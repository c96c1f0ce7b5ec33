from repro_torch.data.loader import DeviceLoader, to_device
from repro_torch.data.synthetic import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM", "DeviceLoader", "to_device"]
