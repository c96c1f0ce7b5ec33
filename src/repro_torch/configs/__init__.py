"""Architecture configs of the port (transformer family)."""

from repro_torch.configs.base import Arch, MTPConfig
