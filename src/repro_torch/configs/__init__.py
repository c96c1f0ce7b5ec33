"""Architecture configs of the port (the transformer, griffin, xlstm and
enc-dec families)."""

from repro_torch.configs.base import Arch, MTPConfig, TuningConfig, with_mtp
