"""Architecture configs of the port (the transformer, griffin and xlstm
families)."""

from repro_torch.configs.base import Arch, MTPConfig, with_mtp
