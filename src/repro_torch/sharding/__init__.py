"""Sharding rules of the port (`repro.sharding`): specs as tuples of
mesh axis names."""

from repro_torch.sharding.rules import AxisRules, param_specs

__all__ = ["AxisRules", "param_specs"]
