"""Graph-based static analysis over recorded hot paths (port of
`repro.analysis.lint`).

`ir` records one eager run of an entry point into an aten-level op graph
with def-use edges (and its torch-function-level calls); `rules` is the
pluggable invariant-rule registry that runs over it; `torchfn` walks the
torch-function level, the jaxpr's counterpart; `kernel_source` lints the
kernel wrappers and CUDA sources.  `launch/analyze.py` drives all of it
over every hot path.
"""

from repro_torch.analysis.lint.ir import (DTYPE_BYTES, FnGraph, Instruction,
                                          OpGraph, OpShape, record)
from repro_torch.analysis.lint.rules import (Finding, Rule, RuleContext,
                                             find_logits_defs,
                                             find_wide_copies, get_rules,
                                             logits_targets, register,
                                             run_rules)

__all__ = [
    "DTYPE_BYTES",
    "FnGraph",
    "Instruction",
    "OpGraph",
    "OpShape",
    "record",
    "Finding",
    "Rule",
    "RuleContext",
    "find_logits_defs",
    "find_wide_copies",
    "get_rules",
    "logits_targets",
    "register",
    "run_rules",
]
