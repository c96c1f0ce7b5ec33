"""The torch-function-level walker (port of `repro.analysis.lint.jaxpr`).

The op-graph rules see every aten buffer the run wrote; this level sees
what the program *asked for*: the calls the model code makes through the
torch API (`F.linear`, ``@``, `torch.einsum`, ...), recorded by the
`TorchFunctionMode` of `ir.record` in the same run.  Kernel scopes are
opaque here, as ``pallas_call`` is in the reference: a call inside one
is not recorded (its plain version's tiles are the kernel's business),
and any logits-shaped *output* of the kernel would still surface as the
output of a call one level up.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from repro_torch.analysis.lint.ir import FnCall, FnGraph, OpShape

# dtypes that can never hold logits (the reference's `_NON_LOGIT_NP`, in
# this IR's spelling: bool, int8, uint8, int4, uint4)
NON_LOGIT = ("pred", "s8", "u8", "s4", "u4")


def logits_calls(fn_graph: FnGraph, targets: Set[Tuple[int, ...]]
                 ) -> List[Tuple[FnCall, OpShape]]:
    """Calls returning a value whose non-unit dims match a logits target,
    in a dtype that can hold logits.  Returns ``(call, shape)`` pairs."""
    hits = []
    for call in fn_graph:
        for shape in call.shapes:
            if shape.dtype in NON_LOGIT:
                continue
            if shape.nonunit() in targets:
                hits.append((call, shape))
                break
    return hits
