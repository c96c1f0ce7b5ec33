"""Trace-level checks of one recorded run (port of
`repro.analysis.hlo`'s logits-free and wide-dequant checks) and the CUDA
caching allocator's view of a window (`memory_dict`, the counterpart of
the compiled module's ``memory_analysis``).

The logits and dequant helpers are thin wrappers over the op-graph rules
(`repro_torch.analysis.lint`): they take the `OpGraph` of `lint.record`
where the reference takes HLO text, and return the offending
instructions' lines in program order (empty == clean).
`collective_stats` counts the collectives of a recorded run by kind, as
the reference counts them in the compiled module; its ``cost_dict``
waits for the benchmark's port (A10).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from repro_torch.analysis.lint.ir import OpGraph
from repro_torch.analysis.lint.rules import (find_logits_defs,
                                             find_wide_copies,
                                             logits_targets)
from repro_torch.distributed.collectives import CollectiveStats


# the collectives' aten-level ops -> (the reference's kind, the input
# holding the operand): the process group's ``c10d`` ops, which
# `distributed.collectives` runs (all-reduce: its tensors; the base
# all-gather and reduce-scatter: (output, input)), and the functional
# ``_c10d_functional`` ones (the first input)
COLLECTIVE_OPS = {
    "c10d.allreduce_": ("all-reduce", None),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
}


def collective_stats(graph: OpGraph) -> CollectiveStats:
    """This rank's collective operand bytes and calls by kind in a
    recorded run (the reference's rules: an all-gather's operand is the
    local shard, a reduce-scatter's the whole input, an all-reduce's its
    tensor), read off the op's inputs: the same record that
    `distributed.collectives` keeps as it runs them."""
    stats = CollectiveStats()
    for instr in graph:
        hit = COLLECTIVE_OPS.get(instr.opcode.rsplit(".", 1)[0])
        if hit is None:
            continue
        kind, arg = hit
        ins = [s.size_bytes for _, s in instr.inputs]
        stats.add(kind, sum(ins) if arg is None else ins[arg])
    return stats


def logits_intermediates(graph: OpGraph, batch: int, vocab: int,
                         seq: Optional[int] = None,
                         heads: Optional[int] = None) -> List[str]:
    """Lines of the ops that WRITE a logits-shaped buffer the run really
    materialized: a result whose non-unit dims are {batch, vocab} (or,
    with `seq` / `heads`, the multi-token / multi-horizon forms, as
    `logits_targets` lists them), in a dtype that can hold logits, and
    tainted by a vocab-dim-creating op outside every kernel scope (a
    plain version's tile inside its kernel's scope is not evidence)."""
    targets = logits_targets(batch, vocab, seq=seq, heads=heads)
    return [i.line for i in find_logits_defs(graph, targets, (vocab,))]


def assert_logits_free(graph: OpGraph, batch: int, vocabs: Iterable[int],
                       seq: Optional[int] = None,
                       heads: Optional[int] = None) -> None:
    """Raise if the run materialized a (batch, V) — or, with `seq` /
    `heads`, any multi-token / multi-horizon — logits buffer for any V
    in `vocabs` (pass both the vocab size and the padded vocab)."""
    for v in vocabs:
        hits = logits_intermediates(graph, batch, v, seq=seq, heads=heads)
        if hits:
            shapes = f"({batch}, {v})"
            if seq is not None:
                shapes += (f" / ({batch}, {seq}, {v})"
                           f" / ({batch * seq}, {v})")
            if heads is not None:
                shapes += f" / ({batch}, ..{heads} heads.., {v})"
            raise AssertionError(
                f"{shapes} logits intermediate(s) in the recorded run:\n  "
                + "\n  ".join(hits[:8]))


def wide_dequant_intermediates(graph: OpGraph, shape) -> List[str]:
    """Lines of the ops that write a wide (>1 byte an element) tensor of
    `shape` (order-free, size-1 dims ignored) outside kernel scopes:
    a full-size dequantized copy of a quantized operand.  Parameters
    and views are not evidence, and unknown dtypes count as wide."""
    target = tuple(sorted(int(d) for d in shape if int(d) != 1))
    return [i.line for i in find_wide_copies(graph, target)]


def assert_no_wide_dequant(graph: OpGraph, shapes) -> None:
    """Raise if the run wrote a full-size wide copy of any quantized
    operand of `shapes` (the K/V pool shape, the gathered-cache shape,
    the quantized lm_head shape)."""
    for shape in shapes:
        hits = wide_dequant_intermediates(graph, shape)
        if hits:
            raise AssertionError(
                f"full-size dequantized copy of quantized operand "
                f"{tuple(shape)} in the recorded run:\n  "
                + "\n  ".join(hits[:8]))


def memory_dict(fn, *args, device=None, max_entries: int = 1 << 20,
                **kw):
    """``(fn(*args, **kw), {base_bytes, peak_bytes, largest_alloc_bytes,
    allocs})`` read from the CUDA caching allocator: the bytes allocated
    before the call, the peak above them during it, and the largest
    single block it allocated and how many, from the allocator's history
    (``_record_memory_history``, without stack traces)."""
    dev = torch.device("cuda" if device is None else device)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.memory._record_memory_history(
        enabled="all", context=None, stacks="python",
        max_entries=max_entries, device=dev)
    try:
        out = fn(*args, **kw)
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot(dev)
    finally:
        torch.cuda.memory._record_memory_history(enabled=None, device=dev)
    allocs = [e["size"] for trace in snap.get("device_traces", [])
              for e in trace if e.get("action") == "alloc"]
    return out, {
        "base_bytes": int(base),
        "peak_bytes": int(torch.cuda.max_memory_allocated(dev) - base),
        "largest_alloc_bytes": int(max(allocs, default=0)),
        "allocs": len(allocs)}
