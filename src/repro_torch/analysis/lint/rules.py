"""The pluggable invariant-rule registry (port of
`repro.analysis.lint.rules`).

A *rule* is a named check over one recorded entry point.  Each rule
declares what it consumes (``requires``: the op graph of the run, its
torch-function-level calls, or kernel source files) and returns
:class:`Finding`s; the runner (`run_rules`) hands every rule a
:class:`RuleContext`, collects findings, and feeds the per-rule
``lint.findings.<rule>_total`` counters in `repro_torch.obs`.

Rules, with the reference's names where they check the same thing:

  ``logits-materialization``  (rows, V)-shaped buffers that are
      *provenance-tainted*: produced by a vocab-dim-creating op (a
      matrix product, an allocation of a logits shape inside a kernel
      scope — a kernel's global-memory buffer — or a materialising op
      that broadcasts a V-dim operand) or downstream of one, outside
      kernel scopes.
      A plain version's full-vocab tile inside a scope is exempt, as a
      Pallas body is.
  ``wide-dequant``            >1-byte full-size copies of 1-byte
      quantized inputs (pools / quantized lm_head) outside kernels.
  ``dtype-policy``            f64 / c128 results anywhere, full-shape
      f32/f64 upcasts (``_to_copy``) of 1-byte inputs, and of bf16/f16
      inputs larger than `bf16_upcast_bytes`.
  ``buffer-donation``         entry points that promise donation but
      updated fewer inputs in place (`OpGraph.alias_pairs`) than
      promised: the train state or the decode caches are copied.
  ``vocab-collectives``       all-gather / all-to-all results carrying a
      full-vocab dim (``_c10d_functional`` / ``c10d`` ops; none exist
      until the port shards anything).
  ``torchfn-logits``          the reference's ``jaxpr-logits``: any
      torch-function-level call returning a (rows, V) value outside
      kernel scopes.
  ``cuda-kernel-source``      the kernel wrappers' and sources' lint
      (`analysis/lint/kernel_source.py`), registered on import.

Suppressions: ``(rule, entry-substring)`` pairs in
`RuleContext.suppress` drop matching findings but are *recorded* in the
run report; the CI gate (``analyze --smoke``) requires none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.lint.ir import (ALLOC_OPS, Instruction, OpGraph,
                                          OpShape)

# dtypes that can never hold logits (the int8 / uint8 constrained-decoding
# mask IS a (B, V) tensor by design; bool masks likewise)
NON_LOGIT_DTYPES = ("pred", "s4", "u4", "s8", "u8")

# the matrix products (and convolution) that create a vocab-sized dim
ROOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm", "_int_mm",
            "convolution", "mv", "addmv", "dot", "matmul")

_FLOAT = ("f8e4m3fn", "f8e5m2", "f8e4m3fnuz", "f8e5m2fnuz", "f8e8m0fnu",
          "f16", "bf16", "f32", "f64")


def logits_targets(batch: int, vocab: int, seq: Optional[int] = None,
                   heads: Optional[int] = None) -> Set[Tuple[int, ...]]:
    """The non-unit dim multisets a logits tensor can take: {B, V}; with
    `seq` the multi-token {B, S, V} / {B*S, V}; with `heads` the MTP
    horizon forms (a copy of the reference's)."""
    def nonunit(dims):
        return tuple(sorted(d for d in dims if d != 1))

    b, v = int(batch), int(vocab)
    targets = {nonunit((b, v))}
    if seq is not None:
        targets.add(nonunit((b, int(seq), v)))
        targets.add(nonunit((b * int(seq), v)))
    if heads is not None:
        targets.add(nonunit((b, int(heads), v)))
        targets.add(nonunit((b * int(heads), v)))
        if seq is not None:
            targets.add(nonunit((b, int(seq), int(heads), v)))
            targets.add(nonunit((b * int(seq) * int(heads), v)))
    return targets


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    message: str
    where: str                  # instruction line / file:line
    entry: str = ""             # recorded entry point (runner fills in)

    def to_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "entry": self.entry,
                "message": self.message, "where": self.where}


@dataclasses.dataclass
class RuleContext:
    """Everything a rule may consume for ONE recorded entry point.

    Unset fields disable the rules that need them: a context with no
    `graph` runs only torch-function / source rules,
    `expect_donation=None` skips the donation check, etc."""
    entry: str = ""
    graph: Optional[OpGraph] = None
    fn_graph: Optional[object] = None        # ir.FnGraph (the jaxpr's)
    sources: Sequence[str] = ()              # kernel sources to lint
    batch: Optional[int] = None              # logits-rule row count
    vocabs: Tuple[int, ...] = ()             # (vocab_size, padded_vocab)
    seq: Optional[int] = None
    heads: Optional[int] = None
    expect_donation: Optional[int] = None    # min in-place inputs
    bf16_upcast_bytes: int = 1 << 20         # dtype-policy threshold
    quant_param_bytes: int = 4096            # min 1-byte input size
    suppress: Sequence[Tuple[str, str]] = ()  # (rule, entry-substring)


class Rule:
    """Base class: subclass, set `name`/`requires`, implement `run`."""

    name: str = ""
    requires: str = "graph"      # 'graph' | 'torchfn' | 'source'

    def applicable(self, ctx: RuleContext) -> bool:
        if self.requires == "graph":
            return ctx.graph is not None
        if self.requires == "torchfn":
            return ctx.fn_graph is not None
        if self.requires == "source":
            return bool(ctx.sources)
        return False

    def run(self, ctx: RuleContext) -> List[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Rule] = {}


def register(rule_cls):
    """Class decorator: instantiate + add to the global registry."""
    rule = rule_cls()
    if not rule.name:
        raise ValueError(f"rule {rule_cls.__name__} has no name")
    _REGISTRY[rule.name] = rule
    return rule_cls


def get_rules(names: Optional[Iterable[str]] = None) -> List[Rule]:
    """All registered rules (or the named subset, unknown names raise)."""
    # the source rule registers on import; keep it one package
    from repro_torch.analysis.lint import kernel_source  # noqa: F401
    if names is None:
        return [_REGISTRY[k] for k in sorted(_REGISTRY)]
    out = []
    for n in names:
        if n not in _REGISTRY:
            raise KeyError(f"unknown lint rule {n!r}; known: "
                           f"{sorted(_REGISTRY)}")
        out.append(_REGISTRY[n])
    return out


def run_rules(ctx: RuleContext,
              rules: Optional[Sequence[Rule]] = None
              ) -> Tuple[List[Finding], List[Finding]]:
    """Run every applicable rule over `ctx`.

    Returns ``(findings, suppressed)`` — suppressed findings matched a
    ``(rule, entry-substring)`` pair in `ctx.suppress` and are reported
    separately so the caller can gate on "zero suppressions in-tree".
    Per-rule `lint.findings.<rule>_total` counters and the aggregate
    `lint.findings_total` land in the `repro_torch.obs` registry."""
    from repro_torch import obs
    reg = obs.get_registry()
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for rule in (get_rules() if rules is None else rules):
        if not rule.applicable(ctx):
            continue
        hits = [dataclasses.replace(f, entry=f.entry or ctx.entry)
                for f in rule.run(ctx)]
        reg.counter(f"lint.findings.{rule.name}_total").inc(len(hits))
        for f in hits:
            if any(f.rule == r and s in f.entry for r, s in ctx.suppress):
                suppressed.append(f)
            else:
                findings.append(f)
    reg.counter("lint.findings_total").inc(len(findings))
    return findings, suppressed


# ---------------------------------------------------------------------------
# graph helpers shared by the shape rules
# ---------------------------------------------------------------------------


def _matches(instr: Instruction, targets: Set[Tuple[int, ...]],
             exempt_dtypes: Tuple[str, ...] = NON_LOGIT_DTYPES) -> bool:
    return any(s.nonunit() in targets and s.dtype not in exempt_dtypes
               for s in instr.shapes)


def _kernel_buffer(instr: Instruction) -> bool:
    """An allocation inside a kernel scope: the kernel's global memory."""
    return instr.in_kernel and instr.base in ALLOC_OPS


def _numel(shape: OpShape) -> int:
    n = 1
    for d in shape.dims:
        n *= d
    return n


def _broadcasts_vocab(graph: OpGraph, instr: Instruction,
                      vocab_dims: Set[int]) -> bool:
    """Whether `instr` broadcasts an operand whose data has a vocab dim
    into its result: the buffer under the operand (an expanded (V,)
    bias, a vocab-row statistic) carries V and is smaller than the
    result.  An expanded scalar carries none; an elementwise op over a
    full (rows, V) operand broadcasts nothing."""
    out = _numel(instr.shape)
    for root, shape in instr.inputs:
        src = graph.get(root)
        under = src.shape if src is not None else shape
        if (any(d in vocab_dims for d in shape.nonunit())
                and any(d in vocab_dims for d in under.nonunit())
                and _numel(under) < out):
            return True
    return False


def find_logits_defs(graph: OpGraph, targets: Set[Tuple[int, ...]],
                     vocabs: Iterable[int]) -> List[Instruction]:
    """Graph core of the logits rule (also backs
    `analysis.trace.logits_intermediates`): taint from vocab-dim-creating
    producers, stop at kernel-internal ops, report shape-matching
    writes."""
    vocab_dims = {int(v) for v in vocabs}

    def stop(instr: Instruction) -> bool:
        return instr.in_kernel and not _kernel_buffer(instr)

    seeds = []
    for instr in graph:
        if not _matches(instr, targets):
            continue
        if instr.in_kernel:
            # the custom-call seed: a kernel's (rows, V) float buffer
            if _kernel_buffer(instr) and any(
                    s.dtype in _FLOAT for s in instr.shapes):
                seeds.append(instr.name)
            continue
        if instr.base in ROOT_OPS:
            seeds.append(instr.name)
        elif instr.reported and _broadcasts_vocab(graph, instr,
                                                  vocab_dims):
            # the broadcast seed: materialising a V-dim operand (a (V,)
            # bias, a vocab-row statistic) into a (rows, V) buffer
            seeds.append(instr.name)
    tainted = graph.propagate(seeds, stop=stop)
    hits = [i for i in graph
            if i.name in tainted and _matches(i, targets) and i.reported]
    hits.sort(key=lambda i: i.lineno)
    return hits


def find_wide_copies(graph: OpGraph, target: Tuple[int, ...]
                     ) -> List[Instruction]:
    """Defs of a WIDE (>1 byte/elem) tensor whose non-unit dims equal
    `target` — the graph core behind `trace.wide_dequant_intermediates`.
    Parameters, views and kernel-internal ops are non-evidence."""
    hits = []
    for instr in graph:
        if not instr.reported or instr.in_kernel:
            continue
        for s in instr.shapes:
            try:
                wide = s.byte_width > 1
            except ValueError:
                wide = True          # unknown dtype: assume the worst
            if wide and s.nonunit() == tuple(target):
                hits.append(instr)
                break
    hits.sort(key=lambda i: i.lineno)
    return hits


# ---------------------------------------------------------------------------
# the rule pack
# ---------------------------------------------------------------------------


@register
class LogitsMaterializationRule(Rule):
    """No hot path may materialize a (rows, V) logits buffer."""

    name = "logits-materialization"
    requires = "graph"

    def run(self, ctx: RuleContext) -> List[Finding]:
        if ctx.batch is None or not ctx.vocabs:
            return []
        out = []
        for v in dict.fromkeys(ctx.vocabs):     # dedupe V == padded V
            targets = logits_targets(ctx.batch, v, seq=ctx.seq,
                                     heads=ctx.heads)
            for instr in find_logits_defs(ctx.graph, targets, ctx.vocabs):
                out.append(Finding(
                    self.name,
                    f"(rows, {v}) logits-shaped intermediate "
                    f"materialized by '{instr.opcode}'",
                    instr.line))
        return out


@register
class WideDequantRule(Rule):
    """Quantized (1-byte) inputs must be widened only inside kernels.

    Targets are discovered from the run itself: every 1-byte entry
    parameter of at least `quant_param_bytes` is treated as a quantized
    pool/weight, and any out-of-kernel wide def matching its shape —
    and fed (transitively) by it — is a full-size dequantized copy."""

    name = "wide-dequant"
    requires = "graph"

    def run(self, ctx: RuleContext) -> List[Finding]:
        g = ctx.graph
        pools = [p for p in g.entry_parameters()
                 if p.shape.byte_width == 1
                 and p.shape.size_bytes >= ctx.quant_param_bytes]
        if not pools:
            return []
        tainted = g.propagate([p.name for p in pools],
                              stop=lambda i: i.in_kernel)
        out = []
        for p in pools:
            for instr in find_wide_copies(g, p.shape.nonunit()):
                if instr.name in tainted:
                    out.append(Finding(
                        self.name,
                        f"full-size wide copy of quantized operand "
                        f"{p.shape.dtype}{list(p.shape.dims)} "
                        f"(param %{p.name}) outside a kernel",
                        instr.line))
        return out


@register
class DtypePolicyRule(Rule):
    """No accidental precision widening in hot paths:

      * f64/c128 results anywhere (a stray double);
      * any full-shape f32/f64 upcast of a 1-byte input;
      * full-shape f32/f64 upcasts of bf16/f16 inputs larger than
        `bf16_upcast_bytes` (a silently promoted copy).

    An upcast is a ``_to_copy`` of a parameter, or of a view of one
    with its full shape."""

    name = "dtype-policy"
    requires = "graph"

    def run(self, ctx: RuleContext) -> List[Finding]:
        g = ctx.graph
        out = []
        for instr in g:
            if instr.in_kernel or instr.opcode == "parameter":
                continue
            if any(s.dtype in ("f64", "c128") for s in instr.shapes):
                out.append(Finding(
                    self.name,
                    f"f64 result from '{instr.opcode}' — double precision "
                    "is never intentional in this stack", instr.line))
        narrow: Dict[str, OpShape] = {}
        for p in g.entry_parameters():
            s = p.shape
            if s.byte_width == 1 or (s.dtype in ("bf16", "f16") and
                                     s.size_bytes >= ctx.bf16_upcast_bytes):
                narrow[p.name] = s
        if not narrow:
            return out
        for instr in g:
            if instr.in_kernel or instr.base != "_to_copy":
                continue
            if instr.shape.dtype not in ("f32", "f64"):
                continue
            for root, s in instr.inputs:
                ps = narrow.get(root)
                if (ps is None or s.nonunit() != ps.nonunit()
                        or instr.shape.nonunit() != ps.nonunit()):
                    continue
                kind = "1-byte" if ps.byte_width == 1 else ps.dtype
                out.append(Finding(
                    self.name,
                    f"full-shape {instr.shape.dtype} upcast of {kind} "
                    f"param %{root} {list(ps.dims)}", instr.line))
                break
        return out


@register
class BufferDonationRule(Rule):
    """Entry points that promise donation must update their state in
    place: a missing in-place update means the train state / decode
    caches are copied every step (2x live memory)."""

    name = "buffer-donation"
    requires = "graph"

    def run(self, ctx: RuleContext) -> List[Finding]:
        if ctx.expect_donation is None:
            return []
        have = ctx.graph.alias_pairs
        if have >= ctx.expect_donation:
            return []
        return [Finding(
            self.name,
            f"expected >= {ctx.expect_donation} donated (in-place "
            f"updated) inputs, the run updated {have} — the donated "
            "operand is being copied",
            f"OpGraph {ctx.entry or '<entry>'} in-place inputs: {have}")]


@register
class VocabCollectivesRule(Rule):
    """Sharded fused-CE must never regather a vocab-sharded operand:
    flag all-gather / all-to-all results carrying a full-vocab dim."""

    name = "vocab-collectives"
    requires = "graph"

    _OPS = ("all_gather_into_tensor", "all_gather_into_tensor_coalesced",
            "all_gather", "allgather_", "_allgather_base_",
            "all_to_all_single", "alltoall_", "alltoall_base_")

    def run(self, ctx: RuleContext) -> List[Finding]:
        if not ctx.vocabs:
            return []
        vocab_dims = {int(v) for v in ctx.vocabs}
        out = []
        for instr in ctx.graph:
            if instr.base not in self._OPS:
                continue
            for s in instr.shapes:
                if any(d in vocab_dims for d in s.nonunit()):
                    out.append(Finding(
                        self.name,
                        f"'{instr.opcode}' result carries a full-vocab "
                        f"dimension {s.dtype}{list(s.dims)} — a "
                        "vocab-sharded operand is being regathered",
                        instr.line))
                    break
        return out


@register
class TorchFnLogitsRule(Rule):
    """The reference's ``jaxpr-logits``: walk the torch-function-level
    calls (kernel scopes are opaque there) and flag outputs whose shape
    matches a logits target."""

    name = "torchfn-logits"
    requires = "torchfn"

    def run(self, ctx: RuleContext) -> List[Finding]:
        if ctx.batch is None or not ctx.vocabs:
            return []
        from repro_torch.analysis.lint.torchfn import logits_calls
        out = []
        for v in dict.fromkeys(ctx.vocabs):     # dedupe V == padded V
            targets = logits_targets(ctx.batch, v, seq=ctx.seq,
                                     heads=ctx.heads)
            for call, shape in logits_calls(ctx.fn_graph, targets):
                out.append(Finding(
                    self.name,
                    f"call '{call.name}' #{call.index} produces a "
                    f"(rows, {v}) logits-shaped value "
                    f"{shape.dtype}{list(shape.dims)}",
                    call.line))
        return out
