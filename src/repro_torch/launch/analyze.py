"""Static-analysis driver: every invariant rule over every hot path.

    PYTHONPATH=src python -m repro_torch.launch.analyze [--smoke]
        [--json PATH] [--device cuda|cpu]

Port of `repro.launch.analyze`, with its matrix, entry names,
expectations, flags and report keys.  The reference compiles each entry
point and parses the HLO; the port has no compiled module, so each
entry runs ONCE, eagerly, on throwaway engines and state at the
reference's reduced shapes, recorded into the op-graph IR
(`analysis/lint/ir.py`: the aten ops and the torch-function calls of the
run), and the full rule registry (`analysis/lint/rules.py`) runs over
it: logits materialization, wide dequant, dtype policy, buffer donation,
vocab-dim collectives, torch-function-level logits, and the kernel
source lint over `repro_torch/kernels`.  The entries are the train step
(exact and gradient-filtered), slab and paged decode, quantized decode,
beam top-k, masked (constrained) decode, eval scoring and speculative
verify, for ALL FOUR model families.

Two deliberately-broken fixtures (the canonical two-stage loss and a
dense ``h @ lm_head.T`` sampler) run alongside and MUST be flagged:
they prove the rules still have teeth in the same process that declares
the hot paths clean.

On the card (``--device cuda``, the default) the entries launch the
kernels, whose wrappers take bf16 with ``d % 64 == 0``: the reduced
configs run in bf16, and the three whose reduced width is 48 (griffin,
xlstm, enc-dec) at width 64 (`CARD_WIDTHS`).  Each row of the report
also carries the kernel scopes the run entered and the launches each
kernel's `LaunchCounter` counted (equal on the card: every launch is
scoped).

Output: a per-entry table plus a JSON report
(`obs.export.dump_json`, ``--json -`` for stdout) with every finding,
suppression, and the `lint.*` counter snapshot.  Exit status is
non-zero on any violation: a clean entry with findings other than its
listed open ones (`OPEN_FINDINGS`, ROADMAP §C), a fixture without
findings, or (under ``--smoke``, the CI gate) ANY suppression in
use — suppressions (``--suppress rule:entry-substring``) are a local
triage tool, never a way to ship a finding.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis.lint import RuleContext, get_rules, record, \
    run_rules
from repro_torch.kernels import build
from repro_torch.models.registry import (forward_hidden, get_arch,
                                         init_params, init_serve_caches)
from repro_torch.serve import Engine, PagedEngine, ServeConfig
from repro_torch.serve.engine import resolve_device
from repro_torch.train.step import TrainConfig, build_train_step

_FAMILIES = (
    ("transformer", "qwen3-0.6b", {}),
    ("griffin", "recurrentgemma-9b", {}),
    ("xlstm", "xlstm-125m", {}),
    ("encdec", "seamless-m4t-medium", {"enc_len": 8}),
)
_B, _S = 2, 16          # train rows
_K = 3                  # speculative draft length (verify scans K+1)
_MAX_LEN = 48

# Findings on entries the reference calls clean that this PR could not
# repair, each listed with its text in ROADMAP.md §C "Open": an entry
# listed here must report exactly these rules, and every other clean
# entry none, so a new finding and a repaired one both fail the run.
OPEN_FINDINGS: Dict[str, Tuple[str, ...]] = {}

# the reduced configs of width 48 at the card's width: the kernels take
# d % 64 == 0, and paged_attn a head_dim % 8 == 0
CARD_WIDTHS = {
    "griffin": {"d_model": 64, "head_dim": 16},
    "xlstm": {"d_model": 64, "num_heads": 4},
    "encdec": {"d_model": 64, "head_dim": 16},
}


def arch_for(arch_id: str, device: torch.device):
    """The reduced arch; on the card in bf16 at `CARD_WIDTHS`."""
    arch = get_arch(arch_id, reduced=True)
    if device.type != "cuda":
        return arch
    kw = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    if arch.cfg.d_model % 64:
        kw.update(CARD_WIDTHS[arch.family])
    return dataclasses.replace(arch,
                               cfg=dataclasses.replace(arch.cfg, **kw))


def _vocabs(arch):
    return (arch.vocab_size, arch.padded_vocab)


def _cdt(arch):
    return getattr(torch, getattr(arch.cfg, "compute_dtype", "float32"))


def _frames(arch, n: int, dev, seed: int = 0):
    """Seeded encoder frames (n, 8, d) for enc-dec, else None."""
    if arch.family != "encdec":
        return None
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 8, arch.cfg.d_model), generator=g).to(
        dev, _cdt(arch))


def run_entry(fn, *args, **kw):
    """Record ``fn(*args, **kw)``: (OpGraph, FnGraph, launches), where
    launches is each kernel's `LaunchCounter` delta over the call."""
    before = {k: c.count for k, c in build.COUNTERS.items()}
    _, graph, fn_graph = record(fn, *args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches = {k: c.count - before.get(k, 0)
                for k, c in build.COUNTERS.items()
                if c.count - before.get(k, 0)}
    return graph, fn_graph, launches


def _ctx(entry, rec, arch, batch, *, seq=None, expect_donation=None,
         suppress=()):
    """(RuleContext, launches) of one recorded entry."""
    graph, fn_graph, launches = rec
    return RuleContext(entry=entry, graph=graph, fn_graph=fn_graph,
                       batch=batch, vocabs=_vocabs(arch), seq=seq,
                       expect_donation=expect_donation,
                       suppress=suppress), launches


# ---------------------------------------------------------------------------
# entry builders: each yields ((RuleContext, launches), expect) with
# expect in {'clean', 'flagged'}
# ---------------------------------------------------------------------------


def _train_entry(name, arch, family, dev, *, loss_impl, eps, suppress):
    tc = TrainConfig(loss_impl=loss_impl, loss_block_v=128,
                     total_steps=10, warmup_steps=1, grad_filter_eps=eps)
    init_fn, step_fn = build_train_step(arch, tc)
    state = init_fn(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, arch.vocab_size, (_B, _S), dtype=np.int64)).to(dev)
        for k in ("tokens", "targets")}
    fe = _frames(arch, _B, dev)
    if fe is not None:
        batch["frontend_embeds"] = fe
    rec = run_entry(step_fn, state, batch)
    return _ctx(f"{family}/{name}", rec, arch, _B, seq=_S,
                expect_donation=1, suppress=suppress)


def _prefilled(make, arch, dev):
    """An engine from `make()` with both slots prefilled (not recorded)."""
    eng = make()
    fe = _frames(arch, 1, dev, seed=1)
    for slot, n in enumerate((5, 7)):
        eng.prefill_into_slot(slot, np.arange(1, n + 1), frontend_embeds=fe)
    return eng


def _family_entries(family, arch_id, sc_kw, dev, suppress):
    """The per-family hot-path matrix; every entry must be clean."""
    arch = arch_for(arch_id, dev)
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)

    yield _train_entry("train_exact", arch, family, dev, loss_impl="kernel",
                       eps=0.0, suppress=suppress), "clean"
    yield _train_entry("train_filtered", arch, family, dev,
                       loss_impl="kernel", eps=1e-3,
                       suppress=suppress), "clean"

    sc = ServeConfig(batch_size=_B, max_len=_MAX_LEN, temperature=0.0,
                     **sc_kw)
    eng = _prefilled(lambda: Engine(arch, params, sc, device=dev), arch, dev)
    rec = run_entry(eng.decode_step)
    yield _ctx(f"{family}/decode_slab", rec, arch, _B, expect_donation=1,
               suppress=suppress), "clean"

    # paged decode (recurrent families degrade to slab semantics)
    psc = ServeConfig(batch_size=_B, max_len=_MAX_LEN, paged=True,
                      block_size=8, temperature=0.0, **sc_kw)
    peng = _prefilled(lambda: PagedEngine(arch, params, psc, device=dev),
                      arch, dev)
    rec = run_entry(peng.decode_topk_step, 4)
    yield _ctx(f"{family}/decode_paged", rec, arch, _B,
               suppress=suppress), "clean"

    # beam inner loop: top-k + lse decode on the slab engine
    rec = run_entry(eng.decode_topk_step, 8)
    yield _ctx(f"{family}/beam_topk", rec, arch, _B,
               suppress=suppress), "clean"

    # constrained decode: the int8 allowed-mask must NOT trip the logits
    # rule (dtype exemption), everything else must stay clean
    for slot in range(_B):
        eng.set_slot_mask(slot, np.ones((arch.vocab_size,), bool))
    rec = run_entry(eng.decode_step)
    for slot in range(_B):
        eng.set_slot_mask(slot, None)
    yield _ctx(f"{family}/masked_decode", rec, arch, _B,
               suppress=suppress), "clean"

    # eval scoring through the engine's own slot prefill
    eng.reset_slot(0)
    prompt = np.arange(1, 9, dtype=np.int32)
    cont = np.arange(1, 5, dtype=np.int32)
    p_pad = 8
    rec = run_entry(eng.score_in_slot, 0, prompt, cont,
                    frontend_embeds=_frames(arch, 1, dev, seed=2))
    yield _ctx(f"{family}/eval_score", rec, arch, 1, seq=p_pad,
               suppress=suppress), "clean"

    # speculative verify: score K+1 drafted tokens per row
    from repro_torch.kernels.score_tokens import score_tokens

    def verify(params, hs, ids):
        logp, _ = score_tokens(hs, params["lm_head"], ids,
                               valid_vocab=arch.vocab_size)
        return logp

    rows = _B * (_K + 1)
    hs = torch.zeros((rows, arch.cfg.d_model), dtype=_cdt(arch), device=dev)
    vids = torch.zeros((rows,), dtype=torch.int32, device=dev)
    rec = run_entry(verify, params, hs, vids)
    yield _ctx(f"{family}/spec_verify", rec, arch, _B, seq=_K + 1,
               suppress=suppress), "clean"

    if family == "transformer":
        # quantized serving: int8 KV pools + int8 lm_head — the
        # wide-dequant and dtype-policy rules get real 1-byte operands
        qsc = ServeConfig(batch_size=_B, max_len=_MAX_LEN, paged=True,
                          block_size=8, quantize_cache=True,
                          head_dtype="int8", temperature=0.0)
        qeng = _prefilled(lambda: PagedEngine(arch, params, qsc,
                                              device=dev), arch, dev)
        rec = run_entry(qeng.decode_step)
        yield _ctx(f"{family}/decode_quant", rec, arch, _B,
                   expect_donation=1, suppress=suppress), "clean"


def dense_decode(arch):
    """The dense sampler fixture: ``h @ lm_head.T`` then argmax."""
    def fn(params, caches, tokens):
        h, _, caches = forward_hidden(arch, params, {"tokens": tokens},
                                      caches=caches)
        z = h[:, -1, :] @ params["lm_head"].T        # (B, V) logits
        return torch.argmax(z, dim=-1), caches
    return fn


def _fixture_entries(dev, suppress):
    """Deliberately-broken programs that MUST be flagged — the rules'
    proof of teeth, run in the same process as the clean matrix."""
    arch = arch_for("qwen3-0.6b", dev)
    yield _train_entry("fixture_canonical_loss", arch, "transformer", dev,
                       loss_impl="canonical", eps=0.0,
                       suppress=suppress), "flagged"

    params = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                         dev)
    caches = init_serve_caches(arch, _B, _MAX_LEN, device=dev)
    cur = torch.zeros((_B, 1), dtype=torch.int64, device=dev)
    with torch.no_grad():
        rec = run_entry(dense_decode(arch), params, caches, cur)
    yield _ctx("transformer/fixture_dense_sampler", rec, arch, _B,
               suppress=suppress), "flagged"


def kernel_sources() -> List[str]:
    """The port's kernel wrappers and CUDA sources."""
    import repro_torch.kernels as K
    root = pathlib.Path(K.__file__).parent
    return sorted(str(p) for p in list(root.rglob("*.py"))
                  + list(root.rglob("*.cu")))


def _kernel_ast_entry(suppress):
    return (RuleContext(entry="kernels/ast", sources=kernel_sources(),
                        suppress=suppress), {}), "clean"


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _parse_suppressions(specs) -> Tuple[Tuple[str, str], ...]:
    out = []
    for s in specs or ():
        rule, _, substr = s.partition(":")
        if not rule or not substr:
            raise SystemExit(
                f"--suppress wants rule:entry-substring, got {s!r}")
        out.append((rule, substr))
    return tuple(out)


def _kernel_ops(graph) -> Dict[str, int]:
    """Recorded ops inside each kernel's scope (its plain version's on
    the CPU, its buffers' on the card)."""
    out: Dict[str, int] = {}
    for instr in graph if graph is not None else ():
        if instr.in_kernel:
            out[instr.kernel] = out.get(instr.kernel, 0) + 1
    return out


def analyze(families=None, rule_names=None, suppress=(), device="cuda",
            progress=print) -> Dict:
    """Run the full matrix; returns the JSON-able report."""
    dev = resolve_device(device)
    rules = get_rules(rule_names)
    tracer = obs.get_tracer()
    rows: List[Dict] = []
    t0 = time.perf_counter()

    def run_one(entry, expect):
        ctx, launches = entry
        te = time.perf_counter()
        with tracer.span("analyze.entry", cat="lint", entry=ctx.entry):
            findings, suppressed = run_rules(ctx, rules)
        open_rules = OPEN_FINDINGS.get(ctx.entry, ())
        if expect == "flagged":
            ok = bool(findings)
        else:
            ok = sorted({f.rule for f in findings}) == sorted(open_rules)
        graph = ctx.graph
        rows.append({
            "entry": ctx.entry, "expect": expect, "ok": ok,
            "findings": [f.to_dict() for f in findings],
            "open": list(open_rules),
            "suppressed": [f.to_dict() for f in suppressed],
            "seconds": round(time.perf_counter() - te, 3),
            "ops": len(graph) if graph is not None else 0,
            "scopes": dict(graph.scopes) if graph is not None else {},
            "kernel_ops": _kernel_ops(graph),
            "launches": dict(launches),
        })
        progress(f"  {ctx.entry:44s} {expect:8s} "
                 f"{len(findings):3d} finding(s)  "
                 f"{'OK' if ok else 'VIOLATION'}")

    with tracer.span("analyze", cat="lint"):
        for family, arch_id, sc_kw in _FAMILIES:
            if families and family not in families:
                continue
            progress(f"[analyze] {family} ({arch_id})")
            for entry, expect in _family_entries(family, arch_id, sc_kw,
                                                 dev, suppress):
                run_one(entry, expect)
        progress("[analyze] fixtures (must be flagged)")
        for entry, expect in _fixture_entries(dev, suppress):
            run_one(entry, expect)
        progress("[analyze] kernel sources")
        run_one(*_kernel_ast_entry(suppress))

    n_find = sum(len(r["findings"]) for r in rows)
    n_supp = sum(len(r["suppressed"]) for r in rows)
    violations = [r["entry"] for r in rows if not r["ok"]]
    report = {
        "rules": [r.name for r in rules],
        "entries": rows,
        "totals": {"entries": len(rows), "rules": len(rules),
                   "findings": n_find, "suppressed": n_supp,
                   "violations": len(violations),
                   "seconds": round(time.perf_counter() - t0, 3)},
        "violations": violations,
        "metrics": {k: v for k, v in obs.get_registry().snapshot().items()
                    if k.startswith("lint.")},
        "device": str(dev),
    }
    return report


def _print_table(report):
    print()
    print(f"{'entry':44s} {'expect':8s} {'findings':>8s} "
          f"{'suppressed':>10s}  status")
    print("-" * 80)
    for r in report["entries"]:
        print(f"{r['entry']:44s} {r['expect']:8s} "
              f"{len(r['findings']):8d} {len(r['suppressed']):10d}  "
              f"{'OK' if r['ok'] else 'VIOLATION'}")
    t = report["totals"]
    print("-" * 80)
    print(f"{t['entries']} entries x {t['rules']} rules: "
          f"{t['findings']} finding(s), {t['suppressed']} suppressed, "
          f"{t['violations']} violation(s) in {t['seconds']:.1f}s")
    for r in report["entries"]:
        if r["ok"] and not r["findings"]:
            continue
        head = ("VIOLATION" if not r["ok"] else "expected (fixture)"
                if r["expect"] == "flagged" else "open (ROADMAP §C)")
        for f in r["findings"][:4]:
            print(f"  [{head}] {f['entry']} {f['rule']}: {f['message']}")
            print(f"      at {f['where'][:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: also fail on ANY suppression in use")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="dump the JSON report ('-' for stdout)")
    ap.add_argument("--families", nargs="*", default=None,
                    choices=[f for f, _, _ in _FAMILIES])
    ap.add_argument("--rules", nargs="*", default=None,
                    help="rule subset (default: all registered)")
    ap.add_argument("--suppress", action="append", default=[],
                    metavar="RULE:ENTRY-SUBSTRING",
                    help="drop matching findings (recorded, not hidden; "
                         "--smoke refuses to pass with any in use)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    obs.enable(trace=True)
    report = analyze(families=args.families, rule_names=args.rules,
                     suppress=_parse_suppressions(args.suppress),
                     device=args.device)
    _print_table(report)
    if args.json:
        obs.export.dump_json(report, args.json, label="analyze report",
                             tag="analyze")

    bad = report["totals"]["violations"]
    if args.smoke and report["totals"]["suppressed"]:
        print(f"[analyze] --smoke: {report['totals']['suppressed']} "
              "suppression(s) in use — the gate requires zero")
        bad += 1
    if bad:
        print(f"[analyze] FAILED: {bad} violation(s)")
        return 1
    n_open = sum(len(r["open"]) for r in report["entries"])
    print(f"[analyze] all entries as expected: hot paths clean but for "
          f"{n_open} open finding(s) (ROADMAP §C), fixtures flagged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
