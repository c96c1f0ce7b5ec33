"""The port's static analysis: the op-graph IR, the rule pack, the
kernel-source lint, and its parity with the JAX package's analysis.

Four layers, on the CPU (the rules are exact, so no tolerance):

  * the rule pack on hand-built op graphs, case for case the reference's
    rule tests (`tests/test_lint.py`): provenance, the broadcast seed,
    the mask-dtype exemption, donation, dtype policy, vocab collectives,
    wide-dequant taint, suppressions recorded, counters in `obs`;
  * the recorder (`ir.record`) on small eager runs: kernel scopes, a
    kernel's (B, V) float buffer, no tensor kept alive, in-place writes
    tainting their storage;
  * parity with the JAX package: `logits_targets` and the roofline
    formulas, and the verdicts (and flagged non-unit dims) of JAX's
    ``jaxpr-logits`` / HLO logits check against the port's
    ``torchfn-logits`` / op-graph check on the reduced qwen3-0.6b decode
    step and the dense-sampler fixture;
  * the kernel-source lint: each bug class flagged on a source string,
    and the repo's kernel tree clean.
"""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.lint import (Instruction, OpGraph,  # noqa: E402
                                       OpShape, RuleContext,
                                       find_logits_defs, find_wide_copies,
                                       get_rules, logits_targets, record,
                                       run_rules)
from repro_torch.analysis.lint.ir import dtype_name  # noqa: E402
from repro_torch.analysis.lint.kernel_source import (lint_file,  # noqa: E402
                                                     lint_source)
from repro_torch.analysis.trace import (assert_logits_free,  # noqa: E402
                                        logits_intermediates)
from repro_torch.kernels import build  # noqa: E402

# ---------------------------------------------------------------------------
# hand-built op graphs
# ---------------------------------------------------------------------------


def _graph(*specs):
    """OpGraph from (name, opcode, dtype, dims[, operands][, kw]) specs.
    Each instruction's `inputs` are its operands' (storage root, shape),
    a view's root being its source's."""
    g = OpGraph()
    roots = {}
    for spec in specs:
        name, opcode, dtype, dims = spec[:4]
        operands = tuple(spec[4]) if len(spec) > 4 else ()
        kw = dict(spec[5]) if len(spec) > 5 else {}
        inputs = tuple((roots[o], g.get(o).shape) for o in operands
                       if o in roots)
        instr = g.add(Instruction(
            name=name, opcode=opcode, shapes=(OpShape(dtype, tuple(dims)),),
            operands=operands, where="toy.py:1", inputs=inputs,
            **kw))
        roots[name] = (roots[operands[0]] if instr.is_view and operands
                       else name)
    return g


_TOY = [
    ("a", "parameter", "f32", (4, 64)),
    ("w", "parameter", "f32", (512, 64)),
    ("wt", "aten.t.default", "f32", (64, 512), ["w"], {"is_view": True}),
    ("d", "aten.mm.default", "f32", (4, 512), ["a", "wt"]),
    ("e", "aten.exp.default", "f32", (4, 512), ["d"]),
]


def test_op_graph_structure():
    g = _graph(*_TOY)
    assert [p.name for p in g.entry_parameters()] == ["a", "w"]
    assert g.users("d") == ["e"] and g.users("w") == ["wt"]
    assert g.get("d").base == "mm" and g.get("wt").reported is False
    assert [i.lineno for i in g] == [1, 2, 3, 4, 5]
    assert g.alias_pairs == 0


def test_taint_follows_def_use_edges():
    g = _graph(*_TOY)
    assert g.propagate(["d"]) == {"d", "e"}
    # taint crosses views: the weight's transpose feeds the product
    assert {"wt", "d", "e"} <= g.propagate(["w"])


def test_propagate_stops_at_kernel_ops():
    g = _graph(
        ("h", "parameter", "f32", (4, 64)),
        ("kd", "aten.mm.default", "f32", (4, 512), ["h"],
         {"in_kernel": True, "kernel": "score_tokens"}),
        ("out", "aten.add.Tensor", "f32", (4, 512), ["kd", "kd"]))
    assert g.get("kd").in_kernel
    assert g.propagate(["kd"], stop=lambda i: i.in_kernel) == set()
    # a plain version's (rows, V) tile is not evidence
    assert find_logits_defs(g, logits_targets(4, 512), (512,)) == []


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="unknown dtype"):
        OpShape("f6e3m2", (4, 4)).size_bytes
    assert OpShape("f8e4m3fn", (4, 4)).size_bytes == 16
    assert dtype_name(torch.float8_e4m3fn) == "f8e4m3fn"
    assert dtype_name(torch.bfloat16) == "bf16"
    with pytest.raises(ValueError, match="unknown dtype"):
        dtype_name(torch.qint8)


def _run(rule_name, ctx):
    return run_rules(ctx, get_rules([rule_name]))


def test_logits_rule_needs_provenance():
    # shape-matching values NOT fed by a vocab-creating op stay clean: an
    # arange / parameter of (B, V) is data, not logits
    g = _graph(("i", "aten.arange.default", "f32", (4, 512)),
               ("p", "parameter", "f32", (4, 512)),
               ("c", "aten.add.Tensor", "f32", (4, 512), ["i", "p"]))
    assert find_logits_defs(g, logits_targets(4, 512), (64,)) == []
    # ...but a product's value taints its consumers
    g2 = _graph(*_TOY)
    hits = find_logits_defs(g2, logits_targets(4, 512), (512,))
    assert [h.name for h in hits] == ["d", "e"]


def test_logits_rule_broadcast_of_vocab_operand_seeds():
    g = _graph(
        ("bias", "parameter", "f32", (512,)),
        ("bx", "aten.expand.default", "f32", (4, 512), ["bias"],
         {"is_view": True}),
        ("b", "aten.clone.default", "f32", (4, 512), ["bx"]),
        ("zero", "aten.scalar_tensor.default", "f32", ()),
        ("zx", "aten.expand.default", "f32", (4, 512), ["zero"],
         {"is_view": True}),
        ("ok", "aten.clone.default", "f32", (4, 512), ["zx"]))
    hits = find_logits_defs(g, logits_targets(4, 512), (512,))
    assert [h.name for h in hits] == ["b"]     # the scalar's stays clean


def test_logits_rule_exempts_mask_dtypes():
    # a kernel's int8 (B, V) buffer (the constrained-decoding mask's
    # dtype) is no logits; its f32 twin is
    g = _graph(("m", "aten.empty.memory_format", "s8", (4, 512), [],
                {"in_kernel": True, "kernel": "sample_topk"}))
    assert find_logits_defs(g, logits_targets(4, 512), (512,)) == []
    g = _graph(("m", "aten.empty.memory_format", "f32", (4, 512), [],
                {"in_kernel": True, "kernel": "sample_topk"}))
    assert [h.name for h in find_logits_defs(
        g, logits_targets(4, 512), (512,))] == ["m"]


def _donation_graph(copy=False):
    specs = [("c0", "parameter", "bf16", (2, 48, 4)),
             ("c1", "parameter", "bf16", (2, 48, 4)),
             ("k", "aten.randn.default", "bf16", (2, 1, 4)),
             ("w0", "aten.index_put_.default", "bf16", (2, 48, 4),
              ["c0", "k"], {"writes": ("c0",)}),
             ("w1", "aten.index_put_.default", "bf16", (2, 48, 4),
              ["c1", "k"], {"writes": ("c1",)})]
    if copy:
        specs.append(("cp", "aten.clone.default", "bf16", (2, 48, 4),
                      ["c1"]))
    return _graph(*specs)


def test_donation_rule():
    g = _donation_graph()
    assert g.alias_pairs == 2
    assert _run("buffer-donation", RuleContext(
        entry="t", graph=g, expect_donation=2))[0] == []
    findings, _ = _run("buffer-donation", RuleContext(
        entry="t", graph=g, expect_donation=3))
    assert len(findings) == 1 and "2" in findings[0].message
    # expect_donation=None disables the check entirely
    assert _run("buffer-donation", RuleContext(entry="t", graph=g))[0] == []
    # a written input copied whole outside a kernel is not donated
    assert _donation_graph(copy=True).alias_pairs == 1


def test_dtype_policy_rule():
    g = _graph(
        ("p", "parameter", "bf16", (2048, 2048)),
        ("q", "parameter", "s8", (64, 64)),
        ("w", "aten._to_copy.default", "f32", (2048, 2048), ["p"]),
        ("qq", "aten._to_copy.default", "f32", (64, 64), ["q"]),
        ("d", "aten._to_copy.default", "f64", (2048, 2048), ["w"]),
        # a slice of the bf16 param widened: not full-shape, clean
        ("ps", "aten.slice.Tensor", "bf16", (1024, 2048), ["p"],
         {"is_view": True}),
        ("pw", "aten._to_copy.default", "f32", (1024, 2048), ["ps"]))
    findings, _ = _run("dtype-policy", RuleContext(entry="t", graph=g))
    msgs = "\n".join(f.message for f in findings)
    assert "f64" in msgs and "%p" in msgs and "%q" in msgs
    assert len(findings) == 3


def test_vocab_collectives_rule():
    g = _graph(
        ("x", "parameter", "f32", (8, 64)),
        ("ag", "_c10d_functional.all_gather_into_tensor.default", "f32",
         (8, 512), ["x"]),
        ("ar", "_c10d_functional.all_reduce.default", "f32", (8, 64),
         ["x"]))
    findings, _ = _run("vocab-collectives", RuleContext(
        entry="t", graph=g, vocabs=(512,)))
    assert len(findings) == 1 and "all_gather" in findings[0].message


def test_wide_dequant_taint():
    g = _graph(
        ("p", "parameter", "s8", (256, 64)),
        ("w", "parameter", "f32", (256, 64)),      # same shape: clean
        ("d", "aten._to_copy.default", "f32", (256, 64), ["p"]),
        ("o", "aten.add.Tensor", "f32", (256, 64), ["d", "w"]))
    assert [h.name for h in find_wide_copies(g, (64, 256))] == ["d", "o"]
    findings, _ = _run("wide-dequant", RuleContext(entry="t", graph=g))
    assert findings and all("%p" in f.message for f in findings)


def test_suppressions_are_recorded_not_hidden():
    g = _graph(*_TOY)
    ctx = RuleContext(entry="decode", graph=g, batch=4, vocabs=(512,),
                      suppress=(("logits-materialization", "decode"),))
    findings, suppressed = run_rules(
        ctx, get_rules(["logits-materialization"]))
    assert findings == [] and len(suppressed) == 2
    assert suppressed[0].rule == "logits-materialization"


def test_rule_counters_land_in_obs():
    from repro_torch import obs
    with obs.capture(trace=False) as (reg, _):
        g = _graph(*_TOY[:4])
        ctx = RuleContext(entry="t", graph=g, batch=4, vocabs=(512,))
        run_rules(ctx, get_rules(["logits-materialization"]))
        snap = reg.snapshot()
    assert snap["lint.findings_total"]["value"] == 1
    assert snap["lint.findings.logits-materialization_total"]["value"] == 1


def test_rule_registry_names():
    assert [r.name for r in get_rules()] == sorted([
        "buffer-donation", "cuda-kernel-source", "dtype-policy",
        "logits-materialization", "torchfn-logits", "vocab-collectives",
        "wide-dequant"])
    with pytest.raises(KeyError, match="unknown lint rule"):
        get_rules(["jaxpr-logits"])


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_kernel_scope_marks_ops_in_kernel():
    h, w = torch.randn(4, 8), torch.randn(32, 8)

    def fn():
        with build.kernel_scope("sample_topk"):
            z = h @ w.T                  # a plain version's logits tile
            top = z.max(dim=-1)
        return top.values + 1.0

    out, g, fg = record(fn)
    assert out.shape == (4,)
    mm = [i for i in g if i.base == "mm"]
    assert len(mm) == 1 and mm[0].in_kernel and mm[0].kernel == "sample_topk"
    assert not [i for i in g if i.base == "add"][0].in_kernel
    assert g.scopes == {"sample_topk": 1}
    assert build._recorder is None
    # the scope is opaque at the torch-function level
    assert not [c for c in fg if c.name.endswith("matmul")]
    assert find_logits_defs(g, logits_targets(4, 32), (32,)) == []
    # a scope with no recorder active costs nothing and records nothing
    with build.kernel_scope("sample_topk"):
        pass


def test_kernel_buffer_of_logits_shape_is_flagged():
    h = torch.randn(4, 8)

    def fn():
        with build.kernel_scope("sample_topk"):
            buf = torch.empty((4, 32), dtype=torch.float32)   # (B, V)
            ids = torch.empty((4, 1), dtype=torch.int32)
        return buf.sum(-1), ids, h

    _, g, _ = record(fn)
    hits = find_logits_defs(g, logits_targets(4, 32), (32,))
    assert [h.base for h in hits] == ["empty"] and hits[0].in_kernel
    # outside a scope an allocation has no provenance
    _, g2, _ = record(lambda: torch.empty((4, 32)).sum(-1))
    assert find_logits_defs(g2, logits_targets(4, 32), (32,)) == []


def test_recorder_keeps_no_tensor_alive():
    x = torch.randn(64, 64)
    ref = weakref.ref(x)
    made = []

    def fn(t):
        y = t * 2.0
        made.append(weakref.ref(y))
        return (y @ t).sum()

    out, g, fg = record(fn, x)
    del x, out
    gc.collect()
    assert ref() is None and made[0]() is None
    assert len(g) > 0 and len(fg) > 0
    # the graph holds shapes and names only
    assert g.entry_parameters()[0].shape == OpShape("f32", (64, 64))


def test_inplace_write_taints_its_storage():
    h, w = torch.randn(2, 8), torch.randn(16, 8)
    cache = torch.zeros(2, 4, 16)

    def fn():
        before = cache.sum()                 # read before the write
        z = h @ w.T                          # (2, 16)
        cache[:, 1].copy_(z)                 # written through a view
        after = cache.sum()
        return before, after

    _, g, _ = record(fn)
    params = {i.shape.dims: i.name for i in g.entry_parameters()}
    cache_p = params[(2, 4, 16)]
    assert g.written_parameters() == {cache_p: [
        i.name for i in g if i.base == "copy_"]}
    assert g.alias_pairs == 1
    mm = [i.name for i in g if i.base == "mm"]
    sums = [i.name for i in g if i.base == "sum"]
    tainted = g.propagate(mm)
    assert cache_p in tainted                # the cache itself
    assert sums[1] in tainted and sums[0] not in tainted


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def test_logits_targets_match_the_reference():
    pytest.importorskip("jax")
    from repro.analysis.lint import logits_targets as ref
    for b in (1, 2, 8):
        for v in (1, 512, 151936):
            for seq in (None, 1, 4, 16):
                for heads in (None, 2):
                    assert logits_targets(b, v, seq=seq, heads=heads) == \
                        ref(b, v, seq=seq, heads=heads)


def test_roofline_formulas_match_the_reference():
    pytest.importorskip("jax")
    from repro.analysis import roofline as ref
    assert roofline.model_flops(10 ** 9, 4096, "train") == \
        ref.model_flops(10 ** 9, 4096, "train")
    assert roofline.model_flops(10 ** 9, 7, "decode") == \
        ref.model_flops(10 ** 9, 7, "decode")
    for kw in ({}, {"window": 64}, {"n_attn_layers": 3}):
        for kind in ("train", "prefill"):
            assert roofline.attention_flops(28, 16, 128, 1024, 8, kind,
                                            **kw) == \
                ref.attention_flops(28, 16, 128, 1024, 8, kind, **kw)
    args = (3.1e13, 2.2e11, 5.0e9, 2.0e13, 4.0e13)
    got = roofline.roofline_from_stats(*args)
    want = ref.roofline_from_stats(*args)
    f, b, c = (roofline.PEAK_FLOPS / ref.PEAK_FLOPS,
               roofline.HBM_BW / ref.HBM_BW, roofline.NVLINK_BW / ref.ICI_BW)
    assert got.compute_s * f == pytest.approx(want.compute_s, rel=1e-12)
    assert got.analytic_compute_s * f == pytest.approx(
        want.analytic_compute_s, rel=1e-12)
    assert got.memory_s * b == pytest.approx(want.memory_s, rel=1e-12)
    assert got.collective_s * c == pytest.approx(want.collective_s,
                                                 rel=1e-12)
    assert set(got.to_dict()) == set(want.to_dict())
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert roofline.HBM_BYTES > 0


@pytest.fixture(scope="module")
def decode_verdicts():
    """The reduced qwen3-0.6b decode step (batch 4, max_len 32) and the
    dense-sampler fixture, through both packages: {(package, level,
    program): flagged non-unit dims}."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.analysis.hlo import logits_intermediates as j_hlo_hits
    from repro.analysis.lint.jaxpr import logits_eqns
    from repro.analysis.lint import logits_targets as j_targets
    from repro.models.registry import forward_hidden as j_forward
    from repro.models.registry import get_arch as j_arch
    from repro.models.registry import init_params as j_init
    from repro.serve import Engine as JEngine
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve.engine import build_serve_fns

    from repro_torch.launch.analyze import dense_decode
    from repro_torch.models.registry import get_arch, init_params
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.analysis.lint.torchfn import logits_calls

    b = 4
    jarch = j_arch("qwen3-0.6b", reduced=True)
    jparams = j_init(jarch, jax.random.PRNGKey(0))
    jsc = JServeConfig(batch_size=b, max_len=32)
    jeng = JEngine(jarch, jparams, jsc)
    *_, jdecode = build_serve_fns(jarch, jsc)
    cur = jnp.zeros((b, 1), jnp.int32)
    key = jax.random.PRNGKey(0)

    def jdense(params, caches, tokens):
        h, _, caches = j_forward(jarch, params, {"tokens": tokens},
                                 caches=caches)
        return jnp.argmax(h[:, -1, :] @ params["lm_head"].T, -1), caches

    arch = get_arch("qwen3-0.6b", reduced=True)
    params = init_params(arch, torch.Generator().manual_seed(0))
    eng = Engine(arch, params, ServeConfig(batch_size=b, max_len=32),
                 device="cpu")
    _, g_dec, f_dec = record(eng.decode_step)
    with torch.no_grad():
        _, g_den, f_den = record(dense_decode(arch), params,
                                 eng._empty_caches(),
                                 torch.zeros((b, 1), dtype=torch.int64))
    v = arch.padded_vocab
    assert v == jarch.padded_vocab

    def dims(hits):
        return sorted(tuple(sorted(d for d in s if d != 1)) for s in hits)

    out = {}
    for prog, jx, fg in (
            ("decode", jax.make_jaxpr(jdecode)(jparams, jeng.caches, cur,
                                               key), f_dec),
            ("dense", jax.make_jaxpr(jdense)(jparams, jeng.caches, cur),
             f_den)):
        out[("jax", "fn", prog)] = dims(
            a.shape for _, _, a in logits_eqns(jx, j_targets(b, v)))
        out[("torch", "fn", prog)] = dims(
            s.dims for _, s in logits_calls(fg, logits_targets(b, v)))
    jdec_txt = (jax.jit(jdecode).lower(jparams, jeng.caches, cur, key)
                .compile().as_text())
    jden_txt = (jax.jit(jdense).lower(jparams, jeng.caches, cur)
                .compile().as_text())
    out[("jax", "graph", "decode")] = bool(j_hlo_hits(jdec_txt, b, v))
    out[("jax", "graph", "dense")] = bool(j_hlo_hits(jden_txt, b, v))
    out[("torch", "graph", "decode")] = bool(logits_intermediates(g_dec, b,
                                                                  v))
    out[("torch", "graph", "dense")] = bool(logits_intermediates(g_den, b,
                                                                 v))
    out["graphs"] = (g_dec, g_den, arch)
    return out


@pytest.mark.parametrize("prog,flagged", [("decode", False),
                                          ("dense", True)])
def test_torchfn_verdicts_match_jaxpr_logits(decode_verdicts, prog,
                                             flagged):
    j = decode_verdicts[("jax", "fn", prog)]
    t = decode_verdicts[("torch", "fn", prog)]
    assert bool(j) is flagged
    assert t == j


@pytest.mark.parametrize("prog,flagged", [("decode", False),
                                          ("dense", True)])
def test_op_graph_verdicts_match_the_reference(decode_verdicts, prog,
                                               flagged):
    """The port's op-graph check against the JAX HLO check on the same
    two programs (`tests/test_serve.py`'s logits-free decode test)."""
    assert decode_verdicts[("jax", "graph", prog)] is flagged
    assert decode_verdicts[("torch", "graph", prog)] is flagged
    g_dec, g_den, arch = decode_verdicts["graphs"]
    vocabs = (arch.vocab_size, arch.padded_vocab)
    if flagged:
        hits = find_logits_defs(g_den, logits_targets(4, vocabs[1]), vocabs)
        assert any(h.base == "mm" for h in hits)
        with pytest.raises(AssertionError, match="logits intermediate"):
            assert_logits_free(g_den, 4, vocabs)
    else:
        assert_logits_free(g_dec, 4, vocabs)
        # the step did go through the sampler's kernel scope
        assert g_dec.scopes == {"sample_topk": 1}


# ---------------------------------------------------------------------------
# the kernel-source lint
# ---------------------------------------------------------------------------

_WRAPPER = '''
import ctypes
from repro_torch.kernels import build

LAUNCHES = build.counter("toy")


def _lib():
    lib = build.load("toy")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.toy_launch.argtypes = [p, p, i, p]
    lib.toy_launch.restype = i
    for fn in (lib.toy_error_string,):
        fn.argtypes = [i]
        fn.restype = ctypes.c_char_p
    return lib


def toy(x, out):
    lib = _lib()
    err = lib.toy_launch(x.data_ptr(), out.data_ptr(), 4, None)
    if err:
        raise RuntimeError("toy launch failed: "
                           + lib.toy_error_string(err).decode())
    LAUNCHES.inc()
    return out
'''

_CU = '''
extern "C" {
// a comment with return 0; in it
int toy_launch(const void* x, void* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  toy_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
const char* toy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
}  // extern "C"
'''


def test_kernel_source_lint_clean_sources():
    assert lint_source(_WRAPPER, "toy/kernel.py") == []
    assert lint_source(_CU, "toy.cu") == []


@pytest.mark.parametrize("bug,find,replace,needle", [
    ("argtypes", "    lib.toy_launch.argtypes = [p, p, i, p]\n", "",
     "argtypes"),
    ("restype", "        fn.restype = ctypes.c_char_p\n", "", "restype"),
    ("uncounted", "    LAUNCHES.inc()\n", "", "LaunchCounter"),
    ("unchecked", "    if err:\n        raise RuntimeError(\"toy launch "
     "failed: \"\n                           + lib.toy_error_string(err)"
     ".decode())\n", "", "launch status"),
])
def test_kernel_source_lint_flags_each_wrapper_bug(bug, find, replace,
                                                   needle):
    assert find in _WRAPPER, bug
    findings = lint_source(_WRAPPER.replace(find, replace), "toy/kernel.py")
    assert len(findings) == 1 and needle in findings[0].message, findings
    assert findings[0].rule == "cuda-kernel-source"


def test_kernel_source_lint_counts_through_callers_and_helpers():
    # the launch in a helper counted by its only caller, the status
    # raised through a module helper (the fused-CE wrapper's layout)
    src = _WRAPPER.replace('''    err = lib.toy_launch(x.data_ptr(), out.data_ptr(), 4, None)
    if err:
        raise RuntimeError("toy launch failed: "
                           + lib.toy_error_string(err).decode())
    LAUNCHES.inc()
    return out
''', '''    out = _launch(lib, x, out)
    LAUNCHES.inc()
    return out


def _raise_on(err, lib):
    if err:
        raise RuntimeError(lib.toy_error_string(err).decode())


def _launch(lib, x, out):
    launch = lib.toy_launch
    err = launch(x.data_ptr(), out.data_ptr(), 4, None)
    _raise_on(err, lib)
    return out
''')
    assert lint_source(src, "toy/kernel.py") == []
    # a second, uncounted caller of the helper is a finding
    src2 = src + '''

def toy_again(lib, x, out):
    return _launch(lib, x, out)
'''
    findings = lint_source(src2, "toy/kernel.py")
    assert len(findings) == 1 and "'_launch'" in findings[0].message


def test_kernel_source_lint_flags_a_cuda_entry_without_last_error():
    bad = _CU.replace("  return (int)cudaGetLastError();\n",
                      "  return 0;\n")
    findings = lint_source(bad, "toy.cu")
    assert len(findings) == 1 and "toy_launch" in findings[0].message
    assert findings[0].where == "toy.cu:4"
    # a void entry cannot report its launch either
    void = _CU.replace("int toy_launch", "void toy_launch")
    assert len(lint_source(void, "toy.cu")) == 1


def test_repo_kernel_tree_is_source_clean():
    from repro_torch.launch.analyze import kernel_sources
    paths = kernel_sources()
    assert sum(p.endswith(".cu") for p in paths) == 4
    assert sum(p.endswith("kernel.py") for p in paths) == 4
    findings = []
    for p in paths:
        findings += lint_file(p)
    assert findings == [], [f"{f.where}: {f.message}" for f in findings]


def test_rule_runs_over_context_sources(tmp_path):
    path = tmp_path / "kernel.py"
    path.write_text(_WRAPPER.replace("    LAUNCHES.inc()\n", ""))
    findings, _ = run_rules(RuleContext(entry="kernels/ast",
                                        sources=[str(path)]),
                            get_rules(["cuda-kernel-source"]))
    assert len(findings) == 1 and findings[0].entry == "kernels/ast"
    assert np.all([f.where.startswith(str(path)) for f in findings])
