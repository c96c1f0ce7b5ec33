"""The port's static-analysis driver (`repro_torch.launch.analyze`) on the
CPU, where every kernel entry point runs its plain version inside its
kernel scope.

  * the matrix, parametrised by family: every hot path clean (or exactly
    its listed open findings, ROADMAP §C), both fixtures flagged, the
    kernel sources clean, and each recorded entry through the kernel
    scopes its path takes;
  * the matrix's entry names and expectations equal the JAX package's
    (`repro.launch.analyze`, read from its source: the reference
    compiles each entry, which this test does not need);
  * the CLI: ``--smoke`` exits 0, and any ``--suppress`` in use makes it
    exit 1.
"""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.launch import analyze as A  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_FAMILIES = [f for f, _, _ in A._FAMILIES]

# the kernel scopes each hot path enters on the CPU (on the card each
# is one launch of that kernel)
_SCOPES = {
    "train_exact": {"fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"},
    "train_filtered": {"fused_ce_fwd", "fused_ce_dh_filtered",
                       "fused_ce_dw_filtered"},
    "decode_slab": {"sample_topk"},
    "beam_topk": {"sample_topk"},
    "masked_decode": {"sample_topk"},
    "eval_score": {"score_tokens"},
    "spec_verify": {"score_tokens"},
    "decode_quant": {"sample_topk", "paged_attn"},
}


@pytest.fixture(scope="module")
def report():
    with obs.capture(trace=True):
        return A.analyze(device="cpu", progress=lambda *a: None)


def _rows(report, family):
    return {r["entry"].split("/", 1)[1]: r for r in report["entries"]
            if r["entry"].startswith(family + "/")}


@pytest.mark.parametrize("family", _FAMILIES)
def test_family_matrix_as_expected(report, family):
    rows = _rows(report, family)
    assert rows, family
    for name, r in rows.items():
        if r["expect"] == "flagged":
            continue
        entry = f"{family}/{name}"
        assert r["ok"], (entry, r["findings"])
        assert sorted({f["rule"] for f in r["findings"]}) == sorted(
            A.OPEN_FINDINGS.get(entry, ())), entry
        assert r["suppressed"] == []
        want = set(_SCOPES.get(name, ()))
        if name == "decode_paged":
            # a paged engine attends through paged_attn where the family
            # has pageable caches (the transformer's and enc-dec's)
            want = {"sample_topk"} | ({"paged_attn"} if family in (
                "transformer", "encdec") else set())
        assert set(r["scopes"]) == want, (entry, r["scopes"])
        assert r["launches"] == {}, entry       # plain versions only
        assert r["ops"] > 0


def test_fixtures_flagged_and_sources_clean(report):
    rows = {r["entry"]: r for r in report["entries"]}
    canon = rows["transformer/fixture_canonical_loss"]
    dense = rows["transformer/fixture_dense_sampler"]
    for r in (canon, dense):
        assert r["expect"] == "flagged" and r["ok"]
        assert {"logits-materialization", "torchfn-logits"} <= {
            f["rule"] for f in r["findings"]}
    assert any("aten.mm" in f["message"] for f in dense["findings"])
    ast_row = rows["kernels/ast"]
    assert ast_row["ok"] and ast_row["findings"] == []
    t = report["totals"]
    assert t["entries"] == 36 and t["suppressed"] == 0
    assert t["violations"] == 0 and report["violations"] == []
    assert report["metrics"]["lint.findings_total"]["value"] == t[
        "findings"]


def _reference_matrix():
    """[(entry, expect)] of the JAX driver, read from its source."""
    src = (_ROOT / "src" / "repro" / "launch" / "analyze.py").read_text()
    tree = ast.parse(src)
    fams = next(n for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "_FAMILIES")
    families = [e.elts[0].value for e in fams.value.elts]

    def yields(fn):
        out = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Yield)
                    and isinstance(node.value, ast.Tuple)):
                continue
            call, expect = node.value.elts
            first = call.args[0]
            if isinstance(first, ast.JoinedStr):
                name = first.values[-1].value.lstrip("/")
            else:
                name = first.value
            out.append((node.lineno, name, expect.value))
        return out

    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    fam_entries = yields(fns["_family_entries"])
    quant_line = next(n.lineno for n in ast.walk(fns["_family_entries"])
                      if isinstance(n, ast.If))
    matrix = []
    for fam in families:
        for line, name, expect in sorted(fam_entries):
            if line > quant_line and fam != "transformer":
                continue
            matrix.append((f"{fam}/{name}", expect))
    for _, name, expect in sorted(yields(fns["_fixture_entries"])):
        prefix = "" if "/" in name else "transformer/"
        matrix.append((prefix + name, expect))
    matrix.append(("kernels/ast", "clean"))
    return matrix


def test_matrix_matches_the_reference(report):
    ref = _reference_matrix()
    assert len(ref) == 36
    got = [(r["entry"], r["expect"]) for r in report["entries"]]
    assert sorted(got) == sorted(ref)
    assert [f for f, _, _ in A._FAMILIES] == [
        "transformer", "griffin", "xlstm", "encdec"]


def test_xlstm_decode_updates_its_state_in_place(report):
    """ROADMAP §C 2, repaired: the xlstm decode step writes its state
    into the caches it was given, so the buffer-donation rule finds the
    in-place updates the reference's donation promises."""
    row = _rows(report, "xlstm")["decode_slab"]
    assert row["ok"] and row["findings"] == [], row["findings"]
    assert "xlstm/decode_slab" not in A.OPEN_FINDINGS


def test_open_findings_are_listed_in_the_roadmap():
    roadmap = (_ROOT / "ROADMAP.md").read_text()
    for entry, rules in A.OPEN_FINDINGS.items():
        for rule in rules:
            assert f"`{entry}` {rule}" in roadmap, (entry, rule)


@pytest.mark.parametrize("argv,rc", [
    ([], 0),
    (["--suppress", "torchfn-logits:fixture_dense"], 1),
])
def test_cli_smoke_gate(argv, rc, capsys):
    try:
        got = A.main(["--smoke", "--device", "cpu", "--families",
                      "transformer", *argv])
    finally:
        obs.disable()
    out = capsys.readouterr().out
    assert got == rc, out
    if rc:
        assert "suppression(s) in use" in out
    else:
        assert "all entries as expected" in out


def test_card_widths():
    """On the card the reduced configs run in bf16 at d % 64 == 0, and
    paged attention's head_dim % 8 == 0 (what the kernels take)."""
    for _, arch_id, _ in A._FAMILIES:
        arch = A.arch_for(arch_id, torch.device("cuda"))
        assert arch.cfg.d_model % 64 == 0
        assert arch.cfg.param_dtype == arch.cfg.compute_dtype == "bfloat16"
        hd = getattr(arch.cfg, "resolved_head_dim", None)
        if hd is not None:
            assert hd % 8 == 0
        assert A.arch_for(arch_id, torch.device("cpu")) == \
            A.get_arch(arch_id, reduced=True)
