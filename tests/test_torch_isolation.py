"""The port stands alone: no module of `repro_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package `repro`."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_PORT = _ROOT / "src" / "repro_torch"
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


def _modules():
    for path in sorted(_PORT.rglob("*.py")):
        rel = path.relative_to(_PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_PORT.rglob("*.py"))
                         + [_ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(_FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    code = ("import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "2",
         "--max-new", "4"],
        env=_env(), capture_output=True, text=True, timeout=300,
        cwd=str(_ROOT))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[serve] arch=")]
    assert line and "served 2 requests (8 tokens)" in line[0], out.stdout
    assert "on cpu" in line[0]


def test_analysis_is_covered():
    """The static analysis (`analysis/`, `launch/analyze.py`) is among
    the modules checked above, and its CLI starts without JAX."""
    mods = set(_modules())
    assert {"repro_torch.analysis", "repro_torch.analysis.lint",
            "repro_torch.analysis.lint.ir", "repro_torch.analysis.lint.rules",
            "repro_torch.analysis.lint.torchfn",
            "repro_torch.analysis.lint.kernel_source",
            "repro_torch.analysis.trace", "repro_torch.analysis.roofline",
            "repro_torch.launch.analyze"} <= mods
    code = ("import sys\n"
            "from repro_torch.launch import analyze\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
