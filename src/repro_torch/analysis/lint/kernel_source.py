"""Lint of the port's kernel wrappers and CUDA sources (the counterpart
of `repro.analysis.lint.pallas_ast`, registered as
``cuda-kernel-source``).

The reference's two checks are Pallas-only (``pl.program_id`` inside a
``pl.when`` body, impure ``BlockSpec`` index maps); the port has no
Pallas.  Its kernels are `ctypes` calls into ``extern "C"`` entries, and
three bug classes of that boundary are checked instead:

  (a) every ``lib.<fn>`` a ``kernels/*/kernel.py`` wrapper calls has
      ``argtypes`` and ``restype`` declared in its ``_lib()``: without
      ``argtypes`` ctypes passes a Python int as a C ``int``, truncating
      a pointer; without ``restype`` a pointer result is truncated too;
  (b) every function that calls a launch entry (``lib.*_launch``)
      increments a `LaunchCounter` (``<counter>.inc()``), itself or in
      every function of the module that calls it;
  (c) every ``extern "C"`` launch entry of a ``.cu`` source ends by
      returning ``cudaGetLastError()``, and every wrapper call of one
      raises on a non-zero status with the library's
      ``*_error_string``, inline (``if err: raise ...``) or through a
      helper of the module that does (``_raise_on(err, ...)``).

Both halves are plain-text walks (the Python `ast`, and a brace matcher
over the CUDA source); nothing is built or imported.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from repro_torch.analysis.lint.rules import Finding, Rule, RuleContext, \
    register

RULE = "cuda-kernel-source"


# ---------------------------------------------------------------------------
# Python wrappers
# ---------------------------------------------------------------------------


def _lib_attr(node: ast.AST) -> Optional[str]:
    """'X' for ``lib.X``."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "lib"):
        return node.attr
    return None


def _declared(fn: ast.FunctionDef) -> Dict[str, Set[str]]:
    """``{entry: {'argtypes', 'restype'}}`` declared in `_lib()`, also
    through ``for f in (lib.a, lib.b): f.argtypes = ...`` loops."""
    out: Dict[str, Set[str]] = {}

    def note(target: ast.AST, loop: Dict[str, List[str]]):
        if not (isinstance(target, ast.Attribute)
                and target.attr in ("argtypes", "restype")):
            return
        name = _lib_attr(target.value)
        if name is not None:
            out.setdefault(name, set()).add(target.attr)
        elif isinstance(target.value, ast.Name):
            for n in loop.get(target.value.id, ()):
                out.setdefault(n, set()).add(target.attr)

    def walk(body, loop):
        for stmt in body:
            if isinstance(stmt, ast.For) and isinstance(stmt.target,
                                                        ast.Name):
                elts = getattr(stmt.iter, "elts", [])
                names = [n for n in (_lib_attr(e) for e in elts) if n]
                walk(stmt.body, dict(loop, **{stmt.target.id: names}))
                continue
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    note(t, loop)
            for field in ("body", "orelse"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list) and not isinstance(stmt, ast.For):
                    walk(sub, loop)

    walk(fn.body, {})
    return out


def _functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _calls_inc(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "inc" for n in ast.walk(fn))


def _launch_names(fn: ast.AST) -> Set[str]:
    """Launch entries (``lib.*_launch``) that `fn` references."""
    return {a for a in (_lib_attr(n) for n in ast.walk(fn))
            if a and a.endswith("_launch")}


def _raises_with_error_string(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Raise) and any(
        isinstance(m, ast.Attribute) and m.attr.endswith("_error_string")
        for m in ast.walk(n)) for n in ast.walk(node))


def _status_names(fn: ast.AST) -> Set[str]:
    """Names assigned the result of a launch call (``err = ...``)."""
    names = set()
    for n in ast.walk(fn):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)):
            callee = n.value.func
            name = _lib_attr(callee)
            if (name and name.endswith("_launch")) or isinstance(
                    callee, ast.Name):
                names.add(n.targets[0].id)
    return names


def _checks_status(fn: ast.AST, helpers: Set[str]) -> bool:
    """Whether `fn` raises on its launch status: ``if err: raise ...
    *_error_string ...`` or ``helper(err, ...)``."""
    status = _status_names(fn)
    for n in ast.walk(fn):
        if isinstance(n, ast.If) and any(
                isinstance(m, ast.Name) and m.id in status
                for m in ast.walk(n.test)) and _raises_with_error_string(n):
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in helpers and n.args
                and isinstance(n.args[0], ast.Name)
                and n.args[0].id in status):
            return True
    return False


def lint_python(src: str, path: str = "<source>") -> List[Finding]:
    """Checks (a), (b) and the wrapper half of (c) over one kernel.py."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(RULE, f"unparsable kernel wrapper: {e.msg}",
                        f"{path}:{e.lineno or 0}")]
    fns = _functions(tree)
    out: List[Finding] = []
    lib_fn = fns.get("_lib")
    declared = _declared(lib_fn) if lib_fn is not None else {}
    used: Dict[str, int] = {}
    for fn in fns.values():
        if fn is lib_fn:
            continue
        for n in ast.walk(fn):
            name = _lib_attr(n)
            if name and isinstance(n.ctx, ast.Load):
                used.setdefault(name, n.lineno)
    for name, line in sorted(used.items(), key=lambda kv: kv[1]):
        missing = {"argtypes", "restype"} - declared.get(name, set())
        if missing:
            out.append(Finding(
                RULE, f"'lib.{name}' is called without "
                f"{' and '.join(sorted(missing))} declared in _lib() — "
                "ctypes would pass or return pointers as C ints",
                f"{path}:{line}"))

    # (b) launches counted, by the launching function or all its callers
    callers: Dict[str, List[str]] = {}
    for fn in fns.values():
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id in fns:
                callers.setdefault(n.func.id, []).append(fn.name)

    def counted(name: str, seen: Set[str]) -> bool:
        if name in seen:
            return False
        fn = fns[name]
        if _calls_inc(fn):
            return True
        up = callers.get(name, [])
        return bool(up) and all(counted(c, seen | {name}) for c in up)

    helpers = {f.name for f in fns.values()
               if _raises_with_error_string(f) and f.args.args}
    for fn in fns.values():
        if fn is lib_fn or not _launch_names(fn):
            continue
        if not counted(fn.name, set()):
            out.append(Finding(
                RULE, f"'{fn.name}' launches "
                f"{sorted(_launch_names(fn))} without incrementing a "
                "LaunchCounter (itself or in every caller)",
                f"{path}:{fn.lineno}"))
        if not _checks_status(fn, helpers):
            out.append(Finding(
                RULE, f"'{fn.name}' does not raise on the launch status "
                "with the library's *_error_string",
                f"{path}:{fn.lineno}"))
    return out


# ---------------------------------------------------------------------------
# CUDA sources
# ---------------------------------------------------------------------------

_EXTERN_RE = re.compile(r'extern\s+"C"\s*\{')
_ENTRY_RE = re.compile(r"\b(\w+)\s+(\w+_launch)\s*\(")


def _strip_comments(src: str) -> str:
    """Comments blanked (newlines kept, so line numbers stay)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, src, flags=re.S)


def _match_brace(text: str, at: int) -> int:
    """Index one past the '}' matching the '{' at `at`."""
    depth = 0
    for i in range(at, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def lint_cuda(src: str, path: str = "<source>") -> List[Finding]:
    """Check (c)'s source half: every ``extern "C"`` launch entry ends
    with ``return (int)cudaGetLastError();``."""
    text = _strip_comments(src)
    out: List[Finding] = []
    for m in _EXTERN_RE.finditer(text):
        start = m.end() - 1
        end = _match_brace(text, start)
        block = text[start:end]
        for e in _ENTRY_RE.finditer(block):
            ret, name = e.group(1), e.group(2)
            body_at = block.find("{", e.end())
            if body_at < 0 or ";" in block[e.end():body_at]:
                continue                      # a declaration
            body = block[body_at:_match_brace(block, body_at)]
            line = text.count("\n", 0, start + e.start()) + 1
            returns = re.findall(r"\breturn\b([^;]*);", body)
            if ret != "int" or not returns or \
                    "cudaGetLastError()" not in returns[-1]:
                out.append(Finding(
                    RULE, f"launch entry '{name}' must return int and end "
                    "with 'return (int)cudaGetLastError();' (a failed "
                    "launch would otherwise go unreported)",
                    f"{path}:{line}"))
    return out


def lint_source(src: str, path: str = "<source>") -> List[Finding]:
    """Lint one source string: CUDA (``.cu``, ``.cuh``) or a Python
    kernel wrapper, by `path`'s suffix."""
    if path.endswith((".cu", ".cuh")):
        return lint_cuda(src, path)
    return lint_python(src, path)


def lint_file(path: str) -> List[Finding]:
    with open(path, "r") as f:
        return lint_source(f.read(), path)


@register
class CudaKernelSourceRule(Rule):
    """Lint every kernel source file handed to the context."""

    name = RULE
    requires = "source"

    def run(self, ctx: RuleContext) -> List[Finding]:
        out: List[Finding] = []
        for path in ctx.sources:
            out.extend(lint_file(path))
        return out
