"""One eager run of an entry point -> aten-level op graph.

Port of `repro.analysis.lint.ir`.  The reference parses XLA's optimized
HLO; the port has no compiled module, so its IR is recorded: `record`
runs a function once under a `TorchDispatchMode`, and every aten op
becomes an :class:`Instruction` with its result shapes and def-use
edges.  In eager mode every aten result is a real buffer, so this graph
plays the HLO graph's role without the fusion caveat.  A
`TorchFunctionMode` records the torch-function-level calls of the same
run (`F.linear`, ``@``, `torch.einsum`, ...) into a :class:`FnGraph`,
the jaxpr's counterpart (`analysis/lint/torchfn.py`).

  * :class:`Instruction` — name, opcode (the aten overload), result
    shapes, operand names, the kernel scope it ran in (the counterpart
    of the reference's ``source_file`` exemption: every kernel entry
    point runs its launch, and on CPU tensors its plain version, inside
    `kernels.build.kernel_scope`), and ``line``: the op and the
    ``file:line`` of the innermost frame under ``src/repro_torch``.
  * :class:`OpGraph` — the instructions in program order, def-use edges,
    the entry parameters (tensors read before any recorded op wrote
    them: inputs, caches, params, optimizer state) and the in-place
    writes into their storage (`alias_pairs`, the counterpart of the
    compiled ``input_output_alias`` table).

Def-use edges follow storage as well as tensors: an op that reads a
tensor depends on the op that defined that tensor and on the last op
that wrote its storage in place, so ``cache.index_put_(...)`` followed
by a read of the cache (through any view) links the two.  View ops
(`VIEW_OPS`, or any op whose schema says its result aliases an input)
are never reported by the rules but carry taint.

The recorder keeps no tensor alive: tensors are known by weak
references, and only their shapes, dtypes and storage identities are
kept, so a full-width
training step can be recorded on the card.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Set, Tuple)

import torch

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e4m3b11fnuz": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "f8e3m4": 1, "f8e8m0fnu": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

# zero-size / opaque types that legitimately carry no byte width
SIZELESS_DTYPES = ("token", "opaque", "tuple")

# torch dtype -> the reference's spelling (each one of DTYPE_BYTES)
_TORCH_NAMES = {
    "bool": "pred", "int8": "s8", "uint8": "u8", "int16": "s16",
    "uint16": "u16", "int32": "s32", "uint32": "u32", "int64": "s64",
    "uint64": "u64", "float16": "f16", "bfloat16": "bf16",
    "float32": "f32", "float64": "f64", "complex64": "c64",
    "complex128": "c128", "float8_e4m3fn": "f8e4m3fn",
    "float8_e5m2": "f8e5m2", "float8_e4m3fnuz": "f8e4m3fnuz",
    "float8_e5m2fnuz": "f8e5m2fnuz", "float8_e8m0fnu": "f8e8m0fnu",
}
TORCH_DTYPES = {getattr(torch, k): v for k, v in _TORCH_NAMES.items()
                if hasattr(torch, k)}

# the reference's `_VIEW_OPS`: they alias or index a buffer rather than
# writing a new one, so they are never reported (taint flows through)
VIEW_OPS = ("parameter", "view", "_unsafe_view", "slice", "select",
            "expand", "permute", "transpose", "t", "unsqueeze", "squeeze",
            "as_strided", "alias", "detach")

# allocation ops: inside a kernel scope, a kernel's global-memory buffer
ALLOC_OPS = ("empty", "empty_like", "empty_strided", "zeros", "zeros_like",
             "ones", "ones_like", "full", "full_like", "new_empty",
             "new_empty_strided", "new_zeros", "new_ones", "new_full")

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))          # .../src/repro_torch
_SKIP = (os.path.join(_PKG, "analysis", "lint", ""),
         os.path.join(_PKG, "kernels", "build.py"))


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's spelling of a torch dtype; unknown ones raise."""
    try:
        return TORCH_DTYPES[dtype]
    except KeyError:
        raise ValueError(
            f"unknown dtype {dtype} — add it to repro_torch.analysis.lint"
            ".ir.TORCH_DTYPES so byte accounting cannot silently treat it "
            "as free") from None


@dataclasses.dataclass(frozen=True)
class OpShape:
    """One tensor shape: dtype (the reference's spelling) + dims."""
    dtype: str
    dims: Tuple[int, ...]

    def nonunit(self) -> Tuple[int, ...]:
        return tuple(sorted(d for d in self.dims if d != 1))

    @property
    def byte_width(self) -> int:
        if self.dtype in DTYPE_BYTES:
            return DTYPE_BYTES[self.dtype]
        if self.dtype in SIZELESS_DTYPES:
            return 0
        raise ValueError(
            f"unknown dtype {self.dtype!r} — add it to "
            "repro_torch.analysis.lint.ir.DTYPE_BYTES so byte accounting "
            "cannot silently treat it as free")

    @property
    def size_bytes(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n * self.byte_width

    @classmethod
    def of(cls, t: torch.Tensor) -> "OpShape":
        return cls(dtype_name(t.dtype), tuple(t.shape))


_NO_SHAPE = OpShape("tuple", ())


def _fmt(shape: OpShape) -> str:
    return f"{shape.dtype}[{','.join(str(d) for d in shape.dims)}]"


def base_name(opcode: str) -> str:
    """'mm' for 'aten.mm.default' (an opcode without dots: itself)."""
    parts = opcode.split(".")
    return parts[1] if len(parts) >= 2 else opcode


@dataclasses.dataclass
class Instruction:
    name: str                          # graph-unique, e.g. 'mm.12'
    opcode: str                        # aten overload, or 'parameter'
    shapes: Tuple[OpShape, ...] = ()   # every tensor result
    operands: Tuple[str, ...] = ()     # producer names (tensor + storage)
    where: str = ""                    # file:line under src/repro_torch
    lineno: int = 0                    # program order
    in_kernel: bool = False
    kernel: str = ""                   # the innermost kernel scope's name
    is_view: bool = False              # result aliases an input
    # (storage root, shape as read) of each tensor input: a full-shape
    # view of a parameter reads that parameter's root at its shape
    inputs: Tuple[Tuple[str, OpShape], ...] = ()
    writes: Tuple[str, ...] = ()       # storage roots written in place

    @property
    def shape(self) -> OpShape:
        return self.shapes[0] if self.shapes else _NO_SHAPE

    @property
    def line(self) -> str:
        """The op as one line: ``%name = type opcode(%operands)  # where``."""
        res = ", ".join(_fmt(sh) for sh in self.shapes) or "()"
        ops = ", ".join(f"%{o}" for o in self.operands)
        return f"%{self.name} = {res} {self.opcode}({ops})  # {self.where}"

    @property
    def base(self) -> str:
        return base_name(self.opcode)

    @property
    def reported(self) -> bool:
        """False for ops the rules never report (views, parameters)."""
        return not self.is_view and self.base not in VIEW_OPS


class OpGraph:
    """A recorded run: instructions in program order + def-use edges."""

    def __init__(self, instructions: Iterable[Instruction] = ()):
        self.instructions: Dict[str, Instruction] = {}
        self.scopes: Dict[str, int] = {}    # kernel -> scopes entered
        self._users: Optional[Dict[str, List[str]]] = None
        for instr in instructions:
            self.add(instr)

    def add(self, instr: Instruction) -> Instruction:
        if not instr.lineno:
            instr.lineno = len(self.instructions) + 1
        self.instructions[instr.name] = instr
        self._users = None
        return instr

    # -- queries ------------------------------------------------------------

    def __iter__(self) -> Iterator[Instruction]:
        return iter(self.instructions.values())

    def __len__(self) -> int:
        return len(self.instructions)

    def get(self, name: str) -> Optional[Instruction]:
        return self.instructions.get(name)

    def entry_parameters(self) -> List[Instruction]:
        return [i for i in self if i.opcode == "parameter"]

    def users(self, name: str) -> List[str]:
        if self._users is None:
            u: Dict[str, List[str]] = {}
            for instr in self:
                for op in dict.fromkeys(instr.operands):
                    if op in self.instructions:
                        u.setdefault(op, []).append(instr.name)
            self._users = u
        return self._users.get(name, [])

    def written_parameters(self) -> Dict[str, List[str]]:
        """Entry parameter -> the ops that wrote its storage in place."""
        out: Dict[str, List[str]] = {}
        for instr in self:
            for root in instr.writes:
                p = self.instructions.get(root)
                if p is not None and p.opcode == "parameter":
                    out.setdefault(root, []).append(instr.name)
        return out

    def copied_parameters(self) -> Dict[str, List[str]]:
        """Entry parameter -> its out-of-kernel full-size same-dtype
        copies (``clone``, ``copy``, a same-dtype ``_to_copy``): a donated
        input that is copied whole is not updated in place."""
        params = {i.name: i.shape for i in self.entry_parameters()}
        out: Dict[str, List[str]] = {}
        for instr in self:
            if instr.in_kernel or instr.base not in ("clone", "copy",
                                                     "_to_copy"):
                continue
            for root, s in instr.inputs:
                ps = params.get(root)
                if (ps is not None and instr.shape == ps
                        and s.nonunit() == ps.nonunit()):
                    out.setdefault(root, []).append(instr.name)
                    break
        return out

    @property
    def alias_pairs(self) -> int:
        """Entry parameters updated in place and never copied whole
        outside a kernel: the compiled module's donation table."""
        copied = self.copied_parameters()
        return sum(1 for p in self.written_parameters() if p not in copied)

    def propagate(self, seeds: Iterable[str],
                  stop: Optional[Callable[[Instruction], bool]] = None
                  ) -> Set[str]:
        """Forward value-taint: every instruction reachable from `seeds`
        along def-use edges.  A tainted op that writes a storage in place
        also taints that storage's root (a cache or a parameter), without
        reaching the ops that read it before the write.  Instructions for
        which `stop` is true are never tainted and never expanded: the
        logits rule stops at kernel-internal ops, so a plain version's
        (rows, V) tile cannot taint anything outside its kernel."""
        tainted: Set[str] = set()
        marked: Set[str] = set()
        work = [s for s in seeds if s in self.instructions]
        while work:
            n = work.pop()
            if n in tainted:
                continue
            instr = self.instructions[n]
            if stop is not None and stop(instr):
                continue
            tainted.add(n)
            work.extend(self.users(n))
            marked.update(r for r in instr.writes if r in self.instructions)
        return tainted | marked


@dataclasses.dataclass
class FnCall:
    """One torch-function-level call outside every kernel scope."""
    name: str                          # 'torch.einsum', 'Tensor.__matmul__'
    shapes: Tuple[OpShape, ...]
    line: str
    index: int


class FnGraph:
    """The torch-function-level calls of a recorded run, in order."""

    def __init__(self, calls: Iterable[FnCall] = ()):
        self.calls: List[FnCall] = list(calls)

    def __iter__(self) -> Iterator[FnCall]:
        return iter(self.calls)

    def __len__(self) -> int:
        return len(self.calls)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


_REL: Dict[str, Optional[str]] = {}      # filename -> package path


def _rel(fn: str) -> Optional[str]:
    rel = _REL.get(fn, "")
    if rel == "":
        rel = _REL[fn] = (os.path.relpath(fn, _PKG) if fn.startswith(_PKG)
                          and not fn.startswith(_SKIP) else None)
    return rel


def _where() -> str:
    """``file:line`` of the innermost frame under src/repro_torch (the
    recorder's own frames skipped), relative to the package."""
    f = sys._getframe(2)
    while f is not None:
        rel = _rel(f.f_code.co_filename)
        if rel is not None:
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _storage_key(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError, AttributeError):
        return -id(t)


_SCHEMAS: Dict[object, tuple] = {}      # aten overload -> _schema_info


def _schema_info(func) -> tuple:
    """(opcode, base name, [(index, name, kwarg_only)] of the arguments
    the op writes, whether its results alias inputs: a view)."""
    schema = func._schema
    opcode = str(func)
    writes = [(i, a.name, a.kwarg_only)
              for i, a in enumerate(schema.arguments)
              if a.alias_info is not None and a.alias_info.is_write]
    rets = schema.returns
    is_view = bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)
    return opcode, base_name(opcode), writes, is_view


class Recorder:
    """The state of one `record` run (see the module docstring)."""

    def __init__(self):
        self.graph = OpGraph()
        self.fn_graph = FnGraph()
        self.depth = 0                   # kernel scopes entered
        self.kernels: List[str] = []     # their names, innermost last
        self.scopes: Dict[str, int] = {}  # kernel -> scopes entered
        self._n = 0
        # id(tensor) -> (weakref, defining op): a dead or reused id fails
        # the weakref's identity check
        self._tdef: Dict[int, Tuple[weakref.ref, str]] = {}
        self._root: Dict[int, str] = {}      # storage -> first def
        self._last: Dict[int, str] = {}      # storage -> last writer
        self._alive: Dict[int, List[weakref.ref]] = {}

    # -- kernel scopes (kernels.build.kernel_scope) -------------------------

    def enter_kernel(self, name: str) -> None:
        self.depth += 1
        self.kernels.append(name)
        self.scopes[name] = self.scopes.get(name, 0) + 1

    def exit_kernel(self, name: str) -> None:
        self.depth -= 1
        self.kernels.pop()

    # -- graph construction -------------------------------------------------

    def _name(self, base: str) -> str:
        self._n += 1
        return f"{base}.{self._n}"

    def _note(self, t: torch.Tensor, s: int, name: str) -> None:
        """Record `name` as `t`'s def and `t` as alive on storage `s`."""
        ref = weakref.ref(t)
        self._tdef[id(t)] = (ref, name)
        refs = self._alive.setdefault(s, [])
        if len(refs) > 64:
            refs[:] = [r for r in refs if r() is not None]
        refs.append(ref)

    def _def_of(self, t: torch.Tensor, where: str) -> Tuple[str, int]:
        """(the op that defined `t`, its storage key); a tensor no
        recorded op made becomes an entry parameter."""
        s = _storage_key(t)
        ent = self._tdef.get(id(t))
        if ent is not None and ent[0]() is t:
            return ent[1], s
        shared = s in self._root and any(
            r() is not None for r in self._alive.get(s, ()))
        if shared:
            # a tensor made outside the dispatcher on a known storage
            # (``p.data``): it reads that storage's last writer
            name = self._last[s]
        else:
            name = self._name("param")
            shape = OpShape.of(t)
            self.graph.add(Instruction(
                name=name, opcode="parameter", shapes=(shape,),
                where=where, in_kernel=self.depth > 0,
                kernel=self.kernels[-1] if self.kernels else ""))
            self._root[s] = self._last[s] = name
        self._note(t, s, name)
        return name, s

    def on_op(self, func, args, kwargs, out) -> None:
        where = _where()
        info = _SCHEMAS.get(func)
        if info is None:
            info = _SCHEMAS[func] = _schema_info(func)
        opcode, base, write_args, is_view = info
        written: Dict[int, torch.Tensor] = {}
        for i, arg, kwarg_only in write_args:
            val = (args[i] if i < len(args) and not kwarg_only
                   else kwargs.get(arg))
            for t in _tensors(val):
                written[id(t)] = t
        operands: Dict[str, None] = {}
        inputs: List[Tuple[str, OpShape]] = []
        for t in _tensors((args, kwargs)) if kwargs else _tensors(args):
            d, s = self._def_of(t, where)
            operands[d] = None
            last = self._last.get(s)
            if last is not None:
                operands[last] = None
            inputs.append((self._root.get(s, d), OpShape.of(t)))
        name = self._name(base)
        writes: List[str] = []
        for t in written.values():
            s = _storage_key(t)
            writes.append(self._root.get(s, name))
            self._last[s] = name
        outs = _tensors(out)
        for o in outs:
            s = _storage_key(o)
            if id(o) not in written and not is_view:
                self._root[s] = self._last[s] = name
                self._alive[s] = []
            self._note(o, s, name)
        self.graph.add(Instruction(
            name=name, opcode=opcode,
            shapes=tuple(OpShape.of(o) for o in outs),
            operands=tuple(operands), where=where,
            in_kernel=self.depth > 0,
            kernel=self.kernels[-1] if self.kernels else "",
            is_view=is_view, inputs=tuple(inputs), writes=tuple(writes)))

    def on_call(self, func, out) -> None:
        if self.depth > 0:
            return                      # a kernel scope is opaque here
        ts = _tensors(out)
        if not ts:
            return
        self.fn_graph.calls.append(FnCall(
            name=_fn_name(func), shapes=tuple(OpShape.of(t) for t in ts),
            line=_where(), index=len(self.fn_graph.calls) + 1))


def _fn_name(func) -> str:
    qual = getattr(func, "__qualname__", None) or getattr(
        func, "__name__", repr(func))
    owner, _, attr = qual.rpartition(".")
    if attr == "__get__" and hasattr(func, "__self__"):
        return f"Tensor.{getattr(func.__self__, '__name__', '?')}"
    if owner in ("TensorBase", "Tensor"):
        return f"Tensor.{attr}"
    if owner == "_VariableFunctionsClass":
        return f"torch.{attr}"
    mod = getattr(func, "__module__", None) or ""
    if mod.startswith("torch._C._nn"):
        mod = "torch.nn.functional"
    return f"{mod}.{qual}" if mod else qual


def record(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` once, eagerly, recording its aten ops and
    its torch-function calls.  Returns ``(out, OpGraph, FnGraph)``; the
    recorder's scope counts are on ``OpGraph.scopes`` (kernel -> scopes
    entered: on the card, each one launch)."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import build

    rec = Recorder()

    class _Dispatch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            rec.on_op(func, args, kwargs, out)
            return out

    class _Functions(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            rec.on_call(func, out)
            return out

    if build._recorder is not None:
        raise RuntimeError("record() does not nest")
    build._recorder = rec
    try:
        with _Functions(), _Dispatch():
            out = fn(*args, **kw)
    finally:
        build._recorder = None
    rec.graph.scopes = dict(rec.scopes)
    return out, rec.graph, rec.fn_graph
