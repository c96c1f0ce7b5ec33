"""The JAX package's engines, shared within a port test module.

A JAX engine jits its own closures, so every new instance traces and
compiles its prefill and decode functions again: seconds a test on the
CPU.  `engine` builds one engine per class and constructor arguments and
hands it back reset on every later request (`reset`: a fresh cache tree,
slot template, RNG and masks; on a paged engine a fresh pool and trie;
on a speculative one the draft's too), as a new engine starts.  The JAX
engines are the reference that the port's own, always new, engines are
held to.
"""

import dataclasses

_ENGINES = {}


def _key(x):
    # configs by their fields; weights and anything else by identity (the
    # cache keeps them alive, so no other object can take their id)
    return ("cfg", repr(x)) if dataclasses.is_dataclass(x) else id(x)


def engine(cls, *args):
    """``cls(*args)``, built once a module for equal configs and the same
    weights, and reset whenever it is handed out again."""
    key = (cls,) + tuple(_key(a) for a in args)
    hit = _ENGINES.get(key)
    if hit is not None:
        hit[0].reset()
        return hit[0]
    eng = cls(*args)
    _ENGINES[key] = (eng, args)
    return eng
