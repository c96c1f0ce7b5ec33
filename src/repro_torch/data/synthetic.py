"""Deterministic synthetic LM data stream (a copy of
`repro.data.synthetic`, numpy only: the same seed gives bit-identical
batches in both packages).

A seeded Zipfian Markov-chain token generator: reproducible across
hosts (each host derives its shard from (seed, step, host_shard)),
learnable structure (bigram dependencies a model can fit), and zero I/O.
Documents have random lengths and are packed into fixed-size rows with
EOS separators and ignore-index masking of the positions without a next
token.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.core.types import IGNORE_INDEX


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512
    zipf_alpha: float = 1.1
    num_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Infinite deterministic stream of packed (tokens, targets) batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        rng = np.random.default_rng(cfg.seed)
        # Zipfian unigram distribution over the vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = ranks ** (-cfg.zipf_alpha)
        self._unigram /= self._unigram.sum()
        # sparse bigram structure: each token has a few favored successors
        self._succ = rng.integers(0, v, size=(v, 4))
        self._mix = 0.7   # P(pick a favored successor)

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        n = max(2, int(rng.exponential(self.cfg.mean_doc_len)))
        n = min(n, 4 * self.cfg.mean_doc_len)
        toks = np.empty(n, np.int64)
        toks[0] = rng.choice(len(self._unigram), p=self._unigram)
        unif = rng.random(n)
        jumps = rng.choice(len(self._unigram), size=n, p=self._unigram)
        picks = rng.integers(0, 4, size=n)
        for i in range(1, n):
            if unif[i] < self._mix:
                toks[i] = self._succ[toks[i - 1], picks[i]]
            else:
                toks[i] = jumps[i]
        return toks

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Host-local shard of the global batch for `step` (deterministic)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index, 0xD1CE))
        rows_tok = np.full((cfg.host_batch, cfg.seq_len), cfg.eos_id,
                           np.int32)
        rows_tgt = np.full((cfg.host_batch, cfg.seq_len), IGNORE_INDEX,
                           np.int32)
        for r in range(cfg.host_batch):
            pos = 0
            while pos < cfg.seq_len:
                doc = self._doc(rng)
                take = min(len(doc), cfg.seq_len - pos)
                rows_tok[r, pos:pos + take] = doc[:take]
                # next-token targets within the doc
                rows_tgt[r, pos:pos + take - 1] = doc[1:take]
                if pos + take < cfg.seq_len:
                    rows_tgt[r, pos + take - 1] = cfg.eos_id
                pos += take
        return {"tokens": rows_tok, "targets": rows_tgt}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
