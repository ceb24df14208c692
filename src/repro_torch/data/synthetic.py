"""Synthetic Zipfian corpus pipeline (copy of ``repro.data.synthetic``; the
code is numpy, so the port keeps its own copy rather than importing the JAX
package).

Deterministic, shardable, resumable: batch t of a run is a pure function of
(seed, step, shard), so both packages draw the same tokens bit for bit, and
restarts never replay or skip data. The token stream is a Zipf(alpha)
unigram draw filtered through a cheap bigram mixer so models have structure
to learn (repetition and local agreement).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


def zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = r ** (-alpha)
    return (p / p.sum()).astype(np.float64)


@dataclasses.dataclass
class SyntheticCorpus:
    vocab: int
    seed: int = 0
    alpha: float = 1.1
    mix: float = 0.3          # bigram-structure strength

    def __post_init__(self):
        self.probs = zipf_probs(self.vocab, self.alpha)
        rng = np.random.RandomState(self.seed)
        # deterministic "successor" map: w -> preferred next word
        self.successor = rng.permutation(self.vocab)

    def batch(self, step: int, batch: int, seq_len: int,
              shard: int = 0, n_shards: int = 1) -> np.ndarray:
        """Tokens (batch, seq_len + 1) for (step, shard) — pure function."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 977 + shard) % (2 ** 31))
        base = rng.choice(self.vocab, size=(batch, seq_len + 1),
                          p=self.probs)
        use_succ = rng.rand(batch, seq_len + 1) < self.mix
        out = base.copy()
        for t in range(1, seq_len + 1):
            out[:, t] = np.where(use_succ[:, t],
                                 self.successor[out[:, t - 1]], base[:, t])
        return out.astype(np.int32)


@dataclasses.dataclass
class DataState:
    """Checkpointable iterator state."""
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @staticmethod
    def from_dict(d):
        return DataState(step=int(d["step"]))


class DataIterator:
    """Shard-aware iterator over SyntheticCorpus with resumable state.
    Yields numpy ``(tokens, labels)``; the caller moves them to its
    device."""

    def __init__(self, corpus: SyntheticCorpus, batch: int, seq_len: int,
                 shard: int = 0, n_shards: int = 1, state: DataState = None,
                 n_codebooks: int = 0):
        self.corpus = corpus
        self.batch = batch
        self.seq_len = seq_len
        self.shard = shard
        self.n_shards = n_shards
        self.state = state or DataState()
        self.n_codebooks = n_codebooks

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        toks = self.corpus.batch(self.state.step, self.batch, self.seq_len,
                                 self.shard, self.n_shards)
        self.state = DataState(self.state.step + 1)
        if self.n_codebooks:
            # audio: C parallel codebook streams with the delay pattern
            reps = [np.roll(toks, c, axis=1) for c in range(self.n_codebooks)]
            toks = np.stack(reps, axis=-1) % self.corpus.vocab
            return toks[:, :-1], toks[:, 1:]
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator:
        return self
