"""Synthetic TinyStories-style data pipeline.

The port's own copy of ``repro/data/pipeline.py`` (the port imports nothing
of the JAX package), numpy as there: the same seeds draw the same batches
bit for bit, and ``state()`` is the same dict, so either package's
``restore()`` resumes the other's stream.  The stream runs on the host, one
token at a time (``_doc``), as the reference's does.

The paper evaluates on TinyStories (Karpathy's 110M llama2.c model).  No
dataset ships with this container, so the pipeline generates a *synthetic
language* with TinyStories-like statistics: a small vocabulary of "words"
with Zipfian frequencies, Markov bigram structure, and sentence/story
delimiters.  It is deterministic (seeded), infinite, shardable per host,
and exercises every real pipeline concern: tokenization, document packing,
shuffling windows, per-host sharding, and checkpointable iterator state.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    batch_size: int = 8            # per-host batch
    seed: int = 0                  # stream position seed (per host / eval)
    language_seed: int = 42        # fixes the synthetic LANGUAGE (bigram
                                   # structure) — train and eval streams
                                   # must share it or perplexity is
                                   # measured against a different language
    n_special: int = 4             # pad=0, bos=1, eos=2, sep=3
    zipf_a: float = 1.1            # word-frequency skew
    mean_doc_len: int = 180        # tokens per "story"
    host_id: int = 0
    n_hosts: int = 1


PAD, BOS, EOS, SEP = 0, 1, 2, 3


class SyntheticTinyStories:
    """Deterministic Markov-bigram token stream packed into fixed windows.

    State (``state()``/``restore()``) is a tiny tuple, checkpointed with
    the train state so restarts resume the exact stream position.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(
            [cfg.seed, cfg.host_id])
        v = cfg.vocab_size - cfg.n_special
        # Zipfian unigram distribution over the non-special vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._unigram = probs / probs.sum()
        # sparse bigram tendencies: each word prefers a small successor set
        g = np.random.default_rng(cfg.language_seed)
        self._succ = g.integers(0, v, size=(v, 8))
        self._step = 0
        self._buf = np.empty(0, np.int32)

    # -- iterator state ----------------------------------------------------
    def state(self) -> dict:
        return {"rng": self._rng.bit_generator.state, "step": self._step,
                "buf": self._buf.tolist()}

    def restore(self, st: dict) -> None:
        self._rng.bit_generator.state = st["rng"]
        self._step = int(st["step"])
        self._buf = np.asarray(st.get("buf", []), np.int32)

    # -- generation ---------------------------------------------------------
    def _doc(self) -> np.ndarray:
        cfg = self.cfg
        n = max(8, int(self._rng.exponential(cfg.mean_doc_len)))
        v = cfg.vocab_size - cfg.n_special
        out = np.empty(n, np.int32)
        w = int(self._rng.choice(v, p=self._unigram))
        for i in range(n):
            out[i] = w + cfg.n_special
            if self._rng.random() < 0.7:       # follow bigram structure
                w = int(self._succ[w, self._rng.integers(0, 8)])
            else:                              # or resample from unigram
                w = int(self._rng.choice(v, p=self._unigram))
        return out

    def _next_window(self) -> np.ndarray:
        """Next packed window (documents joined with BOS/EOS)."""
        need = self.cfg.seq_len + 1            # inputs + shifted labels
        while len(self._buf) < need:
            doc = self._doc()
            self._buf = np.concatenate(
                [self._buf, [BOS], doc, [EOS]]).astype(np.int32)
        out = self._buf[:need]
        self._buf = self._buf[need:]
        return out

    def batches(self) -> Iterator[dict]:
        """{'tokens': (B, S), 'labels': (B, S)} int32, per host shard."""
        cfg = self.cfg
        while True:
            window = np.stack([self._next_window()
                               for _ in range(cfg.batch_size)])
            self._step += 1
            yield {"tokens": window[:, :-1].astype(np.int32),
                   "labels": window[:, 1:].astype(np.int32)}


def eval_batches(cfg: DataConfig, n_batches: int = 8) -> list:
    """A fixed held-out set (different seed stream) for perplexity evals."""
    ecfg = dataclasses.replace(cfg, seed=cfg.seed + 10_000)
    it = SyntheticTinyStories(ecfg).batches()
    return [next(it) for _ in range(n_batches)]
