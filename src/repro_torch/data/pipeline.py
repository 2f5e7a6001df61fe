"""Data pipeline: byte-level tokenizer + synthetic corpus + batched streams.

The port's own copy of ``repro.data.pipeline`` (numpy only, unchanged), so
the port's trainer reads the same batches as the reference's for a seed.

The training examples use a self-contained synthetic corpus (structured
pseudo-text with learnable statistics: repeated templates, arithmetic facts,
and Zipfian vocabulary) so training is runnable offline.  The pipeline is an
ordinary Python iterator yielding device-ready numpy batches; shuffling and
packing are deterministic given the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


# -- byte tokenizer ----------------------------------------------------------
class ByteTokenizer:
    """Reversible byte-level tokenizer with a few special ids."""

    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.BOS] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in ids if int(i) < 256)
        return bs.decode("utf-8", errors="replace")


# -- synthetic corpus --------------------------------------------------------
_TEMPLATES = [
    "the {a} {v} the {b}.",
    "agent {a} schedules a {b} task with priority {n}.",
    "kernel {a} runs on the {b} with chunk size {n}.",
    "{a} plus {b} equals {n}.",
    "proactive {a} yields to reactive {b} after {n} ms.",
]
_NOUNS = ["scheduler", "npu", "igpu", "prefill", "decode", "cache", "queue",
          "kernel", "chunk", "token", "batch", "graph", "model", "agent"]
_VERBS = ["preempts", "backfills", "dispatches", "batches", "chunks",
          "annotates", "profiles", "maps"]


def synthetic_text(rng: np.random.Generator) -> str:
    t = _TEMPLATES[rng.integers(len(_TEMPLATES))]
    return t.format(a=_NOUNS[rng.integers(len(_NOUNS))],
                    b=_NOUNS[rng.integers(len(_NOUNS))],
                    v=_VERBS[rng.integers(len(_VERBS))],
                    n=int(rng.integers(100)))


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0
    vocab_size: int = 259  # clip ids into the model's vocab if smaller


def token_stream(cfg: PipelineConfig) -> Iterator[np.ndarray]:
    """Infinite stream of packed (seq_len,) windows."""
    tok = ByteTokenizer()
    rng = np.random.default_rng(cfg.seed)
    buf = np.empty((0,), np.int32)
    while True:
        while len(buf) < cfg.seq_len + 1:
            ids = tok.encode(synthetic_text(rng))
            ids = np.append(ids, tok.EOS)
            buf = np.concatenate([buf, ids])
        yield np.minimum(buf[:cfg.seq_len + 1], cfg.vocab_size - 1)
        buf = buf[cfg.seq_len:]


def batches(cfg: PipelineConfig) -> Iterator[dict]:
    """Yield {"tokens": (B, S+1) int32} batches (shift happens in the loss)."""
    streams = [token_stream(dataclasses.replace(cfg, seed=cfg.seed + i))
               for i in range(cfg.batch_size)]
    while True:
        yield {"tokens": np.stack([next(s) for s in streams])}
