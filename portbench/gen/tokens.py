"""Prompt token ids: a frozen copy of the port's synthetic corpus
(``data/synthetic.py``: ``_zipf_tokens`` and ``SyntheticCorpus.batch_at``),
a seeded zipf-like token process with a document separator about every
thousand tokens. Pure numpy.
"""
from __future__ import annotations

import numpy as np


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """Zipf-distributed token ids (inverse-CDF approximation)."""
    u = rng.random(n)
    ids = ((vocab ** u - 1.0) / (vocab - 1.0) * vocab).astype(np.int64)
    return np.clip(ids, 0, vocab - 1)


def prompts(seed: int, index: int, batch: int, length: int,
            vocab: int) -> np.ndarray:
    """(batch, length) int32 prompt ids of prompt batch ``index`` of a run
    seeded ``seed``: a pure function of its arguments."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3, index]))
    toks = zipf_tokens(rng, batch * length, vocab).reshape(batch, length)
    toks = np.where(rng.random((batch, length)) < 1e-3, 0, toks)
    return toks.astype(np.int32)
