"""Deterministic synthetic data pipeline (``repro.data.synthetic`` on
torch: the corpus and load generators are the same numpy code; only
``make_batch`` hands back tensors on a device).

A real run would stream tokenized documents; here the corpus is a seeded
zipf-ish token process with document boundaries, which is enough to (a) drive
hundreds of real optimization steps, (b) give MoE routers non-degenerate
token statistics, and (c) be exactly resumable from a step index after
restart/migration (fault-tolerance requirement: data state is (seed, step)).

Fleet-telemetry load generators live here too: seeded, fully vectorized
(n_jobs, steps, 6) load-index tensors ordered like
``telemetry.DEFAULT_FIELDS``, used by the Fig. 10 scalability benchmark to
stress the decide plane with workload mixes beyond the paper's Table 3
traces — ``heavy_tail_load`` (Pareto dirty-rate bursts over a square-wave
cycle) and ``correlated_tenant_load`` (jobs share their tenant's cycle plus
idiosyncratic drift, the "everyone's nightly build at 2am" pattern that
makes whole shards go stale at once).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import DeviceLike, resolve_device


# field order of telemetry.DEFAULT_FIELDS (kept literal so this module does
# not depend on the core package)
LOAD_FIELDS = ("step_time", "dirty_bytes", "dirty_fraction",
               "collective_bytes", "compute_util", "hbm_util")


def _load_indexes(cu: np.ndarray, hb: np.ndarray, dr: np.ndarray
                  ) -> np.ndarray:
    """Map (compute_util, hbm_util, dirty_rate) primitives of any common
    shape to (..., 6) load-index rows ordered like ``LOAD_FIELDS`` — the
    same mapping the fleet simulator's trace sampler uses."""
    return np.stack([0.5 / np.maximum(cu, 0.02), dr,
                     np.minimum(1.0, dr / 200e6), cu * 1e9, cu, hb],
                    axis=-1)


def _square_wave(rng: np.random.Generator, n: int, steps: int,
                 cycle_range: tuple, duty: float) -> np.ndarray:
    """(n, steps) in {0,1}: per-row square wave with a seeded random period
    from ``cycle_range`` and a random phase offset."""
    lo, hi = cycle_range
    periods = rng.integers(lo, hi + 1, n)
    phases = rng.integers(0, periods)
    t = np.arange(steps, dtype=np.int64)
    frac = ((t[None, :] + phases[:, None]) % periods[:, None]) \
        / periods[:, None]
    return (frac < duty).astype(np.float64)


def heavy_tail_load(n_jobs: int, steps: int, *, seed: int = 0,
                    alpha: float = 1.6, burst_rate: float = 0.02,
                    cycle_range: tuple = (64, 256), duty: float = 0.5,
                    jitter: float = 0.05) -> np.ndarray:
    """Heavy-tailed fleet load: (n_jobs, steps, 6) load indexes.

    Each job runs a square-wave busy/idle cycle (seeded period and phase
    from ``cycle_range``); on top, dirty-rate bursts arrive at rate
    ``burst_rate`` per step with Pareto(``alpha``) magnitudes — a few bursts
    dwarf everything else (alpha < 2 means infinite variance), which is the
    regime where a mean-based classifier would misjudge suitability but the
    per-sample NB + cycle decomposition should not. Pure function of the
    arguments (``SeedSequence([seed, n_jobs, steps])``).
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, n_jobs, steps]))
    busy = _square_wave(rng, n_jobs, steps, cycle_range, duty)
    cu = 0.15 + 0.75 * busy
    hb = 0.30 + 0.50 * busy
    dr = 5e6 + 395e6 * busy
    burst = rng.random((n_jobs, steps)) < burst_rate
    mag = (1.0 + rng.pareto(alpha, (n_jobs, steps))) * burst
    dr = dr * (1.0 + mag)               # the heavy tail rides the dirty rate
    cu = np.minimum(1.0, cu * (1.0 + 0.2 * mag))
    noise = 1.0 + jitter * rng.standard_normal((n_jobs, steps, 1))
    return np.maximum(0.0, _load_indexes(cu, hb, dr) * noise)


def correlated_tenant_load(n_jobs: int, steps: int, *, n_tenants: int = 8,
                           rho: float = 0.8, seed: int = 0,
                           cycle_range: tuple = (64, 256),
                           jitter: float = 0.05) -> np.ndarray:
    """Tenant-correlated fleet load: (n_jobs, steps, 6) load indexes.

    Every job belongs to one of ``n_tenants`` tenants; its busy signal is
    ``rho`` parts the tenant's shared cycle plus ``1 - rho`` parts an
    idiosyncratic cycle of its own. High ``rho`` makes whole tenant cohorts
    go stale in the same surveillance tick (the worst case for staleness-
    epoch load spreading), which is exactly what the scalability benchmark
    wants to stress. Pure function of the arguments.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, n_jobs, n_tenants]))
    tenant = rng.integers(0, n_tenants, n_jobs)
    shared = _square_wave(rng, n_tenants, steps, cycle_range, 0.5)[tenant]
    idio = _square_wave(rng, n_jobs, steps, cycle_range, 0.5)
    busy = rho * shared + (1.0 - rho) * idio
    cu = 0.15 + 0.75 * busy
    hb = 0.25 + 0.55 * busy
    dr = 5e6 + 395e6 * busy
    noise = 1.0 + jitter * rng.standard_normal((n_jobs, steps, 1))
    return np.maximum(0.0, _load_indexes(cu, hb, dr) * noise)


def _zipf_tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """Zipf-distributed token ids (cheap inverse-CDF approximation)."""
    u = rng.random(n)
    ids = ((vocab ** u - 1.0) / (vocab - 1.0) * vocab).astype(np.int64)
    return np.clip(ids, 0, vocab - 1)


class SyntheticCorpus:
    """Step-indexed corpus: ``batch_at(step)`` is a pure function of
    (seed, step, shard), so any worker can resume anywhere."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, *,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.shard, self.num_shards = seed, shard, num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        toks = _zipf_tokens(rng, self.batch * (self.seq + 1), cfg.vocab_size)
        toks = toks.reshape(self.batch, self.seq + 1)
        # document boundaries every ~1k tokens: token 0 acts as separator
        doc_mask = rng.random((self.batch, self.seq + 1)) < 1e-3
        toks = np.where(doc_mask, 0, toks)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }
        if cfg.frontend_prefix:
            batch["prefix_embeds"] = rng.standard_normal(
                (self.batch, min(cfg.frontend_prefix, self.seq), cfg.d_model)
            ).astype(np.float32) * 0.02
        if cfg.mrope:
            pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32),
                                  (self.batch, self.seq))
            batch["positions"] = np.broadcast_to(pos, (3, self.batch, self.seq))
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(cfg: ArchConfig, batch: int, seq: int, *,
               seed: int = 0, step: int = 0,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """One batch as tensors on ``device`` (``None`` is the card): token ids
    int32, equal to ``repro.data.make_batch``'s for the same seed and step."""
    dev = resolve_device(device)
    np_batch = SyntheticCorpus(cfg, batch, seq, seed=seed).batch_at(step)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in np_batch.items()}


def token_stream(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2,
                 num_shards: int = 1, shard: int = 0):
    """Prefetching host-side iterator (background thread pipeline)."""
    import queue
    import threading

    corpus = SyntheticCorpus(cfg, batch, seq, seed=seed, shard=shard,
                             num_shards=num_shards)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(corpus.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class Stream:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return Stream()
