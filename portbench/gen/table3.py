"""Fleet telemetry from the paper's Table 3 cycles, and the Naive Bayes
training set: a frozen copy of the port's generators
(``core/fleetsim.py``: ``PHASES``, ``phase_means``, ``table3_traces``,
``make_training_nb``'s samples; ``chip_smoke.py``: ``_sample_matrix``,
``_tick_values``), kept here so that a change to the program cannot move
the benchmark's traffic. Pure numpy; everything is drawn from the seed.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# telemetry field order (the port's ``telemetry.DEFAULT_FIELDS``)
FIELDS = ("step_time", "dirty_bytes", "dirty_fraction", "collective_bytes",
          "compute_util", "hbm_util")
# workload classes and their phases (paper §6.2, Table 3)
CLASSES = ("CPU", "MEM", "IO", "IDLE")
PHASES = {
    "CPU": dict(compute_util=0.95, hbm_util=0.30, dirty_rate=3e6, label=0),
    "MEM": dict(compute_util=0.55, hbm_util=0.95, dirty_rate=150e6, label=1),
    "IO": dict(compute_util=0.25, hbm_util=0.45, dirty_rate=12e6, label=2),
    "IDLE": dict(compute_util=0.03, hbm_util=0.05, dirty_rate=0.3e6, label=3),
}
# the paper's four Table 3 VMs: phase names, one phase per ``PHASE_S``
TABLE3 = {
    "vm03_A": ["IO", "CPU", "CPU", "IO", "CPU", "CPU", "IO", "CPU", "CPU"],
    "vm02_C": ["MEM", "IDLE", "CPU", "MEM", "IDLE", "CPU", "MEM", "IDLE",
               "CPU"],
    "vm02_A": ["MEM", "CPU", "CPU", "MEM", "CPU", "CPU", "MEM", "CPU", "CPU",
               "MEM", "CPU", "CPU"],
    "vm01_C": ["MEM", "IDLE", "CPU", "MEM", "IDLE", "CPU"],
}
PHASE_S = 60.0
JITTER = 0.05
# every Table 3 pattern repeats after this many seconds (three phases)
BASE_PERIOD_S = 180


def phase_means(name: str) -> Tuple[float, ...]:
    """A phase's load-index means in ``FIELDS`` order."""
    ph = PHASES[name]
    return (0.5 / max(ph["compute_util"], 0.02), ph["dirty_rate"],
            min(1.0, ph["dirty_rate"] / 200e6), ph["compute_util"] * 1e9,
            ph["compute_util"], ph["hbm_util"])


def sample_matrix(phases: Sequence[str], phase_s: float, t0: np.ndarray,
                  steps: int, rng: np.random.Generator) -> np.ndarray:
    """(J, steps, F) load indexes of J VMs running one cyclic phase trace
    from their offsets ``t0`` (seconds), one sample a second, each field
    jittered by ``JITTER`` of its mean."""
    cycle = phase_s * len(phases)
    tc = (t0[:, None] + np.arange(steps, dtype=np.float64)) % cycle
    cum = np.cumsum([phase_s] * len(phases))
    pi = np.searchsorted(cum, tc.ravel(), side="right").reshape(tc.shape)
    base = np.asarray([phase_means(n) for n in phases])[pi]
    return np.maximum(0.0, base * (1.0 + JITTER
                                   * rng.standard_normal(base.shape)))


def fleet_values(seed: int, n_vms: int, steps: int,
                 dtype=np.float64) -> np.ndarray:
    """(n_vms, steps, F) telemetry of a fleet: VM j runs Table 3 trace
    j % 4 from a seeded phase offset, seeded jitter on every sample."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1, n_vms]))
    vals = np.empty((n_vms, steps, len(FIELDS)), dtype)
    idx = np.arange(n_vms)
    traces = list(TABLE3.values())
    for k, names in enumerate(traces):
        rows = idx[idx % len(traces) == k]
        t0 = rng.uniform(0, PHASE_S * len(names), rows.size)
        vals[rows] = sample_matrix(names, PHASE_S, t0, steps, rng)
    return vals


def training_set(seed: int, n: int = 4000) -> Tuple[np.ndarray, np.ndarray]:
    """(features (n, F) f32, labels (n,)): the NB training samples, one
    second of each phase in a 4 s cycle at seeded times (the paper trains
    NB on labelled benchmark runs)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2, n]))
    names: List[str] = ["CPU", "MEM", "IO", "IDLE"]
    t = rng.uniform(0, len(names), n)
    which = np.minimum(t.astype(np.int64), len(names) - 1)
    means = np.asarray([phase_means(m) for m in names])[which]
    feats = np.maximum(0.0, means * (1.0 + JITTER
                                     * rng.standard_normal(means.shape)))
    labels = np.asarray([PHASES[m]["label"] for m in names])[which]
    return feats.astype(np.float32), labels


def trace_names() -> Dict[str, List[str]]:
    return {k: list(v) for k, v in TABLE3.items()}
