"""Prediction guard — convergence watchdogs for in-flight migrations.

ALMA's admission sweep prices every launch from a model (cycle fit +
what-if cost batch), and until this layer the execute plane trusted that
price unconditionally: a lane whose realized dirty rate exceeds the
estimate grinds toward the Xen ``max_rounds``/``total_cap`` stops at up
to ``stop_total_factor``x the priced bytes, burning shared links the
whole way. Production migration managers treat convergence handling as
table stakes (He & Buyya's taxonomy: auto-converge, timeout/abort); this
module is that handler for ``core/plane.py``.

Mechanics: each launched lane may carry its admission-time expectation
(``expected_bytes``/``expected_time``, priced by the controller's cost
batch at launch). At every round boundary the plane evaluates all lanes
against a vectorized :class:`MigrationGuard`: the divergence ratio is
``max(realized_sent / expected_bytes, elapsed / expected_time)``, and a
two-rung policy ladder fires as it crosses configurable thresholds —

  1. **auto-converge throttling** (QEMU-style): the lane's dirty-rate
     table is replaced by a progressively scaled copy
     (``throttle_factor ** step``, floored at ``throttle_floor``).  The
     throttle is a *composable table transform* (:func:`throttled_spec`)
     — the scaled ``PiecewiseRate`` flows through the same ``RateBank``
     sampling, ``lane_state()`` snapshots, and
     ``simulate_precopy_batch``/``ResumeState`` repricing as the
     original, so the controller's in-flight repricing stays
     bit-consistent with what the plane will actually execute;
  2. **abort-and-retry**: the lane settles early with partial-bytes
     accounting and ``stop_reason == strunk.STOP_GUARD``
     (``"guard_abort"``, distinct from fault aborts) and re-enters
     ``LMCM.fail()``'s backoff path.  FleetSim additionally treats a
     guard abort as misprediction feedback: the job's cycle fit is
     forced stale and its ``trust`` score decays, which gates the
     receding-horizon trough pricing (see :meth:`MigrationGuard.trusts`).

Lanes without expectations (NaN) are never throttled or aborted, and a
plane constructed with ``guard=None`` (the default) takes none of these
code paths — disabled runs are bit-identical to a guard-less build.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.rates import PiecewiseRate, as_rate_table


def expectation_of(req) -> Tuple[float, float]:
    """(expected_bytes, expected_time) stamped on a request at admission,
    NaN where absent — NaN disarms the guard for that lane."""
    b = getattr(req, "expected_bytes", None)
    t = getattr(req, "expected_time", None)
    return (float(b) if b is not None else float("nan"),
            float(t) if t is not None else float("nan"))


def throttled_spec(spec, factor: float):
    """The composable auto-converge transform: ``spec`` with every dirty
    rate scaled by ``factor`` in (0, 1].

    ``PiecewiseRate`` tables (and anything ``as_rate_table`` can
    normalize: constants, objects exposing ``rate_table``) come back as a
    derived ``PiecewiseRate`` — same breakpoints, scaled rates — so every
    consumer (the plane's ``RateBank`` sampling, ``what_if_cost_batch``
    repricing from a ``ResumeState``, the scalar reference loop) prices
    the throttled lane identically. Plain callables are wrapped; None
    (no dirtying) is returned unchanged."""
    if spec is None:
        return None
    factor = float(factor)
    table = spec if isinstance(spec, PiecewiseRate) else (
        None if callable(spec) else as_rate_table(spec))
    if table is not None:
        return PiecewiseRate(table.ends, np.asarray(table.rates) * factor,
                             offset=table.offset)
    return lambda t, _fn=spec, _f=factor: _f * float(_fn(t))


class MigrationGuard:
    """Vectorized convergence watchdog + misprediction-feedback policy.

    One instance is shared by every migration domain of a
    ``fabric.ShardedPlane`` (it is plumbed through ``_plane_kw``), so the
    ``n_throttles``/``n_aborts`` counters aggregate fleet-wide; all
    per-lane state lives in the plane's SoA rows.

    Thresholds are divergence *ratios* (realized / predicted):
    ``throttle_ratio`` arms the auto-converge ladder, ``abort_ratio``
    (must be >= throttle_ratio) cuts the lane loose. ``trust_decay`` /
    ``trust_floor`` shape the per-job trust score a guard abort burns,
    and ``trust_gate`` is the ``confidence x trust`` floor below which
    the receding-horizon controller falls back to myopic pricing instead
    of deferring to a trough the model may have hallucinated."""

    def __init__(self, *, throttle_ratio: float = 1.5,
                 abort_ratio: float = 3.0,
                 throttle_factor: float = 0.5,
                 throttle_floor: float = 0.05,
                 trust_decay: float = 0.5,
                 trust_gate: float = 0.25,
                 trust_floor: float = 0.05):
        if not (1.0 <= throttle_ratio <= abort_ratio):
            raise ValueError("need 1 <= throttle_ratio <= abort_ratio, got "
                             f"{throttle_ratio} / {abort_ratio}")
        if not (0.0 < throttle_factor < 1.0):
            raise ValueError(f"throttle_factor in (0,1): {throttle_factor}")
        if not (0.0 < trust_decay <= 1.0):
            raise ValueError(f"trust_decay in (0,1]: {trust_decay}")
        self.throttle_ratio = float(throttle_ratio)
        self.abort_ratio = float(abort_ratio)
        self.throttle_factor = float(throttle_factor)
        self.throttle_floor = float(throttle_floor)
        self.trust_decay = float(trust_decay)
        self.trust_gate = float(trust_gate)
        self.trust_floor = float(trust_floor)
        self.n_throttles = 0
        self.n_aborts = 0

    def divergence(self, sent: np.ndarray, elapsed: np.ndarray,
                   expected_bytes: np.ndarray,
                   expected_time: np.ndarray) -> np.ndarray:
        """Per-lane divergence ratio, NaN where the lane carries no
        expectation (NaN compares False against every threshold, so
        unguarded lanes are structurally exempt)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            div_b = np.asarray(sent, float) / np.asarray(
                expected_bytes, float)
            div_t = np.asarray(elapsed, float) / np.asarray(
                expected_time, float)
        return np.fmax(div_b, div_t)

    def factor_for(self, step: int) -> Optional[float]:
        """Dirty-rate scale after ``step`` ladder escalations, or None
        once the progressive cap would undercut ``throttle_floor``."""
        f = self.throttle_factor ** step
        return f if f >= self.throttle_floor else None

    def decay_trust(self, trust: float) -> float:
        """Trust after one guard abort (burned fits stay above the floor
        so a long-lived job can re-earn trough pricing after refits)."""
        return max(self.trust_floor, float(trust) * self.trust_decay)

    def trusts(self, confidence: float, trust: float) -> bool:
        """Does ``confidence x trust`` clear the trough-pricing gate?"""
        return float(confidence) * float(trust) >= self.trust_gate
