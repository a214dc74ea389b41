"""Fleet surveillance engine — one batched tick for the whole LMCM fleet.

Counterpart of ``repro/core/surveillance.py``. The paper's LMCM (§5)
surveils every VM continuously: classify the latest telemetry window (NB,
§4.1), recognize the workload cycle (FFT, §4.2 + Alg. 1), and answer
migration requests with Alg. 2 postponements. One tick does that for the
whole registered fleet, with every fleet-sized array a tensor on the
engine's device (the card unless the caller asks for the CPU):

  1. gather     — every job's telemetry window in one ``window_matrix``
                  call (device-resident ``FleetTelemetry`` ring; per-buffer
                  copies for foreign stores);
  2. classify   — one NB call over (J, T, F)
                  (``characterize.classify_lm_batch``); classification is
                  *incremental*: NB is stateless per sample, so a slid
                  window only classifies its new tail and splices the
                  cached lm series for the overlap (telemetry steps are
                  assumed dense — one sample per step);
  3. recognize  — one batched power spectrum (the DFT kernel, mean removal
                  fused) + one shared candidate-lag autocorrelation
                  refinement (the autocorr kernel), in
                  ``cycles.fit_cycle_batch``;
  4. decide     — Algorithm 2 fleet-wide (``postpone.postpone_batch``).

Staleness epochs make the tick incremental: a job's cycle fit is only
recomputed once its window has advanced >= period/4 samples since the last
fit (``acyclic_refit`` samples while no cycle is known). The packed Alg. 2
operands are cached and invalidated only by register/unregister/refit, so
a tick over an all-fresh fleet does no per-job Python work past the
staleness scan. ``overlap=True`` returns the ``TickResult`` before the
decide is copied to the host: the device runs Alg. 2 while the caller goes
on, and ``.remain`` materializes on first access (bit-identical values).

``shards=k`` splits the row stages (classify, spectrum, lag scores,
Algorithm 2) over the first k ranks of the initialised
``torch.distributed`` group (``core/shard.py``): every rank registers and
records the same fleet, computes its block of rows and all-gathers, so
every rank's tick is bit-identical to the unsharded one (``shards=None``).
With ``overlap=True`` the decide's all-gather is issued and waited on
when ``.remain`` is first read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import characterize, cycles, postpone as pp
from repro_torch.core import shard as shardlib
from repro_torch.core.telemetry import TelemetryBuffer
from repro_torch.kernels.backend import DeviceLike, resolve_device


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@dataclass
class SurveilledJob:
    """Per-job surveillance state (the LMCM's job registry entry)."""
    job_id: str
    telemetry: TelemetryBuffer          # or any buffer with its interface
    nb: characterize.NaiveBayes
    window: int = 512
    dirty_rate_fn: Optional[Callable[[float], float]] = None
    model: Optional[cycles.CycleModel] = None
    # (window,) int8 LM series on the engine's device (a row of the fit's
    # batch; empty before the first fit)
    lm_series: torch.Tensor = field(
        default_factory=lambda: torch.zeros(0, dtype=torch.int8))
    # step index of the first sample in the characterized window: Alg.1's
    # profile is indexed from here, so Alg.2's M_current must be too
    origin_step: int = 0
    fitted_step: int = -1               # latest step at last fit (-1 = never)
    # misprediction feedback (core/guard.py): decayed by each guard abort
    # of this job's migrations, floor-clamped by the guard's policy. The
    # receding-horizon controller gates trough pricing on
    # confidence x trust, so a burned fit stops deferring launches to
    # troughs the model hallucinated until refits re-earn it.
    trust: float = 1.0


class TickResult:
    """One surveillance tick's outcome: ``remain`` (job -> Alg.2 RemainTime
    in samples), ``refitted`` (cycle fits recomputed), ``fleet`` (jobs with
    a current model), ``confidence`` (job -> spectral confidence of its
    current fit — the guard layer's gating input, shared with the packed
    Alg. 2 cache so surfacing it costs no per-tick Python).

    With ``overlap=True`` the engine constructs this while Algorithm 2 is
    still executing on the device; the ``remain`` dict is
    built on first access from operands captured at dispatch time, so the
    values are bit-identical to the synchronous schedule — only the host
    sync moves.
    """
    __slots__ = ("_remain", "refitted", "fleet", "confidence", "_thunk")

    def __init__(self, remain: Optional[Dict[str, int]], refitted: int,
                 fleet: int, confidence: Optional[Dict[str, float]] = None,
                 _thunk: Optional[Callable] = None):
        self._remain = remain
        self.refitted = refitted
        self.fleet = fleet
        self.confidence = confidence if confidence is not None else {}
        self._thunk = _thunk

    @property
    def remain(self) -> Dict[str, int]:
        if self._thunk is not None:
            self._remain = self._thunk()
            self._thunk = None
        return self._remain

    @property
    def pending(self) -> bool:
        """True while the decide has not been synced to host yet."""
        return self._thunk is not None

    def __repr__(self) -> str:
        body = "<pending>" if self.pending else repr(self._remain)
        return (f"TickResult(remain={body}, refitted={self.refitted}, "
                f"fleet={self.fleet})")


class SurveillanceEngine:
    """Batched NB -> FFT -> Alg.2 surveillance over a registered fleet."""

    def __init__(self, *, folded: bool = False, min_samples: int = 8,
                 acyclic_refit: int = 8,
                 shards: Optional[int] = None,
                 overlap: bool = False,
                 min_coverage: float = 0.5,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.folded = folded
        self.min_samples = min_samples
        self.acyclic_refit = acyclic_refit
        # degraded-telemetry gate: fraction of a job's gathered window that
        # must be valid (recorded AND finite — NaN samples are sensor
        # dropout) for its cycle fit to be trusted; rows below it demote to
        # an acyclic model instead of fitting a cycle to zero-filled holes.
        # Clean telemetry always has coverage 1.0, so the gate is inert
        # until NaNs appear.
        self.min_coverage = float(min_coverage)
        self.overlap = overlap
        self.shards = shards
        # every rank of the group must build its engine (the mesh's groups
        # are made collectively)
        self.mesh = shardlib.decide_mesh(shards, device=self.device)
        self.jobs: Dict[str, SurveilledJob] = {}
        self._decide_cache: Optional[Tuple] = None

    # -- registration -------------------------------------------------------
    def register(self, job_id: str, telemetry, nb: characterize.NaiveBayes,
                 *, window: int = 512, dirty_rate_fn=None) -> SurveilledJob:
        job = SurveilledJob(job_id, telemetry, nb, window=window,
                            dirty_rate_fn=dirty_rate_fn)
        self.jobs[job_id] = job
        self._decide_cache = None
        return job

    def unregister(self, job_id: str) -> None:
        if self.jobs.pop(job_id, None) is not None:
            self._decide_cache = None

    # -- staleness epochs ---------------------------------------------------
    def _latest_steps(self, jobs: List[SurveilledJob]) -> np.ndarray:
        """(J,) latest telemetry step per job; one call on the fleet-SoA
        fast path, per-buffer otherwise."""
        out = np.full(len(jobs), -1, np.int64)
        by_fleet: Dict[int, List[int]] = {}
        for i, job in enumerate(jobs):
            fleet = getattr(job.telemetry, "fleet", None)
            if fleet is not None:
                by_fleet.setdefault(id(fleet), []).append(i)
            else:
                out[i] = job.telemetry.latest_step()
        for idxs in by_fleet.values():
            fleet = jobs[idxs[0]].telemetry.fleet
            latest = fleet.latest_steps()
            for i in idxs:
                out[i] = latest[jobs[i].telemetry.index]
        return out

    def _stale(self, job: SurveilledJob, latest: int) -> bool:
        if latest < 0 or len(job.telemetry) < self.min_samples:
            return False                        # not enough history yet
        if job.fitted_step < 0:
            return True
        advanced = latest - job.fitted_step
        if job.model is not None and job.model.period > 1:
            return advanced >= max(1, job.model.period // 4)
        return advanced >= self.acyclic_refit

    def next_refresh_step(self, now_step: int) -> float:
        """Earliest telemetry step at which ANY registered job's cycle fit
        becomes stale, assuming telemetry stays dense (one sample per
        step) — the event-skipping simulator's surveillance horizon: a
        per-step ``refresh()`` is a pure no-op strictly before this step,
        so the simulator may jump straight to it without changing any
        fit (``inf`` when no job will ever go stale, e.g. an empty
        fleet). Jobs with no samples yet are assumed to record their
        FIRST sample at ``now_step`` (callers pass the step about to be
        recorded), so they reach ``min_samples`` at
        ``now_step + min_samples - 1``."""
        nxt = np.inf
        if not self.jobs:
            return nxt
        jobs = list(self.jobs.values())
        for job, latest in zip(jobs, self._latest_steps(jobs)):
            base = int(latest) if latest >= 0 else now_step - 1
            ready = base + max(0, self.min_samples - len(job.telemetry))
            if job.fitted_step < 0:
                cand = ready                    # stale on first full window
            else:
                if job.model is not None and job.model.period > 1:
                    thresh = max(1, job.model.period // 4)
                else:
                    thresh = self.acyclic_refit
                cand = max(ready, job.fitted_step + thresh)
            nxt = min(nxt, cand)
        return nxt

    # -- the batched pipeline ----------------------------------------------
    def refresh(self, job_ids: Optional[List[str]] = None,
                *, force: bool = False) -> int:
        """Recompute the cycle fit of every stale (or ``force``d) job in
        one batched pipeline per (classifier, window-length) group.
        Returns the number of jobs refit."""
        jobs = ([self.jobs[i] for i in job_ids] if job_ids is not None
                else list(self.jobs.values()))
        if not jobs:
            return 0
        latest = self._latest_steps(jobs)
        todo = [(job, ls) for job, ls in zip(jobs, latest)
                if (force and ls >= 0
                    and len(job.telemetry) >= self.min_samples)
                or (not force and self._stale(job, ls))]
        if not todo:
            return 0
        groups: Dict[tuple, List[tuple]] = {}
        for job, ls in todo:
            m = min(job.window, len(job.telemetry))
            delta = int(ls) - job.fitted_step
            # incremental classification: NB is stateless per sample, so a
            # slid window only needs its NEW tail classified — the cached
            # lm_series supplies the overlap (telemetry steps are assumed
            # dense, one sample per step, as the recorder produces them)
            splice = (job.fitted_step >= 0 and len(job.lm_series) == m
                      and 0 <= delta < m)
            tail = min(m, _pow2(max(delta, 1))) if splice else m
            groups.setdefault((id(job.nb), m, tail), []).append((job, ls))
        for (_, m, tail), entries in groups.items():
            self._refresh_group([j for j, _ in entries],
                                np.asarray([ls for _, ls in entries]),
                                m, tail)
        return len(todo)

    def _refresh_group(self, jobs: List[SurveilledJob],
                       latest: np.ndarray, m: int, tail: int) -> None:
        G = len(jobs)
        dev = self.device
        # masked gather: NaN dropout samples come back zero-filled (the
        # batched NB/FFT stays finite) with their invalidity recorded, so
        # starved rows can be demoted instead of fit to hole-filled data
        W, counts, valid = TelemetryBuffer.window_matrix(
            [j.telemetry for j in jobs], tail,
            return_mask=True, device=dev)                  # (G, tail, F)
        coverage = (valid.sum(dim=1).cpu().numpy()
                    / np.maximum(counts, 1))
        lm_tail = shardlib.classify_lm(jobs[0].nb, W, self.mesh)  # (G, tail)
        if tail == m:
            LM = lm_tail
        else:
            # splice: row i keeps its cached series shifted left by d_i
            # samples and takes its last d_i samples from the new tail
            d = torch.as_tensor(
                [int(ls) - job.fitted_step for job, ls in zip(jobs, latest)],
                device=dev)[:, None]
            old = torch.stack([job.lm_series for job in jobs])
            t = torch.arange(m, device=dev)[None, :]
            src = torch.where(t < m - d, t + d, tail + t)
            LM = torch.gather(torch.cat([old, lm_tail], dim=1), 1, src)
        models = cycles.fit_cycle_batch(LM, folded=self.folded,
                                        mesh=self.mesh)
        for i, (job, model, ls) in enumerate(zip(jobs, models, latest)):
            if coverage[i] < self.min_coverage:
                # blackout-starved window: a cycle fit over zero-filled
                # holes is noise — demote to acyclic (same shape as the
                # not-found branch of fit_cycle_batch) until telemetry
                # recovers and a later refit sees real samples again
                model = cycles._acyclic(LM[i].cpu().numpy())
            job.model = model
            job.lm_series = LM[i]
            job.origin_step = int(ls) - m + 1
            job.fitted_step = int(ls)
        self._decide_cache = None       # packed Alg.2 operands went stale

    def refresh_model(self, job_id: str, *, force: bool = False
                      ) -> Optional[cycles.CycleModel]:
        """Single-job view of ``refresh``: recompute if stale, then return
        the (possibly cached) model. None while history is too short."""
        self.refresh([job_id], force=force)
        return self.jobs[job_id].model

    # -- the batched tick ---------------------------------------------------
    def _packed_fleet(self) -> Tuple:
        """(ids, origins, profiles, periods, confidence) for the fitted
        fleet, padded/bucketed for Alg. 2 — cached between ticks and
        invalidated only by register/unregister/refit, so an all-fresh
        tick does no per-job Python work past the staleness scan."""
        if self._decide_cache is None:
            fitted = [j for j in self.jobs.values() if j.model is not None]
            if not fitted:
                self._decide_cache = ((), None, None, None, {})
            else:
                profiles, periods = pp.pack_fleet(
                    [j.model for j in fitted], device=self.device)
                origins = torch.as_tensor(
                    [j.origin_step for j in fitted], dtype=torch.int64,
                    device=self.device)
                self._decide_cache = (tuple(j.job_id for j in fitted),
                                      origins, profiles, periods,
                                      {j.job_id: float(j.model.confidence)
                                       for j in fitted})
        return self._decide_cache

    def next_trough(self, job_ids: List[str], now_step: int
                    ) -> Dict[str, Optional[int]]:
        """Samples until each job's next predicted LM trough — Algorithm
        2's RemainTime read off the CURRENT cycle fits (no refit: admission
        decisions ride whatever the last tick fitted, so pricing a
        candidate does not perturb the surveillance schedule). ``None``
        for unregistered jobs and for jobs without a cyclic model — there
        is no trough to time against, and the receding-horizon controller
        falls back to its myopic one-period deferral for them."""
        out: Dict[str, Optional[int]] = {}
        for jid in job_ids:
            job = self.jobs.get(jid)
            model = job.model if job is not None else None
            if model is None or not model.cyclic:
                out[jid] = None
            else:
                out[jid] = int(pp.postpone(
                    model, int(now_step) - job.origin_step))
        return out

    def tick(self, now_step: int) -> TickResult:
        """One fleet surveillance tick: refresh every stale cycle fit, then
        answer Algorithm 2 for the whole fleet in one vectorized call.

        With ``overlap=True`` the returned ``TickResult`` is constructed
        before the decide's host sync: Alg. 2 runs on the device while the
        caller records/gathers the next tick, and ``.remain`` materializes
        on first access (bit-identical values — the operands are captured
        at launch).
        """
        refitted = self.refresh()
        ids, origins, profiles, periods, conf = self._packed_fleet()
        if not ids:
            return TickResult({}, refitted, 0)
        m_now = (now_step - origins).to(torch.int32)     # one vector op
        remain = shardlib.postpone_rows(profiles, periods, m_now, self.mesh,
                                        async_op=self.overlap)
        J = len(ids)

        def materialize(ids=ids, remain=remain,
                        lazy=self.overlap) -> Dict[str, int]:
            dev = remain.wait() if lazy else remain
            return dict(zip(ids, dev.tolist()))

        if self.overlap:
            return TickResult(None, refitted, J, conf, _thunk=materialize)
        return TickResult(materialize(), refitted, J, conf)
