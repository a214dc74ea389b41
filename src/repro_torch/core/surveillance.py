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
                  ``cycles.fit_cycle_rows``;
  4. decide     — Algorithm 2 fleet-wide (``postpone.postpone_batch``).

Every job's fit lives in one fleet-wide store, a row a job
(``_FitStore``): period, confidence, fitted and origin steps as host
arrays, the LM series as one int8 tensor on the device with its host copy.
The staleness scan, the grouping, the commit of a refit and the packing of
Algorithm 2's operands are whole-array operations on it, with no Python
per job when every job records into a ``FleetTelemetry``. A job's
``CycleModel`` is a view of its row, built when first read after a refit.

Staleness epochs make the tick incremental: a job's cycle fit is only
recomputed once its window has advanced >= period/4 samples since the last
fit (``acyclic_refit`` samples while no cycle is known). The packed Alg. 2
operands are cached and invalidated only by register/unregister/refit.
``overlap=True`` returns the ``TickResult`` before the decide is copied to
the host: the device runs Alg. 2 while the caller goes on, and ``.remain``
materializes on first access (bit-identical values).

``shards=k`` splits the row stages (classify, spectrum, lag scores,
Algorithm 2) over the first k ranks of the initialised
``torch.distributed`` group (``core/shard.py``): every rank registers and
records the same fleet, computes its block of rows and all-gathers, so
every rank's tick is bit-identical to the unsharded one (``shards=None``).
With ``overlap=True`` the decide's all-gather is issued and waited on
when ``.remain`` is first read.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import characterize, cycles, postpone as pp
from repro_torch.core import shard as shardlib
from repro_torch.core.telemetry import TelemetryBuffer
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.runtime import spans


def _pow2(n: np.ndarray) -> np.ndarray:
    """Smallest power of two >= n, for n >= 1 (``frexp`` gives the bit
    length of n - 1, exactly for integers below 2**53)."""
    return np.left_shift(1, np.frexp(np.asarray(n) - 1)[1]).astype(np.int64)


class _FitStore:
    """Every registered job's fit state, one row a job in registration
    order: the host columns of ``COLUMNS``, and the LM series as one
    (rows, width) int8 tensor on the engine's device (``lm``) with its host
    copy (``lm_host``), each row valid up to its ``length``.

    A refit writes its rows in place; ``lm_series`` hands out copies. The
    rows grow by doubling (amortised O(1) registration). A job that leaves
    takes a copy of its fit into a store of one row of its own, for a
    handle still held (``release``); its row is reclaimed at the next
    reallocation, which keeps only the live rows, so the store holds at
    most twice the live fleet."""

    #: column -> (dtype, value of a fresh row)
    COLUMNS = {
        "live": (np.bool_, False),
        "fit": (np.bool_, False),        # has a model
        "fitted": (np.int64, -1),        # latest step at the last fit
        "origin": (np.int64, 0),         # first step of the fit's window
        "period": (np.int64, 0),         # 0: acyclic
        "confidence": (np.float64, 0.0),
        "length": (np.int64, 0),         # samples in the LM series
        "stamp": (np.int64, 0),          # the commit that wrote the row
        "window": (np.int64, 0),
        "nb": (np.int64, -1),            # index into ``nbs``
        "fleet": (np.int64, -1),         # index into ``fleets``; -1: foreign
        "index": (np.int64, -1),         # the job's row in its fleet
        "ids": (object, None),
        "jobs": (object, None),
    }

    def __init__(self, device: torch.device, folded: bool):
        self.device, self.folded = device, folded
        self.n = self.cap = self.width = 0
        self.commits = 0
        for name, (dtype, _) in self.COLUMNS.items():
            setattr(self, name, np.zeros(0, dtype))
        self.lm = torch.zeros((0, 0), dtype=torch.int8, device=device)
        self.lm_host = np.zeros((0, 0), np.int8)
        # the objects themselves are kept, so their id()s stay unique
        self.nbs: List[characterize.NaiveBayes] = []
        self.fleets: List = []
        self._interned: Dict[int, int] = {}

    def _intern(self, obj, into: List) -> int:
        k = self._interned.get(id(obj))
        if k is None:
            k = self._interned[id(obj)] = len(into)
            into.append(obj)
        return k

    def _take(self, src: "_FitStore", keep: np.ndarray, cap: int,
              width: int) -> None:
        """Holds ``src``'s rows ``keep``, renumbered from 0, in fresh
        arrays of ``cap`` rows and ``width`` samples; their jobs, and the
        classifiers and fleets they use, go with them."""
        host = src.lm_host[keep]
        lm = src.lm[torch.as_tensor(keep, device=src.device)]
        cols = {name: getattr(src, name)[keep] for name in self.COLUMNS}
        nbs, fleets = src.nbs, src.fleets
        self.n, self.cap, self.width = len(keep), cap, width
        for name, (dtype, fresh) in self.COLUMNS.items():
            col = np.full(cap, fresh, dtype)
            col[:self.n] = cols[name]
            setattr(self, name, col)
        self.lm_host = np.zeros((cap, width), np.int8)
        self.lm_host[:self.n, :host.shape[1]] = host
        self.lm = torch.zeros((cap, width), dtype=torch.int8,
                              device=self.device)
        self.lm[:self.n, :lm.shape[1]] = lm
        for col, objs, into in (("nb", nbs, "nbs"),
                                ("fleet", fleets, "fleets")):
            c = getattr(self, col)[:self.n]
            used, c[c >= 0] = np.unique(c[c >= 0], return_inverse=True)
            setattr(self, into, [objs[k] for k in used])
        self._interned = {id(o): k for objs in (self.nbs, self.fleets)
                          for k, o in enumerate(objs)}
        for row, job in enumerate(self.jobs[:self.n]):
            job.row, job._store = row, self

    def add(self, job: "SurveilledJob") -> int:
        """A fresh row for ``job``, at the end; returns it."""
        if self.n == self.cap or job.window > self.width:
            live = self.live_rows()
            grow = self.n == self.cap and 2 * len(live) > self.cap
            self._take(self, live, max(64, 2 * self.cap if grow
                                       else self.cap),
                       max(self.width, job.window))
        row, self.n = self.n, self.n + 1
        fleet = getattr(job.telemetry, "fleet", None)
        if fleet is not None:
            self.fleet[row] = self._intern(fleet, self.fleets)
            self.index[row] = job.telemetry.index
        self.live[row], self.ids[row], self.jobs[row] = True, job.job_id, job
        self.window[row] = job.window
        self.nb[row] = self._intern(job.nb, self.nbs)
        return row

    def release(self, job: "SurveilledJob") -> None:
        """Frees ``job``'s row: the job keeps a copy of its fit in a store
        of one row of its own."""
        row = job.row
        _FitStore(self.device, self.folded)._take(
            self, np.asarray([row]), 1, self.width)
        job._store.jobs[0] = None
        self.live[row] = False
        self.ids[row] = self.jobs[row] = None

    def live_rows(self) -> np.ndarray:
        return np.flatnonzero(self.live[:self.n])

    def telemetry(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Each row's latest telemetry step (-1: none) and samples held:
        one call a fleet, one a foreign buffer."""
        latest = np.full(len(rows), -1, np.int64)
        held = np.zeros(len(rows), np.int64)
        fleet = self.fleet[rows]
        for k in np.unique(fleet):
            at = np.flatnonzero(fleet == k)
            if k >= 0:
                store, index = self.fleets[k], self.index[rows[at]]
                latest[at] = store.latest_steps()[index]
                held[at] = np.minimum(store._n[index], store.capacity)
                continue
            for i in at:                 # foreign buffers, one by one
                buf = self.jobs[rows[i]].telemetry
                latest[i], held[i] = buf.latest_step(), len(buf)
        return latest, held

    def gather(self, rows: np.ndarray, n: int, device: torch.device):
        """The rows' last ``n`` samples, as ``TelemetryBuffer.window_matrix``
        with ``return_mask``; one fleet's rows in one fleet gather."""
        fleet = self.fleet[rows]
        if fleet[0] >= 0 and (fleet == fleet[0]).all():
            W, counts, valid = self.fleets[fleet[0]].window_matrix(
                n, rows=self.index[rows], return_mask=True)
            return W.to(device), counts, valid.to(device)
        return TelemetryBuffer.window_matrix(
            [self.jobs[r].telemetry for r in rows], n, return_mask=True,
            device=device)

    def threshold(self, rows: np.ndarray, acyclic_refit: int) -> np.ndarray:
        """Samples after its fit at which each row goes stale: a quarter
        period while its model is cyclic, else ``acyclic_refit``."""
        period = self.period[rows]
        return np.where(self.fit[rows] & (period > 1),
                        np.maximum(1, period // 4), acyclic_refit)

    def commit(self, rows: np.ndarray, fits: cycles.CycleFits,
               LM: torch.Tensor, latest: np.ndarray, m: int,
               demote: np.ndarray) -> None:
        """Writes a group's refit: ``demote``d rows (blackout-starved
        windows) become acyclic, as ``fit_cycle_rows`` leaves a row whose
        spectrum has no peak."""
        self.commits += 1
        self.period[rows] = np.where(demote, 0, fits.period)
        self.confidence[rows] = np.where(demote, 0.0, fits.confidence)
        self.fitted[rows] = latest
        self.origin[rows] = latest - m + 1
        self.length[rows] = m
        self.fit[rows] = True
        self.stamp[rows] = self.commits
        self.lm_host[rows, :m] = fits.host
        self.lm[torch.as_tensor(rows, device=self.device), :m] = LM

    def model(self, job: "SurveilledJob") -> Optional[cycles.CycleModel]:
        """``job``'s ``CycleModel``, built from its row on the first read
        after the commit that wrote it."""
        row = job.row
        if not self.fit[row]:
            return None
        stamp = int(self.stamp[row])
        if job._view is None or job._view[0] != stamp:
            job._view = (stamp, cycles.model_view(
                self.lm_host[row, :self.length[row]], int(self.period[row]),
                float(self.confidence[row]), folded=self.folded))
        return job._view[1]


class SurveilledJob:
    """Per-job surveillance state (the LMCM's job registry entry): what the
    job registered with, its guard ``trust``, and its row of the engine's
    fit store. ``model`` is built from the row when first read after a
    refit; ``lm_series``, ``origin_step`` and ``fitted_step`` read the row,
    and setting ``fitted_step`` writes it."""
    __slots__ = ("job_id", "telemetry", "nb", "window", "dirty_rate_fn",
                 "trust", "_store", "row", "_view")

    def __init__(self, job_id: str, telemetry, nb: characterize.NaiveBayes,
                 window: int,
                 dirty_rate_fn: Optional[Callable[[float], float]],
                 store: _FitStore):
        self.job_id = job_id
        self.telemetry = telemetry       # TelemetryBuffer or its interface
        self.nb = nb
        self.window = window
        self.dirty_rate_fn = dirty_rate_fn
        # misprediction feedback (core/guard.py): decayed by each guard abort
        # of this job's migrations, floor-clamped by the guard's policy. The
        # receding-horizon controller gates trough pricing on
        # confidence x trust, so a burned fit stops deferring launches to
        # troughs the model hallucinated until refits re-earn it.
        self.trust = 1.0
        self._store, self.row = store, -1
        #: (stamp of the commit it was built from, CycleModel)
        self._view: Optional[Tuple[int, cycles.CycleModel]] = None

    @property
    def model(self) -> Optional[cycles.CycleModel]:
        return self._store.model(self)

    @property
    def lm_series(self) -> torch.Tensor:
        """(window,) int8 LM series on the engine's device: a copy of the
        row, so a later refit leaves it as it is (empty before the first
        fit)."""
        return self._store.lm[self.row,
                              :int(self._store.length[self.row])].clone()

    @property
    def origin_step(self) -> int:
        """Step index of the first sample in the characterized window:
        Alg.1's profile is indexed from here, so Alg.2's M_current must be
        too."""
        return int(self._store.origin[self.row])

    @property
    def fitted_step(self) -> int:
        """Latest step at the last fit (-1 = never, or forced stale)."""
        return int(self._store.fitted[self.row])

    @fitted_step.setter
    def fitted_step(self, step: int) -> None:
        self._store.fitted[self.row] = step


class TickResult:
    """One surveillance tick's outcome: ``remain`` (job -> Alg.2 RemainTime
    in samples), ``refitted`` (cycle fits recomputed), ``fleet`` (jobs with
    a current model), ``confidence`` (job -> spectral confidence of its
    current fit — the guard layer's gating input, shared with the packed
    Alg. 2 cache and built on its first read, so a tick that does not read
    it pays nothing for it; the constructor takes the dict or a callable
    that returns it).

    With ``overlap=True`` the engine constructs this while Algorithm 2 is
    still executing on the device; the ``remain`` dict is
    built on first access from operands captured at dispatch time, so the
    values are bit-identical to the synchronous schedule — only the host
    sync moves.
    """
    __slots__ = ("_remain", "refitted", "fleet", "_confidence", "_thunk")

    def __init__(self, remain: Optional[Dict[str, int]], refitted: int,
                 fleet: int, confidence=None,
                 _thunk: Optional[Callable] = None):
        self._remain = remain
        self.refitted = refitted
        self.fleet = fleet
        self._confidence = confidence if confidence is not None else {}
        self._thunk = _thunk

    @property
    def confidence(self) -> Dict[str, float]:
        if callable(self._confidence):
            self._confidence = self._confidence()
        return self._confidence

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
        self._store = _FitStore(self.device, folded)
        self._decide_cache: Optional[Tuple] = None

    # -- registration -------------------------------------------------------
    def register(self, job_id: str, telemetry, nb: characterize.NaiveBayes,
                 *, window: int = 512, dirty_rate_fn=None) -> SurveilledJob:
        old = self.jobs.get(job_id)
        if old is not None:
            self._store.release(old)
        job = SurveilledJob(job_id, telemetry, nb, window, dirty_rate_fn,
                            self._store)
        job.row = self._store.add(job)
        self.jobs[job_id] = job
        self._decide_cache = None
        return job

    def unregister(self, job_id: str) -> None:
        job = self.jobs.pop(job_id, None)
        if job is not None:
            self._store.release(job)
            self._decide_cache = None

    # -- staleness epochs ---------------------------------------------------
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
        st = self._store
        rows = st.live_rows()
        if not len(rows):
            return np.inf
        latest, held = st.telemetry(rows)
        base = np.where(latest >= 0, latest, now_step - 1)
        ready = base + np.maximum(0, self.min_samples - held)
        fitted = st.fitted[rows]
        # stale on the first full window; else a threshold after the fit
        cand = np.where(fitted < 0, ready, np.maximum(
            ready, fitted + st.threshold(rows, self.acyclic_refit)))
        return int(cand.min())

    # -- the batched pipeline ----------------------------------------------
    def refresh(self, job_ids: Optional[List[str]] = None,
                *, force: bool = False) -> int:
        """Recompute the cycle fit of every stale (or ``force``d) job in
        one batched pipeline per (classifier, window-length) group.
        Returns the number of jobs refit."""
        st = self._store
        with spans.span("surveillance.refresh"):
            with spans.span("surveillance.select"):
                rows = (np.asarray([self.jobs[i].row for i in job_ids],
                                   np.int64)
                        if job_ids is not None else st.live_rows())
                latest, held = st.telemetry(rows)
                due = (latest >= 0) & (held >= self.min_samples)
                fitted = st.fitted[rows]
                if not force:
                    due &= (fitted < 0) | (latest - fitted >= st.threshold(
                        rows, self.acyclic_refit))
                rows, latest, fitted = rows[due], latest[due], fitted[due]
                if not len(rows):
                    return 0
                m = np.minimum(st.window[rows], held[due])
                delta = latest - fitted
                # incremental classification: NB is stateless per sample,
                # so a slid window only needs its NEW tail classified — the
                # stored lm series supplies the overlap (telemetry steps are
                # assumed dense, one sample per step, as the recorder
                # produces them)
                splice = ((fitted >= 0) & (st.length[rows] == m)
                          & (delta >= 0) & (delta < m))
                tail = np.where(splice, np.minimum(
                    m, _pow2(np.maximum(delta, 1))), m)
                nb = st.nb[rows]
                base = int(m.max()) + 1          # m and tail lie below it
                _, first, group = np.unique((nb * base + m) * base + tail,
                                            return_index=True,
                                            return_inverse=True)
            for g, i in enumerate(first.tolist()):
                at = group == g
                self._refresh_group(rows[at], latest[at], int(nb[i]),
                                    int(m[i]), int(tail[i]))
            return len(rows)

    def _refresh_group(self, rows: np.ndarray, latest: np.ndarray, nb: int,
                       m: int, tail: int) -> None:
        st, dev = self._store, self.device
        with spans.span("surveillance.gather"):
            # masked gather: NaN dropout samples come back zero-filled (the
            # batched NB/FFT stays finite) with their invalidity recorded,
            # so starved rows can be demoted instead of fit to hole-filled
            # data
            W, counts, valid = st.gather(rows, tail, dev)  # (G, tail, F)
            coverage = (valid.sum(dim=1).cpu().numpy()
                        / np.maximum(counts, 1))
        with spans.span("surveillance.classify"):
            lm_tail = shardlib.classify_lm(st.nbs[nb], W, self.mesh)
            if tail == m:
                LM = lm_tail                               # (G, m)
            else:
                # splice: row i keeps its stored series shifted left by d_i
                # samples and takes its last d_i samples from the new tail
                d = torch.as_tensor(latest - st.fitted[rows],
                                    device=dev)[:, None]
                old = st.lm[torch.as_tensor(rows, device=dev), :m]
                t = torch.arange(m, device=dev)[None, :]
                src = torch.where(t < m - d, t + d, tail + t)
                LM = torch.gather(torch.cat([old, lm_tail], dim=1), 1, src)
        fits = cycles.fit_cycle_rows(LM, mesh=self.mesh)
        with spans.span("surveillance.commit"):
            # blackout-starved windows: a cycle fit over zero-filled holes
            # is noise — demoted to acyclic until telemetry recovers and a
            # later refit sees real samples again
            st.commit(rows, fits, LM, latest, m,
                      coverage < self.min_coverage)
            self._decide_cache = None   # packed Alg.2 operands went stale

    def refresh_model(self, job_id: str, *, force: bool = False
                      ) -> Optional[cycles.CycleModel]:
        """Single-job view of ``refresh``: recompute if stale, then return
        the (possibly cached) model. None while history is too short."""
        self.refresh([job_id], force=force)
        return self.jobs[job_id].model

    # -- the batched tick ---------------------------------------------------
    def _packed_fleet(self) -> Tuple:
        """(ids, origins, profiles, periods, confidence) for the fitted
        fleet, padded for Alg. 2 straight from the fit store — cached
        between ticks and invalidated only by register/unregister/refit."""
        if self._decide_cache is None:
            with spans.span("surveillance.pack"):
                st, dev = self._store, self.device
                rows = np.flatnonzero(st.fit[:st.n] & st.live[:st.n])
                if not len(rows):
                    self._decide_cache = ((), None, None, None, {})
                else:
                    ids = tuple(st.ids[rows])
                    period = st.period[rows]
                    profiles = cycles.profile_rows(
                        st.lm[torch.as_tensor(rows, device=dev)], period,
                        folded=self.folded,
                        lengths=st.length[rows])
                    conf = st.confidence[rows]
                    self._decide_cache = (
                        ids, torch.as_tensor(st.origin[rows], device=dev),
                        profiles,
                        torch.as_tensor(period.astype(np.int32), device=dev),
                        functools.cache(
                            lambda: dict(zip(ids, conf.tolist()))))
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
        with spans.span("surveillance.tick", now_step):
            refitted = self.refresh()
            ids, origins, profiles, periods, conf = self._packed_fleet()
            if not ids:
                return TickResult({}, refitted, 0)
            J = len(ids)
            with spans.span("surveillance.decide", now_step):
                m_now = (now_step - origins).to(torch.int32)  # one vector op
                remain = shardlib.postpone_rows(profiles, periods, m_now,
                                                self.mesh,
                                                async_op=self.overlap)
                if not self.overlap:
                    return TickResult(dict(zip(ids, remain.tolist())),
                                      refitted, J, conf)

        def materialize(ids=ids, remain=remain) -> Dict[str, int]:
            with spans.span("surveillance.decide", now_step):
                return dict(zip(ids, remain.wait().tolist()))

        return TickResult(None, refitted, J, conf, _thunk=materialize)
