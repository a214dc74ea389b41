"""Load-index telemetry — the analogue of the paper's 15-second SNMP
samples (§4, §6.4.1). Counterpart of ``repro/core/telemetry.py``.

Each job (training/serving replica) owns a ``TelemetryBuffer``; the runtime
records one sample per step with exact in-process load indexes (no semantic
gap): dirty-bytes of the last update, collective bytes, step time, tokens/s.
The LMCM reads fixed-length windows for characterization. Gathering overhead
is measured in ``benchmarks/fig11_gathering.py``.

Fleet scale: ``FleetTelemetry`` keeps the whole fleet's samples in one
structure-of-arrays ring buffer — (J, capacity, F) — so the surveillance
engine (``core/surveillance.py``) gathers every job's window in a single
vectorized ``window_matrix`` call instead of J per-buffer copies, and the
simulator records one (J, F) row per step instead of J dict-kwarg calls.
Per-job ``view(j)`` adapters expose the ``TelemetryBuffer`` read/record
surface, so existing consumers (LMCM registration, examples) are agnostic
to which backing store a job uses.

In the port the fleet's value ring is an f64 tensor on the fleet's device
(the card unless the caller asks for the CPU): a gather for the tick never
leaves the device. Step stamps and per-job counts stay host numpy, as do
the per-job ``TelemetryBuffer`` rings and every per-job read (``window``).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.runtime import spans

DEFAULT_FIELDS: Tuple[str, ...] = (
    "step_time", "dirty_bytes", "dirty_fraction", "collective_bytes",
    "compute_util", "hbm_util",
)


class TelemetryBuffer:
    """Fixed-capacity ring buffer of per-step load indexes."""

    def __init__(self, capacity: int = 8192,
                 fields: Sequence[str] = DEFAULT_FIELDS):
        self.fields = tuple(fields)
        self.capacity = capacity
        self._data = np.zeros((capacity, len(self.fields)), np.float64)
        self._steps = np.full(capacity, -1, np.int64)
        self._n = 0
        self._lock = threading.Lock()

    def record(self, step: int, **indexes: float) -> None:
        with self._lock:
            i = self._n % self.capacity
            for j, f in enumerate(self.fields):
                self._data[i, j] = float(indexes.get(f, 0.0))
            self._steps[i] = step
            self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def latest_step(self) -> int:
        with self._lock:
            if self._n == 0:
                return -1
            return int(self._steps[(self._n - 1) % self.capacity])

    def window(self, n: int) -> np.ndarray:
        """Most recent ``n`` samples, oldest first. Shape (m<=n, F)."""
        with self._lock:
            m = min(n, len(self))
            if m == 0:
                return np.zeros((0, len(self.fields)))
            idx = (np.arange(self._n - m, self._n)) % self.capacity
            return self._data[idx].copy()

    def series(self, field: str, n: Optional[int] = None) -> np.ndarray:
        j = self.fields.index(field)
        return self.window(n if n is not None else len(self))[:, j]

    def snapshot(self) -> Dict[str, np.ndarray]:
        w = self.window(len(self))
        return {f: w[:, j] for j, f in enumerate(self.fields)}

    @staticmethod
    def window_matrix(buffers: Sequence["TelemetryBuffer"], n: int,
                      return_mask: bool = False, *,
                      device: DeviceLike = None):
        """Gather the most recent ``n`` samples of many buffers into one
        (J, n, F) f64 tensor on ``device`` in a single call (lengths stay
        a host array, the mask is a tensor beside the matrix).

        Buffers backed by the same ``FleetTelemetry`` are gathered with one
        vectorized fancy-index; foreign buffers fall back to per-buffer
        ``window`` copies into the preallocated output. Short histories are
        left zero at the front; the second return value holds each job's
        valid sample count (callers batch jobs with equal counts).

        ``return_mask=True`` adds a (J, n) bool validity mask (recorded AND
        every field finite); non-finite samples are zero-filled in the
        output so classify/cycle-fit math stays finite while coverage
        gates see the dropout.
        """
        dev = resolve_device(device)
        J = len(buffers)
        F = len(buffers[0].fields) if J else 0
        out = torch.zeros((J, n, F), dtype=torch.float64, device=dev)
        lengths = np.zeros(J, np.int64)
        mask = (torch.zeros((J, n), dtype=torch.bool, device=dev)
                if return_mask else None)
        # fleet fast path: group contiguous views of a shared SoA store
        by_fleet: Dict[int, List[int]] = {}
        for j, b in enumerate(buffers):
            fleet = getattr(b, "fleet", None)
            if fleet is not None and tuple(b.fields) == (
                    tuple(buffers[0].fields)):
                by_fleet.setdefault(id(fleet), []).append(j)
        done = np.zeros(J, bool)
        for js in by_fleet.values():
            fleet = buffers[js[0]].fleet
            rows = np.asarray([buffers[j].index for j in js])
            dst = torch.as_tensor(js, device=dev)
            if return_mask:
                w, m, fm = fleet.window_matrix(n, rows=rows,
                                               return_mask=True)
                mask[dst] = fm.to(dev)
            else:
                w, m = fleet.window_matrix(n, rows=rows)
            out[dst] = w.to(dev)
            lengths[js] = m
            done[js] = True
        for j, b in enumerate(buffers):
            if done[j]:
                continue
            w = b.window(n)
            lengths[j] = len(w)
            if len(w):
                if return_mask:
                    finite = np.isfinite(w).all(axis=1)
                    mask[j, n - len(w):] = torch.as_tensor(finite, device=dev)
                    w = np.where(finite[:, None], w, 0.0)
                out[j, n - len(w):] = torch.as_tensor(w, device=dev)
        if return_mask:
            return out, lengths, mask
        return out, lengths


class FleetJobView:
    """One job's ``TelemetryBuffer``-compatible view into a FleetTelemetry
    SoA store (read surface + per-step ``record``)."""

    def __init__(self, fleet: "FleetTelemetry", index: int):
        self.fleet = fleet
        self.index = index
        self.fields = fleet.fields
        self.capacity = fleet.capacity

    def __len__(self) -> int:
        return int(min(self.fleet._n[self.index], self.capacity))

    def record(self, step: int, **indexes: float) -> None:
        self.fleet.record_job(self.index, step, **indexes)

    def latest_step(self) -> int:
        return self.fleet.latest_step(self.index)

    def window(self, n: int) -> np.ndarray:
        w, m = self.fleet.window_matrix(n, rows=np.asarray([self.index]))
        return w[0, n - int(m[0]):].cpu().numpy()

    def series(self, field: str, n: Optional[int] = None) -> np.ndarray:
        j = self.fields.index(field)
        return self.window(n if n is not None else len(self))[:, j]

    def snapshot(self) -> Dict[str, np.ndarray]:
        w = self.window(len(self))
        return {f: w[:, j] for j, f in enumerate(self.fields)}


class FleetTelemetry:
    """Fleet-wide structure-of-arrays telemetry ring buffer.

    One (J, capacity, F) array holds every job's samples; ``record_fleet``
    appends one (J, F) row per step for the whole fleet and
    ``window_matrix`` gathers all windows with one fancy-index — the O(J)
    Python dispatch of per-job ring buffers disappears from both the record
    and the surveillance-gather path. Jobs may also record independently
    (``record_job`` / per-job views); counts are tracked per job.
    """

    def __init__(self, n_jobs: int, capacity: int = 8192,
                 fields: Sequence[str] = DEFAULT_FIELDS, *,
                 device: DeviceLike = None):
        self.fields = tuple(fields)
        self.capacity = capacity
        self.n_jobs = n_jobs
        self.device = resolve_device(device)
        self._data = torch.zeros((n_jobs, capacity, len(self.fields)),
                                 dtype=torch.float64, device=self.device)
        self._rows = torch.arange(n_jobs, device=self.device)
        self._steps = np.full((n_jobs, capacity), -1, np.int64)
        self._n = np.zeros(n_jobs, np.int64)
        self._lock = threading.Lock()

    def view(self, index: int) -> FleetJobView:
        return FleetJobView(self, index)

    def views(self) -> List[FleetJobView]:
        return [FleetJobView(self, j) for j in range(self.n_jobs)]

    def record_fleet(self, step: int, values: np.ndarray) -> None:
        """Append one sample row per job. values: (J, F) ordered like
        ``fields``."""
        with spans.span("telemetry.record_fleet", step), self._lock:
            values = np.asarray(values, np.float64)
            i = self._n % self.capacity                     # (J,)
            rows = np.arange(self.n_jobs)
            self._data[self._rows, self._dev(i)] = self._dev(values)
            self._steps[rows, i] = step
            self._n += 1

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def record_fleet_bulk(self, steps: np.ndarray,
                          values: np.ndarray) -> None:
        """Append S fleet rows in one call — ring contents (slots, step
        stamps, counts) identical to S successive ``record_fleet`` calls.
        ``steps``: (S,), ``values``: (S, J, F). The event-skipping
        simulator uses this to land a whole skipped window's telemetry
        without S Python iterations; appends past a full wrap keep only
        the surviving tail (earlier rows would be overwritten anyway)
        while still advancing every job's sample count by S."""
        steps = np.asarray(steps, np.int64)
        values = np.asarray(values, np.float64)
        s = steps.shape[0]
        if s == 0:
            return
        with self._lock:
            if s > self.capacity:        # only the tail survives the wrap
                drop = s - self.capacity
                steps, values = steps[drop:], values[drop:]
                self._n += drop
                s = self.capacity
            idx = (self._n[:, None] + np.arange(s)) % self.capacity  # (J, S)
            rows = np.arange(self.n_jobs)[:, None]
            self._data[self._rows[:, None], self._dev(idx)] = \
                self._dev(np.ascontiguousarray(values.transpose(1, 0, 2)))
            self._steps[rows, idx] = steps[None, :]
            self._n += s

    def record_job(self, index: int, step: int, **indexes: float) -> None:
        with self._lock:
            i = int(self._n[index] % self.capacity)
            self._data[index, i] = self._dev(np.asarray(
                [float(indexes.get(f, 0.0)) for f in self.fields]))
            self._steps[index, i] = step
            self._n[index] += 1

    def latest_step(self, index: int) -> int:
        with self._lock:
            if self._n[index] == 0:
                return -1
            return int(self._steps[index,
                                   (self._n[index] - 1) % self.capacity])

    def latest_steps(self) -> np.ndarray:
        """(J,) latest recorded step per job (-1 when empty) — one call."""
        with self._lock:
            rows = np.arange(self.n_jobs)
            idx = (self._n - 1) % self.capacity
            out = self._steps[rows, idx].copy()
            out[self._n == 0] = -1
            return out

    def window_matrix(self, n: int, rows: Optional[np.ndarray] = None,
                      return_mask: bool = False):
        """Most recent ``n`` samples for ``rows`` (default: all jobs) as one
        (len(rows), n, F) f64 gather on the fleet's device, oldest first,
        zero-padded at the front. Returns (matrix, per-job valid counts as
        a host array).

        With ``return_mask=True`` also returns a (R, n) bool validity mask:
        True only for recorded samples whose every field is finite. NaN
        samples (sensor dropout / telemetry blackout) are zero-filled in
        the matrix so downstream batched math stays finite, and masked
        False so coverage gates can demote starved rows; the default call
        leaves NaNs in place (the store accepts them verbatim)."""
        with self._lock:
            if rows is None:
                rows = np.arange(self.n_jobs)
            rows = np.asarray(rows)
            counts = np.minimum(self._n[rows], self.capacity)
            m = np.minimum(counts, n)                       # (R,)
            start = self._n[rows] - m
            # gather index t in [0, n): maps to ring slot of sample
            # (start + t - (n - m)); invalid front entries are zeroed after
            # the gather. Built on the device from (R,) host vectors.
            t = torch.arange(n, device=self.device)[None, :]
            rel = t - self._dev(n - m)[:, None]
            idx = torch.remainder(self._dev(start)[:, None] + rel,
                                  self.capacity)
            w = self._data[self._dev(rows)[:, None], idx]
            w[rel < 0] = 0.0
            if not return_mask:
                return w, m
            finite = torch.isfinite(w).all(dim=2)           # (R, n)
            mask = (rel >= 0) & finite
            w[~finite] = 0.0
            return w, m, mask
