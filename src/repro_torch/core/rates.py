"""Piecewise-constant dirty-rate tables — the fleet's vectorizable rate spec.

A live migration's cost is driven by the dirty rate r(t) of the workload
being moved (paper §3.2); the fleet represents every workload's rate as a
``PiecewiseRate`` — a cyclic table of (phase end, rate) pairs.  The table
form is what makes the whole execution stack vectorizable:

  * ``PiecewiseRate.batch`` stacks M tables into one padded lookup, so the
    batched pre-copy simulator (``strunk.simulate_precopy_batch``) samples
    the entire fleet's rates per round in one call;
  * the migration plane (``core/plane.py``) registers each launched lane's
    table into the same padded layout (``RateBank``) and accrues dirty
    bytes for every in-flight lane per event chunk in one lookup — no
    per-lane Python in the event loop.

Scalar calls (``rate(t)``) and every batched path index the same tables
with the same float64 arithmetic, so scalar vs batch agree bit-for-bit —
the parity contract the simulator and the plane's scalar-reference tests
rely on.

Lane-registration API (what the plane accepts per lane):

  =====================  =================================================
  spec                   vectorized handling
  =====================  =================================================
  ``None``               rate 0 (nothing dirties; pre-copy converges in
                         one round)
  ``float``              constant rate — a one-entry table
  ``PiecewiseRate``      table row in the shared padded lookup
  object with a
  ``rate_table``         its ``PiecewiseRate`` is registered (e.g. a
  attribute              ``fleetsim.WorkloadTrace``)
  plain callable         compatibility path: sampled per lane per event
                         (keeps third-party rate functions working, but
                         re-introduces O(lanes) Python — prefer tables)
  =====================  =================================================

``as_rate_table`` performs that normalization; ``RateBank`` is the plane's
stacked-lookup container.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np


class PiecewiseRate:
    """Piecewise-constant cyclic rate r(t) backed by phase-end tables.

    ``ends`` are cumulative phase end times, ``rates`` the per-phase value;
    the pattern repeats every ``ends[-1]`` seconds, shifted by ``offset``.
    Scalar calls and the vectorized ``batch`` path index the same tables
    with the same float64 arithmetic, so they agree bit-for-bit — the
    parity contract ``strunk.simulate_precopy_batch`` relies on.
    """

    def __init__(self, ends: Sequence[float], rates: Sequence[float],
                 offset: float = 0.0):
        self.ends = np.asarray(ends, np.float64)
        self.rates = np.asarray(rates, np.float64)
        self.cycle = float(self.ends[-1])
        self.offset = float(offset)

    def index_at(self, t: float) -> int:
        tc = (t + self.offset) % self.cycle
        i = int(np.searchsorted(self.ends, tc, side="right"))
        return min(i, len(self.rates) - 1)

    def __call__(self, t: float) -> float:
        return float(self.rates[self.index_at(t)])

    @staticmethod
    def stack(lanes: Sequence["PiecewiseRate"]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Pad M tables into one (ends, rates, cycle, offset) array set —
        the storable form behind ``batch`` and ``RateBank``. Padding rule:
        ``ends`` extend with inf (never matched), ``rates`` replicate each
        row's last value, so any further right-padding of a stacked row is
        idempotent (``RateBank.concat`` re-pads to a common width)."""
        m = len(lanes)
        width = max(len(l.rates) for l in lanes)
        ends = np.full((m, width), np.inf)
        rates = np.zeros((m, width))
        for i, l in enumerate(lanes):
            n = len(l.rates)
            ends[i, :n] = l.ends
            rates[i, :n] = l.rates
            rates[i, n:] = l.rates[-1]
        cyc = np.asarray([l.cycle for l in lanes])
        off = np.asarray([l.offset for l in lanes])
        return ends, rates, cyc, off

    @staticmethod
    def lookup_fn(ends: np.ndarray, rates: np.ndarray, cyc: np.ndarray,
                  off: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
        """The vectorized (M,) time -> (M,) rate lookup over stacked
        tables (see ``stack``). Per-lane arithmetic is independent of the
        stack's width and row order, so gathered/concatenated stacks
        sample bit-identically to freshly built ones."""
        m, width = rates.shape
        # flat-table lookup with persistent scratch: per-phase column
        # compares (W is tiny) + in-place ufuncs beat a (M, W)
        # broadcast+reduce by ~5x in numpy dispatch overhead — this sits on
        # the batch simulator's per-round hot path. The returned array is a
        # reused buffer: callers consume it before the next call.
        cols = [np.ascontiguousarray(ends[:, k]) for k in range(width)]
        flat = np.ascontiguousarray(rates.ravel())
        row_off = np.arange(m, dtype=np.intp) * width
        tc = np.empty(m)
        idx = np.empty(m, np.intp)
        cmp = np.empty(m, bool)
        out = np.empty(m)

        def fn(t: np.ndarray) -> np.ndarray:
            np.add(t, off, out=tc)
            np.mod(tc, cyc, out=tc)
            np.copyto(idx, row_off)
            for col in cols[:-1]:       # tc < ends[-1] always
                np.greater_equal(tc, col, out=cmp)
                np.add(idx, cmp, out=idx, casting="unsafe")
            return flat.take(idx, out=out)
        fn.vectorized = True
        fn.nonneg = bool(np.all(rates >= 0.0))
        return fn

    @staticmethod
    def batch(lanes: Sequence["PiecewiseRate"]
              ) -> Callable[[np.ndarray], np.ndarray]:
        """One vectorized rate function over (M,) lanes: maps the (M,) time
        array to (M,) rates in a single padded table lookup."""
        return PiecewiseRate.lookup_fn(*PiecewiseRate.stack(lanes))


RateSpec = Union[None, float, PiecewiseRate, Callable[[float], float]]


def as_rate_table(spec: RateSpec) -> Optional[PiecewiseRate]:
    """Normalize a lane's rate spec to a ``PiecewiseRate`` table, or None
    when only per-call sampling is possible (plain callables).

    Constants become one-entry tables (cycle 1.0 — any positive cycle
    yields the same value everywhere); objects exposing a ``rate_table``
    attribute (e.g. ``WorkloadTrace``) contribute their table directly.
    """
    if spec is None:
        return PiecewiseRate([1.0], [0.0])
    if isinstance(spec, PiecewiseRate):
        return spec
    table = getattr(spec, "rate_table", None)
    if isinstance(table, PiecewiseRate):
        return table
    if callable(spec):
        return None
    return PiecewiseRate([1.0], [float(spec)])


class RateBank:
    """Stacked rate tables for the plane's in-flight lanes.

    Holds one padded table row per lane plus a per-lane fallback callable
    slot for specs that cannot be tabulated. ``sample(t, copy_mask)``
    returns the (M,) dirty rates at scalar time ``t`` — one padded lookup
    for every table lane, a scalar call per fallback lane still in its
    copy phase (matching the reference loop's call pattern bit-for-bit).

    The padded tables are stored as plain arrays, so banks compose
    without re-normalizing specs: ``concat`` stitches two banks (the
    fabric merges the banks of two bridged migration domains instead of
    rebuilding from the lane list), ``take`` gathers arbitrary rows into
    a derived bank (the defer-k sweep prices all n+1 nested prefixes
    through ONE bank built from the n unique candidate tables). Both are
    numpy copies — no per-lane Python — and both sample bit-identically
    to a freshly built bank (per-row lookups are width/order agnostic).
    """

    def __init__(self, specs: Sequence[RateSpec]):
        tables: List[PiecewiseRate] = []
        fallback: List[Tuple[int, Callable[[float], float]]] = []
        for i, spec in enumerate(specs):
            table = as_rate_table(spec)
            if table is None:
                fallback.append((i, spec))
                table = PiecewiseRate([1.0], [0.0])   # placeholder row
            tables.append(table)
        self._init_arrays(
            *(PiecewiseRate.stack(tables) if tables
              else (np.full((0, 1), np.inf), np.zeros((0, 1)),
                    np.zeros(0), np.zeros(0))),
            fallback)

    def _init_arrays(self, ends, rates, cyc, off, fallback) -> None:
        self.m = len(cyc)
        self._ends, self._rates = ends, rates
        self._cyc, self._off = cyc, off
        self.fallback = fallback
        self._lookup = PiecewiseRate.lookup_fn(ends, rates, cyc, off) \
            if self.m else None
        # public view of the stacked lookup: an (M,) time array -> (M,)
        # rates callable (``.vectorized``/``.nonneg`` set), valid whenever
        # ``fallback`` is empty — strunk's what-if costing reuses it to
        # price hypothetical lane batches through the same tables
        self.table_fn = self._lookup
        self._t = np.empty(self.m)
        self._out = np.empty(self.m)

    @classmethod
    def _from_arrays(cls, ends, rates, cyc, off, fallback) -> "RateBank":
        bank = cls.__new__(cls)
        bank._init_arrays(ends, rates, cyc, off, fallback)
        return bank

    @staticmethod
    def _pad_to(ends: np.ndarray, rates: np.ndarray, width: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Right-pad stacked tables to ``width`` columns under the
        ``PiecewiseRate.stack`` padding rule (idempotent: trailing rate
        columns already replicate each row's last valid value)."""
        m, w = rates.shape
        if w >= width:
            return ends, rates
        e = np.full((m, width), np.inf)
        r = np.empty((m, width))
        e[:, :w] = ends
        r[:, :w] = rates
        r[:, w:] = rates[:, w - 1:w]
        return e, r

    @classmethod
    def concat(cls, a: "RateBank", b: "RateBank") -> "RateBank":
        """Bank holding ``a``'s lanes followed by ``b``'s — array
        concatenation only (no spec re-normalization); rows sample
        bit-identically to a rebuild over the combined lane list."""
        width = max(a._rates.shape[1], b._rates.shape[1])
        ea, ra = cls._pad_to(a._ends, a._rates, width)
        eb, rb = cls._pad_to(b._ends, b._rates, width)
        fallback = list(a.fallback) + [(i + a.m, fn) for i, fn in b.fallback]
        return cls._from_arrays(
            np.concatenate([ea, eb]), np.concatenate([ra, rb]),
            np.concatenate([a._cyc, b._cyc]),
            np.concatenate([a._off, b._off]), fallback)

    def take(self, idx: np.ndarray) -> "RateBank":
        """Bank whose lane ``j`` is this bank's lane ``idx[j]`` (rows may
        repeat) — one fancy-index gather."""
        idx = np.asarray(idx, np.intp)
        if self.fallback:
            by_row = dict(self.fallback)
            fallback = [(j, by_row[int(i)]) for j, i in enumerate(idx)
                        if int(i) in by_row]
        else:
            fallback = []
        return self._from_arrays(
            self._ends[idx], self._rates[idx], self._cyc[idx],
            self._off[idx], fallback)

    def sample(self, t: float, copy_mask: np.ndarray) -> np.ndarray:
        """(M,) rates at time ``t``; fallback lanes are sampled only while
        ``copy_mask`` is set (stopped lanes accrue nothing, and the
        reference loop never calls their rate function either)."""
        if self._lookup is None:
            return self._out
        self._t.fill(t)
        np.copyto(self._out, self._lookup(self._t))
        for i, fn in self.fallback:
            self._out[i] = float(fn(t)) if copy_mask[i] else 0.0
        return self._out
