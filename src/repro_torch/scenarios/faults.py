"""Seeded, deterministic fault plans for the fleet simulator.

A ``FaultPlan`` is an ordered schedule of :class:`FaultEvent` — host
crashes/recoveries and link capacity changes — that ``FleetSim`` drives as
first-class event boundaries: every event fires at the first sampling
boundary at or after its ``t``, and the event-skipping fast paths
(``run_idle`` bulk appends, ``_skip_idle_steps``) never jump over one, so
a faulted run is bit-identical between ``event_skip`` on and off.

Event kinds
-----------
``host_fail``
    The host dies at ``t``: every in-flight lane with it as an endpoint
    is aborted (partial bytes settled, see ``MigrationPlane.fail_host``),
    aborted requests re-enter the LMCM with exponential backoff, and —
    when the simulator's ``evacuate_on_fail`` is set — the VMs resident
    on the host are cold-restarted onto live hosts via urgent requests.
``host_recover``
    The host rejoins at ``t``: it becomes a valid endpoint again.
``link_degrade`` / ``link_restore``
    The link's capacity becomes ``capacity`` at ``t`` (identity, paths,
    and domains are unchanged; 0.0 stalls its flows until restored).
    The two kinds are synonyms mechanically — the split keeps plans
    readable and lets reports tell brownouts from repairs.
``link_fail``
    Correlated outage: the link's capacity drops to ``capacity``
    (typically 0.0) AND every in-flight lane whose path crosses it is
    aborted (``abort_link`` — partial bytes settled exactly as a host
    failure would). Aborted requests re-enter the LMCM with backoff; on a
    multi-route fabric the retry re-routes around the dead link, so a
    ToR/pod-uplink loss fails the lanes over to a surviving spine plane
    instead of stalling them in place the way a 0.0 ``link_degrade``
    does. ``link_restore`` brings the link back.
``telemetry_blackout`` / ``telemetry_restore``
    Sensor dropout: from ``t`` until the matching restore, the listed
    ``jobs`` record NaN telemetry samples instead of real load indexes.
    The simulator injects the NaNs identically on its scalar and bulk
    recording paths (and the rng draws are unchanged — values are
    overwritten after sampling), so blacked-out runs stay bit-identical
    between ``event_skip`` on/off. Downstream, the surveillance gather
    masks the NaNs and demotes under-covered rows to acyclic
    (``SurveillanceEngine.min_coverage``).

An empty plan is falsy; ``FleetSim`` treats it exactly like no plan at
all, which is what keeps every existing benchmark and bit-identity
contract unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Mapping, Optional, Sequence

import numpy as np

HOST_FAIL = "host_fail"
HOST_RECOVER = "host_recover"
LINK_DEGRADE = "link_degrade"
LINK_RESTORE = "link_restore"
LINK_FAIL = "link_fail"
TELEMETRY_BLACKOUT = "telemetry_blackout"
TELEMETRY_RESTORE = "telemetry_restore"
KINDS = (HOST_FAIL, HOST_RECOVER, LINK_DEGRADE, LINK_RESTORE, LINK_FAIL,
         TELEMETRY_BLACKOUT, TELEMETRY_RESTORE)


@dataclass(frozen=True)
class FaultEvent:
    t: float                 # sim-clock seconds (absolute, incl. warmup)
    kind: str                # one of KINDS
    target: str              # host id (host_*) or link id (link_*)
    capacity: float = 0.0    # link events: the new capacity, bytes/s
    # telemetry events: the affected job ids (sensor dropout is per
    # monitoring agent, not per link). Empty on other kinds.
    jobs: tuple = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")


class FaultPlan:
    """Deterministic fault schedule: events sorted by time (stable, so
    same-instant events keep their authored order)."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(events, key=lambda e: e.t)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __repr__(self) -> str:
        return f"FaultPlan({self.events!r})"

    # -- builders ------------------------------------------------------------
    @classmethod
    def host_failure(cls, t: float, host: str, *,
                     recover_at: Optional[float] = None) -> "FaultPlan":
        """One host crash at ``t``, optionally rejoining at
        ``recover_at``."""
        events = [FaultEvent(t, HOST_FAIL, host)]
        if recover_at is not None:
            events.append(FaultEvent(recover_at, HOST_RECOVER, host))
        return cls(events)

    @classmethod
    def link_brownout(cls, t: float, link: str, capacity: float, *,
                      restore_at: Optional[float] = None,
                      restore_capacity: Optional[float] = None
                      ) -> "FaultPlan":
        """Degrade ``link`` to ``capacity`` at ``t``, optionally restoring
        ``restore_capacity`` at ``restore_at``."""
        events = [FaultEvent(t, LINK_DEGRADE, link, capacity=capacity)]
        if restore_at is not None:
            if restore_capacity is None:
                raise ValueError("restore_at needs restore_capacity "
                                 "(the original link speed)")
            events.append(FaultEvent(restore_at, LINK_RESTORE, link,
                                     capacity=restore_capacity))
        return cls(events)

    @classmethod
    def access_outage(cls, t: float, link: str, *,
                      restore_at: Optional[float] = None,
                      restore_capacity: Optional[float] = None
                      ) -> "FaultPlan":
        """Correlated rack/ToR (or pod-uplink) loss: ``link`` goes to
        capacity 0 at ``t`` and every lane riding it aborts
        (``link_fail`` — the retries re-route around the outage on
        multi-route fabrics), optionally restoring ``restore_capacity``
        at ``restore_at``."""
        events = [FaultEvent(t, LINK_FAIL, link, capacity=0.0)]
        if restore_at is not None:
            if restore_capacity is None:
                raise ValueError("restore_at needs restore_capacity "
                                 "(the original link speed)")
            events.append(FaultEvent(restore_at, LINK_RESTORE, link,
                                     capacity=restore_capacity))
        return cls(events)

    @classmethod
    def random(cls, hosts: Sequence[str], link_caps: Mapping[str, float],
               *, horizon_s: float, seed: int = 0,
               n_host_faults: int = 1, n_link_faults: int = 1,
               mttr_s: float = 300.0, degrade_frac: float = 0.1
               ) -> "FaultPlan":
        """Seeded random plan: ``n_host_faults`` crashes (each recovering
        after ``mttr_s``) and ``n_link_faults`` brownouts to
        ``degrade_frac`` of nominal capacity (restored after ``mttr_s``),
        uniformly placed over ``[0, horizon_s)``. Deterministic in
        ``seed``."""
        rng = np.random.default_rng(seed)
        hosts = list(hosts)
        links = list(link_caps)
        events: List[FaultEvent] = []
        for _ in range(n_host_faults):
            h = hosts[int(rng.integers(len(hosts)))]
            t = float(rng.uniform(0.0, horizon_s))
            events.append(FaultEvent(t, HOST_FAIL, h))
            events.append(FaultEvent(t + mttr_s, HOST_RECOVER, h))
        for _ in range(n_link_faults):
            l = links[int(rng.integers(len(links)))]
            t = float(rng.uniform(0.0, horizon_s))
            events.append(FaultEvent(
                t, LINK_DEGRADE, l, capacity=degrade_frac * link_caps[l]))
            events.append(FaultEvent(
                t + mttr_s, LINK_RESTORE, l, capacity=link_caps[l]))
        return cls(events)

    @classmethod
    def telemetry_blackout(cls, t: float, jobs: Sequence[str], *,
                           duration_s: float, frac: float = 1.0,
                           seed: int = 0) -> "FaultPlan":
        """Seeded sensor dropout: a ``frac`` subset of ``jobs`` (chosen
        deterministically by ``seed``) records NaN samples over
        ``[t, t + duration_s)``. ``frac=1.0`` blacks out every listed
        job (no rng draw — independent of seed)."""
        jobs = list(jobs)
        if frac >= 1.0:
            picked = tuple(jobs)
        else:
            rng = np.random.default_rng(seed)
            k = max(1, int(round(frac * len(jobs))))
            picked = tuple(sorted(
                np.asarray(jobs)[rng.permutation(len(jobs))[:k]].tolist()))
        return cls([
            FaultEvent(t, TELEMETRY_BLACKOUT, "", jobs=picked),
            FaultEvent(t + duration_s, TELEMETRY_RESTORE, "", jobs=picked),
        ])

    def shifted(self, dt: float) -> "FaultPlan":
        """The same plan with every event time shifted by ``dt`` —
        scenarios author relative times, then shift past warmup."""
        return FaultPlan(FaultEvent(e.t + dt, e.kind, e.target, e.capacity,
                                    e.jobs)
                         for e in self.events)
