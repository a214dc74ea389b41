"""Algorithm 2 — identification of the live-migration moment (paper §5.2).

Counterpart of ``repro/core/postpone.py``. ``postpone(model, m_current)``
computes the paper's ``RemainTime`` on the host for one request: zero when
the workload's current relative moment sits in ArrayLM, otherwise the
distance to the first suitable moment, wrapping into the next cycle, with
a one-full-cycle backoff for an all-NLM profile. ``postpone_batch`` is the
same algorithm over a packed fleet as int32 tensor ops on the fleet's
device (the surveillance tick's decide stage).
"""
from __future__ import annotations

import torch

from repro_torch.core.cycles import CycleModel

_INT32_MAX = torch.iinfo(torch.int32).max


def postpone(model: CycleModel, m_current: int) -> int:
    """RemainTime in samples until the next suitable (LM) moment."""
    if model.period <= 1:
        return 0 if model.profile_lm.any() else int(model.period or 1)
    m_rel = int(m_current) % model.period
    if model.profile_lm[m_rel] == 1:
        return 0                                     # already suitable
    if len(model.array_lm) == 0:
        return model.period                          # acyclically busy: back off
    greater = model.array_lm[model.array_lm > m_rel]
    nxt = int(greater[0]) if len(greater) else int(model.array_lm[0]) + model.period
    return nxt - m_rel


def postpone_batch(profiles: torch.Tensor, periods: torch.Tensor,
                   m_current: torch.Tensor) -> torch.Tensor:
    """Vectorized Algorithm 2 over a fleet.

    profiles: (J, P_max) int8 (1=LM), padded with -1 beyond each period;
    periods: (J,) int32; m_current: (J,) int32. Returns (J,) int32
    RemainTime; rows with period <= 1 (padding included) decide to 0.
    """
    J, P_max = profiles.shape
    per = periods.to(torch.int32).clamp(min=1)
    m_rel = torch.remainder(m_current.to(torch.int32), per)
    idx = torch.arange(P_max, dtype=torch.int32, device=profiles.device)[None]
    valid = idx < periods[:, None]
    is_lm = (profiles == 1) & valid
    # distance from m_rel to each LM phase, wrapping within the period
    dist = torch.remainder(idx - m_rel[:, None], per[:, None])
    dist = torch.where(is_lm, dist, torch.full_like(dist, _INT32_MAX))
    remain = dist.min(dim=1).values
    none_lm = ~is_lm.any(dim=1)
    remain = torch.where(none_lm, periods.to(torch.int32), remain)  # backoff
    return torch.where(periods <= 1, torch.zeros_like(remain),
                       remain).to(torch.int32)

