"""Chunked gated linear attention on torch — the shared scan core for
Mamba2 (SSD) and RWKV6 (Finch) (``repro``'s ``models/gla.py``).

Both architectures are linear recurrences over an outer-product state::

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          # S: (Dk, Dv) per head
    y_t = q_t S_t            (+ bonus (q_t . u . k_t) v_t   for RWKV)

``gla_chunked`` evaluates them chunk-parallel (chunk Q tokens): a masked
(Q, Q) intra-chunk product plus a short scan carrying S between chunks. It
is the plain version of kernel B4 (``kernels/csrc/ssm_scan.cu``, the same
algorithm) and the CPU path of ``kernels.ops.ssm_scan``; the models call
that op, never this function directly. ``gla_decode_step`` is the exact
one-token recurrence of decode, plain torch on every device (the JAX
package has no kernel for it).

Numerics: all decay math in f32 log-space. Per-step log-decay is clamped to
[-LOG_DECAY_CLAMP, 0]; within a chunk, exponents are shifted by the
mid-chunk cumulative decay so both factors of the factored pairwise term
stay inside f32 range.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

LOG_DECAY_CLAMP = 4.0
CHUNK = 32


def clamp_log_decay(logw: torch.Tensor) -> torch.Tensor:
    return logw.clamp(-LOG_DECAY_CLAMP, 0.0)


def gla_chunked(
    q: torch.Tensor,            # (B, H, S, Dk)
    k: torch.Tensor,            # (B, H, S, Dk)
    v: torch.Tensor,            # (B, H, S, Dv)
    log_decay: torch.Tensor,    # (B, H, S, Dk) per-channel log decay (<= 0)
    *,
    bonus: Optional[torch.Tensor] = None,          # (H, Dk): RWKV 'u'
    initial_state: Optional[torch.Tensor] = None,  # (B, H, Dk, Dv)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B,H,S,Dv) f32, final_state: (B,H,Dk,Dv) f32).

    ``bonus is None`` selects SSD semantics (current token enters the state
    *before* readout: mask j<=t, no bonus). Otherwise RWKV semantics
    (readout sees only the past: mask j<t, current token contributes via
    ``bonus``)."""
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    S_orig, Q = S, CHUNK
    if S % Q:
        # zero-pad to a chunk multiple: k=v=0 adds nothing to the state and
        # log_decay=0 leaves it untouched, so padding is exact.
        pad = Q - S % Q
        q, k, v, log_decay = (F.pad(a, (0, 0, 0, pad))
                              for a in (q, k, v, log_decay))
        S += pad
    nc = S // Q

    qc = q.reshape(B, H, nc, Q, Dk).float()
    kc = k.reshape(B, H, nc, Q, Dk).float()
    vc = v.reshape(B, H, nc, Q, Dv).float()
    lw = clamp_log_decay(log_decay.reshape(B, H, nc, Q, Dk).float())

    ssd = bonus is None
    L = torch.cumsum(lw, dim=3)                      # inclusive cumsum
    L_q = L if ssd else L - lw                       # RWKV reads pre-decay
    L_total = L[:, :, :, -1, :]                      # (B,H,nc,Dk)
    shift = L[:, :, :, Q // 2, :][:, :, :, None, :]  # mid-chunk exponent shift

    q_in = qc * torch.exp(L_q - shift)               # (B,H,nc,Q,Dk)
    k_in = kc * torch.exp(shift - L)
    scores = torch.einsum("bhcqd,bhckd->bhcqk", q_in, k_in)
    pos = torch.arange(Q, device=q.device)
    mask = (pos[:, None] >= pos[None, :]) if ssd else \
        (pos[:, None] > pos[None, :])
    scores = torch.where(mask, scores, 0.0)
    if not ssd:
        diag = torch.einsum("bhcqd,hd,bhcqd->bhcq", qc,
                            bonus.to(qc.device, torch.float32), kc)
        scores = scores + diag[..., None] * torch.eye(Q, device=q.device)
    y_intra = torch.einsum("bhcqk,bhckv->bhcqv", scores, vc)

    # ---- inter-chunk: scan the per-chunk state summaries --------------------
    k_out = kc * torch.exp(L_total[:, :, :, None, :] - L)   # weight to chunk end
    chunk_states = torch.einsum("bhcqd,bhcqv->bhcdv", k_out, vc)
    decay_c = torch.exp(L_total)                            # (B,H,nc,Dk)

    state = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state.float())
    entering = []                                           # state entering chunk
    for c in range(nc):
        entering.append(state)
        state = decay_c[:, :, c, :, None] * state + chunk_states[:, :, c]
    entering = torch.stack(entering, dim=2)                 # (B,H,nc,Dk,Dv)

    q_inter = qc * torch.exp(L_q)
    y_inter = torch.einsum("bhcqd,bhcdv->bhcqv", q_inter, entering)

    y = (y_intra + y_inter).reshape(B, H, S, Dv)[:, :, :S_orig]
    return y, state


def gla_decode_step(
    q: torch.Tensor,            # (B, H, Dk)
    k: torch.Tensor,            # (B, H, Dk)
    v: torch.Tensor,            # (B, H, Dv)
    log_decay: torch.Tensor,    # (B, H, Dk)
    state: torch.Tensor,        # (B, H, Dk, Dv)
    *,
    bonus: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token exact recurrence (decode path). Matches gla_chunked;
    returns (y (B,H,Dv) f32, new state (B,H,Dk,Dv) f32)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    w = torch.exp(clamp_log_decay(log_decay.float()))
    kv = kf[..., :, None] * vf[..., None, :]               # (B,H,Dk,Dv)
    if bonus is None:                                      # SSD: state first
        state = w[..., None] * state + kv
        y = torch.einsum("bhd,bhdv->bhv", qf, state)
    else:                                                  # RWKV: read, bonus, then update
        y = torch.einsum("bhd,bhdv->bhv", qf, state)
        y = y + torch.einsum("bhd,hd,bhd->bh", qf, bonus.float(),
                             kf)[..., None] * vf
        state = w[..., None] * state + kv
    return y, state
