"""Train, prefill and serve step builders (``repro``'s ``train/steps.py``).

PyTorch runs them eagerly, so there is nothing to jit. The train step is a
plain function on the state dict: the loss and its gradient
(``torch.autograd.grad`` over the params' leaves), accumulation over
``cfg.accum_steps`` micro-batches in f32, then clip and optimizer
(``optim.apply_updates``; AdamW updates its moments and master in place).

Telemetry for ALMA is produced here: with ``telemetry=True`` every train
step reports the dirty-block profile of its update (the fraction of
parameter blocks it changed, and their bytes), the analogue of the paper's
SNMP-measured dirty page rate. On the card the block scan is kernel B3
(``kernels/csrc/dirty_delta.cu``), one launch for the whole tree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.backend import DeviceLike
from repro_torch.models import lm

TrainState = Dict[str, Any]


def init_train_state(cfg: ArchConfig, seed: int = 0, *,
                     device: DeviceLike = None) -> TrainState:
    """Seeded params (``lm.init_params``), a fresh optimizer state and step
    0, on ``device`` (``None`` is the card; ``"meta"`` gives shapes and
    dtypes only, e.g. as the ``like`` of a checkpoint restore)."""
    params = lm.init_params(cfg, seed, device=device)
    leaf = tree.leaves(params)[0]
    return {
        "params": params,
        "opt": optim.init_opt_state(cfg, params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


# ---------------------------------------------------------------------------
# dirty-block telemetry (ALMA load index: the pre-copy 'dirty page rate')
# ---------------------------------------------------------------------------
DIRTY_BLOCK = 1 << 14          # 16k-element blocks ~= 32 KiB bf16 "pages"


def _nan_blocks_changed(new: torch.Tensor, old: torch.Tensor, block: int,
                        idx: torch.Tensor) -> torch.Tensor:
    """For the blocks ``idx`` (whose max |delta| is NaN): does any element
    differ by more than 0? The reference's element-wise test, on those
    blocks only (the ragged last block as it is)."""
    n, o = new.reshape(-1), old.reshape(-1)
    out = []
    for b in idx.tolist():
        d = (n[b * block:(b + 1) * block].float()
             - o[b * block:(b + 1) * block].float()).abs()
        out.append(bool((d > 0).any()))
    return torch.tensor(out, dtype=torch.bool, device=idx.device)


def dirty_block_stats(old_params, new_params,
                      block: int = DIRTY_BLOCK) -> Dict[str, torch.Tensor]:
    """Per-update dirty profile: the fraction of ``block``-sized chunks of
    the flat leaves that changed, and their bytes (a changed block counts
    ``block * itemsize``, the ragged last one too), as f32 0-dim tensors
    accumulated leaf by leaf as the reference does.

    The float leaves go through ``ops.block_deltas`` (B3 on the card, one
    launch for the tree); a block is dirty when its max |delta| is above
    0. A block whose max is NaN is dirty when any of its elements differs
    by more than 0, the reference's element-wise test, decided by a plain
    test of those blocks alone. Integer leaves compare exactly."""
    olds, news = tree.leaves(old_params), tree.leaves(new_params)
    floats = [i for i, n in enumerate(news) if n.dtype.is_floating_point]
    deltas = dict(zip(floats, ops.block_deltas(
        [news[i] for i in floats], [olds[i] for i in floats], block=block)))
    changed = []
    for i, (o, n) in enumerate(zip(olds, news)):
        if i in deltas:
            changed.append(deltas[i] > 0)
        else:
            changed.append(ops.dirty_blocks(n.reshape(-1), o.reshape(-1),
                                            block=block))
    nans = [torch.isnan(deltas[i]).sum() if i in deltas
            else torch.zeros((), dtype=torch.int64, device=c.device)
            for i, c in enumerate(changed)]
    counts = torch.stack([torch.stack([c.sum(), k])             # one sync
                          for c, k in zip(changed, nans)]).tolist()
    for i, (_, n_nan) in enumerate(counts):
        if n_nan:                        # rare: decide those blocks plainly
            idx = torch.isnan(deltas[i]).nonzero().squeeze(1)
            changed[i][idx] = _nan_blocks_changed(news[i], olds[i], block,
                                                  idx)
            counts[i][0] = int(changed[i].sum())
    dirty_blocks = total_blocks = dirty_bytes = np.float32(0)
    for (n_dirty, _), c, n in zip(counts, changed, news):
        dirty_blocks += np.float32(n_dirty)
        total_blocks += np.float32(c.numel())
        dirty_bytes += np.float32(n_dirty * block * n.element_size())
    dev = news[0].device if news else None
    return {"dirty_fraction": torch.tensor(
                dirty_blocks / max(total_blocks, np.float32(1)),
                dtype=torch.float32, device=dev),
            "dirty_bytes": torch.tensor(dirty_bytes, dtype=torch.float32,
                                        device=dev)}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def make_train_step(cfg: ArchConfig, *, telemetry: bool = False,
                    schedule: Optional[Callable] = None):
    """Returns fn(state, batch) -> (state, metrics). Gradient accumulation
    over ``cfg.accum_steps`` micro-batches (a split of dim 0 of every batch
    entry; grads accumulated in f32). The state handed in must not be read
    again: AdamW updates its moments in place."""
    schedule = schedule or optim.make_schedule(cfg)

    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree.map(lambda p: p.detach().requires_grad_(True),
                            params)
            loss, metrics = lm.lm_loss(live, cfg, batch)
            grads = torch.autograd.grad(loss, tree.leaves(live))
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        A = cfg.accum_steps
        if A == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            micro = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree.leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            ms = []
            for a in range(A):
                l, m, g = grad_fn(params, {k: v[a] for k, v in micro.items()})
                grads = [acc + gi.float() for acc, gi in zip(grads, g)]
                loss = loss + l
                ms.append(m)
            grads = [g / A for g in grads]
            loss = loss / A
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        by_leaf = dict(zip(map(id, tree.leaves(params)), grads))
        grads = tree.map(lambda p: by_leaf[id(p)], params)
        lr = schedule(state["step"])
        new_params, new_opt, gnorm = optim.apply_updates(
            cfg, params, grads, state["opt"], lr)
        del grads, by_leaf
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        if telemetry:
            metrics.update(dirty_block_stats(params, new_params))
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ArchConfig, cache_len: int):
    """fn(params, batch) -> (last_logits (B, V), cache)."""

    def prefill_step(params, batch):
        x, _, cache = lm.forward(params, cfg, batch, want_cache=True,
                                 cache_len=cache_len)
        logits = lm._head(cfg, params, x[:, -1:, :])[:, 0]
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """serve_step: fn(params, token (B,1), cache) -> (greedy next_token,
    logits, cache). The cache's KV rings are written in place."""

    def serve_step(params, token, cache):
        logits, cache = lm.decode_step(params, cfg, token, cache)
        nxt = logits.argmax(dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step
