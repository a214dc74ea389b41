"""Gradients of the forward kernels B5 (flash attention) and B4 (the SSM
scan) for training.

No kernel of the JAX package has a backward: it trains by differentiating
the XLA functions its models run in the kernels' place,
``_chunked_causal_attention`` (``repro/models/blocks.py``) and
``gla_chunked`` (``repro/models/gla.py``). The port does the same. Each
``torch.autograd.Function`` here runs its forward through the op (the
kernel on a CUDA tensor, the plain version on the CPU), saves its inputs,
and in backward takes the VJP of the plain chunked function
(``ref.attention_chunked``, ``gla.gla_chunked``), recomputed under
``torch.enable_grad()``. That backward is plain PyTorch on every device;
it replaces no kernel. It runs the plain forward again, graph and all,
before it differentiates it: the kernel's output is not reused. A backward
that starts from the saved output and a per-row logsumexp (which B5 does
not emit yet) would not run the plain forward.

The scan's gradient flows to ``y`` only; its final state is not
differentiated (training never reads it). Inputs given as stride-0 views
(Mamba2's B and C shared by every head, its per-head decay over the state
dimension) get a gradient of the full view's shape, which autograd sums
back through the expand that made the view.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.models import gla


def _plain_vjp(fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
               needs: Sequence[bool], grad_out: torch.Tensor):
    """Gradients of ``fn(*inputs)`` (its first output when it returns a
    tuple) against ``grad_out``, for the inputs ``needs`` marks; ``None``
    for the rest."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(n) if t is not None else None
                for t, n in zip(inputs, needs)]
        out = fn(*args)
        if isinstance(out, tuple):
            out = out[0]
        wrt = [a for a, n in zip(args, needs) if n]
        got = iter(torch.autograd.grad(out, wrt, grad_out))
    return tuple(next(got) if n else None for n in needs)


class Attention(torch.autograd.Function):
    """``ops.flash_attention`` with a plain backward: (q, k, v, window,
    chunk, forward) -> (B, H, S, D); ``forward`` is the op's own
    device dispatch."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, chunk: int, forward: Callable):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.chunk = window, chunk
        return forward(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        return Attention.grads(ctx, *ctx.saved_tensors, grad_out)

    @staticmethod
    def grads(ctx, q, k, v, grad_out):
        """The backward once the saved inputs are unpacked (under block
        remat, unpacking them recomputes the block)."""
        def plain(q, k, v):
            return ref.attention_chunked(q, k, v, window=ctx.window,
                                         chunk=ctx.chunk)

        grads = _plain_vjp(plain, (q, k, v), ctx.needs_input_grad[:3],
                           grad_out)
        return (*grads, None, None, None)


class Scan(torch.autograd.Function):
    """``ops.ssm_scan`` with a plain backward: (q, k, v, log_decay, bonus,
    initial_state, forward) -> (y, final state); ``forward`` is the op's
    own device dispatch. The state is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, bonus, initial_state,
                forward: Callable):
        ctx.save_for_backward(q, k, v, log_decay, bonus, initial_state)
        y, state = forward(q, k, v, log_decay, bonus, initial_state)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, grad_y, _grad_state):
        return Scan.grads(ctx, *ctx.saved_tensors, grad_y)

    @staticmethod
    def grads(ctx, q, k, v, log_decay, bonus, initial_state, grad_y):
        """The backward once the saved inputs are unpacked."""
        def plain(q, k, v, log_decay, bonus, initial_state):
            return gla.gla_chunked(q, k, v, log_decay, bonus=bonus,
                                   initial_state=initial_state)

        grads = _plain_vjp(plain, (q, k, v, log_decay, bonus, initial_state),
                           ctx.needs_input_grad[:6], grad_y)
        return (*grads, None)
