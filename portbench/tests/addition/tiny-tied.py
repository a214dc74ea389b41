"""Plain reference of the test configuration ``tiny-tied``: a copy of
``refs/internlm2-1.8b.py`` that reads two keys that reference leaves out,
``d_head`` (heads of that width, not d / H; the softmax scaled by
d_head^-0.5) and ``tie_embeddings`` (the head is the embedding table's
transpose). It stands for the reference module a new language-model
configuration brings: the harness reads ``logits``, ``gaps``, ``fp8``,
``prefill_flops``, ``decode_flops`` and ``SMALL`` of it.

``quant`` rounds both operands of every matrix product (the control:
float8 e4m3 with one scale per tensor).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

#: already small enough for the CPU
SMALL: dict = {}


def _head_dim(cfg: dict) -> int:
    return cfg.get("d_head") or cfg["d_model"] // cfg["num_heads"]


def _layer_weights(cfg: dict) -> int:
    """The weights of one block's products: q and o, k and v, the
    SwiGLU."""
    d, hd = cfg["d_model"], _head_dim(cfg)
    return (2 * d * cfg["num_heads"] * hd + 2 * d * cfg["num_kv_heads"] * hd
            + 3 * d * cfg["d_ff"])


def prefill_flops(cfg: dict, batch: int, S: int) -> float:
    """2 a weight a token for every block's products, 4 d_head a causal
    (query, key) pair a head, the head (tied or not, a product with V x d
    weights) on the last position only."""
    L, H = cfg["num_layers"], cfg["num_heads"]
    head = cfg["d_model"] * cfg["vocab_size"]
    return float(batch) * (S * 2 * L * _layer_weights(cfg)
                           + L * 4 * _head_dim(cfg) * H * S * (S + 1) // 2
                           + 2 * head)


def decode_flops(cfg: dict, batch: int, kv_len: int) -> float:
    """One decode step of ``batch`` sequences attending to ``kv_len``
    positions each."""
    L, H = cfg["num_layers"], cfg["num_heads"]
    head = cfg["d_model"] * cfg["vocab_size"]
    return float(batch) * (2 * (L * _layer_weights(cfg) + head)
                           + L * 4 * _head_dim(cfg) * kv_len * H)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    w = w.float()
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(t: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = t.shape[-1] // 2
    inv = theta ** -(torch.arange(half, dtype=torch.float64,
                                  device=t.device) / half)
    ang = (pos.double()[:, None] * inv[None, :]).float()     # (S, half)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    t1, t2 = t[..., :half], t[..., half:]
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1)


def attention_block(p: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
                    quant: Quant, q_block: int = 1024) -> torch.Tensor:
    b, S, d = x.shape
    H, Hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = _head_dim(cfg)
    pos = torch.arange(S, device=x.device)
    h = _rms(x, p["ln1"], cfg["norm_eps"])
    q = _rope(_mm(h, p["wq"], quant).view(b, S, H, hd), pos, cfg["rope_theta"])
    k = _rope(_mm(h, p["wk"], quant).view(b, S, Hkv, hd), pos,
              cfg["rope_theta"])
    v = _mm(h, p["wv"], quant).view(b, S, Hkv, hd)
    rep = H // Hkv
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)      # (b,H,S,hd)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        sc = (q[:, :, s0:s1] @ k[:, :, :s1].transpose(-1, -2)) / math.sqrt(hd)
        qi = torch.arange(s0, s1, device=x.device)[:, None]
        kj = torch.arange(s1, device=x.device)[None, :]
        sc = sc.masked_fill(kj > qi, -math.inf)
        out[:, :, s0:s1] = torch.softmax(sc, dim=-1) @ v[:, :, :s1]
    x = x + _mm(out.transpose(1, 2).reshape(b, S, H * hd), p["wo"], quant)
    h2 = _rms(x, p["ln2"], cfg["norm_eps"])
    m = F.silu(_mm(h2, p["w_gate"], quant)) * _mm(h2, p["w_up"], quant)
    return x + _mm(m, p["w_down"], quant)


def _layer(stack, i: int):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in stack.items()}


def logits(params, cfg: dict, tokens: torch.Tensor, at: torch.Tensor,
           quant: Quant = None) -> torch.Tensor:
    """(b, S) token ids -> (b, len(at), V) f32 logits at positions ``at``
    (the logits that predict the token after each)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            x = params["embed"].float()[tokens.long()]
            blocks = params["blocks"]
            for i in range(blocks["ln1"]["scale"].shape[0]):
                lp = _layer(blocks, i)
                x = attention_block({**lp["attn"], **lp["mlp"],
                                     "ln1": lp["ln1"]["scale"],
                                     "ln2": lp["ln2"]["scale"]},
                                    cfg, x, quant)
            h = _rms(x[:, at], params["final_ln"]["scale"], cfg["norm_eps"])
            head = (params["embed"].T if cfg.get("tie_embeddings")
                    else params["head"])
            return _mm(h, head, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each served token's lies:
    ref (b, T, V), served (b, T) -> (b, T)."""
    pick = ref.gather(-1, served.long()[..., None])[..., 0]
    return ref.amax(dim=-1) - pick
