"""Plain reference of the ``zamba2-7b`` configuration (Zamba2-7B-Instruct,
hf Zyphra/Zamba2-7B-Instruct; the family in arXiv:2411.15242): a stack of
Mamba2 layers with two weight-shared attention blocks called in turn
before the layers at ``hybrid_layer_ids``. Float32 plain PyTorch, every
matrix product with TF32 off, no kernels, no cache, no batching tricks: a
full forward over each whole sequence, whose logits at the served
positions judge the served tokens.

Layer equations (the published config's keys; the weights' names as the
benchmark lays them out, ``params["mamba"|"shared"|"calls"]``):

- Embedding ``e = embed[tokens]``; ``h = e``.
- Before Mamba2 layer i = ``hybrid_layer_ids[j]``, call j of shared block
  j mod ``num_mem_blocks``: ``u = RMSNorm(concat(h, e))`` (2 d wide);
  attention of ``num_attention_heads`` heads of ``attention_head_dim``
  (q, k, v from u, rotate-half rotary over the whole head, base
  ``rope_theta``, causal softmax of q.k (attention_head_dim / 2)^-0.5),
  ``a = wo(attn)`` (d wide); ``g = RMSNorm(a)``; ``[gate, up] = g W_gu +
  (g A_j) B_j`` (the call's LoRA of ``adapter_rank``, gate first), ``m =
  w_down(gelu(gate) * up)`` (exact GELU); ``t = linear_j(m)``. No
  residual inside the block.
- Mamba2 layer i: ``h = h + Mixer(RMSNorm(h + t))`` (t only after a call,
  added to the layer's input and not to its residual). Mixer: ``[z, xBC,
  dt] = in_proj``; ``xBC = silu(causal depthwise conv(xBC) + bias)``
  (width ``mamba_d_conv``); x, B, C split, B and C as ``mamba_ngroups``
  groups of ``mamba_d_state``; ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; per head h of group g = h // (heads / groups): ``S_t =
  exp(dt_t A_h) S_{t-1} + dt_t B_{g,t} x_{h,t}^T``, ``y_{h,t} = C_{g,t}
  S_t + D_h x_{h,t}``; ``y = GroupRMSNorm(y * silu(z))`` over each
  group's d_in / groups channels; ``out_proj(y)``.
- Head: RMSNorm, then ``@ embed^T`` (tied).

The SSD is computed in chunks of ``CHUNK`` tokens, the SSD paper's
minimal dual form (the quadratic form inside a chunk from the segment sums
of the log decay, an f32 state carried between chunks), written from the
equations above; ``portbench/tests/test_portbench_zamba2.py`` holds it to
the step recurrence.

Departures from transformers' ``models/zamba2/modeling_zamba2.py``:

- the per-step log decay dt A is clamped at -``ssm.log_decay_clamp`` (the
  program's clamp as well; the published model has no limit on the step,
  ``time_step_limit`` null);
- dt is not clamped below at ``time_step_min``: the file's plain torch
  path (``torch_forward``) clamps it, its fused path (``mamba_ssm``'s
  kernels, ``time_step_limit`` None) does not; this follows the fused
  path, as the program does;
- B and C are repeated over each group's heads as the file does, but the
  SSD, the gated norm (eps ``rms_norm_eps``, 1e-5 as the file's fixed
  1e-5) and every product run in float32 throughout, where the file rounds
  to the weights' dtype between layers;
- the attention is computed in query blocks of 1,024, and the mask is
  causal over the whole prompt (no padding, no attention mask);
- the head is the embedding table (tied) and gives logits at the asked
  positions only.

``quant`` rounds both operands of every matrix product with a weight (the
control: float8 e4m3 with one scale per tensor).

What the harness reads of a language model's reference module: ``logits``,
``gaps`` and ``fp8`` (the check and its control), ``prefill_flops`` and
``decode_flops`` (the operations the ``*_mfu`` readers count) and
``SMALL`` (the sizes the CPU tests run the configuration at).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

#: the SSD's chunk of tokens
CHUNK = 64

#: configuration keys the CPU tests put over the file: five Mamba2 layers
#: of two groups, calls before layers 1, 2 and 4 (blocks 0, 1, 0), heads
#: of 2 d / H over the 2 d-wide concat; the published keys restated at
#: these sizes
SMALL = {
    "num_layers": 5, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
    "d_head": 32, "d_ff": 128, "vocab_size": 256, "context": 64,
    "hybrid_layer_ids": [1, 2, 4], "num_mem_blocks": 2, "adapter_rank": 8,
    "attn_scale": 0.25,
    "ssm": {"kind": "mamba2", "state_dim": 16, "head_dim": 16, "expand": 2,
            "conv_width": 4, "n_groups": 2, "log_decay_clamp": 4.0},
    "hidden_size": 64, "num_hidden_layers": 5, "num_attention_heads": 4,
    "num_key_value_heads": 4, "num_query_groups": 4,
    "attention_head_dim": 32, "attention_hidden_size": 128,
    "kv_channels": 16, "ffn_hidden_size": 128, "intermediate_size": 128,
    "layers_block_type": ["mamba", "hybrid", "hybrid", "mamba", "hybrid"],
    "mamba_d_state": 16, "mamba_headdim": 16, "n_mamba_heads": 8,
    "max_position_embeddings": 64,
}


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------
def _mamba_weights(cfg: dict) -> int:
    """Weights of a Mamba2 layer's products: in_proj and out_proj."""
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    H = d_in // cfg["mamba_headdim"]
    return d * (2 * d_in + 2 * G * N + H) + d_in * d


def _call_weights(cfg: dict) -> int:
    """Weights of one shared-block call's products: q, k, v from the 2 d
    concat, o, the gated MLP, the call's LoRA and its linear."""
    d, f = cfg["hidden_size"], cfg["ffn_hidden_size"]
    hd = cfg["attention_head_dim"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = 2 * d * hd * (H + 2 * Hkv) + H * hd * d
    return attn + 3 * d * f + cfg["adapter_rank"] * (d + 2 * f) + d * d


def _ssd_flops(cfg: dict) -> int:
    """The SSD recurrence a token in a layer: 5 N P a head."""
    d_in = cfg["mamba_expand"] * cfg["hidden_size"]
    P = cfg["mamba_headdim"]
    return 5 * (d_in // P) * cfg["mamba_d_state"] * P


def _per_token(cfg: dict) -> float:
    """A token's operations outside the attention's pairs and the head:
    2 a weight of every product, each shared block counted at each call."""
    L, n = cfg["num_hidden_layers"], len(cfg["hybrid_layer_ids"])
    return (2 * (L * _mamba_weights(cfg) + n * _call_weights(cfg))
            + L * _ssd_flops(cfg))


def decode_flops(cfg: dict, batch: int, kv_len: int) -> float:
    """One decode step of ``batch`` sequences, each call's attention over
    ``kv_len`` positions (its own included); the tied head's product."""
    n = len(cfg["hybrid_layer_ids"])
    attn = 4 * cfg["attention_head_dim"] * cfg["num_attention_heads"]
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return float(batch) * (_per_token(cfg) + n * attn * kv_len + head)


def prefill_flops(cfg: dict, batch: int, S: int) -> float:
    """A prefill of ``batch`` prompts of ``S``: every layer and call on every
    position, causal attention, the head on the last position only."""
    n = len(cfg["hybrid_layer_ids"])
    attn = 4 * cfg["attention_head_dim"] * cfg["num_attention_heads"]
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return float(batch) * (S * _per_token(cfg) + n * attn * S * (S + 1) // 2
                           + head)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------
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


def _at(tree, i: int):
    return {k: (_at(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def shared_call(blk: dict, call: dict, cfg: dict, h: torch.Tensor,
                e: torch.Tensor, quant: Quant,
                q_block: int = 1024) -> torch.Tensor:
    """One call of a shared block on the stream ``h`` and embeddings ``e``
    (b, S, d) -> the call's output t (b, S, d)."""
    b, S, d = h.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["attention_head_dim"]
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(S, device=h.device)
    u = _rms(torch.cat([h, e], dim=-1), blk["ln1"]["scale"], eps)
    a = blk["attn"]
    q = _rope(_mm(u, a["wq"], quant).view(b, S, H, hd), pos,
              cfg["rope_theta"]).transpose(1, 2)
    k = _rope(_mm(u, a["wk"], quant).view(b, S, Hkv, hd), pos,
              cfg["rope_theta"])
    v = _mm(u, a["wv"], quant).view(b, S, Hkv, hd)
    k = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)    # (b,H,S,hd)
    v = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    scale = (hd / 2) ** -0.5
    out = torch.empty_like(q)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        sc = (q[:, :, s0:s1] @ k[:, :, :s1].transpose(-1, -2)) * scale
        qi = torch.arange(s0, s1, device=h.device)[:, None]
        kj = torch.arange(s1, device=h.device)[None, :]
        sc = sc.masked_fill(kj > qi, -math.inf)
        out[:, :, s0:s1] = torch.softmax(sc, dim=-1) @ v[:, :, :s1]
    att = _mm(out.transpose(1, 2).reshape(b, S, H * hd), a["wo"], quant)
    g = _rms(att, blk["ln2"]["scale"], eps)
    m = blk["mlp"]
    f = cfg["ffn_hidden_size"]
    lora = _mm(_mm(g, call["lora_a"], quant), call["lora_b"], quant)
    gate = _mm(g, m["w_gate"], quant) + lora[..., :f]
    up = _mm(g, m["w_up"], quant) + lora[..., f:]
    y = _mm(F.gelu(gate) * up, m["w_down"], quant)
    return _mm(y, call["linear"], quant)


def _ssd(x: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor,
         Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """y_t = C_t S_t, S_t = a_t S_{t-1} + dt_t B_t x_t^T, in chunks of
    ``CHUNK``: x (b, S, H, P), dt and log_a (b, S, H), B and C (b, S, H, N)
    (each head's group's) -> y (b, S, H, P), all f32."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = CHUNK
    pad = (-S) % Q
    if pad:      # zero steps: no input, no decay, no read-out kept
        x, dt, log_a, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                                for t in (x, dt, log_a, Bm, Cm))
    nc = (S + pad) // Q
    xs = (x * dt[..., None]).view(b, nc, Q, H, P)
    la = log_a.view(b, nc, Q, H)
    Bc, Cc = Bm.view(b, nc, Q, H, N), Cm.view(b, nc, Q, H, N)
    cum = torch.cumsum(la, dim=2)                          # (b, nc, Q, H)
    # inside a chunk: exp(cum_i - cum_j) for j <= i
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,i,j,H)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      -math.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * decay
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xs)
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (b, nc, Q, H)
    chunk_state = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Bc, to_end, xs)
    state = torch.zeros(b, H, N, P, dtype=torch.float32, device=x.device)
    for c in range(nc):
        # read-out of the state entering chunk c, decayed to each position
        y[:, c] += torch.einsum("bihn,bih,bhnp->bihp", Cc[:, c],
                                torch.exp(cum[:, c]), state)
        state = (torch.exp(cum[:, c, -1])[..., None, None] * state
                 + chunk_state[:, c])
    return y.reshape(b, nc * Q, H, P)[:, :S]


def mamba_layer(lp: dict, cfg: dict, h: torch.Tensor, t: Optional[torch.Tensor],
                quant: Quant) -> torch.Tensor:
    """Mamba2 layer: ``h + Mixer(RMSNorm(h + t))``."""
    b, S, d = h.shape
    d_in = cfg["mamba_expand"] * d
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    P = cfg["mamba_headdim"]
    H = d_in // P
    W = cfg["mamba_d_conv"]
    eps = cfg["rms_norm_eps"]
    mx = lp["mixer"]
    xn = _rms(h if t is None else h + t, lp["ln"]["scale"], eps)
    proj = _mm(xn, mx["in_proj"], quant)
    z = proj[..., :d_in]
    xBC = proj[..., d_in:2 * d_in + 2 * G * N]
    dt = proj[..., 2 * d_in + 2 * G * N:]
    w, bias = mx["conv_w"].float(), mx["conv_b"].float()     # (W, C), (C,)
    xp = F.pad(xBC, (0, 0, W - 1, 0))
    xBC = F.silu(sum(xp[:, i:i + S] * w[i] for i in range(W)) + bias)
    x = xBC[..., :d_in].reshape(b, S, H, P)
    per = H // G                                    # heads of a group
    Bm = xBC[..., d_in:d_in + G * N].reshape(b, S, G, N)
    Cm = xBC[..., d_in + G * N:].reshape(b, S, G, N)
    Bm = Bm.repeat_interleave(per, dim=2)           # (b, S, H, N)
    Cm = Cm.repeat_interleave(per, dim=2)
    dt = F.softplus(dt + mx["dt_bias"].float())     # (b, S, H)
    A = -torch.exp(mx["A_log"].float())
    log_a = (dt * A).clamp(-cfg["ssm"]["log_decay_clamp"], 0.0)
    y = _ssd(x, dt, log_a, Bm, Cm) + mx["D"].float()[:, None] * x
    y = y.reshape(b, S, d_in) * F.silu(z)
    yg = y.view(b, S, G, d_in // G)
    scale = mx["norm"]["scale"].view(G, d_in // G)
    y = _rms(yg, scale, eps).reshape(b, S, d_in)
    return h + _mm(y, mx["out_proj"], quant)


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
            e = params["embed"].float()[tokens.long()]
            h = e
            call_at = {i: j for j, i in enumerate(cfg["hybrid_layer_ids"])}
            nb = cfg["num_mem_blocks"]
            for i in range(cfg["num_hidden_layers"]):
                t = None
                if i in call_at:
                    j = call_at[i]
                    t = shared_call(_at(params["shared"], j % nb),
                                    _at(params["calls"], j), cfg, h, e,
                                    quant)
                h = mamba_layer(_at(params["mamba"], i), cfg, h, t, quant)
            x = _rms(h[:, at], params["final_ln"]["scale"],
                     cfg["rms_norm_eps"])
            return _mm(x, params["embed"].T, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each served token's lies:
    ref (b, T, V), served (b, T) -> (b, T)."""
    pick = ref.gather(-1, served.long()[..., None])[..., 0]
    return ref.amax(dim=-1) - pick
