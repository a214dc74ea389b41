"""Architecture configuration system (copied from ``repro.configs.base``;
``dtype`` is a ``torch.dtype``).

Every assigned architecture is an ``ArchConfig`` instance. The config fully
determines the model pytree, the block wiring (dense / MoE / SSM / hybrid),
the sharding rules chosen by ``launch.sharding`` and the train/serve step
builders in ``train.steps``.

Shapes follow the assignment sheet verbatim; reduced "smoke" variants are
derived mechanically via :meth:`ArchConfig.smoke` so that every family is
exercised on CPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts sub-config (Switch/Mesh-TF style capacity dispatch)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    num_shared_experts: int = 0        # always-on shared expert(s) (kimi-k2 style)
    router_jitter: float = 0.0
    aux_loss_weight: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-attention sub-config (Mamba2 SSD or RWKV6)."""

    kind: str                          # 'mamba2' | 'rwkv6'
    state_dim: int = 64                # N: SSM state per head
    head_dim: int = 64                 # P: channels per head
    conv_width: int = 4                # depthwise conv (mamba2)
    expand: int = 2                    # d_inner = expand * d_model (mamba2)
    dt_rank: int = 0                   # 0 -> heads (mamba2 uses per-head dt)
    decay_lora: int = 64               # rank of data-dependent decay (rwkv6)


@dataclass(frozen=True)
class ArchConfig:
    # -- identity ------------------------------------------------------------
    name: str
    family: str                        # dense|moe|ssm|hybrid|audio|vlm
    source: str = ""                   # provenance note "[arXiv:...; tier]"

    # -- trunk ---------------------------------------------------------------
    num_layers: int = 12
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    d_head: int = 0                    # 0 -> d_model // num_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # -- attention options ---------------------------------------------------
    qk_norm: bool = False              # qwen3: RMSNorm on q/k heads
    gated_mlp: bool = True             # False -> GPT-style 2-matrix MLP
    attn_chunk: int = 512              # online-softmax tile (perf knob)
    rope_theta: float = 1e4
    mrope: bool = False                # qwen2-vl 3-axis M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: int = 0            # 0 -> full attention (h2o-danube SWA)

    # -- block wiring ---------------------------------------------------------
    # Repeating pattern of block kinds over depth. 'attn' = attention+MLP
    # block, 'moe' = attention+MoE block, 'mamba' = Mamba2 block,
    # 'rwkv' = RWKV6 block, 'shared_attn' = zamba2 shared-weight attn block.
    block_pattern: Tuple[str, ...] = ("attn",)
    first_k_dense: int = 0             # kimi-k2: leading dense layers before MoE

    # -- sub-configs ----------------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # -- modality stub ---------------------------------------------------------
    # audio/vlm: number of prefix positions whose embeddings are supplied by a
    # (stubbed) frontend instead of the token table. 0 disables.
    frontend_prefix: int = 0

    # -- numerics / training --------------------------------------------------
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"           # 'adamw' | 'adafactor'
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: str = "block"               # 'none' | 'block' | 'full'
    accum_steps: int = 1               # gradient-accumulation microbatches
    seq_shard: bool = False            # Megatron-style sequence sharding of the
                                       # residual stream over the model axis
    z_loss: float = 1e-4

    # ------------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        """``param_dtype`` as a torch dtype ("bfloat16" -> torch.bfloat16)."""
        return getattr(torch, self.param_dtype)

    @property
    def attention_free(self) -> bool:
        return all(k in ("mamba", "rwkv") for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if a 500k-token decode state does not require O(S) KV per head.

        SSM archs keep O(1) state; hybrids keep O(1) + a small shared-attn KV;
        SWA archs keep an O(window) ring. Pure full-attention archs are not
        sub-quadratic and skip the long_500k shape (see DESIGN.md §4).
        """
        if self.attention_free:
            return True
        if self.ssm is not None:       # hybrid: attention is periodic/shared
            return True
        return self.sliding_window > 0

    def pattern_for_depth(self) -> Tuple[str, ...]:
        """Full per-layer kind list of length num_layers."""
        kinds = []
        i = 0
        while len(kinds) < self.num_layers:
            kind = self.block_pattern[i % len(self.block_pattern)]
            if len(kinds) < self.first_k_dense and kind == "moe":
                kind = "attn"
            kinds.append(kind)
            i += 1
        return tuple(kinds[: self.num_layers])

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                   # embedding
        if not self.tie_embeddings:
            total += v * d                              # lm head
        hd = self.head_dim
        for kind in self.pattern_for_depth():
            if kind in ("attn", "moe", "shared_attn"):
                attn = d * (self.num_heads * hd) * 2          # q, o
                attn += d * (self.num_kv_heads * hd) * 2      # k, v
                total += attn + 2 * d                          # + 2 norms
                if kind == "moe" and self.moe is not None:
                    m = self.moe
                    total += m.num_experts * 3 * d * m.d_ff_expert
                    total += d * m.num_experts                 # router
                    total += m.num_shared_experts * 3 * d * m.d_ff_expert
                else:
                    total += 3 * d * self.d_ff                 # swiglu
            elif kind == "mamba":
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                total += d * (2 * d_in + 2 * s.state_dim + nheads)   # in_proj
                total += s.conv_width * (d_in + 2 * s.state_dim)     # conv
                total += d_in * d + 2 * nheads + d                   # out, A, D, norm
            elif kind == "rwkv":
                total += 4 * d * d + 2 * d * s_lora(self.ssm)        # time-mix
                total += d * self.d_ff + self.d_ff * d + d           # channel-mix
                total += 2 * d                                       # norms
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_expert_cost = m.num_experts * 3 * self.d_model * m.d_ff_expert
        active_expert_cost = (m.top_k + m.num_shared_experts) * 3 * self.d_model * m.d_ff_expert
        n_moe = sum(1 for k in self.pattern_for_depth() if k == "moe")
        return self.param_count() - n_moe * (dense_expert_cost +
                                             m.num_shared_experts * 3 * self.d_model * m.d_ff_expert
                                             - active_expert_cost)

    # ------------------------------------------------------------------------
    def smoke(self) -> "ArchConfig":
        """Mechanically reduced config of the same family for CPU tests."""
        changes = dict(
            num_layers=min(self.num_layers, 2 * len(self.block_pattern)),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_head=32,
            d_ff=256,
            vocab_size=512,
            accum_steps=1,
            remat="none",
            seq_shard=False,
            frontend_prefix=min(self.frontend_prefix, 4),
            first_k_dense=min(self.first_k_dense, 1),
        )
        if self.moe is not None:
            # generous capacity so smoke tests are drop-free (deterministic
            # prefill/decode equivalence); full configs keep the real factor
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, d_ff_expert=64,
                capacity_factor=4.0)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=32, decay_lora=8)
        if self.mrope:
            changes["mrope_sections"] = (4, 6, 6)     # sums to smoke d_head/2
        return dataclasses.replace(self, **changes)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def s_lora(ssm: Optional[SSMConfig]) -> int:
    return ssm.decay_lora if ssm is not None else 0


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (seq_len, global_batch, mode).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells that are well-defined for this architecture."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return tuple(out)
