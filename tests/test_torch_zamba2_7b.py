"""zamba2-7b (Zamba2-7B-Instruct) on the port's serving path, on the CPU at
the sizes its plain reference module states (``portbench/refs/zamba2-7b.py``
``SMALL``: five Mamba2 layers of two groups, calls before layers 1, 2 and 4
over both shared blocks), in float32 on the benchmark's seeded weights.

The port's prefill logits, and its greedy decode through the cache after
the prefill, are held to the reference's full forward over the same tokens
within 1e-5 of the logits' scale (measured: 2.4e-6 and 4.1e-6; the two
compute the SSD in chunks of 32 and 64 and the attention in one pass and in
query blocks, so they differ by f32 rounding only). Each of the wiring's pieces
matters at that tolerance: the reference with the piece dropped (one block
for every call, one LoRA or one linear for every call, the call's output
added to the residual as well, one group's B and C for both) lands far
outside it. With one group the Mamba2 layer is bit for bit the layer it
was before groups (``_layer_before_groups``), and with two the scan runs
once a group on stride-0 views of that group's B and C. Also here: the
published wiring's 13 calls in turn over the two blocks with their own
weights, the new spans, the parameter count, and the B4 launches once a
group (on the CPU, and on the card at the cell's shape, ``card``)."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from portbench.lib import calls  # noqa: E402
from portbench.lib import harness as H  # noqa: E402
from portbench.lib import lm as lmlib  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import blocks, mamba2  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
R = H.load_module("refs", "zamba2-7b")
TOL = 1e-5
SEEDS = [5, 2 ** 31 + 3]


def small_cfg(dtype: str = "float32", **over) -> dict:
    cfg = json.loads((ROOT / "portbench/configs/zamba2-7b.json").read_text())
    cfg.update(R.SMALL, param_dtype=dtype, **over)
    return cfg


def _tokens(seed: int, B: int, S: int, V: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).integers(0, V, (B, S)),
                           dtype=torch.int32)


def _served(cfg: dict, params, toks: torch.Tensor, steps: int):
    """The port's prefill then ``steps`` greedy decode steps: (logits (B,
    steps + 1, V), the sequence the reference reads)."""
    arch = lmlib.arch_config(cfg)
    S = toks.shape[1]
    logits, cache = make_prefill_step(arch, cache_len=S + steps)(
        params, {"tokens": toks})
    got, seq = [logits], toks
    decode = make_decode_step(arch)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for _ in range(steps):
        seq = torch.cat([seq, tok], dim=1)
        tok, logits, cache = decode(params, tok, cache)
        got.append(logits)
    return torch.stack(got, dim=1), seq


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed, S", [(SEEDS[0], 40), (SEEDS[1], 150)])
def test_prefill_and_decode_equal_the_reference(seed, S):
    """Prefill, then decode through the cache (the rings of three calls and
    five layers' conv and SSD states) against the reference's forward; S =
    150 spans three of the reference's SSD chunks and five of the port's."""
    cfg = small_cfg()
    params = lmlib.make_params(cfg, seed, "cpu")
    toks = _tokens(seed, 2, S, cfg["vocab_size"])
    got, seq = _served(cfg, params, toks, 6)
    want = R.logits(params, cfg, seq, torch.arange(S - 1, S + 6))
    assert _err(got[:, 0], want[:, 0]) <= TOL
    assert _err(got, want) <= TOL


def _drop(piece: str, params, cfg, monkeypatch):
    """The parameters (and the reference) of the model with ``piece``
    dropped."""
    p = {k: v for k, v in params.items()}
    if piece == "alternation":            # block 0 at every call
        p["shared"] = {k: (v[:1].expand_as(v) if not isinstance(v, dict)
                           else {kk: vv[:1].expand_as(vv)
                                 for kk, vv in v.items()})
                       for k, v in params["shared"].items()}
    elif piece == "per_call_lora":        # call 0's LoRA at every call
        p["calls"] = {k: (v[:1].expand_as(v) if k.startswith("lora") else v)
                      for k, v in params["calls"].items()}
    elif piece == "per_call_linear":      # call 0's linear at every call
        p["calls"] = {k: (v[:1].expand_as(v) if k == "linear" else v)
                      for k, v in params["calls"].items()}
    elif piece == "linear_into_input_only":   # t reaches the residual too
        layer = R.mamba_layer

        def also_residual(lp, cfg, h, t, quant):
            out = layer(lp, cfg, h, t, quant)
            return out if t is None else out + t

        monkeypatch.setattr(R, "mamba_layer", also_residual)
    else:                                 # group 0's B and C for group 1
        s = cfg["ssm"]
        d_in = s["expand"] * cfg["d_model"]
        N = s["state_dim"]
        mixer = dict(params["mamba"]["mixer"])
        w, cw, cb = (mixer[k].clone() for k in ("in_proj", "conv_w",
                                                "conv_b"))
        for off in (0, 2 * N):            # B's groups, then C's
            g0 = slice(d_in + off, d_in + off + N)
            g1 = slice(d_in + off + N, d_in + off + 2 * N)
            w[..., d_in:][..., g1] = w[..., d_in:][..., g0]
            cw[..., g1], cb[..., g1] = cw[..., g0], cb[..., g0]
        mixer.update(in_proj=w, conv_w=cw, conv_b=cb)
        p["mamba"] = {**params["mamba"], "mixer": mixer}
    return p


@pytest.mark.parametrize("piece", ["alternation", "per_call_lora",
                                   "per_call_linear",
                                   "linear_into_input_only", "two_groups"])
def test_dropping_a_piece_misses_the_tolerance(piece, monkeypatch):
    """The port agrees with the full reference and lies far outside the
    tolerance of the reference without ``piece``: a port that dropped it
    would fail the agreement above."""
    cfg = small_cfg()
    params = lmlib.make_params(cfg, SEEDS[0], "cpu")
    toks = _tokens(1, 2, 40, cfg["vocab_size"])
    got, seq = _served(cfg, params, toks, 2)
    at = torch.arange(39, 42)
    assert _err(got, R.logits(params, cfg, seq, at)) <= TOL
    dropped = _drop(piece, params, cfg, monkeypatch)
    assert _err(got, R.logits(dropped, cfg, seq, at)) > 1e3 * TOL


def test_the_new_spans_are_recorded():
    """Spans of a prefill and a decode step: each call under ``lm.block``
    ("shared", j) with ``shared.attention``, ``shared.mlp`` and
    ``shared.linear`` inside, before its Mamba2 layer's ``lm.block``
    ("mamba", i); in the prefill each layer's two group scans under
    ``mamba2.scan``, keyed by the group, and its gated norm of both groups
    under ``mamba2.gated_norm``."""
    cfg = small_cfg()
    arch = lmlib.arch_config(cfg)
    params = lmlib.make_params(cfg, 3, "cpu")
    toks = _tokens(3, 2, 24, cfg["vocab_size"])
    spans.enable()
    try:
        logits, cache = make_prefill_step(arch, cache_len=32)(
            params, {"tokens": toks})
        make_decode_step(arch)(params, logits.argmax(-1)[:, None].to(
            torch.int32), cache)
    finally:
        spans.disable()
    got, _ = spans.drain()
    for top in ("lm.forward", "lm.decode_step"):
        (i0,) = [i for i, s in enumerate(got) if s.name == top]

        def under(i):
            while i >= 0:
                if i == i0:
                    return True
                i = got[i].parent
            return False

        mine = [(i, s) for i, s in enumerate(got) if under(s.parent)]
        blocks_ = [s.key for _, s in mine if s.name == "lm.block"]
        assert blocks_ == [("mamba", 0), ("shared", 0), ("mamba", 1),
                           ("shared", 1), ("mamba", 2), ("mamba", 3),
                           ("shared", 2), ("mamba", 4)]
        inner = [(s.name, got[s.parent].key) for _, s in mine
                 if s.name.startswith("shared.")]
        assert inner == [(n, ("shared", j)) for j in range(3)
                         for n in ("shared.attention", "shared.mlp",
                                   "shared.linear")]
        for name, per_layer in (("mamba2.scan", (0, 1)),
                                ("mamba2.gated_norm", (None,))):
            keys = [(s.key, got[s.parent].key) for _, s in mine
                    if s.name == name]
            assert keys == ([(g, ("mamba", i)) for i in range(5)
                             for g in per_layer]
                            if top == "lm.forward" else [])


def test_the_published_calls_alternate_with_their_own_weights(monkeypatch):
    """At the published wiring (81 Mamba2 layers, calls before layers 6,
    11, 17, ..., 77, two shared blocks) on tiny widths: the 13 calls run
    before their layers, call j on block j mod 2 with its own LoRA and
    linear (call j's rows of the stacks, by storage)."""
    from repro_torch.models import lm
    pub = json.loads((ROOT / "portbench/configs/zamba2-7b.json")
                     .read_text())
    ids = pub["hybrid_layer_ids"]
    cfg = small_cfg(num_layers=81, num_hidden_layers=81,
                    hybrid_layer_ids=ids,
                    layers_block_type=pub["layers_block_type"])
    arch = lmlib.arch_config(cfg)
    params = lmlib.make_params(cfg, 8, "cpu")
    seen = []
    shared_block = blocks.shared_block

    def spy(blk, call, *a, **kw):
        seen.append((blk["attn"]["wq"].data_ptr(),
                     call["lora_a"].data_ptr(), call["linear"].data_ptr()))
        return shared_block(blk, call, *a, **kw)

    monkeypatch.setattr(blocks, "shared_block", spy)
    spans.enable()
    try:
        make_prefill_step(arch, cache_len=8)(
            params, {"tokens": _tokens(8, 1, 8, cfg["vocab_size"])})
    finally:
        spans.disable()
    got, _ = spans.drain()
    order = [s.key for s in got if s.name == "lm.block"]
    assert [order[order.index(("shared", j)) + 1]
            for j in range(len(ids))] == [("mamba", i) for i in ids]
    wq, calls_ = params["shared"]["attn"]["wq"], params["calls"]
    assert seen == [(wq[j % 2].data_ptr(), calls_["lora_a"][j].data_ptr(),
                     calls_["linear"][j].data_ptr())
                    for j in range(len(ids))]
    assert len(ids) == 13 and len({p for p, _, _ in seen}) == 2


def test_each_group_scans_once_on_stride0_views():
    """The prefill's B4 calls, recorded as the benchmark records them: two
    a layer, each over one group's H / G heads, its q and k (C and B) with
    B S N distinct elements: nothing built per head."""
    cfg = small_cfg()
    arch = lmlib.arch_config(cfg)
    params = lmlib.make_params(cfg, 4, "cpu")
    B, S = 2, 24
    toks = _tokens(4, B, S, cfg["vocab_size"])
    with calls.recorded() as got:
        make_prefill_step(arch, cache_len=S)(params, {"tokens": toks})
    d_in, H, N, _ = mamba2.dims(arch)
    G = arch.ssm.n_groups
    rec = got["ssm_scan"]
    assert len(rec) == cfg["num_layers"] * G
    for Bq, Hq, Sq, Dk, Dv, ins, bonus, state in rec:
        assert (Bq, Hq, Sq, Dk, Dv) == (B, H // G, S, N, arch.ssm.head_dim)
        assert ins[0][0] == ins[1][0] == B * S * N       # q, k: stride 0
        assert ins[2][0] == B * (H // G) * S * Dv        # v: the group's
        assert ins[3][0] == B * (H // G) * S             # decay: stride 0
        assert not bonus and not state
    assert len(got["attention"]) == len(cfg["hybrid_layer_ids"])
    assert {r[4] for r in got["attention"]} == {arch.head_dim}


def _layer_before_groups(p, cfg, x):
    """``mamba2.mamba2_forward`` as it was before groups (one group, no
    context): what the one-group path must still compute bit for bit."""
    B, S, _ = x.shape
    d_in, H, N, _ = mamba2.dims(cfg)
    Wc = cfg.ssm.conv_width
    proj = x @ p["in_proj"]
    z = proj[..., :d_in]
    xBC_raw = proj[..., d_in: 2 * d_in + 2 * N]
    dt_raw = proj[..., 2 * d_in + 2 * N:]
    xBC = mamba2._causal_depthwise_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC)
    xs, Bm, Cm = xBC[..., :d_in], xBC[..., d_in:d_in + N], xBC[..., d_in + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    xh = xs.reshape(B, S, H, cfg.ssm.head_dim)
    v = xh * dt[..., None].to(xh.dtype)
    logw = dt * -torch.exp(p["A_log"])
    y, state = ops.ssm_scan(Cm[:, None].expand(B, H, S, N),
                            Bm[:, None].expand(B, H, S, N),
                            v.permute(0, 2, 1, 3),
                            logw.permute(0, 2, 1)[..., None].expand(
                                B, H, S, N))
    y = y + p["D"][None, :, None, None] * xh.permute(0, 2, 1, 3)
    y = y.permute(0, 2, 1, 3).reshape(B, S, d_in).to(x.dtype)
    y = blocks.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps) @ p["out_proj"]
    return y, xBC_raw[:, -(Wc - 1):, :], state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_group_is_the_layer_it_was(dtype):
    from repro_torch.configs import get_config
    cfg = get_config("zamba2_2p7b").smoke().replace(param_dtype=dtype)
    assert cfg.ssm.n_groups == 1
    gen = torch.Generator().manual_seed(9)
    p = mamba2.mamba2_init(gen, cfg)
    x = torch.randn(2, 40, cfg.d_model, generator=gen).to(cfg.dtype)
    y, (conv, state) = mamba2.mamba2_forward(p, cfg, x)
    y0, conv0, state0 = _layer_before_groups(p, cfg, x)
    assert torch.equal(y, y0) and torch.equal(conv, conv0)
    assert torch.equal(state, state0.float())


def test_two_groups_decode_continues_the_prefill():
    """One Mamba2 layer of two groups: a prefill of 30 tokens then 5 decode
    steps equal the prefill of all 35 (f32)."""
    cfg = lmlib.arch_config(small_cfg())
    gen = torch.Generator().manual_seed(2)
    p = mamba2.mamba2_init(gen, cfg)
    x = torch.randn(2, 35, cfg.d_model, generator=gen)
    whole, _ = mamba2.mamba2_forward(p, cfg, x)
    y, cache = mamba2.mamba2_forward(p, cfg, x[:, :30])
    outs = [y]
    for t in range(30, 35):
        yt, cache = mamba2.mamba2_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(yt)
    got = torch.cat(outs, dim=1)
    assert _err(got, whole) <= TOL


@pytest.mark.parametrize("small", [False, True])
def test_the_published_keys_restate_the_port_fields(small):
    """The configuration file's published config.json keys, which the
    plain reference computes from, and the port's fields, which the port
    computes from, state one model (at the cell's size and at ``SMALL``)."""
    cfg = small_cfg() if small else json.loads(
        (ROOT / "portbench/configs/zamba2-7b.json").read_text())
    a = lmlib.arch_config(cfg)
    s = a.ssm
    heads = s.expand * a.d_model // s.head_dim
    assert (cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["num_query_groups"], cfg["attention_head_dim"],
            cfg["attention_hidden_size"], cfg["kv_channels"],
            cfg["ffn_hidden_size"], cfg["intermediate_size"],
            cfg["rms_norm_eps"]) == (
        a.d_model, a.num_layers, a.num_heads, a.num_kv_heads,
        a.num_kv_heads, a.head_dim, 2 * a.d_model, a.d_model // a.num_heads,
        a.d_ff, a.d_ff, a.norm_eps)
    assert (cfg["mamba_d_state"], cfg["mamba_headdim"], cfg["mamba_expand"],
            cfg["mamba_d_conv"], cfg["mamba_ngroups"],
            cfg["n_mamba_heads"]) == (s.state_dim, s.head_dim, s.expand,
                                      s.conv_width, s.n_groups, heads)
    assert cfg["layers_block_type"] == [
        "hybrid" if i in a.hybrid_layer_ids else "mamba"
        for i in range(a.num_layers)]
    assert cfg["use_shared_mlp_adapter"] == (a.adapter_rank > 0)
    if not small:
        assert a.attn_scale == pytest.approx(
            (cfg["attention_head_dim"] / 2) ** -0.5, rel=1e-15)


@pytest.mark.parametrize("over", [
    {"hybrid_layer_ids": [2, 1, 4]}, {"hybrid_layer_ids": [1, 1, 4]},
    {"hybrid_layer_ids": [1, 2, 5]}, {"num_mem_blocks": 0},
    {"adapter_rank": 0}, {"block_pattern": ["mamba", "attn"]}])
def test_a_malformed_wiring_is_refused(over):
    from repro_torch.models import lm
    with pytest.raises(ValueError, match="hybrid_layer_ids"):
        lm.init_params(lmlib.arch_config(small_cfg(**over)), device="meta")


def test_param_count_is_the_published_size():
    """``ArchConfig.param_count`` of the published configuration counts
    every leaf of ``lm.init_params`` on the meta device once (each shared
    block once, each call's LoRA and linear once): 7.357e9, the published
    model's ~7.4 B."""
    from repro_torch.models import lm
    cfg = json.loads((ROOT / "portbench/configs/zamba2-7b.json").read_text())
    arch = lmlib.arch_config(cfg)
    meta = lm.init_params(arch, device="meta")

    def n(tree):
        return sum(n(v) if isinstance(v, dict) else v.numel()
                   for v in tree.values())

    assert arch.param_count() == n(meta) == 7_356_749_648
    assert n(meta["shared"]) == 2 * 333_982_208
    assert n(meta["calls"]) == 13 * 16_973_824


def test_prefill_in_passes_equals_one_pass(monkeypatch):
    """Passes of whole sequences (``lm.PREFILL_TOKENS``; here 2, 2 and 1
    sequences) give the one-pass prefill's logits, rings and states."""
    from repro_torch.models import lm
    cfg = small_cfg()
    arch = lmlib.arch_config(cfg)
    params = lmlib.make_params(cfg, 6, "cpu")
    toks = _tokens(6, 5, 40, cfg["vocab_size"])
    one, c1 = make_prefill_step(arch, cache_len=48)(params, {"tokens": toks})
    monkeypatch.setattr(lm, "PREFILL_TOKENS", 80)
    with calls.recorded() as got:
        parts, c2 = make_prefill_step(arch, cache_len=48)(
            params, {"tokens": toks})
    assert [r[0] for r in got["attention"]] == [2] * 6 + [1] * 3
    assert torch.equal(one, parts)
    for a, b in zip(c1["shared"].values(), c2["shared"].values()):
        assert torch.equal(a, b)
    for a, b in zip(c1["mamba"], c2["mamba"]):
        assert torch.equal(a, b)


def test_scan_groups_launches_once_a_group():
    """``mamba2.scan_groups`` on the CPU: one ``ops.ssm_scan`` a group over
    its H / G heads, that group's C and B broadcast over them, equal to
    ``gla_chunked`` on B and C built for every head."""
    from repro_torch.models import gla
    g = torch.Generator().manual_seed(7)
    Bsz, S, H, G, N, P = 2, 70, 8, 2, 16, 16
    q, k = (torch.randn(Bsz, S, G * N, generator=g) for _ in range(2))
    v = torch.randn(Bsz, S, H, P, generator=g)
    lw = -1.5 * torch.rand(Bsz, S, H, generator=g)
    with calls.recorded() as rec:
        got = list(mamba2.scan_groups(q, k, v, lw, G))
    assert [r[:5] for r in rec["ssm_scan"]] == [(Bsz, H // G, S, N, P)] * G
    per = H // G
    qh, kh = (t.view(Bsz, S, G, N).repeat_interleave(per, 2).permute(
        0, 2, 1, 3) for t in (q, k))
    y, st = gla.gla_chunked(qh, kh, v.permute(0, 2, 1, 3),
                            lw.permute(0, 2, 1)[..., None].expand(
                                Bsz, H, S, N).contiguous())
    assert torch.allclose(torch.cat([a for a, _ in got], 1), y, atol=1e-5)
    assert torch.allclose(torch.cat([b for _, b in got], 1), st, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("B4 is a CUDA kernel: this runs on an NVIDIA card only")
    from repro_torch.kernels import build
    build.build_all(["ssm_scan"])
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.card
def test_card_b4_two_groups_at_the_cell_shape(card):
    """B4 once a group at zamba2-7b's prefill shape (16, 112 heads, 4,080,
    N 64, P 64; two groups of 56) in bf16, as the layer sends it, against
    ``gla_chunked`` in f32 on B and C built for every head: within
    ``chip_smoke``'s scan tolerance (2e-4, plus 1e-6 of the peak)."""
    from repro_torch.models import gla
    g = torch.Generator(device=card).manual_seed(112)
    Bsz, S, H, G, N, P = 16, 4080, 112, 2, 64, 64
    q, k = (torch.randn(Bsz, S, G * N, device=card, generator=g).to(
        torch.bfloat16) for _ in range(2))
    v = torch.randn(Bsz, S, H, P, device=card, generator=g).to(torch.bfloat16)
    lw = -1.5 * torch.rand(Bsz, S, H, device=card, generator=g)
    got = list(mamba2.scan_groups(q, k, v, lw, G))
    per = H // G
    for gi, (y, st) in enumerate(got):
        hs, ns = slice(gi * per, (gi + 1) * per), slice(gi * N, (gi + 1) * N)
        want, wst = gla.gla_chunked(
            q[..., ns].float()[:, None].expand(Bsz, per, S, N),
            k[..., ns].float()[:, None].expand(Bsz, per, S, N),
            v[:, :, hs].float().permute(0, 2, 1, 3),
            lw[:, :, hs].permute(0, 2, 1)[..., None].expand(Bsz, per, S, N))
        for a, b in ((y, want), (st, wst)):
            tol = 2e-4 + 1e-6 * float(b.abs().max())
            assert torch.allclose(a, b, rtol=2e-4, atol=tol), gi
        del want, wst
