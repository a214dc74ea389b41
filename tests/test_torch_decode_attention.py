"""Decode attention (``ops.decode_attention``): one token against a KV ring
from the projections' outputs, rotary, the ring write and the attention
over the ring's valid slots in one op.

On the CPU the op runs its plain version (``ref.decode_attention_ref``),
which must equal, bit for bit in its output and in the ring's bytes, the
composition the model ran before the op (``_today`` below: rotary in
``blocks._qkv``, then ``blocks._decode_whole``'s ring write and two einsums,
kept here as they were written), and so must ``blocks._decode_whole``, the
op's caller. The op's fake form gives the output's shape and dtype and the
flops of its plain version; ``decode_attention.plan`` picks the splits from
the shapes.

The kernel itself (``csrc/decode_attention.cu``) runs only on the card:
the tests marked ``card`` skip without one, and run there by

    python -m pytest -q -m card tests/test_torch_decode_attention.py

(this file imports no JAX). They hold the kernel at internlm2's (16, 16
query heads, 8 KV heads, W 4,096, hd 128) and zamba2-7b's (16, 32, 32,
4,096, 224) rings, on sliding-window rings before and after they wrap, on
a KV-head range and in f32, to the plain path on the card: the rings'
bytes equal, the output within the bound the plain path meets against an
f64 oracle, a relaunch bit-equal; and a decode step of each model launches
the kernel once a ring (24 and 13) with no ring-sized copy."""
import itertools
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.trace_analysis import analyze  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16_U = 2.0 ** -8


def _rope(x, angles):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _today(q, k, v, angles, ring, cache_pos, window, scale, kv):
    """The model's decode before the op: rotary, then the whole-ring
    decode as ``blocks._decode_whole`` computed it."""
    q, k = _rope(q, angles), _rope(k, angles)
    ck, cv = ring
    B, _, n, hd = q.shape
    W = ck.shape[1]
    slot = torch.remainder(cache_pos, W).long()
    ck.index_copy_(1, slot.view(1), k.to(ck.dtype))
    cv.index_copy_(1, slot.view(1), v.to(cv.dtype))
    kv0, kv1 = kv or (0, ck.shape[2])
    ck, cv = ck[:, :, kv0:kv1], cv[:, :, kv0:kv1]
    qh = q.reshape(B, 1, kv1 - kv0, n // (kv1 - kv0), hd)
    logits = (torch.einsum("bqhgd,bkhd->bhgqk", qh, ck).float()
              * (scale or hd ** -0.5))
    idx = torch.arange(W, device=q.device)
    if window > 0:
        abs_pos = torch.where(idx <= slot, cache_pos - slot + idx,
                              cache_pos - slot + idx - W)
        valid = (abs_pos >= 0) & (abs_pos > cache_pos - window)
    else:
        valid = idx < cache_pos + 1
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, cv).reshape(B, 1, n * hd)


def _inputs(seed, B, W, Hr, n, hd, dtype, pos, device="cpu"):
    """q (B, 1, n, hd), k, v (B, 1, Hr, hd), angles (B, 1, hd/2) as
    ``rope_angles`` gives them at ``pos``, rings (B, W, Hr, hd) filled
    with noise (so a slot read by mistake shows), ``cache_pos`` int32."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, n, hd, generator=g)
    k = torch.randn(B, 1, Hr, hd, generator=g)
    v = torch.randn(B, 1, Hr, hd, generator=g)
    inv = 1e4 ** (-torch.arange(hd // 2, dtype=torch.float32) / (hd // 2))
    angles = (float(pos) * inv).expand(B, 1, hd // 2).contiguous()
    rings = [torch.randn(B, W, Hr, hd, generator=g) for _ in range(2)]
    to = dict(device=device, dtype=dtype)
    return ([t.to(**to) for t in (q, k, v)], angles.to(device),
            [r.to(**to) for r in rings],
            torch.tensor(pos, dtype=torch.int32, device=device))


# (W, window, pos, scale, kv of 4 ring heads): full ring before and after
# it wraps, window rings as wide as the ring and narrower, before and after
# they wrap, the scale set and not, a KV-head range
VARIANTS = [(24, 0, 5, None, None), (24, 0, 53, 0.3, None),
            (16, 16, 9, None, (1, 3)), (16, 16, 37, 0.2, None),
            (32, 12, 50, None, (0, 2)), (32, 12, 7, 0.25, (3, 4))]
CASES = [(g, hd, dtype, *VARIANTS[i % len(VARIANTS)])
         for i, (g, hd, dtype) in enumerate(itertools.product(
             (1, 2, 4), (64, 80, 128, 224), (torch.bfloat16, torch.float32)))]


@pytest.mark.parametrize("g, hd, dtype, W, window, pos, scale, kv", CASES)
def test_plain_path_is_the_composition_it_replaced(g, hd, dtype, W, window,
                                                   pos, scale, kv):
    B, Hr = 2, 4
    n = g * ((kv[1] - kv[0]) if kv else Hr)
    (q, k, v), angles, rings, cpos = _inputs(hd + pos, B, W, Hr, n, hd,
                                             dtype, pos)
    want_rings = [r.clone() for r in rings]
    want = _today(q, k, v, angles, want_rings, cpos, window, scale, kv)
    got_rings = [r.clone() for r in rings]
    got = ops.decode_attention(q, k, v, angles, got_rings, cpos,
                               window=window, scale=scale, kv=kv)
    cfg = get_config("internlm2_1p8b").replace(sliding_window=window,
                                               attn_scale=scale or 0.0)
    caller_rings = [r.clone() for r in rings]
    caller = blocks._decode_whole(cfg, q, k, v, angles, caller_rings, cpos,
                                  kv)
    for out, rs in ((got, got_rings), (caller, caller_rings)):
        assert out.dtype == dtype and out.shape == (B, 1, n * hd)
        assert torch.equal(out, want)
        for r, w in zip(rs, want_rings):
            assert torch.equal(r, w)
    # the write touched the token's slot only
    slot = pos % W
    keep = torch.ones(W, dtype=torch.bool)
    keep[slot] = False
    for r, old in zip(got_rings, rings):
        assert torch.equal(r[:, keep], old[:, keep])
        assert not torch.equal(r[:, slot], old[:, slot])


@pytest.mark.parametrize("window", (0, 7))
def test_shape_only_form_counts_the_plain_flops(window):
    B, W, Hr, n, hd = 2, 24, 4, 8, 64

    def run(device):
        with FakeTensorMode():
            q = torch.empty(B, 1, n, hd, device=device, dtype=torch.bfloat16)
            k = torch.empty(B, 1, Hr, hd, device=device, dtype=torch.bfloat16)
            angles = torch.empty(B, 1, hd // 2, device=device)
            ck = torch.empty(B, W, Hr, hd, device=device,
                             dtype=torch.bfloat16)
            pos = torch.zeros((), dtype=torch.int32, device=device)
            return analyze(lambda q, k, ck: ops.decode_attention(
                q, k, k, angles, (ck, ck), pos, window=window), q, k, ck)

    ops.reset_launch_counts()
    out, a = run("cuda")
    assert ops.launch_counts()["decode_attention"] == 0
    assert out.shape == (B, 1, n * hd) and out.dtype == torch.bfloat16
    assert out.device.type == "cuda"
    assert a.flops_by_op == {"repro_torch.decode_attention":
                             4 * hd * B * n * W}
    _, plain = run("cpu")                 # the two einsums of the plain path
    assert plain.flops == a.flops


def test_kernel_entries_refuse_the_cpu():
    (q, k, v), angles, (ck, cv), pos = _inputs(1, 1, 16, 2, 4, 64,
                                               torch.bfloat16, 3)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q, k, v, angles, ck, cv, pos)
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.decode_attention(q, k, v, angles, ck, cv, pos,
                                               0, 0.0, 0, 2)


@pytest.mark.parametrize("pairs, W, G, want", [
    (128, 4096, 2, (5, 832)),     # internlm2: 16 rows x 8 KV heads
    (512, 4096, 1, (2, 2048)),    # zamba2-7b: 16 rows x 32 KV heads
    (16, 4096, 4, (16, 256)),     # few pairs: splits no shorter than 256
    (2, 64, 2, (1, 64)),          # a short ring: one split
    (4, 4096, 16, (16, 256)),
    (8192, 4096, 1, (1, 4096)),   # pairs enough to fill the card
    (8192, 4096, 4, (2, 2048)),   # scores capped in shared memory
])
def test_splits_come_from_the_shapes(pairs, W, G, want):
    n, length = da.plan(pairs, W, G)
    assert (n, length) == want
    assert length % da.TILE == 0 and (n - 1) * length < W <= n * length
    assert length * G <= da.MAX_SCORES or length == da.TILE


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("decode attention is a CUDA kernel: these run on an "
                    "NVIDIA card only")
    from repro_torch.kernels import build
    build.build_all(["decode_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _oracle(q, k_ring, v_ring, angles, pos, window, scale, kv):
    """f64 attention of the rotated q over the written rings: (o, the
    bound the plain path's and the kernel's outputs are held to). bf16:
    ``2u (|o| + sum p |v|) + u max|s| sum p |v - o|`` (u = 2^-8: the dot,
    p and o each rounded once, a score's rounding moving p by up to
    u |s| / 2); f32: 1e-5 (|o| + sum p |v|)."""
    qr = ref.apply_rope(q, angles).double()
    B, _, n, hd = q.shape
    W = k_ring.shape[1]
    kv0, kv1 = kv or (0, k_ring.shape[2])
    G = n // (kv1 - kv0)
    K = k_ring[:, :, kv0:kv1].double().repeat_interleave(G, dim=2)
    V = v_ring[:, :, kv0:kv1].double().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhk", qr, K) * (scale or hd ** -0.5)
    slot = torch.remainder(pos, W).long()
    valid = ref.decode_valid(window, W, pos, slot,
                             torch.arange(W, device=q.device))
    s = torch.where(valid, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, V)
    mass = torch.einsum("bhk,bkhd->bhd", p, V.abs())
    if q.dtype == torch.float32:
        bound = 1e-5 * (o.abs() + mass)
    else:
        spread = torch.einsum("bhk,bkhd->bhd", p,
                              (V - o[:, None]).abs())
        top = torch.where(valid, s.abs(), 0).amax(-1, keepdim=True)
        bound = 2 * BF16_U * (o.abs() + mass) + BF16_U * top * spread
    return o.reshape(B, 1, n * hd), bound.reshape(B, 1, n * hd)


CARD_CASES = {
    # name: (B, W, Hr, n, hd, dtype, pos, window, scale, kv)
    "internlm2": (16, 4096, 8, 16, 128, torch.bfloat16, 3500, 0, None, None),
    "internlm2-full": (16, 4096, 8, 16, 128, torch.bfloat16, 4095, 0, None,
                       None),
    "zamba2-7b": (16, 4096, 32, 32, 224, torch.bfloat16, 4087, 0,
                  112 ** -0.5, None),
    "window-wrapped": (4, 4096, 8, 32, 120, torch.bfloat16, 5000, 4096, None,
                       None),
    "window-narrow": (4, 4096, 8, 32, 120, torch.bfloat16, 9000, 1000, None,
                      None),
    "kv-range": (2, 512, 8, 8, 128, torch.bfloat16, 300, 0, None, (2, 6)),
    "f32": (2, 600, 4, 8, 64, torch.float32, 417, 0, None, None),
    "f32-hd80-wrapped": (3, 64, 2, 2, 80, torch.float32, 70, 0, 0.3, None),
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_card_kernel_against_the_plain_path(card, name):
    B, W, Hr, n, hd, dtype, pos, window, scale, kv = CARD_CASES[name]
    (q, k, v), angles, rings, cpos = _inputs(7, B, W, Hr, n, hd, dtype, pos,
                                             card)
    plain_rings = [r.clone() for r in rings]
    plain = ref.decode_attention_ref(q, k, v, angles, plain_rings, cpos,
                                     window=window, scale=scale, kv=kv)
    ops.reset_launch_counts()
    got_rings = [r.clone() for r in rings]
    got = ops.decode_attention(q, k, v, angles, got_rings, cpos,
                               window=window, scale=scale, kv=kv)
    assert ops.launch_counts()["decode_attention"] == 1
    for r, w in zip(got_rings, plain_rings):        # the ring's bytes
        assert torch.equal(r, w)
    o, bound = _oracle(q, *plain_rings, angles, cpos, window, scale, kv)
    used = {what: float(((out.double() - o).abs() / bound).max())
            for what, out in (("plain", plain), ("kernel", got))}
    assert max(used.values()) <= 1.0, used
    again_rings = [r.clone() for r in rings]
    again = ops.decode_attention(q, k, v, angles, again_rings, cpos,
                                 window=window, scale=scale, kv=kv)
    assert torch.equal(again, got)
    for r, w in zip(again_rings, got_rings):
        assert torch.equal(r, w)


@pytest.mark.card
def test_card_takes_only_an_int32_position(card):
    """The kernel reads the position as an int32 on the card (as
    ``lm.init_cache`` makes it); any other dtype is refused, not read."""
    (q, k, v), angles, (ck, cv), pos = _inputs(1, 1, 64, 2, 4, 64,
                                               torch.bfloat16, 3, card)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, v, angles, ck, cv, pos.long())


@pytest.mark.card
@pytest.mark.parametrize("W, window, pos", [
    (64, 0, 40), (64, 0, 100), (64, 16, 40), (64, 16, 100), (64, 64, 100),
    (100, 30, 250), (4096, 0, 3071), (4096, 1000, 9000)])
def test_card_masks_edges_and_the_token_s_own_slot(card, W, window, pos):
    """Scores that pick one slot: the oldest valid slot and the newest
    invalid one (a score of 30 each, every other key zero) must give the
    oldest's v; a query along the token's own k must give the token's v,
    not the ring's stale row. A slot read by mistake, or missed, moves the
    output by about |v|, far past the bound."""
    B, Hr, hd, dtype = 2, 2, 128, torch.bfloat16
    (q, k, v), angles, rings, cpos = _inputs(pos, B, W, Hr, Hr, hd, dtype,
                                             pos, card)
    nv = min(pos + 1, W, window or W)
    slot = pos % W
    qr = ref.apply_rope(q, angles).float()[:, 0]
    magnet = (qr * (30 / (qr.pow(2).sum(-1, keepdim=True) * hd ** -0.5)))
    edges = rings[0].clone().zero_()
    for j in {(slot - nv + 1) % W, (slot - nv) % W} - {slot}:
        edges[:, j] = magnet.to(dtype)
    own = 3 * k.float().repeat_interleave(1, dim=2)
    for name, qq, ring_k in (("edges", q, edges), ("own", own.to(dtype),
                                                    rings[0])):
        plain_rings = [ring_k.clone(), rings[1].clone()]
        plain = ref.decode_attention_ref(qq, k, v, angles, plain_rings, cpos,
                                         window=window)
        got_rings = [ring_k.clone(), rings[1].clone()]
        got = ops.decode_attention(qq, k, v, angles, got_rings, cpos,
                                   window=window)
        for r, w in zip(got_rings, plain_rings):
            assert torch.equal(r, w)
        o, bound = _oracle(qq, *plain_rings, angles, cpos, window, None, None)
        for out in (plain, got):
            assert float(((out.double() - o).abs() / bound).max()) <= 1.0, \
                name
        # the picked slot's v: the oldest valid one, or the token's own
        pick = v if name == "own" else rings[1][:, (slot - nv + 1) % W][:,
                                                                      None]
        assert float((got.float() - pick.reshape(B, 1, -1).float()
                      ).abs().max()) < 0.05, name


def _zamba2_7b():
    from portbench.lib import lm as lmlib
    cfg = json.loads((ROOT / "portbench/configs/zamba2-7b.json").read_text())
    return lmlib.arch_config(cfg)


@pytest.mark.card
@pytest.mark.parametrize("arch, launches", [("internlm2_1p8b", 24),
                                            ("zamba2-7b", 13)])
def test_card_decode_step_launches_once_a_ring(card, arch, launches):
    """One decode step of the whole model (batch 2, a ring of 512) calls
    the kernel once a ring and neither copies nor multiplies a tensor of a
    ring's size (the einsums' permuted copies of the ring before)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import lm
    cfg = _zamba2_7b() if arch == "zamba2-7b" else get_config(arch)
    params = lm.init_params(cfg, 3, device=card)
    cache = lm.init_cache(cfg, 2, 512, device=card)
    cache["pos"].fill_(37)
    ring = 2 * 512 * cfg.num_kv_heads * cfg.head_dim
    big = []

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.ops.aten.clone.default,
                        torch.ops.aten.bmm.default) and any(
                    t.numel() >= ring for t in args
                    if isinstance(t, torch.Tensor)):
                big.append(str(func))
            return out

    token = torch.ones(2, 1, dtype=torch.int32, device=card)
    ops.reset_launch_counts()
    with torch.no_grad(), Copies():
        logits, _ = lm.decode_step(params, cfg, token, cache)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == launches
    assert big == []
    assert bool(torch.isfinite(logits).all())
