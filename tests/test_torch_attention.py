"""Attention prefill on the CPU against the JAX package: the port's naive
oracle ``ref.attention_ref`` against the JAX ``ref.attention_ref``; the
CPU path of ``ops.flash_attention`` (kernel B5's plain version, the
model's chunked online softmax) against the Pallas ``flash_attention`` in
interpret mode, the JAX oracle and the JAX ``_chunked_causal_attention``;
the layout and dispatch rules; the model's prefill going through the
op (``qwen3_8b.smoke()`` served from the launcher); and the bf16 limit
``chip_smoke.py`` holds B5 to, against B5's arithmetic run here in plain
torch (the first kernel's tiles of 64, and the tensor-core kernel's
tiling with D padded to a multiple of 16), with and without one of its
kv tiles, and with pad columns that are not zero.

Tolerances are those of ``tests/test_kernels.py``: rtol = atol = 2e-5 in
float32 and 2e-2 in bfloat16 (both packages round the output, and in the
one-pass branch the probabilities, to bf16)."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_fa  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import make_prefill_step  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (S, Hkv, G, D) of tests/test_kernels.py's flash-attention sweep
SWEEP = [(128, 1, 1, 64), (256, 2, 2, 64), (384, 2, 4, 128), (256, 4, 1, 32)]


def _qkv(seed, B, Hkv, G, S, D, dtype="float32"):
    """q (B, Hkv * G, S, D), k and v (B, Hkv, S, D) as numpy f32, rounded
    to ``dtype``'s values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Hkv * G, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(cfg, B, S):
    rng = np.random.default_rng(6)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                         dtype=np.int32))


CASES = ([(s, hkv, g, d, 0) for s, hkv, g, d in SWEEP]
         + [(256, 2, 2, 64, w) for w in (64, 128, 500)])


@pytest.mark.parametrize("s,hkv,g,d,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax(s, hkv, g, d, window, dtype):
    q, k, v = _qkv(0, 2, hkv, g, s, d, dtype)
    got = ref.attention_ref(*(_torch(a, dtype) for a in (q, k, v)),
                            window=window)
    want = jax_ref.attention_ref(*(_jax(a, dtype) for a in (q, k, v)),
                                 window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("s,hkv,g,d,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_op_matches_pallas_interpret(s, hkv, g, d, window, dtype):
    """Every S here fits in one chunk (512) of the CPU path, so this holds
    its one-pass branch against the TPU kernel's online softmax; the
    chunked branch is held below."""
    q, k, v = _qkv(1, 2, hkv, g, s, d, dtype)
    got = ops.flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                              window=window)
    want = jax_fa(*(_jax(a, dtype) for a in (q, k, v)), window=window,
                  interpret=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("s", [1, 33, 127, 1024])
@pytest.mark.parametrize("window", [0, 100])
def test_cpu_op_matches_jax_oracle_off_tile(s, window):
    """Lengths the TPU kernel does not take (S % 128 != 0) and, at 1,024,
    the online-softmax branch over two chunks of 512."""
    q, k, v = _qkv(2, 1, 2, 3, s, 40)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window)
    want = jax_ref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                 window=window)
    _close(got, want, "float32")


@pytest.mark.parametrize("s,chunk,hkv,g,window", [
    (16, 16, 2, 2, 0),            # S <= chunk: one pass
    (12, 16, 1, 4, 5),            # one pass, SWA
    (32, 16, 2, 2, 0),            # S = 2 chunk: online softmax
    (64, 16, 2, 3, 24),           # window over more than a chunk
    (64, 16, 4, 1, 16),           # window of one chunk, MHA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_op_matches_jax_chunked(s, chunk, hkv, g, window, dtype):
    B, D = 2, 16
    q, k, v = _qkv(3, B, hkv, g, s, D, dtype)
    got = ops.flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                              window=window, chunk=chunk)
    jq = _jax(q, dtype).transpose(0, 2, 1, 3).reshape(B, s, hkv, g, D)
    jk, jv = (_jax(a, dtype).transpose(0, 2, 1, 3) for a in (k, v))
    want = jax_blocks._chunked_causal_attention(jq, jk, jv, window,
                                                chunk=chunk)
    want = np.asarray(want.astype(jnp.float32)).reshape(
        B, s, hkv * g, D).transpose(0, 2, 1, 3)
    _close(got, want, dtype)


def test_strided_views_equal_contiguous_inputs():
    """Head views of (B, S, heads, D) tensors, as the model hands them
    over, give what contiguous (B, heads, S, D) copies give."""
    q, k, v = _qkv(4, 2, 2, 4, 64, 24)
    dense = [torch.from_numpy(a) for a in (q, k, v)]
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in dense]
    assert not views[0].is_contiguous()
    for window in (0, 20):
        got = ops.flash_attention(*views, window=window, chunk=32)
        want = ops.flash_attention(*dense, window=window, chunk=32)
        assert torch.equal(got, want)


def test_cpu_path_launches_no_kernel_and_the_wrapper_refuses_cpu():
    ops.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 2, 2, 40, 16))
    ops.flash_attention(q, k, v, window=8)
    cfg = get_config("qwen3_8b").smoke()
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = _tokens(cfg, 2, 24)
    make_prefill_step(cfg, 28)(params, {"tokens": tokens})
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)


@pytest.mark.parametrize("arch", ["qwen3_8b", "h2o_danube3_4b",
                                  "zamba2_2p7b"])
def test_prefill_attention_goes_through_the_op(arch, monkeypatch):
    """Every attention layer of a prefill calls ``ops.flash_attention``
    once, with the config's window, on (B, H, S, D) views; decode does
    not."""
    cfg = get_config(arch).smoke()
    seen = []
    op = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw["window"]))
        return op(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    params = lm.init_params(cfg, 0, device="cpu")
    B, S = 2, 24
    tokens = _tokens(cfg, B, S)
    logits, cache = make_prefill_step(cfg, S + 2)(params, {"tokens": tokens})
    n_attn = sum(kind in lm.ATTN_KINDS for kind, *_ in
                 lm._layers(cfg, params))
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert n_attn > 0
    assert seen == [((B, H, S, D), (B, Hkv, S, D), cfg.sliding_window)] * \
        n_attn
    lm.decode_step(params, cfg, logits.argmax(-1)[:, None].to(torch.int32),
                   cache)
    assert len(seen) == n_attn


def test_serve_launcher_runs_qwen3_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen3_8b",
                                     "--batch", "2", "--prompt-len", "16",
                                     "--tokens", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill: 2x16" in out and "decode:  3 steps" in out


def _b5_arithmetic(q, k, v, window, skip=None):
    """B5's arithmetic in plain torch: kv tiles of 64 in order, a running
    max, p rounded to v's dtype before P.V and l summing the unrounded p,
    the output rounded to q's dtype. ``skip`` drops the kv tile that
    starts there, as a kernel that lost it would."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kx, vx = (t.repeat_interleave(G, 1).float() for t in (k, v))
    m = torch.full((B, H, S), -1e30)
    l, acc = torch.zeros(B, H, S), torch.zeros(B, H, S, D)
    pos = torch.arange(S)
    for t0 in range(0, S, 64):
        kp = pos[t0:t0 + 64]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         kx[:, :, t0:t0 + 64]) * D ** -0.5
        mask = pos[:, None] >= kp[None, :]
        if window > 0:
            mask &= pos[:, None] - kp[None, :] < window
        if t0 == skip:
            mask &= False
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = p.to(v.dtype).float() @ vx[:, :, t0:t0 + 64]
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("s,hkv,g,d,window", [(1024, 2, 2, 64, 0),
                                              (1000, 1, 4, 80, 300)])
def test_chip_bf16_limit_holds_b5_arithmetic_not_a_lost_tile(s, hkv, g, d,
                                                             window):
    q, k, v = (_torch(a, "bfloat16")
               for a in _qkv(7, 1, hkv, g, s, d, "bfloat16"))
    got = _b5_arithmetic(q, k, v, window)
    err, use = chip_smoke._attn_check(torch, ref, got, q, k, v, window,
                                      "B5's arithmetic")
    assert 0 < err and use <= 1
    lost = _b5_arithmetic(q, k, v, window, skip=s // 2 // 64 * 64)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke._attn_check(torch, ref, lost, q, k, v, window,
                               "a lost kv tile")


def _b5_tc_arithmetic(q, k, v, window, fault=None):
    """The bf16 kernel's tiling in plain torch: query tiles of 128 rows,
    each walking the kv tiles of 128 its rows can see, D zero-padded to
    DP = 16 ceil(D / 16), scores in f32 sums per tile times D^-0.5,
    p = exp2(s log2(e) - m log2(e)) (the kernel fuses it into one FMA), a
    row with nothing unmasked yet keeping m = -1e30 and p = 0, corr = 1
    where m did not move, p rounded to bf16 before P.V and l summing the
    unrounded p, the output's first D columns rounded to bf16. ``fault``
    is "lost tile" (the kv tile at S / 2 dropped) or "stale pad" (the pad
    columns of q and k hold stale values, not zeros)."""
    BQ, BK, L2E, NEG = 128, 128, 1.4426950408889634, -1e30
    B, H, S, D = q.shape
    G, DP = H // k.shape[1], -(-D // 16) * 16
    qp, kp, vp = (torch.nn.functional.pad(t.float(), (0, DP - D))
                  for t in (q, k, v))
    if fault == "stale pad":
        qp[..., D:] = q[..., :DP - D].float()
        kp[..., D:] = k[..., :DP - D].float()
    kx, vx = (t.repeat_interleave(G, 1) for t in (kp, vp))
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    lost = S // 2 // BK * BK if fault == "lost tile" else None
    out = torch.empty(B, H, S, DP)
    pos = torch.arange(S)
    for q0 in range(0, S, BQ):
        rows = pos[q0:q0 + BQ]
        hi = min(q0 + BQ - 1, S - 1) // BK
        lo = (q0 - window + 1) // BK if window > 0 and q0 - window + 1 > 0 \
            else 0
        m = torch.full((B, H, len(rows)), NEG)
        l, acc = torch.zeros(B, H, len(rows)), torch.zeros(B, H, len(rows),
                                                          DP)
        for k0 in range(lo * BK, (hi + 1) * BK, BK):
            cols = pos[k0:k0 + BK]
            s = torch.einsum("bhqd,bhkd->bhqk", qp[:, :, q0:q0 + BQ],
                             kx[:, :, k0:k0 + BK]) * scale
            mask = rows[:, None] >= cols[None, :]
            if window > 0:
                mask &= rows[:, None] - cols[None, :] < window
            if k0 == lost:
                mask &= False
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            ml = torch.where(m_new == NEG, 0.0, m_new * L2E)
            p = torch.exp2(s * L2E - ml[..., None])
            corr = torch.where(m == m_new, 1.0, torch.exp2(m * L2E - ml))
            l = l * corr + p.sum(-1)
            pv = p.bfloat16().float() @ vx[:, :, k0:k0 + BK]
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, q0:q0 + BQ] = acc / l.clamp_min(1e-30)[..., None]
    return out[..., :D].bfloat16()


# (S, Hkv, G, D, window): the pad (D = 120), zamba2's D, G = 4, a window,
# ragged S; each fault only where it can occur (no pad at D = 80)
TC_CASES = [(1000, 1, 4, 120, 300), (1000, 1, 4, 80, 300),
            (777, 2, 2, 120, 0)]


@pytest.mark.parametrize("s,hkv,g,d,window,fault", [
    case + (fault,) for case in TC_CASES
    for fault in (None, "lost tile", "stale pad")
    if fault != "stale pad" or case[3] % 16])
def test_chip_bf16_limit_holds_tensor_core_tiling(s, hkv, g, d, window,
                                                  fault):
    """``chip_smoke._attn_check``'s bf16 limit passes the tensor-core
    kernel's arithmetic and fails it with one kv tile lost or with pad
    columns that are not zero."""
    q, k, v = (_torch(a, "bfloat16")
               for a in _qkv(8, 1, hkv, g, s, d, "bfloat16"))
    got = _b5_tc_arithmetic(q, k, v, window, fault)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    if fault is None:
        err, use = chip_smoke._attn_check(torch, ref, got, q, k, v, window,
                                          "the tensor-core tiling")
        assert 0 < err and use <= 1
    else:
        with pytest.raises(AssertionError, match="disagrees"):
            chip_smoke._attn_check(torch, ref, got, q, k, v, window, fault)
