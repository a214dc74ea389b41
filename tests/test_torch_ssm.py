"""The port's SSM serving path on the CPU against the JAX package: the
chunked scan (kernel B4's plain version ``gla_chunked``, the step
recurrence ``ssm_scan_ref`` and the CPU path of ``ops.ssm_scan``) against
the Pallas kernel in interpret mode and ``gla_chunked``; the Mamba2 and
RWKV6 layers; ``zamba2_2p7b.smoke()`` (hybrid_shared wiring) and
``rwkv6_1p6b.smoke()`` (uniform RWKV6) with the JAX package's weights
carried across; and one pre-copy of a hybrid replica on both packages.

Tolerances: the scan within rtol/atol 2e-4 (``tests/test_kernels.py``);
layers and f32 logits within rtol/atol 1e-4, greedy tokens equal. In
bfloat16 both packages round activations at different places and the
smoke models are deeper than danube's (zamba2: 10 Mamba2 layers and two
shared-block applications); measured, logits of size ~4 differ by at most
0.133 (zamba2) and 0.082 (rwkv6), a few bf16 ulps there, so bf16 logits
are held to atol 0.25 on the reference's tokens."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import precopy as jax_precopy  # noqa: E402
from repro.data import make_batch as jax_batch  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.models import gla as jax_gla  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro.train import make_decode_step as jax_decode  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import precopy  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm_kernel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert, gla, lm, mamba2, rwkv6  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("zamba2_2p7b", "rwkv6_1p6b")


def _scan_inputs(seed, B, H, S, dk, dv, ssd, decay_scale=0.3):
    """Seeded numpy (q, k, v, log_decay, u-or-None, initial state)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, H, S, dk), f(B, H, S, dk), f(B, H, S, dv)
    lw = -np.abs(f(B, H, S, dk)) * decay_scale
    u = None if ssd else f(H, dk)
    s0 = f(B, H, dk, dv)
    return q, k, v, lw, u, s0


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the scan (B4's plain versions and the CPU op)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,dk,dv", [(64, 16, 16), (128, 64, 32),
                                     (96, 32, 64)])
@pytest.mark.parametrize("ssd", [True, False])
def test_scan_matches_pallas_interpret(s, dk, dv, ssd):
    """The shapes of ``tests/test_kernels.py``: the port's step recurrence
    and its CPU op against the Pallas kernel run in interpret mode."""
    q, k, v, lw, u, _ = _scan_inputs(s * dk + dv, 2, 3, s, dk, dv, ssd)
    yk, stk = jax_ssm_scan(*map(_j, (q, k, v, lw)), bonus=_j(u), ssd=ssd)
    for fn in (ref.ssm_scan_ref, ops.ssm_scan):
        y, st = fn(*map(_t, (q, k, v, lw)), bonus=_t(u))
        assert y.dtype == st.dtype == torch.float32
        assert y.shape == (2, 3, s, dv) and st.shape == (2, 3, dk, dv)
        np.testing.assert_allclose(y.numpy(), np.asarray(yk), **SCAN_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(stk), **SCAN_TOL)


@pytest.mark.parametrize("s", [1, 33, 45, 95])
@pytest.mark.parametrize("ssd", [True, False])
@pytest.mark.parametrize("with_state", [False, True])
def test_ragged_and_initial_state_match_jax_gla(s, ssd, with_state):
    """S not a multiple of the chunk and a non-zero initial state, which
    the Pallas kernel does not take: the port's op against the JAX
    package's ``gla_chunked``, and against the port's step recurrence."""
    q, k, v, lw, u, s0 = _scan_inputs(s + 7 * ssd, 2, 3, s, 16, 24, ssd)
    s0 = s0 if with_state else None
    yj, stj = jax_gla.gla_chunked(*map(_j, (q, k, v, lw)), bonus=_j(u),
                                  initial_state=_j(s0))
    y, st = ops.ssm_scan(*map(_t, (q, k, v, lw)), bonus=_t(u),
                         initial_state=_t(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), **SCAN_TOL)
    yr, str_ = ref.ssm_scan_ref(*map(_t, (q, k, v, lw)), bonus=_t(u),
                                initial_state=_t(s0))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), str_.numpy(), **SCAN_TOL)


def test_decay_below_the_clamp():
    """Log decay under -4 scans as -4 (and above 0 as 0), in both the
    chunked and the step versions, as in the JAX package."""
    q, k, v, lw, u, _ = _scan_inputs(3, 1, 2, 70, 8, 8, False,
                                     decay_scale=6.0)
    lw[0, 0, :5] = 0.5
    clamped = np.clip(lw, -4.0, 0.0)
    for fn in (ops.ssm_scan, ref.ssm_scan_ref):
        got = fn(*map(_t, (q, k, v, lw)), bonus=_t(u))
        want = fn(*map(_t, (q, k, v, clamped)), bonus=_t(u))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    yj, _ = jax_gla.gla_chunked(*map(_j, (q, k, v, lw)), bonus=_j(u))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(yj), **SCAN_TOL)


def test_strided_and_bf16_inputs():
    """Mamba2's call: B/C broadcast over heads and the per-head decay over
    the state dimension as stride-0 views, bf16 q/k/v; the op reads them
    as the materialized f32 tensors."""
    rng = np.random.default_rng(5)
    B, H, S, N, P = 2, 3, 40, 8, 16
    c = torch.from_numpy(rng.standard_normal((B, S, N)).astype(np.float32))
    b_ = torch.from_numpy(rng.standard_normal((B, S, N)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    lw = torch.from_numpy(-np.abs(rng.standard_normal((B, S, H))).astype(
        np.float32))
    views = (c.bfloat16()[:, None].expand(B, H, S, N),
             b_.bfloat16()[:, None].expand(B, H, S, N),
             v.bfloat16().permute(0, 2, 1, 3),
             lw.permute(0, 2, 1)[..., None].expand(B, H, S, N))
    assert views[0].stride()[1] == 0 and views[3].stride()[3] == 0
    y, st = ops.ssm_scan(*views)
    dense = [t.float().contiguous() for t in views]
    y2, st2 = ops.ssm_scan(*dense)
    np.testing.assert_array_equal(y.numpy(), y2.numpy())
    np.testing.assert_array_equal(st.numpy(), st2.numpy())
    yj, stj = jax_gla.gla_chunked(*(jnp.asarray(t.numpy()) for t in dense))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), **SCAN_TOL)


@pytest.mark.parametrize("ssd", [True, False])
def test_gla_decode_step_matches_jax_and_the_scan(ssd):
    """One decode step after a chunked prefill continues the recurrence:
    equal to the JAX package's step and to the scan of S + 1 tokens."""
    q, k, v, lw, u, _ = _scan_inputs(11 + ssd, 2, 3, 37, 16, 8, ssd)
    y_all, st_all = gla.gla_chunked(*map(_t, (q, k, v, lw)), bonus=_t(u))
    _, st = gla.gla_chunked(*(_t(a[:, :, :-1]) for a in (q, k, v, lw)),
                            bonus=_t(u))
    last = [a[:, :, -1] for a in (q, k, v, lw)]
    y, st1 = gla.gla_decode_step(*map(_t, last), st, bonus=_t(u))
    yj, stj = jax_gla.gla_decode_step(*map(_j, last), jnp.asarray(st.numpy()),
                                      bonus=_j(u))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SCAN_TOL)
    np.testing.assert_allclose(st1.numpy(), np.asarray(stj), **SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), y_all[:, :, -1].numpy(), **SCAN_TOL)
    np.testing.assert_allclose(st1.numpy(), st_all.numpy(), **SCAN_TOL)


def test_cpu_scan_launches_no_kernel_and_the_wrapper_refuses_cpu():
    ops.reset_launch_counts()
    q, k, v, lw, _, _ = _scan_inputs(0, 1, 2, 8, 4, 4, True)
    ops.ssm_scan(*map(_t, (q, k, v, lw)))
    assert ops.launch_counts()["ssm_scan"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ssm_kernel.ssm_scan(*map(_t, (q, k, v, lw)))


# ---------------------------------------------------------------------------
# B4's tensor-core arithmetic, in plain torch
# ---------------------------------------------------------------------------
def _tf32(x):
    """f32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    by the kernel's integer rounding of the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, a_exact=False, b_exact=False, terms=3):
    """a @ b as the kernel's products: each f32 operand split hi + lo (both
    TF32) and lo.hi + hi.lo + hi.hi summed in f32, a term whose lo is 0
    (an exact bf16 operand) left out; ``terms=1`` keeps hi.hi alone, a
    plain TF32 product."""
    ah = a if a_exact else _tf32(a)
    bh = b if b_exact else _tf32(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    if terms == 3 and not a_exact:
        out = out + _tf32(a - ah) @ bh
    if terms == 3 and not b_exact:
        out = out + ah @ _tf32(b - bh)
    return out + ah @ bh


def _b4_tc_arithmetic(q, k, v, lw, bonus=None, s0=None, *, scalar=False,
                      exact=False, terms=3):
    """``csrc/ssm_scan.cu`` in plain torch: chunks of 32 (the ragged tail
    zero-filled), the log decay clamped, the products of ``_mm``.
    ``scalar`` (SSD, one decay a token): scores (q k^T) exp(L_t - L_s),
    readout exp(L_t) (q S), update exp(L_end) S + k^T (v exp(L_end - L_s)).
    Else the factored form: the cumsum in two halves of 16, X = q exp(Lq -
    shift), q exp(Lq) = X exp(shift), k_in = k exp(shift - L), k_out =
    k_in exp(L_end - shift). ``exact``: q, k, v hold bf16 values."""
    Q = 32
    B, H, S, Dk = q.shape
    pad = (-S) % Q
    q, k, v, lw = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                   for t in (q, k, v, lw))
    lw = lw.clamp(-4.0, 0.0)
    st = torch.zeros(B, H, Dk, v.shape[-1]) if s0 is None else s0.float()
    pos = torch.arange(Q)
    ssd = bonus is None
    mask = pos[:, None] >= pos[None, :] if ssd else pos[:, None] > pos[None, :]
    ys = []
    for c in range(0, S + pad, Q):
        qc, kc, vc, lc = (t[:, :, c:c + Q] for t in (q, k, v, lw))
        if scalar:
            L = torch.cumsum(lc[..., 0], dim=-1)                # (B, H, Q)
            G = _mm(qc, kc.transpose(-1, -2), exact, exact, terms)
            P = torch.where(mask, G * torch.exp(L[..., :, None]
                                                - L[..., None, :]), 0.0)
            y = (torch.exp(L)[..., None] * _mm(qc, st, exact, False, terms)
                 + _mm(P, vc, False, exact, terms))
            tot = L[..., -1:]
            w = torch.exp(tot - L)[..., None]
            st = (torch.exp(tot)[..., None] * st
                  + _mm(kc.transpose(-1, -2), vc * w, exact, False, terms))
        else:
            L1 = torch.cumsum(lc[:, :, :16], dim=2)
            L = torch.cat([L1, torch.cumsum(lc[:, :, 16:], dim=2)
                           + L1[:, :, -1:]], dim=2)
            Lq = L if ssd else torch.cat(
                [torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
            shift, tot = L[:, :, 16:17], L[:, :, -1:]
            X = qc * torch.exp(Lq - shift)
            kin = kc * torch.exp(shift - L)
            P = torch.where(mask, _mm(X, kin.transpose(-1, -2), terms=terms),
                            0.0)
            if not ssd:
                diag = torch.einsum("bhtd,hd,bhtd->bht", qc, bonus.float(),
                                    kc)
                P = P + diag[..., None] * torch.eye(Q)
            y = (_mm(X * torch.exp(shift), st, terms=terms)
                 + _mm(P, vc, False, exact, terms))
            kout = kin * torch.exp(tot - shift)
            st = (torch.exp(tot[:, :, 0])[..., None] * st
                  + _mm(kout.transpose(-1, -2), vc, False, exact, terms))
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :S], st


def _mamba_inputs(seed, B, H, S, dk, dv, bf16):
    """Mamba2's call: q, k shared by every head and one decay a token per
    head (stride-0 views), -exp(U(log 1e-3, log 1.6)) as dt * A spans."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v = f(B, S, dk), f(B, S, dk), f(B, S, H, dv)
    if bf16:
        q, k, v = (t.bfloat16().float() for t in (q, k, v))
    lw = -torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1.6),
                                              (B, S, H))).astype(np.float32))
    return (q[:, None].expand(B, H, S, dk), k[:, None].expand(B, H, S, dk),
            v.permute(0, 2, 1, 3),
            lw.permute(0, 2, 1)[..., None].expand(B, H, S, dk))


@pytest.mark.parametrize("bf16", [True, False])
def test_b4_tc_arithmetic_ssd_broadcast_matches_pallas_and_gla(bf16):
    """The SCALAR form on Mamba2's stride-0 q/k/decay (bf16 raw inputs
    read as exact operands, or f32 split everywhere) against the Pallas
    kernel in interpret mode and ``gla_chunked``, within 2e-4."""
    ins = _mamba_inputs(3 + bf16, 2, 3, 96, 32, 16, bf16)
    got = _b4_tc_arithmetic(*ins, scalar=True, exact=bf16)
    dense = [np.ascontiguousarray(t.numpy()) for t in ins]
    yk, stk = jax_ssm_scan(*map(jnp.asarray, dense), ssd=True)
    want = gla.gla_chunked(*ins)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(yk), **SCAN_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(stk), **SCAN_TOL)


@pytest.mark.parametrize("ssd", [True, False])
def test_b4_tc_arithmetic_factored_matches_pallas_and_gla(ssd):
    """The GENERAL form (per-channel decay; RWKV with its bonus) against
    the Pallas kernel in interpret mode and ``gla_chunked``."""
    q, k, v, lw, u, _ = _scan_inputs(21 + ssd, 2, 3, 64, 32, 16, ssd)
    got = _b4_tc_arithmetic(*map(_t, (q, k, v, lw)), _t(u))
    yk, stk = jax_ssm_scan(*map(_j, (q, k, v, lw)), bonus=_j(u), ssd=ssd)
    want = gla.gla_chunked(*map(_t, (q, k, v, lw)), bonus=_t(u))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(yk), **SCAN_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(stk), **SCAN_TOL)


@pytest.mark.parametrize("s", [45, 77])
@pytest.mark.parametrize("form", ["rwkv", "ssd", "scalar"])
def test_b4_tc_arithmetic_ragged_with_initial_state(s, form):
    """A ragged S and an initial state (which the Pallas kernel does not
    take): each form against the JAX package's ``gla_chunked`` and the
    step recurrence."""
    q, k, v, lw, u, s0 = _scan_inputs(s + len(form), 2, 3, s, 16, 24,
                                      form != "rwkv")
    if form == "scalar":
        lw = np.ascontiguousarray(np.broadcast_to(lw[..., :1], lw.shape))
    got = _b4_tc_arithmetic(*map(_t, (q, k, v, lw)), _t(u), _t(s0),
                            scalar=form == "scalar")
    yj, stj = jax_gla.gla_chunked(*map(_j, (q, k, v, lw)), bonus=_j(u),
                                  initial_state=_j(s0))
    yr, str_ = ref.ssm_scan_ref(*map(_t, (q, k, v, lw)), bonus=_t(u),
                                initial_state=_t(s0))
    for want in ((yj, stj), (yr, str_)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   **SCAN_TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   **SCAN_TOL)


@pytest.mark.parametrize("form", ["rwkv", "scalar"])
def test_b4_single_tf32_product_misses_the_tolerance(form):
    """C-w2: the same arithmetic with each f32 product taken as one plain
    TF32 product (hi.hi alone, ~11 bits) fails 2e-4, which the 3xTF32
    split above keeps."""
    q, k, v, lw, u, s0 = _scan_inputs(9, 2, 3, 96, 32, 32, form == "scalar")
    if form == "scalar":
        lw = np.ascontiguousarray(np.broadcast_to(lw[..., :1], lw.shape))
    args = (*map(_t, (q, k, v, lw)), _t(u), _t(s0))
    want = ref.ssm_scan_ref(*args[:4], bonus=args[4], initial_state=args[5])
    split = _b4_tc_arithmetic(*args, scalar=form == "scalar")
    np.testing.assert_allclose(split[0].numpy(), want[0].numpy(), **SCAN_TOL)
    plain = _b4_tc_arithmetic(*args, scalar=form == "scalar", terms=1)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(plain[0].numpy(), want[0].numpy(),
                                   **SCAN_TOL)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _tensors(params):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)


def _layer_cfgs(arch):
    kw = dict(param_dtype="float32")
    return (jax_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def test_mamba2_forward_and_decode_match_jax():
    jc, tc = _layer_cfgs("zamba2_2p7b")
    jp = jax_mamba2.mamba2_init(jax.random.key(3), jc)
    tp = _tensors(jp)
    x = _x(0, 2, 45, jc.d_model)
    yj, (cj, sj) = jax.jit(jax_mamba2.mamba2_forward, static_argnums=1)(
        jp, jc, jnp.asarray(x))
    y, (c, s) = mamba2.mamba2_forward(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **TOL)
    x1 = _x(1, 2, 1, jc.d_model)
    yj, (cj, sj) = jax.jit(jax_mamba2.mamba2_decode, static_argnums=1)(
        jp, jc, jnp.asarray(x1), (cj, sj))
    y, (c, s) = mamba2.mamba2_decode(tp, tc, torch.from_numpy(x1), (c, s))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **TOL)


def test_rwkv6_block_matches_jax():
    """Prefill, a prefill continuing from that carry (the scan's initial
    state), then a decode step, with a non-zero bonus."""
    jc, tc = _layer_cfgs("rwkv6_1p6b")
    jp = jax_rwkv6.rwkv6_init(jax.random.key(4), jc)
    jp["faaaa"] = jnp.asarray(np.random.default_rng(9).standard_normal(
        jp["faaaa"].shape).astype(np.float32) * 0.5)
    tp = _tensors(jp)
    jcache, tcache = None, None
    block = jax.jit(jax_rwkv6.rwkv6_block, static_argnums=1)
    for seed, S in ((0, 37), (1, 20), (2, 1)):
        x = _x(seed, 2, S, jc.d_model)
        yj, jcache = block(jp, jc, jnp.asarray(x), jcache)
        y, tcache = rwkv6.rwkv6_block(tp, tc, torch.from_numpy(x), tcache)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
        for a, b in zip(tcache, jcache):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def _replicas(arch, kw, batch, prompt):
    jc = jax_config(arch).smoke().replace(**kw)
    tc = get_config(arch).smoke().replace(**kw)
    jp = jax_lm.init_params(jc, jax.random.key(0))
    tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    jb = jax_batch(jc, batch, prompt)
    jb.pop("targets")
    tb = make_batch(tc, batch, prompt, device="cpu")
    tb.pop("targets")
    np.testing.assert_array_equal(np.asarray(jb["tokens"]),
                                  tb["tokens"].numpy())
    return jc, tc, jp, tp, jb, tb


def _assert_caches_close(tcache, jcache, tol):
    """Leaves in the same order with the same shapes and dtypes and, unless
    ``tol`` is None, values within ``tol``."""
    tl, jl = tree.leaves(tcache), jax.tree.leaves(jcache)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        if tol is not None:
            np.testing.assert_allclose(_f32(a), _f32(b), **tol)


def _serve_both(arch, kw, batch, prompt, n_decode, tol, teacher_forced):
    """Prefill + ``n_decode`` greedy steps on both packages, every logits
    row within ``tol``; caches compared within ``tol`` unless teacher
    forced (bf16), where their values drift apart with the activations."""
    jc, tc, jp, tp, jb, tb = _replicas(arch, kw, batch, prompt)
    cache_len = prompt + n_decode
    cache_tol = None if teacher_forced else tol
    jl, jcache = jax.jit(jax_prefill(jc, cache_len))(jp, jb)
    tl, tcache = make_prefill_step(tc, cache_len)(tp, tb)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    _assert_caches_close(tcache, jcache, cache_tol)
    jdec, tdec = jax.jit(jax_decode(jc)), make_decode_step(tc)
    jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tt = tl.argmax(-1)[:, None].to(torch.int32)
    jtoks, ttoks = [np.asarray(jt)], [tt.numpy()]
    for _ in range(n_decode):
        if teacher_forced:
            tt = torch.from_numpy(np.array(jt))
        jt, jlog, jcache = jdec(jp, jt, jcache)
        tt, tlog, tcache = tdec(tp, tt, tcache)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **tol)
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
    assert int(tcache["pos"]) == int(jcache["pos"]) == prompt + n_decode
    _assert_caches_close(tcache, jcache, cache_tol)
    return np.concatenate(jtoks, 1), np.concatenate(ttoks, 1)


@pytest.mark.parametrize("arch,prompt", [("zamba2_2p7b", 40),
                                         ("zamba2_2p7b", 64),
                                         ("rwkv6_1p6b", 45),
                                         ("rwkv6_1p6b", 64)])
def test_serving_f32_matches_jax(arch, prompt):
    jtoks, ttoks = _serve_both(arch, dict(param_dtype="float32"), 3, prompt,
                               6, TOL, teacher_forced=False)
    np.testing.assert_array_equal(ttoks, jtoks)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_bf16_matches_jax(arch):
    _serve_both(arch, {}, 2, 40, 4, dict(rtol=0, atol=0.25),
                teacher_forced=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_serving_launches_no_kernel(arch):
    ops.reset_launch_counts()
    _, tc, _, tp, _, tb = _replicas(arch, {}, 2, 16)
    logits, cache = make_prefill_step(tc, 20)(tp, tb)
    make_decode_step(tc)(tp, logits.argmax(-1)[:, None].to(torch.int32),
                         cache)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_tree_matches_jax(arch):
    """The full-width tree (shapes only): every key, shape and dtype equal
    to the JAX package's, the f32 leaves (A_log, D, dt_bias, decay_base,
    faaaa) included; zamba2 has 2,063,676,080 parameters."""
    jc, tc = jax_config(arch), get_config(arch)
    spec = jax.eval_shape(lambda: jax_lm.init_params(jc, jax.random.key(0)))
    want = {jax.tree_util.keystr(p): (l.shape, str(l.dtype)) for p, l in
            jax.tree_util.tree_leaves_with_path(spec)}
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}['{k}']")
        else:
            got[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    walk(lm.init_params(tc, device="meta"), "")
    assert got == want
    assert {d for _, d in got.values()} == {"bfloat16", "float32"}
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert n == jax_lm.param_count(jc)
    if arch == "zamba2_2p7b":
        assert n == 2_063_676_080


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    jc, tc = jax_config(arch).smoke(), get_config(arch).smoke()
    jcache = jax_lm.init_cache(jc, 3, 24)
    tcache = lm.init_cache(tc, 3, 24, device="cpu")
    _assert_caches_close(tcache, jcache, dict(rtol=0, atol=0))


def test_convert_keeps_f32_leaves_under_bf16():
    jc, tc = jax_config("zamba2_2p7b").smoke(), \
        get_config("zamba2_2p7b").smoke()
    jp = jax_lm.init_params(jc, jax.random.key(1))
    tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    for name in ("A_log", "D", "dt_bias"):
        got = tp["mamba"]["mixer"][name]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jp["mamba"]["mixer"][name]))
    assert tp["mamba"]["mixer"]["in_proj"].dtype == torch.bfloat16


def test_serve_launcher_runs_zamba2_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "zamba2_2p7b",
                                     "--batch", "2", "--prompt-len", "16",
                                     "--tokens", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill: 2x16" in out and "decode:  3 steps" in out


# ---------------------------------------------------------------------------
# pre-copy of a hybrid replica on both packages
# ---------------------------------------------------------------------------
B_, P_, N_ = 3, 40, 24
PCFG = dict(block_elems=1 << 10, max_rounds=6, stop_dirty_blocks=2)


def test_hybrid_precopy_matches_jax():
    """zamba2's smoke replica (tuples of f32 SSD and conv states beside the
    shared block's KV rings) pre-copied while decode runs: the same rounds,
    stop reason and per-round bytes in both packages, and the port's
    destination bit-equal to its live state."""
    jc, tc, jp, tp, jb, tb = _replicas("zamba2_2p7b", {}, B_, P_)
    jprefill = jax.jit(jax_prefill(jc, cache_len=P_ + N_))
    jdec = jax.jit(jax_decode(jc))
    jl, jcache = jprefill(jp, jb)
    jbox = {"cache": jcache,
            "tok": jnp.argmax(jl, -1)[:, None].astype(jnp.int32)}

    def jstep():
        jbox["tok"], _, jbox["cache"] = jdec(jp, jbox["tok"], jbox["cache"])

    jdest, jrep = jax_precopy.migrate(
        lambda: {"params": jp, "cache": jbox["cache"]}, jstep,
        jax_precopy.PrecopyConfig(**PCFG))

    tl, tcache = make_prefill_step(tc, P_ + N_)(tp, tb)
    tdec = make_decode_step(tc)
    box = {"cache": tcache, "tok": tl.argmax(-1)[:, None].to(torch.int32)}

    def step():
        box["tok"], _, box["cache"] = tdec(tp, box["tok"], box["cache"])

    state = lambda: {"params": tp, "cache": box["cache"]}  # noqa: E731
    dest, rep = precopy.migrate(state, step, precopy.PrecopyConfig(**PCFG))
    assert (rep.outcome.rounds, rep.outcome.stop_reason) == \
        (jrep.outcome.rounds, jrep.outcome.stop_reason) == (6, "max_rounds")
    assert rep.per_round_dirty_bytes == jrep.per_round_dirty_bytes
    assert rep.v_mem == jrep.v_mem
    assert rep.outcome.bytes_sent == jrep.outcome.bytes_sent
    for a, b in zip(tree.leaves(dest), tree.leaves(state())):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    assert len(tree.leaves(dest)) == len(jax.tree.leaves(jdest))
