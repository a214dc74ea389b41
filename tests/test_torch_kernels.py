"""Port kernels on the CPU: the plain versions that ``repro_torch``'s ops
run for CPU tensors, against the JAX package's Pallas kernels (interpret
mode) and the numpy oracles, plus the dispatch-by-device rule.

Tolerances are those of ``tests/test_kernels.py``: spectra rtol 2e-4 /
atol 2e-2, autocorrelation rtol 2e-4 / atol 2e-3. The dirty-block scan is
a max of exact f32 differences, so it must agree bit for bit (NaN where
the reference gives NaN)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.autocorr import autocorr_score as jax_autocorr  # noqa: E402
from repro.kernels.autocorr import autocorr_score_ref  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.dft import dft_power as jax_dft_power  # noqa: E402
from repro.kernels.dirty_delta import max_abs_delta as jax_mad  # noqa: E402
from repro_torch.kernels import autocorr, dft, dirty_delta, ops, ref  # noqa: E402


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("b,n", [(1, 128), (3, 256), (9, 512), (2, 1024)])
def test_power_spectrum_matches_jax_dft(b, n):
    x = _randn(b * n, b, n)
    want = np.asarray(jax_dft_power(jnp.asarray(x)))[:, : n // 2 + 1]
    got = ops.power_spectrum(torch.as_tensor(x)).numpy()
    assert got.shape == (b, n // 2 + 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("b,n", [(3, 128), (5, 512)])
def test_power_spectrum_center_matches_jax_fused(b, n):
    x = _randn(7 + n, b, n) + 3.0              # big DC so the fusion matters
    want = np.asarray(jax_dft_power(jnp.asarray(x), center=True))
    got = ops.power_spectrum(torch.as_tensor(x), center=True).numpy()
    np.testing.assert_allclose(got, want[:, : n // 2 + 1],
                               rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("b,n", [(37, 600), (2, 4096), (4, 2), (3, 7)])
def test_power_spectrum_off_tile_matches_numpy(b, n):
    """N the TPU kernel never took (not a multiple of 128, or > 2048)."""
    x = _randn(n, b, n) + 1.5
    xc = x.astype(np.float64) - x.astype(np.float64).mean(1, keepdims=True)
    f = np.fft.rfft(xc, axis=1)
    want = f.real ** 2 + f.imag ** 2
    got = ops.power_spectrum(torch.as_tensor(x), center=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("j,n,nl", [(1, 128, 3), (7, 256, 8), (12, 512, 17)])
def test_autocorr_matches_jax_kernel(j, n, nl):
    rng = np.random.default_rng(j * n)
    x = rng.standard_normal((j, n)).astype(np.float32)
    x = x - x.mean(axis=1, keepdims=True)
    lags = rng.integers(0, n + 10, nl).astype(np.int32)
    want = np.asarray(jax_autocorr(jnp.asarray(x), jnp.asarray(lags)))
    got = ops.autocorr_score(torch.as_tensor(x), torch.as_tensor(lags))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("j,n", [(37, 600), (3, 4096)])
def test_autocorr_off_tile_matches_numpy(j, n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((j, n)).astype(np.float32)
    x = x - x.mean(axis=1, keepdims=True)
    lags = np.asarray([0, 1, 2, 5, n // 3, n - 1, n, n + 1, n + 100, -3],
                      np.int32)
    got = ops.autocorr_score(torch.as_tensor(x), torch.as_tensor(lags))
    np.testing.assert_allclose(got.numpy(), autocorr_score_ref(x, lags),
                               rtol=2e-4, atol=2e-3)
    assert np.all(got.numpy()[:, 6:9] == 0.0)     # lag >= N scores 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels launch on CUDA tensors or raise; they never hand a CPU
    tensor to the plain version themselves."""
    x = torch.zeros((2, 128))
    with pytest.raises(ValueError):
        dft.power_spectrum(x)
    with pytest.raises(ValueError):
        autocorr.autocorr_score(x, torch.arange(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        dirty_delta.max_abs_delta(x, x)


def test_cpu_dispatch_leaves_launch_counters_at_zero():
    ops.reset_launch_counts()
    x = torch.as_tensor(_randn(1, 4, 256))
    ops.power_spectrum(x, center=True)
    ops.autocorr_score(x, torch.arange(5, dtype=torch.int32))
    ops.dirty_blocks(x, x + 1.0, block=100)
    q = x.reshape(1, 4, 64, 4)
    ops.ssm_scan(q, q, q, -q.abs())
    assert ops.launch_counts() == {"power_spectrum": 0, "autocorr_score": 0,
                                   "dirty_blocks": 0, "ssm_scan": 0,
                                   "flash_attention": 0,
                                   "decode_attention": 0}


def test_dft_table_cache_capped():
    for n in (128, 256, 512, 128):
        ref.dft_tables(n, torch.device("cpu"))
    assert len(ref._TABLE_CACHE) <= ref._TABLE_CACHE_MAX


# ---------------------------------------------------------------------------
# B1's FFT route, in plain torch
# ---------------------------------------------------------------------------
def _b1_fft_arithmetic(x, center):
    """The FFT route of ``csrc/dft_power.cu`` in plain torch: each row on
    its own as (x, 0), its f64 mean subtracted in f32, then one Stockham
    pass per radix of ``dft.fft_plan(N)`` in the kernel's order: butterfly
    j reads j + r N/R, takes twiddle ``(k r N / (Ns R))`` of the table
    ``dft.twiddles`` (k = j mod Ns), runs the radix-R DFT and writes output
    q to (j - k) R + k + q Ns; complex64 throughout."""
    B, N = x.shape
    z = x.clone()
    if center:
        z = x - (x.double().mean(dim=1, keepdim=True)).float()
    z = z.to(torch.complex64)
    tw = torch.complex(*dft.twiddles(N, x.device).unbind(1))
    ns = 1
    for R in dft.fft_plan(N):
        M = N // R
        j = torch.arange(M)
        k = j % ns
        r = torch.arange(R)
        v = z[:, j[:, None] + r[None, :] * M]                 # (B, M, R)
        v = v * tw[k[:, None] * r[None, :] * (N // (ns * R))]
        dft_r = torch.exp(-2j * torch.pi * torch.outer(r, r).double() / R)
        v = v @ dft_r.to(torch.complex64)
        out = torch.empty_like(z)
        out[:, ((j - k) * R + k)[:, None] + r[None, :] * ns] = v
        z, ns = out, ns * R
    f = z[:, : N // 2 + 1]
    return f.real ** 2 + f.imag ** 2


@pytest.mark.parametrize("n,want_plan", [
    (2, [2]), (3, [3]), (4, [4]), (5, [5]), (8, [8]), (16, [8, 2]),
    (512, [8, 8, 8]), (600, [8, 5, 5, 3]), (1440, [8, 4, 5, 3, 3]),
    (2880, [8, 8, 5, 3, 3]), (4096, [8, 8, 8, 8]),
    (16384, [8, 8, 8, 8, 4]), (6561, [3] * 8), (15625, [5] * 6),
    (7, None), (14, None), (1031, None), (16383, None)])
def test_b1_route_and_plan(n, want_plan):
    """Every 5-smooth N takes the FFT route with its radices in the
    kernel's order (8s, a 4 or 2, 5s, 3s), their product N; any other N
    the direct route."""
    plan = dft.fft_plan(n)
    assert plan == want_plan
    assert dft.route(n) == ("direct" if want_plan is None else "fft")
    if plan is not None:
        assert int(np.prod(plan)) == n and len(plan) <= 16


def test_b1_twiddle_table_exact_and_cached():
    """The FFT route's table: W_N^m = exp(-2 pi i m / N) from f64, one per
    N and device, the last few kept."""
    tw = dft.twiddles(600, torch.device("cpu"))
    m = np.arange(600)
    want = np.exp(-2j * np.pi * m / 600)
    assert tw.shape == (600, 2) and tw.dtype == torch.float32
    # within half an f32 ulp of 1 (numpy's f64 and torch's differ in the
    # last f64 bit near 0)
    np.testing.assert_allclose(tw[:, 0].numpy(), want.real, rtol=0,
                               atol=6e-8)
    np.testing.assert_allclose(tw[:, 1].numpy(), want.imag, rtol=0,
                               atol=6e-8)
    assert dft.twiddles(600, torch.device("cpu")) is tw
    for n in range(2, 2 + 2 * dft._TWIDDLE_CACHE_MAX):
        dft.twiddles(n, torch.device("cpu"))
    assert len(dft._TWIDDLES) <= dft._TWIDDLE_CACHE_MAX


def test_b1_paths_send_fft_sizes():
    """The tick's window, FleetSim's Table 3 windows and the window bounds
    all take the FFT route."""
    for n in (512, 600, 1440, 2880, 4096):
        assert dft.route(n) == "fft"


@pytest.mark.parametrize("b,n", [(3, 512), (2, 640), (2, 1920)])
def test_b1_fft_arithmetic_matches_jax_dft(b, n):
    """The FFT route's arithmetic against the Pallas kernel (interpret
    mode; it takes N % 128 == 0): radix 8 alone, with a 5, with 5 and 3s."""
    x = _randn(n + b, b, n) + 3.0
    want = np.asarray(jax_dft_power(jnp.asarray(x), center=True))
    got = _b1_fft_arithmetic(torch.as_tensor(x), True).numpy()
    np.testing.assert_allclose(got, want[:, : n // 2 + 1],
                               rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("n", [512, 600, 1440, 2880, 4096, 3, 15, 45, 243,
                               375, 2025])
@pytest.mark.parametrize("center", [True, False])
def test_b1_fft_arithmetic_matches_numpy(n, center):
    """The paths' N and odd N (radices 3 and 5 alone) against numpy's
    f64 FFT, at the spectrum tolerance, and the plain version's DFT sums."""
    x = _randn(3 * n, 4, n) + 1.5
    x64 = x.astype(np.float64)
    if center:
        x64 = x64 - x64.mean(axis=1, keepdims=True)
    f = np.fft.rfft(x64, axis=1)
    want = f.real ** 2 + f.imag ** 2
    got = _b1_fft_arithmetic(torch.as_tensor(x), center)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-2)
    np.testing.assert_allclose(
        got.numpy(), ref.power_spectrum_ref(torch.as_tensor(x), center),
        rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("n", [512, 1440])
def test_b1_constant_row_gives_zero_power(n):
    """Each row is transformed on its own: a constant 0/1 row beside a
    noisy one still gives P = 0 exactly after mean removal (the cycle
    fit's degenerate-window clamp reads that); packing two rows into one
    complex row would leak the noisy row's rounding into it."""
    x = np.stack([np.ones(n, np.float32), np.zeros(n, np.float32),
                  _randn(n, n) + 0.5])
    got = _b1_fft_arithmetic(torch.as_tensor(x), True).numpy()
    assert (got[:2] == 0).all() and (got[2, 1:] > 0).any()
    z = torch.as_tensor(x[0] + 1j * x[2]).to(torch.complex64)[None]
    Z = torch.fft.fft(z - z.mean(dim=1, keepdim=True)).numpy()[0]
    packed = np.abs(Z + np.conj(np.roll(Z[::-1], 1))) ** 2 / 4
    assert packed[1: n // 2 + 1].max() > 0       # the packed form leaks


# ---------------------------------------------------------------------------
# B2's two routes, in plain torch
# ---------------------------------------------------------------------------
def _tf32(x):
    """f32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    by the kernel's integer rounding of the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b, terms=3):
    """a @ b as the kernel's products: each f32 operand split hi + lo (both
    TF32), lo.hi + hi.lo + hi.hi summed in f32; ``terms=1`` keeps hi.hi
    alone, a plain TF32 product."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    if terms == 3:
        out = out + _tf32(a - ah) @ bh
        out = out + ah @ _tf32(b - bh)
    return out + ah @ bh


def _b2_tc_arithmetic(x, lags, T, LT, terms=3):
    """``csrc/autocorr.cu`` in plain torch: tiles of LT lags, each routed
    by ``autocorr.tile_routes``. A tensor tile at a0 is the Hankel product
    ``G[w, i] = sum_b x[bT + a0 + w] x[bT + i]`` (w < LT + T - 1, the time
    blocks with bT < N - a0, x zero past N) in 3xTF32, then
    ``R[a0 + d] = sum_i G[d + i, i]`` in the order i = 0..T-1; a CUDA tile
    is the direct f32 sums."""
    J, N = x.shape
    lag = [min(max(int(v), 0), N) for v in lags]
    out = torch.zeros((J, len(lag)))
    M = LT + T - 1
    for t, route in enumerate(autocorr.tile_routes(lags, N, LT)):
        l0 = t * LT
        tile = lag[l0:l0 + LT]
        if route == "cuda":
            for k, p in enumerate(tile):
                out[:, l0 + k] = (x[:, : N - p] * x[:, p:]).sum(dim=1)
            continue
        a0 = tile[0]
        kb = -(-(N - a0) // T)
        xp = torch.zeros((J, kb * T + a0 + M))
        xp[:, :N] = x
        b = torch.arange(kb)
        A = xp[:, b[None, :] * T + a0 + torch.arange(M)[:, None]]
        B = xp[:, b[:, None] * T + torch.arange(T)[None, :]]
        G = _mm3(A, B, terms)                              # (J, M, T)
        for d in range(len(tile)):
            s = torch.zeros(J)
            for i in range(T):
                s = s + G[:, d + i, i]
            out[:, l0 + d] = s
    return out


#: SMs of the H100 SXM the plans are sized for
H100_SMS = 132


def _b2_grid(name):
    """(N, lags) of each lag grid the tests send through B2's routes."""
    rng = np.random.default_rng(17)
    if name == "2..256":
        return 512, np.arange(2, 257)
    if name == "N=600":
        return 600, np.arange(2, 302)
    if name == "N=1031":
        return 1031, np.arange(2, 516)
    if name == "straddles N":        # the last tile's lags reach N = 300
        return 300, np.arange(150, 301)
    if name == "N and N+100":        # lags past N clamp to N: not consecutive
        return 300, np.arange(240, 401)
    if name == "negatives":          # -5..0 clamp to 0
        return 512, np.arange(-5, 120)
    assert name == "mixed"           # a consecutive tile, then a scattered one
    lt = autocorr.lag_tiles(200)[1]
    return 1031, np.concatenate([np.arange(2, 2 + lt),
                                 rng.integers(-3, 1041, 200 - lt)])


_B2_ROUTES = {"2..256": ["tensor"] * 3, "N=600": ["tensor"] * 3,
              "N=1031": ["tensor"] * 5, "straddles N": ["tensor"] * 2,
              "N and N+100": ["cuda", "cuda"],
              "negatives": ["cuda", "tensor"], "mixed": ["tensor", "cuda"]}


@pytest.mark.parametrize("jobs", [16384, 3])
@pytest.mark.parametrize("name", list(_B2_ROUTES))
def test_b2_tc_arithmetic_matches_jax_kernel_and_numpy(name, jobs):
    """Both routes' arithmetic against the Pallas kernel (interpret mode)
    and the f64 oracle, at the autocorrelation tolerance, in the tiles a
    launch of ``jobs`` rows takes (large ones for many rows, 9-lag ones
    for a few)."""
    N, lags = _b2_grid(name)
    lags = lags.astype(np.int32)
    x = _randn(N + len(lags), 3, N)
    x = x - x.mean(axis=1, keepdims=True)
    lt = autocorr.plan(jobs, N, len(lags), H100_SMS).lt
    got = _b2_tc_arithmetic(torch.as_tensor(x), lags.tolist(), autocorr.T,
                            lt).numpy()
    want = np.asarray(jax_autocorr(jnp.asarray(x), jnp.asarray(lags)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got, autocorr_score_ref(x, lags),
                               rtol=2e-4, atol=2e-3)
    assert np.all(got[:, np.clip(lags, 0, N) == N] == 0.0)   # lag N scores 0


def test_b2_plain_tf32_misses_the_tolerance():
    """One TF32 product (``terms=1``) keeps ~11 bits: over ~500 products of
    unit rows it misses 2e-4 / 2e-3, which is why the kernel splits."""
    N, lags = _b2_grid("2..256")
    x = _randn(5, 3, N)
    x = x - x.mean(axis=1, keepdims=True)
    want = autocorr_score_ref(x, lags.astype(np.int32))
    lt = autocorr.plan(16384, N, len(lags), H100_SMS).lt
    got3 = _b2_tc_arithmetic(torch.as_tensor(x), lags.tolist(), 8, lt)
    got1 = _b2_tc_arithmetic(torch.as_tensor(x), lags.tolist(), 8, lt,
                             terms=1)
    tol = 2e-4 * np.abs(want) + 2e-3
    assert np.all(np.abs(got3.numpy() - want) <= tol)
    assert np.any(np.abs(got1.numpy() - want) > tol)


@pytest.mark.parametrize("name", list(_B2_ROUTES))
def test_b2_tile_routes(name):
    """The route of each tile a launch of many rows takes."""
    N, lags = _b2_grid(name)
    lt = autocorr.plan(16384, N, len(lags), H100_SMS).lt
    assert autocorr.tile_routes(lags.tolist(), N, lt) == _B2_ROUTES[name]


@pytest.mark.parametrize("L,count,want", [
    (1, 1, (1, 9, 1)), (13, 1, (2, 25, 1)), (64, 1, (5, 73, 1)),
    (121, 1, (8, 121, 1)), (122, 1, (5, 73, 2)), (255, 1, (6, 89, 3)),
    (514, 1, (7, 105, 5)), (8192, 1, (8, 121, 68)), (514, 15, (2, 25, 21)),
    (452, 66, (1, 9, 51)), (8192, 9, (8, 121, 68)), (5, 100, (1, 9, 1))])
def test_b2_lag_tiles(L, count, want):
    """Tiles of 16 MT - 7 lags (a 16 MT-row product less the T - 1 rows
    the diagonals need), as few as 121-lag tiles allow, then as small as
    they can be, then smaller until there are ``count`` of them."""
    mt, lt, tiles = autocorr.lag_tiles(L, count)
    assert (mt, lt, tiles) == want
    assert lt == 16 * mt - (autocorr.T - 1) and (tiles - 1) * lt < L <= \
        tiles * lt


@pytest.mark.parametrize("J,N,L,rows,lt,groups", [
    (16384, 512, 255, 4, 89, 1), (12288, 512, 119, 4, 121, 1),
    (1024, 4096, 64, 1, 9, 1), (8, 1440, 452, 1, 9, 13),
    (64, 16384, 8192, 1, 121, 17), (37, 1031, 514, 1, 9, 15),
    (5000, 16384, 10, 1, 9, 1)])
def test_b2_plan(J, N, L, rows, lt, groups):
    """A block takes 4 rows only when the rows still fill the card and fit
    32 KB; the tiles shrink until every warp of a full card (and of each
    block) has a (row, tile) unit; a small J's tiles spread over blocks,
    a unit a warp."""
    p = autocorr.plan(J, N, L, H100_SMS)
    assert (p.rows, p.lt, p.groups) == (rows, lt, groups)
    assert p.group <= autocorr.MAX_TILES and p.group * p.groups >= p.tiles
    assert (p.group - 1) * p.groups < p.tiles
    units = -(-J // p.rows) * p.rows * p.tiles
    assert p.mt == 1 or units >= (autocorr.WARPS * autocorr.BLOCKS_PER_SM
                                  * H100_SMS)
    assert p.rows * p.group >= min(autocorr.WARPS, p.rows * p.tiles)


def test_b2_plan_follows_the_sm_count():
    """A card with fewer SMs needs fewer units: larger tiles."""
    assert autocorr.plan(64, 1440, 452, 132).lt == 9
    assert autocorr.plan(64, 1440, 452, 32).lt == 57
    assert autocorr.plan(64, 1440, 452, 16).lt == 121


def test_b2_non_finite_rows_reach_their_whole_tensor_tile():
    """The kernel's contract is finite rows: a tensor tile's products take
    the zeros past N, so a NaN reaches every lag of its tile, while the
    plain version poisons only the lags whose sums hold it (here lags past
    256 skip x[256] at N = 512)."""
    N, lags = 512, np.arange(200, 400)
    x = _randn(N, 2, N)
    x[:, 256] = np.nan
    lt = autocorr.plan(16384, N, len(lags), H100_SMS).lt
    routes = autocorr.tile_routes(lags.tolist(), N, lt)
    got = _b2_tc_arithmetic(torch.as_tensor(x), lags.tolist(), autocorr.T,
                            lt).numpy()
    want = autocorr_score_ref(x, lags.astype(np.int32))
    assert routes[0] == "tensor"
    assert np.all(np.isnan(got[:, :lt]))
    assert np.all(np.isnan(want[:, lags <= 256]))
    assert np.all(np.isfinite(want[:, lags > 256]))


# ---------------------------------------------------------------------------
# dirty blocks (pre-copy)
# ---------------------------------------------------------------------------
_NP_TO_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "float64": torch.float64}


def _leaf_pair(seed, n, block, dtype, nan_block=None):
    """(new, old) f32/f64 numpy leaves of n elements: old random, new equal
    to it except in every third block (one element changed) and a block
    that is changed throughout; ``nan_block`` gets a NaN in ``new``."""
    rng = np.random.default_rng(seed)
    wide = np.float64 if dtype == "float64" else np.float32
    old = rng.standard_normal(n).astype(wide)
    new = old.copy()
    nb = -(-n // block)
    for b in range(0, nb, 3):
        i = min(b * block + (b * 7) % block, n - 1)
        new[i] += rng.standard_normal() * 0.5
    new[(nb // 2) * block: (nb // 2 + 1) * block] += 0.25
    if nan_block is not None:
        new[min(nan_block * block + 1, n - 1)] = np.nan
    return new, old


def _as_torch(x, dtype):
    return torch.from_numpy(x.copy()).to(_NP_TO_TORCH[dtype])


def _as_jax(x, dtype):
    # jnp's own f32 -> bf16/f16 rounding is round-to-nearest-even, as
    # torch's; float64 becomes float32 without x64, as astype(float32)
    return jnp.asarray(x, {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                           "float16": jnp.float16,
                           "float64": jnp.float32}[dtype])


def _jax_padded(x, n, block):
    nb = -(-n // block)
    return jnp.pad(x, (0, nb * block - n)).reshape(nb, block)


def _assert_bit_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
@pytest.mark.parametrize("n,block", [(64 * 7, 64), (1000, 129),
                                     (4096 * 3 + 17, 4096), (300, 300),
                                     (5, 64)])
def test_max_abs_delta_bit_equals_jax(dtype, n, block):
    """Flat leaves, the tail block read in place, against the Pallas
    kernel on the zero-padded (n_blocks, block) tiles ``precopy`` builds."""
    new, old = _leaf_pair(n + block, n, block, dtype)
    tn, to = _as_torch(new, dtype), _as_torch(old, dtype)
    jn, jo = _as_jax(new, dtype), _as_jax(old, dtype)
    want = jax_mad(_jax_padded(jn, n, block), _jax_padded(jo, n, block))
    got = ref.max_abs_delta_ref(tn, to, block)
    assert got.shape == (-(-n // block), 1) and got.dtype == torch.float32
    _assert_bit_equal(got.numpy(), want)
    if n % block == 0:                     # the reference's 2-D form
        _assert_bit_equal(ref.max_abs_delta_ref(
            tn.view(-1, block), to.view(-1, block)).numpy(), want)
    mask = ops.dirty_blocks(tn, to, block=block)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jax_ops.dirty_blocks(
            _jax_padded(jn, n, block), _jax_padded(jo, n, block))))
    if mask.numel() >= 3:                  # clean and dirty blocks both seen
        assert 0 < int(mask.sum()) < mask.numel()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dirty_blocks_nan_block_is_not_dirty(dtype):
    """jnp.maximum propagates NaN, so a block with a NaN delta scores NaN,
    and NaN > 0 is False: the reference never marks it dirty."""
    n, block = 64 * 10 + 5, 64
    new, old = _leaf_pair(3, n, block, dtype, nan_block=4)
    tn, to = _as_torch(new, dtype), _as_torch(old, dtype)
    jn, jo = _as_jax(new, dtype), _as_jax(old, dtype)
    want = jax_mad(_jax_padded(jn, n, block), _jax_padded(jo, n, block))
    got = ref.max_abs_delta_ref(tn, to, block)
    assert bool(torch.isnan(got[4, 0])) and int(torch.isnan(got).sum()) == 1
    _assert_bit_equal(got.numpy(), want)
    mask = ops.dirty_blocks(tn, to, block=block)
    assert not bool(mask[4])
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jax_ops.dirty_blocks(
            _jax_padded(jn, n, block), _jax_padded(jo, n, block))))


@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
@pytest.mark.parametrize("n,block", [(64 * 4, 64), (1000, 129)])
def test_dirty_blocks_exact_for_int_and_bool(dtype, n, block):
    rng = np.random.default_rng(n)
    old = rng.integers(0, 2 if dtype is np.bool_ else 1 << 30, n).astype(
        dtype)
    new = old.copy()
    for i in (3, block + 1, n - 1):
        new[i] = not new[i] if dtype is np.bool_ else new[i] + 1
    if dtype is np.int32:                  # equal in f32, distinct in int32
        old[2 * block], new[2 * block] = 16777216, 16777217
    got = ops.dirty_blocks(torch.from_numpy(new), torch.from_numpy(old),
                           block=block)
    want = jax_ops.dirty_blocks(_jax_padded(jnp.asarray(new), n, block),
                                _jax_padded(jnp.asarray(old), n, block))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.bool and int(got.sum()) >= 2


def test_dirty_blocks_threshold():
    new, old = _leaf_pair(5, 640, 64, "float32")
    tn, to = torch.from_numpy(new), torch.from_numpy(old)
    d = ref.max_abs_delta_ref(tn, to, 64)[:, 0]
    for thr in (0.0, 0.1, 0.3):
        np.testing.assert_array_equal(
            ops.dirty_blocks(tn, to, thr, block=64).numpy(),
            (d > thr).numpy())


@pytest.mark.parametrize("block", [64, 129])
def test_dirty_blocks_many_equals_jax_on_each_pair(block):
    """The scan's form for a whole tree: float pairs of every dtype, each
    of its own length and with a NaN block in one, beside int32 and bool
    pairs, each mask that of the reference's ``dirty_blocks`` and each
    count its number of dirty blocks."""
    news, olds, want = [], [], []
    for i, dtype in enumerate(["float32", "bfloat16", "float16", "float64",
                               "float32"]):
        n = 5 * block + 13 * i + 1
        new, old = _leaf_pair(40 + i, n, block, dtype,
                              nan_block=2 if i == 1 else None)
        news.append(_as_torch(new, dtype))
        olds.append(_as_torch(old, dtype))
        want.append(jax_ops.dirty_blocks(
            _jax_padded(_as_jax(new, dtype), n, block),
            _jax_padded(_as_jax(old, dtype), n, block)))
    rng = np.random.default_rng(block)
    for dtype in (np.int32, np.bool_):
        old = rng.integers(0, 2, 3 * block + 5).astype(dtype)
        new = old.copy()
        new[block + 2] = not new[block + 2] if dtype is np.bool_ else 7
        news.append(torch.from_numpy(new))
        olds.append(torch.from_numpy(old))
        want.append(jax_ops.dirty_blocks(
            _jax_padded(jnp.asarray(new), new.size, block),
            _jax_padded(jnp.asarray(old), old.size, block)))
    ops.reset_launch_counts()
    got, counts = ops.dirty_blocks_many(news, olds, block=block)
    assert ops.launch_counts()["dirty_blocks"] == 0
    assert len(got) == len(want) == len(counts)
    for g, w, c in zip(got, want, counts):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert c == int(np.asarray(w).sum())
    assert not bool(got[1][2]) and all(int(g.sum()) >= 1 for g in got)


def test_many_pair_wrapper_refuses_cpu_and_mismatched_pairs():
    x = torch.zeros(256)
    with pytest.raises(ValueError):
        dirty_delta.max_abs_delta_many([x], [x], 64)
    with pytest.raises(ValueError):
        dirty_delta.max_abs_delta_many([x, x], [x], 64)
    with pytest.raises(ValueError):
        dirty_delta.max_abs_delta_many([x], [x], 0)


def test_dirty_blocks_many_card_branch_counts(monkeypatch):
    """The card branch's masks and counts (one cumsum over B3's blocks,
    read at each pair's end), with B3 replaced by its plain version so it
    runs here: pairs of several lengths, an empty one, a NaN block and an
    int32 pair, against ``dirty_blocks`` pair by pair."""
    block = 64
    news, olds = [], []
    for i, n in enumerate([5 * block + 3, 0, block, 7 * block, 2]):
        new, old = _leaf_pair(60 + i, max(n, 1), block, "float32",
                              nan_block=1 if i == 3 else None)
        news.append(torch.from_numpy(new[:n]))
        olds.append(torch.from_numpy(old[:n]))
    news.append(torch.arange(3 * block, dtype=torch.int32))
    olds.append(news[-1].clone())
    olds[-1][block + 5] += 1
    calls = []

    def plain_many(ns, os_, blk):
        calls.append(len(ns))
        return torch.cat([ref.max_abs_delta_ref(a.reshape(-1), b.reshape(-1),
                                                blk)[:, 0]
                          for a, b in zip(ns, os_)])

    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(ops._dd, "max_abs_delta_many", plain_many)
    got, counts = ops.dirty_blocks_many(news, olds, 0.1, block=block)
    monkeypatch.undo()
    assert calls == [5]
    for g, c, n, o in zip(got, counts, news, olds):
        want = ops.dirty_blocks(n, o, 0.1, block=block)
        np.testing.assert_array_equal(g.numpy(), want.numpy())
        assert c == int(want.sum())
    assert counts[1] == 0 and counts[-1] == 1 and sum(counts) > 3


def test_block_deltas_card_branch_splits_one_launch(monkeypatch):
    """The card branch of ``block_deltas`` (B3's maxima for a tree, as
    the train step's telemetry reads them), with B3 replaced by its plain
    version so it runs here: pairs of several lengths and dtypes, an empty
    one and a NaN block go out in one call and come back per pair equal to
    the plain maxima, NaN kept; an integer pair is refused."""
    block = 64
    news, olds = [], []
    for i, (n, dtype) in enumerate([(5 * block + 3, "float32"),
                                    (0, "float32"), (block, "bfloat16"),
                                    (7 * block, "float32"), (2, "float16")]):
        new, old = _leaf_pair(70 + i, max(n, 1), block, dtype,
                              nan_block=1 if i == 3 else None)
        news.append(_as_torch(new, dtype)[:n])
        olds.append(_as_torch(old, dtype)[:n])
    calls = []

    def plain_many(ns, os_, blk):
        calls.append(len(ns))
        return torch.cat([ref.max_abs_delta_ref(a.reshape(-1), b.reshape(-1),
                                                blk)[:, 0]
                          for a, b in zip(ns, os_)])

    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(ops._dd, "max_abs_delta_many", plain_many)
    got = ops.block_deltas(news, olds, block=block)
    with pytest.raises(ValueError):
        ops.block_deltas([torch.zeros(3, dtype=torch.int32)],
                         [torch.ones(3, dtype=torch.int32)], block=block)
    monkeypatch.undo()
    assert calls == [5]
    for g, n, o in zip(got, news, olds):
        want = ref.max_abs_delta_ref(n, o, block)[:, 0]
        assert g.shape == (-(-n.numel() // block),)
        torch.testing.assert_close(g, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got[3][1])) and got[1].numel() == 0
