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
    assert ops.launch_counts() == {"power_spectrum": 0, "autocorr_score": 0,
                                   "dirty_blocks": 0}


def test_dft_table_cache_capped():
    for n in (128, 256, 512, 128):
        ref.dft_tables(n, torch.device("cpu"))
    assert len(ref._TABLE_CACHE) <= ref._TABLE_CACHE_MAX


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
