"""Port kernels on the CPU: the plain versions that ``repro_torch``'s ops
run for CPU tensors, against the JAX package's Pallas kernels (interpret
mode) and the numpy oracles, plus the dispatch-by-device rule.

Tolerances are those of ``tests/test_kernels.py``: spectra rtol 2e-4 /
atol 2e-2, autocorrelation rtol 2e-4 / atol 2e-3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.autocorr import autocorr_score as jax_autocorr  # noqa: E402
from repro.kernels.autocorr import autocorr_score_ref  # noqa: E402
from repro.kernels.dft import dft_power as jax_dft_power  # noqa: E402
from repro_torch.kernels import autocorr, dft, ops, ref  # noqa: E402


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


def test_cpu_dispatch_leaves_launch_counters_at_zero():
    ops.reset_launch_counts()
    x = torch.as_tensor(_randn(1, 4, 256))
    ops.power_spectrum(x, center=True)
    ops.autocorr_score(x, torch.arange(5, dtype=torch.int32))
    assert ops.launch_counts() == {"power_spectrum": 0, "autocorr_score": 0}


def test_dft_table_cache_capped():
    for n in (128, 256, 512, 128):
        ref.dft_tables(n, torch.device("cpu"))
    assert len(ref._TABLE_CACHE) <= ref._TABLE_CACHE_MAX
