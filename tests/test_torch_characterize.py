"""Port NB characterization on the CPU against the JAX package: the model
tables carried over (or refit by the port) and the fleet LM series must be
equal bit for bit, samples lying exactly on bin edges included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import characterize as jchar  # noqa: E402
from repro.core.fleetsim import make_training_nb as jax_training_nb  # noqa: E402
from repro_torch.core import characterize as tchar  # noqa: E402
from repro_torch.core.fleetsim import make_training_nb  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    jnb = jax_training_nb()
    return jnb, make_training_nb(device=CPU)


def _arrays(nb):
    return [np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()
            for a in (nb.bin_edges, nb.log_likelihood, nb.log_prior)]


def test_fit_is_bit_equal(models):
    jnb, tnb = models
    for a, b in zip(_arrays(jnb), _arrays(tnb)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_naive_bayes_from_arrays_is_bit_equal(models):
    jnb, _ = models
    carried = tchar.naive_bayes_from_arrays(
        *[np.asarray(a) for a in (jnb.bin_edges, jnb.log_likelihood,
                                   jnb.log_prior)], device=CPU)
    for a, b in zip(_arrays(jnb), _arrays(carried)):
        np.testing.assert_array_equal(a, b)


def _windows(jnb, seed=0, J=16, T=96):
    """Telemetry-like windows in f64 with a share of samples placed exactly
    on (f32) bin edges, plus values just either side of an edge."""
    rng = np.random.default_rng(seed)
    edges = np.asarray(jnb.bin_edges)                  # (F, nb-1) f32
    F = edges.shape[0]
    scale = np.abs(edges).max(axis=1) + 1e-6
    w = rng.random((J, T, F)) * scale * 1.2
    pick = rng.random((J, T, F)) < 0.3
    which = rng.integers(0, edges.shape[1], (J, T, F))
    on_edge = edges[np.arange(F)[None, None, :], which].astype(np.float64)
    w = np.where(pick, on_edge, w)
    nudge = rng.random((J, T, F)) < 0.1
    return np.where(nudge, np.nextafter(on_edge, np.inf), w)


def test_classify_lm_batch_bit_equal_on_bin_edges(models):
    jnb, tnb = models
    W = _windows(jnb)
    want = jchar.classify_lm_batch(jnb, W)
    got = tchar.classify_lm_batch(tnb, torch.as_tensor(W))
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the same from a host array
    np.testing.assert_array_equal(
        tchar.classify_lm_batch(tnb, W).numpy(), want)


def test_classify_series_matches(models):
    jnb, tnb = models
    W = _windows(jnb, seed=3, J=1, T=200)[0].astype(np.float32)
    jc, jlm, jpost = jchar.classify_series(jnb, W)
    tc, tlm, tpost = tchar.classify_series(tnb, W)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tlm, jlm)
    np.testing.assert_allclose(tpost, jpost, rtol=1e-5, atol=1e-6)
    assert tchar.primary_secondary(tc) == jchar.primary_secondary(jc)
