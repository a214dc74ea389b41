"""Port cycle fit (Algorithm 1) and Algorithm 2 on the CPU against the JAX
package: periods and profiles equal, confidence within rtol 1e-4, and
RemainTime exact.

``fit_cycle_batch`` is held to two references: the JAX package's kernel
path (``force_backend("tpu")``: Pallas DFT and autocorrelation kernels in
interpret mode, which is what the port's kernels replace) and its default
numpy path (pocketfft spectrum, Wiener-Khinchin refinement)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cycles as jcycles  # noqa: E402
from repro.core import postpone as jpp  # noqa: E402
from repro.kernels.backend import force_backend  # noqa: E402
from repro_torch.core import cycles as tcycles  # noqa: E402
from repro_torch.core import postpone as tpp  # noqa: E402

CPU = "cpu"


def _planted(period, reps, duty):
    lm_len = max(1, int(period * duty))
    pattern = np.array([1] * lm_len + [0] * (period - lm_len), np.int8)
    return np.tile(pattern, reps)


PLANTED = [_planted(p, r, d) for p, r, d in
           [(4, 4, 0.2), (7, 5, 0.5), (12, 8, 0.6), (24, 12, 0.3),
            (40, 6, 0.8), (48, 4, 0.5), (48, 12, 0.25), (9, 12, 0.45)]]
PLANTED.append(np.tile([1, 1, 0, 1, 1, 1, 0, 0], 10).astype(np.int8))


def _noisy_fleet(n, J, seed):
    """LM series of cyclic jobs with 5% classifier flips."""
    rng = np.random.default_rng(seed)
    rows = []
    for j in range(J):
        period = int(rng.integers(6, n // 4))
        patt = (np.arange(period) < period * rng.uniform(0.3, 0.8))
        s = np.tile(patt, n // period + 1)[:n].astype(np.int8)
        s = np.roll(s, int(rng.integers(0, period)))
        flip = rng.random(n) < 0.05
        rows.append(np.where(flip, 1 - s, s).astype(np.int8))
    return np.stack(rows)


def _assert_same_models(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.period == w.period
        np.testing.assert_array_equal(g.profile_lm, w.profile_lm)
        np.testing.assert_array_equal(g.array_lm, w.array_lm)
        np.testing.assert_array_equal(g.array_nlm, w.array_nlm)
        np.testing.assert_allclose(g.confidence, w.confidence, rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("series", PLANTED,
                         ids=[f"n{len(s)}" for s in PLANTED])
def test_fit_cycle_planted_matches_numpy_path(series):
    want = jcycles.fit_cycle(series)
    got = tcycles.fit_cycle(series, device=CPU)
    _assert_same_models([got], [want])
    assert tcycles.cycle_length(series.astype(np.float32), device=CPU) == \
        pytest.approx(jcycles.cycle_length(series.astype(np.float32)),
                      rel=1e-4)


@pytest.mark.parametrize("folded", [False, True])
def test_fit_cycle_batch_planted_matches_jax_kernel_path(folded):
    J = len(PLANTED)
    n = max(len(s) for s in PLANTED)
    X = np.stack([np.resize(s, n) for s in PLANTED]).astype(np.int8)
    with force_backend("tpu"):
        want = jcycles.fit_cycle_batch(X, folded=folded)
    got = tcycles.fit_cycle_batch(torch.as_tensor(X), folded=folded)
    assert len(got) == J
    _assert_same_models(got, want)


@pytest.mark.parametrize("n,J", [(128, 12), (512, 24)])
def test_fit_cycle_batch_fleet_matches_both_references(n, J):
    X = _noisy_fleet(n, J, seed=n)
    with force_backend("tpu"):
        want_kernel = jcycles.fit_cycle_batch(X)
    want_numpy = jcycles.fit_cycle_batch(X)
    got = tcycles.fit_cycle_batch(X, device=CPU)
    _assert_same_models(got, want_kernel)
    _assert_same_models(got, want_numpy)


def test_fit_cycle_batch_constant_rows_match_numpy_path():
    """Constant windows have no DC-removed mass at all: no cycle, and the
    degenerate-mass clamp (the Pallas path's float residue can still pick
    a spurious peak there, so only the exact numpy path is compared)."""
    X = np.concatenate([_noisy_fleet(256, 3, seed=1),
                        np.ones((1, 256), np.int8),
                        np.zeros((1, 256), np.int8)])
    got = tcycles.fit_cycle_batch(X, device=CPU)
    _assert_same_models(got, jcycles.fit_cycle_batch(X))
    assert [m.period for m in got[-2:]] == [0, 0]
    assert [m.profile_lm.tolist() for m in got[-2:]] == [[1], [0]]


def _batches():
    n = max(len(s) for s in PLANTED)
    planted = np.stack([np.resize(s, n) for s in PLANTED]).astype(np.int8)
    return {"planted": planted, "fleet128": _noisy_fleet(128, 12, seed=128),
            "fleet512": _noisy_fleet(512, 24, seed=512),
            "constant": np.concatenate([_noisy_fleet(256, 3, seed=1),
                                        np.ones((1, 256), np.int8),
                                        np.zeros((1, 256), np.int8)])}


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("name", ["planted", "fleet128", "fleet512",
                                  "constant"])
def test_fit_cycle_rows_matches_the_list_view_and_references(name, folded):
    """The batched core's periods, confidences and Algorithm 2 profiles
    (``profile_rows``) against the list view's ``CycleModel``s and both
    references' lists, packed by the reference's ``pack_fleet``. The constant rows'
    spurious Pallas peak (above) leaves only the numpy path there."""
    X = _batches()[name]
    fits = tcycles.fit_cycle_rows(torch.as_tensor(X))
    np.testing.assert_array_equal(fits.host, X)
    listed = tcycles.fit_cycle_batch(X, folded=folded, device=CPU)
    wants = [listed, jcycles.fit_cycle_batch(X, folded=folded)]
    if name != "constant":
        with force_backend("tpu"):
            wants.append(jcycles.fit_cycle_batch(X, folded=folded))
    profiles = tcycles.profile_rows(torch.as_tensor(X), fits.period,
                                    folded=folded)
    for want in wants:
        np.testing.assert_array_equal(fits.period, [m.period for m in want])
        np.testing.assert_allclose(fits.confidence,
                                   [m.confidence for m in want],
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(profiles.numpy(), np.asarray(
            jpp.pack_fleet(want)[0]))
    np.testing.assert_array_equal(
        fits.confidence, np.asarray([m.confidence for m in listed],
                                    np.float32))
    for j, m in enumerate(listed):
        view = tcycles.model_view(X[j], int(fits.period[j]),
                                  float(fits.confidence[j]), folded=folded)
        _assert_same_models([view], [m])


def test_profile_rows_folds_each_row_over_its_own_length():
    """Rows padded past their series: the folded vote counts only each
    row's whole cycles inside its own length, as ``fold_profile`` of the
    unpadded row does."""
    rng = np.random.default_rng(7)
    lengths = np.asarray([64, 40, 33, 64, 17])
    period = np.asarray([6, 7, 5, 0, 4])
    rows = (rng.random((5, 64)) < 0.5).astype(np.int8)
    got = tcycles.profile_rows(torch.as_tensor(rows), period, folded=True,
                               lengths=lengths).numpy()
    assert got.shape == (5, 7)
    for j in range(5):
        want = np.full(7, -1, np.int8)
        if period[j] > 1:
            want[:period[j]] = tcycles.fold_profile(rows[j, :lengths[j]],
                                                    int(period[j]))
        np.testing.assert_array_equal(got[j], want)


def test_power_spectrum_public_view():
    s = np.sin(2 * np.pi * np.arange(512) / 32).astype(np.float32)
    p = tcycles.power_spectrum(s, device=CPU)
    assert p.shape == (257,) and int(np.argmax(p[1:])) + 1 == 512 // 32


def _models(seed, J=40):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(J):
        period = int(rng.integers(0, 30))
        if period <= 1:
            prof = np.asarray([int(rng.integers(0, 2))], np.int8)
        elif j % 7 == 0:
            prof = np.zeros(period, np.int8)            # all-NLM: backoff
        else:
            prof = (rng.random(period) < 0.5).astype(np.int8)
        idx = np.arange(len(prof))
        out.append(jcycles.CycleModel(period, 1.0, prof, idx[prof == 1],
                                      idx[prof != 1]))
    return out


def test_postpone_batch_exact():
    models = _models(0)
    m_now = np.random.default_rng(1).integers(-50, 10_000, len(models) + 9)
    jp, jper = jpp.pack_fleet(models, n_jobs=len(models) + 9, p_max=64)
    want = np.asarray(jpp.postpone_batch(jp, jper, jnp.asarray(
        m_now, jnp.int32)))
    tmodels = [tcycles.CycleModel(m.period, m.confidence, m.profile_lm,
                                  m.array_lm, m.array_nlm) for m in models]
    tp, tper = torch.as_tensor(np.array(jp)), torch.as_tensor(
        np.array(jper))
    got = tpp.postpone_batch(tp, tper, torch.as_tensor(m_now, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got.numpy()[len(models):] == 0)      # padding rows
    for m, tm, mn in zip(models, tmodels, m_now):
        assert tpp.postpone(tm, int(mn)) == jpp.postpone(m, int(mn))
