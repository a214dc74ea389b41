"""The port's sharded decide plane (``core/shard.py``, ``kernels.ops`` with
a mesh, ``SurveillanceEngine(shards=k)``) on ranks of a ``gloo`` group on
the CPU, against its unsharded path and against the JAX package's tick.

One pair of groups for the module (``torch_dist_worker.launch``): world 2
(a 2-rank mesh) and world 4 (a 2-rank mesh, whose ranks 2 and 3 lie
outside it and compute every row themselves, and a 4-rank mesh). Every
rank runs every case and writes what it got; the tests read the files.
This mirrors ``tests/test_shard.py``'s cases.

Exact: sharded against unsharded inside the port, every array bit for bit
(LM series, periods, profiles, RemainTime, ``scheduled_at`` = the tick's
step + RemainTime, confidences, refit counts, ``next_refresh_step``), on
every rank. Against the JAX package's unsharded tick: the integers exact,
confidences within ``tests/test_torch_surveillance.py``'s rtol 1e-4 /
atol 1e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402

from repro.core.fleetsim import make_training_nb as jax_training_nb  # noqa: E402
from repro.core.fleetsim import table3_traces  # noqa: E402
from repro.core.surveillance import SurveillanceEngine as JaxEngine  # noqa: E402
from repro.core.telemetry import FleetTelemetry as JaxFleet  # noqa: E402
from repro_torch.core import shard  # noqa: E402

WORLDS = (2, 4)
TICKS = len(W.SHARD_RECORDS) + 1
INTS = ("remain", "scheduled_at", "refitted", "fleet", "period", "profile",
        "lm_series", "fitted_step", "origin_step")


def _samples(steps, J, seed=0):
    """(steps, J, F) load indexes of Table 3 traces (4 s phases), de-phased
    per job."""
    rng = np.random.default_rng(seed)
    traces = list(table3_traces(phase_s=4.0).values())
    t0 = rng.uniform(0, 60, J)
    out = np.empty((steps, J, 6))
    for j in range(J):
        tr = traces[j % len(traces)]
        for s in range(steps):
            out[s, j] = list(tr.sample_indexes(t0[j] + s, rng).values())
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs written, both groups run; returns (workdir, inputs, JAX nb)."""
    work = tmp_path_factory.mktemp("shard")
    rng = np.random.default_rng(3)
    jnb = jax_training_nb()
    inp = {"nb_edges": np.asarray(jnb.bin_edges),
           "nb_ll": np.asarray(jnb.log_likelihood),
           "nb_prior": np.asarray(jnb.log_prior),
           "rows": rng.standard_normal((5, 256)).astype(np.float32),
           "vals": _samples(W.SHARD_STEPS, W.SHARD_J)}
    for J in (4, 7):
        inp[f"windows{J}"] = rng.random((J, 64, 6))
    for J in (6, 9):
        inp[f"profiles{J}"] = rng.integers(-1, 2, (J, 16)).astype(np.int8)
        inp[f"periods{J}"] = rng.integers(0, 17, J).astype(np.int32)
        inp[f"m_now{J}"] = rng.integers(0, 500, J).astype(np.int32)
    np.savez(work / "inputs.npz", **inp)
    W.launch([("shard", w) for w in WORLDS], work)
    return work, inp, jnb


def _ranks(work, world):
    return [W.load("shard", world, r, work) for r in range(world)]


def _meshes(world):
    return sorted({2, world})


def test_decide_mesh_unsharded_and_refusals(run):
    assert shard.decide_mesh(None) is None
    assert shard.decide_mesh(1) is None
    assert shard.device_count() == 1          # no group in this process
    with pytest.raises(ValueError):
        shard.decide_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):     # the default is the card
            shard.decide_mesh(2)
    work, _, _ = run
    for world in WORLDS:
        for f in _ranks(work, world):
            assert int(f["device_count"]) == world
            assert bool(f["too_many_refused"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("J", [4, 7])            # multiple and non-multiple
def test_classify_lm_sharded_parity(run, world, J):
    work = run[0]
    for f in _ranks(work, world):
        for k in _meshes(world):
            np.testing.assert_array_equal(f[f"k{k}_classify{J}"],
                                          f[f"k{k}_classify{J}_ref"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("J", [6, 9])
def test_postpone_rows_sharded_parity(run, world, J):
    work = run[0]
    for f in _ranks(work, world):
        for k in _meshes(world):
            want = f[f"k{k}_postpone{J}_ref"]
            assert want.dtype == np.int32
            np.testing.assert_array_equal(f[f"k{k}_postpone{J}"], want)
            np.testing.assert_array_equal(f[f"k{k}_postpone{J}_async"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_kernel_ops_mesh_row_sharding(run, world):
    work = run[0]
    for f in _ranks(work, world):
        for k in _meshes(world):
            assert f[f"k{k}_spectrum"].shape == (5, 129)
            np.testing.assert_array_equal(f[f"k{k}_spectrum"],
                                          f[f"k{k}_spectrum_ref"])
            np.testing.assert_array_equal(f[f"k{k}_scores"],
                                          f[f"k{k}_scores_ref"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("overlap", [False, True])
def test_tick_bit_parity_across_shard_counts(run, world, overlap):
    """Every tick of the sequence (first fit, slid windows, a blackout,
    recovery, a full refit) on every rank, sharded over 2 and ``world``
    ranks, bit-identical to the unsharded engine's."""
    work = run[0]
    for f in _ranks(work, world):
        for k in _meshes(world):
            for t in range(TICKS):
                pre = f"k{k}_o{int(overlap)}_t{t}_"
                assert bool(f[pre + "pending"]) == overlap
                for name in INTS + ("confidence",):
                    np.testing.assert_array_equal(
                        f[pre + name], f[f"ref_t{t}_{name}"],
                        err_msg=f"world {world} shards {k} tick {t} {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_next_refresh_step_sharded(run, world):
    work = run[0]
    for f in _ranks(work, world):
        want = f[f"ref_t{TICKS - 1}_next_refresh"]
        assert np.isfinite(want).all()
        for k in _meshes(world):
            for o in (0, 1):
                np.testing.assert_array_equal(
                    f[f"k{k}_o{o}_t{TICKS - 1}_next_refresh"], want)


@pytest.fixture(scope="module")
def jax_ticks(run):
    _, inp, jnb = run
    return W.run_ticks(JaxEngine, lambda n, capacity: JaxFleet(
        n, capacity=capacity), inp["vals"], jnb)


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_tick_matches_jax_unsharded_tick(run, jax_ticks, overlap):
    """The port's tick over a 4-rank mesh against the JAX package's
    unsharded tick (whose own tests hold it bit-identical to its sharded
    one)."""
    work = run[0]
    f = W.load("shard", 4, 0, work)
    assert any(int(p) > 1 for p in jax_ticks[0]["period"])
    for t, want in enumerate(jax_ticks):
        pre = f"k4_o{int(overlap)}_t{t}_"
        for name in INTS:
            np.testing.assert_array_equal(f[pre + name], want[name],
                                          err_msg=f"tick {t} {name}")
        np.testing.assert_allclose(f[pre + "confidence"], want["confidence"],
                                   rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(f[f"k4_o{int(overlap)}_t{TICKS - 1}"
                                    "_next_refresh"],
                                  jax_ticks[-1]["next_refresh"])
