"""The port's checkpoints, trainer and elastic rescale on the CPU against
the JAX package: the store's on-disk format read both ways (bf16 through
its bits), incremental deltas equal to the reference's block for block,
restore after an injected failure as ``tests/test_checkpoint.py`` runs it,
the live pre-copy of a training job as ``tests/test_system.py`` runs it,
and the training launcher.

Everything here is exact: restored leaves bit for bit, delta block
indices, dtype names and bytes, rounds, stop reasons and per-round dirty
bytes. The final loss of the port's restored trainer equals the port's
uninterrupted run bit for bit (same seed, same batches, same CPU)."""
import json
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import precopy as jax_precopy  # noqa: E402
from repro.data import make_batch as jax_batch  # noqa: E402
from repro.train import init_train_state as jax_init  # noqa: E402
from repro.train import make_train_step as jax_step  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    IncrementalCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import precopy  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.runtime.elastic import rescale  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread each, as the suite runs its files
    in parallel worker processes (restored after this module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    """A leaf's bytes, for bit-for-bit comparison."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


def _assert_bit_equal(a, b):
    la = tree.leaves(a) if not _is_jax(a) else jax.tree.leaves(a)
    lb = tree.leaves(b) if not _is_jax(b) else jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert tuple(x.shape) == tuple(y.shape)
        assert _bits(x) == _bits(y)


def _is_jax(t):
    return not isinstance(jax.tree.leaves(t)[0], torch.Tensor)


def _to_torch(jtree):
    def leaf(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())
    return jax.tree.map(leaf, jtree)


def _jax_state(seed=0, scale=1.0):
    """``tests/test_checkpoint.py``'s state: bf16 and f32 params, an int32
    step."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(rng.standard_normal((32, 48)) * scale,
                                    jnp.bfloat16),
                   "b": jnp.asarray(rng.standard_normal((48,)), jnp.float32)},
        "step": jnp.asarray(int(scale * 10), jnp.int32),
    }


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------
def test_roundtrip(tmp_path):
    s = _to_torch(_jax_state())
    s["params"]["h"] = torch.arange(6, dtype=torch.float16).reshape(2, 3)
    save_checkpoint(str(tmp_path), 5, s)
    assert latest_step(str(tmp_path)) == 5
    like = tree.map(lambda t: t.to("meta"), s)
    r = restore_checkpoint(str(tmp_path), 5, like, device="cpu")
    _assert_bit_equal(s, r)
    assert r["params"]["w"].dtype == torch.bfloat16
    assert r["step"].dtype == torch.int32 and r["step"].dim() == 0
    man = json.loads((tmp_path / "step_00000005" / "manifest.json")
                     .read_text())
    assert {k: v["dtype"] for k, v in man["leaves"].items()} == {
        "params/b": "float32", "params/h": "float16",
        "params/w": "bfloat16", "step": "int32"}


def test_async_checkpointer_keeps_latest(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    live = _to_torch(_jax_state(scale=10))
    for step in (10, 20, 30):
        live = _to_torch(_jax_state(scale=step))
        ck.save(step, live)
        live["params"]["b"].add_(1.0)      # in place after save: not saved
    ck.wait()
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [20, 30]
    like = _to_torch(_jax_state())
    r = restore_checkpoint(str(tmp_path), 30, like, device="cpu")
    _assert_bit_equal(_to_torch(_jax_state(scale=30)), r)


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """A train state written by ``repro`` is read bit for bit by the port,
    and the port's write is read bit for bit by ``repro``."""
    jc = jax_config("h2o_danube3_4b").smoke()
    js = jax.jit(jax_init, static_argnums=0)(jc, jax.random.key(0))
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 3, js)
    like = init_train_state(get_config("h2o_danube3_4b").smoke(), 0,
                            device="meta")
    ts = restore_checkpoint(str(tmp_path / "jax"), 3, like, device="cpu")
    _assert_bit_equal(js, ts)
    save_checkpoint(str(tmp_path / "torch"), 4, ts)
    back = jax_ckpt.restore_checkpoint(str(tmp_path / "torch"), 4,
                                       jax.eval_shape(lambda: js))
    _assert_bit_equal(js, back)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                         jax.tree.leaves(js)):
        assert a.dtype == b.dtype, p


# ---------------------------------------------------------------------------
# incremental checkpoints
# ---------------------------------------------------------------------------
def _delta_sequence():
    """A base state and three later ones: one block touched, a ragged
    tail touched, nothing touched."""
    s0 = _jax_state()
    s1 = jax.tree.map(lambda x: x, s0)
    s1["params"]["w"] = s0["params"]["w"].at[0, 0].add(jnp.bfloat16(1.0))
    s1["step"] = s0["step"] + 1
    s2 = jax.tree.map(lambda x: x, s1)
    s2["params"]["b"] = s1["params"]["b"].at[47].set(0.5)
    s2["params"]["w"] = s1["params"]["w"].at[31, 40].set(2.0)
    s2["step"] = s1["step"] + 1
    s3 = jax.tree.map(lambda x: x, s2)
    return [s0, s1, s2, s3]


def test_incremental_deltas_match_jax(tmp_path):
    states = _delta_sequence()
    jinc = jax_ckpt.IncrementalCheckpointer(str(tmp_path / "jax"),
                                            block_elems=32, full_every=100)
    tinc = IncrementalCheckpointer(str(tmp_path / "torch"), block_elems=32,
                                   full_every=100)
    for step, s in enumerate(states):
        js = jinc.save(step, s)
        ts = tinc.save(step, _to_torch(s))
        assert ts == js, step
        if step:
            man = [json.loads((tmp_path / pkg / f"delta_{step:08d}"
                               / "manifest.json").read_text())
                   for pkg in ("jax", "torch")]
            assert man[0] == man[1]
            for key, meta in man[0]["leaves"].items():
                a, b = ((tmp_path / pkg / f"delta_{step:08d}" / meta["file"])
                        .read_bytes() for pkg in ("jax", "torch"))
                assert jax_ckpt.store.decompress_bytes(a, man[0]["codec"]) \
                    == jax_ckpt.store.decompress_bytes(b, man[1]["codec"])
    like = _to_torch(states[0])
    for step, s in enumerate(states):
        _assert_bit_equal(s, tinc.restore(step, like, device="cpu"))
        # each package restores the other's directory
        _assert_bit_equal(s, jinc.restore(step, jax.eval_shape(lambda: s)))
        other = IncrementalCheckpointer(str(tmp_path / "jax"),
                                        block_elems=32)
        _assert_bit_equal(s, other.restore(step, like, device="cpu"))


def test_incremental_full_every(tmp_path):
    inc = IncrementalCheckpointer(str(tmp_path), block_elems=32,
                                  full_every=2)
    kinds = [inc.save(i, _to_torch(_jax_state(scale=1 + i)))["kind"]
             for i in range(5)]
    assert kinds == ["full", "delta", "delta", "full", "delta"]
    r = inc.restore(4, _to_torch(_jax_state()), device="cpu")
    _assert_bit_equal(_to_torch(_jax_state(scale=5)), r)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def test_trainer_restores_after_failure(tmp_path):
    """``tests/test_checkpoint.py``'s integration on the port: the job is
    killed at step 7, restores from the step-5 checkpoint and reaches step
    12; its loss then equals an uninterrupted run's bit for bit."""
    cfg = get_config("internlm2_1p8b").smoke().replace(num_layers=2)
    failed = {"done": False}

    def failure_hook(step):
        if step == 7 and not failed["done"]:
            failed["done"] = True
            return True
        return False

    tcfg = TrainerConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=5,
                         telemetry=False)
    tr = Trainer(cfg, tcfg, batch=2, seq=32, failure_hook=failure_hook,
                 device="cpu")
    out = tr.run(12)
    assert out["restarts"] == 1
    assert out["final_step"] == 12
    assert np.isfinite(out["loss"])
    ref = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "b"),
                                     ckpt_every=5, telemetry=True),
                  batch=2, seq=32, device="cpu").run(12)
    assert ref["loss"] == out["loss"]
    assert len(ref["history"]) == 12
    assert all(0.0 <= h["dirty_fraction"] <= 1.0 for h in ref["history"])


def test_trainer_nan_restore_waits_for_the_pending_save(tmp_path,
                                                      monkeypatch):
    """A NaN right after a checkpoint restores only once the asynchronous
    write has landed: with a write slowed to outlast two steps, the
    restore neither trips over the write's ``.tmp`` directory nor misses
    the step it is writing."""
    import time

    from repro_torch.checkpoint import store

    save = store.save_checkpoint

    def slow(directory, step, state):
        (tmp_path / f"step_{step:08d}.tmp").mkdir(exist_ok=True)
        time.sleep(0.5)
        return save(directory, step, state)

    monkeypatch.setattr(store, "save_checkpoint", slow)
    cfg = get_config("internlm2_1p8b").smoke().replace(num_layers=1)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                    telemetry=False, max_nan_restarts=1),
                 batch=2, seq=16, device="cpu")
    step_fn, calls = tr.step_fn, {"n": 0}

    def poisoned(state, batch):
        calls["n"] += 1
        state, m = step_fn(state, batch)
        if calls["n"] == 3:                  # the step after the save
            m = dict(m, loss=torch.tensor(float("nan")))
        return state, m

    tr.step_fn = poisoned
    out = tr.run(4)
    assert out["restarts"] == 1 and out["final_step"] == 4
    assert calls["n"] == 3 + 2               # replayed from step 2


def test_trainer_restores_from_a_nan(tmp_path):
    """A NaN loss restores the last checkpoint and replays; past
    ``max_nan_restarts`` it raises."""
    cfg = get_config("internlm2_1p8b").smoke().replace(num_layers=1)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                    telemetry=False, max_nan_restarts=1),
                 batch=2, seq=16, device="cpu")
    step_fn, calls = tr.step_fn, {"n": 0}

    def poisoned(state, batch):
        calls["n"] += 1
        state, m = step_fn(state, batch)
        if calls["n"] == 4:
            m = dict(m, loss=torch.tensor(float("nan")))
        return state, m

    tr.step_fn = poisoned
    out = tr.run(5)
    assert out["restarts"] == 1 and out["final_step"] == 5
    tr2 = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "x"),
                                     telemetry=False, max_nan_restarts=0),
                  batch=2, seq=16, device="cpu")
    tr2.step_fn = lambda s, b: (s, {"loss": torch.tensor(float("nan"))})
    with pytest.raises(FloatingPointError):
        tr2.run(1)


# ---------------------------------------------------------------------------
# live pre-copy of a training job (elastic rescale, quickstart step 4)
# ---------------------------------------------------------------------------
def _tiny(get):
    return get("internlm2_1p8b").smoke().replace(
        num_layers=2, d_model=64, d_ff=128, num_heads=2, num_kv_heads=1,
        d_head=32, vocab_size=128, learning_rate=1e-3)


def test_elastic_rescale_matches_jax():
    """``tests/test_system.py``'s elastic flow in both packages from the
    same state: rounds, stop reason and every round's dirty bytes equal,
    each destination bit-equal to its source at handoff and to the other
    package's, and the destination trains on."""
    jc, tc = _tiny(jax_config), _tiny(get_config)
    js0 = jax.jit(jax_init, static_argnums=0)(jc, jax.random.key(2))
    jstep = jax.jit(jax_step(jc))
    box = {"s": js0}

    def do_step():
        batch = jax_batch(jc, 2, 32, step=int(box["s"]["step"]))
        box["s"], _ = jstep(box["s"], batch)

    pcfg = dict(block_elems=1 << 12, max_rounds=4, stop_dirty_blocks=0)
    jdest, jrep = jax_precopy.migrate(lambda: box["s"], do_step,
                                      jax_precopy.PrecopyConfig(**pcfg))
    _assert_bit_equal(jdest, box["s"])

    tstep = make_train_step(tc)
    steps = []

    def step_once(s):
        steps.append(int(s["step"]))
        s, _ = tstep(s, make_batch(tc, 2, 32, step=int(s["step"]),
                                   device="cpu"))
        return s

    ts0 = convert.train_state_from_numpy(tc, jax.tree.map(np.asarray, js0),
                                         device="cpu")
    tdest, rep = rescale(tc, ts0, step_once, "cpu",
                         pcfg=precopy.PrecopyConfig(**pcfg))
    assert rep.src_devices == rep.dst_devices == 1
    t_out, j_out = rep.precopy.outcome, jrep.outcome
    assert (t_out.rounds, t_out.stop_reason) == (j_out.rounds,
                                                 j_out.stop_reason)
    assert t_out.rounds >= 1
    assert rep.precopy.per_round_dirty_bytes == [
        int(b) for b in jrep.per_round_dirty_bytes]
    assert rep.precopy.v_mem == jrep.v_mem
    assert steps == list(range(len(steps)))
    assert int(tdest["step"]) == int(jdest["step"]) == len(steps)
    # the destination is its own copy; it trains on from the same step
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(tree.leaves(tdest), tree.leaves(ts0)))
    resumed, m = tstep(tdest, make_batch(tc, 2, 32, step=int(tdest["step"]),
                                         device="cpu"))
    assert int(resumed["step"]) == int(jdest["step"]) + 1
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def test_train_launcher_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --device cpu``, run as
    ``__main__`` in this process."""
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--steps", "4", "--batch", "2", "--seq",
        "16", "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir",
        str(tmp_path)])
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and lines[0].startswith("step=1 loss=")
    assert json.loads(lines[-1])["final_step"] == 4
    assert latest_step(str(tmp_path)) == 4


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``device=None`` is the card: without one, every entry point raises
    instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2_1p8b").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)))
    save_checkpoint(str(tmp_path), 1, _to_torch(_jax_state()))
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_checkpoint(str(tmp_path), 1, _to_torch(_jax_state()))
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main([])
