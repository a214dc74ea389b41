"""Pre-copy live migration on the port (``repro_torch.core.precopy``),
on the CPU: the invariants of ``tests/test_precopy.py`` run on the port,
and the port's ``migrate`` against the JAX package's on the same seeded
tree and the same sequence of live updates. Rounds, stop reasons, bytes
and modelled times must be equal, and both destinations bit-equal to
their final sources and to each other."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import precopy as jax_precopy  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import precopy, strunk  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402


def _bits(t):
    """A leaf's bytes, for bit-for-bit comparison (NaN and -0 included)."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        return t.tobytes()
    a = np.asarray(t)
    return a.tobytes()


def _tree(rng, scale=1.0):
    return {
        "w1": torch.as_tensor(rng.standard_normal((64, 128)) * scale,
                              dtype=torch.float32),
        "w2": torch.as_tensor(rng.standard_normal((300,)) * scale,
                              dtype=torch.float32).to(torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_migration_is_exact_with_live_updates():
    rng = np.random.default_rng(0)
    state = {"v": _tree(rng)}
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        state["v"]["w1"] = state["v"]["w1"] + 0.01 * calls["n"]
        state["v"]["step"] = state["v"]["step"] + 1

    cfg = precopy.PrecopyConfig(block_elems=64, max_rounds=6,
                                stop_dirty_blocks=0)
    spans.enable()
    try:
        dest, report = precopy.migrate(lambda: state["v"], step, cfg)
    finally:
        spans.disable()
    recorded, _ = spans.drain()
    for a, b in zip(tree.leaves(dest), tree.leaves(state["v"])):
        assert _bits(a) == _bits(b), report
    assert calls["n"] >= 1
    assert report.outcome.rounds <= cfg.max_rounds
    assert report.outcome.bytes_sent >= report.v_mem
    scans = [s for s in recorded if s.name == "precopy.scan"]
    assert len(scans) == len(report.per_round_dirty_bytes)


def test_idle_job_single_round():
    rng = np.random.default_rng(1)
    state = _tree(rng)
    cfg = precopy.PrecopyConfig(block_elems=128)
    dest, report = precopy.migrate(lambda: state, None, cfg)
    assert report.outcome.stop_reason == "dirty_low"
    assert report.outcome.bytes_sent == report.v_mem
    lo, hi = strunk.strunk_bounds(report.v_mem, cfg.bandwidth)
    assert lo <= report.outcome.total_time <= hi


def test_total_cap_stop_condition():
    rng = np.random.default_rng(2)
    state = {"w": torch.as_tensor(rng.standard_normal((4096,)),
                                  dtype=torch.float32)}

    def hot_step():  # dirty everything every round
        state["w"] = state["w"] + 1.0

    cfg = precopy.PrecopyConfig(block_elems=64, max_rounds=29,
                                stop_dirty_blocks=0, stop_total_factor=3.0)
    dest, report = precopy.migrate(lambda: state["w"], hot_step, cfg)
    assert report.outcome.stop_reason in ("total_cap", "max_rounds")
    assert report.outcome.bytes_sent <= (3.0 + 2) * report.v_mem


def test_destination_never_aliases_live_state():
    """A step that writes the live tensors in place (as decode writes its
    KV ring) must not reach the destination: round 0 clones, and merges
    copy only the dirty blocks."""
    rng = np.random.default_rng(4)
    state = _tree(rng)

    def step():
        state["w1"][3, :5] += 1.0              # in place
        state["step"] += 1

    cfg = precopy.PrecopyConfig(block_elems=64, max_rounds=4,
                                stop_dirty_blocks=0)
    dest, report = precopy.migrate(lambda: state, step, cfg)
    for a, b in zip(tree.leaves(dest), tree.leaves(state)):
        assert _bits(a) == _bits(b)
        assert a.data_ptr() != b.data_ptr()
    before = _bits(dest["w1"])
    step()
    assert _bits(dest["w1"]) == before
    # one dirty block of w1 and the step counter per round
    assert report.per_round_dirty_bytes[1:] == [64 * 4 + 64 * 4] * 4


def test_placement_hook_moves_round_zero():
    rng = np.random.default_rng(5)
    state = _tree(rng)
    placed = []

    def place(t):
        placed.append(True)
        return tree.map(lambda x: x.to("cpu", copy=True), t)

    dest, report = precopy.migrate(lambda: state, None,
                                   precopy.PrecopyConfig(block_elems=64),
                                   placement=place)
    assert placed == [True]
    assert all(_bits(a) == _bits(b) for a, b in
               zip(tree.leaves(dest), tree.leaves(state)))


def test_placement_elsewhere_scans_a_source_record():
    """A placement that moves the float leaves to f64 (as one that moves
    them to another device) gets a source-side record to scan: the rounds
    and bytes equal an unplaced run's, only dirty blocks reach the f64
    destination, and it ends equal to the live state."""
    runs = []
    for place in (None, lambda t: tree.map(
            lambda x: x.double() if x.is_floating_point() else x.clone(), t)):
        state = _tree(np.random.default_rng(6))
        n = {"k": 0}

        def step():
            n["k"] += 1
            state["w1"][n["k"] % 64, :7] += 0.5
            state["step"] += 1

        cfg = precopy.PrecopyConfig(block_elems=64, max_rounds=5,
                                    stop_dirty_blocks=0)
        dest, report = precopy.migrate(lambda: state, step, cfg,
                                       placement=place)
        runs.append((report.per_round_dirty_bytes, report.outcome))
        for a, b in zip(tree.leaves(dest), tree.leaves(state)):
            assert torch.equal(a.to(b.dtype), b)
    assert runs[0] == runs[1]
    assert dest["w1"].dtype == torch.float64


def test_dirty_scan_refuses_a_shadow_on_another_device():
    live = {"w": torch.zeros(8)}
    with pytest.raises(ValueError, match="one device"):
        precopy.dirty_scan(live, {"w": torch.zeros(8, device="meta")}, 4)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
def _update_sequence(seed, n_steps):
    """Seeded numpy leaves and the live value of each after every step.
    Each step dirties a few rows of ``a`` (f32), sometimes the tail of
    ``b`` (bf16 bits via f32), always the int32 counter; it stops
    dirtying after ``n_steps - 2`` steps so that dirty_low can fire."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((48, 100)).astype(np.float32)
    b = rng.standard_normal((333,)).astype(np.float32)
    c = np.asarray(3, np.int32)
    seq = [{"a": a, "b": b, "c": c}]
    for s in range(n_steps):
        a, b, c = a.copy(), b.copy(), c.copy()
        if s < n_steps - 2:
            rows = rng.choice(48, size=1 + s % 4, replace=False)
            a[rows, rng.integers(0, 100)] += 1.0 + s
            if s % 2:
                b[-5:] -= 0.5
            c = c + 1
        seq.append({"a": a, "b": b, "c": c})
    return seq


def _jax_leaf(k, v):
    return jnp.asarray(v, jnp.bfloat16 if k == "b" else v.dtype)


def _torch_leaf(k, v):
    t = torch.from_numpy(np.array(v))
    return t.to(torch.bfloat16) if k == "b" else t


#: (seed, steps, max_rounds, stop_dirty_blocks, stop_total_factor): one
#: case per stop reason (dirty_low, max_rounds, total_cap)
CASES = [(0, 12, 29, 2, 3.0), (1, 12, 4, 0, 3.0), (2, 30, 29, 0, 1.2)]


def _cfg_kw(max_rounds, stop_dirty, factor):
    return dict(block_elems=128, max_rounds=max_rounds,
                stop_dirty_blocks=stop_dirty, stop_total_factor=factor)


@pytest.mark.parametrize("seed,n_steps,max_rounds,stop_dirty,factor", CASES)
def test_migrate_matches_jax(seed, n_steps, max_rounds, stop_dirty, factor):
    seq = _update_sequence(seed, n_steps)
    cfg_kw = _cfg_kw(max_rounds, stop_dirty, factor)

    def run(pc, to_leaf):
        box = {"i": 0, "s": {k: to_leaf(k, v) for k, v in seq[0].items()}}

        def step():
            box["i"] = min(box["i"] + 1, len(seq) - 1)
            box["s"] = {k: to_leaf(k, v) for k, v in seq[box["i"]].items()}

        dest, rep = pc.migrate(lambda: box["s"], step,
                               pc.PrecopyConfig(**cfg_kw))
        return dest, rep, box["s"]

    jd, jr, jlive = run(jax_precopy, _jax_leaf)
    td, tr, tlive = run(precopy, _torch_leaf)
    jo, to = jr.outcome, tr.outcome
    assert (to.rounds, to.stop_reason) == (jo.rounds, jo.stop_reason)
    assert tr.per_round_dirty_bytes == jr.per_round_dirty_bytes
    assert tr.v_mem == jr.v_mem
    assert (to.bytes_sent, to.downtime, to.total_time) == \
        (jo.bytes_sent, jo.downtime, jo.total_time)
    for a, b in zip(tree.leaves(td), tree.leaves(tlive)):
        assert _bits(a) == _bits(b)
    for a, b in zip(jax.tree.leaves(jd), jax.tree.leaves(jlive)):
        assert _bits(a) == _bits(b)
    for a, b in zip(tree.leaves(td), jax.tree.leaves(jd)):
        assert _bits(a) == _bits(b)


def test_stop_reasons_covered_by_parity_cases():
    reasons = []
    for seed, n_steps, max_rounds, stop_dirty, factor in CASES:
        seq = _update_sequence(seed, n_steps)
        box = {"i": 0}

        def get():
            return {k: _torch_leaf(k, v) for k, v in seq[box["i"]].items()}

        def step():
            box["i"] = min(box["i"] + 1, len(seq) - 1)

        _, rep = precopy.migrate(get, step, precopy.PrecopyConfig(
            **_cfg_kw(max_rounds, stop_dirty, factor)))
        reasons.append(rep.outcome.stop_reason)
    assert reasons == ["dirty_low", "max_rounds", "total_cap"], reasons


def test_tree_leaves_follow_jax_order():
    """Sorted dict keys, list and tuple order, None as an empty subtree:
    the order per-leaf dirty masks are matched in."""
    shape = {"z": [np.zeros(2), (np.ones(3), None)], "a": {"y": np.zeros(1),
                                                         "b": np.ones(4)},
             "m": np.full(5, 2.0)}
    want = [np.asarray(l).tolist() for l in jax.tree.leaves(shape)]
    as_torch = {"z": [torch.zeros(2), (torch.ones(3), None)],
                "a": {"y": torch.zeros(1), "b": torch.ones(4)},
                "m": torch.full((5,), 2.0)}
    assert [t.tolist() for t in tree.leaves(as_torch)] == want
    doubled = tree.map(lambda t: t * 2, as_torch)
    assert isinstance(doubled["z"][1], tuple) and doubled["z"][1][1] is None
    assert [t.tolist() for t in tree.leaves(doubled)] == \
        [[2 * v for v in l] for l in want]
    with pytest.raises(TypeError):
        tree.leaves({"x": 1.0})
