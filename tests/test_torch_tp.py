"""The port's model on a ``(data, model)`` mesh: the sharding rules against
the JAX package's leaf for leaf, the production mesh, and four ``gloo``
ranks on the CPU (``torch_dist_worker.py``, suite "tp") running the
dense and MoE wirings tensor-parallel on (2, 2) and (1, 4) meshes.

Rules: ``state_specs``, ``batch_specs``, ``cache_specs`` and the hooks'
``constrain_spec`` / ``constrain_logits_spec`` equal the reference's
``state_shardings``, ``batch_shardings``, ``cache_shardings``,
``make_constrain`` and ``make_constrain_logits`` (their
``PartitionSpec``s, read through a stand-in ``NamedSharding``) for every
architecture, on the duck-typed 16 x 16 and 2 x 16 x 16 meshes of
``tests/test_sharding_rules.py`` and on (2, 2) and (1, 4).

Ranks: the f32 smoke configs of internlm2 (dense, block remat), qwen3
(``qk_norm``), danube (a window of 8, so the ring wraps), qwen3-moe
(``moe``) and kimi-k2 (``prefix_dense``, its own ``seq_shard``, full remat,
Adafactor), and on (2, 2) starcoder2, qwen2-vl (M-RoPE positions) and
musicgen (a frontend prefix), weights from the JAX package's ``init_params`` carried across
by ``models/convert.params_from_numpy``. Each rank cuts the train state,
batch and cache with ``launch/sharding``; what it computes is gathered
back (``gather_tree``): one train step's loss, grad norm, every leaf's
gradient and every param and optimizer leaf after the step; a prefill's
last logits and its cache; two decode steps' logits and the cache after
them. On (1, 4) the 2 KV heads do not divide the model axis, so the ring
is cut along its window and decode merges the blocks' softmax sums.

Against (a) the port's local path (rank 0 runs it on the same inputs) and
(b) the JAX package in a subprocess with 4 forced host devices, on a mesh
of ``AxisType.Auto`` axes (ROADMAP C-10: ``jax.make_mesh``'s default
Explicit axes break the reference's dense path): its GSPMD steps with the
rules and hooks for the dense configs, its unsharded steps for the MoE
ones (its sharded MoE joins other tokens' logits, ROADMAP C-9).
Tolerance: each array within 1e-5 of its largest magnitude (loss and
grad norm within 1e-5 relative).

Elastic: ``elastic.rescale`` of the (2, 2) training state onto (1, 4)
while the source steps; each destination slice bit-equal to the slice cut
from the gathered source at the stop, the same rounds and stop reason on
every rank, then a step on (1, 4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import sharding as jax_sharding  # noqa: E402
from repro.launch.specs import (  # noqa: E402
    batch_specs, cache_specs, state_specs)
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402

TOL = 1e-5


class FakeMesh:
    """Duck-typed mesh: the rules read only ``.shape`` and
    ``.axis_names``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()))


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "2x2": FakeMesh({"data": 2, "model": 2}),
          "1x4": FakeMesh({"data": 1, "model": 4})}


@pytest.fixture
def reference_specs(monkeypatch):
    """The reference's sharding functions give their ``PartitionSpec``s:
    ``NamedSharding`` and ``with_sharding_constraint`` stand-ins."""
    monkeypatch.setattr(jax_sharding, "NamedSharding",
                        lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)


def _flat(tree):
    return [(tuple(str(k.key) if hasattr(k, "key") else str(k.idx)
                   for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]]


def _at(tree, path):
    """The port's spec at a leaf path (dict keys, tuple positions)."""
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


def _same_specs(got_tree, want_tree, shapes):
    """The port's spec tree against the reference's, leaf for leaf over
    the shapes' paths; returns how many leaves are cut."""
    n_cut = 0
    want = _flat(want_tree)
    assert len(want) == len(_flat(shapes))
    for (path, spec), (_, leaf) in zip(want, _flat(shapes)):
        got = _at(got_tree, path)
        assert got == tuple(spec), (path, leaf.shape, got, spec)
        n_cut += any(e is not None for e in tuple(spec))
    return n_cut


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_state_batch_cache_specs_match_reference(arch, mesh,
                                                 reference_specs):
    m, cfg = MESHES[mesh], jax_config(arch)
    tree = state_specs(cfg)
    assert _same_specs(sharding.state_specs(m, tree),
                       jax_sharding.state_shardings(m, tree), tree) > 0
    for B in (32, 6, 1):
        b = batch_specs(cfg, B, 64)
        b["positions"] = jax.ShapeDtypeStruct((3, B, 64), np.int32)
        _same_specs(sharding.batch_specs(m, b),
                    jax_sharding.batch_shardings(m, b), b)
    for B, L in ((32, 4096), (1, 4100), (2, 4096 + 16 * 3)):
        c = cache_specs(cfg, B, L)
        _same_specs(sharding.cache_specs(m, cfg, c),
                    jax_sharding.cache_shardings(m, cfg, c), c)


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_constrain_hook_specs_match_reference(mesh, reference_specs):
    m = MESHES[mesh]
    for arch in ("internlm2_1p8b", "kimi_k2_1t_a32b"):
        cfg = jax_config(arch)
        hook = jax_sharding.make_constrain(m, cfg)
        for shape in ((32, 4096, 64), (6, 100, 64), (1, 1, 64), (2, 8, 4)):
            x = jax.ShapeDtypeStruct(shape, np.float32)
            assert sharding.constrain_spec(m, cfg, shape) == tuple(hook(x))
            assert sharding.constrain_logits_spec(m, shape) == tuple(
                jax_sharding.make_constrain_logits(m)(x))


def test_kv_ring_cut_along_window_where_heads_do_not_divide(
        reference_specs):
    """On (1, 4) the smoke configs' 2 KV heads do not divide the model
    axis: the ring (L, B, W, Hkv, hd) is cut along W, as the reference's
    ``cache_shardings`` cuts it; on (2, 2) along the heads."""
    cfg = jax_config("internlm2_1p8b").smoke()
    c = jax.eval_shape(lambda: jax_lm.init_cache(cfg, 4, 20))
    for mesh, want in (("1x4", (None, "data", "model", None, None)),
                       ("2x2", (None, "data", None, "model", None))):
        m = MESHES[mesh]
        assert tuple(jax_sharding.cache_shardings(m, cfg, c)["attn"]["k"]) \
            == want
        assert sharding.cache_specs(m, cfg, c)["attn"]["k"] == want
    assert sharding.kv_split(MESHES["1x4"], 2, 20) == "window"
    assert sharding.kv_split(MESHES["1x4"], 2, 18) is None


@pytest.mark.parametrize("multi_pod,world", [(False, 256), (True, 512)])
def test_production_mesh_on_a_fake_group(multi_pod, world):
    """``make_production_mesh`` builds (16, 16) ``(data, model)`` and
    (2, 16, 16) ``(pod, data, model)`` over a fake group of 256 and 512
    ranks in this process, and refuses a group too small."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as meshlib
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world)
    try:
        m = meshlib.make_production_mesh(multi_pod=multi_pod, device="cpu")
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert m.mesh_dim_names == names
        assert tuple(m.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert meshlib.batch_axes(m) == names[:-1]
        if not multi_pod:
            with pytest.raises(ValueError, match="needs 512 ranks"):
                meshlib.make_production_mesh(multi_pod=True, device="cpu")
    finally:
        tdist.destroy_process_group()


def test_one_rank_collectives_are_identities(tmp_path, monkeypatch):
    """On a (1, 1) mesh every collective of ``models/dist`` returns its
    input itself, calls no backend, and passes the gradient unchanged
    (ROADMAP C-w9)."""
    import torch.distributed as tdist
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import dist
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                             rank=0, world_size=1)
    try:
        mesh = meshlib.make_host_mesh(1, 1, device="cpu")
        ctx = dist.model_context(mesh)
        for name in ("all_reduce", "all_gather_into_tensor",
                     "all_to_all_single"):
            monkeypatch.setattr(tdist, name, None)      # any call fails
        x = torch.randn(4, 6, requires_grad=True)
        ys = [dist.all_gather(x, mesh, "model", 1),
              dist.all_gather(x, mesh, "data", 0),
              dist.all_to_all(x, mesh, "model"),
              dist.all_reduce(x, mesh, "data"),
              dist.reduce_scatter(x, mesh, "model", 1),
              dist.gather_split(x, mesh, "model", 1),
              dist.split(x, mesh, "model", 0),
              dist.copy_to_tp(x, mesh, "model"),
              dist.reduce_from_tp(x, mesh, "model"),
              dist.tp_enter(x, ctx), dist.tp_exit(x, ctx),
              dist.fsdp(x, ctx, 4, 0)]
        assert all(y is x for y in ys)
        w = torch.randint(-3, 4, (4, 6)).float()     # sums exact
        sum((y * w).sum() for y in ys).backward()
        assert torch.equal(x.grad, w * len(ys))
    finally:
        tdist.destroy_process_group()


def test_ssm_wirings_on_a_mesh_name_their_roadmap_item():
    """The SSM and hybrid wirings run on a mesh (ROADMAP item 15a-ii,
    ``tests/test_torch_tp_ssm.py``): ``lm._mesh_context`` takes the smoke
    configs on (1, 4) and refuses only a width the model axis does not
    divide (Mamba2 heads, RWKV heads and d) or ``seq_shard`` with a scan,
    naming it. A fake group of 4 ranks in this process: the refusal comes
    before any collective."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import dist, lm
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=4)
    try:
        ctx = dist.model_context(meshlib.make_host_mesh(1, 4, device="cpu"))
        narrow = {"zamba2_2p7b": "Mamba2 heads", "rwkv6_1p6b": "RWKV heads"}
        for arch, width in narrow.items():
            cfg = get_config(arch).smoke().replace(param_dtype="float32")
            with dist.use(ctx):
                assert lm._mesh_context(cfg) is ctx
                with pytest.raises(NotImplementedError, match=width):
                    lm._mesh_context(cfg.replace(d_model=96))   # 6, 3 heads
            seq = dist.model_context(ctx.mesh, seq_shard=True)
            with dist.use(seq), pytest.raises(NotImplementedError,
                                              match="seq_shard"):
                lm._mesh_context(cfg)
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs written; the JAX subprocess and the four ranks run at once.
    Returns (the rank files, the JAX package's results)."""
    return W.run_tp_suite("tp", tmp_path_factory.mktemp("tp"),
                          W.tp_inputs("tp", jax, jax_lm, jax_config))


PARTS = {"train": ("grads", "state"),
         "prefill": ("prefill_logits", "prefill_cache"),
         "decode": ("decode0_logits", "decode1_logits", "decode_cache")}
SCALARS = {"train": ("step_loss", "grad_norm")}


def _held(got_file, got_pre, want_file, want_pre, part):
    """Every array of ``part`` under ``got_pre`` against ``want_pre``:
    within TOL of each leaf's largest magnitude, scalars within TOL
    relative. Returns the number of arrays held."""
    keys = [k[len(got_pre) + 1:] for k in got_file.files
            if k.startswith(got_pre + "/")
            and k[len(got_pre) + 1:].split("/")[0] in PARTS[part]]
    for name in SCALARS.get(part, ()):
        got = float(got_file[f"{got_pre}/{name}"])
        want = float(want_file[f"{want_pre}/{name}"])
        assert abs(got - want) <= TOL * abs(want), (name, got, want)
    for k in keys:
        got = got_file[f"{got_pre}/{k}"].astype(np.float64)
        want = want_file[f"{want_pre}/{k}"].astype(np.float64)
        assert got.shape == want.shape, (k, got.shape, want.shape)
        assert np.isfinite(got).all(), k
        peak = float(np.abs(want).max()) if want.size else 0.0
        err = float(np.abs(got - want).max()) if want.size else 0.0
        assert err <= TOL * peak, (k, err, peak)
    return len(keys)


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("arch", W.TP_ARCHS)
@pytest.mark.parametrize("mesh", list(W.TP_MESHES))
def test_mesh_matches_local_path(run, mesh, arch, part):
    ranks, _ = run
    f = ranks[0]
    n = _held(f, f"{mesh}/{arch}", f, f"local/{arch}", part)
    assert n >= (3 if part == "decode" else 2)
    if part == "train":      # every param, gradient and optimizer leaf
        cfg = W.tp_config(arch, get_config)
        from repro_torch import tree
        from repro_torch.models import lm
        n_params = len(tree.leaves(lm.init_params(cfg, device="meta")))
        assert sum(k.startswith(f"{mesh}/{arch}/grads/")
                   for k in f.files) == n_params


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("arch", W.TP_EXTRA_ARCHS)
def test_more_uniform_configs_on_2x2_match_local_path(run, arch, part):
    """starcoder2 (GELU MLP), qwen2-vl (M-RoPE positions (3, B, S), cut by
    ``batch_pspec``, and a frontend prefix) and musicgen (the prefix stub
    frontend) on (2, 2) against the port's local path."""
    ranks, _ = run
    assert _held(ranks[0], f"2x2/{arch}", ranks[0], f"local/{arch}",
                 part) >= (3 if part == "decode" else 2)


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("arch", W.TP_EXTRA_ARCHS)
def test_more_uniform_configs_on_2x2_match_jax_package(run, arch, part):
    ranks, jx = run
    assert _held(ranks[0], f"2x2/{arch}", jx, f"2x2/{arch}", part) >= 2


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("arch", W.TP_ARCHS)
@pytest.mark.parametrize("mesh", list(W.TP_MESHES))
def test_mesh_matches_jax_package(run, mesh, arch, part):
    """The JAX package's GSPMD steps on the same mesh (dense), or its
    unsharded steps (MoE, ROADMAP C-9)."""
    ranks, jx = run
    cfg = W.tp_config(arch, jax_config)
    want = f"{mesh}/{arch}" if cfg.moe is None else f"local/{arch}"
    assert _held(ranks[0], f"{mesh}/{arch}", jx, want, part) >= 2


def test_elastic_rescale_onto_a_mesh(run):
    """(2, 2) -> (1, 4) while the source steps: the destination is the
    slices of the gathered source at the stop, bit for bit, every rank
    took the same rounds and stop reason, and the destination steps."""
    ranks, _ = run
    first = ranks[0]
    for f in ranks:
        assert bool(f["elastic/equal"])
        for k in ("rounds", "stop_reason", "per_round", "devices", "step"):
            assert np.array_equal(f[f"elastic/{k}"], first[f"elastic/{k}"])
        assert float(f["elastic/dst_loss"]) == pytest.approx(
            float(f["elastic/src_loss"]), rel=TOL)
        assert np.isfinite(float(f["elastic/dst_step_loss"]))
    assert list(first["elastic/devices"]) == [4, 4]
    assert int(first["elastic/rounds"]) >= 2
    assert int(first["elastic/step"]) == int(first["elastic/rounds"])
