"""The port's sharding rules (``launch/sharding.param_pspec``) against the
JAX package's, leaf for leaf, for every architecture on both production
mesh shapes (duck-typed, as ``tests/test_sharding_rules.py`` does), and
``param_shardings`` cutting a tree to a rank's slices.

Leaf paths and shapes: the JAX package's ``launch/specs.state_specs``
(params and optimizer state). The port's spec is a tuple of the same
entries as the reference's ``PartitionSpec`` (itself a tuple)."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import sharding as jax_sharding  # noqa: E402
from repro.launch.specs import state_specs  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402


class FakeMesh:
    """Duck-typed mesh: the rules read only ``.shape`` and
    ``.axis_names``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()))


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}


@functools.lru_cache(maxsize=None)
def _leaves(arch):
    return jax.tree_util.tree_flatten_with_path(
        state_specs(jax_config(arch)))[0]


def _names(path):
    return tuple(str(k.key) if hasattr(k, "key") else str(k.idx)
                 for k in path)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_param_pspec_matches_reference(arch, mesh):
    m = MESHES[mesh]
    n_sharded = 0
    for path, leaf in _leaves(arch):
        want = tuple(jax_sharding.param_pspec(m, path, leaf))
        got = sharding.param_pspec(m, _names(path), leaf)
        assert got == want, (_names(path), got, want)
        for d, ax in enumerate(got):
            if ax is not None:
                assert leaf.shape[d] % m.shape[ax] == 0
                n_sharded += 1
    assert n_sharded > 0


def test_rules_take_key_objects_and_device_mesh_shapes():
    """A JAX key path gives the same spec as its names; a mesh given as
    ``mesh_dim_names`` + a shape tuple (a ``DeviceMesh``) the same as the
    name -> size mapping."""

    class DeviceMeshLike:
        mesh_dim_names = ("data", "model")
        shape = (16, 16)

    path, leaf = next((p, v) for p, v in _leaves("qwen3_moe_30b_a3b")
                      if _names(p)[-1] == "w_gate" and "moe" in _names(p))
    want = sharding.param_pspec(MESHES["single"], _names(path), leaf)
    assert want[-3:] == ("model", "data", None)
    assert sharding.param_pspec(MESHES["single"], path, leaf) == want
    assert sharding.param_pspec(DeviceMeshLike(), _names(path), leaf) == want


def test_param_shardings_cut_a_rank_slice(monkeypatch):
    """``param_shardings`` on a (2, 2) mesh: each leaf's slice at this
    rank's coordinates, a tensor of its own; a leaf no rule names whole.
    (``blocks.moe_shard_params`` cuts the shared expert so too.)"""
    from repro_torch.launch import mesh as meshlib

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

    coord = {"data": 1, "model": 0}
    monkeypatch.setattr(meshlib, "axis_rank", lambda mesh, a: coord[a])
    E, d, f = 4, 6, 8
    full = {"moe": {"router": torch.arange(d * E, dtype=torch.float32
                                           ).reshape(d, E),
                    "w_gate": torch.randn(E, d, f),
                    "w_down": torch.randn(E, f, d),
                    "shared": {"w_gate": torch.randn(d, f)}},
            "other": torch.randn(3, 5)}
    got = sharding.param_shardings(Mesh(), full)
    moe = got["moe"]
    assert torch.equal(moe["router"], full["moe"]["router"][:, :2])
    assert torch.equal(moe["w_gate"], full["moe"]["w_gate"][:2, 3:])
    assert torch.equal(moe["w_down"], full["moe"]["w_down"][:2, :, 3:])
    assert moe["w_gate"].is_contiguous()
    assert moe["w_gate"].untyped_storage().data_ptr() != \
        full["moe"]["w_gate"].untyped_storage().data_ptr()
    # the shared expert is a dense MLP: (data, model) on (d, f)
    assert torch.equal(moe["shared"]["w_gate"],
                       full["moe"]["shared"]["w_gate"][3:, :4])
    assert torch.equal(got["other"], full["other"])
    assert math.prod(moe["w_gate"].shape) * 4 == full["moe"]["w_gate"].numel()
