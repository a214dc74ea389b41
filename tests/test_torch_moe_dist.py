"""The port's expert-parallel MoE layer (``blocks._moe_ffn_sharded`` under a
``models/dist.DistContext``) on a (2, 2) ``("data", "model")`` mesh of
four ``gloo`` ranks on the CPU (``torch_dist_worker.py``, suite "moe"),
against the port's local path and against the JAX package's own
``_moe_ffn_sharded`` on a forced 4-device host mesh (a subprocess, as
``tests/test_moe_dist.py`` runs it).

Weights: the JAX package's ``lm.init_params`` of each case's smoke config,
carried across by ``models/convert.params_from_numpy``; each rank cuts
its share with ``blocks.moe_shard_params`` (``launch/sharding``).

Against the local path, at the reference test's no-drop capacity (8
experts, top-2, capacity_factor 8.0): bf16 output within 5e-2 and aux
within 1e-3 (``tests/test_moe_dist.py``'s limits); f32 output within 1e-5
of its largest magnitude; gradients of sum(out) + aux through both
all-to-alls within 1e-5 of each leaf's largest magnitude.

Against the JAX package at the full config's capacity factor (1.25, where
each shard drops pairs), in f32, for qwen3-moe's smoke config and
kimi-k2's (a shared expert), in the ``slice``, ``dup`` (decode, one token
a row) and ``seq`` (``seq_shard``) modes: each shard's dropped pairs
equal, output within 1e-5 of its largest magnitude, aux within 1e-6. The
JAX side is its sharded layer's semantics built shard by shard from its
own blocks, since its ``_moe_ffn_sharded`` joins logits of different
tokens in ``slice`` and ``seq`` modes (ROADMAP C-9,
``test_reference_logit_gather_fault_is_not_ported``); in ``dup`` mode,
where that gather is right, the port is held to ``_moe_ffn_sharded``
itself.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, sys.argv[2])
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.models import blocks, dist
    import torch_dist_worker as W

    inp = np.load(os.path.join(sys.argv[1], "inputs.npz"))
    mesh = jax.make_mesh(W.MOE_MESH, ("data", "model"))
    nd, nm = W.MOE_MESH

    def layer_of(name):
        pre = name + "/params/blocks/moe/"
        layer = {}
        for k in inp.files:
            if k.startswith(pre):
                node, parts = layer, k[len(pre):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(inp[k][0])
        return layer

    def sharded(cfg, layer, x, seq):
        ctx = dist.DistContext(mesh=mesh, batch_axes=("data",),
                               tp_axis="model", seq_shard=seq)
        with mesh, dist.use(ctx):
            return jax.jit(lambda p, x: blocks.moe_ffn(p, cfg, x))(layer, x)

    def per_shard(cfg, layer, x, mode):
        # the sharded layer's semantics from the package's own blocks: each
        # shard (data block i, model rank r) routes its tokens on their own
        # logits, fills its capacity buffer, runs the experts and combines;
        # aux from the load-balance sums over the shards that count
        m = cfg.moe
        B, S, d = x.shape
        E, K = m.num_experts, m.top_k
        out = np.zeros(x.shape, np.float32)
        drops = np.zeros((nd, nm), np.int64)
        p_tot, c_tot, T_tot = 0.0, 0.0, 0
        for i in range(nd):
            b0, b1 = i * B // nd, (i + 1) * B // nd
            xb = x[b0:b1]
            for r in range(nm):
                if mode == "seq":
                    s0, s1 = r * S // nm, (r + 1) * S // nm
                    xt = xb[:, s0:s1].reshape(-1, d)
                else:
                    xt = xb.reshape(-1, d)
                    if mode == "slice":
                        t = xt.shape[0] // nm
                        xt = xt[r * t:(r + 1) * t]
                T = xt.shape[0]
                C = blocks.moe_capacity(m, T)
                gate, expert, p_sum, c_sum = blocks._route(layer, m, xt)
                buf, slot = blocks._fill_buffer(xt, expert, E, C)
                y = blocks._expert_swiglu(buf, layer["w_gate"],
                                          layer["w_up"], layer["w_down"])
                o = np.asarray(blocks._combine(y, slot, gate, T))
                drops[i, r] = int(jnp.sum(slot == E * C))
                if mode == "seq":
                    out[b0:b1, s0:s1] = o.reshape(b1 - b0, s1 - s0, d)
                elif mode == "slice":
                    out[b0:b1].reshape(-1, d)[r * T:(r + 1) * T] = o
                else:
                    out[b0:b1] = o.reshape(b1 - b0, S, d)
                if mode != "dup" or r == 0:
                    p_tot, c_tot, T_tot = p_tot + p_sum, c_tot + c_sum, \\
                        T_tot + T
        aux = E * jnp.sum((p_tot / T_tot) * (c_tot / (T_tot * K))) \\
            * m.aux_loss_weight
        if m.num_shared_experts:
            out = out + np.asarray(blocks.mlp(
                layer["shared"], x.reshape(B * S, d))).reshape(x.shape)
        return out, np.asarray(aux), drops

    out = {}
    for name, arch, mode, dtype, cf, (B, S) in W.MOE_CASES:
        cfg = W.moe_config(arch, dtype, cf, get_config)
        layer = layer_of(name)
        x = jnp.asarray(inp[name + "/x"], jnp.float32)
        if name == "local_f32":
            # the package's sharded layer against its own local path
            y, _ = sharded(cfg, layer, x, False)
            want, _ = blocks.moe_ffn(layer, cfg, x)
            out["fault/err"] = np.asarray(jnp.abs(y - want).max())
            out["fault/peak"] = np.asarray(jnp.abs(want).max())
        if not name.startswith("jax_"):
            continue
        y, aux, drops = per_shard(cfg, layer, x, mode)
        out[name + "/out"], out[name + "/aux"] = y, aux
        out[name + "/drops"] = drops
        y, aux = sharded(cfg, layer, x, mode == "seq")
        out[name + "/sharded_out"] = np.asarray(y, np.float32)
        out[name + "/sharded_aux"] = np.asarray(aux)
    np.savez(os.path.join(sys.argv[1], "jax.npz"), **out)
    print("JAX_MOE_DIST_OK")
""")


def _numpy_tree(tree, prefix, out):
    """Flatten a JAX param tree into ``out`` under ``prefix``: bf16 leaves
    as their uint16 bits (``convert.params_from_numpy`` reads them so)."""
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            _numpy_tree(v, key, out)
        else:
            a = np.asarray(v)
            out[key] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs written; the JAX subprocess and the four ranks run at once.
    Returns (rank files, the JAX package's results)."""
    work = tmp_path_factory.mktemp("moe_dist")
    rng = np.random.default_rng(0)
    inp = {}
    for seed, (name, arch, _, dtype, cf, (B, S)) in enumerate(W.MOE_CASES):
        cfg = W.moe_config(arch, dtype, cf, jax_config)
        _numpy_tree(jax_lm.init_params(cfg, jax.random.key(seed + 1)),
                    f"{name}/params", inp)
        # tokens that share a direction crowd a few experts, so that the
        # config's capacity drops pairs (the no-drop capacity cannot)
        common = rng.standard_normal(cfg.d_model) * 0.2
        inp[f"{name}/x"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.1
                            + common).astype(np.float32)
    np.savez(work / "inputs.npz", **inp)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(W.ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                                 else []))
    jx = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(work),
                           os.path.dirname(W.__file__)],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          env=env, text=True)
    try:
        W.launch([("moe", 4)], work)
        stdout, stderr = jx.communicate(timeout=W.LAUNCH_TIMEOUT)
    finally:
        if jx.poll() is None:
            jx.kill()
            jx.wait()
    assert jx.returncode == 0 and "JAX_MOE_DIST_OK" in stdout, stderr[-3000:]
    ranks = [W.load("moe", 4, r, work) for r in range(4)]
    return ranks, np.load(work / "jax.npz")


def _peak_err(got, want):
    return float(np.abs(got - want).max()), float(np.abs(want).max())


@pytest.mark.parametrize("name,tol", [("local_bf16", None),
                                      ("local_f32", 1e-5)])
def test_sharded_moe_matches_local_path(run, name, tol):
    ranks, _ = run
    for f in ranks:
        got, want = f[f"{name}/out"], f[f"{name}/local_out"]
        assert got.shape == want.shape and np.isfinite(got).all()
        err, peak = _peak_err(got, want)
        assert int(f[f"{name}/drops"].sum()) == 0
        if tol is None:                       # bf16: the reference's limits
            assert err < 5e-2, err
            assert abs(float(f[f"{name}/aux"])
                       - float(f[f"{name}/local_aux"])) < 1e-3
        else:
            assert err <= tol * peak, (err, peak)
            assert abs(float(f[f"{name}/aux"])
                       - float(f[f"{name}/local_aux"])) <= 1e-6


@pytest.mark.parametrize("leaf", ["x", "router", "w_gate", "w_up", "w_down"])
def test_gradients_through_both_all_to_alls(run, leaf):
    ranks, _ = run
    name = W.GRAD_CASE
    for f in ranks:
        got, want = f[f"{name}/grad_{leaf}"], f[f"{name}/grad_{leaf}_ref"]
        assert got.shape == want.shape
        err, peak = _peak_err(got, want)
        assert peak > 0 and err <= 1e-5 * peak, (leaf, err, peak)


JAX_CASES = [c[0] for c in W.MOE_CASES if c[0].startswith("jax_")]


def _case(name):
    return next(c for c in W.MOE_CASES if c[0] == name)


def _block(f, want, mode, B, S):
    """Rank ``f``'s block of a global (B, S, d) array."""
    nd, nm = W.MOE_MESH
    i, r = (int(c) for c in f["coord"])
    want = want[i * B // nd:(i + 1) * B // nd]
    if mode == "seq":
        want = want[:, r * S // nm:(r + 1) * S // nm]
    return want, (i, r)


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_moe_matches_jax_per_shard_semantics(run, name):
    """Each rank's block of the output, its aux and its shard's dropped
    pairs against the JAX package's sharded semantics at the config's
    capacity, built shard by shard from its own ``_route``,
    ``_fill_buffer``, ``_expert_swiglu``, ``_combine`` and ``mlp``."""
    ranks, jx = run
    _, _, mode, _, _, (B, S) = _case(name)
    for f in ranks:
        want, (i, r) = _block(f, jx[f"{name}/out"], mode, B, S)
        got = f[f"{name}/out"]
        assert got.shape == want.shape
        err, peak = _peak_err(got, want)
        assert err <= 1e-5 * peak, (err, peak)
        assert abs(float(f[f"{name}/aux"]) - float(jx[f"{name}/aux"])) <= 1e-6
        assert list(f[f"{name}/drops"]) == [int(jx[f"{name}/drops"][i, r])]
    if mode != "dup":               # decode's few tokens cannot overflow
        assert int(jx[f"{name}/drops"].sum()) > 0


@pytest.mark.parametrize("name", [n for n in JAX_CASES if "dup" in n])
def test_sharded_moe_matches_jax_sharded_layer_in_dup_mode(run, name):
    """In ``dup`` mode every ``model`` rank routes the same tokens, where
    the JAX package's ``_moe_ffn_sharded`` gathers logits correctly: the
    port's layer equals it there."""
    ranks, jx = run
    _, _, mode, _, _, (B, S) = _case(name)
    for f in ranks:
        want, _ = _block(f, jx[f"{name}/sharded_out"], mode, B, S)
        err, peak = _peak_err(f[f"{name}/out"], want)
        assert err <= 1e-5 * peak, (err, peak)
        assert abs(float(f[f"{name}/aux"])
                   - float(jx[f"{name}/sharded_aux"])) <= 1e-6


def test_reference_logit_gather_fault_is_not_ported(run):
    """ROADMAP C-9: the JAX package's sharded layer gathers logits that
    ``model`` ranks computed on different tokens, so at a capacity that
    cannot drop it misses its own local path by about the outputs' size
    (its test's bf16 limit, 5e-2, is larger than the outputs); the port's
    layer holds its local path to 1e-5 on the same weights and tokens."""
    ranks, jx = run
    assert float(jx["fault/err"]) > 0.1 * float(jx["fault/peak"])
    for f in ranks:
        err, peak = _peak_err(f["local_f32/out"], f["local_f32/local_out"])
        assert err <= 1e-5 * peak, (err, peak)


def test_expert_inner_shard_is_refused():
    """The reference's inner-dim layout for the experts (its
    EXPERT_INNER_SHARD, kept off there) would sum partial outputs of
    different tokens over 'data'; the port takes ZeRO-3 only and refuses
    the knob rather than ignore it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.models import blocks, dist
    cfg = get_config("qwen3_moe_30b_a3b").smoke()
    ctx = dist.DistContext(None, ("data",), expert_inner_shard=True)
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(ValueError, match="expert_inner_shard"):
        blocks._moe_ffn_sharded({}, cfg, x, ctx)
    assert not any(k.endswith("3i") for k in sharding._RULES)
