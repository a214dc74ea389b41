"""The port's MoE layer (``blocks.moe_*``) and the two wirings that use it
(uniform ``moe``: qwen3-moe; ``prefix_dense``: kimi-k2) on the CPU against
the JAX package, on the same seeded numpy inputs and the JAX package's
weights carried across (``models/convert.py``).

Exact: expert ids, each (token, k)'s buffer slot and which ones drop
(capacity overflow), ``moe_capacity``, token counts, greedy tokens in
f32, the param trees' keys, shapes and dtypes (the router f32 in a bf16
model).

Tolerances (measured on this container, then given margin):
- the layer in f32: gates rtol 1e-5 (measured 4e-6), outputs within 1e-5
  of their largest magnitude (measured 5e-7), aux within 1e-6 absolute
  (measured 2e-9).
- the layer in bf16: both packages compute the expert products in bf16
  with f32 sums; outputs within 2e-2 of their largest magnitude
  (measured 1.1e-2: a few bf16 roundings).
- prefill and decode in f32: logits and KV rings rtol 1e-4 / atol 1e-4
  (measured 3e-6 on logits of size ~3.5); in bf16 atol 0.1 (measured
  0.031), the reference's tokens fed to both.
- the loss in f32: ce, z-loss and aux within rtol 1e-5 (measured 1.4e-7);
  gradients within 1e-4 of each leaf's largest magnitude (measured
  1.6e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import make_batch as jax_batch  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.train import init_train_state as jax_init  # noqa: E402
from repro.train import make_decode_step as jax_decode  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks, convert, lm  # noqa: E402
from repro_torch.train import (init_train_state, make_decode_step,  # noqa: E402
                               make_prefill_step)

ARCHS = ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread each, as the suite runs its files
    in parallel worker processes (restored after this module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    return (jax_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch(arr):
    """A JAX array as a CPU tensor of the same dtype (bf16 by its bits)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _near(got, want, frac, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, f"{what}: {err} > {frac} * {scale}"


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def _layer(arch, dtype, cf, B, S, skew):
    """One MoE layer of ``arch``'s smoke config (capacity factor ``cf``)
    with the JAX package's weights, and seeded inputs: N(0, 1) plus
    ``skew`` times one shared direction, which crowds the router onto a
    few experts."""
    jc, tc = _configs(arch, param_dtype=dtype)
    jc = jc.replace(moe=dataclasses.replace(jc.moe, capacity_factor=cf))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, capacity_factor=cf))
    jp = jax_blocks.moe_init(jax.random.key(1), jc)
    tp = jax.tree.map(_torch, jp)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, S, jc.d_model))
         + skew * rng.standard_normal(jc.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jc.dtype)
    tx = torch.from_numpy(x).to(tc.dtype)
    return jc, tc, jp, tp, jx, tx


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,drops", [(4.0, False), (1.25, True)])
def test_moe_ffn_matches_jax(arch, dtype, cf, drops):
    """Routing, dispatch and output of one layer; the smoke factor 4.0
    drops nothing, 1.25 with crowded routing drops (asserted)."""
    B, S = 4, 64
    jc, tc, jp, tp, jx, tx = _layer(arch, dtype, cf, B, S,
                                    skew=1.5 if drops else 0.0)
    T, E, K = B * S, jc.moe.num_experts, jc.moe.top_k
    C = blocks.moe_capacity(tc.moe, T)
    assert C == jax_blocks.moe_capacity(jc.moe, T)

    jxt = jx.reshape(T, -1)
    jgate, jexp, jpsum, jcsum = jax_blocks._route(jp, jc.moe, jxt)
    gate, expert, p_sum, c_sum = blocks._route(tp, tc.moe, tx.reshape(T, -1))
    np.testing.assert_array_equal(expert.numpy(), np.asarray(jexp))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-5)
    np.testing.assert_array_equal(c_sum.numpy(), np.asarray(jcsum))
    np.testing.assert_allclose(p_sum.numpy(), np.asarray(jpsum), rtol=1e-5)

    jbuf, jslot = jax_blocks._fill_buffer(jxt, jexp, E, C)
    buf, slot = blocks._fill_buffer(tx.reshape(T, -1), expert, E, C)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(_f32(buf), _f32(jbuf))
    n_drop = int((slot == E * C).sum())
    assert n_drop == int(np.sum(np.asarray(jslot) == E * C))
    assert (n_drop > 0) == drops, n_drop

    jout, jaux = jax_blocks.moe_ffn(jp, jc, jx)
    out, aux = blocks.moe_ffn(tp, tc, tx)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(jaux)) <= 1e-6
    _near(out, jout, 1e-5 if dtype == "float32" else 2e-2, "moe_ffn out")
    if drops:                                # a fully dropped token adds 0
        kept = (slot.reshape(T, K) < E * C).any(1)
        if not bool(kept.all()) and not jc.moe.num_shared_experts:
            assert bool((out.reshape(T, -1)[~kept] == 0).all())


@pytest.mark.parametrize("E,K,cf", [(8, 2, 4.0), (8, 2, 1.25), (128, 8, 1.25),
                                    (384, 8, 1.25), (16, 1, 1.0),
                                    (64, 6, 2.0)])
def test_moe_capacity_matches_jax(E, K, cf):
    jm = dataclasses.replace(jax_config("qwen3_moe_30b_a3b").moe,
                             num_experts=E, top_k=K, capacity_factor=cf)
    tm = dataclasses.replace(get_config("qwen3_moe_30b_a3b").moe,
                             num_experts=E, top_k=K, capacity_factor=cf)
    for T in (1, 2, 7, 8, 64, 100, 256, 1000, 8 * 4096, 4 * 4096, 32768 + 1):
        c = blocks.moe_capacity(tm, T)
        assert c == jax_blocks.moe_capacity(jm, T), (E, K, cf, T)
        assert c % 8 == 0 and c >= 8
    # the full configs' prefill and decode capacities
    assert blocks.moe_capacity(get_config("qwen3_moe_30b_a3b").moe,
                               8 * 4096) == 2568
    assert blocks.moe_capacity(get_config("qwen3_moe_30b_a3b").moe, 8) == 8


def test_moe_layer_grads_match_jax():
    """The layer's VJP (x, router, experts, the aux through p_sum) with
    drops, against ``jax.grad``, in f32."""
    jc, tc, jp, tp, jx, tx = _layer("kimi_k2_1t_a32b", "float32", 1.25, 2,
                                    64, skew=1.5)
    w = np.random.default_rng(5).standard_normal(
        tuple(tx.shape)).astype(np.float32)

    def jloss(p, x):
        out, aux = jax_blocks.moe_ffn(p, jc, x)
        return jnp.sum(out * w) + 10.0 * aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    live = tree.map(lambda t: t.requires_grad_(True), tp)
    xt = tx.clone().requires_grad_(True)
    out, aux = blocks.moe_ffn(live, tc, xt)
    loss = torch.sum(out * torch.from_numpy(w)) + 10.0 * aux
    tg = torch.autograd.grad(loss, tree.leaves(live) + [xt])
    want = jax.tree.leaves(jg[0]) + [jg[1]]
    assert len(tg) == len(want)
    for i, (a, b) in enumerate(zip(tg, want)):
        _near(a, b, 1e-4, f"grad leaf {i}")


# ---------------------------------------------------------------------------
# the model: prefill, decode, loss
# ---------------------------------------------------------------------------
def _replicas(arch, dtype, batch, prompt):
    jc, tc = _configs(arch, param_dtype=dtype)
    jp = jax_lm.init_params(jc, jax.random.key(0))
    tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    jb = jax_batch(jc, batch, prompt)
    jb.pop("targets")
    tb = make_batch(tc, batch, prompt, device="cpu")
    tb.pop("targets")
    np.testing.assert_array_equal(np.asarray(jb["tokens"]),
                                  tb["tokens"].numpy())
    return jc, tc, jp, tp, jb, tb


def _rings(cache):
    return {k: v for k, v in cache.items() if k != "pos"}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_serving_matches_jax(arch, dtype):
    """Prefill (3 x 24 tokens, the cache's rings under ``moe`` and, for
    kimi-k2, ``dense0``) and 3 greedy decode steps."""
    f32 = dtype == "float32"
    tol = dict(rtol=1e-4, atol=1e-4) if f32 else dict(rtol=0, atol=0.1)
    P, n = 24, 3
    jc, tc, jp, tp, jb, tb = _replicas(arch, dtype, 3, P)
    jl, jcache = jax.jit(jax_prefill(jc, P + n))(jp, jb)
    tl, tcache = make_prefill_step(tc, P + n)(tp, tb)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    assert sorted(_rings(tcache)) == sorted(_rings(jcache)) == (
        ["dense0", "moe"] if arch == "kimi_k2_1t_a32b" else ["moe"])
    for key, rings in _rings(tcache).items():
        for name in ("k", "v"):
            assert rings[name].shape == jcache[key][name].shape
            assert rings[name].dtype == tc.dtype
            np.testing.assert_allclose(_f32(rings[name]),
                                       _f32(jcache[key][name]), **tol)
    jdec, tdec = jax.jit(jax_decode(jc)), make_decode_step(tc)
    jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tt = tl.argmax(-1)[:, None].to(torch.int32)
    for _ in range(n):
        if not f32:                          # the reference's tokens
            tt = torch.from_numpy(np.array(jt))
        jt, jlog, jcache = jdec(jp, jt, jcache)
        tt, tlog, tcache = tdec(tp, tt, tcache)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **tol)
        if f32:
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tcache["pos"]) == int(jcache["pos"]) == P + n
    for key, rings in _rings(tcache).items():
        np.testing.assert_allclose(_f32(rings["k"]), _f32(jcache[key]["k"]),
                                   **tol)


@pytest.mark.parametrize("arch,remat", [("qwen3_moe_30b_a3b", "block"),
                                        ("qwen3_moe_30b_a3b", "none"),
                                        ("kimi_k2_1t_a32b", "full")])
def test_moe_lm_loss_and_grads_match_jax(arch, remat):
    """ce, z-loss and the summed aux loss, and every gradient, with each
    layer under ``torch.utils.checkpoint`` (remat) and without."""
    jc, tc = _configs(arch, param_dtype="float32", remat=remat)
    jp = jax_lm.init_params(jc, jax.random.key(0))
    tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    jb = jax_batch(jc, 2, 32)
    tb = make_batch(tc, 2, 32, device="cpu")
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_lm.lm_loss(p, jc, jb), has_aux=True))(jp)
    live = tree.map(lambda p: p.requires_grad_(True), tp)
    tl, tm = lm.lm_loss(live, tc, tb)
    tg = torch.autograd.grad(tl, tree.leaves(live))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("ce", "z_loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tm["aux_loss"]) > 0
    assert float(tm["tokens"]) == float(jm["tokens"])
    jleaves = jax.tree.leaves(jg)
    assert len(tg) == len(jleaves)
    for i, (a, b) in enumerate(zip(tg, jleaves)):
        _near(a, b, 1e-4, f"{arch} remat {remat} grad leaf {i}")


# ---------------------------------------------------------------------------
# trees, states and the launcher
# ---------------------------------------------------------------------------
def _tree_spec(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in t:
            out.update(_tree_spec(t[k], f"{path}['{k}']"))
        return out
    return {path: (tuple(t.shape), str(t.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_tree_matches_jax(arch):
    """Full width and depth, shapes only: every key, shape and dtype equal
    to the JAX package's (``jax.eval_shape``), the router f32 beside bf16
    experts, and the count equal to the reference's."""
    jc, tc = jax_config(arch), get_config(arch)
    spec = jax.eval_shape(lambda: jax_lm.init_params(jc, jax.random.key(0)))
    want = {jax.tree_util.keystr(p): (l.shape, str(l.dtype)) for p, l in
            jax.tree_util.tree_leaves_with_path(spec)}
    meta = lm.init_params(tc, device="meta")
    got = _tree_spec(meta)
    assert got == want
    assert got["['blocks']['moe']['router']"][1] == "float32"
    assert got["['blocks']['moe']['w_gate']"][1] == "bfloat16"
    n = sum(t.numel() for t in tree.leaves(meta))
    assert n == jax_lm.param_count(jc)
    if arch == "qwen3_moe_30b_a3b":
        assert n == 30_532_122_624
    else:
        assert "['dense0']['mlp']['w_gate']" in got
        two = lm.init_params(tc.replace(num_layers=2), device="meta")
        assert sum(t.numel() for t in tree.leaves(two)) == 19_934_645_248


@pytest.mark.parametrize("arch,opt", [("qwen3_moe_30b_a3b", "adamw"),
                                      ("kimi_k2_1t_a32b", "adafactor")])
def test_train_state_from_numpy_carries_moe_trees(arch, opt):
    """The JAX package's fresh train state (bf16 params, the router f32)
    arrives leaf for leaf, value for value, in the layout of the port's
    own ``init_train_state``."""
    jc, tc = _configs(arch, optimizer=opt)
    js = jax_init(jc, jax.random.key(0))
    ts = convert.train_state_from_numpy(tc, jax.tree.map(np.asarray, js),
                                        device="cpu")
    assert _tree_spec(ts) == _tree_spec(init_train_state(tc, 0,
                                                         device="meta"))
    assert ts["params"]["blocks"]["moe"]["router"].dtype == torch.float32
    assert ts["params"]["blocks"]["moe"]["w_up"].dtype == torch.bfloat16
    jl = jax.tree.leaves(js)
    tl = tree.leaves(ts)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(_f32(a), _f32(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_moe_on_cpu(arch, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--batch", "2",
                                     "--prompt-len", "16", "--tokens", "4",
                                     "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill: 2x16" in out and "decode:  3 steps" in out


def test_init_params_draws_a_large_stack_matrix_by_matrix():
    """A stack is drawn one (fan_in, fan_out) matrix at a time with the
    stack's fan-in: each matrix is the next draw of one such matrix from
    the generator, and the stack has the truncated normal's spread."""
    g = torch.Generator().manual_seed(0)
    stack = blocks.dense_init(g, (3, 64, 32), torch.bfloat16, lead=(2,))
    assert stack.shape == (2, 3, 64, 32) and stack.dtype == torch.bfloat16
    g = torch.Generator().manual_seed(0)
    for part in stack.view(-1, 64, 32):
        assert torch.equal(part, blocks.dense_init(g, (64, 32),
                                                   torch.bfloat16))
    std = 64 ** -0.5
    f = stack.float()
    assert float(f.abs().max()) <= 3 * std * 1.01
    assert abs(float(f.std()) / std - 0.987) < 0.05  # N(0,1) cut at 3
