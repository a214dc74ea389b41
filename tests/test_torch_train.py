"""The port's training path on the CPU against the JAX package: the loss
and its gradients, the train step (AdamW and Adafactor, gradient
accumulation, block remat) on the smoke configs of ``h2o_danube3_4b`` (f32
and bf16), ``zamba2_2p7b`` (hybrid) and ``rwkv6_1p6b``, the dirty-block
telemetry, and the backward of the attention and scan ops. The JAX state
comes across through ``models/convert.train_state_from_numpy``.

Tolerances (measured on this container, then given margin):
- f32: loss, ce and z-loss within rtol 1e-5 (measured <= 2e-7); the grad
  norm rtol 1e-4 (measured 5e-6); gradients within 1e-4 of each leaf's
  largest magnitude; AdamW's and Adafactor's moments within 5e-3 of
  theirs (measured 9e-4: a moment of a near-zero gradient carries the
  summation-order noise of the deep backward, relative to its leaf);
  params and master as ``_compare_states`` says.
- bf16: the two packages round activations at different places, so
  gradients differ by bf16 roundings (a few % of a small leaf's largest
  gradient). Loss within rtol 1e-3 (measured 2e-4), grad norm rtol 5e-3
  (measured 1e-3), moments within 0.1 of their leaf's largest magnitude
  (measured 0.037), params and master as ``_compare_states`` says.
- The optimizers on equal gradients (``test_optimizers_match_jax``):
  the grad norm within rtol 2e-6, f32 leaves within 2e-6 of their leaf's
  largest magnitude, bf16 params within one bf16 rounding.
- Exact: the learning rate, tokens, the step counter and count, every
  dirty fraction and dirty byte count.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import make_batch as jax_batch  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import gla as jax_gla  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.optim import make_schedule as jax_schedule  # noqa: E402
from repro.train import dirty_block_stats as jax_dirty  # noqa: E402
from repro.train import init_train_state as jax_init  # noqa: E402
from repro.train import make_train_step as jax_step  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import ops, vjp  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.optim import make_schedule  # noqa: E402
from repro_torch.train import (dirty_block_stats, init_train_state,  # noqa: E402
                               make_train_step)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread each, as the suite runs its files
    in parallel worker processes (restored after this module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL = dict(loss=1e-5, gnorm=5e-4, master=1e-4, moment=5e-3, update=0.01)
BF16_TOL = dict(loss=1e-3, gnorm=5e-3, master=1e-3, moment=0.1, update=0.1)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(arch, **kw):
    return (jax_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def _close_to_leaf(got, want, frac, what, outliers=0.0, bound=None,
                   floor=1e-30):
    """|got - want| <= frac * max(max|want|, floor) over the leaf, but for
    at most a fraction ``outliers`` of its elements, which must be within
    ``bound``."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    if not want.size:
        return
    scale = max(float(np.max(np.abs(want))), floor)
    err = np.abs(got - want)
    over = float(np.mean(err > frac * scale))
    assert over <= outliers, (f"{what}: {over} of the elements off by more "
                              f"than {frac} * {scale} (max {err.max()})")
    if bound is not None:
        assert float(err.max()) <= bound, f"{what}: err {err.max()} > {bound}"


def _batches(jc, tc, step, batch=4, seq=32, mask_targets=False):
    jb = jax_batch(jc, batch, seq, step=step)
    tb = make_batch(tc, batch, seq, step=step, device="cpu")
    if mask_targets:                        # some targets ignored (-1)
        t = np.asarray(jb["targets"]).copy()
        t[:, ::5] = -1
        jb["targets"] = jnp.asarray(t)
        tb["targets"] = torch.from_numpy(t)
    return jb, tb


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kw", [
    ("h2o_danube3_4b", {"remat": "block", "sliding_window": 8,
                        "attn_chunk": 16}),
    ("zamba2_2p7b", {"remat": "block"}),
])
def test_lm_loss_and_grads_match_jax(arch, kw):
    jc, tc = _configs(arch, param_dtype="float32", **kw)
    jp = jax.jit(jax_lm.init_params, static_argnums=0)(jc,
                                                        jax.random.key(0))
    tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    jb, tb = _batches(jc, tc, 0, mask_targets=True)

    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_lm.lm_loss(p, jc, jb), has_aux=True))(jp)
    live = tree.map(lambda p: p.requires_grad_(True), tp)
    tl, tm = lm.lm_loss(live, tc, tb)
    tg = torch.autograd.grad(tl, tree.leaves(live))

    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=F32_TOL["loss"])
    for k in ("ce", "z_loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=F32_TOL["loss"], atol=1e-9)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 4 * 32 - 4 * 7
    jleaves = jax.tree.leaves(jg)
    assert len(tg) == len(jleaves)
    for i, (a, b) in enumerate(zip(tg, jleaves)):
        _close_to_leaf(a, b, F32_TOL["master"], f"grad leaf {i}")


def test_forward_for_prefill_stays_without_grad():
    """``lm.forward`` (prefill) keeps ``no_grad`` even on params that
    require grad; ``lm_loss`` builds a graph."""
    _, tc = _configs("h2o_danube3_4b", param_dtype="float32")
    p = tree.map(lambda t: t.requires_grad_(True),
                 lm.init_params(tc, 0, device="cpu"))
    b = make_batch(tc, 2, 16, device="cpu")
    x, _, _ = lm.forward(p, tc, b)
    assert not x.requires_grad
    loss, _ = lm.lm_loss(p, tc, b)
    assert loss.requires_grad


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
# each optimizer, accumulation, remat setting, dtype and wiring at least once
STEP_CASES = [
    ("h2o_danube3_4b", "float32", "adamw", 1, "none"),
    ("h2o_danube3_4b", "bfloat16", "adamw", 1, "block"),
    ("h2o_danube3_4b", "bfloat16", "adafactor", 2, "block"),
    ("zamba2_2p7b", "float32", "adamw", 2, "block"),
    ("rwkv6_1p6b", "float32", "adafactor", 1, "none"),
]


def _compare_states(ts, js, tol, bf16, lr_sum):
    """Params and master: every element within 3 x the summed learning rate
    of the reference, and all but 2% of them within ``tol["master"]`` of
    their leaf's largest magnitude or 1% of the summed rate, whichever is
    larger. The optimizer's arithmetic is held tighter by
    ``test_optimizers_match_jax`` on equal gradients; here the gradients
    carry each package's rounding, which AdamW's normalized step
    ``m / sqrt(v)`` of a near-zero gradient turns into up to ~lr, and
    Adafactor's clipped step of a tiny leaf (RWKV's bonus) into a few %
    (measured in f32 at lr 1e-3: at most 1.2% of a leaf beyond the limit).
    bf16 params, whose rounding edges the update crosses (20-35% of the
    elements differ by one rounding after three steps at lr 1e-3): each
    within one bf16 rounding of its value plus 3 x the summed rate (a
    first AdamW step of opposite sign moves master 2 lr apart)."""
    assert int(ts["step"]) == int(js["step"])
    assert int(ts["opt"]["count"]) == int(js["opt"]["count"])
    moved = dict(frac=tol["master"], outliers=0.02, bound=3 * lr_sum,
                 floor=tol["update"] * lr_sum / tol["master"])
    for i, (a, b) in enumerate(zip(tree.leaves(ts["params"]),
                                   jax.tree.leaves(js["params"]))):
        if bf16 and a.dtype == torch.bfloat16:
            got, want = _f32(a), _f32(b)
            limit = 2 ** -7 * np.abs(want) + 3 * lr_sum
            assert np.all(np.abs(got - want) <= limit), f"param leaf {i}"
        else:
            _close_to_leaf(a, b, what=f"param leaf {i}", **moved)
    for name in sorted(js["opt"]):
        if name == "count":
            continue
        kw = moved if name == "master" else dict(frac=tol["moment"])
        for i, (a, b) in enumerate(zip(tree.leaves(ts["opt"][name]),
                                       jax.tree.leaves(js["opt"][name]))):
            _close_to_leaf(a, b, what=f"opt {name} leaf {i}", **kw)


@pytest.mark.parametrize("arch,dtype,opt,accum,remat", STEP_CASES)
def test_train_steps_match_jax(arch, dtype, opt, accum, remat):
    """One step, then two more, with telemetry, on the same state and
    batches in both packages."""
    jc, tc = _configs(arch, param_dtype=dtype, optimizer=opt,
                      accum_steps=accum, remat=remat, learning_rate=0.05)
    bf16 = dtype == "bfloat16"
    tol = BF16_TOL if bf16 else F32_TOL
    js = jax.jit(jax_init, static_argnums=0)(jc, jax.random.key(0))
    ts = convert.train_state_from_numpy(tc, jax.tree.map(np.asarray, js),
                                        device="cpu")
    jf = jax.jit(jax_step(jc, telemetry=True))
    tf = make_train_step(tc, telemetry=True)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batches(jc, tc, i)
        js, jm = jf(js, jb)
        ts, tm = tf(ts, tb)
        lr_sum += float(jm["lr"])
        assert set(tm) == set(jm)
        for k in ("loss", "ce", "z_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=tol["loss"], err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=tol["gnorm"])
        for k in ("lr", "tokens", "aux_loss", "dirty_fraction",
                  "dirty_bytes"):
            assert float(tm[k]) == float(jm[k]), (k, i)
        if i in (0, 2):                     # after one step and after three
            _compare_states(ts, js, tol, bf16, lr_sum)


@pytest.mark.parametrize("opt,dtype,grad_dtype", [
    ("adamw", "bfloat16", "bfloat16"), ("adamw", "float32", "float32"),
    ("adafactor", "bfloat16", "bfloat16"),
    ("adafactor", "bfloat16", "float32"),   # accumulated f32 grads
])
def test_optimizers_match_jax(opt, dtype, grad_dtype):
    """``apply_updates`` on the same params and gradients: three updates,
    each with a gradient large enough to be clipped."""
    from repro import optim as jax_optim
    from repro_torch import optim
    jc, tc = _configs("h2o_danube3_4b", optimizer=opt, param_dtype=dtype,
                      learning_rate=0.2)
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 5, 7), "b": {"c": (11, 4), "d": (9,)}, "e": (6,)}
    params = jax.tree.map(lambda sh: rng.standard_normal(sh).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp = jax.tree.map(lambda x: jnp.asarray(x, dtype), params)
    tp = jax.tree.map(_torch_leaf, jp)
    js = jax_optim.init_opt_state(jc, jp)
    ts = optim.init_opt_state(tc, tp)
    for i in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape) * (0.1 + i), grad_dtype), jp)
        lr = jax_optim.make_schedule(jc)(jnp.asarray(i * 50, jnp.int32))
        jp_new, js, jn = jax_optim.apply_updates(jc, jp, g, js, lr)
        before = [t.clone() for t in tree.leaves(tp)]
        tp_new, ts, tn = optim.apply_updates(
            tc, tp, jax.tree.map(_torch_leaf, g), ts,
            torch.tensor(np.float32(lr)))
        for a, b in zip(tree.leaves(tp), before):    # old params untouched
            assert torch.equal(a, b)
        jp, tp = jp_new, tp_new
        np.testing.assert_allclose(float(tn), float(jn), rtol=2e-6)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == getattr(torch, dtype)
            if dtype == "bfloat16":
                np.testing.assert_allclose(_f32(a), _f32(b), rtol=2 ** -7,
                                           atol=0)
            else:
                _close_to_leaf(a, b, 2e-6, "param")
        for a, b in zip(tree.leaves({k: v for k, v in ts.items()
                                     if k != "count"}),
                        jax.tree.leaves({k: v for k, v in js.items()
                                         if k != "count"})):
            _close_to_leaf(a, b, 2e-6, "optimizer state")


def test_init_train_state_layout_matches_jax():
    for opt in ("adamw", "adafactor"):
        jc, tc = _configs("zamba2_2p7b", optimizer=opt)
        js = jax.eval_shape(lambda: jax_init(jc, jax.random.key(0)))
        ts = init_train_state(tc, 0, device="meta")
        jl = jax.tree_util.tree_flatten_with_path(js)[0]
        tl = tree.leaves(ts)
        assert len(tl) == len(jl)
        for (path, a), b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype) == str(b.dtype)[len("torch."):], path


def test_schedule_matches_jax_exactly():
    jc, tc = _configs("h2o_danube3_4b", learning_rate=3e-4)
    js, ts = jax_schedule(jc, warmup=20, total=100), \
        make_schedule(tc, warmup=20, total=100)
    for s in (0, 1, 7, 18, 19, 20, 21, 55, 99, 100, 150):
        want = np.float32(js(jnp.asarray(s, jnp.int32)))
        got = np.float32(ts(torch.tensor(s, dtype=torch.int32)))
        assert got == want, (s, got, want)


def test_train_state_from_numpy_refuses_the_wrong_optimizer():
    jc, tc = _configs("h2o_danube3_4b", optimizer="adafactor")
    js = jax.tree.map(np.asarray, jax_init(jc, jax.random.key(0)))
    with pytest.raises(ValueError):
        convert.train_state_from_numpy(tc.replace(optimizer="adamw"), js,
                                       device="cpu")


# ---------------------------------------------------------------------------
# dirty-block telemetry
# ---------------------------------------------------------------------------
def _dirty_pair(seed, dtype):
    """Two trees of ragged leaves; some blocks of the second changed."""
    rng = np.random.default_rng(seed)
    old = {"a": rng.standard_normal((5, 13)).astype(np.float32),
           "b": {"c": rng.standard_normal(70).astype(np.float32),
                 "d": rng.standard_normal((3, 4)).astype(np.float32)}}
    new = jax.tree.map(np.copy, old)
    new["a"][0, 3] += 1.0
    new["a"][4, 12] -= 0.5                  # ragged last block
    new["b"]["c"][33] = 0.25
    return (jax.tree.map(lambda x: jnp.asarray(x, dtype), old),
            jax.tree.map(lambda x: jnp.asarray(x, dtype), new))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [4, 16, 1 << 14])
def test_dirty_block_stats_matches_jax(dtype, block):
    jo, jn = _dirty_pair(0, dtype)
    to, tn = (jax.tree.map(_torch_leaf, t) for t in (jo, jn))
    want = jax_dirty(jo, jn, block=block)
    got = dirty_block_stats(to, tn, block=block)
    for k in ("dirty_fraction", "dirty_bytes"):
        assert float(got[k]) == float(want[k]), (k, got[k], want[k])


def _torch_leaf(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def test_dirty_block_stats_decides_a_nan_block_as_the_reference():
    """A block whose max |delta| is NaN is dirty when an element of it
    differs by more than 0 (the reference's element-wise test), though
    B3's max, and so ``ops.dirty_blocks``, leaves it clean."""
    old = np.zeros(8, np.float32)
    new = np.asarray([np.nan, 1, 0, 0, 0, 0, 0, 0], np.float32)
    want = jax_dirty({"w": jnp.asarray(old)}, {"w": jnp.asarray(new)},
                     block=4)
    got = dirty_block_stats({"w": torch.from_numpy(old)},
                            {"w": torch.from_numpy(new)}, block=4)
    assert float(want["dirty_fraction"]) == 0.5
    assert float(got["dirty_fraction"]) == 0.5
    assert float(got["dirty_bytes"]) == float(want["dirty_bytes"]) == 16.0
    assert not ops.dirty_blocks(torch.from_numpy(new),
                                torch.from_numpy(old), block=4).any()
    # a NaN block with no other change stays clean, as in the reference
    new2 = np.asarray([np.nan, 0, 0, 0, 0, 0, 0, 0], np.float32)
    want2 = jax_dirty({"w": jnp.asarray(old)}, {"w": jnp.asarray(new2)},
                      block=4)
    got2 = dirty_block_stats({"w": torch.from_numpy(old)},
                             {"w": torch.from_numpy(new2)}, block=4)
    assert float(got2["dirty_fraction"]) == float(want2["dirty_fraction"]) \
        == 0.0


# ---------------------------------------------------------------------------
# the attention and scan ops under grad
# ---------------------------------------------------------------------------
GRAD_TOL = 1e-4     # of each gradient's largest magnitude, f32


@pytest.mark.parametrize("s,chunk,window,g", [
    (24, 32, 0, 2),         # one chunk
    (48, 16, 0, 1),         # chunked, full causal
    (48, 16, 20, 3),        # chunked, sliding window
])
def test_attention_op_grads_match_jax(s, chunk, window, g):
    rng = np.random.default_rng(1)
    B, Hkv, D = 2, 2, 16
    q = rng.standard_normal((B, s, Hkv, g, D)).astype(np.float32)
    k = rng.standard_normal((B, s, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, s, Hkv, D)).astype(np.float32)
    ct = rng.standard_normal((B, s, Hkv, g, D)).astype(np.float32)

    def jf(q, k, v):
        out = jax_blocks._chunked_causal_attention(q, k, v, window,
                                                   chunk=chunk)
        return jnp.sum(out * ct)

    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    # the op's layout: (B, H, S, D) and (B, Hkv, S, D) views
    out = ops.flash_attention(
        tq.reshape(B, s, Hkv * g, D).transpose(1, 2), tk.transpose(1, 2),
        tv.transpose(1, 2), window=window, chunk=chunk)
    assert out.grad_fn is not None and "Attention" in type(out.grad_fn).__name__
    t_out = out.transpose(1, 2).reshape(B, s, Hkv, g, D)
    got = torch.autograd.grad((t_out * torch.from_numpy(ct)).sum(),
                              (tq, tk, tv))
    for a, b, name in zip(got, want, "qkv"):
        _close_to_leaf(a, b, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("ssd", [True, False])
def test_scan_op_grads_match_jax(ssd):
    """SSD with Mamba2's stride-0 views (q/k over heads, the decay over
    the state dimension); RWKV with a bonus and an initial state."""
    rng = np.random.default_rng(2)
    B, H, S, Dk, Dv = 2, 3, 45, 8, 6
    if ssd:
        qs = rng.standard_normal((B, S, Dk)).astype(np.float32)
        ks = rng.standard_normal((B, S, Dk)).astype(np.float32)
        lws = -rng.uniform(0.01, 1.0, (B, S, H)).astype(np.float32)
    else:
        qs = rng.standard_normal((B, H, S, Dk)).astype(np.float32)
        ks = rng.standard_normal((B, H, S, Dk)).astype(np.float32)
        lws = -rng.uniform(0.01, 1.0, (B, H, S, Dk)).astype(np.float32)
    v = rng.standard_normal((B, H, S, Dv)).astype(np.float32)
    bonus = rng.standard_normal((H, Dk)).astype(np.float32)
    h0 = rng.standard_normal((B, H, Dk, Dv)).astype(np.float32)
    ct = rng.standard_normal((B, H, S, Dv)).astype(np.float32)

    def views(xp, q, k, lw):
        if not ssd:
            return q, k, lw
        bc = (jnp.broadcast_to if xp is jnp else
              (lambda a, shape: a.expand(*shape)))
        return (bc(q[:, None], (B, H, S, Dk)), bc(k[:, None], (B, H, S, Dk)),
                bc(jnp.moveaxis(lw, 2, 1)[..., None] if xp is jnp
                   else lw.permute(0, 2, 1)[..., None], (B, H, S, Dk)))

    def jf(q, k, v, lw, u, h):
        q, k, lw = views(jnp, q, k, lw)
        y, _ = jax_gla.gla_chunked(q, k, v, lw, bonus=None if ssd else u,
                                   initial_state=None if ssd else h)
        return jnp.sum(y * ct)

    want = jax.jit(jax.grad(jf, argnums=tuple(range(6))))(qs, ks, v, lws,
                                                         bonus, h0)
    t = [torch.from_numpy(x).requires_grad_(True)
         for x in (qs, ks, v, lws, bonus, h0)]
    q, k, lw = views(torch, t[0], t[1], t[3])
    y, state = ops.ssm_scan(q, k, t[2], lw, bonus=None if ssd else t[4],
                            initial_state=None if ssd else t[5])
    assert "Scan" in type(y.grad_fn).__name__
    assert not state.requires_grad
    used = [0, 1, 2, 3] if ssd else [0, 1, 2, 3, 4, 5]
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                              [t[i] for i in used])
    for a, i in zip(got, used):
        assert a.shape == t[i].shape
        _close_to_leaf(a, want[i], GRAD_TOL, f"grad of input {i}")


def test_ops_without_grad_take_the_plain_path():
    """With grad off, or no input requiring it, the ops return no graph
    (the path is the serving one)."""
    q = torch.randn(1, 2, 8, 4, requires_grad=True)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
    k = torch.randn(1, 2, 8, 4)
    assert ops.flash_attention(k, k, k).grad_fn is None
    assert ops.ssm_scan(k, k, k, -k.abs())[0].grad_fn is None
    assert issubclass(vjp.Attention, torch.autograd.Function)
    assert issubclass(vjp.Scan, torch.autograd.Function)


_ATTENTION = vjp.Attention


class _OffAttention(_ATTENTION):
    """A forward kernel whose output is 1% off; the backward stays plain."""

    @staticmethod
    def forward(ctx, q, k, v, window, chunk, forward, scale=None):
        return _ATTENTION.forward(ctx, q, k, v, window, chunk,
                                  lambda *a: 1.01 * forward(*a), scale)


@pytest.mark.parametrize("fault", ["none", "update x0.9", "update sign",
                                   "attention forward 1% off"])
def test_smoke_train_check_fails_a_faulty_step(fault, monkeypatch):
    """The smoke's card-against-CPU train check (``_train_errors``) on two
    CPU runs of one f32 AdamW step of the internlm2 smoke config, one of
    them faulty: an optimizer whose update is 0.9 of the true one (reads
    ~0.1 lr, within the 2.5 lr a sign-blind limit allows), one whose update
    has the wrong sign (~2 lr), and a forward attention 1% off (the first
    moment's limit). Without a fault every error is 0."""
    cfg = get_config("internlm2_1p8b").smoke().replace(param_dtype="float32")

    def run(faulty):
        state = init_train_state(cfg, 0, device="cpu")
        if faulty:
            monkeypatch.setattr(vjp, "Attention", _OffAttention)
        state, m = make_train_step(cfg)(state, make_batch(cfg, 2, 32,
                                                          device="cpu"))
        monkeypatch.undo()
        return {k: float(v) for k, v in m.items()}, state

    p0 = tree.leaves(init_train_state(cfg, 0, device="cpu")["params"])
    want = run(False)
    mg, sg = run(fault == "attention forward 1% off")
    if fault.startswith("update"):
        f = 0.9 if fault == "update x0.9" else -1.0
        start = {id(b): a for a, b in zip(p0, tree.leaves(sg["params"]))}
        sg = dict(sg, params=tree.map(
            lambda b: start[id(b)] + f * (b - start[id(b)]), sg["params"]))
    errs, ok = chip_smoke._train_errors(torch, (mg, sg), want)
    print(f"{fault}: {errs}, within the limits: {ok}")
    lim = chip_smoke.TRAIN_CHECK
    if fault == "none":
        assert ok and errs["share"] > 0.5
        assert all(errs[k] == 0 for k in ("loss", "grad_norm", "moment",
                                          "update_lr"))
        return
    assert not ok
    if fault == "update x0.9":
        assert 0.05 < errs["update_lr"] < 0.2 and errs["moment"] == 0
        shift = max(float((a - b).abs().max()) for a, b in zip(
            tree.leaves(sg["params"]), tree.leaves(want[1]["params"])))
        assert shift < 2.5 * want[0]["lr"]          # a sign-blind limit
    elif fault == "update sign":
        assert errs["update_lr"] > 1.5
    else:
        assert errs["moment"] > lim["moment"] and errs["grad_norm"] > 0
