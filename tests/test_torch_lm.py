"""The port's serving path on the CPU against the JAX package:
``h2o_danube3_4b.smoke()`` with the JAX package's weights carried across
(``models.convert.params_from_numpy``), prefill and decode logits, greedy
tokens and the KV ring, then the whole ``examples/serve_migration.py``
flow on both packages.

Tolerances: in float32, logits within rtol 1e-4 / atol 1e-4 (measured:
at most 4e-6 on logits of size ~3). In bfloat16 both packages round their
activations at different places; measured, logits differ by at most 0.047
on logits of size ~3 (three bf16 ulps there), so the test holds them to
atol 0.1 and feeds both the same (the reference's) tokens."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_configs as jax_all_configs  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.core import precopy as jax_precopy  # noqa: E402
from repro.data import make_batch as jax_batch  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.train import make_decode_step as jax_decode  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import all_configs, get_config  # noqa: E402
from repro_torch.core import precopy  # noqa: E402
from repro_torch.data import make_batch, synthetic  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402

ARCH = "h2o_danube3_4b"


def _configs(arch=ARCH, **kw):
    return (jax_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _replicas(kw, batch, prompt, arch=ARCH):
    jc, tc = _configs(arch, **kw)
    jp = jax_lm.init_params(jc, jax.random.key(0))
    tp = convert.params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    jb = jax_batch(jc, batch, prompt)
    jb.pop("targets")
    tb = make_batch(tc, batch, prompt, device="cpu")
    tb.pop("targets")
    assert set(tb) == set(jb)
    for k in jb:                           # tokens, and the stub frontend's
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
    assert tb["tokens"].dtype == torch.int32
    return jc, tc, jp, tp, jb, tb


def _serve_both(kw, batch, prompt, n_decode, tol, teacher_forced,
                arch=ARCH):
    """Prefill + ``n_decode`` greedy steps on both packages; every logits
    row within ``tol``; returns the final caches and tokens."""
    jc, tc, jp, tp, jb, tb = _replicas(kw, batch, prompt, arch)
    cache_len = prompt + n_decode
    jl, jcache = jax.jit(jax_prefill(jc, cache_len))(jp, jb)
    tl, tcache = make_prefill_step(tc, cache_len)(tp, tb)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(tcache["attn"][n]),
                                   _f32(jcache["attn"][n]), **tol)
    assert int(tcache["pos"]) == int(jcache["pos"]) == prompt
    jdec, tdec = jax.jit(jax_decode(jc)), make_decode_step(tc)
    jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tt = tl.argmax(-1)[:, None].to(torch.int32)
    jtoks, ttoks = [np.asarray(jt)], [tt.numpy()]
    for _ in range(n_decode):
        if teacher_forced:
            tt = torch.from_numpy(np.array(jt))
        jt, jlog, jcache = jdec(jp, jt, jcache)
        tt, tlog, tcache = tdec(tp, tt, tcache)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **tol)
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
    assert int(tcache["pos"]) == int(jcache["pos"]) == prompt + n_decode
    return jcache, tcache, np.concatenate(jtoks, 1), np.concatenate(ttoks, 1)


@pytest.mark.parametrize("kw,prompt", [
    ({}, 64),                                            # no SWA, one chunk
    ({"sliding_window": 16}, 40),                        # ring wraps, one chunk
    ({"sliding_window": 16, "attn_chunk": 16}, 48),      # ring wraps, chunked
    ({"sliding_window": 24, "attn_chunk": 8}, 32),       # window > one chunk
])
def test_serving_f32_matches_jax(kw, prompt):
    tol = dict(rtol=1e-4, atol=1e-4)
    jcache, tcache, jtoks, ttoks = _serve_both(
        dict(kw, param_dtype="float32"), 3, prompt, 6, tol,
        teacher_forced=False)
    np.testing.assert_array_equal(ttoks, jtoks)
    for n in ("k", "v"):                   # the ring layout after wrapping
        assert tcache["attn"][n].shape == jcache["attn"][n].shape
        np.testing.assert_allclose(_f32(tcache["attn"][n]),
                                   _f32(jcache["attn"][n]), **tol)


@pytest.mark.parametrize("arch", ["internlm2_1p8b", "qwen3_8b",
                                  "starcoder2_7b", "musicgen_medium",
                                  "qwen2_vl_2b"])
def test_other_dense_archs_f32_match_jax(arch):
    """The other configs of the uniform attention wiring: q/k norms
    (qwen3), the GELU MLP (starcoder2), a stub frontend prefix (musicgen)
    and M-RoPE position streams (qwen2-vl)."""
    tol = dict(rtol=1e-4, atol=1e-4)
    _, _, jtoks, ttoks = _serve_both(dict(param_dtype="float32"), 2, 32, 4,
                                     tol, teacher_forced=False, arch=arch)
    np.testing.assert_array_equal(ttoks, jtoks)


@pytest.mark.parametrize("kw,prompt", [({}, 64),
                                       ({"sliding_window": 16,
                                         "attn_chunk": 16}, 48)])
def test_serving_bf16_matches_jax(kw, prompt):
    jcache, tcache, _, _ = _serve_both(kw, 3, prompt, 5,
                                       dict(rtol=0, atol=0.1),
                                       teacher_forced=True)
    assert tcache["attn"]["k"].dtype == torch.bfloat16


def test_cpu_serving_launches_no_kernel():
    ops.reset_launch_counts()
    _, tc, _, tp, _, tb = _replicas({}, 2, 16)
    logits, cache = make_prefill_step(tc, 20)(tp, tb)
    make_decode_step(tc)(tp, logits.argmax(-1)[:, None].to(torch.int32),
                         cache)
    assert set(ops.launch_counts().values()) == {0}


def test_full_width_param_tree_matches_jax():
    """The full-width tree (shapes only): every key, shape and dtype equal
    to the JAX package's, and the parameter count equal to both packages'
    analytic count plus the final norm (3,961,839,360)."""
    jc, tc = jax_config(ARCH), get_config(ARCH)
    spec = jax.eval_shape(lambda: jax_lm.init_params(jc, jax.random.key(0)))
    want = {jax.tree_util.keystr(p): (l.shape, str(l.dtype)) for p, l in
            jax.tree_util.tree_leaves_with_path(spec)}
    meta = lm.init_params(tc, device="meta")
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}['{k}']")
        else:
            got[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    walk(meta, "")
    assert got == want
    n = sum(t.numel() for t in tree.leaves(meta))
    assert n == jax_lm.param_count(jc) == tc.param_count() + tc.d_model
    assert n == 3_961_839_360 and tc.param_count() == jc.param_count()


def test_configs_equal_the_reference():
    """Every config of the registry, full and smoke, field for field;
    ``dtype`` is the torch dtype of the same name."""
    jax_cfgs, cfgs = jax_all_configs(), all_configs()
    assert list(cfgs) == list(jax_cfgs)
    for name, jc in jax_cfgs.items():
        for j, t in ((jc, cfgs[name]), (jc.smoke(), cfgs[name].smoke())):
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
            assert t.dtype == getattr(torch, str(j.dtype))
            assert t.param_count() == j.param_count()
            assert t.pattern_for_depth() == j.pattern_for_depth()


@pytest.mark.parametrize("gen,kw", [("heavy_tail_load", {}),
                                    ("correlated_tenant_load",
                                     {"n_tenants": 3})])
def test_load_generators_equal_the_reference(gen, kw):
    want = getattr(jax_synthetic, gen)(7, 50, seed=3, **kw)
    got = getattr(synthetic, gen)(7, 50, seed=3, **kw)
    np.testing.assert_array_equal(got, want)


def test_serve_launcher_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--batch", "2",
                                     "--prompt-len", "16", "--tokens", "4",
                                     "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill: 2x16" in out and "decode:  3 steps" in out


def test_convert_rejects_wrong_tree():
    _, tc = _configs()
    good = tree.map(lambda t: t.float().numpy(),
                    lm.init_params(tc, device="cpu"))
    bad = dict(good)
    bad.pop("head")
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(tc, bad, device="cpu")
    bad = dict(good, embed=good["embed"][:-1])
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy(tc, bad, device="cpu")
    bits = dict(good, embed=torch.from_numpy(good["embed"]).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16))
    got = convert.params_from_numpy(tc, bits, device="cpu")
    assert torch.equal(got["embed"],
                       torch.from_numpy(good["embed"]).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# examples/serve_migration.py on both packages
# ---------------------------------------------------------------------------
B_, P_, N_ = 4, 64, 24
PCFG = dict(block_elems=1 << 12, max_rounds=8, stop_dirty_blocks=2)


def _jax_flow(jc, jp, jb):
    prefill = jax.jit(jax_prefill(jc, cache_len=P_ + N_))
    decode = jax.jit(jax_decode(jc))
    logits, cache = prefill(jp, jb)
    box = {"cache": cache,
           "tok": jnp.argmax(logits, -1)[:, None].astype(jnp.int32)}

    def decode_once():
        box["tok"], _, box["cache"] = decode(jp, box["tok"], box["cache"])

    state = lambda: {"params": jp, "cache": box["cache"]}  # noqa: E731
    dest, report = jax_precopy.migrate(state, decode_once,
                                       jax_precopy.PrecopyConfig(**PCFG))
    return dest, report, state()


def test_serve_migration_flow_matches_jax():
    jc, tc, jp, tp, jb, tb = _replicas({}, B_, P_)
    jdest, jrep, jlive = _jax_flow(jc, jp, jb)

    prefill = make_prefill_step(tc, cache_len=P_ + N_)
    decode = make_decode_step(tc)
    logits, cache = prefill(tp, tb)
    box = {"cache": cache, "tok": logits.argmax(-1)[:, None].to(torch.int32),
           "produced": 0}

    def decode_once():
        box["tok"], _, box["cache"] = decode(tp, box["tok"], box["cache"])
        box["produced"] += 1

    state = lambda: {"params": tp, "cache": box["cache"]}  # noqa: E731
    dest, rep = precopy.migrate(state, decode_once,
                                precopy.PrecopyConfig(**PCFG))
    assert (rep.outcome.rounds, rep.outcome.stop_reason) == \
        (jrep.outcome.rounds, jrep.outcome.stop_reason)
    assert rep.per_round_dirty_bytes == jrep.per_round_dirty_bytes
    assert rep.v_mem == jrep.v_mem
    assert box["produced"] == rep.outcome.rounds
    # the port's destination is its live state, bit for bit
    for a, b in zip(tree.leaves(dest), tree.leaves(state())):
        assert torch.equal(a.view(-1).view(torch.uint8)
                           if a.dim() else a, b.view(-1).view(torch.uint8)
                           if b.dim() else b)
    assert len(tree.leaves(dest)) == len(jax.tree.leaves(jdest))
    # decode resumes on the destination, as on the live replica
    t_live, _, _ = decode(tp, box["tok"], box["cache"])
    t_dest, _, _ = decode(dest["params"], box["tok"], dest["cache"])
    assert torch.equal(t_live, t_dest)
