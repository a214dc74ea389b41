"""Ranks of the port's sharded paths on the CPU, for the tests.

``launch([(suite, world), ...], workdir)`` starts, for each group,
``world`` processes of this script, each one rank of a ``gloo`` group
whose ``FileStore`` lies in ``workdir`` (no port, so test files run in
parallel), and waits for them all. Each rank reads its inputs from
``workdir/inputs.npz`` (written by the test), runs every case of its suite
and writes what it computed to ``workdir/<suite><world>_rank<r>.npz``
(``load``); the tests compare those files. A rank that fails exits
non-zero and ``launch`` raises with its output.

Suites:
  ``shard`` -- the decide plane (``core/shard.py``, ``kernels.ops`` with a
               mesh, ``SurveillanceEngine(shards=k)``), sharded and not;
  ``moe``   -- the expert-parallel MoE layer on a (2, 2) mesh against the
               port's local path, and at the config's capacity for the
               comparison with the JAX package;
  ``tp``    -- the whole model (five wirings) on (2, 2) and (1, 4) meshes,
               three more uniform configs on (2, 2): a train step's
               gradients and state, a prefill and decode steps, gathered
               back, beside the port's local path (rank 0); then
               ``elastic.rescale`` from (2, 2) to (1, 4);
  ``tp_ssm`` -- the same for the SSM and hybrid wirings (zamba2, rwkv6, a
               uniform Mamba2 stack) over a sequence that crosses a scan
               chunk, the gradients of TP_MUTANTS' broken variants, and
               zamba2's rescale.
  ``trace`` -- the dry run's cells of TRACE_ARCHS on a (2, 2) mesh of real
               tensors, each step counted by ``launch/trace_analysis``;
  ``trace_fake`` -- one process, no gloo group: the same cells traced by
               ``launch/dryrun.trace`` as rank 0 of a fake group of 4.

``run_tp_suite`` runs a "tp" suite's ranks beside the JAX package's
GSPMD steps on the same inputs (``JAX_SCRIPT``).

Run by hand: ``python tests/torch_dist_worker.py SUITE RANK WORLD WORKDIR``.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 240


def launch(groups, workdir) -> None:
    """Start every (suite, world) group of ``groups`` at once, ``world``
    processes each, and wait for all of them."""
    workdir = pathlib.Path(workdir)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    env["OMP_NUM_THREADS"] = "1"
    procs = [((suite, world, r), subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True))
        for suite, world in groups for r in range(world)]
    outs = []
    try:
        for _, p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT)[0])
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(who, p.returncode, out[-4000:])
           for (who, p), out in zip(procs, outs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed: {bad}")


def load(suite: str, world: int, rank: int, workdir):
    return np.load(pathlib.Path(workdir) / f"{suite}{world}_rank{rank}.npz")


# ---------------------------------------------------------------------------
# suite "shard"
# ---------------------------------------------------------------------------
SHARD_J, SHARD_WINDOW = 29, 128
#: samples recorded before each tick: first fit, slid windows, a blackout
#: of jobs 0..5 over steps 150..229, recovery
SHARD_RECORDS = (SHARD_WINDOW, 7, 23, 40, 70, 30)
SHARD_STEPS = sum(SHARD_RECORDS)
BLACKOUT_JOBS, BLACKOUT_STEPS = 6, (150, 230)


def tick_record(eng, now: int, res) -> dict:
    """Everything a tick decided, as arrays in job order."""
    ids = sorted(eng.jobs)
    pending = res.pending
    remain = res.remain
    out = {"pending": np.asarray(pending),
           "remain": np.asarray([remain.get(i, -1) for i in ids]),
           "scheduled_at": np.asarray([now + remain.get(i, 0) for i in ids]),
           "refitted": np.asarray(res.refitted),
           "fleet": np.asarray(res.fleet),
           "confidence": np.asarray([res.confidence.get(i, -1.0)
                                     for i in ids])}
    jobs = [eng.jobs[i] for i in ids]
    out["period"] = np.asarray([j.model.period if j.model else -1
                                for j in jobs])
    width = max([len(j.model.profile_lm) for j in jobs if j.model] + [1])
    prof = np.full((len(jobs), width), -2, np.int8)
    for k, j in enumerate(jobs):
        if j.model is not None:
            prof[k, :len(j.model.profile_lm)] = j.model.profile_lm
    out["profile"] = prof
    out["lm_series"] = np.stack([np.asarray(j.lm_series, np.int8)
                                 for j in jobs])
    out["fitted_step"] = np.asarray([j.fitted_step for j in jobs])
    out["origin_step"] = np.asarray([j.origin_step for j in jobs])
    return out


def run_ticks(make_engine, make_fleet, vals: np.ndarray, nb) -> list:
    """The tick sequence of ``SHARD_RECORDS`` on a new engine, then a full
    refit and ``next_refresh_step`` at three steps. Returns one record per
    tick (the last is the full refit's, with ``next_refresh``)."""
    fleet = make_fleet(SHARD_J, capacity=2 * SHARD_WINDOW)
    eng = make_engine()
    for i in range(SHARD_J):
        eng.register(f"j{i:02d}", fleet.view(i), nb, window=SHARD_WINDOW)
    recs, step = [], 0
    for n in SHARD_RECORDS:
        for _ in range(n):
            v = vals[step].copy()
            if BLACKOUT_STEPS[0] <= step < BLACKOUT_STEPS[1]:
                v[:BLACKOUT_JOBS] = np.nan
            fleet.record_fleet(step, v)
            step += 1
        recs.append(tick_record(eng, step - 1, eng.tick(step - 1)))
    eng.refresh(force=True)
    rec = tick_record(eng, step - 1, eng.tick(step - 1))
    rec["next_refresh"] = np.asarray(
        [eng.next_refresh_step(s) for s in (step, step + 3, step + 50)])
    recs.append(rec)
    return recs


def _shard_suite(rank: int, world: int, inp) -> dict:
    import torch
    from repro_torch.core import characterize, postpone as pp, shard
    from repro_torch.core.surveillance import SurveillanceEngine
    from repro_torch.core.telemetry import FleetTelemetry
    from repro_torch.kernels import ops

    def fleet(n, capacity):
        return FleetTelemetry(n, capacity=capacity, device="cpu")

    nb = characterize.naive_bayes_from_arrays(
        inp["nb_edges"], inp["nb_ll"], inp["nb_prior"], device="cpu")
    out = {"device_count": np.asarray(shard.device_count())}
    for k in sorted({2, world}):
        mesh = shard.decide_mesh(k, device="cpu")
        for J in (4, 7):
            W = torch.as_tensor(inp[f"windows{J}"])
            out[f"k{k}_classify{J}"] = shard.classify_lm(nb, W, mesh).numpy()
            out[f"k{k}_classify{J}_ref"] = \
                characterize.classify_lm_batch(nb, W).numpy()
        for J in (6, 9):
            args = [torch.as_tensor(inp[f"{n}{J}"])
                    for n in ("profiles", "periods", "m_now")]
            out[f"k{k}_postpone{J}"] = \
                shard.postpone_rows(*args, mesh).numpy()
            out[f"k{k}_postpone{J}_async"] = shard.postpone_rows(
                *args, mesh, async_op=True).wait().numpy()
            out[f"k{k}_postpone{J}_ref"] = pp.postpone_batch(*args).numpy()
        x = torch.as_tensor(inp["rows"])
        lags = torch.arange(3, 40, dtype=torch.int32)
        out[f"k{k}_spectrum"] = ops.power_spectrum(x, center=True,
                                                   mesh=mesh).numpy()
        out[f"k{k}_spectrum_ref"] = ops.power_spectrum(x, center=True).numpy()
        out[f"k{k}_scores"] = ops.autocorr_score(x, lags, mesh=mesh).numpy()
        out[f"k{k}_scores_ref"] = ops.autocorr_score(x, lags).numpy()
        for overlap in (False, True):
            recs = run_ticks(lambda: SurveillanceEngine(
                shards=k, overlap=overlap, device="cpu"), fleet, inp["vals"],
                nb)
            for t, rec in enumerate(recs):
                for name, v in rec.items():
                    out[f"k{k}_o{int(overlap)}_t{t}_{name}"] = v
    recs = run_ticks(lambda: SurveillanceEngine(device="cpu"), fleet,
                     inp["vals"], nb)
    for t, rec in enumerate(recs):
        for name, v in rec.items():
            out[f"ref_t{t}_{name}"] = v
    try:
        shard.decide_mesh(world + 1, device="cpu")
    except ValueError:
        out["too_many_refused"] = np.asarray(True)
    return out


# ---------------------------------------------------------------------------
# suite "moe"
# ---------------------------------------------------------------------------
#: (name, arch, mode, dtype, capacity factor, x shape); "local" cases are
#: held to the port's local path, "jax" cases to the JAX package's
#: ``_moe_ffn_sharded``
MOE_CASES = (
    ("local_bf16", "qwen3_moe_30b_a3b", "slice", "bfloat16", 8.0, (4, 32)),
    ("local_f32", "qwen3_moe_30b_a3b", "slice", "float32", 8.0, (4, 32)),
    ("jax_qwen3_slice", "qwen3_moe_30b_a3b", "slice", "float32", None,
     (4, 32)),
    ("jax_qwen3_dup", "qwen3_moe_30b_a3b", "dup", "float32", None, (2, 1)),
    ("jax_qwen3_seq", "qwen3_moe_30b_a3b", "seq", "float32", None, (4, 32)),
    ("jax_kimi_slice", "kimi_k2_1t_a32b", "slice", "float32", None, (4, 32)),
    ("jax_kimi_dup", "kimi_k2_1t_a32b", "dup", "float32", None, (2, 1)),
    ("jax_kimi_seq", "kimi_k2_1t_a32b", "seq", "float32", None, (4, 32)),
)
MOE_MESH = (2, 2)
#: the gradient check's case (no drops, f32)
GRAD_CASE = "local_f32"


def moe_config(arch: str, dtype: str, cf, pkg):
    """The smoke config of ``arch`` in ``pkg`` (the JAX package's or the
    port's ``get_config``) with 8 experts, top-2 and the given capacity
    factor; ``None`` takes the full config's (drops happen there)."""
    import dataclasses
    full = pkg(arch)
    cfg = full.smoke().replace(param_dtype=dtype)
    cf = full.moe.capacity_factor if cf is None else cf
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _moe_layer(torch, cfg, flat, prefix):
    """The first MoE layer of the params saved under ``prefix``, through
    ``convert.params_from_numpy``."""
    from repro_torch.models import convert, lm
    tree: dict = {}
    for key in flat.files:
        if not key.startswith(prefix + "/"):
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    n = cfg.num_layers - cfg.first_k_dense
    return lm._unstack(params["blocks"], n)[0]["moe"]


def _moe_suite(rank: int, world: int, inp) -> dict:
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import blocks, dist

    mesh = meshlib.make_host_mesh(*MOE_MESH, device="cpu")
    out = {"coord": np.asarray(mesh.get_coordinate())}
    drops, combine = [], blocks._combine

    def counted(y, slot, gate, T):
        drops.append(int((slot >= y.shape[0] * y.shape[1]).sum()))
        return combine(y, slot, gate, T)

    blocks._combine = counted
    for name, arch, mode, dtype, cf, (B, S) in MOE_CASES:
        cfg = moe_config(arch, dtype, cf, get_config)
        full = _moe_layer(torch, cfg, inp, f"{name}/params")
        x = torch.as_tensor(inp[f"{name}/x"]).to(cfg.dtype)
        ctx = dist.DistContext(mesh, ("data",), seq_shard=mode == "seq")
        mine = blocks.moe_shard_params(mesh, full)
        xl = dist.local_tokens(ctx, x)
        drops.clear()
        with dist.use(ctx):
            y, aux = blocks.moe_ffn(mine, cfg, xl)
        out[f"{name}/out"] = y.float().numpy()
        out[f"{name}/aux"] = aux.detach().numpy()
        out[f"{name}/drops"] = np.asarray(drops)
        drops.clear()
        want, want_aux = blocks.moe_ffn(full, cfg, x)
        out[f"{name}/local_out"] = dist.local_tokens(ctx, want).float().numpy()
        out[f"{name}/local_aux"] = want_aux.numpy()
        if name == GRAD_CASE:
            out.update(_moe_grads(torch, tdist, blocks, dist, mesh, ctx, cfg,
                                  full, x, name))
    blocks._combine = combine
    return out


def _moe_grads(torch, tdist, blocks, dist, mesh, ctx, cfg, full, x, name):
    """Gradients of sum(out) + aux through the expert-parallel path (every
    rank's loss scaled so that the ranks' losses sum to the local path's)
    against the local path's. A leaf replicated over an axis gets the sum
    of its replicas' gradients (what data parallelism all-reduces): the
    router over ``data``, the token block over ``model``."""
    keys = ("router", "w_gate", "w_up", "w_down")
    mine = {k: v.clone().requires_grad_(True)
            for k, v in blocks.moe_shard_params(mesh, full).items()}
    xl = dist.local_tokens(ctx, x).clone().requires_grad_(True)
    tp_n = mesh.size(1)
    with dist.use(ctx):
        y, aux = blocks.moe_ffn(mine, cfg, xl)
    (y.sum() / tp_n + aux / mesh.size()).backward()
    tdist.all_reduce(mine["router"].grad, group=mesh.get_group("data"))
    tdist.all_reduce(xl.grad, group=mesh.get_group("model"))
    ref = {k: v.clone().requires_grad_(True) for k, v in full.items()}
    xr = x.clone().requires_grad_(True)
    yr, auxr = blocks.moe_ffn(ref, cfg, xr)
    (yr.sum() + auxr).backward()
    want = blocks.moe_shard_params(mesh, {k: ref[k].grad for k in keys})
    out = {f"{name}/grad_x": xl.grad.numpy(),
           f"{name}/grad_x_ref": dist.local_tokens(ctx, xr.grad).numpy()}
    for k in keys:
        out[f"{name}/grad_{k}"] = mine[k].grad.numpy()
        out[f"{name}/grad_{k}_ref"] = want[k].numpy()
    return out


# ---------------------------------------------------------------------------
# suites "tp" and "tp_ssm"
# ---------------------------------------------------------------------------
#: the five wirings the model on a mesh runs: dense, qk_norm, SWA, moe,
#: prefix_dense with seq_shard and Adafactor
TP_ARCHS = ("internlm2_1p8b", "qwen3_8b", "h2o_danube3_4b",
            "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b")
#: more uniform configs, on (2, 2) only: a GELU MLP (starcoder2), M-RoPE
#: positions (3, B, S) with a stub frontend prefix (qwen2-vl), the stub
#: frontend prefix alone (musicgen)
TP_EXTRA_ARCHS = ("starcoder2_7b", "qwen2_vl_2b", "musicgen_medium")
TP_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: train batch, sequence (= prompt), decode cache and decode steps; the
#: cache's window (20, or danube's 8) divides 4, so on (1, 4), where the 2
#: KV heads do not, the KV ring is cut along its window
TP_BATCH, TP_SEQ, TP_CACHE, TP_DECODE = 4, 16, 20, 2
#: the elastic case: its arch, the pre-copy's block and source steps
TP_ELASTIC = ("internlm2_1p8b", 256)
#: the SSM and hybrid wirings: zamba2 (hybrid_shared: 2 groups of 5
#: Mamba2 layers and the shared attention, 8 Mamba2 heads, 4 query and 2
#: KV heads), rwkv6 (4 wkv heads) and a uniform Mamba2 stack
TP_SSM_ARCHS = ("zamba2_2p7b", "rwkv6_1p6b", "mamba2_stack")
#: a sequence that crosses the scan's chunk of 32 (the state carried into
#: a second chunk); a cache of 52, which divides 4 (zamba2's ring cut
#: along its window on (1, 4))
TP_SSM_SEQ, TP_SSM_CACHE = 48, 52
TP_SSM_ELASTIC = ("zamba2_2p7b", 256)
#: mutations of the new gradient paths, each on (2, 2): (arch, name); the
#: leaf names drop the ``model`` sum of that leaf's gradient
#: (``dist.tp_block`` without ``tp_param``), ``norm_sum`` drops the gated
#: norm's all-reduce, ``norm_sum_backward`` only its backward
TP_MUTANTS = (("zamba2_2p7b", "A_log"), ("zamba2_2p7b", "conv_w"),
              ("rwkv6_1p6b", "faaaa"), ("zamba2_2p7b", "norm_sum"),
              ("zamba2_2p7b", "norm_sum_backward"))


def tp_config(arch: str, pkg):
    """The f32 smoke config of ``arch`` in ``pkg`` (either package's
    ``get_config``), with what each case exercises: block remat
    (internlm2, zamba2's groups, rwkv6's layers), a window of 8 (danube:
    the ring wraps in prefill), and kimi-k2's own ``seq_shard`` and full
    remat, which its smoke config turns off. ``mamba2_stack``: zamba2's
    smoke widths as a uniform stack of 2 Mamba2 layers."""
    if arch == "mamba2_stack":
        return pkg("zamba2_2p7b").smoke().replace(
            param_dtype="float32", block_pattern=("mamba",), num_layers=2)
    cfg = pkg(arch).smoke().replace(param_dtype="float32")
    return cfg.replace(**{"internlm2_1p8b": dict(remat="block"),
                          "h2o_danube3_4b": dict(sliding_window=8),
                          "kimi_k2_1t_a32b": dict(seq_shard=True,
                                                  remat="full"),
                          "zamba2_2p7b": dict(remat="block"),
                          "rwkv6_1p6b": dict(remat="block"),
                          }.get(arch, {}))


def tp_cases(suite: str):
    """The suite's (arch, mesh names) pairs, its sequence and its cache
    length."""
    if suite == "tp_ssm":
        return ([(a, tuple(TP_MESHES)) for a in TP_SSM_ARCHS], TP_SSM_SEQ,
                TP_SSM_CACHE)
    return ([(a, tuple(TP_MESHES)) for a in TP_ARCHS]
            + [(a, ("2x2",)) for a in TP_EXTRA_ARCHS], TP_SEQ, TP_CACHE)


def tp_inputs(suite: str, jax, jax_lm, jax_config) -> dict:
    """The suite's inputs from seeded numpy draws: each arch's weights from
    the JAX package's ``init_params`` (flat), tokens, targets (3 masked),
    a prompt and decode tokens; M-RoPE positions and a frontend prefix
    where the config reads them."""
    rng = np.random.default_rng(0)
    inp: dict = {}
    cases, seq, _ = tp_cases(suite)
    for seed, (arch, _) in enumerate(cases):
        cfg = tp_config(arch, jax_config)
        flat_tree(jax_lm.init_params(cfg, jax.random.key(seed + 1)),
                  f"{arch}/params", inp)
        V, shape = cfg.vocab_size, (TP_BATCH, seq)
        targets = rng.integers(0, V, shape, dtype=np.int32)
        targets[0, :3] = -1                     # masked positions
        inp[f"{arch}/tokens"] = rng.integers(0, V, shape, dtype=np.int32)
        inp[f"{arch}/targets"] = targets
        inp[f"{arch}/prompt"] = rng.integers(0, V, shape, dtype=np.int32)
        inp[f"{arch}/decode"] = rng.integers(
            0, V, (TP_DECODE, TP_BATCH, 1), dtype=np.int32)
        if cfg.mrope:                           # t, h and w streams
            t = np.arange(seq, dtype=np.int32)
            inp[f"{arch}/positions"] = np.broadcast_to(
                np.stack([t, t // 2, t % 5])[:, None], (3, *shape)).copy()
        if cfg.frontend_prefix:
            inp[f"{arch}/prefix_embeds"] = (0.5 * rng.standard_normal(
                (TP_BATCH, cfg.frontend_prefix, cfg.d_model))).astype(
                    np.float32)
    return inp


#: the JAX package's side, run as ``python -c JAX_SCRIPT WORKDIR TESTS
#: SUITE`` with 4 forced host devices: for each case its GSPMD steps on a
#: mesh of ``AxisType.Auto`` axes with the rules and hooks (the default
#: Explicit axes break the dense path at its embedding gather, ROADMAP
#: C-10), or its unsharded steps for a MoE config (ROADMAP C-9); writes
#: ``WORKDIR/jax_SUITE.npz``
JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import optim
from repro.configs import get_config
from repro.launch import sharding
from repro.train import steps
import torch_dist_worker as W

suite = sys.argv[3]
inp = np.load(os.path.join(sys.argv[1], "inputs.npz"))
cases, _, cache_len = W.tp_cases(suite)
EXTRA = ("positions", "prefix_embeds")


def subtree(prefix):
    tree = {}
    for k in inp.files:
        if k.startswith(prefix + "/"):
            node, parts = tree, k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(inp[k])
    return tree


out = {}
for arch, mesh_names in cases:
    cfg = W.tp_config(arch, get_config)
    params = subtree(arch + "/params")
    state = {"params": params, "opt": optim.init_opt_state(cfg, params),
             "step": jnp.zeros((), jnp.int32)}
    extra = {k: jnp.asarray(inp[f"{arch}/{k}"]) for k in EXTRA
             if f"{arch}/{k}" in inp.files}
    batch = {k: jnp.asarray(inp[f"{arch}/{k}"])
             for k in ("tokens", "targets")}
    batch.update(extra)
    prompt = {"tokens": jnp.asarray(inp[arch + "/prompt"]), **extra}
    meshes = ([(n, W.TP_MESHES[n]) for n in mesh_names] if cfg.moe is None
              else [("local", None)])
    for name, shape in meshes:
        hooks, st, b, pb = {}, state, batch, prompt
        if shape is not None:
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)
            hooks = dict(
                constrain=sharding.make_constrain(mesh, cfg),
                constrain_logits=sharding.make_constrain_logits(mesh))
            st = jax.device_put(state, sharding.state_shardings(mesh, state))
            b = jax.device_put(batch, sharding.batch_shardings(mesh, batch))
            pb = jax.device_put(prompt,
                                sharding.batch_shardings(mesh, prompt))
        pre = f"{name}/{arch}"
        grads = jax.jit(jax.grad(lambda p, b: steps.lm.lm_loss(
            p, cfg, b, **hooks)[0]))(st["params"], b)
        W.flat_tree(grads, pre + "/grads", out)
        new, m = jax.jit(steps.make_train_step(cfg, **hooks))(st, b)
        out[pre + "/step_loss"] = np.asarray(m["loss"])
        out[pre + "/grad_norm"] = np.asarray(m["grad_norm"])
        W.flat_tree(new, pre + "/state", out)
        ckw = {"constrain": hooks["constrain"]} if hooks else {}
        logits, cache = jax.jit(steps.make_prefill_step(
            cfg, cache_len, **ckw))(st["params"], pb)
        out[pre + "/prefill_logits"] = np.asarray(logits)
        W.flat_tree(cache, pre + "/prefill_cache", out)
        if shape is not None:
            cache = jax.device_put(
                cache, sharding.cache_shardings(mesh, cfg, cache))
        decode = jax.jit(steps.make_decode_step(cfg, **ckw))
        for t, tok in enumerate(inp[arch + "/decode"]):
            _, logits, cache = decode(st["params"], jnp.asarray(tok), cache)
            out[f"{pre}/decode{t}_logits"] = np.asarray(logits)
        W.flat_tree(cache, pre + "/decode_cache", out)
np.savez(os.path.join(sys.argv[1], f"jax_{suite}.npz"), **out)
print("JAX_TP_OK")
"""


def run_tp_suite(suite: str, work, inputs: dict):
    """``inputs`` written to ``work``; the JAX package's side
    (``JAX_SCRIPT``) and four ranks of ``suite`` run at once. Returns (the
    rank files, the JAX package's results)."""
    work = pathlib.Path(work)
    np.savez(work / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    jx = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(work),
                           os.path.dirname(os.path.abspath(__file__)), suite],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          env=env, text=True)
    try:
        launch([(suite, 4)], work)
        stdout, stderr = jx.communicate(timeout=LAUNCH_TIMEOUT)
    finally:
        if jx.poll() is None:
            jx.kill()
            jx.wait()
    if jx.returncode != 0 or "JAX_TP_OK" not in stdout:
        raise RuntimeError(f"the JAX side failed: {stderr[-3000:]}")
    ranks = [load(suite, 4, r, work) for r in range(4)]
    return ranks, np.load(work / f"jax_{suite}.npz")


def _subtree(flat, prefix):
    tree: dict = {}
    for key in flat.files:
        if key.startswith(prefix + "/"):
            node, parts = tree, key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


def flat_tree(tree, prefix, out) -> dict:
    """A nested dict (or tuple) of tensors/arrays as ``prefix/key/...``
    numpy entries of ``out``."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        key = f"{prefix}/{k}"
        if isinstance(v, (dict, tuple, list)):
            flat_tree(v, key, out)
        else:
            out[key] = (v.detach().float().numpy().copy()
                        if hasattr(v, "detach") else np.asarray(v))
    return out


@contextlib.contextmanager
def _backward_on_another_thread(torch):
    """``torch.autograd.grad`` run on a thread of its own, as the autograd
    engine runs a card's backward (on its device thread, where the
    caller's thread-local ``dist`` context is not set): a checkpointed
    layer's recompute must still see the mesh."""
    import threading
    grad = torch.autograd.grad

    def on_thread(*args, **kw):
        box = {}

        def run():
            try:
                box["out"] = grad(*args, **kw)
            except BaseException as e:          # re-raised by the caller
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    torch.autograd.grad = on_thread
    try:
        yield
    finally:
        torch.autograd.grad = grad


def _tp_run(torch, cfg, state, batch, prompt, tokens, *, mesh=None,
            cache_len=TP_CACHE, grads_only=False):
    """One train step's gradient, loss, grad norm and new state, a prefill
    and the decode steps, on ``mesh`` (this rank's slices, gathered back)
    or, without one, on the port's local path (``grads_only``: the loss
    and gradient alone). Returns flat numpy entries."""
    from repro_torch.launch import sharding
    from repro_torch.models import dist, lm
    from repro_torch.train import (make_decode_step, make_grad_fn,
                                   make_prefill_step, make_train_step)
    out: dict = {}
    hooks, ctx = {}, None
    gather = (lambda spec_fn, t: t)
    n_rows = prompt["tokens"].shape[0]
    full_cache = lm.init_cache(cfg, n_rows, cache_len, device="cpu")
    if mesh is not None:
        hooks = dict(constrain=sharding.make_constrain(mesh, cfg),
                     constrain_logits=sharding.make_constrain_logits(mesh))
        ctx = dist.model_context(mesh, cfg.seq_shard)

        def gather(specs, t):
            return sharding.gather_tree(mesh, specs, t)

        state_specs = sharding.state_specs(mesh, state)
        param_specs = sharding.param_specs(mesh, state["params"])
        cache_specs = sharding.cache_specs(mesh, cfg, full_cache)
        rows = sharding.batch_pspec(mesh, ("logits",), full_cache["pos"]
                                    .new_zeros(n_rows, 1))
        state = sharding.state_shardings(mesh, state)
        batch = sharding.batch_shardings(mesh, batch)
        prompt = sharding.batch_shardings(mesh, prompt)
        tokens = [sharding.batch_shardings(mesh, {"tokens": t})["tokens"]
                  for t in tokens]
    else:
        state_specs = param_specs = cache_specs = rows = None
    with dist.use(ctx):
        loss, metrics, grads = make_grad_fn(cfg, **hooks)(state["params"],
                                                           batch)
        out["loss"] = loss.numpy()
        flat_tree(gather(param_specs, grads), "grads", out)
        if grads_only:
            return out
        new, m = make_train_step(cfg, **hooks)(state, batch)
        out["step_loss"], out["grad_norm"] = m["loss"].numpy(), \
            m["grad_norm"].numpy()
        flat_tree(gather(state_specs, new), "state", out)
        logits, cache = make_prefill_step(
            cfg, cache_len, constrain=hooks.get("constrain", lm.Identity))(
                state["params"], prompt)
    if mesh is not None:
        logits = sharding.gather_leaf(mesh, rows, logits)
    out["prefill_logits"] = logits.numpy().copy()
    flat_tree(gather(cache_specs, cache), "prefill_cache", out)
    dec_ctx = None if ctx is None else dist.model_context(mesh, False)
    with dist.use(dec_ctx):
        decode = make_decode_step(cfg, constrain=hooks.get("constrain",
                                                           lm.Identity))
        for t, tok in enumerate(tokens):
            _, logits, cache = decode(state["params"], tok, cache)
            if mesh is not None:
                logits = sharding.gather_leaf(mesh, rows, logits)
            out[f"decode{t}_logits"] = logits.numpy().copy()
    flat_tree(gather(cache_specs, cache), "decode_cache", out)
    return out


def _tp_inputs(torch, inp, arch):
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.models import convert
    cfg = tp_config(arch, get_config)
    params = convert.params_from_numpy(cfg, _subtree(inp, f"{arch}/params"),
                                       device="cpu")
    state = {"params": params, "opt": optim.init_opt_state(cfg, params),
             "step": torch.zeros((), dtype=torch.int32)}
    t = {k: torch.as_tensor(inp[f"{arch}/{k}"])
         for k in ("tokens", "targets", "prompt", "decode")}
    extra = {k: torch.as_tensor(inp[f"{arch}/{k}"])
             for k in ("positions", "prefix_embeds")
             if f"{arch}/{k}" in inp.files}
    return (cfg, state, {"tokens": t["tokens"], "targets": t["targets"],
                         **extra},
            {"tokens": t["prompt"], **extra}, list(t["decode"]))


def _clone_state(torch, state):
    from repro_torch import tree
    return tree.map(lambda t: t.clone(), state)


def _tp_elastic(torch, inp, rank, case=TP_ELASTIC, key="elastic") -> dict:
    """``elastic.rescale`` of the (2, 2) state onto (1, 4) while the source
    keeps stepping; the destination held bit for bit to the slices cut from
    the gathered source at the stop, then one step on (1, 4)."""
    from repro_torch.core import precopy
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import dist
    from repro_torch.runtime import elastic
    from repro_torch.train import make_grad_fn, make_train_step
    arch, block = case
    cfg, state, batch, _, _ = _tp_inputs(torch, inp, arch)
    src = meshlib.make_host_mesh(2, 2, device="cpu")
    dst = meshlib.make_host_mesh(1, 4, device="cpu")
    s_specs = sharding.state_specs(src, state)
    d_specs = sharding.state_specs(dst, state)

    def run_on(mesh):
        hooks = dict(constrain=sharding.make_constrain(mesh, cfg),
                     constrain_logits=sharding.make_constrain_logits(mesh))
        return (dist.model_context(mesh, cfg.seq_shard),
                sharding.batch_shardings(mesh, batch), hooks)

    ctx, b_src, hooks = run_on(src)
    step = make_train_step(cfg, **hooks)
    box = {"state": sharding.state_shardings(src, state)}

    def step_once(st):
        with dist.use(ctx):
            box["state"], _ = step(st, b_src)
        return box["state"]

    got, rep = elastic.rescale(cfg, box["state"], step_once, dst, src=src,
                               pcfg=precopy.PrecopyConfig(block_elems=block))
    want = sharding.walk(
        lambda p, leaf, a, b: sharding.local_slice(
            dst, b, sharding.gather_leaf(src, a, leaf)),
        box["state"], (), s_specs, d_specs)
    from repro_torch import tree
    equal = all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                  tree.leaves(want)))
    with dist.use(ctx):
        src_loss = make_grad_fn(cfg, **hooks)(box["state"]["params"],
                                              b_src)[0]
    d_ctx, b_dst, d_hooks = run_on(dst)
    with dist.use(d_ctx):
        dst_loss = make_grad_fn(cfg, **d_hooks)(got["params"], b_dst)[0]
        _, m = make_train_step(cfg, **d_hooks)(got, b_dst)
    o = rep.precopy.outcome
    return {f"{key}/equal": np.asarray(equal),
            f"{key}/rounds": np.asarray(o.rounds),
            f"{key}/stop_reason": np.asarray(o.stop_reason),
            f"{key}/per_round": np.asarray(
                rep.precopy.per_round_dirty_bytes),
            f"{key}/devices": np.asarray([rep.src_devices,
                                          rep.dst_devices]),
            f"{key}/src_loss": src_loss.numpy(),
            f"{key}/dst_loss": dst_loss.numpy(),
            f"{key}/dst_step_loss": m["loss"].numpy(),
            f"{key}/step": np.asarray(int(got["step"]))}


@contextlib.contextmanager
def tp_mutant(name: str, params):
    """One of TP_MUTANTS in force while the block runs (module-level
    patches of ``models/dist``): a leaf's ``model`` sum dropped (the
    ``dist.tp_block`` calls on that leaf's storage run without
    ``tp_param``), or the gated norm's ``dist.tp_sum`` replaced by no sum
    (``norm_sum``) or by a sum whose backward is the identity
    (``norm_sum_backward``)."""
    from repro_torch.models import dist
    if name in ("norm_sum", "norm_sum_backward"):
        orig_sum = dist.tp_sum

        def no_sum(x, ctx):
            return x

        def forward_only(x, ctx):
            return dist.reduce_from_tp(x, ctx.mesh, ctx.tp_axis)

        dist.tp_sum = no_sum if name == "norm_sum" else forward_only
        try:
            yield
        finally:
            dist.tp_sum = orig_sum
        return
    leaf = (params["blocks"][name] if "blocks" in params
            else params["mamba"]["mixer"][name])
    ptr = leaf.untyped_storage().data_ptr()
    orig_block, orig_param = dist.tp_block, dist.tp_param

    def block(t, ctx, dim, ranges=None):
        if t.untyped_storage().data_ptr() != ptr:
            return orig_block(t, ctx, dim, ranges)
        dist.tp_param = lambda t, ctx: t
        try:
            return orig_block(t, ctx, dim, ranges)
        finally:
            dist.tp_param = orig_param

    dist.tp_block = block
    try:
        yield
    finally:
        dist.tp_block = orig_block


def _tp_suite(rank: int, world: int, inp) -> dict:
    import torch
    with _backward_on_another_thread(torch):
        return _tp_cases(torch, rank, inp, "tp")


def _tp_ssm_suite(rank: int, world: int, inp) -> dict:
    import torch
    with _backward_on_another_thread(torch):
        return _tp_cases(torch, rank, inp, "tp_ssm")


def _tp_cases(torch, rank: int, inp, suite: str) -> dict:
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import dist
    out: dict = {}
    cases, _, cache_len = tp_cases(suite)
    for name, shape in TP_MESHES.items():
        mesh = meshlib.make_host_mesh(*shape, device="cpu")
        for arch, meshes in cases:
            if name not in meshes:
                continue
            cfg, state, batch, prompt, tokens = _tp_inputs(torch, inp, arch)
            got = _tp_run(torch, cfg, state, batch, prompt, tokens,
                          mesh=mesh, cache_len=cache_len)
            if rank == 0:
                out.update({f"{name}/{arch}/{k}": v for k, v in got.items()})
    if suite == "tp_ssm":
        mesh = meshlib.make_host_mesh(*TP_MESHES["2x2"], device="cpu")
        for arch, name in TP_MUTANTS:
            cfg, state, batch, prompt, tokens = _tp_inputs(torch, inp, arch)
            with tp_mutant(name, state["params"]):
                got = _tp_run(torch, cfg, state, batch, prompt, tokens,
                              mesh=mesh, cache_len=cache_len,
                              grads_only=True)
            if rank == 0:
                out.update({f"mutant_{name}/{arch}/{k}": v
                            for k, v in got.items()})
    if rank == 0:
        with dist.use(None):
            for arch, _ in cases:
                cfg, state, batch, prompt, tokens = _tp_inputs(torch, inp,
                                                               arch)
                got = _tp_run(torch, cfg, state, batch, prompt, tokens,
                              cache_len=cache_len)
                out.update({f"local/{arch}/{k}": v for k, v in got.items()})
    if suite == "tp_ssm":
        out.update(_tp_elastic(torch, inp, rank, TP_SSM_ELASTIC,
                               "elastic_ssm"))
    else:
        out.update(_tp_elastic(torch, inp, rank))
    return out


# ---------------------------------------------------------------------------
# suites "trace" and "trace_fake"
# ---------------------------------------------------------------------------
#: the dry run held against real ranks: a dense wiring with block remat, an
#: RWKV6 stack (B4's plain path, over a sequence that crosses a scan chunk)
#: and a MoE wiring (its all-to-alls), smoke widths, f32
TRACE_ARCHS = ("internlm2_1p8b", "rwkv6_1p6b", "qwen3_moe_30b_a3b")
TRACE_BATCH, TRACE_SEQ = 4, 48
TRACE_MESH = (2, 2)


def trace_cases():
    """((arch, mode) -> (config, shape)) of the trace suites."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    out = {}
    for arch in TRACE_ARCHS:
        cfg = get_config(arch).smoke().replace(param_dtype="float32",
                                               remat="block")
        for mode in ("train", "prefill", "decode"):
            out[arch, mode] = (cfg, ShapeConfig(f"smoke_{mode}", TRACE_SEQ,
                                                TRACE_BATCH, mode))
    return out


#: the cells test_torch_dryrun.py also has the JAX package's analyzer count:
#: internlm2's smoke config as it is (bf16), remat none and block
ANALYZER_BATCH, ANALYZER_SEQ = 4, 64


def analyzer_cases():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    return {(f"analyzer_{remat}", mode): (
        get_config("internlm2_1p8b").smoke().replace(remat=remat),
        ShapeConfig(f"smoke_{mode}", ANALYZER_SEQ, ANALYZER_BATCH, mode))
        for remat in ("none", "block") for mode in ("prefill", "train")}


def trace_record(prefix: str, got: dict) -> dict:
    """A traced cell's counts as flat npz entries."""
    out = {f"{prefix}/{k}": np.float64(got[k])
           for k in ("flops", "ops", "hbm_bytes", "hbm_write_bytes")}
    for key in ("collective_calls", "collective_input_bytes"):
        for kind, v in got[key].items():
            out[f"{prefix}/{key}/{kind}"] = np.int64(v)
    for kind, v in got["collectives"].items():
        out[f"{prefix}/collectives/{kind}"] = np.float64(v)
    for k, v in got["memory"].items():
        out[f"{prefix}/memory/{k}"] = np.int64(v)
    return out


def _filled(torch, tree):
    """Values for real step arguments made empty: small normal floats (a
    fixed seed), zero integers."""
    g = torch.Generator().manual_seed(0)

    def fill(t):
        if t.dtype.is_floating_point:
            t.copy_(0.02 * torch.randn(t.shape, generator=g))
        else:
            t.zero_()
        return t

    from repro_torch.launch import sharding
    return sharding.walk(lambda p, t: fill(t), tree)


def _trace_suite(rank: int, world: int, inp) -> dict:
    """Each cell's step on this rank's real slices, counted."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.trace_analysis import analyze
    from repro_torch.models import dist
    mesh = meshlib.make_host_mesh(*TRACE_MESH, device="cpu")
    out = {}
    for (arch, mode), (cfg, shape) in trace_cases().items():
        _, args = dryrun.cell_args(cfg, shape, mesh, torch.device("cpu"))
        args = _filled(torch, args)
        fn, ctx = dryrun.step_fn(cfg, shape, mode, mesh)
        with dist.use(ctx):
            res, a = analyze(fn, *args)
        t = a.totals()
        out.update(trace_record(f"{arch}/{mode}", {
            **t, "ops": a.ops, "memory": a.memory(args, res),
            "collectives": {k[5:]: v for k, v in t.items()
                            if k.startswith("coll_")},
            "collective_calls": {k: r["calls"]
                                 for k, r in a.collectives.items()},
            "collective_input_bytes": {k: r["input_bytes"]
                                       for k, r in a.collectives.items()}}))
    return out


def _trace_fake_suite(rank: int, world: int, inp) -> dict:
    """The same cells traced by the dry run on fake tensors, rank 0 of a
    fake group of 4."""
    from repro_torch.launch import dryrun
    out = {}
    for (name, mode), (cfg, shape) in [*trace_cases().items(),
                                       *analyzer_cases().items()]:
        out.update(trace_record(f"{name}/{mode}", dryrun.run_custom(
            cfg, shape, TRACE_MESH, "cpu")))
    return out


def main(argv) -> int:
    suite, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), \
        pathlib.Path(argv[3])
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    if suite == "trace_fake":
        np.savez(workdir / f"{suite}{world}_rank{rank}.npz",
                 **_trace_fake_suite(rank, world, None))
        return 0
    store = workdir / f"store_{suite}_{world}"
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             rank=rank, world_size=world)
    try:
        inp = (np.load(workdir / "inputs.npz")
               if (workdir / "inputs.npz").exists() else None)
        out = {"shard": _shard_suite, "moe": _moe_suite,
               "tp": _tp_suite, "tp_ssm": _tp_ssm_suite,
               "trace": _trace_suite}[suite](
            rank, world, inp)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    np.savez(workdir / f"{suite}{world}_rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
