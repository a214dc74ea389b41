"""Multi-pod dry run: trace rank 0's step of every (architecture x input
shape) on the production meshes and record its memory, flops, HBM bytes
and collective bytes.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell on 256 or 512 forced host devices and reads the
partitioned HLO. The port runs one process a rank, so it traces the
program of one rank: rank 0 of a fake process group of 256 ranks (the
single-pod (16, 16) ``("data", "model")`` mesh) or 512 (the 2-pod
(2, 16, 16) ``("pod", "data", "model")`` mesh), built by
``launch/mesh.make_production_mesh`` on the ``cpu`` device type (the fake
group moves no data, so its mesh needs no card). The inputs are fake
tensors (``FakeTensorMode``: shapes, dtypes and strides, no memory) made
from ``launch/specs.input_specs`` and cut to rank 0's slices by
``launch/sharding``'s rules. The step runs under ``dist.use`` with the
``make_constrain`` hooks, as the reference's ``lower_cell``, and under
``launch/trace_analysis.TraceAnalysis``. Collectives reach the fake group,
which returns at once; B4 and B5 run their shape-only forms
(``kernels/ops.py``): no kernel library is built, loaded or launched.

Traced device (``--device``). ``cuda`` (the default) traces the card's
path, where B4 and B5 are the custom ops and their flop formulas. It
needs a CUDA build of torch and a visible card (torch's Python bindings
of indexing, ``contiguous`` and ``copy_`` set the tensor's device, fake or
not), but no card memory. On a build without CUDA a ``cuda`` cell is
refused before it starts: those bindings fail there, and a train cell's
backward would abort the process (the autograd engine's CUDA thread).
``cpu`` traces the CPU path, where B4 and B5 are their plain versions
(``models/gla.gla_chunked``, ``kernels/ref.attention_chunked``); the
record's ``device`` says which.

What the reference records and the port does not: ``compile_s`` and
``xla_cost_analysis`` (there is no compiler; ``lower_s`` becomes
``trace_s``) and ``generated_code_size_in_bytes``. Refused options:
``--inner-shard`` (the expert FFN's inner dim over ``data``; the port's
MoE refuses that layout, ``models/blocks._moe_ffn_sharded``) and
``--free-cache-out`` (an XLA output-layout choice; the port's prefill
writes the cache in the rules' layout, ``lm.init_cache``). A step that
reads a value on the host (``.item()``, ``.tolist()``, ``nonzero``) fails
under fake tensors, and its record says so; the train step is traced
without telemetry, as the reference's.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2_1p8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both     # 66 cells, a process each
  python -m repro_torch.launch.dryrun --arch rwkv6_1p6b --shape decode_32k --device cpu

Results go to ``experiments/dryrun_torch/<arch>_<shape>_<mesh>[_tag].json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import traceback
import warnings
from typing import Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.trace_analysis import analyze
from repro_torch.models import dist
from repro_torch.train import (make_decode_step, make_prefill_step,
                               make_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "experiments" / "dryrun_torch"
WORLD = {"single": 256, "multi": 512}

INNER_SHARD_REFUSED = (
    "--inner-shard: the expert FFN's inner dim over 'data' is not ported; "
    "'data' is also the token axis, so its partial-output sum would mix "
    "tokens (models/blocks._moe_ffn_sharded refuses it)")
FREE_CACHE_OUT_REFUSED = (
    "--free-cache-out: an XLA choice of the prefill cache's output layout; "
    "the port's prefill writes the cache in the rules' layout as it runs "
    "(lm.init_cache), so there is no layout to leave free")


def _coerce(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(v.lower(), v)


def fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world`` ranks
    (collectives return at once, moving nothing); an existing fake group
    of that size is kept, any other group refused."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        if tdist.get_backend() != "fake" or tdist.get_world_size() != world:
            raise RuntimeError(f"a process group of {tdist.get_world_size()}"
                               f" ranks ({tdist.get_backend()}) is already "
                               f"initialised; the dry run needs a fake one "
                               f"of {world}")
        return
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world)


def _fake(spec: torch.Tensor, device: torch.device) -> torch.Tensor:
    return torch.empty_strided(tuple(spec.shape), spec.stride(),
                               dtype=spec.dtype, device=device)


def cell_args(cfg: ArchConfig, shape: ShapeConfig, mesh,
              device: torch.device) -> Tuple[str, Tuple]:
    """(mode, rank 0's step arguments): ``specs.input_specs`` made on
    ``device`` and cut by ``launch/sharding``'s rules on ``mesh`` (whole
    without one). Call it under a ``FakeTensorMode``, which makes the
    tensors fake; ``mesh`` may be duck-typed (``mesh_dim_names``,
    ``shape``, ``get_local_rank``)."""
    mode, specs = input_specs(cfg, shape)
    args = sharding.walk(lambda p, t: _fake(t, device), specs)
    if mesh is None:
        return mode, args
    if mode == "train":
        return mode, (sharding.state_shardings(mesh, args[0]),
                      sharding.batch_shardings(mesh, args[1]))
    if mode == "prefill":
        return mode, (sharding.param_shardings(mesh, args[0]),
                      sharding.batch_shardings(mesh, args[1]))
    params, token, cache = args
    return mode, (sharding.param_shardings(mesh, params),
                  sharding.batch_shardings(mesh, {"tokens": token})["tokens"],
                  sharding.cache_shardings(mesh, cfg, cache))


def step_fn(cfg: ArchConfig, shape: ShapeConfig, mode: str, mesh):
    """(the step of ``mode``, its ``dist`` context): the train step without
    telemetry, the prefill step with a cache of ``seq_len``, or the decode
    step, with the hooks on ``mesh`` (none without one)."""
    hooks, ctx = {}, None
    if mesh is not None:
        hooks = dict(constrain=sharding.make_constrain(mesh, cfg),
                     constrain_logits=sharding.make_constrain_logits(mesh))
        ctx = dist.model_context(mesh, cfg.seq_shard)
    if mode == "train":
        return make_train_step(cfg, **hooks), ctx
    hooks.pop("constrain_logits", None)
    if mode == "prefill":
        return make_prefill_step(cfg, cache_len=shape.seq_len, **hooks), ctx
    # decode: one position cannot be split over the model axis
    return make_decode_step(cfg, **hooks), (
        None if ctx is None else dataclasses.replace(ctx, seq_shard=False))


def refuse_without_cuda_build(mode: str, device: torch.device) -> None:
    """A ``cuda`` cell needs torch built with CUDA. Without it a train
    cell's backward would abort the process (the autograd engine's CUDA
    thread), and every cell stops at the first index, ``contiguous`` or
    ``copy_``, whose Python binding guards the tensor's CUDA device."""
    if device.type == "cuda" and not torch.backends.cuda.is_built():
        why = ("its backward runs on the autograd engine's CUDA thread, "
               "which aborts a build without CUDA" if mode == "train" else
               "torch's indexing, contiguous and copy_ guard the CUDA "
               "device, which a build without CUDA does not have")
        raise RuntimeError(f"a cuda {mode} cell needs torch built with "
                           f"CUDA: {why}; trace it with --device cpu")


def trace(cfg: ArchConfig, shape: ShapeConfig, mesh, device) -> dict:
    """Rank 0's step of ``cfg`` at ``shape`` on ``mesh`` (``None``: one
    rank, the local path), traced on fake tensors of ``device``. Returns
    the record's measured part: mode, memory, flops, hbm bytes,
    collectives (link bytes by kind, with ``total``), their calls and raw
    input bytes by kind, ops, trace_s."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = torch.device(device)
    refuse_without_cuda_build(shape.mode, device)
    t0 = time.perf_counter()
    with FakeTensorMode():
        mode, args = cell_args(cfg, shape, mesh, device)
        fn, ctx = step_fn(cfg, shape, mode, mesh)
        with dist.use(ctx):
            out, a = analyze(fn, *args)
        memory = a.memory(args, out)
    t = a.totals()
    coll = {k[5:]: v for k, v in t.items() if k.startswith("coll_")}
    return {"mode": mode, "memory": memory, "flops": t["flops"],
            "flops_by_op": a.flops_by_op,
            "hbm_bytes": t["hbm_bytes"],
            "hbm_write_bytes": t["hbm_write_bytes"], "collectives": coll,
            "collective_calls": {k: r["calls"]
                                 for k, r in a.collectives.items()},
            "collective_input_bytes": {k: r["input_bytes"]
                                       for k, r in a.collectives.items()},
            "ops": a.ops, "trace_s": time.perf_counter() - t0}


def _untouched_kernels() -> list:
    """The kernel libraries loaded in this process, which must be none;
    raises if one was loaded or a kernel launched."""
    from repro_torch.kernels import build, ops
    loaded = sorted(build._LOADED)
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if loaded or launched:
        raise AssertionError(f"the trace touched a kernel: libraries "
                             f"{loaded}, launches {launched}")
    return loaded


def run_custom(cfg: ArchConfig, shape: ShapeConfig, mesh_shape,
               device: str = "cuda") -> dict:
    """A cell of any config and shape: rank 0 of a fake group of
    prod(``mesh_shape``) ranks on a ``(data, model)`` mesh of that shape,
    or with ``mesh_shape`` None one rank on the local path (no group).
    Returns ``trace``'s record with ``kernels_loaded``."""
    from repro_torch.launch.mesh import device_mesh
    refuse_without_cuda_build(shape.mode, torch.device(device))
    mesh = None
    if mesh_shape:
        fake_group(math.prod(mesh_shape))
        mesh = device_mesh(tuple(mesh_shape), ("data", "model"),
                           device="cpu")
    got = trace(cfg, shape, mesh, device)
    return {**got, "kernels_loaded": _untouched_kernels()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[dict] = None, *,
             device: str = "cuda") -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    mesh_name = "multi" if multi_pod else "single"
    refuse_without_cuda_build(SHAPES[shape_name].mode, torch.device(device))
    fake_group(WORLD[mesh_name])
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    got = trace(cfg, SHAPES[shape_name], mesh, device)
    mem = got["memory"]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "devices": int(mesh.size()), "rank": 0, "device": device,
           **got, "kernels_loaded": _untouched_kernels(), "ok": True}
    print(f"[dryrun] {arch} {shape_name} {mesh_name} {device} OK "
          f"flops={rec['flops']:.4e} hbm={rec['hbm_bytes']:.4e} "
          f"coll={rec['collectives'].get('total', 0):.4e} "
          f"temp={mem['temp_size_in_bytes'] / 2**30:.4f}GiB "
          f"args={mem['argument_size_in_bytes'] / 2**30:.4f}GiB "
          f"trace={rec['trace_s']:.2f}s")
    return rec


def cells(mesh_sel: str):
    for arch in ARCH_IDS:
        for shape in shapes_for(get_config(arch)):
            for m in (["single", "multi"] if mesh_sel == "both"
                      else [mesh_sel]):
                yield arch, shape.name, m


def _out_path(out_dir, arch: str, shape: str, mesh: str, tag: str = ""):
    return out_dir / f"{arch}_{shape}_{mesh}{'_' + tag if tag else ''}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have results")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device type the fake tensors are on")
    ap.add_argument("--inner-shard", action="store_true",
                    help="refused: " + INNER_SHARD_REFUSED)
    ap.add_argument("--free-cache-out", action="store_true",
                    help="refused: " + FREE_CACHE_OUT_REFUSED)
    ap.add_argument("--tag", default="",
                    help="suffix for the result file")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the result files")
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor",
                            category=FutureWarning)
    for flag, why in ((args.inner_shard, INNER_SHARD_REFUSED),
                      (args.free_cache_out, FREE_CACHE_OUT_REFUSED)):
        if flag:
            print(f"[dryrun] refused {why}", file=sys.stderr)
            return 2
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        env = dict(os.environ)
        src = str(ROOT / "src")
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        passed = ["--out", str(out_dir)] + [
            f for kv in args.overrides for f in ("--set", kv)]
        if args.tag:
            passed += ["--tag", args.tag]
        failures = []
        for arch, shape, m in cells(args.mesh):
            out = _out_path(out_dir, arch, shape, m, args.tag)
            if out.exists() and not args.force:
                print(f"[dryrun] skip {out.name} (exists)")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", m,
                   "--device", args.device, *passed]
            if subprocess.run(cmd, cwd=str(ROOT), env=env).returncode:
                failures.append((arch, shape, m))
        if failures:
            print("FAILURES:", failures)
            return 1
        print("[dryrun] all cells OK")
        return 0

    if not (args.arch and args.shape and args.mesh in ("single", "multi")):
        ap.error("name --arch, --shape and --mesh single|multi, or --all")
    out = _out_path(out_dir, args.arch, args.shape, args.mesh, args.tag)
    overrides = {k: _coerce(v) for k, v in
                 (kv.split("=", 1) for kv in args.overrides)}
    try:
        rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                       overrides or None, device=args.device)
        rec["tag"] = args.tag
        rec["overrides"] = overrides
    except Exception as e:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "device": args.device, "ok": False,
               "error": f"{type(e).__name__}: {e}", "tag": args.tag,
               "overrides": overrides}
        out.write_text(json.dumps(rec, indent=2))
        traceback.print_exc()
        return 1
    out.write_text(json.dumps(rec, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
