"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels built or loaded, inputs and weights made from the seed,
the cell's shapes warmed up) runs first; then the window: ``--seconds`` of
the cell's traffic, or with ``--trace 1`` a short traced stretch of it
under ``torch.profiler``. Once the window has closed and the program's
state is freed, the cell's plain reference judges what the window
produced. The last line on standard output is one JSON object: correct,
attempted, failed, the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), the device, and the numbers compared
with their limits; the same numbers end standard error.

Exits 3 without a card (or with fewer cards than the cell asks for), 2
where the program's package is missing, 4 where a JAX module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX from libraries."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in reported


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    _environment()
    import torch
    from portbench.lib import harness as H

    bench = H.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} card(s); CUDA available: "
              f"{torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    wl, cfg = H.cell_files(args.workload)
    ctx = H.Ctx(args.workload, wl, cfg, H.seed_int(args.seed), args.seconds,
                bool(args.trace), device="cuda", t_start=T_START)
    out = H.load_module("drivers", wl["driver"]).run(ctx)

    bad = H.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4

    cell = args.workload
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, {m["name"]})]
    reported = {m["name"] for m in e2e}
    metrics = {}
    if not args.trace:
        values = {"setup_s": out["setup_s"], **out["metrics"]}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        rec = out["record"]
        for m in bench["per_layer"]:
            if not _applies(m, cell, reported):
                continue
            v = H.load_module("layer_metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": all(c.ok for c in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = out["record"].busy_s
        device["window_s"] = out["record"].window_s
        result["breakdown"] = out["record"].breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out["checks"]}
    print(f"card: {_card_line()}; setup {out['setup_s']:.3f} s, window "
          f"{out['window_s']:.3f} s, check {out.get('check_s', 0.0):.3f} s, "
          f"compared {out.get('compared')}", file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c.name}: {c.value} (limit {c.limit})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
