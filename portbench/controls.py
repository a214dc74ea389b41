"""Readings for the limits of ``correct``: each seed's run of a cell with
the check's numbers read twice, once for the program (the lower reading)
and once for the control (the reference in the program's place, computed
below the configuration's precision, or without the guarantee it breaks),
all seeds in one process. Not part of a benchmark run.

    python3 portbench/controls.py --workload <cell> --seconds <s> --seeds 1 2 3

Prints one JSON line a seed; ``--device cpu`` with ``--sizes`` (JSON) runs
a cell small without a card, as the tests do.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

T_START = time.perf_counter()


def readings(cell: str, seed: int, seconds: float, device: str,
             sizes: dict) -> dict:
    from portbench.lib import harness as H
    wl, cfg = H.cell_files(cell)
    ctx = H.Ctx(cell, wl, cfg, H.seed_int(seed), seconds, False,
                device=device, sizes=sizes, control=True)
    out = H.load_module("drivers", wl["driver"]).run(ctx)
    H.free_device(ctx)
    return {"cell": cell, "seed": seed,
            "lower": out["lower_reading"], "control": out["control_reading"],
            "limits": {c.name: c.limit for c in out["checks"]},
            "correct": all(c.ok for c in out["checks"]),
            "attempted": out["attempted"], "compared": out["compared"],
            "metrics": out["metrics"], "setup_s": out["setup_s"],
            "check_s": out.get("check_s")}


def main(argv=None) -> int:
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from portbench import run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="{}")
    args = ap.parse_args(argv)
    run._environment()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cuda" and not torch.cuda.is_available():
        print("controls: no card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        r = readings(args.workload, seed, args.seconds, args.device,
                     json.loads(args.sizes))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
