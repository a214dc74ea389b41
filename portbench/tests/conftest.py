"""Shared set-up of the benchmark's tests: the checkout and ``src`` on the
path, and small sizes at which every cell runs on the CPU in seconds."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {"batch": 4, "prompt": 40, "max_len": 64, "check_seqs": 4,
         "check_block": 2, "max_rounds": 3, "decode_steps": 8, "pool": 2,
         "block_elems": 64, "vms": 128, "window": 128, "extra_steps": 180,
         "warmup_ticks": 2, "check_share": 0.5}


def small_sizes(config: dict, **over) -> dict:
    """The traffic's small sizes, and the configuration keys its reference
    module puts over its file (``SMALL``), where it has any."""
    from portbench.lib import harness as H
    sizes = dict(SMALL)
    ref = H.load_module("refs", config["name"])
    if hasattr(ref, "SMALL"):
        sizes["config"] = dict(ref.SMALL)
    sizes.update(over)
    return sizes


@pytest.fixture
def run_small():
    """Run a cell small on the CPU: returns the driver's output."""
    from portbench.lib import harness as H

    def go(cell, seed=3, control=False, trace=False, seconds=0.2, **over):
        wl, cfg = H.cell_files(cell)
        ctx = H.Ctx(cell, wl, cfg, H.seed_int(seed), seconds, trace,
                    device="cpu", sizes=small_sizes(cfg, **over),
                    control=control)
        return H.load_module("drivers", wl["driver"]).run(ctx)

    return go
