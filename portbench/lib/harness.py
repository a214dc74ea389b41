"""What every cell shares: finding a cell's files by name, the run's
context, host-clock spans, the window loop, the checks and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its traffic is
``workloads/<cell>.json`` (which names the driver and the configuration),
its configuration ``configs/<config>.json``, its reference
``refs/<config>.py``, its driver ``drivers/<driver>.py`` and each per-layer
metric ``layer_metrics/<metric>.py``: a new cell, configuration, traffic
mix or metric is new files and entries, never an edit here.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

BENCH = pathlib.Path(__file__).resolve().parents[1]     # portbench/
ROOT = BENCH.parent                                      # the checkout
#: module names that must not be loaded in a run (top-level names, whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold ``-`` and
    ``.``, so they are loaded by path)."""
    path = BENCH / kind / f"{name}.py"
    mod_name = f"portbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(cell: str) -> tuple:
    """(workload dict, config dict) of a cell."""
    wl = load_json(BENCH / "workloads" / f"{cell}.json")
    cfg = load_json(BENCH / "configs" / f"{wl['config']}.json")
    return wl, cfg


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is forbidden,
    compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Ctx:
    """One run of one cell. ``sizes`` overrides traffic or configuration
    numbers (tests run cells small on the CPU); ``control`` also reads the
    control."""
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    sizes: Dict[str, Any] = field(default_factory=dict)
    control: bool = False
    t_start: float = field(default_factory=time.perf_counter)

    def traffic(self, key: str):
        return self.sizes.get(key, self.workload["traffic"][key])

    def conf(self, key: str):
        return self.sizes.get(key, self.config[key])

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()


class Spans:
    """Host-clock spans around calls into the program. In a traced run
    each span ends with a device synchronise, so that it holds the device
    work it launched, and its interval is kept to name the device's idle
    gaps."""

    def __init__(self, ctx: Ctx, tracing: bool = False):
        self.ctx, self.tracing = ctx, tracing
        self.times: Dict[str, List[float]] = {}
        #: (name, start, end) on the host clock, kept in a traced run
        self.intervals: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            if self.tracing:
                self.ctx.sync()
            end = time.perf_counter()
            self.times.setdefault(name, []).append(end - t)
            if self.tracing:
                self.intervals.append((name, t, end))

    def clear(self) -> None:
        self.times.clear()
        self.intervals.clear()


def settle() -> None:
    """Before a window: collect the set-up's garbage and move every object
    alive to the collector's permanent generation (``gc.freeze``), as a
    server does once it has started. The window's own objects are
    collected as ever; the set-up's long-lived ones (16,384 registered
    VMs, the weights) are no longer traversed by each full collection,
    whose cost moved with the heap's layout from run to run.
    ``free_device`` unfreezes them."""
    import gc
    gc.collect()
    gc.freeze()


def window(seconds: float, body: Callable[[int], None],
           sync: Callable[[], None]) -> tuple:
    """Call ``body(i)`` for i = 0, 1, ... until ``seconds`` have passed,
    the last call finished whole. Returns (calls, window seconds): the
    window runs from a synced device to the end of the last call."""
    settle()
    sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        body(n)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return n, time.perf_counter() - t0


@dataclass
class Check:
    """A number compared against its limit: correct when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def peak_bytes(ctx: Ctx) -> int:
    if ctx.device != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated())


def free_device(ctx: Ctx) -> None:
    import gc
    gc.unfreeze()
    gc.collect()
    if ctx.device == "cuda":
        import torch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def seed_int(seed: int) -> int:
    """The seed as a torch generator takes it (0 <= s < 2**63)."""
    return int(seed) % (1 << 63)
