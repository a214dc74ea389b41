"""Roofline terms of one traced step of a rank: flops, HBM bytes,
collective bytes by kind, and memory.

Counterpart of ``repro/launch/hlo_analysis.py``. The reference reads the
partitioned per-device HLO of a compiled step. The port has no compiler and
no HLO: it runs rank 0's program eagerly, so ``TraceAnalysis`` is a
``TorchDispatchMode`` that sees every op the step dispatches. Under
``FakeTensorMode`` and a fake process group (``launch/dryrun.py``) it traces
a rank of a 256- or 512-rank mesh without memory or data; on real tensors
it counts a real step the same way (the tests hold the two equal on gloo
ranks). It accumulates, for rank 0 (the program of one rank is the
per-device program):

  flops       -- the formulas of ``torch.utils.flop_counter`` (the
                 matmul family, attention), which count 2*M*N*K per
                 product, plus the formulas of the custom ops B4 and B5
                 (``kernels/ops.py``); elementwise ops count none, as the
                 reference's ``dot``-only count
  hbm_bytes   -- operands plus results of each dispatched op, views and
                 allocations left out: the eager counterpart of the
                 reference's top-level instructions (an eager op reads its
                 operands from memory and writes its result there; a hand
                 kernel counts at its call site, as a fusion does)
  hbm_write_bytes -- results only
  collectives -- link bytes by kind with the reference's ring conventions
                 (all-gather ~ its result, all-reduce ~ 2x its result,
                 reduce-scatter ~ its operand, all-to-all and permute ~
                 their result); also each kind's calls and raw input bytes,
                 which a real run's wrappers of ``torch.distributed`` read
  memory      -- the step's arguments, outputs, the outputs that are
                 argument storages (written in place: AdamW's moments and
                 master, a decode cache's rings and states), and the peak of
                 the bytes allocated during the step and still live (every
                 storage an op created, freed when its last reference goes)

``analyze(fn, *args)`` runs ``fn(*args)`` under the mode and returns (its
output, the record) with the keys of the reference's ``analyze``.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# op name -> (kind, where its output is, where its input is): an argument
# position, or "result"
_COLLECTIVES = {
    "c10d::_allgather_base_": ("all-gather", 0, 1),
    "c10d::allgather_": ("all-gather", 0, 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
    "c10d::allreduce_": ("all-reduce", 0, 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0, 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 0, 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
    "c10d::alltoall_base_": ("all-to-all", 0, 1),
    "c10d::alltoall_": ("all-to-all", 0, 1),
    "c10d::send": ("collective-permute", 0, 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "result", 0),
    "_c10d_functional::all_reduce": ("all-reduce", "result", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "result",
                                                0),
    "_c10d_functional::all_to_all_single": ("all-to-all", "result", 0),
}

_aten = torch.ops.aten
# allocations without a write: they make a storage, move no bytes
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.new_empty.default, _aten.new_empty_strided.default,
                _aten.empty_like.default}
# aliases the schema does not mark as views, and queries of a tensor's
# metadata (which a fake tensor answers through dispatch)
_ALIASES = {_aten._unsafe_view.default, torch.ops.prim.device.default,
            torch.ops.prim.layout.default, _aten.sym_size.default,
            _aten.sym_stride.default, _aten.sym_numel.default,
            _aten.sym_storage_offset.default, _aten.is_contiguous.default,
            _aten.is_contiguous.memory_format,
            _aten.is_strides_like_format.default,
            _aten.is_non_overlapping_and_dense.default, _aten.size.default,
            _aten.stride.default, _aten.storage_offset.default,
            _aten.numel.default, _aten.dim.default}


def _tensors(tree) -> Iterator[torch.Tensor]:
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def nbytes(tree) -> int:
    """Bytes of the tensors of a tree (each leaf's elements)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class TraceAnalysis(TorchDispatchMode):
    """Counts one step's roofline terms as it runs (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.hbm_bytes = 0
        self.hbm_write_bytes = 0
        self.ops = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self._args: Dict[int, Any] = {}     # storage id -> the storage
        self._live: Dict[int, int] = {}     # storage id -> bytes
        self._live_bytes = 0
        self.peak_bytes = 0

    # -- memory ---------------------------------------------------------------
    def track_arguments(self, tree) -> None:
        """The step's inputs: their storages are not the step's own."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            self._args[id(st)] = st

    def _freed(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        weakref.finalize(st, self._freed, key)

    # -- the mode -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _ALIASES:
            return out
        outs = list(_tensors(out))
        for t in outs:
            self._allocated(t)
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        if func in _ALLOCATIONS:
            return out
        self.ops += 1
        written = nbytes(outs)
        self.hbm_bytes += nbytes((args, kwargs)) + written
        self.hbm_write_bytes += written
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops += n
            name = str(func._overloadpacket)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        coll = _COLLECTIVES.get(func.name())
        if coll is not None:
            self._collective(coll, args, out)
        return out

    def _collective(self, coll, args, out) -> None:
        kind, where_out, where_in = coll
        result = nbytes(out if where_out == "result" else args[where_out])
        raw = nbytes(args[where_in])
        link = {"all-reduce": 2 * result, "reduce-scatter": raw}.get(kind,
                                                                     result)
        rec = self.collectives.setdefault(
            kind, {"bytes": 0, "calls": 0, "input_bytes": 0})
        rec["bytes"] += link
        rec["calls"] += 1
        rec["input_bytes"] += raw

    # -- the record -----------------------------------------------------------
    def totals(self) -> Dict[str, float]:
        """The reference's ``analyze`` keys: flops, hbm_bytes,
        hbm_write_bytes, ``coll_<kind>`` and coll_total."""
        t: Dict[str, float] = {"flops": float(self.flops),
                               "hbm_bytes": float(self.hbm_bytes),
                               "hbm_write_bytes": float(self.hbm_write_bytes)}
        for kind, rec in self.collectives.items():
            t["coll_" + kind] = float(rec["bytes"])
        t["coll_total"] = float(sum(r["bytes"] for r in
                                    self.collectives.values()))
        return t

    def memory(self, args, out) -> Dict[str, int]:
        """The reference's ``memory_analysis`` fields for this step:
        arguments, outputs, outputs held in argument storages (aliases),
        and the peak of the step's own live bytes (temp)."""
        alias = sum(t.numel() * t.element_size() for t in _tensors(out)
                    if id(t.untyped_storage()) in self._args)
        return {"argument_size_in_bytes": nbytes(args),
                "output_size_in_bytes": nbytes(out),
                "alias_size_in_bytes": alias,
                "temp_size_in_bytes": self.peak_bytes}


def analyze(fn, *args) -> Tuple[Any, TraceAnalysis]:
    """``fn(*args)`` under a ``TraceAnalysis`` whose arguments are
    ``args``; returns (the output, the analysis)."""
    a = TraceAnalysis()
    a.track_arguments(args)
    with a:
        out = fn(*args)
    return out, a
