"""Sharding rules: the partition spec of each parameter and optimizer leaf
per (architecture x shape x mesh), and each rank's slice of a tree.

Counterpart of ``repro/launch/sharding.py``'s parameter half. Scheme, as
in the reference: ``data`` carries DP + FSDP (params and optimizer state
ZeRO-sharded over it), ``model`` carries TP (attention heads / FFN
columns), EP (the expert axis) and, with ``seq_shard``, the sequence.
``pod`` is pure DP. Every rule falls back to replication along a dimension
the mesh axis does not divide.

A spec is a tuple with one entry per dimension, ``None`` or a mesh axis
name (the reference's ``PartitionSpec`` is a tuple of the same entries;
``()`` replicates the leaf). The rules read only the mesh's axis names and
sizes, so they take a ``DeviceMesh`` or any object with ``.shape`` as a
name -> size mapping and ``.axis_names`` (the reference tests' fake mesh).
``param_shardings`` cuts a whole tree to this rank's slices on a real
``DeviceMesh``.

The state, batch and cache rules and the ``make_constrain*`` hooks go
with the dry run (ROADMAP item 15).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

FSDP, TP = "data", "model"

# trailing-dims rules keyed by leaf name; names match the model param
# dicts. 3D entries are the (E, d, f) expert tensors. The embedding table
# is d-sharded only, as in the reference. The reference's ``*3i`` rules
# (the expert FFN's inner dim over 'data', behind its EXPERT_INNER_SHARD
# knob, which it keeps off) are left out: that layout is invalid on this
# mesh, because 'data' is also the token axis and the partial-output sum
# would mix tokens (``models/blocks._moe_ffn_sharded`` refuses it).
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": (None, TP),
    "head": (None, TP),
    "wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP),
    "wo": (TP, FSDP),
    "w_gate": (FSDP, TP), "w_up": (FSDP, TP), "w_down": (TP, FSDP),
    "w_gate3": (TP, FSDP, None), "w_up3": (TP, FSDP, None),
    "w_down3": (TP, None, FSDP),
    "router": (None, TP),        # expert-sharded; EP gathers its columns
    "in_proj": (FSDP, None), "out_proj": (None, FSDP),
    "wr": (FSDP, TP), "wg": (FSDP, TP),
    "cm_wk": (FSDP, TP), "cm_wv": (TP, FSDP), "cm_wr": (FSDP, TP),
    "maa_w1": (FSDP, None), "decay_w1": (FSDP, None),
}

Spec = Tuple[Optional[str], ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, from a ``DeviceMesh`` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _path_names(path) -> Tuple[str, ...]:
    """Leaf path -> its key names: strings and ints as they are, and
    objects with a ``.key`` or ``.idx`` (a JAX key path) by that."""
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "idx"):
            out.append(str(k.idx))
        else:
            out.append(str(k))
    return tuple(out)


def _rule_for(names: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
    leaf = names[-1] if names else ""
    # optimizer-state leaves mirror the param tree: the param name is the
    # nearest enclosing named key
    param_name = leaf
    if leaf in ("vr", "vc", "m", "v", "master"):
        for n in reversed(names[:-1]):
            if n in _RULES or n in ("embed", "head"):
                param_name = n
                break
        else:
            param_name = names[-2] if len(names) >= 2 else leaf
    rule = _RULES.get(param_name)
    if rule is None:
        return ()
    # expert tensors: same names, one extra leading dim -> 3D rule
    if param_name in ("w_gate", "w_up", "w_down"):
        if len(shape) >= 3 and shape[-1] != 1 and _looks_expert(names):
            rule = _RULES[param_name + "3"]
    if leaf == "vr":            # adafactor row stats: param shape minus last
        rule = rule[:-1]
    elif leaf == "vc":          # col stats: minus second-to-last
        rule = rule[:-2] + rule[-1:]
    return rule


def _looks_expert(names: Tuple[str, ...]) -> bool:
    return any(n == "moe" for n in names) and "shared" not in names


def _fits(mesh, axes: Optional[str], dim: int) -> bool:
    return axes is not None and dim % mesh_shape(mesh).get(axes, 1) == 0


def param_pspec(mesh, path, leaf) -> Spec:
    """The spec of the leaf at ``path`` (key names, or a JAX key path) with
    ``leaf.shape``: the rule aligned to the trailing dims (leading dims are
    layer-stack axes), each axis kept where it divides its dim."""
    names = _path_names(path)
    shape = tuple(leaf.shape)
    rule = _rule_for(names, shape)
    if not rule:
        return ()
    spec: list = [None] * len(shape)
    for i, ax in enumerate(rule):
        d = len(shape) - len(rule) + i
        if d >= 0 and _fits(mesh, ax, shape[d]):
            spec[d] = ax
    return tuple(spec)


def local_slice(mesh, spec: Spec, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` on a ``DeviceMesh``, as a
    tensor of its own; ``t`` itself where the spec cuts nothing (axes of
    one rank)."""
    from repro_torch.launch.mesh import axis_rank
    sizes, whole = mesh_shape(mesh), t
    for d, ax in enumerate(spec):
        if ax is None or sizes[ax] == 1:
            continue
        step = t.shape[d] // sizes[ax]
        t = t.narrow(d, axis_rank(mesh, ax) * step, step)
    return whole if t is whole else t.clone(
        memory_format=torch.contiguous_format)


def param_shardings(mesh, tree, path: Tuple[str, ...] = ()) -> Any:
    """A nested dict of full tensors -> the same tree of this rank's
    slices (``param_pspec`` of each leaf). ``path`` prefixes the keys, for
    a subtree (a MoE layer's ``("moe",)``)."""
    if isinstance(tree, dict):
        return {k: param_shardings(mesh, v, path + (k,))
                for k, v in tree.items()}
    return local_slice(mesh, param_pspec(mesh, path, tree), tree)
