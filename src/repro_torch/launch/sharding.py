"""Sharding rules: the partition spec of each parameter, optimizer, batch
and cache leaf per (architecture x shape x mesh), each rank's slice of a
tree, and the residual-stream and logits hooks.

Counterpart of ``repro/launch/sharding.py``. Scheme, as
in the reference: ``data`` carries DP + FSDP (params and optimizer state
ZeRO-sharded over it), ``model`` carries TP (attention heads / FFN
columns), EP (the expert axis) and, with ``seq_shard``, the sequence.
``pod`` is pure DP. Every rule falls back to replication along a dimension
the mesh axis does not divide.

A spec is a tuple with one entry per dimension, ``None``, a mesh axis
name or a tuple of names (the batch axes ``("pod", "data")``), as the
reference's
``PartitionSpec`` is a tuple of the same entries; ``()`` replicates the
leaf. The rules read only the mesh's axis names and sizes, so they take a
``DeviceMesh`` or any object with ``.shape`` as a name -> size mapping and
``.axis_names`` (the reference tests' fake mesh).

Each rule has two forms: ``*_specs`` (and ``param_pspec``,
``batch_pspec``, ``cache_pspec``, ``constrain_spec``,
``constrain_logits_spec``) give the spec tuples, held to the reference's
leaf for leaf; ``param_shardings``, ``state_shardings``,
``batch_shardings`` and ``cache_shardings`` cut a tree of full tensors to
this rank's slices on a real ``DeviceMesh``, and ``gather_tree``
(``gather_leaf``) is their inverse, every rank's slices all-gathered back
to the full leaves. The hooks ``make_constrain`` and
``make_constrain_logits`` act on a rank's tensor, which arrives cut along
the batch axes (``batch_shardings``): they cut the other axes of their
spec that divide (the reference's ``_guarded_wsc``), as
``models/dist.split`` (its gradient all-gathered).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

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


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec cuts along."""
    return tuple(a for e in spec for a in _entry_axes(e))


def replicas(mesh, spec: Spec) -> int:
    """How many ranks of the mesh hold the same slice of a leaf under
    ``spec``: the product of the axes it is not cut along."""
    cut = set(spec_axes(spec))
    return math.prod(n for a, n in mesh_shape(mesh).items() if a not in cut)


def _batch_axes(mesh):
    """The batch axes as one spec entry: a name, or a tuple of names (as
    ``PartitionSpec`` normalises a one-name tuple to the name)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return axes[0] if len(axes) == 1 else axes


def _size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = mesh_shape(mesh)
    return math.prod(sizes.get(a, 1) for a in axes)


def local_slice(mesh, spec: Spec, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` on a ``DeviceMesh`` (a
    tuple entry cuts by the row-major index over its axes), as a tensor of
    its own; ``t`` itself where the spec cuts nothing (axes of one
    rank)."""
    from repro_torch.launch.mesh import axis_rank
    sizes, whole = mesh_shape(mesh), t
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = _size(mesh, axes)
        if n == 1:
            continue
        index = 0
        for a in axes:
            index = index * sizes.get(a, 1) + axis_rank(mesh, a)
        step = t.shape[d] // n
        t = t.narrow(d, index * step, step)
    return whole if t is whole else t.clone(
        memory_format=torch.contiguous_format)


def walk(fn: Callable, tree, path: Tuple[str, ...] = (), *rest):
    """``fn(path, leaf, *matching leaves of rest)`` over a nested tree of
    dicts, lists and tuples (``None`` an empty subtree), structure kept;
    list and tuple positions are path entries as strings."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: walk(fn, v, path + (k,), *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk(fn, v, path + (str(i),),
                                *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def param_specs(mesh, tree, path: Tuple[str, ...] = ()) -> Any:
    """The spec tree of a parameter tree (full shapes: tensors, meta
    tensors or anything with ``.shape``)."""
    return walk(lambda p, leaf: param_pspec(mesh, p, leaf), tree, path)


def param_shardings(mesh, tree, path: Tuple[str, ...] = ()) -> Any:
    """A nested dict of full tensors -> the same tree of this rank's
    slices (``param_pspec`` of each leaf). ``path`` prefixes the keys, for
    a subtree (a MoE layer's ``("moe",)``)."""
    return walk(lambda p, leaf: local_slice(mesh, param_pspec(mesh, p, leaf),
                                             leaf), tree, path)


def leaf_specs(mesh, tree) -> list:
    """The specs of a tree's leaves in ``tree.leaves`` order (dict keys
    sorted), for code that walks leaf lists."""
    out: list = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append(param_pspec(mesh, path, node))

    walk(tree, ())
    return out


# the optimizer state mirrors the params (``vr``/``vc`` by ``_rule_for``);
# ``step`` and ``count`` match no rule and are replicated
state_specs = param_specs
state_shardings = param_shardings


# ---------------------------------------------------------------------------
# batch / cache
# ---------------------------------------------------------------------------
def batch_pspec(mesh, path, leaf) -> Spec:
    """A batch leaf's spec: ``positions`` (3, B, S) over the batch axes at
    dim 1, every other (B, ...) leaf at dim 0, each only where the batch
    axes divide it."""
    bd = _batch_axes(mesh)
    nb = _size(mesh, _entry_axes(bd))
    names, shape = _path_names(path), tuple(leaf.shape)
    if names and names[-1] == "positions":
        return (None, bd, None) if shape[1] % nb == 0 else ()
    return (bd, *([None] * (len(shape) - 1))) if shape[0] % nb == 0 else ()


def batch_specs(mesh, tree) -> Any:
    return walk(lambda p, leaf: batch_pspec(mesh, p, leaf), tree)


def batch_shardings(mesh, tree) -> Any:
    """This rank's block of a batch of full tensors."""
    return walk(lambda p, leaf: local_slice(mesh, batch_pspec(mesh, p, leaf),
                                             leaf), tree)


def kv_split(mesh, num_kv_heads: int, window: int) -> Optional[str]:
    """Which dim of a KV ring the ``model`` axis cuts: ``"heads"`` where
    it divides the KV heads, else ``"window"`` where it divides the ring's
    window W (long-context, small-batch decode), else None (the ring
    replicated over ``model``)."""
    tp = mesh_shape(mesh).get(TP, 1)
    if num_kv_heads % tp == 0:
        return "heads"
    if window % tp == 0:
        return "window"
    return None


def cache_pspec(mesh, path, leaf) -> Spec:
    """A decode-cache leaf's spec. KV rings (L, B, W, Hkv, hd): B over the
    batch axes where they divide it (and B > 1), then ``kv_split``; other
    states (L, B, H, ...): their heads over ``model`` where it divides
    them; ``pos`` replicated."""
    bd = _batch_axes(mesh)
    nb, tp = _size(mesh, _entry_axes(bd)), mesh_shape(mesh).get(TP, 1)
    names, shape = _path_names(path), tuple(leaf.shape)
    if names and names[-1] == "pos":
        return ()
    s: list = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % nb == 0 and shape[1] > 1:
        s[1] = bd
    if names and names[-1] in ("k", "v") and len(shape) == 5:
        where = kv_split(mesh, shape[3], shape[2])
        if where is not None:
            s[3 if where == "heads" else 2] = TP
    elif len(shape) >= 3:
        if shape[2] % tp == 0 and shape[2] >= tp:
            s[2] = TP
    return tuple(s)


def cache_specs(mesh, cfg, tree) -> Any:
    """The spec tree of a decode cache of full shapes (``cfg`` as the
    reference's signature takes it; the rule reads the shapes)."""
    return walk(lambda p, leaf: cache_pspec(mesh, p, leaf), tree)


def cache_shardings(mesh, cfg, tree) -> Any:
    """This rank's slices of a decode cache of full tensors."""
    return walk(lambda p, leaf: local_slice(mesh, cache_pspec(mesh, p, leaf),
                                             leaf), tree)


# ---------------------------------------------------------------------------
# residual-stream and logits hooks
# ---------------------------------------------------------------------------
def _guarded(mesh, shape, wanted) -> Spec:
    """The reference's ``_guarded_wsc`` spec: each wanted entry kept where
    its axes divide the dim (and the dim is at least their size)."""
    spec = []
    for d, ax in enumerate(wanted):
        n = _size(mesh, _entry_axes(ax))
        spec.append(ax if ax is not None and shape[d] % n == 0
                    and shape[d] >= n else None)
    return tuple(spec)


def constrain_spec(mesh, cfg, shape) -> Spec:
    """The residual stream (B, S, d): batch over the batch axes, the
    sequence over ``model`` with ``cfg.seq_shard``."""
    return _guarded(mesh, shape, (_batch_axes(mesh),
                                  TP if cfg.seq_shard else None, None))


def constrain_logits_spec(mesh, shape) -> Spec:
    """Logits (B, S, V): batch over the batch axes, vocabulary over
    ``model``."""
    return _guarded(mesh, shape, (_batch_axes(mesh), None, TP))


def _cutter(mesh, spec_of: Callable) -> Callable:
    from repro_torch.models import dist

    def cut(x: torch.Tensor) -> torch.Tensor:
        for d, ax in enumerate(spec_of(x.shape)):
            if d > 0 and ax is not None:
                x = dist.split(x, mesh, ax, d)
        return x

    return cut


def make_constrain(mesh, cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    """The residual-stream hook on a rank's (B_loc, S, d) tensor: with
    ``cfg.seq_shard`` its block of the sequence (where ``model`` divides
    S), else the identity."""
    return _cutter(mesh, lambda shape: constrain_spec(mesh, cfg, shape))


def make_constrain_logits(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The logits hook on a rank's whole-vocabulary (B_loc, S, V) logits:
    its block of the vocabulary (where ``model`` divides V)."""
    return _cutter(mesh, lambda shape: constrain_logits_spec(mesh, shape))


# ---------------------------------------------------------------------------
# the inverse: a rank's slices gathered back to the full leaves
# ---------------------------------------------------------------------------
def _gather_dim(t: torch.Tensor, grp, d: int) -> torch.Tensor:
    import torch.distributed as tdist
    xt = t.movedim(d, 0).contiguous()
    out = xt.new_empty((tdist.get_world_size(grp) * xt.shape[0],
                        *xt.shape[1:]))
    tdist.all_gather_into_tensor(out, xt, group=grp)
    return out.movedim(0, d)


def gather_leaf(mesh, spec: Spec, t: torch.Tensor) -> torch.Tensor:
    """Every rank's slice of a leaf cut by ``spec`` (``local_slice``),
    all-gathered back into the full leaf (contiguous; ``t`` itself where
    the spec cuts nothing). Every rank of the mesh must call it."""
    sizes, whole = mesh_shape(mesh), t
    for d, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):     # inner axis first
            if sizes.get(a, 1) > 1:
                t = _gather_dim(t, mesh.get_group(a), d)
    return whole if t is whole else t.contiguous()


def gather_tree(mesh, specs, tree) -> Any:
    """``gather_leaf`` over a tree of slices and its spec tree."""
    return walk(lambda p, leaf, spec: gather_leaf(mesh, spec, leaf), tree,
                 (), specs)
