"""Checkpoint store: save and restore a whole tree of tensors
(``repro``'s ``checkpoint/store.py``, in its on-disk format).

Format: one directory ``step_%08d`` per step holding one compressed blob
per leaf (``leaf_%05d.bin.zst``, zstd where ``zstandard`` is installed,
else stdlib zlib) and a ``manifest.json`` with the codec and, per leaf
key path (``params/blocks/attn/wq``: ``jax.tree``'s keys joined by ``/``,
dict keys sorted), its file, shape and dtype name. Each package reads the
other's checkpoints. bfloat16 leaves are written and read as their uint16
bits under the dtype name ``bfloat16``, so this module needs no numpy
type for bf16.

``restore_checkpoint`` rebuilds the structure of ``like`` (a tree of
tensors, e.g. from ``device="meta"``) on ``device`` (``None`` is the
card). ``AsyncCheckpointer`` copies the state to host memory synchronously
(so in-place optimizer updates after the call cannot reach the snapshot)
and writes it to disk on a thread: the training loop never waits on disk.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels.backend import DeviceLike, resolve_device

try:
    import zstandard
    CODEC = "zstd"
except ImportError:          # clean containers fall back to stdlib zlib;
    zstandard = None         # the manifest records which codec wrote the
    CODEC = "zlib"           # blobs so a mismatch fails loud at restore

#: torch dtype -> numpy dtype of its bytes on disk, and the dtype name the
#: manifest records
_DTYPES = {torch.float32: (np.float32, "float32"),
           torch.float64: (np.float64, "float64"),
           torch.float16: (np.float16, "float16"),
           torch.bfloat16: (np.uint16, "bfloat16"),
           torch.int64: (np.int64, "int64"),
           torch.int32: (np.int32, "int32"),
           torch.int16: (np.int16, "int16"),
           torch.int8: (np.int8, "int8"),
           torch.uint8: (np.uint8, "uint8"),
           torch.bool: (np.bool_, "bool")}
_BY_NAME = {name: (t, np_t) for t, (np_t, name) in _DTYPES.items()}


def compress_bytes(data: bytes) -> bytes:
    if CODEC == "zstd":
        return zstandard.ZstdCompressor(level=3).compress(data)
    return zlib.compress(data, 3)


def decompress_bytes(data: bytes, codec: str = "zstd") -> bytes:
    if codec == "zlib":          # stdlib: readable everywhere
        return zlib.decompress(data)
    if zstandard is None:
        raise RuntimeError(
            "checkpoint was written with zstd but zstandard is not "
            "installed in this environment")
    return zstandard.ZstdDecompressor().decompress(data)


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """key path -> leaf, in ``jax.tree_util.tree_flatten_with_path``'s order
    and key format (dict keys sorted, list and tuple items by index)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_with_paths(v, f"{prefix}{i}/"))
        return out
    if tree is None:
        return {}
    return {prefix[:-1]: tree}


def unflatten_like(like: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """The structure of ``like`` with each leaf taken from ``flat`` by its
    key path."""
    if isinstance(like, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten_like(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    if like is None:
        return None
    return flat[prefix[:-1]]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as the numpy array of its on-disk bytes (bf16 as
    uint16 bits)."""
    np_t, _ = _DTYPES[t.dtype]
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().view(np_t)


def dtype_name(t: torch.Tensor) -> str:
    return _DTYPES[t.dtype][1]


def from_bytes(raw: bytes, name: str, shape) -> torch.Tensor:
    """A CPU tensor of dtype ``name`` (a manifest's dtype name) and
    ``shape`` from its raw bytes."""
    t_dtype, np_t = _BY_NAME[name]
    arr = np.frombuffer(raw, dtype=np_t).reshape(shape).copy()
    if t_dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, state) -> pathlib.Path:
    """Write ``state`` (tensors on any device, or host copies from
    ``to_numpy``) as ``directory/step_%08d``, replacing it atomically."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for i, (key, leaf) in enumerate(flatten_with_paths(state).items()):
        if isinstance(leaf, torch.Tensor):
            leaf = _HostLeaf(to_numpy(leaf), dtype_name(leaf))
        fname = f"leaf_{i:05d}.bin.zst"
        with open(tmp / fname, "wb") as f:
            f.write(compress_bytes(leaf.arr.tobytes()))
        manifest[key] = {"file": fname, "shape": list(leaf.arr.shape),
                         "dtype": leaf.dtype}
    (tmp / "manifest.json").write_text(json.dumps(
        {"step": step, "codec": CODEC, "leaves": manifest}))
    if d.exists():  # atomic replace
        shutil.rmtree(d)
    tmp.rename(d)
    return d


class _HostLeaf:
    """A leaf's host bytes and its manifest dtype name."""

    def __init__(self, arr: np.ndarray, dtype: str):
        self.arr, self.dtype = arr, dtype


def host_copy(state) -> Any:
    """``state`` with host leaves (``_HostLeaf``), copied from the device
    now: what ``save_checkpoint`` writes later is the state of this
    moment."""
    return tree.map(lambda t: _HostLeaf(to_numpy(t), dtype_name(t)), state)


def latest_step(directory: str) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if p.is_dir()]
    return max(steps) if steps else None


def read_leaves(directory: str, step: int) -> Dict[str, torch.Tensor]:
    """key path -> CPU tensor of every leaf of ``directory/step_%08d``."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    top = json.loads((d / "manifest.json").read_text())
    codec = top.get("codec", "zstd")
    return {key: from_bytes(decompress_bytes((d / meta["file"]).read_bytes(),
                                             codec),
                            meta["dtype"], meta["shape"])
            for key, meta in top["leaves"].items()}


def restore_checkpoint(directory: str, step: int, like, *,
                       device: DeviceLike = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, on any
    device, ``meta`` too), each leaf in its manifest's dtype and shape, on
    ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    flat = read_leaves(directory, step)
    keys = flatten_with_paths(like)
    return unflatten_like(like, {k: flat[k].to(dev) for k in keys})


class AsyncCheckpointer:
    """Snapshot to host synchronously, write to disk asynchronously."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, state) -> None:
        self.wait()
        host = host_copy(state)                    # device -> host copy

        def _write():
            try:
                save_checkpoint(str(self.directory), step, host)
                self.last_saved = step
                self._gc()
            except Exception as e:                 # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*") if p.is_dir())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
