"""Incremental (dirty-block) checkpoints: the pre-copy engine applied to
fault tolerance (``repro``'s ``checkpoint/incremental.py``, in its on-disk
format).

Between full checkpoints, only the state blocks that changed since the
last (full or delta) snapshot are written: the paper's dirty-page
tracking, reused. Restore replays the base full checkpoint, then the deltas
in order.

Unlike the reference, which scans leaf by leaf against a host copy, a save
runs one ``ops.dirty_blocks_many`` over all leaves (kernel B3 on the card,
one launch for every float leaf; integer leaves compare exactly) against a
shadow kept on the state's device, so only the dirty blocks cross to the
host. The shadow costs one more copy of the state in device memory (26.5
GB for a full-width internlm2-1.8b with AdamW), and each save refreshes it
with a device-to-device copy of the whole state, so it equals the state as
saved bit for bit, as the reference's host copy does.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

import torch

from repro_torch import tree
from repro_torch.checkpoint.store import (CODEC, compress_bytes,
                                          decompress_bytes, dtype_name,
                                          flatten_with_paths, from_bytes,
                                          read_leaves, save_checkpoint,
                                          to_numpy, unflatten_like)
from repro_torch.kernels import ops
from repro_torch.kernels.backend import DeviceLike, resolve_device


def _dirty_rows(leaf: torch.Tensor, idx: torch.Tensor,
                block: int) -> torch.Tensor:
    """The blocks ``idx`` of the flat ``leaf`` as (len(idx), block) rows,
    the ragged last block zero-padded, gathered on the leaf's device."""
    flat = leaf.reshape(-1)
    full = flat.numel() // block
    rows = flat[: full * block].view(full, block).index_select(
        0, idx[idx < full])
    if flat.numel() > full * block and bool((idx == full).any()):
        last = torch.zeros((1, block), dtype=flat.dtype, device=flat.device)
        last[0, : flat.numel() - full * block] = flat[full * block:]
        rows = torch.cat([rows, last])
    return rows


class IncrementalCheckpointer:
    def __init__(self, directory: str, block_elems: int = 1 << 14,
                 full_every: int = 10):
        self.directory = pathlib.Path(directory)
        self.block = block_elems
        self.full_every = full_every
        self._shadow = None            # device copy of the last snapshot
        self._since_full = 0

    def save(self, step: int, state) -> Dict[str, Any]:
        """Full or delta save; returns stats {kind, bytes}."""
        if self._shadow is None or self._since_full >= self.full_every:
            save_checkpoint(str(self.directory), step, state)
            self._refresh_shadow(state)
            self._since_full = 0
            n = sum(t.numel() * t.element_size() for t in tree.leaves(state))
            return {"kind": "full", "bytes": n}

        d = self.directory / f"delta_{step:08d}"
        d.mkdir(parents=True, exist_ok=True)
        flat_new = flatten_with_paths(state)
        flat_old = flatten_with_paths(self._shadow)
        keys = list(flat_new)
        news = [flat_new[k] for k in keys]
        olds = [flat_old[k].to(n.dtype) for k, n in zip(keys, news)]
        masks, counts = ops.dirty_blocks_many(news, olds, block=self.block)
        manifest, total = {}, 0
        for i, (key, new, mask, count) in enumerate(zip(keys, news, masks,
                                                        counts)):
            if count == 0:
                continue
            idx = mask.nonzero().squeeze(1)
            blocks = to_numpy(_dirty_rows(new, idx, self.block))
            fname = f"delta_{i:05d}.bin.zst"
            with open(d / fname, "wb") as f:
                f.write(compress_bytes(blocks.tobytes()))
            manifest[key] = {"file": fname, "blocks": idx.tolist(),
                             "dtype": dtype_name(new)}
            total += blocks.nbytes
        (d / "manifest.json").write_text(json.dumps(
            {"step": step, "block": self.block, "codec": CODEC,
             "leaves": manifest}))
        self._refresh_shadow(state)
        self._since_full += 1
        return {"kind": "delta", "bytes": total}

    def _refresh_shadow(self, state) -> None:
        """The shadow := ``state``, in place once it exists."""
        if self._shadow is None:
            self._shadow = tree.map(
                lambda t: t.clone(memory_format=torch.contiguous_format),
                state)
            return
        for o, n in zip(tree.leaves(self._shadow), tree.leaves(state)):
            o.copy_(n)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int, like, *, device: DeviceLike = None) -> Any:
        """Restore the state at ``step`` into the structure of ``like``: the
        base full checkpoint, then the deltas after it in order, on
        ``device`` (``None`` is the card)."""
        dev = resolve_device(device)
        fulls = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*") if p.is_dir())
        base = max(s for s in fulls if s <= step)
        flat = read_leaves(str(self.directory), base)
        deltas = sorted(int(p.name.split("_")[1])
                        for p in self.directory.glob("delta_*") if p.is_dir())
        for s in deltas:
            if not (base < s <= step):
                continue
            d = self.directory / f"delta_{s:08d}"
            man = json.loads((d / "manifest.json").read_text())
            blk = man["block"]
            for key, meta in man["leaves"].items():
                raw = decompress_bytes((d / meta["file"]).read_bytes(),
                                       man.get("codec", "zstd"))
                blocks = from_bytes(raw, meta["dtype"],
                                    (len(meta["blocks"]), blk))
                leaf = flat[key]
                n = leaf.numel()
                nb = -(-n // blk)
                padded = torch.zeros(nb * blk, dtype=leaf.dtype)
                padded[:n] = leaf.reshape(-1)
                padded.view(nb, blk)[torch.tensor(meta["blocks"])] = \
                    blocks.to(leaf.dtype)
                flat[key] = padded[:n].reshape(leaf.shape)
        keys = flatten_with_paths(like)
        return unflatten_like(like, {k: flat[k].to(dev) for k in keys})
