"""Serving-replica live migration on the PyTorch port (the counterpart of
``examples/serve_migration.py``): batched decode keeps producing tokens
while its (params + KV cache) state pre-copies to a new placement; only the
stop-and-copy delta pauses decoding.

Decode-only phases dirty almost nothing (just the KV append), so they are
deep LM windows: the migration finishes in one cheap round compared to a
training replica of equal size. On the card the prefill runs kernel B5 and
each dirty scan kernel B3.

Run:  PYTHONPATH=src python examples/torch_serve_migration.py [--device cpu]
(the default device is the card).
"""
import argparse

import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import precopy
from repro_torch.data import make_batch
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import lm
from repro_torch.train import make_decode_step, make_prefill_step

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)

cfg = get_config("h2o_danube3_4b").smoke()
params = lm.init_params(cfg, 0, device=dev)
B, P, N = 4, 64, 24

batch = make_batch(cfg, B, P, device=dev)
batch.pop("targets")
prefill = make_prefill_step(cfg, cache_len=P + N)
decode = make_decode_step(cfg)
logits, cache = prefill(params, batch)
tok = logits.argmax(-1)[:, None].to(torch.int32)

# serving replica state = params + cache; decode steps mutate ONLY the cache
# (its rings in place)
box = {"cache": cache, "tok": tok, "produced": 0}


def decode_once():
    box["tok"], _, box["cache"] = decode(params, box["tok"], box["cache"])
    box["produced"] += 1


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


serve_state = lambda: {"params": params, "cache": box["cache"]}  # noqa: E731
pcfg = precopy.PrecopyConfig(block_elems=1 << 12, max_rounds=8,
                             stop_dirty_blocks=2)
dest, report = precopy.migrate(serve_state, decode_once, pcfg)

param_bytes = precopy.total_bytes(params)
print(f"replica state: {report.v_mem/1e6:.1f} MB "
      f"(params {param_bytes/1e6:.1f} MB)")
print(f"tokens produced during migration: {box['produced']}")
print(f"rounds: {report.outcome.rounds} "
      f"(per-round dirty MB: "
      f"{[round(b/1e6, 2) for b in report.per_round_dirty_bytes[1:]]})")
print(f"bytes sent / state size: "
      f"{report.outcome.bytes_sent / report.v_mem:.3f}x "
      f"(decode dirties only the KV ring -> near-1x, a deep LM window)")

exact = all(same_bits(a, b) for a, b in
            zip(tree.leaves(dest), tree.leaves(serve_state())))
assert exact, "migrated replica must be exact"
# decode continues on the destination
tok2, _, _ = decode(dest["params"], box["tok"], dest["cache"])
assert tok2.shape == box["tok"].shape
print("serving migration OK (replica exact, decode resumed)")
