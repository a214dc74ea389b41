"""Traffic of a serving replica that is live-migrated while it decodes.

A batch of ``batch`` requests with ``prompt``-token prompts is prefilled
in set-up and then decoded greedily, each step's tokens copied to the host
as a streaming server sends them. Meanwhile pre-copy migrations of the
whole state (weights, KV rings, and any SSM and conv states) run back to
back (``core/precopy.migrate``, one decode step a round), and each
continues the replica on its destination. A batch that would pass
``max_len`` positions (its KV rings' length) within a migration is
replaced by a freshly prefilled one first, as a server turns its requests
over.

Traffic keys: ``batch``, ``prompt``, ``max_len``, ``block_elems``,
``max_rounds``,
``stop_dirty_blocks``, ``stop_total_factor``, ``warmup_migrations``,
``traced_migrations``, ``check_seqs`` (requests the reference judges),
``check_block`` (requests a reference pass takes).
"""
from __future__ import annotations

import time

import numpy as np

from portbench.lib import harness as H
from portbench.lib import serve

def run(ctx: H.Ctx) -> dict:
    import torch
    from repro_torch import tree
    from repro_torch.core import precopy
    from portbench.gen import tokens

    cfg = serve.config(ctx)
    B, P = int(ctx.traffic("batch")), int(ctx.traffic("prompt"))
    ctx_len = int(ctx.traffic("max_len"))
    if ctx_len > int(cfg["context"]):
        raise ValueError("max_len exceeds the configuration's context")
    pcfg = precopy.PrecopyConfig(
        block_elems=int(ctx.traffic("block_elems")),
        max_rounds=int(ctx.traffic("max_rounds")),
        stop_dirty_blocks=int(ctx.traffic("stop_dirty_blocks")),
        stop_total_factor=float(ctx.traffic("stop_total_factor")),
        steps_per_round=1)
    rep = serve.Replica(ctx, cfg, cache_len=ctx_len)
    spans = H.Spans(ctx, tracing=ctx.trace)
    box = {"batch": 0, "mig": [], "last": None, "decode_in_mig": 0.0,
           "prefilled": 0, "batches": []}

    def new_batch():
        ids = tokens.prompts(ctx.seed, box["batch"], B, P, cfg["vocab_size"])
        with spans("prefill"):
            rep.prefill(torch.as_tensor(ids, device=ctx.device))
        box["batches"].append((ids, rep.served, rep.arrivals))
        box["batch"] += 1
        box["prefilled"] += B * P

    def step():
        t = time.perf_counter()
        with spans("decode"):
            rep.decode()
        box["decode_in_mig"] += time.perf_counter() - t

    def migration(_i=0):
        if rep.pos + pcfg.max_rounds + 1 > ctx_len:
            new_batch()
        box["last"] = None                 # the previous source, released
        box["decode_in_mig"] = 0.0
        t = time.perf_counter()
        with spans("migration"):
            dest, report = precopy.migrate(rep.state, step, pcfg)
        wall = time.perf_counter() - t
        source = rep.state()               # the live state it stopped at
        box["mig"].append((wall, box["decode_in_mig"], report))
        rep.params, rep.cache = dest["params"], dest["cache"]
        box["last"] = (source, dest)

    new_batch()
    for _ in range(int(ctx.traffic("warmup_migrations"))):
        migration()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    box["mig"], box["prefilled"] = [], 0
    spans.clear()
    t_first = time.perf_counter()
    steps0 = sum(len(b[1]) for b in box["batches"])

    record = None
    if ctx.trace:
        from portbench.lib.trace import Record, Tracer
        record = Record(ctx.cell, ctx.workload, ctx.config)
        tracer = Tracer(ctx.device)
        with tracer.window():
            for _ in range(int(ctx.traffic("traced_migrations"))):
                migration()
        tracer.read(record, spans)
        record.counters.update({
            "migrations": [(w, d, r.outcome.rounds, r.outcome.bytes_sent,
                            r.v_mem) for w, d, r in box["mig"]],
            "decode_flops": _decode_flops(ctx, cfg, B, rep, spans)})
        n_mig, t_win = len(box["mig"]), record.window_s
    else:
        n_mig, t_win = H.window(ctx.seconds, migration, ctx.sync)
    peak = H.peak_bytes(ctx)

    # tokens and gaps of the window
    gaps = np.concatenate([np.diff([t for t in b[2] if t >= t_first])
                           for b in box["batches"]])
    generated = sum(len(b[1]) for b in box["batches"]) - steps0
    metrics = {
        "migration_s": sum(w for w, _, _ in box["mig"]) / max(n_mig, 1),
        "step_gap_p95_ms": (1e3 * float(np.percentile(gaps, 95))
                            if len(gaps) else float("nan")),
        "tokens_per_s": (B * generated + box["prefilled"]) / t_win}

    # the last migration: its destination against its source, bit for bit
    source, dest = box["last"]
    differ = 0
    for a, b in zip(tree.leaves(source), tree.leaves(dest)):
        differ += int((a.reshape(-1).view(torch.uint8)
                       != b.reshape(-1).view(torch.uint8)).sum())
    limits = ctx.workload["limits"]
    checks = [H.Check("dest_bytes_differ", differ,
                      float(limits["dest_bytes_differ"]))]
    del source, dest, box["last"], rep.params, rep.cache
    H.free_device(ctx)

    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 5]))
    ids, served, _ = max(box["batches"], key=lambda b: len(b[1]))
    served = np.stack(served, axis=1)                    # (B, T)
    rows = rng.choice(B, size=min(B, int(ctx.traffic("check_seqs"))),
                      replace=False)
    t0 = time.perf_counter()
    res = serve.judge(ctx, cfg, [(ids[r], served[r]) for r in sorted(rows)],
                      int(ctx.traffic("check_block")))
    checks.append(H.Check("served_logit_gap", res["served_logit_gap"],
                          float(limits["served_logit_gap"])))
    out = {"setup_s": setup_s, "window_s": t_win, "attempted": n_mig,
           "failed": 0, "peak_bytes": peak, "record": record,
           "metrics": metrics, "checks": checks,
           "check_s": time.perf_counter() - t0, "compared": res["tokens"],
           "lower_reading": {"served_logit_gap": res["served_logit_gap"],
                             "dest_bytes_differ": differ}}
    if ctx.control:
        out["control_reading"] = {"served_logit_gap": res["control"]}
    return out


def _decode_flops(ctx: H.Ctx, cfg: dict, B: int, rep, spans) -> float:
    """The decode steps' least operations in the traced window (each step
    attends to the positions before it and its own), as the
    configuration's reference counts them."""
    ref = H.load_module("refs", ctx.workload["config"])
    n = len(spans.times.get("decode", []))
    end = rep.pos
    return sum(ref.decode_flops(cfg, B, end - k) for k in range(n))
