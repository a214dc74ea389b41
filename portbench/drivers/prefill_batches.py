"""Traffic of a replica that takes whole batches of long prompts: each
batch of ``batch`` prompts of ``prompt`` tokens is prefilled
(``make_prefill_step`` -> ``lm.forward``) and then decoded greedily for
``decode_steps`` steps, each step's tokens copied to the host. Batches
follow back to back, closed loop; their prompts come from a pool of
``pool`` batches made in set-up. No migration.

Traffic keys: ``batch``, ``prompt``, ``decode_steps``, ``pool``,
``warmup_batches``, ``traced_batches``, ``check_seqs``, ``check_block``.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.lib import harness as H
from portbench.lib import serve

def run(ctx: H.Ctx) -> dict:
    import torch
    from portbench.gen import tokens

    cfg = serve.config(ctx)
    B, P = int(ctx.traffic("batch")), int(ctx.traffic("prompt"))
    steps = int(ctx.traffic("decode_steps"))
    rep = serve.Replica(ctx, cfg, cache_len=P + steps)
    if P + steps > int(cfg["context"]):
        raise ValueError("prompt + decode steps exceed the context")
    pool = [tokens.prompts(ctx.seed, i, B, P, cfg["vocab_size"])
            for i in range(int(ctx.traffic("pool")))]
    pool_dev = [torch.as_tensor(p, device=ctx.device) for p in pool]
    spans = H.Spans(ctx, tracing=ctx.trace)
    done = []                                  # (pool index, (B, T) served)

    def one_batch(i: int) -> None:
        k = i % len(pool)
        with spans("prefill"):
            rep.prefill(pool_dev[k])
        for _ in range(steps):
            with spans("decode"):
                rep.decode()
        done.append((k, np.stack(rep.served, axis=1)))

    for i in range(int(ctx.traffic("warmup_batches"))):
        one_batch(i)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    done.clear()
    spans.clear()

    record = None
    if ctx.trace:
        from portbench.lib.trace import Record, Tracer
        ref = H.load_module("refs", ctx.workload["config"])
        record = Record(ctx.cell, ctx.workload, ctx.config)
        tracer = Tracer(ctx.device)
        with tracer.window():
            for i in range(int(ctx.traffic("traced_batches"))):
                one_batch(i)
        tracer.read(record, spans)
        n = len(done)
        record.counters["prefill_flops"] = n * ref.prefill_flops(cfg, B, P)
        n_batches, t_win = n, record.window_s
    else:
        n_batches, t_win = H.window(ctx.seconds, one_batch, ctx.sync)
    peak = H.peak_bytes(ctx)
    del rep.params, rep.cache
    H.free_device(ctx)

    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 6]))
    n_req = len(done) * B
    pick = rng.choice(n_req, size=min(n_req, int(ctx.traffic("check_seqs"))),
                      replace=False)
    reqs = [(pool[done[r // B][0]][r % B], done[r // B][1][r % B])
            for r in sorted(pick)]
    t0 = time.perf_counter()
    res = serve.judge(ctx, cfg, reqs, int(ctx.traffic("check_block")))
    limits = ctx.workload["limits"]
    checks = [H.Check("served_logit_gap", res["served_logit_gap"],
                      float(limits["served_logit_gap"]))]
    out = {"setup_s": setup_s, "window_s": t_win, "attempted": n_batches,
           "failed": 0, "peak_bytes": peak, "record": record,
           "metrics": {"tokens_per_s":
                       n_batches * B * (P + steps) / t_win},
           "checks": checks, "check_s": time.perf_counter() - t0,
           "compared": res["tokens"],
           "lower_reading": {"served_logit_gap": res["served_logit_gap"]}}
    if ctx.control:
        out["control_reading"] = {"served_logit_gap": res["control"]}
    return out
