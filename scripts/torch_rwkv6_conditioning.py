"""How far rwkv6's first-step gradient moves under a perturbation far
below its precision (ROADMAP C-11), on the port's local path.

Seeded rwkv6 params (``lm.init_params``) at full width, ``--layers`` deep,
in ``--dtype``; one batch of ``--batch`` x ``--seq`` tokens, either
``SyntheticCorpus``'s batch 0 or uniform random tokens (``--tokens``).
Prints the loss and grad norm, then the same after a perturbation of the
weights: in f32 each weight times (1 + ``--noise`` N(0, 1)); in bf16 one
ulp-sized step (x (1 +- 8e-3)) in 1% of the weights. A smooth loss moves
its grad norm about as much as its weights; a chaotic one by far more.

  python scripts/torch_rwkv6_conditioning.py --layers 24 --seq 256
  python scripts/torch_rwkv6_conditioning.py --layers 2 --tokens uniform
  python scripts/torch_rwkv6_conditioning.py --smoke --layers 2 --batch 4 \
      --seq 48 --tokens uniform

Runs on the CPU by default (``--device cuda`` on the card).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config's widths (d 128, 4 heads), as "
                         "the CPU tests run it")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--tokens", choices=("corpus", "uniform"),
                    default="corpus")
    ap.add_argument("--noise", type=float, default=1e-7)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import lm
    from repro_torch.train import make_grad_fn

    cfg = get_config("rwkv6_1p6b")
    if a.smoke:
        cfg = cfg.smoke()
    cfg = cfg.replace(num_layers=a.layers, param_dtype=a.dtype)
    params = lm.init_params(cfg, a.seed, device=a.device)
    batch = {k: torch.from_numpy(v.copy()).to(a.device) for k, v in
             SyntheticCorpus(cfg, a.batch, a.seq, seed=a.seed)
             .batch_at(0).items()}
    if a.tokens == "uniform":
        rng = np.random.default_rng(a.seed)
        batch["tokens"] = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, tuple(batch["tokens"].shape),
            dtype=np.int32)).to(a.device)
    grad_fn = make_grad_fn(cfg)

    def measure(p):
        loss, _, g = grad_fn(p, batch)
        norm = sum(float(x.float().norm()) ** 2 for x in tree.leaves(g))
        return float(loss), norm ** 0.5, tree.leaves(g)

    gen = torch.Generator(device=a.device).manual_seed(a.seed + 1)

    def perturbed(t):
        if a.dtype == "float32":
            return t * (1 + a.noise * torch.randn(
                t.shape, generator=gen, device=t.device))
        hit = torch.rand(t.shape, generator=gen, device=t.device) < 0.01
        sign = torch.randn(t.shape, generator=gen, device=t.device).sign()
        return (t.float() * (1 + 8e-3 * hit * sign)).to(t.dtype)

    base = measure(params)
    moved = measure(tree.map(perturbed, params))
    leaf = max(float((m.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for m, b in zip(moved[2], base[2]))
    what = (f"{a.noise:g} relative noise" if a.dtype == "float32"
            else "one bf16 ulp in 1% of the weights")
    print(f"rwkv6{' smoke' if a.smoke else ''} {a.layers} layers, "
          f"{a.dtype}, {a.batch} x {a.seq} "
          f"{a.tokens} tokens: loss {base[0]:.8f} grad norm {base[1]:.6f}; "
          f"after {what}: loss {moved[0]:.8f} grad norm {moved[1]:.6f} "
          f"(ratio {moved[1] / base[1]:.6f}), the gradient's largest move "
          f"{leaf:.6g} of its leaf's peak")
    return 0


if __name__ == "__main__":
    sys.exit(main())
