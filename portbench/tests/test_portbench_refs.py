"""Both plain references against the port at small sizes on the CPU (the
tests may import the program; the references do not)."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.lib import harness as H  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
R = H.load_module("refs", "internlm2-1.8b")
A = H.load_module("refs", "alma-fleet-16k")


@pytest.mark.parametrize("stagger", [1, 8])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_tick_decisions_equal_the_reference(run_small, stagger, seed):
    """Every VM's RemainTime, period and fit window, with all VMs refit
    every tick and with their first fits staggered over 8 steps."""
    out = run_small("tick-16k-refit", seed=seed, stagger=stagger)
    assert out["attempted"] >= 1 and out["compared"] > 0
    assert [(c.name, c.value) for c in out["checks"]] == [
        ("decision_mismatch_share", 0.0)]


def test_cycle_fit_finds_a_square_wave_period():
    n, period = 512, 180
    t = np.arange(n)
    lm = torch.as_tensor(((t % period) < 60).astype(np.int8))[None]
    got, prof = A.fit(lm)
    assert int(got[0]) == period
    assert prof[0, :period].tolist() == lm[0, :period].tolist()
    coarse, _ = A.fit(lm, refine=False)
    assert int(coarse[0]) == round(n / 3)          # the spectral bin: 171


def test_remain_is_algorithm_2():
    period = torch.tensor([4, 4, 4, 0])
    prof = torch.tensor([[0, 1, 0, 0], [0, 1, 0, 0], [0, 0, 0, 0],
                         [1, -1, -1, -1]], dtype=torch.int8)
    m = torch.tensor([1, 2, 3, 7])
    assert A.remain(period, prof, m).tolist() == [0, 3, 4, 0]


def _small_cfg(dtype="float32"):
    cfg = json.loads((ROOT / "portbench/configs/internlm2-1.8b.json")
                     .read_text())
    cfg.update(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
               d_ff=128, vocab_size=256, context=64, param_dtype=dtype)
    return cfg


def test_internlm2_reference_equals_the_port_in_float32():
    """The port's prefill and greedy decode in float32 on the CPU against
    the reference's forward over the same tokens: logits equal to f32
    rounding."""
    from portbench.lib import lm as lmlib
    from repro_torch.train import make_decode_step, make_prefill_step
    cfg = _small_cfg()
    arch = lmlib.arch_config(cfg)
    params = lmlib.make_params(cfg, 7, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], (2, 24)), dtype=torch.int32)
    logits, cache = make_prefill_step(arch, cache_len=32)(params,
                                                          {"tokens": toks})
    got, seq = [logits], toks
    decode = make_decode_step(arch)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for _ in range(5):
        seq = torch.cat([seq, tok], dim=1)
        tok, logits, cache = decode(params, tok, cache)
        got.append(logits)
    got = torch.stack(got, dim=1)
    want = R.logits(params, cfg, seq, torch.arange(23, 29))
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale


def test_fp8_rounds_to_eight_bits():
    x = torch.linspace(-3, 3, 101)
    q = R.fp8(x)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0 < float(rel.max()) <= 2 ** -4 + 1e-6
