"""The yardstick's counts against numbers worked by hand at small shapes."""
import json
import pathlib

import pytest

from portbench.counts import kernels as K
from portbench.counts import lm as C

ROOT = pathlib.Path(__file__).resolve().parents[2]

TINY = {"d_model": 4, "num_heads": 2, "num_kv_heads": 2, "d_ff": 8,
        "vocab_size": 10, "num_layers": 6,
        "block_pattern": ["mamba"] * 5 + ["shared_attn"],
        "ssm": {"state_dim": 2, "head_dim": 2, "expand": 2}}


@pytest.mark.parametrize("got, want", [
    (K.spectrum(2, 8), (182.0, 104.0)),
    (K.autocorr(1, 8, [0, 2, 9]), (28.0, 56.0)),
    (K.dirty_scan([(10, 2), (4, 4)], 4), (42.0, 88.0)),
    (K.attention(1, 2, 1, 4, 8, in_bytes=2), (640.0, 384.0)),
])
def test_kernel_counts(got, want):
    assert got == pytest.approx(want)


def test_causal_pairs():
    assert K.causal_pairs(4) == 10
    assert K.causal_pairs(5, 2) == 9
    assert K.causal_pairs(5, 9) == 15


def test_wiener_khinchin_is_taken_where_fewer():
    flops, _ = K.autocorr(1, 1024, list(range(1, 1000)))
    m = 1024 + 999
    assert flops == pytest.approx(2 * 2.5 * m * 11 + 3 * (m // 2 + 1),
                                  rel=0.02)


def test_seconds_is_the_larger_bound():
    assert K.seconds(K.PEAK_FLOPS, 0) == pytest.approx(1.0)
    assert K.seconds(0, K.PEAK_BYTES) == pytest.approx(1.0)
    assert K.seconds(K.PEAK_FLOPS, 2 * K.PEAK_BYTES) == pytest.approx(2.0)


def test_lm_counts_by_hand():
    assert C.decode_flops(TINY, 2, 3) == 4256.0
    assert C.prefill_flops(TINY, 1, 3) == 6176.0


DENSE = {"d_model": 4, "num_heads": 2, "num_kv_heads": 1, "d_ff": 8,
         "vocab_size": 10, "num_layers": 2, "block_pattern": ["attn"]}


def test_dense_counts_by_hand():
    """Per layer: q and o 2 x 4 x 4, k and v 2 x 4 x 2, the MLP 3 x 4 x 8,
    so 144 weights; the head 40. A decode token: 2 (2 x 144 + 40) + 2
    layers x 4 hd 2 x kv_len 3 x 2 heads = 752. A prefill of 3: 3 x 2 x
    288 + 2 x 4 x 2 x 6 pairs x 2 + 2 x 40 = 2000."""
    assert C.decode_flops(DENSE, 1, 3) == 752.0
    assert C.prefill_flops(DENSE, 1, 3) == 2000.0


BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LM_CONFIGS = [c["name"] for c in BENCH["configs"]
              if "block_pattern" in json.loads((ROOT / c["file"]).read_text())]


def _ref(name: str):
    pytest.importorskip("torch")
    from portbench.lib import harness as H
    return H.load_module("refs", name)


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_decode_weights_match_the_program_parameter_count(name):
    """2 operations a weight a token, as the configuration's reference
    counts them: the products' weights are the model's parameters less the
    embedding table and the norms' scales. A tied head's product with the
    embedding table is still a weight product: there the table counts
    once, as the head's weights."""
    from portbench.lib import lm as lmlib
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{name}.json").read_text())
    arch = lmlib.arch_config(cfg)
    weights = _ref(name).decode_flops(cfg, 1, 0) / 2
    table = 0 if arch.tie_embeddings else cfg["vocab_size"] * cfg["d_model"]
    program = arch.param_count() - table
    assert weights == pytest.approx(program, rel=2e-3)


def _internlm2_cells():
    """(batch, prompt, largest KV length) of each internlm2 cell, from its
    traffic file, with the cell's name as its id."""
    out = []
    for w in BENCH["workloads"]:
        if w["config"] != "internlm2-1.8b":
            continue
        t = json.loads((ROOT / "portbench" / "workloads"
                        / f"{w['name']}.json").read_text())["traffic"]
        end = t.get("max_len", t["prompt"] + t.get("decode_steps", 0))
        out.append(pytest.param(t["batch"], t["prompt"], end, id=w["name"]))
    return out


@pytest.mark.parametrize("B, P, end", _internlm2_cells())
def test_internlm2_reference_counts_as_counts_lm(B, P, end):
    """At the cells' own shapes the reference's counts are ``counts.lm``'s,
    so ``prefill_mfu``, ``decode_mfu`` and ``migration_mfu`` read what
    they read before each model stated its own."""
    ref = _ref("internlm2-1.8b")
    cfg = json.loads((ROOT / "portbench/configs/internlm2-1.8b.json")
                     .read_text())
    assert ref.prefill_flops(cfg, B, P) == C.prefill_flops(cfg, B, P)
    for kv in range(P, end + 1):
        assert ref.decode_flops(cfg, B, kv) == C.decode_flops(cfg, B, kv)


def test_internlm2_reference_counts_by_hand():
    ref = _ref("internlm2-1.8b")
    assert ref.decode_flops(TINY, 2, 3) == 4256.0
    assert ref.prefill_flops(TINY, 1, 3) == 6176.0
    assert ref.decode_flops(DENSE, 1, 3) == 752.0
    assert ref.prefill_flops(DENSE, 1, 3) == 2000.0


def test_ssm_scan_counts_by_hand():
    """B4 on (B, H, S, Dk, Dv) = (1, 2, 3, 2, 2), q and k f32 shared by the
    heads (stride 0 over H: 6 distinct elements each), v bf16 (12), the
    decay f32 shared by the key channels (stride 0 over Dk: 6). Flops 5 x
    1 x 2 x 3 x 2 x 2 = 120; bytes: inputs 24 + 24 + 24 + 24, y in bf16
    24, the state in f32 32, so 152."""
    torch = pytest.importorskip("torch")
    from portbench.lib import calls
    qk = torch.ones(1, 3, 2)[:, None].expand(1, 2, 3, 2)
    v = torch.ones(1, 2, 3, 2, dtype=torch.bfloat16)
    w = torch.ones(1, 2, 3)[..., None].expand(1, 2, 3, 2)
    record = calls.ENTRIES["ssm_scan"][1](qk, qk, v, w)
    assert record == (1, 2, 3, 2, 2, ((6, 4), (6, 4), (12, 2), (6, 4)),
                      False, False)
    assert K.ssm_scan(*record[:6]) == (120.0, 152.0)
