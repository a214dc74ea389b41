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


@pytest.mark.parametrize("name", ["internlm2-1.8b"])
def test_decode_weights_match_the_program_parameter_count(name):
    """2 operations a weight a token: the products' weights are the model's
    parameters less the embedding table and the norms' scales."""
    pytest.importorskip("torch")
    from portbench.lib import lm as lmlib
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{name}.json").read_text())
    arch = lmlib.arch_config(cfg)
    weights = C.decode_flops(cfg, 1, 0) / 2
    program = arch.param_count() - cfg["vocab_size"] * cfg["d_model"]
    assert weights == pytest.approx(program, rel=2e-3)
