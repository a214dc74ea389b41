"""The card smoke's kernel bounds are the benchmark's count: at B4's
zamba2-7b group launch (stride-0 B and C shared by the group's 56 heads,
the per-head decay broadcast over Dk), at B5's internlm2 prefill and for a
pre-copy scan of a state, ``chip_smoke`` reports
``1e3 * counts.kernels.seconds(...)`` of the counts the ledger's
``*_roofline`` metrics read. Shapes only: the inputs are meta tensors."""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from portbench.counts import kernels  # noqa: E402


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _b4_zamba2_7b_group():
    """One group's launch of zamba2-7b's prefill pass, laid out as the
    model and ``chip_smoke._scan_case`` lay it out ("mamba")."""
    B, H, S, Dk, Dv = 8, 56, 4080, 64, 64
    q = _meta(B, S, Dk)[:, None].expand(B, H, S, Dk)
    k = _meta(B, S, Dk)[:, None].expand(B, H, S, Dk)
    v = _meta(B, S, H, Dv).permute(0, 2, 1, 3)
    lw = _meta(B, S, H, dtype=torch.float32).permute(0, 2, 1)[..., None] \
        .expand(B, H, S, Dk)
    got = chip_smoke._bound(chip_smoke._scan_work((q, k, v, lw), None,
                                                  None))
    # q, k: B S Dk each; v: every element; the decay: B S H in f32
    want = kernels.ssm_scan(B, H, S, Dk, Dv, [
        (B * S * Dk, 2), (B * S * Dk, 2), (B * H * S * Dv, 2),
        (B * S * H, 4)])
    return got, want


def _b5_internlm2_prefill():
    B, H, Hkv, S, D = 16, 16, 8, 4096, 128
    q = _meta(B, S, H, D).transpose(1, 2)
    k = _meta(B, S, Hkv, D).transpose(1, 2)
    got = chip_smoke._bound(chip_smoke._attn_work(q, k, 0))
    return got, kernels.attention(B, H, Hkv, S, D, in_bytes=2)


def _b3_state():
    """A state of bf16, f32 and integer leaves, one ragged against the
    block. The bound is also the bytes-only one the ``SCAN_LIMIT`` gates
    held before, bit for bit: both copies of every leaf read, a float a
    block written."""
    block = 1 << 12
    leaves = [_meta(24 * 16, 4096, 8 * 120), _meta(3840, 10240),
              _meta(1_000_003, dtype=torch.float32),
              _meta(7, dtype=torch.int32)]
    got = (chip_smoke._scan_bound(leaves, block), None)
    v_mem = sum(t.numel() * t.element_size() for t in leaves)
    blocks = sum(-(-t.numel() // block) for t in leaves)
    assert got[0] == 1e3 * kernels.seconds(0.0, 2.0 * v_mem + 4.0 * blocks)
    return got, kernels.dirty_scan(
        [(t.numel(), t.element_size()) for t in leaves], block)


@pytest.mark.parametrize("case", [_b4_zamba2_7b_group, _b5_internlm2_prefill,
                                  _b3_state],
                         ids=["B4 zamba2-7b group", "B5 internlm2 prefill",
                              "B3 state"])
def test_smoke_bound_is_the_benchmark_count(case):
    (ms, by), (flops, nbytes) = case()
    assert ms == 1e3 * kernels.seconds(flops, nbytes)
    if by is not None:               # the scan's bound is bytes by its name
        assert by == ("operations" if flops / kernels.PEAK_FLOPS
                      >= nbytes / kernels.PEAK_BYTES else "bytes")
