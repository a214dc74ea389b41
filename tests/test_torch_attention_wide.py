"""B5 (``ops.flash_attention``) past D = 128 and with the caller's softmax
scale: zamba2-7b's shared attention, 32 heads of 224 scaled by
(224 / 2)^-0.5. The bf16 kernel takes 128 < D <= 224 on kv tiles of 64
keys (D padded to 224); f32 stays at D <= 128.

On the CPU the op's plain path (``ref.attention_chunked``) against the
naive oracle (``ref.attention_ref``) at the given scale, within 2e-5 in
f32 and 2e-2 in bf16 (``tests/test_kernels.py``'s tolerances); the default
scale is D^-0.5 to the bit. The kernel itself runs only on the card: the
tests marked ``card`` skip without one, and run there by

    python -m pytest -q -m card tests/test_torch_attention_wide.py

(this file imports no JAX). They hold B5 in bf16 at (2, 32, 32, 1,024,
224) and (1, 32, 32, 4,080, 224), the cell's prefill length, to the oracle
within ``2u (|o| + sum_k p_k |v_k|)`` (u = 2^-8, the bound
``chip_smoke._attn_check`` holds every bf16 B5 shape to), a second launch
to the bits of the first, element-wise loads to the bits of TMA's, and
other widths past 128 (padded to 224). ``scripts/torch_b5_wide.py`` holds
the D <= 128 outputs to another checkout's bits."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SCALE = (224 / 2) ** -0.5
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BF16_U = 2.0 ** -8


def _qkv(seed, B, H, Hkv, S, D, dtype, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device=device, dtype=dtype)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S, chunk", [(96, 512), (256, 64)])
def test_cpu_op_takes_the_scale(dtype, S, chunk):
    q, k, v = _qkv(11, 1, 4, 2, S, 224, dtype)
    got = ops.flash_attention(q, k, v, chunk=chunk, scale=SCALE)
    want = ref.attention_ref(q, k, v, scale=SCALE)
    tol = TOL[dtype]
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    plain = ref.attention_ref(q, k, v)            # D^-0.5: another result
    assert float((plain.float() - want.float()).abs().max()) > 10 * tol


def test_default_scale_is_unchanged():
    q, k, v = _qkv(12, 2, 4, 4, 128, 128, torch.float32)
    assert torch.equal(ops.flash_attention(q, k, v),
                       ops.flash_attention(q, k, v, scale=None))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 128 ** -0.5
    mask = torch.ones(128, 128, dtype=torch.bool).tril()
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    assert torch.equal(ref.attention_ref(q, k, v),
                       torch.einsum("bhqk,bhkd->bhqd", p, v))


def test_the_wrapper_takes_up_to_224_in_bf16_and_refuses_the_cpu():
    assert fa.MAX_D == {torch.float32: 128, torch.bfloat16: 224}
    q, k, v = _qkv(13, 1, 2, 2, 8, 224, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, scale=SCALE)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("B5 is a CUDA kernel: these run on an NVIDIA card only")
    from repro_torch.kernels import build
    build.build_all(["flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _hold(got, q, k, v, scale):
    """Each batch element within the bf16 bound (module docstring);
    returns the largest share of the bound used."""
    use = 0.0
    for b in range(q.shape[0]):
        one = slice(b, b + 1)
        want = ref.attention_ref(q[one], k[one], v[one], scale=scale).float()
        mass = ref.attention_ref(q[one].float(), k[one].float(),
                                 v[one].float().abs(), scale=scale)
        bound = 2 * BF16_U * (want.abs() + mass)
        err = (got[one].float() - want).abs()
        use = max(use, float((err / bound.clamp_min(1e-30)).max()))
    return use


@pytest.mark.card
@pytest.mark.parametrize("B, S", [(2, 1024), (1, 4080)])
def test_card_b5_at_zamba2_heads(card, B, S):
    q, k, v = _qkv(21, B, 32, 32, S, 224, torch.bfloat16, card)
    got = ops.flash_attention(q, k, v, scale=SCALE)
    assert _hold(got, q, k, v, SCALE) <= 1.0
    again = ops.flash_attention(q, k, v, scale=SCALE)
    assert torch.equal(got, again)


@pytest.mark.card
def test_card_b5_refuses_wide_f32(card):
    q, k, v = _qkv(22, 1, 4, 2, 70, 224, torch.float32, card)
    with pytest.raises(ValueError, match="224"):
        ops.flash_attention(q, k, v, scale=SCALE)


@pytest.mark.card
@pytest.mark.parametrize("D", [136, 200])
def test_card_b5_other_wide_heads(card, D):
    q, k, v = _qkv(23, 1, 4, 1, 333, D, torch.bfloat16, card)
    got = ops.flash_attention(q, k, v)
    assert _hold(got, q, k, v, None) <= 1.0


@pytest.mark.card
def test_card_b5_wide_strided_equals_contiguous(card):
    """A d stride of S (element-wise loads) gives the bits of the
    contiguous input (TMA) at D = 224."""
    q, k, v = _qkv(24, 1, 4, 4, 300, 224, torch.bfloat16, card)
    qs = q.transpose(2, 3).contiguous().transpose(2, 3)
    assert qs.stride(3) != 1
    assert torch.equal(ops.flash_attention(qs, k, v, scale=SCALE),
                       ops.flash_attention(q, k, v, scale=SCALE))

