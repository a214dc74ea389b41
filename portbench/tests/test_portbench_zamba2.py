"""``zamba2-7b``'s reference module and the ``ssm_scan_roofline`` reader.

The reference's operation counts (``prefill_mfu`` reads them) against
numbers worked by hand at a tiny configuration and, at the published
widths, against the port's own weight shapes; its chunked SSD against the
step recurrence; and the reader of B4's roofline on the call records of
one prefill (``lib/calls.py``)."""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from portbench.counts import kernels as K  # noqa: E402
from portbench.lib import harness as H  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
R = H.load_module("refs", "zamba2-7b")
READ = H.load_module("layer_metrics", "ssm_scan_roofline").read
PUBLISHED = json.loads((ROOT / "portbench/configs/zamba2-7b.json")
                       .read_text())

#: d 4, 2 heads of 4 over the 8-wide concat, d_ff 8, LoRA rank 2, vocab
#: 10; three Mamba2 layers (d_in 8, 2 heads of 4, state 2, 2 groups),
#: calls before layers 0 and 2
TINY = {"hidden_size": 4, "num_hidden_layers": 3, "num_attention_heads": 2,
        "num_key_value_heads": 2, "attention_head_dim": 4,
        "ffn_hidden_size": 8, "adapter_rank": 2, "vocab_size": 10,
        "hybrid_layer_ids": [0, 2], "mamba_expand": 2, "mamba_headdim": 4,
        "mamba_d_state": 2, "mamba_ngroups": 2}


def test_weights_by_hand():
    """A Mamba2 layer: in_proj 4 x (2 x 8 + 2 x 2 x 2 + 2) = 104, out_proj
    8 x 4 = 32: 136. A call: q, k, v 3 x 8 x 8 = 192, o 8 x 4 = 32, the
    MLP 3 x 4 x 8 = 96, the LoRA 2 x (4 + 16) = 40, the linear 16: 376.
    The SSD: 5 x 2 heads x 2 x 4 = 80 a layer and token."""
    assert R._mamba_weights(TINY) == 136
    assert R._call_weights(TINY) == 376
    assert R._ssd_flops(TINY) == 80


def test_decode_and_prefill_by_hand():
    """A token outside attention and head: 2 (3 x 136 + 2 x 376) + 3 x 80
    = 2,560. Decode of 2 sequences at 3 positions: each adds 2 calls x 4
    hd 4 x 2 heads x 3 = 192 and the head 2 x 4 x 10 = 80: 2 x 2,832 =
    5,664. A prefill of 3: 3 x 2,560 + 2 calls x 32 x 6 pairs + 80 =
    8,144."""
    assert R.decode_flops(TINY, 2, 3) == 5664.0
    assert R.prefill_flops(TINY, 1, 3) == 8144.0


def test_published_counts_take_the_port_s_weights_at_each_use():
    """At the published widths the reference counts, a token, the
    products of every Mamba2 layer and of each shared block at each of its
    calls with the call's LoRA and linear: the port's weight matrices
    (``lm.init_params`` on the meta device, norms and vectors left out)
    with each block taken once a call. A prefill of 16 x 4,080 is then
    ~1.49e15 operations."""
    from portbench.lib import lm as lmlib
    from repro_torch.models import lm
    meta = lm.init_params(lmlib.arch_config(PUBLISHED), device="meta")

    def numel(tree, *names):
        return sum(tree[k].numel() for k in names)

    mamba = numel(meta["mamba"]["mixer"], "in_proj", "out_proj")
    sh = meta["shared"]
    block = (numel(sh["attn"], "wq", "wk", "wv", "wo")
             + numel(sh["mlp"], "w_gate", "w_up", "w_down")
             ) // PUBLISHED["num_mem_blocks"]
    calls = numel(meta["calls"], "linear", "lora_a", "lora_b")
    n = len(PUBLISHED["hybrid_layer_ids"])
    assert 81 * R._mamba_weights(PUBLISHED) == mamba
    assert n * R._call_weights(PUBLISHED) == n * block + calls
    assert R.prefill_flops(PUBLISHED, 16, 4080) == pytest.approx(1.49e15,
                                                                 rel=1e-2)


def _steps(x, dt, log_a, Bm, Cm):
    """The SSD one step at a time: S_t = exp(log_a_t) S_{t-1} + dt_t B_t
    x_t^T, y_t = C_t S_t."""
    b, S, Hh, P = x.shape
    N = Bm.shape[-1]
    state = torch.zeros(b, Hh, N, P, dtype=torch.float64)
    ys = []
    for t in range(S):
        state = (torch.exp(log_a[:, t])[..., None, None] * state
                 + torch.einsum("bhn,bhp->bhnp", Bm[:, t],
                                dt[:, t, :, None] * x[:, t]))
        ys.append(torch.einsum("bhn,bhnp->bhp", Cm[:, t], state))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("S", [1, 63, 64, 150])
def test_chunked_ssd_equals_the_step_recurrence(S):
    """The reference's chunked dual form (chunks of ``CHUNK``, a ragged
    last one padded) against the recurrence in float64: f32 rounding
    only (1e-5 of the output's peak)."""
    g = torch.Generator().manual_seed(S)
    b, Hh, N, P = 2, 4, 8, 6
    x = torch.randn(b, S, Hh, P, generator=g)
    dt = torch.rand(b, S, Hh, generator=g) * 0.1
    log_a = -torch.rand(b, S, Hh, generator=g) * 1.5
    Bm, Cm = (torch.randn(b, S, Hh, N, generator=g) for _ in range(2))
    got = R._ssd(x, dt, log_a, Bm, Cm)
    want = _steps(*(t.double() for t in (x, dt, log_a, Bm, Cm)))
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_ssm_scan_roofline_reads_one_prefill_s_records():
    """One zamba2-7b prefill at ``SMALL`` on the CPU under
    ``lib/calls.py``: two B4 calls a layer, each over its group's heads
    with that group's C and B counted once (B S N distinct elements, not
    H/G times that). The reader takes their least time
    (``counts/kernels.ssm_scan``) over ``ssm_scan_kernel``'s device time:
    100% at a device time equal to that least time, less above it, and
    nothing without a record or a device time."""
    from portbench.lib import calls, lm as lmlib
    from portbench.lib.trace import Record
    from repro_torch.train import make_prefill_step
    cfg = {**PUBLISHED, **R.SMALL, "param_dtype": "float32"}
    arch = lmlib.arch_config(cfg)
    params = lmlib.make_params(cfg, 11, "cpu")
    B, S = 2, 24
    toks = torch.randint(0, cfg["vocab_size"], (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(11))
    with calls.recorded() as got:
        make_prefill_step(arch, cache_len=S)(params, {"tokens": toks})
    s = cfg["ssm"]
    G, N, P = s["n_groups"], s["state_dim"], s["head_dim"]
    Hg = s["expand"] * cfg["d_model"] // P // G
    recs = got["ssm_scan"]
    assert len(recs) == cfg["num_layers"] * G
    for r in recs:
        assert r[:5] == (B, Hg, S, N, P)
        assert [n for n, _ in r[5]] == [B * S * N, B * S * N,
                                        B * Hg * S * P, B * Hg * S]
    least = sum(K.seconds(*K.ssm_scan(*r[:6])) for r in recs)
    rec = Record("zamba2-7b-prefill", {}, cfg)
    assert READ(rec) is None
    rec.counters["ssm_scan"] = recs
    assert READ(rec) is None                     # no device time
    rec.device_ops = [("void (anonymous namespace)::ssm_scan_kernel<true, "
                       "2, true>(Args, CUtensorMap)", least),
                      ("void (anonymous namespace)::wg::attn_wg<224, true>"
                       "(Args)", 1.0)]
    assert READ(rec) == pytest.approx(100.0)
    rec.device_ops[0] = (rec.device_ops[0][0], 4 * least)
    assert READ(rec) == pytest.approx(25.0)
