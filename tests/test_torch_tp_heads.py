"""The attention on a model axis that does not divide its heads
(``blocks.head_split`` "replicated"): four ``gloo`` ranks on the CPU
(``torch_dist_worker.py``, suite "tp_heads").

Cases (``W.TP_HEADS_CASES``): the f32 smoke configs of qwen2-vl (M-RoPE
positions, a frontend prefix), starcoder2 (GELU MLP) and musicgen (MHA, a
frontend prefix) with 6 query heads on (1, 4) (``wq``'s 192 columns cut at
48, 1.5 heads, a rank; ``wk``/``wv`` at 16 columns, half a head, or 48 for
musicgen) and with 3 query heads and 1 KV head (musicgen 3) on (2, 2) (96
columns, 1.5 heads, a rank); starcoder2's 3 heads also with ``seq_shard``
on (2, 2), and, as a control cut by heads, internlm2's 4 on (1, 4);
weights from the JAX package's ``init_params`` carried across. Each rank cuts the train state, batch and
cache with ``launch/sharding`` and every rank computes every head on the
gathered weights. Held, gathered back (``gather_tree``): one train step's
loss, grad norm, every gradient leaf and every param and optimizer leaf
after the step; for a cache of 20 (the ring cut along its window over
``model``) and of 21 (cut neither way: whole on every rank, also for the
head-cut control), a prefill's
last logits and cache, three greedy decode steps' logits and tokens and
the cache after them.

Against (a) the port's local path (rank 0 runs it on the same inputs) and
(b) the JAX package's GSPMD steps on the same mesh of ``AxisType.Auto``
axes (ROADMAP C-10), in a subprocess with 4 forced host devices.
Tolerance: ``test_torch_tp.py``'s, each array within 1e-5 of its largest
magnitude, loss and grad norm within 1e-5 relative; greedy tokens equal.

Mutants (``W.TP_HEADS_MUTANTS``, qwen2-vl on (1, 4)): the weights
gathered by an all-gather whose backward sums every rank's (whole)
gradient, and a region left through ``tp_exit``'s all-reduce; each must
fail the gradient check against the local path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_dist_worker as W  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

TOL = 1e-5
RINGS = [tag for tag, _ in W.TP_HEADS_RINGS]
PARTS = {"train": ("grads", "state"),
         **{f"{t}prefill": (f"{t}prefill_logits", f"{t}prefill_cache")
            for t in RINGS},
         **{f"{t}decode": tuple(f"{t}decode{i}_logits"
                                for i in range(W.TP_HEADS_DECODE))
            + (f"{t}decode_cache",) for t in RINGS}}
SCALARS = {"train": ("step_loss", "grad_norm")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs written; the JAX subprocess and the four ranks run at once.
    Returns (the rank files, the JAX package's results)."""
    return W.run_tp_suite("tp_heads", tmp_path_factory.mktemp("tp_heads"),
                          W.tp_inputs("tp_heads", jax, jax_lm, jax_config))


def _errors(got_file, got_pre, want_file, want_pre, part):
    """(key, error, largest magnitude) of every array of ``part``, and the
    scalars' relative errors."""
    out = []
    for name in SCALARS.get(part, ()):
        got = float(got_file[f"{got_pre}/{name}"])
        want = float(want_file[f"{want_pre}/{name}"])
        out.append((name, abs(got - want), abs(want)))
    keys = [k[len(got_pre) + 1:] for k in got_file.files
            if k.startswith(got_pre + "/")
            and k[len(got_pre) + 1:].split("/")[0] in PARTS.get(part,
                                                                (part,))]
    for k in keys:
        got = got_file[f"{got_pre}/{k}"].astype(np.float64)
        want = want_file[f"{want_pre}/{k}"].astype(np.float64)
        assert got.shape == want.shape, (k, got.shape, want.shape)
        assert np.isfinite(got).all(), k
        peak = float(np.abs(want).max()) if want.size else 0.0
        err = float(np.abs(got - want).max()) if want.size else 0.0
        out.append((k, err, peak))
    return out


def _held(*args):
    errs = _errors(*args)
    for k, err, peak in errs:
        assert err <= TOL * peak, (k, err, peak)
    return len(errs)


def _case_mesh(case):
    return W.TP_HEADS_CASES[case][0]


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("case", list(W.TP_HEADS_CASES))
def test_replicated_heads_match_local_path(run, case, part):
    ranks, _ = run
    f = ranks[0]
    mesh = _case_mesh(case)
    n = _held(f, f"{mesh}/{case}", f, f"local/{case}", part)
    assert n >= (4 if part.endswith("decode") else 2)
    if part == "train":      # every param, gradient and optimizer leaf
        from repro_torch import tree
        from repro_torch.models import lm
        cfg = W.tp_config(case, get_config)
        n_params = len(tree.leaves(lm.init_params(cfg, device="meta")))
        assert sum(k.startswith(f"{mesh}/{case}/grads/")
                   for k in f.files) == n_params


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("case", list(W.TP_HEADS_CASES))
def test_replicated_heads_match_jax_package(run, case, part):
    """The JAX package's GSPMD steps on the same mesh."""
    ranks, jx = run
    mesh = _case_mesh(case)
    assert _held(ranks[0], f"{mesh}/{case}", jx, f"{mesh}/{case}",
                 part) >= (4 if part.endswith("decode") else 2)


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("case", list(W.TP_HEADS_CASES))
def test_greedy_tokens_match(run, case, ring):
    """The greedy tokens of the mesh, the local path and the JAX package
    agree, and every rank gathered the same logits."""
    ranks, jx = run
    pre = f"{_case_mesh(case)}/{case}/{ring}"
    got = ranks[0][pre + "tokens"]
    assert got.shape == (W.TP_BATCH, W.TP_HEADS_DECODE + 1)
    assert np.array_equal(got, ranks[0][f"local/{case}/{ring}tokens"])
    assert np.array_equal(got, jx[pre + "tokens"])


@pytest.mark.parametrize("mutant", W.TP_HEADS_MUTANTS)
def test_gradient_mutants_fail(run, mutant):
    """A gather whose backward sums, or an exit that all-reduces, moves
    some gradient leaf beyond the tolerance the real path holds."""
    ranks, _ = run
    f = ranks[0]
    case = "qwen2_vl_2b_h6"
    errs = _errors(f, f"mutant_{mutant}/{case}", f, f"local/{case}",
                   "grads")
    bad = [k for k, err, peak in errs if err > TOL * peak]
    assert bad and all(k.startswith("grads/") for k in bad), mutant
    if mutant == "gather_sums":      # 4x the attention weights' gradients
        assert all(k.split("/")[-1] in ("wq", "wk", "wv", "wo") for k in bad)
    # the real path's own gradient of the same case holds
    assert _held(f, f"1x4/{case}", f, f"local/{case}", "grads") > 8


def test_head_split_rule_and_mesh_context():
    """``blocks.head_split`` replicates the heads of qwen2-vl (12),
    musicgen (24) and starcoder2 (36) on the production mesh's 16-wide
    ``model`` axis and cuts every other attention config's; on a fake
    (1, 4) group ``lm._mesh_context`` takes 6 query heads and still
    refuses a ``d_ff`` the axis does not divide."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import blocks, dist, lm
    want = {"qwen2_vl_2b", "musicgen_medium", "starcoder2_7b"}
    got = {a for a in ARCH_IDS if not get_config(a).attention_free
           and blocks.head_split(get_config(a), 16) == "replicated"}
    assert got == want
    for case, (mesh, *_) in W.TP_HEADS_CASES.items():
        cfg = W.tp_config(case, get_config)
        tp = 4 if mesh == "1x4" else 2
        assert blocks.head_split(cfg, tp) == (
            "heads" if case in W.TP_HEADS_CUT else "replicated")
        assert blocks.head_split(cfg, 1) == "heads"
    # heads a rank within one GQA group, or whole groups: cut by heads
    base = get_config("internlm2_1p8b").smoke()
    assert blocks.head_split(base.replace(num_heads=8, num_kv_heads=2),
                             4) == "heads"
    assert blocks.head_split(base.replace(num_heads=8, num_kv_heads=4),
                             2) == "heads"
    assert blocks.head_split(base.replace(num_heads=12, num_kv_heads=2),
                             2) == "heads"
    assert blocks.head_split(base.replace(num_heads=12, num_kv_heads=2),
                             3) == "replicated"   # 4 heads, groups of 6
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=4)
    try:
        ctx = dist.model_context(meshlib.make_host_mesh(1, 4, device="cpu"))
        cfg = W.tp_config("qwen2_vl_2b_h6", get_config)
        with dist.use(ctx):
            assert lm._mesh_context(cfg) is ctx
            with pytest.raises(NotImplementedError, match="d_ff"):
                lm._mesh_context(cfg.replace(d_ff=250))
    finally:
        tdist.destroy_process_group()
