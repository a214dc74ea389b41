"""The port's dry run (``launch/specs.py``, ``launch/trace_analysis.py``,
``launch/dryrun.py``) and the shape-only forms of B4 and B5.

(a) ``specs.input_specs`` equals the reference's for every arch x shape
    cell at full size, leaf for leaf (tree path, shape, dtype).
(b) Every cell's rank-0 argument bytes on the fake 16 x 16 and 2 x 16 x 16
    meshes equal the sum over leaves of the shard shape the reference's
    ``PartitionSpec``s give (read through a stand-in ``NamedSharding``)
    times the itemsize: spec arithmetic and the port's cut, no trace.
(c) Fake against real: four gloo CPU ranks (``torch_dist_worker.py``,
    suite "trace") run each smoke cell's train, prefill and decode step on
    (2, 2), counted by ``TraceAnalysis``; the dry run traces the same cells
    on fake tensors as rank 0 of a fake group of 4 (suite "trace_fake").
    Flops, collective calls, raw input bytes and link bytes by kind and the
    op count are equal exactly on every rank, the four memory fields on
    rank 0 (whose program the dry run traces).
    HBM bytes are equal for train and prefill; in decode the meta kernels
    give some size-1 dimensions other strides than the CPU kernels, so a
    product is folded otherwise (``bmm`` against ``mm``) and moves other
    bytes: within HBM_DECODE_RTOL there.
(d) Flops against a count written here from the widths: internlm2's smoke
    prefill and train step (remat none and block). The shape-only forms of
    B4 and B5 on fake CUDA tensors, with ``kernels/build.load`` made to
    raise: shapes, strides and the flop formulas; B4's formula equals the
    count of its plain chunked form.
(e) The reference's ``hlo_analysis.analyze`` of the same smoke dense cell
    (prefill and train, 4 forced host devices, ``AxisType.Auto`` axes:
    ROADMAP C-10) against the port's fake-``cpu`` count. Prefill: equal.
    Train: the port counts exactly one attention forward a layer more,
    the plain VJP's recompute (``kernels/vjp.py``, ROADMAP K6); with that
    term taken out, equal (tolerance 0; the raw gap is under 3%).
(f) The CLI on a handful of full-size cells (decode, fake ``cpu``), a cell
    the port's tensor parallelism refuses, ``--all``'s 66 cells.
(g) The refusals: ``--inner-shard``, ``--free-cache-out``, and a ``cuda``
    cell on a build without CUDA.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_dist_worker as W  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import shapes_for as jax_shapes_for  # noqa: E402
from repro.launch import sharding as jax_sharding  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.trace_analysis import analyze, nbytes  # noqa: E402
from repro_torch.models import gla  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HBM_DECODE_RTOL = 0.03
#: the analyzer cell of (d) and (e): internlm2's smoke widths
AN_BATCH, AN_SEQ = W.ANALYZER_BATCH, W.ANALYZER_SEQ


def _jax_leaves(tree):
    return [(tuple(str(k.key) if hasattr(k, "key") else str(k.idx)
                   for k in path), tuple(leaf.shape),
             np.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _torch_leaves(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _torch_leaves(tree[k],
                                                               path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _torch_leaves(v, path + (str(i),))]
    return [(path, tuple(tree.shape), str(tree.dtype)[len("torch."):])]


# ---------------------------------------------------------------------------
# (a) specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cells = jax_shapes_for(jax_config(arch))
    assert [s.name for s in cells] == [
        s.name for s in dryrun.shapes_for(get_config(arch))]
    for shape in cells:
        want_mode, want = jax_specs.input_specs(jax_config(arch), shape)
        mode, got = specs.input_specs(get_config(arch), SHAPES[shape.name])
        assert mode == want_mode
        assert all(t.device.type == "meta"
                   for t in torch.utils._pytree.tree_leaves(got))
        assert _torch_leaves(got) == _jax_leaves(want), (arch, shape.name)


# ---------------------------------------------------------------------------
# (b) a rank's argument bytes from the reference's rules
# ---------------------------------------------------------------------------
class RankZero:
    """Duck-typed mesh for both packages' rules, this process rank 0: the
    port's (``mesh_dim_names``, a shape tuple, ``get_local_rank``) and the
    reference's (``axis_names``, ``shape`` as a mapping, ``devices``)."""

    def __init__(self, shape):
        self.sizes = dict(shape)
        self.mesh_dim_names = self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()))

    @property
    def shape(self):
        return self.sizes

    def get_local_rank(self, name):
        return 0


class PortMesh(RankZero):
    @property
    def shape(self):
        return tuple(self.sizes.values())


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _shard_bytes(mesh, spec, leaf) -> int:
    n = 1
    for d, dim in enumerate(leaf.shape):
        entry = tuple(spec)[d] if d < len(tuple(spec)) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        cut = int(np.prod([mesh.sizes[a] for a in axes])) if axes else 1
        assert dim % cut == 0
        n *= dim // cut
    return n * np.dtype(leaf.dtype).itemsize


def _reference_bytes(mesh, specs_tree, shapes) -> int:
    flat = jax.tree_util.tree_flatten_with_path(
        specs_tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))[0]
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat) == len(leaves)
    return sum(_shard_bytes(mesh, spec, leaf)
               for (_, spec), (_, leaf) in zip(flat, leaves))


@pytest.fixture
def reference_specs(monkeypatch):
    monkeypatch.setattr(jax_sharding, "NamedSharding",
                        lambda mesh, spec: spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_rank_argument_bytes_follow_reference_rules(arch, mesh,
                                                    reference_specs):
    ref_mesh, port_mesh = RankZero(MESHES[mesh]), PortMesh(MESHES[mesh])
    S = jax_sharding
    for shape in jax_shapes_for(jax_config(arch)):
        mode, args = jax_specs.input_specs(jax_config(arch), shape)
        if mode == "train":
            trees = [(S.state_shardings(ref_mesh, args[0]), args[0]),
                     (S.batch_shardings(ref_mesh, args[1]), args[1])]
        elif mode == "prefill":
            trees = [(S.param_shardings(ref_mesh, args[0]), args[0]),
                     (S.batch_shardings(ref_mesh, args[1]), args[1])]
        else:
            trees = [(S.param_shardings(ref_mesh, args[0]), args[0]),
                     (S.batch_shardings(ref_mesh, {"tokens": args[1]})
                      ["tokens"], args[1]),
                     (S.cache_shardings(ref_mesh, jax_config(arch), args[2]),
                      args[2])]
        want = sum(_reference_bytes(ref_mesh, s, t) for s, t in trees)
        with FakeTensorMode():
            _, got = dryrun.cell_args(get_config(arch), SHAPES[shape.name],
                                      port_mesh, torch.device("cpu"))
        assert nbytes(got) == want, (arch, shape.name, mesh)


# ---------------------------------------------------------------------------
# (c), (e): the ranks, the fake trace and the reference's analyzer at once
# ---------------------------------------------------------------------------
JAX_ANALYZER = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch import sharding, specs
from repro.launch.hlo_analysis import analyze
from repro.launch.mesh import batch_axes
from repro.models import dist
from repro.train import make_prefill_step, make_train_step
B, S = int(sys.argv[1]), int(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for remat in ("none", "block"):
    cfg = get_config("internlm2_1p8b").smoke().replace(remat=remat)
    hooks = dict(constrain=sharding.make_constrain(mesh, cfg),
                 constrain_logits=sharding.make_constrain_logits(mesh))
    ctx = dist.DistContext(mesh=mesh, batch_axes=batch_axes(mesh),
                           tp_axis="model", seq_shard=cfg.seq_shard)
    state, batch = specs.state_specs(cfg), specs.batch_specs(cfg, B, S)
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    params = specs.params_specs(cfg)
    with mesh, dist.use(ctx):
        st = (sharding.state_shardings(mesh, state),
              sharding.batch_shardings(mesh, batch))
        train = jax.jit(make_train_step(cfg, **hooks), in_shardings=st,
                        out_shardings=(st[0], None), donate_argnums=(0,))
        out["train_" + remat] = analyze(
            train.lower(state, batch).compile().as_text())["flops"]
        pre = jax.jit(make_prefill_step(cfg, cache_len=S,
                                        constrain=hooks["constrain"]),
                      in_shardings=(sharding.param_shardings(mesh, params),
                                    sharding.batch_shardings(mesh, prompt)))
        out["prefill_" + remat] = analyze(
            pre.lower(params, prompt).compile().as_text())["flops"]
print("ANALYZER " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Runs, at once: the four gloo ranks (suite "trace"), the fake trace
    (suite "trace_fake", also the analyzer cells of (e)), and the
    reference's analyzer in a JAX subprocess."""
    work = tmp_path_factory.mktemp("trace")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_ANALYZER, str(AN_BATCH), str(AN_SEQ)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True)
    try:
        W.launch([("trace", 4), ("trace_fake", 1)], work)
        out = jax_proc.communicate(timeout=W.LAUNCH_TIMEOUT)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, out[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("ANALYZER ")][-1]
    return ([W.load("trace", 4, r, work) for r in range(4)],
            W.load("trace_fake", 1, 0, work),
            json.loads(line[len("ANALYZER "):]))


@pytest.mark.parametrize("arch", W.TRACE_ARCHS)
@pytest.mark.parametrize("mode", ("train", "prefill", "decode"))
def test_fake_trace_equals_real_ranks(traced, arch, mode):
    ranks, fake, _ = traced
    keys = [k for k in fake.files if k.startswith(f"{arch}/{mode}/")]
    assert f"{arch}/{mode}/flops" in keys and any(
        "/collective_calls/" in k for k in keys)
    for r, real in enumerate(ranks):
        assert sorted(k for k in real.files
                      if k.startswith(f"{arch}/{mode}/")) == sorted(keys)
        for k in keys:
            if "/memory/" in k and r:
                continue            # the fake trace is rank 0's program
            if k.endswith("/hbm_bytes") and mode == "decode":
                assert abs(real[k] - fake[k]) <= HBM_DECODE_RTOL * real[k]
            else:
                assert real[k] == fake[k], (r, k, real[k], fake[k])


def _attention_fwd_flops(cfg, B, S):
    """Both products of one causal attention over S positions done as
    whole (S, S) blocks (S <= the plain version's chunk)."""
    return 2 * 2 * B * cfg.num_heads * S * S * cfg.head_dim


@pytest.mark.parametrize("remat", ("none", "block"))
@pytest.mark.parametrize("mode", ("prefill", "train"))
def test_flops_match_reference_analyzer(traced, remat, mode):
    _, fake, want = traced
    got = float(fake[f"analyzer_{remat}/{mode}/flops"])
    ref = want[f"{mode}_{remat}"]
    if mode == "prefill":
        assert got == ref
        return
    # a rank's share of the plain VJP's recompute: half the batch, half the
    # heads, every layer
    cfg = get_config("internlm2_1p8b").smoke()
    extra = cfg.num_layers * _attention_fwd_flops(
        cfg.replace(num_heads=cfg.num_heads // 2), AN_BATCH // 2, AN_SEQ)
    assert got - ref == extra
    assert (got - ref) / ref < 0.03


# ---------------------------------------------------------------------------
# (d) flops against the widths; the shape-only kernels
# ---------------------------------------------------------------------------
def _widths_flops(cfg, B, S, mode):
    d, H, Hkv, hd, ff, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    qkv = 2 * B * S * d * (H + 2 * Hkv) * hd
    proj = 2 * B * S * H * hd * d
    up = 2 * B * S * d * ff           # each of gate, up and down
    lin = qkv + proj + 3 * up
    att = _attention_fwd_flops(cfg, B, S)
    if mode == "prefill":             # the head on the last position only
        return cfg.num_layers * (lin + att) + 2 * B * d * V
    # forward, 2x backward; attention also its plain VJP's recompute; block
    # remat runs each layer's forward again, but the recompute stops once
    # every saved tensor is back: the down projection's output is saved by
    # no backward, so that product is not run again
    per_layer = 3 * lin + 4 * att
    if cfg.remat == "block":
        per_layer += lin - up + att
    return cfg.num_layers * per_layer + 3 * 2 * B * S * d * V


@pytest.mark.parametrize("remat", ("none", "block"))
@pytest.mark.parametrize("mode", ("prefill", "train"))
def test_flops_match_analytic_count(remat, mode):
    cfg = get_config("internlm2_1p8b").smoke().replace(remat=remat)
    got = dryrun.trace(cfg, ShapeConfig("smoke", AN_SEQ, AN_BATCH, mode),
                       None, "cpu")
    assert got["flops"] == _widths_flops(cfg, AN_BATCH, AN_SEQ, mode)
    assert got["collectives"] == {"total": 0.0}
    assert got["memory"]["argument_size_in_bytes"] > 0


@pytest.fixture
def no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the kernel library {name} was touched")
    monkeypatch.setattr(build, "load", refuse)
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("window", (0, 40))
def test_attention_shape_only_form(no_library, window):
    B, H, Hkv, S, D = 2, 8, 2, 96, 64
    with FakeTensorMode():
        q = torch.empty(B, H, S, D, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(B, Hkv, S, D, device="cuda", dtype=torch.bfloat16)
        out, a = analyze(lambda q, k: ops.flash_attention(
            q, k, k, window=window), q, k)
    assert out.shape == (B, H, S, D) and out.dtype == torch.bfloat16
    assert out.device.type == "cuda"
    assert out.stride() == (S * H * D, D, H * D, 1)      # (B, S, H, D) order
    assert a.flops_by_op == {"repro_torch.flash_attention":
                             4 * D * B * H * ops.attention_pairs(S, window)}
    assert ops.attention_pairs(S, 0) == S * (S + 1) // 2
    assert ops.attention_pairs(S, 40) == sum(min(i + 1, 40)
                                             for i in range(S))


def test_kernel_operators_take_no_cpu_tensor(no_library):
    """The operators have a CUDA kernel and a fake form, no CPU kernel: a
    real CPU tensor raises instead of reaching a plain version (the CPU
    path is ``ops``' own branch)."""
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.flash_attention(q, q, q, 0)
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.ssm_scan(q, q, q, q, None, None)


@pytest.mark.parametrize("rwkv", (False, True))
def test_scan_shape_only_form(no_library, rwkv):
    B, H, S, Dk, Dv = 2, 4, 70, 16, 8

    def scan(device):
        with FakeTensorMode():
            q = torch.empty(B, H, S, Dk, device=device)
            v = torch.empty(B, H, S, Dv, device=device)
            bonus = torch.empty(H, Dk, device=device) if rwkv else None
            return analyze(lambda q, v: ops.ssm_scan(q, q, v, q, bonus=bonus),
                           q, v)

    (y, state), a = scan("cuda")
    assert (y.shape, state.shape) == ((B, H, S, Dv), (B, H, Dk, Dv))
    assert y.dtype == state.dtype == torch.float32
    assert a.flops == ops.scan_flops(B, H, S, Dk, Dv, rwkv)
    assert a.flops_by_op == {"repro_torch.ssm_scan": a.flops}
    # the formula is the count of the plain chunked form (the CPU path)
    _, plain = scan("cpu")
    assert plain.flops == a.flops and gla.CHUNK == 32


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------
KEYS = {"arch", "shape", "mesh", "devices", "rank", "device", "mode",
        "memory", "flops", "hbm_bytes", "hbm_write_bytes", "collectives",
        "collective_calls", "collective_input_bytes", "trace_s", "ok",
        "tag", "overrides"}
MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
          "alias_size_in_bytes", "temp_size_in_bytes"}
#: full-size cells traced through the CLI (decode: a few hundred ops)
CLI_CELLS = (("rwkv6_1p6b", "decode_32k", "single"),
             ("zamba2_2p7b", "long_500k", "multi"),
             ("qwen3_moe_30b_a3b", "decode_32k", "single"),
             ("qwen2_vl_2b", "decode_32k", "single"))


@pytest.fixture(scope="module")
def cli_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", s, "--mesh", m, "--device", "cpu", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for a, s, m in CLI_CELLS]
    codes = [(p.communicate(timeout=300)[0], p.returncode) for p in procs]
    return {cell: (json.loads((out / f"{'_'.join(cell)}.json").read_text()),
                   text, code) for cell, (text, code) in zip(CLI_CELLS,
                                                            codes)}


@pytest.mark.parametrize("cell", CLI_CELLS[:3], ids="_".join)
def test_cli_traces_a_full_size_cell(cli_records, cell):
    rec, text, code = cli_records[cell]
    assert code == 0, text[-3000:]
    assert KEYS <= set(rec) and MEMORY == set(rec["memory"])
    assert rec["ok"] and rec["rank"] == 0 and rec["device"] == "cpu"
    assert rec["devices"] == {"single": 256, "multi": 512}[cell[2]]
    assert rec["mode"] == "decode" and rec["flops"] > 0
    assert rec["kernels_loaded"] == []
    mem = rec["memory"]
    # decode writes the cache in place: the outputs alias its rings
    assert 0 < mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]
    assert rec["collectives"]["total"] == sum(
        v for k, v in rec["collectives"].items() if k != "total")
    assert f"[dryrun] {' '.join(cell)} cpu OK" in text


def test_cli_records_a_cell_the_port_refuses(cli_records):
    # qwen2-vl's 12 query heads: a model axis of 16 does not divide them,
    # and the port's tensor parallelism raises there (ROADMAP deviations)
    rec, text, code = cli_records[("qwen2_vl_2b", "decode_32k", "single")]
    assert code == 1 and rec["ok"] is False
    assert "does not divide" in rec["error"]


def test_all_runs_66_cells_each_in_a_process(monkeypatch, tmp_path):
    cells = list(dryrun.cells("both"))
    assert len(cells) == 66 and len(set(cells)) == 66
    assert len(list(dryrun.cells("single"))) == 33
    runs = []

    class Done:
        returncode = 0

    monkeypatch.setattr(dryrun.subprocess, "run",
                        lambda cmd, **kw: runs.append(cmd) or Done())
    assert dryrun.main(["--all", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    assert len(runs) == 66
    assert all(cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
               and "--device" in cmd for cmd in runs)


# ---------------------------------------------------------------------------
# (g) refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flag", ("--inner-shard", "--free-cache-out"))
def test_cli_refuses_xla_only_options(flag, tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3_moe_30b_a3b", "--shape",
                        "train_4k", "--mesh", "single", flag, "--out",
                        str(tmp_path)]) == 2
    assert "refused " + flag in capsys.readouterr().err
    assert not list(tmp_path.iterdir())          # no record, no trace


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k"))
def test_cuda_cell_refused_without_cuda_build(shape):
    if torch.backends.cuda.is_built():
        pytest.skip("a build with CUDA traces cuda cells")
    with pytest.raises(RuntimeError, match="needs torch built with CUDA"):
        dryrun.run_cell("internlm2_1p8b", shape, False, device="cuda")
    cfg = get_config("internlm2_1p8b").smoke()
    with pytest.raises(RuntimeError, match="needs torch built with CUDA"):
        dryrun.trace(cfg, ShapeConfig("s", 16, 2, SHAPES[shape].mode),
                     None, "cuda")
