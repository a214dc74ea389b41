"""A new language-model configuration goes into the benchmark as new files
only: a copy of ``portbench/`` that adds a configuration, its reference
module and a traffic file (``tests/addition/``) and changes nothing else
runs its cell through a driver that is already there. The configuration
states two keys the internlm2 reference never reads, ``d_head`` (not
d_model / num_heads) and ``tie_embeddings``; its reference reads both,
and the traced run's ``prefill_mfu`` counts with that reference."""
import filecmp
import pathlib
import shutil

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[2]
ADDED = ROOT / "portbench" / "tests" / "addition"
CELL, CONFIG = "tiny-tied-prefill", "tiny-tied"


@pytest.fixture
def added(tmp_path, monkeypatch):
    """``harness.BENCH`` pointed at a copy of ``portbench/`` with the three
    files added under their kinds' directories."""
    from portbench.lib import harness as H
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ADDED / f"{CONFIG}.json", bench / "configs")
    shutil.copy(ADDED / f"{CONFIG}.py", bench / "refs")
    shutil.copy(ADDED / f"{CELL}.json", bench / "workloads")
    monkeypatch.setattr(H, "BENCH", bench)
    return bench


def _edited(a: pathlib.Path, b: pathlib.Path) -> list:
    """Files of ``a`` that ``b`` lacks or holds otherwise, recursively."""
    cmp = filecmp.dircmp(a, b, ignore=["__pycache__"])
    out = [a / n for n in cmp.left_only + cmp.diff_files + cmp.funny_files]
    for sub in cmp.common_dirs:
        out += _edited(a / sub, b / sub)
    return out


def test_the_copy_only_adds(added):
    assert _edited(ROOT / "portbench", added) == []
    assert sorted(p.relative_to(added).as_posix()
                  for p in _edited(added, ROOT / "portbench")) == [
        f"configs/{CONFIG}.json", f"refs/{CONFIG}.py",
        f"workloads/{CELL}.json"]


def test_the_port_builds_what_the_file_states(added):
    from portbench.lib import harness as H, lm as lmlib
    _, cfg = H.cell_files(CELL)
    arch = lmlib.arch_config(cfg)
    assert (arch.head_dim, arch.tie_embeddings) == (24, True)
    assert arch.head_dim != cfg["d_model"] // cfg["num_heads"]
    params = lmlib.make_params(cfg, 3, "cpu")
    assert "head" not in params
    assert params["blocks"]["attn"]["wq"].shape[-1] == 4 * 24


def test_the_new_cell_runs_correct(run_small, added):
    out = run_small(CELL, seed=43)
    assert out["attempted"] >= 1 and out["compared"] > 0
    assert all(c.ok for c in out["checks"]), [
        (c.name, c.value, c.limit) for c in out["checks"]]


def test_a_traced_run_counts_with_the_new_reference(run_small, added):
    from portbench.counts import kernels as K, lm as C
    from portbench.lib import harness as H
    from portbench.tests.conftest import small_sizes
    out = run_small(CELL, seed=47, trace=True)
    assert all(c.ok for c in out["checks"])
    rec = out["record"]
    _, cfg = H.cell_files(CELL)
    sizes = small_sizes(cfg)
    B, P = sizes["batch"], sizes["prompt"]
    ref = H.load_module("refs", CONFIG)
    want = out["attempted"] * ref.prefill_flops(cfg, B, P)
    assert rec.counters["prefill_flops"] == want
    assert want != out["attempted"] * C.prefill_flops(cfg, B, P)
    assert rec.counters["attention"] and all(
        D == 24 for _, _, _, _, D, _, _ in rec.counters["attention"])
    got = H.load_module("layer_metrics", "prefill_mfu").read(rec)
    t = sum(rec.spans["prefill"])
    assert got == pytest.approx(100.0 * want / (t * K.PEAK_FLOPS))
