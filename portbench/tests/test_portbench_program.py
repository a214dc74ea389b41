"""The program's spans and counters in a traced run (``lib/program.py``):
the recorder's spans fill ``Record.program`` and lie inside the traced
window, the idle gaps are cut at them and named after the innermost, and
without the recorder (a program that lacks it) its readers give
nothing."""
import sys

import pytest

from portbench.lib import program as P

NEW = ["refit_host_ms", "decide_pack_ms", "stop_copy_ms", "precopy_send_ms",
       "scan_dirty_leaf_share", "decode_host_ms"]


def test_a_gap_is_cut_at_the_program_spans():
    host = [(0.0, 10.0, "refresh"), (10.0, 12.0, "tick")]
    program = [(1.0, 9.0, "a"), (2.0, 4.0, "b"), (6.0, 7.0, "c"),
               (4.0, 4.0, "empty")]
    got = P.cut_gaps([(0.0, 10.0), (10.5, 11.0), (11.0, 13.0)], host,
                     program)
    assert got == [("refresh", 1.0), ("a", 1.0), ("b", 2.0), ("a", 2.0),
                   ("c", 1.0), ("a", 2.0), ("refresh", 1.0),
                   ("tick", 0.5), ("host", 2.0)]


def test_pieces_of_one_name_are_joined():
    got = P.cut_gaps([(0.0, 4.0)], [], [(0.0, 2.0, "x"), (2.0, 4.0, "x")])
    assert got == [("x", 4.0)]


def test_the_dirty_leaf_share_reads_what_each_scan_read():
    from portbench.lib import harness as H
    from portbench.lib.trace import Record
    rec = Record("c", {}, {})
    # a scan of 100 bytes with 60 in dirty leaves, then one that skipped
    # the clean leaves and read 60, all dirty
    rec.program = ([], {"precopy.scan_bytes": [(0, (100, 60)),
                                               (1, (60, 60))]})
    read = H.load_module("layer_metrics", "scan_dirty_leaf_share").read
    assert read(rec) == pytest.approx(100.0 * 120 / 160)
    rec.program = ([], {})
    assert read(rec) is None


@pytest.fixture
def tracer_of(monkeypatch):
    """Keeps each ``Tracer`` and the benchmark's spans that ``read`` got."""
    from portbench.lib import trace
    kept = {}
    read = trace.Tracer.read

    def keep(self, rec, spans):
        kept.update(tracer=self, bench=spans)
        return read(self, rec, spans)

    monkeypatch.setattr(trace.Tracer, "read", keep)
    return kept


@pytest.mark.parametrize("cell, expect", [
    ("tick-16k-refit", "cycles.models"),
    ("internlm2-decode-migrate", "precopy.stop_and_copy")])
def test_a_traced_run_fills_the_program_recording(run_small, tracer_of, cell,
                                                  expect):
    out = run_small(cell, seed=37, trace=True)
    rec = out["record"]
    spans, counters = P.recording(rec)
    assert rec.program == (spans, counters)
    assert expect in {s.name for s in spans}
    tr = tracer_of["tracer"]
    assert all(tr.h0 <= s.start <= s.end <= tr.h1 for s in spans)
    named = P.named_gaps(tr, tracer_of["bench"], spans)
    idle = sum(s for _, s in named)
    assert idle == pytest.approx(rec.window_s - rec.busy_s, rel=1e-9)
    by_program = sum(t for n, t in named if n in {s.name for s in spans})
    assert by_program > 0


def test_without_the_recorder_the_readers_give_nothing(monkeypatch):
    from portbench.lib import harness as H
    from portbench.lib.trace import Record
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    rec = Record("c", {}, {})
    for name in NEW:
        assert H.load_module("layer_metrics", name).read(rec) is None
