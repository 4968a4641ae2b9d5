"""``portbench.spans`` on hand-made intervals: idle time goes to the
innermost span open on the dispatching thread, split where a gap
crosses a span's edge, to ``window`` outside every span, and never to
another thread's spans; the per-volume numbers and their shares."""

import pytest

from empanada_torch.utils.profiling import Span
from portbench import spans as sp

MAIN, OTHER = 1, 2


def _span(i, name, start, end, thread=MAIN, cpu=0, parent=None):
    return Span(i, name, thread, "t", start, end, cpu, parent, 1)


def test_merged_and_idle_intervals():
    assert sp.merged([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert sp.idle_intervals([(2, 4), (3, 5), (8, 12), (-5, -1)], 0, 10) \
        == [(0, 2), (5, 8)]
    assert sp.idle_intervals([], 0, 10) == [(0, 10)]
    assert sp.idle_intervals([(0, 10)], 0, 10) == []


def test_innermost_span_wins():
    spans = [_span(1, "infer.axis", 0, 100),
             _span(2, "infer.dispatch", 10, 30, parent=1),
             _span(3, "infer.handoff", 30, 50, parent=1)]
    got = sp.idle_by_span([(12, 20), (40, 45), (60, 70)], spans, MAIN)
    assert got == pytest.approx({"infer.dispatch": 8e-9,
                                 "infer.handoff": 5e-9,
                                 "infer.axis": 10e-9})


def test_gaps_straddling_span_edges_split():
    spans = [_span(1, "infer.axis", 0, 100),
             _span(2, "infer.load_wait", 20, 40, parent=1),
             _span(3, "infer.consensus", 120, 150)]
    got = sp.idle_by_span([(10, 30), (35, 130)], spans, MAIN)
    assert got == pytest.approx({"infer.axis": (10 + 60) * 1e-9,
                                 "infer.load_wait": (10 + 5) * 1e-9,
                                 "window": 20e-9,
                                 "infer.consensus": 10e-9})


def test_idle_outside_every_span_and_other_threads_ignored():
    spans = [_span(1, "infer.match", 0, 100, thread=OTHER),
             _span(2, "infer.join", 50, 60)]
    got = sp.idle_by_span([(0, 40), (55, 70)], spans, MAIN)
    assert got == pytest.approx({"window": 50e-9, "infer.join": 5e-9})
    assert sp.idle_by_span([(0, 10)], [], MAIN) == {"window": 1e-8}


def test_self_off_cpu_takes_out_children():
    spans = [_span(2, "infer.d2h_wait", 10, 40, cpu=5, parent=1),
             _span(1, "infer.decode", 0, 100, cpu=50),
             _span(3, "infer.match", 0, 10, thread=OTHER, cpu=10)]
    # decode: 100 - 50 off the CPU, of which 25 belong to d2h_wait
    assert sp.self_off_cpu(spans) == pytest.approx(
        {"infer.decode": 25e-9, "infer.d2h_wait": 25e-9, "infer.match": 0})


def test_per_volume_numbers_and_shares():
    spans = [_span(1, "infer.handoff", 0, 4e9, cpu=1e9),
             _span(2, "infer.match", 0, 2e9, thread=OTHER, cpu=1e9),
             _span(3, "infer.load", 0, 1e9, thread=OTHER, cpu=0.5e9)]
    idle = {"infer.handoff": 4.0, "infer.load_wait": 2.0,
            "infer.dispatch": 1.0, "infer.join": 1.0, "window": 2.0}
    out = sp.per_volume(idle, spans, volumes=2)
    m = out["metrics"]
    assert m["idle_handoff_share.infer"] == pytest.approx(40.0)
    assert m["idle_load_share.infer"] == pytest.approx(20.0)
    assert m["idle_dispatch_share.infer"] == pytest.approx(10.0)
    assert m["idle_outside_forward_share.infer"] == pytest.approx(10.0)
    assert m["handoff_wait_s.infer"] == pytest.approx(2.0)
    assert m["match_s.infer"] == pytest.approx(1.0)
    # work spans only: match 1 s and load 0.5 s off the CPU, 2 volumes
    assert m["lock_wait_s.infer"] == pytest.approx(0.75)
    assert out["idle_s"]["window"] == pytest.approx(1.0)
    empty = sp.per_volume({}, [], volumes=1)["metrics"]
    assert empty["idle_load_share.infer"] is None
    assert empty["match_s.infer"] == 0.0
