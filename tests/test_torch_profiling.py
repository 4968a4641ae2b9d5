"""The span recorder (``empanada_torch.utils.profiling``) and the spans of
``run_inference3d``: which thread records each span, how they nest, how
many there are, that recording changes no answer, that a span reads no
clock while recording is off, and (on the card) that spans and the
profiler's device events share a clock. No JAX here: the card test runs
in this file."""

import json
import threading

import numpy as np
import pytest
import torch

from empanada_torch.cli import infer3d
from empanada_torch.cli.infer3d import run_inference3d
from empanada_torch.inference import fused
from empanada_torch.inference.patterns import fill_volume
from empanada_torch.synthetic import SyntheticModule
from empanada_torch.utils import profiling

# span -> the thread that records it (worker threads by name prefix; the
# dispatching thread is the caller's)
THREADS = {
    "infer.axis": "MainThread", "infer.setup": "MainThread",
    "infer.load_wait": "MainThread", "infer.dispatch": "MainThread",
    "infer.handoff": "MainThread", "infer.join": "MainThread",
    "infer.consensus": "MainThread", "infer.fill": "MainThread",
    "infer.load": "infer-load", "infer.decode": "infer-decode",
    "infer.match": "infer-match", "infer.backward": "infer-finish-",
    "infer.track": "infer-finish-", "infer.filter": "infer-finish-",
}
# span -> the spans it may open inside (None: the top of its thread)
PARENTS = {
    "infer.axis": {None}, "infer.setup": {None, "infer.axis"},
    "infer.load_wait": {"infer.axis"}, "infer.dispatch": {"infer.axis"},
    "infer.handoff": {"infer.axis"}, "infer.d2h_wait": {"infer.decode"},
}


class _CountingEngine(fused.FusedStackEngine):
    """Keeps each pass's ``last_dispatch_count``."""

    passes = []

    def _blocks(self, p, batches):
        yield from super()._blocks(p, batches)
        self.passes.append(self.last_dispatch_count)


def _volume(d=19, h=30, w=27):
    """uint8 noise with six bright ellipsoids; no side a multiple of the
    padding factor (16)."""
    rng = np.random.default_rng(3)
    vol = rng.integers(0, 100, (d, h, w)).astype(np.uint8)
    zz, yy, xx = np.mgrid[:d, :h, :w]
    for _ in range(6):
        cz, cy, cx = rng.uniform(0, d), rng.uniform(3, h - 3), \
            rng.uniform(3, w - 3)
        r = rng.uniform(2.5, 5)
        vol[((zz - cz) / 2.5) ** 2 + ((yy - cy) / r) ** 2
            + ((xx - cx) / r) ** 2 <= 1] = 250
    return vol


def _run(vol):
    return run_inference3d(
        SyntheticModule(), vol, labels=[1], thing_list=[1],
        mode="orthoplane", label_divisor=100, padding_factor=16,
        max_centers=64, min_size=10, min_span=1, block_size=4,
        progress=False, norms={"mean": 0.5, "std": 0.2}, device="cpu")


@pytest.fixture(scope="module")
def recorded():
    """One orthoplane run and its fill with recording on: (volume,
    consensus, spans, dispatches counted by the engine)."""
    vol = _volume()
    _CountingEngine.passes = []
    old, fused.FusedStackEngine = fused.FusedStackEngine, _CountingEngine
    try:
        with profiling.recording() as spans:
            consensus = _run(vol)
            fill_volume(np.zeros(vol.shape, np.uint32),
                        consensus[1].instances)
    finally:
        fused.FusedStackEngine = old
    return vol, consensus, spans, list(_CountingEngine.passes)


def test_orthoplane_spans_threads_nesting_and_counts(recorded):
    vol, _, spans, passes = recorded
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    # on the CPU no copy is waited for
    assert {s.name for s in spans} == set(THREADS)
    for s in spans:
        assert s.thread_name.startswith(THREADS[s.name]), s
        parent = by_id[s.parent].name if s.parent is not None else None
        assert parent in PARENTS.get(s.name, {None}), s
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert 0 <= s.cpu_ns and s.start_ns <= s.end_ns
    calls = {s.call for s in spans if s.name != "infer.fill"}
    assert len(calls) == 1 and None not in calls
    names = [s.name for s in spans]
    assert names.count("infer.axis") == 3
    assert names.count("infer.match") == sum(vol.shape)
    assert len(passes) == 3
    assert names.count("infer.dispatch") == sum(passes)
    assert names.count("infer.load") == names.count("infer.load_wait") \
        == names.count("infer.handoff") == names.count("infer.decode") \
        == sum(passes)
    for step in ("infer.backward", "infer.track", "infer.filter"):
        assert sorted(s.thread_name for s in spans if s.name == step) == \
            ["infer-finish-xy", "infer-finish-xz", "infer-finish-yz"]
    summary = spans.summary()
    assert summary["infer.match"]["count"] == sum(vol.shape)
    assert summary["infer.axis"]["total_s"] == pytest.approx(sum(
        (s.end_ns - s.start_ns) / 1e9 for s in spans
        if s.name == "infer.axis"))


def test_recording_off_reads_no_clock_and_changes_no_answer(recorded,
                                                             monkeypatch):
    vol, want, _, _ = recorded

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"clock read while off: {name}")

    monkeypatch.setattr(profiling, "time", NoClock())
    got = _run(vol)
    assert profiling._rec is None
    assert got.keys() == want.keys()
    got, want = got[1].instances, want[1].instances
    assert want and list(got) == list(want)
    for label, attrs in want.items():
        assert tuple(got[label]["box"]) == tuple(attrs["box"])
        for key in ("starts", "runs"):
            np.testing.assert_array_equal(got[label][key], attrs[key])


def test_span_off_is_one_shared_object():
    assert profiling.span("a") is profiling.span("b", call=3)
    with profiling.span("a") as inside:
        assert inside is None
    profiling.count("c")
    assert profiling.new_call() is None and profiling.current_call() is None


def test_recorder_nesting_calls_counters_and_threads():
    with profiling.recording() as spans:
        call = profiling.new_call()
        with profiling.span("outer", call):
            assert profiling.current_call() == call
            with profiling.span("inner"):
                sum(range(20000))
            with profiling.recording() as same:
                assert same is spans

            def work():
                with profiling.span("worker", call):
                    pass
                with profiling.span("orphan"):
                    pass

            th = threading.Thread(target=work, name="w")
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
        profiling.count("n")
        profiling.count("n", 4)
    assert spans.counters == {"n": 5}
    s = {x.name: x for x in spans}
    assert s["inner"].parent == s["outer"].id and s["inner"].call == call
    assert s["outer"].parent is None
    assert s["worker"].thread_name == "w" and s["worker"].parent is None
    assert s["worker"].call == call and s["orphan"].call is None
    assert s["inner"].cpu_ns > 0
    assert s["outer"].cpu_ns >= s["inner"].cpu_ns
    assert [x.name for x in spans].index("inner") < \
        [x.name for x in spans].index("outer")
    summary = spans.summary()
    assert summary["outer"]["count"] == 1
    assert summary["outer"]["total_s"] == \
        (s["outer"].end_ns - s["outer"].start_ns) / 1e9
    assert profiling.span("late") is profiling.span("other")


def test_infer3d_trace_dir_writes_trace_and_spans(tmp_path, monkeypatch):
    def command(args):
        with profiling.span("infer.fill"):
            torch.ones(4).add_(1)

    monkeypatch.setattr(infer3d, "_run_command", command)
    out = tmp_path / "t"
    infer3d.main(["m.yaml", "v.npy", "--use-cpu", "-trace-dir", str(out)])
    assert json.loads((out / "trace.json").read_text())
    spans = json.loads((out / "spans.json").read_text())
    assert spans["clock"] == "time.time_ns" and spans["counters"] == {}
    (only,) = spans["spans"]
    assert only["name"] == "infer.fill"
    assert set(only) == set(profiling.Span._fields)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device's events come from "
                    "its profiler")


@pytest.mark.cuda
def test_spans_and_device_events_share_a_clock():
    """A sleeping kernel launched and waited for inside a span lies,
    as the profiler's CUDA trace places it, inside the span to 0.2 ms."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            profiling.recording() as spans:
        with profiling.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    (s,) = spans
    cpu = torch.autograd.DeviceType.CPU
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() != cpu and "spin_kernel" in e.name()]
    assert kernels, [e.name() for e in prof.profiler.kineto_results.events()]
    k = max(kernels, key=lambda e: e.end_ns() - e.start_ns())
    assert k.end_ns() - k.start_ns() > 2_000_000
    slack = 200_000
    assert s.start_ns - slack <= k.start_ns() <= k.end_ns() \
        <= s.end_ns + slack, (s.start_ns, k.start_ns(), k.end_ns(), s.end_ns)


@pytest.mark.cuda
def test_orthoplane_on_the_card_waits_for_copies_in_decode():
    """On the card, each block's copy to the host is waited for inside
    the decode worker's span."""
    _card()
    with profiling.recording() as spans:
        run_inference3d(
            SyntheticModule(), _volume(), labels=[1], thing_list=[1],
            mode="orthoplane", label_divisor=100, padding_factor=16,
            max_centers=64, min_size=10, min_span=1, block_size=4,
            progress=False, norms={"mean": 0.5, "std": 0.2})
    by_id = {s.id: s for s in spans}
    waits = [s for s in spans if s.name == "infer.d2h_wait"]
    assert len(waits) == sum(s.name == "infer.dispatch" for s in spans)
    for s in waits:
        assert s.thread_name.startswith("infer-decode")
        assert by_id[s.parent].name == "infer.decode"


def test_handoff_to_a_full_queue_is_counted():
    """A block handed to the matcher while its queue is full waits, and
    counts once as ``infer.handoff_full``."""
    from empanada_torch.inference.patterns import ForwardMatcher, \
        create_matchers

    release = threading.Event()

    class Packed:
        def __array__(self, dtype=None, copy=None):
            assert release.wait(timeout=30)
            return np.zeros((1, 1, 3), np.int32)

    block = ([None], np.zeros((1, 16, 16), np.int32), Packed())
    with profiling.recording() as spans:
        fm = ForwardMatcher(create_matchers([1], 100), [1], 100, [1],
                            queue_size=1)
        fm.put_block(*block)
        for _ in range(3000):  # the match thread takes the first block
            if fm._queue.empty():
                break
            threading.Event().wait(0.01)
        fm.put_block(*block)
        third = threading.Thread(target=fm.put_block, args=block)
        third.start()
        threading.Event().wait(0.2)
        release.set()
        third.join(timeout=30)
        assert not third.is_alive()
        assert fm.finish() == []
    assert spans.counters == {"infer.handoff_full": 1}
    assert [s.name for s in spans].count("infer.handoff") == 3
