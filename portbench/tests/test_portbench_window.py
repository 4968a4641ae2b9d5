"""The window's arithmetic on a fake clock, and the trace reduction on
made-up events."""

import torch

from portbench.drivers import train
from portbench.trace import Tracer, reduce_events


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class FakeTrainer:
    """A step takes ``dt`` seconds of the fake clock."""

    def __init__(self, clock, dt):
        self.clock, self.dt = clock, dt
        self.model = torch.nn.Linear(1, 1)
        self.batches = []

    def train_step(self, batch, point_coords=None):
        self.clock.t += self.dt
        self.batches.append(batch["i"])
        return {"total_loss": torch.tensor(1.0)}


class Pool:
    def __init__(self, n):
        self.batches = [{"i": i} for i in range(n)]
        self.coords = [torch.zeros(2, 1, 2)] * n

    def __len__(self):
        return len(self.batches)


def test_window_closes_with_the_step_that_crosses_the_time():
    clock = Clock()
    trainer = FakeTrainer(clock, 0.3)
    steps, elapsed, step_ms, losses = train.window(
        trainer, Pool(16), 3, 2.0, Tracer(False), clock=clock)
    assert steps == 7  # 6 steps reach 1.8 s, the 7th crosses 2.0 s
    assert abs(elapsed - 2.1) < 1e-9  # all the time, to the last step's end
    assert trainer.batches == [3, 4, 5, 6, 7, 8, 9]
    assert step_ms == [] and losses.shape == (7,)
    rate = steps * 64 / elapsed
    assert abs(rate - 7 * 64 / 2.1) < 1e-9


def test_window_cycles_through_the_pool():
    clock = Clock()
    trainer = FakeTrainer(clock, 1.0)
    train.window(trainer, Pool(4), 3, 5.0, Tracer(False), clock=clock)
    assert trainer.batches == [3, 0, 1, 2, 3]


def test_trace_reduction():
    spans = [("window", 100, 1100), ("train_step", 100, 600),
             ("train_step", 600, 1100)]
    ops = [("conv", 150, 400), ("bn", 350, 500), ("conv", 700, 1050),
           ("late", 1090, 1200), ("early", 0, 50)]
    r = reduce_events(ops, spans)
    assert r["window_s"] == 1000 / 1e9
    assert r["busy_s"] == (350 + 350 + 10) / 1e9
    assert r["device_ops"][0] == ["conv", 600 / 1e9]
    gaps = r["idle_gaps"]
    assert gaps[0] == ["train_step", 200 / 1e9]  # 500..700 under step 1
    assert sorted(g[1] for g in gaps) == sorted(
        x / 1e9 for x in (50, 200, 40))
    assert reduce_events([], spans) is None
    assert reduce_events(ops, [("train_step", 0, 1)]) is None


def test_volume_window_closes_with_the_volume_that_crosses(monkeypatch):
    from portbench.drivers import volume

    clock = Clock()
    calls = []

    def fake_volume(model, vol, kw, tracer):
        clock.t += 1.5
        calls.append(clock.t)
        return "labels", {"n": len(calls)}, {"axes": {}}, 0.0

    monkeypatch.setattr(volume, "run_volume", fake_volume)
    n, elapsed, answer, runs = volume.window(
        None, None, {"device": "cpu"}, 4.0, Tracer(False), clock=clock)
    assert n == 3 and abs(elapsed - 4.5) < 1e-9  # 3.0 s < 4.0 <= 4.5 s
    assert answer == "labels" and runs[-1][0] == {"n": 3}
