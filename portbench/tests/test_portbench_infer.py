"""The inference reference against the program (float32, CPU, small
volumes, the bench MitoNet at full width): the same answer in stack
mode and in orthoplane mode;
the answer altered where it is produced (every second instance left
out) fails the cell's limits. The harness's look for a card is skipped
by driving the program and the check directly."""

import copy
import json

import numpy as np

from portbench import check, gen
from portbench.drivers import volume as vd
from portbench.reference.infer import compare_labels
from portbench.spec import HERE
from portbench.trace import Tracer

CFG = json.loads((HERE / "configs" / "mitonet.json").read_text())


def _float32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["recipe"]["MODEL"]["dtype"] = "float32"
    return cfg


def _settings(traffic):
    s = vd.settings(json.loads((HERE / "traffic"
                                / f"{traffic}.json").read_text()))
    s.update(min_size=50, min_span=2, max_centers=64, block_size=None)
    return s


def _check(cfg, state, traffic, shape, **settings):
    s = dict(_settings(traffic), **settings)
    model = vd.program_model(cfg, state, "cpu")
    vol, _ = gen.em_volume({"shape": shape, "instances": 12,
                            "overlap": False}, 2**31 + 7)
    out, inst, _, _ = vd.run_volume(model, vol, vd.program_kwargs(s, "cpu"),
                                    Tracer(False))
    assert len(inst) > 3
    ref, probs = vd._reference(cfg, state, vol, s, "cpu")
    assert set(compare_labels(out, ref, probs=probs).values()) == {0.0}
    from empanada_torch.inference.patterns import fill_volume

    limits = json.loads((HERE / "limits"
                         / f"mitonet_{traffic}.json").read_text())["limits"]
    half = np.zeros(vol.shape, np.uint32)
    fill_volume(half, vd.drop_half(inst))
    assert not check.judge(compare_labels(half, ref, probs=probs),
                           limits)[0]


def test_stack_answer_matches_at_full_width():
    _check(_float32(CFG), vd.bench_weights(CFG), "stack", (16, 128, 128))


def test_orthoplane_answer_matches():
    _check(_float32(CFG), vd.bench_weights(CFG), "slab", (32, 128, 128),
           min_size=20)
