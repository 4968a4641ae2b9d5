"""Shared fixtures of the benchmark's own tests (run with
``python -m pytest portbench/tests``). Tests that need a card carry the
``cuda`` marker and skip here through the ``card`` fixture."""

import copy
import json

import pytest
import torch

from portbench.spec import HERE


class TinyCell:
    """A training cell at a size the CPU holds: the configuration's
    model at small widths, four crops of 128^2 a batch."""

    def __init__(self, config):
        cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
        traffic = json.loads((HERE / "traffic" / "train.json").read_text())
        if config == "mitonet":
            cfg["encoder"].update(name="regnety_200mf", widths=[24, 56, 152, 368],
                                  depths=[1, 1, 4, 7], groups=[3, 7, 19, 46],
                                  se=False)
            cfg["recipe"]["MODEL"].update(encoder="regnety_200mf", fpn_dim=32,
                                          fpn_layers=1)
        traffic.update(batch=4, crop=128, pool=4, points=16)
        self.name, self.chips = f"tiny_{config}", 1
        self.config, self.traffic = cfg, traffic
        limits = json.loads((HERE / "limits"
                             / f"{config}_train.json").read_text())
        self.limits = copy.deepcopy(limits)


@pytest.fixture
def tiny():
    return TinyCell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
