"""The plain reference is the same function as the program's model: the
same state-dict keys and shapes at full width, and the same train-mode
outputs on the same weights, images and points (float32, CPU)."""

import json

import pytest
import torch

from portbench.drivers import train
from portbench.spec import HERE
from portbench.reference import models as ref_models

OUT_KEYS = ("sem_logits", "sem_points", "ctr_hmp", "offsets")


def _program(cfg):
    from empanada_torch.models import create_model

    m = dict(cfg["recipe"]["MODEL"])
    arch = m.pop("arch")
    m.pop("dtype")
    return create_model(arch, device="cpu", **m)


@pytest.mark.parametrize("config", ["mitonet", "pdlpr"])
def test_full_width_state_dicts_agree(config):
    cfg_full = json.loads((HERE / "configs" / f"{config}.json").read_text())
    prog = _program(cfg_full).state_dict()
    ref = train.state_shapes(cfg_full)
    assert list(prog) == list(ref)
    assert all(tuple(prog[k].shape) == ref[k][0] for k in prog)
    n = sum(prog[k].numel() for k in prog if "running" not in k
            and "num_batches" not in k)
    assert n == cfg_full["parameters"]


@pytest.mark.parametrize("config", ["mitonet", "pdlpr"])
def test_train_forward_agrees(tiny, config):
    cell = tiny(config)
    cfg = cell.config
    prog = _program(cfg).train()
    ref = ref_models.build(cfg, "cpu")
    state = train.make_weights(cfg, 3, "cpu")
    prog.load_state_dict(state)
    ref.load_state_dict(state)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 1, 128, 128), generator=g)
    coords = torch.rand((2, 16, 2), generator=g)
    torch.manual_seed(5)
    a = prog(x, point_coords=coords)
    torch.manual_seed(5)
    b = ref(x, coords)
    for k in OUT_KEYS:
        scale = b[k].abs().max().item() + 1e-12
        assert (a[k] - b[k]).abs().max().item() / scale < 1e-4, k
