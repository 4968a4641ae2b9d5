"""Port parity of the optimizers and schedules (train/optim.py): each
step's learning rate for totals {2, 3, 10, 100} within 1e-7 relative
(or one float32 unit in the last place: XLA's float32 cosine is not
correctly rounded at every argument, the port's is);
the decay mask and the finetune freeze mask on the same leaves as the
JAX package's flax paths; AdamW / Adam / SGD (with and without
weight decay and grad_clip) over 5 updates of a small tree within 1e-6
of each leaf's scale."""

import pytest

for _dep in ("jax", "flax", "optax"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import numpy as np
import optax
import torch
from flax import traverse_util

from empanada_tpu.models import create_model as j_create_model
from empanada_tpu.train import optim as j_optim
from empanada_tpu.train.trainer import (
    finetune_trainable_mask as j_trainable_mask,
)
from empanada_torch.models import create_model
from empanada_torch.train import optim as t_optim
from empanada_torch.train.trainer import finetune_trainable_mask
from empanada_torch.weights import flax_path

SCHEDULES = [
    ("OneCycleLR", dict(max_lr=3e-3, epochs=1)),
    ("OneCycleLR", dict(max_lr=3e-4, epochs=3, pct_start=0.25,
                        div_factor=10.0, final_div_factor=100.0)),
    ("CosineAnnealingLR", dict(lr=0.01, T_max=1)),
    ("MultiStepLR", dict(lr=0.01, milestones=[0.3, 0.7], gamma=0.5)),
    ("constant", dict(lr=1e-3)),
]


@pytest.mark.parametrize("total", [2, 3, 10, 100])
@pytest.mark.parametrize("name, params", SCHEDULES)
def test_schedule_matches_jax_at_every_step(name, params, total):
    want = j_optim.create_lr_schedule(name, total, **params)
    got = t_optim.create_lr_schedule(name, total, **params)
    for step in range(3 * total + 2):
        w, g = float(want(step)), got(step)
        ulp = float(np.spacing(np.float32(w)))
        assert abs(g - w) <= max(1e-7 * abs(w), ulp), (step, g, w)


def test_one_cycle_is_not_torch_one_cycle():
    """The hand-rolled schedule peaks at pct_start * total; torch's
    OneCycleLR peaks one step earlier."""
    sched = t_optim.create_lr_schedule("OneCycleLR", 10, max_lr=1.0,
                                       epochs=1)
    assert sched(3) == pytest.approx(1.0)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0)
    torch_sched = torch.optim.lr_scheduler.OneCycleLR(opt, 1.0,
                                                      total_steps=10)
    lrs = []
    for _ in range(10):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        torch_sched.step()
    assert int(np.argmax(lrs)) == 2


@pytest.fixture(scope="module")
def tiny_params():
    model = j_create_model("PanopticBiFPNPR", encoder="regnety_200mf",
                           fpn_dim=32, fpn_layers=1)
    params = jax.eval_shape(
        lambda: model.init({"params": jax.random.key(0),
                            "points": jax.random.key(1)},
                           np.zeros((1, 128, 128, 1), np.float32),
                           train=True))["params"]
    port = create_model("PanopticBiFPNPR", device="cpu",
                        encoder="regnety_200mf", fpn_dim=32, fpn_layers=1)
    return params, list(port.named_parameters())


def test_decay_mask_on_the_same_leaves(tiny_params):
    params, named = tiny_params
    want = traverse_util.flatten_dict(j_optim.decay_mask(params))
    got = t_optim.decay_mask(named)
    assert len(got) == len(want)
    assert {flax_path(n): v for n, v in got.items()} == want
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("layer", ["all", "none", "stage1", "stage2",
                                   "stage3", "stage4"])
def test_freeze_mask_on_the_same_leaves(tiny_params, layer):
    params, named = tiny_params
    want = traverse_util.flatten_dict(j_trainable_mask(params, layer))
    got = finetune_trainable_mask(named, layer)
    assert {flax_path(n): v for n, v in got.items()} == want


def _tree(rng):
    """A small flax-named tree: a conv kernel, a conv bias, a BN's scale
    and bias, a dense kernel (decayed and exempt leaves)."""
    return {
        "Conv_0": {"kernel": rng.normal(0, 1, (3, 3, 4, 6)),
                   "bias": rng.normal(0, 1, (6,))},
        "BatchNorm_0": {"scale": 1 + 0.1 * rng.normal(0, 1, (6,)),
                        "bias": rng.normal(0, 0.1, (6,))},
        "Dense_0": {"kernel": rng.normal(0, 1, (6, 5))},
    }


def _torch_name(path):
    mods, leaf = path[:-1], path[-1]
    if leaf in ("kernel", "scale"):
        leaf = "weight"
    return ".".join(mods + (leaf,))


def _to_torch_layout(path, a):
    if path[-1] == "kernel" and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if path[-1] == "kernel" and a.ndim == 2:
        return a.T
    return a


OPTIMIZERS = [
    ("AdamW", {"weight_decay": 0.1}, None),
    ("AdamW", {"weight_decay": 0.0, "betas": (0.8, 0.99)}, None),
    ("AdamW", {"weight_decay": 0.1}, 0.5),
    ("Adam", {"weight_decay": 0.05}, None),
    ("Adam", {}, 1.0),
    ("SGD", {"momentum": 0.9, "weight_decay": 0.01}, None),
    ("SGD", {"momentum": 0.9, "nesterov": True}, 0.5),
    ("SGD", {}, None),
]


@pytest.mark.parametrize("opt_name, opt_params, grad_clip", OPTIMIZERS)
def test_optimizer_updates_match_optax(opt_name, opt_params, grad_clip):
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                  _tree(rng))
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1, a.shape).astype(np.float32), tree)
        for _ in range(5)]
    schedule_args = ("OneCycleLR", 5)
    schedule_kw = dict(max_lr=0.05, epochs=1)

    extra = {} if grad_clip is None else {"grad_clip": grad_clip}
    tx = j_optim.configure_optimizer(
        tree, opt_name, j_optim.create_lr_schedule(*schedule_args,
                                                   **schedule_kw),
        **dict(opt_params), **extra)
    params, state = tree, tx.init(tree)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)

    flat = traverse_util.flatten_dict(tree)
    tensors = {_torch_name(p): torch.nn.Parameter(torch.from_numpy(
        np.ascontiguousarray(_to_torch_layout(p, a)))) for p, a in flat.items()}
    opt = t_optim.configure_optimizer(
        list(tensors.items()), opt_name, **dict(opt_params), **extra)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, t_optim.create_lr_schedule(*schedule_args, **schedule_kw))
    for g in grads:
        for p, a in traverse_util.flatten_dict(g).items():
            tensors[_torch_name(p)].grad = torch.from_numpy(
                np.ascontiguousarray(_to_torch_layout(p, a)))
        if grad_clip:
            t_optim.clip_by_global_norm_(list(tensors.values()), grad_clip)
        opt.step()
        sched.step()

    for p, want in traverse_util.flatten_dict(params).items():
        want = _to_torch_layout(p, np.asarray(want))
        got = tensors[_torch_name(p)].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * max(np.abs(want).max(), 1),
                                   err_msg=str(p))


def test_clip_by_global_norm_has_no_epsilon():
    """Scale max_norm / norm exactly when the norm reaches max_norm, and
    leave smaller gradients untouched."""
    a = torch.nn.Parameter(torch.zeros(2))
    a.grad = torch.tensor([3.0, 4.0])
    norm = t_optim.clip_by_global_norm_([a], 1.0)
    assert float(norm) == 5.0
    assert torch.equal(a.grad, torch.tensor([0.6, 0.8]))
    a.grad = torch.tensor([0.3, 0.4])
    t_optim.clip_by_global_norm_([a], 1.0)
    assert torch.equal(a.grad, torch.tensor([0.3, 0.4]))
