"""Port parity of training: one optimizer step of the tiny MitoNet
(PanopticBiFPNPR on regnety_200mf, fpn_layers 1, batch 2 x 128^2) from
the same converted weights, batch and PointRend points gives the JAX
package's loss, gradients, updated parameters, AdamW moments and
batch-norm running statistics; three steps with finetune_layer stage4
leave the frozen leaves untouched in both packages while their BN
statistics move; and the training init has JAX's per-leaf statistics.

Tolerances (float32 on both sides, different convolution summation
orders): loss 1e-5 relative; the gradient tree 1e-5 relative in L2 norm
and each gradient leaf 1e-4 of max(its max |value|, 5% of the tree's
largest leaf max), the Adam moments as the gradient they scale (mu / 0.1
and sqrt(nu / 0.001)); parameters 1e-5 of each leaf's max |value| (at
least 1e-5 absolute); the BN running statistics, which are statistics of
the forward's activations, at the forward's tolerance (1e-4 of each
leaf's max |value|, as in test_torch_models.py: the float32 forward
drifts to 2.5e-5 of max |value| at stage 4).

Why the floors: (1) leaves whose gradient is 1e-4 of the tree's scale
carry absolute float32 error of the tree's scale, hence the 5% floor;
(2) AdamW's first steps move each element by about lr * sign(g), so an
element whose |g| is within the gradient tolerance of 0 (many are float
noise: with the ReLUs on, each bottleneck's last BN bias feeds only
batch-normed consumers, so its exact gradient is 0) may move either way:
such elements are held to 2 lr per step instead of 1e-5."""

import pytest

for _dep in ("jax", "flax", "optax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import numpy as np
import optax
import torch
from flax import traverse_util

from empanada_tpu import losses as j_losses
from empanada_tpu.models import create_model as j_create_model
from empanada_tpu.train import optim as j_optim
from empanada_tpu.train.trainer import _freeze_wrap
from empanada_tpu.train.trainer import (
    finetune_trainable_mask as j_trainable_mask,
)
from empanada_torch.data.utils.target_creation import heatmap_and_offsets
from empanada_torch.models import create_model
from empanada_torch.train import Trainer
from empanada_torch.weights import flax_path, flax_to_torch, params_to_torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this module: the suite runs six pytest
    workers on the machine's cores, and torch's default (one thread a
    core in every worker) makes their spinning threads starve each
    other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

TINY = dict(arch="PanopticBiFPNPR", encoder="regnety_200mf", num_classes=1,
            fpn_dim=64, fpn_layers=1, train_num_points=64,
            subdivision_num_points=256)
STEPS_PER_EPOCH = 10


def _config(**train):
    tcfg = {"batch_size": 2, "schedule_params": {"max_lr": 3e-3,
                                                 "epochs": 1},
            "optimizer": "AdamW", "optimizer_params": {"weight_decay": 0.1},
            "criterion_params": {"ce_weight": 1, "mse_weight": 200,
                                 "l1_weight": 0.01, "top_k_percent": 0.2,
                                 "pr_weight": 1}}
    tcfg.update(train)
    return {"DATASET": {"labels": [1], "thing_list": [1],
                        "class_names": {1: "mito"},
                        "norms": {"mean": 0.5, "std": 0.15}},
            "MODEL": dict(TINY), "TRAIN": tcfg}


def _randomize(variables, seed):
    """Seeded values of realistic scale for every leaf (the flax init
    leaves many gradients exactly zero: zero-init residual BN). Batch
    norm shifts the normalized activations by +1 +- 0.1 at a scale of
    0.5, so that almost no pre-activation lies within float32 rounding
    of the ReLU kink: at 4 x 4 pixels per stage-4 map one sign flip moves
    a channel's gradient by 1/32, which would make a per-leaf gradient
    comparison a test of rounding luck instead of the math."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, a in traverse_util.flatten_dict(
            jax.tree_util.tree_map(np.asarray, variables)).items():
        leaf = path[-1]
        in_bn = any(p.startswith("BatchNorm_") for p in path)
        if leaf == "var":
            v = 1 + 0.2 * rng.random(a.shape)
        elif leaf == "kernel":
            v = rng.normal(0, 1, a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf == "scale":
            v = 0.5 + 0.05 * rng.normal(0, 1, a.shape)
        elif leaf == "bias" and in_bn:
            v = 1 + 0.1 * rng.normal(0, 1, a.shape)
        elif leaf == "fusion_weights":
            v = 1 + 0.1 * rng.normal(0, 1, a.shape)
        else:
            v = 0.1 * rng.normal(0, 1, a.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def _batch(seed, n=2, size=128):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    image = rng.normal(0, 1, (n, size, size, 1)).astype(np.float32)
    masks = np.zeros((n, size, size), np.int64)
    for b in range(n):
        for k in range(1, 7):
            cy, cx = rng.uniform(0, size, 2)
            r = rng.uniform(6, 18)
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            masks[b][inside] = k
            image[b][inside] += 1.5
    hm, off = zip(*(heatmap_and_offsets(m) for m in masks))
    return {"image": image, "sem": (masks > 0).astype(np.float32),
            "ctr_hmp": np.stack(hm), "offsets": np.stack(off)}


@pytest.fixture(scope="module")
def jax_model():
    """(flax model, randomized variables, the train-mode init)."""
    model = j_create_model(TINY["arch"], **{k: v for k, v in TINY.items()
                                            if k != "arch"})
    # jitted: the eager init takes half a minute
    init = jax.jit(lambda rngs, x: model.init(rngs, x, train=True))(
        {"params": jax.random.key(0), "points": jax.random.key(1),
         "dropout": jax.random.key(2)},
        np.zeros((1, 128, 128, 1), np.float32))
    return model, _randomize(init, seed=3), init


def _jax_steps(model, variables, batches, finetune_layer="all"):
    """The JAX package's train step (flax apply in train mode, its
    PanopticLoss, its AdamW + OneCycle chain) over ``batches``; returns
    per step (loss, grads, point coords) and the final params, batch
    stats and optimizer state."""
    crit = j_losses.create_loss("PanopticLoss", **_config()["TRAIN"][
        "criterion_params"])
    schedule = j_optim.create_lr_schedule("OneCycleLR", STEPS_PER_EPOCH,
                                          max_lr=3e-3, epochs=1)
    params = variables["params"]
    tx = j_optim.configure_optimizer(params, "AdamW", schedule,
                                     weight_decay=0.1)
    if finetune_layer != "all":
        tx = _freeze_wrap(tx, j_trainable_mask(params, finetune_layer))
    opt_state = tx.init(params)

    @jax.jit
    def step(params, stats, opt_state, batch, key):
        def loss_fn(p):
            out, mut = model.apply(
                {"params": p, "batch_stats": stats}, batch["image"],
                train=True, rngs={"points": key, "dropout": key},
                mutable=["batch_stats"])
            total, _ = crit(out, batch)
            return total, (mut["batch_stats"], out["point_coords"])

        (total, (stats, coords)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), stats, opt_state,
                total, grads, coords)

    stats = variables["batch_stats"]
    per_step = []
    for i, batch in enumerate(batches):
        params, stats, opt_state, total, grads, coords = step(
            params, stats, opt_state, batch, jax.random.key(10 + i))
        per_step.append((float(total), grads, np.asarray(coords)))
    return per_step, params, stats, opt_state


def _port_trainer(variables, finetune_layer="all"):
    trainer = Trainer(_config(finetune_layer=finetune_layer), device="cpu")
    trainer.init_state(STEPS_PER_EPOCH)
    trainer.model.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), expect=trainer.model))
    return trainer


def _grad_tol(grads):
    """{name: the gradient tolerance of the leaf}."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {n: 1e-4 * max(float(g.abs().max()), 0.05 * top)
            for n, g in grads.items()}


def _params_close(got, want, grads_per_step, lrs, name):
    """Parameters after len(lrs) AdamW steps: 1e-5 of the leaf's scale,
    2 lr per step where a step's gradient sign is not determined."""
    ambiguous = np.zeros(want.shape, bool)
    for grads in grads_per_step:
        ambiguous |= grads[name].abs().numpy() <= _grad_tol(grads)[name]
    atol = np.where(ambiguous, 2 * sum(lrs), 0.0) \
        + 1e-5 * max(float(want.abs().max()), 1.0)
    diff = np.abs(got.numpy() - want.numpy())
    assert (diff <= atol).all(), (name, float(diff.max()))


def _close(got, want, rel, label):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=label)


def _adam_state(opt_state):
    """The ScaleByAdamState (mu, nu) inside the optax chain."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


def test_one_train_step_matches_jax(jax_model):
    model, variables, _ = jax_model
    batch = _batch(20)
    per_step, params, stats, opt_state = _jax_steps(model, variables,
                                                    [batch])
    (loss, grads, coords), = per_step

    trainer = _port_trainer(variables)
    aux = trainer.train_step(batch, point_coords=torch.from_numpy(coords))
    got_loss = float(aux["total_loss"])
    assert abs(got_loss - loss) <= 1e-5 * abs(loss), (got_loss, loss)

    named = dict(trainer.model.named_parameters())
    want_grads = params_to_torch(jax.tree_util.tree_map(np.asarray, grads))
    assert set(want_grads) == set(named)
    top = max(float(g.abs().max()) for g in want_grads.values())
    num = sum(float((named[n].grad - g).square().sum())
              for n, g in want_grads.items())
    den = sum(float(g.square().sum()) for g in want_grads.values())
    assert (num / den) ** 0.5 <= 1e-5, (num / den) ** 0.5
    for name, g in want_grads.items():
        scale = max(float(g.abs().max()), 0.05 * top)
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)

    want_params = params_to_torch(jax.tree_util.tree_map(np.asarray, params))
    adam = _adam_state(opt_state)
    mu = params_to_torch(jax.tree_util.tree_map(np.asarray, adam.mu))
    nu = params_to_torch(jax.tree_util.tree_map(np.asarray, adam.nu))
    state = trainer.optimizer.state
    for name, p in named.items():
        _params_close(p.detach(), want_params[name], [want_grads],
                      [trainer.lr_schedule(0)], name)
        # the moments are the gradient scaled, (1 - b1) g and
        # (1 - b2) g^2: held to the gradient's tolerance
        scale = max(float(want_grads[name].abs().max()), 0.05 * top)
        np.testing.assert_allclose(
            state[p]["exp_avg"].numpy() / 0.1, mu[name].numpy() / 0.1,
            rtol=0, atol=1e-4 * scale, err_msg=f"{name} mu")
        np.testing.assert_allclose(
            np.sqrt(state[p]["exp_avg_sq"].numpy() / 0.001),
            np.sqrt(nu[name].numpy() / 0.001), rtol=0, atol=1e-4 * scale,
            err_msg=f"{name} nu")

    want_stats = flax_to_torch({"batch_stats": jax.tree_util.tree_map(
        np.asarray, stats)})
    buffers = dict(trainer.model.named_buffers())
    moved = 0
    for key, v in want_stats.items():
        if key.endswith(("running_mean", "running_var")):
            _close(buffers[key], v, 1e-4, key)
            moved += 1
    assert moved == sum(k.endswith(("running_mean", "running_var"))
                        for k in buffers)


def test_finetune_stage4_freezes_the_same_leaves(jax_model):
    """Three steps with finetune_layer stage4: the frozen leaves (stem,
    stages 1-3) keep their values in both packages, every other leaf
    moves (to the JAX package's values within the steps' rates), and the
    frozen stages' BN statistics move."""
    model, variables, _ = jax_model
    batches = [_batch(30 + i) for i in range(3)]
    per_step, params, stats, _ = _jax_steps(model, variables, batches,
                                            "stage4")
    trainer = _port_trainer(variables, "stage4")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for batch, (loss, _, coords) in zip(batches, per_step):
        aux = trainer.train_step(batch,
                                 point_coords=torch.from_numpy(coords))
        assert abs(float(aux["total_loss"]) - loss) <= 1e-5 * abs(loss)

    # after the first step the trajectories part by the elements whose
    # update sign float noise decides, so three steps agree to the sum
    # of the steps' rates, not to 1e-5
    drift = 2 * sum(trainer.lr_schedule(i) for i in range(3))
    j_mask = traverse_util.flatten_dict(
        j_trainable_mask(variables["params"], "stage4"))
    start = params_to_torch(jax.tree_util.tree_map(
        np.asarray, variables["params"]))
    end = params_to_torch(jax.tree_util.tree_map(np.asarray, params))
    after = trainer.model.state_dict()
    frozen = 0
    for name, p in trainer.model.named_parameters():
        trainable = j_mask[flax_path(name)]
        assert p.requires_grad == trainable, name
        if trainable:
            assert not torch.equal(after[name], before[name]), name
            _close(after[name], end[name], drift, name)
        else:
            frozen += 1
            assert torch.equal(end[name], start[name]), name
            assert torch.equal(after[name], before[name]), name
    assert frozen > 0
    frozen_stats = [k for k in after if k.endswith("running_var")
                    and k.startswith("encoder_mod.stage1")]
    assert frozen_stats and all(not torch.equal(after[k], before[k])
                                for k in frozen_stats)


def test_train_init_matches_jax_statistics(jax_model):
    """init_train_ gives each leaf the JAX init's distribution: zero
    leaves exactly zero, constant leaves equal, and the std of every
    random leaf of at least 256 values within 10% of JAX's."""
    _, _, init = jax_model
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(init)))
    port = create_model(TINY["arch"], device="cpu", seed=0, init="train",
                        **{k: v for k, v in TINY.items() if k != "arch"})
    got = port.state_dict()
    n_random = 0
    for key, w in want.items():
        g = got[key]
        if not w.is_floating_point():
            continue
        w_std = float(w.std()) if w.numel() > 1 else 0.0
        if w_std == 0.0:
            assert torch.equal(g, w), key
        elif w.numel() >= 256:
            n_random += 1
            assert abs(float(g.std()) / w_std - 1) < 0.1, key
            assert abs(float(g.mean())) < 0.2 * w_std + 1e-6, key
    assert n_random > 20
