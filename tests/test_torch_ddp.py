"""Port parity of data-parallel training on the CPU: two gloo processes
run one step of the tiny MitoNet on rows 0-1 and 2-3 of a global batch
of 4, from the same converted weights and the JAX draw's PointRend
points. Held, to the JAX package's own data-parallel tolerances
(``__graft_entry__._dryrun_impl``: loss rel 1e-5, gradient tree rel L2
1e-4, BN running statistics max abs 1e-4, post-AdamW parameters max abs
1e-3), against the port's one-process step on the global batch AND the
JAX package's step over a 2-device mesh (its ``Trainer``'s state and
optimizer). With stages 1-3 frozen, the frozen parameters stay bit for
bit on both ranks. The global top-k of ``bootstrap_ce`` is held on ties
across ranks at the k-th value; the train command runs over two
processes of one host each (``--coordinator``)."""

import os
import subprocess
import sys
import textwrap

import pytest

for _dep in ("jax", "flax", "optax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import numpy as np
import torch

from empanada_tpu import losses as j_losses
from empanada_tpu.parallel import create_mesh as jax_create_mesh
from empanada_tpu.parallel import shard_batch as jax_shard_batch
from empanada_tpu.train import Trainer as JaxTrainer
from empanada_tpu.train import optim as j_optim
from empanada_tpu.train.trainer import TrainState
from empanada_torch import losses
from empanada_torch.train import Trainer
from empanada_torch.weights import flax_to_torch, params_to_torch
from tests.test_multihost import _free_port
from tests.test_torch_train import (  # noqa: F401 (fixtures)
    STEPS_PER_EPOCH,
    _batch,
    _config,
    _few_threads,
    jax_model,
)
from tests.test_torch_train_fit import _fit_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
FROZEN = ("encoder_mod.stem.", "encoder_mod.stage1", "encoder_mod.stage2",
          "encoder_mod.stage3")

WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(2)
    port, rank, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]

    from empanada_torch.parallel import initialize_distributed
    initialize_distributed(f"127.0.0.1:{{port}}", 2, rank, backend="gloo")
    import torch.distributed as dist
    from empanada_torch import losses
    from empanada_torch.train import Trainer

    inputs = torch.load(f"{{workdir}}/inputs.pt", weights_only=False)
    rows = slice(rank * 2, rank * 2 + 2)
    out = {{}}
    for case, config in inputs["configs"].items():
        trainer = Trainer(config, device="cpu")
        trainer.model.load_state_dict(inputs["state"])
        trainer.init_state(inputs["steps"])
        aux = trainer.train_step(
            {{k: v[rows] for k, v in inputs["batch"].items()}},
            point_coords=inputs["coords"][rows])
        out[case] = {{
            "aux": {{k: float(v) for k, v in aux.items()}},
            "grads": {{n: p.grad.clone() for n, p in
                      trainer.model.named_parameters()
                      if p.grad is not None}},
            "state": {{k: v.clone() for k, v in
                      trainer.model.state_dict().items()}}}}

    # the global top-k on ties across ranks
    logits = inputs["tie_logits"][rows].clone().requires_grad_(True)
    loss = losses.bootstrap_ce(logits, inputs["tie_labels"][rows], 0.2,
                               gb=losses.GlobalBatch())
    loss.backward()
    out["ties"] = {{"loss": float(loss), "grad": logits.grad.clone()}}
    torch.save(out, f"{{workdir}}/rank{{rank}}.pt")
    dist.destroy_process_group()
""")


def run_ranks(script, workdir, n=2, timeout=240):
    """Start ``n`` ranks of ``script`` (argv: port, rank, workdir) and
    wait for all; fails with their standard error on a non-zero exit."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(rank), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(n)]
    errs = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=timeout)
        finally:
            proc.kill()
        if proc.returncode != 0:
            errs.append(f"rank {rank} exit {proc.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)


def _tie_inputs():
    """Binary logits (4, 1, 8, 8) whose global top 20% (k = 51) ends
    inside a run of equal losses on both ranks: 40 pixels above the tie
    value, 10 tied ones on rank 0's rows and 10 on rank 1's, of which
    the top k takes rank 0's ten and rank 1's first."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 1, (4, 1, 8, 8)).astype(np.float32)
    labels = (rng.random((4, 8, 8)) > 0.5).astype(np.float32)
    flat = logits.reshape(4, 64)
    labels.reshape(4, 64)[:] = 0
    flat[:] = -3.0
    flat[:, :10] = 4.0 + rng.random((4, 10))
    flat[:, 10:15] = 2.5
    return torch.from_numpy(logits), torch.from_numpy(labels)


def _jax_mesh_step(model, variables, batch, key):
    """The JAX Trainer's step over a 2-device mesh (its TrainState, the
    recipe's AdamW + OneCycle, its criterion; value_and_grad +
    apply_gradients jitted over the sharded global batch) from
    ``variables``. Returns loss, gradients, point coords, BN stats,
    params."""
    config = _config(batch_size=BATCH)
    trainer = JaxTrainer(config, mesh=jax_create_mesh(2))
    schedule = j_optim.create_lr_schedule(
        "OneCycleLR", STEPS_PER_EPOCH, **config["TRAIN"]["schedule_params"])
    state = TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=j_optim.configure_optimizer(
            variables["params"], "AdamW", schedule,
            **config["TRAIN"]["optimizer_params"]))
    crit = trainer.criterion

    @jax.jit
    def step(state, batch, rng):
        r_points, r_dropout = jax.random.split(rng)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                batch["image"], train=True,
                rngs={"points": r_points, "dropout": r_dropout},
                mutable=["batch_stats"])
            total, _ = crit(out, batch)
            return total, (mut["batch_stats"], out["point_coords"])

        (total, (stats, coords)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        return (total, grads, coords, stats,
                state.apply_gradients(grads=grads).params)

    sharded = jax_shard_batch(batch, trainer.mesh)
    assert len(sharded["image"].sharding.device_set) == 2
    out = jax.device_get(step(state, sharded, key))
    return float(out[0]), out[1], np.asarray(out[2]), out[3], out[4]


def _flat(tensors, names):
    return torch.cat([tensors[n].reshape(-1).double() for n in names])


def _hold(got, want, label):
    """The data-parallel tolerances between two steps' results."""
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    assert rel <= 1e-5, (label, got["loss"], want["loss"])
    names = sorted(want["grads"])
    assert sorted(got["grads"]) == names
    g, w = _flat(got["grads"], names), _flat(want["grads"], names)
    grad_rel = float((g - w).norm() / w.norm())
    assert grad_rel <= 1e-4, (label, grad_rel)
    stats = sorted(k for k in want["stats"]
                   if k.endswith(("running_mean", "running_var")))
    bn = float((_flat(got["stats"], stats)
                - _flat(want["stats"], stats)).abs().max())
    assert bn <= 1e-4, (label, bn)
    params = sorted(want["params"])
    p = float((_flat(got["params"], params)
               - _flat(want["params"], params)).abs().max())
    assert p <= 1e-3, (label, p)


def test_two_process_step_matches_one_process_and_the_jax_mesh(
        jax_model, tmp_path):
    model, variables, _ = jax_model
    batch = _batch(50, n=BATCH)
    loss, grads, coords, stats, params = _jax_mesh_step(
        model, variables, batch, jax.random.key(7))
    state = flax_to_torch(jax.tree_util.tree_map(np.asarray, variables))
    coords = torch.from_numpy(coords.copy())

    # the port's one-process step on the global batch
    trainer = Trainer(_config(batch_size=BATCH), device="cpu")
    trainer.model.load_state_dict(state)
    trainer.init_state(STEPS_PER_EPOCH)
    aux = trainer.train_step(batch, point_coords=coords)
    named = dict(trainer.model.named_parameters())
    single = {"loss": float(aux["total_loss"]),
              "grads": {n: p.grad for n, p in named.items()},
              "stats": trainer.model.state_dict(),
              "params": {n: p.detach() for n, p in named.items()}}
    jax_side = {
        "loss": loss,
        "grads": params_to_torch(jax.tree_util.tree_map(np.asarray, grads)),
        "stats": flax_to_torch({"batch_stats": jax.tree_util.tree_map(
            np.asarray, stats)}),
        "params": params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                         params))}

    tie_logits, tie_labels = _tie_inputs()
    configs = {"all": _config(batch_size=BATCH),
               "stage4": _config(batch_size=BATCH, finetune_layer="stage4")}
    torch.save({"configs": configs, "state": state, "batch": batch,
                "coords": coords, "steps": STEPS_PER_EPOCH,
                "tie_logits": tie_logits, "tie_labels": tie_labels},
               tmp_path / "inputs.pt")
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    run_ranks(script, tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]

    for r, out in enumerate(ranks):
        res = out["all"]
        dp = {"loss": res["aux"]["total_loss"], "grads": res["grads"],
              "stats": res["state"], "params": res["state"]}
        _hold(dp, single, f"rank {r} vs one process")
        _hold(dp, jax_side, f"rank {r} vs the JAX mesh")
        assert abs(res["aux"]["sem_iou"] - float(aux["sem_iou"])) <= 1e-6
    for key, value in ranks[0]["all"]["state"].items():
        assert torch.equal(value, ranks[1]["all"]["state"][key]), key

    # frozen stages: bit for bit on both ranks; the rest moved alike
    moved = 0
    for key, value in ranks[0]["stage4"]["state"].items():
        other = ranks[1]["stage4"]["state"][key]
        assert torch.equal(value, other), key
        if key in named and key.startswith(FROZEN):
            assert torch.equal(value, state[key]), key
            assert key not in ranks[0]["stage4"]["grads"], key
        elif key in named:
            moved += not torch.equal(value, state[key])
    assert moved > 0

    # the global top-k with ties across ranks == lax.top_k's split
    want_loss, want_grad = jax.value_and_grad(
        lambda x: j_losses.bootstrap_ce(x, tie_labels.numpy(), 0.2))(
        tie_logits.numpy().transpose(0, 2, 3, 1))
    got_grad = torch.cat([ranks[r]["ties"]["grad"] for r in range(2)])
    for r in range(2):
        assert abs(ranks[r]["ties"]["loss"] - float(want_loss)) \
            <= 1e-6 * abs(float(want_loss))
    # DDP averages the ranks' gradients: each rank's is world x its part
    np.testing.assert_allclose(
        got_grad.numpy() / 2, np.asarray(want_grad).transpose(0, 3, 1, 2),
        rtol=1e-6, atol=1e-9)


def test_world_one_bootstrap_is_the_one_process_loss():
    """Without a GlobalBatch the loss is the one-process formula, bit for
    bit: the mean of torch.topk's k largest pixel losses."""
    logits, labels = _tie_inputs()
    pixel = torch.nn.functional.binary_cross_entropy_with_logits(
        logits[:, 0], labels, reduction="none").reshape(-1)
    want = torch.topk(pixel, int(0.2 * pixel.numel()), sorted=False) \
        .values.mean()
    assert torch.equal(losses.bootstrap_ce(logits, labels, 0.2), want)
    assert losses.PanopticLoss.global_batch is None


def test_batch_must_divide_over_the_ranks(monkeypatch):
    from empanada_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "world", lambda: (3, 0))
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        Trainer(_config(batch_size=BATCH), device="cpu")


def test_train_command_over_two_hosts(tmp_path):
    """``train --coordinator --num-processes 2 --process-id i --device
    cpu``, two processes: one step of the global batch of 4, one
    checkpoint, written by rank 0."""
    import yaml

    cfg = _fit_config(tmp_path)
    cfg["EVAL"]["epochs_per_eval"] = 0
    cfg["TRAIN"].update(batch_size=4)
    cfg["TRAIN"]["schedule_params"]["epochs"] = 1
    with open(tmp_path / "train.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "empanada_torch", "train",
         str(tmp_path / "train.yaml"), "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(i), "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=240))
        finally:
            proc.kill()
        assert proc.returncode == 0, outs[-1][1][-3000:]
    assert "Epoch [0][1/1]" in outs[0][0] and "Epoch" not in outs[1][0]
    assert outs[0][0].count("=> saved checkpoint") == 1
    assert "saved checkpoint" not in outs[1][0]
    assert sorted(os.listdir(tmp_path / "models")) == [
        "tiny_checkpoint.pth", "tiny_checkpoint.pth.json"]
