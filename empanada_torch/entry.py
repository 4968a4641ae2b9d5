"""The port's counterpart of the JAX package's root ``__graft_entry__.py``.

- ``entry()``: the single-card eval forward of the flagship model
  (MitoNet = ``PanopticBiFPNPR`` on ``regnety_6p4gf``) as
  ``fn(params, image)``, the parameters and buffers an argument as the
  flax ``variables`` are (``torch.func.functional_call``), with its
  example arguments on the device, float32 with TF32 off.
- ``dryrun_multichip(n)``: two checks over n ranks and n replicas.
  (1) Training: one step of the tiny MitoNet recipe at world n through
  the data-parallel ``Trainer`` (``DistributedDataParallel``, batch norm
  and the loss over the global batch) against one process's step on the
  same global batch, held to the JAX package's data-parallel tolerances
  (``DDP_TOL``: loss, gradients, batch-norm statistics, post-AdamW
  parameters). (2) Inference: the orthoplane composition (fused blocked
  engine, matching, consensus) with the mesh-sharded engine against the
  run without a mesh, RLE for RLE.

Devices: with n cards visible, one rank and one replica a card over
NCCL; with fewer, the ranks share the cards over gloo and the replicas
repeat them; with ``device="cpu"``, gloo ranks and a CPU mesh of n.
A failed check raises.

    python -m empanada_torch.entry [n] [--device cpu]

runs ``dryrun_multichip(n)`` (n: every visible card by default) and
exits non-zero on a failed check.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from empanada_torch.device import resolve_device
from empanada_torch.export import FORWARD_KW

__all__ = ["entry", "dryrun_multichip", "DDP_TOL", "compare_steps",
           "step_record"]

# the JAX package's data-parallel tolerances (__graft_entry__._dryrun_impl):
# loss relative, gradient relative L2, batch-norm statistics max abs,
# post-AdamW parameters max abs (Adam's g/sqrt(v) may flip sign where |g|
# is at rounding level, bounding that coordinate's step by 2 lr)
DDP_TOL = {"loss_rel": 1e-5, "grad_rel_l2": 1e-4, "bn_abs": 1e-4,
           "param_abs": 1e-3}
DRYRUN_SIDE = 128


def _flagship(tiny=False, device=None):
    """(model, image): MitoNet at full width from the port's seeded init
    and a (1, 1, 256, 256) zero image, or with ``tiny`` the narrow
    MitoNet the tests use (``regnety_200mf``, one BiFPN layer) and a
    128² image; on the card unless ``device`` names another."""
    from empanada_torch.models import create_model

    device = resolve_device(device)
    kwargs = dict(num_classes=1)
    if tiny:
        kwargs.update(encoder="regnety_200mf", fpn_layers=1,
                      train_num_points=16, subdivision_num_points=32)
        size = 128
    else:
        kwargs.update(encoder="regnety_6p4gf")
        size = 256
    model = create_model("PanopticBiFPNPR", device=device, seed=0, **kwargs)
    image = torch.zeros((1, 1, size, size), dtype=torch.float32,
                        device=device)
    return model, image


def eval_forward(model):
    """``fn(params, image)``: ``model``'s eval forward (two PointRend
    steps, coarse instance maps) with ``params`` (its parameters and
    buffers by name) in place of its own."""
    def fn(params, image):
        return torch.func.functional_call(model, params, (image,),
                                          FORWARD_KW)

    return fn


def entry(device=None):
    """(fn, example_args): ``fn(params, image)`` the flagship's eval
    forward, ``example_args`` its parameters and buffers and a
    (1, 1, 256, 256) image, on the card unless ``device`` names
    another."""
    model, image = _flagship(device=device)
    params = {name: t.detach() for name, t in
              [*model.named_parameters(), *model.named_buffers()]}
    return eval_forward(model), (params, image)


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

def _dryrun_config(n):
    """The JAX dry run's recipe: the tiny MitoNet, OneCycle, AdamW with
    weight decay 0.1, PanopticLoss, a global batch of n, nothing
    frozen."""
    return {
        "DATASET": {"class_names": {1: "mito"}, "labels": [1],
                    "thing_list": [1],
                    "norms": {"mean": 0.5, "std": 0.15}},
        "MODEL": {"arch": "PanopticBiFPNPR", "encoder": "regnety_200mf",
                  "fpn_layers": 1, "num_classes": 1,
                  "train_num_points": 16, "subdivision_num_points": 32},
        "TRAIN": {
            "lr_schedule": "OneCycleLR",
            "schedule_params": {"max_lr": 3e-3, "epochs": 1},
            "optimizer": "AdamW", "optimizer_params": {"weight_decay": 0.1},
            "criterion": "PanopticLoss", "criterion_params": {},
            "batch_size": n, "finetune_layer": "all",
        },
    }


def _dryrun_batch(n, size=DRYRUN_SIDE):
    """The JAX dry run's seeded global batch (NHWC, as collated)."""
    rng = np.random.default_rng(0)
    return {
        "image": rng.normal(0, 1, (n, size, size, 1)).astype(np.float32),
        "sem": (rng.random((n, size, size)) > 0.5).astype(np.float32),
        "ctr_hmp": rng.random((n, size, size, 1)).astype(np.float32),
        "offsets": rng.normal(0, 4, (n, size, size, 2)).astype(np.float32),
    }


def step_record(trainer, aux):
    """Loss, trainable gradients, parameters and batch-norm statistics of
    a trainer after its step, on the host."""
    return {"loss": float(aux["total_loss"]),
            "grads": {n: p.grad.detach().cpu() for n, p in
                      trainer.model.named_parameters() if p.grad is not None},
            "state": {k: v.detach().cpu() for k, v in
                      trainer.model.state_dict().items()}}


def compare_steps(got, want):
    """The data-parallel tolerances between two step records: (numbers
    by ``DDP_TOL`` key, ok). Not ok where a number exceeds its tolerance
    or is NaN, or where the two records' trainable parameters differ."""
    names = sorted(want["grads"])
    g = torch.cat([got["grads"][n].reshape(-1).double() for n in names])
    w = torch.cat([want["grads"][n].reshape(-1).double() for n in names])
    stats = [k for k in want["state"]
             if k.endswith(("running_mean", "running_var"))]
    nums = {
        "loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        "grad_rel_l2": float((g - w).norm() / w.norm()),
        "bn_abs": max(float((got["state"][k] - want["state"][k]).abs().max())
                      for k in stats),
        "param_abs": max(float((got["state"][k] - want["state"][k])
                               .abs().max()) for k in names)}
    ok = sorted(got["grads"]) == names and all(
        nums[k] <= DDP_TOL[k] for k in DDP_TOL)
    return nums, ok


def _train_step(config, batch, device):
    """One step of a fresh seeded Trainer on ``batch`` (this process's
    rows of the global batch): its step record."""
    from empanada_torch.train import Trainer

    trainer = Trainer(config, device=device, seed=0)
    trainer.init_state(steps_per_epoch=1)
    return step_record(trainer, trainer.train_step(batch))


def _dryrun_rank(rank, n, devices, backend, address, out, threads):
    """Rank ``rank`` of the world-n step: its row of the global batch on
    ``devices[rank]``; rank 0 writes the step record to ``out``."""
    import torch.distributed as dist

    from empanada_torch.parallel import initialize_distributed

    device = devices[rank]
    if device.type == "cuda":
        os.environ["LOCAL_RANK"] = str(device.index)
    else:
        torch.set_num_threads(threads)
    initialize_distributed(address, n, rank, backend=backend)
    try:
        batch = {k: v[rank:rank + 1] for k, v in _dryrun_batch(n).items()}
        record = _train_step(_dryrun_config(n), batch, device)
        if rank == 0:
            torch.save(record, out)
    finally:
        dist.destroy_process_group()


def _layout(n, device):
    """(devices by rank and replica, backend): a card each over NCCL where
    n cards are visible, else the ranks share the cards over gloo; on the
    CPU, n gloo ranks; at world 1 one process and no group (None)."""
    if device.type != "cuda":
        devices, backend = [device] * n, "gloo"
    else:
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n)]
        backend = "nccl" if count >= n else "gloo"
    return devices, backend if n > 1 else None


def _dryrun_train(n, devices, backend):
    """The world-n step against one process's step on the same global
    batch: the numbers beside ``DDP_TOL``; raises beyond them."""
    config = _dryrun_config(n)
    single = _train_step(config, _dryrun_batch(n), devices[0])
    if n == 1:
        dp = _train_step(config, _dryrun_batch(n), devices[0])
    else:
        import torch.multiprocessing as mp

        from empanada_torch.cli.train import _free_port

        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "step.pt")
            threads = max(1, torch.get_num_threads() // n)
            mp.start_processes(
                _dryrun_rank, nprocs=n, join=True, start_method="spawn",
                args=(n, devices, backend, f"127.0.0.1:{_free_port()}", out,
                      threads))
            dp = torch.load(out, weights_only=True)
    nums, ok = compare_steps(dp, single)
    print(f"dryrun_multichip({n}): train step at world {n} vs one process "
          f"on the same global batch ({n} x {DRYRUN_SIDE}², float32): loss "
          f"{dp['loss']:.6f}; " + ", ".join(
              f"{k} {v:.3e} (tol {DDP_TOL[k]:.0e})" for k, v in nums.items()))
    if not ok:
        raise RuntimeError(
            f"dryrun_multichip({n}): the world-{n} step differs from one "
            f"process's beyond {DDP_TOL}: {nums}")
    return dict(nums, loss=dp["loss"])


def _ellipsoid():
    """The JAX dry run's (12, 32, 32) ellipsoid volume."""
    zz, yy, xx = np.mgrid[:12, :32, :32]
    return (((zz - 6.0) ** 2 / 16 + (yy - 15.0) ** 2 / 64
             + (xx - 16.0) ** 2 / 49) <= 1.0).astype(np.float32)


def _dryrun_inference(n, devices):
    """The orthoplane consensus of the parameter-free synthetic model
    over a mesh of ``devices`` against the run on ``devices[0]`` without
    a mesh, at the same block (2n slices, divisible over the mesh):
    labels, boxes, starts and runs equal, at least one instance. Returns
    the mesh run's instances; raises on a difference."""
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.parallel import create_mesh
    from empanada_torch.synthetic import SyntheticModule

    vol = _ellipsoid()
    kwargs = dict(labels=[1], thing_list=[1], mode="orthoplane", qlen=3,
                  label_divisor=100, block_size=2 * n, padding_factor=16,
                  max_centers=64, min_size=4, min_span=1, pixel_vote_thr=2,
                  progress=False)
    single = run_inference3d((SyntheticModule(), None), vol,
                             device=devices[0], **kwargs)[1].instances
    meshed = run_inference3d((SyntheticModule(), None), vol,
                             mesh=create_mesh(devices=devices),
                             **kwargs)[1].instances
    if not single:
        raise RuntimeError(f"dryrun_multichip({n}): the run without a mesh "
                           f"found no instance")
    same = list(single) == list(meshed) and all(
        tuple(single[k]["box"]) == tuple(meshed[k]["box"])
        and np.array_equal(single[k]["starts"], meshed[k]["starts"])
        and np.array_equal(single[k]["runs"], meshed[k]["runs"])
        for k in single)
    if not same:
        raise RuntimeError(f"dryrun_multichip({n}): the mesh consensus "
                           f"differs from the run without a mesh")
    print(f"dryrun_multichip({n}): inference OK ({n}-replica orthoplane "
          f"consensus == one device's, {len(single)} instance(s), exact "
          f"RLE equality)")
    return meshed


def dryrun_multichip(n, device=None):
    """The two checks of the module's docstring at world n, on the cards
    unless ``device`` is "cpu". Returns {"world", "backend" (None at
    world 1), "devices",
    "train" (the numbers beside DDP_TOL and the loss), "instances" (the
    mesh run's consensus)}; raises on a failed check."""
    n = int(n)
    if n < 1:
        raise ValueError(f"dryrun_multichip needs n >= 1, got {n}")
    device = resolve_device(device)  # TF32 off too
    devices, backend = _layout(n, device)
    names = sorted({str(d) for d in devices})
    how = "one rank and one replica a card" if backend != "gloo" \
        else f"{n} ranks and {n} replicas sharing"
    print(f"dryrun_multichip({n}): {how} {', '.join(names)}, ranks over "
          f"{backend or 'no group (world 1)'}")
    train = _dryrun_train(n, devices, backend)
    instances = _dryrun_inference(n, devices)
    return {"world": n, "backend": backend, "devices": devices,
            "train": train, "instances": instances}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="dryrun_multichip(n): the data-parallel step and the "
                    "mesh-sharded orthoplane consensus at world n, each "
                    "against one device's")
    parser.add_argument("n", nargs="?", type=int, default=None,
                        help="ranks and replicas (default: every visible "
                             "card)")
    parser.add_argument("--device", default=None,
                        help="'cpu' runs on the CPU (n gloo ranks, a CPU "
                             "mesh of n); the cards otherwise")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    n = args.n
    if n is None:
        if device.type != "cuda":
            parser.error("name n on the CPU")
        n = torch.cuda.device_count()
    dryrun_multichip(n, device=device)


if __name__ == "__main__":
    main()
