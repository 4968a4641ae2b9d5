"""Device meshes and process groups.

The JAX package runs one SPMD program over a ``data`` mesh. The port
keeps torch's explicit idiom instead:

- inference: a ``Mesh`` is an ordered tuple of devices; the engine holds
  one replica of the weights per device (``replicate``) and splits each
  block of slices into contiguous per-device chunks (``shard_batch``);
- training: one process per card, joined by ``initialize_distributed``
  (NCCL when the process owns a card, gloo on the CPU), the model
  wrapped in ``DistributedDataParallel`` by the trainer.
"""

from __future__ import annotations

import copy
import os

import torch

__all__ = ["Mesh", "create_mesh", "shard_batch", "replicate",
           "initialize_distributed", "world"]


class Mesh:
    """An ordered tuple of devices along one named axis."""

    def __init__(self, devices, axis_name="data"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name

    @property
    def size(self):
        return len(self.devices)


def create_mesh(n_devices=None, axis_name="data", devices=None):
    """A mesh over the first ``n_devices`` visible cards (all of them by
    default), or over ``devices`` as given (e.g. ``[torch.device("cpu")]
    * 2``). Raises without a card when no devices are named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: name the mesh's devices (e.g. "
                "devices=[torch.device('cpu')] * 2) to run on the CPU")
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"{n} devices asked for, {count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(devices, axis_name)


def shard_batch(batch, mesh):
    """Split the leading axis of a tensor (or of each tensor of a dict)
    into ``mesh.size`` contiguous chunks, chunk i moved to device i.
    The batch must divide by the mesh size, as DDP's per-rank batches
    do. Returns a list (of dicts) by device."""
    if isinstance(batch, dict):
        parts = {k: shard_batch(v, mesh) for k, v in batch.items()}
        return [{k: parts[k][i] for k in batch} for i in range(mesh.size)]
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch of {n} does not divide over the "
                         f"{mesh.size}-device mesh")
    per = n // mesh.size
    return [batch[i * per:(i + 1) * per].to(d, non_blocking=True)
            for i, d in enumerate(mesh.devices)]


def replicate(module, mesh):
    """One copy of ``module`` per device of the mesh, made once; devices
    named twice share their copy. The first device gets ``module``
    itself (moved there)."""
    copies = {}
    out = []
    for d in mesh.devices:
        if d not in copies:
            copies[d] = module.to(d) if not copies \
                else copy.deepcopy(module).to(d)
        out.append(copies[d])
    return out


def world():
    """(world size, rank) of the default process group; (1, 0) when no
    group is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None):
    """Join the default process group at ``tcp://coordinator_address``
    as rank ``process_id`` of ``num_processes``. A no-op for one process
    or fewer. The backend is NCCL when this process owns a card
    (``cuda:LOCAL_RANK``, LOCAL_RANK as torch's launchers set it and 0
    by default, becomes its current device before any CUDA work), gloo
    otherwise; ``backend`` overrides it (gloo on one card holds several
    ranks, which NCCL refuses)."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need coordinator_address and "
                         "process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
