"""Host-level collectives for multi-process pipelines.

Objects are pickled through ``torch.distributed``'s object collectives
over a gloo group, even when the default group is NCCL: the reference's
gloo side group for pickled results (reference
inference3d_multigpu.py:78-171, patterns.py:226-240). At world size 1
each function returns its input without touching ``torch.distributed``.
"""

from __future__ import annotations

import numpy as np

from empanada_torch.parallel.mesh import world

__all__ = ["all_gather_arrays", "all_gather_objects", "broadcast_object",
           "object_group"]

_GLOO = {"world": None, "group": None}


def object_group():
    """The gloo group the object collectives run over: the default group
    when it is gloo, else one gloo group over the same ranks, made once
    for each default group (every rank must call this, as any group
    creation)."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    if _GLOO["world"] is not dist.group.WORLD:
        _GLOO["group"] = dist.new_group(backend="gloo")
        _GLOO["world"] = dist.group.WORLD
    return _GLOO["group"]


def all_gather_objects(obj):
    """Gather a picklable object from every process: a list by rank."""
    import torch.distributed as dist

    size, _ = world()
    if size == 1:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj, group=object_group())
    return out


def all_gather_arrays(array):
    """Gather a numpy array from every process: a list by rank."""
    return [np.asarray(a) for a in all_gather_objects(np.asarray(array))]


def broadcast_object(obj, root=0):
    """The root process's object, on every process."""
    import torch.distributed as dist

    size, _ = world()
    if size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root, group=object_group())
    return box[0]
