"""Training checkpoint save / resume.

A checkpoint is one ``torch.save`` file holding the model's state dict,
the optimizer's and the LR schedule's state, the optimizer step and the
epoch, written atomically (a temporary file, then ``os.replace``), with
a JSON sidecar ``<path>.json`` of metadata (epoch, arch, norms,
model_config, run_id: the JAX package's keys).
"""

from __future__ import annotations

import json
import os

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "restore_state"]


def save_checkpoint(path, state, metadata=None):
    """``state``: a dict of state dicts and numbers; tensors are saved
    from the CPU."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu()
        if isinstance(obj, dict):
            return {k: cpu(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(cpu(v) for v in obj)
        return obj

    tmp = path + ".tmp"
    torch.save(cpu(state), tmp)
    os.replace(tmp, path)
    if metadata is not None:
        tmp = path + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump(metadata, f, indent=2, default=str)
        os.replace(tmp, path + ".json")


def load_checkpoint(path):
    """Returns (state, metadata) with tensors on the CPU."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta


def restore_state(path, model, optimizer=None, scheduler=None):
    """Load a checkpoint into the model (and optimizer / schedule when
    given, moving the optimizer's state to the parameters' device).
    Returns (step, metadata)."""
    state, meta = load_checkpoint(path)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(state["scheduler"])
    meta.setdefault("epoch", state.get("epoch", 0))
    return int(state.get("step", 0)), meta
