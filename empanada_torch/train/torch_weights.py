"""Weights from the reference's torch ecosystem (CEM pretrained encoders,
MitoNet's published TorchScript weights) into the port's modules, and
back.

The reference's modules and the port's do not share parameter names, so
tensors are paired by *structural order*: both register their conv and
batch-norm tensors in the same definition order, so the i-th reference
tensor of a kind (conv kernels, conv biases, BN scales, BN biases, BN
means, BN variances, BiFPN fusion weights, Conv1d kernels) goes to the
i-th tensor of that kind in the port, shape-checked. This is the JAX
package's ``train/torch_weights.py`` with the port in the place of the
flax tree:

- the port's sequence of leaves is its own ``named_parameters()`` and
  ``named_buffers()`` named as flax names them (``weights.flax_path``;
  ``running_mean`` / ``running_var`` are flax's ``mean`` / ``var``). The
  port registers its children in the order flax traces them, so the
  sequence is flax's, and it goes through the same reshuffle into the
  reference's registration order (``_registration_order``);
- layouts: the reference and the port are both torch, so conv and
  transposed-conv kernels carry over as they are; a reference Conv1d
  kernel (out, in, 1) is the port's Linear weight (out, in).

The JAX package's ``reorder_like`` has no counterpart: it repairs flax
trees whose keys came back sorted from serialization, and the port's
order always comes from the module.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

from empanada_torch.weights import flax_path

__all__ = ["load_torch_state_dict", "convert_reference_state_dict",
           "convert_to_reference_state_dict", "load_encoder_pretraining"]

_QUEUES = ("kernel", "conv_bias", "scale", "bn_bias", "mean", "var",
           "fusion", "kernel1d")


def _is_torchscript_archive(path):
    """True if ``path`` is a TorchScript zip (torch.jit.save): those hold
    a ``constants.pkl`` + ``code/`` tree instead of torch.save's
    ``data.pkl``. MitoNet's published weights are this format (reference
    scripts/pdl_inference3d.py:69-74 loads them with torch.jit.load)."""
    if not zipfile.is_zipfile(path):
        return False
    try:
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
    except (OSError, zipfile.BadZipFile):
        return False
    return any(n.endswith("constants.pkl") for n in names)


def load_torch_state_dict(path):
    """Load a reference torch checkpoint on the CPU; returns
    (state_dict, norms).

    Accepts plain ``torch.save`` checkpoints (a state dict, or a dict
    with a ``state_dict`` key and optional ``norms``: the CEM pretraining
    format) and TorchScript archives (``torch.jit.save``: the format
    MitoNet's published ``.pth`` weights ship in), whose module state
    dict is taken. DDP ``module.`` prefixes are stripped (reference
    train.py:131-138)."""
    if _is_torchscript_archive(path):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
        norms = None
    else:
        state = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(state, dict) and "state_dict" in state:
            sd = state["state_dict"]
            norms = state.get("norms")
        else:
            sd = state
            norms = None
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    if norms is not None and not isinstance(norms, dict):
        norms = {"mean": float(norms[0]), "std": float(norms[1])}
    return sd, norms


def _classify_torch(sd):
    """Split a reference state dict (in key order) into typed queues of
    (key, numpy array)."""
    prefixes_bn = {k[: -len(".running_mean")] for k in sd
                   if k.endswith(".running_mean")}
    queues = {name: [] for name in _QUEUES}
    seen_storage = set()
    for k, v in sd.items():
        if k.startswith("fc.") or ".fc." in k:
            continue  # classification head, never used (train.py:146)
        # modules shared across an nn.ModuleList (the reference BiFPN's
        # after-combine convs) appear once per registration: keep the
        # first occurrence of each tensor
        if hasattr(v, "data_ptr"):
            ptr = (v.data_ptr(), tuple(v.shape))
            if ptr in seen_storage:
                continue
            seen_storage.add(ptr)
        v = np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
        prefix, _, leaf = k.rpartition(".")
        if prefix in prefixes_bn:
            name = {"weight": "scale", "bias": "bn_bias",
                    "running_mean": "mean", "running_var": "var"}.get(leaf)
            if name is not None:
                queues[name].append((k, v))
        elif leaf == "weight" and v.ndim == 4:
            queues["kernel"].append((k, v))
        elif leaf == "weight" and v.ndim == 3:
            queues["kernel1d"].append((k, v))  # Conv1d (PointRend MLP)
        elif leaf == "weights" and v.ndim == 1:
            queues["fusion"].append((k, v))  # BiFPN fast-fusion weights
        elif leaf == "bias":
            queues["conv_bias"].append((k, v))
    return queues


def _registration_order(flat_keys):
    """Reorder flax paths to the reference's torch *registration* order.

    flax traces parameters in __call__ usage order, torch registers them
    in __init__ order. They agree everywhere except the PDL decoder,
    which registers aspp, then ALL project convs, then ALL fuse convs
    (reference decoders/panoptic_deeplab.py) while the flax trace
    interleaves project_i/fuse_i; and the BiFPN passes (below). A stable
    sort with a group rank on those segment names reconciles them."""
    rank = {"aspp": 0, "project": 1, "fuse": 2}

    # first-appearance index of every child name under every parent
    child_order = {}
    for path in flat_keys:
        for depth in range(len(path)):
            children = child_order.setdefault(path[:depth], {})
            children.setdefault(path[depth], len(children))

    def seg_key(parent, seg):
        base, _, suffix = seg.rpartition("_")
        if base in rank and suffix.isdigit():
            return (1, rank[base], int(suffix))
        # BiFPN top-down/bottom-up passes: torch registers resamplings,
        # then the (shared) after-combine conv, then the fusion weights;
        # flax traces fusion weights first and interleaves the rest
        if base == "resample" and suffix.isdigit():
            return (1, 0, int(suffix))
        if seg == "after":
            return (1, 5, 0)
        if seg == "fusion_weights":
            return (1, 6, 0)
        return (0, child_order[parent][seg], 0)

    return sorted(
        flat_keys,
        key=lambda path: tuple(
            seg_key(path[:d], path[d]) for d in range(len(path))))


def _state(module_or_state):
    return module_or_state.state_dict() \
        if hasattr(module_or_state, "state_dict") else module_or_state


def _port_leaves(state):
    """The port's tensors as {flax path: (state_dict key, tensor)}, one
    dict for params and one for batch statistics, each in the reference's
    registration order (the state dict's own key order, reshuffled)."""
    params, stats = {}, {}
    for key, t in state.items():
        *mods, leaf = key.split(".")
        if leaf in ("running_mean", "running_var"):
            stats[tuple(mods) + (leaf[len("running_"):],)] = (key, t)
        elif leaf != "num_batches_tracked":
            params[flax_path(key)] = (key, t)
    return ({p: params[p] for p in _registration_order(list(params))},
            {p: stats[p] for p in _registration_order(list(stats))})


def _queue_of(path, ndim):
    """Which reference queue feeds this flax leaf (None: none does)."""
    leaf = path[-1]
    in_bn = any("BatchNorm" in seg for seg in path)
    if leaf == "kernel":
        return "kernel" if ndim == 4 else "kernel1d"
    if leaf == "scale" and in_bn:
        return "scale"
    if leaf == "bias":
        return "bn_bias" if in_bn else "conv_bias"
    if leaf == "fusion_weights":
        return "fusion"
    return {"mean": "mean", "var": "var"}.get(leaf)


def _pairs(queues, state, what):
    """Pair each port tensor, in registration order, with the next
    reference tensor of its kind: yields (port key, port tensor, kind,
    reference key, reference array). Raises where ``what`` (the
    reference state dict) runs out of a kind."""
    params, stats = _port_leaves(state)
    for path, (key, t) in list(params.items()) + list(stats.items()):
        name = _queue_of(path, t.ndim)
        if name is None:
            raise KeyError(f"no reference tensor kind for {key}")
        if not queues[name]:
            raise ValueError(f"torch {what} ran out of {name} params at "
                             f"flax path {'/'.join(path)} ({key})")
        ref_key, v = queues[name].pop(0)
        yield key, t, name, ref_key, v


def _report(matched, queues):
    return {"matched": matched,
            "leftover": {k: len(q) for k, q in queues.items() if q}}


def convert_reference_state_dict(sd, module_or_state):
    """Map reference torch weights onto the port's module (or its state
    dict, in its own key order); the counterpart of the JAX package's
    ``convert_encoder_state_dict``.

    Returns (state_dict, report): every key of the port's state dict,
    with each tensor the order matching pairs taken from ``sd`` (float32)
    and ``num_batches_tracked`` zero; report = {"matched": n,
    "leftover": {kind: count}} for reference tensors no port tensor
    took. Raises on a shape mismatch and where ``sd`` runs out of a
    kind."""
    state = _state(module_or_state)
    queues = _classify_torch(sd)
    out = {}
    for key, t, name, ref_key, v in _pairs(queues, state, "checkpoint"):
        if name == "kernel1d":
            if v.shape[2] != 1:
                raise ValueError(f"Conv1d kernel_size={v.shape[2]} cannot "
                                 "map to a Linear layer (only kernel_size=1)")
            v = v[:, :, 0]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch {ref_key} {tuple(v.shape)} -> "
                             f"{key} {tuple(t.shape)}")
        out[key] = torch.from_numpy(np.array(v, np.float32, copy=True))
    result = {key: torch.zeros((), dtype=torch.long)
              if key.endswith(".num_batches_tracked") else out[key]
              for key in state}
    return result, _report(len(out), queues)


def convert_to_reference_state_dict(template, state_dict):
    """The inverse of ``convert_reference_state_dict``: fill a reference
    state-dict TEMPLATE (a same-architecture reference model's
    ``.state_dict()``) with the port's values; the counterpart of the JAX
    package's ``convert_flax_to_torch_state_dict``.

    ``state_dict``: the port's module or its state dict, in the port's
    key order. Returns (state_dict, report). Template-only entries
    (classification ``fc.``, ``num_batches_tracked``) keep their
    template values; keys aliased by weight sharing (the reference
    BiFPN's shared after-combine convs) all receive the shared tensor."""
    # every later key of an alias group mirrors the first
    ptr_first, aliases = {}, {}
    for k, v in template.items():
        if hasattr(v, "data_ptr"):
            ptr = (v.data_ptr(), tuple(v.shape))
            if ptr in ptr_first:
                aliases[k] = ptr_first[ptr]
            else:
                ptr_first[ptr] = k

    queues = _classify_torch(template)
    out = dict(template)
    matched = 0
    for key, t, name, ref_key, tv in _pairs(queues, _state(state_dict),
                                            "template"):
        v = t.detach().cpu().numpy().astype(np.float32)
        if name == "kernel1d":
            v = v[:, :, None]
        if tuple(v.shape) != tuple(tv.shape):
            raise ValueError(f"shape mismatch {key} {tuple(v.shape)} -> "
                             f"{ref_key} {tuple(tv.shape)}")
        out[ref_key] = torch.from_numpy(np.array(v, np.float32, copy=True))
        matched += 1
    for k, first in aliases.items():
        out[k] = out[first]
    return out, _report(matched, queues)


def load_encoder_pretraining(model, path, encoder_key="encoder_mod"):
    """Load a CEM torch encoder checkpoint into ``model``'s encoder (the
    'encoder_pretraining' path, reference train.py:141-157), in place.
    Returns the checkpoint's norms (or None)."""
    sd, norms = load_torch_state_dict(path)
    encoder = getattr(model, encoder_key)
    state, report = convert_reference_state_dict(sd, encoder)
    encoder.load_state_dict(state)
    print(f"=> loaded encoder pretraining from {path}: "
          f"{report['matched']} tensors"
          + (f", leftover {report['leftover']}" if report["leftover"]
             else ""))
    return norms
