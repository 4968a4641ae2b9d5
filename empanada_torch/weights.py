"""Weight carry-across: the JAX package's flax variables -> this port's
state_dict.

The port's modules register their children under the flax names
(``Conv_0``, ``BatchNorm_0``, ``stage1_block1``, ...), so each flax leaf
maps to one state_dict key by its path. Layout changes:

- conv kernels HWIO -> OIHW (grouped and depthwise included);
- transposed-conv kernels (kh, kw, in, out) -> (in, out, kh, kw) with a
  spatial flip (flax does not flip, torch's ConvTranspose2d does);
- Dense kernels (in, out) -> Linear weights (out, in);
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (+ a zero ``num_batches_tracked``).

Any leaf that maps nowhere raises; given ``expect`` (a module or a
state_dict), missing and extra keys and shape mismatches raise too.

``params_to_torch`` maps a params-only tree the same way (gradients,
optax's Adam ``mu`` / ``nu``), and ``flax_path`` names the flax leaf of
a parameter of the port, so masks built on flax paths carry across.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_to_torch", "params_to_torch", "flax_path"]

_BN_LEAVES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


# convs the JAX modules name themselves (ResNet's 7x7 stem); every
# other conv is flax's auto-named ``Conv_<i>``
_NAMED_CONVS = ("stem",)


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, value


def _convert_leaf(collection, path, value):
    """(state_dict key, tensor) for one flax leaf, or raise."""
    *mods, leaf = path
    owner = mods[-1] if mods else ""
    base = ".".join(mods)
    v = np.asarray(value, dtype=np.float32)
    if owner.startswith("BatchNorm_"):
        name = _BN_LEAVES.get((collection, leaf))
        if name is None:
            raise KeyError(f"unexpected batch-norm leaf {collection}/"
                           f"{'/'.join(path)}")
        return f"{base}.{name}", v
    if collection != "params":
        raise KeyError(f"unexpected leaf {collection}/{'/'.join(path)}")
    if leaf == "fusion_weights":
        return base + ".fusion_weights" if base else leaf, v
    if leaf == "bias":
        return f"{base}.bias", v
    if leaf != "kernel":
        raise KeyError(f"unexpected leaf params/{'/'.join(path)}")
    if owner.startswith("ConvTranspose_") and v.ndim == 4:
        return f"{base}.weight", v[::-1, ::-1].transpose(2, 3, 0, 1)
    if (owner.startswith("Conv_") or owner in _NAMED_CONVS) and v.ndim == 4:
        return f"{base}.weight", v.transpose(3, 2, 0, 1)
    if owner.startswith("Dense_") and v.ndim == 2:
        return f"{base}.weight", v.T
    raise KeyError(f"cannot map kernel params/{'/'.join(path)} "
                   f"of shape {v.shape}")


def flax_to_torch(variables_numpy, expect=None):
    """Convert ``{"params": ..., "batch_stats": ...}`` (nested dicts of
    numpy arrays) to a state_dict for the port's matching module.

    ``expect``: optional module or state_dict to check against — every
    key must be produced exactly once with the same shape."""
    state = {}
    for collection, tree in variables_numpy.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {collection!r}")
        for path, value in _flatten(tree):
            key, arr = _convert_leaf(collection, path, value)
            if key in state:
                raise KeyError(f"two flax leaves map to {key}")
            state[key] = torch.from_numpy(np.array(arr, copy=True))
    for key in list(state):
        if key.endswith(".running_mean"):
            state[key[: -len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    if expect is not None:
        want = expect.state_dict() if hasattr(expect, "state_dict") \
            else expect
        missing = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        if missing or extra:
            raise KeyError(f"state_dict mismatch: missing {missing[:8]} "
                           f"({len(missing)}), extra {extra[:8]} "
                           f"({len(extra)})")
        for key, t in want.items():
            if tuple(t.shape) != tuple(state[key].shape):
                raise ValueError(f"{key}: shape {tuple(state[key].shape)} "
                                 f"!= expected {tuple(t.shape)}")
    return state


def params_to_torch(params_numpy):
    """A params-only flax tree (parameters, gradients, optimizer moments)
    -> {parameter name of the port: tensor}, with the layout changes of
    ``flax_to_torch``."""
    out = {}
    for path, value in _flatten(params_numpy):
        key, arr = _convert_leaf("params", path, value)
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def flax_path(name: str) -> tuple:
    """Parameter name of the port -> the path of its flax leaf in the
    ``params`` collection (``a.BatchNorm_0.weight`` -> ``(a,
    "BatchNorm_0", "scale")``, ``a.Conv_0.weight`` -> ``(a, "Conv_0",
    "kernel")``)."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        leaf = "scale" if mods[-1].startswith("BatchNorm_") else "kernel"
    return tuple(mods) + (leaf,)
