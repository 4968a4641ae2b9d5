"""The benchmark's seeded weights: the training recipe's initial
distributions, made on the device from the seed in two large draws and
handed to the program and to the reference alike.

Each state-dict entry takes the first rule whose pattern it matches
(the distributions of the models' published ``init``): kaiming-normal
(fan out) convolutions, glorot-uniform separable and transposed
convolutions, normal with std 0.001 for the heads, the ASPP and the
Panoptic-DeepLab decoders' projections and fuses, zero biases, batch
norm scale 1 (0 on the last batch norm of each RegNet block), running
variance and BiFPN fusion weights 1. An architecture's reference module
may add ``INIT_RULES``, consulted before these.
"""

from __future__ import annotations

import math
import re

import torch

__all__ = ["RULES", "KINDS", "rule_for", "make_state", "bench_backbone",
           "head_keys", "fingerprint", "bench_state"]

HEADS = r"(semantic_head|ins_center|ins_xy)\."
RULES = [
    (r"(running_var|fusion_weights)$", "ones"),
    (r"stage\d+_block\d+\.ConvBNAct_2\.BatchNorm_0\.weight$", "zeros"),
    (r"BatchNorm_\d+\.weight$", "ones"),
    (r"(bias|running_mean)$", "zeros"),
    (r"num_batches_tracked$", "zeros"),
    (r"ASPP_0\.Conv_\d+\.weight$", "head_normal"),
    (r"project_\d+\.Conv_0\.weight$", "head_normal"),
    (r"fuse_\d+\.Conv_[01]\.weight$", "head_normal"),
    (HEADS + r"SeparableConvBNAct_0\.Conv_[01]\.weight$", "head_normal"),
    (HEADS + r"Conv_0\.weight$", "head_normal"),
    (r"(after|fusion)\.Conv_[01]\.weight$", "glorot_uniform"),
    (r"ConvTranspose_0\.weight$", "glorot_uniform"),
    (r"Dense_\d+\.weight$", "dense"),
    (r"weight$", "kaiming_normal"),
]
KINDS = ("ones", "zeros", "head_normal", "kaiming_normal", "dense",
         "glorot_uniform")


def rule_for(name, rules=()):
    """The rule of the first pattern of ``rules``, then ``RULES``, that
    the state-dict key ``name`` matches."""
    for pattern, rule in (*rules, *RULES):
        if re.search(pattern, name):
            return rule
    raise KeyError(name)


def _fans(shape):
    rf = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * rf, shape[0] * rf


def make_state(shapes, seed, device, num_fc, rules=()):
    """{name: tensor} for ``shapes`` ({name: (shape, dtype)}, a model's
    state dict order) on ``device``. ``num_fc``: the PointRend MLP's
    hidden layers (its last layer takes std 0.001). ``rules``: (pattern,
    one of ``KINDS``) pairs consulted before ``RULES``."""
    unknown = [rule for _, rule in rules if rule not in KINDS]
    if unknown:
        raise ValueError(f"unknown initialisation rules {unknown}")
    floats = [n for n, (s, dt) in shapes.items() if dt.is_floating_point]
    total = sum(math.prod(shapes[n][0]) for n in floats)
    gen = torch.Generator(device).manual_seed(int(seed) % (1 << 63))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    last_dense = f"Dense_{num_fc}.weight"
    out, at = {}, 0
    for name, (shape, dtype) in shapes.items():
        rule = rule_for(name, rules)
        if not dtype.is_floating_point or rule in ("zeros", "ones"):
            fill = 1 if rule == "ones" else 0
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
            if dtype.is_floating_point:
                at += math.prod(shape)
            continue
        n = math.prod(shape)
        fan_in, fan_out = _fans(shape)
        if rule == "head_normal" or name.endswith(last_dense):
            t = normal[at:at + n] * 0.001
        elif rule in ("kaiming_normal", "dense"):
            t = normal[at:at + n] * math.sqrt(2.0 / fan_out)
        else:  # glorot_uniform
            t = (uniform[at:at + n] * 2 - 1) \
                * math.sqrt(6.0 / (fan_in + fan_out))
        out[name] = t.view(shape).to(dtype)
        at += n
    return out


# --- the bench MitoNet's weights (inference cells) ------------------------

BENCH_HEADS = {"semantic_head": "sem", "ins_center": "ctr", "ins_xy": "off"}


def bench_backbone(shapes, seed=0):
    """The seeded backbone that the committed heads were fitted on: one
    CPU generator over the state dict in order; kaiming-normal (fan out)
    for every tensor of two or more dimensions, running variance 1 +
    U(0, 0.1), BiFPN fusion weights 1, other weights 1 + 0.1 N(0, 1),
    other vectors 0.05 N(0, 1). The heads' fit holds for these values
    only, so they do not depend on a run's seed."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, dtype) in shapes.items():
        if not dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dtype)
        elif len(shape) >= 2:
            fan_out = shape[0] * (math.prod(shape[2:]) if len(shape) > 2
                                  else 1)
            out[name] = torch.randn(shape, generator=gen) \
                * (2.0 / fan_out) ** 0.5
        elif name.endswith("running_var"):
            out[name] = 1.0 + 0.1 * torch.rand(shape, generator=gen)
        elif name.endswith("fusion_weights"):
            out[name] = torch.ones(shape)
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * torch.randn(shape, generator=gen)
        else:
            out[name] = 0.05 * torch.randn(shape, generator=gen)
    return out


def _dense(num_fc):
    return f"semantic_pr.StandardPointHead_0.Dense_{num_fc}."


def head_keys(num_fc):
    """The state-dict keys of the bench MitoNet's fitted heads."""
    dense = _dense(num_fc)
    return [f"{h}.Conv_0.{leaf}" for h in BENCH_HEADS
            for leaf in ("weight", "bias")] + [dense + "weight",
                                               dense + "bias"]


def fingerprint(state, skip):
    """SHA-256 over the names and float32 bytes of every floating tensor
    but those of the keys ``skip`` (the fitted heads'), in name order
    (the heads file records the backbone's)."""
    import hashlib

    skip = set(skip)
    digest = hashlib.sha256()
    for key in sorted(state):
        t = state[key]
        if key in skip or not t.is_floating_point():
            continue
        digest.update(key.encode())
        digest.update(t.detach().to("cpu", torch.float32).contiguous()
                      .numpy().tobytes())
    return digest.hexdigest()


def _fitted(data, state, num_fc):
    """{state key: array in torch layout} that a heads file puts in: the
    arrays it holds under the state-dict keys they replace, and the
    bench MitoNet's heads under their tags (``<tag>_kernel`` HWIO and
    ``<tag>_bias`` of ``BENCH_HEADS``; ``pr_kernel`` (in, out) and
    ``pr_bias`` of the point head's last Dense)."""
    out = {key: value for key, value in data.items() if key in state}
    if "pr_kernel" in data:
        dense = _dense(num_fc)
        out[dense + "weight"] = data["pr_kernel"].T
        out[dense + "bias"] = data["pr_bias"]
        for head, tag in BENCH_HEADS.items():
            out[f"{head}.Conv_0.weight"] = \
                data[f"{tag}_kernel"].transpose(3, 2, 0, 1)
            out[f"{head}.Conv_0.bias"] = data[f"{tag}_bias"]
    return out


def bench_state(shapes, npz_path, num_fc):
    """The inference cells' weights: ``bench_backbone`` with the fitted
    heads of ``npz_path`` put in; raises where the file was fitted on
    another backbone."""
    import numpy as np

    state = bench_backbone(shapes)
    with np.load(npz_path) as f:
        data = dict(f)
    updates = _fitted(data, state, num_fc)
    if str(data["backbone_fingerprint"]) != fingerprint(state, updates):
        raise ValueError(f"{npz_path} was not fitted on this backbone")
    for key, value in updates.items():
        if tuple(state[key].shape) != value.shape:
            raise ValueError(f"{key}: fitted {value.shape}, model "
                             f"{tuple(state[key].shape)}")
        state[key] = torch.from_numpy(np.array(value, np.float32))
    return state
