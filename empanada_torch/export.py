"""Model export for deployment (reference scripts/export_model.py:77-199).

The float32 artifact: ``<name>.pth`` (a ``torch.save`` of the state dict
as CPU tensors) plus a YAML descriptor ``<name>.yaml`` (model_config,
norms, padding_factor, thing_list, labels, class_names, FINETUNE params)
that the inference command line consumes, exactly like the reference's
exported YAML (export_model.py:173-196). The descriptor has the JAX
package's keys and defaults with ``format: empanada_torch``.

The int8 artifact (``quantize=True``): ``<name>.int8.pth``, the state
dict with each quantized weight replaced by ``<key>.__int8__`` (int8, the
weight's layout) and ``<key>.__scale__`` (float32, one scale an output
channel), named by the descriptor's ``model_quantized``. With
calibration data the descriptor also carries ``act_scales``,
``quantize_scope`` and the measured ``int8_drift``, and the artifact
EXECUTES in int8 when loaded with ``quantized=True``
(``models/quantization.py``); without it the artifact is weight-only and
is dequantized to float32 on load. These are the JAX package's
``quantize_variables_int8`` semantics in the port's layout.

Other artifacts read here: the JAX package's own exports (``format:
empanada_tpu``, its ``<name>.params.msgpack`` and ``<name>.int8.msgpack``
decoded without the ``msgpack`` package, then ``weights.flax_to_torch``),
and reference torch artifacts (``import_torch_model``). The StableHLO
artifact has no counterpart on a GPU: asking for it raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from empanada_torch.models import create_model

__all__ = ["export_model", "load_exported_model", "import_torch_model",
           "quantize_state_int8", "dequantize_state_int8"]

FORMAT = "empanada_torch"
JAX_FORMAT = "empanada_tpu"
# keys of a quantized weight in the int8 artifact: <module>.weight + these
INT8_SUFFIX = ".__int8__"
SCALE_SUFFIX = ".__scale__"
# the eval forward calibration and the drift measurement run (the JAX
# package's apply_kwargs)
FORWARD_KW = {"render_steps": 2, "interpolate_ins": False}


def _out_axis(key):
    """The output-channel axis of a weight: 1 for a transposed conv's
    (in, out, kh, kw), 0 for a conv's (out, in, kh, kw) or a Linear's."""
    parts = key.split(".")
    return 1 if len(parts) > 1 and parts[-2].startswith("ConvTranspose_") \
        else 0


def quantize_state_int8(state_dict, module_paths=None):
    """int8 storage of the large weights, per-output-channel symmetric
    scales: scale = max |w| over every axis but the output channel / 127
    (at least 1e-12), w8 = clip(round_half_even(w / scale), -127, 127).

    Only weights with ``ndim >= 2`` and more than 4096 elements are
    quantized, and with ``module_paths`` (``a/b/c`` module paths: the
    calibration's ``act_scales`` keys) only those of the named modules,
    so transposed convs, which no int8 module replaces, stay float. With
    None (the weight-only artifact) every large weight is quantized.
    Returns a new state dict of CPU tensors."""
    allowed = None if module_paths is None else set(module_paths)
    out = {}
    for key, t in state_dict.items():
        t = t.detach().cpu()
        path = "/".join(key.split(".")[:-1])
        if (key.endswith(".weight") and t.ndim >= 2 and t.numel() > 4096
                and (allowed is None or path in allowed)):
            w = t.numpy().astype(np.float32)
            axis = _out_axis(key)
            axes = tuple(a for a in range(w.ndim) if a != axis)
            scale = np.abs(w).max(axis=axes, keepdims=True) / 127.0
            scale = np.maximum(scale, 1e-12)
            q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
            out[key + INT8_SUFFIX] = torch.from_numpy(q)
            out[key + SCALE_SUFFIX] = torch.from_numpy(
                scale.reshape(-1).astype(np.float32))
        else:
            out[key] = t.clone()
    return out


def dequantize_state_int8(state):
    """Inverse of ``quantize_state_int8`` -> a float32 state dict."""
    out = {}
    for key, t in state.items():
        if key.endswith(INT8_SUFFIX):
            base = key[: -len(INT8_SUFFIX)]
            shape = [1] * t.ndim
            shape[_out_axis(base)] = -1
            out[base] = t.float() * state[base + SCALE_SUFFIX].reshape(shape)
        elif not key.endswith(SCALE_SUFFIX):
            out[key] = t
    return out


def import_torch_model(pth_path, model_config, save_dir, name, norms=None,
                       **export_kw):
    """Take a reference torch artifact into the port: a plain torch
    checkpoint or a TorchScript archive (the format MitoNet's published
    weights ship in), converted by structural order into the
    ``model_config``'s model (``train.torch_weights``) and written as the
    port's descriptor (``export_model``, which also takes ``quantize``
    and the other export options). Raises where the artifact leaves
    tensors unconsumed. Returns the descriptor dict."""
    from empanada_torch.train.torch_weights import (
        convert_reference_state_dict,
        load_torch_state_dict,
    )

    sd, sd_norms = load_torch_state_dict(pth_path)
    cfg = dict(model_config)
    model = create_model(cfg.pop("arch"), device="cpu", **cfg)
    state, report = convert_reference_state_dict(sd, model)
    if report["leftover"]:
        raise ValueError(
            f"torch artifact does not structurally match model_config "
            f"{model_config}: unconsumed torch params {report['leftover']}")
    return export_model(state, model_config, save_dir, name,
                        norms=norms or sd_norms, **export_kw)


def export_model(state_dict, model_config, save_dir, name,
                 norms=None, padding_factor=128, thing_list=(1,),
                 labels=(1,), class_names=None, finetune_params=None,
                 stablehlo=False, quantize=False, calibration_data=None,
                 quantize_scope=None, run_id=None, device=None):
    """Write <name>.pth + <name>.yaml (+ <name>.int8.pth when
    quantize=True); returns the descriptor dict (also written to YAML).

    ``calibration_data``: iterable of normalized (N, 1, H, W) inputs
    (arrays or tensors) to calibrate the int8 activation scales on; the
    calibration and the drift measurement run on ``device`` (CUDA unless
    named; raises without a card when none is named). ``quantize_scope``:
    "all" | "encoder"; by default "encoder" for the BiFPN family (the
    reference's quantizable BiFPN keeps its decoder and heads float) and
    "all" for the others."""
    import yaml

    if stablehlo:
        raise NotImplementedError(
            "the StableHLO artifact (stablehlo=True) has no counterpart on "
            "the GPU; the .pth artifacts are the port's")
    scope = quantize_scope
    if quantize and scope is None:
        scope = ("encoder" if "BiFPN" in model_config.get("arch", "")
                 else "all")
    if quantize and scope not in ("all", "encoder"):
        raise ValueError(f"quantize_scope {scope!r}: 'all' or 'encoder'")
    calibrate = quantize and calibration_data is not None
    if calibrate:
        from empanada_torch.device import resolve_device

        device = resolve_device(device)

    os.makedirs(save_dir, exist_ok=True)
    weights_path = os.path.join(save_dir, f"{name}.pth")
    state_dict = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save(state_dict, weights_path)

    desc = {
        "format": FORMAT,
        "model": weights_path,
        "model_config": dict(model_config),
        "norms": dict(norms) if norms else {"mean": 0.5, "std": 0.29},
        "padding_factor": padding_factor,
        "thing_list": list(thing_list),
        "labels": list(labels),
        "class_names": dict(class_names or {l: str(l) for l in labels}),
        "FINETUNE": finetune_params or {},
        "run_id": run_id,  # training run for eval-result back-logging
    }

    if quantize:
        if calibrate:
            from empanada_torch.models.quantization import (
                calibrate_activations,
            )

            cfg = dict(model_config)
            model = create_model(cfg.pop("arch"), device="cpu", **cfg)
            model.load_state_dict(state_dict)
            model = model.to(device).eval()
            batches = [torch.as_tensor(b, dtype=torch.float32,
                                       device=device)
                       for b in calibration_data]
            act_scales = calibrate_activations(model, batches,
                                               forward_kwargs=FORWARD_KW)
            if scope == "encoder":
                act_scales = {k: v for k, v in act_scales.items()
                              if k.split("/")[0].startswith("encoder")}
            desc["act_scales"] = act_scales
            desc["quantize_scope"] = scope
            # only the modules an int8 module replaces go int8; the
            # others (transposed convs) stay float
            int8_state = quantize_state_int8(state_dict, act_scales.keys())
            desc["int8_drift"] = _measure_int8_drift(
                model, int8_state, act_scales, batches)
        else:
            int8_state = quantize_state_int8(state_dict)
        q_path = os.path.join(save_dir, f"{name}.int8.pth")
        torch.save(int8_state, q_path)
        desc["model_quantized"] = q_path

    with open(os.path.join(save_dir, f"{name}.yaml"), "w") as f:
        yaml.safe_dump(desc, f)
    return desc


def _measure_int8_drift(model, int8_state, act_scales, batches):
    """int8-vs-float32 drift on (at most 2 of) the calibration batches:
    {"sem_iou": mean IoU of the hardened (> 0.5) semantic maps,
    "center_count_rel": mean relative difference of the instance-center
    counts (NMS threshold 0.1, kernel 7, 256 slots), "batches": n}, each
    rounded to 4 places, as the JAX package measures it."""
    import copy

    from empanada_torch.models.quantization import quantize_model
    from empanada_torch.ops.postprocess import (
        find_instance_centers,
        logits_to_prob,
    )

    int8_model = quantize_model(copy.deepcopy(model), int8_state,
                                act_scales).eval()
    ious, center_rel = [], []
    with torch.inference_mode():
        for x in list(batches)[:2]:
            out_f = model(x, **FORWARD_KW)
            out_q = int8_model(x, **FORWARD_KW)
            sem_f = logits_to_prob(out_f["sem_logits"]) > 0.5
            sem_q = logits_to_prob(out_q["sem_logits"]) > 0.5
            union = int((sem_f | sem_q).sum())
            inter = int((sem_f & sem_q).sum())
            ious.append(inter / union if union else 1.0)
            _, vf = find_instance_centers(out_f["ctr_hmp"][:, 0], 0.1, 7, 256)
            _, vq = find_instance_centers(out_q["ctr_hmp"][:, 0], 0.1, 7, 256)
            n_f, n_q = int(vf.sum()), int(vq.sum())
            center_rel.append(abs(n_q - n_f) / max(n_f, 1))
    return {"sem_iou": round(float(np.mean(ious)), 4),
            "center_count_rel": round(float(np.mean(center_rel)), 4),
            "batches": len(ious)}


def _jax_int8_state(tree, model):
    """A JAX package int8 artifact (flax tree whose quantized kernels are
    {"__int8__": HWIO / (in, out) int8, "__scale__": (1, ..., O)}) -> the
    port's int8 state (``quantize_state_int8`` layout)."""
    from empanada_torch.weights import _convert_leaf, _flatten, flax_to_torch

    rest = {}
    state = {}
    for collection, sub in tree.items():
        for path, value in _flatten(sub):
            if path[-1] == "__int8__":
                key, arr = _convert_leaf(collection, path[:-1], value)
                state[key + INT8_SUFFIX] = torch.from_numpy(
                    np.ascontiguousarray(arr).astype(np.int8))
            elif path[-1] == "__scale__":
                key = ".".join(path[:-2]) + ".weight"
                state[key + SCALE_SUFFIX] = torch.from_numpy(
                    np.asarray(value, np.float32).reshape(-1).copy())
            else:
                node = rest.setdefault(collection, {})
                for seg in path[:-1]:
                    node = node.setdefault(seg, {})
                node[path[-1]] = value
    state.update(flax_to_torch(rest))
    want = set(model.state_dict())
    have = {k[: -len(INT8_SUFFIX)] if k.endswith(INT8_SUFFIX) else k
            for k in state if not k.endswith(SCALE_SUFFIX)}
    if have != want:
        raise KeyError(f"int8 artifact does not match the model: missing "
                       f"{sorted(want - have)[:8]}, extra "
                       f"{sorted(have - want)[:8]}")
    return state


def load_exported_model(descriptor_path, quantized=False, device=None):
    """Descriptor YAML -> (nn.Module in eval mode on the device,
    descriptor dict). The analog of torch.jit.load on the reference's
    exported model (reference pdl_inference3d.py:69-74). Reads the port's
    descriptors and the JAX package's (``format: empanada_tpu``).

    ``quantized=True`` loads the int8 artifact: with the descriptor's
    calibrated ``act_scales`` the model EXECUTES int8 convolutions and
    products (``models.quantization.quantize_model``); without them the
    weights are dequantized to float32. ``device``: CUDA unless named;
    raises without a card when none is named. Relative weight paths
    resolve beside the descriptor."""
    from empanada_torch.config import read_yaml
    from empanada_torch.device import resolve_device

    device = resolve_device(device)
    desc = read_yaml(descriptor_path)
    fmt = desc.get("format")
    if fmt not in (FORMAT, JAX_FORMAT):
        raise ValueError(f"{descriptor_path}: descriptor format {fmt!r} is "
                         f"neither {FORMAT!r} nor {JAX_FORMAT!r}")
    key = "model_quantized" if quantized else "model"
    if key not in desc:
        raise ValueError(f"{descriptor_path}: no int8 artifact "
                         "(model_quantized); export with quantize=True")

    cfg = dict(desc["model_config"])
    arch = cfg.pop("arch")
    model = create_model(arch, device="cpu", **cfg)

    weights_path = desc[key]
    if not os.path.isabs(weights_path):
        weights_path = os.path.join(os.path.dirname(descriptor_path),
                                    os.path.basename(weights_path))
    if fmt == JAX_FORMAT:
        from empanada_torch.utils.msgpack import read_msgpack
        from empanada_torch.weights import flax_to_torch

        tree = read_msgpack(weights_path)
        state = _jax_int8_state(tree, model) if quantized \
            else flax_to_torch(tree, expect=model)
    else:
        state = torch.load(weights_path, map_location="cpu",
                           weights_only=True)
    if quantized and desc.get("act_scales"):
        from empanada_torch.models.quantization import quantize_model

        quantize_model(model, state, desc["act_scales"])
    else:
        model.load_state_dict(dequantize_state_int8(state) if quantized
                              else state)
    return model.to(device).eval(), desc
