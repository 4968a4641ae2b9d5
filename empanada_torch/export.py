"""Model export for deployment (reference scripts/export_model.py:77-199).

The float32 artifact: ``<name>.pth`` (a ``torch.save`` of the state dict
as CPU tensors) plus a YAML descriptor ``<name>.yaml`` (model_config,
norms, padding_factor, thing_list, labels, class_names, FINETUNE params)
that the inference command line consumes, exactly like the reference's
exported YAML (export_model.py:173-196). The descriptor has the JAX
package's keys and defaults with ``format: empanada_torch``; weights
cross from that package through ``weights.flax_to_torch``.

The int8 and StableHLO artifacts are not ported: asking for them raises.
"""

from __future__ import annotations

import os

import torch

from empanada_torch.models import create_model

__all__ = ["export_model", "load_exported_model"]

FORMAT = "empanada_torch"


def export_model(state_dict, model_config, save_dir, name,
                 norms=None, padding_factor=128, thing_list=(1,),
                 labels=(1,), class_names=None, finetune_params=None,
                 stablehlo=False, quantize=False, run_id=None):
    """Write <name>.pth + <name>.yaml; returns the descriptor dict (also
    written to YAML)."""
    import yaml

    if quantize:
        raise NotImplementedError(
            "the int8 artifact (quantize=True) is not ported yet")
    if stablehlo:
        raise NotImplementedError(
            "the StableHLO artifact (stablehlo=True) is not ported; the "
            "float32 .pth artifact is the only one")

    os.makedirs(save_dir, exist_ok=True)
    weights_path = os.path.join(save_dir, f"{name}.pth")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               weights_path)

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
    with open(os.path.join(save_dir, f"{name}.yaml"), "w") as f:
        yaml.safe_dump(desc, f)
    return desc


def load_exported_model(descriptor_path, quantized=False, device=None):
    """Descriptor YAML -> (nn.Module in eval mode on the device,
    descriptor dict). The analog of torch.jit.load on the reference's
    exported model (reference pdl_inference3d.py:69-74). ``device``:
    CUDA unless named; raises without a card when none is named."""
    from empanada_torch.config import read_yaml
    from empanada_torch.device import resolve_device

    if quantized:
        raise NotImplementedError(
            "the int8 artifact (quantized=True) is not ported yet")
    device = resolve_device(device)
    desc = read_yaml(descriptor_path)
    if desc.get("format") != FORMAT:
        raise ValueError(
            f"{descriptor_path}: descriptor format {desc.get('format')!r} "
            f"is not {FORMAT!r}. Convert the JAX package's variables with "
            "empanada_torch.weights.flax_to_torch and write them with "
            "empanada_torch.export.export_model")

    cfg = dict(desc["model_config"])
    arch = cfg.pop("arch")
    model = create_model(arch, device="cpu", **cfg)

    weights_path = desc["model"]
    if not os.path.isabs(weights_path):
        weights_path = os.path.join(os.path.dirname(descriptor_path),
                                    os.path.basename(weights_path))
    state = torch.load(weights_path, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return model.to(device).eval(), desc
