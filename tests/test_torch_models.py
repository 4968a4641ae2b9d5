"""Port parity: the tiny flax MitoNet (PanopticBiFPNPR on regnety_200mf,
fpn_layers=1, 128^2) converted by empanada_torch.weights.flax_to_torch
must reproduce the flax eval outputs.

The flax init leaves most outputs near zero (zero-init residual BN,
1e-3 heads), so the variables are replaced by seeded random values of
realistic scale. Tolerance: 1e-4 of max |value| per output (float32,
different summation order in the convolutions).
"""

import pytest

# the JAX package's third-party dependencies: where only the port's are
# installed, these parity tests skip
for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import numpy as np
import torch
from flax import traverse_util

from empanada_tpu.models import create_model as flax_create_model
from empanada_tpu.models.point_rend import (
    get_uncertain_point_coords_on_grid as j_uncertain_points,
)
from empanada_torch.models import create_model
from empanada_torch.models.point_rend import (
    get_uncertain_point_coords_on_grid as t_uncertain_points,
)
from empanada_torch.weights import flax_to_torch

TINY = dict(encoder="regnety_200mf", fpn_layers=1, num_classes=1,
            train_num_points=16, subdivision_num_points=32)
REL_TOL = 1e-4


def _randomize(variables, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for path, a in traverse_util.flatten_dict(
            jax.tree_util.tree_map(np.asarray, variables)).items():
        leaf = path[-1]
        if leaf == "var":
            v = 1 + 0.2 * rng.random(a.shape)
        elif leaf == "kernel":
            v = rng.normal(0, 1, a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf == "fusion_weights":
            v = 0.5 + rng.random(a.shape)
        elif leaf == "scale":
            v = 1 + 0.1 * rng.normal(0, 1, a.shape)
        else:
            v = 0.1 * rng.normal(0, 1, a.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


@pytest.fixture(scope="module")
def tiny_pair():
    flax_model = flax_create_model("PanopticBiFPNPR", **TINY)
    x = np.zeros((1, 128, 128, 1), np.float32)
    init = flax_model.init(
        {"params": jax.random.key(0), "points": jax.random.key(1),
         "dropout": jax.random.key(2)}, x, train=False)
    variables = _randomize(init, seed=3)
    torch_model = create_model("PanopticBiFPNPR", device="cpu", **TINY)
    torch_model.load_state_dict(flax_to_torch(variables, expect=torch_model))
    return flax_model, variables, torch_model


@pytest.mark.parametrize("interpolate_ins", [True, False])
def test_converted_mitonet_matches_flax(tiny_pair, interpolate_ins):
    flax_model, variables, torch_model = tiny_pair
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 128, 128, 1)).astype(np.float32)
    want = flax_model.apply(variables, x, train=False, render_steps=2,
                            interpolate_ins=interpolate_ins)
    with torch.inference_mode():
        got = torch_model(torch.from_numpy(x).permute(0, 3, 1, 2),
                          render_steps=2, interpolate_ins=interpolate_ins)
    coarse = 32 if not interpolate_ins else 128
    shapes = {"sem_logits": (2, 128, 128, 1), "ctr_hmp": (2, coarse, coarse, 1),
              "offsets": (2, coarse, coarse, 2)}
    for key, shape in shapes.items():
        a = np.asarray(want[key])
        b = got[key].permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape == shape, key
        scale = np.abs(a).max()
        assert scale > 0.05, (key, scale)  # real signal, not init zeros
        np.testing.assert_allclose(b, a, rtol=0, atol=REL_TOL * scale,
                                   err_msg=key)


def test_render_steps_one_matches_flax(tiny_pair):
    """One PointRend step renders at 1/2 resolution."""
    flax_model, variables, torch_model = tiny_pair
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (1, 128, 128, 1)).astype(np.float32)
    want = np.asarray(flax_model.apply(variables, x, train=False,
                                       render_steps=1)["sem_logits"])
    with torch.inference_mode():
        got = torch_model(torch.from_numpy(x).permute(0, 3, 1, 2),
                          render_steps=1)["sem_logits"]
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 64, 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


def test_uncertain_points_ties_go_to_lower_index():
    """Exact top-k with ties broken toward the lower flat index, like
    lax.top_k (the port never uses an approximate top-k)."""
    rng = np.random.default_rng(6)
    unc = np.round(rng.random((2, 12, 10, 1)) * 3).astype(np.float32) / 3
    j_idx, j_coords = j_uncertain_points(unc, 50)
    t_idx, t_coords = t_uncertain_points(
        torch.from_numpy(unc).permute(0, 3, 1, 2), 50)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_coords.numpy(), np.asarray(j_coords))


def test_converter_raises_on_missing_or_extra_leaf(tiny_pair):
    _, variables, torch_model = tiny_pair
    flat = traverse_util.flatten_dict(variables)

    missing = dict(flat)
    del missing[("params", "ins_xy", "Conv_0", "bias")]
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch(traverse_util.unflatten_dict(missing),
                      expect=torch_model)

    extra = dict(flat)
    extra[("params", "ins_xy", "Conv_9", "kernel")] = np.zeros(
        (1, 1, 160, 2), np.float32)
    with pytest.raises(KeyError, match="extra"):
        flax_to_torch(traverse_util.unflatten_dict(extra), expect=torch_model)

    unknown = dict(flat)
    unknown[("params", "ins_xy", "Conv_0", "gamma")] = np.zeros(2, np.float32)
    with pytest.raises(KeyError):
        flax_to_torch(traverse_util.unflatten_dict(unknown))


def test_converter_layouts():
    """HWIO -> OIHW, transposed convs flipped, Dense -> Linear, BN
    leaves renamed (+ num_batches_tracked)."""
    rng = np.random.default_rng(7)
    conv = rng.random((3, 3, 4, 8)).astype(np.float32)
    tconv = rng.random((2, 2, 4, 8)).astype(np.float32)
    dense = rng.random((5, 6)).astype(np.float32)
    sd = flax_to_torch({
        "params": {"a": {"Conv_0": {"kernel": conv},
                         "ConvTranspose_0": {"kernel": tconv},
                         "Dense_0": {"kernel": dense, "bias": np.ones(6)},
                         "BatchNorm_0": {"scale": np.ones(8),
                                         "bias": np.zeros(8)}}},
        "batch_stats": {"a": {"BatchNorm_0": {"mean": np.zeros(8),
                                              "var": np.ones(8)}}},
    })
    np.testing.assert_array_equal(sd["a.Conv_0.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["a.ConvTranspose_0.weight"].numpy(),
                                  tconv[::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(sd["a.Dense_0.weight"].numpy(), dense.T)
    assert set(sd) >= {"a.BatchNorm_0.weight", "a.BatchNorm_0.running_var",
                       "a.BatchNorm_0.num_batches_tracked"}
