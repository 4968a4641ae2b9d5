"""The port's executing int8 path (``ops/int8.py``,
``models/quantization.py``, ``export.quantize_state_int8``) held against
the JAX package's (``models/quantization.py``, ``export.py``) on the
same numpy inputs and weights.

Exact: the int8 products (against ``lax.conv_general_dilated`` /
``dot_general`` on int8 operands), the int8 artifact (kernels permuted,
scales reshaped), the int8 product count of one forward.

Within tolerance: the calibrated activation scales (rtol 1e-5: the
float32 activations differ by ulps between XLA and torch, and the
percentile is taken over them); the whole int8 model's outputs. There
the ulps can move an activation across a .5 rounding boundary and flip
its int8 code by one, and a flipped code moves the next product by a
whole weight step, which flips more codes downstream. Measured on these
inputs: PDL-PR flips no code; the BiFPN-PR flips its first code in the
first stage-4 block, and the cascade through stage 4's 4x4 maps flips
1.92% of all int8 input codes (12255 of 639488, none by more than 3).
The test holds the flipped-code share under 3%, the outputs within 1e-4
of max |value| (measured 2.6e-5 and 7.1e-7) and the hardened semantic
maps equal on all but 0.1% of the pixels (measured: all equal)."""

import pytest

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn
from flax import traverse_util
from jax import lax

from empanada_tpu import export as jax_export
from empanada_tpu.models import create_model as j_create_model
from empanada_tpu.models import quantization as jq
from empanada_torch import export
from empanada_torch.models import create_model
from empanada_torch.models import quantization as tq
from empanada_torch.ops import int8
from empanada_torch.weights import flax_to_torch
from tests.test_torch_models import TINY as BIFPN_TINY
from tests.test_torch_pdl import TINY as PDL_TINY
from tests.test_torch_torch_weights import RNGS, _randomize

APPLY_KW = dict(train=False, render_steps=2, interpolate_ins=False)
MODELS = {
    # BiFPN-PR: scope "encoder" (its transposed convs stay float)
    "bifpn_pr": ("PanopticBiFPNPR", dict(BIFPN_TINY), 128, "encoder"),
    # PDL-PR: scope "all" (decoders, heads and PointRend's Dense too)
    "pdl_pr": ("PanopticDeepLabPR", dict(PDL_TINY, ins_decoder=True), 64,
               "all"),
}
FLIP_SHARE = 0.03
OUT_TOL = 1e-4
SEM_FLIPS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several pytest workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _batches(side, n=2, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, side, side, 1)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module", params=list(MODELS))
def quantized(request):
    """JAX and port models on the same weights, calibrated on the same
    batches, with the scope's scales and both int8 artifacts."""
    arch, kw, side, scope = MODELS[request.param]
    j_model = j_create_model(arch, **kw)
    variables = _randomize(j_model.init(
        RNGS, np.zeros((1, side, side, 1), np.float32), train=False), 9)
    port = create_model(arch, device="cpu", **kw)
    port.load_state_dict(flax_to_torch(variables, expect=port))
    batches = _batches(side)
    j_scales = jq.calibrate_activations(j_model, variables, batches,
                                        apply_kwargs=APPLY_KW)
    scales = tq.calibrate_activations(port, [_nchw(b) for b in batches],
                                      forward_kwargs=export.FORWARD_KW)
    if scope == "encoder":
        j_scales = {k: v for k, v in j_scales.items()
                    if k.split("/")[0].startswith("encoder")}
        scales = {k: v for k, v in scales.items()
                  if k.split("/")[0].startswith("encoder")}
    return dict(name=request.param, arch=arch, kw=kw, side=side,
                j_model=j_model, variables=variables, port=port,
                batches=batches, j_scales=j_scales, scales=scales)


CONVS = [  # cin, cout, k, stride, dilation, groups, H, W, padding
    (8, 16, 3, 1, 1, 1, 13, 11, 1),
    (8, 16, 3, 2, 1, 1, 13, 11, 1),
    (16, 16, 3, 1, 2, 4, 15, 9, 2),
    (12, 12, 3, 2, 1, 12, 10, 13, 1),  # depthwise
    (5, 7, 1, 1, 1, 1, 9, 9, 0),
    (6, 10, 5, 2, 2, 2, 17, 14, 4),
    (6, 10, 3, 1, 1, 1, 7, 7, 0),
]


@pytest.mark.parametrize("case", CONVS, ids=[
    "3x3", "3x3_s2", "3x3_d2_g4", "depthwise_s2", "1x1", "5x5_s2_d2_g2",
    "3x3_valid"])
def test_int8_conv2d_equals_lax(case):
    """The plain path equals XLA's int8 convolution exactly; the card
    path's im2col and padding, run here through torch._int_mm on the
    CPU, equal it too."""
    cin, cout, k, s, d, g, h, w, p = case
    rng = np.random.default_rng(sum(case))
    x = rng.integers(-127, 128, (2, h, w, cin)).astype(np.int8)
    wt = rng.integers(-127, 128, (k, k, cin // g, cout)).astype(np.int8)
    want = lax.conv_general_dilated(
        x, wt, (s, s), [(p, p), (p, p)], rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g,
        preferred_element_type=jnp.int32)
    xq = _nchw(x)
    w8 = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    got = int8.int8_conv2d(xq, w8, s, p, d, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    card = int8.int8_conv2d_card(xq, w8, s, p, d, g)
    assert torch.equal(card, got)


@pytest.mark.parametrize("shape", [(3, 20), (2, 5, 64), (33, 7)])
def test_int8_linear_equals_dot_general(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.integers(-127, 128, shape).astype(np.int8)
    wt = rng.integers(-127, 128, (shape[-1], 9)).astype(np.int8)
    want = lax.dot_general(x, wt, (((x.ndim - 1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)
    w8 = torch.from_numpy(np.ascontiguousarray(wt.T))
    got = int8.int8_linear(torch.from_numpy(x), w8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(int8.int8_linear_card(torch.from_numpy(x), w8), got)


def test_int8_operands_are_checked():
    x = torch.zeros((1, 2, 4, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        int8.int8_conv2d(x.float(), torch.zeros((2, 2, 1, 1), dtype=torch.int8))


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_state_equals_jax(quantized, calibrated):
    """quantize_state_int8 == the JAX package's quantize_variables_int8
    (kernels permuted to the port's layout, scales reshaped to (O,)),
    exactly; with a calibrated path set, only the named modules."""
    q = quantized
    paths = q["j_scales"].keys() if calibrated else None
    j_tree = jax_export.quantize_variables_int8(q["variables"], paths)
    got = export.quantize_state_int8(q["port"].state_dict(),
                                     q["scales"].keys() if calibrated
                                     else None)
    want = export._jax_int8_state(j_tree, q["port"])  # port layout
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
    n_int8 = sum(1 for k in traverse_util.flatten_dict(j_tree)
                 if k[-1] == "__int8__")
    assert sum(k.endswith(export.INT8_SUFFIX) for k in got) == n_int8 > 0
    tconv = [k for k in got if ".ConvTranspose_" in k]
    if q["name"] == "bifpn_pr":
        assert tconv and all(k.endswith(export.INT8_SUFFIX)
                             or k.endswith(export.SCALE_SUFFIX)
                             for k in tconv) != calibrated
    # the inverse gives back float weights within half a step
    back = export.dequantize_state_int8(got)
    for key, value in q["port"].state_dict().items():
        if key + export.INT8_SUFFIX in got:
            step = got[key + export.SCALE_SUFFIX].max()
            assert (back[key] - value).abs().max() <= step / 2 + 1e-6
        else:
            assert torch.equal(back[key], value)


def test_calibration_equals_jax(quantized):
    """Same module paths; scales within rtol 1e-5 (NHWC sample order)."""
    q = quantized
    assert sorted(q["scales"]) == sorted(q["j_scales"])
    for path, s in q["j_scales"].items():
        np.testing.assert_allclose(q["scales"][path], s, rtol=1e-5,
                                   err_msg=path)


def _int8_pair(q):
    j_int8 = jq.Int8Module(q["j_model"], q["j_scales"])
    j_vars = jax_export.quantize_variables_int8(q["variables"],
                                                q["j_scales"].keys())
    port = create_model(q["arch"], device="cpu", **q["kw"])
    int8_state = export.quantize_state_int8(q["port"].state_dict(),
                                            q["scales"].keys())
    tq.quantize_model(port, int8_state, q["scales"])
    return j_int8, j_vars, port.eval()


def test_int8_conv_count_equals_jax(quantized):
    """The int8 products of one forward, counted as the JAX package
    counts the jaxpr's int8 equations; the transposed convs and every
    module without a scale keep their float compute."""
    from torch import nn

    q = quantized
    j_int8, j_vars, port = _int8_pair(q)
    x = q["batches"][0][:1]
    want = jq.int8_conv_count(
        lambda v, im: j_int8.apply(v, im, **APPLY_KW), j_vars,
        jnp.asarray(x))
    got = tq.int8_conv_count(port, _nchw(x), **export.FORWARD_KW)
    assert got == want > 0
    names = {n for n, m in port.named_modules()
             if isinstance(m, (tq.Int8Conv2d, tq.Int8Linear))}
    assert {n.replace(".", "/") for n in names} <= set(q["scales"])
    for n, m in port.named_modules():
        if isinstance(m, nn.ConvTranspose2d):
            assert m.weight.dtype == torch.float32
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            assert n not in names
    if q["name"] == "bifpn_pr":
        assert not any(n.startswith("semantic") for n in names)


def test_modules_without_scale_or_int8_weight_fall_through(quantized):
    """A module whose weight is int8 in the artifact but has no scale
    computes in float32 from the dequantized weight; a module with a
    scale whose weight stayed float (too small) keeps its float weight."""
    from torch import nn

    q = quantized
    int8_state = export.quantize_state_int8(q["port"].state_dict())
    big = sorted(k[: -len(export.INT8_SUFFIX) - len(".weight")]
                 for k in int8_state if k.endswith(export.INT8_SUFFIX)
                 and ".ConvTranspose_" not in k)
    small = sorted(p for p in q["scales"]
                   if p.replace("/", ".") + ".weight" in int8_state)
    assert big and small
    scales = {p: s for p, s in q["scales"].items() if p != big[0]
              .replace(".", "/")}
    port = create_model(q["arch"], device="cpu", **q["kw"])
    tq.quantize_model(port, int8_state, scales)
    dequant = export.dequantize_state_int8(int8_state)
    for name in (big[0], small[0].replace("/", ".")):
        mod = port.get_submodule(name)
        # not swapped: a float layer (the port's compute-dtype
        # subclasses of nn.Conv2d / nn.Linear), no int8 module
        assert isinstance(mod, (nn.Conv2d, nn.Linear)), name
        assert not isinstance(mod, (tq.Int8Conv2d, tq.Int8Linear)), name
        assert torch.equal(mod.weight, dequant[name + ".weight"]), name
    out = port(_nchw(q["batches"][0]), **export.FORWARD_KW)
    assert torch.isfinite(out["sem_logits"]).all()


def test_int8_model_matches_int8module(quantized):
    """Whole-model int8 forward against Int8Module.apply: the input codes
    of every int8 module compared call by call (flipped-code share under
    FLIP_SHARE), the outputs within OUT_TOL of max |value|, the hardened
    semantic maps equal but for SEM_FLIPS of the pixels."""
    q = quantized
    j_int8, j_vars, port = _int8_pair(q)
    x = np.random.default_rng(11).normal(
        0, 1, (2, q["side"], q["side"], 1)).astype(np.float32)

    j_codes = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        path = "/".join(mod.path)
        if (context.method_name == "__call__"
                and isinstance(mod, (fnn.Conv, fnn.Dense))
                and path in q["j_scales"]
                and jq._int8_kernel(jq._get_params(mod)) is not None):
            xq = jq._quantize_act(args[0], q["j_scales"][path])
            if xq.ndim == 4:
                xq = jnp.transpose(xq, (0, 3, 1, 2))
            j_codes.setdefault(path, []).append(np.asarray(xq))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        want = j_int8.apply(j_vars, x, **APPLY_KW)

    codes = {}

    def hook(name):
        def pre(module, args):
            codes.setdefault(name, []).append(
                module.quantize_input(args[0]).numpy())
        return pre

    handles = [m.register_forward_pre_hook(hook(n.replace(".", "/")))
               for n, m in port.named_modules()
               if isinstance(m, (tq.Int8Conv2d, tq.Int8Linear))]
    with torch.inference_mode():
        got = port(_nchw(x), **export.FORWARD_KW)
    for h in handles:
        h.remove()

    assert sorted(codes) == sorted(j_codes)
    flipped = total = worst = 0
    for path, calls in j_codes.items():
        assert len(codes[path]) == len(calls), path
        for a, b in zip(codes[path], calls):
            assert a.shape == b.shape, path
            diff = a.astype(np.int32) - b.astype(np.int32)
            worst = max(worst, int(np.abs(diff).max()))
            flipped += int(np.count_nonzero(diff))
            total += diff.size
    share = flipped / total
    print(f"{q['name']}: {flipped} of {total} int8 codes flipped "
          f"({share:.2e}), largest change {worst}")
    assert share < FLIP_SHARE

    for key in ("sem_logits", "ctr_hmp", "offsets"):
        if key not in want:
            continue
        a = np.asarray(want[key])
        b = got[key].permute(0, 2, 3, 1).numpy()
        scale = float(np.abs(a).max())
        assert a.shape == b.shape and scale > 1e-3, key
        np.testing.assert_allclose(b, a, rtol=0, atol=OUT_TOL * scale,
                                   err_msg=key)
    sem_a = np.asarray(jax.nn.sigmoid(want["sem_logits"])) > 0.5
    sem_b = torch.sigmoid(got["sem_logits"]).permute(0, 2, 3, 1).numpy() \
        > 0.5
    assert np.mean(sem_a != sem_b) < SEM_FLIPS


def test_drift_record_equals_jax(quantized):
    """export's drift record against the JAX package's on the same
    calibration batches."""
    q = quantized
    want = jax_export._measure_int8_drift(q["j_model"], q["variables"],
                                          q["j_scales"], q["batches"])
    int8_state = export.quantize_state_int8(q["port"].state_dict(),
                                            q["scales"].keys())
    got = export._measure_int8_drift(q["port"], int8_state, q["scales"],
                                     [_nchw(b) for b in q["batches"]])
    assert got["batches"] == want["batches"] == 2
    assert abs(got["sem_iou"] - want["sem_iou"]) <= 2e-3
    assert abs(got["center_count_rel"] - want["center_count_rel"]) <= 0.02
