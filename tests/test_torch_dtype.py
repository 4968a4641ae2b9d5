"""Port parity of the compute dtype (``MODEL.dtype``): the port's
bfloat16 MitoNet against the JAX package's ``PanopticBiFPNPR(dtype=
bfloat16)`` on the same weights and inputs (the tiny MitoNet:
regnety_200mf, fpn_layers=1, 128^2, seeded random variables of realistic
scale, converted by ``flax_to_torch``).

bfloat16 keeps 8 significant bits, and XLA and torch round at other
places (their convolutions sum in other orders before the one rounding
of each output), so the two bfloat16 forwards are compared with stated
tolerances, and each against its own float32 forward:

- the center heatmap and offsets (convolutions only) within ``MAX_TOL``
  of the float32 output's max |value| (measured 1.0-1.2e-2);
- the rendered semantic logits by their mean absolute difference,
  ``MEAN_TOL`` of max |value| (measured 2.2e-3): PointRend re-predicts
  the most uncertain points, and in bfloat16 the uncertainty's ties and
  roundings select partly other points in the two packages, so single
  pixels differ by a whole refinement (as bfloat16 differs from float32
  within each package, measured 0.55 of max |value| in both);
- the port's bfloat16 error against its float32 forward (relative L2)
  within ``ERR_RATIO`` times the JAX package's.

The fused stack engine in bfloat16 against the JAX engine in bfloat16
(same weights, same volume) is held by voxel agreement: near a
threshold the rounding flips a semantic pixel or moves a center, which
relabels or reshapes an instance, so the maps cannot be equal voxel for
voxel; their agreement is held to the size of each package's own
bfloat16-against-float32 difference (measured: foreground 0.993, ids
0.942; the JAX package's own bfloat16 against float32 0.992 / 0.969).

Exact: a float32 model equals one built without ``dtype``; ties in the
bfloat16 top-k go to the lower index as in ``lax.top_k``; a bfloat16
descriptor (either package's) loads as the bfloat16 model, and the
port's exported program (``.pt2``) runs the bfloat16 forward; the
block's FLOP count is the same in either dtype; the int8
convolution in a bfloat16 model returns its input's dtype as the JAX
``Int8Module`` does; the trainer's model keeps float32 compute under a
bfloat16 recipe (its step equals the float32 recipe's on the CPU).
"""

import pytest

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from empanada_tpu import export as jax_export
from empanada_tpu.inference.fused import FusedStackEngine as JaxEngine
from empanada_tpu.models import create_model as flax_create_model
from empanada_tpu.models import quantization as jq
from empanada_tpu.models.blocks import ConvBNAct as JaxConvBNAct
from empanada_torch import export
from empanada_torch.data.synthetic import synthetic_em_volume
from empanada_torch.inference.fused import FusedStackEngine
from empanada_torch.models import create_model
from empanada_torch.models import quantization as tq
from empanada_torch.models.blocks import ConvBNAct, set_compute_dtype
from empanada_torch.models.point_rend import (
    get_uncertain_point_coords_on_grid,
    topk_lower_index,
)
from empanada_torch.train import Trainer
from empanada_torch.weights import flax_to_torch
from tests import test_torch_train
from tests.test_torch_models import TINY, _randomize
from tests.test_torch_stack import _DS, _collect

SIDE = 128
MODEL_CONFIG = dict(arch="PanopticBiFPNPR", **TINY)
FORWARD_KW = dict(render_steps=2, interpolate_ins=False)
MAX_TOL = 0.03
MEAN_TOL = 0.01
ERR_RATIO = 2.0
FG_AGREE = 0.98
ID_AGREE = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the small CPU forwards: beside other test
    workers, more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """{dtype: flax model}, the randomized variables, {dtype: the port's
    model on those weights}."""
    flax_models = {dt: flax_create_model("PanopticBiFPNPR", dtype=dt, **TINY)
                   for dt in ("float32", "bfloat16")}
    shapes = jax.eval_shape(lambda: flax_models["float32"].init(
        {"params": jax.random.key(0), "points": jax.random.key(1),
         "dropout": jax.random.key(2)},
        np.zeros((1, SIDE, SIDE, 1), np.float32), train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, _randomize(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), shapes), seed=3))
    ports = {}
    for dt in flax_models:
        ports[dt] = create_model("PanopticBiFPNPR", device="cpu", dtype=dt,
                                 **TINY)
        ports[dt].load_state_dict(flax_to_torch(variables,
                                                expect=ports[dt]))
    return flax_models, variables, ports


def _port_forward(model, x):
    with torch.inference_mode():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), **FORWARD_KW)
    return {k: v.permute(0, 2, 3, 1).float().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def forwards(tiny):
    """{(package, dtype): NHWC float32 outputs} on one seeded batch."""
    flax_models, variables, ports = tiny
    x = np.random.default_rng(4).normal(0, 1, (2, SIDE, SIDE, 1)) \
        .astype(np.float32)
    out = {}
    for dt, model in flax_models.items():
        got = jax.jit(lambda v, x, m=model: m.apply(
            v, x, train=False, **FORWARD_KW))(variables, x)
        out["jax", dt] = {k: np.asarray(v.astype(jnp.float32))
                          for k, v in got.items()}
        out["port", dt] = _port_forward(ports[dt], x)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("key", ["sem_logits", "ctr_hmp", "offsets"])
def test_bf16_forward_matches_jax(forwards, key):
    j16, p16 = forwards["jax", "bfloat16"][key], \
        forwards["port", "bfloat16"][key]
    j32, p32 = forwards["jax", "float32"][key], \
        forwards["port", "float32"][key]
    scale = float(np.abs(j32).max())
    assert j16.shape == p16.shape and scale > 0.05, key
    diff = np.abs(p16 - j16)
    if key == "sem_logits":
        assert diff.mean() <= MEAN_TOL * scale, (key, diff.mean() / scale)
    else:
        assert diff.max() <= MAX_TOL * scale, (key, diff.max() / scale)
    # each bfloat16 forward against its own float32 one
    port_err, jax_err = _rel_l2(p16, p32), _rel_l2(j16, j32)
    assert 0 < port_err <= ERR_RATIO * jax_err, (key, port_err, jax_err)


def test_bf16_model_computes_in_bf16_with_float32_parameters(tiny):
    _, _, ports = tiny
    model = ports["bfloat16"]
    assert all(t.dtype == torch.float32
               for t in model.state_dict().values() if t.is_floating_point())
    dtypes = {m.compute_dtype for m in model.modules()
              if hasattr(m, "compute_dtype")}
    assert dtypes == {torch.bfloat16}
    x = torch.zeros((1, 1, SIDE, SIDE))
    with torch.inference_mode():
        out = model(x, **FORWARD_KW)
    assert {v.dtype for v in out.values()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="dtype"):
        create_model("PanopticBiFPNPR", device="cpu", dtype="float16",
                     **TINY)


@pytest.mark.parametrize("name", ["float32", "fp32"])
def test_float32_equals_the_model_built_without_dtype(tiny, name):
    _, _, ports = tiny
    state = ports["float32"].state_dict()
    plain = create_model("PanopticBiFPNPR", device="cpu", **TINY)
    named = create_model("PanopticBiFPNPR", device="cpu", dtype=name, **TINY)
    plain.load_state_dict(state)
    named.load_state_dict(state)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (1, 1, SIDE, SIDE)).astype(np.float32))
    with torch.inference_mode():
        want = plain(x, **FORWARD_KW)
        got = named(x, **FORWARD_KW)
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key


def test_bf16_topk_ties_go_to_lower_index():
    """bfloat16 uncertainties tie often: the port's stable top-k and its
    grid points equal lax.top_k's on the same bfloat16 values."""
    rng = np.random.default_rng(6)
    values = (np.round(rng.random((2, 24, 20)) * 5) / 5 - 0.5) \
        .astype(np.float32)
    j16 = jnp.asarray(values, jnp.bfloat16)
    t16 = torch.from_numpy(values).to(torch.bfloat16)
    want = np.asarray(lax.top_k(j16.reshape(2, -1), 100)[1])
    got = topk_lower_index(t16.reshape(2, -1), 100)[1]
    assert len(np.unique(values)) < 10  # many ties
    np.testing.assert_array_equal(got.numpy(), want)
    idx, coords = get_uncertain_point_coords_on_grid(t16[:, None], 100)
    np.testing.assert_array_equal(idx.numpy(), want)
    assert coords.dtype == torch.float32


@pytest.mark.parametrize("package", ["jax", "port"])
def test_bf16_descriptor_loads_as_bf16_model(tmp_path, tiny, package):
    _, variables, ports = tiny
    config = dict(MODEL_CONFIG, dtype="bfloat16")
    if package == "jax":
        jax_export.export_model(variables, config, str(tmp_path), "m")
    else:
        # with the exported program, which traces the bfloat16 forward
        export.export_model(flax_to_torch(variables), config,
                            str(tmp_path), "m", stablehlo=True,
                            input_shape=(1, SIDE, SIDE, 1))
    model, desc = export.load_exported_model(str(tmp_path / "m.yaml"),
                                             device="cpu")
    assert desc["model_config"]["dtype"] == "bfloat16"
    assert {m.compute_dtype for m in model.modules()
            if hasattr(m, "compute_dtype")} == {torch.bfloat16}
    x = np.random.default_rng(7).normal(0, 1, (1, SIDE, SIDE, 1)) \
        .astype(np.float32)
    want = _port_forward(ports["bfloat16"], x)
    got = _port_forward(model, x)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if package == "port":
        program = torch.export.load(str(tmp_path / "m.pt2")).module()
        with torch.no_grad():
            out = program(torch.from_numpy(x).permute(0, 3, 1, 2))
        for key in want:
            assert out[key].dtype == torch.bfloat16, key
            np.testing.assert_array_equal(
                out[key].permute(0, 2, 3, 1).float().numpy(), want[key],
                err_msg=key)


def test_fused_engine_bf16_agrees_with_jax(tiny):
    flax_models, variables, ports = tiny
    vol, _ = synthetic_em_volume((10, SIDE, SIDE), n_instances=12, seed=7,
                                 overlap=False)
    kwargs = dict(thing_list=[1], label_divisor=1000, median_kernel_size=3,
                  padding_factor=128, max_centers=64, block_size=4,
                  device_norms={"mean": 0.57, "std": 0.12})

    def maps(blocks):
        got = _collect(blocks, len(vol))
        return np.stack([got[z][0] for z in range(len(vol))])

    want = maps(JaxEngine(flax_models["bfloat16"], variables, **kwargs)
                .infer_blocks(_DS(vol)))
    engine = FusedStackEngine(ports["bfloat16"], None, device="cpu",
                              **kwargs)
    got = maps(engine.infer_blocks(_DS(vol)))
    fg = want > 0
    assert 0.2 < fg.mean() < 0.9 and len(np.unique(want)) > 2
    assert np.mean((got > 0) == fg) >= FG_AGREE
    assert np.mean(got == want) >= ID_AGREE
    # the block's FLOP count does not depend on the compute dtype
    engine32 = FusedStackEngine(ports["float32"], None, device="cpu",
                                **kwargs)
    maps(engine32.infer_blocks(_DS(vol)))
    flops = engine.block_cost_analysis()["flops"]
    assert flops > 0 and flops == engine32.block_cost_analysis()["flops"]


class _Conv(torch.nn.Module):
    """One ConvBNAct, as the int8 swap finds it inside a model."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x):
        return self.block(x)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_int8_conv_in_bf16_model_casts_back_like_int8module(in_dtype):
    """A bfloat16 ConvBNAct with an int8 convolution: the int8 product is
    cast back to its input's dtype (float32 for a model's first layer,
    bfloat16 inside it), then batch norm in float32 and the block's
    output in bfloat16, as the JAX Int8Module runs it."""
    rng = np.random.default_rng(8)
    jmod = JaxConvBNAct(32, 3, dtype=jnp.bfloat16)
    x = rng.normal(0, 1, (2, 12, 12, 32)).astype(np.float32)
    init = jmod.init(jax.random.key(0), x)
    variables = jax.tree_util.tree_map(np.asarray, _randomize(init, 9))
    scale = float(np.abs(x).max()) / 127.0
    jx = jnp.asarray(x, getattr(jnp, in_dtype))
    qvars = jax_export.quantize_variables_int8(variables, ["Conv_0"])
    want = jq.Int8Module(jmod, {"Conv_0": scale}).apply(qvars, jx)

    port = _Conv(ConvBNAct(32, 32, 3)).eval()
    port.block.load_state_dict(flax_to_torch(variables,
                                             expect=port.block))
    set_compute_dtype(port, "bfloat16")
    state = {f"block.{k}": v for k, v in port.block.state_dict().items()}
    tq.quantize_model(port,
                      export.quantize_state_int8(state, ["block/Conv_0"]),
                      {"block/Conv_0": scale})
    assert isinstance(port.block.Conv_0, tq.Int8Conv2d)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, in_dtype))
    with torch.inference_mode():
        product = port.block.Conv_0(tx)
        got = port(tx)
    assert product.dtype == tx.dtype
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want.astype(jnp.float32)))


def test_trainer_keeps_float32_compute_under_a_bf16_recipe():
    """MODEL.dtype bfloat16 trains under autocast on the card; the
    trainer's model itself computes in float32, so on the CPU its step
    equals the float32 recipe's bit for bit."""
    results = []
    for dtype in ("bfloat16", "float32"):
        config = test_torch_train._config()
        config["MODEL"]["dtype"] = dtype
        trainer = Trainer(config, device="cpu")
        trainer.init_state(test_torch_train.STEPS_PER_EPOCH)
        assert trainer.amp_dtype is None
        assert {m.compute_dtype for m in trainer.model.modules()
                if hasattr(m, "compute_dtype")} == {torch.float32}
        aux = trainer.train_step(test_torch_train._batch(20))
        results.append(({k: float(v) for k, v in aux.items()},
                        trainer.model.state_dict()))
    (aux16, state16), (aux32, state32) = results
    assert aux16 == aux32
    for key in state32:
        assert torch.equal(state16[key], state32[key]), key
