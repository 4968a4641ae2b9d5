"""Port parity of the Panoptic-DeepLab family: ResNet encoders (resnet18,
a [1, 1, 1, 1] bottleneck, and a grouped one) at output strides 16 and
32, ASPP, the decoder, and PanopticDeepLab / PR / BC in eval mode with
and without the instance decoder, converted from seeded flax variables
by flax_to_torch(expect=); train mode (dropout 0) with the JAX draw's
PointRend points: outputs and the updated BN statistics; the six new
RegNet configs' parameter shapes against jax.eval_shape of the JAX
init; the registry on all 17 encoders; init_train_'s distributions;
and the per-slice 3D engines (z-median), end() included.

Tolerance: 1e-4 of each output's max |value| (float32, another
summation order in the convolutions); integer outputs exactly.
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

from empanada_tpu.inference import engines as je
from empanada_tpu.models import create_model as j_create_model
from empanada_tpu.models.decoders.aspp import ASPP as JASPP
from empanada_tpu.models.decoders.panoptic_deeplab import (
    PanopticDeepLabDecoder as JDecoder,
)
from empanada_tpu.models.encoders import regnet as j_regnet
from empanada_tpu.models.encoders.resnet import (
    ResNet as JResNet,
    ResNetConfig as JResNetConfig,
)
from empanada_torch.inference import engines as te
from empanada_torch.models import MODELS, create_model
from empanada_torch.models.decoders.aspp import ASPP
from empanada_torch.models.decoders.panoptic_deeplab import (
    PanopticDeepLabDecoder,
)
from empanada_torch.models.encoders import ENCODERS, regnet
from empanada_torch.models.encoders.resnet import ResNet, ResNetConfig
from empanada_torch.synthetic import SyntheticModule
from empanada_torch.weights import flax_to_torch
from tests.synthetic import SyntheticModule as JaxSyntheticModule
from tests.test_torch_models import _randomize
from tests.test_torch_stack import _FineTwin, _JaxFineTwin

REL_TOL = 1e-4
RNGS = {"params": jax.random.key(0), "points": jax.random.key(1),
        "dropout": jax.random.key(2)}
TINY = dict(encoder="resnet18", num_classes=1, decoder_channels=32,
            low_level_stages=[3, 1], low_level_channels_project=[16, 8],
            atrous_rates=[1, 2], train_num_points=16,
            subdivision_num_points=64)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several pytest workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _close(got, want, label):
    """got NCHW torch, want NHWC jax/numpy."""
    want = np.asarray(want)
    got = got.detach().permute(0, 2, 3, 1).numpy() if got.ndim == 4 \
        else got.detach().numpy()
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 1e-3, (label, scale)  # real signal
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * scale,
                               err_msg=label)


def _pair(j_module, t_module, x, seed=3):
    variables = _randomize(j_module.init(RNGS, x, train=False), seed)
    t_module.load_state_dict(flax_to_torch(variables, expect=t_module))
    return variables, t_module.eval()


# each arch at both output strides, with and without the instance
# decoder, over the six cases
@pytest.mark.parametrize("arch,stride,ins", [
    ("PanopticDeepLab", 16, True), ("PanopticDeepLab", 32, False),
    ("PanopticDeepLabPR", 16, False), ("PanopticDeepLabPR", 32, True),
    ("PanopticDeepLabBC", 16, True), ("PanopticDeepLabBC", 32, False)])
def test_eval_forward_matches_jax(arch, stride, ins):
    kw = dict(TINY, stage4_stride=stride, ins_decoder=ins)
    x = np.random.default_rng(4).normal(0, 1, (2, 64, 64, 1)) \
        .astype(np.float32)
    j_model = j_create_model(arch, **kw)
    variables, t_model = _pair(j_model, create_model(arch, device="cpu",
                                                     **kw), x)
    keys = {"PanopticDeepLabBC": ["sem_logits", "cnt_logits"]}.get(
        arch, ["sem_logits", "ctr_hmp", "offsets"])
    for interpolate_ins in (True, False):
        want = j_model.apply(variables, x, train=False,
                             interpolate_ins=interpolate_ins)
        with torch.no_grad():
            got = t_model(_nchw(x), interpolate_ins=interpolate_ins)
        assert sorted(got) == sorted(want) == sorted(keys)
        for key in keys:
            _close(got[key], want[key], f"{key} {interpolate_ins}")
        if arch == "PanopticDeepLab":
            break  # no PointRend: interpolate_ins changes nothing


# after test_eval_forward_matches_jax (its compiled ops are reused);
# resnet18 at stride 32 runs there
@pytest.mark.parametrize("cfg,output_stride", [
    (dict(layers=[2, 2, 2, 2], block="basic"), 16),
    (dict(layers=[1, 1, 1, 1], block="bottleneck"), 32),
    (dict(layers=[1, 1, 1, 1], block="bottleneck"), 16),
    (dict(layers=[1, 1, 1, 1], block="bottleneck", groups=4,
          width_per_group=8), 16)],
    ids=["resnet18-16", "bottleneck-32", "bottleneck-16", "grouped-16"])
def test_resnet_pyramid_matches_jax(cfg, output_stride):
    x = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 1)) \
        .astype(np.float32)
    j_mod = JResNet(cfg=JResNetConfig(**cfg), output_stride=output_stride)
    t_mod = ResNet(ResNetConfig(**cfg), output_stride=output_stride)
    variables, t_mod = _pair(j_mod, t_mod, x)
    want = j_mod.apply(variables, x, train=False)
    with torch.no_grad():
        got = t_mod(_nchw(x))
    strides = [4, 4, 8, 16, output_stride]
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[-1] == 64 // strides[i]
        _close(g, w, f"p{i + 1}")


def test_aspp_and_decoder_match_jax():
    """On their own, at the shapes TINY's resnet18 gives them at stride
    16 (so the JAX package's compiled ops are reused)."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 4, 4, 512)).astype(np.float32)
    j_aspp = JASPP(32, (1, 2), dropout_p=0.5)
    variables, t_aspp = _pair(j_aspp, ASPP(512, 32, (1, 2), 0.5), x)
    with torch.no_grad():
        _close(t_aspp(_nchw(x)), j_aspp.apply(variables, x), "aspp")

    chans = [64, 64, 128, 256, 512]
    pyramid = [rng.normal(0, 1, (2, s, s, c)).astype(np.float32)
               for s, c in zip([16, 16, 8, 4, 4], chans)]
    j_dec = JDecoder(decoder_channels=32, low_level_stages=(3, 1),
                     low_level_channels_project=(16, 8),
                     atrous_rates=(1, 2))
    t_dec = PanopticDeepLabDecoder(
        chans, decoder_channels=32, low_level_stages=(3, 1),
        low_level_channels_project=(16, 8), atrous_rates=(1, 2))
    variables, t_dec = _pair(j_dec, t_dec, pyramid)
    with torch.no_grad():
        _close(t_dec([_nchw(p) for p in pyramid]),
               j_dec.apply(variables, pyramid), "decoder")


@pytest.mark.parametrize("arch", ["PanopticDeepLabPR", "PanopticDeepLabBC"])
def test_train_forward_and_bn_statistics_match_jax(arch):
    """Train mode with dropout 0 and the JAX draw's points: every output
    and the updated batch-norm statistics."""
    kw = dict(TINY, stage4_stride=16, ins_decoder=True, aspp_dropout=0.0)
    x = np.random.default_rng(5).normal(0, 1, (2, 64, 64, 1)) \
        .astype(np.float32)
    j_model = j_create_model(arch, **kw)
    variables, t_model = _pair(j_model, create_model(arch, device="cpu",
                                                     **kw), x)
    want, updates = j_model.apply(variables, x, train=True,
                                  mutable=["batch_stats"], rngs=RNGS)
    if arch == "PanopticDeepLabPR":
        coords = torch.from_numpy(np.array(want["point_coords"]))
    else:
        coords = tuple(torch.from_numpy(np.array(want[k])) for k in
                       ("sem_point_coords", "cnt_point_coords"))
    t_model.train()
    got = t_model(_nchw(x), point_coords=coords)
    assert sorted(got) == sorted(want)
    for key in want:
        g = got[key]
        _close(g, want[key], key)
    stats = flax_to_torch({"batch_stats": jax.tree_util.tree_map(
        np.asarray, dict(updates["batch_stats"]))})
    state = t_model.state_dict()
    n = 0
    for key, w in stats.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(
            state[key].numpy(), w.numpy(), rtol=0,
            atol=REL_TOL * float(w.abs().max()), err_msg=key)
        n += 1
    assert n > 40


def _param_shapes(tree):
    return {"/".join(p): tuple(v.shape)
            for p, v in traverse_util.flatten_dict(tree).items()}


@pytest.mark.parametrize("name", ["regnetx_6p4gf", "regnety_800mf",
                                  "regnety_3p2gf", "regnety_4gf",
                                  "regnety_8gf", "regnety_16gf"])
def test_new_regnet_shapes_match_jax_eval_shape(name):
    """The parameter tree's shapes from jax.eval_shape of the JAX init
    (no compute) against the port's module built on the meta device;
    SE where the JAX config has it."""
    j_mod = getattr(j_regnet, name)()
    x = jax.ShapeDtypeStruct((1, 64, 64, 1), np.float32)
    shapes = jax.eval_shape(lambda x: j_mod.init(jax.random.key(0), x), x)
    with torch.device("meta"):
        t_mod = getattr(regnet, name)()
    want = {k: v for k, v in flax_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes)),
        expect=t_mod).items()}
    got = t_mod.state_dict()
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    assert t_mod.cfg.use_se == j_mod.cfg.use_se
    assert any("SqueezeExcite" in k for k in got) == j_mod.cfg.use_se


def test_registry_serves_every_encoder_and_arch():
    assert len(ENCODERS) == 17
    assert sorted(MODELS) == ["PanopticBiFPN", "PanopticBiFPNPR",
                              "PanopticDeepLab", "PanopticDeepLabBC",
                              "PanopticDeepLabPR", "QuantizablePanopticBiFPN",
                              "QuantizablePanopticBiFPNPR",
                              "QuantizablePanopticDeepLab",
                              "QuantizablePanopticDeepLabPR"]
    for encoder in ENCODERS:
        for arch in ("PanopticDeepLab", "PanopticDeepLabPR",
                     "PanopticDeepLabBC"):
            # built on the meta device: shapes only, no memory
            with torch.device("meta"):
                model = create_model(arch, device="meta", encoder=encoder,
                                     stage4_stride=16, dtype="bfloat16")
            chans = model.encoder_mod.out_channels
            aspp = model.semantic_decoder.ASPP_0
            assert aspp.Conv_0.in_channels == chans[-1], (arch, encoder)
            assert (model.instance_decoder is None) and \
                hasattr(model, "boundary_head") == (arch == "PanopticDeepLabBC")


def test_flax_to_torch_places_the_stem_and_raises_on_strays():
    j_mod = JResNet(cfg=JResNetConfig(layers=[1, 1, 1, 1], block="basic"))
    x = np.zeros((1, 32, 32, 1), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, j_mod.init(RNGS, x))
    t_mod = ResNet(ResNetConfig(layers=[1, 1, 1, 1], block="basic"))
    state = flax_to_torch(variables, expect=t_mod)
    np.testing.assert_array_equal(
        state["stem.weight"].numpy(),
        variables["params"]["stem"]["kernel"].transpose(3, 2, 0, 1))
    stray = {"params": {"head": {"kernel": np.zeros((1, 1, 2, 3))}}}
    with pytest.raises(KeyError, match="cannot map kernel"):
        flax_to_torch(stray)
    del variables["params"]["layer1_block1"]
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch(variables, expect=t_mod)


def test_train_init_matches_jax_statistics():
    """init_train_ on PDL-BC (ResNet convs, ASPP and decoder convs at
    std 0.001, heads, PointRend): zero leaves exactly zero, constant
    leaves equal, the std of every random leaf of at least 256 values
    within 10% of the JAX init's."""
    kw = dict(TINY, stage4_stride=16, ins_decoder=True)
    j_model = j_create_model("PanopticDeepLabBC", **kw)
    init = j_model.init(RNGS, np.zeros((2, 64, 64, 1), np.float32),
                        train=False)
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(init)))
    got = create_model("PanopticDeepLabBC", device="cpu", seed=0,
                       init="train", **kw).state_dict()
    n_random = 0
    for key, w in want.items():
        g = got[key]
        if not w.is_floating_point():
            continue
        w_std = float(w.std()) if w.numel() > 1 else 0.0
        if w_std == 0.0:
            assert torch.equal(g, w), key
        elif w.numel() >= 256:
            n_random += 1
            assert abs(float(g.std()) / w_std - 1) < 0.1, key
            assert abs(float(g.mean())) < 0.2 * w_std + 1e-6, key
    assert n_random > 20


def _blob_slices(seed, d=7, h=40, w=44):
    rng = np.random.default_rng(seed)
    vol = np.zeros((d, h, w), np.float32)
    zz, yy, xx = np.mgrid[:d, :h, :w]
    for _ in range(3):
        cz, cy, cx = rng.uniform(0, d), rng.uniform(8, h - 8), \
            rng.uniform(8, w - 8)
        vol[((zz - cz) / 3) ** 2 + ((yy - cy) / 6) ** 2
            + ((xx - cx) / 7) ** 2 <= 1] = 1.0
    return vol + rng.normal(0, 0.1, vol.shape).astype(np.float32)


KW3D = dict(thing_list=[1], label_divisor=100, stuff_area=0,
            max_centers=64, median_kernel_size=3)


@pytest.mark.parametrize("engine", ["PanopticDeepLabEngine3d",
                                    "PanopticDeepLabRenderEngine3d"])
def test_3d_engines_match_jax_per_slice(engine):
    """Slice by slice: None while the window fills, the median-filtered
    middle slice after, then end()'s slices: panoptic ids equal."""
    vol = _blob_slices(6)
    if engine == "PanopticDeepLabEngine3d":
        # full-resolution centers and offsets (interpolate_ins=True)
        j_model = je.JittedModel(_JaxFineTwin(), {})
        t_model = te.EvalModel(_FineTwin())
        call = {}
    else:
        j_model = je.JittedModel(JaxSyntheticModule(), {})
        t_model = te.EvalModel(SyntheticModule())
        call = {"padding_factor": 16}
    j_engine = je.create_engine(engine, j_model, **KW3D, **call)
    t_engine = te.create_engine(engine, t_model, device="cpu", **KW3D,
                                **call)
    got, want = [], []
    for img in vol:
        if engine == "PanopticDeepLabEngine3d":
            w, g = j_engine(img[None, :, :, None]), t_engine(img)
        else:
            w = j_engine(img[None, :, :, None], img.shape)
            g = t_engine(img, img.shape)
        assert (w is None) == (g is None)
        if w is not None:
            want.append(np.asarray(w))
            got.append(g.numpy())
    want += [np.asarray(p) for p in j_engine.end()]
    got += [p.numpy() for p in t_engine.end()]
    assert len(got) == len(want) == len(vol)
    assert max(int(w.max()) for w in want) > 100
    for z, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=str(z))
