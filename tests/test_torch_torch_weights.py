"""Reference torch weights into the port (``train/torch_weights.py``),
held against the JAX package's ``train/torch_weights.py``.

No reference modules exist here, so each test builds a reference-layout
state dict from the JAX tree's leaves in the reference's registration
order: torch-style keys (``m{i}.weight``; batch norms with weight, bias,
running_mean, running_var and num_batches_tracked), torch layouts
(OIHW, transposed convs (in, out, kh, kw), PointRend's Conv1d (out, in,
1)), a ``fc.`` classification head the converters skip, a ``module.``
prefix they strip, and one tensor under two keys (the reference BiFPN's
shared after-combine conv). Conversions are compared key for key and
bit for bit."""

import pytest

for _dep in ("jax", "flax"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import numpy as np
import torch
from flax import traverse_util
from torch import nn

from empanada_tpu.models import create_model as j_create_model
from empanada_tpu.train import torch_weights as jtw
from empanada_torch.models import MODELS, create_model
from empanada_torch.train import torch_weights as ttw
from empanada_torch.weights import flax_to_torch
from tests.test_torch_models import TINY as BIFPN_TINY
from tests.test_torch_pdl import TINY as PDL_TINY

RNGS = {"params": jax.random.key(0), "points": jax.random.key(1),
        "dropout": jax.random.key(2)}
CASES = {
    "bifpn_pr": ("PanopticBiFPNPR", dict(BIFPN_TINY), 128),
    "pdl_pr": ("PanopticDeepLabPR", dict(PDL_TINY, ins_decoder=True), 64),
    "pdl_bc": ("PanopticDeepLabBC", dict(PDL_TINY), 64),
}


def _randomize(variables, seed):
    """Seeded values of realistic scale (kernels at 1 / sqrt(fan-in)),
    in the tree's own key order (the converters pair by order: no pytree
    map, which sorts keys)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, a in traverse_util.flatten_dict(variables).items():
        a = np.asarray(a)
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


def reference_layout(variables, prefix="module.", head=True, alias=True):
    """A reference-layout torch state dict of a flax variables tree, in
    the reference's registration order (see the module docstring)."""
    flat_p = traverse_util.flatten_dict(variables["params"])
    flat_s = traverse_util.flatten_dict(variables.get("batch_stats", {}))
    order = jtw._registration_order(list(flat_p))
    bn_params = [p[:-1] for p in order if p[-1] == "scale"]
    bn_stats = [p[:-1] for p in jtw._registration_order(list(flat_s))
                if p[-1] == "mean"]
    assert bn_params == bn_stats  # one order for both kinds
    names, sd, aliased = {}, {}, False
    for path in order:
        mod, leaf = path[:-1], path[-1]
        v = np.asarray(flat_p[path], np.float32)
        in_bn = any("BatchNorm" in seg for seg in mod)
        names.setdefault(mod, f"{'bn' if in_bn else 'm'}{len(names)}")
        base = prefix + names[mod]
        if in_bn:
            sd[f"{base}.{'weight' if leaf == 'scale' else 'bias'}"] = \
                torch.from_numpy(v.copy())
            if leaf == "bias":
                for stat in ("mean", "var"):
                    sd[f"{base}.running_{stat}"] = torch.from_numpy(
                        np.array(flat_s[mod + (stat,)], np.float32))
                sd[f"{base}.num_batches_tracked"] = torch.tensor(7)
            continue
        if leaf == "kernel" and v.ndim == 4:
            if any("ConvTranspose" in seg for seg in mod):
                w = v[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                w = v.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            w = v.T[:, :, None]  # Dense <- Conv1d(kernel_size=1)
        else:
            w = v
        key = {"kernel": "weight", "fusion_weights": "weights"}.get(leaf,
                                                                     leaf)
        t = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{base}.{key}"] = t
        if alias and not aliased and "after" in mod and leaf == "kernel":
            sd[f"{base}_shared.{key}"] = t  # one tensor, two keys
            aliased = True
    if head:
        sd[prefix + "fc.weight"] = torch.ones(2, 8)
        sd[prefix + "fc.bias"] = torch.zeros(2)
    return sd


def scripted(sd):
    """A TorchScript module whose state dict is ``sd`` (buffers)."""
    root = nn.Identity()
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        m = root
        for name in mods:
            if not hasattr(m, name):
                m.add_module(name, nn.Identity())
            m = getattr(m, name)
        m.register_buffer(leaf, t)
    return torch.jit.script(root)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, kw, side = CASES[request.param]
    j_model = j_create_model(arch, **kw)
    variables = _randomize(
        j_model.init(RNGS, np.zeros((1, side, side, 1), np.float32),
                     train=False), seed=5)
    port = create_model(arch, device="cpu", **kw)
    return request.param, variables, port


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("alias", ["QuantizablePanopticDeepLab",
                                   "QuantizablePanopticDeepLabPR",
                                   "QuantizablePanopticBiFPN",
                                   "QuantizablePanopticBiFPNPR"])
def test_quantizable_aliases_build_the_plain_archs(alias):
    """The registry resolves the reference's quantizable arch names to
    the plain classes, as the JAX registry does."""
    from empanada_tpu.models import MODELS as J_MODELS

    plain = alias[len("Quantizable"):]
    assert MODELS[alias] is MODELS[plain]
    assert J_MODELS[alias] is J_MODELS[plain]
    kw = dict(BIFPN_TINY) if "BiFPN" in plain else dict(PDL_TINY)
    with torch.device("meta"):
        a = create_model(alias, device="meta", **kw)
        b = create_model(plain, device="meta", **kw)
    assert type(a) is type(b)
    assert list(a.state_dict()) == list(b.state_dict())
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}


def test_reference_conversion_matches_jax(case, tmp_path):
    """convert_reference_state_dict == the JAX package's
    convert_encoder_state_dict followed by flax_to_torch, key for key and
    bit for bit, with the same matched count and no leftovers."""
    name, variables, port = case
    path = str(tmp_path / "ref.pth")
    torch.save(reference_layout(variables), path)
    sd, norms = ttw.load_torch_state_dict(path)
    j_sd, j_norms = jtw.load_torch_state_dict(path)
    assert norms is None and j_norms is None
    assert list(sd) == list(j_sd) and not any(
        k.startswith("module.") for k in sd)

    params, stats, j_report = jtw.convert_encoder_state_dict(
        j_sd, variables["params"], variables.get("batch_stats", {}))
    want = flax_to_torch({"params": params, "batch_stats": stats})
    got, report = ttw.convert_reference_state_dict(sd, port)
    assert report == j_report
    assert report["leftover"] == {} and report["matched"] > 0
    _assert_same_state(got, want)
    # and the round trip gives back the variables the layout came from
    _assert_same_state(got, flax_to_torch(variables))
    # a state dict in the port's order converts as the module does
    got_sd, _ = ttw.convert_reference_state_dict(sd, port.state_dict())
    _assert_same_state(got_sd, want)
    port.load_state_dict(got)


def test_inverse_conversion_matches_jax(case):
    """convert_to_reference_state_dict == the JAX package's
    convert_flax_to_torch_state_dict, bit for bit: template-only entries
    keep the template's values, the aliased key mirrors the shared
    tensor."""
    name, variables, port = case
    zeros = traverse_util.unflatten_dict({
        k: np.zeros_like(v)
        for k, v in traverse_util.flatten_dict(variables).items()})
    template = reference_layout(zeros, prefix="")
    want, j_report = jtw.convert_flax_to_torch_state_dict(
        template, variables["params"], variables.get("batch_stats"))
    port.load_state_dict(flax_to_torch(variables))
    got, report = ttw.convert_to_reference_state_dict(template, port)
    assert report == j_report and report["leftover"] == {}
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    shared = [k for k in got if "_shared." in k]
    assert len(shared) == (name == "bifpn_pr")
    for key in shared:
        assert torch.equal(got[key], got[key.replace("_shared", "")])
    assert torch.equal(got["fc.weight"], template["fc.weight"])
    # forward then inverse is the identity on the reference tensors
    back, _ = ttw.convert_reference_state_dict(got, port)
    _assert_same_state(back, flax_to_torch(variables))


def test_mismatches_raise(case):
    name, variables, port = case
    sd = reference_layout(variables, prefix="")
    conv = next(k for k, v in sd.items() if v.ndim == 4)
    bad = dict(sd, **{conv: torch.zeros(sd[conv].shape[:-1] + (9,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ttw.convert_reference_state_dict(bad, port)
    var = [k for k in sd if k.endswith("running_var")][-1]
    short = {k: v for k, v in sd.items() if k != var}
    with pytest.raises(ValueError, match="ran out of var"):
        ttw.convert_reference_state_dict(short, port)
    last = [k for k, v in sd.items() if v.ndim == 4][-1]
    template = {k: v for k, v in sd.items() if k != last}
    with pytest.raises(ValueError, match="ran out of kernel"):
        ttw.convert_to_reference_state_dict(template, port)


def test_torchscript_archive_loads_like_torch_save(tmp_path):
    """A torch.jit.save archive of a module holding the tensors is
    detected and gives the same dict as the plain torch.save, aliasing
    included; both packages agree."""
    arch, kw, side = CASES["bifpn_pr"]
    variables = _randomize(j_create_model(arch, **kw).init(
        RNGS, np.zeros((1, side, side, 1), np.float32), train=False), 6)
    sd = reference_layout(variables)
    plain, archive = str(tmp_path / "plain.pth"), str(tmp_path / "ts.pth")
    torch.save(sd, plain)
    torch.jit.save(scripted(sd), archive)
    assert ttw._is_torchscript_archive(archive)
    assert not ttw._is_torchscript_archive(plain)
    a, norms_a = ttw.load_torch_state_dict(archive)
    b, norms_b = ttw.load_torch_state_dict(plain)
    assert norms_a is None and norms_b is None
    _assert_same_state(a, b)
    j_a, _ = jtw.load_torch_state_dict(archive)
    _assert_same_state(a, j_a)
    shared = next(k for k in a if "_shared." in k)
    assert a[shared].data_ptr() == a[shared.replace("_shared", "")] \
        .data_ptr()
    port = create_model(arch, device="cpu", **kw)
    got_a, _ = ttw.convert_reference_state_dict(a, port)
    got_b, _ = ttw.convert_reference_state_dict(b, port)
    _assert_same_state(got_a, got_b)


def test_encoder_pretraining_loads_a_cem_checkpoint(tmp_path):
    """A CEM-style encoder checkpoint ({"state_dict", "norms"}) loads as
    the JAX package loads it, and the trainer takes its norms."""
    from empanada_tpu.train.torch_weights import load_encoder_pretraining
    from empanada_torch.train import Trainer
    from tests.test_torch_train_fit import TINY as TRAIN_TINY
    from tests.test_torch_train_fit import _config

    cfg = dict(TRAIN_TINY)
    j_model = j_create_model(cfg.pop("arch"), **cfg)
    variables = _randomize(j_model.init(
        RNGS, np.zeros((1, 128, 128, 1), np.float32), train=False), 7)
    encoder = {"params": variables["params"]["encoder_mod"],
               "batch_stats": variables["batch_stats"]["encoder_mod"]}
    path = str(tmp_path / "cem.pth.tar")
    torch.save({"state_dict": reference_layout(encoder, head=True,
                                               alias=False),
                "norms": (0.61, 0.17)}, path)

    new_vars, j_norms = load_encoder_pretraining(variables, path)
    want = flax_to_torch({"params": new_vars["params"]["encoder_mod"],
                          "batch_stats":
                              new_vars["batch_stats"]["encoder_mod"]})
    trainer = Trainer(_config(encoder_pretraining=path), device="cpu")
    trainer.init_state(4)
    got = trainer.model.encoder_mod.state_dict()
    _assert_same_state(got, want)
    assert trainer.norms == j_norms == {"mean": 0.61, "std": 0.17}
