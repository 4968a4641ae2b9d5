"""Port parity of ``empanada_torch.entry`` (the counterpart of the root
``__graft_entry__.py``) and ``FusedStackEngine.infer_stack`` on the CPU.

- ``entry``'s ``fn(params, image)`` on the tiny flagship carries the
  JAX ``_flagship(tiny=True)`` variables across with ``flax_to_torch``
  and equals the JAX eval forward within float32 tolerance: absolute
  1e-4 of the largest |value| of each output (the tolerance of
  ``test_torch_models.py``); it equals the module's own forward bit for
  bit and goes through ``torch.export``.
- ``dryrun_multichip(2, device="cpu")`` (two gloo ranks, a CPU mesh of
  two) passes, its step numbers within ``DDP_TOL``, and its consensus
  equals the JAX ``run_inference3d`` of the synthetic model with the
  same arguments exactly; at world 1 it runs in one process.
- ``compare_steps`` rejects a step with one number perturbed past its
  tolerance.
- ``infer_stack`` equals the JAX engine's ``infer_stack`` on the
  synthetic twins slice for slice and run for run, the run-budget
  overflow included.
"""

import numpy as np
import pytest
import torch

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import __graft_entry__ as graft
from empanada_tpu.cli.infer3d import run_inference3d as jax_run_inference3d
from empanada_tpu.inference.fused import FusedStackEngine as JaxEngine
from empanada_torch import entry as entry_mod
from empanada_torch.data import VolumeDataset
from empanada_torch.inference.fused import FusedStackEngine
from empanada_torch.synthetic import SyntheticModule
from empanada_torch.weights import flax_to_torch
from tests.synthetic import SyntheticModule as JaxSyntheticModule
from tests.test_torch_models import _randomize
from tests.test_torch_stack import _DS, _blob_volume

CPU = torch.device("cpu")
REL_TOL = 1e-4
OUTPUT_KEYS = ("sem_logits", "ctr_hmp", "offsets")


@pytest.fixture(scope="module")
def flagship():
    """The JAX tiny flagship's eval forward and the port's ``fn``, each
    with the JAX init's variables on the example zero image, and with
    those variables redrawn so that every layer carries signal
    (``test_torch_models._randomize``) on a seeded image."""
    flax_model, variables, x0 = graft._flagship(tiny=True)
    model, image = entry_mod._flagship(tiny=True, device="cpu")
    assert tuple(image.shape) == (1, 1) + x0.shape[1:3]
    fn = entry_mod.eval_forward(model)
    x = np.random.default_rng(7).normal(0, 1, x0.shape).astype(np.float32)
    cases = {"init, zero image": (variables, x0),
             "redrawn, seeded image": (_randomize(variables, seed=3), x)}
    want, got, params = {}, {}, {}
    for case, (v, image) in cases.items():
        want[case] = flax_model.apply(v, image, train=False, render_steps=2,
                                      interpolate_ins=False)
        params[case] = flax_to_torch(v, expect=model)
        with torch.no_grad():
            got[case] = fn(params[case],
                           torch.from_numpy(image).permute(0, 3, 1, 2))
    return {"model": model, "fn": fn, "params": params["redrawn, seeded "
                                                       "image"],
            "want": want, "got": got, "x": x}


@pytest.mark.parametrize("key", OUTPUT_KEYS)
def test_entry_fn_matches_the_jax_flagship_forward(flagship, key):
    for case, want in flagship["want"].items():
        a = np.asarray(want[key])
        b = flagship["got"][case][key].permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape, (case, key)
        scale = np.abs(a).max()
        if case.startswith("redrawn"):
            assert scale > 0.05, (key, scale)  # real signal
        np.testing.assert_allclose(b, a, rtol=0, atol=REL_TOL * scale,
                                   err_msg=f"{case} {key}")


def test_entry_fn_equals_the_module_forward_and_exports(flagship):
    model, fn, params = flagship["model"], flagship["fn"], flagship["params"]
    x = torch.from_numpy(flagship["x"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        model.load_state_dict(params)
        want = model(x, render_steps=2, interpolate_ins=False)
        got = fn(params, x)

        class Forward(torch.nn.Module):
            def forward(self, params, image):
                return fn(params, image)

        program = torch.export.export(Forward(), (params, x))
        exported = program.module()(params, x)
    for key in OUTPUT_KEYS:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(exported[key], want[key]), key


def test_entry_gives_the_full_width_flagship():
    fn, (params, image) = entry_mod.entry(device="cpu")
    assert tuple(image.shape) == (1, 1, 256, 256)
    assert image.dtype == torch.float32 and image.device == CPU
    n = sum(t.numel() for k, t in params.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked")))
    assert n == 32_057_292  # MitoNet at full width (PERF.md section 4)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert callable(fn)


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dryrun_two():
    return entry_mod.dryrun_multichip(2, device="cpu")


def _same_instances(got, want):
    assert sorted(got) == sorted(want)
    for label, attrs in want.items():
        assert tuple(got[label]["box"]) == tuple(attrs["box"]), label
        np.testing.assert_array_equal(got[label]["starts"], attrs["starts"])
        np.testing.assert_array_equal(got[label]["runs"], attrs["runs"])


def test_dryrun_two_ranks_step_within_the_jax_tolerances(dryrun_two):
    assert dryrun_two["world"] == 2 and dryrun_two["backend"] == "gloo"
    assert dryrun_two["devices"] == [CPU, CPU]
    train = dryrun_two["train"]
    assert np.isfinite(train["loss"])
    for key, tol in entry_mod.DDP_TOL.items():
        assert train[key] <= tol, (key, train[key])


def test_dryrun_consensus_equals_the_jax_run(dryrun_two):
    """The mesh run's consensus equals the JAX package's single-device
    ``run_inference3d`` of the synthetic model at the dry run's
    arguments (``__graft_entry__._dryrun_inference_impl``)."""
    kwargs = dict(labels=[1], thing_list=[1], mode="orthoplane", qlen=3,
                  label_divisor=100, block_size=4, padding_factor=16,
                  max_centers=64, min_size=4, min_span=1, pixel_vote_thr=2,
                  progress=False)
    want = jax_run_inference3d((JaxSyntheticModule(), {}),
                               entry_mod._ellipsoid(), **kwargs)
    assert len(want[1].instances) >= 1
    _same_instances(dryrun_two["instances"], want[1].instances)


def test_dryrun_world_one_runs_in_one_process(dryrun_two):
    one = entry_mod.dryrun_multichip(1, device="cpu")
    assert one["world"] == 1 and one["devices"] == [CPU]
    assert one["train"]["grad_rel_l2"] == 0.0
    assert one["train"]["param_abs"] == 0.0
    _same_instances(one["instances"], dryrun_two["instances"])


def test_dryrun_refuses_an_empty_world():
    with pytest.raises(ValueError, match="n >= 1"):
        entry_mod.dryrun_multichip(0, device="cpu")


@pytest.fixture(scope="module")
def step():
    """A real step record of the tiny recipe on one CPU process."""
    return entry_mod._train_step(entry_mod._dryrun_config(1),
                                 entry_mod._dryrun_batch(1), CPU)


def _perturbed(record, what):
    out = {"loss": record["loss"], "grads": dict(record["grads"]),
           "state": dict(record["state"])}
    if what == "loss_rel":
        out["loss"] = record["loss"] * (1 + 1e-4)
    elif what == "grad_rel_l2":
        name = max(out["grads"], key=lambda n: float(out["grads"][n].norm()))
        out["grads"][name] = out["grads"][name] * 1.01
    elif what == "bn_abs":
        name = next(k for k in out["state"] if k.endswith("running_var"))
        out["state"][name] = out["state"][name] + 1e-3
    elif what == "param_abs":
        name = sorted(out["grads"])[0]
        out["state"][name] = out["state"][name] + 1e-2
    return out


def test_compare_steps_accepts_the_same_step(step):
    nums, ok = entry_mod.compare_steps(_perturbed(step, None), step)
    assert ok and all(v == 0.0 for v in nums.values()), nums


@pytest.mark.parametrize("what", sorted(entry_mod.DDP_TOL))
def test_compare_steps_rejects_a_perturbed_step(step, what):
    nums, ok = entry_mod.compare_steps(_perturbed(step, what), step)
    assert not ok
    assert nums[what] > entry_mod.DDP_TOL[what], nums
    assert all(nums[k] <= entry_mod.DDP_TOL[k] for k in nums
               if k != what), nums


def test_compare_steps_rejects_a_missing_gradient(step):
    got = _perturbed(step, None)
    got["grads"]["extra.weight"] = torch.zeros(1)
    assert not entry_mod.compare_steps(got, step)[1]


# ---------------------------------------------------------------------------
# FusedStackEngine.infer_stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_size, upsampling, max_runs", [
    (4, 1, None), (8, 1, None), (4, 2, None), (4, 1, 3)])
def test_infer_stack_matches_jax(block_size, upsampling, max_runs):
    vol = _blob_volume(seed=20 + block_size + upsampling, d=9, h=30, w=27)
    # at upsampling f the engine takes slices downsampled by f, and its
    # maps come back at the original slice shape
    ds = VolumeDataset(vol, axis=0, scale=upsampling) if upsampling > 1 \
        else _DS(vol)
    kwargs = dict(thing_list=[1], label_divisor=100, stuff_area=0,
                  median_kernel_size=3, padding_factor=16, max_centers=64,
                  block_size=block_size, max_runs=max_runs,
                  device_norms={"mean": 0.5, "std": 0.2})
    want = list(JaxEngine(JaxSyntheticModule(), {}, **kwargs)
                .infer_stack(ds, upsampling))
    got = list(FusedStackEngine(SyntheticModule(), None, device="cpu",
                                **kwargs).infer_stack(ds, upsampling))
    assert [z for z, _, _ in got] == [z for z, _, _ in want] \
        == list(range(len(vol)))
    overflow = 0
    for (z, pan, runs), (_, want_pan, want_runs) in zip(got, want):
        want_pan = np.asarray(want_pan)
        assert pan.shape == want_pan.shape == vol.shape[1:], z
        np.testing.assert_array_equal(pan, want_pan, err_msg=str(z))
        assert int(runs[3]) == int(want_runs[3]), z
        overflow += int(runs[3]) > len(runs[0])
        for a, b in zip(runs[:3], want_runs[:3]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=str(z))
    assert (overflow > 0) == (max_runs is not None), overflow


def test_batch_norm_of_one_value_a_channel_matches_flax():
    """A train-mode batch norm over one value a channel (the tiny
    MitoNet's 1x1 BiFPN level at a global batch of 1, the dry run at
    world 1) normalizes to the bias and moves the running statistics as
    flax's ``BatchNorm`` does (torch's own batch norm refuses it)."""
    import flax.linen as fnn

    from empanada_torch.models.blocks import BN_EPS, BN_MOMENTUM, bn

    rng = np.random.default_rng(9)
    c = 6
    x = rng.normal(0, 1, (1, 1, 1, c)).astype(np.float32)
    params = {"scale": rng.normal(1, 0.1, c).astype(np.float32),
              "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
             "var": (1 + rng.random(c)).astype(np.float32)}
    want, mut = fnn.BatchNorm(use_running_average=False,
                              momentum=1 - BN_MOMENTUM, epsilon=BN_EPS).apply(
        {"params": params, "batch_stats": stats}, x,
        mutable=["batch_stats"])
    m = bn(c).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(params["scale"]))
        m.bias.copy_(torch.from_numpy(params["bias"]))
        m.running_mean.copy_(torch.from_numpy(stats["mean"]))
        m.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = m(xt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    assert torch.isfinite(xt.grad).all()
