"""The inference cells' head fit (``portbench.fit_heads``) on the CPU at a
tiny size: the ridge solution recovers a linear map, the targets follow
the labels, and a fit of a small MitoNet writes heads that
``weights.bench_state`` loads into the same model. The seeded states
that the cells run on are those of the commit before reference modules
and named heads keys came in, bit for bit."""

import copy
import hashlib
import json

import numpy as np
import pytest

from portbench import fit_heads, weights
from portbench.drivers import train, volume
from portbench.drivers.train import state_shapes
from portbench.spec import HERE


def test_ridge_recovers_a_linear_map():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    w = rng.normal(size=(6, 2)).astype(np.float32)
    got = fit_heads.ridge(x, x @ w, lam=1e-9)
    assert np.allclose(got, w, atol=1e-4)


def test_targets_follow_the_labels():
    lab = np.zeros((32, 32), np.uint32)
    lab[8:16, 4:12] = 5
    sem, ctr, off = fit_heads.head_targets([lab], 32, 32)
    assert sem.shape == (1, 8, 8) and off.shape == (1, 8, 8, 2)
    assert sem[0, 2:4, 1:3].all() and sem.sum() == 4
    assert ctr[0].max() > 0.8 and ctr[0, 7, 7] < 0.1
    # offsets point at the centroid (2.5, 1.5 at 1/4), in full units
    assert np.allclose(off[0, 2, 1], [2, 2]) and np.allclose(
        off[0, 3, 2], [-2, -2])


def test_fit_of_a_small_mitonet_loads(tmp_path, monkeypatch):
    cfg = json.loads((HERE / "configs" / "mitonet.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["encoder"].update(name="regnety_200mf", widths=[24, 56, 152, 368],
                          depths=[1, 1, 4, 7], groups=[3, 7, 19, 46],
                          se=False)
    cfg["recipe"]["MODEL"].update(encoder="regnety_200mf", fpn_dim=32,
                                  fpn_layers=1)
    monkeypatch.setattr(fit_heads, "FIT_SLICES", 2)
    heads, report = fit_heads.fit(cfg, "cpu", size=128)
    assert heads["sem_kernel"].shape == (1, 1, 32, 1)
    assert heads["off_kernel"].shape == (1, 1, 32, 2)
    assert heads["pr_kernel"].shape == (33, 1)
    assert 0.0 <= report["sem_iou"] <= 1.0
    path = tmp_path / "heads.npz"
    np.savez(path, **heads)
    num_fc = cfg["recipe"]["MODEL"]["num_fc"]
    state = weights.bench_state(state_shapes(cfg), path, num_fc)
    assert np.allclose(state["ins_xy.Conv_0.weight"].numpy()[:, :, 0, 0],
                       heads["off_kernel"][0, 0].T)


def _state_digest(state):
    digest = hashlib.sha256()
    for key in sorted(state):
        t = state[key]
        digest.update(key.encode())
        digest.update(str(t.dtype).encode())
        digest.update(str(tuple(t.shape)).encode())
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


# computed with this file's ``_state_digest`` at commit e1dfcf7, the
# parent of the change that opened the reference modules and the named
# heads keys
PINNED = {
    "bench_mitonet":
        "305ac0c5dcce4ec1cf5d4de598af6ab789dc93cb3bc802ddff9e14570aab7a49",
    "train_mitonet_tiny":
        "940f37fdd79e7a5493f8665b18409c3a82ebd607d88f051d99a3eeb3ac958ae9",
    "train_pdlpr":
        "d7069d30f67eee15c49a9477ade5dffe57405bfcfd30316e5c01ea1760740c20",
}


@pytest.mark.parametrize("state", sorted(PINNED))
def test_seeded_states_are_pinned(tiny, state):
    if state == "bench_mitonet":
        cfg = json.loads((HERE / "configs" / "mitonet.json").read_text())
        got = volume.bench_weights(cfg)
    else:
        config = "mitonet" if state == "train_mitonet_tiny" else "pdlpr"
        got = train.make_weights(tiny(config).config, 2**31 + 3, "cpu")
    assert _state_digest(got) == PINNED[state]
