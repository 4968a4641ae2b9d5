"""The traffic generator and the seeded weights are functions of the
seed; the targets are those of the images."""

import pytest
import torch

from portbench import gen, weights
from portbench.drivers import train

SEED = 2**31 + 12345


def _pool(tiny, seed):
    cell = tiny("mitonet")
    return gen.training_pool(cell.traffic,
                             cell.config["recipe"]["DATASET"]["norms"],
                             seed, "cpu")


def test_pool_is_deterministic_in_the_seed(tiny):
    a, b, c = _pool(tiny, SEED), _pool(tiny, SEED), _pool(tiny, SEED + 1)
    for i in range(len(a)):
        for k in a.batches[i]:
            assert torch.equal(a.batches[i][k], b.batches[i][k])
        assert torch.equal(a.coords[i], b.coords[i])
    assert not torch.equal(a.batches[0]["image"], c.batches[0]["image"])


def test_targets_match_the_images(tiny):
    pool = _pool(tiny, 7)
    images = torch.cat([b["image"] for b in pool.batches])
    assert len({tuple(x.flatten()[:64].tolist()) for x in images}) \
        == len(images)
    for b in pool.batches:
        fg = b["sem"] > 0
        assert fg.any(1).any(1).all()
        assert torch.all(b["offsets"][~fg] == 0)
        peak = b["ctr_hmp"].amax((1, 2, 3))
        assert torch.allclose(peak, torch.ones_like(peak))
        # an offset points from a pixel into the image
        n, h, w, _ = b["offsets"].shape
        yy = torch.arange(h)[None, :, None]
        cy = yy + b["offsets"][..., 0]
        assert torch.all((cy[fg] >= 0) & (cy[fg] <= h - 1))
    coords = torch.cat(pool.coords)
    assert coords.min() >= 0 and coords.max() < 1


@pytest.mark.parametrize("config", ["mitonet", "pdlpr"])
def test_weights_cover_every_leaf_and_repeat(tiny, config):
    cfg = tiny(config).config
    shapes = train.state_shapes(cfg)
    for name in shapes:
        weights.rule_for(name)
    a = train.make_weights(cfg, SEED, "cpu")
    b = train.make_weights(cfg, SEED, "cpu")
    assert list(a) == list(shapes)
    assert all(torch.equal(a[k], b[k]) for k in a)
    conv = next(k for k in a if weights.rule_for(k) == "kaiming_normal"
                and a[k].ndim == 4 and a[k].numel() > 5000)
    fan_out = a[conv].shape[0] * a[conv][0, 0].numel()
    assert abs(a[conv].std().item() / (2.0 / fan_out) ** 0.5 - 1) < 0.1


def test_volume_is_the_programs_synthetic_volume():
    import numpy as np

    from empanada_torch.data.synthetic import synthetic_em_volume

    for overlap in (True, False):
        p = {"shape": [16, 48, 40], "instances": 9, "overlap": overlap}
        vol, gt = gen.em_volume(p, SEED)
        want = synthetic_em_volume((16, 48, 40), 9, seed=SEED,
                                   overlap=overlap)
        assert np.array_equal(vol, want[0]) and np.array_equal(gt, want[1])
    other, _ = gen.em_volume(p, SEED + 1)
    assert not np.array_equal(vol, other)
