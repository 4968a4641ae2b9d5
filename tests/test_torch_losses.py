"""Port parity of the training losses (losses.py): every part and
PanopticLoss for C in {1, 3}, with and without the PointRend term and
with an empty foreground, within 1e-6 of the JAX package's value (1e-6
relative for the composite); BCLoss is refused by name."""

import pytest

for _dep in ("jax", "optax"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import numpy as np
import torch

from empanada_tpu import losses as jl
from empanada_torch import losses as tl


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _case(seed, c, empty=False, n=2, h=24, w=20, p=17):
    rng = np.random.default_rng(seed)
    sem = rng.integers(0, c if c > 1 else 2, (n, h, w))
    if empty:
        sem[:] = 0
    out = {"sem_logits": rng.normal(0, 2, (n, h, w, c)),
           "ctr_hmp": rng.normal(0, 0.3, (n, h, w, 1)),
           "offsets": rng.normal(0, 5, (n, h, w, 2)),
           "sem_points": rng.normal(0, 2, (n, p, c)),
           "point_coords": rng.random((n, p, 2))}
    tgt = {"sem": sem.astype(np.float32 if c == 1 else np.int32),
           "ctr_hmp": rng.random((n, h, w, 1)),
           "offsets": rng.normal(0, 5, (n, h, w, 2))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    tgt = {k: v.astype(np.float32) if v.dtype == np.float64 else v
           for k, v in tgt.items()}
    return out, tgt


def _port(out, tgt):
    t_out = {k: _nchw(v) if v.ndim == 4 else torch.from_numpy(v)
             for k, v in out.items()}
    t_tgt = {"sem": torch.from_numpy(tgt["sem"]),
             "ctr_hmp": _nchw(tgt["ctr_hmp"]),
             "offsets": _nchw(tgt["offsets"])}
    return t_out, t_tgt


CASES = [(c, empty) for c in (1, 3) for empty in (False, True)]


@pytest.mark.parametrize("c, empty", CASES)
@pytest.mark.parametrize("pct", [0.2, 0.15, 1.0])
def test_bootstrap_ce(c, empty, pct):
    out, tgt = _case(1, c, empty)
    want = float(jl.bootstrap_ce(out["sem_logits"], tgt["sem"], pct))
    t_out, t_tgt = _port(out, tgt)
    got = float(tl.bootstrap_ce(t_out["sem_logits"], t_tgt["sem"], pct))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("c, empty", CASES)
def test_heatmap_offset_and_pointrend_parts(c, empty):
    out, tgt = _case(2, c, empty)
    t_out, t_tgt = _port(out, tgt)
    want = float(jl.heatmap_mse(out["ctr_hmp"], tgt["ctr_hmp"]))
    got = float(tl.heatmap_mse(t_out["ctr_hmp"], t_tgt["ctr_hmp"]))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))

    weights = (tgt["sem"] > 0)[..., None].astype(np.float32)
    want = float(jl.offset_l1(out["offsets"], tgt["offsets"], weights))
    got = float(tl.offset_l1(t_out["offsets"], t_tgt["offsets"],
                             _nchw(weights)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    if empty:
        assert got == 0.0

    want = float(jl.pointrend_loss(out["sem_points"], out["point_coords"],
                                   tgt["sem"]))
    got = float(tl.pointrend_loss(t_out["sem_points"],
                                  t_out["point_coords"], t_tgt["sem"]))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("c, empty", CASES)
@pytest.mark.parametrize("points", [True, False])
def test_panoptic_loss(c, empty, points):
    out, tgt = _case(3, c, empty)
    if not points:
        out = {k: v for k, v in out.items()
               if k not in ("sem_points", "point_coords")}
    kwargs = dict(ce_weight=1.0, mse_weight=200.0, l1_weight=0.01,
                  pr_weight=1.0, top_k_percent=0.2)
    want_total, want_aux = jl.PanopticLoss(**kwargs)(out, tgt)
    t_out, t_tgt = _port(out, tgt)
    got_total, got_aux = tl.PanopticLoss(**kwargs)(t_out, t_tgt)
    assert set(got_aux) == set(want_aux)
    for key, want in want_aux.items():
        want = float(want)
        assert abs(float(got_aux[key]) - want) <= 1e-6 * max(1.0, abs(want)), key
    assert abs(float(got_total) - float(want_total)) \
        <= 1e-6 * abs(float(want_total))


def test_nearest_point_labels_round_half_to_even():
    """Points at exact half-pixel positions pick the even neighbour, as
    jnp.round does."""
    labels = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4)
    coords = torch.tensor([[[0.25, 0.25], [0.5, 0.5], [0.75, 0.125]]])
    got = tl.point_sample_nearest(labels, coords)
    # x, y source = c * 4 - 0.5: (0.5, 0.5) -> (0, 0); (1.5, 1.5) -> (2, 2)
    assert got.tolist() == [[0.0, 10.0, 2.0]]


def test_create_loss_and_bc_refusal():
    assert isinstance(tl.create_loss("PanopticLoss"), tl.PanopticLoss)
    bc = tl.create_loss("BCLoss", top_k_percent=0.15)
    assert isinstance(bc, tl.BCLoss) and bc.top_k_percent == 0.15
    with pytest.raises(ValueError, match="unknown loss"):
        tl.create_loss("Nope")
