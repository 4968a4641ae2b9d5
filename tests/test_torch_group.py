"""Nearest-center grouping: the plain version (chunked and not) against
the JAX package on the CPU, the wrapper's argument checks, and, on a
card, the CUDA kernel against the plain version (ids identical).

Inputs come from seeded numpy generators. The JAX side is imported
inside the CPU tests, so the card tests of this file also run where JAX
is not installed.
"""

import numpy as np
import pytest
import torch

from empanada_torch.ops import group

SPECIAL = (np.nan, np.inf, -np.inf, 1e6, -1e6)


def _inputs(rng, b, h, w, k, step, mask="random", special=True):
    """(B, K, 2) int32 centers, (B, K) bool valid, (B, H, W, 2) float32
    offsets. Slice i's valid fraction cycles through 0.5, 0.3, 1, 0;
    masks are random subsets or valid prefixes. Offsets are half-pixel
    quantized (exact distance ties) with NaN, +-inf and +-1e6 at a few
    pixels."""
    centers = rng.integers(0, max(h, w), (b, k, 2)).astype(np.int32)
    valid = np.zeros((b, k), bool)
    for i in range(b):
        frac = (0.5, 0.3, 1.0, 0.0)[i % 4]
        n = max(1, round(k * frac)) if frac else 0
        idx = rng.permutation(k)[:n] if mask == "random" else np.arange(n)
        valid[i, idx] = True
    offsets = (np.round(rng.standard_normal((b, h, w, 2)) * 6 * step * 2)
               / 2).astype(np.float32)
    if special:
        flat = offsets.reshape(b, h * w, 2)
        for i in range(b):
            at = rng.choice(h * w, len(SPECIAL), replace=False)
            for j, val in enumerate(SPECIAL):
                flat[i, at[j], (i + j) % 2] = val
    return centers, valid, offsets


def _jax_group(centers, valid, offsets, step):
    jnp = pytest.importorskip("jax.numpy")
    from empanada_tpu.ops import postprocess as jpost

    return np.stack([np.asarray(jpost.group_pixels(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(o), step=step,
        use_pallas=False)) for c, v, o in zip(centers, valid, offsets)])


def _plain(centers, valid, offsets, step, **kw):
    return group.group_pixels_plain(
        torch.from_numpy(centers), torch.from_numpy(valid),
        torch.from_numpy(offsets), step, **kw).numpy()


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("mask", ["random", "prefix"])
@pytest.mark.parametrize("step", [1.0, 4.0])
def test_plain_matches_jax_on_nonfinite_and_huge_offsets(step, mask, chunk):
    """NaN offsets take the first valid center (argmin's first NaN),
    +-inf and 1e6 offsets the first invalid slot (1e10 < their
    distances), chunked over K or not."""
    rng = np.random.default_rng(11)
    b, h, w, k = 4, 24, 20, 64
    centers, valid, offsets = _inputs(rng, b, h, w, k, step, mask)
    want = _jax_group(centers, valid, offsets, step)
    kw = {} if chunk is None else {"slab_elements": b * h * w * chunk}
    got = _plain(centers, valid, offsets, step, **kw)
    np.testing.assert_array_equal(got, want)
    nan_px = np.isnan(offsets).any(-1) & valid.any(1)[:, None, None]
    first_valid = 1 + valid.argmax(1)
    assert (got[nan_px] == np.broadcast_to(
        first_valid[:, None, None], got.shape)[nan_px]).all()


@pytest.mark.parametrize("chunk", [1, 7, 100, 2047])
def test_chunked_plain_equals_unchunked_and_jax_at_k2048(chunk):
    rng = np.random.default_rng(12)
    b, h, w, k, step = 2, 16, 24, 2048, 4.0
    centers, valid, offsets = _inputs(rng, b, h, w, k, step, "random")
    want = _jax_group(centers, valid, offsets, step)
    whole = _plain(centers, valid, offsets, step)
    chunked = _plain(centers, valid, offsets, step,
                     slab_elements=b * h * w * chunk)
    np.testing.assert_array_equal(whole, want)
    np.testing.assert_array_equal(chunked, want)


def test_wrapper_takes_any_k_and_rejects_bad_arguments():
    def args(k, b=1, h=5, w=6):
        return (torch.zeros((b, k, 2), dtype=torch.int32),
                torch.ones((b, k), dtype=torch.bool),
                torch.zeros((b, h, w, 2)))

    for k in (1, 1025, 2048):
        group.check_inputs(*args(k))
    out = group.group_pixels_batched(*args(2048), 4.0)
    assert out.shape == (1, 5, 6) and bool((out == 1).all())
    with pytest.raises(ValueError, match="at least one center"):
        group.group_pixels_batched(*args(0), 4.0)
    c, v, o = args(4)
    with pytest.raises(TypeError, match="dtypes"):
        group.group_pixels_batched(c.long(), v, o, 4.0)
    with pytest.raises(TypeError, match="valid"):
        group.group_pixels_batched(c, v.float(), o, 4.0)
    with pytest.raises(ValueError, match="contiguous"):
        group.group_pixels_batched(
            c, v, torch.zeros((1, 6, 5, 2)).transpose(1, 2), 4.0)
    with pytest.raises(ValueError, match="shapes"):
        group.group_pixels_batched(c, v[:, :3].contiguous(), o, 4.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _kernel_vs_plain(centers, valid, offsets, step):
    want = _plain(centers, valid, offsets, step)
    dev = [torch.from_numpy(a).cuda() for a in (centers, valid, offsets)]
    got = group.group_pixels_batched(*dev, step).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    return group.tile_stats(*dev, step)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1.0, 4.0])
@pytest.mark.parametrize("k", [1, 7, 256, 1000, 2048])
def test_kernel_matches_plain_on_card(k, step):
    """Random and prefix masks, half-pixel ties, NaN / inf / 1e6 offsets,
    a grid that is not a multiple of the 8x32 tile, and a multiple."""
    _card()
    rng = np.random.default_rng(13)
    pruned = 0
    for mask in ("random", "prefix"):
        for h, w in ((33, 47), (64, 96)):
            for special in (True, False):
                stats = _kernel_vs_plain(
                    *_inputs(rng, 4, h, w, k, step, mask, special), step)
                pruned += stats["pruned"]
    assert pruned > 0


@pytest.mark.cuda
def test_kernel_crowded_tile_scans_exhaustively():
    """2048 valid centers packed next to the pixels overflow a tile's
    candidate list: the tile scans the whole table, ids still exact."""
    _card()
    rng = np.random.default_rng(14)
    b, h, w, k, step = 2, 8, 32, 2048, 1.0
    centers = rng.integers(0, 8, (b, k, 2)).astype(np.int32)
    valid = np.ones((b, k), bool)
    offsets = (np.round(rng.standard_normal((b, h, w, 2)) * 4) / 2
               ).astype(np.float32)
    stats = _kernel_vs_plain(centers, valid, offsets, step)
    assert stats["exhaustive"] == b and stats["pruned"] == 0
