"""The block step with its per-block values on the device, and the CUDA
graph that replays it.

On the CPU: ``FusedStackEngine._block_step``, which reads block_start,
n and the crop from an int32 tensor and rewrites the median window's
carry in place, gives the pan maps and packed runs of the step that
took them as Python ints (kept below as the reference), block by block.

On the card (marker ``cuda``): the graph's blocks equal the eager
step's, on two passes that share one graph (the crop equal to the
padded slice and smaller, another n, streaming and resident), with
every block in flight at once; the counters and the grouping kernel's
launch count; a module that waits for the device falls back to the
eager step; replaced module tensors are captured anew.
"""

import numpy as np
import pytest
import torch

from empanada_torch.inference.fused import FusedStackEngine
from empanada_torch.ops import group
from empanada_torch.ops.postprocess import (
    find_instance_centers,
    group_pixels,
    harden_semantic,
    logits_to_prob,
    median_small,
    merge_semantic_and_instance_coarse,
)
from empanada_torch.ops.rle_device import extract_fg_runs
from empanada_torch.synthetic import SyntheticModule
from empanada_torch.utils import profiling

NORMS = {"mean": 0.5, "std": 0.2}


def _blob_volume(seed, d, h, w, n_blobs=4):
    """uint8 volume: bright ellipsoids on dim noise."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 100, (d, h, w)).astype(np.uint8)
    zz, yy, xx = np.mgrid[:d, :h, :w]
    for _ in range(n_blobs):
        cz, cy, cx = rng.uniform(0, d), rng.uniform(3, h - 3), \
            rng.uniform(3, w - 3)
        r = rng.uniform(2.5, max(3.0, h / 6))
        vol[((zz - cz) / 2.5) ** 2 + ((yy - cy) / r) ** 2
            + ((xx - cx) / r) ** 2 <= 1] = 250
    return vol


class _DS:
    def __init__(self, vol, size=None):
        self.vol, self.size = vol, size

    def __len__(self):
        return len(self.vol)

    def __getitem__(self, i):
        return {"index": i, "image": self.vol[i],
                "size": self.size or self.vol[i].shape}


# -- the step as it took its values on the host (the reference) --------


def _int_forward(engine, batch, p):
    oh, ow = p.crop
    ph, pw = p.pad_shape
    ny, nx = -(-oh // p.upsampling), -(-ow // p.upsampling)
    x = batch[:, None].float()
    x = (x / 255.0 - p.norms[0]) / p.norms[1]
    if ny < ph or nx < pw:
        ring = torch.zeros((ph, pw))
        ring[:min(ny, ph), :min(nx, pw)] = 1.0
        x = x * ring
    out = engine.module(x, render_steps=p.render_steps,
                        interpolate_ins=not engine.coarse_boundaries)
    return (logits_to_prob(out["sem_logits"]).float(),
            out["ctr_hmp"][:, 0].float(),
            out["offsets"].permute(0, 2, 3, 1).float())


def _int_postprocess(engine, sem_prob, ctr, off, p):
    oh, ow = p.crop
    scale = 4 * p.upsampling
    centers, valid = find_instance_centers(
        ctr, engine.nms_threshold, engine.nms_kernel, engine.max_centers)
    ins = group_pixels(centers, valid, off, step=4.0)
    ins = torch.where(valid.any(dim=1)[:, None, None], ins,
                      torch.zeros_like(ins))
    sem = harden_semantic(sem_prob, engine.confidence_thr)
    pan = merge_semantic_and_instance_coarse(
        sem, ins, scale, engine.label_divisor, p.table, engine.stuff_area,
        engine.void_label, engine.max_centers, p.num_classes)
    b, H, W = pan.shape
    if (H, W) != (oh, ow):
        rows = torch.arange(H)[:, None] < oh
        cols = torch.arange(W)[None, :] < ow
        pan = torch.where(rows & cols, pan, torch.zeros_like(pan))
    starts, ends, values, n_runs = extract_fg_runs(pan, p.max_runs)
    header = torch.stack([n_runs, torch.full_like(n_runs, oh),
                          torch.full_like(n_runs, ow)], dim=1)
    packed = torch.cat([header[:, None],
                        torch.stack([starts, ends, values], dim=-1)], dim=1)
    return pan, packed


def _int_step(engine, p, batch, block_start, carry):
    ks, mid, B = engine.ks, engine.mid, p.B
    sem, ctr, off = _int_forward(engine, batch, p)
    allsem = torch.cat([carry[0], sem])
    allctr = torch.cat([carry[1], ctr])
    alloff = torch.cat([carry[2], off])
    med = median_small(allsem.unfold(0, ks, 1)[:B], dim=-1)
    raw = allsem[mid:mid + B]
    z = torch.arange(block_start - mid, block_start - mid + B)
    use_median = (z >= mid) & (z < p.n - mid)
    emit = torch.where(use_median[:, None, None, None], med, raw)
    pan, packed = _int_postprocess(engine, emit, allctr[:B],
                                   alloff[:B].contiguous(), p)
    return pan, packed, (allsem[B:], allctr[B:], alloff[B:])


class _BrightBorder(SyntheticModule):
    """Each row averaged with the next, as a convolution would mix the
    crop's last row with the padding (so the normalized padding's value
    shows), then foreground on the last two rows and columns of the
    padded slice: in the margin where the crop is smaller, so only the
    margin's zeroing keeps it out of the runs."""

    def forward(self, images, render_steps=2, interpolate_ins=False):
        images = (images + torch.roll(images, -1, dims=-2)) / 2
        border = torch.zeros_like(images, dtype=torch.bool)
        border[..., -2:, :] = True
        border[..., :, -2:] = True
        return super().forward(torch.where(border, 1.0, images),
                               render_steps, interpolate_ins)


@pytest.mark.parametrize("shape,upsampling", [
    ((11, 32, 32), 1), ((11, 30, 27), 1), ((9, 30, 27), 2)],
    ids=["crop_is_pad", "crop_under_pad", "crop_under_pad_upsampled"])
def test_block_step_reads_its_values_from_the_device(shape, upsampling):
    """Every block (the first, a middle one, the last) of a pass: pan
    and packed equal the reference's, and the carry rewritten in place
    equals the one it hands on. Squares bright on the first, the
    second and the last slice alone (raw at the edges, median inside),
    the crop's last row bright (the pad mask and its rounding), an odd
    full-resolution crop and a module bright in the margin hold each
    value read on the device."""
    n, oh, ow = shape
    vol = _blob_volume(seed=sum(shape) + upsampling, d=n, h=oh, w=ow)
    for z, others, cols in ((0, (1,), slice(2, 9)),
                            (n - 1, (n - 2,), slice(2, 9)),
                            (1, (0, 2), slice(12, 19))):
        vol[z, 2:9, cols] = 250
        for other in others:
            vol[other, 2:9, cols] = 0
    vol[:, -1, :] = 250
    engine = FusedStackEngine(
        _BrightBorder(), None, [1], block_size=4, label_divisor=100,
        stuff_area=0, padding_factor=16, max_centers=64, device="cpu",
        device_norms=NORMS)
    pad = (32, 32)
    crop = (oh * upsampling - (upsampling - 1),
            ow * upsampling - (upsampling - 1))
    p = engine._prepare(pad, crop, n, upsampling)
    bufs = engine._buffers(p)
    engine._start_pass(bufs, p)
    carry = engine._zero_carry(p)
    starts = list(range(0, n + engine.mid, p.B))
    assert len(starts) == 3
    n_fg = 0
    with torch.inference_mode():
        for block_start in starts:
            images = np.zeros((p.B,) + pad, np.uint8)
            part = vol[block_start:block_start + p.B]
            images[:len(part), :oh, :ow] = part
            batch = torch.from_numpy(images)
            want_pan, want_packed, carry = _int_step(
                engine, p, batch, block_start, carry)
            bufs.scalars[0].fill_(block_start)
            pan, packed = engine._block_step(p, batch, bufs.scalars,
                                             bufs.carry)
            np.testing.assert_array_equal(pan.numpy(), want_pan.numpy())
            np.testing.assert_array_equal(packed.numpy(),
                                          want_packed.numpy())
            for got, want in zip(bufs.carry, carry):
                np.testing.assert_array_equal(got.numpy(), want.numpy())
            n_fg += int(packed[:, 0, 0].sum())
    assert n_fg > 0


def test_no_graph_on_the_cpu():
    """The CPU runs the eager step and counts no graph counter."""
    vol = _blob_volume(seed=3, d=6, h=16, w=16)
    engine = FusedStackEngine(
        SyntheticModule(), None, [1], block_size=4, label_divisor=100,
        stuff_area=0, padding_factor=16, max_centers=64, device="cpu",
        device_norms=NORMS)
    with profiling.recording() as rec:
        blocks = list(engine.infer_blocks(_DS(vol)))
    assert len(blocks) == engine.last_dispatch_count == 2
    assert not [k for k in rec.counters if k.startswith("infer.graph")]


# -- on the card ---------------------------------------------------------

TINY = dict(encoder="regnety_200mf", fpn_layers=1, num_classes=1,
            train_num_points=16, subdivision_num_points=32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured and "
                    "replayed on the card")


def _module(kind):
    if kind == "synthetic":
        return SyntheticModule().cuda()
    from empanada_torch.models import create_model

    return create_model("PanopticBiFPNPR", device="cuda", seed=0,
                        dtype="bfloat16", **TINY)


def _engine(module):
    # every block of these stacks in flight at once
    return FusedStackEngine(
        module, None, [1], block_size=4, label_divisor=100, stuff_area=0,
        padding_factor=128, max_centers=64, device="cuda",
        device_norms=NORMS, pipeline_depth=8)


def _run(module, vol, resident=False, size=None):
    """[(z_indices, pan, packed)] of one pass, read after the whole pass
    is dispatched; and the grouping kernel's launches during it."""
    engine = _engine(module)
    before = group.LAUNCHES["group_pixels"]
    if resident:
        it = engine.infer_blocks_resident(torch.from_numpy(vol).cuda())
    else:
        it = engine.infer_blocks(_DS(vol, size))
    blocks = list(it)
    out = [(z, np.asarray(pan), np.asarray(packed))
           for z, pan, packed in blocks]
    assert len(out) == engine.last_dispatch_count
    return out, group.LAUNCHES["group_pixels"] - before


def _eager(monkeypatch, module, vol, **kw):
    with monkeypatch.context() as m:
        m.setattr(FusedStackEngine, "_claim_graph",
                  lambda self, p, batch: None)
        return _run(module, vol, **kw)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (zg, pg, kg), (zw, pw, kw) in zip(got, want):
        assert zg == zw
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_array_equal(kg, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["synthetic", "mitonet"])
def test_graph_blocks_equal_eager_blocks(kind, monkeypatch):
    """Two passes share one graph: 20 slices of 256^2 (the crop is the
    padded slice) and 13 slices of 200 x 256 (padded to 256^2). Graph ==
    eager, as eager == eager; one capture, every block replayed, none
    eager; one grouping launch a block, and the warm-up's before the
    capture; the resident pass replays the same graph."""
    _card()
    torch.manual_seed(0)
    module = _module(kind)
    vol_a = _blob_volume(seed=5, d=20, h=256, w=256, n_blobs=12)
    vol_b = _blob_volume(seed=6, d=13, h=200, w=256, n_blobs=8)
    want_a, _ = _eager(monkeypatch, module, vol_a)
    again, _ = _eager(monkeypatch, module, vol_a)
    _assert_same(again, want_a)
    want_b, _ = _eager(monkeypatch, module, vol_b)
    with profiling.recording() as rec:
        got_a, launches_a = _run(module, vol_a)
        got_b, launches_b = _run(module, vol_b)
        got_r, launches_r = _run(module, vol_a, resident=True)
    _assert_same(got_a, want_a)
    _assert_same(got_b, want_b)
    _assert_same(got_r, want_a)
    blocks = len(want_a) * 2 + len(want_b)
    assert rec.counters.get("infer.graph_capture") == 1
    assert rec.counters.get("infer.graph_replay") == blocks
    assert "infer.graph_eager" not in rec.counters
    assert (launches_a, launches_b, launches_r) == (
        len(want_a) + 1, len(want_b), len(want_a))
    assert sum(s.name == "infer.capture" for s in rec) == 1
    if kind == "synthetic":
        assert sum(int(k[:, 0, 0].sum()) for _, _, k in want_a) > 0


class _Waits(SyntheticModule):
    """Reads a value back from the device in its forward: capturable
    by no graph."""

    def forward(self, images, render_steps=2, interpolate_ins=False):
        if images.sum().item() != images.sum().item():
            raise AssertionError("NaN input")
        return super().forward(images, render_steps, interpolate_ins)


@pytest.mark.cuda
def test_module_that_waits_falls_back_to_eager(monkeypatch):
    """The capture raises once; the key then runs eagerly, pass after
    pass, with the same blocks as the graph-free module; a graph of
    another module captures and replays after it."""
    _card()
    vol = _blob_volume(seed=7, d=10, h=256, w=256, n_blobs=6)
    want, _ = _eager(monkeypatch, SyntheticModule().cuda(), vol)
    module = _Waits().cuda()
    with profiling.recording() as rec:
        got, _ = _run(module, vol)
        got2, _ = _run(module, vol)
        after, _ = _run(SyntheticModule().cuda(), vol)
    _assert_same(got, want)
    _assert_same(got2, want)
    _assert_same(after, want)
    torch.cuda.empty_cache()  # no capture left open in the allocator
    assert rec.counters.get("infer.graph_capture") == 2
    assert rec.counters.get("infer.graph_eager") == 2 * len(want)
    assert rec.counters.get("infer.graph_replay") == len(want)


@pytest.mark.cuda
def test_replaced_module_tensors_are_captured_anew(monkeypatch):
    """A module whose parameters were replaced (new storage) is captured
    again, and its old graph is dropped; values changed in place are
    read by the replays as they are."""
    _card()
    from empanada_torch.inference import fused

    module = _module("mitonet")
    vol = _blob_volume(seed=8, d=8, h=256, w=256)
    with profiling.recording() as rec:
        first, _ = _run(module, vol)
        with torch.no_grad():
            for prm in module.parameters():
                prm.data = prm.data.clone()
        second, _ = _run(module, vol)
        with torch.no_grad():
            for prm in module.parameters():
                prm.mul_(0.5)
        halved, _ = _run(module, vol)
    _assert_same(second, first)
    assert rec.counters.get("infer.graph_capture") == 2
    assert rec.counters.get("infer.graph_replay") == 3 * len(first)
    assert len(fused._GRAPHS[module]) == 1
    want, _ = _eager(monkeypatch, module, vol)
    _assert_same(halved, want)
