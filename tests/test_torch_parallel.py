"""Port parity of the multi-device inference helpers on the CPU: the
mesh helpers, the mesh-sharded ``FusedStackEngine`` and
``SliceParallelEngine3d`` against the JAX package's (whose mesh is the
conftest's virtual CPU devices), the distributed samplers index for
index, and the trainer's per-rank row cut. The engines run the
parameter-free synthetic twins, so every integer output is comparable;
the tiny MitoNet's mesh run is held to the port's own run without a
mesh, exactly."""

import numpy as np
import pytest
import torch

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

from empanada_tpu.data.utils import sampler as jax_sampler
from empanada_tpu.inference.fused import FusedStackEngine as JaxEngine
from empanada_tpu.parallel import create_mesh as jax_create_mesh
from empanada_tpu.parallel.inference import (
    SliceParallelEngine3d as JaxSliceParallelEngine3d,
)
from empanada_torch.data.loader import EpochBatchSampler
from empanada_torch.data.utils import sampler
from empanada_torch.inference.fused import FusedStackEngine
from empanada_torch.models import create_model
from empanada_torch.parallel import Mesh, create_mesh, replicate, shard_batch
from empanada_torch.parallel.inference import SliceParallelEngine3d
from empanada_torch.synthetic import SyntheticModule
from tests.synthetic import SyntheticModule as JaxSyntheticModule
from tests.test_torch_models import TINY
from tests.test_torch_stack import _DS, _blob_volume, _collect

CPU = torch.device("cpu")


def cpu_mesh(n):
    return create_mesh(devices=[CPU] * n)


def test_shard_batch_splits_and_refuses_ragged_batches():
    mesh = cpu_mesh(2)
    x = torch.arange(12.0).reshape(4, 3)
    parts = shard_batch({"a": x, "b": x[:, 0]}, mesh)
    assert len(parts) == 2
    assert torch.equal(parts[0]["a"], x[:2]) and torch.equal(
        parts[1]["b"], x[2:, 0])
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(torch.zeros(5, 2), mesh)
    assert create_mesh(1, devices=[CPU] * 3).size == 1


def test_create_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])


def test_replicate_shares_a_copy_per_device():
    module = torch.nn.Linear(2, 2)
    copies = replicate(module, cpu_mesh(3))
    assert copies[0] is module and copies[1] is module and copies[2] is module


@pytest.mark.parametrize("mesh_size", [1, 2, 4, 8])
def test_resolve_block_matches_jax(mesh_size):
    """The automatic block over each orthoplane slice shape and a short
    stack, and an explicit one, against the JAX engine's."""
    jax_engine = JaxEngine(JaxSyntheticModule(), {}, [1],
                           mesh=jax_create_mesh(mesh_size))
    engine = FusedStackEngine(SyntheticModule(), None, [1],
                              mesh=cpu_mesh(mesh_size))
    cases = [((256, 384), 96), ((128, 384), 192), ((128, 256), 320),
             ((512, 512), 5), ((128, 128), 3), ((1024, 1024), 1000)]
    for pad_shape, n in cases:
        assert engine._resolve_block(pad_shape, n) \
            == jax_engine._resolve_block(pad_shape, n), (pad_shape, n)
    with pytest.raises(ValueError, match="must divide"):
        FusedStackEngine(SyntheticModule(), None, [1], block_size=3,
                         mesh=cpu_mesh(2))


ENGINE_KW = dict(thing_list=[1], label_divisor=100, stuff_area=0,
                 median_kernel_size=3, padding_factor=16, max_centers=64,
                 block_size=8, device_norms={"mean": 0.5, "std": 0.2})


@pytest.mark.parametrize("qlen", [3, 5])
def test_mesh_engine_matches_jax_mesh_engine(qlen):
    """D=19 with blocks of 8 over a 2-device mesh: the median carries
    cross block edges. Packed rows and maps equal the JAX mesh engine's
    and the port's engine without a mesh, on every slice."""
    vol = _blob_volume(seed=qlen, d=19, h=30, w=27, n_blobs=5)
    kw = dict(ENGINE_KW, median_kernel_size=qlen)
    want = _collect(JaxEngine(JaxSyntheticModule(), {}, mesh=jax_create_mesh(2),
                              **kw).infer_blocks(_DS(vol)), len(vol))
    got = _collect(FusedStackEngine(SyntheticModule(), None, mesh=cpu_mesh(2),
                                    **kw).infer_blocks(_DS(vol)), len(vol))
    alone = _collect(FusedStackEngine(SyntheticModule(), None, device="cpu",
                                      **kw).infer_blocks(_DS(vol)), len(vol))
    n_fg = 0
    for z in range(len(vol)):
        for k in range(2):
            np.testing.assert_array_equal(got[z][k], want[z][k],
                                          err_msg=str(z))
            np.testing.assert_array_equal(got[z][k], alone[z][k],
                                          err_msg=str(z))
        n_fg += int(got[z][1][0, 0])
    assert n_fg > 0


def test_tiny_mitonet_mesh_engine_equals_its_single_device_run():
    model = create_model("PanopticBiFPNPR", device="cpu", seed=0, **TINY)
    vol = _blob_volume(seed=7, d=13, h=40, w=36, n_blobs=4)
    kw = dict(ENGINE_KW, padding_factor=128, device_norms={"mean": 0.4,
                                                          "std": 0.3})
    alone = _collect(FusedStackEngine(model, None, device="cpu", **kw)
                     .infer_blocks(_DS(vol)), len(vol))
    got = _collect(FusedStackEngine(model, None, mesh=cpu_mesh(4), **kw)
                   .infer_blocks(_DS(vol)), len(vol))
    for z in range(len(vol)):
        np.testing.assert_array_equal(got[z][0], alone[z][0], err_msg=str(z))
        np.testing.assert_array_equal(got[z][1], alone[z][1], err_msg=str(z))


@pytest.mark.parametrize("mesh_size", [2, 4])
def test_slice_parallel_engine_matches_jax(mesh_size):
    vol = (_blob_volume(seed=11, d=10, h=30, w=27, n_blobs=4) > 200) \
        .astype(np.float32)
    kw = dict(thing_list=[1], label_divisor=100, stuff_area=0,
              median_kernel_size=3, padding_factor=16, max_centers=64)
    want = dict(JaxSliceParallelEngine3d(
        JaxSyntheticModule(), {}, jax_create_mesh(mesh_size), **kw)
        .infer_stack(_DS(vol)))
    got = dict(SliceParallelEngine3d(
        SyntheticModule(), None, cpu_mesh(mesh_size), **kw)
        .infer_stack(_DS(vol)))
    assert sorted(got) == sorted(want) == list(range(len(vol)))
    n_ids = 0
    for z in range(len(vol)):
        np.testing.assert_array_equal(got[z].numpy(), np.asarray(want[z]),
                                      err_msg=str(z))
        n_ids += len(np.unique(got[z].numpy())) - 1
    assert n_ids > 0


@pytest.mark.parametrize("world, shuffle, drop_last, n", [
    (1, True, True, 17), (2, True, True, 17), (3, False, True, 17),
    (4, True, False, 10), (2, False, False, 9)])
def test_distributed_weighted_sampler_matches_jax(world, shuffle, drop_last,
                                                  n):
    weights = np.random.default_rng(n).random(n) + 0.1
    for rank in range(world):
        for epoch in (0, 3):
            kw = dict(num_replicas=world, rank=rank, shuffle=shuffle,
                      drop_last=drop_last, seed=5)
            ours = sampler.DistributedWeightedSampler(n, weights, **kw)
            theirs = jax_sampler.DistributedWeightedSampler(n, weights, **kw)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert len(ours) == len(theirs)
            assert list(ours) == list(theirs)


@pytest.mark.parametrize("world, n", [(1, 7), (2, 7), (3, 10), (4, 4)])
def test_sequential_distributed_sampler_matches_jax(world, n):
    for rank in range(world):
        ours = sampler.SequentialDistributedSampler(n, world, rank)
        theirs = jax_sampler.SequentialDistributedSampler(n, world, rank)
        assert len(ours) == len(theirs) and list(ours) == list(theirs)


def test_samplers_default_to_one_process():
    """With no process group up, the world is one process of rank 0."""
    ours = sampler.DistributedWeightedSampler(6, np.ones(6))
    assert (ours.num_replicas, ours.rank) == (1, 0)
    assert list(sampler.SequentialDistributedSampler(3)) == [0, 1, 2]


@pytest.mark.parametrize("weighted", [False, True])
def test_rank_rows_rebuild_one_process_batches(weighted):
    """The per-rank row cut of a world-2 epoch, concatenated row by row,
    is one process's batches, index for index."""
    n, batch = 23, 6
    weights = np.linspace(0.1, 2, n)

    def batches(world, rank):
        s = sampler.WeightedRandomSampler(weights, seed=3) if weighted \
            else None
        out = EpochBatchSampler(n, batch, s, shuffle=True, drop_last=True,
                                seed=3, num_replicas=world, rank=rank)
        out.set_epoch(2)
        return list(out)

    one = batches(1, 0)
    parts = [batches(2, r) for r in range(2)]
    assert len(one) == len(parts[0]) == len(parts[1]) == n // batch
    assert [a + b for a, b in zip(*parts)] == one
    with pytest.raises(ValueError, match="does not divide"):
        EpochBatchSampler(n, 5, num_replicas=2)


def _rank_loader_batches(root, world, rank, epoch=1):
    """(fnames, images) by batch of the loader that rank ``rank`` of a
    ``world``-rank trainer builds on the weighted, augmented set."""
    from empanada_torch.train import Trainer

    cfg = {"DATASET": {"labels": [1], "thing_list": [1],
                       "norms": {"mean": 0.5, "std": 0.15}},
           "MODEL": dict(TINY, arch="PanopticBiFPNPR"),
           "TRAIN": {"batch_size": 4, "workers": 1, "train_dir": str(root),
                     "dataset_params": {"weight_gamma": 0.7},
                     "augmentations": [
                         {"aug": "RandomCrop", "height": 48, "width": 48},
                         {"aug": "Rotate", "limit": 180},
                         {"aug": "HorizontalFlip"}]}}
    trainer = Trainer(cfg, device="cpu", seed=3)
    trainer.world, trainer.rank = world, rank
    loader = trainer.build_loader()
    loader.set_epoch(epoch)
    out = [(b["fname"], b["image"]) for b in loader]
    return out, loader.dataset


@pytest.mark.parametrize("hosts", [1, 2])
def test_trainer_rank_loaders_on_a_weighted_augmented_set(tmp_path, hosts,
                                                          monkeypatch):
    """The loaders of a world-2 trainer on a weighted, augmented set. On
    one host the two ranks' rows, concatenated, are one process's
    batches, index for index (``WeightedRandomSampler`` over the global
    batch); over two hosts (``LOCAL_WORLD_SIZE`` 1) each host draws its
    own batch through ``DistributedWeightedSampler``, as the JAX
    package's processes do. Every example is the same image, so a
    repeated augmentation draw shows as two equal rows: none is shared
    between the ranks."""
    from empanada_torch.data.image_files import write_png

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (64, 64)).astype(np.uint8)
    msk = np.zeros((64, 64), np.uint16)
    msk[10:30, 20:50] = 1
    for src, n in (("a", 6), ("b", 2)):
        for sub, arr in (("images", img), ("masks", msk)):
            (tmp_path / src / sub).mkdir(parents=True)
            for i in range(n):
                write_png(str(tmp_path / src / sub / f"{i}.png"), arr)
    if hosts == 2:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    else:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    ranks = [_rank_loader_batches(tmp_path, 2, r) for r in range(2)]
    dataset = ranks[0][1]
    names = [[f for f, _ in batches] for batches, _ in ranks]
    if hosts == 1:
        one, _ = _rank_loader_batches(tmp_path, 1, 0)
        assert [a + b for a, b in zip(*names)] == [f for f, _ in one]
    else:
        for r in range(2):
            draw = sampler.DistributedWeightedSampler(
                len(dataset), dataset.weights, num_replicas=2, rank=r,
                seed=3)
            draw.set_epoch(1)
            idx = list(draw)
            assert names[r] == [[dataset.impaths[i] for i in idx[k:k + 2]]
                                for k in range(0, len(idx) - 1, 2)]
    rows = [[x for _, imgs in batches for x in imgs] for batches, _ in ranks]
    assert len(rows[0]) == len(rows[1]) > 0
    assert not any(torch.equal(a, b) for a in rows[0] for b in rows[1])
