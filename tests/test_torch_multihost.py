"""Port parity of multi-process orthoplane inference on the CPU:
``z_shard`` and the z-shard accounting of a simulated world of 8 (shard
coverage, blocks and copied bytes ~1/world, a gather of O(runs)); two
real gloo processes run ``multihost_run_inference3d`` and rank 0's
consensus equals the port's single-process ``run_inference3d`` AND the
JAX package's, RLE for RLE; the object collectives round-trip over the
two processes and return their input at world 1, and their gloo side
group follows the default group across a destroy and a new init; ``infer3d -n-devices
2 --use-cpu`` writes the same store and JSON as without the flag. The
engines run the parameter-free synthetic twins."""

import json
import pickle
import textwrap

import numpy as np
import pytest

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

from empanada_tpu.cli.infer3d import run_inference3d as jax_run_inference3d
from empanada_tpu.parallel.multihost import z_shard as jax_z_shard
from empanada_torch.cli.infer3d import run_inference3d
from empanada_torch.inference.fused import FusedStackEngine
from empanada_torch.parallel import collectives
from empanada_torch.parallel.multihost import local_rle_shard, z_shard
from empanada_torch.synthetic import SyntheticModule
from tests.synthetic import SyntheticModule as JaxSyntheticModule
from tests.test_multihost import blob_volume, canonical
from tests.test_torch_ddp import REPO, run_ranks
from tests.test_torch_stack import _blob_volume

SETTINGS = dict(labels=[1], thing_list=[1], qlen=3, label_divisor=100,
                padding_factor=16, max_centers=64, min_size=4, min_span=1,
                pixel_vote_thr=2)

WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(2)
    port, rank, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]

    from empanada_torch.parallel import initialize_distributed
    initialize_distributed(f"127.0.0.1:{{port}}", 2, rank, backend="gloo")
    import torch.distributed as dist
    from empanada_torch.parallel import collectives
    from empanada_torch.parallel.multihost import multihost_run_inference3d
    from empanada_torch.synthetic import SyntheticModule
    from tests.test_multihost import blob_volume, canonical
    from tests.test_torch_multihost import SETTINGS

    out = {{
        "objects": collectives.all_gather_objects({{"rank": rank,
                                                   "list": [rank] * 3}}),
        "broadcast": collectives.broadcast_object(
            "from rank 0" if rank == 0 else None),
        "arrays": [a.tolist() for a in collectives.all_gather_arrays(
            np.full(3, rank, np.int32))]}}
    stats = {{}}
    cons = multihost_run_inference3d(
        SyntheticModule(), blob_volume(), block_size=4, device="cpu",
        stats=stats, **SETTINGS)
    out["stats"] = stats
    out["consensus"] = canonical(cons) if cons is not None else None
    with open(f"{{workdir}}/rank{{rank}}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("n, world", [(11, 2), (40, 8), (7, 3), (3, 4)])
def test_z_shard_matches_jax(n, world):
    for rank in range(world):
        assert z_shard(n, rank, world) == jax_z_shard(n, rank, world)


def test_z_shard_accounting_scales_with_the_world():
    """Every rank of a world of 8 simulated in one process: exact shard
    coverage, per-rank blocks ~ total / world + the halo, per-rank copied
    bytes ~ total / world, and a gather of O(runs), not O(volume)."""
    vol = _blob_volume(seed=3, d=40, h=32, w=32, n_blobs=8)
    B = 4
    engine = FusedStackEngine(
        SyntheticModule(), None, [1], label_divisor=100, stuff_area=0,
        median_kernel_size=3, padding_factor=16, max_centers=64,
        block_size=B, device_norms={"mean": 0.5, "std": 0.2}, device="cpu")
    mid, D, world = engine.mid, len(vol), 8
    per_rank, covered, gather_bytes = [], [], 0
    for rank in range(world):
        start, end = z_shard(D, rank, world)
        stats = {}
        local = local_rle_shard(engine, vol, start, end, labels=[1],
                                label_divisor=100, thing_list=[1],
                                stats=stats)
        per_rank.append(stats)
        covered.extend(z for z, _ in local)
        gather_bytes += len(pickle.dumps(local))
    assert sorted(covered) == list(range(D))

    shard = -(-D // world)
    per_rank_cap = -(-(shard + 2 * mid) // B) + 1
    total_single = -(-(D + 2 * mid) // B) + 1
    for stats in per_rank:
        assert 1 <= stats["dispatches"] <= per_rank_cap, stats
    assert sum(s["dispatches"] for s in per_rank) < total_single * world / 2
    bytes_cap = per_rank_cap / max(total_single - 1, 1)
    total_bytes = sum(s["d2h_bytes"] for s in per_rank)
    for stats in per_rank:
        assert stats["d2h_bytes"] <= total_bytes * bytes_cap, stats
    assert gather_bytes < vol.size, (gather_bytes, vol.size)


def test_collectives_return_their_input_at_world_one():
    obj = {"a": [1, 2]}
    assert collectives.all_gather_objects(obj) == [obj]
    assert collectives.broadcast_object(obj) is obj
    (arr,) = collectives.all_gather_arrays(np.arange(3))
    assert arr.tolist() == [0, 1, 2]


def test_object_group_follows_the_default_group(tmp_path, monkeypatch):
    """Under a non-gloo default group the side group is made once per
    default group: kept while that group lives, made anew after
    destroy_process_group and a new init in the same process."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    groups = []
    for i in range(2):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s{i}",
                                world_size=1, rank=0)
        try:
            groups.append(collectives.object_group())
            assert collectives.object_group() is groups[-1]
            assert collectives.broadcast_object("x") == "x"
        finally:
            dist.destroy_process_group()
    assert groups[0] is not groups[1]


def test_two_processes_match_both_single_process_runs(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    run_ranks(script, tmp_path)
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]

    for out in ranks:
        assert out["objects"] == [{"rank": 0, "list": [0, 0, 0]},
                                  {"rank": 1, "list": [1, 1, 1]}]
        assert out["broadcast"] == "from rank 0"
        assert out["arrays"] == [[0, 0, 0], [1, 1, 1]]
    assert ranks[1]["consensus"] is None

    vol = blob_volume()
    port = run_inference3d(SyntheticModule(), vol, block_size=4,
                           device="cpu", progress=False, **SETTINGS)
    jax = jax_run_inference3d((JaxSyntheticModule(), {}), vol, block_size=4,
                              progress=False, **SETTINGS)
    got = ranks[0]["consensus"]
    assert got == canonical(port) == canonical(jax)
    assert sum(len(v) for v in got.values()) > 0
    # each rank ran its half of every axis
    for axis, n in zip(("xy", "xz", "yz"), vol.shape):
        assert [r["stats"][axis]["slices"] for r in ranks] == [
            z_shard(n, r, 2)[1] - z_shard(n, r, 2)[0] for r in range(2)]
        assert all(r["stats"][axis]["dispatches"] >= 1 for r in ranks)


def test_infer3d_n_devices_writes_what_one_device_writes(tmp_path):
    """``infer3d -n-devices 2 --use-cpu``: the same store and JSON."""
    from empanada_torch.cli import infer3d
    from empanada_torch.data.zarr_store import create_zarr, open_zarr
    from empanada_torch.export import export_model
    from empanada_torch.models import create_model
    from tests.test_torch_export import MODEL_CONFIG, NORMS

    cfg = dict(MODEL_CONFIG)
    model = create_model(cfg.pop("arch"), device="cpu", seed=0, **cfg)
    export_model(model.state_dict(), MODEL_CONFIG, str(tmp_path / "export"),
                 "tiny", norms=NORMS)
    desc = str(tmp_path / "export" / "tiny.yaml")
    vol = np.random.default_rng(0).integers(0, 255, (10, 40, 36),
                                            dtype=np.uint8)
    outs = {}
    for tag, flags in (("one", []), ("two", ["-n-devices", "2"])):
        path = str(tmp_path / f"{tag}.zarr")
        create_zarr(path, vol.shape, dtype=np.uint8)[:] = vol
        infer3d.main([desc, path, "--use-cpu", "-block-size", "4",
                      "-min-size", "4", "-min-span", "1"] + flags)
        base = path.rsplit(".zarr", 1)[0]
        outs[tag] = (np.asarray(open_zarr(
            f"{base}_orthoplane_seg_class1.zarr")[:]),
            open(f"{base}_orthoplane_class1.json").read())
    np.testing.assert_array_equal(outs["one"][0], outs["two"][0])
    assert outs["one"][1] == outs["two"][1]
