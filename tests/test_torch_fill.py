"""Port parity of the volume fill and the zarr-v2 store: seeded RLE
instances go through the JAX package's core/fill.py and data/
zarr_store.py and the port's copies. Dense fills are exactly equal, a
store written by one package opens in the other, and the bytes on disk
(.zarray and every chunk file) are identical."""

import os

import numpy as np
import pytest

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

from empanada_tpu.core import fill as jax_fill
from empanada_tpu.data import zarr_store as jax_zarr
from empanada_tpu.inference import patterns as jax_patterns
from empanada_torch.core import fill
from empanada_torch.data import zarr_store
from empanada_torch.inference import patterns
from tests.test_torch_native import with_host_half

SHAPE = (20, 70, 90)
CHUNKS = (8, 32, 64)


def _instances(seed, shape=SHAPE, n=40):
    """Seeded disjoint instances as sorted flat runs over ``shape``: the
    volume's voxels cut into random runs, a random half of them dealt to
    n labels (so runs cross row, plane and chunk boundaries)."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(shape))
    cuts = np.sort(rng.choice(np.arange(1, size), 3000, replace=False))
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [size]])
    keep = rng.random(len(starts)) < 0.5
    starts, ends = starts[keep], ends[keep]
    owner = rng.integers(0, n, len(starts))
    instances = {}
    for k in range(n):
        sel = owner == k
        instances[1001 + k] = {"box": (0, 0, 0) + tuple(shape),
                               "starts": starts[sel],
                               "runs": ends[sel] - starts[sel]}
    return instances


def _dir_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.uint16, np.int64])
@pytest.mark.parametrize("contiguous", [True, False])
def test_numpy_fill_instances(dtype, contiguous):
    instances = _instances(0)
    instances[5] = {"box": (0,) * 6, "starts": np.zeros(0, np.int64),
                    "runs": np.zeros(0, np.int64)}  # empty: skipped
    if np.dtype(dtype) == np.uint16:
        instances = {k - 900: v for k, v in instances.items() if k != 5}

    def target():
        if contiguous:
            return np.zeros(SHAPE, dtype)
        return np.zeros((SHAPE[0], SHAPE[1], 2 * SHAPE[2]), dtype)[..., ::2]

    want, got = target(), target()
    want_ret = jax_fill.numpy_fill_instances(want, instances)
    got_ret = fill.numpy_fill_instances(got, instances)
    assert got.flags.c_contiguous == contiguous
    np.testing.assert_array_equal(got, want)      # filled in place
    np.testing.assert_array_equal(got_ret, want_ret)
    assert got_ret.dtype == want_ret.dtype
    assert (got > 0).sum() == sum(int(v["runs"].sum())
                                  for v in instances.values())


@pytest.mark.parametrize("chunks", [CHUNKS, (20, 70, 90), (3, 7, 11)])
def test_split_ranges_on_chunks(chunks):
    for attrs in list(_instances(1).values())[:6]:
        want = jax_fill.split_ranges_on_chunks(
            attrs["starts"], attrs["runs"], SHAPE, chunks)
        got = fill.split_ranges_on_chunks(
            attrs["starts"], attrs["runs"], SHAPE, chunks)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key][0], want[key][0])
            np.testing.assert_array_equal(got[key][1], want[key][1])
        assert sum(int(r.sum()) for _, r in got.values()) == \
            int(attrs["runs"].sum())


@pytest.mark.parametrize("processes", [1, 4])
@pytest.mark.parametrize("compressor", ["zlib", None])
def test_chunked_fill_into_both_stores(tmp_path, processes, compressor):
    """Each package's fill into each package's store: four stores with
    the same bytes, each read back by the other package and equal to the
    dense fill."""
    instances = _instances(2)
    dense = fill.numpy_fill_instances(np.zeros(SHAPE, np.uint32), instances)
    stores = {}
    for fill_name, fill_mod in (("jax", jax_fill), ("torch", fill)):
        for store_name, store_mod in (("jax", jax_zarr),
                                      ("torch", zarr_store)):
            path = str(tmp_path / f"{fill_name}_{store_name}.zarr")
            store = store_mod.create_zarr(path, SHAPE, chunks=CHUNKS,
                                          dtype=np.uint32,
                                          compressor=compressor)
            fill_mod.chunked_fill_instances(store, instances,
                                            processes=processes)
            stores[fill_name, store_name] = path
    first = _dir_bytes(stores["jax", "jax"])
    assert ".zarray" in first and len(first) > 10
    for (fill_name, store_name), path in stores.items():
        assert _dir_bytes(path) == first, (fill_name, store_name)
        reader = zarr_store if store_name == "jax" else jax_zarr
        back = reader.open_zarr(path)
        assert back.shape == SHAPE and back.chunks == CHUNKS
        np.testing.assert_array_equal(np.asarray(back), dense)


@pytest.mark.parametrize("host_half", ["native", "numpy"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int64])
def test_chunked_fill_host_halves(tmp_path, dtype, host_half):
    """The fill into a zarr store with the host half named: the C++ run
    fill (the default; uint32 chunks through their int32 view) and
    numpy's repeat path (asked for). Stores are byte-identical to the
    JAX package's."""
    instances = _instances(6)
    paths = {name: str(tmp_path / f"{name}.zarr") for name in ("jax",
                                                                "torch")}
    store = jax_zarr.create_zarr(paths["jax"], SHAPE, chunks=CHUNKS,
                                 dtype=dtype)
    jax_fill.chunked_fill_instances(store, instances, processes=2)
    store = zarr_store.create_zarr(paths["torch"], SHAPE, chunks=CHUNKS,
                                   dtype=dtype)
    with_host_half(
        host_half,
        lambda: fill.chunked_fill_instances(store, instances, processes=2),
        required=("fill_runs_i32" if dtype == np.uint32
                  else "fill_runs_i64",))
    assert _dir_bytes(paths["torch"]) == _dir_bytes(paths["jax"])
    dense = fill.numpy_fill_instances(np.zeros(SHAPE, dtype), instances)
    np.testing.assert_array_equal(
        np.asarray(zarr_store.open_zarr(paths["torch"])), dense)


def test_fill_volume_dispatch(tmp_path):
    """patterns.fill_volume: numpy arrays in place, stores by chunk;
    fill_panoptic_volume over several trackers."""
    instances = _instances(3)
    want = np.zeros(SHAPE, np.uint32)
    jax_patterns.fill_volume(want, instances)
    got = np.zeros(SHAPE, np.uint32)
    patterns.fill_volume(got, instances)
    np.testing.assert_array_equal(got, want)
    store = zarr_store.create_zarr(str(tmp_path / "a.zarr"), SHAPE,
                                   chunks=CHUNKS)
    patterns.fill_volume(store, instances, processes=2)
    np.testing.assert_array_equal(np.asarray(store), want)

    class _T:
        def __init__(self, instances):
            self.instances = instances

    halves = [_T(dict(list(instances.items())[:20])),
              _T(dict(list(instances.items())[20:]))]
    both = np.zeros(SHAPE, np.uint32)
    patterns.fill_panoptic_volume(both, halves)
    np.testing.assert_array_equal(both, want)


@pytest.mark.parametrize("compressor", ["zlib", None])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint32, np.float32])
def test_zarr_store_bytes_and_cross_open(tmp_path, compressor, dtype):
    """Partial and whole-chunk writes, integer keys and an overwrite:
    .zarray and chunk files byte-identical, either package reads both."""
    rng = np.random.default_rng(4)
    data = (rng.random((13, 50, 37)) * 200).astype(dtype)
    paths = {}
    for name, mod in (("jax", jax_zarr), ("torch", zarr_store)):
        path = str(tmp_path / f"{name}.zarr")
        arr = mod.create_zarr(path, data.shape, chunks=(4, 32, 16),
                              dtype=dtype, compressor=compressor, level=3)
        arr[:, :, :] = data
        arr[2:7, 10:45, 5:30] = data[2:7, 10:45, 5:30] * 0 + 7
        arr[3] = data[5]
        with pytest.raises(FileExistsError):
            mod.create_zarr(path, data.shape)
        paths[name] = path
    assert _dir_bytes(paths["torch"]) == _dir_bytes(paths["jax"])
    want = np.asarray(jax_zarr.open_zarr(paths["jax"]))
    for reader in (jax_zarr, zarr_store):
        for path in paths.values():
            arr = reader.open_zarr(path)
            assert arr.dtype == np.dtype(dtype) and arr.ndim == 3
            np.testing.assert_array_equal(np.asarray(arr), want)
            np.testing.assert_array_equal(arr[4:9, :, 20], want[4:9, :, 20])
    # overwrite clears the stale chunks of the old layout
    fresh = zarr_store.create_zarr(paths["torch"], data.shape,
                                   chunks=(13, 50, 37), dtype=dtype,
                                   overwrite=True)
    assert sorted(os.listdir(paths["torch"])) == [".zarray"]
    assert not np.asarray(fresh).any()


def test_read_volume_npy_npz_zarr_and_groups(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 255, (6, 20, 30)).astype(np.uint8)
    np.save(tmp_path / "v.npy", data)
    np.savez(tmp_path / "v.npz", vol=data)
    arr = zarr_store.create_zarr(str(tmp_path / "g.zarr" / "em"),
                                 data.shape, dtype=np.uint8)
    arr[:, :, :] = data
    (tmp_path / "g.zarr" / ".zgroup").write_text('{"zarr_format": 2}')
    for mod in (jax_zarr, zarr_store):
        for name in ("v.npy", "v.npz", "g.zarr", "g.zarr/em"):
            vol = mod.read_volume(str(tmp_path / name))
            assert tuple(vol.shape) == data.shape, name
            np.testing.assert_array_equal(np.asarray(vol), data)
            np.testing.assert_array_equal(np.asarray(vol[:, 3, :]),
                                          data[:, 3, :])
    with pytest.raises(FileNotFoundError):
        zarr_store.open_zarr(str(tmp_path / "missing.zarr"))
    zarr_store.create_zarr(str(tmp_path / "g.zarr" / "second"), (2, 2, 2))
    with pytest.raises(ValueError, match="2 arrays"):
        zarr_store.open_zarr(str(tmp_path / "g.zarr"))
