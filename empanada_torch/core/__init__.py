"""Host-side sparse core: box algebra, RLE algebra, range voting,
run-based connected components (3D: ``core.ccl3d``), and chunked volume
filling.

Numpy-vectorized implementations with a C++ fast path (see
``empanada_torch.core.native``; built at first use, never at import).
Mirrors the capability surface of the reference's
``empanada/array_utils.py`` + ``empanada/zarr_utils.py`` (see reference
array_utils.py:42-736) but replaces its per-pixel numba loops with
event-sweep algorithms.
"""

from empanada_torch.core.boxes import (
    box_area,
    box_intersection,
    box_iou_dense,
    box_iou_pairs,
    merge_boxes,
)
from empanada_torch.core.rle import (
    rle_encode,
    rle_decode,
    rle_to_string,
    string_to_rle,
    rle_intersection,
    rle_iou,
    rle_ioa,
    merge_rles,
    rle_area,
    crop_and_binarize,
    mask_iou,
    mask_ioa,
)
from empanada_torch.core.ranges import (
    rle_to_ranges,
    ranges_to_rle,
    concat_sort_ranges,
    join_ranges,
    vote_by_ranges,
    invert_ranges,
    ranges_intersection,
)
from empanada_torch.core.ccl import (
    connected_components_2d,
    runs_connected_components,
    label_mask,
    region_props_from_runs,
)
from empanada_torch.core.fill import numpy_fill_instances, chunked_fill_instances


def take(array, indices, axis=0):
    """Take indices from an array-like along an axis (works for numpy
    and zarr-store arrays; reference array_utils.py:6-23)."""
    key = tuple(
        slice(None) if n != axis else indices
        for n in range(array.ndim)
    )
    return array[key]


def put(array, indices, value, axis=0):
    """Put values at indices along an axis, in place
    (reference array_utils.py:25-42)."""
    key = tuple(
        slice(None) if n != axis else indices
        for n in range(array.ndim)
    )
    array[key] = value
