"""Device-side ops: resizing, sampling, panoptic post-processing, pixel
grouping (the CUDA kernel) and run-boundary extraction."""

from empanada_torch.ops.resize import factor_pad, interpolate_scale, resize_bilinear
from empanada_torch.ops.sampling import point_sample
