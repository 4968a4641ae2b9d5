"""empanada_torch — the PyTorch/CUDA port of empanada_tpu for NVIDIA Hopper.

Same pipeline, same results: the MitoNet stack-mode 3D inference path
(model forward, z-median, center NMS, pixel grouping, panoptic merge,
run extraction, then host matching and tracking) in PyTorch, with the
one TPU kernel of the JAX package (nearest-center pixel grouping)
replaced by a hand-written CUDA kernel (``csrc/group_pixels.cu``).

The package imports torch, numpy and scipy only. Entry points run on
CUDA unless the caller passes ``device="cpu"``; without a card and
without an explicit device they raise instead of falling back.
"""

__version__ = "0.1.0"
