"""empanada_torch — the PyTorch/CUDA port of empanada_tpu for NVIDIA Hopper.

Same pipeline, same results: MitoNet 3D inference in orthoplane and
stack mode (model forward, z-median, center NMS, pixel grouping,
panoptic merge, run extraction, then host matching, tracking, cross-axis
consensus and volume fill), the zarr-v2 store, the exported-model loader
and the ``infer3d`` command line in PyTorch, and MitoNet training and
finetuning (``train/``, the losses, metrics, data pipeline, 2D engines
and the ``train`` / ``finetune`` / ``export`` commands), with the one TPU
kernel of the JAX package (nearest-center pixel grouping) replaced by a
hand-written CUDA kernel (``csrc/group_pixels.cu``).

The package imports torch, numpy and scipy only (PyYAML inside the
functions that read or write a descriptor or a recipe; an image library
and mlflow inside the functions that use them, where installed). Entry points run
on CUDA unless the caller passes ``device="cpu"``; without a card and
without an explicit device they raise instead of falling back.
"""

__version__ = "0.1.0"
