"""mode_tpu_torch — MODE (Multi-view Omnidirectional Depth Estimation) in
PyTorch, with hand-written CUDA kernels for an NVIDIA Hopper card (sm_90a).

A port of the JAX package ``mode_tpu``, which stays the reference the port is
tested against. The module layout mirrors it, so each counterpart sits at the
same path: ``ops/resize.py``, ``ops/cost_volume.py``, ``models/blocks.py``,
``models/disparity.py`` and so on. The Pallas kernels of ``mode_tpu`` become
CUDA kernels under ``kernels/csrc/``, each with a plain PyTorch version of the
same function beside its wrapper.

This package never imports ``jax``, ``flax`` or ``mode_tpu``. Its entry points
run on CUDA unless the caller passes ``device="cpu"``; without a card they
raise instead of running on the CPU.

Ported so far: the stage-1 eval forward of ``ModeDisparity``, at any
batch, with the sphere feature extractor (``conv="Sphere"``, Cassini, the
default) or PSMNet's (``conv="Regular"``).
"""

__version__ = "0.1.0"
