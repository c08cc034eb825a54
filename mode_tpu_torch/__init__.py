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

Ported so far:

- stage 1, ``models/disparity.py:ModeDisparity``: the eval forward at any
  batch with the sphere feature extractor (``conv="Sphere"``, Cassini, the
  default, or ERP) or PSMNet's (``conv="Regular"``), and the Sphere model's
  training step (``training.py``), f32 or mixed precision (bf16);
- the disparity -> depth bridge: ``ops/grid_sample.py`` and ``geometry/``
  (the Cassini / ERP projections, the sine law, the z-buffered
  re-projection);
- stage 2, ``models/fusion.py``: ``ModeFusion`` and ``Baseline``, eval and
  training, and ``ModeFusion``'s training step with the silog loss
  (``training.make_fusion_train_step``, f32 or bf16, on float or packed
  wire inputs);
- the whole frame, ``pipeline.py:TwoStagePipeline``, f32 or bf16;
- the four serving CLIs, ``cli/``: ``predict`` (``--stage disp`` and
  ``all``), ``test_disparity``, ``save_output_disparity_stage`` and
  ``test_fusion``, run as ``python -m mode_tpu_torch.cli.<name>`` with the
  JAX CLIs' flags and ``--device`` (the card by default, ``cpu`` for the
  plain path); they read reference-layout torch ``.tar`` weights
  (``scripts/jax_checkpoint_to_torch.py`` converts a JAX checkpoint);
- the two training CLIs, ``cli/train_disparity.py`` and
  ``cli/train_fusion.py``, with the JAX CLIs' flags and ``--device``; they
  write reference-layout ``.tar`` checkpoints every epoch, which the
  serving CLIs read, and TensorBoard event files;
- ``data/``: the Deep360 and 3D60 datasets (uint8 images for
  ``--device_normalize``), the file listers, the threaded loader, the
  ``native/libmodeio.so`` reader and the packed fusion frames
  (``fusion_pack.py``); ``models/initialize.py``: the ``--init_type``
  menu; ``utils/``: the metrics, the colormaps, checkpoint reading and
  saving (SHG-only loading in ``convert.py``), the TensorBoard writer
  (``tb_writer.py``), the tracer (``profiling.py``: spans at the
  frame's stages and the training step's phases, upload counters and
  kernel launch records, on ``torch.profiler``'s clock) and the model-FLOP
  counts;
- ``parallel/``: data-parallel training, one process a card under
  ``torchrun`` (the steps' and trainers' ``mesh``), and ``remat.py``: the
  stage-1 training forward's rematerialisation of the feature extractor
  and hourglasses (``"save_convs"``, the default, or ``"full"``).

Not yet: the ``spatial`` axis of ``parallel/`` (the cost volume sharded
over cards) and the re-projection's other z-buffer forms (``ROADMAP.md``).
"""

__version__ = "0.1.0"
