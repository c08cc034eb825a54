"""The serving CLIs (``mode_tpu/cli``), each run as ``python -m
mode_tpu_torch.cli.<name>`` or through its ``main(argv)``."""
