"""The CLIs (``mode_tpu/cli``): the four serving CLIs and the two
trainers, each run as ``python -m mode_tpu_torch.cli.<name>`` or through its
``main(argv)``."""
