"""Training on several cards (``mode_tpu/parallel/``): the ``data`` axis.

``mesh.py`` makes the process group and the mesh, splits the global batch
over the ranks, all-reduces the gradients and holds the active mesh that
the BatchNorm layers and the losses read; ``launch.py`` starts one process
per rank on one host, as ``torchrun`` does. The ``spatial`` axis (the cost
volume's H over cards) is not ported yet (``ROADMAP.md``).
"""
