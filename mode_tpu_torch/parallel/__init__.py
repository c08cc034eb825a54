"""Several cards (``mode_tpu/parallel/``): the ``data`` and ``spatial`` axes.

``mesh.py`` makes the process group, the ``(data, spatial)`` mesh and its
axes' process groups, splits the global batch over the data ranks and H
over the spatial ranks, holds the differentiable collectives (sums, halo
exchanges, row gathers), all-reduces the gradients and holds the active
mesh that the BatchNorm layers, the losses and the 3-D layers read;
``shard_ops.py`` runs the cost volume's kernels on a spatial rank's rows
(halo forms, the library convs on haloed rows in training, the regression
head's row window); ``launch.py`` starts one process per rank on one host,
as ``torchrun`` does. Stage 1 trains under both axes; the fusion net
serves under both and trains under ``data`` only.
"""
