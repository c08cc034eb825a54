"""Training stage 2 (``mode_tpu/cli/train_fusion.py``).

    python -m mode_tpu_torch.cli.train_fusion --datapath-input pred/ \
        --datapath-dataset Deep360/ [--loadmodel fusion.tar] [--bf16]

The reference's trainer: the silog loss (lambda 0.5) over the ground truth
<= ``--maxdepth``, Adam at the constant ``--lr`` (the reference builds Adam
at 1e-3 and sets ``--lr`` before every step), a checkpoint every epoch
(``ckpt_fusion_epoch<epoch>.tar``, the reference's torch layout, no
optimiser state), then the 8-metric validation table on the Cassini maps.
``ModeFusion`` trains through ``training.make_fusion_train_step`` (f32, or
mixed precision with ``--bf16``); with ``--packed_dir`` its training split
is first packed into one ``.mfp`` file a frame (``data/fusion_pack.py``)
and trained from the packs, unpacked on the device. The ``Baseline``
ablation trains through the step inlined below, in f32, as the JAX CLI
inlines it. The scalars go to TensorBoard event files under ``log/``,
opened with ``purge_step=--epoch-start``: ``Training Loss`` and the first
six metrics per epoch. The flags are the JAX CLI's, plus ``--device`` (the
CUDA card by default; ``cpu`` runs the kernels' plain versions) and
``--trace_dir`` (a ``torch.profiler`` trace of the first epoch and the
program's spans, as ``train_disparity`` writes them).

Each batch goes to the device in one copy per array; each step's loss is
read back as the JAX CLI reads it.

On several cards (``torchrun --nproc_per_node W -m
mode_tpu_torch.cli.train_fusion ...``) ``--batch-size`` is the global
batch, split over the ranks as ``cli/train_disparity.py`` splits it, for
both models; ``--dp`` None is the world size and any other value must equal
it. Rank 0 alone packs the frames, writes, validates and prints; the
others wait for it.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from mode_tpu_torch import training
from mode_tpu_torch.cli.common import (METRIC_NAMES, NullWriter, barrier,
                                       count_params, device_batches,
                                       format_table, load_model_checkpoint,
                                       rank_zero, seed_everything,
                                       training_mesh)
from mode_tpu_torch.data.deep360 import Deep360DatasetFusion
from mode_tpu_torch.data.file_lists import list_deep360_fusion_train
from mode_tpu_torch.data.loader import DataLoader
from mode_tpu_torch.device import ieee_f32_convs, upload
from mode_tpu_torch.models.fusion import Baseline, ModeFusion
from mode_tpu_torch.parallel.mesh import activate, batch_sharding
from mode_tpu_torch.utils import metrics
from mode_tpu_torch.utils.checkpoint import save_checkpoint
from mode_tpu_torch.utils.losses import silog_loss
from mode_tpu_torch.utils.profiling import span, trace
from mode_tpu_torch.utils.tb_writer import SummaryWriter


def build_parser():
  p = argparse.ArgumentParser(description="MODE Fusion training (CUDA)")
  p.add_argument("--maxdepth", type=float, default=1000.0)
  p.add_argument("--model", default="ModeFusion",
                 choices=["ModeFusion", "Baseline"])
  p.add_argument("--dbname", default="Deep360")
  p.add_argument("--soiled", action="store_true")
  p.add_argument("--resize", action="store_true")
  p.add_argument("--datapath-input", default="./outputs/Deep360PredDepth/")
  p.add_argument("--datapath-dataset", default="./datasets/Deep360/")
  p.add_argument("--epochs", type=int, default=150)
  p.add_argument("--epoch-start", type=int, default=0)
  p.add_argument("--batch-size", type=int, default=4)
  p.add_argument("--lr", type=float, default=0.0001)
  p.add_argument("--loadmodel", default=None)
  p.add_argument("--savemodel", default="./checkpoints/fusion/")
  p.add_argument("--bf16", action="store_true",
                 help="mixed-precision training (bf16 activations, f32 "
                      "master weights)")
  p.add_argument("--packed_dir", default=None,
                 help="pack the train split into one .mfp file per frame "
                      "under this dir (resumable; data/fusion_pack.py) and "
                      "train from the packs, unpacked on the device "
                      "(ModeFusion only)")
  p.add_argument("--seed", type=int, default=1)
  p.add_argument("--dp", type=int, default=None,
                 help="data-parallel ranks (default: the world size, "
                      "torchrun's --nproc_per_node; any other value must "
                      "equal it)")
  p.add_argument("--steps_per_epoch", type=int, default=None)
  p.add_argument("--trace_dir", default=None,
                 help="write a torch.profiler trace of the first epoch "
                      "there, and the program's spans beside it "
                      "(utils/profiling.py)")
  p.add_argument("--device", default=None,
                 help="torch device; the CUDA card by default, 'cpu' runs "
                      "the kernels' plain versions")
  return p


def make_baseline_step(model: Baseline, optimizer: torch.optim.Optimizer,
                       max_depth: float, plain: bool = False, mesh=None):
  """``step(depths, gt) -> loss``: one f32 update of the ``Baseline``
  ablation, the JAX CLI's inlined step (``mode_tpu/cli/train_fusion.py:
  125-146``): silog (lambda 0.5) over ``gt <= max_depth``, Adam, the BN
  statistics updated. ``plain=True`` runs the kernels' plain versions (a
  reference for the kernels on the card). ``mesh`` as in
  ``training.make_fusion_train_step``: the JAX CLI's step sees the batch
  that ``shard_batch`` spread over the mesh as one global batch."""
  training.replicate(model, mesh)

  def step(depths, gt: torch.Tensor) -> torch.Tensor:
    with span("step"):
      with span("step.inputs"):
        mask = gt <= max_depth
        model.train()
        optimizer.zero_grad(set_to_none=True)
      with ieee_f32_convs(), activate(mesh):
        with span("step.forward"):
          out = model(depths, plain=plain)
        with span("step.loss"):
          loss = silog_loss(training.SILOG_LAMBDA, out[..., 0], gt, mask,
                            mesh)
        with span("step.backward"):
          loss.backward()
      training.sync_gradients(model, mesh)
      with span("step.optimizer"):
        optimizer.step()
      return loss.detach()

  return step


def batch_to_device(batch: dict, keys, device) -> list:
  """``batch[key]`` on ``device``, one copy per array, the per-source
  stacks split into lists of ``(B, H, W, C)`` maps."""
  out = []
  for key in keys:
    x = upload(batch[key], device)
    out.append(x if key == "gt" else [x[:, k] for k in range(x.shape[1])])
  return out


def main(argv=None):
  """Returns each step's loss, and each epoch's mean training loss and
  validation metrics, by epoch."""
  args = build_parser().parse_args(argv)
  mesh = training_mesh(args.dp, 1, args.device)
  device, main_rank = mesh.device, mesh.rank == 0
  log = rank_zero(mesh)
  seed_everything(args.seed)

  td, tc, tr, tg, vd, vc, vr, vg = list_deep360_fusion_train(
      args.datapath_input, args.datapath_dataset, args.soiled)
  packed = bool(args.packed_dir) and args.model == "ModeFusion" \
      and not args.resize
  if args.packed_dir and not packed:
    log("--packed_dir ignored (requires ModeFusion and no --resize)")
  if packed:
    from mode_tpu_torch.data.fusion_pack import (PackedFusionDataset,
                                                 pack_dataset, pack_frame_path)
    out_dir = os.path.join(args.packed_dir, "train")
    if main_rank:
      pack_dataset(td, tc, tr, tg, out_dir, verbose=True)
    barrier()
    paths = [pack_frame_path(out_dir, g) for g in tg]
    train_ds = PackedFusionDataset(paths, gt_names=tg)
  else:
    train_ds = Deep360DatasetFusion(td, tc, tr, tg, resize=args.resize,
                                    training=True)
  val_ds = Deep360DatasetFusion(vd, vc, vr, vg, resize=False, training=False)
  train_loader = DataLoader(train_ds, batch_size=args.batch_size,
                            shuffle=True, num_workers=args.batch_size,
                            seed=args.seed,
                            rows=functools.partial(batch_sharding, mesh))
  val_loader = DataLoader(val_ds, batch_size=8, num_workers=8)

  gen = torch.Generator().manual_seed(0)
  if args.model == "ModeFusion":
    model = ModeFusion(args.maxdepth, device=device, generator=gen)
    keys = ("depths", "confs", "rgbs", "gt")
  else:
    model = Baseline(args.maxdepth, device=device, generator=gen)
    keys = ("depths", "gt")
  if args.loadmodel:
    log("Load pretrained model")
    load_model_checkpoint(args.loadmodel, model)
  log(f"Number of model parameters: {count_params(model)}")

  optimizer = training.make_optimizer(model.parameters())
  training.set_learning_rate(optimizer, args.lr)
  if args.model == "ModeFusion":
    train_step = training.make_fusion_train_step(
        model, optimizer, args.maxdepth,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        raw_inputs=packed, mesh=mesh)
  else:
    train_step = make_baseline_step(model, optimizer, args.maxdepth,
                                    mesh=mesh)

  log_path = os.path.join(args.savemodel, args.model, args.dbname, "log")
  if main_rank:
    os.makedirs(log_path, exist_ok=True)
  writer = (SummaryWriter(log_path, purge_step=args.epoch_start)
            if main_rank else NullWriter())

  out = {"losses": [], "train_loss": {}, "val": {}}
  t_start = time.time()
  for epoch in range(args.epoch_start, args.epoch_start + args.epochs):
    log(f"This is {epoch}-th epoch")
    train_loader.set_epoch(epoch)
    total_loss, nb = 0.0, 0
    first = epoch == args.epoch_start and main_rank
    with trace(args.trace_dir if first else None, device):
      for batch in device_batches(
          train_loader, lambda b: batch_to_device(b, keys, device),
          args.steps_per_epoch):
        loss = float(train_step(*batch))
        out["losses"].append(loss)
        total_loss += loss
        nb += 1
    avg_loss = total_loss / max(nb, 1)
    writer.add_scalar("Training Loss", avg_loss, epoch)
    out["train_loss"][epoch] = avg_loss

    if main_rank:
      save_checkpoint(os.path.join(args.savemodel, args.model, args.dbname,
                                   f"ckpt_fusion_epoch{epoch}.tar"),
                      {"epoch": epoch, "state_dict": model.state_dict(),
                       "train_loss": avg_loss})
      out["val"][epoch] = _validate(args, model, val_loader, keys, device,
                                    writer, epoch)
    barrier()
  log(f"full training time = {(time.time() - t_start) / 3600:.2f} HR")
  writer.close()
  return out


def _validate(args, model, val_loader, keys, device, writer, epoch) -> dict:
  """The epoch's validation, in eval mode and unsharded: the 8 metrics,
  printed as a table and the first six logged; returns them by name."""
  model.eval()
  totals = np.zeros(len(METRIC_NAMES))
  nb = 0
  for i, batch in enumerate(val_loader):
    if args.steps_per_epoch and i >= args.steps_per_epoch:
      break
    *inputs, gt = batch_to_device(batch, keys, device)
    pred = model(*inputs)[..., 0]
    m = metrics.depth_metrics(pred, gt, gt <= args.maxdepth)
    totals += torch.stack([m[k] for k in METRIC_NAMES]).cpu().numpy()
    nb += 1
  mean = totals / max(nb, 1)
  print()
  print(format_table(METRIC_NAMES, [list(mean)]))
  for name, val in zip(METRIC_NAMES[:6], mean[:6]):
    writer.add_scalar(name.split(" ")[0], val, epoch)
  return dict(zip(METRIC_NAMES, mean))


if __name__ == "__main__":
  main()
