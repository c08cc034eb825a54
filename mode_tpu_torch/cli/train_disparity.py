"""Training stage 1 (``mode_tpu/cli/train_disparity.py``).

    python -m mode_tpu_torch.cli.train_disparity --dataset_root Deep360/ \
        [--checkpoint_disp disp.tar [--resume | --loadSHGonly]] [--bf16]

The reference's trainer: its flags, Adam at ``--learning_rate`` times 0.1
after epoch ``--start_decay``, the deep-supervision loss
(``training.make_disparity_train_step``, f32, or mixed precision with
``--bf16``), a checkpoint every epoch
(``ckpt_disp_<model>_<dataset>_<epoch>.tar``, the reference's torch layout,
which the serving CLIs read; no optimiser state, as the JAX CLI saves none,
so ``--resume`` restarts Adam), then a validation pass: EPE and D1 over the
ground truth in (0, max_disp], in eval mode and f32, and the first batch's
colormap ``outputs/<epoch>_val.png``. The scalars go to TensorBoard event
files under ``logs/``: ``loss disp`` per step, ``total disp train loss`` and
the validation's per epoch. The flags are the JAX CLI's, plus ``--device``
(the CUDA card by default; ``cpu`` runs the kernels' plain versions).

Each batch goes to the device in one copy per array (uint8 images with
``--device_normalize``, normalised there by the step); each step's loss is
read back as the JAX CLI reads it.

On several cards, one process each:

    torchrun --nproc_per_node W -m mode_tpu_torch.cli.train_disparity ...

``--batch_size`` is the global batch, split over the ranks as the JAX
CLI's ``make_mesh(data=--dp, spatial=--sp)`` splits it
(``parallel/mesh.py``): the ``--dp`` data indices take its rows, every
rank shuffling the same way and decoding only its data index's rows, and
the ``--sp`` spatial ranks of a data index split the cost volume's H (each
runs the feature extractor on the whole images, then its rows of the 3-D
stack and of the heads, and takes its rows of the ground truth). The BN
statistics and the loss are the global batch's and the gradients are
averaged over every rank, so every rank takes the same step. The world
must be ``--dp x --sp`` (``--dp`` None: the world size over ``--sp``), and
under ``--sp`` above 1 ``--height`` a multiple of 16 x ``--sp`` (every
rank's rows of the 1/4 and 1/8 levels even, as the stride-2 convs need).
Rank 0 alone writes the checkpoints, event files, trace and validation
images, runs the validation (unsharded, as the JAX CLI runs it) and
prints; the others wait for it. ``--resume`` and ``--loadSHGonly`` load on
every rank.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from mode_tpu_torch import training
from mode_tpu_torch.cli.common import (NullWriter, barrier, count_params,
                                       device_batches,
                                       load_model_checkpoint, rank_zero,
                                       seed_everything, training_mesh)
from mode_tpu_torch.data.deep360 import Deep360DatasetDisparity
from mode_tpu_torch.data.file_lists import list_deep360_disparity_train
from mode_tpu_torch.data.loader import DataLoader
from mode_tpu_torch.device import upload
from mode_tpu_torch.parallel.mesh import batch_sharding
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.models.initialize import INIT_TYPES, init_model_params
from mode_tpu_torch.utils import metrics
from mode_tpu_torch.utils.checkpoint import save_checkpoint
from mode_tpu_torch.utils.colormap import save_colormapped
from mode_tpu_torch.utils.profiling import trace
from mode_tpu_torch.utils.tb_writer import SummaryWriter


def build_parser():
  p = argparse.ArgumentParser(
      description="MODE Disparity estimation training (CUDA)")
  p.add_argument("--model_disp", default="ModeDisparity")
  p.add_argument("--dataset", default="Deep360",
                 choices=["Deep360", "3D60"])
  p.add_argument("--dataset_root", default="../../datasets/Deep360/")
  p.add_argument("--filenames_train", default=None,
                 help="3D60: filenames .txt for the training split")
  p.add_argument("--filenames_val", default=None,
                 help="3D60: filenames .txt for the validation split")
  p.add_argument("--pair", default="all", choices=["lr", "ud", "ur", "all"],
                 help="3D60: stereo pair selection")
  p.add_argument("--max_depth_3d60", type=float, default=20.0)
  p.add_argument("--width", default=512, type=int)
  p.add_argument("--height", default=1024, type=int)
  p.add_argument("--max_disp", type=int, default=192)
  p.add_argument("--max_depth", default=1000, type=float)
  p.add_argument("--epochs", type=int, default=55)
  p.add_argument("--start_decay", type=int, default=45)
  p.add_argument("--batch_size", type=int, default=4)
  p.add_argument("--learning_rate", type=float, default=0.001)
  p.add_argument("--resume", action="store_true")
  p.add_argument("--checkpoint_disp", default=None)
  p.add_argument("--loadSHGonly", action="store_true")
  p.add_argument("--soiled", action="store_true")
  p.add_argument("--crop_disp", action="store_true")
  p.add_argument("--init_type", default="default", choices=INIT_TYPES,
                 help="weight re-initialization menu (initModel.py:9-32)")
  p.add_argument("--trace_dir", default=None,
                 help="write a torch.profiler trace of the first epoch "
                      "there, and the program's spans beside it "
                      "(utils/profiling.py)")
  p.add_argument("--bf16", action="store_true",
                 help="mixed-precision training (bf16 activations, f32 "
                      "master weights and loss)")
  p.add_argument("--device_normalize", action="store_true",
                 help="send raw uint8 RGB to the device (4x fewer bytes) "
                      "and ImageNet-normalise it there in the train step")
  p.add_argument("--seed", type=int, default=123)
  p.add_argument("--save_checkpoint_path", default="./checkpoints/disp/")
  p.add_argument("--dp", type=int, default=None,
                 help="data-parallel ranks (default: the world size over "
                      "--sp; --dp x --sp must be the world size, "
                      "torchrun's --nproc_per_node)")
  p.add_argument("--sp", type=int, default=1,
                 help="spatial-parallel ranks of each data index: they "
                      "split the cost volume's H (--height a multiple of "
                      "16 x --sp)")
  p.add_argument("--steps_per_epoch", type=int, default=None,
                 help="debug: truncate epochs to N steps")
  p.add_argument("--device", default=None,
                 help="torch device; the CUDA card by default, 'cpu' runs "
                      "the kernels' plain versions")
  return p


def check_spatial_rows(height: int, spatial: int) -> None:
  """Refuse a ``--height`` that the spatial ranks cannot split: each
  rank's rows of the 1/4 and 1/8 levels must be even (the stride-2 convs'
  rows start on an even row), so H % (16 x --sp) == 0."""
  if spatial > 1 and height % (16 * spatial):
    raise ValueError(f"--height {height} does not split over --sp "
                     f"{spatial}: the stride-2 convs need H % (16 x --sp) "
                     "== 0")


def main(argv=None):
  """Returns each step's loss, and each epoch's mean training loss and
  validation (EPE, D1; on rank 0), by epoch."""
  args = build_parser().parse_args(argv)
  mesh = training_mesh(args.dp, args.sp, args.device)
  check_spatial_rows(args.height, mesh.spatial)
  device, main_rank = mesh.device, mesh.global_rank == 0
  log = rank_zero(mesh)
  seed_everything(args.seed)

  save_root = os.path.join(args.save_checkpoint_path, args.model_disp,
                           args.dataset)
  image_path = os.path.join(save_root, "outputs")
  if main_rank:
    os.makedirs(os.path.join(save_root, "logs"), exist_ok=True)
    os.makedirs(image_path, exist_ok=True)
  writer = (SummaryWriter(os.path.join(save_root, "logs")) if main_rank
            else NullWriter())

  log(f"Preparing data. Dataset: <{args.dataset}>")
  if args.dataset == "Deep360":
    tl, tr, td, vl, vr, vd = list_deep360_disparity_train(
        args.dataset_root, soiled=args.soiled)
    train_ds = Deep360DatasetDisparity(tl, tr, td,
                                       shape=(args.height, args.width),
                                       crop=args.crop_disp,
                                       device_normalize=args.device_normalize)
    val_ds = Deep360DatasetDisparity(vl, vr, vd,
                                     shape=(args.height, args.width))
  else:  # 3D60 (512x256 Cassini, sine-law gt disparity from depth)
    from mode_tpu_torch.data.three_d60 import Dataset3D60Disparity
    train_ds = Dataset3D60Disparity(
        args.filenames_train, args.dataset_root, "training",
        shape=(args.height, args.width), crop=args.crop_disp,
        pair=args.pair, max_depth=args.max_depth_3d60)
    val_ds = Dataset3D60Disparity(
        args.filenames_val, args.dataset_root, "validation",
        shape=(args.height, args.width), pair="lr",
        max_depth=args.max_depth_3d60)
  log(f"Num of training data:{len(train_ds)}. "
        f"Num of validation data:{len(val_ds)}")
  train_loader = DataLoader(train_ds, batch_size=args.batch_size,
                            num_workers=4, shuffle=True, seed=args.seed,
                            rows=functools.partial(batch_sharding, mesh))
  val_loader = DataLoader(val_ds, batch_size=args.batch_size, num_workers=4)

  model = ModeDisparity(args.max_disp, "Sphere", "Cassini", out_conf=False,
                        device=device,
                        generator=torch.Generator().manual_seed(args.seed))
  if args.init_type != "default":
    init_model_params(model, args.init_type,
                      torch.Generator().manual_seed(args.seed + 1))
    log(f"initialize model <{args.model_disp}> as type <{args.init_type}>")
  log(f"Number of model parameters: {count_params(model)}")

  start_epoch = 0
  if args.checkpoint_disp and args.checkpoint_disp != "None":
    ckpt_epoch = load_model_checkpoint(args.checkpoint_disp, model,
                                       shg_only=args.loadSHGonly)
    if args.resume:
      start_epoch = ckpt_epoch
    log(f"loaded checkpoint <{args.checkpoint_disp}> "
          f"(SHG-only={args.loadSHGonly}, resume from epoch {start_epoch})")

  optimizer = training.make_optimizer(model.parameters())
  train_step = training.make_disparity_train_step(
      model, optimizer, compute_dtype=torch.bfloat16 if args.bf16 else None,
      mesh=mesh)

  out = {"losses": [], "train_loss": {}, "val": {}}
  global_step = 0
  for epoch in range(start_epoch + 1, args.epochs + 1):
    t0 = time.time()
    lr = training.learning_rate(epoch, args.learning_rate, args.start_decay)
    training.set_learning_rate(optimizer, lr)
    log(f"Epoch: {epoch}, Current Stage: Disp, "
          f"Current Learning Rate: {lr}")
    train_loader.set_epoch(epoch)

    total_loss, n_batches = 0.0, 0
    first = epoch == start_epoch + 1 and main_rank
    with trace(args.trace_dir if first else None, device):
      for left, right, disp in device_batches(
          train_loader, lambda b: [upload(b[k], device) for k in
                                   ("leftImg", "rightImg", "dispMap")],
          args.steps_per_epoch):
        loss = float(train_step(left, right, disp))
        total_loss += loss
        n_batches += 1
        global_step += 1
        writer.add_scalar("loss disp", loss, global_step)
        out["losses"].append(loss)
    avg_loss = total_loss / max(n_batches, 1)
    writer.add_scalar("total disp train loss", avg_loss, epoch)
    out["train_loss"][epoch] = avg_loss
    log(f"epoch: {epoch}, avg train loss: {avg_loss}")

    if main_rank:
      save_checkpoint(
          os.path.join(save_root, f"ckpt_disp_{args.model_disp}_"
                       f"{args.dataset}_{epoch}.tar"),
          {"epoch": epoch, "state_dict": model.state_dict(),
           "train_loss": avg_loss})
      out["val"][epoch] = _validate(args, model, val_loader, device, writer,
                                    image_path, epoch)
    barrier()
    log(f"Time of This epoch: {time.time() - t0} seconds")
  writer.close()
  return out


def _validate(args, model, val_loader, device, writer, image_path,
              epoch) -> tuple[float, float]:
  """The epoch's validation, in eval mode and unsharded: EPE and D1, the
  first batch's colormap; returns (EPE, D1)."""
  model.eval()
  total_epe, total_d1, counter = 0.0, 0.0, 0
  for i, batch in enumerate(val_loader):
    if args.steps_per_epoch and i >= args.steps_per_epoch:
      break
    left, right, gt = (upload(batch[k], device) for k in
                       ("leftImg", "rightImg", "dispMap"))
    mask = (gt > 0) & torch.isfinite(gt) & (gt <= args.max_disp)
    gt = torch.nan_to_num(gt)
    pred = model(left, right)
    epe, d1 = torch.stack([metrics.mae(pred, gt, mask),
                           metrics.d1(3, 0.05, pred, gt, mask)]).tolist()
    if i == 0:
      g, p, m = (t[0].cpu().numpy() for t in (gt, pred, mask))
      save_colormapped(os.path.join(image_path, f"{epoch:03d}_val.png"),
                       np.concatenate([g, p], 1), np.concatenate([m, m], 1))
    total_epe += epe
    total_d1 += d1
    counter += gt.shape[0]
  val_epe, val_d1 = total_epe / max(counter, 1), total_d1 / max(counter, 1)
  writer.add_scalar("total disp validation loss", val_epe, epoch)
  writer.add_scalar("total disp validation d1", val_d1, epoch)
  print(f"epoch: {epoch}, avg val loss: {val_epe}, avg val d1 {val_d1}")
  return val_epe, val_d1


if __name__ == "__main__":
  main()
