"""What the reference computes from the benchmark's inputs: a served frame and
the first training steps of each stage, with MODE's losses and Adam.

Inputs arrive as the benchmark made them (uint8 NHWC images, f16 depths,
uint8 confidences, f32 ground truth); everything derived from them is worked
out here again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.bridge import bridge

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SILOG_LAMBDA = 0.5
SUPERVISION = (0.5, 0.7, 1.0)


def normalize(images: torch.Tensor) -> torch.Tensor:
  """uint8 ``(B, H, W, 3)`` -> ImageNet-normalised f32 ``(B, 3, H, W)``."""
  x = images.float().permute(0, 3, 1, 2) / 255.0
  mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
  std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
  return (x - mean) / std


def fusion_inputs(depths, confs, views):
  """The packed wire dtypes unpacked: f16 depths ``(B, H, W, 1)`` to f32,
  uint8 confidences to [0, 1], uint8 views normalised; NCHW lists."""
  return ([d.float().permute(0, 3, 1, 2) for d in depths],
          [c.float().permute(0, 3, 1, 2) / 255.0 for c in confs],
          [normalize(v) for v in views])


@torch.no_grad()
def frame(stage1, fusion, lefts, rights, views, rig: dict,
          judged: dict | None = None) -> dict:
  """One served frame: six pairs ``(6, H, W, 3)`` uint8 through stage 1, the
  bridge and the fusion net (both nets in eval mode). Returns the maps a
  frame is judged on, each f32: ``disp``, ``conf`` ``(6, H, W)``,
  ``depth``, ``depth_conf`` ``(6, H, W)`` and ``fused`` ``(H, W)``. With
  ``judged`` (another side's ``disp``, ``conf``, ``depth`` and
  ``depth_conf``) also the stages that follow stage 1 on that side's
  outputs: ``depth_given``, ``depth_conf_given`` (the bridge of its
  disparities) and ``fused_given`` (the fusion net on its bridged maps)."""
  views = normalize(views)

  def fuse(depth, dconf):
    out = fusion([d[None, None].float() for d in depth],
                 [c[None, None].float() for c in dconf],
                 [v[None] for v in views])
    return out[0, 0].float()

  disp, conf = stage1(normalize(lefts), normalize(rights))
  depth, dconf = bridge(disp, conf, rig)
  out = {"disp": disp.float(), "conf": conf.float(), "depth": depth.float(),
         "depth_conf": dconf.float(), "fused": fuse(depth, dconf)}
  if judged is not None:
    d, c = bridge(judged["disp"], judged["conf"], rig)
    out["depth_given"], out["depth_conf_given"] = d.float(), c.float()
    out["fused_given"] = fuse(judged["depth"], judged["depth_conf"])
  return out


def smooth_l1(pred, gt, mask):
  return F.smooth_l1_loss(pred[mask], gt[mask], reduction="sum") / max(
      int(mask.sum()), 1)


def disparity_loss(model, batch):
  left, right, gt = batch
  mask = ~torch.isnan(gt)
  preds = model(normalize(left), normalize(right))
  return sum(w * smooth_l1(p, gt, mask) for w, p in zip(SUPERVISION, preds))


def silog(pred, gt, mask):
  m = mask & (gt > 0) & (pred > 0)
  d = torch.log(pred[m]) - torch.log(gt[m])
  n = max(int(m.sum()), 1)
  return (d * d).sum() / n - SILOG_LAMBDA * (d.sum() / n) ** 2


def fusion_loss(model, batch, max_depth):
  depths, confs, views, gt = batch
  out = model(*fusion_inputs(depths, confs, views))[:, 0]
  return silog(out, gt, gt <= max_depth)


def train_steps(model, loss_fn, batches, lr: float) -> dict:
  """Adam (betas 0.9, 0.999, eps 1e-8) at ``lr`` over ``batches``, in train
  mode. Returns each step's loss, the first step's outputs and gradient,
  and the parameters after the last step, by name."""
  model.train()
  params = dict(model.named_parameters())
  opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                         eps=1e-8)
  first = []
  hook = model.register_forward_hook(
      lambda m, a, out: first.append(out) if not first else None)
  losses, grads = [], None
  for batch in batches:
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)
    loss.backward()
    if grads is None:
      hook.remove()
      grads = {k: p.grad.detach().clone() for k, p in params.items()
               if p.grad is not None}
    opt.step()
    losses.append(float(loss.detach()))
  out = first[0]
  out = torch.stack(out) if isinstance(out, tuple) else out[:, 0]
  return {"losses": losses, "grads": grads, "out1": out.detach().float(),
          "params": {k: p.detach().clone() for k, p in params.items()}}
