"""The disparity -> depth bridge of MODE's reference, in plain PyTorch (f64
unless told otherwise).

For each stereo pair: the sine law on the Cassini panorama gives depth in the
pair's left camera; a pure rotation ("rot") resamples the panorama
bilinearly with border padding; a translation and rotation ("trans")
forward-projects every pixel into camera 1 and keeps, per target pixel, the
nearest point, the first in scan order among equals (the reference's serial
z-buffer, ``utils/geometry.py:depthViewTransWithConf``), with its
confidence. Angle conventions are the reference's: a Cassini panorama
``(H, W)`` has ``theta_i = pi - (2i + 1) pi / H`` along rows and ``phi_j =
pi/2 - (2j + 1) pi / (2W)`` along columns.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SENTINEL = 100000.0
MAX_DEPTH_CLIP = 1000.0


def _angles(n: int, full: bool, device) -> torch.Tensor:
  k = torch.arange(n, dtype=torch.float64, device=device)
  if full:
    return math.pi - (2 * k + 1) * math.pi / n
  return 0.5 * math.pi - (2 * k + 1) * 0.5 * math.pi / n


def _rotation(pitch: float, yaw: float, roll: float, device) -> torch.Tensor:
  """``Rx(roll) @ Rz(yaw) @ Ry(pitch)``, f64."""
  cr, sr = math.cos(roll), math.sin(roll)
  cy, sy = math.cos(yaw), math.sin(yaw)
  cp, sp = math.cos(pitch), math.sin(pitch)
  rx = [[1, 0, 0], [0, cr, -sr], [0, sr, cr]]
  rz = [[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]
  ry = [[cp, 0, -sp], [0, 1, 0], [sp, 0, cp]]
  t = lambda m: torch.tensor(m, dtype=torch.float64, device=device)
  return t(rx) @ t(rz) @ t(ry)


def disp_to_depth(disp: torch.Tensor, baselines: torch.Tensor
                  ) -> torch.Tensor:
  """Sine law, ``(K, H, W)`` disparities (px) -> depth (m): zero disparity
  is the 1000 m far clip, depths past it are clipped, negative ones 0."""
  w = disp.shape[-1]
  phi_l = _angles(w, False, disp.device).to(disp.dtype)
  zero = disp == 0
  phi_r = torch.where(zero, 1.0, disp) * (math.pi / w) + phi_l
  depth = (baselines[:, None, None] * torch.sin(0.5 * math.pi - phi_r)
           / torch.sin(phi_r - phi_l))
  depth = torch.where(zero, MAX_DEPTH_CLIP, depth)
  depth = torch.clamp_max(depth, MAX_DEPTH_CLIP)
  return torch.where(depth < 0, 0.0, depth)


def _unit_rays(h: int, w: int, device) -> torch.Tensor:
  theta = _angles(h, True, device)[:, None].expand(h, w)
  phi = _angles(w, False, device)[None, :].expand(h, w)
  return torch.stack([torch.sin(phi), torch.cos(phi) * torch.sin(theta),
                      torch.cos(phi) * torch.cos(theta)], dim=-1)


def rotate(maps: torch.Tensor, pitch: float, yaw: float, roll: float
           ) -> torch.Tensor:
  """``(C, H, W)`` maps rotated as the reference's ``rotateCassini``:
  bilinear, border padding."""
  _, h, w = maps.shape
  dev, dt = maps.device, maps.dtype
  v = _unit_rays(h, w, dev).to(dt) @ torch.linalg.inv(
      _rotation(pitch, yaw, roll, dev)).T.to(dt)
  theta1 = torch.atan2(v[..., 1], v[..., 2])
  phi1 = torch.asin(torch.clamp(v[..., 0], -1, 1))
  gx = torch.clamp(-phi1 / (0.5 * math.pi), -1, 1)
  gy = torch.clamp(-theta1 / math.pi, -1, 1)
  grid = torch.stack([gx, gy], dim=-1)[None]
  out = F.grid_sample(maps[None], grid, mode="bilinear",
                      padding_mode="border", align_corners=True)
  return out[0]


def reproject(depth: torch.Tensor, conf: torch.Tensor, y0: float, z0: float,
              x0: float, pitch: float, yaw: float, roll: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
  """A depth and confidence map ``(H, W)`` carried into camera 1 through a
  serial z-buffer: per target pixel the least radius, the first source in
  scan order among equal radii; no hit gives depth 0 and confidence 0."""
  h, w = depth.shape
  dev, dt = depth.device, depth.dtype
  d = depth
  pts = d[..., None] * _unit_rays(h, w, dev).to(dt) - torch.tensor(
      [x0, y0, z0], dtype=dt, device=dev)
  p2 = pts @ _rotation(pitch, yaw, roll, dev).T.to(dt)
  r2 = torch.sqrt((p2 * p2).sum(-1))
  theta2 = torch.atan2(p2[..., 1], p2[..., 2])
  phi2 = torch.asin(torch.clamp(p2[..., 0] / torch.where(r2 > 0, r2, 1.0),
                                -1, 1))
  ti = torch.round(h / 2 - theta2 * h / (2 * math.pi)).long().clamp(0, h - 1)
  tj = torch.round(w / 2 - phi2 * w / math.pi).long().clamp(0, w - 1)
  tgt = (ti * w + tj).reshape(-1)
  radius = torch.where(d > 0, r2, math.inf).reshape(-1)
  n = h * w
  best = torch.full((n,), SENTINEL, dtype=dt, device=dev)
  best.scatter_reduce_(0, tgt, radius, "amin", include_self=True)
  hit = (radius < SENTINEL) & (radius == best[tgt])
  src = torch.arange(n, device=dev)
  winner = torch.full((n,), n, dtype=torch.long, device=dev)
  winner.scatter_reduce_(0, tgt, torch.where(hit, src, n), "amin",
                         include_self=True)
  found = winner < n
  out_c = torch.where(found, conf.reshape(-1)[winner.clamp_max(n - 1)], 0.0)
  out_d = torch.where(found, torch.clamp_max(best, MAX_DEPTH_CLIP), 0.0)
  return out_d.reshape(h, w), out_c.reshape(h, w)


def bridge(disps: torch.Tensor, confs: torch.Tensor, rig: dict
           ) -> tuple[torch.Tensor, torch.Tensor]:
  """Six pairs' disparities and confidences ``(6, H, W)`` -> depths and
  confidences in camera 1's frame ``(6, H, W)`` f64. ``rig`` is the
  configuration's: ``pairs``, ``baselines_m`` and ``transforms`` (pair ->
  ``["identity"]``, ``["rot", pitch, yaw, roll]`` or ``["trans", y0, z0,
  x0, pitch, yaw, roll]``), and optionally ``dtype``: the precision the
  bridge computes in (f64 by default)."""
  dtype = rig.get("dtype", torch.float64)
  base = torch.tensor(rig["baselines_m"], dtype=torch.float64,
                      device=disps.device)
  depth = disp_to_depth(disps.to(dtype), base.to(dtype))
  out_d, out_c = [], []
  for k, pair in enumerate(rig["pairs"]):
    kind, *params = rig["transforms"][pair]
    d, c = depth[k], confs[k].to(dtype)
    if kind == "rot":
      d, c = rotate(torch.stack([d, c]), *params)
    elif kind == "trans":
      d, c = reproject(d, c, *params)
    out_d.append(d)
    out_c.append(c)
  return torch.stack(out_d), torch.stack(out_c)
