"""Disparity <-> depth conversion and cross-camera depth re-projection
(``mode_tpu/geometry/reprojection.py``).

The reference's bridge forward-projects every source pixel into the target
panorama and resolves collisions in a serial loop: the first strictly
smaller radius wins. :func:`_zbuffer_resolve` computes the same winner in
the JAX package's three forms (:func:`set_zbuffer_impl`): by default one
stable sort by (target, radius bits) and a scatter of each target's run
start (``"sort"``), or two scatter-mins (``"scatter"``), or two stable sorts
(``"sort2x"``). Each gives the JAX package's and the reference's winner,
first-come tie-break included.

Every constant a call needs (the phi map, the rays, R and t) is computed
once per shape and kept on the device; a call makes no upload and nothing
in it waits on the host. The 3x3 rotation is written out as multiply-adds:
a ``(..., 3) @ (3, 3)`` matmul may run as TF32 on the card, which would
move points across the z-buffer's cells. The arithmetic is the JAX
package's as XLA compiles it (see :func:`_per_radian`), and ``sqrt``,
``sin``, ``atan2`` and ``asin`` are rounded once from f64 (:func:`_f32`),
so the card and the CPU agree but in rare ties. From the same depth map the
radii are then bit-equal to the JAX package's on the CPU. Its ``sin``
(glibc's ``sinf``, through XLA) is not correctly rounded: the sine law's
depths differ from it in the last bit at a few percent of pixels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mode_tpu_torch.device import upload
from mode_tpu_torch.geometry.projection import (_axis_angles, rotate_cassini,
                                                rotation_matrix)

_SENTINEL = 100000.0      # the reference's z-buffer init
_MAX_DEPTH_CLIP = 1000.0  # the reference's hard clip
_SENTINEL_BITS = int(np.array([_SENTINEL], np.float32).view(np.int32)[0])

# Deep360 camera rig: pair name -> stereo baseline in meters
DEEP360_BASELINES = {
    "12": 1.0, "13": 1.0, "14": math.sqrt(2.0),
    "23": math.sqrt(2.0), "24": 1.0, "34": 1.0,
}

# The real fisheye rig's baselines
FISHEYE_BASELINES = {
    "12": 0.6 * math.sqrt(2.0), "13": 0.6 * math.sqrt(2.0), "14": 1.2,
    "23": 1.2, "24": 0.6 * math.sqrt(2.0), "34": 0.6 * math.sqrt(2.0),
}

# Pair name -> the SE(3) that carries the pair's reference view into camera
# 1's frame: a pure rotation of the panorama ("rot", (pitch, yaw, roll)) or
# a translation and rotation with re-projection ("trans", (y0, z0, x0,
# pitch, yaw, roll)).
DEEP360_PAIR_TRANSFORMS = {
    "12": ("identity", None),
    "13": ("rot", (0.5 * math.pi, 0.0, 0.0)),
    "14": ("rot", (0.25 * math.pi, 0.0, 0.0)),
    "23": ("trans", (0.0, -math.sqrt(2.0) / 2, -math.sqrt(2.0) / 2,
                     0.75 * math.pi, 0.0, 0.0)),
    "24": ("trans", (0.0, -1.0, 0.0, 0.5 * math.pi, 0.0, 0.0)),
    "34": ("trans", (0.0, 1.0, 0.0, 0.0, 0.0, 0.0)),
}


def _f32(fn, *args: torch.Tensor) -> torch.Tensor:
  """``fn(*args)`` for f32 ``args``, computed in f64 and rounded once to
  f32: correctly rounded but in rare ties, and so the same on the CPU and
  on the card (PyTorch's own f32 ``sqrt`` on the CPU, and its ``sin`` and
  ``atan2`` on either, are not correctly rounded, and differ between
  them)."""
  return fn(*(a.double() for a in args)).float()


def _per_radian(n: int, angle: float) -> float:
  """``n / angle`` in f32 arithmetic. ``n * a / angle`` is computed as ``a *
  _per_radian(n, angle)``: one product, as XLA folds the JAX package's
  ``n * a / angle`` (a multiply and a divide by constants), so the cells the
  points land in are the JAX package's."""
  return float(np.float32(n) / np.float32(angle))


@functools.lru_cache(maxsize=32)
def _phi_map(h: int, w: int, device: torch.device) -> torch.Tensor:
  """The latitude-like angle along Cassini columns, ``(h, w)`` f32."""
  phi = np.tile(_axis_angles(w, full=False)[None, :], (h, 1))
  return upload(phi.astype(np.float32), device)


def cassini_disp_to_depth(disp: torch.Tensor, baseline) -> torch.Tensor:
  """Sine-law disparity -> depth on Cassini panoramas ``(..., H, W)``:
  ``depth = b sin(pi/2 - phi_r) / sin(phi_r - phi_l)`` with ``phi_r = disp
  pi / W + phi_l``; zero disparity maps to the 1000 m far clip, negative
  depth to 0. ``baseline`` is a float or a tensor that broadcasts against
  ``disp`` (one baseline per map)."""
  h, w = disp.shape[-2], disp.shape[-1]
  phi_l = _phi_map(h, w, disp.device)
  zero = disp == 0
  safe = torch.where(zero, 1.0, disp)
  phi_r = safe * (np.pi / w) + phi_l
  depth = (baseline * _f32(torch.sin, 0.5 * np.pi - phi_r)
           / _f32(torch.sin, phi_r - phi_l))
  depth = torch.where(zero, _MAX_DEPTH_CLIP, depth)
  depth = torch.where(depth > _MAX_DEPTH_CLIP, _MAX_DEPTH_CLIP, depth)
  return torch.where(depth < 0, 0.0, depth)


def depth_to_cassini_disp(depth: torch.Tensor, baseline: float,
                          max_depth: float) -> torch.Tensor:
  """Closed-form depth -> disparity of a Cassini stereo pair ``(..., H, W)``
  (the 3D60 loader's ``__depth2disp``): depths <= 0 or > ``max_depth``
  become NaN, negative disparities 0."""
  h, w = depth.shape[-2], depth.shape[-1]
  phi_l = _phi_map(h, w, depth.device)
  invalid = (depth <= 0) | (depth > max_depth)
  d = torch.where(invalid, 1.0, depth)
  denom = _f32(torch.sqrt, d * d + baseline * baseline
               - 2.0 * d * baseline * _f32(torch.cos, phi_l + 0.5 * np.pi))
  ratio = torch.clamp((d * _f32(torch.sin, phi_l) + baseline) / denom,
                      -1.0, 1.0)
  disp = (_f32(torch.asin, ratio) - phi_l) * _per_radian(w, np.pi)
  disp = torch.where(invalid, torch.nan, disp)
  return torch.where(disp < 0, 0.0, disp)


@functools.lru_cache(maxsize=16)
def _view_transform_consts(h: int, w: int, transforms: tuple,
                           device: torch.device):
  """The unit rays ``(K, h, w, 3)``, rotations ``(K, 3, 3)`` and
  translations ``(K, 3)`` of K transforms ``(y0, z0, x0, pitch, yaw,
  roll)``, f32 on ``device``."""
  theta1 = np.tile(_axis_angles(h, full=True)[:, None],
                   (1, w)).astype(np.float64)
  phi1 = np.tile(_axis_angles(w, full=False)[None, :],
                 (h, 1)).astype(np.float64)
  ray = np.stack([np.sin(phi1), np.cos(phi1) * np.sin(theta1),
                  np.cos(phi1) * np.cos(theta1)], axis=-1).astype(np.float32)
  rots = [rotation_matrix(p, yw, rl) for _, _, _, p, yw, rl in transforms]
  trs = [(x0, y0, z0) for y0, z0, x0, *_ in transforms]
  as_dev = lambda a: upload(np.ascontiguousarray(
      np.asarray(a, np.float64).astype(np.float32)), device)
  return (as_dev(np.broadcast_to(ray, (len(transforms), h, w, 3))),
          as_dev(rots), as_dev(trs))


def _reproject(depths: torch.Tensor, confs: torch.Tensor,
               transforms: tuple) -> tuple[torch.Tensor, torch.Tensor]:
  """K depth + confidence maps ``(K, H, W)`` re-projected, each by its
  transform, with one z-buffer sort over the K problems (each pair's
  targets offset by ``k H W``, so the runs never mix)."""
  k_n, h, w = depths.shape
  dev = depths.device
  ray, r, t = _view_transform_consts(h, w, transforms, dev)
  # points in camera A, less the translation
  d = depths[..., None] * ray - t[:, None, None, :]
  d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
  rk = r[:, None, None]                            # (K, 1, 1, 3, 3)
  # the rotation as multiply-adds (no matmul: see the module note): points
  # in camera B
  x2 = [d0 * rk[..., i, 0] + d1 * rk[..., i, 1] + d2 * rk[..., i, 2]
        for i in range(3)]
  r2 = _f32(torch.sqrt, x2[0] * x2[0] + x2[1] * x2[1] + x2[2] * x2[2])
  r2_safe = torch.where(r2 > 0, r2, 1.0)
  theta2 = _f32(torch.atan2, x2[1], x2[2])
  phi2 = _f32(torch.asin, torch.clamp(x2[0] / r2_safe, -1.0, 1.0))
  # torch.round rounds half to even, as jnp.round does
  ti = torch.clamp(torch.round(h / 2 - theta2 * _per_radian(h, 2 * np.pi)),
                   0, h - 1).long()
  tj = torch.clamp(torch.round(w / 2 - phi2 * _per_radian(w, np.pi)),
                   0, w - 1).long()
  n = h * w
  offs = (torch.arange(k_n, device=dev) * n)[:, None, None]
  tgt = (offs + ti * w + tj).reshape(-1)
  r2f = torch.where(depths > 0, r2, torch.inf).reshape(-1)

  best, winner = _zbuffer_resolve(r2f, tgt, k_n * n)
  has_winner = (winner < k_n * n) & (best < _SENTINEL)
  conf_out = torch.where(
      has_winner, torch.take(confs, winner.clamp(0, k_n * n - 1)), 0.0)
  view_out = torch.where(best >= _SENTINEL, 0.0, best)
  view_out = torch.where(view_out > _MAX_DEPTH_CLIP, _MAX_DEPTH_CLIP,
                         view_out)
  return view_out.reshape(k_n, h, w), conf_out.reshape(k_n, h, w)


_ZBUFFER_IMPL = "sort"   # "scatter" | "sort" | "sort2x" (set_zbuffer_impl)


def set_zbuffer_impl(impl: str) -> None:
  """Select the form of :func:`_zbuffer_resolve` that every re-projection
  takes (the JAX package's ``set_zbuffer_impl``): ``"scatter"``, ``"sort"``
  (the default) or ``"sort2x"``. The three are elementwise bit-equal and
  differ only in speed."""
  global _ZBUFFER_IMPL
  if impl not in ("scatter", "sort", "sort2x"):
    raise ValueError(f"unknown z-buffer form {impl!r}: "
                     "expected 'scatter', 'sort' or 'sort2x'")
  _ZBUFFER_IMPL = impl


def _zbuffer_resolve(r2f: torch.Tensor, tgt: torch.Tensor, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
  """Per target pixel, the least radius and the least flattened source
  index among the hits with that radius, in the form
  :func:`set_zbuffer_impl` selected.

  Args:
    r2f: ``(n,)`` f32 radii, ``inf`` where the source is invalid.
    tgt: ``(n,)`` target index of each source, in ``[0, n)``.
  Returns:
    ``best`` ``(n,)`` f32, at most ``_SENTINEL``, and ``winner`` ``(n,)``
    int64, ``n`` where no source hit.

  * ``"scatter"``: two scatter-mins, the radius and then the least source
    among the hits at that radius. A minimum does not depend on the order
    in which the card's atomics land, so it is exact there too.
  * ``"sort"``: one stable sort of int64 keys ``tgt << 32 | bits``,
    ``bits`` the radius (capped at ``_SENTINEL``, so ``inf`` sorts as the
    sentinel) as its f32 bit pattern: a radius >= 0 orders as its bits, and
    stability keeps the sources in ascending order within equal keys, the
    serial loop's first-come tie-break. The sort's indices are the sources.
    The first entry of each target's run is its winner, scattered to its
    target into an ``n + 1`` buffer whose last slot takes every other entry
    and is cut off (the JAX package scatters with ``mode="drop"``).
  * ``"sort2x"``: one sentinel entry per target (radius ``_SENTINEL``,
    source ``n``) appended, so every target has a run; the 2n entries
    sorted stably as in ``"sort"``; then a second stable sort on
    ``1 - start`` brings the n run starts to the front in target order.

  A real entry capped at exactly ``_SENTINEL`` wins its target in the sort
  forms and not in ``"scatter"``; the caller's ``best < _SENTINEL``
  discards it in all three.
  """
  if _ZBUFFER_IMPL == "scatter":
    return _zbuffer_scatter(r2f, tgt, n)
  r2_cap = torch.clamp_max(r2f, _SENTINEL)
  bits = r2_cap.contiguous().view(torch.int32).long() & 0xFFFFFFFF
  key = (tgt.long() << 32) | bits
  if _ZBUFFER_IMPL == "sort2x":
    return _zbuffer_sort2x(key, n)
  s_key, s_src = torch.sort(key, stable=True)
  s_tgt = s_key >> 32
  start = torch.ones_like(s_tgt, dtype=torch.bool)
  start[1:] = s_tgt[1:] != s_tgt[:-1]
  idx = torch.where(start, s_tgt, n)
  best_bits = torch.full((n + 1,), _SENTINEL_BITS, dtype=torch.int32,
                         device=r2f.device)
  best_bits.scatter_(0, idx, (s_key & 0xFFFFFFFF).int())
  winner = torch.full((n + 1,), n, dtype=torch.long, device=r2f.device)
  winner.scatter_(0, idx, s_src)
  return best_bits[:n].view(torch.float32), winner[:n]


def _zbuffer_scatter(r2f: torch.Tensor, tgt: torch.Tensor, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
  """The ``"scatter"`` form of :func:`_zbuffer_resolve`."""
  dev = r2f.device
  tgt = tgt.long()
  best = torch.full((n,), _SENTINEL, dtype=torch.float32, device=dev)
  best.scatter_reduce_(0, tgt, r2f, "amin", include_self=True)
  contender = (r2f < _SENTINEL) & (r2f == best[tgt])
  src = torch.arange(n, device=dev)
  winner = torch.full((n,), n, dtype=torch.long, device=dev)
  winner.scatter_reduce_(0, tgt, torch.where(contender, src, n), "amin",
                         include_self=True)
  return best, winner


def _zbuffer_sort2x(key: torch.Tensor, n: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
  """The ``"sort2x"`` form of :func:`_zbuffer_resolve` on the ``"sort"``
  form's keys."""
  dev = key.device
  sentinels = (torch.arange(n, device=dev) << 32) | _SENTINEL_BITS
  all_src = torch.cat([torch.arange(n, device=dev),
                       torch.full((n,), n, dtype=torch.long, device=dev)])
  s_key, order = torch.sort(torch.cat([key, sentinels]), stable=True)
  s_tgt = s_key >> 32
  later = torch.ones_like(s_tgt, dtype=torch.int32)
  later[0] = 0
  later[1:] = (s_tgt[1:] == s_tgt[:-1]).int()     # 1 - start
  # every target has a run (its sentinel), so there are exactly n run
  # starts, and the k-th in order belongs to target k
  _, front = torch.sort(later, stable=True)
  first = front[:n]
  best = (s_key[first] & 0xFFFFFFFF).int().view(torch.float32)
  return best, all_src[order[first]]


def depth_view_transform_with_conf(depth: torch.Tensor, conf: torch.Tensor,
                                   y0: float, z0: float, x0: float,
                                   pitch: float, yaw: float, roll: float
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
  """Re-project a Cassini depth + confidence map ``(H, W)`` into another
  camera's frame with z-buffer collision resolution (the reference's
  ``depthViewTransWithConf``; its argument order)."""
  transform = tuple(float(v) for v in (y0, z0, x0, pitch, yaw, roll))
  d, c = _reproject(depth[None], conf[None], (transform,))
  return d[0], c[0]


def depth_view_transforms_batched(depths: torch.Tensor, confs: torch.Tensor,
                                  transforms: tuple
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
  """K re-projections ``(K, H, W)`` in one z-buffer sort, bit-equal to K
  calls of :func:`depth_view_transform_with_conf`; ``transforms`` holds K
  tuples ``(y0, z0, x0, pitch, yaw, roll)``."""
  transforms = tuple(tuple(float(v) for v in t) for t in transforms)
  return _reproject(depths, confs, transforms)


def disp_to_depth_at_cam1(disp: torch.Tensor, conf: torch.Tensor,
                          cam_pair: str, baselines: dict | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
  """The bridge for one Deep360 pair: disparity ``(H, W)`` -> depth in
  camera 1's frame and the confidence carried with it (the reference's
  ``disp2depth``)."""
  b = (baselines or DEEP360_BASELINES)[cam_pair]
  depth_l = cassini_disp_to_depth(disp, b)
  kind, params = DEEP360_PAIR_TRANSFORMS[cam_pair]
  if kind == "identity":
    return depth_l, conf
  if kind == "rot":
    both = torch.stack([depth_l, conf], dim=-1)[None]     # (1, H, W, 2)
    rot = rotate_cassini(both, *params)[0]
    return rot[..., 0], rot[..., 1]
  return depth_view_transform_with_conf(depth_l, conf, *params)
