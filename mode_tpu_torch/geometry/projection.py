"""Projection-domain transforms between Cassini and equirectangular panoramas
(``mode_tpu/geometry/projection.py``).

Images are channel-minor ``(B, H, W, C)``. Each transform's sampling maps
depend only on the shapes (and the rotation), so they are computed once in
numpy f64, cast to f32 exactly as the JAX package casts them, and kept on
the device per (shapes, angles, device); the per-pixel work is the bilinear
gather of ``ops/grid_sample.py``.

Angle conventions (the reference's):
  * a Cassini panorama ``(H, W)`` has ``theta_i = pi - (2 i + 1) pi / H``
    along rows and ``phi_j = pi/2 - (2 j + 1) pi / (2 W)`` along columns;
  * an ERP panorama ``(He, We)`` has latitude ``phi`` along rows and
    longitude ``theta`` along columns, with the same half-pixel offsets;
  * unit sphere: ``x = sin(phi), y = cos(phi) sin(theta),
    z = cos(phi) cos(theta)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mode_tpu_torch.device import upload
from mode_tpu_torch.ops.grid_sample import sample_bilinear_shared


def _axis_angles(n: int, full: bool) -> np.ndarray:
  """The descending angle ladder: ``pi - (2k+1) pi/n`` where ``full``, else
  ``pi/2 - (2k+1) pi/(2n)``, computed in f64 and returned as f32 (the
  reference's ``np.arange(start, end, -step)``)."""
  k = np.arange(n, dtype=np.float64)
  if full:
    return (np.pi - (2.0 * k + 1.0) * np.pi / n).astype(np.float32)
  return (0.5 * np.pi - (2.0 * k + 1.0) * 0.5 * np.pi / n).astype(np.float32)


def rotation_matrix(pitch: float, yaw: float, roll: float) -> np.ndarray:
  """``R = Rx(roll) @ Rz(yaw) @ Ry(pitch)``, f64, the reference's
  composition."""
  cr, sr = np.cos(roll), np.sin(roll)
  cy, sy = np.cos(yaw), np.sin(yaw)
  cp, sp = np.cos(pitch), np.sin(pitch)
  rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], dtype=np.float64)
  rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], dtype=np.float64)
  ry = np.array([[cp, 0, -sp], [0, 1, 0], [sp, 0, cp]], dtype=np.float64)
  return rx @ rz @ ry


def rodrigues(rvec: np.ndarray) -> np.ndarray:
  """The rotation matrix of an axis-angle vector (``cv2.Rodrigues``)."""
  rvec = np.asarray(rvec, dtype=np.float64)
  theta = np.linalg.norm(rvec)
  if theta < 1e-12:
    return np.eye(3)
  k = rvec / theta
  kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
  return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


@functools.lru_cache(maxsize=32)
def _cassini_to_erp_pix(hc: int, wc: int) -> tuple[np.ndarray, np.ndarray]:
  """Pixel sampling maps for Cassini ``(hc, wc)`` -> ERP ``(wc, hc)``."""
  he, we = wc, hc
  theta_e = np.tile(_axis_angles(we, full=True)[None, :],
                    (he, 1)).astype(np.float64)
  phi_e = np.tile(_axis_angles(he, full=False)[:, None],
                  (1, we)).astype(np.float64)
  theta_c = np.arctan2(np.tan(phi_e), np.cos(theta_e))
  phi_c = np.arcsin(np.cos(phi_e) * np.sin(theta_e))
  gx = np.clip(-phi_c / (0.5 * np.pi), -1, 1)    # Cassini width (phi)
  gy = np.clip(-theta_c / np.pi, -1, 1)          # Cassini height (theta)
  x_pix = (gx + 1.0) * 0.5 * (wc - 1)
  y_pix = (gy + 1.0) * 0.5 * (hc - 1)
  return y_pix.astype(np.float32), x_pix.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _rotate_cassini_pix(h: int, w: int, pitch: float, yaw: float,
                        roll: float) -> tuple[np.ndarray, np.ndarray]:
  r_inv = np.linalg.inv(rotation_matrix(pitch, yaw, roll))
  theta2 = np.tile(_axis_angles(h, full=True)[:, None],
                   (1, w)).astype(np.float64)
  phi2 = np.tile(_axis_angles(w, full=False)[None, :],
                 (h, 1)).astype(np.float64)
  x2 = np.sin(phi2)
  y2 = np.cos(phi2) * np.sin(theta2)
  z2 = np.cos(phi2) * np.cos(theta2)
  v = np.stack([x2, y2, z2], axis=-1) @ r_inv.T
  theta1 = np.arctan2(v[..., 1], v[..., 2])
  phi1 = np.arcsin(np.clip(v[..., 0], -1, 1))
  gx = np.clip(-phi1 / (0.5 * np.pi), -1, 1)
  gy = np.clip(-theta1 / np.pi, -1, 1)
  x_pix = (gx + 1.0) * 0.5 * (w - 1)
  y_pix = (gy + 1.0) * 0.5 * (h - 1)
  return y_pix.astype(np.float32), x_pix.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _erp_to_rect_pix(he: int, we: int, ca_h: int, ca_w: int,
                     r_bytes: bytes) -> tuple[np.ndarray, np.ndarray]:
  r = np.frombuffer(r_bytes, dtype=np.float64).reshape(3, 3)
  r_inv = np.linalg.inv(r)
  theta_ca = np.tile(_axis_angles(ca_h, full=True)[:, None],
                     (1, ca_w)).astype(np.float64)
  phi_ca = np.tile(_axis_angles(ca_w, full=False)[None, :],
                   (ca_h, 1)).astype(np.float64)
  x = np.sin(phi_ca)
  y = np.cos(phi_ca) * np.sin(theta_ca)
  z = np.cos(phi_ca) * np.cos(theta_ca)
  v = np.stack([x, y, z], axis=-1) @ r_inv.T
  phi_erp = np.arcsin(np.clip(v[..., 1], -1, 1))
  theta_erp = np.arctan2(v[..., 0], v[..., 2])
  gx = np.clip(-theta_erp / np.pi, -1, 1)          # ERP width (longitude)
  gy = np.clip(-phi_erp / (0.5 * np.pi), -1, 1)    # ERP height (latitude)
  x_pix = (gx + 1.0) * 0.5 * (we - 1)
  y_pix = (gy + 1.0) * 0.5 * (he - 1)
  return y_pix.astype(np.float32), x_pix.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _on_device(maps_fn, args: tuple, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
  """``maps_fn(*args)``'s ``(y, x)`` maps, uploaded once per device."""
  return tuple(upload(m, device) for m in maps_fn(*args))


def cassini_to_erp(cassini: torch.Tensor) -> torch.Tensor:
  """Cassini ``(B, Hc, Wc, C)`` -> ERP ``(B, Wc, Hc, C)``: the reference's
  ``cassini2Equirec``, bilinear, border padding."""
  _, hc, wc, _ = cassini.shape
  y, x = _on_device(_cassini_to_erp_pix, (hc, wc), cassini.device)
  return sample_bilinear_shared(cassini, y, x, "border")


def rotate_cassini(img: torch.Tensor, pitch: float, yaw: float,
                   roll: float) -> torch.Tensor:
  """SO(3)-rotate a Cassini panorama ``(B, H, W, C)``: the reference's
  ``rotateCassini``."""
  _, h, w, _ = img.shape
  y, x = _on_device(_rotate_cassini_pix,
                    (h, w, float(pitch), float(yaw), float(roll)), img.device)
  return sample_bilinear_shared(img, y, x, "border")


def erp_to_rect_cassini(erp: torch.Tensor, r: np.ndarray, ca_h: int,
                        ca_w: int) -> torch.Tensor:
  """Rectify an ERP panorama ``(B, He, We, C)`` into a rotated Cassini view
  ``(B, ca_h, ca_w, C)``: the reference's ``erp2rect_cassini``; ``r`` is a
  numpy rotation matrix (e.g. from :func:`rodrigues`)."""
  _, he, we, _ = erp.shape
  r64 = np.ascontiguousarray(np.asarray(r, dtype=np.float64))
  y, x = _on_device(_erp_to_rect_pix, (he, we, ca_h, ca_w, r64.tobytes()),
                    erp.device)
  return sample_bilinear_shared(erp, y, x, "border")
