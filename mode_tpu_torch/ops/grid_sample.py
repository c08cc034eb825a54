"""Bilinear and nearest 2-D resampling with torch ``grid_sample`` semantics
(``mode_tpu/ops/grid_sample.py``).

Images are channel-minor, ``(H, W, C)`` or ``(B, H, W, C)``, as in the JAX
package; sampling positions are in pixel units. Conventions (torch's, with
``align_corners=True``):

  - ``x`` samples the width (last spatial) axis, ``y`` the height axis;
  - ``padding_mode="border"`` clamps the positions into the image;
  - ``padding_mode="zeros"`` lets out-of-range corners contribute 0.

The corners are gathered by flat index (``index_select``/``gather``), so no
call waits on the host.
"""

from __future__ import annotations

import torch


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
              padding_mode: str, batched: bool) -> torch.Tensor:
  """``img`` ``(B, H, W, C)`` sampled at ``y``/``x``: shared ``(S...)`` maps,
  or per-image ``(B, S...)`` where ``batched``."""
  _, h, w, _ = img.shape
  y = y.float()
  x = x.float()
  if padding_mode == "border":
    y = y.clamp(0.0, h - 1.0)
    x = x.clamp(0.0, w - 1.0)
  y0 = torch.floor(y)
  x0 = torch.floor(x)
  wy = (y - y0)[..., None]
  wx = (x - x0)[..., None]
  y0i = y0.long()
  x0i = x0.long()
  y1i = y0i + 1
  x1i = x0i + 1
  gather = _gather_batched if batched else _gather_shared

  if padding_mode == "zeros":
    def corner(iy, ix):
      valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
      v = gather(img, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
      return torch.where(valid[..., None], v, 0.0)
  else:
    # the positions are clamped, so only the far corners can step out: at
    # the last row or column their weight is 0, and the edge pixel (the JAX
    # package's edge padding) stands in for them
    def corner(iy, ix):
      return gather(img, iy.clamp(0, h - 1), ix.clamp(0, w - 1))

  v00 = corner(y0i, x0i)
  v01 = corner(y0i, x1i)
  v10 = corner(y1i, x0i)
  v11 = corner(y1i, x1i)
  if not batched:
    wy, wx = wy[None], wx[None]
  top = v00 * (1.0 - wx) + v01 * wx
  bot = v10 * (1.0 - wx) + v11 * wx
  return top * (1.0 - wy) + bot * wy


def _gather_shared(img, iy, ix):
  """Pixels of ``img`` ``(B, H, W, C)`` at maps ``(S...)`` that every image
  shares: ``(B, S..., C)``."""
  b, h, w, c = img.shape
  idx = iy * w + ix
  out = img.reshape(b, h * w, c).index_select(1, idx.reshape(-1))
  return out.reshape(b, *idx.shape, c)


def _gather_batched(img, iy, ix):
  """Pixels of ``img`` ``(B, H, W, C)`` at per-image maps ``(B, S...)``:
  ``(B, S..., C)``."""
  b, h, w, c = img.shape
  idx = (iy * w + ix).reshape(b, -1, 1).expand(-1, -1, c)
  out = torch.gather(img.reshape(b, h * w, c), 1, idx)
  return out.reshape(*iy.shape, c)


def _nearest(img, y, x, padding_mode, batched):
  _, h, w, _ = img.shape
  if padding_mode == "border":
    y = y.clamp(0.0, h - 1.0)
    x = x.clamp(0.0, w - 1.0)
  # torch.round rounds half to even, as torch's grid_sample (nearbyint) and
  # jnp.round do
  iy = torch.round(y).long()
  ix = torch.round(x).long()
  gather = _gather_batched if batched else _gather_shared
  v = gather(img, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
  if padding_mode == "zeros":
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    if not batched:
      valid = valid[None]
    v = torch.where(valid[..., None], v, 0.0)
  return v


def _check_mode(padding_mode: str) -> None:
  if padding_mode not in ("border", "zeros"):
    raise ValueError(f"padding_mode must be 'border' or 'zeros', got "
                     f"{padding_mode!r}")


def sample_bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                    padding_mode: str = "border") -> torch.Tensor:
  """Bilinearly sample ``img`` ``(H, W, C)`` at fractional pixel positions
  ``y``, ``x`` (any one shape); returns ``y.shape + (C,)``."""
  _check_mode(padding_mode)
  return _bilinear(img[None], y, x, padding_mode, False)[0]


def sample_nearest(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                   padding_mode: str = "border") -> torch.Tensor:
  """Nearest-neighbour sampling of ``img`` ``(H, W, C)``, torch's
  ``mode="nearest"`` (ties to even)."""
  _check_mode(padding_mode)
  return _nearest(img[None], y, x, padding_mode, False)[0]


def sample_bilinear_shared(imgs: torch.Tensor, y: torch.Tensor,
                           x: torch.Tensor,
                           padding_mode: str = "border") -> torch.Tensor:
  """Every image of ``imgs`` ``(B, H, W, C)`` sampled bilinearly at the same
  positions ``y``, ``x`` ``(S...)``: ``(B, S..., C)``. The projections use
  it with their cached maps."""
  _check_mode(padding_mode)
  return _bilinear(imgs, y, x, padding_mode, False)


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "border",
                align_corners: bool = True) -> torch.Tensor:
  """torch-compatible ``grid_sample`` on channel-minor maps.

  Args:
    img: ``(B, H, W, C)``.
    grid: ``(B, Ho, Wo, 2)`` normalised positions, last axis (x, y) in
      ``[-1, 1]``.
  Returns:
    ``(B, Ho, Wo, C)``.
  """
  if not align_corners:
    raise NotImplementedError("only align_corners=True is used by MODE")
  _check_mode(padding_mode)
  _, h, w, _ = img.shape
  x = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
  y = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
  if mode == "bilinear":
    return _bilinear(img, y, x, padding_mode, True)
  if mode == "nearest":
    return _nearest(img, y, x, padding_mode, True)
  raise ValueError(f"mode must be 'bilinear' or 'nearest', got {mode!r}")
