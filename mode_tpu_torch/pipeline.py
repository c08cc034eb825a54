"""The whole frame: six stereo pairs through stage 1, the disparity -> depth
bridge, and fusion (``mode_tpu/pipeline.py``; ``predict --stage all``
without the CLI).

The reference runs its two stages through the filesystem. Here a frame
stays on the device from its input images to the fused depth map: it
uploads its inputs and nothing else (the bridge's and the normalisation's
constants are kept on the device), and no step waits on the host.

Under ``with activate(make_mesh(data=1, spatial=S)):`` (``parallel/``, one
process a card) every rank serves the frame over the spatial axis: stage 1
on its rows of every chunk (``models/disparity.py``), one ``gather_rows`` of
the disparities and one of the confidences, the bridge whole on every rank
(its re-projection moves pixels across rows), the fusion net on its rows of
the bridged maps and the views (``models/fusion.py``), and one
``gather_rows`` of the fused map: every rank returns the whole frame. The
frame's fusion runs at batch 1, so a data axis above 1 raises.

A frame opens the tracer's spans (``utils/profiling.py``) ``frame``, and
inside it ``frame.stage1``, ``frame.gather`` (under a spatial mesh),
``frame.bridge`` and ``frame.fusion``.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import torch

from mode_tpu_torch.device import resolve_device, upload
from mode_tpu_torch.geometry.projection import rotate_cassini
from mode_tpu_torch.geometry.reprojection import (
    DEEP360_BASELINES, DEEP360_PAIR_TRANSFORMS, cassini_disp_to_depth,
    depth_view_transforms_batched)
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.models.fusion import ModeFusion
from mode_tpu_torch.parallel.mesh import Mesh, active_mesh, gather_rows
from mode_tpu_torch.training import (cast_conv_params,
                                     normalize_rgb_on_device)
from mode_tpu_torch.utils.convert import load_reference_state_dict
from mode_tpu_torch.utils.profiling import span

CAM_PAIRS = ("12", "13", "14", "23", "24", "34")
# the "trans" pairs, the last three: a slice, so that selecting them makes
# no index tensor (an upload on the card)
_TRANS = slice(3, 6)
assert all((DEEP360_PAIR_TRANSFORMS[p][0] == "trans")
           == (k >= _TRANS.start) for k, p in enumerate(CAM_PAIRS))


@functools.lru_cache(maxsize=8)
def _baselines(device: torch.device) -> torch.Tensor:
  """The pairs' baselines ``(6, 1, 1)`` f32, uploaded once per device."""
  return upload(torch.tensor([DEEP360_BASELINES[p] for p in CAM_PAIRS],
                             dtype=torch.float32), device)[:, None, None]


def bridge_all_pairs(disps: torch.Tensor, confs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
  """The six pairs' disparities and confidences ``(6, H, W)``, pair order
  ``CAM_PAIRS``, as depth maps and confidences in camera 1's frame ``(6, H,
  W)``: the sine law per pair, then pair 12 as it is, the two "rot" pairs
  rotated, the three "trans" pairs re-projected in one z-buffer sort
  (bit-equal to three; one sort is three launches fewer on the card)."""
  depth_l = cassini_disp_to_depth(disps, _baselines(disps.device))
  out_d, out_c = list(depth_l), list(confs)
  for k, pair in enumerate(CAM_PAIRS):
    kind, params = DEEP360_PAIR_TRANSFORMS[pair]
    if kind == "rot":
      both = torch.stack([depth_l[k], confs[k]], dim=-1)[None]
      rot = rotate_cassini(both, *params)[0]
      out_d[k], out_c[k] = rot[..., 0], rot[..., 1]
  d, c = depth_view_transforms_batched(
      depth_l[_TRANS], confs[_TRANS],
      tuple(DEEP360_PAIR_TRANSFORMS[p][1] for p in CAM_PAIRS[_TRANS]))
  out_d[_TRANS], out_c[_TRANS] = list(d), list(c)
  return torch.stack(out_d), torch.stack(out_c)


class TwoStagePipeline:
  """Whole-frame 360° depth: six stereo pairs and four views -> one fused
  depth map.

  Args:
    disp: stage 1, a ``ModeDisparity`` built with ``out_conf=True``, or a
      reference-layout ``state_dict`` for one (Sphere, Cassini).
    fusion: stage 2, a ``ModeFusion`` or a reference-layout ``state_dict``
      (the dead ``downsample`` keys are dropped).
    maxdisp, max_depth: 192 and 1000 for Deep360.
    dtype: stage 1's conv weights and activations (``torch.bfloat16`` for
      speed); its softmax, soft-argmin and confidence stay f32.
    stage1_chunk: pairs per stage-1 call (6, 3, 2 or 1).
    uint8_inputs: the images are uint8 and normalised on the device: the
      pairs into ``dtype``, the views into f32 before ``fusion_dtype``.
    fusion_dtype: the fusion net's conv weights and activations (``dtype``
      if None); its sigmoid head stays f32. The bridge always runs f32.
    device: the CUDA card by default (raises without one); ``"cpu"`` runs
      the plain PyTorch path. Modules passed in must be on it.

  The pipeline holds eval-mode copies of the modules passed in, their conv
  weights cast to its dtypes, as the JAX pipeline applies both nets with
  ``train=False`` to a cast copy of their parameters: the caller's modules
  keep their mode, dtypes and BN statistics, and later changes to them do
  not reach the pipeline.
  """

  def __init__(self, disp: ModeDisparity | Mapping[str, Any],
               fusion: ModeFusion | Mapping[str, Any], maxdisp: int = 192,
               max_depth: float = 1000.0,
               dtype: torch.dtype = torch.float32, stage1_chunk: int = 6,
               uint8_inputs: bool = False,
               fusion_dtype: torch.dtype | None = None,
               device: str | torch.device | None = None):
    self.device = resolve_device(device)
    if 6 % stage1_chunk:
      raise ValueError(f"stage1_chunk must divide 6, got {stage1_chunk}")
    if isinstance(disp, Mapping):
      model = ModeDisparity(maxdisp, out_conf=True, device=self.device)
      load_reference_state_dict(model, disp)
      disp = model
    if isinstance(fusion, Mapping):
      model = ModeFusion(max_depth, device=self.device)
      load_reference_state_dict(model, fusion)
      fusion = model
    for name, model in (("stage 1", disp), ("fusion", fusion)):
      if model.device != self.device:
        raise ValueError(f"{name} is on {model.device}, the pipeline on "
                         f"{self.device}")
    if not disp.out_conf or disp.maxdisp != maxdisp:
      raise ValueError(f"stage 1 must be built with out_conf=True and "
                       f"maxdisp {maxdisp}")
    if fusion.max_depth != max_depth:
      raise ValueError(f"fusion has max_depth {fusion.max_depth}, the "
                       f"pipeline {max_depth}")
    self.dtype = dtype
    self.fusion_dtype = fusion_dtype or dtype
    self.disp = cast_conv_params(disp, dtype).eval()
    self.fusion = cast_conv_params(fusion, self.fusion_dtype).eval()
    self.stage1_chunk = stage1_chunk
    self.uint8_inputs = uint8_inputs

  def _input(self, imgs, dtype: torch.dtype) -> torch.Tensor:
    imgs = torch.as_tensor(imgs)
    if imgs.device != self.device:
      imgs = upload(imgs, self.device)
    if self.uint8_inputs:
      return normalize_rgb_on_device(imgs, dtype)
    return imgs.to(dtype)

  def stage1(self, lefts, rights, *, plain: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Disparities and confidences ``(6, H, W)`` f32 of the six pairs
    ``(6, H, W, 3)`` (under a spatial mesh this rank's ``(6, H / S, W)``
    rows)."""
    lefts = self._input(lefts, self.dtype)
    rights = self._input(rights, self.dtype)
    preds, confs = [], []
    for i in range(0, 6, self.stage1_chunk):
      p, c = self.disp(lefts[i:i + self.stage1_chunk],
                       rights[i:i + self.stage1_chunk], plain=plain)
      preds.append(p.float())
      confs.append(c.float())
    return torch.cat(preds), torch.cat(confs)

  def fuse(self, depths: torch.Tensor, confs: torch.Tensor, rgbs, *,
           plain: bool = False) -> torch.Tensor:
    """The fused depth ``(H, W)`` f32 of the bridged maps ``(6, H, W)`` and
    the four views ``(4, H, W, 3)`` (under a spatial mesh this rank's
    ``(H / S, W)`` rows)."""
    rgbs = self._input(rgbs, torch.float32).to(self.fusion_dtype)
    fdt = self.fusion_dtype
    out = self.fusion([depths[k][None, :, :, None].to(fdt) for k in range(6)],
                      [confs[k][None, :, :, None].to(fdt) for k in range(6)],
                      [rgbs[k][None] for k in range(4)], plain=plain)
    return out[0, :, :, 0]

  def __call__(self, lefts, rights, rgbs, *, plain: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``lefts``/``rights`` ``(6, H, W, 3)`` (pair order ``CAM_PAIRS``) and
    ``rgbs`` ``(4, H, W, 3)`` (cameras 1-4: pair 12's left and right, pair
    34's left and right), tensors or arrays. Returns ``(fused (H, W),
    disparities (6, H, W), confidences (6, H, W))``, f32 on the device.
    ``plain=True`` runs the kernels' plain versions (a reference for the
    card). Under a spatial mesh every rank returns the whole frame (module
    docstring)."""
    mesh = _frame_mesh()
    with span("frame"):
      with span("frame.stage1"):
        disp, conf = self.stage1(lefts, rights, plain=plain)
      if mesh is not None:
        with span("frame.gather"):
          disp, conf = gather_rows(disp, 1, mesh), gather_rows(conf, 1, mesh)
      with span("frame.bridge"):
        depths, confs = bridge_all_pairs(disp, conf)
      with span("frame.fusion"):
        fused = self.fuse(depths, confs, rgbs, plain=plain)
      if mesh is not None:
        with span("frame.gather"):
          fused = gather_rows(fused, 0, mesh)
    return fused, disp, conf


def _frame_mesh() -> Mesh | None:
  """The active mesh if it splits H, None without one; a data axis above 1
  raises (the frame is one example)."""
  mesh = active_mesh()
  if mesh is None:
    return None
  if mesh.data > 1:
    raise ValueError(
        f"the frame runs its fusion net at batch 1 and takes no data axis: "
        f"got a mesh of data {mesh.data} x spatial {mesh.spatial}; serve "
        "frames on a (1, S) mesh")
  return mesh if mesh.spatial > 1 else None

