"""One file per fusion frame, ``.mfp`` (``mode_tpu/data/fusion_pack.py``,
byte for byte its format: a pack written by either package reads in the
other): ``train_fusion --packed_dir``.

The reference's fusion ingest decodes 19 files a frame, 6 depth npz, 6
confidence PNGs, 4 RGB PNGs and the ground-truth npz
(``deep360_loader.py:118-168``). A pack holds the bytes the training step
needs in the wire dtypes, after the header ``<4sIIIIII`` (``MFPK``, version
1, H, W and the counts of depths, confidences and views):

  * depths: float16 (6, H, W);
  * confs:  uint8   (6, H, W), as the PNGs hold them;
  * rgbs:   uint8   (4, H, W, 3), normalised on the device;
  * gt:     float32 (H, W), the loss's target, exact.

Reading a frame is one open and one read (~17 MB at 1024x512 against ~50
MB decoded to f32) with no inflate. :class:`PackedFusionDataset` serves the
batch dict of ``Deep360DatasetFusion`` in the wire dtypes, which
``training.make_fusion_train_step(raw_inputs=True)`` unpacks on the device.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Sequence

import numpy as np

_MAGIC = b"MFPK"
_VERSION = 1
_HEADER = struct.Struct("<4sIIIIII")   # magic, version, h, w, nd, nc, nr


def pack_frame_path(out_dir: str, gt_path: str) -> str:
  """Canonical pack filename for a frame, derived from its gt npz path."""
  stem = os.path.splitext(os.path.basename(gt_path))[0]
  return os.path.join(out_dir, stem + ".mfp")


def write_pack(path: str, depths: np.ndarray, confs: np.ndarray,
               rgbs: np.ndarray, gt: np.ndarray) -> None:
  """Write one packed frame.

  Args:
    depths: (6, H, W) float (stored f16).
    confs: (6, H, W) float in [0, 1] (stored u8) or uint8.
    rgbs: (4, H, W, 3) uint8 (raw PNG pixels, NOT normalized).
    gt: (H, W) float32.
  """
  nd, h, w = depths.shape
  nc = confs.shape[0]
  nr = rgbs.shape[0]
  if confs.dtype != np.uint8:
    confs = np.clip(confs * 255.0 + 0.5, 0, 255).astype(np.uint8)
  assert rgbs.dtype == np.uint8 and rgbs.shape == (nr, h, w, 3)
  tmp = path + ".tmp"
  with open(tmp, "wb") as f:
    f.write(_HEADER.pack(_MAGIC, _VERSION, h, w, nd, nc, nr))
    f.write(np.ascontiguousarray(depths, np.float16).tobytes())
    f.write(np.ascontiguousarray(confs).tobytes())
    f.write(np.ascontiguousarray(rgbs).tobytes())
    f.write(np.ascontiguousarray(gt, np.float32).tobytes())
  os.replace(tmp, path)


def read_pack(path: str):
  """Read one packed frame -> (depths f16 (6,H,W), confs u8 (6,H,W),
  rgbs u8 (4,H,W,3), gt f32 (H,W))."""
  with open(path, "rb") as f:
    head = f.read(_HEADER.size)
    magic, version, h, w, nd, nc, nr = _HEADER.unpack(head)
    if magic != _MAGIC or version != _VERSION:
      raise IOError(f"not a fusion pack: {path}")
    buf = f.read()
  o0 = 0
  o1 = o0 + nd * h * w * 2
  o2 = o1 + nc * h * w
  o3 = o2 + nr * h * w * 3
  o4 = o3 + h * w * 4
  if len(buf) < o4:
    raise IOError(f"truncated fusion pack: {path}")
  depths = np.frombuffer(buf, np.float16, nd * h * w, o0).reshape(nd, h, w)
  confs = np.frombuffer(buf, np.uint8, nc * h * w, o1).reshape(nc, h, w)
  rgbs = np.frombuffer(buf, np.uint8, nr * h * w * 3, o2).reshape(
      nr, h, w, 3)
  gt = np.frombuffer(buf, np.float32, h * w, o3).reshape(h, w)
  return depths, confs, rgbs, gt


def pack_dataset(depth_lists: Sequence[Sequence[str]],
                 conf_lists: Sequence[Sequence[str]],
                 rgb_lists: Sequence[Sequence[str]],
                 gt_list: Sequence[str], out_dir: str,
                 threads: int = 8, verbose: bool = False) -> list[str]:
  """Pack every frame of a fusion file-list set into ``out_dir``.

  Uses the native decoder (libmodeio) when available, PIL/numpy otherwise.
  Skips frames whose pack already exists (resumable). Returns pack paths.
  """
  from mode_tpu_torch.data import native_io
  from mode_tpu_torch.data.deep360 import load_conf, load_npz

  os.makedirs(out_dir, exist_ok=True)
  n = len(gt_list)
  native = native_io.available()
  out_paths = []
  for i in range(n):
    path = pack_frame_path(out_dir, gt_list[i])
    out_paths.append(path)
    if os.path.exists(path):
      continue
    gt = load_npz(gt_list[i])
    h, w = gt.shape
    if native:
      depths = native_io.read_npz_batch(
          [depth_lists[k][i] for k in range(6)], (h, w), threads)
      confs = native_io.decode_rgb_batch_u8(
          [conf_lists[k][i] for k in range(6)], h, w, threads)[..., 0]
      rgbs = native_io.decode_rgb_batch_u8(
          [rgb_lists[k][i] for k in range(4)], h, w, threads)
    else:
      from PIL import Image
      depths = np.stack([load_npz(depth_lists[k][i]) for k in range(6)])
      confs = np.stack([
          np.clip(load_conf(conf_lists[k][i])[..., 0] * 255.0 + 0.5,
                  0, 255).astype(np.uint8) for k in range(6)])
      rgbs = np.stack([
          np.asarray(Image.open(rgb_lists[k][i]).convert("RGB"), np.uint8)
          for k in range(4)])
    write_pack(path, depths, confs, rgbs, gt)
    if verbose:
      print(f"packed {i + 1}/{n}: {path}", flush=True)
  return out_paths


class PackedFusionDataset:
  """Fusion dataset over packed frames (one .mfp file per frame).

  Serves RAW wire dtypes — depths f16, confs u8, rgbs u8 (un-normalized)
  — for the on-device unpack path
  (``training.make_fusion_train_step(raw_inputs=True)``); ~3x fewer
  host->device bytes than the decoded-f32 dict and zero PNG/npz inflate.
  """

  raw_inputs = True

  def __init__(self, pack_paths: Sequence[str],
               gt_names: Optional[Sequence[str]] = None):
    self.paths = list(pack_paths)
    self.gt_names = list(gt_names) if gt_names is not None else self.paths

  def __len__(self):
    return len(self.paths)

  def __getitem__(self, index: int) -> dict:
    depths, confs, rgbs, gt = read_pack(self.paths[index])
    return {
        "gtNames": self.gt_names[index],
        "depths": depths[..., None],        # (6, H, W, 1) f16
        "confs": confs[..., None],          # (6, H, W, 1) u8
        "rgbs": rgbs,                       # (4, H, W, 3) u8
        "gt": gt,                           # (H, W) f32
    }
