"""ctypes bindings of the native IO library, ``native/libmodeio.so``
(``mode_tpu/data/native_io.py``).

Batched, thread-pooled PNG and NPZ decoding with the ImageNet normalisation
fused into the decode. The library is the repo's own (``native/modeio.cpp``);
a checkout without it builds it on first use with ``make -C native`` (g++
and zlib), and says so loudly if that fails. :func:`available` is False
when there is no library; the datasets then decode per item with PIL.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from mode_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()     # the loader's threads may ask first


def _lib_path() -> str:
  return os.path.join(os.path.dirname(os.path.dirname(
      os.path.dirname(os.path.abspath(__file__)))), "native",
      "libmodeio.so")


def _load() -> Optional[ctypes.CDLL]:
  with _LOCK:
    return _load_once()


def _load_once() -> Optional[ctypes.CDLL]:
  global _LIB, _TRIED
  if _TRIED:
    return _LIB
  _TRIED = True
  path = _lib_path()
  if not os.path.exists(path):
    # build on first use (g++ + zlib are part of the toolchain); loud on
    # failure so a broken toolchain doesn't silently degrade to slow IO
    log = logging.getLogger(__name__)
    makefile = os.path.join(os.path.dirname(path), "Makefile")
    if os.path.exists(makefile):
      log.info("building native IO library: make -C %s", os.path.dirname(path))
      proc = subprocess.run(["make", "-s", "-C", os.path.dirname(path)],
                            capture_output=True, text=True)
      if proc.returncode != 0:
        log.warning("native IO build failed (falling back to PIL/numpy "
                    "decoding):\n%s", proc.stderr.strip())
  if not os.path.exists(path):
    return None
  lib = ctypes.CDLL(path)
  lib.modeio_decode_png.restype = ctypes.c_int
  lib.modeio_decode_png.argtypes = [
      ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
  lib.modeio_decode_rgb_batch_normalized.restype = ctypes.c_int64
  lib.modeio_decode_rgb_batch_normalized.argtypes = [
      ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
      ctypes.c_int, ctypes.POINTER(ctypes.c_float),
      ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
      ctypes.c_int]
  lib.modeio_decode_rgb_batch_u8.restype = ctypes.c_int64
  lib.modeio_decode_rgb_batch_u8.argtypes = [
      ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
      ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
  lib.modeio_read_npz.restype = ctypes.c_int64
  lib.modeio_read_npz.argtypes = [
      ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
  lib.modeio_read_npz_batch.restype = ctypes.c_int64
  lib.modeio_read_npz_batch.argtypes = [
      ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
      ctypes.POINTER(ctypes.c_float), ctypes.c_int]
  _LIB = lib
  return lib


def available() -> bool:
  return _load() is not None


def _require() -> ctypes.CDLL:
  lib = _load()
  if lib is None:
    raise RuntimeError(f"the native IO library is missing: {_lib_path()} "
                       "(build it with `make -C native`)")
  return lib


def _paths_array(paths: Sequence[str]):
  arr = (ctypes.c_char_p * len(paths))()
  arr[:] = [p.encode() for p in paths]
  return arr


def decode_png(path: str, max_bytes: int = 64 << 20) -> np.ndarray:
  """Decode one PNG → uint8 (H, W, C), C the file's channel count."""
  lib = _require()
  buf = np.empty((max_bytes,), np.uint8)
  w = ctypes.c_int()
  h = ctypes.c_int()
  ch = lib.modeio_decode_png(
      path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
      max_bytes, ctypes.byref(w), ctypes.byref(h))
  if ch < 0:
    raise IOError(f"native PNG decode failed: {path}")
  return buf[:h.value * w.value * ch].reshape(h.value, w.value, ch).copy()


def decode_rgb_batch_normalized(paths: Sequence[str], height: int,
                                width: int, threads: int = 8) -> np.ndarray:
  """Decode PNGs → ImageNet-normalized float32 (N, H, W, 3) in one call."""
  lib = _require()
  out = np.empty((len(paths), height, width, 3), np.float32)
  mean = IMAGENET_MEAN.astype(np.float32)
  std = IMAGENET_STD.astype(np.float32)
  rc = lib.modeio_decode_rgb_batch_normalized(
      _paths_array(paths), len(paths), height, width,
      mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
      std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
  if rc != 0:
    raise IOError(f"native batch decode failed at {paths[rc - 1]}")
  return out


def decode_rgb_batch_u8(paths: Sequence[str], height: int, width: int,
                        threads: int = 8) -> np.ndarray:
  """Decode PNGs → raw uint8 (N, H, W, 3)."""
  lib = _require()
  out = np.empty((len(paths), height, width, 3), np.uint8)
  rc = lib.modeio_decode_rgb_batch_u8(
      _paths_array(paths), len(paths), height, width,
      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
  if rc != 0:
    raise IOError(f"native u8 batch decode failed at {paths[rc - 1]}")
  return out


def read_npz(path: str, shape) -> np.ndarray:
  """Read the first array of an .npz or .npy as float32 of ``shape``;
  ``IOError`` when its element count is not the shape's."""
  lib = _require()
  out = np.empty(shape, np.float32)
  count = lib.modeio_read_npz(
      path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
      out.size)
  if count != out.size:
    raise IOError(f"native npz read failed: {path} (got {count} elements)")
  return out


def read_npz_batch(paths: Sequence[str], shape,
                   threads: int = 8) -> np.ndarray:
  """Batched npz read → float32 (N, *shape)."""
  lib = _require()
  out = np.empty((len(paths),) + tuple(shape), np.float32)
  elems = int(np.prod(shape))
  rc = lib.modeio_read_npz_batch(
      _paths_array(paths), len(paths), elems,
      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
  if rc != 0:
    raise IOError(f"native npz batch read failed at {paths[rc - 1]}")
  return out
