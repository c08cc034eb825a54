"""Build the CUDA sources under ``csrc/`` for sm_90a and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``; no PyTorch header is
compiled, which keeps a build to seconds. The build runs at first use. Its
output goes to ``kernels/build/`` (listed in ``.gitignore``), named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
Missing libraries are compiled in parallel, one ``nvcc`` per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCES = ("conv3d", "conv3d_s1", "conv3d_s2", "regression", "sphere_conv",
           "conv2d", "sphere_conv_bwd")
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  from torch.utils.cpp_extension import CUDA_HOME
  if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
    return str(Path(CUDA_HOME) / "bin" / "nvcc")
  found = shutil.which("nvcc")
  if found is None:
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit")
  return found


def lib_path(name: str) -> Path:
  """Where the library built from ``csrc/<name>.cu`` lives."""
  digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
  for header in sorted(CSRC_DIR.glob("*.cuh")):
    digest.update(header.read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, ctypes.CDLL]:
  """Compile what is missing (in parallel), load, and return the libraries.

  Raises ``RuntimeError`` with the compiler's output if a source does not
  compile. Each compile's log (``-Xptxas=-v``: registers, shared memory,
  spills) is kept beside its library as ``<name>.log``.
  """
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  jobs = {}
  for name in names:
    path = lib_path(name)
    if name in _LIBS or path.exists():
      continue
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True),
                  tmp, path)
  failed = []
  for name, (proc, tmp, path) in jobs.items():
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
      failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
      continue
    os.replace(tmp, path)
  if failed:
    raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
  for name in names:
    if name not in _LIBS:
      _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
  return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
  """The library of ``csrc/<name>.cu``, built first if needed."""
  lib = _LIBS.get(name)
  return lib if lib is not None else build((name,))[name]
