"""Weights between the JAX package, the reference's torch checkpoints and the
port.

The port's modules carry the reference's torch ``state_dict`` keys, and the
JAX package names its Flax children with the same path segments
(``mode_tpu/models/blocks.py``). So :func:`params_from_jax` is the inverse of
``mode_tpu/utils/torch_convert.py:convert_state_dict``: join the Flax path
with dots, rename the leaf, and permute conv-like arrays back to torch's
layout (the sphere convs' HWIO ``kernel`` included). Its result loads with
``load_state_dict(strict=True)``; a transpose conv's ``kernel_t`` ``(*K, O,
I)`` becomes torch's ``(I, O, *K)`` by the same permutation, so the fusion
nets' trees carry over too. :func:`load_npz` loads the repo's
reference-layout ``.npz`` weights (``tests/data/trained_mirror*.npz``), and
:func:`load_reference_state_dict` a reference ``state_dict`` whose dead
parameters the port does not build.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "kernel_t": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
  """Flax ``(*K, B, A)`` -> torch ``(A, B, *K)`` for arrays with ndim >= 3:
  a conv's ``(*K, I, O)`` -> ``(O, I, *K)`` and a transpose conv's
  ``(*K, O, I)`` -> ``(I, O, *K)``."""
  if arr.ndim < 3:
    return arr
  n = arr.ndim
  return np.ascontiguousarray(arr.transpose((n - 1, n - 2, *range(n - 2))))


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _flatten(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def params_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
  """The port's ``state_dict`` from the JAX package's Flax variables.

  ``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts
  of arrays (numpy, or anything ``np.asarray`` takes). Each BatchNorm also
  gets ``num_batches_tracked = 0``, as a torch state_dict has.
  """
  state: dict[str, torch.Tensor] = {}
  for collection in ("params", "batch_stats"):
    for path, value in _flatten(variables.get(collection, {})):
      key = ".".join(path[:-1]) + "." + _LEAF_TO_TORCH[path[-1]]
      state[key] = torch.from_numpy(_to_torch_layout(np.asarray(value)))
      if path[-1] == "mean":
        state[".".join(path[:-1]) + ".num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long)
  return state


def strip_module_prefix(state: Mapping[str, Any]) -> dict[str, Any]:
  """Remove DataParallel's ``module.`` prefixes."""
  return {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state.items()}


def unwrap_checkpoint(obj: Mapping[str, Any]) -> dict[str, Any]:
  """A reference ``.tar`` checkpoint's state_dict: accepts a raw state_dict
  or the training wrapper ``{'epoch', 'state_dict', ...}``."""
  if "state_dict" in obj and not any(k.endswith("weight") for k in obj):
    obj = obj["state_dict"]
  return strip_module_prefix(obj)


def load_reference_state_dict(model: torch.nn.Module,
                              state: Mapping[str, Any]) -> list[str]:
  """Load a reference-layout torch ``state_dict`` (raw, DataParallel-
  prefixed, or in the training checkpoint's wrapper) into ``model``.

  The keys of the reference's fusion ``BasicBlock`` s' ``downsample``
  branches, which the reference builds and never runs (their parameters and
  their BNs' ``num_batches_tracked``), map to nothing in the port: they are
  dropped and returned, as ``mode_tpu/utils/torch_convert.py`` tolerates
  them. Every other key must match, and every parameter and buffer of
  ``model`` must be given (``strict=True``)."""
  state = unwrap_checkpoint(state)
  own = model.state_dict()
  dropped = sorted(k for k in state if k not in own)
  unknown = [k for k in dropped if ".downsample." not in f".{k}"]
  if unknown:
    raise KeyError(f"{len(unknown)} keys map to nothing in "
                   f"{type(model).__name__}, e.g. {unknown[:4]}")
  model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()
                         if k in own}, strict=True)
  return dropped


def filter_stack_hourglass_only(state: Mapping[str, Any]) -> dict[str, Any]:
  """The reference's partial load ``loadStackHourglassOnly``
  (``initModel.py:35-43``; ``mode_tpu/utils/torch_convert.py:108-116``): a
  checkpoint's ``state_dict`` without the feature extractor's keys (those
  holding ``feature_extraction`` or ``forfilter1``), so only the 3-D
  regularisation stack loads from it."""
  return {k: v for k, v in unwrap_checkpoint(state).items()
          if "feature_extraction" not in k and "forfilter1" not in k}


def load_stack_hourglass_only(model: torch.nn.Module,
                              state: Mapping[str, Any]) -> list[str]:
  """Load :func:`filter_stack_hourglass_only` of ``state`` into ``model``:
  the feature extractor keeps the weights it has (as
  ``mode_tpu/utils/torch_convert.py:convert_shg_only`` leaves them), every
  other parameter and buffer of ``model`` must be given, and every given key
  must be ``model``'s (the fusion nets' dead ``downsample`` keys aside, as
  :func:`load_reference_state_dict` drops them). Returns the keys left
  with their own weights."""
  state = filter_stack_hourglass_only(state)
  own = model.state_dict()
  unknown = [k for k in state
             if k not in own and ".downsample." not in f".{k}"]
  if unknown:
    raise KeyError(f"{len(unknown)} keys map to nothing in "
                   f"{type(model).__name__}, e.g. {unknown[:4]}")
  kept = [k for k in own if k not in state]
  missing = [k for k in kept
             if "feature_extraction" not in k and "forfilter1" not in k]
  if missing:
    raise KeyError(f"{len(missing)} keys of {type(model).__name__} outside "
                   f"the feature extractor are missing, e.g. {missing[:4]}")
  model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()
                         if k in own}, strict=False)
  return kept


def load_npz(model: torch.nn.Module, path: str | os.PathLike
             ) -> torch.nn.Module:
  """Load a reference-layout ``.npz`` state_dict (torch keys; float16
  arrays widened to float32) into ``model`` with ``strict=True``; returns
  ``model``."""
  with np.load(path) as z:
    state = {k: torch.from_numpy(z[k].astype(np.float32)
                                 if z[k].dtype == np.float16 else z[k])
             for k in z.files}
  model.load_state_dict(state, strict=True)
  return model


def grads_from_jax(grads: Mapping[str, Any]) -> dict[str, torch.Tensor]:
  """A JAX gradient tree (the ``params`` tree's structure) as the port's
  parameter names and layouts: ``{name: tensor}`` for
  ``model.named_parameters()``, the conv-like arrays permuted as
  :func:`params_from_jax` permutes the parameters."""
  return params_from_jax({"params": grads})
