"""Shared numpy weights for the port's tests against the JAX package: values
for an ``eval_shape``'d Flax variables tree, and their transfer into a port
module through ``params_from_jax``."""

import jax
import numpy as np
import torch

from mode_tpu_torch.utils.convert import params_from_jax


def numpy_variables(shapes, seed, head_scale=1.0):
  """Values for every leaf of an ``eval_shape``'d variables tree: convs
  ~ N(0, sqrt(2 / (prod(k) * C_out))) (times ``head_scale`` for the
  1-channel classifier heads), transpose convs ~ U(+-1/sqrt(fan)), BN
  scale/var ~ U(0.8, 1.2), bias/mean ~ N(0, 0.05)."""
  rng = np.random.default_rng(seed)

  def leaf(path, s):
    name = path[-1].key
    if name == "kernel":
      std = np.sqrt(2.0 / (np.prod(s.shape[:-2]) * s.shape[-1]))
      if s.shape[-1] == 1:
        std *= head_scale
      v = rng.normal(size=s.shape) * std
    elif name == "kernel_t":
      bound = 1.0 / np.sqrt(s.shape[-2] * np.prod(s.shape[:-2]))
      v = rng.uniform(-bound, bound, size=s.shape)
    elif name in ("scale", "var"):
      v = rng.uniform(0.8, 1.2, size=s.shape)
    else:
      v = rng.normal(size=s.shape) * 0.05
    return v.astype(np.float32)

  return jax.tree_util.tree_map_with_path(leaf, shapes)


def carry(module: torch.nn.Module, variables) -> torch.nn.Module:
  module.load_state_dict(params_from_jax(jax.tree_util.tree_map(
      np.asarray, variables)), strict=True)
  return module.eval()
