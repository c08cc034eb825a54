"""The port's init menu (``models/initialize.py:init_model_params``)
against the JAX package's (``mode_tpu/models/initialize.py``) on both
models: the same set of tensors re-initialised (the JAX menu's leaves named
through ``utils/convert.py:params_from_jax``), BN weights 1 and biases 0
exactly. The menu's statistics are held in
``tests/test_torch_train_utils.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_tpu.models import disparity as jdisp
from mode_tpu.models import fusion as jfusion
from mode_tpu.models.initialize import init_model_params as jinit
from mode_tpu_torch.models.initialize import init_model_params
from mode_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_train_utils import H, MAXDISP, W, _port_model

torch.set_num_threads(2)


def _jax_variables(kind):
  if kind == "disparity":
    model = jdisp.ModeDisparity(maxdisp=MAXDISP)
    x = jnp.zeros((1, H, W, 3))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x,
                                             train=False))
  zeros = [jnp.zeros((1, H, W, 1))] * 6
  views = [jnp.zeros((1, H, W, 3))] * 4
  return jax.eval_shape(lambda: jfusion.ModeFusion(1000.0).init(
      jax.random.PRNGKey(0), zeros, zeros, views, False))


def _changed_jax(kind, init_type) -> set:
  """The torch names of the leaves the JAX menu changes in a tree whose
  every parameter is 0.5."""
  shapes = _jax_variables(kind)
  variables = {"params": jax.tree_util.tree_map(
      lambda s: np.full(s.shape, 0.5, np.float32), shapes["params"])}
  new = jinit(variables, init_type, jax.random.PRNGKey(0))
  before = params_from_jax(variables)
  after = params_from_jax(jax.tree_util.tree_map(np.asarray, new))
  return {k for k in before if not torch.equal(before[k], after[k])}


@pytest.mark.parametrize("kind", ["disparity", "fusion"])
def test_init_touches_the_jax_menus_tensors(kind):
  init_type = "kaiming_normal"
  want = _changed_jax(kind, init_type)
  model = _port_model(kind)
  with torch.no_grad():
    for p in model.parameters():
      p.fill_(0.5)
  before = {n: p.clone() for n, p in model.named_parameters()}
  init_model_params(model, init_type, torch.Generator().manual_seed(1))
  got = {n for n, p in model.named_parameters()
         if not torch.equal(p, before[n])}
  assert got == want
  assert len(got) > 100
  for n, p in model.named_parameters():
    if n.endswith("bias"):
      assert bool((p == 0).all()), n
    elif p.ndim == 1:
      assert bool((p == 1).all()), n
