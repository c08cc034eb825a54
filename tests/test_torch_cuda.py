"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes that the production shapes of ``chip_smoke.py``
do not reach: Cin not a multiple of the 16-channel K step, Cout not a
multiple of the output tile, odd extents for the stride-2 conv, batch 2,
dilation 2, Cassini maps whose tables have a drop row; and the stage-1
model at batch 2 against its plain path.

Every test needs a CUDA card and skips without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from mode_tpu_torch import kernels
from mode_tpu_torch.ops import conv2d as C2
from mode_tpu_torch.ops import conv3d as C
from mode_tpu_torch.ops import regression as R
from mode_tpu_torch.ops import sphere_conv as S

pytestmark = pytest.mark.cuda

# |kernel - plain| <= tol * (1 + max |plain|): f32 sums the same products in
# another order; bf16 outputs may round one bf16 step (2^-8) apart
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
  got, want = got.float(), want.float()
  err = float((got - want).abs().max())
  assert err <= TOL[dtype] * (1 + float(want.abs().max())), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn,x_shape,cout,res,relu", [
    (C.conv3d_s1_bn_act, (1, 3, 5, 6, 20), 24, True, True),
    (C.conv3d_s1_bn_act, (2, 2, 4, 5, 16), 40, False, True),
    (C.conv3d_s1_bn_act, (1, 3, 4, 5, 32), 1, False, False),
    (C.conv3d_s1_bn_act, (1, 2, 3, 4, 8), 70, True, False),
    (C.conv3d_s2_bn_act, (1, 5, 7, 6, 16), 24, False, True),
    (C.conv3d_s2_bn_act, (2, 4, 4, 8, 20), 64, False, False),
    (C.deconv3d_bn_act, (1, 2, 3, 4, 12), 10, True, True),
    (C.deconv3d_bn_act, (2, 3, 2, 5, 32), 64, False, False),
    (C.deconv3d_bn_act, (1, 2, 2, 3, 16), 33, False, True),
])
def test_conv_kernel_matches_plain(gen, fn, x_shape, cout, res, relu, dtype):
  cin = x_shape[-1]
  deconv = fn is C.deconv3d_bn_act
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cin, cout, 3, 3, 3) if deconv else (cout, cin, 3, 3, 3),
                   generator=gen, device="cuda") * 0.2).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  kw = {"relu": relu}
  if res:
    shape = (x_shape[0], *[2 * n for n in x_shape[1:4]], cout) if deconv \
        else (*x_shape[:4], cout)
    kw["residual"] = torch.randn(shape, generator=gen, device="cuda").to(dtype)
  kernels.reset_launches()
  got = fn(x, w, scale, bias, **kw)
  want = fn(x, w, scale, bias, plain=True, **kw)
  torch.cuda.synchronize()
  assert sum(kernels.LAUNCHES.values()) == 1
  assert got.dtype == dtype and got.shape == want.shape
  _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,hq,wq,maxdisp,h,w", [
    (2, 6, 5, 7, 24, 17, 30),
    (1, 4, 1, 3, 8, 4, 300),
    (1, 3, 4, 4, 3, 4, 4),
])
def test_regression_kernel_matches_plain(gen, n, d, hq, wq, maxdisp, h, w,
                                         dtype):
  cost = (torch.randn((n, d, hq, wq), generator=gen, device="cuda")
          * 2).to(dtype)
  kernels.reset_launches()
  pred, conf = R.fused_disparity_regression(cost, maxdisp, h, w)
  ref_pred, ref_conf = R.fused_disparity_regression(cost, maxdisp, h, w,
                                                    plain=True)
  torch.cuda.synchronize()
  assert kernels.LAUNCHES["fused_disparity_regression"] == 1
  _close(pred, ref_pred, torch.float32)
  # conf jumps where round(pred) does; leave out pixels within f32 noise of
  # a k + 0.5 tie
  tie = (ref_pred - ref_pred.floor() - 0.5).abs() < 1e-3
  _close(conf[~tie], ref_conf[~tie], torch.float32)


def test_kernels_refuse_what_they_do_not_take(gen):
  x = torch.randn((1, 2, 3, 4, 8), generator=gen, device="cuda")
  w = torch.randn((8, 8, 3, 3, 3), generator=gen, device="cuda")
  with pytest.raises(ValueError, match="contiguous"):
    C.conv3d_s1_bn_act(x.transpose(2, 3), w)
  with pytest.raises(ValueError, match="contiguous"):
    C.conv3d_s1_bn_act(x.double(), w.double())
  with pytest.raises(ValueError, match="does not match"):
    C.conv3d_s1_bn_act(x, w[:, :4])
  with pytest.raises(ValueError, match="scale"):
    C.conv3d_s1_bn_act(x, w, torch.ones(4, device="cuda"))
  with pytest.raises(ValueError, match="contiguous"):
    R.fused_disparity_regression(x[0, ..., 0].transpose(1, 2), 8, 8, 8)
  with pytest.raises(ValueError, match="Cassini"):
    S.sphere_conv_bn_act(x[0], w[..., 0])
  with pytest.raises(ValueError, match="contiguous"):
    C2.conv2d_s1_bn_act(x[0].transpose(1, 2), w[..., 0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,dil,res,relu", [
    ((1, 9, 13, 20), 24, 1, True, True),
    ((2, 8, 16, 32), 64, 2, False, True),
    ((3, 5, 7, 64), 128, 1, True, False),
    ((2, 6, 6, 40), 70, 2, True, True),
])
def test_conv2d_kernel_matches_plain(gen, x_shape, cout, dil, res, relu,
                                     dtype):
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
       * 0.2).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  r = (torch.randn((*x_shape[:3], cout), generator=gen, device="cuda")
       .to(dtype) if res else None)
  kernels.reset_launches()
  got = C2.conv2d_s1_bn_act(x, w, scale, bias, r, relu, dil)
  want = C2.conv2d_s1_bn_act(x, w, scale, bias, r, relu, dil, plain=True)
  torch.cuda.synchronize()
  assert kernels.LAUNCHES["conv2d_s1_bn_act"] == 1
  assert got.dtype == dtype and got.shape == want.shape
  _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,res,relu", [
    ((2, 64, 32, 24), 40, True, True),     # drop row at (column 0, tap 5)
    ((1, 32, 16, 8), 128, False, True),
    ((1, 128, 64, 64), 128, True, True),
])
def test_sphere_conv_kernel_matches_plain(gen, x_shape, cout, res, relu,
                                          dtype):
  """Held against the plain gather version, which encodes the edge rules
  independently of the kernel's shift tables."""
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
       * 0.2).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  r = (torch.randn((*x_shape[:3], cout), generator=gen, device="cuda")
       .to(dtype) if res else None)
  kernels.reset_launches()
  got = S.sphere_conv_bn_act(x, w, scale, bias, r, relu)
  want = S.sphere_conv_bn_act(x, w, scale, bias, r, relu, plain=True)
  torch.cuda.synchronize()
  assert kernels.LAUNCHES["sphere_conv_bn_act"] == 1
  _close(got, want, dtype)


@pytest.mark.parametrize("conv,shape", [("Sphere", (64, 32)),
                                        ("Regular", (256, 256))])
def test_slice_at_batch_two_runs_the_kernels(gen, conv, shape):
  """At batch 2 every stride-1 3x3 conv of the feature extractor runs the
  2-D kernel (32 per Sphere call, 52 per Regular call, two calls a pair),
  and the features agree with the plain path's. Random weights grow them
  to ~1e6, so the bar is relative to their largest value."""
  from mode_tpu_torch.models.disparity import ModeDisparity
  model = ModeDisparity(16, conv, out_conf=True, device="cuda")
  left = torch.randn((2, *shape, 3), generator=gen, device="cuda")
  with torch.no_grad():
    feat = model.feature_extraction(left)
    ref = model.feature_extraction(left, plain=True)
  torch.cuda.synchronize()
  assert float((feat - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
  kernels.reset_launches()
  pred, conf = model(left, torch.roll(left, 4, dims=2))
  torch.cuda.synchronize()
  assert kernels.LAUNCHES["conv2d_s1_bn_act"] == (64 if conv == "Sphere"
                                                  else 104)
  assert pred.shape == conf.shape == (2, *shape)
  assert bool(torch.isfinite(pred).all() and torch.isfinite(conf).all())
