"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes that the production shapes of ``chip_smoke.py``
do not reach: Cin not a multiple of the 32-channel K stage, Cout not a
multiple of the output tile, odd extents for the stride-2 conv, batch 2,
dilation 2, Cassini maps whose tables have a drop row and ERP maps whose
tables have a drop column; the tensor-core kernels at the production
shapes of the stride-2 conv and the sphere convs, and the strided
training grad-inputs; the deconv's tensor-core kernel at the K5 and K7
shapes and its C entry's refusal of a Cin off its 16-byte copies; the
head kernel's refusal of a Cin past shared memory; the bf16 box kernel of
the stride-1 conv at ragged shapes and at the cells' levels, as the
training's grad-input at Cout 64, and the launches that do not take it;
the stage-1 model
(Cassini and ERP) at batch 2 against its plain path; the sphere conv's
two backward kernels in both layouts, the layer-4 shapes of a batch-2
step and a 16-lane dw stage included, and the two kernels' refusals; the
regression head on logits spread over +-60 and its C entry's refusal of a
shape past 48 KB of shared memory; one training step at 512x256, where
every kernel family trains, in f32 and in mixed precision (bf16), against
the same step through the plain versions; and one fusion training step at
256x128, f32 and bf16, K9 forward and grad-input, against its plain step;
and both training CLIs, one step each at 512x256; the halo forms of the
3-D kernels and of the 2-D kernel (the fusion net's rows at spatial 2 and
4, the Sphere stem's, ragged shards) and the 2-D C entry's refusal of a
halo at dilation 2; K2's row window; the 3-D training Function on a
rank's rows (``conv3d_train``/``deconv3d_train`` with a mesh), forward
and grad-input on the halo forms, at a 1024x512 rank's shapes; the
z-buffer's three forms at 1024x512 with K = 3.

Every test needs a CUDA card and skips without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from mode_tpu_torch import kernels
from mode_tpu_torch.ops import conv2d as C2
from mode_tpu_torch.ops import conv3d as C
from mode_tpu_torch.ops import kmajor
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
    (C.conv3d_s1_bn_act, (1, 3, 5, 6, 24), 24, True, True),
    (C.conv3d_s1_bn_act, (2, 2, 4, 5, 16), 40, False, True),
    (C.conv3d_s1_bn_act, (1, 3, 4, 5, 32), 1, False, False),
    (C.conv3d_s1_bn_act, (1, 2, 3, 4, 8), 70, True, False),
    (C.conv3d_s2_bn_act, (1, 5, 7, 6, 16), 24, False, True),
    (C.conv3d_s2_bn_act, (2, 4, 4, 8, 24), 64, False, False),
    (C.deconv3d_bn_act, (1, 2, 3, 4, 16), 10, True, True),
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


def test_regression_kernel_refuses_levels_past_48_kb(gen):
  """Where the output is as wide as the source, a block stages 128 columns
  of every source level: d 90 takes 48,748 bytes of shared memory and
  launches, d 96 takes 51,844, past the 48 KB the launch asks for, and the
  C entry refuses it; the wrapper raises naming the kernel, uncounted."""
  kernels.reset_launches()
  cost = torch.randn((1, 90, 2, 128), generator=gen, device="cuda")
  pred, _ = R.fused_disparity_regression(cost, 192, 8, 128)
  ref_pred, _ = R.fused_disparity_regression(cost, 192, 8, 128, plain=True)
  torch.cuda.synchronize()
  _close(pred, ref_pred, torch.float32)
  assert kernels.LAUNCHES["fused_disparity_regression"] == 1
  cost = torch.randn((1, 96, 2, 128), generator=gen, device="cuda")
  with pytest.raises(RuntimeError, match="fused_disparity_regression: "
                     ".*CUDA error 1$"):
    R.fused_disparity_regression(cost, 192, 8, 128)
  assert kernels.LAUNCHES["fused_disparity_regression"] == 1


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


def test_tensor_core_convs_refuse_what_they_do_not_take(gen):
  """The tensor-core kernels (the stride-1 and stride-2 3-D convs, the 2-D
  and the sphere conv) take Cin in multiples of 8 (whole 16-byte chunks in
  bf16) and contiguous, 16-byte aligned inputs."""
  x = torch.randn((1, 2, 3, 4, 12), generator=gen, device="cuda")
  w = torch.randn((16, 12, 3, 3, 3), generator=gen, device="cuda")
  with pytest.raises(ValueError, match="multiple of 8"):
    C.conv3d_s1_bn_act(x, w)
  with pytest.raises(ValueError, match="multiple of 8"):
    C.conv3d_s2_bn_act(x, w)
  with pytest.raises(ValueError, match="deconv3d_bn_act: Cin must be"):
    C.deconv3d_bn_act(x, w.transpose(0, 1))
  with pytest.raises(ValueError, match="multiple of 8"):
    C2.conv2d_s1_bn_act(x[0], w[..., 0])
  with pytest.raises(ValueError, match="multiple of 8"):
    S.sphere_conv_bn_act(torch.randn((1, 32, 16, 12), generator=gen,
                                     device="cuda"), w[..., 0])
  x = torch.randn((1, 2, 3, 4, 16), generator=gen, device="cuda")
  w = torch.randn((16, 16, 3, 3, 3), generator=gen, device="cuda")
  with pytest.raises(ValueError, match="contiguous"):
    C.conv3d_s1_bn_act(x.transpose(1, 2), w)
  with pytest.raises(ValueError, match="contiguous"):
    C2.conv2d_s1_bn_act(x[0].transpose(0, 1), w[..., 0])
  offset = torch.randn(x.numel() + 1, generator=gen, device="cuda")
  with pytest.raises(ValueError, match="aligned"):
    C.conv3d_s1_bn_act(offset[1:].view(x.shape), w)
  with pytest.raises(ValueError, match="deconv3d_bn_act: .*aligned"):
    C.deconv3d_bn_act(offset[1:].view(x.shape), w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,dil,res,relu", [
    ((1, 9, 13, 24), 24, 1, True, True),
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,res,relu", [
    ((1, 12, 32, 16, 64), 32, False, True),   # dres0 at 1/16 the size
    ((1, 12, 32, 16, 32), 32, True, True),    # dres1: residual, ReLU
    ((2, 6, 16, 8, 64), 64, True, False),     # hourglass conv2, batch 2
    ((1, 3, 8, 4, 64), 64, False, True),      # the 1/16 level (K6)
    ((6, 3, 8, 4, 32), 32, False, False),     # batch 6
    ((1, 12, 32, 16, 32), 1, False, False),   # a classifier head
    ((2, 5, 9, 40, 32), 1, True, True),       # head: ragged tiles, epilogue
    ((1, 4, 10, 7, 16), 8, False, True),      # Cout 8: a 32-wide N tile
    ((1, 3, 5, 7, 16), 24, True, True),       # ragged M, Cin < the stage
    ((2, 1, 2, 5, 40), 128, False, True),     # D = 1, H = 2; Cin 32 + 8
    ((1, 2, 1, 3, 8), 130, True, False),      # H = 1; two N tiles, odd part
])
def test_conv3d_s1_tensor_core_kernels_match_plain(gen, x_shape, cout, res,
                                                   relu, dtype):
  """K1/K6's tensor-core kernel (Cout > 1) and the head kernel (Cout 1)
  against the plain version, the weight packed once as the layers keep it;
  the scaled weights give outputs of order 1, where a single TF32 pass
  would miss the f32 bar by ~10x."""
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda")
       * (2.0 / (27 * cin)) ** 0.5).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  r = (torch.randn((*x_shape[:4], cout), generator=gen, device="cuda")
       .to(dtype) if res else None)
  packed = C.pack_weight_tc(w)
  kernels.reset_launches()
  got = C.conv3d_s1_bn_act(x, packed, scale, bias, r, relu)
  want = C.conv3d_s1_bn_act(x, w, scale, bias, r, relu, plain=True)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"conv3d_s1_bn_act": 1}
  assert got.dtype == dtype and got.shape == want.shape
  _close(got, want, dtype)


@pytest.mark.parametrize("x_shape,cout,res,relu", [
    ((1, 2, 8, 16, 32), 32, False, False),     # one output box, exactly
    ((1, 3, 9, 17, 32), 32, True, True),       # ragged D, H, W: every edge
    ((2, 4, 16, 16, 64), 32, True, True),      # dres0's 64 -> 32, batch 2
    ((1, 5, 7, 8, 64), 64, True, False),       # W under the box, Cout 64
    ((6, 3, 8, 4, 32), 32, False, True),       # batch 6, W 4
    ((1, 48, 256, 128, 32), 32, True, True),   # the frame's 1/4 level
    ((1, 24, 128, 64, 64), 64, True, True),    # its 1/8 level (conv2)
    ((6, 12, 64, 32, 64), 64, False, True),    # its 1/16 level at batch 6
    ((16, 12, 32, 16, 64), 64, False, True),   # 3D60's 1/16 at batch 16
    ((16, 6, 32, 64, 32), 64, False, False),   # a 3D60 grad-input's 32 -> 64
])
def test_conv3d_s1_box_kernel_matches_plain(gen, x_shape, cout, res, relu):
  """The box kernel (``conv3d_box.cuh``) takes every bf16 call with Cin and
  Cout 32 or 64 and matches the plain version at the bf16 bar, with and
  without a residual and a ReLU, at ragged shapes and at the cells'
  levels; each launch counts once as a box launch."""
  cin = x_shape[-1]
  dtype = torch.bfloat16
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda")
       * (2.0 / (27 * cin)) ** 0.5).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  r = (torch.randn((*x_shape[:4], cout), generator=gen, device="cuda")
       .to(dtype) if res else None)
  packed = C.pack_weight_tc(w)
  kernels.reset_launches()
  got = C.conv3d_s1_bn_act(x, packed, scale, bias, r, relu)
  want = C.conv3d_s1_bn_act(x, w, scale, bias, r, relu, plain=True)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"conv3d_s1_bn_act": 1}
  assert dict(kernels.BOX_LAUNCHES) == {"conv3d_s1_bn_act": 1}
  assert got.dtype == dtype and got.shape == want.shape
  _close(got, want, dtype)


def test_box_kernel_runs_the_grad_input_at_cout_64(gen):
  """The training Function's stride-1 grad-input of a 64 -> 32 conv (dres0's
  first) is a 32 -> 64 conv with the flipped, io-swapped weight: in bf16
  both the forward and the grad-input take the box kernel, and match the
  plain Function's."""
  x = torch.randn((2, 8, 32, 16, 64), generator=gen,
                  device="cuda").to(torch.bfloat16)
  w = (torch.randn((32, 64, 3, 3, 3), generator=gen, device="cuda")
       * (2.0 / (27 * 64)) ** 0.5).to(torch.bfloat16)
  g = torch.randn((2, 8, 32, 16, 32), generator=gen,
                  device="cuda").to(torch.bfloat16)
  out = {}
  for plain in (False, True):
    xr = x.clone().requires_grad_()
    kernels.reset_launches()
    y = C.conv3d_train(xr, w, 1, plain=plain)
    y.backward(g)
    torch.cuda.synchronize()
    out[plain] = (y, xr.grad)
    if not plain:
      assert dict(kernels.BOX_LAUNCHES) == {"conv3d_s1_bn_act": 2}
  _close(out[False][0], out[True][0], torch.bfloat16)
  _close(out[False][1], out[True][1], torch.bfloat16)


def test_box_launches_are_exactly_the_eligible_ones(gen):
  """f32, the halo form, Cout 1 (the head kernel) and Cout 8 run without
  the box kernel; the eligible bf16 calls run on it, counted once each,
  and the tracer counts them as ``conv3d_s1.box`` in their span; the C
  entry refuses the box flag on a call the kernel does not take."""
  from mode_tpu_torch.utils import profiling
  def run(dtype, cin, cout, halo=False):
    x = torch.randn((1, 2, 6, 16, cin), generator=gen,
                    device="cuda").to(dtype)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda")
         * 0.05).to(dtype)
    got = C.conv3d_s1_bn_act(x, w, relu=True, h_halo=halo)
    _close(got, C.conv3d_s1_bn_act(x, w, relu=True, h_halo=halo,
                                   plain=True), dtype)
  kernels.reset_launches()
  profiling.reset()
  with profiling.tracing():
    with profiling.span("stage1.aggregation"):
      run(torch.float32, 32, 32)
      run(torch.bfloat16, 32, 32, halo=True)
      run(torch.bfloat16, 32, 1)
      run(torch.bfloat16, 32, 8)
      assert not kernels.BOX_LAUNCHES
      run(torch.bfloat16, 32, 32)
      run(torch.bfloat16, 64, 64)
  torch.cuda.synchronize()
  counters = profiling.summary()["counters"]
  profiling.reset()
  assert kernels.LAUNCHES["conv3d_s1_bn_act"] == 6
  assert dict(kernels.HALO_LAUNCHES) == {"conv3d_s1_bn_act": 1}
  assert dict(kernels.BOX_LAUNCHES) == {"conv3d_s1_bn_act": 2}
  assert counters == [{"name": "conv3d_s1.box", "span": "stage1.aggregation",
                       "n": 2}]
  x = torch.randn((1, 2, 6, 16, 32), generator=gen, device="cuda")
  out = torch.empty((1, 2, 6, 16, 32), device="cuda")
  tw = C.pack_weight_tc(torch.randn((32, 32, 3, 3, 3), generator=gen,
                                    device="cuda"))
  one = torch.ones(32, device="cuda")
  for bf16, cin, halo in ((0, 32, 0), (1, 32, 1), (1, 16, 0)):
    err = C._conv3d_s1_lib().conv3d_s1_bn_act(
        bf16, x.data_ptr(), tw.parts[0].data_ptr(), tw.parts[1].data_ptr(),
        one.data_ptr(), (0 * one).data_ptr(), None, out.data_ptr(),
        1, 2, 6, 16, cin, 32, 0, halo, 1,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1                                    # cudaErrorInvalidValue
  torch.cuda.synchronize()


def test_head_kernel_refuses_a_cin_past_shared_memory(gen):
  """The Cout-1 head kernel needs 2 x 340 x (Cin itemsize + 16) + 108 Cin
  bytes of shared memory: past 227 KB (f32 Cin >= 80, bf16 Cin >= 152)
  the wrapper refuses and the C entry returns cudaErrorInvalidValue (1)
  without launching; the largest Cin that fits runs and matches plain."""
  for dtype, fits, past in ((torch.float32, 72, 80),
                            (torch.bfloat16, 144, 152)):
    for cin in (fits, past):
      x = torch.randn((1, 3, 4, 5, cin), generator=gen,
                      device="cuda").to(dtype)
      w = (torch.randn((1, cin, 3, 3, 3), generator=gen, device="cuda")
           * 0.05).to(dtype)
      if cin == past:
        with pytest.raises(ValueError, match="Cout-1 head kernel"):
          C.conv3d_s1_bn_act(x, w)
        continue
      got = C.conv3d_s1_bn_act(x, w)
      _close(got, C.conv3d_s1_bn_act(x, w, plain=True), dtype)
    tw = C.pack_weight_tc(w)
    one = torch.ones(1, device="cuda")
    out = torch.empty((1, 3, 4, 5, 1), dtype=dtype, device="cuda")
    err = C._conv3d_s1_lib().conv3d_s1_bn_act(
        int(dtype == torch.bfloat16), x.data_ptr(), tw.parts[0].data_ptr(),
        None, one.data_ptr(), (0 * one).data_ptr(), None, out.data_ptr(),
        1, 3, 4, 5, past, 1, 0, 0, 0, torch.cuda.current_stream().cuda_stream)
    assert err == 1                                    # cudaErrorInvalidValue
  torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,relu", [
    ((1, 48, 256, 128, 32), 64, True),     # hourglass conv1 (M = 196,608)
    ((1, 24, 128, 64, 64), 64, True),      # hourglass conv3 (M = 24,576)
    ((2, 48, 128, 256, 32), 64, False),    # ERP conv1 at batch 2
    ((1, 5, 7, 9, 16), 24, True),          # odd extents, Cin < the stage
    ((2, 3, 4, 6, 40), 72, False),         # Cin 32 + 8, two N tiles of 64
    ((1, 1, 1, 7, 8), 130, True),          # D = H = 1; three N tiles
])
def test_conv3d_s2_tensor_core_kernel_matches_plain(gen, x_shape, cout, relu,
                                                    dtype):
  """K4's tensor-core kernel (conv_body at stride 2) against the plain
  version, the weight packed once as the layers keep it, He-scaled so the
  outputs are of order 1 (where one TF32 pass would miss the f32 bar)."""
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda")
       * (2.0 / (27 * cin)) ** 0.5).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  packed = C.pack_weight_tc(w, stride=2)
  kernels.reset_launches()
  got = C.conv3d_s2_bn_act(x, packed, scale, bias, relu)
  want = C.conv3d_s2_bn_act(x, w, scale, bias, relu, plain=True)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"conv3d_s2_bn_act": 1}
  assert got.dtype == dtype and got.shape == want.shape
  _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,res,relu", [
    ((1, 24, 128, 64, 64), 32, False, False),   # K5: hourglass conv6
    ((2, 24, 128, 64, 64), 32, False, False),   # K5 at batch 2
    ((1, 12, 64, 32, 64), 64, True, True),      # K7: conv5, + residual
    ((1, 3, 5, 7, 16), 24, True, True),         # odd extents, Cin < stage
    ((2, 1, 3, 2, 40), 72, False, True),        # D = 1; Cin 32 + 8; BN 128
    ((1, 1, 1, 7, 8), 130, True, False),        # D = H = 1; three N tiles
])
def test_deconv_tensor_core_kernel_matches_plain(gen, x_shape, cout, res,
                                                 relu, dtype):
  """K5/K7's tensor-core kernel (conv_body at S = DECONV: the eight output
  parity phases walked in one pipeline) against the plain version, the
  weight packed once as DeconvBn3d keeps it, He-scaled so the outputs are
  of order 1 (where one TF32 pass would miss the f32 bar)."""
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cin, cout, 3, 3, 3), generator=gen, device="cuda")
       * (2.0 / (27 * cout)) ** 0.5).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  oshape = (x_shape[0], *[2 * n for n in x_shape[1:4]], cout)
  r = (torch.randn(oshape, generator=gen, device="cuda").to(dtype)
       if res else None)
  packed = C.pack_weight_tc(w, transpose=True)
  kernels.reset_launches()
  got = C.deconv3d_bn_act(x, packed, scale, bias, r, relu)
  want = C.deconv3d_bn_act(x, w, scale, bias, r, relu, plain=True)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"deconv3d_bn_act": 1}
  assert got.dtype == dtype and got.shape == want.shape == oshape
  _close(got, want, dtype)


def test_deconv_entry_refuses_a_cin_off_its_copies(gen):
  """The deconv's C entry returns cudaErrorInvalidValue (1) without
  launching on Cin 12, which its 16-byte copies cannot take (the wrapper
  refuses it before that)."""
  x = torch.randn((1, 2, 3, 4, 16), generator=gen, device="cuda")
  tw = C.pack_weight_tc(torch.randn((16, 8, 3, 3, 3), generator=gen,
                                    device="cuda"), transpose=True)
  one = torch.ones(8, device="cuda")
  out = torch.full((1, 4, 6, 8, 8), 7.0, device="cuda")
  err = C._deconv3d_lib().deconv3d_bn_act(
      0, x.data_ptr(), tw.parts[0].data_ptr(), tw.parts[1].data_ptr(),
      one.data_ptr(), (0 * one).data_ptr(), None, out.data_ptr(), 1, 2, 3,
      4, 12, 8, 0, 0, torch.cuda.current_stream().cuda_stream)
  torch.cuda.synchronize()
  assert err == 1                                      # cudaErrorInvalidValue
  assert bool((out == 7.0).all())                      # nothing launched


@pytest.mark.parametrize("deconv,x_shape,cout", [
    (True, (2, 12, 32, 16, 64), 32),     # conv6's grad-input: K4 64 <- 32
    (True, (2, 3, 8, 4, 64), 64),        # conv5 (1/16 -> 1/8)
    (False, (2, 24, 64, 32, 32), 64),    # conv1: K4 forward, deconv dx
])
def test_strided_grad_input_matches_plain(gen, deconv, x_shape, cout):
  """The training Function of the deconv runs K4 as its grad-input (the
  torch (I, O, 3, 3, 3) weight read as the stride-2 conv's (Cout, Cin),
  packed K-major per call on the device), and that of the stride-2 conv
  runs K4 forward; against the plain Function's, f32."""
  cin = x_shape[-1]
  wshape = (cin, cout, 3, 3, 3) if deconv else (cout, cin, 3, 3, 3)
  w = torch.randn(wshape, generator=gen, device="cuda") * 0.05
  x = torch.randn(x_shape, generator=gen, device="cuda")

  def run(plain):
    xr = x.clone().requires_grad_(True)
    y = (C.deconv3d_train(xr, w, plain=plain) if deconv
         else C.conv3d_train(xr, w, 2, plain=plain))
    g = torch.randn(y.shape, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    y.backward(g)
    return y.detach(), xr.grad

  kernels.reset_launches()
  y, dx = run(False)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"conv3d_s2_bn_act": 1,
                                    "deconv3d_bn_act": 1}
  want_y, want_dx = run(True)
  _close(y, want_y, torch.float32)
  _close(dx, want_dx, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sphere_type,x_shape,cout,res,relu", [
    ("Cassini", (1, 256, 128, 128), 128, True, True),  # layer 4, one view
    ("Cassini", (1, 256, 128, 64), 128, False, True),  # layer 4's first conv
    ("Cassini", (2, 256, 128, 128), 128, False, False),
    ("ERP", (1, 128, 256, 128), 128, True, True),
    ("ERP", (6, 128, 256, 128), 128, True, True),      # a frame's six pairs
    ("Cassini", (1, 64, 32, 40), 72, True, False),     # drop row; tiles of
    ("ERP", (1, 32, 64, 40), 72, False, True),         # 64 span two bands
])
def test_sphere_conv_tensor_core_kernel_matches_plain(gen, sphere_type,
                                                      x_shape, cout, res,
                                                      relu, dtype):
  """K3/K10's tensor-core kernel against the plain gather version (which
  encodes the edge rules apart from the kernel's shift tables), the weight
  packed K-major once as the layers keep it, He-scaled; bf16 blends in f32
  and rounds the sample to bf16 as the Pallas kernel does."""
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
       * (2.0 / (9 * cin)) ** 0.5).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  r = (torch.randn((*x_shape[:3], cout), generator=gen, device="cuda")
       .to(dtype) if res else None)
  packed = C2.pack_weight_tc(w)
  kernels.reset_launches()
  got = S.sphere_conv_bn_act(x, packed, scale, bias, r, relu,
                             sphere_type=sphere_type)
  want = S.sphere_conv_bn_act(x, w, scale, bias, r, relu,
                              sphere_type=sphere_type, plain=True)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {S.FORWARD[sphere_type]: 1}
  assert got.dtype == dtype and got.shape == want.shape
  _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,dil,res,relu", [
    ((1, 64, 32, 32), 32, 1, False, True),    # the stem at batch 1 (K8)
    ((2, 32, 16, 64), 64, 2, True, True),     # layer 3, dilated (K9)
    ((6, 16, 8, 128), 128, 1, True, False),   # batch 6, Cout 128
    ((2, 16, 8, 32), 1, 1, False, False),     # Cout 1
    ((1, 9, 13, 24), 8, 2, True, True),       # Cout 8, ragged M
    ((1, 9, 13, 40), 40, 2, False, True),     # Cin 32 + 8
    ((2, 1, 2, 8), 32, 2, True, False),       # H = 1, W = 2
])
def test_conv2d_tensor_core_kernel_matches_plain(gen, x_shape, cout, dil, res,
                                                 relu, dtype):
  """K8/K9's tensor-core kernel against the plain version."""
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
       * (2.0 / (9 * cin)) ** 0.5).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  r = (torch.randn((*x_shape[:3], cout), generator=gen, device="cuda")
       .to(dtype) if res else None)
  packed = C2.pack_weight_tc(w)
  kernels.reset_launches()
  got = C2.conv2d_s1_bn_act(x, packed, scale, bias, r, relu, dil)
  want = C2.conv2d_s1_bn_act(x, w, scale, bias, r, relu, dil, plain=True)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"conv2d_s1_bn_act": 1}
  _close(got, want, dtype)


@pytest.mark.parametrize("two_d,x_shape,cout,dil", [
    (False, (2, 6, 16, 8, 32), 64, 1),
    (False, (2, 3, 8, 4, 64), 32, 1),
    (True, (2, 32, 16, 64), 32, 2),
    (True, (3, 16, 8, 128), 128, 1),
])
def test_tensor_core_grad_input_matches_plain(gen, two_d, x_shape, cout, dil):
  """The training Functions' grad-input (the flipped, io-swapped weight
  packed per call) on the kernels against the plain Function's, f32."""
  cin = x_shape[-1]
  wshape = (cout, cin, 3, 3) if two_d else (cout, cin, 3, 3, 3)
  w = torch.randn(wshape, generator=gen, device="cuda") * 0.05
  x = torch.randn(x_shape, generator=gen, device="cuda")
  g = torch.randn((*x_shape[:-1], cout), generator=gen, device="cuda")

  def dx(plain):
    xr = x.clone().requires_grad_(True)
    y = (C2.conv2d_train(xr, w, dil, plain=plain) if two_d
         else C.conv3d_train(xr, w, 1, plain=plain))
    y.backward(g)
    return xr.grad

  kernels.reset_launches()
  got = dx(False)
  torch.cuda.synchronize()
  key = "conv2d_s1_bn_act" if two_d else "conv3d_s1_bn_act"
  assert dict(kernels.LAUNCHES) == {key: 2}
  _close(got, dx(True), torch.float32)


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout", [
    ((2, 64, 32, 24), 40),      # drop row; Cin, Cout off the tiles
    ((1, 32, 16, 8), 128),
    ((2, 128, 64, 64), 128),    # the first layer-4 conv, at half size
    ((1, 64, 32, 128), 64),
    ((2, 256, 128, 64), 128),   # the first layer-4 conv of a batch-2 step
    ((2, 256, 128, 128), 128),  # its other layer-4 convs
    ((1, 80, 40, 72), 40),      # a 16-lane dw stage; Cin 72
])
def test_sphere_conv_backward_kernels_match_plain(gen, x_shape, cout, dtype):
  """dx against the plain scatter (index_add_), dw (f32, split over pixel
  blocks and summed in a fixed order) against the plain contraction; the
  kernel's dw is the same on a second run (no atomics)."""
  n, h, w, cin = x_shape
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  g = torch.randn((n, h, w, cout), generator=gen, device="cuda").to(dtype)
  wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
        * 0.2).to(dtype)
  kernels.reset_launches()
  dx, dw = S.sphere_conv_backward(x, wt, g)
  again = S.sphere_conv_bwd_weight(x, g)
  torch.cuda.synchronize()
  assert kernels.LAUNCHES["sphere_conv_bwd_input"] == 1
  assert kernels.LAUNCHES["sphere_conv_bwd_weight"] == 2
  want_dx, want_dw = S.sphere_conv_backward(x, wt, g, plain=True)
  assert dx.dtype == dtype and dw.dtype == torch.float32
  assert dw.shape == wt.shape
  _close(dx, want_dx, dtype)
  _close(dw, want_dw, torch.float32)
  assert torch.equal(again, S.pack_weight(dw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,res,relu", [
    ((1, 128, 256, 64), 128, False, True),    # layer 4's first conv
    ((1, 128, 256, 128), 128, True, True),    # a block's conv2: shortcut, ReLU
    ((1, 128, 256, 128), 128, False, False),
    ((2, 32, 64, 24), 40, True, False),       # drop column; Cin, Cout ragged
])
def test_erp_sphere_conv_kernel_matches_plain(gen, x_shape, cout, res, relu,
                                              dtype):
  """K10's kernel at the ERP layer-4 shapes of a 512x1024 pair, against the
  plain gather version."""
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
       * 0.2).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  r = (torch.randn((*x_shape[:3], cout), generator=gen, device="cuda")
       .to(dtype) if res else None)
  kernels.reset_launches()
  got = S.sphere_conv_bn_act(x, w, scale, bias, r, relu, sphere_type="ERP")
  want = S.sphere_conv_bn_act(x, w, scale, bias, r, relu, sphere_type="ERP",
                              plain=True)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"sphere_conv_erp_bn_act": 1}
  _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout", [
    ((2, 128, 256, 64), 128),   # the first layer-4 conv of a batch-2 step
    ((2, 128, 256, 128), 128),
    ((2, 32, 64, 24), 40),      # drop column; Cin, Cout off the tiles
    ((1, 40, 80, 72), 40),      # a 16-lane dw stage; Cin 72
])
def test_erp_sphere_conv_backward_kernels_match_plain(gen, x_shape, cout,
                                                      dtype):
  """K10b's two kernels against the plain scatter and contraction; dw is
  the same bit for bit on a second run."""
  n, h, w, cin = x_shape
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  g = torch.randn((n, h, w, cout), generator=gen, device="cuda").to(dtype)
  wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
        * 0.2).to(dtype)
  kernels.reset_launches()
  dx, dw = S.sphere_conv_backward(x, wt, g, sphere_type="ERP")
  again = S.sphere_conv_bwd_weight(x, g, sphere_type="ERP")
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"sphere_conv_erp_bwd_input": 1,
                                    "sphere_conv_erp_bwd_weight": 2}
  want_dx, want_dw = S.sphere_conv_backward(x, wt, g, sphere_type="ERP",
                                            plain=True)
  assert dx.dtype == dtype and dw.dtype == torch.float32
  assert dw.shape == wt.shape
  _close(dx, want_dx, dtype)
  _close(dw, want_dw, torch.float32)
  assert torch.equal(again, S.pack_weight(dw))


@pytest.mark.parametrize("sphere_type,shape", [("Cassini", (1, 64, 32)),
                                              ("ERP", (1, 32, 64))])
def test_dx_kernel_refuses_what_it_does_not_take(gen, sphere_type, shape):
  """The tensor-core dx kernel copies g 16 bytes at a time: its wrapper
  refuses a Cout that is no multiple of 8 and a g that is not 16-byte
  aligned, its packed-weight check a weight packed for another Cout, dtype
  or device, each with a ValueError naming the kernel, and its C entry
  returns cudaErrorInvalidValue (1) for Cout 12 without launching."""
  name = S.BWD_INPUT[sphere_type]
  g = torch.randn((*shape, 12), generator=gen, device="cuda")
  w = torch.randn((12, 8, 3, 3), generator=gen, device="cuda")
  with pytest.raises(ValueError, match=f"{name}: Cout must be a multiple"):
    S.sphere_conv_bwd_input(g, w, sphere_type=sphere_type)
  offset = torch.randn(g.numel() // 12 * 16 + 1, generator=gen, device="cuda")
  g16 = offset[1:].view(*shape, 16)
  w16 = torch.randn((16, 8, 3, 3), generator=gen, device="cuda")
  with pytest.raises(ValueError, match=f"{name}: .*aligned"):
    S.sphere_conv_bwd_input(g16, w16, sphere_type=sphere_type)
  g16 = g16.clone()
  wk = S.pack_weight(w16)
  for parts in (kmajor.pack(wk[:, :4], wk, True).parts,
                kmajor.pack(wk.bfloat16(), wk, False).parts,
                kmajor.pack(wk.cpu(), wk, True).parts):
    with pytest.raises(ValueError, match=f"{name}: weight .* does not match"):
      kmajor.pointers(name, g16, parts, 9, 8, True)
  parts = kmajor.pack(wk, wk, True).parts
  table = S._device_tables("transpose", *shape[1:], sphere_type, g.device)
  dx = torch.empty((*shape, 8), device="cuda")
  err = getattr(S._bwd_lib(), name)(
      0, g.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
      table[0].data_ptr(), table[1].data_ptr(), dx.data_ptr(), *shape, 8,
      12, torch.cuda.current_stream().cuda_stream)
  assert err == 1                                      # cudaErrorInvalidValue
  torch.cuda.synchronize()


@pytest.mark.parametrize("sphere_type,shape", [("Cassini", (1, 64, 32)),
                                              ("ERP", (1, 32, 64))])
def test_dw_kernel_refuses_what_it_does_not_take(gen, sphere_type, shape):
  """The tensor-core dw kernel copies x and g 16 bytes at a time: its
  wrapper refuses a Cin or Cout that is no multiple of 8 and an x or g
  that is not 16-byte aligned, with a ValueError naming the kernel, and
  its C entry returns cudaErrorInvalidValue (1) for Cin 12 without
  launching."""
  name = S.BWD_WEIGHT[sphere_type]
  kernels.reset_launches()
  x12 = torch.randn((*shape, 12), generator=gen, device="cuda")
  x8 = torch.randn((*shape, 8), generator=gen, device="cuda")
  for x, g in ((x12, x8), (x8, x12)):
    with pytest.raises(ValueError, match=f"{name}: Cin and Cout must be"):
      S.sphere_conv_bwd_weight(x, g, sphere_type=sphere_type)
  offset = torch.randn(x8.numel() + 1, generator=gen, device="cuda")
  with pytest.raises(ValueError, match=f"{name}: .*aligned"):
    S.sphere_conv_bwd_weight(offset[1:].view(x8.shape), x8,
                             sphere_type=sphere_type)
  itab, ftab = S._device_tables("shift", *shape[1:], sphere_type, x8.device)
  part = torch.empty((1, 9 * 12, 8), device="cuda")
  dw = torch.empty((9, 12, 8), device="cuda")
  err = getattr(S._bwd_lib(), name)(
      0, x12.data_ptr(), x8.data_ptr(), itab.data_ptr(), ftab.data_ptr(),
      part.data_ptr(), dw.data_ptr(), *shape, 12, 8, 1, 64,
      torch.cuda.current_stream().cuda_stream)
  assert err == 1                                      # cudaErrorInvalidValue
  torch.cuda.synchronize()
  assert not kernels.LAUNCHES


def test_regression_kernel_holds_sharp_logits(gen):
  """Logits uniform in +-60, a sharp softmax whose top upsampled logit lies
  well below the max-of-sources shift at some pixels: the kernel stays
  finite and holds the plain version (the sphere_b1 shape, f32)."""
  cost = (torch.rand((1, 48, 256, 128), generator=gen, device="cuda") * 120
          - 60)
  pred, conf = R.fused_disparity_regression(cost, 192, 1024, 512)
  ref_pred, ref_conf = R.fused_disparity_regression(cost, 192, 1024, 512,
                                                    plain=True)
  torch.cuda.synchronize()
  assert bool(torch.isfinite(pred).all() and torch.isfinite(conf).all())
  _close(pred, ref_pred, torch.float32)
  tie = (ref_pred - ref_pred.floor() - 0.5).abs() < 1e-3
  _close(conf[~tie], ref_conf[~tie], torch.float32)


def test_sphere_kernels_refuse_the_other_layout(gen):
  """Each layout's wrappers refuse a map of the other layout on the card."""
  cassini = torch.randn((1, 32, 16, 8), generator=gen, device="cuda")
  erp = cassini.transpose(1, 2).contiguous()
  w = torch.randn((8, 8, 3, 3), generator=gen, device="cuda")
  with pytest.raises(ValueError, match="Cassini"):
    S.sphere_conv_bn_act(erp, w)
  with pytest.raises(ValueError, match="ERP"):
    S.sphere_conv_bn_act(cassini, w, sphere_type="ERP")
  with pytest.raises(ValueError, match="ERP"):
    S.sphere_conv_bwd_input(cassini, w, sphere_type="ERP")
  with pytest.raises(ValueError, match="ERP"):
    S.sphere_conv_bwd_weight(cassini, cassini, sphere_type="ERP")
  with pytest.raises(ValueError, match="Cassini"):
    S.sphere_conv_bwd_weight(erp, erp)


def test_erp_slice_at_batch_two_runs_the_kernels(gen):
  """The ERP model at batch 2: 16 ERP sphere convs and 32 2-D convs per view
  on the kernels, none on the Cassini sphere kernel, features as the plain
  path's (relative to their largest value, as random weights grow them)."""
  from mode_tpu_torch.models.disparity import ModeDisparity
  model = ModeDisparity(16, "Sphere", "ERP", out_conf=True, device="cuda")
  left = torch.randn((2, 64, 128, 3), generator=gen, device="cuda")
  with torch.no_grad():
    feat = model.feature_extraction(left)
    ref = model.feature_extraction(left, plain=True)
  torch.cuda.synchronize()
  assert float((feat - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
  kernels.reset_launches()
  with torch.no_grad():
    pred, conf = model(left, torch.roll(left, 4, dims=2))
  torch.cuda.synchronize()
  assert kernels.LAUNCHES["sphere_conv_erp_bn_act"] == 32
  assert kernels.LAUNCHES["conv2d_s1_bn_act"] == 64
  assert kernels.LAUNCHES["sphere_conv_bn_act"] == 0
  assert pred.shape == conf.shape == (2, 64, 128)
  assert bool(torch.isfinite(pred).all() and torch.isfinite(conf).all())


# The f32 per-leaf bar of the steps below (chip_smoke.STEP_BARS holds its
# own steps' leaves at 1e-3): at 512x256 with the trained weights a leaf
# needs up to 1.0e-3 beyond twice its spread.
F32_LEAF = 1e-2


def _step_against_plain(model, make_step, inputs, dtype):
  """One step of ``make_step(model, plain=False)`` through the kernels on
  ``inputs`` (float tensors, then the target) against the same step through
  the plain versions from an identical copy, held by ``chip_smoke.py``'s
  ``grad_check`` at its ``STEP_BARS[dtype]`` (in f32 each leaf at
  ``F32_LEAF``). Returns the kernel step's launches."""
  import chip_smoke
  bars = dict(chip_smoke.STEP_BARS[dtype])
  if dtype == torch.float32:
    bars["leaf"] = F32_LEAF
  plain_step = chip_smoke.plain_stepper(model, make_step, inputs)
  kernels.reset_launches()
  loss = float(make_step(model, plain=False)(*inputs))
  torch.cuda.synchronize()
  launched = dict(kernels.LAUNCHES)
  grads = {n: p.grad for n, p in model.named_parameters()}
  assert all(g.dtype == torch.float32 for g in grads.values())
  check = chip_smoke.grad_check("card test", plain_step, loss, grads, dtype,
                                bars=bars)
  assert check["ok"], check
  return launched


def _textured_pair(gen, h, w, disp):
  import torch.nn.functional as F
  fine = torch.randn((2, 3, h // 2, w // 2), generator=gen, device="cuda")
  coarse = torch.randn((2, 3, h // 8, w // 8), generator=gen, device="cuda")
  left = (F.interpolate(fine, size=(h, w), mode="bilinear")
          + 0.5 * F.interpolate(coarse, size=(h, w), mode="bilinear"))
  left = left.permute(0, 2, 3, 1).contiguous()
  return left, torch.roll(left, -disp, dims=2)


def _stage1_step(gen, dtype):
  """One stage-1 step at 512x256, batch 2, with the trained mid-resolution
  weights (maxdisp 48) on a textured pair, against its plain step."""
  import pathlib
  from mode_tpu_torch import training
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.utils.convert import load_npz
  root = pathlib.Path(__file__).resolve().parents[1]
  model = load_npz(ModeDisparity(48, device="cuda"),
                   root / "tests/data/trained_mirror_mid.npz")
  left, right = _textured_pair(gen, 512, 256, 12)
  gt = torch.full((2, 512, 256), 12.0, device="cuda")
  gt[:, 40:80, 20:60] = float("nan")
  cdt = None if dtype == torch.float32 else dtype

  def make_step(m, compute_dtype=cdt, plain=False):
    return training.make_disparity_train_step(
        m, training.make_optimizer(m.parameters()),
        compute_dtype=compute_dtype, plain=plain)

  return _step_against_plain(model, make_step, (left, right, gt), dtype)


STAGE1_LAUNCHES = {"conv3d_s1_bn_act": 14, "conv3d_s2_bn_act": 6,
                   "deconv3d_bn_act": 6, "conv2d_s1_bn_act": 128,
                   "sphere_conv_bn_act": 32, "sphere_conv_bwd_input": 32,
                   "sphere_conv_bwd_weight": 32}


def test_train_step_kernels_match_plain(gen):
  """One step at 512x256, batch 2, where every kernel family trains
  (tests/test_torch_train_step.py counts the routing), with the trained
  mid-resolution weights (maxdisp 48) on a textured pair, through the
  kernels and through the plain versions from an identical copy, at
  ``chip_smoke.STEP_BARS``: the same loss; all the gradients within 1e-3
  of the plain ones' norm plus twice their spread, the largest distance by
  which a 1e-6 jitter of the normalised inputs moves the plain step's
  gradients (two draws); each leaf within 1e-2 plus twice its spread. The
  BN stack amplifies f32 rounding in the gradients by ~1e2-1e3 at this
  size, so a leaf may part from the plain one by a few 1e-3; the kernels
  themselves are held at 1e-5 above."""
  launched = _stage1_step(gen, torch.float32)
  assert launched == STAGE1_LAUNCHES, launched


def test_bf16_train_step_kernels_match_plain(gen):
  """The same step in mixed precision (bf16 activations and conv weights,
  f32 masters), every kernel family in bf16 forward and backward, against
  the plain bf16 step at ``chip_smoke.STEP_BARS``: the loss within 1e-2;
  the leaves that a one-bf16-step input jitter moves by less than 0.15 of
  their norm within 1e-2 globally and 1e-1 each of the plain ones' norm
  plus twice their spread (four draws); the gradients f32."""
  launched = _stage1_step(gen, torch.bfloat16)
  assert launched == STAGE1_LAUNCHES, launched


@pytest.mark.parametrize("dtype", DTYPES)
def test_fusion_train_step_kernels_match_plain(gen, dtype):
  """One fusion step (``make_fusion_train_step`` on the packed wire
  inputs) at batch 2, 256x128, seeded weights with the head scaled to
  logits of std ~1, through the kernels and through the plain versions:
  K9 trains the 24 stride-1 3x3 convs of the 256x128 (W 128) and 128x64
  (H 128) levels that have a Cin multiple of 8, forward and grad-input
  (tests/test_torch_fusion_train.py counts the routing); the bars of
  ``chip_smoke.STEP_BARS``, which in bf16 hold only the leaves next to the
  head (the seeded net's other gradients are rounding noise in bf16)."""
  import functools

  import chip_smoke
  from mode_tpu_torch import training
  from mode_tpu_torch.models.fusion import ModeFusion
  b, h, w = 2, 256, 128
  model = ModeFusion(device="cuda")
  with torch.no_grad():         # train-mode logits of a std ~1
    model.feature_extraction.depth_layer7[2].weight.mul_(0.5)
  depths = [(torch.rand((b, h, w, 1), generator=gen, device="cuda") * 999
             + 1).half() for _ in range(6)]
  confs = [torch.randint(0, 256, (b, h, w, 1), generator=gen, device="cuda",
                         dtype=torch.uint8) for _ in range(6)]
  rgbs = [torch.randint(0, 256, (b, h, w, 3), generator=gen, device="cuda",
                        dtype=torch.uint8) for _ in range(4)]
  gt = torch.rand((b, h, w), generator=gen, device="cuda") * 1100
  unpacked = training.unpack_fusion_inputs(depths, confs, rgbs, dtype)
  make_step = functools.partial(
      chip_smoke.fusion_step,
      compute_dtype=None if dtype == torch.float32 else dtype)
  launched = _step_against_plain(model, make_step,
                                 (*unpacked[0], *unpacked[1], *unpacked[2],
                                  gt), dtype)
  assert launched == {"conv2d_s1_bn_act": 48}, launched


@pytest.mark.parametrize("h,w", [(64, 32), (256, 128)])
def test_bridge_on_the_card_matches_the_cpu(gen, h, w):
  """The bridge on the card against the same function on the CPU from the
  same disparities: the carried confidences (which show each target's
  winner) bit-equal and the depths within 4e-7 of their value at >= 99.9%
  of the pixels of each pair."""
  from mode_tpu_torch.pipeline import bridge_all_pairs
  disps = torch.rand((6, h, w), generator=gen, device="cuda") * (w / 3)
  confs = torch.rand((6, h, w), generator=gen, device="cuda")
  d, c = bridge_all_pairs(disps, confs)
  rd, rc = bridge_all_pairs(disps.cpu(), confs.cpu())
  d, c = d.cpu(), c.cpu()
  for k in range(6):
    conf_differ = (c[k] != rc[k]).float().mean()
    depth_differ = ((d[k] - rd[k]).abs() > 4e-7 * rd[k].abs()).float().mean()
    assert conf_differ <= 1e-3 and depth_differ <= 1e-3, (k, conf_differ,
                                                          depth_differ)


@pytest.mark.parametrize("form", ["scatter", "sort", "sort2x"])
def test_zbuffer_forms_on_the_card_match_the_cpu_sort(gen, form):
  """Each z-buffer form on the card at 1024x512, K = 3 (the three "trans"
  pairs): ``_zbuffer_resolve`` on the CPU's radii and targets bit-equal to
  the CPU's "sort" (``best``; ``winner`` wherever ``best`` is under the
  sentinel, the only winners a caller reads), the batched re-projection
  bit-equal to the card's "sort", and within the bridge's bar of the CPU's
  "sort" (the radii are computed on each device)."""
  from mode_tpu_torch.geometry import reprojection as rep
  h, w, k = 1024, 512, 3
  params = tuple(rep.DEEP360_PAIR_TRANSFORMS[p][1] for p in ("23", "24",
                                                              "34"))
  depths = torch.rand((k, h, w), generator=gen, device="cuda") * 40
  depths[torch.rand((k, h, w), generator=gen, device="cuda") < 0.1] = 0.0
  confs = torch.rand((k, h, w), generator=gen, device="cuda")
  n = k * h * w
  tgt = torch.randint(0, n // 4, (n,), generator=gen, device="cuda")
  r2 = (torch.randint(0, 64, (n,), generator=gen, device="cuda") * 0.25
        ).float()
  r2[torch.rand((n,), generator=gen, device="cuda") < 0.05] = torch.inf
  r2[torch.rand((n,), generator=gen, device="cuda") < 0.02] = rep._SENTINEL
  bits = lambda t: t.cpu().view(torch.int32)
  rep.set_zbuffer_impl("sort")
  want_best, want_win = rep._zbuffer_resolve(r2.cpu(), tgt.cpu(), n)
  want_d, want_c = rep.depth_view_transforms_batched(depths.cpu(),
                                                     confs.cpu(), params)
  card_d, card_c = rep.depth_view_transforms_batched(depths, confs, params)
  try:
    rep.set_zbuffer_impl(form)
    best, win = rep._zbuffer_resolve(r2, tgt, n)
    d, c = rep.depth_view_transforms_batched(depths, confs, params)
  finally:
    rep.set_zbuffer_impl("sort")
  assert torch.equal(bits(best), bits(want_best))
  read = want_best < rep._SENTINEL
  assert torch.equal(win.cpu()[read], want_win[read])
  assert torch.equal(bits(d), bits(card_d)) and torch.equal(bits(c),
                                                           bits(card_c))
  d, c = d.cpu(), c.cpu()
  for i in range(k):
    conf_differ = (c[i] != want_c[i]).float().mean()
    depth_differ = (d[i] != want_d[i]).float().mean()
    assert conf_differ <= 1e-3 and depth_differ <= 1e-3, (i, conf_differ,
                                                          depth_differ)


@pytest.mark.parametrize("h,w,maxdisp", [(64, 32, 16), (256, 128, 16)])
def test_frame_on_the_card_matches_plain(gen, h, w, maxdisp):
  """``TwoStagePipeline`` on the card against its plain path from the same
  uint8 inputs, the plain path deterministic: stage 1 at the served bars;
  the bridged depths of both paths' disparities apart by more than 1e-3 of
  their value (a z-buffer winner flipped) at <= 1e-3 of the pixels; the
  fused depth within 1e-3 m (MAE) and 5e-2 m of the plain fusion net on
  the same bridged maps; at 256x128 the fusion net's full-resolution convs
  run the 2-D kernel (W = 128)."""
  import pathlib

  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import ModeFusion
  from mode_tpu_torch.pipeline import TwoStagePipeline, bridge_all_pairs
  from mode_tpu_torch.utils.convert import load_npz
  root = pathlib.Path(__file__).resolve().parents[1]
  disp = load_npz(ModeDisparity(maxdisp, out_conf=True, device="cuda"),
                  root / "tests/data/trained_mirror.npz")
  fusion = ModeFusion(device="cuda")
  with torch.no_grad():        # logits of a std ~1 (seeded features ~400)
    fusion.feature_extraction.depth_layer7[2].weight.mul_(1 / 400)
  pipe = TwoStagePipeline(disp, fusion, maxdisp, uint8_inputs=True)
  lefts = torch.randint(0, 256, (6, h, w, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
  rights = torch.roll(lefts, -8, dims=2)
  rgbs = torch.stack([lefts[0], rights[0], lefts[5], rights[5]])
  kernels.reset_launches()
  fused, pred, conf = pipe(lefts, rights, rgbs)
  torch.cuda.synchronize()
  launches = dict(kernels.LAUNCHES)
  # the plain path's library convs on deterministic cuDNN algorithms (the
  # default ones vary between repeats by ~4e-6 px); two repeats must agree
  # bit for bit
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    refs = [pipe.stage1(lefts, rights, plain=True) for _ in range(2)]
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = deterministic
  assert all(torch.equal(a, b) for a, b in zip(*refs))
  ref_pred, ref_conf = refs[0]
  assert launches["sphere_conv_bn_act"] == 32
  if w % 128 == 0:
    assert launches["conv2d_s1_bn_act"] >= 16
  err = (pred - ref_pred).abs()
  assert float(err.mean()) <= 1e-3 and float(err.max()) <= 1e-2
  assert float((conf - ref_conf).abs().mean()) <= 1e-3
  # The bridge is a z-buffer: where two candidates lie within stage 1's
  # ~1e-5 px of each other the two paths may pick different winners (2
  # pixels at 256x128, 3.76 m apart), and the fusion net spreads a flip
  # over its receptive field (~500 pixels). So the winners are held by
  # count, and the fusion net on the kernel path's bridged maps.
  depths, confs = bridge_all_pairs(pred, conf)
  ref_depths, _ = bridge_all_pairs(ref_pred, ref_conf)
  flipped = ((depths - ref_depths).abs() > 1e-3 * ref_depths.abs()).float()
  assert float(flipped.mean()) <= 1e-3
  assert torch.equal(pipe.fuse(depths, confs, rgbs), fused)
  ref_fused = pipe.fuse(depths, confs, rgbs, plain=True)
  ferr = (fused - ref_fused).abs()
  assert float(ferr.mean()) <= 1e-3 and float(ferr.max()) <= 5e-2
  assert fused.shape == (h, w) and bool(torch.isfinite(fused).all())


def test_trainers_take_a_step_on_the_card(gen, tmp_path):
  """Both training CLIs, one step each with their default device at 512x256
  (a synthetic tree, batch 2): ``train_disparity`` from the trained weights
  launches every stage-1 kernel in its step and validation,
  ``train_fusion --packed_dir`` the 2-D kernel (forward and grad-input);
  each loss is finite and each checkpoint loads strictly."""
  import importlib.util
  import pathlib

  from mode_tpu_torch.cli import train_disparity, train_fusion
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import ModeFusion
  from mode_tpu_torch.utils.convert import load_npz
  root = pathlib.Path(__file__).resolve().parents[1]
  # by its path: run with --noconftest, ``tests`` may resolve to another
  # installed package of that name
  spec = importlib.util.spec_from_file_location(
      "synth_data", root / "tests" / "synth_data.py")
  synth = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(synth)
  h, w, maxdisp = 512, 256, 16
  data = synth.make_deep360_tree(str(tmp_path / "data"), frames_per_subset=2,
                                 h=h, w=w)
  pred = synth.make_fusion_inputs(str(tmp_path / "pred"), data)
  tar = str(tmp_path / "disp.tar")
  torch.save({"epoch": 0, "state_dict": load_npz(
      ModeDisparity(maxdisp, device="cpu"),
      root / "tests/data/trained_mirror.npz").state_dict()}, tar)
  kernels.reset_launches()
  out = train_disparity.main([
      "--dataset_root", data, "--height", str(h), "--width", str(w),
      "--max_disp", str(maxdisp), "--checkpoint_disp", tar, "--epochs", "1",
      "--steps_per_epoch", "1", "--batch_size", "2",
      "--save_checkpoint_path", str(tmp_path / "disp")])
  launches = dict(kernels.LAUNCHES)
  for name in ("conv3d_s1_bn_act", "conv3d_s2_bn_act", "deconv3d_bn_act",
               "conv2d_s1_bn_act", "sphere_conv_bn_act",
               "sphere_conv_bwd_input", "sphere_conv_bwd_weight",
               "fused_disparity_regression"):
    assert launches.get(name, 0) > 0, (name, launches)
  assert len(out["losses"]) == 1 and all(
      torch.isfinite(torch.tensor([*out["losses"], *out["val"][1]])))
  saved = torch.load(str(tmp_path / "disp" / "ModeDisparity" / "Deep360" /
                         "ckpt_disp_ModeDisparity_Deep360_1.tar"),
                     weights_only=True)
  ModeDisparity(maxdisp, device="cuda").load_state_dict(saved["state_dict"],
                                                        strict=True)
  kernels.reset_launches()
  out = train_fusion.main([
      "--datapath-input", pred, "--datapath-dataset", data, "--epochs", "1",
      "--steps_per_epoch", "1", "--batch-size", "2", "--packed_dir",
      str(tmp_path / "packs"), "--savemodel", str(tmp_path / "fusion")])
  assert kernels.LAUNCHES["conv2d_s1_bn_act"] >= 2 * 8
  assert len(out["losses"]) == 1 and all(
      torch.isfinite(torch.tensor(out["losses"])))
  saved = torch.load(str(tmp_path / "fusion" / "ModeFusion" / "Deep360" /
                         "ckpt_fusion_epoch0.tar"), weights_only=True)
  ModeFusion(device="cuda").load_state_dict(saved["state_dict"], strict=True)


# --- the spatial axis: the halo forms and the row window ----------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn,x_shape,cout,res,relu", [
    # a rank's rows of a 1024x512 pair at spatial 2, with its two halo rows
    (C.conv3d_s1_bn_act, (1, 48, 130, 128, 64), 32, False, True),   # dres0.0
    (C.conv3d_s1_bn_act, (1, 48, 130, 128, 32), 32, True, False),   # dres1.2
    (C.conv3d_s1_bn_act, (1, 48, 130, 128, 32), 1, False, False),   # head
    (C.conv3d_s1_bn_act, (1, 6, 18, 16, 64), 64, False, True),      # K6
    (C.conv3d_s2_bn_act, (1, 48, 130, 128, 32), 64, False, True),   # conv1
    (C.conv3d_s2_bn_act, (1, 24, 66, 64, 64), 64, False, True),     # conv3
    (C.deconv3d_bn_act, (1, 6, 18, 16, 64), 64, True, True),        # K7
    (C.deconv3d_bn_act, (1, 12, 34, 32, 64), 32, False, False),     # conv6
    # spatial 4, and a ragged shard
    (C.conv3d_s1_bn_act, (1, 48, 66, 128, 32), 32, False, True),
    (C.conv3d_s2_bn_act, (2, 5, 8, 7, 24), 40, False, True),
    (C.deconv3d_bn_act, (2, 3, 5, 5, 16), 24, True, False),
])
def test_halo_kernel_matches_plain(gen, fn, x_shape, cout, res, relu, dtype):
  """Each kernel's halo form (``h_halo=True``) against its plain halo
  version on the same haloed rows: one launch, counted as haloed."""
  cin = x_shape[-1]
  deconv = fn is C.deconv3d_bn_act
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cin, cout, 3, 3, 3) if deconv else (cout, cin, 3, 3, 3),
                   generator=gen, device="cuda")
       * (2.0 / (27 * cout)) ** 0.5).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  kw = {"relu": relu, "h_halo": True}
  rows = x_shape[2] - 2
  if res:
    shape = ((x_shape[0], 2 * x_shape[1], 2 * rows, 2 * x_shape[3], cout)
             if deconv else (*x_shape[:2], rows, x_shape[3], cout))
    kw["residual"] = torch.randn(shape, generator=gen, device="cuda").to(dtype)
  kernels.reset_launches()
  got = fn(x, w, scale, bias, **kw)
  want = fn(x, w, scale, bias, plain=True, **kw)
  torch.cuda.synchronize()
  assert sum(kernels.LAUNCHES.values()) == 1
  assert sum(kernels.HALO_LAUNCHES.values()) == 1
  assert got.dtype == dtype and got.shape == want.shape
  _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_shape,cout,res,relu", [
    # a rank's rows of the fusion net's 1024x512 maps at spatial 2, with
    # its two halo rows: every level the 2-D kernel takes, Cin 12 padded
    ((1, 514, 512, 16), 32, False, True),     # depth_layer1.0.conv1
    ((1, 514, 512, 32), 32, False, True),
    ((1, 514, 512, 64), 32, False, True),     # fusion_layer1, depth_layer7
    ((1, 258, 256, 32), 64, False, True),
    ((1, 258, 256, 64), 64, False, True),
    ((1, 258, 256, 128), 64, False, True),
    ((1, 130, 128, 64), 128, False, True),
    ((1, 130, 128, 128), 128, False, True),
    ((1, 130, 128, 256), 128, False, True),
    # spatial 4, the Sphere stem at spatial 2, and ragged shards
    ((1, 66, 128, 128), 128, False, True),
    ((1, 258, 256, 32), 32, False, True),
    ((2, 5, 13, 24), 40, True, False),
    ((1, 3, 9, 40), 8, True, True),
])
def test_conv2d_halo_kernel_matches_plain(gen, x_shape, cout, res, relu,
                                          dtype):
  """K8's halo form (``h_halo=True``) against its plain halo version on the
  same haloed rows: one launch, counted as haloed."""
  cin = x_shape[-1]
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
  w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
       * (2.0 / (9 * cin)) ** 0.5).to(dtype)
  scale = torch.randn(cout, generator=gen, device="cuda") * 0.3 + 1
  bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
  r = (torch.randn((x_shape[0], x_shape[1] - 2, x_shape[2], cout),
                   generator=gen, device="cuda").to(dtype) if res else None)
  packed = C2.pack_weight_tc(w)
  kernels.reset_launches()
  got = C2.conv2d_s1_bn_act(x, packed, scale, bias, r, relu, h_halo=True)
  want = C2.conv2d_s1_bn_act(x, w, scale, bias, r, relu, h_halo=True,
                             plain=True)
  torch.cuda.synchronize()
  assert dict(kernels.LAUNCHES) == {"conv2d_s1_bn_act": 1}
  assert dict(kernels.HALO_LAUNCHES) == {"conv2d_s1_bn_act": 1}
  assert got.dtype == dtype and got.shape == want.shape == (
      x_shape[0], x_shape[1] - 2, *x_shape[2:3], cout)
  _close(got, want, dtype)


def test_conv2d_halo_entry_refuses_dilation_2(gen):
  """The C entry refuses a halo with dilation 2 (the JAX package shards
  only dilation-1 convs), returning cudaErrorInvalidValue unlaunched."""
  x = torch.randn((1, 6, 8, 16), generator=gen, device="cuda")
  tw = C2.pack_weight_tc(torch.randn((16, 16, 3, 3), generator=gen,
                                     device="cuda"))
  one = torch.ones(16, device="cuda")
  out = torch.full((1, 4, 8, 16), 7.0, device="cuda")
  err = C2._conv2d_lib().conv2d_s1_bn_act(
      0, x.data_ptr(), tw.parts[0].data_ptr(), tw.parts[1].data_ptr(),
      one.data_ptr(), (0 * one).data_ptr(), None, out.data_ptr(), 1, 6, 8,
      16, 16, 2, 0, 1, torch.cuda.current_stream().cuda_stream)
  torch.cuda.synchronize()
  assert err == 1                                      # cudaErrorInvalidValue
  assert bool((out == 7.0).all())                      # nothing launched


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row0,h_out", [(512, 512), (0, 256), (768, 256),
                                        (5, 17)])
def test_regression_window_matches_plain(gen, row0, h_out, dtype):
  """K2's row window at the 1024x512 shapes: rank 1 of 2, ranks 0 and 3
  of 4, and a ragged window; the plain window computes the same rows."""
  cost = (torch.randn((1, 48, 256, 128), generator=gen, device="cuda")
          * 2.0).to(dtype)
  pred, conf = R.fused_disparity_regression(cost, 192, 1024, 512, row0=row0,
                                            h_out=h_out)
  ref_pred, ref_conf = R.fused_disparity_regression(
      cost, 192, 1024, 512, row0=row0, h_out=h_out, plain=True)
  torch.cuda.synchronize()
  assert pred.shape == (1, h_out, 512)
  _close(pred, ref_pred, torch.float32)
  tie = (ref_pred - ref_pred.floor() - 0.5).abs() < 1e-3
  _close(conf[~tie], ref_conf[~tie], torch.float32)


# a rank's rows of a batch-2 1024x512 training step at spatial 2: (stride
# 1, 2 or the deconv, x's shape, Cout)
TRAIN_HALO_CASES = [
    (1, (2, 48, 128, 128, 64), 32),       # dres0.0
    (1, (2, 48, 128, 128, 32), 32),       # dres1, classif.0
    (1, (2, 24, 64, 64, 64), 64),         # hourglass conv2 (1/8)
    (2, (2, 48, 128, 128, 32), 64),       # conv1 (its dx: K5's halo form)
    (2, (2, 24, 64, 64, 64), 64),         # conv3 (its dx: K7's halo form)
    ("deconv", (2, 12, 32, 32, 64), 64),  # conv5 (its dx: K4's halo form)
    ("deconv", (2, 24, 64, 64, 64), 32),  # conv6
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride,x_shape,cout", TRAIN_HALO_CASES)
def test_sharded_training_function_matches_plain(gen, monkeypatch, stride,
                                                 x_shape, cout, dtype):
  """The training Function on a rank's rows (``mesh`` with a spatial axis):
  its forward on the kernel's halo form and its grad-input on the matching
  halo form of the cotangent, two haloed launches, against the same
  Function through the plain versions; the grad-weight (a library call)
  alike. The neighbours' planes come from a stub of the exchange, the
  same seeded planes for both runs."""
  from types import SimpleNamespace
  mesh = SimpleNamespace(spatial=2)

  def planes(t, axis, mesh):
    g = torch.Generator(device="cuda").manual_seed(t.shape[axis] + t.shape[-1])
    shape = (*t.shape[:axis], 1, *t.shape[axis + 1:])
    return tuple(torch.randn(shape, generator=g, device="cuda").to(t.dtype)
                 for _ in range(2))

  monkeypatch.setattr(C, "halo_planes", planes)
  deconv = stride == "deconv"
  cin = x_shape[-1]
  w = (torch.randn((cin, cout, 3, 3, 3) if deconv else (cout, cin, 3, 3, 3),
                   generator=gen, device="cuda")
       * (2.0 / (27 * cin)) ** 0.5).to(dtype)
  x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)

  def run(plain):
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = (C.deconv3d_train(xr, wr, plain=plain, mesh=mesh) if deconv
         else C.conv3d_train(xr, wr, stride, plain=plain, mesh=mesh))
    g = (torch.randn(y.shape, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda") * 0.5).to(dtype)
    y.backward(g)
    return y.detach(), xr.grad, wr.grad

  kernels.reset_launches()
  y, dx, dw = run(False)
  torch.cuda.synchronize()
  want = ({"conv3d_s1_bn_act": 2} if stride == 1
          else {"conv3d_s2_bn_act": 1, "deconv3d_bn_act": 1})
  assert dict(kernels.LAUNCHES) == want
  assert dict(kernels.HALO_LAUNCHES) == want
  rows = x_shape[2] * (2 if deconv else 1) // (2 if stride == 2 else 1)
  assert y.dtype == dtype and y.shape[2] == rows and dx.shape == x.shape
  want_y, want_dx, want_dw = run(True)
  _close(y, want_y, dtype)
  _close(dx, want_dx, dtype)
  _close(dw, want_dw, dtype)
