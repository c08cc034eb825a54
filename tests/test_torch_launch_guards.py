"""The port's launch discipline, on the CPU with the CUDA runtime mocked:

1. Precision: the eval forward and the training step run their library
   convs (``F.conv2d``/``F.conv3d``, forward and backward) with cuDNN's
   TF32 off, scoped to the call, whatever the caller set.
2. Device guard: every kernel wrapper calls its C entry with the input's
   device as the current CUDA device and that device's stream, and counts
   the launch only after a launch that returned 0; the sphere conv's
   grad-input refuses a g it cannot copy 16 bytes at a time before that.
3. Refusal: the Cout-1 head kernel's wrapper refuses a Cin whose shared
   memory (``conv3d_s1.cu:head_smem``) exceeds the card's 227 KB, before
   any launch; the tensor-core deconv's wrapper refuses what its 16-byte
   copies and its K-major weight cannot take, and raises, uncounted, when
   its C entry refuses a launch.
4. Flags: the halo forms and the regression's row window reach their C
   entries and count apart; the stride-1 conv hands its C entry the box
   flag (``ops/conv3d.py:box_eligible``) and counts box launches apart.
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from mode_tpu_torch import kernels, training
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.ops import conv2d as C2
from mode_tpu_torch.ops import conv3d as C
from mode_tpu_torch.ops import regression as R
from mode_tpu_torch.ops import sphere_conv as S
from mode_tpu_torch.utils import profiling

torch.set_num_threads(2)


# --- 1. precision -----------------------------------------------------------

@pytest.fixture
def conv_flags(monkeypatch):
  """Records cuDNN's TF32 flag in every F.conv2d / F.conv3d call and in its
  backward; the caller's setting is TF32 on."""
  seen = []

  class Probe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
      return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
      seen.append(("backward", torch.backends.cudnn.allow_tf32))
      return g

  def probed(orig):
    def conv(*args, **kw):
      seen.append(("forward", torch.backends.cudnn.allow_tf32))
      return Probe.apply(orig(*args, **kw))
    return conv

  monkeypatch.setattr(F, "conv2d", probed(F.conv2d))
  monkeypatch.setattr(F, "conv3d", probed(F.conv3d))
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
  return seen


def _pair(batch=1):
  gen = torch.Generator().manual_seed(0)
  left = torch.randn((batch, 64, 32, 3), generator=gen)
  return left, torch.roll(left, 2, dims=2)


def test_eval_forward_runs_its_convs_without_tf32(conv_flags):
  model = ModeDisparity(16, device="cpu")
  pred = model(*_pair())
  assert pred.shape == (1, 64, 32)
  assert conv_flags and all(not flag for _, flag in conv_flags)
  assert torch.backends.cudnn.allow_tf32           # restored


def test_train_step_runs_its_convs_without_tf32(conv_flags):
  model = ModeDisparity(16, device="cpu")
  step = training.make_disparity_train_step(
      model, training.make_optimizer(model.parameters()))
  left, right = _pair(2)
  loss = step(left, right, torch.full((2, 64, 32), 3.0))
  assert torch.isfinite(loss)
  kinds = {kind for kind, _ in conv_flags}
  assert kinds == {"forward", "backward"}
  assert all(not flag for _, flag in conv_flags)
  assert torch.backends.cudnn.allow_tf32           # restored


# --- 2. device guard --------------------------------------------------------

class _Guard:
  """Stands in for the CUDA runtime: ``torch.cuda.device(d)`` makes ``d``
  current while its block runs; ``current_stream(d)`` is d's stream."""

  def __init__(self):
    self.current = None
    self.calls = []
    self.entry_args = []

  @contextlib.contextmanager
  def device(self, d):
    before, self.current = self.current, torch.device(d)
    try:
      yield
    finally:
      self.current = before

  def current_stream(self, d):
    return type("Stream", (), {"cuda_stream": 1000 + (torch.device(d).index
                                                       or 0)})()

  def entry(self, name, err=0):
    def fn(*args):
      self.calls.append((name, self.current, args[-1]))
      self.entry_args.append(args)
      return err
    return fn


class _Lib:
  def __init__(self, guard, *names, err=0):
    for name in names:
      setattr(self, name, guard.entry(name, err))


@pytest.fixture
def guard(monkeypatch):
  g = _Guard()
  monkeypatch.setattr(torch.cuda, "device", g.device)
  monkeypatch.setattr(torch.cuda, "current_stream", g.current_stream)
  monkeypatch.setattr(C, "_conv3d_s1_lib",
                      lambda: _Lib(g, "conv3d_s1_bn_act"))
  monkeypatch.setattr(C, "_conv3d_s2_lib",
                      lambda: _Lib(g, "conv3d_s2_bn_act"))
  monkeypatch.setattr(C, "_deconv3d_lib", lambda: _Lib(g, "deconv3d_bn_act"))
  monkeypatch.setattr(C2, "_conv2d_lib", lambda: _Lib(g, "conv2d_s1_bn_act"))
  monkeypatch.setattr(R, "_regression_lib",
                      lambda: _Lib(g, "fused_disparity_regression"))
  monkeypatch.setattr(S, "_sphere_lib",
                      lambda: _Lib(g, *S.FORWARD.values()))
  monkeypatch.setattr(S, "_bwd_lib", lambda: _Lib(
      g, *S.BWD_INPUT.values(), *S.BWD_WEIGHT.values()))
  monkeypatch.setattr(S, "_weight_splits", lambda *a: (1, 64 * 32))
  kernels.reset_launches()
  return g


def _launches(guard):
  """Each wrapper's launch of its kernel, on CPU tensors."""
  one = torch.ones(16)
  x3 = torch.randn((1, 2, 4, 4, 16))
  w3 = torch.randn((16, 16, 3, 3, 3))
  x2 = torch.randn((1, 64, 32, 16))
  w2 = torch.randn((16, 16, 3, 3))
  return {
      "conv3d_s1_bn_act": lambda: C._launch(C._S1, x3, w3, one, 0 * one,
                                            None, True),
      "conv3d_s2_bn_act": lambda: C._launch(C._S2, x3, w3, one, 0 * one,
                                            None, False),
      "deconv3d_bn_act": lambda: C._launch(C._DECONV, x3, w3, one, 0 * one,
                                           None, False),
      "conv2d_s1_bn_act": lambda: C2._launch(x2, w2, one, 0 * one, None,
                                             True, 1),
      "fused_disparity_regression": lambda: R._launch(
          torch.randn((1, 4, 8, 4)), 16, 32, 16),
      "sphere_conv_bn_act": lambda: S._launch(x2, w2, one, 0 * one, None,
                                              True, "Cassini"),
      "sphere_conv_erp_bn_act": lambda: S._launch(
          x2.transpose(1, 2).contiguous(), w2, one, 0 * one, None, False,
          "ERP"),
      "sphere_conv_bwd_input": lambda: S._launch_bwd_input(x2, w2,
                                                           "Cassini"),
      "sphere_conv_erp_bwd_input": lambda: S._launch_bwd_input(
          x2.transpose(1, 2).contiguous(), w2, "ERP"),
      "sphere_conv_bwd_weight": lambda: S._launch_bwd_weight(x2, x2,
                                                             "Cassini"),
  }


@pytest.mark.parametrize("name", [
    "conv3d_s1_bn_act", "conv3d_s2_bn_act", "deconv3d_bn_act",
    "conv2d_s1_bn_act", "fused_disparity_regression", "sphere_conv_bn_act",
    "sphere_conv_erp_bn_act", "sphere_conv_bwd_input",
    "sphere_conv_erp_bwd_input", "sphere_conv_bwd_weight"])
def test_every_launch_runs_under_its_device_guard(guard, name):
  """The C entry runs with the input's device made current and gets that
  device's stream (the mock names each device's stream by its index); the
  guard is left after it, and the launch is counted once."""
  _launches(guard)[name]()
  assert guard.calls == [(name, torch.device("cpu"), 1000)]
  assert guard.current is None
  assert dict(kernels.LAUNCHES) == {name: 1}


def test_a_failed_launch_raises_and_is_not_counted(guard, monkeypatch):
  monkeypatch.setattr(C, "_conv3d_s2_lib",
                      lambda: _Lib(guard, "conv3d_s2_bn_act", err=700))
  with pytest.raises(RuntimeError, match="CUDA error 700"):
    _launches(guard)["conv3d_s2_bn_act"]()
  assert not kernels.LAUNCHES


@pytest.mark.parametrize("sphere_type,hw", [("Cassini", (64, 32)),
                                           ("ERP", (32, 64))])
def test_dx_wrapper_refuses_a_cout_off_its_copies(guard, sphere_type, hw):
  """The tensor-core dx kernel copies g 16 bytes at a time: its wrapper
  refuses Cout 12 and a g off 16 bytes with a ValueError naming the
  kernel, before any launch; Cout 8 launches once, under the device
  guard."""
  name = S.BWD_INPUT[sphere_type]
  w = torch.randn((12, 16, 3, 3))
  with pytest.raises(ValueError, match=f"{name}: Cout must be a multiple"):
    S._launch_bwd_input(torch.randn((1, *hw, 12)), w, sphere_type)
  g = torch.randn(1 * hw[0] * hw[1] * 8 + 1)[1:].view(1, *hw, 8)
  with pytest.raises(ValueError, match=f"{name}: .*aligned"):
    S._launch_bwd_input(g, w[:8], sphere_type)
  assert not guard.calls and not kernels.LAUNCHES
  dx = S._launch_bwd_input(g.clone(), w[:8], sphere_type)
  assert dx.shape == (1, *hw, 16)
  assert guard.calls == [(name, torch.device("cpu"), 1000)]
  assert dict(kernels.LAUNCHES) == {name: 1}


@pytest.mark.parametrize("sphere_type,hw", [("Cassini", (64, 32)),
                                           ("ERP", (32, 64))])
def test_dw_wrapper_refuses_what_its_copies_cannot_take(guard, sphere_type,
                                                        hw):
  """The tensor-core dw kernel copies x and g 16 bytes at a time: its
  wrapper refuses Cin 12, Cout 12 and an x off 16 bytes with a ValueError
  naming the kernel, before any launch; Cin and Cout 8 launch once, under
  the device guard."""
  name = S.BWD_WEIGHT[sphere_type]
  x8, x12 = torch.randn((1, *hw, 8)), torch.randn((1, *hw, 12))
  for x, g in ((x12, x8), (x8, x12)):
    with pytest.raises(ValueError, match=f"{name}: Cin and Cout must be"):
      S._launch_bwd_weight(x, g, sphere_type)
  off = torch.randn(x8.numel() + 1)[1:].view(x8.shape)
  with pytest.raises(ValueError, match=f"{name}: .*aligned"):
    S._launch_bwd_weight(off, x8, sphere_type)
  assert not guard.calls and not kernels.LAUNCHES
  assert S._launch_bwd_weight(x8, x8, sphere_type).shape == (9, 8, 8)
  assert guard.calls == [(name, torch.device("cpu"), 1000)]
  assert dict(kernels.LAUNCHES) == {name: 1}


@pytest.mark.parametrize("err", [0, 1, 701])
def test_regression_wrapper_refuses_levels_past_shared_memory(guard,
                                                              monkeypatch,
                                                              err):
  """The regression kernel stages d levels of a block's source columns in
  shared memory; its C entry, not the wrapper, refuses a shape past 48 KB
  with cudaErrorInvalidValue (1; a card test takes that branch). The
  wrapper calls the entry once and counts the launch where it returned 0;
  on 1, or a failed launch (701), it raises naming the kernel and counts
  nothing."""
  monkeypatch.setattr(R, "_regression_lib",
                      lambda: _Lib(guard, "fused_disparity_regression",
                                   err=err))
  cost = torch.randn((1, 96, 2, 128))
  if err == 0:
    pred, _ = R._launch(cost, 192, 8, 128)
    assert pred.shape == (1, 8, 128)
    assert dict(kernels.LAUNCHES) == {"fused_disparity_regression": 1}
  else:
    with pytest.raises(RuntimeError, match="fused_disparity_regression: "
                       f".*CUDA error {err}"):
      R._launch(cost, 192, 8, 128)
    assert not kernels.LAUNCHES
  assert [c[0] for c in guard.calls] == ["fused_disparity_regression"]


# --- 3. the head kernel's shared memory ---------------------------------------

@pytest.mark.parametrize("dtype,cin,fits", [
    (torch.float32, 72, True), (torch.float32, 80, False),
    (torch.bfloat16, 144, True), (torch.bfloat16, 152, False)])
def test_head_kernel_refuses_a_cin_past_shared_memory(guard, dtype, cin,
                                                      fits):
  """f32 Cin >= 80 and bf16 Cin >= 152 need more than 227 KB: refused with
  a ValueError, the library never called; the Cin below each is launched."""
  assert (C.head_smem(cin, dtype.itemsize) <= C.SMEM_MAX) == fits
  x = torch.randn((1, 2, 3, 4, cin)).to(dtype)
  w = torch.randn((1, cin, 3, 3, 3)).to(dtype)
  one = torch.ones(1)

  def run():
    return C._launch(C._S1, x, C.pack_weight_tc(w), one, 0 * one, None,
                     False)

  if fits:
    assert run().shape == (1, 2, 3, 4, 1)
    assert [c[0] for c in guard.calls] == ["conv3d_s1_bn_act"]
  else:
    with pytest.raises(ValueError, match="Cout-1 head kernel"):
      run()
    assert not guard.calls


# --- 4. the tensor-core deconv --------------------------------------------------

def test_deconv_wrapper_refuses_what_its_copies_cannot_take(guard):
  """The deconv copies x 16 bytes at a time and reads the K-major TcWeight
  of the transpose conv's (I, O, k) weight: its wrapper refuses Cin 12,
  an x off 16 bytes, a pack of another Cin and a pack made as a conv's
  (whose plain version would read the tensor the other way round), each
  with a ValueError naming the kernel, before any launch; Cin 16 launches
  once, under the device guard."""
  name = "deconv3d_bn_act"
  one = torch.ones(8)

  def run(x, w):
    return C._launch(C._DECONV, x, w, one, 0 * one, None, False)

  with pytest.raises(ValueError, match=f"{name}: Cin must be a multiple"):
    run(torch.randn((1, 2, 3, 4, 12)), torch.randn((12, 8, 3, 3, 3)))
  w = torch.randn((16, 8, 3, 3, 3))
  x = torch.randn(2 * 3 * 4 * 16 + 1)[1:].view(1, 2, 3, 4, 16)
  with pytest.raises(ValueError, match=f"{name}: .*aligned"):
    run(x, w)
  x = x.clone()
  with pytest.raises(ValueError, match=f"{name}: weight"):
    run(x, C.pack_weight_tc(torch.randn((24, 8, 3, 3, 3)), transpose=True))
  with pytest.raises(ValueError, match=f"{name}: weight"):
    run(x, C.pack_weight_tc(w.transpose(0, 1).contiguous(), 2))
  assert not guard.calls and not kernels.LAUNCHES
  assert run(x, C.pack_weight_tc(w, transpose=True)).shape == (1, 4, 6, 8, 8)
  assert guard.calls == [(name, torch.device("cpu"), 1000)]
  assert dict(kernels.LAUNCHES) == {name: 1}


def test_deconv_entry_refusal_raises_and_is_not_counted(guard, monkeypatch):
  """The C entry returns cudaErrorInvalidValue (1) without launching on a
  Cin that is not a multiple of 8 (a card test calls it directly); the
  wrapper raises on that return and counts nothing."""
  monkeypatch.setattr(C, "_deconv3d_lib",
                      lambda: _Lib(guard, "deconv3d_bn_act", err=1))
  with pytest.raises(RuntimeError, match="deconv3d_bn_act: .*CUDA error 1"):
    _launches(guard)["deconv3d_bn_act"]()
  assert not kernels.LAUNCHES


# --- 5. the halo forms and the row window -------------------------------------

@pytest.mark.parametrize("name,mode,x_shape,out_shape", [
    ("conv3d_s1_bn_act", C._S1, (1, 2, 6, 4, 16), (1, 2, 4, 4, 16)),
    ("conv3d_s2_bn_act", C._S2, (1, 2, 6, 4, 16), (1, 1, 2, 2, 16)),
    ("deconv3d_bn_act", C._DECONV, (1, 2, 6, 4, 16), (1, 4, 8, 8, 16))])
def test_halo_launches_pass_the_flag_and_count_apart(guard, name, mode,
                                                     x_shape, out_shape):
  """``h_halo`` reaches the C entry as its last int beside x's own extents,
  the output has the halo form's rows, and the launch counts under its
  kernel's key and again as haloed; a call without it counts once."""
  one = torch.ones(16)
  x, w = torch.randn(x_shape), torch.randn((16, 16, 3, 3, 3))
  for halo in (True, False):
    out = C._launch(mode, x, w, one, 0 * one, None, False, halo)
    assert guard.calls[-1][0] == name
    args = guard.entry_args[-1]
    if mode == C._S1:      # the stride-1 entry's last int: the box flag
      assert args[-2] == 0
      args = args[:-1]
    assert args[-9:-1] == (*x_shape[:4], 16, 16, 0, int(halo))
    if halo:
      assert tuple(out.shape) == out_shape
  assert dict(kernels.LAUNCHES) == {name: 2}
  assert dict(kernels.HALO_LAUNCHES) == {name: 1}


@pytest.mark.parametrize("dtype,cin,cout,halo,box", [
    (torch.bfloat16, 32, 32, False, True),
    (torch.bfloat16, 64, 32, False, True),
    (torch.bfloat16, 32, 64, False, True),
    (torch.bfloat16, 64, 64, False, True),
    (torch.bfloat16, 32, 32, True, False),     # the halo form
    (torch.float32, 32, 32, False, False),     # f32: 3xTF32 on conv_body
    (torch.bfloat16, 32, 8, False, False),     # Cout 8: conv_body
    (torch.bfloat16, 32, 1, False, False),     # Cout 1: the head kernel
    (torch.bfloat16, 16, 32, False, False)])   # Cin 16: conv_body
def test_box_launches_pass_the_flag_and_count_apart(guard, dtype, cin, cout,
                                                    halo, box):
  """The stride-1 wrapper hands ``box_eligible``'s answer to its C entry
  as the last int before the stream, and counts a box launch in
  ``BOX_LAUNCHES`` and, while the tracer is on, as the counter
  ``conv3d_s1.box`` of the innermost open span; every other call counts
  in neither."""
  x = torch.randn((1, 2, 6, 4, cin)).to(dtype)
  w = torch.randn((cout, cin, 3, 3, 3)).to(dtype)
  one = torch.ones(cout)
  profiling.reset()
  with profiling.tracing():
    with profiling.span("stage1.aggregation"):
      C._launch(C._S1, x, w, one, 0 * one, None, True, halo)
  counters = profiling.summary()["counters"]
  profiling.reset()
  assert guard.calls[-1][0] == "conv3d_s1_bn_act"
  assert guard.entry_args[-1][-2] == int(box)
  assert dict(kernels.LAUNCHES) == {"conv3d_s1_bn_act": 1}
  assert dict(kernels.HALO_LAUNCHES) == ({"conv3d_s1_bn_act": 1} if halo
                                         else {})
  assert dict(kernels.BOX_LAUNCHES) == ({"conv3d_s1_bn_act": 1} if box
                                        else {})
  assert counters == ([{"name": "conv3d_s1.box",
                        "span": "stage1.aggregation", "n": 1}] if box
                      else [])


def test_conv2d_halo_launch_passes_the_flag_and_counts_apart(guard):
  """The 2-D kernel's ``h_halo`` reaches its C entry as the last int after
  x's own extents, the dilation and the ReLU; the output has two rows
  fewer than x, and the launch counts again as haloed."""
  one = torch.ones(16)
  x, w = torch.randn((1, 6, 4, 16)), torch.randn((16, 16, 3, 3))
  for halo in (True, False):
    out = C2._launch(x, w, one, 0 * one, None, True, 1, halo)
    assert guard.entry_args[-1][-9:-1] == (1, 6, 4, 16, 16, 1, 1, int(halo))
    assert tuple(out.shape) == (1, 4 if halo else 6, 4, 16)
  assert dict(kernels.LAUNCHES) == {"conv2d_s1_bn_act": 2}
  assert dict(kernels.HALO_LAUNCHES) == {"conv2d_s1_bn_act": 1}


def test_regression_window_reaches_the_entry(guard):
  """``row0`` and ``h_out`` are the C entry's last two ints; the output
  has ``h_out`` rows, and a window short of the whole output counts as
  haloed."""
  cost = torch.randn((1, 4, 8, 4))
  pred, _ = R._launch(cost, 16, 32, 16, 8, 16)
  assert pred.shape == (1, 16, 16)
  assert guard.entry_args[-1][-3:-1] == (8, 16)
  assert dict(kernels.HALO_LAUNCHES) == {"fused_disparity_regression": 1}
