"""Numpy models of the tensor-core conv kernels (``igemm_tc.cuh``, used by
``conv3d_s1.cu``, ``conv3d_s2.cu`` and ``conv2d.cu``; ``sphere_conv.cu``)
and of the K-major weight packing, on the CPU: no card runs here, so the
arithmetic and the address walk of the kernels are held here and the
kernels themselves on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

1. The f32 arithmetic: TF32 rounding (``cvt.rna.tf32.f32``) and the 3xTF32
   split, summed in the kernel's K order (per stage of 32 channels, K steps
   of 8, each step small*B_big, big*B_small, big*B_big into a stage fragment
   added to the f32 sum), holds a conv at the main path's K (27 x 64, 9 x
   128) within chip_smoke.py's f32 bar; one TF32 pass misses it.
2. The operand walk: which voxel and tap each thread's 16-byte copies read
   (at stride 1 and 2), the zero-fill predicate, the swizzled address each
   chunk lands at and the address wgmma's descriptor (or the f32 A
   fragment) reads back, and the accumulator fragment's rows and columns in
   the epilogue rebuild the plain conv exactly at ragged shapes; at an H
   origin of one row (the HALO instantiations) each spatial shard's haloed
   rows rebuild its rows of the conv of the whole volume.
3. The sphere conv's walk: each row's four corner copies from the shift
   tables (zero-filled at the seam, on the drop lane, past Cin and past M),
   its corner weights copied beside them, each thread's blend of its
   fragment rows from the four swizzled tiles (f32, and bf16 rounded as the
   kernel rounds it) and the epilogue's scatter in the Cassini and ERP
   output orders rebuild the port's plain ``sphere_conv``, with tiles that
   end at a band edge and tiles that span two bands.
4. The box walk of the bf16 stride-1 conv (``conv3d_box.cuh``): the
   producer's box and weight copies, each tap's window read in place
   through a descriptor without swizzle, the persistent blocks' tiles and
   the epilogue rebuild the conv exactly; its shared memory, descriptor
   fields and barrier hand-over; and which launches of the benchmark's
   cells take it (``ops/conv3d.py:box_eligible``).
"""

import re

import numpy as np
import pytest
import torch

from mode_tpu_torch.kernels.build import CSRC_DIR
from mode_tpu_torch.ops import conv2d as C2
from mode_tpu_torch.ops import conv3d as C
from mode_tpu_torch.ops import kmajor
from mode_tpu_torch.ops import sphere_conv as S
from mode_tpu_torch.ops.kmajor import tf32_round

# chip_smoke.py's elementwise f32 bar: |got - want| <= ATOL + RTOL * |want|
ATOL, RTOL = 1e-4, 1e-4
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2      # its bf16 bar
BK = 32          # input channels per K stage
SMS = 132        # streaming multiprocessors of an H100 SXM


def _tf32(a):
  """``cvt.rna.tf32.f32``: the magnitude rounded to 10 mantissa bits, ties
  away from zero."""
  a = np.asarray(a, np.float32)
  mag = np.abs(a).view(np.uint32)
  rounded = ((mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000))
  return np.copysign(rounded.view(np.float32), a)


def _tf32_channel_order(cin):
  """The input channel at each K position of the f32 pack
  (``ops/kmajor.py:pack``): per stage of 32, position q + 4 j holds
  channel 8 q + j; padding past Cin."""
  within = [8 * (p % 4) + p // 4 for p in range(BK)]
  return np.array([s * BK + c for s in range(-(-cin // BK)) for c in within])


def _im2col(x, taps, stride=1):
  """Rows of the implicit GEMM's A, K in the kernel's (tap, channel) order:
  ``x`` (N, D, H, W, C) zero-padded, taps as (od, oh, ow) offsets from the
  input voxel (stride z, stride y, stride x) of output voxel (z, y, x)."""
  n, d, h, w, c = x.shape
  do, ho, wo = (-(-e // stride) for e in (d, h, w))
  p = max(max(abs(o) for o in t) for t in taps)
  xp = np.pad(x, ((0, 0), (p, p + stride), (p, p + stride),
                  (p, p + stride), (0, 0)))
  cols = [xp[:, p + od:p + od + stride * do:stride,
             p + oh:p + oh + stride * ho:stride,
             p + ow:p + ow + stride * wo:stride]
          for od, oh, ow in taps]
  return np.concatenate(cols, axis=-1).reshape(n * do * ho * wo,
                                                len(taps) * c)


def _taps(kd, dil):
  return [((jd - 1) * dil if kd == 3 else 0, (jh - 1) * dil, (jw - 1) * dil)
          for jd in range(kd) for jh in range(3) for jw in range(3)]


def _sum_3xtf32(a, b, terms):
  """The kernel's f32 sum of A (M, K) times B (K, N): per stage of BK
  channels a fresh fragment takes, per K step of 8, each term's products in
  order (``terms``: pairs of (A part, B part)); the FP32 pipes add it to
  the sum."""
  m, k = a.shape
  acc = np.zeros((m, b.shape[1]), np.float32)
  for s0 in range(0, k, BK):
    part = np.zeros_like(acc)
    for k0 in range(s0, s0 + BK, 8):
      for ta, tb in terms:
        for kk in range(k0, k0 + 8):
          part = (part + np.outer(ta[:, kk], tb[kk]).astype(np.float32)
                  ).astype(np.float32)
    acc = (acc + part).astype(np.float32)
  return acc


def test_tf32_round_matches_cvt_rna():
  rng = np.random.default_rng(0)
  vals = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
          ).astype(np.float32)
  # ties: the dropped 13 bits exactly half an ulp of the kept ones
  ties = ((vals.view(np.uint32) & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
          ).view(np.float32)
  for v in (vals, ties, -ties):
    want = _tf32(v)
    got = tf32_round(torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not (want.view(np.uint32) & np.uint32(0x1FFF)).any()
  # a tie rounds away from zero
  assert _tf32(np.float32(1 + 2.0 ** -11)) == np.float32(1 + 2.0 ** -10)


@pytest.mark.parametrize("kd,cin,cout", [(3, 64, 32), (1, 128, 64)])
def test_3xtf32_holds_the_f32_bar_where_one_pass_does_not(kd, cin, cout):
  """At K = 27 x 64 (the 3-D dres0 conv) and 9 x 128 (a 2-D FE conv), with
  chip_smoke.py's inputs (x * 0.5, He-scaled weights): the 3xTF32 sum is
  within the f32 bar of the f64 conv with a wide margin; one TF32 pass is
  not, which is why the kernel splits both operands."""
  rng = np.random.default_rng(1)
  shape = (1, 2, 4, 4, cin) if kd == 3 else (1, 1, 6, 8, cin)
  x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
  taps = _taps(kd, 1)
  w = (rng.standard_normal((len(taps) * cin, cout))
       * np.sqrt(2.0 / (len(taps) * cout))).astype(np.float32)
  a = _im2col(x, taps)
  exact = a.astype(np.float64) @ w.astype(np.float64)
  a_big, w_big = _tf32(a), _tf32(w)
  a_small, w_small = _tf32(a - a_big), _tf32(w - w_big)
  three = _sum_3xtf32(a, w, [(a_small, w_big), (a_big, w_small),
                             (a_big, w_big)])
  one = _sum_3xtf32(a, w, [(a_big, w_big)])
  bar = ATOL + RTOL * np.abs(exact)
  assert (np.abs(three - exact) / bar).max() < 0.05
  assert (np.abs(one - exact) / bar).max() > 2


# --- the operand walk -------------------------------------------------------
# Per input type: element bytes, stage row bytes (the swizzle width: 128
# bytes XORs the chunk with r & 7, 64 bytes with (r >> 1) & 3), weight parts.
CFG = {"f32": dict(esize=4, rb=128, parts=2),
       "bf16": dict(esize=2, rb=64, parts=1)}


def _swizzle(r, c, rb):
  """``igemm_tc.cuh:swizzle``: the byte offset of 16-byte chunk c of row r."""
  return r * rb + ((c ^ (r & 7 if rb == 128 else (r >> 1) & 3)) << 4)


def _desc_read(base, r, kbyte, rb):
  """The byte that wgmma reads for row r, byte kbyte of its K-major row,
  through a descriptor at ``base`` (1024-aligned, SBO = 8 rows): the
  linear address with the swizzle applied to its bits."""
  lin = base + (r // 8) * (8 * rb) + (r % 8) * rb + kbyte
  mask = 7 if rb == 128 else 3
  return lin ^ (((lin >> 7) & mask) << 4)


def _tile(mtot, cout):
  """``igemm_tc.cuh:dispatch``: (BM, BN) of a call."""
  tall = (mtot + 127) // 128 >= 2 * SMS
  bn = 128 if cout > 64 else 64 if cout > 32 else 32
  return (128 if tall else 64), bn


def test_descriptor_reads_back_what_the_copies_wrote():
  """Every (row, byte) of a K-major tile: the descriptor's swizzled read
  lands on the chunk the writer put there (128- and 64-byte swizzle)."""
  for rb in (128, 64):
    for base in (0, 1024, 5 * 1024):
      for r in range(128):
        for kbyte in range(rb):
          want = base + _swizzle(r, kbyte // 16, rb) + kbyte % 16
          assert _desc_read(base, r, kbyte, rb) == want


def _phase_taps(p):
  """igemm_tc.cuh:phase_taps: the taps of output parity phase p = 4 pd +
  2 ph + pw of the transposed conv."""
  return (1 + (p >> 2)) * (1 + (p >> 1 & 1)) * (1 + (p & 1))


def _deconv_tap(t):
  """igemm_tc.cuh:deconv_tap, the integer arithmetic of the kernel: tap t
  of the deconv's walk (phases in order, each phase's taps in (jd, jh, jw)
  order) as a byte: bits 0-4 the weight tap (kd * 3 + kh) * 3 + kw, bits
  5, 6, 7 the input offsets ow, oh, od."""
  starts = [sum(_phase_taps(q) for q in range(p)) for p in range(8)]
  p, start = 0, 0
  for q in range(1, 8):
    if t >= starts[q]:
      p, start = q, starts[q]
  pd, ph, pw = p >> 2, p >> 1 & 1, p & 1
  j = t - start
  jw = j & 1 if pw else 0
  j >>= pw
  jh = j & 1 if ph else 0
  jd = j >> ph if pd else 0
  wtap = (((2 * jd if pd else 1) * 3 + (2 * jh if ph else 1)) * 3
          + (2 * jw if pw else 1))
  return (wtap | (1 - jw if pw else 0) << 5 | (1 - jh if ph else 0) << 6
          | (1 - jd if pd else 0) << 7)


# igemm_tc.cuh:deconv_word(0..3), the 27 bytes eight to a 64-bit word, and
# phase_ends(), bit t set where tap t ends its phase
DECONV_WORDS = [sum(_deconv_tap(t) << (8 * (t - 8 * w))
                    for t in range(8 * w, min(8 * w + 8, 27)))
                for w in range(4)]
PHASE_ENDS = sum(1 << (sum(_phase_taps(q) for q in range(p + 1)) - 1)
                 for p in range(8))


def _deconv_tap_at(t):
  """igemm_tc.cuh:deconv_tap_at: (od, oh, ow), weight tap of tap t, read
  from the words as the kernel reads them."""
  w = DECONV_WORDS[0 if t < 8 else 1 if t < 16 else 2 if t < 24 else 3]
  b = (w >> (8 * (t & 7))) & 0xFF
  return (b >> 7, b >> 6 & 1, b >> 5 & 1), b & 31


def _walk_conv(x, wk, kd, dil, dtype, bm, bn, stride=1, deconv=False,
               h0=0):
  """The kernel's walk over one call, in f64: the copies of each stage
  into shared memory, the reads of A (f32: each thread's tf32 fragment;
  bf16: the descriptor) and B (the descriptor), the products, and the
  epilogue's scatter of the accumulator fragments. x (N, D, H, W, Cin),
  wk the K-major weight (taps, Cout, Cin), which the f32 kernel gets padded
  and permuted as the host packs it; the output extents are the input's
  over ``stride``, rounded up. With ``deconv`` the walk of the transposed
  conv (S = DECONV): M the input grid, the taps of ``_deconv_tap``, and
  after each phase's last stage the epilogue into that phase's output
  voxels, returned as (N * 2D * 2H * 2W, Cout) rows. ``h0`` is the H
  origin (``tc::Shape``'s): 1 for a haloed x, whose H then has two rows
  more than the output grid (the M grid, for the deconv) takes."""
  cfg = CFG[dtype]
  esize, rb = cfg["esize"], cfg["rb"]
  ch, cpr = 16 // esize, rb // 16          # channels per chunk, chunks/row
  nt = 2 * bm
  n, d, h, w, cin = x.shape
  do, ho, wo = ((d, h - 2 * h0, w) if deconv else
                (-(-e // stride) for e in (d, h - 2 * h0, w)))
  cout = wk.shape[1]
  mtot = n * do * ho * wo
  if deconv:
    walk = [_deconv_tap_at(t) for t in range(27)]
    taps = [off for off, _ in walk]
    ckc = ctap = cphase = 0       # the kernel's stage counters
  else:
    taps = _taps(kd, dil)
  nkc = -(-cin // BK)
  a_bytes, b_bytes = bm * rb, bn * rb
  assert (a_bytes + cfg["parts"] * b_bytes) % 1024 == 0 and b_bytes % 1024 == 0
  wcin = cin
  if dtype == "f32":
    order = _tf32_channel_order(cin)
    wcin = len(order)
    wk = np.pad(wk, ((0, 0), (0, 0), (0, wcin - cin)))[..., order]
  xf, wf = x.reshape(-1), wk.reshape(-1)
  out = np.full((8 * mtot if deconv else mtot, cout), np.nan)

  def scatter(acc, m0, n0, out_row):
    # the epilogue: fragment element 4j + 2hh + e of (wg, warp, lane)
    for wg in range(bm // 64):
      for warp in range(4):
        for lane in range(32):
          er = m0 + wg * 64 + warp * 16 + lane // 4
          for j in range(bn // 8):
            for hh in range(2):
              for e in range(2):
                r = wg * 64 + warp * 16 + lane // 4 + 8 * hh
                co = n0 + 8 * j + 2 * (lane % 4) + e
                if m0 + r < mtot and co < cout:
                  o = out_row(er, m0 + r)
                  assert o % cout == 0 and np.isnan(out[o // cout, co])
                  out[o // cout, co] = acc[r, co - n0]

  def deconv_row(phase):
    # the kernel's eo of the thread's rows er and er + 8, plus the phase's
    # voxel offset, in elements
    pd, ph, pw = phase >> 2, phase >> 1 & 1, phase & 1
    po = ((pd * 2 * ho + ph) * 2 * wo + pw) * cout

    def eo(m):
      q = m // wo
      bz = q // ho
      return ((2 * bz * 2 * ho + 2 * (q - bz * ho)) * 2 * wo
              + 2 * (m - q * wo)) * cout
    return lambda er, m: (eo(er) if m == er else eo(er + 8)) + po

  for m0 in range(0, mtot, bm):
    for n0 in range(0, cout, bn):
      acc = np.zeros((bm, bn))
      for step in range(len(taps) * nkc):
        tap, kc = divmod(step, nkc)
        od, oh, ow = taps[tap]
        wtap = walk[tap][1] if deconv else tap
        smem = np.full((a_bytes + b_bytes) // esize, np.nan)
        # A: thread tid copies chunk tid % cpr of rows tid // cpr + i nt/cpr
        for tid in range(nt):
          ac = tid % cpr
          for i in range(bm * cpr // nt):
            r = tid // cpr + i * (nt // cpr)
            m = m0 + r
            c0 = kc * BK + ac * ch
            bb, rem = divmod(m, do * ho * wo)
            z, rem = divmod(rem, ho * wo)
            y, xx = divmod(rem, wo)
            if stride == 2:
              # the input voxel the centre tap reads
              z, y, xx = 2 * z, 2 * y + h0, 2 * xx
              base = ((bb * d + z) * h + y) * w + xx
            else:
              # the grid's index plus the halo rows of the planes up to it
              base = m + (2 * (bb * do + z) + 1) * h0 * w
              y += h0
            ok = (m < mtot and c0 < cin and 0 <= z + od < d
                  and 0 <= y + oh < h and 0 <= xx + ow < w)
            src = ((base + (od * h + oh) * w + ow) * cin + c0) if ok else None
            dst = _swizzle(r, ac, rb) // esize
            smem[dst:dst + ch] = xf[src:src + ch] if ok else 0.0
        # B: row n (output channel n0 + n), chunk c of the tap's channels
        for idx in range(bn * cpr):
          nn, c = divmod(idx, cpr)
          co, c0 = n0 + nn, kc * BK + c * ch
          ok = co < cout and c0 < wcin
          src = (wtap * cout + co) * wcin + c0
          dst = (a_bytes + _swizzle(nn, c, rb)) // esize
          smem[dst:dst + ch] = wf[src:src + ch] if ok else 0.0
        # B through the descriptor, every (n, k) of the stage
        kb = np.arange(BK) * esize
        b_tile = np.stack([smem[[_desc_read(a_bytes, nn, int(k), rb) // esize
                                 for k in kb]] for nn in range(bn)])
        a_tile = np.full((bm, BK), np.nan)
        for wg in range(bm // 64):
          if dtype == "f32":
            # each thread's m64k8 tf32 fragment of K step kk: K positions
            # 8 kk + q (+ 4) are channels 8 q + 2 kk (+ 1) of the stage
            seen = np.zeros((64, BK), int)
            for warp in range(4):
              for lane in range(32):
                r0, q = wg * 64 + warp * 16 + lane // 4, lane % 4
                for kk in range(BK // 8):
                  for e in range(4):
                    r, k = r0 + (e & 1) * 8, kk * 8 + q + (e >> 1) * 4
                    j = 2 * kk + (e >> 1)
                    off = _swizzle(r, 2 * q + j // 4, rb) + (j % 4) * 4
                    a_tile[r, k] = smem[off // esize]
                    seen[r - wg * 64, k] += 1
            assert (seen == 1).all()
          else:
            for r in range(64):
              a_tile[wg * 64 + r] = [
                  smem[_desc_read(wg * 64 * rb, r, int(k), rb) // esize]
                  for k in kb]
        assert not np.isnan(a_tile).any() and not np.isnan(b_tile).any()
        acc += a_tile @ b_tile.T
        if deconv:
          ckc += 1
          if ckc == nkc:
            ckc = 0
            if PHASE_ENDS >> ctap & 1:
              scatter(acc, m0, n0, deconv_row(cphase))
              acc = np.zeros((bm, bn))
              cphase += 1
            ctap += 1
      if deconv:
        assert (ckc, ctap, cphase) == (0, 27, 8)
        ckc = ctap = cphase = 0
      else:
        scatter(acc, m0, n0, lambda er, m: m * cout)
  return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("x_shape,cout,kd,dil,bm", [
    ((1, 2, 3, 5, 16), 40, 3, 1, 64),     # Cin < a stage, Cout off the tile
    ((2, 1, 2, 5, 40), 24, 3, 1, 128),    # D = 1, H = 2; Cin 32 + 8
    ((1, 1, 5, 7, 24), 72, 1, 2, 64),     # 2-D, dilation 2, N tile 128
    ((2, 1, 3, 2, 8), 8, 1, 1, 64),       # 2-D, W = 2, Cout 8
    ((1, 1, 1, 9, 32), 33, 1, 2, 128),    # 2-D, H = 1, BM 128 over 9 rows
])
def test_operand_walk_rebuilds_the_conv(x_shape, cout, kd, dil, bm, dtype):
  """Integer-valued inputs, so the walk must rebuild the f64 conv exactly:
  any wrong voxel, tap, zero-fill, swizzle or fragment index shows."""
  rng = np.random.default_rng(2)
  cin = x_shape[-1]
  taps = _taps(kd, dil)
  x = rng.integers(-4, 5, x_shape).astype(np.float64)
  wk = rng.integers(-4, 5, (len(taps), cout, cin)).astype(np.float64)
  mtot = int(np.prod(x_shape[:4]))
  bn = _tile(mtot, cout)[1]
  got = _walk_conv(x, wk, kd, dil, dtype, bm, bn)
  want = _im2col(x, taps) @ wk.transpose(0, 2, 1).reshape(-1, cout)
  assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("x_shape,cout,bm", [
    ((1, 5, 7, 9, 16), 24, 64),     # odd extents, Cin < a stage
    ((2, 4, 3, 6, 40), 72, 128),    # even and odd, Cin 32 + 8, N tile 128
    ((1, 2, 6, 5, 32), 64, 64),     # D = 2: one output plane
    ((1, 1, 1, 7, 8), 8, 64),       # D = H = 1
])
def test_stride2_walk_rebuilds_the_conv(x_shape, cout, bm, dtype):
  """The stride-2 walk (conv3d_s2.cu: conv_body at S = 2): output voxel
  (z, y, x) copies input voxel (2z + kd - 1, 2y + kh - 1, 2x + kw - 1),
  zero outside the input volume, at ragged and odd extents; exact on
  integer-valued inputs."""
  rng = np.random.default_rng(5)
  cin = x_shape[-1]
  taps = _taps(3, 1)
  x = rng.integers(-4, 5, x_shape).astype(np.float64)
  wk = rng.integers(-4, 5, (27, cout, cin)).astype(np.float64)
  bn = _tile(1, cout)[1]
  got = _walk_conv(x, wk, 3, 1, dtype, bm, bn, stride=2)
  want = _im2col(x, taps, 2) @ wk.transpose(0, 2, 1).reshape(-1, cout)
  assert np.array_equal(got, want)
  # and the plain stride-2 conv of the port agrees with the im2col
  plain = C.conv3d_s2_bn_act(torch.from_numpy(x).float(), torch.from_numpy(
      wk.reshape(3, 3, 3, cout, cin).transpose(3, 4, 0, 1, 2).copy()).float())
  assert np.allclose(plain.reshape(-1, cout).numpy(), want, atol=1e-3)


def _haloed(x, r0, r1):
  """Rows [r0, r1) of x's H with a halo row either side, zeros past the
  ends, as ``parallel/shard_ops.py:halo_concat`` hands them over."""
  return np.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0), (0, 0)))[:, :, r0:r1 + 2]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode,x_shape,cout,bm,split", [
    ("s1", (1, 2, 8, 5, 16), 24, 64, 2),     # Cin < a stage
    ("s1", (2, 1, 6, 3, 40), 72, 128, 3),    # Cin 32 + 8, N tile 128
    ("s2", (1, 3, 8, 5, 16), 24, 64, 2),     # odd D and W
    ("s2", (2, 2, 12, 4, 40), 8, 128, 3),    # two rows a shard
    ("deconv", (1, 2, 6, 5, 16), 24, 64, 3),
    ("deconv", (2, 1, 4, 3, 40), 72, 128, 2),
    ("2d", (1, 1, 8, 5, 16), 24, 64, 2),     # conv2d.cu: D = 1, kd = 1
    ("2d", (2, 1, 6, 3, 40), 72, 128, 3),    # batch 2, Cin 32 + 8
])
def test_halo_walk_rebuilds_the_rows_of_the_conv(mode, x_shape, cout, bm,
                                                 split, dtype):
  """The walk at H origin 1 (conv3d_s1.cu, conv3d_s2.cu, conv3d.cu and
  conv2d.cu with h_halo): each shard of a ``split``-way split of H, with
  its halo rows, rebuilds its rows of the conv of the whole volume (or
  map) exactly on integer-valued inputs: at stride 1 and for the deconv's
  M grid the shard's rows, at stride 2 half of them; every output written
  once."""
  rng = np.random.default_rng(7)
  cin = x_shape[-1]
  x = rng.integers(-4, 5, x_shape).astype(np.float64)
  bn = _tile(1, cout)[1]
  if mode == "deconv":
    wt = rng.integers(-4, 5, (cin, cout, 3, 3, 3)).astype(np.float64)
    wk = wt.transpose(2, 3, 4, 1, 0).reshape(27, cout, cin)
    whole = _deconv_im2col(x, wt)
  else:
    stride = 2 if mode == "s2" else 1
    kd = 1 if mode == "2d" else 3
    wk = rng.integers(-4, 5, (3 * kd * 3, cout, cin)).astype(np.float64)
    whole = _im2col(x, _taps(kd, 1), stride) @ wk.transpose(0, 2, 1).reshape(
        -1, cout)
  n, d, h, w = x_shape[:4]
  out_h = {"s1": h, "2d": h, "s2": h // 2, "deconv": 2 * h}[mode]
  out_d, out_w = {"s1": (d, w), "2d": (d, w), "s2": (-(-d // 2), -(-w // 2)),
                  "deconv": (2 * d, 2 * w)}[mode]
  whole = whole.reshape(n, out_d, out_h, out_w, cout)
  rows, per = h // split, out_h // split
  for s in range(split):
    got = _walk_conv(_haloed(x, s * rows, (s + 1) * rows), wk,
                     1 if mode == "2d" else 3, 1, dtype,
                     bm, bn, stride=2 if mode == "s2" else 1,
                     deconv=mode == "deconv", h0=1)
    want = whole[:, :, s * per:(s + 1) * per].reshape(-1, cout)
    assert not np.isnan(got).any()
    assert np.array_equal(got, want)


def test_deconv_taps_cover_the_kernel_once():
  """The 27 taps of the deconv's walk: phase p's (1 + pd)(1 + ph)(1 + pw)
  in a row, ending at taps 0, 2, 4, 8, 10, 14, 18, 26; every weight tap
  once; each tap's input offset and kernel index satisfy o = 2 i - 1 + k
  for the phase's output o = 2 z + parity, input i = z + offset; and the
  packed words are those the kernel's constexpr functions give (evaluated
  by a C++17 compiler from igemm_tc.cuh)."""
  walk = [_deconv_tap_at(t) for t in range(27)]
  assert sorted(wt for _, wt in walk) == list(range(27))
  ends = [t for t in range(27) if PHASE_ENDS >> t & 1]
  assert ends == [0, 2, 4, 8, 10, 14, 18, 26]
  starts = [0] + [e + 1 for e in ends[:-1]]
  for p in range(8):
    assert ends[p] - starts[p] + 1 == _phase_taps(p)
    for t in range(starts[p], ends[p] + 1):
      off, wtap = walk[t]
      ks = (wtap // 9, wtap // 3 % 3, wtap % 3)
      for parity, o, k in zip((p >> 2, p >> 1 & 1, p & 1), off, ks):
        assert o <= parity                  # offset +1 only on odd axes
        z = 5
        assert 2 * z + parity == 2 * (z + o) - 1 + k
  assert DECONV_WORDS[0] == 0x2F4B69104A0E2C0D
  assert DECONV_WORDS[3] == 0x1A3854


def _deconv_im2col(x, wt):
  """The transposed conv k3 s2 p1 op1 as a stride-1 conv: x (N, D, H, W,
  Cin) stuffed with zeros to (N, 2D, 2H, 2W, Cin), its im2col at the 27
  taps (offsets kd' - 1, ...) times the flipped torch (I, O, k) weight."""
  n, d, h, w, cin = x.shape
  u = np.zeros((n, 2 * d, 2 * h, 2 * w, cin))
  u[:, ::2, ::2, ::2] = x
  wf = wt[:, :, ::-1, ::-1, ::-1].transpose(2, 3, 4, 0, 1)
  return _im2col(u, _taps(3, 1)) @ wf.reshape(27 * cin, -1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("x_shape,cout,bm", [
    ((1, 3, 5, 7, 16), 24, 64),     # odd extents, Cin < a stage
    ((2, 1, 3, 2, 40), 72, 128),    # D = 1; Cin 32 + 8, N tile 128
    ((1, 2, 1, 5, 8), 8, 64),       # H = 1, Cout 8
    ((1, 2, 4, 9, 32), 24, 128),    # BM 128 over 72 rows: a ragged M tile
])
def test_deconv_walk_rebuilds_the_transpose_conv(x_shape, cout, bm, dtype):
  """conv3d.cu's walk (conv_body at S = DECONV): each phase's taps at input
  offsets 0 or +1, zero-filled past the far edge and past Cin, the
  swizzled copies and fragment reads as for the convs, and after each
  phase's last stage the epilogue's out_row (the thread's two rows' base
  voxel plus the phase's offset) rebuild the transposed conv exactly on
  integer-valued inputs: every output voxel written once."""
  rng = np.random.default_rng(6)
  cin = x_shape[-1]
  x = rng.integers(-4, 5, x_shape).astype(np.float64)
  wt = rng.integers(-4, 5, (cin, cout, 3, 3, 3)).astype(np.float64)
  packed = C.pack_weight_tc(torch.from_numpy(wt), transpose=True)
  assert packed.transposed and packed.parts.shape[1:3] == (27, cout)
  wk = wt.transpose(2, 3, 4, 1, 0).reshape(27, cout, cin)
  bn = _tile(1, cout)[1]
  got = _walk_conv(x, wk, 3, 1, dtype, bm, bn, deconv=True)
  want = _deconv_im2col(x, wt)
  assert not np.isnan(got).any()
  assert np.array_equal(got, want)
  # and the port's plain deconv agrees with the im2col
  plain = C.deconv3d_bn_act(torch.from_numpy(x).float(),
                            torch.from_numpy(wt).float())
  assert np.allclose(plain.reshape(-1, cout).numpy(), want, atol=1e-3)


def test_tile_choice():
  """BM = 64 where 128-row tiles would not give every SM two (the 1/16
  level, M = 24,576 at batch 1); BN follows Cout."""
  assert _tile(48 * 256 * 128, 32) == (128, 32)
  assert _tile(12 * 64 * 32, 64) == (64, 64)
  assert _tile(2 * 256 * 128, 128) == (128, 128)
  assert _tile(100, 130) == (64, 128)


def test_head_plane_walk_rebuilds_the_conv():
  """The Cout-1 head kernel's walk along D: input plane p (zero outside
  the volume) adds its kd = 2, 1, 0 taps to output planes p - 1, p, p + 1,
  and output plane p - 1 is complete and stored after plane p, over a
  block's planes [z0, z1)."""
  _head_plane_walk(0)


def test_head_plane_walk_rebuilds_a_shards_rows():
  """The same walk at H origin 1: x is a shard's rows with their halo
  rows, and the output is that shard's rows of the whole conv."""
  _head_plane_walk(1)


def _head_plane_walk(h0):
  """The head kernel's walk, a plane's rows those of ``load_plane``:
  output row y reads x's row y - 1 + h0 + kh of hi = h + 2 h0 (zero
  outside x)."""
  rng = np.random.default_rng(3)
  d, h, w, cin, hz = 5, 3, 4, 8, 2
  whole_x = rng.integers(-4, 5, (1, d, 3 * h, w, cin)).astype(np.float64)
  x = _haloed(whole_x, h, 2 * h) if h0 else whole_x[:, :, :h]
  wt = rng.integers(-4, 5, (27, cin)).astype(np.float64)
  hi = h + 2 * h0
  rows = np.arange(-1 + h0, h + 1 + h0)        # the rows a plane stages
  inside = (rows >= 0) & (rows < hi)
  xp = np.zeros((d, h + 2, w + 2, cin))
  xp[:, inside, 1:-1] = x[0][:, rows[inside]]
  out = np.full((d, h, w), np.nan)
  for z0 in range(0, d, hz):
    z1 = min(z0 + hz, d)
    acc = [np.zeros((h, w)) for _ in range(3)]
    for p in range(z0 - 1, z1 + 1):
      plane = xp[p] if 0 <= p < d else np.zeros_like(xp[0])
      for kd in range(3):
        for t9 in range(9):
          kh, kw = divmod(t9, 3)
          acc[2 - kd] += plane[kh:kh + h, kw:kw + w] @ wt[kd * 9 + t9]
      if p - 1 >= z0:
        out[p - 1] = acc[0]
      acc = [acc[1], acc[2], np.zeros((h, w))]
  if h0:
    want = (_im2col(whole_x, _taps(3, 1)) @ wt.reshape(-1)).reshape(
        d, 3 * h, w)[:, h:2 * h]
  else:
    want = (_im2col(x, _taps(3, 1)) @ wt.reshape(-1)).reshape(d, h, w)
  assert np.array_equal(out, want)


# --- the box walk (conv3d_box.cuh) ------------------------------------------
# The box kernel's geometry: an output box of TZ x 8 x 16 voxels (D, H, W)
# times 32 output channels, two consumer warpgroups, m64 tiles of 8 rows of
# H x 8 voxels of W, the input box 16 bytes a voxel in four 8-channel planes.
BOX_TY, BOX_TX, BOX_BN, BOX_NWG = 8, 16, 32, 2
BOX_PY, BOX_PX = BOX_TY + 2, BOX_TX + 2
BOX_TZ = {32: 4, 64: 2}   # conv3d_s1.cu's depth by Cin


def _box_plane(tz):
  """``Box<TZ>::PLANE``: one 8-channel plane of the input box in bytes,
  16 bytes a voxel, rounded up to the 128 bytes a bulk copy's destination
  is aligned to."""
  nvox = (tz + 2) * BOX_PY * BOX_PX
  return -(-nvox * 16 // 128) * 128


def _box_smem(tz, nkc):
  """``smem_bytes<TZ>(nkc)``: alignment slack, the resident weight (27 x
  nkc tiles of 32 rows x 64 bytes), two input boxes."""
  return 1024 + 27 * nkc * BOX_BN * 64 + 2 * 4 * _box_plane(tz)


def _box_grid(shape, cout, tz, sms=SMS):
  """``tcbox::launch``'s grid: (blocks a column slice, column slices) and
  the tile count."""
  n, d, h, w = shape[:4]
  ntiles = n * -(-d // tz) * -(-h // BOX_TY) * -(-w // BOX_TX)
  nblk = cout // BOX_BN
  return min(ntiles, max(1, sms // nblk)), nblk, ntiles


def _box_origin(t, shape, tz):
  """``Walk::origin``: the output box of tile t, W fastest, then H, D,
  batch."""
  n, d, h, w = shape[:4]
  nz, ny, nx = -(-d // tz), -(-h // BOX_TY), -(-w // BOX_TX)
  x0 = t % nx * BOX_TX
  t //= nx
  y0 = t % ny * BOX_TY
  t //= ny
  return t // nz, t % nz * tz, y0, x0


def _interleave_read(start, r, k, lbo, sbo):
  """The byte wgmma reads for row r, K index k (bf16) of an A operand
  through a K-major descriptor without swizzle at ``start``: core matrices
  of 8 rows x 16 bytes, the next 8 rows SBO bytes on, the next 8 K values
  LBO bytes on."""
  return start + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2


def _walk_box(x, wk, tz, sms=SMS):
  """The box kernel's walk over one call, in f64 (bf16 values are exact in
  it): the copies of the weight and each step's four TMA boxes of the
  input box (8 channels x PX x PY x TZ + 2 voxels from (z0 - 1, y0 - 1,
  x0 - 1), zero outside the volume) into shared memory, each consumer
  warpgroup's A windows through the INTERLEAVE descriptor and B through the
  64-byte-swizzled one, the products over the whole K, and the epilogue's
  scatter of each tile's fragments. x (N, D, H, W, Cin), Cin 32 or 64; wk
  the K-major weight (27, Cout, Cin), Cout 32 or 64."""
  n, d, h, w, cin = x.shape
  cout = wk.shape[1]
  nkc = cin // BK
  plane = _box_plane(tz)
  nvox = (tz + 2) * BOX_PY * BOX_PX
  w_tile = BOX_BN * 64
  wbytes = 27 * nkc * w_tile
  gx, nblk, ntiles = _box_grid(x.shape, cout, tz, sms)
  xf, wf = x.reshape(-1), wk.reshape(-1)
  out = np.full((n, d, h, w, cout), np.nan)
  zw, xh_n = tz // BOX_NWG, BOX_TX // 8
  # every voxel of the box and the input voxel it holds
  v = np.arange(nvox)
  bz, r = divmod(v, BOX_PY * BOX_PX)
  by, bx = divmod(r, BOX_PX)
  covered = np.zeros(ntiles * nblk, int)
  for blk_y in range(nblk):
    n0 = blk_y * BOX_BN
    for blk_x in range(gx):
      smem = np.full((wbytes + 2 * 4 * plane) // 2, np.nan)
      # the weight, once a block: tile (tap, kc) row nn, chunk c
      for i in range(27 * nkc * BOX_BN * 4):
        c, nn, tk = i & 3, i // 4 % BOX_BN, i // (4 * BOX_BN)
        tap, kc = divmod(tk, nkc)
        src = (tap * cout + n0 + nn) * cin + kc * BK + c * 8
        dst = (tk * w_tile + _swizzle(nn, c, 64)) // 2
        smem[dst:dst + 8] = wf[src:src + 8]
      b_tiles = {}
      kb = np.arange(BK) * 2
      for tk in range(27 * nkc):
        b_tiles[tk] = np.stack([smem[[_desc_read(tk * w_tile, nn, int(k), 64)
                                      // 2 for k in kb]]
                                for nn in range(BOX_BN)])
      mine = (ntiles - 1 - blk_x) // gx + 1 if blk_x < ntiles else 0
      acc = np.zeros((BOX_NWG, zw * xh_n, 64, BOX_BN))
      for j in range(mine * nkc):
        t, kc = blk_x + j // nkc * gx, j % nkc
        buf = j & 1
        b, z0, y0, x0 = _box_origin(t, x.shape, tz)
        # the TMA boxes: plane c holds voxel v's channels 8 c ... 8 c + 7
        base = wbytes + buf * 4 * plane
        z, y, xx = z0 - 1 + bz, y0 - 1 + by, x0 - 1 + bx
        ok = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (xx >= 0) & (xx < w)
        for c in range(4):
          vals = np.zeros((nvox, 8))
          src = (((b * d + z[ok]) * h + y[ok]) * w + xx[ok]) * cin + kc * BK
          vals[ok] = xf[src[:, None] + c * 8 + np.arange(8)]
          dst = (base + c * plane + v * 16) // 2
          smem[dst[:, None] + np.arange(8)] = vals
        # each warpgroup's tiles: 27 taps x 2 k16 steps
        for wg in range(BOX_NWG):
          start0 = base + wg * zw * BOX_PY * BOX_PX * 16
          for ti in range(zw * xh_n):
            for tap in range(27):
              kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
              vo = ((ti // xh_n + kd) * BOX_PY + kh) * BOX_PX + (
                  ti % xh_n) * 8 + kw
              for kk in range(2):
                start = start0 + vo * 16 + kk * 2 * plane
                rr, k = np.meshgrid(np.arange(64), np.arange(16),
                                    indexing="ij")
                a = smem[_interleave_read(start, rr, k, plane,
                                          BOX_PX * 16) // 2]
                bt = b_tiles[tap * nkc + kc][:, 16 * kk:16 * kk + 16]
                assert not np.isnan(a).any() and not np.isnan(bt).any()
                acc[wg, ti] += a @ bt.T
        if kc != nkc - 1:
          continue
        covered[blk_y * ntiles + t] += 1
        # the epilogue: fragment element 4 jn + 2 hh + e of (warp, lane)
        for wg in range(BOX_NWG):
          for ti in range(zw * xh_n):
            zo = z0 + wg * zw + ti // xh_n
            for warp in range(4):
              for lane in range(32):
                xo = x0 + ti % xh_n * 8 + lane // 4
                for hh in range(2):
                  yo = y0 + 2 * warp + hh
                  if zo >= d or yo >= h or xo >= w:
                    continue
                  rrow = 16 * warp + lane // 4 + 8 * hh
                  for jn in range(BOX_BN // 8):
                    for e in range(2):
                      col = 8 * jn + 2 * (lane % 4) + e
                      assert np.isnan(out[b, zo, yo, xo, n0 + col])
                      out[b, zo, yo, xo, n0 + col] = acc[wg, ti, rrow, col]
        acc[:] = 0
  assert (covered == 1).all()
  return out


@pytest.mark.parametrize("tz", [2, 4])
@pytest.mark.parametrize("x_shape,cout,sms", [
    ((1, 2, 8, 16, 32), 32, 1),      # one box, exactly
    ((1, 3, 9, 17, 32), 32, 3),      # ragged D, H and W: boxes past each edge
    ((2, 2, 5, 8, 64), 32, 2),       # W under TX, Cin 64, batch 2
    ((1, 2, 8, 12, 32), 64, 4),      # Cout 64: two column slices
    ((6, 1, 3, 5, 32), 32, 5),       # batch 6, D 1, H and W under the box
])
def test_box_walk_rebuilds_the_conv(x_shape, cout, sms, tz):
  """The box kernel's walk (conv3d_box.cuh): box origins and halo offsets,
  each tap's shifted window read in place through the INTERLEAVE
  descriptor, the zero fill past every edge, the A rows (8 rows of H x 8
  voxels of W), the resident weight tiles, the persistent blocks' tiles
  and the epilogue's fragment rows rebuild the f64 conv exactly on
  integer-valued inputs; every output written once, every tile of every
  column slice walked once."""
  rng = np.random.default_rng(11)
  cin = x_shape[-1]
  x = rng.integers(-4, 5, x_shape).astype(np.float64)
  wk = rng.integers(-4, 5, (27, cout, cin)).astype(np.float64)
  got = _walk_box(x, wk, tz, sms)
  want = (_im2col(x, _taps(3, 1)) @ wk.transpose(0, 2, 1).reshape(-1, cout)
          ).reshape(*x_shape[:4], cout)
  assert np.array_equal(got, want)


@pytest.mark.parametrize("batch", [1, 16])
def test_box_walk_covers_3d60s_smallest_level(batch):
  """3D60's 1/16 level, 12 x 32 x 16 voxels (W one box wide), at batch 1
  and at the training's batch 16 over two blocks: each output voxel of
  every batch index gets its own conv."""
  rng = np.random.default_rng(12)
  x = rng.integers(-2, 3, (batch, 12, 32, 16, 32)).astype(np.float64)
  if batch > 1:
    x = x[:, :2, :8]        # the walk's cost in Python: two planes, a box
  wk = rng.integers(-2, 3, (27, 32, 32)).astype(np.float64)
  got = _walk_box(x, wk, BOX_TZ[32], 2)
  want = (_im2col(x, _taps(3, 1)) @ wk.transpose(0, 2, 1).reshape(-1, 32)
          ).reshape(*x.shape[:4], 32)
  assert np.array_equal(got, want)


def test_box_kernel_constants_match_the_model():
  """The model's geometry is the source's: conv3d_box.cuh's tile, warp
  groups and column width, conv3d_s1.cu's box depth."""
  src = (CSRC_DIR / "conv3d_box.cuh").read_text()
  assert re.search(r"constexpr int TY = (\d+), TX = (\d+);", src).groups() \
      == (str(BOX_TY), str(BOX_TX))
  assert re.search(r"constexpr int BN = (\d+);", src)[1] == str(BOX_BN)
  assert re.search(r"constexpr int NWG = (\d+);", src)[1] == str(BOX_NWG)
  s1 = (CSRC_DIR / "conv3d_s1.cu").read_text()
  assert re.search(r"constexpr int BOX_TZ_CIN32 = (\d+), BOX_TZ_CIN64 = "
                   r"(\d+);", s1).groups() == tuple(
                       str(BOX_TZ[cin]) for cin in (32, 64))


@pytest.mark.parametrize("tz", [2, 4])
def test_box_shared_memory_and_descriptor_fields(tz):
  """The box kernel's shared memory fits the card at Cin 32 and 64 at depth
  2 (``max_nkc``: 2), at depth 4 at Cin 32 only; a plane holds whole
  voxels and starts 128-byte aligned, as a bulk tensor copy's destination
  must; each TMA box's bytes (the mbarrier's expected count) fill its
  plane's voxels; LBO (a plane) and every descriptor address fit their
  14-bit fields."""
  plane = _box_plane(tz)
  nvox = (tz + 2) * BOX_PY * BOX_PX
  assert plane % 128 == 0 and nvox * 16 <= plane < nvox * 16 + 128
  assert 8 * BOX_PX * BOX_PY * (tz + 2) * 2 == nvox * 16
  assert plane // 16 < 2 ** 14
  fits = {nkc: _box_smem(tz, nkc) <= C.SMEM_MAX for nkc in (1, 2)}
  assert fits == ({1: True, 2: True} if tz == 2 else {1: True, 2: False})
  assert _box_smem(tz, 2 if tz == 2 else 1) < 2 ** 18


def test_box_barriers_balance():
  """The producer/consumer hand-over (conv3d_box.cuh): over any count of
  steps, each named barrier's arrivals and waits pair up generation by
  generation (the producer waits EMPTY of step j - 2 before refilling a
  buffer, and the last two at the end), so no barrier is left half used."""
  for nsteps in range(0, 9):
    producer = {"FULL": [0, 0], "EMPTY": [0, 0]}
    consumer = {"FULL": [0, 0], "EMPTY": [0, 0]}
    for j in range(nsteps):
      if j >= 2:
        producer["EMPTY"][j & 1] += 1
      producer["FULL"][j & 1] += 1
    for j in range(max(nsteps - 2, 0), nsteps):
      producer["EMPTY"][j & 1] += 1
    for j in range(nsteps):
      consumer["FULL"][j & 1] += 1
      consumer["EMPTY"][j & 1] += 1
    assert producer == consumer


# The K1 launches of the benchmark's three cells: (x shape, Cout), bf16.
# The frame (stage 1 at batch 6, 1024x512): dres0's 64->32 and 32->32,
# dres1's two, the classifiers' 32->32 at 1/4; each hourglass's conv2 at
# 1/8 and conv4 at 1/16; the three Cout-1 heads.
FRAME_K1 = ([((6, 48, 256, 128, 64), 32)] + [((6, 48, 256, 128, 32), 32)] * 6
            + [((6, 24, 128, 64, 64), 64)] * 3 + [((6, 12, 64, 32, 64), 64)] * 3
            + [((6, 48, 256, 128, 32), 1)] * 3)
# 3D60 training (batch 16, 512x256): the forward at 1/4 and the stride-1
# grad-inputs with flipped, io-swapped weights (dres0's first: 32 -> 64);
# the 1/8 and 1/16 shapes the trainer's eval forward runs.
TRAIN_3D60_K1 = [((16, 48, 128, 64, 64), 32), ((16, 48, 128, 64, 32), 32),
                 ((16, 48, 128, 64, 32), 64), ((16, 24, 64, 32, 64), 64),
                 ((16, 12, 32, 16, 64), 64), ((16, 48, 128, 64, 32), 1)]


@pytest.mark.parametrize("cell", ["frame", "train_3d60"])
def test_box_path_takes_every_bf16_k1_launch_of_the_cells(cell):
  """``ops/conv3d.py:box_eligible`` at every K1 shape of the cells: each
  bf16 launch with Cout 32 or 64 takes the box kernel, the Cout-1 heads
  stay on the head kernel; the same shapes in f32, and under a spatial
  halo, stay on conv_body; the fusion cell runs no K1."""
  shapes = FRAME_K1 if cell == "frame" else TRAIN_3D60_K1
  for x_shape, cout in shapes:
    cin = x_shape[-1]
    assert C.box_eligible(torch.bfloat16, cin, cout) == (cout != 1)
    assert not C.box_eligible(torch.float32, cin, cout)
    assert not C.box_eligible(torch.bfloat16, cin, cout, h_halo=True)
  if cell == "frame":
    # 7 launches at 1/4 a stage-1 call, 13 in all
    assert sum(C.box_eligible(torch.bfloat16, s[-1], c) for s, c in shapes
               if s[1] == 48) == 7
    assert sum(C.box_eligible(torch.bfloat16, s[-1], c)
               for s, c in shapes) == 13


@pytest.mark.parametrize("cin,cout,want", [
    (32, 32, True), (64, 32, True), (32, 64, True), (64, 64, True),
    (16, 32, False), (96, 32, False), (128, 64, False), (32, 8, False),
    (32, 1, False), (64, 128, False), (40, 32, False)])
def test_box_eligibility_by_width(cin, cout, want):
  """Cin and Cout 32 or 64 (the weight slice and two boxes fit shared
  memory; Cout 64 as two 32-wide column slices); other widths stay on
  conv_body (Cout 2-31, past 64, Cin off 32 and 64) or the head kernel."""
  assert C.box_eligible(torch.bfloat16, cin, cout) == want
  assert not C.box_eligible(torch.float32, cin, cout)


@pytest.mark.parametrize("two_d", [False, True])
def test_kmajor_split_packing(two_d):
  """pack_weight_tc: the K-major layout of pack_weight's (taps, Cin, Cout),
  in f32 padded to whole stages, permuted and split into tf32 parts whose
  sum is the weight to f32 rounding; bf16 and the 3-D Cout-1 head's weight
  whole."""
  gen = torch.Generator().manual_seed(4)
  for cout in (1, 40):
    shape = (cout, 24, 3, 3) if two_d else (cout, 24, 3, 3, 3)
    w = torch.randn(shape, generator=gen)
    mod = C2 if two_d else C
    packed = mod.pack_weight_tc(w)
    ref = mod.pack_weight(w).transpose(1, 2)          # (taps, Cout, Cin)
    assert packed.weight is not w and torch.equal(packed.weight, w)
    if cout == 1 and not two_d:
      assert packed.parts.shape == (1, *ref.shape)
      assert torch.equal(packed.parts[0], ref)
    else:
      # Cin 24 padded to one stage of 32, in the fragment's channel order
      order = torch.from_numpy(_tf32_channel_order(24))
      assert sorted(order.tolist()) == list(range(32))
      assert order[:8].tolist() == [0, 8, 16, 24, 1, 9, 17, 25]
      refp = torch.nn.functional.pad(ref, (0, 8))[..., order]
      big, small = packed.parts
      assert torch.equal(big, tf32_round(refp))
      assert torch.equal(small, tf32_round(refp - big))
      rel = (big + small - refp).abs() / refp.abs().clamp_min(1e-30)
      assert float(rel.max()) < 2 ** -21
    bf = mod.pack_weight_tc(w.bfloat16())
    assert bf.parts.shape == (1, *ref.shape)
    assert torch.equal(bf.parts[0], ref.bfloat16())


def test_deconv_kmajor_packing():
  """pack_weight_tc(transpose=True): the deconv's torch (I, O, 3, 3, 3)
  weight as K-major (27, O, I), tap (kd * 3 + kh) * 3 + kw, in f32 padded,
  permuted and split as the convs' (always split: no Cout-1 head kernel
  here), bf16 whole; the TcWeight keeps the torch weight and is marked
  transposed, and kmajor.operands takes it for an x of Cin = I only."""
  gen = torch.Generator().manual_seed(9)
  cin, cout = 24, 1
  w = torch.randn((cin, cout, 3, 3, 3), generator=gen)
  packed = C.pack_weight_tc(w, transpose=True)
  ref = w.permute(2, 3, 4, 1, 0).reshape(27, cout, cin)
  assert torch.equal(ref[9 * 2 + 3 * 0 + 1], w[:, :, 2, 0, 1].T)
  assert torch.equal(ref, C.pack_weight(w, transpose=True).transpose(1, 2))
  assert packed.transposed and torch.equal(packed.weight, w)
  assert packed.cout == cout
  order = torch.from_numpy(_tf32_channel_order(cin))
  refp = torch.nn.functional.pad(ref, (0, 32 - cin))[..., order]
  big, small = packed.parts
  assert torch.equal(big, tf32_round(refp))
  assert torch.equal(small, tf32_round(refp - big))
  bf = C.pack_weight_tc(w.bfloat16(), transpose=True)
  assert bf.parts.shape == (1, 27, cout, cin)
  assert torch.equal(bf.parts[0], ref.bfloat16())
  x = torch.randn((1, 2, 2, 2, cin), generator=gen)
  wbig, wsmall = kmajor.operands("deconv3d_bn_act", x, packed, 27, True,
                                 transposed=True)
  assert (wbig, wsmall) == (big.data_ptr(), small.data_ptr())
  # the same tensor packed as a conv's (Cout = I, Cin = O) is refused
  with pytest.raises(ValueError, match="deconv3d_bn_act: weight"):
    kmajor.operands("deconv3d_bn_act", x, C.pack_weight_tc(w, 2), 27, True,
                    transposed=True)
  with pytest.raises(ValueError, match="conv3d_s2_bn_act: weight"):
    kmajor.operands("conv3d_s2_bn_act", x, packed, 27, True)


# --- the sphere conv (sphere_conv.cu) ----------------------------------------
SMEM_MAX = 232448     # shared memory a block can take (227 KB)


def _bf16(a):
  """f32 values rounded to bf16 (to nearest even), as __floats2bfloat162_rn."""
  u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
  u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
  return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _sphere_stage(dtype, bm, bn):
  """(stage bytes, stages in flight) of sphere_conv.cu: four corner tiles,
  the weight parts and a float4 of corner weights per row."""
  cfg = CFG[dtype]
  stage = 4 * bm * cfg["rb"] + cfg["parts"] * bn * cfg["rb"] + bm * 16
  return stage, min(4, (SMEM_MAX - 1024) // stage)


def _sphere_tile(mtot, cout):
  """sphere_conv.cu:launch: BN 128 past Cout 64, else 64; BM 128 where
  that still gives every SM a block."""
  return (128 if (mtot + 127) // 128 >= SMS else 64), (128 if cout > 64
                                                         else 64)


def _shift_tables(h, w, sphere_type):
  """The int4 (sigma, b0, b1, drop) and float4 tables by (band, tap), as
  ops/sphere_conv.py:_device_tables packs them."""
  sigma, pairint, quad, drop = S.shift_tables(h, w, sphere_type)
  itab = np.stack([sigma, pairint[..., 0].astype(np.int32),
                   pairint[..., 1].astype(np.int32), drop], axis=-1)
  return itab.astype(np.int64), quad.astype(np.float64)


def _walk_sphere(x, wk, sphere_type, dtype, bm, bn):
  """sphere_conv.cu's walk over one call, vectorised over the threads of a
  block: per stage (tap, 32 channels) each thread's corner copies of its
  rows into four swizzled tiles (zero-filled at the seam, on the drop lane,
  past Cin and past M) and, for the thread with chunk 0, the row's corner
  weights; each thread's blend of its fragment rows from the tiles; B
  through the descriptor; the epilogue's scatter in the layout's output
  order. x (N, H, W, Cin) f64, wk (9, Cout, Cin); returns (N, H, W, Cout)
  and whether any read met a byte no copy wrote."""
  cfg = CFG[dtype]
  esize, rb = cfg["esize"], cfg["rb"]
  ch, cpr, nt = 16 // esize, rb // 16, 2 * bm
  n, h, w, cin = x.shape
  cout = wk.shape[1]
  erp = sphere_type == "ERP"
  nband, nlane = (h, w) if erp else (w, h)
  band_step, lane_step = (w, 1) if erp else (1, w)
  itab, ftab = _shift_tables(h, w, sphere_type)
  mtot, nkc = n * h * w, -(-cin // BK)
  wcin = cin
  if dtype == "f32":
    order = _tf32_channel_order(cin)
    wcin = len(order)
    wk = np.pad(wk, ((0, 0), (0, 0), (0, wcin - cin)))[..., order]
  xf, wf = x.reshape(-1), wk.reshape(-1)
  a_bytes, b_bytes = bm * rb, bn * rb
  assert a_bytes % 1024 == 0 and b_bytes % 1024 == 0
  out = np.full((mtot, cout), np.nan)
  stale = False
  tid = np.arange(nt)
  ac = tid % cpr
  lanes = np.arange(ch)
  for m0 in range(0, mtot, bm):
    for n0 in range(0, cout, bn):
      acc = np.zeros((bm, bn))
      for step in range(9 * nkc):
        tap, kc = divmod(step, nkc)
        smem = np.full((4 * a_bytes + b_bytes) // esize, np.nan)
        qs = np.full((bm, 4), np.nan)
        chn = kc * BK + ac * ch
        for i in range(bm * cpr // nt):
          r = tid // cpr + i * (nt // cpr)
          m = m0 + r
          rv = m < mtot
          t = np.where(rv, m, 0)
          rl, t = t % nlane, t // nlane
          band, img = t % nband, t // nband * h * w
          it = itab[band, tap]
          sl = rl + it[:, 0]
          sl = np.where(sl >= nlane, sl - nlane, sl)
          ok = rv & (chn < cin) & (rl != it[:, 3])
          okn = ok & (sl != nlane - 1)
          p = img + sl * lane_step
          p0 = (p + it[:, 1] * band_step) * cin + chn
          p1 = (p + it[:, 2] * band_step) * cin + chn
          nx = lane_step * cin
          dst = _swizzle(r, ac, rb) // esize
          for corner, (src, good) in enumerate(
              ((p0, ok), (p0 + nx, okn), (p1, ok), (p1 + nx, okn))):
            idx = np.where(good, src, 0)[:, None] + lanes
            vals = np.where(good[:, None], xf[np.minimum(idx, xf.size - 1)],
                            0.0)
            smem[corner * a_bytes // esize + dst[:, None] + lanes] = vals
          first = ac == 0
          qs[r[first]] = np.where(rv[first, None], ftab[band[first], tap],
                                  0.0)
        # B: row nn (output channel n0 + nn), chunk c of the tap's channels
        nn, c = np.divmod(np.arange(bn * cpr), cpr)
        co, cb = n0 + nn, kc * BK + c * ch
        okb = (co < cout) & (cb < wcin)
        src = ((tap * cout + co) * wcin + cb)[:, None] + lanes
        bdst = (4 * a_bytes + _swizzle(nn, c, rb))[:, None] // esize
        smem[bdst + lanes] = np.where(okb[:, None],
                                      wf[np.where(okb[:, None], src, 0)], 0)
        kb = np.arange(BK) * esize
        b_tile = smem[_desc_read(4 * a_bytes, np.arange(bn)[:, None],
                                 kb[None], rb) // esize]
        # each thread's fragment: rows r0 and r0 + 8, quad q
        a_tile = np.full((bm, BK), np.nan)
        thr = np.arange(nt)
        wg, warp, lane = thr // 128, thr % 128 // 32, thr % 32
        r0, q = wg * 64 + warp * 16 + lane // 4, lane % 4
        for hh in range(2):
          rows = r0 + 8 * hh
          wq = qs[rows]                                  # (nt, 4)
          if dtype == "f32":
            for j in range(8):
              off = _swizzle(rows, 2 * q + j // 4, rb) + (j % 4) * 4
              v = sum(wq[:, cc] * smem[(cc * a_bytes + off) // esize]
                      for cc in range(4))
              # channel 8q + j sits at K position q + 4j of the f32 pack
              a_tile[rows, q + 4 * j] = v
          else:
            for chunk in range(4):
              off = _swizzle(rows, chunk, rb) + 4 * q
              for e in range(2):
                v = sum(wq[:, cc] * smem[(cc * a_bytes + off) // esize + e]
                        for cc in range(4))
                # K position 8 chunk + 2q + e: channel 8 chunk + 2q + e
                a_tile[rows, 8 * chunk + 2 * q + e] = _bf16(v)
        stale |= bool(np.isnan(a_tile).any() or np.isnan(b_tile).any())
        acc += np.nan_to_num(a_tile) @ np.nan_to_num(b_tile).T
      # the epilogue: row m of the tile to the layout's output pixel
      for r in range(bm):
        m = m0 + r
        if m >= mtot:
          continue
        if erp:
          o = m
        else:
          i, t = m % h, m // h
          o = (t // w * h + i) * w + t % w
        cols = slice(n0, min(n0 + bn, cout))
        assert np.isnan(out[o, cols]).all()
        out[o, cols] = acc[r, :cols.stop - n0]
  return out.reshape(n, h, w, cout), stale


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sphere_type,h,w,cin,cout,bm", [
    ("Cassini", 64, 32, 8, 8, 64),       # tiles end at band edges
    ("Cassini", 64, 32, 40, 72, 128),    # tiles span two bands; Cin 32 + 8
    ("ERP", 32, 64, 8, 8, 64),
    ("ERP", 32, 64, 40, 72, 128),
])
def test_sphere_walk_rebuilds_the_plain_conv(sphere_type, h, w, cin, cout,
                                             bm, dtype):
  """At the smallest grids with a drop lane (64x32 Cassini: column 0, tap
  5; 32x64 ERP: row 0, tap 5), whose seam corners carry weight: the
  modelled kernel equals the port's plain sphere_conv (held against the
  Pallas kernel by tests/test_torch_sphere_conv.py), every byte it reads
  was copied, and a 128-row tile spans two bands of 64 lanes. bf16 blends
  in f32 and rounds the sample to bf16, as the Pallas kernel does: held
  against the plain conv of the rounded samples."""
  _, _, quad, drop = S.shift_tables(h, w, sphere_type)
  assert (drop >= 0).any() and ((quad[..., 1] + quad[..., 3]) > 0).any()
  assert bm == 64 or bm > max(h, w)      # the band is the 64 lanes long
  rng = np.random.default_rng(6)
  x = rng.normal(size=(1, h, w, cin)).astype(np.float32)
  wt = (rng.normal(size=(cout, cin, 3, 3)) * 0.2).astype(np.float32)
  wk = wt.transpose(2, 3, 0, 1).reshape(9, cout, cin).astype(np.float64)
  bn = _sphere_tile(1, cout)[1]
  got, stale = _walk_sphere(x.astype(np.float64), wk, sphere_type, dtype,
                            bm, bn)
  assert not stale
  xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
  if dtype == "f32":
    want = S.sphere_conv(xt, wtt, sphere_type).numpy()
    tol = 1e-5
  else:
    col = _bf16(S._im2col(xt, sphere_type).numpy())    # (N, 9, H, W, Cin)
    want = np.einsum("nkhwc,kco->nhwo", col,
                     S.pack_weight(wtt).double().numpy())
    tol = 1e-2      # a sample whose f32 blend lands on a bf16 tie may round
  err = np.abs(got - want).max() / np.abs(want).max()
  assert err < tol, err


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bm,bn", [(64, 64), (64, 128), (128, 64),
                                   (128, 128)])
def test_sphere_stages_fit_shared_memory(dtype, bm, bn):
  """Every tile's stages are 1024-byte aligned and two or more fit in the
  227 KB a block can take (f32 at BM 128, BN 128: two stages of 98 KB)."""
  stage, stages = _sphere_stage(dtype, bm, bn)
  assert stage % 1024 == 0 and stages >= 2
  assert stages * stage + 1024 <= SMEM_MAX
  assert _sphere_tile(256 * 128, 128) == (128, 128)    # one view, layer 4
  assert _sphere_tile(64 * 32, 40) == (64, 64)


# --- the sphere conv's grad-input (sphere_conv_bwd.cu) ------------------------
MAXE = 4         # output band indices per (input band index, tap)
MAXT = 2         # halo tiles per stage: a tap's entries in passes of 2
# static shared memory: the band's table rows and the (tap, pass) list
DX_TABLE_BYTES = 9 * MAXE * (16 + 8) + 9 * MAXE + 4


def _dx_stage(dtype, bm, bn):
  """(halo tile bytes, stage bytes, stages in flight) of sphere_conv_bwd.cu's
  dx kernel: the weight parts (1024-byte aligned), then two halo tiles of
  BM + 1 rows, each in whole 128-byte lines; as many stages as fit beside
  the 1024 bytes of alignment slack and the table's static shared memory."""
  cfg = CFG[dtype]
  tile = -(-(bm + 1) * cfg["rb"] // 128) * 128
  stage = -(-(cfg["parts"] * bn * cfg["rb"] + MAXT * tile) // 1024) * 1024
  return tile, stage, min(4, (SMEM_MAX - 1024 - DX_TABLE_BYTES) // stage)


def _dx_tile(nb, band, lanes, cin):
  """sphere_conv_bwd.cu:launch_dx: (BM, BN) of a call; a block owns BM
  lanes of one band index."""
  tall = nb * band * -(-lanes // 128) >= SMS
  return (128 if tall else 64), (128 if cin > 64 else 64)


def _fmaf(w, x, v):
  """fmaf on f32 values: the exact product and sum, rounded once to f32
  (through f64, whose 53 bits hold the product of two f32 values)."""
  return (w.astype(np.float64) * x + v).astype(np.float32)


def _walk_dx(g, wk, sphere_type, dtype, bm, bn):
  """sphere_conv_bwd.cu's dx walk over one call, vectorised over the
  threads of a block. Per block (image, band index c, BM lanes from l0),
  live tap of c (transpose_table) and pass over its entries (two at a
  time), per stage of 32 channels of g: B, the
  (9, Cin, Cout) weight packed K-major over Cout by ops/kmajor.py (f32:
  padded, permuted, split), copied into its swizzled tiles and read back
  through the descriptor; for each entry (j, sigma, drop) of (c, tap) a halo
  tile of BM + 1 rows of band j, tile row t the output lane (l0 - sigma - 1
  + t) mod L, zero-filled past the band's rows and past Cout; each
  thread's blend (fmaf in the kernel's order) of its fragment rows r0 and
  r0 + 8 from tile rows r + 1 (weight a_s, 0 on the drop lane) and r
  (a_n, 0 at lane 0 or on the drop lane); f32 split into tf32 parts, three
  products per stage into a fresh fragment added in f32; bf16 rounded
  once; a tap's second pass adds its products to the same sum. The
  epilogue stores rows inside the band at the layout's pixel.
  g (N, H, W, Cout) and wk (9, Cin, Cout) hold values of the dtype; returns
  dx (N, H, W, Cin) in f32 before the store's rounding, and whether any
  read met a byte no copy wrote."""
  cfg = CFG[dtype]
  esize, rb, parts = cfg["esize"], cfg["rb"], cfg["parts"]
  ch, cpr, nt = 16 // esize, rb // 16, 2 * bm
  n, h, w, cout = g.shape
  cin = wk.shape[1]
  erp = sphere_type == "ERP"
  nband, nlane = (h, w) if erp else (w, h)
  entries, weights = S.transpose_table(h, w, sphere_type)
  split = dtype == "f32"
  # (P, 9, Cin, Cout'), as the wrapper packs it
  wt = torch.from_numpy(wk)
  packed = kmajor.pack(wt, wt, split).parts.double().numpy()
  wcout = packed.shape[-1]
  nkc = -(-cout // BK)
  b_bytes = bn * rb
  a_off = parts * b_bytes
  tile, stage, _ = _dx_stage(dtype, bm, bn)
  gf = g.reshape(-1).astype(np.float64)
  tiles = -(-nlane // bm)
  lanes = np.arange(ch)
  # the B copies and descriptor reads, and the halo chunks, of every stage
  bn_, bcc = np.divmod(np.arange(bn * cpr), cpr)
  bdst = np.stack([(p * b_bytes + _swizzle(bn_, bcc, rb)) // esize
                   for p in range(parts)])
  kb = np.arange(BK) * esize
  bread = np.stack([_desc_read(p * b_bytes, np.arange(bn)[:, None], kb[None],
                               rb) // esize for p in range(parts)])
  ht, hcc = np.divmod(np.arange((bm + 1) * cpr), cpr)
  hdst = _swizzle(ht, hcc, rb) // esize
  # each thread's fragment rows and quad, and the elements of a tile that
  # its blend reads from tile row r0 + 8 hh + d, in fragment order: f32
  # channels 8q .. 8q + 7 (chunks 2q, 2q + 1), bf16 bytes 4q (+ 2) of
  # chunks 0 .. 3
  thr = np.arange(nt)
  r0 = thr // 128 * 64 + thr % 128 // 32 * 16 + thr % 32 // 4
  q = thr % 4
  jj = np.arange(8)
  frag = {}
  for hh in range(2):
    for d in range(2):
      row = (r0 + 8 * hh + d)[:, None]
      if dtype == "f32":
        off = _swizzle(row, 2 * q[:, None] + jj // 4, rb) + (jj % 4) * 4
      else:
        off = _swizzle(row, jj // 2, rb) + 4 * q[:, None] + 2 * (jj % 2)
      frag[hh, d] = off // esize
  out = np.full((n * h * w, cin), np.nan)
  stale = False
  for blk in range(n * nband * tiles):
    l0 = blk % tiles * bm
    c = blk // tiles % nband
    img = blk // tiles // nband * h * w
    rows = min(bm, nlane - l0)

    def pixel(b, l, img=img):
      return img + (b * w + l if erp else l * w + b)

    # (tap, first entry) of each pass, in K order
    work = [(k, e0) for k in range(9) for e0 in range(0, entries[c, k, 0, 3],
                                                     MAXT)]
    for n0 in range(0, cin, bn):
      acc = np.zeros((bm, bn), np.float32)
      for step in range(len(work) * nkc):
        (tap, e0), kc = work[step // nkc], step % nkc
        ent = entries[c, tap, e0:e0 + MAXT]
        cnt = min(MAXT, entries[c, tap, 0, 3] - e0)
        smem = np.full(stage // esize, np.nan)
        ci, chb = n0 + bn_, kc * BK + bcc * ch
        okb = (ci < cin) & (chb < wcout)
        for p in range(parts):
          vals = packed[p, tap, np.where(okb, ci, 0)[:, None],
                        np.where(okb, chb, 0)[:, None] + lanes]
          smem[bdst[p][:, None] + lanes] = np.where(okb[:, None], vals, 0.0)
        for e in range(cnt):
          j, sigma = ent[e, :2]
          chn = kc * BK + hcc * ch
          l = l0 - sigma - 1 + ht
          l = np.where(l < 0, l + nlane, l)
          ok = (ht <= rows) & (chn < cout)
          assert (l[ok] < nlane).all()
          src = np.where(ok, pixel(j, l) * cout + chn, 0)
          smem[(a_off + e * tile) // esize + hdst[:, None] + lanes] = np.where(
              ok[:, None], gf[src[:, None] + lanes], 0.0)
        # each thread's blend, in the stage's K order
        a_tile = np.full((bm, BK), np.nan)
        blend = np.zeros((2, nt, 8), np.float32)
        for e in range(cnt):
          _, sigma, drop, _ = ent[e]
          a_s, a_n = weights[c, tap, e0 + e]
          base = (a_off + e * tile) // esize
          for hh in range(2):
            r = r0 + 8 * hh
            l = l0 + r
            ls = l - sigma
            ls = np.where(ls < 0, ls + nlane, ls)
            ln = np.where(ls == 0, nlane - 1, ls - 1)
            ws = np.where(ls == drop, np.float32(0), a_s)
            wn = np.where((l == 0) | (ln == drop), np.float32(0), a_n)
            for d, wt in ((1, ws), (0, wn)):     # tile rows r + 1, r
              blend[hh] = _fmaf(wt[:, None], smem[base + frag[hh, d]],
                                blend[hh])
        for hh in range(2):
          for jj in range(8):
            if dtype == "f32":         # channel 8q + jj at K position q + 4jj
              a_tile[r0 + 8 * hh, q + 4 * jj] = blend[hh, :, jj]
            else:                      # K position 8 chunk + 2q + e
              a_tile[r0 + 8 * hh, 8 * (jj // 2) + 2 * q + jj % 2] = _bf16(
                  blend[hh, :, jj])
        b_tiles = smem[bread]                               # (P, BN, BK)
        stale |= bool(np.isnan(a_tile).any() or np.isnan(b_tiles).any())
        if dtype == "f32":
          big = _tf32(a_tile)
          small = _tf32(a_tile - big)
          part = (small @ b_tiles[0].T + big @ b_tiles[1].T
                  + big @ b_tiles[0].T)
        else:
          part = a_tile @ b_tiles[0].T
        acc = (acc + part.astype(np.float32)).astype(np.float32)
      # the epilogue: rows inside the band, at pixel (c, l0 + r)
      cols = slice(n0, min(n0 + bn, cin))
      for r in range(rows):
        o = pixel(c, l0 + r)
        assert np.isnan(out[o, cols]).all()
        out[o, cols] = acc[r, :cols.stop - n0]
  assert not np.isnan(out).any()
  return out.reshape(n, h, w, cin), stale


def _dx_operand_by_pass(g, sphere_type):
  """The dx GEMM's A by tap and pass, (9, 2, H*W, Cout) f64, for a batch-1
  g: each output band's samples of the tap scattered back through the plain
  gather's four corners (build_gather_tables, independent of the shift
  tables), and added into the pass that the transposed table gives that
  output band at each input band (its first two entries, then the rest)."""
  _, h, w, cout = g.shape
  idx, wgt = S.build_gather_tables(h, w, 3, 3, sphere_type, 1, 1, 1)
  entries, _ = S.transpose_table(h, w, sphere_type)
  erp = sphere_type == "ERP"
  pix = np.arange(h * w)
  band_of = pix // w if erp else pix % w
  gf = g.reshape(h * w, cout).astype(np.float64)
  a = np.zeros((9, 2, h * w, cout))
  for k in range(9):
    for j in range(entries.shape[0]):
      out = pix[band_of == j]                    # output pixels of band j
      part = np.zeros((h * w, cout))
      for corner in range(4):
        np.add.at(part, idx[corner, k].reshape(-1)[out],
                  wgt[corner, k].reshape(-1, 1)[out].astype(np.float64)
                  * gf[out])
      for c in np.unique(band_of[np.any(part != 0, axis=1)]):
        listed = list(entries[c, k, :entries[c, k, 0, 3], 0])
        into = band_of == c
        a[k, listed.index(j) // MAXT, into] += part[into]
  return a


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sphere_type,h,w,cin,cout,bm", [
    ("Cassini", 32, 16, 8, 8, 64),       # L = 32 < BM: half the rows masked
    ("ERP", 16, 32, 8, 8, 64),
    ("Cassini", 64, 32, 72, 40, 64),     # drop lane; Cout 32 + 8; Cin 72
    ("ERP", 32, 64, 72, 40, 64),
    ("Cassini", 64, 32, 8, 16, 128),     # BM 128 over 64 lanes
    ("ERP", 32, 64, 8, 16, 128),
])
def test_dx_walk_rebuilds_the_plain_grad_input(sphere_type, h, w, cin, cout,
                                               bm, dtype):
  """The modelled dx kernel against the port's plain grad-input
  (``_plain_bwd_input``, held against the Pallas backward by
  tests/test_torch_sphere_conv_bwd.py): every band index of these maps
  has taps with 1 to 4 entries in the transposed table, the 64-lane maps a
  drop lane, and no read meets a byte no copy wrote. f32 as 3xTF32 within
  1e-5 of the largest value; bf16 blends in f32 and rounds each pass's A
  once: held to 1e-3 against A rounded pass by pass from the plain
  gather's own scatter (a blend on a bf16 tie may round the other way),
  and after the store's rounding to
  chip_smoke.py's bf16 bar against the plain version, on chip_smoke.py's
  inputs (the rounding of A is ~2^-9 of each product, so the bar's
  absolute part holds only at the scale of those inputs)."""
  entries, _ = S.transpose_table(h, w, sphere_type)
  assert set(np.unique(entries[..., 0, 3])) >= {1, 2, 3, 4}
  _, _, _, drop = S.shift_tables(h, w, sphere_type)
  assert (drop >= 0).any() == (max(h, w) >= 64)
  # chip_smoke.py's inputs: g * 0.5, He-scaled weights
  rng = np.random.default_rng(8)
  g = (rng.normal(size=(1, h, w, cout)) * 0.5).astype(np.float32)
  wt = (rng.normal(size=(cout, cin, 3, 3))
        * np.sqrt(2.0 / (9 * cout))).astype(np.float32)
  if dtype == "bf16":
    g, wt = _bf16(g).astype(np.float32), _bf16(wt).astype(np.float32)
  wk = S.pack_weight(torch.from_numpy(wt)).numpy()      # (9, Cin, Cout)
  bn = _dx_tile(1, min(h, w), max(h, w), cin)[1]
  got, stale = _walk_dx(g, wk, sphere_type, dtype, bm, bn)
  assert not stale
  want = S._plain_bwd_input(torch.from_numpy(g), torch.from_numpy(wt),
                            sphere_type).double().numpy()
  scale = np.abs(want).max()
  if dtype == "f32":
    assert np.abs(got - want).max() / scale < 1e-5
  else:
    a = _bf16(_dx_operand_by_pass(g, sphere_type).astype(np.float32))
    rounded = np.einsum("kqpo,kco->pc", a, wk.astype(np.float64))
    assert np.abs(got.reshape(rounded.shape) - rounded).max() / scale < 1e-3
    stored = _bf16(got)
    assert (np.abs(stored - want) <= BF16_ATOL + BF16_RTOL * np.abs(want)
            ).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bm,bn", [(64, 64), (64, 128), (128, 64),
                                   (128, 128)])
def test_dx_stages_fit_shared_memory(dtype, bm, bn):
  """Every dx tile's stages fit the 227 KB a block can take, two or more,
  with the weight tiles 1024-byte aligned for their descriptors and the
  two halo tiles on whole 128-byte lines, so the fragment reads stay
  conflict-free: f32 at BM 128, BN 128 holds three stages of 65 KB, and
  bf16 two blocks an SM."""
  tile, stage, stages = _dx_stage(dtype, bm, bn)
  cfg = CFG[dtype]
  assert tile % 128 == 0 and tile >= (bm + 1) * cfg["rb"]
  assert stage % 1024 == 0 and (cfg["parts"] * bn * cfg["rb"]) % 1024 == 0
  assert stages >= 2
  assert stages * stage + 1024 + DX_TABLE_BYTES <= SMEM_MAX
  if (dtype, bm, bn) == ("f32", 128, 128):
    assert (stage, stages) == (66560, 3)
  if dtype == "bf16":
    assert 2 * (stages * stage + 1024 + DX_TABLE_BYTES) <= SMEM_MAX
  # the layer-4 grad-inputs of a batch-2 step: 128 bands of 256 lanes
  assert _dx_tile(2, 128, 256, 64) == (128, 64)
  assert _dx_tile(2, 128, 256, 128) == (128, 128)
  assert _dx_tile(1, 16, 32, 8) == (64, 64)


# --- the sphere conv's weight gradient (sphere_conv_bwd.cu) -------------------
DW_BM = 128      # output channels of a block (two warpgroups)
DW_BK = 32       # lanes of a K stage
DW_HALO = DW_BK + 1


def _dw_layout(dtype, bn):
  """(corner tile bytes, g tile bytes, copy stage bytes, stages in flight,
  dynamic shared memory) of sphere_conv_bwd.cu's dw kernel: two B buffers
  of two f32 parts (BN rows of 128 bytes), then the copy stages, each two
  corner tiles of 33 rows of BN channels (whole 128-byte lines) and the g
  tile of 32 rows of 128 channels."""
  esize = CFG[dtype]["esize"]
  corner = -(-DW_HALO * bn * esize // 128) * 128
  gbytes = DW_BK * DW_BM * esize
  stage = 2 * corner + gbytes
  b_parts = 4 * bn * 128
  stages = min(4, (SMEM_MAX - 1024 - b_parts) // stage)
  return corner, gbytes, stage, stages, b_parts + stages * stage + 1024


def _dw_corner_at(t, c, bn, esize):
  """sphere_conv_bwd.cu:dw_corner_at: chunk c of corner row t, XOR t & 7."""
  return t * bn * esize + ((c ^ (t & 7)) << 4)


def _dw_g_at(i, c, esize):
  """sphere_conv_bwd.cu:dw_g_at: chunk c of g row i, XOR a function of
  i >> 3."""
  sw = ((i >> 3) & 3) << 1 if esize == 4 else (i >> 3) & 3
  return i * DW_BM * esize + ((c ^ sw) << 4)


def _walk_dw(x, g, sphere_type, dtype, nsplit, chunk):
  """sphere_conv_bwd.cu's dw walk over one call, vectorised over the
  threads of a block: for each block (tap x BN input channels, 128 output
  channels, split) and K stage of its split (a run of 32 lanes of one band
  index of one image), the copies into the two corner tiles (33 rows, lane
  (l0 + sigma + t) mod L of bands b0 and b1, zero-filled past the run and
  past Cin) and the g tile (the run's pixels, zero-filled past the run and
  past Cout), in their swizzled layouts; each thread's blend of 4 channels
  x pixels j, j + 8, j + 16, j + 24 (fmaf in the kernel's order, the
  drop lane zero, the successor of lane L - 1 weighing zero) stored split
  as chunk j of the 128-byte-swizzled B rows and read back through the
  descriptor; each thread's A fragment loaded from the g tile (rows r0,
  r0 + 8, pixels 8q .. 8q + 7); 3xTF32 products into a fresh fragment per
  stage, added in f32; the partial sums of each split, then their sum in
  split order. x (N, H, W, Cin) and g (N, H, W, Cout) hold values of the
  dtype; returns dw (9, Cin, Cout) f32, whether any read met a byte no
  copy wrote, and how many samples met the seam, the drop lane and a
  run shorter than a stage."""
  esize = CFG[dtype]["esize"]
  ch = 16 // esize
  n, h, w, cin = x.shape
  cout = g.shape[-1]
  bn = 128 if cin > 64 else 64
  xcpr, gcpr = bn // ch, DW_BM // ch
  corner, _, stage, _, _ = _dw_layout(dtype, bn)
  erp = sphere_type == "ERP"
  nband, nlane = (h, w) if erp else (w, h)
  runs = -(-nlane // DW_BK)
  total = n * nband * runs
  itab, ftab = _shift_tables(h, w, sphere_type)
  xf, gf = x.reshape(-1).astype(np.float64), g.reshape(-1).astype(np.float64)
  lanes = np.arange(ch)

  def pixel(img, b, l):
    return img * h * w + (b * w + l if erp else l * w + b)

  # the copies of a stage: corner (e, t, cc) and g (i, cc)
  ce, ct, ccc = np.unravel_index(np.arange(2 * DW_HALO * xcpr),
                                 (2, DW_HALO, xcpr))
  cdst = (ce * corner + _dw_corner_at(ct, ccc, bn, esize)) // esize
  gi, gcc = np.divmod(np.arange(DW_BK * gcpr), gcpr)
  gdst = (2 * corner + _dw_g_at(gi, gcc, esize)) // esize
  # the blend's threads (j, cg), active below BN / 4 channel groups
  tid = np.arange(2 * DW_BM)
  bj, cg = tid & 7, tid >> 3
  act = cg < bn // 4
  bj, cg = bj[act], cg[act]
  # element offsets of each thread's 4 channels in corner rows 0 .. 32
  if esize == 4:
    coff = np.stack([_dw_corner_at(t, cg, bn, esize) // esize
                     for t in range(DW_HALO)])
  else:
    coff = np.stack([(_dw_corner_at(t, cg >> 1, bn, esize) + 8 * (cg & 1))
                     // esize for t in range(DW_HALO)])
  thr = np.arange(len(bj))
  # B read back through the descriptor, (part, BN, 32 K positions)
  bread = np.stack([_desc_read(p * bn * 128, np.arange(bn)[:, None],
                               np.arange(DW_BK)[None] * 4, 128) // 4
                    for p in range(2)])
  # the A fragment: thread (wg, warp, lane), rows r0 + 8 hh, pixels 8q + j
  r0 = tid // 128 * 64 + tid % 128 // 32 * 16 + tid % 32 // 4
  q = tid % 4
  stats = {"seam": 0, "drop": 0, "short": 0}
  part = np.full((nsplit, 9 * cin, cout), np.nan, np.float32)
  stale = False
  for z in range(nsplit):
    s_lo = z * chunk
    nsteps = max(0, min(chunk, total - s_lo))
    for tap in range(9):
      for c0 in range(0, cin, bn):
        for m0 in range(0, cout, DW_BM):
          acc = np.zeros((DW_BM, bn), np.float32)
          for step in range(nsteps):
            s = s_lo + step
            l0 = s % runs * DW_BK
            band = s // runs % nband
            img = s // runs // nband
            rows = min(DW_BK, nlane - l0)
            sigma, b0, b1, drop = itab[band, tap]
            f = ftab[band, tap].astype(np.float32)
            sl = l0 + sigma
            sl = sl - nlane if sl >= nlane else sl
            smem = np.full(stage // esize, np.nan)
            ci = c0 + ccc * ch
            lane = sl + ct
            lane = np.where(lane >= nlane, lane - nlane, lane)
            ok = (ct <= rows) & (ci < cin)
            src = np.where(ok, pixel(img, np.where(ce == 1, b1, b0), lane)
                           * cin + ci, 0)
            smem[cdst[:, None] + lanes] = np.where(ok[:, None],
                                                   xf[src[:, None] + lanes],
                                                   0.0)
            co = m0 + gcc * ch
            ok = (gi < rows) & (co < cout)
            src = np.where(ok, pixel(img, band, l0 + gi) * cout + co, 0)
            smem[gdst[:, None] + lanes] = np.where(ok[:, None],
                                                   gf[src[:, None] + lanes],
                                                   0.0)
            # the blend, stored split at chunk j of B rows 4 cg + c
            bmem = np.full(2 * bn * 128 // 4, np.nan)
            for u in range(4):
              i = bj + 8 * u
              live = (i < rows) & (l0 + i != drop)
              sv = sl + i
              sv = np.where(sv >= nlane, sv - nlane, sv)
              seam = sv == nlane - 1
              stats["seam"] += int((live & seam).sum())
              stats["drop"] += int(((i < rows) & (l0 + i == drop)).sum())
              stats["short"] += int(rows < DW_BK and u == 0)
              fy = np.where(seam, np.float32(0), f[1])
              fw = np.where(seam, np.float32(0), f[3])
              ir = np.where(live, i, 0)
              vals = np.zeros((len(bj), 4), np.float32)
              for c in range(4):
                def at(tile, t):
                  return smem[tile * corner // esize + coff[t, thr] + c]
                a0, a1 = at(0, ir), at(0, ir + 1)
                q0, q1 = at(1, ir), at(1, ir + 1)
                v = (np.float64(f[0]) * a0).astype(np.float32)
                v = _fmaf(fy, a1, v)
                v = _fmaf(np.full_like(fy, f[2]), q0, v)
                v = _fmaf(fw, q1, v)
                vals[:, c] = np.where(live, v, np.float32(0))
              for c in range(4):
                nrow = 4 * cg + c
                big = _tf32(vals[:, c])
                small = _tf32(vals[:, c] - big)
                off = _swizzle(nrow, bj, 128) // 4 + u
                bmem[off] = big
                bmem[bn * 128 // 4 + off] = small
            b_tiles = bmem[bread]                      # (2, BN, 32)
            # A from the g tile: K position q + 4 j holds pixel 8 q + j
            a_tile = np.full((DW_BM, DW_BK), np.nan)
            for hh in range(2):
              col = r0 + 8 * hh
              for jj in range(8):
                ipx = 8 * q + jj
                a_tile[col, q + 4 * jj] = smem[
                    (2 * corner + _dw_g_at(ipx, col // ch, esize)) // esize
                    + col % ch]
            stale |= bool(np.isnan(a_tile).any() or np.isnan(b_tiles).any())
            big = _tf32(a_tile)
            small = _tf32(a_tile - big)
            prod = (small @ b_tiles[0].T + big @ b_tiles[1].T
                    + big @ b_tiles[0].T)
            acc = (acc + prod.astype(np.float32)).astype(np.float32)
          cis = slice(c0, min(c0 + bn, cin))
          cos = slice(m0, min(m0 + DW_BM, cout))
          part[z, tap * cin + cis.start:tap * cin + cis.stop, cos] = acc[
              :cos.stop - m0, :cis.stop - c0].T
  assert not np.isnan(part).any()
  dw = np.zeros((9 * cin, cout), np.float32)
  for z in range(nsplit):
    dw = (dw + part[z]).astype(np.float32)
  return dw.reshape(9, cin, cout), stale, stats


def _sms(monkeypatch, sms=SMS):
  """The SM count that ops/sphere_conv.py:_weight_splits reads, here."""
  monkeypatch.setattr(torch.cuda, "get_device_properties",
                      lambda device: type("P", (), {
                          "multi_processor_count": sms})())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sphere_type,n,h,w,cin,cout", [
    ("Cassini", 2, 48, 24, 8, 8),     # runs of 32 and 16 lanes; two images
    ("ERP", 2, 24, 48, 8, 8),
    ("Cassini", 1, 80, 40, 72, 40),   # drop lane, a 16-lane run; Cin 72
    ("ERP", 1, 40, 80, 72, 40),
    ("Cassini", 1, 64, 32, 64, 16),   # drop lane; Cin 64 (BN 64)
    ("ERP", 1, 32, 64, 64, 16),
])
def test_dw_walk_rebuilds_the_plain_grad_weight(monkeypatch, sphere_type, n,
                                                h, w, cin, cout, dtype):
  """The modelled dw kernel against the port's plain grad-weight
  (``_plain_bwd_weight``, held against the Pallas backward by
  tests/test_torch_sphere_conv_bwd.py), with the splits the wrapper picks
  for an H100: every sample at the seam, on the drop lane and in a run
  shorter than a stage is met, and no read meets a byte no copy wrote.
  f32 as 3xTF32 within 1e-5 of the largest value; bf16 widened on read
  and summed the same way, so the same bar (chip_smoke.py's)."""
  _sms(monkeypatch)
  rng = np.random.default_rng(9)
  x = (rng.normal(size=(n, h, w, cin)) * 0.5).astype(np.float32)
  g = (rng.normal(size=(n, h, w, cout)) * 0.5).astype(np.float32)
  if dtype == "bf16":
    x, g = _bf16(x).astype(np.float32), _bf16(g).astype(np.float32)
  nsplit, chunk = S._weight_splits(n, h, w, cin, cout, sphere_type, "cuda")
  got, stale, stats = _walk_dw(x, g, sphere_type, dtype, nsplit, chunk)
  assert not stale
  assert stats["seam"] > 0
  assert (stats["short"] > 0) == (max(h, w) % DW_BK != 0)
  assert (stats["drop"] > 0) == (max(h, w) >= 64)
  want = S._plain_bwd_weight(torch.from_numpy(x), torch.from_numpy(g),
                             sphere_type).double().numpy()
  assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bn", [64, 128])
def test_dw_stages_fit_shared_memory(dtype, bn):
  """The dw kernel's two B buffers (1024-byte aligned for their
  descriptors) and three or more copy stages (128-byte aligned, corner rows
  of eight chunks or more, so the XOR swizzles stay in the row) fit the
  227 KB a block can take: f32 at BN 128 three stages of 49 KB beside the
  64 KB of B."""
  corner, gbytes, stage, stages, smem = _dw_layout(dtype, bn)
  esize = CFG[dtype]["esize"]
  assert bn * esize >= 128 and corner >= DW_HALO * bn * esize
  assert (bn * 128) % 1024 == 0 and stage % 128 == 0 and corner % 128 == 0
  assert gbytes == DW_BK * DW_BM * esize
  assert stages >= 3 and smem <= SMEM_MAX
  if (dtype, bn) == ("f32", 128):
    assert (stage, stages, smem) == (50176, 3, 217088)
  # The swizzles spread what 8 threads read at once over distinct 16-byte
  # bank groups: an A fragment load (rows 8q + j of the g tile, q = 0..3,
  # at the chunks of 8 consecutive output channels from an even chunk) and
  # a corner read of the blend (one chunk of 8 consecutive rows).
  for j in range(8):
    chunks = (0, 1) if esize == 4 else (0,)
    groups = {(_dw_g_at(8 * q + j, c, esize) // 16) % 8
              for q in range(4) for c in chunks}
    assert len(groups) == 4 * len(chunks)
  for t0 in range(DW_HALO - 7):
    groups = {(_dw_corner_at(t, 5, bn, esize) // 16) % 8
              for t in range(t0, t0 + 8)}
    assert len(groups) == 8
