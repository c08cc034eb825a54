"""The port's single-file decoders (``mode_tpu_torch/data/native_io.py``:
``decode_png`` and ``read_npz``) against the JAX package's and against PIL
and numpy, on the cases of ``tests/test_native_io.py``: 8-bit RGB, RGBA and
grayscale PNGs from a seeded array; ``.npy`` in f4 and f8 and ``.npz``
stored and compressed with two arrays (the first is read), all bit-equal;
and the inputs both sides refuse with ``IOError``.
"""

import numpy as np
import pytest
from PIL import Image

from mode_tpu.data import native_io as jnative
from mode_tpu_torch.data import native_io as tnative


def test_the_library_is_there():
  assert tnative.available() and jnative.available()


@pytest.mark.parametrize("ch,mode", [(3, "RGB"), (4, "RGBA"), (1, "L")])
def test_decode_png_matches_jax_and_pil(tmp_path, rng, ch, mode):
  img = rng.integers(0, 256, size=(37, 53, ch), dtype=np.uint8)
  p = str(tmp_path / f"t{ch}.png")
  Image.fromarray(img[..., 0] if ch == 1 else img, mode=mode).save(p)
  got = tnative.decode_png(p)
  assert got.dtype == np.uint8 and got.shape == (37, 53, ch)
  np.testing.assert_array_equal(got, jnative.decode_png(p))
  want = np.asarray(Image.open(p))
  np.testing.assert_array_equal(got, want.reshape(37, 53, ch))
  np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["npy_f4", "npy_f8", "npz_stored",
                                  "npz_compressed"])
def test_read_npz_matches_jax(tmp_path, rng, kind):
  a = rng.normal(size=(17, 9))
  other = rng.normal(size=(3, 4)).astype(np.float32)
  a = a.astype(np.float64 if kind == "npy_f8" else np.float32)
  if kind.startswith("npy"):
    p = str(tmp_path / "a.npy")
    np.save(p, a)
  else:
    p = str(tmp_path / "a.npz")
    save = np.savez_compressed if kind == "npz_compressed" else np.savez
    save(p, a, other)                      # the first array is read
  got = tnative.read_npz(p, a.shape)
  assert got.dtype == np.float32 and got.shape == a.shape
  np.testing.assert_array_equal(got, jnative.read_npz(p, a.shape))
  np.testing.assert_array_equal(got, a.astype(np.float32))


def _bad_inputs(tmp_path, rng):
  img = rng.integers(0, 256, size=(20, 30, 3), dtype=np.uint8)
  good = tmp_path / "good.png"
  Image.fromarray(img).save(good)
  cut = tmp_path / "cut.png"
  cut.write_bytes(good.read_bytes()[:len(good.read_bytes()) // 2])
  bad = tmp_path / "bad.png"
  bad.write_bytes(b"not a png")
  arr = tmp_path / "a.npz"
  np.savez(arr, np.zeros((4, 5), np.float32))
  return {
      "missing_png": ("decode_png", (str(tmp_path / "missing.png"),)),
      "truncated_png": ("decode_png", (str(cut),)),
      "not_a_png": ("decode_png", (str(bad),)),
      "missing_npz": ("read_npz", (str(tmp_path / "missing.npz"), (2, 2))),
      "too_few_elements": ("read_npz", (str(arr), (5, 5))),
      "too_many_elements": ("read_npz", (str(arr), (2, 5))),
  }


@pytest.mark.parametrize("case", ["missing_png", "truncated_png",
                                  "not_a_png", "missing_npz",
                                  "too_few_elements", "too_many_elements"])
def test_bad_inputs_raise_ioerror_on_both_sides(tmp_path, rng, case):
  name, args = _bad_inputs(tmp_path, rng)[case]
  with pytest.raises(IOError):
    getattr(jnative, name)(*args)
  with pytest.raises(IOError):
    getattr(tnative, name)(*args)


def test_a_missing_library_names_its_build(monkeypatch):
  monkeypatch.setattr(tnative, "_load", lambda: None)
  with pytest.raises(RuntimeError, match="make -C native"):
    tnative.decode_png("x.png")
