#!/usr/bin/env python3
"""Convert a JAX (orbax) checkpoint of ``mode_tpu`` into a reference-layout
torch ``.tar`` that the PyTorch port serves.

    python scripts/jax_checkpoint_to_torch.py CKPT_DIR OUT.tar

``CKPT_DIR`` is a directory written by ``mode_tpu``'s training CLIs
(``train_disparity``: ``ckpt_disp_<model>_<dataset>_<epoch>``;
``train_fusion``: ``ckpt_fusion_epoch<epoch>``). The script reads it with
``mode_tpu.utils.checkpoint.load_checkpoint``, maps its ``params`` and
``batch_stats`` to torch keys and layouts with
``mode_tpu_torch.utils.convert.params_from_jax``, and writes
``{'epoch', 'state_dict'}`` (plus ``train_loss`` where the checkpoint has
one), which ``mode_tpu_torch.cli.common.load_model_checkpoint`` loads. It
needs JAX and orbax, so it runs where ``mode_tpu`` is installed, not on the
card's machine.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mode_tpu.utils.checkpoint import load_checkpoint  # noqa: E402
from mode_tpu_torch.utils.convert import params_from_jax  # noqa: E402


def convert(ckpt_dir: str, out_path: str) -> dict:
  """Write ``ckpt_dir``'s model as a reference ``.tar`` at ``out_path``;
  returns what was written."""
  payload = load_checkpoint(ckpt_dir)
  variables = {k: payload[k] for k in ("params", "batch_stats")
               if payload.get(k)}
  obj = {"epoch": int(np.asarray(payload.get("epoch", 0))),
         "state_dict": params_from_jax(variables)}
  if "train_loss" in payload:
    obj["train_loss"] = float(np.asarray(payload["train_loss"]))
  torch.save(obj, out_path)
  return obj


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("ckpt_dir", help="the orbax checkpoint directory")
  p.add_argument("out", help="the torch .tar to write")
  args = p.parse_args(argv)
  obj = convert(args.ckpt_dir, args.out)
  print(f"wrote {args.out}: epoch {obj['epoch']}, "
        f"{len(obj['state_dict'])} tensors")


if __name__ == "__main__":
  main()
