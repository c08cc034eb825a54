"""Traffic of served frames: ``TwoStagePipeline.__call__`` on a stream of
whole frames (six uint8 Cassini pairs and four views) from a pool made
from the seed, one client, closed loop; the fused depth is read back to the
host. Stage 1 serves the configuration's ``stage1_weights``; the fusion net
is seeded, its head calibrated by the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import compare, inputs
from benchmark.harness import driver as base
from benchmark.harness.weights import seeded_state
from benchmark.reference import models as ref_models
from benchmark.reference import steps as ref_steps
from benchmark.reference.bridge import bridge
from benchmark.reference.precision import PRECISIONS

# the bridge runs f32 in the program, so the control's is the next below
BRIDGE_DTYPES = {"float32": torch.float64, "fp8": torch.bfloat16}


class Driver(base.Driver):
  program_state = ("pipe", "kept_gpu")

  def setup(self) -> None:
    from mode_tpu_torch.models.disparity import ModeDisparity
    from mode_tpu_torch.models.fusion import ModeFusion
    from mode_tpu_torch.pipeline import TwoStagePipeline
    from mode_tpu_torch.utils.convert import load_reference_state_dict
    cfg, tr = self.config, self.traffic
    h, w = cfg["height"], cfg["width"]
    self.mark("imports")
    self.pool = inputs.frame_pool(self.gen, tr["pool"], h, w,
                                  tr["disparity_px"], self.device)
    self.mark("inputs")
    self.stage1_state = base.load_npz(cfg["stage1_weights"], self.device)
    template = ref_models.ModeFusion(cfg["max_depth"],
                                     cfg["fusion_channels"]).state_dict()
    self.fusion_state = seeded_state(template, self.gen, self.device)
    with self.reference_time():
      self._calibrate_head()
    self.mark("weights")
    disp = ModeDisparity(cfg["maxdisp"], out_conf=True, device=self.device)
    load_reference_state_dict(disp, self.stage1_state)
    fusion = ModeFusion(cfg["max_depth"], cfg["fusion_channels"],
                        device=self.device)
    load_reference_state_dict(fusion, self.fusion_state)
    self.pipe = TwoStagePipeline(
        disp, fusion, maxdisp=cfg["maxdisp"], max_depth=cfg["max_depth"],
        dtype=self.dtype, stage1_chunk=tr["stage1_chunk"], uint8_inputs=True,
        device=self.device)
    del disp, fusion
    self._keep_bridged()
    self.mark("program")
    self.offset = int(np.random.default_rng(self.seed).integers(tr["pool"]))
    self.kept, self.kept_gpu = {}, {}
    for i in range(self.warm_calls()):
      self.call(i)
      self.mark(f"call {i}")

  def _keep_bridged(self) -> None:
    """Keep the bridged maps that ``__call__`` hands to the fusion net, so
    that the check judges the bridge the timed call ran: the pipeline's
    bound ``fuse`` wrapped on this instance."""
    fuse = self.pipe.fuse

    def fuse_keeping(depths, confs, rgbs, **kw):
      self.bridged = (depths, confs)
      return fuse(depths, confs, rgbs, **kw)

    self.pipe.fuse = fuse_keeping

  def _calibrate_head(self) -> None:
    """The head calibrated on pool frame 0's true depths: the reference's
    bridge of its disparities, confidence 1, in eval mode."""
    cfg, frame = self.config, self.pool[0]
    h, w = cfg["height"], cfg["width"]
    disps = torch.tensor(frame["disps"], dtype=torch.float32,
                         device=self.device)[:, None, None].expand(6, h, w)
    depth, conf = bridge(disps, torch.ones_like(disps), cfg["rig"])
    views = ref_steps.normalize(frame["views"].to(self.device))
    net = ref_models.ModeFusion(cfg["max_depth"], cfg["fusion_channels"])
    base.scale_head(self.fusion_state, net.eval(), lambda n: n(
        [d[None, None].float() for d in depth],
        [c[None, None].float() for c in conf], [v[None] for v in views]),
        self.device)

  def _upload(self, i):
    k = (self.offset + i) % len(self.pool)
    f = self.pool[k]
    return k, [f[n].to(self.device, non_blocking=True)
               for n in ("lefts", "rights", "views")]

  def _keep(self, k, fused, disp, conf) -> None:
    self.kept[k] = fused.cpu()
    self.kept_gpu[k] = (disp, conf, *self.bridged)

  def call(self, i: int) -> None:
    k, (lefts, rights, views) = self._upload(i)
    fused, disp, conf = self.pipe(lefts, rights, views)
    self._keep(k, fused, disp, conf)

  def traced_call(self, i: int) -> None:
    """``call`` split as ``TwoStagePipeline.__call__`` runs it, with CUDA
    events around stage 1, the bridge and fusion."""
    from mode_tpu_torch.pipeline import bridge_all_pairs
    k, (lefts, rights, views) = self._upload(i)
    e0 = self.event()
    disp, conf = self.pipe.stage1(lefts, rights)
    e1 = self.event()
    depths, confs = bridge_all_pairs(disp, conf)
    e2 = self.event()
    fused = self.pipe.fuse(depths, confs, views)
    e3 = self.event()
    self._keep(k, fused, disp, conf)
    for name, a, b in (("stage1", e0, e1), ("bridge", e1, e2),
                       ("fusion", e2, e3)):
      self.spans.setdefault(name, []).append((a, b))

  def trace_hooks(self) -> list:
    """CUDA events around each call of stage 1's feature extractor."""
    fe = self.pipe.disp.feature_extraction
    starts = []

    def pre(module, args, kwargs):
      starts.append(self.event())

    def post(module, args, kwargs, out):
      self.spans.setdefault("feature_extraction", []).append(
          (starts.pop(), self.event()))

    return [fe.register_forward_pre_hook(pre, with_kwargs=True),
            fe.register_forward_hook(post, with_kwargs=True)]

  def program_outputs(self) -> dict:
    """The maps the timed path produced for a sample, drawn from the seed,
    of the pool's frames it served (each one's last serving): its
    disparities and confidences, the bridged maps it fused and the fused
    depth it read back."""
    served = sorted(self.kept_gpu)
    self.check = [served[i] for i in base.sampled(
        self.seed + 1, len(served), self.traffic["checked"])]
    out = {}
    for k in self.check:
      disp, conf, depth, dconf = self.kept_gpu[k]
      out[k] = {"disp": disp.float(), "conf": conf.float(),
                "depth": depth.float(), "depth_conf": dconf.float(),
                "fused": self.kept[k].to(self.device)}
    return out

  def reference_outputs(self, precision: str = "float32",
                        judged: dict | None = None) -> dict:
    """The reference's frames, and with ``judged`` (a side's frames) its
    stages after stage 1 on that side's outputs."""
    cfg = self.config
    stage1 = ref_models.ModeDisparity(cfg["maxdisp"], cfg["height"],
                                      cfg["width"], cfg["sphere_type"],
                                      out_conf=True)
    stage1.load_state_dict(self.stage1_state)
    fusion = ref_models.ModeFusion(cfg["max_depth"], cfg["fusion_channels"])
    fusion.load_state_dict(self.fusion_state)
    quant = PRECISIONS[precision]
    rig = dict(cfg["rig"], dtype=BRIDGE_DTYPES[precision])
    for m in (stage1, fusion):
      if quant is not None:
        ref_models.set_quant(m, quant)
      m.to(self.device).eval()
    out = {}
    with base.ieee_f32():
      for k in self.check:
        f = {n: self.pool[k][n].to(self.device)
             for n in ("lefts", "rights", "views")}
        out[k] = ref_steps.frame(stage1, fusion, f["lefts"], f["rights"],
                                 f["views"], rig,
                                 judged[k] if judged else None)
    return out

  def control(self, variant: str) -> tuple[dict, dict]:
    """The control (``variant`` "fp8": the reference in fp8, its bridge in
    bf16) in the program's place, and the f32 reference's stages on its
    outputs, to judge it by."""
    got = self.reference_outputs(variant)
    return got, self.reference_outputs("float32", judged=got)

  numbers = staticmethod(compare.frame_numbers)
