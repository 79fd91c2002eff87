"""Clip scoring traffic: 60-s FOA wavs from host memory to outputs on the
host, as `make_answer` and `predict_wav` score a split, one clip at a time
or `clip_batch` clips together, closed loop.

An item: the clip's wav (or `clip_batch` wavs stacked) copied to the card,
the port's fused FOA front-end (one launch), the features cut to
`label_frames` x 5 frames and normalised, `ensemble_outputs` (the exact
sliding window, or the fast path with its trunk once a clip), the SED and
DOA outputs copied to the host. A clip's latency runs from taking its wav
to its outputs on the host; in a batch of clips each clip's is the
batch's.

The clips are seeded noise with a moving source (W the source plus noise,
Y Z X the source along a direction that changes every second), made on the
card in set-up and kept in pinned host memory; the normaliser's mean and
standard deviation come from the reference front-end over one more such
clip.

After the window the program is freed; a sample of the window's items,
drawn from the seed, is scored by the plain reference (front-end through
torch.fft, the model in f32 with TF32 off, the same windows, overlap
averaging) and the widest gap of any output is the reading.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from seld_bench import harness
from seld_bench.harness import Phases
from seld_bench.reference import common as R
from seld_bench.yardstick.work import GRULaunch, frontend_work

HOP = 480


def make_clips(n: int, seconds: float, sample_rate: int, seed: int, device
               ) -> torch.Tensor:
    """[n, 4, L] float32 FOA clips (W, Y, Z, X), drawn on `device`."""
    g = harness.generator(seed, device)
    length = int(seconds * sample_rate)
    per_s = -(-length // sample_rate)
    src = torch.randn((n, 1, length), generator=g, device=device) * 0.1
    env = torch.rand((n, 1, per_s), generator=g, device=device)
    src = src * env.repeat_interleave(sample_rate, dim=-1)[..., :length]
    d = torch.randn((n, 3, per_s), generator=g, device=device)
    d = (d / d.norm(dim=1, keepdim=True)).repeat_interleave(
        sample_rate, dim=-1)[..., :length]
    noise = torch.randn((n, 4, length), generator=g, device=device) * 0.01
    return torch.cat([src, src * d], dim=1) + noise


class Cell:
    FAULTS = ()

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cfg = config["model_config"]
        self.frames = traffic["label_frames"] * traffic["step_frames"]
        self.per_item = traffic["clip_batch"]
        self.done = 0
        self.records: List = []     # (clip index, sed, doa) on the host
        self._latencies: List[float] = []

    def setup(self) -> None:
        from seld_tpu_torch.models import build_model
        tr, dev = self.traffic, self.device
        if dev.type == "cuda":
            # f32 as the configuration states it: cuDNN's convolutions
            # otherwise run in TF32 (PyTorch's default)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        clock = Phases(dev)
        model = build_model(self.config["model"],
                            tuple(self.config["input_shape"]), self.cfg,
                            device=dev)
        self.shapes = {k: tuple(v.shape)
                       for k, v in model.state_dict().items()}
        model.load_state_dict(harness.make_weights(
            self.shapes, harness.sub_seed(self.seed, 1), dev))
        self.model = model.eval()
        clips = make_clips(tr["clips"] + 1, tr["clip_seconds"],
                           tr["sample_rate"], harness.sub_seed(self.seed, 6),
                           dev)
        calib = R.foa_features(clips[-1:])[0]
        self.mean, self.std = calib.mean(0), calib.std(0)
        # pinned, as a loader that stages its reads for the card keeps them:
        # the copy is the card's DMA, not the host's memcpy
        self.clips = clips[:-1].cpu()
        if dev.type == "cuda":
            self.clips = self.clips.pin_memory()
        del clips, calib
        clock("weights, clips, normaliser")
        for _ in range(2):              # every shape the window uses
            self.item(record=False)
        self.done = 0
        clock("warm-up")
        self.phases = clock.phases

    def item(self, record: bool = True) -> int:
        from seld_tpu_torch.inference.ensemble import ensemble_outputs
        from seld_tpu_torch.ops.features import apply_normalizer
        from seld_tpu_torch.ops.frontend import fused_foa_frontend
        tr = self.traffic
        ks = [(self.done + r) % tr["clips"] for r in range(self.per_item)]
        t0 = time.perf_counter()
        wav = [self.clips[k].to(self.device) for k in ks]
        feats = fused_foa_frontend(torch.stack(wav) if self.per_item > 1
                                   else wav[0], sample_rate=tr["sample_rate"])
        feats = apply_normalizer(feats[..., :self.frames, :, :], self.mean,
                                 self.std)
        outs = ensemble_outputs(
            self.model, list(feats) if self.per_item > 1 else [feats],
            win_size=tr["win_frames"], step_size=tr["step_frames"],
            batch_size=tr["batch_size"], fast=tr["fast"],
            time_down=self.cfg.get("first_pool_size", [5, 1])[0],
            clip_batch=tr["clip_batch"])
        host = [(s.cpu(), d.cpu()) for s, d in outs]
        latency = time.perf_counter() - t0
        self.done += self.per_item
        if record:
            self._latencies += [latency] * self.per_item
            self.records += [(k, s, d) for k, (s, d) in zip(ks, host)]
        return self.per_item

    def end_to_end(self, elapsed: float, units: int) -> Dict[str, float]:
        """Clips a second over the window, and the 95th percentile of every
        clip's latency (linear between closest ranks)."""
        v = sorted(self._latencies)
        pos = (len(v) - 1) * 0.95
        lo = int(pos)
        hi = min(lo + 1, len(v) - 1)
        p95 = v[lo] + (v[hi] - v[lo]) * (pos - lo)
        return {"score_clips_per_s": units / elapsed, "clip_p95_ms": p95 * 1e3}

    def release(self) -> None:
        del self.model

    # --------------------------------------------------------- reference
    def _sample(self) -> List[int]:
        n = min(self.traffic["check_clips"], len(self.records))
        return sorted(random.Random(self.seed).sample(
            range(len(self.records)), n))

    def reference_outputs(self, k: int, tf32: bool = False):
        """Clip k's (sed, doa) from the plain reference."""
        ref = harness.reference(self.config)
        tr, dev = self.traffic, self.device
        weights = harness.make_weights(self.shapes,
                                       harness.sub_seed(self.seed, 1), dev)
        drop = R.Dropout(None)
        with torch.no_grad(), R.matmul_precision(tf32):
            feats = R.foa_features(self.clips[k:k + 1].to(dev))[0]
            feats = (feats[:self.frames] - self.mean) / self.std.clamp_min(
                1e-8)
            trunk = None
            if tr["fast"]:
                def trunk(x):
                    return ref.forward(weights, x, self.cfg, False, drop,
                                       "trunk")

            def head(x):
                return ref.forward(weights, x, self.cfg, False, drop,
                                   "head" if tr["fast"] else "full")

            return R.clip_outputs(
                head, feats, tr["win_frames"], tr["step_frames"], 128, trunk,
                self.cfg.get("first_pool_size", [5, 1])[0])

    def _gap(self, outputs) -> float:
        gap = 0.0
        for i, (sed, doa) in outputs:
            _, s, d = self.records[i]
            gap = max(gap, (s - sed.cpu()).abs().max().item(),
                      (d - doa.cpu()).abs().max().item())
        return gap

    def check(self, details: bool = False) -> Dict[str, float]:
        outs = [(i, self.reference_outputs(self.records[i][0]))
                for i in self._sample()]
        return {"output_gap": self._gap(outs)}

    def check_control(self, fault: str = None, details: bool = False
                      ) -> Dict[str, float]:
        """The control: the reference with TF32 on in the program's place."""
        gap = 0.0
        for i in self._sample():
            k = self.records[i][0]
            exact = self.reference_outputs(k)
            ctl = self.reference_outputs(k, tf32=True)
            gap = max(gap, (exact[0] - ctl[0]).abs().max().item(),
                      (exact[1] - ctl[1]).abs().max().item())
        return {"output_gap": gap}

    # ------------------------------------------------------- per layer
    def facts(self) -> Dict:
        """The forward FLOPs a clip of this path (counted over the
        reference on the meta device), and a clip's GRU and front-end
        launches as the work they need: every window of the clip once."""
        from torch.utils.flop_counter import FlopCounterMode
        ref = harness.reference(self.config)
        tr = self.traffic
        P = {n: torch.empty(s, device="meta") for n, s in self.shapes.items()}
        win, step = tr["win_frames"], tr["step_frames"]
        n_win = (self.frames - win) // step + 1
        shape = tuple(self.config["input_shape"][1:])
        drop = R.Dropout(None)
        with FlopCounterMode(display=False) as counter:
            if tr["fast"]:
                trunk = ref.forward(P, torch.empty((1, self.frames, *shape),
                                                   device="meta"),
                                    self.cfg, False, drop, "trunk")
                td = self.frames // trunk.shape[1]
                ref.forward(P, torch.empty((n_win, win // td,
                                            trunk.shape[-1]), device="meta"),
                            self.cfg, False, drop, "head")
            else:
                ref.forward(P, torch.empty((n_win, win, *shape),
                                           device="meta"),
                            self.cfg, False, drop)
        samples = int(tr["clip_seconds"] * tr["sample_rate"])
        launches = [GRULaunch(2, t, n_win, u, 4, 4)
                    for u, t in ref.gru_layers(self.cfg, win)]
        return {"flops_per_unit": counter.get_total_flops(),
                "gru_fwd": launches,
                "frontend": [frontend_work(1, 1 + samples // HOP)]}
