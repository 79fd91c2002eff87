"""Training traffic: epochs of the port's epoch step over a card-resident
split, as `python -m seld_tpu_torch.train --device_data --epoch_scan` runs
them.

Set-up builds ONE training state (the model with the harness's seeded
weights, AdaBelief with AGC, the dropout generator), stages a seeded split
in a `DeviceDataset` and makes the epoch step. The state's first
`check_steps` steps go through that epoch step and feed, one batch a call
(rows of the first epoch's shuffle, all different), and what they leave
(the losses, the first gradient as the optimizer's first moment holds
it, the parameters after the last) is kept to be judged; then one whole
epoch captures the window's graph. The same state trains on in the
window, an epoch an item, each ended by reading its last loss on the host.

After the window the program's state is freed and the plain reference
(`reference/<config>.py` + `common.py`, f32, TF32 off) follows the same
steps from the same weights, batches and dropout masks (its generator
seeded as the state's). Readings: each step's SED and DOA loss (relative
gap; `first_loss_gap` the first step's alone), the first gradient's norm
and the parameters' change after the steps, each by its worst leaf (gap
of norms over the larger of the reference leaf's norm and the median
leaf's), and the median leaf's distance from the reference's first
gradient (`median_grad_diff`, the norm of the difference over the same
scale). Leaves whose reference gradient is under a thousandth of the
median leaf's (a key bias under softmax) are left out of all but the
losses.
"""
from __future__ import annotations

import contextlib
import statistics
from typing import Dict

import torch

from seld_bench import harness
from seld_bench.harness import Phases
from seld_bench.reference import common as R
from seld_bench.yardstick.work import GRULaunch


def make_split(traffic: Dict, input_shape, n_classes: int, seed: int,
               device):
    """(x [N, T, F, C] in the compute dtype, y [N, T_l, 4C] f32: SED
    activity and unit DOA vectors of the active classes) from `seed`, on
    `device`, in a few large draws."""
    n = traffic["clips"] * traffic["windows_per_clip"]
    g = harness.generator(seed, device)
    dtype = getattr(torch, traffic["compute_dtype"])
    x = torch.randn((n, *input_shape), generator=g, device=device).to(dtype)
    t, c = traffic["label_frames"], n_classes
    sed = (torch.rand((n, t, c), generator=g, device=device)
           < traffic["event_share"]).float()
    v = torch.randn((n, t, 3, c), generator=g, device=device)
    v = v / v.norm(dim=2, keepdim=True).clamp_min(1e-6)
    doa = (v * sed[:, :, None]).reshape(n, t, 3 * c)
    return x, torch.cat([sed, doa], dim=-1)


class Cell:
    # the faults `check_control` can plant in the reference's steps
    FAULTS = ("half",)

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cfg = config["model_config"]
        self.n_classes = self.cfg["n_classes"]
        self.input_shape = tuple(config["input_shape"])
        self.batch = traffic["batch"]

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from seld_tpu_torch.data.device_dataset import DeviceDataset
        from seld_tpu_torch.models import build_model
        from seld_tpu_torch.train import losses as L
        from seld_tpu_torch.train import metrics as M
        from seld_tpu_torch.train.optimizers import adabelief
        from seld_tpu_torch.train.steps import make_train_epoch
        from seld_tpu_torch.train.train_state import TrainState

        tr, dev, c = self.traffic, self.device, self.n_classes
        self._M = M
        clock = Phases(dev)
        model = build_model(self.config["model"], self.input_shape, self.cfg,
                            device=dev)
        self.shapes = {k: tuple(v.shape)
                       for k, v in model.state_dict().items()}
        self.names = [k for k, _ in model.named_parameters()]
        model.load_state_dict(harness.make_weights(
            self.shapes, harness.sub_seed(self.seed, 1), dev))
        opt = adabelief(list(model.parameters()), tr["learning_rate"],
                        agc_clip=tr["agc_clip"])
        self.state = TrainState(model, opt,
                                seed=harness.sub_seed(self.seed, 2))
        x, y = make_split(tr, self.input_shape, c,
                          harness.sub_seed(self.seed, 3), dev)
        self.ds = DeviceDataset(x, y, self.batch, dev,
                                loop_time=tr["loop_time"],
                                seed=harness.sub_seed(self.seed, 4) % 2 ** 32)
        self.steps_per_item = len(self.ds)
        del x, y
        clock("weights and split")
        cw = L.class_weights_from_samples(L.DCASE2021_TRAIN_SAMPLES, dev)
        self.epoch = make_train_epoch(
            sed_loss_fn=lambda yy, p: L.sed_loss_with_weights(yy, p, cw),
            doa_loss_fn=lambda yy, p: L.MMSE_with_cls_weights(yy, p, cw),
            n_classes=c, loss_weights=tuple(tr["loss_weights"]),
            l2=tr["l2"], compute_dtype=getattr(torch, tr["compute_dtype"]))
        self.aug = harness.generator(harness.sub_seed(self.seed, 5), dev)
        self._check_steps()
        clock("checked steps")
        self.item()                     # captures the window's epoch graph
        clock("window graph")
        self.phases = clock.phases

    def _check_steps(self) -> None:
        """The state's first steps, one batch a call of the epoch step."""
        x_all, y_all = self.ds.device_arrays
        ids = self.ds.epoch_index_matrix()[:self.traffic["check_steps"]]
        self.check_ids = ids.clone()
        one = torch.empty_like(ids[:1])
        mstate = self._M.init_state(self.n_classes, self.device)
        losses = []
        opt = self.state.optimizer
        for i in range(ids.shape[0]):
            one.copy_(self.check_ids[i:i + 1])
            self.state, mstate, (sl, dl) = self.epoch(
                self.state, mstate, x_all, y_all, one, self.aug)
            losses.append(torch.stack([sl[0], dl[0]]))
            if i == 0:
                self.grad1 = [m / (1.0 - opt.b1) for m in opt.m]
        self.params_after = [p.detach().clone()
                             for p in self.state.model.parameters()]
        self.losses = torch.stack(losses).cpu()

    def item(self, record: bool = True) -> int:
        """One epoch; returns the windows it trained on (nothing of a
        window's epoch is judged, so `record` changes nothing)."""
        x_all, y_all = self.ds.device_arrays
        idx = self.ds.epoch_index_matrix()
        self.state, _, (sl, _) = self.epoch(
            self.state, self._M.init_state(self.n_classes, self.device),
            x_all, y_all, idx, self.aug)
        self.last_loss = sl[-1].item()
        return idx.numel()

    def end_to_end(self, elapsed: float, units: int) -> Dict[str, float]:
        return {"train_windows_per_s": units / elapsed}

    def release(self) -> None:
        """Free the program's state; the readings to judge stay."""
        self.epoch.release()
        del self.state, self.ds, self.epoch

    # --------------------------------------------------------- reference
    def follow(self, control: bool = False, fault: str = None) -> Dict:
        """The reference's losses, first gradient and parameters after the
        checked steps, from the same weights, batches and masks; with
        `control`, every product's operands rounded to fp8; with fault
        "half", the losses taken over the first half of each batch."""
        ref = harness.reference(self.config)
        tr, dev, c = self.traffic, self.device, self.n_classes
        # the same draw as the program's weights, buffers and all
        weights = harness.make_weights(self.shapes,
                                       harness.sub_seed(self.seed, 1), dev)
        P = {n: weights[n].clone().requires_grad_(True) for n in self.names}
        x, y = make_split(tr, self.input_shape, c,
                          harness.sub_seed(self.seed, 3), dev)
        drop = R.Dropout(harness.generator(harness.sub_seed(self.seed, 2),
                                           dev))
        opt = R.AdaBelief(list(P.values()), tr["learning_rate"],
                          tr["agc_clip"])
        cw = R.class_weights(dev)
        w_sed, w_doa = tr["loss_weights"]
        out = {"losses": [], "raw1": None, "grad1": None}
        for i, ids in enumerate(self.check_ids.long()):
            yb = y[ids]
            with R.fp8_products() if control else contextlib.nullcontext():
                sed, doa = ref.forward(P, x[ids].float(), self.cfg, True,
                                       drop)
            rows = slice(0, len(ids) // 2 if fault == "half" else len(ids))
            sl = R.sed_loss(yb[rows, :, :c], sed[rows], cw)
            dl = R.doa_loss(yb[rows, :, c:], doa[rows], cw)
            loss = w_sed * sl + w_doa * dl + R.l2_penalty(P, tr["l2"])
            grads = torch.autograd.grad(loss, list(P.values()))
            used = opt.step(list(P.values()), grads)
            out["losses"].append([sl.item(), dl.item()])
            if i == 0:
                out["raw1"] = [g.norm().item() for g in grads]
                out["grad1"] = [g.detach() for g in used]
        out["start"] = [weights[n] for n in self.names]
        out["after"] = [p.detach() for p in P.values()]
        return out

    def compare(self, ref: Dict, judged: Dict, details: bool = False
                ) -> Dict:
        """The readings of `judged` (losses [steps, 2], the first
        gradient's leaves, the parameters after) against the reference's;
        with `details`, each step's loss gaps and the worst leaves too."""
        rl = torch.tensor(ref["losses"])
        step_gaps = (judged["losses"] - rl).abs() / rl.abs()
        # null leaves (a bias before a batch norm, a key bias under
        # softmax): their reference gradient is rounding, so they count in
        # neither the gradient nor the change
        raw_med = statistics.median(ref["raw1"])
        keep = [i for i, r in enumerate(ref["raw1"]) if r >= 1e-3 * raw_med]
        g_ref = [ref["grad1"][i].norm().item() for i in keep]
        g_med = statistics.median(g_ref)
        grads = [(abs(judged["grad1"][i].norm().item() - b) / max(b, g_med),
                  i) for i, b in zip(keep, g_ref)]
        # the same leaves' distance from the reference's, first order in
        # the error where a gap of norms is second order in random error
        diffs = [((judged["grad1"][i].float() - ref["grad1"][i]).norm().item()
                  / max(b, g_med), i) for i, b in zip(keep, g_ref)]
        start = ref["start"]
        d_ref = [(ref["after"][i] - start[i]).norm().item() for i in keep]
        d_got = [(judged["after"][i] - start[i]).norm().item() for i in keep]
        d_med = statistics.median(d_ref)
        updates = [(abs(a - b) / max(b, d_med), i)
                   for a, b, i in zip(d_got, d_ref, keep)]
        out = {"loss_gap": step_gaps.max().item(),
               "first_loss_gap": step_gaps[0].max().item(),
               "grad_gap": max(grads)[0], "update_gap": max(updates)[0],
               "median_grad_diff": statistics.median(v for v, _ in diffs)}
        if details:
            out["step_loss_gaps"] = step_gaps.tolist()
            out["worst_grad"] = [(v, self.names[i], self.shapes[self.names[i]])
                                 for v, i in sorted(grads)[-3:]]
            out["worst_update"] = [(v, self.names[i],
                                    self.shapes[self.names[i]])
                                   for v, i in sorted(updates)[-3:]]
            out["worst_grad_diff"] = [(v, self.names[i])
                                      for v, i in sorted(diffs)[-3:]]
            out["median_update_gap"] = statistics.median(v for v, _ in updates)
            out["null_leaves"] = len(ref["raw1"]) - len(keep)
        return out

    def judged(self) -> Dict:
        return {"losses": self.losses,
                "grad1": self.grad1,
                "after": self.params_after}

    def check(self, details: bool = False) -> Dict:
        with R.exact_f32():
            ref = self.follow()
        return self.compare(ref, self.judged(), details)

    def check_control(self, fault: str = None, details: bool = False
                      ) -> Dict:
        """The control's readings: the reference in fp8 in the program's
        place; with `fault` ("half"), the f32 reference with that fault
        planted instead."""
        with R.exact_f32():
            ref = self.follow()
            ctl = self.follow(control=fault is None, fault=fault)
        judged = {"losses": torch.tensor(ctl["losses"]),
                  "grad1": ctl["grad1"], "after": ctl["after"]}
        return self.compare(ref, judged, details)

    # ------------------------------------------------------- per layer
    def facts(self) -> Dict:
        """What the per-layer readers need of this cell: the model FLOPs a
        window (forward and backward of the reference at the cell's
        shapes, counted on the meta device), and each step's GRU
        launches as the work they need."""
        from torch.utils.flop_counter import FlopCounterMode
        ref = harness.reference(self.config)
        P = {n: torch.empty(self.shapes[n], device="meta",
                            requires_grad=True) for n in self.names}
        x = torch.empty((self.batch, *self.input_shape), device="meta")
        with FlopCounterMode(display=False) as counter:
            sed, doa = ref.forward(P, x, self.cfg, True, R.Dropout(None))
            torch.autograd.grad(sed.sum() + doa.sum(), list(P.values()),
                                allow_unused=True)
        io = torch.tensor([], dtype=getattr(
            torch, self.traffic["compute_dtype"])).element_size()
        launches = [GRULaunch(2, t, self.batch, u, io, io) for u, t in
                    ref.gru_layers(self.cfg, self.input_shape[0])]
        return {"flops_per_unit": counter.get_total_flops() / self.batch,
                "steps_per_item": self.steps_per_item,
                "gru_fwd": launches, "gru_bwd": launches}
