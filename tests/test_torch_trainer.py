"""The port's trainer (seld_tpu_torch/train/trainer.py) against the JAX
package's `SELDTrainer.fit` on a one-device mesh with its `DeviceDataset`,
from the same initial variables (through the bridge) and the same windows,
eagerly and with `--epoch_scan` on both sides; exact resume from a
checkpoint; and the training CLI on a tiny wav tree, eagerly and with
`--epoch_scan [--fuse_metrics]`.

Setup: narrow SS5 (tests/test_torch_model.py::narrow_ss5), every dropout
zeroed, 12 classes with the DCASE2021 class weights, AGC 0.01, L2 1e-3,
AdaBelief at lr 1e-3, 12 train windows [300, 64, 7] in batches of 6 and 6
val windows in whole-clip batches of 3; 4 epochs with swa_start 2,
swa_freq 1, lr_patience 0 and decay 0.5, so plateau decay fires wherever
the val score fails to improve before epoch 2, the lr halves at epoch 2 and
SWA averages epochs 2 and 3. Both sides take the fused stem (the JAX one
through SELD_FUSED_STEM=always).

Tolerances (f32):
  - per-epoch train and val losses, 1e-3 relative; SELD scalars 1e-3
    absolute; lr and swa_count equal (the lr in f32, as JAX holds it);
  - parameters after the first step, element by element, 1e-4 of the
    leaf's largest |value| plus what the gradient's rounding passes on.
    That rounding is about 1e-6 of the step's largest gradient element
    (the level at which tests/test_torch_train_step.py calls a leaf null:
    its gradient is zero in exact arithmetic, as for the bias of a conv
    that feeds a train-mode BatchNorm or attention's key bias). AdaBelief's
    first step moves an element by up to about 1.1 lr, so an element whose
    gradient g is small against its leaf's largest carries up to
    lr x 1e-5 x max|g| / |g| (a 10x margin), and at most 2 x 1.2 lr, where
    the two frameworks' rounding decides the sign of the step;
  - parameters and the SWA average after 4 epochs, leaf by leaf, within
    3e-2 of how far JAX's training moved the leaf: ||port - jax|| <=
    3e-2 ||jax - init|| (null leaves: 2 x 1.2 lr x steps element by
    element). Those sign-decided elements feed every later step, and the
    trajectory spreads: JAX against itself, with its initial weights
    perturbed by 1e-7 relative, ends these 4 epochs up to 6.1e-3 apart in
    these units, and the port ends at most 9.5e-3 from JAX (both at the
    MotherBlock BatchNorm biases). A port that skips the L2 term reads
    about 0.9, and one that leaves a leaf at its initial value reads 1.0;
    test_trajectory_limit_separates_noise_from_faults holds those
    readings on either side of the limit.
Resume is exact: bit for bit on the CPU.
"""
import argparse
import copy
import json
import os
import wave
import weakref

import jax
import numpy as np
import pytest
import torch
from test_torch_model import narrow_ss5

from seld_tpu.data.device_dataset import DeviceDataset as JaxDeviceDataset
from seld_tpu.parallel import make_mesh, replicate
from seld_tpu.train.trainer import SELDTrainer as JaxTrainer
from seld_tpu.train.train_state import SWAState
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.data.device_dataset import DeviceDataset
from seld_tpu_torch.train import main as cli
from seld_tpu_torch.train.checkpoint import (latest_best, restore_checkpoint,
                                             save_checkpoint)
from seld_tpu_torch.train.trainer import SELDTrainer

torch.set_num_threads(1)
SHAPE = (300, 64, 7)
N_CLASSES, LR, EPOCHS, STEPS_PER_EPOCH = 12, 1e-3, 4, 2
LOSS_RTOL, SCORE_ATOL, PARAM_RTOL, NULL_GRAD = 1e-3, 1e-3, 1e-4, 1e-6
GRAD_NOISE, TRAJ_RTOL, SIGN_ATOL = 1e-5, 3e-2, 2 * 1.2 * LR
FROZEN = "ConformerEncoderBlock_0.BatchNorm_0.scale"


def _config(name, **overrides):
    return argparse.Namespace(**{**dict(
        name=name, model="conv_temporal", lr=LR, batch=6,
        loss_weight="1,1000", epoch=EPOCHS, agc=True, label_smoothing=0.0,
        sed_loss="BCE", doa_loss="MMSE", patience=100, lr_patience=0,
        decay=0.5, swa=True, swa_start=2, swa_freq=1, mesh="data:1", seed=0),
        **overrides})


def _model_config():
    cfg = narrow_ss5()
    for key in ("BLOCK0", "BLOCK1", "BLOCK2", "SED", "DOA"):
        cfg.setdefault(f"{key}_ARGS", {})["dropout_rate"] = 0.0
    return cfg


def _windows(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *SHAPE).astype(np.float32)
    sed = (rng.rand(n, 60, N_CLASSES) < 0.2).astype(np.float32)
    xyz = rng.randn(n, 60, 3, N_CLASSES)
    xyz /= np.linalg.norm(xyz, axis=2, keepdims=True)
    doa = (xyz * sed[:, :, None]).reshape(n, 60, -1)
    return x, np.concatenate([sed, doa], axis=-1).astype(np.float32)


def _scalars(logdir, name):
    out = {}
    with open(os.path.join(logdir, name, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out[(rec["tag"], rec["step"])] = rec["value"]
    return out


def _port_trainer(tmp_path, tag, variables, **overrides):
    trainer = SELDTrainer(
        _config("run", **overrides), _model_config(), n_classes=N_CLASSES,
        input_shape=SHAPE, device="cpu",
        workdir=str(tmp_path / tag / "m"), logdir=str(tmp_path / tag / "l"))
    trainer.model.load_state_dict(from_flax(variables, trainer.model))
    return trainer


def _port_data(x, y, xv, yv):
    return (DeviceDataset(x, y, 6, "cpu", loop_time=1, seed=0),
            DeviceDataset(xv, yv, 3, "cpu", train=False))


def _capture_first_step(trainer, params_of, into):
    """Wrap trainer.train_step so that `into` receives the parameters after
    the first step, by name."""
    step = trainer.train_step

    def wrapped(state, *args, **kwargs):
        out = step(state, *args, **kwargs)
        if not into:
            into.update(params_of(out[0]))
        return out
    trainer.train_step = wrapped


def _capture_first_grads(trainer, into):
    """`into` receives the port's first raw gradients, by name."""
    opt, names = trainer.state.optimizer, list(trainer.state.params)
    step = opt.step

    def recording(params, grads):
        if not into:
            into.update((n, g.detach().numpy().copy())
                        for n, g in zip(names, grads))
        return step(params, grads)
    opt.step = recording


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


def _jax_fit(tmp, tag, perturb=0.0, first=None, **overrides):
    """JAX's fit on a one-device mesh, its initial weights scaled element
    by element by 1 + perturb x N(0, 1); returns (trainer, fit's result,
    initial variables). `first` receives the parameters after step 1;
    `overrides` go to the config."""
    x, y = _windows(12, 0)
    xv, yv = _windows(6, 1)
    os.environ["SELD_FUSED_STEM"] = "always"
    try:
        mesh = make_mesh("data:1", devices=jax.devices()[:1])
        jt = JaxTrainer(_config("run", **overrides), _model_config(),
                        n_classes=N_CLASSES, input_shape=SHAPE, mesh=mesh,
                        workdir=str(tmp / tag / "m"),
                        logdir=str(tmp / tag / "l"))
        if perturb:
            rng = np.random.RandomState(5)
            params = jax.tree_util.tree_map(
                lambda a: np.asarray(a) * (1 + perturb * rng.randn(
                    *np.shape(a))).astype(np.float32),
                jax.device_get(jt.state.params))
            with mesh:
                jt.state = jt.state.replace(params=replicate(params, mesh))
                jt.swa = replicate(SWAState.create(
                    params, jt.state.batch_stats), mesh)
        variables = jax.tree_util.tree_map(np.asarray, {
            "params": jax.device_get(jt.state.params),
            "batch_stats": jax.device_get(jt.state.batch_stats)})
        if first is not None:
            _capture_first_step(jt, lambda st: _flat(jax.tree_util.tree_map(
                np.asarray, st.params)), first)
        out = jt.fit(JaxDeviceDataset(x, y, 6, mesh, loop_time=1, seed=0),
                     JaxDeviceDataset(xv, yv, 3, mesh, train=False),
                     verbose=False)
    finally:
        del os.environ["SELD_FUSED_STEM"]
    return jt, out, variables


def _jax_ends(jt):
    """JAX's parameters and SWA average after fit, by name."""
    return tuple(_flat(jax.tree_util.tree_map(np.asarray, t))
                 for t in (jt.state.params, jt.swa.avg_params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's fit and the port's uninterrupted fit (which saves a checkpoint
    when epoch 2 starts) and its resumed fit from that checkpoint."""
    tmp = tmp_path_factory.mktemp("trainer")
    x, y = _windows(12, 0)
    xv, yv = _windows(6, 1)
    jax_first = {}
    jt, jax_out, variables = _jax_fit(tmp, "jax", first=jax_first)

    port = _port_trainer(tmp, "port", variables)
    port_first, port_grads = {}, {}
    _capture_first_step(port, lambda st: {
        n: p.detach().numpy().copy() for n, p in st.params.items()},
        port_first)
    _capture_first_grads(port, port_grads)
    saved = {}

    def save_at_epoch_2(tr, epoch):
        if epoch == 2:
            saved["path"] = save_checkpoint(
                str(tmp / "resume"), "after_epoch_1", tr.state, tr.swa,
                extra={"best_score": float(tr.best_score), "epoch": 1},
                aug_generator=tr.aug_generator)
    port_out = port.fit(*_port_data(x, y, xv, yv), eval_fn=save_at_epoch_2,
                        eval_every=1, verbose=False)

    resumed = _port_trainer(tmp, "resumed", variables)
    torch.nn.init.zeros_(next(resumed.model.parameters()))  # overwritten
    _, _, extra = restore_checkpoint(saved["path"], resumed.state,
                                     resumed.swa, resumed.aug_generator)
    resumed.best_score, resumed.start_epoch = extra["best_score"], 2
    train, val = _port_data(x, y, xv, yv)
    for _ in range(2):      # the dataset's shuffle is the dataset's own
        train._epoch_order()
    resumed_out = resumed.fit(train, val, verbose=False)
    return dict(tmp=tmp, jax=(jt, jax_out), port=(port, port_out),
                resumed=(resumed, resumed_out), variables=variables,
                init=_flat(variables["params"]),
                first=(jax_first, port_first, port_grads))


def _holds_jax_fit(tmp, jax_tag, port_tag, jt, jax_out, port, port_out):
    """Per-epoch losses, SELD scalars, the lr schedule, the SWA count and
    the best score of the port's fit against JAX's."""
    assert len(jax_out["history"]) == len(port_out["history"]) == EPOCHS
    for jh, ph in zip(jax_out["history"], port_out["history"]):
        for split in ("train", "val"):
            for key in ("sedLoss", "doaLoss"):
                np.testing.assert_allclose(ph[split][key], jh[split][key],
                                           rtol=LOSS_RTOL,
                                           err_msg=f"{split} {key}")
            for key in ("ErrorRate", "F", "DoaErrorRateF", "seldScore"):
                np.testing.assert_allclose(ph[split][key], jh[split][key],
                                           rtol=0, atol=SCORE_ATOL,
                                           err_msg=f"{split} {key}")
    want = _scalars(str(tmp / jax_tag / "l"), "run")
    got = _scalars(str(tmp / port_tag / "l"), "run")
    lrs = [np.float32(got[("train/lr", e)]) for e in range(EPOCHS)]
    assert lrs == [np.float32(want[("train/lr", e)]) for e in range(EPOCHS)]
    assert lrs[2] == np.float32(LR / 2)
    counts = [got[("train/swa_count", e)] for e in range(EPOCHS)]
    assert counts == [want[("train/swa_count", e)] for e in range(EPOCHS)]
    assert counts == [0.0, 0.0, 1.0, 2.0]
    assert port.best_score == pytest.approx(jt.best_score, abs=SCORE_ATOL)


def test_losses_scores_and_schedule_match_jax(runs):
    _holds_jax_fit(runs["tmp"], "jax", "port", *runs["jax"], *runs["port"])


def test_epoch_scan_fit_matches_jax_epoch_scan_fit(runs):
    """--epoch_scan on both sides (augment off): the port's epoch step (a
    plain loop on the CPU) against JAX's whole-epoch lax.scan, over the
    same 4 epochs, schedule and SWA as the eager fit."""
    tmp = runs["tmp"] / "scan"
    jt, jax_out, _ = _jax_fit(tmp, "jax", epoch_scan=True)
    port = _port_trainer(tmp, "port", runs["variables"], epoch_scan=True)
    port_out = port.fit(*_port_data(*_windows(12, 0), *_windows(6, 1)),
                        verbose=False)
    assert port._epoch_step is not None
    _holds_jax_fit(tmp, "jax", "port", jt, jax_out, port, port_out)


def _null_leaves(grads):
    top = max(np.abs(g).max() for g in grads.values())
    return {n for n, g in grads.items() if np.abs(g).max() < NULL_GRAD * top}


def test_first_step_parameters_match_jax(runs):
    want, got, grads = runs["first"]
    null = _null_leaves(grads)
    assert null and all(n.endswith("bias") for n in null)
    assert set(got) == set(want) == set(grads)
    for name, w in want.items():
        g = np.abs(grads[name])
        carried = SIGN_ATOL if name in null else np.minimum(
            SIGN_ATOL, LR * GRAD_NOISE * g.max() / np.maximum(g, 1e-30))
        np.testing.assert_array_less(np.abs(got[name] - w),
                                     PARAM_RTOL * np.abs(w).max() + carried,
                                     err_msg=name)


def _trajectory_gap(got, want, init, null):
    """(largest ||got - want|| / ||want - init|| over the leaves not in
    `null`, its leaf): the distance from JAX's end point in units of how
    far JAX's training moved the leaf."""
    return max((np.linalg.norm(got[n] - w) / np.linalg.norm(w - init[n]), n)
               for n, w in want.items() if n not in null)


def _port_ends(trainer):
    return tuple({n: p.detach().numpy() for n, p in t.items()}
                 for t in (trainer.state.params, trainer.swa.avg_params))


def test_parameters_and_swa_average_match_jax(runs):
    jt, _ = runs["jax"]
    port, _ = runs["port"]
    null = _null_leaves(runs["first"][2])
    for got, want in zip(_port_ends(port), _jax_ends(jt)):
        assert set(got) == set(want)
        for name in null:
            np.testing.assert_allclose(
                got[name], want[name], rtol=0,
                atol=SIGN_ATOL * EPOCHS * STEPS_PER_EPOCH, err_msg=name)
        gap, name = _trajectory_gap(got, want, runs["init"], null)
        print(f"port: {gap:.3e} at {name}")
        assert gap <= TRAJ_RTOL, (name, gap)
    assert port.swa.count == int(jt.swa.count) == 2


def _freeze(trainer, name):
    """Put leaf `name` back to its initial value after every step."""
    keep = trainer.state.params[name].detach().clone()
    step = trainer.train_step

    def frozen(state, *args, **kwargs):
        out = step(state, *args, **kwargs)
        with torch.no_grad():
            out[0].params[name].copy_(keep)
        return out
    trainer.train_step = frozen


@pytest.mark.parametrize("control", ["jax_perturbed", "l2_skipped",
                                     "leaf_frozen"])
def test_trajectory_limit_separates_noise_from_faults(runs, control):
    """The 4-epoch limit sits above JAX's own spread (its initial weights
    perturbed by 1e-7) and below what a fault gives: the L2 term skipped,
    or a large-norm leaf left at its initial value."""
    jt, _ = runs["jax"]
    null = _null_leaves(runs["first"][2])
    tmp = runs["tmp"] / control
    if control == "jax_perturbed":
        ends = _jax_ends(_jax_fit(tmp, "jax", perturb=1e-7)[0])
    else:
        trainer = _port_trainer(tmp, "port", runs["variables"],
                                **({"l2": 0.0} if control == "l2_skipped"
                                   else {}))
        if control == "leaf_frozen":
            _freeze(trainer, FROZEN)
        trainer.fit(*_port_data(*_windows(12, 0), *_windows(6, 1)),
                    verbose=False)
        ends = _port_ends(trainer)
    gap, name = max(_trajectory_gap(got, want, runs["init"], null)
                    for got, want in zip(ends, _jax_ends(jt)))
    print(f"{control}: {gap:.3e} at {name}")
    if control == "jax_perturbed":
        assert gap <= TRAJ_RTOL / 2, (name, gap)
    else:
        assert gap >= 10 * TRAJ_RTOL, (name, gap)


def test_resume_is_exact(runs):
    port, port_out = runs["port"]
    resumed, resumed_out = runs["resumed"]
    assert [h["epoch"] for h in resumed_out["history"]] == [2, 3]
    for a, b in zip(port_out["history"][2:], resumed_out["history"]):
        assert a["train"] == b["train"] and a["val"] == b["val"]
    for name, p in port.state.params.items():
        assert torch.equal(p, resumed.state.params[name]), name
    for name, s in port.state.batch_stats.items():
        assert torch.equal(s, resumed.state.batch_stats[name]), name
    for slot in ("m", "v"):
        for a, b in zip(getattr(port.state.optimizer, slot),
                        getattr(resumed.state.optimizer, slot)):
            assert torch.equal(a, b)
    assert port.state.optimizer.count == resumed.state.optimizer.count
    assert port.state.get_lr() == resumed.state.get_lr()
    assert port.state.step == resumed.state.step == EPOCHS * STEPS_PER_EPOCH
    assert torch.equal(port.state.generator.get_state(),
                       resumed.state.generator.get_state())
    assert torch.equal(port.aug_generator.get_state(),
                       resumed.aug_generator.get_state())
    assert port.swa.count == resumed.swa.count
    for name, a in port.swa.avg_params.items():
        assert torch.equal(a, resumed.swa.avg_params[name]), name
    assert port.best_score == resumed.best_score


def test_keep_best_only_and_latest_best(tmp_path, runs):
    port, _ = runs["port"]
    d = str(tmp_path / "ckpt")
    for score in (0.4123, 0.41, 0.5):
        save_checkpoint(d, f"bestscore_{score}", port.state, port.swa,
                        extra={"best_score": score}, keep_best_only=True)
    assert sorted(os.listdir(d)) == ["bestscore_0.5",
                                     "bestscore_0.5.meta.json"]
    save_checkpoint(d, "bestscore_0.3", port.state)
    assert latest_best(d).endswith("bestscore_0.3")
    assert latest_best(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _write_wav(path, data):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(4)
        w.setsampwidth(2)
        w.setframerate(24000)
        w.writeframes(data.tobytes())


def _write_wav_tree(root, folds=(1, 2, 5, 6), seconds=1.0):
    """foa_dev and mic_dev (the same stems, independent noise) and label
    CSVs. Each train clip's first 10 label frames are one event of class
    3, a single-class run TDM banks."""
    rng = np.random.RandomState(7)
    for sub in ("foa_dev", "mic_dev", "metadata_dev"):
        os.makedirs(root / sub)
    for i, fold in enumerate(folds):
        name = f"fold{fold}_room1_mix{i:03d}"
        for sub in ("foa_dev", "mic_dev"):
            _write_wav(root / sub / f"{name}.wav",
                       (rng.uniform(-0.3, 0.3, (int(24000 * seconds), 4))
                        * 32767).astype(np.int16))
        # events in every 60-frame label window: a batch without one has a
        # 0/0 DOA loss (MMSE_with_cls_weights, as in the reference)
        with open(root / "metadata_dev" / f"{name}.csv", "w") as f:
            first = 10 if fold <= 4 else 0
            for fr in range(first):
                f.write(f"{fr},3,0,{10 * i},{fr - 5}\n")
            for fr in range(first, 600, 7):
                f.write(f"{fr},{(i + fr) % 12},0,{10 * i},{fr % 90 - 45}\n")


@pytest.fixture
def cli_tree(tmp_path, monkeypatch):
    """A wav tree of four 1-s clips (train folds 1-2, val 5, test 6) and a
    narrow model config; the CLI writes ./config, ./saved_model and
    ./tensorboard_log under the test's directory."""
    _write_wav_tree(tmp_path)
    os.makedirs(tmp_path / "model_config")
    with open(tmp_path / "model_config" / "narrow.json", "w") as f:
        json.dump(_model_config(), f)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _argv(root, *extra):
    return ["--name", "cli", "--model", "conv_temporal", "--model_config",
            "narrow", "--doa_loss", "MMSE", "--abspath", str(root),
            "--from_wav", "--device_data", "--use_tfm", "--use_acs",
            "--agc", "true", "--batch", "2", "--loop_time", "1",
            "--epoch", "1", "--eval_every", "0", "--device", "cpu", *extra]


def test_cli_trains_from_wavs_and_resumes(cli_tree):
    # 1-s clips give 10 label frames: pad to 600 as the loader does, so each
    # clip holds 10 windows and the two train clips 20 (10 steps of 2)
    out = cli.main(_argv(cli_tree))
    run = "conv_temporal_narrow_MMSE_cli_v_0"
    assert out["trainer"].state.step == 10
    h = out["history"][0]
    assert np.isfinite(h["train"]["sedLoss"]) and h["val"] is not None
    assert os.path.exists(cli_tree / "saved_model" / run / "normalizer.npz")
    best = latest_best(str(cli_tree / "saved_model" / run))
    assert best is not None and os.path.exists(os.path.join(best,
                                                            "state.pt"))
    assert os.path.exists(cli_tree / "tensorboard_log" / run /
                          "scalars.jsonl")
    with np.load(cli_tree / "saved_model" / run / "normalizer.npz") as norm:
        assert norm["mean"].shape == norm["std"].shape == (1, 64, 7)
    again = cli.main(_argv(cli_tree, "--resume", "--epoch", "2"))
    assert out["trainer"].config.name == again["trainer"].config.name
    assert [h["epoch"] for h in again["history"]] == [1]
    assert again["trainer"].state.step == 20


@pytest.mark.parametrize("flags", [["--epoch_scan"],
                                   ["--epoch_scan", "--fuse_metrics"]],
                         ids=["epoch_scan", "fuse_metrics"])
def test_cli_trains_and_resumes_with_epoch_scan(cli_tree, flags):
    out = cli.main(_argv(cli_tree, *flags))
    trainer = out["trainer"]
    assert trainer._epoch_step is not None and trainer.state.step == 10
    h = out["history"][0]
    assert np.isfinite([h["train"]["sedLoss"], h["train"]["doaLoss"],
                        h["val"]["sedLoss"]]).all()
    again = cli.main(_argv(cli_tree, *flags, "--resume", "--epoch", "2"))
    assert again["trainer"].config.name == trainer.config.name
    assert again["trainer"].start_epoch == 1
    assert [h["epoch"] for h in again["history"]] == [1]
    assert again["trainer"].state.step == 20


@pytest.mark.parametrize("drop,flags,match", [
    ("--device_data", ["--epoch_scan"], "requires --device_data"),
    (None, ["--fuse_metrics"], "only applies to the --epoch_scan")])
def test_cli_checks_the_epoch_scan_flags(cli_tree, drop, flags, match):
    """The JAX CLI's two checks (scripts/train.py), with its messages."""
    argv = [a for a in _argv(cli_tree, *flags) if a != drop]
    with pytest.raises(ValueError, match=match):
        cli.main(argv)


def _write_feat_label_tree(root):
    """feat_label's offline layout for the four clips: FOA (7) and MIC
    (10) normalised features [3000, 64 * C] and labels [600, 48]."""
    rng = np.random.RandomState(8)
    base = root / "DCASE2021" / "feat_label"
    for i, fold in enumerate((1, 2, 5, 6)):
        name = f"fold{fold}_room1_mix{i:03d}.npy"
        labels = np.zeros((600, 48), np.float32)
        labels[::7, i % 12] = 1.0
        labels[::7, 12 + i % 12] = 1.0     # a unit DOA vector
        for kind, channels in (("foa", 7), ("mic", 10)):
            for sub in (f"{kind}_dev_norm", f"{kind}_dev_label"):
                os.makedirs(base / sub, exist_ok=True)
            np.save(base / f"{kind}_dev_norm" / name,
                    rng.randn(3000, 64 * channels).astype(np.float32))
            np.save(base / f"{kind}_dev_label" / name, labels)


@pytest.mark.parametrize("flags,channels", [
    (["--use_tdm", "--tdm_epoch", "1", "--epoch_scan"], 7),
    (["--wav_mode", "mic"], 10),
    (["--use_both", "--epoch_scan"], 17),
    (["--use_both", "--offline"], 17)],
    ids=["tdm_epoch_scan", "mic", "both_epoch_scan", "both_offline"])
def test_cli_trains_tdm_mic_and_joint_inputs_and_resumes(cli_tree, flags,
                                                         channels,
                                                         monkeypatch):
    """--use_tdm (a rebuild each epoch, restaged under --epoch_scan, the
    old split freed before the new one is staged), --from_wav --wav_mode
    mic and --use_both --use_acs (from wavs, and from feat_label's .npy
    files): finite losses, the model's input width, the normalizer's width
    and a resumed epoch."""
    staged = []

    class Recording(cli.DeviceDataset):
        def __init__(self, *args, train=True, **kwargs):
            if train:
                staged.append(all(ref() is None for ref in staged[1::2]))
            super().__init__(*args, train=train, **kwargs)
            if train:
                staged.append(weakref.ref(self.device_arrays[0]))
    monkeypatch.setattr(cli, "DeviceDataset", Recording)
    argv = _argv(cli_tree, *flags)
    if "--offline" in flags:
        _write_feat_label_tree(cli_tree)
        argv = [a for a in argv if a not in ("--offline", "--from_wav")]
    if "mic" in flags:        # the FOA aug takes no mic input
        argv.remove("--use_acs")
    out = cli.main(argv)
    trainer = out["trainer"]
    assert trainer.input_shape == (300, 64, channels)
    assert trainer.state.step == 10
    h = out["history"][0]
    assert np.isfinite([h["train"]["sedLoss"], h["train"]["doaLoss"],
                        h["val"]["sedLoss"]]).all()
    x_all = out["trainset"].device_arrays[0]
    assert x_all.shape[1:] == (300, 64, channels)
    run_dir = cli_tree / "saved_model" / trainer.config.name
    if "--from_wav" in argv:
        with np.load(run_dir / "normalizer.npz") as norm:
            assert norm["mean"].shape == (1, 64, channels)
    freed = staged[::2]
    assert freed == [True] * len(freed)
    if "--use_tdm" in flags:
        assert len(freed) == 1
        (rebuild,) = out["tdm_rebuilds"]
        assert set(rebuild) == {"epoch", "paste_s", "extract_s",
                                "normalize_window_s", "restage_s"}
        assert x_all.dtype == torch.float32
    # TDM resumes for two epochs: two rebuilds, the second restaged after
    # the first split was freed
    epochs = 3 if "--use_tdm" in flags else 2
    del staged[:]
    again = cli.main([*argv, "--resume", "--epoch", str(epochs)])
    assert [h["epoch"] for h in again["history"]] == list(range(1, epochs))
    assert again["trainer"].state.step == 10 * epochs
    assert np.isfinite(again["history"][0]["train"]["sedLoss"])
    if "--use_tdm" in flags:
        assert [r["epoch"] for r in again["tdm_rebuilds"]] == [1, 2]
        assert staged[::2] == [True, True]
        assert again["trainset"].device_arrays[0] is not x_all


def test_tdm_rebuilds_paste_bank_events(cli_tree):
    """The train clips' single-class runs make a bank, and a rebuild
    pastes from it into the audible frames without class 3 (2-s clips:
    frames 10-19): the rebuilt labels differ from the static split's."""
    from seld_tpu_torch.data.loader import load_wav_clips
    from seld_tpu_torch.data.tdm import build_event_banks
    root = cli_tree / "two_seconds"
    _write_wav_tree(root, seconds=2.0)
    wavs, labels = load_wav_clips(str(root / "foa_dev"),
                                  str(root / "metadata_dev"), "train",
                                  n_classes=12)
    banks = build_event_banks(list(zip(wavs, labels)), n_classes=12)
    assert banks[1][3].shape == (20, 48)
    argv = _argv(root, "--use_tdm", "--tdm_epoch", "1")
    out = cli.main([a for a in argv if a != "--device_data"])
    static, _ = cli.build_datasets(out["trainer"].config, "cpu")
    assert not np.array_equal(out["trainset"].y, static["train"].y)


@pytest.mark.parametrize("flags,match", [
    (["--use_tdm", "--use_both"], "FOA .7-channel. train set"),
    (["--use_tdm", "--wav_mode", "mic"], "FOA .7-channel. train set"),
    (["--wav_mode", "mic"], "the 10-channel mic input has neither")],
    ids=["tdm_both", "tdm_mic", "acs_mic"])
def test_cli_refuses_what_the_jax_cli_cannot_train(cli_tree, flags, match):
    """TDM's set is FOA, and --use_acs is an FOA or joint augment: on
    these pairs the JAX CLI fails at its first step, the port refuses
    them up front."""
    with pytest.raises(ValueError, match=match):
        cli.main(_argv(cli_tree, *flags))


def test_tdm_falls_back_to_the_static_set_without_wavs(cli_tree, capsys):
    """The JAX CLI's data rule: no foa_dev under --abspath, no TDM."""
    _write_feat_label_tree(cli_tree)
    os.rename(cli_tree / "foa_dev", cli_tree / "foa_dev_elsewhere")
    argv = [a for a in _argv(cli_tree, "--use_tdm") if a != "--from_wav"]
    out = cli.main(argv)
    assert "falling back to the static train set" in capsys.readouterr().out
    assert out["tdm_rebuilds"] is None and out["trainer"].state.step == 10


def test_cli_refuses_a_missing_card(cli_tree):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(_argv(cli_tree)[:-2])
