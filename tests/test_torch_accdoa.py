"""ACCDOA in the port (seld_tpu_torch/models/models.py::ACCDOA, the
trainer's ACCDOA objective) against seld_tpu's, and the full-width trees of
the rows the card drives: accdoa on SS5's config and SS5 with BLOCK2
swapped for each 1-D block (seld_tpu_torch/bench.py::BLOCK_ROWS).

  - full width (300, 64, 7): each row's state_dict keys and shapes equal
    the flax tree of `jax.eval_shape(model.init, ...)` (nothing compiles),
    the parameter counts equal the JAX model's, and `bridge.from_flax`
    loads that tree with no leaf left over or missing;
  - the model's contract (tests/test_beyond_parity.py's): sed (B, 60, C)
    in [0, 1] equal to min(||v_c||, 1), doa (B, 60, 3C);
  - narrowed (input (60, 32, 7), B=2): the eval and train forwards equal
    the JAX model's to FORWARD_ATOL;
  - the trainer's objective: the port's SELDTrainer and the JAX package's
    on `--model accdoa` give the same loss functions and weights (a zero
    SED loss; the doa loss by --doa_loss; (0, 1), or (0, w1) with
    --loss_weight), and one f32 step through them agrees: losses 1e-4
    relative, gradients 1e-4 of each leaf's largest element, parameters
    2e-5, running statistics 1e-5;
  - SELDTrainer.fit and the training CLI run `--model accdoa` for two
    epochs (one with the CLI) with sedLoss 0.0.
"""
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model import narrow_ss5, random_variables
from test_torch_trainer import _write_wav_tree
from test_torch_zoo_train import _flat, _recording

from seld_tpu.models import build_model as jax_build_model
from seld_tpu.train import metrics as JM
from seld_tpu.train.optimizers import adam as jax_adam
from seld_tpu.train.steps import make_train_step as jax_make_train_step
from seld_tpu.train.train_state import TrainState as JaxTrainState
from seld_tpu.train.trainer import SELDTrainer as JaxSELDTrainer
from seld_tpu_torch.bench import BLOCK_ROWS, block_row
from seld_tpu_torch.bridge import from_flax, to_flax
from seld_tpu_torch.data.loader import SeldDataset
from seld_tpu_torch.models import build_model
from seld_tpu_torch.train import main as cli
from seld_tpu_torch.train import metrics as TM
from seld_tpu_torch.train.optimizers import adam
from seld_tpu_torch.train.steps import make_train_step
from seld_tpu_torch.train.train_state import TrainState
from seld_tpu_torch.train.trainer import SELDTrainer

torch.set_num_threads(1)
FULL_SHAPE = (300, 64, 7)
NARROW_SHAPE = (60, 32, 7)
FORWARD_ATOL = 1e-4
LOSS_RTOL, GRAD_RTOL, NULL_GRAD = 1e-4, 1e-4, 1e-6
PARAM_ATOL, STATS_ATOL, LR = 2e-5, 1e-5, 1e-3
# parameters of each row at full width, as the JAX model counts them
ROW_PARAMS = {"accdoa": 1624196, "transformer": 2687888,
              "attention": 2664848, "conformer_relative_scan": 2666384,
              "rnn_lstm": 1917584, "rnn_gru": 1771152,
              "rnn_gru_dropout": 1771152, "tcn": 2541392,
              "identity": 1652048}


def _flax_shapes(model_name, cfg, shape):
    jm = jax_build_model(model_name, shape, cfg)
    return jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape)),
        train=False))


def test_rows_are_every_row_the_card_drives():
    assert sorted(ROW_PARAMS) == sorted(["accdoa", *BLOCK_ROWS])


@pytest.mark.parametrize("row", sorted(ROW_PARAMS))
def test_full_width_parameters_equal_the_flax_tree(row):
    model_name, cfg = block_row(row)
    shapes = _flax_shapes(model_name, cfg, FULL_SHAPE)
    model = build_model(model_name, FULL_SHAPE, cfg, device="cpu")
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, s: want.__setitem__(
            ".".join(p.key for p in path[1:]), tuple(s.shape)), shapes)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == want
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax \
        == ROW_PARAMS[row]
    variables = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    model.load_state_dict(from_flax(variables, model))
    assert all(bool((v == 0.5).all()) for v in model.state_dict().values())


def test_accdoa_model_contract():
    cfg = {"n_classes": 12, "first_pool_size": [5, 2],
           "BLOCK0": "tcn_stage", "BLOCK0_ARGS": {"filters": 32, "depth": 2}}
    model = build_model("accdoa", FULL_SHAPE, cfg, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, *FULL_SHAPE).astype(np.float32))
    with torch.inference_mode():
        sed, doa = model(x)
    assert sed.shape == (2, 60, 12) and doa.shape == (2, 60, 36)
    s = sed.numpy()
    assert (s >= 0).all() and (s <= 1).all()
    v = doa.numpy().reshape(2, 60, 3, 12)
    np.testing.assert_allclose(
        s, np.minimum(np.linalg.norm(v, axis=-2), 1.0), atol=1e-6)


def _narrow_accdoa():
    cfg = narrow_ss5()
    cfg["n_classes"] = 12
    cfg["BLOCK2_ARGS"]["dropout_rate"] = 0.0
    return cfg


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_narrow_forward_matches_jax(train):
    cfg = _narrow_accdoa()
    jm = jax_build_model("accdoa", NARROW_SHAPE, cfg)
    v = jax.tree_util.tree_map(np.asarray, random_variables(
        jm, NARROW_SHAPE))
    x = np.random.RandomState(2).randn(2, *NARROW_SHAPE).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=train,
                                         mutable=["batch_stats"])[0])(
        v, jnp.asarray(x))
    model = build_model("accdoa", NARROW_SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got[0].shape == (2, 12, 12) and got[1].shape == (2, 12, 36)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FORWARD_ATOL)


def _config(**kw):
    return argparse.Namespace(name="accdoa", model="accdoa", lr=LR,
                              batch=4, epoch=2, agc=True, sed_loss="BCE",
                              doa_loss="MSE", patience=100, lr_patience=5,
                              decay=0.5, swa_start=99, swa_freq=2,
                              mesh="data:-1", seed=0, **kw)


@pytest.mark.parametrize("loss_weight,want", [(None, (0.0, 1.0)),
                                              ("1,3", (0.0, 3.0))],
                         ids=["default", "given"])
def test_trainer_objective_matches_jax(loss_weight, want, tmp_path):
    """The two trainers' ACCDOA objective on --model accdoa, then one f32
    step of narrow accdoa through each (Adam, AGC 0.01, no L2)."""
    kw = {} if loss_weight is None else {"loss_weight": loss_weight}
    cfg = _narrow_accdoa()
    common = dict(n_classes=12, input_shape=NARROW_SHAPE,
                  use_class_weights=False, workdir=str(tmp_path / "m"),
                  logdir=str(tmp_path / "l"), metric_block_size=6)
    jt = JaxSELDTrainer(_config(**kw), cfg, **common)
    pt = SELDTrainer(_config(**kw), cfg, device="cpu", **common)
    assert jt.loss_weights == pt.loss_weights == want

    rng = np.random.RandomState(5)
    x = rng.randn(4, *NARROW_SHAPE).astype(np.float32)
    sed = (rng.rand(4, 12, 12) < 0.3).astype(np.float32)
    xyz = rng.randn(4, 12, 3, 12)
    xyz /= np.linalg.norm(xyz, axis=2, keepdims=True)
    doa = (xyz * sed[:, :, None]).reshape(4, 12, 36).astype(np.float32)
    jm = jax_build_model("accdoa", NARROW_SHAPE, cfg)
    v = jax.tree_util.tree_map(np.asarray, random_variables(
        jm, NARROW_SHAPE))

    state = JaxTrainState.create(
        apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
        tx=optax.chain(_recording(), jax_adam(LR, agc_clip=0.01)),
        rng=jax.random.PRNGKey(0))
    step = jax_make_train_step(sed_loss_fn=jt.sed_loss,
                               doa_loss_fn=jt.doa_loss,
                               loss_weights=jt.loss_weights,
                               metric_block_size=6, donate=False)
    state, _, (jsl, jdl) = step(state, JM.init_state(12), jnp.asarray(x),
                                (jnp.asarray(sed), jnp.asarray(doa)))
    want_g = _flat(jax.tree_util.tree_map(np.asarray, state.opt_state[0]))
    want_p = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    want_s = _flat(jax.tree_util.tree_map(np.asarray, state.batch_stats))

    model = build_model("accdoa", NARROW_SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    tstate = TrainState(model, adam(list(model.parameters()), LR,
                                    agc_clip=0.01))
    grads, names = {}, list(tstate.params)
    opt_step = tstate.optimizer.step

    def recording_step(ps, gs):
        grads.update((n, g.detach().numpy().copy())
                     for n, g in zip(names, gs))
        opt_step(ps, gs)
    tstate.optimizer.step = recording_step
    tstep = make_train_step(sed_loss_fn=pt.sed_loss, doa_loss_fn=pt.doa_loss,
                            loss_weights=pt.loss_weights,
                            metric_block_size=6)
    _, _, (tsl, tdl) = tstep(tstate, TM.init_state(12, "cpu"),
                             torch.from_numpy(x),
                             (torch.from_numpy(sed), torch.from_numpy(doa)))
    assert float(jsl) == tsl.item() == 0.0
    np.testing.assert_allclose(tdl.item(), float(jdl), rtol=LOSS_RTOL)
    got = to_flax(model)
    got_p, got_s = _flat(got["params"]), _flat(got["batch_stats"])
    assert set(grads) == set(want_g)
    null_at = NULL_GRAD * max(np.abs(g).max() for g in want_g.values())
    for n, w in want_g.items():
        if np.abs(w).max() < null_at:
            assert n.endswith("bias"), n
            assert np.abs(grads[n]).max() < null_at, n
            continue
        np.testing.assert_allclose(grads[n], w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max()
                                   + null_at, err_msg=n)
        np.testing.assert_allclose(got_p[n], want_p[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    for n, w in want_s.items():
        np.testing.assert_allclose(got_s[n], w, rtol=0, atol=STATS_ATOL,
                                   err_msg=n)


def test_seld_trainer_fits_accdoa(tmp_path):
    """tests/test_beyond_parity.py's trainer journey in the port: two
    epochs of `--model accdoa`, the SED loss disabled."""
    n_classes = 4
    rng = np.random.RandomState(0)
    feats = [rng.randn(100, 16, 7).astype(np.float32) for _ in range(2)]
    labs = []
    for _ in range(2):
        s = (rng.rand(20, n_classes) < 0.2).astype(np.float32)
        s[::10, 0] = 1.0                    # an event in every window
        v = rng.randn(20, 3, n_classes)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        labs.append(np.concatenate(
            [s, (v * s[:, None]).reshape(20, 3 * n_classes)],
            axis=-1).astype(np.float32))
    train_ds = SeldDataset.from_clips(feats, labs, batch_size=4, train=True,
                                      label_window_size=10)
    val_ds = SeldDataset.from_clips(feats, labs, batch_size=4, train=False,
                                    label_window_size=10)
    model_config = {"first_pool_size": [5, 2], "BLOCK0": "tcn_stage",
                    "BLOCK0_ARGS": {"filters": 16, "depth": 1}}
    trainer = SELDTrainer(
        _config(), model_config, n_classes=n_classes,
        input_shape=(50, 16, 7), device="cpu", use_class_weights=False,
        workdir=str(tmp_path / "m"), logdir=str(tmp_path / "l"),
        metric_block_size=5)
    result = trainer.fit(train_ds, val_ds, verbose=False)
    hist = result["history"]
    assert len(hist) == 2 and np.isfinite(result["best_score"])
    assert all(h["train"]["sedLoss"] == 0.0 for h in hist)
    assert hist[1]["train"]["doaLoss"] < hist[0]["train"]["doaLoss"] * 1.5


def test_cli_trains_accdoa_from_wavs(tmp_path, monkeypatch):
    """`python -m seld_tpu_torch.train --model accdoa` (its main, on the
    CPU) on a tiny wav tree: one epoch with --epoch_scan, its resume, and
    every history line with sedLoss 0.0."""
    _write_wav_tree(tmp_path)
    os.makedirs(tmp_path / "model_config")
    cfg = _narrow_accdoa()
    with open(tmp_path / "model_config" / "narrow.json", "w") as f:
        json.dump(cfg, f)
    monkeypatch.chdir(tmp_path)
    argv = ["--name", "acc", "--model", "accdoa", "--model_config",
            "narrow", "--doa_loss", "MSE", "--abspath", str(tmp_path),
            "--from_wav", "--device_data", "--epoch_scan", "--batch", "2",
            "--loop_time", "1", "--epoch", "1", "--eval_every", "0",
            "--device", "cpu"]
    out = cli.main(argv)
    again = cli.main([*argv, "--resume", "--epoch", "2"])
    assert out["trainer"].loss_weights == (0.0, 1000.0)
    hist = out["history"] + again["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(h[s]["sedLoss"] == 0.0 for h in hist for s in ("train", "val"))
    assert all(np.isfinite(h["train"]["doaLoss"]) for h in hist)
    assert again["trainer"].state.step == 20
