"""The port's SS5 training step (seld_tpu_torch/train/steps.py) against the
JAX package's `make_train_step` on the same weights and batches, plus the
pieces around it: the L2 kernel penalty, bf16 compute over f32 masters,
the dropout generator a `TrainState` hands to the model, the bench's MAC
count, and the card-only entry points refusing to run without a card.

SS5 is narrowed (tests/test_torch_model.py::narrow_ss5) with every dropout
zeroed; the batch is [4, 60, 16, 7]. Both sides take the fused stem (the
JAX one through SELD_FUSED_STEM=always, its dy pass in interpret mode),
class-weighted BCE + 1000 x class-weighted masked MSE + L2 1e-3, AGC 0.01
and AdaBelief at lr 1e-3.

Tolerances (f32):
  - losses, 1e-4 relative at every step: the first step agrees to ~1e-6,
    and each AdaBelief step moves every parameter by about lr whatever its
    gradient's size, so rounding in one step reaches the next one's loss
    only through elements whose gradient is itself noise;
  - some gradients are zero in exact arithmetic (the bias of a conv that
    feeds a train-mode BatchNorm, attention's key bias): a leaf whose
    first-step JAX gradient stays below NULL_GRAD (1e-6) of that step's
    largest gradient element is one of them, and its first-step gradient
    must stay below that level on both sides; every other first-step
    gradient agrees to GRAD_RTOL (1e-4) of its largest element;
  - parameters after 5 steps, 2e-5 absolute (~1% of a step of lr = 1e-3:
    an element whose gradient differs in the last bits moves by the same
    ~lr), for every leaf whose gradient is not null. A null leaf moves by
    AdaBelief's response to rounding noise, so its trajectory is not
    compared;
  - BatchNorm running variances, 1e-5 absolute; running means, 1e-5 plus
    (1 - momentum) x 2 x 1.2 lr x steps, since every BatchNorm here follows
    a conv whose bias has a null gradient, the two sides' biases may drift
    apart by at most 1.2 lr a step each, and the batch mean carries them.
"""
import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model import narrow_ss5, random_variables

from seld_tpu.data import transforms as JT
from seld_tpu.models import build_model as jax_build_model
from seld_tpu.nas.complexity import conv_temporal_complexity as jax_cx
from seld_tpu.train import losses as JL
from seld_tpu.train import metrics as JM
from seld_tpu.train.optimizers import adabelief as jax_adabelief
from seld_tpu.train.steps import l2_kernel_penalty as jax_l2
from seld_tpu.train.steps import make_train_step as jax_make_train_step
from seld_tpu.train.train_state import TrainState as JaxTrainState
from seld_tpu_torch import bench
from seld_tpu_torch.bridge import from_flax, to_flax
from seld_tpu_torch.config import get_model_config
from seld_tpu_torch.data import transforms as T
from seld_tpu_torch.models import build_model
from seld_tpu_torch.nas.complexity import conv_temporal_complexity
from seld_tpu_torch.ops import dropout as D
from seld_tpu_torch.train import losses as TL
from seld_tpu_torch.train import metrics as TM
from seld_tpu_torch.train.optimizers import adabelief
from seld_tpu_torch.train.steps import l2_kernel_penalty, make_train_step
from seld_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)
INPUT_SHAPE = (60, 16, 7)
B, N_CLASSES, STEPS, LR = 4, 12, 5, 1e-3
BLOCK = 6            # metric block: 12 label frames per window
LOSS_RTOL, PARAM_ATOL, STATS_ATOL = 1e-4, 2e-5, 1e-5
GRAD_RTOL, NULL_GRAD = 1e-4, 1e-6


def _config():
    cfg = narrow_ss5()
    for key in ("BLOCK0", "BLOCK1", "BLOCK2", "SED", "DOA"):
        cfg.setdefault(f"{key}_ARGS", {})["dropout_rate"] = 0.0
    cfg["n_classes"] = N_CLASSES
    return cfg


def _batches(n, shape=INPUT_SHAPE):
    out = []
    for s in range(n):
        rng = np.random.RandomState(100 + s)
        x = rng.randn(B, *shape).astype(np.float32)
        sed = (rng.rand(B, 12, N_CLASSES) < 0.2).astype(np.float32)
        doa = (np.clip(rng.randn(B, 12, 3 * N_CLASSES), -1, 1)
               * np.repeat(sed, 3, axis=-1)).astype(np.float32)
        out.append((x, sed, doa))
    return out


def _torch_step(cw, compute_dtype=None, l2=1e-3):
    return make_train_step(
        sed_loss_fn=lambda y, p: TL.sed_loss_with_weights(y, p, cw),
        doa_loss_fn=lambda y, p: TL.MMSE_with_cls_weights(y, p, cw),
        loss_weights=(1.0, 1000.0), l2=l2, compute_dtype=compute_dtype,
        metric_block_size=BLOCK)


def _torch_run(variables, batches, compute_dtype=None, grads=None,
               shape=INPUT_SHAPE):
    """Runs the port's step over `batches`; when `grads` is a dict, it
    receives the first step's raw gradients by parameter name."""
    model = build_model("conv_temporal", shape, _config(), device="cpu")
    model.load_state_dict(from_flax(variables, model))
    state = TrainState(model, adabelief(list(model.parameters()), LR,
                                        agc_clip=0.01))
    if grads is not None:
        names, opt_step = list(state.params), state.optimizer.step

        def recording_step(ps, gs):
            if not grads:
                grads.update((n, g.detach().numpy().copy())
                             for n, g in zip(names, gs))
            opt_step(ps, gs)
        state.optimizer.step = recording_step
    cw = TL.class_weights_from_samples(TL.DCASE2021_TRAIN_SAMPLES)
    step = _torch_step(cw, compute_dtype)
    metric, losses = TM.init_state(N_CLASSES, "cpu"), []
    for x, sed, doa in batches:
        state, metric, (sl, dl) = step(
            state, metric, torch.from_numpy(x),
            (torch.from_numpy(sed), torch.from_numpy(doa)))
        losses.append((sl.item(), dl.item()))
    return state, metric, np.asarray(losses)


def _recording():
    """An identity gradient transformation whose state is the last raw
    gradient it was handed."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


def test_f32_trajectory_matches_jax_make_train_step(monkeypatch):
    monkeypatch.setenv("SELD_FUSED_STEM", "always")
    cfg = _config()
    jm = jax_build_model("conv_temporal", INPUT_SHAPE, cfg)
    variables = jax.tree_util.tree_map(np.asarray,
                                       random_variables(jm, INPUT_SHAPE))
    batches = _batches(STEPS)

    cw = JL.class_weights_from_samples(JL.DCASE2021_TRAIN_SAMPLES)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=optax.chain(_recording(), jax_adabelief(LR, agc_clip=0.01)),
        rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(
        sed_loss_fn=lambda y, p: JL.sed_loss_with_weights(y, p, cw),
        doa_loss_fn=lambda y, p: JL.MMSE_with_cls_weights(y, p, cw),
        loss_weights=(1.0, 1000.0), l2=1e-3, metric_block_size=BLOCK,
        donate=False)
    jmetric, want_losses = JM.init_state(N_CLASSES), []
    for x, sed, doa in batches:
        jstate, jmetric, (sl, dl) = jstep(
            jstate, jmetric, jnp.asarray(x),
            (jnp.asarray(sed), jnp.asarray(doa)))
        want_losses.append((float(sl), float(dl)))
        if len(want_losses) == 1:
            want_g = _flat(jax.tree_util.tree_map(np.asarray,
                                                  jstate.opt_state[0]))

    got_g = {}
    state, metric, losses = _torch_run(variables, batches, grads=got_g)
    np.testing.assert_allclose(losses, np.asarray(want_losses),
                               rtol=LOSS_RTOL)
    assert state.step == STEPS and losses[-1].sum() < losses[0].sum()

    assert set(got_g) == set(want_g)
    null_at = NULL_GRAD * max(np.abs(g).max() for g in want_g.values())
    null = {n for n, g in want_g.items() if np.abs(g).max() < null_at}
    assert null and all(n.endswith("bias") for n in null)
    for name, w in want_g.items():
        if name in null:
            assert np.abs(got_g[name]).max() < null_at, name
        else:
            np.testing.assert_allclose(got_g[name], w, rtol=0,
                                       atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=name)

    got = to_flax(state.model)
    want_p = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    got_p = _flat(got["params"])
    assert set(got_p) == set(want_p)
    moved = 0.0
    for name, w in want_p.items():
        if name not in null:
            np.testing.assert_allclose(got_p[name], w, rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
        moved = max(moved, np.abs(w - _flat(variables["params"])[name])
                    .max())
    assert moved > STEPS * LR
    want_s = _flat(jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    for name, w in _flat(got["batch_stats"]).items():
        atol = STATS_ATOL + (name.endswith("mean")
                             * (1 - 0.99) * 2 * 1.2 * LR * STEPS)
        np.testing.assert_allclose(w, want_s[name], rtol=0, atol=atol,
                                   err_msg=name)
    for key, w in jmetric.items():
        np.testing.assert_allclose(metric[key].numpy(), np.asarray(w),
                                   rtol=1e-5, err_msg=key)


def test_joint_input_step_through_acs_aug_matches_jax(monkeypatch):
    """The joint 17-channel FOA+MIC input: each batch through acs_aug
    (the port's application on JAX's draws, bitwise equal), then 3 steps
    on both sides: the losses of every step at LOSS_RTOL and the first
    step's gradients at GRAD_RTOL (with the null rule), this file's
    tolerances. The update that follows the gradients is the optimizer's,
    whatever the input width (test_f32_trajectory_... holds it)."""
    monkeypatch.setenv("SELD_FUSED_STEM", "always")
    shape, steps = (60, 16, 17), 3
    cfg = _config()
    jm = jax_build_model("conv_temporal", shape, cfg)
    variables = jax.tree_util.tree_map(np.asarray,
                                       random_variables(jm, shape))
    batches = []
    for s, (x, sed, doa) in enumerate(_batches(steps, shape)):
        key = jax.random.PRNGKey(40 + s)
        y = np.concatenate([sed, doa], axis=-1)
        want_x, want_y = JT.acs_aug(key, jnp.asarray(x), jnp.asarray(y))
        idx = np.array(jax.random.randint(key, (B,), 0, 8))
        got_x, got_y = T.acs_aug_apply(torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       torch.from_numpy(idx))
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
        batches.append((got_x.numpy(), got_y.numpy()[..., :N_CLASSES],
                        got_y.numpy()[..., N_CLASSES:]))

    cw = JL.class_weights_from_samples(JL.DCASE2021_TRAIN_SAMPLES)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=optax.chain(_recording(), jax_adabelief(LR, agc_clip=0.01)),
        rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(
        sed_loss_fn=lambda y, p: JL.sed_loss_with_weights(y, p, cw),
        doa_loss_fn=lambda y, p: JL.MMSE_with_cls_weights(y, p, cw),
        loss_weights=(1.0, 1000.0), l2=1e-3, metric_block_size=BLOCK,
        donate=False)
    want_losses = []
    jmetric = JM.init_state(N_CLASSES)
    for x, sed, doa in batches:
        jstate, jmetric, (sl, dl) = jstep(
            jstate, jmetric, jnp.asarray(x),
            (jnp.asarray(sed), jnp.asarray(doa)))
        want_losses.append((float(sl), float(dl)))
        if len(want_losses) == 1:
            want_g = _flat(jax.tree_util.tree_map(np.asarray,
                                                  jstate.opt_state[0]))

    got_g = {}
    state, _, losses = _torch_run(variables, batches, grads=got_g,
                                  shape=shape)
    np.testing.assert_allclose(losses, np.asarray(want_losses),
                               rtol=LOSS_RTOL)
    assert state.step == steps
    assert got_g["Conv2DBN_0.Conv_0.kernel"].shape == (7, 7, 17, 8)
    assert set(got_g) == set(want_g)
    null_at = NULL_GRAD * max(np.abs(g).max() for g in want_g.values())
    for name, w in want_g.items():
        if np.abs(w).max() < null_at:
            assert np.abs(got_g[name]).max() < null_at, name
        else:
            np.testing.assert_allclose(got_g[name], w, rtol=0,
                                       atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=name)


def test_l2_kernel_penalty_matches_jax_on_bridged_params():
    cfg = _config()
    jm = jax_build_model("conv_temporal", INPUT_SHAPE, cfg)
    variables = jax.tree_util.tree_map(np.asarray,
                                       random_variables(jm, INPUT_SHAPE))
    model = build_model("conv_temporal", INPUT_SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(variables, model))
    params = dict(model.named_parameters())
    got = l2_kernel_penalty(params, 1e-3)
    want = jax_l2(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                  1e-3)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert l2_kernel_penalty(params, 0.0).item() == 0.0
    # the GRU stage's leaves are all skipped
    gru = {k: v for k, v in params.items() if ".GRU_" in k}
    assert gru and l2_kernel_penalty(gru, 1e-3).item() == 0.0


def test_bf16_trajectory_tracks_f32():
    """bf16 compute over f32 masters stays within 5% of the f32 losses at
    every step (as the JAX package's tests/test_train_core.py holds it),
    the master parameters stay f32 and receive f32 gradients."""
    jm = jax_build_model("conv_temporal", INPUT_SHAPE, _config())
    variables = jax.tree_util.tree_map(np.asarray,
                                       random_variables(jm, INPUT_SHAPE))
    batches = _batches(STEPS)
    _, _, l32 = _torch_run(variables, batches)
    state, metric, l16 = _torch_run(variables, batches, torch.bfloat16)
    np.testing.assert_allclose(l16, l32, rtol=0.05)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for b in state.model.buffers())
    assert float(metric["Nref"]) > 0


def test_dropout_mask_follows_the_generator():
    x = torch.ones(64, 32)

    def mask(seed):
        gen = torch.Generator().manual_seed(seed)
        return D.dropout(x, 0.3, True, gen) == 0

    assert torch.equal(mask(1), mask(1))
    assert not torch.equal(mask(1), mask(2))
    kept = D.dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    vals = kept.unique()
    assert ((vals == 0) | torch.isclose(vals, torch.tensor(1 / 0.7))).all()
    assert torch.equal(D.dropout(x, 0.3, False), x)
    assert torch.equal(D.dropout(x, 1.0, True), torch.zeros_like(x))


def test_train_state_hands_its_generator_to_every_dropout():
    """With dropout on, two models from one seed give the same training
    losses, and another state seed gives other ones."""
    cfg = copy.deepcopy(narrow_ss5())
    cfg["n_classes"] = N_CLASSES
    x, sed, doa = _batches(1)[0]
    cw = TL.class_weights_from_samples(TL.DCASE2021_TRAIN_SAMPLES)

    def first_loss(seed):
        model = build_model("conv_temporal", INPUT_SHAPE, cfg, seed=0,
                            device="cpu")
        state = TrainState(model, adabelief(list(model.parameters()), LR),
                           seed=seed)
        users = [m for m in model.modules()
                 if hasattr(m, "dropout_generator")]
        assert users and all(m.dropout_generator is state.generator
                             for m in users)
        _, _, (sl, dl) = _torch_step(cw)(
            state, TM.init_state(N_CLASSES, "cpu"), torch.from_numpy(x),
            (torch.from_numpy(sed), torch.from_numpy(doa)))
        return sl.item(), dl.item()

    assert first_loss(3) == first_loss(3)
    assert first_loss(3) != first_loss(4)


@pytest.mark.parametrize("config", ["SS5", "narrow"])
def test_complexity_copy_matches_jax(config):
    cfg = (get_model_config("SS5", search_paths=[]) if config == "SS5"
           else narrow_ss5())
    shape = (300, 64, 7) if config == "SS5" else INPUT_SHAPE
    got, got_shapes = conv_temporal_complexity(copy.deepcopy(cfg), shape)
    want, want_shapes = jax_cx(copy.deepcopy(cfg), shape)
    assert got == want
    assert [list(s) for s in got_shapes] == [list(s) for s in want_shapes]
    if config == "SS5":
        assert bench.gflops_per_window(bench.ss5_config()) == pytest.approx(
            6 * want["flops"] / 1e9)


def test_robust_window_time_drops_a_slow_first_window():
    times = iter([2.0, 1.0, 1.1])
    per, seen, anomaly = bench.robust_window_time(lambda: next(times),
                                                  n_windows=3)
    assert anomaly and seen == [2.0, 1.0, 1.1] and per == pytest.approx(1.05)
    times = iter([1.0, 1.1])
    per, _, anomaly = bench.robust_window_time(lambda: next(times))
    assert not anomaly and per == pytest.approx(1.05)


@pytest.mark.parametrize("module", ["seld_tpu_torch.bench",
                                    "seld_tpu_torch.profile_step",
                                    "seld_tpu_torch.bench_feed",
                                    "seld_tpu_torch.bench_infer",
                                    "seld_tpu_torch.make_answer",
                                    "seld_tpu_torch.search_best",
                                    "seld_tpu_torch.dress_rehearsal",
                                    "seld_tpu_torch.stream_demo",
                                    "seld_tpu_torch.predict_wav"])
def test_card_entry_points_fail_without_a_card(module):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", module], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
