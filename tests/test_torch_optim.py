"""The port's optimizers and training state (seld_tpu_torch/train/
optimizers.py, train_state.py) against the JAX package's: unit-wise norms
for every rank, AGC, the reference AdaBelief with and without AGC (and
amsgrad) and Adam over a shared 100-step gradient stream, the learning
rate read and set mid-stream, and the SWA average.

Tolerance: 1e-5 relative / 1e-6 absolute on parameters after 100 steps.
Each step moves a parameter by about lr = 1e-3 through the same f32
formulas; the two frameworks round the bias corrections and the square
roots independently, so the trajectories drift apart by a few f32 ulps.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seld_tpu.train import optimizers as JO
from seld_tpu.train.train_state import SWAState as JaxSWA
from seld_tpu_torch.train import optimizers as TO
from seld_tpu_torch.train.train_state import SWAState, TrainState

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
STEPS = 100
LR = 1e-3
# every rank AGC's unit-wise norm knows: a scalar, a zero-initialised bias,
# dense [I, O], GRU [D, I, 3U] and conv HWIO kernels
SHAPES = [(), (5,), (7, 5), (3, 4, 6), (3, 3, 2, 4)]


def _init_params():
    rng = np.random.RandomState(0)
    out = [np.asarray(rng.randn(*s), np.float32) for s in SHAPES]
    out[1][:] = 0.0
    return out


def _grads_at(t):
    r = np.random.RandomState(1000 + t)
    return [np.asarray(r.randn(*s) * 0.1, np.float32) for s in SHAPES]


@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 2, 2, 2)],
                         ids=lambda s: f"rank{len(s)}")
def test_unitwise_norm(shape):
    x = np.asarray(np.random.RandomState(1).randn(*shape), np.float32)
    if len(shape) > 4:
        with pytest.raises(ValueError):
            TO.unitwise_norm(torch.from_numpy(x))
        return
    got = TO.unitwise_norm(torch.from_numpy(x))
    want = np.asarray(JO.unitwise_norm(jnp.asarray(x)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_adaptive_clip_grad_clips_some_units_and_matches():
    params = _init_params()
    grads = [np.asarray(g * s, np.float32) for g, s in
             zip(_grads_at(0), (1.0, 1e-4, 1.0, 0.01, 1.0))]
    got = TO.adaptive_clip_grad([torch.from_numpy(p) for p in params],
                                [torch.from_numpy(g) for g in grads], 0.01)
    want = JO.adaptive_clip_grad([jnp.asarray(p) for p in params],
                                 [jnp.asarray(g) for g in grads], 0.01)
    clipped = 0
    for g, a, w in zip(grads, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)
        clipped += int(not np.allclose(a.numpy(), g))
    assert 0 < clipped < len(SHAPES)


def _run_jax(tx, lr_change=None):
    params = [jnp.asarray(p) for p in _init_params()]
    state = tx.init(params)
    update = jax.jit(tx.update)
    for t in range(STEPS):
        if lr_change is not None and t == STEPS // 2:
            hp = dict(state.hyperparams)
            hp["learning_rate"] = jnp.asarray(lr_change, jnp.float32)
            state = state._replace(hyperparams=hp)
        updates, state = update([jnp.asarray(g) for g in _grads_at(t)],
                                state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


def _run_torch(make, lr_change=None):
    params = [torch.from_numpy(p) for p in _init_params()]
    opt = make(params)
    for t in range(STEPS):
        if lr_change is not None and t == STEPS // 2:
            opt.lr = lr_change
        opt.step(params, [torch.from_numpy(g) for g in _grads_at(t)])
    return [p.numpy() for p in params]


@pytest.mark.parametrize("agc,amsgrad", [(None, False), (0.01, False),
                                         (0.01, True)])
def test_adabelief_matches_jax_over_100_steps(agc, amsgrad):
    want = _run_jax(JO.adabelief(LR, amsgrad=amsgrad, agc_clip=agc))
    got = _run_torch(lambda ps: TO.adabelief(ps, LR, amsgrad=amsgrad,
                                             agc_clip=agc))
    for g, w, p0 in zip(got, want, _init_params()):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    moved = max(np.abs(g - p).max() for g, p in zip(got, _init_params()))
    assert moved > 10 * LR


@pytest.mark.parametrize("agc", [None, 0.01])
def test_adam_matches_jax_over_100_steps(agc):
    want = _run_jax(JO.adam(LR, agc_clip=agc))
    got = _run_torch(lambda ps: TO.adam(ps, LR, agc_clip=agc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_learning_rate_read_and_set_mid_stream():
    """TrainState.get_lr/set_lr against optax.inject_hyperparams, the way
    the JAX TrainState exposes its learning rate."""
    tx = optax.inject_hyperparams(JO.adabelief)(learning_rate=LR,
                                                agc_clip=0.01)
    want = _run_jax(tx, lr_change=LR / 10)

    params = [torch.from_numpy(p) for p in _init_params()]
    model = torch.nn.Module()
    for i, p in enumerate(params):
        model.register_parameter(f"p{i}", torch.nn.Parameter(p))
    state = TrainState(model, TO.adabelief(list(model.parameters()), LR,
                                           agc_clip=0.01))
    assert state.get_lr() == LR
    for t in range(STEPS):
        if t == STEPS // 2:
            assert state.set_lr(LR / 10) is state
        state.optimizer.step(list(model.parameters()),
                             [torch.from_numpy(g) for g in _grads_at(t)])
    assert state.get_lr() == pytest.approx(LR / 10)
    for g, w in zip(model.parameters(), want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)


def test_swa_averages_params_and_batch_stats():
    rng = np.random.RandomState(2)
    snaps = [({"w": rng.randn(3, 2).astype(np.float32)},
              {"mean": rng.randn(2).astype(np.float32)}) for _ in range(4)]
    want = JaxSWA.create(*snaps[0])
    got = SWAState({k: torch.from_numpy(v) for k, v in snaps[0][0].items()},
                   {k: torch.from_numpy(v) for k, v in snaps[0][1].items()})
    assert not got.available
    for p, s in snaps:
        want = want.update(p, s)
        got.update({k: torch.from_numpy(v) for k, v in p.items()},
                   {k: torch.from_numpy(v) for k, v in s.items()})
    assert got.available and got.count == 4
    np.testing.assert_allclose(got.avg_params["w"].numpy(),
                               np.asarray(want.avg_params["w"]), rtol=1e-6)
    np.testing.assert_allclose(got.avg_batch_stats["mean"].numpy(),
                               np.asarray(want.avg_batch_stats["mean"]),
                               rtol=1e-6)
    assert got.should_update(5, 3, 2) == want.should_update(5, 3, 2)
    assert got.should_update(4, 3, 2) == want.should_update(4, 3, 2)


@pytest.mark.parametrize("name", ["adabelief", "adam"])
def test_count_and_lr_are_device_tensors_that_track_jax(name):
    """The count and the learning rate are 0-dim f32 tensors on the
    parameters' device, read back as an int and the float last set; after
    100 steps the count is JAX's and the update uses the lr tensor."""
    tx = getattr(JO, name)(LR)
    params = [jnp.asarray(p) for p in _init_params()]
    jstate = tx.init(params)
    update = jax.jit(tx.update)
    for t in range(STEPS):
        _, jstate = update([jnp.asarray(g) for g in _grads_at(t)], jstate,
                           params)
    opt = getattr(TO, name)([torch.from_numpy(p) for p in _init_params()],
                            LR)
    for t in range(STEPS):
        opt.step([torch.from_numpy(p) for p in _init_params()],
                 [torch.from_numpy(g) for g in _grads_at(t)])
    for tensor in (opt._count, opt._lr):
        assert tensor.dim() == 0 and tensor.dtype == torch.float32
        assert tensor.device == torch.device("cpu")
    jcount = [leaf for leaf in jax.tree_util.tree_leaves(jstate)
              if np.shape(leaf) == () and np.asarray(leaf).dtype == np.int32]
    assert opt.count == STEPS == int(jcount[0])
    assert opt.lr == LR and opt._lr.item() == np.float32(LR)


def test_set_lr_between_calls_takes_effect():
    """A step that reads the lr tensor it was built over (as a captured
    graph does) sees `set_lr` between calls: the lr is written in place."""
    params = [torch.from_numpy(p) for p in _init_params()]
    model = torch.nn.Module()
    for i, p in enumerate(params):
        model.register_parameter(f"p{i}", torch.nn.Parameter(p))
    state = TrainState(model, TO.adabelief(list(model.parameters()), LR,
                                           agc_clip=0.01))
    lr_tensor, count_tensor = state.optimizer._lr, state.optimizer._count
    grads = [torch.zeros_like(p) for p in params]

    def call(t):   # the body: reads nothing from the host but the grads
        for g, new in zip(grads, _grads_at(t)):
            g.copy_(torch.from_numpy(new))
        state.optimizer.step(list(model.parameters()), grads)

    tx = optax.inject_hyperparams(JO.adabelief)(learning_rate=LR,
                                                agc_clip=0.01)
    want = _run_jax(tx, lr_change=LR / 10)
    for t in range(STEPS):
        if t == STEPS // 2:
            state.set_lr(LR / 10)
        call(t)
    assert state.optimizer._lr is lr_tensor
    assert state.optimizer._count is count_tensor
    assert lr_tensor.item() == np.float32(LR / 10)
    for g, w in zip(model.parameters(), want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)


def test_a_checkpoint_written_before_the_tensor_count_loads(tmp_path):
    """A checkpoint that stores the count as an int and the lr as a float
    (the port's format) restores into the existing tensors."""
    from seld_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    model = torch.nn.Linear(3, 2)
    state = TrainState(model, TO.adabelief(list(model.parameters()), LR))
    path = save_checkpoint(str(tmp_path), "old", state)
    tree = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    tree["opt_state"]["count"], tree["opt_state"]["lr"] = 7, 5e-4
    tree["opt_state"]["slots"]["m"] = [torch.full_like(t, 0.5) for t in
                                       tree["opt_state"]["slots"]["m"]]
    torch.save(tree, os.path.join(path, "state.pt"))
    lr_tensor, count_tensor = state.optimizer._lr, state.optimizer._count
    restore_checkpoint(path, state)
    opt = state.optimizer
    assert opt.count == 7 and opt.lr == 5e-4
    assert opt._lr is lr_tensor and opt._count is count_tensor
    assert lr_tensor.item() == np.float32(5e-4) and count_tensor.item() == 7
    assert all(torch.equal(m, torch.full_like(m, 0.5)) for m in opt.m)
    saved = torch.load(os.path.join(save_checkpoint(str(tmp_path), "new",
                                                    state), "state.pt"),
                       weights_only=True)["opt_state"]
    assert saved["count"] == 7 and type(saved["count"]) is int
    assert saved["lr"] == 5e-4 and type(saved["lr"]) is float
