"""The port's multi-step and whole-epoch training steps
(seld_tpu_torch/train/steps.py: `make_train_multistep`, `make_train_epoch`
and the fused single step, fronts of one program run by train/graphs.py)
against the JAX package's on the same weights and batches, against each
other, and against the port's own eager steps with dropout and augments
on.

On the CPU the step body runs in a plain loop, as it does whenever the
caller asks for the CPU; the CUDA graph that runs it on the card is
checked by chip_smoke.py's `[graph]` and `[feed]` phases.

Setup and tolerances are tests/test_torch_train_step.py's (narrow SS5,
every dropout zeroed where JAX is compared, f32, [4, 60, 16, 7] batches,
class-weighted BCE + 1000 x class-weighted masked MSE + L2 1e-3, AGC 0.01,
AdaBelief at lr 1e-3): losses 1e-4 relative at every step; parameters
2e-5 absolute for every leaf whose gradient is not null (a null leaf, zero
in exact arithmetic, moves by AdaBelief's response to rounding noise);
BatchNorm running variances 1e-5 absolute and running means 1e-5 plus the
drift of the null conv biases before them; the metric state 1e-5
relative. The port against itself (same ops, same values, the same
generators in the same order) is exact, but for the metric: one folded
update sums the same counts in another order than k updates do (1e-6).
"""
import argparse
import copy
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model import narrow_ss5, random_variables
from test_torch_train_step import (B, BLOCK, INPUT_SHAPE, LOSS_RTOL, LR,
                                   N_CLASSES, NULL_GRAD, PARAM_ATOL,
                                   STATS_ATOL, _batches, _config, _flat,
                                   _recording)

from seld_tpu.models import build_model as jax_build_model
from seld_tpu.train import losses as JL
from seld_tpu.train import metrics as JM
from seld_tpu.train.optimizers import adabelief as jax_adabelief
from seld_tpu.train.steps import make_train_epoch as jax_make_train_epoch
from seld_tpu.train.steps import \
    make_train_multistep as jax_make_train_multistep
from seld_tpu.train.train_state import TrainState as JaxTrainState
from seld_tpu_torch.bridge import from_flax, to_flax
from seld_tpu_torch.data import transforms as T
from seld_tpu_torch.data.device_dataset import DeviceDataset
from seld_tpu_torch.models import build_model
from seld_tpu_torch.train import losses as TL
from seld_tpu_torch.train import metrics as TM
from seld_tpu_torch.train.graphs import StepLoop
from seld_tpu_torch.train.optimizers import adabelief
from seld_tpu_torch.train.steps import (make_train_epoch,
                                        make_train_multistep,
                                        make_train_step)
from seld_tpu_torch.train.train_state import TrainState
from seld_tpu_torch.train.trainer import SELDTrainer

torch.set_num_threads(1)
K = 3                      # steps per call
N_WINDOWS = 12             # the epoch's split: 3 steps of B = 4
METRIC_RTOL = 1e-6


def _loss_fns(module, cw):
    return dict(sed_loss_fn=lambda y, p: module.sed_loss_with_weights(y, p,
                                                                      cw),
                doa_loss_fn=lambda y, p: module.MMSE_with_cls_weights(y, p,
                                                                      cw))


def _port_kwargs():
    cw = TL.class_weights_from_samples(TL.DCASE2021_TRAIN_SAMPLES)
    return dict(**_loss_fns(TL, cw), loss_weights=(1.0, 1000.0), l2=1e-3,
                metric_block_size=BLOCK)


def _jax_kwargs():
    cw = JL.class_weights_from_samples(JL.DCASE2021_TRAIN_SAMPLES)
    return dict(**_loss_fns(JL, cw), loss_weights=(1.0, 1000.0), l2=1e-3,
                metric_block_size=BLOCK, donate=False)


def _stacked():
    """The K batches of test_torch_train_step, stacked [K, B, ...]."""
    xs, seds, doas = zip(*_batches(K))
    return np.stack(xs), np.stack(seds), np.stack(doas)


def _split():
    """N_WINDOWS windows with sed and doa labels side by side, and an
    epoch's [K, B] index matrix."""
    xs, seds, doas = zip(*_batches(N_WINDOWS // B))
    x_all = np.concatenate(xs)
    y_all = np.concatenate([np.concatenate(seds), np.concatenate(doas)], -1)
    idx = np.random.RandomState(3).permutation(N_WINDOWS).astype(np.int32)
    return x_all, y_all, idx.reshape(-1, B)


@pytest.fixture(scope="module")
def variables():
    jm = jax_build_model("conv_temporal", INPUT_SHAPE, _config())
    return jm, jax.tree_util.tree_map(np.asarray,
                                      random_variables(jm, INPUT_SHAPE))


def _jax_state(jm, variables):
    return JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=optax.chain(_recording(), jax_adabelief(LR, agc_clip=0.01)),
        rng=jax.random.PRNGKey(0))


def _with_fused_stem(fn):
    os.environ["SELD_FUSED_STEM"] = "always"
    try:
        return fn()
    finally:
        del os.environ["SELD_FUSED_STEM"]


@pytest.fixture(scope="module", params=[1, K], ids=lambda u: f"unroll{u}")
def jax_multistep(request, variables):
    """JAX's make_train_multistep(K) at one unroll: (state, metric,
    losses [K, 2])."""
    jm, v = variables
    xs, sed, doa = _stacked()
    step = jax_make_train_multistep(steps_per_call=K, unroll=request.param,
                                    **_jax_kwargs())
    state, metric, (sl, dl) = _with_fused_stem(lambda: step(
        _jax_state(jm, v), JM.init_state(N_CLASSES), jnp.asarray(xs),
        (jnp.asarray(sed), jnp.asarray(doa))))
    return request.param, state, metric, np.stack([sl, dl], -1)


@pytest.fixture(scope="module", params=[False, True],
                ids=lambda f: "fused" if f else "folded")
def jax_epoch(request, variables):
    """JAX's make_train_epoch(mesh=None, augment_fn=None) over the split
    at one fuse_metrics: (fuse, state, metric, losses [K, 2])."""
    jm, v = variables
    x_all, y_all, idx = _split()
    epoch = jax_make_train_epoch(n_classes=N_CLASSES, mesh=None,
                                 fuse_metrics=request.param,
                                 **_jax_kwargs())
    state, metric, (sl, dl) = _with_fused_stem(lambda: epoch(
        _jax_state(jm, v), JM.init_state(N_CLASSES), jnp.asarray(x_all),
        jnp.asarray(y_all), jnp.asarray(idx), jax.random.PRNGKey(1)))
    return request.param, state, metric, np.stack([sl, dl], -1)


def _port_state(variables, cfg=None, seed=0):
    model = build_model("conv_temporal", INPUT_SHAPE, cfg or _config(),
                        device="cpu")
    if variables is not None:
        model.load_state_dict(from_flax(variables, model))
    return TrainState(model, adabelief(list(model.parameters()), LR,
                                       agc_clip=0.01), seed=seed)


def _holds_jax(state, metric, losses, jstate, jmetric, jlosses, steps):
    """The port's state, metric and losses after `steps` updates against
    JAX's, to test_torch_train_step's tolerances."""
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert state.step == steps and state.optimizer.count == steps
    last_g = _flat(jax.tree_util.tree_map(np.asarray, jstate.opt_state[0]))
    null_at = NULL_GRAD * max(np.abs(g).max() for g in last_g.values())
    null = {n for n, g in last_g.items() if np.abs(g).max() < null_at}
    assert all(n.endswith("bias") for n in null)
    got = to_flax(state.model)
    want_p = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    got_p = _flat(got["params"])
    assert set(got_p) == set(want_p)
    for name, w in want_p.items():
        if name not in null:
            np.testing.assert_allclose(got_p[name], w, rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
    want_s = _flat(jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    for name, w in _flat(got["batch_stats"]).items():
        atol = STATS_ATOL + (name.endswith("mean")
                             * (1 - 0.99) * 2 * 1.2 * LR * steps)
        np.testing.assert_allclose(w, want_s[name], rtol=0, atol=atol,
                                   err_msg=name)
    for key, w in jmetric.items():
        np.testing.assert_allclose(metric[key].numpy(), np.asarray(w),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose([float(v) for v in TM.result(metric)],
                               [float(v) for v in JM.result(jmetric)],
                               rtol=1e-5)


def test_multistep_matches_jax_make_train_multistep(variables,
                                                    jax_multistep):
    unroll, jstate, jmetric, jlosses = jax_multistep
    xs, sed, doa = (torch.from_numpy(a) for a in _stacked())
    state = _port_state(variables[1])
    step = make_train_multistep(steps_per_call=K, unroll=unroll,
                                **_port_kwargs())
    state, metric, (sl, dl) = step(state, TM.init_state(N_CLASSES, "cpu"),
                                   xs, (sed, doa))
    assert sl.shape == dl.shape == (K,)
    _holds_jax(state, metric, torch.stack([sl, dl], -1).numpy(), jstate,
               jmetric, jlosses, K)


def test_epoch_matches_jax_make_train_epoch(variables, jax_epoch):
    fuse, jstate, jmetric, jlosses = jax_epoch
    x_all, y_all, idx = (torch.from_numpy(a) for a in _split())
    state = _port_state(variables[1])
    epoch = make_train_epoch(n_classes=N_CLASSES, fuse_metrics=fuse,
                             **_port_kwargs())
    state, metric, (sl, dl) = epoch(state, TM.init_state(N_CLASSES, "cpu"),
                                    x_all, y_all, idx, torch.Generator())
    assert sl.shape == dl.shape == (N_WINDOWS // B,)
    _holds_jax(state, metric, torch.stack([sl, dl], -1).numpy(), jstate,
               jmetric, jlosses, N_WINDOWS // B)


def _assert_same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
    for (name, s), t in zip(a.model.named_buffers(), b.model.buffers()):
        assert torch.equal(s, t), name
    for slot in ("m", "v"):
        for x, y in zip(getattr(a.optimizer, slot),
                        getattr(b.optimizer, slot)):
            assert torch.equal(x, y)
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _metric_close(a, b):
    for key in a:
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                   rtol=METRIC_RTOL, err_msg=key)


@pytest.mark.parametrize("unroll", [1, 2, K])
def test_multistep_equals_k_single_steps_with_dropout(unroll):
    """The contract of the JAX package's steps.py:155-161, dropout on:
    the masks of step i come from the state's generator in step order, and
    a further single step draws the same masks after either."""
    cfg = narrow_ss5()
    cfg["n_classes"] = N_CLASSES
    xs, sed, doa = (torch.from_numpy(a) for a in _stacked())
    single = make_train_step(**_port_kwargs())
    a = _port_state(None, cfg, seed=5)
    b = _port_state(None, cfg, seed=5)
    b.model.load_state_dict(a.model.state_dict())
    ma, losses = TM.init_state(N_CLASSES, "cpu"), []
    for i in range(K):
        a, ma, (sl, dl) = single(a, ma, xs[i], (sed[i], doa[i]))
        losses.append(torch.stack([sl, dl]))
    multi = make_train_multistep(steps_per_call=K, unroll=unroll,
                                 **_port_kwargs())
    b, mb, (sl, dl) = multi(b, TM.init_state(N_CLASSES, "cpu"), xs,
                            (sed, doa))
    assert torch.equal(torch.stack(losses), torch.stack([sl, dl], -1))
    _assert_same_state(a, b)
    _metric_close(ma, mb)
    # a second call continues the same stream
    _, _, after_a = single(a, ma, xs[0], (sed[0], doa[0]))
    _, _, after_b = single(b, mb, xs[0], (sed[0], doa[0]))
    assert torch.equal(torch.stack(after_a), torch.stack(after_b))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_single_step_equals_the_unfused_step(dtype):
    """make_train_step(fuse_metrics=True), the JAX package's single step
    with the metric inside (seld_tpu/train/steps.py:117-123), dropout on:
    K calls leave the state, the losses and the metric state exactly where
    K unfused steps leave them, and a further unfused step continues the
    same stream."""
    cfg = narrow_ss5()
    cfg["n_classes"] = N_CLASSES
    xs, sed, doa = (torch.from_numpy(a) for a in _stacked())
    kw = dict(_port_kwargs(), compute_dtype=dtype)
    plain, fused = make_train_step(**kw), make_train_step(fuse_metrics=True,
                                                          **kw)
    a = _port_state(None, cfg, seed=5)
    b = _port_state(None, cfg, seed=5)
    b.model.load_state_dict(a.model.state_dict())
    ma, mb = TM.init_state(N_CLASSES, "cpu"), TM.init_state(N_CLASSES, "cpu")
    for i in range(K):
        a, ma, la = plain(a, ma, xs[i], (sed[i], doa[i]))
        b, mb, lb = fused(b, mb, xs[i], (sed[i], doa[i]))
        assert torch.equal(torch.stack(la), torch.stack(lb))
    assert a.step == b.step == K
    _assert_same_state(a, b)
    for key in ma:
        assert torch.equal(ma[key], mb[key]), key
    _, _, after_a = plain(a, ma, xs[0], (sed[0], doa[0]))
    _, _, after_b = plain(b, mb, xs[0], (sed[0], doa[0]))
    assert torch.equal(torch.stack(after_a), torch.stack(after_b))


@pytest.mark.parametrize("fuse", [False, True],
                         ids=lambda f: "fused" if f else "folded")
def test_staged_fronts_equal_the_epoch_over_an_identity_index(fuse):
    """The k-step call (fuse_metrics=False) and K calls of the fused single
    step (fuse_metrics=True) are fronts of the epoch's program: over K
    stacked batches they leave the state, the metric state and the losses
    bit for bit where `make_train_epoch` at the same fuse_metrics leaves
    them over the same rows under the identity index matrix, dropout on
    and no augment."""
    cfg = narrow_ss5()
    cfg["n_classes"] = N_CLASSES
    xs, sed, doa = (torch.from_numpy(a) for a in _stacked())
    a = _port_state(None, cfg, seed=5)
    b = _port_state(None, cfg, seed=5)
    b.model.load_state_dict(a.model.state_dict())
    ma = TM.init_state(N_CLASSES, "cpu")
    if fuse:
        step, losses = make_train_step(fuse_metrics=True,
                                       **_port_kwargs()), []
        for i in range(K):
            a, ma, (sl, dl) = step(a, ma, xs[i], (sed[i], doa[i]))
            losses.append(torch.stack([sl, dl]))
        la = torch.stack(losses)
    else:
        step = make_train_multistep(steps_per_call=K, **_port_kwargs())
        a, ma, (sl, dl) = step(a, ma, xs, (sed, doa))
        la = torch.stack([sl, dl], -1)
    epoch = make_train_epoch(n_classes=N_CLASSES, fuse_metrics=fuse,
                             **_port_kwargs())
    x_all = xs.reshape(K * B, *xs.shape[2:])
    y_all = torch.cat([sed, doa], -1).reshape(K * B, *sed.shape[2:-1], -1)
    idx = torch.arange(K * B, dtype=torch.int32).reshape(K, B)
    b, mb, (sl, dl) = epoch(b, TM.init_state(N_CLASSES, "cpu"), x_all,
                            y_all, idx, torch.Generator())
    assert torch.equal(la, torch.stack([sl, dl], -1))
    _assert_same_state(a, b)
    for key in ma:
        assert torch.equal(ma[key], mb[key]), key


def _augment():
    """The CLI's --use_tfm --use_acs augments at this test's 60 frames."""
    return T.compose(
        T.random_ups_and_downs,
        lambda g, x, y: (T.batch_mask(g, x, axis=-3, max_mask_size=6,
                                      n_mask=2, period=60), y),
        lambda g, x, y: (T.batch_mask(g, x, axis=-2, max_mask_size=4,
                                      n_mask=2, period=60), y),
        T.foa_intensity_vec_aug)


def _trainer(tmp_path, tag, epoch_scan, fuse):
    cfg = narrow_ss5()
    config = argparse.Namespace(
        name="g", model="conv_temporal", lr=LR, batch=B, loss_weight="1,1000",
        epoch=2, agc=True, label_smoothing=0.0, sed_loss="BCE",
        doa_loss="MMSE", swa=True, swa_start=1, swa_freq=1, seed=3,
        epoch_scan=epoch_scan, fuse_metrics=fuse)
    trainer = SELDTrainer(config, cfg, n_classes=N_CLASSES,
                          input_shape=INPUT_SHAPE, device="cpu",
                          workdir=str(tmp_path / tag / "m"),
                          logdir=str(tmp_path / tag / "l"),
                          metric_block_size=BLOCK)
    trainer.set_augment(_augment())
    return trainer


@pytest.mark.parametrize("fuse", [False, True],
                         ids=lambda f: "fused" if f else "folded")
def test_epoch_with_augments_equals_the_trainers_eager_loop(tmp_path, fuse):
    """Dropout and augments on: two epochs of the trainer's epoch step
    equal two epochs of its eager loop, step for step and generator for
    generator, and the epoch step is built once for both epochs."""
    x_all, y_all, _ = _split()
    eager = _trainer(tmp_path, "eager", False, False)
    scan = _trainer(tmp_path, "scan", True, fuse)
    scan.model.load_state_dict(eager.model.state_dict())
    built = []
    for trainer in (eager, scan):
        ds = DeviceDataset(x_all, y_all, B, "cpu", loop_time=2, seed=0)
        out = [trainer._run_epoch(ds, e, "train") for e in range(2)]
        built.append(trainer._epoch_step)
        trainer.result = out
    for a, b in zip(eager.result, scan.result):
        assert a["sedLoss"] == b["sedLoss"] and a["doaLoss"] == b["doaLoss"]
        for key in ("ErrorRate", "F", "DoaErrorRate", "DoaErrorRateF"):
            np.testing.assert_allclose(b[key], a[key], rtol=METRIC_RTOL)
    _assert_same_state(eager.state, scan.state)
    assert eager.state.step == 2 * 2 * N_WINDOWS // B
    assert torch.equal(eager.aug_generator.get_state(),
                       scan.aug_generator.get_state())
    assert built[0] is None and built[1] is not None
    scan.set_augment(None)
    assert scan._epoch_step is None


@pytest.mark.parametrize("k,unroll", [(0, 1), (K, 0), (K, K + 1)])
def test_multistep_refuses_what_jax_refuses(k, unroll):
    with pytest.raises(ValueError) as want:
        jax_make_train_multistep(steps_per_call=k, unroll=unroll,
                                 **_jax_kwargs())
    with pytest.raises(ValueError) as got:
        make_train_multistep(steps_per_call=k, unroll=unroll,
                             **_port_kwargs())
    assert str(got.value) == str(want.value)


def test_epoch_refuses_a_mesh():
    """make_train_epoch takes a mesh (several ranks: the two-rank epoch of
    tests/test_torch_dp.py). A mesh without a process group is the
    single-card path: the epoch equals the one without a mesh, bit for
    bit."""
    from seld_tpu_torch.parallel.mesh import make_mesh
    x_all, y_all, idx = (torch.from_numpy(a) for a in _split())
    runs = []
    for mesh in (None, make_mesh("data:-1", "cpu")):
        state = _port_state(None)
        epoch = make_train_epoch(n_classes=N_CLASSES, mesh=mesh,
                                 **_port_kwargs())
        runs.append(epoch(state, TM.init_state(N_CLASSES, "cpu"), x_all,
                          y_all, idx, torch.Generator()))
    (a, ma, la), (b, mb, lb) = runs
    _assert_same_state(a, b)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(u, v) for u, v in zip(la, lb))


@pytest.mark.parametrize("steps,unroll", [(6, 1), (6, 3), (7, 3), (2, 3)])
def test_step_loop_runs_each_step_once(steps, unroll):
    calls = []
    loop = StepLoop(lambda: calls.append(1), [], "cpu", unroll)
    loop.run(steps)
    loop.run(steps)
    assert len(calls) == 2 * steps
    assert sorted(loop._graphs) == sorted({n for n in (unroll,
                                                       steps % unroll)
                                           if n and n <= steps})


def test_epoch_index_matrix_reuses_one_buffer():
    x_all, y_all, _ = _split()
    ds = DeviceDataset(x_all, y_all, B, "cpu", loop_time=2, seed=4)
    ref = copy.deepcopy(ds._rng)
    first = ds.epoch_index_matrix()
    ptr, want = first.data_ptr(), []
    for _ in range(2):
        want.append(np.concatenate([ref.permutation(N_WINDOWS)
                                    for _ in range(2)]).reshape(-1, B))
    np.testing.assert_array_equal(first.numpy(), want[0])
    second = ds.epoch_index_matrix()
    assert second.data_ptr() == ptr and second.dtype == torch.int32
    np.testing.assert_array_equal(second.numpy(), want[1])


def test_epoch_step_reads_a_restaged_split(tmp_path):
    """A rebuilt split (a TDM rebuild), staged after the trainer released
    the epoch step built over the old one: nothing holds the old split
    any more, and the next epoch's first gathered batch is the host's
    gather from the new split at that epoch's index row (on the card the
    program is captured anew; chip_smoke's [tdm] checks the replay)."""
    x_all, y_all, _ = _split()
    trainer = _trainer(tmp_path, "restage", True, False)
    seen = []

    def probe(gen, x, y):
        seen.append((x.clone(), y.clone()))
        return x, y
    trainer.set_augment(probe)
    old = DeviceDataset(x_all, y_all, B, "cpu", seed=0)
    trainer._run_epoch(old, 0, "train")
    first_epoch = len(seen)
    assert first_epoch == N_WINDOWS // B
    old_x = weakref.ref(old.device_arrays[0])
    trainer.release_epoch_program()
    del old
    assert old_x() is None          # freed at once, with no cycle to collect
    rng = np.random.RandomState(11)
    new_x = rng.randn(*x_all.shape).astype(np.float32)
    new_y = np.abs(rng.randn(*y_all.shape)).astype(np.float32)
    new = DeviceDataset(new_x, new_y, B, "cpu", seed=1)
    trainer._run_epoch(new, 1, "train")
    ids = new._idx[0].numpy()
    np.testing.assert_array_equal(seen[first_epoch][0].numpy(), new_x[ids])
    np.testing.assert_array_equal(seen[first_epoch][1].numpy(), new_y[ids])
    assert trainer.state.step == 2 * N_WINDOWS // B
