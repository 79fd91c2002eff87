"""One f32 training step of the zoo's families, the port's `make_train_step`
against the JAX package's on the same weights and batch: narrowed seldnet
and seldnet_v1 (SimpleConvBlock's max pools after a ReLU), Condseldnet
(the expert mix), xception_gru (the overlapping SAME max pool after a
BatchNorm, whose backward routes each window's cotangent to one maximum,
as XLA's select-and-scatter does) and conv_temp (the [5, 1] fused stem,
JAX's through SELD_FUSED_STEM=always and the port's through stem_dy_ref,
and DenseNetStage's average pool). Configs are tests/test_torch_zoo.py's
narrow_zoo at 12 classes; B=4 windows [60, 32, 7]; class-weighted BCE +
1000 x class-weighted masked MSE + L2 1e-3, AGC 0.01 and AdaBelief at lr
1e-3, every dropout 0.

Tolerances (f32), those of tests/test_torch_train_step.py and
tests/test_torch_trainer.py: losses 1e-4 relative; a leaf whose JAX
gradient stays below NULL_GRAD (1e-6) of the step's largest gradient
element is zero in exact arithmetic (the bias of a conv that feeds a
train-mode BatchNorm) and must stay below that level on both sides; every
other gradient to GRAD_RTOL (1e-4) of its largest element plus that
rounding level, NULL_GRAD of the step's largest element (a CondConv
expert's bias gradient is a sum over the batch of per-window sums that
the BatchNorm makes cancel: ~1e-2 of the step's largest element, with
rounding at ~1e-8 of it, 1e-4 of the leaf's own largest), and its updated
parameters to 2e-5 absolute; the running statistics to 1e-5 absolute.

Ties: after a ReLU a max-pool window of zeros is tied, and the port's
VALID pool splits its cotangent where XLA's picks one element; the ReLU's
gradient is zero there on both sides, so the gradients agree to the
tolerance above. tests/test_torch_layers.py holds the pools' backward
on data with ties.

Kinks: a ReLU input within f32 rounding of zero takes its gradient from
the side the rounding puts it on. With the batch of numpy seed 7, one of
narrow conv_temp's DenseNetStage ReLU inputs lies 7e-7 from zero, and
every gradient upstream of it moves by ~1e-2 of its leaf's largest
element between f32 and f64 in either framework alike; the batch is
drawn from seed 8, where no such input decides a gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model import random_variables
from test_torch_zoo import narrow_zoo

from seld_tpu.models import build_model as jax_build_model
from seld_tpu.train import losses as JL
from seld_tpu.train import metrics as JM
from seld_tpu.train.optimizers import adabelief as jax_adabelief
from seld_tpu.train.steps import make_train_step as jax_make_train_step
from seld_tpu.train.train_state import TrainState as JaxTrainState
from seld_tpu_torch.bridge import from_flax, to_flax
from seld_tpu_torch.models import build_model
from seld_tpu_torch.train import losses as TL
from seld_tpu_torch.train import metrics as TM
from seld_tpu_torch.train.optimizers import adabelief
from seld_tpu_torch.train.steps import make_train_step
from seld_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)
SHAPE = (60, 32, 7)
B, N_CLASSES, LR, BLOCK = 4, 12, 1e-3, 6
LOSS_RTOL, PARAM_ATOL, STATS_ATOL = 1e-4, 2e-5, 1e-5
GRAD_RTOL, NULL_GRAD = 1e-4, 1e-6
BATCH_SEED = 8
FAMILIES = [("seldnet", "seldnet"), ("seldnet_v1", "seldnet_v1"),
            ("Condseldnet", "seldnet"), ("xception_gru", "seldnet"),
            ("conv_temp", "conv_temporal")]


def _batch(seed=BATCH_SEED):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, *SHAPE).astype(np.float32)
    sed = (rng.rand(B, 12, N_CLASSES) < 0.2).astype(np.float32)
    sed[:, 0, 0] = 1.0                       # an event in every window
    doa = (np.clip(rng.randn(B, 12, 3 * N_CLASSES), -1, 1)
           * np.repeat(sed, 3, axis=-1)).astype(np.float32)
    return x, sed, doa


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


def _jax_step(model_name, cfg, variables, batch):
    jm = jax_build_model(model_name, SHAPE, cfg)
    cw = JL.class_weights_from_samples(JL.DCASE2021_TRAIN_SAMPLES)
    state = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=optax.chain(_recording(), jax_adabelief(LR, agc_clip=0.01)),
        rng=jax.random.PRNGKey(0))
    step = jax_make_train_step(
        sed_loss_fn=lambda y, p: JL.sed_loss_with_weights(y, p, cw),
        doa_loss_fn=lambda y, p: JL.MMSE_with_cls_weights(y, p, cw),
        loss_weights=(1.0, 1000.0), l2=1e-3, metric_block_size=BLOCK,
        donate=False)
    x, sed, doa = batch
    state, _, (sl, dl) = step(state, JM.init_state(N_CLASSES),
                              jnp.asarray(x),
                              (jnp.asarray(sed), jnp.asarray(doa)))
    return ((float(sl), float(dl)),
            _flat(jax.tree_util.tree_map(np.asarray, state.opt_state[0])),
            _flat(jax.tree_util.tree_map(np.asarray, state.params)),
            _flat(jax.tree_util.tree_map(np.asarray, state.batch_stats)))


def _torch_step(model_name, cfg, variables, batch):
    model = build_model(model_name, SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(variables, model))
    state = TrainState(model, adabelief(list(model.parameters()), LR,
                                        agc_clip=0.01))
    grads, names, opt_step = {}, list(state.params), state.optimizer.step

    def recording_step(ps, gs):
        grads.update((n, g.detach().numpy().copy())
                     for n, g in zip(names, gs))
        opt_step(ps, gs)
    state.optimizer.step = recording_step
    cw = TL.class_weights_from_samples(TL.DCASE2021_TRAIN_SAMPLES)
    step = make_train_step(
        sed_loss_fn=lambda y, p: TL.sed_loss_with_weights(y, p, cw),
        doa_loss_fn=lambda y, p: TL.MMSE_with_cls_weights(y, p, cw),
        loss_weights=(1.0, 1000.0), l2=1e-3, metric_block_size=BLOCK)
    x, sed, doa = batch
    state, _, (sl, dl) = step(state, TM.init_state(N_CLASSES, "cpu"),
                              torch.from_numpy(x),
                              (torch.from_numpy(sed), torch.from_numpy(doa)))
    got = to_flax(state.model)
    return ((sl.item(), dl.item()), grads, _flat(got["params"]),
            _flat(got["batch_stats"]))


@pytest.mark.parametrize("name,model_name", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_one_f32_step_matches_jax(name, model_name, monkeypatch):
    monkeypatch.setenv("SELD_FUSED_STEM", "always")
    cfg = narrow_zoo(name)
    cfg["n_classes"] = N_CLASSES
    variables = jax.tree_util.tree_map(np.asarray, random_variables(
        jax_build_model(model_name, SHAPE, cfg), SHAPE))
    batch = _batch()
    want_l, want_g, want_p, want_s = _jax_step(model_name, cfg, variables,
                                               batch)
    got_l, got_g, got_p, got_s = _torch_step(model_name, cfg, variables,
                                             batch)
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)

    assert set(got_g) == set(want_g)
    null_at = NULL_GRAD * max(np.abs(g).max() for g in want_g.values())
    null = {n for n, g in want_g.items() if np.abs(g).max() < null_at}
    assert all(n.endswith("bias") for n in null), null
    init = _flat(variables["params"])
    for n, w in want_g.items():
        if n in null:
            assert np.abs(got_g[n]).max() < null_at, n
            continue
        np.testing.assert_allclose(
            got_g[n], w, rtol=0,
            atol=GRAD_RTOL * np.abs(w).max() + null_at, err_msg=n)
        np.testing.assert_allclose(got_p[n], want_p[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        assert np.abs(want_p[n] - init[n]).max() > 0.5 * LR, n
    assert set(got_s) == set(want_s)
    for n, w in want_s.items():
        np.testing.assert_allclose(got_s[n], w, rtol=0, atol=STATS_ATOL,
                                   err_msg=n)
