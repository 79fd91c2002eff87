"""The rest of the block zoo in the port against seld_tpu's flax blocks:
the RFF encoding, relative-position MHA and the LSTM layer; RNN_stage /
RNN_block (GRU and LSTM), the transformer stage, the conformer's relative
mode, RFF encoding and scan_depth, the attention stage's options,
tcn_stage, identity_block, mother_block's bn_pair_batch; GRU and LSTM
dropout in training; the equality max-pool backward; the attention
block's ValueErrors.

Each block case builds both sides from the same config dict at toy widths
(B <= 8, T <= 12, d <= 32, U <= 16), draws the flax tree's variables from
numpy (kernels ~ N(0, 1/fan_in), non-zero biases, random BatchNorm
statistics, RFF w ~ N(0, 1)) and bridges them, then compares: the eval
forward and the train forward (batch statistics) to FORWARD_ATOL; the
updated running statistics to STATS_ATOL; the gradients of sum(out * w)
to GRAD_RTOL of each leaf's largest element (a leaf whose JAX gradient
stays below NULL_GRAD of the step's largest element is zero in exact
arithmetic — a bias feeding a train-mode BatchNorm or shifting all of a
softmax's keys, the RFF w behind its stop-gradient, tcn_stage's last
residual conv — and stays below that level in the port); and one AdaBelief
step with AGC 0.01 from those gradients, the parameters to PARAM_ATOL.
Dropout rates are 0 in these cases; the dropout tests hand both sides the
same numpy masks (jax.random.bernoulli patched in the test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model import random_variables

from seld_tpu.config import get_model_config
from seld_tpu.config.registry import get_block as jax_get_block
from seld_tpu.models import layers as jl
from seld_tpu.models import modules as jm
from seld_tpu.train.optimizers import adabelief as jax_adabelief
from seld_tpu_torch.bridge import from_flax, to_flax
from seld_tpu_torch.config import get_block
from seld_tpu_torch.models import layers as tl
from seld_tpu_torch.ops import gru as tgru
from seld_tpu_torch.ops import pooling as tpool
from seld_tpu_torch.train.optimizers import adabelief
from seld_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)
FORWARD_ATOL, STATS_ATOL, PARAM_ATOL = 1e-4, 1e-5, 2e-5
GRAD_RTOL, NULL_GRAD, LR = 1e-4, 1e-6, 1e-3
SS5 = get_model_config("SS5", search_paths=[])


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


def _jax_side(jblock, v, x, w):
    """(eval out, train out, updated stats, grads, params after a step),
    in one compiled program."""
    tx = jax_adabelief(LR, agc_clip=0.01)

    def run(v, x, w):
        params, stats = v.get("params", {}), v.get("batch_stats", {})

        def loss(p):
            out, upd = jblock.apply({"params": p, "batch_stats": stats}, x,
                                    train=True, mutable=["batch_stats"])
            return jnp.sum(out * w), (out, upd.get("batch_stats", {}))

        (_, (train_out, new_stats)), grads = jax.value_and_grad(
            loss, has_aux=True)(params)
        stepped = params
        if params:
            updates, _ = tx.update(grads, tx.init(params), params)
            stepped = optax.apply_updates(params, updates)
        return (jblock.apply(v, x, train=False), train_out, new_stats, grads,
                stepped)

    return tuple(jax.tree_util.tree_map(np.asarray, t)
                 for t in jax.jit(run)(v, x, w))


def _torch_side(block, v, x, w):
    block.load_state_dict(from_flax(v, block))
    block.eval()
    with torch.no_grad():
        eval_out = block(torch.from_numpy(x)).numpy()
    block.train()
    names = [n for n, _ in block.named_parameters()]
    params = list(block.parameters())
    out = block(torch.from_numpy(x))
    grads = []
    if params:
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                    params, allow_unused=True,
                                    materialize_grads=True)
        adabelief(params, LR, agc_clip=0.01).step(params, grads)
    tree = to_flax(block)
    return (eval_out, out.detach().numpy(), _flat(tree["batch_stats"]),
            {n: g.numpy() for n, g in zip(names, grads)},
            _flat(tree["params"]))


def _check(block_name, args, x):
    """Both sides of `block_name` on `x`, compared as the module says."""
    jblock = jax_get_block(block_name)(args)
    v = jax.tree_util.tree_map(np.asarray, random_variables(
        jblock, x.shape[1:]))
    out_shape = jax.eval_shape(lambda: jblock.apply(
        v, jnp.asarray(x), train=False)).shape
    w = _x(*out_shape, seed=9)
    want = _jax_side(jblock, v, jnp.asarray(x), jnp.asarray(w))
    block = get_block(block_name)(args)(x.shape[1:])
    assert tuple(block.out_shape) == out_shape[1:]
    got = _torch_side(block, v, x, w)
    for g, ref in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, ref, rtol=0, atol=FORWARD_ATOL)
    want_stats = _flat(want[2])
    assert set(got[2]) == set(want_stats)
    for k, ref in want_stats.items():
        np.testing.assert_allclose(got[2][k], ref, rtol=0, atol=STATS_ATOL,
                                   err_msg=k)
    want_p, got_p = _flat(want[4]), got[4]
    for n in _assert_grads(got[3], _flat(want[3])):
        np.testing.assert_allclose(got_p[n], want_p[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    return block


def _assert_grads(got, want):
    """Each gradient to GRAD_RTOL of its leaf's largest element plus the
    rounding level null_at; a leaf whose JAX gradient stays below null_at
    is zero in exact arithmetic (a bias, the RFF w, or no path at all) and
    stays below it in the port. Returns the other leaves' names."""
    assert set(got) == set(want)
    null_at = NULL_GRAD * max([np.abs(g).max() for g in want.values()],
                              default=0.0)
    clear = []
    for n, ref in want.items():
        ref = np.asarray(ref)
        if np.abs(ref).max() < null_at:
            assert n.endswith(("bias", "w")) or not ref.any(), n
            assert np.abs(np.asarray(got[n])).max() < null_at, n
            continue
        np.testing.assert_allclose(
            np.asarray(got[n]), ref, rtol=0,
            atol=GRAD_RTOL * np.abs(ref).max() + null_at, err_msg=n)
        clear.append(n)
    return clear


# ------------------------------------------------------------------ layers

def test_rff_encoding_matches_jax_and_never_moves():
    w = _x(1, 1, 8, seed=1)
    want = np.asarray(jl.RFFPosEncoding(16).apply({"params": {"w": w}}, 12))
    layer = tl.RFFPosEncoding(16)
    layer.load_state_dict({"w": torch.from_numpy(w)})
    got = layer(12, torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6)
    # stop_gradient: no gradient reaches w, a leaf the layer declares
    # unused (the train step gives it zeros), so no optimizer moves it
    assert not got.requires_grad and tl.RFFPosEncoding.unused_parameters \
        == ("w",)
    g = torch.zeros_like(layer.w)
    adabelief([layer.w], LR, agc_clip=0.01).step([layer.w], [g])
    np.testing.assert_array_equal(layer.w.detach().numpy(), w)


class _Heads(torch.nn.Module):
    """tcn_stage (and an RFF encoding added to its input) under SED and DOA
    heads of 2 classes, with one parameter that no path reaches if
    `stray`."""

    def __init__(self, stray):
        super().__init__()
        self.rff = tl.RFFPosEncoding(6)
        self.tcn = get_block("tcn_stage")({"filters": 8, "depth": 2})((10, 6))
        self.stray = torch.nn.Parameter(torch.ones(3)) if stray else None

    def forward(self, x):
        h = self.tcn(x + self.rff(x.shape[1], x.dtype))
        return torch.sigmoid(h[..., :2]), torch.tanh(h[..., 2:])


@pytest.mark.parametrize("stray", [False, True])
def test_train_step_zeros_only_declared_unused_leaves(stray):
    """The train step gives zeros, as jax.grad does, to the leaves no path
    reaches that their modules declare (RFF's w, tcn_stage's last residual
    conv) and raises for any other."""
    from seld_tpu_torch.train import metrics as M
    from seld_tpu_torch.train.steps import make_train_step
    torch.manual_seed(0)
    model = _Heads(stray)
    opt = adabelief(list(model.parameters()), LR, agc_clip=0.01)
    state = TrainState(model, opt, seed=1)
    seen = {}
    real_step = opt.step
    opt.step = lambda ps, gs: (seen.update(zip(state.params, gs)),
                               real_step(ps, gs))
    step = make_train_step(
        sed_loss_fn=lambda y, p: (p - y).square().mean(),
        doa_loss_fn=lambda y, p: (p - y).square().mean())
    x = torch.from_numpy(_x(2, 10, 6, seed=3))
    y = (torch.zeros(2, 10, 2), torch.zeros(2, 10, 6))
    if stray:
        with pytest.raises(RuntimeError, match="stray"):
            step(state, M.init_state(2, "cpu"), x, y)
        return
    step(state, M.init_state(2, "cpu"), x, y)
    zero = sorted(k for k, g in seen.items() if not g.any())
    assert zero == ["rff.w", "tcn.Conv_5.bias", "tcn.Conv_5.kernel"]


def test_rel_position_mha_matches_jax():
    q, pos = _x(3, 10, 12, seed=2), _x(1, 10, 12, seed=3)
    jmod = jl.RelPositionMultiHeadAttention(num_heads=2, head_size=5)
    v = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), q, q, q, pos))
    v["params"] = {k: a + 0.1 * _x(*a.shape, seed=4)
                   for k, a in v["params"].items()}
    w = _x(3, 10, 12, seed=5)

    def f(p):
        out = jmod.apply({"params": p}, q, q, q, pos)
        return jnp.sum(out * w), out
    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(v["params"])
    layer = tl.RelPositionMultiHeadAttention(12, 12, 12, 12, 2, 5)
    layer.load_state_dict(from_flax(v, layer))
    t = torch.from_numpy(q)
    got = layer(t, t, t, torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FORWARD_ATOL)
    names, params = zip(*layer.named_parameters())
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), params)
    assert "k_bias" not in _assert_grads(dict(zip(names, grads)), want_g)


def test_relative_shift_matches_jax():
    x = _x(2, 3, 5, 5, seed=6)
    np.testing.assert_array_equal(
        tl.RelPositionMultiHeadAttention.relative_shift(
            torch.from_numpy(x)).numpy(),
        np.asarray(jl.RelPositionMultiHeadAttention.relative_shift(x)))


@pytest.mark.parametrize("bidirectional,merge", [
    (False, "mul"), (True, "mul"), (True, "concat")])
def test_lstm_layer_matches_jax(bidirectional, merge):
    x = _x(4, 9, 6, seed=7)
    jmod = jl.LSTM(8, bidirectional=bidirectional, merge_mode=merge)
    v = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(1), x))
    v["params"]["bias"] = v["params"]["bias"] + 0.2 * _x(
        *v["params"]["bias"].shape, seed=8)
    layer = tl.LSTM(6, 8, bidirectional=bidirectional, merge_mode=merge)
    assert layer.state_dict()["bias"][..., 8:16].eq(1.0).all()  # forget
    layer.load_state_dict(from_flax(v, layer))
    w = _x(*jmod.apply(v, x).shape, seed=9)

    def f(p):
        out = jmod.apply({"params": p}, x)
        return jnp.sum(out * w), out
    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(v["params"])
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FORWARD_ATOL)
    names, params = zip(*layer.named_parameters())
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), params)
    assert len(_assert_grads(dict(zip(names, grads)), want_g)) == 3


# ------------------------------------------------------------------ blocks

_MOTHER = {"depth": 1, "filters0": 8, "filters1": 12, "filters2": 6,
           "kernel_size0": 3, "kernel_size1": 3, "kernel_size2": 1,
           "connect0": [1], "connect1": [1, 1], "connect2": [1, 1, 1],
           "strides": [1, 2], "bn_pair_batch": True}
_ATTN = {"depth": 2, "key_dim": 6, "n_head": 2, "kernel_size": 3,
         "ff_kernel_size": 1, "ff_multiplier": 2, "ff_factor0": 0.5,
         "ff_factor1": 0.5, "dropout_rate": 0.0}
_CONFORMER = dict(SS5["BLOCK2_ARGS"], key_dim=6, n_head=2, kernel_size=4,
                  dropout_rate=0.0)
_TRANSFORMER = {"depth": 2, "n_head": 2, "key_dim": 6, "ff_multiplier": 2,
                "kernel_size": 3, "dropout_rate": 0.0}
# case -> (block, args, input shape)
BLOCKS = {
    "rnn_stage_gru": ("RNN_stage", {"depth": 2, "units": 12}, (8, 10, 3, 4)),
    "rnn_stage_lstm": ("RNN_stage", {"depth": 2, "units": 12,
                                     "rnn_type": "LSTM"}, (8, 10, 3, 4)),
    "rnn_block_lstm_concat": ("RNN_block", {"units": 8, "rnn_type": "LSTM",
                                            "merge_mode": "concat"},
                              (4, 10, 12)),
    "rnn_block_gru_forward_only": ("RNN_block", {"units": 8,
                                                 "bidirectional": False},
                                   (4, 10, 12)),
    "transformer_stage": ("transformer_encoder_stage", _TRANSFORMER,
                          (4, 12, 16)),
    "transformer_block_on_2d": ("transformer_encoder_block",
                                dict(_TRANSFORMER, activation="swish"),
                                (2, 10, 4, 4)),
    "conformer_relative_basic": ("conformer_encoder_stage", dict(
        _CONFORMER, pos_encoding="basic", pos_mode="relative"), (4, 12, 16)),
    "conformer_absolute_rff": ("conformer_encoder_stage", dict(
        _CONFORMER, pos_encoding="rff"), (4, 12, 16)),
    "conformer_relative_rff": ("conformer_encoder_block", dict(
        _CONFORMER, pos_encoding="rff", pos_mode="relative"), (4, 12, 16)),
    "conformer_scan_depth1": ("conformer_encoder_stage", dict(
        _CONFORMER, depth=1, scan_depth=True), (4, 12, 16)),
    "conformer_scan_depth2_relative_rff": ("conformer_encoder_stage", dict(
        _CONFORMER, scan_depth=True, pos_encoding="rff",
        pos_mode="relative"), (4, 12, 16)),
    "attention_stage": ("attention_stage", _ATTN, (4, 12, 16)),
    "attention_pre_ln_glu": ("attention_stage", dict(
        _ATTN, layer_norm_in_front=True, use_glu=True, use_bias=True),
        (4, 12, 16)),
    "attention_pre_ln": ("attention_stage", dict(
        _ATTN, layer_norm_in_front=True), (4, 12, 16)),
    "attention_glu_rff": ("attention_stage", dict(
        _ATTN, use_glu=True, pos_encoding="rff"), (4, 12, 16)),
    "attention_kernel0_glu": ("attention_stage", dict(
        _ATTN, kernel_size=0, use_glu=True), (4, 12, 16)),
    "attention_abs_zeros": ("attention_stage", dict(
        _ATTN, abs_pos_encoding=True, pos_encoding=None), (4, 12, 16)),
    "attention_abs_basic_no_ff": ("attention_block", dict(
        _ATTN, abs_pos_encoding=True, ff_factor0=0, ff_factor1=0,
        ff_kernel_size=0, ff_multiplier=0), (4, 12, 16)),
    "tcn_projected": ("tcn_stage", {"filters": 16, "depth": 3},
                      (4, 12, 3, 4)),
    "tcn_k5": ("tcn_stage", {"filters": 12, "depth": 2, "kernel_size": 5},
               (4, 12, 12)),
    "identity": ("identity_block", {}, (4, 12, 3, 4)),
    "bn_pair_batch": ("mother_stage", _MOTHER, (2, 8, 12, 5)),
    "bn_pair_batch_ss5": ("mother_stage", dict(SS5["BLOCK0_ARGS"],
                                               filters1=8,
                                               bn_pair_batch=True),
                          (2, 6, 12, 4)),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_jax(case):
    name, args, shape = BLOCKS[case]
    _check(name, args, _x(*shape, seed=11))


def test_scan_depth_stacks_every_leaf_on_a_depth_axis():
    """One body under `scan`, each parameter and statistic [depth, ...],
    at depth 1 too."""
    for depth in (1, 3):
        block = get_block("conformer_encoder_stage")(dict(
            _CONFORMER, depth=depth, scan_depth=True,
            pos_encoding="rff"))((12, 16))
        sd = block.state_dict()
        assert all(k.startswith("scan.") for k in sd)
        assert all(v.shape[0] == depth for v in sd.values())
        assert sd["scan.RFFPosEncoding_0.w"].shape == (depth, 1, 1, 8)
        assert sd["scan.BatchNorm_0.mean"].shape == (depth, 16)


@pytest.mark.parametrize("override,message", [
    ({"ff_factor0": -1}, "ff_factor0, ff_factor1 >= 0 must hold"),
    ({"ff_factor0": 0, "ff_factor1": 0},
     "if FF modules are not used, ff_kernel must be set to 0"),
    ({"ff_factor0": 0, "ff_factor1": 0, "ff_kernel_size": 0},
     "if FF modules are not used, ff_multiplier must be set to 0"),
    ({"pos_encoding": None},
     "relative pos encoding demands any types of encoding except the null "
     "one"),
])
def test_attention_kwargs_value_errors(override, message):
    cfg = dict(_ATTN, **override)
    with pytest.raises(ValueError) as want:
        jm._attention_kwargs(cfg)
    assert str(want.value) == message
    for factory in ("attention_block", "attention_stage"):
        with pytest.raises(ValueError) as got:
            get_block(factory)(cfg)
        assert str(got.value) == message


def test_conformer_relative_mode_needs_an_encoding():
    args = dict(_CONFORMER, pos_mode="relative", pos_encoding=None)
    with pytest.raises(ValueError, match="requires a positional encoding"):
        jax_get_block("conformer_encoder_stage")(args).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 12, 16)))
    with pytest.raises(ValueError, match="requires a positional encoding"):
        get_block("conformer_encoder_stage")(args)((12, 16))


def test_every_jax_block_and_model_is_registered():
    from seld_tpu.config import registry as jr
    from seld_tpu_torch.config import registry as tr
    import seld_tpu.models  # noqa: F401
    import seld_tpu_torch.models  # noqa: F401
    assert sorted(tr.BLOCKS) == sorted(jr.BLOCKS) and len(tr.BLOCKS) == 24
    assert sorted(tr.MODELS) == sorted(jr.MODELS) and len(tr.MODELS) == 6


# ----------------------------------------------------------------- dropout

def _patched_bernoulli(monkeypatch, masks):
    """jax.random.bernoulli returns the next of `masks` (numpy bools of the
    asked shape) in call order."""
    queue = list(masks)

    def bernoulli(key, p, shape):
        m = queue.pop(0)
        assert m.shape == tuple(shape)
        return jnp.asarray(m)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return queue


@pytest.mark.parametrize("kind,rate,rec_rate", [
    ("GRU", 0.3, 0.0), ("GRU", 0.0, 0.25), ("GRU", 0.3, 0.25),
    ("LSTM", 0.3, 0.25)])
def test_rnn_dropout_matches_jax_on_the_same_masks(kind, rate, rec_rate,
                                                   monkeypatch):
    """Both sides take the same numpy keep masks: per gate, direction and
    batch row, constant over time; forward and input gradient."""
    b, t, i, u = 4, 7, 6, 8
    gates = 3 if kind == "GRU" else 4
    rng = np.random.RandomState(12)
    masks = []
    if rate:
        masks.append(rng.rand(2, gates, b, 1, i) >= rate)
    if rec_rate:
        masks.append(rng.rand(2, gates, b, u) >= rec_rate)
    x = _x(b, t, i, seed=13)
    w = _x(b, t, u, seed=14)
    jcls = jl.GRU if kind == "GRU" else jl.LSTM
    jmod = jcls(u, bidirectional=True, dropout=rate,
                recurrent_dropout=rec_rate)
    v = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(2), x))

    def f(x):
        out = jmod.apply(v, x, deterministic=False,
                         rngs={"dropout": jax.random.PRNGKey(3)})
        return jnp.sum(out * w), out
    _patched_bernoulli(monkeypatch, masks)
    (_, want), want_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))

    layer = (tl.GRU if kind == "GRU" else tl.LSTM)(
        i, u, bidirectional=True, dropout=rate, recurrent_dropout=rec_rate)
    layer.load_state_dict(from_flax(v, layer))
    queue = [torch.from_numpy(m.astype(np.float32)) for m in masks]
    monkeypatch.setattr(tl, "keep_mask", lambda shape, keep, *a: (
        queue.pop(0).reshape(shape) / keep))
    layer.train()
    xt = torch.from_numpy(x).requires_grad_()
    got = layer(xt)
    (got * torch.from_numpy(w)).sum().backward()
    assert not queue
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FORWARD_ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0,
                               atol=GRAD_RTOL * np.abs(want_dx).max())


def test_gru_dropout_routes(monkeypatch):
    """Input dropout alone keeps the recurrence on gru_scan; recurrent
    dropout takes the masked route at every U."""
    seen = []
    real_scan, real_masked = tgru.gru_scan, tgru.gru_scan_masked
    monkeypatch.setattr(tgru, "gru_scan", lambda *a: seen.append("kernel")
                        or real_scan(*a))
    monkeypatch.setattr(tgru, "gru_scan_masked", lambda *a: seen.append(
        "masked") or real_masked(*a))
    x = torch.from_numpy(_x(2, 5, 4, seed=15))
    for rate, rec, want in ((0.5, 0.0, "kernel"), (0.0, 0.5, "masked")):
        seen.clear()
        tl.GRU(4, 8, bidirectional=True, dropout=rate,
               recurrent_dropout=rec).train()(x)
        assert seen == [want]
    assert tgru.gru_route(384, masked=True) == "masked"
    assert tgru.gru_route(128, masked=True) == "masked"


def test_dropout_masks_are_per_gate_direction_and_row_and_follow_the_generator():
    """A TrainState points the layer at its generator; the masks are
    constant over time ([.., 1, I]), differ by gate, direction and row,
    and a TrainState of the same seed draws the same ones."""
    def state_of(seed):
        block = get_block("RNN_stage")({"depth": 1, "units": 8,
                                        "rnn_type": "LSTM",
                                        "dropout_rate": 0.5})((7, 6))
        state = TrainState(block.train(), adabelief(
            list(block.parameters()), LR), seed=seed)
        return block.LSTM_0, state

    x = torch.zeros(5, 7, 6)
    layer, state = state_of(4)
    assert layer.dropout_generator is state.generator
    gate_masks, rec_masks = layer._masks(x, torch.float32)
    assert gate_masks.shape == (2, 4, 5, 1, 6)   # constant over time
    assert rec_masks.shape == (2, 4, 5, 8)
    assert set(torch.unique(gate_masks).tolist()) == {0.0, 2.0}
    assert not torch.equal(gate_masks[0, 0], gate_masks[0, 1])
    assert not torch.equal(gate_masks[0], gate_masks[1])
    assert not torch.equal(rec_masks[:, :, 0], rec_masks[:, :, 1])
    again, _ = state_of(4)
    for a, b in zip(again._masks(x, torch.float32), (gate_masks, rec_masks)):
        assert torch.equal(a, b)
    other, _ = state_of(5)
    assert not torch.equal(other._masks(x, torch.float32)[0], gate_masks)
    assert again.eval()._masks(x, torch.float32) == (None, None)


def test_rnn_stage_passes_its_rate_to_both_dropouts():
    block = get_block("RNN_stage")({"depth": 2, "units": 8,
                                    "dropout_rate": 0.2})((10, 6))
    for rnn in block.children():
        assert (rnn.dropout, rnn.recurrent_dropout) == (0.2, 0.2)
        assert hasattr(rnn, "dropout_generator")


# --------------------------------------------------- equality max-pool bwd

@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_equality_maxpool_backward_matches_jax_on_ties(monkeypatch,
                                                       padding):
    """SELD_EQ_MAXPOOL_BWD=1: the cotangent goes to every tied maximum,
    split by their count, on both sides, under either padding (SAME pads
    nothing where the window divides the input); off, a SAME pool sends
    it to one maximum a window on both sides."""
    from seld_tpu.ops import pooling as jpool
    x = np.round(_x(2, 10, 8, 3, seed=16) * 2) / 2     # many ties
    g = _x(2, 5, 4, 3, seed=17)
    ties = None
    for knob in ("1", "0"):
        monkeypatch.setenv("SELD_EQ_MAXPOOL_BWD", knob)
        y, vjp = jax.vjp(lambda x: jpool.max_pool(x, (2, 2), (2, 2),
                                                  padding), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_()
        got = tpool.max_pool(xt, (2, 2), (2, 2), padding)
        got.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y))
        if knob == "1" or padding == "SAME":
            np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-7)
        if knob == "1":
            ties = (x.reshape(2, 5, 2, 4, 2, 3) == np.asarray(y).reshape(
                2, 5, 1, 4, 1, 3)).sum(axis=(2, 4))
            split = xt.grad.numpy()
        else:
            assert padding == "VALID" or not np.allclose(xt.grad.numpy(),
                                                         split)
    assert (ties > 1).any()
    # not applicable where the window does not divide the input
    assert not tpool._eq_bwd_applicable((2, 9, 8, 3), (2, 2), (2, 2))


def test_relative_attention_trains_after_an_inference_forward():
    """The cached basic encoding is made outside inference mode: a block
    whose first forward ran under torch.inference_mode (an eval epoch)
    still trains, though relative attention saves the encoding for
    backward."""
    tl.basic_pos_encoding_on.cache_clear()
    block = get_block("conformer_encoder_stage")(dict(
        _CONFORMER, pos_encoding="basic", pos_mode="relative"))((12, 16))
    x = torch.from_numpy(_x(2, 12, 16, seed=18))
    with torch.inference_mode():
        block.eval()(x)
    block.train()(x).sum().backward()
    assert all(p.grad is not None for p in block.parameters())
