"""The port's NAS subsystem (seld_tpu_torch/nas) against the JAX package's
(seld_tpu/nas): the copied modules' values, the samplers' draws, the
complexity table, the analytic FLOPs against torch's FLOP counter, one
candidate's `_fit_and_score` on carried weights, the search driver, and the
nas_search / analyze_nas command lines on the CPU.

Tolerances (f32, toy sizes: input (50, 16, 7), B=2, units <= 16):
  - the samplers' configs, the search spaces, the complexity values and
    the sweep's thresholds: exactly equal (bit-equal for the thresholds);
  - `_fit_and_score`'s train and val loss, 1e-4 relative (4 optimizer
    steps; each AdaBelief or Adam step moves every parameter by about lr
    whatever its gradient's size, so rounding reaches later losses only
    through elements whose gradient is itself noise); the four scores and
    ER, F and DE_F, 1e-4 relative (counts of thresholded predictions,
    equal unless a prediction lies within rounding of a threshold); DE,
    DE_ATOL = 0.05 degrees: after 4 steps the predictions differ by ~1e-5
    relative, and DE averages arccos of normalised dot products, whose
    slope grows without bound near +-1 (a dot-product difference d there
    moves an angle by up to sqrt(2 d)): measured 0.016 degrees of 78; the
    seld scores (DE / 180 is a quarter of them) and the 12 swept seld
    values, 1e-4 relative plus SELD_ATOL = 1e-4 (> 0.05 / 720); the
    searched threshold exactly equal and its F to 1e-4 relative. At lr 0
    every value is equal to the last bit.
  - FLOPs: torch's FlopCounterMode counts 2 per multiply-accumulate of the
    matmuls and convolutions it sees (and nothing for elementwise work),
    while the analytic counts are multiply-accumulates plus one a bias
    output; so counted / (2 x analytic) lies in a stated band a case, as
    tests/test_nas_flops.py holds XLA's count.
"""
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.data.loader import SeldDataset as JaxSeldDataset
from seld_tpu.models import build_model as jax_build_model
from seld_tpu.nas import complexity as JC
from seld_tpu.nas import sampler as JS
from seld_tpu.nas import search as JSR
from seld_tpu.train import losses as JL
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.config.registry import get_block
from seld_tpu_torch.data.loader import SeldDataset
from seld_tpu_torch.models import build_model
from seld_tpu_torch.nas import complexity as C
from seld_tpu_torch.nas import sampler as S
from seld_tpu_torch.nas import search as SR

torch.set_num_threads(1)
INPUT_SHAPE = (50, 16, 7)
LOSS_RTOL = SCORE_RTOL = 1e-4
DE_ATOL, SELD_ATOL = 0.05, 1e-4
VAD_SPACE_1D = {"simple_dense_block": {
    "units": [[16], [24], [32], [48], [64], [96], [128]],
    "dense_activation": [None, "relu"]}}


def test_search_spaces_equal():
    assert SR.SELD_SEARCH_SPACE_2D == JSR.SELD_SEARCH_SPACE_2D
    assert SR.SELD_SEARCH_SPACE_1D == JSR.SELD_SEARCH_SPACE_1D


def test_sweep_thresholds_bit_equal_jax_linspace():
    want = np.asarray(jnp.linspace(0.05, 0.6, 12))
    got = SR.sweep_thresholds()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _draw(mod, sampler, space_2d, space_1d, shape, seed, window, **kw):
    """One config from `mod` (the port's sampler module or JAX's) after
    random.seed(seed), then the next draw of the stream."""
    random.seed(seed)
    cfg = getattr(mod, sampler)(
        space_2d, space_1d, 4, shape,
        config_postprocess_fn=mod.mother_stage_postprocess,
        constraint=mod.sample_constraint(*window), max_iters=500_000, **kw)
    return cfg, random.random()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_conv_temporal_sampler_draws_jax_configs(seed):
    """The default SELD spaces under the 400-480 MFLOP constraint at
    (300, 64, 7): for the same random.seed, the same configs, and the
    random stream left in the same place."""
    kw = dict(default_config={"n_classes": 12, "first_pool_size": [5, 2]})
    got = _draw(S, "conv_temporal_sampler", SR.SELD_SEARCH_SPACE_2D,
                SR.SELD_SEARCH_SPACE_1D, (300, 64, 7), seed,
                (400_000_000, 480_000_000), **kw)
    want = _draw(JS, "conv_temporal_sampler", JSR.SELD_SEARCH_SPACE_2D,
                 JSR.SELD_SEARCH_SPACE_1D, (300, 64, 7), seed,
                 (400_000_000, 480_000_000), **kw)
    assert got == want


@pytest.mark.parametrize("seed", [1, 4])
def test_vad_sampler_draws_jax_configs(seed):
    """The VAD command line's spaces and its 0.5-0.6 MFLOP window at
    (7, 80, 1)."""
    got = _draw(S, "vad_architecture_sampler", dict(SR.SELD_SEARCH_SPACE_2D),
                VAD_SPACE_1D, (7, 80, 1), seed, (500_000, 600_000),
                default_config={"n_classes": 12})
    want = _draw(JS, "vad_architecture_sampler",
                 dict(JSR.SELD_SEARCH_SPACE_2D), VAD_SPACE_1D, (7, 80, 1),
                 seed, (500_000, 600_000), default_config={"n_classes": 12})
    assert got == want and "SED" not in got[0]


# ------------------------------------------------------- complexity table
T, F, CC = 20, 16, 8
# tests/test_nas.py's cases: (block, args, input shape)
CX_CASES = [
    ("mother_block", dict(filters0=8, filters1=12, filters2=16,
                          kernel_size0=3, kernel_size1=3, kernel_size2=1,
                          connect0=[1], connect1=[1, 1],
                          connect2=[1, 1, 1], strides=(1, 2)), (T, F, CC)),
    ("mother_block", dict(filters0=0, filters1=8, filters2=8,
                          kernel_size0=0, kernel_size1=3, kernel_size2=3,
                          connect0=[1], connect1=[1, 0], connect2=[0, 0, 1],
                          squeeze_ratio=0.5), (T, F, CC)),
    ("mother_stage", dict(depth=2, filters0=0, filters1=96, filters2=0,
                          kernel_size0=0, kernel_size1=3, kernel_size2=0,
                          connect0=[1], connect1=[1, 0], connect2=[1, 0, 1],
                          strides=[1, 3]), (T, 12, 7)),
    ("bidirectional_GRU_block", {"units": [16, 16]}, (T, F, CC)),
    ("bidirectional_GRU_stage", {"depth": 2, "units": 16}, (T, 32)),
    ("RNN_block", {"units": 16, "rnn_type": "GRU"}, (T, 8)),
    ("RNN_stage", {"depth": 2, "units": 16, "rnn_type": "LSTM"}, (T, 8)),
    ("simple_dense_block", {"units": [24, 8]}, (T, F, CC)),
    ("simple_dense_stage", {"depth": 2, "units": 24,
                            "dense_activation": "relu"}, (T, 16)),
    ("transformer_encoder_block", {"n_head": 2, "key_dim": 8,
                                   "ff_multiplier": 2, "kernel_size": 3},
     (T, 16)),
    ("conformer_encoder_block", {"key_dim": 8, "n_head": 2, "kernel_size": 4,
                                 "multiplier": 2, "pos_encoding": "basic",
                                 "pos_mode": "relative"}, (T, 16)),
    ("conformer_encoder_stage", {"depth": 2, "key_dim": 8, "n_head": 2,
                                 "kernel_size": 4, "multiplier": 2,
                                 "pos_encoding": None}, (T, F, CC)),
    ("attention_block", {"key_dim": 8, "n_head": 2, "kernel_size": 4,
                         "ff_kernel_size": 3, "ff_multiplier": 2.0,
                         "ff_factor0": 0.5, "ff_factor1": 0.5,
                         "use_glu": True}, (T, 16)),
    ("identity_block", {}, (T, F, CC)),
]
# the blocks the port builds: their real parameter count and output shape
PORT_BLOCKS = ("mother_block", "mother_stage", "bidirectional_GRU_block",
               "bidirectional_GRU_stage", "simple_dense_block",
               "simple_dense_stage", "conformer_encoder_stage")


@pytest.mark.parametrize("name,args,shape", CX_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CX_CASES)])
def test_complexity_table_equals_jax_and_the_port_blocks(name, args, shape):
    got = C.get_stage_complexity(name)(args, list(shape))
    want = JC.get_stage_complexity(name)(args, list(shape))
    assert got == want
    if name in PORT_BLOCKS:
        block = get_block(name)(args)(shape)
        x = torch.zeros(2, *shape)
        out = block.eval()(x)
        cx, out_shape = got
        assert cx["params"] == sum(p.numel() for p in block.parameters())
        assert tuple(out_shape) == tuple(out.shape[1:])


def test_model_complexities_equal_jax():
    from seld_tpu.config import get_model_config
    cfg = get_model_config("SS5", search_paths=[])
    assert C.conv_temporal_complexity(cfg, [300, 64, 7]) == \
        JC.conv_temporal_complexity(cfg, [300, 64, 7])
    vad = {"flatten": True, "last_unit": 1, "BLOCK0": "simple_dense_block",
           "BLOCK0_ARGS": {"units": [32, 16]}}
    assert C.vad_architecture_complexity(vad, [7, 80]) == \
        JC.vad_architecture_complexity(vad, [7, 80])
    model = build_model("vad_architecture", (7, 80), vad, device="cpu")
    assert C.vad_architecture_complexity(vad, [7, 80])[0]["params"] == \
        sum(p.numel() for p in model.parameters())
    acc = {"n_classes": 12, "BLOCK0": "simple_dense_stage",
           "BLOCK0_ARGS": {"depth": 1, "units": 32}}
    assert C.accdoa_complexity(acc, [300, 64, 7]) == \
        JC.accdoa_complexity(acc, [300, 64, 7])


# ---------------------------------------------------------------- FLOPs
def _counted(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return counter.get_total_flops()


def _band(counted, analytic, lo, hi, what):
    ratio = counted / (2.0 * analytic)
    assert lo <= ratio <= hi, f"{what}: ratio {ratio:.3f} not in [{lo}, {hi}]"


def test_linear_flops_match_counter():
    from seld_tpu_torch.models.layers import Dense
    t, c, units = 60, 128, 256
    cx, _ = C.linear_complexity([t, c], units)
    dense = Dense(c, units)
    # the bias add is elementwise: the counter sees t*c*units MACs only
    _band(_counted(dense, torch.zeros(t, c)), cx["flops"], 0.99, 1.0,
          "linear")


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
def test_conv2d_flops_match_counter(strides):
    from seld_tpu_torch.models.layers import Conv
    h, w, cin, cout, k = 30, 16, 16, 32, 3
    cx, out_shape = C.conv2d_complexity([h, w, cin], cout, k,
                                        strides=strides)
    conv = Conv(cin, cout, (k, k), strides=strides, padding="SAME")
    x = torch.zeros(1, h, w, cin)
    assert tuple(conv(x).shape[1:]) == tuple(out_shape)
    # the counter counts every tap of the padded window (no border
    # discount, unlike XLA), so only the bias MAC separates them
    _band(_counted(conv, x), cx["flops"], 0.99, 1.0, f"conv2d {strides}")


def test_gru_flops_match_counter():
    from seld_tpu_torch.models.layers import GRU
    t, i, u = 20, 64, 128
    cx, _ = C.gru_complexity([t, i], u, bi=True, merge_mode="mul")
    gru = GRU(i, u, bidirectional=True)
    # the input projection and the T recurrent products are matmuls; the
    # gates are elementwise, which the analytic count includes
    _band(_counted(gru, torch.zeros(1, t, i)), cx["flops"], 0.95, 1.0,
          "bigru")


def test_mha_flops_match_counter():
    from seld_tpu_torch.models.layers import MultiHeadAttention
    t, c, heads, s = 60, 128, 4, 32
    cx, _ = C.multi_head_attention_complexity([t, c], heads, s)
    mha = MultiHeadAttention(c, c, c, heads, s)
    x = torch.zeros(1, t, c)
    _band(_counted(mha, x, x, x), cx["flops"], 0.95, 1.0, "mha")


def test_conv_temporal_flops_match_counter():
    """The NAS constraint's whole-model unit, on tests/test_nas_flops.py's
    representative config as the sampler would draw it: the search's
    first_pool_size [5, 2], and connect2 [0, 1, 1], since
    mother_stage_postprocess sets connect2[2] where filters2 is 0 and
    filters1 is not (with [0, 1, 0] and strides (1, 2) the block passes
    its unstrided second layer on, which the analytic shape does not
    follow: the counter then reads 1.13 x the analytic count)."""
    cfg = {
        "n_classes": 12, "first_pool_size": [5, 2],
        "BLOCK0": "mother_stage",
        "BLOCK0_ARGS": {
            "depth": 2, "filters0": 32, "filters1": 32, "filters2": 0,
            "kernel_size0": 3, "kernel_size1": 3, "kernel_size2": 0,
            "connect0": [1], "connect1": [1, 0], "connect2": [0, 1, 1],
            "strides": [1, 2]},
        "BLOCK1": "simple_dense_stage",
        "BLOCK1_ARGS": {"depth": 1, "units": 128},
        "SED": "bidirectional_GRU_stage",
        "SED_ARGS": {"depth": 1, "units": 128},
        "DOA": "bidirectional_GRU_stage",
        "DOA_ARGS": {"depth": 1, "units": 128},
    }
    cx, _ = C.conv_temporal_complexity(cfg, [300, 64, 7])
    model = build_model("conv_temporal", (300, 64, 7), cfg, device="cpu")
    # BatchNorm, activations and pooling are elementwise (uncounted)
    _band(_counted(model, torch.zeros(1, 300, 64, 7)), cx["flops"], 0.95,
          1.0, "conv_temporal")


# ------------------------------------------------------- _fit_and_score
def _candidate_config():
    """A conv_temporal candidate as the sampler draws them: a mother stage
    with a skipped first layer, kernel sizes 1 and 5, strides (1, 1); a
    biGRU stage at U=8 (the kernels' route) then one at U=6 (the plain
    recurrence); dense heads at dropout 0."""
    return {
        "filters": 8, "first_pool_size": [5, 2],
        "BLOCK0": "mother_stage",
        "BLOCK0_ARGS": {"depth": 1, "filters0": 0, "filters1": 8,
                        "filters2": 12, "kernel_size0": 0,
                        "kernel_size1": 5, "kernel_size2": 1,
                        "connect0": [1], "connect1": [1, 0],
                        "connect2": [1, 0, 1], "strides": [1, 1]},
        "BLOCK1": "bidirectional_GRU_stage",
        "BLOCK1_ARGS": {"depth": 1, "units": 8},
        "BLOCK2": "bidirectional_GRU_stage",
        "BLOCK2_ARGS": {"depth": 1, "units": 6},
        "SED": "simple_dense_stage",
        "SED_ARGS": {"depth": 1, "units": 8, "dense_activation": "relu",
                     "dropout_rate": 0.0},
        "DOA": "simple_dense_stage",
        "DOA_ARGS": {"depth": 2, "units": 16, "dense_activation": "relu",
                     "dropout_rate": 0.0},
    }


def _toy_clips(n_classes, n_clips=2):
    rng = np.random.RandomState(0)
    feats = [rng.randn(100, 16, 7).astype(np.float32) for _ in range(n_clips)]
    labs = []
    for _ in range(n_clips):
        sed = (rng.rand(20, n_classes) < 0.3).astype(np.float32)
        doa = (np.clip(rng.randn(20, 3 * n_classes), -1, 1)
               * np.tile(sed, 3)).astype(np.float32)
        labs.append(np.concatenate([sed, doa], -1))
    return feats, labs


def _datasets(cls, feats, labs):
    return (cls.from_clips(feats, labs, batch_size=2, label_window_size=10,
                           loop_time=2),
            cls.from_clips(feats, labs, batch_size=2, train=False,
                           label_window_size=10))


def _jax_initial_state_dict(cfg, n_classes, seed=0):
    """The parameters JAX's `_fit_and_score` makes inside (the same
    PRNGKey(seed) init call), as the port's state_dict."""
    cfg = dict(cfg, n_classes=n_classes)
    model = jax_build_model("conv_temporal", INPUT_SHAPE, cfg)
    variables = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((2, *INPUT_SHAPE)), train=False)
    port = build_model("conv_temporal", INPUT_SHAPE, cfg, device="cpu")
    return from_flax(jax.tree_util.tree_map(np.asarray, variables), port)


@pytest.mark.parametrize("proxy,n_classes", [
    ("reference", 12), ("trainer", 12), ("trainer", 4)])
def test_fit_and_score_matches_jax(proxy, n_classes, monkeypatch):
    """One candidate trained one epoch and scored, from JAX's initial
    parameters, on the same batches. The trainer proxy weights its losses
    by the DCASE2021 class table at 12 classes. The JAX package's check
    `n_classes == len(DCASE2021_TRAIN_SAMPLES)` reads the [1, 12] table's
    length, 1, so it runs unweighted at 12 classes; the JAX side is here
    given the table as a 12-vector, which makes its check read 12, the
    weighting it documents. At 4 classes both fall back to no weights."""
    if proxy == "trainer" and n_classes == 12:
        monkeypatch.setattr(JL, "DCASE2021_TRAIN_SAMPLES",
                            JL.DCASE2021_TRAIN_SAMPLES[0])
    feats, labs = _toy_clips(n_classes)
    cfg = _candidate_config()
    sweeps = {}

    def recording(module, key):
        real = module.calculate_seld_score

        def calc(values):
            out = real(values)
            if np.ndim(out):
                sweeps[key] = np.asarray(out, np.float32)
            return out
        monkeypatch.setattr(module, "calculate_seld_score", calc)

    from seld_tpu.train import metrics as JM
    from seld_tpu_torch.train import metrics as TM
    recording(JM, "jax")
    recording(TM, "port")
    want = JSR.train_and_eval_candidate(
        cfg, INPUT_SHAPE, *_datasets(JaxSeldDataset, feats, labs),
        n_classes=n_classes, metric_block_size=5, proxy=proxy)
    got = SR.train_and_eval_candidate(
        cfg, INPUT_SHAPE, *_datasets(SeldDataset, feats, labs),
        n_classes=n_classes, metric_block_size=5, proxy=proxy, device="cpu",
        weights=_jax_initial_state_dict(cfg, n_classes))
    assert set(got) == set(want)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    for key in ("test_error_rate", "test_f1score", "test_derf"):
        np.testing.assert_allclose(got[key], want[key], rtol=SCORE_RTOL,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(got["test_der"], want["test_der"],
                               atol=DE_ATOL)
    for key in ("test_seld_score", "test_seld_score_searched"):
        np.testing.assert_allclose(got[key], want[key], rtol=SCORE_RTOL,
                                   atol=SELD_ATOL, err_msg=key)
    assert sweeps["port"].shape == sweeps["jax"].shape == (12,)
    np.testing.assert_allclose(sweeps["port"], sweeps["jax"],
                               rtol=SCORE_RTOL, atol=SELD_ATOL)
    assert got["searched_threshold"] == want["searched_threshold"]
    assert got["test_f1_searched"] == pytest.approx(want["test_f1_searched"],
                                                    rel=SCORE_RTOL, abs=1e-7)
    for key in ("flops", "params"):
        assert got[key] == want[key]


# --------------------------------------------------------- search driver
def _fake_eval(model_config, device=None):
    return {"test_seld_score": 0.5, "flops": 1, "params": 1}


def test_random_search_resumes_guards_and_matches_jax_json(tmp_path):
    kw = dict(min_flops=None, max_flops=None, n_blocks=2,
              input_shape=(60, 32, 32))
    random.seed(7)
    jax_s = JSR.RandomSearch("j", {"lr": 1e-3}, results_dir=str(tmp_path),
                             **kw)
    jax_s.run(3, _fake_eval, verbose=False)
    random.seed(7)
    s1 = SR.RandomSearch("p", {"lr": 1e-3}, results_dir=str(tmp_path), **kw)
    s1.run(2, _fake_eval, verbose=False)
    s2 = SR.RandomSearch("p", {"lr": 1e-3}, results_dir=str(tmp_path), **kw)
    assert s2.n_done == 2
    s2.run(3, _fake_eval, verbose=False)
    with open(jax_s.path) as f:
        want = json.load(f)
    with open(s2.path) as f:
        got = json.load(f)
    assert got == want and sorted(got) == ["000", "001", "002",
                                           "train_config"]
    with pytest.raises(ValueError):
        SR.RandomSearch("p", {"lr": 5}, results_dir=str(tmp_path))


def test_merge_results_equals_jax(tmp_path):
    a = {"train_config": {"lr": 1}, "000": {"config": {}, "perf": {"s": 1}}}
    b = {"train_config": {"lr": 1}, "000": {"config": {}, "perf": {"s": 2}},
         "001": {"config": {}, "perf": {"s": 3}}}
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    got = SR.merge_results([str(pa), str(pb)], str(tmp_path / "m.json"))
    want = JSR.merge_results([str(pa), str(pb)], str(tmp_path / "w.json"))
    assert got == want and sum(k.isdigit() for k in got) == 3


def test_run_parallel_contract(tmp_path):
    """Contiguous, crash-safe flushes; the serial run's configs in index
    order for the same seed; overlapping evaluations; resume."""
    import time
    kw = dict(min_flops=None, max_flops=None, n_blocks=2,
              input_shape=(60, 32, 32))
    random.seed(3)
    ser = SR.RandomSearch("ser", {"lr": 1e-3}, results_dir=str(tmp_path),
                          **kw)
    ser.run(6, _fake_eval, verbose=False)
    with open(ser.path) as f:
        serial = json.load(f)

    def slow_eval(model_config, device):
        time.sleep(0.2)
        assert device == torch.device("cpu")
        return _fake_eval(model_config)

    random.seed(3)
    s = SR.RandomSearch("par", {"lr": 1e-3}, results_dir=str(tmp_path), **kw)
    t0 = time.time()
    s.run_parallel(6, slow_eval, workers=6,
                   devices=[torch.device("cpu")] * 2, verbose=False)
    assert time.time() - t0 < 1.0          # 6 x 0.2 s overlapped
    with open(s.path) as f:
        stored = json.load(f)
    assert sorted(k for k in stored if k.isdigit()) == [
        f"{i:03}" for i in range(6)]
    assert [stored[f"{i:03}"]["config"] for i in range(6)] == \
        [serial[f"{i:03}"]["config"] for i in range(6)]
    s2 = SR.RandomSearch("par", {"lr": 1e-3}, results_dir=str(tmp_path),
                         **kw)
    assert s2.n_done == 6
    s2.run_parallel(8, slow_eval, workers=2,
                    devices=[torch.device("cpu")], verbose=False)
    assert s2.n_done == 8


def test_shared_state_survives_many_threads(tmp_path):
    """More threads than cores with a short switch interval: the kernels'
    launch counts lose no update (`kernels.count_launch` takes a lock), and
    run_parallel with 16 workers still samples the serial run's configs in
    index order and flushes every index."""
    import sys
    import threading
    from seld_tpu_torch.ops import kernels
    kw = dict(min_flops=None, max_flops=None, n_blocks=2,
              input_shape=(60, 32, 32))
    random.seed(4)
    ser = SR.RandomSearch("ser", {"lr": 1}, results_dir=str(tmp_path), **kw)
    ser.run(32, _fake_eval, verbose=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.launch_counts.clear()
        workers = [threading.Thread(target=lambda: [
            kernels.count_launch("gru_scan") for _ in range(2000)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert kernels.launch_counts["gru_scan"] == 16 * 2000
        random.seed(4)
        par = SR.RandomSearch("par", {"lr": 1}, results_dir=str(tmp_path),
                              **kw)
        par.run_parallel(32, lambda cfg, dev: _fake_eval(cfg), workers=16,
                         devices=[torch.device("cpu")], verbose=False)
    finally:
        sys.setswitchinterval(old)
        kernels.launch_counts.clear()
    with open(ser.path) as f, open(par.path) as g:
        want, got = json.load(f), json.load(g)
    assert sorted(k for k in got if k.isdigit()) == [f"{i:03}"
                                                     for i in range(32)]
    assert [got[f"{i:03}"]["config"] for i in range(32)] == \
        [want[f"{i:03}"]["config"] for i in range(32)]


def test_run_parallel_real_candidates_on_two_cpu_workers(tmp_path):
    """Real tiny candidates through run_parallel on devices [cpu, cpu]:
    the serial run's configs and perfs (each candidate on a dataset of its
    own, so the shuffle does not depend on which thread iterates first)."""
    feats, labs = _toy_clips(12)
    space_1d = {"simple_dense_stage": {"depth": [1, 2], "units": [8, 12],
                                       "dense_activation": ["relu"],
                                       "dropout_rate": [0.0]},
                "bidirectional_GRU_stage": {"depth": [1], "units": [4, 8]}}
    kw = dict(search_space_2d={}, search_space_1d=space_1d, n_blocks=1,
              input_shape=(50, 16, 7), min_flops=None, max_flops=None)

    def evaluate(model_config, device="cpu"):
        return SR.train_and_eval_candidate(
            dict(model_config, filters=8, first_pool_size=[5, 2]),
            INPUT_SHAPE, *_datasets(SeldDataset, feats, labs),
            metric_block_size=5, device=device)

    random.seed(5)
    serial = SR.RandomSearch("ser", {"lr": 1e-3}, results_dir=str(tmp_path),
                             **kw).run(3, evaluate, verbose=False)
    random.seed(5)
    par = SR.RandomSearch("par", {"lr": 1e-3}, results_dir=str(tmp_path),
                          **kw).run_parallel(
        3, evaluate, workers=2, devices=[torch.device("cpu")] * 2,
        verbose=False)
    for i in range(3):
        a, b = serial[f"{i:03}"], par[f"{i:03}"]
        assert a["config"] == b["config"]
        assert np.isfinite(b["perf"]["test_seld_score"])
        for key in ("loss", "val_loss", "test_seld_score"):
            np.testing.assert_allclose(b["perf"][key], a["perf"][key],
                                       rtol=1e-6)


# --------------------------------------------------------- command lines
def test_nas_search_and_analyze_cli_on_the_cpu(tmp_path, capsys):
    """nas_search on a synthesized feat_label tree (both proxies' flag,
    resume one more sample), the two refusals, and analyze_nas on the
    results (without --plots)."""
    from seld_tpu_torch import analyze_nas, nas_search
    from seld_tpu_torch.dress_rehearsal import synthesize_dataset
    synthesize_dataset(str(tmp_path / "d"), 2, 1, 60, n_classes=12)
    data = str(tmp_path / "d" / "DCASE2021" / "feat_label")
    argv = ["--task", "seld", "--dataset_path", data, "--results_dir",
            str(tmp_path / "r"), "--batch_size", "2", "--n_repeat", "1",
            "--min_flops", "0", "--max_flops", "3000000", "--n_blocks", "1",
            "--proxy", "trainer", "--device", "cpu"]
    random.seed(0)
    s = nas_search.main(argv + ["--name", "a", "--n_samples", "1"])
    first = dict(s.results["000"])
    s = nas_search.main(argv + ["--name", "a", "--n_samples", "2"])
    assert s.n_done == 2 and s.results["000"] == first
    for flags in (["--device_data", "--parallel", "2"],
                  ["--device_data", "--eval_device", "cpu"]):
        with pytest.raises(SystemExit):
            nas_search.main(argv + ["--name", "b", "--n_samples", "1"]
                            + flags)
    with pytest.raises(SystemExit):
        nas_search.main(["--task", "vad", "--name", "c", "--proxy",
                         "trainer", "--device", "cpu"])
    out = analyze_nas.main(["--results", s.path, "--merge",
                            str(tmp_path / "m.json"), "--plots",
                            str(tmp_path / "plots")])
    assert out["pairs"] == 2
    assert "result pairs loaded" in capsys.readouterr().out
    assert (tmp_path / "plots" / "cdf_by_count.png").stat().st_size > 0
