"""The port's VAD subsystem (seld_tpu_torch/data/vad.py, train/vad.py, the
two VAD models, the rehearsal's synthesizer and the VAD command lines)
against the JAX package's, on the CPU.

Tolerances (f32):
  - windows, labels, `VadDataset` batches, `binary_auc` and the
    synthesizer's clips: exactly equal;
  - features, FEAT_ATOL = 1e-5 on values min-max normalised into [0, 1]
    (the STFT's sums run in another order; log and normalisation keep the
    error at a few f32 ulps of the log-mel range);
  - the models' outputs on carried weights, OUT_ATOL = 1e-5 (the same
    formulas layer by layer; convolution and product sums in another
    order move probabilities by ~1e-7);
  - one train step's loss, 1e-5 relative, and its updated parameters,
    PARAM_ATOL = 1e-6 where the gradient stands above NULL_GRAD = 1e-5 of
    the step's largest gradient element (the null gradients' rounding
    noise reaches 1.1e-6 of it in the attention model's post net), and
    2.3 lr below it (AdaBelief's
    first step moves each element by ~1.1 lr whatever its gradient's
    size, so an element whose gradient is rounding noise may move the
    other way);
  - `VADTrainer.fit` over EPOCHS epochs with early stopping: each
    epoch's mean loss to 1e-4 relative (later steps carry earlier
    rounding through elements whose gradient is noise), the val AUCs to
    1e-6 (ranks of predictions that differ by ~1e-6), the epochs run
    equal, and the restored parameters to FIT_PARAM_ATOL = 1e-5.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.data import vad as JV
from seld_tpu.train import vad as JTV
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.data import vad as V
from seld_tpu_torch.models import build_model
from seld_tpu_torch.train import vad as TV

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_ATOL, OUT_ATOL, PARAM_ATOL, FIT_PARAM_ATOL = 1e-5, 1e-5, 1e-6, 1e-5
NULL_GRAD = 1e-5
WINDOW = [-2, -1, 0, 1, 2]
EPOCHS = 6
BDNN = {"flatten": True, "last_unit": 5, "BLOCK0": "simple_dense_block",
        "BLOCK0_ARGS": {"units": [32, 32], "dense_activation": "relu"}}
ATTENTION = {"T": 2, "Nc": 4, "Np": 16, "Nt": 8, "H": 2, "dropout_rate": 0.0}
# a VAD NAS candidate: mother stage (skipped first layer, strides (1, 2))
# then a conv1d dense block, per-frame outputs
NAS_VAD = {"flatten": False, "last_unit": 1, "BLOCK0": "mother_stage",
           "BLOCK0_ARGS": {"depth": 1, "filters0": 4, "filters1": 8,
                           "filters2": 0, "kernel_size0": 3,
                           "kernel_size1": 3, "kernel_size2": 0,
                           "connect0": [1], "connect1": [1, 0],
                           "connect2": [1, 0, 1], "strides": [1, 2]},
           "BLOCK1": "simple_dense_block",
           "BLOCK1_ARGS": {"units": [16], "dense_activation": "relu"}}
MODELS = [("vad_architecture", BDNN), ("vad_architecture", NAS_VAD),
          ("spectro_temporal_attention_based_VAD", ATTENTION)]


def _pairs(seed=0, n=4, t=120, mels=16):
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        label = (rng.rand(t) > 0.5).astype(np.float32)
        feat = rng.rand(t, mels, 1).astype(np.float32) * 0.1
        feat += label[:, None, None] * 0.5
        pairs.append((feat, label))
    return pairs


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ data
def test_features_from_a_seeded_wav_match_jax():
    wav = np.random.RandomState(0).randn(1, 16000).astype(np.float32) * 0.1
    want = np.asarray(JV.vad_features_from_wav(jnp.asarray(wav)))
    got = V.vad_features_from_wav(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (30, 80, 1)
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL)


def test_labels_windows_and_round_trip_equal_jax():
    labels = (np.random.RandomState(1).rand(8000) > 0.4).astype(np.float32)
    np.testing.assert_array_equal(V.vad_labels_from_samples(labels),
                                  JV.vad_labels_from_samples(labels))
    for window in (V.DEFAULT_WINDOW, 3, WINDOW):
        np.testing.assert_array_equal(V.preprocess_window(window),
                                      JV.preprocess_window(window))
    seq = np.random.RandomState(2).rand(100, 3).astype(np.float32)
    w = V.seq_to_windows(seq, V.DEFAULT_WINDOW)
    np.testing.assert_array_equal(w, JV.seq_to_windows(seq,
                                                       JV.DEFAULT_WINDOW))
    back = V.windows_to_seq(w, V.DEFAULT_WINDOW)
    np.testing.assert_array_equal(back, JV.windows_to_seq(
        w, JV.DEFAULT_WINDOW))
    np.testing.assert_allclose(back[19:-19], seq[19:81], atol=1e-5)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_vad_dataset_batches_equal_jax(train):
    pairs = _pairs() + [(np.zeros((3, 16, 1), np.float32),
                         np.zeros(3, np.float32))]   # dropped: too short
    kw = dict(window=V.DEFAULT_WINDOW, batch_size=5, train=train,
              n_repeat=3, seed=5)
    got, want = V.VadDataset(pairs, **kw), JV.VadDataset(pairs, **kw)
    for _ in range(2):      # the shuffle goes on across epochs
        a, b = list(got), list(want)
        assert len(a) == len(b) > 1
        for (x, y), (wx, wy) in zip(a, b):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)


def test_binary_auc_and_metrics_equal_jax():
    rng = np.random.RandomState(3)
    labels = (rng.rand(500) > 0.6).astype(np.float32)
    scores = np.round(rng.rand(500) + 0.3 * labels, 2)   # with ties
    assert TV.binary_auc(labels, scores) == JTV.binary_auc(labels, scores)
    assert TV.binary_metrics(labels, scores, 0.6) == \
        JTV.binary_metrics(labels, scores, 0.6)
    assert np.isnan(TV.binary_auc(np.ones(4), np.arange(4.0)))


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("name,cfg", MODELS,
                         ids=["bdnn", "nas_candidate", "attention"])
def test_vad_models_match_jax_through_the_bridge(name, cfg):
    from seld_tpu.models import build_model as jax_build_model
    shape = (5, 16, 1)
    model = jax_build_model(name, shape, cfg)
    x = np.random.RandomState(4).rand(3, *shape).astype(np.float32)
    variables = _to_numpy(model.init({"params": jax.random.PRNGKey(0)},
                                     jnp.zeros((2, *shape)), train=False))
    port = build_model(name, shape, cfg, device="cpu")
    port.load_state_dict(from_flax(variables, port))
    want = model.apply(variables, jnp.asarray(x), train=False)
    got = port(torch.from_numpy(x))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want) == (3 if "attention" in name else 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=OUT_ATOL)


def _trainers(name, cfg, lr=1e-3):
    shape = (5, 16, 1)
    want = JTV.VADTrainer(cfg, shape, model_name=name, lr=lr)
    variables = {"params": want.state.params}
    if want.state.batch_stats is not None:
        variables["batch_stats"] = want.state.batch_stats
    variables = _to_numpy(variables)
    probe = build_model(name, shape, cfg, device="cpu")
    got = TV.VADTrainer(cfg, shape, model_name=name, lr=lr, device="cpu",
                        weights=from_flax(variables, probe))
    return got, want


def _params_err(got, want, grads=None):
    """max |port - JAX| over the parameters; with `grads` (the port's
    first-step gradients by name) only over the elements whose gradient
    stands clear of rounding noise, and (the largest noise element's
    difference) beside it."""
    flat = from_flax(_to_numpy({"params": want.state.params}))
    err, noise = 0.0, 0.0
    for k, p in got.model.named_parameters():
        diff = (p.detach() - flat[k]).abs()
        if grads is None:
            err = max(err, diff.max().item())
            continue
        clear = grads[k].abs() > NULL_GRAD * max(
            g.abs().max().item() for g in grads.values())
        err = max(err, diff[clear].max().item() if clear.any() else 0.0)
        noise = max(noise, diff[~clear].max().item() if (~clear).any()
                    else 0.0)
    return err if grads is None else (err, noise)


@pytest.mark.parametrize("name,cfg", MODELS[1:],
                         ids=["nas_candidate", "attention"])
def test_one_train_step_matches_jax(name, cfg):
    """The loss (with the pipe net's auxiliary BCE for the attention model)
    and the parameters after one AdaBelief step. Some gradients are zero
    in exact arithmetic (the bias of a conv or dense layer that feeds a
    train-mode BatchNorm: the batch mean absorbs it); their elements are
    rounding noise on both sides, and AdaBelief's first step moves every
    element by about 1.1 lr whatever its size, so those elements are held
    only to that step (2.3 lr) and the rest to PARAM_ATOL."""
    lr = 1e-3
    got, want = _trainers(name, cfg, lr=lr)
    grads, opt_step = {}, got.state.optimizer.step
    names = [k for k, _ in got.model.named_parameters()]

    def recording_step(ps, gs):
        grads.update((n, g.detach().clone()) for n, g in zip(names, gs))
        opt_step(ps, gs)
    got.state.optimizer.step = recording_step
    x, y = next(iter(V.VadDataset(_pairs(), window=WINDOW, batch_size=8)))
    state, loss, _ = want.train_step(want.state, jnp.asarray(x),
                                     jnp.asarray(y))
    want.state = state
    g_loss = got.train_step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(g_loss.item(), float(loss), rtol=1e-5)
    err, noise = _params_err(got, want, grads)
    assert err <= PARAM_ATOL and noise <= 2.3 * lr


def test_fit_with_patience_and_restore_matches_jax():
    """EPOCHS epochs of the bDNN baseline at patience 1: the same epochs
    run, losses and val AUCs, and the best epoch's parameters restored."""
    got, want = _trainers("vad_architecture", BDNN, lr=3e-2)
    kw = dict(window=WINDOW, batch_size=16, n_repeat=4)
    val_pairs = _pairs(seed=9, n=2)
    results = []
    for trainer, mod in ((got, V), (want, JV)):
        results.append(trainer.fit(
            mod.VadDataset(_pairs(), **kw),
            mod.VadDataset(val_pairs, window=WINDOW, batch_size=64,
                           train=False),
            epochs=EPOCHS, patience=1, verbose=False))
    g, w = results
    assert len(g["history"]) == len(w["history"])
    for a, b in zip(g["history"], w["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["val_auc"], b["val_auc"], atol=1e-6)
    np.testing.assert_allclose(g["best_val_auc"], w["best_val_auc"],
                               atol=1e-6)
    assert _params_err(got, want) <= FIT_PARAM_ATOL
    seq_g = got.evaluate_sequences(val_pairs, WINDOW)
    seq_w = want.evaluate_sequences(val_pairs, WINDOW)
    np.testing.assert_allclose(seq_g["auc"], seq_w["auc"], atol=1e-6)


# ----------------------------------------------- rehearsal and commands
def _jax_rehearsal():
    spec = importlib.util.spec_from_file_location(
        "jax_vad_rehearsal", os.path.join(REPO, "scripts",
                                          "vad_rehearsal.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rehearsal_synthesizer_equals_jax(tmp_path):
    from seld_tpu_torch import vad_rehearsal as R
    J = _jax_rehearsal()
    for seed in (0, 3):
        a = R.synthesize_clip(np.random.default_rng(seed), 2.0, 16000)
        b = J.synthesize_clip(np.random.default_rng(seed), 2.0, 16000)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    R.synthesize_split(str(tmp_path / "p"), 2, 2.0, 16000, 1)
    J.synthesize_split(str(tmp_path / "j"), 2, 2.0, 16000, 1)
    for sub in ("wav/clip0001.wav", "label/clip0001.npy"):
        assert (tmp_path / "p" / sub).read_bytes() == \
            (tmp_path / "j" / sub).read_bytes()


def test_vad_rehearsal_and_vad_search_cli_on_the_cpu(tmp_path, capsys):
    """The rehearsal (prepare_vad, then train_vad's bDNN baseline) at a
    tiny size, prepare_vad's npz against the JAX package's features, and
    nas_search --task vad for two samples on the rehearsal's npz."""
    from seld_tpu_torch import nas_search, vad_rehearsal
    work = str(tmp_path / "w")
    out = vad_rehearsal.main(["--workdir", work, "--clips", "4",
                              "--val_clips", "2", "--seconds", "2",
                              "--epochs", "2", "--batch", "32",
                              "--units", "16", "--device", "cpu"])
    assert out["epochs"] == 2 and 0.0 <= out["best_val_auc"] <= 1.0
    assert 0.0 <= out["sequence"]["auc"] <= 1.0
    pairs = list(np.load(os.path.join(work, "val.npz"),
                         allow_pickle=True)["pairs"])
    from seld_tpu_torch.data.loader import read_wav
    wav, _ = read_wav(os.path.join(work, "val", "wav", "clip0000.wav"))
    want = np.asarray(JV.vad_features_from_wav(jnp.asarray(wav)))
    np.testing.assert_allclose(pairs[0][0], want[:len(pairs[0][0])],
                               atol=FEAT_ATOL)
    import random
    random.seed(1)
    s = nas_search.main(["--task", "vad", "--name", "v", "--vad_pairs",
                         os.path.join(work, "train.npz"), "--results_dir",
                         str(tmp_path / "r"), "--n_samples", "2",
                         "--batch_size", "32", "--n_repeat", "1",
                         "--min_flops", "500000", "--max_flops", "600000",
                         "--device", "cpu"])
    assert s.n_done == 2
    from seld_tpu_torch.nas.complexity import vad_architecture_complexity
    for i in range(2):
        entry = s.results[f"{i:03}"]
        assert set(entry["perf"]) == {"val_auc", "flops", "params"}
        cfg = {"flatten": False, "last_unit": 1, **entry["config"]}
        cx = vad_architecture_complexity(cfg, [7, 80, 1])[0]
        assert {k: entry["perf"][k] for k in cx} == cx
    assert "done: 2 samples" in capsys.readouterr().out
