"""The port's answer tooling against the JAX package's: `make_answer` and
`search_best` (in-process, --device cpu) on a synthesized feat_label tree
against JAX `ensemble_outputs` + `evaluate_clips_official` /
`search_thresholds` on the bridged weights; the trainer's
`evaluate_ensemble` against the JAX trainer's; and the training CLI with
<ans_path>/dev-test present, which logs ENS_T at the cadence and saves the
SWA average as SWA_best_*.

Setup: narrow SS5 (tests/test_torch_model.py::narrow_ss5) with random
variables, 12 classes, [300, 64, 7] windows, clips of 350 feature frames
(70 label frames, 11 windows). The scores of the port and JAX agree to
1e-6 relative (the same SED decisions, checked to stand clear of each
threshold; the DOA vectors differ in the sixth digit, f32 summation
order), and the searched thresholds are equal. Each comparison first
checks that the port's SED outputs and JAX's fall on the same side of every
threshold it uses; only then are the scores comparable to 1e-6.
"""
import copy
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from test_torch_model import narrow_ss5, random_variables
from test_torch_trainer import (_argv, _config, _model_config, _scalars,
                                cli_tree)  # noqa: F401  (a fixture)

from seld_tpu.data.loader import load_seldnet_data as jax_load
from seld_tpu.inference import ensemble as jens
from seld_tpu.inference.quantize import dequantize_tree, quantize_tree
from seld_tpu.models import build_model as jax_build_model
from seld_tpu.parallel import make_mesh
from seld_tpu.train.trainer import SELDTrainer as JaxTrainer
from seld_tpu_torch import make_answer, search_best
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.dress_rehearsal import synthesize_dataset
from seld_tpu_torch.models import build_model
from seld_tpu_torch.train import main as cli
from seld_tpu_torch.train.checkpoint import save_checkpoint
from seld_tpu_torch.train.optimizers import adabelief
from seld_tpu_torch.train.train_state import TrainState
from seld_tpu_torch.train.trainer import SELDTrainer

torch.set_num_threads(1)
SHAPE = (300, 64, 7)
SCORE_RTOL = 1e-6
CANDIDATES = (0.3, 0.35, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A feat_label tree (2 val, 2 test clips of 70 label frames), the JAX
    model and variables, and a port checkpoint of the same weights."""
    root = tmp_path_factory.mktemp("answer")
    synthesize_dataset(str(root / "data"), 1, 2, 70, n_classes=12,
                       signal_gain=3.0)
    cfg = copy.deepcopy(narrow_ss5())
    cfg["n_classes"] = 12
    with open(root / "narrow.json", "w") as f:
        json.dump(cfg, f)
    jm = jax_build_model("conv_temporal", SHAPE, cfg)
    v = random_variables(jm, SHAPE, seed=4)
    model = build_model("conv_temporal", SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    state = TrainState(model, adabelief(list(model.parameters()), 1e-3))
    ckpt = save_checkpoint(str(root / "ckpt"), "bestscore_0.5", state)
    return dict(root=root, data=str(root / "data"), jm=jm, v=v,
                spec=f"{root / 'narrow.json'}:{ckpt}",
                feat=str(root / "data/DCASE2021/feat_label"),
                ans=str(root / "data/metadata_dev"))


def _clips(t, mode):
    return jax_load(os.path.join(t["feat"], "foa_dev_norm"),
                    os.path.join(t["feat"], "foa_dev_label"), mode=mode)[0]


def _jax_outputs(t, mode, variables=None, fast=False):
    return jens.ensemble_outputs(t["jm"].apply, variables or t["v"],
                                 _clips(t, mode), batch_size=8, fast=fast)


def _names(t, mode):
    fold = {"val": 5, "test": 6}[mode]
    return [f"fold{fold}_room1_mix{i:03d}" for i in range(2)]


def _same_decisions(t, mode, want_outs, thresholds, **kw):
    """The port's SED outputs on the same side of each of `thresholds` (a
    scalar or a per-class table each) as JAX's."""
    got = make_answer.members_outputs(
        [t["spec"]], _clips(t, mode), model_name="conv_temporal",
        n_classes=12, batch=8, device="cpu", **kw)
    for (g, _), (w, _) in zip(got, want_outs):
        for th in thresholds:
            np.testing.assert_array_equal(g.numpy() > th,
                                          np.asarray(w) > th)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_make_answer_matches_jax(tree, fast, tmp_path, capsys):
    t = tree
    from seld_tpu_torch.inference import DEFAULT_CLASS_THRESHOLDS as th
    want_outs = _jax_outputs(t, "test", fast=fast)
    _same_decisions(t, "test", want_outs, [th], fast=fast)
    want = jens.evaluate_clips_official(
        want_outs, _names(t, "test"), os.path.join(t["ans"], "dev-test"),
        str(tmp_path / "jax"), thresholds=th)
    got = make_answer.main(
        ["--data", t["feat"], "--mode", "test", "--models", t["spec"],
         "--ans_path", t["ans"], "--output_path", str(tmp_path / "port"),
         "--batch", "8", "--device", "cpu", "--class_wise"]
        + (["--fast"] if fast else []))
    assert got[0] == pytest.approx(want[0], rel=SCORE_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=SCORE_RTOL)
    out = capsys.readouterr().out
    assert "SELD:" in out and out.count("recall") == 12
    assert sorted(os.listdir(tmp_path / "port")) == \
        [n + ".csv" for n in _names(t, "test")]


def test_make_answer_ensemble_quantize_submit_and_bf16(tree, tmp_path):
    """Two members average; int8 members score what the JAX package's
    dequantize(quantize(w)) scores; --submit writes the eval split's CSVs;
    --bf16 runs the members and clips in bfloat16."""
    t = tree
    common = ["--data", t["feat"], "--mode", "test", "--ans_path", t["ans"],
              "--batch", "8", "--device", "cpu", "--thresholds", "0.5"]
    one = make_answer.main(common + ["--models", t["spec"], "--output_path",
                                     str(tmp_path / "one")])
    two = make_answer.main(common + ["--models", t["spec"], t["spec"],
                                     "--output_path", str(tmp_path / "two")])
    assert two[0] == pytest.approx(one[0], rel=SCORE_RTOL)

    deq = dequantize_tree(quantize_tree(t["v"], "int8"))
    want_outs = _jax_outputs(t, "test", variables=deq)
    _same_decisions(t, "test", want_outs, [0.5], quantize="int8")
    want = jens.evaluate_clips_official(
        want_outs, _names(t, "test"), os.path.join(t["ans"], "dev-test"),
        str(tmp_path / "jq"), thresholds=0.5)
    got = make_answer.main(common + ["--models", t["spec"], "--quantize",
                                     "int8", "--output_path",
                                     str(tmp_path / "q")])
    assert got[0] == pytest.approx(want[0], rel=SCORE_RTOL)

    bf16 = make_answer.main(common + ["--models", t["spec"], "--bf16",
                                      "--output_path", str(tmp_path / "b")])
    assert np.isfinite(bf16[0])

    eval_dir = os.path.join(t["feat"], "foa_eval_norm")
    shutil.copytree(os.path.join(t["feat"], "foa_dev_norm"), eval_dir,
                    dirs_exist_ok=True)
    try:
        assert make_answer.main(
            ["--data", t["feat"], "--submit", "--models", t["spec"],
             "--output_path", str(tmp_path / "sub"), "--batch", "8",
             "--device", "cpu", "--fast"]) is None
    finally:
        shutil.rmtree(eval_dir)
    assert len(os.listdir(tmp_path / "sub")) == 5    # every clip
    with pytest.raises(SystemExit, match="--thresholds lists 2"):
        make_answer.main(common[:-1] + ["0.3,0.4", "--models", t["spec"]])


def test_search_best_matches_jax(tree, tmp_path, capsys):
    t = tree
    want_outs = _jax_outputs(t, "val")
    _same_decisions(t, "val", want_outs, CANDIDATES)
    want_th, want_best = jens.search_thresholds(
        want_outs, _names(t, "val"), os.path.join(t["ans"], "dev-val"),
        str(tmp_path / "jax"))
    got_th, got_best = search_best.main(
        ["--data", t["feat"], "--models", t["spec"], "--ans_path", t["ans"],
         "--output_path", str(tmp_path / "port"), "--batch", "8",
         "--device", "cpu"])
    np.testing.assert_array_equal(got_th, want_th)
    assert got_best == pytest.approx(want_best, rel=SCORE_RTOL)
    out = capsys.readouterr().out.splitlines()
    table = ",".join(f"{x:.2f}" for x in want_th)
    assert f"--thresholds {table}" in out
    got_json = json.loads(out[-1][len("THRESHOLDS_JSON:"):])
    assert got_json["thresholds"] == [float(x) for x in want_th]


def test_evaluate_ensemble_matches_the_jax_trainer(tree, tmp_path):
    """Both trainers on the same variables, clips and ground truth, then
    on other weights passed as params/batch_stats (the final SWA
    evaluation's way): the same scores, logged as ENS_T/*."""
    t = tree
    mesh = make_mesh("data:1", devices=jax.devices()[:1])
    jt = JaxTrainer(_config("run"), _model_config(), n_classes=12,
                    input_shape=SHAPE, mesh=mesh,
                    workdir=str(tmp_path / "jm"), logdir=str(tmp_path / "jl"))
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": jax.device_get(jt.state.params),
        "batch_stats": jax.device_get(jt.state.batch_stats)})
    port = SELDTrainer(_config("run"), _model_config(), n_classes=12,
                       input_shape=SHAPE, device="cpu",
                       workdir=str(tmp_path / "pm"),
                       logdir=str(tmp_path / "pl"))
    port.model.load_state_dict(from_flax(variables, port.model))
    xs, _ = jax_load(os.path.join(t["feat"], "foa_dev_norm"),
                     os.path.join(t["feat"], "foa_dev_label"), mode="test")
    gt = os.path.join(t["ans"], "dev-test")
    names = _names(t, "test")
    other = random_variables(t["jm"], SHAPE, seed=6)
    other_state = from_flax(other, port.model)
    params = {k: v for k, v in other_state.items() if k in port.state.params}
    stats = {k: v for k, v in other_state.items()
             if k in port.state.batch_stats}
    for epoch, kw_jax, kw_port in (
            (0, {}, {}),
            (1, {"params": other["params"],
                 "batch_stats": other["batch_stats"]},
             {"params": params, "batch_stats": stats})):
        want = jt.evaluate_ensemble(xs, names, gt, str(tmp_path / "jo"),
                                    epoch, **kw_jax)
        got = port.evaluate_ensemble(xs, names, gt, str(tmp_path / "po"),
                                     epoch, **kw_port)
        assert got[0] == pytest.approx(want[0], rel=SCORE_RTOL)
        np.testing.assert_allclose(got[1], want[1], rtol=SCORE_RTOL)
    logged = _scalars(str(tmp_path / "pl"), "run")
    for epoch in (0, 1):
        assert {("ENS_T/" + k, epoch) for k in
                ("ER", "F", "DER", "DERF", "seldScore")} <= set(logged)


def test_cli_logs_ens_t_and_saves_swa_best(cli_tree):  # noqa: F811
    """With <ans_path>/dev-test present the training CLI scores the test
    split's full clips every --eval_every epochs and, after fit, saves the
    SWA average as SWA_best_<score>, whose parameters are the average."""
    gt = cli_tree / "metadata_dev" / "dev-test"
    gt.mkdir()
    shutil.copy(cli_tree / "metadata_dev" / "fold6_room1_mix003.csv", gt)
    out = cli.main(_argv(cli_tree, "--ans_path",
                         str(cli_tree / "metadata_dev"), "--eval_every",
                         "1", "--swa_start", "0", "--swa_freq", "1",
                         "--output_path", str(cli_tree / "ens")))
    run = "conv_temporal_narrow_MMSE_cli_v_0"
    logged = _scalars(str(cli_tree / "tensorboard_log"), run)
    assert ("ENS_T/seldScore", 0) in logged and ("ENS_T/F", 0) in logged
    assert os.path.exists(cli_tree / "ens" / "fold6_room1_mix003.csv")
    saved = [d for d in os.listdir(cli_tree / "saved_model" / run)
             if d.startswith("SWA_best_") and not d.endswith(".json")]
    assert len(saved) == 1
    tree = torch.load(cli_tree / "saved_model" / run / saved[0] / "state.pt",
                      weights_only=True)
    trainer = out["trainer"]
    assert trainer.swa.count == 1
    for k, v in trainer.swa_params().items():
        torch.testing.assert_close(tree["params"][k], v, rtol=0, atol=0)
