"""A whole run past the look for a card, at a tiny size on the CPU, with
the timed path broken underneath: `correct` must come out false, and true
for the sound path (in f32, where the tiny model's readings lie far under
the cells' limits)."""
import json
from types import SimpleNamespace

import pytest
import torch

from seld_bench import run
from seld_bench.tests.tiny import tiny_workload

torch.set_num_threads(1)


def _failed(result):
    return [k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]]


def _run(workload, capsys, f32=False):
    wl = tiny_workload(workload)
    if f32 and wl.traffic["driver"] == "train":
        wl = wl._replace(traffic=dict(wl.traffic, compute_dtype="float32"))
    args = SimpleNamespace(seed=2 ** 31 + 11, seconds=0.0, trace=0)
    result = run.execute(wl, args, torch.device("cpu"))
    err = capsys.readouterr().err
    assert all(f"check {k} " in err for k in result["checks"])
    json.dumps(result)
    return result


@pytest.mark.parametrize("workload", ["ss5.train_b256", "seldnet.train_b256",
                                      "ss5.score_exact", "ss5.score_fast_b4"])
def test_the_sound_path_is_correct(workload, capsys):
    result = _run(workload, capsys, f32=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("workload", ["ss5.train_b256", "seldnet.train_b256"])
def test_a_step_that_leaves_the_state_unchanged(workload, capsys,
                                                monkeypatch):
    from seld_tpu_torch.train import optimizers
    monkeypatch.setattr(optimizers._Optimizer, "step",
                        lambda self, params, grads, shard_dims=None: None)
    result = _run(workload, capsys, f32=True)
    assert not result["correct"]
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["ss5.train_b256", "seldnet.train_b256"])
def test_half_of_the_batch_left_out(workload, capsys, monkeypatch):
    from seld_tpu_torch.train import losses

    def on_half(loss):
        def half(y, p, *a, **k):
            n = y.shape[0] // 2
            return loss(y[:n], p[:n], *a, **k)
        return half
    for name in ("sed_loss_with_weights", "MMSE_with_cls_weights"):
        monkeypatch.setattr(losses, name, on_half(getattr(losses, name)))
    result = _run(workload, capsys, f32=True)
    assert not result["correct"]
    assert _failed(result)


@pytest.mark.parametrize("workload", ["ss5.score_exact", "ss5.score_fast_b4"])
def test_an_answer_altered_where_it_is_made(workload, capsys, monkeypatch):
    from seld_tpu_torch.inference import ensemble
    outputs = ensemble.ensemble_outputs

    def altered(*a, **k):
        bumped = []
        for sed, doa in outputs(*a, **k):
            sed = sed.clone()
            sed[0, 0] += 0.05
            bumped.append((sed, doa))
        return bumped
    monkeypatch.setattr(ensemble, "ensemble_outputs", altered)
    result = _run(workload, capsys)
    assert not result["correct"]
    assert result["checks"]["output_gap"]["value"] > 0.04


def test_a_traced_run_reads_no_device_metric_on_the_cpu(capsys):
    """--trace 1 drives the profiler and every reader; the CPU holds no
    card kernels, so each reader returns nothing and none reads 0."""
    wl = tiny_workload("ss5.score_exact")
    args = SimpleNamespace(seed=5, seconds=0.0, trace=1)
    result = run.execute(wl, args, torch.device("cpu"))
    capsys.readouterr()
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
