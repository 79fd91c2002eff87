"""The port's tooling twins (seld_tpu_torch/utils/profiling.py,
utils/trace_analysis.py, extract_features.py, bench_frontend.py,
profile_train.py, smoke.py) against the JAX package's where a number can
be compared, on the CPU at toy sizes.

  - `extract_features` on a seeded wav tree (tests/test_torch_trainer.py's
    writer: ten 1-s clips, label CSVs; scripts/dress_rehearsal.py's
    `synthesize_dataset` writes features, not wavs) against
    scripts/extract_features.py run in this process: the log-mel channels
    within 1e-4, the spatial channels (intensity vectors, GCC) within 1e-4
    of each channel's largest magnitude (a unit-normalised vector of a
    quiet bin carries the two FFT libraries' rounding: 1.7e-4 at one
    element of 13.4 million here, 7e-5 relative), labels exact, the
    statistics and the normalised features too;
  - `StepTimer.summary` equal to JAX's under one fake clock;
  - `trace_analysis` on a CPU torch.profiler trace of a model's forward;
  - the smoke twin, `bench_frontend` and `profile_train` with --device cpu;
  - every new entry point refuses to run without a card unless --device
    cpu.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_model import narrow_ss5
from test_torch_trainer import _write_wav_tree

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_ATOL = 1e-4
MEL_CHANNELS = 4
FOLDS = (1, 2, 3, 4, 5, 6, 1, 2, 3, 4)     # ten clips: two front-end chunks


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    _write_wav_tree(root, folds=FOLDS)
    return root


def _npys(directory):
    return {os.path.basename(p): np.load(os.path.join(directory, p))
            for p in sorted(os.listdir(directory)) if p.endswith(".npy")}


@pytest.mark.parametrize("mode,normalize", [("foa", True), ("mic", False)])
def test_extract_features_equals_the_jax_script(wav_tree, tmp_path,
                                                monkeypatch, mode,
                                                normalize):
    """Both CLIs on the same wavs and CSVs: every clip's [3000, 64, C]
    features within FEAT_ATOL, its [600, 56] labels exact; with
    --normalize the mean/std files and the normalised features too."""
    from seld_tpu_torch import extract_features
    out = {}
    for side in ("jax", "port"):
        work = tmp_path / side
        work.mkdir()
        monkeypatch.chdir(work)
        argv = ["--mode", mode, "--wav_dir", str(wav_tree / f"{mode}_dev"),
                "--label_dir", str(wav_tree / "metadata_dev"),
                "--out_dir", "feat", "--label_out_dir", "label"] + (
            ["--normalize"] if normalize else [])
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["extract_features.py", *argv])
            _jax_script("extract_features").main()
        else:
            extract_features.main(argv + ["--device", "cpu"])
        out[side] = {d: _npys(work / d) for d in
                     ("feat", "label", "feat_norm", ".") if
                     os.path.isdir(work / d)}
    want, got = out["jax"], out["port"]
    assert set(got) == set(want) and set(got["feat"]) == set(want["feat"])
    assert len(got["feat"]) == len(FOLDS)
    for name, w in want["feat"].items():
        assert got["feat"][name].shape == w.shape == (
            3000, 64, 7 if mode == "foa" else 10)
        for c in range(w.shape[-1]):
            scale = 1.0 if c < MEL_CHANNELS else np.abs(w[..., c]).max()
            np.testing.assert_allclose(got["feat"][name][..., c],
                                       w[..., c], rtol=0,
                                       atol=FEAT_ATOL * scale,
                                       err_msg=f"{name} channel {c}")
        np.testing.assert_array_equal(got["label"][name],
                                      want["label"][name])
    if normalize:
        for name in ("mean.npy", "std.npy"):
            np.testing.assert_allclose(got["."][name], want["."][name],
                                       rtol=0, atol=FEAT_ATOL)
        std = np.maximum(want["."]["std.npy"], 1e-8)
        for name, w in want["feat_norm"].items():
            # the features' tolerance over the dataset's std
            err = np.abs(got["feat_norm"][name] - w) * std
            scale = np.ones(w.shape[-1])
            scale[MEL_CHANNELS:] = np.abs(want["feat"][name][
                ..., MEL_CHANNELS:]).max(axis=(0, 1))
            assert (err <= FEAT_ATOL * scale + 1e-6).all(), name


def test_extract_features_refuses_a_wav_without_labels(wav_tree, tmp_path):
    from seld_tpu_torch import extract_features
    labels = tmp_path / "labels"
    labels.mkdir()
    with pytest.raises(ValueError, match="no label CSV"):
        extract_features.main(["--wav_dir", str(wav_tree / "foa_dev"),
                               "--label_dir", str(labels), "--out_dir",
                               str(tmp_path / "f"), "--device", "cpu"])


class _Clock:
    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def __call__(self):
        return next(self.ticks)


@pytest.mark.parametrize("api", ["context", "observe"])
def test_step_timer_summary_equals_jax(monkeypatch, api):
    """One fake clock through both timers, the context manager and the
    observe API: the same summary (warmup excluded, p50/p90, rates)."""
    from seld_tpu.utils import profiling as want_mod
    from seld_tpu_torch.utils import profiling as got_mod
    ticks = np.cumsum([0.0, 0.5, 0.1, 0.3, 0.1, 0.2, 0.1, 0.25, 0.05, 0.4,
                       0.2, 0.15, 0.3, 0.35])
    summaries = []
    for mod in (want_mod, got_mod):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(ticks))
        timer = mod.StepTimer(warmup=2)
        for _ in range(6):
            if api == "context":
                with timer:
                    pass
            else:
                timer.observe()
        summaries.append(timer.summary(items_per_step=16))
        monkeypatch.undo()
    assert summaries[0] == summaries[1] and summaries[1]["steps"] > 0


def test_step_timer_calls_its_sync_and_refuses_a_value():
    from seld_tpu_torch.utils.profiling import StepTimer
    calls = []
    timer = StepTimer(warmup=0, sync=lambda: calls.append(1))
    with timer:
        pass
    assert calls == [1] and timer.summary()["steps"] == 1
    with pytest.raises(TypeError, match="callable"):
        StepTimer(sync=torch.zeros(1))


def test_memory_stats_of_the_cpu_are_empty():
    from seld_tpu_torch.utils.profiling import (device_memory_stats,
                                                format_memory_stats)
    assert device_memory_stats("cpu") == {}
    assert "unavailable" in format_memory_stats({})
    assert format_memory_stats({"bytes_in_use": 3 << 30}) == \
        "bytes_in_use=3.00GiB"


def test_trace_analysis_groups_a_cpu_trace(tmp_path):
    """A torch.profiler trace of narrow SS5's forward on the CPU, written
    by `profiling.trace`: its host operators group into the convolution,
    GEMM and elementwise families with the trace's total time; a CPU trace
    holds no card kernels, which the device grouping refuses."""
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.utils.profiling import trace
    from seld_tpu_torch.utils.trace_analysis import (DEVICE, HOST,
                                                     analyze_trace,
                                                     format_report)
    model = build_model("conv_temporal", (60, 16, 7), narrow_ss5(),
                        device="cpu")
    with torch.no_grad(), trace(str(tmp_path)):
        model(torch.zeros(2, 60, 16, 7))
    report = analyze_trace(str(tmp_path), HOST)
    families = {key for _, _, _, key in report["ops"]}
    assert {"conv", "gemm", "elementwise"} <= families
    assert report["total_ms"] > 0
    assert abs(sum(pct for _, pct, _, _ in report["ops"]) - 100.0) < 1e-6
    assert format_report(report).startswith("cpu_op: ")
    with pytest.raises(ValueError, match="no 'kernel' events"):
        analyze_trace(str(tmp_path / "trace.json"), DEVICE)


@pytest.mark.parametrize("name,family", [
    ("void gru_fwd_kernel<8, 8, 8>(...)", "gru_scan"),
    ("gru_fwd_res_kernel<float>", "gru_scan"),
    ("gru_bwd_rec_kernel<__nv_bfloat16>", "gru_scan_bwd"),
    ("stem_dy_vec_kernel<5, 2>", "stem_dy"),
    ("foa_frontend_kernel", "foa_frontend"),
    ("gather_rows_kernel", "gather_rows"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
    ("cudnn::engines_precompiled::conv2d_grouped_direct_kernel", "conv"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::(anonymous)::multi_tensor_apply_kernel", "elementwise"),
    ("aten::addmm", "gemm"), ("aten::convolution", "conv"),
    ("aten::add", "elementwise"), ("Memcpy DtoH", "other")])
def test_classify_names_the_port_families(name, family):
    from seld_tpu_torch.utils.trace_analysis import _classify
    assert _classify(name) == family


def test_smoke_twin_passes_on_the_cpu(capsys):
    from seld_tpu_torch import smoke
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SMOKE PASS" in out and "train steps ok" in out


def test_bench_frontend_on_the_cpu(capsys):
    from seld_tpu_torch import bench_frontend
    got = bench_frontend.main(["--clips", "3", "--chunk", "2", "--seconds",
                               "1", "--device", "cpu"])
    assert set(got) == {"batched_pcm_s", "batched_float_s",
                        "per_clip_float_s"}
    assert all(v > 0 for v in got.values())
    assert "500 clips" in capsys.readouterr().out


def test_profile_train_with_a_trace_on_the_cpu(tmp_path, monkeypatch,
                                               capsys):
    """Narrow SS5 from ./model_config, B=2, 2 timed steps under the trace:
    the summary (p50/p90/mean, windows/s) and the trace's families."""
    from seld_tpu_torch import profile_train
    (tmp_path / "model_config").mkdir()
    (tmp_path / "model_config" / "narrow.json").write_text(
        json.dumps(narrow_ss5()))
    monkeypatch.chdir(tmp_path)
    got = profile_train.main(["--model_config", "narrow", "--batch", "2",
                              "--steps", "2", "--dtype", "fp32", "--trace",
                              str(tmp_path / "tr"), "--device", "cpu"])
    assert got["steps"] == 2 and got["windows_per_sec"] > 0
    assert got["p50_s"] <= got["p90_s"]
    out = capsys.readouterr().out
    assert "cpu_op:" in out and "conv" in out and "windows_per_sec" in out
    assert os.path.exists(tmp_path / "tr" / "trace.json")


@pytest.mark.parametrize("module,argv", [
    ("smoke", []), ("bench_frontend", []), ("profile_train", []),
    ("extract_features", ["--wav_dir", ".", "--out_dir", "o"]),
    ("import_tf_weights", ["--weights", "w.h5", "--model_config", "SS5",
                           "--out", "o"])])
def test_entry_points_refuse_without_a_card(module, argv, monkeypatch):
    """--device cuda is the default and there is no card here: each
    refuses before it does any work."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"seld_tpu_torch.{module}").main
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv)
