"""The port's spans and counters (seld_tpu_torch/utils/profiling.py) on the
benchmarked paths, and the benchmark's readers of them
(seld_bench/metrics/).

  - Without a profiler `span` is one shared null context and `count` adds
    nothing; no `record_function` is entered on the scoring and training
    paths the benchmark runs.
  - Under a CPU profiler a tiny SS5's clip scoring (exact, fast, batched
    fast) holds the front-end, normaliser and scorer spans, the window and
    overlap-add spans inside the scorer's, and counts the windows and the
    rows of the chunk arithmetic; an epoch over a `DeviceDataset` holds the
    epoch and feed spans.
  - Each of the six readers gives its value on a hand-built trace and
    nothing without its spans (as on a commit without them).
  - On the card (marked `card`, skipped without one) the spans share the
    kernels' clock: a clip's front-end kernel starts inside 50 ms of its
    span, and each graph replay's kernels start after its span.

This file imports no JAX, so its card test runs on a machine without it:

    python -m pytest tests/test_torch_tracing.py -m card --noconftest -s
"""
import collections
import json
import os

import pytest
import torch

from seld_bench import harness
from seld_bench.tests.tiny import tiny_workload
from seld_bench.yardstick.trace import DeviceTrace, Op
from seld_tpu_torch.utils import profiling

torch.set_num_threads(1)

SEED = 2 ** 31 + 7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _score_cell(fast, clip_batch, device="cpu"):
    """The benchmark's scoring cell at a tiny size: 3 clips of 4 s, 200
    feature frames a clip, 21 windows of 100 frames, chunks of 8."""
    wl = tiny_workload("ss5.score_fast_b4" if fast else "ss5.score_exact")
    traffic = dict(wl.traffic, fast=fast, clip_batch=clip_batch)
    cell = harness.driver("score").Cell(wl.config, traffic, SEED, device)
    cell.setup()
    return cell


def _train_cell(device="cpu"):
    """The benchmark's training cell at a tiny size: 16 windows, B=4, an
    epoch of 4 steps, f32."""
    wl = tiny_workload("ss5.train_b256")
    traffic = dict(wl.traffic, compute_dtype="float32")
    cell = harness.driver("train").Cell(wl.config, traffic, SEED, device)
    cell.setup()
    return cell


def _annotations(logdir):
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return [Op(ev["name"], float(ev["ts"]), float(ev["ts"]) + ev["dur"])
            for ev in events if ev.get("ph") == "X"
            and ev.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end


# ---------------------------------------------------------------- off


def test_without_a_profiler_span_and_count_do_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("seld.a"), profiling.span("seld.b")
    assert a is b
    with a:
        pass
    before = collections.Counter(profiling.counts)
    profiling.count("score.windows", 5)
    assert profiling.counts == before and entered == []


def test_no_record_function_on_the_benchmarked_paths_without_a_profiler(
        monkeypatch):
    cells = [_score_cell(False, 1), _score_cell(True, 1),
             _score_cell(True, 2), _train_cell()]
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    before = collections.Counter(profiling.counts)
    for cell in cells:
        cell.item(record=False)
    assert entered == [] and profiling.counts == before


# ----------------------------------------------------------------- on


@pytest.mark.parametrize("fast,clip_batch,trunk", [
    (False, 1, False), (True, 1, True), (True, 2, True)])
def test_a_traced_clip_holds_the_scorer_spans_and_counts(
        fast, clip_batch, trunk, tmp_path):
    cell = _score_cell(fast, clip_batch)
    with profiling.trace(str(tmp_path)):
        assert cell.item(record=False) == clip_batch
    ops = _annotations(str(tmp_path))
    names = collections.Counter(o.name for o in ops)
    ensemble = [o for o in ops if o.name == "seld.score.ensemble"]
    assert names["seld.score.frontend"] == names["seld.score.normalize"] \
        == len(ensemble) == 1
    inner = [o for o in ops if o.name in ("seld.score.windows",
                                          "seld.score.overlap_add",
                                          "seld.score.trunk")]
    assert all(_inside(o, ensemble[0]) for o in inner)
    # 21 windows a clip; the exact path the chunk plan's 3 chunks of 8
    # rows (ceil(21 / 3) = 7 rows, rounded up to 8), the fast path one head
    # chunk padded to 8, the batched path the clips' windows together
    # padded to 8
    n_win = 21
    if not fast:
        rows, chunks = 3 * 8, 3
    elif clip_batch == 1:
        rows, chunks = 24, 1
    else:
        rows, chunks = 48, 1
    assert names["seld.score.windows"] == chunks
    assert names["seld.score.overlap_add"] == clip_batch
    assert names["seld.score.trunk"] == (1 if trunk else 0)
    assert profiling.counts == {"score.windows": clip_batch * n_win,
                                "score.window_rows": rows}


def test_a_traced_epoch_holds_the_epoch_and_feed_spans(tmp_path):
    cell = _train_cell()
    with profiling.trace(str(tmp_path)):
        cell.item()
    names = collections.Counter(o.name for o in _annotations(str(tmp_path)))
    # on the CPU the step body runs in a plain loop: no graph to replay
    assert names == {"seld.train.epoch": 1, "seld.feed.epoch_index": 1}


def test_trace_clears_the_counts_on_entry(tmp_path):
    with profiling.trace(str(tmp_path)):
        profiling.count("score.windows", 3)
    with profiling.trace(str(tmp_path)):
        profiling.count("score.windows", 2)
    assert profiling.counts == {"score.windows": 2}


# ------------------------------------------------------------ readers


def _read(metric, trace, items=1, units=1, steps_per_item=2):
    ctx = {"trace": trace, "items": items, "units": units, "unit_rate": 1.0,
           "facts": {"steps_per_item": steps_per_item}}
    return harness.metric_reader(metric).read(ctx)


def _train_trace(spans=True):
    """A 4-s window: the card busy over [0, 1] and [2, 3.5] (two streams
    overlap at [2.5, 3]); the host in an epoch over [0.5, 3], two replays
    of 0.1 and 0.2 s, an index upload over [0.2, 0.4] and the benchmark's
    window span, which is not the program's."""
    dev = [Op("k", 0.0, 1.0), Op("k", 2.0, 3.0), Op("k2", 2.5, 3.5)]
    host = [Op("seld_bench.traced_window", 0.0, 4.0),
            Op("cudaGraphLaunch", 1.2, 1.9)]
    if spans:
        host += [Op("seld.train.epoch", 0.5, 3.0),
                 Op("seld.train.replay", 0.5, 0.6),
                 Op("seld.train.replay", 2.0, 2.2),
                 Op("seld.feed.epoch_index", 0.2, 0.4)]
    return DeviceTrace(dev, host, 0.0, 4.0)


def _score_trace(spans=True):
    """A 2-s window of 2 clips: the card busy over [0, 0.5] and [1, 1.5];
    the front-end [0.1, 0.3], the normaliser [0.3, 0.35], the scorer
    [0.4, 1.2] holding a chunk's windows [0.45, 1.0]."""
    dev = [Op("foa_frontend_kernel", 0.0, 0.5), Op("gemm", 1.0, 1.5)]
    host = [Op("seld_bench.traced_window", 0.0, 2.0)]
    if spans:
        host += [Op("seld.score.frontend", 0.1, 0.3),
                 Op("seld.score.normalize", 0.3, 0.35),
                 Op("seld.score.ensemble", 0.4, 1.2),
                 Op("seld.score.windows", 0.45, 1.0)]
    return DeviceTrace(dev, host, 0.0, 2.0)


def test_the_span_readers_on_known_intervals():
    # idle [1, 2] and [3.5, 4]; the program's spans [0.2, 0.4], [0.5, 3]:
    # they share [1, 2], a quarter of the window
    assert _read("program_idle.train", _train_trace()) == pytest.approx(25.0)
    # (0.1 + 0.2) s over 1 epoch of 2 steps
    assert _read("replay_host_ms.train", _train_trace()) == \
        pytest.approx(150.0)
    assert _read("feed_ms.train", _train_trace(), items=2) == \
        pytest.approx(100.0)
    # idle [0.5, 1] and [1.5, 2]; spans [0.1, 0.35] and [0.4, 1.2]: 0.5 s
    assert _read("program_idle.score", _score_trace()) == pytest.approx(25.0)
    # the union 0.25 + 0.8 s over 2 clips
    assert _read("host_ms.score", _score_trace(), units=2) == \
        pytest.approx(525.0)


@pytest.mark.parametrize("metric,trace", [
    ("program_idle.train", _train_trace), ("replay_host_ms.train",
                                           _train_trace),
    ("feed_ms.train", _train_trace), ("program_idle.score", _score_trace),
    ("host_ms.score", _score_trace)])
def test_a_span_reader_reads_nothing_without_its_spans(metric, trace):
    assert _read(metric, trace(spans=False)) is None
    # nor without a card under the run
    t = trace()
    assert _read(metric, DeviceTrace([], t.host_ops, t.start, t.end)) is None


@pytest.mark.parametrize("windows,rows,share", [
    (541, 1024, 52.83203125), (2164, 2168, 99.81549815498155)])
def test_the_useful_rows_reader(windows, rows, share, monkeypatch):
    monkeypatch.setattr(profiling, "counts", collections.Counter(
        {"score.windows": windows, "score.window_rows": rows}))
    assert _read("useful_rows.score", _score_trace()) == pytest.approx(share)
    monkeypatch.setattr(profiling, "counts", collections.Counter())
    assert _read("useful_rows.score", _score_trace()) is None
    # a program without counts (the commit before them)
    monkeypatch.delattr(profiling, "counts")
    assert _read("useful_rows.score", _score_trace()) is None


# ------------------------------------------------- profile_step's idle


def test_idle_share_counts_overlapping_streams_once():
    """Two streams' kernels over the same 10 us of a 12-us window: the card
    is idle 2 us. Summed device time (20 us) would read -67%, which the
    old guard refused as a double count."""
    from seld_tpu_torch.utils.trace_analysis import idle_share
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 100.0,
               "dur": 10.0},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 100.0,
               "dur": 10.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 104.0,
               "dur": 2.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 98.0,
               "dur": 12.0}]
    assert idle_share(events, 12.0) == pytest.approx(2.0 / 12.0)
    assert idle_share(events[:1] + events[3:], 20.0) == pytest.approx(0.5)


# --------------------------------------------------------------- card


def _events(prof):
    from seld_tpu_torch.utils.trace_analysis import profile_events
    return [ev for ev in profile_events(prof) if ev.get("ph") == "X"]


def _span_ops(events, name):
    return [ev for ev in events if ev.get("cat") == "user_annotation"
            and ev["name"] == name]


def _launched_by(events, spans):
    """The device's kernels whose launch (a CUDA API call, by
    correlation id) lies inside one of `spans`: {span index: [kernels]}."""
    calls = [ev for ev in events
             if ev.get("cat") in ("cuda_runtime", "cuda_driver")]
    out = collections.defaultdict(list)
    for i, s in enumerate(spans):
        ids = {c["args"].get("correlation") for c in calls
               if s["ts"] <= c["ts"] <= s["ts"] + s["dur"]}
        out[i] = [k for k in events if k.get("cat") == "kernel"
                  and k["args"].get("correlation") in ids]
    return out


@pytest.mark.card
def test_spans_share_the_clock_of_the_card(card):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cell = _score_cell(False, 1, card)
    with profile(activities=activities) as prof:
        cell.item(record=False)
        torch.cuda.synchronize()
    events = _events(prof)
    span = _span_ops(events, "seld.score.frontend")[0]
    first = min(float(ev["ts"]) for ev in events if ev.get("cat") == "kernel"
                and "foa_frontend_" in ev["name"])
    lead_ms = (first - float(span["ts"])) / 1e3
    train = _train_cell(card)
    with profile(activities=activities) as prof:
        train.item()
        torch.cuda.synchronize()
    events = _events(prof)
    replays = sorted(_span_ops(events, "seld.train.replay"),
                     key=lambda ev: ev["ts"])
    kernels = _launched_by(events, replays)
    leads = [(min(float(k["ts"]) for k in kernels[i]) - float(s["ts"])) / 1e3
             for i, s in enumerate(replays)]
    print(json.dumps({"frontend_kernel_after_span_ms": lead_ms,
                      "replays": len(replays),
                      "replay_kernels": [len(kernels[i])
                                         for i in range(len(replays))],
                      "replay_first_kernel_after_span_ms": leads,
                      "card": torch.cuda.get_device_name(card)}))
    assert 0.0 <= lead_ms < 50.0
    assert len(replays) == train.steps_per_item
    assert all(kernels[i] for i in range(len(replays)))
    assert all(lead >= 0.0 for lead in leads)
