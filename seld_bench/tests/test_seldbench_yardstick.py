"""The frozen yardstick, the benchmark's file layout and its imports."""
import ast
import json
import os
import re

import pytest

from seld_bench import harness
from seld_bench.yardstick.peaks import bound_s
from seld_bench.yardstick.trace import DeviceTrace, family, union
from seld_bench.yardstick.work import (GRULaunch, frontend_work,
                                       gru_bwd_work, gru_fwd_work)

PKG = harness.PKG
BENCH = harness.benchmark()


def test_gru_counts_pin_the_bound_notes():
    g = GRULaunch(2, 60, 256, 128, 2, 2)
    product = 2 * 2 * 60 * 256 * 128 * 3 * 128
    assert product == pytest.approx(3.02e9, rel=1e-3)
    flops, _ = gru_fwd_work(g)
    assert flops == product + 10 * 2 * 60 * 256 * 128     # 3.06 GFLOP
    assert gru_bwd_work(g)[0] == pytest.approx(9.06e9, rel=1e-3)
    # f32 x_proj and hs with an f32 Rk: the 31.9 MB of the forward's note
    # less the 0.4 MB the note's Rk counts for bf16 ones
    _, nbytes = gru_fwd_work(GRULaunch(2, 60, 256, 128, 2, 4))
    assert nbytes == pytest.approx(31.85e6, rel=1e-3)


@pytest.mark.parametrize("name", sorted({c["name"] for c in
                                         BENCH["configs"]}))
def test_the_gru_steps_are_those_the_reference_runs(name, monkeypatch):
    """The GRU rooflines take each layer's steps from the model's time
    pooling (`gru_layers`): the lengths the reference's biGRUs run."""
    import torch

    from seld_bench.reference.common import Dropout
    from seld_tpu_torch.models import build_model
    config = next(harness.workload(s["name"]).config
                  for s in BENCH["workloads"] if s["config"] == name)
    ref = harness.reference(config)
    cfg, shape = config["model_config"], tuple(config["input_shape"])
    model = build_model(config["model"], shape, cfg, device="cpu")
    P = {k: torch.empty(v.shape, device="meta")
         for k, v in model.state_dict().items()}
    seen, gru = [], ref.gru_bidirectional
    monkeypatch.setattr(ref, "gru_bidirectional", lambda x, P, n: (
        seen.append((P[f"{n}.recurrent_kernel"].shape[1], x.shape[1])),
        gru(x, P, n))[1])
    ref.forward(P, torch.empty((2, *shape), device="meta"), cfg, False,
                Dropout(None))
    assert ref.gru_layers(cfg, shape[0]) == seen


def test_frontend_counts_pin_the_bound_notes():
    flops, nbytes = frontend_work(8, 3001)
    assert nbytes == pytest.approx(227e6, rel=5e-3)
    assert flops == pytest.approx(3.3e9, rel=2e-2)
    # bytes-bound at 3.35 TB/s: 0.0679 ms a chunk of 8
    assert bound_s(flops, nbytes) == pytest.approx(67.9e-6, rel=5e-3)


def test_union_and_idle():
    assert union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    ev = [{"ph": "X", "cat": "kernel", "name": "gru_fwd_k", "ts": 0,
           "dur": 2e6},
          {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise",
           "ts": 1e6, "dur": 2e6},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 3e6,
           "dur": 1e6}]
    t = DeviceTrace.from_chrome(ev, (0.0, 4.0))
    assert t.busy_s() == pytest.approx(3.0)
    assert t.seconds_by(lambda n: family(n) == "gru_scan") == \
        pytest.approx(2.0)
    assert t.idle_gaps() == [["aten::copy_", pytest.approx(1.0)]]


def test_every_workload_resolves_its_files():
    names = {"end_to_end": set(), "per_layer": set()}
    for key in names:
        for m in BENCH[key]:
            names[key].add(m["name"])
    for spec in BENCH["workloads"]:
        wl = harness.workload(spec["name"])
        assert wl.config["name"] == spec["config"]
        assert harness.driver(wl.traffic["driver"]).Cell
        assert harness.reference(wl.config).forward
        assert wl.limits, f"limits/{spec['name']}.json"
        reported = [m for m in BENCH["end_to_end"]
                    if spec["name"] in m.get("workloads", [spec["name"]])]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(spec["name"] in m.get("workloads", [])
                   for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == \
            (m["unit"], m["layer"], m["moves"], m["source"])
        assert m["moves"] in names["end_to_end"]
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert (cfg["name"], cfg["source"], cfg["reduced"]) == \
            (c["name"], c["source"], c["reduced"])


def test_names_and_units_keep_the_allowed_characters():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            assert name.match(entry["name"])
            if "unit" in entry:
                assert unit.match(entry["unit"])
    for spec in BENCH["workloads"]:
        assert spec["chips"] == 1 and len(spec["why"]) <= 200


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                             "seld_tpu"), (path, mod)


@pytest.mark.parametrize("sub", ["reference", "yardstick"])
def test_reference_and_yardstick_import_nothing_of_the_program(sub):
    for path in _sources(sub):
        for mod in _imports(path):
            assert mod.split(".")[0] != "seld_tpu_torch", (path, mod)


def test_the_run_refuses_a_machine_without_the_card(monkeypatch, capsys):
    import torch
    from seld_bench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", BENCH["workloads"][0]["name"],
                     "--seed", "3", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
