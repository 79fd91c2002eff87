"""The control (the plain reference in the program's place, computed in
the precision below the cell's) and each fault the reference can plant
must come out not correct under each cell's limits: at a tiny size on the
CPU for training (fp8 products; the CPU has no TF32, so the scoring
control runs on the card only), and at the cells' own sizes on the card,
where the program must come out correct.

On the card, each case prints its readings as one JSON line (run with
`-s` to keep them): the readings the cells' limits were set from.

    python -m pytest seld_bench/tests -m card -s
"""
import gc
import json

import pytest
import torch

from seld_bench import harness
from seld_bench.tests.tiny import tiny_workload

torch.set_num_threads(1)


def _correct(values, limits):
    return all(r.ok for r in harness.readings_with_limits(values, limits))


def _readings(wl, seed, device):
    """A cell's set-up and the items whose outputs its check judges, the
    program freed; then the readings of the program, of the control and
    of each fault the driver plants."""
    cell = harness.driver(wl.traffic["driver"]).Cell(
        wl.config, wl.traffic, seed, device)
    cell.setup()
    for _ in range(wl.traffic.get("check_clips", 0)
                   // wl.traffic.get("clip_batch", 1)):
        cell.item()
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"program": cell.check(details=True),
           "control": cell.check_control(details=True)}
    for fault in cell.FAULTS:
        out[fault] = cell.check_control(fault=fault, details=True)
    return out


@pytest.mark.parametrize("workload", ["ss5.train_b256",
                                      "seldnet.train_b256"])
def test_the_fp8_control_fails_at_a_tiny_size(workload):
    wl = tiny_workload(workload)
    wl = wl._replace(traffic=dict(wl.traffic, compute_dtype="float32"))
    readings = _readings(wl, 2 ** 31 + 7, torch.device("cpu"))
    assert _correct(readings.pop("program"), wl.limits)
    assert set(readings) == {"control", "half"}
    for side, values in readings.items():
        assert not _correct(values, wl.limits), side


@pytest.mark.card
@pytest.mark.parametrize("workload", [s["name"] for s in
                                      harness.benchmark()["workloads"]])
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
def test_the_control_fails_and_the_program_passes_on_the_card(
        card, workload, seed):
    wl = harness.workload(workload)
    readings = _readings(wl, seed, card)
    print(json.dumps({"workload": workload, "seed": seed,
                      "card": torch.cuda.get_device_name(card),
                      "readings": readings}), flush=True)
    assert _correct(readings.pop("program"), wl.limits)
    for side, values in readings.items():
        assert not _correct(values, wl.limits), side
