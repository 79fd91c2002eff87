"""The plain references against the port's CPU path at toy sizes."""
import pytest
import torch

from seld_bench import harness
from seld_bench.reference import common as R
from seld_bench.tests.tiny import tiny_config, tiny_workload

torch.set_num_threads(1)


def _model(name, config, seed=11):
    from seld_tpu_torch.models import build_model
    model = build_model(config["model"], tuple(config["input_shape"]),
                        config["model_config"], device="cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = harness.make_weights(shapes, seed, "cpu")
    model.load_state_dict(weights)
    return model, weights


@pytest.mark.parametrize("name", ["ss5", "seldnet"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_port(name, train):
    """Full widths, a few 100-frame windows; in training with the conformers'
    dropout masks drawn from generators seeded alike."""
    from seld_tpu_torch.ops.dropout import set_dropout_generator
    config = harness.workload(f"{name}.train_b256").config
    config = dict(config, input_shape=[100, 64, 7])
    model, weights = _model(name, config)
    ref = harness.reference(config)
    x = torch.randn(3, 100, 64, 7, generator=torch.Generator().manual_seed(1))
    set_dropout_generator(model, torch.Generator().manual_seed(5))
    drop = R.Dropout(torch.Generator().manual_seed(5) if train else None)
    with torch.no_grad():
        got = model.train(train)(x)
        want = ref.forward(weights, x, config["model_config"], train, drop)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() < 1e-5


def test_trunk_and_head_compose_to_the_whole():
    config = tiny_config("ss5")
    _, weights = _model("ss5", config)
    ref = harness.reference(config)
    x = torch.randn(2, 100, 64, 7)
    mc, drop = config["model_config"], R.Dropout(None)
    whole = ref.forward(weights, x, mc, False, drop)
    split = ref.forward(weights, ref.forward(weights, x, mc, False, drop,
                                             "trunk"), mc, False, drop, "head")
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


@pytest.mark.parametrize("workload", ["ss5.train_b256",
                                      "seldnet.train_b256"])
def test_training_steps_follow_the_port(workload):
    """The loss, autograd gradients, AGC and AdaBelief of the reference
    against the port's epoch step and feed, three steps in f32."""
    wl = tiny_workload(workload)
    traffic = dict(wl.traffic, compute_dtype="float32")
    cell = harness.driver("train").Cell(wl.config, traffic, 2 ** 31 + 3,
                                        "cpu")
    cell.setup()
    cell.item()
    cell.release()
    got = cell.check()
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-3
    assert got["update_gap"] < 1e-4


def test_front_end_matches_the_port():
    from seld_tpu_torch.ops.frontend import fused_foa_frontend
    from seld_bench.drivers.score import make_clips
    wav = make_clips(2, 2, 24000, 9, "cpu")
    got = fused_foa_frontend(wav)
    want = R.foa_features(wav)
    assert got.shape == want.shape == (2, 101, 64, 7)
    assert (got[..., :4] - want[..., :4]).abs().max().item() < 1e-3
    assert (got[..., 4:] - want[..., 4:]).abs().max().item() < 1e-3


@pytest.mark.parametrize("workload", ["ss5.score_exact", "ss5.score_fast_b4"])
def test_clip_scoring_follows_the_port(workload):
    """Front-end, normaliser, windows (exact, or trunk once and the head),
    overlap averaging: the reference against the port's outputs."""
    wl = tiny_workload(workload)
    cell = harness.driver("score").Cell(wl.config, wl.traffic, 41, "cpu")
    cell.setup()
    for _ in range(2):
        cell.item()
    cell.release()
    assert cell.check()["output_gap"] < 1e-5


def test_fp8_rounds_and_passes_the_gradient():
    t = torch.linspace(-3, 3, 101, requires_grad=True)
    q = R.fp8(t)
    err = (q - t).abs()
    # e4m3 keeps 3 mantissa bits: within 2^-4 of each value, and not exact
    assert err.max().item() > 0
    assert bool((err <= t.abs() * 2 ** -4 + 1e-6).all())
    q.sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))
