"""The port's clip path (seld_tpu_torch/inference/ensemble.py and the
trunk/head split of models/models.py) against the JAX package's
`ensemble_outputs` and `ConvTemporal.apply(stage=...)` on the same bridged
weights and numpy clips, and the official scoring and threshold search on
the same outputs and ground-truth CSVs.

Setup: narrow SS5 (tests/test_torch_model.py::narrow_ss5) for [60, 16, 7]
windows (12 label frames, trunk time stride 5), clips of 200 frames at
win 60 / step 5 (29 windows; at batch_size 8 four chunks of 8 rows, the
last holding 5 windows and 3 padded rows).
Tolerance: 1e-5 abs / 1e-4 rel in f32 (the model test's); the split's
trunk -> head against the full forward, 1e-6 abs; scores and searched
thresholds exactly equal.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import narrow_ss5, random_variables

from seld_tpu.inference import ensemble as jens
from seld_tpu.models import build_model as jax_build_model
from seld_tpu.models.models import \
    conv_temporal_trunk_blocks as jax_trunk_blocks
from seld_tpu.utils import io as jio
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.inference import ensemble as tens
from seld_tpu_torch.models import build_model
from seld_tpu_torch.models.models import conv_temporal_trunk_blocks

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4
SHAPE = (60, 16, 7)
WIN, STEP, BATCH = 60, 5, 8


def _pair(cfg=None, seed=1):
    cfg = copy.deepcopy(cfg or narrow_ss5())
    cfg["n_classes"] = 12
    jm = jax_build_model("conv_temporal", SHAPE, cfg)
    v = random_variables(jm, SHAPE, seed=seed)
    model = build_model("conv_temporal", SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    return jm, v, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _clips(n, frames=200, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(frames, *SHAPE[1:]).astype(np.float32)
            for _ in range(n)]


def _close(got, want, atol=ATOL, rtol=RTOL):
    assert len(got) == len(want)
    for (gs, gd), (ws, wd) in zip(got, want):
        assert tuple(gs.shape) == tuple(np.shape(ws))
        assert gs.dtype == torch.float32
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=atol,
                                   rtol=rtol)
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=atol,
                                   rtol=rtol)


def test_trunk_head_split_equals_full_and_jax(pair):
    jm, v, model = pair
    x = np.random.RandomState(4).randn(2, *SHAPE).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        full = model(xt)
        trunk = model(xt, stage="trunk")
        split = model(trunk, stage="head")
        # the trunk is sized by nothing: a 200-frame clip gives 40 frames
        long = model(torch.from_numpy(_clips(1)[0])[None], stage="trunk")
    assert tuple(trunk.shape) == (2, 12, 32) and long.shape[1] == 40
    for a, b in zip(split, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    jtrunk = jm.apply(v, jnp.asarray(x), train=False, stage="trunk")
    jsplit = jm.apply(v, jtrunk, train=False, stage="head")
    np.testing.assert_allclose(trunk.numpy(), np.asarray(jtrunk), atol=ATOL,
                               rtol=RTOL)
    for a, b in zip(split, jsplit):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    with pytest.raises(ValueError, match="stage"):
        model(xt, stage="middle")


def test_trunk_block_rule_matches_jax():
    """SS5's trunk is mother_stage (strides [1, 3]) + the dense stage; a
    squeeze-and-excitation mother stage or a time stride ends it."""
    cfg = narrow_ss5()
    se = copy.deepcopy(cfg)
    se["BLOCK0_ARGS"]["squeeze_ratio"] = 0.5
    strided = copy.deepcopy(cfg)
    strided["BLOCK0_ARGS"]["strides"] = [2, 1]
    dense_first = copy.deepcopy(cfg)
    dense_first["BLOCK0"], dense_first["BLOCK1"] = cfg["BLOCK1"], \
        cfg["BLOCK0"]
    dense_first["BLOCK0_ARGS"], dense_first["BLOCK1_ARGS"] = \
        cfg["BLOCK1_ARGS"], cfg["BLOCK0_ARGS"]
    got = [conv_temporal_trunk_blocks(c)
           for c in (cfg, se, strided, dense_first)]
    assert got == [jax_trunk_blocks(c)
                   for c in (cfg, se, strided, dense_first)]
    assert got[:3] == [2, 0, 0]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_ensemble_outputs_match_jax(pair, fast):
    jm, v, model = pair
    clips = _clips(2) + _clips(1, frames=WIN, seed=5)
    want = jens.ensemble_outputs(jm.apply, v, clips, win_size=WIN,
                                 step_size=STEP, batch_size=BATCH, fast=fast)
    got = tens.ensemble_outputs(model, clips, win_size=WIN, step_size=STEP,
                                batch_size=BATCH, fast=fast)
    assert tuple(got[0][0].shape) == (40, 12)
    assert tuple(got[0][1].shape) == (40, 36)
    _close(got, want)


@pytest.mark.parametrize("n_win,batch_size,shards,plan", [
    (541, 512, 1, (2, 272)),    # a 60-s clip: 544 rows, not 1,024
    (29, 24, 1, (2, 16)),
    (31, 24, 2, (2, 16)),
    (31, 24, 3, (2, 24)),
    (21, 8, 1, (3, 8)),
    (1024, 512, 1, (2, 512)),   # n_win a multiple of batch_size
    (29, 8, 1, (4, 8)),
    (1, 512, 1, (1, 8)),
    (5, 6, 2, (1, 6)),          # a batch_size under 8 a shard bounds rows
])
def test_the_chunk_plan(n_win, batch_size, shards, plan):
    n_chunks, rows = tens._chunk_plan(n_win, batch_size, shards)
    assert (n_chunks, rows) == plan
    assert n_chunks == -(-n_win // batch_size)
    assert rows <= batch_size and rows % shards == 0
    assert n_chunks * rows >= n_win


def test_the_chunk_plan_refuses_a_batch_the_axis_does_not_divide():
    with pytest.raises(ValueError, match="a batch of 25 windows does not "
                       "shard evenly over the 2-way data axis"):
        tens._chunk_plan(31, 25, 2)


def test_exact_path_runs_the_planned_rows_and_matches_jax(pair, tmp_path):
    """29 windows at batch_size 24: two chunks of 16 rows (32 counted, not
    2 x 24), the same outputs as the JAX package's padded chunks."""
    from seld_tpu_torch.utils import profiling
    jm, v, model = pair
    clips = _clips(1, seed=13)
    want = jens.ensemble_outputs(jm.apply, v, clips, win_size=WIN,
                                 step_size=STEP, batch_size=24)
    with profiling.trace(str(tmp_path)):
        got = tens.ensemble_outputs(model, clips, win_size=WIN,
                                    step_size=STEP, batch_size=24)
        counts = dict(profiling.counts)
    assert counts == {"score.windows": 29, "score.window_rows": 32}
    _close(got, want)


def test_clip_batch_matches_jax_batched_path(pair):
    """clip_batch=3 over four equal clips and a shorter one: a stacked
    group of 3, a group of 1 and the ragged clip alone."""
    jm, v, model = pair
    clips = _clips(4, seed=2) + _clips(1, frames=150, seed=3)
    want = jens.ensemble_outputs(jm.apply, v, clips, win_size=WIN,
                                 step_size=STEP, batch_size=BATCH, fast=True,
                                 clip_batch=3)
    got = tens.ensemble_outputs(model, clips, win_size=WIN, step_size=STEP,
                                batch_size=BATCH, fast=True, clip_batch=3)
    _close(got, want)
    one_at_a_time = tens.ensemble_outputs(model, clips, win_size=WIN,
                                          step_size=STEP, batch_size=BATCH,
                                          fast=True)
    _close(got, [(s.numpy(), d.numpy()) for s, d in one_at_a_time])


def test_squeeze_excitation_trunk_is_the_stem_alone():
    """With SE in the mother stage the trunk is the stem only, and the fast
    path slides everything after it, as the JAX package does."""
    cfg = narrow_ss5()
    cfg["BLOCK0_ARGS"]["squeeze_ratio"] = 0.5
    jm, v, model = _pair(cfg, seed=2)
    clips = _clips(1, seed=6)
    want = jens.ensemble_outputs(jm.apply, v, clips, win_size=WIN,
                                 step_size=STEP, batch_size=BATCH, fast=True)
    got = tens.ensemble_outputs(model, clips, win_size=WIN, step_size=STEP,
                                batch_size=BATCH, fast=True)
    _close(got, want)


def test_the_geometry_errors(pair):
    jm, v, model = pair
    x = _clips(1)
    # a step that is not a whole number of label frames (multiplier 5)
    with pytest.raises(ValueError, match="multiple"):
        tens.ensemble_outputs(model, x, win_size=WIN, step_size=3,
                              batch_size=BATCH)
    # the fast path's step must land on trunk frames
    with pytest.raises(ValueError, match="trunk time stride"):
        tens.ensemble_outputs(model, x, win_size=WIN, step_size=3,
                              batch_size=BATCH, fast=True)
    # a time_down that is not the model's
    with pytest.raises(ValueError, match="time_down"):
        tens.ensemble_outputs(model, x, win_size=WIN, step_size=STEP,
                              batch_size=BATCH, fast=True, time_down=1)
    with pytest.raises(ValueError, match="time_down"):
        tens.ensemble_outputs(model, x * 4, win_size=WIN, step_size=STEP,
                              fast=True, time_down=1, clip_batch=2)
    for fast in (False, True):   # and the JAX package raises the same
        with pytest.raises(ValueError):
            jens.ensemble_outputs(jm.apply, v, x, win_size=WIN, step_size=3,
                                  batch_size=BATCH, fast=fast)


def test_refuses_a_mesh_and_a_clip_on_another_device(pair):
    _, _, model = pair
    from seld_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="'data' alone"):
        tens.ensemble_outputs(model, _clips(1), data_axis="batch",
                              mesh=make_mesh("data:-1", "cpu"))
    with pytest.raises(ValueError, match="meta"):
        tens.ensemble_outputs(model, [torch.zeros(200, 16, 7,
                                                  device="meta")],
                              win_size=WIN, step_size=STEP)


def test_variables_override_and_eval_mode(pair):
    """`variables` scores other weights through the same model (the SWA
    average); the model's own mode comes back as it was."""
    _, _, model = pair
    other = _pair(seed=3)[2]
    clips = _clips(1, seed=7)
    want = tens.ensemble_outputs(other, clips, win_size=WIN, step_size=STEP,
                                 batch_size=BATCH)
    model.train()
    got = tens.ensemble_outputs(model, clips, win_size=WIN, step_size=STEP,
                                batch_size=BATCH,
                                variables=dict(other.state_dict()))
    assert model.training
    model.eval()
    _close(got, [(s.numpy(), d.numpy()) for s, d in want], atol=0, rtol=0)


def test_frames_and_overlap_add_match_jax():
    x = np.random.RandomState(8).randn(23, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tens.sliding_windows(torch.from_numpy(x), 7, 4).numpy(),
        np.asarray(jens.sliding_windows(jnp.asarray(x), 7, 4)))
    frames = np.random.RandomState(9).randn(5, 6, 2).astype(np.float32)
    np.testing.assert_allclose(
        tens.overlap_add(torch.from_numpy(frames), 2).numpy(),
        np.asarray(jens.overlap_add(jnp.asarray(frames), 2)), atol=1e-6)


def test_average_ensemble_matches_jax():
    rng = np.random.RandomState(10)
    outs = [[(rng.rand(40, 12).astype(np.float32),
              rng.randn(40, 36).astype(np.float32)) for _ in range(3)]
            for _ in range(2)]
    want = jens.average_ensemble([[(jnp.asarray(s), jnp.asarray(d))
                                   for s, d in m] for m in outs])
    got = tens.average_ensemble([[(torch.from_numpy(s), torch.from_numpy(d))
                                  for s, d in m] for m in outs])
    _close(got, want, atol=0, rtol=0)


def _gt_tree(root, names, frames, seed=11):
    """Ground-truth CSVs (polar, as DCASE ships them) with a few events."""
    rng = np.random.RandomState(seed)
    gt = root / "gt"
    gt.mkdir()
    for name in names:
        sed = np.zeros((frames, 12), np.float32)
        doa = np.zeros((frames, 3, 12), np.float32)
        for _ in range(4):
            c, t0 = rng.randint(12), rng.randint(frames - 10)
            vec = rng.randn(3)
            sed[t0:t0 + 10, c] = 1
            doa[t0:t0 + 10, :, c] = vec / np.linalg.norm(vec)
        jio.write_answer(str(gt), name + ".csv", sed, doa.reshape(frames, -1))
    return str(gt)


def _outputs(names, frames, seed=12):
    rng = np.random.RandomState(seed)
    return [(rng.rand(frames, 12).astype(np.float32),
             np.tanh(rng.randn(frames, 36)).astype(np.float32))
            for _ in names]


def test_official_score_and_threshold_search_match_jax(tmp_path):
    names = ["fold6_room1_mix001", "fold6_room1_mix002"]
    frames = 60
    gt = _gt_tree(tmp_path, names, frames)
    outs = _outputs(names, frames)
    touts = [(torch.from_numpy(s), torch.from_numpy(d)) for s, d in outs]
    th = np.linspace(0.3, 0.7, 12).astype(np.float32)
    want = jens.evaluate_clips_official(outs, names, gt, str(tmp_path / "j"),
                                        thresholds=th, gt_polar=False)
    got = tens.evaluate_clips_official(touts, names, gt, str(tmp_path / "t"),
                                       thresholds=th, gt_polar=False)
    assert got[0] == want[0]
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    for a, b in zip(sorted((tmp_path / "j").iterdir()),
                    sorted((tmp_path / "t").iterdir())):
        assert a.read_text() == b.read_text()
    want_th, want_best = jens.search_thresholds(
        outs, names, gt, str(tmp_path / "js"), gt_polar=False,
        candidates=(0.3, 0.5, 0.7))
    got_th, got_best = tens.search_thresholds(
        touts, names, gt, str(tmp_path / "ts"), gt_polar=False,
        candidates=(0.3, 0.5, 0.7))
    np.testing.assert_array_equal(got_th, want_th)
    assert got_best == want_best
