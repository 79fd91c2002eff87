"""The port's streaming SELD metric (seld_tpu_torch/train/metrics.py)
against the JAX package's (seld_tpu/train/metrics.py) on the same random
predictions: every accumulator after a few updates, the scores, the
class-wise recall and precision, the SELD score, merging, and a sed
threshold other than 0.5.

Tolerance: the counts are sums of 0/1 values and must be equal; the
angular-error total and the scores are f32 sums of arccos values, to
1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.train import metrics as JM
from seld_tpu_torch.train import metrics as TM

torch.set_num_threads(1)
N_CLASSES = 12
RTOL = 1e-5


def _batch(seed, b=3, t=20):
    """Labels with unit DOA vectors; predictions near the labels in some
    frames and away from them in others, so every branch of the metric
    (matched close, matched far, missed, inserted) is hit."""
    rng = np.random.RandomState(seed)
    sed = (rng.rand(b, t, N_CLASSES) < 0.1).astype(np.float32)
    xyz = rng.randn(b, t, 3, N_CLASSES)
    xyz /= np.linalg.norm(xyz, axis=2, keepdims=True)
    doa = (xyz * sed[:, :, None]).reshape(b, t, -1).astype(np.float32)
    false_alarm = rng.rand(b, t, N_CLASSES) < 0.03
    sed_p = np.clip(sed * 0.7 + 0.3 * rng.rand(b, t, N_CLASSES)
                    + 0.75 * false_alarm, 0, 1).astype(np.float32)
    noise = rng.randn(b, t, 3, N_CLASSES) * rng.choice([0.05, 2.0],
                                                       (b, t, 1, 1))
    doa_p = (xyz + noise).reshape(b, t, -1).astype(np.float32)
    return (sed, doa), (sed_p, doa_p)


def _init(mod):
    return (TM.init_state(N_CLASSES, "cpu") if mod is TM
            else JM.init_state(N_CLASSES))


def _accumulate(mod, as_array, batches, **kwargs):
    state = _init(mod)
    for y, p in batches:
        state = mod.update(state, tuple(map(as_array, y)),
                           tuple(map(as_array, p)), **kwargs)
    return state


def _compare(got, want):
    for key, w in want.items():
        g = got[key].numpy()
        if key in ("total_DE",):
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)


@pytest.mark.parametrize("sed_threshold,block", [(0.5, 10), (0.3, 10),
                                                 (0.7, 20)])
def test_update_result_and_scores_match_jax(sed_threshold, block):
    batches = [_batch(s) for s in range(3)]
    kwargs = dict(doa_threshold=20.0, block_size=block,
                  sed_threshold=sed_threshold)
    want = _accumulate(JM, jnp.asarray, batches, **kwargs)
    got = _accumulate(TM, torch.from_numpy, batches, **kwargs)
    assert set(got) == set(want)
    _compare(got, want)
    assert float(want["DE_TP"]) > 0 and float(want["FN"]) > 0 \
        and float(want["FP"]) > 0

    want_r, got_r = JM.result(want), TM.result(got)
    for g, w in zip(got_r, want_r):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    for g, w in zip(TM.class_result(got), JM.class_result(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    np.testing.assert_allclose(TM.calculate_seld_score(got_r).numpy(),
                               np.asarray(JM.calculate_seld_score(want_r)),
                               rtol=RTOL)


def test_empty_state_scores_and_merge():
    got, want = _init(TM), _init(JM)
    for g, w in zip(TM.result(got), JM.result(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w))
    a = _accumulate(TM, torch.from_numpy, [_batch(3)])
    b = _accumulate(TM, torch.from_numpy, [_batch(4)])
    both = _accumulate(TM, torch.from_numpy, [_batch(3), _batch(4)])
    merged = TM.merge(a, b)
    for key in both:
        torch.testing.assert_close(merged[key], both[key])


def test_unbatched_input_and_block_check():
    (sed, doa), (sed_p, doa_p) = _batch(5, b=1)
    args = [torch.from_numpy(a[0]) for a in (sed, doa, sed_p, doa_p)]
    got = TM.update(_init(TM), args[:2], args[2:])
    want = JM.update(JM.init_state(N_CLASSES),
                     (jnp.asarray(sed[0]), jnp.asarray(doa[0])),
                     (jnp.asarray(sed_p[0]), jnp.asarray(doa_p[0])))
    _compare(got, want)
    with pytest.raises(ValueError, match="divisible"):
        TM.update(_init(TM), args[:2], args[2:],
                  block_size=7)


def test_seld_metrics_class():
    batches = [_batch(s) for s in (6, 7)]
    got = TM.SELDMetrics(n_classes=N_CLASSES, device="cpu")
    want = JM.SELDMetrics(n_classes=N_CLASSES)
    for (y, p) in batches:
        got.update_states(tuple(map(torch.from_numpy, y)),
                          tuple(map(torch.from_numpy, p)))
        want.update_states(tuple(map(jnp.asarray, y)),
                           tuple(map(jnp.asarray, p)))
    for g, w in zip(got.result(), want.result()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    for g, w in zip(got.class_result(), want.class_result()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    got.reset_states()
    assert float(got.state["Nref"]) == 0.0


def test_metric_state_defaults_to_the_card():
    """Like every entry point of the port, the metric state lives on the
    card unless the caller asks for the CPU."""
    import inspect
    assert inspect.signature(TM.init_state).parameters["device"].default \
        == "cuda"
    assert inspect.signature(TM.SELDMetrics).parameters["device"].default \
        == "cuda"
