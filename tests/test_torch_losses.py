"""The port's losses (seld_tpu_torch/train/losses.py) against the JAX
package's (seld_tpu/train/losses.py) on the same numpy inputs.

Tolerance: 1e-5 relative in f32 — the same elementwise formulas and one
mean or masked sum each over ~10^3 terms; only the summation order
differs (measured up to 1.7e-6 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.train import losses as JL
from seld_tpu_torch.train import losses as TL

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-7
N_CLASSES = 12


def _targets(seed=0, b=4, t=10):
    rng = np.random.RandomState(seed)
    sed = (rng.rand(b, t, N_CLASSES) < 0.3).astype(np.float32)
    doa = (np.clip(rng.randn(b, t, 3 * N_CLASSES), -1, 1)
           * np.repeat(sed, 3, axis=-1)).astype(np.float32)
    # unit-norm active DOA vectors, as real labels are
    xyz = doa.reshape(b, t, 3, N_CLASSES)
    norm = np.sqrt((xyz ** 2).sum(axis=2, keepdims=True))
    doa = (xyz / np.maximum(norm, 1e-6)).reshape(b, t, -1)
    sed_p = rng.rand(b, t, N_CLASSES).astype(np.float32)
    doa_p = rng.randn(b, t, 3 * N_CLASSES).astype(np.float32)
    return sed, doa, sed_p, doa_p


def _both(fn_name, *arrays, **kwargs):
    want = getattr(JL, fn_name)(*map(jnp.asarray, arrays), **kwargs)
    got = getattr(TL, fn_name)(*map(torch.from_numpy, arrays), **kwargs)
    return got, np.asarray(want)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_class_weights_and_sample_counts():
    np.testing.assert_array_equal(TL.DCASE2021_TRAIN_SAMPLES,
                                  JL.DCASE2021_TRAIN_SAMPLES)
    _close(TL.class_weights_from_samples(TL.DCASE2021_TRAIN_SAMPLES),
           np.asarray(JL.class_weights_from_samples(
               JL.DCASE2021_TRAIN_SAMPLES)))


def test_doa_mask():
    _, doa, _, _ = _targets(1)
    got, want = _both("_doa_mask", doa)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= {0.0, 1.0}


@pytest.mark.parametrize("weighted", [False, True])
def test_mmse(weighted):
    _, doa, _, doa_p = _targets(2)
    if weighted:
        cw = np.array(JL.class_weights_from_samples(
            JL.DCASE2021_TRAIN_SAMPLES))
        got, want = _both("MMSE_with_cls_weights", doa, doa_p, cw)
    else:
        got, want = _both("MMSE", doa, doa_p)
    _close(got, want)


@pytest.mark.parametrize("edge", ["inside", "zero_and_one"])
def test_binary_crossentropy_clips_at_1e7(edge):
    sed, _, sed_p, _ = _targets(3)
    if edge == "zero_and_one":
        # exact 0 and 1 predictions: the clip keeps the log finite
        sed_p = np.where(sed_p < 0.5, 0.0, 1.0).astype(np.float32)
    got, want = _both("binary_crossentropy", sed, sed_p)
    assert np.isfinite(want).all()
    _close(got, want)


@pytest.mark.parametrize("reduce", [True, False])
def test_focal_loss(reduce):
    sed, _, sed_p, _ = _targets(4)
    got, want = _both("focal_loss", sed, sed_p, reduce=reduce)
    _close(got, want)


@pytest.mark.parametrize("kind,smoothing,weighted", [
    ("BCE", 0.0, False), ("BCE", 0.0, True), ("BCE", 0.1, True),
    ("FOCAL", 0.0, False), ("FOCAL", 0.0, True), ("FOCAL", 0.2, True)])
def test_sed_loss_with_weights(kind, smoothing, weighted):
    """With class weights, FOCAL is mean(focal) * mean(weights): the
    reference's quirk (trainv2.py:41), which both packages keep."""
    sed, _, sed_p, _ = _targets(5)
    cw = (np.array(JL.class_weights_from_samples(
        JL.DCASE2021_TRAIN_SAMPLES)) if weighted else None)
    got = TL.sed_loss_with_weights(
        torch.from_numpy(sed), torch.from_numpy(sed_p),
        None if cw is None else torch.from_numpy(cw),
        label_smoothing=smoothing, kind=kind)
    want = JL.sed_loss_with_weights(
        jnp.asarray(sed), jnp.asarray(sed_p),
        None if cw is None else jnp.asarray(cw),
        label_smoothing=smoothing, kind=kind)
    _close(got, np.asarray(want))
    if kind == "FOCAL" and weighted:
        plain = TL.focal_loss(
            torch.from_numpy(sed * (1 - smoothing) + 0.5 * smoothing),
            torch.from_numpy(sed_p))
        torch.testing.assert_close(got, plain * float(cw.mean()))


def test_sed_loss_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown sed loss"):
        TL.sed_loss_with_weights(torch.zeros(2), torch.zeros(2), kind="L1")


@pytest.mark.parametrize("name", ["MAE", "MSE", "MSLE", "MMSE"])
def test_get_doa_loss(name):
    _, doa, _, doa_p = _targets(6)
    got = TL.get_doa_loss(name)(torch.from_numpy(doa),
                                torch.from_numpy(doa_p))
    want = JL.get_doa_loss(name)(jnp.asarray(doa), jnp.asarray(doa_p))
    assert np.isfinite(np.asarray(want))
    _close(got, np.asarray(want))


def test_get_doa_loss_rejects_unknown():
    with pytest.raises(ValueError, match="unknown doa loss"):
        TL.get_doa_loss("HUBER")


def test_losses_keep_gradients():
    """The train step differentiates through them: the gradient of the
    weighted sum equals jax.grad's."""
    import jax
    sed, doa, sed_p, doa_p = _targets(7)
    cw = np.array(JL.class_weights_from_samples(JL.DCASE2021_TRAIN_SAMPLES))

    def jax_loss(sp, dp):
        return (JL.sed_loss_with_weights(jnp.asarray(sed), sp, cw)
                + 1000 * JL.MMSE_with_cls_weights(jnp.asarray(doa), dp, cw))

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(sed_p),
                                              jnp.asarray(doa_p))
    sp = torch.from_numpy(sed_p).requires_grad_()
    dp = torch.from_numpy(doa_p).requires_grad_()
    cwt = torch.from_numpy(cw)
    (TL.sed_loss_with_weights(torch.from_numpy(sed), sp, cwt)
     + 1000 * TL.MMSE_with_cls_weights(torch.from_numpy(doa), dp, cwt)
     ).backward()
    np.testing.assert_allclose(sp.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dp.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)
