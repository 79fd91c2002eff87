"""The port's augment applications (seld_tpu_torch/data/transforms.py)
against the JAX package's augments (seld_tpu/data/transforms.py).

Each JAX augment draws from a key; the test makes the same draws from the
same key splits the JAX function makes and hands them to the port's
application step. Outputs and co-transformed labels must then be exactly
equal (f32; the augments only select, negate, zero or add one gain). The
port's own draws come from a torch.Generator: the SS5 recipe's compose is
reproducible from its seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.data import transforms as JT
from seld_tpu_torch.data import transforms as T
from seld_tpu_torch.train.main import build_augment

torch.set_num_threads(1)
B, TIME, FREQ, N_CLASSES = 4, 300, 64, 12


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, TIME, FREQ, 7).astype(np.float32)
    y = rng.randn(B, 60, 4 * N_CLASSES).astype(np.float32)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("axis,max_size,n_mask", [(-3, 6, 10), (-2, 8, 6),
                                                  (-3, None, 1),
                                                  (-2, 16, 1)])
def test_batch_mask_matches_jax(axis, max_size, n_mask):
    x, _ = _batch(1)
    key = jax.random.PRNGKey(axis + 7 * n_mask)
    want = JT.batch_mask(key, jnp.asarray(x), axis=axis,
                         max_mask_size=max_size, n_mask=n_mask, period=100)
    # _chunk_masks: rs, ro = split(key); sizes then offsets
    rows = B * (TIME // 100)
    total = 100 if axis == -3 else FREQ
    rs, ro = jax.random.split(key)
    sizes = jax.random.randint(rs, (rows, n_mask), 0, max_size or total)
    offsets = jax.random.randint(ro, (rows, n_mask), 0, total)
    got = T.batch_mask_apply(torch.from_numpy(x), axis, _t(sizes),
                             _t(offsets), period=100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).any() and (got != 0).any()


def test_batch_mask_rejects_a_ragged_period_and_axis():
    with pytest.raises(ValueError, match="rest must be 0"):
        T.batch_mask(torch.Generator(), torch.zeros(1, 30, 4, 7), -3,
                     period=100)
    with pytest.raises(ValueError, match="unsupported"):
        T.batch_mask(torch.Generator(), torch.zeros(1, 100, 4, 7), -1)


def test_foa_intensity_vec_aug_matches_jax():
    x, y = _batch(2)
    key = jax.random.PRNGKey(5)
    want_x, want_y = JT.foa_intensity_vec_aug(key, jnp.asarray(x),
                                              jnp.asarray(y))
    r_flip, r_perm = jax.random.split(key)
    flip = jax.random.randint(r_flip, (B, 3), 0, 2)
    swap = jax.random.randint(r_perm, (B, 1), 0, 2)
    assert 0 < int(swap.sum()) < B          # both branches of the swap
    got_x, got_y = T.foa_intensity_vec_aug_apply(
        torch.from_numpy(x), torch.from_numpy(y), _t(flip), _t(swap))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_random_ups_and_downs_matches_jax():
    x, y = _batch(3)
    key = jax.random.PRNGKey(9)
    want_x, _ = JT.random_ups_and_downs(key, jnp.asarray(x), y)
    gain = jax.random.normal(key, ()) * 0.2
    got_x, got_y = T.random_ups_and_downs_apply(torch.from_numpy(x), y,
                                                _t(gain))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    assert got_y is y
    with pytest.raises(NotImplementedError, match="item 8"):
        T.random_ups_and_downs(torch.Generator(), torch.zeros(1, 4, 4, 17),
                               None)


def test_split_total_labels_to_sed_doa():
    x, y = _batch(4)
    _, (sed, doa) = T.split_total_labels_to_sed_doa(x, torch.from_numpy(y))
    _, (jsed, jdoa) = JT.split_total_labels_to_sed_doa(x, jnp.asarray(y))
    np.testing.assert_array_equal(sed.numpy(), np.asarray(jsed))
    np.testing.assert_array_equal(doa.numpy(), np.asarray(jdoa))


def _ss5_config(**kw):
    from types import SimpleNamespace
    base = dict(use_tfm=True, use_acs=True, swa=True, tfm_period=100,
                time_mask_size=24, freq_mask_size=16)
    return SimpleNamespace(**{**base, **kw})


def test_ss5_recipe_is_reproducible_from_its_seed():
    augment = build_augment(_ss5_config())
    x, y = (torch.from_numpy(a) for a in _batch(5))

    def run(seed):
        return augment(torch.Generator().manual_seed(seed), x, y)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == x.shape and a[1].shape == y.shape
    # labels change only where the FOA aug moves them: the SED part stays
    assert torch.equal(a[1][..., :N_CLASSES], y[..., :N_CLASSES])
    assert build_augment(_ss5_config(use_tfm=False, use_acs=False)) is None
