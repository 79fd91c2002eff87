"""The port's augment applications (seld_tpu_torch/data/transforms.py)
against the JAX package's augments (seld_tpu/data/transforms.py), on the
7-channel FOA input and the joint 17-channel FOA+MIC input.

Each JAX augment draws from a key; the test makes the same draws from the
same key splits the JAX function makes and hands them to the port's
application step. Outputs and co-transformed labels must then be exactly
equal (f32; the augments only select, negate, zero or add one gain).
The host-side CGMM mask (float64 EM) agrees to 1e-6 relative. The
port's own draws come from a torch.Generator: the SS5 recipe's compose is
reproducible from its seed.
"""
import itertools

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


def _batch(seed=0, channels=7, batch=B):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, TIME, FREQ, channels).astype(np.float32)
    y = rng.randn(batch, 60, 4 * N_CLASSES).astype(np.float32)
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
    """7 channels: the gain on mels 0:4; the joint 17-channel input: the
    same gain on 0:4 and on the mic mels 7:11."""
    for channels in (7, 17):
        x, y = _batch(3, channels)
        key = jax.random.PRNGKey(9)
        want_x, _ = JT.random_ups_and_downs(key, jnp.asarray(x), y)
        gain = jax.random.normal(key, ()) * 0.2
        got_x, got_y = T.random_ups_and_downs_apply(torch.from_numpy(x), y,
                                                    _t(gain))
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        assert got_y is y
        moved = (got_x.numpy() != x).any(axis=(0, 1, 2))
        assert list(np.flatnonzero(moved)) == (
            [0, 1, 2, 3] if channels == 7 else [0, 1, 2, 3, 7, 8, 9, 10])
    got, _ = T.random_ups_and_downs(torch.Generator().manual_seed(0),
                                    torch.zeros(1, 4, 4, 17), None)
    assert got.shape == (1, 4, 4, 17)


def test_mic_gcc_perm_matches_jax():
    perms = np.concatenate([JT.CHANNEL_LIST[:, 0], np.asarray(
        list(itertools.permutations(range(4))))])
    want = np.asarray(JT.mic_gcc_perm(jnp.asarray(perms)))
    got = T.mic_gcc_perm(torch.from_numpy(perms).long()).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8 + 24, 6)


@pytest.mark.parametrize("seed", [5, 6])
def test_acs_aug_matches_jax(seed):
    """From JAX's draws (one randint of [B] rows in [0, 8) from the key),
    the joint features and the labels come out bitwise equal."""
    x, y = _batch(seed, 17, batch=8)
    key = jax.random.PRNGKey(seed)
    want_x, want_y = JT.acs_aug(key, jnp.asarray(x), jnp.asarray(y))
    idx = jax.random.randint(key, (8,), 0, 8)
    assert len(set(np.asarray(idx).tolist())) > 3
    got_x, got_y = T.acs_aug_apply(torch.from_numpy(x), torch.from_numpy(y),
                                   _t(idx))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    # the port's own draws: 8 rows from the generator, in [0, 8)
    gen = torch.Generator().manual_seed(seed)
    drawn = T.draw_acs(gen, 8)
    assert drawn.shape == (8,) and 0 <= int(drawn.min()) <= int(drawn.max()) < 8
    a = T.acs_aug(torch.Generator().manual_seed(seed), torch.from_numpy(x),
                  torch.from_numpy(y))
    b = T.acs_aug_apply(torch.from_numpy(x), torch.from_numpy(y), drawn)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cgmm_mask_aug_matches_jax():
    x = np.random.RandomState(8).randn(2, 12, 6, 4).astype(np.float32)
    got = T.cgmm_mask_aug(x)
    want = JT.cgmm_mask_aug(x)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert not np.array_equal(got, x)


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


def test_joint_recipe_uses_the_channel_swap():
    """--use_both --use_acs: the augment is acs_aug (17 channels), and the
    recipe is reproducible from its seed."""
    augment = build_augment(_ss5_config(use_both=True))
    x, y = (torch.from_numpy(a) for a in _batch(7, 17))
    a = augment(torch.Generator().manual_seed(3), x, y)
    b = augment(torch.Generator().manual_seed(3), x, y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == x.shape
    only_acs = build_augment(_ss5_config(use_both=True, use_tfm=False))
    got = only_acs(torch.Generator().manual_seed(4), x, y)
    want = T.acs_aug(torch.Generator().manual_seed(4), x, y)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
