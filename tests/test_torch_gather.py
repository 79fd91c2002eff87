"""The port's row gather (seld_tpu_torch/ops/gather.py) against the JAX
package's Pallas gather (seld_tpu/ops/pallas/gather.py, interpret mode, as
tests/test_pallas.py runs it): a copy, so exactly equal. Also the packed
staging helpers, copied from the JAX module."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from seld_tpu.ops.pallas import gather as JG
from seld_tpu_torch.ops import gather as G

torch.set_num_threads(1)


def _ids(rng, n, b):
    return rng.randint(0, n, b).astype(np.int32)


def test_f32_3d_rows_equal_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(17, 6, 64).astype(np.float32)       # row = 3 x 128
    ids = _ids(rng, 17, 9)
    want = np.asarray(JG.gather_rows(jnp.asarray(x), jnp.asarray(ids),
                                     interpret=True))
    got = G.gather_rows(torch.from_numpy(x), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_4d_rows_equal_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(11, 30, 64, 4).astype(ml_dtypes.bfloat16)
    ids = _ids(rng, 11, 8)
    want = np.asarray(JG.gather_rows(jnp.asarray(x), jnp.asarray(ids),
                                     interpret=True))
    xt = torch.from_numpy(x.view(np.uint16).astype(np.int32)).to(
        torch.int16).view(torch.bfloat16)
    got = G.gather_rows(xt, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("inflight", [1, 5, 16])
def test_packed_rows_equal_jax_dma_gather(inflight):
    rng = np.random.RandomState(6)
    x = rng.randn(19, 6, 5, 7).astype(np.float32)     # row 210 -> rp 8
    assert G.packed_rows(x.shape[1:]) == JG.packed_rows(x.shape[1:]) == 8
    xp = G.pack_rows(x)
    np.testing.assert_array_equal(xp, JG.pack_rows(x))
    ids = _ids(rng, 19, 12)
    want = np.asarray(JG.gather_rows(jnp.asarray(xp), jnp.asarray(ids),
                                     inflight=inflight, interpret=True))
    got = G.gather_rows(torch.from_numpy(xp), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        G.unpack_rows(got, x.shape[1:]).numpy(),
        np.asarray(JG.unpack_rows(jnp.asarray(want), x.shape[1:])))
    np.testing.assert_array_equal(G.unpack_rows(got, x.shape[1:]).numpy(),
                                  x[ids])


def test_pack_rows_tile_exact_and_label_rows():
    rng = np.random.RandomState(8)
    x = rng.randn(3, 8, 128).astype(np.float32)       # row 1024, exact
    np.testing.assert_array_equal(G.pack_rows(x), JG.pack_rows(x))
    y = rng.randn(7, 60, 48).astype(np.float32)       # the feed's labels
    ids = _ids(rng, 7, 5)
    got = G.gather_rows(torch.from_numpy(y), torch.from_numpy(ids))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JG.gather_rows(jnp.asarray(y),
                                               jnp.asarray(ids))))


def test_out_of_range_ids_raise_on_the_cpu():
    x = torch.zeros(4, 3)
    with pytest.raises(IndexError):
        G.gather_rows(x, torch.tensor([0, 4], dtype=torch.int32))
