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


def _bf16(x):
    """An ml_dtypes bfloat16 array as a torch bfloat16 tensor, bit for bit."""
    return torch.from_numpy(x.view(np.uint16).astype(np.int32)).to(
        torch.int16).view(torch.bfloat16)


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("case", ["one", "x_and_labels", "byte_rows"])
def test_gather_batch_equals_jax_per_array(case):
    """gather_batch gathers one or two arrays by one ids vector (the feed's
    x and y); each output equals the JAX Pallas gather of that array,
    including a y whose 30-byte rows take the kernel's byte-wise copy."""
    rng = np.random.RandomState(11)
    n = 13
    x = rng.randn(n, 30, 16, 7).astype(ml_dtypes.bfloat16)
    arrays = {"one": [x],
              "x_and_labels": [x, rng.randn(n, 60, 48).astype(np.float32)],
              "byte_rows": [x, rng.randn(n, 3, 5).astype(ml_dtypes.bfloat16)]
              }[case]
    ids = _ids(rng, n, 9)
    tensors = [_bf16(a) if a.dtype == ml_dtypes.bfloat16
               else torch.from_numpy(a) for a in arrays]
    got = G.gather_batch(tensors, torch.from_numpy(ids))
    assert isinstance(got, tuple) and len(got) == len(arrays)
    for g, a, t in zip(got, arrays, tensors):
        want = np.asarray(JG.gather_rows(jnp.asarray(a), jnp.asarray(ids),
                                         interpret=True))
        assert g.dtype == t.dtype and tuple(g.shape) == want.shape
        np.testing.assert_array_equal(
            _bits(g), want.view(np.uint16) if a.dtype == ml_dtypes.bfloat16
            else want)
    for g, w in zip(got, G.gather_batch_ref(tensors, torch.from_numpy(ids))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["arrays", "ids_dtype", "ids_2d",
                                  "contig", "scalar", "too_many_ids"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The CUDA wrapper's checks run before any library load; they are
    plain tensor checks, so CPU tensors exercise them here."""
    from seld_tpu_torch.ops import kernels
    x, y = torch.zeros(6, 4), torch.zeros(6, 2)
    ids = torch.zeros(3, dtype=torch.int32)
    arrays = (x, y)
    if case == "arrays":
        arrays = (x, y, x)
    elif case == "ids_dtype":
        ids = ids.long()
    elif case == "ids_2d":
        ids = ids.reshape(3, 1)
    elif case == "contig":
        arrays = (x.t(), y)
    elif case == "scalar":
        arrays = (torch.zeros(()),)
    elif case == "too_many_ids":
        ids = torch.zeros(G._MAX_ROWS + 1, dtype=torch.int32)
    loaded = dict(kernels._libs)
    with pytest.raises(ValueError):
        G._gather_batch_cuda(arrays, ids)
    assert kernels._libs == loaded


def test_gather_rows_is_the_one_array_case():
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(10, 3, 4).astype(np.float32))
    ids = torch.from_numpy(_ids(rng, 10, 7))
    assert torch.equal(G.gather_rows(x, ids), G.gather_batch((x,), ids)[0])
    assert torch.equal(G.gather_rows_ref(x, ids), x[ids.long()])
    with pytest.raises(ValueError, match="cpu or cuda"):
        G.gather_rows(torch.empty(4, 3, device="meta"), ids)
