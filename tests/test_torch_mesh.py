"""The port's mesh record, batch sharding, sharded DeviceDataset and
strided loader (seld_tpu_torch/parallel/mesh.py, data/device_dataset.py,
data/loader.py) against the JAX package's on the same data.

Indices, shards and batches are copies and must be exactly equal: the
shuffles are the same numpy RandomState call sequences. No process group
is needed here: a rank's view of a mesh is a `Mesh` record (a group's
collectives are held in tests/test_torch_dp.py).
"""
import jax
import numpy as np
import pytest
import torch

from seld_tpu.data import loader as JL
from seld_tpu.data.device_dataset import DeviceDataset as JaxDeviceDataset
from seld_tpu.parallel import make_mesh as jax_make_mesh
from seld_tpu.parallel import parse_mesh_spec as jax_parse_mesh_spec
from seld_tpu_torch.data import loader as L
from seld_tpu_torch.data.device_dataset import DeviceDataset
from seld_tpu_torch.parallel import collectives
from seld_tpu_torch.parallel.mesh import (batch_shard_count, make_mesh,
                                          parse_mesh_spec, replicate,
                                          shard_batch)

torch.set_num_threads(1)


def _rank(rank, axes):
    """What rank `rank` of a group laid out in `axes` sees: make_mesh under
    a stand-in group of that rank and size."""
    import torch.distributed as dist
    world = int(np.prod(list(axes.values())))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "is_initialized", lambda: True)
        mp.setattr(dist, "get_world_size", lambda: world)
        mp.setattr(dist, "get_rank", lambda: rank)
        spec = ",".join(f"{k}:{v}" for k, v in axes.items())
        return make_mesh(spec, "cpu")


def _data(n=24, t=10, f=4, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, t, f, c).astype(np.float32),
            rng.randn(n, 5, 8).astype(np.float32))


@pytest.mark.parametrize("spec,n", [
    ("data:-1", 8), ("data:4,model:2", 8), ("data:-1,model:2", 8),
    ("data:3", 8), ("a:-1,b:-1", 8), ("data:-1,model:3", 8),
    ("data:2", 2), ("data:-1", 1), ("model:2,data:-1", 4)])
def test_parse_mesh_spec_copy_equals_jax(spec, n):
    """(1): tests/test_mesh.py's cases and a few more, value for value and
    error for error."""
    try:
        want = jax_parse_mesh_spec(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            parse_mesh_spec(spec, n)
    else:
        assert parse_mesh_spec(spec, n) == want


def test_make_mesh_without_a_group_is_one_rank():
    """No process group: world 1, today's single-card path (no
    collective), and a spec for more ranks raises."""
    mesh = make_mesh("data:-1", "cpu")
    assert (mesh.world, mesh.rank, mesh.data_size, mesh.data_index) == \
        (1, 0, 1, 0)
    assert not mesh.distributed and mesh.device == torch.device("cpu")
    assert make_mesh("data:1", "cpu").axes == {"data": 1}
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh("data:2", "cpu")
    with collectives.data_parallel(mesh):
        assert collectives.active() is None
        t = torch.arange(4.0)
        assert collectives.gather_rows(t) is t
        assert collectives.rows_of(t) is t


@pytest.mark.parametrize("spec", ["data:4,model:2", "model:2,data:4"])
def test_ranks_take_jax_device_layout(spec):
    """Rank r sits where np.reshape puts device r in JAX's mesh: its data
    index is the device's row on the data axis, and ranks that differ
    only on the model axis hold the same rows."""
    jmesh = jax_make_mesh(spec)
    axes = parse_mesh_spec(spec, 8)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    x = torch.arange(16.0).reshape(16, 1)
    for rank in range(8):
        mesh = _rank(rank, axes)
        pos = np.argwhere(ids == jax.devices()[rank].id)[0]
        assert mesh.data_index == pos[jmesh.axis_names.index("data")]
        assert mesh.primary == (pos[jmesh.axis_names.index("model")] == 0)
        assert batch_shard_count(mesh) == 4
        np.testing.assert_array_equal(
            shard_batch(x, mesh).numpy(), x[4 * mesh.data_index:
                                            4 * mesh.data_index + 4])


def test_shard_batch_and_replicate_at_one_rank():
    x, y = torch.arange(12.0).reshape(6, 2), torch.arange(6)
    assert shard_batch((x, y), None)[0] is x
    got = shard_batch((x, y), _rank(1, {"data": 3}))
    assert torch.equal(got[0], x[2:4]) and torch.equal(got[1], y[2:4])
    with pytest.raises(ValueError, match="does not shard evenly"):
        shard_batch(x, _rank(0, {"data": 4}))
    w = {"w": torch.ones(3)}
    assert replicate(w, make_mesh("data:-1", "cpu")) is w


def _assert_global_batches(per_rank, want):
    """Rank r's batch i is rows [r B/N, (r+1) B/N) of global batch i."""
    want = list(want)
    got = [list(ds) for ds in per_rank]
    assert all(len(g) == len(want) > 0 for g in got)
    for i, (wx, wy) in enumerate(want):
        np.testing.assert_array_equal(
            torch.cat([g[i][0] for g in got]).numpy(), np.asarray(wx))
        np.testing.assert_array_equal(
            torch.cat([g[i][1] for g in got]).numpy(), np.asarray(wy))


def test_sharded_device_dataset_matches_jax():
    """(5): eval batches of a 2-shard DeviceDataset, gathered over the
    ranks, equal JAX's on a 2-device mesh (and the dataset's order); train
    batches too, each rank drawing only from its own shard, the tail that
    does not divide trimmed."""
    jmesh = jax_make_mesh("data:2", devices=jax.devices()[:2])
    x, y = _data(n=30)                      # 3 clips x 10 windows
    ranks = [_rank(r, {"data": 2}) for r in range(2)]
    evals = [DeviceDataset(x, y, 10, "cpu", train=False, mesh=m)
             for m in ranks]
    want = JaxDeviceDataset(x, y, 10, jmesh, train=False)
    _assert_global_batches(evals, want)
    _assert_global_batches(evals, JL.SeldDataset(x, y, 99, train=False,
                                                 windows_per_clip=10))
    x, y = _data(n=25)                      # 12 windows a shard, 1 trimmed
    trains = [DeviceDataset(x, y, 8, "cpu", loop_time=2, seed=3, mesh=m)
              for m in ranks]
    want = JaxDeviceDataset(x, y, 8, jmesh, loop_time=2, seed=3)
    assert [len(d) for d in trains] == [len(want)] * 2 == [6, 6]
    assert [d.n_windows for d in trains] == [want.n_windows] * 2 == [24] * 2
    for _ in range(2):                      # two epochs: the shuffle moves
        _assert_global_batches(trains, want)
    for r, ds in enumerate(trains):
        sx, _ = ds.device_arrays
        np.testing.assert_array_equal(sx.numpy(), x[12 * r:12 * r + 12])
        idx = ds.epoch_index_matrix()
        assert tuple(idx.shape) == (6, 4) and int(idx.max()) < 12
    with pytest.raises(ValueError, match="divide over"):
        DeviceDataset(x, y, 9, "cpu", mesh=ranks[0])


def test_strided_loader_matches_jax():
    """(6): SeldDataset(process_index, process_count): the strided slices,
    the global-derived step count, RandomState(seed + index) and the
    refusal of strided eval, as the JAX loader."""
    x, y = _data(n=23)
    for index in range(2):
        kw = dict(loop_time=2, seed=4, process_index=index,
                  process_count=2)
        got = L.SeldDataset(x, y, 4, **kw)
        want = JL.SeldDataset(x, y, 4, **kw)
        assert len(got) == len(want) == 5
        np.testing.assert_array_equal(got.x, want.x)
        for _ in range(2):
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError, match="train-only"):
        L.SeldDataset(x, y, 4, train=False, process_index=1,
                      process_count=2)
