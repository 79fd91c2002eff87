"""Data-parallel training on two gloo ranks on the CPU against one rank and
against the JAX package's sharded step (seld_tpu_torch/parallel/,
train/steps.py, data/device_dataset.py, data/loader.py).

The invariant: a step on N ranks, each holding B/N windows, gives the same
losses, gradients, updated parameters, BatchNorm running statistics and
metric state as one rank holding all B windows; only the order of the sums
may differ. Two worker processes (this file run as a script: one gloo group
of two CPU ranks) run every multi-rank scenario once; the pytest process
runs the one-rank references and the JAX side.

Narrow SS5 (tests/test_torch_model.py::narrow_ss5), input (60, 16, 7), a
global batch of 16 (8 a rank), 12 classes, AdaBelief with AGC, class-
weighted BCE + 1000 x class-weighted masked MSE + L2 1e-3.

Tolerances (f32), those of tests/test_torch_train_step.py: losses 1e-4
relative; the first step's gradients GRAD_RTOL (1e-4) of each leaf's
largest element, and below NULL_GRAD (1e-6) of the largest gradient on
both sides for a leaf whose gradient is zero in exact arithmetic (a conv
bias before a train-mode BatchNorm); parameters 2e-5 absolute for every
other leaf; running variances 1e-5 and means 1e-5 + (1 - 0.99) 2 (1.2 lr)
steps absolute; the metric state 1e-5 relative. The two ranks hold the
same state bit for bit.
"""
import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (60, 16, 7)
B, N_CLASSES, BLOCK, LR = 16, 12, 6, 1e-3
STEPS = 2
LOSS_RTOL, PARAM_ATOL, STATS_ATOL = 1e-4, 2e-5, 1e-5
GRAD_RTOL, NULL_GRAD, METRIC_RTOL = 1e-4, 1e-6, 1e-5
N_WINDOWS = 40           # the epoch's split: 20 windows a shard


def _config(dropout: bool):
    """narrow SS5 (tests/test_torch_model.py::narrow_ss5), from the port's
    own zoo copy so a worker imports no JAX."""
    from seld_tpu_torch.config import get_model_config
    cfg = copy.deepcopy(get_model_config("SS5", search_paths=[]))
    cfg["filters"] = 8
    cfg["BLOCK0_ARGS"]["filters1"] = 16
    cfg["BLOCK1_ARGS"]["units"] = 32
    cfg["BLOCK2_ARGS"]["key_dim"] = 8
    cfg["SED_ARGS"]["key_dim"] = 8
    cfg["DOA_ARGS"]["units"] = 16
    if not dropout:
        for key in ("BLOCK0", "BLOCK1", "BLOCK2", "SED", "DOA"):
            cfg.setdefault(f"{key}_ARGS", {})["dropout_rate"] = 0.0
    cfg["n_classes"] = N_CLASSES
    return cfg


def _batches(n, seed=100):
    """n global batches (x [B, 60, 16, 7], y [B, 12, 48]); every window has
    an active frame."""
    out = []
    for s in range(n):
        rng = np.random.RandomState(seed + s)
        x = rng.randn(B, *SHAPE).astype(np.float32)
        sed = (rng.rand(B, 12, N_CLASSES) < 0.2).astype(np.float32)
        sed[:, 0, 0] = 1.0
        doa = (np.clip(rng.randn(B, 12, 3 * N_CLASSES), -1, 1)
               * np.repeat(sed, 3, axis=-1)).astype(np.float32)
        out.append((torch.from_numpy(x),
                    torch.from_numpy(np.concatenate([sed, doa], -1))))
    return out


def _split(n=N_WINDOWS, seed=7):
    (x, y), = _batches(1, seed)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, B, n)
    return x[idx].contiguous(), y[idx].contiguous()


def _losses():
    from seld_tpu_torch.train import losses as TL
    cw = TL.class_weights_from_samples(TL.DCASE2021_TRAIN_SAMPLES)
    return (lambda y, p: TL.sed_loss_with_weights(y, p, cw),
            lambda y, p: TL.MMSE_with_cls_weights(y, p, cw))


def _augment():
    from seld_tpu_torch.data import transforms as T
    return T.compose(
        T.random_ups_and_downs,
        lambda g, x, y: (T.batch_mask(g, x, axis=-3, max_mask_size=6,
                                      n_mask=10, period=20), y),
        lambda g, x, y: (T.batch_mask(g, x, axis=-2, max_mask_size=8,
                                      n_mask=6, period=20), y),
        T.foa_intensity_vec_aug)


def _state(init, dropout):
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.optimizers import adabelief
    from seld_tpu_torch.train.train_state import TrainState
    model = build_model("conv_temporal", SHAPE, _config(dropout),
                        device="cpu")
    model.load_state_dict(init)
    return TrainState(model, adabelief(list(model.parameters()), LR,
                                       agc_clip=0.01), seed=3)


def _record_grads(state, grads):
    """The first step's gradients by name into `grads`."""
    names, opt_step = list(state.params), state.optimizer.step

    def recording(ps, gs):
        if not grads:
            grads.update((n, g.detach().clone()) for n, g in zip(names, gs))
        opt_step(ps, gs)
    state.optimizer.step = recording


def _snapshot(state, metric, losses, grads):
    return {"losses": np.asarray(losses),
            "params": {k: v.detach().clone() for k, v in
                       state.params.items()},
            "stats": {k: v.clone() for k, v in state.batch_stats.items()},
            "metric": {k: v.clone() for k, v in metric.items()},
            "grads": grads}


def run_steps(init, mesh, *, dropout, augment, steps=STEPS, first=0,
              state=None, grads=None):
    """`steps` make_train_step calls over the global batches [first,
    first + steps) (this rank's rows under a mesh), the augment drawn from
    its own generator; returns the snapshot and the state."""
    from seld_tpu_torch.parallel import collectives
    from seld_tpu_torch.parallel.mesh import shard_batch
    from seld_tpu_torch.train import metrics as TM
    from seld_tpu_torch.train.steps import make_train_step
    sed_loss, doa_loss = _losses()
    if state is None:
        state = _state(init, dropout)
        state.aug = torch.Generator().manual_seed(5)
    grads = {} if grads is None else grads
    _record_grads(state, grads)
    step = make_train_step(sed_loss_fn=sed_loss, doa_loss_fn=doa_loss,
                           loss_weights=(1.0, 1000.0), l2=1e-3,
                           metric_block_size=BLOCK, mesh=mesh)
    aug = _augment() if augment else None
    metric, losses = TM.init_state(N_CLASSES, "cpu"), []
    for x, y in _batches(first + steps)[first:]:
        x, y = shard_batch((x, y), mesh)
        if aug is not None:
            with collectives.data_parallel(mesh):
                x, y = aug(state.aug, x, y)
        state, metric, (sl, dl) = step(
            state, metric, x, (y[..., :N_CLASSES], y[..., N_CLASSES:]))
        losses.append((sl.item(), dl.item()))
    return _snapshot(state, metric, losses, grads), state


def epoch_idx(dataset_for_rank):
    """Each rank's local epoch index matrix and the global one (rank r's
    columns point into shard r): the 2-rank epoch's batches on one rank."""
    local = [dataset_for_rank(r).epoch_index_matrix() for r in range(2)]
    shard = N_WINDOWS // 2
    return local, torch.cat([local[0], local[1] + shard], dim=1)


def run_epoch(init, mesh, x_all, y_all, idx):
    from seld_tpu_torch.train import metrics as TM
    from seld_tpu_torch.train.steps import make_train_epoch
    sed_loss, doa_loss = _losses()
    state = _state(init, dropout=True)
    grads = {}
    _record_grads(state, grads)
    epoch = make_train_epoch(sed_loss_fn=sed_loss, doa_loss_fn=doa_loss,
                             n_classes=N_CLASSES, loss_weights=(1.0, 1000.0),
                             l2=1e-3, metric_block_size=BLOCK,
                             augment_fn=_augment(), mesh=mesh)
    state, metric, (sl, dl) = epoch(
        state, TM.init_state(N_CLASSES, "cpu"), x_all, y_all, idx,
        torch.Generator().manual_seed(9))
    return _snapshot(state, metric, torch.stack([sl, dl], 1).numpy(), grads)


def mesh_record(rank, world=2):
    """The mesh rank `rank` of a data:`world` group sees, without a group
    (what DeviceDataset reads)."""
    from seld_tpu_torch.parallel.mesh import Mesh
    return Mesh(axes={"data": world}, world=world, rank=rank,
                data_size=world, data_index=rank,
                device=torch.device("cpu"))


def _stem_inputs():
    """x [B, 12, 8, 3] whose halves differ in offset and scale, a 3x3 conv
    to 4 channels with its BatchNorm, and a cotangent for the pooled
    [B, 6, 4, 4]."""
    rng = np.random.RandomState(9)
    x = rng.randn(B, 12, 8, 3) * np.repeat([1.0, 2.0], B // 2)[
        :, None, None, None] + np.repeat([0.0, 1.0], B // 2)[
        :, None, None, None]
    arrays = (x, rng.randn(3, 3, 3, 4) * 0.3, rng.randn(4) * 0.1,
              1 + rng.randn(4) * 0.1, rng.randn(4) * 0.1,
              rng.randn(B, 6, 4, 4))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def stem_input_grad(mesh, other_thread: bool):
    """The fused stem's input gradient of sum(pooled * cotangent) for this
    rank's rows (all B without a mesh): the forward inside the step's
    data-parallel span, the backward on another thread when
    `other_thread` (the autograd engine runs a card's backward on a
    thread of its own)."""
    import threading

    from seld_tpu_torch.ops.stem import conv_bn_relu_pool
    from seld_tpu_torch.parallel import collectives
    from seld_tpu_torch.parallel.mesh import shard_batch
    x, kernel, bias, gamma, beta, cot = _stem_inputs()
    x, cot = shard_batch((x, cot), mesh)
    x.requires_grad_(True)
    with collectives.data_parallel(mesh):
        pooled, _, _ = conv_bn_relu_pool(x, kernel, bias, gamma, beta,
                                         (2, 2), 1e-3)
        loss = (pooled * cot).sum()
    out = {}

    def backward():
        out["dx"], = torch.autograd.grad(loss, x)
    if other_thread:
        thread = threading.Thread(target=backward)
        thread.start()
        thread.join()
    else:
        backward()
    return out["dx"]


def _worker(rank, world, port, workdir):
    """One rank of the gloo group: every multi-rank scenario in turn."""
    import torch.distributed as dist

    from seld_tpu_torch.data.device_dataset import DeviceDataset
    from seld_tpu_torch.parallel import collectives
    from seld_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
    from seld_tpu_torch.train import losses as TL
    from seld_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from seld_tpu_torch.train.steps import _gathered
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_mesh("data:-1", "cpu")
    assert (mesh.world, mesh.rank, mesh.data_index) == (world, rank, rank)
    init = torch.load(os.path.join(workdir, "init.pt"))
    out = {}
    out["step"], _ = run_steps(init, mesh, dropout=True, augment=True)
    out["jax_step"], _ = run_steps(init, mesh, dropout=False, augment=False,
                                   steps=1)
    # data:1,model:2 on the same group: both ranks hold the whole batch
    replicas = Mesh(axes={"data": 1, "model": 2}, world=world, rank=rank,
                    data_size=1, data_index=0, device=torch.device("cpu"),
                    distributed=True, primary=rank == 0)
    out["replicated"], _ = run_steps(init, replicas, dropout=False,
                                     augment=False, steps=1)

    # the masked MSE over shards with different active-frame counts
    y, p = torch.load(os.path.join(workdir, "mmse.pt"))
    ys, ps = shard_batch((y, p), mesh)
    with collectives.data_parallel(mesh):
        (gy,), (gp,) = _gathered((ys,), (ps,))
        out["mmse"] = TL.MMSE(gy, gp).item()
    out["mmse_local"] = TL.MMSE(ys, ps).item()

    # the stem's backward on another thread than its forward
    out["stem_dx"] = stem_input_grad(mesh, other_thread=True)

    # the epoch over this rank's shard
    x_all, y_all = _split()
    ds = DeviceDataset(x_all, y_all, B, "cpu", seed=11, mesh=mesh)
    sx, sy = ds.device_arrays
    out["epoch"] = run_epoch(init, mesh, sx, sy, ds.epoch_index_matrix())

    # a checkpoint saved by rank 0 after 2 steps, then 2 more steps; and
    # the one-rank checkpoint resumed here for 2 steps
    snap, state = run_steps(init, mesh, dropout=True, augment=True)
    collectives.all_reduce_(torch.zeros(1))             # the barrier
    if rank == 0:
        save_checkpoint(os.path.join(workdir, "two"), "ckpt", state,
                        aug_generator=state.aug)
    collectives.all_reduce_(torch.zeros(1))
    out["continued"], _ = run_steps(init, mesh, dropout=True, augment=True,
                                    first=STEPS, state=state)
    state = _state(init, dropout=True)
    state.aug = torch.Generator()
    restore_checkpoint(os.path.join(workdir, "one", "ckpt"), state,
                       aug_generator=state.aug)
    out["resumed"], _ = run_steps(init, mesh, dropout=True, augment=True,
                                  first=STEPS, state=state)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX-drawn initial weights, the one-rank checkpoint and the
    masked-MSE batch written for the workers; the two workers' results."""
    import jax
    from test_torch_model import random_variables

    from seld_tpu.models import build_model as jax_build_model
    from seld_tpu_torch.bridge import from_flax
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import save_checkpoint
    workdir = str(tmp_path_factory.mktemp("dp"))
    jm = jax_build_model("conv_temporal", SHAPE, _config(False))
    variables = jax.tree_util.tree_map(np.asarray,
                                       random_variables(jm, SHAPE))
    init = from_flax(variables, build_model("conv_temporal", SHAPE,
                                            _config(False), device="cpu"))
    torch.save(init, os.path.join(workdir, "init.pt"))
    torch.save(_mmse_batch(), os.path.join(workdir, "mmse.pt"))
    # one rank: 2 steps, a checkpoint, 2 more
    _, state = run_steps(init, None, dropout=True, augment=True)
    save_checkpoint(os.path.join(workdir, "one"), "ckpt", state,
                    aug_generator=state.aug)
    one_continued, _ = run_steps(init, None, dropout=True, augment=True,
                                 first=STEPS, state=state)

    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         workdir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False)
             for r in range(2)]
    return {"init": init, "variables": variables, "ranks": ranks,
            "one_continued": one_continued, "workdir": workdir}


def _mmse_batch():
    """A DOA batch whose two halves hold 30 and 2 active (frame, class)
    pairs: the masked MSE of the whole differs from the mean of the
    halves'."""
    rng = np.random.RandomState(3)
    sed = np.zeros((B, 12, N_CLASSES), np.float32)
    flat = sed[:B // 2].reshape(-1)
    flat[rng.choice(flat.size, 30, replace=False)] = 1
    sed[B // 2:].reshape(-1)[:2] = 1
    y = np.clip(rng.randn(B, 12, 3 * N_CLASSES), -1, 1) * np.repeat(sed, 3,
                                                                    -1)
    p = rng.randn(B, 12, 3 * N_CLASSES)
    return (torch.from_numpy(y.astype(np.float32)),
            torch.from_numpy(p.astype(np.float32)))


def _null_leaves(grads):
    top = max(g.abs().max().item() for g in grads.values())
    return {n for n, g in grads.items()
            if g.abs().max().item() < NULL_GRAD * top}


def _assert_ranks_equal(a, b):
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for part in ("params", "stats", "metric"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def _assert_same_step(got, want, steps=STEPS):
    """`got` (2 ranks) against `want` (1 rank) to the module's
    tolerances."""
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    null = _null_leaves(want["grads"]) if want["grads"] else set()
    if want["grads"]:
        top = max(g.abs().max().item() for g in want["grads"].values())
        for name, w in want["grads"].items():
            g = got["grads"][name]
            if name in null:
                assert g.abs().max().item() < NULL_GRAD * top, name
            else:
                torch.testing.assert_close(
                    g, w, rtol=0, atol=GRAD_RTOL * w.abs().max().item(),
                    msg=name)
    for name, w in want["params"].items():
        if name not in null:
            torch.testing.assert_close(got["params"][name], w, rtol=0,
                                       atol=PARAM_ATOL, msg=name)
    for name, w in want["stats"].items():
        atol = STATS_ATOL + (name.endswith("mean")
                             * (1 - 0.99) * 2 * 1.2 * LR * steps)
        torch.testing.assert_close(got["stats"][name], w, rtol=0, atol=atol,
                                   msg=name)
    for name, w in want["metric"].items():
        torch.testing.assert_close(got["metric"][name], w,
                                   rtol=METRIC_RTOL, atol=1e-6, msg=name)


def test_two_rank_step_equals_one_rank_step_with_dropout_and_augments(runs):
    """(2): 2 steps on 2 ranks (8 windows each) against 2 steps on one rank
    (16 windows), dropout and the trainer's augments on: losses, first-step
    gradients, parameters, BatchNorm statistics and the metric state."""
    want, _ = run_steps(runs["init"], None, dropout=True, augment=True)
    r0, r1 = (r["step"] for r in runs["ranks"])
    _assert_ranks_equal(r0, r1)
    _assert_same_step(r0, want)
    assert np.all(np.isfinite(r0["losses"]))


def test_two_rank_step_matches_jax_sharded_step(runs, monkeypatch):
    """(3): one step on 2 ranks against the JAX package's make_train_step
    on an 8-device data:8 mesh (GSPMD: BatchNorm statistics, losses and
    gradients over the global batch), dropout off: losses, gradients,
    parameters, statistics and the metric."""
    import jax
    import jax.numpy as jnp
    import optax

    from seld_tpu.models import build_model as jax_build_model
    from seld_tpu.parallel import make_mesh, replicate, shard_batch
    from seld_tpu.train import losses as JL
    from seld_tpu.train import metrics as JM
    from seld_tpu.train.optimizers import adabelief as jax_adabelief
    from seld_tpu.train.steps import make_train_step as jax_make_train_step
    from seld_tpu.train.train_state import TrainState as JaxTrainState
    from seld_tpu_torch.bridge import from_flax
    monkeypatch.setenv("SELD_FUSED_STEM", "always")
    variables = runs["variables"]
    jm = jax_build_model("conv_temporal", SHAPE, _config(False))
    cw = JL.class_weights_from_samples(JL.DCASE2021_TRAIN_SAMPLES)
    mesh = make_mesh("data:8")

    def keep(grads, state, params=None):
        return grads, grads
    tx = optax.chain(optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), keep),
        jax_adabelief(LR, agc_clip=0.01))
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=tx,
        rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(
        sed_loss_fn=lambda y, p: JL.sed_loss_with_weights(y, p, cw),
        doa_loss_fn=lambda y, p: JL.MMSE_with_cls_weights(y, p, cw),
        loss_weights=(1.0, 1000.0), l2=1e-3, metric_block_size=BLOCK,
        donate=False)
    (x, y), = _batches(1)
    with mesh:
        jstate = replicate(jstate, mesh)
        xs, ys = shard_batch((x.numpy(), y.numpy()), mesh)
        jstate, jmetric, (sl, dl) = jstep(
            jstate, replicate(JM.init_state(N_CLASSES), mesh), xs,
            (ys[..., :N_CLASSES], ys[..., N_CLASSES:]))
    want = {"losses": np.asarray([[float(sl), float(dl)]])}
    model_names = from_flax(variables)
    flat = from_flax({"params": jax.tree_util.tree_map(
        np.asarray, jstate.opt_state[0])})
    want["grads"] = {k: v.float() for k, v in flat.items()}
    state = from_flax({"params": jax.tree_util.tree_map(
        np.asarray, jstate.params), "batch_stats": jax.tree_util.tree_map(
        np.asarray, jstate.batch_stats)})
    want["params"] = {k: v for k, v in state.items() if k in want["grads"]}
    want["stats"] = {k: v for k, v in state.items()
                     if k not in want["grads"]}
    want["metric"] = {k: torch.from_numpy(np.array(v))
                      for k, v in jmetric.items()}
    assert set(want["params"]) | set(want["stats"]) == set(model_names)
    got = runs["ranks"][0]["jax_step"]
    _assert_ranks_equal(got, runs["ranks"][1]["jax_step"])
    _assert_same_step(got, want, steps=1)


def test_a_model_axis_replicates_the_batch(runs):
    """A mesh data:1,model:2 over the two ranks: both hold all 16 windows
    (a non-data axis replicates, as in the JAX trainer) and the step
    equals one rank's, dropout off (each rank draws its own slot's
    masks)."""
    want, _ = run_steps(runs["init"], None, dropout=False, augment=False,
                        steps=1)
    r0, r1 = (r["replicated"] for r in runs["ranks"])
    _assert_ranks_equal(r0, r1)
    _assert_same_step(r0, want, steps=1)


def test_masked_mse_over_shards_is_global(runs):
    """(4): the halves hold 30 and 2 active pairs; 2 ranks compute the
    masked MSE of the whole batch (the local numerators over the global
    mask sum), not the mean of the halves' MSEs."""
    from seld_tpu_torch.train import losses as TL
    y, p = _mmse_batch()
    want = TL.MMSE(y, p).item()
    got = [r["mmse"] for r in runs["ranks"]]
    halves = [r["mmse_local"] for r in runs["ranks"]]
    np.testing.assert_allclose(got, [want, want], rtol=1e-6)
    assert abs(np.mean(halves) - want) > 0.05 * want


def test_stem_backward_on_another_thread_takes_the_global_batch(runs):
    """The fused stem's backward run on another thread than its forward
    (as the autograd engine runs a card's) still forms stem_dy's terms
    from the global batch: each rank's input gradient equals its rows of
    one rank's over the whole batch, whose halves differ in offset and
    scale."""
    want = stem_input_grad(None, other_thread=False)
    got = torch.cat([r["stem_dx"] for r in runs["ranks"]])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=GRAD_RTOL * want.abs().max().item())


def test_two_rank_epoch_equals_one_rank_epoch(runs):
    """(8): make_train_epoch(mesh=...) on 2 ranks, each gathering from its
    staged shard, against the one-rank epoch over the whole split with the
    global index matrix the two shards' make (dropout and augments on)."""
    from seld_tpu_torch.data.device_dataset import DeviceDataset
    x_all, y_all = _split()
    local, idx = epoch_idx(lambda r: DeviceDataset(
        x_all, y_all, B, "cpu", seed=11, mesh=mesh_record(r)))
    want = run_epoch(runs["init"], None, x_all, y_all, idx)
    r0, r1 = (r["epoch"] for r in runs["ranks"])
    _assert_ranks_equal(r0, r1)
    assert r0["losses"].shape == (N_WINDOWS // 2 // (B // 2), 2)
    _assert_same_step(r0, want, steps=len(r0["losses"]))


def test_checkpoints_resume_across_rank_counts(runs):
    """(7): a checkpoint saved by rank 0 of 2 resumes on 1 rank, and one
    saved on 1 rank resumes on 2; each continues its run's trajectory (2
    more steps, dropout and augments on)."""
    from seld_tpu_torch.train.checkpoint import restore_checkpoint
    init = runs["init"]
    state = _state(init, dropout=True)
    state.aug = torch.Generator()
    restore_checkpoint(os.path.join(runs["workdir"], "two", "ckpt"), state,
                       aug_generator=state.aug)
    on_one, _ = run_steps(init, None, dropout=True, augment=True,
                          first=STEPS, state=state)
    two = runs["ranks"][0]
    _assert_ranks_equal(two["continued"], runs["ranks"][1]["continued"])
    _assert_same_step(on_one, two["continued"], steps=2 * STEPS)
    _assert_ranks_equal(two["resumed"], runs["ranks"][1]["resumed"])
    _assert_same_step(two["resumed"], runs["one_continued"],
                      steps=2 * STEPS)


def test_cli_mesh_trains_on_three_gloo_ranks(tmp_path, monkeypatch):
    """--mesh data:3 on the CPU: the training CLI spawns three gloo ranks
    that read the wav tree (the host feed: strided train slices, each
    10-window eval clip padded to 12 and cut back), rank 0 alone writes the
    scalars and the checkpoint, and the logged val scalars equal one rank's
    evaluation of that checkpoint on the whole val split."""
    import json

    from test_torch_trainer import _model_config, _write_wav_tree

    from seld_tpu_torch.config.params import get_param
    from seld_tpu_torch.parallel.mesh import make_mesh
    from seld_tpu_torch.train import main as cli
    from seld_tpu_torch.train.checkpoint import latest_best, \
        restore_checkpoint
    from seld_tpu_torch.train.trainer import SELDTrainer
    _write_wav_tree(tmp_path)
    os.makedirs(tmp_path / "model_config")
    with open(tmp_path / "model_config" / "narrow.json", "w") as f:
        json.dump(_model_config(), f)
    flags = ["--name", "dp", "--model", "conv_temporal", "--model_config",
             "narrow", "--doa_loss", "MMSE", "--abspath", str(tmp_path),
             "--from_wav", "--use_tfm", "--use_acs", "--agc", "true",
             "--batch", "3", "--loop_time", "1", "--epoch", "1",
             "--eval_every", "0"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    done = subprocess.run(
        [sys.executable, "-m", "seld_tpu_torch.train", *flags, "--mesh",
         "data:3", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout + done.stderr
    run = "conv_temporal_narrow_MMSE_dp_v_0"
    with open(tmp_path / "tensorboard_log" / run / "scalars.jsonl") as f:
        logged = [json.loads(line) for line in f]
    tags = [r["tag"] for r in logged]
    assert len(tags) == len(set(tags)) and "val/val_sedLoss" in tags
    assert done.stdout.count("best val seld score") == 1   # rank 0 alone

    monkeypatch.chdir(tmp_path)
    config, model_config = get_param(flags + ["--mesh", "data:3"])
    assert config.name == run
    datasets, _ = cli.build_datasets(config, "cpu")
    trainer = SELDTrainer(config, model_config, n_classes=12,
                          input_shape=(300, 64, 7), device="cpu",
                          mesh=make_mesh("data:-1", "cpu"),
                          workdir=str(tmp_path / "one"),
                          logdir=str(tmp_path / "one"))
    restore_checkpoint(latest_best(str(tmp_path / "saved_model" / run)),
                       trainer.state)
    want = trainer._run_epoch(datasets["val"], 0, "val")
    got = {r["tag"].split("val_")[1]: r["value"] for r in logged
           if r["tag"].startswith("val/")}
    assert datasets["val"].batch_size % 3 and set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
