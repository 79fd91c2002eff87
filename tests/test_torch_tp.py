"""Tensor parallelism over a `model` axis on gloo ranks on the CPU, against
one rank and against the JAX package (seld_tpu_torch/parallel/
partitioning.py, parallel/collectives.py, train/steps.py).

The invariant: a step over a data:D,model:M mesh whose ranks hold the
sharded parameters (`shard_tree`) gives the same losses, updated
parameters (the shards put back together), BatchNorm statistics and metric
state as one rank holding everything, only the order of the sums
differing; and, on tests/test_mesh.py's recipe, as JAX's GSPMD step on a
data:4,model:2 mesh. Worker processes (this file run as a script: a gloo
group of 2 ranks, data:1,model:2, and one of 4, data:2,model:2) run every
scenario once; the pytest process runs the one-rank references and the
JAX side.

Scenarios:
  - "recipe": tests/test_mesh.py:74-155's seldnet (a conv block, a
    transformer stage of 2 heads, dense heads), B=8, one SGD step;
  - "ss5": narrow SS5 (tests/test_torch_dp.py::_config), B=8, AdaBelief
    with AGC, class-weighted losses and L2 1e-3, two steps, dropout off:
    the fused stem on 4 of its 8 filters a rank, the conformer's heads
    sharded (AGC's head-axis norms over the model group);
  - "ss5_dropout": the same with dropout on, the attention masks drawn
    whole and each rank's heads kept.

Tolerances, tests/test_mesh.py's: losses 1e-4 relative, parameters 5e-4
absolute (leaves whose gradient is zero in exact arithmetic, a conv bias
before a train-mode BatchNorm, below NULL_GRAD of the largest gradient on
both sides instead: AdaBelief turns their noise into a step of about the
learning rate), running statistics 1e-5 absolute, the metric state 1e-4
relative.
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
LOSS_RTOL, PARAM_ATOL, STATS_ATOL, METRIC_RTOL = 1e-4, 5e-4, 1e-5, 1e-4
NULL_GRAD = 1e-6
MESHES = {"data1_model2": ("data:1,model:2", 2),
          "data2_model2": ("data:2,model:2", 4)}
SCENARIOS = ("recipe", "ss5", "ss5_dropout")
RECIPE_SHAPE, SS5_SHAPE = (20, 16, 7), (60, 16, 7)
B = 8


def recipe_config():
    """tests/test_mesh.py:89-99."""
    return {
        "FIRST": "simple_conv_block",
        "FIRST_ARGS": {"filters": [8], "pool_size": [[5, 4]]},
        "SECOND": "transformer_encoder_stage",
        "SECOND_ARGS": {"depth": 1, "n_head": 2, "key_dim": 4,
                        "ff_multiplier": 2, "kernel_size": 1,
                        "dropout_rate": 0.0},
        "SED": "simple_dense_block", "SED_ARGS": {"units": [8]},
        "DOA": "simple_dense_block", "DOA_ARGS": {"units": [8]},
        "n_classes": 4,
    }


def ss5_config(dropout: bool):
    """Narrow SS5, as tests/test_torch_dp.py's (from the port's own zoo
    copy, so a worker imports no JAX)."""
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
    cfg["n_classes"] = 12
    return cfg


def recipe_batch():
    """tests/test_mesh.py:120-123's batch."""
    rng = np.random.RandomState(3)
    x = rng.randn(8, 20, 16, 7).astype(np.float32)
    sed = (rng.rand(8, 4, 4) < 0.3).astype(np.float32)
    doa = np.repeat(sed, 3, -1) * 0.5
    return x, sed, doa


def ss5_batches(n):
    out = []
    for s in range(n):
        rng = np.random.RandomState(200 + s)
        x = rng.randn(B, *SS5_SHAPE).astype(np.float32)
        sed = (rng.rand(B, 12, 12) < 0.2).astype(np.float32)
        sed[:, 0, 0] = 1.0
        doa = (np.clip(rng.randn(B, 12, 36), -1, 1)
               * np.repeat(sed, 3, axis=-1)).astype(np.float32)
        out.append((x, sed, doa))
    return out


class SGD:
    """optax.sgd (the recipe's optimizer): p -= lr * g."""

    def __init__(self, lr):
        self.lr = lr

    @torch.no_grad()
    def step(self, params, grads, shard_dims=None):
        for p, g in zip(params, grads):
            p.sub_(self.lr * g)


def run_scenario(name, init, mesh=None):
    """One scenario's steps from the state_dict `init` (sharded first
    under a mesh with a model axis); the snapshot: losses, parameters by
    key (this rank's shards), the shard dims, statistics, metric state and
    the first step's gradients as the optimizer receives them."""
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.parallel.mesh import shard_batch
    from seld_tpu_torch.parallel.partitioning import shard_tree
    from seld_tpu_torch.train import losses as TL
    from seld_tpu_torch.train import metrics as TM
    from seld_tpu_torch.train.optimizers import adabelief
    from seld_tpu_torch.train.steps import make_train_step
    from seld_tpu_torch.train.train_state import TrainState
    if name == "recipe":
        model = build_model("seldnet", RECIPE_SHAPE, recipe_config(),
                            device="cpu")
        n_classes, steps = 4, [recipe_batch()]
        kw = dict(sed_loss_fn=lambda y, p: TL.sed_loss_with_weights(y, p),
                  doa_loss_fn=TL.MSE, loss_weights=(1.0, 10.0),
                  metric_block_size=2)
    else:
        model = build_model("conv_temporal", SS5_SHAPE,
                            ss5_config(name == "ss5_dropout"), device="cpu")
        cw = TL.class_weights_from_samples(TL.DCASE2021_TRAIN_SAMPLES)
        n_classes, steps = 12, ss5_batches(2)
        kw = dict(sed_loss_fn=lambda y, p: TL.sed_loss_with_weights(y, p,
                                                                    cw),
                  doa_loss_fn=lambda y, p: TL.MMSE_with_cls_weights(y, p,
                                                                    cw),
                  loss_weights=(1.0, 1000.0), l2=1e-3, metric_block_size=6)
    model.load_state_dict(init)
    if mesh is not None and mesh.model_size > 1:
        shard_tree(model, mesh)
    opt = SGD(1e-2) if name == "recipe" else adabelief(
        list(model.parameters()), 1e-3, agc_clip=0.01)
    state = TrainState(model, opt, seed=3)
    names, first = list(state.params), {}
    opt_step = opt.step

    def recording(ps, gs, **kw):
        if not first:
            first.update((n, g.detach().clone()) for n, g in zip(names, gs))
        opt_step(ps, gs, **kw)
    opt.step = recording
    step = make_train_step(mesh=mesh, **kw)
    metric, losses = TM.init_state(n_classes, "cpu"), []
    for x, sed, doa in steps:
        x, sed, doa = shard_batch(tuple(torch.from_numpy(a)
                                        for a in (x, sed, doa)), mesh)
        state, metric, (sl, dl) = step(state, metric, x, (sed, doa))
        losses.append((sl.item(), dl.item()))
    return {"losses": np.asarray(losses),
            "params": {k: v.detach().clone()
                       for k, v in state.params.items()},
            "dims": dict(getattr(model, "tensor_parallel", {})),
            "stats": {k: v.clone() for k, v in state.batch_stats.items()},
            "metric": {k: v.clone() for k, v in metric.items()},
            "grads": first,
            "model_index": 0 if mesh is None else mesh.model_index}


def _worker(rank, world, port, spec, workdir):
    import torch.distributed as dist

    from seld_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    all_reduce = dist.all_reduce

    def contiguous_only(t, *args, **kwargs):
        # NCCL's rule, which gloo does not enforce
        assert t.is_contiguous(), f"all_reduce of strides {t.stride()}"
        return all_reduce(t, *args, **kwargs)
    dist.all_reduce = contiguous_only
    mesh = make_mesh(spec, "cpu")
    out = {name: run_scenario(
        name, torch.load(os.path.join(workdir, f"{name}.pt")), mesh)
        for name in SCENARIOS}
    torch.save(out, os.path.join(workdir, f"{spec}.rank{rank}.pt"))
    dist.destroy_process_group()


def _free_ports(n):
    """n distinct free ports (held together while chosen)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _whole(ranks, part, key):
    """A leaf put back together from the model ranks of data index 0."""
    dims = ranks[0]["dims"]
    if key not in dims:
        return ranks[0][part][key]
    shards = sorted((r for r in ranks if r["mesh_data_index"] == 0),
                    key=lambda r: r["model_index"])
    return torch.cat([r[part][key] for r in shards], dim=dims[key])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The initial weights (the recipe's from JAX's init, SS5's from
    random JAX variables), the one-rank references and every worker's
    results."""
    import jax
    from test_torch_model import random_variables

    from seld_tpu.models import build_model as jax_build_model
    from seld_tpu_torch.bridge import from_flax
    from seld_tpu_torch.models import build_model
    workdir = str(tmp_path_factory.mktemp("tp"))
    jm = jax_build_model("seldnet", RECIPE_SHAPE, recipe_config())
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(4)},
        np.zeros((2, *RECIPE_SHAPE), np.float32), train=False))
    inits = {"recipe": from_flax(v, build_model(
        "seldnet", RECIPE_SHAPE, recipe_config(), device="cpu"))}
    for name in ("ss5", "ss5_dropout"):
        cfg = ss5_config(name == "ss5_dropout")
        jss5 = jax_build_model("conv_temporal", SS5_SHAPE, cfg)
        inits[name] = from_flax(
            jax.tree_util.tree_map(np.asarray,
                                   random_variables(jss5, SS5_SHAPE)),
            build_model("conv_temporal", SS5_SHAPE, cfg, device="cpu"))
    for name, init in inits.items():
        torch.save(init, os.path.join(workdir, f"{name}.pt"))

    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    for (spec, world), port in zip(MESHES.values(),
                                   _free_ports(len(MESHES))):
        procs += [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             str(port), spec, workdir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    one = {name: run_scenario(name, init) for name, init in inits.items()}
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = {}
    for label, (spec, world) in MESHES.items():
        ranks[label] = [torch.load(os.path.join(workdir,
                                                f"{spec}.rank{r}.pt"),
                                   weights_only=False)
                        for r in range(world)]
        for r, got in enumerate(ranks[label]):
            for snap in got.values():
                snap["mesh_data_index"] = r // 2
    return {"inits": inits, "variables": v, "one": one, "ranks": ranks}


# ------------------------------------------------------------- spec rules

def _jax_mesh():
    from seld_tpu.parallel import make_mesh as jax_make_mesh
    return jax_make_mesh("data:4,model:2")


def _port_mesh(axes=None):
    from seld_tpu_torch.parallel.mesh import Mesh
    return Mesh(axes=axes or {"data": 4, "model": 2}, world=8, rank=0,
                data_size=4, data_index=0, device=torch.device("cpu"))


MESH_TREE = {
    "Dense_0": {"kernel": (16, 8), "bias": (8,)},
    "Conv_0": {"kernel": (3, 3, 4, 8)},
    "MultiHeadAttention_0": {"query_kernel": (4, 16, 8)},
    "GRU_0": {"kernel": (1, 16, 24), "recurrent_kernel": (1, 8, 24)},
    "BatchNorm_0": {"scale": (8,), "bias": (8,)},
    "Dense_odd": {"kernel": (16, 7)},
}


@pytest.mark.parametrize("key", [f"{m}.{leaf}" for m, leaves in
                                 MESH_TREE.items() for leaf in leaves])
def test_spec_rules_equal_jax(key):
    """tests/test_mesh.py:46-72's tree, leaf for leaf: the port's spec
    equals JAX's `tp_param_specs`."""
    import jax.numpy as jnp

    from seld_tpu.parallel import tp_param_specs as jax_specs
    from seld_tpu_torch.parallel.partitioning import tp_param_specs
    module, leaf = key.split(".")
    want = jax_specs({m: {n: jnp.zeros(s) for n, s in leaves.items()}
                      for m, leaves in MESH_TREE.items()},
                     _jax_mesh())[module][leaf]
    got = tp_param_specs({f"{m}.{n}": torch.zeros(s)
                          for m, leaves in MESH_TREE.items()
                          for n, s in leaves.items()}, _port_mesh())[key]
    assert got == tuple(want)


@pytest.mark.parametrize("which", ["seldnet", "conv_temporal"])
def test_model_specs_equal_jax_key_for_key(which):
    """A seeded seldnet (the recipe) and a narrow SS5: the port's spec of
    every parameter equals JAX's for the same flax leaf, every running
    statistic is replicated, and both shard some kernels and the head
    kernels."""
    import jax

    from seld_tpu.models import build_model as jax_build_model
    from seld_tpu.parallel import tp_param_specs as jax_specs
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.parallel.partitioning import tp_param_specs
    shape, cfg = ((RECIPE_SHAPE, recipe_config()) if which == "seldnet"
                  else (SS5_SHAPE, ss5_config(False)))
    jm = jax_build_model(which, shape, cfg)
    params = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, np.zeros((1, *shape),
                                                    np.float32),
        train=False))["params"]
    flat = jax.tree_util.tree_flatten_with_path(
        jax_specs(params, _jax_mesh()),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    want = {".".join(p.key for p in path): tuple(s) for path, s in flat}
    model = build_model(which, shape, cfg, device="cpu")
    got = tp_param_specs(model, _port_mesh())
    names = dict(model.named_parameters())
    assert {k: got[k] for k in names} == want
    assert all(got[k] == () for k, _ in model.named_buffers())
    assert any(s == ("model",) for s in want.values())
    assert any(s and s[-1] == "model" and len(s) > 1 for s in want.values())


def test_shard_tree_takes_this_ranks_slices():
    """A state_dict's sharded leaves are this rank's slices along the
    spec's dim; a model's parameters are replaced in place and their dims
    recorded."""
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.parallel.mesh import Mesh
    from seld_tpu_torch.parallel.partitioning import (shard_tree,
                                                      tp_param_specs)
    mesh = Mesh(axes={"data": 1, "model": 2}, world=2, rank=1, data_size=1,
                data_index=0, device=torch.device("cpu"), model_size=2,
                model_index=1)
    tree = {"Dense_0.kernel": torch.arange(32.0).reshape(4, 8),
            "Dense_0.bias": torch.arange(8.0),
            "MultiHeadAttention_0.query_kernel": torch.arange(24.0)
            .reshape(2, 3, 4)}
    got = shard_tree(tree, mesh)
    assert torch.equal(got["Dense_0.kernel"], tree["Dense_0.kernel"][:, 4:])
    assert got["Dense_0.bias"] is tree["Dense_0.bias"]
    assert torch.equal(got["MultiHeadAttention_0.query_kernel"],
                       tree["MultiHeadAttention_0.query_kernel"][1:])
    model = build_model("seldnet", RECIPE_SHAPE, recipe_config(),
                        device="cpu")
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    specs = tp_param_specs(model, mesh)
    shard_tree(model, mesh, specs)
    for key, d in model.tensor_parallel.items():
        assert specs[key][d] == "model"
        n = whole[key].shape[d] // 2
        assert torch.equal(model.state_dict()[key],
                           whole[key].narrow(d, n, n)), key
    assert len(model.tensor_parallel) == sum(bool(s) for s in specs.values())


def test_a_sharded_layer_outside_a_model_parallel_step_raises():
    """A model holding shards cannot run outside a step over its mesh."""
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.parallel.mesh import Mesh
    from seld_tpu_torch.parallel.partitioning import shard_tree
    mesh = Mesh(axes={"data": 1, "model": 2}, world=2, rank=0, data_size=1,
                data_index=0, device=torch.device("cpu"), model_size=2)
    model = shard_tree(build_model("seldnet", RECIPE_SHAPE, recipe_config(),
                                   device="cpu"), mesh)
    with pytest.raises(RuntimeError, match="outside a step"):
        model(torch.zeros(1, *RECIPE_SHAPE))


# ------------------------------------------------------------------ steps

def _null_leaves(grads):
    top = max(g.abs().max().item() for g in grads.values())
    return {n for n, g in grads.items()
            if g.abs().max().item() < NULL_GRAD * top}


def _assert_same_step(ranks, want):
    """The model ranks' shards put back together against one rank's step,
    to the module's tolerances; ranks of one data index hold the same
    replicated leaves bit for bit."""
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
    null = _null_leaves(want["grads"])
    top = max(g.abs().max().item() for g in want["grads"].values())
    for name, w in want["params"].items():
        if name in null:
            g = _whole(ranks, "grads", name)
            assert g.abs().max().item() < NULL_GRAD * top, name
            continue
        torch.testing.assert_close(_whole(ranks, "params", name), w,
                                   rtol=0, atol=PARAM_ATOL, msg=name)
    for name, w in want["stats"].items():
        for r in ranks:
            torch.testing.assert_close(r["stats"][name], w, rtol=0,
                                       atol=STATS_ATOL, msg=name)
    for name, w in want["metric"].items():
        for r in ranks:
            torch.testing.assert_close(r["metric"][name], w,
                                       rtol=METRIC_RTOL, atol=1e-6,
                                       msg=name)
    for r in ranks[1:]:
        for name in want["params"]:
            if name not in ranks[0]["dims"]:
                assert torch.equal(r["params"][name],
                                   ranks[0]["params"][name]), name


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("label", list(MESHES))
def test_sharded_step_equals_one_rank_step(runs, label, scenario):
    """A data:1,model:2 (2 ranks) and a data:2,model:2 (4 ranks) step
    equal one rank's on the whole batch; each rank holds half of every
    sharded kernel, the stem's and the attention heads' among them."""
    ranks = [r[scenario] for r in runs["ranks"][label]]
    dims = ranks[0]["dims"]
    assert dims and any(k.endswith("query_kernel") for k in dims)
    for key, d in dims.items():
        assert (ranks[0]["params"][key].shape[d] * 2
                == runs["one"][scenario]["params"][key].shape[d]), key
    if scenario != "recipe":
        assert "Conv2DBN_0.Conv_0.kernel" in dims
    _assert_same_step(ranks, runs["one"][scenario])


@pytest.mark.parametrize("label", list(MESHES))
def test_sharded_step_equals_jax_gspmd_step(runs, label):
    """tests/test_mesh.py:74-155: JAX's step on a data:4,model:2 mesh with
    TP-sharded parameters and the port's sharded step from the same
    weights agree (losses 1e-4 relative, parameters 5e-4, metric 1e-4)."""
    import jax
    import jax.numpy as jnp
    import optax

    from seld_tpu.models import build_model as jax_build_model
    from seld_tpu.parallel import (make_mesh, replicate, shard_batch,
                                   shard_tree, tp_param_specs)
    from seld_tpu.train import losses as L
    from seld_tpu.train import metrics as M
    from seld_tpu.train.steps import make_train_step
    from seld_tpu.train.train_state import TrainState
    from seld_tpu_torch.bridge import from_flax
    jm = jax_build_model("seldnet", RECIPE_SHAPE, recipe_config())
    v = runs["variables"]
    step = make_train_step(
        sed_loss_fn=lambda y, p: L.sed_loss_with_weights(y, p),
        doa_loss_fn=L.MSE, loss_weights=(1.0, 10.0),
        metric_block_size=2, donate=False)
    x, sed, doa = (jnp.asarray(a) for a in recipe_batch())
    mesh = make_mesh("data:4,model:2")
    with mesh:
        st = TrainState.create(
            apply_fn=jm.apply, params=v["params"],
            batch_stats=v.get("batch_stats"), tx=optax.sgd(1e-2),
            rng=jax.random.PRNGKey(5))
        specs = tp_param_specs(st.params, mesh)
        st = st.replace(params=shard_tree(st.params, mesh, specs))
        st = st.replace(
            batch_stats=replicate(st.batch_stats, mesh),
            opt_state=replicate(st.opt_state, mesh),
            rng=replicate(st.rng, mesh), step=replicate(st.step, mesh))
        s_tp, m_tp, (sl, dl) = step(st, replicate(M.init_state(4), mesh),
                                    shard_batch(x, mesh),
                                    shard_batch((sed, doa), mesh))
    ranks = [r["recipe"] for r in runs["ranks"][label]]
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], [float(sl), float(dl)],
                                   rtol=1e-4)
    want = from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                       s_tp.params)})
    for name, w in want.items():
        torch.testing.assert_close(_whole(ranks, "params", name), w,
                                   rtol=5e-4, atol=5e-4, msg=name)
    for name, w in jax.tree_util.tree_map(np.asarray, m_tp).items():
        for r in ranks:
            np.testing.assert_allclose(r["metric"][name].numpy(), w,
                                       rtol=1e-4, atol=1e-4, err_msg=name)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4], sys.argv[5])
