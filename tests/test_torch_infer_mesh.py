"""Clip scoring and serving over several ranks on the CPU
(seld_tpu_torch/inference/ensemble.py, train/trainer.py::evaluate_ensemble,
train/main.py, inference/export.py, inference/export_model.py,
serving/server.py) against one rank and against the JAX package's sharded
counterparts.

The invariant: `ensemble_outputs(mesh=...)` on N ranks, each running its
slice of every chunk of windows, returns on every rank what one
rank returns for the whole chunk; only the batch each library call sees
differs. Five worker processes (this file run as a script: a gloo group of
two CPU ranks and one of three) run every multi-rank scenario once; the
pytest process runs the one-rank references and the JAX side (its
`data:8` mesh of the tests' eight CPU devices). A data-parallel window
artifact (`nr_devices` N) holds N replicas; on the CPU they all sit on the
CPU, which exercises the split and the order of the rows without a card.

Models: SS5 at full width and the tiny seldnet of
tests/test_inference_trainer.py, for [50, 16, 7] windows (win_size 50,
step_size 5), JAX's random variables carried across by bridge.py; three
200-frame clips (31 windows: at batch 24 two chunks of 16 rows on one rank
and on two, of 24 on three: a multiple of 8 a shard).
Tolerances (f32): N ranks against one rank 1e-5 absolute; against JAX
1e-5 absolute / 1e-4 relative (tests/test_torch_ensemble.py's); official
scores 1e-6 relative; the ranks of a group equal bit for bit.
"""
import copy
import json
import os
import socket
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (50, 16, 7)
WIN, STEP, BATCH = 50, 5, 24
ATOL, RTOL, RANK_ATOL, SCORE_RTOL = 1e-5, 1e-4, 1e-5, 1e-6
WORLDS = (2, 3)
# (model, ensemble_outputs options) of every sharded scenario
CASES = {"ss5_exact": ("ss5", {}),
         "ss5_fast": ("ss5", {"fast": True}),
         "ss5_fast_clip_batch2": ("ss5", {"fast": True, "clip_batch": 2}),
         "seldnet_exact": ("seldnet", {})}
TINY = {"FIRST": "simple_conv_block",
        "FIRST_ARGS": {"filters": [8], "pool_size": [[5, 4]]},
        "SECOND": "bidirectional_GRU_block", "SECOND_ARGS": {"units": [8]},
        "SED": "simple_dense_block", "SED_ARGS": {"units": [8]},
        "DOA": "simple_dense_block", "DOA_ARGS": {"units": [8]},
        "n_classes": 4}


def _ss5_config():
    from seld_tpu_torch.config import get_model_config
    cfg = copy.deepcopy(get_model_config("SS5", search_paths=[]))
    cfg["n_classes"] = 12
    return cfg


def _configs():
    return {"ss5": ("conv_temporal", _ss5_config()),
            "seldnet": ("seldnet", dict(TINY))}


def _clips(frames=200):
    rng = np.random.RandomState(5)
    return [rng.randn(frames, *SHAPE[1:]).astype(np.float32)
            for _ in range(3)]


def _models(workdir):
    """The port's models on the CPU with the bridged weights."""
    from seld_tpu_torch.models import build_model
    out = {}
    for key, (name, cfg) in _configs().items():
        model = build_model(name, SHAPE, cfg, device="cpu")
        model.load_state_dict(torch.load(os.path.join(workdir,
                                                      f"{key}.pt")))
        out[key] = model
    return out


def score(models, case, mesh, batch_size=BATCH):
    from seld_tpu_torch.inference.ensemble import ensemble_outputs
    key, kw = CASES[case]
    return ensemble_outputs(models[key], _clips(), win_size=WIN,
                            step_size=STEP, batch_size=batch_size,
                            mesh=mesh, time_down=5, **kw)


def score_counted(models, case, mesh, logdir):
    """`score` under the port's profiler: (the outputs, the scorer's
    counts)."""
    from seld_tpu_torch.utils import profiling
    with profiling.trace(logdir):
        out = score(models, case, mesh)
        return out, dict(profiling.counts)


def _names():
    return [f"clip{i}" for i in range(len(_clips()))]


def evaluate(model, mesh, workdir, out_dir):
    """The trainer's full-clip eval (its 300-frame windows at step 5, on
    400-frame clips: 21 windows) of SS5's weights over `mesh`; (seld,
    metric values, the CSVs written under out_dir)."""
    from seld_tpu_torch.train.trainer import SELDTrainer
    config = Namespace(name="ens", model="conv_temporal", batch=BATCH,
                       mesh="data:-1")
    trainer = SELDTrainer(config, _ss5_config(), n_classes=12,
                          input_shape=(300, *SHAPE[1:]), device="cpu",
                          mesh=mesh,
                          workdir=os.path.join(out_dir, "m"),
                          logdir=os.path.join(out_dir, "l"))
    trainer.model.load_state_dict(model.state_dict())
    csv_dir = os.path.join(out_dir, "csv")
    seld, mv = trainer.evaluate_ensemble(
        _clips(400), _names(), os.path.join(workdir, "gt"), csv_dir, 0)
    trainer.logger.close()
    csvs = sorted(os.listdir(csv_dir)) if os.path.isdir(csv_dir) else []
    return seld, tuple(float(v) for v in mv), csvs


def _worker(rank, world, port, workdir):
    """One rank of a gloo group: every sharded scenario in turn."""
    import torch.distributed as dist

    from seld_tpu_torch.parallel.mesh import Mesh, make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_mesh("data:-1", "cpu")
    assert (mesh.world, mesh.rank, mesh.data_index) == (world, rank, rank)
    models = _models(workdir)
    out = {case: score(models, case, mesh) for case in CASES
           if case != "ss5_exact"}
    out["ss5_exact"], out["rows"] = score_counted(
        models, "ss5_exact", mesh,
        os.path.join(workdir, f"trace{world}_{rank}"))
    # data:1,model:N on the same group: every rank holds the whole batch
    replicas = Mesh(axes={"data": 1, "model": world}, world=world,
                    rank=rank, data_size=1, data_index=0,
                    device=torch.device("cpu"), distributed=True,
                    primary=rank == 0)
    out["replicated"] = score(models, "ss5_fast", replicas)
    # a chunk the data axis does not divide: every rank refuses it alike
    try:
        score(models, "ss5_exact", mesh, batch_size=BATCH + 1)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    out["evaluate"] = evaluate(models["ss5"], mesh, workdir,
                               os.path.join(workdir, f"eval{world}_{rank}"))
    torch.save(out, os.path.join(workdir, f"w{world}_rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_gt(gt_dir):
    """Polar ground-truth CSVs of the eval clips' 80 label frames."""
    os.makedirs(gt_dir)
    rng = np.random.RandomState(9)
    for name in _names():
        with open(os.path.join(gt_dir, name + ".csv"), "w") as f:
            for fr in range(0, 80, 2):
                f.write(f"{fr},{rng.randint(12)},0,{rng.randint(-180, 180)},"
                        f"{rng.randint(-45, 45)}\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's variables bridged for the workers; each group's results by
    rank, the one-rank references and JAX's sharded results."""
    import jax
    from test_torch_model import random_variables

    from seld_tpu.inference import ensemble as jens
    from seld_tpu.models import build_model as jax_build_model
    from seld_tpu.parallel import make_mesh as jax_make_mesh
    from seld_tpu_torch.bridge import from_flax
    from seld_tpu_torch.models import build_model
    workdir = str(tmp_path_factory.mktemp("infer_mesh"))
    _write_gt(os.path.join(workdir, "gt"))
    jax_models = {}
    for key, (name, cfg) in _configs().items():
        jm = jax_build_model(name, SHAPE, cfg)
        v = jax.tree_util.tree_map(np.asarray, random_variables(jm, SHAPE))
        torch.save(from_flax(v, build_model(name, SHAPE, cfg, device="cpu")),
                   os.path.join(workdir, f"{key}.pt"))
        jax_models[key] = (jm, v)

    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    for world in WORLDS:
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             str(port), workdir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    models = _models(workdir)
    one = {case: score(models, case, None) for case in CASES
           if case != "ss5_exact"}
    one["ss5_exact"], one_rows = score_counted(
        models, "ss5_exact", None, os.path.join(workdir, "trace1"))
    mesh8 = jax_make_mesh("data:8")
    jax_out = {}
    for case, (key, kw) in CASES.items():
        jm, v = jax_models[key]
        jax_out[case] = jens.ensemble_outputs(
            jm.apply, v, _clips(), win_size=WIN, step_size=STEP,
            batch_size=BATCH, mesh=mesh8, time_down=5, **kw)
    one_eval = evaluate(models["ss5"], None, workdir,
                        os.path.join(workdir, "eval1"))

    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    groups = {world: [torch.load(os.path.join(workdir,
                                              f"w{world}_rank{r}.pt"),
                                 weights_only=False) for r in range(world)]
              for world in WORLDS}
    return {"groups": groups, "one": one, "jax": jax_out,
            "one_eval": one_eval, "one_rows": one_rows}


def _close(got, want, atol, rtol=0.0):
    assert len(got) == len(want)
    for (gs, gd), (ws, wd) in zip(got, want):
        assert tuple(gs.shape) == tuple(np.shape(ws)) and \
            gs.dtype == torch.float32
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=atol,
                                   rtol=rtol)
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_scoring_equals_one_rank_and_jax(runs, world, case):
    ranks = runs["groups"][world]
    for r in ranks[1:]:         # every rank returns the whole result
        for (a, b), (c, d) in zip(r[case], ranks[0][case]):
            assert torch.equal(a, c) and torch.equal(b, d)
    _close(ranks[0][case], runs["one"][case], RANK_ATOL)
    _close(ranks[0][case], runs["jax"][case], ATOL, RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_the_sharded_exact_path_runs_the_planned_rows(runs, world):
    """Three clips of 31 windows at batch 24: two chunks of 16 rows a clip
    on one rank and on two (32 rows, not 2 x 24), of 24 on three; the
    counts are the whole chunks', alike on every rank."""
    rows = {2: 32, 3: 48}[world]
    assert runs["one_rows"] == {"score.windows": 93,
                                "score.window_rows": 96}
    for r in runs["groups"][world]:
        assert r["rows"] == {"score.windows": 93,
                             "score.window_rows": 3 * rows}


@pytest.mark.parametrize("world", WORLDS)
def test_a_model_axis_replicates_the_windows(runs, world):
    """A data:1,model:N mesh: every rank scores whole chunks, and the
    gathered copies collapse to one."""
    for r in runs["groups"][world]:
        _close(r["replicated"], runs["one"]["ss5_fast"], RANK_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_a_chunk_the_data_axis_does_not_divide_is_refused(runs, world):
    for r in runs["groups"][world]:
        assert r["refused"] == (f"a batch of {BATCH + 1} windows does not "
                                f"shard evenly over the {world}-way data "
                                "axis")


def test_one_rank_without_a_group_is_the_single_card_path():
    """A mesh without a process group changes nothing, bit for bit."""
    from seld_tpu_torch.inference.ensemble import ensemble_outputs
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.parallel.mesh import make_mesh
    model = build_model("seldnet", SHAPE, dict(TINY), device="cpu")
    clips = _clips()[:1]
    plain = ensemble_outputs(model, clips, win_size=WIN, step_size=STEP,
                             batch_size=8)
    meshed = ensemble_outputs(model, clips, win_size=WIN, step_size=STEP,
                              batch_size=8, mesh=make_mesh("data:-1", "cpu"))
    for (a, b), (c, d) in zip(plain, meshed):
        assert torch.equal(a, c) and torch.equal(b, d)


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_eval_scores_on_the_chief_and_broadcasts(runs, world):
    """evaluate_ensemble over the group: rank 0 alone writes the CSVs;
    every rank returns the one-rank score."""
    seld, mv, csvs = runs["one_eval"]
    assert csvs == [n + ".csv" for n in _names()]
    for rank, r in enumerate(runs["groups"][world]):
        got_seld, got_mv, got_csvs = r["evaluate"]
        assert got_csvs == (csvs if rank == 0 else [])
        np.testing.assert_allclose([got_seld, *got_mv], [seld, *mv],
                                   rtol=SCORE_RTOL)


def _ens_rows(root, run):
    """The ENS_T scalars of a CLI run in logged order."""
    with open(os.path.join(root, "tensorboard_log", run,
                           "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["tag"], r["step"], r["value"]) for r in rows
            if r["tag"].startswith("ENS_T/")]


def test_cli_ensemble_eval_over_two_gloo_ranks(tmp_path, monkeypatch):
    """--mesh data:2 with <ans_path>/dev-test: the two spawned ranks score
    the test split's full clip together; the epoch-0 ENS_T scalars (the
    initial weights) equal one process's, rank 0 alone prints and saves
    SWA_best_*."""
    import shutil

    from test_torch_trainer import _model_config, _write_wav_tree

    from seld_tpu_torch.train import main as cli
    _write_wav_tree(tmp_path)
    os.makedirs(tmp_path / "model_config")
    with open(tmp_path / "model_config" / "narrow.json", "w") as f:
        json.dump(_model_config(), f)
    gt = tmp_path / "metadata_dev" / "dev-test"
    gt.mkdir()
    shutil.copy(tmp_path / "metadata_dev" / "fold6_room1_mix003.csv", gt)
    flags = ["--model", "conv_temporal", "--model_config", "narrow",
             "--doa_loss", "MMSE", "--abspath", str(tmp_path), "--from_wav",
             "--batch", "8", "--loop_time", "1", "--epoch", "1",
             "--eval_every", "1", "--swa_start", "0", "--swa_freq", "1",
             "--ans_path", str(tmp_path / "metadata_dev")]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    done = subprocess.run(
        [sys.executable, "-m", "seld_tpu_torch.train", *flags, "--name",
         "two", "--mesh", "data:2", "--output_path", str(tmp_path / "two"),
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.count("SWA seld score") == 1
    assert done.stdout.count("ensemble @ 0") == 1
    monkeypatch.chdir(tmp_path)
    cli.main([*flags, "--name", "one", "--output_path",
              str(tmp_path / "one"), "--device", "cpu"])
    two = _ens_rows(tmp_path, "conv_temporal_narrow_MMSE_two_v_0")
    one = _ens_rows(tmp_path, "conv_temporal_narrow_MMSE_one_v_0")
    # the periodic eval at epoch 0, then the SWA average's
    assert len(two) == len(one) == 10
    assert [r[:2] for r in two] == [r[:2] for r in one]
    np.testing.assert_allclose([r[2] for r in two[:5]],
                               [r[2] for r in one[:5]], rtol=SCORE_RTOL)
    assert os.listdir(tmp_path / "two") == ["fold6_room1_mix003.csv"]
    saved = [d for d in os.listdir(tmp_path / "saved_model" /
                                   "conv_temporal_narrow_MMSE_two_v_0")
             if d.startswith("SWA_best_") and not d.endswith(".json")]
    assert len(saved) == 1


# ---- the data-parallel window artifact ----

def _tiny_pair(seed=0):
    """The tiny seldnet (JAX init) and the port's model on its weights."""
    import jax
    import jax.numpy as jnp

    from seld_tpu.models import build_model as jax_build_model
    from seld_tpu_torch.bridge import from_flax
    from seld_tpu_torch.models import build_model
    jm = jax_build_model("seldnet", SHAPE, dict(TINY))
    v = jm.init({"params": jax.random.PRNGKey(seed)},
                jnp.zeros((1, *SHAPE)), train=False)
    model = build_model("seldnet", SHAPE, dict(TINY), device="cpu")
    model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, v),
                                    model))
    return jm, v, model


def _x(b, seed=0):
    return np.random.RandomState(seed).randn(b, *SHAPE).astype(np.float32)


@pytest.mark.parametrize("n", (2, 3))
def test_data_parallel_artifact_served_equals_live_model_and_jax(tmp_path,
                                                                  n):
    """An nr_devices-n window artifact (static batch 2n, n CPU replicas)
    through SELDServer's micro-batcher for b in (1, 3, 2n): the live model
    and JAX's export_window_forward(mesh=...) on the same weights."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from test_torch_serving import _Daemon

    from seld_tpu.inference.export import export_window_forward
    from seld_tpu_torch.inference import export_window, load_exported
    from seld_tpu_torch.serving import SELDServer
    jm, v, model = _tiny_pair()
    path = export_window(model, str(tmp_path / "dp.npz"), batch=2 * n,
                         nr_devices=n)
    art = load_exported(path, device="cpu")
    assert art.meta["nr_devices"] == n and art.nr_devices == n
    assert len({id(m) for (m,) in art.replicas}) == n
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    exported = export_window_forward(jm, v, SHAPE, batch=2 * n, mesh=mesh)
    assert exported.nr_devices == n
    jax_call = jax.jit(exported.call)

    svc = SELDServer(artifact=path, batch_window_ms=1.0, max_batch=64,
                     device="cpu")
    assert svc.nr_devices == n
    with _Daemon(svc) as client:
        assert client.health()["artifact_meta"]["nr_devices"] == n
        for b in (1, 3, 2 * n):
            x = _x(b, seed=b)
            sed, doa = client.score(x)
            with torch.inference_mode():
                live = model(torch.from_numpy(x))
            pad = np.zeros((-(-b // (2 * n)) * 2 * n, *SHAPE), np.float32)
            pad[:b] = x
            jax_rows = [jax_call(jax.device_put(
                jnp.asarray(pad[i:i + 2 * n]),
                NamedSharding(mesh, PartitionSpec("data"))))
                for i in range(0, len(pad), 2 * n)]
            for k, got in enumerate((sed, doa)):
                np.testing.assert_allclose(got, live[k].numpy(), atol=1e-5)
                want = np.concatenate([np.asarray(r[k]) for r in jax_rows])
                np.testing.assert_allclose(got, want[:b], atol=ATOL,
                                           rtol=RTOL)


def test_data_parallel_artifact_refusals(tmp_path):
    from seld_tpu_torch.inference import export_window, load_exported
    _, _, model = _tiny_pair()
    with pytest.raises(ValueError, match="static batch"):
        export_window(model, str(tmp_path / "a.npz"), nr_devices=2)
    with pytest.raises(ValueError, match="must divide over the 2-device "
                                         "mesh"):
        export_window(model, str(tmp_path / "a.npz"), batch=3, nr_devices=2)
    path = export_window(model, str(tmp_path / "a.npz"), batch=4,
                         nr_devices=2)
    visible = torch.cuda.device_count()
    if visible < 2:
        with pytest.raises(ValueError, match=f"artifact wants 2 devices; "
                                             f"{visible} visible"):
            load_exported(path, device="cuda")
    art = load_exported(path, device="cpu")
    with pytest.raises(ValueError, match="does not split over"):
        art.call(torch.from_numpy(_x(3)))
    assert load_exported(export_window(model, str(tmp_path / "b.npz")),
                         device="cpu").meta["nr_devices"] == 1


def _export_cli(tmp_path, *extra):
    from seld_tpu_torch.inference import export_model
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({k: v for k, v in TINY.items()
                               if k != "n_classes"}))
    return export_model.main(
        ["--model", "seldnet", "--model_config", str(cfg), "--n_classes",
         "4", "--win_size", "50", "--n_freq", "16", *extra])


def test_export_cli_data_parallel_verifies(tmp_path, capsys):
    from seld_tpu_torch.inference import load_exported
    out = tmp_path / "dp.npz"
    _export_cli(tmp_path, "--batch", "4", "--data_parallel", "2",
                "--out", str(out), "--device", "cpu", "--verify")
    assert "verify: artifact matches the live model" in capsys.readouterr() \
        .out
    assert load_exported(str(out), device="cpu").meta["nr_devices"] == 2


@pytest.mark.parametrize("extra, message", [
    (("--unit", "clip", "--model", "conv_temporal"),
     "--data_parallel is a window-unit option"),
    (("--seed", "0,1"), "--data_parallel supports single-model window "
                        "exports"),
    (("--device", "cuda"), "--data_parallel 2: only"),
])
def test_export_cli_data_parallel_refusals(tmp_path, extra, message):
    if "cuda" in extra and torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    out = tmp_path / "x.npz"
    with pytest.raises(SystemExit, match=message):
        _export_cli(tmp_path, "--batch", "4", "--data_parallel", "2",
                    "--out", str(out), *extra)
    assert not out.exists()


def test_reload_across_device_counts(tmp_path):
    """A one-device artifact reloaded as a two-replica one swaps in; a
    reload whose replicas cannot be built leaves serving as it was."""
    from seld_tpu_torch.inference import export_window
    from seld_tpu_torch.serving import SELDServer
    from seld_tpu_torch.serving.server import HTTPError
    _, _, model = _tiny_pair()
    _, _, other = _tiny_pair(seed=1)
    path = str(tmp_path / "a.npz")
    export_window(model, path, batch=4)
    svc = SELDServer(artifact=path, batch_window_ms=1.0, device="cpu")
    x = torch.from_numpy(_x(3))
    with torch.inference_mode():
        want = [o.numpy() for o in model(x)], [o.numpy() for o in other(x)]
    try:
        assert svc.nr_devices == 1
        export_window(other, path, batch=4, nr_devices=2)
        assert svc.reload()["default"]["changed"]
        assert svc.nr_devices == 2
        got = svc.score(x)
        np.testing.assert_allclose(got["sed"], want[1][0], atol=1e-6)
        # a meta whose device count does not divide the batch
        meta_path = path + ".meta.json"
        with open(meta_path) as f:
            meta = json.load(f)
        export_window(model, path, batch=4)
        with open(meta_path, "w") as f:
            json.dump({**meta, "nr_devices": 3}, f)
        with pytest.raises(HTTPError, match="no artifacts were swapped"):
            svc.reload()
        assert svc.nr_devices == 2
        got = svc.score(x)
        np.testing.assert_allclose(got["sed"], want[1][0], atol=1e-6)
        np.testing.assert_allclose(got["doa"], want[1][1], atol=1e-6)
    finally:
        svc.close()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
