"""The port's scoring server (seld_tpu_torch/serving/) on device="cpu":
routes, micro-batching, bucket padding, static-batch pad-and-chunk, the
bf16 wire, reload, the two CLIs, and replies equal to the JAX model's apply
on bridged weights; the clip unit (a whole clip a request, no batcher, its
reply the JAX package's trunk-once fast path), ensemble artifacts, and a
reload that would change an artifact's unit, refused; stream bundles
(export_streaming, the export CLI's --unit stream) and the server's
/v1/stream sessions, whose frames equal the JAX package's streaming engine
on the same bridged weights, and stream_demo serving a bundle.
"""
import copy
import io
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import get_model_config
from seld_tpu.inference.ensemble import ensemble_outputs as jax_ensemble
from seld_tpu.inference.streaming import StreamingSELD as JaxStreamingSELD
from seld_tpu.models import build_model as jax_build_model
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.inference import (StreamingSELD, export_clip_fast,
                                      export_clip_fast_ensemble,
                                      export_streaming, export_window,
                                      export_window_ensemble, load_exported)
from seld_tpu_torch.models import build_model
from seld_tpu_torch.serving import SELDClient, SELDServer
from seld_tpu_torch.serving.server import serve

torch.set_num_threads(1)
SHAPE = (50, 16, 7)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _narrow():
    cfg = copy.deepcopy(get_model_config("SS5", search_paths=[]))
    cfg["filters"] = 4
    cfg["BLOCK0_ARGS"]["filters1"] = 8
    cfg["BLOCK1_ARGS"]["units"] = 16
    cfg["BLOCK2_ARGS"].update(key_dim=4, depth=1)
    cfg["SED_ARGS"]["key_dim"] = 4
    cfg["DOA_ARGS"]["units"] = 8
    return cfg


def _artifact(tmp_path, name="a.npz", seed=0, **kw):
    model = build_model("conv_temporal", SHAPE, _narrow(), seed=seed,
                        device="cpu")
    return export_window(model, str(tmp_path / name), **kw)


def _x(b, seed=0):
    return np.random.RandomState(seed).randn(b, *SHAPE).astype(np.float32)


def _direct(path, x):
    art = load_exported(path, device="cpu")
    return art.call(torch.from_numpy(np.asarray(x, np.float32)))


class _Daemon:
    """In-process server on an ephemeral port, shut down on exit."""

    def __init__(self, service):
        self.service = service
        self.httpd = serve(service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def __enter__(self):
        return SELDClient("127.0.0.1", self.httpd.server_address[1],
                          timeout=120)

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()
        self.thread.join(timeout=10)


def test_reply_equals_jax_apply(tmp_path):
    cfg = _narrow()
    jm = jax_build_model("conv_temporal", SHAPE, cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *SHAPE)),
        train=False))
    rng = np.random.RandomState(3)
    v = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = build_model("conv_temporal", SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    path = export_window(model, str(tmp_path / "jax.npz"))
    x = _x(3)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with _Daemon(SELDServer(artifact=path, device="cpu")) as client:
        got = client.score(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_score_health_models_and_errors(tmp_path):
    path = _artifact(tmp_path)
    with _Daemon(SELDServer(artifact=path, device="cpu")) as client:
        h = client.health()
        assert h["status"] == "ok" and h["units"] == ["window"]
        assert h["artifact_meta"]["input_shape"] == list(SHAPE)
        x = _x(3)
        sed, doa = client.score(x)
        want = _direct(path, x)
        np.testing.assert_array_equal(sed, want[0])
        np.testing.assert_array_equal(doa, want[1])
        assert sed.shape == (3, 10, 12) and doa.shape == (3, 10, 36)
        models = client.models()
        assert models["default"]["default"] and \
            models["default"]["unit"] == "window"
        with pytest.raises(RuntimeError, match="400"):
            client._request("POST", "/v1/score", b"not an npy")
        with pytest.raises(RuntimeError, match="400"):
            client.score(np.zeros((3, 50, 16, 5), np.float32))
        with pytest.raises(RuntimeError, match="404"):
            client.score(x, model="nope")
        with pytest.raises(RuntimeError, match="404"):
            client._request("GET", "/nowhere")
        assert client.health()["status"] == "ok"


def test_streaming_routes_without_a_bundle(tmp_path):
    path = _artifact(tmp_path)
    with _Daemon(SELDServer(artifact=path, device="cpu")) as client:
        with pytest.raises(RuntimeError,
                           match="404.*no streaming bundle loaded"):
            client.stream_push("s0", _x(1)[0])
        with pytest.raises(RuntimeError, match="404.*no such stream"):
            client.stream_finalize("s0")
        assert client.stream_drop("s0") is False
        h = client.health()
        assert h["status"] == "ok" and h["units"] == ["window"]
        assert h["sessions"] == 0


def test_microbatch_coalesces(tmp_path):
    path = _artifact(tmp_path)
    svc = SELDServer(artifact=path, batch_window_ms=1.0, max_batch=64,
                     device="cpu")
    slot = svc._slots[svc.DEFAULT]
    with _Daemon(svc) as client:
        client.score(_x(1))
        xs = [_x(n, seed=i) for i, n in enumerate((1, 2, 3, 1))]
        got = [None] * len(xs)

        def post(i):
            got[i] = client.score(xs[i])

        # hold the dispatch lock so the batcher blocks on its first batch
        # while the rest pile into the queue; count enqueues at the source
        q = slot._queue
        enqueued = []
        orig_put = q.put

        def counting_put(item, *a, **kw):
            r = orig_put(item, *a, **kw)
            if item is not None:
                enqueued.append(item)
            return r

        q.put = counting_put
        try:
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(xs))]
            with svc._dispatch_lock:
                for t in threads:
                    t.start()
                for _ in range(6000):
                    if len(enqueued) >= len(xs):
                        break
                    time.sleep(0.01)
                else:
                    raise AssertionError("requests never queued")
        finally:
            q.put = orig_put
        for t in threads:
            t.join(timeout=120)
        for x, (sed, doa) in zip(xs, got):
            want = _direct(path, x)
            np.testing.assert_allclose(sed, want[0], rtol=0, atol=1e-6)
            np.testing.assert_allclose(doa, want[1], rtol=0, atol=1e-6)
        b = client.health()["batching"]
        assert b["requests"] == 5 and b["rows"] == 8
        assert b["dispatches"] < b["requests"]
        sed, _ = client.score(xs[0][0])              # bare window
        assert sed.shape[0] == 1
        with pytest.raises(RuntimeError, match="400"):
            client.score(np.zeros((0, *SHAPE), np.float32))
        with pytest.raises(RuntimeError, match="400"):
            client.score(np.zeros((2, 50, 16, 5), np.float32))
        assert client.health()["status"] == "ok"


def _record_calls(slot):
    art = slot.artifact
    rows, orig = [], art.call

    def call(x):
        rows.append(x.shape[0])
        return orig(x)
    art.call = call
    return rows


@pytest.mark.parametrize("bucket_pad,want_rows", [
    (True, [4, 4, 4, 2]), (False, [3, 4, 4, 2])])
def test_bucket_padding_and_chunking(tmp_path, bucket_pad, want_rows):
    path = _artifact(tmp_path)
    svc = SELDServer(artifact=path, batch_window_ms=1.0, max_batch=4,
                     bucket_pad=bucket_pad, device="cpu")
    rows = _record_calls(svc._slots[svc.DEFAULT])
    with _Daemon(svc) as client:
        x3, x10 = _x(3), _x(10, seed=1)
        sed3, _ = client.score(x3)
        sed10, doa10 = client.score(x10)     # chunks 4 + 4 + 2
    assert rows == want_rows
    assert sed3.shape[0] == 3 and sed10.shape[0] == 10
    want = _direct(path, x10)
    np.testing.assert_allclose(sed10, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(doa10, want[1], rtol=0, atol=1e-6)


def test_static_batch_pads_and_chunks(tmp_path):
    path = _artifact(tmp_path, batch=4)
    svc = SELDServer(artifact=path, batch_window_ms=1.0, device="cpu")
    rows = _record_calls(svc._slots[svc.DEFAULT])
    with _Daemon(svc) as client:
        x = _x(6)
        sed, doa = client.score(x)
    assert rows == [4, 4]
    want = _direct(path, x)
    np.testing.assert_allclose(sed, want[0], rtol=0, atol=1e-6)
    # without batching a static artifact takes exactly its batch
    with _Daemon(SELDServer(artifact=path, device="cpu")) as client:
        assert client.score(_x(4))[0].shape[0] == 4
        with pytest.raises(RuntimeError, match="400"):
            client.score(_x(3))


def _bf16_body(x):
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    buf = io.BytesIO()
    np.save(buf, bits.view(np.uint16))
    return buf.getvalue()


def test_bf16_wire_without_ml_dtypes(tmp_path):
    path = _artifact(tmp_path)
    x = _x(3)
    rounded = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = _direct(path, rounded)
    with _Daemon(SELDServer(artifact=path, device="cpu")) as client:
        out = client._request("POST", "/v1/score", _bf16_body(x),
                              {"X-SELD-Dtype": "bfloat16"})
        np.testing.assert_array_equal(out["sed"], want[0])
        np.testing.assert_array_equal(out["doa"], want[1])
        with pytest.raises(RuntimeError, match="400.*X-SELD-Dtype"):
            client._request("POST", "/v1/score", _bf16_body(x),
                            {"X-SELD-Dtype": "float8_e4m3"})
        buf = io.BytesIO()
        np.save(buf, np.zeros((1, *SHAPE), np.dtype("V2")))
        with pytest.raises(RuntimeError, match="400"):
            client._request("POST", "/v1/score", buf.getvalue())


def test_bf16_artifact_and_client_bit_view(tmp_path):
    """A bf16-input artifact value-casts f32 requests; the client's own
    bit-view encoding (ml_dtypes arrays, where numpy has them) decodes to
    the same input."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    path = _artifact(tmp_path, dtype="bfloat16")
    x = _x(2)
    with _Daemon(SELDServer(artifact=path, batch_window_ms=1.0,
                            device="cpu")) as client:
        sed_f, doa_f = client.score(x)
        sed_b, doa_b = client.score(x.astype(ml_dtypes.bfloat16))
    np.testing.assert_array_equal(sed_f, sed_b)
    np.testing.assert_array_equal(doa_f, doa_b)
    rounded = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(sed_f, _direct(path, rounded)[0], rtol=0,
                               atol=1e-6)


def test_metrics_text(tmp_path):
    path = _artifact(tmp_path)
    svc = SELDServer(artifact=path, batch_window_ms=1.0, device="cpu")
    with _Daemon(svc) as client:
        client.score(_x(2))
        text = client.metrics()
    assert 'seld_requests_total{route="/v1/score",code="200"} 1' in text
    assert 'seld_request_seconds_count{route="/v1/score"} 1' in text
    assert 'seld_batch_dispatches_total{model="default"} 1' in text
    assert 'seld_batch_rows_total{model="default"} 2' in text


def test_multi_model_routing_and_reload(tmp_path):
    pa = _artifact(tmp_path, "a.npz", seed=0)
    pb = _artifact(tmp_path, "b.npz", seed=1)
    x = _x(2)
    svc = SELDServer(artifacts={"a": pa, "b": pb}, batch_window_ms=1.0,
                     device="cpu")
    with _Daemon(svc) as client:
        sa, _ = client.score(x, model="a")
        sb, _ = client.score(x, model="b")
        assert not np.allclose(sa, sb)
        with pytest.raises(RuntimeError, match="404.*no default"):
            client.score(x)
        assert set(client.models()) == {"a", "b"}
        # re-export b with a's weights, then hot-swap
        _artifact(tmp_path, "b.npz", seed=0)
        out = client.reload()
        assert out["b"]["changed"] and not out["a"]["changed"]
        np.testing.assert_array_equal(client.score(x, model="b")[0], sa)
        # a broken file fails the reload and swaps nothing
        with open(pb, "wb") as f:
            f.write(b"broken")
        with pytest.raises(RuntimeError, match="500"):
            client.reload()
        np.testing.assert_array_equal(client.score(x, model="b")[0], sa)


def test_server_needs_an_artifact():
    with pytest.raises(ValueError):
        SELDServer(device="cpu")


def test_load_exported_refuses_other_units(tmp_path):
    path = _artifact(tmp_path)
    meta_path = path + ".meta.json"
    with open(meta_path) as f:
        meta = json.load(f)
    for unit, error, match in (("stream", ValueError,
                                "StreamingSELD.from_exported"),
                               ("bundle", ValueError,
                                "window or clip artifact")):
        meta["unit"] = unit
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(error, match=match):
            load_exported(path, device="cpu")


def test_export_cli_from_flax_variables_then_serve_cli(tmp_path):
    """export_model --variables (flat flax npz) --verify, then the serve
    CLI in a subprocess answering a /v1/score that equals the JAX apply."""
    from seld_tpu_torch.inference import export_model

    cfg = _narrow()
    cfg_path = tmp_path / "narrow.json"
    cfg_path.write_text(json.dumps(cfg))
    jm = jax_build_model("conv_temporal", SHAPE, dict(cfg, n_classes=12))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *SHAPE)),
        train=False))
    rng = np.random.RandomState(5)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"):
            (0.3 * rng.randn(*s.shape)).astype(np.float32)
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat = {k: (np.abs(a) if k.endswith("/var") else a)
            for k, a in flat.items()}
    np.savez(tmp_path / "flax.npz", **flat)
    out = str(tmp_path / "cli.npz")
    export_model.main(["--model_config", str(cfg_path), "--out", out,
                       "--variables", str(tmp_path / "flax.npz"),
                       "--win_size", "50", "--n_freq", "16",
                       "--device", "cpu", "--verify"])

    proc = subprocess.Popen(
        [sys.executable, "-m", "seld_tpu_torch.serving.serve",
         "--artifact", out, "--port", "0", "--device", "cpu",
         "--batch_window_ms", "1", "--warmup_buckets", "1,2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=REPO))
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "serve CLI exited:\n" + "".join(lines)
            lines.append(line)
            if line.startswith("serving"):
                break
        assert sum(ln.startswith("warmup") for ln in lines) == 2
        port = int(line.rsplit(":", 1)[1])
        x = _x(2, seed=7)
        sed, doa = SELDClient("127.0.0.1", port, timeout=60).score(x)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    variables = {"params": {}, "batch_stats": {}}
    for k, a in flat.items():
        node = variables
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    want = jm.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(sed, np.asarray(want[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(doa, np.asarray(want[1]), rtol=1e-4,
                               atol=1e-5)


def test_serve_cli_argument_errors():
    from seld_tpu_torch.serving import serve as serve_cli
    assert hasattr(serve_cli, "main")
    with pytest.raises(SystemExit):
        serve_cli.main([])
    with pytest.raises(SystemExit):
        serve_cli.main(["--model", "no_equals_sign"])


CLIP = 100      # frames of a clip artifact's clip: 11 windows of 50 at step 5


def _clip_x(seed=0):
    return np.random.RandomState(seed).randn(CLIP, *SHAPE[1:]).astype(
        np.float32)


def _clip_artifact(tmp_path, name="clip.npz", seed=0):
    model = build_model("conv_temporal", SHAPE, _narrow(), seed=seed,
                        device="cpu")
    return export_clip_fast(model, str(tmp_path / name), CLIP, win_size=50,
                            step_size=5, time_down=5)


def test_clip_unit_replies_equal_the_jax_fast_path(tmp_path):
    """A clip artifact of bridged JAX weights, served with micro-batching
    asked for: one clip a request, no batcher, and the reply is the JAX
    package's trunk-once fast path on the same clip."""
    cfg = dict(_narrow(), n_classes=12)
    jm = jax_build_model("conv_temporal", SHAPE, cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *SHAPE)),
        train=False))
    rng = np.random.RandomState(4)
    v = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = build_model("conv_temporal", SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    path = export_clip_fast(model, str(tmp_path / "clip.npz"), CLIP,
                            win_size=50, step_size=5, time_down=5)
    x = _clip_x()
    want = jax_ensemble(jm.apply, v, [x], win_size=50, step_size=5,
                        fast=True)[0]
    svc = SELDServer(artifact=path, batch_window_ms=1.0, device="cpu")
    assert svc._slots["default"]._queue is None
    with _Daemon(svc) as client:
        h = client.health()
        assert h["units"] == ["clip"] and "batching" not in h
        assert client.models()["default"]["unit"] == "clip"
        assert h["artifact_meta"]["clip_frames"] == CLIP
        sed, doa = client.score(x)
        with pytest.raises(RuntimeError, match="400.*clip artifact"):
            client.score(x[None])
    assert sed.shape == (20, 12) and doa.shape == (20, 36)
    np.testing.assert_array_equal(sed, _direct(path, x)[0])
    for g, w in zip((sed, doa), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_ensemble_artifacts_return_the_members_average(tmp_path):
    members = [build_model("conv_temporal", SHAPE, _narrow(), seed=s,
                           device="cpu") for s in (0, 1)]
    x, clip = torch.from_numpy(_x(3)), torch.from_numpy(_clip_x(1))
    wpath = export_window_ensemble(members, str(tmp_path / "w.npz"))
    cpath = export_clip_fast_ensemble(members, str(tmp_path / "c.npz"), CLIP,
                                      win_size=50, step_size=5,
                                      time_downs=[5, 5])
    from seld_tpu_torch.inference.ensemble import _predict_clip_fast
    with torch.inference_mode():
        wouts = [m(x) for m in members]
        couts = [_predict_clip_fast(m, clip, win_size=50, step_size=5,
                                    batch_size=1 << 30, time_down=5)
                 for m in members]
    for path, outs in ((wpath, wouts), (cpath, couts)):
        art = load_exported(path, device="cpu")
        assert art.meta["n_members"] == 2
        got = art.call(clip if art.unit == "clip" else x)
        for i in range(2):
            want = ((outs[0][i] + outs[1][i]) / 2).numpy()
            np.testing.assert_allclose(got[i], want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="one time_down per member"):
        export_clip_fast_ensemble(members, str(tmp_path / "x.npz"), CLIP,
                                  time_downs=[5])


def test_reload_refuses_a_unit_change(tmp_path):
    path = _artifact(tmp_path, "a.npz")
    x = _x(2)
    with _Daemon(SELDServer(artifact=path, device="cpu")) as client:
        before = client.score(x)
        export_clip_fast(build_model("conv_temporal", SHAPE, _narrow(),
                                     device="cpu"), path, CLIP,
                         win_size=50, step_size=5, time_down=5)
        with pytest.raises(RuntimeError, match="500.*unit changed"):
            client.reload()
        assert client.health()["units"] == ["window"]
        np.testing.assert_array_equal(client.score(x)[0], before[0])


def test_export_cli_clip_ensemble_quantized_and_refusals(tmp_path):
    from seld_tpu_torch.inference import export_model

    cfg_path = tmp_path / "narrow.json"
    cfg_path.write_text(json.dumps(_narrow()))
    common = ["--model_config", str(cfg_path), "--win_size", "50",
              "--n_freq", "16", "--device", "cpu"]
    out = str(tmp_path / "clip.npz")
    export_model.main(common + ["--out", out, "--unit", "clip",
                                "--clip_frames", str(CLIP), "--step_size",
                                "5", "--seed", "0,1", "--quantize", "int8",
                                "--verify"])
    meta = load_exported(out, device="cpu").meta
    assert (meta["unit"], meta["n_members"], meta["quantize"],
            meta["clip_frames"], meta["step_size"]) == (
                "clip", 2, "int8", CLIP, 5)
    bundle = str(tmp_path / "stream")
    export_model.main(common + ["--out", bundle, "--unit", "stream",
                                "--chunk", "4", "--n_streams", "2",
                                "--quantize", "int8", "--verify"])
    with pytest.raises(ValueError, match="from_exported"):
        load_exported(bundle, device="cpu")
    eng = StreamingSELD.from_exported(bundle, device="cpu")
    assert (eng.n_streams, eng.chunk_t, eng.meta["quantize"]) == (2, 4,
                                                                  "int8")
    with pytest.raises(SystemExit, match="one engine per model"):
        export_model.main(common + ["--out", bundle, "--unit", "stream",
                                    "--seed", "0,1"])
    with pytest.raises(ValueError, match="static batch"):
        export_model.main(common + ["--out", out, "--data_parallel", "2"])
    with pytest.raises(SystemExit, match="2 values for 3 members"):
        export_model.main(common + ["--out", out, "--seed", "0,1",
                                    "--model_config", "a,b,c"])


# ---- stream bundles and /v1/stream sessions

def _jax_pair(seed=6):
    """The JAX model with random variables and the port's model on the
    same weights (narrow SS5, [50, 16, 7] windows)."""
    cfg = dict(_narrow(), n_classes=12)
    jm = jax_build_model("conv_temporal", SHAPE, cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *SHAPE)),
        train=False))
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = build_model("conv_temporal", SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    return jm, v, model


STREAM_GEOM = dict(win_size=50, step_size=5, time_down=5, chunk=4)


def _stream_frames(engine, x, step=40):
    engine.reset()
    out = []
    for lo in range(0, x.shape[0], step):
        out.extend(engine.push(x[lo:lo + step]))
    return out + list(engine.finalize())


def _same_frames(got, want, atol=1e-5):
    assert len(got) == len(want) > 0
    for (gs, gd), (ws, wd) in zip(got, want):
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=0, atol=atol)
        np.testing.assert_allclose(gd, np.asarray(wd), rtol=0, atol=atol)


def test_stream_bundle_round_trip(tmp_path):
    """export_streaming + StreamingSELD.from_exported: the bundle's engine
    (model rebuilt from the zoo, halo from the meta) emits the live
    engine's frames on ragged pushes, refuses a short clip, and an int8
    bundle equals the live engine on dequantised weights."""
    from seld_tpu_torch.inference import dequantize_tree, quantize_tree
    _, _, model = _jax_pair()
    bundle = export_streaming(model, str(tmp_path / "b"), (16, 7),
                              **STREAM_GEOM)
    live = StreamingSELD(model, (16, 7), **STREAM_GEOM)
    exp = StreamingSELD.from_exported(bundle, device="cpu")
    assert (exp.halo_t, exp.l_f, exp.live) == (live.halo_t, live.l_f, False)
    meta = exp.meta
    assert (meta["unit"], meta["halo"], meta["l_f"], meta["n_streams"],
            meta["feat_shape"]) == ("stream", live.halo_t, live.l_f, 1,
                                    [16, 7])
    x = np.random.RandomState(2).randn(200, 16, 7).astype(np.float32)
    _same_frames(_stream_frames(exp, x, 33), _stream_frames(live, x, 33))
    exp.reset()
    exp.push(x[:exp.l_f - 10])
    with pytest.raises(RuntimeError, match="exported streaming engines"):
        exp.finalize()

    q = export_streaming(model, str(tmp_path / "q"), (16, 7),
                         quantize="int8", **STREAM_GEOM)
    deq = copy.deepcopy(model)
    deq.load_state_dict(dequantize_tree(quantize_tree(model.state_dict(),
                                                      "int8")))
    live_q = StreamingSELD(deq, (16, 7), **STREAM_GEOM)
    _same_frames(_stream_frames(StreamingSELD.from_exported(q, "cpu"), x),
                 _stream_frames(live_q, x))


def test_serve_streaming_sessions(tmp_path):
    """Two interleaved sessions over one bundle emit the JAX engine's
    frames; finalize frees a session; a short stream's finalize is a 400;
    a reload leaves a live session's engine alone; 429 at the session
    limit; the session gauge in /metrics."""
    jm, v, model = _jax_pair()
    bundle = export_streaming(model, str(tmp_path / "bundle"), (16, 7),
                              **STREAM_GEOM)
    halo = StreamingSELD.from_exported(bundle, device="cpu").halo_t
    jax_eng = JaxStreamingSELD(jm.apply, v, (16, 7), halo=halo,
                               **dict(STREAM_GEOM, chunk=4))
    rng = np.random.RandomState(2)
    xa = rng.randn(200, 16, 7).astype(np.float32)
    xb = rng.randn(200, 16, 7).astype(np.float32)
    want = {"a": _stream_frames(jax_eng, xa), "b": _stream_frames(jax_eng,
                                                                  xb)}
    svc = SELDServer(bundle=bundle, max_sessions=2, device="cpu")
    with _Daemon(svc) as client:
        h = client.health()
        assert h["units"] == ["stream"] and h["bundle_meta"]["halo"] == halo
        got = {"a": [], "b": []}
        for lo in range(0, 200, 40):       # interleaved pushes
            if lo == 80:
                # re-export the bundle with other weights and reload: the
                # live sessions keep the engine they started with
                other = build_model("conv_temporal", SHAPE, _narrow(),
                                    seed=3, device="cpu")
                export_streaming(other, bundle, (16, 7), **STREAM_GEOM)
                assert client.reload()["bundle"]["path"] == bundle
                with pytest.raises(RuntimeError, match="429"):
                    client.stream_push("c", xa[:40])
            for sid, x in (("a", xa), ("b", xb)):
                sed, doa = client.stream_push(sid, x[lo:lo + 40])
                got[sid].extend(zip(sed, doa))
        assert client.health()["sessions"] == 2
        assert "seld_stream_sessions 2" in client.metrics()
        for sid in ("a", "b"):
            sed, doa = client.stream_finalize(sid)
            got[sid].extend(zip(sed, doa))
            _same_frames(got[sid], want[sid])
        assert client.health()["sessions"] == 0
        text = client.metrics()
        assert "seld_stream_sessions 0" in text
        assert 'route="/v1/stream/push",code="200"} 10' in text

        # a new session runs the reloaded bundle
        sed, doa = client.stream_push("new", xa[:120])
        fresh = StreamingSELD.from_exported(bundle, device="cpu")
        want_new = fresh.push(xa[:120])
        _same_frames(list(zip(sed, doa)), want_new)
        # short clip: exported engines refuse finalize -> clean 400
        assert client.stream_drop("new") is True
        client.stream_push("short", xa[:40])
        with pytest.raises(RuntimeError, match="400"):
            client.stream_finalize("short")
        assert client.stream_drop("short") is True
        assert client.stream_drop("short") is False
        with pytest.raises(RuntimeError, match="400"):
            client.stream_push("bad", np.zeros((10, 16, 5), np.float32))
        client.stream_drop("bad")
        with pytest.raises(RuntimeError, match="404.*no score artifact"):
            client.score(_x(1))


def test_stream_demo_serves_a_bundle(tmp_path):
    """stream_demo --export_dir as a subprocess at a toy size: every frame
    of the clip emitted, each rep's latency line and the JSON line."""
    model = build_model("conv_temporal", SHAPE, _narrow(), device="cpu")
    bundle = export_streaming(model, str(tmp_path / "bundle"), (16, 7),
                              n_streams=2, **STREAM_GEOM)
    r = subprocess.run(
        [sys.executable, "-m", "seld_tpu_torch.stream_demo", "--export_dir",
         bundle, "--chunk", "4", "--streams", "2", "--seconds", "4",
         "--reps", "1", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "measured trunk halo" in r.stdout
    assert "rep 0: 40/40 frames" in r.stdout
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["streams"] == 2 and out["reps"][0]["frames"] == 40
    assert "not measured" in r.stdout
