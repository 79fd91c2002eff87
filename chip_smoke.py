#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seld_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    compile every CUDA kernel of the port from csrc/ (seconds)
  3. kernels  each kernel against its plain PyTorch version on the card, in
              f32 and bf16 at the serving path's shapes, with its time, the
              plain version's time and one PyTorch library call's time
  4. model    full-width SS5 (seeded weights), B=32, on the card against the
              same model on the CPU with the plain kernels, TF32 off
  5. serve    export a window artifact, serve it with micro-batching on an
              ephemeral port, send concurrent /v1/score requests (f32 and
              one bf16) through the port's client, check every reply against
              a direct forward and that every dispatch launched the GRU
              kernel once per GRU layer
Then a JSON line {"kernels": [...]}, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failed phase raises: the exit code
is non-zero and no result line is printed. Without a CUDA card, or run
from a directory that holds this file and nothing else of the repository,
it fails the same way.
"""
import json
import math
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, SXM data sheet

GRU_TOL = {"float32": 1e-4,
           # both sides carry h in f32 and round once to bf16: at most one
           # bf16 ulp (2^-8 for |h| < 1) apart
           "bfloat16": 2.0 ** -7}
MODEL_TOL = 1e-4      # f32, TF32 off: cuDNN/cuBLAS vs CPU summation order
REPLY_TOL = 1e-4      # a reply's rows ran in a padded batch of another size


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cudnn_gru(x_proj, rec_kernel, rec_bias):
    """torch.nn.GRU (cuDNN) computing gru_scan's function: the input is
    x_proj of both directions side by side and each direction's input
    weights select its own block, permuted z|r|h -> r|z|n."""
    import torch
    d, t, b, k = x_proj.shape
    u = k // 3
    perm = torch.cat([torch.arange(u, 2 * u), torch.arange(u),
                      torch.arange(2 * u, 3 * u)])
    gru = torch.nn.GRU(d * k, u, bidirectional=d == 2).to(x_proj.device)
    with torch.no_grad():
        for di in range(d):
            sfx = "_reverse" if di else ""
            w_ih = torch.zeros(k, d * k, device=x_proj.device)
            w_ih[torch.arange(k), di * k + perm.to(x_proj.device)] = 1.0
            getattr(gru, f"weight_ih_l0{sfx}").copy_(w_ih)
            getattr(gru, f"bias_ih_l0{sfx}").zero_()
            getattr(gru, f"weight_hh_l0{sfx}").copy_(rec_kernel[di][:, perm].T)
            getattr(gru, f"bias_hh_l0{sfx}").copy_(rec_bias[di][perm])
    inp = torch.cat(list(x_proj.float()), dim=-1)        # [T, B, D*3U]

    def run():
        with torch.no_grad():
            return gru(inp)[0]
    return run


def phase_kernels(card):
    import torch
    from seld_tpu_torch.ops.gru import gru_scan, gru_scan_ref

    rng = np.random.RandomState(0)
    d, t, u = 2, 60, 128
    worst = {"float32": 0.0, "bfloat16": 0.0}
    timing = None
    for dtype in ("float32", "bfloat16"):
        for b in (1, 3, 32, 256):
            xp = torch.from_numpy(rng.randn(d, t, b, 3 * u).astype(
                np.float32)).cuda().to(getattr(torch, dtype))
            rk = torch.from_numpy((rng.randn(d, u, 3 * u) / math.sqrt(u))
                                  .astype(np.float32)).cuda()
            rb = torch.from_numpy(0.1 * rng.randn(d, 3 * u).astype(
                np.float32)).cuda()
            hs = gru_scan(xp, rk, rb)
            torch.cuda.synchronize()
            ref = gru_scan_ref(xp, rk, rb)
            err = (hs.float() - ref.float()).abs().max().item()
            ok = hs.shape == ref.shape and hs.dtype == xp.dtype and \
                err <= GRU_TOL[dtype]
            ms = cuda_ms(lambda: gru_scan(xp, rk, rb), 50)
            log("kernels", f"gru_scan {dtype} B={b}: max_abs_err {err:.3e} "
                           f"(tol {GRU_TOL[dtype]:.1e}) {'ok' if ok else 'FAIL'}"
                           f", kernel_ms {ms:.4f}")
            if not ok:
                raise SystemExit(f"gru_scan disagrees with gru_scan_ref at "
                                 f"{dtype} B={b}")
            worst[dtype] = max(worst[dtype], err)
            if dtype == "float32" and b == 32:
                timing = (xp, rk, rb, hs)

    # the serving path's shape: SS5 biGRU-128, T=60, a B=32 bucket, f32
    xp, rk, rb, hs = timing
    lib = cudnn_gru(xp, rk, rb)
    lib_out = lib()
    lib_err = max((lib_out[..., :u] - hs[0]).abs().max().item(),
                  (lib_out[..., u:] - hs[1]).abs().max().item())
    if lib_err > GRU_TOL["float32"]:
        raise SystemExit(f"cuDNN GRU disagrees with gru_scan: {lib_err:.3e}")
    ms = cuda_ms(lambda: gru_scan(xp, rk, rb), 200)
    plain_ms = cuda_ms(lambda: gru_scan_ref(xp, rk, rb), 10)
    library_ms = cuda_ms(lib, 200)
    b = xp.shape[2]
    nbytes = (xp.numel() * xp.element_size() + rk.numel() * 4
              + rb.numel() * 4 + hs.numel() * hs.element_size())
    flops = 2 * d * t * b * u * 3 * u + 10 * d * t * b * u   # product + gates
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    log("kernels", f"gru_scan f32 D=2 T=60 B=32 U=128 on {card}: "
                   f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                   f"(cuDNN GRU) {library_ms:.4f} bound_ms "
                   f"{max(bytes_ms, ops_ms):.5f}; cuDNN vs kernel "
                   f"{lib_err:.2e}")
    return {"name": "gru_scan", "route": "cuda",
            "source": "seld_tpu_torch/csrc/gru_fwd.cu",
            "replaces": "seld_tpu/ops/pallas/gru.py:170",
            "launches": None, "max_abs_err": worst["float32"],
            "max_abs_err_bf16": worst["bfloat16"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms}


def phase_model(card):
    import torch
    from seld_tpu_torch.config import get_model_config
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import kernels

    cfg = get_model_config("SS5", search_paths=[])
    shape = (300, 64, 7)
    gpu = build_model("conv_temporal", shape, cfg, seed=0, device="cuda")
    cpu = build_model("conv_temporal", shape, cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(32, *shape).astype(
        np.float32))
    kernels.launch_counts.clear()
    xg = x.cuda()
    with torch.inference_mode():
        sed, doa = gpu(xg)
        torch.cuda.synchronize()
        launches = kernels.launch_counts["gru_scan"]
        sed_c, doa_c = cpu(x)
        fwd_ms = {b: cuda_ms(lambda: gpu(xg[:b]), 10) for b in (1, 8, 32)}
    if tuple(sed.shape) != (32, 60, 12) or tuple(doa.shape) != (32, 60, 36):
        raise SystemExit(f"SS5 output shapes {tuple(sed.shape)}, "
                         f"{tuple(doa.shape)}")
    if not (torch.isfinite(sed).all() and torch.isfinite(doa).all()):
        raise SystemExit("SS5 output is not finite")
    err = max((sed.cpu() - sed_c).abs().max().item(),
              (doa.cpu() - doa_c).abs().max().item())
    log("model", f"SS5 full width B=32: sed {tuple(sed.shape)} doa "
                 f"{tuple(doa.shape)}, card vs cpu max_abs_err {err:.3e} "
                 f"(tol {MODEL_TOL:.0e}), gru_scan launches {launches}; "
                 f"forward ms " + ", ".join(f"B={b} {ms:.3f}" for b, ms in
                                            fwd_ms.items()) + f" on {card}")
    if err > MODEL_TOL or launches != 2:
        raise SystemExit("SS5 on the card disagrees with the CPU or skipped "
                         "the GRU kernel")
    return gpu


def _bf16_request(client, x):
    """POST a bfloat16 window batch as its uint16 bit view (the card's
    machine has no ml_dtypes to build a numpy bfloat16 array)."""
    import io

    import torch
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    buf = io.BytesIO()
    np.save(buf, bits.view(np.uint16))
    out = client._request("POST", "/v1/score", buf.getvalue(),
                          {"X-SELD-Dtype": "bfloat16"})
    rounded = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return out["sed"], out["doa"], rounded


def phase_serve(model, card):
    import torch
    from seld_tpu_torch.inference import export_window
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.serving import SELDClient, SELDServer
    from seld_tpu_torch.serving.server import serve

    rng = np.random.RandomState(2)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ss5_window.npz"
        export_window(model, path)
        server = SELDServer(artifact=path, batch_window_ms=2.0, max_batch=32,
                            device="cuda")
        httpd = serve(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            client = SELDClient("127.0.0.1", httpd.server_address[1])
            slot = server._slots[server.DEFAULT]
            for b in (1, 4, 8, 16, 32):     # every bucket once, uncounted
                server.score(torch.zeros(b, 300, 64, 7))
            requests = [rng.randn(b, 300, 64, 7).astype(np.float32)
                        for b in [1, 3, 8] * 9]
            bf16_x = rng.randn(3, 300, 64, 7).astype(np.float32)

            def send(x):
                t0 = time.perf_counter()
                sed, doa = client.score(x)
                return sed, doa, time.perf_counter() - t0

            kernels.launch_counts.clear()
            dispatches0 = slot.batch_stats["dispatches"]
            t0 = time.perf_counter()
            replies = [send(x) for x in requests[:3]]          # one by one
            with ThreadPoolExecutor(8) as pool:                # concurrent
                replies += list(pool.map(send, requests[3:]))
            bf16_reply = _bf16_request(client, bf16_x)
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts["gru_scan"]
            dispatches = slot.batch_stats["dispatches"] - dispatches0
            health = client.health()
            metrics = client.metrics()
        finally:
            httpd.shutdown()
            server.close()
            httpd.server_close()
            thread.join(timeout=10)

        art = slot.artifact
        x8 = torch.from_numpy(requests[2])
        direct_ms = []
        for _ in range(5):      # host tensor in, numpy out: no HTTP
            t1 = time.perf_counter()
            art.call(x8)
            direct_ms.append((time.perf_counter() - t1) * 1e3)
        worst = 0.0
        for x, (sed, doa, _) in zip(requests, replies):
            want = art.call(torch.from_numpy(x))
            worst = max(worst, np.abs(sed - want[0]).max(),
                        np.abs(doa - want[1]).max())
        want = art.call(torch.from_numpy(bf16_reply[2]))
        worst = max(worst, np.abs(bf16_reply[0] - want[0]).max(),
                    np.abs(bf16_reply[1] - want[1]).max())
    n_req = len(requests) + 1
    windows = sum(x.shape[0] for x in requests) + bf16_x.shape[0]
    p50 = float(np.median([r[2] for r in replies])) * 1e3
    log("serve", f"{n_req} requests ({windows} windows) in {dispatches} "
                 f"dispatches, gru_scan launches {launches}, reply vs direct "
                 f"forward max_abs_err {worst:.3e} (tol {REPLY_TOL:.0e}), "
                 f"p50 latency {p50:.2f} ms, {windows / wall:.1f} windows/s; "
                 f"direct call B=8 {np.median(direct_ms):.2f} ms on {card}")
    if worst > REPLY_TOL:
        raise SystemExit("a reply disagrees with the direct forward")
    if launches == 0 or launches != 2 * dispatches:
        raise SystemExit(f"{launches} gru_scan launches for {dispatches} "
                         "dispatches (want 2 per dispatch)")
    if health.get("status") != "ok" or "seld_batch_dispatches_total" \
            not in metrics:
        raise SystemExit("healthz/metrics incomplete")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script measures "
                         "the port on the card and never falls back to the "
                         "CPU)")
    from seld_tpu_torch.ops import kernels

    # every comparison below is f32 against f32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", smi)

    t0 = time.perf_counter()
    logs = kernels.build()
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line:
                log("build", f"{src}: {line.strip()}")
    log("build", f"{len(kernels.SOURCES)} kernel source(s) ready in "
                 f"{time.perf_counter() - t0:.1f} s")

    entry = phase_kernels(smi)
    model = phase_model(smi)
    entry["launches"] = phase_serve(model, smi)

    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
