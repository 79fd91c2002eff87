"""Where a GRU forward step's time goes past U = 256, on the card.

    python -m seld_tpu_torch.gru_probe [--units 384 512] [--batch 256]
                                       [--kernel streamed|resident|grid]

Builds csrc/gru_fwd.cu several times into build/probe/ (one nvcc each, all
at once): as it is, and with one part of the variant's step taken out by
a text edit of the copy (the results of the edited builds are wrong; only
their times are read). The streamed variant (EDITS):
  full        the kernel as it is
  no_rk       Rk's values are constants: no Rk load from device memory
  no_barrier  no cluster barrier between steps
  no_hstage   no staging of the previous states into shared memory (the
              chunk loop's loads and its two block barriers)
the resident one (RES_EDITS): full; no_exchange (no st.shared::cluster of
the new h); no_barrier (one cluster barrier after the last step, so that
no CTA leaves while a peer writes into it); no_smem_w (the Rk chunks held
in shared memory are constants); no_h_reads (the h rows are constants).
`--kernel grid` instead times csrc/gru_fwd.cu's grid-resident forward with
the state in 3 bf16 parts (as it is) and in 2 (GRID_FWD_EDITS), and takes
csrc/gru_bwd.cu's grid-resident recurrence apart (GRID_EDITS), splitting
the backward by pass with each copy.
Each is timed on the variant's plan (`_fwd_plan(..., variant=_FWD_STREAM)`
or the default plan) at D=2, T=60, B=`--batch`, bf16, with CUDA events.
Then splits the backward (the same kind of plan) into its passes with
torch.profiler, and reads `cudaOccupancyMaxActiveClusters` for clusters of
8 and 16 CTAs at the shared-memory sizes and block sizes given by
`--occupancy`. Prints one JSON line last; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np

from seld_tpu_torch.ops import kernels

PROBE_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "probe")

# (edit name, [(text in gru_fwd.cu, replacement, times it occurs)])
EDITS = {
    "full": [],
    "no_rk": [
        ("w[g][q] = __ldg(col + static_cast<size_t>(k_lo + q) * K + g * U);",
         "w[g][q] = 1e-3f * (q + 1 + g);", 1),
        ("wn[g][q] = more ? __ldg(col + static_cast<size_t>(k + 4 + q) * K +\n"
         "                                      g * U)\n"
         "                              : 0.0f;",
         "wn[g][q] = more ? 1e-3f * (q + 2 + g) : 0.0f;", 1)],
    "no_barrier": [
        ("    if (s + 1 < steps) {\n      cluster_arrive();\n"
         "      cluster_wait();\n    }\n", "", 1)],
    "no_hstage": [
        ("        __syncthreads();                 // the previous chunk is "
         "consumed\n"
         "        for (int i = threadIdx.x; i < BT * KC; i += blockDim.x) {\n"
         "          const int b = i / KC, k = i % KC;\n"
         "          h_s[b][k] = b < rows && k0 + k < U\n"
         "                          ? __ldcg(hprev + static_cast<size_t>(b) "
         "* U + k0 + k)\n"
         "                          : 0.0f;\n"
         "        }\n"
         "        __syncthreads();\n", "", 1)],
}

# the same for the resident variant (`--kernel resident`)
RES_EDITS = {
    "full": [],
    "no_exchange": [
        ("#pragma unroll\n          for (int peer = 0; peer < C; ++peer)\n"
         "            st_cluster(map_rank(h_local + off, peer), hn);\n", "",
         1)],
    "no_barrier": [   # one barrier at the end: no CTA leaves while peers
        ("    if (exchange) {\n      cluster_arrive();\n"
         "      cluster_wait();\n    }\n  }\n}\n",
         "  }\n  cluster_arrive();\n  cluster_wait();\n}\n", 1)],
    "no_smem_w": [
        ("const float4 f = w_s[(i * 3 + g) * nt + tid];",
         "const float4 f = make_float4(1e-3f, 2e-3f, 3e-3f, 4e-3f);", 1)],
    "no_h_reads": [
        ("h4[b] = *reinterpret_cast<const float4*>(a + (b0 + b) * stride);",
         "h4[b] = make_float4(1e-3f * b, 1e-3f, 2e-3f, 3e-3f);", 1)],
}

# the grid-resident backward recurrence (`--kernel grid`, csrc/gru_bwd.cu;
# timed by pass at Rk in bf16): full; no_product (no chunk streamed and no
# wgmma: the step's gates, stores, barriers and group sums alone);
# no_group (the partial sums neither written nor waited for)
GRID_EDITS = {
    "full": [],
    "no_product": [
        ("for (int kc = r * nq; kc < (r + 1) * nq; ++kc, ++gs) {",
         "for (int kc = r * nq; kc < r * nq; ++kc, ++gs) {", 1),
        ("for (int kc = 0; kc < nq; ++kc, ++gs) {",
         "for (int kc = 0; kc < 0; ++kc, ++gs) {", 1)],
    "no_group": [
        ("      tc::wait_counter(gcount,", "      if (0) tc::wait_counter(gcount,",
         1),
        ("            __stcg(mine + b * kGridUnits + m, acc[sb][4 * i + 2 * hh + e]);",
         "            if (0) __stcg(mine + b * kGridUnits + m, "
         "acc[sb][4 * i + 2 * hh + e]);", 1)],
}

# the grid-resident forward (`--kernel grid`, csrc/gru_fwd.cu; timed with
# Rk in bf16): full; two_parts (the state h exchanged and multiplied as 2
# bf16 parts instead of 3: 2^-18 of h kept, two thirds of the bytes)
GRID_FWD_EDITS = {
    "full": [],
    "two_parts": [("constexpr int kGridParts = 3;",
                   "constexpr int kGridParts = 2;", 1)],
}

# a kernel whose occupancy stands for a resident variant's: one CTA of
# `threads` threads and `smem` bytes of dynamic shared memory
OCCUPANCY_SRC = r"""
#include <cuda_runtime.h>
__global__ void probe_kernel(float* out) {
  extern __shared__ float s[];
  s[threadIdx.x] = threadIdx.x;
  __syncthreads();
  if (out) out[threadIdx.x] = s[threadIdx.x];
}
extern "C" int probe_max_clusters(int cluster, int threads, int smem,
                                  int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(probe_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, probe_kernel, &cfg);
}
"""


def edited_source(name: str, edits=EDITS, source="gru_fwd.cu") -> str:
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        src = f.read()
    for old, new, times in edits[name]:
        found = src.count(old)
        if found != times:
            raise SystemExit(f"edit {name}: found {found} of {times} "
                             f"occurrence(s) of {old!r}")
        src = src.replace(old, new)
    return src


def build_all(edits, source="gru_fwd.cu", occupancy=True, more=None):
    """One nvcc per edited copy of `source`, one for the occupancy kernel
    and one for each of `more` ({name: source text}), all at once; returns
    {name: library path}."""
    os.makedirs(PROBE_DIR, exist_ok=True)
    sources = {n: edited_source(n, edits, source) for n in edits}
    if occupancy:
        sources["occupancy"] = OCCUPANCY_SRC
    sources.update(more or {})
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(PROBE_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(PROBE_DIR, f"lib{name}.so")
        # -I: the copies include csrc/'s headers (tc.cuh)
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR,
             "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        out[name] = so
    return out


def time_forward(lib_path, xp, rk, rb, plan, iters=10):
    """ms a call of `seld_gru_fwd` in the library at lib_path on `plan`."""
    import torch
    lib = ctypes.CDLL(lib_path)
    lib.seld_gru_fwd.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    lib.seld_gru_fwd.restype = ctypes.c_int
    lib.seld_gru_fwd_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.seld_gru_fwd_workspace_bytes.restype = ctypes.c_size_t
    d, t, b, k = xp.shape
    u = k // 3
    is_bf16 = int(xp.dtype == torch.bfloat16)
    hs = torch.empty((d, t, b, u), dtype=xp.dtype, device=xp.device)
    ws = torch.empty(max(1, lib.seld_gru_fwd_workspace_bytes(
        d, b, u, plan.variant)), dtype=torch.uint8, device=xp.device)
    stream = kernels.current_stream(xp.device.index)

    def call():
        # rk16 (Rk in bf16, read by the grid-resident variant alone) is rk
        # itself: each probed variant reads rk in the dtype it takes
        err = lib.seld_gru_fwd(xp.data_ptr(), rk.data_ptr(), rb.data_ptr(),
                               hs.data_ptr(), ws.data_ptr(), d, t, b, u,
                               is_bf16, plan.variant, plan.c, plan.bt,
                               rk.data_ptr(), stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
    for _ in range(2):
        call()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, hs


def backward_split(xp, rk, rb, g, plan, n=5):
    """Device ms a call of the backward by kernel (torch.profiler)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from seld_tpu_torch.ops.gru import _gru_scan_bwd_cuda, gru_scan_ref
    hs = gru_scan_ref(xp, rk, rb)

    def call():
        _gru_scan_bwd_cuda(xp, rk, rb, hs, g, plan=plan)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for avg in prof.key_averages():
        if avg.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"\b(gru_bwd_\w*?_kernel)", avg.key)
        us = getattr(avg, "self_device_time_total", None)
        us = avg.self_cuda_time_total if us is None else us
        if m and us > 0:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3 / n
    return out


def grid_split(libs, units, b):
    """The backward by pass at D=2, T=60, B=b, bf16 with Rk in bf16 (the
    grid-resident plan) with each edited gru_bwd.cu library in turn in
    place of the port's (the wrapper loads whichever library the kernel
    cache holds for the source)."""
    import torch

    from seld_tpu_torch.ops import gru
    rng = np.random.RandomState(16)
    d, t = 2, 60
    out = {}
    for u in units:
        xp = torch.from_numpy(rng.randn(d, t, b, 3 * u).astype(
            np.float32)).cuda().bfloat16()
        rk = torch.from_numpy((rng.randn(d, u, 3 * u) / math.sqrt(u))
                              .astype(np.float32)).cuda().bfloat16()
        rb = torch.from_numpy(0.1 * rng.randn(d, 3 * u).astype(
            np.float32)).cuda()
        g = torch.from_numpy(rng.randn(d, t, b, u).astype(
            np.float32)).cuda().bfloat16()
        plan = gru._bwd_plan(d, b, u, rk_bf16=True)
        if plan.variant != gru._BWD_GRID:
            raise SystemExit(f"U={u}, B={b}: no grid-resident plan")
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            lib.seld_cuda_error_string.argtypes = [ctypes.c_int]
            lib.seld_cuda_error_string.restype = ctypes.c_char_p
            kernels._libs[gru._BWD_SOURCE] = lib
            gru._bwd_library.cache_clear()
            split = backward_split(xp, rk, rb, g, plan)
            out[f"U{u}_{name}"] = split
            print(f"[probe] grid backward bf16 D=2 T=60 B={b} U={u} {name}, "
                  f"device ms a call by kernel: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in split.items())
                  + f"; sum {sum(split.values()):.4f}", flush=True)
    kernels._libs.pop(gru._BWD_SOURCE, None)
    gru._bwd_library.cache_clear()
    return out


def grid_forward(libs, units, b, rounds=2):
    """The grid-resident forward at D=2, T=60, B=b, bf16 storage, Rk in
    bf16, with each edited gru_fwd.cu library: ms a call (CUDA events; the
    libraries in turns, `rounds` times each way) and max |hs - ref|
    against gru_scan_ref."""
    import torch

    from seld_tpu_torch.ops import gru
    rng = np.random.RandomState(18)
    d, t = 2, 60
    out = {}
    for u in units:
        xp = torch.from_numpy(rng.randn(d, t, b, 3 * u).astype(
            np.float32)).cuda().bfloat16()
        rk = torch.from_numpy((rng.randn(d, u, 3 * u) / math.sqrt(u))
                              .astype(np.float32)).cuda().bfloat16()
        rb = torch.from_numpy(0.1 * rng.randn(d, 3 * u).astype(
            np.float32)).cuda()
        plan = gru._fwd_plan(d, b, u, rk_bf16=True)
        if plan.variant != gru._FWD_GRID:
            raise SystemExit(f"U={u}, B={b}: no grid-resident forward")
        ref = gru.gru_scan_ref(xp, rk, rb).float()
        row = {n: {"ms": []} for n in libs}
        order = list(libs) * rounds
        for name in order + order[::-1]:
            ms, hs = time_forward(libs[name], xp, rk, rb, plan)
            row[name]["ms"].append(ms)
            row[name]["max_abs_err"] = (hs.float() - ref).abs().max().item()
        out[f"U{u}"] = row
        print(f"[probe] grid forward bf16 D=2 T=60 B={b} U={u} Rk bf16: "
              + "; ".join(f"{n} " + "/".join(f"{m:.4f}" for m in r["ms"])
                          + f" ms, max_abs_err {r['max_abs_err']:.3e}"
                          for n, r in row.items()), flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--units", type=int, nargs="+", default=None,
                        help="default 384 512; 1024 with --kernel grid")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--kernel", choices=("streamed", "resident", "grid"),
                        default="streamed",
                        help="the variant whose step is taken apart (the "
                             "backward split is the same variant's; grid: "
                             "the grid-resident forward with 3 and 2 parts "
                             "of h, and the backward recurrence taken "
                             "apart, --units 1024 by default)")
    parser.add_argument("--occupancy", nargs="+", default=[
        "8:384:230400", "8:384:208896", "8:256:229376", "16:256:229376",
        "16:256:204800", "16:512:204800", "16:384:229376"],
        metavar="C:THREADS:SMEM")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gru_probe: no CUDA device")
    from seld_tpu_torch.ops.gru import (_BWD_STREAM, _FWD_STREAM, _bwd_plan,
                                        _fwd_plan)
    resident = args.kernel == "resident"
    fwd_variant = None if resident else _FWD_STREAM
    bwd_variant = None if resident else _BWD_STREAM
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[probe] {smi}", flush=True)
    if args.kernel == "grid":
        libs = build_all(GRID_EDITS, "gru_bwd.cu", occupancy=False, more={
            f"fwd_{n}": edited_source(n, GRID_FWD_EDITS)
            for n in GRID_FWD_EDITS})
        fwd = {n: libs.pop(f"fwd_{n}") for n in GRID_FWD_EDITS}
        units = args.units or [1024]
        print(json.dumps({"device": smi,
                          "grid_forward": grid_forward(fwd, units,
                                                       args.batch),
                          "grid_backward": grid_split(libs, units,
                                                      args.batch)}))
        return 0
    libs = build_all(RES_EDITS if resident else EDITS)
    occ_lib = ctypes.CDLL(libs.pop("occupancy"))
    occ_lib.probe_max_clusters.argtypes = [ctypes.c_int] * 3 + \
        [ctypes.POINTER(ctypes.c_int)]
    result = {"device": smi, "forward": {}, "backward": {}, "occupancy": {}}
    rng = np.random.RandomState(15)
    d, t, b = 2, 60, args.batch
    for u in args.units or [384, 512]:
        xp = torch.from_numpy(rng.randn(d, t, b, 3 * u).astype(
            np.float32)).cuda().bfloat16()
        rk = torch.from_numpy((rng.randn(d, u, 3 * u) / math.sqrt(u))
                              .astype(np.float32)).cuda()
        rb = torch.from_numpy(0.1 * rng.randn(d, 3 * u).astype(
            np.float32)).cuda()
        plan = _fwd_plan(d, b, u, variant=fwd_variant)
        times = {}
        for name, path in libs.items():
            times[name], _ = time_forward(path, xp, rk, rb, plan)
        times["step_us"] = {k: v / t * 1e3 for k, v in times.items()}
        result["forward"][f"U{u}"] = times
        print(f"[probe] {args.kernel} forward bf16 D=2 T=60 B={b} U={u} "
              f"(C={plan.c}, {plan.ctas} CTAs of {plan.threads}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()
                          if k != "step_us"), flush=True)
        g = torch.from_numpy(rng.randn(d, t, b, u).astype(
            np.float32)).cuda().bfloat16()
        split = backward_split(xp, rk, rb, g,
                               _bwd_plan(d, b, u, variant=bwd_variant))
        result["backward"][f"U{u}"] = split
        print(f"[probe] {args.kernel} backward bf16 D=2 T=60 B={b} U={u}, "
              f"device ms a call by kernel: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items())
              + f"; sum {sum(split.values()):.4f}", flush=True)
    for spec in args.occupancy:
        c, threads, smem = (int(x) for x in spec.split(":"))
        n = ctypes.c_int(-1)
        err = occ_lib.probe_max_clusters(c, threads, smem, ctypes.byref(n))
        result["occupancy"][spec] = n.value if err == 0 else f"error {err}"
        print(f"[probe] cudaOccupancyMaxActiveClusters cluster {c}, "
              f"{threads} threads, {smem} B shared: "
              f"{n.value if err == 0 else f'CUDA error {err}'}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
