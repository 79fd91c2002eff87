"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one `.cu` file under `seld_tpu_torch/csrc/` with a plain C
interface. At first use it is compiled by nvcc for sm_90a into
`build/kernels/` at the repository root, under a file name that carries a
hash of the source and of the headers beside it (an edited source or
header builds anew), and loaded with ctypes.
`build()` starts one nvcc per source, all at once, so a cold start pays for
the slowest source only.

Every op module declares its C entry points' argument types in its own
`_library()` and launches them through `launch`, the one launch protocol:
it appends the raw handle of the card's current stream, enters a device
guard only where the card is not the current one, checks the returned
CUDA error, and then adds one to `launch_counts[<kernel>]`. Nothing else
counts (`count_launch`, under a lock: worker threads that share a card,
as the NAS search's run_parallel does, lose no count), so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("gru_fwd.cu", "gru_bwd.cu", "stem_dy.cu", "foa_frontend.cu",
           "gather_rows.cu", "batch_norm.cu")
# kernel name (its launch_counts key) -> the source that holds it
KERNELS = {"gru_scan": "gru_fwd.cu", "gru_scan_bwd": "gru_bwd.cu",
           "stem_dy": "stem_dy.cu", "foa_frontend": "foa_frontend.cu",
           "gather_rows": "gather_rows.cu", "batch_norm": "batch_norm.cu",
           "batch_norm_pool": "batch_norm.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: collections.Counter = collections.Counter()
_count_lock = threading.Lock()

_load_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def count_launch(name: str) -> None:
    """One launch of kernel `name` (a key of KERNELS)."""
    with _count_lock:
        launch_counts[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit")


def library_path(source: str) -> str:
    """The built library of `source`, named by a hash of the source, the
    headers beside it (csrc/*.cuh) and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns {source: nvcc output (ptxas register/shared-memory report)};
    raises with the compiler's output if any build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for src in sources:
        out = library_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built on first use."""
    with _load_lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(library_path(source))
            lib.seld_cuda_error_string.argtypes = [ctypes.c_int]
            lib.seld_cuda_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def current_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on a card, for a launch.

    `torch.cuda.current_stream()` builds a Stream object first, which costs
    more host time than a small kernel's whole launch (chip_smoke's
    `gather host us` line); this reads the handle alone."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device_index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err != 0:
        msg = lib.seld_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(kernel: str, entry, what: str, device: int, *args) -> None:
    """Launch `kernel` (a key of KERNELS) through its declared C entry
    point: entry(*args, stream) on card `device`, `stream` the raw handle
    of PyTorch's current stream there. A device guard is entered only where
    that card is not the current one. A returned CUDA error raises, naming
    `what`, and counts nothing; a launch that succeeded counts one."""
    import torch
    if device == torch.cuda.current_device():
        err = entry(*args, current_stream(device))
    else:
        with torch.cuda.device(device):
            err = entry(*args, current_stream(device))
    check(_libs[KERNELS[kernel]], err, what)
    count_launch(kernel)
