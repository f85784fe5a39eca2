"""Build, load and count the port's hand-written CUDA kernels.

Each kernel lives in `csrc/<name>.cu` with a plain C entry point.  On first
use it is compiled with `nvcc` for Hopper (`sm_90a`) into a shared library
under the package's `_build/` directory, keyed by a hash of the source and
the flags, and loaded with `ctypes` — no PyTorch headers, so a build takes
seconds.  Nothing here runs at import time: the CPU-only test environment
imports every module and never builds.

Every wrapper adds one to `launch_counts[<name>]` each time it launches its
kernel, and nowhere else, so a run can show that its path went through the
kernel (chip_smoke.py resets and reads the counts).  A kernel's bf16
instantiation counts under `<name>.bf16` (`launch_key`), so a bf16 path
shows which instantiation it ran.

There is no automatic kernel selection: a wrapper takes its plain PyTorch
version only for a tensor on the CPU, and for a CUDA tensor launches the
kernel or raises.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: collections.Counter = collections.Counter()
_KEY_SUFFIX = {"torch.float32": "", "torch.bfloat16": ".bf16"}


def launch_key(name: str, dtype) -> str:
    """The `launch_counts` key of kernel `name`'s instantiation for the
    torch dtype `dtype`: `name` for float32, `<name>.bf16` for bfloat16."""
    return name + _KEY_SUFFIX[str(dtype)]

_libs: dict = {}
_lock = threading.Lock()


def kernel_sources():
    """Names of every kernel source under csrc/ (without `.cu`)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source on first use")


def library_path(name: str) -> str:
    """Where `name`'s library lives: keyed by its source, the shared headers
    of csrc/ and the flags, so an edit or a changed flag never loads a stale
    build."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_log(name: str) -> str:
    """nvcc's output for `name`'s library (ptxas's registers, spills and
    static shared memory per kernel), kept beside it."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


def _start_build(name: str):
    """Start nvcc for `name` unless its library exists; returns the process
    (or None) and the temporary output path it writes."""
    out = library_path(name)
    if os.path.isfile(out):
        return None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc, tmp: str) -> str:
    out = library_path(name)
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", out[:-3] + ".log")
    os.replace(tmp, out)  # atomic: a concurrent build sees whole files
    return out


def build_all() -> dict:
    """Compile every kernel source with one nvcc each, all started
    together; returns {name: library path}."""
    started = {n: _start_build(n) for n in kernel_sources()}
    return {n: _finish_build(n, *proc_tmp) for n, proc_tmp in started.items()}


def load_library(name: str, bind) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; `bind(lib)` declares the
    argtypes/restype of its entry points once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_finish_build(name, *_start_build(name)))
            bind(lib)
            _libs[name] = lib
        return lib


def check_status(name: str, status: int):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {status}")
