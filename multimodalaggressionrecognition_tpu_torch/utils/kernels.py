"""Build, load, launch and count the port's hand-written CUDA kernels.

Each kernel lives in `csrc/<name>.cu` with a plain C entry point.  On first
use it is compiled with `nvcc` for Hopper (`sm_90a`) into a shared library
under the package's `_build/` directory, keyed by a hash of the source and
the flags, and loaded with `ctypes` — no PyTorch headers, so a build takes
seconds.  Nothing here runs at import time: the CPU-only test environment
imports every module and never builds.

The wrappers (`ops/cuda/`) declare each entry point's C signature as data
(`load_library`), check the tensors they hand it (`check_tensor`) and call
it through `launch` or `query`.  `launch` is the one place that adds to
`launch_counts`: one under the launch's key, after its status is checked,
so a run can show that its path went through the kernel (chip_smoke.py and
the benchmark's launch plan read the counts).  A kernel's bf16 instantiation
counts under `<name>.bf16` (`launch_key`), so a bf16 path shows which
instantiation it ran.

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

import torch

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


# one code per C parameter: a pointer (a tensor, or None for a null one),
# an int, a float, an int out-array
_CTYPES = {"P": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "o": ctypes.POINTER(ctypes.c_int)}


def bind(lib, signatures: dict):
    """Declare the argtypes and (int) restype of each entry point of `lib`
    from `signatures`, {entry: codes}, one `_CTYPES` code a parameter.  An
    entry that takes a pointer launches kernels: its last parameter, the
    stream, is appended here.  ctypes then checks every call's arguments
    against the declaration."""
    for entry, codes in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = [_CTYPES[c] for c in codes + ("P" if "P" in codes
                                                     else "")]
        fn.restype = ctypes.c_int


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`, its entry points bound
    once from `signatures` (`bind`)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_finish_build(name, *_start_build(name)))
            bind(lib, signatures)
            _libs[name] = lib
        return lib


def check_status(name: str, status: int):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {status}")


def check_tensor(op: str, name: str, t, shape, dtype, device,
                 aligned: bool = False):
    """Raise unless `t`, the tensor `op` hands its kernel as `name`, has
    `dtype` (else TypeError), is on `device`, has `shape`, is contiguous
    and, where `aligned`, starts on a 16-byte boundary (else ValueError)."""
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, not {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{op}: {name} must be 16-byte aligned")


def launch(lib, entry: str, key: str, device, *args):
    """Run `lib`'s launch entry point `entry` on `device`'s current stream
    with `args` (a tensor passes its data pointer, None a null one), raise
    on its status and add one to `launch_counts` under `key`: the only
    place a launch is counted."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    check_status(entry, getattr(lib, entry)(*args, stream))
    launch_counts[key] += 1


def query(lib, entry: str, *args, n_out: int = 0):
    """Call `lib`'s query entry point `entry` (no stream, nothing launched)
    and raise on a failure.  With `n_out`, the entry fills an int array of
    that length, passed last, and returns a cudaError_t: the array comes
    back as a list.  Without, it returns a count, or minus a cudaError_t:
    the count comes back."""
    fn = getattr(lib, entry)
    if n_out:
        out = (ctypes.c_int * n_out)()
        check_status(entry, fn(*args, out))
        return list(out)
    value = fn(*args)
    if value < 1:
        check_status(entry, -value or 1)
    return value
