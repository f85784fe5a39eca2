"""ctypes bindings for the native host libraries (the JAX package's
data/native.py, which the port does not import).

`native/marhost.cpp` decodes WAVs (PCM16/24/32, float32), mixes them to
mono, resamples them with the windowed-sinc polyphase filter of
ops/resample.py and assembles fixed-shape batches on threads; it needs
nothing but the C++ standard library.  `native/marvideo.cpp` decodes .mp4
clips through FFmpeg (libavformat, libavcodec, libswscale, libavutil),
resizes frames inside the decode's swscale pass and assembles batches on
threads.  Callers fall back to scipy and numpy, or to OpenCV, when a
library is unavailable.

The libraries are built from those sources on first use, with `g++` and
the flags of native/Makefile (plus `pkg-config`'s flags for the libav*
libraries), into the package's git-ignored `_build/` directory, keyed by a
hash of the source, the flags and the compiler's version, and published
with an atomic rename, so processes that build at once never load a
half-written file.  The shared objects under `native/` are never loaded
or written: they were built with `-march=native` on another machine.
`unavailable_reasons()` says why a library is missing: no `g++`, the
libav* libraries `pkg-config` cannot find, or the compiler's last lines.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from ..utils.kernels import BUILD_DIR, PACKAGE_DIR

NATIVE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "native")
CXXFLAGS = ("-O3", "-march=native", "-ffast-math", "-funroll-loops", "-fPIC",
            "-std=c++17", "-Wall")
FFMPEG_PACKAGES = ("libavformat", "libavcodec", "libswscale", "libavutil")

_lock = threading.Lock()
_libs: dict = {}      # library name -> ctypes.CDLL or None, once tried
_reasons: dict = {}   # library name -> why it is unavailable


class NativeLibraryError(RuntimeError):
    """A native library could not be built or loaded; the message says
    why."""


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600)


def _pkg_config_flags():
    """(cflags, libs) of the libav* libraries from pkg-config; raises
    NativeLibraryError naming the ones it cannot find."""
    pkg_config = shutil.which("pkg-config")
    if pkg_config is None:
        raise NativeLibraryError("pkg-config not found: libmarvideo needs "
                                 "it to find " + ", ".join(FFMPEG_PACKAGES))
    missing = [p for p in FFMPEG_PACKAGES
               if _run([pkg_config, "--exists", p]).returncode != 0]
    if missing:
        raise NativeLibraryError("pkg-config finds no "
                                 + ", ".join(missing))
    cflags = _run([pkg_config, "--cflags", *FFMPEG_PACKAGES]).stdout.split()
    libs = _run([pkg_config, "--libs", *FFMPEG_PACKAGES]).stdout.split()
    return cflags, libs


def library_path(name: str) -> str:
    """Build (if needed) `lib<name>.so` from native/<name>.cpp and return
    its path under _build/; raises NativeLibraryError with the reason."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeLibraryError("g++ not found")
    cflags, libs = (_pkg_config_flags() if name == "marvideo"
                    else ((), ()))
    source = os.path.join(NATIVE_DIR, name + ".cpp")
    version = _run([cxx, "--version"]).stdout.splitlines()[:1]
    digest = hashlib.sha256(" ".join([*CXXFLAGS, *cflags, *libs, *version])
                            .encode())
    with open(source, "rb") as f:
        digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = _run([cxx, *CXXFLAGS, *cflags, "-shared", "-o", tmp, source,
                 *libs, "-lpthread"])
    if proc.returncode != 0:
        last = "\n".join((proc.stdout + proc.stderr).strip().splitlines()[-5:])
        raise NativeLibraryError(f"g++ failed building {name}.cpp (exit "
                                 f"{proc.returncode}): {last}")
    os.replace(tmp, out)  # atomic: a concurrent build sees whole files
    return out


def _load(name: str, bind) -> Optional[ctypes.CDLL]:
    """The built and bound library `name`, or None (the reason kept)."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        try:
            lib = ctypes.CDLL(library_path(name))
        except NativeLibraryError as err:
            _reasons[name] = str(err)
        except OSError as err:  # built, but its runtime libraries are absent
            _reasons[name] = f"lib{name}.so does not load: {err}"
        if lib is not None:
            bind(lib)
        _libs[name] = lib
        return lib


def unavailable_reasons() -> dict:
    """{'libmarhost': reason or None, 'libmarvideo': reason or None} for
    the libraries tried so far (None: it loaded, or was not tried)."""
    return {f"lib{n}": _reasons.get(n) for n in ("marhost", "marvideo")}


def _bind_host(lib):
    lib.mar_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_int, ctypes.POINTER(ctypes.c_long)]
    lib.mar_wav_read.restype = ctypes.c_int
    lib.mar_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.c_int]
    lib.mar_wav_batch.restype = ctypes.c_int
    lib.mar_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]
    lib.mar_resample.restype = ctypes.c_int


def _bind_video(lib):
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    lib.mar_video_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_double)]
    lib.mar_video_probe.restype = ctypes.c_int
    lib.mar_video_read.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.mar_video_read.restype = ctypes.c_long
    lib.mar_video_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.mar_video_batch.restype = ctypes.c_int


def load_library() -> Optional[ctypes.CDLL]:
    """libmarhost (WAV decode, resample, batches), or None."""
    return _load("marhost", _bind_host)


def available() -> bool:
    return load_library() is not None


def _host():
    lib = load_library()
    if lib is None:
        raise RuntimeError("libmarhost unavailable: "
                           + unavailable_reasons()["libmarhost"])
    return lib


def wav_read(path: str, target_len: int,
             target_rate: int = 16000) -> np.ndarray:
    """One WAV, mono, resampled to `target_rate`, cut or zero-padded to
    `target_len` samples."""
    lib = _host()
    out = np.zeros(target_len, np.float32)
    decoded = ctypes.c_long(0)
    rc = lib.mar_wav_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        target_len, target_rate, ctypes.byref(decoded))
    if rc != 0:
        raise IOError(f"mar_wav_read failed for {path}")
    return out


def wav_batch(paths: Sequence[str], target_len: int, target_rate: int = 16000,
              num_threads: int = 4) -> np.ndarray:
    """`wav_read` of each path on `num_threads` threads -> (N, target_len)."""
    lib = _host()
    n = len(paths)
    out = np.zeros((n, target_len), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.mar_wav_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        target_len, target_rate, num_threads)
    if failures:
        raise IOError(f"{failures} wav files failed to decode")
    return out


def load_video_library() -> Optional[ctypes.CDLL]:
    """libmarvideo (FFmpeg decode, fused resize, batches), or None."""
    return _load("marvideo", _bind_video)


def video_available() -> bool:
    return load_video_library() is not None


def _video():
    lib = load_video_library()
    if lib is None:
        raise RuntimeError("libmarvideo unavailable: "
                           + unavailable_reasons()["libmarvideo"])
    return lib


def video_probe(path: str):
    """(width, height, nb_frames, fps); nb_frames is 0 when the container
    doesn't record a count (decode to find out)."""
    lib = _video()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    n, fps = ctypes.c_long(0), ctypes.c_double(0)
    if lib.mar_video_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(n), ctypes.byref(fps)):
        raise IOError(f"mar_video_probe failed for {path}")
    return w.value, h.value, n.value, fps.value


# decode-buffer guards: the batch pipeline passes explicit frames/size, so
# these only bound the read-everything path on pathological inputs (a
# fragmented container with no nb_frames, or a corrupt frame count)
_MAX_DECODE_BYTES = 8 << 30
_FIRST_GUESS_BYTES = 1 << 30


def video_read(path: str, max_frames: int = 0,
               size: Optional[int] = None) -> np.ndarray:
    """Decode to (T, H, W, 3) RGB uint8; `size` resizes (bilinear, fused
    into the decode's swscale pass), `max_frames` caps T (0 = all).

    When the container carries no frame count, the whole-file read decodes
    into a geometrically grown buffer (each growth re-decodes: the C API
    is stateless); reads that would exceed an 8 GB buffer raise instead of
    silently truncating: pass max_frames= or size= for such files."""
    lib = _video()
    w, h, n, fps = video_probe(path)
    if size is not None:
        w = h = size
    frame_bytes = max(h * w * 3, 1)
    if max_frames:
        cap = max_frames
    elif n > 0:
        cap = n
    else:  # unknown count: start from a ~1 GB guess, grow on overflow
        cap = max(_FIRST_GUESS_BYTES // frame_bytes, 16)
    while True:
        if cap * frame_bytes > _MAX_DECODE_BYTES:
            raise IOError(
                f"{path}: decoding {cap} frames at {w}x{h} needs "
                f"{cap * frame_bytes >> 30} GB; pass max_frames= or size= "
                f"to bound the read")
        out = np.empty((cap, h, w, 3), np.uint8)
        got = lib.mar_video_read(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            cap, w if size is not None else 0, h if size is not None else 0)
        if got < 0:
            raise IOError(f"mar_video_read failed for {path}")
        if got < cap or max_frames or n > 0:
            return out[:got]
        cap *= 4  # unknown count and the guess filled up: grow and redecode


def video_batch(paths: Sequence[str], frames: int, size: int,
                num_threads: int = 8) -> np.ndarray:
    """Threaded decode+resize to (N, frames, size, size, 3) uint8,
    zero-padded past each clip's end."""
    lib = _video()
    n = len(paths)
    out = np.empty((n, frames, size, size, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.mar_video_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        frames, size, size, num_threads)
    if failures:
        raise IOError(f"{failures} video files failed to decode")
    return out


def resample(x: np.ndarray, orig_rate: int, new_rate: int) -> np.ndarray:
    """Polyphase resample of a 1-D signal (ops/resample.py's filter)."""
    lib = _host()
    x = np.ascontiguousarray(x, np.float32)
    cap = int(np.ceil(new_rate * len(x) / orig_rate)) + 16
    out = np.zeros(cap, np.float32)
    out_len = ctypes.c_long(0)
    rc = lib.mar_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), orig_rate,
        new_rate, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError("mar_resample buffer too small")
    return out[:out_len.value]
