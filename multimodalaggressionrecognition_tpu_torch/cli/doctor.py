"""Environment check for the PyTorch package (the JAX package's
cli/doctor.py, with the port's facts).

One JSON report: library versions, whether torch sees a CUDA card (and
why not), the launch (world size, rank, backend), the kernel build's
state (nvcc, the build directory, which csrc/*.cu are built for their
current source, the launch counts), and whether the native wav and mp4
decoders build and load (and why not).
`--smoke` proves the card works: it times one 256x256 matmul round trip,
builds and launches K4 (the shifted-window roll, csrc/roll.cu) once on a
small tensor and checks it bit for bit against torch.roll.  Without a
card `--smoke` exits non-zero and says why.

  python -m multimodalaggressionrecognition_tpu_torch.cli.doctor [--smoke]
"""

import argparse
import json
import os
import subprocess
import time


def _backend(report):
    import torch

    if not torch.cuda.is_available():
        report["backend"] = None
        report["backend_error"] = (
            "torch is built without CUDA" if torch.version.cuda is None
            else "torch sees no CUDA device")
        return
    report["backend"] = "cuda"
    report["devices"] = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        report["devices"].append({
            "name": props.name, "capability": f"{props.major}.{props.minor}",
            "memory_gib": round(props.total_memory / 2 ** 30, 2)})


def _distributed():
    """The launch this process belongs to: torch.distributed's world size,
    rank and backend where a process group is up, else torchrun's
    environment (the JAX doctor's process_count)."""
    import torch.distributed as dist

    env = {k: os.environ[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")
           if k in os.environ}
    if dist.is_available() and dist.is_initialized():
        return {"initialized": True, "world_size": dist.get_world_size(),
                "rank": dist.get_rank(), "backend": dist.get_backend(),
                "env": env}
    return {"initialized": False,
            "world_size": int(env.get("WORLD_SIZE", 1)),
            "rank": int(env.get("RANK", 0)),
            "backends": {"nccl": dist.is_available()
                         and dist.is_nccl_available(),
                         "gloo": dist.is_available()
                         and dist.is_gloo_available()},
            "env": env}


def _kernels():
    from ..utils import kernels

    out = {"build_dir": kernels.BUILD_DIR,
           "built": [n for n in kernels.kernel_sources()
                     if os.path.isfile(kernels.library_path(n))],
           "launch_counts": dict(kernels.launch_counts)}
    try:
        nvcc = kernels._nvcc()
    except RuntimeError as err:
        out["nvcc"], out["nvcc_error"] = None, str(err)
        return out
    out["nvcc"] = nvcc
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    out["nvcc_version"] = version.splitlines()[-1] if version else None
    return out


def _smoke():
    """The matmul round trip and K4 once, bit for bit against torch.roll."""
    import torch

    from ..ops.cuda.roll import circular_roll, roll_reference

    dev = torch.device("cuda")
    x = torch.ones((256, 256), device=dev)
    t0 = time.perf_counter()
    float((x @ x).sum())  # first run + readback
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    float((x @ x).sum())  # the dispatch + readback round trip
    cached_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(0)
    v = torch.randn((2, 4, 14, 14, 8), generator=g).to(dev)
    shifts = (2, 3, 3)
    t0 = time.perf_counter()
    got = circular_roll(v, shifts)  # builds csrc/roll.cu on first use
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    equal = bool(torch.equal(got, roll_reference(v, shifts)))
    return {"matmul_first_run_s": first_s,
            "matmul_cached_roundtrip_s": cached_s,
            "roll": {"shape": list(v.shape), "shifts": list(shifts),
                     "build_and_launch_s": roll_s,
                     "bitwise_equal_to_torch_roll": equal}}


def _native():
    """Whether the native decoders build and load here (data/native.py),
    and why not."""
    from ..data import native

    out = {"libmarhost_wav_decode": native.available(),
           "libmarvideo_mp4_decode": native.video_available()}
    if not all(out.values()):
        out["hint"] = ("wavs then decode with scipy and numpy, .mp4 with "
                       "OpenCV")
    for lib, reason in native.unavailable_reasons().items():
        if reason is not None:
            out[f"{lib}_reason"] = reason
    return out


def collect(smoke: bool = False) -> dict:
    import numpy as np
    import scipy
    import torch

    report = {"versions": {"torch": torch.__version__,
                           "cuda_runtime": torch.version.cuda,
                           "numpy": np.__version__,
                           "scipy": scipy.__version__}}
    _backend(report)
    report["distributed"] = _distributed()
    report["kernels"] = _kernels()
    report["native"] = _native()
    if smoke and report["backend"]:
        report["smoke"] = _smoke()
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="time a matmul and launch K4 once on the card")
    args = p.parse_args(argv)
    report = collect(smoke=args.smoke)
    print(json.dumps(report, indent=2))
    if args.smoke and not report["backend"]:
        raise SystemExit(f"doctor --smoke needs a CUDA card: "
                         f"{report['backend_error']}")
    if args.smoke and not report["smoke"]["roll"][
            "bitwise_equal_to_torch_roll"]:
        raise SystemExit("doctor --smoke: K4 (roll) disagrees with "
                         "torch.roll")
    return report


if __name__ == "__main__":
    main()
