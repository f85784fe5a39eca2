"""Kernel families by name, frozen from `chip_smoke.py`'s
`kernel_breakdown`: the rules that file a profiler's kernel under one of
the port's hand-written kernels or a library family."""


def family(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "framed_conv1d" in name:
        return "K1"
    if "roll_kernel<" in name:
        return "K4"
    if "window_attention_bwd" in name or "sum_groups" in name:
        return "K3"
    if "window_attention" in name:
        return "K2"
    if "multi_tensor" in name:
        return "Adam (multi-tensor)"
    if any(k in name for k in ("rnn", "lstm", "gru_")):
        return "RNN cells (cuDNN)"
    if any(k in name for k in ("group_norm", "groupnorm", "rowwisemoments",
                               "computefusedparams")):
        return "GroupNorm"
    if any(k in name for k in ("fprop", "dgrad", "wgrad", "conv", "winograd",
                               "fft", "cf32")):
        return "cuDNN conv"
    if any(k in name for k in ("gemm", "nvjet")):
        return "GEMM"
    if "batch_norm" in name or "bn_" in name:
        return "BatchNorm"
    if "max_pool" in name:
        return "max pool"
    if "layer_norm" in name:
        return "LayerNorm"
    if any(k in name for k in ("roll", "copy", "pad", "cat")):
        return "copies, pads, concat"
    return "other elementwise, reductions"


def is_transfer(kernel_name: str) -> bool:
    """A copy or fill of memory (Memcpy, Memset), not a kernel."""
    return kernel_name.startswith(("Memcpy", "Memset", "memcpy", "memset"))
