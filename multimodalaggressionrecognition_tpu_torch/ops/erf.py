"""GELU modes of the Swin MLP (the JAX package's ops/erf.py and the
`gelu` switch of models/swin3d.py).

- "poly": the JAX package's float32 polynomial erf, which exists because
  XLA's erf lowering is slow on the TPU.  Its GELU is within 1.3e-6 of the
  exact one, so the port computes the exact GELU (`F.gelu`,
  approximate="none") and keeps no polynomial;
- "erf": the exact GELU, as above;
- "tanh": torch's approximate="tanh" GELU.
"""

import torch.nn.functional as F

GELU_MODES = {"poly": "none", "erf": "none", "tanh": "tanh"}


def check_gelu_mode(mode: str) -> str:
    if mode not in GELU_MODES:
        raise ValueError(
            f"gelu must be 'poly', 'erf' or 'tanh', got {mode!r}")
    return mode


def gelu(x, mode: str = "poly"):
    return F.gelu(x, approximate=GELU_MODES[check_gelu_mode(mode)])
