"""Self-attention with dropout of its weights: a bf16 forward
(csrc/self_attention.cu) and backward (csrc/self_attention_bwd.cu) kernel,
with their plain PyTorch version.

The unmasked path of `MultiheadSelfAttention._attend` (models/layers.py)
in bf16 on the card: XLS-R's and the wav2vec-2 family's transformer layers.
It replaces no TPU kernel (the JAX package leaves this attention to XLA):
the plain composition makes a pass over device memory per op of the
(B, heads, T, T) scores and keeps ~1.1 GB of them a layer for autograd at
XLS-R's 10 s clips.  For packed qkv (B, T, 3 heads d) and the dropout's
uniforms u (B, heads, T, T) f32, or None, it returns (B, T, heads d)

    softmax(q k^T / sqrt(d)) with each weight kept where u < keep, scaled
    by 1 / keep (0 elsewhere), times v,

per (batch, head).  `self_attention` is the entry: a CPU tensor takes the
plain version, `self_attention_reference` (the layer's own composition);
a CUDA one the kernels, through a `torch.autograd.Function` where a
gradient of qkv is wanted.  The kernels read the uniforms the layer's
dropout drew (its one `torch.rand` a layer, in the layer's draw order) and
keep an element where u < keep, the f32 comparison the plain dropout
makes, so the keep mask is the same bit for bit; they never draw.  The
forward keeps, for the backward, each row's logsumexp (base 2, (B, heads,
T) f32) and the keep mask as bits ((B, heads, T, 2 ceil(T / 64)) int32
words); the uniforms are freed after it, as the plain composition frees
them.  Without uniforms (eval, rate 0) there is no mask.

Without a gradient and without uniforms the forward is the
`mar_torch::self_attention` op (torch.library): the plain version on the
CPU, the kernel on CUDA, and a fake for torch.export, which keeps the op
in a serving artifact's graph (io/export.py).  `utils/kernels.launch`
counts the launches under `self_attention.bf16` and
`self_attention_bwd.bf16`.

`kernel_takes(qkv, head_dim)` is the routing predicate `_attend` applies,
with no key padding mask: a CUDA bf16 qkv at a head dim the kernels take.
"""

import math
from typing import Optional

import torch

from ...utils.kernels import (check_tensor, launch, launch_key, load_library,
                               query)

HEAD_DIMS = (32, 64)  # the kernels' instantiations
TILE = 64  # keys a mask word pair covers (csrc/self_attention.cuh)


def kernel_takes(qkv, head_dim: int) -> bool:
    """Whether the kernels run the attention of `qkv` with heads of
    `head_dim` (and no key padding mask): a CUDA bf16 tensor at a head dim
    they take."""
    return (qkv.device.type == "cuda" and qkv.dtype == torch.bfloat16
            and head_dim in HEAD_DIMS)


def self_attention_reference(qkv, u, heads: int, keep: float = 1.0):
    """The plain version, `_attend`'s composition without a mask: qkv
    (B, T, 3 heads d), u (B, heads, T, T) or None -> (B, T, heads d) in
    qkv's dtype; the scores and the softmax in f32, the weights in qkv's
    dtype for the dropout and P.V."""
    b, t, _ = qkv.shape
    d = qkv.shape[-1] // (3 * heads)
    q, k, v = qkv.view(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    if u is not None:
        attn = torch.where(u < keep, attn / keep, 0.0)
    return (attn @ v).transpose(1, 2).reshape(b, t, heads * d)


def _tiles(t: int) -> int:
    return (t + TILE - 1) // TILE


# qkv, u, out, lse, bits, B, T, heads, d, keep; info: d, drop, out[3]
_FWD = {"self_attention_bf16": "PPPPPiiiif", "self_attention_info": "iio"}
# qkv, g, lse, bits, dqkv, dsum, B, T, heads, d, keep; info: d, drop, out[5]
_BWD = {"self_attention_bwd_bf16": "PPPPPPiiiif",
        "self_attention_bwd_info": "iio"}


def launch_info(d: int, drop: bool) -> dict:
    """The kernels' launches at head dim `d`, with or without dropout, on
    the current card: threads per block, and each kernel's dynamic shared
    memory bytes and resident blocks per SM."""
    out = query(load_library("self_attention", _FWD), "self_attention_info",
                d, int(drop), n_out=3)
    info = {"threads": out[0], "fwd": {"dynamic_smem_bytes": out[1],
                                       "blocks_per_sm": out[2]}}
    out = query(load_library("self_attention_bwd", _BWD),
                "self_attention_bwd_info", d, int(drop), n_out=5)
    info["bwd_rows"] = {"dynamic_smem_bytes": out[1], "blocks_per_sm": out[2]}
    info["bwd_columns"] = {"dynamic_smem_bytes": out[3],
                           "blocks_per_sm": out[4]}
    return info


def _validate(qkv, heads: int):
    """Check what the kernels take; returns (B, T, d)."""
    if qkv.dim() != 3 or heads < 1 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"self_attention: qkv must be (B, T, 3 heads d) "
                         f"with heads={heads}, got {tuple(qkv.shape)}")
    b, t, c3 = qkv.shape
    d = c3 // (3 * heads)
    if not kernel_takes(qkv, d):
        raise ValueError(f"self_attention: the kernels take a CUDA bf16 qkv "
                         f"at head dim {HEAD_DIMS}, got {qkv.dtype} on "
                         f"{qkv.device} at d={d}")
    check_tensor("self_attention", "qkv", qkv, qkv.shape, torch.bfloat16,
                 qkv.device, aligned=True)
    if not (b >= 1 and t >= 1 and b * heads * _tiles(t) < 2 ** 31):
        raise ValueError(f"self_attention: B={b} T={t} heads={heads} do not "
                         "fit the kernels' grid")
    return b, t, d


def _launch_fwd(qkv, u, heads: int, keep: float, for_grad: bool):
    """The forward launch.  Returns (out, lse or None, bits or None); lse
    and bits where `for_grad` (bits where there are uniforms)."""
    b, t, d = _validate(qkv, heads)
    if u is not None:
        check_tensor("self_attention", "u", u, (b, heads, t, t),
                     torch.float32, qkv.device, aligned=True)
    dev = qkv.device
    out = torch.empty((b, t, heads * d), dtype=qkv.dtype, device=dev)
    lse = (torch.empty((b, heads, t), dtype=torch.float32, device=dev)
           if for_grad else None)
    bits = (torch.empty((b, heads, t, 2 * _tiles(t)), dtype=torch.int32,
                        device=dev)
            if for_grad and u is not None else None)
    launch(load_library("self_attention", _FWD), "self_attention_bf16",
           launch_key("self_attention", qkv.dtype), dev, qkv, u, out, lse,
           bits, b, t, heads, d, keep)
    return out, lse, bits


def self_attention_bwd(qkv, g, lse, bits, heads: int, keep: float = 1.0):
    """The backward of the kernel forward for output gradient g (B, T,
    heads d) bf16, given its row logsumexp `lse` and keep mask `bits` (None
    without uniforms), as `_launch_fwd` returns them: dqkv (B, T, 3 heads d)
    bf16.  CUDA only: the plain version's gradient is autograd's."""
    b, t, d = _validate(qkv, heads)
    check_tensor("self_attention", "g", g, (b, t, heads * d), torch.bfloat16,
                 qkv.device, aligned=True)
    check_tensor("self_attention", "lse", lse, (b, heads, t), torch.float32,
                 qkv.device, aligned=True)
    if bits is not None:
        check_tensor("self_attention", "bits", bits,
                     (b, heads, t, 2 * _tiles(t)), torch.int32, qkv.device,
                     aligned=True)
    dqkv = torch.empty_like(qkv)
    dsum = torch.empty_like(lse)
    launch(load_library("self_attention_bwd", _BWD),
           "self_attention_bwd_bf16",
           launch_key("self_attention_bwd", qkv.dtype), qkv.device, qkv, g,
           lse, bits, dqkv, dsum, b, t, heads, d, keep)
    return dqkv


class _SelfAttention(torch.autograd.Function):
    """The forward kernel with the row logsumexp and the keep mask, and the
    backward kernels reading them.  Saves qkv (the in-projection's output,
    held anyway), lse and the mask bits; not the uniforms."""

    @staticmethod
    def forward(ctx, qkv, u, heads: int, keep: float):
        out, lse, bits = _launch_fwd(qkv, u, heads, keep, for_grad=True)
        ctx.heads, ctx.keep = heads, keep
        ctx.save_for_backward(qkv, lse, bits)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, lse, bits = ctx.saved_tensors
        return (self_attention_bwd(qkv, g.contiguous(), lse, bits, ctx.heads,
                                   ctx.keep), None, None, None)


def self_attention(qkv, u: Optional[torch.Tensor], heads: int,
                   keep: float = 1.0):
    """qkv (B, T, 3 heads d), the dropout's uniforms u (B, heads, T, T) f32
    or None, and its keep probability -> (B, T, heads d) in qkv's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels on the current stream or raises."""
    if qkv.device.type == "cpu":
        return self_attention_reference(qkv, u, heads, keep)
    if u is not None and not u.is_contiguous():
        u = u.contiguous()  # one rank's heads of a tensor-parallel draw
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _SelfAttention.apply(qkv, u, heads, keep)
    if u is None:
        return torch.ops.mar_torch.self_attention(qkv, heads)
    return _launch_fwd(qkv, u, heads, keep, for_grad=False)[0]


@torch.library.custom_op("mar_torch::self_attention", mutates_args=(),
                         device_types="cpu")
def _self_attention_op(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    return self_attention_reference(qkv, None, heads)


@_self_attention_op.register_fake
def _(qkv, heads):
    b, t, c3 = qkv.shape
    return qkv.new_empty((b, t, c3 // 3))


@_self_attention_op.register_kernel("cuda")
def _self_attention_cuda(qkv, heads):
    return _launch_fwd(qkv, None, heads, 1.0, for_grad=False)[0]
