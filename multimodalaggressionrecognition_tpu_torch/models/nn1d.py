"""1-D conv-net building blocks with torch semantics, channels-last layout.

Sequence tensors are (B, L, C), as in the JAX package (models/nn1d.py).
A waveform stem (C_in = 1) with a bias runs through the framed-conv CUDA
kernel (ops/cuda/framed_conv.py), as the JAX package takes its Pallas
kernel only there: for inference with an eval BatchNorm and ReLU folded
into its epilogue, and where a gradient is needed through its autograd
Function with the bias only.  Every other convolution, the bias-free
C_in = 1 conv0 of the wav2vec encoders included, is `F.conv1d`, as the JAX
package leaves those to XLA.

BatchNorm follows torch.nn.BatchNorm1d: in train mode it normalizes with the
biased batch variance and moves the running statistics (momentum 0.1) with
the unbiased one; in eval mode it uses the running statistics.  The dropouts
draw from explicit generators (models/stochastic.py).

Under bf16 compute (utils/precision.py) every layer returns its input's
dtype, as in the JAX package: the kernel's stem runs in f32 with a cast in
and out (its folded BatchNorm scale and shift are f32), BatchNorm and
GroupNorm take their statistics in f32 from the widened input, and the
other convolutions run in the input's dtype with the weights cast to it,
any folded affine applied in f32 before the rounding.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.framed_conv import framed_conv1d, framed_conv1d_trainable
from .stochastic import Stochastic


class Conv1d(nn.Module):
    """Strided 1-D convolution on (B, L, C_in) -> (B, L_out, C_out).

    Weight (C_out, C_in, K) as torch's; the JAX package's frame-major
    (K*C_in, C_out) kernel converts in io/from_jax.py; under w8a8 serving
    it is int8 with a `weight_scale` buffer (`kernel`).  `bias=False` has
    no bias parameter, as the JAX `use_bias=False` has no leaf.  `scale`,
    `shift` and `relu` apply `act(y * scale + shift)` per output channel
    after the bias: fused into the kernel on the stem, plain ops elsewhere.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        bound = (in_channels * kernel_size) ** -0.5
        nn.init.uniform_(self.weight, -bound, bound)

    def kernel(self):
        """The weight; under w8a8 serving (utils/quantize.py) int8 codes
        and their `weight_scale`, dequantized here in f32, as the JAX
        Conv1d does with its int8 kernel."""
        if self.weight.dtype == torch.int8:
            return self.weight.float() * self.weight_scale[:, None, None]
        return self.weight

    def forward(self, x, scale=None, shift=None, relu: bool = False):
        dtype = x.dtype
        weight = self.kernel()
        if x.shape[-1] == 1 and self.bias is not None:
            # (C_out, 1, K) -> (K, C_out): the kernel's (F, C_out) layout; it
            # runs in f32 (cast in and out under bf16, as JAX does)
            w = weight[:, 0, :].t().float().contiguous()
            args = (x[..., 0].float().contiguous(), w, self.bias.float(),
                    self.kernel_size, self.stride, self.padding)
            if not (torch.is_grad_enabled() and (
                    x.requires_grad or weight.requires_grad)):
                return framed_conv1d(
                    *args, scale=None if scale is None else scale.float(),
                    shift=None if shift is None else shift.float(),
                    relu=relu).to(dtype)
            y = framed_conv1d_trainable(*args)
        else:
            y = F.conv1d(x.transpose(1, 2), weight.to(dtype),
                         None if self.bias is None else self.bias.to(dtype),
                         stride=self.stride, padding=self.padding
                         ).transpose(1, 2)
        if scale is not None:
            y = y.float() * scale
        if shift is not None:
            y = y.float() + shift
        y = y.to(dtype)
        return torch.relu(y) if relu else y


class BatchNorm1d(nn.Module):
    """torch BatchNorm1d over the channel (last) axis, eps 1e-5, momentum
    0.1.  With a `data_group` (a data-parallel mesh,
    parallel/sharding_rules.place_params) the batch statistics are the
    GLOBAL batch's, as GSPMD gives them: the count and the per-channel sum,
    then the sum of squared deviations, are all-reduced in f32 with
    autograd, and the running variance moves by the global n's unbiased
    factor.  (`nn.SyncBatchNorm` refuses CPU tensors.)"""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.data_group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def folded_scale_shift(self):
        """(scale, shift) with bn(y) == y * scale + shift in eval mode, f32
        (the running statistics are)."""
        if self.training:
            raise RuntimeError("BatchNorm1d: only the eval mode folds")
        scale = self.weight.float() * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias.float() - self.running_mean * scale

    def forward(self, x):
        dtype, x = x.dtype, x.float()
        weight, bias = self.weight.float(), self.bias.float()
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * weight
            return ((x - self.running_mean) * inv + bias).to(dtype)
        axes = tuple(range(x.dim() - 1))
        if self.data_group is None:
            mean = x.mean(dim=axes)
            var = (x - mean).square().mean(dim=axes)
            n = x.numel() // x.shape[-1]
        else:
            mean, var, n = self._global_moments(x, axes)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            unbiased = (n / (n - 1).clamp(min=1) if torch.is_tensor(n)
                        else n / max(n - 1, 1))
            self.running_var.mul_(1 - m).add_(m * var * unbiased)
        inv = torch.rsqrt(var + self.eps) * weight
        return ((x - mean) * inv + bias).to(dtype)

    def _global_moments(self, x, axes):
        """(mean, biased variance, count) over the data group's batch."""
        from ..parallel.mesh import all_reduce_sum

        count = x.new_full((1,), x.numel() // x.shape[-1])
        total = all_reduce_sum(torch.cat([x.sum(dim=axes), count]),
                               self.data_group)
        n = total[-1].detach()
        mean = total[:-1] / n
        var = all_reduce_sum((x - mean).square().sum(dim=axes),
                             self.data_group) / n
        return mean, var, n


def max_pool1d(x, window: int):
    """torch MaxPool1d(window) on (B, L, C): floor(L / window) outputs."""
    return F.max_pool1d(x.transpose(1, 2), window).transpose(1, 2)


class Dropout1d(Stochastic):
    """Channel dropout on (B, L, C): zeroes whole channels per sample."""

    def noise_shape(self, x):
        return (x.shape[0], 1, x.shape[-1])


class SampleDropout(Stochastic):
    """Drops whole rows of a (B, F) tensor (the reference's Dropout1d after
    Flatten)."""

    def noise_shape(self, x):
        return (x.shape[0], 1)


class GroupNorm(nn.GroupNorm):
    """torch nn.GroupNorm on (B, L, C): normalizes over L and each group of
    C / num_groups channels (one group: wav2vec-1; C groups: wav2vec-2's
    norm0), eps 1e-5.  Under a lower compute dtype the statistics and the
    affine run in f32 and the result takes the input's dtype, as in the
    JAX package's GroupNorm."""

    def forward(self, x):
        y = F.group_norm(x.transpose(1, 2).float(), self.num_groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype).transpose(1, 2)
