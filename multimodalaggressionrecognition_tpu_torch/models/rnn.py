"""GRU and LSTM sequence layers (the JAX package's models/rnn.py).

One layer, batch first, zero initial state: torch's `nn.GRU` / `nn.LSTM`,
whose gate order (GRU r, z, n; LSTM i, f, g, o) and GRU candidate
`n = tanh(W_in x + b_in + r * (W_hn h + b_hn))` are the JAX modules' too.
The JAX package leaves the recurrence to `lax.scan`, not to a hand kernel,
so on the card this is cuDNN's RNN.  The JAX kernels (E or H, 3H or 4H)
are torch's `weight_ih_l0` / `weight_hh_l0` transposed (io/from_jax.py).

Under bf16 compute the JAX layers project with f32 products and run the
recurrence in f32 on the bf16-rounded weights, returning f32 whatever
their input's dtype.  So do these: a bf16 input or bf16 weights are
widened, the weights into one f32 buffer laid out as cuDNN's flat weight
buffer (`_widened`), so cuDNN takes them without compacting them again.
"""

import torch
from torch import _VF, nn


def _widened(rnn):
    """The RNN's weights as f32 views into one new buffer, in the order
    and layout `flatten_parameters` gives one layer without projections
    (w_ih, w_hh, b_ih, b_hh, each contiguous, back to back).  The cast is
    differentiable, so gradients reach the weights it was made from."""
    weights = rnn._flat_weights
    flat = torch.cat([w.reshape(-1) for w in weights]).float()
    out, offset = [], 0
    for w in weights:
        out.append(flat[offset:offset + w.numel()].view(w.shape))
        offset += w.numel()
    return out


def _all_f32(rnn, x):
    # the weights a functional_call (a bf16 step) substituted, not the
    # module's own
    rnn._update_flat_weights()
    return x.dtype == torch.float32 and all(
        w.dtype == torch.float32 for w in rnn._flat_weights)


class GRU(nn.GRU):
    """x (B, T, E) -> (outputs (B, T, H), final hidden (B, H)), f32 under
    a lower compute dtype."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)

    def forward(self, x):
        if _all_f32(self, x):
            out, h = super().forward(x)
        else:
            h0 = x.new_zeros((1, x.shape[0], self.hidden_size),
                             dtype=torch.float32)
            out, h = _VF.gru(x.float(), h0, _widened(self), True, 1, 0.0,
                             self.training, False, True)
        return out, h[0]


class LSTM(nn.LSTM):
    """x (B, T, E) -> (outputs (B, T, H), (h_T (B, H), c_T (B, H))), f32
    under a lower compute dtype."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)

    def forward(self, x):
        if _all_f32(self, x):
            out, (h, c) = super().forward(x)
        else:
            h0 = x.new_zeros((1, x.shape[0], self.hidden_size),
                             dtype=torch.float32)
            out, h, c = _VF.lstm(x.float(), (h0, h0), _widened(self), True,
                                 1, 0.0, self.training, False, True)
        return out, (h[0], c[0])
