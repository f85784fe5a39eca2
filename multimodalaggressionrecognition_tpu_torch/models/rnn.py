"""GRU and LSTM sequence layers (the JAX package's models/rnn.py).

One layer, batch first, zero initial state: torch's `nn.GRU` / `nn.LSTM`,
whose gate order (GRU r, z, n; LSTM i, f, g, o) and GRU candidate
`n = tanh(W_in x + b_in + r * (W_hn h + b_hn))` are the JAX modules' too.
The JAX package leaves the recurrence to `lax.scan`, not to a hand kernel,
so on the card this is cuDNN's RNN.  The JAX kernels (E or H, 3H or 4H)
are torch's `weight_ih_l0` / `weight_hh_l0` transposed (io/from_jax.py).
"""

from torch import nn


class GRU(nn.GRU):
    """x (B, T, E) -> (outputs (B, T, H), final hidden (B, H))."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)

    def forward(self, x):
        out, h = super().forward(x)
        return out, h[0]


class LSTM(nn.LSTM):
    """x (B, T, E) -> (outputs (B, T, H), (h_T (B, H), c_T (B, H)))."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)

    def forward(self, x):
        out, (h, c) = super().forward(x)
        return out, (h[0], c[0])
