"""The card's published peaks and the least time a kernel launch could
take, frozen from `chip_smoke.py` (its `peaks`, `PASSES`, `bound`,
`k1_work`, `k2_work`, `k2_work_bf16`, `k3_work`, `k3_work_bf16` and K4's
byte count), so that later changes to the program cannot move the
yardstick.

A bound is max(products over the tensor cores' peak, bytes over the HBM
bandwidth); f32 x f32 products take three TF32 passes (3xTF32), f32 x bf16
two bf16 passes and bf16 x bf16 one.  Every input byte is counted read once
and every output byte written once."""


def peaks(name: str):
    """{f32 non-tensor, dense TF32 and dense bf16 tensor-core FLOP/s, HBM
    bytes/s} of the card named `name`, from NVIDIA's data sheets (dense
    rates, without sparsity)."""
    if "PCIe" in name:
        return {"fma": 51.2e12, "tf32": 378e12, "bf16": 756.5e12,
                "bw": 2.0e12}
    if "NVL" in name:
        return {"fma": 60.0e12, "tf32": 417.5e12, "bf16": 835.5e12,
                "bw": 3.9e12}
    return {"fma": 67.0e12, "tf32": 495e12, "bf16": 989e12,
            "bw": 3.35e12}  # H100 SXM


PASSES = {"f32*f32": (3, "tf32"), "f32*bf16": (2, "bf16"),
          "bf16*bf16": (1, "bf16")}


def train_peak(name: str, dtype: str) -> float:
    """The FLOP/s a training step in `dtype` is held to: bf16's dense
    tensor-core peak, or for float32 three TF32 passes (PASSES)."""
    p = peaks(name)
    if dtype == "bfloat16":
        return p["bf16"]
    n, kind = PASSES["f32*f32"]
    return p[kind] / n


def bound_s(card: str, flops: float, nbytes: float, products) -> float:
    """The least seconds a launch could take on `card`: the larger of its
    products at their PASSES and its bytes at the HBM bandwidth."""
    p = peaks(card)
    ops = sum(PASSES[kind][0] * f / p[PASSES[kind][1]] for f, kind in products)
    return max(ops, nbytes / p["bw"])


def k1_out_length(length, kernel_size, stride, pad):
    return (length + 2 * pad - kernel_size) // stride + 1


def k1_work(b, length, f, hop, pad, c):
    """(operations, bytes, products) of one K1 launch: 2*B*T*F*C; x, w,
    bias, scale and shift read once, y written once (f32)."""
    t = k1_out_length(length, f, hop, pad)
    flops = 2 * b * t * f * c
    return (flops, 4 * (b * length + f * c + 3 * c + b * t * c),
            [(flops, "f32*f32")])


def k2_work(w, n, heads, d, nw, lse=False):
    """(operations, bytes, products) of one f32 K2 launch: two N x N x d
    products per window and head; qkv, bias and mask read once, the output
    (and with `lse` the rows' logsumexp) written once."""
    c = heads * d
    flops = 4 * w * heads * n * n * d
    return (flops,
            4 * (w * n * 3 * c + heads * n * n + nw * n * n + w * n * c
                 + (w * heads * n if lse else 0)),
            [(flops, "f32*f32")])


def k2_work_bf16(w, n, heads, d, nw, lse=False):
    """k2_work with qkv and the output in bf16 (bias, mask and lse f32):
    Q.K^T is bf16*bf16, P.V (P the f32 probabilities) f32*bf16."""
    c = heads * d
    one = 2 * w * heads * n * n * d
    return (2 * one,
            2 * (w * n * 3 * c + w * n * c) + 4 * (heads * n * n + nw * n * n)
            + (4 * w * heads * n if lse else 0),
            [(one, "bf16*bf16"), (one, "f32*bf16")])


def k3_work(w, n, heads, d, nw):
    """(operations, bytes, products) of one f32 K3 launch: five N x N x d
    products per window and head; qkv, g, bias, mask, K2's output and lse
    read once, dqkv and dbias written once."""
    c = heads * d
    flops = 10 * w * heads * n * n * d
    return (flops,
            4 * (2 * w * n * 3 * c + 2 * heads * n * n + nw * n * n
                 + w * n * c + w * n * c + w * heads * n),
            [(flops, "f32*f32")])


def k3_work_bf16(w, n, heads, d, nw):
    """k3_work with qkv, g and dqkv in bf16 (bias, mask, dbias and K2's lse
    f32; K2's output not read): Q.K^T and g.V^T bf16*bf16; P^T.g, dS.K and
    dS^T.Q f32*bf16."""
    c = heads * d
    one = 2 * w * heads * n * n * d
    return (5 * one,
            2 * (2 * w * n * 3 * c + w * n * c)
            + 4 * (2 * heads * n * n + nw * n * n + w * heads * n),
            [(2 * one, "bf16*bf16"), (3 * one, "f32*bf16")])


def k4_work(b, t, h, w, c, elem_bytes):
    """(operations, bytes, products) of one K4 roll: x read and the output
    written once."""
    return 0, 2 * b * t * h * w * c * elem_bytes, []
