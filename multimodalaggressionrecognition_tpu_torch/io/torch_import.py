"""Reference / torchvision / torchaudio / HF state_dicts -> port state_dicts.

The port's copy of the JAX package's io/torch_import.py: the same numpy
layout rules build the JAX variables tree of each model, and
io/from_jax.from_jax_variables turns that tree into the port's names, so
one set of name rules serves both bridges.  Each converter returns a
state_dict that loads with `strict=True` into the port module of the same
architecture (CNN1D, AudioCnn1DExtractorWrapper, R3D18Classifier, VGG11BN,
SwinTransformer3d, S3DClassifier, Wav2Vec2Model).

Input: a state_dict of torch tensors or numpy arrays.  A key that no rule
reads raises, except the buffers the port recomputes or never reads
(`num_batches_tracked`, Swin's `relative_position_index`) and what a
converter drops by design (swin3d_t: torchvision's `head.` classifier, the
backbone being headless; wav2vec2_hf: `masked_spec_embed`, a training-time
mask embedding).

Layout rules (torch -> the JAX tree):
- Linear:  kernel = weight.T                        (in, out)
- Conv1d:  kernel = weight.transpose(2, 1, 0).reshape(K*C_in, C_out)
- Conv2d:  kernel = weight.transpose(2, 3, 1, 0)    (H, W, C_in, C_out)
- Conv3d:  kernel = weight.transpose(2, 3, 4, 1, 0) (D, H, W, C_in, C_out)
- MHA:     in_proj_kernel = in_proj_weight.T (torchaudio's separate q/k/v
           projections packed), out_proj_kernel = out_proj.weight.T
- Norms:   scale = weight, bias = bias; BN running stats -> batch_stats
- weight_norm convs: w = g * v / ||v||_(0,1)
"""

from collections.abc import Mapping

import numpy as np

from .from_jax import from_jax_variables

_IGNORED = ("num_batches_tracked", "relative_position_index")


class _Reads(Mapping):
    """A state_dict that records which keys a rule read."""

    def __init__(self, sd):
        self._sd = sd
        self.read = set()

    def __getitem__(self, key):
        value = self._sd[key]
        self.read.add(key)
        return value

    def __contains__(self, key):  # a membership test is not a read
        return key in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)


def _port(sd, build, *args, dropped=(), names=None):
    """Run the JAX-tree rule `build` over `sd`, raise on any key it left
    unread, and convert the tree to port names.  `names` maps a renamed
    key back to the caller's for the error message."""
    reads = _Reads(sd)
    variables = build(reads, *args)
    left = sorted(k for k in sd if k not in reads.read
                  and not k.endswith(_IGNORED) and not k.startswith(dropped))
    if left:
        shown = [names.get(k, k) if names else k for k in left]
        raise ValueError(f"{len(left)} torch keys no rule consumes: "
                         f"{shown[:8]}{' ...' if len(left) > 8 else ''}")
    return from_jax_variables(variables)


def _t(x):
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def linear(sd, prefix):
    p = {"kernel": _t(sd[prefix + "weight"]).T}
    if prefix + "bias" in sd:
        p["bias"] = _t(sd[prefix + "bias"])
    return p


def conv1d(sd, prefix):
    w = _t(sd[prefix + "weight"])  # (C_out, C_in, K)
    p = {"kernel": w.transpose(2, 1, 0).reshape(-1, w.shape[0])}
    if prefix + "bias" in sd:
        p["bias"] = _t(sd[prefix + "bias"])
    return p


def conv2d(sd, prefix):
    w = _t(sd[prefix + "weight"])  # (C_out, C_in, H, W)
    p = {"kernel": w.transpose(2, 3, 1, 0)}
    if prefix + "bias" in sd:
        p["bias"] = _t(sd[prefix + "bias"])
    return p


def conv3d(sd, prefix):
    w = _t(sd[prefix + "weight"])  # (C_out, C_in, D, H, W)
    p = {"kernel": w.transpose(2, 3, 4, 1, 0)}
    if prefix + "bias" in sd:
        p["bias"] = _t(sd[prefix + "bias"])
    return p


def norm(sd, prefix):
    """LayerNorm / GroupNorm / BN affine params."""
    return {"scale": _t(sd[prefix + "weight"]),
            "bias": _t(sd[prefix + "bias"])}


def bn_stats(sd, prefix):
    return {"mean": _t(sd[prefix + "running_mean"]),
            "var": _t(sd[prefix + "running_var"])}


def _sequential_conv_bn_indices(sd, prefix):
    """Conv and BN module indices inside a torch Sequential's state_dict."""
    conv_idx, bn_idx = [], []
    seen = set()
    for key in sd:
        if not key.startswith(prefix):
            continue
        idx = int(key[len(prefix):].split(".")[0])
        if idx in seen:
            continue
        seen.add(idx)
        if f"{prefix}{idx}.running_mean" in sd:
            bn_idx.append(idx)
        elif f"{prefix}{idx}.weight" in sd:
            conv_idx.append(idx)
    return sorted(conv_idx), sorted(bn_idx)


def _cnn1d_extractor(sd, prefix="extractor."):
    """The reference CNN1D's conv trunk (a torch Sequential)."""
    conv_idx, bn_idx = _sequential_conv_bn_indices(sd, prefix)
    params, stats = {}, {}
    for j, (ci, bi) in enumerate(zip(conv_idx, bn_idx)):
        params[f"conv{j}"] = conv1d(sd, f"{prefix}{ci}.")
        params[f"bn{j}"] = norm(sd, f"{prefix}{bi}.")
        stats[f"bn{j}"] = bn_stats(sd, f"{prefix}{bi}.")
    return params, stats


def _cnn1d(sd):
    ext_params, ext_stats = _cnn1d_extractor(sd, "extractor.")
    return {"params": {"extractor": ext_params,
                       "head": linear(sd, "classifier.3.")},
            "batch_stats": {"extractor": ext_stats}}


def cnn1d(sd):
    """The reference CNN1D (extractor Sequential + classifier Sequential)
    -> port `CNN1D`."""
    return _port(sd, _cnn1d)


def _audio_cnn1d_wrapper(sd):
    ext_params, ext_stats = _cnn1d_extractor(sd, "extractor.")
    return {"params": {"extractor": ext_params,
                       "adaptor": linear(sd, "adaptor.0.")},
            "batch_stats": {"extractor": ext_stats}}


def audio_cnn1d_wrapper(sd):
    """The reference AudioCnn1DExtractorWrapper -> port
    `AudioCnn1DExtractorWrapper`."""
    return _port(sd, _audio_cnn1d_wrapper)


def _basic_block3d(sd, prefix):
    """torchvision video BasicBlock: conv1/conv2 are Sequential(conv, bn[, relu])."""
    params = {"conv1": conv3d(sd, prefix + "conv1.0."),
              "bn1": norm(sd, prefix + "conv1.1."),
              "conv2": conv3d(sd, prefix + "conv2.0."),
              "bn2": norm(sd, prefix + "conv2.1.")}
    stats = {"bn1": bn_stats(sd, prefix + "conv1.1."),
             "bn2": bn_stats(sd, prefix + "conv2.1.")}
    if prefix + "downsample.0.weight" in sd:
        params["downsample_conv"] = conv3d(sd, prefix + "downsample.0.")
        params["downsample_bn"] = norm(sd, prefix + "downsample.1.")
        stats["downsample_bn"] = bn_stats(sd, prefix + "downsample.1.")
    return params, stats


def _r3d18(sd):
    params = {"stem": {"conv": conv3d(sd, "stem.0."),
                       "bn": norm(sd, "stem.1.")}}
    stats = {"stem": {"bn": bn_stats(sd, "stem.1.")}}
    for layer in range(1, 5):
        for block in range(2):
            p, s = _basic_block3d(sd, f"layer{layer}.{block}.")
            params[f"layer{layer}_{block}"] = p
            stats[f"layer{layer}_{block}"] = s
    return {"params": {"trunk": params, "fc": linear(sd, "fc.")},
            "batch_stats": {"trunk": stats}}


def r3d18(sd):
    """torchvision r3d_18 (with its classifier `fc`) -> port
    `R3D18Classifier`."""
    return _port(sd, _r3d18)


def _packed_qkv(sd, prefix):
    """torchaudio wav2vec2's separate q/k/v projections -> packed in_proj."""
    q_w, k_w, v_w = (_t(sd[prefix + f"{n}_proj.weight"]) for n in "qkv")
    q_b, k_b, v_b = (_t(sd[prefix + f"{n}_proj.bias"]) for n in "qkv")
    return {
        "in_proj_kernel": np.concatenate([q_w, k_w, v_w], axis=0).T,
        "in_proj_bias": np.concatenate([q_b, k_b, v_b]),
        "out_proj_kernel": _t(sd[prefix + "out_proj.weight"]).T,
        "out_proj_bias": _t(sd[prefix + "out_proj.bias"]),
    }


def _weight_norm_conv1d(sd, prefix):
    """torch weight_norm (dim=2): w = g * v / ||v||_(0,1), from the legacy
    `weight_g`/`weight_v` names or the parametrize-based
    `parametrizations.weight.original{0,1}` ones (newer torch, HF)."""
    if prefix + "weight_g" in sd:
        g = _t(sd[prefix + "weight_g"])  # (1, 1, K)
        v = _t(sd[prefix + "weight_v"])  # (C_out, C_in/groups, K)
    else:
        g = _t(sd[prefix + "parametrizations.weight.original0"])
        v = _t(sd[prefix + "parametrizations.weight.original1"])
    vnorm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(vnorm, 1e-12)
    return {"kernel": w.transpose(2, 1, 0), "bias": _t(sd[prefix + "bias"])}


def _wav2vec2(sd, num_layers, extractor_layers, extractor_mode):
    fe = {}
    for i in range(extractor_layers):
        p = f"feature_extractor.conv_layers.{i}."
        fe[f"conv{i}"] = conv1d(sd, p + "conv.")
        if extractor_mode == "layer_norm" or i == 0:
            fe[f"norm{i}"] = norm(sd, p + "layer_norm.")
    params = {
        "feature_extractor": fe,
        "fp_norm": norm(sd, "encoder.feature_projection.layer_norm."),
        "fp_proj": linear(sd, "encoder.feature_projection.projection."),
        "pos_conv": _weight_norm_conv1d(
            sd, "encoder.transformer.pos_conv_embed.conv."),
        "encoder_norm": norm(sd, "encoder.transformer.layer_norm."),
    }
    for i in range(num_layers):
        p = f"encoder.transformer.layers.{i}."
        params[f"layers_{i}"] = {
            "self_attn": _packed_qkv(sd, p + "attention."),
            "norm1": norm(sd, p + "layer_norm."),
            "linear1": linear(sd, p + "feed_forward.intermediate_dense."),
            "linear2": linear(sd, p + "feed_forward.output_dense."),
            "norm2": norm(sd, p + "final_layer_norm."),
        }
    return {"params": params}


def wav2vec2(sd, num_layers=12, extractor_layers=7,
             extractor_mode="group_norm"):
    """torchaudio Wav2Vec2Model / HuBERT -> port `Wav2Vec2Model`.

    torchaudio layout: feature_extractor.conv_layers.{i}.{conv,layer_norm},
    encoder.feature_projection.{layer_norm,projection},
    encoder.transformer.{pos_conv_embed.conv, layer_norm, layers.{i}.
    {attention, layer_norm, feed_forward.{intermediate_dense,output_dense},
    final_layer_norm}}.  Every layer of the checkpoint must be converted:
    `num_layers` below the checkpoint's depth raises on the rest."""
    return _port(sd, _wav2vec2, num_layers, extractor_layers, extractor_mode)


_HF_RENAMES = (
    ("feature_projection.", "encoder.feature_projection."),
    ("encoder.pos_conv_embed.", "encoder.transformer.pos_conv_embed."),
    ("encoder.layer_norm.", "encoder.transformer.layer_norm."),
    ("encoder.layers.", "encoder.transformer.layers."),
)


def wav2vec2_hf(sd, num_layers=12, extractor_layers=7,
                extractor_mode="group_norm"):
    """HF `transformers` Wav2Vec2Model / HubertModel -> port
    `Wav2Vec2Model`: the same graph under other names (no
    `encoder.transformer.` nesting, `feature_projection` at the top), so
    the keys are renamed into torchaudio's and converted as `wav2vec2`."""
    out, names = {}, {}
    for k, v in sd.items():
        new = k
        for old, repl in _HF_RENAMES:
            if k.startswith(old):
                new = repl + k[len(old):]
                break
        out[new], names[new] = v, k
    return _port(out, _wav2vec2, num_layers, extractor_layers, extractor_mode,
                 dropped=("masked_spec_embed",), names=names)


def _swin_block(sd, prefix):
    return {
        "norm1": norm(sd, prefix + "norm1."),
        "norm2": norm(sd, prefix + "norm2."),
        "attn": {
            "qkv": linear(sd, prefix + "attn.qkv."),
            "proj": linear(sd, prefix + "attn.proj."),
            "relative_position_bias_table": _t(
                sd[prefix + "attn.relative_position_bias_table"]),
        },
        "mlp_fc1": linear(sd, prefix + "mlp.0."),
        "mlp_fc2": linear(sd, prefix + "mlp.3."),
    }


def _swin3d_t(sd, depths):
    params = {"patch_embed": conv3d(sd, "patch_embed.proj."),
              "patch_norm": norm(sd, "patch_embed.norm.")}
    feat_idx = 0
    for stage, depth in enumerate(depths):
        for i in range(depth):
            params[f"stage{stage}_block{i}"] = _swin_block(
                sd, f"features.{feat_idx}.{i}.")
        feat_idx += 1
        if stage < len(depths) - 1:
            params[f"merge{stage}"] = {
                "norm": norm(sd, f"features.{feat_idx}.norm."),
                "reduction": linear(sd, f"features.{feat_idx}.reduction."),
            }
            feat_idx += 1
    params["norm"] = norm(sd, "norm.")
    return {"params": params}


def swin3d_t(sd, depths=(2, 2, 6, 2)):
    """torchvision swin3d_t -> port `SwinTransformer3d` (headless: the
    Kinetics classifier `head.` is dropped).

    torchvision layout: patch_embed.proj/norm; features = Sequential
    [stage0, PatchMerging, stage1, PatchMerging, stage2, PatchMerging,
    stage3]; final norm."""
    return _port(sd, _swin3d_t, depths, dropped=("head.",))


def _conv_bn_act(sd, prefix):
    """torchvision Conv3dNormActivation (Sequential conv, bn, relu)."""
    return ({"conv": conv3d(sd, prefix + "0."), "bn": norm(sd, prefix + "1.")},
            {"bn": bn_stats(sd, prefix + "1.")})


def _temp_sep_conv(sd, prefix):
    sp, ss = _conv_bn_act(sd, prefix + "0.")
    tp, ts = _conv_bn_act(sd, prefix + "1.")
    return {"spatial": sp, "temporal": tp}, {"spatial": ss, "temporal": ts}


def _s3d_features(sd, prefix="features."):
    """torchvision S3D `features` Sequential: 0 TempSep stem, 1 pool, 2
    ConvBN, 3 TempSep, 4 pool, then inception blocks at 5, 6, 8-12, 14, 15
    (pools at 7, 13)."""
    params, stats = {}, {}
    params["stem0"], stats["stem0"] = _temp_sep_conv(sd, prefix + "0.")
    params["stem1"], stats["stem1"] = _conv_bn_act(sd, prefix + "2.")
    params["stem2"], stats["stem2"] = _temp_sep_conv(sd, prefix + "3.")
    for j, si in enumerate([5, 6, 8, 9, 10, 11, 12, 14, 15]):
        p, s = {}, {}
        base = f"{prefix}{si}.branch"
        p["branch0"], s["branch0"] = _conv_bn_act(sd, base + "0.")
        p["branch1_0"], s["branch1_0"] = _conv_bn_act(sd, base + "1.0.")
        p["branch1_1"], s["branch1_1"] = _temp_sep_conv(sd, base + "1.1.")
        p["branch2_0"], s["branch2_0"] = _conv_bn_act(sd, base + "2.0.")
        p["branch2_1"], s["branch2_1"] = _temp_sep_conv(sd, base + "2.1.")
        p["branch3_1"], s["branch3_1"] = _conv_bn_act(sd, base + "3.1.")
        params[f"inception{j}"] = p
        stats[f"inception{j}"] = s
    return params, stats


def _s3d(sd):
    feats, stats = _s3d_features(sd)
    return {"params": {"features": feats, "head": conv3d(sd, "classifier.1.")},
            "batch_stats": {"features": stats}}


def s3d(sd):
    """torchvision S3D -> port `S3DClassifier`."""
    return _port(sd, _s3d)


def _vgg11_bn(sd):
    conv_idx, bn_idx = _sequential_conv_bn_indices(sd, "features.")
    params, stats = {}, {}
    for j, (ci, bi) in enumerate(zip(conv_idx, bn_idx)):
        params[f"conv{j}"] = conv2d(sd, f"features.{ci}.")
        params[f"bn{j}"] = norm(sd, f"features.{bi}.")
        stats[f"bn{j}"] = bn_stats(sd, f"features.{bi}.")
    params["fc1"] = linear(sd, "classifier.0.")
    params["fc2"] = linear(sd, "classifier.3.")
    params["fc3"] = linear(sd, "classifier.6.")
    return {"params": params, "batch_stats": stats}


def vgg11_bn(sd):
    """torchvision vgg11_bn -> port `VGG11BN`."""
    return _port(sd, _vgg11_bn)
