"""Score raw clips with a trained multimodal checkpoint (the JAX package's
cli/predict.py).

Decode -> resample/pad -> model -> per-head probabilities, one clip or a
directory:

  python -m multimodalaggressionrecognition_tpu_torch.cli.predict \
      --from_run runs/<run> --path_to_checkpoint runs/<run>/checkpoint_best_verb \
      --audio clip.wav --text clip_embeddings.npy

Accepts .wav (host decode + 16 kHz resample), .pt waveforms, .npy text
embeddings, and .mp4/.npy/.pt video clips (host decode + spatial resize +
frame pad; pass --modalities audio,text,video so the model has the video
tower); missing modalities follow the EMPTY protocol (zero stubs).  Prints
one JSON line per clip.  Runs on CUDA unless --device cpu, in f32 or with
--compute_dtype bfloat16, and with --quantize int8|w8a8 on int8 weights.
`--exported <dir>` scores an artifact of cli/export_model.py instead (no
model class or checkpoint load; clip shapes from its meta): files for every
exported modality are required, and a feature-sequence artifact (`--entry
train_video_rnn`) takes (T, D) video features as .npy/.pt.
"""

import json
import os
from dataclasses import dataclass

import numpy as np

from .common import compute_dtype, parse_config, quantize_mode
from .train_multimodal import MultimodalConfig, build_model


@dataclass
class PredictConfig(MultimodalConfig):
    path_to_checkpoint: str = ""
    exported: str = ""  # an artifact dir of cli/export_model.py
    audio: str = ""     # file or directory of .wav/.pt
    text: str = ""      # file or directory of .npy
    video: str = ""     # file or directory of .mp4/.npy/.pt
    batch_size: int = 8
    quantize: str = ""  # '', 'int8' (weight-only), 'w8a8'


def _gather(path, exts):
    if not path:
        return []
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if os.path.splitext(f)[1] in exts)
    return [path]


def _load_audio(path, target_rate, target_len):
    from ..data.files import _load_pt, _load_wav
    from ..data.transforms import pad_audio

    if path.endswith(".wav"):
        x = _load_wav(path, target_rate)
    else:
        x = _load_pt(path).reshape(-1)
    return pad_audio(target_len)(x)


def _load_video(path, target_frames, target_size):
    """(T, H, W, 3) float32 in [0, 1], resized and frame-padded to the
    model's clip shape, as the training pipeline decodes, resizes and pads
    (data/video_clips.py, data/transforms.py)."""
    from ..data.files import _load_pt
    from ..data.transforms import pad_video
    from ..data.video_clips import read_video_cv2, resize_frames

    if path.endswith(".mp4"):
        x = read_video_cv2(path)
    elif path.endswith(".npy"):
        x = np.load(path)
    else:
        x = _load_pt(path)
    x = np.asarray(x, np.float32)
    if x.ndim == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        # reference-prep .pt clips are saved (T, C, H, W): the transpose the
        # training pipeline applies (data/avabos.py)
        x = x.transpose(0, 2, 3, 1)
    if x.ndim != 4 or x.shape[-1] != 3:
        raise SystemExit(f"{path}: expected a (T, H, W, 3) or (T, 3, H, W) "
                         f"clip, got shape {x.shape}")
    if x.max() > 2.0:  # uint8-range tensor: match decode's [0, 1] scale
        x = x / 255.0
    if x.shape[1:3] != (target_size, target_size):
        x = resize_frames(x, target_size)
    return pad_video(target_frames)(x)


def _load_video_features(path, target_frames, feat_dim):
    """(T, D) precomputed video features, frame-padded or truncated to the
    artifact's sequence length: the input of a feature-sequence artifact
    (export_model --entry train_video_rnn)."""
    from ..data.files import _load_pt
    from ..data.transforms import pad_text

    if not path.endswith((".npy", ".pt")):
        raise SystemExit(
            f"{path}: this artifact takes (T, {feat_dim}) video feature "
            "sequences as .npy/.pt (precomputed extractor output), not raw "
            "video files")
    x = np.load(path) if path.endswith(".npy") else _load_pt(path)
    x = np.asarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] != feat_dim:
        raise SystemExit(
            f"{path}: this artifact takes (T, {feat_dim}) video feature "
            f"sequences (precomputed extractor output), got shape {x.shape}")
    return pad_text(target_frames)(x)


def main(argv=None):
    from ..data.transforms import pad_text
    from ..io.checkpoint import restore_variables
    from ..models.layers import seeded_init_
    from ..serve import Predictor, resolve_device

    cfg = parse_config(PredictConfig, argv)
    device = resolve_device(cfg.device)  # fail before any data or model work
    dtype = compute_dtype(cfg)
    quantize = quantize_mode(cfg)

    exported = None
    audio_len, text_tokens = cfg.audio_samples, cfg.text_tokens
    video_frames, video_size = cfg.video_frames, cfg.video_size
    video_feat_dim = None  # set for (T, D) feature-sequence artifacts
    if cfg.exported:
        from ..io.export import ExportedPredictor

        if cfg.path_to_checkpoint or cfg.quantize:
            raise SystemExit(
                "--exported conflicts with --path_to_checkpoint/--quantize: "
                "the artifact's weights (and any int8 quantization) were "
                "baked in at export time; re-export to change them")
        exported = ExportedPredictor(cfg.exported, device=device)
        # pad/truncate to the artifact's clip shapes, not the flags
        audio_len = exported.clip_shapes.get("audio", (audio_len,))[0]
        text_tokens = exported.clip_shapes.get("text", (text_tokens,))[0]
        vshape = exported.clip_shapes.get("video")
        if vshape is not None and len(vshape) == 2:
            video_frames, video_feat_dim = vshape
        elif vshape is not None:
            video_frames, video_size = vshape[0], vshape[1]

    files = {"audio": _gather(cfg.audio, {".wav", ".pt"}),
             "text": _gather(cfg.text, {".npy"}),
             "video": _gather(cfg.video, {".mp4", ".npy", ".pt"})}
    files = {m: fs for m, fs in files.items() if fs}
    if not files:
        raise SystemExit(
            "nothing to score: pass --audio, --text and/or --video")
    counts = {m: len(fs) for m, fs in files.items()}
    n = max(counts.values())
    if len(set(counts.values())) > 1:
        raise SystemExit(
            f"modalities disagree on file counts: {counts}; paired scoring "
            "needs matching counts (score one modality at a time otherwise)")
    if exported is None:
        configured = set(cfg.modalities.split(","))
        extra = set(files) - configured
        if extra:
            raise SystemExit(
                f"files given for {sorted(extra)} but --modalities is "
                f"{cfg.modalities!r}; pass --modalities "
                f"{','.join(sorted(configured | extra))} so the model has "
                "those towers")
    elif sorted(files) != exported.modalities:
        raise SystemExit(
            f"artifact {cfg.exported!r} has the fixed input signature "
            f"{exported.modalities}; got files for {sorted(files)}: supply "
            "every exported modality, or export a single-modality artifact")

    loaders = {
        "audio": lambda p: _load_audio(p, 16000, audio_len),
        "text": lambda p: pad_text(text_tokens)(
            np.load(p).astype(np.float32)),
        "video": ((lambda p: _load_video_features(p, video_frames,
                                                  video_feat_dim))
                  if video_feat_dim is not None else
                  (lambda p: _load_video(p, video_frames, video_size))),
    }
    request = {m: np.stack([loaders[m](p) for p in fs])
               for m, fs in files.items()}

    if exported is not None:
        predictor = exported
    else:
        model = seeded_init_(
            build_model(cfg, tuple(cfg.modalities.split(","))), cfg.seed)
        state_dict = None
        if cfg.path_to_checkpoint:
            # the weights of a training or an inference checkpoint
            state_dict, _ = restore_variables(cfg.path_to_checkpoint)
        predictor = Predictor(model, state_dict,
                              batch_size=min(cfg.batch_size, max(n, 1)),
                              device=device, compute_dtype=dtype,
                              quantize=quantize)
    names = [os.path.basename(p) for p in next(iter(files.values()))]
    for start in range(0, n, predictor.batch_size):
        chunk = {k: v[start:start + predictor.batch_size]
                 for k, v in request.items()}
        probs = predictor.predict(chunk)
        for i in range(next(iter(chunk.values())).shape[0]):
            row = {"clip": names[start + i]}
            for head, p in probs.items():
                row[f"{head}_prob_aggr"] = round(float(p[i, 1]), 4)
            print(json.dumps(row, ensure_ascii=False))


if __name__ == "__main__":
    main()
