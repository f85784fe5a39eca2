"""Convert a reference PyTorch checkpoint into a port checkpoint (the JAX
package's cli/import_torch_checkpoint.py).

Reads a torch .pt/.pth state_dict (bare, or inside a `state_dict` /
`model` / `model_state_dict` entry), applies the matching io/torch_import
converter, and writes a port inference checkpoint (io/checkpoint.py) that
loads with `strict=True` into the port module:

  python -m multimodalaggressionrecognition_tpu_torch.cli.import_torch_checkpoint \
      --model cnn1d --torch_path model.pt --out_dir converted/cnn1d

Models: cnn1d | audio_cnn1d_wrapper | r3d18 | vgg11_bn | swin3d_t | s3d |
wav2vec2 | wav2vec2_hf (+ --num_layers/--extractor_mode for the wav2vec
variants).  As the trainer's checkpoints (directories in the JAX
package) are single files in the port, the checkpoint is written to the
path `--out_dir` itself: pass that path to `io.checkpoint.
restore_variables` or a CLI's `--path_to_checkpoint`.
"""

import argparse


def load_state_dict(path: str):
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    return obj


def convert(model: str, sd, num_layers=12, extractor_mode="group_norm"):
    from ..io import torch_import as ti

    simple = {"cnn1d": ti.cnn1d, "audio_cnn1d_wrapper": ti.audio_cnn1d_wrapper,
              "r3d18": ti.r3d18, "vgg11_bn": ti.vgg11_bn,
              "swin3d_t": ti.swin3d_t, "s3d": ti.s3d}
    if model in simple:
        return simple[model](sd)
    if model in ("wav2vec2", "wav2vec2_hf"):
        return getattr(ti, model)(sd, num_layers=num_layers,
                                  extractor_mode=extractor_mode)
    raise ValueError(f"unknown model {model!r}")


def main(argv=None):
    from ..io.checkpoint import save_variables

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True)
    p.add_argument("--torch_path", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--extractor_mode", default="group_norm")
    args = p.parse_args(argv)

    sd = load_state_dict(args.torch_path)
    state_dict = convert(args.model, sd, args.num_layers, args.extractor_mode)
    save_variables(args.out_dir, state_dict,
                   {"model": args.model, "source": args.torch_path})
    n = sum(v.numel() for v in state_dict.values())
    print(f"converted {args.model}: {n:,} params -> {args.out_dir}")
    return args.out_dir


if __name__ == "__main__":
    main()
