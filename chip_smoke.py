#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (multimodalaggressionrecognition_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. device   - the card's name, `nvidia-smi` name and power limit, versions;
                TF32 off for matmuls and cuDNN, so every f32 comparison below
                means f32.
  2. build    - nvcc for sm_90a of every kernel source, all started together;
                each kernel's registers, spills and static shared memory (from
                ptxas), K1's launch for each of its two frame tiles (threads,
                dynamic shared memory, resident blocks per SM) and their SASS
                instruction mix (cuobjdump), and K2's and K3's launch at
                stage 0; their bf16 kernels' launches (K2 also at N = 392)
                from their own occupancy, and the HMMA variants of every
                K2 and K3 kernel (the bf16 ones bf16 and no TF32).
  3. kernels  - each kernel against its plain PyTorch version on the card:
                K1 (framed conv1d) at the JAX tests' shapes, its three routes
                at full size (CNN1D stem at the served b32, the trained
                b8, the audio,text trainer's b16 with and without its
                epilogue and the audio RNN trainer's b16 on 10 s clips with
                it, STFT at b32 and at the trained b16, 44.1 -> 16 kHz
                resample) and ragged edges (C=1, T < 128, F < 8, hops 3, 7
                and 12, T=1), atol/rtol 1e-4, and bit for bit over two
                launches at the stem; the device resample_poly (K1's
                resample route) on 32 clips of 220 500 samples against the
                CPU, 1e-4; K2 (window attention) at
                tests/test_pallas.py's shapes, 1e-5 as there, and at ragged
                edge shapes (N in {1, 17, 392} x d in {8, 16, 32}, masked and
                not) and the four Swin3D-T stage shapes of the tri-modal b8
                forward, masked and unmasked, 1e-4 (longer f32 sums); K3
                (window-attention backward, dqkv and dbias) at
                tests/test_pallas.py's gradient shapes, 1e-4, and at the edge
                and stage shapes, 1e-4 of the largest gradient; K3 twice on
                the same inputs, bit for bit.  At the main path's shape (K1:
                the stem at b32 and b8, and the STFT's; K2, K3: stage 0's
                shifted block; K1 also the STFT's at b32 and b16 and the
                stem's at b16 x 160 000 with its epilogue) also the
                kernel's, the plain version's and one library
                call's time (K1: F.conv1d, with the inputs evicted from L2
                before each call, and warm from CUDA graphs, as one call is
                shorter than Python's dispatch; K3: SDPA's backward) and the
                least time the card could take (on the
                tensor cores in 3xTF32, with the f32 FMA pipe's bound beside
                it); K2's and K3's time at every stage.  K4 (the Swin
                tower's shifted-window roll) bit for bit against torch.roll
                at the tower's two shifted stages of the b8 forward, both
                signs, and at ragged shapes (C = 3 and 5 on the scalar
                path, odd H and W, a T shift, shift 0 on one axis, B = 1, a
                misaligned view), twice bit for bit, its autograd backward
                against the opposite roll; its time cold and warm at both
                stages against its bound (bytes) and torch.roll.  K2 and K4
                also at the shapes of the extraction forward
                (extract_features --backbone swin3d_t, b4 x 304 frames, 76
                16-frame windows, the full (8, 7, 7) window): K2 at every
                stage (stage 0: W = 1216, N = 392, its real mask), 1e-4,
                with stage 0's times cold and warm, plain and SDPA, against
                its bound, and its launch (threads, shared memory, blocks
                per SM) at N = 392; K4 at (76, 8, 28, 28, 96) and
                (76, 8, 14, 14, 192), both signs, bit for bit, cold and
                warm against its bound and torch.roll.  In bf16 (the
                main path's bf16 shapes: K2 and K3 at stage 0's shifted
                block, K4 at stage 0): K2 and K3 within 1e-2 of their plain
                versions' largest output and element by element within one
                bf16 ulp + 3e-5 (a plain version with p rounded to bf16
                fails that), and in f32 on the same inputs within 1e-3, K4
                bit for bit; K2 cold with and without the mask; each kernel's, plain version's and
                library call's (SDPA, its backward, torch.roll, in bf16)
                time cold and warm against the bound with bf16 bytes.  The
                self-attention pair (no Pallas counterpart; XLS-R's layer):
                output and dqkv element by element within one bf16 ulp +
                3e-5 of the plain version in f32 at B 2, the keep bits
                `u < keep`, the backward twice bit for bit; at B 32 each
                kernel cold and warm against its bound, one layer's draw,
                forward and backward against the plain composition's.  The
                Swin's patch embedding as one patch GEMM (no Pallas
                counterpart; the tri-modal cells' b32 clips, f32 and bf16):
                output, dW and db against an f64 product and F.conv3d's, dX
                at b2 against the conv's; forward and backward cold and
                warm against their bound and F.conv3d's with cuDNN's
                backward of it.
  4. slices   - each served model at full width with seeded random weights:
                audio,text (hidden 768, 80 000 samples, 48 tokens, 1 fusion
                layer, 8 heads, batch 32), then audio,text,video (+ the frozen
                Swin3D-T tower on 128 frames at 112 px in 8-frame windows,
                batch 8):
                (a) logits and tower features on the card against the same
                    model on the CPU, 1e-3 (tri-modal at batch 2);
                (b) the HTTP server (cli/serve.build_server) answering a short
                    JSON clip, an npz batch larger than the batch size and 4
                    concurrent npz clips, with the kernels' launch counts
                    reset just before and read just after: every kernel of the
                    path launched its count per served forward (K1 once, K2
                    12 times, K4 4 times), no other kernel;
                (c) throughput of Predictor.predict at the served batch, the
                    forward's time by tower, its kernel time by family, and
                    MicroBatcher single-clip p50 latency;
                (d) the tri-modal Predictor with compute_dtype bfloat16 at
                    b8: K1 1, K2 12, K4 4 launches a forward, probabilities
                    within 0.03 of the f32 Predictor's, both forwards' ms.
  5. train    - the tri-modal model fine-tuned (Swin unfrozen, remat on):
                (a) loss and every gradient of the full-width model at b1
                    with 16 frames, eval mode, on the card against the CPU,
                    each within 1e-3 times that tensor's largest gradient;
                (b) cli.train_multimodal.main at full width, batch 8, 2
                    epochs on a synthetic set, launch counts reset just
                    before and read just after: finite logged losses, the
                    logs and checkpoints; then one step of each presence
                    pattern with its launches (video: K2 24, K3 12, K4 12;
                    audio: K1 1; a verb batch: no K2, no K3, no K4);
                (c) the median b8 step time with remat on and off, the peak
                    memory, the step's kernel time by family;
                (d) cli.evaluate.main --from_run of that run's
                    checkpoint_best_phys on the card, launch counts reset
                    just before and read just after (K1 once per test batch
                    with audio, K2 12 and K4 4 times per batch with video):
                    each head's accuracy, UAR, UAP and UAF1 equal to the
                    trainer's logged test row of that epoch and the loss
                    within 1e-4; the same call with --device cpu, metrics
                    equal and loss within 1e-3; clips/s on the host clock;
                (e) cli.predict.main --from_run on 8 raw clips at b8 (5 s
                    wavs at 44.1 kHz, (20, 768) text .npy, (128, 144, 144,
                    3) uint8 frames resized to 112): K1 1, K2 12, K4 4;
                    every probability within 1e-3 of the same CLI with
                    --device cpu; host-clock seconds;
                (f) the same fine-tune with --compute_dtype bfloat16, 2
                    epochs: K1 1, K2 24, K3 12, K4 12 launches a tri-modal
                    step, its step time and peak memory with remat on and
                    off beside f32's, its kernel families, one bf16 step
                    within 5 % of one f32 step's loss on the same weights,
                    master parameters, optimizer state and BatchNorm
                    statistics f32;
                (g) the audio,text flagship trainer at b32, 2 epochs, with
                    a cosine schedule, warmup, clipping, AdamW, accumulation
                    over 2, an EMA, early stopping, TensorBoard and the
                    profiler: K1 once a micro-step, the trace and the
                    scalars (or the one warning), the step time; the same
                    run preempted by guard.request() mid-epoch 1 and
                    resumed from checkpoint_preempt, its logged losses within
                    1e-4 relative of the uninterrupted run's.
  6. audio_vgg - the spectrogram VGG11-BN trained at full width (5 s at 16
                kHz, n_fft 512: 257 x 313 spectrograms, masks 80/80):
                (a) SpectrogramVGG at b2, eval mode, card against CPU: the
                    spectrogram within 1e-4 of its largest value, the
                    logits and the loss within 1e-3; every gradient of
                    each within 1e-3 of that tensor's largest of a float64
                    CPU run that takes the same ReLU and max-pool decisions
                    (one flipped near tie moves a gradient by more, so the
                    card's and the CPU's are reported side by side);
                (b) cli.train_audio_transformer.main, batch 16, 2 epochs on
                    64 + 16 synthetic tone clips, launch counts reset just
                    before and read just after: K1 once per train and eval
                    step, no other kernel; the logs and checkpoints;
                (c) the median b16 step time, the peak memory, the step's
                    kernel time by family, and K1's time in the step beside
                    its cold and warm times and right after a cuDNN conv.
  7. text     - the text transformer trained at full width (hidden 768, 2
                layers, 8 heads, 48 tokens): logits at b2 on the card
                against the CPU, 1e-3; cli.train_text_transformer.main,
                batch 16, 2 epochs on a synthetic AVABOS table, no kernel
                launched; the median step time and its kernel time.
  8. video_transformer - the frozen windowed Swin3D-T + a 2-layer
                transformer head at full width (128 frames, window 8,
                hidden 768, 8 heads): (a) the logits and, under the
                class-weighted CE, every head gradient at b2 (16 frames at
                128 px, resized to 112 on the device) on the card against
                the CPU, 1e-3 (of each gradient's largest); (b)
                cli.train_video_transformer.main at its defaults (b8, 112
                px), 2 epochs on 8 + 4 synthetic clips of 128 frames at 128
                px: K2 12 and K4 4 times per train and eval step, no K3;
                the logs and checkpoints; (c) the median step time, the
                peak memory and the step's kernel families.
  9. audio_text - the CNN1D + text transformer two-tower model at full width
                (80 000 samples, 48 tokens, hidden 768): (a) the loss and
                every gradient at b2, eval mode, card against CPU, 1e-3 of
                each tensor's largest; (b) cli.train_audio_text.main, b16, 2
                epochs on a synthetic AVABOS table: K1 once per train and
                eval step, no other kernel; (c) the median step time, the
                peak memory and the step's kernel families.
 10. audio_rnn - the audio RNN entry's three heads (LSTM_1_layer,
                GRU_1_layer, Avg at hidden 512) over a frozen extractor on
                10 s clips (160 000 samples): (a) the summed loss, every
                head's logits and every gradient at b2, eval mode, card
                against CPU, 1e-3 (of each gradient's largest), for each
                extractor (wav2vec-1, wav2vec-2's conv stack, the whole
                wav2vec-2, CNN1D); (b) cli.train_audio_rnn.main at its
                defaults (wav2vec-1, b16), 2 epochs on 32 + 8 synthetic
                tone clips: no kernel launched, each head's logs and best
                checkpoint; (c) the same with --extractor cnn1d: K1 (the
                stem, its BN and ReLU folded in) once per train and eval
                step, no other kernel; (d) for both, the median step time,
                the peak memory and the kernel families.  An RNN whose
                weights are not one flat buffer (cuDNN's warning) fails
                this phase and the next.
 11. video_rnn - the same three heads over 19 x 512 feature sequences:
                parity at b2 as (a); cli.train_video_rnn.main at b16, 2
                epochs with --epoch_dirs over train/0 and train/1 (the
                second epoch reads train/1), no kernel; the step time.
 12. audio_transformer_w2v - cli.train_audio_transformer --arch
                transformer: the frozen wav2vec-1 encoder on 5 s clips
                (498 frames) and a 2-layer, 8-head transformer head:
                parity at b2 as (a); 2 epochs at b16 on 32 + 8 tone clips,
                no kernel; the step time.
 13. train3dcnn - the bbox-masked R3D-18 at cli/train3dcnn.py's defaults
                (b8, 32 frames at 112 px, 4 classes, alpha 0.4): (a) its
                loss, logits and every gradient at b2, eval mode, card
                against CPU, each run held to float64 on its own ReLU
                decisions (the differing decisions counted); (b)
                cli.train3dcnn.main, 2 epochs on 16 + 8 synthetic clip dirs
                written at 112 px (the paired augmentation on every train
                clip, no resize): no kernel launched; the logs and
                checkpoints; (c) the median step time, the peak memory,
                the kernel families with cuDNN's conv forward, dgrad and
                wgrad apart, the busy share.
 14. extract   - cli.extract_features.main at its defaults (b4, 304
                frames, 16-frame windows, --swin_gelu poly, --num_epochs 1)
                on 4 + 4 clips of 304 frames at 112 px, for each backbone:
                (a) one clip's features card against CPU, 1e-3 of the
                largest; (b) the CLI with the launch counts reset just
                before and read just after: K2 12 and K4 4 per Swin
                forward, none for R3D-18 and S3D; the files test/,
                train/0/, train/1/ with (19, D) arrays; (c) the device ms
                and kernel families of one b4 forward, and the host-clock
                ms per batch and clips/s of a 3-batch split with the lag-1
                readback and with MAR_EXTRACT_PIPELINE=0, in turns.
 15. generate_features - cli.generate_features.main on the tri-modal model
                at TRAIN's config (b8) over a synthetic table: the fused
                tokens card against CPU at b2 (1e-3), launches per batch
                by the modalities present (K1 once with audio, K2 12 and
                K4 4 times with video), the files and manifest.
 16. doctor    - cli.doctor --smoke: its report on one line, K4 launched
                once and bit for bit equal to torch.roll, the native wav
                decoder built and loaded.
 17. quantized - (22) serve.Predictor(quantize=...) of the flagship (b32)
                and the tri-modal model (b8) at full width: int8 and w8a8
                in f32, and the tri-modal int8 in bf16: K1 1 (tri-modal
                also K2 12, K4 4) launches a forward through the
                mar_torch:: ops; the probabilities within 0.05 (int8) and
                0.2 (w8a8) of the card's f32 ones (tests/test_quantize.py);
                the same quantized forward on the card and on the CPU
                (tri-modal at b2) within 1e-3 of the largest logit, w8a8 on
                the card's activation codes with the codes that differ
                counted; tree_nbytes f32 and int8, the resident bytes on
                the card, device ms and peak memory beside f32, the kernel
                families.  The video RNN heads (b16, 19 x 512) int8: cuDNN
                weights flat, card against CPU, the dequantization's ms.
 18. export    - (23) io/export.export_predictor at full width: the
                tri-modal model (b8) in f32 and int8 and the flagship (b32)
                in w8a8 exported on the card, each artifact within 1e-6 of
                its live Predictor; the flagship exported on the CPU and
                scored on the card (no node on the CPU) within 1e-3 of the
                largest logit; K1, K2, K4 launched per forward through the
                ops; export seconds, artifact bytes, forward ms; cli.serve
                --exported flag=<dir>,tri=<dir> routed by name over HTTP;
                and inside the train phase, cli.export_model --from_run of
                run (3)'s checkpoint, cli.predict --exported on (e)'s clips
                and cli.evaluate --exported on its test split, equal to the
                same CLIs on the checkpoint.
 19. bf16 entries - (24-26) each train entry of 4-12 (the audio RNN with
                wav2vec-1 and CNN1D) again through its CLI for one epoch
                with --compute_dtype bfloat16 (bf16_cli_phase): launches by
                kernel and dtype against its per-step counts in the dtype
                JAX's flow gives (K1 f32 inside; the video transformer's
                K2 12 and K4 4 in f32, its resize returning f32), the bf16
                step ms and peak beside the f32 run's, the kernel
                families, one step's loss from the seeded weights bf16
                against f32 (5 %) and the first row's eval loss and logits
                card against CPU (2e-2 of the largest logit, 1e-3 where the
                flow is f32); K2 bf16 at every extraction shape (N = 392
                and 128) against its bf16 plain version (1e-2 of the
                largest), at stage 0 cold and warm against its bound and
                SDPA in bf16; K4 bf16 at both extraction shapes bit for
                bit; each backbone's extraction in bf16 (the Swin's K2 12
                and K4 4 bf16 per forward, files within 0.1 of the f32
                run's, one window card against CPU within 2e-2); a bf16
                video-transformer artifact exported and scored on the card
                (K2 12, K4 4 bf16, equal to the live Predictor).
 20. pieces    - the tri-modal towers (CNN1D at 80 000 samples, 48 x 768
                text, the windowed Swin3D-T at 128 frames of 112 px) under
                the pieces no CLI builds, seeded with randomized norms:
                a CrossAttentionFusion(768, 8) with a MultimodalModel of
                one OutputClassifier per stream, and an
                AveragedFeaturesTransformerFusion with
                PhysVerbClassifierAddFeatures.  Each b8 eval forward
                launches K1 1, K2 12, K4 4 (the cross-attention model
                without video K1 only); its device ms; card against CPU at
                b2 within 1e-3 of the largest logit, and one bf16 row
                (K2, K4 bf16) within 2e-2.
 21. remat dots - cli.train_multimodal.main with --video_remat_policy dots
                (b8, Swin unfrozen, 2 epochs); one step under "dots",
                save-nothing and remat off: launches (K1 1, K2 24, K3 12,
                K4 12 under both policies), median device ms and peak
                memory of each, in turns; the loss and every gradient under
                "dots" within 1e-6 of save-nothing's (of each tensor's
                largest, plus two save-nothing runs' own spread).
 22. native    - (after the VGG) libmarhost built from native/marhost.cpp
                (a failed build fails the run), libmarvideo where
                pkg-config finds libav* (else the reason); the predict
                phase's 8 wavs through wav_read and wav_batch at 1, 4 and 8
                threads within 2e-3 of the numpy loader, host ms per clip
                beside numpy's; prepare_data resample-audio on them; one
                epoch of the VGG entry under MAR_USE_NATIVE_WAV=1 (K1 once
                per train and eval step), its first logged train loss
                within 1e-4 relative of the numpy run's; an .mp4 clip dir
                through ClipDirSource where libmarvideo and cv2 are there,
                else which is missing.
 23. parallel  - (after remat dots) the fine-tune under --data_parallel as
                a world of one over NCCL against the plain run; a dp 2 x
                tp 2 step on four gloo ranks sharing the card against one
                rank; two serving replicas and two exported replicas on
                the card against one device.
 24. tp serving - Predictor(devices=, model_parallelism=2) in one process:
                the tri-modal b8 model over ["cuda:0"] * 2 (tp 2) and
                ["cuda:0"] * 4 (dp 2 x tp 2), the flagship b32 over
                ["cuda:0"] * 2 in f32, int8 and bf16, each against its
                one-device Predictor (probabilities within 1e-5, bf16
                logits within 1e-2 of the largest), launches per forward
                (K1 1, K2 12, K4 4 a tri-modal data group), six split
                leaves of the fusion layer, predict ms in turns; the tp 2
                daemon (build_server(devices=["cuda:0"] * 2)) answering
                /score and /healthz; `serve --model_parallelism 2`'s own
                device list: its "does not divide" exit on one card, its
                groups and scores over an even number of cards.

Prints a `slice` JSON line per slice, a `train` JSON line per train path,
an `evaluate` and a `predict` JSON line, an `extract` JSON line per
backbone, a `serve` line for bf16 serving, a `quantized` line per
quantized Predictor, an `export` line per artifact, `serve_exported` and
`exported_scoring` lines, a `pieces`, a `native`, a `parallel` and a
`tp_serving` line,
the `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Every kernel
entry's `launches` counts the tri-modal fine-tune; `launches_by_path` gives
each path's (evaluate, predict and doctor among them); K2's, K3's and K4's
`bf16` entries give their bf16 numbers and the bf16 paths' launches,
K2's `bf16_extract` its N = 392 bf16 numbers, and K1's, K2's and K4's
`launches_under_bf16` the launches of every bf16 path by instantiation.
Without a CUDA device it exits non-zero and prints no result.
"""

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from multimodalaggressionrecognition_tpu_torch.cli.serve import (ServeConfig,
                                                                 build_server)
from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
    MultimodalConfig, build_model)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    seeded_init_)
from multimodalaggressionrecognition_tpu_torch.models.nn1d import BatchNorm1d
from multimodalaggressionrecognition_tpu_torch.models.nn3d import Conv3d
from multimodalaggressionrecognition_tpu_torch.models.physverb import (
    IdentityExtractor)
from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    PatchEmbed3d, _attention_mask, _PatchGemm, _patches, patch_gemm)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    framed_conv1d, framed_conv1d_reference, out_length)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    launch_info as framed_conv_launch_info)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.window_attention import (
    attention_core_reference, fused_window_attention, launch_info,
    window_attention_bwd, window_attention_bwd_reference,
    window_attention_fwd)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.roll import (
    circular_roll, roll, roll_reference)
from multimodalaggressionrecognition_tpu_torch.ops.resample import (
    resample_poly)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.utils import kernels
from portbench.yardstick.peaks import (PASSES, k1_work, k2_work, k2_work_bf16,
                                       k3_work, k3_work_bf16, peaks)

SEED = 0
DEVICE = "cuda"
TOL = dict(atol=1e-4, rtol=1e-4)
# full width of the flagship (cli/train_multimodal.py defaults) and of the
# tri-modal model (+ Swin3D-T on 128 frames at 112 px, 8-frame windows)
FLAGSHIP = dict(hidden_size=768, fusion_layers=1, fusion_heads=8,
                audio_samples=80000, text_tokens=48)
TRIMODAL = dict(FLAGSHIP, video_frames=128, video_size=112, video_window=8)
# (modalities, config, served batch, parity batch, launches per forward)
BATCH = 32  # the flagship's served batch: K1's main-path shape
SLICES = [("audio,text", FLAGSHIP, BATCH, BATCH, {"framed_conv1d": 1}),
          ("audio,text,video", TRIMODAL, 8, 2,
           {"framed_conv1d": 1, "window_attention": 12, "roll": 4})]
# (name, B, L, F, hop, pad, C, epilogue): tests/test_pallas.py's shapes, a
# non-multiple F/hop; K1's three routes at full size: the CNN1D stem as the
# served path calls it (its BatchNorm and ReLU folded into the epilogue) and
# as the b8 train step does (bias only), the STFT of ops/stft.py (5 s at 16 kHz, reflect-padded, against the 514-wide
# DFT basis) and the 44.1 -> 16 kHz polyphase resample of ops/resample.py;
# (at b32, and at b16 as the spectrogram VGG's train step calls it);
# then ragged edges: C=1, T under one 128-frame tile, F < 8 with hop 3, hops
# 7 and 12 (not multiples of 8; 7 takes the 4-byte gathers) and T = 1
K1_SHAPES = [("stem-2x8000", 2, 8000, 160, 40, 80, 64, False),
             ("stft-2x8000", 2, 8000, 512, 256, 0, 128, False),
             ("w2v-2x8000", 2, 8000, 10, 5, 0, 512, False),
             ("epilogue-1x4000", 1, 4000, 160, 40, 80, 64, True),
             ("f147-hop40", 2, 8000, 147, 40, 3, 24, False),
             ("stem-32x80000", BATCH, 80000, 160, 40, 80, 64, True),
             ("stem-8x80000", 8, 80000, 160, 40, 80, 64, False),
             # the audio,text trainer's stem: bias only in a train step,
             # the folded BN/ReLU epilogue in an eval step
             ("stem-16x80000", 16, 80000, 160, 40, 80, 64, False),
             ("stem-16x80000-epilogue", 16, 80000, 160, 40, 80, 64, True),
             # the audio RNN trainer's frozen CNN1D stem (10 s clips): the
             # folded BN/ReLU epilogue in train and eval steps alike
             ("stem-16x160000-epilogue", 16, 160000, 160, 40, 80, 64, True),
             ("stft-32x80512", BATCH, 80512, 512, 256, 0, 514, False),
             ("stft-16x80512", 16, 80512, 512, 256, 0, 514, False),
             ("resample-32x220975", BATCH, 220975, 475, 441, 0, 160, False),
             ("c1", 3, 5000, 160, 40, 80, 1, True),
             ("t26", 2, 1000, 160, 40, 80, 64, False),
             ("f5-hop3", 2, 3001, 5, 3, 2, 33, True),
             ("hop7-c70", 2, 4003, 64, 7, 1, 70, False),
             ("hop12", 2, 4000, 48, 12, 4, 40, False),
             ("t1", 3, 160, 160, 40, 0, 64, True)]
# timed in turns with the plain version and F.conv1d, each under its key of
# the kernels JSON: the served stem first (its numbers at the entry's top
# level), the train step's stem (its grid takes the narrow frame tile), the
# STFT's at b32 and as the spectrogram VGG's b16 train step calls it, and
# the audio RNN trainer's stem on 10 s clips
K1_TIMED = {"stem-32x80000": None, "stem-8x80000": "stem_b8",
            "stft-32x80512": "stft", "stft-16x80512": "stft_b16",
            "stem-16x160000-epilogue": "stem_b16_10s"}
# K4, Swin3D-T's shifted-window roll, as the b8 tri-modal forward calls it:
# 128 windows of 8 frames, T = 4 after the patch embed (its shift clamped to
# 0), rolled by (0, 3, 3) before the attention and back after it, at stage 0
# (28 x 28, C = 96) and stage 1 (14 x 14, C = 192); stages 2 and 3 clamp
# every axis (no roll).  (name, shape, shifts); then ragged shapes: C = 3
# and 5 (the scalar path) with odd H and W and a T shift, shift 0 on one
# axis, B = 1
K4_STAGES = {"stage0": (128, 4, 28, 28, 96), "stage1": (128, 4, 14, 14, 192)}
K4_CASES = ([(f"{k}{sign}", shape, (0, s, s)) for k, shape in K4_STAGES.items()
             for sign, s in (("", 3), ("-back", -3))]
            + [("c3-odd", (2, 4, 7, 9, 3), (0, 3, 4)),
               ("c5-t-shift", (3, 5, 9, 11, 5), (2, -4, 6)),
               ("w-only", (2, 4, 14, 14, 96), (0, 0, 3)),
               ("b1", (1, 4, 28, 28, 96), (0, 3, 3)),
               ("c8-t-shift", (2, 3, 9, 11, 8), (1, 4, 5))])
# K2: (W, N, heads, d, nW_img) of tests/test_pallas.py, random masks
K2_TEST_SHAPES = [(8, 24, 3, 8, 4), (6, 49, 3, 32, 3), (4, 12, 2, 16, 0)]
# K2 as the tri-modal b8 forward calls it: 128 windows of 8 frames, patch
# grid 4x28x28, window (8,7,7) clamped to 4 frames; (name, W, N, heads, d,
# nW_img, launches per forward).  Shifted blocks use the real mask of their
# padded grid (K2_GRIDS); stage 2 clamps h and w (no shift), stage 3 all axes.
K2_STAGES = [("stage0-shifted", 2048, 196, 3, 32, 16, 1),
             ("stage0", 2048, 196, 3, 32, 0, 1),
             ("stage1-shifted", 512, 196, 6, 32, 4, 1),
             ("stage1", 512, 196, 6, 32, 0, 1),
             ("stage2", 128, 196, 12, 32, 0, 6),
             ("stage3", 128, 64, 24, 32, 0, 2)]
K2_GRIDS = {16: (4, 28, 28), 4: (4, 14, 14)}
# K3: (W, N, heads, d, nW_img) of tests/test_pallas.py's gradient case,
# masked and not, and a clamped N=64 window; then K2_STAGES
K3_TEST_SHAPES = [(6, 24, 3, 8, 0), (6, 24, 3, 8, 3), (4, 64, 2, 16, 2)]
# K2 and K3 at ragged 16- and 8-token tiles: (W, N, heads, d, nW_img) for
# N in {1, 17, 392} x d in {8, 16, 32}, unmasked and with random masks
EDGE_SHAPES = [(4, n, 2, d, nw) for n in (1, 17, 392) for d in (8, 16, 32)
               for nw in (0, 2)]


def bound(card: str, flops: float, nbytes: float, products=None):
    """The least time the card could take: {bound_ms, bound_by, and both
    terms}.  `products`: the work runs on the tensor cores, listed as
    (flops, operand types) per product, each at its PASSES (the
    benchmark's yardstick, portbench/yardstick/peaks.py); the f32 FMA
    pipe's bound (the only one before the tensor-core designs) is then
    kept beside it as fma_bound_ms."""
    peak = peaks(card)
    fma_ms = flops / peak["fma"] * 1e3
    bytes_ms = nbytes / peak["bw"] * 1e3
    ops_ms = fma_ms
    if products is not None:
        ops_ms = sum(PASSES[kind][0] * f / peak[PASSES[kind][1]]
                     for f, kind in products) * 1e3
    out = {"bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "ops_ms": ops_ms, "bytes_ms": bytes_ms}
    if products is not None:
        out["fma_bound_ms"] = max(fma_ms, bytes_ms)
    return out


def bound_text(bd) -> str:
    """'bound X ms (by: operations A ms, bytes B ms)[; FMA bound F ms]'."""
    text = (f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: operations "
            f"{bd['ops_ms']:.4f} ms, bytes {bd['bytes_ms']:.4f} ms)")
    if "fma_bound_ms" in bd:
        text = ("tensor-core " + text
                + f"; f32 FMA bound {bd['fma_bound_ms']:.4f} ms")
    return text


def log(*parts):
    print(*parts, flush=True)


def short_name(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_115name_kernelILi32EE...' -> 'name_kernel<32>': the
    length-prefixed name ending in `_kernel` (every kernel of csrc/ is
    named so) and its int template arguments ('<32,2>' for the bf16 K2's
    head dim and key tiles), with ',bf16' where the next one is
    __nv_bfloat16."""
    # a hash before the name may end in digits, so try every split of a
    # digit run into the hash's tail and the length prefix
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):
            end = m.end() + int(mangled[start:m.end()])
            name = mangled[m.end():end]
            if re.fullmatch(r"[A-Za-z]\w*_kernel", name):
                tmpl = re.match(r"ILi(\d+)E(?:Li(\d+)E)?(13__nv_bfloat16)?",
                                mangled[end:])
                if not tmpl:
                    return name
                return (name + f"<{tmpl.group(1)}"
                        + (f",{tmpl.group(2)}" if tmpl.group(2) else "")
                        + (",bf16>" if tmpl.group(3) else ">"))
    return mangled


def ptxas_usage(text: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack, static_smem}}
    from nvcc's `-Xptxas -v` output."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = short_name(m.group(1))
            usage[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                usage[name].update(zip(("stack", "spill_stores",
                                        "spill_loads"),
                                       map(int, m.groups())))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                usage[name].update(registers=int(m.group(1)),
                                   static_smem=int(smem.group(1)) if smem
                                   else 0)
    return usage


SASS_OPS = ("HMMA", "FFMA", "FMUL", "FADD", "LDS", "LDGSTS", "LDG", "STS",
            "STG", "BAR")


def sass_counts(lib: str) -> dict:
    """{kernel: {"total": {opcode: count}, "product_loop": {...},
    "hmma": {HMMA variant: count}}} for each kernel of `lib`'s library,
    from `cuobjdump -sass` (HMMA: tensor-core mma, its variant naming the
    shape and operand type, e.g. HMMA.1688.F32.TF32 or
    HMMA.16816.F32.BF16; FFMA: f32 FMA pipe; LDGSTS: cp.async).  The
    product loop is the longest run of instructions whose HMMAs lie fewer
    than 150 apart."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", kernels.library_path(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        full = re.findall(
            r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
            body, re.M)
        ops = [op.split(".")[0] for op in full]
        runs, hmma = [], [i for i, op in enumerate(ops) if op == "HMMA"]
        for i in hmma:
            if runs and i - runs[-1][1] < 150:
                runs[-1][1] = i
            else:
                runs.append([i, i])
        a, b = max(runs, key=lambda r: r[1] - r[0], default=(0, -1))
        loop = ops[a:b + 1]
        hmma = [op for op in full if op.startswith("HMMA")]
        counts[short_name(body.split()[0])] = {
            "total": {k: ops.count(k) for k in SASS_OPS},
            "product_loop": {"instructions": len(loop),
                             **{k: loop.count(k) for k in SASS_OPS}},
            "hmma": {k: hmma.count(k) for k in sorted(set(hmma))}}
    return counts


def resources_phase():
    """Each kernel's registers, spills and static shared memory (ptxas);
    the framed conv's launch and SASS instruction mix for each frame tile
    (m-tiles of 16 frames a warp: 2 where the taps are many and the grid
    is full, as at the STFT, else 1, as at the stem); the
    window-attention launches at stage 0 (N=196, d=32): threads, dynamic
    shared memory, resident blocks per SM, and their bf16 instantiations;
    the roll's 16-byte, 4-byte and 2-byte instantiations."""
    found = {}
    for lib in kernels.kernel_sources():
        for kernel, use in ptxas_usage(kernels.build_log(lib)).items():
            found[kernel] = use
            log(f"resources {lib}: {kernel}: {use.get('registers')} "
                f"registers, spill stores {use.get('spill_stores')} B, spill "
                f"loads {use.get('spill_loads')} B, stack {use.get('stack')} "
                f"B, static smem {use.get('static_smem')} B")
    sass = sass_counts("framed_conv")
    launches = {"framed_conv1d": {}}
    for mt in (2, 1):
        kernel = f"framed_conv1d_kernel<{mt}>"
        info = framed_conv_launch_info(mt)
        launches["framed_conv1d"][f"m_tiles_{mt}"] = {
            **info, **found[kernel], "sass": sass[kernel]}
        log(f"resources {kernel} launch: {info['threads']} threads, "
            f"{info['dynamic_smem_bytes']} B dynamic smem, "
            f"{info['blocks_per_sm']} blocks per SM "
            f"({info['blocks_per_sm'] * info['threads'] // 32} warps); SASS "
            + "; ".join(f"{part}: " + ", ".join(f"{k} {v}"
                                                for k, v in n.items())
                        for part, n in sass[kernel].items()))
    # 16-byte vectors, 4-byte (f32) and 2-byte (bf16) elements
    launches["roll"] = {f"bytes{v}": found[f"roll_kernel<{v}>"]
                        for v in (16, 4, 2)}
    sass = {**sass_counts("window_attention"),
            **sass_counts("window_attention_bwd")}
    # the bf16 instantiations' own kernels: K2's with 2 key tiles a step
    # (N <= 256) and with 4 (N = 392), K3's
    bf16_kernels = {"window_attention": {196: "window_attention_bf16_kernel<32,2>",
                                         392: "window_attention_bf16_kernel<32,4>"},
                    "window_attention_bwd": {
                        196: "window_attention_bwd_bf16_kernel<32>"}}
    for name in ("window_attention", "window_attention_bwd"):
        info = launch_info(name, 196, 32)
        launches[name] = {**info, **found.get(f"{name}_kernel<32>", {}),
                          "hmma": sass[f"{name}_kernel<32>"]["hmma"],
                          "bf16": {}}
        log(f"resources {name} launch at N=196 d=32: {info['threads']} "
            f"threads, {info['dynamic_smem_bytes']} B dynamic smem, "
            f"{info['blocks_per_sm']} blocks per SM "
            f"({info['blocks_per_sm'] * info['threads'] // 32} warps); SASS "
            f"HMMA {sass[f'{name}_kernel<32>']['hmma']}")
        for n, kernel in bf16_kernels[name].items():
            info = launch_info(name, n, 32, BF16)
            hmma = sass[kernel]["hmma"]
            # the bf16 products run on the bf16 tensor cores, none in TF32
            if (not any(".BF16" in k for k in hmma)
                    or any(".TF32" in k for k in hmma)):
                raise AssertionError(f"resources {kernel}: HMMA {hmma}, want "
                                     "bf16 and no TF32")
            launches[name]["bf16"][f"N{n}"] = {
                "kernel": kernel, **info, **found[kernel], "sass": sass[kernel]}
            log(f"resources {kernel} (bf16) launch at N={n} d=32: "
                f"{info['threads']} threads, {info['dynamic_smem_bytes']} B "
                f"dynamic smem, {info['blocks_per_sm']} blocks per SM "
                f"({info['blocks_per_sm'] * info['threads'] // 32} warps), "
                f"{found[kernel].get('registers')} registers, spill stores "
                f"{found[kernel].get('spill_stores')} B; SASS HMMA {hmma}; "
                + "; ".join(f"{part}: " + ", ".join(
                    f"{k} {v}" for k, v in sass[kernel][part].items())
                    for part in ("total", "product_loop")))
    return launches


def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rotating(make, n: int = 4):
    """A fn() that cycles through n argument sets, so that the working set
    exceeds the 50 MB L2 and each call reads its inputs from HBM, as the
    served path (fresh clips every batch) does."""
    sets = [make(i) for i in range(n)]
    state = {"i": 0}

    def call(fn):
        def run():
            state["i"] = (state["i"] + 1) % n
            return fn(*sets[state["i"]])
        return run

    return call


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device time of fn() without the host's dispatch: `reps` calls
    captured in one CUDA graph, replayed `replays` times (CUDA events).  For
    work shorter than a Python call (K1 takes ~0.03 ms at the stem), where
    timing back-to-back calls measures the host."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # a first call on the capture's side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the kernels' launch raises their shared-memory limit
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


_FLUSH = []


def cold_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() finding its inputs outside the 50 MB L2,
    as a served batch of fresh clips does: before each call a 256 MB copy
    evicts them, long enough that fn's launches are queued before it ends,
    and CUDA events time fn alone."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(2 ** 26, device=DEVICE))  # 256 MB
        _FLUSH.append(torch.empty_like(_FLUSH[0]))
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        _FLUSH[1].copy_(_FLUSH[0])
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def in_turns(fns, reps: int = 30, timer=cuda_ms):
    """{key: min ms} of each fn, timed in turns a, b, ..., ..., b, a."""
    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for key in order:
        times[key].append(timer(fns[key], reps=reps))
    return {k: min(v) for k, v in times.items()}


def k1_inputs(b, length, f, c, epilogue, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, length), generator=g)
    w = torch.randn((f, c), generator=g) * 0.05
    bias = torch.randn((c,), generator=g)
    scale = torch.rand((c,), generator=g) + 0.5 if epilogue else None
    shift = torch.randn((c,), generator=g) * 0.2 if epilogue else None
    return [t if t is None else t.to(DEVICE)
            for t in (x, w, bias, scale, shift)]


def k1_phase(card: str):
    """K1 against its plain version at every shape (1e-4), bit for bit over
    two launches at the served stem; at each K1_TIMED shape the kernel's,
    the plain version's and F.conv1d's device times, in turns on rotating
    inputs, against the tensor-core bound (3xTF32) and the f32 FMA pipe's:
    cold, the inputs evicted from L2 before each call as a batch of fresh
    clips finds them (the JSON's times), and warm, back to back in a CUDA
    graph."""
    worst, shapes = 0.0, {}
    for name, b, length, f, hop, pad, c, epi in K1_SHAPES:
        shapes[name] = (b, length, f, hop, pad, c, epi)
        x, w, bias, scale, shift = k1_inputs(b, length, f, c, epi, seed=f)
        got = framed_conv1d(x, w, bias, f, hop, pad, scale, shift, relu=epi)
        torch.cuda.synchronize()
        ref = framed_conv1d_reference(x, w, bias, f, hop, pad, scale, shift,
                                      relu=epi)
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **TOL)
        worst = max(worst, err)
        log(f"k1 {name}: B={b} L={length} F={f} hop={hop} pad={pad} C={c} "
            f"epilogue={epi} out={tuple(got.shape)} max_abs_err={err:.3e} ok")
        if name == "stem-32x80000":  # deterministic: a fixed order, no atomics
            again = framed_conv1d(x, w, bias, f, hop, pad, scale, shift,
                                  relu=epi)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"k1 {name}: two launches differ by "
                                     f"{(got - again).abs().max().item():.3e}")
            log(f"k1 {name}: two launches bitwise equal ok")
        del x, w, bias, scale, shift, got, ref

    out = {"max_abs_err": worst}
    labels = {"ms": "kernel", "plain_ms": "plain", "library_ms": "F.conv1d"}
    for name, key in K1_TIMED.items():
        b, length, f, hop, pad, c, epi = shapes[name]

        def make(i):
            x, w, bi, sc, sh = k1_inputs(b, length, f, c, epi, seed=100 + i)
            return x, w, bi, sc, sh, w.t().contiguous()[:, None, :]

        def kernel(x, w, bi, sc, sh, _):
            return framed_conv1d(x, w, bi, f, hop, pad, sc, sh, relu=epi)

        call = rotating(make)
        fns = {"ms": call(kernel),
               "plain_ms": call(lambda x, w, bi, sc, sh, _:
                                framed_conv1d_reference(x, w, bi, f, hop, pad,
                                                        sc, sh, relu=epi)),
               # yardstick only (the port never calls it): cuDNN's conv with
               # bias, in the (B, C, T) layout, without the epilogue
               "library_ms": call(lambda x, w, bi, sc, sh, w_conv: F.conv1d(
                   x[:, None, :], w_conv, bi, stride=hop, padding=pad))}
        times = in_turns(fns, reps=20, timer=cold_ms)
        warm = in_turns(fns, reps=20, timer=graph_ms)
        flops, nbytes, products = k1_work(b, length, f, hop, pad, c)
        bd = bound(card, flops, nbytes, products)
        for label, t in (("cold", times), ("warm", warm)):
            log(f"k1 {name} timing ({label}) on {card}: "
                + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in t.items())
                + f"; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; "
                f"{bound_text(bd)}; kernel at "
                f"{bd['bound_ms'] / t['ms'] * 100:.1f}% of the tensor-core "
                f"bound, {bd['fma_bound_ms'] / t['ms'] * 100:.1f}% of the "
                "FMA bound")
        numbers = {**times, "warm": warm, "bound_ms": bd["bound_ms"],
                   "bound_by": bd["bound_by"],
                   "fma_bound_ms": bd["fma_bound_ms"]}
        if key is None:
            out.update(numbers)
        else:
            out[key] = numbers
        del call, fns
    return out


def k4_phase(card: str):
    """K4 against torch.roll (its plain version) bit for bit at every
    K4_CASES shape and on a misaligned view (the scalar path); twice on the
    same input, bit for bit; its autograd backward against the opposite
    roll; at each stage the kernel's, the plain version's and torch.roll's
    device times (the plain version is torch.roll, so the two time one
    call), in turns on rotating inputs, cold (after an L2 flush, the JSON's
    times) and warm (CUDA graphs), against the bound by bytes: x read and
    the output written once."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    cases = [(name, torch.randn(shape, generator=g, device=DEVICE), shifts)
             for name, shape, shifts in K4_CASES]
    flat = torch.randn(1 + 2 * 4 * 6 * 6 * 8, generator=g, device=DEVICE)
    cases.append(("misaligned-view", flat[1:].view(2, 4, 6, 6, 8), (0, 3, 3)))
    for name, x, shifts in cases:
        got = circular_roll(x, shifts)
        torch.cuda.synchronize()
        if not torch.equal(got, roll_reference(x, shifts)):
            raise AssertionError(f"k4 {name} {tuple(x.shape)} {shifts}: "
                                 "differs from torch.roll")
        log(f"k4 {name}: {tuple(x.shape)} shifts {shifts} bitwise equal to "
            "torch.roll ok")
    x = cases[0][1]
    if not torch.equal(circular_roll(x, (0, 3, 3)), circular_roll(x, (0, 3, 3))):
        raise AssertionError("k4: two launches differ")
    xg = x.clone().requires_grad_(True)
    grad = torch.randn_like(x)
    roll(xg, (0, 3, 3)).backward(grad)
    if not torch.equal(xg.grad, roll_reference(grad, (0, -3, -3))):
        raise AssertionError("k4: the backward is not the opposite roll")
    log("k4 stage0: two launches bitwise equal, backward equals the "
        "opposite roll ok")
    del cases, flat, xg, grad

    out = {"max_abs_err": 0.0}
    labels = {"ms": "kernel", "plain_ms": "plain (torch.roll)",
              "library_ms": "torch.roll"}
    for stage, shape in K4_STAGES.items():
        def make(i, shape=shape):
            gi = torch.Generator(device=DEVICE).manual_seed(200 + i)
            return (torch.randn(shape, generator=gi, device=DEVICE),)

        call = rotating(make)
        fns = {"ms": call(lambda x: circular_roll(x, (0, 3, 3))),
               "plain_ms": call(lambda x: roll_reference(x, (0, 3, 3))),
               # yardstick only: the one PyTorch call for the same function
               "library_ms": call(lambda x: torch.roll(x, (-3, -3), (2, 3)))}
        cold = in_turns(fns, reps=20, timer=cold_ms)
        warm = in_turns(fns, reps=20, timer=graph_ms)
        nbytes = 2 * 4 * int(np.prod(shape))
        bd = bound(card, 0, nbytes)
        for label, t in (("cold", cold), ("warm", warm)):
            log(f"k4 {stage} {shape} timing ({label}) on {card}: "
                + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in t.items())
                + f"; {nbytes / 1e6:.1f} MB; bound {bd['bound_ms']:.4f} ms "
                f"(bytes); kernel at {bd['bound_ms'] / t['ms'] * 100:.1f}% "
                "of the bound")
        numbers = {**cold, "warm": warm, "bound_ms": bd["bound_ms"],
                   "bound_by": "bytes", "shape": list(shape),
                   "shifts": [0, 3, 3]}
        if stage == "stage0":
            out.update(numbers)
        else:
            out[stage] = numbers
        del call, fns
    return out


def k2_inputs(w, n, heads, d, nw, seed, stage_mask=False, window=(4, 7, 7),
              grids=K2_GRIDS):
    """qkv, bias and mask on the card, drawn there from `seed`; a stage's
    mask is the real one of its padded grid (`grids[nW_img]`) for
    `window` shifted by (0, 3, 3)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    c = heads * d
    qkv = torch.randn((w, n, 3 * c), generator=g, device=DEVICE)
    bias = torch.randn((heads, n, n), generator=g, device=DEVICE) * 0.1
    mask = None
    if nw and stage_mask:
        mask = torch.from_numpy(_attention_mask(
            *grids[nw], window, (0, 3, 3))).to(DEVICE)
    elif nw:
        mask = torch.where(torch.rand((nw, n, n), generator=g,
                                      device=DEVICE) > 0.7, -100.0, 0.0)
    return qkv, bias, mask


def bitwise_equal(x, y):
    return x.shape == y.shape and torch.equal(x.view(torch.uint8),
                                              y.view(torch.uint8))


# K2's lse against the plain version's: LSE_TOL plus LSE_RTOL of its
# magnitude (a row whose keys the -100 mask all hides has lse ~ -100, ~ -144
# in base 2, where f32's own spacing is 1.5e-5)
LSE_TOL, LSE_RTOL = 1e-5, 1e-6


def k2_lse_check(label, qkv, bias, mask, heads, out):
    """K2 with the rows' logsumexp (window_attention_fwd) against the
    launch without it and the plain version: its output bit for bit
    `out`, its lse within LSE_TOL + LSE_RTOL |lse| of the plain version's
    in the instantiation's base (e for f32, 2 for bf16).  Returns lse's
    max abs error."""
    got, lse = window_attention_fwd(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    if not bitwise_equal(got, out):
        raise AssertionError(f"{label}: the output with lse differs from the "
                             "output without it")
    want = attention_core_reference(qkv, bias, mask, heads, with_lse=True)[1]
    err = (lse - want).abs()
    excess = (err - LSE_TOL - LSE_RTOL * want.abs()).max().item()
    if lse.dtype != torch.float32 or not excess <= 0:
        raise AssertionError(f"{label}: lse {lse.dtype}, an element "
                             f"{excess:.3e} past {LSE_TOL} + {LSE_RTOL} |lse|")
    return err.max().item()


def sdpa_args(qkv, bias, mask, heads):
    """q, k, v and attn_mask for F.scaled_dot_product_attention: the same
    function, with windows sharing a mask slot batched as (W/nW, nW*heads,
    N, d).  Made once, outside the timing."""
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    nw = 1 if mask is None else mask.shape[0]
    q, k, v = (t.reshape(w // nw, nw * heads, n, d)
               for t in qkv.view(w, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    am = bias[None] if mask is None else (bias[None] + mask[:, None])
    return q, k, v, am.reshape(1, nw * heads, n, n)


def k2_phase(card: str):
    """K2 against its plain version at every shape, and with the rows'
    logsumexp (k2_lse_check); at stage 0's shifted block the kernel, plain
    and SDPA times; the kernel's time per stage."""
    worst, worst_lse = 0.0, 0.0
    shapes = ([(f"test-{w}x{n}-d{d}", w, n, h, d, nw, 1e-5, False)
               for w, n, h, d, nw in K2_TEST_SHAPES]
              + [(f"edge-N{n}-d{d}-nW{nw}", w, n, h, d, nw, 1e-4, False)
                 for w, n, h, d, nw in EDGE_SHAPES]
              + [(name, w, n, h, d, nw, 1e-4, True)
                 for name, w, n, h, d, nw, _ in K2_STAGES])
    for name, w, n, heads, d, nw, tol, stage in shapes:
        qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed=n * 100 + d,
                                    stage_mask=stage)
        got = fused_window_attention(qkv, bias, mask, heads)
        torch.cuda.synchronize()
        ref = attention_core_reference(qkv, bias, mask, heads)
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
        worst = max(worst, err)
        lse_err = k2_lse_check(f"k2 {name}", qkv, bias, mask, heads, got)
        worst_lse = max(worst_lse, lse_err)
        log(f"k2 {name}: W={w} N={n} heads={heads} d={d} nW_img={nw} "
            f"out={tuple(got.shape)} max_abs_err={err:.3e} <= {tol:g}; with "
            f"lse the same bit for bit, lse {lse_err:.3e} ok")

    from torch.nn.attention import SDPBackend, sdpa_kernel

    # every stage: the kernel; at the main path's shape (stage 0's shifted
    # block) also the plain version, and there and at stage 2 SDPA
    main, per_stage, fwd_ms, fwd_bound, fwd_fma = {}, {}, 0.0, 0.0, 0.0
    for name, w, n, heads, d, nw, launches in K2_STAGES:
        def make(i):
            return k2_inputs(w, n, heads, d, nw, seed=7 + i, stage_mask=True)

        call = rotating(make)
        fns = {"ms": call(
            lambda q, b, m: fused_window_attention(q, b, m, heads))}
        if name == "stage0-shifted":
            fns["plain_ms"] = call(
                lambda q, b, m: attention_core_reference(q, b, m, heads))
        if name in ("stage0-shifted", "stage2"):
            fns["library_ms"] = rotating(
                lambda i: sdpa_args(*make(i), heads))(sdpa)
        times = in_turns(fns)
        bd = bound(card, *k2_work(w, n, heads, d, nw))
        if name == "stage0-shifted":
            main = {**times, "bound_ms": bd["bound_ms"],
                    "bound_by": bd["bound_by"],
                    "fma_bound_ms": bd["fma_bound_ms"],
                    "lse_bound_ms": bound(card, *k2_work(
                        w, n, heads, d, nw, lse=True))["bound_ms"]}
        per_stage[name] = times["ms"]
        fwd_ms += launches * times["ms"]
        fwd_bound += launches * bd["bound_ms"]
        fwd_fma += launches * bd["fma_bound_ms"]
        labels = {"ms": "kernel", "plain_ms": "plain", "library_ms": "SDPA"}
        log(f"k2 {name} x{launches} per forward on {card}: "
            + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in times.items())
            + f"; {bound_text(bd)}; kernel at "
            f"{bd['bound_ms'] / times['ms'] * 100:.1f}% of the tensor-core "
            f"bound, {bd['fma_bound_ms'] / times['ms'] * 100:.1f}% of the "
            "FMA bound")
    log(f"k2 per tri-modal b8 forward (12 launches): kernel {fwd_ms:.4f} ms, "
        f"tensor-core bound {fwd_bound:.4f} ms "
        f"({fwd_bound / fwd_ms * 100:.1f}%), FMA bound {fwd_fma:.4f} ms")

    # the yardstick computes the same function, and which kernel it takes
    name, w, n, heads, d, nw, _ = K2_STAGES[0]
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed=7, stage_mask=True)
    args = sdpa_args(qkv, bias, mask, heads)
    lib_out = (sdpa(*args).reshape(w, heads, n, d).transpose(1, 2)
               .reshape(w, n, heads * d))
    lib_err = (lib_out - attention_core_reference(qkv, bias, mask, heads)
               ).abs().max().item()
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa(*args)
        backend = "its memory-efficient kernel"
    except RuntimeError:
        backend = "another kernel than the memory-efficient one"
    log(f"k2 SDPA at {name}: {backend}, max |d| vs plain {lib_err:.3e}")
    return {"max_abs_err": worst, "lse_max_abs_err": worst_lse, **main,
            "ms_by_stage": per_stage,
            "forward_ms": fwd_ms, "forward_bound_ms": fwd_bound,
            "forward_fma_bound_ms": fwd_fma}


def k3_inputs(w, n, heads, d, nw, seed, stage_mask=False):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed, stage_mask)
    g = torch.randn((w, n, heads * d), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(
                        seed + 1))
    return qkv, bias, mask, g


def with_fwd(qkv, bias, mask, g, heads):
    """K3's inputs (qkv, bias, mask, g, lse, out), lse and the output from
    K2 (window_attention_fwd) on the same qkv, bias and mask."""
    out, lse = window_attention_fwd(qkv, bias, mask, heads)
    return qkv, bias, mask, g, lse, out


def plain_bwd(qkv, bias, mask, g, heads, **route):
    """The plain backward on the plain forward's own lse and output: K3,
    fed K2's, is held to it, so the two sides share only qkv, bias, mask
    and g (an lse written in one base and read in the other shows)."""
    out, lse = attention_core_reference(qkv, bias, mask, heads, with_lse=True)
    return window_attention_bwd_reference(qkv, bias, mask, g, heads, lse, out,
                                          **route)


def sdpa_backward(qkv, bias, mask, g, heads):
    """fn() running only the backward of F.scaled_dot_product_attention on
    the same function, gradients to q, k, v and the float bias + mask; the
    forward runs once, outside the timing."""
    q, k, v, am = (t.detach().requires_grad_()
                   for t in sdpa_args(qkv, bias, mask, heads))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    go = g.reshape(w, n, heads, d).transpose(1, 2).reshape(out.shape)
    return lambda: torch.autograd.grad(out, (q, k, v, am), go,
                                       retain_graph=True)


def k3_phase(card: str):
    """K3 against its plain version (dqkv and dbias) at the gradient shapes
    of tests/test_pallas.py (1e-4) and the Swin3D-T stage shapes (1e-4 of
    the largest gradient); at stage 0's shifted block the kernel, plain and
    SDPA-backward times; the kernel's time per stage and per train step."""
    worst = 0.0
    # (name, shape, stage mask, tolerance relative to the largest gradient)
    shapes = ([(f"test-{w}x{n}-d{d}", w, n, h, d, nw, False, False)
               for w, n, h, d, nw in K3_TEST_SHAPES]
              + [(f"edge-N{n}-d{d}-nW{nw}", w, n, h, d, nw, False, True)
                 for w, n, h, d, nw in EDGE_SHAPES]
              + [(name, w, n, h, d, nw, True, True)
                 for name, w, n, h, d, nw, _ in K2_STAGES])
    for name, w, n, heads, d, nw, stage, relative in shapes:
        qkv, bias, mask, g, lse, out = with_fwd(*k3_inputs(
            w, n, heads, d, nw, seed=n + d, stage_mask=stage), heads)
        got = window_attention_bwd(qkv, bias, mask, g, heads, lse, out)
        torch.cuda.synchronize()
        want = plain_bwd(qkv, bias, mask, g, heads)
        errs = []
        for part, x, y in zip(("dqkv", "dbias"), got, want):
            # at N = 1 the one key has p = 1, so dS = dP - D and dbias are
            # 0 in exact arithmetic: each side returns only its rounding of
            # dP - D (D = g . o against dP on the tensor cores), and dbias
            # is held to the call's largest gradient, dqkv's, instead
            ref = want[0] if part == "dbias" and n == 1 else y
            tol = 1e-4 * (ref.abs().max().item() if relative else 1.0)
            err = (x - y).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"k3 {name} {part}: max |d| {err:.3e} "
                                     f"> {tol:.3e}")
            worst = max(worst, err)
            errs.append(f"{part} {err:.3e} <= {tol:.3e}")
        log(f"k3 {name}: W={w} N={n} heads={heads} d={d} nW_img={nw} "
            + ", ".join(errs) + " ok")

    # deterministic: two launches on the same inputs agree bit for bit
    name, w, n, heads, d, nw, _ = K2_STAGES[0]
    q, b, m, g, lse, out = with_fwd(*k3_inputs(w, n, heads, d, nw, seed=5,
                                               stage_mask=True), heads)
    first = window_attention_bwd(q, b, m, g, heads, lse, out)
    again = window_attention_bwd(q, b, m, g, heads, lse, out)
    torch.cuda.synchronize()
    for part, x, y in zip(("dqkv", "dbias"), first, again):
        if not torch.equal(x, y):
            raise AssertionError(f"k3 {name}: two launches differ in {part} "
                                 f"(max |d| {(x - y).abs().max().item():.3e})")
    log(f"k3 {name}: two launches bitwise equal (dqkv, dbias) ok")
    del q, b, m, g, lse, out, first, again

    main, per_stage, step_ms, step_bound, step_fma = {}, {}, 0.0, 0.0, 0.0
    for name, w, n, heads, d, nw, launches in K2_STAGES:
        def make(i):
            return k3_inputs(w, n, heads, d, nw, seed=17 + i, stage_mask=True)

        call = rotating(lambda i: with_fwd(*make(i), heads))
        fns = {"ms": call(lambda q, b, m, g, lse, o: window_attention_bwd(
            q, b, m, g, heads, lse, o))}
        if name == "stage0-shifted":
            fns["plain_ms"] = call(lambda q, b, m, g, lse, o:
                                   window_attention_bwd_reference(
                                       q, b, m, g, heads, lse, o))
            fns["library_ms"] = rotating(
                lambda i: (sdpa_backward(*make(i), heads),))(lambda f: f())
        times = in_turns(fns, reps=10)
        bd = bound(card, *k3_work(w, n, heads, d, nw))
        if name == "stage0-shifted":
            main = {**times, "bound_ms": bd["bound_ms"],
                    "bound_by": bd["bound_by"],
                    "fma_bound_ms": bd["fma_bound_ms"]}
        per_stage[name] = times["ms"]
        step_ms += launches * times["ms"]
        step_bound += launches * bd["bound_ms"]
        step_fma += launches * bd["fma_bound_ms"]
        labels = {"ms": "kernel", "plain_ms": "plain",
                  "library_ms": "SDPA backward"}
        log(f"k3 {name} x{launches} per train step on {card}: "
            + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in times.items())
            + f"; {bound_text(bd)}; kernel at "
            f"{bd['bound_ms'] / times['ms'] * 100:.1f}% of the tensor-core "
            f"bound, {bd['fma_bound_ms'] / times['ms'] * 100:.1f}% of the "
            "FMA bound")
    log(f"k3 per tri-modal b8 train step (12 launches): kernel {step_ms:.4f} "
        f"ms, tensor-core bound {step_bound:.4f} ms "
        f"({step_bound / step_ms * 100:.1f}%), FMA bound {step_fma:.4f} ms")
    return {"max_abs_err": worst, **main, "ms_by_stage": per_stage,
            "train_step_ms": step_ms, "train_step_bound_ms": step_bound,
            "train_step_fma_bound_ms": step_fma}


# K2, K3 and K4 in bf16 at the main path's shapes (stage 0's shifted block
# of the tri-modal b8 step, and its roll): qkv, g, the output and dqkv in
# bf16 (the bias too, as the cast model's table gives it); K2 and K3 run on
# the bf16 tensor cores to f32 accuracy and round each result once
BF16_TOL = 1e-2  # of each output's largest value: one bf16 rounding, 2^-8
BF16 = torch.bfloat16


def bf16_check(label, got, want):
    """max |got - want| / max |want|, raised past BF16_TOL; both bf16."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= BF16_TOL * scale:
        raise AssertionError(f"{label}: max |d| {err:.3e} > {BF16_TOL} * "
                             f"{scale:.3e}")
    return err / scale


# K2's and K3's bf16 results against their plain versions element by
# element: within one bf16 ulp of the plain version's (bf16) value plus
# 3e-5.  The kernels compute to f32 accuracy and round once, as the plain
# versions do, so the two roundings differ by at most one ulp; a kernel that
# took p (and dS) in one bf16 piece misses it, and the p-rounded plain
# versions below are held to miss it.
BF16_ULP_SLACK = 3e-5


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (f32; 0 at 0)."""
    xf = x.float().abs()
    _, e = torch.frexp(xf)
    return torch.where(xf > 0, torch.ldexp(torch.ones_like(xf), e - 8),
                       torch.zeros_like(xf))


def bf16_ulp_excess(got, want):
    """max over elements of |got - want| - (ulp(want) + BF16_ULP_SLACK):
    the check passes at <= 0."""
    return ((got.float() - want.float()).abs()
            - (bf16_ulp(want) + BF16_ULP_SLACK)).max().item()


def bf16_elementwise_check(label, got, want):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    excess = bf16_ulp_excess(got, want)
    if not excess <= 0:
        raise AssertionError(f"{label}: an element is {excess:.3e} past one "
                             f"bf16 ulp + {BF16_ULP_SLACK}")
    return excess


def p_rounded_reference(qkv, bias, mask, g, heads):
    """The plain forward and backward with p (and dS) rounded to bf16
    before the products they enter, as a one-pass bf16 kernel would take
    them: (out, dqkv), bf16.  Only to show that the element-wise check
    tells the two-piece kernels from such a one."""
    w, n, c3 = qkv.shape
    q, k, v = (t.float() for t in qkv.reshape(w, n, 3, heads, -1)
               .permute(2, 0, 3, 1, 4))
    d = q.shape[-1]
    scale = d ** -0.5
    s = q @ k.transpose(-1, -2) * scale + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(w // nw, nw, heads, n, n)
             + mask[None, :, None]).reshape(w, heads, n, n)
    p = torch.softmax(s, dim=-1)
    pr = p.to(BF16).float()
    out = (pr @ v).transpose(1, 2).reshape(w, n, c3 // 3)
    gh = g.float().reshape(w, n, heads, d).transpose(1, 2)
    dp = gh @ v.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(BF16).float()
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dv = pr.transpose(-1, -2) @ gh
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(w, n, c3)
    return out.to(BF16), dqkv.to(BF16)


def sdpa_args_bf16(qkv, bias, mask, heads):
    """sdpa_args with bias + mask as a bf16 float mask (SDPA takes a mask
    of the query's dtype)."""
    q, k, v, am = sdpa_args(qkv, bias, mask, heads)
    return q, k, v, am.to(torch.bfloat16)


def sdpa_backward_bf16(qkv, bias, mask, g, heads):
    q, k, v, am = (t.detach().requires_grad_()
                   for t in sdpa_args_bf16(qkv, bias, mask, heads))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    go = g.reshape(w, n, heads, d).transpose(1, 2).reshape(out.shape)
    return lambda: torch.autograd.grad(out, (q, k, v, am), go,
                                       retain_graph=True)


def bf16_kernel_phase(card: str):
    """K2, K3 and K4 on bf16 inputs at the main path's shapes: each against
    its plain version (K2, K3 within BF16_TOL of the largest output, K4 bit
    for bit), K2 and K3 in f32 on the same inputs within 1e-3 (the f32 path
    unchanged); the kernel's, the plain version's and the library call's
    (SDPA, its backward, torch.roll, all in bf16) times cold (L2 flushed)
    and warm (K2, K3 back to back; K4 in CUDA graphs), against the bound
    with bf16 bytes.  K2's and K3's bf16 results are also held element by
    element (bf16_elementwise_check; dbias in f32 for an f32 bias within
    1e-4 of its largest), a p-rounded plain version and a backward taking
    D from the bf16-rounded output (D = g . o, the f32 route) are shown to
    fail that check, K2 with lse is held by k2_lse_check, K3 bit for bit
    over two launches, and K2's cold time is taken with and without the
    mask (the bias and mask reads through L2) and with and without lse.
    K3 reads the lse of K2's bf16 launch (base 2), as the train step
    does."""
    name, w, n, heads, d, nw, _ = K2_STAGES[0]
    bf = torch.bfloat16

    def make(i):
        qkv, bias, mask, g = k3_inputs(w, n, heads, d, nw, seed=31 + i,
                                       stage_mask=True)
        return qkv.to(bf), bias.to(bf), mask, g.to(bf)

    q16, b16, mask, g16 = make(0)
    out = {}
    err_f32 = 0.0
    q32, b32, g32 = q16.float(), b16.float(), g16.float()
    o32, lse32 = window_attention_fwd(q32, b32, mask, heads)
    for label, got, want in (
            ("k2 f32", fused_window_attention(q32, b32, mask, heads),
             attention_core_reference(q32, b32, mask, heads)),
            ("k3 f32 dqkv", window_attention_bwd(q32, b32, mask, g32,
                                                 heads, lse32, o32)[0],
             plain_bwd(q32, b32, mask, g32, heads)[0])):
        e = ((got - want).abs().max() / want.abs().max()).item()
        if not e <= 1e-3:
            raise AssertionError(f"{label} {name}: {e:.3e} > 1e-3")
        err_f32 = max(err_f32, e)
    del q32, b32, g32, o32, lse32
    o16 = fused_window_attention(q16, b16, mask, heads)
    lse_err = k2_lse_check("k2 bf16", q16, b16, mask, heads, o16)
    lse16 = window_attention_fwd(q16, b16, mask, heads)[1]
    errs = {"k2": bf16_check("k2 bf16", o16, attention_core_reference(
        q16, b16, mask, heads))}
    got = window_attention_bwd(q16, b16, mask, g16, heads, lse16)
    again = window_attention_bwd(q16, b16, mask, g16, heads, lse16)
    want = plain_bwd(q16, b16, mask, g16, heads)
    torch.cuda.synchronize()
    if not all(bitwise_equal(x, y) for x, y in zip(got, again)):
        raise AssertionError("k3 bf16: two launches differ")
    errs["k3"] = max(bf16_check(f"k3 bf16 {part}", x, y) for part, x, y in
                     zip(("dqkv", "dbias"), got, want))
    excess = {"k2": bf16_elementwise_check(
                  "k2 bf16", o16,
                  attention_core_reference(q16, b16, mask, heads)),
              "k3": bf16_elementwise_check("k3 bf16 dqkv", got[0], want[0])}
    # dbias stays f32 for an f32 bias: 1e-4 of its largest, as K3 f32
    db = window_attention_bwd(q16, b16.float(), mask, g16, heads, lse16)[1]
    want_db = plain_bwd(q16, b16.float(), mask, g16, heads)[1]
    db_err = ((db - want_db).abs().max() / want_db.abs().max()).item()
    if db.dtype != torch.float32 or not db_err <= 1e-4:
        raise AssertionError(f"k3 bf16 dbias (f32 bias): {db.dtype}, "
                             f"{db_err:.3e} of the largest > 1e-4")
    control = [bf16_ulp_excess(x, y) for x, y in zip(
        p_rounded_reference(q16, b16, mask, g16, heads),
        (attention_core_reference(q16, b16, mask, heads), want[0]))]
    # D = g . o from the stored bf16 output, where f32 takes it
    control.append(bf16_ulp_excess(plain_bwd(q16, b16, mask, g16, heads,
                                             same_sweep=False)[0], want[0]))
    if not min(control) > 0:
        raise AssertionError(f"bf16 element-wise check passes p rounded to "
                             f"bf16 or D from the bf16 output (excess "
                             f"{control})")
    log(f"bf16 k2/k3 {name}: W={w} N={n} heads={heads} d={d} nW={nw}, "
        f"bf16 in and out: k2 {errs['k2']:.3e}, k3 {errs['k3']:.3e} of the "
        f"largest <= {BF16_TOL}; element by element within one bf16 ulp + "
        f"{BF16_ULP_SLACK} (k2 excess {excess['k2']:.3e}, k3 dqkv "
        f"{excess['k3']:.3e} <= 0), k3 dbias (f32 bias) {db_err:.3e} of the "
        f"largest <= 1e-4; p rounded to bf16 fails that check (excess k2 "
        f"{control[0]:.3e}, k3 {control[1]:.3e}), and so does D from the "
        f"bf16 output (k3 {control[2]:.3e}); k2 with lse the same bit for "
        f"bit, lse {lse_err:.3e} (base 2); k3 bit for bit over "
        f"two launches; the same inputs in f32 within {err_f32:.3e} <= 1e-3 "
        f"ok")
    del got, again, want, db, want_db, o16, lse16

    call = rotating(make)
    call3 = rotating(lambda i: with_fwd(*make(i), heads))
    works = {"k2": k2_work_bf16(w, n, heads, d, nw),
             "k3": k3_work_bf16(w, n, heads, d, nw)}
    fns = {
        "k2": {"ms": call(lambda q, b, m, g: fused_window_attention(
                   q, b, m, heads)),
               "plain_ms": call(lambda q, b, m, g: attention_core_reference(
                   q, b, m, heads)),
               # yardstick only: the one PyTorch call for the same function
               "library_ms": rotating(lambda i: sdpa_args_bf16(
                   *make(i)[:3], heads))(sdpa)},
        "k3": {"ms": call3(lambda q, b, m, g, lse, o: window_attention_bwd(
                   q, b, m, g, heads, lse)),
               "plain_ms": call3(lambda q, b, m, g, lse, o:
                                 window_attention_bwd_reference(
                                     q, b, m, g, heads, lse)),
               "library_ms": rotating(lambda i: (sdpa_backward_bf16(
                   *make(i), heads),))(lambda f: f())}}
    labels = {"ms": "kernel", "plain_ms": "plain", "library_ms": "library"}
    for key in ("k2", "k3"):
        cold = in_turns(fns[key], reps=10, timer=cold_ms)
        warm = in_turns(fns[key], reps=10)
        nbytes = works[key][1]
        bd = bound(card, *works[key])
        for label, t in (("cold", cold), ("warm", warm)):
            log(f"bf16 {key} {name} timing ({label}) on {card}: "
                + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in t.items())
                + f"; {nbytes / 1e6:.1f} MB; {bound_text(bd)}; kernel "
                f"at {bd['bound_ms'] / t['ms'] * 100:.1f}% of the bound")
        out[key] = {**cold, "warm": warm, "bound_ms": bd["bound_ms"],
                    "bound_by": bd["bound_by"], "max_abs_err": errs[key],
                    "ulp_excess": excess[key], "shape": [w, n, heads, d, nw]}
    out["k2"]["lse_bound_ms"] = bound(card, *k2_work_bf16(
        w, n, heads, d, nw, lse=True))["bound_ms"]
    out["k2"]["lse_max_abs_err"] = lse_err
    out["k3"]["dbias_f32_rel_err"] = db_err
    (out["k2"]["p_rounded_excess"], out["k3"]["p_rounded_excess"],
     out["k3"]["d_from_bf16_output_excess"]) = control
    # the mask's share: the same kernel on the same windows without it
    unmasked = rotating(lambda i: make(i)[:2])
    masks = in_turns({
        "masked": call(lambda q, b, m, g: fused_window_attention(q, b, m,
                                                                 heads)),
        "unmasked": unmasked(lambda q, b: fused_window_attention(q, b, None,
                                                                 heads))},
        reps=10, timer=cold_ms)
    out["k2"]["unmasked_ms"] = masks["unmasked"]
    log(f"bf16 k2 {name} with and without the mask (cold) on {card}: "
        f"{masks['masked']:.4f} / {masks['unmasked']:.4f} ms")
    del call, call3, fns, unmasked
    # what writing lse costs K2 (the train step's launch against the served
    # one), in both instantiations: cold, in turns
    out["k2"]["lse_cost"] = {}
    for dtype in (torch.float32, bf):
        def make_fwd(i, dtype=dtype):
            q, b, m, _ = make(i)
            return q.to(dtype), b, m

        call = rotating(make_fwd)
        fns = {"without": call(lambda q, b, m: fused_window_attention(
                   q, b, m, heads)),
               "with": call(lambda q, b, m: window_attention_fwd(q, b, m,
                                                                 heads))}
        key = "bf16" if dtype == bf else "f32"
        # cold as the step finds its inputs; warm in CUDA graphs, where
        # the host's dispatch of either call cannot reach the timing
        cost = {"cold": in_turns(fns, reps=40, timer=cold_ms),
                "graph": in_turns(fns, reps=20, timer=graph_ms)}
        out["k2"]["lse_cost"][key] = cost
        log(f"k2 {key} {name} with and without lse on {card}: "
            + "; ".join(f"{label} {t['with']:.4f} / {t['without']:.4f} ms "
                        f"({(t['with'] / t['without'] - 1) * 100:+.2f} %)"
                        for label, t in cost.items()))
        del call, fns

    shape = K4_STAGES["stage0"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    x = torch.randn(shape, generator=g, device=DEVICE).to(bf)
    for shifts in ((0, 3, 3), (0, -3, -3)):
        if not torch.equal(circular_roll(x, shifts).view(torch.int16),
                           roll_reference(x, shifts).view(torch.int16)):
            raise AssertionError(f"bf16 k4 {shape} {shifts}: differs from "
                                 "torch.roll")
    del x

    def make4(i):
        gi = torch.Generator(device=DEVICE).manual_seed(300 + i)
        return (torch.randn(shape, generator=gi, device=DEVICE).to(bf),)

    call = rotating(make4)
    fns = {"ms": call(lambda x: circular_roll(x, (0, 3, 3))),
           "plain_ms": call(lambda x: roll_reference(x, (0, 3, 3))),
           "library_ms": call(lambda x: torch.roll(x, (-3, -3), (2, 3)))}
    cold = in_turns(fns, reps=20, timer=cold_ms)
    warm = in_turns(fns, reps=20, timer=graph_ms)
    nbytes = 2 * 2 * int(np.prod(shape))
    bd = bound(card, 0, nbytes)
    for label, t in (("cold", cold), ("warm", warm)):
        log(f"bf16 k4 stage0 {shape} timing ({label}) on {card}: "
            + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in t.items())
            + f"; {nbytes / 1e6:.1f} MB; bound {bd['bound_ms']:.4f} ms "
            f"(bytes); kernel at {bd['bound_ms'] / t['ms'] * 100:.1f}% of "
            "the bound")
    log(f"bf16 k4 stage0: bit for bit equal to torch.roll, both signs ok")
    out["k4"] = {**cold, "warm": warm, "bound_ms": bd["bound_ms"],
                 "bound_by": "bytes", "max_abs_err": 0.0,
                 "shape": list(shape), "shifts": [0, 3, 3]}
    del call, fns
    return out


def kernel_breakdown(fn, reps: int = 5, split_conv: bool = False):
    """Device time per call of fn() by kernel family (torch.profiler);
    `split_conv` files cuDNN's convs under forward, dgrad and wgrad."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    families, top = {}, []
    for e in prof.key_averages():
        if (e.self_cpu_time_total > 0 or e.self_device_time_total <= 0
                or getattr(e, "is_user_annotation", False)):
            continue  # host-side rows and ranges such as Optimizer.step's
        name = e.key.lower()
        # cuDNN's implicit-GEMM convs are named "...fprop_implicit_gemm...",
        # their backward "...dgrad..." and "...wgrad..."; its Winograd and
        # FFT convs run "winograd..." and "fft..." kernels and complex
        # ("cf32") GEMMs
        family = ("framed_conv1d (K1)" if "framed_conv1d" in name
                  else "roll (K4)" if "roll_kernel<" in name
                  else "window_attention_bwd (K3)"
                  if "window_attention_bwd" in name or "sum_groups" in name
                  else "window_attention (K2)" if "window_attention" in name
                  else "Adam (multi-tensor)" if "multi_tensor" in name
                  # cuDNN's RNN kernels (RNN_blockPersist..., LSTM_/GRU_
                  # elementWise..., elemWiseRNNcell); its recurrent GEMMs
                  # land under gemm
                  else "RNN cells (cuDNN)" if any(
                      k in name for k in ("rnn", "lstm", "gru_"))
                  else "GroupNorm" if any(k in name for k in (
                      "group_norm", "groupnorm", "rowwisemoments",
                      "computefusedparams"))
                  else "cuDNN conv"
                  if any(k in name for k in ("fprop", "dgrad", "wgrad",
                                             "conv", "winograd", "fft",
                                             "cf32"))
                  # torch._int_mm's int8 GEMMs (w8a8 serving)
                  else "int8 GEMM (w8a8)" if any(
                      k in name for k in ("s8s8", "_s8", "i8i8", "imma",
                                          "int8", "i8816", "i8832"))
                  and any(k in name for k in ("gemm", "nvjet", "xmma"))
                  # cuBLAS's bf16 GEMMs on Hopper are "nvjet_..." kernels
                  else "gemm (Linear, fusion attention)" if any(
                      k in name for k in ("gemm", "nvjet"))
                  else "BatchNorm (cuDNN)" if "batch_norm" in name
                  or "bn_" in name
                  else "max pool" if "max_pool" in name
                  else "LayerNorm" if "layer_norm" in name
                  else "roll, copies, pads, concat" if any(
                      k in name for k in ("roll", "copy", "pad", "cat"))
                  else "other elementwise, GELU, reductions")
        if split_conv and family == "cuDNN conv":
            family = ("cuDNN conv dgrad" if "dgrad" in name
                      else "cuDNN conv wgrad" if "wgrad" in name
                      else "cuDNN conv forward")
        families[family] = (families.get(family, 0.0)
                            + e.self_device_time_total / reps / 1e3)
        top.append((e.self_device_time_total / reps / 1e3, e.key[:72]))
    log("top kernels (ms per call): " + "; ".join(
        f"{k} {v:.4f}" for v, k in sorted(top, reverse=True)[:8]))
    return families


def full_batch(cfg, modalities, n: int, seed: int):
    """A full-width batch: zero-padded text tails and, past two rows, one
    absent row."""
    g = torch.Generator().manual_seed(seed)
    data = {}
    if "audio" in modalities:
        data["audio"] = torch.randn((n, cfg["audio_samples"]), generator=g) * 0.1
    if "text" in modalities:
        text = torch.randn((n, cfg["text_tokens"], cfg["hidden_size"]),
                           generator=g)
        for i in range(0, n, 3):
            text[i, 20 + i:] = 0.0  # zero-padded (masked) token rows
        data["text"] = text
    if "video" in modalities:
        size = cfg["video_size"]
        data["video"] = torch.randn((n, cfg["video_frames"], size, size, 3),
                                    generator=g)
    present = torch.ones(n)
    if n > 2:
        present[-1] = 0.0  # absent row: every token masked
    return {m: {"data": d, "present": present} for m, d in data.items()}


def to_device(tree, device):
    """Nested dicts of tensors, moved to `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def seeded_model(cfg, modalities):
    """The seeded model with non-trivial BatchNorm statistics and LayerNorm
    parameters.  With the initial LayerNorm (weight 1, bias 0) every token
    of the Swin tower's mean-pooled output sums to ~1e-6, and the fusion
    masks a token whose features sum to exactly 0: rounding would decide."""
    return randomize_norms(seeded_init_(
        build_model(MultimodalConfig(**cfg), modalities), SEED))


@torch.no_grad()
def randomize_norms(model):
    """Seeded random BatchNorm statistics and LayerNorm parameters, in
    place; returns the model in eval mode."""
    g = torch.Generator().manual_seed(SEED + 1)
    for m in model.modules():
        if isinstance(m, BatchNorm1d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g)
                                 * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g)
                                + 0.5)
        elif isinstance(m, torch.nn.LayerNorm):
            m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape, generator=g))
            m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    return model.eval()


def parity_phase(label, cfg, modalities, n: int):
    """(a) The same seeded model on the card and on the CPU: each tower's
    features and the logits."""
    model = seeded_model(cfg, modalities)
    gpu = copy.deepcopy(model).to(DEVICE)
    batch = full_batch(cfg, modalities, n, SEED + 2)

    def run(m, b):  # PhysVerbModel.forward, keeping the features
        feats = m.extract_features(b)
        return feats, m.classifier(m.fusion(feats))

    with torch.inference_mode():
        t0 = time.monotonic()
        want_feats, want = run(model, batch)
        cpu_s = time.monotonic() - t0
        got_feats, got = run(gpu, to_device(batch, DEVICE))
        torch.cuda.synchronize()
    for h in want:
        if got[h].shape != (n, 2) or not torch.isfinite(got[h]).all():
            raise AssertionError(f"head {h}: bad logits {got[h].shape}")
    err = max((got[h].cpu() - want[h]).abs().max().item() for h in want)
    feat_err = {m: (got_feats[m].cpu() - want_feats[m]).abs().max().item()
                for m in want_feats}
    if err > 1e-3 or max(feat_err.values()) > 1e-3:
        raise AssertionError(f"{label}: GPU vs CPU logits differ by {err:.3e}, "
                             f"features by {feat_err} (limit 1e-3)")
    scale = max(want[h].abs().max().item() for h in want)
    log(f"slice {label} parity: b{n} full width, cuda vs cpu max |dlogit| "
        f"{err:.3e} <= 1e-3 ok (max |logit| {scale:.3e}); max |dfeature| "
        + ", ".join(f"{m} {e:.3e}" for m, e in feat_err.items())
        + f"; cpu forward {cpu_s:.2f} s")
    return err


def _http(srv, path, body=None, ctype="application/json"):
    host, port = srv.server_address[:2]
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _check_scores(got, n):
    for head in ("phys", "verb"):
        probs = np.asarray(got[head])
        if probs.shape != (n, 2) or not np.isfinite(probs).all():
            raise AssertionError(f"{head}: bad scores shape {probs.shape}")
        if np.abs(probs.sum(1) - 1.0).max() > 1e-3:  # rounded to 4 dp
            raise AssertionError(f"{head}: probabilities do not sum to 1")


def request(rng, cfg, modalities, n: int, short: bool = False):
    """{modality: (n, ...)} float32 clips; `short` clips are padded by the
    server (5/8 of the samples, half the tokens, 12 frames)."""
    out = {}
    if "audio" in modalities:
        length = cfg["audio_samples"] * 5 // 8 if short else cfg["audio_samples"]
        out["audio"] = rng.standard_normal((n, length)) * 0.1
    if "text" in modalities:
        tokens = cfg["text_tokens"] // 2 if short else cfg["text_tokens"]
        out["text"] = rng.standard_normal((n, tokens, cfg["hidden_size"]))
    if "video" in modalities:
        size = cfg["video_size"]
        frames = 12 if short else cfg["video_frames"]
        out["video"] = rng.standard_normal((n, frames, size, size, 3))
    return {m: a.astype(np.float32) for m, a in out.items()}


def _npz(arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def serving_phase(srv, label, cfg, modalities, per_forward):
    """(b) Drive the main path: /score over HTTP, JSON and npz."""
    rng = np.random.default_rng(SEED + 3)
    batch_size = srv.predictor.batch_size
    short = json.dumps({m: a[0].round(4).tolist() for m, a in request(
        rng, cfg, modalities, 1, short=True).items()}).encode()
    # a batch larger than the fixed size: chunked into batch_size + the rest
    n_big = batch_size + batch_size // 4
    big = _npz(request(rng, cfg, modalities, n_big))
    singles = [_npz({m: a[0] for m, a in request(rng, cfg, modalities,
                                                 1).items()})
               for _ in range(4)]

    dispatches0 = _http(srv, "/statz")["model"]["dispatches"]
    kernels.launch_counts.clear()  # count this path only
    _check_scores(_http(srv, "/score", short), 1)
    _check_scores(_http(srv, "/score", big, "application/x-npz"), n_big)
    # concurrent single clips, coalesced by the micro-batcher
    results = [None] * len(singles)

    def hit(i):
        results[i] = _http(srv, "/score", singles[i], "application/x-npz")

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(singles))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    for r in results:
        _check_scores(r, 1)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the main path
    stats = _http(srv, "/statz")["model"]
    dispatches = stats["dispatches"] - dispatches0
    if dispatches < 3:
        raise AssertionError(f"/statz dispatches advanced by {dispatches}")
    for name in set(per_forward) | set(counts):
        want = per_forward.get(name, 0) * dispatches
        if counts.get(name, 0) != want:
            raise AssertionError(
                f"{label}: {name} launched {counts.get(name, 0)} times in "
                f"{dispatches} served forwards, want {want}")
    log(f"slice {label} serving: 6 requests (JSON 1 short clip, npz {n_big} "
        f"clips, 4 concurrent npz clips) -> {dispatches} forwards, launches "
        f"{counts}, mean group {stats.get('mean_group_size')} ok")
    return counts


def throughput_phase(srv, label, cfg, modalities, card_line):
    """(c) Predictor.predict at the served batch, the forward by tower and
    by kernel family, and MicroBatcher single-clip p50."""
    pred, batcher = srv.predictor, srv.batcher
    gpu, batch_size = pred.model, pred.batch_size
    rng = np.random.default_rng(SEED + 4)
    req = request(rng, cfg, modalities, batch_size)
    host_mb = sum(a.nbytes for a in req.values()) / 1e6
    for _ in range(2):
        pred.predict(req)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(req)  # ends in a device-to-host copy of the scores
    secs = time.perf_counter() - t0
    clips_s = batch_size * reps / secs

    on_card = to_device(full_batch(cfg, modalities, batch_size, SEED + 5),
                        DEVICE)
    towers = {}
    with torch.inference_mode():
        fwd = cuda_ms(lambda: gpu(on_card), reps=reps)
        for m, ext in gpu.extractors.items():
            if not isinstance(ext, IdentityExtractor):
                towers[m] = cuda_ms(lambda: ext(on_card[m]["data"]), reps=reps)
        trunk = cuda_ms(lambda: gpu.extractors["audio"].extractor(
            on_card["audio"]["data"]), reps=reps)
        feats = gpu.extract_features(on_card)
        rest = cuda_ms(lambda: gpu.classifier(gpu.fusion(feats)), reps=reps)
        families = kernel_breakdown(lambda: gpu(on_card), reps=3)
    busy = sum(families.values())
    log(f"slice {label} forward kernels by family (b{batch_size}, ms per "
        "forward): " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / fwd * 100:.1f}% of the "
        f"{fwd:.3f} ms forward, the rest is the card idle between launches")
    lat = []
    clip = {k: v[:1] for k, v in req.items()}
    for _ in range(20):
        t1 = time.perf_counter()
        batcher.submit(clip).result(timeout=120)
        lat.append((time.perf_counter() - t1) * 1e3)
    p50 = float(np.median(lat))
    log(f"slice {label} throughput on {card_line}: Predictor.predict "
        f"b{batch_size} {clips_s:.1f} clips/s ({secs / reps * 1e3:.3f} "
        f"ms/batch incl. host pad + {host_mb:.1f} MB pageable copy); device "
        f"forward b{batch_size} {fwd:.3f} ms = "
        + " + ".join(f"{m} tower {t:.3f} ms" + (
            f" (CNN1D trunk {trunk:.3f} ms)" if m == "audio" else "")
            for m, t in towers.items())
        + f" + fusion/adaptors/heads {rest:.3f} ms; MicroBatcher "
        f"single-clip p50 {p50:.3f} ms "
        f"(max_delay_ms {batcher.max_delay * 1e3:.1f}, 20 sequential)")
    return {"predict_clips_per_s": clips_s, "predict_ms": secs / reps * 1e3,
            "forward_ms": fwd, "tower_ms": towers,
            "fusion_heads_ms": rest, "kernel_ms_by_family": families,
            "kernel_busy_pct": busy / fwd * 100, "p50_ms": p50}


def run_slice(label, cfg, batch_size, parity_n, per_forward, card_line):
    modalities = tuple(sorted(label.split(",")))
    err = parity_phase(label, cfg, modalities, parity_n)
    srv = build_server(ServeConfig(**cfg, modalities=label,
                                   batch_size=batch_size, device=DEVICE,
                                   allow_random_weights=True, port=0,
                                   seed=SEED))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        counts = serving_phase(srv, label, cfg, modalities, per_forward)
        numbers = throughput_phase(srv, label, cfg, modalities, card_line)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=60)
    log(json.dumps({"slice": label, "batch": batch_size,
                    "parity_max_abs_logit_err": err, "launches": counts,
                    **numbers}))
    return counts


# the train path: the tri-modal model fine-tuned at full width, batch 8
TRAIN = dict(TRIMODAL, batch_size=8)
TRAIN_DATA = dict(num_clusters=4, samples_per_cluster=12, seed=SEED,
                  audio_len=TRAIN["audio_samples"],
                  text_len=TRAIN["text_tokens"],
                  video_frames=TRAIN["video_frames"],
                  video_hw=TRAIN["video_size"])
# launches per train step, by presence pattern (remat on: K2 runs again in
# each block's recompute)
PER_PATTERN = {"video": {"window_attention": 24, "window_attention_bwd": 12,
                         "roll": 12},
               "audio,text": {"framed_conv1d": 1},
               "audio,text,video": {"framed_conv1d": 1,
                                    "window_attention": 24,
                                    "window_attention_bwd": 12, "roll": 12}}


def bf16_counts(counts):
    """`counts` with K2, K3 and K4 under their bf16 instantiations' keys
    (kernels.launch_key): what a bf16 path launches where the f32 path
    launches `counts`.  K1 stays f32, cast around the kernel."""
    return {k if k == "framed_conv1d" else kernels.launch_key(
        k, torch.bfloat16): v for k, v in counts.items()}
SPECS = {"phys": LossSpec("focal", class_weights=(0.5, 0.5), gamma=2.0),
         "verb": LossSpec("ce")}


def grad_parity(label, cpu, gpu):
    """Every gradient of `gpu`'s trainable parameters against `cpu`'s,
    each within 1e-3 * max|g| of that tensor; returns the worst ratio."""
    worst, count = 0.0, 0
    gpu_params = dict(gpu.named_parameters())
    for name, p in cpu.named_parameters():
        if not p.requires_grad:
            continue
        want, got = p.grad, gpu_params[name].grad
        if want is None or got is None:
            raise AssertionError(f"{label} parity: {name} has no gradient")
        scale = want.abs().max().item()
        err = (got.cpu() - want).abs().max().item()
        if not err <= 1e-3 * scale:
            raise AssertionError(f"{label} parity: {name} gradient differs by "
                                 f"{err:.3e} > 1e-3 * {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
        count += 1
    return worst, count


def train_parity(n: int = 1, frames: int = 16):
    """The loss and every gradient of one batch of the full-width model,
    unfrozen, eval mode (deterministic), on the card against the CPU:
    each within 1e-3 * max|g| of that tensor."""
    cfg = dict(TRIMODAL, video_frames=frames, video_freeze=False)
    modalities = ("audio", "text", "video")
    cpu = seeded_model(cfg, modalities)
    gpu = copy.deepcopy(cpu).to(DEVICE)
    data = full_batch(cfg, modalities, n, SEED + 6)
    batch = {"modalities": data,
             "labels": {"phys": torch.ones(n, dtype=torch.int32),
                        "verb": torch.zeros(n, dtype=torch.int32)},
             "label_mask": {"phys": torch.ones(n), "verb": torch.ones(n)}}
    losses = {}
    for name, model, b in (("cpu", cpu, batch),
                           ("cuda", gpu, to_device(batch, DEVICE))):
        total, _ = head_losses_and_metrics(model(b["modalities"]), b, SPECS, 2)
        total.backward()
        losses[name] = total.item()
    loss_err = abs(losses["cuda"] - losses["cpu"])
    if not loss_err <= 1e-3 * abs(losses["cpu"]):
        raise AssertionError(f"train parity: loss cuda {losses['cuda']} vs "
                             f"cpu {losses['cpu']}")
    worst, count = grad_parity("train", cpu, gpu)
    log(f"train parity: b{n} {frames} frames full width, unfrozen, loss cuda "
        f"{losses['cuda']:.6f} vs cpu {losses['cpu']:.6f}; {count} "
        f"gradients, worst max |d| / max |g| {worst:.3e} <= 1e-3 ok")
    return {"loss_err": loss_err, "grad_rel_err": worst}


def finetune_args(tmp, root, run_name="r", *extra):
    """cli.train_multimodal's arguments for the tri-modal fine-tune at
    full width (TRAIN), 2 epochs, on the synthetic set at `root`."""
    args = ["--dataset_root", root, "--synthetic",
            "--saving_dir", os.path.join(tmp, "runs"), "--run_name", run_name,
            "--modalities", "audio,text,video", "--video_freeze", "false",
            *extra, "--epoch_num", "2", "--device", DEVICE,
            "--num_threads", "4"]
    for k in ("hidden_size", "fusion_layers", "fusion_heads",
              "audio_samples", "text_tokens", "video_frames", "video_size",
              "video_window", "batch_size"):
        args += [f"--{k}", str(TRAIN[k])]
    return args


def step_counts(trainer, batch):
    """Launch counts of one train step on `batch`, reset just before."""
    torch.cuda.synchronize()
    kernels.launch_counts.clear()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    return dict(kernels.launch_counts)


def median_step_ms(trainer, batch, steps: int = 6, warm: int = 2):
    """Median device time of one train step (CUDA events) and the peak
    device memory over those steps."""
    for _ in range(warm):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.train_step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), torch.cuda.max_memory_allocated() / 2**30


def train_phase(card_line):
    """Fine-tune the tri-modal model through cli.train_multimodal.main, at
    full width, b8, 2 epochs on a synthetic set; check its outputs, the
    launches per presence pattern, card-vs-CPU gradients; time the step."""
    import pandas as pd

    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    parity = train_parity()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        root = os.path.join(tmp, "avabos")
        generate_synthetic_avabos(root, **TRAIN_DATA)
        data_s = time.monotonic() - t0
        args = finetune_args(tmp, root)
        torch.cuda.synchronize()
        kernels.launch_counts.clear()  # count this path only
        t0 = time.monotonic()
        trainer = train_multimodal.main(args)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)  # read just after the main path
        fit_s = time.monotonic() - t0
        steps = trainer.state.step
        video_steps = counts.get("window_attention_bwd", 0) // 12
        if steps < 6 or video_steps < 3:
            raise AssertionError(f"train: {steps} steps, {video_steps} with "
                                 "video (want >= 6 and >= 3)")
        swin = trainer.state.model.extractors["video"].backbone.backbone
        embeds = swin.patch_embed.calls  # the patch GEMM, once a forward
        if embeds < video_steps:
            raise AssertionError(f"train: the patch GEMM ran {embeds} times "
                                 f"in {video_steps} video steps")
        files = set(os.listdir(trainer.run_dir))
        need = {"checkpoint_current", "checkpoint_best_phys",
                "checkpoint_best_verb", "config.json"} | {
            f"{h}_{s}_log.csv" for h in ("phys", "verb")
            for s in ("train", "test")}
        if not need <= files:
            raise AssertionError(f"train: missing {sorted(need - files)}")
        logs = {f: pd.read_csv(os.path.join(trainer.run_dir, f))
                for f in need if f.endswith("_log.csv")}
        for f, df in logs.items():
            if df["epoch"].tolist() != [0, 1] or not np.isfinite(
                    df["loss"]).all():
                raise AssertionError(f"train: {f} holds {df.to_dict()}")
        clips_s = [float(v) for v in
                   logs["verb_train_log.csv"]["clips_per_sec"]]
        log(f"train main path: cli.train_multimodal.main, 2 epochs, {steps} "
            f"steps ({video_steps} with video), launches {counts}; data set "
            f"made in {data_s:.1f} s, fit {fit_s:.1f} s; epoch clips/s "
            f"{clips_s} (epoch 0 includes the first step's set-up)")

        # one step of each presence pattern, launches reset around it
        patterns = {}
        for batch in trainer.batches(trainer.train_loader):
            key = ",".join(sorted(batch["modalities"]))
            patterns.setdefault(key, batch)
        if sorted(patterns) != sorted(PER_PATTERN):
            raise AssertionError(
                f"train: presence patterns {sorted(patterns)}")
        per_pattern = {}
        for key, batch in sorted(patterns.items()):
            got = step_counts(trainer, batch)
            if got != PER_PATTERN[key]:
                raise AssertionError(f"train: a {key} step launched {got}, "
                                     f"want {PER_PATTERN[key]}")
            per_pattern[key] = got
        log(f"train launches per step by pattern: {per_pattern} ok")

        batch = patterns["audio,text,video"]
        timing = {}
        for remat in (True, False):
            swin.remat = remat
            timing[remat] = median_step_ms(trainer, batch)
        swin.remat = True
        families = kernel_breakdown(lambda: trainer.train_step(batch), reps=2)
        scored = {"evaluate": evaluate_phase(trainer.run_dir, card_line),
                  "predict": predict_phase(trainer.run_dir, tmp, card_line)}
        scored.update(exported_scoring_phase(trainer.run_dir, tmp,
                                             card_line))
        scored["train_bf16"], _ = bf16_train_phase(args, trainer, batch,
                                                   timing, card_line)
    busy = sum(families.values())
    (on_ms, on_gb), (off_ms, off_gb) = timing[True], timing[False]
    attention = attention_family_ms(families, on_ms,
                                    "train step (remat on)")
    log(f"train step b8 (audio,text,video, 128 frames at 112 px) on "
        f"{card_line}: median {on_ms:.3f} ms, peak {on_gb:.2f} GiB with "
        f"remat; {off_ms:.3f} ms, peak {off_gb:.2f} GiB without")
    log("train step kernels by family (ms per step, remat on): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / on_ms * 100:.1f}% of the "
        f"{on_ms:.3f} ms step")
    log(json.dumps({"train": "audio,text,video", "batch": TRAIN["batch_size"],
                    "video_freeze": False, "steps": steps,
                    "launches": counts, "launches_per_pattern": per_pattern,
                    "patch_embed_calls": embeds,
                    "step_ms_remat": on_ms, "step_ms_no_remat": off_ms,
                    "peak_gib_remat": on_gb, "peak_gib_no_remat": off_gb,
                    "epoch_clips_per_s": clips_s,
                    "kernel_ms_by_family": families, **attention,
                    "kernel_busy_pct": busy / on_ms * 100,
                    **parity}))
    return counts, scored


def check_logs(run_dir, heads, epochs, label):
    """Each head's train and test logs hold `epochs` rows of finite
    losses; returns {log name: DataFrame}."""
    import pandas as pd

    logs = {}
    for h in heads:
        for split in ("train", "test"):
            f = f"{h}_{split}_log.csv"
            df = pd.read_csv(os.path.join(run_dir, f))
            if df["epoch"].tolist() != list(range(epochs)) or not np.isfinite(
                    df["loss"]).all():
                raise AssertionError(f"{label}: {f} holds {df.to_dict()}")
            logs[f] = df
    return logs


def state_dtypes_f32(state, label):
    """Master parameters, their gradients, the optimizer's floating state
    and every buffer (BatchNorm's statistics) are f32."""
    for name, p in state.model.named_parameters():
        if p.dtype != torch.float32 or (p.grad is not None
                                        and p.grad.dtype != torch.float32):
            raise AssertionError(f"{label}: {name} is {p.dtype}")
    for st in state.optimizer.inner.state.values():
        for v in st.values():
            if v.is_floating_point() and v.dtype != torch.float32:
                raise AssertionError(f"{label}: optimizer state {v.dtype}")
    for name, b in state.model.named_buffers():
        if b.is_floating_point() and b.dtype != torch.float32:
            raise AssertionError(f"{label}: buffer {name} is {b.dtype}")


def attention_family_ms(families, total_ms, label):
    """K2's and K3's device ms by the profiler's families, logged beside
    the step's or forward's total."""
    k2 = families.get("window_attention (K2)", 0.0)
    k3 = families.get("window_attention_bwd (K3)", 0.0)
    log(f"{label}: K2 {k2:.4f} ms, K3 {k3:.4f} ms of {total_ms:.3f} ms")
    return {"k2_ms": k2, "k3_ms": k3}


def bf16_train_phase(args, trainer32, batch, timing32, card_line):
    """The tri-modal fine-tune with --compute_dtype bfloat16: 2 epochs of
    cli.train_multimodal.main on the f32 run's data set and config, its
    launches per step (K1 1, K2 24, K3 12, K4 12 with remat), the median
    step time and peak memory with remat on and off (JAX's tuned
    configuration: --video_remat false --compute_dtype bfloat16), the
    kernel families; one bf16 step against one f32 step on the same
    weights (the runs' seeded initial model) and batch: the loss within
    5 % (tests/test_precision.py:168), master state f32."""
    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        train_step)

    args = list(args) + ["--compute_dtype", "bfloat16"]
    args[args.index("--run_name") + 1] = "r_bf16"
    torch.cuda.synchronize()
    kernels.launch_counts.clear()  # count this path only
    t0 = time.monotonic()
    trainer = train_multimodal.main(args)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the main path
    fit_s = time.monotonic() - t0
    swin_kernels = ("window_attention", "window_attention_bwd", "roll")
    if (not counts.get("framed_conv1d")
            or any(counts.get(k) for k in swin_kernels)
            or not all(counts.get(kernels.launch_key(k, torch.bfloat16))
                       for k in swin_kernels)):
        raise AssertionError(f"train bf16: the fit launched {counts}, want "
                             "K1 and the bf16 K2, K3 and K4 only")
    logs = check_logs(trainer.run_dir, ("phys", "verb"), 2, "train bf16")
    per_step = step_counts(trainer, batch)
    want = bf16_counts(PER_PATTERN["audio,text,video"])
    if per_step != want:
        raise AssertionError(f"train bf16: a tri-modal step launched "
                             f"{per_step}, want {want}")
    swin = trainer.state.model.extractors["video"].backbone.backbone
    timing = {}
    for remat in (True, False):
        swin.remat = remat
        timing[remat] = median_step_ms(trainer, batch)
    swin.remat = True
    families = kernel_breakdown(lambda: trainer.train_step(batch), reps=2)
    busy = sum(families.values())
    attention = attention_family_ms(families, timing[True][0],
                                    "train bf16 step (remat on)")
    state_dtypes_f32(trainer.state, "train bf16")

    losses = {}
    initial = seeded_init_(build_model(
        MultimodalConfig(**TRAIN, video_freeze=False),
        ("audio", "text", "video")), SEED)
    for dtype in (None, torch.bfloat16):
        st = create_train_state(copy.deepcopy(initial),
                                OptimizerConfig(learning_rate=1e-3), DEVICE)
        set_generator(st.model, torch.Generator(DEVICE).manual_seed(SEED))
        losses[dtype] = train_step(st, batch, trainer32.loss_specs, 2,
                                   compute_dtype=dtype)["total_loss"].item()
        state_dtypes_f32(st, "train bf16 parity")
        del st
    rel = abs(losses[torch.bfloat16] - losses[None]) / abs(losses[None])
    if not rel <= 0.05:
        raise AssertionError(f"train bf16: loss {losses} differs by {rel}")
    (on_ms, on_gb), (off_ms, off_gb) = timing[True], timing[False]
    (f_on, f_on_gb), (f_off, f_off_gb) = timing32[True], timing32[False]
    clips_s = [float(v) for v in logs["verb_train_log.csv"]["clips_per_sec"]]
    log(f"train bf16 main path: cli.train_multimodal.main --compute_dtype "
        f"bfloat16, 2 epochs, {trainer.state.step} steps, launches {counts}, "
        f"fit {fit_s:.1f} s; per tri-modal step {per_step}; loss of one "
        f"step bf16 {losses[torch.bfloat16]:.6f} vs f32 {losses[None]:.6f} "
        f"({rel * 100:.3f} % <= 5 %); master state f32 ok")
    log(f"train bf16 step b8 on {card_line}: median {on_ms:.3f} ms, peak "
        f"{on_gb:.2f} GiB with remat; {off_ms:.3f} ms, peak {off_gb:.2f} GiB "
        f"without (f32: {f_on:.3f} ms, {f_on_gb:.2f} GiB; {f_off:.3f} ms, "
        f"{f_off_gb:.2f} GiB); kernels by family (ms per step, remat on): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / on_ms * 100:.1f}% of the step")
    log(json.dumps({"train": "audio,text,video bf16",
                    "batch": TRAIN["batch_size"], "compute_dtype": "bfloat16",
                    "steps": trainer.state.step, "launches": counts,
                    "launches_per_step": per_step, "step_ms_remat": on_ms,
                    "step_ms_no_remat": off_ms, "peak_gib_remat": on_gb,
                    "peak_gib_no_remat": off_gb, "f32_step_ms_remat": f_on,
                    "f32_step_ms_no_remat": f_off,
                    "f32_peak_gib_remat": f_on_gb,
                    "f32_peak_gib_no_remat": f_off_gb,
                    "epoch_clips_per_s": clips_s,
                    "kernel_ms_by_family": families, **attention,
                    "kernel_busy_pct": busy / on_ms * 100,
                    "loss_bf16": losses[torch.bfloat16],
                    "loss_f32": losses[None], "loss_rel_diff": rel}))
    return counts, {"step_ms_remat": on_ms, "step_ms_no_remat": off_ms}


def serve_bf16_phase(card_line):
    """Predictor(compute_dtype="bfloat16") of the tri-modal model at b8
    (seeded weights): its launches per forward (K1 1, K2 12, K4 4), its
    probabilities within 0.03 of the f32 Predictor's on the card
    (tests/test_precision.py:201), and both forwards' device ms."""
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    modalities = ("audio", "text", "video")
    model = seeded_model(TRIMODAL, modalities)
    batch = full_batch(TRIMODAL, modalities, 8, SEED + 3)
    request = {m: v["data"].numpy() for m, v in batch.items()}
    p32 = Predictor(copy.deepcopy(model), batch_size=8, device=DEVICE)
    p16 = Predictor(model, batch_size=8, device=DEVICE,
                    compute_dtype="bfloat16")
    want = p32.predict(request)
    p16.predict(request)  # first call: the constants and the casts' set-up
    torch.cuda.synchronize()
    kernels.launch_counts.clear()  # count this path only
    got = p16.predict(request)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the path
    expect = bf16_counts({"framed_conv1d": 1, "window_attention": 12,
                          "roll": 4})
    if counts != expect:
        raise AssertionError(f"serve bf16: a forward launched {counts}, "
                             f"want {expect}")
    err = max(float(np.abs(got[h] - want[h]).max()) for h in want)
    if not err <= 0.03 or any(got[h].dtype != np.float32 for h in got):
        raise AssertionError(f"serve bf16: probabilities differ by {err}")
    padded = p16._pad_batch(request, 8)
    ms = {"f32": cuda_ms(lambda: p32._forward(padded), reps=10),
          "bf16": cuda_ms(lambda: p16._forward(padded), reps=10)}
    families = kernel_breakdown(lambda: p16._forward(padded), reps=3)
    attention = attention_family_ms(families, ms["bf16"],
                                    "serve bf16 tri-modal b8 forward")
    log(f"serve bf16 tri-modal b8 on {card_line}: launches {counts} ok; "
        f"max |dprob| vs the f32 card {err:.3e} <= 0.03 ok; forward "
        f"{ms['bf16']:.3f} ms (f32 {ms['f32']:.3f} ms); kernels by family: "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1])))
    log(json.dumps({"serve": "audio,text,video bf16", "batch": 8,
                    "launches": counts, "max_abs_prob_err": err,
                    "forward_ms_bf16": ms["bf16"],
                    "forward_ms_f32": ms["f32"],
                    "kernel_ms_by_family": families, **attention}))
    return counts


# the flagship trainer (ROADMAP item 11): train_multimodal --modalities
# audio,text at full width, b32, with the JAX package's production knobs
FLAGSHIP_DATA = dict(num_clusters=4, samples_per_cluster=64, seed=SEED,
                     audio_len=FLAGSHIP["audio_samples"],
                     text_len=FLAGSHIP["text_tokens"], video_frames=8,
                     video_hw=32)
FLAGSHIP_KNOBS = ["--lr_schedule", "cosine", "--warmup_steps", "2",
                  "--grad_clip_norm", "1.0", "--weight_decay", "0.01",
                  "--grad_accum_steps", "2", "--ema_decay", "0.99",
                  "--early_stop_patience", "3"]


class _RequestAt:
    """Calls guard.request() after the `at`-th train step of epoch `epoch`
    (the trainer's on_epoch_start hook tells the epoch)."""

    def __init__(self, trainer, guard, epoch: int, at: int):
        self.trainer, self.guard = trainer, guard
        self.epoch, self.at = epoch, at
        self.current, self.steps = -1, 0
        self.step = trainer.train_step
        trainer.on_epoch_start = self.on_epoch_start
        trainer.train_step = self

    def on_epoch_start(self, epoch):
        self.current, self.steps = epoch, 0

    def __call__(self, batch):
        out = self.step(batch)
        self.steps += 1
        if self.current == self.epoch and self.steps == self.at:
            self.guard.request()
        return out


def flagship_phase(card_line):
    """cli.train_multimodal --modalities audio,text at full width, b32, 2
    epochs, with a cosine schedule after a 2-step warmup, clipping at 1.0,
    AdamW (0.01), accumulation over 2 micro-batches, an EMA (0.99), early
    stopping (3), TensorBoard and the profiler: K1 once a micro-step, the
    trace file, the scalars (or the one warning without tensorboard); the
    median step time (micro-steps and updates alternate).  Then the same
    run preempted by guard.request() after the 3rd step of epoch 1 (mid
    accumulation), resumed from checkpoint_preempt: its logged losses
    within 1e-4 relative of the uninterrupted run's."""
    import glob

    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
    from multimodalaggressionrecognition_tpu_torch.cli.common import (
        parse_config, run_training)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)
    from multimodalaggressionrecognition_tpu_torch.utils.preemption import (
        PreemptionGuard)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        root = os.path.join(tmp, "avabos")
        generate_synthetic_avabos(root, **FLAGSHIP_DATA)
        data_s = time.monotonic() - t0
        base = ["--dataset_root", root, "--saving_dir",
                os.path.join(tmp, "runs"), "--modalities", "audio,text",
                "--epoch_num", "2", "--device", DEVICE, "--num_threads", "4",
                "--batch_size", "32", "--log_console", "false",
                *FLAGSHIP_KNOBS]
        for k in ("hidden_size", "fusion_layers", "fusion_heads",
                  "audio_samples", "text_tokens"):
            base += [f"--{k}", str(FLAGSHIP[k])]
        prof, tb = os.path.join(tmp, "prof"), os.path.join(tmp, "tb")
        args = base + ["--run_name", "full", "--profile_dir", prof,
                       "--tensorboard_dir", tb]
        torch.cuda.synchronize()
        kernels.launch_counts.clear()  # count this path only
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            trainer = train_multimodal.main(args)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)  # read just after the path
        fit_s = time.monotonic() - t0
        logs = check_logs(trainer.run_dir, ("verb",), 2, "train flagship")
        steps, updates = trainer.state.step, trainer.state.optimizer.updates
        eval_steps = 2 * sum(1 for _ in trainer.test_loader)
        if counts != {"framed_conv1d": steps + eval_steps} or steps < 8:
            raise AssertionError(f"train flagship: {steps} micro-steps and "
                                 f"{eval_steps} eval steps launched {counts}")
        if updates != steps // 2:
            raise AssertionError(f"train flagship: accumulation made "
                                 f"{updates} updates in {steps} micro-steps")
        ckpt = torch.load(os.path.join(trainer.run_dir, "checkpoint_current"),
                          weights_only=True)
        if abs(ckpt["ema"]["decay"] - 0.99) > 1e-12:
            raise AssertionError("train flagship: no EMA in the checkpoint")
        traces = glob.glob(os.path.join(prof, "trace_*.json"))
        events = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
        warned = out.getvalue().count("tensorboard not available")
        if len(traces) != 1 or not (events or warned == 1):
            raise AssertionError(f"train flagship: traces {traces}, events "
                                 f"{events}, warnings {warned}")
        trace_mb = os.path.getsize(traces[0]) / 1e6
        batch = next(iter(trainer.batches(trainer.train_loader)))
        one = step_counts(trainer, batch)
        if one != {"framed_conv1d": 1}:
            raise AssertionError(f"train flagship: a step launched {one}")
        step_ms, peak_gb = median_step_ms(trainer, batch)
        families = kernel_breakdown(lambda: trainer.train_step(batch), reps=4)
        busy = sum(families.values())
        clips_s = [float(v) for v in logs["verb_train_log.csv"]
                   ["clips_per_sec"]]
        log(f"train flagship main path on {card_line}: audio,text b32, 2 "
            f"epochs, {steps} micro-steps ({updates} updates), launches "
            f"{counts}; data set made in {data_s:.1f} s, "
            f"fit {fit_s:.1f} s; epoch clips/s {clips_s}; trace "
            f"{os.path.basename(traces[0])} ({trace_mb:.1f} MB); TensorBoard "
            + (f"{len(events)} event file(s)" if events else
               "not installed: one warning"))
        log(f"train flagship step b32 on {card_line}: median {step_ms:.3f} ms "
            f"(micro-steps and updates), peak {peak_gb:.2f} GiB; kernels by "
            "family (ms per step): " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(families.items(),
                                                  key=lambda kv: -kv[1]))
            + f"; sum {busy:.4f} ms = {busy / step_ms * 100:.1f}% of the step")

        cfg = parse_config(train_multimodal.MultimodalConfig,
                           base + ["--run_name", "pre"])
        first = train_multimodal.make_trainer(cfg)
        guard = PreemptionGuard(verbose=False)
        first.preemption_guard = guard
        _RequestAt(first, guard, epoch=1, at=3)
        run_training(cfg, first)
        pre_dir = first.run_dir
        if not os.path.isfile(os.path.join(pre_dir, "checkpoint_preempt")):
            raise AssertionError("train flagship: no checkpoint_preempt")
        partial = torch.load(os.path.join(pre_dir, "checkpoint_preempt"),
                             weights_only=True)["meta"]
        second = train_multimodal.make_trainer(cfg)
        run_training(cfg, second)  # resumes from checkpoint_preempt
        got = check_logs(pre_dir, ("verb",), 2, "train flagship resumed")
        gap = 0.0
        for f, df in logs.items():
            want = df["loss"].to_numpy()
            have = got[f]["loss"].to_numpy()
            gap = max(gap, float(np.max(np.abs(have - want)
                                        / np.abs(want))))
        if not gap <= 1e-4:
            raise AssertionError(f"train flagship: the resumed run's losses "
                                 f"differ by {gap:.3e} relative")
        if os.path.exists(os.path.join(pre_dir, "checkpoint_preempt")):
            raise AssertionError("train flagship: checkpoint_preempt left")
        log(f"train flagship preemption: guard.request() after step 3 of "
            f"epoch 1 -> checkpoint_preempt at epoch {partial['epoch']}, "
            f"batch {partial['batches_done']}; the resumed run's logged "
            f"losses within {gap:.3e} relative of the uninterrupted run's "
            "<= 1e-4 ok")
    log(json.dumps({"train": "audio,text flagship", "batch": 32,
                    "knobs": FLAGSHIP_KNOBS, "steps": steps,
                    "updates": updates,
                    "launches": counts, "launches_per_step": one,
                    "step_ms": step_ms, "peak_gib": peak_gb,
                    "epoch_clips_per_s": clips_s,
                    "kernel_ms_by_family": families,
                    "kernel_busy_pct": busy / step_ms * 100,
                    "trace_mb": trace_mb, "tensorboard_events": len(events),
                    "preempt_batches_done": partial["batches_done"],
                    "preempt_resume_loss_rel_gap": gap}))
    return counts


# launches per scored batch by the modalities it holds (evaluate, predict
# and generate_features run the tri-modal forward)
PER_FORWARD_MODALITY = {"audio": {"framed_conv1d": 1},
                        "video": {"window_attention": 12, "roll": 4}}
SCORED_KERNELS = ("framed_conv1d", "window_attention", "roll")
EVAL_METRICS = ("accuracy", "UAR", "UAP", "UAF1")


def expected_launches(batches):
    """Launches of one forward per batch, `batches` their modality lists."""
    expect = {}
    for present in batches:
        for m in present:
            for k, v in PER_FORWARD_MODALITY.get(m, {}).items():
                expect[k] = expect.get(k, 0) + v
    return expect


def counted(fn):
    """(fn(), launch counts reset just before and read just after, host
    seconds); fn's standard output is swallowed (the CLIs print JSON)."""
    torch.cuda.synchronize()
    kernels.launch_counts.clear()  # count this path only
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn()
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the path
    return result, counts, time.monotonic() - t0, out.getvalue()


def evaluate_phase(run_dir, card_line):
    """cli.evaluate.main --from_run of the fine-tuned run's
    checkpoint_best_phys on the card: each head's accuracy, UAR, UAP and
    UAF1 equal to the trainer's logged test row of that epoch (to 1e-12,
    the CSV's round trip) and its loss within 1e-4; the same call with
    --device cpu: metrics equal, loss within 1e-3; the launches against
    the test batches (K1 once with audio, K2 12 and K4 4 with video)."""
    import pandas as pd

    from multimodalaggressionrecognition_tpu_torch.cli import (
        evaluate, train_multimodal)
    from multimodalaggressionrecognition_tpu_torch.cli.common import (
        ensure_dataset)
    from multimodalaggressionrecognition_tpu_torch.io.checkpoint import (
        restore_variables)

    ckpt = os.path.join(run_dir, "checkpoint_best_phys")
    epoch = int(restore_variables(ckpt)[1]["epoch"])
    args = ["--from_run", run_dir, "--path_to_checkpoint", ckpt,
            "--saving_dir", os.path.join(run_dir, "evaluate"),
            "--num_threads", "4"]
    cfg = evaluate.parse_config(evaluate.EvalConfig, args)
    _, test_loader = train_multimodal.make_loaders(
        cfg, *ensure_dataset(cfg), tuple(cfg.modalities.split(",")))
    test = [(sorted(b["modalities"]), int(b["sample_mask"].sum()))
            for b in test_loader]
    clips = sum(n for _, n in test)
    expect = expected_launches([m for m, _ in test])
    got, counts, card_s, _ = counted(lambda: evaluate.main(
        args + ["--device", DEVICE]))
    if counts != expect or not all(expect.get(k) for k in SCORED_KERNELS):
        raise AssertionError(f"evaluate: {len(test)} test batches launched "
                             f"{counts}, want {expect}")
    cpu, _, cpu_s, _ = counted(lambda: evaluate.main(args + ["--device",
                                                            "cpu"]))
    if sorted(got) != ["phys", "verb"] or sorted(cpu) != sorted(got):
        raise AssertionError(f"evaluate: heads {sorted(got)}, cpu "
                             f"{sorted(cpu)}")
    errs = {}
    for head in got:
        df = pd.read_csv(os.path.join(run_dir, f"{head}_test_log.csv"))
        row = df[df["epoch"] == epoch].iloc[0]
        for metric in EVAL_METRICS:
            if abs(got[head][metric] - float(row[metric])) > 1e-12:
                raise AssertionError(
                    f"evaluate: {head} {metric} {got[head][metric]} vs the "
                    f"logged {row[metric]} (epoch {epoch})")
            if cpu[head][metric] != got[head][metric]:
                raise AssertionError(
                    f"evaluate: {head} {metric} cuda {got[head][metric]} vs "
                    f"cpu {cpu[head][metric]}")
        errs[head] = {"vs_log": abs(got[head]["loss"] - float(row["loss"])),
                      "vs_cpu": abs(got[head]["loss"] - cpu[head]["loss"])}
        if errs[head]["vs_log"] > 1e-4 or errs[head]["vs_cpu"] > 1e-3:
            raise AssertionError(f"evaluate: {head} loss {got[head]['loss']}"
                                 f", logged {row['loss']}, cpu "
                                 f"{cpu[head]['loss']}")
    log(f"evaluate main path on {card_line}: cli.evaluate.main --from_run, "
        f"checkpoint_best_phys (epoch {epoch}), {len(test)} test batches "
        f"({clips} clips), launches {counts}; metrics equal to the logged "
        f"row and the CPU's, loss |d| " + ", ".join(
            f"{h} {e['vs_log']:.3e} vs log, {e['vs_cpu']:.3e} vs cpu"
            for h, e in errs.items())
        + f"; {card_s:.2f} s ({clips / card_s:.2f} clips/s) on the host "
        f"clock, data and model set-up included; the CPU {cpu_s:.2f} s")
    log(json.dumps({"evaluate": "audio,text,video", "batches": len(test),
                    "clips": clips, "launches": counts,
                    "metrics": {h: {k: got[h][k] for k in EVAL_METRICS}
                                for h in got},
                    "loss_err": errs, "host_s": card_s,
                    "clips_per_s": clips / card_s, "cpu_host_s": cpu_s}))
    return counts


PREDICT_CLIPS = 8  # one b8 batch: 5 s wavs at 44.1 kHz, (20, 768) text,
# (128, 144, 144, 3) uint8 frames (the /255 rule and the resize to 112)


def predict_clips(tmp, video=True):
    """The predict phase's PREDICT_CLIPS raw clips under `tmp`:
    {modality: directory} (the frames skipped unless `video`)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(SEED + 23)
    dirs = {m: os.path.join(tmp, f"predict_{m}")
            for m in ("audio", "text", "video")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(PREDICT_CLIPS):
        wavfile.write(os.path.join(dirs["audio"], f"clip{i}.wav"), 44100,
                      (rng.standard_normal(5 * 44100) * 3000).astype(
                          np.int16))
        np.save(os.path.join(dirs["text"], f"clip{i}.npy"),
                rng.standard_normal((20, 768)).astype(np.float32))
        frames = rng.integers(0, 256, (128, 144, 144, 3), dtype=np.uint8)
        if video:
            np.save(os.path.join(dirs["video"], f"clip{i}.npy"), frames)
    return dirs


def predict_phase(run_dir, tmp, card_line):
    """cli.predict.main --from_run on PREDICT_CLIPS raw clips at b8 on the
    card: one line per clip, every probability within 1e-3 of the same CLI
    with --device cpu; K1 once, K2 12 and K4 4 times."""
    from multimodalaggressionrecognition_tpu_torch.cli import predict

    dirs = predict_clips(tmp)
    args = ["--from_run", run_dir, "--path_to_checkpoint",
            os.path.join(run_dir, "checkpoint_best_phys"),
            "--modalities", "audio,text,video", "--batch_size", "8"]
    for m, d in dirs.items():
        args += [f"--{m}", d]
    rows = {}
    _, counts, card_s, out = counted(lambda: predict.main(
        args + ["--device", DEVICE]))
    rows["cuda"] = [json.loads(line) for line in out.splitlines()]
    expect = expected_launches([["audio", "text", "video"]])
    if counts != expect:
        raise AssertionError(f"predict: launched {counts}, want {expect}")
    _, _, cpu_s, out = counted(lambda: predict.main(args + ["--device",
                                                           "cpu"]))
    rows["cpu"] = [json.loads(line) for line in out.splitlines()]
    names = [f"clip{i}.wav" for i in range(PREDICT_CLIPS)]
    worst = 0.0
    for device, got in rows.items():
        if [r["clip"] for r in got] != names:
            raise AssertionError(f"predict {device}: rows {got}")
    for g, w in zip(rows["cuda"], rows["cpu"]):
        for key in ("phys_prob_aggr", "verb_prob_aggr"):
            worst = max(worst, abs(g[key] - w[key]))
            if not 0.0 <= g[key] <= 1.0 or abs(g[key] - w[key]) > 1e-3:
                raise AssertionError(f"predict: cuda {g} vs cpu {w}")
    log(f"predict main path on {card_line}: cli.predict.main --from_run, "
        f"{PREDICT_CLIPS} clips at b8 (5 s wavs at 44.1 kHz, (20, 768) text, "
        f"128 x 144 px uint8 frames resized to 112), launches {counts}; "
        f"probabilities within {worst:.1e} of the CPU's (<= 1e-3); "
        f"{card_s:.2f} s on the host clock, decoding and set-up included "
        f"({PREDICT_CLIPS / card_s:.2f} clips/s); the CPU {cpu_s:.2f} s")
    log(json.dumps({"predict": "audio,text,video", "clips": PREDICT_CLIPS,
                    "launches": counts, "max_prob_err": worst,
                    "host_s": card_s, "clips_per_s": PREDICT_CLIPS / card_s,
                    "cpu_host_s": cpu_s, "rows": rows["cuda"]}))
    return counts


def doctor_phase():
    """cli.doctor --smoke on the card: its report on one line; K4 bit for
    bit against torch.roll (doctor exits non-zero otherwise); the native
    wav decoder built and loaded (the mp4 one, or the reason it is not)."""
    from multimodalaggressionrecognition_tpu_torch.cli import doctor

    report, counts, _, _ = counted(lambda: doctor.main(["--smoke"]))
    if (report["backend"] != "cuda" or counts != {"roll": 1}
            or not report["smoke"]["roll"]["bitwise_equal_to_torch_roll"]
            or report["native"]["libmarhost_wav_decode"] is not True):
        raise AssertionError(f"doctor: {report}, launches {counts}")
    log("doctor --smoke: " + json.dumps(report))
    return counts


# the device resample on K1's resample route: 5 s clips at 44.1 kHz
RESAMPLE_SHAPE, RESAMPLE_RATES = (BATCH, 220500), (44100, 16000)


def resample_phase():
    """ops/resample.resample_poly on the card against the same call on the
    CPU (the kernel's plain version), 1e-4."""
    x = torch.randn(RESAMPLE_SHAPE, generator=torch.Generator().manual_seed(
        SEED + 7)) * 0.3
    want = resample_poly(x, *RESAMPLE_RATES)
    before = kernels.launch_counts["framed_conv1d"]
    got = resample_poly(x.to(DEVICE), *RESAMPLE_RATES)
    torch.cuda.synchronize()
    if kernels.launch_counts["framed_conv1d"] != before + 1:
        raise AssertionError("resample_poly did not launch K1 once")
    err = (got.cpu() - want).abs().max().item()
    if got.shape != want.shape or not err <= 1e-4:
        raise AssertionError(f"resample_poly: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, max |d| {err:.3e}")
    log(f"resample_poly {RESAMPLE_SHAPE} {RESAMPLE_RATES[0]} -> "
        f"{RESAMPLE_RATES[1]} Hz: out {tuple(got.shape)}, cuda vs cpu max "
        f"|d| {err:.3e} <= 1e-4 ok")
    return err


def run_cli(main_fn, args, card_line, label, heads=("main",), epochs=2):
    """One CLI train run with the launch counts reset just before and read
    just after; checks each head's logs (`epochs` epochs, finite losses)
    and its best checkpoint.  Returns (trainer, counts, epoch clips/s)."""
    import pandas as pd

    torch.cuda.synchronize()
    kernels.launch_counts.clear()  # count this path only
    t0 = time.monotonic()
    trainer = main_fn(args)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the main path
    fit_s = time.monotonic() - t0
    files = set(os.listdir(trainer.run_dir))
    logs = [f"{h}_{split}_log.csv" for h in heads for split in ("train",
                                                                "test")]
    need = {"checkpoint_current", "config.json", *logs,
            *(f"checkpoint_best_{h}" for h in heads)}
    if not need <= files:
        raise AssertionError(f"{label}: missing {sorted(need - files)}")
    for f in logs:
        df = pd.read_csv(os.path.join(trainer.run_dir, f))
        if (df["epoch"].tolist() != list(range(epochs))
                or not np.isfinite(df["loss"]).all()):
            raise AssertionError(f"{label}: {f} holds {df.to_dict()}")
    clips_s = [float(v) for v in pd.read_csv(os.path.join(
        trainer.run_dir, logs[0]))["clips_per_sec"]]
    log(f"{label} main path on {card_line}: {epochs} epochs, "
        f"{trainer.state.step} "
        f"train steps, launches {counts}, fit {fit_s:.1f} s; epoch clips/s "
        f"{clips_s} (epoch 0 includes the first step's set-up)")
    return trainer, counts, clips_s


def loss_parity(label, model, batch, specs):
    """The summed loss of the heads of `specs` ({head: LossSpec}), its
    gradients and every head's logits of `model` (eval mode) on `batch`,
    on the CPU and on the card: the loss within 1e-3 of its size, the
    logits within 1e-3, every gradient by grad_parity.  GRUs and LSTMs run
    in train mode: cuDNN's RNN has a backward only there, and a one-layer
    RNN without dropout computes the same in both modes."""
    for m in model.modules():
        if isinstance(m, torch.nn.RNNBase):
            m.train()
    gpu = copy.deepcopy(model).to(DEVICE)
    out, losses = {}, {}
    for name, m, b in (("cpu", model, batch),
                       ("cuda", gpu, to_device(batch, DEVICE))):
        logits = m(b["modalities"])
        total, _ = head_losses_and_metrics(logits, b, specs, 2)
        total.backward()
        losses[name] = total.item()
        out[name] = torch.cat([logits[h].detach().cpu() for h in specs])
    n = batch["label_mask"][next(iter(specs))].shape[0]
    if (out["cuda"].shape != (len(specs) * n, 2)
            or not torch.isfinite(out["cuda"]).all()):
        raise AssertionError(f"{label} parity: bad logits {out['cuda']}")
    logit_err = (out["cuda"] - out["cpu"]).abs().max().item()
    loss_err = abs(losses["cuda"] - losses["cpu"])
    if not (logit_err <= 1e-3 and loss_err <= 1e-3 * abs(losses["cpu"])):
        raise AssertionError(f"{label} parity: logits differ by "
                             f"{logit_err:.3e}, loss {losses}")
    worst, count = grad_parity(label, model, gpu)
    log(f"{label} parity: b{n} full width, eval mode, heads "
        f"{list(specs)}, cuda vs cpu max |dlogit| {logit_err:.3e}, loss "
        f"{losses['cuda']:.6f} vs "
        f"{losses['cpu']:.6f}; {count} gradients, worst max |d| / max |g| "
        f"{worst:.3e} <= 1e-3 ok")
    return {"parity_max_abs_logit_err": logit_err, "loss_err": loss_err,
            "grad_rel_err": worst}


def labelled(modalities, n: int, heads=("main",)):
    """A batch of `modalities` ({m: data}) with every head labelled 0, 1,
    0, ..."""
    mask = torch.ones(n)
    return {"modalities": {m: {"data": d, "present": mask}
                           for m, d in modalities.items()},
            "labels": {h: torch.arange(n, dtype=torch.int32) % 2
                       for h in heads},
            "label_mask": {h: mask for h in heads}}


def train_cli_phase(label, cli, args, card_line, per_step, parity,
                    heads=("main",), split_conv=False):
    """One train entry at full width through cli.main (run_cli), its
    launches against `per_step` launches per train and eval step, then its
    median step time, peak memory and kernel families; prints its `train`
    JSON line.  Returns (its launch counts, the trainer, its first train
    batch, (median step ms, peak GiB)): bf16_cli_phase's f32 run."""
    trainer, counts, clips_s = run_cli(cli.main, args, card_line,
                                       f"train {label}", heads)
    steps = trainer.state.step
    eval_steps = 2 * len(trainer.test_loader)
    want = {k: v * (steps + eval_steps) for k, v in per_step.items()}
    if counts != want or steps < 2:
        raise AssertionError(f"train {label}: {steps} train and {eval_steps} "
                             f"eval steps launched {counts}, want {want}")
    batch = next(iter(trainer.batches(trainer.train_loader)))
    one = step_counts(trainer, batch)
    if one != per_step:
        raise AssertionError(f"train {label}: a step launched {one}, want "
                             f"{per_step}")
    step_ms, peak_gb = median_step_ms(trainer, batch)
    families = kernel_breakdown(lambda: trainer.train_step(batch), reps=3,
                                split_conv=split_conv)
    busy = sum(families.values())
    b = batch["sample_mask"].shape[0]
    log(f"train {label} step b{b} on {card_line}: median {step_ms:.3f} ms, "
        f"peak {peak_gb:.2f} GiB; launches per step {one}; kernels by family "
        "(ms per step): " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / step_ms * 100:.1f}% of the step")
    log(json.dumps({"train": label, "batch": b, "steps": steps,
                    "eval_steps": eval_steps, "launches": counts,
                    "launches_per_step": one, "step_ms": step_ms,
                    "peak_gib": peak_gb, "epoch_clips_per_s": clips_s,
                    "kernel_ms_by_family": families,
                    "kernel_busy_pct": busy / step_ms * 100, **parity}))
    return counts, trainer, batch, (step_ms, peak_gb)


# the train entries' bf16 runs, by path: read into main's launch table
BF16_LAUNCHES = {}


def _rows(tree, n, frames=None):
    """The first n rows of every tensor of a batch; a video clip (and its
    mask) also cut to its first `frames` frames."""
    if isinstance(tree, dict):
        return {k: _rows(v, n, frames) for k, v in tree.items()}
    t = tree[:n]
    return t[:, :frames] if frames and t.dim() == 5 else t


def _eval_loss(model, batch, specs, num_classes, dtype):
    """The eval-mode summed loss of `model` on `batch` in `dtype` (the
    train step's forward, deterministic) and its heads' logits (f32, on
    the CPU, concatenated)."""
    from multimodalaggressionrecognition_tpu_torch.train.steps import forward

    model.eval()
    with torch.no_grad():
        out = forward(model, batch["modalities"], dtype)
        loss = head_losses_and_metrics(out, batch, specs, num_classes)[0]
        return loss.item(), torch.cat([out[h].float().cpu() for h in specs])


def bf16_cli_phase(label, cli, args, card_line, batch, timing32, per_step,
                   heads=("main",), cpu_frames=None, cpu_tol=2e-2,
                   train_only=None):
    """The entry under --compute_dtype bfloat16 through cli.main for one
    epoch on the f32 run's data, `batch` its first train batch and
    `timing32` its (median step ms, peak GiB); the caller has dropped its
    f32 trainer, so the peak is the bf16 run's own (launch counts reset
    just before, read just after): its launches by kernel and dtype (kernels.launch_key) against
    `per_step` per train and eval step, the dtype JAX's flow gives, and
    `train_only` more per train step (a backward kernel); one train
    step's launches on the f32 run's batch; the median bf16 step and peak
    memory beside the f32 ones; the kernel families; the master state f32;
    from the entry's seeded initial weights, one bf16 train step's loss on
    that batch against one f32 step's (the same dropout draws; 5 %,
    tests/test_precision.py:168), and the eval-mode bf16 loss and logits
    of its first row (`cpu_frames` frames of a clip) card against CPU,
    within `cpu_tol` of the loss and of the largest logit."""
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        train_step)

    gc.collect()  # the f32 trainer's cycles, before the peak is read
    args = list(args) + ["--compute_dtype", "bfloat16"]
    args[args.index("--epoch_num") + 1] = "1"
    args[args.index("--run_name") + 1] += "_bf16"
    name = f"train {label} bf16"
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=UNFLATTENED_RNN)
        trainer, counts, clips_s = run_cli(cli.main, args, card_line, name,
                                           heads, epochs=1)
        steps, eval_steps = trainer.state.step, len(trainer.test_loader)
        train_only = train_only or {}
        want = {k: per_step.get(k, 0) * (steps + eval_steps)
                + train_only.get(k, 0) * steps
                for k in {**per_step, **train_only}}
        if counts != want or steps < 1:
            raise AssertionError(f"{name}: {steps} train and {eval_steps} "
                                 f"eval steps launched {counts}, want {want}")
        one = step_counts(trainer, batch)
        if one != {**per_step, **train_only}:
            raise AssertionError(f"{name}: a step launched {one}, want "
                                 f"{per_step} and {train_only}")
        step_ms, peak_gb = median_step_ms(trainer, batch)
        families = kernel_breakdown(lambda: trainer.train_step(batch),
                                    reps=3)
        state_dtypes_f32(trainer.state, name)
        specs, ncls = trainer.loss_specs, trainer.num_classes
        # seeded on the CPU (its generator draws there), as the CLI seeds
        initial = seeded_init_(copy.deepcopy(trainer.state.model).cpu(),
                               SEED)
        losses = {}
        for dtype in (None, BF16):
            st = create_train_state(copy.deepcopy(initial),
                                    OptimizerConfig(learning_rate=1e-3),
                                    DEVICE)
            set_generator(st.model, torch.Generator(DEVICE).manual_seed(SEED))
            losses[dtype] = train_step(st, batch, specs, ncls,
                                       compute_dtype=dtype)["total_loss"].item()
            state_dtypes_f32(st, name)
            del st
        loss16, loss32 = losses[BF16], losses[None]
        row = _rows(batch, 1, cpu_frames)
        cpu_row, cpu_logits = _eval_loss(initial, to_device(row, "cpu"),
                                         specs, ncls, BF16)
        card_row, card_logits = _eval_loss(initial.to(DEVICE), row, specs,
                                           ncls, BF16)
        del initial
    rel32 = abs(loss16 - loss32) / (abs(loss32) + 1e-6)
    rel_cpu = abs(card_row - cpu_row) / (abs(cpu_row) + 1e-6)
    logit_err = ((card_logits - cpu_logits).abs().max()
                 / cpu_logits.abs().max()).item()
    if not (rel32 <= 0.05 and rel_cpu <= cpu_tol and logit_err <= cpu_tol
            and np.isfinite(loss16)):
        raise AssertionError(f"{name}: step loss bf16 {loss16} vs f32 {loss32} "
                             f"({rel32:.3e}); first row card {card_row} vs "
                             f"cpu {cpu_row} ({rel_cpu:.3e}), logits "
                             f"{logit_err:.3e} of the largest (<= {cpu_tol})")
    busy = sum(families.values())
    b = batch["sample_mask"].shape[0]
    step32, peak32 = timing32
    log(f"{name} step b{b} on {card_line}: median {step_ms:.3f} ms, peak "
        f"{peak_gb:.2f} GiB (f32 {step32:.3f} ms, {peak32:.2f} GiB); "
        f"launches per step {one}; one step's loss bf16 {loss16:.6f} vs "
        f"f32 {loss32:.6f} ({rel32 * 100:.3f} % <= 5 %), first row card "
        f"{card_row:.6f} vs cpu {cpu_row:.6f} ({rel_cpu:.2e}), logits "
        f"{logit_err:.2e} of the largest (<= {cpu_tol}); "
        "master state f32 ok; kernels by family (ms per step): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / step_ms * 100:.1f}% of the step")
    log(json.dumps({"train": f"{label} bf16", "batch": b,
                    "compute_dtype": "bfloat16", "steps": steps,
                    "eval_steps": eval_steps, "launches": counts,
                    "launches_per_step": one, "step_ms": step_ms,
                    "peak_gib": peak_gb, "f32_step_ms": step32,
                    "f32_peak_gib": peak32, "epoch_clips_per_s": clips_s,
                    "kernel_ms_by_family": families,
                    "kernel_busy_pct": busy / step_ms * 100,
                    "loss_bf16": loss16, "loss_f32": loss32,
                    "loss_rel_diff": rel32, "row_loss_card": card_row,
                    "row_loss_cpu": cpu_row, "row_rel_diff": rel_cpu,
                    "row_logit_rel_err": logit_err}))
    BF16_LAUNCHES[f"train_{label}_bf16"] = counts
    shutil.rmtree(trainer.run_dir, ignore_errors=True)  # its checkpoints
    del trainer


def after_ms(pre, fn, reps: int = 20) -> float:
    """Mean device time of fn() launched right behind pre() on the stream
    (CUDA events around fn alone): a kernel's time in place after another
    kernel, as a train step gives it."""
    pre()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        pre()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


# the spectrogram VGG trained at full width (cli/train_audio_transformer.py
# defaults: 5 s at 16 kHz, n_fft 512 -> 257 x 313, masks 80/80, batch 16)
AUDIO_VGG = dict(batch_size=16, synthetic_files=64)


def vgg_forward(vgg, x, decisions=None):
    """VGG11BN's eval-mode forward, returning (logits, its decisions): every
    ReLU's mask and every max pool's argmax.  Given `decisions` it takes
    those instead of its own, and so computes the branch of this
    piecewise-linear net that another run took."""
    taken, given = [], iter(decisions or ())

    def relu(y):
        mask = next(given).to(y.device) if decisions else y > 0
        taken.append(mask.cpu())
        return y * mask.to(y.dtype)

    for block in vgg.blocks:
        if block != "M":
            conv, bn = (getattr(vgg, f"{k}{block}") for k in ("conv", "bn"))
            x = relu(bn(conv(x)))
        elif decisions:
            idx = next(given).to(x.device)
            x = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            taken.append(idx.cpu())
        else:
            x, idx = F.max_pool2d(x, 2, return_indices=True)
            taken.append(idx.cpu())
    if x.shape[-2:] != (7, 7):
        x = F.adaptive_avg_pool2d(x, 7)
    x = relu(vgg.fc2(relu(vgg.fc1(x.flatten(1)))))
    return vgg.fc3(x), taken


def audio_vgg_parity(model, samples: int, n_fft: int):
    """SpectrogramVGG (seeded, eval mode) at b2 on the card against the
    CPU: (a) the spectrogram, within 1e-4 of its largest value; (b) the
    logits and the loss of the whole path, within 1e-3; (c) every gradient
    of each run, the card's and the CPU's, within 1e-3 * max|g| of that
    tensor in a float64 CPU reference that takes the same ReLU and max-pool
    decisions on the same spectrogram.  At full size a float32 run flips
    about one of its millions of decisions against another (a near tie),
    and one flip moves a gradient by up to a few percent of its largest,
    so the card's and the CPU's gradients are only reported side by side,
    with how many decisions they take differently."""
    from multimodalaggressionrecognition_tpu_torch.ops.stft import (
        spectrogram)

    g = torch.Generator().manual_seed(SEED + 8)
    wav = torch.randn((2, samples), generator=g) * 0.1
    model = seeded_init_(model, SEED).eval()
    with torch.no_grad():  # non-trivial running statistics for eval mode
        for m in model.modules():
            if isinstance(m, BatchNorm1d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=g) + 0.5)
    runs = {"cpu": model, "card": copy.deepcopy(model).to(DEVICE)}
    specs = {"main": LossSpec("ce")}
    batch = {"modalities": {"audio": {"data": wav, "present": torch.ones(2)}},
             "labels": {"main": torch.tensor([0, 1], dtype=torch.int32)},
             "label_mask": {"main": torch.ones(2)}}
    out = {}
    for name, m in runs.items():
        b = to_device(batch, next(m.parameters()).device)
        spec = spectrogram(b["modalities"]["audio"]["data"], n_fft=n_fft,
                           basis=m.basis)
        logits = m(b["modalities"])["main"]
        total, _ = head_losses_and_metrics({"main": logits}, b, specs, 2)
        total.backward()
        img = spec[:, None].expand(-1, 3, -1, -1)
        with torch.no_grad():
            _, decisions = vgg_forward(m.vgg, img)
        # the float64 reference on this run's spectrogram and decisions
        ref = copy.deepcopy(model.vgg).double()
        ref.zero_grad()
        ref_logits, _ = vgg_forward(ref, img.cpu().double(), decisions)
        ref_total, _ = head_losses_and_metrics({"main": ref_logits}, batch,
                                               specs, 2)
        ref_total.backward()
        grads = {n: p.grad.double().cpu() for n, p in m.vgg.named_parameters()}
        ref_grads = {n: p.grad for n, p in ref.named_parameters()}
        err, worst = max(((grads[n] - ref_grads[n]).abs().max().item()
                          / ref_grads[n].abs().max().item(), n)
                         for n in ref_grads)
        branch = (logits.detach().cpu().double() - ref_logits).abs().max()
        if not (err <= 1e-3 and branch.item() <= 1e-3):
            raise AssertionError(
                f"audio_vgg parity: the {name}'s {worst} gradient differs "
                f"from float64 on its decisions by {err:.3e} of its largest "
                f"(logits by {branch.item():.3e}) > 1e-3")
        out[name] = dict(spec=spec.detach().cpu(),
                         logits=logits.detach().cpu(), loss=total.item(),
                         grads=grads, decisions=decisions, err=err,
                         worst=worst)
    cpu, card = out["cpu"], out["card"]
    scale = cpu["spec"].abs().max().item()
    spec_err = (card["spec"] - cpu["spec"]).abs().max().item()
    logit_err = (card["logits"] - cpu["logits"]).abs().max().item()
    loss_err = abs(card["loss"] - cpu["loss"])
    if not (spec_err <= 1e-4 * scale and logit_err <= 1e-3
            and loss_err <= 1e-3 * abs(cpu["loss"])):
        raise AssertionError(f"audio_vgg parity: spectrogram max |d| "
                             f"{spec_err:.3e} (max {scale:.3e}), logits "
                             f"{logit_err:.3e}, loss {card['loss']} vs "
                             f"{cpu['loss']}")
    paths, paths_name = max(
        ((card["grads"][n] - cpu["grads"][n]).abs().max().item()
         / cpu["grads"][n].abs().max().item(), n) for n in cpu["grads"])
    flips = sum((a != b).sum().item() for a, b in
                zip(card["decisions"], cpu["decisions"]))
    total = sum(d.numel() for d in cpu["decisions"])
    log(f"audio_vgg parity b2 {tuple(cpu['spec'].shape)}: spectrogram card vs "
        f"cpu max |d| {spec_err:.3e} <= 1e-4 * {scale:.3e}; logits "
        f"{logit_err:.3e}, loss {card['loss']:.6f} vs {cpu['loss']:.6f} ok; "
        f"{len(cpu['grads'])} gradients against float64 on each run's "
        f"decisions: card {card['err']:.3e} ({card['worst']}), cpu "
        f"{cpu['err']:.3e} ({cpu['worst']}) <= 1e-3 ok; card vs cpu "
        f"{paths:.3e} ({paths_name}), {flips} of {total} decisions differ")
    return {"spectrogram_err": spec_err, "logit_err": logit_err,
            "loss_err": loss_err, "grad_rel_err": card["err"],
            "cpu_grad_rel_err": cpu["err"],
            "card_vs_cpu_grad_rel_err": paths, "decisions_differing": flips,
            "decisions": total}


def audio_vgg_phase(card_line, k1):
    """(a) audio_vgg_parity; (b) cli.train_audio_transformer.main at full
    width, b16, 2 epochs: K1 once per train and eval step, no other kernel;
    (c) the b16 step's time, peak memory and kernel families, K1 in the
    step beside its cold and warm times and right after a cuDNN conv."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_audio_transformer as cli)

    cfg = cli.AudioTransformerConfig()
    parity = audio_vgg_parity(cli.make_model(cfg),
                              cfg.sample_rate * cfg.audio_seconds, cfg.n_fft)

    with tempfile.TemporaryDirectory() as tmp:
        args = ["--files_root", os.path.join(tmp, "wavs"), "--synthetic_wav",
                "--synthetic_tones", "--saving_dir", os.path.join(tmp, "runs"),
                "--run_name", "r", "--epoch_num", "2", "--device", DEVICE,
                "--num_threads", "4",
                "--synthetic_files", str(AUDIO_VGG["synthetic_files"]),
                "--batch_size", str(AUDIO_VGG["batch_size"])]
        trainer, counts, clips_s = run_cli(cli.main, args, card_line,
                                           "train audio_vgg")
        steps = trainer.state.step
        eval_steps = 2 * len(trainer.test_loader)
        want_counts = {"framed_conv1d": steps + eval_steps}
        if counts != want_counts or steps < 6:
            raise AssertionError(f"train audio_vgg: {steps} train and "
                                 f"{eval_steps} eval steps launched {counts}, "
                                 f"want {want_counts}")
        batch = list(trainer.batches(trainer.train_loader))[0]
        step_ms, peak_gb = median_step_ms(trainer, batch)
        families = kernel_breakdown(lambda: trainer.train_step(batch), reps=3)
        vgg = trainer.state.model.vgg
        h = trainer.state.model.basis
        x = batch["modalities"]["audio"]["data"]
        xpad = F.pad(x, (cfg.n_fft // 2, cfg.n_fft // 2),
                     mode="reflect").contiguous()
        zeros = h.new_zeros(h.shape[1])
        act = torch.randn((AUDIO_VGG["batch_size"], 512, 16, 19),
                          device=DEVICE)

        def stft_k1():
            return framed_conv1d(xpad, h, zeros, cfg.n_fft, cfg.n_fft // 2)

        with torch.no_grad():
            k1_after_conv = after_ms(lambda: vgg.conv7(act), stft_k1)
        # bf16: the spectrogram returns f32 (as JAX's), so K1 and the VGG
        # run in f32 on the bf16-rounded weights.  The f32 run's ~1 GB
        # checkpoints and its trainer go first
        shutil.rmtree(trainer.run_dir, ignore_errors=True)
        del trainer, vgg, h, x, xpad, zeros, act
        bf16_cli_phase("audio_vgg", cli, args, card_line, batch,
                       (step_ms, peak_gb), {"framed_conv1d": 1},
                       cpu_tol=1e-3)
    busy = sum(families.values())
    k1_in_step = families.get("framed_conv1d (K1)", 0.0)
    stft = k1["stft_b16"]
    log(f"train audio_vgg step b{AUDIO_VGG['batch_size']} (257 x 313 "
        f"spectrograms, f32 with TF32 off) on {card_line}: median "
        f"{step_ms:.3f} ms, peak {peak_gb:.2f} GiB")
    log("train audio_vgg step kernels by family (ms per step): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / step_ms * 100:.1f}% of the "
        f"{step_ms:.3f} ms step")
    log(f"k1 stft-16x80512 in place: {k1_in_step:.4f} ms in the train step "
        f"(torch.profiler, 1 launch), {k1_after_conv:.4f} ms right after a "
        f"cuDNN conv; alone {stft['ms']:.4f} ms cold, "
        f"{stft['warm']['ms']:.4f} ms warm")
    log(json.dumps({"train": "audio_vgg", "batch": AUDIO_VGG["batch_size"],
                    "steps": steps, "eval_steps": eval_steps,
                    "launches": counts, "step_ms": step_ms,
                    "peak_gib": peak_gb, "epoch_clips_per_s": clips_s,
                    "kernel_ms_by_family": families,
                    "kernel_busy_pct": busy / step_ms * 100,
                    "k1_in_step_ms": k1_in_step,
                    "k1_after_conv_ms": k1_after_conv,
                    "k1_cold_ms": stft["ms"], "k1_warm_ms": stft["warm"]["ms"],
                    **parity}))
    return counts


# the text transformer trained at full width (cli/train_text_transformer.py
# defaults: hidden 768, 2 layers, 8 heads, 48 tokens, batch 16) on the
# intervals table of a synthetic AVABOS set
TEXT_DATA = dict(num_clusters=4, samples_per_cluster=12, seed=SEED,
                 text_len=48, audio_len=16000, video_frames=8, video_hw=32)


def text_phase(card_line):
    """(a) logits of the text model, card against CPU, b2; (b)
    cli.train_text_transformer.main at full width, b16, 2 epochs, no
    kernel launched; (c) the median step time."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_text_transformer as cli)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    cfg = cli.TextConfig()
    model = seeded_init_(cli.make_model(cfg), SEED).eval()
    tokens = torch.randn((2, cfg.text_tokens, cfg.hidden_size),
                         generator=torch.Generator().manual_seed(SEED + 9))
    data = {"text": {"data": tokens, "present": torch.ones(2)}}
    with torch.inference_mode():
        want = model(data)["main"]
        got = copy.deepcopy(model).to(DEVICE)(to_device(data, DEVICE))["main"]
    err = (got.cpu() - want).abs().max().item()
    if got.shape != (2, 2) or not err <= 1e-3:
        raise AssertionError(f"text parity: logits differ by {err:.3e}")
    log(f"text parity: b2 full width, cuda vs cpu max |dlogit| {err:.3e} "
        "<= 1e-3 ok")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "avabos")
        generate_synthetic_avabos(root, **TEXT_DATA)
        args = ["--dataset_root", root, "--saving_dir",
                os.path.join(tmp, "runs"), "--run_name", "r", "--epoch_num",
                "2", "--device", DEVICE, "--num_threads", "4",
                "--batch_size", "16"]
        counts, _, batch, timing = train_cli_phase(
            "text", cli, args, card_line, {},
            {"parity_max_abs_logit_err": err})
        bf16_cli_phase("text", cli, args, card_line, batch, timing, {})
        return counts


# the video transformer trained at its defaults (cli/train_video_transformer
# .py: 128 frames at 112 px in 8-frame windows, hidden 768, 2 layers, 8
# heads, batch 8) on clips of 128 frames at 128 px, as the reference's data
# is, so the device resizes 128 -> 112
VIDEO_CLIPS = dict(n_train=8, n_test=4, frames=128, hw=128)


def video_transformer_phase(card_line):
    """(a) logits and head gradients card against CPU at b2 (16 frames at
    128 px); (b) cli.train_video_transformer.main at its defaults, 2 epochs:
    K2 12 and K4 4 times per train and eval step, no K3; (c) step time."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_video_transformer as cli)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        make_synthetic_videos)

    cfg = cli.VideoTransformerConfig()
    model = randomize_norms(seeded_init_(cli.make_model(cfg), SEED))
    video = torch.randn((2, 16, VIDEO_CLIPS["hw"], VIDEO_CLIPS["hw"], 3),
                        generator=torch.Generator().manual_seed(SEED + 11))
    parity = loss_parity(
        "video_transformer", model, labelled({"video": video}, 2),
        {"main": LossSpec("weighted_ce", class_weights=(
            cfg.class_weight_0, cfg.class_weight_1))})
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vids")
        make_synthetic_videos(root, seed=SEED, **VIDEO_CLIPS)
        args = ["--files_root", root, "--saving_dir",
                os.path.join(tmp, "runs"), "--run_name", "r", "--epoch_num",
                "2", "--device", DEVICE, "--num_threads", "4"]
        # bf16: the 128 -> 112 resize returns f32 (as JAX's), so the Swin
        # and its K2 and K4 run in f32 on the bf16-rounded weights
        per_step = {"window_attention": 12, "roll": 4}
        counts, _, batch, timing = train_cli_phase(
            "video_transformer", cli, args, card_line, per_step, parity)
        bf16_cli_phase("video_transformer", cli, args, card_line, batch,
                       timing, per_step, cpu_frames=16, cpu_tol=1e-3)
        return counts


# the audio,text model trained at full width (cli/train_audio_text.py
# defaults: 80 000 samples, 48 tokens, hidden 768, batch 16) on the
# intervals table of a synthetic AVABOS set
AUDIO_TEXT_DATA = dict(num_clusters=4, samples_per_cluster=12, seed=SEED,
                       audio_len=80000, text_len=48, video_frames=8,
                       video_hw=32)


def audio_text_phase(card_line):
    """(a) loss, logits and every gradient card against CPU at b2; (b)
    cli.train_audio_text.main at full width, b16, 2 epochs: K1 once per
    train and eval step, no other kernel; (c) the median step time."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_audio_text as cli)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    cfg = cli.AudioTextConfig()
    model = randomize_norms(seeded_init_(cli.make_model(cfg), SEED))
    g = torch.Generator().manual_seed(SEED + 12)
    parity = loss_parity("audio_text", model, labelled({
        "audio": torch.randn((2, cfg.audio_samples), generator=g) * 0.1,
        "text": torch.randn((2, cfg.text_tokens, cfg.hidden_size),
                            generator=g)}, 2), {"main": LossSpec("ce")})
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "avabos")
        generate_synthetic_avabos(root, **AUDIO_TEXT_DATA)
        args = ["--dataset_root", root, "--saving_dir",
                os.path.join(tmp, "runs"), "--run_name", "r", "--epoch_num",
                "2", "--device", DEVICE, "--num_threads", "4"]
        counts, _, batch, timing = train_cli_phase(
            "audio_text", cli, args, card_line, {"framed_conv1d": 1}, parity)
        bf16_cli_phase("audio_text", cli, args, card_line, batch, timing,
                       {"framed_conv1d": 1})
        return counts


# the audio RNN entry at its defaults (cli/train_audio_rnn.py: 10 s at 16
# kHz, batch 16, three heads at hidden 512) on 32 + 8 synthetic tone clips
AUDIO_RNN_HEADS = ("LSTM_1_layer", "GRU_1_layer", "Avg")
AUDIO_RNN_EXTRACTORS = ("wav2vec1", "wav2vec2_conv", "wav2vec2", "cnn1d")
# cuDNN warns, and compacts the weights on every call, when an RNN's
# parameters are not one flat buffer; the RNN paths treat it as a failure
UNFLATTENED_RNN = "RNN module weights are not part of single contiguous"


def encoder_layers_ms(trainer):
    """Device ms of each conv and each GroupNorm + ReLU of the trainer's
    frozen wav2vec-1 encoder on a train batch (no gradient, as in the
    step), and conv0's kernel families: the bias-free C_in = 1 conv that
    F.conv1d takes."""
    ext = trainer.state.model.inner.extractor
    batch = next(iter(trainer.batches(trainer.train_loader)))
    x = x0 = batch["modalities"]["audio"]["data"][..., None]
    out = {}
    with torch.no_grad():
        for i in range(ext.num_convs):
            conv, norm = getattr(ext, f"conv{i}"), getattr(ext, f"norm{i}")
            out[f"conv{i}"] = cuda_ms(lambda: conv(x), reps=5)
            y = conv(x)
            out[f"norm{i}_relu"] = cuda_ms(lambda: torch.relu(norm(y)),
                                           reps=5)
            x = torch.relu(norm(y))
        families = kernel_breakdown(lambda: ext.conv0(x0), reps=3)
    log(f"train audio_rnn encoder on {tuple(x0.shape)}, ms per call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
        + "; conv0 by family: " + ", ".join(
            f"{k} {v:.4f}" for k, v in families.items()))
    return out


def audio_rnn_phase(card_line):
    """(a) the three heads' loss, logits and every gradient card against
    CPU at b2 and 10 s, for each extractor; (b) cli.train_audio_rnn.main
    at its defaults (wav2vec-1, b16), 2 epochs, no kernel; (c) the same
    with --extractor cnn1d: K1 once per train and eval step, nothing else;
    (d) each run's median step, peak memory and kernel families."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_audio_rnn as cli)

    specs = {h: LossSpec("ce") for h in AUDIO_RNN_HEADS}
    cfg = cli.AudioRnnConfig()
    samples = cfg.sample_rate * cfg.audio_seconds
    parity = {}
    for extractor in AUDIO_RNN_EXTRACTORS:
        model = randomize_norms(seeded_init_(cli.make_model(
            cli.AudioRnnConfig(extractor=extractor)), SEED))
        audio = torch.randn((2, samples), generator=torch.Generator(
        ).manual_seed(SEED + 13)) * 0.1
        parity[extractor] = loss_parity(
            f"audio_rnn {extractor}", model,
            labelled({"audio": audio}, 2, AUDIO_RNN_HEADS), specs)
        del model
    launches = []
    with tempfile.TemporaryDirectory() as tmp:
        # (label, extractor, the other extractors' parity on its line,
        #  launches per step)
        for label, extractor, others, per_step in (
                ("audio_rnn", "wav2vec1", ("wav2vec2_conv", "wav2vec2"), {}),
                ("audio_rnn_cnn1d", "cnn1d", (), {"framed_conv1d": 1})):
            args = ["--files_root", os.path.join(tmp, "wavs"),
                    "--synthetic_wav", "--synthetic_tones", "--saving_dir",
                    os.path.join(tmp, "runs"), "--run_name", label,
                    "--epoch_num", "2", "--device", DEVICE, "--num_threads",
                    "4", "--extractor", extractor]
            line = dict(parity[extractor])
            line.update({f"{e}_{k}": v for e in others
                         for k, v in parity[e].items()})
            counts, trainer, batch, timing = train_cli_phase(
                label, cli, args, card_line, per_step, line, AUDIO_RNN_HEADS)
            if extractor == "wav2vec1":
                encoder_layers_ms(trainer)
            del trainer
            bf16_cli_phase(label, cli, args, card_line, batch, timing,
                           per_step, AUDIO_RNN_HEADS)
            launches.append(counts)
    return launches


VIDEO_RNN_FEATURES = dict(n_train=32, n_test=8, seq=19)


def video_rnn_phase(card_line):
    """(a) the three heads' loss, logits and every gradient card against
    CPU at b2 on 19 x 512 features; (b) cli.train_video_rnn.main at its
    defaults (b16), 2 epochs with --epoch_dirs over train/0 and train/1: no
    kernel, and the second epoch reads train/1; (c) the median step."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_video_rnn as cli)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        make_synthetic_features)

    cfg = cli.VideoRnnConfig()
    model = seeded_init_(cli.make_model(cfg), SEED).eval()
    feats = torch.randn((2, VIDEO_RNN_FEATURES["seq"], cfg.feature_dim),
                        generator=torch.Generator().manual_seed(SEED + 14))
    parity = loss_parity("video_rnn", model,
                         labelled({"video": feats}, 2, AUDIO_RNN_HEADS),
                         {h: LossSpec("ce") for h in AUDIO_RNN_HEADS})
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "feats")
        make_synthetic_features(root, cfg.feature_dim, seed=SEED,
                                **VIDEO_RNN_FEATURES)
        # epoch 1's directory: the same clips, other draws
        make_synthetic_features(os.path.join(tmp, "other"), cfg.feature_dim,
                                seed=SEED + 1, **VIDEO_RNN_FEATURES)
        os.rename(os.path.join(tmp, "other", "train", "0"),
                  os.path.join(root, "train", "1"))
        args = ["--files_root", root, "--saving_dir",
                os.path.join(tmp, "runs"), "--run_name", "r", "--epoch_num",
                "2", "--device", DEVICE, "--num_threads", "4",
                "--epoch_dirs"]
        counts, trainer, batch, timing = train_cli_phase(
            "video_rnn", cli, args, card_line, {}, parity, AUDIO_RNN_HEADS)
        read = trainer.train_loader.source.root
        if read != os.path.join(root, "train", "1"):
            raise AssertionError(f"train video_rnn: epoch 1 read {read}")
        log("train video_rnn: --epoch_dirs moved the train source to "
            "train/1 ok")
        del trainer
        bf16_cli_phase("video_rnn", cli, args, card_line, batch, timing, {},
                       AUDIO_RNN_HEADS)
    return counts


class relu_decisions:
    """Within the block every `torch.relu` (the port's models call it by
    that name) records its mask in `taken`; given `decisions` it takes
    those masks instead of its own, and so computes the branch of the
    piecewise-linear parts that another run took.  `fit(mask, shape)`
    cuts a given mask to the call's shape (a rank's block of a run over
    the whole batch)."""

    def __init__(self, decisions=None, fit=None):
        self.taken, self.given = [], decisions
        self.fit = fit or (lambda mask, shape: mask)
        self._relu = torch.relu

    def __enter__(self):
        given = iter(self.given or ())

        def relu(y):
            mask = (self.fit(next(given), y.shape).to(y.device)
                    if self.given is not None else y > 0)
            self.taken.append(mask.cpu())
            return y * mask.to(y.dtype)

        torch.relu = relu
        return self

    def __exit__(self, *exc):
        torch.relu = self._relu


class pool_decisions:
    """relu_decisions for the CNN1D tower's max pools
    (`models/cnn1d.max_pool1d`): each records its argmax in `taken`, or
    takes the given one (cut by `fit`) and gathers it, which is the pool's
    forward and backward on that argmax."""

    def __init__(self, decisions=None, fit=None):
        self.taken, self.given = [], decisions
        self.fit = fit or (lambda idx, shape: idx)

    def __enter__(self):
        from multimodalaggressionrecognition_tpu_torch.models import cnn1d

        given = iter(self.given or ())
        self._module, self._pool = cnn1d, cnn1d.max_pool1d

        def pool(x, window):
            xt = x.transpose(1, 2)  # (B, C, L)
            out_shape = (*xt.shape[:2], xt.shape[2] // window)
            if self.given is not None:
                idx = self.fit(next(given), out_shape).to(x.device)
            else:
                idx = F.max_pool1d(xt.detach(), window,
                                   return_indices=True)[1]
            self.taken.append(idx.cpu())
            return xt.gather(-1, idx).transpose(1, 2)

        cnn1d.max_pool1d = pool
        return self

    def __exit__(self, *exc):
        self._module.max_pool1d = self._pool


def replay_parity(label, model, batch, specs, num_classes=2):
    """loss_parity for a model with many ReLUs: the loss and the logits
    card against CPU within 1e-3; every gradient of each run, the card's
    and the CPU's, within 1e-3 * max|g| of a float64 CPU run that takes
    that run's ReLU decisions (a float32 run flips a near tie among
    millions against another, and one flip moves a gradient by more), with
    the card-vs-CPU gradients and the decisions they take differently
    reported beside."""
    runs, out = {"cpu": model, "card": copy.deepcopy(model).to(DEVICE)}, {}
    for name, m in runs.items():
        b = to_device(batch, DEVICE if name == "card" else "cpu")
        with relu_decisions() as rec:
            logits = m(b["modalities"])
        total, _ = head_losses_and_metrics(logits, b, specs, num_classes)
        total.backward()
        ref = copy.deepcopy(model).double()
        ref.zero_grad(set_to_none=True)
        ref_batch = {**batch, "modalities": {
            k: {**v, "data": v["data"].double()}
            for k, v in batch["modalities"].items()}}
        with relu_decisions(rec.taken):
            ref_logits = ref(ref_batch["modalities"])
        ref_total, _ = head_losses_and_metrics(ref_logits, ref_batch, specs,
                                               num_classes)
        ref_total.backward()
        grads = {n: p.grad.double().cpu() for n, p in m.named_parameters()
                 if p.requires_grad}
        ref_grads = {n: p.grad for n, p in ref.named_parameters()
                     if p.requires_grad}
        err, worst = max(((grads[n] - ref_grads[n]).abs().max().item()
                          / ref_grads[n].abs().max().item(), n)
                         for n in ref_grads)
        logits = torch.cat([logits[h].detach().cpu() for h in specs])
        branch = (logits.double() - torch.cat(
            [ref_logits[h].detach() for h in specs])).abs().max().item()
        if not (err <= 1e-3 and branch <= 1e-3):
            raise AssertionError(
                f"{label} parity: the {name}'s {worst} gradient differs from "
                f"float64 on its decisions by {err:.3e} of its largest "
                f"(logits by {branch:.3e}) > 1e-3")
        out[name] = dict(logits=logits, loss=total.item(), grads=grads,
                         decisions=rec.taken, err=err, worst=worst)
    cpu, card = out["cpu"], out["card"]
    logit_err = (card["logits"] - cpu["logits"]).abs().max().item()
    loss_err = abs(card["loss"] - cpu["loss"])
    if not (logit_err <= 1e-3 and loss_err <= 1e-3 * abs(cpu["loss"])):
        raise AssertionError(f"{label} parity: logits differ by "
                             f"{logit_err:.3e}, loss {card['loss']} vs "
                             f"{cpu['loss']}")
    paths, paths_name = max(
        ((card["grads"][n] - cpu["grads"][n]).abs().max().item()
         / cpu["grads"][n].abs().max().item(), n) for n in cpu["grads"])
    flips = sum((a != b).sum().item() for a, b in
                zip(card["decisions"], cpu["decisions"]))
    total = sum(d.numel() for d in cpu["decisions"])
    log(f"{label} parity: b{len(cpu['logits']) // len(specs)} full width, "
        f"eval mode, cuda vs cpu max |dlogit| {logit_err:.3e}, loss "
        f"{card['loss']:.6f} vs {cpu['loss']:.6f} ok; {len(cpu['grads'])} "
        f"gradients against float64 on each run's ReLU decisions: card "
        f"{card['err']:.3e} ({card['worst']}), cpu {cpu['err']:.3e} "
        f"({cpu['worst']}) <= 1e-3 ok; card vs cpu {paths:.3e} "
        f"({paths_name}), {flips} of {total} decisions differ")
    return {"parity_max_abs_logit_err": logit_err, "loss_err": loss_err,
            "grad_rel_err": card["err"], "cpu_grad_rel_err": cpu["err"],
            "card_vs_cpu_grad_rel_err": paths, "decisions_differing": flips,
            "decisions": total}


def audio_transformer_w2v_phase(card_line):
    """(a) loss, logits and every gradient of the head card against CPU at
    b2 on 5 s clips; (b) cli.train_audio_transformer.main --arch
    transformer at b16, 2 epochs on 32 + 8 synthetic tone clips: no
    kernel; (c) the median step."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_audio_transformer as cli)

    cfg = cli.AudioTransformerConfig(arch="transformer")
    model = randomize_norms(seeded_init_(cli.make_model(cfg), SEED))
    audio = torch.randn((2, cfg.sample_rate * cfg.audio_seconds),
                        generator=torch.Generator().manual_seed(SEED + 15))
    parity = replay_parity("audio_transformer_w2v", model,
                           labelled({"audio": audio * 0.1}, 2),
                           {"main": LossSpec("ce")})
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--files_root", os.path.join(tmp, "wavs"), "--synthetic_wav",
                "--synthetic_tones", "--saving_dir",
                os.path.join(tmp, "runs"), "--run_name", "r", "--epoch_num",
                "2", "--device", DEVICE, "--num_threads", "4", "--arch",
                "transformer", "--batch_size", "16"]
        counts, _, batch, timing = train_cli_phase(
            "audio_transformer_w2v", cli, args, card_line, {}, parity)
        # bf16: the classifier's two layers (d = 64, no mask) run the
        # self-attention kernels, the backward's in train steps only
        bf16_cli_phase("audio_transformer_w2v", cli, args, card_line, batch,
                       timing, {"self_attention.bf16": 2},
                       train_only={"self_attention_bwd.bf16": 2})
        return counts

# extract_features at its CLI defaults (b4 clips of 304 frames at 112 px,
# 16-frame windows): 19 windows a clip, 76 a batch.  The Swin's patch grid
# is 8 x 28 x 28, its window the full (8, 7, 7) (N = 392; T' = 8 fills one
# window, so T is not shifted).  K2 per forward, (name, W, N, heads, d,
# nW_img, launches): stage 0 and 1 shifted and not, stage 2 (7 x 7 clamps H
# and W: no shift) and stage 3 (4 x 4 after the merge, N = 128)
K2_EXTRACT = [("stage0-shifted", 1216, 392, 3, 32, 16, 1),
              ("stage0", 1216, 392, 3, 32, 0, 1),
              ("stage1-shifted", 304, 392, 6, 32, 4, 1),
              ("stage1", 304, 392, 6, 32, 0, 1),
              ("stage2", 76, 392, 12, 32, 0, 6),
              ("stage3", 76, 128, 24, 32, 0, 2)]
K2_EXTRACT_GRIDS = {16: (8, 28, 28), 4: (8, 14, 14)}
# K4 per extraction forward: the two shifted stages, each rolled by
# (0, 3, 3) before the attention and back after it
K4_EXTRACT = {"stage0": (76, 8, 28, 28, 96), "stage1": (76, 8, 14, 14, 192)}


def sdpa(q, k, v, am):
    return F.scaled_dot_product_attention(q, k, v, attn_mask=am)


def k2_extract_phase(card: str):
    """K2 at the extraction forward's shapes against its plain version at
    1e-4, each with its stage's real mask; at stage 0's shifted block
    (W = 1216, N = 392) the kernel's, the plain version's and SDPA's
    times cold (L2 flushed) and warm (back-to-back calls) against the
    bound; the kernel's warm time at every stage and per forward."""
    kw = dict(stage_mask=True, window=(8, 7, 7), grids=K2_EXTRACT_GRIDS)
    worst = 0.0
    for name, w, n, heads, d, nw, _ in K2_EXTRACT:
        qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed=31 + w, **kw)
        got = fused_window_attention(qkv, bias, mask, heads)
        torch.cuda.synchronize()
        ref = attention_core_reference(qkv, bias, mask, heads)
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        worst = max(worst, err)
        log(f"k2 extract {name}: W={w} N={n} heads={heads} d={d} nW_img={nw} "
            f"max_abs_err={err:.3e} <= 1e-4 ok")
        del qkv, bias, mask, got, ref
    info = launch_info("window_attention", 392, 32)
    log(f"k2 launch at N=392 d=32: {info['threads']} threads, "
        f"{info['dynamic_smem_bytes']} B dynamic smem, "
        f"{info['blocks_per_sm']} blocks per SM")

    out, fwd_ms, fwd_bound = {}, 0.0, 0.0
    labels = {"ms": "kernel", "plain_ms": "plain", "library_ms": "SDPA"}
    for name, w, n, heads, d, nw, launches in K2_EXTRACT:
        def make(i, w=w, n=n, heads=heads, d=d, nw=nw):
            return k2_inputs(w, n, heads, d, nw, seed=50 + i, **kw)

        call = rotating(make, n=2)
        fns = {"ms": call(
            lambda q, b, m, h=heads: fused_window_attention(q, b, m, h))}
        main = name == "stage0-shifted"
        if main:
            fns["plain_ms"] = call(
                lambda q, b, m, h=heads: attention_core_reference(q, b, m, h))
            fns["library_ms"] = rotating(
                lambda i: sdpa_args(*make(i), heads), n=2)(sdpa)
        # a launch takes 0.1-3 ms here, far above Python's dispatch: the
        # back-to-back calls of cuda_ms time the card, not the host
        warm = in_turns(fns, reps=10)
        bd = bound(card, *k2_work(w, n, heads, d, nw))
        fwd_ms += launches * warm["ms"]
        fwd_bound += launches * bd["bound_ms"]
        if main:
            cold = in_turns(fns, reps=10, timer=cold_ms)
            out.update({**cold, "warm": warm, "bound_ms": bd["bound_ms"],
                        "bound_by": bd["bound_by"],
                        "fma_bound_ms": bd["fma_bound_ms"],
                        "shape": {"W": w, "N": n, "heads": heads, "d": d,
                                  "nW_img": nw}, "launch": info})
            log(f"k2 extract {name} timing (cold) on {card}: " + ", ".join(
                f"{labels[k]} {v:.4f} ms" for k, v in cold.items())
                + f"; kernel at {bd['bound_ms'] / cold['ms'] * 100:.1f}% of "
                "the tensor-core bound")
        out.setdefault("warm_ms_by_stage", {})[name] = warm["ms"]
        log(f"k2 extract {name} x{launches} per forward (warm) on {card}: "
            + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in warm.items())
            + f"; {bound_text(bd)}; kernel at "
            f"{bd['bound_ms'] / warm['ms'] * 100:.1f}% of the tensor-core "
            "bound")
        del call, fns
    log(f"k2 per extraction forward (12 launches, warm): {fwd_ms:.4f} ms, "
        f"tensor-core bound {fwd_bound:.4f} ms "
        f"({fwd_bound / fwd_ms * 100:.1f}%)")
    return {"max_abs_err": worst, **out, "forward_ms": fwd_ms,
            "forward_bound_ms": fwd_bound}


# the self-attention kernels (ops/cuda/self_attention.py) at XLS-R's layer
# in the audio,text cell (B 32, 16 heads, 499 frames of a 10 s clip, d 64,
# attention dropout 0.1), and at B 2 for the element-by-element check
XLSR_ATTENTION = (32, 16, 499, 64, 0.1)


def self_attention_phase(card: str):
    """The bf16 self-attention pair against its plain version in f32 on the
    same uniforms (output and dqkv within one bf16 ulp + 3e-5 at B 2), its
    keep mask against `u < keep` bit for bit, each kernel bit for bit over
    two launches; then at B 32 each kernel's time cold (L2 flushed) and
    warm (CUDA graphs) against its bound, the eval forward (no dropout)
    warm, the layer's draw, and one layer's draw, forward and backward
    through the kernels and through the plain composition (CUDA events),
    with the peak memory each adds."""
    from multimodalaggressionrecognition_tpu_torch.ops.cuda import (
        self_attention as sa)

    b, heads, t, d, rate = XLSR_ATTENTION
    keep = 1.0 - rate
    g = torch.Generator(DEVICE).manual_seed(SEED + 41)

    def inputs(batch):
        qkv = (torch.randn(batch, t, 3 * heads * d, generator=g,
                           device=DEVICE) * 0.5).bfloat16()
        u = torch.rand((batch, heads, t, t), generator=g, device=DEVICE)
        cot = torch.randn(batch, t, heads * d, generator=g,
                          device=DEVICE).bfloat16()
        return qkv, u, cot

    qkv, u, cot = inputs(2)
    x = qkv.clone().requires_grad_(True)
    out = sa.self_attention(x, u, heads, keep)
    out.backward(cot)
    xf = qkv.float().requires_grad_(True)
    want = sa.self_attention_reference(xf, u, heads, keep)
    want.backward(cot.float())
    excess = {"out": bf16_elementwise_check("self_attention out",
                                            out.detach(),
                                            want.detach().bfloat16()),
              "dqkv": bf16_elementwise_check("self_attention dqkv", x.grad,
                                             xf.grad.bfloat16())}
    _, lse, bits = sa._launch_fwd(qkv, u, heads, keep, for_grad=True)
    shifts = torch.arange(32, dtype=torch.int32, device=DEVICE)
    kept = ((bits[..., None] >> shifts) & 1).flatten(-2).bool()
    if not (torch.equal(kept[..., :t], u < keep) and not kept[..., t:].any()):
        raise AssertionError("self_attention: keep bits are not u < keep")
    first = sa.self_attention_bwd(qkv, cot, lse, bits, heads, keep)
    again = sa.self_attention_bwd(qkv, cot, lse, bits, heads, keep)
    if not torch.equal(first.view(torch.int16), again.view(torch.int16)):
        raise AssertionError("self_attention_bwd: two launches differ")

    qkv, u, cot = inputs(b)
    _, lse, bits = sa._launch_fwd(qkv, u, heads, keep, for_grad=True)
    n = 2 * b * heads * t * t * d
    mask_bytes, lse_bytes = 4 * bits.numel(), 4 * lse.numel()
    qkv_bytes, out_bytes = 2 * qkv.numel(), 2 * cot.numel()
    bounds = {
        "fwd": bound(card, 2 * n, 4 * u.numel() + qkv_bytes + out_bytes
                     + mask_bytes + lse_bytes,
                     [(n, "bf16*bf16"), (n, "f32*bf16")]),
        "bwd": bound(card, 5 * n, 2 * qkv_bytes + out_bytes + mask_bytes
                     + lse_bytes,
                     [(n, "bf16*bf16")] * 2 + [(n, "f32*bf16")] * 3)}

    def fwd():
        return sa._launch_fwd(qkv, u, heads, keep, for_grad=True)

    def bwd():
        return sa.self_attention_bwd(qkv, cot, lse, bits, heads, keep)

    times = {"fwd": {"cold": cold_ms(fwd), "warm": graph_ms(fwd)},
             "bwd": {"cold": cold_ms(bwd), "warm": graph_ms(bwd)},
             "fwd_eval_warm": graph_ms(
                 lambda: sa._launch_fwd(qkv, None, heads, 1.0, False))}

    def layer(attend):
        x = qkv.clone().requires_grad_(True)
        uu = torch.rand((b, heads, t, t), generator=g, device=DEVICE)
        attend(x, uu, heads, keep).backward(cot)

    def events_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    times["draw"] = events_ms(
        lambda: torch.rand((b, heads, t, t), generator=g, device=DEVICE))
    layers = {}
    for name, attend in (("kernels", sa.self_attention),
                         ("plain", sa.self_attention_reference)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        layers[name] = {"draw_fwd_bwd_ms": events_ms(
            lambda: layer(attend)),
            "peak_added_mb": (torch.cuda.max_memory_allocated() - base)
            / 1e6}
    for k in ("fwd", "bwd"):
        times[k]["roofline_cold_pct"] = (100 * bounds[k]["bound_ms"]
                                         / times[k]["cold"])
        log(f"self_attention {k} b{b} T{t}: {times[k]['cold']:.4f} ms cold, "
            f"{times[k]['warm']:.4f} warm; {bound_text(bounds[k])}")
    log(f"self_attention layer (draw, forward, backward): kernels "
        f"{layers['kernels']['draw_fwd_bwd_ms']:.3f} ms, plain "
        f"{layers['plain']['draw_fwd_bwd_ms']:.3f} ms; draw "
        f"{times['draw']:.4f} ms; check excess {excess}")
    return {"times": times, "bounds": bounds, "layer": layers,
            "excess": excess, "launch": sa.launch_info(d, True),
            "resources": {lib: ptxas_usage(kernels.build_log(lib))
                          for lib in ("self_attention",
                                      "self_attention_bwd")}}


# GigaChat's text tower in the benchmark's cell: batch, padded length, and
# the b2 check's lengths
GIGACHAT_BATCH, GIGACHAT_TOKENS, GIGACHAT_LENGTHS = 32, 256, (256, 97)


def _events_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _gigachat_moe(cfg, g):
    """One MoE block of `cfg` in bf16 on the card, its weights drawn as the
    benchmark draws them (fan-in uniform, the correction bias 0.05 N)."""
    from multimodalaggressionrecognition_tpu_torch.models import gigachat

    moe = gigachat.MoE(cfg).to(DEVICE)
    with torch.no_grad():
        for name, p in moe.named_parameters():
            fan = p.shape[-1]
            p.copy_((torch.rand(p.shape, generator=g, device=DEVICE) * 2 - 1)
                    / math.sqrt(fan))
        moe.gate.e_score_correction_bias.copy_(
            0.05 * torch.randn(cfg.router_experts, generator=g,
                               device=DEVICE))
    return moe.bfloat16()


def gigachat_phase(card: str):
    """GigaChat3.1's tower at its published widths on the benchmark's
    share (models/gigachat.py `GIGACHAT3_1_EP32`), in bf16: at b2 (lengths
    256 and 97) one MoE block's output and gradients through the grouped
    products against the per-expert loop, the held-rows counter against the
    reference router's rows (portbench/reference/gigachat.py `route`, in
    f32 on the same inputs), the grouped block's step under CUDA's sync
    debug mode "error"; the causal attention at head dim 192 through flash
    against the composition (f32 scores), forward and backward; then at the
    cell's b32 x 256 each block's forward and backward (CUDA events), the
    grouped block against the loop, flash against the composition, the
    peak memory each adds, and the kernels a MoE block launches."""
    from multimodalaggressionrecognition_tpu_torch.models import gigachat
    from portbench.reference import gigachat as ref_gigachat

    cfg = gigachat.GIGACHAT3_1_EP32
    g = torch.Generator(DEVICE).manual_seed(SEED + 43)
    moe = _gigachat_moe(cfg, g)

    def block(b, lengths):
        x = torch.randn(b, GIGACHAT_TOKENS, cfg.hidden_size, generator=g,
                        device=DEVICE).bfloat16()
        valid = (torch.arange(GIGACHAT_TOKENS, device=DEVICE)[None]
                 < torch.tensor(lengths, device=DEVICE)[:, None])
        cot = torch.randn(x.shape, generator=g, device=DEVICE).bfloat16()
        return x, valid, cot

    def looped(x, valid):
        """The block with its held experts by the per-expert loop, on the
        block's own routing and sorted rows."""
        flat = x.reshape(-1, cfg.hidden_size)
        ids, w = moe.gate(flat)
        key = gigachat.held_keys(ids, valid.reshape(-1), cfg.first_expert,
                                 cfg.experts_held)
        order, counts, keep, ws = gigachat.sort_assignments(
            key, w, cfg.experts_held, x.dtype)
        routed = gigachat.held_experts_loop(
            flat, order, counts, keep, ws, moe.experts.gate_up_proj,
            moe.experts.down_proj)
        return routed.view(x.shape) + moe.shared_experts(x)

    def run(impl, x, valid, cot):
        """The block's output and gradients: "grouped" is the block's own
        forward on a CUDA bf16 input, "loop" the per-expert loop."""
        moe.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        out = moe(xi, valid) if impl == "grouped" else looped(xi, valid)
        out.backward(cot)
        return [out.detach(), xi.grad] + [p.grad for p in moe.parameters()]

    x, valid, cot = block(2, GIGACHAT_LENGTHS)
    moe.rows = None
    grouped = run("grouped", x, valid, cot)
    rows = moe.rows.clone()
    loop = run("loop", x, valid, cot)
    names = ["out", "dx"] + [n for n, _ in moe.named_parameters()]
    gaps = {n: _gap(a, b) for n, a, b in zip(names, grouped, loop)}
    if max(gaps.values()) > 2e-2:
        raise AssertionError(f"gigachat grouped against loop: {gaps}")
    flat = x.reshape(-1, cfg.hidden_size).float()
    ids, _ = ref_gigachat.route(
        flat, moe.gate.weight.float(), moe.gate.e_score_correction_bias,
        {**dataclasses.asdict(cfg)}, types.SimpleNamespace(r=lambda t: t))
    first, held = cfg.first_expert, cfg.experts_held
    chosen = ids[valid.reshape(-1)]
    want = torch.stack([(chosen == first + e).sum() for e in range(held)])
    if not torch.equal(rows, want):
        raise AssertionError(f"gigachat rows {rows.tolist()} against the "
                             f"reference router's {want.tolist()}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run("grouped", x, valid, cot)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    heads, d = cfg.num_attention_heads, cfg.qk_head_dim
    scale = gigachat.softmax_scale(cfg)

    def qkv(b):
        return [(torch.randn(b, heads, GIGACHAT_TOKENS, d, generator=g,
                             device=DEVICE)).bfloat16().requires_grad_(True)
                for _ in range(3)]

    def composed(q, k, v):
        return gigachat.causal_attention(q.float(), k.float(), v.float(),
                                         scale)

    q, k, v = qkv(2)
    cot_a = torch.randn(q.shape, generator=g, device=DEVICE).bfloat16()
    out = gigachat.causal_attention(q, k, v, scale)
    flash = [out.detach()] + list(torch.autograd.grad(out, (q, k, v), cot_a))
    out = composed(q, k, v)
    plain = [out.detach()] + list(torch.autograd.grad(out, (q, k, v),
                                                      cot_a.float()))
    attention_gaps = {n: _gap(a, b) for n, a, b in zip(
        ("out", "dq", "dk", "dv"), flash, plain)}
    if max(attention_gaps.values()) > 2e-2:
        raise AssertionError(f"gigachat flash against the composition: "
                             f"{attention_gaps}")

    b = GIGACHAT_BATCH
    x, valid, cot = block(b, [GIGACHAT_TOKENS] * b)
    times, peaks = {}, {}
    for impl in ("grouped", "loop"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times[f"moe_{impl}"] = _events_ms(lambda: run(impl, x, valid, cot),
                                          reps=3)
        peaks[f"moe_{impl}"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run("grouped", x, valid, cot)
        torch.cuda.synchronize()
    moe_kernels = sorted(
        ((e.key, e.device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_time_total > 0),
        key=lambda r: -r[1])[:16]
    q, k, v = qkv(b)
    cot_a = torch.randn(q.shape, generator=g, device=DEVICE).bfloat16()
    for name, attend in (("flash", gigachat.causal_attention),
                         ("composed", composed)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def step():
            out = attend(q, k, v, scale) if name == "flash" else attend(
                q, k, v)
            torch.autograd.grad(out, (q, k, v), cot_a.to(out.dtype))

        times[f"attention_{name}"] = _events_ms(step, reps=3)
        peaks[f"attention_{name}"] = (torch.cuda.max_memory_allocated()
                                      - base) / 1e9
    mla = gigachat.MLA(cfg).to(DEVICE).bfloat16()
    cos, sin = gigachat.rope_tables(cfg, GIGACHAT_TOKENS, DEVICE)
    xm = torch.randn(b, GIGACHAT_TOKENS, cfg.hidden_size, generator=g,
                     device=DEVICE).bfloat16().requires_grad_(True)

    def mla_step():
        mla(xm, cos, sin).backward(cot)

    times["mla"] = _events_ms(mla_step, reps=3)
    log(f"gigachat b{b} x {GIGACHAT_TOKENS}: MoE block fwd+bwd grouped "
        f"{times['moe_grouped']:.2f} ms ({peaks['moe_grouped']:.2f} GB), "
        f"loop {times['moe_loop']:.2f} ms; MLA fwd+bwd {times['mla']:.2f} ms; "
        f"attention flash {times['attention_flash']:.2f} ms, composed "
        f"{times['attention_composed']:.2f} ms; rows {rows.tolist()}; "
        f"grouped vs loop {gaps}; flash vs composed {attention_gaps}; "
        f"{card}")
    return {"times_ms": times, "peak_added_gb": peaks, "gaps": gaps,
            "attention_gaps": attention_gaps, "rows_b2": rows.tolist(),
            "moe_kernels": moe_kernels}


def gigachat_routing_phase(card: str, batch: int = 4):
    """The routing of the benchmark cell's tower at its published widths
    against the plain reference's: the cell's configuration, the
    benchmark's weights and token-id batch for one seed, the port's tower
    in bf16 (the step's casts) and the reference's with bf16 products; the
    share of the valid tokens' chosen experts both chose, per MoE layer,
    and the features' distance."""
    import json as _json

    from torch.func import functional_call

    from multimodalaggressionrecognition_tpu_torch.models import gigachat
    from multimodalaggressionrecognition_tpu_torch.utils.precision import (
        cast_floating)
    from portbench import inputs
    from portbench.models import physverb_gigachat as GM
    from portbench.reference import gigachat as G
    from portbench.reference import model as M

    with open("portbench/configs/audiotext_gigachat31_ep32.json") as f:
        cfg = _json.load(f)
    spec = [s for s in G.parameter_spec(cfg, ("text",))
            if s[0].startswith(G.PRE + ".")]
    weights = inputs.make_weights(spec, SEED + 47, DEVICE)
    g = torch.Generator(DEVICE).manual_seed(SEED + 47)
    text = GM.make_batch(g, cfg, ("text",), batch, (), DEVICE)[
        "modalities"]["text"]
    ids, lengths = text["data"], text["lengths"]
    tower = gigachat.GigaChatTextExtractor(GM.port_config(cfg)).to(DEVICE)
    pre = G.PRE + "."
    tower.load_state_dict({n[len(pre):]: w for n, w in weights.items()})
    seen = []
    for layer in tower.model.layers:
        if layer.moe:
            layer.mlp.gate.register_forward_hook(
                lambda m, a, out: seen.append(out[0]))
    with torch.no_grad():
        feats = functional_call(tower, cast_floating(
            dict(tower.named_parameters()), torch.bfloat16),
            (ids, lengths)).float()
    del tower
    want = []
    route = G.route

    def recorded(*args, **kw):
        out = route(*args, **kw)
        want.append(out[0])
        return out

    G.route = recorded
    try:
        with torch.no_grad():
            ref = G.tower(ids, lengths, weights, cfg, M.Products("bf16"))
    finally:
        G.route = route
    valid = (torch.arange(ids.shape[1], device=DEVICE)[None]
             < lengths[:, None]).reshape(-1)
    agreement = []
    for a, b in zip(seen, want):
        a, b = a[valid], b[valid]
        hit = (a[:, :, None] == b[:, None, :]).any(-1).sum()
        agreement.append(float(hit) / a.numel())
    gap = float((feats - ref).norm() / ref.norm())
    log(f"gigachat routing at b{batch} x {ids.shape[1]}, published widths, "
        f"bf16 port against the reference's bf16 products: agreement "
        f"{[round(x, 5) for x in agreement]} by MoE layer, features "
        f"{gap:.3e}; {card}")
    return {"agreement": agreement, "features_gap": gap,
            "valid_tokens": int(valid.sum())}


# the tri-modal cells' clip batch, (B, T, H, W, C), and the Swin's patch
PATCH_EMBED = ((32, 128, 112, 112, 3), (2, 4, 4), 96)


def _gap(got, want):
    """max |got - want| over max |want|."""
    want = want.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def patch_embed_phase(card: str):
    """The Swin's patch embedding as one patch GEMM (models/swin3d.py
    `PatchEmbed3d`) at the tri-modal cells' b32 clips, in f32 (TF32 off)
    and bf16: the output, dW and db against the same product in f64 (within
    1e-5 of the largest in f32, 1e-2 in bf16; the conv's own distance
    beside it) and the output against F.conv3d's; dX at b2 against the
    conv's autograd; the forward and the backward (dW, db: what a step
    asks) cold (L2 flushed) and warm (CUDA graphs) against their bound and
    against F.conv3d and cuDNN's backward of it on the permuted clip, as
    nn3d.Conv3d ran it (`library_ms`); the peak memory a forward and
    backward adds through each module."""
    shape, kernel, c_out = PATCH_EMBED
    g = torch.Generator(DEVICE).manual_seed(SEED + 43)
    out = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        label = str(dtype).split(".")[-1]
        embed = PatchEmbed3d(shape[-1], c_out, kernel).to(DEVICE)
        conv = Conv3d(shape[-1], c_out, kernel, stride=kernel).to(DEVICE)
        conv.load_state_dict(embed.state_dict())

        small = torch.randn((2,) + shape[1:], generator=g,
                            device=DEVICE).to(dtype)
        xs = [small.clone().requires_grad_(True) for _ in range(2)]
        ys = [m(x) for m, x in zip((embed, conv), xs)]
        cot = torch.randn(ys[0].shape, generator=g, device=DEVICE).to(dtype)
        for y in ys:
            y.backward(cot)
        gaps = {"dx_b2": _gap(xs[0].grad, xs[1].grad)}
        embed.zero_grad(set_to_none=True)
        conv.zero_grad(set_to_none=True)

        x = torch.rand(shape, generator=g, device=DEVICE).to(dtype)
        w = embed.weight.detach().to(dtype)
        b = embed.bias.detach().to(dtype)
        y = patch_gemm(x, w, b, kernel)
        dy = torch.randn(y.shape, generator=g, device=DEVICE).to(dtype)
        ctx = types.SimpleNamespace(saved_tensors=(x, w), kernel=kernel,
                                    needs_input_grad=(False, True, True,
                                                      False))
        xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)

        def fwd():
            return patch_gemm(x, w, b, kernel)

        def bwd():
            return _PatchGemm.backward(ctx, dy)

        def conv_fwd():
            return F.conv3d(xc, w, b, stride=kernel)

        def conv_bwd():
            return torch.ops.aten.convolution_backward(
                dyc, xc, w, [c_out], list(kernel), [0] * 3, [1] * 3, False,
                [0] * 3, 1, [False, True, True])

        _, dw, db, _ = bwd()
        yc = conv_fwd().permute(0, 2, 3, 4, 1)
        _, dwc, dbc = conv_bwd()
        p64, dy64 = _patches(x.double(), kernel), dy.double().reshape(
            -1, c_out)
        want = {"out": torch.addmm(b.double(), p64,
                                   w.double().permute(0, 2, 3, 4, 1).reshape(
                                       c_out, -1).t()),
                "dw": dy64.t().mm(p64).view(c_out, *kernel, shape[-1])
                .permute(0, 4, 1, 2, 3),
                "db": dy64.sum(0)}
        del p64, dy64
        for key, got, lib in (("out", y.reshape(-1, c_out),
                               yc.reshape(-1, c_out)),
                              ("dw", dw, dwc), ("db", db, dbc)):
            gaps[key] = _gap(got, want[key])
            gaps["conv_" + key] = _gap(lib, want[key])
        gaps["out_vs_conv"] = _gap(y, yc)
        del want, yc, dwc, dbc
        bad = {k: v for k, v in gaps.items()
               if not k.startswith("conv_") and v > tol}
        if bad:
            raise AssertionError(f"patch embedding {label}: {bad} > {tol}")

        n = y.numel() // c_out
        k = math.prod(kernel) * shape[-1]
        flops = 2 * n * k * c_out
        size = x.element_size()
        products = None if dtype == torch.float32 else [
            (flops, "bf16*bf16")]
        bounds = {"fwd": bound(card, flops, size * (x.numel() + y.numel()),
                               products),
                  "bwd": bound(card, flops + n * c_out,
                               size * (x.numel() + dy.numel()), products)}
        times = {"fwd": {"cold": cold_ms(fwd), "warm": graph_ms(fwd),
                         "library_ms": cold_ms(conv_fwd, reps=5)},
                 "bwd": {"cold": cold_ms(bwd), "warm": graph_ms(bwd),
                         "library_ms": cold_ms(conv_bwd, reps=3)}}
        for key, t in times.items():
            t["bound_ms"] = bounds[key]["bound_ms"]
            t["roofline_cold_pct"] = 100 * t["bound_ms"] / t["cold"]
            log(f"patch embedding {key} {label} b{shape[0]}: {t['cold']:.4f} "
                f"ms cold, {t['warm']:.4f} warm; F.conv3d"
                f"{' backward' if key == 'bwd' else ''} "
                f"{t['library_ms']:.4f}; {bound_text(bounds[key])}")
        del y, dw, db, ctx
        peak = {}
        for name, m in (("gemm", embed), ("conv", conv)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            m(x).backward(dy)
            torch.cuda.synchronize()
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 1e6
        log(f"patch embedding {label}: gaps {gaps} (<= {tol} but the "
            f"conv's); peak added by forward and backward {peak} MB")
        out[label] = {"times": times, "bounds": bounds, "gaps": gaps,
                      "peak_added_mb": peak, "calls": embed.calls}
        del x, dy, xc, dyc, embed, conv
        torch.cuda.empty_cache()
    return out


def k2_extract_bf16_phase(card: str):
    """K2 in bf16 at every shape of the bf16 extraction forward (K2_EXTRACT:
    qkv and the cast bias table's bias bf16, each stage's real mask f32)
    against its bf16 plain version within BF16_TOL of the largest output
    and element by element (bf16_elementwise_check), as bf16_kernel_phase
    holds it at N = 196; at stage 0's shifted block
    (W = 1216, N = 392, 3 heads, d 32, nW_img 16) the kernel's, the plain
    version's and SDPA's (bf16) times cold (L2 flushed) and warm (back to
    back) against the bound with bf16 bytes."""
    kw = dict(stage_mask=True, window=(8, 7, 7), grids=K2_EXTRACT_GRIDS)
    worst = 0.0
    for name, w, n, heads, d, nw, _ in K2_EXTRACT:
        qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed=70 + w, **kw)
        q16, b16 = qkv.to(BF16), bias.to(BF16)
        del qkv, bias
        got = fused_window_attention(q16, b16, mask, heads)
        want = attention_core_reference(q16, b16, mask, heads)
        err = bf16_check(f"k2 bf16 extract {name}", got, want)
        excess = bf16_elementwise_check(f"k2 bf16 extract {name}", got, want)
        worst = max(worst, err)
        log(f"bf16 k2 extract {name}: W={w} N={n} heads={heads} d={d} "
            f"nW={nw}, bf16 in and out: {err:.3e} of the largest <= "
            f"{BF16_TOL}, element by element within one bf16 ulp + "
            f"{BF16_ULP_SLACK} (excess {excess:.3e}) ok")
        del q16, b16, mask, got, want
    name, w, n, heads, d, nw, _ = K2_EXTRACT[0]

    def make(i):
        qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed=70 + i, **kw)
        return qkv.to(BF16), bias.to(BF16), mask

    call = rotating(make, n=2)
    fns = {"ms": call(lambda q, b, m: fused_window_attention(q, b, m, heads)),
           "plain_ms": call(lambda q, b, m: attention_core_reference(
               q, b, m, heads)),
           # yardstick only: the one PyTorch call for the same function
           "library_ms": rotating(lambda i: sdpa_args_bf16(*make(i), heads),
                                  n=2)(sdpa)}
    cold = in_turns(fns, reps=10, timer=cold_ms)
    warm = in_turns(fns, reps=10)
    work = k2_work_bf16(w, n, heads, d, nw)
    bd = bound(card, *work)
    labels = {"ms": "kernel", "plain_ms": "plain", "library_ms": "SDPA"}
    for label, t in (("cold", cold), ("warm", warm)):
        log(f"bf16 k2 extract {name} timing ({label}) on {card}: "
            + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in t.items())
            + f"; {work[1] / 1e6:.1f} MB; {bound_text(bd)}; kernel at "
            f"{bd['bound_ms'] / t['ms'] * 100:.1f}% of the bound")
    del call, fns
    return {**cold, "warm": warm, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "max_abs_err": worst,
            "shape": [w, n, heads, d, nw]}


def k4_extract_phase(card: str):
    """K4 at the extraction forward's two shifted stages, both signs, in
    f32 and in bf16 (the bf16 extraction's), bit for bit against
    torch.roll; the kernel's, the plain version's and torch.roll's times
    (f32) cold and warm against the bytes bound."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    for stage, shape in K4_EXTRACT.items():
        x32 = torch.randn(shape, generator=g, device=DEVICE)
        for x in (x32, x32.to(BF16)):
            for shifts in ((0, 3, 3), (0, -3, -3)):
                got = circular_roll(x, shifts)
                torch.cuda.synchronize()
                want = roll_reference(x, shifts)
                if not (got.dtype == x.dtype and torch.equal(
                        got.view(torch.uint8), want.view(torch.uint8))):
                    raise AssertionError(f"k4 extract {stage} {x.dtype} "
                                         f"{shifts}: differs from torch.roll")
        log(f"k4 extract {stage}: {shape} by (0, +-3, +-3) in f32 and bf16 "
            "bitwise equal to torch.roll ok")
        del x, x32, got, want
    out = {"max_abs_err": 0.0}
    labels = {"ms": "kernel", "plain_ms": "plain (torch.roll)",
              "library_ms": "torch.roll"}
    for stage, shape in K4_EXTRACT.items():
        def make(i, shape=shape):
            gi = torch.Generator(device=DEVICE).manual_seed(300 + i)
            return (torch.randn(shape, generator=gi, device=DEVICE),)

        call = rotating(make)
        fns = {"ms": call(lambda x: circular_roll(x, (0, -3, -3))),
               "plain_ms": call(lambda x: roll_reference(x, (0, -3, -3))),
               "library_ms": call(lambda x: torch.roll(x, (3, 3), (2, 3)))}
        cold = in_turns(fns, reps=20, timer=cold_ms)
        warm = in_turns(fns, reps=20, timer=graph_ms)
        nbytes = 2 * 4 * int(np.prod(shape))
        bd = bound(card, 0, nbytes)
        for label, t in (("cold", cold), ("warm", warm)):
            log(f"k4 extract {stage} {shape} timing ({label}) on {card}: "
                + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in t.items())
                + f"; {nbytes / 1e6:.1f} MB; bound {bd['bound_ms']:.4f} ms "
                f"(bytes); kernel at {bd['bound_ms'] / t['ms'] * 100:.1f}% "
                "of the bound")
        numbers = {**cold, "warm": warm, "bound_ms": bd["bound_ms"],
                   "bound_by": "bytes", "shape": list(shape),
                   "shifts": [0, -3, -3]}
        if stage == "stage0":
            out.update(numbers)
        else:
            out[stage] = numbers
        del call, fns
    return out


# train3dcnn at its defaults (b8, 32 frames at 112 px, 4 classes, alpha
# 0.4) on 16 + 8 synthetic clip dirs written at 112 px (no host resize;
# the paired augmentation runs on every train clip)
CLIPS_3D = dict(n_train=16, n_test=8, frames=32, hw=112)


def train3dcnn_phase(card_line):
    """(a) R3DWithBboxes' loss, logits and every gradient at b2, full
    width, eval mode, card against CPU, each run against float64 on its
    own ReLU decisions (replay_parity); (b) cli.train3dcnn.main at its
    defaults, 2 epochs: no hand-written kernel; the logs and checkpoints;
    (c) the median step time, the peak memory, the kernel families with
    cuDNN's conv forward, dgrad and wgrad apart, the busy share."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train3dcnn as cli)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        make_synthetic_clips)

    cfg = cli.Cnn3DConfig()
    model = randomize_norms(seeded_init_(cli.make_model(cfg), SEED))
    g = torch.Generator().manual_seed(SEED + 16)
    size, frames = cfg.video_size, cfg.frame_num
    video = torch.rand((2, frames, size, size, 3), generator=g)
    mask = torch.zeros((2, frames, size, size, 1))
    mask[0, :, 20:90, 30:70] = 1.0
    mask[1, 4:, 10:60, 50:110] = 1.0
    batch = labelled({"video": video}, 2)
    batch["modalities"]["video"]["mask"] = mask
    parity = replay_parity("train3dcnn", model, batch,
                           {"main": LossSpec("ce")}, num_classes=4)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "clips")
        make_synthetic_clips(root, seed=SEED, **CLIPS_3D)
        args = ["--files_root", root, "--saving_dir",
                os.path.join(tmp, "runs"), "--run_name", "r", "--epoch_num",
                "2", "--device", DEVICE, "--num_threads", "4"]
        counts, _, batch, timing = train_cli_phase(
            "train3dcnn", cli, args, card_line, {}, parity, split_conv=True)
        bf16_cli_phase("train3dcnn", cli, args, card_line, batch, timing, {},
                       cpu_frames=8)
        return counts


# extract_features: 4 train and 4 test clips of 304 frames at 112 px, one
# augmented re-extraction of the train split (--num_epochs 1)
EXTRACT_CLIPS = dict(n_train=4, n_test=4, frames=304, hw=112)
EXTRACT_DIMS = {"swin3d_t": 768, "r3d18": 512, "s3d": 1024}
PER_EXTRACT_FORWARD = {"swin3d_t": {"window_attention": 12, "roll": 4},
                       "r3d18": {}, "s3d": {}}


def extract_backbone(backbone, root, tmp, card_line):
    """One backbone: (a) features of one clip card against CPU, 1e-3 of
    the largest; (b) cli.extract_features.main at its defaults with the
    launch counts reset just before and read just after: each forward
    launches PER_EXTRACT_FORWARD, the files' names and (19, D) shapes;
    (c) the device ms of a batch forward, its kernel families, and the
    host-clock ms per batch and clips/s of a 3-batch split with the lag-1
    readback and with MAR_EXTRACT_PIPELINE=0, in turns."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        extract_features as cli)

    cfg = cli.parse_config(cli.ExtractConfig, ["--backbone", backbone,
                                               "--swin_gelu", "poly"])
    dim, per_forward = EXTRACT_DIMS[backbone], PER_EXTRACT_FORWARD[backbone]
    windows = cfg.frame_num // cfg.window
    model = randomize_norms(seeded_init_(cli.make_extractor(cfg), SEED))
    clip = torch.rand((1, cfg.frame_num, 112, 112, 3),
                      generator=torch.Generator().manual_seed(SEED + 17))
    gpu = copy.deepcopy(model).to(DEVICE)
    with torch.inference_mode():
        want = model(clip)
        torch.cuda.synchronize()
        kernels.launch_counts.clear()
        got = gpu(clip.to(DEVICE))
        torch.cuda.synchronize()
        one = dict(kernels.launch_counts)
    got = got.cpu()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if (got.shape != (1, windows, dim) or not torch.isfinite(got).all()
            or err > 1e-3 * scale or one != per_forward):
        raise AssertionError(f"extract {backbone}: card features "
                             f"{tuple(got.shape)} differ by {err:.3e} (max "
                             f"{scale:.3e}); a forward launched {one}")
    log(f"extract {backbone} parity: b1 x {cfg.frame_num} frames, card vs "
        f"cpu max |d| {err:.3e} (largest {scale:.3e}) <= 1e-3 of it ok; "
        f"launches per forward {one}")

    out = os.path.join(tmp, f"out_{backbone}")
    args = ["--files_root", root, "--out_root", out, "--backbone", backbone,
            "--num_epochs", "1", "--swin_gelu", "poly", "--device", DEVICE,
            "--seed", str(SEED)]
    torch.cuda.synchronize()
    kernels.launch_counts.clear()  # count this path only
    t0 = time.monotonic()
    cli.main(args)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the main path
    run_s = time.monotonic() - t0
    forwards = 3  # test, train/0, train/1: one batch of 4 clips each
    if counts != {k: v * forwards for k, v in per_forward.items()}:
        raise AssertionError(f"extract {backbone}: {forwards} forwards "
                             f"launched {counts}, want {per_forward} each")
    for sub in ("test", "train/0", "train/1"):
        split = "test" if sub == "test" else "train"
        want_names = sorted(f[:-3] + ".npy" for f in os.listdir(
            os.path.join(root, split)))
        names = sorted(os.listdir(os.path.join(out, sub)))
        if names != want_names:
            raise AssertionError(f"extract {backbone}: {sub} holds {names}")
        for f in names:
            a = np.load(os.path.join(out, sub, f))
            if a.shape != (windows, dim) or not np.isfinite(a).all():
                raise AssertionError(f"extract {backbone}: {sub}/{f} "
                                     f"{a.shape}")
    log(f"extract {backbone} main path on {card_line}: test, train/0, "
        f"train/1 of 4 clips each written, ({windows}, {dim}) per clip, "
        f"launches {counts}, run {run_s:.1f} s")

    batch = torch.rand((cfg.batch_size, cfg.frame_num, 112, 112, 3),
                       generator=torch.Generator().manual_seed(SEED + 18)
                       ).to(DEVICE)
    times = []
    with torch.inference_mode():
        gpu(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            gpu(batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        families = kernel_breakdown(lambda: gpu(batch), reps=2,
                                    split_conv=True)
    forward_ms = float(np.median(times))
    busy = sum(families.values())
    del batch

    # a 3-batch split: the 4 train clips under three names each
    timing = os.path.join(tmp, "timing")
    os.makedirs(timing, exist_ok=True)
    for f in sorted(os.listdir(os.path.join(root, "train"))):
        for k in range(3):
            link = os.path.join(timing, f"r{k}{f}")
            if not os.path.exists(link):
                os.symlink(os.path.join(root, "train", f), link)
    host = {"lag1": [], "sequential": []}
    device = torch.device(DEVICE)
    for mode in ("lag1", "sequential", "sequential", "lag1"):
        os.environ["MAR_EXTRACT_PIPELINE"] = "0" if mode == "sequential" else "1"
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n = cli.run_split(gpu, cfg, device, timing,
                          os.path.join(tmp, f"timing_out_{backbone}"))
        torch.cuda.synchronize()
        host[mode].append(time.monotonic() - t0)
    os.environ.pop("MAR_EXTRACT_PIPELINE")
    batches = -(-n // cfg.batch_size)
    rates = {m: {"ms_per_batch": min(v) / batches * 1e3,
                 "clips_per_s": n / min(v)} for m, v in host.items()}
    log(f"extract {backbone} on {card_line}: device forward b4 x "
        f"{cfg.frame_num} frames ({windows * cfg.batch_size} windows) "
        f"median {forward_ms:.3f} ms, peak {peak:.2f} GiB; kernels by "
        "family (ms per forward): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(families.items(),
                                              key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / forward_ms * 100:.1f}% busy; "
        f"{n} clips in {batches} batches, host clock: lag-1 "
        f"{rates['lag1']['ms_per_batch']:.1f} ms per batch "
        f"({rates['lag1']['clips_per_s']:.2f} clips/s), sequential "
        f"{rates['sequential']['ms_per_batch']:.1f} ms "
        f"({rates['sequential']['clips_per_s']:.2f} clips/s)")
    log(json.dumps({"extract": backbone, "batch": cfg.batch_size,
                    "frames": cfg.frame_num, "window": cfg.window,
                    "launches": counts, "launches_per_forward": one,
                    "parity_max_abs_err": err, "forward_ms": forward_ms,
                    "peak_gib": peak, "kernel_ms_by_family": families,
                    "kernel_busy_pct": busy / forward_ms * 100,
                    "host": rates}))
    return counts


def extract_bf16(backbone, root, tmp, card_line):
    """cli.extract_features.main --compute_dtype bfloat16 at its defaults on
    extract_backbone's clips (launch counts reset just before, read just
    after): every variable (BatchNorm statistics too) and the clips cast,
    as the JAX CLI does, so each Swin forward launches K2 12 and K4 4 in
    bf16 (K2 at N = 392) and R3D-18 and S3D none; the files f32 and (19,
    D), each within 0.1 of its largest value of the f32 run's file
    (tests/test_precision.py:92); one window's bf16 features of the model
    with extract_backbone's norms, card against CPU within 2e-2 of the
    largest; the device ms of a b4 forward in bf16 and f32, in turns."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        extract_features as cli)

    name = f"extract {backbone} bf16"
    dim = EXTRACT_DIMS[backbone]
    per_forward = {kernels.launch_key(k, BF16): v for k, v in
                   PER_EXTRACT_FORWARD[backbone].items()}
    out = os.path.join(tmp, f"out_{backbone}_bf16")
    f32_out = os.path.join(tmp, f"out_{backbone}")
    args = ["--files_root", root, "--out_root", out, "--backbone", backbone,
            "--num_epochs", "1", "--swin_gelu", "poly", "--device", DEVICE,
            "--seed", str(SEED), "--compute_dtype", "bfloat16"]
    torch.cuda.synchronize()
    kernels.launch_counts.clear()  # count this path only
    t0 = time.monotonic()
    cli.main(args)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the main path
    run_s = time.monotonic() - t0
    forwards = 3
    if counts != {k: v * forwards for k, v in per_forward.items()}:
        raise AssertionError(f"{name}: {forwards} forwards launched "
                             f"{counts}, want {per_forward} each")
    worst = 0.0
    for sub in ("test", "train/0", "train/1"):
        for f in sorted(os.listdir(os.path.join(f32_out, sub))):
            a = np.load(os.path.join(out, sub, f))
            want = np.load(os.path.join(f32_out, sub, f))
            err = float(np.abs(a - want).max() / np.abs(want).max())
            if a.dtype != np.float32 or a.shape != want.shape or not (
                    err <= 0.1):
                raise AssertionError(f"{name}: {sub}/{f} {a.dtype} "
                                     f"{a.shape}, {err:.3e} of the f32 "
                                     "file's largest")
            worst = max(worst, err)

    cfg = cli.parse_config(cli.ExtractConfig, ["--backbone", backbone,
                                               "--swin_gelu", "poly"])
    model = randomize_norms(seeded_init_(cli.make_extractor(cfg), SEED))
    clip = torch.rand((1, cfg.window, 112, 112, 3),
                      generator=torch.Generator().manual_seed(SEED + 19))
    cpu16 = copy.deepcopy(model).to(BF16)
    gpu32 = model.to(DEVICE)
    gpu16 = copy.deepcopy(gpu32).to(BF16)
    with torch.inference_mode():
        want = cpu16(clip.to(BF16)).float()
        got = gpu16(clip.to(DEVICE, BF16)).float().cpu()
        parity = ((got - want).abs().max() / want.abs().max()).item()
        if got.shape != (1, 1, dim) or not parity <= 2e-2:
            raise AssertionError(f"{name}: card vs cpu {parity:.3e} of the "
                                 "largest > 2e-2")
        batch = torch.rand((cfg.batch_size, cfg.frame_num, 112, 112, 3),
                           generator=torch.Generator().manual_seed(SEED + 18)
                           ).to(DEVICE)
        b16 = batch.to(BF16)
        ms = in_turns({"bf16": lambda: gpu16(b16), "f32": lambda: gpu32(batch)},
                      reps=3)
        torch.cuda.reset_peak_memory_stats()
        gpu16(b16)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        families = kernel_breakdown(lambda: gpu16(b16), reps=2,
                                    split_conv=True)
    attention = attention_family_ms(families, ms["bf16"],
                                    f"{name} b4 forward")
    del batch, b16, gpu16, gpu32, cpu16, model
    log(f"{name} main path on {card_line}: launches {counts} "
        f"({per_forward} per forward), run {run_s:.1f} s; files f32 within "
        f"{worst:.3e} of the f32 run's largest <= 0.1; one window card vs "
        f"cpu {parity:.3e} <= 2e-2 ok; device forward b4 x {cfg.frame_num} "
        f"frames bf16 {ms['bf16']:.3f} ms (f32 {ms['f32']:.3f} ms), peak "
        f"{peak:.2f} GiB; kernels by family (ms per forward): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(families.items(),
                                              key=lambda kv: -kv[1])))
    log(json.dumps({"extract": f"{backbone} bf16", "compute_dtype": "bfloat16",
                    "launches": counts, "launches_per_forward": per_forward,
                    "max_rel_err_vs_f32": worst, "parity_rel_err": parity,
                    "forward_ms": ms["bf16"], "f32_forward_ms": ms["f32"],
                    "peak_gib": peak, "kernel_ms_by_family": families,
                    **attention, "run_s": run_s}))
    return counts


def extract_phase(card_line):
    """extract_features with each backbone on the same clips, then each in
    bf16."""
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        make_synthetic_videos)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vids")
        make_synthetic_videos(root, seed=SEED, **EXTRACT_CLIPS)
        out = {f"extract_{b}": extract_backbone(b, root, tmp, card_line)
               for b in EXTRACT_DIMS}
        out.update({f"extract_{b}_bf16": extract_bf16(b, root, tmp, card_line)
                    for b in EXTRACT_DIMS})
        return out


def generate_features_phase(card_line):
    """(a) the tri-modal model's fused tokens at b2, full width, card
    against CPU, 1e-3 of the largest; (b) cli.generate_features.main at
    TRAIN's config on a synthetic table, the launch counts reset just
    before and read just after, against the batches its loaders give (K1
    once with audio, K2 12 and K4 4 times with video); the files and the
    manifest; host-clock ms per batch."""
    import pandas as pd

    from multimodalaggressionrecognition_tpu_torch.cli import (
        generate_features as cli)
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_multimodal)
    from multimodalaggressionrecognition_tpu_torch.cli.common import (
        ensure_dataset)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    modalities = ("audio", "text", "video")
    model = seeded_model(TRIMODAL, modalities)
    b = full_batch(TRIMODAL, modalities, 2, SEED + 19)
    gpu = copy.deepcopy(model).to(DEVICE)
    with torch.inference_mode():
        want = cli.fused_features(model, b)
        got = cli.fused_features(gpu, to_device(b, DEVICE))
    errs = {m: (got[m].cpu() - want[m]).abs().max().item()
            / want[m].abs().max().item() for m in want}
    if sorted(got) != list(modalities) or max(errs.values()) > 1e-3:
        raise AssertionError(f"generate_features parity: {errs}")
    log("generate_features parity: tri-modal b2 full width, fused tokens "
        "card vs cpu max |d| / max " + ", ".join(
            f"{m} {e:.3e}" for m, e in errs.items()) + " <= 1e-3 ok")
    del gpu
    with tempfile.TemporaryDirectory() as tmp:
        root, out = os.path.join(tmp, "avabos"), os.path.join(tmp, "fused")
        generate_synthetic_avabos(root, **TRAIN_DATA)
        args = ["--dataset_root", root, "--synthetic", "--modalities",
                ",".join(modalities), "--out_dir", out, "--device", DEVICE,
                "--num_threads", "4", "--seed", str(SEED)]
        for k in ("hidden_size", "fusion_layers", "fusion_heads",
                  "audio_samples", "text_tokens", "video_frames",
                  "video_size", "video_window", "batch_size"):
            args += [f"--{k}", str(TRAIN[k])]
        cfg = cli.parse_config(cli.GenFeaturesConfig, args)
        batches = [sorted(bt["modalities"]) for loader in
                   train_multimodal.make_loaders(cfg, *ensure_dataset(cfg),
                                                 modalities)
                   for bt in loader]
        expect = expected_launches(batches)
        torch.cuda.synchronize()
        kernels.launch_counts.clear()  # count this path only
        t0 = time.monotonic()
        cli.main(args)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)  # read just after the main path
        run_s = time.monotonic() - t0
        if counts != expect or not all(expect.get(k) for k in
                                       SCORED_KERNELS):
            raise AssertionError(f"generate_features: {len(batches)} "
                                 f"batches launched {counts}, want {expect}")
        manifest = pd.read_csv(os.path.join(out, "manifest.csv"))
        names = sorted(f[:-4] for f in os.listdir(out) if f.endswith(".npy"))
        if names != sorted(manifest["name"]) or len(names) < len(batches):
            raise AssertionError(f"generate_features: {len(names)} files, "
                                 f"manifest {len(manifest)}")
        sample = np.load(os.path.join(out, f"{names[0]}.npy"),
                         allow_pickle=True).item()
        shapes = {m: a.shape for m, a in sample.items()}
        if shapes != {"audio": (7, 768), "text": (48, 768),
                      "video": (16, 768)}:
            raise AssertionError(f"generate_features: {names[0]} {shapes}")
    log(f"generate_features main path on {card_line}: {len(batches)} "
        f"batches ({len(names)} samples), launches {counts}; run "
        f"{run_s:.1f} s, {run_s / len(batches) * 1e3:.1f} ms per batch on "
        "the host clock (data loading included)")
    return counts


# (22) quantized serving: (label, config, served batch, card-vs-CPU parity
# batch, launches per forward), at full width with seeded weights
QUANT_SLICES = [("audio,text", FLAGSHIP, BATCH, BATCH, {"framed_conv1d": 1}),
                ("audio,text,video", TRIMODAL, 8, 2,
                 {"framed_conv1d": 1, "window_attention": 12, "roll": 4})]
# (mode, compute dtype, the JAX tests' bound on |prob - f32 prob|:
# tests/test_quantize.py:79 (int8), :212 (w8a8))
QUANT_MODES = [("int8", None, 0.05), ("w8a8", None, 0.2),
               ("int8", "bfloat16", 0.05)]


class activation_codes:
    """The w8a8 layers' activation codes of one forward
    (utils/quantize.quantize_activations): recorded, or (`replay`) handed
    to another run's layers in the same order, counting the codes that
    differ from that run's own.  The int32 sums are exact, so two runs of
    the same w8a8 forward differ only where a code rounds the other way;
    one flip moves everything after it by ~1/127, so parity is held on
    the same codes, as the ReLU replays hold it on the same decisions."""

    def __init__(self, replay=None):
        self.codes = [] if replay is None else replay
        self.replay = replay is not None
        self.i = self.differ = self.total = 0

    def __enter__(self):
        from multimodalaggressionrecognition_tpu_torch.utils import quantize

        self.module, self.orig = quantize, quantize.quantize_activations

        def patched(x):
            xq, xscale = self.orig(x)
            self.total += xq.numel()
            if not self.replay:
                self.codes.append(xq.cpu())
                return xq, xscale
            want = self.codes[self.i].to(xq.device)
            self.i += 1
            self.differ += int((want != xq).sum())
            return want, xscale

        quantize.quantize_activations = patched
        return self

    def __exit__(self, *exc):
        self.module.quantize_activations = self.orig


def weight_bytes(model):
    """Bytes of a model's parameters and buffers (its resident weights)."""
    return sum(t.numel() * t.element_size()
               for t in [*model.parameters(), *model.buffers()])


def quantized_phase(card_line):
    """(22) Predictor(quantize=...) of the flagship (b32) and the tri-modal
    model (b8) at full width, int8 and w8a8 in f32 and the tri-modal int8
    in bf16: launches per forward (K1 1; tri-modal K2 12, K4 4), the
    probabilities against the card's f32 ones at the JAX tolerances, the
    card against the CPU within 1e-3 of the largest logit (w8a8 on the
    card's activation codes, the differing ones counted), the weights'
    bytes (tree_nbytes f32 against int8, resident on the card), device ms
    and peak memory per forward beside f32's, and the kernel families."""
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor
    from multimodalaggressionrecognition_tpu_torch.utils.quantize import (
        quantize_params, tree_nbytes)

    out = {}
    for label, cfg, bs, parity_n, per_forward in QUANT_SLICES:
        modalities = tuple(sorted(label.split(",")))
        model = seeded_model(cfg, modalities)
        batch = full_batch(cfg, modalities, bs, SEED + 30)
        clips = {m: v["data"].numpy() for m, v in batch.items()}
        small = {m: a[:parity_n] for m, a in clips.items()}
        p32 = Predictor(copy.deepcopy(model), batch_size=bs, device=DEVICE)
        want = p32.predict(clips)
        padded = p32._pad_batch(clips, bs)
        torch.cuda.reset_peak_memory_stats()
        f32_ms = cuda_ms(lambda: p32._forward(padded), reps=10)
        f32_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        params = dict(model.named_parameters())
        nbytes = {"f32": tree_nbytes(params),
                  "int8": tree_nbytes(quantize_params(params))}
        resident = {"f32": weight_bytes(p32.model)}
        del p32
        for mode, dtype, tol in QUANT_MODES:
            if dtype is not None and "video" not in modalities:
                continue
            key = f"{mode}{'' if dtype is None else '_bf16'}"
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            pq = Predictor(copy.deepcopy(model), batch_size=bs, device=DEVICE,
                           quantize=mode, compute_dtype=dtype)
            resident[key] = torch.cuda.memory_allocated() - before
            pq.predict(clips)  # first call: the constants' set-up
            torch.cuda.synchronize()
            kernels.launch_counts.clear()  # count this path only
            got = pq.predict(clips)
            torch.cuda.synchronize()
            counts = dict(kernels.launch_counts)  # read just after the path
            expect = per_forward if dtype is None else bf16_counts(
                per_forward)
            if counts != expect:
                raise AssertionError(f"quantized {label} {key}: a forward "
                                     f"launched {counts}, want {expect}")
            prob_err = max(float(np.abs(got[h] - want[h]).max())
                           for h in want)
            if not prob_err <= tol:
                raise AssertionError(f"quantized {label} {key}: |dprob| vs "
                                     f"f32 {prob_err} > {tol}")
            # the same quantized forward on the card and on the CPU, at the
            # parity batch
            card = Predictor(copy.deepcopy(model), batch_size=parity_n,
                             device=DEVICE, quantize=mode,
                             compute_dtype=dtype)
            cpu = Predictor(copy.deepcopy(model), batch_size=parity_n,
                            device="cpu", quantize=mode, compute_dtype=dtype)
            with activation_codes() as rec:
                card_logits = card.predict(small, return_probs=False)
            with activation_codes(rec.codes) as rep:
                cpu_logits = cpu.predict(small, return_probs=False)
            del card, cpu
            scale = max(float(np.abs(v).max()) for v in cpu_logits.values())
            err = max(float(np.abs(card_logits[h] - cpu_logits[h]).max())
                      for h in cpu_logits)
            # f32: 1e-3 of the largest logit; bf16 rounds each stored
            # activation to 2**-8 relative (3.9e-3), in another order on
            # each device, so its bound is 2e-2
            rel = 1e-3 if dtype is None else 2e-2
            if not err <= rel * scale or rep.i != len(rec.codes):
                raise AssertionError(
                    f"quantized {label} {key}: cuda vs cpu |dlogit| {err} > "
                    f"{rel} x {scale} (codes {rep.i} of {len(rec.codes)})")
            qpad = pq._pad_batch(clips, bs)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: pq._forward(qpad), reps=10)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            families = kernel_breakdown(lambda: pq._forward(qpad), reps=3)
            line = {"quantized": label, "mode": mode,
                    "compute_dtype": dtype or "float32", "batch": bs,
                    "launches": counts, "max_abs_prob_err_vs_f32": prob_err,
                    "cuda_vs_cpu_max_abs_logit_err": err,
                    "max_abs_logit": scale,
                    "codes_differ": rep.differ, "codes": rep.total,
                    "tree_nbytes": nbytes, "resident_bytes": resident[key],
                    "resident_bytes_f32": resident["f32"],
                    "forward_ms": ms, "forward_ms_f32": f32_ms,
                    "peak_gib": peak, "peak_gib_f32": f32_peak,
                    "kernel_ms_by_family": families}
            log(f"quantized {label} {key} b{bs} on {card_line}: launches "
                f"{counts} ok; max |dprob| vs the f32 card {prob_err:.3e} <= "
                f"{tol} ok; cuda vs cpu (b{parity_n}) max |dlogit| "
                f"{err:.3e} <= {rel} x {scale:.3e} ok, {rep.differ} of "
                f"{rep.total} activation codes differ; tree_nbytes f32 "
                f"{nbytes['f32']} int8 {nbytes['int8']}, resident "
                f"{resident[key]} B (f32 {resident['f32']}); forward "
                f"{ms:.3f} ms (f32 {f32_ms:.3f}), peak {peak:.2f} GiB (f32 "
                f"{f32_peak:.2f}); kernels by family: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sorted(
                        families.items(), key=lambda kv: -kv[1])))
            log(json.dumps(line))
            out[f"serve_{key}_{'trimodal' if 'video' in label else 'flagship'}"
                ] = counts
            del pq
        torch.cuda.empty_cache()
    out["serve_int8_video_rnn"] = quantized_rnn_phase(card_line)
    return out


def quantized_rnn_phase(card_line):
    """The video RNN heads (train_video_rnn at its defaults, b16 on 19 x
    512 features) served int8: cuDNN's GRU and LSTM on weights dequantized
    each forward and flattened into one buffer (cuDNN's warning about
    weights in several chunks is an error here), card against CPU within
    1e-3 of the largest logit, and the forward's device ms beside f32's:
    what the dequantization costs."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_video_rnn as cli)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    model = seeded_init_(cli.make_model(cli.VideoRnnConfig()), SEED).eval()
    clips = {"video": np.random.default_rng(SEED + 31).standard_normal(
        (16, 19, 512)).astype(np.float32)}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=UNFLATTENED_RNN)
        p32 = Predictor(copy.deepcopy(model), batch_size=16, device=DEVICE)
        pq = Predictor(copy.deepcopy(model), batch_size=16, device=DEVICE,
                       quantize="int8")
        pq.predict(clips)
        torch.cuda.synchronize()
        kernels.launch_counts.clear()
        got = pq.predict(clips, return_probs=False)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)
        want = Predictor(copy.deepcopy(model), batch_size=16, device="cpu",
                         quantize="int8").predict(clips,
                                                  return_probs=False)
        padded = pq._pad_batch(clips, 16)
        ms = {"f32": cuda_ms(lambda: p32._forward(padded), reps=20),
              "int8": cuda_ms(lambda: pq._forward(padded), reps=20)}
    scale = max(float(np.abs(v).max()) for v in want.values())
    err = max(float(np.abs(got[h] - want[h]).max()) for h in want)
    if counts or not err <= 1e-3 * scale:
        raise AssertionError(f"quantized video_rnn: launches {counts}, cuda "
                             f"vs cpu |dlogit| {err} > 1e-3 x {scale}")
    log(f"quantized video_rnn int8 b16 on {card_line}: no kernel, weights "
        f"flat; cuda vs cpu max |dlogit| {err:.3e} <= 1e-3 x {scale:.3e} "
        f"ok; forward {ms['int8']:.3f} ms (f32 {ms['f32']:.3f}): the "
        f"dequantization costs {ms['int8'] - ms['f32']:.3f} ms a forward")
    log(json.dumps({"quantized": "video_rnn", "mode": "int8", "batch": 16,
                    "launches": counts, "cuda_vs_cpu_max_abs_logit_err": err,
                    "forward_ms": ms["int8"], "forward_ms_f32": ms["f32"]}))
    return counts


def _exported_counts(exported, clips, label, expect):
    """One scored batch of an ExportedPredictor with the launch counts
    reset just before and read just after; returns its logits."""
    exported.predict(clips)
    torch.cuda.synchronize()
    kernels.launch_counts.clear()  # count this path only
    logits = exported.predict(clips, return_probs=False)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the path
    if counts != expect:
        raise AssertionError(f"export {label}: a forward launched {counts}, "
                             f"want {expect}")
    return logits, counts


def export_phase(card_line):
    """(23) torch.export artifacts at full width: the tri-modal model (b8,
    f32 and int8) and the flagship (b32, w8a8) exported on the card, and
    the flagship (f32) exported on the CPU and loaded on the card (nothing
    left on the CPU in its program); each held to the live Predictor
    (atol 1e-6 exported on the card, 1e-3 of the largest logit from the
    CPU), launching K1, K2 and K4 through the mar_torch:: ops; then both
    served by name (`serve --exported flag=<dir>,tri=<dir>`) over HTTP.
    The export time, the artifact bytes and the served forward ms."""
    from multimodalaggressionrecognition_tpu_torch.io.export import (
        ARTIFACT, ExportedPredictor, export_predictor, graph_ops)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    cases = [("tri_f32", "audio,text,video", TRIMODAL, 8, None, DEVICE),
             ("tri_int8", "audio,text,video", TRIMODAL, 8, "int8", DEVICE),
             ("flag_w8a8", "audio,text", FLAGSHIP, BATCH, "w8a8", DEVICE),
             ("flag_f32_from_cpu", "audio,text", FLAGSHIP, BATCH, None,
              "cpu")]
    out, dirs = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        for key, label, cfg, bs, mode, on in cases:
            modalities = tuple(sorted(label.split(",")))
            model = seeded_model(cfg, modalities)
            batch = full_batch(cfg, modalities, bs, SEED + 32)
            clips = {m: v["data"].numpy() for m, v in batch.items()}
            example = {m: a[:1] for m, a in clips.items()}
            live = Predictor(copy.deepcopy(model), batch_size=bs,
                             device=DEVICE, quantize=mode)
            source = live if on == DEVICE else Predictor(
                copy.deepcopy(model), batch_size=bs, device="cpu",
                quantize=mode)
            dirs[key] = os.path.join(tmp, key)
            t0 = time.monotonic()
            export_predictor(source, example, dirs[key])
            export_s = time.monotonic() - t0
            size = os.path.getsize(os.path.join(dirs[key], ARTIFACT))
            exported = ExportedPredictor(dirs[key], device=DEVICE)
            ops = {o for o in graph_ops(exported.program)
                   if o.startswith("mar_torch::")}
            stray = sorted({str(n.kwargs["device"])
                            for n in exported.program.graph.nodes
                            if "device" in n.kwargs
                            and torch.device(n.kwargs["device"]).type
                            != torch.device(DEVICE).type})
            if stray:
                raise AssertionError(f"export {key}: nodes on {stray}")
            expect = PER_FORWARD_LAUNCHES[label]
            got, counts = _exported_counts(exported, clips, key, expect)
            want = live.predict(clips, return_probs=False)
            scale = max(float(np.abs(v).max()) for v in want.values())
            err = max(float(np.abs(got[h] - want[h]).max()) for h in want)
            limit = 1e-6 if on == DEVICE else 1e-3 * scale
            if not err <= limit:
                raise AssertionError(f"export {key}: artifact vs live "
                                     f"|dlogit| {err} > {limit}")
            padded = exported._pad_batch(clips, bs)
            ms = cuda_ms(lambda: exported._forward(padded), reps=10)
            live_ms = cuda_ms(lambda: live._forward(padded), reps=10)
            log(f"export {key} ({label}, b{bs}, exported on {on}) on "
                f"{card_line}: {export_s:.1f} s, {size} B, ops "
                f"{sorted(ops)}, launches {counts} ok; artifact vs live "
                f"max |dlogit| {err:.3e} <= {limit:.1e} ok; forward "
                f"{ms:.3f} ms (live {live_ms:.3f})")
            log(json.dumps({"export": key, "batch": bs, "quantize": mode,
                            "exported_on": on, "export_s": export_s,
                            "artifact_bytes": size, "launches": counts,
                            "max_abs_logit_err": err, "forward_ms": ms,
                            "live_forward_ms": live_ms}))
            out[f"export_{key}"] = counts
            del live, source, exported
            torch.cuda.empty_cache()
        out["export_video_transformer_bf16"] = export_bf16_phase(
            tmp, card_line)
        out["serve_exported"] = serve_exported_phase(
            dirs["flag_w8a8"], dirs["tri_int8"], card_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def export_bf16_phase(tmp, card_line):
    """cli.export_model --entry train_video_transformer --compute_dtype
    bfloat16 at the entry's defaults (b8, 128 frames at 112 px) on the
    card, scored there: the frames come at the model's size (no resize),
    so the Swin runs in bf16 and each forward launches K2 12 and K4 4 in
    bf16 through the mar_torch:: ops; the artifact against a live bf16
    Predictor of the same seeded model within 1e-6."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        export_model, train_video_transformer as vt)
    from multimodalaggressionrecognition_tpu_torch.io.export import (
        ARTIFACT, ExportedPredictor)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    out_dir = os.path.join(tmp, "video_transformer_bf16")
    t0 = time.monotonic()
    export_model.main(["--entry", "train_video_transformer",
                       "--allow_random_weights", "true", "--compute_dtype",
                       "bfloat16", "--device", DEVICE, "--seed", str(SEED),
                       "--output_dir", out_dir])
    export_s = time.monotonic() - t0
    cfg = vt.VideoTransformerConfig()
    live = Predictor(seeded_init_(vt.make_model(cfg), SEED),
                     batch_size=cfg.batch_size, device=DEVICE,
                     compute_dtype="bfloat16")
    exported = ExportedPredictor(out_dir, device=DEVICE)
    g = torch.Generator().manual_seed(SEED + 33)
    clips = {"video": torch.rand((cfg.batch_size, cfg.video_frames,
                                  cfg.video_size, cfg.video_size, 3),
                                 generator=g).numpy()}
    expect = {kernels.launch_key("window_attention", BF16): 12,
              kernels.launch_key("roll", BF16): 4}
    got, counts = _exported_counts(exported, clips, "video_transformer_bf16",
                                   expect)
    want = live.predict(clips, return_probs=False)
    err = max(float(np.abs(got[h] - want[h]).max()) for h in want)
    if not (err <= 1e-6 and all(np.isfinite(v).all() for v in got.values())):
        raise AssertionError(f"export video_transformer_bf16: artifact vs "
                             f"live |dlogit| {err} > 1e-6")
    padded = exported._pad_batch(clips, cfg.batch_size)
    ms = cuda_ms(lambda: exported._forward(padded), reps=5)
    live_ms = cuda_ms(lambda: live._forward(padded), reps=5)
    size = os.path.getsize(os.path.join(out_dir, ARTIFACT))
    log(f"export video_transformer_bf16 (b{cfg.batch_size}, exported on "
        f"{DEVICE}) on {card_line}: {export_s:.1f} s, {size} B, launches "
        f"{counts} ok; artifact vs live bf16 max |dlogit| {err:.3e} <= 1e-6 "
        f"ok; forward {ms:.3f} ms (live {live_ms:.3f})")
    log(json.dumps({"export": "video_transformer_bf16",
                    "batch": cfg.batch_size, "compute_dtype": "bfloat16",
                    "export_s": export_s, "artifact_bytes": size,
                    "launches": counts, "max_abs_logit_err": err,
                    "forward_ms": ms, "live_forward_ms": live_ms}))
    del live, exported
    torch.cuda.empty_cache()
    return counts


PER_FORWARD_LAUNCHES = {label: per_forward
                        for label, _, _, _, per_forward in QUANT_SLICES}


def serve_exported_phase(flag_dir, tri_dir, card_line):
    """cli.serve --exported flag=<dir>,tri=<dir>: /healthz lists both,
    /score/<name> routes, /score is ambiguous (404); a request to each
    launches its kernels once per forward (flagship K1 1; tri-modal K1 1,
    K2 12, K4 4)."""
    srv = build_server(ServeConfig(exported=f"flag={flag_dir},tri={tri_dir}",
                                   device=DEVICE, port=0))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        health = _http(srv, "/healthz")
        if sorted(health["models"]) != ["flag", "tri"]:
            raise AssertionError(f"serve --exported: healthz {health}")
        rng = np.random.default_rng(SEED + 33)
        bodies = {
            "flag": _npz({m: a[0] for m, a in request(
                rng, FLAGSHIP, ("audio", "text"), 1).items()}),
            "tri": _npz({m: a[0] for m, a in request(
                rng, TRIMODAL, ("audio", "text", "video"), 1).items()})}
        try:
            _http(srv, "/score", bodies["flag"], "application/x-npz")
            raise AssertionError("serve --exported: /score answered with "
                                 "two models")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        torch.cuda.synchronize()
        kernels.launch_counts.clear()  # count this path only
        t0 = time.monotonic()
        for name, body in bodies.items():
            _check_scores(_http(srv, f"/score/{name}", body,
                                "application/x-npz"), 1)
        host_ms = (time.monotonic() - t0) * 1e3
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)  # read just after the path
        stats = _http(srv, "/statz")
        expect = dict(PER_FORWARD_LAUNCHES["audio,text,video"])
        expect["framed_conv1d"] += 1  # the flagship's forward
        if counts != expect or any(stats[n]["dispatches"] != 1
                                   for n in ("flag", "tri")):
            raise AssertionError(f"serve --exported: launches {counts}, "
                                 f"want {expect}; statz {stats}")
    finally:
        srv.shutdown()
        srv.server_close()
        for ep in srv.endpoints.values():
            ep.batcher.close()
        thread.join(timeout=60)
    log(f"serve --exported flag,tri on {card_line}: /score/flag and "
        f"/score/tri routed, /score 404, launches {counts} ok; two requests "
        f"{host_ms:.1f} ms on the host clock")
    log(json.dumps({"serve_exported": ["flag", "tri"], "launches": counts,
                    "host_ms_two_requests": host_ms}))
    return counts


def exported_scoring_phase(run_dir, tmp, card_line):
    """(23, continued) run (3)'s checkpoint_best_phys exported on the card
    (cli.export_model --from_run, b8), then cli.predict --exported on
    predict_phase's 8 raw clips and cli.evaluate --exported on the run's
    test split: the same probabilities (to the printed 4 places) and
    metrics as the same CLIs on the checkpoint; K1 1, K2 12 and K4 4 per
    scored batch (the artifact runs every tower, a missing modality as
    zeros with present=0)."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        evaluate, export_model, predict)

    ckpt = os.path.join(run_dir, "checkpoint_best_phys")
    art = os.path.join(tmp, "exported_best_phys")
    meta, _, export_s, _ = counted(lambda: export_model.main(
        ["--from_run", run_dir, "--path_to_checkpoint", ckpt,
         "--batch_size", "8", "--output_dir", art, "--device", DEVICE]))
    per = PER_FORWARD_LAUNCHES["audio,text,video"]
    files = ["--device", DEVICE]
    for m in ("audio", "text", "video"):
        files += [f"--{m}", os.path.join(tmp, f"predict_{m}")]
    rows = {}
    _, counts, pred_s, text = counted(lambda: predict.main(
        files + ["--exported", art]))
    rows["exported"] = [json.loads(line) for line in text.splitlines()]
    _, _, _, text = counted(lambda: predict.main(
        files + ["--from_run", run_dir, "--path_to_checkpoint", ckpt,
                 "--modalities", "audio,text,video", "--batch_size", "8"]))
    rows["checkpoint"] = [json.loads(line) for line in text.splitlines()]
    if counts != per or len(rows["exported"]) != PREDICT_CLIPS:
        raise AssertionError(f"predict --exported: launched {counts}, want "
                             f"{per}; rows {rows['exported']}")
    worst = max(abs(g[k] - w[k]) for g, w in zip(*rows.values())
                for k in ("phys_prob_aggr", "verb_prob_aggr"))
    if worst > 1e-4:
        raise AssertionError(f"predict --exported: {rows}")
    args = ["--from_run", run_dir, "--saving_dir",
            os.path.join(run_dir, "evaluate_exported"), "--num_threads", "4",
            "--device", DEVICE]
    got, ev_counts, eval_s, _ = counted(lambda: evaluate.main(
        args + ["--exported", art]))
    want, _, _, _ = counted(lambda: evaluate.main(
        args + ["--path_to_checkpoint", ckpt]))
    n_batches = ev_counts.get("framed_conv1d", 0)
    if not n_batches or ev_counts != {k: v * n_batches
                                      for k, v in per.items()}:
        raise AssertionError(f"evaluate --exported: launched {ev_counts}")
    for head in want:
        for metric in EVAL_METRICS:
            if got[head][metric] != want[head][metric]:
                raise AssertionError(
                    f"evaluate --exported: {head} {metric} "
                    f"{got[head][metric]} vs the checkpoint's "
                    f"{want[head][metric]}")
    log(f"exported scoring on {card_line}: export_model --from_run "
        f"{export_s:.1f} s; predict --exported {PREDICT_CLIPS} clips, "
        f"launches {counts}, probabilities within {worst:.1e} of the "
        f"checkpoint's ({pred_s:.2f} s host); evaluate --exported "
        f"{n_batches} batches, launches {ev_counts}, metrics equal to the "
        f"checkpoint's ({eval_s:.2f} s host)")
    log(json.dumps({"exported_scoring": "audio,text,video",
                    "export_s": export_s, "predict_launches": counts,
                    "evaluate_launches": ev_counts,
                    "max_prob_err": worst, "predict_host_s": pred_s,
                    "evaluate_host_s": eval_s,
                    "metrics": {h: {k: got[h][k] for k in EVAL_METRICS}
                                for h in got}, "meta": meta}))
    return {"predict_exported": counts, "evaluate_exported": ev_counts}


# the native host loaders (data/native.py): built from native/*.cpp here
NATIVE_THREADS = (1, 4, 8)
NATIVE_VGG_FILES = 32  # train wavs of the VGG's one-epoch runs (test n/4)


def _clip_ms(fn, n, reps=3):
    """Median host ms per clip of fn() over `reps` calls that decode n."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3 / n)
    return float(np.median(times))


def _mp4_clip_dir(tmp):
    """One clip dir holding a 16-frame 128 x 128 .mp4 (written with cv2)
    and its boxes; None when cv2 cannot write one."""
    import cv2

    clip = os.path.join(tmp, "clips", "clip0!person,0!(0,1)!Удары")
    os.makedirs(clip)
    rng = np.random.default_rng(SEED + 31)
    frames = rng.integers(0, 256, (16, 128, 128, 3), dtype=np.uint8)
    frames[:, :64] = 200
    path = os.path.join(clip, "video.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (128, 128))
    if not writer.isOpened():
        return None
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    np.save(os.path.join(clip, "bboxes.npy"),
            np.tile(np.asarray([[8, 8, 100, 100]], np.float32), (16, 1)))
    return os.path.dirname(clip)


def native_phase(card_line):
    """The native host loaders on the card's host: libmarhost built from
    native/marhost.cpp (the run fails without it) and libmarvideo where
    pkg-config finds libav* (else the reason); the predict phase's 8 wavs
    (5 s at 44.1 kHz) decoded with wav_read and wav_batch at 1, 4 and 8
    threads within 2e-3 of the numpy loader (tests/test_native.py:40),
    host ms per clip beside numpy's; prepare_data resample-audio on them;
    one epoch of the spectrogram VGG entry (16 kHz wavs) under
    MAR_USE_NATIVE_WAV=1, K1 once per train and eval step, its first
    logged train loss within 1e-4 relative of the numpy run's; an .mp4
    clip dir through ClipDirSource where libmarvideo and cv2 are both
    there, else which is missing."""
    import pandas as pd

    from multimodalaggressionrecognition_tpu_torch.cli import (
        prepare_data, train_audio_transformer as vgg_cli)
    from multimodalaggressionrecognition_tpu_torch.data import native
    from multimodalaggressionrecognition_tpu_torch.data.files import _load_wav
    from multimodalaggressionrecognition_tpu_torch.data.video_clips import (
        ClipDirSource)

    out = {}
    t0 = time.monotonic()
    host = native.load_library()
    out["libmarhost_build_s"] = time.monotonic() - t0
    reasons = native.unavailable_reasons()
    if host is None:
        raise AssertionError(f"native: libmarhost did not build or load: "
                             f"{reasons['libmarhost']}")
    t0 = time.monotonic()
    video = native.load_video_library()
    out["libmarvideo_build_s"] = time.monotonic() - t0
    out["libmarvideo"] = video is not None
    log(f"native: libmarhost built from native/marhost.cpp and loaded in "
        f"{out['libmarhost_build_s']:.2f} s "
        f"({native.library_path('marhost')})")
    if video is None:
        out["libmarvideo_reason"] = native.unavailable_reasons()["libmarvideo"]
        log(f"native: libmarvideo unavailable: {out['libmarvideo_reason']}")
    else:
        log(f"native: libmarvideo built and loaded in "
            f"{out['libmarvideo_build_s']:.2f} s")

    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = predict_clips(tmp, video=False)["audio"]
        paths = sorted(os.path.join(wav_dir, f) for f in os.listdir(wav_dir))
        n, target = len(paths), 5 * 16000
        want = np.stack([_load_wav(p, 16000) for p in paths])
        if want.shape != (n, target):
            raise AssertionError(f"native: numpy decoded {want.shape}")
        errs = {"wav_read": float(np.abs(np.stack(
            [native.wav_read(p, target) for p in paths]) - want).max())}
        for threads in NATIVE_THREADS:
            got = native.wav_batch(paths, target, num_threads=threads)
            errs[f"wav_batch_{threads}"] = float(np.abs(got - want).max())
        ms = {"numpy": _clip_ms(lambda: [_load_wav(p, 16000) for p in paths],
                                n),
              "wav_read": _clip_ms(lambda: [native.wav_read(p, target)
                                            for p in paths], n)}
        for threads in NATIVE_THREADS:
            ms[f"wav_batch_{threads}"] = _clip_ms(
                lambda: native.wav_batch(paths, target, num_threads=threads),
                n)
        if max(errs.values()) > 2e-3:
            raise AssertionError(f"native: wavs off numpy by {errs} (> 2e-3)")
        dst = os.path.join(tmp, "resampled")
        with contextlib.redirect_stdout(io.StringIO()):
            prepare_data.main(["resample-audio", wav_dir, dst])
        pts = sorted(os.listdir(dst))
        written = np.stack([torch.load(os.path.join(dst, f),
                                       weights_only=True).numpy()[0]
                            for f in pts])
        errs["prepare_data"] = float(np.abs(written - want).max())
        if len(pts) != n or errs["prepare_data"] > 2e-3:
            raise AssertionError(f"native: resample-audio wrote {pts}, "
                                 f"{errs['prepare_data']:.3e} off numpy")
        log(f"native wavs on {card_line}: {n} clips of 5 s at 44.1 kHz -> "
            f"16 kHz, max |d| vs numpy " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items()) + " <= 2e-3 ok; "
            "host ms per clip " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in ms.items()))

        # one VGG epoch, the wavs decoded natively and with numpy
        losses, counts = {}, {}
        root = os.path.join(tmp, "vgg_wavs")
        for route in ("numpy", "native"):
            args = ["--files_root", root, "--synthetic_wav",
                    "--synthetic_tones", "--synthetic_files",
                    str(NATIVE_VGG_FILES), "--saving_dir",
                    os.path.join(tmp, f"runs_{route}"), "--run_name", "r",
                    "--epoch_num", "1", "--device", DEVICE, "--num_threads",
                    "4", "--batch_size", str(AUDIO_VGG["batch_size"])]
            os.environ.pop("MAR_USE_NATIVE_WAV", None)
            if route == "native":
                os.environ["MAR_USE_NATIVE_WAV"] = "1"
            try:
                trainer, counts[route], _ = run_cli(
                    vgg_cli.main, args, card_line, f"native {route} vgg",
                    epochs=1)
            finally:
                os.environ.pop("MAR_USE_NATIVE_WAV", None)
            steps = trainer.state.step + len(trainer.test_loader)
            if counts[route] != {"framed_conv1d": steps}:
                raise AssertionError(f"native {route} vgg: launched "
                                     f"{counts[route]}, want K1 {steps}")
            losses[route] = float(pd.read_csv(os.path.join(
                trainer.run_dir, "main_train_log.csv"))["loss"].iloc[0])
            shutil.rmtree(trainer.run_dir, ignore_errors=True)
            del trainer
        rel = abs(losses["native"] - losses["numpy"]) / abs(losses["numpy"])
        if not rel <= 1e-4:
            raise AssertionError(f"native vgg: first train loss {losses} "
                                 f"differ by {rel:.2e} (> 1e-4 relative)")
        log(f"native vgg: one epoch under MAR_USE_NATIVE_WAV=1, launches "
            f"{counts['native']}; first train loss {losses['native']:.6f} vs "
            f"numpy {losses['numpy']:.6f} ({rel:.1e} <= 1e-4 relative) ok")

        try:
            import cv2  # noqa: F401 (writes the .mp4)
            missing = None if video is not None else "libmarvideo"
        except ImportError:
            missing = "cv2" if video is not None else "libmarvideo and cv2"
        mp4 = None
        if missing is None:
            clips = _mp4_clip_dir(tmp)
            if clips is None:
                missing = "a cv2 mp4 writer"
            else:
                frames, mask, label = ClipDirSource(clips, frame_num=16,
                                                    size=112).load(0)
                if (frames.shape != (16, 112, 112, 3) or label != 3
                        or not 0.6 < frames[:, :50].mean() < 0.9):
                    raise AssertionError(f"native mp4: {frames.shape}, "
                                         f"label {label}")
                mp4 = list(frames.shape)
                log(f"native mp4: ClipDirSource decoded a 16-frame 128 px "
                    f".mp4 through libmarvideo to {mp4} ok")
        if missing is not None:
            log(f"native mp4: not run here: {missing} missing")
    out.update({"max_abs_err": errs, "ms_per_clip": ms,
                "vgg_first_train_loss": losses, "vgg_loss_rel_err": rel,
                "mp4_frames": mp4, "mp4_missing": missing})
    log(json.dumps({"native": out}))
    return counts["native"]


def _pieces(cfg, kind):
    """The tri-modal towers of build_model(cfg) under the pieces no CLI
    builds, seeded, norms randomized, on the CPU: 'cross' a
    CrossAttentionFusion(768, 8) and a MultimodalModel with one
    OutputClassifier per stream; 'averaged' an
    AveragedFeaturesTransformerFusion with PhysVerbClassifierAddFeatures."""
    from multimodalaggressionrecognition_tpu_torch.models import (
        audiotext, fusion, heads, physverb)

    base = build_model(MultimodalConfig(**cfg), PIECES_MODALITIES)
    width = cfg["hidden_size"]
    kw = dict(extractors=dict(base.extractors),
              feature_shapes=base.feature_shapes, modalities=base.modalities)
    if kind == "cross":
        model = audiotext.MultimodalModel(
            classifiers={m: heads.OutputClassifier(2, input_size=width)
                         for m in PIECES_MODALITIES},
            fusion=fusion.CrossAttentionFusion(width, cfg["fusion_heads"]),
            **kw)
    else:
        model = physverb.PhysVerbModel(
            classifier=physverb.PhysVerbClassifierAddFeatures(
                2, {m: (width, cfg["adaptor_out"])
                    for m in PIECES_MODALITIES}),
            fusion=fusion.AveragedFeaturesTransformerFusion(
                cfg["fusion_layers"], width, cfg["fusion_heads"]), **kw)
    return randomize_norms(seeded_init_(model, SEED))


PIECES_MODALITIES = ("audio", "text", "video")
PIECES = dict(TRIMODAL, adaptor_out=256)
PER_PIECES_FORWARD = {"framed_conv1d": 1, "window_attention": 12, "roll": 4}


def _largest_err(got, want):
    """(max |got - want| over the heads, max |want|)."""
    err = max((got[h].float().cpu() - want[h].float()).abs().max().item()
              for h in want)
    return err, max(want[h].float().abs().max().item() for h in want)


def pieces_phase(card_line):
    """The pieces no CLI builds over the tri-modal towers at full width,
    b8 (see _pieces): each model's eval forward launching K1 1, K2 12, K4 4
    (the cross-attention model's without video: K1 only), its device ms
    (CUDA events); card against CPU at b2 within 1e-3 of the largest logit
    (f32) and on one row within 2e-2 in bf16 (utils/precision through
    train/steps.forward: K2 and K4 bf16, K1 f32 inside)."""
    from multimodalaggressionrecognition_tpu_torch.train.steps import forward

    launches, numbers = {}, {}
    for kind in ("cross", "averaged"):
        cpu = _pieces(PIECES, kind)
        gpu = copy.deepcopy(cpu).to(DEVICE)
        heads = gpu.head_names()
        cases = [("", PIECES_MODALITIES)]
        if kind == "cross":
            cases.append(("_no_video", ("audio", "text")))
        for suffix, present in cases:
            label = f"pieces_{kind}{suffix}"
            full = full_batch(PIECES, present, 8, SEED + 41)
            b8 = to_device(full, DEVICE)
            with torch.inference_mode():
                logits, counts, _, _ = counted(lambda: gpu(b8))
                want = {k: v for k, v in PER_PIECES_FORWARD.items()
                        if k == "framed_conv1d" or "video" in present}
                if counts != want or list(logits) != heads:
                    raise AssertionError(f"{label}: launched {counts}, want "
                                         f"{want}; heads {list(logits)}")
                ms = cuda_ms(lambda: gpu(b8), reps=10)
                small = full_batch(PIECES, present, 2, SEED + 42)
                err, scale = _largest_err(gpu(to_device(small, DEVICE)),
                                          cpu(small))
                if not err <= 1e-3 * scale:
                    raise AssertionError(f"{label}: card vs CPU {err:.3e} > "
                                         f"1e-3 * {scale:.3e}")
                row = full_batch(PIECES, present, 1, SEED + 43)
                got16, counts16, _, _ = counted(lambda: forward(
                    gpu, to_device(row, DEVICE), "bfloat16"))
                err16, scale16 = _largest_err(got16, forward(cpu, row,
                                                             "bfloat16"))
            want16 = bf16_counts(want)
            if counts16 != want16 or not err16 <= 2e-2 * scale16:
                raise AssertionError(f"{label} bf16: launched {counts16} "
                                     f"(want {want16}), card vs CPU "
                                     f"{err16:.3e} (limit 2e-2 * "
                                     f"{scale16:.3e})")
            launches[label], launches[f"{label}_bf16"] = counts, counts16
            numbers[label] = {"forward_ms": ms, "max_abs_err": err,
                              "max_abs_logit": scale,
                              "bf16_max_abs_err": err16,
                              "bf16_max_abs_logit": scale16,
                              "launches": counts, "launches_bf16": counts16}
            log(f"{label} on {card_line}: b8 eval forward {ms:.3f} ms, "
                f"launches {counts}, heads {heads}; card vs CPU (b2) "
                f"{err:.3e} <= 1e-3 * {scale:.3e}; bf16 (one row) "
                f"{err16:.3e} <= 2e-2 * {scale16:.3e}, launches {counts16}")
        del cpu, gpu
        torch.cuda.empty_cache()
    log(json.dumps({"pieces": numbers}))
    return launches


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic convolutions and torch's deterministic
    algorithms (a warning, silenced here, where an op has none)."""
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        cudnn.deterministic, cudnn.benchmark = before[2:]


def loss_and_grads(model, batch, seed):
    """The train-mode loss of `batch` and every gradient, stochastic depth
    and dropout drawn from a fresh generator seeded `seed`."""
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)

    model.train()
    set_generator(model, torch.Generator(DEVICE).manual_seed(seed))
    model.zero_grad(set_to_none=True)
    total, _ = head_losses_and_metrics(model(batch["modalities"]), batch,
                                       SPECS, 2)
    total.backward()
    return total.item(), {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None}


def remat_dots_phase(card_line):
    """The tri-modal fine-tune with --video_remat_policy dots through
    cli.train_multimodal.main at full width, b8, 2 epochs; then one step of
    an audio,text,video batch under "dots", save-nothing and remat off:
    launches per step (K1 1, K2 24, K3 12, K4 12 under both remat
    policies), the median device ms and peak memory of each, and the loss
    and every gradient under "dots" equal to save-nothing's, taken with
    deterministic algorithms (limit 1e-6 of each tensor's largest, plus
    the spread of two save-nothing runs should any op still differ)."""
    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "avabos")
        generate_synthetic_avabos(root, **TRAIN_DATA)
        args = finetune_args(tmp, root, "r", "--video_remat_policy", "dots")
        trainer, counts, clips_s = run_cli(
            train_multimodal.main, args, card_line, "train remat dots",
            heads=("phys", "verb"))
        model = trainer.state.model
        swin = model.extractors["video"].backbone.backbone
        if not (swin.remat and swin.remat_policy == "dots"):
            raise AssertionError(f"remat dots: the Swin runs remat "
                                 f"{swin.remat}, {swin.remat_policy!r}")
        batch = next(b for b in trainer.batches(trainer.train_loader)
                     if sorted(b["modalities"]) == list(PIECES_MODALITIES))
        per_step = PER_PATTERN["audio,text,video"]
        variants = {"dots": (True, "dots"), "none": (True, "none"),
                    "off": (False, "none")}
        steps, timing, grads, losses = {}, {}, {}, {}
        with deterministic():
            for name in ("dots", "none", "off", "none_again"):
                swin.remat, swin.remat_policy = variants[name.split("_")[0]]
                losses[name], grads[name] = loss_and_grads(model, batch,
                                                           SEED + 51)
        for name in ("dots", "none", "off", "dots"):  # in turns
            swin.remat, swin.remat_policy = variants[name]
            if name != "off":
                steps[name] = step_counts(trainer, batch)
                if steps[name] != per_step:
                    raise AssertionError(f"remat {name}: a step launched "
                                         f"{steps[name]}, want {per_step}")
            timing.setdefault(name, []).append(median_step_ms(trainer,
                                                              batch))
        swin.remat, swin.remat_policy = True, "dots"
    # the gradients are taken with deterministic algorithms; should an op
    # still differ between two save-nothing runs, "dots" may add that
    # spread to the 1e-6 of each tensor's largest
    worst, bitwise, noisy, bad = 0.0, 0, [], []
    for name, g in grads["dots"].items():
        want = grads["none"][name]
        spread = (grads["none_again"][name] - want).abs().max().item()
        err = (g - want).abs().max().item()
        scale = want.abs().max().item()
        if spread:
            noisy.append((name, spread, scale))
        if not err <= 1e-6 * scale + spread:
            bad.append((name, err, scale, spread))
        if not spread:
            worst = max(worst, err / scale if scale else 0.0)
        bitwise += bool(torch.equal(g, want))
    if noisy or bad:
        log(f"remat dots: gradients that differ between two save-nothing "
            f"runs (name, spread, largest): {noisy[:8]}; over the limit "
            f"(name, error, largest, spread): {bad[:8]}")
    if bad:
        raise AssertionError(f"remat dots: {len(bad)} gradients off "
                             f"save-nothing's beyond 1e-6 of their largest "
                             f"plus the runs' spread: {bad[:4]}")
    if sorted(grads["dots"]) != sorted(grads["none"]) or not abs(
            losses["dots"] - losses["none"]) <= 1e-6 * abs(losses["none"]):
        raise AssertionError(f"remat dots: losses {losses}")
    off_err = max((grads["off"][n] - g).abs().max().item()
                  / max(g.abs().max().item(), 1e-30)
                  for n, g in grads["none"].items())
    ms = {k: [t for t, _ in v] for k, v in timing.items()}
    peak = {k: max(p for _, p in v) for k, v in timing.items()}
    log(f"train remat dots step b8 on {card_line}: median ms dots "
        f"{ms['dots']}, save-nothing {ms['none']}, off {ms['off']}; peak GiB "
        f"dots {peak['dots']:.2f}, save-nothing {peak['none']:.2f}, off "
        f"{peak['off']:.2f}; launches per step {steps['dots']}; loss dots "
        f"{losses['dots']:.6f} vs save-nothing {losses['none']:.6f}; "
        f"{len(grads['dots'])} gradients, {bitwise} bit for bit; "
        f"{len(noisy)} differ between two save-nothing runs, "
        f"the rest within {worst:.2e} of the largest (<= 1e-6); remat off "
        f"vs save-nothing {off_err:.2e}")
    log(json.dumps({"train": "audio,text,video remat dots",
                    "batch": TRAIN["batch_size"], "launches": counts,
                    "launches_per_step": steps["dots"],
                    "step_ms": ms, "peak_gib": peak,
                    "epoch_clips_per_s": clips_s, "losses": losses,
                    "grad_rel_err": worst, "grads_bitwise": bitwise,
                    "grads": len(grads["dots"]),
                    "grads_nondeterministic": [n for n, _, _ in noisy],
                    "off_vs_none_grad_rel_err": off_err}))
    return counts


# ------------------------------------------------------------------ parallel
PARALLEL_WORLD, PARALLEL_TP = 4, 2  # dp 2 x tp 2 ranks on the one card
PARALLEL_SEED = SEED + 61


def parallel_world1(card_line):
    """(a) cli.train_multimodal.main --data_parallel at full width, b8, 2
    epochs: a world of one rank over NCCL, and the same run without the
    flag, both under deterministic algorithms (train_phase's run is not,
    and over 12 Adam steps the card's nondeterministic reductions move a
    gradient that is ~0 in exact arithmetic by +-lr).  Its launches per
    video step, its logged train and test losses against the plain run's
    (1e-5), and its median step against the plain step's, in turns (the
    all-reduces' cost at world 1)."""
    import pandas as pd
    import torch.distributed as dist

    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    heads = ("phys", "verb")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "avabos")
        generate_synthetic_avabos(root, **TRAIN_DATA)
        with deterministic():
            plain, _, _ = run_cli(train_multimodal.main,
                                  finetune_args(tmp, root, "plain"),
                                  card_line, "parallel plain", heads=heads)
            trainer, counts, clips_s = run_cli(
                train_multimodal.main,
                finetune_args(tmp, root, "dp", "--data_parallel"),
                card_line, "parallel world 1", heads=heads)
        mesh = trainer.mesh
        backend = "nccl" if torch.device(DEVICE).type == "cuda" else "gloo"
        if (mesh is None or mesh.world != 1
                or dist.get_backend() != backend):
            raise AssertionError(f"parallel world 1: mesh {mesh}, backend "
                                 f"{dist.get_backend()}")
        worst = 0.0
        for f in (f"{h}_{s}_log.csv" for h in heads
                  for s in ("train", "test")):
            got, want = (pd.read_csv(os.path.join(t.run_dir, f))["loss"]
                         .to_numpy() for t in (trainer, plain))
            err = float(np.abs(got - want).max())
            worst = max(worst, err)
            if not err <= 1e-5:
                raise AssertionError(f"parallel world 1: {f} losses "
                                     f"{got.tolist()} vs {want.tolist()}")
        batch = next(b for b in trainer.batches(trainer.train_loader)
                     if sorted(b["modalities"]) == list(PIECES_MODALITIES))
        per_step = step_counts(trainer, batch)
        if per_step != PER_PATTERN["audio,text,video"]:
            raise AssertionError(f"parallel world 1: a step launched "
                                 f"{per_step}")
        timing = {"dp": [], "plain": []}
        for name in ("dp", "plain", "plain", "dp"):
            timing[name].append(median_step_ms(
                trainer if name == "dp" else plain, batch)[0])
        # what a step of dp > 1 all-reduces; world 1 reduces the loss
        # terms alone (train/state.Optimizer.step)
        grad_bytes = sum(p.numel() * p.element_size()
                         for p in trainer.state.optimizer.params)
        del plain, trainer
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parallel (a) world 1 over {backend} on {card_line}: launches "
        f"{counts}, per video step {per_step} ok; logged losses vs the "
        f"plain run's max |d| {worst:.3e} <= 1e-5 ok (both under "
        f"deterministic algorithms); median step ms dp {timing['dp']} vs "
        f"plain {timing['plain']} (world 1 all-reduces the loss terms "
        f"alone); {grad_bytes} gradient bytes a dp > 1 step all-reduces")
    return {"launches": counts, "launches_per_step": per_step,
            "loss_max_abs_err": worst, "step_ms_dp": timing["dp"],
            "step_ms_plain": timing["plain"], "grad_bytes": grad_bytes,
            "epoch_clips_per_s": clips_s}


def _sync():
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def _parallel_model(cfg):
    return seeded_model(dict(cfg, video_freeze=False),
                        ("audio", "text", "video"))


def _parallel_batch(cfg):
    n = cfg["batch_size"]
    data = full_batch(cfg, ("audio", "text", "video"), n, PARALLEL_SEED)
    phys_mask = torch.ones(n)
    phys_mask[1] = 0.0
    return {"modalities": data,
            "labels": {"phys": torch.arange(n) % 2,
                       "verb": (torch.arange(n) + 1) % 2},
            "label_mask": {"phys": phys_mask, "verb": torch.ones(n)},
            "sample_mask": torch.ones(n)}


def _parallel_step(model, batch, mesh=None):
    """One train step (dropout and stochastic depth on) of `model` on the
    card; (loss, {name: summed gradient}, {name: BatchNorm statistic},
    launches), tp shards gathered."""
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        gather_state)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        train_step)

    state = create_train_state(model, OptimizerConfig(1e-3), DEVICE,
                               mesh=mesh)
    set_generator(model, torch.Generator(DEVICE).manual_seed(PARALLEL_SEED))
    batch = to_device(batch, DEVICE)
    _sync()
    kernels.launch_counts.clear()
    metrics = train_step(state, batch, SPECS, 2)
    _sync()
    counts = dict(kernels.launch_counts)
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.requires_grad}
    if mesh is not None and mesh.tp > 1:
        grads = gather_state({"state_dict": grads}, state)["state_dict"]
    stats = {n: b.detach().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return (float(metrics["total_loss"]),
            {n: g.detach().cpu() for n, g in grads.items()}, stats, counts)


def parallel_rank_main(rank: int, world: int, workdir: str):
    """One of parallel_ranks' ranks (a child process): gloo on CUDA
    tensors, all on cuda:0; the config and device come from the parent."""
    global DEVICE
    import torch.distributed as dist

    from multimodalaggressionrecognition_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh, shard_batch)

    with open(os.path.join(workdir, "config.json")) as f:
        setup = json.load(f)
    DEVICE = setup["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    initialize_distributed(
        num_processes=world, process_id=rank, backend="gloo",
        init_method=f"file://{os.path.join(workdir, 'rendezvous')}")
    mesh = make_mesh(model_parallelism=PARALLEL_TP,
                     device=torch.device(DEVICE, 0) if DEVICE == "cuda"
                     else torch.device(DEVICE))
    model = _parallel_model(setup["train"])
    model.load_state_dict(torch.load(os.path.join(workdir, "weights.pt")))
    batch = shard_batch(torch.load(os.path.join(workdir, "batch.pt")), mesh)
    taken = torch.load(os.path.join(workdir, "decisions.pt"))

    def fit(full, shape):
        """This rank's block of a decision of the one-rank run: its rows
        and, in a tensor-parallel block, its columns."""
        if full.shape[0] != shape[0]:
            full = full.narrow(0, mesh.dp_rank * shape[0], shape[0])
        if full.shape[-1] != shape[-1]:
            full = full.narrow(-1, mesh.tp_rank * shape[-1], shape[-1])
        return full

    t0 = time.monotonic()
    with relu_decisions(taken["relu"], fit), pool_decisions(taken["pool"],
                                                            fit):
        loss, grads, stats, counts = _parallel_step(model, batch, mesh)
    step_s = time.monotonic() - t0
    with open(os.path.join(workdir, f"launches_{rank}.json"), "w") as f:
        json.dump({"launches": counts, "step_s": step_s,
                   "dp_rank": mesh.dp_rank, "tp_rank": mesh.tp_rank}, f)
    if rank == 0:
        torch.save({"loss": loss, "grads": grads, "stats": stats},
                   os.path.join(workdir, "rank0.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parallel_ranks(card_line):
    """(b) dp 2 x tp 2: four ranks on the one card (gloo on CUDA tensors;
    NCCL refuses two ranks on one device), one tri-modal train step at
    full width on the global b8, dropout and stochastic depth on, the
    fusion encoder (768 wide, 8 heads) split by head; against one rank on
    the same weights, batch, generator and ReLU and max-pool decisions:
    the loss within rtol 1e-5, every gradient within 1e-4 of that tensor's
    largest, the CNN1D BatchNorm statistics within 1e-5, and each rank's
    launches."""
    model = _parallel_model(TRAIN)
    batch = _parallel_batch(TRAIN)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"train": TRAIN, "device": DEVICE}, f)
        torch.save(model.state_dict(), os.path.join(tmp, "weights.pt"))
        torch.save(batch, os.path.join(tmp, "batch.pt"))
        # the one-rank step first: its ReLU and max-pool decisions are
        # replayed by the ranks (a near tie that the split batch's or the
        # split block's summation order flips routes a whole gradient
        # elsewhere, far beyond the rounding this check holds)
        with relu_decisions() as relus, pool_decisions() as pools:
            want_loss, want_grads, want_stats, one_counts = _parallel_step(
                model, batch)
        torch.save({"relu": relus.taken, "pool": pools.taken},
                   os.path.join(tmp, "decisions.pt"))
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), str(PARALLEL_WORLD), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(PARALLEL_WORLD)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.monotonic() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"parallel (b): rank {r} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
        got = torch.load(os.path.join(tmp, "rank0.pt"))
        ranks = []
        for r in range(PARALLEL_WORLD):
            with open(os.path.join(tmp, f"launches_{r}.json")) as f:
                ranks.append(json.load(f))
    per_step = PER_PATTERN["audio,text,video"]
    for r, info in enumerate(ranks):
        if info["launches"] != per_step:
            raise AssertionError(f"parallel (b): rank {r} launched "
                                 f"{info['launches']}, want {per_step}")
    if not abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss):
        raise AssertionError(f"parallel (b): loss {got['loss']} vs one "
                             f"rank {want_loss}")
    if sorted(got["grads"]) != sorted(want_grads):
        raise AssertionError("parallel (b): gradient names differ")
    # a conv bias feeding a train-mode BatchNorm has no gradient in exact
    # arithmetic (the batch mean takes it out): its largest value is
    # rounding, so it is held to 1e-4 of its conv weight's largest instead
    fed = [re.fullmatch(r"(.*\.)bn(\d+)", n) for n, m in
           model.named_modules() if isinstance(m, BatchNorm1d)]
    zero = {f"{f[1]}conv{f[2]}.bias": f"{f[1]}conv{f[2]}.weight"
            for f in fed if f}
    worst, bad = 0.0, []
    for name, want in want_grads.items():
        scale = float(want_grads[zero.get(name, name)].abs().max())
        err = float((got["grads"][name] - want).abs().max())
        if name not in zero:
            worst = max(worst, err / scale if scale else err)
        if not err <= 1e-4 * scale + 1e-12:
            bad.append((name, err, scale))
    if bad:
        raise AssertionError(f"parallel (b): {len(bad)} gradients beyond "
                             f"1e-4 of their largest: {bad}")
    stat_err = max(float((got["stats"][n] - w).abs().max())
                   for n, w in want_stats.items())
    if not want_stats or not stat_err <= 1e-5:
        raise AssertionError(f"parallel (b): BatchNorm statistics "
                             f"{stat_err}")
    log(f"parallel (b) dp 2 x tp 2 on one {card_line}: 4 ranks in "
        f"{ranks_s:.1f} s (start-up included); loss {got['loss']:.7f} vs "
        f"one rank {want_loss:.7f}; {len(want_grads) - len(zero)} "
        f"gradients within {worst:.2e} of their largest (<= 1e-4), the "
        f"{len(zero)} BatchNorm-fed conv biases within 1e-4 of their "
        f"weights' (the ranks on the one-rank run's {len(relus.taken)} ReLU "
        f"and {len(pools.taken)} max-pool decisions); BatchNorm statistics "
        f"{stat_err:.2e} (<= 1e-5); launches per rank "
        f"{[i['launches'] for i in ranks]} ok")
    return {"loss": got["loss"], "one_rank_loss": want_loss,
            "grad_rel_err": worst, "bn_max_abs_err": stat_err,
            "launches_per_rank": [i["launches"] for i in ranks],
            "rank_step_s": [i["step_s"] for i in ranks],
            "ranks_s": ranks_s, "one_rank_launches": one_counts}


def parallel_serving(card_line):
    """(c) Data-parallel serving of the tri-modal model at b8:
    Predictor(devices=["cuda:0", "cuda:0"]) against the one-device
    Predictor (probabilities within 1e-5; K1 2, K2 24, K4 8 a forward);
    `serve --data_parallel` answering /score; an ExportedPredictor over two
    replicas (each the artifact's b8) against the one-device artifact."""
    from multimodalaggressionrecognition_tpu_torch.io.export import (
        ExportedPredictor, export_predictor)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    modalities = ("audio", "text", "video")
    model = seeded_model(TRIMODAL, modalities)
    rng = np.random.default_rng(PARALLEL_SEED)
    clips = request(rng, TRIMODAL, modalities, 8)
    example = {m: a[:1] for m, a in clips.items()}
    pair = [torch.device(DEVICE, 0) if DEVICE == "cuda"
            else torch.device(DEVICE)] * 2
    one = Predictor(copy.deepcopy(model), batch_size=8,
                    device=DEVICE).warmup(example)
    two = Predictor(copy.deepcopy(model), batch_size=8,
                    devices=pair).warmup(example)
    per_forward = {k: 2 * v for k, v in PER_PIECES_FORWARD.items()}
    _sync()
    kernels.launch_counts.clear()
    got = two.predict(clips)
    _sync()
    counts = dict(kernels.launch_counts)
    if counts != per_forward:
        raise AssertionError(f"parallel (c): a two-replica forward "
                             f"launched {counts}, want {per_forward}")
    want = one.predict(clips)
    err = max(float(np.abs(got[h] - want[h]).max()) for h in want)
    if not err <= 1e-5:
        raise AssertionError(f"parallel (c): replicas vs one device {err}")
    timing = {"one": [], "two": []}
    for name in ("one", "two", "two", "one"):
        pred = one if name == "one" else two
        t0 = time.monotonic()
        for _ in range(3):
            pred.predict(clips)
        timing[name].append((time.monotonic() - t0) / 3 * 1e3)

    srv = build_server(ServeConfig(
        modalities=",".join(modalities), batch_size=8, port=0,
        allow_random_weights=True, data_parallel=True, device=DEVICE,
        **TRIMODAL))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        devices = [str(d) for d in srv.predictor.devices]
        scores = _http(srv, "/score", _npz({m: a[:2] for m, a in
                                            clips.items()}),
                       "application/x-npz")
        _check_scores(scores, 2)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=30)
    want_devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                    if DEVICE == "cuda" else [DEVICE])
    if devices != want_devices:
        raise AssertionError(f"parallel (c): serve replicas {devices}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        export_predictor(one, example, tmp)
        export_s = time.monotonic() - t0
        single = ExportedPredictor(tmp, device=DEVICE).warmup()
        double = ExportedPredictor(tmp, devices=pair).warmup()
        if double.batch_size != 16:
            raise AssertionError(f"parallel (c): exported replicas' batch "
                                 f"{double.batch_size}")
        sixteen = {m: np.concatenate([a, a[::-1]]) for m, a in clips.items()}
        _sync()
        kernels.launch_counts.clear()
        egot = double.predict(sixteen)
        _sync()
        ecounts = dict(kernels.launch_counts)
        halves = [single.predict({m: a[s:s + 8] for m, a in
                                  sixteen.items()}) for s in (0, 8)]
    eerr = max(float(np.abs(egot[h] - np.concatenate(
        [x[h] for x in halves])).max()) for h in egot)
    if ecounts != per_forward or not eerr <= 1e-5:
        raise AssertionError(f"parallel (c): exported replicas launched "
                             f"{ecounts}, |dp| {eerr}")
    del one, two, single, double
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parallel (c) serving on {card_line}: Predictor over "
        f"{[str(d) for d in pair]} "
        f"launches {counts} a forward ok, probabilities within {err:.2e} of "
        f"one device (<= 1e-5); predict b8 ms one device {timing['one']}, "
        f"two replicas {timing['two']} (host clock); serve --data_parallel "
        f"replicas {devices} answered /score; ExportedPredictor over two "
        f"replicas (b16, exported in {export_s:.1f} s) launches {ecounts}, "
        f"within {eerr:.2e} of one (<= 1e-5)")
    return {"launches": counts, "max_abs_prob_err": err,
            "predict_ms_one": timing["one"], "predict_ms_two": timing["two"],
            "serve_devices": devices, "exported_launches": ecounts,
            "exported_max_abs_prob_err": eerr}


def parallel_phase(card_line):
    """The multi-GPU slice on one card: (a) a world of one over NCCL
    through the CLI, (b) four gloo ranks sharing the card, (c)
    data-parallel serving.  Returns the launch counts of its paths."""
    t0 = time.monotonic()
    world1 = parallel_world1(card_line)
    ranks = parallel_ranks(card_line)
    serving = parallel_serving(card_line)
    seconds = time.monotonic() - t0
    log(json.dumps({"parallel": {"world1": world1, "dp2_tp2": ranks,
                                 "serving": serving, "seconds": seconds,
                                 "card": card_line}}))
    return {"parallel_world1": world1["launches"],
            "parallel_dp2_tp2_rank0": ranks["launches_per_rank"][0],
            "parallel_serve": serving["launches"],
            "parallel_serve_exported": serving["exported_launches"]}


# tensor-parallel serving in one process (ROADMAP item 13): dp x tp over a
# device list, the fusion encoder's heads and feed-forward columns split
TP_SEED = SEED + 71


def _median_predict_ms(predictors, clips, turns: int = 2, reps: int = 3):
    """{name: median host-clock ms of `predict`} over `turns` visits in
    turns (a, b, ..., ..., b, a), `reps` calls a visit."""
    names = list(predictors)
    times = {name: [] for name in names}
    for name in (names + names[::-1]) * (turns // 2):
        for _ in range(reps):
            t0 = time.monotonic()
            predictors[name].predict(clips)
            times[name].append((time.monotonic() - t0) * 1e3)
    return {name: float(np.median(t)) for name, t in times.items()}


def _tp_check(label, pred, one, clips, expect, bf16=False):
    """`pred`'s launches on one predict of `clips` (counts reset just
    before, read just after) against `expect`, then its scores against
    `one` on `clips` and on their first 5 (padded rows): probabilities
    within 1e-5, or under `bf16` logits within 1e-2 of the largest.
    Returns (counts, error)."""
    _sync()
    kernels.launch_counts.clear()
    pred.predict(clips)
    _sync()
    counts = dict(kernels.launch_counts)
    if counts != expect:
        raise AssertionError(f"tp serving {label}: a forward launched "
                             f"{counts}, want {expect}")
    err = 0.0
    for n in (len(next(iter(clips.values()))), 5):
        part = {m: a[:n] for m, a in clips.items()}
        probs = not bf16
        want = one.predict(part, return_probs=probs)
        got = pred.predict(part, return_probs=probs)
        for h in want:
            if got[h].shape != want[h].shape or not np.isfinite(got[h]).all():
                raise AssertionError(f"tp serving {label}: bad {h} scores")
            d = float(np.abs(got[h] - want[h]).max())
            err = max(err, d if probs else d / float(np.abs(want[h]).max()))
    limit = 1e-2 if bf16 else 1e-5
    if not err <= limit:
        raise AssertionError(f"tp serving {label}: {err:.3e} off one "
                             f"device (limit {limit})")
    return counts, err


def tp_serving_phase(card_line):
    """Tensor-parallel serving in one process at full width, TF32 off:
    the tri-modal b8 Predictor over ["cuda:0"] * 2 (tp 2) and ["cuda:0"] * 4
    (dp 2 x tp 2), the flagship b32 over ["cuda:0"] * 2 in f32, int8 and
    bf16, each against its one-device Predictor (probabilities within
    1e-5; bf16 logits within 1e-2 of the largest), launches per forward (the
    towers are not split: tri-modal K1 1, K2 12, K4 4 a data group),
    `predict` ms in turns beside one device's; the tp 2 daemon
    (build_server's devices override) answering /score and /healthz; and
    the CLI's own device list: on one card its "does not divide" exit, on
    an even number of cards its data groups and the flagship Predictor
    over them against one device."""
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        local_splits)
    from multimodalaggressionrecognition_tpu_torch.serve import Predictor

    t_phase = time.monotonic()
    card0 = [torch.device(DEVICE, 0) if DEVICE == "cuda"
             else torch.device(DEVICE)]
    out = {"launches": {}, "max_err": {}, "predict_ms": {}}
    rng = np.random.default_rng(TP_SEED)

    modalities = ("audio", "text", "video")
    model = seeded_model(TRIMODAL, modalities)
    clips = request(rng, TRIMODAL, modalities, 8)
    example = {m: a[:1] for m, a in clips.items()}
    one = Predictor(copy.deepcopy(model), batch_size=8,
                    device=DEVICE).warmup(example)
    tri = {"one": one}
    for name, n_devices in (("tp2", 2), ("dp2_tp2", 4)):
        pred = Predictor(copy.deepcopy(model), batch_size=8,
                         devices=card0 * n_devices,
                         model_parallelism=2).warmup(example)
        groups = n_devices // 2
        expect = {k: groups * v for k, v in PER_PIECES_FORWARD.items()}
        (out["launches"][f"trimodal_{name}"],
         out["max_err"][f"trimodal_{name}"]) = _tp_check(
            f"tri-modal b8 {name}", pred, one, clips, expect)
        tri[name] = pred
    out["predict_ms"]["trimodal"] = _median_predict_ms(tri, clips)
    out["trimodal_split_leaves"] = len(local_splits(tri["tp2"].model))
    del tri, one, model
    gc.collect()
    torch.cuda.empty_cache()

    modalities = ("audio", "text")
    model = seeded_model(FLAGSHIP, modalities)
    clips = request(rng, FLAGSHIP, modalities, BATCH)
    example = {m: a[:1] for m, a in clips.items()}
    flag = {}
    for mode, kw in (("f32", {}), ("int8", {"quantize": "int8"}),
                     ("bf16", {"compute_dtype": "bfloat16"})):
        one = Predictor(copy.deepcopy(model), batch_size=BATCH,
                        device=DEVICE, **kw).warmup(example)
        pred = Predictor(copy.deepcopy(model), batch_size=BATCH,
                         devices=card0 * 2, model_parallelism=2,
                         **kw).warmup(example)
        splits = len(local_splits(pred.model))
        if splits != 6:
            raise AssertionError(f"tp serving flagship {mode}: {splits} "
                                 f"split leaves, want 6")
        expect = SLICES[0][4]  # the flagship's launches per forward
        if mode == "bf16":
            expect = bf16_counts(expect)
        (out["launches"][f"flagship_tp2_{mode}"],
         out["max_err"][f"flagship_tp2_{mode}"]) = _tp_check(
            f"flagship b32 tp2 {mode}", pred, one, clips, expect,
            bf16=mode == "bf16")
        if mode == "f32":
            flag = {"one": one, "tp2": pred}
    out["flagship_split_leaves"] = splits
    out["predict_ms"]["flagship"] = _median_predict_ms(flag, clips)
    flag_one = flag["one"]
    del flag, one, pred
    gc.collect()
    torch.cuda.empty_cache()

    cfg = ServeConfig(modalities="audio,text", batch_size=BATCH, port=0,
                      allow_random_weights=True, model_parallelism=2,
                      device=DEVICE, **FLAGSHIP)
    srv = build_server(cfg, devices=card0 * 2)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        groups = [[str(d) for d in g] for g in srv.predictor.groups]
        _sync()
        kernels.launch_counts.clear()
        scores = _http(srv, "/score", _npz({m: a[:2] for m, a in
                                            clips.items()}),
                       "application/x-npz")
        _sync()
        out["launches"]["daemon_tp2"] = dict(kernels.launch_counts)
        _check_scores(scores, 2)
        health = _http(srv, "/healthz")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=30)
    if (not health.get("ok") or groups != [[str(d) for d in card0 * 2]]
            or out["launches"]["daemon_tp2"] != SLICES[0][4]):
        raise AssertionError(f"tp serving daemon: groups {groups}, launches "
                             f"{out['launches']['daemon_tp2']}, /healthz "
                             f"{health}")
    del srv
    gc.collect()

    cards = torch.cuda.device_count() if DEVICE == "cuda" else 1
    if cards > 1 and cards % 2 == 0:
        srv = build_server(cfg)
        try:
            out["cli_groups"] = [[str(d) for d in g]
                                 for g in srv.predictor.groups]
        finally:
            srv.server_close()
            srv.batcher.close()
        if len(out["cli_groups"]) != cards // 2:
            raise AssertionError(f"tp serving CLI: groups "
                                 f"{out['cli_groups']} over {cards} cards")
        pred = Predictor(copy.deepcopy(model), batch_size=BATCH,
                         devices=[torch.device(DEVICE, i)
                                  for i in range(cards)],
                         model_parallelism=2).warmup(example)
        expect = {k: v * (cards // 2) for k, v in SLICES[0][4].items()}
        (out["launches"]["flagship_cards"],
         out["max_err"]["flagship_cards"]) = _tp_check(
            f"flagship b32 over {cards} cards", pred, flag_one, clips,
            expect)
        out["predict_ms"]["flagship_cards"] = _median_predict_ms(
            {"one": flag_one, "cards": pred}, clips)
        del pred
    else:
        want = f"does not divide the {cards} available devices"
        try:
            build_server(cfg)
        except SystemExit as e:
            if want not in str(e):
                raise AssertionError(f"tp serving CLI: exit {e}") from None
            out["cli_exit"] = str(e)
        else:
            raise AssertionError(f"tp serving CLI: --model_parallelism 2 "
                                 f"over {cards} card(s) did not exit")
    out["seconds"] = time.monotonic() - t_phase
    log(f"tp serving on {card_line}: launches {out['launches']}; max "
        f"error against one device {out['max_err']} (probabilities <= "
        f"1e-5, bf16 logits <= 1e-2 of the largest); split leaves "
        f"tri-modal {out['trimodal_split_leaves']}, flagship "
        f"{out['flagship_split_leaves']}; predict ms (host clock, median) "
        f"{out['predict_ms']}; daemon groups {groups} answered /score and "
        f"/healthz; CLI {out.get('cli_groups') or out.get('cli_exit')}; "
        f"{out['seconds']:.1f} s")
    log(json.dumps({"tp_serving": {**out, "card": card_line}}))
    return {f"tp_serve_{k}": v for k, v in out["launches"].items()}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card_line = smi.splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    libs = kernels.build_all()
    log(f"build: {sorted(libs)} in {time.monotonic() - t0:.1f} s (nvcc, sm_90a)")
    resources = resources_phase()

    k1 = {**k1_phase(name), "resources": resources["framed_conv1d"]}
    k1["resample_poly_max_abs_err"] = resample_phase()
    k4 = {**k4_phase(name), "resources": resources["roll"]}
    k4["extract"] = k4_extract_phase(name)
    k2 = {**k2_phase(name), "resources": resources["window_attention"]}
    k2["extract"] = k2_extract_phase(name)
    k3 = {**k3_phase(name), "resources": resources["window_attention_bwd"]}
    bf16 = bf16_kernel_phase(name)
    k2["bf16_extract"] = k2_extract_bf16_phase(name)
    log(json.dumps({"self_attention": self_attention_phase(name)}))
    log(json.dumps({"patch_embed": patch_embed_phase(name)}))
    log(json.dumps({"gigachat": gigachat_phase(name)}))
    log(json.dumps({"gigachat_routing": gigachat_routing_phase(name)}))
    launches = {label: run_slice(label, cfg, bs, parity_n, per_forward,
                                 card_line)
                for label, cfg, bs, parity_n, per_forward in SLICES}
    launches["serve_bf16"] = serve_bf16_phase(card_line)
    launches.update(quantized_phase(card_line))
    launches.update(export_phase(card_line))
    main_path = "train"  # the tri-modal fine-tune runs every kernel
    launches[main_path], scored = train_phase(card_line)
    launches.update(scored)
    launches["train_flagship"] = flagship_phase(card_line)
    launches.update(pieces_phase(card_line))
    launches["train_remat_dots"] = remat_dots_phase(card_line)
    launches.update(parallel_phase(card_line))
    launches.update(tp_serving_phase(card_line))
    for numbers, key, kernel in ((k2, "k2", "window_attention"),
                                 (k3, "k3", "window_attention_bwd"),
                                 (k4, "k4", "roll")):
        numbers["bf16"] = {
            **bf16[key],
            "launches": launches["train_bf16"].get(
                kernels.launch_key(kernel, torch.bfloat16), 0),
            "launches_by_path": {
                p: launches[p].get(kernels.launch_key(kernel, torch.bfloat16),
                                   0)
                for p in ("train_bf16", "serve_bf16")}}
    launches["train_audio_vgg"] = audio_vgg_phase(card_line, k1)
    launches["native_vgg"] = native_phase(card_line)
    launches["train_text"] = text_phase(card_line)
    launches["train_video_transformer"] = video_transformer_phase(card_line)
    launches["train_audio_text"] = audio_text_phase(card_line)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=UNFLATTENED_RNN)
        (launches["train_audio_rnn"],
         launches["train_audio_rnn_cnn1d"]) = audio_rnn_phase(card_line)
        launches["train_video_rnn"] = video_rnn_phase(card_line)
    launches["train_audio_transformer_w2v"] = audio_transformer_w2v_phase(
        card_line)
    launches["train3dcnn"] = train3dcnn_phase(card_line)
    launches.update(extract_phase(card_line))
    launches["generate_features"] = generate_features_phase(card_line)
    launches["doctor"] = doctor_phase()
    launches.update(BF16_LAUNCHES)
    for numbers, kernel in ((k1, "framed_conv1d"), (k2, "window_attention"),
                            (k4, "roll")):
        # the paths that launched it under --compute_dtype bfloat16, by the
        # dtype of its instantiation (K1 is always f32 inside)
        numbers["launches_under_bf16"] = {
            p: {k: v for k, v in c.items() if k.startswith(kernel + ".")
                or k == kernel}
            for p, c in launches.items() if "bf16" in p and any(
                k == kernel or k.startswith(kernel + ".") for k in c)}

    def entry(kernel, source, replaces, numbers):
        return {"name": kernel, "route": "cuda",
                "source": f"multimodalaggressionrecognition_tpu_torch/csrc/"
                          f"{source}",
                "replaces": replaces,
                "launches": launches[main_path].get(kernel, 0),
                "launches_by_path": {p: c.get(kernel, 0)
                                     for p, c in launches.items()},
                **numbers, "status": "ok"}

    jax_pkg = "multimodalaggressionrecognition_tpu/"
    log(json.dumps({"kernels": [
        entry("framed_conv1d", "framed_conv.cu",
              jax_pkg + "ops/pallas/framed_conv.py:54", k1),
        entry("window_attention", "window_attention.cu",
              jax_pkg + "ops/pallas/window_attention.py:112", k2),
        entry("window_attention_bwd", "window_attention_bwd.cu",
              jax_pkg + "ops/pallas/window_attention.py:224", k3),
        entry("roll", "roll.cu", "benchmarks/proto_swin_levers.py:48",
              k4)]}))
    log(card_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4]))
    sys.exit(main())
