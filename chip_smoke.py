#!/usr/bin/env python3
"""Drive the PyTorch port (open_clip_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which fails the run (exit code 1, no result line) when it fails:
  0. build the CUDA kernels from csrc/ with nvcc, one process per source, together;
  1. each kernel against its plain PyTorch version on the card, at the shapes the
     main paths give it (bf16 and fp32): the short attention forward and backward,
     each also where one head's logits sit ~100 below its neighbour's (at L=50 and
     L=257), both also at L=129 and 257 (ViT-L-14's image tower: the two-pass forward
     and the two-kernel backward on the tensor cores) and 288 with hd=128, the
     backward also at L=128 (the longest its fused body takes), the LayerNorm
     backward, and the three flash attention kernels (forward with logsumexp, dq,
     dk/dv) at the NaFlex train and serve buckets, a length that is no multiple of a
     tile, causal, prefix-LM, hd=128 and samples with whole key tiles of invalid keys
     (the bf16 kernels on wgmma fed by TMA, which skip them; dq also takes di), a
     sample with no valid key and misaligned rows (which raise); kernel, plain and
     library-call device time (the whole backward beside SDPA's), each from one CUDA
     graph of calls (no host work between launches), and the bound;
  2. serving: ViT-B-32 from create_model_and_transforms in pure_bf16 with random
     weights from a seed, a zero-shot classifier over 10 ImageNet classes (one
     encode_text call), and requests of 256 synthetic 256x320 uint8 images (device
     preprocess -> encode_image -> logits -> top-5), one in flight: a warm-up
     request, a window of at least 0.5 s (latency, images/s over the window, device
     time per phase from CUDA events), and 10 more under torch.profiler (device
     time per kernel class, idle share). The kernel must launch 12 times per tower
     call;
  3. the same model at fp32 (TF32 off) on the card against the port on the CPU:
     image and text features must agree to cosine >= 0.9999;
  4. training, library surface: ViT-B-32 in amp_bf16 (fp32 master weights), AdamW
     with clipping, make_train_step on one fixed batch of 256 random images and
     token ids: 2 warm-up steps, a window of at least 2 s, a few steps under
     torch.profiler. Every loss is finite, the loss falls, and each step launches
     the attention forward and backward kernels 24 times each, all on the tensor-core
     bodies. Then a few steps
     with remat, and the same run with the fused LayerNorm backward switched on
     (51 launches of that kernel a step, the same first loss), timed and profiled
     in the same way so that the two step times stand side by side;
  5. training, CLI: open_clip_tpu_torch.train.main with synthetic data, batch 256,
     one epoch into a temporary directory, then a second one through --resume latest;
  6. one fp32 train step (TF32 off) at batch 8 on the card against the CPU: loss,
     grad_norm and every gradient;
  7. NaFlex serving: naflex_ViT-B-16 in pure_bf16, the same zero-shot classifier,
     requests of 32 synthetic 384x512 uint8 images (NaFlexTransform(576, 16) on the
     card: a 20x27 grid, 540 valid patches of 576 -> encode_image(patch dict) ->
     logits -> top-5), timed and profiled like phase 2; 12 flash forward launches a
     request, every one on the wgmma body, and no backward launch;
  8. NaFlex training: amp_bf16, AdamW with clipping, make_train_step on one fixed
     batch of 16 patch dicts at 1024 tokens (32x32 grids, all valid, alternating with
     24x32 grids, 768 valid) and 16 token rows, timed and profiled like phase 4; a
     step launches each flash kernel 12 times (all three on the wgmma bodies) and the
     short kernels 12 + 12 times (the text tower); then two steps with remat;
  9. the CLI with --dataset-type synthetic-naflex at the 1024-token bucket (batch 16
     from the token budget), one short epoch;
 10. NaFlex at fp32 (TF32 off), card against CPU: image features of a ragged batch
     of 4 at 576 tokens, and one train step at batch 4 and 512 tokens: loss,
     grad_norm and every gradient;
 11. (with phase 1) the window and panel attention kernels, forward and backward
     (dq, dk, dv, dbias), bf16 and fp32, against their plain versions at HTSAT-tiny's
     stage-0 (shifted and not) and stage-3 shapes at the serve and train batches,
     stages 1 and 2 (shifted) at the train batch, Swin-B's four stages' windows at
     the train batch (and stages 0 and 2 at the serve batch), a non-square map and odd
     head counts; kernel, plain, library (SDPA with the bias as attn_mask) time and
     the bound. The bf16 forward and backward take the tensor-core bodies (the panel's
     64-token windows and Swin-B's 49-token ones, padded to 64), fp32 the CUDA-core
     ones; the bf16 forward is also timed on its CUDA-core body (simt_ms) and, at one
     Swin and one HTSAT shape, launched twice and compared bit for bit; then the
     tensor-core window and panel backwards and forwards at Swin-B's and HTSAT's four
     stage shapes under five group splits (the window_bwd_groups and window_fwd_groups
     lines);
 12. CLAP serving: CLAP-HTSAT-tiny in pure_bf16, requests of 64 ten-second clips
     (host AudioPreprocess, pinned copy, log-mel and encode_audio on the card, an
     ESC-50-template classifier, top-5), timed and profiled like phase 2; 12 panel
     forward launches a request, all on the tensor-core body; then the same requests
     with the panel forward on its CUDA-core body (latency, kernel ms, panel forward
     ms a request: the before and after);
 13. CLAP training at batch 128 (amp_bf16, AdamW, clipping): 12 panel forward and
     backward launches a step, all on the tensor-core bodies, the loss falls; profiled
     steps, and the same with the panel forward on its CUDA-core body;
 14. the CLI with --dataset-type synthetic-audio, a checkpoint and a resume;
 15. CLAP at fp32 (TF32 off), card against CPU: log-mel, features, every gradient;
 16. Swin-B (swin_base_patch4_window7_224) serving in pure_bf16 (64 images a request)
     and training in amp_bf16 (batch 32): 24 window launches of each kind per
     encode_image and per step, all on the tensor-core bodies; serving again with the
     window forward on its CUDA-core body; profiled steps (kernel ms a step, the window
     forward's and backward's ms a step), the same steps with the window backward,
     then the forward, sent to its CUDA-core body for a before and after within the
     run, and a step with remat;
 17. (with phase 1) the SwitchBack kernels against their plain versions bit for bit:
     the int8 matmul-dequant, fp32 and bf16 out, at the MLP shapes of ViT-H-14 (batch
     32) and ViT-B-32 (batch 256), on the body matmul_body picks (wgmma; launched
     twice, the same bits) and on the mma body, and at
     ragged shapes (mma where K % 16 != 0); the row-wise quantization of each shape's
     bf16 activations (with rows at .5 ties and a zero row) and fp32 weight, against
     the plain version on the CPU; kernel, mma body, plain,
     torch._int_mm plus the dequant, bare torch._int_mm and bf16 F.linear time, and
     the bounds;
 18. ViT-H-14 training with the switch on, at full width with 8 of its 32 image blocks
     and 6 of its 24 text blocks (the script's time limit): amp_bf16, AdamW, clip 1.0,
     remat with the names_mm preset, batch 32, timed and profiled like phase 4 (42
     wgmma product and 84 quantization launches a step); the loss falls; then the same step with the
     mma product and the plain quantization patched in (the earlier bodies,
     profiled: the switchback and quantization ms and the launches a step, beside the
     kernels'), with the switch off (profiled), and with it on under full remat;
 19. ViT-B-32 at batch 256 with the switch on: library steps, then the CLI with
     --use-switchback --grad-checkpointing --remat-policy names_mm;
 20. ViT-H-14's widths with 2 layers per tower, the switch on, fp32 (TF32 off), card
     against CPU: features, loss and every gradient;
 21. ViT-L-14 training, the JAX package's bench_vit_l14 step: batch 64, amp_bf16,
     AdamW (lr 1e-5), clip 1.0, timed and profiled like phase 4, the loss falls; 24 + 12 short
     forward and backward launches a step, all on the tensor-core bodies (the image
     tower's 257 tokens on the two-pass forward and the two-kernel backward); then 2
     steps under names_mm from the same initial weights, with the same first loss;
 22. SigLIP serving (siglip_serve): ViT-B-16-SigLIP in pure_bf16, a 10-class
     classifier built once from seeded token ids (SigLIP's vocabulary is not in the
     repository), requests of 256 uint8 256x320 images (device preprocess ->
     encode_image -> sigmoid(scale * logits + logit_bias) -> top-5), timed and
     profiled like phase 2; every block takes the short kernel (12 two-pass mma
     launches a request at L=196, 12 non-causal one-pass ones at L=64 for the
     classifier), only the MAP pool's one-query attention is dense;
 23. siglip384_serve: ViT-B-16-SigLIP-384 at batch 64: the 576-token blocks take the
     flash forward without a key mask (12 wgmma launches a request, 0 short);
 24. SigLIP training (siglip_train), the JAX package's bench_siglip step: batch 256,
     224 px, 64 tokens, amp_bf16, AdamW (wd 0.2; lr 1e-4, where bench_siglip's 5e-4
     with no warm-up first drives this fixed batch's loss up), clip 1.0, loss_type
     "siglip", with names_mm and without remat from the same weights (the same first
     loss), each timed and profiled like phase 4: the loss falls, the logit bias moves
     from -10, short launches a step by tower and direction;
 25. siglip_cli: the CLI with --model ViT-B-16-SigLIP --siglip and synthetic data;
 26. siglip_card_vs_cpu: fp32 (TF32 off), ViT-B-16-SigLIP at full width, batch 2, card
     (the CUDA-core short bodies at L=196 and 64) against CPU: features, the siglip
     loss and every gradient (the logit bias and the MAP pool's included);
 27. dist_losses, in an NCCL process group of one (this card): the gathered clip_loss
     (local_loss on and off) and siglip_loss (gather, shift, bidir, reduce) forward and
     backward on seeded bf16 features at ViT-B-32's width and batch 256, against the
     one-process forms (relative error of the loss and of each gradient) and timed;
 28. dist_train: phase 4's ViT-B-32 b256 step from seed 0, plain and with the model
     under FSDP2 (shard_model on a (data 1, fsdp 1) mesh), the same count of steps each:
     the losses agree, 24 + 24 short launches a step in both, step ms, kernel ms, idle
     share and peak GiB side by side; then GradCache steps (accum_steps=2) in both;
 29. dist_cli: python -m open_clip_tpu_torch.train.main in a child process under
     torchrun's variables (RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR and a free
     MASTER_PORT): an NCCL group of one, one epoch at b64, then a second through --resume.
 30. decode: what the host has for JPEG decoding (g++, jpeglib.h, libjpeg.so*,
     nvjpeg.h, the cores), the build of the native decode stage (libjpeg where its
     header is, else nvJPEG; the line says which), the committed JPEGs of
     tests/assets_torch against their canvases (made by the JAX package's libjpeg
     build; max and mean difference, strict and fractional), the full-resolution
     decode that NaFlex data takes on the card against the committed whole-image
     decodes (full_decodes.npz; libjpeg's, equal to PIL's) and a decode into memory
     that a kernel queued on the allocating stream still uses (twice), bad bytes and
     the grayscale asset, and the decode rate at canvas 256 on 1, 4 and cpu_count threads;
 31. data_train, the slice's main path: 16 tar shards of 512 JPEG-caption pairs (the
     assets, each under distinct keys and captions), a 512-pair val shard and a
     10-class folder in a temporary directory; the CLI trains ViT-B-32 b256 amp_bf16
     from the shards (--device-preprocess, --native-decode-threads cpu_count) for one
     epoch of 32 steps, then evaluates (val retrieval, zero-shot with 1000 classes x
     80 templates). Step ms, the loop's host data and batch ms, the crop's device ms
     (CUDA events), 24 + 24 short launches every step, the evaluation's seconds by
     part and its metrics, beside phase 4's synthetic step;
 32. data_card_vs_cpu: fp32, TF32 off: make_device_train_preprocess at b256 and the
     same boxes (max abs <= 1e-5), make_eval_step on ViT-B-32 at b32 (min cosine,
     loss relative 1e-4), card against CPU;
 33. pretrained_load: ViT-B-32 (seed 0) written in a temporary directory as a
     local-dir: model directory (save_for_hf: open_clip_config.json and
     open_clip_model.safetensors in the reference layout), as a .pt wrapped as
     {"state_dict": {"module." + k: v}} and as a bare .bin; each loaded through
     create_model_and_transforms in pure_bf16 equals the source bit for bit; the
     file MB and the seconds of each part of a load (read, convert and merge, copy to
     the card) and of the whole call; the .pt's model serves phase 2's b256 request
     and a classifier with the source's features bit for bit at 12 + 12 short launches;
 34. pretrained_resize: the .pt at force_image_size=256 (grid 7 -> 8) and
     force_context_length=64: b256 served with 12 short launches at L=65 and 12 at
     L=64; fp32 (TF32 off) card features against the CPU's, min cosine >= 0.9999;
 35. siglip_big_vision: a big_vision .npz synthesized from ViT-B-16-SigLIP (seed 0:
     per-head q/k/v, the MAP head, t and b), with and without the params/ root,
     loaded by load_big_vision_weights into a seed-1 model: bit for bit; b256 served
     in pure_bf16 with 12 short launches at L=196 and 12 at L=64; the load seconds;
 36. finetune: the .pt in amp_bf16, the image tower locked but for its head and last
     block, layer decay 0.75, AdamW (lr 5e-4, wd 0.2, clip 1.0): library steps on
     phase 4's batch timed and profiled beside phase 4's plain step (locked tensors
     keep the checkpoint's bits, ln_post, proj, the last image block and the text
     tower move, 24 + 24 short launches a step); the CLI with --pretrained
     --lock-image --lock-image-unlocked-groups 2 --layer-decay 0.75 for 16 steps
     (the same checks on synthetic data, where only the weight decay moves
     anything); a --pretrained-image load at --seed 1 (the image tower equals the
     checkpoint's, the text tower the seed-1 init's). The checkpoints are deleted at
     the end.
 37. naflexclap_serve: naflexclap_mediumd_pf4_pt20_moderntextp in pure_bf16, requests of
     64 clips of seeded lengths of 3-10 s at 48 kHz patchified on the host
     (AudioNaFlexPatchify, padded to 816 tokens), a pinned copy, encode_audio (the
     trunk's 20 blocks on the flash forward with the clips' key validity) and a
     10-class classifier from seeded token ids (the tiktoken vocabulary is not in the
     repository; the modern text tower is dense); latency, clips/s, the host patchify's
     ms, the copy and device ms (CUDA events), device ms by kernel class (profiled), 20
     wgmma flash forwards a request;
 38. naflexclap_train: the same model in amp_bf16, batch 64 of phase 37's patch dicts
     and seeded token rows, AdamW with clipping, timed and profiled like phase 4: the
     loss falls, 20 launches of each flash kernel a step, all wgmma, no short launch;
 39. naflexclap_card_vs_cpu: fp32 (TF32 off), 2 layers a tower at full width, a 10 s and
     a 4.3 s clip: the card (the flash kernels' CUDA-core bodies, keys masked) against
     the CPU (the dense bias): features, the loss and every gradient;
 40. audio_data_train: naflexclap_mediumd (the CLIP BPE text tower; 252 audio tokens,
     the trunk's dense path) trained by the CLI for one epoch from 4 WAV tar shards
     (16, 44.1 and 48 kHz, mono and stereo, int16 and float32, written by the script),
     the zero-shot split of a 10-class WAV folder after it, then an evaluation-only run
     of --audio-zeroshot-dataset on the folder: step and host data ms, zero-shot s.
 41. naflex_data_train: naflex_ViT-B-16 at full width and depth trained by the CLI for
     2 epochs from 16 tar shards of the committed JPEGs and seeded PNGs (written with
     zlib and struct), --dataset-type webdataset-naflex at 256/576/1024 tokens in a
     16384-token budget with --length-bucketing, amp_bf16, AdamW, --ema 0.999,
     --save-most-recent and --delete-previous-checkpoint: step ms by bucket, host data
     ms, images/s, device-busy ms and idle share (3 steps profiled), flash launches a
     step by bucket, the EMA's device ms, the decode route; and the first batch on the
     card's route (nvJPEG into the card's memory, resized there) against the CPU's;
 42. optimizers: ViT-B-32 b256 amp_bf16 stepped by adamw, nadamw, lion, sgd, lamb,
     adafactor and muon in turn from the same weights: step ms, each update's device ms
     (profiled alone), its state's GiB, the peak; each at 2 layers and full width in
     fp32: the card's update_ against the CPU's on the gradients of 2 CPU train steps,
     each entry within 1e-4 of its tensor's largest change plus 3 ulp (lion: the share
     beyond; muon: by the cosine, and per entry with its Newton-Schulz in float32);
 43. patch_dropout_train: ViT-B-16 b256 amp_bf16 with patch dropout 0.5 (99 tokens)
     beside none (197): step and kernel ms, short launches by length;
 44. remat_dots: ViT-L-14 (12 image and 6 text blocks at full width) b64 amp_bf16 under
     full remat, names_mm, dots and
     dots_no_batch from the same weights: step and kernel ms, peak GiB, launches.
 45. coca_serve: coca_ViT-B-32 in pure_bf16 (seed 0): a 10-class classifier (its CLS
     text tower dense: the pad mask is a bias), requests of 64 uint8 images
     (encode_image + top-5), of 64 caption rows (encode_text), greedy captions of 30
     tokens through the KV cache at b64 and beam search over 6 beams at b16, each
     timed over a window and profiled; 12 short forwards (L=50) an image-tower call and
     none in the cached decode (its one-query attention is plain), the pool and the
     text tower dense (select_impl counted); the bf16 cached decode's logits against
     the uncached forward, teacher-forced on the greedy tokens (12 + 12 short launches:
     the image tower and the decoder at L=76); fp32 (TF32 off) card against CPU
     (features and decoder logits), and cached against uncached greedy captions token
     for token with the teacher-forced logits;
 46. coca_train: coca_ViT-B-32 b256 amp_bf16, AdamW, clip 1.0, loss_type "coca" (the
     caption through the chunked linear CE) on a fixed batch, timed and profiled like
     phase 4: the loss and the caption term fall, 12 + 12 short forward and backward
     launches a step (image tower and decoder, tensor-core bodies), none for the text
     tower; the chunked CE and the dense attention timed alone at the step's shapes
     (their shares of the kernel ms); 2 steps under full remat from the same weights;
     the CLI (b64, 4 steps, --val-data synthetic: val_generative_loss), a checkpoint
     and --resume;
 47. distill_train: a ViT-B-32 student and a ViT-B-32 teacher (seed 1), b256 amp_bf16,
     loss_type "distill" (lr 1e-4), timed and profiled like phase 4: the loss falls, 24 + 24
     short forwards (student and teacher) and 12 + 12 backwards a step, the teacher's
     weights unchanged.
 48. genlip_serve: naflexgenlip_b16 (bf16 compute; its weights stay fp32, as the JAX
     factory keeps them) from seeded patch dicts and token ids (the tiktoken
     vocabulary is not in the repository): encode_image requests of 32 images at 1024
     tokens (ragged 1024/768 validity; 12 wgmma flash forwards a request, no other
     attention kernel), 16 captions of 128 ids scored against one image's prefix cache
     (dense), greedy captions of 32 tokens at b16 over 256-token prefixes with the KV
     cache (timed and profiled) and without (timed); then fp32 (TF32 off): cached captions
     equal uncached ones token for token, and cached scores equal the joint forward's,
     whose trunk takes the flash kernels with prefix_len 1024 at 1152 tokens;
 49. genlip_train: the JAX package's bench_genlip step, b32 of 1024 image + 128 text
     tokens (ragged captions), amp_bf16, AdamW (lr 1e-4, wd 0.1), clip 1.0, full remat,
     timed and profiled like phase 4: the loss falls; 24 flash forwards (12 and remat's
     12 again), 12 dq and 12 dk/dv a step, all wgmma, every call with prefix_len 1024;
     then one accum_freq 2 step against the simple step from the same weights (plain
     gradient descent: loss and update);
 50. genlap_serve_train: naflexgenlap_betwixt, 32 ten-second clips through the
     factory's mel patchify (63 tokens: dense), encode_audio, cached scoring, and the
     packed (pack_prefix) caption step in amp_bf16: the loss falls, no flash or short
     launch;
 51. genlip_card_vs_cpu: fp32 (TF32 off), naflexgenlip_b16's widths at depth 2, 448
     image + 96 text tokens (one caption ragged): the card's trunk on the flash
     kernels' CUDA-core bodies with prefix_len 448 against the CPU's dense bias:
     logits on the valid rows, the caption loss and every gradient.
 52. rn50_serve: RN50 (the ModifiedResNet tower: convolutions on cuDNN's NHWC path,
     batch norms on stored statistics, the dense attention pool) in pure_bf16, a
     10-class classifier and requests of 256 uint8 256x320 images, timed and profiled
     like phase 2 (device ms by kernel class: conv, batch_norm, pool, elementwise,
     matmul, short attention); 12 short forwards for the classifier, none an image;
 53. rn50_train: RN50 b256 amp_bf16, AdamW, clip 1.0, train-mode batch norms, timed and
     profiled like phase 4 (the idle share also as 1 - kernel ms / step ms): the loss
     falls, 12 + 12 short launches a step; then a plain step, whose running statistics
     must equal 0.9 of theirs plus 0.1 of the batch's, a freeze_bn_stats step and an
     accum_steps 2 (GradCache) step, after which they must not have moved;
 54. rn_card_vs_cpu: fp32, TF32 off for the matmuls and cuDNN, RN50's widths with one
     block a stage and 2 text blocks, b4: features, the loss and every gradient (the
     attention pool's key bias, zero in exact arithmetic, by its size), and the running
     statistics after one step, card against CPU;
 55. convnext_serve: convnext_base_w (256 px, text 640 wide in 10 heads) in pure_bf16,
     requests of 256 images, like phase 52;
 56. convnext_train: convnext_base_w b128 amp_bf16, AdamW, clip 1.0, drop path 0.1: a
     window with the fused LayerNorm backward off and one with it on (66 launches a
     step, 5 at the stage-0 shape 524288 x 128), each timed and profiled; the two
     switches' gradients from the same weights and drop-path masks (cosine), and the
     loss under full remat against the plain forward's with the same masks;
 57. convnext_card_vs_cpu: fp32 (TF32 off), convnext_base_w's widths with blocks 1, 1,
     2, 1 and 2 text blocks, drop path 0, b2: features, the loss and every gradient.

Phase 1 also times the short forward and backward at CoCa's decoder shape (B=256, L=76,
H=8, causal) and at the SigLIP shapes, the flash
forward at ViT-B-16-SigLIP-384's (576 tokens, no key mask) and the three flash kernels
at the NaFlex audio trunk's (B=64, L=816, H=8, ragged key validity) and at GenLIP's train step
(B=32, L=1152, H=12, causal with prefix_len 1024, ragged captions), the short kernels at
convnext_base_w's text shape (B=128, L=77, H=10, causal) and the LayerNorm backward at
its stage-0 shape (524288 x 128, bf16); phase 17 also times the
SwitchBack product's mma body at one ragged shape (130 x 40 x 129).

Every kernel record names its body: "wgmma" (on the tensor cores, warpgroup
products fed by TMA: the flash kernels in bf16, the SwitchBack product in int8), "mma"
(on the tensor cores, mma.sync) or "simt" (CUDA cores); the train lines give the launches by body and the kernel ms
of a step beside the step time.

Prints the card's name and power limit (nvidia-smi), and when every check passed
one {"kernels": [...]} JSON line and as the last line {"ok": true, "device": {...}}.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,  # dense bf16 tensor / fp32 non-tensor
              "int8": 1979e12}  # dense int8 tensor
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # max |kernel - plain|, inputs ~N(0, 1)
# backward kernels, relative to the plain result's largest entry: fp32 sums of up to
# 77 (attention) or 19712 (LayerNorm) terms in another order; bf16 rounds ds, p and
# every output to 2**-8
BWD_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
COSINE_MIN = 0.9999
BATCH = 256
IMAGE_HW = (256, 320)
CLASSES = 10
DISTINCT_REQUESTS = 8  # request tensors made once and reused in turn
WINDOW_S = 0.5  # the timed serving windows last at least this long
TRAIN_WINDOW_S = 2.0  # and the timed training windows this long
TRAIN_PROFILED_STEPS = 2
CLI_STEPS_PER_EPOCH = 16
PROFILED_REQUESTS = 5
PHASES = ("preprocess", "encode_image", "logits_top5")
NAFLEX_MODEL = "naflex_ViT-B-16"
NF_SERVE_BATCH, NF_IMAGE_HW, NF_SERVE_SEQ = 32, (384, 512), 576
NF_TRAIN_BATCH, NF_TRAIN_SEQ = 16, 1024
NF_CLI_STEPS = 8
FLASH_SOURCE = "open_clip_tpu_torch/csrc/flash_attention.cu"
WINDOW_SOURCE = "open_clip_tpu_torch/csrc/window_attention.cu"
# the NaFlex-audio CLAP: 64 clips of 3-10 s, at most 816 tokens (16 frequency x 51
# time patches of a 10 s clip); the flash kernel record at the lengths of such clips
NFC_MODEL, NFC_BATCH, NFC_SEQ, NFC_HEADS = "naflexclap_mediumd_pf4_pt20_moderntextp", 64, 816, 8
NFC_SECONDS = (3.0, 10.0)
NFC_LENS = (816, 256, 528, 672, 400, 752)
NFC_SERVE_REQUESTS, NFC_PROFILED, NFC_MIN_WINDOW = 3, 2, 7
# real audio through the CLI: WAV tar shards for the CLIP-BPE-text naflexclap config
NFC_DATA_MODEL, NFC_DATA_SHARDS, NFC_DATA_PER_SHARD, NFC_DATA_BATCH = "naflexclap_mediumd", 4, 32, 32
CLAP_MODEL = "CLAP-HTSAT-tiny"
CLAP_SERVE_BATCH, CLAP_TRAIN_BATCH, CLAP_CLI_BATCH = 64, 128, 32
CLAP_SECONDS, CLAP_RATE = 10, 48000
CLAP_CLI_STEPS = 4
ESC50_CLASSES = ("dog", "rooster", "pig", "cow", "frog", "cat", "hen", "insects", "sheep", "crow")
SWIN_MODEL = "swin_base_patch4_window7_224"
SWIN_SERVE_BATCH, SWIN_TRAIN_BATCH = 64, 32
# phase 11's cases whose tensor-core forward is launched twice and compared bit for bit
FWD_DETERMINISM_CASES = ("swin_s0_shift", "htsat_s0_shift_serve")
SB_SOURCE = "open_clip_tpu_torch/csrc/switchback.cu"
H14_MODEL, H14_BATCH = "ViT-H-14", 32
# the script's time limit: ViT-H-14's train runs take 8 of its 32 image blocks and 6 of
# its 24 text blocks (full width, the same kernels and shapes a block), remat_dots
# ViT-L-14's 12 and 6 of 24 and 12
H14_DEPTH, RD_DEPTH = (8, 6), (12, 6)
L14_MODEL, L14_BATCH = "ViT-L-14", 64  # the JAX package's bench_vit_l14 step
# the JAX package's bench_siglip step (batch 256, 224 px, 64 text tokens); the 384-px
# tower (576 tokens, the flash forward) served at a quarter of that batch
SIGLIP_MODEL, SIGLIP_BATCH = "ViT-B-16-SigLIP", 256
SIGLIP384_MODEL, SIGLIP384_BATCH = "ViT-B-16-SigLIP-384", 64
SIGLIP_CLI_STEPS = 6
# CoCa: requests of 64 images (encode_image, greedy captions of 30 tokens) and 16 for
# beam search over 6 beams; the train step at batch 256; the distillation step's
# teacher is a ViT-B-32 from another seed
COCA_MODEL, COCA_SERVE_BATCH, COCA_BEAM_BATCH, COCA_BEAMS, COCA_SEQ = "coca_ViT-B-32", 64, 16, 6, 30
COCA_CLI_BATCH, COCA_CLI_STEPS = 64, 4
# GenLIP (random weights, seeded token ids: the tiktoken vocabulary is not in the
# repository): encode_image requests of 32 images at 1024 tokens, 16 captions of 128
# scored against one image's cache, greedy captions of 32 tokens at b16 over 256-token
# prefixes (the JAX package's bench_generation); the train step is bench_genlip's at
# batch 32 (1024 image + 128 text tokens). GenLAP: 32 ten-second clips
GENLIP_MODEL, GENLIP_BATCH, GENLIP_NI, GENLIP_LT, GENLIP_CAPTIONS = "naflexgenlip_b16", 32, 1024, 128, 16
GENLIP_GEN_BATCH, GENLIP_GEN_NI, GENLIP_GEN_SEQ, GENLIP_PROFILED = 16, 256, 32, 4
GENLAP_MODEL, GENLAP_SECONDS = "naflexgenlap_betwixt", 10
# the cached decode against the uncached forward in pure_bf16: the two paths round to bf16
# in different places (the cached one-query softmax is fp32, the uncached attention casts
# its probabilities to bf16), which moves a 49408-logit row's cosine to 0.99983 on the
# H100 (the same in four runs); the limit leaves 3x that gap. fp32 is held to COSINE_MIN
COCA_BF16_COSINE_MIN = 0.9995
# the MLP products (M, K, N) of ViT-H-14 at batch 32 (257 and 77 tokens) and of
# ViT-B-32 at batch 256 (50 and 77 tokens), then ragged shapes
SB_SHAPES = {"h14_vision_fc": (8224, 1280, 5120), "h14_vision_proj": (8224, 5120, 1280),
             "h14_text_fc": (2464, 1024, 4096), "h14_text_proj": (2464, 4096, 1024),
             "b32_vision_fc": (12800, 768, 3072), "b32_vision_proj": (12800, 3072, 768),
             "b32_text_fc": (19712, 512, 2048), "b32_text_proj": (19712, 2048, 512)}
SB_RAGGED = [(5, 16, 3), (9, 24, 13), (33, 40, 7), (130, 72, 129), (257, 80, 250), (1, 1, 1),
             (130, 144, 129), (130, 40, 129)]
SB_TIMED_RAGGED = (130, 40, 129)  # a shape of the mma body (K % 16 != 0), timed as well
# card against CPU with the int8 forward: a value at a rounding tie of its
# quantization may land one level apart where the fp32 sums before it ran in
# another order, which moves that output by one quantum (~1e-2 of the row's
# largest entry); so a looser bound than COSINE_MIN
SB_COSINE_MIN, SB_LOSS_RTOL = 0.999, 1e-3
# the conv towers: RN50 served and trained at b256 (224 px), convnext_base_w (256 px,
# the config's drop path 0.1) served at b256 and trained at b128
RN_MODEL, RN_BATCH = "RN50", 256
CNX_MODEL, CNX_SERVE_BATCH, CNX_TRAIN_BATCH = "convnext_base_w", 256, 128
# the (rows, width) of every LayerNorm in convnext_base_w's b128 step at 256 px: the
# stem and stage 0 (64x64 positions), stages 1-3 (32x32, 16x16, 8x8; each opened by
# the downsample's norm at the stage before's shape), head_norm, the 640-wide text tower
CNX_LN_SHAPES = {"convnext_s0": (CNX_TRAIN_BATCH * 64 * 64, 128),
                 "convnext_s1": (CNX_TRAIN_BATCH * 32 * 32, 256),
                 "convnext_s2": (CNX_TRAIN_BATCH * 16 * 16, 512),
                 "convnext_s3": (CNX_TRAIN_BATCH * 8 * 8, 1024),
                 "convnext_head": (CNX_TRAIN_BATCH, 1024),
                 "convnext_text": (CNX_TRAIN_BATCH * 77, 640)}
# the LayerNorm backward's cold timing: copies of x and dy past twice the 50 MB L2
COLD_BYTES = 100e6
KERNEL_CLASSES = {  # first match wins
    "switchback": ("int8_matmul_dequant",),
    "switchback_quantize": ("quantize_rowwise",),
    "window_attention_bwd": ("win_attn_bwd", "dbias_fold"),
    "window_attention": ("win_attn_fwd",),
    "flash_attention_bwd_dq": ("flash_attn_bwd_dq",),
    "flash_attention_bwd_dkv": ("flash_attn_bwd_dkv",),
    "flash_attention": ("flash_attn",),
    "short_attention_bwd": ("short_attn_bwd",),
    "short_attention": ("short_attn",),
    "layer_norm_bwd": ("layer_norm_bwd",),  # the port's kernel; PyTorch's own falls below
    # cuDNN's convolutions (implicit GEMMs on the tensor cores, named fprop / dgrad /
    # wgrad) and the layout changes around them, ahead of the GEMMs they resemble
    "conv": ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "conv_depthwise", "depthwise",
             "winograd", "nchwtonhwc", "nhwctonchw"),
    "batch_norm": ("batch_norm", "batchnorm", "bn_fw", "bn_bw"),
    "pool": ("avg_pool", "avgpool", "max_pool"),
    "matmul": ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas", "wgmma"),
    "layer_norm": ("layer_norm", "layernorm", "gammabeta"),
    "optimizer": ("multi_tensor", "foreach"),
    "resize": ("upsample", "interpolate", "aa_"),
    # PyTorch's elementwise kernels (casts, adds, activations)
    "elementwise": ("elementwise_kernel",),
}

FAILURES = []
PHASE_S = {}  # seconds of each phase, printed with the result


def timed(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its wall seconds recorded in PHASE_S under name."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[name] = time.perf_counter() - t0


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def reset_counts(*modules) -> None:
    """Set every kernel's launch count, and every count by body, to 0."""
    for mod in modules:
        for counts in (mod.LAUNCHES, getattr(mod, "FWD_BODIES", {}),
                       getattr(mod, "BWD_BODIES", {})):
            for key in counts:
                counts[key] = 0


def rel_err(got, ref) -> float:
    """max |got - ref| over the largest |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def bound(nbytes: float, flops: float, dn: str) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dn] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@contextlib.contextmanager
def tally_by_shape(sa, fl):
    """While open, count the wrappers' launches by the shape they serve: the
    attention kernels by tower (the text tower is the causal one), the LayerNorm
    backward by width. The wrappers' own counts stay the ones that are checked;
    this only says which tower each launch came from."""
    tally = {}
    fwd, bwd, ln = sa._launch_fwd, sa.short_attention_bwd, fl.layer_norm_bwd

    def bump(key):
        tally[key] = tally.get(key, 0) + 1

    def fwd_(q, k, v, causal, scale):
        out = fwd(q, k, v, causal, scale)
        bump(("fwd", "text" if causal else "vision"))
        return out

    def bwd_(q, k, v, do, *, causal=False, scale=None):
        out = bwd(q, k, v, do, causal=causal, scale=scale)
        bump(("bwd", "text" if causal else "vision"))
        return out

    def ln_(x, dy, scale, eps=1e-5):
        out = ln(x, dy, scale, eps)
        bump(("ln", x.shape[-1]))
        return out

    sa._launch_fwd, sa.short_attention_bwd, fl.layer_norm_bwd = fwd_, bwd_, ln_
    try:
        yield tally
    finally:
        sa._launch_fwd, sa.short_attention_bwd, fl.layer_norm_bwd = fwd, bwd, ln


def cut_depth(oc, name: str, vision: int, text: int) -> str:
    """Register ``name``'s config with ``vision`` image and ``text`` text blocks (the
    widths and every other field kept); returns the new name."""
    raw = json.loads(json.dumps(oc.get_model_config(name)))
    raw["vision_cfg"]["layers"], raw["text_cfg"]["layers"] = vision, text
    cut = f"{name}-{vision}-{text}-layers"
    oc.add_model_config(raw, name=cut)
    return cut


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA graph, so
    no host work sits between the launches; the median over ``replays`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs require
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def cold_ms(fn, inputs, iters: int = 20, replays: int = 3) -> float:
    """Device ms per call of ``fn(*inputs[k])``, the k taken in turn: as ``graph_ms``,
    the calls captured in one CUDA graph. Hand it copies whose one pass exceeds
    ``COLD_BYTES``, so that no call finds its inputs in the 50 MB L2, as a step's
    backward finds what its forward saved long before."""
    import torch

    calls = -(-max(iters, len(inputs)) // len(inputs)) * len(inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in inputs:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host microseconds to enqueue one call of ``fn``: ``calls`` calls with no
    synchronisation between them (at a shape the card runs faster than the host
    enqueues, so that the launch queue never fills)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def attention_inputs(b, l, h, hd, dtype, gen, c2=False):
    """q, k, v as the three views of one fused (B, L, 3, H, hd) projection, the
    layout the towers hand the kernel."""
    import torch

    qkv = torch.randn(b, l, 3, h, hd, generator=gen, device="cuda")
    if c2:  # head 0's logits ~100 below head 1's: q.k*scale = -100 + O(0.1)
        qkv[:, :, 0, 0] = 1.0 + 0.1 * qkv[:, :, 0, 0]
        qkv[:, :, 1, 0] = -100.0 / (hd * hd ** -0.5) + 0.01 * qkv[:, :, 1, 0]
    q, k, v = qkv.to(dtype).unbind(2)
    return q, k, v


def phase_kernels(torch, sa, text_batch):
    """Kernel vs plain version; returns the per-shape records for the kernels line."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    both = (torch.bfloat16, torch.float32)
    # the text tower at the serving batch as well: the classifier's batch is small; ViT-L-14's
    # image tower (L=257), the shortest two-pass length (129) and the most shared memory
    bf16 = (torch.bfloat16,)
    cases = [("vision", BATCH, 50, 12, 64, False, both),
             ("text", text_batch, 77, 8, 64, True, both),
             ("text_b256", BATCH, 77, 8, 64, True, bf16),
             ("l257", L14_BATCH, 257, 16, 64, False, bf16),
             ("l129", L14_BATCH, 129, 16, 64, False, bf16),
             ("l288_hd128", 16, 288, 8, 128, True, bf16),
             # ViT-B-16-SigLIP at bench_siglip's batch: the image tower's 196 tokens (no
             # class token, the two-pass body) and the non-causal 64-token text tower
             ("siglip_vision", SIGLIP_BATCH, 196, 12, 64, False, bf16),
             ("siglip_text", SIGLIP_BATCH, 64, 12, 64, False, bf16),
             # ViT-B-16 at batch 256: 197 tokens, and 99 under patch dropout 0.5
             ("l197", BATCH, 197, 12, 64, False, bf16),
             ("l99", BATCH, 99, 12, 64, False, bf16),
             # coca_ViT-B-32's decoder self-attention at the train batch
             ("coca_decoder", BATCH, 76, 8, 64, True, bf16),
             # convnext_base_w's text tower (width 640, 10 heads) at its train batch and
             # at its classifier's
             ("text_h10", CNX_TRAIN_BATCH, 77, 10, 64, True, bf16),
             ("text_h10_b70", text_batch, 77, 10, 64, True, bf16)]
    records = {}
    for name, b, l, h, hd, causal, dtypes in cases:
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            body = sa.fwd_body(l, hd, dtype)
            q, k, v = attention_inputs(b, l, h, hd, dtype, gen)
            before = dict(sa.FWD_BODIES)
            out = sa.short_attention(q, k, v, causal=causal)
            ref = sa.short_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(bool(torch.isfinite(out).all()) and err <= TOL[dn]
                  and sa.FWD_BODIES[body] == before[body] + 1,
                  f"kernel ({body}) {name} B={b} L={l} H={h} hd={hd} causal={causal} {dn}: "
                  f"max_abs_err={err:.3e} (tol {TOL[dn]:.0e})")
            ms = graph_ms(lambda: sa.short_attention(q, k, v, causal=causal))
            plain_ms = graph_ms(lambda: sa.short_attention_reference(q, k, v, causal=causal))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
            nbytes = 4 * b * l * h * hd * q.element_size()
            pairs = l * (l + 1) // 2 if causal else l * l  # (query, key) pairs the mask keeps
            flops = 4 * b * h * hd * pairs
            rec = {"name": f"short_attention_fwd[{name}]", "route": "cuda", "body": body,
                   "source": "open_clip_tpu_torch/csrc/short_attention.cu",
                   "replaces": "open_clip_tpu/ops/short_attention.py:262",
                   "shape": [b, l, h, hd], "causal": causal, "dtype": dn,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   **bound(nbytes, flops, dn), "library_ms": library_ms}
            print("kernel_case " + json.dumps(rec), flush=True)
            if dtype == torch.bfloat16:  # the serving path's dtype
                records[name] = rec
    for l, dtype in ((50, torch.bfloat16), (50, torch.float32), (257, torch.bfloat16)):
        q, k, v = attention_inputs(4, l, 12, 64, dtype, gen, c2=True)
        out = sa.short_attention(q, k, v)
        ref = sa.short_attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        dn = str(dtype).split(".")[1]
        check(bool(torch.isfinite(out).all()) and err <= TOL[dn],
              f"kernel ({sa.fwd_body(l, 64, dtype)}) C2 regime (head 0 logits ~100 below head 1) "
              f"L={l} {dn}: max_abs_err={err:.3e}")
    return records


def phase_attention_bwd_kernels(torch, sa):
    """Backward kernel vs plain version at the train step's shapes, at L=128 (the
    longest the fused tensor-core body takes), and at L=129, 257 (ViT-L-14's image
    tower) and 288 with hd=128, which take the two tensor-core kernels; per-shape
    records, keyed by (name, dtype)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = {}
    both, bf16 = (torch.bfloat16, torch.float32), (torch.bfloat16,)
    for name, b, l, h, hd, causal, dtypes in (("vision", BATCH, 50, 12, 64, False, both),
                                              ("text", BATCH, 77, 8, 64, True, both),
                                              ("l128", 128, 128, 12, 64, False, bf16),
                                              ("l129", L14_BATCH, 129, 16, 64, False, bf16),
                                              ("l257", L14_BATCH, 257, 16, 64, False, bf16),
                                              ("l288_hd128", 16, 288, 8, 128, True, bf16),
                                              ("siglip_vision", SIGLIP_BATCH, 196, 12, 64, False,
                                               bf16),
                                              ("siglip_text", SIGLIP_BATCH, 64, 12, 64, False,
                                               bf16),
                                              ("l197", BATCH, 197, 12, 64, False, bf16),
                                              ("l99", BATCH, 99, 12, 64, False, bf16),
                                              ("coca_decoder", BATCH, 76, 8, 64, True, bf16),
                                              ("text_h10", CNX_TRAIN_BATCH, 77, 10, 64, True,
                                               bf16)):
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            body = sa.bwd_body(l, hd, dtype)
            q, k, v = attention_inputs(b, l, h, hd, dtype, gen)
            do = torch.randn(b, l, h, hd, generator=gen, device="cuda").to(dtype)
            before = dict(sa.BWD_BODIES)
            grads = sa.short_attention_bwd(q, k, v, do, causal=causal)
            refs = sa.short_attention_bwd_reference(q, k, v, do, causal=causal)
            torch.cuda.synchronize()
            errs = [rel_err(g, r) for g, r in zip(grads, refs)]
            abs_err = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs))
            check(all(bool(torch.isfinite(g).all()) for g in grads) and max(errs) <= BWD_RTOL[dn]
                  and sa.BWD_BODIES[body] == before[body] + 1,
                  f"backward kernel ({body}) {name} B={b} L={l} H={h} hd={hd} causal={causal} "
                  f"{dn}: rel err dq/dk/dv={errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} "
                  f"(tol {BWD_RTOL[dn]:.0e})")
            ms = graph_ms(lambda: sa.short_attention_bwd(q, k, v, do, causal=causal))
            plain_ms = graph_ms(
                lambda: sa.short_attention_bwd_reference(q, k, v, do, causal=causal))
            # library: SDPA forward and backward, less its forward
            ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa_both():
                out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
                return torch.autograd.grad(out, (ql, kl, vl), dot)

            library_ms = (graph_ms(sdpa_both) - graph_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)))
            pairs = l * (l + 1) // 2 if causal else l * l
            rec = {"name": f"short_attention_bwd[{name}]", "route": "cuda", "body": body,
                   "source": "open_clip_tpu_torch/csrc/short_attention.cu",
                   "replaces": "open_clip_tpu/ops/short_attention.py:296",
                   "shape": [b, l, h, hd], "causal": causal, "dtype": dn,
                   "max_abs_err": abs_err, "max_rel_err": max(errs), "ms": ms,
                   "plain_ms": plain_ms,
                   **bound(7 * b * l * h * hd * q.element_size(), 10 * b * h * hd * pairs, dn),
                   "library_ms": library_ms}
            print("kernel_case " + json.dumps(rec), flush=True)
            records[(name, dn)] = rec
    for l, dtype in ((50, torch.bfloat16), (50, torch.float32), (257, torch.bfloat16)):
        dn = str(dtype).split(".")[1]
        q, k, v = attention_inputs(4, l, 12, 64, dtype, gen, c2=True)
        do = torch.randn(4, l, 12, 64, generator=gen, device="cuda").to(dtype)
        grads = sa.short_attention_bwd(q, k, v, do)
        refs = sa.short_attention_bwd_reference(q, k, v, do)
        errs = [rel_err(g, r) for g, r in zip(grads, refs)]
        check(all(bool(torch.isfinite(g).all()) for g in grads) and max(errs) <= BWD_RTOL[dn],
              f"backward kernel ({sa.bwd_body(l, 64, dtype)}) C2 regime (head 0 logits ~100 "
              f"below head 1) L={l} {dn}: rel err {max(errs):.2e}")
    return records


def phase_ln_bwd_kernels(torch, fl):
    """LayerNorm backward kernel vs plain version; records for the two tower shapes and
    for every shape of convnext_base_w's b128 step (``CNX_LN_SHAPES``). Each shape is
    timed warm (``graph_ms``: the same x and dy every call, in L2 where they fit) and
    cold (``cold_ms`` over copies of x and dy past ``COLD_BYTES``), the kernel and
    ``native_layer_norm_backward`` alike; the record's ``ms`` and ``library_ms`` are
    the cold times. The wrapper's host cost is timed at the head_norm shape."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}
    both = (torch.bfloat16, torch.float32)
    for name, rows, w, dtypes in (("vision", BATCH * 50, 768, both), ("text", BATCH * 77, 512, both),
                                  ("pooled", BATCH, 768, both),
                                  *((n, r, w, (torch.bfloat16,))
                                    for n, (r, w) in CNX_LN_SHAPES.items())):
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            x = (torch.randn(rows, w, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
            dy = torch.randn(rows, w, generator=gen, device="cuda").to(dtype)
            scale = torch.randn(w, generator=gen, device="cuda")
            got = fl.layer_norm_bwd(x, dy, scale, 1e-5)
            ref = fl.layer_norm_bwd_reference(x, dy, scale, 1e-5)
            torch.cuda.synchronize()
            errs = [rel_err(g, r) for g, r in zip(got, ref)]
            abs_err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
            check(all(bool(torch.isfinite(g).all()) for g in got) and max(errs) <= BWD_RTOL[dn],
                  f"LayerNorm backward kernel {name} {rows}x{w} {dn}: rel err dx/dscale/dbias="
                  f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (tol {BWD_RTOL[dn]:.0e})")
            again = fl.layer_norm_bwd(x, dy, scale, 1e-5)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"LayerNorm backward kernel {name} {rows}x{w} {dn}: two calls bit-equal")
            warm_ms = graph_ms(lambda: fl.layer_norm_bwd(x, dy, scale, 1e-5))
            plain_ms = graph_ms(lambda: fl.layer_norm_bwd_reference(x, dy, scale, 1e-5))
            # library: PyTorch's own LayerNorm backward, given the forward's statistics
            wt, bt = scale.to(dtype), torch.zeros(w, device="cuda", dtype=dtype)
            _, mean, rstd = torch.native_layer_norm(x, [w], wt, bt, 1e-5)

            def native(x_, dy_, mean_, rstd_):
                return torch.ops.aten.native_layer_norm_backward(
                    dy_, x_, [w], mean_, rstd_, wt, bt, [True, True, True])

            library_warm_ms = graph_ms(lambda: native(x, dy, mean, rstd))
            n_copies = math.ceil(COLD_BYTES / (2 * x.nbytes))
            copies = [(x, dy, mean, rstd)] + [
                (torch.randn_like(x, dtype=torch.float32).to(dtype), torch.randn_like(dy),
                 mean, rstd) for _ in range(n_copies - 1)]
            ms = cold_ms(lambda x_, dy_, *_: fl.layer_norm_bwd(x_, dy_, scale, 1e-5), copies)
            library_ms = cold_ms(native, copies)
            del copies
            moved = 3 * rows * w * x.element_size() + 12 * w
            rec = {"name": f"layer_norm_bwd[{name}]", "route": "cuda", "body": "tma_ring",
                   "source": "open_clip_tpu_torch/csrc/layer_norm_bwd.cu",
                   "replaces": "open_clip_tpu/ops/fused_ln.py:39",
                   "shape": [rows, w], "dtype": dn, "max_abs_err": abs_err,
                   "max_rel_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                   **bound(moved, 12 * rows * w, "float32"), "library_ms": library_ms,
                   "warm_ms": warm_ms, "library_warm_ms": library_warm_ms,
                   "cold_copies": n_copies, "tb_s": moved / ms / 1e9,
                   "warm_tb_s": moved / warm_ms / 1e9,
                   "plan": dataclasses.asdict(fl.launch_plan(rows, w, dtype, sms))}
            rec["bound_share"] = rec["bound_ms"] / ms
            if (rows, w) == CNX_LN_SHAPES["convnext_head"]:
                rec["host_us_per_call"] = host_us_per_call(
                    lambda: fl.layer_norm_bwd(x, dy, scale, 1e-5))
            print("kernel_case " + json.dumps(rec), flush=True)
            if dtype == torch.bfloat16 and name != "pooled":
                records[name] = rec
    return records


def ragged_valid(torch, b, l, lens):
    """(B, L) bool: sample i is valid up to lens[i % len(lens)]."""
    n = torch.tensor([lens[i % len(lens)] for i in range(b)], device="cuda")
    return torch.arange(l, device="cuda")[None, :] < n[:, None]


def phase_flash_kernels(torch, fa):
    """The three flash kernels vs their plain versions; records for the kernels line.

    Tolerances as for the short kernels (TOL on the output, BWD_RTOL on each gradient
    relative to the plain result's largest entry): the sums run over up to 1024 keys,
    tile by tile with a running max, and stay inside them; lse within 1e-4."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    # name, B, L, H, hd, causal, prefix_len, valid lengths (None: no mask), timed
    cases = [("train", NF_TRAIN_BATCH, NF_TRAIN_SEQ, 12, 64, False, 0, (1024, 768), True),
             ("serve", NF_SERVE_BATCH, NF_SERVE_SEQ, 12, 64, False, 0, (540,), True),
             ("l577", 8, 577, 12, 64, False, 0, None, False),
             ("causal640", 8, 640, 12, 64, True, 0, None, False),
             ("prefix256", 4, 1024, 12, 64, True, 256, None, False),
             ("hd128", 4, 512, 8, 128, False, 0, None, False),
             # whole key tiles with no valid key, which the wgmma kernels skip
             ("ragged300", 4, 1024, 12, 64, False, 0, (300, 1024, 129), True),
             # ViT-B-16-SigLIP-384's image tower: 576 tokens and no key mask
             ("siglip384", SIGLIP384_BATCH, 576, 12, 64, False, 0, None, True),
             # the NaFlex-audio trunk: 816 = 6 * 128 + 48 tokens, clips of 3-10 s
             ("audio816", NFC_BATCH, NFC_SEQ, NFC_HEADS, 64, False, 0, NFC_LENS, True),
             # GenLIP's train step: [1024 image ; 128 text] under the prefix-LM mask, the
             # captions ragged (the lengths of genlip_train's batch)
             ("genlip_train", GENLIP_BATCH, GENLIP_NI + GENLIP_LT, 12, 64, True, GENLIP_NI,
              tuple(GENLIP_NI + n for n in (128, 101, 64, 128, 87, 33, 128, 120)), True)]
    records = {}
    for name, b, l, h, hd, causal, prefix, lens, timed in cases:
        valid = ragged_valid(torch, b, l, lens) if lens else None
        kw = dict(causal=causal, key_valid=valid, prefix_len=prefix)
        vis = fa._visible(l, causal, prefix, valid, "cuda")
        # visible (sample, query, key) triples: the mask broadcasts over samples and queries
        pairs = b * l * l if vis is None else int(vis.expand(b, 1, l, l).sum())
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, k, v = attention_inputs(b, l, h, hd, dtype, gen)
            do = torch.randn(b, l, h, hd, generator=gen, device="cuda").to(dtype)
            fwd_body, before = fa.fwd_body(hd, dtype), dict(fa.FWD_BODIES)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            check(fa.FWD_BODIES[fwd_body] == before[fwd_body] + 1
                  and fwd_body == ("wgmma" if dtype == torch.bfloat16 else "simt"),
                  f"flash forward {name} {dtype}: took the {fwd_body} body")
            ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            bwd_body = fa.bwd_body(hd, dtype)
            before, before_bodies = dict(fa.LAUNCHES), dict(fa.BWD_BODIES)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            check(fa.LAUNCHES["bwd_dq"] == before["bwd_dq"] + 1
                  and fa.LAUNCHES["bwd_dkv"] == before["bwd_dkv"] + 1
                  and fa.BWD_BODIES == dict(before_bodies,
                                            **{bwd_body: before_bodies[bwd_body] + 1})
                  and bwd_body == ("wgmma" if dtype == torch.bfloat16 else "simt"),
                  f"flash backward {name} {dtype}: one dq and one dk/dv launch on the "
                  f"{bwd_body} body")
            refs = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            check(bool(torch.isfinite(out).all()) and err <= TOL[dn] and lse_err <= 1e-4,
                  f"flash forward {name} B={b} L={l} H={h} hd={hd} causal={causal} prefix={prefix} "
                  f"valid={lens} {dn}: max_abs_err={err:.3e} (tol {TOL[dn]:.0e}), lse {lse_err:.1e}")
            errs = [rel_err(g, r) for g, r in zip(grads, refs)]
            abs_errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs)]
            check(all(bool(torch.isfinite(g).all()) for g in grads) and max(errs) <= BWD_RTOL[dn],
                  f"flash backward {name} {dn}: rel err dq/dk/dv={errs[0]:.2e}/{errs[1]:.2e}/"
                  f"{errs[2]:.2e} (tol {BWD_RTOL[dn]:.0e})")
            size, n, rows = q.element_size(), b * l * h * hd, b * h * l
            common = {"route": "cuda", "body": bwd_body, "source": FLASH_SOURCE, "shape": [b, l, h, hd],
                      "causal": causal, "prefix_len": prefix, "valid": lens, "dtype": dn,
                      "visible_pairs": pairs}
            it = dict(iters=10, replays=3)
            do_c = do.contiguous()
            vb = fa._valid_bytes(valid, q)
            args = (q, k, v, out, do_c, lse)
            _, di = fa._launch_bwd("bwd_dq", *args, None, vb, causal, hd ** -0.5, prefix)
            ms_fwd = graph_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), **it)
            ms_dq = graph_ms(lambda: fa._launch_bwd("bwd_dq", *args, None, vb, causal, hd ** -0.5,
                                                    prefix), **it)
            ms_dkv = graph_ms(lambda: fa._launch_bwd("bwd_dkv", *args, di, vb, causal, hd ** -0.5,
                                                     prefix), **it)
            ms_bwd = graph_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw), **it)
            plain_fwd = plain_bwd = lib_fwd = lib_bwd = None
            if timed:
                plain_fwd = graph_ms(lambda: fa.flash_attention_reference(q, k, v, **kw), **it)
                plain_bwd = graph_ms(lambda: fa.flash_attention_bwd_reference(
                    q, k, v, ref, ref_lse, do, **kw), **it)
                # library: SDPA with the boolean key mask; backward = both less forward
                ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
                dot = do.transpose(1, 2).contiguous()
                mask = None if vis is None else vis

                def sdpa():
                    return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)

                def sdpa_both():
                    return torch.autograd.grad(sdpa(), (ql, kl, vl), dot)

                with torch.no_grad():
                    lib_fwd = graph_ms(sdpa, **it)
                lib_bwd = graph_ms(sdpa_both, **it) - graph_ms(sdpa, **it)
            recs = {
                "fwd": dict(common, name=f"flash_attention_fwd[{name}]", body=fwd_body,
                            replaces="open_clip_tpu/ops/flash_attention.py:45",
                            max_abs_err=err, lse_abs_err=lse_err, ms=ms_fwd, plain_ms=plain_fwd,
                            **bound(4 * n * size, 4 * h * hd * pairs, dn),
                            library_ms=lib_fwd),
                # each backward kernel alone: dq reads q, k, v, do, out and lse and writes
                # dq and di, with three products; dk/dv reads q, k, v, do, lse and di and
                # writes dk and dv, with four. No single PyTorch call computes one of them
                # alone.
                "bwd_dq": dict(common, name=f"flash_attention_bwd_dq[{name}]",
                               replaces="open_clip_tpu/ops/flash_attention.py:161",
                               max_abs_err=abs_errs[0], max_rel_err=errs[0], ms=ms_dq,
                               plain_ms=plain_bwd,
                               **bound(6 * n * size + 8 * rows, 6 * h * hd * pairs, dn),
                               library_ms=None, library_whole_bwd_ms=lib_bwd),
                "bwd_dkv": dict(common, name=f"flash_attention_bwd_dkv[{name}]",
                                replaces="open_clip_tpu/ops/flash_attention.py:218",
                                max_abs_err=max(abs_errs[1:]), max_rel_err=max(errs[1:]), ms=ms_dkv,
                                plain_ms=plain_bwd,
                                **bound(6 * n * size + 8 * rows, 8 * h * hd * pairs, dn),
                                library_ms=None, library_whole_bwd_ms=lib_bwd),
            }
            for rec in recs.values():
                print("kernel_case " + json.dumps(rec), flush=True)
            # the whole backward (di, dq, dk/dv): reads q, k, v, out, do and lse, writes
            # dq, dk and dv; SDPA's whole backward beside it
            print("kernel_case " + json.dumps(dict(
                common, name=f"flash_attention_bwd[{name}]", ms=ms_bwd, plain_ms=plain_bwd,
                **bound(8 * n * size + 4 * rows, 10 * h * hd * pairs, dn), library_ms=lib_bwd)),
                flush=True)
            if dtype == torch.bfloat16 and timed:  # the main paths' dtype
                records[name] = recs
            del q, k, v, do, out, lse, ref, ref_lse, grads, refs
        torch.cuda.empty_cache()
    # a sample with no valid key: zero rows, finite, as the plain version
    q, k, v = attention_inputs(2, 600, 4, 64, torch.bfloat16, gen)
    valid = ragged_valid(torch, 2, 600, (600, 0))
    out, lse = fa.flash_attention_fwd(q, k, v, key_valid=valid)
    ref, _ = fa.flash_attention_reference(q, k, v, key_valid=valid)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out), key_valid=valid)
    check(bool((out[1] == 0).all()) and bool((ref[1] == 0).all()) and bool(torch.isfinite(lse).all())
          and all(bool(torch.isfinite(g).all()) and bool((g[1] == 0).all()) for g in grads)
          and (out[0].float() - ref[0].float()).abs().max().item() <= TOL["bfloat16"],
          "flash kernels: a sample with no valid key gives zero rows, a finite lse and zero gradients")
    # rows 8 bytes past a 16-byte boundary: no tensor map can read them, so the call
    # raises and nothing launches (no other body takes them)
    x = torch.zeros(2, 520, 3 * 4 * 64 + 4, device="cuda", dtype=torch.bfloat16)
    q, k, v = x[..., :3 * 4 * 64].unflatten(-1, (3, 4, 64)).unbind(2)
    before = dict(fa.LAUNCHES)
    try:
        fa.flash_attention_fwd(q, k, v)
        raised = False
    except ValueError:
        raised = True
    check(raised and fa.LAUNCHES == before,
          "flash forward: misaligned rows raise, nothing launched")
    return records


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES.items():
        if any(k in low for k in keys):
            return cls
    return "other"


def profile_summary(prof, wall_ms: float, n: int, unit: str = "request") -> dict:
    """Device time per request (or step) by kernel class and the device's idle share,
    from the profiler's kernel rows (an operator's row repeats its kernels' time)."""
    from torch.autograd import DeviceType

    def device_ms(evt):
        us = getattr(evt, "self_device_time_total", None)
        return (getattr(evt, "self_cuda_time_total", 0.0) if us is None else us) / 1e3

    kernels = [(e.key, device_ms(e), e.count) for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and device_ms(e) > 0
               and not getattr(e, "is_user_annotation", False)]  # a range's span is no kernel
    busy_ms = sum(ms for _, ms, _ in kernels)
    by_class, launches = {}, {}
    for name, ms, count in kernels:
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        launches[cls] = launches.get(cls, 0) + count
    top = sorted(kernels, key=lambda k: -k[1])[:15]
    return {
        f"{unit}s": n, f"wall_ms_per_{unit}": wall_ms / n,
        f"device_busy_ms_per_{unit}": busy_ms / n,
        f"kernel_launches_per_{unit}": sum(launches.values()) / n,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        f"class_ms_per_{unit}": {c: ms / n for c, ms in sorted(by_class.items(), key=lambda x: -x[1])},
        "ms_per_launch": {c: by_class[c] / launches[c] for c in
                          ("switchback", "switchback_quantize", "short_attention",
                           "short_attention_bwd", "layer_norm_bwd",
                           "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                           "window_attention", "window_attention_bwd")
                          if c in by_class},
        "top_kernels": [{"name": k[:120], "class": kernel_class(k), f"ms_per_{unit}": ms / n,
                         f"launches_per_{unit}": c / n} for k, ms, c in top]}


def serve_window(request, profiled: int):
    """Requests one at a time for at least WINDOW_S (latency in ms, from request(1)
    on), then ``profiled`` more under torch.profiler, which records the card's kernels
    alone: CPU events would add host time to every op and so to the idle share. Returns the latencies, the window's seconds, the last request's
    output, the profiler and its wall ms."""
    from torch.profiler import ProfilerActivity, profile

    lat = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < WINDOW_S:
        t0 = time.perf_counter()
        feats, top5 = request(len(lat) + 1)
        lat.append((time.perf_counter() - t0) * 1e3)
    window_s = time.perf_counter() - t_start
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(profiled):
            request(i)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    return lat, window_s, feats, top5, prof, prof_wall_ms


@contextlib.contextmanager
def body_patched(wa, which: str, body: str):
    """While open, the window and panel kernels of ``which`` ("fwd_body" or
    "bwd_body") take ``body`` at every shape."""
    body_of = getattr(wa, which)
    setattr(wa, which, lambda mode, n, hd, dtype: body)
    try:
        yield
    finally:
        setattr(wa, which, body_of)


def phase_serve(torch, oc, sa):
    """The main path. Returns the kernel's measured launches per tower and the
    number of encode_text and encode_image calls that made them."""
    from torch.profiler import ProfilerActivity, profile

    model, _, preprocess = oc.create_model_and_transforms("ViT-B-32", precision="pure_bf16", seed=0)
    tokenizer = oc.get_tokenizer("ViT-B-32")
    layers_v = model.cfg.vision_cfg.layers
    layers_t = model.cfg.text_cfg.layers
    classnames = oc.IMAGENET_CLASSNAMES[:CLASSES]
    gen = torch.Generator(device="cuda").manual_seed(0)
    requests = [torch.randint(0, 256, (BATCH, *IMAGE_HW, 3), dtype=torch.uint8, device="cuda",
                              generator=gen) for _ in range(DISTINCT_REQUESTS)]
    with torch.inference_mode():
        reset_counts(sa)
        clf = oc.build_zero_shot_classifier(model, tokenizer, classnames,
                                            oc.SIMPLE_IMAGENET_TEMPLATES,
                                            num_classes_per_batch=CLASSES)
        torch.cuda.synchronize()
        text_launches, text_calls = sa.LAUNCHES["fwd"], 1
        clf32 = clf.float()

        def request(i, events=None):
            """One request, answered when its top-5 reaches the host."""
            mark = (lambda j: events[j].record()) if events else (lambda j: None)
            mark(0)
            pixels = preprocess(requests[i % DISTINCT_REQUESTS])
            mark(1)
            feats = model.encode_image(pixels, normalize=True)
            mark(2)
            top5 = (100.0 * feats.float() @ clf32).topk(5, dim=-1).indices
            mark(3)
            return feats, top5.cpu()  # waits for the device: one request in flight

        t0 = time.perf_counter()
        request(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        lat, phase_ms = [], {n: [] for n in PHASES}
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < WINDOW_S:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(PHASES) + 1)]
            t0 = time.perf_counter()
            feats, top5 = request(len(lat) + 1, ev)
            lat.append((time.perf_counter() - t0) * 1e3)
            for j, n in enumerate(PHASES):
                phase_ms[n].append(ev[j].elapsed_time(ev[j + 1]))
        window_s = time.perf_counter() - t_start

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(PROFILED_REQUESTS):
                request(i)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        image_calls = 1 + len(lat) + PROFILED_REQUESTS
        vision_launches = sa.LAUNCHES["fwd"] - text_launches

    check(text_launches == layers_t * text_calls,
          f"classifier: {text_launches} kernel launches for {text_calls} encode_text call "
          f"(expect {layers_t * text_calls})")
    norms = torch.linalg.vector_norm(clf32, dim=0)
    check(tuple(clf.shape) == (model.cfg.embed_dim, CLASSES) and bool(torch.isfinite(clf).all())
          and bool(((norms - 1).abs() < 1e-3).all()),
          f"classifier shape {tuple(clf.shape)}, finite, unit columns")
    check(vision_launches == layers_v * image_calls,
          f"requests: {vision_launches} kernel launches for {image_calls} encode_image calls "
          f"(expect {layers_v * image_calls})")
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(tuple(feats.shape) == (BATCH, model.cfg.embed_dim) and bool(torch.isfinite(feats).all())
          and bool(((fn - 1).abs() < 1e-2).all()) and tuple(top5.shape) == (BATCH, 5)
          and int(top5.min()) >= 0 and int(top5.max()) < CLASSES,
          f"request output: features {tuple(feats.shape)} finite and unit, top-5 {tuple(top5.shape)}")
    print("serve " + json.dumps({
        "model": "ViT-B-32", "precision": "pure_bf16", "batch": BATCH, "image_hw": list(IMAGE_HW),
        "first_request_ms": first_ms, "window_s": window_s, "window_requests": len(lat),
        "images_per_s": BATCH * len(lat) / window_s,
        "median_request_ms": statistics.median(lat), "min_request_ms": min(lat),
        "max_request_ms": max(lat),
        "device_ms_median": {n: statistics.median(v) for n, v in phase_ms.items()},
        "text_launches": text_launches, "vision_launches": vision_launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    summary = profile_summary(prof, prof_wall_ms, PROFILED_REQUESTS)
    print("profile " + json.dumps(summary), flush=True)
    if summary["device_idle_share"] is None:
        print("profile: the profiler recorded no device time", flush=True)
    return {"text": text_launches, "vision": vision_launches}, {"text": text_calls,
                                                               "vision": image_calls}


def phase_card_vs_cpu(torch, oc, sa):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = oc.create_model("ViT-B-32", precision="fp32", seed=1)
    cpu = oc.create_model("ViT-B-32", precision="fp32", seed=1, device="cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (4, *IMAGE_HW, 3), dtype=torch.uint8, generator=gen)
    texts = oc.get_tokenizer("ViT-B-32")(["a photo of a cat.", "a diagram", "²½ café 日本", ""])
    pp = oc.make_device_preprocess(cpu.preprocess_cfg)
    with torch.inference_mode():
        reset_counts(sa)
        fi_g = gpu.encode_image(pp(images.cuda()), normalize=True).cpu()
        ft_g = gpu.encode_text(texts, normalize=True).cpu()
        launched = sa.LAUNCHES["fwd"]
        fi_c = cpu.encode_image(pp(images), normalize=True)
        ft_c = cpu.encode_text(texts, normalize=True)
    check(launched == gpu.cfg.vision_cfg.layers + gpu.cfg.text_cfg.layers,
          f"fp32 card run launched the kernel {launched} times")
    for name, a, b in (("encode_image", fi_g, fi_c), ("encode_text", ft_g, ft_c)):
        cos = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()
        check(bool(torch.isfinite(a).all()) and cos >= COSINE_MIN,
              f"{name} card vs CPU fp32: min cosine {cos:.7f} (>= {COSINE_MIN})")


def train_batch(torch, cfg, n, device, seed=0):
    """One fixed batch: random-normal images and random token ids from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    size = cfg.vision_cfg.image_size
    return {"image": torch.randn(n, size, size, 3, generator=gen, device=device),
            "text": torch.randint(0, cfg.text_cfg.vocab_size - 1, (n, cfg.text_cfg.context_length),
                                  generator=gen, device=device)}


def run_steps(torch, step, state, batch, n):
    """n steps with nothing waiting for the device between them; returns the state,
    each step's metrics, its device ms (CUDA events), the host's ms to queue it, the
    ms the device still ran after the host had queued the last step (the host's
    lead: near 0 where the host sets the pace), and the wall seconds of all n."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    metrics, host_ms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n):
        t1 = time.perf_counter()
        state, m = step(state, batch)
        events[i + 1].record()
        host_ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append(m)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n)]
    return state, metrics, step_ms, host_ms, (t2 - t1) * 1e3, t2 - t0


def profiled_steps(torch, step, state, batch):
    """TRAIN_PROFILED_STEPS steps under torch.profiler, after one profiled warm-up step.
    Returns the state and the steps' profile summary (kernel ms a step, by class)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        state = run_steps(torch, step, state, batch, 1)[0]  # the profiler's own warm-up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, *_, prof_wall_s = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)
    return state, profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")


def phase_train(torch, oc, sa, fl, layers_mod, fused_ln: bool):
    """The training main path through the library surface. Returns the launches of
    each kernel by tower over the timed window, the window's steps and a summary."""
    from torch.profiler import ProfilerActivity, profile

    label = "train[fused_ln]" if fused_ln else "train"
    layers_mod.FUSED_LN_BWD = fused_ln
    try:
        torch.cuda.reset_peak_memory_stats()
        model = oc.create_model("ViT-B-32", precision="amp_bf16", seed=0)
        lv, lt = model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers
        optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                        model, oc.const_lr(5e-4, 0))
        state = oc.create_train_state(model, optimizer)
        step = oc.make_train_step(model.cfg, optimizer)
        batch = train_batch(torch, model.cfg, BATCH, "cuda")
        state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
        n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
        reset_counts(sa, fl)
        with tally_by_shape(sa, fl) as tally:
            state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
        counts = {"fwd": sa.LAUNCHES["fwd"], "bwd": sa.LAUNCHES["bwd"], "ln": fl.LAUNCHES["bwd"]}
        bodies, fwd_bodies = dict(sa.BWD_BODIES), dict(sa.FWD_BODIES)
        losses = [float(m["loss"]) for m in warm + window]
        norms = [float(m["grad_norm"]) for m in warm + window]
        scale = float(window[-1]["logit_scale"])
        check(all(math.isfinite(x) for x in losses), f"{label}: {len(losses)} losses finite")
        check(losses[-1] < losses[0], f"{label}: loss fell on the fixed batch, "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps")
        check(all(math.isfinite(x) and x > 0 for x in norms), f"{label}: grad_norm finite, positive")
        check(scale <= 100.0 + 1e-3, f"{label}: logit_scale {scale:.3f} <= 100")
        check(counts["fwd"] == (lv + lt) * n and counts["bwd"] == (lv + lt) * n,
              f"{label}: {counts['fwd']} forward and {counts['bwd']} backward attention launches "
              f"in {n} steps (expect {(lv + lt) * n} each)")
        check(tally.get(("fwd", "vision"), 0) == lv * n and tally.get(("bwd", "vision"), 0) == lv * n
              and tally.get(("fwd", "text"), 0) == lt * n and tally.get(("bwd", "text"), 0) == lt * n,
              f"{label}: per tower and step {lv} vision and {lt} text launches of each kernel")
        check(bodies == {"mma": (lv + lt) * n, "simt": 0} and fwd_bodies == bodies,
              f"{label}: short-attention launches by body, forward {fwd_bodies}, backward "
              f"{bodies} in {n} steps (expect all {(lv + lt) * n} of each on the tensor cores)")
        ln_expect = (2 * lv + 2 + 2 * lt + 1) * n if fused_ln else 0
        check(counts["ln"] == ln_expect,
              f"{label}: {counts['ln']} LayerNorm backward launches in {n} steps (expect {ln_expect})")
        with profile(activities=[ProfilerActivity.CUDA]):
            state = run_steps(torch, step, state, batch, 1)[0]  # the profiler's own warm-up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, *_, prof_wall_s = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)
        prof_summary = profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")
        print(f"{label.replace('train', 'train_profile')} " + json.dumps(prof_summary), flush=True)
        # kernel ms: the device-busy time of the profiled steps (the sum of their kernels)
        summary = {"model": "ViT-B-32", "precision": "amp_bf16", "batch": BATCH,
                   "fused_ln_bwd": fused_ln, "window_steps": n, "window_s": wall_s,
                   "images_per_s": BATCH * n / wall_s, "median_step_ms": statistics.median(step_ms),
                   "kernel_ms_per_step": prof_summary["device_busy_ms_per_step"],
                   "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
                   "median_host_ms_per_step": statistics.median(host_ms),
                   "host_lead_ms_at_end": lead_ms,
                   "first_loss": losses[0], "last_loss": losses[-1], "logit_scale": scale,
                   "launches_per_step": {k: v / n for k, v in counts.items()},
                   "short_fwd_launches_per_step_by_body": {k: v / n for k, v in fwd_bodies.items()},
                   "short_bwd_launches_per_step_by_body": {k: v / n for k, v in bodies.items()},
                   "device_busy_ms_per_step": prof_summary["device_busy_ms_per_step"]}
        if not fused_ln:
            # remat: every block's forward runs again in the backward pass
            remat_step = oc.make_train_step(model.cfg, optimizer, remat=True)
            reset_counts(sa, fl)
            state, rm, remat_ms, *_ = run_steps(torch, remat_step, state, batch, 2)
            check(sa.LAUNCHES == {"fwd": 2 * (lv + lt) * 2, "bwd": (lv + lt) * 2}
                  and math.isfinite(float(rm[-1]["loss"])),
                  f"train[remat]: launches {sa.LAUNCHES} in 2 steps, loss finite")
            summary["remat_median_step_ms"] = statistics.median(remat_ms)
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print("train " + json.dumps(summary), flush=True)
        return tally, n, summary
    finally:
        layers_mod.FUSED_LN_BWD = False


def phase_cli(torch):
    """The training CLI: one epoch of synthetic data, then a second through --resume."""
    from open_clip_tpu_torch.train.main import main as train_main

    with tempfile.TemporaryDirectory() as logs:
        args = ["--model", "ViT-B-32", "--dataset-type", "synthetic", "--batch-size", str(BATCH),
                "--train-num-samples", str(BATCH * CLI_STEPS_PER_EPOCH), "--precision", "amp_bf16",
                "--grad-clip-norm", "1.0", "--lr", "5e-4", "--wd", "0.2", "--warmup", "4",
                "--log-every-n-steps", "4", "--workers", "1", "--logs", logs, "--name", "smoke"]
        run = Path(logs) / "smoke"
        t0 = time.perf_counter()
        state = train_main(args + ["--epochs", "1"])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        rows = [json.loads(x) for x in (run / "results.jsonl").read_text().splitlines()]
        check(state.step == CLI_STEPS_PER_EPOCH, f"CLI: {state.step} steps in the first epoch")
        check(bool(rows) and all(math.isfinite(r["train/loss"])
                                 and abs(r["train/loss"] - math.log(BATCH)) < 1e-2 for r in rows),
              f"CLI: loss {[round(r['train/loss'], 4) for r in rows]} is ln {BATCH} on identical samples")
        check((run / "checkpoints" / "epoch_1.pt").exists() and (run / "params.txt").exists(),
              "CLI: checkpoint epoch_1.pt and params.txt written")
        state = train_main(args + ["--epochs", "2", "--resume", "latest"])
        torch.cuda.synchronize()
        rows2 = [json.loads(x) for x in (run / "results.jsonl").read_text().splitlines()][len(rows):]
        check(state.step == 2 * CLI_STEPS_PER_EPOCH and bool(rows2)
              and rows2[0]["step"] == CLI_STEPS_PER_EPOCH + 1
              and (run / "checkpoints" / "epoch_2.pt").exists(),
              f"CLI: --resume latest went on from step {CLI_STEPS_PER_EPOCH} to {state.step}")
        last = rows2[-1] if rows2 else {}
        batch_ms = 1e3 * last.get("train/batch_time", float("nan"))
        print("cli " + json.dumps({
            "steps_per_epoch": CLI_STEPS_PER_EPOCH, "first_run_s": first_s,
            "host_data_ms_per_step": 1e3 * last.get("train/data_time", float("nan")),
            "host_batch_ms_per_step": 1e3 * last.get("train/batch_time", float("nan")),
            "images_per_s": BATCH / last["train/batch_time"] if last.get("train/batch_time") else None,
            "averaged_over_steps": (last.get("step", 0) - CLI_STEPS_PER_EPOCH - 1) or None}),
            flush=True)
        return batch_ms


def phase_train_card_vs_cpu(torch, oc, sa):
    """One fp32 train step (TF32 off) from the same seed on the card and on the CPU."""
    from open_clip_tpu_torch.loss import clip_loss
    from open_clip_tpu_torch.models.clip import clip_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for device in ("cuda", "cpu"):
        model = oc.create_model("ViT-B-32", precision="fp32", seed=2, device=device)
        batch = {k: v.to(device) for k, v in train_batch(torch, model.cfg, 8, "cpu", seed=2).items()}
        out = clip_forward(model, batch["image"], batch["text"], train=True)
        clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp()).backward()
        grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                        model, oc.const_lr(5e-4, 0))
        state = oc.create_train_state(model, optimizer)
        reset_counts(sa)
        state, m = oc.make_train_step(model.cfg, optimizer)(state, batch)
        results[device] = (grads, float(m["loss"]), float(m["grad_norm"]),
                           (dict(sa.LAUNCHES), dict(sa.BWD_BODIES), dict(sa.FWD_BODIES)))
    (g_gpu, loss_g, norm_g, launched), (g_cpu, loss_c, norm_c, _) = results["cuda"], results["cpu"]
    check(launched == ({"fwd": 24, "bwd": 24}, {"mma": 0, "simt": 24}, {"mma": 0, "simt": 24}),
          f"fp32 card train step launched {launched[0]}, backward by body {launched[1]}, "
          f"forward by body {launched[2]} (fp32 takes the CUDA-core bodies)")
    simt_launches = launched[1]["simt"]
    check(abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) and abs(norm_g - norm_c) <= 1e-3 * norm_c,
          f"train step card vs CPU fp32: loss {loss_g:.6f} vs {loss_c:.6f} (rel 1e-4), "
          f"grad_norm {norm_g:.6f} vs {norm_c:.6f} (rel 1e-3)")
    cos = {k: torch.nn.functional.cosine_similarity(g_gpu[k].flatten(), g_cpu[k].flatten(), dim=0).item()
           for k in g_cpu}
    worst = min(cos, key=cos.get)
    check(all(bool(torch.isfinite(g).all()) for g in g_gpu.values()) and cos[worst] >= COSINE_MIN,
          f"gradients card vs CPU fp32: min cosine {cos[worst]:.7f} at {worst} "
          f"over {len(cos)} tensors (>= {COSINE_MIN})")
    return simt_launches


def naflex_batch(torch, n, seq_len, grids, device, seed=0, vocab=49408, context=77):
    """One fixed NaFlex train batch: sample i has the grid grids[i % len(grids)] of
    N(0, 1) patches from a seed, padded with zeros to seq_len, and random token ids."""
    gen = torch.Generator(device=device).manual_seed(seed)
    patches = torch.zeros(n, seq_len, 768, device=device)
    coords = torch.zeros(n, seq_len, 2, dtype=torch.int32, device=device)
    valid = torch.zeros(n, seq_len, dtype=torch.bool, device=device)
    for i in range(n):
        gh, gw = grids[i % len(grids)]
        m = gh * gw
        patches[i, :m] = torch.randn(m, 768, generator=gen, device=device)
        ys, xs = torch.meshgrid(torch.arange(gh, device=device), torch.arange(gw, device=device),
                                indexing="ij")
        coords[i, :m] = torch.stack([ys.reshape(-1), xs.reshape(-1)], dim=-1).to(torch.int32)
        valid[i, :m] = True
    text = torch.randint(0, vocab - 1, (n, context), generator=gen, device=device)
    return {"image": {"patches": patches, "patch_coord": coords, "patch_valid": valid},
            "text": text}


def phase_naflex_serve(torch, oc, sa, fa):
    """NaFlex serving main path; returns the flash forward launches and the
    encode_image calls that made them."""
    from torch.profiler import ProfilerActivity, profile

    from open_clip_tpu_torch.data.naflex import NaFlexTransform

    torch.cuda.reset_peak_memory_stats()
    model, _, _ = oc.create_model_and_transforms(NAFLEX_MODEL, precision="pure_bf16", seed=0)
    tokenizer = oc.get_tokenizer(NAFLEX_MODEL)
    layers_t = model.cfg.text_cfg.layers
    layers_v = model.visual.cfg.layers
    transform = NaFlexTransform(NF_SERVE_SEQ, model.visual.cfg.patch_size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    requests = [torch.randint(0, 256, (NF_SERVE_BATCH, *NF_IMAGE_HW, 3), dtype=torch.uint8,
                              device="cuda", generator=gen) for _ in range(DISTINCT_REQUESTS)]
    phases = ("naflex_transform", "encode_image", "logits_top5")
    with torch.inference_mode():
        reset_counts(sa, fa)
        clf = oc.build_zero_shot_classifier(model, tokenizer, oc.IMAGENET_CLASSNAMES[:CLASSES],
                                            oc.SIMPLE_IMAGENET_TEMPLATES,
                                            num_classes_per_batch=CLASSES)
        torch.cuda.synchronize()
        text_launches = sa.LAUNCHES["fwd"]
        clf32 = clf.float()

        def request(i, events=None):
            mark = (lambda j: events[j].record()) if events else (lambda j: None)
            mark(0)
            patches = transform(requests[i % DISTINCT_REQUESTS])
            mark(1)
            feats = model.encode_image(patches, normalize=True)
            mark(2)
            top5 = (100.0 * feats.float() @ clf32).topk(5, dim=-1).indices
            mark(3)
            return patches, feats, top5.cpu()  # waits for the device: one request in flight

        t0 = time.perf_counter()
        request(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        lat, phase_ms = [], {n: [] for n in phases}
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < WINDOW_S:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(phases) + 1)]
            t0 = time.perf_counter()
            patches, feats, top5 = request(len(lat) + 1, ev)
            lat.append((time.perf_counter() - t0) * 1e3)
            for j, n in enumerate(phases):
                phase_ms[n].append(ev[j].elapsed_time(ev[j + 1]))
        window_s = time.perf_counter() - t_start
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(PROFILED_REQUESTS):
                request(i)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        image_calls = 1 + len(lat) + PROFILED_REQUESTS

    n_valid = patches["patch_valid"].sum(dim=1)
    check(tuple(patches["patches"].shape) == (NF_SERVE_BATCH, NF_SERVE_SEQ, 768)
          and bool((n_valid == 540).all()),
          f"NaFlex transform: patches {tuple(patches['patches'].shape)}, "
          f"{int(n_valid[0])} valid of {NF_SERVE_SEQ} (a 20x27 grid)")
    check(text_launches == layers_t and sa.LAUNCHES["fwd"] == layers_t,
          f"NaFlex classifier: {text_launches} short-kernel launches for 1 encode_text call")
    check(fa.LAUNCHES == {"fwd": layers_v * image_calls, "bwd_dq": 0, "bwd_dkv": 0}
          and fa.FWD_BODIES == {"wgmma": layers_v * image_calls, "simt": 0},
          f"NaFlex requests: flash launches {fa.LAUNCHES}, forward by body {fa.FWD_BODIES} for "
          f"{image_calls} encode_image calls (expect {layers_v * image_calls} wgmma forwards, "
          f"no backward)")
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(tuple(feats.shape) == (NF_SERVE_BATCH, model.cfg.embed_dim)
          and bool(torch.isfinite(feats).all()) and bool(((fn - 1).abs() < 1e-2).all())
          and tuple(top5.shape) == (NF_SERVE_BATCH, 5) and int(top5.min()) >= 0
          and int(top5.max()) < CLASSES,
          f"NaFlex request output: features {tuple(feats.shape)} finite and unit, "
          f"top-5 {tuple(top5.shape)}")
    print("naflex_serve " + json.dumps({
        "model": NAFLEX_MODEL, "precision": "pure_bf16", "batch": NF_SERVE_BATCH,
        "image_hw": list(NF_IMAGE_HW), "seq_len": NF_SERVE_SEQ, "valid_patches": int(n_valid[0]),
        "first_request_ms": first_ms, "window_s": window_s, "window_requests": len(lat),
        "images_per_s": NF_SERVE_BATCH * len(lat) / window_s,
        "median_request_ms": statistics.median(lat), "min_request_ms": min(lat),
        "max_request_ms": max(lat),
        "device_ms_median": {n: statistics.median(v) for n, v in phase_ms.items()},
        "flash_fwd_launches": fa.LAUNCHES["fwd"], "flash_fwd_bodies": dict(fa.FWD_BODIES),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    print("naflex_profile " + json.dumps(profile_summary(prof, prof_wall_ms, PROFILED_REQUESTS)),
          flush=True)
    return fa.LAUNCHES["fwd"], image_calls


def phase_naflex_train(torch, oc, sa, fa):
    """NaFlex training main path; returns the flash launches of the timed window and
    its steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    model = oc.create_model(NAFLEX_MODEL, precision="amp_bf16", seed=0)
    lv, lt = model.visual.cfg.layers, model.cfg.text_cfg.layers
    # lr 1e-4: with no warm-up, 5e-4 first drives the loss of this 16-sample batch up
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-4, wd=0.2, grad_clip_norm=1.0),
                                    model, oc.const_lr(1e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer)
    batch = naflex_batch(torch, NF_TRAIN_BATCH, NF_TRAIN_SEQ, ((32, 32), (24, 32)), "cuda")
    state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
    n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
    reset_counts(sa, fa)
    state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
    flash, short, flash_bodies = dict(fa.LAUNCHES), dict(sa.LAUNCHES), dict(fa.FWD_BODIES)
    flash_bwd_bodies = dict(fa.BWD_BODIES)
    losses = [float(m["loss"]) for m in warm + window]
    norms = [float(m["grad_norm"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses), f"naflex_train: {len(losses)} losses finite")
    check(losses[-1] < losses[0], f"naflex_train: loss fell on the fixed batch, "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps")
    check(all(math.isfinite(x) and x > 0 for x in norms), "naflex_train: grad_norm finite, positive")
    check(flash == {"fwd": lv * n, "bwd_dq": lv * n, "bwd_dkv": lv * n}
          and flash_bodies == {"wgmma": lv * n, "simt": 0},
          f"naflex_train: flash launches {flash}, forward by body {flash_bodies} in {n} steps "
          f"(expect {lv * n} of each, every forward wgmma)")
    check(flash_bwd_bodies == {"wgmma": lv * n, "simt": 0},
          f"naflex_train: flash backward passes by body {flash_bwd_bodies} in {n} steps (expect "
          f"{lv * n}, each a wgmma dq and a wgmma dk/dv launch)")
    check(short == {"fwd": lt * n, "bwd": lt * n},
          f"naflex_train: short-kernel launches {short} in {n} steps (the text tower: "
          f"{lt * n} of each)")
    summary = {"model": NAFLEX_MODEL, "precision": "amp_bf16", "batch": NF_TRAIN_BATCH,
               "seq_len": NF_TRAIN_SEQ, "window_steps": n, "window_s": wall_s,
               "image_tokens_per_s": NF_TRAIN_BATCH * NF_TRAIN_SEQ * n / wall_s,
               "images_per_s": NF_TRAIN_BATCH * n / wall_s,
               "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
               "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
               "host_lead_ms_at_end": lead_ms, "first_loss": losses[0], "last_loss": losses[-1],
               "flash_launches_per_step": {k: v / n for k, v in flash.items()},
               "flash_fwd_launches_per_step_by_body": {k: v / n for k, v in flash_bodies.items()},
               "flash_bwd_passes_per_step_by_body": {k: v / n for k, v in flash_bwd_bodies.items()},
               "short_launches_per_step": {k: v / n for k, v in short.items()}}
    with profile(activities=[ProfilerActivity.CUDA]):
        state = run_steps(torch, step, state, batch, 1)[0]  # the profiler's own warm-up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, *_, prof_wall_s = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)
    prof_summary = profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")
    print("naflex_train_profile " + json.dumps(prof_summary), flush=True)
    summary["device_busy_ms_per_step"] = prof_summary["device_busy_ms_per_step"]
    # remat: the key-padding mask goes through torch's checkpoint with each block
    remat_step = oc.make_train_step(model.cfg, optimizer, remat=True)
    reset_counts(sa, fa)
    state, rm, remat_ms, *_ = run_steps(torch, remat_step, state, batch, 2)
    check(fa.LAUNCHES == {"fwd": 2 * lv * 2, "bwd_dq": lv * 2, "bwd_dkv": lv * 2}
          and fa.FWD_BODIES == {"wgmma": 2 * lv * 2, "simt": 0}
          and fa.BWD_BODIES == {"wgmma": lv * 2, "simt": 0}
          and math.isfinite(float(rm[-1]["loss"])),
          f"naflex_train[remat]: flash launches {fa.LAUNCHES} in 2 steps, loss finite")
    summary["remat_median_step_ms"] = statistics.median(remat_ms)
    summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print("naflex_train " + json.dumps(summary), flush=True)
    return flash, n


def phase_naflex_cli(torch, fa):
    """The training CLI on token-budget NaFlex batches: one short epoch."""
    from open_clip_tpu_torch.train.main import main as train_main

    with tempfile.TemporaryDirectory() as logs:
        args = ["--model", NAFLEX_MODEL, "--dataset-type", "synthetic-naflex",
                "--naflex-seq-lens", str(NF_TRAIN_SEQ), "--naflex-max-tokens",
                str(NF_TRAIN_BATCH * NF_TRAIN_SEQ), "--batch-size", str(NF_TRAIN_BATCH),
                "--train-num-samples", str(NF_TRAIN_BATCH * NF_CLI_STEPS),
                "--precision", "amp_bf16", "--grad-clip-norm", "1.0", "--lr", "5e-4", "--wd", "0.2",
                "--warmup", "4", "--log-every-n-steps", "4", "--workers", "1", "--epochs", "1",
                "--logs", logs, "--name", "naflex"]
        run = Path(logs) / "naflex"
        reset_counts(fa)
        t0 = time.perf_counter()
        state = train_main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        rows = [json.loads(x) for x in (run / "results.jsonl").read_text().splitlines()]
        layers = state.model.visual.cfg.layers
        check(state.step == NF_CLI_STEPS, f"NaFlex CLI: {state.step} steps in the epoch "
              f"(batch {NF_TRAIN_BATCH} from the token budget)")
        check(bool(rows) and all(math.isfinite(r["train/loss"])
                                 and abs(r["train/loss"] - math.log(NF_TRAIN_BATCH)) < 1e-2
                                 for r in rows),
              f"NaFlex CLI: loss {[round(r['train/loss'], 4) for r in rows]} is ln "
              f"{NF_TRAIN_BATCH} on identical samples")
        check(fa.LAUNCHES == {k: layers * NF_CLI_STEPS for k in fa.LAUNCHES}
              and fa.FWD_BODIES == {"wgmma": layers * NF_CLI_STEPS, "simt": 0}
              and fa.BWD_BODIES == {"wgmma": layers * NF_CLI_STEPS, "simt": 0},
              f"NaFlex CLI: flash launches {fa.LAUNCHES}, forward by body {fa.FWD_BODIES}, "
              f"backward by body {fa.BWD_BODIES} in {NF_CLI_STEPS} steps")
        check((run / "checkpoints" / "epoch_1.pt").exists(), "NaFlex CLI: checkpoint epoch_1.pt written")
        last = rows[-1] if rows else {}
        print("naflex_cli " + json.dumps({
            "steps": NF_CLI_STEPS, "run_s": wall_s, "flash_fwd_bodies": dict(fa.FWD_BODIES),
            "flash_bwd_bodies": dict(fa.BWD_BODIES),
            "host_data_ms_per_step": 1e3 * last.get("train/data_time", float("nan")),
            "host_batch_ms_per_step": 1e3 * last.get("train/batch_time", float("nan"))}), flush=True)


def phase_naflex_card_vs_cpu(torch, oc, sa, fa):
    """fp32, TF32 off: NaFlex image features and one train step, card against CPU."""
    from open_clip_tpu_torch.data.naflex import NaFlexTransform, collate_naflex
    from open_clip_tpu_torch.loss import clip_loss
    from open_clip_tpu_torch.models.clip import clip_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    transform = NaFlexTransform(NF_SERVE_SEQ, 16)
    images = [torch.randint(0, 256, (h, w, 3), dtype=torch.uint8, generator=gen)
              for h, w in ((384, 512), (300, 500), (512, 384), (224, 224))]
    dicts = collate_naflex([transform(im) for im in images])
    n_valid = dicts["patch_valid"].sum(dim=1).tolist()
    train = naflex_batch(torch, 4, 512, ((16, 32), (16, 24)), "cpu", seed=5)
    results = {}
    for device in ("cuda", "cpu"):
        model = oc.create_model(NAFLEX_MODEL, precision="fp32", seed=3, device=device)
        reset_counts(sa, fa)
        with torch.inference_mode():
            feats = model.encode_image({k: v.to(device) for k, v in dicts.items()},
                                       normalize=True).cpu()
        serve_launches = dict(fa.LAUNCHES)
        batch = {"image": {k: v.to(device) for k, v in train["image"].items()},
                 "text": train["text"].to(device)}
        out = clip_forward(model, batch["image"], batch["text"], train=True)
        clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp()).backward()
        grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                        model, oc.const_lr(5e-4, 0))
        state = oc.create_train_state(model, optimizer)
        reset_counts(sa, fa)
        state, m = oc.make_train_step(model.cfg, optimizer)(state, batch)
        results[device] = (feats, grads, float(m["loss"]), float(m["grad_norm"]), serve_launches,
                           dict(fa.LAUNCHES), dict(sa.LAUNCHES))
        del model, state, optimizer
    (f_g, g_gpu, loss_g, norm_g, served, flash, short) = results["cuda"]
    (f_c, g_cpu, loss_c, norm_c, *_) = results["cpu"]
    check(served == {"fwd": 12, "bwd_dq": 0, "bwd_dkv": 0} and flash == {"fwd": 12, "bwd_dq": 12,
          "bwd_dkv": 12} and short == {"fwd": 12, "bwd": 12},
          f"NaFlex fp32 card run: flash {served} serving, {flash} and short {short} in the step")
    cos = torch.nn.functional.cosine_similarity(f_g.double(), f_c.double(), dim=-1).min().item()
    check(bool(torch.isfinite(f_g).all()) and cos >= COSINE_MIN,
          f"NaFlex encode_image card vs CPU fp32 (valid patches {n_valid} of {NF_SERVE_SEQ}): "
          f"min cosine {cos:.7f} (>= {COSINE_MIN})")
    check(abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) and abs(norm_g - norm_c) <= 1e-3 * norm_c,
          f"NaFlex train step card vs CPU fp32: loss {loss_g:.6f} vs {loss_c:.6f} (rel 1e-4), "
          f"grad_norm {norm_g:.6f} vs {norm_c:.6f} (rel 1e-3)")
    cosg = {k: torch.nn.functional.cosine_similarity(g_gpu[k].flatten(), g_cpu[k].flatten(),
                                                     dim=0).item() for k in g_cpu}
    worst = min(cosg, key=cosg.get)
    check(all(bool(torch.isfinite(g).all()) for g in g_gpu.values()) and cosg[worst] >= COSINE_MIN,
          f"NaFlex gradients card vs CPU fp32: min cosine {cosg[worst]:.7f} at {worst} "
          f"over {len(cosg)} tensors (>= {COSINE_MIN})")


def window_inputs(torch, lead, c, nw, heads, n, dtype, gen):
    """q, k, v as views of one fused (..., 3C) projection (row stride 3C), an fp32 bias
    with -100 shift-mask entries, and do."""
    x = torch.randn(*lead, 3 * c, generator=gen, device="cuda").to(dtype)
    q, k, v = x.unflatten(-1, (3, c)).unbind(-2)
    bias = torch.randn(nw, heads, n, n, generator=gen, device="cuda")
    bias[..., 1::4, ::3] -= 100.0
    do = torch.randn(*lead, c, generator=gen, device="cuda").to(dtype)
    return q, k, v, bias, do


def phase_window_kernels(torch, wa, swa):
    """Window and panel attention kernels (forward; backward with dq, dk, dv, dbias)
    against their plain versions, bf16 and fp32; device time from CUDA graphs of calls;
    records for the kernels line. Library: SDPA with the float bias as attn_mask on
    partitioned (windows, nW*H, N, hd) tensors (backward = forward+backward less
    forward, without dbias); for the panel form the partition and reverse copies are
    timed with it, and alone."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    b_s, b_t, b_w = CLAP_SERVE_BATCH, CLAP_TRAIN_BATCH, SWIN_SERVE_BATCH
    # name, kind, batch (samples, or windows for "window"), map (H, W) or N, C, heads, nW
    cases = [("htsat_s0_shift_serve", "panel", b_s, (64, 64), 96, 4, 64),
             ("htsat_s0_serve", "panel", b_s, (64, 64), 96, 4, 1),
             ("htsat_s3_serve", "panel", b_s, (8, 8), 768, 32, 1),
             ("htsat_s0_shift_train", "panel", b_t, (64, 64), 96, 4, 64),
             ("htsat_s0_train", "panel", b_t, (64, 64), 96, 4, 1),
             ("htsat_s1_shift_train", "panel", b_t, (32, 32), 192, 8, 16),
             ("htsat_s2_shift_train", "panel", b_t, (16, 16), 384, 16, 4),
             ("htsat_s3_train", "panel", b_t, (8, 8), 768, 32, 1),
             ("nonsquare_odd_heads", "panel", 8, (16, 40), 48, 3, 10),
             ("swin_s0_shift", "window", b_w * 64, 49, 128, 4, 64),
             ("swin_s2_shift", "window", b_w * 4, 49, 512, 16, 4),
             ("swin_s0_train", "window", SWIN_TRAIN_BATCH * 64, 49, 128, 4, 64),
             ("swin_s1_train", "window", SWIN_TRAIN_BATCH * 16, 49, 256, 8, 16),
             ("swin_s2_train", "window", SWIN_TRAIN_BATCH * 4, 49, 512, 16, 4),
             ("swin_s3_train", "window", SWIN_TRAIN_BATCH, 49, 1024, 32, 1),
             ("odd_heads", "window", 96, 49, 72, 3, 1)]
    it = dict(iters=10, replays=3)
    # fp32 cases whose plain and library times are taken too: the kernels line's record
    # of the CUDA-core panel backward, which the fp32 CLAP step runs, and the CUDA-core
    # window forward at Swin-B's stage 0 (serve batch)
    fp32_timed = {"htsat_s0_shift_train", "swin_s0_shift"}
    records = {}
    for name, kind, b, geo, c, heads, nw in cases:
        panel = kind == "panel"
        n = 64 if panel else geo
        hd = c // heads
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            mode = wa.PANEL if panel else wa.PARTITIONED
            body = wa.bwd_body(mode, n, hd, dtype)
            fbody = wa.fwd_body(mode, n, hd, dtype)
            if panel:
                hw = geo
                q, k, v, bias, do = window_inputs(torch, (b, hw[0] * hw[1]), c, nw, heads, 64,
                                                  dtype, gen)
                kw = dict(hw=hw, ws=8)
                fwd = lambda: swa.panel_attention_fwd(q, k, v, bias, **kw)  # noqa: E731
                bwd = lambda: swa.panel_attention_bwd(q, k, v, bias, do, **kw)  # noqa: E731
                ref_f = lambda: swa.panel_attention_reference(q, k, v, bias, **kw)  # noqa: E731
                ref_b = lambda: swa.panel_attention_bwd_reference(q, k, v, bias, do, **kw)  # noqa: E731
                windows = b * (hw[0] // 8) * (hw[1] // 8)
                part = lambda x: swa.partition(x, hw, 8)  # noqa: E731
                unpart = lambda x: swa.reverse(x, hw, 8)  # noqa: E731
                replaces = ("open_clip_tpu/ops/swin_attention.py:105",
                            "open_clip_tpu/ops/swin_attention.py:154")
                label = "panel_attention"
            else:
                q, k, v, bias, do = window_inputs(torch, (b, n), c, nw, heads, n, dtype, gen)
                fwd = lambda: wa.window_attention_fwd(q, k, v, bias)  # noqa: E731
                bwd = lambda: wa.window_attention_bwd(q, k, v, bias, do)  # noqa: E731
                ref_f = lambda: wa.window_attention_reference(q, k, v, bias)  # noqa: E731
                ref_b = lambda: wa.window_attention_bwd_reference(q, k, v, bias, do)  # noqa: E731
                windows = b
                part = unpart = lambda x: x  # noqa: E731
                replaces = ("open_clip_tpu/ops/window_attention.py:141",
                            "open_clip_tpu/ops/window_attention.py:175")
                label = "window_attention"
            mod = swa if panel else wa
            before, fwd_before = dict(mod.BWD_BODIES), dict(mod.FWD_BODIES)
            out, grads = fwd(), bwd()
            ref, refs = ref_f(), ref_b()
            torch.cuda.synchronize()
            took = {k: v - before[k] for k, v in mod.BWD_BODIES.items()}
            took_fwd = {k: v - fwd_before[k] for k, v in mod.FWD_BODIES.items()}
            err = (out.float() - ref.float()).abs().max().item()
            errs = [rel_err(g, r) for g, r in zip(grads, refs)]
            abs_errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs)]
            shape = f"B={b} {'map' if panel else 'N'}={geo} C={c} H={heads} nW={nw} {dn}"
            check(bool(torch.isfinite(out).all()) and err <= TOL[dn] and took_fwd[fbody] == 1
                  and sum(took_fwd.values()) == 1,
                  f"{label} forward ({fbody}) {name} {shape}: max_abs_err={err:.3e} "
                  f"(tol {TOL[dn]:.0e})")
            if dtype == torch.bfloat16 and name in FWD_DETERMINISM_CASES:
                check(torch.equal(out, fwd()),
                      f"{label} forward ({fbody}) {name}: two launches give the same bits")
            check(all(bool(torch.isfinite(g).all()) for g in grads) and max(errs) <= BWD_RTOL[dn]
                  and took[body] == 1,
                  f"{label} backward ({body}) {name} {shape}: rel err dq/dk/dv/dbias="
                  f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e}/{errs[3]:.2e} (tol {BWD_RTOL[dn]:.0e})")
            if name.startswith("swin") and dtype == torch.bfloat16:
                check(body == "mma", f"{label} backward {name}: Swin-B's 49-token windows take "
                                     f"the tensor-core body ({body})")
            if name.startswith(("swin", "htsat")):
                want = "mma" if dtype == torch.bfloat16 else "simt"
                check(fbody == want, f"{label} forward {name} {dn}: takes the {fbody} body "
                                     f"(expect {want})")
            del out, grads, ref, refs
            ms_fwd, ms_bwd = graph_ms(fwd, **it), graph_ms(bwd, **it)
            simt_fwd = None
            if fbody == "mma":  # the CUDA-core forward on the same inputs, the body it replaced
                with body_patched(wa, "fwd_body", "simt"):
                    simt_fwd = graph_ms(fwd, **it)
            plain_fwd = plain_bwd = lib_fwd = lib_bwd = copies = None
            if dtype == torch.bfloat16 or name in fp32_timed:
                plain_fwd, plain_bwd = graph_ms(ref_f, **it), graph_ms(ref_b, **it)
                nb = windows // nw
                heads_first = lambda x: part(x).reshape(nb, nw, n, heads, hd).permute(  # noqa: E731
                    0, 1, 3, 2, 4).reshape(nb, nw * heads, n, hd).contiguous()
                mask = bias.to(dtype).reshape(1, nw * heads, n, n)
                lq, lk, lv = (heads_first(x).requires_grad_() for x in (q, k, v))
                ldo = heads_first(do)

                def back(o):  # (nb, nW*H, N, hd) -> the layout of q
                    return unpart(o.reshape(nb, nw, heads, n, hd).permute(0, 1, 3, 2, 4)
                                  .reshape(windows, n, c))

                def lib():
                    with torch.no_grad():
                        if panel:  # the partition copies, as a caller of the library makes them
                            return back(F.scaled_dot_product_attention(
                                heads_first(q), heads_first(k), heads_first(v), attn_mask=mask))
                        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)

                def lib_both():
                    o = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
                    return torch.autograd.grad(o, (lq, lk, lv), ldo)

                lib_fwd = graph_ms(lib, **it)
                with torch.no_grad():
                    lib_plain_fwd = graph_ms(
                        lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask), **it)
                lib_bwd = graph_ms(lib_both, **it) - lib_plain_fwd
                if panel:
                    with torch.no_grad():
                        copies = graph_ms(lambda: (heads_first(q), heads_first(k), heads_first(v),
                                                   back(lq)), **it)
                del lq, lk, lv, ldo
            size, blc = q.element_size(), windows * n * c
            bias_bytes = bias.numel() * 4
            common = {"route": "cuda", "source": WINDOW_SOURCE, "case": name, "batch": b,
                      "map_or_n": geo, "channels": c, "heads": heads, "bias_windows": nw,
                      "windows": windows, "dtype": dn}
            recs = {
                "fwd": dict(common, name=f"{label}_fwd[{name}]", replaces=replaces[0], body=fbody,
                            max_abs_err=err, ms=ms_fwd, simt_ms=simt_fwd, plain_ms=plain_fwd,
                            **bound(4 * blc * size + bias_bytes, 4 * windows * n * n * c, dn),
                            library_ms=lib_fwd, library_partition_copies_ms=copies),
                "bwd": dict(common, name=f"{label}_bwd[{name}]", replaces=replaces[1], body=body,
                            max_abs_err=max(abs_errs), max_rel_err=max(errs), ms=ms_bwd,
                            plain_ms=plain_bwd,
                            **bound(7 * blc * size + 2 * bias_bytes, 10 * windows * n * n * c, dn),
                            library_ms=lib_bwd),
            }
            for rec in recs.values():
                print("kernel_case " + json.dumps(rec), flush=True)
            records[(name, dn)] = recs
            del q, k, v, bias, do
        torch.cuda.empty_cache()
    return records


def phase_window_groups(torch, wa, swa):
    """The tensor-core window backward and forward at Swin-B's four stage shapes and
    HTSAT's panel backward and forward at its four (train batches) under other group
    splits: ``bwd_groups`` aims at ``bwd_target(mode, body)`` blocks in the backward
    and at ``fwd_target()`` in the forward. Prints the device ms of each target beside
    the one the port takes (the window_bwd_groups and window_fwd_groups lines)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    result, fwd_result = {}, {}
    own_target, own_fwd_target = wa.bwd_target, wa.fwd_target
    cases = [("swin_s0", 49, SWIN_TRAIN_BATCH * 64, None, 128, 4, 64),
             ("swin_s1", 49, SWIN_TRAIN_BATCH * 16, None, 256, 8, 16),
             ("swin_s2", 49, SWIN_TRAIN_BATCH * 4, None, 512, 16, 4),
             ("swin_s3", 49, SWIN_TRAIN_BATCH, None, 1024, 32, 1),
             ("htsat_s0_shift", 64, CLAP_TRAIN_BATCH, (64, 64), 96, 4, 64),
             ("htsat_s1_shift", 64, CLAP_TRAIN_BATCH, (32, 32), 192, 8, 16),
             ("htsat_s2_shift", 64, CLAP_TRAIN_BATCH, (16, 16), 384, 16, 4),
             ("htsat_s3", 64, CLAP_TRAIN_BATCH, (8, 8), 768, 32, 1)]
    for name, n, b, hw, c, heads, nw in cases:
        mode = wa.PARTITIONED if hw is None else wa.PANEL
        lead = (b, n) if hw is None else (b, hw[0] * hw[1])
        q, k, v, bias, do = window_inputs(torch, lead, c, nw, heads, n, torch.bfloat16, gen)
        if hw is None:
            bwd = lambda: wa.window_attention_bwd(q, k, v, bias, do)  # noqa: E731
            fwd = lambda: wa.window_attention_fwd(q, k, v, bias)  # noqa: E731
        else:
            bwd = lambda: swa.panel_attention_bwd(q, k, v, bias, do, hw=hw, ws=8)  # noqa: E731
            fwd = lambda: swa.panel_attention_fwd(q, k, v, bias, hw=hw, ws=8)  # noqa: E731
        times = {"target_in_use": own_target(mode, "mma")}
        fwd_times = {"target_in_use": own_fwd_target()}
        try:
            for target in (132, 264, 528, 1056, 2112):
                wa.bwd_target = lambda mode_, body, t=target: t  # noqa: E731
                wa.fwd_target = lambda t=target: t  # noqa: E731
                times[str(target)] = graph_ms(bwd, iters=10, replays=3)
                fwd_times[str(target)] = graph_ms(fwd, iters=20, replays=3)
        finally:
            wa.bwd_target, wa.fwd_target = own_target, own_fwd_target
        result[name], fwd_result[name] = times, fwd_times
    print("window_bwd_groups " + json.dumps(result), flush=True)
    print("window_fwd_groups " + json.dumps(fwd_result), flush=True)


def clap_audio(torch, n, seed, device="cuda"):
    """A waveform dict of n ten-second clips: 0.1 * N(0, 1) noise and a tone, from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(CLAP_SECONDS * CLAP_RATE, device=device) / CLAP_RATE
    freq = 200.0 + 100.0 * torch.arange(n, device=device)[:, None]
    wav = 0.1 * torch.randn(n, t.numel(), generator=gen, device=device) + 0.2 * torch.sin(
        2 * math.pi * freq * t)
    return {"waveform": wav, "longer": torch.zeros(n, dtype=torch.bool, device=device)}


def phase_clap_serve(torch, oc, sa, swa, wa):
    """CLAP serving: 64 ten-second clips a request, preprocessed on the host by the
    model's AudioPreprocess, copied from pinned memory, log-mel and encode_audio on the
    card, logits against an ESC-50-template classifier, top-5. Returns the panel
    forward launches and the encode_audio calls that made them."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from open_clip_tpu_torch.data.audio import collate_audio
    from open_clip_tpu_torch.train.audio_zero_shot import ESC50_TEMPLATES

    torch.cuda.reset_peak_memory_stats()
    model, _, pp_val = oc.create_model_and_transforms(CLAP_MODEL, precision="pure_bf16", seed=0)
    layers = sum(model.audio.encoder.depths)
    tokenizer = oc.get_tokenizer(CLAP_MODEL)
    rng = np.random.default_rng(0)
    requests = []
    for _ in range(4):
        clips = [(0.1 * rng.standard_normal(CLAP_SECONDS * CLAP_RATE).astype(np.float32), CLAP_RATE)
                 for _ in range(CLAP_SERVE_BATCH)]
        batch = collate_audio([pp_val(c) for c in clips])
        requests.append({k: v.pin_memory() for k, v in batch.items()})
    phases = ("copy", "encode_audio", "logits_top5")
    with torch.inference_mode():
        reset_counts(sa, swa, wa)
        clf = oc.build_zero_shot_classifier(model, tokenizer, ESC50_CLASSES, ESC50_TEMPLATES,
                                            num_classes_per_batch=len(ESC50_CLASSES))
        torch.cuda.synchronize()
        text_launches = sa.LAUNCHES["fwd"]
        clf32 = clf.float()

        def request(i, events=None):
            mark = (lambda j: events[j].record()) if events else (lambda j: None)
            mark(0)
            audio = {k: v.to("cuda", non_blocking=True) for k, v in requests[i % 4].items()}
            mark(1)
            feats = model.encode_audio(audio, normalize=True)
            mark(2)
            top5 = (100.0 * feats.float() @ clf32).topk(5, dim=-1).indices
            mark(3)
            return feats, top5.cpu()  # waits for the device: one request in flight

        t0 = time.perf_counter()
        request(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        lat, phase_ms = [], {n: [] for n in phases}
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < WINDOW_S:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(phases) + 1)]
            t0 = time.perf_counter()
            feats, top5 = request(len(lat) + 1, ev)
            lat.append((time.perf_counter() - t0) * 1e3)
            for j, n in enumerate(phases):
                phase_ms[n].append(ev[j].elapsed_time(ev[j + 1]))
        window_s = time.perf_counter() - t_start
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(PROFILED_REQUESTS):
                request(i)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        calls = 1 + len(lat) + PROFILED_REQUESTS
        panel, window, by_body = dict(swa.LAUNCHES), dict(wa.LAUNCHES), dict(swa.FWD_BODIES)
        # the log-mel front end alone, for the stage breakdown
        audio = {k: v.to("cuda") for k, v in requests[0].items()}
        mel_ms = graph_ms(lambda: model.audio.encoder.mel(audio["waveform"]), iters=5, replays=3)
        # the same requests with the panel forward sent to its CUDA-core body, the one it
        # took before the tensor-core forward: a before and after within one run
        with body_patched(wa, "fwd_body", "simt"):
            reset_counts(swa)
            request(0)
            simt_lat, _, _, _, simt_prof, simt_wall_ms = serve_window(request, 3)
            simt_by_body = dict(swa.FWD_BODIES)
    check(text_launches == model.cfg.text_cfg.layers,
          f"CLAP classifier: {text_launches} short-kernel launches for 1 encode_text call")
    check(panel == {"fwd": layers * calls, "bwd": 0} and window == {"fwd": 0, "bwd": 0}
          and by_body == {"mma": layers * calls, "simt": 0},
          f"CLAP requests: panel launches {panel}, forward by body {by_body}, window {window} "
          f"for {calls} encode_audio calls (expect {layers} panel forward each, all on the "
          "tensor-core body, nothing else)")
    simt_calls = 1 + len(simt_lat) + 3
    check(simt_by_body == {"mma": 0, "simt": layers * simt_calls},
          f"CLAP requests[CUDA-core panel forward]: forward by body {simt_by_body}")
    summary = profile_summary(prof, prof_wall_ms, PROFILED_REQUESTS)
    simt_summary = profile_summary(simt_prof, simt_wall_ms, 3)
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(tuple(feats.shape) == (CLAP_SERVE_BATCH, model.cfg.embed_dim)
          and bool(torch.isfinite(feats).all()) and bool(((fn - 1).abs() < 1e-2).all())
          and tuple(top5.shape) == (CLAP_SERVE_BATCH, 5) and int(top5.min()) >= 0
          and int(top5.max()) < len(ESC50_CLASSES),
          f"CLAP request output: features {tuple(feats.shape)} finite and unit, top-5 {tuple(top5.shape)}")
    print("clap_serve " + json.dumps({
        "model": CLAP_MODEL, "precision": "pure_bf16", "batch": CLAP_SERVE_BATCH,
        "clip_seconds": CLAP_SECONDS, "first_request_ms": first_ms, "window_s": window_s,
        "window_requests": len(lat), "clips_per_s": CLAP_SERVE_BATCH * len(lat) / window_s,
        "median_request_ms": statistics.median(lat), "min_request_ms": min(lat),
        "max_request_ms": max(lat),
        "device_ms_median": {n: statistics.median(v) for n, v in phase_ms.items()},
        "log_mel_device_ms": mel_ms, "panel_fwd_launches": panel["fwd"],
        "panel_fwd_launches_per_request_by_body": {k: v / calls for k, v in by_body.items()},
        "kernel_ms_per_request": summary["device_busy_ms_per_request"],
        "panel_fwd_ms_per_request": summary["class_ms_per_request"].get("window_attention"),
        "median_request_ms_cuda_core_panel_fwd": statistics.median(simt_lat),
        "kernel_ms_per_request_cuda_core_panel_fwd": simt_summary["device_busy_ms_per_request"],
        "panel_fwd_ms_per_request_cuda_core": simt_summary["class_ms_per_request"].get(
            "window_attention"),
        "device_idle_share": summary["device_idle_share"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    print("clap_profile " + json.dumps(summary), flush=True)
    return panel["fwd"], by_body, calls


def phase_clap_train(torch, oc, sa, swa, wa):
    """CLAP training at bench_clap's shape: batch 128 of ten-second clips, amp_bf16,
    AdamW with clipping; returns the panel launches of the timed window and its steps."""
    torch.cuda.reset_peak_memory_stats()
    model = oc.create_model(CLAP_MODEL, precision="amp_bf16", seed=0)
    layers, lt = sum(model.audio.encoder.depths), model.cfg.text_cfg.layers
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-4, wd=0.2, grad_clip_norm=1.0),
                                    model, oc.const_lr(1e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer)
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"audio": clap_audio(torch, CLAP_TRAIN_BATCH, 7),
             "text": torch.randint(0, 49407, (CLAP_TRAIN_BATCH, 77), generator=gen, device="cuda")}
    state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
    n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
    reset_counts(sa, swa, wa)
    state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
    panel, short = dict(swa.LAUNCHES), dict(sa.LAUNCHES)
    panel_bodies, short_bodies = dict(swa.BWD_BODIES), dict(sa.BWD_BODIES)
    panel_fwd_bodies, short_fwd_bodies = dict(swa.FWD_BODIES), dict(sa.FWD_BODIES)
    losses = [float(m["loss"]) for m in warm + window]
    norms = [float(m["grad_norm"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses), f"clap_train: {len(losses)} losses finite")
    check(losses[-1] < losses[0], f"clap_train: loss fell on the fixed batch, "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps")
    check(all(math.isfinite(x) and x > 0 for x in norms), "clap_train: grad_norm finite, positive")
    check(panel == {"fwd": layers * n, "bwd": layers * n} and wa.LAUNCHES == {"fwd": 0, "bwd": 0},
          f"clap_train: panel launches {panel}, window {wa.LAUNCHES} in {n} steps "
          f"(expect {layers * n} panel forward and backward)")
    check(short == {"fwd": lt * n, "bwd": lt * n},
          f"clap_train: short-kernel launches {short} in {n} steps (the text tower)")
    check(panel_bodies == {"mma": layers * n, "simt": 0} and short_bodies == {"mma": lt * n, "simt": 0}
          and short_fwd_bodies == short_bodies and panel_fwd_bodies == panel_bodies,
          f"clap_train: backward launches by body, panel {panel_bodies}, short {short_bodies} "
          f"(forward: panel {panel_fwd_bodies}, short {short_fwd_bodies}) in {n} steps (expect "
          "every one on the tensor-core bodies)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state, prof_summary = profiled_steps(torch, step, state, batch)
    print("clap_train_profile " + json.dumps(prof_summary), flush=True)
    # the same steps with the panel forward on its CUDA-core body: the kernels' before
    # and after within one run
    with body_patched(wa, "fwd_body", "simt"):
        reset_counts(swa)
        state, simt_summary = profiled_steps(torch, step, state, batch)
        simt_fwd_bodies = dict(swa.FWD_BODIES)
    check(simt_fwd_bodies == {"mma": 0, "simt": layers * (TRAIN_PROFILED_STEPS + 1)},
          f"clap_train[CUDA-core panel forward]: forward launches by body {simt_fwd_bodies}")
    # kernel ms: the device-busy time of the profiled steps (the sum of their kernels)
    summary = {"model": CLAP_MODEL, "precision": "amp_bf16", "batch": CLAP_TRAIN_BATCH,
               "clip_seconds": CLAP_SECONDS, "window_steps": n, "window_s": wall_s,
               "clips_per_s": CLAP_TRAIN_BATCH * n / wall_s,
               "median_step_ms": statistics.median(step_ms),
               "kernel_ms_per_step": prof_summary["device_busy_ms_per_step"],
               "min_step_ms": min(step_ms),
               "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
               "host_lead_ms_at_end": lead_ms, "first_loss": losses[0], "last_loss": losses[-1],
               "panel_launches_per_step": {k: v / n for k, v in panel.items()},
               "panel_fwd_launches_per_step_by_body": {k: v / n for k, v in panel_fwd_bodies.items()},
               "panel_bwd_launches_per_step_by_body": {k: v / n for k, v in panel_bodies.items()},
               "panel_fwd_ms_per_step": prof_summary["class_ms_per_step"].get("window_attention"),
               "kernel_ms_per_step_cuda_core_panel_fwd": simt_summary["device_busy_ms_per_step"],
               "panel_fwd_ms_per_step_cuda_core": simt_summary["class_ms_per_step"].get(
                   "window_attention"),
               "short_fwd_launches_per_step_by_body": {k: v / n for k, v in short_fwd_bodies.items()},
               "short_bwd_launches_per_step_by_body": {k: v / n for k, v in short_bodies.items()},
               "peak_mem_gib": peak,
               "device_busy_ms_per_step": prof_summary["device_busy_ms_per_step"]}
    print("clap_train " + json.dumps(summary), flush=True)
    return panel, panel_fwd_bodies, panel_bodies, n


def phase_clap_cli(torch, swa):
    """The training CLI on synthetic audio: one epoch, a checkpoint, a second through
    --resume latest."""
    from open_clip_tpu_torch.train.main import main as train_main

    with tempfile.TemporaryDirectory() as logs:
        args = ["--model", CLAP_MODEL, "--dataset-type", "synthetic-audio",
                "--batch-size", str(CLAP_CLI_BATCH),
                "--train-num-samples", str(CLAP_CLI_BATCH * CLAP_CLI_STEPS),
                "--precision", "amp_bf16", "--grad-clip-norm", "1.0", "--lr", "1e-4", "--wd", "0.2",
                "--warmup", "2", "--log-every-n-steps", "2", "--workers", "1", "--logs", logs,
                "--name", "clap"]
        run = Path(logs) / "clap"
        reset_counts(swa)
        t0 = time.perf_counter()
        state = train_main(args + ["--epochs", "1"])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        layers = sum(state.model.audio.encoder.depths)
        rows = [json.loads(x) for x in (run / "results.jsonl").read_text().splitlines()]
        check(state.step == CLAP_CLI_STEPS, f"CLAP CLI: {state.step} steps in the first epoch")
        check(bool(rows) and all(math.isfinite(r["train/loss"])
                                 and abs(r["train/loss"] - math.log(CLAP_CLI_BATCH)) < 1e-2
                                 for r in rows),
              f"CLAP CLI: loss {[round(r['train/loss'], 4) for r in rows]} is ln {CLAP_CLI_BATCH} "
              "on identical samples")
        check(swa.LAUNCHES == {"fwd": layers * CLAP_CLI_STEPS, "bwd": layers * CLAP_CLI_STEPS},
              f"CLAP CLI: panel launches {swa.LAUNCHES} in {CLAP_CLI_STEPS} steps")
        state = train_main(args + ["--epochs", "2", "--resume", "latest"])
        torch.cuda.synchronize()
        rows2 = [json.loads(x) for x in (run / "results.jsonl").read_text().splitlines()][len(rows):]
        check(state.step == 2 * CLAP_CLI_STEPS and bool(rows2)
              and (run / "checkpoints" / "epoch_1.pt").exists()
              and (run / "checkpoints" / "epoch_2.pt").exists(),
              f"CLAP CLI: checkpoint, then --resume latest went on to step {state.step}")
        last = rows2[-1] if rows2 else {}
        print("clap_cli " + json.dumps({
            "steps_per_epoch": CLAP_CLI_STEPS, "batch": CLAP_CLI_BATCH, "first_run_s": first_s,
            "host_data_ms_per_step": 1e3 * last.get("train/data_time", float("nan")),
            "host_batch_ms_per_step": 1e3 * last.get("train/batch_time", float("nan"))}),
            flush=True)


def grads_card_vs_cpu(torch, results, label):
    """Loss and every gradient of the card run against the CPU run."""
    (g_gpu, loss_g), (g_cpu, loss_c) = results["cuda"], results["cpu"]
    check(abs(loss_g - loss_c) <= 1e-4 * abs(loss_c),
          f"{label} loss card vs CPU fp32: {loss_g:.6f} vs {loss_c:.6f} (rel 1e-4)")
    cos = {k: torch.nn.functional.cosine_similarity(g_gpu[k].flatten(), g_cpu[k].flatten(),
                                                    dim=0).item() for k in g_cpu}
    worst = min(cos, key=cos.get)
    check(set(g_gpu) == set(g_cpu) and all(bool(torch.isfinite(g).all()) for g in g_gpu.values())
          and cos[worst] >= COSINE_MIN,
          f"{label} gradients card vs CPU fp32: min cosine {cos[worst]:.7f} at {worst} over "
          f"{len(cos)} tensors (>= {COSINE_MIN})")


def phase_clap_card_vs_cpu(torch, oc, swa):
    """fp32 with TF32 off: log-mel, audio features and every gradient of the contrastive
    loss, the card (panel kernels) against the port's CPU path (dense attention)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    audio = clap_audio(torch, 2, 8, device="cpu")
    texts = torch.as_tensor(oc.get_tokenizer(CLAP_MODEL)(["a dog barks", "rain on a tin roof"]))
    results, feats, mels = {}, {}, {}
    for device in ("cuda", "cpu"):
        model = oc.create_model(CLAP_MODEL, precision="fp32", seed=1, device=device)
        batch = {k: v.to(device) for k, v in audio.items()}
        reset_counts(swa)
        with torch.inference_mode():
            mels[device] = model.audio.encoder.mel(batch["waveform"]).cpu()
            feats[device] = model.encode_audio(batch, normalize=True).cpu()
        out = oc.clip_forward(model, batch, texts.to(device))
        loss = oc.clip_loss(out["audio_features"], out["text_features"], model.logit_scale.exp())
        loss.backward()
        results[device] = ({k: p.grad.detach().cpu().double() for k, p in model.named_parameters()
                            if p.grad is not None}, loss.item())
        if device == "cuda":
            launched, bodies, fwd_bodies = dict(swa.LAUNCHES), dict(swa.BWD_BODIES), dict(swa.FWD_BODIES)
        del model, out, loss
    mel_err = (mels["cuda"] - mels["cpu"]).abs().max().item()
    check(bool(torch.isfinite(mels["cuda"]).all()) and mel_err <= 1e-2,
          f"CLAP log-mel card vs CPU fp32: max abs {mel_err:.2e} dB (<= 1e-2) over "
          f"{tuple(mels['cpu'].shape)}, range {mels['cpu'].min().item():.1f}.."
          f"{mels['cpu'].max().item():.1f} dB")
    cos = torch.nn.functional.cosine_similarity(feats["cuda"].double(), feats["cpu"].double(),
                                                dim=-1).min().item()
    check(bool(torch.isfinite(feats["cuda"]).all()) and cos >= COSINE_MIN,
          f"CLAP encode_audio card vs CPU fp32: min cosine {cos:.7f} (>= {COSINE_MIN})")
    check(launched == {"fwd": 24, "bwd": 12} and bodies == {"mma": 0, "simt": 12}
          and fwd_bodies == {"mma": 0, "simt": 24},
          f"CLAP fp32 card run: panel launches {launched}, forward by body {fwd_bodies}, "
          f"backward by body {bodies} (12 serving, 12 in the training forward, 12 backward, all "
          "on the CUDA-core bodies)")
    grads_card_vs_cpu(torch, results, "CLAP")
    return fwd_bodies["simt"], bodies["simt"]


def phase_swin_serve(torch, oc, sa, wa):
    """Swin-B serving: 64 uint8 256x320 images a request, device preprocess,
    encode_image, logits, top-5. Returns the window forward launches and calls."""
    torch.cuda.reset_peak_memory_stats()
    model, _, preprocess = oc.create_model_and_transforms(SWIN_MODEL, precision="pure_bf16", seed=0)
    blocks = sum(len(stage.blocks) for stage in model.visual.layers)
    tokenizer = oc.get_tokenizer(SWIN_MODEL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    requests = [torch.randint(0, 256, (SWIN_SERVE_BATCH, *IMAGE_HW, 3), dtype=torch.uint8,
                              device="cuda", generator=gen) for _ in range(4)]
    with torch.inference_mode():
        reset_counts(sa, wa)
        clf = oc.build_zero_shot_classifier(model, tokenizer, oc.IMAGENET_CLASSNAMES[:CLASSES],
                                            oc.SIMPLE_IMAGENET_TEMPLATES,
                                            num_classes_per_batch=CLASSES)
        clf32 = clf.float()

        def request(i):
            feats = model.encode_image(preprocess(requests[i % 4]), normalize=True)
            return feats, (100.0 * feats.float() @ clf32).topk(5, dim=-1).indices.cpu()

        t0 = time.perf_counter()
        request(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        lat, window_s, feats, top5, prof, prof_wall_ms = serve_window(request, 3)
        calls = 1 + len(lat) + 3
        launched, by_body = dict(wa.LAUNCHES), dict(wa.FWD_BODIES)
        # the same requests with the window forward sent to its CUDA-core body, the one it
        # took before the tensor-core forward: a before and after within one run
        with body_patched(wa, "fwd_body", "simt"):
            reset_counts(wa)
            request(0)
            simt_lat, _, _, _, simt_prof, simt_wall_ms = serve_window(request, 3)
            simt_by_body = dict(wa.FWD_BODIES)
    check(launched == {"fwd": blocks * calls, "bwd": 0}
          and by_body == {"mma": blocks * calls, "simt": 0},
          f"Swin requests: window launches {launched}, forward by body {by_body} for {calls} "
          f"encode_image calls (expect {blocks} forward each, all on the tensor-core body)")
    simt_calls = 1 + len(simt_lat) + 3
    check(simt_by_body == {"mma": 0, "simt": blocks * simt_calls},
          f"Swin requests[CUDA-core window forward]: forward by body {simt_by_body}")
    summary = profile_summary(prof, prof_wall_ms, 3)
    simt_summary = profile_summary(simt_prof, simt_wall_ms, 3)
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(tuple(feats.shape) == (SWIN_SERVE_BATCH, model.cfg.embed_dim)
          and bool(torch.isfinite(feats).all()) and bool(((fn - 1).abs() < 1e-2).all())
          and tuple(top5.shape) == (SWIN_SERVE_BATCH, 5),
          f"Swin request output: features {tuple(feats.shape)} finite and unit")
    print("swin_serve " + json.dumps({
        "model": SWIN_MODEL, "precision": "pure_bf16", "batch": SWIN_SERVE_BATCH,
        "image_hw": list(IMAGE_HW), "first_request_ms": first_ms, "window_s": window_s,
        "window_requests": len(lat), "images_per_s": SWIN_SERVE_BATCH * len(lat) / window_s,
        "median_request_ms": statistics.median(lat), "min_request_ms": min(lat),
        "window_fwd_launches": launched["fwd"],
        "window_fwd_launches_per_request_by_body": {k: v / calls for k, v in by_body.items()},
        "kernel_ms_per_request": summary["device_busy_ms_per_request"],
        "window_fwd_ms_per_request": summary["class_ms_per_request"].get("window_attention"),
        "median_request_ms_cuda_core_window_fwd": statistics.median(simt_lat),
        "kernel_ms_per_request_cuda_core_window_fwd": simt_summary["device_busy_ms_per_request"],
        "window_fwd_ms_per_request_cuda_core": simt_summary["class_ms_per_request"].get(
            "window_attention"),
        "device_idle_share": summary["device_idle_share"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    print("swin_profile " + json.dumps(summary), flush=True)
    return launched["fwd"], by_body, calls


def phase_swin_train(torch, oc, sa, wa):
    """Swin-B training through the existing train step: amp_bf16, AdamW with clipping,
    one fixed batch; a few profiled steps, the same with the window backward on its
    CUDA-core body; then one step with remat (each block recomputed)."""
    torch.cuda.reset_peak_memory_stats()
    model = oc.create_model(SWIN_MODEL, precision="amp_bf16", seed=0)
    blocks = sum(len(stage.blocks) for stage in model.visual.layers)
    lt = model.cfg.text_cfg.layers
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-4, wd=0.2, grad_clip_norm=1.0),
                                    model, oc.const_lr(1e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer)
    batch = train_batch(torch, model.cfg, SWIN_TRAIN_BATCH, "cuda", seed=9)
    state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
    n = max(3, math.ceil(TRAIN_WINDOW_S / 2 * 1e3 / warm_ms[-1]))
    reset_counts(sa, wa)
    state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
    win, short, bodies = dict(wa.LAUNCHES), dict(sa.LAUNCHES), dict(wa.BWD_BODIES)
    losses = [float(m["loss"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"swin_train: {len(losses)} losses finite, fell {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(win == {"fwd": blocks * n, "bwd": blocks * n} and short == {"fwd": lt * n, "bwd": lt * n},
          f"swin_train: window launches {win}, short {short} in {n} steps (expect {blocks} and "
          f"{lt} of each a step)")
    fwd_bodies = dict(wa.FWD_BODIES)
    check(wa.BWD_BODIES == {"mma": blocks * n, "simt": 0} and sa.BWD_BODIES == {"mma": lt * n, "simt": 0}
          and sa.FWD_BODIES == sa.BWD_BODIES and fwd_bodies == wa.BWD_BODIES,
          f"swin_train: backward launches by body, window {wa.BWD_BODIES} (49-token windows on "
          f"the tensor-core body), short {sa.BWD_BODIES}; forward: window {fwd_bodies}, short "
          f"{sa.FWD_BODIES}")

    state, summary = profiled_steps(torch, step, state, batch)
    # the same steps with the window backward, then the window forward, sent to the
    # CUDA-core body, the one each took before its tensor-core body served 49-token
    # windows: a before and after of the step's kernels within one run
    with body_patched(wa, "bwd_body", "simt"):
        reset_counts(wa)
        state, simt_summary = profiled_steps(torch, step, state, batch)
        simt_launches = dict(wa.BWD_BODIES)
    check(simt_launches == {"mma": 0, "simt": blocks * (TRAIN_PROFILED_STEPS + 1)},
          f"swin_train[CUDA-core window backward]: backward launches by body {simt_launches}")
    with body_patched(wa, "fwd_body", "simt"):
        reset_counts(wa)
        state, simt_fwd_summary = profiled_steps(torch, step, state, batch)
        simt_fwd_launches = dict(wa.FWD_BODIES)
    check(simt_fwd_launches == {"mma": 0, "simt": blocks * (TRAIN_PROFILED_STEPS + 1)},
          f"swin_train[CUDA-core window forward]: forward launches by body {simt_fwd_launches}")
    print("swin_train_profile " + json.dumps(summary), flush=True)
    remat_step = oc.make_train_step(model.cfg, optimizer, remat=True)
    reset_counts(wa)
    state, rm, remat_ms, *_ = run_steps(torch, remat_step, state, batch, 1)
    check(wa.LAUNCHES == {"fwd": 2 * blocks, "bwd": blocks} and math.isfinite(float(rm[-1]["loss"])),
          f"swin_train[remat]: window launches {wa.LAUNCHES} in 1 step, loss finite")
    print("swin_train " + json.dumps({
        "model": SWIN_MODEL, "precision": "amp_bf16", "batch": SWIN_TRAIN_BATCH, "window_steps": n,
        "window_s": wall_s, "images_per_s": SWIN_TRAIN_BATCH * n / wall_s,
        "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
        "median_host_ms_per_step": statistics.median(host_ms), "host_lead_ms_at_end": lead_ms,
        "first_loss": losses[0], "last_loss": losses[-1], "remat_step_ms": remat_ms[0],
        "window_fwd_launches_per_step_by_body": {k: v / n for k, v in fwd_bodies.items()},
        "window_bwd_launches_per_step_by_body": {k: v / n for k, v in bodies.items()},
        "kernel_ms_per_step": summary["device_busy_ms_per_step"],
        "window_fwd_ms_per_step": summary["class_ms_per_step"].get("window_attention"),
        "window_bwd_ms_per_step": summary["class_ms_per_step"].get("window_attention_bwd"),
        "kernel_ms_per_step_cuda_core_window_bwd": simt_summary["device_busy_ms_per_step"],
        "window_bwd_ms_per_step_cuda_core": simt_summary["class_ms_per_step"].get(
            "window_attention_bwd"),
        "kernel_ms_per_step_cuda_core_window_fwd": simt_fwd_summary["device_busy_ms_per_step"],
        "window_fwd_ms_per_step_cuda_core": simt_fwd_summary["class_ms_per_step"].get(
            "window_attention"),
        "device_idle_share": summary["device_idle_share"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    return win, fwd_bodies, n


@contextlib.contextmanager
def sb_parent_bodies(sb):
    """While open, the SwitchBack forward runs its earlier bodies: the mma product at
    every shape and the plain PyTorch quantization."""
    body_of, quantize = sb.matmul_body, sb.quantize_rowwise
    sb.matmul_body, sb.quantize_rowwise = (lambda k, aligned: "mma"), sb.quantize_rowwise_plain
    try:
        yield
    finally:
        sb.matmul_body, sb.quantize_rowwise = body_of, quantize


@contextlib.contextmanager
def quantize_ranges(sb):
    """While open, each quantization of the SwitchBack forward, kernel or plain, runs
    in a profiler range "switchback_quantize"; ``range_ops_ms`` sums the kernels that
    PyTorch ops launched inside them (the plain version's; a ctypes launch has no op,
    so the kernel's own time is its class's)."""
    from torch.profiler import record_function

    quantize = sb.quantize_rowwise

    def ranged(x):
        with record_function("switchback_quantize"):
            return quantize(x)

    sb.quantize_rowwise = ranged
    try:
        yield
    finally:
        sb.quantize_rowwise = quantize


def range_ops_ms(prof, name: str) -> float:
    """Device ms of the kernels that PyTorch ops launched inside the profiler ranges
    called ``name`` (the host-side ranges; their device-side spans hold gaps)."""
    from torch.autograd import DeviceType

    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) / 1e3


def sb_quantize_input(torch, m, k, dtype, gen):
    """(m, k) rows of mixed ranges; rows 0-2 at .5 ties of their quotients (absmax 127,
    254 and 63.5: scales 1, 2 and 0.5, the other values j + 0.5 times the scale) and
    the last row zero."""
    x = torch.randn(m, k, device="cuda", generator=gen) * (
        torch.rand(m, 1, device="cuda", generator=gen) * 10 + 0.01)
    halves = ((torch.arange(k, device="cuda") % 253 - 126).float() + 0.5).clamp(-126.5, 126.5)
    for i, scale in enumerate((1.0, 2.0, 0.5)):
        x[i] = halves * scale
        x[i, 0] = 127.0 * scale
    x[-1] = 0.0
    return x.to(dtype)


def phase_switchback_kernels(torch, sb):
    """The two SwitchBack kernels against their plain versions, exactly (atol 0).

    The int8 matmul-dequant with fp32 and bf16 outputs at the MLP shapes of ViT-H-14
    b32 and ViT-B-32 b256 (the wgmma body; launched twice, the same bits; and the mma
    body patched in), ragged shapes (mma where K % 16 != 0), a zero row and a zero
    column. Time from one CUDA graph of calls: the body the wrapper picks, the mma
    body, the plain version, torch._int_mm plus the dequant, bare torch._int_mm, and
    bf16 F.linear (what SwitchBack replaces).

    The row-wise quantization of each shape's bf16 activations (M, K) and its fp32
    weight (N, K), with tie rows and a zero row, against the plain version on the CPU
    (on the card PyTorch divides by the host scalar 127 through its reciprocal);
    kernel and plain (on the card) time, the bound. Returns the bf16-output product
    records and the quantization records by shape name."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    records, q_records = {}, {}
    cases = dict(SB_SHAPES, **{f"ragged_{m}x{k}x{n}": (m, k, n) for m, k, n in SB_RAGGED})
    for name, (m, k, n) in cases.items():
        qx = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda", generator=gen)
        qw = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda", generator=gen)
        qx[0], qw[-1] = 0, 0  # a zero row, a zero column of the output
        sx = torch.rand(m, device="cuda", generator=gen) * 0.1 + 1e-3
        sw = torch.rand(n, device="cuda", generator=gen) * 0.1 + 1e-3
        body = sb.matmul_body(k, True)
        err = {}
        for od in (torch.float32, torch.bfloat16):
            dn = str(od).split(".")[1]
            reset_counts(sb)
            out = sb.int8_matmul_dequant(qx, qw, sx, sw, od)
            again = sb.int8_matmul_dequant(qx, qw, sx, sw, od)
            ref = sb.int8_matmul_dequant_plain(qx, qw, sx, sw, od)
            torch.cuda.synchronize()
            err[dn] = (out.float() - ref.float()).abs().max().item()
            check(out.dtype == od and tuple(out.shape) == (m, n) and torch.equal(out, ref)
                  and torch.equal(out, again) and sb.FWD_BODIES[body] == 2,
                  f"switchback {name} M={m} K={k} N={n} {dn} out, {body} body: kernel == plain "
                  f"bit for bit, twice (max |err| {err[dn]:.3e})")
            if name in SB_SHAPES:
                with sb_parent_bodies(sb):
                    out = sb.int8_matmul_dequant(qx, qw, sx, sw, od)
                torch.cuda.synchronize()
                check(torch.equal(out, ref) and sb.FWD_BODIES["mma"] == 1,
                      f"switchback {name} {dn} out, mma body: kernel == plain bit for bit")
        if name not in SB_SHAPES and (m, k, n) != SB_TIMED_RAGGED:
            continue

        def product(od=torch.bfloat16):
            return sb.int8_matmul_dequant(qx, qw, sx, sw, od)

        ms = {dn: graph_ms(lambda: product(od), iters=20)
              for dn, od in (("float32", torch.float32), ("bfloat16", torch.bfloat16))}
        with sb_parent_bodies(sb):
            mma_ms = graph_ms(product, iters=20)
        plain_ms = graph_ms(lambda: sb.int8_matmul_dequant_plain(qx, qw, sx, sw, torch.bfloat16),
                            iters=3, replays=3)
        library, library_ms, int_mm_ms = "torch._int_mm + dequant", None, None
        try:
            library_ms = graph_ms(lambda: ((torch._int_mm(qx, qw.t()).float() * sx[:, None])
                                           * sw[None, :]).to(torch.bfloat16), iters=20)
            int_mm_ms = graph_ms(lambda: torch._int_mm(qx, qw.t()), iters=20)
        except RuntimeError as refused:  # _int_mm takes only some shapes; the reason it gives
            library = f"none (torch._int_mm: {str(refused).splitlines()[0]})"
        x = sb_quantize_input(torch, m, k, torch.bfloat16, gen)
        w = torch.randn(n, k, device="cuda", generator=gen) * 0.02
        w_bf16 = w.to(torch.bfloat16)
        linear_ms = graph_ms(lambda: F.linear(x, w_bf16), iters=20)
        flops = 2 * m * n * k
        rec = {"name": f"int8_matmul_dequant[{name}]", "route": "cuda", "body": body,
               "source": SB_SOURCE,
               "replaces": "open_clip_tpu/ops/switchback.py:42", "shape": [m, k, n],
               "dtype": "int8 in, bfloat16 out", "max_abs_err": err["bfloat16"],
               "ms": ms["bfloat16"], "plain_ms": plain_ms,
               **bound(m * k + n * k + 2 * m * n + 4 * (m + n), flops, "int8"),
               "library_ms": library_ms, "library": library,
               "mma_ms": mma_ms,
               "ms_fp32_out": ms["float32"], "max_abs_err_fp32_out": err["float32"],
               "bound_ms_fp32_out": bound(m * k + n * k + 4 * m * n + 4 * (m + n), flops,
                                          "int8")["bound_ms"],
               "int_mm_ms": int_mm_ms, "linear_bf16_ms": linear_ms,
               "linear_bf16_bound_ms": bound(2 * (m * k + n * k + m * n), flops,
                                             "bfloat16")["bound_ms"]}
        print("kernel_case " + json.dumps(rec), flush=True)
        records[name] = rec
        if name not in SB_SHAPES:
            continue
        # the quantization of this product's operands: the activations, the weight
        for what, t in (("input", x), ("weight", w)):
            dn = str(t.dtype).split(".")[1]
            reset_counts(sb)
            q, scale = sb.quantize_rowwise(t)
            q2, scale2 = sb.quantize_rowwise(t)
            pq, pscale = sb.quantize_rowwise_plain(t.cpu())
            torch.cuda.synchronize()
            exact = torch.equal(q.cpu(), pq) and torch.equal(scale.cpu(), pscale)
            check(exact and torch.equal(q, q2) and torch.equal(scale, scale2)
                  and sb.LAUNCHES["quantize"] == 2,
                  f"quantize_rowwise {name} {what} {tuple(t.shape)} {dn}: kernel == plain (CPU) "
                  "bit for bit, ties and a zero row included, twice")
            cq, cscale = sb.quantize_rowwise_plain(t)
            qrec = {"name": f"quantize_rowwise[{name}_{what}]", "route": "cuda",
                    "source": SB_SOURCE,
                    "replaces": "open_clip_tpu/ops/switchback.py:23 (quantize_rowwise: XLA's "
                                "fusion, no pallas_call)",
                    "shape": list(t.shape), "dtype": f"{dn} in, int8 + fp32 scales out",
                    "max_abs_err": (q.cpu().int() - pq.int()).abs().max().item(),
                    "ms": graph_ms(lambda: sb.quantize_rowwise(t), iters=20),
                    "plain_ms": graph_ms(lambda: sb.quantize_rowwise_plain(t), iters=10),
                    **bound(t.numel() * (t.element_size() + 1) + 4 * t.shape[0], 0, "float32"),
                    "library_ms": None, "library": "none",
                    "plain_on_card_scales_differing": int((cscale.cpu() != pscale).sum()),
                    "plain_on_card_values_differing": int((cq.cpu() != pq).sum())}
            print("kernel_case " + json.dumps(qrec), flush=True)
            q_records[f"{name}_{what}"] = qrec
    return records, q_records


def phase_h14_train(torch, oc, sa, sb, blocks):
    """ViT-H-14 training with --use-switchback: amp_bf16, AdamW at the CLI's defaults
    (its schedule too), clip 1.0, remat with names_mm, one fixed batch of 32 images and
    texts; 2 warm-up steps, a window, a profile. Then the same step with the earlier
    bodies patched in (the mma product, the plain quantization; profiled), with the
    switch off (names_mm; profiled) and with the switch on under full remat. Each
    profile gives the quantization's device ms a step (the kernel's class; the plain
    version's through ``quantize_ranges``, in steps profiled with CPU events).
    Returns the main run's product launches by body, its quantization launches and its
    steps."""
    from torch.profiler import ProfilerActivity, profile

    saved = blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY
    try:
        model = oc.create_model(cut_depth(oc, H14_MODEL, *H14_DEPTH), precision="amp_bf16",
                                seed=0)
        lv, lt = model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers
        # the CLI's defaults: lr 5e-4 under a cosine schedule with 10,000 warm-up steps
        optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                        model, oc.cosine_lr(5e-4, 10000, 100000))
        state = oc.create_train_state(model, optimizer)
        batch = train_batch(torch, model.cfg, H14_BATCH, "cuda")
        runs, main_run = {}, None
        # (label, MLP linear, remat policy, parent bodies, profiled, switchback launches a
        # block, short forward launches a text block): names_mm saves c_fc's output and
        # the attention output, and the recompute reruns c_proj; full remat reruns both
        for label, impl, policy, parent, profiled, sb_per_block, sa_per_block in (
                ("switchback_names_mm", "switchback", "names_mm", False, True, 3, 1),
                ("switchback_names_mm_parent_bodies", "switchback", "names_mm", True, True, 3, 1),
                ("dense_names_mm", "dense", "names_mm", False, True, 0, 1),
                ("switchback_full_remat", "switchback", "none", False, False, 4, 2)):
            blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY = impl, policy
            with contextlib.ExitStack() as stack:
                if parent:
                    stack.enter_context(sb_parent_bodies(sb))
                torch.cuda.reset_peak_memory_stats()
                step = oc.make_train_step(model.cfg, optimizer, remat=True)
                state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
                main = main_run is None
                n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1])) if main else 3
                reset_counts(sa, sb)
                state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state,
                                                                             batch, n)
                launches = {"switchback": sb.LAUNCHES["fwd"],
                            **{f"switchback_{k}": v for k, v in sb.FWD_BODIES.items()},
                            "quantize": sb.LAUNCHES["quantize"],
                            **{f"short_{k}": v for k, v in sa.LAUNCHES.items()}}
                losses = [float(m["loss"]) for m in warm + window]
                check(all(math.isfinite(x) for x in losses) and (not main or losses[-1] < losses[0]),
                      f"h14_train[{label}]: {len(losses)} losses finite"
                      + (f", fell {losses[0]:.4f} -> {losses[-1]:.4f}" if main else ""))
                products = sb_per_block * (lv + lt) * n
                want = {"switchback": products,
                        "switchback_wgmma": 0 if parent else products,
                        "switchback_mma": products if parent else 0,
                        "quantize": 0 if parent else 2 * products,
                        "short_fwd": sa_per_block * lt * n, "short_bwd": lt * n}
                check(launches == want, f"h14_train[{label}]: launches {launches} in {n} steps "
                      f"(expect {want})")
                runs[label] = {"window_steps": n, "median_step_ms": statistics.median(step_ms),
                               "min_step_ms": min(step_ms), "images_per_s": H14_BATCH * n / wall_s,
                               "median_host_ms_per_step": statistics.median(host_ms),
                               "host_lead_ms_at_end": lead_ms, "first_loss": losses[0],
                               "last_loss": losses[-1],
                               "launches_per_step": {k: v / n for k, v in launches.items()},
                               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
                if main:
                    main_run = ({"wgmma": sb.FWD_BODIES["wgmma"], "mma": sb.FWD_BODIES["mma"]},
                                sb.LAUNCHES["quantize"], n)
                if profiled:
                    if main:  # the profiler's first window pays its start-up
                        with profile(activities=[ProfilerActivity.CUDA]):
                            state = run_steps(torch, step, state, batch, 1)[0]
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        state, *_, prof_wall_s = run_steps(torch, step, state, batch,
                                                           TRAIN_PROFILED_STEPS)
                    summary = profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")
                    # the quantization's kernels a step: the kernel's class; the plain
                    # version's ops are found by their host ranges, which need CPU events,
                    # so they are read in profiled steps of their own (the summary above,
                    # like every other profile here, records the card's kernels alone)
                    quantize_ms = summary["class_ms_per_step"].get("switchback_quantize", 0.0)
                    if parent:
                        stack.enter_context(quantize_ranges(sb))
                        with profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as ranges_prof:
                            state = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)[0]
                        quantize_ms = (range_ops_ms(ranges_prof, "switchback_quantize")
                                       / TRAIN_PROFILED_STEPS)
                    print(f"h14_train_profile[{label}] " + json.dumps(
                        dict(summary, quantize_ms_per_step=quantize_ms)), flush=True)
                    runs[label].update(
                        device_busy_ms_per_step=summary["device_busy_ms_per_step"],
                        kernel_launches_per_step=summary["kernel_launches_per_step"],
                        class_ms_per_step=summary["class_ms_per_step"],
                        quantize_ms_per_step=quantize_ms)
        print("h14_train " + json.dumps({"model": H14_MODEL, "layers": [lv, lt],
                                         "precision": "amp_bf16",
                                         "batch": H14_BATCH, "runs": runs}), flush=True)
        return main_run
    finally:
        blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY = saved


def phase_l14_train(torch, oc, sa, fl, blocks):
    """ViT-L-14 training, the step of the JAX package's bench_vit_l14: batch 64, amp_bf16,
    AdamW (wd 0.2; lr 1e-5, no longer bench_vit_l14's 5e-4: on this fixed batch, with
    no warm-up, the loss at 5e-4 oscillates from step to step, 4.1982 at the first step,
    5.0201 at the 12th, 4.3104 at the 14th, 3.8740 at the 17th, so whether the window's
    last loss was below the first depended on how many steps the window took; the 20
    losses are the same bit for bit with the package of the commit before CoCa, so the
    oscillation is the recipe's, not a fault of the towers; at 1e-5 the loss falls every
    step, and the step's time does not depend on the lr), clip 1.0, one fixed batch; 2
    warm-up steps, a window, a profile; then 2 steps under names_mm from the same initial
    weights, which must give the same first loss. The image tower's 257 tokens take the
    short kernels' two-pass forward and two-kernel backward, the text tower's 77 the
    one-pass forward and the fused backward, all on the tensor cores. Returns the
    window's launches by tower and its steps."""
    from torch.profiler import ProfilerActivity, profile

    saved = blocks.REMAT_POLICY
    try:
        torch.cuda.reset_peak_memory_stats()
        model = oc.create_model(cut_depth(oc, L14_MODEL, *RD_DEPTH), precision="amp_bf16",
                                seed=0)
        lv, lt = model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers
        init = {k: v.clone() for k, v in model.state_dict().items()}

        def fresh(remat=False):
            optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-5, wd=0.2, grad_clip_norm=1.0),
                                            model, oc.const_lr(1e-5, 0))
            return oc.create_train_state(model, optimizer), oc.make_train_step(
                model.cfg, optimizer, remat=remat)

        state, step = fresh()
        batch = train_batch(torch, model.cfg, L14_BATCH, "cuda")
        state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
        n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
        reset_counts(sa)
        with tally_by_shape(sa, fl) as tally:
            state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
        counts, fwd_bodies, bwd_bodies = dict(sa.LAUNCHES), dict(sa.FWD_BODIES), dict(sa.BWD_BODIES)
        losses = [float(m["loss"]) for m in warm + window]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"l14_train: {len(losses)} losses finite, fell {losses[0]:.4f} -> {losses[-1]:.4f}")
        want = (lv + lt) * n
        check(counts == {"fwd": want, "bwd": want} and fwd_bodies == {"mma": want, "simt": 0}
              and bwd_bodies == fwd_bodies,
              f"l14_train: short launches {counts}, forward by body {fwd_bodies}, backward by "
              f"body {bwd_bodies} in {n} steps (expect {want} of each, all on the tensor cores)")
        check(all(tally.get((d, "vision"), 0) == lv * n and tally.get((d, "text"), 0) == lt * n
                  for d in ("fwd", "bwd")),
              f"l14_train: per step {lv} vision and {lt} text launches of each kernel")
        with profile(activities=[ProfilerActivity.CUDA]):
            state = run_steps(torch, step, state, batch, 1)[0]  # the profiler's own warm-up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, *_, prof_wall_s = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)
        prof_summary = profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")
        print("l14_train_profile " + json.dumps(prof_summary), flush=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        # names_mm: remat that saves the products' and the attention forward's outputs
        with torch.no_grad():
            model.load_state_dict(init)
        del init, state
        blocks.REMAT_POLICY = "names_mm"
        state, step = fresh(remat=True)
        reset_counts(sa)
        state, rm, rm_ms, *_ = run_steps(torch, step, state, batch, 2)
        rm_losses = [float(m["loss"]) for m in rm]
        check(sa.LAUNCHES == {"fwd": 2 * (lv + lt), "bwd": 2 * (lv + lt)}
              and all(math.isfinite(x) for x in rm_losses)
              and abs(rm_losses[0] - losses[0]) <= 1e-3 * abs(losses[0]),
              f"l14_train[names_mm]: launches {sa.LAUNCHES} in 2 steps (the attention forward "
              f"saved), first loss {rm_losses[0]:.6f} vs {losses[0]:.6f} (rel 1e-3)")
        summary = {"model": L14_MODEL, "precision": "amp_bf16", "batch": L14_BATCH,
                   "window_steps": n, "window_s": wall_s, "images_per_s": L14_BATCH * n / wall_s,
                   "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
                   "max_step_ms": max(step_ms),
                   "kernel_ms_per_step": prof_summary["device_busy_ms_per_step"],
                   "device_idle_share": prof_summary["device_idle_share"],
                   "median_host_ms_per_step": statistics.median(host_ms),
                   "host_lead_ms_at_end": lead_ms, "first_loss": losses[0],
                   "last_loss": losses[-1], "peak_mem_gib": peak,
                   "short_launches_per_step": {f"{d}_{tower}": tally.get((d, tower), 0) / n
                                               for d in ("fwd", "bwd")
                                               for tower in ("vision", "text")},
                   "short_fwd_launches_per_step_by_body": {k: v / n for k, v in fwd_bodies.items()},
                   "short_bwd_launches_per_step_by_body": {k: v / n for k, v in bwd_bodies.items()},
                   "names_mm_step_ms": rm_ms, "names_mm_losses": rm_losses}
        print("l14_train " + json.dumps(summary), flush=True)
        return tally, n
    finally:
        blocks.REMAT_POLICY = saved


def phase_b32_switchback(torch, oc, sa, sb, blocks, dense_first_loss: float):
    """ViT-B-32 at batch 256 with the switch on: four steps through the library (no
    remat: 2 launches a block; the first loss within int8 noise of the dense step's
    on the same model and batch, ``dense_first_loss``), then the CLI with
    --use-switchback --grad-checkpointing --remat-policy names_mm. Returns the CLI's
    launches and steps."""
    from open_clip_tpu_torch.train.main import main as train_main

    saved = blocks.MLP_LINEAR_IMPL
    try:
        blocks.MLP_LINEAR_IMPL = "switchback"
        model = oc.create_model("ViT-B-32", precision="amp_bf16", seed=0)
        blocks_n = model.cfg.vision_cfg.layers + model.cfg.text_cfg.layers
        optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                        model, oc.const_lr(5e-4, 0))
        state = oc.create_train_state(model, optimizer)
        batch = train_batch(torch, model.cfg, BATCH, "cuda")
        state, warm, _, _, _, _ = run_steps(torch, oc.make_train_step(model.cfg, optimizer), state,
                                            batch, 1)
        reset_counts(sb)
        state, window, step_ms, *_ = run_steps(torch, oc.make_train_step(model.cfg, optimizer),
                                               state, batch, 3)
        losses = [float(m["loss"]) for m in warm + window]
        check(sb.LAUNCHES["fwd"] == sb.FWD_BODIES["wgmma"] == 2 * blocks_n * 3
              and sb.LAUNCHES["quantize"] == 2 * sb.LAUNCHES["fwd"]
              and all(math.isfinite(x) for x in losses)
              and abs(losses[0] - dense_first_loss) <= 2e-2,
              f"b32_switchback: {sb.LAUNCHES} launches in 3 steps (expect {6 * blocks_n} "
              f"wgmma products, twice as many quantizations), "
              f"losses finite, first {losses[0]:.4f} vs {dense_first_loss:.4f} dense (int8 "
              "tolerance 2e-2)")
    finally:
        blocks.MLP_LINEAR_IMPL = saved
    del state, model, optimizer
    steps = 4
    with tempfile.TemporaryDirectory() as logs:
        reset_counts(sb)
        t0 = time.perf_counter()
        state = train_main(["--model", "ViT-B-32", "--dataset-type", "synthetic",
                            "--batch-size", str(BATCH), "--train-num-samples", str(BATCH * steps),
                            "--epochs", "1", "--precision", "amp_bf16", "--grad-clip-norm", "1.0",
                            "--lr", "5e-4", "--wd", "0.2", "--warmup", "2", "--workers", "1",
                            "--use-switchback", "--grad-checkpointing", "--remat-policy",
                            "names_mm", "--logs", logs, "--name", "sb"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        rows = [json.loads(x) for x in (Path(logs) / "sb" / "results.jsonl").read_text().splitlines()]
        cli_launches = dict(sb.LAUNCHES)
    check(state.step == steps and bool(rows) and all(
        abs(r["train/loss"] - math.log(BATCH)) < 1e-2 for r in rows),
        f"b32_switchback CLI: {state.step} steps, loss {[round(r['train/loss'], 4) for r in rows]} "
        f"is ln {BATCH} on identical samples")
    check(cli_launches == {"fwd": 3 * blocks_n * steps, "quantize": 6 * blocks_n * steps}
          and blocks.MLP_LINEAR_IMPL == "dense"
          and blocks.REMAT_POLICY == "none",
          f"b32_switchback CLI: {cli_launches} launches in {steps} names_mm steps "
          f"(expect {3 * blocks_n * steps}), the switch restored after the run")
    print("b32_switchback " + json.dumps({
        "batch": BATCH, "median_step_ms_no_remat": statistics.median(step_ms),
        "first_loss": losses[0], "dense_first_loss": dense_first_loss, "cli_s": cli_s,
        "cli_launches_per_step": {k: v / steps for k, v in cli_launches.items()}}), flush=True)
    return cli_launches, steps


def phase_h14_card_vs_cpu(torch, oc, sb, blocks):
    """ViT-H-14's widths with 2 layers per tower, the switch on, fp32 (TF32 off), one
    step at batch 4 on the card and on the CPU: features, loss and every gradient."""
    from open_clip_tpu_torch.loss import clip_loss
    from open_clip_tpu_torch.config import get_model_config
    from open_clip_tpu_torch.models.clip import clip_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_model_config(H14_MODEL)
    cfg["vision_cfg"]["layers"] = cfg["text_cfg"]["layers"] = 2
    name = "ViT-H-14-2-layers"
    oc.add_model_config(cfg, name=name)
    saved = blocks.MLP_LINEAR_IMPL
    results = {}
    try:
        blocks.MLP_LINEAR_IMPL = "switchback"
        for device in ("cuda", "cpu"):
            model = oc.create_model(name, precision="fp32", seed=3, device=device)
            batch = {k: v.to(device) for k, v in train_batch(torch, model.cfg, 4, "cpu", seed=3).items()}
            reset_counts(sb)
            out = clip_forward(model, batch["image"], batch["text"], train=True)
            loss = clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
            loss.backward()
            results[device] = ({k: p.grad.detach().cpu().double() for k, p in model.named_parameters()},
                               {k: out[k].detach().cpu().double()
                                for k in ("image_features", "text_features")},
                               loss.item(), dict(sb.LAUNCHES))
    finally:
        blocks.MLP_LINEAR_IMPL = saved
    (g_gpu, f_gpu, loss_g, launched), (g_cpu, f_cpu, loss_c, _) = results["cuda"], results["cpu"]
    check(launched == {"fwd": 2 * 4, "quantize": 4 * 4},
          f"h14 card vs CPU: {launched} SwitchBack launches (expect 8 products, 16 quantizations)")
    for key in f_cpu:
        cos = torch.nn.functional.cosine_similarity(f_gpu[key], f_cpu[key], dim=-1).min().item()
        check(bool(torch.isfinite(f_gpu[key]).all()) and cos >= SB_COSINE_MIN,
              f"h14 switchback {key} card vs CPU fp32: min cosine {cos:.7f} (>= {SB_COSINE_MIN})")
    check(abs(loss_g - loss_c) <= SB_LOSS_RTOL * abs(loss_c),
          f"h14 switchback loss card vs CPU fp32: {loss_g:.6f} vs {loss_c:.6f} (rel {SB_LOSS_RTOL})")
    cos = {k: torch.nn.functional.cosine_similarity(g_gpu[k].flatten(), g_cpu[k].flatten(),
                                                    dim=0).item() for k in g_cpu}
    worst = min(cos, key=cos.get)
    check(all(bool(torch.isfinite(g).all()) for g in g_gpu.values()) and cos[worst] >= SB_COSINE_MIN,
          f"h14 switchback gradients card vs CPU fp32: min cosine {cos[worst]:.7f} at {worst} "
          f"over {len(cos)} tensors (>= {SB_COSINE_MIN})")


def seeded_token_ids(torch, text_cfg, seed):
    """A stand-in for SigLIP's tokenizer, whose vocabulary is not in the repository:
    each call gives a row of random token ids per text, from one seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    return lambda texts: torch.randint(1, text_cfg.vocab_size, (len(texts), text_cfg.context_length),
                                       generator=gen)


@contextlib.contextmanager
def attention_paths(attn, nf):
    """While open, count the towers' attention calls by path and key length: each
    block's self-attention by the path ``select_impl`` gives it ("short", "flash" or
    "dense"), and the MAP pool's one-query cross-attention ("pool_dense"), which is
    dense by design, as in the JAX package."""
    tally = {}
    select, pool_dense = attn.select_impl, nf.dense_attention

    def select_(on_cuda, lq, lk, h, hd, bias, key_valid):
        impl = select(on_cuda, lq, lk, h, hd, bias, key_valid)
        tally[(impl, lk)] = tally.get((impl, lk), 0) + 1
        return impl

    def pool_(q, k, v, *args, **kwargs):
        tally[("pool_dense", k.shape[1])] = tally.get(("pool_dense", k.shape[1]), 0) + 1
        return pool_dense(q, k, v, *args, **kwargs)

    attn.select_impl, nf.dense_attention = select_, pool_
    try:
        yield tally
    finally:
        attn.select_impl, nf.dense_attention = select, pool_dense


@contextlib.contextmanager
def tally_by_len(sa):
    """While open, count the short kernels' launches by direction and sequence length
    (the SigLIP towers are told apart by length: both are non-causal)."""
    tally = {}
    fwd, bwd = sa._launch_fwd, sa.short_attention_bwd

    def bump(key):
        tally[key] = tally.get(key, 0) + 1

    def fwd_(q, k, v, causal, scale):
        out = fwd(q, k, v, causal, scale)
        bump(("fwd", q.shape[1]))
        return out

    def bwd_(q, k, v, do, *, causal=False, scale=None):
        out = bwd(q, k, v, do, causal=causal, scale=scale)
        bump(("bwd", q.shape[1]))
        return out

    sa._launch_fwd, sa.short_attention_bwd = fwd_, bwd_
    try:
        yield tally
    finally:
        sa._launch_fwd, sa.short_attention_bwd = fwd, bwd


def siglip_serve(torch, oc, sa, fa, attn, nf, name, batch, label):
    """SigLIP serving: ``name`` in pure_bf16 with weights from seed 0, a 10-class
    classifier built once from seeded token ids, then requests of ``batch`` uint8
    256x320 images (device preprocess -> encode_image -> sigmoid(scale * logits +
    bias) -> top-5), one in flight: a warm-up request, a window of at least 0.5 s and
    10 profiled requests. Returns the model, the classifier's and the requests'
    launches and path counts, and the requests served."""
    torch.cuda.reset_peak_memory_stats()
    model, _, preprocess = oc.create_model_and_transforms(name, precision="pure_bf16", seed=0)
    lv, lt = model.visual.cfg.layers, model.cfg.text_cfg.layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    requests = [torch.randint(0, 256, (batch, *IMAGE_HW, 3), dtype=torch.uint8, device="cuda",
                              generator=gen) for _ in range(DISTINCT_REQUESTS)]
    with torch.inference_mode():
        reset_counts(sa, fa)
        with attention_paths(attn, nf) as text_paths:
            clf = oc.build_zero_shot_classifier(model, seeded_token_ids(torch, model.cfg.text_cfg, 0),
                                                oc.IMAGENET_CLASSNAMES[:CLASSES],
                                                oc.SIMPLE_IMAGENET_TEMPLATES,
                                                num_classes_per_batch=CLASSES)
            torch.cuda.synchronize()
        text = {"short": dict(sa.LAUNCHES), "short_bodies": dict(sa.FWD_BODIES),
                "paths": dict(text_paths)}
        clf32 = clf.float()
        scale, bias = model.logit_scale.float().exp(), model.logit_bias.detach().float()

        def request(i):
            pixels = preprocess(requests[i % DISTINCT_REQUESTS])
            feats = model.encode_image(pixels, normalize=True)
            probs = torch.sigmoid(scale * feats.float() @ clf32 + bias)
            return feats, (probs, probs.topk(5, dim=-1).indices.cpu())

        t0 = time.perf_counter()
        request(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        reset_counts(sa, fa)
        with attention_paths(attn, nf) as paths:
            lat, window_s, feats, (probs, top5), prof, prof_wall_ms = serve_window(
                request, PROFILED_REQUESTS)
        calls = len(lat) + PROFILED_REQUESTS
        served = {"short": dict(sa.LAUNCHES), "short_bodies": dict(sa.FWD_BODIES),
                  "flash": dict(fa.LAUNCHES), "flash_bodies": dict(fa.FWD_BODIES),
                  "paths": dict(paths)}
    lq = model.cfg.text_cfg.context_length
    check(text["short"] == {"fwd": lt, "bwd": 0} and text["short_bodies"] == {"mma": lt, "simt": 0}
          and text["paths"] == {("short", lq): lt},
          f"{label} classifier: short launches {text['short']}, by body {text['short_bodies']}, "
          f"paths {text['paths']} for 1 encode_text call (expect {lt} non-causal L={lq} mma "
          "launches, no dense block)")
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(tuple(clf.shape) == (model.cfg.embed_dim, CLASSES) and bool(torch.isfinite(clf).all())
          and tuple(feats.shape) == (batch, model.cfg.embed_dim) and bool(torch.isfinite(feats).all())
          and bool(((fn - 1).abs() < 1e-2).all()) and bool(torch.isfinite(probs).all())
          and tuple(top5.shape) == (batch, 5) and int(top5.min()) >= 0 and int(top5.max()) < CLASSES,
          f"{label} output: classifier {tuple(clf.shape)}, features {tuple(feats.shape)} finite "
          f"and unit, sigmoid probabilities finite, top-5 {tuple(top5.shape)}")
    summary = profile_summary(prof, prof_wall_ms, PROFILED_REQUESTS)
    print(f"{label}_profile " + json.dumps(summary), flush=True)
    line = {"model": name, "precision": "pure_bf16", "batch": batch, "image_hw": list(IMAGE_HW),
            "first_request_ms": first_ms, "window_s": window_s, "window_requests": len(lat),
            "images_per_s": batch * len(lat) / window_s,
            "median_request_ms": statistics.median(lat), "min_request_ms": min(lat),
            "max_request_ms": max(lat), "kernel_ms_per_request": summary["device_busy_ms_per_request"],
            "device_idle_share": summary["device_idle_share"],
            "class_ms_per_request": summary["class_ms_per_request"],
            "short_fwd_launches_per_request": served["short"]["fwd"] / calls,
            "flash_fwd_launches_per_request": served["flash"]["fwd"] / calls,
            "paths_per_request": {f"{k[0]}@{k[1]}": v / calls for k, v in served["paths"].items()},
            "logit_bias": float(bias), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"{label} " + json.dumps(line), flush=True)
    return model, text, served, calls


def phase_siglip_serve(torch, oc, sa, fa, attn, nf):
    """ViT-B-16-SigLIP serving at bench_siglip's batch: every block of the image tower
    (196 tokens, no class token) takes the short kernel's two-pass mma forward, the
    MAP pool's one-query attention the dense path."""
    model, text, served, calls = siglip_serve(torch, oc, sa, fa, attn, nf, SIGLIP_MODEL,
                                              SIGLIP_BATCH, "siglip_serve")
    lv, l = model.visual.cfg.layers, model.visual.cfg.grid_size[0] * model.visual.cfg.grid_size[1]
    check(served["short"] == {"fwd": lv * calls, "bwd": 0}
          and served["short_bodies"] == {"mma": lv * calls, "simt": 0}
          and served["flash"]["fwd"] == 0
          and served["paths"] == {("short", l): lv * calls, ("pool_dense", l): calls},
          f"siglip_serve requests: short {served['short']}, by body {served['short_bodies']}, "
          f"paths {served['paths']} for {calls} encode_image calls (expect {lv} mma launches "
          f"at L={l} and one dense MAP pool a call, no dense block)")
    return text["short"]["fwd"], served["short"]["fwd"], calls


def phase_siglip384_serve(torch, oc, sa, fa, attn, nf):
    """ViT-B-16-SigLIP-384 serving: 576 tokens, no key mask, so every block takes the
    flash forward; nothing of the image tower takes the short kernel."""
    model, _, served, calls = siglip_serve(torch, oc, sa, fa, attn, nf, SIGLIP384_MODEL,
                                           SIGLIP384_BATCH, "siglip384_serve")
    lv, l = model.visual.cfg.layers, model.visual.cfg.grid_size[0] * model.visual.cfg.grid_size[1]
    check(served["flash"] == {"fwd": lv * calls, "bwd_dq": 0, "bwd_dkv": 0}
          and served["flash_bodies"] == {"wgmma": lv * calls, "simt": 0}
          and served["short"] == {"fwd": 0, "bwd": 0}
          and served["paths"] == {("flash", l): lv * calls, ("pool_dense", l): calls},
          f"siglip384_serve requests: flash {served['flash']}, by body {served['flash_bodies']}, "
          f"short {served['short']}, paths {served['paths']} for {calls} encode_image calls "
          f"(expect {lv} wgmma flash forwards at L={l} without a key mask, 0 short, one dense "
          "MAP pool a call)")
    return served["flash"]["fwd"], calls


def phase_siglip_train(torch, oc, sa, blocks):
    """bench_siglip's step: ViT-B-16-SigLIP at batch 256, 224 px, 64 tokens, amp_bf16,
    AdamW (wd 0.2), clip 1.0, loss_type "siglip", one fixed batch; with remat under
    names_mm (as bench_siglip) and without remat, each from the same initial weights
    (the same first loss): 2 warm-up steps, a window, profiled steps. lr 1e-4, where
    bench_siglip has 5e-4: with no warm-up, 5e-4 first drives this fixed batch's
    sigmoid loss up (9.62 -> 29.74 in 13 steps under names_mm on the H100), and the
    loss must fall here; the step's time does not depend on the lr. Returns the
    launches by direction and length of both windows, and their steps."""
    saved = blocks.REMAT_POLICY
    model = oc.create_model(SIGLIP_MODEL, precision="amp_bf16", seed=0)
    lv, lt = model.visual.cfg.layers, model.cfg.text_cfg.layers
    li = model.visual.cfg.grid_size[0] * model.visual.cfg.grid_size[1]
    ltx = model.cfg.text_cfg.context_length
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(torch, model.cfg, SIGLIP_BATCH, "cuda")
    total, steps, first = {}, 0, {}
    try:
        for run in ("names_mm", "no_remat"):
            label = f"siglip_train[{run}]"
            with torch.no_grad():
                model.load_state_dict(init)
            blocks.REMAT_POLICY = "names_mm" if run == "names_mm" else "none"
            torch.cuda.reset_peak_memory_stats()
            optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-4, wd=0.2, grad_clip_norm=1.0),
                                            model, oc.const_lr(1e-4, 0))
            state = oc.create_train_state(model, optimizer)
            step = oc.make_train_step(model.cfg, optimizer, loss_type="siglip",
                                      remat=run == "names_mm")
            state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
            n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
            reset_counts(sa)
            with tally_by_len(sa) as tally:
                state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state,
                                                                             batch, n)
            fwd_bodies, bwd_bodies = dict(sa.FWD_BODIES), dict(sa.BWD_BODIES)
            losses = [float(m["loss"]) for m in warm + window]
            check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                  f"{label}: {len(losses)} losses finite, fell {losses[0]:.4f} -> {losses[-1]:.4f}")
            first[run] = losses[0]
            if len(first) == 2:
                check(abs(first["no_remat"] - first["names_mm"]) <= 1e-3 * abs(first["names_mm"]),
                      f"{label}: first loss {first['no_remat']:.6f} vs {first['names_mm']:.6f} "
                      "under names_mm from the same weights (rel 1e-3)")
            want = {("fwd", li): lv * n, ("fwd", ltx): lt * n, ("bwd", li): lv * n,
                    ("bwd", ltx): lt * n}
            check(tally == want and fwd_bodies == {"mma": (lv + lt) * n, "simt": 0}
                  and bwd_bodies == fwd_bodies,
                  f"{label}: short launches by (direction, L) {tally}, forward by body "
                  f"{fwd_bodies}, backward by body {bwd_bodies} in {n} steps (expect {lv} at "
                  f"L={li} and {lt} at L={ltx} of each a step, all on the tensor cores)")
            state, prof_summary = profiled_steps(torch, step, state, batch)
            print(f"{label.replace('train', 'train_profile')} " + json.dumps(prof_summary),
                  flush=True)
            bias = float(model.logit_bias)
            check(math.isfinite(bias) and bias != -10.0,
                  f"{label}: logit_bias {bias:.6f} moved from -10")
            print("siglip_train " + json.dumps({
                "model": SIGLIP_MODEL, "precision": "amp_bf16", "batch": SIGLIP_BATCH,
                "remat": run, "window_steps": n, "window_s": wall_s,
                "images_per_s": SIGLIP_BATCH * n / wall_s,
                "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
                "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
                "host_lead_ms_at_end": lead_ms,
                "kernel_ms_per_step": prof_summary["device_busy_ms_per_step"],
                "device_idle_share": prof_summary["device_idle_share"],
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
                "lr": 1e-4, "logit_bias": bias,
                "logit_scale": float(window[-1]["logit_scale"]),
                "short_launches_per_step": {f"{d}_{'image' if l == li else 'text'}": v / n
                                            for (d, l), v in tally.items()}}), flush=True)
            for key, v in tally.items():
                total[key] = total.get(key, 0) + v
            steps += n
            del state, optimizer, step
    finally:
        blocks.REMAT_POLICY = saved
    return total, steps, li, ltx


def phase_siglip_cli(torch, sa):
    """python -m open_clip_tpu_torch.train.main --model ViT-B-16-SigLIP --siglip with
    synthetic data (fixed token ids: SigLIP's vocabulary is not in the repository)."""
    from open_clip_tpu_torch.train.main import main as train_main

    with tempfile.TemporaryDirectory() as logs:
        args = ["--model", SIGLIP_MODEL, "--siglip", "--dataset-type", "synthetic",
                "--batch-size", str(SIGLIP_BATCH),
                "--train-num-samples", str(SIGLIP_BATCH * SIGLIP_CLI_STEPS),
                "--precision", "amp_bf16", "--grad-clip-norm", "1.0", "--lr", "5e-4", "--wd", "0.2",
                "--warmup", "2", "--log-every-n-steps", "1", "--workers", "1", "--epochs", "1",
                "--logs", logs, "--name", "siglip"]
        reset_counts(sa)
        t0 = time.perf_counter()
        state = train_main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        rows = [json.loads(x) for x in (Path(logs) / "siglip" / "results.jsonl").read_text().splitlines()]
        layers = state.model.visual.cfg.layers + state.model.cfg.text_cfg.layers
        bias = float(state.model.logit_bias)
        check(state.step == SIGLIP_CLI_STEPS and len(rows) == SIGLIP_CLI_STEPS
              and all(math.isfinite(r["train/loss"]) for r in rows) and bias != -10.0,
              f"siglip CLI: {state.step} steps, losses {[round(r['train/loss'], 4) for r in rows]} "
              f"finite, logit_bias {bias:.5f}")
        check(sa.LAUNCHES == {"fwd": layers * SIGLIP_CLI_STEPS, "bwd": layers * SIGLIP_CLI_STEPS}
              and sa.FWD_BODIES == {"mma": layers * SIGLIP_CLI_STEPS, "simt": 0},
              f"siglip CLI: short launches {sa.LAUNCHES}, forward by body {sa.FWD_BODIES} in "
              f"{SIGLIP_CLI_STEPS} steps")
        last = rows[-1] if rows else {}
        print("siglip_cli " + json.dumps({
            "steps": SIGLIP_CLI_STEPS, "run_s": wall_s, "logit_bias": bias,
            "host_data_ms_per_step": 1e3 * last.get("train/data_time", float("nan")),
            "host_batch_ms_per_step": 1e3 * last.get("train/batch_time", float("nan"))}), flush=True)


def phase_siglip_card_vs_cpu(torch, oc, sa):
    """fp32, TF32 off: ViT-B-16-SigLIP at full width, batch 2, the same weights on the
    card (the CUDA-core short bodies at L=196 and L=64) and on the CPU: features, the
    siglip loss and every gradient, the logit bias and the MAP pool's included."""
    from open_clip_tpu_torch.loss import siglip_loss
    from open_clip_tpu_torch.models.clip import clip_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, feats, launched = {}, {}, {}
    batch = None
    for device in ("cuda", "cpu"):
        model = oc.create_model(SIGLIP_MODEL, precision="fp32", seed=4, device=device)
        if batch is None:
            batch = train_batch(torch, model.cfg, 2, "cpu", seed=6)
        image, text = batch["image"].to(device), batch["text"].to(device)
        reset_counts(sa)
        with torch.inference_mode():
            feats[device] = (model.encode_image(image, normalize=True).cpu(),
                             model.encode_text(text, normalize=True).cpu())
        out = clip_forward(model, image, text, train=True)
        loss = siglip_loss(out["image_features"], out["text_features"], out["logit_scale"],
                           out["logit_bias"])
        loss.backward()
        results[device] = ({k: p.grad.detach().cpu().double() for k, p in model.named_parameters()},
                           loss.item())
        launched[device] = (dict(sa.LAUNCHES), dict(sa.FWD_BODIES), dict(sa.BWD_BODIES))
        del model, out, loss
    check(launched["cuda"] == ({"fwd": 48, "bwd": 24}, {"mma": 0, "simt": 48}, {"mma": 0, "simt": 24}),
          f"SigLIP fp32 card run: short launches {launched['cuda'][0]}, forward by body "
          f"{launched['cuda'][1]}, backward by body {launched['cuda'][2]} (24 serving, 24 in the "
          "training forward, 24 backward, all on the CUDA-core bodies)")
    for i, name in enumerate(("encode_image", "encode_text")):
        cos = torch.nn.functional.cosine_similarity(feats["cuda"][i].double(), feats["cpu"][i].double(),
                                                    dim=-1).min().item()
        check(bool(torch.isfinite(feats["cuda"][i]).all()) and cos >= COSINE_MIN,
              f"SigLIP {name} card vs CPU fp32: min cosine {cos:.7f} (>= {COSINE_MIN})")
    g_gpu, g_cpu = results["cuda"][0], results["cpu"][0]
    named = {k: torch.nn.functional.cosine_similarity(g_gpu[k].flatten(), g_cpu[k].flatten(),
                                                      dim=0).item()
             for k in g_cpu if k == "logit_bias" or k.startswith("visual.attn_pool.")}
    print("siglip_card_vs_cpu " + json.dumps({
        "loss_cuda": results["cuda"][1], "loss_cpu": results["cpu"][1],
        "logit_bias_grad": [g_gpu["logit_bias"].item(), g_cpu["logit_bias"].item()],
        "grad_cosine": named}), flush=True)
    grads_card_vs_cpu(torch, results, "SigLIP")


DIST_STEPS = 8  # the window of each dist_train run: a fixed count, so the losses pair up
DIST_ACCUM_STEPS = 2  # timed and counted, after one GradCache warm-up step
DIST_CLI_STEPS = 2
# gathered loss at world 1 against the one-process form, relative to each tensor's
# largest entry: fp32 results (the loss, the scale's and bias' gradients) to 1e-5; the
# features' gradients are bf16, as the features are, and the local_loss form sums their
# fp32 terms in another order, which may move an entry across a bf16 rounding (2**-8)
DIST_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -8}
DIST_STEP_TOL = 2e-2  # per-step loss, FSDP2 step against the plain one (bf16 tolerance)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist_losses(torch):
    """The gathered losses on NCCL at world 1: clip_loss (local_loss on and off) and
    siglip_loss (gather, shift, bidir, reduce) on the default group, forward and
    backward, against the one-process forms on the same seeded bf16 features at
    ViT-B-32's width and batch 256; the max relative error over the loss and the
    gradients of the features, the scale and the bias, and the ms of each form's
    forward and backward (CUDA events, median of 10)."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from open_clip_tpu_torch.loss import clip_loss, siglip_loss

    group = dist.group.WORLD
    gen = torch.Generator(device="cuda").manual_seed(5)
    feats = [F.normalize(torch.randn(BATCH, 512, device="cuda", generator=gen), dim=-1)
             .to(torch.bfloat16) for _ in range(2)]
    scale = torch.tensor(1 / 0.07, device="cuda")
    bias = torch.tensor(-10.0, device="cuda")

    def run(fn):
        args = [t.clone().requires_grad_() for t in (*feats, scale, bias)]
        loss = fn(*args)
        loss.backward()
        return [loss.detach()] + [a.grad for a in args if a.grad is not None]

    def ms(fn):
        times = []
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(fn)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    cases = {f"clip_{form}": (
        lambda i, t, s, b, form=form: clip_loss(i, t, s, group=group, local_loss=form == "local"),
        lambda i, t, s, b: clip_loss(i, t, s)) for form in ("local", "global")}
    cases.update({f"siglip_{impl}": (
        lambda i, t, s, b, impl=impl: siglip_loss(i, t, s, b, group=group, dist_impl=impl),
        lambda i, t, s, b: siglip_loss(i, t, s, b)) for impl in ("gather", "shift", "bidir",
                                                                 "reduce")})
    summary = {}
    names = ("loss", "image_features", "text_features", "scale", "bias")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the losses' fp32 products in fp32
    try:
        for name, (gathered, plain) in cases.items():
            got, want = run(gathered), run(plain)
            errs = {k: rel_err(a, b) for k, a, b in zip(names, got, want)}
            tols = {k: DIST_LOSS_RTOL[str(a.dtype).split(".")[-1]] for k, a in zip(names, got)}
            ok = len(got) == len(want) and all(bool(torch.isfinite(t).all()) for t in got)
            check(ok and all(errs[k] <= tols[k] for k in errs),
                  f"dist_losses {name}: gathered on NCCL world 1 vs one-process form, rel err "
                  f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (<= {tols})")
            summary[name] = {"rel_err": errs, "ms": ms(gathered), "plain_ms": ms(plain)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print("dist_losses " + json.dumps({"world": dist.get_world_size(),
                                       "backend": dist.get_backend(), "batch": BATCH,
                                       "width": 512, "features": "bfloat16", **summary}),
          flush=True)


def phase_dist_train(torch, oc, sa, fl):
    """The ViT-B-32 b256 amp_bf16 step from seed 0 (phase 4's), plain and then with the
    model under shard_model(create_mesh(data=1, fsdp=1)) on NCCL: DIST_STEPS steps
    each after 2 warm-up steps (the same fixed count, so the losses pair up), then
    profiled steps, then DIST_ACCUM_STEPS GradCache steps (accum_steps=2). The FSDP2
    run's losses must match the plain run's within bf16 tolerance, its short-attention
    launches must be phase 4's per step, and both runs' step ms, kernel ms, idle share
    and peak GiB are printed side by side. Returns the FSDP2 window's launches by
    tower and its steps."""
    from open_clip_tpu_torch.parallel.mesh import create_mesh, shard_model

    mesh = create_mesh(data=1, fsdp=1, device="cuda")
    runs, tally_fsdp = {}, None
    for label in ("plain", "fsdp"):
        torch.cuda.reset_peak_memory_stats()
        model = oc.create_model("ViT-B-32", precision="amp_bf16", seed=0)
        lv, lt = model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers
        on_mesh = mesh if label == "fsdp" else None
        if on_mesh is not None:
            shard_model(model, mesh)
        optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                        model, oc.const_lr(5e-4, 0))
        state = oc.create_train_state(model, optimizer)
        step = oc.make_train_step(model.cfg, optimizer, mesh=on_mesh)
        batch = train_batch(torch, model.cfg, BATCH, "cuda")
        state, warm, *_ = run_steps(torch, step, state, batch, 2)
        reset_counts(sa, fl)
        with tally_by_shape(sa, fl) as tally:
            state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch,
                                                                         DIST_STEPS)
        counts = {"fwd": sa.LAUNCHES["fwd"], "bwd": sa.LAUNCHES["bwd"]}
        bodies = {"fwd": dict(sa.FWD_BODIES), "bwd": dict(sa.BWD_BODIES)}
        if label == "fsdp":
            tally_fsdp = dict(tally)
        losses = [float(m["loss"]) for m in warm + window]
        check(all(math.isfinite(x) for x in losses),
              f"dist_train[{label}]: {len(losses)} losses finite")
        n = DIST_STEPS
        check(counts == {"fwd": (lv + lt) * n, "bwd": (lv + lt) * n}
              and bodies["fwd"] == bodies["bwd"] == {"mma": (lv + lt) * n, "simt": 0},
              f"dist_train[{label}]: short launches {counts}, by body {bodies} in {n} steps "
              f"(expect {lv + lt} forward and backward a step, as phase 4, all mma)")
        state, prof = profiled_steps(torch, step, state, batch)
        accum = oc.make_train_step(model.cfg, optimizer, mesh=on_mesh, accum_steps=2)
        state, accum_metrics, *_ = run_steps(torch, accum, state, batch, 1)  # warm-up
        reset_counts(sa)
        state, window_metrics, accum_ms, *_ = run_steps(torch, accum, state, batch,
                                                        DIST_ACCUM_STEPS)
        accum_losses = [float(m["loss"]) for m in accum_metrics + window_metrics]
        # GradCache: phase 1 and phase 2 each run both microbatches' forwards
        want = {"fwd": 4 * (lv + lt) * DIST_ACCUM_STEPS, "bwd": 2 * (lv + lt) * DIST_ACCUM_STEPS}
        check(dict(sa.LAUNCHES) == want and all(math.isfinite(x) for x in accum_losses),
              f"dist_train[{label}] accum_steps=2: short launches {dict(sa.LAUNCHES)} in "
              f"{DIST_ACCUM_STEPS} steps (expect {want}), losses {accum_losses}")
        runs[label] = {
            "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
            "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
            "host_lead_ms_at_end": lead_ms, "images_per_s": BATCH * n / wall_s,
            "kernel_ms_per_step": prof["device_busy_ms_per_step"],
            "device_idle_share": prof["device_idle_share"],
            "kernel_launches_per_step": prof["kernel_launches_per_step"],
            "class_ms_per_step": prof["class_ms_per_step"],
            "accum_median_step_ms": statistics.median(accum_ms),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "losses": losses, "accum_losses": accum_losses,
            "short_launches_per_step": {k: v / n for k, v in counts.items()}}
        del state, optimizer, step, accum, model
        torch.cuda.empty_cache()
    plain, fsdp = runs["plain"], runs["fsdp"]
    diff = max(abs(a - b) for a, b in zip(plain["losses"] + plain["accum_losses"],
                                          fsdp["losses"] + fsdp["accum_losses"]))
    check(diff <= DIST_STEP_TOL,
          f"dist_train: FSDP2 losses {[round(x, 4) for x in fsdp['losses']]} vs plain "
          f"{[round(x, 4) for x in plain['losses']]} and GradCache {fsdp['accum_losses']} vs "
          f"{plain['accum_losses']}: max |diff| {diff:.3g} (<= {DIST_STEP_TOL})")
    print("dist_train " + json.dumps({"model": "ViT-B-32", "precision": "amp_bf16",
                                      "batch": BATCH, "mesh": {"data": 1, "fsdp": 1},
                                      "backend": "nccl", "window_steps": DIST_STEPS,
                                      "max_loss_diff": diff, **runs}), flush=True)
    return tally_fsdp, DIST_STEPS


def phase_dist_cli():
    """python -m open_clip_tpu_torch.train.main in a child process under a
    torchrun-style environment (RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR, a
    free MASTER_PORT): it joins an NCCL group of one, trains one epoch of ViT-B-32 b256
    synthetic batches, then a second through --resume latest."""
    import os

    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1")
    with tempfile.TemporaryDirectory() as logs:
        args = ["--model", "ViT-B-32", "--dataset-type", "synthetic", "--batch-size", str(BATCH),
                "--train-num-samples", str(BATCH * DIST_CLI_STEPS), "--precision", "amp_bf16",
                "--grad-clip-norm", "1.0", "--lr", "5e-4", "--wd", "0.2", "--warmup", "2",
                "--log-every-n-steps", "1", "--log-metric-every-n-steps", "1", "--workers", "1",
                "--logs", logs, "--name", "dist"]
        run = Path(logs) / "dist"
        outs = []
        for extra in (["--epochs", "1"], ["--epochs", "2", "--resume", "latest"]):
            env["MASTER_PORT"] = str(free_port())
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "open_clip_tpu_torch.train.main",
                                   *args, *extra], env=env, cwd=Path(__file__).resolve().parent,
                                  capture_output=True, text=True, timeout=300)
            outs.append((proc, time.perf_counter() - t0))
            nccl = "backend=nccl" in proc.stderr  # the CLI logs the group's backend
            check(proc.returncode == 0 and nccl,
                  f"dist_cli {' '.join(extra)}: exit {proc.returncode}, NCCL group {nccl}"
                  + (f"\n{proc.stderr[-3000:]}" if proc.returncode else ""))
        rows = [json.loads(x) for x in (run / "results.jsonl").read_text().splitlines()] \
            if (run / "results.jsonl").exists() else []
        steps = [r["step"] for r in rows]
        check(steps == list(range(1, 2 * DIST_CLI_STEPS + 1))
              and all(abs(r["train/loss"] - math.log(BATCH)) < 1e-2 for r in rows),
              f"dist_cli: steps {steps} over two runs, losses "
              f"{[round(r['train/loss'], 4) for r in rows]} (ln {BATCH} on identical samples)")
        check((run / "checkpoints" / "epoch_1.pt").exists()
              and (run / "checkpoints" / "epoch_2.pt").exists()
              and "world_size: 1" in (run / "params.txt").read_text(),
              "dist_cli: epoch_1.pt, epoch_2.pt and params.txt written")
        # each child's wall seconds: start-up, the group, the model, its steps, a checkpoint
        print("dist_cli " + json.dumps({"steps_per_epoch": DIST_CLI_STEPS,
                                        "run_s": [t for _, t in outs]}), flush=True)


ASSETS = Path(__file__).resolve().parent / "tests" / "assets_torch"
DATA_SHARDS, DATA_PER_SHARD = 16, 512  # 8,192 image-caption pairs: 32 steps at b256
DATA_VAL_PAIRS = 2048
DATA_CLASSES, DATA_PER_CLASS = 10, 50
# the strict canvas's bound against PIL (tests/test_native_decode.py), and the
# fractional bound, both of the JAX package's tests
STRICT_MAX = 2
FRACTIONAL_MEAN, FRACTIONAL_MAX = 3.0, 64
CROP_TOL = 1e-5


def load_assets():
    """The committed JPEGs and their canvases (tests/assets_torch)."""
    sys.path.insert(0, str(ASSETS))
    import make_assets

    canv = make_assets.load_canvases()
    datas = [(ASSETS / name).read_bytes() for name in canv["names"]]
    return datas, canv, make_assets.ROW_STEP


def phase_decode(torch):
    """The native decode stage on the card's host: what the machine has, the build,
    the committed assets against their canvases, and the decode rate by thread count."""
    import glob
    import os

    from open_clip_tpu_torch.native import decode as nd

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    libs = sorted(p for d in ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib",
                              "/usr/local/lib") for p in glob.glob(f"{d}/libjpeg.so*"))
    has_header = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                                input="#include <jpeglib.h>\n", text=True,
                                capture_output=True).returncode == 0
    nvjpeg_h = (nd._cuda_home() / "include" / "nvjpeg.h").exists()
    nvjpeg_libs = sorted(os.path.basename(p) for p in glob.glob(
        str(nd._cuda_home() / "lib64" / "libnvjpeg.so*")))
    t0 = time.perf_counter()
    name = nd.decoder()
    nd.load()
    build_s = time.perf_counter() - t0
    print("decode_host " + json.dumps({
        "gxx": (gxx.stdout.splitlines() or ["none"])[0], "jpeglib_h": has_header,
        "libjpeg_so": libs, "nvjpeg_h": nvjpeg_h, "libnvjpeg_so": nvjpeg_libs,
        "cpu_count": os.cpu_count(), "decoder": name, "build_s": build_s,
        "build_command": " ".join(nd._command(name, "<lib>"))}), flush=True)

    datas, canv, step = load_assets()
    rows = []
    for i, data in enumerate(datas):
        row = {"name": canv["names"][i]}
        for mode in ("strict", "fractional"):
            out, status = nd.decode_resize_one(data, 256, fractional=mode == "fractional")
            check(status == 0, f"decode {row['name']} ({mode}): status {status}")
            for ref in ("strict", "fractional"):
                d = (out[::step].astype(int) - canv[ref][i].astype(int)).__abs__()
                row[f"{mode}_vs_{ref}"] = {"max": int(d.max()), "mean": float(d.mean())}
        rows.append(row)
    print("decode_agreement " + json.dumps(rows), flush=True)
    for row in rows:
        s, f = row["strict_vs_strict"], row["fractional_vs_strict"]
        if name == "libjpeg":
            check(s["max"] <= STRICT_MAX, f"decode {row['name']} strict vs the strict canvas: "
                  f"max {s['max']} (<= {STRICT_MAX})")
        # nvJPEG decodes at full scale in both modes; the fractional bound holds either
        for mode in (("strict", "fractional") if name == "nvjpeg" else ("fractional",)):
            d = row[f"{mode}_vs_strict"]
            if name == "libjpeg" and d["max"] <= STRICT_MAX:
                continue
            check(d["mean"] < FRACTIONAL_MEAN and d["max"] < FRACTIONAL_MAX,
                  f"decode {row['name']} {mode} ({name}) vs the strict canvas: mean "
                  f"{d['mean']:.3f} (< {FRACTIONAL_MEAN}), max {d['max']} (< {FRACTIONAL_MAX})")
    full_decode_check(torch, nd, datas)
    bad, status = nd.decode_resize_one(b"definitely not a jpeg", 64)
    check(status != 0 and not bad.any(), f"decode of bad bytes: status {status}, zeros")
    gray = datas[2]  # the grayscale asset
    out, status = nd.decode_resize_one(gray, 64)
    check(status == 0 and int((out.max(-1).astype(int) - out.min(-1)).max()) == 0,
          "decode of the grayscale asset: R = G = B")

    batch = [datas[i % len(datas)] for i in range(BATCH)]
    rates = {}
    for threads in sorted({1, 4, os.cpu_count() or 1}):
        nd.decode_resize_batch(batch[:16], 256, threads)  # warm the threads' decoders
        reps, t0 = 0, time.perf_counter()
        while reps < 2 or time.perf_counter() - t0 < 1.0:
            _, status = nd.decode_resize_batch(batch, 256, threads)
            reps += 1
        rates[threads] = BATCH * reps / (time.perf_counter() - t0)
        check(not any(status), f"decode batch of {BATCH} on {threads} threads: all status 0")
    mix = sum(len(d) for d in batch) / len(batch)
    print("decode_rate " + json.dumps({
        "decoder": name, "canvas": 256, "fractional": True, "batch": BATCH,
        "mean_jpeg_bytes": mix, "images_per_s_by_threads": rates}), flush=True)
    return name, rates


def full_decode_check(torch, nd, datas):
    """The full-resolution decode that NaFlex data takes on the card, against the
    committed whole-image decodes of the assets (libjpeg, equal to PIL's): on the
    libjpeg route bit for bit; on nvJPEG's within the canvases' bound for another
    decoder (mean < FRACTIONAL_MEAN, max < FRACTIONAL_MAX levels). Then, on nvJPEG's
    route, a decode into memory that a kernel queued on the allocating stream still
    reads and writes: it must wait for that kernel and equal the idle card's decode."""
    import hashlib

    import make_assets

    ref = make_assets.load_full_decodes()
    route = nd.full_decode_route("cuda")
    images, status = nd.decode_full_batch(datas, 4, device="cuda")
    torch.cuda.synchronize()
    check(not any(status), f"full decode of the assets by route {route}: all status 0")
    rows = []
    for i, image in enumerate(images):
        host = torch.as_tensor(image).cpu().numpy()
        want = ref["rows"][i]
        check(host[::make_assets.FULL_ROW_STEP].shape == want.shape,
              f"full decode {ref['names'][i]}: shape {host.shape}")
        d = abs(host[::make_assets.FULL_ROW_STEP].astype(int) - want.astype(int))
        same = hashlib.sha256(host.tobytes()).hexdigest() == ref["sha256"][i]
        rows.append({"name": ref["names"][i], "shape": list(host.shape), "max": int(d.max()),
                     "mean": float(d.mean()), "bit_equal": same})
    print("full_decode_agreement " + json.dumps({"route": route, "row_step":
                                                 make_assets.FULL_ROW_STEP, "images": rows}),
          flush=True)
    for row in rows:
        if route == "libjpeg-host":
            check(row["bit_equal"], f"full decode {row['name']} ({route}) equals the committed "
                  "decode bit for bit")
        else:
            check(row["mean"] < FRACTIONAL_MEAN and row["max"] < FRACTIONAL_MAX,
                  f"full decode {row['name']} ({route}) vs the committed libjpeg decode: mean "
                  f"{row['mean']:.3f} (< {FRACTIONAL_MEAN}), max {row['max']} "
                  f"(< {FRACTIONAL_MAX}) levels")
    if route != "nvjpeg-device":
        return
    idle = images[4]
    side = torch.cuda.Stream()
    # twice: a kernel's first launch in the process loads its module, which waits for
    # the card and would hide a decode that does not wait
    for trial in range(2):
        with torch.cuda.stream(side):  # the only blocks of this stream's pool are ours
            x = torch.full(idle.shape, 7, dtype=torch.uint8, device="cuda")
            ptr = x.data_ptr()
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the card, queued before x's uses
            total = x.sum(dtype=torch.int64)
            x.add_(1)
            del x
            t0 = time.perf_counter()
            raced, status = nd.decode_full_batch([datas[4]], 1, device="cuda")
            call_ms = (time.perf_counter() - t0) * 1e3
            side.synchronize()
        check(status == [0] and raced[0].data_ptr() == ptr and total.item() == 7 * idle.numel()
              and torch.equal(raced[0], idle),
              f"full decode into memory freed on the host while a queued kernel reads and "
              f"writes it (trial {trial}, the call {call_ms:.1f} ms): the same block, the "
              "kernel's sum unchanged, the image equal to the idle card's")
        del raced


def tar_member(name: str, data: bytes):
    import io
    import tarfile

    info = tarfile.TarInfo(name)
    info.size = len(data)
    return info, io.BytesIO(data)


def write_data(root: Path, datas, classnames):
    """Tar shards of the committed JPEGs (no encoder on the card: each asset repeats
    under a distinct key and caption), a val shard and a class folder."""
    import tarfile

    classes = list(classnames[:DATA_CLASSES])
    k = 0
    for s in range(DATA_SHARDS):
        with tarfile.open(root / f"{s:05d}.tar", "w") as tf:
            for _ in range(DATA_PER_SHARD):
                tf.addfile(*tar_member(f"s{k:07d}.jpg", datas[k % len(datas)]))
                caption = f"a photo of a {classes[k % DATA_CLASSES]}, number {k}"
                tf.addfile(*tar_member(f"s{k:07d}.txt", caption.encode()))
                k += 1
    with tarfile.open(root / "val.tar", "w") as tf:
        for i in range(DATA_VAL_PAIRS):
            tf.addfile(*tar_member(f"v{i:07d}.jpg", datas[(7 * i) % len(datas)]))
            tf.addfile(*tar_member(f"v{i:07d}.txt", f"a picture of item {i}".encode()))
    for c in range(DATA_CLASSES):
        cdir = root / "imagenet" / f"n{c:08d}"
        cdir.mkdir(parents=True)
        for i in range(DATA_PER_CLASS):
            (cdir / f"{i:04d}.jpg").write_bytes(datas[(c + i) % len(datas)])


def phase_data_train(torch, oc, sa, fl, synthetic: dict):
    """The slice's main path: ViT-B-32 b256 trained by the CLI from JPEG tar shards
    (decoded by the native stage, RandomResizedCrop and normalization on the card),
    then evaluated on a val shard and a class folder."""
    import os

    import open_clip_tpu_torch.train.main as main_mod
    from open_clip_tpu_torch.train import train_loop, zero_shot

    datas, _, _ = load_assets()
    threads = os.cpu_count() or 1
    steps_expected = DATA_SHARDS * DATA_PER_SHARD // BATCH
    rec = {"steps": [], "pp": [], "launches": []}
    timing, towers = {}, {}

    def wrap_pp(make):
        def make_(*a, **k):
            fn = make(*a, **k)

            def fn_(gen, images):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(gen, images)
                ev[1].record()
                rec["pp"].append(ev)
                return out
            return fn_
        return make_

    def wrap_step(make):
        def make_(*a, **k):
            fn = make(*a, **k)

            def fn_(state, batch):
                before, by_tower = dict(sa.LAUNCHES), dict(tally)
                t = time.perf_counter()
                out = fn(state, batch)
                rec["steps"].append((t, time.perf_counter()))
                rec["launches"].append({k: sa.LAUNCHES[k] - before[k] for k in before})
                for key, v in tally.items():
                    towers[key] = towers.get(key, 0) + v - by_tower.get(key, 0)
                return out
            return fn_
        return make_

    def timed_call(key, fn):
        def fn_(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                timing[key] = timing.get(key, 0.0) + time.perf_counter() - t
        return fn_

    saved = (main_mod.make_device_train_preprocess, main_mod.make_train_step, main_mod.evaluate,
             zero_shot.build_zero_shot_classifier, zero_shot.run_zero_shot_classifier,
             zero_shot.zero_shot_eval)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_data(root, datas, oc.IMAGENET_CLASSNAMES)
        write_s = time.perf_counter() - t0
        args = ["--model", "ViT-B-32", "--train-data", str(root / "{00000..00015}.tar"),
                "--dataset-type", "webdataset", "--device-preprocess",
                "--native-decode-threads", str(threads), "--batch-size", str(BATCH),
                "--precision", "amp_bf16", "--lr", "5e-4", "--wd", "0.2", "--grad-clip-norm", "1.0",
                "--epochs", "1", "--val-data", str(root / "val.tar"),
                "--imagenet-val", str(root / "imagenet"), "--zeroshot-frequency", "1",
                "--log-every-n-steps", "8", "--log-metric-every-n-steps", "8",
                "--logs", str(root / "logs"), "--name", "data"]
        main_mod.make_device_train_preprocess = wrap_pp(saved[0])
        main_mod.make_train_step = wrap_step(saved[1])
        main_mod.evaluate = timed_call("evaluate_s", saved[2])
        zero_shot.build_zero_shot_classifier = timed_call("classifier_build_s", saved[3])
        zero_shot.run_zero_shot_classifier = timed_call("zero_shot_s", saved[4])
        zero_shot.zero_shot_eval = timed_call("zero_shot_eval_s", saved[5])
        try:
            t0 = time.perf_counter()
            with tally_by_shape(sa, fl) as tally:
                state = main_mod.main(args)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            (main_mod.make_device_train_preprocess, main_mod.make_train_step, main_mod.evaluate,
             zero_shot.build_zero_shot_classifier, zero_shot.run_zero_shot_classifier,
             zero_shot.zero_shot_eval) = saved
        rows = [json.loads(x) for x in (root / "logs" / "data" / "results.jsonl").read_text()
                .splitlines()]
    train_rows = [r for r in rows if "train/loss" in r]
    val = next((r for r in rows if "val/clip_val_loss" in r), {})
    n = len(rec["steps"])
    check(state.step == steps_expected == n,
          f"data_train: {state.step} steps in the epoch (expect {steps_expected} = "
          f"{DATA_SHARDS * DATA_PER_SHARD} // {BATCH})")
    losses = [r["train/loss"] for r in train_rows]
    check(bool(losses) and all(math.isfinite(x) for x in losses),
          f"data_train: losses finite {[round(x, 4) for x in losses]}")
    lv, lt = 12, 12
    per_step = [(d["fwd"], d["bwd"]) for d in rec["launches"]]
    check(all(p == (lv + lt, lv + lt) for p in per_step),
          f"data_train: short-attention launches a step {sorted(set(per_step))} "
          f"(expect ({lv + lt}, {lv + lt}))")
    keys = ["val/clip_val_loss", "val/image_to_text_R@1", "val/text_to_image_R@1",
            "val/image_to_text_mean_rank", "val/imagenet-zeroshot-val-top1",
            "val/imagenet-zeroshot-val-top5", "val/num_samples", "val/epoch"]
    check(all(k in val and math.isfinite(val[k]) for k in keys),
          f"data_train: results.jsonl holds the val and zero-shot keys {keys}")
    check(val.get("val/num_samples") == DATA_VAL_PAIRS,
          f"data_train: val over {val.get('val/num_samples')} pairs (expect {DATA_VAL_PAIRS})")
    check(val.get("val/image_to_text_R@1", 1.0) <= 0.05,
          f"data_train: R@1 {val.get('val/image_to_text_R@1')} near chance for random weights")
    # the loop's meters are running means; rows at steps 9, 17, 25 give steps 9-24
    by_step = {r["step"]: r for r in train_rows}
    a, b = by_step.get(9), by_step.get(25)
    meters = {}
    if a and b:
        meters = {"host_data_ms_per_step": 1e3 * (b["train/data_time"] * 25 - a["train/data_time"] * 9) / 16,
                  "host_batch_ms_per_step": 1e3 * (b["train/batch_time"] * 24 - a["train/batch_time"] * 8) / 16,
                  "meter_steps": "9-24"}
    starts = [t for t, _ in rec["steps"]]
    period = [1e3 * (y - x) for x, y in zip(starts[8:], starts[9:])]
    pp_ms = [e[0].elapsed_time(e[1]) for e in rec["pp"]]
    step_ms = statistics.median(period) if period else float("nan")
    summary = dict(meters, **{
        "model": "ViT-B-32", "batch": BATCH, "decode_threads": threads, "steps": n,
        "shards": DATA_SHARDS, "pairs": DATA_SHARDS * DATA_PER_SHARD, "write_data_s": write_s,
        "run_s": run_s, "median_step_ms": step_ms, "images_per_s": BATCH * 1e3 / step_ms,
        "median_host_ms_in_step": statistics.median(1e3 * (e - s) for s, e in rec["steps"][8:]),
        "crop_normalize_device_ms_per_step": statistics.median(pp_ms[8:]) if pp_ms else None,
        "short_launches_per_step": {"fwd": per_step[0][0], "bwd": per_step[0][1]} if per_step else None,
        "synthetic_step_ms_library": synthetic.get("median_step_ms"),
        "synthetic_cli_host_batch_ms": synthetic.get("cli_host_batch_ms"),
        "eval_s": timing.get("evaluate_s"), "classifier_build_s": timing.get("classifier_build_s"),
        "zero_shot_s": timing.get("zero_shot_s"),
        "val_retrieval_s": (timing.get("evaluate_s", 0) - timing.get("zero_shot_eval_s", 0)),
        "first_loss": losses[0] if losses else None, "last_loss": losses[-1] if losses else None,
        "val": {k[4:]: v for k, v in val.items() if k != "step"}})
    print("data_train " + json.dumps(summary), flush=True)
    return towers, n


def phase_data_card_vs_cpu(torch, oc):
    """fp32, TF32 off: the device train preprocess at the same boxes, and
    make_eval_step on ViT-B-32 at b32, card against CPU."""
    from open_clip_tpu_torch import transform as tr
    from open_clip_tpu_torch.train.train_loop import make_eval_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tr.PreprocessCfg(size=224)
    gen = torch.Generator().manual_seed(5)
    canvases = torch.randint(0, 256, (BATCH, 256, 256, 3), dtype=torch.uint8, generator=gen)
    boxes = tr.make_crop_param_sampler(256, (0.5, 1.0), (3 / 4, 4 / 3))(gen, BATCH)
    outs = []
    for device in ("cuda", "cpu"):
        fixed = tuple(v.to(device) for v in boxes)
        pp = tr.make_device_train_preprocess(cfg, sampler=lambda g, n, f=fixed: f)
        outs.append(pp(torch.Generator(device=device), canvases.to(device)).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    check(outs[0].shape == (BATCH, 224, 224, 3) and err <= CROP_TOL,
          f"device train preprocess card vs CPU at the same boxes, b{BATCH}: max abs {err:.2e} "
          f"(<= {CROP_TOL})")
    # its device time at b256 (fp32, TF32 off) and the kernels it runs
    from torch.profiler import ProfilerActivity, profile

    fixed = tuple(v.cuda() for v in boxes)
    pp = tr.make_device_train_preprocess(cfg, sampler=lambda g, n: fixed)
    gen_c, canv_c = torch.Generator(device="cuda"), canvases.cuda()
    for _ in range(3):
        pp(gen_c, canv_c)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        pp(gen_c, canv_c)
    ev[1].record()
    ev[1].synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pp(gen_c, canv_c)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:8]
    flops = 2 * BATCH * 224 * 256 * 256 * 3 + 2 * BATCH * 224 * 224 * 256 * 3
    print("crop_profile " + json.dumps({
        "batch": BATCH, "canvas": 256, "size": 224, "ms": ev[0].elapsed_time(ev[1]) / 10,
        **bound(BATCH * 256 * 256 * 3 + BATCH * 224 * 224 * 3 * 4, flops, "float32"),
        "kernels_us": {e.key[:80]: e.device_time_total for e in top}}), flush=True)

    gpu = oc.create_model("ViT-B-32", precision="fp32", seed=3)
    cpu = oc.create_model("ViT-B-32", precision="fp32", seed=3, device="cpu")
    images = tr.make_device_preprocess(cfg)(canvases[:32])
    texts = torch.randint(1, 49000, (images.shape[0], 77), generator=gen)
    step = make_eval_step()
    rg = step(gpu, {"image": images.cuda(), "text": texts.cuda()})
    rc = step(cpu, {"image": images, "text": texts})
    for key in ("primary_features", "text_features"):
        cos = torch.nn.functional.cosine_similarity(rg[key].cpu().double(), rc[key].double(),
                                                    dim=-1).min().item()
        check(cos >= COSINE_MIN, f"make_eval_step {key} card vs CPU fp32 b32: min cosine "
              f"{cos:.7f} (>= {COSINE_MIN})")
    rel = abs(float(rg["loss"]) - float(rc["loss"])) / abs(float(rc["loss"]))
    check(rel <= 1e-4, f"make_eval_step loss card vs CPU fp32: {float(rg['loss']):.6f} vs "
          f"{float(rc['loss']):.6f} (relative {rel:.2e} <= 1e-4)")



# ---------------------------------------------------------------------------
# starting from a checkpoint: reference files written from the port's seeded models
# ---------------------------------------------------------------------------

FT_CLI_STEPS = 16
FT_LOCK = {"lock_image": True, "lock_image_unlocked_groups": 2}
FT_LAYER_DECAY = 0.75


def state_diff(torch, got: dict, want: dict) -> list:
    """The names where two state dicts differ in a bit, dtype or shape (or one lacks)."""
    bad = sorted(set(got) ^ set(want))
    for k in sorted(set(got) & set(want)):
        a = got[k].detach()
        b = want[k].detach().to(a.device)
        if a.dtype != b.dtype or not torch.equal(a, b):
            bad.append(k)
    return bad


def file_mb(path) -> float:
    path = Path(path)
    files = path.iterdir() if path.is_dir() else [path]
    return sum(p.stat().st_size for p in files) / 2 ** 20


def load_split(torch, oc, ck, path: str, name: str = "ViT-B-32", pretrained=None) -> dict:
    """Seconds of each part of loading ``path`` (read, convert and merge on the CPU,
    copy to the card), timed one by one with the factory's own functions, then the
    whole ``create_model_and_transforms(name, pretrained)`` call (the seed init and
    the pure_bf16 cast too)."""
    model = oc.create_model("ViT-B-32", precision="fp32", device="cpu", seed=1)
    t0 = time.perf_counter()
    sd = ck.read_state_dict(path)
    t1 = time.perf_counter()
    ck.merge_params_(model, ck.checkpoint_to_params(sd, model.cfg))
    t2 = time.perf_counter()
    model.to("cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del sd, model
    t4 = time.perf_counter()
    loaded, _, pp = oc.create_model_and_transforms(name, pretrained=pretrained,
                                                   precision="pure_bf16")
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    return {"read_s": t1 - t0, "convert_s": t2 - t1, "copy_to_card_s": t3 - t2,
            "create_model_and_transforms_s": t5 - t4, "model": loaded, "preprocess": pp}


def phase_pretrained_load(torch, oc, sa, tmp: Path):
    """pretrained_load: ViT-B-32 (seed 0) written as a local-dir: directory through
    save_for_hf, as a .pt wrapped as {"state_dict": {"module." + k: v}} and as a bare
    .bin; each loaded through create_model_and_transforms in pure_bf16 must equal the
    source bit for bit, and one serves phase 2's b256 request with the source's
    features, bit for bit, at 12 + 12 short launches."""
    from open_clip_tpu_torch import checkpoint as ck
    from open_clip_tpu_torch.convert import reference_state_dict

    src = oc.create_model("ViT-B-32", precision="fp32", device="cpu", seed=0)
    ref = reference_state_dict(src)
    paths = {"pt": tmp / "vit_b32.pt", "bin": tmp / "open_clip_pytorch_model.bin",
             "local_dir": tmp / "vit_b32_dir"}
    torch.save({"state_dict": {"module." + k: v for k, v in ref.items()}}, paths["pt"])
    torch.save(ref, paths["bin"])
    oc.save_for_hf(src, paths["local_dir"])
    del src, ref
    want = oc.create_model("ViT-B-32", precision="pure_bf16", seed=0)
    line, served = {}, None
    for fmt, path in paths.items():
        if fmt == "local_dir":
            split = load_split(torch, oc, ck, str(path / "open_clip_model.safetensors"),
                               name="local-dir:" + str(path))
        else:
            split = load_split(torch, oc, ck, str(path), pretrained=str(path))
        model, preprocess = split.pop("model"), split.pop("preprocess")
        bad = state_diff(torch, model.state_dict(), want.state_dict())
        check(not bad, f"pretrained_load {fmt}: {len(model.state_dict())} tensors equal the "
              f"source's bit for bit (differ: {bad[:5]})")
        line[fmt] = {"file_mb": file_mb(path), **split}
        if fmt == "pt":
            served = (model, preprocess)
        else:
            del model
    model, preprocess = served
    tokenizer = oc.get_tokenizer("ViT-B-32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (BATCH, *IMAGE_HW, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    feats = []
    with torch.inference_mode():
        for m in (model, want):
            reset_counts(sa)
            with tally_by_len(sa) as tally:
                clf = oc.build_zero_shot_classifier(m, tokenizer, oc.IMAGENET_CLASSNAMES[:CLASSES],
                                                    oc.SIMPLE_IMAGENET_TEMPLATES,
                                                    num_classes_per_batch=CLASSES)
                f = m.encode_image(preprocess(images), normalize=True)
                torch.cuda.synchronize()
            feats.append((clf, f, dict(sa.LAUNCHES), dict(tally)))
    (clf_l, f_l, launches, tally), (clf_s, f_s, _, _) = feats
    check(torch.equal(f_l, f_s) and torch.equal(clf_l, clf_s) and bool(torch.isfinite(f_l).all()),
          "pretrained_load: the loaded model's b256 request features and classifier equal the "
          "source's bit for bit")
    check(launches == {"fwd": 24, "bwd": 0} and tally == {("fwd", 50): 12, ("fwd", 77): 12},
          f"pretrained_load: short launches {launches}, by length {tally}, for one classifier "
          "and one request (expect 12 at L=50 and 12 at L=77)")
    print("pretrained_load " + json.dumps(line), flush=True)
    return {"vision": tally[("fwd", 50)], "text": tally[("fwd", 77)]}


def phase_pretrained_resize(torch, oc, sa, tmp: Path):
    """pretrained_resize: the 224-px checkpoint loaded at force_image_size=256 (grid 7
    -> 8) and force_context_length=64; b256 served, short launches counted by length
    (L = 65 image, 64 text); fp32 (TF32 off) card features against the CPU's."""
    path = str(tmp / "vit_b32.pt")
    force = {"force_image_size": 256, "force_context_length": 64}
    model, _, preprocess = oc.create_model_and_transforms("ViT-B-32", pretrained=path,
                                                          precision="pure_bf16", **force)
    tokenizer = oc.get_tokenizer("ViT-B-32", context_length=64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (BATCH, *IMAGE_HW, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    with torch.inference_mode():
        reset_counts(sa)
        with tally_by_len(sa) as tally:
            clf = oc.build_zero_shot_classifier(model, tokenizer, oc.IMAGENET_CLASSNAMES[:CLASSES],
                                                oc.SIMPLE_IMAGENET_TEMPLATES,
                                                num_classes_per_batch=CLASSES)
            feats = model.encode_image(preprocess(images), normalize=True)
            top5 = (feats.float() @ clf.float()).topk(5, dim=-1).indices.cpu()
        tally = dict(tally)
    check(tally == {("fwd", 65): 12, ("fwd", 64): 12} and tuple(top5.shape) == (BATCH, 5)
          and bool(torch.isfinite(feats).all()),
          f"pretrained_resize: short launches by length {tally} (expect 12 at L=65, 12 at "
          f"L=64), features finite, top-5 {tuple(top5.shape)}")
    del model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = oc.create_model("ViT-B-32", pretrained=path, precision="fp32", **force)
    cpu = oc.create_model("ViT-B-32", pretrained=path, precision="fp32", device="cpu", **force)
    small = torch.randint(0, 256, (4, *IMAGE_HW, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    texts = tokenizer(["a photo of a cat.", "a diagram", "a dog", ""])
    pp = oc.make_device_preprocess(cpu.preprocess_cfg)
    with torch.inference_mode():
        pairs = (("encode_image", gpu.encode_image(pp(small.cuda()), normalize=True).cpu(),
                  cpu.encode_image(pp(small), normalize=True)),
                 ("encode_text", gpu.encode_text(texts, normalize=True).cpu(),
                  cpu.encode_text(texts, normalize=True)))
    cosines = {}
    for name, a, b in pairs:
        cos = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()
        cosines[name] = cos
        check(bool(torch.isfinite(a).all()) and cos >= COSINE_MIN,
              f"pretrained_resize {name} card vs CPU fp32: min cosine {cos:.7f} (>= {COSINE_MIN})")
    print("pretrained_resize " + json.dumps({
        "image_size": 256, "context_length": 64, "launches_by_len": {f"{k[0]}@{k[1]}": v
                                                                     for k, v in tally.items()},
        "min_cosine_fp32": cosines}), flush=True)
    return tally[("fwd", 65)], tally[("fwd", 64)]


def big_vision_arrays(torch, model) -> dict:
    """The big_vision SigLIP ``.npz`` arrays of a port ViT SigLIP model: the inverse of
    ``convert.big_vision_to_params`` (fused qkv split into per-head (W, H, hd) q/k/v,
    the MAP head, ``t`` and ``b``)."""
    import numpy as np

    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    vcfg, tcfg = model.visual.cfg, model.cfg.text_cfg
    out = {}

    def mha(prefix, q_k, q_b, k_k, k_b, v_k, v_b, o_k, o_b, heads):
        width = q_k.shape[0]
        for n, k, b in (("query", q_k, q_b), ("key", k_k, k_b), ("value", v_k, v_b)):
            out[f"{prefix}{n}/kernel"] = k.reshape(width, heads, -1)
            out[f"{prefix}{n}/bias"] = b.reshape(heads, -1)
        out[f"{prefix}out/kernel"] = o_k.reshape(heads, -1, o_k.shape[-1])
        out[f"{prefix}out/bias"] = o_b

    def tower(src, dst, layers, heads):
        for i in range(layers):
            s, d = f"{src}transformer.resblocks.{i}.", f"{dst}encoderblock_{i}/"
            qkv, bqkv = sd[s + "attn.in_proj_weight"].T, sd[s + "attn.in_proj_bias"]
            w = qkv.shape[0]
            mha(d + "MultiHeadDotProductAttention_0/", qkv[:, :w], bqkv[:w], qkv[:, w:2 * w],
                bqkv[w:2 * w], qkv[:, 2 * w:], bqkv[2 * w:], sd[s + "attn.out_proj.weight"].T,
                sd[s + "attn.out_proj.bias"], heads)
            for j, ln in ((0, "ln_1"), (1, "ln_2")):
                out[f"{d}LayerNorm_{j}/scale"] = sd[f"{s}{ln}.weight"]
                out[f"{d}LayerNorm_{j}/bias"] = sd[f"{s}{ln}.bias"]
            for j, fc in ((0, "c_fc"), (1, "c_proj")):
                out[f"{d}MlpBlock_0/Dense_{j}/kernel"] = sd[f"{s}mlp.{fc}.weight"].T
                out[f"{d}MlpBlock_0/Dense_{j}/bias"] = sd[f"{s}mlp.{fc}.bias"]

    w = vcfg.width
    out["img/embedding/kernel"] = sd["visual.conv1.weight"].reshape(
        vcfg.patch_size, vcfg.patch_size, 3, w)
    out["img/embedding/bias"] = sd["visual.conv1.bias"]
    out["img/pos_embedding"] = sd["visual.positional_embedding"][None]
    out["img/Transformer/encoder_norm/scale"] = sd["visual.ln_post.weight"]
    out["img/Transformer/encoder_norm/bias"] = sd["visual.ln_post.bias"]
    tower("visual.", "img/Transformer/", vcfg.layers, vcfg.heads)
    p, bp = "visual.attn_pool.", "img/MAPHead_0/"
    out[bp + "probe"] = sd[p + "latent"].reshape(1, 1, w)
    kv, bkv = sd[p + "kv.weight"].T, sd[p + "kv.bias"]
    mha(bp + "MultiHeadDotProductAttention_0/", sd[p + "q.weight"].T, sd[p + "q.bias"],
        kv[:, :w], bkv[:w], kv[:, w:], bkv[w:], sd[p + "proj.weight"].T, sd[p + "proj.bias"],
        vcfg.heads)
    out[bp + "LayerNorm_0/scale"], out[bp + "LayerNorm_0/bias"] = sd[p + "norm.weight"], sd[p + "norm.bias"]
    for j, fc in ((0, "c_fc"), (1, "c_proj")):
        out[f"{bp}MlpBlock_0/Dense_{j}/kernel"] = sd[f"{p}mlp.{fc}.weight"].T
        out[f"{bp}MlpBlock_0/Dense_{j}/bias"] = sd[f"{p}mlp.{fc}.bias"]
    out["txt/Embed_0/embedding"] = sd["token_embedding.weight"]
    out["txt/pos_embedding"] = sd["positional_embedding"][None]
    out["txt/Encoder_0/encoder_norm/scale"] = sd["ln_final.weight"]
    out["txt/Encoder_0/encoder_norm/bias"] = sd["ln_final.bias"]
    tower("", "txt/Encoder_0/", tcfg.layers, tcfg.heads)
    out["txt/head/kernel"], out["txt/head/bias"] = sd["text_projection.weight"].T, sd["text_projection.bias"]
    out["t"], out["b"] = sd["logit_scale"].reshape(1), sd["logit_bias"].reshape(1)
    return out


def phase_siglip_big_vision(torch, oc, sa, tmp: Path):
    """siglip_big_vision: a big_vision .npz synthesized from ViT-B-16-SigLIP (seed 0),
    with and without the params/ root, loaded by load_big_vision_weights into a seed-1
    model: the state dict equals the source's bit for bit; b256 served with short
    launches at L = 196 and 64."""
    import numpy as np

    from open_clip_tpu_torch.convert import load_big_vision_weights

    src = oc.create_model(SIGLIP_MODEL, precision="fp32", device="cpu", seed=0)
    arrays = big_vision_arrays(torch, src)
    want = src.state_dict()
    line, model = {}, None
    for root in ("", "params/"):
        path = tmp / f"siglip_{root.strip('/') or 'bare'}.npz"
        np.savez(path, **{root + k: v for k, v in arrays.items()})
        target = oc.create_model(SIGLIP_MODEL, precision="fp32", device="cpu", seed=1)
        t0 = time.perf_counter()
        load_big_vision_weights(target, path)
        t1 = time.perf_counter()
        bad = state_diff(torch, target.state_dict(), want)
        check(not bad, f"siglip_big_vision root {root or '(none)'!r}: {len(want)} tensors equal "
              f"the source's bit for bit (differ: {bad[:5]})")
        line[root or "bare"] = {"file_mb": file_mb(path), "load_s": t1 - t0}
        path.unlink()
        model = target
    del src, arrays, want
    # served as create_model serves pure_bf16: cast after the load
    model = oc.convert_params_dtype_(model, torch.bfloat16).to("cuda")
    model.compute_dtype = torch.bfloat16
    preprocess = oc.make_device_preprocess(model.preprocess_cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (BATCH, *IMAGE_HW, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    with torch.inference_mode():
        reset_counts(sa)
        with tally_by_len(sa) as tally:
            clf = oc.build_zero_shot_classifier(model, seeded_token_ids(torch, model.cfg.text_cfg, 0),
                                                oc.IMAGENET_CLASSNAMES[:CLASSES],
                                                oc.SIMPLE_IMAGENET_TEMPLATES,
                                                num_classes_per_batch=CLASSES)
            feats = model.encode_image(preprocess(images), normalize=True)
            probs = torch.sigmoid(model.logit_scale.float().exp() * feats.float() @ clf.float()
                                  + model.logit_bias.float())
            torch.cuda.synchronize()
        tally = dict(tally)
    check(tally == {("fwd", 196): 12, ("fwd", 64): 12} and bool(torch.isfinite(probs).all()),
          f"siglip_big_vision: short launches by length {tally} (expect 12 at L=196, 12 at "
          "L=64), sigmoid probabilities finite")
    print("siglip_big_vision " + json.dumps(line), flush=True)
    return tally[("fwd", 196)], tally[("fwd", 64)]


def phase_finetune(torch, oc, sa, fl, tmp: Path, plain: dict):
    """finetune: ViT-B-32 b256 amp_bf16 from the .pt, the image tower locked but for
    its head and last block (unlocked groups 2), layer decay 0.75, AdamW (lr 5e-4, wd
    0.2, clip 1.0). Library steps on phase 4's random batch (timed beside phase 4's
    plain step, 24 + 24 short launches a step: the locked tower still runs its
    backward), then the CLI for 16 steps on synthetic data, then a --pretrained-image
    load at --seed 1: locked tensors keep the checkpoint's bits, the rest moves."""
    from open_clip_tpu_torch.train import optim
    from open_clip_tpu_torch.train.main import main as train_main

    path = str(tmp / "vit_b32.pt")
    source = oc.create_model("ViT-B-32", precision="fp32", device="cpu", seed=0).state_dict()
    model = oc.create_model("ViT-B-32", pretrained=path, precision="amp_bf16")
    opt_cfg = oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0, layer_decay=FT_LAYER_DECAY)
    optimizer = optim.create_optimizer(opt_cfg, model, oc.const_lr(5e-4, 0),
                                       num_layers=model.cfg.vision_cfg.layers)
    mask = optim.trainable_mask(model, **FT_LOCK)
    optimizer = optim.apply_trainable_mask(optimizer, mask)
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer)
    batch = train_batch(torch, model.cfg, BATCH, "cuda")
    state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
    n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
    reset_counts(sa, fl)
    with tally_by_shape(sa, fl) as tally:
        state, window, step_ms, host_ms, _, wall_s = run_steps(torch, step, state, batch, n)
    tally = dict(tally)
    state, prof = profiled_steps(torch, step, state, batch)
    last = model.cfg.vision_cfg.layers - 1

    def moved_locked(got):
        got = {k: v.detach().float().cpu() for k, v in got.items()}
        locked = [k for k, m in mask.items() if m == 0.0]
        kept = [k for k in locked if not torch.equal(got[k], source[k])]
        probe = ("visual.ln_post.weight", "visual.proj",
                 f"visual.transformer.resblocks.{last}.mlp.c_fc.weight",
                 "transformer.resblocks.0.attn.in_proj_weight", "token_embedding.weight")
        still = [k for k in probe if torch.equal(got[k], source[k])]
        return locked, kept, still

    locked, changed, still = moved_locked(state.model.state_dict())
    losses = [float(m["loss"]) for m in warm + window]
    check(bool(locked) and not changed and not still and all(math.isfinite(x) for x in losses),
          f"finetune steps: {len(locked)} locked image tensors keep the checkpoint's bits "
          f"(changed: {changed[:3]}); ln_post, proj, the last image block and the text tower "
          f"moved (did not: {still}); {len(losses)} losses finite")
    check(tally.get(("fwd", "vision"), 0) == 12 * n and tally.get(("bwd", "vision"), 0) == 12 * n
          and tally.get(("fwd", "text"), 0) == 12 * n and tally.get(("bwd", "text"), 0) == 12 * n,
          f"finetune steps: short launches {tally} in {n} steps (expect 12 + 12 of each "
          "direction a step: the locked tower runs its backward)")
    # the same model and batch under the plain optimizer (its own moments) and the
    # fine-tune one, in turns, so that the two step times compare within one phase
    plain_opt = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0), model,
                                    oc.const_lr(5e-4, 0))
    states = {"plain": oc.create_train_state(model, plain_opt), "finetune": state}
    steps = {"plain": oc.make_train_step(model.cfg, plain_opt), "finetune": step}
    states["plain"] = run_steps(torch, steps["plain"], states["plain"], batch, 2)[0]
    turns = {"plain": {"step": [], "host": []}, "finetune": {"step": [], "host": []}}
    for which in ("plain", "finetune", "finetune", "plain"):
        states[which], _, t_ms, h_ms, _, _ = run_steps(torch, steps[which], states[which], batch, n)
        turns[which]["step"] += t_ms
        turns[which]["host"] += h_ms
    line = {"window_steps": n, "median_step_ms": statistics.median(step_ms),
            "median_host_ms_per_step": statistics.median(host_ms),
            "kernel_ms_per_step": prof["device_busy_ms_per_step"],
            "phase4_plain_median_step_ms": plain["median_step_ms"],
            "phase4_plain_kernel_ms_per_step": plain["kernel_ms_per_step"],
            "turns_median_step_ms": {k: statistics.median(v["step"]) for k, v in turns.items()},
            "turns_median_host_ms_per_step": {k: statistics.median(v["host"])
                                              for k, v in turns.items()},
            "first_loss": losses[0], "last_loss": losses[-1], "images_per_s": BATCH * n / wall_s}
    del state, states, steps, model, optimizer, plain_opt, batch

    with tempfile.TemporaryDirectory(dir=tmp) as logs:
        def cli_args(steps, name):
            return ["--model", "ViT-B-32", "--dataset-type", "synthetic", "--batch-size",
                    str(BATCH), "--train-num-samples", str(BATCH * steps), "--precision",
                    "amp_bf16", "--wd", "0.2", "--grad-clip-norm", "1.0", "--warmup", "4",
                    "--epochs", "1", "--workers", "1", "--log-every-n-steps", "8", "--logs", logs,
                    "--name", name]

        reset_counts(sa)
        with tally_by_shape(sa, fl) as cli_tally:
            t0 = time.perf_counter()
            state = train_main(cli_args(FT_CLI_STEPS, "ft") + [
                "--lr", "5e-4", "--pretrained", path, "--lock-image",
                "--lock-image-unlocked-groups", "2", "--layer-decay", str(FT_LAYER_DECAY)])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        cli_tally = dict(cli_tally)
        locked, changed, still = moved_locked(state.model.state_dict())
        # identical synthetic samples: the gradients vanish, so only the weight decay
        # moves the trainable 2-D weights (ln_post has none)
        still = [k for k in still if k != "visual.ln_post.weight"]
        check(state.step == FT_CLI_STEPS and not changed and not still,
              f"finetune CLI: {state.step} steps; {len(locked)} locked image tensors keep the "
              f"checkpoint's bits (changed: {changed[:3]}); proj, the last image block and "
              f"the text tower moved (did not: {still})")
        expect = 12 * FT_CLI_STEPS
        check(all(cli_tally.get((d, t), 0) == expect for d in ("fwd", "bwd")
                  for t in ("vision", "text")),
              f"finetune CLI: short launches {cli_tally} in {FT_CLI_STEPS} steps (expect "
              f"{expect} of each)")
        del state
        # one step at lr 0: the weights stay as loaded
        state = train_main(cli_args(1, "img") + ["--pretrained-image", path, "--seed", "1",
                                                 "--lr", "0"])
        seed1 = oc.create_model("ViT-B-32", precision="fp32", device="cpu", seed=1).state_dict()
        got = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
        vis = state_diff(torch, {k: v for k, v in got.items() if k.startswith("visual.")},
                         {k: v for k, v in source.items() if k.startswith("visual.")})
        txt = state_diff(torch, {k: v for k, v in got.items() if not k.startswith("visual.")},
                         {k: v for k, v in seed1.items() if not k.startswith("visual.")})
        check(not vis and not txt,
              f"finetune --pretrained-image: the image tower equals the checkpoint's (differ: "
              f"{vis[:3]}), the text tower the --seed 1 init's (differ: {txt[:3]})")
    line.update({"cli_steps": FT_CLI_STEPS, "cli_s": cli_s,
                 "cli_launches_per_step": {f"{k[0]}_{k[1]}": v / FT_CLI_STEPS
                                           for k, v in cli_tally.items() if k[0] != "ln"}})
    print("finetune " + json.dumps(line), flush=True)
    return tally, n, cli_tally


def modern_token_ids(torch, text_cfg, seed):
    """A stand-in for the tiktoken tokenizer of the modern text towers, whose
    vocabulary is not in the repository: per text a seeded row of 8-40 random ids, the
    EOS id, then the pad id up to the context length."""
    gen = torch.Generator().manual_seed(seed)
    eos, pad, ctx = text_cfg.eos_id, text_cfg.pad_id, text_cfg.context_length

    def tokenize(texts):
        out = torch.full((len(texts), ctx), pad, dtype=torch.long)
        for i in range(len(texts)):
            n = int(torch.randint(8, 41, (1,), generator=gen))
            out[i, :n] = torch.randint(0, eos, (n,), generator=gen)
            out[i, n] = eos
        return out

    return tokenize


def nfc_clips(n, seed):
    """n clips of 0.1 * N(0, 1) noise at 48 kHz, their lengths uniform in NFC_SECONDS."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [((0.1 * rng.standard_normal(int(sec * CLAP_RATE))).astype(np.float32), CLAP_RATE)
            for sec in rng.uniform(*NFC_SECONDS, n)]


def nfc_tokens(samples: int, acfg) -> int:
    """The patch count of a clip of ``samples`` at the model's rate: frames of the
    reflect-padded STFT, whole time patches, times the frequency rows."""
    frames = 1 + samples // acfg.hop_size
    return (acfg.mel_bins // acfg.patch_freq) * math.ceil(frames / acfg.patch_time)


def phase_naflexclap_serve(torch, oc, sa, fa):
    """The NaFlex-audio CLAP serving main path: 64 clips a request patchified on the
    host (AudioNaFlexPatchify, padded to 816 tokens), copied from pinned memory,
    encode_audio (the trunk's 20 blocks on the flash forward with the clips' key
    validity), logits against a 10-class classifier from seeded token ids, top-5.
    Returns the flash forward launches, the encode_audio calls that made them and the
    first request's patch dicts (CPU tensors)."""
    from open_clip_tpu_torch.data.audio import collate_audio
    from open_clip_tpu_torch.train.audio_zero_shot import ESC50_TEMPLATES

    torch.cuda.reset_peak_memory_stats()
    model, _, pp = oc.create_model_and_transforms(NFC_MODEL, precision="pure_bf16", seed=0)
    acfg, depth = model.cfg.audio_cfg, model.audio.encoder.tcfg.depth
    tokenize = modern_token_ids(torch, model.cfg.text_cfg, seed=0)
    requests = [nfc_clips(NFC_BATCH, seed=i) for i in range(2)]
    with torch.inference_mode():
        reset_counts(sa, fa)
        clf = oc.build_zero_shot_classifier(model, tokenize, ESC50_CLASSES, ESC50_TEMPLATES,
                                            num_classes_per_batch=len(ESC50_CLASSES))
        torch.cuda.synchronize()
        text_launches = (dict(sa.LAUNCHES), dict(fa.LAUNCHES))
        clf32 = clf.float()

        def request(i):
            t0 = time.perf_counter()
            batch = collate_audio([pp(c) for c in requests[i % 2]])
            host_ms = (time.perf_counter() - t0) * 1e3
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            audio = {k: v.pin_memory().to("cuda", non_blocking=True) for k, v in batch.items()}
            ev[1].record()
            feats = model.encode_audio(audio, normalize=True)
            top5 = (100.0 * feats.float() @ clf32).topk(5, dim=-1).indices
            ev[2].record()
            return batch, feats, top5.cpu(), host_ms, ev  # .cpu(): one request in flight

        t0 = time.perf_counter()
        first_batch = request(0)[0]
        first_ms = (time.perf_counter() - t0) * 1e3
        lat, host, copy, device = [], [], [], []
        for i in range(1, 1 + NFC_SERVE_REQUESTS):
            t0 = time.perf_counter()
            batch, feats, top5, host_ms, ev = request(i)
            lat.append((time.perf_counter() - t0) * 1e3)
            host.append(host_ms)
            copy.append(ev[0].elapsed_time(ev[1]))
            device.append(ev[1].elapsed_time(ev[2]))
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(NFC_PROFILED):
                request(i)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        calls = 1 + NFC_SERVE_REQUESTS + NFC_PROFILED
    want_valid = [min(NFC_SEQ, nfc_tokens(len(w), acfg)) for w, _ in requests[0]]
    got_valid = first_batch["patch_valid"].sum(dim=1).tolist()
    check(tuple(first_batch["patches"].shape) == (NFC_BATCH, NFC_SEQ, acfg.patch_freq * acfg.patch_time)
          and got_valid == want_valid and max(got_valid) <= NFC_SEQ,
          f"naflexclap patchify: patches {tuple(first_batch['patches'].shape)}, valid tokens "
          f"{min(got_valid)}..{max(got_valid)} of {NFC_SEQ}, each the clip's own count")
    check(text_launches == ({"fwd": 0, "bwd": 0}, {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}),
          f"naflexclap classifier: the modern text tower is dense (short {text_launches[0]}, "
          f"flash {text_launches[1]})")
    check(fa.LAUNCHES == {"fwd": depth * calls, "bwd_dq": 0, "bwd_dkv": 0}
          and fa.FWD_BODIES == {"wgmma": depth * calls, "simt": 0},
          f"naflexclap requests: flash launches {fa.LAUNCHES}, forward by body {fa.FWD_BODIES} "
          f"for {calls} encode_audio calls (expect {depth} wgmma forwards each, no backward)")
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(tuple(feats.shape) == (NFC_BATCH, model.cfg.embed_dim) and bool(torch.isfinite(feats).all())
          and bool(((fn - 1).abs() < 1e-2).all()) and tuple(top5.shape) == (NFC_BATCH, 5)
          and int(top5.min()) >= 0 and int(top5.max()) < len(ESC50_CLASSES),
          f"naflexclap request output: features {tuple(feats.shape)} finite and unit, "
          f"top-5 {tuple(top5.shape)}")
    summary = profile_summary(prof, prof_wall_ms, NFC_PROFILED)
    print("naflexclap_serve " + json.dumps({
        "model": NFC_MODEL, "precision": "pure_bf16", "batch": NFC_BATCH, "seq_len": NFC_SEQ,
        "clip_seconds": list(NFC_SECONDS), "valid_tokens_mean": sum(got_valid) / len(got_valid),
        "first_request_ms": first_ms, "requests": len(lat),
        "median_request_ms": statistics.median(lat),
        "clips_per_s": NFC_BATCH * len(lat) / (sum(lat) / 1e3),
        "median_host_patchify_ms": statistics.median(host),
        "host_patchify_ms_per_clip": statistics.median(host) / NFC_BATCH,
        "median_copy_ms": statistics.median(copy),
        "median_device_ms_encode_logits": statistics.median(device),
        "flash_fwd_launches_per_request": fa.LAUNCHES["fwd"] / calls,
        "kernel_ms_per_request": summary["device_busy_ms_per_request"],
        "class_ms_per_request": summary["class_ms_per_request"],
        "device_idle_share": summary["device_idle_share"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    print("naflexclap_profile " + json.dumps(summary), flush=True)
    return fa.LAUNCHES["fwd"], calls, first_batch


def phase_naflexclap_train(torch, oc, sa, fa, audio):
    """The NaFlex-audio CLAP training main path: batch 64 of the serving request's patch
    dicts and seeded token rows, amp_bf16, AdamW with clipping; the trunk's 20 blocks
    on the three flash kernels a step. Returns the window's flash launches and steps."""
    torch.cuda.reset_peak_memory_stats()
    model = oc.create_model(NFC_MODEL, precision="amp_bf16", seed=0)
    depth = model.audio.encoder.tcfg.depth
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-4, wd=0.2, grad_clip_norm=1.0),
                                    model, oc.const_lr(1e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer)
    text = modern_token_ids(torch, model.cfg.text_cfg, seed=1)(range(NFC_BATCH))
    batch = {"audio": {k: v.to("cuda") for k, v in audio.items()}, "text": text.to("cuda")}
    state, warm, warm_ms, *_ = run_steps(torch, step, state, batch, 2)
    # at least NFC_MIN_WINDOW steps: from random weights at this lr the loss on the fixed
    # batch rises for its first ~5 steps and falls after, so the check below reads the
    # same steps whatever the host's pace
    n = max(NFC_MIN_WINDOW, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
    reset_counts(sa, fa)
    state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
    flash, short = dict(fa.LAUNCHES), dict(sa.LAUNCHES)
    fwd_bodies, bwd_bodies = dict(fa.FWD_BODIES), dict(fa.BWD_BODIES)
    losses = [float(m["loss"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses), f"naflexclap_train: {len(losses)} losses finite")
    check(losses[-1] < losses[0], f"naflexclap_train: loss fell on the fixed batch, "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps")
    check(flash == {"fwd": depth * n, "bwd_dq": depth * n, "bwd_dkv": depth * n}
          and fwd_bodies == {"wgmma": depth * n, "simt": 0}
          and bwd_bodies == {"wgmma": depth * n, "simt": 0} and short == {"fwd": 0, "bwd": 0},
          f"naflexclap_train: flash launches {flash}, forward by body {fwd_bodies}, backward "
          f"passes by body {bwd_bodies}, short {short} in {n} steps (expect {depth * n} of each "
          "flash kernel, all wgmma, no short launch: the text tower is dense)")
    state, prof_summary = profiled_steps(torch, step, state, batch)
    print("naflexclap_train_profile " + json.dumps(prof_summary), flush=True)
    print("naflexclap_train " + json.dumps({
        "model": NFC_MODEL, "precision": "amp_bf16", "batch": NFC_BATCH, "seq_len": NFC_SEQ,
        "valid_tokens_mean": float(audio["patch_valid"].sum(dim=1).float().mean()),
        "window_steps": n, "window_s": wall_s, "clips_per_s": NFC_BATCH * n / wall_s,
        "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
        "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
        "host_lead_ms_at_end": lead_ms, "first_loss": losses[0], "last_loss": losses[-1],
        "device_busy_ms_per_step": prof_summary["device_busy_ms_per_step"],
        "device_idle_share": prof_summary["device_idle_share"],
        "flash_launches_per_step": {k: v / n for k, v in flash.items()},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    del state, model, optimizer, batch
    torch.cuda.empty_cache()
    return flash, n


def phase_naflexclap_card_vs_cpu(torch, oc, fa):
    """fp32, TF32 off: the NaFlex-audio CLAP at full width with 2 layers a tower, a
    10 s and a 4.3 s clip (816 tokens, one of them ragged): features and every
    gradient of the contrastive loss, the card (the flash kernels' CUDA-core bodies
    with the key validity) against the CPU (the dense bias)."""
    from open_clip_tpu_torch.data.audio import collate_audio
    from open_clip_tpu_torch.factory import naflex_audio_preprocess

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = json.loads(json.dumps(oc.get_model_config(NFC_MODEL)))
    raw["audio_cfg"]["naflexvit_cfg"]["depth"] = 2
    raw["text_cfg"]["layers"] = 2
    name = NFC_MODEL + "-2layer"
    oc.add_model_config(raw, name=name)
    import numpy as np

    rng = np.random.default_rng(9)
    clips = [((0.1 * rng.standard_normal(int(sec * CLAP_RATE))).astype(np.float32), CLAP_RATE)
             for sec in (10.0, 4.3)]
    pp = naflex_audio_preprocess(oc.CLIPModelCfg.from_dict(raw).audio_cfg)
    audio = collate_audio([pp(c) for c in clips])
    text = modern_token_ids(torch, oc.CLIPModelCfg.from_dict(raw).text_cfg, seed=2)(range(2))
    results, feats = {}, {}
    for device in ("cuda", "cpu"):
        model = oc.create_model(name, precision="fp32", seed=3, device=device)
        batch = {k: v.to(device) for k, v in audio.items()}
        reset_counts(fa)
        with torch.inference_mode():
            feats[device] = model.encode_audio(batch, normalize=True).cpu()
        out = oc.clip_forward(model, batch, text.to(device))
        loss = oc.clip_loss(out["audio_features"], out["text_features"], model.logit_scale.exp())
        loss.backward()
        results[device] = ({k: p.grad.detach().cpu().double() for k, p in model.named_parameters()
                            if p.grad is not None}, loss.item())
        if device == "cuda":
            launched = (dict(fa.LAUNCHES), dict(fa.FWD_BODIES), dict(fa.BWD_BODIES))
        del model, out, loss
    check(launched == ({"fwd": 4, "bwd_dq": 2, "bwd_dkv": 2}, {"wgmma": 0, "simt": 4},
                       {"wgmma": 0, "simt": 2}),
          f"naflexclap fp32 card run: flash launches, forward and backward by body {launched} "
          "(2 serving, 2 in the training forward, 2 backward passes, all CUDA-core)")
    cos = torch.nn.functional.cosine_similarity(feats["cuda"].double(), feats["cpu"].double(),
                                                dim=-1).min().item()
    check(bool(torch.isfinite(feats["cuda"]).all()) and cos >= COSINE_MIN,
          f"naflexclap encode_audio card vs CPU fp32 (valid {audio['patch_valid'].sum(1).tolist()} "
          f"of {NFC_SEQ}): min cosine {cos:.7f} (>= {COSINE_MIN})")
    grads_card_vs_cpu(torch, results, "naflexclap")


def wav_bytes(wav, sr: int) -> bytes:
    """A RIFF WAV of (T,) or (T, C) int16 (PCM) or float32 (IEEE float) samples."""
    import struct

    channels = 1 if wav.ndim == 1 else wav.shape[1]
    width = wav.dtype.itemsize
    tag = 3 if wav.dtype.kind == "f" else 1
    data = wav.astype(wav.dtype.newbyteorder("<")).tobytes()
    fmt = struct.pack("<HHIIHH", tag, channels, sr, sr * channels * width, channels * width, 8 * width)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data))
            + data)


def seeded_wav(rng, seconds, sr, channels, kind, freq):
    """A tone and noise, (T,) or (T, channels), int16 or float32."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.standard_normal(t.shape)
    x = np.stack([x, 0.5 * x], axis=1) if channels == 2 else x
    return (x * 32767).astype(np.int16) if kind == "int16" else x.astype(np.float32)


def phase_audio_data_train(torch, oc, sa, fa):
    """Real audio through the CLI: naflexclap_mediumd (the CLIP BPE text tower, 252
    audio tokens: the trunk's dense path) trained one epoch from 4 WAV tar shards
    (16, 44.1 and 48 kHz, mono and stereo, int16 and float32, 1-5 s), the zero-shot
    split of a 10-class WAV folder after it; then an evaluation-only run on the folder."""
    import tarfile

    import numpy as np

    from open_clip_tpu_torch.train.main import main as train_main

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(7)
        t0 = time.perf_counter()
        k = 0
        for s in range(NFC_DATA_SHARDS):
            with tarfile.open(root / f"{s:05d}.tar", "w") as tf:
                for _ in range(NFC_DATA_PER_SHARD):
                    sr, channels = (16000, 44100, 48000)[k % 3], 1 + (k // 3) % 2
                    kind = ("int16", "float32")[(k // 6) % 2]
                    wav = seeded_wav(rng, rng.uniform(1.0, 5.0), sr, channels, kind, 150 + 10 * (k % 50))
                    tf.addfile(*tar_member(f"a{k:06d}.wav", wav_bytes(wav, sr)))
                    tf.addfile(*tar_member(f"a{k:06d}.txt", f"the sound of item {k}".encode()))
                    k += 1
        for ci, cls in enumerate(ESC50_CLASSES):
            (root / "zs" / cls).mkdir(parents=True)
            for i in range(2):
                wav = seeded_wav(rng, 2.0, (16000, 48000)[i], 1, "int16", 200 + 120 * ci)
                (root / "zs" / cls / f"{i}.wav").write_bytes(wav_bytes(wav, (16000, 48000)[i]))
        write_s = time.perf_counter() - t0
        n = NFC_DATA_SHARDS * NFC_DATA_PER_SHARD
        steps = n // NFC_DATA_BATCH
        args = ["--model", NFC_DATA_MODEL, "--dataset-type", "webdataset-audio",
                "--train-data", f"{root}/{{00000..{NFC_DATA_SHARDS - 1:05d}}}.tar",
                "--train-num-samples", str(n), "--batch-size", str(NFC_DATA_BATCH), "--epochs", "1",
                "--precision", "amp_bf16", "--lr", "1e-4", "--wd", "0.2", "--grad-clip-norm", "1.0",
                "--warmup", "1", "--audio-ext", "wav", "--audio-zeroshot-dataset", str(root / "zs"),
                "--log-every-n-steps", "1", "--workers", "1", "--logs", str(root / "logs"),
                "--name", "audio"]
        reset_counts(sa, fa)
        t0 = time.perf_counter()
        state = train_main(args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        rows = [json.loads(x) for x in (root / "logs" / "audio" / "results.jsonl").read_text().splitlines()]
        train_rows = [r for r in rows if "train/loss" in r]
        evals = [r for r in rows if "val/audio-zeroshot-top1" in r]
        layers = state.model.cfg.text_cfg.layers
        check(state.step == steps and len(train_rows) == steps
              and all(math.isfinite(r["train/loss"]) for r in train_rows),
              f"audio_data_train: {state.step} steps from the WAV shards, losses "
              f"{[round(r['train/loss'], 4) for r in train_rows]}")
        check(sa.LAUNCHES["bwd"] == layers * steps and sa.LAUNCHES["fwd"] >= layers * steps
              and fa.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0},
              f"audio_data_train: short launches {sa.LAUNCHES} (the text tower, {layers} a step "
              f"and the classifier), flash {fa.LAUNCHES} (252 audio tokens: the dense path)")
        check(len(evals) == 1 and 0.0 <= evals[0]["val/audio-zeroshot-top1"]
              <= evals[0]["val/audio-zeroshot-top5"] <= 1.0,
              f"audio_data_train: the zero-shot split after the epoch {evals}")
        t0 = time.perf_counter()
        metrics = train_main(["--model", NFC_DATA_MODEL, "--audio-zeroshot-dataset",
                              f"folder:{root / 'zs'}", "--batch-size", "20", "--precision", "amp_bf16",
                              "--logs", str(root / "logs"), "--name", "zs"])
        torch.cuda.synchronize()
        zs_s = time.perf_counter() - t0
        check(0.0 <= metrics.get("audio-zeroshot-top1", -1) <= metrics.get("audio-zeroshot-top5", -1)
              <= 1.0, f"audio zero-shot CLI on the WAV folder: {metrics}")
        later = train_rows[1:] or train_rows
        print("audio_data_train " + json.dumps({
            "model": NFC_DATA_MODEL, "batch": NFC_DATA_BATCH, "steps": steps, "write_s": write_s,
            "train_run_s": run_s,
            "median_step_ms": 1e3 * statistics.median(r["train/batch_time"] for r in later),
            "median_host_data_ms": 1e3 * statistics.median(r["train/data_time"] for r in later),
            "zero_shot_run_s": zs_s, "zero_shot_clips": 2 * len(ESC50_CLASSES),
            "zero_shot_top1": metrics.get("audio-zeroshot-top1"),
            "zero_shot_top5": metrics.get("audio-zeroshot-top5")}), flush=True)


# ---------------------------------------------------------------------------
# NaFlex training from tar shards, the other optimizers, patch dropout, dots remat
# ---------------------------------------------------------------------------

NFD_SHARDS, NFD_PER_SHARD, NFD_PNG_EVERY = 16, 48, 6  # 768 pairs, every 6th a PNG
NFD_SEQS, NFD_MAX_TOKENS, NFD_EPOCHS, NFD_THREADS = (256, 576, 1024), 16384, 2, 4
NFD_PROFILED = 3  # steps of the second epoch under the profiler
OPTIMIZERS = ("adamw", "nadamw", "lion", "sgd", "lamb", "adafactor", "muon")
OPT_WINDOW_S, OPT_PROFILED, OPT_CPU_STEPS, OPT_CPU_BATCH = 0.5, 2, 2, 2
# the card's optimizer against the CPU's on the same gradients: each entry within
# OPT_ENTRY_TOL of its tensor's largest change in the 3 steps (fp32 arithmetic in other
# orders: the clip's global norm, adafactor's means; lamb's norms are summed in
# float64) plus OPT_ULPS units in the last place of the parameter (each step's p + u
# rounds once, and an update that differs in its last bits can round the other way).
# Lion takes the sign of (1 - b1) g + b1 m, which those last bits flip where it
# cancels: it is held to the share of its entries beyond the bound. Muon's
# Newton-Schulz runs in bfloat16 (as JAX's does), and the card and the CPU round its
# products at other points, which ill-conditioned leaves (a stacked L x D vector)
# amplify: it is held per entry with the iteration in float32 on both sides
# (muon_fp32_ns), to OPT_NS_TOL, the bound tests/test_torch_optimizers.py holds it to
# against JAX (15 float32 products over up to 3072 terms summed in other orders), and
# in bfloat16 by the cosine of the updates
OPT_ENTRY_TOL, OPT_NS_TOL, OPT_ULPS, OPT_LION_OFF = 1e-4, 1e-3, 3, 1e-6
PD_MODEL, PD_PROB = "ViT-B-16", 0.5
REMAT_POLICIES = ("none", "names_mm", "dots", "dots_no_batch")


def png_bytes(rgb) -> bytes:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG (zlib and struct; row y filtered
    with type y % 5: None, Sub, Up, Average, Paeth)."""
    import struct
    import zlib

    import numpy as np

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    h, w, _ = rgb.shape
    rows, out, prev = rgb.reshape(h, -1).astype(np.int64), [], None
    prev = np.zeros(w * 3, np.int64)
    for y, row in enumerate(rows):
        left = np.concatenate([np.zeros(3, np.int64), row[:-3]])
        up_left = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        p = left + prev - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        pred = [0, left, prev, (left + prev) // 2, paeth][y % 5]
        out.append(bytes([y % 5]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out), 6)) + chunk(b"IEND", b""))


def write_naflex_data(root: Path, datas) -> int:
    """NFD_SHARDS shards: the committed JPEGs under distinct keys, every
    NFD_PNG_EVERY-th sample a seeded PNG of its own size; captions of 1 to 12 words.
    Returns the PNG count."""
    import tarfile

    import numpy as np

    rng = np.random.default_rng(0)
    k = pngs = 0
    for s in range(NFD_SHARDS):
        with tarfile.open(root / f"{s:05d}.tar", "w") as tf:
            for _ in range(NFD_PER_SHARD):
                if k % NFD_PNG_EVERY == NFD_PNG_EVERY - 1:
                    h, w = (int(v) for v in rng.integers(160, 480, 2))
                    yy, xx = np.mgrid[0:h, 0:w]
                    rgb = np.stack([127 + 120 * np.sin(xx / 23.0 + c + k) * np.cos(yy / 17.0)
                                    for c in range(3)], -1).astype(np.uint8)
                    tf.addfile(*tar_member(f"s{k:07d}.png", png_bytes(rgb)))
                    pngs += 1
                else:
                    tf.addfile(*tar_member(f"s{k:07d}.jpg", datas[k % len(datas)]))
                words = " ".join(["photo"] * int(rng.integers(1, 13)))
                tf.addfile(*tar_member(f"s{k:07d}.txt", f"a {words} number {k}".encode()))
                k += 1
    return pngs


def naflex_route_check(torch, oc, root: Path) -> dict:
    """The first batch of the pipeline on the card's route (nvJPEG, resized on the
    card) against the CPU's (the host's decoder, nvJPEG where libjpeg is absent, then
    resized on the host): equal coordinates and validity, patches within the NaFlex
    transform's 2 levels (0.3 on average). ``full_decode_check`` holds nvJPEG's
    decode against libjpeg's."""
    from open_clip_tpu_torch.data.naflex import NaFlexDataConfig, NaFlexWdsPipeline
    from open_clip_tpu_torch.data.wds import WdsConfig, WdsPipeline

    tok = oc.get_tokenizer(NAFLEX_MODEL)
    cfg = NaFlexDataConfig(seq_lens=(576,), max_tokens_per_batch=NFD_MAX_TOKENS, seed=0)
    batches, secs = {}, {}
    for device in ("cuda", "cpu"):
        wcfg = WdsConfig(urls=str(root / "{00000..00001}.tar"), shuffle_shards=0,
                         shuffle_samples=0)
        pipe = NaFlexWdsPipeline(WdsPipeline(wcfg, None, tok), cfg, 1, tok, device=device,
                                 decode_threads=NFD_THREADS)
        t0 = time.perf_counter()
        batches[device] = (pipe.route, next(iter(pipe)))
        torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t0
    (card_route, card), (cpu_route, cpu) = batches["cuda"], batches["cpu"]
    level = 1 / 255 / 0.26
    diff = (card["image"]["patches"].cpu() - cpu["image"]["patches"]).abs()
    same = all(torch.equal(card["image"][k].cpu(), cpu["image"][k])
               for k in ("patch_coord", "patch_valid")) and torch.equal(card["text"], cpu["text"])
    check(card["image"]["patches"].device.type == "cuda" and same
          and diff.max().item() <= 2.01 * level and diff.mean().item() <= 0.3 * level,
          f"naflex_data_train: the first batch by route {card_route} (on the card) vs "
          f"{cpu_route}: coordinates, validity and tokens equal, patches max "
          f"{diff.max().item() / level:.3f} mean {diff.mean().item() / level:.4f} levels "
          "(tol 2, 0.3)")
    return {"card_route": card_route, "cpu_route": cpu_route,
            "max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
            "max_levels": diff.max().item() / level, "mean_levels": diff.mean().item() / level,
            "first_batch_s": secs, "batch": int(card["text"].shape[0])}


def phase_naflex_data_train(torch, oc, sa, fa):
    """naflex_ViT-B-16 at full width and depth trained by the CLI from tar shards of
    JPEGs and PNGs (webdataset-naflex, 256/576/1024 buckets in a 16384-token budget,
    length bucketing), amp_bf16, AdamW with --ema 0.999, 2 epochs, --save-most-recent
    and --delete-previous-checkpoint. Returns the flash launches by bucket and the
    text tower's short launches of the run, and its steps."""
    import os

    from torch.profiler import ProfilerActivity, profile

    import open_clip_tpu_torch.train.main as main_mod
    from open_clip_tpu_torch.data import naflex as nfdata
    from open_clip_tpu_torch.native import full_decode_route
    from open_clip_tpu_torch.train import train_step as ts_mod

    datas, _, _ = load_assets()
    rec = {"steps": [], "ema": [], "batch_ms": [], "prof": None}
    flash_by_bucket, short_total = {}, {"fwd": 0, "bwd": 0}
    saved = main_mod.make_train_step, ts_mod.update_ema_, nfdata.NaFlexWdsPipeline.__iter__

    def make_step(*a, **k):
        fn = saved[0](*a, **k)

        def step(state, batch):
            bucket = int(batch["image"]["patches"].shape[1])
            f0, s0 = dict(fa.LAUNCHES), dict(sa.LAUNCHES)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            i = len(rec["steps"])
            if i == nb + 4:  # the second epoch's fifth step
                rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
                rec["prof"].__enter__()
                rec["prof_t0"] = time.perf_counter()
            t = time.perf_counter()
            ev[0].record()
            out = fn(state, batch)
            ev[1].record()
            rec["steps"].append((bucket, int(batch["text"].shape[0]), t, time.perf_counter(), ev))
            counts = flash_by_bucket.setdefault(bucket, {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0})
            for key in counts:
                counts[key] += fa.LAUNCHES[key] - f0[key]
            for key in short_total:
                short_total[key] += sa.LAUNCHES[key] - s0[key]
            if i == nb + 4 + NFD_PROFILED - 1 and rec["prof"] is not None:
                torch.cuda.synchronize()
                rec["prof_wall_ms"] = (time.perf_counter() - rec["prof_t0"]) * 1e3
                rec["prof"].__exit__(None, None, None)
            return out
        return step

    def ema(e, p, d):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        saved[1](e, p, d)
        ev[1].record()
        rec["ema"].append(ev)

    def timed_iter(self):
        it = saved[2](self)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            rec["batch_ms"].append((time.perf_counter() - t) * 1e3)
            yield batch

    nb = NFD_SHARDS * NFD_PER_SHARD * NFD_SEQS[0] // NFD_MAX_TOKENS
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        pngs = write_naflex_data(root, datas)
        write_s = time.perf_counter() - t0
        route = naflex_route_check(torch, oc, root)
        args = ["--model", NAFLEX_MODEL,
                "--train-data", str(root / f"{{00000..{NFD_SHARDS - 1:05d}}}.tar"),
                "--dataset-type", "webdataset-naflex",
                "--naflex-seq-lens", *map(str, NFD_SEQS), "--naflex-max-tokens",
                str(NFD_MAX_TOKENS), "--length-bucketing", "--bucket-pool", "256",
                "--bucket-chunk", "32", "--train-num-samples", str(NFD_SHARDS * NFD_PER_SHARD),
                "--native-decode-threads", str(NFD_THREADS), "--batch-size", "16",
                "--precision", "amp_bf16", "--lr", "1e-4", "--wd", "0.2", "--warmup", "2",
                "--grad-clip-norm", "1.0", "--ema", "0.999", "--epochs", str(NFD_EPOCHS),
                "--save-most-recent", "--delete-previous-checkpoint",
                "--log-every-n-steps", "4", "--log-metric-every-n-steps", "1",
                "--logs", str(root / "logs"), "--name", "nfd"]
        main_mod.make_train_step = make_step
        ts_mod.update_ema_ = ema
        nfdata.NaFlexWdsPipeline.__iter__ = timed_iter
        reset_counts(sa, fa)
        try:
            t0 = time.perf_counter()
            state = main_mod.main(args)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            main_mod.make_train_step, ts_mod.update_ema_ = saved[:2]
            nfdata.NaFlexWdsPipeline.__iter__ = saved[2]
        ck = root / "logs" / "nfd" / "checkpoints"
        files = sorted(os.listdir(ck))
        link = os.readlink(ck / "epoch_latest.pt") if (ck / "epoch_latest.pt").is_symlink() else None
        rows = [json.loads(x) for x in (root / "logs" / "nfd" / "results.jsonl").read_text()
                .splitlines()]
    lv, lt = 12, 12
    n = len(rec["steps"])
    check(state.step == NFD_EPOCHS * nb == n,
          f"naflex_data_train: {state.step} steps over {NFD_EPOCHS} epochs (expect "
          f"{NFD_EPOCHS} x {nb})")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    check(bool(losses) and all(math.isfinite(x) for x in losses),
          f"naflex_data_train: {len(losses)} losses finite")
    check(files == [f"epoch_{NFD_EPOCHS}.pt", "epoch_latest.pt"]
          and link == f"epoch_{NFD_EPOCHS}.pt" and state.ema is not None,
          f"naflex_data_train: checkpoints {files}, epoch_latest -> {link}, EMA kept")
    buckets = sorted({b for b, *_ in rec["steps"]})
    per_step = {b: {k: v / sum(1 for x in rec["steps"] if x[0] == b) for k, v in c.items()}
                for b, c in flash_by_bucket.items()}
    want = {b: ({"fwd": lv, "bwd_dq": lv, "bwd_dkv": lv} if b >= 512 else
                {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}) for b in buckets}
    check(per_step == want and any(b >= 512 for b in buckets),
          f"naflex_data_train: flash launches a step by bucket {per_step} (expect {lv} of each "
          f"at 576 and 1024 with the key mask, none at 256, the dense path)")
    check(short_total == {"fwd": lt * n, "bwd": lt * n},
          f"naflex_data_train: short launches {short_total} in {n} steps (the text tower)")
    step_ms = {b: [] for b in buckets}
    images = 0
    for b, size, t, t_end, ev in rec["steps"][nb:]:  # the second epoch: no first-call work
        step_ms[b].append(ev[0].elapsed_time(ev[1]))
        images += size
    starts = [t for _, _, t, _, _ in rec["steps"][nb:]]
    wall_s = rec["steps"][-1][3] - starts[0]
    check(rec["prof"] is not None and "prof_wall_ms" in rec,
          f"naflex_data_train: steps {nb + 4}..{nb + 3 + NFD_PROFILED} profiled")
    prof_summary = profile_summary(rec["prof"], rec["prof_wall_ms"], NFD_PROFILED, "step")
    print("naflex_data_train_profile " + json.dumps(prof_summary), flush=True)
    ema_ms = [e[0].elapsed_time(e[1]) for e in rec["ema"]]
    data_rows = [r["train/data_time"] for r in rows if "train/data_time" in r]
    summary = {
        "model": NAFLEX_MODEL, "precision": "amp_bf16", "steps": n, "epochs": NFD_EPOCHS,
        "shards": NFD_SHARDS, "pairs": NFD_SHARDS * NFD_PER_SHARD, "pngs": pngs,
        "write_data_s": write_s, "run_s": run_s, "decode_route": full_decode_route("cuda"),
        "decode_threads": NFD_THREADS, "steps_by_bucket": {b: len(v) for b, v in step_ms.items()},
        "median_step_ms_by_bucket": {b: statistics.median(v) for b, v in step_ms.items() if v},
        "epoch2_wall_s": wall_s, "images_per_s_epoch2": images / wall_s,
        "host_data_ms_per_batch": statistics.median(rec["batch_ms"]),
        "host_data_ms_per_batch_max": max(rec["batch_ms"]),
        "loop_data_wait_s_mean": data_rows[-1] if data_rows else None,
        "device_busy_ms_per_step": prof_summary["device_busy_ms_per_step"],
        "device_idle_share": prof_summary["device_idle_share"],
        "profiled_buckets": [b for b, *_ in rec["steps"][nb + 4: nb + 4 + NFD_PROFILED]],
        "ema_device_ms_per_step": statistics.median(ema_ms[1:]) if len(ema_ms) > 1 else None,
        "flash_launches_per_step_by_bucket": per_step,
        "first_loss": losses[0] if losses else None, "last_loss": losses[-1] if losses else None,
        "checkpoints": files, "route_check": route}
    print("naflex_data_train " + json.dumps(summary), flush=True)
    return flash_by_bucket, short_total, n


def optimizer_state_gib(opt_state) -> float:
    return sum(t.numel() * t.element_size() for v in opt_state.values() if isinstance(v, list)
               for t in v) / 2 ** 30


def phase_optimizers(torch, oc, sa):
    """ViT-B-32 at batch 256, amp_bf16 (phase 4's recipe), one timed window per
    optimizer from the same weights: step ms, the optimizer's device ms a step (its
    update_ profiled alone on the step's gradients), its state's GiB and the peak;
    then each at 2 layers and full width in fp32: the card's update_ against the CPU's
    on the gradients of 3 CPU train steps (per tensor, the largest error relative to
    its largest change). Returns the short launches by tower and the
    steps of the windows."""
    from torch.profiler import ProfilerActivity, profile

    model = oc.create_model("ViT-B-32", precision="amp_bf16", seed=0)
    lv, lt = model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(torch, model.cfg, BATCH, "cuda")
    results, tally_all, steps_all = {}, {}, 0
    for name in OPTIMIZERS:
        with torch.no_grad():
            model.load_state_dict(init)
        torch.cuda.reset_peak_memory_stats()
        opt = oc.create_optimizer(oc.OptimizerCfg(opt=name, lr=5e-4, wd=0.2, grad_clip_norm=1.0,
                                                  momentum=0.9), model, oc.const_lr(5e-4, 0))
        state = oc.create_train_state(model, opt)
        step = oc.make_train_step(model.cfg, opt)
        state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
        n = max(3, math.ceil(OPT_WINDOW_S * 1e3 / warm_ms[-1]))
        reset_counts(sa)
        with tally_by_len(sa) as tally:
            state, window, step_ms, host_ms, _, wall_s = run_steps(torch, step, state, batch, n)
        for key, v in tally.items():
            tally_all[key] = tally_all.get(key, 0) + v
        steps_all += n
        losses = [float(m["loss"]) for m in warm + window]
        check(all(math.isfinite(x) for x in losses) and sa.LAUNCHES == {
            "fwd": (lv + lt) * n, "bwd": (lv + lt) * n},
              f"optimizers[{name}]: losses finite ({losses[0]:.4f} -> {losses[-1]:.4f}), short "
              f"launches {sa.LAUNCHES} in {n} steps")
        # the optimizer alone: update_ on gradients of this step's size, profiled
        grads = [torch.randn_like(p) * 1e-3 for p in state.params]
        with torch.no_grad():
            opt.update_(state.params, grads, state.opt_state)  # the profiler's own warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(OPT_PROFILED):
                opt.update_(state.params, grads, state.opt_state)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        ps = profile_summary(prof, prof_ms, OPT_PROFILED, "step")
        results[name] = {"median_step_ms": statistics.median(step_ms), "window_steps": n,
                         "images_per_s": BATCH * n / wall_s,
                         "median_host_ms_per_step": statistics.median(host_ms),
                         "optimizer_device_ms": ps["device_busy_ms_per_step"],
                         "optimizer_wall_ms": ps["wall_ms_per_step"],
                         "optimizer_launches": ps["kernel_launches_per_step"],
                         "optimizer_class_ms": ps["class_ms_per_step"],
                         "state_gib": optimizer_state_gib(state.opt_state),
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                         "first_loss": losses[0], "last_loss": losses[-1]}
        del state, opt, step, grads
    del model, init
    for key, err in optimizers_card_vs_cpu(torch, oc).items():
        name, ns, _ = key.partition("_fp32_ns")
        results[name]["card_vs_cpu" + ns] = err
    print("optimizers " + json.dumps({"model": "ViT-B-32", "precision": "amp_bf16",
                                      "batch": BATCH, "results": results}), flush=True)
    return tally_all, steps_all


def optimizers_card_vs_cpu(torch, oc, device="cuda") -> dict:
    """Each optimizer at 2 layers and full width in fp32: ``device``'s update_ against
    the CPU's, from the same weights on the same gradients (those of the CPU's train
    steps), so that only the optimizer's arithmetic differs."""
    from open_clip_tpu_torch.config import get_model_config
    from open_clip_tpu_torch.models.clip import clamp_logit_scale

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_model_config("ViT-B-32")
    cfg["vision_cfg"]["layers"] = cfg["text_cfg"]["layers"] = 2
    oc.add_model_config(cfg, name="ViT-B-32-2-layers")
    from open_clip_tpu_torch.train import optim as optim_mod

    base = oc.create_model("ViT-B-32-2-layers", precision="fp32", seed=0, device="cpu")

    def run(name, seen=None):
        """(start, the CPU's, the card's parameters, the gradients) after OPT_CPU_STEPS
        updates: of the CPU's train steps, or on ``seen``, gradients recorded before."""
        ocfg = oc.OptimizerCfg(opt=name, lr=5e-4, wd=0.2, grad_clip_norm=1.0)
        m = copy.deepcopy(base)
        opt = oc.create_optimizer(ocfg, m, oc.const_lr(5e-4, 0))
        st = oc.create_train_state(m, opt)
        start = [p.detach().clone() for p in st.params]
        if seen is None:
            seen, update = [], opt.update_

            def record(params, grads, opt_state):
                seen.append([g.detach().clone() for g in grads])
                return update(params, grads, opt_state)

            opt.update_ = record
            step = oc.make_train_step(m.cfg, opt)
            b = train_batch(torch, m.cfg, OPT_CPU_BATCH, "cpu", seed=3)
            for _ in range(OPT_CPU_STEPS):
                st, _ = step(st, b)
        else:
            for grads in seen:
                opt.update_(st.params, grads, st.opt_state)
                clamp_logit_scale(m)
        mc = copy.deepcopy(base).to(device)
        optc = oc.create_optimizer(ocfg, mc, oc.const_lr(5e-4, 0))
        stc = oc.create_train_state(mc, optc)
        for grads in seen:  # the train step's update: the optimizer, then the clamp
            optc.update_(stc.params, [g.to(device) for g in grads], stc.opt_state)
            clamp_logit_scale(mc)
        return (start, [p.detach() for p in st.params], [p.detach().cpu() for p in stc.params],
                seen)

    out, muon_grads = {}, None
    # muon twice: as the main path runs it (bfloat16 Newton-Schulz), and with the
    # iteration in float32 on both sides (on the same gradients), where the whole chain
    # is held per entry
    for key, name, ns_dtype in [(n, n, None) for n in OPTIMIZERS] + [
            ("muon_fp32_ns", "muon", torch.float32)]:
        saved = optim_mod.MUON_DTYPE
        optim_mod.MUON_DTYPE = ns_dtype or saved
        try:
            start, cpu, card, seen = run(name, muon_grads if ns_dtype else None)
        finally:
            optim_mod.MUON_DTYPE = saved
        if key == "muon":
            muon_grads = seen
        worst, off, total = 0.0, 0, 0
        tol = OPT_NS_TOL if key == "muon_fp32_ns" else OPT_ENTRY_TOL
        for c, r, s0 in zip(card, cpu, start):
            change = (r.double() - s0.double()).abs().max().item()
            diff = (c.double() - r.double()).abs()
            worst = max(worst, diff.max().item() / change if change else
                        (0.0 if diff.max().item() == 0 else math.inf))
            mag = torch.maximum(r.abs(), s0.abs())
            ulp = (torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag).double()
            off += int((diff > tol * change + OPT_ULPS * ulp).sum())
            total += diff.numel()
        flat = lambda ts: torch.cat([t.flatten() for t in ts]).double()  # noqa: E731
        cos = torch.nn.functional.cosine_similarity(flat(card) - flat(start),
                                                    flat(cpu) - flat(start), dim=0).item()
        out[key] = {"max_rel_err": worst, "entries_off": off, "share_off": off / total,
                    "update_cosine": cos}
        if key == "lion":
            ok, bound = off / total <= OPT_LION_OFF, f"share <= {OPT_LION_OFF:g}"
        elif key == "muon":
            ok, bound = True, "not bounded per entry: bfloat16, see muon_fp32_ns"
        else:
            ok, bound = off == 0, "none allowed"
        check(ok and math.isfinite(worst) and cos >= 0.999,
              f"optimizers[{key}] fp32 2-layer card vs CPU on the CPU's gradients, "
              f"{OPT_CPU_STEPS} steps: entries beyond {tol:g} of their tensor's "
              f"largest change + {OPT_ULPS} ulp {off} of {total} ({bound}); largest error "
              f"{worst:.3e} of the largest change; cosine of the updates {cos:.6f} (min 0.999)")
    return out


def phase_patch_dropout_train(torch, oc, sa):
    """ViT-B-16 at batch 256, amp_bf16, AdamW: a window with patch dropout 0.5 (99
    tokens a sample: the class token and 98 of 196 patches) beside one without (197):
    step ms, kernel ms, short launches by length. Returns the launches by (direction,
    length) and the windows' steps."""
    from torch.profiler import ProfilerActivity, profile

    out, tally_all, steps = {}, {}, {}
    for prob in (PD_PROB, 0.0):
        torch.cuda.reset_peak_memory_stats()
        model = oc.create_model(PD_MODEL, precision="amp_bf16", seed=0, force_patch_dropout=prob)
        lv, lt = model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers
        opt = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0), model,
                                  oc.const_lr(5e-4, 0))
        state = oc.create_train_state(model, opt)
        step = oc.make_train_step(model.cfg, opt)
        batch = train_batch(torch, model.cfg, BATCH, "cuda")
        state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
        n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
        reset_counts(sa)
        with tally_by_len(sa) as tally:
            state, window, step_ms, host_ms, _, wall_s = run_steps(torch, step, state, batch, n)
        for key, v in tally.items():
            tally_all[key] = tally_all.get(key, 0) + v
        steps[prob] = n
        gh, gw = model.visual.cfg.grid_size
        length = 1 + (max(1, int(gh * gw * (1 - prob))) if prob else gh * gw)
        losses = [float(m["loss"]) for m in warm + window]
        check(all(math.isfinite(x) for x in losses)
              and tally.get(("fwd", length), 0) == lv * n and tally.get(("bwd", length), 0) == lv * n
              and tally.get(("fwd", 77), 0) == lt * n,
              f"patch_dropout_train[{prob}]: short launches by (direction, length) {tally} in {n} "
              f"steps (expect {lv * n} at L={length}, {lt * n} at 77), losses finite "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        with profile(activities=[ProfilerActivity.CUDA]):
            state = run_steps(torch, step, state, batch, 1)[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, *_, prof_wall_s = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)
        ps = profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")
        out[str(prob)] = {"tokens": length, "window_steps": n,
                          "median_step_ms": statistics.median(step_ms),
                          "images_per_s": BATCH * n / wall_s,
                          "kernel_ms_per_step": ps["device_busy_ms_per_step"],
                          "device_idle_share": ps["device_idle_share"],
                          "short_ms_per_step": {c: ps["class_ms_per_step"].get(c) for c in
                                                ("short_attention", "short_attention_bwd")},
                          "median_host_ms_per_step": statistics.median(host_ms),
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                          "short_launches_per_step": {f"{d}_L{l}": v / n
                                                      for (d, l), v in tally.items()},
                          "first_loss": losses[0], "last_loss": losses[-1]}
        del model, opt, state, step
    print("patch_dropout_train " + json.dumps({"model": PD_MODEL, "batch": BATCH,
                                               "precision": "amp_bf16", "by_prob": out}),
          flush=True)
    return tally_all, steps


def phase_remat_dots(torch, oc, sa, blocks):
    """ViT-L-14 at batch 64, amp_bf16: the same weights stepped under each remat policy
    (none = full remat, names_mm, dots, dots_no_batch): step ms, kernel ms, peak GiB and
    short launches; the first loss is the same under every policy."""
    from torch.profiler import ProfilerActivity, profile

    saved = blocks.REMAT_POLICY
    out, steps = {}, 0
    try:
        model = oc.create_model(L14_MODEL, precision="amp_bf16", seed=0)
        lv, lt = model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers
        init = {k: v.clone() for k, v in model.state_dict().items()}
        batch = train_batch(torch, model.cfg, L14_BATCH, "cuda")
        for policy in REMAT_POLICIES:
            blocks.REMAT_POLICY = policy
            steps += 4
            with torch.no_grad():
                model.load_state_dict(init)
            opt = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                      model, oc.const_lr(5e-4, 0))
            state = oc.create_train_state(model, opt)
            step = oc.make_train_step(model.cfg, opt, remat=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(sa)
            state, first, first_ms, _, _, _ = run_steps(torch, step, state, batch, 1)
            launches = dict(sa.LAUNCHES)
            state, window, step_ms, host_ms, _, wall_s = run_steps(torch, step, state, batch, 2)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, *_, prof_wall_s = run_steps(torch, step, state, batch, 1)
            ps = profile_summary(prof, prof_wall_s * 1e3, 1, "step")
            out[policy] = {"first_loss": float(first[0]["loss"]),
                           "median_step_ms": statistics.median(step_ms),
                           "kernel_ms_per_step": ps["device_busy_ms_per_step"],
                           "matmul_ms_per_step": ps["class_ms_per_step"].get("matmul"),
                           "peak_mem_gib": peak, "short_launches_per_step": launches,
                           "images_per_s": L14_BATCH * 2 / wall_s}
            # the attention kernels are custom ops, not products: recomputed under the
            # dots policies as under full remat; names_mm saves their output
            fwd = (lv + lt) * (1 if policy == "names_mm" else 2)
            check(launches == {"fwd": fwd, "bwd": lv + lt}
                  and all(math.isfinite(float(m["loss"])) for m in first + window),
                  f"remat_dots[{policy}]: short launches {launches} in one step (expect "
                  f"{fwd} forward, {lv + lt} backward), losses finite")
            del state, opt, step
        base = out["none"]["first_loss"]
        check(all(abs(v["first_loss"] - base) <= 1e-3 * abs(base) for v in out.values()),
              f"remat_dots: first losses {[round(v['first_loss'], 6) for v in out.values()]} "
              "equal under every policy (rel 1e-3)")
        check(out["dots"]["peak_mem_gib"] >= out["none"]["peak_mem_gib"],
              f"remat_dots: dots keeps more than full remat, peak "
              f"{out['dots']['peak_mem_gib']:.2f} vs {out['none']['peak_mem_gib']:.2f} GiB")
    finally:
        blocks.REMAT_POLICY = saved
    print("remat_dots " + json.dumps({"model": L14_MODEL, "layers": list(RD_DEPTH),
                                      "batch": L14_BATCH,
                                      "precision": "amp_bf16", "by_policy": out}), flush=True)
    return steps


@contextlib.contextmanager
def card_clocks(readings: dict):
    """While open, a thread reads the card's SM and memory clocks, power draw and
    active throttle reasons (nvidia-smi) over and over; on exit ``readings`` gets their
    extremes, beside a kernel time that a lowered clock would have stretched."""
    import threading

    rows, stop = [], threading.Event()

    def loop():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                                  "clocks_throttle_reasons.active", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60).stdout
            try:
                sm, mem, power, reasons = (x.strip() for x in out.strip().split(","))
                rows.append((float(sm), float(mem), float(power), reasons))
            except ValueError:
                pass

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    try:
        yield readings
    finally:
        stop.set()
        thread.join()
        readings.update(samples=len(rows), sm_mhz_min=min((r[0] for r in rows), default=None),
                        mem_mhz_min=min((r[1] for r in rows), default=None),
                        power_w_max=max((r[2] for r in rows), default=None),
                        throttle_reasons=sorted({r[3] for r in rows}))


def coca_texts(torch, n, context, seed, device="cuda"):
    """n caption rows of the CLIP vocabulary: the start token, random tokens, the end
    token at a seeded length of 5 to ``context`` - 1, then pad (0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(1, 49406, (n, context), generator=gen, device=device)
    ids[:, 0] = 49406
    ends = torch.randint(5, context, (n,), generator=gen, device=device)
    pos = torch.arange(context, device=device)[None]
    ids = torch.where(pos == ends[:, None], 49407, ids)
    return torch.where(pos > ends[:, None], 0, ids)


def coca_teacher_forced_cosine(torch, coca, model, pixels, ids) -> float:
    """The cached decode's logits of every position against the uncached forward on
    the same tokens (the buffer padded to the context length), over the positions
    whose prefix holds no pad: the smallest cosine."""
    import torch.nn.functional as F

    n, seq = ids.shape
    image_embs = coca._image_tokens(model, pixels)
    cache = coca.DecodeCache(model, image_embs, seq)
    cached = torch.stack([coca._cached_decode_logits(model, ids[:, t - 1], t, cache)
                          for t in range(1, seq)], dim=1)
    ctx = model.cfg.text_cfg.context_length
    full = coca.coca_forward(model, pixels, F.pad(ids, (0, ctx - seq)))["logits"][:, :seq - 1]
    ok = (ids[:, :seq - 1] != 0).cumprod(dim=1).bool()
    cos = F.cosine_similarity(cached.double(), full.double(), dim=-1)
    return cos[ok].min().item()


def phase_coca_serve(torch, oc, sa, attn, nf):
    """coca_ViT-B-32 in pure_bf16 (seed 0): a 10-class zero-shot classifier, requests
    of 64 uint8 images (device preprocess -> encode_image, then greedy captions of 30
    tokens through the KV cache) and of 16 for beam search over 6 beams, each timed
    over a window and profiled; the cached decode against the uncached forward on
    the same tokens; fp32 card against CPU. Returns the short launches by direction
    and length, and the requests that made them."""
    from open_clip_tpu_torch.models import coca

    torch.cuda.reset_peak_memory_stats()
    model, _, preprocess = oc.create_model_and_transforms(COCA_MODEL, precision="pure_bf16",
                                                          seed=0)
    tokenizer = oc.get_tokenizer(COCA_MODEL)
    lv, lt, ld = (model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers,
                  model.cfg.multimodal_cfg.layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    requests = [torch.randint(0, 256, (COCA_SERVE_BATCH, *IMAGE_HW, 3), dtype=torch.uint8,
                              device="cuda", generator=gen) for _ in range(DISTINCT_REQUESTS)]
    texts = coca_texts(torch, COCA_SERVE_BATCH, model.cfg.text_cfg.context_length, 0)
    out, calls = {}, {}
    t_phase = time.perf_counter()
    with torch.inference_mode():
        reset_counts(sa)
        with tally_by_len(sa) as tally, attention_paths(attn, nf) as paths:
            t0 = time.perf_counter()
            clf = oc.build_zero_shot_classifier(model, tokenizer, oc.IMAGENET_CLASSNAMES[:CLASSES],
                                                oc.SIMPLE_IMAGENET_TEMPLATES,
                                                num_classes_per_batch=CLASSES)
            torch.cuda.synchronize()
            out["classifier_ms"] = (time.perf_counter() - t0) * 1e3
            clf_tally, clf_paths = dict(tally), dict(paths)
            clf32 = clf.float()

            def encode(i):
                feats = model.encode_image(preprocess(requests[i % DISTINCT_REQUESTS]),
                                           normalize=True)
                return feats, (100.0 * feats.float() @ clf32).topk(5, dim=-1).indices.cpu()

            def encode_text(i):
                f = model.encode_text(texts.roll(i, 0), normalize=True)
                return f, f[:1].cpu()

            def greedy(i):
                ids = model.generate(preprocess(requests[i % DISTINCT_REQUESTS]),
                                     generation_type="greedy", seq_len=COCA_SEQ)
                return ids, ids.cpu()

            def beam(i):
                pixels = preprocess(requests[i % DISTINCT_REQUESTS][:COCA_BEAM_BATCH])
                ids = model.generate(pixels, num_beams=COCA_BEAMS, seq_len=COCA_SEQ)
                return ids, ids.cpu()

            for name, request, n, profiled in (("encode_image", encode, COCA_SERVE_BATCH, 5),
                                               ("encode_text", encode_text, COCA_SERVE_BATCH, 5),
                                               ("greedy", greedy, COCA_SERVE_BATCH, 1),
                                               ("beam", beam, COCA_BEAM_BATCH, 1)):
                before = sum(tally.values())
                t0 = time.perf_counter()
                request(0)
                first_ms = (time.perf_counter() - t0) * 1e3
                lat, window_s, res, host, prof, prof_ms = serve_window(
                    request, profiled)
                calls[name] = 1 + len(lat) + profiled
                summary = profile_summary(prof, prof_ms, profiled)
                out[name] = {"batch": n, "first_request_ms": first_ms, "window_requests": len(lat),
                             "window_s": window_s, "images_per_s": n * len(lat) / window_s,
                             "median_request_ms": statistics.median(lat),
                             "kernel_ms_per_request": summary["device_busy_ms_per_request"],
                             "device_idle_share": summary["device_idle_share"],
                             "short_launches": sum(tally.values()) - before}
                print(f"coca_serve_profile[{name}] " + json.dumps(summary), flush=True)
                out[name + "_result"] = (res, host)
            serve_tally, serve_paths = dict(tally), dict(paths)
            seconds = {"serve": time.perf_counter() - t_phase}
            ids = greedy(0)[0]
            reset_counts(sa)
            with tally_by_len(sa) as tf_tally:
                cos = coca_teacher_forced_cosine(torch, coca, model,
                                                 preprocess(requests[0]), ids)
            tf_tally = dict(tf_tally)
    ctx = model.cfg.text_cfg.context_length
    li = model.cfg.vision_cfg.grid_size[0] * model.cfg.vision_cfg.grid_size[1] + 1
    check(clf_tally == {} and clf_paths.get(("dense", ctx + 1)) == lt
          and tuple(clf.shape) == (model.cfg.embed_dim, CLASSES) and bool(torch.isfinite(clf).all()),
          f"coca_serve: classifier {tuple(clf.shape)} finite; its text tower dense "
          f"({clf_paths}), no short launch ({clf_tally})")
    image_calls = calls["encode_image"] + calls["greedy"] + calls["beam"]
    check(serve_tally == {("fwd", li): lv * image_calls},
          f"coca_serve: short launches {serve_tally} for {image_calls} image-tower calls "
          f"(expect {lv} at L={li} each; the cached decode's one-query attention is plain)")
    want_paths = {("short", li): lv * image_calls, ("dense", li): image_calls,
                  ("dense", ctx + 1): lt * (1 + calls["encode_text"])}
    check(all(serve_paths.get(k) == v for k, v in want_paths.items()),
          f"coca_serve: attention paths {serve_paths} (the attentional pool dense once an "
          f"image call, the CLS text tower dense, expect {want_paths})")
    feats, top5 = out.pop("encode_image_result")
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(bool(torch.isfinite(feats).all()) and bool(((fn - 1).abs() < 1e-2).all())
          and tuple(top5.shape) == (COCA_SERVE_BATCH, 5),
          f"coca_serve: image features {tuple(feats.shape)} finite and unit, top-5 {tuple(top5.shape)}")
    out.pop("encode_text_result")
    for name in ("greedy", "beam"):
        got = out.pop(name + "_result")[1]
        n = COCA_SERVE_BATCH if name == "greedy" else COCA_BEAM_BATCH
        ended = (got == 49407).any(dim=1)
        after_end = (torch.arange(COCA_SEQ)[None] > (got == 49407).int().argmax(dim=1)[:, None])
        check(tuple(got.shape) == (n, COCA_SEQ) and bool((got[:, 0] == 49406).all())
              and bool((got[ended][after_end[ended]] == 0).all())
              and int(got.min()) >= 0 and int(got.max()) < 49408,
              f"coca_serve: {name} captions {tuple(got.shape)} start with the start token, "
              f"ids in the vocabulary, pad after an end token ({int(ended.sum())} ended)")
        out[name + "_caption_0"] = tokenizer.decode(got[0].tolist())
    seconds["teacher_forced"] = time.perf_counter() - t_phase - seconds["serve"]
    # the image tower runs once for the cache and once in the uncached forward
    check(tf_tally == {("fwd", li): 2 * lv, ("fwd", ctx): ld} and cos >= COCA_BF16_COSINE_MIN,
          f"coca_serve: bf16 cached decode logits vs the uncached forward, teacher-forced: min "
          f"cosine {cos:.6f} (>= {COCA_BF16_COSINE_MIN}: each path rounds to bf16 in its own "
          f"places); short launches {tf_tally} (the decoder at L={ctx})")
    out["teacher_forced_min_cosine_bf16"] = cos
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    t0 = time.perf_counter()
    # fp32, TF32 off: the card against the CPU on two images and two captions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = oc.create_model(COCA_MODEL, precision="fp32", seed=1, device="cpu")
    gpu = copy.deepcopy(cpu).cuda()  # the same weights, one init
    images = requests[1][:2].cpu()
    caps = tokenizer(["a photo of a cat on a mat.", "two dogs running on the beach"])
    pp = oc.make_device_preprocess(cpu.preprocess_cfg)
    with torch.inference_mode():
        g = coca.coca_forward(gpu, pp(images.cuda()), caps)
        c = coca.coca_forward(cpu, pp(images), caps)
        # fp32 on the card: the cached decode against the re-encoding one, token for token,
        # and its logits against the uncached forward, teacher-forced
        pixels = pp(requests[0][:8])
        ids = gpu.generate(pixels, generation_type="greedy", seq_len=COCA_SEQ)
        ids_uncached = gpu.generate(pixels, generation_type="greedy", seq_len=COCA_SEQ,
                                    kv_cache=False)
        cos32 = coca_teacher_forced_cosine(torch, coca, gpu, pixels, ids)
    for key in ("image_features", "text_features", "logits"):
        a, b = g[key].cpu().double(), c[key].double()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
        check(bool(torch.isfinite(a).all()) and cos >= COSINE_MIN,
              f"coca card vs CPU fp32 {key} {tuple(a.shape)}: min cosine {cos:.7f} (>= {COSINE_MIN})")
    check(torch.equal(ids, ids_uncached) and cos32 >= COSINE_MIN,
          f"coca fp32 on the card: cached greedy captions equal the uncached ones token for token "
          f"({tuple(ids.shape)}); cached logits vs the uncached forward, teacher-forced: min cosine "
          f"{cos32:.7f} (>= {COSINE_MIN})")
    seconds["fp32_checks"] = time.perf_counter() - t0
    out["teacher_forced_min_cosine_fp32"] = cos32
    print("coca_serve " + json.dumps({"model": COCA_MODEL, "precision": "pure_bf16",
                                      "seq_len": COCA_SEQ, "beams": COCA_BEAMS, **out,
                                      "seconds": seconds}), flush=True)
    return serve_tally, tf_tally, {"image": image_calls, "teacher_forced": 1}


def coca_component_ms(torch, model, batch) -> dict:
    """Device ms a step of the CoCa step's parts that take no kernel of the port, each
    run alone at the step's shapes (forward and backward; the sum of its kernels'
    device time, profiled):
    the chunked cross-entropy of the caption, and the dense attention of the CLS text
    tower (12 layers, L=77 with its pad bias), the attentional pooler (256 queries over
    50 tokens) and the decoder's 12 cross-attentions (76 queries over 255 tokens)."""
    from open_clip_tpu_torch.ops.attention import dense_attention
    from open_clip_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    cfg = model.cfg
    b, ctx = batch["text"].shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt = torch.bfloat16

    def timed_ms(fn, reps=3):
        """The device-busy ms of one call (its kernels' sum, profiled over ``reps``): an
        event span would hold the host's gaps between these small launches."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return profile_summary(prof, wall_ms, reps, "call")["device_busy_ms_per_call"]

    width = cfg.multimodal_cfg.width
    hidden = torch.randn(b * (ctx - 1), width, generator=gen, device="cuda", dtype=dt,
                         requires_grad=True)
    weight = model.text_decoder.text_projection.detach().t().contiguous().requires_grad_()
    labels = batch["text"][:, 1:].reshape(-1).masked_fill(batch["text"][:, 1:].reshape(-1) == 0,
                                                          -100)

    def ce():
        fused_linear_cross_entropy(hidden, weight, labels).backward()

    def attention(lq, lk, heads, hd, bias=None, causal=False):
        q = torch.randn(b, lq, heads, hd, generator=gen, device="cuda", dtype=dt,
                        requires_grad=True)
        k = torch.randn(b, lk, heads, hd, generator=gen, device="cuda", dtype=dt,
                        requires_grad=True)
        v = torch.randn(b, lk, heads, hd, generator=gen, device="cuda", dtype=dt,
                        requires_grad=True)
        return lambda: dense_attention(q, k, v, bias, causal=causal).sum().backward()

    tc, vc, mc = cfg.text_cfg, cfg.vision_cfg, cfg.multimodal_cfg
    text_bias = torch.zeros(b, 1, 1, ctx + 1, device="cuda")
    grid = vc.grid_size[0] * vc.grid_size[1] + 1
    parts = {"fused_ce": timed_ms(ce),
             "dense_text_tower": tc.layers * timed_ms(attention(ctx + 1, ctx + 1, tc.heads,
                                                                tc.width // tc.heads, text_bias,
                                                                True)),
             "dense_attn_pool": timed_ms(attention(vc.attn_pooler_queries, grid,
                                                   vc.attn_pooler_heads,
                                                   cfg.embed_dim // vc.attn_pooler_heads)),
             "dense_cross_attention": mc.layers * timed_ms(attention(
                 ctx, vc.attn_pooler_queries - 1, mc.heads, mc.width // mc.heads))}
    parts["dense_attention"] = sum(v for k, v in parts.items() if k.startswith("dense_"))
    return parts


def phase_coca_train(torch, oc, sa):
    """The CoCa step: coca_ViT-B-32 in amp_bf16 at batch 256, AdamW (wd 0.2), clip 1.0,
    one fixed batch of images and captions (pad after a seeded end), loss_type "coca"
    (InfoNCE + 2 x the caption cross-entropy through the chunked linear CE): 2 warm-up
    steps, a window, profiled steps, then 2 steps under full remat from the same
    weights; the device ms of the fused CE and of the dense attention timed alone; then
    the CLI on synthetic data (batch 64) with a val split (val_generative_loss), a
    checkpoint and --resume. Returns the window's short launches by (direction, L)
    and its steps."""
    model = oc.create_model(COCA_MODEL, precision="amp_bf16", seed=0)
    lv, ld = model.cfg.vision_cfg.layers, model.cfg.multimodal_cfg.layers
    ctx = model.cfg.text_cfg.context_length
    li = model.cfg.vision_cfg.grid_size[0] * model.cfg.vision_cfg.grid_size[1] + 1
    init = {k: v.clone() for k, v in model.state_dict().items()}
    size = model.cfg.vision_cfg.image_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn(BATCH, size, size, 3, generator=gen, device="cuda"),
             "text": coca_texts(torch, BATCH, ctx, 1)}
    torch.cuda.reset_peak_memory_stats()
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0), model,
                                    oc.const_lr(5e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer, loss_type="coca")
    state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
    n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
    reset_counts(sa)
    with tally_by_len(sa) as tally:
        state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
    tally, bodies = dict(tally), (dict(sa.FWD_BODIES), dict(sa.BWD_BODIES))
    losses = [float(m["loss"]) for m in warm + window]
    caption = [float(m["caption_loss"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses + caption) and losses[-1] < losses[0]
          and caption[-1] < caption[0],
          f"coca_train: {len(losses)} losses finite, fell {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(caption {caption[0]:.4f} -> {caption[-1]:.4f})")
    want = {("fwd", li): lv * n, ("bwd", li): lv * n, ("fwd", ctx): ld * n, ("bwd", ctx): ld * n}
    check(tally == want and bodies[0] == {"mma": (lv + ld) * n, "simt": 0} and bodies[1] == bodies[0],
          f"coca_train: short launches {tally} in {n} steps, by body {bodies} (expect {lv} image "
          f"and {ld} decoder of each a step on the tensor cores; the CLS text tower is dense)")
    with card_clocks({}) as clocks:
        state, prof = profiled_steps(torch, step, state, batch)
    print("coca_train_profile " + json.dumps(prof), flush=True)
    parts = coca_component_ms(torch, model, batch)
    kernel_ms = prof["device_busy_ms_per_step"]
    summary = {"model": COCA_MODEL, "precision": "amp_bf16", "batch": BATCH, "window_steps": n,
               "window_s": wall_s, "images_per_s": BATCH * n / wall_s,
               "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
               "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
               "host_lead_ms_at_end": lead_ms, "kernel_ms_per_step": kernel_ms,
               "device_idle_share": prof["device_idle_share"], "clocks_during_profile": clocks,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "first_loss": losses[0], "last_loss": losses[-1],
               "first_caption_loss": caption[0], "last_caption_loss": caption[-1],
               "contrastive_loss": float(window[-1]["contrastive_loss"]),
               "short_launches_per_step": {f"{d}_L{l}": v / n for (d, l), v in tally.items()},
               "parts_ms_per_step_alone": parts,
               "fused_ce_share": parts["fused_ce"] / kernel_ms if kernel_ms else None,
               "dense_attention_share": parts["dense_attention"] / kernel_ms if kernel_ms else None}
    # full remat from the same weights: the towers' blocks and the decoder's pairs again
    with torch.no_grad():
        model.load_state_dict(init)
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0), model,
                                    oc.const_lr(5e-4, 0))
    state = oc.create_train_state(model, optimizer)
    reset_counts(sa)
    with tally_by_len(sa) as rt:
        state, rm, remat_ms, *_ = run_steps(torch, oc.make_train_step(
            model.cfg, optimizer, loss_type="coca", remat=True), state, batch, 2)
    want = {("fwd", li): 2 * lv * 2, ("bwd", li): lv * 2, ("fwd", ctx): 2 * ld * 2,
            ("bwd", ctx): ld * 2}
    check(dict(rt) == want and abs(float(rm[0]["loss"]) - losses[0]) <= 2e-2 * abs(losses[0]),
          f"coca_train[remat]: short launches {dict(rt)} in 2 steps (expect {want}); first loss "
          f"{float(rm[0]['loss']):.4f} vs {losses[0]:.4f} (rel 2e-2)")
    summary["remat_median_step_ms"] = statistics.median(remat_ms)
    summary["remat_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, optimizer, model
    # the CLI: train, evaluate (val_generative_loss), checkpoint, resume
    from open_clip_tpu_torch.train.main import main as train_main

    with tempfile.TemporaryDirectory() as logs:
        args = ["--model", COCA_MODEL, "--dataset-type", "synthetic", "--batch-size",
                str(COCA_CLI_BATCH), "--train-num-samples", str(COCA_CLI_BATCH * COCA_CLI_STEPS),
                "--val-data", "synthetic", "--precision", "amp_bf16", "--grad-clip-norm", "1.0",
                "--lr", "5e-4", "--warmup", "2", "--log-every-n-steps", "2", "--workers", "1",
                "--logs", logs, "--name", "coca"]
        t0 = time.perf_counter()
        st = train_main(args + ["--epochs", "1"])
        first_s = time.perf_counter() - t0
        run = Path(logs) / "coca"
        rows = [json.loads(x) for x in (run / "results.jsonl").read_text().splitlines()]
        val = [r for r in rows if "val/val_generative_loss" in r]
        check(st.step == COCA_CLI_STEPS and bool(val)
              and math.isfinite(val[-1]["val/val_generative_loss"])
              and math.isfinite(val[-1]["val/clip_val_loss"])
              and (run / "checkpoints" / "epoch_1.pt").exists(),
              f"coca CLI: {st.step} steps, val_generative_loss "
              f"{val[-1]['val/val_generative_loss'] if val else None}, epoch_1.pt written")
        st = train_main(args + ["--epochs", "2", "--resume", "latest"])
        check(st.step == 2 * COCA_CLI_STEPS and (run / "checkpoints" / "epoch_2.pt").exists(),
              f"coca CLI: --resume latest went on to step {st.step}")
        summary["cli_first_run_s"] = first_s
        summary["cli_val"] = {k: v for k, v in val[-1].items()} if val else None
    print("coca_train " + json.dumps(summary), flush=True)
    return tally, n


def phase_distill_train(torch, oc, sa, fl):
    """The distillation step: a ViT-B-32 student (seed 0) and a ViT-B-32 teacher (seed
    1), amp_bf16, batch 256, AdamW (wd 0.2; lr 1e-4: at 5e-4 with no warm-up this fixed
    batch's loss rose in one of three runs on the H100, 11.2156 -> 11.6794 over 22
    steps, the KL to a random teacher leading it), clip 1.0, loss_type "distill"
    (InfoNCE + the KL to the teacher's logits), on phase 4's fixed batch: warm-up, a
    window, profiled steps. Returns the window's short launches by (direction, tower)
    and its steps."""
    torch.cuda.reset_peak_memory_stats()
    model = oc.create_model("ViT-B-32", precision="amp_bf16", seed=0)
    teacher = oc.create_model("ViT-B-32", precision="amp_bf16", seed=1).eval().requires_grad_(False)
    t_init = {k: v.clone() for k, v in teacher.state_dict().items()}
    lv, lt = model.cfg.vision_cfg.layers, model.cfg.text_cfg.layers
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-4, wd=0.2, grad_clip_norm=1.0), model,
                                    oc.const_lr(1e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer, loss_type="distill", teacher=teacher)
    batch = train_batch(torch, model.cfg, BATCH, "cuda")
    state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
    n = max(3, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
    reset_counts(sa)
    with tally_by_shape(sa, fl) as tally:
        state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
    tally = dict(tally)
    losses = [float(m["loss"]) for m in warm + window]
    dl = [float(m["distill_loss"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses + dl) and losses[-1] < losses[0],
          f"distill_train: {len(losses)} losses finite, fell {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(distill term {dl[0]:.4f} -> {dl[-1]:.4f})")
    want = {("fwd", "vision"): 2 * lv * n, ("fwd", "text"): 2 * lt * n,
            ("bwd", "vision"): lv * n, ("bwd", "text"): lt * n}
    check(tally == want, f"distill_train: short launches {tally} in {n} steps (expect the "
          f"student's forward and backward and the teacher's forward: {want})")
    check(all(torch.equal(v, t_init[k]) for k, v in teacher.state_dict().items()),
          "distill_train: the teacher's weights did not move")
    state, prof = profiled_steps(torch, step, state, batch)
    print("distill_train_profile " + json.dumps(prof), flush=True)
    print("distill_train " + json.dumps({
        "model": "ViT-B-32", "teacher": "ViT-B-32", "precision": "amp_bf16", "batch": BATCH,
        "lr": 1e-4,
        "window_steps": n, "window_s": wall_s, "images_per_s": BATCH * n / wall_s,
        "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
        "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
        "host_lead_ms_at_end": lead_ms, "kernel_ms_per_step": prof["device_busy_ms_per_step"],
        "device_idle_share": prof["device_idle_share"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "first_loss": losses[0], "last_loss": losses[-1], "first_distill_loss": dl[0],
        "last_distill_loss": dl[-1],
        "short_launches_per_step": {f"{d}_{t}": v / n for (d, t), v in tally.items()}}),
        flush=True)
    return tally, n


# ---------------------------------------------------------------------------
# GenLIP and GenLAP
# ---------------------------------------------------------------------------

def genlip_image(torch, b, grids, seed, device="cuda", patch_dim=768):
    """NaFlex patch dicts of ``b`` images, image i on grids[i % len(grids)] = (gh, gw)
    patches of 16 px, padded to the largest grid's token count: row-major (y, x)
    coordinates with the valid patches first, as NaFlexTransform lays them out, and
    random-normal patch values from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = max(gh * gw for gh, gw in grids)
    coord = torch.zeros(b, n, 2, dtype=torch.long, device=device)
    valid = torch.zeros(b, n, dtype=torch.bool, device=device)
    for i in range(b):
        gh, gw = grids[i % len(grids)]
        yx = torch.stack(torch.meshgrid(torch.arange(gh), torch.arange(gw), indexing="ij"), -1)
        coord[i, :gh * gw] = yx.reshape(-1, 2).to(device)
        valid[i, :gh * gw] = True
    return {"patches": torch.randn(b, n, patch_dim, generator=gen, device=device),
            "patch_coord": coord, "patch_valid": valid}


def genlip_text(torch, text_cfg, b, length, lens, seed, device="cuda"):
    """(b, length) token ids from a seed (the tiktoken vocabulary is not in the
    repository): the start id, seeded ids below the special ones, then the end id
    and pad after lens[i % len(lens)] tokens."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(1, text_cfg.eos_id, (b, length), generator=gen, device=device)
    ids[:, 0] = text_cfg.bos_id
    for i in range(b):
        n = lens[i % len(lens)]
        if n < length:
            ids[i, n - 1] = text_cfg.eos_id
            ids[i, n:] = text_cfg.pad_id
    return ids


@contextlib.contextmanager
def tally_flash_masks(fa):
    """While open, count ``flash_attention``'s calls by (L, causal, prefix_len): the
    mask each trunk call hands the kernels (a call's forward launches once, again when
    remat recomputes it, and its backward once)."""
    tally, call = {}, fa.flash_attention

    def counted(q, k, v, *, causal=False, prefix_len=0, **kw):
        key = (q.shape[1], bool(causal), int(prefix_len))
        tally[key] = tally.get(key, 0) + 1
        return call(q, k, v, causal=causal, prefix_len=prefix_len, **kw)

    fa.flash_attention = counted
    try:
        yield tally
    finally:
        fa.flash_attention = call


def phase_genlip_serve(torch, oc, sa, fa):
    """naflexgenlip_b16 serving (pure_bf16: bf16 compute; GenLIP keeps fp32 weights, as
    the JAX factory does): encode_image of 32 images at 1024 tokens (32x32 grids and
    24x32, ragged key validity) a request, its 12 trunk blocks on the flash forward;
    prefix_cache of one image and score_captions of 16 captions against it (dense, as
    in JAX); greedy captions of 32 tokens at b16 over a 256-token prefix (16x16
    grids), through the KV cache and by running the trunk each step. Then fp32 (TF32
    off, the same weights): cached captions equal uncached ones token for token, and
    the cached scores equal the joint forward's (which takes the flash kernels with
    prefix_len 1024 at 1152 tokens). Returns the flash forward launches of the
    encode_image calls and the calls."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    model = oc.create_model(GENLIP_MODEL, precision="pure_bf16", seed=0)
    tc, depth = model.cfg.text_cfg, model.cfg.trunk_cfg.depth
    images = [genlip_image(torch, GENLIP_BATCH, ((32, 32), (24, 32)), seed=i) for i in range(2)]
    captions = genlip_text(torch, tc, GENLIP_CAPTIONS, GENLIP_LT, (128, 40, 97, 12), seed=5)
    prefix = genlip_image(torch, GENLIP_GEN_BATCH, ((16, 16),), seed=7)
    out, seconds = {}, {"build": time.perf_counter() - t_phase}
    with torch.inference_mode():
        reset_counts(sa, fa)

        def encode(i):
            feats = model.encode_image(images[i % 2], normalize=True)
            return feats, feats[:1].cpu()

        with tally_flash_masks(fa) as masks:
            t0 = time.perf_counter()
            encode(0)
            first_ms = (time.perf_counter() - t0) * 1e3
            lat, window_s, feats, _, prof, prof_ms = serve_window(encode, GENLIP_PROFILED)
        calls = 1 + len(lat) + GENLIP_PROFILED
        flash, bodies, short = dict(fa.LAUNCHES), dict(fa.FWD_BODIES), dict(sa.LAUNCHES)
        summary = profile_summary(prof, prof_ms, GENLIP_PROFILED)
        print("genlip_serve_profile[encode_image] " + json.dumps(summary), flush=True)
        out["encode_image"] = {"batch": GENLIP_BATCH, "seq_len": GENLIP_NI, "first_request_ms": first_ms,
                               "window_requests": len(lat), "window_s": window_s,
                               "median_request_ms": statistics.median(lat),
                               "images_per_s": GENLIP_BATCH * len(lat) / window_s,
                               "kernel_ms_per_request": summary["device_busy_ms_per_request"],
                               "device_idle_share": summary["device_idle_share"]}
        seconds["encode_image"] = time.perf_counter() - t_phase - seconds["build"]
        check(flash == {"fwd": depth * calls, "bwd_dq": 0, "bwd_dkv": 0}
              and bodies == {"wgmma": depth * calls, "simt": 0} and short == {"fwd": 0, "bwd": 0}
              and masks == {(GENLIP_NI, False, 0): depth * calls},
              f"genlip_serve encode_image: flash launches {flash}, by body {bodies}, calls by "
              f"(L, causal, prefix) {masks}, short {short} for {calls} requests (expect {depth} "
              f"bidirectional wgmma forwards at L={GENLIP_NI} each)")
        fn = torch.linalg.vector_norm(feats.float(), dim=-1)
        check(tuple(feats.shape) == (GENLIP_BATCH, model.cfg.embed_dim)
              and bool(torch.isfinite(feats).all()) and bool(((fn - 1).abs() < 1e-2).all()),
              f"genlip_serve encode_image: features {tuple(feats.shape)} finite and unit")

        # scoring: one image's cache, 16 captions against it
        one = {k: v[:1] for k, v in images[0].items()}
        reset_counts(fa)

        def score(i):
            scores = model.score_captions(model.prefix_cache(one), captions)
            return scores, scores.cpu()

        t0 = time.perf_counter()
        score(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        lat, window_s, scores, _, prof, prof_ms = serve_window(score, 2)
        summary = profile_summary(prof, prof_ms, 2)
        out["score_captions"] = {"captions": GENLIP_CAPTIONS, "caption_len": GENLIP_LT,
                                 "first_request_ms": first_ms, "window_requests": len(lat),
                                 "median_request_ms": statistics.median(lat),
                                 "kernel_ms_per_request": summary["device_busy_ms_per_request"],
                                 "device_idle_share": summary["device_idle_share"]}
        check(tuple(scores.shape) == (GENLIP_CAPTIONS,) and bool(torch.isfinite(scores).all())
              and bool((scores < 0).all()) and fa.LAUNCHES["fwd"] == 0,
              f"genlip_serve score_captions: {tuple(scores.shape)} finite log-probabilities "
              f"(max {float(scores.max()):.3f}); the cached paths are dense "
              f"(flash {dict(fa.LAUNCHES)})")
        seconds["score_captions"] = time.perf_counter() - t_phase - sum(seconds.values())

        # greedy captions, cached and uncached, at b16 over 256-token prefixes
        for name, kv in (("greedy_cached", True), ("greedy_uncached", False)):
            def caption(i, kv=kv):
                ids = model.generate(prefix, seq_len=GENLIP_GEN_SEQ, kv_cache=kv)
                return ids, ids.cpu()

            t0 = time.perf_counter()
            caption(0)
            first_ms = (time.perf_counter() - t0) * 1e3
            # the cached decode is profiled (one batch, ~24k launches); the uncached one,
            # the parity path, is timed only
            lat, window_s, ids, _, prof, prof_ms = serve_window(caption, int(kv))
            out[name] = {"batch": GENLIP_GEN_BATCH, "prefix_tokens": GENLIP_GEN_NI,
                         "seq_len": GENLIP_GEN_SEQ, "first_request_ms": first_ms,
                         "window_requests": len(lat), "median_request_ms": statistics.median(lat),
                         "captions_per_s": GENLIP_GEN_BATCH * len(lat) / window_s}
            if kv:
                summary = profile_summary(prof, prof_ms, 1)
                print(f"genlip_serve_profile[{name}] " + json.dumps(summary), flush=True)
                out[name].update(
                    kernel_ms_per_request=summary["device_busy_ms_per_request"],
                    kernel_launches_per_request=summary["kernel_launches_per_request"],
                    device_idle_share=summary["device_idle_share"])
            out[name + "_ids"] = ids
        got = out.pop("greedy_cached_ids")
        out.pop("greedy_uncached_ids")
        check(tuple(got.shape) == (GENLIP_GEN_BATCH, GENLIP_GEN_SEQ)
              and bool((got[:, 0] == tc.bos_id).all()) and int(got.min()) >= 0
              and int(got.max()) < tc.vocab_size,
              f"genlip_serve greedy: captions {tuple(got.shape)} start with the start id, ids in "
              "the vocabulary")
        seconds["generate"] = time.perf_counter() - t_phase - sum(seconds.values())

        # fp32 (TF32 off; GenLIP's weights are fp32 already): cached captions against
        # uncached ones, and cached scores against the joint forward's (flash, prefix 1024)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model.compute_dtype = torch.float32
        few = {k: v[:4] for k, v in prefix.items()}
        ids32 = model.generate(few, seq_len=GENLIP_GEN_SEQ)
        ids32_uncached = model.generate(few, seq_len=GENLIP_GEN_SEQ, kv_cache=False)
        check(torch.equal(ids32, ids32_uncached),
              f"genlip_serve fp32: cached greedy captions equal the uncached ones token for "
              f"token ({tuple(ids32.shape)})")
        four = captions[:4]
        cached = model.score_captions(model.prefix_cache(one), four)
        reset_counts(fa)
        with tally_flash_masks(fa) as masks:
            logits = model({k: v.expand(4, -1, *v.shape[2:]) for k, v in one.items()}, four)["logits"]
        lp = torch.log_softmax(logits[:, GENLIP_NI - 1:GENLIP_NI - 1 + GENLIP_LT].float(), -1)
        lp = torch.gather(lp, 2, four[..., None])[..., 0]
        tv = four != tc.pad_id
        joint = (lp * tv).sum(1) / tv.sum(1)
        err = (cached - joint).abs().max().item()
        check(masks == {(GENLIP_NI + GENLIP_LT, True, GENLIP_NI): depth} and err <= 1e-4,
              f"genlip_serve fp32: cached scores vs the joint forward's (flash calls by (L, "
              f"causal, prefix) {masks}): max abs diff {err:.2e} (<= 1e-4)")
        seconds["fp32_checks"] = time.perf_counter() - t_phase - sum(seconds.values())
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print("genlip_serve " + json.dumps({"model": GENLIP_MODEL, "precision": "pure_bf16",
                                        **out, "seconds": seconds}), flush=True)
    del model
    torch.cuda.empty_cache()
    return flash["fwd"], calls


def phase_genlip_train(torch, oc, sa, fa, blocks):
    """The JAX package's bench_genlip step: naflexgenlip_b16, batch 32, 1024 image tokens
    (32x32 grids) + 128 text tokens (ragged: the end id, then pad), amp_bf16, AdamW (lr
    1e-4, wd 0.1), clip 1.0, full remat, the caption loss through the chunked linear
    CE; 2 warm-up steps, a timed window, profiled steps. Every step launches the flash
    forward 24 times (12 blocks, and 12 again in remat's recompute), dq and dk/dv 12
    times, all with prefix_len 1024 at L = 1152. Then one accum_freq 2 step against the
    simple step from the same weights (plain gradient descent, lr 1e-2: the update is
    the gradient; drop path off; halves with the same text lengths, so the two losses
    are one quantity). Returns the window's flash launches and steps."""
    torch.cuda.reset_peak_memory_stats()
    blocks.REMAT_POLICY = "none"
    model = oc.create_model(GENLIP_MODEL, precision="amp_bf16", seed=0)
    depth, tc = model.cfg.trunk_cfg.depth, model.cfg.text_cfg
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-4, wd=0.1, grad_clip_norm=1.0),
                                    model, oc.const_lr(1e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer, loss_type="genlip", remat=True)
    lens = (128, 101, 64, 128, 87, 33, 128, 120)  # each half of the batch has the same lengths
    batch = {"image": genlip_image(torch, GENLIP_BATCH, ((32, 32),), seed=11),
             "text": genlip_text(torch, tc, GENLIP_BATCH, GENLIP_LT, lens, seed=12)}
    state, warm, warm_ms, *_ = run_steps(torch, step, state, batch, 2)
    n = max(4, math.ceil(TRAIN_WINDOW_S * 1e3 / warm_ms[-1]))
    reset_counts(sa, fa)
    with tally_flash_masks(fa) as masks:
        state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
    flash, short = dict(fa.LAUNCHES), dict(sa.LAUNCHES)
    fwd_bodies, bwd_bodies = dict(fa.FWD_BODIES), dict(fa.BWD_BODIES)
    losses = [float(m["loss"]) for m in warm + window]
    seq = GENLIP_NI + GENLIP_LT
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"genlip_train: {len(losses)} losses finite, fell on the fixed batch "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    check(flash == {"fwd": 2 * depth * n, "bwd_dq": depth * n, "bwd_dkv": depth * n}
          and fwd_bodies == {"wgmma": 2 * depth * n, "simt": 0}
          and bwd_bodies == {"wgmma": depth * n, "simt": 0} and short == {"fwd": 0, "bwd": 0}
          and masks == {(seq, True, GENLIP_NI): 2 * depth * n},
          f"genlip_train: flash launches {flash}, forward by body {fwd_bodies}, backward passes "
          f"by body {bwd_bodies}, calls by (L, causal, prefix) {masks}, short {short} in {n} "
          f"steps (expect {2 * depth} forwards with remat's recompute, {depth} dq and dk/dv a "
          f"step, all wgmma, prefix_len {GENLIP_NI} at L={seq})")
    state, prof_summary = profiled_steps(torch, step, state, batch)
    print("genlip_train_profile " + json.dumps(prof_summary), flush=True)
    summary = {"model": GENLIP_MODEL, "precision": "amp_bf16", "batch": GENLIP_BATCH,
               "image_tokens": GENLIP_NI, "text_tokens": GENLIP_LT, "remat": "full",
               "window_steps": n, "window_s": wall_s,
               "tokens_per_s": GENLIP_BATCH * seq * n / wall_s,
               "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
               "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
               "host_lead_ms_at_end": lead_ms, "first_loss": losses[0], "last_loss": losses[-1],
               "device_busy_ms_per_step": prof_summary["device_busy_ms_per_step"],
               "device_idle_share": prof_summary["device_idle_share"],
               "flash_launches_per_step": {k: v / n for k, v in flash.items()},
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del state, model, optimizer
    torch.cuda.empty_cache()
    # accumulation: one step of each from the same weights
    updates, results = {}, {}
    for accum in (1, 2):
        model = oc.create_model(GENLIP_MODEL, precision="amp_bf16", seed=0)
        model.cfg.trunk_cfg.drop_path_rate = 0.0  # the two cut the batch into other draws
        opt = oc.create_optimizer(oc.OptimizerCfg(opt="sgd", momentum=0.0, lr=1e-2, wd=0.0,
                                                  grad_clip_norm=None), model, oc.const_lr(1e-2, 0))
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        _, m = oc.make_train_step(model.cfg, opt, loss_type="genlip", remat=True,
                                  accum_steps=accum)(oc.create_train_state(model, opt), batch)
        updates[accum] = {k: (before[k] - p.detach()).float() for k, p in model.named_parameters()}
        results[accum] = float(m["loss"])
        del model, opt, before
        torch.cuda.empty_cache()
    # the cosines see the update's direction, the norms' ratios its scale: a lost or
    # doubled 1/accum_steps keeps every cosine at 1 (and the loss, which accum_step
    # averages on its own), and moves every ratio to 2 or 0.5
    cos, ratio = {}, {}
    for k, u in updates[1].items():
        v = updates[2][k]
        if bool((u == 0).all()) and bool((v == 0).all()):
            continue  # visual_proj: outside the caption loss in both
        cos[k] = torch.nn.functional.cosine_similarity(u.flatten(), v.flatten(), dim=0).item()
        ratio[k] = (v.norm() / u.norm()).item()
    worst = min(cos, key=cos.get)
    worst_ratio = max(ratio, key=lambda k: abs(ratio[k] - 1))
    u_all = torch.cat([u.flatten() for u in updates[1].values()])
    v_all = torch.cat([v.flatten() for v in updates[2].values()])
    whole = torch.nn.functional.cosine_similarity(u_all, v_all, dim=0).item()
    whole_ratio = (v_all.norm() / u_all.norm()).item()
    rel = abs(results[2] - results[1]) / abs(results[1])
    # bf16 products round differently where the batch is cut in two (the library picks
    # other tiles for the other row count); a LayerNorm scale's gradient sums such
    # terms of both signs over 36,864 tokens and cancels most (0.998 read on the H100).
    # That rounding is mostly across the update's direction, so the norms move by less
    check(rel <= 1e-3 and whole >= 0.9999 and cos[worst] >= 0.995
          and abs(whole_ratio - 1) <= 1e-2 and abs(ratio[worst_ratio] - 1) <= 2e-2,
          f"genlip_train accum_freq 2 vs the simple step from the same weights (amp_bf16): loss "
          f"{results[2]:.5f} vs {results[1]:.5f} (rel {rel:.1e} <= 1e-3), update cosine "
          f"{whole:.7f} over all parameters (>= 0.9999), min {cos[worst]:.6f} at {worst} over "
          f"{len(cos)} tensors (>= 0.995); update norm ratio {whole_ratio:.6f} over all "
          f"parameters (within 1e-2 of 1), furthest {ratio[worst_ratio]:.6f} at {worst_ratio} "
          f"(within 2e-2 of 1)")
    summary["accum2_loss_rel"], summary["accum2_min_update_cosine"] = rel, cos[worst]
    summary["accum2_update_cosine"] = whole
    summary["accum2_update_norm_ratio"] = whole_ratio
    summary["accum2_furthest_tensor_norm_ratio"] = ratio[worst_ratio]
    print("genlip_train " + json.dumps(summary), flush=True)
    return flash, n


def phase_genlap_serve_train(torch, oc, sa, fa):
    """naflexgenlap_betwixt at full width: 32 ten-second clips patchified on the host
    (the factory's AudioNaFlexPatchify: full-height 64x16 mel patches, 1-D time
    positions), encode_audio in pure_bf16; one clip's prefix cache and 16 captions
    scored against it; then the packed (pack_prefix) caption step in amp_bf16, AdamW,
    clip 1.0, on 32 clips and captions: the loss falls; everything dense (62 tokens),
    no flash or short launch."""
    from open_clip_tpu_torch.data.audio import collate_audio
    from open_clip_tpu_torch.factory import generative_transforms

    import numpy as np

    torch.cuda.reset_peak_memory_stats()
    model = oc.create_model(GENLAP_MODEL, precision="pure_bf16", seed=0)
    tc = model.cfg.text_cfg
    pp, _ = generative_transforms(model)
    rng = np.random.default_rng(13)
    clips = [((0.1 * rng.standard_normal(GENLAP_SECONDS * CLAP_RATE)).astype(np.float32), CLAP_RATE)
             for _ in range(GENLIP_BATCH)]
    t0 = time.perf_counter()
    audio = {k: v.to("cuda") for k, v in collate_audio([pp(c) for c in clips]).items()}
    patchify_ms = (time.perf_counter() - t0) * 1e3
    captions = genlip_text(torch, tc, GENLIP_CAPTIONS, 48, (48, 20, 33, 9), seed=14)
    out = {"host_patchify_ms": patchify_ms, "tokens": int(audio["patches"].shape[1])}
    reset_counts(sa, fa)
    with torch.inference_mode():
        def encode(i):
            feats = model.encode_audio(audio, normalize=True)
            return feats, feats[:1].cpu()

        lat, window_s, feats, _, prof, prof_ms = serve_window(encode, 2)
        summary = profile_summary(prof, prof_ms, 2)
        out["encode_audio"] = {"batch": GENLIP_BATCH, "median_request_ms": statistics.median(lat),
                               "kernel_ms_per_request": summary["device_busy_ms_per_request"],
                               "device_idle_share": summary["device_idle_share"]}
        one = {k: v[:1] for k, v in audio.items()}
        t0 = time.perf_counter()
        scores = model.score_captions(model.prefix_cache(one), captions).cpu()
        out["score_captions_ms"] = (time.perf_counter() - t0) * 1e3
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(tuple(feats.shape) == (GENLIP_BATCH, model.cfg.embed_dim)
          and bool(torch.isfinite(feats).all()) and bool(((fn - 1).abs() < 1e-2).all())
          and tuple(scores.shape) == (GENLIP_CAPTIONS,) and bool(torch.isfinite(scores).all()),
          f"genlap_serve: encode_audio {tuple(feats.shape)} finite and unit at "
          f"{out['tokens']} tokens; cached scores {tuple(scores.shape)} finite")
    del model
    model = oc.create_model(GENLAP_MODEL, precision="amp_bf16", seed=0)
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=1e-4, wd=0.1, grad_clip_norm=1.0),
                                    model, oc.const_lr(1e-4, 0))
    step = oc.make_train_step(model.cfg, optimizer, loss_type="genlap")
    batch = {"audio": audio, "text": genlip_text(torch, tc, GENLIP_BATCH, 48, (48, 20, 33, 9), seed=15)}
    state, warm, *_ = run_steps(torch, step, oc.create_train_state(model, optimizer), batch, 2)
    state, window, step_ms, host_ms, _, wall_s = run_steps(torch, step, state, batch, 6)
    losses = [float(m["loss"]) for m in warm + window]
    check(model.cfg.trunk_cfg.pack_prefix and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and dict(fa.LAUNCHES) == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
          and dict(sa.LAUNCHES) == {"fwd": 0, "bwd": 0},
          f"genlap_train (packed): {len(losses)} losses finite, fell {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; dense (flash {dict(fa.LAUNCHES)}, short {dict(sa.LAUNCHES)})")
    out["train"] = {"batch": GENLIP_BATCH, "caption_len": 48, "pack_prefix": True,
                    "median_step_ms": statistics.median(step_ms),
                    "median_host_ms_per_step": statistics.median(host_ms),
                    "first_loss": losses[0], "last_loss": losses[-1]}
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print("genlap_serve_train " + json.dumps({"model": GENLAP_MODEL, **out}), flush=True)
    del state, model, optimizer
    torch.cuda.empty_cache()


def phase_genlip_card_vs_cpu(torch, oc, fa):
    """fp32, TF32 off: naflexgenlip_b16's widths (vocabulary 100280) at depth 2, drop path
    0, two images of 448 valid tokens (16x28) and captions of 96 ids (one ragged): 544
    tokens, so the card's trunk takes the flash kernels (CUDA-core bodies) with
    prefix_len 448 and the CPU the dense bias. Logits on the valid rows, the caption
    loss and every gradient, card against CPU. Padded query rows are left out by name:
    the dense bias opens their diagonal, the flash mask does not (models/genlip.py);
    the loss reads no padded row, since the text's validity is front-contiguous and
    every image patch is valid."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = json.loads(json.dumps(oc.get_model_config(GENLIP_MODEL)))
    raw["genlip_cfg"].update(depth=2, drop_path_rate=0.0)
    name = GENLIP_MODEL + "-2layer"
    oc.add_model_config(raw, name=name)
    image = genlip_image(torch, 2, ((16, 28),), seed=21, device="cpu")
    model = oc.create_model(name, precision="fp32", seed=3, device="cpu")
    text = genlip_text(torch, model.cfg.text_cfg, 2, 96, (96, 57), seed=22, device="cpu")
    ni = image["patches"].shape[1]
    rows = torch.cat([image["patch_valid"], text != model.cfg.text_cfg.pad_id], 1)
    results, logits = {}, {}
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(device)
        batch = {k: v.to(device) for k, v in image.items()}
        reset_counts(fa)
        with tally_flash_masks(fa) as masks:
            with torch.no_grad():
                logits[device] = m(batch, text.to(device))["logits"][rows.to(device)].cpu().double()
            loss = m(batch, text.to(device), compute_loss=True)["loss"]
            loss.backward()
        results[device] = ({k: p.grad.detach().cpu().double() for k, p in m.named_parameters()
                            if p.grad is not None}, loss.item())
        if device == "cuda":
            launched = (dict(fa.LAUNCHES), dict(fa.FWD_BODIES), dict(fa.BWD_BODIES), dict(masks))
        del m, loss
    check(launched == ({"fwd": 4, "bwd_dq": 2, "bwd_dkv": 2}, {"wgmma": 0, "simt": 4},
                       {"wgmma": 0, "simt": 2}, {(ni + 96, True, ni): 4}),
          f"genlip fp32 card run: flash launches, forward and backward by body, calls by (L, "
          f"causal, prefix) {launched} (2 in the logits forward, 2 in the loss's, 2 backward "
          f"passes, all CUDA-core, prefix_len {ni})")
    err = ((logits["cuda"] - logits["cpu"]).abs().max() / logits["cpu"].abs().max()).item()
    check(bool(torch.isfinite(logits["cuda"]).all()) and err <= 1e-4,
          f"genlip logits card vs CPU fp32 on the {int(rows.sum())} valid rows of "
          f"{rows.numel()} (vocabulary {logits['cpu'].shape[-1]}): max abs diff {err:.2e} of the "
          "largest (<= 1e-4)")
    grads_card_vs_cpu(torch, results, "genlip")


# ---------------------------------------------------------------------------
# the conv towers: ModifiedResNet (RN50) and ConvNeXt (convnext_base_w)
# ---------------------------------------------------------------------------

def conv_serve(torch, oc, sa, name, batch, label):
    """Serving a conv tower in pure_bf16: a 10-class classifier (one encode_text call),
    requests of ``batch`` uint8 256x320 images (device preprocess -> encode_image ->
    logits -> top-5), timed and profiled like phase 2. The image tower launches no
    attention kernel; the text tower the short forward once a block."""
    torch.cuda.reset_peak_memory_stats()
    model, _, preprocess = oc.create_model_and_transforms(name, precision="pure_bf16", seed=0)
    lt = model.cfg.text_cfg.layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    requests = [torch.randint(0, 256, (batch, *IMAGE_HW, 3), dtype=torch.uint8, device="cuda",
                              generator=gen) for _ in range(4)]
    with torch.inference_mode():
        reset_counts(sa)
        clf = oc.build_zero_shot_classifier(model, oc.get_tokenizer(name),
                                            oc.IMAGENET_CLASSNAMES[:CLASSES],
                                            oc.SIMPLE_IMAGENET_TEMPLATES,
                                            num_classes_per_batch=CLASSES)
        torch.cuda.synchronize()
        text_launches = dict(sa.LAUNCHES)
        clf32 = clf.float()

        def request(i):
            feats = model.encode_image(preprocess(requests[i % 4]), normalize=True)
            return feats, (100.0 * feats.float() @ clf32).topk(5, dim=-1).indices.cpu()

        reset_counts(sa)
        t0 = time.perf_counter()
        request(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        lat, window_s, feats, top5, prof, prof_wall_ms = serve_window(request, 3)
        image_launches = dict(sa.LAUNCHES)
    check(text_launches == {"fwd": lt, "bwd": 0} and image_launches == {"fwd": 0, "bwd": 0},
          f"{label}: short launches {text_launches} for the classifier (expect {lt}), "
          f"{image_launches} for {1 + len(lat) + 3} image-tower calls (expect none)")
    fn = torch.linalg.vector_norm(feats.float(), dim=-1)
    check(tuple(feats.shape) == (batch, model.cfg.embed_dim) and bool(torch.isfinite(feats).all())
          and bool(((fn - 1).abs() < 1e-2).all()) and tuple(top5.shape) == (batch, 5)
          and int(top5.min()) >= 0 and int(top5.max()) < CLASSES,
          f"{label} request output: features {tuple(feats.shape)} finite and unit, top-5")
    summary = profile_summary(prof, prof_wall_ms, 3)
    print(f"{label} " + json.dumps({
        "model": name, "precision": "pure_bf16", "batch": batch, "image_hw": list(IMAGE_HW),
        "first_request_ms": first_ms, "window_s": window_s, "window_requests": len(lat),
        "images_per_s": batch * len(lat) / window_s, "median_request_ms": statistics.median(lat),
        "min_request_ms": min(lat), "kernel_ms_per_request": summary["device_busy_ms_per_request"],
        "class_ms_per_request": summary["class_ms_per_request"],
        "device_idle_share": summary["device_idle_share"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    print(f"{label}_profile " + json.dumps(summary), flush=True)
    return text_launches["fwd"]


def running_stats(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.endswith(("running_mean", "running_var"))}


def phase_rn50_train(torch, oc, sa):
    """RN50 b256 amp_bf16, AdamW, clip 1.0, one fixed batch, timed and profiled like
    phase 4: the loss falls, 12 + 12 short launches a step (the text tower). Then one
    step each: plain, where the running statistics move by the merge (0.9 of theirs
    plus 0.1 of the batch's, recorded by a train-mode forward of the same weights);
    with freeze_bn_stats and with accum_steps 2 (GradCache), where they do not move."""
    from open_clip_tpu_torch.models.clip import clip_forward
    from open_clip_tpu_torch.models.resnet import BN_MOMENTUM

    torch.cuda.reset_peak_memory_stats()
    model = oc.create_model(RN_MODEL, precision="amp_bf16", seed=0)
    lt = model.cfg.text_cfg.layers
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                    model, oc.const_lr(5e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer)
    batch = train_batch(torch, model.cfg, RN_BATCH, "cuda", seed=11)
    state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
    n = max(3, math.ceil(TRAIN_WINDOW_S / 2 * 1e3 / warm_ms[-1]))
    reset_counts(sa)
    state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state, batch, n)
    launched = dict(sa.LAUNCHES)
    losses = [float(m["loss"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"rn50_train: {len(losses)} losses finite, fell {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(launched == {"fwd": lt * n, "bwd": lt * n} and sa.BWD_BODIES == {"mma": lt * n, "simt": 0},
          f"rn50_train: short launches {launched}, backward by body {sa.BWD_BODIES} in {n} "
          f"steps (expect {lt} of each a step, on the tensor cores)")
    state, summary = profiled_steps(torch, step, state, batch)
    print("rn50_train_profile " + json.dumps(summary), flush=True)
    median = statistics.median(step_ms)
    # the running statistics: the plain step's merge, then a frozen and a GradCache step
    sink = []
    with torch.no_grad():
        clip_forward(model, batch["image"], batch["text"], train=True, stats_sink=sink)
    names = {id(m): n for n, m in model.named_modules()}
    want = {}
    for bn, mean, var in sink:
        prefix = names[id(bn)]
        want[prefix + ".running_mean"] = (1 - BN_MOMENTUM) * bn.running_mean.detach() \
            + BN_MOMENTUM * mean
        want[prefix + ".running_var"] = (1 - BN_MOMENTUM) * bn.running_var.detach() \
            + BN_MOMENTUM * var
    before = running_stats(model)
    state, _ = step(state, batch)
    after = running_stats(model)
    err = max(((after[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-6)).item()
              for k in want)
    moved = max((after[k] - before[k]).abs().max().item() for k in after)
    n_bn = sum(type(m).__name__ == "BatchNorm2d" for m in model.modules())
    check(set(want) == set(after) and len(after) == 2 * n_bn and err <= 1e-3 and moved > 0,
          f"rn50_train: the plain step moved the {len(after)} running statistics by the merge "
          f"(max change {moved:.3e}; against 0.9 running + 0.1 batch: rel err {err:.2e} <= 1e-3)")
    frozen = {}
    for label, kw in (("freeze_bn_stats", {"freeze_bn_stats": True}),
                      ("accum_steps 2", {"accum_steps": 2})):
        before = running_stats(model)
        state, m = oc.make_train_step(model.cfg, optimizer, **kw)(state, batch)
        frozen[label] = float(m["loss"])
        after = running_stats(model)
        check(all(torch.equal(after[k], before[k]) for k in after) and math.isfinite(frozen[label]),
              f"rn50_train[{label}]: the running statistics did not move, loss "
              f"{frozen[label]:.4f} finite")
    print("rn50_train " + json.dumps({
        "model": RN_MODEL, "precision": "amp_bf16", "batch": RN_BATCH, "window_steps": n,
        "window_s": wall_s, "images_per_s": RN_BATCH * n / wall_s, "median_step_ms": median,
        "min_step_ms": min(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
        "host_lead_ms_at_end": lead_ms, "first_loss": losses[0], "last_loss": losses[-1],
        "kernel_ms_per_step": summary["device_busy_ms_per_step"],
        "class_ms_per_step": summary["class_ms_per_step"],
        "idle_share_by_window": 1.0 - summary["device_busy_ms_per_step"] / median,
        "device_idle_share_profiled": summary["device_idle_share"],
        "short_launches_per_step": {k: v / n for k, v in launched.items()},
        "running_stats_merge_rel_err": err, "losses_frozen_and_accum": frozen,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    return launched, n


def cut_rn(oc, name: str, layers, text: int) -> str:
    raw = json.loads(json.dumps(oc.get_model_config(name)))
    raw["vision_cfg"]["layers"], raw["text_cfg"]["layers"] = list(layers), text
    cut = f"{name}-cut"
    oc.add_model_config(raw, name=cut)
    return cut


def conv_card_vs_cpu(torch, oc, name, batch_size, label, seed, zero=()):
    """fp32, TF32 off for the matmuls and cuDNN (an fp32 convolution is TF32 in cuDNN
    by default): features (inference), then one train-mode forward and backward:
    the loss and every gradient, card against CPU; the gradients named in ``zero``,
    zero in exact arithmetic, by their size. Returns both models and the batch."""
    from open_clip_tpu_torch.loss import clip_loss
    from open_clip_tpu_torch.models.clip import clip_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, feats, models = {}, {}, {}
    batch = None
    for device in ("cuda", "cpu"):
        model = oc.create_model(name, precision="fp32", seed=seed, device=device)
        if batch is None:
            batch = train_batch(torch, model.cfg, batch_size, "cpu", seed=seed)
        image, text = batch["image"].to(device), batch["text"].to(device)
        with torch.inference_mode():
            feats[device] = (model.encode_image(image, normalize=True).cpu(),
                             model.encode_text(text, normalize=True).cpu())
        out = clip_forward(model, image, text, train=True)
        loss = clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
        loss.backward()
        results[device] = ({k: p.grad.detach().cpu().double() for k, p in model.named_parameters()
                            if p.grad is not None}, loss.item())
        models[device] = model
    for i, which in enumerate(("encode_image", "encode_text")):
        cos = torch.nn.functional.cosine_similarity(feats["cuda"][i].double(),
                                                    feats["cpu"][i].double(), dim=-1).min().item()
        check(bool(torch.isfinite(feats["cuda"][i]).all()) and cos >= COSINE_MIN,
              f"{label} {which} card vs CPU fp32: min cosine {cos:.7f} (>= {COSINE_MIN})")
    # a gradient that is zero in exact arithmetic is rounding noise on both sides: it is
    # held to its size, not its direction
    g_gpu, g_cpu = results["cuda"][0], results["cpu"][0]
    top = max(g.norm().item() for g in g_cpu.values())
    for k in zero:
        size = max(g_gpu[k].norm().item(), g_cpu[k].norm().item()) / top
        check(size <= 1e-6, f"{label}: the gradient of {k}, zero in exact arithmetic, is "
              f"{size:.1e} of the largest on the card and the CPU (<= 1e-6)")
    grads_card_vs_cpu(torch, {d: ({k: g for k, g in r[0].items() if k not in zero}, r[1])
                              for d, r in results.items()}, label)
    return models, batch


def phase_rn_card_vs_cpu(torch, oc):
    """RN50's widths with one block a stage and 2 text blocks, batch 4 at 224 px: the
    features, the loss and every gradient, then one train step's running statistics,
    card against CPU."""
    name = cut_rn(oc, RN_MODEL, (1, 1, 1, 1), 2)
    # the attention pool's key bias: a softmax does not see a constant added to a row
    models, batch = conv_card_vs_cpu(torch, oc, name, 4, "RN50", seed=5,
                                     zero=("visual.attnpool.k_proj.bias",))
    stats = {}
    for device, model in models.items():
        model.zero_grad(set_to_none=True)
        optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                        model, oc.const_lr(5e-4, 0))
        oc.make_train_step(model.cfg, optimizer)(oc.create_train_state(model, optimizer),
                                                 {k: v.to(device) for k, v in batch.items()})
        stats[device] = {k: v.cpu() for k, v in running_stats(model).items()}
    err = max(((stats["cuda"][k] - v).abs().max() / v.abs().max().clamp_min(1e-6)).item()
              for k, v in stats["cpu"].items())
    moved = max((v - 1.0 if k.endswith("var") else v).abs().max().item()
                for k, v in stats["cpu"].items())
    check(err <= 1e-4 and moved > 0,
          f"RN50 running statistics after one step, card vs CPU fp32: rel err {err:.2e} "
          f"(<= 1e-4) over {len(stats['cpu'])} tensors")


@contextlib.contextmanager
def tally_ln_rows(fl):
    """While open, count the LayerNorm backward kernel's launches by (rows, width)."""
    tally = {}
    ln = fl.layer_norm_bwd

    def ln_(x, dy, scale, eps=1e-5):
        key = (x.numel() // x.shape[-1], x.shape[-1])
        tally[key] = tally.get(key, 0) + 1
        return ln(x, dy, scale, eps)

    fl.layer_norm_bwd = ln_
    try:
        yield tally
    finally:
        fl.layer_norm_bwd = ln


def phase_convnext_train(torch, oc, sa, fl, layers_mod):
    """convnext_base_w b128 amp_bf16, AdamW, clip 1.0, the config's drop path 0.1, one
    fixed batch: a window with the fused LayerNorm backward off, then on (66 of its
    launches a step, 5 at the stage-0 shape, each at a shape of ``CNX_LN_SHAPES``, which
    phase_ln_bwd_kernels holds against the plain version), each timed and profiled like
    phase 4; the two switches' gradients from the same weights and masks, whole and for
    each LayerNorm's weight and bias, and the loss under full remat against the plain
    forward's with the same masks."""
    from open_clip_tpu_torch.loss import clip_loss
    from open_clip_tpu_torch.models.clip import clip_forward

    torch.cuda.reset_peak_memory_stats()
    model = oc.create_model(CNX_MODEL, precision="amp_bf16", seed=0)
    lt = model.cfg.text_cfg.layers
    blocks = sum(len(s.blocks) for s in model.visual.stages)
    lns = 1 + blocks + (len(model.visual.stages) - 1) + 1 + 2 * lt + 1
    s0_lns = 1 + len(model.visual.stages[0].blocks) + 1  # stem, stage 0, stage 1's downsample
    optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                    model, oc.const_lr(5e-4, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(model.cfg, optimizer)
    batch = train_batch(torch, model.cfg, CNX_TRAIN_BATCH, "cuda", seed=12)
    lines, ln_tally, short = {}, {}, {}
    for fused in (False, True):
        layers_mod.FUSED_LN_BWD = fused
        try:
            state, warm, warm_ms, _, _, _ = run_steps(torch, step, state, batch, 2)
            n = max(3, math.ceil(TRAIN_WINDOW_S / 2 * 1e3 / warm_ms[-1]))
            reset_counts(sa, fl)
            with tally_ln_rows(fl) as tally:
                state, window, step_ms, host_ms, lead_ms, wall_s = run_steps(torch, step, state,
                                                                             batch, n)
            launched, ln_launched = dict(sa.LAUNCHES), fl.LAUNCHES["bwd"]
            state, summary = profiled_steps(torch, step, state, batch)
        finally:
            layers_mod.FUSED_LN_BWD = False
        tag = "on" if fused else "off"
        losses = [float(m["loss"]) for m in warm + window]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"convnext_train[fused_ln {tag}]: {len(losses)} losses finite, fell "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        check(launched == {"fwd": lt * n, "bwd": lt * n}
              and ln_launched == (lns * n if fused else 0)
              and (not fused or tally.get(CNX_LN_SHAPES["convnext_s0"], 0) == s0_lns * n)
              and set(tally) <= set(CNX_LN_SHAPES.values()),
              f"convnext_train[fused_ln {tag}]: short launches {launched}, LayerNorm backward "
              f"{ln_launched} ({tally}) in {n} steps (expect {lt} short of each a step"
              + (f", {lns} LayerNorm backwards, {s0_lns} at the stage-0 shape)" if fused else ")"))
        short[tag], ln_tally[tag] = (launched, n), (dict(tally), n)
        median = statistics.median(step_ms)
        lines[tag] = {"window_steps": n, "window_s": wall_s, "images_per_s": CNX_TRAIN_BATCH * n / wall_s,
                      "median_step_ms": median, "min_step_ms": min(step_ms),
                      "median_host_ms_per_step": statistics.median(host_ms),
                      "host_lead_ms_at_end": lead_ms, "first_loss": losses[0],
                      "last_loss": losses[-1],
                      "kernel_ms_per_step": summary["device_busy_ms_per_step"],
                      "class_ms_per_step": summary["class_ms_per_step"],
                      "layer_norm_bwd_ms_per_step": summary["class_ms_per_step"].get(
                          "layer_norm_bwd"),
                      "idle_share_by_window": 1.0 - summary["device_busy_ms_per_step"] / median,
                      "device_idle_share_profiled": summary["device_idle_share"]}
        print(f"convnext_train_profile[fused_ln {tag}] " + json.dumps(summary), flush=True)

    ln_params = {f"{m}.{n}": p for m, mod in model.named_modules()
                 if isinstance(mod, torch.nn.LayerNorm) for n, p in mod.named_parameters()}
    check(len(ln_params) == 2 * lns, f"convnext_train: {len(ln_params)} LayerNorm weights and "
          f"biases (expect {2 * lns})")

    # a batch the windows did not fit, so that the loss and every gradient stay far
    # from 0 and each LayerNorm's gradient carries more than rounding
    held = train_batch(torch, model.cfg, CNX_TRAIN_BATCH, "cuda", seed=13)

    def grads(fused: bool, remat: bool = False):
        """The loss on ``held``, every gradient flattened into one fp32 vector, and
        each LayerNorm weight's and bias's gradient in fp32."""
        layers_mod.FUSED_LN_BWD = fused
        try:
            model.zero_grad(set_to_none=True)
            out = clip_forward(model, held["image"], held["text"], train=True, remat=remat,
                               generator=torch.Generator(device="cuda").manual_seed(5))
            loss = clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
            loss.backward()
            got = torch.cat([p.grad.float().flatten() for p in model.parameters()])
            ln = {k: p.grad.float() for k, p in ln_params.items()}
            model.zero_grad(set_to_none=True)
            return loss.item(), got, ln
        finally:
            layers_mod.FUSED_LN_BWD = False

    loss_off, g_off, ln_off = grads(False)
    loss_on, g_on, ln_on = grads(True)
    cos = torch.nn.functional.cosine_similarity(g_off, g_on, dim=0).item()
    ln_cos = {k: torch.nn.functional.cosine_similarity(ln_off[k].flatten(), ln_on[k].flatten(),
                                                       dim=0).item() for k in ln_params}
    worst = min(ln_cos, key=ln_cos.get)
    check(abs(loss_on - loss_off) <= 1e-6 * abs(loss_off) and cos >= 0.999
          and ln_cos[worst] >= 0.999,
          f"convnext_train: gradients with the fused LayerNorm backward against without, the "
          f"same weights and masks: cosine {cos:.6f} (>= 0.999) over all, >= "
          f"{ln_cos[worst]:.6f} ({worst}) for each of the {len(ln_cos)} LayerNorm weights "
          f"and biases (>= 0.999), loss {loss_on:.6f} vs {loss_off:.6f}")
    del g_on, ln_on
    train_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    loss_remat, g_remat, _ = grads(False, remat=True)
    remat_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    cos_remat = torch.nn.functional.cosine_similarity(g_off, g_remat, dim=0).item()
    check(abs(loss_remat - loss_off) <= 1e-6 * abs(loss_off) and cos_remat >= 0.999,
          f"convnext_train[remat]: loss {loss_remat:.6f} vs {loss_off:.6f} without remat (the "
          f"same masks), gradient cosine {cos_remat:.6f}")
    print("convnext_train " + json.dumps({
        "model": CNX_MODEL, "precision": "amp_bf16", "batch": CNX_TRAIN_BATCH,
        "drop_path": model.cfg.vision_cfg.timm_drop_path, "fused_ln_off": lines["off"],
        "fused_ln_on": lines["on"], "grad_cosine_fused_ln": cos,
        "min_ln_grad_cosine_fused_ln": ln_cos[worst], "min_ln_grad_cosine_at": worst,
        "loss_remat": loss_remat, "loss_plain": loss_off, "grad_cosine_remat": cos_remat,
        "remat_peak_gib": remat_gib, "ln_bwd_launches_by_rows_width": {
            f"{r}x{w}": c for (r, w), c in ln_tally["on"][0].items()},
        "peak_mem_gib": train_gib}), flush=True)
    return short, ln_tally


def phase_convnext_card_vs_cpu(torch, oc):
    """convnext_base_w's widths with blocks 1, 1, 2, 1 and 2 text blocks, drop path 0
    (the two devices' generators differ), batch 2 at 256 px: features, the loss and
    every gradient, card against CPU."""
    from open_clip_tpu_torch.models import convnext

    raw = json.loads(json.dumps(oc.get_model_config(CNX_MODEL)))
    arch = raw["vision_cfg"]["timm_model_name"]
    convnext.CONVNEXT_CFGS[arch + "_cut"] = ((1, 1, 2, 1), convnext.CONVNEXT_CFGS[arch][1])
    raw["vision_cfg"].update(timm_model_name=arch + "_cut", timm_drop_path=0.0)
    raw["text_cfg"]["layers"] = 2
    oc.add_model_config(raw, name=CNX_MODEL + "-cut")
    conv_card_vs_cpu(torch, oc, CNX_MODEL + "-cut", 2, "convnext", seed=6)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    import open_clip_tpu_torch as oc
    from open_clip_tpu_torch.ops import _build
    from open_clip_tpu_torch.ops import flash_attention as fa
    from open_clip_tpu_torch.ops import fused_ln as fl
    from open_clip_tpu_torch.ops import layers as layers_mod
    from open_clip_tpu_torch.ops import short_attention as sa
    from open_clip_tpu_torch.ops import swin_attention as swa
    from open_clip_tpu_torch.ops import switchback as sb
    from open_clip_tpu_torch.ops import window_attention as wa
    from open_clip_tpu_torch.models import blocks
    from open_clip_tpu_torch.models import naflex_vit as nf
    from open_clip_tpu_torch.ops import attention as attn

    sources = ("short_attention", "layer_norm_bwd", "flash_attention", "window_attention",
               "switchback")
    timed("build", _build.build_all, sources)
    print(f"build {PHASE_S['build']:.1f} s", flush=True)
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    fwd_records = timed("kernels", phase_kernels, torch, sa,
                        text_batch=CLASSES * len(oc.SIMPLE_IMAGENET_TEMPLATES))
    bwd_records = timed("attention_bwd_kernels", phase_attention_bwd_kernels, torch, sa)
    ln_records = timed("ln_bwd_kernels", phase_ln_bwd_kernels, torch, fl)
    flash_records = timed("flash_kernels", phase_flash_kernels, torch, fa)
    window_records = timed("window_kernels", phase_window_kernels, torch, wa, swa)
    timed("window_groups", phase_window_groups, torch, wa, swa)
    sb_records, sb_q_records = timed("switchback_kernels", phase_switchback_kernels, torch, sb)
    launches, calls = timed("serve", phase_serve, torch, oc, sa)
    timed("card_vs_cpu", phase_card_vs_cpu, torch, oc, sa)
    tally, steps, plain_summary = timed("train", phase_train, torch, oc, sa, fl, layers_mod,
                                        fused_ln=False)
    tally_ln, steps_ln, fused_summary = timed("train_fused_ln", phase_train, torch, oc, sa, fl,
                                              layers_mod, fused_ln=True)
    check(abs(fused_summary["first_loss"] - plain_summary["first_loss"]) <= 2e-2,
          f"first loss with the fused LayerNorm backward {fused_summary['first_loss']:.4f} vs "
          f"{plain_summary['first_loss']:.4f} without (bf16 tolerance 2e-2)")
    print("fused_ln_step " + json.dumps({
        "median_step_ms_off": plain_summary["median_step_ms"],
        "median_step_ms_on": fused_summary["median_step_ms"],
        "device_busy_ms_per_step_off": plain_summary["device_busy_ms_per_step"],
        "device_busy_ms_per_step_on": fused_summary["device_busy_ms_per_step"],
        "median_host_ms_per_step_off": plain_summary["median_host_ms_per_step"],
        "median_host_ms_per_step_on": fused_summary["median_host_ms_per_step"],
        "peak_mem_gib_off": plain_summary["peak_mem_gib"],
        "peak_mem_gib_on": fused_summary["peak_mem_gib"]}), flush=True)
    cli_batch_ms = timed("cli", phase_cli, torch)
    short_simt_launches = timed("train_card_vs_cpu", phase_train_card_vs_cpu, torch, oc, sa)
    nf_serve_launches, nf_serve_calls = timed("naflex_serve", phase_naflex_serve, torch, oc, sa,
                                              fa)
    nf_train_launches, nf_steps = timed("naflex_train", phase_naflex_train, torch, oc, sa, fa)
    timed("naflex_cli", phase_naflex_cli, torch, fa)
    timed("naflex_card_vs_cpu", phase_naflex_card_vs_cpu, torch, oc, sa, fa)
    clap_serve_launches, clap_serve_bodies, clap_calls = timed("clap_serve", phase_clap_serve,
                                                               torch, oc, sa, swa, wa)
    clap_train_launches, clap_fwd_bodies, clap_bodies, clap_steps = timed(
        "clap_train", phase_clap_train, torch, oc, sa, swa, wa)
    timed("clap_cli", phase_clap_cli, torch, swa)
    panel_fwd_simt_launches, panel_simt_launches = timed("clap_card_vs_cpu", phase_clap_card_vs_cpu,
                                                         torch, oc, swa)
    swin_serve_launches, swin_serve_bodies, swin_calls = timed("swin_serve", phase_swin_serve,
                                                               torch, oc, sa, wa)
    swin_train_launches, swin_fwd_bodies, swin_steps = timed("swin_train", phase_swin_train, torch,
                                                             oc, sa, wa)
    h14_bodies, h14_quantize, h14_steps = timed("h14_train", phase_h14_train, torch, oc, sa, sb,
                                                blocks)
    l14_tally, l14_steps = timed("l14_train", phase_l14_train, torch, oc, sa, fl, blocks)
    b32_sb_launches, b32_sb_steps = timed("b32_switchback", phase_b32_switchback, torch, oc, sa,
                                          sb, blocks, plain_summary["first_loss"])
    timed("h14_card_vs_cpu", phase_h14_card_vs_cpu, torch, oc, sb, blocks)
    sg_text_launches, sg_serve_launches, sg_calls = timed(
        "siglip_serve", phase_siglip_serve, torch, oc, sa, fa, attn, nf)
    sg384_launches, sg384_calls = timed("siglip384_serve", phase_siglip384_serve, torch, oc, sa, fa,
                                        attn, nf)
    sg_tally, sg_steps, sg_li, sg_lt = timed("siglip_train", phase_siglip_train, torch, oc, sa,
                                             blocks)
    timed("siglip_cli", phase_siglip_cli, torch, sa)
    timed("siglip_card_vs_cpu", phase_siglip_card_vs_cpu, torch, oc, sa)
    import torch.distributed as dist
    from open_clip_tpu_torch.parallel.distributed import init_distributed

    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        timed("dist_losses", phase_dist_losses, torch)
        dist_tally, dist_steps = timed("dist_train", phase_dist_train, torch, oc, sa, fl)
    finally:
        dist.destroy_process_group()
    timed("dist_cli", phase_dist_cli)
    timed("decode", phase_decode, torch)
    data_tally, data_steps = timed("data_train", phase_data_train, torch, oc, sa, fl, {
        "median_step_ms": plain_summary["median_step_ms"], "cli_host_batch_ms": cli_batch_ms})
    timed("data_card_vs_cpu", phase_data_card_vs_cpu, torch, oc)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        load_launches = timed("pretrained_load", phase_pretrained_load, torch, oc, sa, tmp)
        resize_l65, resize_l64 = timed("pretrained_resize", phase_pretrained_resize, torch, oc,
                                       sa, tmp)
        bv_l196, bv_l64 = timed("siglip_big_vision", phase_siglip_big_vision, torch, oc, sa, tmp)
        ft_tally, ft_steps, ft_cli_tally = timed("finetune", phase_finetune, torch, oc, sa, fl,
                                                 tmp, plain_summary)
    nfc_serve_launches, nfc_calls, nfc_audio = timed("naflexclap_serve", phase_naflexclap_serve,
                                                     torch, oc, sa, fa)
    nfc_train, nfc_steps = timed("naflexclap_train", phase_naflexclap_train, torch, oc, sa, fa,
                                 nfc_audio)
    timed("naflexclap_card_vs_cpu", phase_naflexclap_card_vs_cpu, torch, oc, fa)
    timed("audio_data_train", phase_audio_data_train, torch, oc, sa, fa)
    nfd_flash, nfd_short, nfd_steps = timed("naflex_data_train", phase_naflex_data_train, torch,
                                            oc, sa, fa)
    opt_tally, opt_steps = timed("optimizers", phase_optimizers, torch, oc, sa)
    pd_tally, pd_steps = timed("patch_dropout_train", phase_patch_dropout_train, torch, oc, sa)
    with tally_by_len(sa) as rd_tally:
        rd_steps = timed("remat_dots", phase_remat_dots, torch, oc, sa, blocks)
    coca_serve_tally, coca_tf_tally, coca_calls = timed("coca_serve", phase_coca_serve, torch, oc,
                                                        sa, attn, nf)
    coca_tally, coca_steps = timed("coca_train", phase_coca_train, torch, oc, sa)
    distill_tally, distill_steps = timed("distill_train", phase_distill_train, torch, oc, sa, fl)
    gl_serve_launches, gl_serve_calls = timed("genlip_serve", phase_genlip_serve, torch, oc, sa, fa)
    gl_train, gl_steps = timed("genlip_train", phase_genlip_train, torch, oc, sa, fa, blocks)
    timed("genlap_serve_train", phase_genlap_serve_train, torch, oc, sa, fa)
    timed("genlip_card_vs_cpu", phase_genlip_card_vs_cpu, torch, oc, fa)
    rn_text_serve = timed("rn50_serve", conv_serve, torch, oc, sa, RN_MODEL, RN_BATCH,
                          "rn50_serve")
    rn_train, rn_steps = timed("rn50_train", phase_rn50_train, torch, oc, sa)
    timed("rn_card_vs_cpu", phase_rn_card_vs_cpu, torch, oc)
    cnx_text_serve = timed("convnext_serve", conv_serve, torch, oc, sa, CNX_MODEL,
                           CNX_SERVE_BATCH, "convnext_serve")
    cnx_short, cnx_ln = timed("convnext_train", phase_convnext_train, torch, oc, sa, fl,
                              layers_mod)
    timed("convnext_card_vs_cpu", phase_convnext_card_vs_cpu, torch, oc)

    print("phase_s " + json.dumps(PHASE_S), flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    # launches measured on the main paths, each driven with the counts at 0 before it:
    # serving (the image tower runs once per request, the text tower once per
    # classifier build) and the train window (attention kernels with the switch
    # off, the LayerNorm backward with it on)
    kernels = []
    # this slice's paths at the same shapes: the optimizer windows (ViT-B-32 b256, 50
    # and 77 tokens), the text tower of the NaFlex data run, of the patch-dropout
    # windows and of the ViT-L-14 remat windows (77 tokens)
    new_paths = {(d, "vision"): opt_tally.get((d, 50), 0) for d in ("fwd", "bwd")}
    new_paths.update({(d, "text"): opt_tally.get((d, 77), 0) + nfd_short[d]
                      + pd_tally.get((d, 77), 0) + rd_tally.get((d, 77), 0)
                      for d in ("fwd", "bwd")})
    # this slice's paths at the same shapes: CoCa's image tower (50 tokens) serving,
    # teacher-forced and training; the distillation window (student and teacher)
    coca_paths = {(d, t): (distill_tally.get((d, t), 0) + (
        coca_serve_tally.get((d, 50), 0) + coca_tf_tally.get((d, 50), 0)
        + coca_tally.get((d, 50), 0) if t == "vision" else 0))
        for d in ("fwd", "bwd") for t in ("vision", "text")}
    for tower in ("vision", "text"):
        n_train, n_dist = tally[("fwd", tower)], dist_tally[("fwd", tower)]
        n_data = data_tally.get(("fwd", tower), 0)
        n_ft, n_ft_cli = ft_tally[("fwd", tower)], ft_cli_tally[("fwd", tower)]
        n_rn = rn_text_serve if tower == "text" else 0  # RN50's classifier (B=70, H=8)
        kernels.append(dict(fwd_records[tower],
                            launches=(launches[tower] + n_train + n_dist + n_data
                                      + load_launches[tower] + n_ft + n_ft_cli
                                      + new_paths[("fwd", tower)] + coca_paths[("fwd", tower)]
                                      + n_rn),
                            launches_rn50_classifier=n_rn,
                            launches_coca_and_distill_paths=coca_paths[("fwd", tower)],
                            launches_distill_per_train_step=distill_tally.get(("fwd", tower), 0)
                            / distill_steps,
                            launches_step_option_paths=new_paths[("fwd", tower)],
                            launches_pretrained_load=load_launches[tower],
                            launches_finetune=n_ft, launches_per_finetune_step=n_ft / ft_steps,
                            launches_finetune_cli=n_ft_cli,
                            launches_pretrained_resize=(resize_l65 if tower == "vision"
                                                        else resize_l64),
                            launches_pretrained_resize_len=65 if tower == "vision" else 64,
                            launches_serving=launches[tower], launches_training=n_train,
                            launches_per_call=launches[tower] / calls[tower],
                            launches_per_train_step=n_train / steps,
                            launches_dist_training=n_dist,
                            launches_per_dist_train_step=n_dist / dist_steps,
                            launches_data_training=n_data,
                            launches_per_data_train_step=n_data / data_steps))
    # the short backward: the fused tensor-core body in the bf16 train windows (plain
    # and under FSDP2); the two-kernel CUDA-core body in the fp32 train step of phase 6
    for tower in ("vision", "text"):
        n_train, n_dist = tally[("bwd", tower)], dist_tally[("bwd", tower)]
        n_data = data_tally.get(("bwd", tower), 0)
        n_ft, n_ft_cli = ft_tally[("bwd", tower)], ft_cli_tally[("bwd", tower)]
        n_rn = rn_train["bwd"] if tower == "text" else 0  # RN50 b256: the same shape
        kernels.append(dict(bwd_records[(tower, "bfloat16")],
                            launches=(n_train + n_dist + n_data + n_ft + n_ft_cli
                                      + new_paths[("bwd", tower)] + coca_paths[("bwd", tower)]
                                      + n_rn),
                            launches_rn50_train=n_rn,
                            launches_rn50_per_train_step=n_rn / rn_steps,
                            launches_coca_and_distill_paths=coca_paths[("bwd", tower)],
                            launches_step_option_paths=new_paths[("bwd", tower)],
                            launches_finetune=n_ft, launches_per_finetune_step=n_ft / ft_steps,
                            launches_finetune_cli=n_ft_cli,
                            launches_training=n_train,
                            launches_per_train_step=n_train / steps,
                            launches_dist_training=n_dist,
                            launches_per_dist_train_step=n_dist / dist_steps,
                            launches_data_training=n_data,
                            launches_per_data_train_step=n_data / data_steps))
    kernels.append(dict(bwd_records[("vision", "float32")], launches=short_simt_launches,
                        launches_path="fp32 train step, B=8 (phase 6)"))
    # ViT-L-14's image tower (L=257): the two-pass forward and the two-kernel backward in
    # the ViT-L-14 train window
    kernels.append(dict(fwd_records["l257"],
                        launches=l14_tally[("fwd", "vision")] + rd_tally.get(("fwd", 257), 0),
                        launches_remat_dots=rd_tally.get(("fwd", 257), 0),
                        launches_per_train_step=l14_tally[("fwd", "vision")] / l14_steps))
    kernels.append(dict(bwd_records[("l257", "bfloat16")],
                        launches=l14_tally[("bwd", "vision")] + rd_tally.get(("bwd", 257), 0),
                        launches_remat_dots=rd_tally.get(("bwd", 257), 0),
                        launches_per_train_step=l14_tally[("bwd", "vision")] / l14_steps))
    # ViT-B-16 at batch 256: 197 tokens, 99 under patch dropout 0.5 (patch_dropout_train)
    for name, length, prob in (("l197", 197, 0.0), ("l99", 99, PD_PROB)):
        kernels.append(dict(fwd_records[name], launches=pd_tally.get(("fwd", length), 0),
                            launches_per_train_step=pd_tally.get(("fwd", length), 0)
                            / pd_steps[prob]))
        kernels.append(dict(bwd_records[(name, "bfloat16")],
                            launches=pd_tally.get(("bwd", length), 0),
                            launches_per_train_step=pd_tally.get(("bwd", length), 0)
                            / pd_steps[prob]))
    for tower, width in (("vision", 768), ("text", 512)):
        kernels.append(dict(ln_records[tower], launches=tally_ln[("ln", width)],
                            launches_per_train_step=tally_ln[("ln", width)] / steps_ln))
    # the flash kernels: NaFlex serving (forward, at the serve bucket) and the NaFlex
    # train window (all three, at the train bucket)
    kernels.append(dict(flash_records["serve"]["fwd"], launches=nf_serve_launches,
                        launches_per_call=nf_serve_launches / nf_serve_calls))
    # GenLIP's encode_image (B=32, L=1024, ragged 1024/768 validity, bidirectional) runs
    # the forward at the NaFlex train record's length and masks
    for which in ("fwd", "bwd_dq", "bwd_dkv"):
        by_bucket = {b: c[which] for b, c in nfd_flash.items()}
        serving = gl_serve_launches if which == "fwd" else 0
        kernels.append(dict(flash_records["train"][which],
                            launches=nf_train_launches[which] + sum(by_bucket.values()) + serving,
                            launches_per_train_step=nf_train_launches[which] / nf_steps,
                            launches_naflex_data_by_bucket=by_bucket,
                            launches_per_naflex_data_step=sum(by_bucket.values()) / nfd_steps,
                            launches_genlip_serving=serving,
                            launches_genlip_per_request=serving / gl_serve_calls))
    # GenLIP's train step (bench_genlip): all three kernels with prefix_len 1024 at L=1152
    for which in ("fwd", "bwd_dq", "bwd_dkv"):
        kernels.append(dict(flash_records["genlip_train"][which], launches=gl_train[which],
                            launches_per_train_step=gl_train[which] / gl_steps))
    # window and panel attention: Swin-B serving and training (the window kernels at
    # the stage-0 shape, 49-token windows), CLAP serving and training (the panel
    # kernels at HTSAT's stage-0 shifted shape); the forwards on the tensor-core body
    kernels.append(dict(window_records[("swin_s0_shift", "bfloat16")]["fwd"],
                        launches=swin_serve_launches + swin_train_launches["fwd"],
                        launches_by_body={k: swin_serve_bodies[k] + swin_fwd_bodies[k]
                                          for k in swin_serve_bodies},
                        launches_serving=swin_serve_launches,
                        launches_training=swin_train_launches["fwd"],
                        launches_per_call=swin_serve_launches / swin_calls,
                        launches_per_train_step=swin_train_launches["fwd"] / swin_steps))
    kernels.append(dict(window_records[("swin_s0_train", "bfloat16")]["bwd"],
                        launches=swin_train_launches["bwd"],
                        launches_per_train_step=swin_train_launches["bwd"] / swin_steps))
    kernels.append(dict(window_records[("htsat_s0_shift_serve", "bfloat16")]["fwd"],
                        launches=clap_serve_launches + clap_train_launches["fwd"],
                        launches_by_body={k: clap_serve_bodies[k] + clap_fwd_bodies[k]
                                          for k in clap_serve_bodies},
                        launches_serving=clap_serve_launches,
                        launches_training=clap_train_launches["fwd"],
                        launches_per_call=clap_serve_launches / clap_calls,
                        launches_per_train_step=clap_train_launches["fwd"] / clap_steps))
    # the CUDA-core panel forward: the fp32 CLAP run of phase 15 (B=2: the request and
    # the train step's forward); every bf16 path takes the tensor-core forward
    kernels.append(dict(window_records[("htsat_s0_shift_train", "float32")]["fwd"],
                        launches=panel_fwd_simt_launches,
                        launches_path="fp32 CLAP request and step, B=2 (phase 15)"))
    # the panel backward: the tensor-core body in the bf16 CLAP train window; the
    # CUDA-core body in the fp32 CLAP step of phase 15 (B=2)
    kernels.append(dict(window_records[("htsat_s0_shift_train", "bfloat16")]["bwd"],
                        launches=clap_bodies["mma"],
                        launches_per_train_step=clap_bodies["mma"] / clap_steps))
    kernels.append(dict(window_records[("htsat_s0_shift_train", "float32")]["bwd"],
                        launches=panel_simt_launches,
                        launches_path="fp32 CLAP step, B=2 (phase 15)"))
    # the SwitchBack kernels: the ViT-H-14 train window (names_mm, the switch on), the
    # product at the image tower's c_fc shape (launches by body), the quantization at
    # c_fc's input; the ViT-B-32 CLI's launches beside them
    h14_products = sum(h14_bodies.values())
    kernels.append(dict(sb_records["h14_vision_fc"], launches=h14_products,
                        launches_by_body=h14_bodies,
                        launches_per_train_step=h14_products / h14_steps,
                        launches_b32_cli=b32_sb_launches["fwd"],
                        launches_per_b32_cli_step=b32_sb_launches["fwd"] / b32_sb_steps))
    kernels.append(dict(sb_q_records["h14_vision_fc_input"], launches=h14_quantize,
                        launches_per_train_step=h14_quantize / h14_steps,
                        launches_b32_cli=b32_sb_launches["quantize"],
                        launches_per_b32_cli_step=b32_sb_launches["quantize"] / b32_sb_steps))
    # SigLIP: the short forward at the image tower's 196 tokens (siglip_serve's requests
    # and both siglip_train windows) and at the non-causal 64-token text tower (the
    # classifier and the train windows), the backwards in the train windows (names_mm
    # and no remat), the flash forward without a key mask in siglip384_serve
    kernels.append(dict(fwd_records["siglip_vision"],
                        launches=sg_serve_launches + sg_tally[("fwd", sg_li)] + bv_l196,
                        launches_big_vision_serving=bv_l196,
                        launches_serving=sg_serve_launches,
                        launches_training=sg_tally[("fwd", sg_li)],
                        launches_per_call=sg_serve_launches / sg_calls,
                        launches_per_train_step=sg_tally[("fwd", sg_li)] / sg_steps))
    kernels.append(dict(fwd_records["siglip_text"],
                        launches=sg_text_launches + sg_tally[("fwd", sg_lt)] + bv_l64,
                        launches_big_vision_serving=bv_l64,
                        launches_serving=sg_text_launches,
                        launches_training=sg_tally[("fwd", sg_lt)],
                        launches_per_train_step=sg_tally[("fwd", sg_lt)] / sg_steps))
    for which, length in (("siglip_vision", sg_li), ("siglip_text", sg_lt)):
        kernels.append(dict(bwd_records[(which, "bfloat16")], launches=sg_tally[("bwd", length)],
                            launches_per_train_step=sg_tally[("bwd", length)] / sg_steps))
    kernels.append(dict(flash_records["siglip384"]["fwd"], launches=sg384_launches,
                        launches_per_call=sg384_launches / sg384_calls))
    # the NaFlex-audio CLAP: the trunk's flash forward in naflexclap_serve's requests and
    # naflexclap_train's window, its two backward kernels in that window (816 tokens,
    # ragged key validity)
    kernels.append(dict(flash_records["audio816"]["fwd"],
                        launches=nfc_serve_launches + nfc_train["fwd"],
                        launches_serving=nfc_serve_launches, launches_training=nfc_train["fwd"],
                        launches_per_call=nfc_serve_launches / nfc_calls,
                        launches_per_train_step=nfc_train["fwd"] / nfc_steps))
    for which in ("bwd_dq", "bwd_dkv"):
        kernels.append(dict(flash_records["audio816"][which], launches=nfc_train[which],
                            launches_per_train_step=nfc_train[which] / nfc_steps))
    # CoCa's decoder self-attention (L=76, causal): the coca_train window and the
    # teacher-forced forward of coca_serve (the cached decode's one-query attention is
    # plain, as in the JAX package)
    kernels.append(dict(fwd_records["coca_decoder"],
                        launches=coca_tally.get(("fwd", 76), 0) + coca_tf_tally.get(("fwd", 76), 0),
                        launches_training=coca_tally.get(("fwd", 76), 0),
                        launches_per_train_step=coca_tally.get(("fwd", 76), 0) / coca_steps,
                        launches_teacher_forced=coca_tf_tally.get(("fwd", 76), 0),
                        launches_coca_image_tower_per_request=(
                            coca_serve_tally.get(("fwd", 50), 0) / coca_calls["image"])))
    kernels.append(dict(bwd_records[("coca_decoder", "bfloat16")],
                        launches=coca_tally.get(("bwd", 76), 0),
                        launches_per_train_step=coca_tally.get(("bwd", 76), 0) / coca_steps))
    # the conv towers' text towers: RN50's at b256 (12 short forwards and backwards a
    # step), convnext_base_w's 10 heads at b128 (both fused-LN windows) and at its
    # classifier's B=70; the LayerNorm backward at each shape of ConvNeXt's step (the
    # switch on)
    kernels.append(dict(fwd_records["text_b256"], launches=rn_train["fwd"],
                        launches_path="rn50_train",
                        launches_per_train_step=rn_train["fwd"] / rn_steps))
    cnx = {d: sum(c[d] for c, _ in cnx_short.values()) for d in ("fwd", "bwd")}
    cnx_steps = sum(n for _, n in cnx_short.values())
    kernels.append(dict(fwd_records["text_h10"], launches=cnx["fwd"],
                        launches_per_train_step=cnx["fwd"] / cnx_steps))
    kernels.append(dict(fwd_records["text_h10_b70"], launches=cnx_text_serve,
                        launches_path="convnext_serve's classifier"))
    kernels.append(dict(bwd_records[("text_h10", "bfloat16")], launches=cnx["bwd"],
                        launches_per_train_step=cnx["bwd"] / cnx_steps))
    ln_tally_on, ln_steps_on = cnx_ln["on"]
    for name, shape in CNX_LN_SHAPES.items():
        n = ln_tally_on.get(shape, 0)
        kernels.append(dict(ln_records[name], launches=n, launches_per_train_step=n / ln_steps_on))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
