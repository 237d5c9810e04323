#!/usr/bin/env python3
"""Drive the PyTorch port (open_clip_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which fails the run (exit code 1, no result line) when it fails:
  0. build the CUDA kernels from csrc/ with nvcc, one process per source, together;
  1. each kernel against its plain PyTorch version on the card, at the shapes the
     main paths give it (bf16 and fp32): the short attention forward and backward,
     each also where one head's logits sit ~100 below its neighbour's, the LayerNorm
     backward, and the three flash attention kernels (forward with logsumexp, dq,
     dk/dv) at the NaFlex train and serve buckets, a length that is no multiple of a
     tile, causal, prefix-LM and hd=128; kernel, plain and library-call device time,
     each from one CUDA graph of calls (no host work between launches), and the bound;
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
     the attention forward and backward kernels 24 times each. Then a few steps
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
     request and no backward launch;
  8. NaFlex training: amp_bf16, AdamW with clipping, make_train_step on one fixed
     batch of 16 patch dicts at 1024 tokens (32x32 grids, all valid, alternating with
     24x32 grids, 768 valid) and 16 token rows, timed and profiled like phase 4; a
     step launches each flash kernel 12 times and the short kernels 12 + 12 times
     (the text tower); then two steps with remat;
  9. the CLI with --dataset-type synthetic-naflex at the 1024-token bucket (batch 16
     from the token budget), one short epoch;
 10. NaFlex at fp32 (TF32 off), card against CPU: image features of a ragged batch
     of 4 at 576 tokens, and one train step at batch 4 and 512 tokens: loss,
     grad_norm and every gradient;
 11. (with phase 1) the window and panel attention kernels, forward and backward
     (dq, dk, dv, dbias), bf16 and fp32, against their plain versions at HTSAT-tiny's
     stage-0 (shifted and not) and stage-3 shapes at the serve and train batches,
     Swin-B's stage-0 and stage-2 windows, a non-square map and odd head counts;
     kernel, plain, library (SDPA with the bias as attn_mask) time and the bound;
 12. CLAP serving: CLAP-HTSAT-tiny in pure_bf16, requests of 64 ten-second clips
     (host AudioPreprocess, pinned copy, log-mel and encode_audio on the card, an
     ESC-50-template classifier, top-5), timed and profiled like phase 2; 12 panel
     forward launches a request;
 13. CLAP training at batch 128 (amp_bf16, AdamW, clipping): 12 panel forward and
     backward launches a step, the loss falls;
 14. the CLI with --dataset-type synthetic-audio, a checkpoint and a resume;
 15. CLAP at fp32 (TF32 off), card against CPU: log-mel, features, every gradient;
 16. Swin-B (swin_base_patch4_window7_224) serving in pure_bf16 (64 images a request)
     and training in amp_bf16 (batch 32): 24 window launches of each kind per
     encode_image and per step, and a step with remat.

Prints the card's name and power limit (nvidia-smi), and when every check passed
one {"kernels": [...]} JSON line and as the last line {"ok": true, "device": {...}}.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 non-tensor
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
TRAIN_PROFILED_STEPS = 3
CLI_STEPS_PER_EPOCH = 16
PROFILED_REQUESTS = 10
PHASES = ("preprocess", "encode_image", "logits_top5")
NAFLEX_MODEL = "naflex_ViT-B-16"
NF_SERVE_BATCH, NF_IMAGE_HW, NF_SERVE_SEQ = 32, (384, 512), 576
NF_TRAIN_BATCH, NF_TRAIN_SEQ = 16, 1024
NF_CLI_STEPS = 8
FLASH_SOURCE = "open_clip_tpu_torch/csrc/flash_attention.cu"
WINDOW_SOURCE = "open_clip_tpu_torch/csrc/window_attention.cu"
CLAP_MODEL = "CLAP-HTSAT-tiny"
CLAP_SERVE_BATCH, CLAP_TRAIN_BATCH, CLAP_CLI_BATCH = 64, 128, 32
CLAP_SECONDS, CLAP_RATE = 10, 48000
CLAP_CLI_STEPS = 4
ESC50_CLASSES = ("dog", "rooster", "pig", "cow", "frog", "cat", "hen", "insects", "sheep", "crow")
SWIN_MODEL = "swin_base_patch4_window7_224"
SWIN_SERVE_BATCH, SWIN_TRAIN_BATCH = 64, 32
KERNEL_CLASSES = {  # first match wins
    "window_attention_bwd": ("win_attn_bwd", "dbias_fold"),
    "window_attention": ("win_attn_fwd",),
    "flash_attention_bwd_dq": ("flash_attn_bwd_dq",),
    "flash_attention_bwd_dkv": ("flash_attn_bwd_dkv",),
    "flash_attention": ("flash_attn",),
    "short_attention_bwd": ("short_attn_bwd",),
    "short_attention": ("short_attn",),
    "layer_norm_bwd": ("layer_norm_bwd",),  # the port's kernel; PyTorch's own falls below
    "matmul": ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas", "wgmma"),
    "layer_norm": ("layer_norm", "layernorm", "gammabeta"),
    "optimizer": ("multi_tensor", "foreach"),
    "resize": ("upsample", "interpolate", "aa_"),
}

FAILURES = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def reset_counts(*modules) -> None:
    """Set every kernel's launch count to 0."""
    for mod in modules:
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0


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


def graph_ms(fn, iters: int = 50, replays: int = 5) -> float:
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
    # the text tower at the serving batch as well: the classifier's batch is small
    cases = [("vision", BATCH, 50, 12, 64, False, both),
             ("text", text_batch, 77, 8, 64, True, both),
             ("text_b256", BATCH, 77, 8, 64, True, (torch.bfloat16,))]
    records = {}
    for name, b, l, h, hd, causal, dtypes in cases:
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            q, k, v = attention_inputs(b, l, h, hd, dtype, gen)
            out = sa.short_attention(q, k, v, causal=causal)
            ref = sa.short_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(bool(torch.isfinite(out).all()) and err <= TOL[dn],
                  f"kernel {name} B={b} L={l} H={h} hd={hd} causal={causal} {dn}: "
                  f"max_abs_err={err:.3e} (tol {TOL[dn]:.0e})")
            ms = graph_ms(lambda: sa.short_attention(q, k, v, causal=causal))
            plain_ms = graph_ms(lambda: sa.short_attention_reference(q, k, v, causal=causal))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
            nbytes = 4 * b * l * h * hd * q.element_size()
            pairs = l * (l + 1) // 2 if causal else l * l  # (query, key) pairs the mask keeps
            flops = 4 * b * h * hd * pairs
            rec = {"name": f"short_attention_fwd[{name}]", "route": "cuda",
                   "source": "open_clip_tpu_torch/csrc/short_attention.cu",
                   "replaces": "open_clip_tpu/ops/short_attention.py:262",
                   "shape": [b, l, h, hd], "causal": causal, "dtype": dn,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   **bound(nbytes, flops, dn), "library_ms": library_ms}
            print("kernel_case " + json.dumps(rec), flush=True)
            if dtype == torch.bfloat16:  # the serving path's dtype
                records[name] = rec
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attention_inputs(4, 50, 12, 64, dtype, gen, c2=True)
        out = sa.short_attention(q, k, v)
        ref = sa.short_attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        dn = str(dtype).split(".")[1]
        check(bool(torch.isfinite(out).all()) and err <= TOL[dn],
              f"kernel C2 regime (head 0 logits ~100 below head 1) {dn}: max_abs_err={err:.3e}")
    return records


def phase_attention_bwd_kernels(torch, sa):
    """Backward kernel vs plain version at the train step's shapes; per-shape records."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = {}
    for name, b, l, h, hd, causal in (("vision", BATCH, 50, 12, 64, False),
                                      ("text", BATCH, 77, 8, 64, True)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, k, v = attention_inputs(b, l, h, hd, dtype, gen)
            do = torch.randn(b, l, h, hd, generator=gen, device="cuda").to(dtype)
            grads = sa.short_attention_bwd(q, k, v, do, causal=causal)
            refs = sa.short_attention_bwd_reference(q, k, v, do, causal=causal)
            torch.cuda.synchronize()
            errs = [rel_err(g, r) for g, r in zip(grads, refs)]
            abs_err = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs))
            check(all(bool(torch.isfinite(g).all()) for g in grads) and max(errs) <= BWD_RTOL[dn],
                  f"backward kernel {name} B={b} L={l} H={h} hd={hd} causal={causal} {dn}: "
                  f"rel err dq/dk/dv={errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} "
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
            rec = {"name": f"short_attention_bwd[{name}]", "route": "cuda",
                   "source": "open_clip_tpu_torch/csrc/short_attention.cu",
                   "replaces": "open_clip_tpu/ops/short_attention.py:296",
                   "shape": [b, l, h, hd], "causal": causal, "dtype": dn,
                   "max_abs_err": abs_err, "max_rel_err": max(errs), "ms": ms,
                   "plain_ms": plain_ms,
                   **bound(7 * b * l * h * hd * q.element_size(), 10 * b * h * hd * pairs, dn),
                   "library_ms": library_ms}
            print("kernel_case " + json.dumps(rec), flush=True)
            if dtype == torch.bfloat16:  # the train step's dtype
                records[name] = rec
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        q, k, v = attention_inputs(4, 50, 12, 64, dtype, gen, c2=True)
        do = torch.randn(4, 50, 12, 64, generator=gen, device="cuda").to(dtype)
        grads = sa.short_attention_bwd(q, k, v, do)
        refs = sa.short_attention_bwd_reference(q, k, v, do)
        errs = [rel_err(g, r) for g, r in zip(grads, refs)]
        check(all(bool(torch.isfinite(g).all()) for g in grads) and max(errs) <= BWD_RTOL[dn],
              f"backward kernel C2 regime (head 0 logits ~100 below head 1) {dn}: "
              f"rel err {max(errs):.2e}")
    return records


def phase_ln_bwd_kernels(torch, fl):
    """LayerNorm backward kernel vs plain version; records for the two tower shapes."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = {}
    for name, rows, w in (("vision", BATCH * 50, 768), ("text", BATCH * 77, 512),
                          ("pooled", BATCH, 768)):
        for dtype in (torch.bfloat16, torch.float32):
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
            ms = graph_ms(lambda: fl.layer_norm_bwd(x, dy, scale, 1e-5))
            plain_ms = graph_ms(lambda: fl.layer_norm_bwd_reference(x, dy, scale, 1e-5))
            # library: PyTorch's own LayerNorm backward, given the forward's statistics
            wt, bt = scale.to(dtype), torch.zeros(w, device="cuda", dtype=dtype)
            _, mean, rstd = torch.native_layer_norm(x, [w], wt, bt, 1e-5)
            library_ms = graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [w], mean, rstd, wt, bt, [True, True, True]))
            rec = {"name": f"layer_norm_bwd[{name}]", "route": "cuda",
                   "source": "open_clip_tpu_torch/csrc/layer_norm_bwd.cu",
                   "replaces": "open_clip_tpu/ops/fused_ln.py:39",
                   "shape": [rows, w], "dtype": dn, "max_abs_err": abs_err,
                   "max_rel_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                   **bound(3 * rows * w * x.element_size() + 12 * w, 12 * rows * w, "float32"),
                   "library_ms": library_ms}
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
             ("hd128", 4, 512, 8, 128, False, 0, None, False)]
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
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
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
            size, n = q.element_size(), b * l * h * hd
            common = {"route": "cuda", "source": FLASH_SOURCE, "shape": [b, l, h, hd],
                      "causal": causal, "prefix_len": prefix, "valid": lens, "dtype": dn,
                      "visible_pairs": pairs}
            it = dict(iters=10, replays=3)
            do_c = do.contiguous()
            vb = fa._valid_bytes(valid, q)
            di = (out.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()
            ms_fwd = graph_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), **it)
            ms_dq = graph_ms(lambda: fa._launch_bwd("bwd_dq", q, k, v, do_c, lse, di, vb, causal,
                                                    hd ** -0.5, prefix), **it)
            ms_dkv = graph_ms(lambda: fa._launch_bwd("bwd_dkv", q, k, v, do_c, lse, di, vb, causal,
                                                     hd ** -0.5, prefix), **it)
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
                "fwd": dict(common, name=f"flash_attention_fwd[{name}]",
                            replaces="open_clip_tpu/ops/flash_attention.py:45",
                            max_abs_err=err, lse_abs_err=lse_err, ms=ms_fwd, plain_ms=plain_fwd,
                            **bound(4 * n * size, 4 * h * hd * pairs, dn),
                            library_ms=lib_fwd),
                # each backward kernel alone: dq reads q, k, v, do and writes dq, with three
                # products; dk/dv reads the same and writes two, with four. No single
                # PyTorch call computes one of them alone.
                "bwd_dq": dict(common, name=f"flash_attention_bwd_dq[{name}]",
                               replaces="open_clip_tpu/ops/flash_attention.py:161",
                               max_abs_err=abs_errs[0], max_rel_err=errs[0], ms=ms_dq,
                               plain_ms=plain_bwd, **bound(5 * n * size, 6 * h * hd * pairs, dn),
                               library_ms=None),
                "bwd_dkv": dict(common, name=f"flash_attention_bwd_dkv[{name}]",
                                replaces="open_clip_tpu/ops/flash_attention.py:218",
                                max_abs_err=max(abs_errs[1:]), max_rel_err=max(errs[1:]), ms=ms_dkv,
                                plain_ms=plain_bwd, **bound(6 * n * size, 8 * h * hd * pairs, dn),
                                library_ms=None),
            }
            for rec in recs.values():
                print("kernel_case " + json.dumps(rec), flush=True)
            # the whole backward (di, dq, dk/dv) against the convention of the short kernels
            print("kernel_case " + json.dumps(dict(
                common, name=f"flash_attention_bwd[{name}]", ms=ms_bwd, plain_ms=plain_bwd,
                **bound(7 * n * size, 10 * h * hd * pairs, dn), library_ms=lib_bwd)), flush=True)
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
          and all(bool(torch.isfinite(g).all()) and bool((g[1] == 0).all()) for g in grads),
          "flash kernels: a sample with no valid key gives zero rows, a finite lse and zero gradients")
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
               if e.device_type != DeviceType.CPU and device_ms(e) > 0]
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
                          ("short_attention", "short_attention_bwd", "layer_norm_bwd",
                           "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                           "window_attention", "window_attention_bwd")
                          if c in by_class},
        "top_kernels": [{"name": k[:120], "class": kernel_class(k), f"ms_per_{unit}": ms / n,
                         f"launches_per_{unit}": c / n} for k, ms, c in top]}


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

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        ln_expect = (2 * lv + 2 + 2 * lt + 1) * n if fused_ln else 0
        check(counts["ln"] == ln_expect,
              f"{label}: {counts['ln']} LayerNorm backward launches in {n} steps (expect {ln_expect})")
        summary = {"model": "ViT-B-32", "precision": "amp_bf16", "batch": BATCH,
                   "fused_ln_bwd": fused_ln, "window_steps": n, "window_s": wall_s,
                   "images_per_s": BATCH * n / wall_s, "median_step_ms": statistics.median(step_ms),
                   "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
                   "median_host_ms_per_step": statistics.median(host_ms),
                   "host_lead_ms_at_end": lead_ms,
                   "first_loss": losses[0], "last_loss": losses[-1], "logit_scale": scale,
                   "launches_per_step": {k: v / n for k, v in counts.items()}}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            state = run_steps(torch, step, state, batch, 1)[0]  # the profiler's own warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, *_, prof_wall_s = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)
        prof_summary = profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")
        print(f"{label.replace('train', 'train_profile')} " + json.dumps(prof_summary), flush=True)
        summary["device_busy_ms_per_step"] = prof_summary["device_busy_ms_per_step"]
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
        print("cli " + json.dumps({
            "steps_per_epoch": CLI_STEPS_PER_EPOCH, "first_run_s": first_s,
            "host_data_ms_per_step": 1e3 * last.get("train/data_time", float("nan")),
            "host_batch_ms_per_step": 1e3 * last.get("train/batch_time", float("nan")),
            "images_per_s": BATCH / last["train/batch_time"] if last.get("train/batch_time") else None,
            "averaged_over_steps": (last.get("step", 0) - CLI_STEPS_PER_EPOCH - 1) or None}),
            flush=True)


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
        results[device] = (grads, float(m["loss"]), float(m["grad_norm"]), dict(sa.LAUNCHES))
    (g_gpu, loss_g, norm_g, launched), (g_cpu, loss_c, norm_c, _) = results["cuda"], results["cpu"]
    check(launched == {"fwd": 24, "bwd": 24}, f"fp32 card train step launched {launched}")
    check(abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) and abs(norm_g - norm_c) <= 1e-3 * norm_c,
          f"train step card vs CPU fp32: loss {loss_g:.6f} vs {loss_c:.6f} (rel 1e-4), "
          f"grad_norm {norm_g:.6f} vs {norm_c:.6f} (rel 1e-3)")
    cos = {k: torch.nn.functional.cosine_similarity(g_gpu[k].flatten(), g_cpu[k].flatten(), dim=0).item()
           for k in g_cpu}
    worst = min(cos, key=cos.get)
    check(all(bool(torch.isfinite(g).all()) for g in g_gpu.values()) and cos[worst] >= COSINE_MIN,
          f"gradients card vs CPU fp32: min cosine {cos[worst]:.7f} at {worst} "
          f"over {len(cos)} tensors (>= {COSINE_MIN})")


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    check(fa.LAUNCHES == {"fwd": layers_v * image_calls, "bwd_dq": 0, "bwd_dkv": 0},
          f"NaFlex requests: flash launches {fa.LAUNCHES} for {image_calls} encode_image calls "
          f"(expect {layers_v * image_calls} forward, no backward)")
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
        "flash_fwd_launches": fa.LAUNCHES["fwd"],
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
    flash, short = dict(fa.LAUNCHES), dict(sa.LAUNCHES)
    losses = [float(m["loss"]) for m in warm + window]
    norms = [float(m["grad_norm"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses), f"naflex_train: {len(losses)} losses finite")
    check(losses[-1] < losses[0], f"naflex_train: loss fell on the fixed batch, "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in {len(losses)} steps")
    check(all(math.isfinite(x) and x > 0 for x in norms), "naflex_train: grad_norm finite, positive")
    check(flash == {"fwd": lv * n, "bwd_dq": lv * n, "bwd_dkv": lv * n},
          f"naflex_train: flash launches {flash} in {n} steps (expect {lv * n} of each)")
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
               "short_launches_per_step": {k: v / n for k, v in short.items()}}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state = run_steps(torch, step, state, batch, 1)[0]  # the profiler's own warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, *_, prof_wall_s = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)
    prof_summary = profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")
    print("naflex_train_profile " + json.dumps(prof_summary), flush=True)
    summary["device_busy_ms_per_step"] = prof_summary["device_busy_ms_per_step"]
    # remat: the key-padding mask goes through torch's checkpoint with each block
    remat_step = oc.make_train_step(model.cfg, optimizer, remat=True)
    reset_counts(sa, fa)
    state, rm, remat_ms, *_ = run_steps(torch, remat_step, state, batch, 2)
    check(fa.LAUNCHES == {"fwd": 2 * lv * 2, "bwd_dq": lv * 2, "bwd_dkv": lv * 2}
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
        check(fa.LAUNCHES == {k: layers * NF_CLI_STEPS for k in fa.LAUNCHES},
              f"NaFlex CLI: flash launches {fa.LAUNCHES} in {NF_CLI_STEPS} steps")
        check((run / "checkpoints" / "epoch_1.pt").exists(), "NaFlex CLI: checkpoint epoch_1.pt written")
        last = rows[-1] if rows else {}
        print("naflex_cli " + json.dumps({
            "steps": NF_CLI_STEPS, "run_s": wall_s,
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
             ("htsat_s3_train", "panel", b_t, (8, 8), 768, 32, 1),
             ("nonsquare_odd_heads", "panel", 8, (16, 40), 48, 3, 10),
             ("swin_s0_shift", "window", b_w * 64, 49, 128, 4, 64),
             ("swin_s2_shift", "window", b_w * 4, 49, 512, 16, 4),
             ("swin_s0_train", "window", SWIN_TRAIN_BATCH * 64, 49, 128, 4, 64),
             ("odd_heads", "window", 96, 49, 72, 3, 1)]
    it = dict(iters=10, replays=3)
    records = {}
    for name, kind, b, geo, c, heads, nw in cases:
        panel = kind == "panel"
        n = 64 if panel else geo
        hd = c // heads
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
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
            out, grads = fwd(), bwd()
            ref, refs = ref_f(), ref_b()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            errs = [rel_err(g, r) for g, r in zip(grads, refs)]
            abs_errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs)]
            shape = f"B={b} {'map' if panel else 'N'}={geo} C={c} H={heads} nW={nw} {dn}"
            check(bool(torch.isfinite(out).all()) and err <= TOL[dn],
                  f"{label} forward {name} {shape}: max_abs_err={err:.3e} (tol {TOL[dn]:.0e})")
            check(all(bool(torch.isfinite(g).all()) for g in grads) and max(errs) <= BWD_RTOL[dn],
                  f"{label} backward {name} {shape}: rel err dq/dk/dv/dbias="
                  f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e}/{errs[3]:.2e} (tol {BWD_RTOL[dn]:.0e})")
            del out, grads, ref, refs
            ms_fwd, ms_bwd = graph_ms(fwd, **it), graph_ms(bwd, **it)
            plain_fwd = plain_bwd = lib_fwd = lib_bwd = copies = None
            if dtype == torch.bfloat16:
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
                "fwd": dict(common, name=f"{label}_fwd[{name}]", replaces=replaces[0],
                            max_abs_err=err, ms=ms_fwd, plain_ms=plain_fwd,
                            **bound(4 * blc * size + bias_bytes, 4 * windows * n * n * c, dn),
                            library_ms=lib_fwd, library_partition_copies_ms=copies),
                "bwd": dict(common, name=f"{label}_bwd[{name}]", replaces=replaces[1],
                            max_abs_err=max(abs_errs), max_rel_err=max(errs), ms=ms_bwd,
                            plain_ms=plain_bwd,
                            **bound(7 * blc * size + 2 * bias_bytes, 10 * windows * n * n * c, dn),
                            library_ms=lib_bwd),
            }
            for rec in recs.values():
                print("kernel_case " + json.dumps(rec), flush=True)
            if dtype == torch.bfloat16:
                records[name] = recs
            del q, k, v, bias, do
        torch.cuda.empty_cache()
    return records


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(PROFILED_REQUESTS):
                request(i)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        calls = 1 + len(lat) + PROFILED_REQUESTS
        # the log-mel front end alone, for the stage breakdown
        audio = {k: v.to("cuda") for k, v in requests[0].items()}
        mel_ms = graph_ms(lambda: model.audio.encoder.mel(audio["waveform"]), iters=5, replays=3)
    check(text_launches == model.cfg.text_cfg.layers,
          f"CLAP classifier: {text_launches} short-kernel launches for 1 encode_text call")
    check(swa.LAUNCHES == {"fwd": layers * calls, "bwd": 0} and wa.LAUNCHES == {"fwd": 0, "bwd": 0},
          f"CLAP requests: panel launches {swa.LAUNCHES}, window {wa.LAUNCHES} for {calls} "
          f"encode_audio calls (expect {layers} panel forward each, nothing else)")
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
        "log_mel_device_ms": mel_ms, "panel_fwd_launches": swa.LAUNCHES["fwd"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    print("clap_profile " + json.dumps(profile_summary(prof, prof_wall_ms, PROFILED_REQUESTS)),
          flush=True)
    return swa.LAUNCHES["fwd"], calls


def phase_clap_train(torch, oc, sa, swa, wa):
    """CLAP training at bench_clap's shape: batch 128 of ten-second clips, amp_bf16,
    AdamW with clipping; returns the panel launches of the timed window and its steps."""
    from torch.profiler import ProfilerActivity, profile

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
    summary = {"model": CLAP_MODEL, "precision": "amp_bf16", "batch": CLAP_TRAIN_BATCH,
               "clip_seconds": CLAP_SECONDS, "window_steps": n, "window_s": wall_s,
               "clips_per_s": CLAP_TRAIN_BATCH * n / wall_s,
               "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
               "max_step_ms": max(step_ms), "median_host_ms_per_step": statistics.median(host_ms),
               "host_lead_ms_at_end": lead_ms, "first_loss": losses[0], "last_loss": losses[-1],
               "panel_launches_per_step": {k: v / n for k, v in panel.items()},
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state = run_steps(torch, step, state, batch, 1)[0]  # the profiler's own warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, *_, prof_wall_s = run_steps(torch, step, state, batch, TRAIN_PROFILED_STEPS)
    prof_summary = profile_summary(prof, prof_wall_s * 1e3, TRAIN_PROFILED_STEPS, "step")
    print("clap_train_profile " + json.dumps(prof_summary), flush=True)
    summary["device_busy_ms_per_step"] = prof_summary["device_busy_ms_per_step"]
    print("clap_train " + json.dumps(summary), flush=True)
    return panel, n


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
            launched = dict(swa.LAUNCHES)
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
    check(launched == {"fwd": 24, "bwd": 12}, f"CLAP fp32 card run: panel launches {launched} "
          "(12 serving, 12 in the training forward, 12 backward)")
    grads_card_vs_cpu(torch, results, "CLAP")


def phase_swin_serve(torch, oc, sa, wa):
    """Swin-B serving: 64 uint8 256x320 images a request, device preprocess,
    encode_image, logits, top-5. Returns the window forward launches and calls."""
    from torch.profiler import ProfilerActivity, profile

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
        lat = []
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < WINDOW_S:
            t0 = time.perf_counter()
            feats, top5 = request(len(lat) + 1)
            lat.append((time.perf_counter() - t0) * 1e3)
        window_s = time.perf_counter() - t_start
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                request(i)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        calls = 1 + len(lat) + 3
    check(wa.LAUNCHES == {"fwd": blocks * calls, "bwd": 0},
          f"Swin requests: window launches {wa.LAUNCHES} for {calls} encode_image calls "
          f"(expect {blocks} forward each)")
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
        "window_fwd_launches": wa.LAUNCHES["fwd"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    print("swin_profile " + json.dumps(profile_summary(prof, prof_wall_ms, 3)), flush=True)
    return wa.LAUNCHES["fwd"], calls


def phase_swin_train(torch, oc, sa, wa):
    """Swin-B training through the existing train step: amp_bf16, AdamW with clipping,
    one fixed batch; then one step with remat (each block recomputed)."""
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
    win, short = dict(wa.LAUNCHES), dict(sa.LAUNCHES)
    losses = [float(m["loss"]) for m in warm + window]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"swin_train: {len(losses)} losses finite, fell {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(win == {"fwd": blocks * n, "bwd": blocks * n} and short == {"fwd": lt * n, "bwd": lt * n},
          f"swin_train: window launches {win}, short {short} in {n} steps (expect {blocks} and "
          f"{lt} of each a step)")
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
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    return win, n


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
    from open_clip_tpu_torch.ops import window_attention as wa

    t0 = time.perf_counter()
    sources = ("short_attention", "layer_norm_bwd", "flash_attention", "window_attention")
    _build.build_all(sources)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    fwd_records = phase_kernels(torch, sa, text_batch=CLASSES * len(oc.SIMPLE_IMAGENET_TEMPLATES))
    bwd_records = phase_attention_bwd_kernels(torch, sa)
    ln_records = phase_ln_bwd_kernels(torch, fl)
    flash_records = phase_flash_kernels(torch, fa)
    window_records = phase_window_kernels(torch, wa, swa)
    launches, calls = phase_serve(torch, oc, sa)
    phase_card_vs_cpu(torch, oc, sa)
    tally, steps, plain_summary = phase_train(torch, oc, sa, fl, layers_mod, fused_ln=False)
    tally_ln, steps_ln, fused_summary = phase_train(torch, oc, sa, fl, layers_mod, fused_ln=True)
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
    phase_cli(torch)
    phase_train_card_vs_cpu(torch, oc, sa)
    nf_serve_launches, nf_serve_calls = phase_naflex_serve(torch, oc, sa, fa)
    nf_train_launches, nf_steps = phase_naflex_train(torch, oc, sa, fa)
    phase_naflex_cli(torch, fa)
    phase_naflex_card_vs_cpu(torch, oc, sa, fa)
    clap_serve_launches, clap_calls = phase_clap_serve(torch, oc, sa, swa, wa)
    clap_train_launches, clap_steps = phase_clap_train(torch, oc, sa, swa, wa)
    phase_clap_cli(torch, swa)
    phase_clap_card_vs_cpu(torch, oc, swa)
    swin_serve_launches, swin_calls = phase_swin_serve(torch, oc, sa, wa)
    swin_train_launches, swin_steps = phase_swin_train(torch, oc, sa, wa)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    # launches measured on the main paths, each driven with the counts at 0 before it:
    # serving (the image tower runs once per request, the text tower once per
    # classifier build) and the train window (attention kernels with the switch
    # off, the LayerNorm backward with it on)
    kernels = []
    for tower in ("vision", "text"):
        n_train = tally[("fwd", tower)]
        kernels.append(dict(fwd_records[tower], launches=launches[tower] + n_train,
                            launches_serving=launches[tower], launches_training=n_train,
                            launches_per_call=launches[tower] / calls[tower],
                            launches_per_train_step=n_train / steps))
    for tower in ("vision", "text"):
        kernels.append(dict(bwd_records[tower], launches=tally[("bwd", tower)],
                            launches_per_train_step=tally[("bwd", tower)] / steps))
    for tower, width in (("vision", 768), ("text", 512)):
        kernels.append(dict(ln_records[tower], launches=tally_ln[("ln", width)],
                            launches_per_train_step=tally_ln[("ln", width)] / steps_ln))
    # the flash kernels: NaFlex serving (forward, at the serve bucket) and the NaFlex
    # train window (all three, at the train bucket)
    kernels.append(dict(flash_records["serve"]["fwd"], launches=nf_serve_launches,
                        launches_per_call=nf_serve_launches / nf_serve_calls))
    for which in ("fwd", "bwd_dq", "bwd_dkv"):
        kernels.append(dict(flash_records["train"][which], launches=nf_train_launches[which],
                            launches_per_train_step=nf_train_launches[which] / nf_steps))
    # window and panel attention: Swin-B serving and training (the window kernels at
    # the stage-0 shape, 49-token windows), CLAP serving and training (the panel
    # kernels at HTSAT's stage-0 shifted shape)
    kernels.append(dict(window_records["swin_s0_shift"]["fwd"],
                        launches=swin_serve_launches + swin_train_launches["fwd"],
                        launches_serving=swin_serve_launches,
                        launches_training=swin_train_launches["fwd"],
                        launches_per_call=swin_serve_launches / swin_calls,
                        launches_per_train_step=swin_train_launches["fwd"] / swin_steps))
    kernels.append(dict(window_records["swin_s0_train"]["bwd"], launches=swin_train_launches["bwd"],
                        launches_per_train_step=swin_train_launches["bwd"] / swin_steps))
    kernels.append(dict(window_records["htsat_s0_shift_serve"]["fwd"],
                        launches=clap_serve_launches + clap_train_launches["fwd"],
                        launches_serving=clap_serve_launches,
                        launches_training=clap_train_launches["fwd"],
                        launches_per_call=clap_serve_launches / clap_calls,
                        launches_per_train_step=clap_train_launches["fwd"] / clap_steps))
    kernels.append(dict(window_records["htsat_s0_shift_train"]["bwd"],
                        launches=clap_train_launches["bwd"],
                        launches_per_train_step=clap_train_launches["bwd"] / clap_steps))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
