#!/usr/bin/env python3
"""Drive the PyTorch port (open_clip_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which fails the run (exit code 1, no result line) when it fails:
  0. build the CUDA kernels from csrc/ with nvcc, one process per source, together;
  1. each kernel against its plain PyTorch version on the card, at the shapes the
     main paths give it (bf16 and fp32): the attention forward and backward, each
     also where one head's logits sit ~100 below its neighbour's, and the LayerNorm
     backward; kernel, plain and library-call device time, each from one CUDA graph
     of 50 calls (no host work between launches), and the bound;
  2. serving: ViT-B-32 from create_model_and_transforms in pure_bf16 with random
     weights from a seed, a zero-shot classifier over 10 ImageNet classes (one
     encode_text call), and requests of 256 synthetic 256x320 uint8 images (device
     preprocess -> encode_image -> logits -> top-5), one in flight: a warm-up
     request, a window of at least 1 s (latency, images/s over the window, device
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
     grad_norm and every gradient.

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
WINDOW_S = 1.0  # the timed serving window lasts at least this long
TRAIN_WINDOW_S = 2.0  # and the timed training window this long
TRAIN_PROFILED_STEPS = 3
CLI_STEPS_PER_EPOCH = 16
PROFILED_REQUESTS = 10
PHASES = ("preprocess", "encode_image", "logits_top5")
KERNEL_CLASSES = {  # first match wins
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
                          ("short_attention", "short_attention_bwd", "layer_norm_bwd")
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
            state, rm, remat_ms, *_ = run_steps(torch, remat_step, state, batch, 4)
            check(sa.LAUNCHES == {"fwd": 2 * (lv + lt) * 4, "bwd": (lv + lt) * 4}
                  and math.isfinite(float(rm[-1]["loss"])),
                  f"train[remat]: launches {sa.LAUNCHES} in 4 steps, loss finite")
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
    from open_clip_tpu_torch.ops import fused_ln as fl
    from open_clip_tpu_torch.ops import layers as layers_mod
    from open_clip_tpu_torch.ops import short_attention as sa

    t0 = time.perf_counter()
    sources = ("short_attention", "layer_norm_bwd")
    _build.build_all(sources)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    fwd_records = phase_kernels(torch, sa, text_batch=CLASSES * len(oc.SIMPLE_IMAGENET_TEMPLATES))
    bwd_records = phase_attention_bwd_kernels(torch, sa)
    ln_records = phase_ln_bwd_kernels(torch, fl)
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
