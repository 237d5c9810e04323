#!/usr/bin/env python3
"""Drive the PyTorch port (open_clip_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which fails the run (exit code 1, no result line) when it fails:
  0. build the CUDA kernel from csrc/ with nvcc;
  1. the kernel against its plain PyTorch version on the card, at the shapes the
     serving path gives it (bf16 and fp32) plus a case where one head's logits sit
     ~100 below its neighbour's; kernel, plain and library-call device time, each
     from one CUDA graph of 50 calls (no host work between launches), and the bound;
  2. serving: ViT-B-32 from create_model_and_transforms in pure_bf16 with random
     weights from a seed, a zero-shot classifier over 10 ImageNet classes (one
     encode_text call), and requests of 256 synthetic 256x320 uint8 images (device
     preprocess -> encode_image -> logits -> top-5), one in flight: a warm-up
     request, a window of at least 2 s (latency, images/s over the window, device
     time per phase from CUDA events), and 10 more under torch.profiler (device
     time per kernel class, idle share). The kernel must launch 12 times per tower
     call;
  3. the same model at fp32 (TF32 off) on the card against the port on the CPU:
     image and text features must agree to cosine >= 0.9999.

Prints the card's name and power limit (nvidia-smi), and when every check passed
one {"kernels": [...]} JSON line and as the last line {"ok": true, "device": {...}}.
Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 non-tensor
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # max |kernel - plain|, inputs ~N(0, 1)
COSINE_MIN = 0.9999
BATCH = 256
IMAGE_HW = (256, 320)
CLASSES = 10
DISTINCT_REQUESTS = 8  # request tensors made once and reused in turn
WINDOW_S = 2.0  # the timed serving window lasts at least this long
PROFILED_REQUESTS = 10
PHASES = ("preprocess", "encode_image", "logits_top5")
KERNEL_CLASSES = {
    "short_attention": ("short_attn",),
    "matmul": ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas", "wgmma"),
    "layer_norm": ("layer_norm", "layernorm"),
    "resize": ("upsample", "interpolate", "aa_"),
}

FAILURES = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


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
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dn] * 1e3
            rec = {"name": f"short_attention_fwd[{name}]", "route": "cuda",
                   "source": "open_clip_tpu_torch/csrc/short_attention.cu",
                   "replaces": "open_clip_tpu/ops/short_attention.py:262",
                   "shape": [b, l, h, hd], "causal": causal, "dtype": dn,
                   "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": library_ms}
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


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES.items():
        if any(k in low for k in keys):
            return cls
    return "other"


def profile_summary(prof, wall_ms: float, n: int) -> dict:
    """Device time per request by kernel class and the device's idle share, from
    the profiler's kernel rows (an operator's row repeats its kernels' time)."""
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
        "requests": n, "wall_ms_per_request": wall_ms / n,
        "device_busy_ms_per_request": busy_ms / n,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "class_ms_per_request": {c: ms / n for c, ms in sorted(by_class.items(), key=lambda x: -x[1])},
        "short_attention_ms_per_launch": (by_class["short_attention"] / launches["short_attention"]
                                          if "short_attention" in by_class else None),
        "top_kernels": [{"name": k[:120], "class": kernel_class(k), "ms_per_request": ms / n,
                         "launches_per_request": c / n} for k, ms, c in top]}


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
        sa.LAUNCHES = 0
        clf = oc.build_zero_shot_classifier(model, tokenizer, classnames,
                                            oc.SIMPLE_IMAGENET_TEMPLATES,
                                            num_classes_per_batch=CLASSES)
        torch.cuda.synchronize()
        text_launches, text_calls = sa.LAUNCHES, 1
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
        vision_launches = sa.LAUNCHES - text_launches

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
        sa.LAUNCHES = 0
        fi_g = gpu.encode_image(pp(images.cuda()), normalize=True).cpu()
        ft_g = gpu.encode_text(texts, normalize=True).cpu()
        launched = sa.LAUNCHES
        fi_c = cpu.encode_image(pp(images), normalize=True)
        ft_c = cpu.encode_text(texts, normalize=True)
    check(launched == gpu.cfg.vision_cfg.layers + gpu.cfg.text_cfg.layers,
          f"fp32 card run launched the kernel {launched} times")
    for name, a, b in (("encode_image", fi_g, fi_c), ("encode_text", ft_g, ft_c)):
        cos = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()
        check(bool(torch.isfinite(a).all()) and cos >= COSINE_MIN,
              f"{name} card vs CPU fp32: min cosine {cos:.7f} (>= {COSINE_MIN})")


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
    from open_clip_tpu_torch.ops import short_attention as sa

    t0 = time.perf_counter()
    _build.load("short_attention")
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log("short_attention").splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print(f"ptxas short_attention: {line.strip()}", flush=True)

    records = phase_kernels(torch, sa, text_batch=CLASSES * len(oc.SIMPLE_IMAGENET_TEMPLATES))
    launches, calls = phase_serve(torch, oc, sa)
    phase_card_vs_cpu(torch, oc, sa)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    # launches measured on the main path: the image tower runs once per request,
    # the text tower once per classifier build
    kernels = [dict(records["vision"], launches=launches["vision"],
                    launches_per_request=launches["vision"] / calls["vision"]),
               dict(records["text"], launches=launches["text"],
                    launches_per_call=launches["text"] / calls["text"])]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
