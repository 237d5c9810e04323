"""Four checks on the card beside chip_smoke.py, each in a process of its own.

  python3 chip_recheck.py l14 ROOT
      ViT-L-14's fixed-batch losses over 20 steps at bench_vit_l14's lr 5e-4 (the
      l14_train step of chip_smoke.py, TF32 off as at its place there), with the
      package and chip_smoke.py found under ROOT; run it on two checkouts to hold
      their losses bit for bit (the kernels are built once, under this checkout).
  python3 chip_recheck.py ln ROOT
      The LayerNorm backward kernel of the package under ROOT at chip_smoke.py's
      LayerNorm shapes in bf16: device ms a call warm and cold (chip_smoke.py's
      graph_ms and cold_ms, from this checkout) and the wrapper's host us a call;
      run it on two checkouts in turns to compare their kernels on one card.
  python3 chip_recheck.py coca
      The coca_ViT-B-32 b256 step of chip_smoke.py's coca_train, profiled in a fresh
      process, again with TF32 off, and again after the coca_serve phase, with
      nvidia-smi's clocks, power and throttle reasons sampled during each window,
      profile and the parts timed alone.
  python3 chip_recheck.py vitamin
      ViTamin-B's fixed-batch losses over 25 steps (chip_smoke.py's vitamin_train batch,
      b128, AdamW, clip 1.0, no warmup, TF32 off as at its place there) in amp_bf16 at
      lr 5e-4, 2e-4, 1e-4 and 5e-5 and in fp32 at 5e-4, each with the mean cosine between
      the batch's image features before and after: where a rate leaves the loss at
      ln(128), the tower has drawn every image onto one feature.

Imports no JAX.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def smi():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


def l14(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    import open_clip_tpu_torch as oc
    from open_clip_tpu_torch.ops import _build

    assert Path(oc.__file__).resolve().is_relative_to(root), oc.__file__
    assert Path(cs.__file__).resolve().is_relative_to(root), cs.__file__
    smi()
    _build.BUILD_DIR = REPO / "build" / "open_clip_tpu_torch"  # one build for every ROOT
    _build.build_all(("short_attention", "layer_norm_bwd"))
    torch.backends.cuda.matmul.allow_tf32 = False  # as at l14_train's place in chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    model = oc.create_model("ViT-L-14", precision="amp_bf16", seed=0)
    batch = cs.train_batch(torch, model.cfg, 64, "cuda")
    opt = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0), model,
                              oc.const_lr(5e-4, 0))
    state = oc.create_train_state(model, opt)
    step = oc.make_train_step(model.cfg, opt)
    losses = []
    for _ in range(20):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    print("recheck_l14 " + json.dumps({"root": str(root), "losses": losses,
                                       "hex": [x.hex() for x in losses]}), flush=True)


def ln(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_timing", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # the timing helpers and shapes of this checkout
    from open_clip_tpu_torch.ops import _build
    from open_clip_tpu_torch.ops import fused_ln as fl

    assert Path(fl.__file__).resolve().is_relative_to(root), fl.__file__
    smi()
    _build.BUILD_DIR = REPO / "build" / "open_clip_tpu_torch"  # one build for every ROOT
    _build.build_all(("layer_norm_bwd",))
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = {"vision": (cs.BATCH * 50, 768), "text": (cs.BATCH * 77, 512), **cs.CNX_LN_SHAPES}
    out = {}
    for name, (rows, w) in shapes.items():
        x, dy = (torch.randn(rows, w, generator=gen, device="cuda").bfloat16() for _ in range(2))
        scale = torch.randn(w, generator=gen, device="cuda")
        copies = [(x, dy)] + [(torch.randn_like(x), torch.randn_like(dy))
                              for _ in range(math.ceil(cs.COLD_BYTES / (2 * x.nbytes)) - 1)]
        out[name] = {"shape": [rows, w],
                     "warm_ms": cs.graph_ms(lambda: fl.layer_norm_bwd(x, dy, scale)),
                     "cold_ms": cs.cold_ms(lambda a, b: fl.layer_norm_bwd(a, b, scale), copies)}
        if (rows, w) == cs.CNX_LN_SHAPES["convnext_head"]:
            out[name]["host_us_per_call"] = cs.host_us_per_call(
                lambda: fl.layer_norm_bwd(x, dy, scale))
        del copies
    print("recheck_ln " + json.dumps({"root": str(root), "shapes": out}), flush=True)


def coca():
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as cs
    import open_clip_tpu_torch as oc
    from open_clip_tpu_torch.models import naflex_vit as nf
    from open_clip_tpu_torch.ops import _build
    from open_clip_tpu_torch.ops import attention as attn
    from open_clip_tpu_torch.ops import short_attention as sa

    smi()
    _build.build_all(("short_attention", "layer_norm_bwd"))

    def profile(label):
        model = oc.create_model(cs.COCA_MODEL, precision="amp_bf16", seed=0)
        ctx = model.cfg.text_cfg.context_length
        size = model.cfg.vision_cfg.image_size
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = {"image": torch.randn(cs.BATCH, size, size, 3, generator=gen, device="cuda"),
                 "text": cs.coca_texts(torch, cs.BATCH, ctx, 1)}
        optimizer = oc.create_optimizer(oc.OptimizerCfg(lr=5e-4, wd=0.2, grad_clip_norm=1.0),
                                        model, oc.const_lr(5e-4, 0))
        state = oc.create_train_state(model, optimizer)
        step = oc.make_train_step(model.cfg, optimizer, loss_type="coca")
        state = cs.run_steps(torch, step, state, batch, 3)[0]
        with cs.card_clocks({}) as s_win:
            state, _, step_ms, host_ms, lead_ms, _ = cs.run_steps(torch, step, state, batch, 8)
        with cs.card_clocks({}) as s_prof:
            state, prof = cs.profiled_steps(torch, step, state, batch)
        with cs.card_clocks({}) as s_parts:
            parts = cs.coca_component_ms(torch, model, batch)
        print(f"recheck_coca[{label}] " + json.dumps({
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "step_ms": step_ms, "host_ms": host_ms, "lead_ms": lead_ms,
            "kernel_ms_per_step": prof["device_busy_ms_per_step"],
            "idle": prof["device_idle_share"], "class_ms": prof["class_ms_per_step"],
            "top": [(round(t["ms_per_step"], 3), t["launches_per_step"], t["name"][:70])
                    for t in prof["top_kernels"][:8]],
            "parts": parts, "smi_window": s_win, "smi_profile": s_prof,
            "smi_parts": s_parts}), flush=True)
        del state, optimizer, model, step
        torch.cuda.empty_cache()

    profile("fresh")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile("tf32_off")
    cs.timed("coca_serve", cs.phase_coca_serve, torch, oc, sa, attn, nf)
    profile("after_coca_serve")
    print("FAILURES " + json.dumps(cs.FAILURES), flush=True)
    return 1 if cs.FAILURES else 0


def vitamin():
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as cs
    import open_clip_tpu_torch as oc
    from open_clip_tpu_torch.ops import _build

    smi()
    _build.build_all(("short_attention",))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def image_cosine(model, batch):
        with torch.no_grad():
            f = model.encode_image(batch["image"], normalize=True).float()
        n = f.shape[0]
        return ((f @ f.T).sum().item() - n) / (n * n - n)

    for precision, lr in (("amp_bf16", 5e-4), ("amp_bf16", 2e-4), ("amp_bf16", 1e-4),
                          ("amp_bf16", 5e-5), ("fp32", 5e-4)):
        model = oc.create_model(cs.VTM_MODEL, precision=precision, seed=0)
        batch = cs.train_batch(torch, model.cfg, cs.VTM_TRAIN_BATCH, "cuda", seed=14)
        opt = oc.create_optimizer(oc.OptimizerCfg(lr=lr, wd=0.2, grad_clip_norm=1.0), model,
                                  oc.const_lr(lr, 0))
        state = oc.create_train_state(model, opt)
        step = oc.make_train_step(model.cfg, opt)
        before = image_cosine(model, batch)
        losses = []
        for _ in range(25):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        print("recheck_vitamin " + json.dumps({
            "precision": precision, "lr": lr, "ln_batch": math.log(cs.VTM_TRAIN_BATCH),
            "image_cosine_before": before, "image_cosine_after": image_cosine(model, batch),
            "losses": losses}), flush=True)
        del state, opt, model, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if sys.argv[1:2] == ["l14"] and len(sys.argv) == 3:
        l14(sys.argv[2])
    elif sys.argv[1:2] == ["ln"] and len(sys.argv) == 3:
        ln(sys.argv[2])
    elif sys.argv[1:] == ["coca"]:
        sys.exit(coca())
    elif sys.argv[1:] == ["vitamin"]:
        vitamin()
    else:
        sys.exit(__doc__)
