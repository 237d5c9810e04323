"""The PyTorch port's CLIP serving slice against the JAX package.

A tiny config (2 layers, width 128, 2 heads of 64, 32-pixel images in 16-pixel
patches, 16-token context) gets its params from the JAX package's ``init_clip``;
``params_from_jax`` carries them into the port, and both encode the same inputs
from a numpy seed. fp32 features and logits agree to 1e-4 (matmuls summed in
other orders). JAX runs once on its dense path (``attn_impl="auto"`` on the CPU)
and once through its Pallas short-attention kernel in interpret mode.

Also: the state-dict keys are the reference checkpoint's, ``create_model``
refuses to run on the CPU unless asked, and no module of the port imports JAX or
the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_clip_tpu.ops.short_attention as jsa
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.convert import convert_params_dtype, params_to_torch_state_dict
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.zero_shot_classifier import build_zero_shot_classifier as jax_zero_shot

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import convert_params_dtype_, params_from_jax
from open_clip_tpu_torch.models.clip import CLIPModel

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "open_clip_tpu_torch"
TINY = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 128, "patch_size": 16, "head_width": 64},
    "text_cfg": {"context_length": 16, "width": 128, "heads": 2, "layers": 2},
}
TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxCfg.from_dict(TINY)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(TINY)
    model = CLIPModel(cfg).eval()
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (4, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(4), [5, 9, 15, 2]] = 49407  # EOT at varied positions
    return jcfg, params, model, images, texts


def test_state_dict_keys_are_the_reference_layout(tiny):
    jcfg, params, model, _, _ = tiny
    ref = params_to_torch_state_dict(params, custom_text=False)
    ours = params_from_jax(params, model.cfg)
    assert set(ours) == set(ref) == set(model.state_dict())
    for key, value in ours.items():
        if key != "visual.conv1.weight":  # kept in the (ph*pw*3, width) patchify layout
            assert tuple(value.shape) == ref[key].shape, key
    assert ours["visual.conv1.weight"].numel() == ref["visual.conv1.weight"].size


@pytest.mark.parametrize("attn_impl", ["auto", "short"])
def test_encoders_and_logits_match_jax(tiny, monkeypatch, attn_impl):
    jcfg, params, model, images, texts = tiny
    monkeypatch.setattr(jsa, "_INTERPRET", True)
    jimg, jtxt = jnp.asarray(images), jnp.asarray(texts)
    kw = {"attn_impl": attn_impl}
    with torch.no_grad():
        fi = model.encode_image(images, normalize=True).numpy()
        ft = model.encode_text(texts, normalize=True).numpy()
        raw = model.encode_text(texts).numpy()
        logits, logits_t = model.get_logits(images, texts)
    np.testing.assert_allclose(fi, np.asarray(jclip.encode_image(params, jcfg, jimg, normalize=True, **kw)),
                               atol=TOL)
    np.testing.assert_allclose(ft, np.asarray(jclip.encode_text(params, jcfg, jtxt, normalize=True, **kw)),
                               atol=TOL)
    np.testing.assert_allclose(raw, np.asarray(jclip.encode_text(params, jcfg, jtxt, **kw)), atol=TOL)
    jl, jl_t = jclip.get_logits(params, jcfg, jimg, jtxt, **kw)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL * 100)  # logit scale 1/0.07
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(jl_t), atol=TOL * 100)


VARIANTS = {
    # options that configs in the registry set (CLIPA, ViT-*-quickgelu, ...)
    "ls_quickgelu_avgpool": {
        "quick_gelu": True,
        "vision_cfg": {"ls_init_value": 0.1, "pool_type": "avg", "final_ln_after_pool": True},
        "text_cfg": {"ls_init_value": 0.1, "pool_type": "last"}},
    "bidir_text_eos_no_ln_pre": {
        "init_logit_bias": -10.0,
        "vision_cfg": {"no_ln_pre": True, "norm_kwargs": {"eps": 1e-6}},
        "text_cfg": {"no_causal_mask": True, "pool_type": "eos", "eos_id": 49407,
                     "norm_kwargs": {"eps": 1e-6}}},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_variants_match_jax(variant):
    d = {k: dict(v) if isinstance(v, dict) else v for k, v in TINY.items()}
    for k, v in VARIANTS[variant].items():
        d[k] = {**d[k], **v} if isinstance(v, dict) else v
    jcfg = JaxCfg.from_dict(d)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(1), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(d)
    model = CLIPModel(cfg).eval()
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (3, 16)).astype(np.int32)
    texts[np.arange(3), [4, 15, 9]] = 49407
    with torch.no_grad():
        logits, _ = model.get_logits(images, texts)
        fi, ft = model.encode_image(images), model.encode_text(texts)
    np.testing.assert_allclose(fi.numpy(), np.asarray(jclip.encode_image(params, jcfg, jnp.asarray(images))),
                               atol=TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(jclip.encode_text(params, jcfg, jnp.asarray(texts))),
                               atol=TOL)
    jl, _ = jclip.get_logits(params, jcfg, jnp.asarray(images), jnp.asarray(texts))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL * 100)


def test_params_the_port_lacks_raise(tiny):
    _, params, model, _, _ = tiny
    extra = {**params, "visual": {**params["visual"], "proj_bias": np.zeros(64, np.float32)}}
    with pytest.raises(KeyError, match="proj_bias"):
        params_from_jax(extra, model.cfg)


def test_forward_dict_matches_jax(tiny):
    jcfg, params, model, images, texts = tiny
    with torch.no_grad():
        out = model(images, texts)
    ref = jclip.clip_forward(params, jcfg, jnp.asarray(images), jnp.asarray(texts))
    assert set(out) == set(ref)
    for key in out:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=TOL, err_msg=key)


def test_pure_bf16_matches_jax(tiny):
    """pure_bf16: the same weights cast to bf16 and bf16 compute in both. The two
    frameworks round at other places, so the features agree in direction only."""
    jcfg, params, _, images, texts = tiny
    jp = convert_params_dtype(jax.tree.map(jnp.asarray, params), jnp.bfloat16)
    cfg = oc.CLIPModelCfg.from_dict(TINY)
    model = CLIPModel(cfg, compute_dtype=torch.bfloat16).eval()
    model.load_state_dict(params_from_jax(params, cfg))
    convert_params_dtype_(model, torch.bfloat16)
    ref_dtypes = {k: str(v.dtype) for k, v in params_to_torch_state_dict(jp, custom_text=False).items()}
    assert {k: str(v.dtype).split(".")[1] for k, v in model.state_dict().items()} == ref_dtypes
    with torch.no_grad():
        fi = model.encode_image(images, normalize=True)
        ft = model.encode_text(texts, normalize=True)
    assert fi.dtype == ft.dtype == torch.bfloat16
    for ours, ref in ((fi, jclip.encode_image(jp, jcfg, jnp.asarray(images), normalize=True,
                                              compute_dtype=jnp.bfloat16)),
                      (ft, jclip.encode_text(jp, jcfg, jnp.asarray(texts), normalize=True,
                                             compute_dtype=jnp.bfloat16))):
        a, b = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
        cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
        assert cos.min() >= 0.999, cos


def test_zero_shot_classifier_matches_jax(tiny):
    jcfg, params, model, _, _ = tiny
    tokenizer = oc.get_tokenizer("ViT-B-32", context_length=16)
    classnames = oc.IMAGENET_CLASSNAMES[:3]
    ours = oc.build_zero_shot_classifier(model, tokenizer, classnames, oc.SIMPLE_IMAGENET_TEMPLATES,
                                         num_classes_per_batch=2)
    ref = jax_zero_shot(jclip.CLIPModel(jcfg, params), tokenizer, classnames,
                        oc.SIMPLE_IMAGENET_TEMPLATES, num_classes_per_batch=2)
    assert tuple(ours.shape) == (64, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL)


def test_vit_b_32_has_the_jax_parameter_count():
    cfg = oc.CLIPModelCfg.from_dict(oc.get_model_config("ViT-B-32"))
    with torch.device("meta"):
        model = CLIPModel(cfg)
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0),
                                                    JaxCfg.from_dict(oc.get_model_config("ViT-B-32"))))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == jax_count


def test_create_model_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        oc.create_model("ViT-B-32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        oc.create_model_and_transforms("ViT-B-32", precision="pure_bf16")


@pytest.mark.parametrize("name,kwargs", [
    ("RN50", {"pretrained": "openai"}),  # RN50 builds; its registry tag is not fetched
    ("coca_roberta-ViT-B-32", {}),  # CoCa builds; its HF text tower does not
    ("MobileCLIP-S1", {}),  # a timm tower (FastViT)
    # nothing is downloaded: a hub name (and a registry tag, below) raises
    ("hf-hub:laion/clap-htsat-unfused", {}),
    ("ViT-B-32", {"pretrained": "openai"}),
    ("CLAP-Whisper-tiny-Roberta-base", {}),
    ("CLAP-HTSAT-tiny-Roberta-base-fused", {}),
])
def test_unported_models_raise(name, kwargs):
    with pytest.raises(NotImplementedError):
        oc.create_model(name, device="cpu", **kwargs)


def test_fp16_precision_is_refused():
    with pytest.raises(ValueError, match="unknown precision"):
        oc.create_model("ViT-B-32", precision="pure_fp16", device="cpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py", REPO / "chip_recheck.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "open_clip_tpu", "flax", "optax")]
    assert not bad, bad


_NO_JAX = """
import sys
for name in ("jax", "jaxlib", "open_clip_tpu", "PIL"):
    sys.modules[name] = None  # any import of them now raises
import numpy as np, torch
torch.set_num_threads(1)
import chip_smoke
import open_clip_tpu_torch as oc
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch import checkpoint, data, loss
from open_clip_tpu_torch.data import naflex
from open_clip_tpu_torch.models import naflex_vit
from open_clip_tpu_torch.ops import _build, attention, flash_attention, fused_ln, layers, short_attention
from open_clip_tpu_torch.ops import switchback
from open_clip_tpu_torch.models import blocks
from open_clip_tpu_torch.train import main, optim, params, scheduler, train_loop, train_step
from open_clip_tpu_torch import parallel
from open_clip_tpu_torch.parallel import distributed, mesh
from open_clip_tpu_torch import native, transform
from open_clip_tpu_torch.data import datasets, wds
from open_clip_tpu_torch.train import metrics as eval_metrics, zero_shot
for name in ("safetensors", "huggingface_hub", "transformers"):
    sys.modules[name] = None
from open_clip_tpu_torch import _safetensors, pretrained, push_to_hf_hub
from open_clip_tpu_torch.ops import pos_embed
cfg = oc.CLIPModelCfg.from_dict({cfg!r})
model = CLIPModel(cfg).eval()
model.init_weights(torch.Generator().manual_seed(0))
preprocess = oc.make_device_preprocess(oc.PreprocessCfg(size=32))
tok = oc.get_tokenizer("ViT-B-32", context_length=16)
with torch.no_grad():
    x = preprocess(torch.zeros(2, 40, 48, 3, dtype=torch.uint8))
    clf = oc.build_zero_shot_classifier(model, tok, ["cat", "dog"], oc.SIMPLE_IMAGENET_TEMPLATES)
    logits = model.encode_image(x, normalize=True) @ clf
assert logits.shape == (2, 2) and bool(torch.isfinite(logits).all())
layers.FUSED_LN_BWD = True
opt = optim.create_optimizer(optim.OptimizerCfg(grad_clip_norm=1.0), model, scheduler.const_lr(1e-3, 0))
state = train_step.create_train_state(model, opt)
batch = {{"image": torch.randn(4, 32, 32, 3), "text": torch.randint(1, 1000, (4, 16))}}
state, metrics = train_step.make_train_step(cfg, opt, remat=True)(state, batch)
assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY = "switchback", "names_mm"
state, metrics = train_step.make_train_step(cfg, opt, remat=True)(state, batch)
assert state.step == 2 and bool(torch.isfinite(metrics["loss"]))
blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY = "dense", "none"
ncfg = oc.CLIPModelCfg.from_dict({{"embed_dim": 32, "custom_text": True, "vision_cfg": {{
    "image_size": 32, "timm_model_name": "naflexvit_tiny_patch16_gap",
    "timm_model_kwargs": {{"embed_dim": 64, "depth": 1, "num_heads": 1}}}}, "text_cfg": cfg.text_cfg.__dict__}})
nmodel = CLIPModel(ncfg)
nmodel.init_weights(torch.Generator().manual_seed(0))
patches = naflex.NaFlexTransform(8, 16)(torch.zeros(2, 40, 48, 3, dtype=torch.uint8))
q = torch.randn(1, 9, 1, 64, requires_grad=True)
flash_attention.flash_attention(q, q, q, causal=True, prefix_len=2).sum().backward()
with torch.no_grad():
    assert nmodel.encode_image(patches).shape == (2, 32)
canvas, status = native.decode_resize_one(open("tests/assets_torch/img00_320x240.jpg", "rb").read(), 64)
assert status == 0 and canvas.shape == (64, 64, 3)
pp = transform.make_device_train_preprocess(oc.PreprocessCfg(size=32))
assert pp(torch.Generator(), torch.zeros(2, 48, 48, 3, dtype=torch.uint8)).shape == (2, 32, 32, 3)
assert eval_metrics.get_clip_metrics(np.eye(3, dtype=np.float32), np.eye(3, dtype=np.float32))["image_to_text_R@1"] == 1.0
import tempfile
oc.add_model_config({cfg!r}, name="tiny-nojax")
src = oc.create_model("tiny-nojax", device="cpu", seed=3)
ref = {{"module." + k: v for k, v in oc.convert.reference_state_dict(src).items()}}
with tempfile.TemporaryDirectory() as d:
    torch.save({{"state_dict": ref}}, d + "/w.pt")
    torch.save(ref, d + "/w.bin")
    _safetensors.save_file(oc.convert.reference_state_dict(src), d + "/w.safetensors")
    np.savez(d + "/w.npz", **{{k: v.numpy() for k, v in ref.items()}})
    oc.save_for_hf(src, d + "/dir")
    with torch.no_grad():
        want = src.encode_image(x)
        for name, pre in [("tiny-nojax", d + "/w." + e) for e in ("pt", "bin", "safetensors", "npz")] + [
                ("local-dir:" + d + "/dir", None)]:
            got = oc.create_model(name, pretrained=pre, device="cpu").encode_image(x)
            assert torch.equal(got, want), name
import struct, zlib
from open_clip_tpu_torch.data import bucketing
from open_clip_tpu_torch.native import png
def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))
rows = b"".join(b"\\x00" + bytes(range(6)) for _ in range(2))
data = (png.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))
assert png.decode_png(data).tolist() == [[[0, 1, 2], [3, 4, 5]]] * 2
imgs, status = native.decode_full_batch([open("tests/assets_torch/img00_320x240.jpg", "rb").read()], 1)
assert status == [0] and imgs[0].shape == (240, 320, 3)
order = bucketing.LengthBucketer(pool=4, chunk=1)([{{"caption": np.zeros(n)}} for n in (3, 1, 2)])
assert sorted(len(s["caption"]) for s in order) == [1, 2, 3]
for name in ("muon", "lamb", "adafactor", "lion", "nadamw", "sgd"):
    opt = optim.create_optimizer(optim.OptimizerCfg(opt=name), model, scheduler.const_lr(1e-3, 0))
    state = train_step.create_train_state(model, opt, ema=True)
    state, metrics = train_step.make_train_step(cfg, opt, ema_decay=0.9)(state, batch)
    assert bool(torch.isfinite(metrics["loss"])), name
cfg.vision_cfg.patch_dropout = 0.5
blocks.REMAT_POLICY = "dots_no_batch"
state, metrics = train_step.make_train_step(cfg, opt, remat=True)(state, batch)
assert bool(torch.isfinite(metrics["loss"]))
blocks.REMAT_POLICY = "none"
from open_clip_tpu_torch.models import genlap, genlip
glip = oc.create_model("naflexgenlip_test", device="cpu")
gp = naflex.NaFlexTransform(12, 16)(torch.zeros(2, 40, 48, 3, dtype=torch.uint8))
gt = torch.randint(0, 1000, (2, 6))
with torch.no_grad():
    assert glip.encode_image(gp).shape == (2, 64)
    assert glip.generate(gp, seq_len=4).shape == (2, 4)
    assert glip.score_captions(glip.prefix_cache(gp), gt).shape == (2,)
gopt = optim.create_optimizer(optim.OptimizerCfg(), glip, scheduler.const_lr(1e-3, 0))
_, metrics = train_step.make_train_step(glip.cfg, gopt, loss_type="genlip", accum_steps=2)(
    train_step.create_train_state(glip, gopt), {{"image": gp, "text": gt}})
assert bool(torch.isfinite(metrics["loss"])) and float(metrics["logit_scale"]) == 0.0
assert isinstance(oc.create_model("naflexgenlap_test_2d", device="cpu"), genlap.GenLapModel)
print("ok")
"""


def test_port_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _NO_JAX.format(cfg=TINY)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
