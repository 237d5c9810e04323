"""The port's EVA towers (EVA01, EVA02, PE-Core) against the JAX package's ``apply_eva``,
on the CPU.

Three micro towers (64-pixel images, patch 16: 16 patch tokens and the class token;
width 64, two heads of 32, two blocks), registered in both packages' ``EVA_CONFIGS``:
EVA01's form (fused qkv with the zero k bias, GELU MLP), EVA02's (separate q/k/v with
k unbiased, SwiGLU with the inner LayerNorm, rope with ``ref_feat_shape``) and PE-Core's
(fused qkv with rope, GELU MLP, the MAP pool). Each gets its params from the JAX
package's ``init_clip``, with the q and v biases made nonzero (the init's zeros would
hide them), and ``params_from_jax`` carries them into the port. Inputs from a numpy
seed.

Tolerances. fp32 features: within 1e-5 relative (the norm of the difference over the
norm); bf16: cosine >= 0.999 against JAX's bf16. Gradients: cosine >= 0.99999 per
tensor (and the loss 1e-5 relative). Steps (fp32, AdamW, clip 1.0): loss and grad_norm
1e-5 relative, the parameters 2e-2 * lr (``tests/test_torch_train_step.py``'s reasons).
Rope table: bit for bit. Masks: exact; layer-decay scales 1 ulp. Converters: bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu import checkpoint as jckpt
from open_clip_tpu import convert as jconvert
from open_clip_tpu.config import CLIPModelCfg as JaxCfg, parse_model_cfg as jax_parse_model_cfg
from open_clip_tpu.loss import clip_loss as jax_clip_loss
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import eva as jeva
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import checkpoint as pckpt
from open_clip_tpu_torch import factory
from open_clip_tpu_torch.convert import convert_params_dtype_, params_from_jax, torch_clip_to_params
from open_clip_tpu_torch.models import blocks as pblocks
from open_clip_tpu_torch.models import eva as peva
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

_COMMON = dict(dim=64, depth=2, heads=2, patch=16, image_size=64)
MICRO = {
    "eva01": ("eva_torch_micro", dict(
        mlp_hidden=128, swiglu=False, fused_qkv=True, rope=False, scale_mlp=False)),
    "eva02": ("eva02_torch_micro", dict(
        mlp_hidden=96, swiglu=True, fused_qkv=False, rope=True, scale_mlp=True,
        ref_feat_shape=(16, 16))),
    "pe": ("vit_pe_core_torch_micro", dict(
        mlp_hidden=128, swiglu=False, fused_qkv=True, rope=True, scale_mlp=False, pool="map")),
}
VARIANTS = list(MICRO)
TEXT = {"context_length": 16, "width": 64, "heads": 2, "layers": 2}
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
B = 6
EVA_REGISTRY = ["EVA01-g-14", "EVA01-g-14-plus", "EVA02-B-16", "EVA02-E-14", "EVA02-E-14-plus",
                "EVA02-L-14", "EVA02-L-14-336", "PE-Core-B-16", "PE-Core-L-14-336",
                "PE-Core-S-16-384", "PE-Core-T-16-384", "PE-Core-bigG-14-448"]


def _raw(variant):
    return {"embed_dim": 32, "custom_text": True, "text_cfg": TEXT,
            "vision_cfg": {"image_size": 64, "timm_model_name": MICRO[variant][0],
                           "timm_model_pretrained": False,
                           "timm_pool": "map" if variant == "pe" else "token", "timm_proj": None}}


@pytest.fixture(scope="module", autouse=True)
def registered():
    for table, cls in ((jeva.EVA_CONFIGS, jeva.EvaCfg), (peva.EVA_CONFIGS, peva.EvaCfg)):
        for name, kw in MICRO.values():
            table[name] = cls(**_COMMON, **kw)
    yield
    for table in (jeva.EVA_CONFIGS, peva.EVA_CONFIGS):
        for name, _ in MICRO.values():
            table.pop(name, None)


@pytest.fixture(scope="module")
def setups(registered):
    out = {}
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (B, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(B), rng.integers(2, 16, B)] = 49407
    for i, variant in enumerate(VARIANTS):
        jcfg = JaxCfg.from_dict(_raw(variant))
        params = jax.tree.map(np.array, jax.jit(lambda k: jclip.init_clip(k, jcfg))(
            jax.random.PRNGKey(i)))
        attn = params["visual"]["blocks"]["attn"]
        for name in ("q_bias", "v_bias"):
            if name in attn:
                attn[name][:] = rng.standard_normal(attn[name].shape) * 0.1
        out[variant] = (jcfg, params, oc.CLIPModelCfg.from_dict(_raw(variant)), images, texts)
    return out


def _model(params, cfg, dtype=torch.float32):
    model = CLIPModel(cfg, compute_dtype=dtype)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("gh,gw,hd,ref", [(4, 4, 32, (16, 16)), (14, 14, 64, (16, 16)),
                                          (24, 24, 64, None), (16, 16, 64, (16, 16)),
                                          (3, 5, 16, (2, 7))])
def test_rope_table_equals_jax(gh, gw, hd, ref):
    np.testing.assert_array_equal(peva.rope_table(gh, gw, hd, ref),
                                  jeva.rope_table(gh, gw, hd, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    """fp32 arithmetic, one rounding to the input dtype: bf16 bit for bit."""
    x = np.random.default_rng(1).standard_normal((2, 16, 2, 32)).astype(np.float32)
    table = peva.rope_table(4, 4, 32, (16, 16))
    want = jeva.apply_rope(jnp.asarray(x, dtype), jnp.asarray(table))
    got = peva.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(table))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-6 if dtype == "float32" else 0, atol=1e-6 if dtype == "float32" else 0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_tower_matches_apply_eva(setups, variant):
    jcfg, params, cfg, images, _ = setups[variant]
    jp = jax.tree.map(jnp.asarray, params["visual"])
    want = jeva.apply_eva(jp, jcfg.vision_cfg, jnp.asarray(images))
    with torch.no_grad():
        got = _model(params, cfg).visual(torch.from_numpy(images))
    assert _rel(got.numpy(), want) <= 1e-5
    want16 = jeva.apply_eva(jp, jcfg.vision_cfg, jnp.asarray(images), compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got16 = _model(params, cfg, torch.bfloat16).visual(torch.from_numpy(images), torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert _cos(got16.float().numpy(), np.asarray(want16, np.float32)) >= 0.999


@pytest.mark.parametrize("variant", VARIANTS)
def test_clip_features_and_logits_match_jax(setups, variant):
    jcfg, params, cfg, images, texts = setups[variant]
    jp = jax.tree.map(jnp.asarray, params)
    fi = jclip.encode_image(jp, jcfg, jnp.asarray(images), normalize=True)
    ft = jclip.encode_text(jp, jcfg, jnp.asarray(texts), normalize=True)
    logits = jnp.exp(jp["logit_scale"]) * fi @ ft.T
    model = _model(params, cfg)
    with torch.no_grad():
        gi = model.encode_image(torch.from_numpy(images), normalize=True)
        gt = model.encode_text(torch.from_numpy(texts), normalize=True)
        lpi, _ = model.get_logits(torch.from_numpy(images), torch.from_numpy(texts))
    assert _rel(gi.numpy(), fi) <= 1e-5 and _rel(gt.numpy(), ft) <= 1e-5
    assert _rel(lpi.numpy(), logits) <= 1e-5


def _jax_grads(jcfg, params, images, texts, remat):
    def loss_fn(p):
        out = jclip.clip_forward(p, jcfg, jnp.asarray(images), jnp.asarray(texts), train=True,
                                 compute_dtype=jnp.float32, remat=remat)
        return jax_clip_loss(out["image_features"], out["text_features"],
                             jnp.exp(p["logit_scale"]))

    return jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_gradients_match_jax(setups, variant, remat):
    """Every gradient of the contrastive loss, without remat and with each block
    recomputed (the JAX ``jax.checkpoint`` of the scan body)."""
    jcfg, params, cfg, images, texts = setups[variant]
    want_loss, jgrads = _jax_grads(jcfg, params, images, texts, remat)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    model = _model(params, cfg)
    out = oc.clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True,
                          remat=remat)
    loss = oc.clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    for key, p in model.named_parameters():
        assert _cos(p.grad.numpy(), want[key].numpy()) >= 0.99999, key


@pytest.mark.parametrize("policy", ["names_mm", "dots"])
def test_remat_policies_give_the_plain_gradients(setups, policy):
    """The selective policies save different tensors; the gradients stay the plain ones."""
    jcfg, params, cfg, images, texts = setups["eva02"]
    grads = []
    for remat, pol in ((False, "none"), (True, policy)):
        model = _model(params, cfg)
        old, pblocks.REMAT_POLICY = pblocks.REMAT_POLICY, pol
        try:
            out = oc.clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts),
                                  train=True, remat=remat)
            oc.clip_loss(out["image_features"], out["text_features"],
                         model.logit_scale.exp()).backward()
        finally:
            pblocks.REMAT_POLICY = old
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for key, g in grads[0].items():
        torch.testing.assert_close(grads[1][key], g, rtol=1e-5, atol=1e-7, msg=key)


def _jax_step(jcfg, params, images, texts, accum_steps=1):
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP),
                                   jparams, jsched.const_lr(LR, WARMUP))
    step = jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32, accum_steps=accum_steps)
    return jax.jit(step)(jts.create_train_state(jparams, jopt),
                         {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                         jax.random.PRNGKey(0))


@pytest.mark.parametrize("variant,accum", [("eva01", 1), ("eva02", 1), ("pe", 1), ("eva02", 2)],
                         ids=["eva01", "eva02", "pe", "eva02-gradcache"])
def test_one_step_matches_jax(setups, variant, accum):
    """One AdamW step with clipping, and the GradCache step over two microbatches."""
    jcfg, params, cfg, images, texts = setups[variant]
    jstate, jm = _jax_step(jcfg, params, images, texts, accum)
    model = _model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    state, m = pts.make_train_step(cfg, opt, accum_steps=accum)(
        pts.create_train_state(model, opt),
        {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)})
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    for key, v in state.model.state_dict().items():
        assert np.abs(v.numpy() - want[key].numpy()).max() <= 2e-2 * LR, key


def _masks_as_port(values, params, cfg):
    full = jax.tree.map(lambda v, p: np.broadcast_to(np.asarray(v, np.float32), p.shape).copy(),
                        values, params)
    return params_from_jax(full, cfg)


@pytest.mark.parametrize("which", ["wd", "layer_decay", "lock0", "lock1", "lock2", "lock3"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_masks_match_jax(setups, variant, which):
    """The weight-decay mask (``pos_embed`` is decayed: it is not in ``NO_WD_NAMES``;
    ``cls_token`` and the q/v biases are 1-D), the layer-decay scales (``head`` is a
    kernel, so not at 1) and the lock masks (every block's ``attn.proj`` unlocks with
    the head: ``proj`` is a head name), tensor by tensor."""
    _, params, cfg, _, _ = setups[variant]
    model = CLIPModel(cfg)
    if which == "wd":
        want, got = joptim.wd_mask(params), poptim.wd_mask(model)
    elif which == "layer_decay":
        want = joptim.layer_decay_scales(params, 0.75, 12)
        got = poptim.layer_decay_scales(model, 0.75, 12)
    else:
        kw = {"lock_image": True, "lock_image_unlocked_groups": int(which[-1])}
        want, got = joptim.trainable_mask(params, **kw), poptim.trainable_mask(model, **kw)
    want = _masks_as_port(want, params, cfg)
    assert list(got) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        g = torch.as_tensor(got[name], dtype=torch.float32).expand(p.shape).numpy()
        np.testing.assert_allclose(g, want[name].numpy(), rtol=np.finfo(np.float32).eps,
                                   atol=0, err_msg=name)
    if which == "wd":
        assert got["visual.pos_embed"] and not got["visual.cls_token"]
    if which == "layer_decay":
        assert got["visual.head.weight"] == pytest.approx(0.75 ** 3)
        assert got["visual.transformer.resblocks.1.norm1.weight"] == pytest.approx(0.75)
    if which == "lock1":
        assert got["visual.head.weight"] == 1.0 and got["visual.norm.weight"] == 0.0
        assert got["visual.transformer.resblocks.0.attn.proj.weight"] == 1.0


@pytest.mark.parametrize("variant", VARIANTS)
def test_pure_bf16_partition_matches_jax(setups, variant):
    """The linears (the fused qkv and the head included) go to bf16; the q/v biases,
    the class token, ``pos_embed``, the norms and the MAP latent stay fp32."""
    _, params, cfg, _, _ = setups[variant]
    model = convert_params_dtype_(_model(params, cfg), torch.bfloat16)
    jdt = jconvert.convert_params_dtype(params, jnp.bfloat16)
    want = params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, a.dtype == jnp.bfloat16, np.float32), jdt), cfg)
    for key, p in model.named_parameters():
        assert (p.dtype == torch.bfloat16) == bool(want[key].flatten()[0]), key


def _timm_sd(params, variant):
    """A timm Eva CLIP checkpoint (``visual.trunk.*``) written from the JAX tree, the
    text tower through the port's names."""
    vis = params["visual"]
    sd = {}

    def lin(prefix, node):
        sd[prefix + ".weight"] = np.asarray(node["kernel"]).T
        if "bias" in node:
            sd[prefix + ".bias"] = node["bias"]

    def ln(prefix, node):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = node["scale"], node["bias"]

    t = "visual.trunk."
    k = np.asarray(vis["patch_embed"]["kernel"])
    sd[t + "patch_embed.proj.weight"] = k.reshape(16, 16, 3, -1).transpose(3, 2, 0, 1)
    sd[t + "patch_embed.proj.bias"] = vis["patch_embed"]["bias"]
    sd[t + "cls_token"] = np.asarray(vis["cls_token"]).reshape(1, 1, -1)
    sd[t + "pos_embed"] = np.asarray(vis["pos_embed"])[None]
    ln(t + "norm", vis["norm"])
    lin(t + "head", vis["head"])
    if "attn_pool" in vis:
        ap = vis["attn_pool"]
        sd[t + "attn_pool.latent"] = np.asarray(ap["latent"]).reshape(1, 1, -1)
        for name in ("q", "kv", "proj"):
            lin(t + f"attn_pool.{name}", ap[name])
        ln(t + "attn_pool.norm", ap["norm"])
        lin(t + "attn_pool.mlp.fc1", ap["mlp"]["c_fc"])
        lin(t + "attn_pool.mlp.fc2", ap["mlp"]["c_proj"])
    names = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "qkv": "qkv", "proj": "proj"}
    for i in range(2):
        row = jax.tree.map(lambda a: np.asarray(a[i]), vis["blocks"])
        b = f"{t}blocks.{i}."
        ln(b + "norm1", row["norm1"])
        ln(b + "norm2", row["norm2"])
        for name, node in row["attn"].items():
            if isinstance(node, dict):
                lin(b + "attn." + names[name], node)
            else:
                sd[b + "attn." + name] = node
        for name, node in row["mlp"].items():
            (ln if name == "norm" else lin)(b + "mlp." + name, node)
    model = _model(params, oc.CLIPModelCfg.from_dict(_raw(variant)))
    sd.update({k: v.numpy() for k, v in model.state_dict().items() if not k.startswith("visual.")})
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_converter_matches_jax(setups, variant):
    """The timm layout through the port's converter gives the JAX converter's tree,
    and a strict load gives the weights it was written from."""
    jcfg, params, cfg, _, _ = setups[variant]
    sd = _timm_sd(params, variant)
    want = jax.tree.map(np.asarray, jconvert.torch_clip_to_params(
        {k: torch.from_numpy(v) for k, v in sd.items()}, jcfg)["visual"])
    got = torch_clip_to_params({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)["visual"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    model = CLIPModel(cfg)
    pckpt.merge_params_(model, pckpt.checkpoint_to_params(sd, cfg))
    ref = _model(params, cfg).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())


def test_a_pos_embed_of_another_size_raises_in_both(setups):
    """``pos_embed`` is not the ViT's ``positional_embedding``: neither package resizes
    it, and a strict load of another grid raises."""
    jcfg, params, cfg, _, _ = setups["eva02"]
    sd = _timm_sd(params, "eva02")
    sd["visual.trunk.pos_embed"] = np.zeros((1, 26, 64), np.float32)
    tree = jconvert.torch_clip_to_params({k: torch.from_numpy(v) for k, v in sd.items()}, jcfg)
    tree.pop("_unconverted", None)
    with pytest.raises(ValueError, match="pos_embed"):
        jckpt.merge_params(jax.tree.map(jnp.asarray, params), tree, jcfg)
    with pytest.raises(ValueError, match="pos_embed"):
        pckpt.merge_params_(CLIPModel(cfg), pckpt.checkpoint_to_params(sd, cfg))


@pytest.mark.parametrize("name", EVA_REGISTRY)
def test_registry_configs_build_with_the_jax_parameter_count(name):
    raw = factory.get_model_config(name)
    with torch.device("meta"):
        model = factory.model_from_config(raw)
    jcfg = jax_parse_model_cfg(name)
    want = jax.eval_shape(lambda k: jclip.init_clip(k, jcfg), jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(want))
    assert isinstance(model.visual, peva.Eva)


def test_registry_tags_raise_naming_their_file():
    with pytest.raises(NotImplementedError, match="merged2b_s8b_b131k"):
        oc.create_model("EVA02-B-16", pretrained="merged2b_s8b_b131k", device="cpu")


def test_create_model_draws_the_jax_distributions():
    """``create_model`` on the CPU: the fused-qkv kernels N(0, 0.02) within +-2 std,
    the q/v biases zero, the class and latent tokens N(0, 0.02)."""
    model = oc.create_model("PE-Core-T-16-384", device="cpu", seed=0)
    blk = model.visual.transformer.resblocks[3]
    w = blk.attn.qkv.weight
    assert w.abs().max() <= 0.04 and abs(w.std().item() - 0.0176) < 2e-3
    assert not blk.attn.q_bias.any() and not blk.attn.v_bias.any()
    for t in (model.visual.cls_token, model.visual.attn_pool.latent):
        assert abs(t.std().item() - 0.02) < 4e-3
    assert model.visual.rope.shape == (576, 2 * 64)


def test_cli_trains_with_remat_and_a_lock(tmp_path):
    """The CLI on the micro EVA02 under full remat (``--grad-checkpointing``), the image
    tower locked but for its head (``head``, and every block's ``attn.proj``)."""
    from open_clip_tpu_torch.train.main import main

    oc.add_model_config(_raw("eva02"), name="micro-torch-eva02")
    start = oc.create_model("micro-torch-eva02", device="cpu", seed=0).state_dict()
    state = main(["--model", "micro-torch-eva02", "--dataset-type", "synthetic",
                  "--train-num-samples", "16", "--batch-size", "8", "--epochs", "1",
                  "--device", "cpu", "--lr", "1e-3", "--grad-checkpointing", "--lock-image",
                  "--lock-image-unlocked-groups", "1", "--logs", str(tmp_path), "--name", "eva"])
    assert state.step == 2
    end = state.model.state_dict()
    for key in ("visual.head.weight", "visual.transformer.resblocks.0.attn.proj.weight",
                "text_projection"):
        assert not torch.equal(end[key], start[key]), key
    for key in ("visual.pos_embed", "visual.transformer.resblocks.1.mlp.fc1_g.weight",
                "visual.patch_embed.weight"):
        assert torch.equal(end[key], start[key]), key
