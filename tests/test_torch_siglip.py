"""The port's SigLIP slice against the JAX package.

A micro SigLIP (the SigLIP options through native fields: no class token, no
``ln_pre``, a MAP head, eps 1e-6, 32-pixel images in 8-pixel patches, width 64, 2
layers of 2 heads; a bidirectional text tower of width 64 and 16 tokens pooled at
the last one, with a biased projection; a logit bias from -10) gets its params
from the JAX package's ``init_clip``; ``params_from_jax`` carries them into the
port, and both take the same inputs from a numpy seed, in fp32.

Tolerances: features 1e-4 absolute (``TOL`` of ``test_torch_clip.py``: fp32
matmuls summed in other orders), logits 1e-2 (scale 14.3 times features, plus the
bias); the losses and their gradients 1e-5 relative; the train steps those of
``test_torch_train_step.py`` (loss and ``grad_norm`` 1e-5 relative, parameters
2e-2 * lr absolute per step taken).

Also the timm names that resolve to the native ViT (field for field against the
JAX package's ``resolve_timm_vision_cfg``), the registry's SigLIP configs built on
the meta device (parameter counts against ``jax.eval_shape(init_clip)``), the
weight-decay mask, the pure-bf16 partition, the ``--siglip`` CLI and the
tokenizer that waits for its vocabulary.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.config import parse_model_cfg as jax_parse_model_cfg
from open_clip_tpu.convert import convert_params_dtype
from open_clip_tpu.loss import siglip_loss as jax_siglip_loss
from open_clip_tpu.loss import siglip_loss_chunked as jax_siglip_loss_chunked
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import vit as jvit
from open_clip_tpu.task import loss_type_for as jax_loss_type_for
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.config import parse_model_cfg
from open_clip_tpu_torch.convert import convert_params_dtype_, params_from_jax
from open_clip_tpu_torch.loss import siglip_loss, siglip_loss_chunked
from open_clip_tpu_torch.model_configs import BUILTIN_MODEL_CONFIGS
from open_clip_tpu_torch.models import vit as pvit
from open_clip_tpu_torch.models.clip import CLIPModel, clip_forward
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts
from open_clip_tpu_torch.train.main import main

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

MICRO = {
    "embed_dim": 64,
    "init_logit_bias": -10,
    "vision_cfg": {"image_size": 32, "patch_size": 8, "width": 64, "layers": 2, "head_width": 32,
                   "class_token": False, "no_ln_pre": True, "pool_type": "map",
                   "norm_kwargs": {"eps": 1e-6}},
    "text_cfg": {"context_length": 16, "vocab_size": 1000, "width": 64, "heads": 2, "layers": 2,
                 "proj_bias": True, "no_causal_mask": True, "pool_type": "last",
                 "norm_kwargs": {"eps": 1e-6}},
}
# the timm gap trunk's options (vit_*_gap_*): the mean of the tokens, ln_post after it
GAP = {**MICRO, "vision_cfg": {**MICRO["vision_cfg"], "pool_type": "avg",
                               "final_ln_after_pool": True}}
TOL = 1e-4
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
BATCH = 8


def _cfgs(d):
    return JaxCfg.from_dict(d), oc.CLIPModelCfg.from_dict(d)


def _port_model(params, cfg, no_proj=False):
    model = CLIPModel(cfg)
    if no_proj:  # a timm trunk with timm_proj "none" (the real ones are full-size)
        model.visual.proj = None
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


@pytest.fixture(scope="module")
def micro():
    jcfg, cfg = _cfgs(MICRO)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 1000, (BATCH, 16)).astype(np.int32)
    return jcfg, params, cfg, images, texts


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

_TIMM_VIT = re.compile(r"vit_[a-z0-9]+_patch\d+_(siglip|clip|gap)")
TIMM_VIT_CONFIGS = sorted(n for n, c in BUILTIN_MODEL_CONFIGS.items()
                          if _TIMM_VIT.match((c.get("vision_cfg") or {}).get("timm_model_name") or ""))
SIGLIP_CONFIGS = sorted(n for n, c in BUILTIN_MODEL_CONFIGS.items()
                        if "siglip" in ((c.get("vision_cfg") or {}).get("timm_model_name") or ""))


@pytest.mark.parametrize("name", TIMM_VIT_CONFIGS)
def test_resolve_timm_vision_cfg_matches_jax(name):
    want = jvit.resolve_timm_vision_cfg(jax_parse_model_cfg(name).vision_cfg)
    got = pvit.resolve_timm_vision_cfg(parse_model_cfg(name).vision_cfg)
    assert vars(got) == vars(want)


def test_the_registry_has_the_timm_names_of_the_slice():
    assert len(SIGLIP_CONFIGS) == 30 and len(TIMM_VIT_CONFIGS) == 30
    assert {"MobileCLIP2-L-14", "vit_medium_patch16_gap_256"} <= set(TIMM_VIT_CONFIGS)


def test_other_timm_names_raise():
    """Other timm towers, a SigLIP size the JAX package does not know, and MobileCLIP's
    trunk, whose conv stem is not ported."""
    for name in ("fastvit_mci1", "vit_so150m_patch16_siglip_256", "vit_base_patch16_rope",
                 "vit_base_mci_224"):
        cfg = oc.CLIPModelCfg.from_dict({**MICRO, "vision_cfg": {"timm_model_name": name}})
        with pytest.raises(NotImplementedError, match="vision tower not ported yet"):
            CLIPModel(cfg)


@pytest.mark.parametrize("name", SIGLIP_CONFIGS)
def test_siglip_registry_configs_build(name):
    """28 of the 30 build on the meta device; the two nllb-clip configs need an HF
    text tower built by name, which needs files that are not in the repository."""
    cfg = parse_model_cfg(name)
    with torch.device("meta"):
        if name.startswith("nllb-clip"):
            with pytest.raises(NotImplementedError, match="HF text tower"):
                CLIPModel(cfg)
            return
        model = CLIPModel(cfg)
    assert model.logit_bias is not None
    assert isinstance(model.text_projection, torch.nn.Linear) or cfg.text_cfg.proj_type == "none"


@pytest.mark.parametrize("name", ["ViT-B-16-SigLIP", "ViT-B-16-SigLIP-384", "ViT-L-16-SigLIP-256",
                                  "ViT-SO400M-14-SigLIP", "ViT-gopt-16-SigLIP2-256",
                                  "ViT-SO400M-16-SigLIP-i18n-256", "ViT-B-16-SigLIP2-naflex"])
def test_parameter_count_matches_jax(name):
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0), jax_parse_model_cfg(name)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = CLIPModel(parse_model_cfg(name))
    assert sum(p.numel() for p in model.parameters()) == want


def test_get_tokenizer_names_the_missing_vocab():
    with pytest.raises(NotImplementedError, match="timm/ViT-B-16-SigLIP"):
        oc.get_tokenizer("ViT-B-16-SigLIP")


def test_loss_type_for_matches_jax():
    for name in ("ViT-B-16-SigLIP", "ViT-B-32", "coca_ViT-B-32"):
        for kw in ({}, {"siglip": True}, {"distill": True}):
            assert (pts.loss_type_for(parse_model_cfg(name), **kw)
                    == jax_loss_type_for(jax_parse_model_cfg(name), **kw))


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["map", "map_no_proj", "gap"])
def test_towers_match_jax(micro, variant):
    """fp32 image and text features against ``encode_image``/``encode_text``, and the
    logits with the bias against ``get_logits``."""
    jcfg, params, cfg, images, texts = micro
    if variant == "gap":
        jcfg, cfg = _cfgs(GAP)
        params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(1), jcfg))
    no_proj = variant == "map_no_proj"
    if no_proj:
        params = {**params, "visual": {k: v for k, v in params["visual"].items() if k != "proj"}}
    model = _port_model(params, cfg, no_proj).eval()
    im, tx = images[:3], texts[:4]
    with torch.no_grad():
        fi, ft = model.encode_image(im), model.encode_text(tx)
        logits, _ = model.get_logits(im, tx)
    jp = jax.tree.map(jnp.asarray, params)
    np.testing.assert_allclose(fi.numpy(), np.asarray(jclip.encode_image(jp, jcfg, jnp.asarray(im))),
                               atol=TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(jclip.encode_text(jp, jcfg, jnp.asarray(tx))),
                               atol=TOL)
    jl, _ = jclip.get_logits(jp, jcfg, jnp.asarray(im), jnp.asarray(tx))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL * 100)
    assert float(logits.max()) < 0.0  # the -10 bias dominates at init


def test_state_dict_names(micro):
    _, params, cfg, _, _ = micro
    keys = set(_port_model(params, cfg).state_dict())
    assert {"visual.conv1.bias", "visual.attn_pool.latent", "visual.attn_pool.kv.weight",
            "visual.attn_pool.mlp.c_fc.weight", "text_projection.weight", "text_projection.bias",
            "logit_bias"} <= keys
    assert not keys & {"visual.class_embedding", "visual.ln_pre.weight"}


def test_unknown_map_pool_entry_raises(micro):
    _, params, cfg, _, _ = micro
    pool = {**params["visual"]["map_pool"], "query": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="query"):
        params_from_jax({**params, "visual": {**params["visual"], "map_pool": pool}}, cfg)


def test_pure_bf16_partition_matches_jax(micro):
    """The leaves ``convert_params_dtype`` casts are the ones ``convert_params_dtype_``
    casts: the patch embedding with its bias, the MAP pool's linears and the biased
    text projection, not the latent, the norms or the logit bias."""
    _, params, cfg, _, _ = micro
    jp = convert_params_dtype(jax.tree.map(jnp.asarray, params), jnp.bfloat16)
    flags = jax.tree.map(lambda x: np.full(x.shape, float(x.dtype == jnp.bfloat16), np.float32), jp)
    want = {k: bool(v.flatten()[0]) if v.numel() else False
            for k, v in params_from_jax(flags, cfg).items()}
    model = convert_params_dtype_(_port_model(params, cfg), torch.bfloat16)
    got = {k: v.dtype == torch.bfloat16 for k, v in model.state_dict().items()}
    assert got == want
    assert got["text_projection.bias"] and got["visual.attn_pool.q.weight"]
    assert not got["visual.attn_pool.latent"] and not got["logit_bias"]


def test_wd_mask_matches_jax(micro):
    """The JAX mask, a bool per leaf, carried through ``params_from_jax``'s key map."""
    _, params, cfg, _, _ = micro
    jmask = joptim.wd_mask(params)
    filled = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    want = {k: bool(v.flatten()[0]) if v.numel() else False
            for k, v in params_from_jax(filled, cfg).items()}
    got = poptim.wd_mask(_port_model(params, cfg))
    assert got == want
    for name in ("logit_bias", "visual.attn_pool.latent", "visual.conv1.bias",
                 "text_projection.bias"):
        assert got[name] is False, name
    for name in ("visual.attn_pool.kv.weight", "text_projection.weight", "visual.proj"):
        assert got[name] is True, name


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(b, n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    imf = rng.standard_normal((b, d)).astype(np.float32)
    txf = rng.standard_normal((n, d)).astype(np.float32)
    imf /= np.linalg.norm(imf, axis=1, keepdims=True)
    txf /= np.linalg.norm(txf, axis=1, keepdims=True)
    return imf, txf, np.float32(10.0), np.float32(-10.0)


def _grads_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_siglip_loss_matches_jax(with_bias):
    imf, txf, scale, bias = _loss_inputs(8, 8)
    args = [imf, txf, scale] + ([bias] if with_bias else [])
    want, jgrads = jax.value_and_grad(
        lambda *a: jax_siglip_loss(*a[:3], a[3] if with_bias else None),
        argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    t = [torch.tensor(a, requires_grad=True) for a in args]
    got = siglip_loss(t[0], t[1], t[2], t[3] if with_bias else None)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    _grads_close([x.grad for x in t], jgrads)


@pytest.mark.parametrize("b, n, chunk, offset, with_bias", [
    (8, 8, 1024, 0, True),     # one chunk: siglip_loss itself
    (6, 20, 8, 0, True),       # 20 texts in chunks of 8: the last chunk padded in JAX
    (6, 20, 8, 7, True),       # the positives at columns 7..12, across a chunk edge
    (6, 20, 8, 14, False),     # positives running past the last column, no bias
])
def test_siglip_loss_chunked_matches_jax(b, n, chunk, offset, with_bias):
    imf, txf, scale, bias = _loss_inputs(b, n, seed=n + offset)
    args = [imf, txf, scale] + ([bias] if with_bias else [])

    def jfn(*a):
        return jax_siglip_loss_chunked(a[0], a[1], a[2], a[3] if with_bias else None,
                                       diag_offset=offset, chunk_size=chunk)

    want, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    t = [torch.tensor(a, requires_grad=True) for a in args]
    got = siglip_loss_chunked(t[0], t[1], t[2], t[3] if with_bias else None, diag_offset=offset,
                              chunk_size=chunk)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    _grads_close([x.grad for x in t], jgrads)
    if offset == 0 and b == n:
        assert got.item() == pytest.approx(siglip_loss(*map(torch.tensor, args)).item(), rel=1e-6)


# ---------------------------------------------------------------------------
# the slice: train steps
# ---------------------------------------------------------------------------

def _assert_tensors_close(got, want, atol):
    assert set(got) == set(want)
    for key in want:
        a, b = got[key].detach().float().numpy(), want[key].float().numpy()
        assert a.shape == b.shape, key
        assert np.abs(a - b).max() <= atol, (key, np.abs(a - b).max())


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "gradcache"])
def test_siglip_steps_match_jax(micro, accum):
    """One and three fp32 siglip steps against ``make_train_step(loss_type="siglip")``:
    the loss, ``grad_norm``, the logit scale, every parameter and the logit bias."""
    jcfg, params, cfg, images, texts = micro
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), jparams,
                                   jsched.const_lr(LR, WARMUP))
    jstate = jts.create_train_state(jparams, jopt)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, loss_type="siglip", compute_dtype=jnp.float32,
                                        accum_steps=accum))
    jbatch = {"image": jnp.asarray(images), "text": jnp.asarray(texts)}
    model = _port_model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    state = pts.create_train_state(model, opt)
    step = pts.make_train_step(cfg, opt, loss_type="siglip", accum_steps=accum)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        state, m = step(state, batch)
        for key in ("loss", "grad_norm", "logit_scale"):
            assert m[key].item() == pytest.approx(float(jm[key]), rel=1e-5), key
        if i in (0, 2):
            want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
            _assert_tensors_close(state.model.state_dict(), want, atol=2e-2 * LR * (i + 1))
    assert state.model.logit_bias.item() != -10.0
    assert state.model.logit_bias.item() == pytest.approx(float(jstate.params["logit_bias"]),
                                                          abs=2e-2 * LR * 3)


def test_siglip_gradients_reach_the_bias_and_the_map_pool(micro):
    _, params, cfg, images, texts = micro
    model = _port_model(params, cfg)
    out = clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True)
    siglip_loss(out["image_features"], out["text_features"], out["logit_scale"],
                out["logit_bias"]).backward()
    grads = dict(model.named_parameters())
    for name in ("logit_bias", "visual.attn_pool.latent", "visual.attn_pool.mlp.c_proj.weight",
                 "visual.conv1.bias", "text_projection.bias"):
        assert grads[name].grad is not None and float(grads[name].grad.abs().max()) > 0, name


def test_clip_step_refuses_a_logit_bias(micro):
    _, params, cfg, _, _ = micro
    model = _port_model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(), model, psched.const_lr(LR, WARMUP))
    with pytest.raises(NotImplementedError, match="siglip"):
        pts.make_train_step(cfg, opt)


def test_cli_siglip_runs_two_steps(tmp_path):
    """``--siglip`` with synthetic data, on the CPU. The micro config names SigLIP's
    tokenizer, whose vocabulary is not in the repository: synthetic data then takes
    fixed token ids."""
    name = "micro-torch-siglip-cli"
    if name not in oc.list_models():
        oc.add_model_config({**MICRO, "text_cfg": {**MICRO["text_cfg"],
                                                   "hf_tokenizer_name": "timm/ViT-B-16-SigLIP"}},
                            name=name)
    state = main(["--model", name, "--siglip", "--dataset-type", "synthetic",
                  "--train-num-samples", "8", "--batch-size", "4", "--epochs", "1", "--lr", "1e-3",
                  "--warmup", "1", "--precision", "fp32", "--loss-dist-impl", "shift",
                  "--logs", str(tmp_path), "--name", "s", "--device", "cpu",
                  "--log-every-n-steps", "1"])
    assert state.step == 2
    rows = [json.loads(x) for x in (tmp_path / "s" / "results.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(np.isfinite(r["train/loss"]) for r in rows)
    assert state.model.logit_bias.item() != -10.0
