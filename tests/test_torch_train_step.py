"""The port's train step against the JAX package's ``make_train_step``.

A tiny config (2 layers, width 128, 2 heads of 64, 32-pixel images in 16-pixel
patches, 16-token context) gets its params from the JAX package's ``init_clip``;
``params_from_jax`` carries them into the port, and both take the same steps on
the same batch from a numpy seed, in fp32. Gradients and updated parameters of
the JAX package are carried through ``params_from_jax``'s key map and compared
tensor by tensor.

Tolerances. Loss and ``grad_norm``: 1e-5 relative. Gradients: 2e-6 absolute plus
1e-4 relative (fp32 matmuls summed in other orders, through 2 layers each way).
Updated parameters: Adam's first update is ``g / (|g| + 1e-6)``, so where a
gradient entry is near zero a 1e-8 difference in it becomes a visible difference
in the update; the parameters are compared with an absolute tolerance scaled by
the lr, 2e-2 * lr per step taken, while each step moves an entry by up to ~lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.loss import clip_loss as jax_clip_loss
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.loss import clip_loss
from open_clip_tpu_torch.models.clip import LOGIT_SCALE_MAX, CLIPModel, clip_forward
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts

TINY = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 128, "patch_size": 16, "head_width": 64},
    "text_cfg": {"context_length": 16, "width": 128, "heads": 2, "layers": 2},
}
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
BATCH = 8


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxCfg.from_dict(TINY)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(TINY)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (BATCH, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(BATCH), rng.integers(2, 16, BATCH)] = 49407
    return jcfg, params, cfg, images, texts


def _port_model(params, cfg, dtype=torch.float32):
    model = CLIPModel(cfg, compute_dtype=dtype)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _port_state(params, cfg, dtype=torch.float32, **opt_kw):
    model = _port_model(params, cfg, dtype)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP, **opt_kw),
                                  model, psched.const_lr(LR, WARMUP))
    return pts.create_train_state(model, opt), opt


def _jax_state(params):
    jparams = jax.tree.map(jnp.asarray, params)
    opt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), jparams,
                                  jsched.const_lr(LR, WARMUP))
    return jts.create_train_state(jparams, opt), opt


def _batch(images, texts):
    return {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}


def _assert_tensors_close(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for key in want:
        a, b = got[key].detach().float().numpy(), want[key].float().numpy()
        assert a.shape == b.shape, key
        diff = np.abs(a - b).max()
        assert diff <= atol + rtol * np.abs(b).max(), (key, diff)


def test_gradients_match_jax(setup):
    jcfg, params, cfg, images, texts = setup

    def loss_fn(p):
        out = jclip.clip_forward(p, jcfg, jnp.asarray(images), jnp.asarray(texts), train=True,
                                 compute_dtype=jnp.float32)
        scale = jnp.exp(p["logit_scale"].astype(jnp.float32))
        return jax_clip_loss(out["image_features"], out["text_features"], scale)

    want_loss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    model = _port_model(params, cfg)
    out = clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True)
    loss = clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in model.named_parameters()}
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    _assert_tensors_close(got, want, atol=2e-6, rtol=1e-4)


def test_one_and_three_steps_match_jax(setup):
    jcfg, params, cfg, images, texts = setup
    jstate, jopt = _jax_state(params)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32))
    jbatch = {"image": jnp.asarray(images), "text": jnp.asarray(texts)}
    state, opt = _port_state(params, cfg)
    step = pts.make_train_step(cfg, opt)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        state, m = step(state, _batch(images, texts))
        assert state.step == i + 1 == int(jstate.step)
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        assert m["logit_scale"].item() == pytest.approx(float(jm["logit_scale"]), rel=1e-5)
        if i in (0, 2):
            want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
            _assert_tensors_close(state.model.state_dict(), want, atol=2e-2 * LR * (i + 1))
    assert all(p.grad is None for p in state.model.parameters())


def _one_step(params, cfg, images, texts, dtype=torch.float32, **kw):
    state, opt = _port_state(params, cfg, dtype)
    state, m = pts.make_train_step(cfg, opt, **kw)(state, _batch(images, texts))
    return state, m


def test_accumulation_equals_the_simple_step(setup):
    """GradCache over 2 and 4 microbatches gives the full batch's gradient: the loss
    is the same number, ``grad_norm`` agrees to 1e-5 relative, the parameters to
    the lr-scaled tolerance of the module docstring."""
    _, params, cfg, images, texts = setup
    s1, m1 = _one_step(params, cfg, images, texts)
    for accum in (2, 4):
        s2, m2 = _one_step(params, cfg, images, texts, accum_steps=accum)
        assert m2["loss"].item() == pytest.approx(m1["loss"].item(), rel=1e-6)
        assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(), rel=1e-5)
        _assert_tensors_close(s2.model.state_dict(), s1.model.state_dict(), atol=2e-2 * LR)


def test_accumulation_needs_an_even_split(setup):
    _, params, cfg, images, texts = setup
    with pytest.raises(ValueError, match="microbatches"):
        _one_step(params, cfg, images, texts, accum_steps=3)


def test_remat_equals_no_remat(setup):
    """Recomputing each block in the backward pass repeats the same arithmetic."""
    _, params, cfg, images, texts = setup
    s1, m1 = _one_step(params, cfg, images, texts)
    s2, m2 = _one_step(params, cfg, images, texts, remat=True)
    assert m1["loss"].item() == m2["loss"].item()
    assert m1["grad_norm"].item() == m2["grad_norm"].item()
    for (k, a), b in zip(s1.model.state_dict().items(), s2.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_amp_bf16_step_is_close_to_fp32(setup):
    """bf16 compute with fp32 master weights: the loss within 2e-2 (features carry
    2**-8 relative error into logits scaled by 14.3), ``grad_norm`` within 10 %;
    the weights stay fp32."""
    _, params, cfg, images, texts = setup
    s32, m32 = _one_step(params, cfg, images, texts)
    s16, m16 = _one_step(params, cfg, images, texts, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in s16.model.parameters())
    assert m16["loss"].item() == pytest.approx(m32["loss"].item(), abs=2e-2)
    assert m16["grad_norm"].item() == pytest.approx(m32["grad_norm"].item(), rel=0.1)
    assert all(bool(torch.isfinite(p).all()) for p in s16.model.parameters())


def test_pure_bf16_step_keeps_bf16_weights(setup):
    """pure_bf16: the linear maps' weights, their gradients and their moments are
    bf16; norms, embeddings and the logit scale stay fp32."""
    from open_clip_tpu_torch.convert import convert_params_dtype_

    _, params, cfg, images, texts = setup
    model = convert_params_dtype_(_port_model(params, cfg, torch.bfloat16), torch.bfloat16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    state = pts.create_train_state(model, opt)
    state, m = pts.make_train_step(cfg, opt)(state, _batch(images, texts))
    assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"]))
    after = state.model.state_dict()
    assert after["visual.transformer.resblocks.0.mlp.c_fc.weight"].dtype == torch.bfloat16
    assert after["visual.ln_pre.weight"].dtype == torch.float32
    assert [t.dtype for t in state.opt_state["mu"]] == [p.dtype for p in state.params]
    assert all(bool(torch.isfinite(v).all()) for v in after.values())
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert len(moved) > len(before) // 2


def test_fused_ln_switch_gives_the_same_step(setup, monkeypatch):
    from open_clip_tpu_torch.ops import layers

    _, params, cfg, images, texts = setup
    s1, m1 = _one_step(params, cfg, images, texts)
    monkeypatch.setattr(layers, "FUSED_LN_BWD", True)
    s2, m2 = _one_step(params, cfg, images, texts)
    assert m1["loss"].item() == m2["loss"].item()
    assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(), rel=1e-5)
    _assert_tensors_close(s2.model.state_dict(), s1.model.state_dict(), atol=2e-2 * LR)


def test_loss_decreases_on_a_fixed_batch(setup):
    _, params, cfg, images, texts = setup
    state, opt = _port_state(params, cfg)
    step = pts.make_train_step(cfg, opt)
    losses = []
    for _ in range(8):
        state, m = step(state, _batch(images, texts))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0], losses
    assert state.step == 8 and state.opt_state["count"] == 8
    assert state.model.logit_scale.item() <= LOGIT_SCALE_MAX + 1e-6


def test_logit_scale_is_clamped_after_the_step(setup):
    _, params, cfg, images, texts = setup
    state, opt = _port_state(params, cfg)
    with torch.no_grad():
        state.model.logit_scale.fill_(LOGIT_SCALE_MAX + 0.5)
    state, m = pts.make_train_step(cfg, opt)(state, _batch(images, texts))
    assert state.model.logit_scale.item() == pytest.approx(LOGIT_SCALE_MAX)
    assert m["logit_scale"].item() == pytest.approx(100.0, rel=1e-5)


def test_eval_forward_matches_clip_forward(setup):
    _, params, cfg, images, texts = setup
    model = _port_model(params, cfg)
    out = pts.eval_forward(model, _batch(images, texts))
    assert not out["image_features"].requires_grad
    with torch.no_grad():
        want = clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts))
    assert all(torch.equal(out[k], want[k]) for k in want)


@pytest.mark.parametrize("kw", [{"loss_type": "genlap"}, {"loss_type": "coca"},
                                {"loss_type": "distill"}, {"loss_type": "genlip"},
                                {"ema_decay": 0.999, "mesh": "a mesh"}, {"freeze_bn_stats": True}])
def test_unported_step_options_raise(setup, kw):
    _, params, cfg, _, _ = setup
    _, opt = _port_state(params, cfg)
    with pytest.raises(NotImplementedError):
        pts.make_train_step(cfg, opt, **kw)


def test_naflex_loss_scale_leaves_an_image_tensor_batch_alone(setup):
    """The scale applies to patch-dict batches only, as in the JAX step."""
    _, params, cfg, images, texts = setup
    _, m1 = _one_step(params, cfg, images, texts)
    _, m2 = _one_step(params, cfg, images, texts, naflex_loss_scale="linear", reference_batch_size=64)
    assert m1["loss"].item() == m2["loss"].item()
    assert m1["grad_norm"].item() == m2["grad_norm"].item()


def test_patch_dropout_in_training_raises(setup):
    _, params, _, images, texts = setup
    cfg = oc.CLIPModelCfg.from_dict({**TINY, "vision_cfg": {**TINY["vision_cfg"],
                                                              "patch_dropout": 0.5}})
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    with torch.no_grad():
        clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts))  # serving: fine
    # patch dropout is ported: training draws its noise from a generator, and refuses
    # to run without one
    with pytest.raises(ValueError, match="torch.Generator"):
        clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True)
    out = clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True,
                       generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(out["image_features"]).all())


# ViT-L-14's token count at a tiny width: a 64-pixel image in 4-pixel patches is a
# 16 x 16 grid plus the class token, 257 tokens, the length the short-attention
# kernels serve with their two-pass forward and two-kernel backward on the card
TINY_257 = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 64, "layers": 2, "width": 64, "patch_size": 4, "head_width": 32},
    "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2},
}


@pytest.fixture(scope="module")
def setup_257():
    jcfg = JaxCfg.from_dict(TINY_257)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(1), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(TINY_257)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((BATCH, 64, 64, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (BATCH, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(BATCH), rng.integers(2, 16, BATCH)] = 49407
    return jcfg, params, cfg, images, texts


def test_257_token_tower_gradients_match_jax(setup_257):
    """Loss and every gradient at 257 image tokens, fp32, tolerances as above."""
    jcfg, params, cfg, images, texts = setup_257
    assert (64 // 4) ** 2 + 1 == 257

    def loss_fn(p):
        out = jclip.clip_forward(p, jcfg, jnp.asarray(images), jnp.asarray(texts), train=True,
                                 compute_dtype=jnp.float32)
        return jax_clip_loss(out["image_features"], out["text_features"],
                             jnp.exp(p["logit_scale"].astype(jnp.float32)))

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    model = _port_model(params, cfg)
    out = clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True)
    loss = clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in model.named_parameters()}
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    _assert_tensors_close(got, want, atol=2e-6, rtol=1e-4)


def test_257_token_tower_step_matches_jax(setup_257):
    """One step of each train step at 257 image tokens: loss, grad_norm and the
    updated parameters, at the tolerances of the module docstring."""
    jcfg, params, cfg, images, texts = setup_257
    jstate, jopt = _jax_state(params)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32))
    jstate, jm = jstep(jstate, {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                       jax.random.PRNGKey(0))
    state, opt = _port_state(params, cfg)
    state, m = pts.make_train_step(cfg, opt)(state, _batch(images, texts))
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    _assert_tensors_close(state.model.state_dict(), want, atol=2e-2 * LR)
