"""The port's loss, schedules and optimizer against the JAX package (optax).

Inputs come from a numpy seed and go through both. Tolerances: the loss and its
feature gradients in fp32 <= 1e-6 (log-softmax over 8 logits in other orders);
schedules <= 1e-6 relative to the value or to the base lr (the JAX schedules
compute in fp32, the port's in Python floats); optimizer steps: see ``test_adamw_matches_the_optax_chain``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu import loss as jloss
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.loss import clip_loss
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched

TINY = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 128, "patch_size": 16, "head_width": 64},
    "text_cfg": {"context_length": 16, "width": 128, "heads": 2, "layers": 2},
}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_loss_value_and_gradients_match_jax(dtype):
    rng = np.random.default_rng(0)
    imf, txf = _unit(rng, 8, 32), _unit(rng, 8, 32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    scale = np.float32(14.3)
    want, (gi, gt, gs) = jax.value_and_grad(jloss.clip_loss, argnums=(0, 1, 2))(
        jnp.asarray(imf, jdt), jnp.asarray(txf, jdt), jnp.asarray(scale))
    ti = torch.from_numpy(imf).to(tdt).requires_grad_()
    tt = torch.from_numpy(txf).to(tdt).requires_grad_()
    ts = torch.tensor(scale, requires_grad=True)
    got = clip_loss(ti, tt, ts)
    got.backward()
    # bf16 features: the loss is computed in fp32 from the same bf16 values; the
    # feature gradients are rounded to bf16 once (2**-8 of values up to ~1)
    tol = 1e-6 if dtype == "float32" else 4e-3
    assert abs(got.item() - float(want)) <= 1e-5
    assert np.abs(ti.grad.float().numpy() - np.asarray(gi, np.float32)).max() <= tol
    assert np.abs(tt.grad.float().numpy() - np.asarray(gt, np.float32)).max() <= tol
    assert abs(ts.grad.item() - float(gs)) <= 1e-6


def test_clip_loss_across_processes_is_not_ported():
    """The gathered loss is ported (``tests/test_torch_parallel.py`` holds it against
    the JAX package); without a process group it raises rather than compute the
    one-process loss."""
    x = torch.eye(4)
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        clip_loss(x, x, torch.tensor(1.0), world_size=2)


STEPS = [0, 1, 4, 5, 6, 50, 99, 100, 101, 150]


@pytest.mark.parametrize("name,kw", [
    ("const", {}),
    ("cosine", {}),
    ("const-cooldown", {"cooldown_steps": 30, "cooldown_power": 2.0, "cooldown_end_lr": 1e-5}),
    ("const-cooldown", {"cooldown_steps": 0}),
])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedules_match_jax(name, kw, warmup):
    """Steps 0, the warm-up edge (warmup - 1, warmup, warmup + 1), the cool-down's
    start, the last step and past it."""
    ours = psched.create_scheduler(name, 5e-4, warmup, 100, **kw)
    theirs = jsched.create_scheduler(name, 5e-4, warmup, 100, **kw)
    for step in STEPS + [69, 70, 71]:
        want = float(theirs(step))
        # abs: 1e-6 of the base lr (the fp32 cosine near pi loses relative precision)
        assert ours(step) == pytest.approx(want, rel=1e-6, abs=5e-10), step


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        psched.create_scheduler("linear", 1e-3, 0, 10)


@pytest.fixture(scope="module")
def tiny_params():
    jcfg = JaxCfg.from_dict(TINY)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(TINY)
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return jcfg, params, cfg, model


def test_wd_mask_matches_jax_leaf_for_leaf(tiny_params):
    """The JAX mask, a bool per leaf, is carried through ``params_from_jax``'s key
    map as arrays of the leaf's shape filled with it."""
    _, params, cfg, model = tiny_params
    jmask = joptim.wd_mask(params)
    filled = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    want = {k: bool(v.flatten()[0]) for k, v in params_from_jax(filled, cfg).items()}
    got = poptim.wd_mask(model)
    assert got == want
    assert sum(got.values()) > 0 and not all(got.values())
    for name in ("positional_embedding", "visual.class_embedding", "logit_scale",
                 "visual.ln_pre.weight", "transformer.resblocks.0.attn.in_proj_bias"):
        assert got[name] is False, name
    for name in ("visual.proj", "text_projection", "token_embedding.weight",
                 "visual.transformer.resblocks.1.mlp.c_fc.weight"):
        assert got[name] is True, name


def test_wd_mask_extra_names_and_patterns():
    params = {"a.weight": torch.zeros(2, 2), "b.proj": torch.zeros(2, 2), "c.w": torch.zeros(2, 2)}
    assert poptim.wd_mask(params, extra_names=("proj",), patterns=("c.*",)) == {
        "a.weight": True, "b.proj": False, "c.w": False}


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"], ids=["mu_fp32", "mu_bf16"])
@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip1"])
def test_adamw_matches_the_optax_chain(clip, mu_dtype):
    """Three steps on given gradients. The first gradient's global norm (0.5) is
    below the clip limit, the second (4.0) above it, the third on neither side
    of anything special. lr is 1e-2 with a 2-step warm-up and wd 0.2.

    Adam's update is g / (|g| + eps) on its first step, so an entry of the
    gradient near zero turns a rounding difference into a visible one: the
    parameters are compared with an absolute tolerance scaled by the lr,
    1e-5 * lr per step taken (each step moves an entry by at most ~lr), and with
    a bf16 first moment 1e-2 * lr (2**-8 of an update of size <= lr)."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "b": (5,), "positional_embedding": (3, 5), "logit_scale": ()}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for norm in (0.5, 4.0, 1.5):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        total = np.sqrt(sum((v ** 2).sum() for v in g.values()))
        grads.append({k: (v * norm / total).astype(np.float32) for k, v in g.items()})
    lr, warm = 1e-2, 2

    jcfg = joptim.OptimizerCfg(lr=lr, wd=0.2, grad_clip_norm=clip, mu_dtype=mu_dtype)
    jparams = jax.tree.map(jnp.asarray, p0)
    jopt = joptim.create_optimizer(jcfg, jparams, jsched.const_lr(lr, warm))
    jstate = jopt.init(jparams)

    pcfg = poptim.OptimizerCfg(lr=lr, wd=0.2, grad_clip_norm=clip, mu_dtype=mu_dtype)
    tparams = {k: torch.tensor(v) for k, v in p0.items()}
    popt = poptim.create_optimizer(pcfg, tparams, psched.const_lr(lr, warm))
    assert popt.decay == [True, False, False, False]
    pstate = popt.init(list(tparams.values()))

    import optax

    for i, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = popt.update_(list(tparams.values()), [torch.as_tensor(g[k]) for k in shapes], pstate)
        assert norm.item() == pytest.approx((0.5, 4.0, 1.5)[i], rel=1e-5)
        tol = (1e-5 if mu_dtype is None else 1e-2) * lr * (i + 1)
        for k in shapes:
            diff = np.abs(tparams[k].numpy() - np.asarray(jparams[k])).max()
            assert diff <= tol, (i, k, diff)
    assert pstate["count"] == 3
    assert pstate["mu"][0].dtype == (torch.float32 if mu_dtype is None else torch.bfloat16)


def test_clip_leaves_a_small_gradient_untouched_and_scales_a_large_one():
    cfg = poptim.OptimizerCfg(lr=1.0, wd=0.0, grad_clip_norm=1.0, beta1=0.0, beta2=0.0, eps=1.0)
    # with b1 = b2 = 0 and eps = 1 the update is -lr * g / (|g| + 1): it shows g as clipped
    for scale, want in ((0.5, 0.5), (4.0, 1.0)):
        p = [torch.zeros(1)]
        opt = poptim.create_optimizer(cfg, {"w": p[0]}, lambda step: 1.0)
        norm = opt.update_(p, [torch.tensor([scale])], opt.init(p))
        assert norm.item() == scale  # the norm before clipping
        assert p[0].item() == pytest.approx(-want / (want + 1.0), rel=1e-6)


@pytest.mark.parametrize("kw", [{"opt": "lion"}, {"opt": "lamb"}, {"opt": "muon"}, {"opt": "sgd"},
                                {"opt": "nadamw"}, {"opt": "adafactor"}, {"opt": "timm/lion"},
                                {"opt": "momentum"}])
def test_unported_optimizer_options_raise(kw):
    with pytest.raises(NotImplementedError):
        poptim.create_optimizer(poptim.OptimizerCfg(**kw), {"w": torch.zeros(2, 2)}, lambda s: 1e-3)


def test_default_params_match_jax():
    for name in ("ViT-B-32", "RN50", "coca_ViT-B-32", "ViT-B-16-SigLIP", ""):
        assert poptim.get_default_params(name) == joptim.get_default_params(name)
