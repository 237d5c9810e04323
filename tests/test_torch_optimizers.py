"""The port's optimizers against the JAX package's ``create_optimizer`` (optax), on
the CPU: nadamw, lion, sgd, lamb, adafactor and muon (adamw has its own tests), each
over 3 steps of seeded gradients with clipping (which bites), the weight-decay
mask, layer-wise lr decay and a trainable mask, on a ViT, a Swin block list and a
NaFlex tower.

The JAX blocks are stacked along a layer axis and the port's are one tensor per
block, so the rules that read a leaf (lamb's one trust ratio per leaf, adafactor's
factored axes, muon's orthogonalization of a stacked per-layer vector as one
layers x width matrix, its pass-through of a rank-4 leaf) run on the JAX leaves
that ``optim.jax_leaves`` rebuilds; ``test_jax_leaves_are_the_jax_tree`` holds those
to the JAX tree's shapes.

The parameters start from seeded normal draws in the JAX tree's shapes.

Tolerances: after 3 steps every parameter is within 1e-3 of its largest change
(plus 1e-7) of JAX's; measured at most ~4e-5 (float32 sums in another order).
Muon's Newton-Schulz runs in bfloat16 in both packages, where one rounding apart
grows through the iteration: 0.15 of the largest change there (measured ~0.13), and
within 1e-3 with the iteration switched to float32 on both sides (measured ~2e-5).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import swin as jswin
from open_clip_tpu.train import optim as joptim

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.checkpoint import load_native, save_native
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.models import swin as pswin
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

TEXT = {"context_length": 16, "width": 64, "heads": 2, "layers": 2, "vocab_size": 300}
# adafactor factors only axes of 128 or more: the ViT's text tower is 128 wide, so its
# token embedding and its stacked MLP kernels (per layer) are factored, and its
# stacked (layers, width) vectors are not
VIT = {"embed_dim": 64, "vision_cfg": {"image_size": 32, "layers": 2, "width": 64,
                                       "patch_size": 16, "head_width": 32},
       "text_cfg": dict(TEXT, width=128)}
SWIN = "swin_micro_patch4_window7_56"
SWIN_MICRO = dict(patch_size=4, embed_dim=24, depths=(2, 2), heads=(3, 3), window=7, mlp_ratio=4.0)
SWIN_CFG = {"embed_dim": 24, "text_cfg": dict(TEXT, width=32, layers=1),
            "vision_cfg": {"image_size": 56, "timm_model_name": SWIN, "timm_model_pretrained": False,
                           "timm_pool": "", "timm_proj": "linear"}}
NAFLEX = {"embed_dim": 32, "custom_text": True,
          "vision_cfg": {"image_size": 32, "timm_model_name": "naflexvit_tiny_patch16_gap",
                         "timm_model_kwargs": {"embed_dim": 64, "depth": 2, "num_heads": 1,
                                               "pos_embed_grid_size": (4, 4)}},
          "text_cfg": TEXT}
CONFIGS = {"vit": VIT, "swin": SWIN_CFG, "naflex": NAFLEX}
LR, CLIP, WD = 1e-2, 1.0, 0.1
LOCK = dict(lock_text=True, lock_text_unlocked_layers=2)


@pytest.fixture(scope="module")
def families():
    for configs in (jswin.SWIN_CONFIGS, pswin.SWIN_CONFIGS):
        configs[SWIN] = SWIN_MICRO
    out = {}
    rng = np.random.default_rng(0)
    for name, d in CONFIGS.items():
        jcfg = JaxCfg.from_dict(json.loads(json.dumps(d)))
        # the JAX tree's shapes (traced, not compiled), filled from the seed
        shapes = jax.eval_shape(lambda k, c=jcfg: jclip.init_clip(k, c), jax.random.PRNGKey(0))
        params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.02).astype(s.dtype),
                              shapes)
        out[name] = (params, oc.CLIPModelCfg.from_dict(json.loads(json.dumps(d))))
    yield out
    for configs in (jswin.SWIN_CONFIGS, pswin.SWIN_CONFIGS):
        configs.pop(SWIN, None)


def _run(params, cfg, name, steps=3, **extra):
    """(port parameters, JAX parameters in the port's names, start, the optimizer, its
    state) after ``steps`` updates of the same seeded gradients."""
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
                          params) for _ in range(steps)]
    kw = dict(opt=name, lr=LR, wd=WD, grad_clip_norm=CLIP, layer_decay=0.8, **extra)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(**kw), params, lambda c: LR, num_layers=2)
    jopt = joptim.apply_trainable_mask(jopt, joptim.trainable_mask(params, **LOCK))
    # jitted whole: JAX's eager ops compile one by one
    jp = params
    js = jax.jit(jopt.init)(jp)
    jupdate = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
        *jopt.update(g, st, p)))
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(**kw), model, lambda c: LR, num_layers=2)
    opt = poptim.apply_trainable_mask(opt, poptim.trainable_mask(model, **LOCK))
    names = [n for n, _ in model.named_parameters()]
    ps = [p.data for _, p in model.named_parameters()]
    state = opt.init(ps)
    for g in grads:
        jp, js = jupdate(g, js, jp)
        by_name = params_from_jax(g, cfg)
        norm = opt.update_(ps, [by_name[n] for n in names], state)
        assert norm.item() > CLIP  # the clip bites
    assert state["count"] == steps
    return (dict(zip(names, ps)), params_from_jax(jax.tree.map(np.asarray, jp), cfg),
            params_from_jax(params, cfg), opt, state)


def _close(got, want, start, rel):
    worst = 0.0
    for k, w in want.items():
        change = (w - start[k]).abs().max().item()
        err = (got[k] - w).abs().max().item()
        assert err <= rel * change + 1e-7, (k, err, change)
        worst = max(worst, err / max(change, 1e-30))
    return worst


CASES = [(n, "vit") for n in ("nadamw", "lion", "sgd", "lamb", "adafactor")] + [
    ("lamb", "swin"), ("adafactor", "swin")]


@pytest.mark.parametrize("name,family", CASES, ids=[f"{n}-{f}" for n, f in CASES])
def test_optimizer_matches_jax(families, name, family):
    got, want, start, opt, state = _run(*families[family], name)
    _close(got, want, start, 1e-3)
    if name == "adafactor":  # factored exactly where optax factors
        factored = {leaf.name for leaf, row in zip(opt.leaves, state["v_row"]) if row.numel() > 1}
        if family == "vit":
            assert {"token_embedding.weight", "transformer.resblocks.*.mlp.c_fc.weight"} <= factored
            assert "transformer.resblocks.*.ln_1.weight" not in factored
        else:
            assert not factored


MUON = [("float32", "vit"), ("float32", "swin"), ("float32", "naflex"), ("bfloat16", "vit")]


@pytest.mark.parametrize("dtype,family", MUON, ids=[f"{d}-{f}" for d, f in MUON])
def test_muon_matches_jax(families, family, dtype, monkeypatch):
    """Muon on stacked per-layer vectors (one L x D matrix), per-layer kernels, the
    patch embedding (2-D in the ViT, rank 4 and passed through in the Swin tower)
    and the NaFlex rank-3 position embedding (per row)."""
    if dtype == "float32":
        proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                         if not k.startswith("__")})
        proxy.bfloat16 = jnp.float32
        monkeypatch.setattr(joptim, "jnp", proxy)
        monkeypatch.setattr(poptim, "MUON_DTYPE", torch.float32)
    got, want, start, *_ = _run(*families[family], "muon", momentum=0.9)
    _close(got, want, start, 1e-3 if dtype == "float32" else 0.15)


def _jax_shapes(params, skip=()):
    leaves = jax.tree_util.tree_leaves_with_path(params)
    return sorted(tuple(v.shape) for path, v in leaves
                  if not any(str(getattr(p, "key", "")) in skip for p in path))


@pytest.mark.parametrize("family", ["vit", "swin", "naflex"])
def test_jax_leaves_are_the_jax_tree(families, family):
    params, cfg = families[family]
    model = CLIPModel(cfg)
    ps = [p for _, p in model.named_parameters()]
    leaves = poptim.jax_leaves(model)
    assert sorted(leaves[0].members + [i for lf in leaves[1:] for i in lf.members]) == list(
        range(len(ps)))
    assert sorted(lf.shape(ps) for lf in leaves) == _jax_shapes(params)
    if family == "swin":
        pe = next(lf for lf in leaves if lf.name == "visual.patch_embed.proj.weight")
        assert pe.shape(ps) == (4, 4, 3, 24)  # rank 4 in JAX, 2-D in the port


def test_optimizer_names_and_inputs():
    model = CLIPModel(oc.CLIPModelCfg.from_dict(VIT))
    model.init_weights(torch.Generator().manual_seed(0))
    for name in ("adam", "sgdx", "timm/adamx"):
        with pytest.raises(ValueError, match="unknown optimizer"):
            poptim.create_optimizer(poptim.OptimizerCfg(opt=name), model, lambda c: LR)
    with pytest.raises(ValueError, match="pass the model"):
        poptim.create_optimizer(poptim.OptimizerCfg(opt="muon"), dict(model.named_parameters()),
                                lambda c: LR)
    for name, same in (("timm/lion", "lion"), ("momentum", "sgd")):
        opt = poptim.create_optimizer(poptim.OptimizerCfg(opt=name), model, lambda c: LR)
        ref = poptim.create_optimizer(poptim.OptimizerCfg(opt=same), model, lambda c: LR)
        ps = [p.detach().clone() for p in model.parameters()]
        qs = [p.detach().clone() for p in model.parameters()]
        grads = [torch.randn_like(p, generator=torch.Generator().manual_seed(i))
                 for i, p in enumerate(ps)]
        opt.update_(ps, grads, opt.init(ps))
        ref.update_(qs, grads, ref.init(qs))
        assert all(torch.equal(a, b) for a, b in zip(ps, qs)), name


@pytest.mark.parametrize("name", ["adafactor", "muon", "sgd"])
def test_optimizer_state_round_trips(families, name, tmp_path):
    """Each optimizer's state (its own statistics) saves and loads bit for bit."""
    _, cfg = families["vit"]
    model = CLIPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    opt = poptim.create_optimizer(poptim.OptimizerCfg(opt=name), model, lambda c: LR)
    state = pts.create_train_state(model, opt)
    grads = [torch.randn_like(p) for p in state.params]
    opt.update_(state.params, grads, state.opt_state)
    save_native(tmp_path / "c.pt", state, epoch=1)
    fresh_model = CLIPModel(cfg)
    fresh = pts.create_train_state(fresh_model, opt)
    assert load_native(tmp_path / "c.pt", like=fresh) == 1
    keys = [k for k, v in state.opt_state.items() if isinstance(v, list)]
    assert keys and fresh.opt_state["count"] == 1
    for k in keys:
        assert all(torch.equal(a, b) for a, b in zip(state.opt_state[k], fresh.opt_state[k])), k
