"""The port's ConvNeXt tower against the JAX package's ``apply_convnext``, on the CPU.

A micro ConvNeXt (64-pixel images: a 16x16 map after the stem, then 8x8, 4x4, 2x2;
depths 2, 2, 3, 2 and widths 16, 24, 32, 48), registered as ``convnext_micro`` in both
packages' ``CONVNEXT_CFGS``, with a linear projection, and again with the MLP one
and a projection bias, gets its params from the JAX package's ``init_clip``;
``params_from_jax`` carries them into the port. The block layer scale ``gamma`` is set
to 0.5 (the init's 1e-6 would hide the blocks). Inputs from a numpy seed.

Tolerances. fp32 towers: rtol 1e-4, atol 1e-5; bf16: cosine >= 0.999 against JAX's
bf16. Gradients: 2e-6 absolute plus 1e-4 relative. Steps (fp32, AdamW, clip 1.0, drop
path 0): loss and grad_norm 1e-5 relative, the parameters 2e-2 * lr
(``tests/test_torch_train_step.py``'s reasons). Masks: exact; layer-decay scales 1
ulp. Drop path: the masks come from other generators in the two packages, so the
keep rate (binomial, 5 sigma) and the 1 / keep scale (against the JAX block at keep
1) are held apart, as ``tests/test_convnext.py`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg, parse_model_cfg as jax_parse_model_cfg
from open_clip_tpu.loss import clip_loss as jax_clip_loss
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import convnext as jcnx
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import checkpoint as pckpt
from open_clip_tpu_torch import factory
from open_clip_tpu_torch.convert import params_from_jax, torch_clip_to_params
from open_clip_tpu_torch.models import convnext as pcnx
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

MICRO_NAME = "convnext_micro"
MICRO_ARCH = ((2, 2, 3, 2), (16, 24, 32, 48))
TEXT = {"context_length": 16, "width": 64, "heads": 2, "layers": 2}
VISION = {"image_size": 64, "timm_model_name": MICRO_NAME, "timm_model_pretrained": False,
          "timm_pool": "", "timm_drop_path": 0.0}
CFGS = {"linear": {"embed_dim": 32, "text_cfg": TEXT, "vision_cfg": {**VISION, "timm_proj": "linear"}},
        "mlp": {"embed_dim": 32, "text_cfg": TEXT,
                "vision_cfg": {**VISION, "timm_proj": "mlp", "timm_proj_bias": True}}}
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
B = 6
CONVNEXT_CONFIGS = ["convnext_base", "convnext_base_w", "convnext_base_w_320", "convnext_large",
                    "convnext_large_d", "convnext_large_d_320", "convnext_small", "convnext_tiny",
                    "convnext_xlarge", "convnext_xxlarge", "convnext_xxlarge_320"]


@pytest.fixture(scope="module", autouse=True)
def registered():
    for configs in (jcnx.CONVNEXT_CFGS, pcnx.CONVNEXT_CFGS):
        configs[MICRO_NAME] = MICRO_ARCH
    yield
    for configs in (jcnx.CONVNEXT_CFGS, pcnx.CONVNEXT_CFGS):
        configs.pop(MICRO_NAME, None)


def _setup(proj):
    jcfg = JaxCfg.from_dict(CFGS[proj])
    params = jax.tree.map(np.array, jax.jit(lambda k: jclip.init_clip(k, jcfg))(
        jax.random.PRNGKey(0)))
    for stage in params["visual"]["stages"].values():
        stage["blocks"]["gamma"][:] = 0.5
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (B, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(B), rng.integers(2, 16, B)] = 49407
    return jcfg, params, oc.CLIPModelCfg.from_dict(CFGS[proj]), images, texts


@pytest.fixture(scope="module")
def linear(registered):
    return _setup("linear")


@pytest.fixture(scope="module")
def mlp(registered):
    return _setup("mlp")


def _model(params, cfg, dtype=torch.float32):
    model = CLIPModel(cfg, compute_dtype=dtype)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_tower_matches_apply_convnext(request, proj):
    jcfg, params, cfg, images, _ = request.getfixturevalue(proj)
    jp = jax.tree.map(jnp.asarray, params["visual"])
    model = _model(params, cfg)
    want = jcnx.apply_convnext(jp, jcfg.vision_cfg, jnp.asarray(images))
    with torch.no_grad():
        got = model.visual(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    want16 = jcnx.apply_convnext(jp, jcfg.vision_cfg, jnp.asarray(images),
                                 compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got16 = _model(params, cfg, torch.bfloat16).visual(torch.from_numpy(images),
                                                           torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert _cos(got16.float().numpy(), np.asarray(want16, np.float32)) >= 0.999


def test_clip_features_and_logits_match_jax(linear):
    jcfg, params, cfg, images, texts = linear
    jp = jax.tree.map(jnp.asarray, params)
    fi = jclip.encode_image(jp, jcfg, jnp.asarray(images), normalize=True)
    ft = jclip.encode_text(jp, jcfg, jnp.asarray(texts), normalize=True)
    logits = jnp.exp(jp["logit_scale"]) * fi @ ft.T
    model = _model(params, cfg)
    with torch.no_grad():
        gi = model.encode_image(torch.from_numpy(images), normalize=True)
        gt = model.encode_text(torch.from_numpy(texts), normalize=True)
        lpi, _ = model.get_logits(torch.from_numpy(images), torch.from_numpy(texts))
    np.testing.assert_allclose(gi.numpy(), np.asarray(fi), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(ft), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lpi.numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_jax(linear, remat):
    """Every gradient of the contrastive loss; full remat recomputes each block and
    gives the same numbers."""
    jcfg, params, cfg, images, texts = linear

    def loss_fn(p):
        out = jclip.clip_forward(p, jcfg, jnp.asarray(images), jnp.asarray(texts), train=True,
                                 compute_dtype=jnp.float32)
        return jax_clip_loss(out["image_features"], out["text_features"],
                             jnp.exp(p["logit_scale"]))

    want_loss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    model = _model(params, cfg)
    out = oc.clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True,
                          remat=remat)
    loss = oc.clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    for key, p in model.named_parameters():
        a, b = p.grad.numpy(), want[key].numpy()
        assert np.abs(a - b).max() <= 2e-6 + 1e-4 * np.abs(b).max(), key


def test_one_step_matches_jax(mlp):
    """One AdamW step at drop path 0 (the masks' generators differ)."""
    jcfg, params, cfg, images, texts = mlp
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP),
                                   jparams, jsched.const_lr(LR, WARMUP))
    jstate = jts.create_train_state(jparams, jopt)
    jstate, jm = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32))(
        jstate, {"image": jnp.asarray(images), "text": jnp.asarray(texts)}, jax.random.PRNGKey(0))
    model = _model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    state, m = pts.make_train_step(cfg, opt)(
        pts.create_train_state(model, opt),
        {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)})
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    for key, v in state.model.state_dict().items():
        assert np.abs(v.numpy() - want[key].numpy()).max() <= 2e-2 * LR, key


def _block(params, cfg, stage=1, j=1):
    model = _model(params, cfg)
    jblk = jax.tree.map(lambda a: jnp.asarray(a[j]), params["visual"]["stages"][str(stage)]["blocks"])
    return model.visual.stages[stage].blocks[j], jblk


def test_drop_path_scales_the_kept_samples_by_one_over_keep(linear):
    """Kept samples: x + (block(x) - x) / keep, the JAX block's branch at keep 1 over
    keep; dropped ones: x."""
    _, params, cfg, _, _ = linear
    blk, jblk = _block(params, cfg)
    x = np.random.default_rng(5).standard_normal((4, 8, 8, 24)).astype(np.float32)
    branch = np.asarray(jcnx._block(jblk, jnp.asarray(x))) - x
    keep = torch.tensor([True, False, True, False]).view(4, 1, 1, 1)
    with torch.no_grad():
        got = blk(torch.from_numpy(x), keep, 0.75).numpy()
    np.testing.assert_allclose(got[[0, 2]], x[[0, 2]] + branch[[0, 2]] / np.float32(0.75),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[[1, 3]], x[[1, 3]])


def test_drop_path_keep_rates_follow_the_linear_schedule(linear):
    """The keep masks each block draws in training: rates spaced linearly from 0 over
    all blocks (JAX's ``np.linspace``), each drawn at its keep rate; none in
    evaluation, and a fixed generator draws the same ones again."""
    _, params, cfg, _, _ = linear
    vcfg = dataclasses.replace(cfg.vision_cfg, timm_drop_path=0.6)
    tower = pcnx.ConvNeXt(vcfg, cfg.embed_dim)
    tower.load_state_dict({k[len("visual."):]: v for k, v in params_from_jax(params, cfg).items()
                           if k.startswith("visual.")})
    want = [float(np.float32(1.0 - r)) for r in np.linspace(0.0, 0.6, 9)]
    assert tower.keep_probs == want
    draws = []
    forward = pcnx.Block.forward

    def record(self, x, keep=None, keep_prob=1.0):
        draws.append((keep_prob, None if keep is None else keep.flatten().clone()))
        return forward(self, x, keep, keep_prob)

    n = 2000
    images = torch.from_numpy(np.random.default_rng(6).standard_normal((n, 32, 32, 3)).astype(
        np.float32))
    pcnx.Block.forward = record
    try:
        with torch.no_grad():
            tower(images, train=True, generator=torch.Generator().manual_seed(0))
            first = [d[1] for d in draws]
            draws.clear()
            tower(images, train=True, generator=torch.Generator().manual_seed(0))
            assert all((a is None and b is None) or torch.equal(a, b)
                       for a, (_, b) in zip(first, draws))
            draws.clear()
            tower(images)
            assert all(keep is None for _, keep in draws)
    finally:
        pcnx.Block.forward = forward
    assert [p for p, _ in zip(want, first)] == want and first[0] is None
    for p, keep in zip(want[1:], first[1:]):
        rate = keep.float().mean().item()
        assert abs(rate - p) <= 5 * (p * (1 - p) / n) ** 0.5, (p, rate)


def test_remat_gives_the_same_loss_with_the_same_masks(linear):
    """Drop path 0.5 in training: with one generator seed, full remat and no remat
    give the same loss and gradients (the masks are drawn before each block)."""
    _, params, cfg, images, texts = linear
    vcfg = dataclasses.replace(cfg.vision_cfg, timm_drop_path=0.5)
    cfg = dataclasses.replace(cfg, vision_cfg=vcfg)
    results = []
    for remat in (False, True):
        model = _model(params, cfg)
        out = oc.clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts),
                              train=True, remat=remat, generator=torch.Generator().manual_seed(3))
        loss = oc.clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
        loss.backward()
        results.append((loss.item(), {k: p.grad for k, p in model.named_parameters()}))
    assert results[0][0] == results[1][0]
    for key, g in results[0][1].items():
        assert torch.allclose(g, results[1][1][key], rtol=1e-5, atol=1e-7), key


def _masks_as_port(values, params, cfg):
    full = jax.tree.map(lambda v, p: np.broadcast_to(np.asarray(v, np.float32), p.shape).copy(),
                        values, params)
    return params_from_jax(full, cfg)


@pytest.mark.parametrize("which", ["wd", "layer_decay", "lock0", "lock1", "lock2", "lock3"])
def test_masks_match_jax(mlp, which):
    """The weight-decay mask (each stage's stacked blocks count their own dimensions),
    the layer-decay scales (the ladder restarts in each stage; ``proj`` a kernel, so
    not at 1) and the lock masks (``unlocked_groups`` > 1 unlocks the last blocks of
    every stage; ``head_norm`` and ``proj_mlp`` are not heads), tensor by tensor."""
    _, params, cfg, _, _ = mlp
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
        assert got["visual.stages.2.blocks.1.fc1.weight"] and got["visual.stem.conv.weight"]
        assert not got["visual.stages.2.blocks.1.gamma"]
    if which == "layer_decay":
        assert got["visual.stages.2.blocks.0.fc1.weight"] == pytest.approx(0.75 ** 3)
        assert got["visual.stages.3.blocks.1.fc1.weight"] == pytest.approx(0.75)
    if which == "lock2":
        assert got["visual.stages.0.blocks.1.dwconv.weight"] == 1.0
        assert got["visual.stages.0.blocks.0.dwconv.weight"] == 0.0
        assert got["visual.proj_mlp.fc1.weight"] == 0.0 and got["visual.head_norm.weight"] == 0.0


def test_lamb_reads_the_stacked_stage_leaves(mlp):
    """lamb's trust ratio is one a JAX leaf: each stage's blocks stack into one."""
    _, params, cfg, _, _ = mlp
    leaves = poptim.jax_leaves(CLIPModel(cfg))
    model = CLIPModel(cfg)
    by_name = {leaf.name: leaf for leaf in leaves}
    leaf = by_name["visual.stages.2.blocks.*.dwconv.weight"]
    assert leaf.layers == 3
    tensors = [p for _, p in model.named_parameters()]
    assert tuple(leaf.gather(tensors).shape) == params["visual"]["stages"]["2"]["blocks"][
        "dwconv"]["kernel"].shape


def _reference_sd(params, proj):
    """A timm ConvNeXt CLIP checkpoint (``visual.trunk.*``, ``visual.head.*``) written
    from the JAX tree, the text tower through the port's names."""
    vis = params["visual"]
    sd = {}

    def conv(prefix, node):
        sd[prefix + ".weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        sd[prefix + ".bias"] = np.asarray(node["bias"])

    def ln(prefix, node):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = node["scale"], node["bias"]

    def lin(prefix, node):
        sd[prefix + ".weight"] = np.asarray(node["kernel"]).T
        if "bias" in node:
            sd[prefix + ".bias"] = node["bias"]

    conv("visual.trunk.stem.0", vis["stem"]["conv"])
    ln("visual.trunk.stem.1", vis["stem"]["norm"])
    for i, stage in vis["stages"].items():
        if "downsample" in stage:
            ln(f"visual.trunk.stages.{i}.downsample.0", stage["downsample"]["norm"])
            conv(f"visual.trunk.stages.{i}.downsample.1", stage["downsample"]["conv"])
        blocks = stage["blocks"]
        for j in range(blocks["gamma"].shape[0]):
            b = f"visual.trunk.stages.{i}.blocks.{j}"
            row = jax.tree.map(lambda a: a[j], blocks)
            conv(f"{b}.conv_dw", row["dwconv"])
            ln(f"{b}.norm", row["norm"])
            lin(f"{b}.mlp.fc1", row["fc1"])
            lin(f"{b}.mlp.fc2", row["fc2"])
            sd[f"{b}.gamma"] = row["gamma"]
    ln("visual.trunk.head.norm", vis["head_norm"])
    if proj == "linear":
        lin("visual.head.proj", vis["proj"])
    else:
        lin("visual.head.mlp.fc1", vis["proj_mlp"]["fc1"])
        lin("visual.head.mlp.fc2", vis["proj_mlp"]["fc2"])
    model = _model(params, oc.CLIPModelCfg.from_dict(CFGS[proj]))
    sd.update({k: v.numpy() for k, v in model.state_dict().items() if not k.startswith("visual.")})
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_reference_converter_matches_jax(request, proj):
    jcfg, params, cfg, _, _ = request.getfixturevalue(proj)
    sd = _reference_sd(params, proj)
    want = jax.tree.map(np.asarray, jcnx.torch_convnext_clip_to_params(sd, jcfg.vision_cfg))
    tree = torch_clip_to_params({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    got = tree["visual"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    model = CLIPModel(cfg)
    pckpt.merge_params_(model, pckpt.checkpoint_to_params(sd, cfg))
    ref = _model(params, cfg).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("name", CONVNEXT_CONFIGS)
def test_registry_configs_build_with_the_jax_parameter_count(name):
    raw = factory.get_model_config(name)
    with torch.device("meta"):
        model = factory.model_from_config(raw)
    jcfg = jax_parse_model_cfg(name)
    want = jax.eval_shape(lambda k: jclip.init_clip(k, jcfg), jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(want))
    assert isinstance(model.visual, pcnx.ConvNeXt)


def test_train_step_draws_drop_path_from_its_seed(linear):
    """The step seeds the drop-path generator from (seed, step): two states from the
    same weights take the same first step; the config's rate is used."""
    _, params, cfg, images, texts = linear
    vcfg = dataclasses.replace(cfg.vision_cfg, timm_drop_path=0.5)
    cfg = dataclasses.replace(cfg, vision_cfg=vcfg)
    losses = []
    for seed in (0, 0, 1):
        model = _model(params, cfg)
        opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR), model, psched.const_lr(LR, 0))
        _, m = pts.make_train_step(cfg, opt, preprocess_seed=seed)(
            pts.create_train_state(model, opt),
            {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)})
        losses.append(m["loss"].item())
    assert losses[0] == losses[1] != losses[2]


def test_registry_tags_raise_naming_their_file():
    with pytest.raises(NotImplementedError, match="laion2b_s13b_b82k"):
        oc.create_model("convnext_base_w", pretrained="laion2b_s13b_b82k", device="cpu")


def test_cli_trains_with_drop_path_and_remat(tmp_path):
    """The CLI on the micro ConvNeXt at drop path 0.1, under full remat
    (``--grad-checkpointing``), with the image tower locked but for its last block
    of each stage and ``proj``."""
    from open_clip_tpu_torch.train.main import main

    raw = {**CFGS["linear"], "vision_cfg": {**CFGS["linear"]["vision_cfg"], "timm_drop_path": 0.1}}
    oc.add_model_config(raw, name="micro-torch-convnext")
    start = oc.create_model("micro-torch-convnext", device="cpu", seed=0).state_dict()
    state = main(["--model", "micro-torch-convnext", "--dataset-type", "synthetic",
                  "--train-num-samples", "16", "--batch-size", "8", "--epochs", "1",
                  "--device", "cpu", "--lr", "1e-3", "--grad-checkpointing", "--lock-image",
                  "--lock-image-unlocked-groups", "2", "--logs", str(tmp_path), "--name", "cnx"])
    assert state.step == 2
    end = state.model.state_dict()
    assert not torch.equal(end["visual.stages.2.blocks.2.fc1.weight"],
                           start["visual.stages.2.blocks.2.fc1.weight"])
    assert not torch.equal(end["visual.proj.weight"], start["visual.proj.weight"])
    for key in ("visual.stages.2.blocks.1.fc1.weight", "visual.stem.conv.weight",
                "visual.head_norm.weight"):
        assert torch.equal(end[key], start[key]), key
