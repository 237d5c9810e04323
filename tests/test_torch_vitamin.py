"""The port's ViTamin tower against the JAX package's ``apply_vitamin``, on the CPU.

A micro ViTamin (64-pixel images: a 32x32 stem map, MBConv stages of one and two
blocks at widths 16 and 32 on 16x16 and 8x8 maps, a 4x4 grid of 16 tokens into two
ViT blocks of width 64 and two heads of 32), registered as ``vitamin_torchmicro`` in
both packages' ``VITAMIN_CFGS``, gets its params from the JAX package's ``init_clip``
(biases and LayerNorm affines made nonzero, which the init's zeros and ones would
hide); ``params_from_jax`` carries them into the port. Its second stage has the
ragged first block (``down``) and a second without. Inputs from a numpy seed.

Tolerances. fp32 features: within 1e-5 relative (the norm of the difference over the
norm); bf16: cosine >= 0.999 against JAX's bf16. Gradients: cosine >= 0.99999 per
tensor (and the loss 1e-5 relative). Steps (fp32, AdamW, clip 1.0): loss and grad_norm
1e-5 relative, the parameters 2e-2 * lr (``tests/test_torch_train_step.py``'s reasons).
The shortcut's pool: 1e-6. Masks: exact; layer-decay scales 1 ulp. Converters: bit for
bit.
"""

import json

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
from open_clip_tpu.models import vitamin as jvit
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import checkpoint as pckpt
from open_clip_tpu_torch import factory
from open_clip_tpu_torch.convert import convert_params_dtype_, params_from_jax, torch_clip_to_params
from open_clip_tpu_torch.models import vitamin as pvit
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

MICRO_NAME = "vitamin_torchmicro"
MICRO_ARCH = dict(conv_dims=(16, 32), conv_depths=(1, 2), embed_dim=64, depth=2, heads=2,
                  image_size=64)
RAW = {"embed_dim": 32, "custom_text": True,
       "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2},
       "vision_cfg": {"image_size": 64, "timm_model_name": f"{MICRO_NAME}_64",
                      "timm_model_pretrained": False, "timm_pool": "", "timm_proj": "linear",
                      "timm_drop": 0.0, "timm_drop_path": 0.1}}
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
B = 6
VITAMIN_REGISTRY = ["ViTamin-B", "ViTamin-B-LTT", "ViTamin-L", "ViTamin-L-256", "ViTamin-L-336",
                    "ViTamin-L-384", "ViTamin-L2", "ViTamin-L2-256", "ViTamin-L2-336",
                    "ViTamin-L2-384", "ViTamin-S", "ViTamin-S-LTT", "ViTamin-XL-256",
                    "ViTamin-XL-336", "ViTamin-XL-384"]


@pytest.fixture(scope="module", autouse=True)
def registered():
    jvit.VITAMIN_CFGS[MICRO_NAME] = jvit.ViTaminCfg(**MICRO_ARCH)
    pvit.VITAMIN_CFGS[MICRO_NAME] = pvit.ViTaminCfg(**MICRO_ARCH)
    yield
    for table in (jvit.VITAMIN_CFGS, pvit.VITAMIN_CFGS):
        table.pop(MICRO_NAME, None)


@pytest.fixture(scope="module")
def setup(registered):
    jcfg = JaxCfg.from_dict(RAW)
    params = jax.tree.map(np.array, jax.jit(lambda k: jclip.init_clip(k, jcfg))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "bias":
            leaf[...] = rng.standard_normal(leaf.shape) * 0.1
        elif name == "scale":
            leaf[...] = 1.0 + rng.standard_normal(leaf.shape) * 0.1
        return leaf

    params["visual"] = jax.tree_util.tree_map_with_path(perturb, params["visual"])
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (B, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(B), rng.integers(2, 16, B)] = 49407
    return jcfg, params, oc.CLIPModelCfg.from_dict(RAW), images, texts


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


def test_tower_matches_apply_vitamin(setup):
    jcfg, params, cfg, images, _ = setup
    jp = jax.tree.map(jnp.asarray, params["visual"])
    want = jvit.apply_vitamin(jp, jcfg.vision_cfg, jnp.asarray(images))
    with torch.no_grad():
        got = _model(params, cfg).visual(torch.from_numpy(images))
    assert _rel(got.numpy(), want) <= 1e-5
    want16 = jvit.apply_vitamin(jp, jcfg.vision_cfg, jnp.asarray(images),
                                compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got16 = _model(params, cfg, torch.bfloat16).visual(torch.from_numpy(images), torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert _cos(got16.float().numpy(), np.asarray(want16, np.float32)) >= 0.999


@pytest.mark.parametrize("hw", [(5, 7), (6, 6), (9, 4)])
def test_shortcut_pool_is_same_padded_and_divided_by_four(hw):
    """The JAX ``reduce_window(..., "SAME") / 4``: an odd edge gets a zero row or
    column and its windows are still divided by 4."""
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1),
                                 "SAME") / 4.0
    np.testing.assert_allclose(pvit._avg_pool_same(torch.from_numpy(x)).numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("stage,j", [(1, 0), (1, 1), (0, 0)], ids=["down", "plain", "widen"])
def test_mbconv_block_on_an_odd_map_matches_jax(setup, stage, j):
    """Each kind of MBConv block (stride 2 with ``down``, stride 1 without) on a 7x9
    map, where the strided depthwise convolution and the shortcut's pool meet an odd
    edge; torch-style k // 2 padding on both sides."""
    _, params, cfg, _, _ = setup
    blk = _model(params, cfg).visual.stages[stage].blocks[j]
    jblk = jax.tree.map(jnp.asarray, params["visual"]["stages"][str(stage)]["blocks"][j])
    cin = blk.pre_norm.weight.shape[0]
    x = np.random.default_rng(3).standard_normal((2, 7, 9, cin)).astype(np.float32)
    want = jvit._mbconv(jblk, jnp.asarray(x), 2 if j == 0 else 1, 1e-6)
    with torch.no_grad():
        got = blk(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


def test_clip_features_and_logits_match_jax(setup):
    jcfg, params, cfg, images, texts = setup
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


def test_train_mode_is_eval_mode(setup):
    """Drop path 0.1 in the config, and the JAX tower ignores it (``del train, rng``):
    in both packages training gives the eval features, bit for bit in the port."""
    jcfg, params, cfg, images, _ = setup
    assert cfg.vision_cfg.timm_drop_path == 0.1
    model = _model(params, cfg)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        train = model.visual(torch.from_numpy(images), train=True, generator=gen)
        evaluate = model.visual(torch.from_numpy(images))
    assert torch.equal(train, evaluate)
    jp = jax.tree.map(jnp.asarray, params["visual"])
    jtrain = jvit.apply_vitamin(jp, jcfg.vision_cfg, jnp.asarray(images), train=True,
                                rng=jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(jtrain), np.asarray(
        jvit.apply_vitamin(jp, jcfg.vision_cfg, jnp.asarray(images))))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_jax(setup, remat):
    """Every gradient of the contrastive loss, without remat and with each ViT block
    recomputed (the JAX ``jax.checkpoint`` of each block)."""
    jcfg, params, cfg, images, texts = setup

    def loss_fn(p):
        out = jclip.clip_forward(p, jcfg, jnp.asarray(images), jnp.asarray(texts), train=True,
                                 compute_dtype=jnp.float32, remat=remat)
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
        assert _cos(p.grad.numpy(), want[key].numpy()) >= 0.99999, key


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "gradcache"])
def test_one_step_matches_jax(setup, accum):
    """One AdamW step with clipping, and the GradCache step over two microbatches."""
    jcfg, params, cfg, images, texts = setup
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP),
                                   jparams, jsched.const_lr(LR, WARMUP))
    jstate, jm = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32,
                                             accum_steps=accum))(
        jts.create_train_state(jparams, jopt),
        {"image": jnp.asarray(images), "text": jnp.asarray(texts)}, jax.random.PRNGKey(0))
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
def test_masks_match_jax(setup, which):
    """The JAX rules' quirks, followed: ``pos_embed`` is decayed; the MBConv blocks are
    a plain list under ``stages/i/blocks``, so the ``blocks`` rules read the first axis
    of every stage leaf (a kernel's kh, a LayerNorm's channels) as a layer axis; ``pool``
    unlocks with the head. Tensor by tensor."""
    _, params, cfg, _, _ = setup
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
        assert got["visual.pos_embed"] and got["visual.stages.1.blocks.0.conv2_kxk.weight"]
        assert not got["visual.stages.1.blocks.0.conv2_kxk.bias"]
    if which == "layer_decay":  # a 3x3 kernel's ladder: 0.75 ** (3 - kh)
        kxk = got["visual.stages.1.blocks.1.conv2_kxk.weight"]
        assert kxk.shape == (1, 1, 3, 1)
        np.testing.assert_allclose(kxk.flatten().numpy(), 0.75 ** np.array([3.0, 2.0, 1.0]),
                                   rtol=1e-6)
    if which == "lock1":
        assert got["visual.pool.conv.weight"] == 1.0 and got["visual.proj.weight"] == 1.0
        assert got["visual.stem.conv1.weight"] == 0.0


def test_lamb_leaves_keep_the_stage_blocks_apart(setup):
    """The ViT blocks stack into one JAX leaf per name; the MBConv list does not."""
    _, params, cfg, _, _ = setup
    model = CLIPModel(cfg)
    by_name = {leaf.name: leaf for leaf in poptim.jax_leaves(model)}
    assert by_name["visual.transformer.resblocks.*.attn.qkv.weight"].layers == 2
    leaf = by_name["visual.stages.1.blocks.0.conv2_kxk.weight"]
    assert leaf.layers == 0
    tensors = [p for _, p in model.named_parameters()]
    assert tuple(leaf.gather(tensors).shape) == params["visual"]["stages"]["1"]["blocks"][0][
        "conv2_kxk"]["kernel"].shape


def test_pure_bf16_partition_matches_jax(setup):
    """The stem, ``pool`` and ViT convolutions and linears go to bf16; norms,
    ``pos_embed`` and the MBConv convolutions stay fp32 (the JAX partition does not
    enter the blocks' list)."""
    _, params, cfg, _, _ = setup
    model = convert_params_dtype_(_model(params, cfg), torch.bfloat16)
    jdt = jconvert.convert_params_dtype(params, jnp.bfloat16)
    want = params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, a.dtype == jnp.bfloat16, np.float32), jdt), cfg)
    for key, p in model.named_parameters():
        assert (p.dtype == torch.bfloat16) == bool(want[key].flatten()[0]), key
    assert model.visual.stages[1].blocks[0].conv2_kxk.weight.dtype == torch.float32
    assert model.visual.pool["conv"].weight.dtype == torch.bfloat16


def _timm_sd(params, mlp_names=("w0", "w1", "w2"), hybrid=False, fc_norm=False):
    """A timm ViTamin CLIP checkpoint (``visual.trunk.*``, ``visual.head.proj``) written
    from the JAX tree, the text tower through the port's names: the MLP under
    ``mlp_names``, the pool as the backbone's ``pool`` or a HybridEmbed projection."""
    vis = params["visual"]
    sd = {}
    bb = "visual.trunk.patch_embed.backbone."

    def conv(prefix, node):
        sd[prefix + ".weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        sd[prefix + ".bias"] = node["bias"]

    def ln(prefix, node):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = node["scale"], node["bias"]

    def lin(prefix, node):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = np.asarray(node["kernel"]).T, node["bias"]

    for name, node in vis["stem"].items():
        (conv if name.startswith("conv") else ln)(bb + "stem." + name, node)
    for i, stage in vis["stages"].items():
        for j, blk in enumerate(stage["blocks"]):
            for name, node in blk.items():
                (ln if name == "pre_norm" else conv)(f"{bb}stages.{i}.blocks.{j}.{name}", node)
    if hybrid:
        ln("visual.trunk.patch_embed.norm", vis["pool"]["norm"])
        conv("visual.trunk.patch_embed.proj", vis["pool"]["conv"])
    else:
        ln(bb + "pool.norm", vis["pool"]["norm"])
        conv(bb + "pool.conv", vis["pool"]["conv"])
    sd["visual.trunk.pos_embed"] = np.asarray(vis["pos_embed"])[None]
    for i in range(2):
        row = jax.tree.map(lambda a: np.asarray(a[i]), vis["blocks"])
        b = f"visual.trunk.blocks.{i}."
        ln(b + "norm1", row["ln_1"])
        lin(b + "attn.qkv", row["attn"]["qkv"])
        lin(b + "attn.proj", row["attn"]["proj"])
        ln(b + "mlp.norm", row["mlp"]["norm"])
        for src, dst in zip(("w0", "w1", "w2"), mlp_names):
            lin(b + "mlp." + dst, row["mlp"][src])
    ln("visual.trunk.norm", vis["norm"])
    if fc_norm:
        ln("visual.trunk.fc_norm", vis["norm"])
    lin("visual.head.proj", vis["proj"])
    model = _model(params, oc.CLIPModelCfg.from_dict(RAW))
    sd.update({k: v.numpy() for k, v in model.state_dict().items() if not k.startswith("visual.")})
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("mlp_names,hybrid", [(("w0", "w1", "w2"), False),
                                              (("fc1_g", "fc1_x", "fc2"), True)],
                         ids=["w012-pool", "glumlp-hybrid"])
def test_reference_converter_matches_jax(setup, mlp_names, hybrid):
    """Both MLP namings and both pool layouts through the port's converter give the
    JAX converter's tree, and a strict load the weights they were written from."""
    jcfg, params, cfg, _, _ = setup
    sd = _timm_sd(params, mlp_names, hybrid)
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
    # the JAX merge_params takes the MBConv list for one leaf and cannot load it
    tree = jconvert.torch_clip_to_params({k: torch.from_numpy(v) for k, v in sd.items()}, jcfg)
    with pytest.raises(ValueError):
        jckpt.merge_params(jax.tree.map(jnp.asarray, params), tree, jcfg)


def test_an_fc_norm_beside_norm_is_unexpected(setup):
    """The converters keep a ``fc_norm`` found beside ``norm``; ``init_vitamin`` makes
    none and neither does the port, so a strict load raises and a lax one drops it."""
    jcfg, params, cfg, _, _ = setup
    sd = _timm_sd(params, fc_norm=True)
    tree = jconvert.torch_clip_to_params({k: torch.from_numpy(v) for k, v in sd.items()}, jcfg)
    assert "fc_norm" in tree["visual"] and "fc_norm" not in params["visual"]
    with pytest.raises(KeyError, match="fc_norm"):
        pckpt.merge_params_(CLIPModel(cfg), pckpt.checkpoint_to_params(sd, cfg))
    model = pckpt.merge_params_(CLIPModel(cfg), pckpt.checkpoint_to_params(sd, cfg), strict=False)
    assert torch.equal(model.visual.norm.weight, torch.from_numpy(params["visual"]["norm"]["scale"]))


def test_a_pos_embed_of_another_size_raises_as_in_jax(setup):
    """``pos_embed`` is not the ViT's ``positional_embedding``: the JAX ``_reconcile``
    resizes only that one and raises for this, and so does the port."""
    jcfg, params, cfg, _, _ = setup
    sd = _timm_sd(params)
    sd["visual.trunk.pos_embed"] = np.zeros((1, 25, 64), np.float32)
    with pytest.raises(ValueError, match="pos_embed"):
        jckpt._reconcile(("visual", "pos_embed"), jnp.zeros((16, 64)), jnp.zeros((25, 64)), jcfg)
    with pytest.raises(ValueError, match="pos_embed"):
        pckpt.merge_params_(CLIPModel(cfg), pckpt.checkpoint_to_params(sd, cfg))


@pytest.mark.parametrize("name", VITAMIN_REGISTRY)
def test_registry_configs_build_with_the_jax_parameter_count(name):
    raw = factory.get_model_config(name)
    with torch.device("meta"):
        model = factory.model_from_config(raw)
    jcfg = jax_parse_model_cfg(name)
    want = jax.eval_shape(lambda k: jclip.init_clip(k, jcfg), jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(want))
    assert isinstance(model.visual, pvit.ViTamin)


def test_registry_tags_raise_naming_their_file():
    with pytest.raises(NotImplementedError, match="datacomp1b"):
        oc.create_model("ViTamin-B", pretrained="datacomp1b", device="cpu")


def test_the_registry_builds_all_but_the_unported_families():
    """153 of the registry's 181 configs build; each of the other 28 raises naming its
    family: FastViT/MobileCLIP 6, the MCi stem 2, relpos 1, an HF text tower 15,
    Whisper 3, audio fusion 1."""
    with open(factory.__file__.rsplit("/", 1)[0] + "/model_configs_data.json") as fh:
        registry = json.load(fh)  # as shipped: tests register configs of their own
    families = {"fastvit_mci": 0, "vit_base_mci": 0, "vit_relpos": 0, "HF text tower": 0,
                "whisper": 0, "fusion": 0}
    built = 0
    for raw in registry.values():
        try:
            with torch.device("meta"):
                factory.model_from_config(raw)
            built += 1
        except NotImplementedError as e:
            hits = [f for f in families if f in str(e)]
            assert len(hits) == 1, str(e)
            families[hits[0]] += 1
    assert (built, len(registry)) == (153, 181)
    assert families == {"fastvit_mci": 6, "vit_base_mci": 2, "vit_relpos": 1,
                        "HF text tower": 15, "whisper": 3, "fusion": 1}


def test_cli_trains_with_remat_and_a_lock(tmp_path):
    """The CLI on the micro ViTamin under full remat (``--grad-checkpointing``), the
    image tower locked but for its head: ``proj`` and the ``pool`` convolution."""
    from open_clip_tpu_torch.train.main import main

    oc.add_model_config(RAW, name="micro-torch-vitamin")
    start = oc.create_model("micro-torch-vitamin", device="cpu", seed=0).state_dict()
    state = main(["--model", "micro-torch-vitamin", "--dataset-type", "synthetic",
                  "--train-num-samples", "16", "--batch-size", "8", "--epochs", "1",
                  "--device", "cpu", "--lr", "1e-3", "--grad-checkpointing", "--lock-image",
                  "--lock-image-unlocked-groups", "1", "--logs", str(tmp_path), "--name", "vtm"])
    assert state.step == 2
    end = state.model.state_dict()
    for key in ("visual.proj.weight", "visual.pool.conv.weight", "text_projection"):
        assert not torch.equal(end[key], start[key]), key
    for key in ("visual.pos_embed", "visual.stem.conv1.weight",
                "visual.transformer.resblocks.1.mlp.w0.weight"):
        assert torch.equal(end[key], start[key]), key
