"""The port's NaFlex path against the JAX package: config parsing, position-grid
sampling, token-budget scheduling, the patchify transform, the tower, and train
steps on patch-dict batches.

Tiny towers (2 layers, width 64, 2 heads) get their params from the JAX package's
``init_clip``; ``params_from_jax`` carries them into the port, and both see the same
inputs from a numpy seed, in fp32. Tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.config import parse_model_cfg as jax_parse_model_cfg
from open_clip_tpu.data import naflex as jdata
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import naflex_vit as jnaflex
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.config import parse_model_cfg
from open_clip_tpu_torch.convert import convert_params_dtype_, params_from_jax
from open_clip_tpu_torch.data import naflex as pdata
from open_clip_tpu_torch.models import naflex_vit as pnaflex
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

TEXT = {"context_length": 12, "vocab_size": 64, "width": 64, "heads": 2, "layers": 2}


def _cfg(tail, **kw):
    kwargs = {"embed_dim": 64, "depth": 2, "num_heads": 2, "pos_embed_grid_size": [4, 4], **kw}
    return {"embed_dim": 32, "custom_text": True,
            "vision_cfg": {"image_size": 64, "timm_model_name": f"naflexvit_tiny_patch16_{tail}",
                           "timm_pool": "", "timm_model_kwargs": kwargs},
            "text_cfg": TEXT}


VARIANTS = {
    "map": _cfg("map"),                                  # attention-pool head
    "gap": _cfg("gap"),                                  # masked average, as naflex_ViT-B-16
    "cls_prenorm_reg": _cfg("tok_reg2", class_token=True, pre_norm=True),
    "swiglu": _cfg("gap", swiglu_mlp=True, mlp_ratio=2.0),
}


def _models(variant, seed=0, dtype=torch.float32):
    raw = VARIANTS[variant]
    jcfg = JaxCfg.from_dict(raw)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(seed), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(raw)
    model = CLIPModel(cfg, compute_dtype=dtype)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return jcfg, params, cfg, model


def _patch_batch(seed, grids, seq_len, patch_dim=768):
    """Sample i has the grid grids[i]: random patches, zeros as padding."""
    rng = np.random.default_rng(seed)
    n = len(grids)
    patches = np.zeros((n, seq_len, patch_dim), np.float32)
    coords = np.zeros((n, seq_len, 2), np.int32)
    valid = np.zeros((n, seq_len), bool)
    for i, (gh, gw) in enumerate(grids):
        m = gh * gw
        patches[i, :m] = rng.standard_normal((m, patch_dim)).astype(np.float32)
        ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        coords[i, :m] = np.stack([ys.reshape(-1), xs.reshape(-1)], -1)
        valid[i, :m] = True
    return {"patches": patches, "patch_coord": coords, "patch_valid": valid}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# config, position grid, schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["naflex_ViT-B-16", "naflex_ViT-B-32", "ViT-B-16-SigLIP2-naflex",
                                  "moderntext-naflex_ViT-B-deep-16",
                                  "moderntext-naflex_ViT-SO150M2-16"])
def test_parse_naflex_cfg_matches_jax(name):
    want = jnaflex.parse_naflex_cfg(jax_parse_model_cfg(name).vision_cfg)
    got = pnaflex.parse_naflex_cfg(parse_model_cfg(name).vision_cfg)
    assert vars(got) == vars(want)


def test_naflex_name_parsing_overrides_and_registers():
    deep = pnaflex.parse_naflex_cfg(parse_model_cfg("moderntext-naflex_ViT-B-deep-16").vision_cfg)
    assert (deep.layers, deep.width, deep.heads) == (16, 768, 12)
    so = pnaflex.parse_naflex_cfg(parse_model_cfg("moderntext-naflex_ViT-SO150M2-16").vision_cfg)
    assert (so.layers, so.width, so.heads, so.reg_tokens) == (21, 832, 13, 1)
    b16 = pnaflex.parse_naflex_cfg(parse_model_cfg("naflex_ViT-B-16").vision_cfg)
    assert (b16.width, b16.layers, b16.heads, b16.patch_size, b16.pos_grid, b16.pool) == \
        (768, 12, 12, 16, (16, 16), "avg")


@pytest.mark.parametrize("bad", ["naflexvit_huge_patch16_gap", "naflexvit"])
def test_parse_naflex_cfg_raises_on_unknown_names(bad):
    with pytest.raises(ValueError):
        pnaflex.parse_naflex_cfg(oc.CLIPVisionCfg(timm_model_name=bad))


@pytest.mark.parametrize("grids", [[(4, 4), (2, 6)], [(1, 1), (7, 3)], [(5, 9), (9, 5)]])
def test_sample_pos_embed_matches_jax(grids):
    """fp32 bilinear sampling of one random grid: 1e-6."""
    rng = np.random.default_rng(1)
    grid = rng.standard_normal((4, 6, 16)).astype(np.float32)
    batch = _patch_batch(2, grids, 48, patch_dim=4)
    want = jnaflex.sample_pos_embed(jnp.asarray(grid), jnp.asarray(batch["patch_coord"]),
                                    jnp.asarray(batch["patch_valid"]))
    got = pnaflex.sample_pos_embed(torch.from_numpy(grid), torch.from_numpy(batch["patch_coord"]),
                                   torch.from_numpy(batch["patch_valid"]))
    assert got.shape == (2, 48, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_sample_pos_embed_at_the_grid_is_the_table():
    grid = torch.randn(4, 4, 8, generator=torch.Generator().manual_seed(0))
    batch = _patch_batch(0, [(4, 4)], 16, patch_dim=4)
    got = pnaflex.sample_pos_embed(grid, torch.from_numpy(batch["patch_coord"]),
                                   torch.from_numpy(batch["patch_valid"]))
    assert torch.allclose(got[0], grid.reshape(16, 8), atol=1e-6)


@pytest.mark.parametrize("w,h,patch,seq", [(96, 64, 16, 128), (512, 384, 16, 576), (130, 70, 16, 64),
                                           (1000, 30, 16, 16), (31, 17, 32, 49), (640, 480, 14, 1024),
                                           (64, 64, 16, 16), (3000, 2000, 16, 256)])
def test_target_grid_matches_jax(w, h, patch, seq):
    got = pdata._target_grid(w, h, patch, seq)
    assert got == jdata._target_grid(w, h, patch, seq)
    assert got[0] * got[1] <= seq and min(got) >= 1


def test_batch_size_calc():
    for args in ((256, 16384, 8), (1024, 16384, 8), (100000, 16384, 8), (576, 16384, 8), (576, 4096, 1)):
        assert pdata.calculate_batch_size(*args) == jdata.calculate_batch_size(*args)
    assert pdata.calculate_batch_size(1024, 16384, divisor=8) == 16
    assert pdata.calculate_batch_size(100000, 16384, divisor=8) == 1  # min clamp


@pytest.mark.parametrize("kw", [
    dict(seq_lens=(64, 128), patch_sizes=(16, 32), max_tokens_per_batch=1024, seed=3),
    dict(seq_lens=(128, 256, 576, 784, 1024), seq_len_probs=(0.1, 0.2, 0.3, 0.2, 0.2), seed=0),
    dict(seq_lens=(1024,), max_tokens_per_batch=16384, batch_divisor=8, seed=7),
])
def test_schedule_equals_the_jax_schedule(kw):
    """Draw for draw, two epochs."""
    ours = pdata.NaFlexBatchScheduler(pdata.NaFlexDataConfig(**kw), num_batches=25)
    theirs = jdata.NaFlexBatchScheduler(jdata.NaFlexDataConfig(**kw), num_batches=25)
    for epoch in (0, 1):
        assert ours.schedule(epoch) == theirs.schedule(epoch)
    assert ours.schedule(0) == ours.schedule(0)
    assert vars(ours.cfg) == vars(theirs.cfg)


# ---------------------------------------------------------------------------
# transform
# ---------------------------------------------------------------------------

def _random_image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("h,w,seq", [(64, 96, 128), (48, 96, 48), (64, 64, 16), (32, 160, 1024)])
def test_transform_without_resize_equals_jax(h, w, seq):
    """An image that is already a whole grid within the budget: patches, coordinates
    and validity are equal (the same normalisation in fp32: 1e-6)."""
    img = _random_image(h + w, h, w)
    want = jdata.NaFlexTransform(seq, 16)(Image.fromarray(img))
    got = pdata.NaFlexTransform(seq, 16)(torch.from_numpy(img))
    assert got["patches"].dtype == torch.float32 and got["patch_coord"].dtype == torch.int32
    assert got["patch_valid"].dtype == torch.bool
    np.testing.assert_array_equal(got["patch_coord"].numpy(), want["patch_coord"])
    np.testing.assert_array_equal(got["patch_valid"].numpy(), want["patch_valid"])
    np.testing.assert_allclose(got["patches"].numpy(), want["patches"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w,seq", [(70, 130, 64), (384, 512, 576), (300, 200, 128), (100, 37, 16)])
def test_transform_with_resize_is_close_to_jax(h, w, seq):
    """Grid, coordinates and validity are equal. Pixels: PIL resamples in fixed point
    and rounds to uint8, the port rounds a float resample, so a pixel may land on the
    next level: at most 2 levels (2/255/0.26 = 0.03 normalised), 0.3 levels on average.
    The image is smooth: on noise PIL's fixed-point coefficients differ by more."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 120 * np.sin(xx / 23.0 + c) * np.cos(yy / 17.0) for c in range(3)], -1)
    img = img.astype(np.uint8)
    want = jdata.NaFlexTransform(seq, 16)(Image.fromarray(img))
    got = pdata.NaFlexTransform(seq, 16)(torch.from_numpy(img))
    np.testing.assert_array_equal(got["patch_coord"].numpy(), want["patch_coord"])
    np.testing.assert_array_equal(got["patch_valid"].numpy(), want["patch_valid"])
    diff = np.abs(got["patches"].numpy() - want["patches"])
    assert diff.max() <= 2.01 / 255 / 0.26 and diff.mean() <= 0.3 / 255 / 0.26, (diff.max(), diff.mean())


def test_transform_of_a_batch_equals_the_single_calls():
    imgs = np.stack([_random_image(i, 70, 130) for i in range(3)])
    t = pdata.NaFlexTransform(64, 16)
    batched = t(torch.from_numpy(imgs))
    singles = pdata.collate_naflex([t(im) for im in imgs])
    assert set(batched) == {"patches", "patch_coord", "patch_valid"}
    for k in batched:
        assert batched[k].shape == singles[k].shape
        assert torch.allclose(batched[k].float(), singles[k].float(), atol=1e-6), k


@pytest.mark.parametrize("bad", [np.zeros((8, 8, 3), np.float32), np.zeros((8, 8), np.uint8),
                                 np.zeros((8, 8, 4), np.uint8)])
def test_transform_refuses_other_inputs(bad):
    with pytest.raises(ValueError, match="uint8"):
        pdata.NaFlexTransform(16, 16)(bad)


def test_synthetic_naflex_dataset_matches_jax():
    tok = oc.get_tokenizer("ViT-B-32", context_length=12)
    import open_clip_tpu as oct

    jtok = oct.get_tokenizer("ViT-B-32", context_length=12)
    kw = dict(seq_lens=(32, 64), max_tokens_per_batch=256, batch_divisor=2, seed=1)
    ours = pdata.SyntheticNaFlexDataset(pdata.NaFlexDataConfig(**kw), tok, num_batches=3)
    theirs = jdata.SyntheticNaFlexDataset(jdata.NaFlexDataConfig(**kw), jtok, num_batches=3)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["text"].numpy(), y["text"])
            for k in y["image"]:
                assert x["image"][k].shape == y["image"][k].shape
                np.testing.assert_allclose(x["image"][k].numpy().astype(np.float32),
                                           y["image"][k].astype(np.float32), atol=1e-6)


def test_webdataset_pipeline_is_not_ported(tmp_path):
    """The webdataset pipeline is ported; what it does not decode (a WebP member,
    there being no PIL tier) raises with the sample's key."""
    import io
    import tarfile

    from open_clip_tpu_torch.data.wds import WdsConfig, WdsPipeline

    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, "WEBP")
    with tarfile.open(tmp_path / "w.tar", "w") as tf:
        for name, data in (("w0.webp", buf.getvalue()), ("w0.txt", b"a webp")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    inner = WdsPipeline(WdsConfig(urls=str(tmp_path / "w.tar"), shuffle_shards=0,
                                  shuffle_samples=0), None, lambda t: np.zeros((len(t), 4)))
    pipe = pdata.NaFlexWdsPipeline(inner, pdata.NaFlexDataConfig(seq_lens=(16,),
                                                                 max_tokens_per_batch=16,
                                                                 batch_divisor=1), 1,
                                   lambda t: np.zeros((len(t), 4)))
    with pytest.raises(NotImplementedError, match=r"'w0'.*\.webp"):
        list(pipe)


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encode_image_matches_jax_on_a_ragged_batch(variant):
    """fp32, 2 layers: 1e-5 on the pooled, projected features."""
    jcfg, params, cfg, model = _models(variant)
    batch = _patch_batch(3, [(4, 4), (2, 5), (3, 3)], 20)
    want = jclip.encode_image(jax.tree.map(jnp.asarray, params), jcfg, _to_jax(batch))
    with torch.no_grad():
        got = model.encode_image(_to_torch(batch))
        unit = model.encode_image(_to_torch(batch), normalize=True)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(unit.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_padding_invariance(variant):
    """Extra padding tokens do not change the features (mask correctness): 1e-5."""
    _, _, _, model = _models(variant)
    small = _patch_batch(4, [(3, 4)], 12)
    big = {k: np.concatenate([v, np.zeros((1, 20) + v.shape[2:], v.dtype)], axis=1)
           for k, v in small.items()}
    big["patches"][:, 12:] = 7.0  # whatever the padding holds
    with torch.no_grad():
        f1 = model.encode_image(_to_torch(small))
        f2 = model.encode_image(_to_torch(big))
    assert (f1 - f2).abs().max().item() <= 1e-5


def test_tokens_output_and_key_valid_prefix():
    """forward_tokens gives the patch tokens without the prefix tokens, as the JAX
    ``apply_naflex_vit`` does: 1e-5."""
    jcfg, params, cfg, model = _models("cls_prenorm_reg")
    batch = _patch_batch(5, [(4, 4), (2, 3)], 16)
    ncfg = jnaflex.parse_naflex_cfg(jcfg.vision_cfg)
    _, want = jnaflex.apply_naflex_vit(jax.tree.map(jnp.asarray, params["visual"]), ncfg,
                                       _to_jax(batch))
    with torch.no_grad():
        _, tokens = model.visual.forward_tokens(_to_torch(batch))
    assert tokens.shape == (2, 16, 64)
    valid = batch["patch_valid"]
    np.testing.assert_allclose(tokens.numpy()[valid], np.asarray(want)[valid], rtol=0, atol=1e-5)


def test_a_patch_dict_needs_a_naflex_tower():
    cfg = oc.CLIPModelCfg.from_dict({
        "embed_dim": 32, "vision_cfg": {"image_size": 32, "layers": 1, "width": 64, "patch_size": 16},
        "text_cfg": TEXT})
    model = CLIPModel(cfg)
    with pytest.raises(ValueError, match="NaFlex patch-dict"):
        model.encode_image(_to_torch(_patch_batch(0, [(2, 2)], 4)))


def test_other_timm_towers_still_raise():
    raw = dict(VARIANTS["gap"], vision_cfg={"image_size": 64, "timm_model_name": "fastvit_mci1"})
    with pytest.raises(NotImplementedError, match="timm tower"):
        CLIPModel(oc.CLIPModelCfg.from_dict(raw))


def test_params_from_jax_raises_on_an_unknown_naflex_entry():
    _, params, cfg, _ = _models("map")
    extra = {**params, "visual": {**params["visual"], "rope": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="rope"):
        params_from_jax(extra, cfg)
    pool = {**params["visual"]["attn_pool"], "q": {**params["visual"]["attn_pool"]["q"],
                                                  "scale": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="scale"):
        params_from_jax({**params, "visual": {**params["visual"], "attn_pool": pool}}, cfg)


def test_pure_bf16_partition_matches_jax():
    """Kernels and their biases in bf16; norms, the position grid and the class,
    register and latent tokens in fp32, as the JAX ``convert_params_dtype`` leaves them."""
    from open_clip_tpu.convert import convert_params_dtype

    for variant in ("map", "cls_prenorm_reg", "swiglu"):
        _, params, cfg, model = _models(variant, dtype=torch.bfloat16)
        convert_params_dtype_(model, torch.bfloat16)
        jp = convert_params_dtype(jax.tree.map(jnp.asarray, params), jnp.bfloat16)
        want = params_from_jax(jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jp), cfg)
        is_bf16 = {k: v.dtype == torch.bfloat16 for k, v in model.state_dict().items()}
        jflat = params_from_jax(jax.tree.map(
            lambda x: np.full(x.shape, 1.0 if x.dtype == jnp.bfloat16 else 0.0, np.float32), jp), cfg)
        assert set(is_bf16) == set(want)
        for k, flag in is_bf16.items():
            assert flag == bool(jflat[k].flatten()[0] == 1.0), k


def test_vit_to_naflex_folding():
    """A square image through the plain ViT equals the folded NaFlex tower on the same
    patches (sampling at the grid's centres reproduces the table): 1e-4."""
    from open_clip_tpu_torch.models.vit import VisionTransformer, patchify

    vcfg = oc.CLIPVisionCfg(image_size=64, layers=2, width=64, patch_size=16, head_width=32)
    vit = VisionTransformer(vcfg, 32)
    vit.init_weights(torch.Generator().manual_seed(1))
    img = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype(np.float32))
    ncfg = pnaflex.NaFlexVitCfg(width=64, layers=2, heads=2, patch_size=16, pos_grid=(4, 4),
                                pool="tok", class_token=True, norm_eps=1e-5, proj_bias=False,
                                pre_norm=True)
    tower = pnaflex.NaFlexVit(ncfg, 32)
    state = {"visual." + k: v for k, v in vit.state_dict().items()}
    folded = pnaflex.vit_params_to_naflex(state, grid=(4, 4))
    tower.load_state_dict({k[len("visual."):]: v for k, v in folded.items()}, strict=True)
    batch = _to_torch(_patch_batch(0, [(4, 4)], 16))
    batch["patches"] = patchify(img, 16)
    with torch.no_grad():
        assert (tower(batch) - vit(img)).abs().max().item() <= 1e-4


def test_init_distributions_follow_the_jax_init():
    """Random init from a torch.Generator: the same shapes as ``init_clip``'s tree and,
    per tensor, a standard deviation within 15 % of the JAX draw's (zeros and ones
    exactly)."""
    raw = VARIANTS["map"]
    jcfg = JaxCfg.from_dict(raw)
    want = params_from_jax(jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg)),
                           oc.CLIPModelCfg.from_dict(raw))
    model = CLIPModel(oc.CLIPModelCfg.from_dict(raw))
    model.init_weights(torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if w.numel() > 1 and float(w.std()) == 0.0:  # zeros and ones
            assert torch.equal(got[k], w), k
        if w.numel() < 512 or float(w.std()) == 0.0:
            continue
        assert abs(float(got[k].std()) / float(w.std()) - 1.0) < 0.15, k


# ---------------------------------------------------------------------------
# train steps on patch-dict batches
# ---------------------------------------------------------------------------

LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
BATCH = 8


def _train_batch(seed=0):
    rng = np.random.default_rng(seed)
    grids = [(4, 4), (3, 5), (2, 2), (4, 3), (1, 6), (3, 3), (4, 4), (2, 7)]
    image = _patch_batch(seed, grids, 16)
    text = rng.integers(1, 62, (BATCH, 12)).astype(np.int32)
    text[np.arange(BATCH), rng.integers(2, 12, BATCH)] = 63  # the EOT position: the largest id
    return image, text


def _port_state(variant):
    _, params, cfg, model = _models(variant)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    return cfg, params, pts.create_train_state(model, opt), opt


def _jax_state(params):
    jparams = jax.tree.map(jnp.asarray, params)
    opt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), jparams,
                                  jsched.const_lr(LR, WARMUP))
    return jts.create_train_state(jparams, opt), opt


def _assert_state_close(state, jparams, cfg, atol):
    want = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        diff = (got[k].float() - w).abs().max().item()
        assert diff <= atol, (k, diff)


@pytest.mark.parametrize("variant", ["gap", "map"])
def test_one_and_three_steps_match_jax(variant):
    """Loss, ``grad_norm`` and logit scale 1e-5 relative at each of three steps; the
    parameters after steps 1 and 3 within 2e-2 * lr per step taken (Adam's first
    updates are g / (|g| + eps): see tests/test_torch_train_step.py)."""
    cfg, params, state, opt = _port_state(variant)
    jcfg = JaxCfg.from_dict(VARIANTS[variant])
    jstate, jopt = _jax_state(params)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32))
    image, text = _train_batch()
    jbatch = {"image": _to_jax(image), "text": jnp.asarray(text)}
    step = pts.make_train_step(cfg, opt)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        state, m = step(state, {"image": _to_torch(image), "text": torch.from_numpy(text)})
        assert state.step == i + 1 == int(jstate.step)
        for key in ("loss", "grad_norm", "logit_scale"):
            assert m[key].item() == pytest.approx(float(jm[key]), rel=1e-5), (i, key)
        if i in (0, 2):
            _assert_state_close(state, jstate.params, cfg, atol=2e-2 * LR * (i + 1))


@pytest.mark.parametrize("mode", ["linear", "sqrt"])
def test_naflex_loss_scale_matches_jax(mode):
    """The loss is scaled by (batch / reference batch) or its root, in both; one step
    against the JAX step at 1e-5 relative, and against the unscaled loss exactly."""
    cfg, params, state, opt = _port_state("gap")
    jcfg = JaxCfg.from_dict(VARIANTS["gap"])
    jstate, jopt = _jax_state(params)
    image, text = _train_batch(1)
    kw = dict(naflex_loss_scale=mode, reference_batch_size=32)
    _, jm = jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32, **kw)(
        jstate, {"image": _to_jax(image), "text": jnp.asarray(text)}, jax.random.PRNGKey(0))
    batch = {"image": _to_torch(image), "text": torch.from_numpy(text)}
    state, m = pts.make_train_step(cfg, opt, **kw)(state, batch)
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    _, _, plain_state, plain_opt = _port_state("gap")
    _, plain = pts.make_train_step(cfg, plain_opt)(plain_state, batch)
    ratio = BATCH / 32
    assert m["loss"].item() == pytest.approx(
        plain["loss"].item() * (ratio if mode == "linear" else ratio ** 0.5), rel=1e-6)


def test_loss_scale_needs_a_reference_batch_and_a_patch_dict():
    cfg, _, state, opt = _port_state("gap")
    image, text = _train_batch(2)
    batch = {"image": _to_torch(image), "text": torch.from_numpy(text)}
    with pytest.raises(ValueError, match="reference batch size"):
        pts.make_train_step(cfg, opt, naflex_loss_scale="linear")(state, batch)
    with pytest.raises(ValueError, match="naflex_loss_scale"):
        pts.make_train_step(cfg, opt, naflex_loss_scale="cubic")


@pytest.mark.parametrize("accum", [2, 4])
def test_gradcache_slices_inside_the_patch_dict(accum):
    """GradCache over microbatches of a dict image gives the simple step's loss (1e-6),
    ``grad_norm`` (1e-5) and parameters (2e-2 * lr), with the loss scale carried."""
    image, text = _train_batch(3)
    batch = {"image": _to_torch(image), "text": torch.from_numpy(text)}
    kw = dict(naflex_loss_scale="sqrt", reference_batch_size=16)
    cfg, _, s1, o1 = _port_state("gap")
    s1, m1 = pts.make_train_step(cfg, o1, **kw)(s1, batch)
    _, _, s2, o2 = _port_state("gap")
    s2, m2 = pts.make_train_step(cfg, o2, accum_steps=accum, **kw)(s2, batch)
    assert m2["loss"].item() == pytest.approx(m1["loss"].item(), rel=1e-6)
    assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(), rel=1e-5)
    for (k, a), b in zip(s1.model.state_dict().items(), s2.model.state_dict().values()):
        assert (a - b).abs().max().item() <= 2e-2 * LR, k


def test_remat_with_a_key_mask_equals_no_remat():
    image, text = _train_batch(4)
    batch = {"image": _to_torch(image), "text": torch.from_numpy(text)}
    cfg, _, s1, o1 = _port_state("swiglu")
    s1, m1 = pts.make_train_step(cfg, o1)(s1, batch)
    _, _, s2, o2 = _port_state("swiglu")
    s2, m2 = pts.make_train_step(cfg, o2, remat=True)(s2, batch)
    assert m1["loss"].item() == m2["loss"].item()
    assert m1["grad_norm"].item() == m2["grad_norm"].item()
