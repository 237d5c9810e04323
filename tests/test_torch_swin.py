"""The port's Swin image tower against the JAX package's ``apply_swin``, on the CPU.

A micro Swin (56-pixel images: a 14x14 token map, then 7x7; windows of 7, shifted
on odd blocks of the first stage; widths 24 and 48, 3 heads), registered as
``swin_micro_patch4_window7_56`` in both packages' ``SWIN_CONFIGS``, gets its params
from the JAX package's ``init_clip``; ``params_from_jax`` carries them into the port.
Inputs from a numpy seed, fp32; the CPU takes the dense window attention in both
packages. Tolerances: features 1e-4 absolute (fp32 sums in other orders through 4
blocks); gradients 2e-6 + 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.loss import clip_loss as jax_clip_loss
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import swin as jswin

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.models import swin as pswin
from open_clip_tpu_torch.models.clip import CLIPModel

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

SWIN = "swin_micro_patch4_window7_56"
MICRO = dict(patch_size=4, embed_dim=24, depths=(2, 2), heads=(3, 3), window=7, mlp_ratio=4.0)
CFG = {"embed_dim": 24, "text_cfg": {"context_length": 16, "width": 32, "heads": 2, "layers": 1},
       "vision_cfg": {"image_size": 56, "timm_model_name": SWIN, "timm_model_pretrained": False,
                      "timm_pool": "", "timm_proj": "linear"}}
B = 3


@pytest.fixture(scope="module")
def setup():
    for configs in (jswin.SWIN_CONFIGS, pswin.SWIN_CONFIGS):
        configs[SWIN] = MICRO
    jcfg = JaxCfg.from_dict(CFG)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jclip.init_clip(k, jcfg))(
        jax.random.PRNGKey(0)))
    cfg = oc.CLIPModelCfg.from_dict(CFG)
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, 56, 56, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (B, 16)).astype(np.int32)
    texts[:, 0], texts[:, -1] = 49406, 49407
    yield jcfg, params, cfg, model, images, texts
    for configs in (jswin.SWIN_CONFIGS, pswin.SWIN_CONFIGS):
        configs.pop(SWIN, None)


def test_tower_matches_apply_swin(setup):
    jcfg, params, _, model, images, _ = setup
    apply = jax.jit(functools.partial(jswin.apply_swin, vision_cfg=jcfg.vision_cfg))
    want = np.asarray(apply(params["visual"], image=images))
    with torch.no_grad():
        got = model.visual(torch.from_numpy(images)).numpy()
        feats = model.encode_image(torch.from_numpy(images), normalize=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(feats, want / np.linalg.norm(want, axis=-1, keepdims=True),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_jax(setup, remat):
    """Every gradient of the contrastive loss; remat recomputes each block and gives
    the same numbers."""
    jcfg, params, cfg, model, images, texts = setup

    def loss_fn(p):
        out = jclip.clip_forward(p, jcfg, jnp.asarray(images), jnp.asarray(texts), train=True,
                                 compute_dtype=jnp.float32)
        return jax_clip_loss(out["image_features"], out["text_features"],
                             jnp.exp(p["logit_scale"]))

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    model.zero_grad(set_to_none=True)
    out = oc.clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True,
                          remat=remat)
    loss = oc.clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    for key, p in model.named_parameters():
        a, b = p.grad.numpy(), want[key].numpy()
        assert np.abs(a - b).max() <= 2e-6 + 1e-4 * np.abs(b).max(), key
    model.zero_grad(set_to_none=True)


def test_state_dict_keys_are_timms(setup):
    _, params, cfg, model, _, _ = setup
    keys = set(params_from_jax(params, cfg))
    assert keys == set(model.state_dict())
    for key in ("visual.patch_embed.proj.weight", "visual.patch_embed.norm.bias",
                "visual.layers.0.blocks.1.attn.relative_position_bias_table",
                "visual.layers.0.downsample.reduction.weight", "visual.layers.1.blocks.0.mlp.fc2.bias",
                "visual.norm.weight", "visual.head.proj.weight", "visual.head.proj.bias"):
        assert key in keys, key


def test_the_base_config_builds_with_timms_geometry():
    cfg = oc.CLIPModelCfg.from_dict(oc.get_model_config("swin_base_patch4_window7_224"))
    tower = pswin.SwinTransformer(cfg.vision_cfg, cfg.embed_dim)
    assert [len(stage.blocks) for stage in tower.layers] == [2, 2, 18, 2]
    assert [stage.blocks[0].attn.heads for stage in tower.layers] == [4, 8, 16, 32]
    assert tower.layers[0].blocks[0].attn.relative_position_bias_table.shape == (169, 4)
    assert tower.head.proj.weight.shape == (640, 1024)
    with pytest.raises(NotImplementedError):
        pswin.swin_cfg(oc.CLIPVisionCfg(timm_model_name="swin_huge_patch4_window12_384"))


def test_window_path_is_taken_on_the_card_only():
    """On the card Swin's 7x7 windows fail the panel gate and take the window kernel;
    on the CPU every block is dense, as in the JAX package."""
    from open_clip_tpu_torch.models.htsat import attention_path

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert attention_path(cuda, 56, 56, 7, 4, 128) == "window"
    assert attention_path(cuda, 7, 7, 7, 32, 1024) == "window"
    assert attention_path(cuda, 64, 64, 8, 4, 96) == "panel"
    assert attention_path(cuda, 64, 64, 8, 2, 16) == "panel"
    assert attention_path(cuda, 64, 64, 8, 4, 16) == "window"  # head width 4 < 8
    assert attention_path(cpu, 64, 64, 8, 4, 96) == "dense"
