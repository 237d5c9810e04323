"""Fine-tuning in the port (layer-wise lr decay, tower locking, the CLI's pretrained
flags) against the JAX package, on the CPU.

Scales and masks are compared per tensor: the JAX package's per-leaf value,
broadcast to the leaf's shape, goes through ``params_from_jax``, which gives the
port's name and layout (transposes included) for every entry. The Swin and HTSAT
towers pin a fault the port follows: the JAX rules take the first axis of every
leaf under ``blocks`` for a layer axis, and those lists are unstacked. Scales are
float32 powers: 1 ulp relative. Train steps: the tolerances of
``tests/test_torch_train_step.py`` (loss and grad_norm 1e-5 relative, parameters
2e-2 * lr per step), and the locked tensors equal their start exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_clip_tpu as oct
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.convert import params_to_torch_state_dict
from open_clip_tpu.models import clap as jclap
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import swin as jswin
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.models import clap as pclap
from open_clip_tpu_torch.models import swin as pswin
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts
from open_clip_tpu_torch.train.main import main

TINY = {"embed_dim": 64,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 128, "patch_size": 16,
                       "head_width": 64},
        "text_cfg": {"context_length": 16, "width": 128, "heads": 2, "layers": 2}}
SWIN = "swin_micro_patch4_window7_56"
SWIN_MICRO = dict(patch_size=4, embed_dim=24, depths=(2, 2), heads=(3, 3), window=7, mlp_ratio=4.0)
SWIN_CFG = {"embed_dim": 24, "text_cfg": {"context_length": 16, "width": 32, "heads": 2, "layers": 1},
            "vision_cfg": {"image_size": 56, "timm_model_name": SWIN, "timm_model_pretrained": False,
                           "timm_pool": "", "timm_proj": "linear"}}
HTSAT_MICRO = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), spec_size=64)
CLAP_CFG = {"embed_dim": 32, "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2},
            "audio_cfg": {"model_type": "HTSAT", "model_name": "micro", "sample_rate": 16000,
                          "window_size": 256, "hop_size": 64, "mel_bins": 32, "fmin": 50,
                          "fmax": 8000, "clip_samples": 8000, "class_num": 10}}
NAME = "tiny-torch-finetune"
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 0.5
BATCH = 8


@pytest.fixture(scope="module", autouse=True)
def registered():
    for configs in (jswin.SWIN_CONFIGS, pswin.SWIN_CONFIGS):
        configs[SWIN] = SWIN_MICRO
    for configs in (jclap.HTSAT_CONFIGS, pclap.HTSAT_CONFIGS):
        configs["micro"] = HTSAT_MICRO
    for pkg in (oct, oc):
        pkg.add_model_config(json.loads(json.dumps(TINY)), name=NAME)
    yield
    for configs in (jswin.SWIN_CONFIGS, pswin.SWIN_CONFIGS):
        configs.pop(SWIN, None)
    for configs in (jclap.HTSAT_CONFIGS, pclap.HTSAT_CONFIGS):
        configs.pop("micro", None)


@pytest.fixture(scope="module")
def towers(registered):
    """name -> (JAX params as numpy, port config) for the three tower families."""
    out = {}
    for name, d in (("vit", TINY), ("swin", SWIN_CFG), ("clap", CLAP_CFG)):
        jcfg = JaxCfg.from_dict(d)
        params = jax.tree.map(np.asarray, jax.jit(lambda k, c=jcfg: jclip.init_clip(k, c))(
            jax.random.PRNGKey(0)))
        out[name] = (params, oc.CLIPModelCfg.from_dict(d))
    return out


def _as_port(jax_values, params, cfg):
    """A JAX per-leaf value tree (a scale or mask) broadcast to each leaf's shape and
    carried into the port's names and layouts."""
    full = jax.tree.map(lambda v, p: np.broadcast_to(np.asarray(v, np.float32), p.shape).copy(),
                        jax_values, params)
    return params_from_jax(full, cfg)


def _assert_per_tensor(got, want, params, ulps=0):
    model = CLIPModel(params[1])
    assert list(got) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        g = torch.as_tensor(got[name], dtype=torch.float32).expand(p.shape).numpy()
        w = want[name].numpy()
        np.testing.assert_allclose(g, w, rtol=ulps * np.finfo(np.float32).eps, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("tower_decay", [None, {"visual": 0.6, "text": 0.9, "audio": None}],
                         ids=["global", "per_tower"])
def test_layer_decay_scales_match_jax_vit(towers, tower_decay):
    params, cfg = towers["vit"]
    want = _as_port(joptim.layer_decay_scales(params, 0.75, 2, tower_decay=tower_decay),
                    params, cfg)
    got = poptim.layer_decay_scales(CLIPModel(cfg), 0.75, 2, tower_decay=tower_decay)
    _assert_per_tensor(got, want, towers["vit"], ulps=1)
    assert got["visual.proj"] == 1.0 and got["ln_final.weight"] == 1.0
    assert got["visual.transformer.resblocks.1.attn.in_proj_weight"] != 1.0


@pytest.mark.parametrize("family", ["swin", "clap"])
def test_layer_decay_scales_follow_jax_on_block_lists(towers, family):
    """Swin's and HTSAT's block weights get JAX's ladder along their first JAX axis."""
    params, cfg = towers[family]
    want = _as_port(joptim.layer_decay_scales(params, 0.9, 3), params, cfg)
    got = poptim.layer_decay_scales(CLIPModel(cfg), 0.9, 3)
    _assert_per_tensor(got, want, towers[family], ulps=1)
    rows = [n for n, v in got.items() if isinstance(v, torch.Tensor)]
    assert rows and all(".blocks." in n for n in rows)


@pytest.mark.parametrize("kw", [
    {"lock_image": True}, {"lock_image": True, "lock_image_unlocked_groups": 1},
    {"lock_image": True, "lock_image_unlocked_groups": 2},
    {"lock_image": True, "lock_image_unlocked_groups": 3},  # L + 1: every block unlocked
    {"lock_text": True}, {"lock_text": True, "lock_text_unlocked_layers": 2},
], ids=["image0", "image1", "image2", "image3", "text0", "text2"])
def test_trainable_mask_matches_jax_vit(towers, kw):
    params, cfg = towers["vit"]
    want = _as_port(joptim.trainable_mask(params, **kw), params, cfg)
    _assert_per_tensor(poptim.trainable_mask(CLIPModel(cfg), **kw), want, towers["vit"])


@pytest.mark.parametrize("family,kw", [
    ("swin", {"lock_image": True, "lock_image_unlocked_groups": 2}),
    ("clap", {"lock_text": True, "lock_text_unlocked_layers": 2}),
])
def test_trainable_mask_follows_jax_on_block_lists(towers, family, kw):
    params, cfg = towers[family]
    want = _as_port(joptim.trainable_mask(params, **kw), params, cfg)
    _assert_per_tensor(poptim.trainable_mask(CLIPModel(cfg), **kw), want, towers[family])


# ---------------------------------------------------------------------------
# fine-tune steps against make_train_step
# ---------------------------------------------------------------------------

LOCK = dict(lock_image=True, lock_image_unlocked_groups=2)


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "gradcache"])
def test_locked_layer_decay_steps_match_jax(towers, accum):
    params, cfg = towers["vit"]
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (BATCH, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(BATCH), rng.integers(2, 16, BATCH)] = 49407

    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(
        joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP, layer_decay=0.75), jparams,
        jsched.const_lr(LR, WARMUP), num_layers=2)
    jopt = joptim.apply_trainable_mask(jopt, joptim.trainable_mask(jparams, **LOCK))
    jstate = jts.create_train_state(jparams, jopt)
    jstep = jax.jit(jts.make_train_step(JaxCfg.from_dict(TINY), jopt, compute_dtype=jnp.float32,
                                        accum_steps=accum))

    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = poptim.create_optimizer(
        poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP, layer_decay=0.75), model,
        psched.const_lr(LR, WARMUP), num_layers=2)
    opt = poptim.apply_trainable_mask(opt, poptim.trainable_mask(model, **LOCK))
    state = pts.create_train_state(model, opt)
    step = pts.make_train_step(cfg, opt, accum_steps=accum)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    for i in range(2):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                           jax.random.PRNGKey(i))
        state, m = step(state, batch)
        assert float(jm["grad_norm"]) > CLIP  # the clip bites
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    mask = poptim.trainable_mask(model, **LOCK)
    for k, v in state.model.state_dict().items():
        diff = np.abs(v.numpy() - want[k].numpy()).max()
        assert diff <= 2e-2 * LR * 2, (k, diff)
        if mask[k] == 0.0:
            assert torch.equal(v, start[k]), k
        else:
            assert not torch.equal(v, start[k]), k
    assert mask["visual.conv1.weight"] == 0.0 and mask["visual.proj"] == 1.0
    assert mask["visual.transformer.resblocks.1.mlp.c_fc.weight"] == 1.0
    assert mask["visual.transformer.resblocks.0.mlp.c_fc.weight"] == 0.0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _args(tmp_path, name, *extra):
    return ["--model", NAME, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "8", "--lr", "1e-3", "--warmup", "1", "--precision", "fp32",
            "--logs", str(tmp_path), "--name", name, "--device", "cpu", "--epochs", "1",
            "--wd", "0.2", "--log-every-n-steps", "1", *extra]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, registered):
    """A reference .pt of the JAX package's seed-5 model, and that model's weights in
    the port's names."""
    jm = oct.create_model(NAME, seed=5)
    path = tmp_path_factory.mktemp("ckpt") / "pretrained.pt"
    sd = params_to_torch_state_dict(jm.params, custom_text=True)
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               path)
    return str(path), params_from_jax(jax.tree.map(np.asarray, jm.params),
                                      oc.CLIPModelCfg.from_dict(TINY))


def test_cli_pretrained_locks_and_decays(tmp_path, checkpoint):
    path, source = checkpoint
    state = main(_args(tmp_path, "ft", "--pretrained", path, "--lock-image",
                       "--lock-image-unlocked-groups", "2", "--layer-decay", "0.75",
                       "--grad-clip-norm", "1.0", "--lock-text-freeze-layer-norm"))
    assert state.step == 2
    got = state.model.state_dict()
    # the synthetic batch repeats one sample: the gradients vanish and the weight
    # decay moves the trainable 2-D weights; the locked ones keep the checkpoint's bits
    for k in ("visual.conv1.weight", "visual.transformer.resblocks.0.attn.in_proj_weight",
              "visual.positional_embedding"):
        assert torch.equal(got[k], source[k]), k
    for k in ("visual.proj", "visual.transformer.resblocks.1.mlp.c_fc.weight",
              "transformer.resblocks.0.attn.in_proj_weight", "token_embedding.weight"):
        assert not torch.equal(got[k], source[k]), k
    assert "lock_image: True" in (tmp_path / "ft" / "params.txt").read_text()


def test_cli_pretrained_image_loads_one_tower(tmp_path, checkpoint):
    path, source = checkpoint
    state = main(_args(tmp_path, "img", "--pretrained-image", path, "--lr", "0"))
    seed0 = oc.create_model(NAME, precision="fp32", device="cpu", seed=0).state_dict()
    for k, v in state.model.state_dict().items():
        want = source[k] if k.startswith("visual.") else seed0[k]
        assert torch.equal(v, want), k


def test_cli_rejects_what_stays_unported(tmp_path, checkpoint):
    with pytest.raises(NotImplementedError, match="--lock-image-freeze-bn-stats"):
        main(_args(tmp_path, "bn", "--lock-image", "--lock-image-freeze-bn-stats"))
    with pytest.raises(NotImplementedError, match="laion2b_s34b_b79k"):
        main(["--model", "ViT-B-32", "--pretrained", "laion2b_s34b_b79k", "--device", "cpu",
              "--dataset-type", "synthetic", "--logs", str(tmp_path), "--name", "tag"])
    with pytest.raises(ValueError, match="no audio tower"):
        main(_args(tmp_path, "aud", "--pretrained-audio", checkpoint[0]))
