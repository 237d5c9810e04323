"""The port's ModifiedResNet tower and its train-mode batch norms against the JAX
package, on the CPU.

A micro RN (64-pixel images; width 8, so a 256-wide attention pool of 8 heads over
2x2 + 1 tokens; stages of 1, 2, 1, 1 blocks, so every shortcut form runs: the
stride-1 projection, the identity and the pooled stride-2 projection) gets its params
from the JAX package's ``init_clip``; ``params_from_jax`` carries them into the port.
Inputs from a numpy seed.

Tolerances. fp32 towers: rtol 1e-4, atol 1e-5 (sums in other orders through the
convolutions and batch norms); bf16: cosine >= 0.999 against JAX's bf16. Gradients
(train-mode batch norms): 2e-6 absolute plus 1e-4 relative. Steps (fp32, AdamW, clip
1.0): loss and grad_norm 1e-5 relative; the parameters 5e-2 * lr: the batch
statistics leave fp32 noise of ~1e-7 on convolution gradients of ~1e-6, which Adam's
first update g / (|g| + 1e-6) turns into ~3e-2 * lr (``tests/test_torch_train_step.py``
holds the ViT, without batch norms, to 2e-2 * lr); the running statistics 1e-5
absolute. Masks: exact; layer-decay scales 1 ulp.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_clip_tpu as oct
from open_clip_tpu.loss import clip_loss as jax_clip_loss
from open_clip_tpu.checkpoint import merge_params as jax_merge_params
from open_clip_tpu.config import CLIPModelCfg as JaxCfg, parse_model_cfg as jax_parse_model_cfg
from open_clip_tpu.convert import convert_params_dtype as jax_convert_params_dtype
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import resnet as jresnet
from open_clip_tpu.ops.pos_embed import resize_vision_pos_embed as jax_resize_vision_pos_embed
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import checkpoint as pckpt
from open_clip_tpu_torch import factory
from open_clip_tpu_torch.convert import (convert_params_dtype_, params_from_jax,
                                         torch_clip_to_params)
from open_clip_tpu_torch.models import resnet as presnet
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts
from open_clip_tpu_torch.train.main import main

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

MICRO = {"embed_dim": 32,
         "vision_cfg": {"image_size": 64, "layers": [1, 2, 1, 1], "width": 8, "head_width": 32},
         "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2}}
NAME = "micro-torch-rn"
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
B = 8
RN_CONFIGS = [f"RN{s}{q}" for s in ("50", "101", "50x4", "50x16", "50x64")
              for q in ("", "-quickgelu")]


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxCfg.from_dict(MICRO)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jclip.init_clip(k, jcfg))(
        jax.random.PRNGKey(0)))
    # batch norms away from the identity, as after training, so eval and train differ
    rng = np.random.default_rng(7)

    def perturb(node):
        for v in node.values():
            if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
                n = v["scale"].shape[0]
                v["scale"] = (1 + 0.2 * rng.standard_normal(n)).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
                v["mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
                v["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            elif isinstance(v, dict):
                perturb(v)

    perturb(params["visual"])
    cfg = oc.CLIPModelCfg.from_dict(MICRO)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (B, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(B), rng.integers(2, 16, B)] = 49407
    return jcfg, params, cfg, images, texts


def _model(params, cfg, dtype=torch.float32):
    model = CLIPModel(cfg, compute_dtype=dtype)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _sink_tree(sink, model):
    """The port's stats sink as {port name of running_mean/var: batch value}."""
    names = {id(m): n for n, m in model.named_modules()}
    out = {}
    for bn, mean, var in sink:
        out[f"{names[id(bn)]}.running_mean"] = mean
        out[f"{names[id(bn)]}.running_var"] = var
    return out


def _jax_sink_as_port(sink, params, cfg):
    """JAX's {path: {mean, var}} sink, laid over a copy of the params, through
    ``params_from_jax``."""
    tree = jax.tree.map(np.array, params)

    def lay(node, st):
        for k, v in st.items():
            if set(v) == {"mean", "var"}:
                node[k].update(mean=np.asarray(v["mean"]), var=np.asarray(v["var"]))
            else:
                lay(node[k], v)

    lay(tree["visual"], sink)
    return params_from_jax(tree, cfg)


@pytest.mark.parametrize("train", [False, True], ids=["running_stats", "batch_stats"])
def test_tower_matches_jax_fp32(setup, train):
    """The tower in fp32; in training also every layer's batch mean and unbiased
    variance against the JAX sink."""
    jcfg, params, cfg, images, _ = setup
    jsink = {}
    want = jresnet.apply_modified_resnet(jax.tree.map(jnp.asarray, params["visual"]),
                                         jcfg.vision_cfg, jnp.asarray(images),
                                         use_batch_stats=train,
                                         stats_sink=jsink if train else None)
    model = _model(params, cfg)
    sink = []
    with torch.no_grad():
        got = model.visual(torch.from_numpy(images), train=train, stats_sink=sink)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    if train:
        got_stats = _sink_tree(sink, model)
        want_stats = _jax_sink_as_port(jsink, params, cfg)
        assert len(sink) == sum(isinstance(m, presnet.BatchNorm2d) for m in model.modules()) == 22
        for name, v in got_stats.items():
            np.testing.assert_allclose(v.numpy(), want_stats[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    else:
        assert sink == []


@pytest.mark.parametrize("train", [False, True], ids=["running_stats", "batch_stats"])
def test_tower_matches_jax_bf16(setup, train):
    jcfg, params, cfg, images, _ = setup
    want = jresnet.apply_modified_resnet(jax.tree.map(jnp.asarray, params["visual"]),
                                         jcfg.vision_cfg, jnp.asarray(images),
                                         compute_dtype=jnp.bfloat16, use_batch_stats=train)
    with torch.no_grad():
        got = _model(params, cfg, torch.bfloat16).visual(torch.from_numpy(images),
                                                         torch.bfloat16, train=train)
    assert got.dtype == torch.bfloat16
    assert _cos(got.float().numpy(), np.asarray(want, np.float32)) >= 0.999


def test_attention_pool_matches_all_query_rows(setup):
    """The port projects the pooled token's query alone; JAX computes every row and
    keeps row 0: the same result."""
    jcfg, params, cfg, _, _ = setup
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 2, 2, 256)).astype(np.float32)
    ap = jax.tree.map(jnp.asarray, params["visual"]["attnpool"])
    want = jresnet._apply_attn_pool(ap, jnp.asarray(x), 8)
    pool = _model(params, cfg).visual.attnpool
    with torch.no_grad():
        got = pool(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


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
        lpi, lpt = model.get_logits(torch.from_numpy(images), torch.from_numpy(texts))
    np.testing.assert_allclose(gi.numpy(), np.asarray(fi), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(ft), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lpi.numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lpt.numpy(), np.asarray(logits).T, rtol=1e-4, atol=1e-4)


def test_gradients_match_jax(setup):
    """Every gradient of the contrastive loss through the train-mode batch norms."""
    jcfg, params, cfg, images, texts = setup

    def loss_fn(p):
        out = jclip.clip_forward(p, jcfg, jnp.asarray(images), jnp.asarray(texts), train=True,
                                 compute_dtype=jnp.float32, stats_sink={})
        return jax_clip_loss(out["image_features"], out["text_features"],
                             jnp.exp(p["logit_scale"]))

    want_loss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    model = _model(params, cfg)
    out = oc.clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts), train=True)
    loss = oc.clip_loss(out["image_features"], out["text_features"], model.logit_scale.exp())
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    for key, p in model.named_parameters():
        if p.grad is None:  # the running statistics; JAX's are zeros
            assert not want[key].any(), key
            continue
        a, b = p.grad.numpy(), want[key].numpy()
        assert np.abs(a - b).max() <= 2e-6 + 1e-4 * np.abs(b).max(), key


def _states(params, cfg, jcfg, ema=False, **step_kw):
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP),
                                   jparams, jsched.const_lr(LR, WARMUP))
    jstate = jts.create_train_state(jparams, jopt, ema=ema)
    jkw = dict(step_kw)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32, **jkw))
    model = _model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    state = pts.create_train_state(model, opt, ema=ema)
    return jstate, jstep, state, pts.make_train_step(cfg, opt, **step_kw)


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _assert_close(got, want, atol):
    assert set(got) == set(want)
    for key in want:
        a, b = got[key].detach().float().numpy(), want[key].float().numpy()
        assert a.shape == b.shape, key
        assert np.abs(a - b).max() <= atol, (key, np.abs(a - b).max())


@pytest.mark.parametrize("kind", ["plain", "frozen", "accum"])
def test_step_and_running_stats_match_jax(setup, kind, caplog):
    """One AdamW step: loss, grad_norm, every parameter and the running statistics.
    The plain step folds the batch's statistics in after the update; the frozen one
    (``freeze_bn_stats``) and GradCache (``accum_steps`` 2) leave them as they were."""
    jcfg, params, cfg, images, texts = setup
    kw = {"plain": {}, "frozen": {"freeze_bn_stats": True}, "accum": {"accum_steps": 2}}[kind]
    jstate, jstep, state, step = _states(params, cfg, jcfg, **kw)
    before = _stats({k: v.clone() for k, v in state.model.state_dict().items()})
    jstate, jm = jstep(jstate, {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                       jax.random.PRNGKey(0))
    state, m = step(state, {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)})
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    got = state.model.state_dict()
    _assert_close({k: v for k, v in got.items() if k not in before},
                  {k: v for k, v in want.items() if k not in before}, atol=5e-2 * LR)
    _assert_close(_stats(got), _stats(want), atol=1e-5)
    moved = max((got[k] - before[k]).abs().max().item() for k in before)
    assert (moved > 1e-3) == (kind == "plain"), moved
    if kind == "accum":
        assert "BN running stats are not updated" in caplog.text


def test_ema_holds_the_running_stats(setup):
    """Two steps with the EMA: the averaged statistics against JAX's EMA leaves (the
    EMA is taken before each step's merge, as in the JAX step)."""
    jcfg, params, cfg, images, texts = setup
    jstate, jstep, state, step = _states(params, cfg, jcfg, ema=True, ema_decay=0.9)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    for i in range(2):
        jstate, _ = jstep(jstate, {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                          jax.random.PRNGKey(i))
        state, _ = step(state, batch)
    want = _stats(params_from_jax(jax.tree.map(np.asarray, jstate.ema_params), cfg))
    names = [n for n, _ in state.model.named_parameters()]
    got = {n: e for n, e in zip(names, state.ema) if n in want}
    _assert_close(got, want, atol=1e-5)
    moved = [n for n in want if not torch.equal(got[n], state.model.state_dict()[n])]
    assert moved  # the EMA lags the merged statistics


def test_running_stats_get_no_gradient(setup):
    _, params, cfg, images, texts = setup
    model = _model(params, cfg)
    for train in (True, False):
        model.zero_grad(set_to_none=True)
        out = oc.clip_forward(model, torch.from_numpy(images), torch.from_numpy(texts),
                              train=train)
        (out["image_features"].sum() + out["text_features"].sum()).backward()
        stats = [n for n, p in model.named_parameters() if n.endswith(("_mean", "_var"))]
        assert len(stats) == 44 and set(stats) == model.params_outside_loss()
        assert all(model.get_parameter(n).grad is None for n in stats)


def test_pure_bf16_keeps_the_jax_partition(setup):
    """Under the pure precisions the JAX package casts the attention pool's kernels
    and biases, not the tower's convolutions (bare leaves) or batch norms."""
    _, params, cfg, _, _ = setup
    want = params_from_jax(jax.tree.map(np.asarray, jax_convert_params_dtype(
        jax.tree.map(jnp.asarray, params), jnp.bfloat16)), cfg)
    jdtypes = jax.tree.map(lambda x: np.asarray(x).dtype, jax_convert_params_dtype(
        jax.tree.map(jnp.asarray, params), jnp.bfloat16))
    model = convert_params_dtype_(_model(params, cfg), torch.bfloat16)
    got = {n: p.dtype for n, p in model.named_parameters()}
    assert got["visual.attnpool.q_proj.weight"] == torch.bfloat16
    assert got["visual.layer1.0.conv1.weight"] == torch.float32
    assert got["visual.bn1.running_var"] == torch.float32
    assert str(jdtypes["visual"]["attnpool"]["q_proj"]["kernel"]) == "bfloat16"
    assert jdtypes["visual"]["layer1"]["0"]["conv1"] == np.float32
    assert set(got) == set(want)


def _masks_as_port(values, params, cfg):
    full = jax.tree.map(lambda v, p: np.broadcast_to(np.asarray(v, np.float32), p.shape).copy(),
                        values, params)
    return params_from_jax(full, cfg)


@pytest.mark.parametrize("which", ["wd", "layer_decay", "lock0", "lock1", "lock2"])
def test_masks_match_jax(setup, which):
    """The weight-decay mask, the layer-decay scales (none on the ResNet: the CLI
    passes no depth for it; the text tower's ladder) and the lock masks, tensor by
    tensor. Locking keeps only ``attnpool`` trainable: the ResNet has no ``blocks``."""
    _, params, cfg, _, _ = setup
    model = CLIPModel(cfg)
    if which == "wd":
        want, got = joptim.wd_mask(params), poptim.wd_mask(model)
    elif which == "layer_decay":
        want = joptim.layer_decay_scales(params, 0.75, None)
        got = poptim.layer_decay_scales(model, 0.75, None)
    else:
        kw = {"lock_image": True, "lock_image_unlocked_groups": int(which[-1])}
        want, got = joptim.trainable_mask(params, **kw), poptim.trainable_mask(model, **kw)
    want = _masks_as_port(want, params, cfg)
    assert list(got) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        g = torch.as_tensor(got[name], dtype=torch.float32).expand(p.shape).numpy()
        np.testing.assert_allclose(g, want[name].numpy(), rtol=np.finfo(np.float32).eps,
                                   atol=0, err_msg=name)
    if which == "lock1":
        assert {n for n in got if got[n] == 1.0 and n.startswith("visual.")} == {
            n for n in got if n.startswith("visual.attnpool.")}


def _reference_sd(params, cfg):
    """The OpenAI RN checkpoint layout, from the port's names (the reference's) plus
    the ``num_batches_tracked`` counters PyTorch's batch norms carry."""
    sd = {k: v.numpy() for k, v in _model(params, cfg).state_dict().items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = np.asarray(3, np.int64)
    return sd


def test_reference_converter_matches_jax(setup):
    jcfg, params, cfg, _, _ = setup
    sd = _reference_sd(params, cfg)
    want = jax.tree.map(np.asarray, jresnet.torch_resnet_clip_to_params(dict(sd), jcfg))
    got = torch_clip_to_params({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # and through the JAX tree, the reference layout loads back bit for bit
    model = CLIPModel(cfg)
    pckpt.merge_params_(model, pckpt.checkpoint_to_params(sd, cfg))
    ref = _model(params, cfg).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())


def test_attention_pool_embedding_at_another_size(setup, tmp_path):
    """A checkpoint of another image size: the port resizes the attention pool's
    positional embedding on the image's grid at stride 32 with the JAX package's
    resize. The JAX ``merge_params`` takes the patch grid there, which an RN config of
    the registry lacks (``patch_size`` None): it raises."""
    jcfg, params, cfg, _, _ = setup
    sd = _reference_sd(params, cfg)
    path = tmp_path / "rn.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    big = json.loads(json.dumps(MICRO))
    big["vision_cfg"].update(image_size=96, patch_size=None)
    jbig = JaxCfg.from_dict(big)
    jtree = jresnet.torch_resnet_clip_to_params(dict(sd), jbig)
    jnew = jax.eval_shape(lambda k: jclip.init_clip(k, jbig), jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        jax_merge_params(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jnew), jtree, jbig)
    model = CLIPModel(oc.CLIPModelCfg.from_dict(big))
    pckpt.load_checkpoint(model, path)
    old = params["visual"]["attnpool"]["positional_embedding"]
    want = np.asarray(jax_resize_vision_pos_embed(jnp.asarray(old), (3, 3), (2, 2), num_prefix=1))
    got = model.visual.attnpool.positional_embedding.detach().numpy()
    assert got.shape == (10, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    same = CLIPModel(cfg)
    pckpt.load_checkpoint(same, path)
    assert torch.equal(same.visual.attnpool.positional_embedding, torch.from_numpy(np.array(old)))


@pytest.mark.parametrize("name", RN_CONFIGS)
def test_registry_configs_build_with_the_jax_parameter_count(name):
    raw = factory.get_model_config(name)
    with torch.device("meta"):
        model = factory.model_from_config(raw)
    jcfg = jax_parse_model_cfg(name)
    want = jax.eval_shape(lambda k: jclip.init_clip(k, jcfg), jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(want))
    assert isinstance(model.visual, presnet.ModifiedResNet)


def test_registry_tags_raise_naming_their_file():
    with pytest.raises(NotImplementedError, match="RN50-quickgelu"):
        oc.create_model("RN50-quickgelu", pretrained="openai", device="cpu")


@pytest.fixture
def registered():
    for pkg in (oct, oc):
        pkg.add_model_config(json.loads(json.dumps(MICRO)), name=NAME)
    yield


@pytest.mark.parametrize("freeze", [False, True], ids=["plain", "freeze_bn_stats"])
def test_cli_trains_and_freezes_the_statistics(registered, tmp_path, freeze):
    """``--lock-image --lock-image-freeze-bn-stats`` keeps the running statistics
    (and the locked tower) where they started; without the freeze they move."""
    args = ["--model", NAME, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "8", "--epochs", "1", "--device", "cpu", "--lr", "1e-3",
            "--logs", str(tmp_path), "--name", f"rn-{freeze}", "--lock-image"]
    start = oc.create_model(NAME, device="cpu", seed=0).state_dict()
    state = main(args + (["--lock-image-freeze-bn-stats"] if freeze else []))
    assert state.step == 2
    end = state.model.state_dict()
    stats = [k for k in end if k.endswith(("running_mean", "running_var"))]
    assert stats and all(torch.equal(end[k], start[k]) for k in stats) == freeze
    assert all(torch.equal(end[k], start[k]) for k in end
               if k.startswith("visual.") and "attnpool" not in k and k not in stats)
