"""The port's GenLAP against the JAX package's, on the CPU at a micro size.

``naflexgenlap_test_1d`` (full-height 64 x 4 mel patches: 1-D time positions) and
``naflexgenlap_test_2d`` (32 x 4 patches, two frequency rows: axial positions),
both width 64, 4 heads, depth 2, with the vocabulary cut to 512 ids (pad 510, start
511, end 509) and drop path 0, get their params from the JAX package's
``init_genlap``; ``params_from_jax`` carries them into the port. Audio prefixes are
patch dicts of 12 patches, one row ragged (8 valid); captions are 6 ids, ragged
with pad. ``test_2d`` also runs with ``pack_prefix`` (the layout of every released
GenLAP config).

Tolerances (fp32): features, logits, scores and losses 2e-5 relative to their
largest. Captions token for token. The train step (plain gradient descent, lr 0.1):
loss 1e-5 relative, each gradient 2e-6 absolute plus 1e-4 relative of its largest,
as in ``test_torch_genlip.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import open_clip_tpu as jpkg
from open_clip_tpu.models import genlap as JGA
from open_clip_tpu.models import genlip as JG
from open_clip_tpu.train import train_step as jts

from open_clip_tpu_torch import factory
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.models import genlap as PGA
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

VOCAB, PAD, BOS, EOS = 512, 510, 511, 509
B, NI, LT = 3, 12, 6
LR = 0.1


def micro_raw(name, **trunk):
    raw = jpkg.get_model_config(name)
    raw["text_cfg"].update(vocab_size=VOCAB, pad_id=PAD, bos_id=BOS, eos_id=EOS)
    raw["genlap_cfg"].update({"drop_path_rate": 0.0, **trunk})
    return raw


RAWS = {"1d": micro_raw("naflexgenlap_test_1d"), "2d": micro_raw("naflexgenlap_test_2d"),
        "2d-packed": micro_raw("naflexgenlap_test_2d", pack_prefix=True)}
_SETUPS = {}


def setup_of(variant):
    if variant not in _SETUPS:
        raw = RAWS[variant]
        jcfg = JGA.GenLapModelCfg.from_dict(raw)
        params = jax.tree.map(np.asarray, jax.jit(lambda k: JGA.init_genlap(k, jcfg))(
            jax.random.PRNGKey(1)))
        cfg = PGA.GenLapModelCfg.from_dict(raw)
        rows = cfg.audio_cfg.freq_tokens
        rng = np.random.default_rng(0)
        coord = np.stack([np.arange(NI) % rows, np.arange(NI) // rows], -1).astype(np.int32)
        audio = {"patches": (rng.standard_normal((B, NI, cfg.audio_cfg.patch_dim)) * 0.5
                             ).astype(np.float32),
                 "patch_coord": np.broadcast_to(coord, (B, NI, 2)).copy(),
                 "patch_valid": np.arange(NI)[None] < np.array([NI, 8, NI])[:, None]}
        text = rng.integers(0, 500, (B, LT)).astype(np.int32)
        text[:, 0] = BOS
        text[1, 3:] = PAD
        _SETUPS[variant] = (jcfg, params, cfg, audio, text)
    return _SETUPS[variant]


def port_model(params, cfg):
    model = PGA.GenLapModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def jtree(x):
    return jax.tree.map(jnp.asarray, x)


def close(a, b, rtol=2e-5, atol=0.0):
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, dtype=np.float64)
            for x in (a, b))
    assert a.shape == b.shape
    diff = np.abs(a - b).max() if a.size else 0.0
    assert diff <= atol + rtol * max(np.abs(b).max(), 1e-30), diff


def test_positions_match_jax():
    for variant in ("1d", "2d"):
        jcfg, _, cfg, audio, text = setup_of(variant)
        assert cfg.use_rope_1d == jcfg.use_rope_1d == (variant == "1d")
        t = torch.from_numpy
        want = JGA.build_audio_position_ids(jnp.asarray(audio["patch_coord"]),
                                            audio["patch_valid"], text != PAD,
                                            rope_1d=jcfg.use_rope_1d)
        got = PGA.build_audio_position_ids(t(audio["patch_coord"]), t(audio["patch_valid"]),
                                           t(text != PAD), rope_1d=cfg.use_rope_1d)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", ["1d", "2d"])
def test_features_logits_and_loss_match_jax(variant):
    jcfg, params, cfg, audio, text = setup_of(variant)
    model = port_model(params, cfg)

    @jax.jit
    def jax_outputs(p, a, t):
        return (JGA.encode_audio(p, jcfg, a, normalize=True),
                JGA.genlap_forward(p, jcfg, a, t)["logits"],
                JGA.genlap_forward(p, jcfg, a, t, compute_loss=True)["loss"])

    feats, logits, want_loss = jax_outputs(jtree(params), jtree(audio), jnp.asarray(text))
    with torch.no_grad():
        close(model.encode_audio(audio, normalize=True), feats)
        out = model(audio, text)
        loss = model(audio, text, compute_loss=True)["loss"]
    assert out["audio_seq_len"] == NI
    close(out["logits"], logits)
    assert loss.item() == pytest.approx(float(want_loss), rel=2e-5)
    with pytest.raises(ValueError, match="encodes audio"):
        model.encode_image(audio)


def test_packed_loss_matches_jax():
    jcfg, params, cfg, audio, text = setup_of("2d-packed")
    with torch.no_grad():
        got = port_model(params, cfg)(audio, text, compute_loss=True)["loss"]
    want = jax.jit(lambda p, a, t: JGA.genlap_forward(p, jcfg, a, t, compute_loss=True)["loss"])(
        jtree(params), jtree(audio), jnp.asarray(text))
    assert got.item() == pytest.approx(float(want), rel=2e-5)


def test_cache_scores_and_captions_match_jax():
    """The audio prefix cache, cached scores, and greedy captions against the audio
    cache (the end token's ``lm_head`` row scaled up so that captions end)."""
    jcfg, params, cfg, audio, text = setup_of("1d")
    params = jax.tree.map(np.copy, params)
    params["lm_head"]["kernel"][:, EOS] *= 6.0
    model = port_model(params, cfg)
    jp = jtree(params)

    @jax.jit
    def jax_outputs(p, a, t):
        c = JGA.prefix_cache(p, jcfg, a)
        return c, JG.score_captions(p, jcfg, c, t), JG.generate_cached(p, jcfg, a, seq_len=8,
                                                                       cache=c)

    jcache, scores, want = jax_outputs(jp, jtree(audio), jnp.asarray(text))
    cache = model.prefix_cache(audio)
    for k in ("k", "v", "last_hidden"):
        close(cache[k], jcache[k])
    assert np.array_equal(cache["text_start"].numpy(), np.asarray(jcache["text_start"]))
    close(model.score_captions(cache, text), scores)
    want = np.asarray(want)
    got = model.generate(audio, seq_len=8).numpy()
    assert np.array_equal(got, want) and (want == EOS).any()
    with pytest.raises(ValueError, match="cache"):
        model.generate(audio, kv_cache=False)


_SGD = optax.chain(optax.trace(decay=0.0, nesterov=True), optax.scale(-LR))


@pytest.mark.parametrize("variant", ["2d", "2d-packed"])
def test_genlap_step_matches_jax(variant):
    """One ``make_train_step(loss_type="genlap")`` step (the packed loss for
    ``2d-packed``) against the JAX step: the loss and every gradient."""
    jcfg, params, cfg, audio, text = setup_of(variant)
    jstate, jm = jax.jit(jts.make_train_step(jcfg, _SGD, loss_type="genlap",
                                             compute_dtype=jnp.float32))(
        jts.create_train_state(jtree(params), _SGD),
        {"audio": jtree(audio), "text": jnp.asarray(text)}, jax.random.PRNGKey(0))
    model = port_model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(opt="sgd", momentum=0.0, lr=LR, wd=0.0),
                                  model, lambda s: LR)
    assert pts.loss_type_for(cfg) == "genlap"
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    _, m = pts.make_train_step(cfg, opt, loss_type="genlap")(
        pts.create_train_state(model, opt),
        {"audio": {k: torch.from_numpy(v) for k, v in audio.items()},
         "text": torch.from_numpy(text)})
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    for k, p in model.named_parameters():
        close((before[k] - p.detach()) / LR, (before[k] - want[k]) / LR, 1e-4, 2e-6)
    with pytest.raises(ValueError, match="does not train this config"):
        pts.make_train_step(cfg, opt, loss_type="genlip")


def test_reference_checkpoint_converts_like_jax():
    """``audio_embed.*``/``audio_proj.*`` and the shared GenLIP keys -> the tree,
    leaf for leaf against the JAX converter; the model loads it strictly."""
    jcfg, params, cfg, _, _ = setup_of("2d")
    sd = {"audio_embed.proj.weight": params["patch_embed"]["proj"]["kernel"].T,
          "audio_embed.proj.bias": params["patch_embed"]["proj"]["bias"],
          "audio_proj.weight": params["visual_proj"]["kernel"].T if "visual_proj" in params
          else None, "text_embed.weight": params["text_embed"],
          "lm_head.weight": params["lm_head"]["kernel"].T,
          "in_proj.weight": params["in_proj"]["kernel"].T, "in_proj.bias": params["in_proj"]["bias"],
          "out_proj.weight": params["out_proj"]["kernel"].T,
          "out_proj.bias": params["out_proj"]["bias"],
          "trunk.ln_post.weight": params["trunk"]["ln_post"]["scale"],
          "trunk.ln_post.bias": params["trunk"]["ln_post"]["bias"]}
    sd = {k: v for k, v in sd.items() if v is not None}
    blocks = params["trunk"]["blocks"]
    for i in range(cfg.trunk_cfg.depth):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"trunk.layers.{i}.self_attn.{n}.weight"] = blocks["attn"][n]["kernel"][i].T
        for n in ("fc1", "gate_fc", "fc2"):
            sd[f"trunk.layers.{i}.mlp.{n}.weight"] = blocks["mlp"][n]["kernel"][i].T
        for j in (1, 2):
            sd[f"trunk.layers.{i}.layer_norm{j}.weight"] = blocks[f"layer_norm{j}"]["scale"][i]
            sd[f"trunk.layers.{i}.layer_norm{j}.bias"] = blocks[f"layer_norm{j}"]["bias"][i]
            sd[f"trunk.layers.{i}.layer_scale{j}.lambda1"] = blocks[f"ls{j}"][i]
    sd = {k: np.ascontiguousarray(v) for k, v in sd.items()}
    got = PGA.torch_genlap_to_params({k: torch.from_numpy(v) for k, v in sd.items()})
    want = JGA.torch_genlap_to_params(sd, jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(g, np.asarray(w))
    model = PGA.GenLapModel(cfg)
    model.load_state_dict(params_from_jax(got, cfg), strict=True)
    pp, val = factory.generative_transforms(model)
    assert pp is val and pp.cfg is cfg.audio_cfg
