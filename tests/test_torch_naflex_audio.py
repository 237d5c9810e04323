"""The port's NaFlex audio CLAP (the GenLIP trunk, the NaFlex audio encoder, its
patchify and its train step) against the JAX package, on the CPU.

Micro CLAPs (16 kHz, 32 mel bins, 8 x 4 mel patches; a 2-layer trunk of width 64;
a 2-layer modern text tower of width 32) get their params from the JAX package's
``init_clip``; ``params_from_jax`` carries them into the port. Two trunks: gated
attention, LayerNorm, the GELU MLP with biases (the naflexclap configs' settings)
at head width 32; and one head of 64 with qk-norm, RMSNorm, SwiGLU, LayerScale and
no biases. Inputs from a numpy seed through the JAX patchify: clips of different
lengths, so every batch is ragged. fp32.

Tolerances: the patchify and the position ids bit for bit; cos/sin tables 2e-6
(positions up to 50 rad, the two libraries' fp32 cos); features, losses and
``grad_norm`` 1e-5 relative (2e-5 on the flash path's valid rows, whose plain
version sums its softmax in another order than the Pallas kernel); parameters
after a step within 2e-2 * lr per step taken, as for the CLIP train step
(``tests/test_torch_train_step.py``).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_clip_tpu.ops.flash_attention as jfa
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.config import parse_model_cfg as jax_parse_model_cfg
from open_clip_tpu.convert import convert_params_dtype
from open_clip_tpu.data import naflex_audio as jdata
from open_clip_tpu.models import blocks as jblocks
from open_clip_tpu.models import clap as jclap
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import genlap as jgenlap
from open_clip_tpu.models import genlip as jgenlip
from open_clip_tpu.models import naflex_audio as jna
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import convert as pconv
from open_clip_tpu_torch.config import parse_model_cfg
from open_clip_tpu_torch.convert import convert_params_dtype_, params_from_jax
from open_clip_tpu_torch.data import naflex_audio as pdata
from open_clip_tpu_torch.models import blocks as pblocks
from open_clip_tpu_torch.models import clap as pclap
from open_clip_tpu_torch.models import genlap as pgenlap
from open_clip_tpu_torch.models import genlip as pgenlip
from open_clip_tpu_torch.models import naflex_audio as pna
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.ops import flash_attention as pfa
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

AUDIO = {"model_type": "naflexvit", "sample_rate": 16000, "window_size": 256, "hop_size": 64,
         "mel_bins": 32, "fmin": 50, "fmax": 8000, "patch_freq": 8, "patch_time": 4}
TRUNKS = {
    "gated": {"embed_dim": 64, "depth": 2, "num_heads": 2, "attn_gated": True,
              "init_values": 1e-5, "reg_tokens": 1, "pre_norm": True},
    "swiglu-qk": {"embed_dim": 64, "depth": 2, "num_heads": 1, "swiglu_mlp": True, "qk_norm": True,
                  "norm_type": "rmsnorm", "hidden_act": "silu", "ls_init_value": 0.1,
                  "attention_bias": False, "mlp_bias": False, "mlp_ratio": 2.0},
}
TEXT = {"text_arch": "modern", "context_length": 12, "vocab_size": 64, "width": 32, "heads": 2,
        "layers": 2, "mlp_ratio": 2.0, "pad_id": 0, "eos_id": 2, "pool_type": "map",
        "attention_mode": "bidirectional", "attn_gated": True, "qk_norm": True,
        "norm_type": "rmsnorm", "norm_eps": 1e-5, "variable_text": True}
TOKENS = 40  # 10 time columns of 4 frequency rows: 0.64 s at 16 kHz
LR, WARMUP, CLIP = 1e-3, 2, 1.0
BATCH = 4


def _raw(variant):
    return {"embed_dim": 32, "audio_cfg": {**AUDIO, "naflexvit_cfg": TRUNKS[variant]},
            "text_cfg": TEXT}


@functools.lru_cache(maxsize=None)
def _make(variant):
    raw = _raw(variant)
    jcfg = JaxCfg.from_dict(raw)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(raw)
    rng = np.random.default_rng(0)
    patchify = jdata.AudioNaFlexPatchify(jna.audio_naflex_cfg_from_clip_audio(jcfg.audio_cfg),
                                         max_audio_tokens=TOKENS)
    clips = [patchify((0.1 * rng.standard_normal(n).astype(np.float32), 16000))
             for n in (10000, 4000, 7000, 1200)]
    audio = {k: np.stack([c[k] for c in clips]) for k in clips[0]}
    text = rng.integers(3, 63, (BATCH, 12)).astype(np.int32)
    text[0, 7:] = 0
    text[1, 4] = 2
    return jcfg, params, cfg, audio, text


@pytest.fixture(scope="module", params=list(TRUNKS))
def setup(request):
    return _make(request.param)


def _port_model(params, cfg, dtype=torch.float32):
    model = CLIPModel(cfg, compute_dtype=dtype)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _close(got, want, rel=1e-5, floor=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got - want).max()
    assert diff <= rel * np.abs(want).max() + floor, diff


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the trunk's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,section,interleaved", [(64, (12, 10, 10), True), (32, (6, 5, 5), True),
                                                    (16, (4, 2, 2), True), (64, (16, 8, 8), False)])
def test_mrope_cos_sin_and_apply_match_jax(hd, section, interleaved):
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, 51, (3, 2, 30)).astype(np.int32)
    want = jgenlip.mrope_cos_sin(jnp.asarray(pos), hd, section, 10000.0, interleaved)
    got = pgenlip.mrope_cos_sin(torch.from_numpy(pos), hd, section, 10000.0, interleaved)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, rel=0, floor=2e-6)
    q, k = (rng.standard_normal((2, 30, 3, hd)).astype(np.float32) for _ in range(2))
    cos, sin = (np.array(t) for t in want)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        wq, wk = jgenlip.apply_mrope(jnp.asarray(q, jdtype), jnp.asarray(k, jdtype), jnp.asarray(cos),
                                     jnp.asarray(sin))
        gq, gk = pgenlip.apply_mrope(torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
                                     torch.from_numpy(cos), torch.from_numpy(sin))
        assert gq.dtype == dtype
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        _close(gq, np.asarray(wq.astype(jnp.float32)), rel=tol)
        _close(gk, np.asarray(wk.astype(jnp.float32)), rel=tol)


@pytest.mark.parametrize("rope_1d", [False, True])
@pytest.mark.parametrize("text_len", [0, 5])
def test_audio_position_ids_match_jax(rope_1d, text_len):
    rng = np.random.default_rng(text_len)
    coord = np.stack([rng.integers(0, 4, (3, 24)), rng.integers(0, 9, (3, 24))], -1).astype(np.int32)
    valid = np.arange(24)[None, :] < np.array([24, 10, 1])[:, None]
    tv = np.ones((3, text_len), bool) if text_len else None
    want = jgenlap.build_audio_position_ids(jnp.asarray(coord), jnp.asarray(valid),
                                            None if tv is None else jnp.asarray(tv), rope_1d)
    got = pgenlap.build_audio_position_ids(torch.from_numpy(coord), torch.from_numpy(valid),
                                           None if tv is None else torch.from_numpy(tv), rope_1d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_biases_and_trunk_mask_match_jax():
    rng = np.random.default_rng(5)
    pv = rng.random((3, 20)) < 0.7
    tv = rng.random((3, 6)) < 0.8
    np.testing.assert_array_equal(
        pgenlip.build_prefix_lm_bias(torch.from_numpy(pv), torch.from_numpy(tv)).numpy(),
        np.asarray(jgenlip.build_prefix_lm_bias(jnp.asarray(pv), jnp.asarray(tv))))
    np.testing.assert_array_equal(pgenlip.build_image_bias(torch.from_numpy(pv)).numpy(),
                                  np.asarray(jgenlip.build_image_bias(jnp.asarray(pv))))
    kv = np.concatenate([pv, tv], 1)
    for prefix in (0, 20):  # on the CPU: the dense bias, as JAX off the TPU
        want = jgenlip.trunk_mask(prefix, jnp.asarray(kv), 26, 64)
        got = pgenlip.trunk_mask(prefix, torch.from_numpy(kv), 26, 64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the card's gate is the TPU's: 512 or more tokens, a head width of 64 or 128
    assert pgenlip.flash_ok(True, 816, 8, 64) and pgenlip.flash_ok(True, 512, 12, 128)
    for args in ((True, 511, 8, 64), (True, 816, 16, 32), (True, 816, 4, 192), (False, 816, 8, 64)):
        assert not pgenlip.flash_ok(*args), args


# ---------------------------------------------------------------------------
# the patchify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["naflexclap_mediumd_pf4_pt20_moderntextp", "naflexclap_test",
                                  "naflexclap_base_pf8_pt20_moderntextp"])
def test_patchify_matches_jax_bit_for_bit(name):
    """Clips of 0.01 to 12 s at 16, 44.1 and 48 kHz, mono and stereo, through the
    config's patchify with and without its 10 s token cap."""
    acfg = parse_model_cfg(name).audio_cfg
    jacfg = jna.audio_naflex_cfg_from_clip_audio(jax_parse_model_cfg(name).audio_cfg)
    pacfg = pna.audio_naflex_cfg_from_clip_audio(acfg)
    assert pacfg.__dict__ == jacfg.__dict__
    n = jdata.naflex_audio_eval_seq_len(jacfg)
    assert pdata.naflex_audio_eval_seq_len(pacfg) == n == acfg.audio_seq_len
    rng = np.random.default_rng(11)
    for cap in (n, None):
        mine, theirs = pdata.AudioNaFlexPatchify(pacfg, cap), jdata.AudioNaFlexPatchify(jacfg, cap)
        for seconds, sr, channels in ((0.01, 48000, 1), (0.5, 16000, 2), (3.3, 44100, 1),
                                      (10.0, 48000, 2), (12.0, 48000, 1), (7.7, 16000, 1)):
            shape = (channels, int(seconds * sr)) if channels > 1 else (int(seconds * sr),)
            wav = (0.3 * rng.standard_normal(shape)).astype(np.float32)
            got, want = mine((wav, sr)), theirs((wav, sr))
            assert set(got) == set(want) == {"patches", "patch_coord", "patch_valid"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    assert n == {"naflexclap_mediumd_pf4_pt20_moderntextp": 816, "naflexclap_test": 251,
                 "naflexclap_base_pf8_pt20_moderntextp": 408}[name]


@pytest.mark.parametrize("mode", ["floor", "silence", "repeat"])
def test_mel_to_patches_and_pad_match_jax(mode):
    mel = np.random.default_rng(3).standard_normal((2, 29, 32)).astype(np.float32)
    for pf in (8, 32):
        got = pdata.mel_to_patches(mel, pf, 4, in_chans=2, pad_mode=mode)
        want = jdata.mel_to_patches(mel, pf, 4, in_chans=2, pad_mode=mode)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        for n in (5, 64):
            a, b = pdata.pad_patch_dict(got, n), jdata.pad_patch_dict(want, n)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def test_features_match_jax(setup):
    jcfg, params, cfg, audio, text = setup
    model = _port_model(params, cfg).eval()
    jp = jax.tree.map(jnp.asarray, params)
    want = jax.jit(lambda p, a, t: jclip.clip_forward(p, jcfg, a, t))(jp, audio, text)
    raw = jax.jit(lambda p, a: jclap.encode_audio(p, jcfg, a))(jp, audio)
    with torch.no_grad():
        got = oc.clip_forward(model, _torch(audio), torch.from_numpy(text))
        got_raw = model.encode_audio(audio)
    assert set(got) == set(want) == {"audio_features", "text_features", "logit_scale"}
    for key in want:
        _close(got[key], want[key])
    _close(got_raw, raw)


def test_padding_changes_no_feature(setup):
    """Tokens past a clip's valid ones (more padding) leave its features as they are."""
    _, params, cfg, audio, _ = setup
    model = _port_model(params, cfg).eval()
    wider = {k: np.asarray(torch.from_numpy(v)) for k, v in audio.items()}
    wider = {k: np.concatenate([v, np.zeros_like(v[:, :8])], axis=1) for k, v in wider.items()}
    with torch.no_grad():
        _close(model.encode_audio(wider), model.encode_audio(audio), rel=2e-6)


def test_flash_path_matches_jax_kernels_on_valid_rows(monkeypatch):
    """The structured mask (the card's path at 512 tokens and more) through the
    port's flash kernels' plain versions, against the JAX trunk on the Pallas kernels
    in interpret mode: L = 200 (not a multiple of any block), ragged validity, head
    width 64. Outputs and the input's gradient on the valid rows; every parameter's
    gradient (the padded rows get no cotangent)."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    acfg = oc.CLIPModelCfg.from_dict(_raw("swiglu-qk")).audio_cfg
    tcfg_p = pna._trunk_cfg_from_audio(acfg)
    tcfg_j = jna._trunk_cfg_from_audio(JaxCfg.from_dict(_raw("swiglu-qk")).audio_cfg)
    proxy = jgenlip.GenLipModelCfg(embed_dim=64, vision_cfg=jgenlip.GenLipVisionCfg(),
                                   text_cfg=jgenlip.GenLipTextCfg(vocab_size=8, pad_id=0, bos_id=1,
                                                                  eos_id=2), trunk_cfg=tcfg_j)
    trunk_params = jax.tree.map(np.asarray, jgenlip.init_genlip(jax.random.PRNGKey(3), proxy)["trunk"])
    b, l = 2, 200
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, l, 64)).astype(np.float32)
    valid = np.arange(l)[None, :] < np.array([l, 131])[:, None]
    coord = np.stack([np.arange(l) % 4, np.arange(l) // 4], -1)[None].repeat(b, 0).astype(np.int32)
    pos = jgenlap.build_audio_position_ids(jnp.asarray(coord), jnp.asarray(valid))
    cos, sin = jgenlip.mrope_cos_sin(pos, 64, tcfg_j.mrope_section)
    ct = rng.standard_normal((b, l, 64)).astype(np.float32) * valid[..., None]

    def run(p, xx):
        return jgenlip.apply_trunk(p, tcfg_j, xx, ("prefix", 0, jnp.asarray(valid)), cos, sin)

    want, vjp = jax.vjp(run, jax.tree.map(jnp.asarray, trunk_params), jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(ct))

    trunk = pgenlip.GenLipTrunk(tcfg_p)
    trunk.load_state_dict(_trunk_state(trunk_params, tcfg_p.depth), strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    before = dict(pfa.LAUNCHES)
    got = trunk(tx, ("prefix", 0, torch.from_numpy(valid)), torch.from_numpy(np.asarray(cos)),
                torch.from_numpy(np.asarray(sin)))
    got.backward(torch.from_numpy(ct))
    assert pfa.LAUNCHES == before  # the plain versions, no launch on the CPU
    rows = torch.from_numpy(valid)
    _close(got[rows], np.asarray(want)[valid], rel=2e-5)
    _close(tx.grad[rows], np.asarray(want_dx)[valid], rel=2e-5)
    want_grads = _trunk_state(jax.tree.map(np.asarray, want_dp), tcfg_p.depth)
    for name, p in trunk.named_parameters():
        _close(p.grad, want_grads[name], rel=2e-5, floor=1e-7)


def _trunk_state(tree, depth):
    """A JAX trunk tree as ``GenLipTrunk``'s state dict."""
    out = {}
    pconv._stacked(tree["blocks"], pconv._TRUNK_BLOCK, depth, "resblocks.", out)
    pconv._norm(tree["ln_post"], "ln_post", out)
    return out


def _cfg_only(variant):
    return oc.CLIPModelCfg.from_dict(_raw(variant))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _states(params, cfg, wd=0.1):
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=wd, grad_clip_norm=CLIP), jparams,
                                   jsched.const_lr(LR, WARMUP))
    model = _port_model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=wd, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    return jts.create_train_state(jparams, jopt), jopt, pts.create_train_state(model, opt), opt


def _assert_state_close(state, jparams, cfg, atol):
    want = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        diff = (got[k].float() - w).abs().max().item()
        assert diff <= atol, (k, diff)


@pytest.mark.parametrize("variant,mode", [("gated", "plain"), ("swiglu-qk", "plain"),
                                          ("gated", "gradcache"), ("swiglu-qk", "names_mm"),
                                          ("gated", "names"), ("swiglu-qk", "full")])
def test_train_steps_match_jax(variant, mode):
    """Two steps of the plain step, GradCache over 2 microbatches, and remat: full, and
    the ``names`` and ``names_mm`` presets (the trunk's ``remat_qkv``/
    ``remat_attn_ctx``/``remat_fc1`` tags; the text tower's full remat), each against
    the JAX ``make_train_step`` with the same settings."""
    jcfg, params, cfg, audio, text = _make(variant)
    kw = {"gradcache": {"accum_steps": 2}}.get(mode, {"remat": True} if mode != "plain" else {})
    saved = jblocks.REMAT_POLICY, pblocks.REMAT_POLICY
    jblocks.REMAT_POLICY = pblocks.REMAT_POLICY = mode if mode.startswith("names") else "none"
    try:
        jstate, jopt, state, opt = _states(params, cfg)
        jstep = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32, **kw))
        step = pts.make_train_step(cfg, opt, **kw)
        jbatch = {"audio": {k: jnp.asarray(v) for k, v in audio.items()}, "text": jnp.asarray(text)}
        for i in range(2):
            jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
            state, m = step(state, {"audio": _torch(audio), "text": torch.from_numpy(text)})
            for key in ("loss", "grad_norm", "logit_scale"):
                assert m[key].item() == pytest.approx(float(jm[key]), rel=1e-5), (i, key)
            _assert_state_close(state, jstate.params, cfg, atol=2e-2 * LR * (i + 1))
    finally:
        jblocks.REMAT_POLICY, pblocks.REMAT_POLICY = saved


def _jax_marks_by_port_name(tree, params, cfg):
    return {k: bool(v.flatten()[0]) for k, v in params_from_jax(
        jax.tree.map(lambda m, x: np.full(np.shape(x), float(m), np.float32), tree, params),
        cfg).items()}


def test_weight_decay_mask_and_pure_bf16_partition_match_jax(setup):
    _, params, cfg, _, _ = setup
    model = _port_model(params, cfg)
    mine = poptim.wd_mask(model)
    assert mine == _jax_marks_by_port_name(joptim.wd_mask(params), params, cfg)
    assert mine["audio.encoder.trunk.resblocks.1.attn.q_proj.weight"]
    assert mine["audio.encoder.patch_embed.proj.weight"]
    assert not mine["audio.encoder.attn_pool.latent"]
    assert not mine["audio.encoder.trunk.resblocks.0.layer_norm1.weight"]
    cast = jax.tree.map(lambda x: x.dtype == jnp.bfloat16, convert_params_dtype(params, jnp.bfloat16))
    convert_params_dtype_(model, torch.bfloat16)
    assert ({k: v.dtype == torch.bfloat16 for k, v in model.state_dict().items()}
            == _jax_marks_by_port_name(cast, params, cfg))


def test_layer_decay_scales_match_jax(setup):
    """Layer-wise lr decay per tensor: the modern text tower's layers on the JAX
    ladder, the audio tower (no stacked ``blocks`` at its top in the JAX tree) at 1."""
    _, params, cfg, _, _ = setup
    model = _port_model(params, cfg)
    jscales = joptim.layer_decay_scales(params, 0.75)
    want = params_from_jax(jax.tree.map(
        lambda sc, x: np.broadcast_to(np.asarray(sc, np.float32), np.shape(x)), jscales, params), cfg)
    got = poptim.layer_decay_scales(model, 0.75)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(torch.broadcast_to(torch.as_tensor(got[name]), p.shape).numpy(),
                                   want[name].numpy(), rtol=1e-6, err_msg=name)
    assert got["audio.encoder.trunk.resblocks.0.attn.q_proj.weight"] == 1.0
    assert got["text.transformer.resblocks.0.attn.qkv.weight"] == pytest.approx(0.75 ** 2)


def test_encoder_init_follows_the_jax_distributions():
    """The port's own init (no JAX weights): the trunk's xavier bounds, zero
    attention biases, unit norms; the patch embedding's 0.02; the pool latent's
    width ** -0.5."""
    cfg = _cfg_only("gated")
    model = CLIPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    enc = model.audio.encoder
    q = enc.trunk.resblocks[0].attn.q_proj
    bound = (6.0 / (64 + 128)) ** 0.5
    assert q.weight.abs().max() <= bound and q.weight.abs().max() > 0.9 * bound
    assert not q.bias.any() and (enc.trunk.ln_post.weight == 1).all()
    assert enc.patch_embed["proj"].weight.std().item() == pytest.approx(0.02, rel=0.1)
    assert enc.attn_pool.latent.std().item() == pytest.approx(64 ** -0.5, rel=0.3)
    assert enc.trunk.resblocks[0].mlp.fc1.bias.abs().max() < 1e-5


# ---------------------------------------------------------------------------
# the registry and the reference's faults
# ---------------------------------------------------------------------------

NAFLEXCLAP_CONFIGS = ["naflexclap_base_pf4_pt20_moderntextp", "naflexclap_base_pf8_pt16_moderntext",
                      "naflexclap_base_pf8_pt16_moderntextp", "naflexclap_base_pf8_pt20_moderntextp",
                      "naflexclap_little", "naflexclap_little_roberta", "naflexclap_mediumd",
                      "naflexclap_mediumd_pf4_pt20_moderntextp", "naflexclap_mediumd_roberta",
                      "naflexclap_test"]


@pytest.mark.parametrize("name", NAFLEXCLAP_CONFIGS)
def test_registry_configs_build_with_the_jax_parameter_count(name):
    """Eight build on the meta device with ``jax.eval_shape(init_clip)``'s parameter
    count; the ``_roberta`` pair needs an HF text tower built by name, which needs
    files that are not in the repository."""
    cfg = parse_model_cfg(name)
    if name.endswith("_roberta"):
        with pytest.raises(NotImplementedError, match="HF text tower"):
            with torch.device("meta"):
                CLIPModel(cfg)
        return
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0), jax_parse_model_cfg(name)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = CLIPModel(cfg)
    assert sum(p.numel() for p in model.parameters()) == want
    assert isinstance(model.audio.encoder, pna.NaFlexAudioEncoder)


def test_trunk_cfg_ignores_four_settings_the_configs_set():
    """Reference fault the port follows: ``_trunk_cfg_from_audio`` reads neither
    ``init_values`` (LayerScale stays off: ``ls_init_value`` is what it reads),
    ``reg_tokens``, ``pre_norm`` nor ``attn_pool_mlp_ratio`` (the pool's MLP is
    always 4 x width), which the naflexclap configs set; the models build the same
    with them or without them, in both packages."""
    name = "naflexclap_base_pf8_pt20_moderntextp"  # sets all four
    raw = json.loads(json.dumps(oc.get_model_config(name)))
    kw = raw["audio_cfg"]["naflexvit_cfg"]
    assert {"init_values", "reg_tokens", "pre_norm", "attn_pool_mlp_ratio"} <= set(kw)
    stripped = json.loads(json.dumps(raw))
    for key in ("init_values", "reg_tokens", "pre_norm", "attn_pool_mlp_ratio"):
        stripped["audio_cfg"]["naflexvit_cfg"].pop(key)
    for mod, make in ((pna, oc.CLIPModelCfg.from_dict), (jna, JaxCfg.from_dict)):
        assert mod._trunk_cfg_from_audio(make(raw).audio_cfg) == \
            mod._trunk_cfg_from_audio(make(stripped).audio_cfg)
    with torch.device("meta"):
        model = CLIPModel(oc.CLIPModelCfg.from_dict(raw))
    assert model.audio.encoder.trunk.resblocks[0].ls1 is None
    assert model.audio.encoder.attn_pool.mlp["c_fc"].out_features == 4 * 768
    assert model.audio.encoder.trunk.resblocks[0].mlp.fc1.out_features == int(768 * 2.6666667)
    assert not hasattr(model.audio.encoder, "reg_tokens")


def test_naflexvit_checkpoints_have_no_converter_in_either_package(setup):
    _, params, cfg, _, _ = setup
    jcfg = JaxCfg.from_dict(_raw("gated"))
    sd = {k: v.numpy() for k, v in _port_model(params, cfg).state_dict().items()}
    with pytest.raises(NotImplementedError):
        jclap.torch_clap_to_params(sd, jcfg)
    with pytest.raises(NotImplementedError, match="naflexvit"):
        pclap.torch_clap_to_params(sd, cfg)


def test_factory_gives_the_patchify_pair_and_a_waveform_is_refused():
    model, pp_train, pp_val = oc.create_model_and_transforms("naflexclap_test", device="cpu")
    assert pp_train is pp_val and isinstance(pp_val, pdata.AudioNaFlexPatchify)
    assert pp_val.max_audio_tokens == 251
    with pytest.raises(ValueError, match="patch dict"):
        model.encode_audio(np.zeros((1, 48000), np.float32))
