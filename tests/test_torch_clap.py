"""The port's CLAP slice (HTSAT audio tower, log-mel, audio preprocess, train step,
CLI, zero-shot) against the JAX package, on the CPU.

A micro HTSAT (spec 64, 32 mel bins: a 16x16 token map, windows of 8, shifted in
stage 0; widths 16-128; heads 2-4), registered as size ``micro`` in both packages'
``HTSAT_CONFIGS``, gets its params from the JAX package's ``init_clip``;
``params_from_jax`` carries them into the port. Inputs from a numpy seed, fp32;
the CPU takes the dense window attention in both packages. Tolerances: log-mel 1e-4
absolute on values of tens of dB (an fp32 DFT of 256 terms, squared); features and
HTSAT outputs 1e-4 (fp32 sums in other orders through 8 blocks); losses 1e-5 and
gradients 2e-6 + 1e-4 relative, parameters 2e-2 * lr per step, as for the CLIP
train step (``tests/test_torch_train_step.py``).
"""

import json
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.convert import convert_params_dtype
from open_clip_tpu.data import audio as jaudio_data
from open_clip_tpu.models import clap as jclap
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import htsat as jhtsat
from open_clip_tpu.ops import audio as jaudio
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import convert_params_dtype_, params_from_jax
from open_clip_tpu_torch.data import audio as paudio_data
from open_clip_tpu_torch.models import clap as pclap
from open_clip_tpu_torch.models import htsat as phtsat
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.ops import audio as paudio
from open_clip_tpu_torch.train import audio_zero_shot as pzs
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts
from open_clip_tpu_torch.train.main import main

MICRO = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), spec_size=64)
AUDIO = {"model_type": "HTSAT", "model_name": "micro", "sample_rate": 16000, "window_size": 256,
         "hop_size": 64, "mel_bins": 32, "fmin": 50, "fmax": 8000, "clip_samples": 8000,
         "class_num": 10}
CFG = {"embed_dim": 32, "audio_cfg": AUDIO,
       "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2}}
NAME = "tiny-torch-clap"
LR, WARMUP, CLIP = 1e-3, 2, 1.0
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def micro_htsat():
    for configs in (jclap.HTSAT_CONFIGS, pclap.HTSAT_CONFIGS):
        configs["micro"] = MICRO
    if NAME not in oc.list_models():
        oc.add_model_config(json.loads(json.dumps(CFG)), name=NAME)
    yield
    for configs in (jclap.HTSAT_CONFIGS, pclap.HTSAT_CONFIGS):
        configs.pop("micro", None)


@pytest.fixture(scope="module")
def setup(micro_htsat):
    jcfg = JaxCfg.from_dict(CFG)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jclip.init_clip(k, jcfg))(
        jax.random.PRNGKey(0)))
    cfg = oc.CLIPModelCfg.from_dict(CFG)
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal((BATCH, 8000))).astype(np.float32)
    wav[1, :4000] = 0.3 * np.sin(np.arange(4000) * 0.05)
    texts = rng.integers(1, 49406, (BATCH, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(BATCH), rng.integers(2, 16, BATCH)] = 49407
    return jcfg, params, cfg, wav, texts


def _port_model(params, cfg, dtype=torch.float32):
    model = CLIPModel(cfg, compute_dtype=dtype)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _close(got, want, tol=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,n_mels,sr,fmax", [(256, 64, 32, 16000, 8000),
                                                      (1024, 480, 64, 48000, 14000)])
def test_log_mel_matches_jax(n_fft, hop, n_mels, sr, fmax):
    wav = (0.2 * np.random.default_rng(n_fft).standard_normal((2, 12000))).astype(np.float32)
    want = jaudio.log_mel_clap(jnp.asarray(wav), sample_rate=sr, n_fft=n_fft, hop_length=hop,
                               n_mels=n_mels, fmin=50, fmax=fmax)
    got = paudio.log_mel_clap(torch.from_numpy(wav), sample_rate=sr, n_fft=n_fft,
                              hop_length=hop, n_mels=n_mels, fmin=50, fmax=fmax)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    _close(got, want)
    np.testing.assert_array_equal(paudio.mel_filter_bank(sr, n_fft, n_mels, 50, fmax),
                                  jaudio.mel_filter_bank(sr, n_fft, n_mels, 50, fmax))
    np.testing.assert_array_equal(paudio._dft_basis(n_fft, n_fft), jaudio._dft_basis(n_fft, n_fft))


def test_true_fp32_restores_the_callers_settings():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with paudio.true_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("n_in,n_out", [(101, 128), (1001, 1024), (64, 64), (5, 9)])
def test_bicubic_matrix_matches_jax(n_in, n_out):
    np.testing.assert_array_equal(phtsat._bicubic_matrix(n_in, n_out),
                                  jhtsat._bicubic_matrix(n_in, n_out))


@pytest.mark.parametrize("t,f,spec,ratio", [(101, 32, 64, 2), (128, 32, 64, 2), (1001, 64, 256, 4)])
def test_reshape_wav2img_matches_jax(t, f, spec, ratio):
    x = np.random.default_rng(t).standard_normal((2, 1, t, f)).astype(np.float32)
    _close(phtsat.reshape_wav2img(torch.from_numpy(x), spec, ratio),
           jhtsat.reshape_wav2img(jnp.asarray(x), spec, ratio), tol=1e-5)


def test_relative_index_and_shift_mask_match_jax():
    for ws in (2, 7, 8):
        np.testing.assert_array_equal(phtsat.relative_position_index(ws),
                                      jhtsat.relative_position_index(ws))
    for h, w, ws, shift in ((16, 16, 8, 4), (56, 56, 7, 3), (14, 14, 7, 3), (8, 8, 8, 0)):
        a, b = phtsat.shifted_window_mask(h, w, ws, shift), jhtsat.shifted_window_mask(h, w, ws, shift)
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("fill", ["repeatpad", "repeat", "pad"])
@pytest.mark.parametrize("trunc", ["rand_trunc", "trunc"])
def test_audio_preprocess_matches_jax(fill, trunc):
    """Every fill and truncation mode, a stereo clip at another rate (mono mix,
    resample), an int16 round trip, the random window seeded alike."""
    rng = np.random.default_rng(7)
    clips = [(rng.standard_normal(3000).astype(np.float32), 16000),        # short: filled
             (rng.standard_normal((2, 9000)).astype(np.float32), 16000),   # stereo, long
             (0.5 * rng.standard_normal(5000).astype(np.float32), 8000),   # resampled to 10000
             (rng.standard_normal(8000).astype(np.float32), 16000)]        # exactly one clip
    for int16 in (False, True):
        kw = dict(data_fill=fill, data_trunc=trunc, int16_normalize=int16)
        mine, theirs = paudio_data.AudioPreprocess(AUDIO, **kw), jaudio_data.AudioPreprocess(AUDIO, **kw)
        for clip in clips:
            random.seed(3)
            got = mine(clip)
            random.seed(3)
            want = theirs(clip)
            assert set(got) == {"waveform", "longer"}
            np.testing.assert_array_equal(got["waveform"], want["waveform"])
            assert bool(got["longer"]) == bool(want["longer"])
            assert got["waveform"].dtype == np.float32 and got["waveform"].shape == (8000,)


def test_audio_transform_v2_modes():
    train = paudio_data.audio_transform_v2(AUDIO, is_train=True, audio_aug_cfg={"data_fill": "pad"})
    val = paudio_data.audio_transform_v2(AUDIO, is_train=False)
    assert (train.data_trunc, train.data_fill, val.data_trunc) == ("rand_trunc", "pad", "trunc")
    with pytest.raises(NotImplementedError, match="fusion"):
        paudio_data.audio_transform_v2(dict(AUDIO, enable_fusion=True))
    with pytest.raises(NotImplementedError, match="webdataset"):
        paudio_data.make_wds_audio_pipeline()


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------

def test_htsat_outputs_match_jax(setup):
    """All four outputs of ``apply_htsat`` (kwargs as it takes them)."""
    jcfg, params, cfg, wav, _ = setup
    model = _port_model(params, cfg).eval()
    apply = jax.jit(lambda p, w: jhtsat.apply_htsat(p, jcfg.audio_cfg, {"waveform": w}, **MICRO))
    want = apply(params["audio"]["encoder"], wav)
    with torch.no_grad():
        got = phtsat.apply_htsat(model.audio.encoder, {"waveform": torch.from_numpy(wav)})
        emb = model.audio.encoder({"waveform": torch.from_numpy(wav)})
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        _close(got[key], want[key])
    _close(emb, want["embedding"])


def test_clap_encode_and_forward_match_jax(setup):
    jcfg, params, cfg, wav, texts = setup
    model = _port_model(params, cfg).eval()
    jp = jax.tree.map(jnp.asarray, params)
    audio = {"waveform": jnp.asarray(wav), "longer": jnp.zeros(BATCH, bool)}
    want = jax.jit(lambda p, a, t: jclip.clip_forward(p, jcfg, a, t, compute_dtype=jnp.float32))(
        jp, audio, jnp.asarray(texts))
    with torch.no_grad():
        got = oc.clip_forward(model, {k: torch.from_numpy(np.asarray(v)) for k, v in audio.items()},
                              torch.from_numpy(texts))
        raw = model.encode_audio(wav)  # a bare waveform, unnormalized
    assert set(got) == set(want) == {"audio_features", "text_features", "logit_scale"}
    for key in want:
        _close(got[key], want[key])
    _close(raw, jax.jit(lambda p, w: jclap.encode_audio(p, jcfg, {"waveform": w}))(jp, wav))


def test_state_dict_keys_are_the_reference_names(setup):
    _, params, cfg, _, _ = setup
    keys = set(params_from_jax(params, cfg))
    for key in ("audio.encoder.layers.0.blocks.1.attn.qkv.weight",
                "audio.encoder.layers.0.blocks.1.attn.relative_position_bias_table",
                "audio.encoder.layers.2.downsample.reduction.weight", "audio.encoder.bn0.running_var",
                "audio.encoder.patch_embed.proj.weight", "audio.encoder.tscam_conv.weight",
                "audio.proj.0.weight", "audio.proj.2.bias", "token_embedding.weight",
                "transformer.resblocks.1.attn.in_proj_weight", "logit_scale"):
        assert key in keys, key
    assert keys == set(CLIPModel(cfg).state_dict())


def test_pure_bf16_casts_what_the_jax_package_casts(setup):
    """convert_params_dtype_ casts the leaves the JAX package's convert_params_dtype
    casts, and no others."""
    _, params, cfg, _, _ = setup
    marks = jax.tree.map(lambda x: np.full(np.shape(x), float(x.dtype == jnp.bfloat16), np.float32),
                         convert_params_dtype(params, jnp.bfloat16))
    theirs = {k: bool(v.flatten()[0]) for k, v in params_from_jax(marks, cfg).items()}
    model = convert_params_dtype_(_port_model(params, cfg), torch.bfloat16)
    mine = {k: v.dtype == torch.bfloat16 for k, v in model.state_dict().items()}
    assert mine == theirs
    assert mine["audio.encoder.layers.0.blocks.0.attn.qkv.weight"]
    assert not mine["audio.encoder.bn0.running_var"]


def test_unported_audio_towers_raise():
    for acfg in ({"model_type": "whisper", "model_name": "tiny"},
                 {"model_type": "naflexvit", "model_name": "tiny"},
                 dict(AUDIO, enable_fusion=True)):
        cfg = oc.CLIPModelCfg.from_dict({"embed_dim": 32, "audio_cfg": acfg, "text_cfg": CFG["text_cfg"]})
        with pytest.raises(NotImplementedError):
            CLIPModel(cfg)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(wav, texts):
    return {"audio": {"waveform": torch.from_numpy(wav), "longer": torch.zeros(len(wav), dtype=torch.bool)},
            "text": torch.from_numpy(texts)}


def _assert_tensors_close(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for key in want:
        a, b = got[key].detach().float().numpy(), want[key].float().numpy()
        diff = np.abs(a - b).max()
        assert diff <= atol + rtol * np.abs(b).max(), (key, diff)


def _states(params, cfg, wd, jcfg):
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=wd, grad_clip_norm=CLIP), jparams,
                                   jsched.const_lr(LR, WARMUP))
    model = _port_model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=wd, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    return jts.create_train_state(jparams, jopt), jopt, pts.create_train_state(model, opt), opt


def test_one_and_three_steps_match_jax(setup):
    """Loss, grad_norm, gradients (through the first step) and parameters after steps
    1 and 3. Weight decay 0: the JAX package's mask skips every Swin block weight
    (see test_weight_decay_mask_of_the_swin_blocks)."""
    jcfg, params, cfg, wav, texts = setup
    jstate, jopt, state, opt = _states(params, cfg, 0.0, jcfg)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32))
    jbatch = {"audio": {"waveform": jnp.asarray(wav), "longer": jnp.zeros(BATCH, bool)},
              "text": jnp.asarray(texts)}
    step = pts.make_train_step(cfg, opt)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        state, m = step(state, _batch(wav, texts))
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        if i in (0, 2):
            want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
            _assert_tensors_close(state.model.state_dict(), want, atol=2e-2 * LR * (i + 1))


def test_gradients_match_jax(setup):
    """Every gradient the loss reaches; the token-semantic head, which it does not
    reach, has zero gradients in JAX and is what ``params_outside_loss`` names."""
    jcfg, params, cfg, wav, texts = setup
    from open_clip_tpu.loss import clip_loss as jax_clip_loss

    def loss_fn(p):
        out = jclip.clip_forward(p, jcfg, {"waveform": jnp.asarray(wav)}, jnp.asarray(texts),
                                 compute_dtype=jnp.float32)
        return jax_clip_loss(out["audio_features"], out["text_features"],
                             jnp.exp(p["logit_scale"]))

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    model = _port_model(params, cfg)
    out = oc.clip_forward(model, {"waveform": torch.from_numpy(wav)}, torch.from_numpy(texts))
    loss = oc.clip_loss(out["audio_features"], out["text_features"], model.logit_scale.exp())
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    outside = model.params_outside_loss()
    assert outside == {k for k, p in model.named_parameters() if p.grad is None}
    assert outside and all(not want[k].any() for k in outside)
    got = {k: p.grad for k, p in model.named_parameters() if k not in outside}
    _assert_tensors_close(got, {k: v for k, v in want.items() if k not in outside},
                          atol=2e-6, rtol=1e-4)


def test_accumulation_equals_the_simple_step(setup):
    """GradCache over 2 microbatches slices the waveform dict entry by entry."""
    _, params, cfg, wav, texts = setup
    results = []
    for accum in (1, 2):
        model = _port_model(params, cfg)
        opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=0.0, grad_clip_norm=CLIP),
                                      model, psched.const_lr(LR, WARMUP))
        state, m = pts.make_train_step(cfg, opt, accum_steps=accum)(
            pts.create_train_state(model, opt), _batch(wav, texts))
        results.append((state.model.state_dict(), m))
    (s1, m1), (s2, m2) = results
    assert m2["loss"].item() == pytest.approx(m1["loss"].item(), rel=1e-6)
    assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(), rel=1e-5)
    _assert_tensors_close(s2, s1, atol=2e-2 * LR)


def test_weight_decay_mask_of_the_swin_blocks(setup):
    """The JAX package's mask takes a leaf under ``blocks`` for a stacked layer and
    so skips every Swin block weight (a fault of the reference, ROADMAP Queue C); the
    port decays them, as the upstream reference does. Both skip the relative-position
    table, norms and biases, and decay the patch embedding and projections."""
    _, params, cfg, _, _ = setup
    jmask = params_from_jax(jax.tree.map(lambda m, x: np.full(np.shape(x), float(m), np.float32),
                                         joptim.wd_mask(params), params), cfg)
    jmask = {k: bool(v.flatten()[0]) for k, v in jmask.items()}
    mine = poptim.wd_mask(_port_model(params, cfg))
    differ = {k for k in mine if mine[k] != jmask[k]}
    assert differ == {k for k in mine if ".blocks." in k and k.startswith("audio.")
                      and k.endswith(".weight") and "norm" not in k}
    for key in ("audio.encoder.layers.0.blocks.0.attn.relative_position_bias_table",
                "audio.encoder.bn0.running_mean", "audio.encoder.layers.0.blocks.0.norm1.weight"):
        assert not mine[key] and not jmask[key]
    for key in ("audio.encoder.patch_embed.proj.weight", "audio.proj.0.weight",
                "audio.encoder.layers.0.downsample.reduction.weight"):
        assert mine[key] and jmask[key]


def test_synthetic_audio_cli_with_resume(tmp_path):
    args = ["--model", NAME, "--dataset-type", "synthetic-audio", "--train-num-samples", "8",
            "--batch-size", "4", "--lr", "1e-3", "--warmup", "1", "--precision", "fp32",
            "--logs", str(tmp_path), "--name", "clap", "--device", "cpu",
            "--log-every-n-steps", "1", "--audio-fill", "repeat"]
    state = main(args + ["--epochs", "1"])
    run = tmp_path / "clap"
    assert state.step == 2 and (run / "checkpoints" / "epoch_1.pt").exists()
    rows = [json.loads(line) for line in (run / "results.jsonl").read_text().splitlines()]
    # identical samples: the loss is ln(batch) whatever the weights
    assert all(r["train/loss"] == pytest.approx(math.log(4), abs=1e-4) for r in rows)
    state = main(args + ["--epochs", "2", "--resume", "latest"])
    assert state.step == 4 and (run / "checkpoints" / "epoch_2.pt").exists()
    assert "audio_fill: repeat" in (run / "params.txt").read_text()


def test_unported_audio_flags_raise():
    from open_clip_tpu_torch.train.params import parse_args

    for flag in (["--audio-fusion"], ["--audio-ext", "wav"], ["--audio-zeroshot-dataset", "x"]):
        with pytest.raises(NotImplementedError):
            parse_args(["--model", NAME] + flag)
    ns = parse_args(["--model", NAME, "--audio-trunc", "trunc", "--audio-int16-normalize"])
    assert (ns.audio_trunc, ns.audio_int16_normalize) == ("trunc", True)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_factory_gives_the_audio_preprocess_pair(micro_htsat):
    model, pp_train, pp_val = oc.create_model_and_transforms(NAME, device="cpu")
    assert isinstance(pp_train, paudio_data.AudioPreprocess) and pp_train.data_trunc == "rand_trunc"
    assert pp_val.data_trunc == "trunc"
    tok = oc.get_tokenizer("CLAP-HTSAT-tiny")
    assert tok.context_length == 77
    with pytest.raises(NotImplementedError, match="pretrained"):
        oc.create_model(NAME, pretrained="laion", device="cpu")
    with pytest.raises(ValueError, match="encode_audio"):
        model.encode_image(torch.zeros(1, 32, 32, 3))


def test_audio_zero_shot_matches_a_direct_computation(setup):
    _, params, cfg, wav, _ = setup
    model = _port_model(params, cfg).eval()
    tok = oc.get_tokenizer(NAME)
    classes = ["dog", "rain", "siren", "engine", "bird", "clock"]
    labels = np.array([0, 3, 5, 1])
    loader = [{"audio": {"waveform": wav[:2]}, "label": labels[:2]},
              {"audio": {"waveform": wav[2:]}, "label": labels[2:]}]
    from open_clip_tpu_torch.data.datasets import DataInfo

    class Loader(list):
        classnames = classes

    data = {"audio-zeroshot": DataInfo(Loader(loader))}
    got = pzs.audio_zero_shot_eval(model, data, epoch=1, tokenizer=tok)
    clf = oc.build_zero_shot_classifier(model, tok, classes, pzs.ESC50_TEMPLATES)
    with torch.no_grad():
        logits = 100 * model.encode_audio(wav, normalize=True) @ clf
    order = logits.argsort(dim=-1, descending=True).numpy()
    assert got["audio-zeroshot-top1"] == pytest.approx(float((order[:, 0] == labels).mean()))
    assert got["audio-zeroshot-top5"] == pytest.approx(
        float((order[:, :5] == labels[:, None]).any(axis=1).mean()))
    templates = pzs.parse_templates("the sound of {}|a recording: ")
    assert [t("rain") for t in templates] == ["the sound of rain", "a recording: rain"]
    with pytest.raises(NotImplementedError):
        pzs.build_audio_zero_shot_dataset("folder:/nowhere", None)
