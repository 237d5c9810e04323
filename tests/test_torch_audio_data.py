"""The port's audio data (the WAV decode, the audio webdataset pipeline, the WAV-folder
zero-shot and the ``webdataset-audio`` CLI) against the JAX package, on the CPU.

WAVs the test writes (scipy's writer, and the standard library's ``wave`` for
24-bit): every PCM width, float32 and float64, mono and stereo, at 16, 44.1 and
48 kHz. The decode agrees bit for bit; the pipelines' batches are equal (the same
shard order, shuffle buffer and random windows from one seed); zero-shot top-1 and
top-5 are equal on the same weights (a micro NaFlex-audio CLAP with the CLIP BPE
text tower). Also the three faults of the reference that the port follows.
"""

import io
import json
import random
import tarfile
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import open_clip_tpu as oct
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.data import audio as jaudio
from open_clip_tpu.data import naflex_audio as jnad
from open_clip_tpu.data.wds import WdsConfig as JWdsConfig
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import naflex_audio as jna
from open_clip_tpu.train import audio_zero_shot as jzs
from open_clip_tpu.zero_shot_classifier import build_zero_shot_classifier as jbuild

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.data import audio as paudio
from open_clip_tpu_torch.data import naflex_audio as pnad
from open_clip_tpu_torch.data.wds import WdsConfig
from open_clip_tpu_torch.models import naflex_audio as pna
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import audio_zero_shot as pzs
from open_clip_tpu_torch.train.main import main

NAME = "tiny-torch-naflexclap-bpe"
CFG = {"embed_dim": 32,
       "audio_cfg": {"model_type": "naflexvit", "sample_rate": 16000, "window_size": 256,
                     "hop_size": 64, "mel_bins": 32, "fmin": 50, "fmax": 8000, "patch_freq": 8,
                     "patch_time": 4, "naflexvit_cfg": {"embed_dim": 64, "depth": 1, "num_heads": 2,
                                                        "attn_gated": True}},
       "text_cfg": {"context_length": 16, "width": 32, "heads": 2, "layers": 1}}
HTSAT_AUDIO = {"model_type": "HTSAT", "sample_rate": 16000, "clip_samples": 8000}


@pytest.fixture(scope="module", autouse=True)
def registered():
    for pkg in (oc, oct):
        if NAME not in pkg.list_models():
            pkg.add_model_config(json.loads(json.dumps(CFG)), name=NAME)


def _wav_bytes(data, sr):
    buf = io.BytesIO()
    wavfile.write(buf, sr, data)
    return buf.getvalue()


def _wav24_bytes(ints, sr, channels):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(3)
        w.setframerate(sr)
        raw = np.frombuffer(ints.astype("<i4").tobytes(), np.uint8).reshape(-1, 4)[:, :3]
        w.writeframes(raw.tobytes())
    return buf.getvalue()


def _clip(rng, kind, n, channels):
    shape = (n, channels) if channels > 1 else (n,)
    x = rng.standard_normal(shape) * 0.2
    if kind == "uint8":
        return (x * 100 + 128).clip(0, 255).astype(np.uint8)
    if kind in ("int16", "int32"):
        return (x * (2 ** 15 if kind == "int16" else 2 ** 31)).astype(kind)
    return x.astype(kind)


def _wavs(seed=0):
    """(name, bytes) of every sample type, mono and stereo, at three rates."""
    rng = np.random.default_rng(seed)
    out = []
    for i, kind in enumerate(("uint8", "int16", "int24", "int32", "float32", "float64")):
        for channels in (1, 2):
            sr = (16000, 44100, 48000)[(i + channels) % 3]
            n = int(0.2 * sr) + i
            if kind == "int24":
                data = _wav24_bytes(rng.integers(-2 ** 23, 2 ** 23, n * channels), sr, channels)
            else:
                data = _wav_bytes(_clip(rng, kind, n, channels), sr)
            out.append((f"{kind}-{channels}ch-{sr}", data))
    return out


def test_decode_audio_bytes_matches_jax_bit_for_bit():
    for name, data in _wavs():
        got, sr = paudio.decode_audio_bytes(data, "wav")
        want, want_sr = jaudio.decode_audio_bytes(data, "wav")
        assert sr == want_sr and got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.ndim == (2 if "2ch" in name else 1)


def test_other_codecs_raise_the_jax_error():
    for ext in ("flac", "mp3"):
        errors = []
        for decode in (paudio.decode_audio_bytes, jaudio.decode_audio_bytes):
            with pytest.raises(RuntimeError) as err:
                decode(b"fLaC\x00\x00", ext)
            errors.append(str(err.value))
        assert errors[0] == errors[1] == f"cannot decode .{ext} audio without soundfile"
    with pytest.raises(ValueError, match="not a WAV"):
        paudio.decode_audio_bytes(b"fLaC" + bytes(40), "wav")


def test_eight_bit_wav_is_not_scaled_by_the_decode_but_is_by_read_wav(tmp_path):
    """Reference fault the port follows: ``decode_audio_bytes`` leaves 8-bit PCM as
    0..255 while ``_read_wav`` (the zero-shot folders) centres and scales it to
    [-1, 1), in both packages."""
    data = _wav_bytes(np.array([0, 64, 128, 192, 255], np.uint8), 16000)
    path = tmp_path / "u8.wav"
    path.write_bytes(data)
    for decode, read in ((paudio.decode_audio_bytes, pzs._read_wav),
                         (jaudio.decode_audio_bytes, jzs._read_wav)):
        np.testing.assert_array_equal(decode(data, "wav")[0], [0, 64, 128, 192, 255])
        np.testing.assert_array_equal(read(str(path))[0], [-1, -0.5, 0, 0.5, 127 / 128])


def test_read_wav_matches_jax(tmp_path):
    """8-, 16- and 32-bit PCM, mono and stereo; ``wave`` refuses float WAVs, and both
    readers refuse 24-bit samples."""
    for name, data in _wavs(1):
        path = tmp_path / f"{name}.wav"
        path.write_bytes(data)
        if name.startswith(("float", "int24")):
            for read in (pzs._read_wav, jzs._read_wav):
                with pytest.raises((wave.Error, ValueError)):
                    read(str(path))
            continue
        got, sr = pzs._read_wav(str(path))
        want, want_sr = jzs._read_wav(str(path))
        assert sr == want_sr
        np.testing.assert_array_equal(got, want, err_msg=name)


def _write_shards(root, n_shards=2, per_shard=5, with_flac=False):
    rng = np.random.default_rng(3)
    wavs = _wavs(4)
    urls = []
    for s in range(n_shards):
        path = root / f"audio-{s}.tar"
        with tarfile.open(path, "w") as tar:
            for i in range(per_shard):
                key = f"{s:02d}{i:03d}"
                name, data = wavs[(s * per_shard + i) % len(wavs)]
                members = {"txt": f"sound {key} {name}".encode()}
                if with_flac:
                    members["flac"] = bytes(rng.integers(0, 255, 64, dtype=np.uint8))
                else:
                    members["wav"] = data
                for ext, blob in members.items():
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(blob)
                    tar.addfile(info, io.BytesIO(blob))
        urls.append(str(path))
    return f"{root}/audio-{{0..{n_shards - 1}}}.tar"


def _pipelines(urls, batch_size, preprocess_pair, shuffle, partial):
    tok = oc.get_tokenizer(NAME)
    kw = dict(urls=urls, batch_size=batch_size, seed=5, shuffle_shards=2000 if shuffle else 0,
              shuffle_samples=4 if shuffle else 0, partial_batches=partial)
    return (paudio.make_wds_audio_pipeline(WdsConfig(**kw), preprocess_pair[0], tok, audio_ext="wav"),
            jaudio.make_wds_audio_pipeline(JWdsConfig(**kw), preprocess_pair[1], tok, audio_ext="wav"))


def _pairs():
    acfg = oc.CLIPModelCfg.from_dict(CFG).audio_cfg
    jacfg = JaxCfg.from_dict(CFG).audio_cfg
    return {
        "naflex": (pnad.AudioNaFlexPatchify(pna.audio_naflex_cfg_from_clip_audio(acfg), 48),
                   jnad.AudioNaFlexPatchify(jna.audio_naflex_cfg_from_clip_audio(jacfg), 48)),
        "htsat": (paudio.AudioPreprocess(HTSAT_AUDIO), jaudio.AudioPreprocess(HTSAT_AUDIO)),
    }


@pytest.mark.parametrize("kind", ["naflex", "htsat"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_wds_audio_batches_equal_jax(tmp_path, kind, shuffle):
    """Every batch of two epochs equal to the JAX pipeline's: the mel patch dicts of
    the NaFlex tower, or HTSAT's waveform windows (the random window from the same
    ``random`` seed), and the captions' token ids."""
    urls = _write_shards(tmp_path)
    mine, theirs = _pipelines(urls, 3, _pairs()[kind], shuffle, partial=True)
    for epoch in range(2):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        random.seed(epoch)
        got = list(mine)
        random.seed(epoch)
        want = list(theirs)
        assert len(got) == len(want) == 4  # 10 samples in batches of 3, the last partial
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["text"].numpy(), w["text"])
            assert set(g["audio"]) == set(w["audio"])
            for k in w["audio"]:
                assert isinstance(g["audio"][k], torch.Tensor)
                np.testing.assert_array_equal(g["audio"][k].numpy(), w["audio"][k])


def test_a_shard_that_does_not_decode_yields_nothing_and_no_error(tmp_path):
    """Reference fault the port follows: the pipeline swallows every decode error,
    so a shard of FLAC members (no decoder) gives no batch and raises nothing."""
    urls = _write_shards(tmp_path, with_flac=True)
    mine, theirs = _pipelines(urls, 2, _pairs()["naflex"], False, partial=True)
    assert list(mine) == [] and list(theirs) == []


def _folder(root, per_class=3):
    rng = np.random.default_rng(8)
    classes = ["dog_bark", "rain", "siren", "engine", "bird", "clock_tick"]
    for ci, c in enumerate(classes):
        (root / c).mkdir(parents=True)
        for i in range(per_class):
            sr = (16000, 44100, 48000)[(ci + i) % 3]
            t = np.arange(int(0.3 * sr)) / sr
            tone = 0.3 * np.sin(2 * np.pi * (200 + 150 * ci) * t) + 0.05 * rng.standard_normal(t.shape)
            data = (tone * 2 ** 14).astype(np.int16)
            if i == 1:
                data = np.stack([data, data // 2], axis=1)  # stereo
            (root / c / f"{i}.wav").write_bytes(_wav_bytes(data, sr))
        (root / c / "notes.txt").write_text("not audio")
    return classes


def test_folder_zero_shot_matches_jax(tmp_path):
    classes = _folder(tmp_path / "zs", per_class=2)
    jcfg = JaxCfg.from_dict(CFG)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(2), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(CFG)
    model = CLIPModel(cfg).eval()
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    jmodel = jclip.CLIPModel(jcfg, jax.tree.map(jnp.asarray, params))
    pp_mine, pp_theirs = _pairs()["naflex"]
    loader = pzs.build_audio_zero_shot_dataset(f"folder:{tmp_path / 'zs'}", pp_mine, batch_size=6)
    jloader = jzs.build_audio_zero_shot_dataset(str(tmp_path / "zs"), pp_theirs, batch_size=6)
    assert loader.classnames == jloader.classnames == [c.replace("_", " ") for c in sorted(classes)]
    assert loader.num_samples == 12
    tok = oc.get_tokenizer(NAME)
    with torch.no_grad():
        clf = oc.build_zero_shot_classifier(model, tok, loader.classnames, pzs.ESC50_TEMPLATES,
                                            num_classes_per_batch=10)
    jclf = jbuild(jmodel, oct.get_tokenizer(NAME), jloader.classnames, jzs.ESC50_TEMPLATES,
                  num_classes_per_batch=10)
    np.testing.assert_allclose(clf.numpy(), np.asarray(jclf), atol=1e-5)
    got = pzs.run_audio_zero_shot(model, clf, loader)
    want = jzs.run_audio_zero_shot(jmodel, jclf, jloader)
    assert got == {k: float(v) for k, v in want.items()}
    with pytest.raises(NotImplementedError, match="ashraq/esc50"):
        pzs.build_audio_zero_shot_dataset("ashraq/esc50", pp_mine)


def test_webdataset_audio_cli_trains_and_evaluates(tmp_path):
    """Two steps from WAV tar shards, then the zero-shot split; then an evaluation-only
    run that reads the WAV folder alone."""
    urls = _write_shards(tmp_path)
    _folder(tmp_path / "zs", per_class=1)
    args = ["--model", NAME, "--dataset-type", "webdataset-audio", "--train-data", urls,
            "--train-num-samples", "8", "--batch-size", "4", "--epochs", "1", "--lr", "1e-3",
            "--precision", "fp32", "--device", "cpu", "--logs", str(tmp_path), "--name", "wds",
            "--audio-ext", "wav", "--audio-zeroshot-dataset", str(tmp_path / "zs"),
            "--log-every-n-steps", "1"]
    state = main(args)
    assert state.step == 2
    rows = [json.loads(line) for line in (tmp_path / "wds" / "results.jsonl").read_text().splitlines()]
    assert any("train/loss" in r for r in rows)
    assert any("val/audio-zeroshot-top1" in r for r in rows)
    metrics = main(["--model", NAME, "--device", "cpu", "--batch-size", "4", "--logs",
                    str(tmp_path), "--name", "zs", "--audio-zeroshot-dataset", str(tmp_path / "zs")])
    assert 0.0 <= metrics["audio-zeroshot-top1"] <= metrics["audio-zeroshot-top5"] <= 1.0
