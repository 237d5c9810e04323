"""NaFlex training data in the port against the JAX package, on the CPU: the length
bucketer, PNG without PIL, the full-resolution decode and the webdataset-naflex
pipeline through ``get_data`` and the CLI.

Shards hold the 12 committed JPEGs (``tests/assets_torch``) under distinct keys and
captions, seeded PNGs written here with ``zlib`` and ``struct`` (every filter type
in turn) and one corrupt JPEG, which both pipelines skip. Tolerances:

- the bucketer's order, the lengths, the schedule, the tokens, the coordinates and
  the validity are equal;
- PNG decodes equal PIL's ``convert("RGB")`` bit for bit for every colour type and
  depth;
- the libjpeg full-resolution decode equals PIL's decode of the same files bit for
  bit (measured: 0 levels; both are libjpeg's accurate integer IDCT with fancy
  upsampling), and the committed ``full_decodes.npz`` that the card's nvJPEG decode
  is held against;
- NaFlex patches within ``test_transform_with_resize_is_close_to_jax``'s bound: 2
  levels at most, 0.3 on average (measured: at most 1 level, about 0.1 on average);
- a PNG's training canvas against the JAX package's PIL tier: 2 levels at most, 0.3
  on average (the native resample in float against PIL's fixed point).
"""

import io
import json
import os
import struct
import tarfile
import types
import zlib

import numpy as np
import pytest
from PIL import Image

from open_clip_tpu.data import bucketing as jbucket
from open_clip_tpu.data import datasets as jdatasets
from open_clip_tpu.factory import get_tokenizer as jax_tokenizer
import open_clip_tpu.transform as jtransform

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import native as pnative
from open_clip_tpu_torch import transform as ptransform
from open_clip_tpu_torch.data import bucketing as pbucket
from open_clip_tpu_torch.data import datasets as pdatasets
from open_clip_tpu_torch.data import wds as pwds
from open_clip_tpu_torch.native.png import decode_png
from open_clip_tpu_torch.train.main import main

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets_torch")
CTX = 16
LEVEL = 1 / 255 / 0.26  # one uint8 level after the normalization (std ~0.26)


# ---------------------------------------------------------------- PNG writer

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int) -> bytes:
    """Row y filtered with type y % 5 (None, Sub, Up, Average, Paeth)."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, up_left)][y % 5]
        out.append(bytes([y % 5]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def png_bytes(samples: np.ndarray, colour: int, depth: int, plte=None, trns=None,
              interlace: int = 0) -> bytes:
    """(H, W, C) samples as a PNG, the image data split over two IDAT chunks."""
    h, w, c = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = samples.reshape(h, -1).astype(np.uint8)
    else:
        v = samples.reshape(h, -1).astype(np.uint8)
        rows = np.packbits(((v[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1),
                           axis=1)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                            0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    data = zlib.compress(_filtered(rows, max(1, c * depth // 8)))
    half = len(data) // 2
    return out + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:]) + _chunk(b"IEND", b"")


def smooth_rgb(h: int, w: int, phase: float = 0.0) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([127 + 120 * np.sin(xx / 23.0 + c + phase) * np.cos(yy / 17.0)
                     for c in range(3)], -1).astype(np.uint8)


# ---------------------------------------------------------------- bucketing

@pytest.fixture(scope="module")
def toks():
    return jax_tokenizer("ViT-B-32", context_length=CTX), oc.get_tokenizer("ViT-B-32",
                                                                            context_length=CTX)


def _wav(frames: int, rate: int, channels: int = 1) -> bytes:
    body = np.zeros(frames * channels, np.int16).tobytes()
    fmt = struct.pack("<HHIIHH", 1, channels, rate, rate * 2 * channels, 2 * channels, 16)
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
            + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(body)) + body)


def test_length_functions_match_jax(toks):
    jt, pt = toks
    samples = [{"caption": "a photo of a cat on a mat"}, {"caption": b"two words"},
               {"caption": np.zeros((3, 7))}, {"caption": [1, 2]}, {}, {"caption": 5}]
    for s in samples:
        assert pbucket.CaptionLength(tokenizer=pt)(s) == jbucket.CaptionLength(tokenizer=jt)(s)
    audio = [{"audio": _wav(16000, 16000)}, {"audio": _wav(4410, 44100, channels=2)},
             {"audio": (np.zeros(48000), 48000)}, {"audio": np.zeros((2, 5000))},
             {"audio": b"RIFF junk"}, {}]
    kw = dict(freq_tokens=16, patch_time=4, hop_size=160, window_size=400, sample_rate=16000,
              max_audio_tokens=500)
    for s in audio:
        for k in (kw, {}):
            assert pbucket.AudioTokenLength(**k)(s) == jbucket.AudioTokenLength(**k)(s)
    assert pbucket._wav_header_frames(_wav(123, 8000)) == jbucket._wav_header_frames(
        _wav(123, 8000)) == (123, 8000)


@pytest.mark.parametrize("prefetch", [0, 2], ids=["inline", "prefetch"])
def test_bucketer_order_matches_jax(toks, prefetch):
    jt, pt = toks
    rng = np.random.default_rng(1)
    stream = [{"caption": " ".join(["word"] * int(rng.integers(1, 14))), "k": i} for i in range(41)]
    for epoch in (0, 1, 2):
        got, want = [], []
        for mod, tok, out in ((pbucket, pt, got), (jbucket, jt, want)):
            b = mod.LengthBucketer([mod.CaptionLength(tokenizer=tok)], pool=9, chunk=4, seed=5,
                                   prefetch_pools=prefetch)
            b.set_epoch(epoch)
            out.extend(s["k"] for s in b(iter(stream)))
        assert got == want and sorted(got) == list(range(41))


def test_prefetch_raises_the_producer_error():
    """The producer's exception reaches the consumer after the pools it finished (the
    pool it was filling is lost), as in the JAX package."""
    def src():
        yield from ({"caption": "x" * i} for i in range(5))
        raise RuntimeError("shard read failed")

    counts = []
    for mod in (pbucket, jbucket):
        seen = []
        with pytest.raises(RuntimeError, match="shard read failed"):
            for s in mod.LengthBucketer(pool=2, chunk=1, prefetch_pools=1)(src()):
                seen.append(s)
        counts.append(len(seen))
    assert counts == [4, 4]


# ---------------------------------------------------------------- PNG

FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
TRNS = {0: b"\x00\x05", 2: b"\x00\x01" * 3, 3: b"\x01\x02"}


@pytest.mark.parametrize("colour,depth", FORMS, ids=[f"c{c}d{d}" for c, d in FORMS])
def test_png_equals_pil(colour, depth):
    rng = np.random.default_rng(colour * 100 + depth)
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (13, 11, CHANNELS[colour]))
    if colour == 0 and depth == 16:
        samples[0, :3, 0] = [0x1234, 0x0080, 255]  # I;16 clips at 255
    plte = rng.integers(0, 256, 3 * (top + 1)).astype(np.uint8).tobytes() if colour == 3 else None
    for trns in (None, TRNS.get(colour)):
        data = png_bytes(samples, colour, depth, plte, trns)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = decode_png(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if colour == 0 and depth == 16:
        assert got[0, :3, 0].tolist() == [255, 128, 255]
    if colour == 2 and depth == 16:
        assert got[0, 0].tolist() == (samples[0, 0] >> 8).tolist()


def test_png_forms_not_decoded_raise():
    rgb = smooth_rgb(9, 7)
    with pytest.raises(NotImplementedError, match="'k9'.*interlaced"):
        decode_png(png_bytes(rgb, 2, 8, interlace=1), key="k9")
    good = png_bytes(rgb, 2, 8)
    i = good.index(b"IDAT") + 6
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:i] + bytes([good[i] ^ 1]) + good[i + 1:])
    with pytest.raises(NotImplementedError, match="'w1'.*webp"):
        pwds.check_image("w1", "webp", b"RIFF....WEBP")
    buf = io.BytesIO()
    Image.new("RGB", (4, 4)).save(buf, "BMP")
    with pytest.raises(NotImplementedError, match="'b1'.*bmp"):
        pwds.check_image("b1", "bmp", buf.getvalue())


def test_png_canvas_is_close_to_the_jax_pil_tier():
    """A PNG takes the JPEG's canvas stage: the training canvas and the val image."""
    cfg = oc.PreprocessCfg(size=32)
    for h, w, colour in ((70, 90, 2), (64, 64, 6), (120, 50, 0)):
        rgb = smooth_rgb(h, w, phase=h / 10)
        samples = rgb if colour == 2 else (np.concatenate([rgb, rgb[..., :1]], -1) if colour == 6
                                            else rgb[..., :1])
        data = png_bytes(samples, colour, 8)
        got = ptransform.uint8_image_transform_v2(cfg, is_train=True)(data)
        want = jtransform.uint8_image_transform_v2(jtransform.PreprocessCfg(size=32),
                                                   is_train=True)(data)
        diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
        assert got.shape == (48, 48, 3) and diff.max() <= 2 and diff.mean() <= 0.3, (diff.max(),
                                                                                    diff.mean())


# ---------------------------------------------------------------- full decode

def _assets():
    return [open(os.path.join(ASSETS, n), "rb").read() for n in sorted(os.listdir(ASSETS))
            if n.endswith(".jpg")]


def test_full_decode_equals_pil():
    datas = _assets()
    images, status = pnative.decode_full_batch(datas + [b"junk"], nthreads=3)
    assert status[:-1] == [0] * 12 and status[-1] != 0 and images[-1] is None
    assert pnative.full_decode_route("cpu") == "libjpeg-host"
    for data, got in zip(datas, images):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(got, want)


def test_full_decode_equals_the_committed_reference():
    """``full_decodes.npz`` (what the card's nvJPEG decode is held against, in
    ``chip_smoke.py`` and ``test_torch_decode_gpu.py``) is the port's libjpeg decode."""
    import hashlib
    import sys

    sys.path.insert(0, ASSETS)
    import make_assets

    ref = make_assets.load_full_decodes()
    assert ref["names"] == make_assets.names()
    images, status = pnative.decode_full_batch(
        [open(os.path.join(ASSETS, n), "rb").read() for n in ref["names"]], nthreads=3)
    assert status == [0] * 12
    for i, got in enumerate(images):
        np.testing.assert_array_equal(got[::make_assets.FULL_ROW_STEP], ref["rows"][i])
        assert hashlib.sha256(got.tobytes()).hexdigest() == ref["sha256"][i]


# ---------------------------------------------------------------- webdataset-naflex

def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """4 shards of 6 samples: the committed JPEGs, a seeded PNG each, and one corrupt
    JPEG; captions of 2 to 13 words."""
    d = tmp_path_factory.mktemp("nfwds")
    rng = np.random.default_rng(0)
    jpgs = _assets()
    k = 0
    for s in range(4):
        with tarfile.open(d / f"{s:05d}.tar", "w") as tf:
            for j in range(6):
                if j == 5:
                    h, w = (int(v) for v in rng.integers(40, 120, 2))
                    data, ext = png_bytes(smooth_rgb(h, w, phase=k), 2, 8), "png"
                elif k == 7:
                    data, ext = b"not a jpeg", "jpg"
                else:
                    data, ext = jpgs[k % 12], "jpg"
                _add(tf, f"s{k:04d}.{ext}", data)
                words = " ".join(["word"] * int(rng.integers(1, 12)))
                _add(tf, f"s{k:04d}.txt", f"{words} {k}".encode())
                k += 1
    return d


def _args(shards, **kw):
    a = dict(dataset_type="webdataset-naflex", train_data=f"{shards}/{{00000..00003}}.tar",
             batch_size=4, naflex_seq_lens=[64, 144], naflex_max_tokens=576,
             naflex_batch_divisor=1, train_num_samples=24, seed=3, wds_shuffle_buffer=6,
             world_size=1, rank=0, device="cpu", length_bucketing=False, bucket_pool=8,
             bucket_chunk=3, bucket_prefetch_pools=0, naflex_seq_len_probs=[0.25, 0.75])
    a.update(kw)
    return types.SimpleNamespace(**a)


@pytest.mark.parametrize("kw", [{}, {"length_bucketing": True},
                                {"length_bucketing": True, "bucket_prefetch_pools": 2}],
                         ids=["plain", "bucketed", "bucketed_prefetch"])
def test_naflex_wds_matches_jax(shards, toks, kw):
    jt, pt = toks
    want = jdatasets.get_data(_args(shards, **kw), (None, None), tokenizer=jt)["train"]
    got = pdatasets.get_data(_args(shards, **kw), None, pt)["train"]
    assert got.num_batches == want.num_batches == 2
    assert got.dataloader.route == "libjpeg-host"
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        jb, pb = list(want.dataloader), list(got.dataloader)
        assert len(pb) == len(jb) == 2
        for x, y in zip(jb, pb):
            np.testing.assert_array_equal(y["text"].numpy(), np.asarray(x["text"]))
            for k in ("patch_coord", "patch_valid"):
                np.testing.assert_array_equal(y["image"][k].numpy(), x["image"][k])
            diff = np.abs(y["image"]["patches"].numpy() - x["image"]["patches"])
            assert diff.max() <= 2.01 * LEVEL and diff.mean() <= 0.3 * LEVEL, (diff.max() / LEVEL,
                                                                                diff.mean() / LEVEL)


NAFLEX_TINY = {"embed_dim": 32, "custom_text": True,
               "vision_cfg": {"image_size": 32, "timm_model_name": "naflexvit_tiny_patch16_gap",
                              "timm_model_kwargs": {"embed_dim": 64, "depth": 2, "num_heads": 1}},
               "text_cfg": {"context_length": CTX, "width": 64, "heads": 2, "layers": 2}}


def test_webdataset_naflex_cli(shards, tmp_path):
    """Two epochs from the shards with bucketing: every scheduled step runs, and a
    resumed run takes the epoch's schedule where it left off."""
    oc.add_model_config(dict(NAFLEX_TINY), name="tiny-naflex-wds")
    args = ["--model", "tiny-naflex-wds", "--train-data", f"{shards}/{{00000..00003}}.tar",
            "--dataset-type", "webdataset-naflex", "--naflex-seq-lens", "64", "144",
            "--naflex-max-tokens", "576", "--naflex-batch-divisor", "1",
            "--naflex-seq-len-probs", "0.5", "0.5", "--naflex-patch-size-probs", "1.0",
            "--naflex-pad-multiple", "8", "--length-bucketing", "--bucket-pool", "8",
            "--bucket-chunk", "3", "--train-num-samples", "24", "--batch-size", "4",
            "--epochs", "2", "--lr", "1e-3", "--warmup", "1", "--device", "cpu",
            "--native-decode-threads", "2", "--logs", str(tmp_path), "--name", "r"]
    state = main(args)
    assert state.step == 4
    rows = [json.loads(r) for r in (tmp_path / "r" / "results.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and all(np.isfinite(losses))
