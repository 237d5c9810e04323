"""The port's image data path against the JAX package's, on the CPU.

- Native decode: the port builds the same ``decode.cpp`` with the same flags and the
  same libjpeg, so its canvases equal ``open_clip_tpu.native``'s **bit for bit**
  (strict and fractional, the committed assets of ``tests/assets_torch`` included),
  and a bad image gives the same non-zero status.
- The val tier (``_Uint8ValTransform``, strict DCT scales) stays within **2 levels** of
  the JAX package's PIL tier, the bound of ``tests/test_native_decode.py``.
- ``WdsPipeline`` on shards written here with PIL: the same sample keys, token ids
  and uint8 images **exactly**, in the same order, at one worker, two forked workers
  and the native thread pool, with ``epoch_batches`` padding, the rank split at world
  2, a corrupt shard and a corrupt JPEG; a non-JPEG member raises with its key.
- ``CsvDataset`` and ``make_imagenet_val``: the same order, captions, labels and
  ``index`` at world 1 and 2 (images within 2 levels: the JAX loaders decode with PIL).
- ``make_crop_resample`` at the same boxes: fp32, max abs **1e-5**.
  ``make_crop_param_sampler``: bounds and integer values, and over 20,000 draws at
  scale (0.9, 1.0) the fallback share and the mean box within **1 %** of the JAX
  sampler's (the random streams differ, so the distributions are compared).
- One ``make_train_step`` step with ``device_preprocess`` and injected boxes against
  the JAX step (fp32; loss and grad norm 1e-5 relative, parameters 2e-2 * lr, the
  tolerances of ``test_torch_train_step.py``), also with ``accum_steps=2``.
- ``get_data`` at ``--accum-freq 2`` gives the JAX loader's rows a step.
"""

import io
import os
import sys
import tarfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import open_clip_tpu.transform as jtransform
from open_clip_tpu import native as jnative
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.data import datasets as jdatasets
from open_clip_tpu.data import wds as jwds
from open_clip_tpu.factory import get_tokenizer as jax_tokenizer
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import native as pnative
from open_clip_tpu_torch import transform as ptransform
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.data import datasets as pdatasets
from open_clip_tpu_torch.data import wds as pwds
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets_torch")
sys.path.insert(0, ASSETS)
import make_assets  # noqa: E402

CANVAS, SIZE, CTX = 48, 32, 16
SHARDS, PER_SHARD = 4, 9


def _jpeg(rng, w, h, gray=False, quality=90):
    base = rng.integers(0, 256, (max(2, h // 8), max(2, w // 8), 3)).astype(np.uint8)
    img = Image.fromarray(base).resize((w, h), Image.BICUBIC)
    if gray:
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """SHARDS tar shards of PER_SHARD samples (one a corrupt JPEG), a truncated shard,
    one with a PNG member, one with a WebP member, a CSV and a class folder, all from
    seed 0."""
    d = tmp_path_factory.mktemp("wds")
    rng = np.random.default_rng(0)
    k = 0
    for s in range(SHARDS):
        with tarfile.open(d / f"{s:05d}.tar", "w") as tf:
            for _ in range(PER_SHARD):
                data = (b"not a jpeg" if k == 5 else
                        _jpeg(rng, int(rng.integers(36, 90)), int(rng.integers(36, 90)), gray=k == 7))
                _add(tf, f"k{k:05d}.jpg", data)
                _add(tf, f"k{k:05d}.txt", f"a photo of item {k}".encode())
                k += 1
    whole = (d / "00000.tar").read_bytes()
    (d / "bad.tar").write_bytes(whole[: len(whole) // 2])
    with tarfile.open(d / "png.tar", "w") as tf:
        buf = io.BytesIO()
        Image.new("RGB", (8, 8)).save(buf, "PNG")
        _add(tf, "p0.png", buf.getvalue())
        _add(tf, "p0.txt", b"a png")
    with tarfile.open(d / "webp.tar", "w") as tf:
        buf = io.BytesIO()
        Image.new("RGB", (8, 8)).save(buf, "WEBP")
        _add(tf, "w0.webp", buf.getvalue())
        _add(tf, "w0.txt", b"a webp")
    os.makedirs(d / "imgs")
    rows = ["filepath\ttitle"]
    for i in range(11):
        (d / "imgs" / f"{i}.jpg").write_bytes(_jpeg(rng, 40 + i, 52))
        rows.append(f"imgs/{i}.jpg\tcsv caption {i}")
    (d / "data.csv").write_text("\n".join(rows) + "\n")
    for c in range(3):
        os.makedirs(d / "folder" / f"class{c}")
        for i in range(3 + c):
            (d / "folder" / f"class{c}" / f"{i}.jpg").write_bytes(_jpeg(rng, 44, 38))
    return d


@pytest.fixture(scope="module")
def toks():
    return jax_tokenizer("ViT-B-32", context_length=CTX), oc.get_tokenizer("ViT-B-32",
                                                                            context_length=CTX)


# ---------------------------------------------------------------- native decode

@pytest.mark.parametrize("fractional", [False, True])
def test_decode_matches_jax_native_bit_for_bit(fractional):
    canv = make_assets.load_canvases()
    for i, name in enumerate(canv["names"]):
        data = open(os.path.join(ASSETS, name), "rb").read()
        ours, status = pnative.decode_resize_one(data, 256, fractional=fractional)
        want = jnative.decode_resize_one(data, 256, fractional=fractional)
        assert status == 0 and np.array_equal(ours, want), name
        stored = canv["fractional" if fractional else "strict"][i]
        assert np.array_equal(ours[::make_assets.ROW_STEP], stored), name


def test_decode_batch_bad_bytes_and_grayscale():
    gray = open(os.path.join(ASSETS, make_assets.names()[2]), "rb").read()
    good = open(os.path.join(ASSETS, make_assets.names()[0]), "rb").read()
    datas = [good, b"definitely not a jpeg", gray]
    ours, status = pnative.decode_resize_batch(datas, 64, nthreads=2)
    want, wstatus = jnative.decode_resize_batch(datas, 64, nthreads=2)
    assert status[0] == status[2] == 0 and status[1] != 0 and status == wstatus
    assert np.array_equal(ours, want) and not ours[1].any()
    assert np.ptp(ours[2].astype(int), axis=-1).max() == 0  # gray: R = G = B
    assert pnative.decode_resize_one(b"junk", 32)[1] != 0
    assert pnative.jpeg_dims(good) == jnative.jpeg_dims(good) == (320, 240)


@pytest.mark.parametrize("index", [0, 4, 7, 11])
def test_val_tier_within_two_levels_of_the_jax_pil_tier(index):
    data = open(os.path.join(ASSETS, make_assets.names()[index]), "rb").read()
    cfg = ptransform.PreprocessCfg(size=224)
    ours = ptransform.uint8_image_transform_v2(cfg, is_train=False)(data)
    want = jtransform._Uint8ValTransform(jtransform.PreprocessCfg(size=224))(data)
    assert ours.shape == want.shape == (224, 224, 3)
    assert np.abs(ours.astype(int) - want.astype(int)).max() <= 2
    host = ptransform.host_val_transform(cfg)(data)  # normalized on the host
    mean, std = np.asarray(cfg.mean, np.float32), np.asarray(cfg.std, np.float32)
    np.testing.assert_array_equal(host, (ours.astype(np.float32) / 255.0 - mean) / std)


@pytest.mark.parametrize("overlay,match", [
    ({"resize_mode": "squash"}, "resize_mode"), ({"interpolation": "bilinear"}, "interpolation"),
    ({"mode": "L"}, "mode"), ({"size": (32, 48)}, "non-square")])
def test_native_stage_refuses_what_it_cannot_do(overlay, match):
    cfg = ptransform.merge_preprocess_dict(ptransform.PreprocessCfg(size=32), overlay)
    with pytest.raises(NotImplementedError, match=match):
        ptransform.host_val_transform(cfg)


# ------------------------------------------------------------------- pipeline

def _cfgs(shards, **kw):
    base = dict(urls=str(shards / "{00000..00003}.tar"), batch_size=4, seed=3,
                shuffle_shards=2000, shuffle_samples=6, num_workers=1)
    base.update(kw)
    return jwds.WdsConfig(**base), pwds.WdsConfig(**base)


def _pipelines(shards, toks, **kw):
    jcfg, pcfg = _cfgs(shards, **kw)
    jstage = jtransform._Uint8CanvasTransform(jtransform.PreprocessCfg(size=SIZE), canvas=CANVAS)
    pstage = ptransform.uint8_image_transform_v2(ptransform.PreprocessCfg(size=SIZE), True,
                                                 canvas=CANVAS)
    return jwds.WdsPipeline(jcfg, jstage, toks[0]), pwds.WdsPipeline(pcfg, pstage, toks[1])


def _same_batches(jp, pp, epoch=0):
    jp.set_epoch(epoch)
    pp.set_epoch(epoch)
    want, got = list(jp), list(pp)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert set(g) == {"image", "text"} and g["image"].dtype == torch.uint8
        np.testing.assert_array_equal(g["text"].numpy(), w["text"])
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
    return got


@pytest.mark.parametrize("kw", [
    {}, {"num_workers": 2}, {"native_decode_threads": 2}, {"epoch_batches": 11},
    {"world_size": 2, "rank": 1}, {"resampled": True, "urls": "{}::{}", "weights": "1::3"},
], ids=["one_worker", "two_workers", "native_threads", "epoch_batches", "rank1_of_2",
        "resampled"])
def test_pipeline_matches_jax(shards, toks, kw):
    if kw.get("urls") == "{}::{}":
        kw = dict(kw, urls=f"{shards / '{00000..00001}.tar'}::{shards / '{00002..00003}.tar'}")
    jp, pp = _pipelines(shards, toks, **kw)
    assert [r["__key__"] for r in pp._samples(1)] == [r["__key__"] for r in jp._samples(1)]
    got = _same_batches(jp, pp, epoch=1)
    if kw.get("epoch_batches"):
        assert len(got) == kw["epoch_batches"]  # padded past one pass of 8 batches


def test_pipeline_corrupt_shard_and_partial_val_batches(shards, toks):
    urls = f"{shards / 'bad.tar'}::{shards / '{00001..00002}.tar'}"
    jp, pp = _pipelines(shards, toks, urls=urls, shuffle_shards=0, shuffle_samples=0,
                        partial_batches=True, batch_size=5)
    got = _same_batches(jp, pp)
    assert sum(len(b["text"]) for b in got) < 3 * PER_SHARD  # the bad shard's tail is lost


def test_pipeline_non_jpeg_raises_with_its_key(shards, toks):
    """A member that is neither a JPEG nor a PNG (WebP) raises with its key."""
    _, pp = _pipelines(shards, toks, urls=str(shards / "webp.tar"), shuffle_shards=0,
                       shuffle_samples=0, partial_batches=True)
    with pytest.raises(NotImplementedError, match=r"'w0'.*\.webp"):
        list(pp)


def test_pipeline_stops_after_consecutive_decode_failures(shards, toks, tmp_path):
    with tarfile.open(tmp_path / "junk.tar", "w") as tf:
        for i in range(4):
            _add(tf, f"j{i}.jpg", b"junk")
            _add(tf, f"j{i}.txt", b"junk")
    _, pp = _pipelines(shards, toks, urls=str(tmp_path / "junk.tar"), shuffle_shards=0,
                       shuffle_samples=0, max_consecutive_failures=3)
    with pytest.raises(RuntimeError, match="3 consecutive decode failures"):
        list(pp)


@pytest.mark.parametrize("world", [1, 2])
def test_csv_and_folder_order_labels_and_index(shards, toks, world):
    jval = jtransform._Uint8ValTransform(jtransform.PreprocessCfg(size=SIZE))
    pval = ptransform.uint8_image_transform_v2(ptransform.PreprocessCfg(size=SIZE), False)
    for shuffle in (True, False):
        for rank in range(world):
            kw = dict(batch_size=4, shuffle=shuffle, seed=2, partial_batches=not shuffle,
                      world_size=world, rank=rank)
            want = list(jdatasets.CsvDataset(str(shards / "data.csv"), jval, toks[0], **kw))
            got = list(pdatasets.CsvDataset(str(shards / "data.csv"), pval, toks[1], **kw))
            assert len(got) == len(want) > 0
            for w, g in zip(want, got):
                assert set(w) == set(g)
                np.testing.assert_array_equal(g["text"].numpy(), w["text"])
                if "index" in w:
                    np.testing.assert_array_equal(g["index"], w["index"])
                assert np.abs(g["image"].numpy().astype(int) - w["image"].astype(int)).max() <= 2
        for rank in range(world):
            want = list(jdatasets.make_imagenet_val(str(shards / "folder"), jval, 4, world,
                                                    rank).dataloader)
            info = pdatasets.make_imagenet_val(str(shards / "folder"), pval, 4, world, rank)
            got = list(info.dataloader)
            assert len(got) == len(want) == info.num_batches
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g["label"].numpy(), w["label"])
                assert np.abs(g["image"].numpy().astype(int) - w["image"].astype(int)).max() <= 2


@pytest.mark.parametrize("accum", [1, 2])
def test_get_data_batches_accum_freq_rows_like_jax(shards, toks, accum):
    """--accum-freq multiplies the train batch (the JAX rule): the same rows a step."""
    kw = dict(train_data=str(shards / "{00000..00003}.tar"), dataset_type="webdataset",
              batch_size=3, accum_freq=accum, train_num_samples=30, seed=1, workers=1,
              native_decode_threads=2, world_size=1, rank=0)
    jstage = jtransform._Uint8CanvasTransform(jtransform.PreprocessCfg(size=SIZE), canvas=CANVAS)
    want = jdatasets.get_data(kw, (jstage, None), tokenizer=toks[0])["train"]
    args = SimpleNamespace(device="cpu", device_preprocess=True, **kw)
    got = pdatasets.get_data(args, ptransform.PreprocessCfg(size=42), toks[1])["train"]
    assert got.num_batches == want.num_batches == 30 // (3 * accum)
    wb, gb = list(want.dataloader), list(got.dataloader)
    assert len(gb) == len(wb) == got.num_batches
    for w, g in zip(wb, gb):
        assert g["text"].shape[0] == w["text"].shape[0] == 3 * accum
        np.testing.assert_array_equal(g["text"].numpy(), w["text"])
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
    syn = SimpleNamespace(device="cpu", dataset_type="synthetic", batch_size=4, accum_freq=accum,
                          train_num_samples=40)
    jsyn = jdatasets.get_data(vars(syn), (jtransform.image_transform_v2(
        jtransform.PreprocessCfg(size=SIZE), False), None), tokenizer=toks[0])["train"]
    psyn = pdatasets.get_data(syn, ptransform.PreprocessCfg(size=SIZE), toks[1])["train"]
    assert psyn.num_batches == jsyn.num_batches == 40 // (4 * accum)
    assert next(iter(psyn.dataloader))["text"].shape[0] == 4 * accum


def test_image_train_data_needs_device_preprocess(shards, toks):
    args = SimpleNamespace(device="cpu", train_data=str(shards / "00000.tar"),
                           dataset_type="auto", batch_size=2)
    with pytest.raises(NotImplementedError, match="--device-preprocess"):
        pdatasets.get_data(args, ptransform.PreprocessCfg(size=SIZE), toks[1])


# ------------------------------------------------------------- device crop

def _boxes(rng, b, s):
    ch = rng.integers(s // 2, s + 1, b).astype(np.float32)
    cw = rng.integers(s // 2, s + 1, b).astype(np.float32)
    top = np.floor(rng.random(b) * (s - ch + 1)).astype(np.float32)
    left = np.floor(rng.random(b) * (s - cw + 1)).astype(np.float32)
    return top, left, ch, cw


@pytest.mark.parametrize("kind,antialias,fractional", [
    ("cubic", True, False), ("cubic", True, True), ("linear", False, False)])
def test_crop_resample_matches_jax(kind, antialias, fractional):
    rng = np.random.default_rng(1)
    b, s, th, tw = 5, 40, 24, 20
    x = rng.random((b, s, s, 3)).astype(np.float32)
    boxes = list(_boxes(rng, b, s))
    if fractional:
        boxes = [v + rng.random(b).astype(np.float32) * 0.5 for v in boxes[:2]] + boxes[2:]
    ours = ptransform.make_crop_resample(s, th, tw, kind, antialias)(
        torch.from_numpy(x), *[torch.from_numpy(v) for v in boxes])
    want = jtransform.make_crop_resample(s, th, tw, kind, antialias)(
        jnp.asarray(x), *[jnp.asarray(v) for v in boxes])
    assert ours.shape == (b, th, tw, 3)
    assert np.abs(ours.numpy() - np.asarray(want)).max() <= 1e-5


@pytest.mark.parametrize("scale,ratio", [((0.9, 1.0), (3 / 4, 4 / 3)), ((0.3, 1.0), (0.5, 2.0)),
                                         ((0.5, 0.8), (1.2, 1.5))])
def test_crop_param_sampler_distribution_matches_jax(scale, ratio):
    s, n = 64, 20000
    top, left, ch, cw = [v.numpy() for v in ptransform.make_crop_param_sampler(s, scale, ratio)(
        torch.Generator().manual_seed(0), n)]
    jt, jl, jch, jcw = [np.asarray(v) for v in jtransform.make_crop_param_sampler(s, scale, ratio)(
        jax.random.PRNGKey(0), n)]
    for v in (top, left, ch, cw):
        assert np.array_equal(v, np.round(v)) and v.min() >= 0
    assert (ch >= 1).all() and (cw >= 1).all() and (top + ch <= s).all() and (left + cw <= s).all()
    full = lambda a, b: np.mean((a == s) & (b == s))  # noqa: E731 — the fallback's box
    assert abs(full(ch, cw) - full(jch, jcw)) <= 0.01
    for ours, theirs in ((ch, jch), (cw, jcw), (top, jt), (left, jl)):
        assert abs(ours.mean() - theirs.mean()) <= 0.01 * s


# ------------------------------------------------------- step with the crop

STEP_TINY = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16, "head_width": 32},
    "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2},
}
LR = 1e-3


@pytest.mark.parametrize("accum", [1, 2])
def test_step_with_device_preprocess_matches_jax(accum, monkeypatch):
    b, s = 8, 40
    rng = np.random.default_rng(4)
    canvases = rng.integers(0, 256, (b, s, s, 3)).astype(np.uint8)
    texts = rng.integers(1, 49406, (b, 16)).astype(np.int32)
    texts[np.arange(b), rng.integers(2, 16, b)] = 49407
    boxes = _boxes(rng, b, s)
    jcfg = JaxCfg.from_dict(STEP_TINY)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(jtransform, "make_crop_param_sampler",
                        lambda *a, **k: lambda rng_, n: tuple(jnp.asarray(v) for v in boxes))
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=0.2, grad_clip_norm=1.0), jparams,
                                   jsched.const_lr(LR, 2))
    jstate = jts.create_train_state(jparams, jopt)
    jstep = jax.jit(jts.make_train_step(
        jcfg, jopt, compute_dtype=jnp.float32, accum_steps=accum,
        device_preprocess=jtransform.make_device_train_preprocess(jtransform.PreprocessCfg(size=32))))
    jstate, jm = jstep(jstate, {"image": jnp.asarray(canvases), "text": jnp.asarray(texts)},
                       jax.random.PRNGKey(0))

    cfg = oc.CLIPModelCfg.from_dict(STEP_TINY)
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=0.2, grad_clip_norm=1.0), model,
                                  psched.const_lr(LR, 2))
    drawn = []
    sampler = lambda gen, n: drawn.append(n) or tuple(torch.from_numpy(v) for v in boxes)  # noqa: E731
    pp = ptransform.make_device_train_preprocess(ptransform.PreprocessCfg(size=32), sampler=sampler)
    state = pts.create_train_state(model, opt)
    state, m = pts.make_train_step(cfg, opt, accum_steps=accum, device_preprocess=pp)(
        state, {"image": torch.from_numpy(canvases), "text": torch.from_numpy(texts)})
    assert drawn == [b]  # one preprocess of the whole batch, before the cut
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    for k, v in state.model.state_dict().items():
        assert np.abs(v.numpy() - want[k].numpy()).max() <= 2e-2 * LR, k


def test_step_crops_are_seeded_by_seed_and_step():
    """The generator of a step depends on (seed, step) only: a resumed run draws the
    crops of an uninterrupted one."""
    seen = []
    sampler = lambda gen, n: seen.append(torch.rand(2, generator=gen)) or (  # noqa: E731
        torch.zeros(n), torch.zeros(n), torch.full((n,), 8.0), torch.full((n,), 8.0))
    pp = ptransform.make_device_train_preprocess(ptransform.PreprocessCfg(size=8), sampler=sampler)
    cfg = oc.CLIPModelCfg.from_dict(dict(STEP_TINY, vision_cfg=dict(STEP_TINY["vision_cfg"],
                                                                  image_size=8, patch_size=4)))
    batch = {"image": torch.zeros(2, 8, 8, 3, dtype=torch.uint8),
             "text": torch.randint(1, 100, (2, 16))}
    for seed in (0, 0, 1):
        model = CLIPModel(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR), model, psched.const_lr(LR, 1))
        state = pts.create_train_state(model, opt)
        step = pts.make_train_step(cfg, opt, device_preprocess=pp, preprocess_seed=seed)
        for _ in range(2):
            state, _ = step(state, batch)
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])
    assert not torch.equal(seen[0], seen[1]) and not torch.equal(seen[0], seen[4])


# ------------------------------------------------------------- nvJPEG build

def _section(text: str, start: str, end: str) -> str:
    i = text.index(start)
    return text[i: text.index(end, i)]


def test_nvjpeg_source_keeps_decode_cpp_resample_and_geometry():
    """decode_nvjpeg.cpp (the build where libjpeg is absent) holds decode.cpp's
    resample and its shortest-edge resize and crop as unchanged text."""
    native_dir = os.path.dirname(pnative.decode.__file__)
    ours = open(os.path.join(native_dir, "decode.cpp")).read()
    assert ours == open(os.path.join(os.path.dirname(jnative.decode.__file__), "decode.cpp")).read()
    nv = open(os.path.join(native_dir, "decode_nvjpeg.cpp")).read()
    resample = _section(ours, "// PIL-equivalent separable resample", "// decode one JPEG")
    geometry = _section(ours, "  // shortest-edge resize (round, matching", "}  // namespace")
    assert resample.rsplit("// ----", 1)[0] in nv
    assert geometry.rstrip() in nv
    for symbol in ("oct_decode_resize", "oct_decode_batch", "oct_resize", "oct_jpeg_dims"):
        assert f"{symbol}(" in nv


def test_decoder_choice(monkeypatch):
    """libjpeg where its header is (this host), and the nvJPEG build's own command."""
    monkeypatch.setattr(pnative.decode, "_DECODER", None)
    assert pnative.decoder() == "libjpeg"
    monkeypatch.setattr(pnative.decode, "_DECODER", "nvjpeg")
    cmd = pnative.decode._command("nvjpeg", "out.so")
    assert "-lnvjpeg" in cmd and str(pnative.decode.SOURCES["nvjpeg"]) in cmd
    assert pnative.decode.library_path().name.startswith("liboct_decode_nvjpeg_")


def test_forked_workers_refuse_the_nvjpeg_decoder(shards, toks, monkeypatch):
    monkeypatch.setattr(pnative.decode, "_DECODER", "nvjpeg")
    _, pp = _pipelines(shards, toks, num_workers=2)
    with pytest.raises(RuntimeError, match="nvJPEG decoder runs on the card"):
        list(pp)
