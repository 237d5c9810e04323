"""The port's evaluation against the JAX package's, on the CPU.

A micro ViT CLIP (fp32, the real tokenizer at 16 tokens) takes its weights from the
JAX package's ``init_clip`` through ``params_from_jax``. The val images are 32x32
JPEGs, the model's size, so the JAX package's PIL val tier and the port's native
stage decode them to the same pixels (no resize) and both evaluations see the same
inputs.

- ``get_clip_metrics`` (ties broken by index): **exactly** the JAX values.
- ``accuracy`` and ``run_zero_shot_classifier``: the same top-1 and top-5.
- ``make_eval_step``: features and loss within **1e-5**; ``evaluate`` over a val tar
  or a CSV plus a class folder (zero-shot with a short class and template list): the
  same keys, values within **1e-5**.
- Rank-split ``evaluate`` in 2 gloo processes, the model under FSDP2 on a (1, 2) mesh
  (the eval forward calls the model as a module, so the shards are gathered): the
  metrics of one process within **1e-5**.
- The CLI trains a micro model from tar shards with ``--device-preprocess`` and
  evaluates (``--val-data``, ``--imagenet-val``) with ``--device cpu``, and runs
  evaluation alone without train data.
"""

import io
import json
import os
import socket
import subprocess
import sys
import tarfile
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import open_clip_tpu as oct
import open_clip_tpu.train.zero_shot as jzs
from open_clip_tpu.data import datasets as jdatasets
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.train import metrics as jmetrics
from open_clip_tpu.train import train_loop as jloop
from open_clip_tpu.transform import PreprocessCfg as JaxPreprocessCfg
from open_clip_tpu.transform import image_transform_v2

import open_clip_tpu_torch as oc
import open_clip_tpu_torch.train.zero_shot as pzs
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.data import datasets as pdatasets
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import metrics as pmetrics
from open_clip_tpu_torch.train import train_loop as ploop
from open_clip_tpu_torch.train.main import main

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

REPO = Path(__file__).resolve().parents[1]
MICRO = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16, "head_width": 32},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 64, "heads": 2, "layers": 2},
}
NAME = "eval-micro-torch"
CLASSES = ("tench", "goldfish", "great white shark")
TEMPLATES = (lambda c: f"a photo of a {c}.", lambda c: f"a bad photo of the {c}.")
TOL = 1e-5


def _jpeg(rng, w=32, h=32):
    base = rng.integers(0, 256, (4, 4, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(base).resize((w, h), Image.BICUBIC).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The micro model in both packages, and data: a val tar, a CSV, a class folder
    (32x32 JPEGs) and train shards of larger JPEGs."""
    for pkg in (oct, oc):
        if NAME not in pkg.list_models():
            pkg.add_model_config(dict(MICRO), name=NAME)
    jcfg = oct.CLIPModelCfg.from_dict(MICRO)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    jmodel = jclip.CLIPModel(jcfg, jax.tree.map(jnp.asarray, params), compute_dtype=jnp.float32)
    cfg = oc.CLIPModelCfg.from_dict(MICRO)
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    model.preprocess_cfg = oc.PreprocessCfg(size=32)

    d = tmp_path_factory.mktemp("evaldata")
    rng = np.random.default_rng(0)
    with tarfile.open(d / "val.tar", "w") as tf:
        for i in range(10):
            _add(tf, f"v{i:04d}.jpg", _jpeg(rng))
            _add(tf, f"v{i:04d}.txt", f"a val picture number {i}".encode())
    rows = ["filepath\ttitle"]
    os.makedirs(d / "csv")
    for i in range(11):
        (d / "csv" / f"{i}.jpg").write_bytes(_jpeg(rng))
        rows.append(f"csv/{i}.jpg\ta csv caption {i}")
    (d / "val.csv").write_text("\n".join(rows) + "\n")
    for c in range(len(CLASSES)):
        os.makedirs(d / "folder" / f"c{c}")
        for i in range(3):
            (d / "folder" / f"c{c}" / f"{i}.jpg").write_bytes(_jpeg(rng))
    for s in range(2):
        with tarfile.open(d / f"train{s}.tar", "w") as tf:
            for i in range(8):
                k = s * 8 + i
                _add(tf, f"t{k:04d}.jpg", _jpeg(rng, 40 + k, 56))
                _add(tf, f"t{k:04d}.txt", f"train caption {k}".encode())
    torch.save(model.state_dict(), d / "weights.pt")
    return jmodel, model, d


@pytest.fixture
def small_zero_shot(monkeypatch):
    """Both packages' zero-shot over CLASSES x TEMPLATES, not 1000 x 80."""
    for mod in (jzs, pzs):
        monkeypatch.setattr(mod, "IMAGENET_CLASSNAMES", CLASSES)
        monkeypatch.setattr(mod, "OPENAI_IMAGENET_TEMPLATES", TEMPLATES)


def _close(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= tol, (k, got[k], want[k])


@pytest.mark.parametrize("chunk", [1, 3, 1024])
def test_clip_metrics_with_ties_match_jax_exactly(chunk):
    rng = np.random.default_rng(1)
    imf = rng.standard_normal((12, 8)).astype(np.float32)
    txf = rng.standard_normal((12, 8)).astype(np.float32)
    imf[5] = imf[2]  # tied rows: the earlier index outranks
    txf[7] = txf[3] = txf[0]
    imf /= np.linalg.norm(imf, axis=1, keepdims=True)
    txf /= np.linalg.norm(txf, axis=1, keepdims=True)
    want = jmetrics.get_clip_metrics([imf[:5], imf[5:]], [txf], 7.0, chunk_size=chunk)
    assert pmetrics.get_clip_metrics([imf[:5], imf[5:]], [txf], 7.0, chunk_size=chunk) == want
    np.testing.assert_array_equal(pmetrics.paired_retrieval_ranks(txf, imf, 2.0, chunk),
                                  jmetrics.paired_retrieval_ranks(txf, imf, 2.0, chunk))


def test_accuracy_and_zero_shot_classifier_match_jax(setup):
    jmodel, model, d = setup
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 40)
    assert pzs.accuracy(torch.from_numpy(logits), labels, topk=(1, 5)) == \
        jzs.accuracy(logits, labels, topk=(1, 5))
    clf = rng.standard_normal((32, 4)).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    batches = [{"image": rng.standard_normal((6, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, 4, 6).astype(np.int32)} for _ in range(3)]
    want = jzs.run_zero_shot_classifier(jmodel, clf, batches)
    got = pzs.run_zero_shot_classifier(
        model, torch.from_numpy(clf),
        [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    assert got == want


def test_make_eval_step_matches_jax(setup):
    jmodel, model, _ = setup
    rng = np.random.default_rng(3)
    images = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (6, 16)).astype(np.int32)
    want = jloop.make_eval_step(jmodel.cfg, compute_dtype=jnp.float32)(
        jmodel.params, {"image": jnp.asarray(images), "text": jnp.asarray(texts)})
    got = ploop.make_eval_step()(model, {"image": torch.from_numpy(images),
                                         "text": torch.from_numpy(texts)})
    for k in ("primary_features", "text_features", "logit_scale", "loss"):
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= TOL, k


@pytest.mark.parametrize("source", ["webdataset", "csv"])
def test_evaluate_matches_jax(setup, small_zero_shot, source):
    jmodel, model, d = setup
    val = str(d / ("val.tar" if source == "webdataset" else "val.csv"))
    kw = dict(val_data=val, dataset_type=source, batch_size=4, imagenet_val=str(d / "folder"),
              zeroshot_frequency=1, epochs=1, world_size=1, rank=0, seed=0,
              val_retrieval_chunk_size=None)
    jtok, ptok = oct.get_tokenizer(NAME), oc.get_tokenizer(NAME)
    jdata = jdatasets.get_data(kw, (None, image_transform_v2(JaxPreprocessCfg(size=32), False)),
                               tokenizer=jtok)
    pdata = pdatasets.get_data(SimpleNamespace(device="cpu", **kw), model.preprocess_cfg, ptok)
    assert set(pdata) == set(jdata) == {"val", "imagenet-val"}
    want = jloop.evaluate(jmodel, jdata, 1, SimpleNamespace(**kw), tokenizer=jtok)
    got = ploop.evaluate(model, pdata, 1, SimpleNamespace(**kw), tokenizer=ptok)
    assert got["num_samples"] == want["num_samples"] == (10 if source == "webdataset" else 11)
    assert "imagenet-zeroshot-val-top1" in got and "image_to_text_R@1" in got
    _close(got, want)


def test_zero_shot_runs_at_its_frequency_and_the_last_epoch(setup, small_zero_shot):
    _, model, d = setup
    data = {"imagenet-val": pdatasets.make_imagenet_val(
        str(d / "folder"), oc.transform.host_val_transform(model.preprocess_cfg), 4)}
    args = SimpleNamespace(zeroshot_frequency=2, epochs=3)
    assert pzs.zero_shot_eval(model, data, 1, args, tokenizer=oc.get_tokenizer(NAME)) == {}
    for epoch in (2, 3):
        assert set(pzs.zero_shot_eval(model, data, epoch, args, tokenizer=oc.get_tokenizer(NAME))) \
            == {"imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5"}


WORKER = r'''
import json, os, sys
import torch
rank, world, port, work, repo = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, repo)
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
from types import SimpleNamespace
import open_clip_tpu_torch as oc
import open_clip_tpu_torch.train.zero_shot as pzs
from open_clip_tpu_torch.data.datasets import get_data
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.parallel import distributed as pdist
from open_clip_tpu_torch.parallel.mesh import create_mesh, shard_model
from open_clip_tpu_torch.train.train_loop import evaluate

spec = json.load(open(os.path.join(work, "spec.json")))
pzs.IMAGENET_CLASSNAMES = spec["classes"]
pzs.OPENAI_IMAGENET_TEMPLATES = ["a photo of a {c}.", "a bad photo of the {c}."]
oc.add_model_config(spec["micro"], name=spec["name"])
assert pdist.init_distributed(device="cpu") == (rank, world)
model = CLIPModel(oc.CLIPModelCfg.from_dict(spec["micro"]))
model.load_state_dict(torch.load(os.path.join(spec["data"], "weights.pt"), weights_only=True))
model.preprocess_cfg = oc.PreprocessCfg(size=32)
shard_model(model, create_mesh(data=1, fsdp=world, device="cpu"), min_size=1024)
args = SimpleNamespace(device="cpu", val_data=os.path.join(spec["data"], "val.csv"),
                       dataset_type="csv", batch_size=4, world_size=world, rank=rank, seed=0,
                       imagenet_val=os.path.join(spec["data"], "folder"), zeroshot_frequency=1,
                       epochs=1, val_retrieval_chunk_size=None)
metrics = evaluate(model, get_data(args, model.preprocess_cfg, oc.get_tokenizer(spec["name"])),
                   1, args, tokenizer=oc.get_tokenizer(spec["name"]))
json.dump(metrics, open(os.path.join(work, f"rank{rank}.json"), "w"))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_rank_split_evaluate_in_two_processes_equals_one(setup, small_zero_shot, tmp_path):
    _, model, d = setup
    (tmp_path / "spec.json").write_text(json.dumps({
        "micro": MICRO, "name": NAME, "data": str(d), "classes": list(CLASSES)}))
    (tmp_path / "worker.py").write_text(WORKER)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(r), "2", port,
                               str(tmp_path), str(REPO)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp_path)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    args = SimpleNamespace(device="cpu", val_data=str(d / "val.csv"), dataset_type="csv",
                           batch_size=4, world_size=1, rank=0, seed=0,
                           imagenet_val=str(d / "folder"), zeroshot_frequency=1, epochs=1,
                           val_retrieval_chunk_size=None)
    tok = oc.get_tokenizer(NAME)
    want = ploop.evaluate(model, pdatasets.get_data(args, model.preprocess_cfg, tok), 1, args,
                          tokenizer=tok)
    for r in range(2):
        _close(json.loads((tmp_path / f"rank{r}.json").read_text()), want)


def test_cli_trains_from_shards_then_evaluates(setup, small_zero_shot, tmp_path):
    _, _, d = setup
    common = ["--model", NAME, "--batch-size", "4", "--precision", "fp32", "--device", "cpu",
              "--logs", str(tmp_path), "--val-data", str(d / "val.tar"),
              "--imagenet-val", str(d / "folder"), "--zeroshot-frequency", "1"]
    state = main(common + ["--name", "train", "--train-data", str(d / "train{0..1}.tar"),
                           "--dataset-type", "webdataset", "--device-preprocess",
                           "--native-decode-threads", "2", "--train-num-samples", "16",
                           "--accum-freq", "2", "--epochs", "2", "--lr", "1e-3", "--warmup", "1",
                           "--aug-cfg", "scale=(0.5,1.0)", "--val-frequency", "2"])
    assert state.step == 4  # 16 samples, batches of 4 x 2 microbatches, 2 epochs
    rows = [json.loads(x) for x in (tmp_path / "train" / "results.jsonl").read_text().splitlines()]
    val = [r for r in rows if "val/clip_val_loss" in r]
    assert [r["val/epoch"] for r in val] == [2.0]  # --val-frequency 2: the last epoch only
    for key in ("val/imagenet-zeroshot-val-top1", "val/image_to_text_R@1", "val/num_samples"):
        assert np.isfinite(val[0][key])
    metrics = main(common + ["--name", "eval", "--dataset-type", "webdataset"])
    assert metrics["num_samples"] == 10 and metrics["epoch"] == 0
    assert "imagenet-zeroshot-val-top5" in metrics


def test_cli_refuses_image_train_data_without_device_preprocess(setup, tmp_path):
    _, _, d = setup
    with pytest.raises(NotImplementedError, match="--device-preprocess"):
        main(["--model", NAME, "--train-data", str(d / "train0.tar"), "--device", "cpu",
              "--logs", str(tmp_path), "--name", "x"])
