"""The port's training CLI on the CPU with a tiny model and synthetic data, and its
counterpart pieces (``SyntheticDataset``, checkpoints, ``AverageMeter``) against
the JAX package's.
"""

import json
import math

import numpy as np
import pytest
import torch

import open_clip_tpu as oct
from open_clip_tpu.data.datasets import SyntheticDataset as JaxSyntheticDataset
from open_clip_tpu.train import params as jparams

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import checkpoint as pckpt
from open_clip_tpu_torch.data import SyntheticDataset, get_data
from open_clip_tpu_torch.train import params as pparams
from open_clip_tpu_torch.train.main import main
from open_clip_tpu_torch.train.train_loop import AverageMeter

TINY = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16, "head_width": 32},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 64, "heads": 2, "layers": 2},
}
NAME = "tiny-torch-cli-vit"


@pytest.fixture(scope="module", autouse=True)
def tiny_model():
    if NAME not in oc.list_models():
        oc.add_model_config(dict(TINY), name=NAME)


def _args(tmp_path, name, *extra):
    return ["--model", NAME, "--dataset-type", "synthetic", "--train-num-samples", "32",
            "--batch-size", "8", "--lr", "1e-3", "--warmup", "2", "--precision", "fp32",
            "--logs", str(tmp_path), "--name", name, "--device", "cpu",
            "--log-every-n-steps", "1", *extra]


def test_training_synthetic_smoke(tmp_path):
    state = main(_args(tmp_path, "smoke", "--epochs", "2", "--grad-clip-norm", "1.0"))
    assert state.step == 8  # 4 steps an epoch, 2 epochs
    run = tmp_path / "smoke"
    assert (run / "checkpoints" / "epoch_1.pt").exists()
    assert (run / "checkpoints" / "epoch_2.pt").exists()
    text = (run / "params.txt").read_text()
    assert f"model: {NAME}" in text and "batch_size: 8" in text and "device: cpu" in text
    rows = [json.loads(line) for line in (run / "results.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 9))
    # identical samples: the loss is ln(batch) whatever the weights
    assert all(r["train/loss"] == pytest.approx(math.log(8), abs=1e-4) for r in rows)
    # the schedule is read at the optimizer's count, 0 on the first step
    assert rows[0]["train/lr"] == pytest.approx(1e-3 * 1 / 2)
    assert rows[1]["train/lr"] == pytest.approx(1e-3)
    assert all(math.isfinite(r["train/grad_norm"]) for r in rows)


def test_training_resume_latest(tmp_path):
    const = ("--lr-scheduler", "const")  # a schedule that does not depend on --epochs
    main(_args(tmp_path, "resume", "--epochs", "1", *const))
    state = main(_args(tmp_path, "resume", "--epochs", "2", "--resume", "latest", *const))
    assert state.step == 8  # resumed at step 4 of epoch 1, 4 more
    assert state.opt_state["count"] == 8
    fresh = main(_args(tmp_path, "fresh", "--epochs", "2", *const))
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k  # a resumed run ends where an uninterrupted one does


def test_training_resume_from_a_path_with_options(tmp_path):
    main(_args(tmp_path, "a", "--epochs", "1"))
    path = tmp_path / "a" / "checkpoints" / "epoch_1.pt"
    state = main(_args(tmp_path, "b", "--epochs", "2", "--resume", str(path), "--accum-freq", "2",
                       "--grad-checkpointing", "--lr-scheduler", "const-cooldown",
                       "--epochs-cooldown", "1", "--save-frequency", "5"))
    assert state.step == 8
    assert sorted(p.name for p in (tmp_path / "b" / "checkpoints").iterdir()) == ["epoch_2.pt"]


def test_resume_latest_without_a_checkpoint_starts_fresh(tmp_path):
    assert main(_args(tmp_path, "none", "--epochs", "1", "--resume", "latest")).step == 4


def test_cli_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _args(tmp_path, "nocard", "--epochs", "1") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)


@pytest.mark.parametrize("extra", [
    ["--siglip"], ["--ema", "0.999"], ["--lock-image"], ["--layer-decay", "0.75"],
    ["--train-data", "shards-{000..010}.tar"], ["--val-data", "val.csv"],
    ["--imagenet-val", "imagenet/val"], ["--mesh-fsdp", "2"], ["--distill-model", "ViT-B-32"],
    ["--pretrained", "openai"], ["--remat-policy", "names"], ["--device-preprocess"],
    ["--use-switchback"], ["--report-to", "wandb"], ["--save-most-recent"],
    ["--force-patch-dropout", "0.5"], ["--torchcompile"], ["--momentum", "0.8"],
])
def test_unported_flags_raise(extra):
    with pytest.raises(NotImplementedError, match=extra[0]):
        pparams.parse_args(["--model", "ViT-B-32", *extra])


@pytest.mark.parametrize("extra,where", [(["--opt", "lion"], "optimizer"),
                                         (["--dataset-type", "csv"], "dataset type")])
def test_unported_choices_raise_in_main(tmp_path, extra, where):
    args = [a for a in _args(tmp_path, "x", "--epochs", "1")]
    if extra[0] == "--dataset-type":
        i = args.index("--dataset-type")
        args[i:i + 2] = extra
    else:
        args += extra
    with pytest.raises(NotImplementedError, match=where):
        main(args)


def test_flag_defaults_match_the_jax_cli():
    """Every flag the port's CLI obeys or accepts carries the JAX CLI's default
    (``--device`` is the port's own)."""
    ours = vars(pparams.parse_args([]))
    theirs = vars(jparams.parse_args([]))
    assert set(theirs) - set(ours) == set()
    for key, value in ours.items():
        assert theirs[key] == value, key


def test_synthetic_dataset_matches_jax():
    from open_clip_tpu.transform import image_transform

    tok = oc.get_tokenizer("ViT-B-32", context_length=16)
    jtok = oct.get_tokenizer("ViT-B-32", context_length=16)
    want = next(iter(JaxSyntheticDataset(image_transform(32, is_train=False), jtok,
                                         image_size=(32, 32), dataset_size=8, batch_size=4)))
    ds = SyntheticDataset(oc.PreprocessCfg(size=32), tok, dataset_size=8, batch_size=4)
    batches = list(ds)
    assert len(batches) == 2
    np.testing.assert_allclose(batches[0]["image"].numpy(), want["image"], atol=1e-6)
    np.testing.assert_array_equal(batches[0]["text"].numpy(), want["text"])
    assert batches[0]["image"].data_ptr() != batches[1]["image"].data_ptr()  # a copy per batch


def test_get_data_counts_batches():
    class Args:
        dataset_type, batch_size, train_num_samples, device = "synthetic", 8, 32, "cpu"

    data = get_data(Args, oc.PreprocessCfg(size=32), oc.get_tokenizer("ViT-B-32", context_length=16))
    assert data["train"].num_samples == 32 and data["train"].num_batches == 4
    data["train"].set_epoch(1)
    Args.dataset_type = "webdataset"
    with pytest.raises(NotImplementedError):
        get_data(Args, oc.PreprocessCfg(size=32), None)


def test_checkpoint_round_trip_and_latest(tmp_path):
    from open_clip_tpu_torch.models.clip import CLIPModel
    from open_clip_tpu_torch.train.optim import OptimizerCfg, create_optimizer
    from open_clip_tpu_torch.train.train_step import create_train_state

    def fresh(seed):
        model = CLIPModel(oc.CLIPModelCfg.from_dict(TINY))
        model.init_weights(torch.Generator().manual_seed(seed))
        opt = create_optimizer(OptimizerCfg(), model, lambda s: 1e-3)
        return create_train_state(model, opt)

    a = fresh(0)
    a.step, a.opt_state["count"] = 7, 7
    for t in a.opt_state["mu"] + a.opt_state["nu"]:
        t.add_(1.5)
    assert pckpt.get_latest_checkpoint(tmp_path) is None
    pckpt.save_native(tmp_path / "epoch_2.pt", a, epoch=2)
    pckpt.save_native(tmp_path / "epoch_10.pt", a, epoch=10)
    assert pckpt.get_latest_checkpoint(tmp_path).endswith("epoch_10.pt")  # by number, not by name
    assert not list(tmp_path.glob("*.tmp"))
    b = fresh(1)
    assert pckpt.load_native(tmp_path / "epoch_2.pt", like=b) == 2
    assert b.step == 7 and b.opt_state["count"] == 7
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a.opt_state[key], b.opt_state[key]))


def test_average_meter():
    m = AverageMeter()
    m.update(2.0)
    m.update(4.0, n=3)
    assert m.val == 4.0 and m.count == 4 and m.avg == pytest.approx(3.5)
