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

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

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


def test_training_synthetic_with_device_preprocess(tmp_path):
    """--device-preprocess: the synthetic batch is the blank uint8 canvas, which the step
    crops and normalizes; identical samples, so the loss is ln(batch)."""
    state = main(_args(tmp_path, "dpp", "--epochs", "1", "--device-preprocess",
                       "--aug-cfg", "scale=(0.5,1.0)"))
    assert state.step == 4
    rows = [json.loads(line) for line in (tmp_path / "dpp" / "results.jsonl").read_text().splitlines()]
    assert all(r["train/loss"] == pytest.approx(math.log(8), abs=1e-4) for r in rows)


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
    # --accum-freq 2: batches of 8 x 2 rows (the JAX rule), 2 steps an epoch
    main(_args(tmp_path, "a", "--epochs", "1", "--accum-freq", "2"))
    path = tmp_path / "a" / "checkpoints" / "epoch_1.pt"
    state = main(_args(tmp_path, "b", "--epochs", "2", "--resume", str(path), "--accum-freq", "2",
                       "--grad-checkpointing", "--lr-scheduler", "const-cooldown",
                       "--epochs-cooldown", "1", "--save-frequency", "5"))
    assert state.step == 4
    assert sorted(p.name for p in (tmp_path / "b" / "checkpoints").iterdir()) == ["epoch_2.pt"]


def test_resume_latest_without_a_checkpoint_starts_fresh(tmp_path):
    assert main(_args(tmp_path, "none", "--epochs", "1", "--resume", "latest")).step == 4


def test_cli_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _args(tmp_path, "nocard", "--epochs", "1") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)


@pytest.mark.parametrize("extra", [
    ["--audio-fusion"], ["--wandb-project-name", "x"],
    ["--remote-sync-frequency", "60"], ["--torchcompile-mode", "max-autotune"],
    ["--log-local"], ["--wandb-notes", "x"],
    ["--copy-codebase"], ["--mesh-tensor", "2"],
    ["--audio-zeroshot-multiprocessing-context", "spawn"],
    ["--scan-unroll", "2"], ["--cache-dir", "x"], ["--profile-dir", "x"],
    ["--remote-sync", "s3://x"], ["--report-to", "wandb"], ["--checkpoint-format", "torch"],
    ["--torchcompile-backend", "inductor"], ["--torchcompile"],
    ["--audio-multiprocessing-context", "spawn"],
])
def test_unported_flags_raise(extra):
    with pytest.raises(NotImplementedError, match=extra[0]):
        pparams.parse_args(["--model", "ViT-B-32", *extra])


def test_use_switchback_runs(tmp_path):
    """--use-switchback trains (the int8 forward of every MLP linear; on the CPU its
    plain version) with the names_mm remat preset, and the run restores the switch."""
    from open_clip_tpu_torch.models import blocks

    state = main(_args(tmp_path, "sb", "--epochs", "1", "--use-switchback", "--grad-checkpointing",
                       "--remat-policy", "names_mm"))
    assert state.step == 4
    rows = [json.loads(line) for line in (tmp_path / "sb" / "results.jsonl").read_text().splitlines()]
    assert all(r["train/loss"] == pytest.approx(math.log(8), abs=1e-4) for r in rows)
    assert "use_switchback: True" in (tmp_path / "sb" / "params.txt").read_text()
    assert (blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY) == ("dense", "none")


@pytest.mark.parametrize("extra,where", [(["--opt", "lion_v2"], "optimizer"),
                                         (["--dataset-type", "webdataset-naflex"], "dataset type")])
def test_unported_choices_raise_in_main(tmp_path, extra, where):
    """Every optimizer and dataset type of the JAX CLI is ported: an optimizer it does
    not know raises, as does NaFlex data for a tower that takes image tensors."""
    args = [a for a in _args(tmp_path, "x", "--epochs", "1")]
    if extra[0] == "--dataset-type":
        i = args.index("--dataset-type")
        args[i:i + 2] = extra
    else:
        args += extra
    with pytest.raises(ValueError, match=where):
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
    # webdataset-naflex: the JAX rule, max(1, n * shortest bucket // token budget), or 8
    Args.dataset_type, Args.train_data, Args.naflex_seq_lens = "webdataset-naflex", "x.tar", [64]
    Args.naflex_max_tokens, Args.train_num_samples = 256, 32
    assert get_data(Args, oc.PreprocessCfg(size=32), None)["train"].num_batches == 8
    Args.train_num_samples = None
    assert get_data(Args, oc.PreprocessCfg(size=32), None)["train"].num_batches == 8
    Args.train_num_samples = 2
    assert get_data(Args, oc.PreprocessCfg(size=32), None)["train"].num_batches == 1


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


# ---------------------------------------------------------------------------
# NaFlex: --dataset-type synthetic-naflex
# ---------------------------------------------------------------------------

NAFLEX_NAME = "tiny-torch-cli-naflex"
NAFLEX_TINY = {
    "embed_dim": 32, "custom_text": True,
    "vision_cfg": {"image_size": 64, "timm_model_name": "naflexvit_tiny_patch16_gap",
                   "timm_model_kwargs": {"embed_dim": 64, "depth": 2, "num_heads": 2,
                                         "pos_embed_grid_size": [4, 4]}},
    "text_cfg": TINY["text_cfg"],
}


def _naflex_args(tmp_path, name, *extra):
    if NAFLEX_NAME not in oc.list_models():
        oc.add_model_config(dict(NAFLEX_TINY), name=NAFLEX_NAME)
    return ["--model", NAFLEX_NAME, "--dataset-type", "synthetic-naflex", "--naflex-seq-lens", "32",
            "64", "--naflex-max-tokens", "256", "--naflex-batch-divisor", "2",
            "--train-num-samples", "32", "--batch-size", "8", "--lr", "1e-3", "--warmup", "2",
            "--precision", "fp32", "--logs", str(tmp_path), "--name", name, "--device", "cpu",
            "--log-every-n-steps", "1", "--epochs", "1", *extra]


def test_training_synthetic_naflex_smoke(tmp_path):
    """Token-budget buckets: 32 tokens -> batch 8, 64 tokens -> batch 4; identical
    samples, so each step's loss is ln(its batch)."""
    from open_clip_tpu.data.naflex import NaFlexBatchScheduler as JaxScheduler
    from open_clip_tpu.data.naflex import NaFlexDataConfig as JaxDataConfig

    state = main(_naflex_args(tmp_path, "naflex", "--grad-clip-norm", "1.0"))
    assert state.step == 4
    schedule = JaxScheduler(JaxDataConfig(seq_lens=(32, 64), max_tokens_per_batch=256,
                                          batch_divisor=2, seed=0), 4).schedule(0)
    rows = [json.loads(line) for line in (tmp_path / "naflex" / "results.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    for row, (_, _, batch) in zip(rows, schedule):
        assert row["train/loss"] == pytest.approx(math.log(batch), abs=1e-4)
    assert (tmp_path / "naflex" / "checkpoints" / "epoch_1.pt").exists()


@pytest.mark.parametrize("mode", ["linear", "sqrt"])
def test_training_synthetic_naflex_loss_scale_and_accumulation(tmp_path, mode):
    """--naflex-loss-scale scales by (batch / --batch-size); --accum-freq slices the
    patch dicts."""
    state = main(_naflex_args(tmp_path, mode, "--naflex-loss-scale", mode, "--accum-freq", "2",
                              "--naflex-seq-lens", "64"))
    assert state.step == 2  # 32 samples // (8 x 2): --accum-freq multiplies the batch
    rows = [json.loads(line) for line in (tmp_path / mode / "results.jsonl").read_text().splitlines()]
    ratio = 4 / 8  # 64-token bucket: batch 4, against --batch-size 8
    want = math.log(4) * (ratio if mode == "linear" else ratio ** 0.5)
    assert all(r["train/loss"] == pytest.approx(want, abs=1e-4) for r in rows)


def test_naflex_cli_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _naflex_args(tmp_path, "nocard") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        oc.create_model_and_transforms("naflex_ViT-B-16")


@pytest.mark.parametrize("extra", [
    ["--naflex-seq-len-probs", "0.5", "0.5"], ["--naflex-patch-size-probs", "1.0"],
    ["--naflex-pad-multiple", "64"], ["--naflex-max-text-tokens", "4096"],
    ["--naflex-num-train-image-tokens", "100000"], ["--use-naflex"], ["--force-naflex-vision"],
    ["--length-bucketing"], ["--dataset-type", "webdataset-naflex", "--train-data", "x.tar"],
])
def test_unported_naflex_flags_raise(tmp_path, extra):
    """These flags raised until the NaFlex webdataset was ported; now they run (a
    webdataset-naflex shard that does not exist yields no batch, so no step)."""
    state = main(_naflex_args(tmp_path, "x") + extra)
    assert state.step == (0 if "webdataset-naflex" in extra else 4)


def test_naflex_flags_parse_with_the_jax_names():
    ns = pparams.parse_args(["--naflex-seq-lens", "576", "1024", "--naflex-patch-sizes", "16", "32",
                             "--naflex-max-tokens-per-batch", "8192", "--naflex-batch-divisor", "4",
                             "--naflex-loss-scale", "sqrt"])
    assert (ns.naflex_seq_lens, ns.naflex_patch_sizes, ns.naflex_max_tokens,
            ns.naflex_batch_divisor, ns.naflex_loss_scale) == ([576, 1024], [16, 32], 8192, 4, "sqrt")


def test_get_data_synthetic_naflex_counts_batches():
    class Args:
        dataset_type, batch_size, train_num_samples, device = "synthetic-naflex", 8, 40, "cpu"
        naflex_seq_lens, naflex_patch_sizes, naflex_max_tokens = (16,), (16,), 64
        naflex_batch_divisor, seed = 1, 0

    data = get_data(Args, oc.PreprocessCfg(size=32), oc.get_tokenizer("ViT-B-32", context_length=16))
    assert data["train"].num_samples == 40 and data["train"].num_batches == 5
    batches = list(data["train"].dataloader)
    assert len(batches) == 5
    assert batches[0]["image"]["patches"].shape == (4, 16, 768)
    assert batches[0]["text"].shape == (4, 16) and batches[0]["text"].dtype == torch.int32
    assert int(batches[0]["image"]["patch_valid"].sum()) == 4 * 12  # 96x64 resized to a 3x4 grid
