"""The rest of the train step's options in the port against the JAX package's
``make_train_step``, on the CPU: the EMA of the weights, patch dropout and the
``dots``/``dots_no_batch`` remat policies; and the CLI's ``--ema``,
``--save-most-recent``, ``--delete-previous-checkpoint``, the optimizer flags and the
flags the JAX CLI parses and never reads.

A micro ViT (2 layers, width 64, 16-token context) from JAX ``init_clip`` goes into
the port through ``params_from_jax``; both take the same steps on one seeded batch
in fp32. Tolerances are ``tests/test_torch_train_step.py``'s: loss and grad norm
1e-5 relative, parameters (and the EMA) 2e-2 * lr per step. Patch dropout takes
JAX's own noise (recorded from the JAX step and fed to the port's
``draw_patch_noise``), so both keep the same patches. A remat policy changes what
is stored, not the numbers: the port's dots steps equal its full-remat steps bit for
bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.models import blocks as jblocks
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import vit as jvit
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.checkpoint import load_native, save_native
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.models import blocks as pblocks
from open_clip_tpu_torch.models import vit as pvit
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts
from open_clip_tpu_torch.train.main import main

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

MICRO = {"embed_dim": 32,
         "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8,
                        "head_width": 32},
         "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2}}
LR, WARMUP, WD, CLIP, BATCH = 1e-3, 2, 0.2, 1.0, 4
NAME = "micro-step-options"


def _cfg(patch_dropout=0.0):
    d = json.loads(json.dumps(MICRO))
    d["vision_cfg"]["patch_dropout"] = patch_dropout
    return d


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jclip.init_clip(k, JaxCfg.from_dict(_cfg())))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (BATCH, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(BATCH), rng.integers(2, 16, BATCH)] = 49407
    return params, images, texts


def _steps(params, images, texts, n, *, patch_dropout=0.0, ema=None, remat=False, jax_too=True):
    """n steps in the port (and in JAX): (port state, port metrics, JAX state, JAX metrics)."""
    d = _cfg(patch_dropout)
    cfg = oc.CLIPModelCfg.from_dict(d)
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    state = pts.create_train_state(model, opt, ema=ema is not None)
    step = pts.make_train_step(cfg, opt, ema_decay=ema, remat=remat)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    jstate = jm = None
    if jax_too:
        jparams = jax.tree.map(jnp.asarray, params)
        jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP),
                                       jparams, jsched.const_lr(LR, WARMUP))
        jstate = jts.create_train_state(jparams, jopt, ema=ema is not None)
        jstep = jax.jit(jts.make_train_step(JaxCfg.from_dict(d), jopt, compute_dtype=jnp.float32,
                                            ema_decay=ema, remat=remat))
    for i in range(n):
        if jax_too:
            jstate, jm = jstep(jstate, {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                               jax.random.PRNGKey(i))
        state, m = step(state, batch)
        if jax_too:
            assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
            assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    return state, m, jstate, jm, cfg


def _close(got, want, n):
    for k, w in want.items():
        diff = (got[k].detach() - w).abs().max().item()
        assert diff <= 2e-2 * LR * n, (k, diff)


def test_ema_steps_match_jax(setup):
    params, images, texts = setup
    state, _, jstate, _, cfg = _steps(params, images, texts, 3, ema=0.9)
    names = [n for n, _ in state.model.named_parameters()]
    got = dict(zip(names, state.ema))
    _close(got, params_from_jax(jax.tree.map(np.asarray, jstate.ema_params), cfg), 3)
    _close(dict(state.model.named_parameters()),
           params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg), 3)
    with pts.ema_weights(state) as model:  # evaluation sees the EMA, then the raw weights
        assert all(torch.equal(p, e) for p, e in zip(model.parameters(), state.ema))
    assert not any(torch.equal(p, e) for p, e in zip(state.model.parameters(), state.ema)
                   if p.ndim > 1)


def test_ema_resume_equals_an_uninterrupted_run(setup, tmp_path):
    params, images, texts = setup
    whole, *_ = _steps(params, images, texts, 3, ema=0.9, jax_too=False)
    part, *_ = _steps(params, images, texts, 1, ema=0.9, jax_too=False)
    save_native(tmp_path / "c.pt", part, epoch=1)
    cfg = oc.CLIPModelCfg.from_dict(_cfg())
    model = CLIPModel(cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    resumed = pts.create_train_state(model, opt, ema=True)
    load_native(tmp_path / "c.pt", like=resumed)
    step = pts.make_train_step(cfg, opt, ema_decay=0.9)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    for _ in range(2):
        resumed, _ = step(resumed, batch)
    for a, b in zip(whole.ema + whole.params, resumed.ema + resumed.params):
        assert torch.equal(a, b)
    no_ema = pts.create_train_state(CLIPModel(cfg), opt)
    save_native(tmp_path / "plain.pt", no_ema, epoch=1)
    with pytest.raises(ValueError, match="no EMA"):
        load_native(tmp_path / "plain.pt", like=resumed)
    with pytest.raises(ValueError, match="ema=True"):
        pts.make_train_step(cfg, opt, ema_decay=0.9)(no_ema, batch)


def test_patch_dropout_matches_jax(setup):
    """Given the same noise, the same patches survive."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 17, 8)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jvit.patch_dropout(key, jnp.asarray(x), 0.5, num_prefix=1)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (3, 16))))
    got = pvit.patch_dropout(torch.from_numpy(x), 0.5, num_prefix=1, noise=noise)
    assert got.shape == (3, 9, 8)  # the class token and max(1, int(16 * 0.5)) patches
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pvit.patch_dropout(torch.from_numpy(x), 0.97, 0, noise=noise[:, :1].expand(3, 17)
                              ).shape == (3, 1, 8)  # at least one patch
    assert torch.equal(pvit.patch_dropout(torch.from_numpy(x), 0.0), torch.from_numpy(x))


def test_patch_dropout_steps_match_jax(setup, monkeypatch):
    params, images, texts = setup
    noises = []
    jax_dropout = jvit.patch_dropout

    def recording(key, x, prob, num_prefix=1):
        noise = jax.random.uniform(key, (x.shape[0], x.shape[1] - num_prefix))
        jax.debug.callback(lambda n: noises.append(np.asarray(n)), noise)
        return jax_dropout(key, x, prob, num_prefix)

    monkeypatch.setattr(jvit, "patch_dropout", recording)
    fed = []

    def jax_noise(b, n, device, generator):
        assert generator is not None  # the step draws from its own generator
        fed.append((b, n))
        return torch.from_numpy(noises.pop(0))

    monkeypatch.setattr(pvit, "draw_patch_noise", jax_noise)
    state, _, jstate, _, cfg = _steps(params, images, texts, 2, patch_dropout=0.5)
    assert fed == [(BATCH, 16)] * 2 and not noises
    _close(dict(state.model.named_parameters()),
           params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg), 2)
    # evaluation keeps every patch
    with torch.no_grad():
        a = oc.encode_image(state.model, torch.from_numpy(images))
        b = oc.encode_image(state.model, torch.from_numpy(images))
    assert torch.equal(a, b)


def test_patch_dropout_draws_from_the_step_seed(setup):
    """Without a recorded noise the port draws from the step's own generator: two runs
    from the same start are equal, and the patches differ from step to step."""
    params, images, texts = setup
    a, ma, *_ = _steps(params, images, texts, 2, patch_dropout=0.5, jax_too=False)
    b, mb, *_ = _steps(params, images, texts, 2, patch_dropout=0.5, jax_too=False)
    assert ma["loss"].item() == mb["loss"].item()
    assert all(torch.equal(x, y) for x, y in zip(a.params, b.params))
    gen = torch.Generator().manual_seed(pts._seed(0, 0) * 64 + 32)
    assert pvit.draw_patch_noise(2, 4, "cpu", gen).shape == (2, 4)
    with pytest.raises(ValueError, match="torch.Generator"):
        pvit.draw_patch_noise(2, 4, "cpu", None)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_dots_policies_match_jax_and_full_remat(setup, policy, monkeypatch):
    params, images, texts = setup
    saved_ops = []
    save_ops = pblocks._save_ops

    def spy(saved, ctx, op, *args, **kwargs):
        decision = save_ops(saved, ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved_ops.append(str(op))
        return decision

    monkeypatch.setattr(pblocks, "_save_ops", spy)
    monkeypatch.setattr(jblocks, "REMAT_POLICY", policy)
    monkeypatch.setattr(pblocks, "REMAT_POLICY", policy)
    state, m, jstate, _, cfg = _steps(params, images, texts, 2, remat=True)
    _close(dict(state.model.named_parameters()),
           params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg), 2)
    kinds = set(saved_ops)
    assert "aten.mm.default" in kinds
    # the dense attention's batched products (the CPU's path) only under "dots"
    assert ("aten.bmm.default" in kinds) == (policy == "dots")
    monkeypatch.setattr(pblocks, "REMAT_POLICY", "none")
    full, mf, *_ = _steps(params, images, texts, 2, remat=True, jax_too=False)
    assert m["loss"].item() == mf["loss"].item()
    assert all(torch.equal(x, y) for x, y in zip(state.params, full.params))


# ---------------------------------------------------------------- the CLI

def _args(tmp_path, name, *extra):
    return ["--model", NAME, "--dataset-type", "synthetic", "--train-num-samples", "8",
            "--batch-size", "4", "--lr", "1e-3", "--warmup", "1", "--precision", "fp32",
            "--logs", str(tmp_path), "--name", name, "--device", "cpu", "--seed", "1", *extra]


@pytest.fixture(scope="module")
def registered():
    oc.add_model_config(_cfg(), name=NAME)


def _final(state):
    return [p.detach().clone() for p in state.params]


def test_cli_checkpoint_rotation_leaves_jax_files(registered, tmp_path):
    """--save-frequency 2 over 3 epochs with --save-most-recent and
    --delete-previous-checkpoint: the JAX CLI leaves epoch_2, epoch_3 and epoch_latest
    pointing at epoch_3 (its epoch-1 epoch_latest, written whole, was replaced by the
    link); the port leaves the same names as .pt files."""
    state = main(_args(tmp_path, "rot", "--epochs", "3", "--save-frequency", "2",
                       "--save-most-recent", "--delete-previous-checkpoint", "--ema", "0.9"))
    ck = tmp_path / "rot" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["epoch_2.pt", "epoch_3.pt", "epoch_latest.pt"]
    assert os.readlink(ck / "epoch_latest.pt") == "epoch_3.pt"
    assert state.step == 6 and state.ema is not None
    state = main(_args(tmp_path, "every", "--epochs", "3", "--save-most-recent",
                       "--delete-previous-checkpoint"))
    ck = tmp_path / "every" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["epoch_3.pt", "epoch_latest.pt"]
    assert oc.checkpoint.get_latest_checkpoint(ck) == str(ck / "epoch_latest.pt")


def test_cli_ema_resume_equals_an_uninterrupted_run(registered, tmp_path):
    flags = ("--ema", "0.9", "--save-most-recent")
    whole = main(_args(tmp_path, "whole", "--epochs", "2", *flags))
    main(_args(tmp_path, "part", "--epochs", "1", *flags))
    resumed = main(_args(tmp_path, "part", "--epochs", "2", "--resume", "latest", *flags))
    assert resumed.step == whole.step == 4
    for a, b in zip(whole.ema + _final(whole), resumed.ema + _final(resumed)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra", [["--opt", "lion"], ["--opt", "sgd", "--momentum", "0.8"],
                                   ["--opt", "muon", "--momentum", "0.95"],
                                   ["--force-patch-dropout", "0.5"],
                                   ["--grad-checkpointing", "--remat-policy", "dots"],
                                   ["--grad-checkpointing", "--remat-policy", "dots_no_batch"]])
def test_cli_new_flags_run(registered, tmp_path, extra):
    state = main(_args(tmp_path, "f", "--epochs", "1", *extra))
    assert state.step == 2 and all(bool(torch.isfinite(p).all()) for p in state.params)
    assert pblocks.REMAT_POLICY == "none"  # restored after the run


def test_cli_flags_parsed_and_unread_change_nothing(registered, tmp_path):
    """The flags the JAX CLI parses and never reads: accepted, same weights."""
    base = main(_args(tmp_path, "base", "--epochs", "1"))
    noop = ["--image-key", "png", "--json-text-key-probs", "0.5", "--max-image-pixels", "100",
            "--val-retrieval-precision", "bf16", "--naflex-max-text-tokens", "8",
            "--naflex-num-train-image-tokens", "8", "--use-naflex", "--force-naflex-vision",
            "--text-pad-multiple", "8", "--opt-kwargs", "foreach=1", "--opt-fallback-list",
            "adamw", "--text-pooler-own-group", "--naflex-pad-multiple", "8"]
    other = main(_args(tmp_path, "noop", "--epochs", "1", *noop))
    assert all(torch.equal(a, b) for a, b in zip(_final(base), _final(other)))
