"""The port's distillation step against the JAX package's, on the CPU at a micro size.

A micro student CLIP (2 layers a tower, width 64) and a micro teacher (2 layers,
width 32, another embedding width) get their params from the JAX package's
``init_clip`` (seeds 0 and 1); ``params_from_jax`` carries them into the port. The
batch comes from a numpy seed. Both packages step the student with plain gradient
descent (lr 0.1), so each step's gradient is (p - p') / lr.

Tolerances (fp32): loss and its terms 1e-5 relative; gradients 2e-6 absolute plus
1e-4 relative of the tensor's largest in the first step (``test_torch_train_step.py``'s),
1e-3 in later ones, which start from parameters that already differ by rounding;
parameters 1e-5 absolute per step taken. The loss classes
1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.loss import DistillClipLoss as JaxDistillClipLoss
from open_clip_tpu.loss import clip_loss as jax_clip_loss
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import loss as ploss
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

STUDENT = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16, "head_width": 32},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 64, "heads": 2, "layers": 2},
}
TEACHER = {
    "embed_dim": 24,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 32, "patch_size": 8, "head_width": 16},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 32, "heads": 2, "layers": 2},
}
BATCH, LR = 8, 0.1


@pytest.fixture(scope="module")
def setup():
    out = []
    for seed, raw in ((0, STUDENT), (1, TEACHER)):
        jcfg = JaxCfg.from_dict(raw)
        params = jax.tree.map(np.asarray, jax.jit(lambda k: jclip.init_clip(k, jcfg))(
            jax.random.PRNGKey(seed)))
        out.append((jcfg, params, oc.CLIPModelCfg.from_dict(raw)))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (BATCH, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(BATCH), rng.integers(2, 16, BATCH)] = 49407
    return out[0], out[1], images, texts


def port_model(params, cfg):
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def close(a, b, atol, rtol=0.0):
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, dtype=np.float64)
            for x in (a, b))
    assert a.shape == b.shape
    diff = np.abs(a - b).max()
    assert diff <= atol + rtol * np.abs(b).max(), diff


_JAX = {}


def jax_fns(student, teacher):
    """The jitted JAX step (simple and GradCache, plain gradient descent) and the
    step's two terms at the student's params."""
    if not _JAX:
        (jcfg, _, _), (tcfg, tparams, _) = student, teacher
        opt = optax.chain(optax.trace(decay=0.0, nesterov=True), optax.scale(-LR))
        for accum in (1, 2):
            _JAX[accum] = jax.jit(jts.make_train_step(
                jcfg, opt, loss_type="distill", compute_dtype=jnp.float32, accum_steps=accum,
                teacher=(tcfg, jax.tree.map(jnp.asarray, tparams))))
        _JAX["opt"] = opt

        @jax.jit
        def terms(p, img, txt):
            out = jclip.clip_forward(p, jcfg, img, txt, train=True, compute_dtype=jnp.float32)
            t = jclip.clip_forward(jax.tree.map(jnp.asarray, tparams), tcfg, img, txt,
                                   compute_dtype=jnp.float32)
            closs, dloss = JaxDistillClipLoss()(
                out["image_features"], out["text_features"], jnp.exp(p["logit_scale"]),
                t["image_features"], t["text_features"], t["logit_scale"])
            return closs, dloss

        _JAX["terms"] = terms
    return _JAX


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("accum", [1, 2], ids=["simple", "gradcache"])
def test_distill_steps_match_jax(setup, accum, n_steps):
    """``make_train_step(loss_type="distill", teacher=...)``, plain and GradCache (2
    microbatches), against the JAX step: each step's loss, its contrastive and
    distillation terms, every gradient and every parameter after it; the teacher
    does not move."""
    student, teacher, images, texts = setup
    (jcfg, params, cfg), (_, tparams, tcfg) = student, teacher
    fns = jax_fns(student, teacher)
    jstate = jts.create_train_state(jax.tree.map(jnp.asarray, params), fns["opt"])
    model, tmodel = port_model(params, cfg), port_model(tparams, tcfg)
    t_before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    opt = poptim.create_optimizer(poptim.OptimizerCfg(opt="sgd", momentum=0.0, lr=LR, wd=0.0),
                                  model, lambda step: LR)
    state = pts.create_train_state(model, opt)
    step = pts.make_train_step(cfg, opt, loss_type="distill", accum_steps=accum, teacher=tmodel)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    for i in range(n_steps):
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        closs, dloss = (float(x) for x in fns["terms"](jstate.params, jnp.asarray(images),
                                                        jnp.asarray(texts)))
        jstate, jm = fns[accum](jstate, {"image": jnp.asarray(images),
                                         "text": jnp.asarray(texts)}, jax.random.PRNGKey(0))
        state, m = step(state, batch)
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert m["contrastive_loss"].item() == pytest.approx(closs, rel=1e-5)
        assert m["distill_loss"].item() == pytest.approx(dloss, rel=1e-5)
        assert m["loss"].item() == pytest.approx(closs + dloss, rel=1e-5)
        assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
        for k, p in model.named_parameters():
            close((before[k] - p.detach()) / LR, (before[k] - want[k]) / LR, 2e-6,
                  1e-4 if i == 0 else 1e-3)  # the gradient
            close(p.detach(), want[k], 1e-5 * (i + 1))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, t_before[k]), k
    assert all(p.grad is None for p in tmodel.parameters())


def test_distill_losses_match_jax(setup):
    """``distill_kl`` (the step's term, this batch's logits) and ``DistillClipLoss``
    against the JAX class on the same features."""
    rng = np.random.default_rng(3)
    imf, txf = (rng.standard_normal((BATCH, 16)).astype(np.float32) for _ in range(2))
    timf, ttxf = (rng.standard_normal((BATCH, 12)).astype(np.float32) for _ in range(2))
    want = JaxDistillClipLoss()(*(jnp.asarray(x) for x in (imf, txf)), jnp.float32(7.0),
                                *(jnp.asarray(x) for x in (timf, ttxf)), jnp.float32(12.0),
                                output_dict=True)
    got = ploss.DistillClipLoss()(*(torch.from_numpy(x) for x in (imf, txf)), torch.tensor(7.0),
                                  *(torch.from_numpy(x) for x in (timf, ttxf)),
                                  torch.tensor(12.0), output_dict=True)
    for key in want:
        assert got[key].item() == pytest.approx(float(want[key]), rel=1e-6)
    kl = ploss.distill_kl(*(torch.from_numpy(x) for x in (imf, txf)), torch.tensor(7.0),
                          *(torch.from_numpy(x) for x in (timf, ttxf)), torch.tensor(12.0))
    assert kl.item() == pytest.approx(float(want["distill_loss"]), rel=1e-6)
    closs = jax_clip_loss(jnp.asarray(imf), jnp.asarray(txf), jnp.float32(7.0))
    assert got["contrastive_loss"].item() == pytest.approx(float(closs), rel=1e-6)


def test_distill_step_needs_a_teacher_and_refuses_a_mesh(setup):
    (_, params, cfg), _, _, _ = setup
    model = port_model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(), model, lambda s: 1e-3)
    with pytest.raises(ValueError, match="teacher"):
        pts.make_train_step(cfg, opt, loss_type="distill")
    with pytest.raises(NotImplementedError, match="under a mesh"):
        pts.make_train_step(cfg, opt, loss_type="distill", teacher=model, mesh="a mesh")


STUDENT_NAME, TEACHER_NAME = "micro-distill-student", "micro-distill-teacher"


def test_cli_distills(tmp_path):
    """``--distill-model``: the teacher is built as the student is, from ``--seed``
    (random weights) or ``--distill-pretrained``; the run's loss is the contrastive
    loss plus the KL, and ``--mesh-fsdp 2`` refuses."""
    from open_clip_tpu_torch.train.main import main

    oc.add_model_config(dict(STUDENT), name=STUDENT_NAME)
    oc.add_model_config(dict(TEACHER), name=TEACHER_NAME)
    args = ["--model", STUDENT_NAME, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "8", "--lr", "1e-3", "--precision", "fp32", "--logs", str(tmp_path),
            "--device", "cpu", "--epochs", "1", "--distill-model", TEACHER_NAME]
    state = main(args + ["--name", "seeded"])
    assert state.step == 2
    teacher = oc.create_model(TEACHER_NAME, device="cpu", seed=3)
    path = tmp_path / "teacher.pt"
    torch.save(oc.convert.reference_state_dict(teacher), path)
    state = main(args + ["--name", "pretrained", "--distill-pretrained", str(path)])
    assert state.step == 2
    assert "distill_model: micro-distill-teacher" in (
        tmp_path / "pretrained" / "params.txt").read_text()
    with pytest.raises(NotImplementedError, match="under a mesh"):
        main(args + ["--name", "mesh", "--mesh-fsdp", "2"])
