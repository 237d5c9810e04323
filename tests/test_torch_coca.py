"""The port's CoCa against the JAX package's, on the CPU at a micro size.

A micro CoCa (vision: width 64, 2 layers, 32-pixel images in 8-pixel patches, an
attentional pooler of 8 queries in each of its three forms, and one more with a
vision width of 96, whose pooler takes separate k/v projections from 96; text: width
64, 2 layers, context 12, ``embed_cls``; decoder: 2 layers, a vocabulary of 100)
gets its params from the JAX package's ``init_clip``; ``params_from_jax`` carries
them into the port. Inputs come from a numpy seed.

Tolerances (fp32): features and logits 1e-5 absolute (they are below ~5 in size,
summed in other orders through 2 + 2 + 2 layers). Captions token for token.
Filtered sampling logits 1e-5 absolute where finite, the same entries at the
float32 minimum. The fused cross-entropy 1e-6 relative, its gradients 1e-6
absolute. Train steps (plain gradient descent, lr 0.1, so that each step's
gradient is (p - p') / lr): loss and aux terms 1e-5 relative, gradients 2e-6
absolute plus 1e-4 relative of the tensor's largest in the first step (the
tolerances of ``test_torch_train_step.py``), 1e-3 in later ones, which start from
parameters that already differ by rounding (at lr 0.1 the CLS gradient of the
second step moves 2.8e-4 of its largest from a 1e-6 parameter difference; from
the same parameters it agrees within 1e-4), parameters 1e-5 absolute per step taken (lr times
the gradients' relative tolerance at their size, ~1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_clip_tpu import convert as jconvert
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.loss import CoCaLoss as JaxCoCaLoss
from open_clip_tpu.loss import caption_cross_entropy as jax_caption_ce
from open_clip_tpu.loss import clip_loss as jax_clip_loss
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import coca as jcoca
from open_clip_tpu.models import text as jtext
from open_clip_tpu.ops.fused_ce import fused_linear_cross_entropy as jax_fused_ce
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import train_loop as jloop
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import loss as ploss
from open_clip_tpu_torch.convert import params_from_jax, reference_state_dict, torch_clip_to_params
from open_clip_tpu_torch.models import coca as pcoca
from open_clip_tpu_torch.models import text as ptext
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import train_loop as ploop
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

VOCAB, SOT, EOS = 100, 98, 99
BATCH, CTX = 4, 12
GEN = dict(seq_len=10, min_seq_len=3, sot_token_id=SOT, eos_token_id=EOS)
LR = 0.1


def micro(pool, vision_width=64):
    return {
        "embed_dim": 64,
        "vision_cfg": {"image_size": 32, "patch_size": 8, "layers": 2, "width": vision_width,
                       "head_width": 32, "attentional_pool": pool, "attn_pooler_queries": 8,
                       "attn_pooler_heads": 4},
        "text_cfg": {"context_length": CTX, "vocab_size": VOCAB, "width": 64, "heads": 2,
                     "layers": 2, "embed_cls": True},
        "multimodal_cfg": {"context_length": CTX, "vocab_size": VOCAB, "width": 64, "heads": 2,
                           "layers": 2},
    }


VARIANTS = {"coca": micro(True), "kdim": micro(True, 96), "parallel": micro("parallel"),
            "cascade": micro("cascade")}
_SETUPS = {}


def setup_of(variant):
    if variant not in _SETUPS:
        raw = VARIANTS[variant]
        jcfg = JaxCfg.from_dict(raw)
        params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
        cfg = oc.CLIPModelCfg.from_dict(raw)
        rng = np.random.default_rng(0)
        images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
        texts = rng.integers(1, SOT, (BATCH, CTX)).astype(np.int32)
        texts[:, 0] = SOT
        for i, end in enumerate((5, 8, 11, 3)):  # rows of different lengths, then pad 0
            texts[i, end] = EOS
            texts[i, end + 1:] = 0
        _SETUPS[variant] = (jcfg, params, cfg, images, texts)
    return _SETUPS[variant]


def port_model(params, cfg):
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def jtree(params):
    return jax.tree.map(jnp.asarray, params)


def close(a, b, atol, rtol=0.0):
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, dtype=np.float64)
            for x in (a, b))
    assert a.shape == b.shape
    diff = np.abs(a - b).max() if a.size else 0.0
    assert diff <= atol + rtol * np.abs(b).max(), diff


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    """Image and text features, the pooled CLS and the tokens of both towers, and the
    decoder's logits against ``coca_forward`` and the JAX towers."""
    jcfg, params, cfg, images, texts = setup_of(variant)

    @jax.jit
    def jax_forward(p, img, txt):
        return (jcoca.coca_forward(p, jcfg, img, txt),
                jtext.apply_text_tower(p["text"], jcfg.text_cfg, txt))

    want, (j_pooled, j_tokens) = jax_forward(jtree(params), jnp.asarray(images),
                                             jnp.asarray(texts))
    model = port_model(params, cfg)
    with torch.no_grad():
        got = pcoca.coca_forward(model, torch.from_numpy(images), torch.from_numpy(texts))
        pooled, tokens = ptext.apply_text_tower(model, cfg.text_cfg,
                                                torch.from_numpy(texts).long(),
                                                return_tokens=True)
        hidden = pcoca.coca_forward(model, torch.from_numpy(images), torch.from_numpy(texts),
                                    return_hidden=True)["hidden"]
    for key in ("image_features", "text_features", "logits"):
        close(got[key], want[key], 1e-5)
    close(pooled, j_pooled, 1e-5)
    close(tokens, j_tokens, 1e-5)
    assert torch.equal(got["labels"], torch.from_numpy(texts).long())
    close(pcoca.linear(hidden, model.text_decoder.text_projection), want["logits"], 1e-5)
    assert model.encode_image(images).shape == (BATCH, 64)


def test_pad_mask_shifts_with_the_cls_first():
    """The key bias masks a pad token's key one position to its right (the CLS
    validity first, as in the JAX package)."""
    cfg = oc.CLIPModelCfg.from_dict(VARIANTS["coca"]).text_cfg
    text = torch.tensor([[SOT, 5, EOS, 0, 0]])
    bias = ptext.cls_key_bias(cfg, text)[0, 0, 0]
    assert bias.shape == (6,)
    assert (bias[:4] == 0).all() and (bias[4:] == ptext.NEG_INF).all()


# ---------------------------------------------------------------------------
# captioning
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gen_setup():
    """The CoCa form with the end token's column of the vocabulary projection made
    1.02x that of the token greedy decoding picks most, so that captions end at
    different steps and the rest is pad."""
    jcfg, params, cfg, images, _ = setup_of("coca")
    params = jax.tree.map(np.copy, params)
    model = port_model(params, cfg)
    ids = pcoca.generate(model, torch.from_numpy(images), **GEN).numpy()[:, 1:]
    common = np.bincount(ids.ravel(), minlength=VOCAB).argmax()
    proj = params["text_decoder"]["text_projection"]
    proj[:, EOS] = 1.02 * proj[:, common]
    return jcfg, params, cfg, images, port_model(params, cfg)


@pytest.mark.parametrize("kind", ["greedy", "top_k1", "beam", "beam_length_penalty"])
@pytest.mark.parametrize("kv_cache", [True, False], ids=["cached", "uncached"])
def test_captions_match_jax(gen_setup, kind, kv_cache):
    jcfg, params, cfg, images, model = gen_setup
    jp, img = jtree(params), jnp.asarray(images)
    if kind.startswith("beam"):
        kw = dict(GEN, num_beams=3, length_penalty=0.8 if kind.endswith("penalty") else 1.0,
                  kv_cache=kv_cache)
        want = jcoca.generate_beam(jp, jcfg, img, **kw)
        got = model.generate(torch.from_numpy(images), **kw)
    else:
        kw = dict(GEN, kv_cache=kv_cache)
        if kind == "top_k1":
            kw.update(generation_type="top_k", top_k=1)
        want = jcoca.generate(jp, jcfg, img, jax.random.PRNGKey(0), **kw)
        got = model.generate(torch.from_numpy(images), seed=0,
                             **{"generation_type": "greedy", **kw})
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] == SOT).all()
    # eos then pad: some captions end inside the buffer, and nothing follows the end
    ended = (want == EOS).any(axis=1)
    assert ended.any()
    for row in want[ended]:
        end = int(np.argmax(row == EOS))
        assert end >= GEN["min_seq_len"] and (row[end + 1:] == 0).all()


def test_generate_default_is_beam_search(gen_setup):
    _, _, _, images, model = gen_setup
    got = model.generate(torch.from_numpy(images), **GEN)
    np.testing.assert_array_equal(got, pcoca.generate_beam(model, torch.from_numpy(images), **GEN))
    with pytest.raises(ValueError, match="CoCa"):
        CLIPModel(oc.CLIPModelCfg.from_dict({k: v for k, v in VARIANTS["coca"].items()
                                             if k != "multimodal_cfg"})).generate(images)


@pytest.mark.parametrize("kw", [
    dict(generation_type="top_k", top_k=3, temperature=0.7),
    dict(generation_type="top_p", top_p=0.5),
    dict(generation_type="top_p", top_p=0.9, temperature=1.5, repetition_penalty=1.3),
    dict(generation_type="top_k", top_k=5, repetition_penalty=0.8),
], ids=["top_k", "top_p", "top_p_repetition", "top_k_repetition"])
def test_sampling_filters_match_jax(gen_setup, monkeypatch, kw):
    """The logits each step hands to the sampler (temperature, top-k or top-p, the
    repetition penalty, the end token blocked before ``min_seq_len``), recorded on
    both sides with the draw replaced by the argmax, so both decode the same tokens."""
    jcfg, params, cfg, images, model = gen_setup
    seen_j, seen_p = [], []

    def fake_categorical(key, logits, axis=-1):
        jax.debug.callback(lambda l: seen_j.append(np.asarray(l)), logits, ordered=True)
        return jnp.argmax(logits, axis=axis)

    def fake_sample(logits, generator):
        seen_p.append(logits.numpy().copy())
        return logits.argmax(dim=-1)

    monkeypatch.setattr(jax.random, "categorical", fake_categorical)
    monkeypatch.setattr(pcoca, "sample", fake_sample)
    want = jcoca.generate(jtree(params), jcfg, jnp.asarray(images), jax.random.PRNGKey(0),
                          **GEN, **kw)
    got = pcoca.generate(model, torch.from_numpy(images), **GEN, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(seen_j) == len(seen_p) == GEN["seq_len"] - 1
    for a, b in zip(seen_p, seen_j):
        neg = np.finfo(np.float32).min
        np.testing.assert_array_equal(a == neg, b == neg)
        keep = b != neg
        close(a[keep], b[keep], 1e-5)


# ---------------------------------------------------------------------------
# the fused cross-entropy and the losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,chunk,smoothing,bias", [(300, 128, 0.0, False), (300, 4096, 0.1, True),
                                                    (64, 128, 0.0, True)])
def test_fused_cross_entropy_matches_jax(n, chunk, smoothing, bias):
    """Value and gradients (hidden, weight, bias) against the JAX function, with
    ignored rows and an n that is not a multiple of the chunk; without smoothing
    also against ``caption_cross_entropy`` on the whole logits."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((n, 32)).astype(np.float32)
    w = (rng.standard_normal((VOCAB, 32)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(VOCAB) * 0.1).astype(np.float32) if bias else None
    labels = rng.integers(0, VOCAB, n).astype(np.int32)
    labels[rng.random(n) < 0.2] = -100

    def jloss(h_, w_, b_):
        return jax_fused_ce(h_, w_, jnp.asarray(labels), b_, chunk_size=chunk,
                            label_smoothing=smoothing)

    args = (jnp.asarray(h), jnp.asarray(w), None if b is None else jnp.asarray(b))
    want, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1) + ((2,) if bias else ())))(
        *args)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    got = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels).long(), tb,
                                     chunk_size=chunk, label_smoothing=smoothing)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    for t, g in zip((th, tw, tb), jgrads):
        close(t.grad, g, 1e-6)
    if smoothing == 0.0:
        logits = th.detach() @ tw.detach().T + (0 if tb is None else tb.detach())
        keep = torch.from_numpy(labels).long()
        want_ce = ploss.caption_cross_entropy(logits, torch.where(keep < 0, 0, keep), pad_id=0)
        # pad id 0 leaves out the label-0 rows too; compare on rows without label 0
        if not (labels == 0).any():
            assert got.item() == pytest.approx(want_ce.item(), rel=1e-6)
        jl = np.where(labels < 0, 0, labels)
        assert ploss.caption_cross_entropy(logits, torch.from_numpy(jl).long()).item() == \
            pytest.approx(float(jax_caption_ce(jnp.asarray(logits.numpy()), jnp.asarray(jl))),
                          rel=1e-6)


def test_coca_loss_class_matches_jax():
    rng = np.random.default_rng(2)
    imf, txf = (rng.standard_normal((BATCH, 16)).astype(np.float32) for _ in range(2))
    logits = rng.standard_normal((BATCH, CTX, VOCAB)).astype(np.float32)
    labels = rng.integers(0, VOCAB, (BATCH, CTX)).astype(np.int32)
    for kw in ({}, {"caption_loss_weight": 1.0, "clip_loss_weight": 0.0}):
        want = JaxCoCaLoss(**kw)(*(jnp.asarray(x) for x in (imf, txf, logits, labels)),
                                 jnp.float32(10.0), output_dict=True)
        got = ploss.CoCaLoss(**kw)(*(torch.from_numpy(x) for x in (imf, txf, logits, labels)),
                                   torch.tensor(10.0), output_dict=True)
        for key in want:
            assert got[key].item() == pytest.approx(float(want[key]), rel=1e-6, abs=1e-7)


def test_create_loss_matches_jax():
    from open_clip_tpu.loss import create_loss as jax_create_loss

    for args in ({"model": "coca_ViT-B-32"}, {"model": "ViT-B-32"},
                 {"model": "ViT-B-16-SigLIP", "siglip": True},
                 {"model": "coca_ViT-B-32", "distill": True},
                 {"model": "coca_ViT-L-14", "coca_caption_loss_weight": 1.5}):
        want, got = jax_create_loss(args), ploss.create_loss(args)
        assert type(got).__name__ == type(want).__name__
        for attr in ("caption_loss_weight", "clip_loss_weight", "local_loss"):
            assert getattr(got, attr, None) == getattr(want, attr, None)


# ---------------------------------------------------------------------------
# train steps and evaluation
# ---------------------------------------------------------------------------

_JAX_STEPS = {}


def jax_step(jcfg, accum):
    if accum not in _JAX_STEPS:
        opt = optax.chain(optax.trace(decay=0.0, nesterov=True), optax.scale(-LR))
        _JAX_STEPS[accum] = (jax.jit(jts.make_train_step(
            jcfg, opt, loss_type="coca", compute_dtype=jnp.float32, accum_steps=accum)), opt)
    return _JAX_STEPS[accum]


_JAX_TERMS = {}


def jax_terms(jp, jcfg, images, texts):
    """The JAX step's two terms (contrastive, caption) at ``jp``."""

    def terms(p, img, txt):
        out = jclip.clip_forward(p, jcfg, img, txt, train=True, compute_dtype=jnp.float32,
                                 return_hidden=True)
        closs = jax_clip_loss(out["image_features"], out["text_features"],
                              jnp.exp(p["logit_scale"]))
        tgt = txt[:, 1:]
        hid = out["hidden"][:, :-1]
        cap = jax_fused_ce(hid.reshape(-1, hid.shape[-1]),
                           p["text_decoder"]["text_projection"].T,
                           jnp.where(tgt == 0, -100, tgt).reshape(-1))
        return closs, cap

    fn = _JAX_TERMS.setdefault(id(jcfg), jax.jit(terms))
    return tuple(float(x) for x in fn(jp, jnp.asarray(images), jnp.asarray(texts)))


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("accum", [1, 2], ids=["simple", "gradcache"])
def test_coca_steps_match_jax(accum, n_steps):
    """``make_train_step(loss_type="coca")``, plain and GradCache (2 microbatches),
    against the JAX step with plain gradient descent: each step's loss, contrastive
    and caption terms, every gradient and every parameter after it."""
    jcfg, params, cfg, images, texts = setup_of("coca")
    jfn, jopt = jax_step(jcfg, accum)
    jstate = jts.create_train_state(jtree(params), jopt)
    model = port_model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(opt="sgd", momentum=0.0, lr=LR, wd=0.0),
                                  model, lambda step: LR)
    state = pts.create_train_state(model, opt)
    step = pts.make_train_step(cfg, opt, loss_type="coca", accum_steps=accum)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    for i in range(n_steps):
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        halves = [slice(0, BATCH)] if accum == 1 else [slice(0, BATCH // 2),
                                                       slice(BATCH // 2, BATCH)]
        terms = [jax_terms(jstate.params, jcfg, images[s], texts[s]) for s in halves]
        want_closs = jax_terms(jstate.params, jcfg, images, texts)[0]
        want_cap = float(np.mean([t[1] for t in terms]))
        jstate, jm = jfn(jstate, {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                         jax.random.PRNGKey(0))
        state, m = step(state, batch)
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert m["loss"].item() == pytest.approx(want_closs + 2.0 * want_cap, rel=1e-5)
        assert m["contrastive_loss"].item() == pytest.approx(want_closs, rel=1e-5)
        assert m["caption_loss"].item() == pytest.approx(want_cap, rel=1e-5)
        assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
        for k, p in model.named_parameters():
            close((before[k] - p.detach()) / LR, (before[k] - want[k]) / LR, 2e-6,
                  1e-4 if i == 0 else 1e-3)  # the gradient
            close(p.detach(), want[k], 1e-5 * (i + 1))


def test_coca_step_with_remat_and_weights():
    """Remat of the towers and of each decoder pair changes nothing; the two
    weights scale the two terms."""
    _, params, cfg, images, texts = setup_of("parallel")
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    out = {}
    for name, kw in (("plain", {}), ("remat", {"remat": True}),
                     ("weights", {"caption_loss_weight": 1.0, "clip_loss_weight": 0.5})):
        model = port_model(params, cfg)
        opt = poptim.create_optimizer(poptim.OptimizerCfg(opt="sgd", momentum=0.0, lr=LR,
                                                          wd=0.0), model, lambda s: LR)
        state, m = pts.make_train_step(cfg, opt, loss_type="coca", **kw)(
            pts.create_train_state(model, opt), batch)
        out[name] = (m, dict(model.named_parameters()))
    m0, p0 = out["plain"]
    m1, p1 = out["remat"]
    assert m1["loss"].item() == pytest.approx(m0["loss"].item(), rel=1e-6)
    for k in p0:
        close(p1[k].detach(), p0[k].detach(), 1e-6)
    mw = out["weights"][0]
    assert mw["loss"].item() == pytest.approx(
        0.5 * mw["contrastive_loss"].item() + mw["caption_loss"].item(), rel=1e-6)


def test_eval_gen_loss_matches_jax():
    """``make_eval_step``'s ``gen_loss`` (the chunked cross-entropy of the hidden
    states) against the JAX eval step's (``caption_cross_entropy`` of the logits),
    and the contrastive val loss beside it."""
    jcfg, params, cfg, images, texts = setup_of("cascade")
    want = jloop.make_eval_step(jcfg, compute_dtype=jnp.float32)(
        jtree(params), {"image": jnp.asarray(images), "text": jnp.asarray(texts)})
    got = ploop.make_eval_step()(port_model(params, cfg),
                                 {"image": torch.from_numpy(images),
                                  "text": torch.from_numpy(texts)})
    assert got["gen_loss"].item() == pytest.approx(float(want["gen_loss"]), rel=1e-5)
    assert got["loss"].item() == pytest.approx(float(want["loss"]), rel=1e-5)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["coca", "kdim", "parallel"])
def test_reference_layout_round_trip(variant, tmp_path):
    """``reference_state_dict`` writes the reference layout (the poolers as
    ``nn.MultiheadAttention``'s, ``text.cls_emb``, ``text_decoder.*``); both
    packages' converters read it back into the JAX tree leaf for leaf, and
    ``create_model`` loads it from a ``.pt`` into the same weights."""
    jcfg, params, cfg, _, _ = setup_of(variant)
    model = port_model(params, cfg)
    sd = reference_state_dict(model)
    assert "text.cls_emb" in sd and "text_decoder.cross_attn.1.ln_1_kv.weight" in sd
    fused = variant != "kdim"
    assert ("visual.attn_pool.attn.in_proj_weight" in sd) == fused
    assert ("visual.attn_pool.attn.k_proj_weight" in sd) == (not fused)
    got = torch_clip_to_params(sd, cfg)
    want = jconvert.torch_clip_to_params({k: v.numpy() for k, v in sd.items()}, jcfg)
    flat_got, flat_want = jconvert._flatten(got), jconvert._flatten(want)
    flat_src = jconvert._flatten(params)
    assert set(flat_got) == set(flat_want) == set(flat_src)
    for k in flat_src:
        np.testing.assert_array_equal(np.asarray(flat_got[k]), np.asarray(flat_want[k]))
        np.testing.assert_array_equal(np.asarray(flat_got[k]), np.asarray(flat_src[k]))
    name = f"micro-coca-{variant}"
    oc.add_model_config(dict(VARIANTS[variant]), name=name)
    path = tmp_path / "coca.pt"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    loaded = oc.create_model(name, str(path), device="cpu", seed=1)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_configs_build_and_count_like_jax():
    """The three CoCa configs build on the meta device with the JAX tree's
    parameter count; the RoBERTa one still raises for its HF text tower."""
    from open_clip_tpu_torch.config import parse_model_cfg

    for name in ("coca_ViT-B-32", "coca_ViT-L-14", "coca_base"):
        with torch.device("meta"):
            model = CLIPModel(parse_model_cfg(name))
        jcfg = JaxCfg.from_dict(oc.get_model_config(name))
        shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0), jcfg))
        assert sum(p.numel() for p in model.parameters()) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)), name
    with pytest.raises(NotImplementedError, match="HF text tower"), torch.device("meta"):
        CLIPModel(parse_model_cfg("coca_roberta-ViT-B-32"))


def test_optimizer_masks_match_jax():
    """Weight decay, layer decay (0.8) and tower locks on a CoCa model, tensor by
    tensor through ``params_from_jax``: ``text_decoder`` is a tower of its own
    (never locked, its own ladder, ``cross_blocks`` off the ladder),
    ``attn_pool*`` is a head, ``cls_emb`` and the pooler's ``query`` take no decay."""
    jcfg, params, cfg, _, _ = setup_of("parallel")
    model = port_model(params, cfg)

    def as_port(tree):
        return params_from_jax(jax.tree.map(lambda x: np.broadcast_to(
            np.asarray(x, dtype=np.float32), np.shape(x) or ()), tree), cfg)

    def broadcast(got, shape):
        return torch.as_tensor(got, dtype=torch.float32).expand(shape) if not isinstance(
            got, bool) else torch.full(shape, float(got))

    want = as_port(jax.tree.map(lambda m, p: np.broadcast_to(np.float32(m), np.shape(p)),
                                joptim.wd_mask(params), params))
    got = poptim.wd_mask(model)
    for k, p in model.named_parameters():
        assert torch.equal(broadcast(got[k], p.shape), want[k]), k
    scales = joptim.layer_decay_scales(params, 0.8)
    want = as_port(jax.tree.map(lambda s, p: np.broadcast_to(np.asarray(s), np.shape(p)),
                                scales, params))
    got = poptim.layer_decay_scales(model, 0.8)
    for k, p in model.named_parameters():
        close(broadcast(got[k], p.shape), want[k], 1e-7)
    kw = dict(lock_image=True, lock_image_unlocked_groups=1, lock_text=True)
    want = as_port(jax.tree.map(lambda s, p: np.broadcast_to(np.asarray(s, np.float32),
                                                             np.shape(p)),
                                joptim.trainable_mask(params, **kw), params))
    got = poptim.trainable_mask(model, **kw)
    for k, p in model.named_parameters():
        assert torch.equal(broadcast(got[k], p.shape), want[k]), k
    assert all(got[k] == 1.0 for k in got if k.startswith(("text_decoder.", "visual.attn_pool")))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_NAME = "micro-coca-cli"


def test_cli_trains_evaluates_and_resumes(tmp_path):
    """``--model`` a CoCa on synthetic data: the caption term trains, evaluation
    reports ``val_generative_loss``, the checkpoint resumes; under ``--mesh-fsdp 2``
    the step refuses."""
    from open_clip_tpu_torch.train.main import main

    raw = micro(True)
    for section in ("text_cfg", "multimodal_cfg"):
        raw[section] = dict(raw[section], vocab_size=49408)
    oc.add_model_config(raw, name=CLI_NAME)
    args = ["--model", CLI_NAME, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "8", "--lr", "1e-3", "--precision", "fp32", "--logs", str(tmp_path),
            "--name", "coca", "--device", "cpu", "--val-data", "synthetic",
            "--coca-caption-loss-weight", "1.0", "--coca-contrastive-loss-weight", "0.5"]
    state = main(args + ["--epochs", "1"])
    assert state.step == 2
    lines = (tmp_path / "coca" / "results.jsonl").read_text().splitlines()
    assert any("val/val_generative_loss" in line for line in lines)
    state = main(args + ["--epochs", "2", "--resume", "latest"])
    assert state.step == 4
    with pytest.raises(NotImplementedError, match="under a mesh"):
        main(args[:-4] + ["--name", "mesh", "--epochs", "1", "--mesh-fsdp", "2"])
