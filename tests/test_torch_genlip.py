"""The port's GenLIP against the JAX package's, on the CPU at a micro size.

``naflexgenlip_test`` (width 64, 4 heads of 16, depth 2, text embedding 32, so
``in_proj``/``out_proj`` exist, embed_dim 64) with its vocabulary cut to 512 ids
(pad 510, start 511, end 509) and drop path 0 gets its params from the JAX
package's ``init_genlip``; ``params_from_jax`` carries them into the port. Images are
patch dicts of 12 patches on a 3 x 4 grid, one row ragged (9 valid); captions are 7
ids, ragged with pad. Each JAX function is jitted once per module and reused.

Tolerances (fp32): features, logits, scores and losses 2e-5 relative to their
largest (sums over 2 layers in other orders). Captions token for token (greedy
margins at these weights are far above the rounding). Train steps (plain gradient
descent, lr 0.1, so each step's gradient is (p - p') / lr): loss 1e-5 relative,
gradients 2e-6 absolute plus 1e-4 relative of the tensor's largest in the first
step, 1e-3 in later ones (which start from parameters that differ by rounding),
parameters 1e-5 absolute per step taken: the tolerances of ``test_torch_coca.py``.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import open_clip_tpu as jpkg
from open_clip_tpu.loss import GenLipLoss as JaxGenLipLoss
from open_clip_tpu.models import genlip as JG
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import factory, loss as ploss
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.models import genlip as PG
from open_clip_tpu_torch.ops import flash_attention as pfa
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import train_loop as ploop
from open_clip_tpu_torch.train import train_step as pts

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

VOCAB, PAD, BOS, EOS = 512, 510, 511, 509
B, NI, LT = 3, 12, 7
LR = 0.1
SEQ = 9


def micro_raw(**trunk):
    raw = jpkg.get_model_config("naflexgenlip_test")
    raw["text_cfg"].update(vocab_size=VOCAB, pad_id=PAD, bos_id=BOS, eos_id=EOS)
    raw["genlip_cfg"].update({"drop_path_rate": 0.0, **trunk})
    return raw


RAW = micro_raw()


@pytest.fixture(scope="module")
def setup():
    jcfg = JG.GenLipModelCfg.from_dict(RAW)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: JG.init_genlip(k, jcfg))(
        jax.random.PRNGKey(0)))
    cfg = PG.GenLipModelCfg.from_dict(RAW)
    rng = np.random.default_rng(0)
    coord = np.stack([np.arange(NI) // 4, np.arange(NI) % 4], -1).astype(np.int32)
    image = {"patches": (rng.standard_normal((B, NI, 768)) * 0.5).astype(np.float32),
             "patch_coord": np.broadcast_to(coord, (B, NI, 2)).copy(),
             "patch_valid": np.arange(NI)[None] < np.array([NI, 9, NI])[:, None]}
    text = rng.integers(0, 500, (B, LT)).astype(np.int32)
    text[:, 0] = BOS
    text[1, 4:] = PAD
    text[2, 6] = EOS
    return jcfg, params, cfg, image, text


def port_model(params, cfg, cls=PG.GenLipModel):
    model = cls(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def jtree(x):
    return jax.tree.map(jnp.asarray, x)


def ttree(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def close(a, b, rtol=2e-5, atol=0.0):
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, dtype=np.float64)
            for x in (a, b))
    assert a.shape == b.shape
    diff = np.abs(a - b).max() if a.size else 0.0
    assert diff <= atol + rtol * max(np.abs(b).max(), 1e-30), diff


_JIT = {}


def jit(name, fn):
    """One ``jax.jit`` per name for the module; the configs are static closures."""
    return _JIT.setdefault(name, jax.jit(fn))


# ---------------------------------------------------------------------------
# config, positions and masks
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    for name in ("naflexgenlip_b16", "naflexgenlip_so150m2", "naflexgenlip_test"):
        raw = jpkg.get_model_config(name)
        assert (dataclasses.asdict(PG.GenLipModelCfg.from_dict(raw))
                == dataclasses.asdict(JG.GenLipModelCfg.from_dict(raw))), name


def test_positions_and_masks_match_jax(setup):
    _, _, _, image, text = setup
    pv, coord = image["patch_valid"], image["patch_coord"]
    tv = text != PAD
    t = torch.from_numpy
    assert np.array_equal(PG.build_image_position_ids(t(coord)).numpy(),
                          np.asarray(JG.build_image_position_ids(jnp.asarray(coord))))
    assert np.array_equal(PG.build_mrope_position_ids(t(coord), t(pv), t(tv)).numpy(),
                          np.asarray(JG.build_mrope_position_ids(jnp.asarray(coord), pv, tv)))
    cols = np.arange(NI + LT)[None]
    k, m = pv.sum(1)[:, None], tv.sum(1)[:, None]
    pre, txt = cols < k, (cols >= k) & (cols < k + m)
    for got, want in ((PG.build_text_over_prefix_bias(t(pv), t(tv)),
                       JG.build_text_over_prefix_bias(pv, tv)),
                      (PG.build_prefix_lm_bias(t(pv), t(tv)), JG.build_prefix_lm_bias(pv, tv)),
                      (PG.build_packed_prefix_lm_bias(t(pre), t(txt)),
                       JG.build_packed_prefix_lm_bias(pre, txt))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    emb = np.random.default_rng(1).standard_normal((B, NI, 8)).astype(np.float32)
    temb = np.random.default_rng(2).standard_normal((B, LT, 8)).astype(np.float32)
    pos = JG.build_mrope_position_ids(jnp.asarray(coord), pv, tv)
    want = JG.pack_prefix_sequence(jnp.asarray(emb), jnp.asarray(pv), pos, jnp.asarray(temb),
                                   jnp.asarray(tv))
    got = PG.pack_prefix_sequence(t(emb), t(pv), torch.from_numpy(np.asarray(pos)), t(temb), t(tv))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_trunk_mask_takes_the_flash_kernels_at_the_b16_train_shape(monkeypatch):
    """At naflexgenlip_b16's train shape (1024 image + 128 text tokens, 12 heads of
    64) the card takes the structured prefix-LM mask; under 512 tokens, on the CPU
    and at head width 16 the dense bias."""
    assert PG.flash_ok(True, 1152, 12, 64)
    assert not PG.flash_ok(True, 288, 12, 64) and not PG.flash_ok(False, 1152, 12, 64)
    assert not PG.flash_ok(True, 1152, 48, 16)
    kv = torch.ones(2, 1152, dtype=torch.bool)
    assert PG.trunk_mask(1024, kv, 1152, 64, 12).shape == (2, 1, 1152, 1152)
    monkeypatch.setattr(PG, "flash_ok", lambda *a: True)
    kind, prefix_len, valid = PG.trunk_mask(1024, kv, 1152, 64, 12)
    assert (kind, prefix_len) == ("prefix", 1024) and valid is kv


def test_structured_mask_equals_the_dense_bias(setup):
    """The flash kernels' plain version under the structured prefix-LM mask against
    the dense bias, through the trunk: equal on valid rows (padded query rows differ
    by design), and no launch on the CPU."""
    _, params, cfg, image, text = setup
    model = port_model(params, cfg)
    pv = torch.from_numpy(image["patch_valid"])
    valid = torch.cat([pv, torch.from_numpy(text != PAD)], 1)
    with torch.no_grad():
        x = torch.cat([model.embed_prefix(torch.from_numpy(image["patches"]), torch.float32),
                       model.embed_text(torch.from_numpy(text), torch.float32)], 1)
        pos = PG.build_mrope_position_ids(torch.from_numpy(image["patch_coord"]), pv,
                                          valid[:, NI:])
        cos, sin = PG._cos_sin(cfg.trunk_cfg, pos)
        before = dict(pfa.LAUNCHES)
        flash = model.trunk(x, ("prefix", NI, valid), cos, sin)
        assert pfa.LAUNCHES == before
        dense = model.trunk(x, PG.build_prefix_lm_bias(pv, valid[:, NI:]), cos, sin)
    close(flash[valid], dense[valid], 1e-5)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def test_encode_image_matches_jax(setup):
    jcfg, params, cfg, image, _ = setup
    model = port_model(params, cfg)
    want = jit("enc", lambda p, im: JG.encode_image(p, jcfg, im, normalize=True))(
        jtree(params), jtree(image))
    with torch.no_grad():
        got = model.encode_image(image, normalize=True)
        feats = model.patch_features(image)
    close(got, want)
    assert feats.shape == (B, NI, 64)


def _jax_forward(jcfg, params, image, text, **kw):
    name = f"fwd{id(jcfg)}{sorted(kw)}"
    return jit(name, lambda p, im, t: JG.genlip_forward(p, jcfg, im, t, **kw))(
        jtree(params), jtree(image), jnp.asarray(text))


def test_logits_and_losses_match_jax(setup):
    """Logits (every row: both packages take the dense bias here), the fused
    caption loss, ``GenLipLoss`` on the shifted logits, and the packed loss of the
    same weights under ``pack_prefix`` (the layout of so150m2 and every GenLAP)."""
    jcfg, params, cfg, image, text = setup
    model = port_model(params, cfg)
    with torch.no_grad():
        out = model(image, text)
        loss = model(image, text, compute_loss=True)["loss"]
    want = _jax_forward(jcfg, params, image, text)
    assert out["image_seq_len"] == NI
    close(out["logits"], want["logits"])
    want_loss = float(_jax_forward(jcfg, params, image, text, compute_loss=True)["loss"])
    assert loss.item() == pytest.approx(want_loss, rel=2e-5)
    shifted = out["logits"][:, NI - 1:-1]
    labels = torch.where(torch.from_numpy(text != PAD), torch.from_numpy(text).long(), -100)
    got = ploss.GenLipLoss()(shifted, labels, output_dict=True)["caption_loss"]
    assert got.item() == pytest.approx(float(JaxGenLipLoss()(np.asarray(shifted), labels.numpy())),
                                       rel=1e-6)
    assert got.item() == pytest.approx(loss.item(), rel=2e-5)
    packed = RAW | {"genlip_cfg": {**RAW["genlip_cfg"], "pack_prefix": True}}
    jpcfg, pcfg = JG.GenLipModelCfg.from_dict(packed), PG.GenLipModelCfg.from_dict(packed)
    with torch.no_grad():
        got = port_model(params, pcfg)(image, text, compute_loss=True)["loss"]
    want = float(_jax_forward(jpcfg, params, image, text, compute_loss=True)["loss"])
    assert got.item() == pytest.approx(want, rel=2e-5)


def test_prefix_cache_and_scores_match_jax(setup):
    """The cache leaf for leaf, scores of B captions against one image (broadcast)
    and one image per caption, and the scores against the joint forward's."""
    jcfg, params, cfg, image, text = setup
    model = port_model(params, cfg)
    jp = jtree(params)
    jcache = jit("cache", lambda p, im: JG.prefix_cache(p, jcfg, im))(jp, jtree(image))
    cache = model.prefix_cache(image)
    for k in ("k", "v", "last_hidden"):
        close(cache[k], jcache[k])
    assert torch.equal(cache["text_start"], torch.from_numpy(np.asarray(jcache["text_start"])).long())
    score = jit("score", lambda p, c, t: JG.score_captions(p, jcfg, c, t))
    close(model.score_captions(cache, text), score(jp, jcache, jnp.asarray(text)))
    one = {k: v[:1] for k, v in image.items()}
    got = model.score_captions(model.prefix_cache(one), text)
    close(got, score(jp, jit("cache", lambda p, im: JG.prefix_cache(p, jcfg, im))(jp, jtree(one)),
                     jnp.asarray(text)))
    with torch.no_grad():
        logits = model({k: np.repeat(v, B, 0) for k, v in one.items()}, text)["logits"]
    lp = torch.log_softmax(logits[:, NI - 1:NI - 1 + LT].float(), -1)
    lp = torch.gather(lp, 2, torch.from_numpy(text).long()[..., None])[..., 0]
    tv = torch.from_numpy(text != PAD)
    close(got, (lp * tv).sum(1) / tv.sum(1), 1e-5)


@pytest.fixture(scope="module")
def gen_setup(setup):
    """The micro weights with the end token's ``lm_head`` row scaled up so that
    greedy captions end inside ``SEQ`` tokens."""
    jcfg, params, cfg, image, _ = setup
    params = jax.tree.map(np.copy, params)
    head = params["lm_head"]["kernel"]
    head[:, EOS] = head[:, EOS] * 6.0
    return jcfg, params, cfg, image


def _jax_captions(jcfg, params, image, **kw):
    name = f"gen{sorted(kw.items())}"
    return np.asarray(jit(name, lambda p, im: JG.generate(p, jcfg, im, seq_len=SEQ, **kw))(
        jtree(params), jtree(image)))


def test_greedy_captions_match_jax(gen_setup):
    """Greedy captions cached and uncached, token for token with each other and the
    JAX cached decode; they end early, and ``min_seq_len`` holds the end back."""
    jcfg, params, cfg, image = gen_setup
    model = port_model(params, cfg)
    want = _jax_captions(jcfg, params, image)
    cached = model.generate(image, seq_len=SEQ).numpy()
    uncached = model.generate(image, seq_len=SEQ, kv_cache=False).numpy()
    assert np.array_equal(cached, want) and np.array_equal(uncached, want)
    assert (want == EOS).any() and (want[:, 0] == BOS).all()
    late = model.generate(image, seq_len=SEQ, min_seq_len=SEQ).numpy()
    assert not (late == EOS).any()
    assert np.array_equal(late, _jax_captions(jcfg, params, image, min_seq_len=SEQ))


def test_top_k_of_one_is_greedy(gen_setup):
    _, params, cfg, image = gen_setup
    model = port_model(params, cfg)
    greedy = model.generate(image, seq_len=SEQ)
    for kv in (True, False):
        assert torch.equal(model.generate(image, seq_len=SEQ, generation_type="top_k", top_k=1,
                                          temperature=0.7, seed=3, kv_cache=kv), greedy)
    top_p = model.generate(image, seq_len=SEQ, generation_type="top_p", top_p=0.9, seed=3)
    assert top_p.shape == greedy.shape and (top_p[:, 0] == BOS).all()


# ---------------------------------------------------------------------------
# training and evaluation
# ---------------------------------------------------------------------------

_SGD = optax.chain(optax.trace(decay=0.0, nesterov=True), optax.scale(-LR))


def _batch(image, text):
    return {"image": ttree(image), "text": torch.from_numpy(text)}


@pytest.mark.parametrize("accum,n_steps", [(1, 1), (1, 3), (2, 1)],
                         ids=["one", "three", "accum2"])
def test_genlip_steps_match_jax(setup, accum, n_steps):
    """``make_train_step(loss_type="genlip")`` (and ``gen_accum_step`` over 2
    microbatches) against the JAX step with plain gradient descent: the loss, every
    gradient and every parameter after each step; the metrics' logit scale is 0."""
    jcfg, params, cfg, image, text = setup
    image, text = {k: np.concatenate([v, v[:1]]) for k, v in image.items()}, np.concatenate(
        [text, text[:1]])  # 4 rows: 2 microbatches of 2
    jfn = jit(f"step{accum}", jts.make_train_step(jcfg, _SGD, loss_type="genlip",
                                                  compute_dtype=jnp.float32, accum_steps=accum))
    jstate = jts.create_train_state(jtree(params), _SGD)
    model = port_model(params, cfg)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(opt="sgd", momentum=0.0, lr=LR, wd=0.0),
                                  model, lambda s: LR)
    state = pts.create_train_state(model, opt)
    step = pts.make_train_step(cfg, opt, loss_type="genlip", accum_steps=accum)
    for i in range(n_steps):
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        jstate, jm = jfn(jstate, {"image": jtree(image), "text": jnp.asarray(text)},
                         jax.random.PRNGKey(0))
        state, m = step(state, _batch(image, text))
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert m["logit_scale"].item() == 0.0 == float(jm["logit_scale"])
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
        for k, p in model.named_parameters():
            close((before[k] - p.detach()) / LR, (before[k] - want[k]) / LR,
                  1e-4 if i == 0 else 1e-3, 2e-6)
            close(p.detach(), want[k], 0.0, 1e-5 * (i + 1))
    assert state.step == n_steps


def test_step_options(setup):
    """Remat changes nothing; drop path draws from the step's generator (same seed,
    same update); a CLIP config or a mesh is refused."""
    _, params, cfg, image, text = setup
    dp = PG.GenLipModelCfg.from_dict(micro_raw(drop_path_rate=0.3))
    out = {}
    for name, c, kw in (("plain", cfg, {}), ("remat", cfg, {"remat": True}),
                        ("drop", dp, {}), ("drop2", dp, {"remat": True})):
        model = port_model(params, c)
        opt = poptim.create_optimizer(poptim.OptimizerCfg(opt="sgd", momentum=0.0, lr=LR,
                                                          wd=0.0), model, lambda s: LR)
        _, m = pts.make_train_step(c, opt, loss_type="genlip", **kw)(
            pts.create_train_state(model, opt), _batch(image, text))
        out[name] = (m["loss"].item(), dict(model.named_parameters()))
    assert out["remat"][0] == pytest.approx(out["plain"][0], rel=1e-6)
    assert out["drop"][0] != out["plain"][0]
    for k, p in out["plain"][1].items():
        close(out["remat"][1][k], p, 0.0, 1e-6)
        close(out["drop2"][1][k], out["drop"][1][k], 0.0, 1e-6)
    with pytest.raises(ValueError, match="does not train this config"):
        pts.make_train_step(oc.CLIPModelCfg(), opt, loss_type="genlip")
    with pytest.raises(NotImplementedError, match="under a mesh"):
        pts.make_train_step(cfg, opt, loss_type="genlip", mesh="a mesh")


class _Loader:
    def __init__(self, batches):
        self.dataloader = batches


def test_val_generative_loss_matches_jax(setup):
    """``evaluate`` over two val batches of 3 and 1: the size-weighted caption loss."""
    jcfg, params, cfg, image, text = setup
    model = port_model(params, cfg)
    parts = [slice(0, 3), slice(2, 3)]
    batches = [{"image": {k: v[s] for k, v in ttree(image).items()},
                "text": torch.from_numpy(text[s])} for s in parts]
    got = ploop.evaluate(model, {"val": _Loader(batches)}, 2, None)
    losses = [float(_jax_forward(jcfg, params, {k: v[s] for k, v in image.items()}, text[s],
                                 compute_loss=True)["loss"]) for s in parts]
    assert got["val_generative_loss"] == pytest.approx((3 * losses[0] + losses[1]) / 4, rel=2e-5)
    assert got["num_samples"] == 4 and got["epoch"] == 2


def test_optimizer_rules_match_jax(setup):
    """Weight decay, layer decay (0.7: the trunk's blocks on their own ladder,
    everything else 1) and tower locks (nothing is ``visual`` or ``text`` in the
    GenLIP tree) tensor by tensor; ``jax_leaves`` rebuilds the JAX tree's leaves."""
    _, params, cfg, _, _ = setup
    model = port_model(params, cfg)

    def as_port(tree):
        return params_from_jax(jax.tree.map(lambda m, p: np.broadcast_to(
            np.asarray(m, np.float32), np.shape(p)), tree, params), cfg)

    def full(v, shape):
        return torch.as_tensor(float(v) if isinstance(v, bool) else v,
                               dtype=torch.float32).expand(shape)

    for want, got in ((joptim.wd_mask(params), poptim.wd_mask(model)),
                      (joptim.layer_decay_scales(params, 0.7),
                       poptim.layer_decay_scales(model, 0.7)),
                      (joptim.trainable_mask(params, lock_image=True, lock_text=True),
                       poptim.trainable_mask(model, lock_image=True, lock_text=True))):
        want = as_port(want)
        for k, p in model.named_parameters():
            close(full(got[k], p.shape), want[k], 0.0, 1e-7)
    leaves = poptim.jax_leaves(model)
    shapes = sorted(tuple(leaf.shape(list(model.parameters()))) for leaf in leaves)
    assert shapes == sorted(tuple(x.shape) for x in jax.tree.leaves(params))


# ---------------------------------------------------------------------------
# weights, configs, the factory and the CLI
# ---------------------------------------------------------------------------

def _reference_sd(params):
    """The reference NaFlexGenLip state dict of a JAX tree (the visual adapter's
    duplicate trunk keys included, as the reference writes them)."""
    sd = {}
    tops = {v: k for k, v in PG._REF_TOP_KEYS.items()}
    blocks = {v: k for k, v in PG._REF_TRUNK_KEYS.items()}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif path[:2] == ("trunk", "blocks"):
                for i in range(v.shape[0]):
                    rest = blocks[path[2:] + (k,)]
                    sd[f"trunk.layers.{i}.{rest}"] = v[i].T if k == "kernel" else v[i]
                    sd[f"visual.trunk.layers.{i}.{rest}"] = sd[f"trunk.layers.{i}.{rest}"]
            else:
                sd[tops[path + (k,)]] = v.T if k == "kernel" else v

    walk(params, ())
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def test_reference_checkpoint_loads_like_jax(setup, tmp_path):
    """The converter's tree leaf for leaf against the JAX converter's, and
    ``create_model(pretrained=...)`` of a ``.safetensors`` file against the model
    loaded through ``params_from_jax``."""
    _, params, cfg, image, _ = setup
    sd = _reference_sd(params)
    got = PG.torch_genlip_to_params(sd)
    want = JG.torch_genlip_to_params({k: v.numpy() for k, v in sd.items()},
                                     JG.GenLipModelCfg.from_dict(RAW))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(g, np.asarray(w))
    from open_clip_tpu_torch import _safetensors

    path = str(tmp_path / "genlip.safetensors")
    _safetensors.save_file({k: v.contiguous() for k, v in sd.items()}, path)
    oc.add_model_config(RAW, name="micro-genlip")
    model = oc.create_model("micro-genlip", pretrained=path, device="cpu", seed=5)
    want_model = port_model(params, cfg)
    for k, v in want_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    bucket, _ = factory.generative_transforms(model)
    patches = bucket(12)(torch.zeros(2, 40, 48, 3, dtype=torch.uint8))
    with torch.no_grad():
        assert model.encode_image(patches).shape == (2, 64)


GENERATIVE = ["naflexgenlip_b16", "naflexgenlip_so150m2", "naflexgenlip_so16",
              "naflexgenlip_test", "naflexgenlap_betwixt", "naflexgenlap_so150m2",
              "naflexgenlap_test_1d", "naflexgenlap_test_2d"]


def test_the_eight_configs_build_with_the_jax_parameter_count():
    """Each GenLIP/GenLAP config on the meta device against ``jax.eval_shape`` of its
    init; with them 153 of the registry's 181 configs build."""
    from open_clip_tpu.models import genlap as JGA

    for name in GENERATIVE:
        raw = jpkg.get_model_config(name)
        with torch.device("meta"):
            model = factory.model_from_config(raw)
        if "genlap_cfg" in raw:
            jcfg, init = JGA.GenLapModelCfg.from_dict(raw), JGA.init_genlap
        else:
            jcfg, init = JG.GenLipModelCfg.from_dict(raw), JG.init_genlip
        want = jax.eval_shape(lambda key: init(key, jcfg), jax.random.PRNGKey(0))
        assert sum(p.numel() for p in model.parameters()) == sum(
            x.size for x in jax.tree.leaves(want)), name
    with open(Path(factory.__file__).parent / "model_configs_data.json") as fh:
        registry = json.load(fh)  # as shipped: tests register configs of their own
    built = 0
    for raw in registry.values():
        try:
            with torch.device("meta"):
                factory.model_from_config(raw)
            built += 1
        except NotImplementedError:
            pass
    assert (built, len(registry)) == (153, 181)


def test_precision_sets_the_compute_dtype_only():
    model = oc.create_model("naflexgenlip_test", precision="pure_bf16", device="cpu")
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert isinstance(model, oc.NaFlexGenLip)


def test_loss_type_loss_and_cli_stop_at_the_tokenizer(tmp_path):
    """A GenLIP config trains with the genlip step and ``GenLipLoss``; the CLI gets
    there, then stops at the tokenizer as the JAX CLI does, naming the vocabulary."""
    from open_clip_tpu_torch.train import main as pmain

    assert pts.loss_type_for(oc.CLIPModelCfg.from_dict(RAW)) == "genlip"
    assert isinstance(ploss.create_loss({"model": "naflexgenlip_test"}), ploss.GenLipLoss)
    with pytest.raises(NotImplementedError, match="cl100k_base.tiktoken"):
        oc.get_tokenizer("naflexgenlip_test")
    with pytest.raises(NotImplementedError, match="cl100k_base"):
        pmain.main(["--model", "naflexgenlip_test", "--dataset-type", "synthetic",
                    "--train-num-samples", "4", "--batch-size", "2", "--device", "cpu",
                    "--logs", str(tmp_path), "--name", "r"])
