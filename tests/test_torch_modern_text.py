"""The port's modern text tower against the JAX package, on the CPU.

Micro towers (width 64, 4 heads, 3 layers, vocabulary 128) of each variant of
``tests/test_parity_modern_text.py`` (gated attention with qk-norm; bidirectional
with registers and MAP pooling; sandwich LayerNorm with pre-norm and mean pooling;
value residual with ReLU², biases and LayerScale), plus a causal EOS tower with
registers and a bidirectional mean-pooled one, get their params from the JAX
package's ``init_clip``; ``params_from_jax`` carries them into the port. Token ids
from a numpy seed, with a padded row, an EOS in the middle of a row and a row
without EOS (the last-valid fallback). fp32; features to 1e-5 of their largest
entry, the gradients of a scalar of the features to 1e-5 of each tensor's largest
entry plus 1e-7. Also the reference-checkpoint converter leaf for leaf, the
pure-bf16 partition, the weight-decay mask and the registry's ``moderntext-*``
configs (built on the meta device, parameter counts against
``jax.eval_shape(init_clip)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu import convert as jconv
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.config import parse_model_cfg as jax_parse_model_cfg
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.train import optim as joptim

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import convert as pconv
from open_clip_tpu_torch.config import parse_model_cfg
from open_clip_tpu_torch.models import modern_text as pmt
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.ops.layers import relu_squared, rms_norm
from open_clip_tpu_torch.train import optim as poptim

BASE_TEXT = {
    "text_arch": "modern", "context_length": 16, "variable_text": True, "vocab_size": 128,
    "width": 64, "heads": 4, "layers": 3, "mlp_ratio": 2.0, "pad_id": 0, "eos_id": 2,
    "pool_type": "eos", "attention_mode": "causal", "pos_embed": "rope", "mlp_type": "swiglu",
    "norm_type": "rmsnorm", "norm_eps": 1e-6,
}
VARIANTS = {
    "mt-gated-qk": {"attn_gated": True, "qk_norm": True},
    "mt-bidir-map": {"attention_mode": "bidirectional", "pool_type": "map", "reg_tokens": 2},
    "mt-sandwich-ln": {"norm_type": "layernorm", "norm_placement": "sandwich", "mlp_type": "mlp",
                       "pool_type": "mean", "attention_mode": "bidirectional", "pre_norm": True},
    "mt-vres-relu2": {"value_residual": True, "mlp_type": "relu2", "attention_bias": True,
                      "proj_bias": True, "ls_init_value": 0.1},
    "mt-causal-eos-reg": {"reg_tokens": 3, "attn_gated": True, "gate_bias": True},
    "mt-mean": {"pool_type": "mean", "attention_mode": "bidirectional", "qk_norm": True},
}
VISION = {"image_size": 32, "layers": 1, "width": 32, "patch_size": 16, "head_width": 16}


def _cfg(variant):
    return {"embed_dim": 48, "vision_cfg": VISION, "text_cfg": {**BASE_TEXT, **VARIANTS[variant]}}


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    txt = rng.integers(3, 127, size=(3, 16)).astype(np.int32)
    txt[0, 10:] = 0  # a padded row, EOS before the padding
    txt[0, 9] = 2
    txt[1, 5] = 2  # EOS in the middle
    return txt  # row 2: no EOS, the last valid position


def _setup(variant):
    raw = _cfg(variant)
    jcfg = JaxCfg.from_dict(raw)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(1), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(raw)
    model = CLIPModel(cfg)
    model.load_state_dict(pconv.params_from_jax(params, cfg), strict=True)
    return jcfg, params, cfg, model


def _close(got, want, rel=1e-5, floor=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want).max()
    assert diff <= rel * np.abs(want).max() + floor, diff


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encode_text_matches_jax(variant):
    jcfg, params, cfg, model = _setup(variant)
    txt = _tokens()
    want = jax.jit(lambda p, t: jclip.encode_text(p, jcfg, t))(jax.tree.map(jnp.asarray, params), txt)
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(txt))
    _close(got, want)


@pytest.mark.parametrize("variant", ["mt-vres-relu2", "mt-bidir-map", "mt-sandwich-ln"])
def test_text_gradients_match_jax(variant):
    """d(sum(features * w))/d(params) of the text tower, full remat on in the port
    (the JAX tower's ``jax.checkpoint``), every text parameter."""
    jcfg, params, cfg, model = _setup(variant)
    txt = _tokens(1)
    w = np.random.default_rng(2).standard_normal((3, 48)).astype(np.float32)

    def loss(p):
        return (jclip.encode_text(p, jcfg, txt, remat=True) * w).sum()

    jgrads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params))
    want = pconv.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    (oc.encode_text(model, torch.from_numpy(txt), remat=True) * torch.from_numpy(w)).sum().backward()
    got = {k: p.grad for k, p in model.named_parameters() if k.startswith("text.")}
    assert got and all(g is not None for g in got.values())
    for key, g in got.items():
        _close(g, want[key], floor=1e-7)


def test_rms_norm_and_relu_squared_match_jax():
    from open_clip_tpu.ops import layers as jl

    x = np.random.default_rng(3).standard_normal((4, 96)).astype(np.float32) * 3
    scale = np.linspace(0.5, 1.5, 96).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = rms_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(scale), eps=1e-5)
        want = jl.rms_norm(jnp.asarray(x, jdtype), jnp.asarray(scale), eps=1e-5)
        assert got.dtype == dtype
        _close(got, np.asarray(want.astype(jnp.float32)), rel=1e-6 if dtype == torch.float32 else 8e-3)
    np.testing.assert_array_equal(relu_squared(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.relu_squared(jnp.asarray(x))))


def test_rope_table_matches_jax_bit_for_bit():
    from open_clip_tpu.models import modern_text as jmt

    np.testing.assert_array_equal(pmt.rope_table(19, 16, 10000.0), np.asarray(jmt.rope_table(19, 16)))
    x = np.random.default_rng(4).standard_normal((2, 19, 3, 16)).astype(np.float32)
    table = pmt.rope_table(19, 16)
    _close(pmt.apply_rope_1d(torch.from_numpy(x), torch.from_numpy(table)),
           jmt.apply_rope_1d(jnp.asarray(x), jnp.asarray(table)), rel=1e-6)


@pytest.mark.parametrize("variant", ["mt-vres-relu2", "mt-bidir-map"])
def test_reference_checkpoint_converts_as_in_jax(variant):
    """A reference ``text.blocks.{i}.*`` state dict (the port's names with the
    reference's block prefix): the port's numpy ``_convert_modern_text`` gives the
    JAX converter's tree leaf for leaf, and the checkpoint loads into the port."""
    jcfg, params, cfg, model = _setup(variant)
    sd = {k.replace("text.transformer.resblocks.", "text.blocks."): v.numpy()
          for k, v in model.state_dict().items() if not k.startswith("visual.")}
    text_sd = {k[len("text."):]: v for k, v in sd.items() if k.startswith("text.")}
    want = jax.tree.map(np.asarray, jconv._convert_modern_text(dict(text_sd)))
    got = pconv._convert_modern_text(text_sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    tree = pconv.torch_clip_to_params(sd, cfg)
    assert "_unconverted" not in tree and set(tree) == {"visual", "text", "logit_scale"}
    tree["visual"] = params["visual"]  # the text tower's checkpoint alone
    fresh = CLIPModel(cfg)
    fresh.load_state_dict(pconv.params_from_jax(tree, cfg), strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy())


def _jax_marks_by_port_name(tree, params, cfg):
    return {k: bool(v.flatten()[0]) for k, v in pconv.params_from_jax(
        jax.tree.map(lambda m, x: np.full(np.shape(x), float(m), np.float32), tree, params),
        cfg).items()}


def test_pure_bf16_and_weight_decay_partitions_match_jax():
    for variant in ("mt-vres-relu2", "mt-bidir-map", "mt-gated-qk"):
        _, params, cfg, model = _setup(variant)
        cast = jax.tree.map(lambda x: x.dtype == jnp.bfloat16,
                            jconv.convert_params_dtype(params, jnp.bfloat16))
        theirs = _jax_marks_by_port_name(cast, params, cfg)
        pconv.convert_params_dtype_(model, torch.bfloat16)
        assert {k: v.dtype == torch.bfloat16 for k, v in model.state_dict().items()} == theirs
        assert poptim.wd_mask(model) == _jax_marks_by_port_name(joptim.wd_mask(params), params, cfg)
    assert theirs["text.transformer.resblocks.0.attn.qkv.weight"]
    assert not theirs["text.token_embedding.weight"] and not theirs["text.ln_final.weight"]


MODERNTEXT_CONFIGS = ["moderntext-ViT-B-32-256", "moderntext-naflex_ViT-B-16",
                      "moderntext-naflex_ViT-B-32", "moderntext-naflex_ViT-B-deep-16",
                      "moderntext-naflex_ViT-SO150M2-16"]


@pytest.mark.parametrize("name", MODERNTEXT_CONFIGS)
def test_registry_configs_build_with_the_jax_parameter_count(name):
    shapes = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0), jax_parse_model_cfg(name)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = CLIPModel(parse_model_cfg(name))
    assert sum(p.numel() for p in model.parameters()) == want
    assert isinstance(model.text, pmt.ModernTextTransformer)


def test_tokenizer_names_the_tiktoken_vocabulary():
    for name in ("moderntext-ViT-B-32-256", "naflexclap_mediumd_pf4_pt20_moderntextp"):
        with pytest.raises(NotImplementedError, match="r50k_base"):
            oc.get_tokenizer(name)


def test_special_token_checks_match_jax():
    """``get_tokenizer``'s checks of the config's special ids (the JAX
    ``validate_special_tokens``): a variable-length text config needs a pad id the
    CLIP BPE tokenizer does not have, and an EOS pool needs its EOS id."""
    from open_clip_tpu import factory as jfactory
    from open_clip_tpu_torch import factory as pfactory
    from open_clip_tpu_torch.tokenizer import SimpleTokenizer

    tok = SimpleTokenizer(context_length=16)
    for text_cfg in ({"variable_text": True}, {"pool_type": "eos"},
                     {"pool_type": "eos", "eos_id": 5}, {"pool_type": "eos", "eos_id": 49407},
                     {"text_arch": "modern", "pool_type": "argmax", "eos_id": 49407}, {}):
        outcomes = []
        for check in (jfactory.validate_special_tokens, pfactory.validate_special_tokens):
            try:
                check(text_cfg, tok)
                outcomes.append(None)
            except ValueError as err:
                outcomes.append(str(err))
        assert outcomes[0] == outcomes[1], text_cfg
