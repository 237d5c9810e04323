"""Loading reference checkpoints into the port, against the JAX package, on the CPU.

Every checkpoint here is written from a seeded model at micro size in the
reference's file formats; no released weights are in the repository. The port's
converters (``convert.torch_clip_to_params`` and the Swin, HTSAT and CLAP ones) must
give the JAX package's param tree leaf for leaf, exactly; ``create_model`` from each
file format must give JAX's features on the same file (1e-5, fp32); the merge follows
JAX's strict rules with its exception types; ``load_big_vision_weights`` and the
position-embedding resize match JAX's (the resize within 1e-6 of the largest entry:
JAX builds its weights and sums in float32); the registry is JAX's.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_clip_tpu as oct
from open_clip_tpu import checkpoint as jckpt
from open_clip_tpu import convert as jconv
from open_clip_tpu import pretrained as jpre
from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.config import parse_model_cfg as jparse
from open_clip_tpu.models import clap as jclap
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.models import swin as jswin
from open_clip_tpu.ops import pos_embed as jpos
from open_clip_tpu.push_to_hf_hub import save_for_hf as jax_save_for_hf

import open_clip_tpu_torch as oc
from open_clip_tpu_torch import _safetensors as pst
from open_clip_tpu_torch import checkpoint as pckpt
from open_clip_tpu_torch import convert as pconv
from open_clip_tpu_torch import pretrained as ppre
from open_clip_tpu_torch.models import clap as pclap
from open_clip_tpu_torch.models import swin as pswin
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.ops import pos_embed as ppos
from open_clip_tpu_torch.push_to_hf_hub import push_to_hf_hub, save_for_hf

from tests.test_timm_vit_convert import TimmNaFlexViT, TimmSiglipViT

TINY = {"embed_dim": 32,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16,
                       "head_width": 32},
        "text_cfg": {"context_length": 16, "vocab_size": 1000, "width": 64, "heads": 2,
                     "layers": 2}}
SIGLIP = {"embed_dim": 32, "init_logit_bias": -10, "custom_text": True,
          "vision_cfg": {"image_size": 32, "layers": 2, "width": 32, "patch_size": 16,
                         "head_width": 16, "class_token": False, "pool_type": "map",
                         "no_ln_pre": True},
          "text_cfg": {"context_length": 12, "vocab_size": 64, "width": 32, "heads": 2,
                       "layers": 2, "no_causal_mask": True, "pool_type": "last",
                       "proj_bias": True}}
SWIN = "swin_micro_patch4_window7_56"
SWIN_MICRO = dict(patch_size=4, embed_dim=24, depths=(2, 2), heads=(3, 3), window=7, mlp_ratio=4.0)
SWIN_CFG = {"embed_dim": 24, "text_cfg": {"context_length": 16, "width": 32, "heads": 2, "layers": 1},
            "vision_cfg": {"image_size": 56, "timm_model_name": SWIN, "timm_model_pretrained": False,
                           "timm_pool": "", "timm_proj": "linear"}}
HTSAT_MICRO = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), spec_size=64)
CLAP_CFG = {"embed_dim": 32, "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2},
            "audio_cfg": {"model_type": "HTSAT", "model_name": "micro", "sample_rate": 16000,
                          "window_size": 256, "hop_size": 64, "mel_bins": 32, "fmin": 50,
                          "fmax": 8000, "clip_samples": 8000, "class_num": 10}}
NAMES = {"tiny-pre-vit": TINY, "tiny-pre-siglip": SIGLIP, "tiny-pre-swin": SWIN_CFG,
         "tiny-pre-clap": CLAP_CFG}


@pytest.fixture(scope="module", autouse=True)
def registered():
    for configs in (jswin.SWIN_CONFIGS, pswin.SWIN_CONFIGS):
        configs[SWIN] = SWIN_MICRO
    for configs in (jclap.HTSAT_CONFIGS, pclap.HTSAT_CONFIGS):
        configs["micro"] = HTSAT_MICRO
    for name, cfg in NAMES.items():
        for pkg in (oct, oc):
            pkg.add_model_config(json.loads(json.dumps(cfg)), name=name)
    yield
    for configs in (jswin.SWIN_CONFIGS, pswin.SWIN_CONFIGS):
        configs.pop(SWIN, None)
    for configs in (jclap.HTSAT_CONFIGS, pclap.HTSAT_CONFIGS):
        configs.pop("micro", None)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _jax_params(name, seed=0):
    return jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(seed),
                                                     JaxCfg.from_dict(NAMES[name])))


def _port_model(name, seed=0):
    """The port's model for ``name`` with its own init from ``seed``."""
    model = CLIPModel(oc.CLIPModelCfg.from_dict(NAMES[name]))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _port_model_of_jax(name, seed):
    """The port's model holding the JAX package's init for ``name``."""
    model = CLIPModel(oc.CLIPModelCfg.from_dict(NAMES[name]))
    model.load_state_dict(pconv.params_from_jax(_jax_params(name, seed), model.cfg), strict=True)
    return model


def _patchify_to_conv(w: torch.Tensor, in_chans: int) -> torch.Tensor:
    p = int(round((w.shape[0] // in_chans) ** 0.5))
    return w.reshape(p, p, in_chans, -1).permute(3, 2, 0, 1).contiguous()


def _reference_layout(model) -> dict:
    """A Swin or HTSAT CLAP port model's weights under the reference's names: the
    timm trunk under ``visual.trunk.`` (TimmModel's head at ``visual.head``), the
    HTSAT encoder under ``audio.encoder.``, patch embeddings as convolutions, the
    text tower under ``text.``."""
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith("patch_embed.proj.weight"):
            v = _patchify_to_conv(v, 3 if k.startswith("visual.") else 1)
        if k.startswith("visual.") and not k.startswith("visual.head."):
            k = "visual.trunk." + k[len("visual."):]
        elif not k.startswith(("visual.", "audio.", "logit_")):
            k = "text." + k
        out[k] = v.clone()
    return out


# ---------------------------------------------------------------------------
# the safetensors reader and writer, against the safetensors package
# ---------------------------------------------------------------------------

TENSORS = {"f32": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)),
           "f16": torch.randn(7, generator=torch.Generator().manual_seed(1)).half(),
           "bf16": torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(2)).bfloat16(),
           "i64": torch.arange(-4, 5), "empty": torch.zeros(0, 4)}


@pytest.mark.parametrize("writer", ["numpy", "torch"])
def test_safetensors_reader_reads_the_package_files(tmp_path, writer):
    path = tmp_path / "x.safetensors"
    if writer == "torch":
        from safetensors.torch import save_file

        tensors = TENSORS
        save_file(tensors, str(path), metadata={"format": "pt"})
    else:
        from safetensors.numpy import save_file

        tensors = {k: v for k, v in TENSORS.items() if k != "bf16"}  # numpy has no bfloat16
        save_file({k: v.numpy() for k, v in tensors.items()}, str(path), metadata={"a": "b"})
    got = pst.load_file(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load

    path = tmp_path / "y.safetensors"
    pst.save_file(TENSORS, path, metadata={"format": "pt"})
    nonbf = {k: v for k, v in TENSORS.items() if k != "bf16"}  # numpy's loader has no bfloat16
    pst.save_file(nonbf, tmp_path / "z.safetensors")
    back = np_load(str(tmp_path / "z.safetensors"))
    assert sorted(back) == sorted(nonbf)
    for k, v in nonbf.items():
        assert np.array_equal(back[k], v.numpy()) and back[k].dtype == v.numpy().dtype, k
    for k, v in torch_load(str(path)).items():
        assert v.dtype == TENSORS[k].dtype and torch.equal(v, TENSORS[k]), k


# ---------------------------------------------------------------------------
# the converters, tree for tree against the JAX package's
# ---------------------------------------------------------------------------

def test_normalize_torch_state_dict_matches_jax():
    rng = np.random.default_rng(0)
    arr = lambda *s: np.asarray(rng.standard_normal(s), np.float32)  # noqa: E731
    cases = [
        {"module.visual.proj": arr(4, 2), "module.logit_scale": arr(1)},
        {"_orig_mod.visual.conv1.weight": arr(2, 3, 2, 2), "text.position_ids": arr(3)},
        {"token_embedding.weight": arr(5, 4), "positional_embedding": arr(3, 4),
         "transformer.resblocks.0.ln_1.weight": arr(4), "ln_final.bias": arr(4),
         "text_projection": arr(4, 2), "visual.positional_embedding": arr(5, 4),
         "position_ids": arr(3), "module.logit_scale": arr()},
        {"text.token_embedding.weight": arr(5, 4), "text_projection.weight": arr(2, 4)},
    ]
    for sd in cases:
        sd_t = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
        got, want = pconv.normalize_torch_state_dict(sd_t), jconv.normalize_torch_state_dict(sd)
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("custom_text", [True, False])
def test_native_vit_tree_equals_jax(custom_text):
    cfg = oc.CLIPModelCfg.from_dict(TINY)
    sd = jconv.params_to_torch_state_dict(jax.tree.map(jnp.asarray, _jax_params("tiny-pre-vit")),
                                          custom_text=custom_text)
    sd = {k: np.asarray(v) for k, v in sd.items()}
    _assert_trees_equal(pconv.torch_clip_to_params(sd, cfg),
                        jconv.torch_clip_to_params(sd, JaxCfg.from_dict(TINY)))


@pytest.mark.parametrize("trunk", ["siglip", "naflex"])
def test_timm_trunk_trees_equal_jax(trunk):
    torch.manual_seed(0)
    if trunk == "siglip":
        module, name = TimmSiglipViT(w=32, layers=2, heads=2, patch=16, size=32), "ViT-B-16-SigLIP"
    else:
        module, name = TimmNaFlexViT(w=32, layers=2, heads=2, patch=16, grid=(3, 4)), \
            "ViT-B-16-SigLIP2-naflex"
    sd = {f"visual.trunk.{k}": v.detach().clone() for k, v in module.state_dict().items()}
    sd["logit_scale"] = torch.tensor(2.5)
    want = jconv.torch_clip_to_params(sd, jparse(name))
    got = pconv.torch_clip_to_params(sd, oc.config.parse_model_cfg(name))
    _assert_trees_equal(got, want)


def test_swin_tree_equals_jax():
    model = _port_model("tiny-pre-swin")
    sd = _reference_layout(model)
    want = jconv.torch_clip_to_params(sd, JaxCfg.from_dict(SWIN_CFG))
    got = pconv.torch_clip_to_params(sd, model.cfg)
    _assert_trees_equal(got, want)
    assert pconv.params_from_jax(got, model.cfg).keys() == model.state_dict().keys()


def test_htsat_clap_tree_equals_jax():
    model = _port_model("tiny-pre-clap")
    sd = _reference_layout(model)
    jcfg = JaxCfg.from_dict(CLAP_CFG)
    _assert_trees_equal(pclap.torch_clap_to_params(sd, model.cfg),
                        jclap.torch_clap_to_params(sd, jcfg))
    # the port loads it strictly; JAX's strict merge counts the empty ``visual`` that
    # its text converter leaves as an unexpected key (a fault of the JAX package)
    loaded = pckpt.merge_params_(_port_model("tiny-pre-clap", seed=9),
                                 pckpt.checkpoint_to_params(sd, model.cfg), strict=True)
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in model.state_dict().items())
    tree = jclap.torch_clap_to_params(sd, jcfg)
    with pytest.raises(KeyError, match="visual"):
        jckpt.merge_params({k: v for k, v in tree.items() if k != "visual"}, tree, jcfg,
                           strict=True)
    with pytest.raises(NotImplementedError, match="fusion"):
        pclap.torch_clap_to_params({**sd, "audio.encoder.fusion_model.x": torch.zeros(1)},
                                   model.cfg)


def test_hf_clap_audio_tree_equals_jax():
    """transformers' ClapModel at micro size (the geometry of test_hf_clap_convert.py's
    fixture, narrowed): unfused, the audio half and the logit scale equal JAX's tree
    and the whole raises for its RoBERTa text tower; fused, it raises for the fusion
    modules."""
    transformers = pytest.importorskip("transformers")

    def hf_model(fusion):
        torch.manual_seed(5)
        ac = transformers.ClapAudioConfig(
            window_size=4, spec_size=64, patch_stride=[4, 4], patch_size=4,
            patch_embeds_hidden_size=16, depths=[1, 1], num_attention_heads=[2, 2],
            hidden_size=32, num_mel_bins=32, enable_fusion=fusion, projection_dim=16,
            num_hidden_layers=2)
        tc = transformers.ClapTextConfig(projection_dim=16, vocab_size=50, hidden_size=16,
                                         num_hidden_layers=1, num_attention_heads=2,
                                         intermediate_size=32, max_position_embeddings=24)
        return transformers.ClapModel(transformers.ClapConfig(
            audio_config=ac.to_dict(), text_config=tc.to_dict(), projection_dim=16))

    sd = hf_model(False).state_dict()
    jcfg = JaxCfg.from_dict({**CLAP_CFG, "text_cfg": {"hf_model_config": {"model_type": "roberta"}}})
    want = jclap.hf_clap_to_params(sd, jcfg)
    got = pclap.hf_clap_audio_to_params(sd)
    _assert_trees_equal(got, {"audio": want["audio"], "logit_scale": want["logit_scale"]})
    cfg = oc.CLIPModelCfg.from_dict(CLAP_CFG)
    with pytest.raises(NotImplementedError, match="RoBERTa"):
        pckpt.checkpoint_to_params(sd, cfg)
    with pytest.raises(NotImplementedError, match="fusion"):
        pclap.hf_clap_audio_to_params(hf_model(True).state_dict())


@pytest.mark.parametrize("family,sd", [
    ("ConvNeXt", {"visual.trunk.stem.0.weight": torch.zeros(1)}),
    ("ModifiedResNet", {"visual.layer1.0.conv1.weight": torch.zeros(1)}),
    ("CoCa", {"text_decoder.x": torch.zeros(1)}),
    ("MobileCLIP", {"image_encoder.model.x": torch.zeros(1)}),
])
def test_unported_families_raise(family, sd):
    with pytest.raises(NotImplementedError, match=family):
        pconv.torch_clip_to_params(sd, oc.CLIPModelCfg.from_dict(TINY))


# ---------------------------------------------------------------------------
# create_model(pretrained=...) through each format, against JAX on the same file
# ---------------------------------------------------------------------------

def _write(fmt, tmp_path):
    """Write the JAX package's seed-3 tiny ViT in ``fmt``; returns the pretrained
    argument (and model name) that loads it."""
    jm = oct.create_model("tiny-pre-vit", seed=3)
    sd = {k: np.ascontiguousarray(v) for k, v in
          jconv.params_to_torch_state_dict(jm.params, custom_text=fmt != "pt_bare").items()}
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    if fmt == "pt_wrapped":
        path = tmp_path / "w.pt"
        torch.save({"state_dict": {"module." + k: v for k, v in tsd.items()}, "epoch": 3}, path)
    elif fmt in ("pt_bare", "bin"):
        path = tmp_path / ("w.pt" if fmt == "pt_bare" else "open_clip_pytorch_model.bin")
        torch.save(tsd, path)
    elif fmt == "safetensors":
        from safetensors.torch import save_file

        path = tmp_path / "w.safetensors"
        save_file(tsd, str(path))
    elif fmt == "npz":
        path = tmp_path / "w.npz"
        np.savez(path, **sd)
    elif fmt == "local_dir_jax":
        jax_save_for_hf(jm, str(tmp_path / "d"), model_config=oct.get_model_config("tiny-pre-vit"))
        return "local-dir:" + str(tmp_path / "d"), None
    elif fmt == "local_dir_port":
        model = oc.create_model("tiny-pre-vit", pretrained=str(_write("npz", tmp_path)[1]),
                                device="cpu")
        save_for_hf(model, tmp_path / "d")
        return "local-dir:" + str(tmp_path / "d"), None
    return "tiny-pre-vit", str(path)


def _features(model, jax_model):
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    txt = rng.integers(1, 999, (2, model.cfg.text_cfg.context_length)).astype(np.int32)
    with torch.no_grad():
        got = (model.encode_image(torch.from_numpy(img)).numpy(),
               model.encode_text(torch.from_numpy(txt).long()).numpy())
    want = (np.asarray(jax_model.encode_image(img)), np.asarray(jax_model.encode_text(txt)))
    return got, want


@pytest.mark.parametrize("fmt", ["pt_wrapped", "pt_bare", "bin", "safetensors", "npz",
                                 "local_dir_jax", "local_dir_port"])
def test_create_model_loads_each_format_as_jax(tmp_path, fmt):
    name, pretrained = _write(fmt, tmp_path)
    model = oc.create_model(name, pretrained=pretrained, device="cpu")
    jax_model = oct.create_model(name, pretrained=pretrained)
    for got, want in zip(*_features(model, jax_model)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if fmt == "pt_wrapped":  # the weights themselves: the JAX tree through params_from_jax
        want = pconv.params_from_jax(jax.tree.map(np.asarray, jax_model.params), model.cfg)
        assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())


def test_local_dir_carries_the_preprocess_and_pure_bf16_casts_after(tmp_path):
    name, pretrained = _write("pt_bare", tmp_path)
    src = oc.create_model(name, pretrained=pretrained, device="cpu")
    src.preprocess_cfg.mean, src.preprocess_cfg.std = (0.5, 0.5, 0.5), (0.25, 0.5, 0.75)
    save_for_hf(src, tmp_path / "d")
    model, _, _ = oc.create_model_and_transforms(f"local-dir:{tmp_path / 'd'}",
                                                 precision="pure_bf16", device="cpu")
    assert model.preprocess_cfg.mean == (0.5, 0.5, 0.5) and model.preprocess_cfg.std == (0.25, 0.5, 0.75)
    ref = oc.convert_params_dtype_(oc.create_model(name, pretrained=pretrained, device="cpu"),
                                   torch.bfloat16)
    for k, v in ref.state_dict().items():
        assert model.state_dict()[k].dtype == v.dtype and torch.equal(model.state_dict()[k], v), k


def test_save_for_hf_refuses_what_the_reference_layout_lacks(tmp_path):
    for name in ("tiny-pre-siglip", "tiny-pre-swin"):  # a MAP pool and patch bias; a Swin tower
        with pytest.raises(NotImplementedError):
            save_for_hf(_port_model(name), tmp_path / name)
        assert not (tmp_path / name).exists()
    with pytest.raises(NotImplementedError, match="hub"):
        push_to_hf_hub(_port_model("tiny-pre-vit"), "org/repo")


def test_force_sizes_resize_the_position_embeddings_as_jax(tmp_path):
    _, pretrained = _write("pt_bare", tmp_path)
    kw = dict(force_image_size=48, force_context_length=12)
    model = oc.create_model("tiny-pre-vit", pretrained=pretrained, device="cpu", **kw)
    jax_model = oct.create_model("tiny-pre-vit", pretrained=pretrained, **kw)
    assert model.visual.positional_embedding.shape == (10, 64)
    assert model.positional_embedding.shape == (12, 64)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    txt = rng.integers(1, 999, (2, 12)).astype(np.int32)
    with torch.no_grad():
        np.testing.assert_allclose(model.encode_image(torch.from_numpy(img)).numpy(),
                                   np.asarray(jax_model.encode_image(img)), rtol=0, atol=1e-5)
        np.testing.assert_allclose(model.encode_text(torch.from_numpy(txt).long()).numpy(),
                                   np.asarray(jax_model.encode_text(txt)), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# strict semantics
# ---------------------------------------------------------------------------

def _both_load(sd, strict, name="tiny-pre-vit"):
    """(port outcome, JAX outcome): the exception type raised, or None."""
    outcomes = []
    for load in (lambda: pckpt.merge_params_(_port_model(name, seed=9),
                                             pckpt.checkpoint_to_params(sd, _port_model(name).cfg),
                                             strict=strict),
                 lambda: jckpt.merge_params(_jax_params(name, seed=9),
                                            {k: v for k, v in jconv.torch_clip_to_params(
                                                sd, JaxCfg.from_dict(NAMES[name])).items()
                                             if k != "_unconverted"},
                                            JaxCfg.from_dict(NAMES[name]), strict=strict)):
        try:
            load()
            outcomes.append(None)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            outcomes.append(type(e))
    return tuple(outcomes)


def _ref_sd(name="tiny-pre-vit"):
    return {k: np.asarray(v) for k, v in jconv.params_to_torch_state_dict(
        jax.tree.map(jnp.asarray, _jax_params(name, seed=4)), custom_text=True).items()}


@pytest.mark.parametrize("case,strict,want", [
    ("missing", True, KeyError), ("missing", False, None),
    ("missing_logit_bias", True, None),
    ("unexpected", True, KeyError), ("unexpected", False, None),
    ("shape", True, ValueError),
])
def test_strict_semantics_match_jax(case, strict, want, caplog):
    name = "tiny-pre-siglip" if case == "missing_logit_bias" else "tiny-pre-vit"
    if case == "missing_logit_bias":  # a tree without it: JAX's inverse drops SigLIP's MAP pool
        tree = {k: v for k, v in _jax_params(name, seed=4).items() if k != "logit_bias"}
        model = pckpt.merge_params_(_port_model(name, seed=9), tree, strict=True)
        assert model.logit_bias.item() == pytest.approx(-10.0)  # kept from the init
        jckpt.merge_params(_jax_params(name, seed=9), tree, JaxCfg.from_dict(NAMES[name]), True)
        return
    sd = _ref_sd()
    if case == "missing":
        sd.pop("visual.ln_post.weight")
    elif case == "unexpected":
        sd["logit_bias"] = np.asarray(-3.0, np.float32)
    elif case == "shape":
        sd["visual.proj"] = sd["visual.proj"][:, :16]
    with caplog.at_level(logging.WARNING):
        assert _both_load(sd, strict) == (want, want)
    if case == "unexpected" and not strict:
        assert "unexpected checkpoint keys dropped" in caplog.text


# ---------------------------------------------------------------------------
# big_vision .npz
# ---------------------------------------------------------------------------

def _big_vision_npz(path, root: str):
    """The synthetic big_vision SigLIP file of tests/test_interop.py's
    test_big_vision_npz_import, for the micro SigLIP config, under ``root``."""
    rng = np.random.default_rng(0)
    rnd = lambda *s, scale=0.05: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    w, heads, hd = 32, 2, 16
    arr = {"img/embedding/kernel": rnd(16, 16, 3, w, scale=0.02), "img/embedding/bias": rnd(w),
           "img/pos_embedding": rnd(1, 4, w, scale=0.02),
           "img/Transformer/encoder_norm/scale": 1 + rnd(w),
           "img/Transformer/encoder_norm/bias": rnd(w)}

    def mha(mp):
        for n in ("query", "key", "value"):
            arr[f"{mp}{n}/kernel"], arr[f"{mp}{n}/bias"] = rnd(w, heads, hd), rnd(heads, hd)
        arr[f"{mp}out/kernel"], arr[f"{mp}out/bias"] = rnd(heads, hd, w), rnd(w)

    for side in ("img/Transformer/", "txt/Encoder_0/"):
        for i in range(2):
            bp = f"{side}encoderblock_{i}/"
            mha(bp + "MultiHeadDotProductAttention_0/")
            for j in (0, 1):
                arr[f"{bp}LayerNorm_{j}/scale"], arr[f"{bp}LayerNorm_{j}/bias"] = 1 + rnd(w), rnd(w)
            arr[f"{bp}MlpBlock_0/Dense_0/kernel"], arr[f"{bp}MlpBlock_0/Dense_0/bias"] = \
                rnd(w, 4 * w), rnd(4 * w)
            arr[f"{bp}MlpBlock_0/Dense_1/kernel"], arr[f"{bp}MlpBlock_0/Dense_1/bias"] = \
                rnd(4 * w, w), rnd(w)
    bp = "img/MAPHead_0/"
    arr[f"{bp}probe"] = rnd(1, 1, w)
    mha(bp + "MultiHeadDotProductAttention_0/")
    arr[f"{bp}LayerNorm_0/scale"], arr[f"{bp}LayerNorm_0/bias"] = 1 + rnd(w), rnd(w)
    arr[f"{bp}MlpBlock_0/Dense_0/kernel"], arr[f"{bp}MlpBlock_0/Dense_0/bias"] = rnd(w, 128), rnd(128)
    arr[f"{bp}MlpBlock_0/Dense_1/kernel"], arr[f"{bp}MlpBlock_0/Dense_1/bias"] = rnd(128, w), rnd(w)
    arr["txt/Embed_0/embedding"] = rnd(64, w, scale=0.02)
    arr["txt/pos_embedding"] = rnd(1, 12, w, scale=0.02)
    arr["txt/Encoder_0/encoder_norm/scale"] = 1 + rnd(w)
    arr["txt/Encoder_0/encoder_norm/bias"] = rnd(w)
    arr["txt/head/kernel"], arr["txt/head/bias"] = rnd(w, 32), rnd(32)
    arr["t"], arr["b"] = np.asarray([4.6], np.float32), np.asarray([-12.9], np.float32)
    np.savez(path, **{root + k: v for k, v in arr.items()})


@pytest.mark.parametrize("root", ["", "params/"], ids=["bare", "params_root"])
def test_load_big_vision_weights_matches_jax(tmp_path, root):
    path = tmp_path / "siglip.npz"
    _big_vision_npz(path, root)
    jcfg = JaxCfg.from_dict(SIGLIP)
    want = jconv.load_big_vision_weights(_jax_params("tiny-pre-siglip", seed=9), jcfg, str(path))
    # the file lacks the image projection: both keep the model's own, JAX's init
    model = pconv.load_big_vision_weights(_port_model_of_jax("tiny-pre-siglip", seed=9), path)
    want = pconv.params_from_jax(jax.tree.map(np.asarray, want), model.cfg)
    assert want.keys() == model.state_dict().keys()
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert model.logit_bias.item() == pytest.approx(-12.9)
    # create_model reads an .npz as a flat state dict of reference names, as JAX does:
    # a big_vision file then has none of the model's keys
    with pytest.raises(KeyError, match="missing keys"):
        oc.create_model("tiny-pre-siglip", pretrained=str(path), device="cpu")


# ---------------------------------------------------------------------------
# position-embedding resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("old,new", [(7, 8), (14, 16), (16, 24), (16, 12)])
@pytest.mark.parametrize("prefix", [0, 1], ids=["no_cls", "cls"])
def test_vision_pos_embed_resize_matches_jax(old, new, prefix):
    x = np.random.default_rng(old * new + prefix).standard_normal(
        (prefix + old * old, 32)).astype(np.float32)
    want = np.asarray(jpos.resize_vision_pos_embed(jnp.asarray(x), (new, new), (old, old),
                                                   num_prefix=prefix))
    got = ppos.resize_vision_pos_embed(torch.from_numpy(x), (new, new), (old, old),
                                       num_prefix=prefix).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("new", [64, 96])
def test_text_pos_embed_resize_matches_jax(new):
    x = np.random.default_rng(new).standard_normal((77, 32)).astype(np.float32)
    want = np.asarray(jpos.resize_text_pos_embed(jnp.asarray(x), new))
    got = ppos.resize_text_pos_embed(torch.from_numpy(x), new).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    assert ppre.list_pretrained() == jpre.list_pretrained()
    assert ppre.list_pretrained(as_str=True) == jpre.list_pretrained(as_str=True)
    for model, tag in (("ViT-B-32", "laion2b_s34b_b79k"), ("ViT-B-16-SigLIP", "webli"),
                       ("ViT-L-14", "openai")):
        assert ppre.get_pretrained_cfg(model, tag) == jpre.get_pretrained_cfg(model, tag)
        assert ppre.get_pretrained_url(model, tag) == jpre.get_pretrained_url(model, tag)
    assert ppre.list_pretrained_tags_by_model("ViT-B-32") == jpre.list_pretrained_tags_by_model("ViT-B-32")
    assert ppre.list_pretrained_models_by_tag("webli") == jpre.list_pretrained_models_by_tag("webli")


def test_tags_and_hub_names_raise():
    with pytest.raises(NotImplementedError, match="laion/CLIP-ViT-B-32-laion2B-s34B-b79K"):
        oc.create_model("ViT-B-32", pretrained="laion2b_s34b_b79k", device="cpu")
    with pytest.raises(RuntimeError, match="Available tags"):
        oc.create_model("ViT-B-32", pretrained="no_such_tag", device="cpu")
    with pytest.raises(NotImplementedError, match="hub"):
        oc.create_model("hf-hub:timm/ViT-B-16-SigLIP", device="cpu")
    with pytest.raises(RuntimeError, match="required"):
        oc.create_model_from_pretrained("tiny-pre-vit", device="cpu")
    with pytest.raises(NotImplementedError, match="patch dropout"):
        oc.create_model("tiny-pre-vit", force_patch_dropout=0.5, device="cpu")


def test_force_overrides_give_jax_config():
    kw = dict(force_quick_gelu=True, force_custom_text=True, force_image_size=48,
              force_context_length=12, force_patch_dropout=0.0)
    got = oc.create_model("tiny-pre-vit", device="cpu", **kw).cfg.to_dict()
    want = oct.create_model("tiny-pre-vit", **kw).cfg.to_dict()
    for tower in ("vision_cfg", "text_cfg"):
        assert {k: v for k, v in got[tower].items() if k in want[tower]} == want[tower]
    assert {k: v for k, v in got.items() if k not in ("vision_cfg", "text_cfg")} == \
        {k: v for k, v in want.items() if k not in ("vision_cfg", "text_cfg")}
