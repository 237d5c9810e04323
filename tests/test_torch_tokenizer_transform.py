"""The PyTorch port's tokenizer and device preprocess against the JAX package.

The port's tokenizer uses only the standard library: its ``\\p{L}``/``\\p{N}``
classes are built from ``unicodedata`` categories, which these tests hold against
the ``regex`` module's classes over every code point, and its ids against the JAX
package's ``SimpleTokenizer``. The device preprocess (bicubic antialiased resize,
center crop, normalize) is held against the JAX ``make_device_preprocess`` on
non-square uint8 batches to 1e-5 on the normalized values (float rounding of two
separable filters summed in other orders).
"""

import re
import sys
import unicodedata

import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from open_clip_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from open_clip_tpu.transform import PreprocessCfg as JaxPreprocessCfg
from open_clip_tpu.transform import make_device_preprocess as jax_device_preprocess
from open_clip_tpu_torch import tokenizer as ptok
from open_clip_tpu_torch.transform import PreprocessCfg, make_device_preprocess

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

STRINGS = [
    "",
    "a photo of a cat.",
    "A PHOTO OF THE Dog's toy, it'll BE fine!!",
    "Café naïve Ünïcödé résumé",
    "日本語のテキスト 中文 한국어",
    "x² ½ ³⁄₄ ⅷ ① ٣ 10,000",
    "&amp;lt;b&amp;gt; tags &quot;quoted&quot;",
    "emoji 🐱‍👤 and combining ͅ marks",
    "<start_of_text> inside <end_of_text>",
    "   many    spaces\tand\nnewlines   ",
    " ".join(["long"] * 100),
]


@pytest.fixture(scope="module")
def tokenizers():
    return ptok.SimpleTokenizer(), JaxTokenizer()


@pytest.mark.parametrize("text", STRINGS, ids=range(len(STRINGS)))
def test_ids_match_jax(tokenizers, text):
    ours, ref = tokenizers
    assert ours.encode(text) == ref.encode(text)
    np.testing.assert_array_equal(ours([text]), ref([text]))


def test_batch_and_context_length_match_jax(tokenizers):
    ours, ref = tokenizers
    for context_length in (77, 8):
        a, b = ours(STRINGS, context_length), ref(STRINGS, context_length)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.decode(ours.encode("a photo of a cat")).strip() == "a photo of a cat"


@pytest.mark.parametrize("category,pattern", [("L", r"\p{L}"), ("N", r"\p{N}")])
def test_unicode_classes_match_regex(category, pattern):
    """Over every code point that the standard library's Unicode tables assign:
    ``regex`` may follow a newer Unicode version, whose new letters the port
    cannot know of."""
    text = "".join(chr(c) for c in range(sys.maxunicode + 1)
                   if unicodedata.category(chr(c)) not in ("Cs", "Cn"))
    ours = re.findall(f"[{ptok.unicode_class(category)}]", text)
    assert ours == regex.findall(pattern, text)
    assert "²" not in ours if category == "L" else "²" in ours


def _images(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape,size", [
    ((2, 48, 64, 3), 32),   # downscale, then crop the long side
    ((2, 70, 40, 3), 32),   # portrait
    ((2, 24, 30, 3), 32),   # upscale
    ((2, 32, 32, 3), 32),   # already at size: normalize only
    ((1, 50, 90, 3), (24, 40)),
    ((2, 256, 320, 3), 224),  # the serving path's request shape
])
def test_device_preprocess_matches_jax(shape, size):
    images = _images(sum(shape), shape)
    ours = make_device_preprocess(PreprocessCfg(size=size))(torch.from_numpy(images))
    ref = jax_device_preprocess(JaxPreprocessCfg(size=size))(jnp.asarray(images))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_device_preprocess_stays_on_the_input_device():
    out = make_device_preprocess(PreprocessCfg(size=16))(torch.from_numpy(_images(0, (1, 20, 24, 3))))
    assert out.device.type == "cpu" and out.is_contiguous()
