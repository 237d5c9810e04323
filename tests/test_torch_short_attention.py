"""Short attention in the PyTorch port against the JAX package.

The port's plain version (what ``short_attention`` computes for CPU tensors) is
held against the JAX Pallas kernel, run in interpret mode as
``tests/test_short_attention.py`` runs it off-TPU. Inputs come from a numpy seed
and go through both frameworks. Tolerances: fp32 <= 1e-5 (two fp32 softmaxes
summed in other orders); bf16 <= 2e-2 (the probabilities are rounded to bf16
before the product with v, about 2**-8 relative, in other places in the two).

The CUDA kernel itself runs only on the card: ``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_clip_tpu.ops.short_attention as jsa
from open_clip_tpu.ops.attention import dot_product_attention as jax_attention
from open_clip_tpu_torch.ops import attention as pattn
from open_clip_tpu_torch.ops import short_attention as psa

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jsa, "_INTERPRET", True)


def _qkv(seed, b, l, h, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, hd)).astype(np.float32) for _ in range(3)]


def _c2_qkv(seed, b, l, h, hd):
    """Head 0's logits sit ~100 below head 1's: the regime where a max shared
    across heads underflows one head's exponentials to zero."""
    q, k, v = _qkv(seed, b, l, h, hd)
    q[:, :, 0] = 1.0 + 0.1 * q[:, :, 0]
    k[:, :, 0] = -100.0 / (hd * hd ** -0.5) + 0.01 * k[:, :, 0]
    return q, k, v


def _port(q, k, v, dtype, causal):
    t = [torch.from_numpy(x).to(TORCH_DTYPES[dtype]) for x in (q, k, v)]
    return psa.short_attention(*t, causal=causal).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,h", [(17, 2), (50, 2), (17, 4), (50, 4), (129, 1), (257, 2)])
def test_plain_matches_jax_kernel(interpret, l, h, causal, dtype):
    q, k, v = _qkv(l * 10 + h, 2, l, h, 64)
    j = [jnp.asarray(x, JAX_DTYPES[dtype]) for x in (q, k, v)]
    ref = np.asarray(jsa.short_attention(*j, causal=causal).astype(jnp.float32))
    out = _port(q, k, v, dtype, causal)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_c2_regime_matches_jax_dense(dtype):
    q, k, v = _c2_qkv(3, 2, 50, 2, 64)
    j = [jnp.asarray(x, JAX_DTYPES[dtype]) for x in (q, k, v)]
    ref = np.asarray(jax_attention(*j, impl="xla").astype(jnp.float32))
    out = _port(q, k, v, dtype, False)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype])


def test_plain_version_is_differentiable():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(4, 2, 17, 2, 32))
    psa.short_attention_reference(q, k, v, causal=True).square().sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_cpu_call_is_not_a_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 17, 2, 64))
    before = dict(psa.LAUNCHES)
    psa.short_attention(q, k, v)
    assert psa.LAUNCHES == before


@pytest.mark.parametrize("l,h,hd,bias,ok", [
    (50, 12, 64, None, True),
    (77, 8, 64, None, True),
    (288, 1, 128, None, True),
    (289, 1, 64, None, False),
    (50, 3, 48, None, False),
    (50, 12, 64, "bias", False),
])
def test_supports(l, h, hd, bias, ok):
    assert psa.supports(l, h, hd, bias) is ok


@pytest.mark.parametrize("on_cuda,l,hd,bias,key_valid,expect", [
    (False, 50, 64, None, None, "dense"),
    (True, 50, 64, None, None, "short"),
    (True, 77, 64, None, None, "short"),
    (True, 50, 64, "bias", None, "dense"),
    (True, 50, 64, None, "mask", "dense"),  # the short kernel takes no mask; too short for flash
    (True, 300, 64, None, None, "dense"),
    (True, 600, 48, None, None, "dense"),
    (False, 1024, 64, None, None, "dense"),
])
def test_dispatch(on_cuda, l, hd, bias, key_valid, expect):
    assert pattn.select_impl(on_cuda, l, l, 4, hd, bias, key_valid) == expect


@pytest.mark.parametrize("key_valid", [None, "mask"])
def test_dispatch_raises_for_flash_shapes(key_valid):
    """These shapes raised while the flash kernels were unported; now they select them."""
    assert pattn.select_impl(True, 1024, 1024, 8, 64, None, key_valid) == "flash"
