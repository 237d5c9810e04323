"""Primitive ops of the PyTorch port against the JAX package's ``ops/layers.py``.

Inputs come from a numpy seed and go through both frameworks. fp32 agrees to
float rounding (1e-6). bf16 results are held to one bf16 ulp (2**-7 relative)
plus 2**-8 absolute: JAX evaluates a bf16 activation in bf16 throughout, so near
zero its tanh form can cancel to 0 where PyTorch, which computes in fp32 and
rounds once, keeps a few 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.ops import layers as jl
from open_clip_tpu_torch.ops import layers as pl

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP = 2.0 ** -7


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(out: torch.Tensor, ref, dtype: str, what: str):
    assert out.dtype == DTYPES[dtype][1], what
    o, r = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-6, err_msg=what)
    else:
        np.testing.assert_allclose(o, r, rtol=BF16_ULP, atol=2.0 ** -8, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm(dtype, with_bias):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 7, 96)) + 1.5).astype(np.float32)
    scale = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32) if with_bias else None
    jx, tx = _pair(x, dtype)
    ref = jl.layer_norm(jx, jnp.asarray(scale), None if bias is None else jnp.asarray(bias))
    out = pl.layer_norm(tx, torch.from_numpy(scale), None if bias is None else torch.from_numpy(bias))
    _close(out, ref, dtype, "layer_norm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gelu", "quick_gelu"])
def test_activation(dtype, name):
    x = np.random.default_rng(1).standard_normal((3, 257)).astype(np.float32) * 4.0
    jx, tx = _pair(x, dtype)
    _close(pl.ACT_FNS[name](tx), jl.ACT_FNS[name](jx), dtype, name)


def test_gelu_form_follows_dtype():
    """tanh form in bf16, exact erf form in fp32: ``nn.GELU()``'s erf in bf16 would
    not match the JAX package."""
    x = torch.linspace(-4, 4, 1001).bfloat16().float()
    erf = torch.nn.functional.gelu(x)
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    assert torch.equal(pl.gelu(x), erf)
    assert torch.equal(pl.gelu(x.bfloat16()), tanh.bfloat16())


@pytest.mark.parametrize("transposed", [False, True])  # (in, out) kernel or nn.Linear weight
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear(dtype, transposed):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.125).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ref = jl.linear(jx, jnp.asarray(w), jnp.asarray(b))
    tw = torch.from_numpy(np.ascontiguousarray(w.T) if transposed else w)
    out = pl.linear(tx, tw, torch.from_numpy(b), transposed=transposed)
    if dtype == "float32":
        _close(out, ref, dtype, "linear")
    else:  # a bf16 product of 64 terms: sums rounded in other orders
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                                   rtol=2 * BF16_ULP, atol=2e-2)
