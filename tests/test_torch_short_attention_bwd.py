"""Short attention's backward in the PyTorch port against the JAX package.

The port's plain backward (``short_attention_bwd_reference``, what autograd runs
for CPU tensors and what the CUDA kernel is held against on the card) is compared
with ``jax.grad`` through the JAX Pallas kernels in interpret mode, as
``tests/test_short_attention.py`` runs them off-TPU. Inputs come from a numpy
seed and go through both frameworks. Tolerances, on gradients of size O(1):
fp32 <= 2e-5 (sums over up to 197 terms in other orders); bf16 <= 3e-2 (ds and
the probabilities are rounded to bf16, 2**-8 relative, before the products, and
each output is rounded once more; the two round at the same points but may
round a value on the boundary differently).

The CUDA kernel itself runs only on the card: ``test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import open_clip_tpu.ops.short_attention as jsa
from open_clip_tpu.ops.attention import dot_product_attention as jax_attention
from open_clip_tpu_torch.ops import short_attention as psa

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jsa, "_INTERPRET", True)


def _inputs(seed, b, l, h, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, hd)).astype(np.float32) for _ in range(4)]


def _port_bwd(q, k, v, do, dtype, causal):
    t = [torch.from_numpy(x).to(TORCH_DTYPES[dtype]) for x in (q, k, v, do)]
    return [g.float().numpy() for g in psa.short_attention_bwd_reference(*t, causal=causal)]


def _jax_grads(fn, q, k, v, do, dtype):
    jq, jk, jv, jdo = (jnp.asarray(x, JAX_DTYPES[dtype]) for x in (q, k, v, do))
    _, vjp = jax.vjp(fn, jq, jk, jv)
    return [np.asarray(g, np.float32) for g in vjp(jdo)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,h", [(50, 2), (77, 2), (197, 2), (50, 4)])
def test_plain_backward_matches_jax_kernel(interpret, l, h, causal, dtype):
    q, k, v, do = _inputs(l + h, 2, l, h, 64)
    ref = _jax_grads(lambda a, b, c: jsa.short_attention(a, b, c, causal=causal), q, k, v, do, dtype)
    out = _port_bwd(q, k, v, do, dtype, causal)
    for name, got, want in zip(("dq", "dk", "dv"), out, ref):
        assert np.isfinite(got).all(), name
        assert np.abs(got - want).max() <= TOL[dtype], name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,h,hd", [(17, 3, 32), (50, 2, 64), (60, 1, 128)])
def test_plain_backward_matches_autograd_of_plain_forward(l, h, hd, causal):
    """fp32 both ways (the plain versions compute in fp32 whatever they are given):
    <= 5e-6, sums of up to 60 terms in other orders."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(l, 2, l, h, hd))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(psa.short_attention_reference(q, k, v, causal=causal), (q, k, v), do)
    got = psa.short_attention_bwd_reference(q.detach(), k.detach(), v.detach(), do, causal=causal)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 5e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_c2_regime_matches_jax_dense(dtype):
    """Head 0's logits sit ~100 below head 1's, where a max shared across heads
    underflows one head's exponentials: the reference is the gradient of the JAX
    package's dense path, which keeps a max per head."""
    q, k, v, do = _inputs(3, 2, 50, 2, 64)
    q[:, :, 0] = 1.0 + 0.1 * q[:, :, 0]
    k[:, :, 0] = -100.0 / (64 * 64 ** -0.5) + 0.01 * k[:, :, 0]
    ref = _jax_grads(lambda a, b, c: jax_attention(a, b, c, impl="xla"), q, k, v, do, dtype)
    out = _port_bwd(q, k, v, do, dtype, False)
    for got, want in zip(out, ref):
        assert np.isfinite(got).all()
        # dk and dq reach ~10 here (|q| and |k| are large): the tolerance is relative
        assert np.abs(got - want).max() <= TOL[dtype] * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_function_on_cpu_uses_the_plain_backward(causal, dtype):
    q, k, v, do = (torch.from_numpy(x).to(TORCH_DTYPES[dtype]) for x in _inputs(9, 2, 50, 2, 64))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = dict(psa.LAUNCHES)
    out = psa.short_attention(q, k, v, causal=causal)
    assert out.requires_grad and out.dtype == q.dtype
    assert torch.equal(out, psa.short_attention_reference(q, k, v, causal=causal))
    got = torch.autograd.grad(out, (q, k, v), do)
    want = psa.short_attention_bwd_reference(q.detach(), k.detach(), v.detach(), do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert psa.LAUNCHES == before  # nothing was launched for CPU tensors


def test_function_runs_under_checkpoint():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(11, 2, 17, 2, 32)[:3])
    fn = lambda a, b, c: psa.short_attention(a, b, c, causal=True).square().sum()
    want = torch.autograd.grad(fn(q, k, v), (q, k, v))
    got = torch.autograd.grad(checkpoint(fn, q, k, v, use_reentrant=False), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_function_takes_views_of_a_fused_projection():
    """q, k, v as the three strided views of one (B, L, 3, H, hd) tensor, as the
    towers hand them over: the gradient reaches the fused tensor."""
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 17, 3, 2, 32),
                                                                    dtype=np.float32))
    qkv.requires_grad_()
    q, k, v = qkv.unbind(2)
    psa.short_attention(q, k, v).sum().backward()
    dq, dk, dv = psa.short_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                                   torch.ones(2, 17, 2, 32))
    assert torch.equal(qkv.grad, torch.stack([dq, dk, dv], dim=2))
