"""The fused LayerNorm backward in the PyTorch port against the JAX package.

The port's plain backward (``layer_norm_bwd_reference``, what autograd runs for
CPU tensors with the switch on and what the CUDA kernel is held against on the
card) is compared with the JAX package's Pallas kernel in interpret mode, as
``tests/test_fused_ln.py`` runs it off-TPU, and with ``jax.grad`` of its plain
``layer_norm``. Inputs come from a numpy seed. Tolerances: dx fp32 <= 1e-5;
dx bf16 <= 2e-2 (one bf16 rounding of values of size ~2); dscale and dbias are
fp32 sums over up to 512 rows in other orders, <= 1e-4 relative to their
largest entry.

The CUDA kernel itself runs only on the card: ``test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.ops import fused_ln as jfl
from open_clip_tpu.ops.layers import layer_norm as jax_layer_norm
from open_clip_tpu_torch.ops import fused_ln as pfl
from open_clip_tpu_torch.ops import layers as pl

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DX_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [((4, 77, 128), "bfloat16"), ((512, 256), "float32"), ((3, 128, 384), "bfloat16"),
          ((2, 150, 128), "float32")]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfl, "_INTERPRET", True)


def _inputs(shape, with_bias):
    rng = np.random.default_rng(0)
    w = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(w) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(w) * 0.1).astype(np.float32) if with_bias else None
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


def _jax_grads(fn, x, scale, bias, dy, dtype):
    jx, jdy = jnp.asarray(x, JAX_DTYPES[dtype]), jnp.asarray(dy, JAX_DTYPES[dtype])
    if bias is None:
        _, vjp = jax.vjp(lambda a, s: fn(a, s, None), jx, jnp.asarray(scale))
    else:
        _, vjp = jax.vjp(fn, jx, jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(g, np.float32) for g in vjp(jdy)]


def _assert_close(got, want, dtype):
    names = ("dx", "dscale", "dbias")
    for name, a, b in zip(names, got, want):
        tol = DX_TOL[dtype] if name == "dx" else 1e-4 * max(1.0, np.abs(b).max())
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max())


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape,dtype", SHAPES)
@pytest.mark.parametrize("against", ["pallas_interpret", "jax_grad_of_plain"])
def test_plain_backward_matches_jax(interpret, against, shape, dtype, with_bias):
    x, scale, bias, dy = _inputs(shape, with_bias)
    fn = jfl.layer_norm_fused_bwd if against == "pallas_interpret" else jax_layer_norm
    want = _jax_grads(fn, x, scale, bias, dy, dtype)
    tx, tdy = (torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in (x, dy))
    dx, dscale, dbias = pfl.layer_norm_bwd_reference(tx, tdy, torch.from_numpy(scale))
    got = [dx.float().numpy(), dscale.numpy(), dbias.numpy()]
    _assert_close(got[:len(want)], want, dtype)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_switch_routes_autograd_through_the_plain_backward_on_cpu(monkeypatch, dtype, with_bias):
    x, scale, bias, dy = _inputs((3, 20, 64), with_bias)
    tx = torch.from_numpy(x).to(TORCH_DTYPES[dtype]).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_() if with_bias else None
    tdy = torch.from_numpy(dy).to(TORCH_DTYPES[dtype])
    y_off = pl.layer_norm(tx, ts, tb)
    monkeypatch.setattr(pl, "FUSED_LN_BWD", True)
    before = dict(pfl.LAUNCHES)
    y_on = pl.layer_norm(tx, ts, tb)
    assert torch.equal(y_on, y_off)  # the same forward
    leaves = (tx, ts) + ((tb,) if with_bias else ())
    got = torch.autograd.grad(y_on, leaves, tdy)
    want = pfl.layer_norm_bwd_reference(tx.detach(), tdy, ts.detach())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pfl.LAUNCHES == before  # nothing was launched for CPU tensors
    # and it agrees with autograd of the plain forward
    plain = torch.autograd.grad(y_off, leaves, tdy)
    _assert_close([g.float().numpy() for g in got], [g.float().numpy() for g in plain], dtype)


def test_switch_is_off_by_default():
    assert pl.FUSED_LN_BWD is False
    x = torch.zeros(2, 8, requires_grad=True)
    y = pl.layer_norm(x, torch.ones(8), None)
    assert "LayerNormFusedBwd" not in type(y.grad_fn).__name__


@pytest.mark.parametrize("shape,dtype,ok", [
    ((12800, 768), torch.bfloat16, True),
    ((256, 512), torch.float32, True),
    ((3, 5, 64), torch.float32, True),      # no row or width threshold: the TPU's is layout
    ((8, 4096), torch.bfloat16, True),
    ((8, 4100), torch.float32, False),
    ((8, 6), torch.float32, False),
    ((8, 64), torch.float16, False),
])
def test_supported(shape, dtype, ok):
    assert pfl.supported(torch.empty(shape, dtype=dtype, device="meta")) is ok
