"""The port's window and panel attention against the JAX package's Pallas kernels.

The CUDA kernels (``csrc/window_attention.cu``) run only on the card; their plain
versions, which the CPU wrappers compute and ``chip_smoke.py`` holds the kernels
to, are compared here with ``window_attention`` and ``panel_attention`` of the JAX
package run in interpret mode (``_INTERPRET = True``), forward and VJP, dbias
included: shared and per-window bias, N = 49 and 64, odd head counts, a non-square
map. Inputs from a numpy seed, fp32. Tolerance 1e-5 absolute on values of order 1
(sums over at most 64 terms in another order, and the exponentials). Also: the autograd wrappers on CPU tensors, the dispatch
gates against the JAX gates, and the backward's group split.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

import open_clip_tpu.ops.swin_attention as jswa
import open_clip_tpu.ops.window_attention as jwa

from open_clip_tpu_torch.ops import swin_attention as swa
from open_clip_tpu_torch.ops import window_attention as wa

TOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jwa, "_INTERPRET", True)
    monkeypatch.setattr(jswa, "_INTERPRET", True)


def _inputs(seed, shape, nw, heads, n):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((nw, heads, n, n)).astype(np.float32)
    bias[..., 1::3, ::2] -= 100.0  # shift-mask-like entries
    return q, k, v, bias, do


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=TOL)


T = torch.from_numpy


# (B*nW, N, C, heads, nW): per-window bias with N = 49 and odd heads (Swin-B's
# shifted stages), shared bias (unshifted), N = 64 (HTSAT's windows)
WINDOW_CASES = [(8, 49, 24, 3, 4), (6, 49, 16, 2, 1), (4, 64, 32, 2, 1), (4, 64, 24, 3, 2)]


@pytest.mark.parametrize("b,n,c,heads,nw", WINDOW_CASES)
def test_window_plain_matches_jax_kernel(interpret, b, n, c, heads, nw):
    q, k, v, bias, do = _inputs(b + n + c, (b, n, c), nw, heads, n)
    out, vjp = jax.vjp(lambda *a: jwa.window_attention(*a), q, k, v, bias)
    _close(wa.window_attention_reference(T(q), T(k), T(v), T(bias)), out)
    for got, want in zip(wa.window_attention_bwd_reference(T(q), T(k), T(v), T(bias), T(do)),
                         vjp(do)):
        _close(got, want)


# (B, H, W, C, heads, nW): per-window bias on a non-square map, shared bias with odd
# heads, and HTSAT's last stage (one window, wide)
PANEL_CASES = [(2, 16, 8, 16, 2, 2), (1, 8, 16, 24, 3, 1), (2, 8, 8, 64, 4, 1)]


@pytest.mark.parametrize("b,h,w,c,heads,nw", PANEL_CASES)
def test_panel_plain_matches_jax_kernel(interpret, b, h, w, c, heads, nw):
    q, k, v, bias, do = _inputs(b + h + w + c, (b, h * w, c), nw, heads, 64)
    out, vjp = jax.vjp(lambda *a: jswa.panel_attention(*a, hw=(h, w), ws=8), q, k, v, bias)
    _close(swa.panel_attention_reference(T(q), T(k), T(v), T(bias), hw=(h, w), ws=8), out)
    for got, want in zip(swa.panel_attention_bwd_reference(T(q), T(k), T(v), T(bias), T(do),
                                                           hw=(h, w), ws=8), vjp(do)):
        _close(got, want)


@pytest.mark.parametrize("panel", [False, True], ids=["window", "panel"])
def test_cpu_autograd_is_the_plain_pair(panel):
    """On CPU tensors the differentiable wrappers compute the plain versions, forward
    and backward (dbias included), and launch nothing."""
    if panel:
        q, k, v, bias, do = _inputs(1, (2, 128, 24), 2, 3, 64)
        fwd = lambda *a: swa.panel_attention(*a, hw=(8, 16), ws=8)  # noqa: E731
        ref = lambda *a: swa.panel_attention_bwd_reference(*a, hw=(8, 16), ws=8)  # noqa: E731
    else:
        q, k, v, bias, do = _inputs(2, (8, 49, 24), 4, 3, 49)
        fwd, ref = wa.window_attention, wa.window_attention_bwd_reference
    before = (dict(wa.LAUNCHES), dict(swa.LAUNCHES))
    leaves = [T(x).requires_grad_() for x in (q, k, v, bias)]
    fwd(*leaves).backward(T(do))
    for leaf, want in zip(leaves, ref(*(T(x) for x in (q, k, v, bias, do)))):
        torch.testing.assert_close(leaf.grad, want, rtol=0, atol=0)
    assert (wa.LAUNCHES, swa.LAUNCHES) == before


def test_bf16_plain_rounds_where_the_kernel_does():
    """The plain versions round p and ds to bf16 before their products: in bf16 the
    forward equals the fp32 computation on the rounded probabilities."""
    q, k, v, bias, _ = _inputs(3, (4, 49, 24), 2, 3, 49)
    qb, kb, vb = (T(x).bfloat16() for x in (q, k, v))
    out = wa.window_attention_reference(qb, kb, vb, T(bias))
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float().reshape(4, 49, 3, 8),
                     kb.float().reshape(4, 49, 3, 8)) * 8 ** -0.5
    p = torch.softmax((s.reshape(2, 2, 3, 49, 49) + T(bias)).reshape(4, 3, 49, 49), -1)
    want = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vb.float().reshape(4, 49, 3, 8))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.bfloat16().float().reshape(4, 49, 24))


def test_window_gate_accepts_every_shape_the_jax_gate_accepts():
    for n, heads, c, b, nw in itertools.product((1, 7, 49, 64, 100, 128, 129), (1, 3, 4, 32),
                                                 (24, 96, 768, 1024, 1056), (1, 6, 64, 4096),
                                                 (1, 2, 4, 64)):
        if nw > b:
            continue
        if jwa.supports(n, heads, c, b, nw):
            assert wa.supports(n, heads, c), (n, heads, c, b, nw)
        # the port's gate is the JAX gate less its TPU blocking terms
        assert wa.supports(n, heads, c) == (n <= 128 and c <= 1024 and c % heads == 0)


def test_panel_gate_matches_the_jax_gate():
    for h, w, ws, heads, c, b in itertools.product((8, 16, 56, 64), (8, 24, 64), (7, 8), (1, 3, 4, 32),
                                                   (24, 96, 768, 1024, 2048), (1, 128)):
        assert swa.supports(h, w, ws, heads, c) == jswa.supports(h, w, ws, heads, c, b), \
            (h, w, ws, heads, c, b)


@pytest.mark.parametrize("geom", [
    [128, 64, 64, 4, 24, 64, 8, 64, 8],   # HTSAT stage 0, shifted, train batch
    [128, 64, 64, 4, 24, 1, 8, 64, 8],    # unshifted: every window shares one bias
    [128, 1, 64, 32, 24, 1, 8, 8, 1],     # stage 3
    [3, 1, 49, 2, 8, 1, 0, 0, 1],         # fewer windows than groups would want
    [1000, 4, 49, 16, 32, 4, 0, 0, 1],
])
def test_backward_groups_cover_every_window_once(geom):
    size, groups = wa.bwd_groups(geom)
    s, p, _, heads, _, nwb = geom[:6]
    count = s * p if nwb == 1 else s
    assert size * groups >= count > size * (groups - 1)  # no group is empty
    # enough blocks: at least half the target (equal group sizes round the count down)
    assert 2 * groups * nwb * heads >= min(count * nwb * heads, wa._BWD_TARGET_BLOCKS)


@pytest.mark.parametrize("what", ["meta", "half_on_cpu"])
def test_wrappers_take_the_plain_path_only_on_the_cpu(what):
    """A tensor on another device than the CPU gets the kernel or an error, never the
    plain version; a CPU tensor of any dtype gets the plain version."""
    q, k, v, bias, _ = (T(x) for x in _inputs(4, (4, 49, 24), 2, 3, 49))
    if what == "meta":
        with pytest.raises(ValueError, match="no kernel for device"):
            wa.window_attention(q.to("meta"), k.to("meta"), v.to("meta"), bias.to("meta"))
        with pytest.raises(ValueError, match="no kernel for device"):
            swa.panel_attention(*(x.to("meta") for x in _panel_args()), hw=(8, 8), ws=8)
    else:
        out = wa.window_attention(q.half(), k.half(), v.half(), bias)
        assert out.dtype == torch.float16  # the plain version serves any CPU dtype


def _panel_args():
    q, k, v, bias, _ = _inputs(5, (1, 64, 16), 1, 2, 64)
    return T(q), T(k), T(v), T(bias)


def test_shapes_that_do_not_fit_raise():
    q, k, v, bias = _panel_args()
    with pytest.raises(ValueError):
        swa.panel_attention(q, k, v, bias, hw=(8, 16), ws=8)
    with pytest.raises(ValueError):
        wa.window_attention(q, k, v, bias[:, :, :49, :49])
