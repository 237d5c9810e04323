"""Flash attention in the PyTorch port against the JAX package.

The port's plain versions (what ``flash_attention`` computes for CPU tensors) are
held against the JAX Pallas kernels, run in interpret mode as
``tests/test_flash_attention.py`` runs them off-TPU: the output, and dq, dk, dv
through ``jax.vjp`` against the port's autograd. Inputs come from a numpy seed and
go through both frameworks. Only queries that see at least one key are compared:
for a query that sees none the two differ by design (the port gives zeros).

Tolerances: fp32 <= 2e-5 (two fp32 softmaxes over up to 320 keys, summed tile by
tile in one and densely in the other); bf16 <= 3e-2 on the output and 6e-2
relative to the largest entry on the gradients (the probabilities and ds are
rounded to bf16, 2**-8 relative, at other places in the two: the JAX kernel rounds
the unnormalised probabilities, the plain version the normalised ones).

The CUDA kernels themselves run only on the card: ``test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_clip_tpu.ops.flash_attention as jfa
from open_clip_tpu_torch.ops import attention as pattn
from open_clip_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUT_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_RTOL = {"float32": 2e-5, "bfloat16": 6e-2}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _inputs(seed, b, l, h, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, hd)).astype(np.float32) for _ in range(4)]


def _valid(b, l):
    """Sample i is valid up to l - i * l // 4 keys: ragged, never empty."""
    lens = np.array([l - (i % 3) * (l // 4) for i in range(b)])
    return np.arange(l)[None, :] < lens[:, None]


MASKS = {
    "full": dict(causal=False, prefix_len=0, masked=False),
    "causal": dict(causal=True, prefix_len=0, masked=False),
    "key_valid": dict(causal=False, prefix_len=0, masked=True),
    "prefix": dict(causal=True, prefix_len=40, masked=False),
    "causal_key_valid": dict(causal=True, prefix_len=0, masked=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("l", [128, 160, 320])
def test_plain_matches_jax_kernels(interpret, l, mask, dtype):
    causal, prefix_len, masked = (MASKS[mask][k] for k in ("causal", "prefix_len", "masked"))
    b, h, hd = 2, 2, 64
    q, k, v, do = _inputs(l + len(mask), b, l, h, hd)
    valid = _valid(b, l) if masked else None

    jq, jk, jv, jdo = (jnp.asarray(x, JAX_DTYPES[dtype]) for x in (q, k, v, do))
    want, vjp = jax.vjp(
        lambda a, b_, c: jfa.flash_attention(
            a, b_, c, causal=causal, prefix_len=prefix_len,
            key_valid=None if valid is None else jnp.asarray(valid)), jq, jk, jv)
    want_grads = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(x).to(TORCH_DTYPES[dtype]).requires_grad_() for x in (q, k, v))
    tvalid = None if valid is None else torch.from_numpy(valid)
    before = dict(pfa.LAUNCHES)
    out = pfa.flash_attention(tq, tk, tv, causal=causal, prefix_len=prefix_len, key_valid=tvalid)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).to(TORCH_DTYPES[dtype]))
    assert pfa.LAUNCHES == before  # a CPU call is the plain version, not a launch
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (b, l, h, hd)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0, atol=OUT_TOL[dtype])
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want_grads):
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= GRAD_RTOL[dtype] * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("mask", list(MASKS))
def test_bwd_reference_matches_autograd_of_the_forward_reference(mask):
    """The step-by-step backward against autograd through the dense forward, fp32:
    1e-5 relative to the largest entry (the same sums in another order)."""
    causal, prefix_len, masked = (MASKS[mask][k] for k in ("causal", "prefix_len", "masked"))
    b, l, h, hd = 2, 96, 2, 64
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(11, b, l, h, hd))
    valid = torch.from_numpy(_valid(b, l)) if masked else None
    kw = dict(causal=causal, prefix_len=prefix_len, key_valid=valid)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out, lse = pfa.flash_attention_reference(q, k, v, **kw)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = pfa.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), out.detach(),
                                            lse.detach(), do, **kw)
    assert lse.shape == (b, h, l) and lse.dtype == torch.float32
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item(), name


def test_forward_reference_matches_dense_attention():
    """Where every query sees a key, the forward reference is the dense path with the
    mask folded into a bias (what the CPU towers run): 1e-6."""
    b, l, h, hd = 2, 70, 2, 64
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(12, b, l, h, hd))
    valid = torch.from_numpy(_valid(b, l))
    for causal in (False, True):
        out, lse = pfa.flash_attention_reference(q, k, v, causal=causal, key_valid=valid)
        want = pattn.dot_product_attention(q, k, v, causal=causal, key_valid=valid)
        assert (out - want).abs().max().item() <= 1e-6
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        vis = pfa._visible(l, causal, 0, valid, "cpu")
        assert torch.allclose(lse, s.masked_fill(~vis, float("-inf")).logsumexp(-1), atol=1e-5)


def test_query_without_a_visible_key_gives_zeros():
    b, l, h, hd = 2, 33, 1, 64
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(13, b, l, h, hd))
    valid = torch.ones(b, l, dtype=torch.bool)
    valid[1] = False
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = pfa.flash_attention(q, k, v, key_valid=valid)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert bool((out[1] == 0).all()) and bool(torch.isfinite(out).all())
    assert all(bool(torch.isfinite(g).all()) and bool((g[1] == 0).all()) for g in grads)


@pytest.mark.parametrize("kw", [dict(prefix_len=4), dict(prefix_len=-1, causal=True)])
def test_prefix_needs_the_causal_mask(kw):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(14, 1, 8, 1, 64))
    with pytest.raises(ValueError, match="prefix_len"):
        pfa.flash_attention(q, k, v, **kw)


def test_self_attention_only():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(15, 1, 8, 1, 64))
    with pytest.raises(ValueError, match="self-attention"):
        pfa.flash_attention(q, k[:, :4], v[:, :4])


def test_float_key_valid_reads_as_positive():
    """The JAX kernel takes the mask as floats and tests ``> 0``."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(16, 2, 20, 1, 64))
    valid = torch.from_numpy(_valid(2, 20))
    a = pfa.flash_attention(q, k, v, key_valid=valid)
    b = pfa.flash_attention(q, k, v, key_valid=valid.float() * 0.5)
    assert torch.equal(a, b)


@pytest.mark.parametrize("l,h,hd,bias,ok", [
    (1024, 12, 64, None, True),
    (1, 1, 128, None, True),
    (576, 12, 64, "bias", False),
    (576, 12, 32, None, False),
    (576, 12, 192, None, False),
])
def test_supports(l, h, hd, bias, ok):
    assert pfa.supports(l, h, hd, bias) is ok


# the whole dispatch table of ops/attention.py:select_impl
@pytest.mark.parametrize("on_cuda,lq,lk,hd,bias,key_valid,expect", [
    (True, 1024, 1024, 64, None, "mask", "flash"),    # the NaFlex train bucket
    (True, 576, 576, 64, None, "mask", "flash"),      # the NaFlex eval bucket
    (True, 512, 512, 128, None, "mask", "flash"),
    (True, 577, 577, 64, None, None, "flash"),        # a plain ViT at 384 px, patch 16
    (True, 4096, 4096, 64, None, None, "flash"),
    (True, 511, 511, 64, None, "mask", "dense"),      # below the flash length, masked
    (True, 256, 256, 64, None, "mask", "dense"),      # the short kernel takes no mask
    (True, 256, 256, 64, None, None, "short"),
    (True, 288, 288, 128, None, None, "short"),
    (True, 400, 400, 64, None, None, "dense"),        # between the two kernels
    (True, 1024, 1024, 64, "bias", "mask", "dense"),
    (True, 1024, 1024, 64, "bias", None, "dense"),
    (True, 1024, 1024, 48, None, "mask", "dense"),
    (True, 1024, 1024, 256, None, None, "dense"),     # a head width the kernels lack
    (True, 1, 1024, 64, None, "mask", "dense"),       # cross-attention (the map pool)
    (False, 1024, 1024, 64, None, "mask", "dense"),   # the CPU
    (False, 1024, 1024, 64, None, None, "dense"),
])
def test_dispatch_table(on_cuda, lq, lk, hd, bias, key_valid, expect):
    assert pattn.select_impl(on_cuda, lq, lk, 4, hd, bias, key_valid) == expect


def test_multi_head_attention_takes_key_valid():
    """Padding must not change the valid rows: (B, L) with a mask against (B, L')."""
    rng = np.random.default_rng(17)
    d, heads = 128, 2
    x = torch.from_numpy(rng.standard_normal((2, 12, d)).astype(np.float32))
    w_in = torch.from_numpy(rng.standard_normal((3 * d, d)).astype(np.float32)) * d ** -0.5
    w_out = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32)) * d ** -0.5
    b_in, b_out = torch.zeros(3 * d), torch.zeros(d)
    valid = torch.arange(12)[None, :] < torch.tensor([[8], [8]])
    padded = pattn.multi_head_attention(x, w_in, b_in, w_out, b_out, num_heads=heads,
                                        key_valid=valid)
    short = pattn.multi_head_attention(x[:, :8], w_in, b_in, w_out, b_out, num_heads=heads)
    assert (padded[:, :8] - short).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
@pytest.mark.parametrize("hd", [64, 128])
def test_forward_body(hd, dtype, body):
    """bf16 takes the wgmma forward (TMA, skipped invalid key tiles) at every L and
    mask; fp32 keeps the CUDA-core one."""
    assert pfa.fwd_body(hd, dtype) == body


def _fused_views(b, l, h, hd, dtype, pad=0, offset=0):
    """q, k, v as the views of one fused (B, L, 3*H*hd + pad) projection, starting
    ``offset`` elements into its storage: the layout NaFlex's tower hands over."""
    width = 3 * h * hd + pad
    flat = torch.zeros(offset + b * l * width, dtype=dtype)[offset:]
    return flat.view(b, l, width)[..., :3 * h * hd].unflatten(-1, (3, h, hd)).unbind(2)


@pytest.mark.parametrize("l,h,hd", [(1024, 12, 64), (576, 12, 64), (577, 2, 128)])
def test_fused_views_fit_the_tensor_maps(l, h, hd):
    """NaFlex's q, k, v: a row stride of 3*768 bf16 (4608 bytes), 16-byte aligned."""
    q, k, v = _fused_views(2, l, h, hd, torch.bfloat16)
    assert q.stride(1) * 2 % 16 == 0
    pfa.check_inputs((q, k, v), ("q", "k", "v"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("what", ["row_stride", "pointer", "batch_stride"])
def test_misaligned_views_raise(what, dtype):
    """A row that starts off a 16-byte boundary cannot be read by TMA (nor 16 bytes
    at a time by the other kernels): the check raises, on any device."""
    off = 8 // torch.tensor([], dtype=dtype).element_size()  # 8 bytes
    if what == "row_stride":  # rows of 3*H*hd elements and 8 bytes
        q, k, v = _fused_views(2, 520, 2, 64, dtype, pad=off)
    elif what == "pointer":  # the storage starts 8 bytes past a 16-byte boundary
        q, k, v = _fused_views(2, 520, 2, 64, dtype, offset=off)
    else:  # 8 bytes more than whole rows between samples
        flat = torch.zeros(2 * 521 * 384, dtype=dtype)
        qkv = flat.as_strided((2, 520, 3, 2, 64), (520 * 384 + off, 384, 128, 64, 1))
        q, k, v = qkv.unbind(2)
    with pytest.raises(ValueError, match="aligned"):
        pfa.check_inputs((q, k, v), ("q", "k", "v"))


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
@pytest.mark.parametrize("hd", [64, 128])
def test_backward_body(hd, dtype, body):
    """bf16 takes the wgmma dq and dk/dv at both head widths; fp32 keeps the CUDA-core
    ones."""
    assert pfa.bwd_body(hd, dtype) == body


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keys_without_a_valid_entry_get_zero_dk_dv(interpret, dtype):
    """Sample 1 is valid only to key 64, so every 64- and 128-key tile past it holds
    no valid key: dk and dv of those keys are exactly 0, in the JAX kernels and in the
    port's plain backward alike. The wgmma dk/dv kernel writes zeros for such a tile
    without loading or multiplying anything, which relies on this."""
    b, l, h, hd = 2, 320, 2, 64
    q, k, v, do = _inputs(21, b, l, h, hd)
    valid = np.ones((b, l), dtype=bool)
    valid[1, 64:] = False

    jq, jk, jv, jdo = (jnp.asarray(x, JAX_DTYPES[dtype]) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention(a, b_, c, key_valid=jnp.asarray(valid)),
                     jq, jk, jv)
    _, jdk, jdv = (np.asarray(g.astype(jnp.float32)) for g in vjp(jdo))

    tq, tk, tv = (torch.from_numpy(x).to(TORCH_DTYPES[dtype]).requires_grad_() for x in (q, k, v))
    out = pfa.flash_attention(tq, tk, tv, key_valid=torch.from_numpy(valid))
    tdo = torch.from_numpy(do).to(TORCH_DTYPES[dtype])
    _, tdk, tdv = torch.autograd.grad(out, (tq, tk, tv), tdo)

    for g in (jdk, jdv, tdk.float().numpy(), tdv.float().numpy()):
        assert (g[1, 64:] == 0).all()
        assert np.abs(g[1, :64]).max() > 0 and np.abs(g[0]).max() > 0  # the valid keys are not


def test_backward_inputs_fit_the_tensor_maps():
    """NaFlex's fused q, k, v views with the dense out and do of the backward: every
    row 16-byte aligned, as the dq kernel's tensor maps (q, k, v, do and out) and the
    dk/dv kernel's read them. An out that starts 8 bytes off a 16-byte boundary raises."""
    b, l, h, hd = 2, 1024, 12, 64
    q, k, v = _fused_views(b, l, h, hd, torch.bfloat16)
    out, do = (torch.zeros(b, l, h, hd, dtype=torch.bfloat16) for _ in range(2))
    names = ("q", "k", "v", "out", "do")
    pfa.check_inputs((q, k, v, out, do), names)
    shifted = torch.zeros(b * l * h * hd + 4, dtype=torch.bfloat16)[4:].view(b, l, h, hd)
    with pytest.raises(ValueError, match="out must have a dense, 16-byte aligned"):
        pfa.check_inputs((q, k, v, shifted, do), names)
