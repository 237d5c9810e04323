"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest.py configures JAX.) The first test builds
the kernels with ``nvcc``. Tolerances, forward: fp32 2e-5 (the kernel and the plain
version sum in other orders); bf16 2e-2 (the probabilities are rounded to bf16
before the product with v, and the output is rounded to bf16). Backward kernels:
relative to the largest entry of the plain result, fp32 1e-4 (sums over up to 288
terms in other orders), bf16 2e-2 (ds, p and the outputs are rounded to bf16: a
probability that rounds the other way moves a term by 2**-8). The flash kernels
sum over up to 1024 keys tile by tile, with a running max: the same tolerances hold.
"""

import numpy as np
import pytest
import torch

from open_clip_tpu_torch.ops import flash_attention as fa
from open_clip_tpu_torch.ops import fused_ln, layers
from open_clip_tpu_torch.ops import short_attention as sa

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (see chip_smoke.py)")
    return torch.device("cuda")


def _fused_qkv(seed, b, l, h, hd, dtype, device):
    """q, k, v as the three views of one (B, L, 3, H, hd) projection, as the towers
    hand them to the kernel."""
    x = np.random.default_rng(seed).standard_normal((b, l, 3, h, hd), dtype=np.float32)
    return torch.from_numpy(x).to(device, dtype).unbind(2)


def _check(q, k, v, causal):
    before = dict(sa.LAUNCHES)
    out = sa.short_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert sa.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"]}
    ref = sa.short_attention_reference(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[q.dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,h,hd,causal", [
    (8, 50, 12, 64, False),   # ViT-B-32 image tower
    (8, 77, 8, 64, True),     # CLIP text tower
    (3, 17, 2, 32, False),
    (2, 60, 4, 128, True),
    (2, 288, 2, 128, True),   # longest sequence, widest head: the most shared memory
    (1, 1, 1, 64, False),
])
def test_kernel_matches_plain(cuda, b, l, h, hd, causal, dtype):
    _check(*_fused_qkv(l + h, b, l, h, hd, dtype, cuda), causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_keeps_a_max_per_head(cuda, dtype):
    """Head 0's logits ~100 below head 1's: a max shared across heads gives NaN."""
    q, k, v = (x.float().clone() for x in _fused_qkv(0, 4, 50, 2, 64, torch.float32, cuda))
    q[:, :, 0] = 1.0 + 0.1 * q[:, :, 0]
    k[:, :, 0] = -100.0 / (64 * 64 ** -0.5) + 0.01 * k[:, :, 0]
    _check(q.to(dtype), k.to(dtype), v.to(dtype), False)


def test_kernel_takes_contiguous_inputs(cuda):
    q, k, v = (x.contiguous() for x in _fused_qkv(1, 2, 50, 4, 64, torch.bfloat16, cuda))
    _check(q, k, v, False)


@pytest.mark.parametrize("what", ["fp16", "transposed", "too_long", "hd48", "cross"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda, what):
    q, k, v = _fused_qkv(2, 2, 50, 4, 64, torch.float32, cuda)
    if what == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif what == "transposed":  # (B, H, L, hd) data seen as (B, L, H, hd)
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "too_long":
        q = k = v = torch.zeros(1, 289, 2, 64, device=cuda)
    elif what == "hd48":
        q = k = v = torch.zeros(1, 50, 2, 48, device=cuda)
    else:
        k = v = torch.zeros(2, 40, 4, 64, device=cuda)
    before = dict(sa.LAUNCHES)
    with pytest.raises((ValueError, RuntimeError)):
        sa.short_attention(q, k, v)
    assert sa.LAUNCHES == before


def test_model_path_launches_once_per_layer(cuda):
    import open_clip_tpu_torch as oc
    from open_clip_tpu_torch.models.clip import CLIPModel

    cfg = oc.CLIPModelCfg.from_dict({
        "embed_dim": 64,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 128, "patch_size": 16},
        "text_cfg": {"context_length": 16, "width": 128, "heads": 2, "layers": 3}})
    model = CLIPModel(cfg, compute_dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    with torch.inference_mode():
        before = sa.LAUNCHES["fwd"]
        model.encode_image(torch.zeros(2, 32, 32, 3, device=cuda))
        assert sa.LAUNCHES["fwd"] == before + 2
        model.encode_text(torch.ones(2, 16, dtype=torch.long, device=cuda))
        assert sa.LAUNCHES["fwd"] == before + 5


def _rel_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _check_bwd(q, k, v, causal):
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(tuple(q.shape), dtype=np.float32))
    do = do.to(q.device, q.dtype)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    before = dict(sa.LAUNCHES)
    out = sa.short_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert sa.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    refs = sa.short_attention_bwd_reference(q.detach(), k.detach(), v.detach(), do, causal=causal)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == q.dtype and got.shape == q.shape
        assert bool(torch.isfinite(got).all()), name
        err = _rel_err(got, ref)
        assert err <= BWD_RTOL[q.dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,h,hd,causal", [
    (8, 50, 12, 64, False),   # ViT-B-32 image tower
    (8, 77, 8, 64, True),     # CLIP text tower
    (3, 17, 2, 32, False),
    (2, 60, 4, 128, True),
    (2, 288, 2, 128, True),   # longest sequence, widest head: the most shared memory
    (2, 288, 2, 128, False),
    (2, 197, 3, 64, False),
    (1, 1, 1, 64, False),
])
def test_backward_kernel_matches_plain(cuda, b, l, h, hd, causal, dtype):
    _check_bwd(*_fused_qkv(l + h, b, l, h, hd, dtype, cuda), causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_backward_kernel_keeps_a_max_per_head(cuda, dtype):
    q, k, v = (x.float().clone() for x in _fused_qkv(0, 4, 50, 2, 64, torch.float32, cuda))
    q[:, :, 0] = 1.0 + 0.1 * q[:, :, 0]
    k[:, :, 0] = -100.0 / (64 * 64 ** -0.5) + 0.01 * k[:, :, 0]
    _check_bwd(q.to(dtype), k.to(dtype), v.to(dtype), False)


def test_backward_kernel_is_deterministic(cuda):
    q, k, v = (x.detach().requires_grad_() for x in _fused_qkv(3, 4, 77, 8, 64, torch.bfloat16, cuda))
    do = torch.ones_like(q)
    runs = [torch.autograd.grad(sa.short_attention(q, k, v, causal=True), (q, k, v), do)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_backward_kernel_runs_under_checkpoint(cuda):
    from torch.utils.checkpoint import checkpoint

    q, k, v = (x.detach().requires_grad_() for x in _fused_qkv(4, 2, 50, 4, 64, torch.float32, cuda))
    before = dict(sa.LAUNCHES)
    out = checkpoint(lambda a, b, c: sa.short_attention(a, b, c) * 2.0, q, k, v, use_reentrant=False)
    out.sum().backward()
    # the forward runs twice (once recomputed), the backward once
    assert sa.LAUNCHES == {"fwd": before["fwd"] + 2, "bwd": before["bwd"] + 1}
    ref = sa.short_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                           torch.full_like(q, 2.0))
    assert _rel_err(q.grad, ref[0]) <= BWD_RTOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", [(256, 50, 768), (256, 77, 512), (256, 768), (3, 5, 64),
                                   (7, 1280), (2, 4096), (1, 4)])
def test_layer_norm_backward_kernel_matches_plain(cuda, monkeypatch, shape, with_bias, dtype):
    rng = np.random.default_rng(sum(shape))
    w = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 2 + 0.5).to(cuda, dtype)
    dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    scale = torch.from_numpy(rng.standard_normal(w, dtype=np.float32)).to(cuda).requires_grad_()
    bias = torch.zeros(w, device=cuda).requires_grad_() if with_bias else None
    x.requires_grad_()
    monkeypatch.setattr(layers, "FUSED_LN_BWD", True)
    before = fused_ln.LAUNCHES["bwd"]
    y = layers.layer_norm(x, scale, bias, 1e-5)
    assert torch.equal(y, layers.layer_norm_plain(x.detach(), scale.detach(), bias, 1e-5))
    grads = torch.autograd.grad(y, (x, scale) + ((bias,) if with_bias else ()), dy)
    torch.cuda.synchronize()
    assert fused_ln.LAUNCHES["bwd"] == before + 1
    refs = fused_ln.layer_norm_bwd_reference(x.detach(), dy, scale.detach(), 1e-5)
    for name, got, ref in zip(("dx", "dscale", "dbias"), grads, refs):
        assert got.shape == ref.shape and bool(torch.isfinite(got).all()), name
        # dx is rounded to bf16 once; the fp32 sums differ by their order only
        tol = 1e-2 if (dtype == torch.bfloat16 and name == "dx") else 1e-4
        assert _rel_err(got, ref) <= tol, (name, _rel_err(got, ref))


def test_layer_norm_backward_kernel_is_deterministic(cuda):
    x = torch.randn(12800, 768, device=cuda, dtype=torch.bfloat16)
    dy = torch.randn_like(x)
    scale = torch.randn(768, device=cuda)
    a = fused_ln.layer_norm_bwd(x, dy, scale)
    b = fused_ln.layer_norm_bwd(x, dy, scale)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


@pytest.mark.parametrize("what", ["fp16", "width_6", "too_wide", "dy_dtype"])
def test_layer_norm_backward_raises_on_what_the_kernel_does_not_take(cuda, what):
    x = torch.zeros(8, 64, device=cuda)
    dy, scale = torch.zeros_like(x), torch.ones(64, device=cuda)
    if what == "fp16":
        x, dy = x.half(), dy.half()
    elif what == "width_6":
        x, dy, scale = x[:, :6].contiguous(), dy[:, :6].contiguous(), scale[:6]
    elif what == "too_wide":
        x = dy = torch.zeros(2, 4100, device=cuda)
        scale = torch.ones(4100, device=cuda)
    else:
        dy = dy.bfloat16()
    before = fused_ln.LAUNCHES["bwd"]
    with pytest.raises(ValueError):
        fused_ln.layer_norm_bwd(x, dy, scale)
    assert fused_ln.LAUNCHES["bwd"] == before


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_launches_each_kernel_once_per_layer(cuda, monkeypatch, remat):
    import open_clip_tpu_torch as oc
    from open_clip_tpu_torch.models.clip import CLIPModel

    cfg = oc.CLIPModelCfg.from_dict({
        "embed_dim": 64,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 128, "patch_size": 16},
        "text_cfg": {"context_length": 16, "width": 128, "heads": 2, "layers": 3}})
    model = CLIPModel(cfg, compute_dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda)
    optimizer = oc.create_optimizer(oc.OptimizerCfg(grad_clip_norm=1.0), model, oc.const_lr(1e-3, 0))
    state = oc.create_train_state(model, optimizer)
    step = oc.make_train_step(cfg, optimizer, remat=remat)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal((4, 32, 32, 3), dtype=np.float32)).to(cuda),
             "text": torch.from_numpy(rng.integers(1, 1000, (4, 16))).to(cuda)}
    monkeypatch.setattr(layers, "FUSED_LN_BWD", True)
    sa_before, ln_before = dict(sa.LAUNCHES), fused_ln.LAUNCHES["bwd"]
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    # 2 vision + 3 text layers; with remat every block's forward runs twice
    assert sa.LAUNCHES["fwd"] - sa_before["fwd"] == (10 if remat else 5)
    assert sa.LAUNCHES["bwd"] - sa_before["bwd"] == 5
    # ln_pre, ln_post, ln_final and two per block
    assert fused_ln.LAUNCHES["bwd"] - ln_before == 3 + 2 * 5


# ---------------------------------------------------------------------------
# flash attention: forward (out, lse), dq, dk/dv
# ---------------------------------------------------------------------------

def _ragged_valid(b, l, device):
    """Rows valid to l, 3l/4, l/2 + 1, ... in turn; never an empty row."""
    lens = [max(1, l - (i % 4) * (l // 4) + (i % 4 > 1)) for i in range(b)]
    return torch.arange(l, device=device)[None, :] < torch.tensor(lens, device=device)[:, None]


FLASH_CASES = [
    # b, l, h, hd, causal, prefix_len, masked
    (4, 1024, 12, 64, False, 0, True),    # the NaFlex train bucket
    (4, 576, 12, 64, False, 0, True),     # the NaFlex eval bucket
    (2, 577, 12, 64, False, 0, False),    # no multiple of any tile
    (2, 640, 4, 64, True, 0, False),
    (2, 1024, 4, 64, True, 256, False),   # prefix-LM
    (2, 700, 2, 64, True, 100, True),     # every mask at once, ragged prefix
    (2, 512, 8, 128, False, 0, True),
    (2, 530, 2, 128, True, 0, False),
    (1, 1, 1, 64, False, 0, False),
    (3, 65, 2, 64, True, 0, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,h,hd,causal,prefix_len,masked", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, b, l, h, hd, causal, prefix_len, masked, dtype):
    q, k, v = (x.detach().requires_grad_() for x in _fused_qkv(l + h, b, l, h, hd, dtype, cuda))
    valid = _ragged_valid(b, l, cuda) if masked else None
    do = torch.from_numpy(np.random.default_rng(7).standard_normal((b, l, h, hd), dtype=np.float32))
    do = do.to(cuda, dtype)
    kw = dict(causal=causal, key_valid=valid, prefix_len=prefix_len)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {key: n + 1 for key, n in before.items()}
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    ref, ref_lse = fa.flash_attention_reference(qd, kd, vd, **kw)
    out2, lse = fa.flash_attention_fwd(qd, kd, vd, **kw)
    assert torch.equal(out2, out.detach())
    assert out.dtype == dtype and out.shape == q.shape and bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert lse.shape == (b, h, l) and (lse - ref_lse).abs().max().item() <= 1e-4
    refs = fa.flash_attention_bwd_reference(qd, kd, vd, ref, ref_lse, do, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dtype and got.shape == q.shape
        assert bool(torch.isfinite(got).all()), name
        # relative to the plain result's largest entry, or to 1e-3 where that is ~0
        # (L = 1: the plain dq and dk are exactly 0, the kernel's ~1e-7)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_RTOL[dtype] * max(want.float().abs().max().item(), 1e-3), (name, err)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_row_without_a_visible_key_is_zero(cuda, causal):
    """Sample 1 has no valid key: zero output, finite lse, zero gradients, as the
    plain version; sample 0 is untouched by it."""
    q, k, v = (x.detach().requires_grad_() for x in _fused_qkv(5, 2, 130, 2, 64, torch.float32, cuda))
    valid = torch.ones(2, 130, dtype=torch.bool, device=cuda)
    valid[1] = False
    out = fa.flash_attention(q, k, v, causal=causal, key_valid=valid)
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    ref, _ = fa.flash_attention_reference(q.detach(), k.detach(), v.detach(), causal=causal,
                                          key_valid=valid)
    assert bool((out[1] == 0).all()) and bool((ref[1] == 0).all())
    assert (out[0] - ref[0]).abs().max().item() <= TOL[torch.float32]
    for g in grads:
        assert bool(torch.isfinite(g).all()) and bool((g[1] == 0).all())


def test_flash_backward_is_deterministic(cuda):
    q, k, v = (x.detach().requires_grad_() for x in _fused_qkv(3, 2, 600, 4, 64, torch.bfloat16, cuda))
    valid = _ragged_valid(2, 600, cuda)
    runs = [torch.autograd.grad(fa.flash_attention(q, k, v, key_valid=valid), (q, k, v),
                                torch.ones_like(q)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["fp16", "transposed", "hd32", "cross", "prefix_without_causal",
                                  "mask_shape"])
def test_flash_wrapper_raises_on_what_the_kernels_do_not_take(cuda, what):
    q, k, v = _fused_qkv(2, 2, 520, 4, 64, torch.float32, cuda)
    kw = {}
    if what == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif what == "transposed":  # (B, H, L, hd) data seen as (B, L, H, hd)
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "hd32":
        q = k = v = torch.zeros(1, 520, 2, 32, device=cuda)
    elif what == "cross":
        k = v = torch.zeros(2, 512, 4, 64, device=cuda)
    elif what == "prefix_without_causal":
        kw = {"prefix_len": 8}
    else:
        kw = {"key_valid": torch.ones(2, 519, dtype=torch.bool, device=cuda)}
    before = dict(fa.LAUNCHES)
    with pytest.raises((ValueError, RuntimeError)):
        fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES == before


def test_dispatch_sends_long_masked_attention_to_flash(cuda):
    from open_clip_tpu_torch.ops.attention import dot_product_attention

    q, k, v = _fused_qkv(9, 2, 576, 4, 64, torch.bfloat16, cuda)
    valid = _ragged_valid(2, 576, cuda)
    before = dict(fa.LAUNCHES)
    out = dot_product_attention(q, k, v, key_valid=valid)
    assert fa.LAUNCHES["fwd"] == before["fwd"] + 1
    ref, _ = fa.flash_attention_reference(q, k, v, key_valid=valid)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# window and panel attention (csrc/window_attention.cu): forward, and backward with
# dbias, against the plain versions. Tolerances as for the short kernels; dbias
# sums ds over up to B*nW windows in fp32, so its relative tolerance is fp32's.
# ---------------------------------------------------------------------------

def _window_inputs(seed, shape, c, nw, heads, n, dtype, device):
    """q, k, v as views of one fused (..., 3C) projection, an fp32 bias with shift-mask
    entries, and do."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((*shape, 3 * c), dtype=np.float32)).to(device, dtype)
    q, k, v = x.unflatten(-1, (3, c)).unbind(-2)
    bias = rng.standard_normal((nw, heads, n, n), dtype=np.float32)
    bias[..., 1::4, ::3] -= 100.0
    do = torch.from_numpy(rng.standard_normal((*shape, c), dtype=np.float32)).to(device, dtype)
    return q, k, v, torch.from_numpy(bias).to(device), do


def _check_window_pair(got_out, ref_out, got_grads, ref_grads, dtype):
    torch.cuda.synchronize()
    assert got_out.dtype == dtype and bool(torch.isfinite(got_out).all())
    assert (got_out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got_grads, ref_grads):
        assert bool(torch.isfinite(g).all()), name
        tol = BWD_RTOL[torch.float32] if name == "dbias" and dtype == torch.float32 else BWD_RTOL[dtype]
        assert _rel_err(g, r) <= tol, (name, _rel_err(g, r))


WINDOW_KERNEL_CASES = [  # (B*nW, N, C, heads, nW)
    (4 * 64, 49, 128, 4, 64),   # Swin-B stage 0, shifted
    (4 * 64, 49, 128, 4, 1),    # Swin-B stage 0, unshifted
    (4 * 4, 49, 512, 16, 4),    # Swin-B stage 2, shifted
    (4, 49, 1024, 32, 1),       # Swin-B stage 3: one window, 32 heads
    (8 * 64, 64, 96, 4, 64),    # HTSAT stage 0 windows, partitioned
    (6, 9, 24, 3, 2),           # tiny windows, odd heads
    (5, 100, 64, 2, 1),         # N between 64 and 128
    (2, 128, 256, 8, 2),        # the largest window
    (3, 33, 40, 5, 1),          # N just past a tile, odd heads, hd 8
    (2, 16, 1024, 1, 1),        # one head of 1024 columns
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c,heads,nw", WINDOW_KERNEL_CASES)
def test_window_kernels_match_plain(cuda, b, n, c, heads, nw, dtype):
    from open_clip_tpu_torch.ops import window_attention as wa

    q, k, v, bias, do = _window_inputs(b + n + c, (b, n), c, nw, heads, n, dtype, cuda)
    before = dict(wa.LAUNCHES)
    out = wa.window_attention_fwd(q, k, v, bias)
    grads = wa.window_attention_bwd(q, k, v, bias, do)
    assert wa.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    _check_window_pair(out, wa.window_attention_reference(q, k, v, bias), grads,
                       wa.window_attention_bwd_reference(q, k, v, bias, do), dtype)


PANEL_KERNEL_CASES = [  # (B, H, W, C, heads, nW)
    (2, 64, 64, 96, 4, 64),     # HTSAT-tiny stage 0, shifted
    (2, 64, 64, 96, 4, 1),      # stage 0, unshifted
    (2, 32, 32, 192, 8, 16),    # stage 1, shifted
    (2, 16, 16, 384, 16, 4),    # stage 2, shifted
    (16, 8, 8, 768, 32, 1),     # stage 3: one window a sample
    (3, 16, 40, 48, 3, 10),     # a non-square map, odd heads
    (2, 24, 8, 40, 5, 1),       # a tall map, hd 8
    (1, 8, 8, 1024, 1, 1),      # one head of 1024 columns
    (4, 8, 16, 64, 2, 2),
    (1, 64, 8, 72, 3, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w,c,heads,nw", PANEL_KERNEL_CASES)
def test_panel_kernels_match_plain(cuda, b, h, w, c, heads, nw, dtype):
    from open_clip_tpu_torch.ops import swin_attention as swa

    q, k, v, bias, do = _window_inputs(b + h + w + c, (b, h * w), c, nw, heads, 64, dtype, cuda)
    kw = dict(hw=(h, w), ws=8)
    before = dict(swa.LAUNCHES)
    out = swa.panel_attention_fwd(q, k, v, bias, **kw)
    grads = swa.panel_attention_bwd(q, k, v, bias, do, **kw)
    assert swa.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    _check_window_pair(out, swa.panel_attention_reference(q, k, v, bias, **kw), grads,
                       swa.panel_attention_bwd_reference(q, k, v, bias, do, **kw), dtype)


def test_window_backward_is_deterministic(cuda):
    """dbias folds fixed groups' partials in a fixed order: the same bits every run."""
    from open_clip_tpu_torch.ops import swin_attention as swa

    q, k, v, bias, do = _window_inputs(3, (8, 4096), 96, 1, 4, 64, torch.bfloat16, cuda)
    runs = [swa.panel_attention_bwd(q, k, v, bias, do, hw=(64, 64), ws=8) for _ in range(3)]
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.parametrize("what", ["fp16", "panel_ws7", "wide", "columns"])
def test_window_wrappers_raise_on_what_the_kernels_do_not_take(cuda, what):
    from open_clip_tpu_torch.ops import swin_attention as swa
    from open_clip_tpu_torch.ops import window_attention as wa

    q, k, v, bias, do = _window_inputs(4, (2, 64), 64, 1, 2, 64, torch.bfloat16, cuda)
    before = (dict(wa.LAUNCHES), dict(swa.LAUNCHES))
    with pytest.raises(ValueError):
        if what == "fp16":
            wa.window_attention(q.half(), k.half(), v.half(), bias)
        elif what == "panel_ws7":
            swa.panel_attention(q.reshape(1, 128, 64)[:, :49], k.reshape(1, 128, 64)[:, :49],
                                v.reshape(1, 128, 64)[:, :49], bias[:, :, :49, :49], hw=(7, 7), ws=7)
        elif what == "wide":
            x = torch.zeros(2, 4, 2048, device=cuda)
            wa.window_attention(x, x, x, torch.zeros(1, 2, 4, 4, device=cuda))
        else:
            t = q.transpose(1, 2).contiguous().transpose(1, 2)  # columns not dense
            wa.window_attention_fwd(t, k, v, bias)
    assert (wa.LAUNCHES, swa.LAUNCHES) == before


def test_clap_and_swin_paths_launch_the_kernels(cuda):
    """A HTSAT block on a 64x64 map takes the panel kernel, a Swin block on 7x7
    windows the window kernel, forward and backward."""
    from open_clip_tpu_torch.models.htsat import SwinBlock
    from open_clip_tpu_torch.ops import swin_attention as swa
    from open_clip_tpu_torch.ops import window_attention as wa

    gen = torch.Generator().manual_seed(0)
    for block, hw, ws, shift, mod in ((SwinBlock(96, 4, 8), (64, 64), 8, 4, swa),
                                      (SwinBlock(128, 4, 7), (56, 56), 7, 3, wa)):
        block.init_weights(gen)
        block = block.to(cuda)
        x = torch.randn(2, hw[0] * hw[1], block.norm1.weight.shape[0], device=cuda,
                        dtype=torch.bfloat16, requires_grad=True)
        before = dict(mod.LAUNCHES)
        block(x, hw, ws, shift).float().square().mean().backward()
        torch.cuda.synchronize()
        assert mod.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
        assert bool(torch.isfinite(x.grad).all())
        assert block.attn.relative_position_bias_table.grad.abs().sum() > 0
