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
probability that rounds the other way moves a term by 2**-8).
"""

import numpy as np
import pytest
import torch

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
