"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest.py configures JAX.) The first test builds
the kernels with ``nvcc``. Tolerances: fp32 2e-5 (the kernel and the plain version
sum in other orders); bf16 2e-2 (the probabilities are rounded to bf16 before the
product with v, and the output is rounded to bf16).
"""

import numpy as np
import pytest
import torch

from open_clip_tpu_torch.ops import short_attention as sa

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

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
    before = sa.LAUNCHES
    out = sa.short_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert sa.LAUNCHES == before + 1
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
    before = sa.LAUNCHES
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
        before = sa.LAUNCHES
        model.encode_image(torch.zeros(2, 32, 32, 3, device=cuda))
        assert sa.LAUNCHES == before + 2
        model.encode_text(torch.ones(2, 16, dtype=torch.long, device=cuda))
        assert sa.LAUNCHES == before + 5
