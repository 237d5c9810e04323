"""Which body the port's attention kernels take, and what each refuses.

The short-attention forward and backward and the window/panel-attention forward
and backward have two bodies each on the card: "mma", a bf16 kernel on the tensor
cores, and "simt", the CUDA-core kernel that also serves fp32. The choice is a pure
function of the mode, the dtype and the shape (``short_attention.fwd_body`` and
``bwd_body``, ``window_attention.fwd_body`` and ``bwd_body``); alignment does not move
it: inputs whose rows the
chosen body cannot read raise. These tests pin both rules on the CPU, where the rules
and the input checks run without a card; the bodies themselves are held to their
plain versions on the card (``test_torch_kernels_gpu.py``).
"""

import pytest
import torch

from open_clip_tpu_torch.ops import short_attention as sa
from open_clip_tpu_torch.ops import window_attention as wa

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("l,hd,dtype,body", [
    (50, 64, BF16, "mma"),     # ViT-B-32 image tower
    (77, 64, BF16, "mma"),     # CLIP text tower
    (128, 64, BF16, "mma"),    # the longest the fused kernel takes
    (1, 32, BF16, "mma"),
    (77, 128, BF16, "mma"),
    (129, 64, BF16, "mma"),    # past the fused kernel: the two tensor-core kernels
    (257, 64, BF16, "mma"),    # ViT-L-14's image tower
    (288, 128, BF16, "mma"),
    (50, 64, FP32, "simt"),    # fp32 always takes the CUDA-core body
    (77, 64, FP32, "simt"),
    (128, 32, FP32, "simt"),
])
def test_short_backward_body(l, hd, dtype, body):
    assert sa.supports(l, 4, hd, None)
    assert sa.bwd_body(l, hd, dtype) == body


@pytest.mark.parametrize("l,hd,dtype,body", [
    (50, 64, BF16, "mma"),     # ViT-B-32 image tower
    (77, 64, BF16, "mma"),     # CLIP text tower
    (1, 32, BF16, "mma"),
    (128, 128, BF16, "mma"),   # the longest whole row in registers
    (129, 64, BF16, "mma"),    # the two-pass body
    (197, 64, BF16, "mma"),    # ViT-B-16
    (257, 64, BF16, "mma"),    # ViT-L-14
    (288, 128, BF16, "mma"),
    (50, 64, FP32, "simt"),    # fp32 keeps the CUDA-core body
    (257, 64, FP32, "simt"),
    (288, 32, FP32, "simt"),
])
def test_short_forward_body(l, hd, dtype, body):
    assert sa.supports(l, 4, hd, None)
    assert sa.fwd_body(l, hd, dtype) == body


@pytest.mark.parametrize("mode,hd,dtype,body", [
    (wa.PANEL, 24, BF16, "mma"),        # HTSAT-tiny, every stage (96/4 ... 768/32)
    (wa.PANEL, 16, BF16, "mma"),        # a non-square map with odd heads (48/3)
    (wa.PANEL, 8, BF16, "mma"),
    (wa.PANEL, 32, BF16, "mma"),
    (wa.PANEL, 64, BF16, "mma"),
    (wa.PANEL, 12, BF16, "simt"),       # hd % 8 != 0
    (wa.PANEL, 72, BF16, "simt"),       # wider than the tensor-core body's tiles
    (wa.PANEL, 1024, BF16, "simt"),
    (wa.PANEL, 24, FP32, "simt"),       # fp32 keeps the CUDA-core body
    (wa.PARTITIONED, 32, BF16, "mma"),  # Swin-B's 49-token windows, hd 32 at every stage
    (wa.PARTITIONED, 24, BF16, "mma"),  # HTSAT's 64-token windows, partitioned
])
def test_window_backward_body(mode, hd, dtype, body):
    """PANEL windows have 64 tokens; the PARTITIONED cases are Swin's 49."""
    n = 64 if mode == wa.PANEL else 49
    assert wa.bwd_body(mode, n, hd, dtype) == body


@pytest.mark.parametrize("n,hd,dtype,body", [
    (49, 32, BF16, "mma"),     # Swin-B, padded to 64 in the kernel
    (64, 24, BF16, "mma"),     # HTSAT's windows where they fall back to partitions
    (9, 8, BF16, "mma"),
    (33, 40, BF16, "mma"),
    (65, 32, BF16, "simt"),    # past the 64-token tile
    (128, 32, BF16, "simt"),
    (49, 32, FP32, "simt"),    # fp32 keeps the CUDA-core body
    (49, 72, BF16, "simt"),    # wider than the tensor-core body's tiles
    (49, 12, BF16, "simt"),    # hd % 8 != 0
])
def test_partitioned_backward_body_by_window_length(n, hd, dtype, body):
    assert wa.supports(n, 4, 4 * hd)
    assert wa.bwd_body(wa.PARTITIONED, n, hd, dtype) == body


@pytest.mark.parametrize("stage", range(4))
def test_every_swin_b_stage_takes_the_tensor_core_backward(stage):
    """Swin-B: width 128 * 2**i and 4 * 2**i heads (hd 32), 7x7 windows."""
    c, heads = 128 * 2 ** stage, 4 * 2 ** stage
    assert wa.bwd_body(wa.PARTITIONED, 49, c // heads, BF16) == "mma"


@pytest.mark.parametrize("stage", range(4))
def test_every_htsat_stage_takes_the_tensor_core_backward(stage):
    """HTSAT-tiny: width 96 * 2**i and 4 * 2**i heads, head width 24 at every stage."""
    c, heads = 96 * 2 ** stage, 4 * 2 ** stage
    assert wa.bwd_body(wa.PANEL, 64, c // heads, BF16) == "mma"


def _short_views(b, l, h, hd, dtype, pad=0, offset=0):
    """q, k, v as the views of one fused (B, L, 3*H*hd + pad) projection, starting
    ``offset`` elements into its storage."""
    width = 3 * h * hd + pad
    flat = torch.zeros(offset + b * l * width, dtype=dtype)[offset:]
    qkv = flat.view(b, l, width)[..., :3 * h * hd].unflatten(-1, (3, h, hd))
    return qkv.unbind(2)


def test_short_fused_views_fit_the_mma_body():
    q, k, v = _short_views(2, 50, 12, 64, BF16)
    sa.check_bwd_inputs(q, k, v, torch.zeros_like(q), "mma")


@pytest.mark.parametrize("l,h,hd", [(50, 12, 64), (77, 8, 64), (257, 16, 64), (288, 2, 128)])
def test_short_fused_views_fit_both_mma_bodies(l, h, hd):
    q, k, v = _short_views(2, l, h, hd, BF16)
    sa.check_fwd_inputs(q, k, v, "mma")
    sa.check_bwd_inputs(q, k, v, torch.zeros_like(q), "mma")


@pytest.mark.parametrize("what", ["row_stride", "pointer"])
def test_short_misaligned_inputs_raise_for_the_mma_body(what):
    """A bf16 row at an 8-byte boundary: the CUDA-core kernels could read it, but the
    shape takes the fused kernel, so the call raises; it is not sent to the other body."""
    if what == "row_stride":  # 3*H*hd + 4 elements a row
        q, k, v = _short_views(2, 50, 2, 32, BF16, pad=4)
    else:  # the storage starts 8 bytes past a 16-byte boundary
        q, k, v = _short_views(2, 50, 2, 32, BF16, offset=4)
    do = torch.zeros(q.shape, dtype=BF16)
    assert sa.bwd_body(50, 32, BF16) == "mma"
    with pytest.raises(ValueError, match="aligned"):
        sa.check_bwd_inputs(q, k, v, do, "mma")
    if what == "row_stride":
        sa.check_bwd_inputs(q, k, v, do, "simt")  # 4-element rows: what "simt" reads


@pytest.mark.parametrize("l", [50, 257])
@pytest.mark.parametrize("what", ["row_stride", "pointer"])
def test_short_misaligned_inputs_raise_for_the_mma_forward(what, l):
    """The forward's mma body reads 16 bytes at a time too: a row 8 bytes past a
    16-byte boundary raises, and is not sent to the CUDA-core forward."""
    if what == "row_stride":
        q, k, v = _short_views(2, l, 2, 32, BF16, pad=4)
    else:
        q, k, v = _short_views(2, l, 2, 32, BF16, offset=4)
    assert sa.fwd_body(l, 32, BF16) == "mma"
    with pytest.raises(ValueError, match="aligned"):
        sa.check_fwd_inputs(q, k, v, "mma")
    if what == "row_stride":
        sa.check_fwd_inputs(q, k, v, "simt")


def _panel_views(b, tokens, c, dtype, pad=0, offset=0):
    """q, k, v as the views of one fused (B, tokens, 3C + pad) projection."""
    width = 3 * c + pad
    flat = torch.zeros(offset + b * tokens * width, dtype=dtype)[offset:]
    return flat.view(b, tokens, width)[..., :3 * c].unflatten(-1, (3, c)).unbind(-2)


def test_panel_fused_views_fit_the_mma_body():
    for c in (96, 192, 384, 768, 48):
        q, k, v = _panel_views(2, 64, c, BF16)
        wa.check_bwd_inputs(q, k, v, torch.zeros(q.shape, dtype=BF16), "mma")


@pytest.mark.parametrize("what", ["row_stride", "pointer"])
def test_panel_misaligned_inputs_raise_for_the_mma_body(what):
    if what == "row_stride":  # 3C + 4 elements a row
        q, k, v = _panel_views(2, 64, 96, BF16, pad=4)
    else:
        q, k, v = _panel_views(2, 64, 96, BF16, offset=4)
    do = torch.zeros(q.shape, dtype=BF16)
    assert wa.bwd_body(wa.PANEL, 64, 24, BF16) == "mma"
    with pytest.raises(ValueError, match="aligned"):
        wa.check_bwd_inputs(q, k, v, do, "mma")
    wa.check_bwd_inputs(q, k, v, do, "simt")  # the CUDA-core body reads any row


def test_swin_fused_views_fit_the_mma_body():
    """Swin-B's windows as the tower hands them over: views of the (B*nW, 49, 3C)
    projection of each stage, every row 16-byte aligned."""
    for c in (128, 256, 512, 1024):
        q, k, v = _panel_views(4, 49, c, BF16)
        wa.check_bwd_inputs(q, k, v, torch.zeros(q.shape, dtype=BF16), "mma")


@pytest.mark.parametrize("what", ["row_stride", "pointer"])
def test_window_misaligned_inputs_raise_for_the_mma_body(what):
    """49-token windows whose rows sit 8 bytes past a 16-byte boundary: the shape
    takes the tensor-core body, which cannot read them, so the check raises."""
    if what == "row_stride":
        q, k, v = _panel_views(4, 49, 128, BF16, pad=4)
    else:
        q, k, v = _panel_views(4, 49, 128, BF16, offset=4)
    do = torch.zeros(q.shape, dtype=BF16)
    assert wa.bwd_body(wa.PARTITIONED, 49, 32, BF16) == "mma"
    with pytest.raises(ValueError, match="aligned"):
        wa.check_bwd_inputs(q, k, v, do, "mma")


# the window/panel forward: one rule with the backward's


@pytest.mark.parametrize("dtype", [BF16, FP32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("hd", [8, 24, 32, 64, 72])
@pytest.mark.parametrize("n", [49, 64, 65, 128])
@pytest.mark.parametrize("mode", [wa.PARTITIONED, wa.PANEL], ids=["partitioned", "panel"])
def test_window_forward_body(mode, n, hd, dtype):
    """bf16 at hd 8, 24, 32 and 64 takes the tensor cores in PANEL mode (64-token
    windows whatever n says) and for PARTITIONED windows of 49 or 64 tokens; fp32,
    hd 72 and PARTITIONED windows of 65 or 128 tokens take the CUDA cores."""
    fits = dtype == BF16 and hd in (8, 24, 32, 64) and (mode == wa.PANEL or n in (49, 64))
    assert wa.fwd_body(mode, n, hd, dtype) == ("mma" if fits else "simt")
    assert wa.fwd_body(mode, n, hd, dtype) == wa.bwd_body(mode, n, hd, dtype)


@pytest.mark.parametrize("stage", range(4))
def test_every_swin_b_stage_takes_the_tensor_core_forward(stage):
    """Swin-B's 7x7 windows at width 128 * 2**i and 4 * 2**i heads (hd 32): "mma" in
    bf16, "simt" in fp32."""
    c, heads = 128 * 2 ** stage, 4 * 2 ** stage
    assert wa.fwd_body(wa.PARTITIONED, 49, c // heads, BF16) == "mma"
    assert wa.fwd_body(wa.PARTITIONED, 49, c // heads, FP32) == "simt"


@pytest.mark.parametrize("stage", range(4))
def test_every_htsat_stage_takes_the_tensor_core_forward(stage):
    """HTSAT-tiny's 8x8 panels at width 96 * 2**i and 4 * 2**i heads (hd 24)."""
    c, heads = 96 * 2 ** stage, 4 * 2 ** stage
    assert wa.fwd_body(wa.PANEL, 64, c // heads, BF16) == "mma"
    assert wa.fwd_body(wa.PANEL, 64, c // heads, FP32) == "simt"


@pytest.mark.parametrize("tokens,widths", [(49, (128, 256, 512, 1024)),   # Swin-B's windows
                                           (64, (96, 192, 384, 768, 48))])  # HTSAT's panels
def test_fused_views_fit_the_mma_forward(tokens, widths):
    """q, k, v as the towers hand them over, views of the fused (.., 3C) projection
    of every stage: every row 16-byte aligned."""
    for c in widths:
        wa.check_fwd_inputs(*_panel_views(2, tokens, c, BF16), "mma")


@pytest.mark.parametrize("tokens,c,hd", [(49, 128, 32), (64, 96, 24)], ids=["window", "panel"])
@pytest.mark.parametrize("what", ["row_stride", "pointer"])
def test_misaligned_inputs_raise_for_the_mma_forward(what, tokens, c, hd):
    """Rows 8 bytes past a 16-byte boundary: the shape takes the tensor-core forward,
    which cannot read them, so the check raises; the call is not sent to the
    CUDA-core forward, which could."""
    if what == "row_stride":
        q, k, v = _panel_views(2, tokens, c, BF16, pad=4)
    else:
        q, k, v = _panel_views(2, tokens, c, BF16, offset=4)
    mode = wa.PARTITIONED if tokens == 49 else wa.PANEL
    assert wa.fwd_body(mode, tokens, hd, BF16) == "mma"
    with pytest.raises(ValueError, match="aligned"):
        wa.check_fwd_inputs(q, k, v, "mma")
    wa.check_fwd_inputs(q, k, v, "simt")
