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
The SwitchBack int8 matmul is held to its plain version exactly (integer sums,
then the same fp32 roundings). The short attention forward and backward and the
window/panel attention forward and backward have two bodies each ("mma" on the tensor
cores for bf16, "simt" on CUDA cores); each test of them also checks which body its
shape took (``fwd_body``, ``bwd_body``), under the same tolerances: the two bodies
round at the same points, but for the bf16 short forward, whose mma body rounds the
unnormalised exponentials (as the TPU kernel does) where the plain version rounds
the probabilities: both within 2e-2. The window/panel forward normalises before it
rounds, in both bodies, as its TPU kernels do.
"""

import numpy as np
import pytest
import torch

from open_clip_tpu_torch.ops import flash_attention as fa
from open_clip_tpu_torch.ops import fused_ln, layers
from open_clip_tpu_torch.ops import short_attention as sa
from open_clip_tpu_torch.ops import switchback as sb

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
    before, bodies = dict(sa.LAUNCHES), dict(sa.FWD_BODIES)
    out = sa.short_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert sa.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"]}
    body = sa.fwd_body(q.shape[1], q.shape[3], q.dtype)
    assert sa.FWD_BODIES == dict(bodies, **{body: bodies[body] + 1})
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


@pytest.mark.parametrize("b,l,h,hd,causal", [
    (8, 50, 12, 64, False),   # ViT-B-32 image tower: one 4-warp block, the row in registers
    (8, 77, 8, 64, True),     # CLIP text tower: a row of 80 keys in registers
    (4, 65, 2, 32, False),    # the shortest row of 80 keys
    (4, 90, 4, 64, True),     # a row of 96 keys
    (4, 128, 4, 128, False),  # the longest row held whole in registers, 8 warps
    (4, 129, 4, 64, False),   # the shortest two-pass length: 3 query tiles
    (4, 129, 2, 32, True),
    (2, 257, 16, 64, False),  # ViT-L-14 image tower: 5 query tiles of 4 warps
    (2, 257, 4, 64, True),
    (2, 197, 3, 64, False),   # ViT-B-16
    (2, 288, 2, 128, True),   # the most shared memory
    (2, 288, 2, 128, False),
])
def test_mma_forward_matches_plain(cuda, b, l, h, hd, causal):
    """The bf16 tensor-core forward on strided views of a fused qkv projection."""
    assert sa.fwd_body(l, hd, torch.bfloat16) == "mma"
    _check(*_fused_qkv(l + hd + h, b, l, h, hd, torch.bfloat16, cuda), causal)


@pytest.mark.parametrize("l", [77, 257])
def test_mma_forward_keeps_a_max_per_head(cuda, l):
    """Head 0's logits ~100 below head 1's, at a one-pass and a two-pass length."""
    q, k, v = (x.float().clone() for x in _fused_qkv(0, 4, l, 2, 64, torch.float32, cuda))
    q[:, :, 0] = 1.0 + 0.1 * q[:, :, 0]
    k[:, :, 0] = -100.0 / (64 * 64 ** -0.5) + 0.01 * k[:, :, 0]
    _check(q.bfloat16(), k.bfloat16(), v.bfloat16(), False)


@pytest.mark.parametrize("l", [50, 257])
def test_mma_forward_raises_on_misaligned_rows(cuda, l):
    """Rows 8 bytes past a 16-byte boundary: bf16 takes the mma forward, which cannot
    read them, so the call raises and nothing is launched."""
    qkv = torch.zeros(2, l, 3 * 2 * 32 + 4, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[..., :3 * 2 * 32].unflatten(-1, (3, 2, 32)).unbind(2)
    before = (dict(sa.LAUNCHES), dict(sa.FWD_BODIES))
    with pytest.raises(ValueError, match="aligned"):
        sa.short_attention(q, k, v)
    assert (sa.LAUNCHES, sa.FWD_BODIES) == before


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
    before, bodies = dict(sa.LAUNCHES), dict(sa.BWD_BODIES)
    out = sa.short_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert sa.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    body = sa.bwd_body(q.shape[1], q.shape[3], q.dtype)
    assert sa.BWD_BODIES == dict(bodies, **{body: bodies[body] + 1})
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


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("l", [1, 50, 77, 128])
def test_fused_backward_matches_plain(cuda, l, hd, causal):
    """The bf16 fused tensor-core body at every sequence length class it takes (one
    row, the image tower, the text tower, its longest), on strided views of a fused
    qkv projection."""
    assert sa.bwd_body(l, hd, torch.bfloat16) == "mma"
    _check_bwd(*_fused_qkv(l + hd, 3, l, 4, hd, torch.bfloat16, cuda), causal)


@pytest.mark.parametrize("b,l,h,hd,causal", [
    (4, 129, 4, 64, False),   # the shortest length of the two kernels
    (4, 129, 2, 32, True),
    (2, 257, 16, 64, False),  # ViT-L-14's image tower
    (2, 257, 4, 64, True),
    (2, 288, 2, 128, False),  # the most shared memory
    (2, 288, 2, 128, True),
])
def test_long_mma_backward_matches_plain(cuda, b, l, h, hd, causal):
    """The bf16 backward past L = 128: two tensor-core kernels and the statistics
    scratch, on strided views of a fused qkv projection."""
    assert sa.bwd_body(l, hd, torch.bfloat16) == "mma"
    _check_bwd(*_fused_qkv(l + hd, b, l, h, hd, torch.bfloat16, cuda), causal)


def test_long_mma_backward_keeps_a_max_per_head(cuda):
    q, k, v = (x.float().clone() for x in _fused_qkv(5, 2, 257, 2, 64, torch.float32, cuda))
    q[:, :, 0] = 1.0 + 0.1 * q[:, :, 0]
    k[:, :, 0] = -100.0 / (64 * 64 ** -0.5) + 0.01 * k[:, :, 0]
    _check_bwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), False)


def test_fused_backward_raises_on_misaligned_rows(cuda):
    """Rows 8 bytes past a 16-byte boundary: the shape takes the fused body, which
    cannot read them, so the call raises and nothing is launched."""
    qkv = torch.zeros(2, 50, 3 * 2 * 32 + 4, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[..., :3 * 2 * 32].unflatten(-1, (3, 2, 32)).unbind(2)
    before = (dict(sa.LAUNCHES), dict(sa.BWD_BODIES))
    with pytest.raises(ValueError, match="aligned"):
        sa.short_attention_bwd(q, k, v, torch.zeros_like(q))
    assert (sa.LAUNCHES, sa.BWD_BODIES) == before


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


def _ln_rows(which, w, dtype):
    """Row counts that reach each path of the launch plan: 1 and 3 rows (one tile, the
    bf16 rows of W % 8 == 4 then partly by plain loads), fewer tiles than blocks, and
    more tiles than blocks with a last tile of one row."""
    if which == "fewer_tiles_than_blocks":
        return 100
    if which == "ragged_last_tile":
        return fused_ln.launch_plan(1 << 20, w, dtype, 132).rows_per_tile * 140 + 1
    return int(which)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", ["1", "3", "fewer_tiles_than_blocks", "ragged_last_tile"])
@pytest.mark.parametrize("w", [4, 12, 20, 128, 256, 640, 1024, 1028, 4096])
def test_layer_norm_backward_kernel_widths_and_rows(cuda, w, rows, dtype):
    r = _ln_rows(rows, w, dtype)
    rng = np.random.default_rng(w + r)
    x = torch.from_numpy(rng.standard_normal((r, w), dtype=np.float32) * 2 + 0.5).to(cuda, dtype)
    dy = torch.from_numpy(rng.standard_normal((r, w), dtype=np.float32)).to(cuda, dtype)
    scale = torch.from_numpy(rng.standard_normal(w, dtype=np.float32)).to(cuda)
    before = fused_ln.LAUNCHES["bwd"]
    got = fused_ln.layer_norm_bwd(x, dy, scale, 1e-5)
    torch.cuda.synchronize()
    assert fused_ln.LAUNCHES["bwd"] == before + 1
    refs = fused_ln.layer_norm_bwd_reference(x, dy, scale, 1e-5)
    for name, g, ref in zip(("dx", "dscale", "dbias"), got, refs):
        assert g.shape == ref.shape and g.dtype == ref.dtype and bool(torch.isfinite(g).all()), name
        tol = 1e-2 if (dtype == torch.bfloat16 and name == "dx") else 1e-4
        assert _rel_err(g, ref) <= tol, (name, _rel_err(g, ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_layer_norm_backward_kernel_at_convnext_stage0(cuda, dtype):
    """524,288 x 128: 8,192 tiles over the persistent blocks."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(524288, 128, generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    dy = torch.randn(524288, 128, generator=gen, device=cuda).to(dtype)
    scale = torch.randn(128, generator=gen, device=cuda)
    got = fused_ln.layer_norm_bwd(x, dy, scale, 1e-5)
    refs = fused_ln.layer_norm_bwd_reference(x, dy, scale, 1e-5)
    for name, g, ref in zip(("dx", "dscale", "dbias"), got, refs):
        assert bool(torch.isfinite(g).all()), name
        tol = 1e-2 if (dtype == torch.bfloat16 and name == "dx") else 1e-4
        assert _rel_err(g, ref) <= tol, (name, _rel_err(g, ref))


@pytest.mark.parametrize("shape", [(12800, 768), (524288, 128), (131072, 256)],
                         ids=["12800x768", "524288x128", "131072x256"])
def test_layer_norm_backward_kernel_is_deterministic(cuda, shape):
    x = torch.randn(*shape, device=cuda, dtype=torch.bfloat16)
    dy = torch.randn_like(x)
    scale = torch.randn(shape[1], device=cuda)
    a = fused_ln.layer_norm_bwd(x, dy, scale)
    b = fused_ln.layer_norm_bwd(x, dy, scale)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


def test_layer_norm_backward_kernel_in_a_cuda_graph(cuda):
    """Replays of a captured launch (each taking the kernel's arrival counters in
    turn) give the eager launch's bits, and so does an eager launch after them."""
    x = torch.randn(8192, 1024, device=cuda, dtype=torch.bfloat16)
    dy, scale = torch.randn_like(x), torch.randn(1024, device=cuda)
    want = fused_ln.layer_norm_bwd(x, dy, scale)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fused_ln.layer_norm_bwd(x, dy, scale)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(s, t) for s, t in zip(got, want))
    again = fused_ln.layer_norm_bwd(x, dy, scale)
    assert all(torch.equal(s, t) for s, t in zip(again, want))


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
    before, bodies, bwd_bodies = dict(fa.LAUNCHES), dict(fa.FWD_BODIES), dict(fa.BWD_BODIES)
    out = fa.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {key: n + 1 for key, n in before.items()}
    body = fa.fwd_body(hd, dtype)  # bf16: the wgmma forward at every L and mask
    assert fa.FWD_BODIES == dict(bodies, **{body: bodies[body] + 1})
    body = fa.bwd_body(hd, dtype)  # bf16: the wgmma dq and dk/dv at both head widths
    assert fa.BWD_BODIES == dict(bwd_bodies, **{body: bwd_bodies[body] + 1})
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l,h", [(4, 196, 12), (4, 64, 12)], ids=["siglip_image", "siglip_text"])
def test_siglip_short_kernels_match_plain(cuda, b, l, h, dtype):
    """ViT-B-16-SigLIP's towers: 196 tokens and no class token (in bf16 the two-pass
    forward and the two-kernel backward), and the non-causal 64-token text tower."""
    q, k, v = _fused_qkv(l + h, b, l, h, 64, dtype, cuda)
    if dtype == torch.bfloat16:
        assert sa.fwd_body(l, 64, dtype) == sa.bwd_body(l, 64, dtype) == "mma"
    _check(q, k, v, False)
    _check_bwd(q, k, v, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_siglip384_flash_forward_without_a_mask_matches_plain(cuda, dtype):
    """ViT-B-16-SigLIP-384's blocks: 576 tokens, no key mask, no causal mask."""
    q, k, v = _fused_qkv(588, 2, 576, 12, 64, dtype, cuda)
    before, bodies = dict(fa.LAUNCHES), dict(fa.FWD_BODIES)
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict(before, fwd=before["fwd"] + 1)
    body = fa.fwd_body(64, dtype)
    assert fa.FWD_BODIES == dict(bodies, **{body: bodies[body] + 1})
    ref, ref_lse = fa.flash_attention_reference(q, k, v)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4


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


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("l", [1024, 576])  # 128-row items, and 192-row items
def test_flash_wgmma_forward_skips_tiles_without_a_valid_key(cuda, l, causal):
    """Samples with 300, all, 0 and 129 valid keys: whole 128-key tiles hold no valid
    key, which the wgmma forward neither loads nor multiplies; the result is the plain
    version's, and the sample with none gives zero rows and a finite lse."""
    b, h, hd = 4, 4, 64
    q, k, v = _fused_qkv(31, b, l, h, hd, torch.bfloat16, cuda)
    lens = torch.tensor([300, l, 0, 129], device=cuda)
    valid = torch.arange(l, device=cuda)[None, :] < lens[:, None]
    bodies = dict(fa.FWD_BODIES)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, key_valid=valid)
    torch.cuda.synchronize()
    assert fa.FWD_BODIES["wgmma"] == bodies["wgmma"] + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, key_valid=valid)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    assert bool((out[2] == 0).all())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]
    seen = [0, 1, 3]  # lse of the rows that see a key
    assert (lse[seen] - ref_lse[seen]).abs().max().item() <= 1e-4
    again, _ = fa.flash_attention_fwd(q, k, v, causal=causal, key_valid=valid)
    assert torch.equal(out, again)


@pytest.mark.parametrize("what", ["row_stride", "pointer"])
def test_flash_wgmma_forward_raises_on_misaligned_rows(cuda, what):
    """bf16 rows 8 bytes past a 16-byte boundary: no TMA tensor map can describe
    them, so the call raises and nothing launches (no other body takes them)."""
    if what == "row_stride":
        x = torch.zeros(2, 520, 3 * 4 * 64 + 4, device=cuda, dtype=torch.bfloat16)
        q, k, v = x[..., :3 * 4 * 64].unflatten(-1, (3, 4, 64)).unbind(2)
    else:
        x = torch.zeros(2 * 520 * 768 + 4, device=cuda, dtype=torch.bfloat16)[4:]
        q = k = v = x.view(2, 520, 12, 64)
    before = (dict(fa.LAUNCHES), dict(fa.FWD_BODIES))
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(q, k, v)
    assert (fa.LAUNCHES, fa.FWD_BODIES) == before


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("l,hd", [(1024, 64), (576, 64), (520, 128)])
def test_flash_wgmma_backward_skips_tiles_without_a_valid_key(cuda, l, hd, causal):
    """Samples with 300, all, 0 and 129 valid keys: whole key tiles hold no valid key,
    which the wgmma dq kernel skips and for which the dk/dv kernel writes zeros without
    loading anything. dq, dk and dv are the plain version's, the sample with none gets
    zero gradients, and two runs give the same bits."""
    b, h = 4, 4
    q, k, v = _fused_qkv(32, b, l, h, hd, torch.bfloat16, cuda)
    do = np.random.default_rng(33).standard_normal((b, l, h, hd), dtype=np.float32)
    do = torch.from_numpy(do).to(cuda, torch.bfloat16)
    lens = torch.tensor([300, l, 0, 129], device=cuda)
    valid = torch.arange(l, device=cuda)[None, :] < lens[:, None]
    kw = dict(causal=causal, key_valid=valid)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    bodies = dict(fa.BWD_BODIES)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.BWD_BODIES["wgmma"] == bodies["wgmma"] + 1
    refs = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert bool(torch.isfinite(got).all()) and bool((got[2] == 0).all()), name
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_RTOL[torch.bfloat16] * want.float().abs().max().item(), (name, err)
    for a, b_ in zip(grads, fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)):
        assert torch.equal(a, b_)


def test_flash_backward_is_deterministic(cuda):
    q, k, v = (x.detach().requires_grad_() for x in _fused_qkv(3, 2, 600, 4, 64, torch.bfloat16, cuda))
    valid = _ragged_valid(2, 600, cuda)
    runs = [torch.autograd.grad(fa.flash_attention(q, k, v, key_valid=valid), (q, k, v),
                                torch.ones_like(q)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["fp16", "transposed", "hd32", "cross", "prefix_without_causal",
                                  "mask_shape", "misaligned_do", "misaligned_out"])
def test_flash_wrapper_raises_on_what_the_kernels_do_not_take(cuda, what):
    q, k, v = _fused_qkv(2, 2, 520, 4, 64, torch.float32, cuda)
    if what in ("misaligned_do", "misaligned_out"):
        # a bf16 do or out 8 bytes past a 16-byte boundary: no tensor map of the wgmma
        # backward can read it, so the backward raises and nothing launches
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        out, lse = fa.flash_attention_fwd(q, k, v)
        shifted = torch.zeros(q.numel() + 4, device=cuda, dtype=torch.bfloat16)[4:].view(q.shape)
        do = shifted if what == "misaligned_do" else torch.ones_like(out)
        if what == "misaligned_out":
            out = shifted.copy_(out)
        before = (dict(fa.LAUNCHES), dict(fa.BWD_BODIES))
        with pytest.raises(ValueError, match="aligned"):
            fa.flash_attention_bwd(q, k, v, out, lse, do)
        assert (fa.LAUNCHES, fa.BWD_BODIES) == before
        return
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


SWIN_MMA_CASES = [  # (B*nW, N, C, heads, nW): bf16 windows the tensor-core backward takes
    (32 * 64, 49, 128, 4, 64),  # Swin-B stage 0 at the train batch, shifted
    (32 * 16, 49, 256, 8, 16),  # stage 1
    (32 * 4, 49, 512, 16, 4),   # stage 2
    (32, 49, 1024, 32, 1),      # stage 3: 7x7, one window a sample, unshifted
    (8 * 64, 64, 96, 4, 64),    # HTSAT's 64-token windows, partitioned
    (6, 9, 24, 3, 2),           # short windows, hd 8
]


@pytest.mark.parametrize("b,n,c,heads,nw", SWIN_MMA_CASES)
def test_partitioned_mma_backward_matches_plain(cuda, b, n, c, heads, nw):
    """Windows of N <= 64 tokens padded to the 64-token tile: dq, dk, dv and dbias
    against the plain version, on the tensor-core body."""
    from open_clip_tpu_torch.ops import window_attention as wa

    q, k, v, bias, do = _window_inputs(b + n + 7, (b, n), c, nw, heads, n, torch.bfloat16, cuda)
    assert wa.bwd_body(wa.PARTITIONED, n, c // heads, torch.bfloat16) == "mma"
    bodies = dict(wa.BWD_BODIES)
    grads = wa.window_attention_bwd(q, k, v, bias, do)
    torch.cuda.synchronize()
    assert wa.BWD_BODIES == dict(bodies, mma=bodies["mma"] + 1)
    refs = wa.window_attention_bwd_reference(q, k, v, bias, do)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, refs):
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        assert _rel_err(g, r) <= BWD_RTOL[torch.bfloat16], (name, _rel_err(g, r))


def test_partitioned_mma_backward_raises_on_misaligned_rows(cuda):
    """49-token windows whose rows sit 8 bytes past a 16-byte boundary: the shape takes
    the tensor-core body, which cannot read them, so the call raises and nothing is
    launched (it is not sent to the CUDA-core body)."""
    from open_clip_tpu_torch.ops import window_attention as wa

    x = torch.zeros(64, 49, 3 * 128 + 4, device=cuda, dtype=torch.bfloat16)
    q, k, v = x[..., :3 * 128].unflatten(-1, (3, 128)).unbind(-2)
    bias = torch.zeros(64, 4, 49, 49, device=cuda)
    before = (dict(wa.LAUNCHES), dict(wa.BWD_BODIES))
    with pytest.raises(ValueError, match="aligned"):
        wa.window_attention_bwd(q, k, v, bias, torch.zeros(q.shape, device=cuda,
                                                           dtype=torch.bfloat16))
    assert (wa.LAUNCHES, wa.BWD_BODIES) == before


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
    before, bodies, fwd_bodies = dict(wa.LAUNCHES), dict(wa.BWD_BODIES), dict(wa.FWD_BODIES)
    out = wa.window_attention_fwd(q, k, v, bias)
    grads = wa.window_attention_bwd(q, k, v, bias, do)
    assert wa.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    body = wa.bwd_body(wa.PARTITIONED, n, c // heads, dtype)  # bf16 N <= 64, hd <= 64: "mma"
    assert wa.BWD_BODIES == dict(bodies, **{body: bodies[body] + 1})
    assert wa.FWD_BODIES == dict(fwd_bodies, **{body: fwd_bodies[body] + 1})  # the same rule
    _check_window_pair(out, wa.window_attention_reference(q, k, v, bias), grads,
                       wa.window_attention_bwd_reference(q, k, v, bias, do), dtype)


PANEL_KERNEL_CASES = [  # (B, H, W, C, heads, nW)
    (2, 64, 64, 96, 4, 64),     # HTSAT-tiny stage 0, shifted
    (2, 64, 64, 96, 4, 1),      # stage 0, unshifted
    (2, 32, 32, 192, 8, 16),    # stage 1, shifted
    (2, 32, 32, 192, 8, 1),     # stage 1, unshifted
    (2, 16, 16, 384, 16, 4),    # stage 2, shifted
    (2, 16, 16, 384, 16, 1),    # stage 2, unshifted
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
    from open_clip_tpu_torch.ops import window_attention as wa

    q, k, v, bias, do = _window_inputs(b + h + w + c, (b, h * w), c, nw, heads, 64, dtype, cuda)
    kw = dict(hw=(h, w), ws=8)
    before, bodies, fwd_bodies = dict(swa.LAUNCHES), dict(swa.BWD_BODIES), dict(swa.FWD_BODIES)
    out = swa.panel_attention_fwd(q, k, v, bias, **kw)
    grads = swa.panel_attention_bwd(q, k, v, bias, do, **kw)
    assert swa.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    body = wa.bwd_body(wa.PANEL, 64, c // heads, dtype)  # bf16: "mma" up to hd 64, then "simt"
    assert swa.BWD_BODIES == dict(bodies, **{body: bodies[body] + 1})
    assert swa.FWD_BODIES == dict(fwd_bodies, **{body: fwd_bodies[body] + 1})  # the same rule
    _check_window_pair(out, swa.panel_attention_reference(q, k, v, bias, **kw), grads,
                       swa.panel_attention_bwd_reference(q, k, v, bias, do, **kw), dtype)


# the tensor-core forward: (name, B (samples, or windows when the map is None), map or
# N, C, heads, nW); Swin-B's four stages at the train batch, HTSAT-tiny's four at batch 8
MMA_FWD_CASES = [
    ("swin_s0", 32 * 64, None, 49, 128, 4, 64),
    ("swin_s1", 32 * 16, None, 49, 256, 8, 16),
    ("swin_s2", 32 * 4, None, 49, 512, 16, 4),
    ("swin_s3", 32, None, 49, 1024, 32, 1),
    ("odd_heads", 96, None, 49, 72, 3, 1),
    ("htsat_s0_shift", 8, (64, 64), 64, 96, 4, 64),
    ("htsat_s1_shift", 8, (32, 32), 64, 192, 8, 16),
    ("htsat_s2_shift", 8, (16, 16), 64, 384, 16, 4),
    ("htsat_s3", 8, (8, 8), 64, 768, 32, 1),
    ("nonsquare_odd_heads", 8, (16, 40), 64, 48, 3, 10),
]


def _forward(seed, b, hw, n, c, heads, nw, dtype, device):
    """(the forward call, its plain version, the module that counts it)."""
    from open_clip_tpu_torch.ops import swin_attention as swa
    from open_clip_tpu_torch.ops import window_attention as wa

    lead = (b, n) if hw is None else (b, hw[0] * hw[1])
    q, k, v, bias, _ = _window_inputs(seed, lead, c, nw, heads, n, dtype, device)
    if hw is None:
        return (lambda: wa.window_attention_fwd(q, k, v, bias),
                lambda: wa.window_attention_reference(q, k, v, bias), wa)
    return (lambda: swa.panel_attention_fwd(q, k, v, bias, hw=hw, ws=8),
            lambda: swa.panel_attention_reference(q, k, v, bias, hw=hw, ws=8), swa)


@pytest.mark.parametrize("name,b,hw,n,c,heads,nw", MMA_FWD_CASES, ids=[x[0] for x in MMA_FWD_CASES])
def test_window_mma_forward_matches_plain(cuda, name, b, hw, n, c, heads, nw):
    """The tensor-core forward (49-token windows padded to 64, HTSAT's panels read from
    the token map) against its plain version, one launch on the "mma" body."""
    from open_clip_tpu_torch.ops import window_attention as wa

    mode = wa.PARTITIONED if hw is None else wa.PANEL
    assert wa.fwd_body(mode, n, c // heads, torch.bfloat16) == "mma"
    fwd, ref, mod = _forward(b + n + c, b, hw, n, c, heads, nw, torch.bfloat16, cuda)
    bodies = dict(mod.FWD_BODIES)
    out = fwd()
    torch.cuda.synchronize()
    assert mod.FWD_BODIES == dict(bodies, mma=bodies["mma"] + 1)
    want = ref()
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert bool(torch.isfinite(out).all())
    assert (out.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.parametrize("name", ["swin_s0", "htsat_s0_shift"])
def test_window_mma_forward_is_deterministic(cuda, name):
    """Every output row is written once: two launches give the same bits."""
    case = next(x for x in MMA_FWD_CASES if x[0] == name)
    fwd, _, mod = _forward(5, *case[1:], torch.bfloat16, cuda)
    bodies = dict(mod.FWD_BODIES)
    first, second = fwd(), fwd()
    assert mod.FWD_BODIES["mma"] == bodies["mma"] + 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("name", ["swin_s0", "htsat_s0_shift"])
def test_window_fp32_forward_stays_on_the_cuda_cores(cuda, name):
    case = next(x for x in MMA_FWD_CASES if x[0] == name)
    fwd, ref, mod = _forward(6, *case[1:], torch.float32, cuda)
    bodies = dict(mod.FWD_BODIES)
    out = fwd()
    torch.cuda.synchronize()
    assert mod.FWD_BODIES == dict(bodies, simt=bodies["simt"] + 1)
    assert (out - ref()).abs().max().item() <= TOL[torch.float32]


@pytest.mark.parametrize("mode", ["window", "panel"])
def test_window_mma_forward_raises_on_misaligned_rows(cuda, mode):
    """Rows 8 bytes past a 16-byte boundary: the shape takes the tensor-core forward,
    which cannot read them, so the call raises and nothing is launched (it is not sent
    to the CUDA-core forward)."""
    from open_clip_tpu_torch.ops import swin_attention as swa
    from open_clip_tpu_torch.ops import window_attention as wa

    tokens, c, heads = (49, 128, 4) if mode == "window" else (64, 96, 4)
    x = torch.zeros(8, tokens, 3 * c + 4, device=cuda, dtype=torch.bfloat16)
    q, k, v = x[..., :3 * c].unflatten(-1, (3, c)).unbind(-2)
    bias = torch.zeros(1, heads, tokens, tokens, device=cuda)
    mod = wa if mode == "window" else swa
    before = (dict(mod.LAUNCHES), dict(mod.FWD_BODIES))
    with pytest.raises(ValueError, match="aligned"):
        if mode == "window":
            wa.window_attention_fwd(q, k, v, bias)
        else:
            swa.panel_attention_fwd(q, k, v, bias, hw=(8, 8), ws=8)
    assert (mod.LAUNCHES, mod.FWD_BODIES) == before


@pytest.mark.parametrize("route", ["panel_mma", "panel_simt", "short_mma", "short_simt",
                                   "short_mma_long", "window_mma"])
def test_window_backward_is_deterministic(cuda, route):
    """No atomics on either body: dbias folds fixed groups' partials in a fixed order,
    every other output is written once. The same bits every run."""
    from open_clip_tpu_torch.ops import swin_attention as swa
    from open_clip_tpu_torch.ops import window_attention as wa

    if route == "window_mma":  # Swin-B stage 0, 49-token windows on the tensor cores
        q, k, v, bias, do = _window_inputs(3, (32 * 64, 49), 128, 64, 4, 49, torch.bfloat16,
                                           cuda)
        before = dict(wa.BWD_BODIES)
        runs = [wa.window_attention_bwd(q, k, v, bias, do) for _ in range(3)]
        assert wa.BWD_BODIES["mma"] == before["mma"] + 3
    elif route.startswith("panel"):
        dtype = torch.bfloat16 if route == "panel_mma" else torch.float32
        q, k, v, bias, do = _window_inputs(3, (8, 4096), 96, 1, 4, 64, dtype, cuda)
        before = dict(swa.BWD_BODIES)
        runs = [swa.panel_attention_bwd(q, k, v, bias, do, hw=(64, 64), ws=8) for _ in range(3)]
        assert swa.BWD_BODIES[route[6:]] == before[route[6:]] + 3
    else:
        # bf16 takes the mma bodies at every length (77: the fused kernel, 257: the two
        # kernels); fp32 the CUDA-core one
        l = 77 if route == "short_mma" else 257
        dtype = torch.float32 if route == "short_simt" else torch.bfloat16
        body = "simt" if route == "short_simt" else "mma"
        q, k, v = _fused_qkv(3, 4, l, 8, 64, dtype, cuda)
        do = torch.ones_like(q)
        before = dict(sa.BWD_BODIES)
        runs = [sa.short_attention_bwd(q, k, v, do, causal=True) for _ in range(3)]
        assert sa.BWD_BODIES[body] == before[body] + 3
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_panel_mma_backward_raises_on_misaligned_rows(cuda):
    """A bf16 panel whose rows sit 8 bytes past a 16-byte boundary: the shape takes
    the tensor-core body, which cannot read them, so the call raises and nothing is
    launched (it is not sent to the CUDA-core body)."""
    from open_clip_tpu_torch.ops import swin_attention as swa

    x = torch.zeros(2, 64, 3 * 96 + 4, device=cuda, dtype=torch.bfloat16)
    q, k, v = x[..., :3 * 96].unflatten(-1, (3, 96)).unbind(-2)
    bias = torch.zeros(1, 4, 64, 64, device=cuda)
    before = (dict(swa.LAUNCHES), dict(swa.BWD_BODIES))
    with pytest.raises(ValueError, match="aligned"):
        swa.panel_attention_bwd(q, k, v, bias, torch.zeros(q.shape, device=cuda,
                                                           dtype=torch.bfloat16), hw=(8, 8), ws=8)
    assert (swa.LAUNCHES, swa.BWD_BODIES) == before


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


# ---------------------------------------------------------------------------
# SwitchBack int8 matmul-dequant
# ---------------------------------------------------------------------------

SWITCHBACK_CASES = [  # (M, K, N)
    (8224, 1280, 5120), (8224, 5120, 1280),  # ViT-H-14 image tower MLP, batch 32
    (2464, 1024, 4096), (2464, 4096, 1024),  # ViT-H-14 text tower MLP, batch 32
    (12800, 768, 3072), (12800, 3072, 768),  # ViT-B-32 image tower, batch 256
    (19712, 512, 2048), (19712, 2048, 512),  # ViT-B-32 text tower, batch 256
    (5, 16, 3), (9, 24, 13), (33, 40, 7), (130, 72, 129), (1, 1, 1), (257, 80, 250),
    (130, 144, 129),  # ragged M, N and K (two 128-byte stages, the second mostly past K)
]


def _int8_operands(seed, m, k, n, device):
    g = torch.Generator().manual_seed(seed)
    qx = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    qw = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    qx[0] = 0  # a zero row
    qw[-1] = 0  # a zero column of the output
    sx = torch.rand(m, generator=g) * 0.1 + 1e-3
    sw = torch.rand(n, generator=g) * 0.1 + 1e-3
    return [t.to(device) for t in (qx, qw, sx, sw)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", SWITCHBACK_CASES)
def test_switchback_kernel_matches_plain_exactly(cuda, m, k, n, out_dtype):
    """The body matmul_body picks (wgmma where K % 16 == 0), bit for bit, twice."""
    args = _int8_operands(m + k + n, m, k, n, cuda)
    body = sb.matmul_body(k, True)
    before, bodies = sb.LAUNCHES["fwd"], dict(sb.FWD_BODIES)
    out = sb.int8_matmul_dequant(*args, out_dtype=out_dtype)
    again = sb.int8_matmul_dequant(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert sb.LAUNCHES["fwd"] == before + 2 and sb.FWD_BODIES[body] == bodies[body] + 2
    ref = sb.int8_matmul_dequant_plain(*args, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (m, n)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, again)  # the same bits every launch


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(300, 528, 520), (129, 32, 136), (64, 16, 8)])
def test_switchback_wgmma_output_paths_match_plain_exactly(cuda, m, k, n, out_dtype):
    """Ragged M and a last column tile that is mostly past N: the bf16 tile staged in
    shared memory and stored by TMA (N % 8 == 0), and the fp32 one from the registers."""
    args = _int8_operands(m * k + n, m, k, n, cuda)
    before = sb.FWD_BODIES["wgmma"]
    out = sb.int8_matmul_dequant(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert sb.FWD_BODIES["wgmma"] == before + 1
    assert torch.equal(out, sb.int8_matmul_dequant_plain(*args, out_dtype=out_dtype))


@pytest.mark.parametrize("m,k,n", [(8224, 1280, 5120), (257, 80, 250), (5, 16, 3)])
def test_switchback_mma_body_on_aligned_shapes_matches_plain_exactly(cuda, monkeypatch, m, k, n):
    """The mma body's 16-byte path, which chip_smoke.py patches in for its
    before-and-after runs."""
    monkeypatch.setattr(sb, "matmul_body", lambda k_, aligned: "mma")
    args = _int8_operands(m + 2 * k + n, m, k, n, cuda)
    before = sb.FWD_BODIES["mma"]
    out = sb.int8_matmul_dequant(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert sb.FWD_BODIES["mma"] == before + 1
    assert torch.equal(out, sb.int8_matmul_dequant_plain(*args, out_dtype=torch.float32))


@pytest.mark.parametrize("what", ["k24", "pointer"])
def test_switchback_wgmma_refuses_what_tma_cannot_read(cuda, monkeypatch, what):
    """The C entry point refuses a wgmma call the rule rejects and the wrapper
    raises: the body follows the shape, never a failure."""
    monkeypatch.setattr(sb, "matmul_body", lambda k_, aligned: "wgmma")
    qx, qw, sx, sw = _int8_operands(2, 64, 24 if what == "k24" else 32, 32, cuda)
    if what == "pointer":  # K = 32, qw one byte off its 16-byte boundary
        qw = torch.empty(qw.numel() + 1, dtype=torch.int8, device=cuda)[1:].view(32, 32).copy_(qw)
    before = dict(sb.FWD_BODIES)
    with pytest.raises(RuntimeError, match="wgmma"):
        sb.int8_matmul_dequant(qx, qw, sx, sw)
    assert sb.FWD_BODIES == before


def test_switchback_bf16_output_is_the_fp32_output_rounded_once(cuda):
    args = _int8_operands(7, 2464, 1024, 4096, cuda)
    out32 = sb.int8_matmul_dequant(*args, out_dtype=torch.float32)
    out16 = sb.int8_matmul_dequant(*args, out_dtype=torch.bfloat16)
    assert torch.equal(out16, out32.to(torch.bfloat16))


def test_switchback_kernel_raises_past_the_int32_limit(cuda):
    k = sb.MAX_K + 1
    qx = torch.ones(1, k, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        sb.int8_matmul_dequant(qx, qx, torch.ones(1, device=cuda), torch.ones(1, device=cuda))
    # at the limit itself the sum of 127 * 127 * K still fits, and the kernel is exact
    k = sb.MAX_K
    qx = torch.full((2, k), 127, dtype=torch.int8, device=cuda)
    ones = torch.ones(2, device=cuda)
    out = sb.int8_matmul_dequant(qx, qx, ones, ones)
    assert torch.equal(out, sb.int8_matmul_dequant_plain(qx, qx, ones, ones))


def test_switchback_linear_on_the_card_matches_the_cpu(cuda):
    """The custom op and its gradients: bf16 activations, an fp32 master weight."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 77, 1024, generator=g)
    w = torch.randn(4096, 1024, generator=g) * 0.02
    b = torch.randn(4096, generator=g) * 0.02
    outs = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev, torch.bfloat16).detach().requires_grad_()
        wd, bd = (t.to(dev).detach().requires_grad_() for t in (w, b))
        y = sb.switchback_linear(xd, wd, bd)
        y.float().square().mean().backward()
        outs[dev] = [t.detach().float().cpu() for t in (y, xd.grad, wd.grad, bd.grad)]
    y_g, y_c = outs["cuda"][0], outs["cpu"][0]
    # the same int8 values and scales; the bf16 bias add may round at another place
    assert (y_g - y_c).abs().max().item() <= 2e-2 * y_c.abs().max().item()
    for got, ref in zip(outs["cuda"][1:], outs["cpu"][1:]):
        assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("what", ["not_int8", "transposed", "fp16_out", "scales_fp16"])
def test_switchback_wrapper_raises_on_what_the_kernel_does_not_take(cuda, what):
    qx, qw, sx, sw = _int8_operands(1, 64, 64, 32, cuda)
    kw = {}
    if what == "not_int8":
        qx = qx.float()
    elif what == "transposed":
        qw = qw.t()
    elif what == "fp16_out":
        kw["out_dtype"] = torch.float16
    else:
        sx = sx.half()
    with pytest.raises(ValueError):
        sb.int8_matmul_dequant(qx, qw, sx, sw, **kw)


# the row-wise quantization: (M, K) activations in bf16, the fp32 master weights, ragged rows
QUANTIZE_CASES = [  # (M, K, dtype)
    (8224, 1280, torch.bfloat16), (8224, 5120, torch.bfloat16),  # ViT-H-14 image MLP inputs
    (5120, 1280, torch.float32), (1280, 5120, torch.float32),    # and its weights
    (2464, 1024, torch.bfloat16), (2464, 4096, torch.bfloat16),  # text tower
    (4096, 1024, torch.float32), (1024, 4096, torch.float32),
    (12800, 768, torch.bfloat16), (19712, 2048, torch.bfloat16), (3072, 768, torch.float32),
    (5, 1, torch.float32), (9, 7, torch.bfloat16), (33, 24, torch.bfloat16),
    (17, 7, torch.float32), (3, 20000, torch.float32),  # rows too long for the registers
]


def _quantize_input(seed, m, k, dtype):
    """Rows of mixed ranges, then rows at .5 ties (absmax 127, 254 and 63.5: scales
    1, 2 and 0.5, every other value k + 0.5 times the scale) and an all-zero row."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g) * (torch.rand(m, 1, generator=g) * 10 + 0.01)
    halves = (torch.arange(k) % 253 - 126).float() + 0.5
    for i, s in enumerate((1.0, 2.0, 0.5)[:max(0, m - 1)]):
        x[i] = halves.clamp(-126.5, 126.5) * s
        x[i, 0] = 127.0 * s
    x[-1] = 0.0
    return x.to(dtype)


@pytest.mark.parametrize("m,k,dtype", QUANTIZE_CASES)
def test_quantize_kernel_matches_plain_exactly(cuda, m, k, dtype):
    """Against the plain version on the CPU, where its divisions are true ones, bit
    for bit, ties included; two launches give the same bits."""
    x = _quantize_input(m + k, m, k, dtype)
    xd = x.to(cuda)
    before = sb.LAUNCHES["quantize"]
    q, s = sb.quantize_rowwise(xd)
    q2, s2 = sb.quantize_rowwise(xd)
    torch.cuda.synchronize()
    assert sb.LAUNCHES["quantize"] == before + 2
    pq, ps = sb.quantize_rowwise_plain(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.shape == (m, k)
    assert torch.equal(s.cpu(), ps), (s.cpu() != ps).sum().item()
    assert torch.equal(q.cpu(), pq), (q.cpu() != pq).sum().item()
    assert torch.equal(q, q2) and torch.equal(s, s2)


def test_quantize_kernel_takes_misaligned_and_batched_rows(cuda):
    """A base off its 16-byte boundary takes the any-row kernel; a 3-D input keeps its
    leading axes."""
    x = _quantize_input(3, 40, 64, torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    xd = buf[1:].view(40, 64)
    xd.copy_(x)
    q, s = sb.quantize_rowwise(xd)
    pq, ps = sb.quantize_rowwise_plain(x)
    assert torch.equal(q.cpu(), pq) and torch.equal(s.cpu(), ps)
    q3, s3 = sb.quantize_rowwise(x.view(4, 10, 64).to(cuda))
    assert q3.shape == (4, 10, 64) and s3.shape == (4, 10)
    assert torch.equal(q3.cpu().view(40, 64), pq) and torch.equal(s3.cpu().view(40), ps)


@pytest.mark.parametrize("what", ["fp16", "transposed", "empty_rows"])
def test_quantize_wrapper_raises_on_what_the_kernel_does_not_take(cuda, what):
    x = torch.randn(8, 16, device=cuda)
    if what == "fp16":
        x = x.half()
    elif what == "transposed":
        x = x.t()
    else:
        x = x[:, :0]
    before = sb.LAUNCHES["quantize"]
    with pytest.raises(ValueError):
        sb.quantize_rowwise(x)
    assert sb.LAUNCHES["quantize"] == before


def test_switchback_forward_launches_two_quantizations_and_one_product(cuda):
    x = torch.randn(4, 77, 1024, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(4096, 1024, device=cuda) * 0.02
    before = dict(sb.LAUNCHES)
    torch.ops.oct.switchback_fwd(x.view(-1, 1024), w)
    assert sb.LAUNCHES == {"fwd": before["fwd"] + 1, "quantize": before["quantize"] + 2}
