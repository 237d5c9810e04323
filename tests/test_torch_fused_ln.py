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

torch.set_num_threads(1)  # one intra-op thread a test process: see test_torch_layers.py

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


# ---------------------------------------------------------------------------
# the CUDA kernel's launch plan (computed in Python; the kernel runs on the card)
# ---------------------------------------------------------------------------

PLAN_WIDTHS = [4, 12, 20, 64, 128, 256, 512, 640, 768, 1024, 1028, 2048, 4096]
PLAN_ROWS = [1, 3, 7, 255, 8192, 524288]
H100_SMS = 132
SMEM_227_KB = 232448


@pytest.mark.parametrize("rows", PLAN_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("width", PLAN_WIDTHS)
def test_launch_plan(width, dtype, rows):
    plan = pfl.launch_plan(rows, width, dtype, H100_SMS)
    size = torch.empty((), dtype=dtype).element_size()
    assert plan.smem_bytes <= SMEM_227_KB
    assert 1 <= plan.blocks <= min(rows, H100_SMS)
    assert 1 <= plan.fold_slices <= min(pfl.MAX_FOLD_SLICES, plan.blocks)
    assert 2 <= plan.stages <= pfl.MAX_STAGES
    # a thread's chunks cover the row, in a body the kernel is built for
    assert plan.lanes * plan.nv * plan.vec >= width and width % plan.vec == 0
    assert plan.nv in pfl._NV[plan.lanes] and plan.vec * size in (8, 16)
    # a warpgroup owns a row past WARP_ROW_WIDTH and where the rows do not fill every
    # consumer warp of the card
    assert (plan.lanes <= 32) == (width <= pfl.WARP_ROW_WIDTH
                                  and rows >= pfl.CONSUMER_WARPS * H100_SMS)
    # every row exactly once: the tiles cut [0, rows) in order; every block gets rows,
    # and the blocks' rows differ by two at most
    t = plan.tile_table()
    assert t["first"][0] == 0 and (t["rows"] >= 1).all() and t["rows"].sum() == rows
    assert (t["first"][1:] == t["first"][:-1] + t["rows"][:-1]).all()
    assert (t["rows"] <= plan.rows_per_tile).all()
    assert np.array_equal(np.unique(t["block"]), np.arange(plan.blocks))
    share = np.bincount(t["block"], weights=t["rows"], minlength=plan.blocks)
    assert share.max() - share.min() <= 2
    # every bulk copy starts 16-byte aligned and moves a multiple of 16 bytes, in the
    # stage for x and in the one for dy; what no copy moves (at most the last tile's
    # last row) goes to the plain loads
    assert plan.rows_per_tile % 2 == 0 and plan.stage_bytes % 128 == 0
    assert plan.rows_per_tile * width * size % 16 == 0
    assert (t["offset"] % 16 == 0).all() and (t["bytes"] % 16 == 0).all()
    assert (t["first"] % 2 == 0).all()
    plain = t["rows"] - t["bulk_rows"]
    assert set(plain[:-1].tolist()) <= {0} and plain[-1] in (0, 1)
    assert plain[-1] == (1 if size == 2 and width % 8 == 4 and t["rows"][-1] % 2 else 0)
    if rows * 2 * width * size >= H100_SMS * 4 * 32 * 1024:  # enough for 4 stages an SM:
        # at least ~32 KB of x and dy in flight an SM
        assert (plan.stages - 1) * 2 * plan.rows_per_tile * width * size >= 32 * 1024


def test_launch_plan_takes_only_what_the_kernel_takes():
    for bad in ((8, 6, torch.float32), (8, 4100, torch.float32), (8, 64, torch.float16),
                (0, 64, torch.float32)):
        with pytest.raises(ValueError):
            pfl.launch_plan(*bad, H100_SMS)


def test_every_planned_body_is_built():
    """Each (dtype, vec, lanes, nv) a plan can name is instantiated in the CUDA source."""
    import re
    from pathlib import Path

    src = (Path(pfl.__file__).resolve().parent.parent / "csrc" / "layer_norm_bwd.cu").read_text()
    built = {(m[0], int(m[1]), int(m[2]), int(m[3]))
             for m in re.findall(r"OCT_LN_CASE\((float|__nv_bfloat16), (\d+), (\d+), (\d+)\)", src)}
    names = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    wanted = set()
    for dtype in names:
        for width in range(4, pfl.MAX_WIDTH + 1, 4):
            for rows in (1, 4096):
                p = pfl.launch_plan(rows, width, dtype, H100_SMS)
                wanted.add((names[dtype], p.vec, p.lanes, p.nv))
    assert wanted <= built, sorted(wanted - built)
