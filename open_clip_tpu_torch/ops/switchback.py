"""SwitchBack int8 linear: the CUDA kernels, their plain versions and the autograd
rule (counterpart of ``open_clip_tpu/ops/switchback.py``).

The forward product of a linear runs in int8: the activations are quantized per
row and the weight per output feature, the int8 product is summed in int32, and
the result is dequantized by the row times the column scale. The backward runs in
the activations' dtype (dx) and in fp32 (dw), the SwitchBack construction.

Two kernels, both in ``csrc/switchback.cu``:

- the product replaces the TPU kernel ``open_clip_tpu/ops/switchback.py:_int8_matmul_kernel``.
  It takes the weight in ``nn.Linear``'s (N, K) layout, quantized per row of that
  tensor, which is the JAX package's per-column quantization of its (K, N) kernel: it
  computes ``qx @ qwᵀ``. The JAX wrapper's zero padding of M, N and K to its tiles is
  left out: the kernel fills the ragged edges with zeros itself. Two bodies:
  ``matmul_body`` picks ``wgmma`` (int8 ``wgmma`` fed by TMA, persistent) where TMA
  can read the operands, else ``mma`` (``mma.sync``), by shape alone;
- the row-wise quantization, one pass over the rows, which the JAX package leaves
  to XLA's fusion outside its kernel.

``int8_matmul_dequant`` and ``quantize_rowwise`` launch their kernels for CUDA
tensors or raise; for CPU tensors, and only for them, they compute
``int8_matmul_dequant_plain`` and ``quantize_rowwise_plain``, which the kernels
equal bit for bit. ``LAUNCHES`` counts the kernels' launches, ``FWD_BODIES`` the
product's by body. ``switchback_linear`` is the differentiable linear. Its forward
is the custom op ``oct::switchback_fwd`` (quantize both operands, then the
product), one op to ``torch.utils.checkpoint``'s selective policies, so that a
remat preset can save its output (``models/blocks.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .layers import remat_name

# |acc| <= 127**2 * K must fit in int32
MAX_K = (2 ** 31 - 1) // 127 ** 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the kernels since the last reset, and of the product by body;
# chip_smoke.py sets and reads them
LAUNCHES = {"fwd": 0, "quantize": 0}
FWD_BODIES = {"wgmma": 0, "mma": 0}
_BODY_CODES = {"mma": 0, "wgmma": 1}

_fns = {}


def matmul_body(k: int, aligned: bool) -> str:
    """The product's body for inner size ``k`` and whether qx and qw start on 16-byte
    boundaries: ``wgmma`` where TMA can read both operands (every row stride a
    multiple of 16 bytes, aligned bases), else ``mma``."""
    return "wgmma" if k % 16 == 0 and aligned else "mma"


def quantize_rowwise_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8 values, per-row fp32 scales): q = round(x / (absmax / 127)),
    rounding half to even, with a true division in fp32 as in the JAX package.
    The absmax is taken in x's dtype (exact in any float type) and the division
    promotes x to fp32 exactly, so no fp32 copy of x is made; round and clamp
    work in place. Its result is defined on the CPU: on a CUDA tensor PyTorch
    computes ``/ 127.0`` (a host scalar) as a product with its fp32 reciprocal,
    which may differ from the division in the last bit of a scale."""
    absmax = x.abs().amax(dim=-1, keepdim=True).float()
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.div(x, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale[..., 0]


def _library(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ._build import load

        fn = getattr(load("switchback"), name)
        if name == "oct_int8_matmul_dequant":
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"quantize_rowwise: no kernel for {x.dtype} (float32, bfloat16)")
    if x.dim() == 0 or x.shape[-1] == 0 or not x.is_contiguous():
        raise ValueError(f"quantize_rowwise: x {tuple(x.shape)} must be contiguous with rows "
                         "of at least one value")
    k = x.shape[-1]
    m = x.numel() // k
    if m >= 2 ** 31:
        raise ValueError(f"quantize_rowwise: {m} rows (at most 2**31 - 1)")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if m == 0:  # nothing to launch for
        return q, scale
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library("oct_quantize_rowwise")(x.data_ptr(), q.data_ptr(), scale.data_ptr(), m, k,
                                               _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"quantize_rowwise kernel launch failed: cudaError {err}")
    LAUNCHES["quantize"] += 1
    return q, scale


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8 values, per-row fp32 scales) over the last axis, as
    ``quantize_rowwise_plain`` computes them on the CPU: the kernel for CUDA tensors
    (bf16, fp32; contiguous), or raise; the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return quantize_rowwise_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rowwise: no kernel for device {x.device}")
    return _launch_quantize(x)


def quantize_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An (in, out) kernel -> int8 values and per-output-column fp32 scales."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=0, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale[0]


def int8_matmul_dequant_plain(qx: torch.Tensor, qw: torch.Tensor, sx: torch.Tensor,
                              sw: torch.Tensor, out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel. There is no integer matrix product on
    CUDA, so the sums are taken in float64, exact while 127**2 * K < 2**53; the
    conversion of an exact integer to fp32 then rounds as int32 -> fp32 does."""
    acc = (qx.double() @ qw.double().t()).float()
    return ((acc * sx[:, None]) * sw[None, :]).to(out_dtype)


def _check(qx, qw, sx, sw, out_dtype) -> None:
    if qx.dim() != 2 or qw.dim() != 2 or qx.shape[1] != qw.shape[1]:
        raise ValueError(f"int8_matmul_dequant: qx {tuple(qx.shape)} and qw {tuple(qw.shape)} "
                         "must be (M, K) and (N, K)")
    m, k = qx.shape
    n = qw.shape[0]
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f"int8_matmul_dequant: qx, qw must be int8, got {qx.dtype}, {qw.dtype}")
    if (sx.shape != (m,) or sw.shape != (n,) or sx.dtype != torch.float32
            or sw.dtype != torch.float32):
        raise ValueError(f"int8_matmul_dequant: scales must be fp32 ({m},) and ({n},), got "
                         f"{tuple(sx.shape)} {sx.dtype} and {tuple(sw.shape)} {sw.dtype}")
    if k > MAX_K:
        raise ValueError(f"int8_matmul_dequant: K = {k} overflows the int32 sum "
                         f"(127**2 * K must stay below 2**31: K <= {MAX_K})")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul_dequant: out_dtype {out_dtype} (float32, bfloat16)")


def _launch(qx, qw, sx, sw, out_dtype) -> torch.Tensor:
    tensors = (qx, qw, sx, sw)
    if any(t.device != qx.device for t in tensors) or not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_matmul_dequant: qx, qw, sx, sw must be contiguous and on one device")
    m, k = qx.shape
    n = qw.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=qx.device)
    if m == 0 or n == 0 or k == 0:  # nothing to launch for
        return out.zero_()
    body = matmul_body(k, qx.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0)
    with torch.cuda.device(qx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library("oct_int8_matmul_dequant")(
            qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(), m, n, k,
            _DTYPE_CODES[out_dtype], _BODY_CODES[body], stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul_dequant kernel launch failed ({body} body): "
                           f"cudaError {err}")
    FWD_BODIES[body] += 1
    LAUNCHES["fwd"] += 1
    return out


def int8_matmul_dequant(qx: torch.Tensor, qw: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(float(qx @ qwᵀ) * sx[:, None]) * sw[None, :] in ``out_dtype`` (fp32 or bf16).
    qx (M, K) and qw (N, K) int8, sx (M,) and sw (N,) fp32. The kernel for CUDA
    tensors (the body ``matmul_body`` picks), or raise; the plain version for CPU
    tensors."""
    _check(qx, qw, sx, sw, out_dtype)
    if qx.device.type == "cpu":
        return int8_matmul_dequant_plain(qx, qw, sx, sw, out_dtype)
    if qx.device.type != "cuda":
        raise ValueError(f"int8_matmul_dequant: no kernel for device {qx.device}")
    return _launch(qx, qw, sx, sw, out_dtype)


@torch.library.custom_op("oct::switchback_fwd", mutates_args=())
def switchback_fwd(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dequant(int8(x) @ int8(weight)ᵀ) in x.dtype, for 2-D x (M, K) and the
    (N, K) weight in its own dtype (the fp32 master weight under amp_bf16, as
    the JAX package quantizes it). The fp32 result rounded once to bf16 equals
    the kernel's bf16 output, so the kernel writes x.dtype directly."""
    qx, sx = quantize_rowwise(x)
    qw, sw = quantize_rowwise(weight)
    out_dtype = x.dtype if x.dtype in _DTYPE_CODES else torch.float32
    return int8_matmul_dequant(qx, qw, sx, sw, out_dtype).to(x.dtype)


class _SwitchBack(torch.autograd.Function):
    """int8 forward; dx = g @ w in g's dtype, dw = gᵀ x in fp32 cast to the weight's
    dtype. Saves x and the weight, never the int8 tensors."""

    @staticmethod
    def forward(ctx, x2, weight):
        ctx.save_for_backward(x2, weight)
        return torch.ops.oct.switchback_fwd(x2, weight)

    @staticmethod
    def backward(ctx, g):
        x2, weight = ctx.saved_tensors
        dx = g @ weight.to(g.dtype)
        return dx, _weight_grad(g, x2).to(weight.dtype)


def _weight_grad(g: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """gᵀ x in fp32. For bf16 operands on the card, one bf16 product with fp32
    accumulation and output: the products of bf16 values are exact in fp32, so it
    is the fp32 product of the upcast operands, on the tensor cores instead of the
    CUDA cores (an fp32 GEMM with TF32 off)."""
    if (g.is_cuda and g.dtype == torch.bfloat16 and x2.dtype == torch.bfloat16
            and hasattr(torch.ops.aten.mm, "dtype")):
        return torch.ops.aten.mm.dtype(g.t(), x2, torch.float32)
    return g.float().t() @ x2.float()


def switchback_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      *, name: Optional[str] = None) -> torch.Tensor:
    """y = dequant(int8(x) @ int8(weight)ᵀ) + bias over the last axis of x, with
    ``nn.Linear``'s (out, in) weight. The product is cast to x.dtype, then the bias
    is added in that dtype: two roundings, as in the JAX package. ``name``: the
    remat tag of the product (``ops/layers.py:remat_name``)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    with remat_name(name):
        y = _SwitchBack.apply(x2, weight)
    y = y.view(*shape[:-1], weight.shape[0])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
