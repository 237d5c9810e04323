"""ModifiedResNet image tower, the OpenAI RN50 family (counterpart of
``open_clip_tpu/models/resnet.py``).

A stem of three 3x3 convolutions (the first at stride 2), each with BatchNorm and
ReLU, and a 2x2 average pool; four stages of Bottleneck blocks whose stride-2
downsampling is an average pool before the third convolution and on the shortcut
(the reference's antialiasing); then the QKV attention pool, whose query is the mean
token. Images come in NHWC and the tower runs them as ``channels_last`` NCHW views of
the same memory, so cuDNN takes its NHWC path and no convolution pays a permute. The
modules hold PyTorch's (out, in, kh, kw) kernels; the JAX tree's are HWIO
(``params_from_jax`` and the reference converter carry both).

BatchNorm is the JAX ``batch_norm``: statistics and affine in float32, the output in
the compute dtype, eps 1e-5. In training (``train`` and not ``bn_eval``) it
normalizes by the batch's statistics and, given a ``stats_sink`` list, appends each
layer's batch mean and unbiased variance to it; the train step folds them into the
running statistics after the optimizer's update (``merge_bn_stats_``, momentum 0.1).
Otherwise it normalizes by the running statistics, read detached. Those are
parameters, as they are leaves of the JAX tree: they sit in the optimizer's order,
the EMA and the checkpoint, never get a gradient from the loss (the train step gives
them zero ones: ``CLIPModel.params_outside_loss``), and so AdamW leaves them as they
are (1-D: no weight decay).

Names follow the reference checkpoint (``conv1``, ``bn1.running_mean``,
``layer1.0.downsample.0`` / ``.1``, ``attnpool.q_proj``). The attention pool keeps
the JAX rounding points: logits from the compute dtype's q and k accumulated in
float32, softmax in float32; it projects the query of the pooled token alone, since
row 0 of the JAX computation depends on no other query row. The tower has no remat,
as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPVisionCfg
from ..ops.layers import conv2d, linear

EXPANSION = 4
BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# (batch norm, batch mean, unbiased batch variance) of each layer a training forward ran
StatsSink = List[Tuple["BatchNorm2d", torch.Tensor, torch.Tensor]]


class Conv2d(nn.Conv2d):
    """A bias-free convolution of the tower. Its kernel stays float32 under the pure
    precisions: the JAX tree holds the tower's kernels as bare leaves, which the JAX
    ``convert_params_dtype`` does not cast (``convert_params_dtype_`` skips them too)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__(cin, cout, k, stride, padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, None, self.stride, self.padding)


class BatchNorm2d(nn.Module):
    """Batch norm over the channels of an NCHW (``channels_last``) tensor; see the
    module docstring. The four entries are parameters, as in the JAX tree."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.running_mean = nn.Parameter(torch.zeros(n))
        self.running_var = nn.Parameter(torch.ones(n))

    def forward(self, x: torch.Tensor, batch_stats: bool = False,
                sink: Optional[StatsSink] = None) -> torch.Tensor:
        w, b = self.weight.float(), self.bias.float()
        if not batch_stats:
            return F.batch_norm(x, self.running_mean.detach().float(),
                                self.running_var.detach().float(), w, b, False, 0.0, BN_EPS)
        # momentum 1 writes the batch mean and the unbiased batch variance into the
        # two fresh tensors: one fused pass gives the output and what the sink records
        mean = torch.zeros(x.shape[1], device=x.device)
        var = torch.ones(x.shape[1], device=x.device)
        y = F.batch_norm(x, mean, var, w, b, True, 1.0, BN_EPS)
        if sink is not None:
            sink.append((self, mean, var))
        return y


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    return x if window <= 1 else F.avg_pool2d(x, window)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = Conv2d(inplanes, planes, 1), BatchNorm2d(planes)
        self.conv2, self.bn2 = Conv2d(planes, planes, 3, padding=1), BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * EXPANSION, 1)
        self.bn3 = BatchNorm2d(planes * EXPANSION)
        self.downsample = None
        if stride > 1 or inplanes != planes * EXPANSION:
            self.downsample = nn.ModuleDict({"0": Conv2d(inplanes, planes * EXPANSION, 1),
                                             "1": BatchNorm2d(planes * EXPANSION)})

    def forward(self, x: torch.Tensor, batch_stats: bool, sink: Optional[StatsSink]):
        out = F.relu(self.bn1(self.conv1(x), batch_stats, sink), inplace=True)
        out = F.relu(self.bn2(self.conv2(out), batch_stats, sink), inplace=True)
        out = self.bn3(self.conv3(avg_pool(out, self.stride)), batch_stats, sink)
        identity = x
        if self.downsample is not None:
            identity = self.downsample["1"](self.downsample["0"](avg_pool(x, self.stride)),
                                            batch_stats, sink)
        return F.relu(out + identity, inplace=True)


class AttentionPool2d(nn.Module):
    """The reference's ``AttentionPool2d``: (B, H, W, C) -> (B, output_dim)."""

    def __init__(self, spacial: int, width: int, heads: int, output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial * spacial + 1, width))
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(width, width) for _ in range(3))
        self.c_proj = nn.Linear(width, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        hd = c // self.heads

        def proj(t, m):
            return linear(t, m.weight, m.bias, transposed=True)

        q = proj(x[:, :1], self.q_proj).view(b, 1, self.heads, hd)
        k = proj(x, self.k_proj).view(b, -1, self.heads, hd)
        v = proj(x, self.v_proj).view(b, -1, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, 1, c)
        return proj(out, self.c_proj)[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: CLIPVisionCfg, embed_dim: int):
        super().__init__()
        width = cfg.width
        self.heads = width * 32 // cfg.head_width
        image_size = cfg.image_size if isinstance(cfg.image_size, int) else cfg.image_size[0]
        self.conv1, self.bn1 = Conv2d(3, width // 2, 3, stride=2, padding=1), BatchNorm2d(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1)
        self.bn2 = BatchNorm2d(width // 2)
        self.conv3, self.bn3 = Conv2d(width // 2, width, 3, padding=1), BatchNorm2d(width)
        inplanes = width
        for li, (n_blocks, stride) in enumerate(zip(cfg.layers, (1, 2, 2, 2)), start=1):
            planes = width * 2 ** (li - 1)
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, stride if bi == 0 else 1))
                inplanes = planes * EXPANSION
            setattr(self, f"layer{li}", nn.ModuleList(blocks))
        self.attnpool = AttentionPool2d(image_size // 32, width * 32, self.heads, embed_dim)

    def stages(self):
        return [getattr(self, f"layer{li}") for li in range(1, 5)]

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX ``init_modified_resnet`` distributions: convolution kernels
        uniform(+-1/sqrt(fan_in)), batch norms at the identity, the positional
        embedding N(0, width^-1/2), ``nn.Linear``'s default for the projections."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                bound = m.weight[0].numel() ** -0.5  # fan_in = kh * kw * in
                m.weight.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, BatchNorm2d):
                for p, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                             (m.running_var, 1.0)):
                    p.fill_(v)
        pool = self.attnpool
        pool.positional_embedding.normal_(0.0, pool.positional_embedding.shape[1] ** -0.5,
                                          generator=gen)
        for lin in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj):
            bound = lin.in_features ** -0.5
            lin.weight.uniform_(-bound, bound, generator=gen)
            lin.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32, *,
                train: bool = False, remat: bool = False,
                generator: Optional[torch.Generator] = None, bn_eval: bool = False,
                stats_sink: Optional[StatsSink] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized NHWC -> (B, embed_dim). ``train`` normalizes by the
        batch's statistics unless ``bn_eval`` (frozen statistics), recording them in
        ``stats_sink``; ``remat`` and ``generator`` are unused (no remat, no noise)."""
        batch_stats = train and not bn_eval
        sink = stats_sink if batch_stats else None
        x = x.to(compute_dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x), batch_stats, sink), inplace=True)
        x = avg_pool(x, 2)
        for stage in self.stages():
            for blk in stage:
                x = blk(x, batch_stats, sink)
        return self.attnpool(x.permute(0, 2, 3, 1))


@torch.no_grad()
def merge_bn_stats_(sink: StatsSink) -> None:
    """Fold the batch statistics in ``sink`` into each layer's running statistics in
    place, the JAX ``_merge_bn_stats``: (1 - m) * running + m * batch, in float32,
    at m = ``BN_MOMENTUM``."""
    for bn, mean, var in sink:
        for run, batch in ((bn.running_mean, mean), (bn.running_var, var)):
            run.copy_((1 - BN_MOMENTUM) * run + BN_MOMENTUM * batch.to(run.dtype))


# ---------------------------------------------------------------------------
# weights: the JAX tree -> the port's names, and the reference layout -> the JAX tree
# ---------------------------------------------------------------------------

_BN_LEAVES = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
              ("var", "running_var"))
_BLOCK_ENTRIES = {"conv1", "bn1", "conv2", "bn2", "conv3", "bn3", "downsample"}


def params_from_jax(vis: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    """The JAX ``init_modified_resnet`` tree into ``out`` under the port's names
    (``visual.*``): HWIO kernels become (out, in, kh, kw)."""
    from ..convert import _linear, _t

    def conv(kernel, name):
        out[f"visual.{name}.weight"] = _t(np.asarray(kernel).transpose(3, 2, 0, 1)).contiguous()

    def bn(node, name):
        for src, dst in _BN_LEAVES:
            out[f"visual.{name}.{dst}"] = _t(node[src])

    for i in (1, 2, 3):
        conv(vis[f"conv{i}"], f"conv{i}")
        bn(vis[f"bn{i}"], f"bn{i}")
    for li in range(1, 5):
        for bi, blk in vis[f"layer{li}"].items():
            extra = set(blk) - _BLOCK_ENTRIES
            if extra:
                raise KeyError(f"JAX ResNet block layer{li}/{bi} holds {sorted(extra)}, which the "
                               "port does not have")
            pre = f"layer{li}.{bi}"
            for i in (1, 2, 3):
                conv(blk[f"conv{i}"], f"{pre}.conv{i}")
                bn(blk[f"bn{i}"], f"{pre}.bn{i}")
            if "downsample" in blk:
                conv(blk["downsample"]["conv"], f"{pre}.downsample.0")
                bn(blk["downsample"]["bn"], f"{pre}.downsample.1")
    ap = vis["attnpool"]
    out["visual.attnpool.positional_embedding"] = _t(ap["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(ap[name], f"visual.attnpool.{name}", out)


def torch_resnet_clip_to_params(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """An OpenAI RN-family CLIP state dict (``visual.*`` ModifiedResNet and the text
    tower; numpy leaves) -> the JAX package's tree, as its
    ``torch_resnet_clip_to_params`` makes it: OIHW kernels to HWIO, ``downsample.0`` /
    ``.1`` to ``downsample.conv`` / ``.bn``; ``num_batches_tracked`` is not read."""
    from ..convert import torch_clip_to_params

    text_sd = {k: v for k, v in sd.items() if not k.startswith("visual.")}
    tree = torch_clip_to_params(text_sd, cfg) if text_sd else {}

    def conv(key):
        return sd[key].transpose(2, 3, 1, 0)

    def bn(prefix):
        return {src: sd[f"{prefix}.{dst}"] for src, dst in _BN_LEAVES}

    v: Dict[str, Any] = {}
    for i in (1, 2, 3):
        v[f"conv{i}"] = conv(f"visual.conv{i}.weight")
        v[f"bn{i}"] = bn(f"visual.bn{i}")
    for li in range(1, 5):
        stage: Dict[str, Any] = {}
        bi = 0
        while f"visual.layer{li}.{bi}.conv1.weight" in sd:
            pre = f"visual.layer{li}.{bi}"
            bp: Dict[str, Any] = {}
            for i in (1, 2, 3):
                bp[f"conv{i}"] = conv(f"{pre}.conv{i}.weight")
                bp[f"bn{i}"] = bn(f"{pre}.bn{i}")
            if f"{pre}.downsample.0.weight" in sd:
                bp["downsample"] = {"conv": conv(f"{pre}.downsample.0.weight"),
                                    "bn": bn(f"{pre}.downsample.1")}
            stage[str(bi)] = bp
            bi += 1
        v[f"layer{li}"] = stage
    ap = "visual.attnpool"
    v["attnpool"] = {"positional_embedding": sd[f"{ap}.positional_embedding"],
                     **{name: {"kernel": sd[f"{ap}.{name}.weight"].T,
                               "bias": sd[f"{ap}.{name}.bias"]}
                        for name in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    tree["visual"] = v
    return tree
