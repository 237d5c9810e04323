"""Optimizer construction (counterpart of ``open_clip_tpu/train/optim.py``): AdamW.

``create_optimizer`` gives the arithmetic of the JAX package's optax chain, in
its order: clip by global norm (``g`` unchanged below the limit, else
``g / norm * clip``; no epsilon is added to the norm), Adam's moments with bias
correction and ``eps`` outside the square root, ``+ wd * p`` on the leaves the
weight-decay mask selects, ``* -lr(count)`` with the schedule read at the
optimizer's own count (0 on the first step), then ``p + update``.

The optimizer itself holds no tensors: its state (count and the two moments) is
a dict made by ``init`` and kept in the train state, as optax keeps it. Updates
are made in place with ``torch._foreach_*`` (the JAX package has no kernel of its
own here either). Under FSDP2 (``parallel.mesh.shard_model``) the parameters and
their gradients are sharded: the moments are made with the parameters' sharding,
the update runs on each rank's shards, and the global norm sums the squares of the
shards over the ranks that hold them, so clipping sees the whole gradient as
``clip_by_global_norm`` does. Other optimizers are not ported yet and raise.

Fine-tuning follows the JAX chain's order: layer-wise lr decay
(``layer_decay_scales``) multiplies the update after the weight decay is added and
before ``* -lr``, so it scales the decay term too; tower locking
(``trainable_mask``, ``apply_trainable_mask``) multiplies the final update, so a
locked tower's gradients still count in the global norm that clipping divides by,
and its moments still move. Both are one value per parameter, except on the Swin and
HTSAT ``blocks`` lists: the JAX rules take the first axis of every leaf under
``blocks`` for a stacked layer axis, and those leaves are unstacked, so their
values run along that axis of the JAX layout (the second axis of a port
``nn.Linear`` weight). The port follows it (ROADMAP, the reference's faults).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import is_sharded, local_tensor

# a per-parameter factor: one number, or a tensor that broadcasts to the parameter
Factor = Union[float, torch.Tensor]

# the relative-position table of the Swin towers is a bias: the JAX mask leaves it
# out by its shape, the reference by its name
NO_WD_NAMES = {"positional_embedding", "class_embedding", "cls_emb", "logit_scale",
               "logit_bias", "query", "relative_position_bias_table"}
_MU_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class OptimizerCfg:
    """The knobs of the JAX package's ``OptimizerCfg``."""

    opt: str = "adamw"
    lr: float = 5e-4
    wd: float = 0.2
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    momentum: float = 0.9
    wd_exclude_names: Tuple[str, ...] = ()
    wd_exclude_patterns: Tuple[str, ...] = ()
    layer_decay: Optional[float] = None
    image_layer_decay: Optional[float] = None
    text_layer_decay: Optional[float] = None
    audio_layer_decay: Optional[float] = None
    grad_clip_norm: Optional[float] = None
    # dtype of Adam's first moment ("bfloat16" halves its memory); None: the parameter's
    mu_dtype: Optional[str] = None


def get_default_params(model_name: str) -> Dict[str, float]:
    """Model-family default hyper-parameters."""
    model_name = (model_name or "").lower()
    if "vit" in model_name or "coca" in model_name or "siglip" in model_name:
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


def _named(params: Union[nn.Module, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def wd_mask(params: Union[nn.Module, Dict[str, torch.Tensor]], extra_names: Sequence[str] = (),
            patterns: Sequence[str] = ()) -> Dict[str, bool]:
    """name -> True where weight decay applies: tensors of 2 or more dimensions whose
    dotted name holds none of the excluded names and matches none of the glob
    ``patterns``, as the JAX package's mask answers for the same parameter.

    The JAX mask takes every leaf under a ``blocks`` key for a layer-stacked one and
    counts one dimension less. The port's ViT and text stacks are ``resblocks`` (one
    module per layer, no stacked axis), where both rules agree; the Swin and HTSAT
    blocks are ``blocks`` lists in both packages, unstacked in JAX too, so their 2-D
    weights count as 1-D there and get no decay. The port follows the JAX package
    (the upstream reference decays them; ROADMAP Queue C 4)."""
    exclude = NO_WD_NAMES | set(extra_names)
    regexes = [re.compile(p.replace(".", r"\.").replace("*", ".*")) for p in patterns]

    def decays(name: str, p: torch.Tensor) -> bool:
        parts = name.split(".")
        if any(part in exclude for part in parts):
            return False
        if any(r.fullmatch(name) for r in regexes):
            return False
        return p.ndim - ("blocks" in parts) > 1

    return {name: decays(name, p) for name, p in _named(params).items()}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32 (a 0-dim tensor). Of a
    sharded tensor each rank holds a part: the parts' squared norms are summed over
    the ranks that share it out (the fsdp group, one all-reduce for all of them) into
    the tensor's norm. On a group of one that is the same number, bit for bit, as
    the norm of the whole tensor (sqrt of a rounded square returns the value)."""
    tensors = list(tensors)
    parts = [i for i, t in enumerate(tensors) if is_sharded(t)]
    norms = torch.stack(torch._foreach_norm([local_tensor(t).float() for t in tensors]))
    if parts:
        first = tensors[parts[0]]
        dims = [i for i, p in enumerate(first.placements) if p.is_shard()]
        if len(dims) != 1:
            raise NotImplementedError(f"global norm of tensors sharded as {first.placements}")
        sq = norms[parts].square()
        dist.all_reduce(sq, group=first.device_mesh.get_group(dims[0]))
        norms = norms.index_copy(0, torch.tensor(parts, device=norms.device), sq.sqrt())
    return torch.linalg.vector_norm(norms)


_BLOCK_RE = re.compile(r"(?:^|\.)transformer\.resblocks\.(\d+)\.")


def _tower(name: str) -> str:
    """The JAX tree's top-level key of a port parameter: the text tower's parts sit
    at the port's top level, under ``text`` in the JAX tree."""
    head = name.split(".")[0]
    return head if head in ("visual", "audio", "logit_scale", "logit_bias") else "text"


def _stack_depths(names: Iterable[str]) -> Dict[str, int]:
    """tower -> its count of ``transformer.resblocks`` (the JAX tree's stacked
    ``blocks``); a tower without them (Swin, HTSAT) is absent."""
    depths: Dict[str, int] = {}
    for name in names:
        m = _BLOCK_RE.search(name)
        if m:
            t = _tower(name)
            depths[t] = max(depths.get(t, 0), int(m.group(1)) + 1)
    return depths


def _along_first_jax_axis(name: str, p: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` (one per row of the JAX leaf's first axis) shaped to broadcast
    over the port's ``p``: a 2-D ``.weight`` is the transpose of the JAX kernel."""
    if p.ndim == 2 and name.endswith(".weight"):
        return values.reshape(1, -1)
    return values.reshape((-1,) + (1,) * (p.ndim - 1))


def layer_decay_scales(params: Union[nn.Module, Dict[str, torch.Tensor]], decay: Optional[float],
                       num_layers: Optional[int] = None,
                       tower_decay: Optional[Dict[str, Optional[float]]] = None
                       ) -> Dict[str, Factor]:
    """name -> the lr scale of layer-wise decay, the JAX package's
    ``layer_decay_scales`` per parameter: block i of a tower's n stacked blocks
    d^(n - i), the other parameters of a tower of depth L d^(L + 1), the projections,
    ``ln_post``, ``ln_final`` and the logit scale and bias 1. ``tower_decay`` sets d
    per tower (``visual``, ``text``, ``audio``; else ``decay``); a tower's depth is
    its block count, else ``num_layers``; d of None or >= 1 or no depth gives 1."""
    named = _named(params)
    depths = _stack_depths(named)
    out: Dict[str, Factor] = {}
    for name, p in named.items():
        tower = _tower(name)
        d = (tower_decay or {}).get(tower, decay)
        depth = depths.get(tower) or num_layers
        parts = name.split(".")
        if d is None or d >= 1.0 or not depth:
            out[name] = 1.0
            continue
        m = _BLOCK_RE.search(name)
        if m:
            n = depths[tower]
            out[name] = float(np.float32(d) ** np.float32(n - int(m.group(1))))
        elif "blocks" in parts:
            n = p.shape[1] if p.ndim == 2 and name.endswith(".weight") else p.shape[0]
            ladder = np.float32(d) ** (np.float32(n) - np.arange(n, dtype=np.float32))
            out[name] = _along_first_jax_axis(name, p, torch.from_numpy(ladder))
        elif name in ("visual.proj", "text_projection", "logit_scale", "logit_bias") or \
                "ln_post" in parts or "ln_final" in parts:
            out[name] = 1.0
        else:
            out[name] = float(np.float32(d ** (depth + 1)))
    return out


# the parts of a tower that ``unlocked_groups > 0`` leaves trainable (the JAX names;
# the port's ViT ``attn_pool`` is the JAX ``map_pool``)
HEAD_NAMES = {"proj", "text_projection", "ln_post", "ln_final", "attn_pool",
              "attn_pool_contrastive", "map_pool", "attnpool", "head", "pool"}


def trainable_mask(params: Union[nn.Module, Dict[str, torch.Tensor]], lock_image: bool = False,
                   lock_image_unlocked_groups: int = 0, lock_text: bool = False,
                   lock_text_unlocked_layers: int = 0) -> Dict[str, Factor]:
    """name -> 1.0 where the parameter trains, 0.0 where its tower is locked, as
    the JAX package's ``trainable_mask`` answers: the groups of a tower are
    [embeddings, block 0 .. block L-1, head]; ``unlocked`` k > 0 keeps the head
    trainable and k > 1 the last k - 1 blocks too."""
    named = _named(params)
    depths = _stack_depths(named)
    out: Dict[str, Factor] = {}
    for name, p in named.items():
        tower = _tower(name)
        locked = (tower == "visual" and lock_image) or (tower == "text" and lock_text)
        if not locked:
            out[name] = 1.0
            continue
        unlocked = lock_image_unlocked_groups if tower == "visual" else lock_text_unlocked_layers
        parts = name.split(".")[1 if tower == "visual" else 0:]
        m = _BLOCK_RE.search(name)
        if unlocked > 0 and HEAD_NAMES.intersection(parts):
            out[name] = 1.0
        elif unlocked > 1 and m:
            out[name] = float(int(m.group(1)) >= depths[tower] - (unlocked - 1))
        elif unlocked > 1 and "blocks" in parts:
            n = p.shape[1] if p.ndim == 2 and name.endswith(".weight") else p.shape[0]
            keep = (torch.arange(n) >= n - (unlocked - 1)).float()
            out[name] = _along_first_jax_axis(name, p, keep)
        else:
            out[name] = 0.0
    return out


class AdamW:
    """Clip, Adam, decoupled weight decay, the layer-decay scales and the schedule,
    then the trainable mask, applied in place."""

    def __init__(self, cfg: OptimizerCfg, decay: List[bool], schedule: Callable[[int], float],
                 scales: Optional[List[Factor]] = None):
        self.cfg = cfg
        self.decay = decay
        self.schedule = schedule
        self.mu_dtype = _MU_DTYPES[cfg.mu_dtype]
        self.scales = None if scales is None else _Factors(scales)  # None: no layer decay
        self.mask: Optional[_Factors] = None  # None: every tensor trains

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        """Zero moments beside ``params`` (in their order; sharded as they are) and a
        count of 0."""
        if len(params) != len(self.decay):
            raise ValueError(f"optimizer was built for {len(self.decay)} tensors, got {len(params)}")
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: Dict) -> torch.Tensor:
        """One step in place on ``params`` and ``state``; returns the global norm of
        ``grads`` before clipping. Does not wait for the device."""
        cfg = self.cfg
        norm = global_norm(grads)
        # sharded tensors update shard by shard: their local parts are views
        params, grads = [local_tensor(p) for p in params], [local_tensor(g) for g in grads]
        moments = {k: [local_tensor(m) for m in state[k]] for k in ("mu", "nu")}
        if cfg.grad_clip_norm:
            below = norm < cfg.grad_clip_norm
            one = torch.ones_like(norm)
            # below the limit g / 1 * 1 is g exactly; above it (g / norm) * clip
            grads = torch._foreach_div(grads, torch.where(below, one, norm))
            torch._foreach_mul_(grads, torch.where(below, one, one * cfg.grad_clip_norm))
        count = state["count"] + 1
        # the moment is kept in mu_dtype; the step's arithmetic is in the gradient's dtype
        mu = moments["mu"] if self.mu_dtype is None else [m.to(g.dtype)
                                                          for m, g in zip(moments["mu"], grads)]
        torch._foreach_mul_(mu, cfg.beta1)
        torch._foreach_add_(mu, grads, alpha=1 - cfg.beta1)
        if self.mu_dtype is not None:
            torch._foreach_copy_(moments["mu"], mu)
        nu = moments["nu"]
        torch._foreach_mul_(nu, cfg.beta2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - cfg.beta2)
        denom = torch._foreach_div(nu, 1 - cfg.beta2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        updates = torch._foreach_div(mu, 1 - cfg.beta1 ** count)
        torch._foreach_div_(updates, denom)
        if cfg.wd:
            picked = [(u, p) for u, p, d in zip(updates, params, self.decay) if d]
            if picked:
                torch._foreach_add_([u for u, _ in picked], [p for _, p in picked], alpha=cfg.wd)
        if self.scales is not None:
            self.scales.mul_(updates)
        torch._foreach_mul_(updates, -self.schedule(state["count"]))
        if self.mask is not None:
            self.mask.mul_(updates)
        torch._foreach_add_(params, updates)
        state["count"] = count
        return norm


class _Factors:
    """Per-tensor factors (one number, or a tensor that broadcasts), sorted once: a
    factor of 1 is skipped (x * 1 is x, bit for bit), the other numbers go to one
    ``_foreach_mul_``."""

    def __init__(self, factors: Sequence[Factor]):
        self.numbers = [(i, float(f)) for i, f in enumerate(factors)
                        if not isinstance(f, torch.Tensor) and float(f) != 1.0]
        self.tensors = [(i, f) for i, f in enumerate(factors) if isinstance(f, torch.Tensor)]

    def mul_(self, updates: List[torch.Tensor]) -> None:
        """updates[i] *= factor i, in place. A tensor factor on a sharded update is
        refused (only the Swin and HTSAT lists have them, and they are not sharded)."""
        if self.numbers:
            torch._foreach_mul_([updates[i] for i, _ in self.numbers],
                                [f for _, f in self.numbers])
        for j, (i, f) in enumerate(self.tensors):
            u = updates[i]
            if u.shape != torch.broadcast_shapes(u.shape, f.shape):
                raise NotImplementedError(f"a per-row factor {tuple(f.shape)} on a sharded "
                                          f"update {tuple(u.shape)}")
            if f.device != u.device or f.dtype != u.dtype:
                f = f.to(u.device, u.dtype)
                self.tensors[j] = (i, f)  # moved to the update's device once
            u.mul_(f)


def create_optimizer(cfg: OptimizerCfg, params: Union[nn.Module, Dict[str, torch.Tensor]],
                     schedule: Callable[[int], float], num_layers: Optional[int] = None) -> AdamW:
    """The optimizer for a model (or a name -> tensor dict); its ``init`` and
    ``update_`` take the tensors in the order of ``named_parameters()``. Layer-wise
    lr decay is on where ``layer_decay`` or a tower's own factor is below 1, with
    ``num_layers`` the depth of a tower that has no stacked blocks (the JAX CLI passes
    the vision tower's layers)."""
    if cfg.opt.lower().replace("timm/", "") != "adamw":
        raise NotImplementedError(f"optimizer {cfg.opt!r} is not ported yet (adamw is)")
    if cfg.mu_dtype not in _MU_DTYPES:
        raise ValueError(f"mu_dtype {cfg.mu_dtype!r}; one of {sorted(map(str, _MU_DTYPES))}")
    mask = wd_mask(params, cfg.wd_exclude_names, cfg.wd_exclude_patterns)
    tower_decay = {t: own if own is not None else cfg.layer_decay for t, own in (
        ("visual", cfg.image_layer_decay), ("text", cfg.text_layer_decay),
        ("audio", cfg.audio_layer_decay))}
    scales = None
    if any(d is not None and d < 1.0 for d in (cfg.layer_decay, *tower_decay.values())):
        scales = list(layer_decay_scales(params, cfg.layer_decay, num_layers,
                                         tower_decay=tower_decay).values())
    return AdamW(cfg, list(mask.values()), schedule, scales)


def apply_trainable_mask(optimizer: AdamW, mask: Dict[str, Factor]) -> AdamW:
    """The optimizer with ``mask`` (``trainable_mask``, in ``named_parameters()``
    order) multiplying each final update: a 0 leaves that tensor as it was, bit for
    bit. Set in place; returns the optimizer."""
    if len(mask) != len(optimizer.decay):
        raise ValueError(f"mask of {len(mask)} tensors for an optimizer of {len(optimizer.decay)}")
    optimizer.mask = _Factors(list(mask.values()))
    return optimizer
