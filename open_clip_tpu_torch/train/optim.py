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
``clip_by_global_norm`` does. Other optimizers, layer-wise lr decay and tower
locking are not ported yet and raise.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import is_sharded, local_tensor

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


class AdamW:
    """Clip, Adam, decoupled weight decay and the schedule, applied in place."""

    def __init__(self, cfg: OptimizerCfg, decay: List[bool], schedule: Callable[[int], float]):
        self.cfg = cfg
        self.decay = decay
        self.schedule = schedule
        self.mu_dtype = _MU_DTYPES[cfg.mu_dtype]

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
        torch._foreach_mul_(updates, -self.schedule(state["count"]))
        torch._foreach_add_(params, updates)
        state["count"] = count
        return norm


def create_optimizer(cfg: OptimizerCfg, params: Union[nn.Module, Dict[str, torch.Tensor]],
                     schedule: Callable[[int], float]) -> AdamW:
    """The optimizer for a model (or a name -> tensor dict); its ``init`` and
    ``update_`` take the tensors in the order of ``named_parameters()``."""
    if cfg.opt.lower().replace("timm/", "") != "adamw":
        raise NotImplementedError(f"optimizer {cfg.opt!r} is not ported yet (adamw is)")
    if any(d is not None for d in (cfg.layer_decay, cfg.image_layer_decay, cfg.text_layer_decay,
                                   cfg.audio_layer_decay)):
        raise NotImplementedError("layer-wise lr decay is not ported yet")
    if cfg.mu_dtype not in _MU_DTYPES:
        raise ValueError(f"mu_dtype {cfg.mu_dtype!r}; one of {sorted(map(str, _MU_DTYPES))}")
    mask = wd_mask(params, cfg.wd_exclude_names, cfg.wd_exclude_patterns)
    return AdamW(cfg, list(mask.values()), schedule)
