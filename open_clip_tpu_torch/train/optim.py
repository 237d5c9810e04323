"""Optimizer construction (counterpart of ``open_clip_tpu/train/optim.py``).

``create_optimizer`` gives the arithmetic of the JAX package's optax chain, in
its order: clip by global norm (``g`` unchanged below the limit, else
``g / norm * clip``; no epsilon is added to the norm), the optimizer's scaling,
``+ wd * p`` on the leaves the weight-decay mask selects, ``* -lr(count)`` with the
schedule read at the optimizer's own count (0 on the first step), then
``p + update``. The scalings are optax's: ``adamw`` (Adam's moments with bias
correction and ``eps`` outside the square root), ``nadamw`` (Adam with the
Nesterov look-ahead), ``lion``, ``sgd``/``momentum`` (a Nesterov trace of
``--momentum``), ``lamb`` (Adam, then the trust ratio), ``adafactor``
(``scale_by_factored_rms`` with its defaults) and ``muon`` (the JAX package's
Newton-Schulz scaling).

The optimizer itself holds no tensors: its state (the count and the optimizer's
statistics) is a dict made by ``init`` and kept in the train state, as optax keeps
it. Updates are made in place with ``torch._foreach_*`` (the JAX package has no
kernel of its own here either). Under FSDP2 (``parallel.mesh.shard_model``) the
parameters and their gradients are sharded: the statistics are made with the
parameters' sharding, the update runs on each rank's shards, and the global norm
sums the squares of the shards over the ranks that hold them, so clipping sees
the whole gradient as ``clip_by_global_norm`` does. lamb, adafactor and muon read a
whole leaf and raise for sharded parameters.

Those three read the JAX tree's leaves, and the JAX blocks are stacked along a
layer axis where the port holds one tensor per block: ``jax_leaves`` rebuilds the
leaves (the tensors of ``transformer.resblocks.{i}`` and ``trunk.resblocks.{i}``
stacked by name, each tensor in its JAX layout), so that lamb takes one trust
ratio for all the layers of a stacked leaf, adafactor factors the axes JAX
factors, and muon orthogonalizes a stacked per-layer vector as one layers x width
matrix and passes a leaf of rank 4 in JAX (a Swin patch embedding) through.

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
ConvNeXt's ``stages.{i}.blocks`` are stacked in the JAX tree, one leaf a stage, and
one module a block in the port (``_STAGE_BLOCK_RE``): each block's tensor counts its
own dimensions for the weight decay, and its layer decay and lock follow its index
in its stage, so the decay ladder starts again in every stage and
``unlocked_groups`` > 1 unlocks the last blocks of every stage, as the JAX rules give
them. A ModifiedResNet's layers are no ``blocks``: it gets no layer decay (the CLI
passes no depth for it) and locking leaves only its ``attnpool`` trainable. The EVA and
ViTamin towers hold their stacked ViT blocks as ``transformer.resblocks``; ViTamin's
MBConv blocks are a plain list under ``stages.{i}.blocks`` in both packages (the
lookahead of ``_STAGE_BLOCK_RE`` tells them from ConvNeXt's), so the JAX rules read
the first axis of each of their leaves as a layer axis: a convolution's kh (the port's
axis 2), a LayerNorm's channels. The port follows (ROADMAP, the reference's faults).
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
    module per layer, no stacked axis), where both rules agree, and so are ConvNeXt's
    stage blocks, stacked in JAX; the Swin and HTSAT blocks are ``blocks`` lists in
    both packages, unstacked in JAX too, so their 2-D weights count as 1-D there and
    get no decay. The port follows the JAX package (the upstream reference decays
    them; ROADMAP Queue C 4)."""
    exclude = NO_WD_NAMES | set(extra_names)
    regexes = [re.compile(p.replace(".", r"\.").replace("*", ".*")) for p in patterns]

    def decays(name: str, p: torch.Tensor) -> bool:
        parts = name.split(".")
        if any(part in exclude for part in parts):
            return False
        if any(r.fullmatch(name) for r in regexes):
            return False
        return p.ndim - ("blocks" in parts and not _STAGE_BLOCK_RE.search(name)) > 1

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


# the blocks the JAX tree stacks and ``layer_decay_scales`` ladders (CoCa's decoder
# self-attention blocks among them; its cross blocks are the JAX ``cross_blocks``,
# which its ladder leaves out; GenLIP's top-level trunk, not the NaFlex audio
# encoder's, whose JAX tree nests it deeper)
_BLOCK_RE = re.compile(r"(?:(?:^|\.)(?:transformer|text_decoder)|^trunk)\.resblocks\.(\d+)\.")
# ConvNeXt's blocks, stacked one leaf a stage in the JAX tree: (stage, block index).
# ViTamin's MBConv blocks sit at the same path but are a plain list in the JAX tree;
# the lookahead tells the two apart by ConvNeXt's block entries.
_CNX_BLOCK = r"(?=\.\d+\.(?:dwconv|norm|fc1|fc2|gamma)(?:\.|$))"
_STAGE_BLOCK_RE = re.compile(r"(?:^|\.)stages\.(\d+)\.blocks" + _CNX_BLOCK + r"\.(\d+)\.")
# the top-level keys of the JAX GenLIP/GenLAP tree, each a tower of its own there
GENLIP_KEYS = ("patch_embed", "text_embed", "in_proj", "out_proj", "text_norm_pre", "lm_head",
               "trunk", "visual_proj")


def _tower(name: str) -> str:
    """The JAX tree's top-level key of a port parameter: the text tower's parts sit
    at the port's top level, under ``text`` in the JAX tree."""
    head = name.split(".")[0]
    return head if head in ("visual", "audio", "logit_scale", "logit_bias",
                            "text_decoder") + GENLIP_KEYS else "text"


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


def _stage_depths(names: Iterable[str]) -> Dict[str, int]:
    """The block count of each ConvNeXt stage, keyed by the name up to its index."""
    depths: Dict[str, int] = {}
    for name in names:
        m = _STAGE_BLOCK_RE.search(name)
        if m:
            key = name[:m.start(2)]
            depths[key] = max(depths.get(key, 0), int(m.group(2)) + 1)
    return depths


def _first_jax_axis(name: str, p: torch.Tensor) -> int:
    """The port axis of the JAX leaf's first axis: a 2-D ``.weight`` is the transpose
    of the JAX (in, out) kernel, a 4-D one an (out, in, kh, kw) convolution of the
    JAX (kh, kw, in, out) kernel."""
    if name.endswith(".weight") and p.ndim in (2, 4):
        return {2: 1, 4: 2}[p.ndim]
    return 0


def _along_first_jax_axis(name: str, p: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` (one per row of the JAX leaf's first axis) shaped to broadcast
    over the port's ``p``."""
    shape = [1] * p.ndim
    shape[_first_jax_axis(name, p)] = -1
    return values.reshape(shape)


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
    depths, stages = _stack_depths(named), _stage_depths(named)
    out: Dict[str, Factor] = {}
    for name, p in named.items():
        tower = _tower(name)
        d = (tower_decay or {}).get(tower, decay)
        depth = depths.get(tower) or num_layers
        parts = name.split(".")
        if d is None or d >= 1.0 or not depth:
            out[name] = 1.0
            continue
        m, s = _BLOCK_RE.search(name), _STAGE_BLOCK_RE.search(name)
        if m:
            n = depths[tower]
            out[name] = float(np.float32(d) ** np.float32(n - int(m.group(1))))
        elif s:
            n = stages[name[:s.start(2)]]
            out[name] = float(np.float32(d) ** (np.float32(n) - np.float32(s.group(2))))
        elif "blocks" in parts:
            n = p.shape[_first_jax_axis(name, p)]
            ladder = np.float32(d) ** (np.float32(n) - np.arange(n, dtype=np.float32))
            out[name] = _along_first_jax_axis(name, p, torch.from_numpy(ladder))
        elif parts[-1] in ("proj", "text_projection", "logit_scale", "logit_bias") or \
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
    depths, stages = _stack_depths(named), _stage_depths(named)
    out: Dict[str, Factor] = {}
    for name, p in named.items():
        tower = _tower(name)
        locked = (tower == "visual" and lock_image) or (tower == "text" and lock_text)
        if not locked:
            out[name] = 1.0
            continue
        unlocked = lock_image_unlocked_groups if tower == "visual" else lock_text_unlocked_layers
        parts = name.split(".")[1 if tower == "visual" else 0:]
        m, s = _BLOCK_RE.search(name), _STAGE_BLOCK_RE.search(name)
        if unlocked > 0 and HEAD_NAMES.intersection(parts):
            out[name] = 1.0
        elif unlocked > 1 and m:
            out[name] = float(int(m.group(1)) >= depths[tower] - (unlocked - 1))
        elif unlocked > 1 and s:
            out[name] = float(int(s.group(2)) >= stages[name[:s.start(2)]] - (unlocked - 1))
        elif unlocked > 1 and "blocks" in parts:
            n = p.shape[_first_jax_axis(name, p)]
            keep = (torch.arange(n) >= n - (unlocked - 1)).float()
            out[name] = _along_first_jax_axis(name, p, keep)
        else:
            out[name] = 0.0
    return out


OPTIMIZERS = ("adamw", "nadamw", "lion", "sgd", "momentum", "lamb", "adafactor", "muon")
# the rules that read a leaf's shape or norm, which the JAX tree's leaves decide
_LEAF_RULES = ("lamb", "adafactor", "muon")
# the JAX tree stacks these blocks along a leading layer axis
_STACK_RE = re.compile(
    r"(?:^|\.)(?:(?:transformer|trunk)\.resblocks|text_decoder\.(?:resblocks|cross_attn)"
    r"|stages\.\d+\.blocks" + _CNX_BLOCK + r")\.(\d+)\.")
# optax.scale_by_factored_rms()'s defaults
_FACTOR_DECAY, _FACTOR_MIN_DIM, _FACTOR_EPS = 0.8, 128, 1e-30


@dataclass
class Leaf:
    """One leaf of the JAX tree: ``members`` are the indices of its port tensors in
    ``named_parameters()`` order (layer i of a stacked leaf at position i),
    ``layers`` the leaf's stacked layer count (0: not stacked) and ``views`` map each
    member to its JAX layout (an (in, out) kernel for an ``nn.Linear`` weight, the
    (kh, kw, in, out) kernel for a convolution), as views of the same storage."""

    name: str
    members: List[int]
    layers: int
    views: List[Callable[[torch.Tensor], torch.Tensor]]

    def shape(self, params: Sequence[torch.Tensor]) -> Tuple[int, ...]:
        """The JAX leaf's shape."""
        one = tuple(self.views[0](params[self.members[0]]).shape)
        return (self.layers,) + one if self.layers else one

    def gather(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The members of ``tensors`` as the JAX leaf: stacked (a copy) or a view."""
        if self.layers:
            return torch.stack([v(tensors[i]) for i, v in zip(self.members, self.views)])
        return self.views[0](tensors[self.members[0]])

    def scatter(self, leaf: torch.Tensor, like: Sequence[torch.Tensor]):
        """(index, tensor) for each member: the JAX-layout ``leaf`` back in the
        port's layout of ``like``'s members."""
        rows = leaf.unbind(0) if self.layers else (leaf,)
        for i, view, row in zip(self.members, self.views, rows):
            out = torch.empty_like(like[i])
            view(out).copy_(row)
            yield i, out


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _transposed(t: torch.Tensor) -> torch.Tensor:
    return t.t()


def _jax_view(model: nn.Module, name: str, p: torch.Tensor, stacked: bool) -> Callable:
    """The map from the port tensor ``name`` to its JAX layout."""
    from ..models.vit import PatchEmbed

    if stacked:  # a block's 2-D tensors are all kernels, its 4-D ones convolutions
        if p.ndim == 4:
            return lambda t: t.permute(2, 3, 1, 0)
        return _transposed if p.ndim == 2 else _same
    owner = model.get_submodule(name.rpartition(".")[0])
    if isinstance(owner, PatchEmbed):
        if name.endswith("patch_embed.proj.weight"):  # the Swin and HTSAT convolutions
            ph, pw = owner.patch_size
            return lambda t: t.view(ph, pw, -1, t.shape[-1])
        return _same  # the ViT's kernel keeps JAX's patchify layout
    if isinstance(owner, nn.Conv2d) and p.ndim == 4:
        return lambda t: t.permute(2, 3, 1, 0)
    if isinstance(owner, nn.Linear) and p.ndim == 2:
        return _transposed
    return _same


def jax_leaves(model: nn.Module) -> List[Leaf]:
    """The model's parameters grouped into the JAX tree's leaves: the tensors of
    ``transformer.resblocks.{i}``, ``trunk.resblocks.{i}``, CoCa's
    ``text_decoder.resblocks.{i}`` and ``text_decoder.cross_attn.{i}`` and each ConvNeXt
    stage's ``stages.{s}.blocks.{i}`` stack into one leaf per name (the JAX blocks'
    layer axis), every other tensor is a leaf of its own (the Swin and HTSAT
    ``blocks`` lists are unstacked in JAX too)."""
    named = list(model.named_parameters())
    depth: Dict[str, int] = {}
    for name, _ in named:
        m = _STACK_RE.search(name)
        if m:
            depth[name[:m.start(1)]] = max(depth.get(name[:m.start(1)], 0), int(m.group(1)) + 1)
    leaves: List[Leaf] = []
    stacks: Dict[str, Leaf] = {}
    for i, (name, p) in enumerate(named):
        m = _STACK_RE.search(name)
        if m is None:
            leaves.append(Leaf(name, [i], 0, [_jax_view(model, name, p, False)]))
            continue
        key = f"{name[:m.start(1)]}*{name[m.end(1):]}"
        if key not in stacks:
            stacks[key] = Leaf(key, [], depth[name[:m.start(1)]], [])
            leaves.append(stacks[key])
        stacks[key].members.append(i)
        stacks[key].views.append(_jax_view(model, name, p, True))
    for leaf in stacks.values():
        if len(leaf.members) != leaf.layers:  # the modern text tower's vr_lambda
            leaf.layers = -1  # the JAX leaf has a row the port does not hold
    return leaves


def _whole(leaf: Leaf) -> None:
    if leaf.layers < 0:
        raise NotImplementedError(f"{leaf.name}: the JAX leaf stacks a layer the port does not "
                                  "hold (the modern text tower's first vr_lambda); lamb and "
                                  "muon are not ported for it")


# the dtype of muon's Newton-Schulz iteration (the JAX package's bfloat16)
MUON_DTYPE = torch.bfloat16


def newton_schulz(g: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Muon's quintic Newton-Schulz orthogonalization of the last two axes, in
    ``MUON_DTYPE`` (batched over any leading axes), op for op as the JAX package
    computes it."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g.to(MUON_DTYPE)
    transpose = x.shape[-2] > x.shape[-1]
    if transpose:
        x = x.mT
    x = x / (torch.linalg.matrix_norm(x, keepdim=True) + 1e-7)
    for _ in range(steps):
        xxt = x @ x.mT
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    if transpose:
        x = x.mT
    return x.to(g.dtype)


def _factored_dims(shape: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    """optax's choice: the two largest axes (second largest, largest), or None when
    the second largest is below the minimum size."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


class Optimizer:
    """The JAX package's optax chain, applied in place: clip by global norm, the
    optimizer's scaling (``scale_by_*``), ``+ wd * p`` under the weight-decay mask,
    the layer-decay scales, ``* -lr(count)``, then the trainable mask."""

    def __init__(self, cfg: OptimizerCfg, decay: List[bool], schedule: Callable[[int], float],
                 scales: Optional[List[Factor]] = None, leaves: Optional[List[Leaf]] = None):
        self.cfg = cfg
        self.name = cfg.opt.lower().replace("timm/", "")
        self.decay = decay
        self.schedule = schedule
        # Adam's first moment dtype; lamb's Adam keeps the parameter's (as in JAX)
        self.mu_dtype = _MU_DTYPES[cfg.mu_dtype] if self.name in ("adamw", "nadamw") else None
        self.scales = None if scales is None else _Factors(scales)  # None: no layer decay
        self.mask: Optional[_Factors] = None  # None: every tensor trains
        self.leaves = leaves  # the JAX leaves, for the rules that read them

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        """The optimizer's state beside ``params`` (in their order; sharded as they
        are) with a count of 0: the moments (``mu``, ``nu``) of Adam and lamb, ``mu``
        of lion, ``trace`` of sgd, ``momentum`` of muon, adafactor's ``v_row``,
        ``v_col`` and ``v``, one each for every JAX leaf (a factored leaf's row and
        column statistics, else its full statistic; the unused ones are one zero, as
        optax keeps them)."""
        if len(params) != len(self.decay):
            raise ValueError(f"optimizer was built for {len(self.decay)} tensors, got {len(params)}")
        if self.leaves is not None and any(is_sharded(p) for p in params):
            raise NotImplementedError(f"{self.name} reads whole JAX leaves; it is not ported for "
                                      "sharded parameters (adamw, nadamw, lion and sgd are)")
        zeros = lambda dtype=None: [torch.zeros_like(p, dtype=dtype or p.dtype)  # noqa: E731
                                    for p in params]
        state: Dict = {"count": 0}
        if self.name in ("adamw", "nadamw", "lamb"):
            state.update(mu=zeros(self.mu_dtype), nu=zeros())
        elif self.name == "lion":
            state["mu"] = zeros()
        elif self.name in ("sgd", "momentum"):
            state["trace"] = zeros()
        elif self.name == "muon":
            state["momentum"] = zeros()
        elif self.name == "adafactor":
            state.update(self._adafactor_init(params))
        return state

    def _adafactor_init(self, params: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        out: Dict[str, List[torch.Tensor]] = {"v_row": [], "v_col": [], "v": []}
        with torch.no_grad():
            for leaf in self.leaves:
                p = leaf.gather(params)
                one, dims = p.new_zeros((1,)), _factored_dims(tuple(p.shape))
                if dims is None:
                    row, col, full = one, one.clone(), torch.zeros(p.shape, dtype=p.dtype,
                                                                   device=p.device)
                else:
                    d1, d0 = dims
                    row = p.new_zeros([n for k, n in enumerate(p.shape) if k != d0])
                    col = p.new_zeros([n for k, n in enumerate(p.shape) if k != d1])
                    full = one
                for key, t in (("v_row", row), ("v_col", col), ("v", full)):
                    out[key].append(t)
        return out

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: Dict) -> torch.Tensor:
        """One step in place on ``params`` and ``state``; returns the global norm of
        ``grads`` before clipping. Does not wait for the device."""
        cfg = self.cfg
        norm = global_norm(grads)
        # sharded tensors update shard by shard: their local parts are views
        params, grads = [local_tensor(p) for p in params], [local_tensor(g) for g in grads]
        if cfg.grad_clip_norm:
            below = norm < cfg.grad_clip_norm
            one = torch.ones_like(norm)
            # below the limit g / 1 * 1 is g exactly; above it (g / norm) * clip
            grads = torch._foreach_div(grads, torch.where(below, one, norm))
            torch._foreach_mul_(grads, torch.where(below, one, one * cfg.grad_clip_norm))
        count = state["count"] + 1
        moments = {k: [local_tensor(m) for m in v] for k, v in state.items() if k != "count"}
        updates = getattr(self, f"_scale_{self.name.replace('momentum', 'sgd')}")(
            params, grads, moments, count)
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

    def _adam(self, grads, moments, count: int, nesterov: bool = False) -> List[torch.Tensor]:
        """``optax.scale_by_adam``: eps outside the square root; with ``nesterov``
        the first moment is looked one step ahead, as NAdam has it."""
        cfg = self.cfg
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
        b1 = cfg.beta1
        if nesterov:  # b1 * mu / (1 - b1^(t+1)) + (1 - b1) * g / (1 - b1^t)
            updates = torch._foreach_div(mu, 1 - b1 ** (count + 1))
            torch._foreach_mul_(updates, b1)
            ahead = torch._foreach_div(grads, 1 - b1 ** count)
            torch._foreach_mul_(ahead, 1 - b1)
            torch._foreach_add_(updates, ahead)
        else:
            updates = torch._foreach_div(mu, 1 - b1 ** count)
        torch._foreach_div_(updates, denom)
        return updates

    def _scale_adamw(self, params, grads, moments, count):
        return self._adam(grads, moments, count)

    def _scale_nadamw(self, params, grads, moments, count):
        return self._adam(grads, moments, count, nesterov=True)

    def _scale_lion(self, params, grads, moments, count):
        """``optax.scale_by_lion``: sign((1 - b1) g + b1 m), then m <- (1 - b2) g + b2 m."""
        b1, b2 = self.cfg.beta1, self.cfg.beta2
        mu = moments["mu"]
        updates = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(updates, torch._foreach_mul(mu, b1))
        torch._foreach_sign_(updates)
        torch._foreach_mul_(mu, b2)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b2))
        return updates

    def _scale_sgd(self, params, grads, moments, count):
        """``optax.trace(decay=momentum, nesterov=True)``: t <- g + m t; g + m t."""
        trace = moments["trace"]
        torch._foreach_mul_(trace, self.cfg.momentum)
        torch._foreach_add_(trace, grads)
        updates = torch._foreach_mul(trace, self.cfg.momentum)
        torch._foreach_add_(updates, grads)
        return updates

    def _scale_lamb(self, params, grads, moments, count):
        """Adam, then ``optax.scale_by_trust_ratio``: each JAX leaf's update times
        |leaf params| / |leaf update| (1 where either is 0), one ratio for all the
        layers of a stacked leaf."""
        updates = self._adam(grads, moments, count)
        # summed in float64: the float32 norm of a leaf of 25 M entries (a token
        # embedding) is off by ~1.5e-3 on the CPU
        pn = torch._foreach_norm(params, 2, dtype=torch.float64)
        un = torch._foreach_norm(updates, 2, dtype=torch.float64)
        for leaf in self.leaves:
            _whole(leaf)
            idx = leaf.members
            p_norm = torch.linalg.vector_norm(torch.stack([pn[i] for i in idx]))
            u_norm = torch.linalg.vector_norm(torch.stack([un[i] for i in idx]))
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            torch._foreach_mul_([updates[i] for i in idx], ratio.to(updates[idx[0]].dtype))
        return updates

    def _scale_adafactor(self, params, grads, moments, count):
        """``optax.scale_by_factored_rms()`` on each JAX leaf: its two largest axes,
        where the second has 128 or more, are factored (per layer for a stacked
        leaf's kernels), any other leaf keeps its full second moment."""
        t = np.float32(count)  # optax's step + 1
        decay = float(np.float32(1.0) - t ** np.float32(-_FACTOR_DECAY))
        keep = float(np.float32(1.0) - np.float32(decay))
        updates: List[torch.Tensor] = [None] * len(params)
        for j, leaf in enumerate(self.leaves):
            g = leaf.gather(grads)
            sq = g * g + _FACTOR_EPS
            dims = _factored_dims(tuple(g.shape))
            if dims is None:
                v = moments["v"][j]
                v.mul_(decay).add_(sq * keep)
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                vr, vc = moments["v_row"][j], moments["v_col"][j]
                vr.mul_(decay).add_(sq.mean(d0) * keep)
                vc.mul_(decay).add_(sq.mean(d1) * keep)
                row_mean = vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                u = g * ((vr / row_mean) ** -0.5).unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
            for i, out in leaf.scatter(u, params):
                updates[i] = out
        return updates

    def _scale_muon(self, params, grads, moments, count):
        """The JAX package's ``scale_by_muon``: Nesterov momentum, then each JAX leaf
        of rank 2 orthogonalized (a stacked per-layer vector as one layers x width
        matrix), of rank 3 per slice of its first axis (per layer for a stacked
        matrix), times sqrt(max of its last two axes) * 0.2; other ranks pass."""
        mom = self.cfg.momentum
        buf = moments["momentum"]
        torch._foreach_mul_(buf, mom)
        torch._foreach_add_(buf, grads)
        eff = list(torch._foreach_mul(buf, mom))
        torch._foreach_add_(eff, grads)
        for leaf in self.leaves:
            shape = leaf.shape(params)
            if len(shape) not in (2, 3):
                continue
            if leaf.layers:
                _whole(leaf)
            scale = float(np.sqrt(np.float32(max(shape[-2], shape[-1]))) * np.float32(0.2))
            # a stacked leaf: (L, D) as one matrix, (L, in, out) per layer
            for i, out in leaf.scatter(newton_schulz(leaf.gather(eff)) * scale, eff):
                eff[i] = out
        return eff


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
                     schedule: Callable[[int], float], num_layers: Optional[int] = None
                     ) -> Optimizer:
    """The optimizer ``cfg.opt`` names for a model (or, for the rules that read
    tensors one by one, a name -> tensor dict); its ``init`` and ``update_`` take the
    tensors in the order of ``named_parameters()``. Layer-wise lr decay is on where
    ``layer_decay`` or a tower's own factor is below 1, with ``num_layers`` the depth
    of a tower that has no stacked blocks (the JAX CLI passes the vision tower's
    layers). An unknown name raises ``ValueError``, as in the JAX package."""
    name = cfg.opt.lower().replace("timm/", "")
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.opt!r}")
    if cfg.mu_dtype not in _MU_DTYPES:
        raise ValueError(f"mu_dtype {cfg.mu_dtype!r}; one of {sorted(map(str, _MU_DTYPES))}")
    leaves = None
    if name in _LEAF_RULES:
        if not isinstance(params, nn.Module):
            raise ValueError(f"{name} reads the JAX tree's leaves: pass the model")
        leaves = jax_leaves(params)
    mask = wd_mask(params, cfg.wd_exclude_names, cfg.wd_exclude_patterns)
    tower_decay = {t: own if own is not None else cfg.layer_decay for t, own in (
        ("visual", cfg.image_layer_decay), ("text", cfg.text_layer_decay),
        ("audio", cfg.audio_layer_decay))}
    scales = None
    if any(d is not None and d < 1.0 for d in (cfg.layer_decay, *tower_decay.values())):
        scales = list(layer_decay_scales(params, cfg.layer_decay, num_layers,
                                         tower_decay=tower_decay).values())
    return Optimizer(cfg, list(mask.values()), schedule, scales, leaves)


def apply_trainable_mask(optimizer: Optimizer, mask: Dict[str, Factor]) -> Optimizer:
    """The optimizer with ``mask`` (``trainable_mask``, in ``named_parameters()``
    order) multiplying each final update: a 0 leaves that tensor as it was, bit for
    bit. Set in place; returns the optimizer."""
    if len(mask) != len(optimizer.decay):
        raise ValueError(f"mask of {len(mask)} tensors for an optimizer of {len(optimizer.decay)}")
    optimizer.mask = _Factors(list(mask.values()))
    return optimizer
