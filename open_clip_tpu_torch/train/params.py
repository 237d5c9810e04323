"""Command-line arguments of the training CLI (counterpart of
``open_clip_tpu/train/params.py``).

The flags carry the JAX CLI's names and defaults. Those of features that are not
ported yet (real datasets, evaluation, other losses, meshes, tower locking, EMA,
remote sync, ...) still parse, and ``parse_args`` raises ``NotImplementedError``
when one is set to anything but its default: a JAX command line is refused, not
half-obeyed. One flag is the port's own: ``--device`` (default: the CUDA card,
raising where there is none; ``cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

from .optim import get_default_params

_INTS = dict(type=int, default=None)
_STRS = dict(type=str, default=None)
_FLOATS = dict(type=float, default=None)
_ON = dict(action="store_true", default=False)

# flags of what is not ported yet: (option strings, add_argument keywords)
_UNPORTED: List[Tuple[Tuple[str, ...], dict]] = [
    # data
    (("--train-data",), _STRS), (("--train-data-upsampling-factors",), _STRS),
    (("--val-data",), _STRS), (("--val-num-samples",), _INTS),
    (("--naflex-seq-len-probs",), dict(type=float, nargs="+", default=None)),
    (("--naflex-patch-size-probs",), dict(type=float, nargs="+", default=None)),
    (("--naflex-pad-multiple",), _INTS), (("--naflex-max-text-tokens",), _INTS),
    (("--naflex-num-train-image-tokens",), _INTS),
    (("--use-naflex",), _ON), (("--force-naflex-vision",), _ON),
    (("--text-pad-multiple",), _INTS), (("--length-bucketing",), _ON),
    (("--bucket-pool",), dict(type=int, default=2048)),
    (("--bucket-chunk",), dict(type=int, default=128)),
    (("--bucket-prefetch-pools",), dict(type=int, default=0)),
    (("--dataset-resampled",), _ON),
    (("--csv-separator",), dict(type=str, default="\t")),
    (("--csv-img-key",), dict(type=str, default="filepath")),
    (("--csv-caption-key",), dict(type=str, default="title")),
    (("--wds-caption-key", "--text-key"), dict(type=str, default="txt")),
    (("--image-key",), dict(type=str, default="jpg;png;jpeg;webp")),
    (("--json-text-key",), _STRS),
    (("--json-text-key-probs",), dict(type=float, nargs="*", default=None)),
    (("--max-image-pixels",), dict(type=int, default=25_000_000)),
    (("--audio-ext",), dict(type=str, default="flac")), (("--audio-fusion",), _ON),
    (("--audio-layer-decay",), _FLOATS), (("--audio-zeroshot-dataset",), _STRS),
    (("--audio-zeroshot-split",), dict(type=str, default="test")),
    (("--audio-zeroshot-audio-key",), dict(type=str, default="audio")),
    (("--audio-zeroshot-class-key",), dict(type=str, default="category")),
    (("--audio-zeroshot-target-key",), dict(type=str, default="target")),
    (("--audio-zeroshot-template",), _STRS),
    (("--audio-zeroshot-workers",), dict(type=int, default=2)),
    (("--imagenet-val",), _STRS), (("--imagenet-v2",), _STRS),
    (("--device-preprocess",), _ON), (("--native-decode-threads",), dict(type=int, default=0)),
    # logging
    (("--log-local",), _ON), (("--report-to",), dict(type=str, default="")),
    (("--wandb-notes",), dict(type=str, default="")),
    (("--wandb-project-name",), dict(type=str, default="open-clip")),
    (("--copy-codebase",), _ON), (("--cache-dir",), _STRS), (("--profile-dir",), _STRS),
    (("--remote-sync",), _STRS), (("--remote-sync-frequency",), dict(type=int, default=300)),
    (("--remote-sync-protocol",), dict(type=str, default="fsspec")),
    # evaluation
    (("--val-retrieval-chunk-size",), dict(type=int, default=4096)),
    (("--val-retrieval-precision",), dict(type=str, default="fp32")),
    (("--val-frequency",), dict(type=int, default=1)),
    (("--zeroshot-frequency",), dict(type=int, default=2)),
    # model and weights
    (("--pretrained",), dict(type=str, default="")),
    (("--pretrained-image",), _STRS), (("--pretrained-audio",), _STRS),
    (("--force-quick-gelu",), _ON), (("--force-custom-text",), _ON),
    (("--force-patch-dropout",), _FLOATS),
    (("--force-image-size",), dict(type=int, nargs="+", default=None)),
    (("--force-context-length",), _INTS),
    (("--image-mean",), dict(type=float, nargs="+", default=None)),
    (("--image-std",), dict(type=float, nargs="+", default=None)),
    (("--image-interpolation",), _STRS), (("--image-resize-mode",), _STRS),
    (("--aug-cfg",), dict(nargs="*", default={})),
    (("--use-switchback",), _ON), (("--use-bnb-linear",), _STRS),
    (("--scan-unroll",), dict(type=int, default=1)),
    # optimizer
    (("--momentum",), dict(type=float, default=0.9)),
    (("--layer-decay",), _FLOATS),
    (("--image-layer-decay", "--visual-layer-decay"), _FLOATS), (("--text-layer-decay",), _FLOATS),
    (("--opt-kwargs",), dict(nargs="*", default={})),
    (("--opt-fallback-list",), dict(type=str, nargs="*", default=None)),
    (("--text-pooler-own-group",), dict(dest="text_pooler_in_head", action="store_false",
                                        default=True)),
    (("--lock-image",), _ON), (("--lock-image-unlocked-groups",), dict(type=int, default=0)),
    (("--lock-image-freeze-bn-stats",), _ON),
    (("--lock-text",), _ON), (("--lock-text-unlocked-layers",), dict(type=int, default=0)),
    (("--lock-text-freeze-layer-norm",), _ON),
    (("--ema",), _FLOATS),
    # losses
    (("--siglip",), _ON), (("--loss-dist-impl",), dict(type=str, default="bidir")),
    (("--coca-caption-loss-weight",), dict(type=float, default=2.0)),
    (("--coca-contrastive-loss-weight",), dict(type=float, default=1.0)),
    (("--distill-model",), _STRS), (("--distill-pretrained",), _STRS),
    # parallelism
    (("--mesh-data",), dict(type=int, default=-1)), (("--mesh-fsdp",), dict(type=int, default=1)),
    (("--mesh-tensor",), dict(type=int, default=1)),
    (("--dist-coordinator",), _STRS), (("--dist-num-processes",), _INTS),
    (("--dist-process-id",), _INTS), (("--dist-auto",), _ON),
    (("--dist-backend",), _STRS), (("--dist-url",), _STRS),
    (("--torchcompile",), _ON), (("--torchcompile-backend",), _STRS),
    (("--torchcompile-mode",), _STRS), (("--torchcompile-strategy",), _STRS),
    (("--fsdp",), _ON), (("--fsdp-checkpoint",), _ON),
    (("--fsdp-no-reshard-after-forward",), _ON), (("--fsdp-offload-cpu",), _ON),
    (("--ddp-static-graph",), _ON), (("--no-set-device-rank",), _ON), (("--use-bn-sync",), _ON),
    (("--audio-multiprocessing-context",), _STRS),
    (("--audio-zeroshot-multiprocessing-context",), _STRS),
    # checkpointing
    (("--save-most-recent",), _ON), (("--delete-previous-checkpoint",), _ON),
    (("--checkpoint-format",), dict(type=str, default="orbax")),
]


def parse_args(args=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("open_clip_tpu_torch training")

    # data
    parser.add_argument("--dataset-type",
                        choices=["webdataset", "csv", "synthetic", "webdataset-audio",
                                 "synthetic-audio", "webdataset-naflex", "synthetic-naflex", "auto"],
                        default="auto",
                        help="'synthetic', 'synthetic-naflex' and 'synthetic-audio' are ported")
    parser.add_argument("--train-num-samples", type=int, default=None)
    # NaFlex token-budget batching (--dataset-type synthetic-naflex)
    parser.add_argument("--naflex-seq-lens", type=int, nargs="+", default=[128, 256, 576, 784, 1024])
    parser.add_argument("--naflex-patch-sizes", type=int, nargs="+", default=[16])
    parser.add_argument("--naflex-max-tokens", "--naflex-max-tokens-per-batch",
                        dest="naflex_max_tokens", type=int, default=16384)
    parser.add_argument("--naflex-batch-divisor", type=int, default=8)
    parser.add_argument("--naflex-loss-scale", type=str, default="none",
                        choices=["none", "linear", "sqrt"],
                        help="scale the loss by (actual batch / --batch-size) for "
                             "token-budget NaFlex batches")
    # CLAP training clips (--dataset-type synthetic-audio)
    parser.add_argument("--audio-fill", type=str, default="repeatpad",
                        choices=["repeatpad", "repeat", "pad"])
    parser.add_argument("--audio-trunc", type=str, default="rand_trunc",
                        choices=["rand_trunc", "trunc"])
    parser.add_argument("--audio-int16-normalize", action="store_true", default=False)
    parser.add_argument("--workers", type=int, default=4)

    # logging / experiment
    parser.add_argument("--logs", type=str, default="./logs/")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--log-every-n-steps", type=int, default=100)
    parser.add_argument("--log-metric-every-n-steps", type=int, default=10,
                        help="writer cadence (denser than the console line)")
    parser.add_argument("--train-loss-ema-samples", type=int, default=50000,
                        help="smoothing horizon in samples for the console loss EMA")
    parser.add_argument("--debug", action="store_true", default=False)

    # core training
    parser.add_argument("--model", type=str, default="ViT-B-32")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=32)
    parser.add_argument("--epochs-cooldown", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--beta1", type=float, default=None)
    parser.add_argument("--beta2", type=float, default=None)
    parser.add_argument("--eps", type=float, default=None)
    parser.add_argument("--wd", type=float, default=0.2)
    parser.add_argument("--opt", type=str, default="adamw", help="only 'adamw' is ported")
    parser.add_argument("--warmup", type=int, default=10000)
    parser.add_argument("--lr-scheduler", type=str, default="cosine",
                        choices=["cosine", "const", "const-cooldown"])
    parser.add_argument("--lr-cooldown-end", type=float, default=0.0)
    parser.add_argument("--lr-cooldown-power", type=float, default=1.0)
    parser.add_argument("--accum-freq", type=int, default=1)
    parser.add_argument("--grad-clip-norm", type=float, default=None)
    parser.add_argument("--wd-exclude", type=str, nargs="*", default=[],
                        dest="wd_exclude_patterns",
                        help="extra parameter-name glob patterns that skip weight decay")
    parser.add_argument("--skip-scheduler", action="store_true", default=False,
                        help="constant lr, no decay")

    # precision / memory
    parser.add_argument("--precision", type=str, default="amp_bf16",
                        choices=["amp", "amp_bf16", "bf16", "pure_bf16", "fp16", "fp32"])
    parser.add_argument("--grad-checkpointing", action="store_true", default=False)
    parser.add_argument("--remat-policy", type=str, default="none",
                        choices=["none", "names", "names_mm", "dots", "dots_no_batch"],
                        help="what --grad-checkpointing saves: only 'none' (recompute the "
                             "whole block) is ported")

    # single process: these change nothing and are accepted
    parser.add_argument("--local-loss", action="store_true", default=True)
    parser.add_argument("--no-local-loss", dest="local_loss", action="store_false")
    parser.add_argument("--gather-with-grad", action="store_true", default=True)

    # checkpointing
    parser.add_argument("--save-frequency", type=int, default=1)
    parser.add_argument("--resume", type=str, default=None, help="path or 'latest'")

    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                             "plain PyTorch path")

    group = parser.add_argument_group("not ported yet (raise when set)")
    unported = []
    for flags, kw in _UNPORTED:
        action = group.add_argument(*flags, **kw, help=argparse.SUPPRESS)
        unported.append((flags[0], action.dest, kw["default"]))

    ns = parser.parse_args(args)
    used = [flag for flag, dest, default in unported if getattr(ns, dest) != default]
    if ns.remat_policy != "none":
        used.append(f"--remat-policy {ns.remat_policy}")
    if used:
        raise NotImplementedError(f"not ported yet: {', '.join(used)}")

    for k, v in get_default_params(ns.model).items():
        if getattr(ns, k, None) is None:
            setattr(ns, k, v)
    ns.world_size, ns.rank = 1, 0
    return ns
