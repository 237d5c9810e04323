"""Command-line arguments of the training CLI (counterpart of
``open_clip_tpu/train/params.py``).

The flags carry the JAX CLI's names and defaults. Those the JAX CLI parses and
never reads parse here too and change nothing. Those of features that are not
ported yet (the CoCa and distillation losses, tensor parallelism, remote sync,
...) still parse, and ``parse_args`` raises
``NotImplementedError`` when one is set to anything but its default: a JAX command
line is refused, not half-obeyed. One flag is the port's own: ``--device`` (default: the CUDA card,
raising where there is none; ``cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import ast
from typing import List, Tuple

from .optim import get_default_params

_INTS = dict(type=int, default=None)
_STRS = dict(type=str, default=None)
_FLOATS = dict(type=float, default=None)
_ON = dict(action="store_true", default=False)

# flags of what is not ported yet: (option strings, add_argument keywords)
_UNPORTED: List[Tuple[Tuple[str, ...], dict]] = [
    # data
    (("--audio-fusion",), _ON),
    # logging
    (("--log-local",), _ON), (("--report-to",), dict(type=str, default="")),
    (("--wandb-notes",), dict(type=str, default="")),
    (("--wandb-project-name",), dict(type=str, default="open-clip")),
    (("--copy-codebase",), _ON), (("--cache-dir",), _STRS), (("--profile-dir",), _STRS),
    (("--remote-sync",), _STRS), (("--remote-sync-frequency",), dict(type=int, default=300)),
    (("--remote-sync-protocol",), dict(type=str, default="fsspec")),
    # model
    (("--scan-unroll",), dict(type=int, default=1)),
    # frozen batch-norm statistics belong to the ResNet towers
    (("--lock-image-freeze-bn-stats",), _ON),
    # losses
    (("--coca-caption-loss-weight",), dict(type=float, default=2.0)),
    (("--coca-contrastive-loss-weight",), dict(type=float, default=1.0)),
    (("--distill-model",), _STRS), (("--distill-pretrained",), _STRS),
    # compilation (the port has no compiled step) and audio loader processes
    (("--torchcompile",), _ON), (("--torchcompile-backend",), _STRS),
    (("--torchcompile-mode",), _STRS), (("--torchcompile-strategy",), _STRS),
    (("--audio-multiprocessing-context",), _STRS),
    (("--audio-zeroshot-multiprocessing-context",), _STRS),
    # checkpointing
    (("--checkpoint-format",), dict(type=str, default="orbax")),
]

# flags the JAX CLI parses and never reads: accepted, and they change nothing
_NOOP: List[Tuple[Tuple[str, ...], dict]] = [
    (("--image-key",), dict(type=str, default="jpg;png;jpeg;webp")),
    (("--json-text-key-probs",), dict(type=float, nargs="*", default=None)),
    (("--max-image-pixels",), dict(type=int, default=25_000_000)),
    (("--val-retrieval-precision",), dict(type=str, default="fp32")),
    (("--naflex-max-text-tokens",), _INTS), (("--naflex-num-train-image-tokens",), _INTS),
    (("--use-naflex",), _ON), (("--force-naflex-vision",), _ON),
    (("--text-pad-multiple",), _INTS),
    (("--opt-kwargs",), dict(nargs="*", default={})),
    (("--opt-fallback-list",), dict(type=str, nargs="*", default=None)),
    (("--text-pooler-own-group",), dict(dest="text_pooler_in_head", action="store_false",
                                        default=True)),
]


class ParseKwargs(argparse.Action):
    """``--aug-cfg key=value ...`` -> a dict, each value a Python literal where it parses."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, _, val = value.partition("=")
            try:
                kw[key] = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                kw[key] = val
        setattr(namespace, self.dest, kw)


def parse_args(args=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("open_clip_tpu_torch training")

    # data
    parser.add_argument("--dataset-type",
                        choices=["webdataset", "csv", "synthetic", "webdataset-audio",
                                 "synthetic-audio", "webdataset-naflex", "synthetic-naflex", "auto"],
                        default="auto",
                        help="webdataset, csv, auto and the synthetic types are ported")
    parser.add_argument("--train-num-samples", type=int, default=None)
    # NaFlex token-budget batching (--dataset-type synthetic-naflex)
    parser.add_argument("--naflex-seq-lens", type=int, nargs="+", default=[128, 256, 576, 784, 1024])
    parser.add_argument("--naflex-patch-sizes", type=int, nargs="+", default=[16])
    parser.add_argument("--naflex-max-tokens", "--naflex-max-tokens-per-batch",
                        dest="naflex_max_tokens", type=int, default=16384)
    parser.add_argument("--naflex-batch-divisor", type=int, default=8)
    parser.add_argument("--naflex-seq-len-probs", type=float, nargs="+", default=None)
    parser.add_argument("--naflex-patch-size-probs", type=float, nargs="+", default=None)
    parser.add_argument("--naflex-pad-multiple", type=int, default=None,
                        help="accepted; as in the JAX CLI, nothing reads it")
    # length bucketing of the webdataset-naflex stream (data/bucketing.py)
    parser.add_argument("--length-bucketing", action="store_true", default=False)
    parser.add_argument("--bucket-pool", type=int, default=2048)
    parser.add_argument("--bucket-chunk", type=int, default=128)
    parser.add_argument("--bucket-prefetch-pools", type=int, default=0)
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
    # real audio (--dataset-type webdataset-audio) and the audio zero-shot split
    parser.add_argument("--audio-ext", type=str, default="flac",
                        help="the preferred audio member of a sample; the other audio "
                             "suffixes still match (only WAV decodes)")
    parser.add_argument("--audio-zeroshot-dataset", type=str, default=None,
                        help="a folder of <class name>/*.wav (or folder:<dir>)")
    parser.add_argument("--audio-zeroshot-split", type=str, default="test")
    parser.add_argument("--audio-zeroshot-audio-key", type=str, default="audio")
    parser.add_argument("--audio-zeroshot-class-key", type=str, default="category")
    parser.add_argument("--audio-zeroshot-target-key", type=str, default="target")
    parser.add_argument("--audio-zeroshot-template", type=str, default=None,
                        help="templates separated by '|', '{}' marking the class name")
    parser.add_argument("--audio-zeroshot-workers", type=int, default=2,
                        help="accepted; the folder loader reads in this process, as the "
                             "JAX one does")
    parser.add_argument("--workers", type=int, default=4,
                        help="forked decode workers of the webdataset train pipeline")
    # real image data: JPEGs through the native decode stage (no PIL tier)
    parser.add_argument("--train-data", type=str, default=None,
                        help="tar shards ('dir/{00000..00099}.tar', '::' between sources) or "
                             "a CSV; needs --device-preprocess")
    parser.add_argument("--train-data-upsampling-factors", type=str, default=None)
    parser.add_argument("--val-data", type=str, default=None)
    parser.add_argument("--val-num-samples", type=int, default=None)
    parser.add_argument("--dataset-resampled", action="store_true", default=False)
    parser.add_argument("--csv-separator", type=str, default="\t")
    parser.add_argument("--csv-img-key", type=str, default="filepath")
    parser.add_argument("--csv-caption-key", type=str, default="title")
    parser.add_argument("--wds-caption-key", "--text-key", type=str, default="txt")
    parser.add_argument("--json-text-key", type=str, default=None,
                        help="caption from this field of each sample's json member")
    parser.add_argument("--imagenet-val", type=str, default=None,
                        help="ImageNet-style folder (one dir a class) for zero-shot")
    parser.add_argument("--imagenet-v2", type=str, default=None)
    parser.add_argument("--device-preprocess", action="store_true", default=False,
                        help="host stage: uint8 canvases; the random resized crop and the "
                             "normalization run in the step on the device")
    parser.add_argument("--native-decode-threads", type=int, default=0,
                        help="decode whole train batches on this many native threads "
                             "(in place of the forked workers)")
    parser.add_argument("--aug-cfg", nargs="*", action=ParseKwargs, default={},
                        help="key=value; scale and ratio only")
    parser.add_argument("--image-mean", type=float, nargs="+", default=None)
    parser.add_argument("--image-std", type=float, nargs="+", default=None)
    parser.add_argument("--image-interpolation", type=str, default=None)
    parser.add_argument("--image-resize-mode", type=str, default=None)
    # evaluation
    parser.add_argument("--val-frequency", type=int, default=1)
    parser.add_argument("--zeroshot-frequency", type=int, default=2)
    parser.add_argument("--val-retrieval-chunk-size", type=int, default=4096)

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
    parser.add_argument("--opt", type=str, default="adamw",
                        help="adamw, nadamw, lion, sgd (momentum), lamb, adafactor or muon")
    parser.add_argument("--momentum", type=float, default=0.9,
                        help="sgd's and muon's momentum")
    parser.add_argument("--ema", type=float, default=None,
                        help="keep an EMA of the weights with this decay; evaluation uses it")
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
                        help="what --grad-checkpointing saves: 'none' (recompute the whole "
                             "block), 'names' (LN outputs, attention output, activation) or "
                             "'names_mm' (fused qkv, attention output, fc1), 'dots' "
                             "(every product) or 'dots_no_batch' (the products without "
                             "batch dimensions)")
    parser.add_argument("--use-switchback", action="store_true", default=False,
                        help="int8 SwitchBack forward for the transformer MLP linears "
                             "(reference --use-bnb-linear)")
    parser.add_argument("--use-bnb-linear", type=str, default=None,
                        help="reference int8 flag; maps onto the SwitchBack path "
                             "(same as --use-switchback)")

    # losses: the sigmoid loss (SigLIP) in place of InfoNCE
    parser.add_argument("--siglip", action="store_true", default=False)

    # weights to start from, and fine-tuning
    parser.add_argument("--pretrained", type=str, default="",
                        help="a reference checkpoint file (.pt, .bin, .safetensors, .npz); a "
                             "registry tag raises (nothing is downloaded)")
    parser.add_argument("--pretrained-image", type=str, default=None,
                        help="load only the image tower from this checkpoint")
    parser.add_argument("--pretrained-audio", type=str, default=None,
                        help="load only the audio tower from this checkpoint")
    parser.add_argument("--force-quick-gelu", action="store_true", default=False)
    parser.add_argument("--force-custom-text", action="store_true", default=False)
    parser.add_argument("--force-patch-dropout", type=float, default=None,
                        help="the fraction of image patches a ViT drops in training")
    parser.add_argument("--force-image-size", type=int, nargs="+", default=None)
    parser.add_argument("--force-context-length", type=int, default=None)
    parser.add_argument("--layer-decay", type=float, default=None,
                        help="layer-wise lr decay factor of every tower")
    parser.add_argument("--image-layer-decay", "--visual-layer-decay", type=float, default=None)
    parser.add_argument("--text-layer-decay", type=float, default=None)
    parser.add_argument("--audio-layer-decay", type=float, default=None)
    parser.add_argument("--lock-image", action="store_true", default=False,
                        help="freeze the image tower (its updates are zeroed)")
    parser.add_argument("--lock-image-unlocked-groups", type=int, default=0,
                        help="keep the head and the last N-1 blocks of a locked image tower "
                             "trainable")
    parser.add_argument("--lock-text", action="store_true", default=False)
    parser.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    parser.add_argument("--lock-text-freeze-layer-norm", action="store_true", default=False,
                        help="accepted and not read, as in the JAX CLI")

    # mesh and processes: a world of more than one process (torchrun's RANK, WORLD_SIZE,
    # LOCAL_RANK, MASTER_ADDR and MASTER_PORT, or the flags) trains on a (data, fsdp)
    # mesh under FSDP2, one device a process
    parser.add_argument("--mesh-data", type=int, default=-1,
                        help="replica axis size (-1: the processes --mesh-fsdp leaves)")
    parser.add_argument("--mesh-fsdp", type=int, default=1, help="parameter-shard axis size")
    parser.add_argument("--mesh-tensor", type=int, default=1,
                        help="tensor-parallel axis size; only 1 is ported")
    parser.add_argument("--dist-coordinator", type=str, default=None,
                        help="host:port of process 0 (or OCT_COORDINATOR / MASTER_ADDR and "
                             "MASTER_PORT)")
    parser.add_argument("--dist-num-processes", type=int, default=None)
    parser.add_argument("--dist-process-id", type=int, default=None)
    parser.add_argument("--dist-auto", action="store_true", default=False,
                        help="accepted: the launcher's variables are always read")
    parser.add_argument("--loss-dist-impl", type=str, default="bidir",
                        help="how the siglip loss crosses processes: bidir, shift, gather "
                             "or reduce")
    parser.add_argument("--local-loss", action="store_true", default=True)
    parser.add_argument("--no-local-loss", dest="local_loss", action="store_false")
    parser.add_argument("--gather-with-grad", action="store_true", default=True,
                        help="always on: the gathered features carry gradients")
    # launch-script flags of the reference that the JAX CLI accepts and ignores: the
    # mesh replaces the DDP/FSDP wrappers, the backend follows the device, each
    # process takes the device of its local rank, and there is no batch norm to sync
    noop = parser.add_argument_group("accepted and ignored (reference launch scripts)")
    for flag in ("--dist-backend", "--dist-url"):
        noop.add_argument(flag, type=str, default=None, help=argparse.SUPPRESS)
    for flag in ("--fsdp", "--fsdp-checkpoint", "--fsdp-no-reshard-after-forward",
                 "--fsdp-offload-cpu", "--ddp-static-graph", "--no-set-device-rank",
                 "--use-bn-sync"):
        noop.add_argument(flag, action="store_true", default=False, help=argparse.SUPPRESS)

    # checkpointing
    parser.add_argument("--save-frequency", type=int, default=1)
    parser.add_argument("--save-most-recent", action="store_true", default=False,
                        help="keep epoch_latest.pt pointing at (or holding) the last epoch")
    parser.add_argument("--delete-previous-checkpoint", action="store_true", default=False,
                        help="delete the checkpoint --save-frequency epochs back")
    parser.add_argument("--resume", type=str, default=None, help="path or 'latest'")

    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                             "plain PyTorch path")

    parsed_only = parser.add_argument_group("accepted and not read, as in the JAX CLI")
    for flags, kw in _NOOP:
        parsed_only.add_argument(*flags, **kw, help=argparse.SUPPRESS)

    group = parser.add_argument_group("not ported yet (raise when set)")
    unported = []
    for flags, kw in _UNPORTED:
        action = group.add_argument(*flags, **kw, help=argparse.SUPPRESS)
        unported.append((flags[0], action.dest, kw["default"]))

    ns = parser.parse_args(args)
    used = [flag for flag, dest, default in unported if getattr(ns, dest) != default]
    if ns.mesh_tensor != 1:
        used.append(f"--mesh-tensor {ns.mesh_tensor} (tensor parallelism)")
    if used:
        raise NotImplementedError(f"not ported yet: {', '.join(used)}")

    if ns.use_bnb_linear:
        ns.use_switchback = True
    if ns.json_text_key:
        ns.wds_caption_key = f"json:{ns.json_text_key}"
    for k, v in get_default_params(ns.model).items():
        if getattr(ns, k, None) is None:
            setattr(ns, k, v)
    ns.world_size, ns.rank = 1, 0  # main sets them once the process group exists
    return ns
