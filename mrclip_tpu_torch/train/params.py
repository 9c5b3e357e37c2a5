"""Training CLI flags of the port: the JAX package's flag set
(`mrclip_tpu/train/params.py`: the open_clip flags, the MR-CLIP additions
and per-family optimizer defaults), plus `--device` (default: the CUDA
card; `--device cpu` runs on the CPU).

The flags of parts the port does not have yet are accepted here and refused
by `train.main` with the ROADMAP item that brings them; the torch-only flags
the JAX package ignores (--dist-url, --dist-backend, --horovod,
--ddp-static-graph, --torchscript, --torchcompile, --trace, --use-bn-sync,
--use-bnb-linear, --no-set-device-rank, --force-custom-text) are ignored
with a warning.
"""

from __future__ import annotations

import argparse
import logging


def get_default_params(model_name: str) -> dict:
    """Per-family optimizer defaults (reference params.py:5-11)."""
    model_name = model_name.lower()
    if "vit" in model_name:
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


class ParseKwargs(argparse.Action):
    """`--aug-cfg key=val` parser (reference params.py:14-23)."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, v = value.split("=")
            try:
                kw[key] = eval(v)  # noqa: S307 - matches reference ast-ish behavior
            except Exception:
                kw[key] = v
        setattr(namespace, self.dest, kw)


_IGNORED_TORCH_FLAGS = [
    "--dist-url", "--dist-backend", "--horovod", "--ddp-static-graph",
    "--torchscript", "--torchcompile", "--trace", "--use-bn-sync", "--use-bnb-linear",
    "--no-set-device-rank", "--force-custom-text",
]


def parse_args(args=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("mrclip_tpu_torch training")

    # data
    p.add_argument("--train-data", type=str, default=None)
    p.add_argument("--train-data-upsampling-factors", type=str, default=None)
    p.add_argument("--val-data", type=str, default=None)
    p.add_argument("--train-num-samples", type=int, default=None)
    p.add_argument("--val-num-samples", type=int, default=None)
    p.add_argument(
        "--dataset-type",
        choices=["webdataset", "csv", "csv-unique-sampler", "synthetic", "auto"],
        default="auto",
    )
    p.add_argument("--dataset-resampled", default=False, action="store_true")
    p.add_argument("--csv-separator", type=str, default=",")
    p.add_argument("--csv-img-key", type=str, default="filepath")
    p.add_argument("--csv-caption-key", type=str, default="title")
    p.add_argument("--imagenet-val", type=str, default=None)
    p.add_argument("--imagenet-v2", type=str, default=None)
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--workers", type=int, default=4)

    # MR-CLIP specifics
    p.add_argument("--multipositiveloss", default=False, action="store_true")
    p.add_argument("--delta", type=float, default=0.5)
    p.add_argument("--lam", type=float, default=None)
    p.add_argument("--distance", default=False, action="store_true")
    p.add_argument("--visiononly", default=False, action="store_true")
    p.add_argument("--tabular", default=False, action="store_true")
    p.add_argument("--unique", default=False, action="store_true")
    p.add_argument("--metrics", default=False, action="store_true")
    p.add_argument("--tracepreds", default=False, action="store_true")
    p.add_argument("--test", default=False, action="store_true")
    p.add_argument("--linear", default=False, action="store_true")
    p.add_argument("--freeze", default=False, action="store_true")
    p.add_argument("--freezelast", default=False, action="store_true")
    p.add_argument("--textdropout", type=float, default=0.0)
    p.add_argument("--logitscaletrainable", default=False, action="store_true")
    p.add_argument("--tsne", default=False, action="store_true")

    # logging / bookkeeping
    p.add_argument("--logs", type=str, default="./logs/")
    p.add_argument("--log-local", action="store_true", default=False)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--log-every-n-steps", type=int, default=100)
    p.add_argument("--report-to", default="", type=str)
    p.add_argument("--wandb-notes", default="", type=str)
    p.add_argument("--wandb-project-name", type=str, default="open-clip")
    p.add_argument("--debug", default=False, action="store_true")
    p.add_argument("--copy-codebase", default=False, action="store_true")

    # optimization
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=32)
    p.add_argument("--epochs-cooldown", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--beta1", type=float, default=None)
    p.add_argument("--beta2", type=float, default=None)
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--wd", type=float, default=0.2)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--warmup", type=int, default=10000)
    p.add_argument("--opt", type=str, default="adamw")
    p.add_argument("--skip-scheduler", action="store_true", default=False)
    p.add_argument("--lr-scheduler", type=str, default="cosine")
    p.add_argument("--lr-cooldown-end", type=float, default=0.0)
    p.add_argument("--lr-cooldown-power", type=float, default=1.0)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--accum-freq", type=int, default=1)
    p.add_argument("--grad-checkpointing", default=False, action="store_true")
    p.add_argument(
        "--remat-policy", choices=["full", "dots", "mlp_only"], default="dots",
        help="what --grad-checkpointing saves: dots (weight-matmul outputs), "
        "mlp_only (attention outputs; recompute MLP hiddens), full",
    )
    p.add_argument(
        "--attn-impl", choices=["xla", "manual", "bf16", "flash", "fused", "fusedp"], default="xla",
        help="attention kernel; bf16 = scores stored in compute dtype "
        "(halves attention HBM traffic, ~3 digits on logits); "
        "fusedp/fused/flash = the hand-written CUDA attention kernels",
    )
    p.add_argument(
        "--gelu-approx", default=False, action="store_true",
        help="tanh-approximate GELU (throughput mode: keeps the erf off the "
        "VPU inside the MLP matmul fusion; max |delta| ~1e-3 per activation)",
    )
    p.add_argument(
        "--bf16-moments", default=False, action="store_true",
        help="store the Adam/Lion first moment in bf16 (halves mu HBM)",
    )

    # checkpointing
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--save-most-recent", action="store_true", default=False)
    p.add_argument("--resume", default=None, type=str)
    p.add_argument("--delete-previous-checkpoint", default=False, action="store_true")
    p.add_argument("--remote-sync", type=str, default=None)
    p.add_argument("--remote-sync-frequency", type=int, default=300)
    p.add_argument("--remote-sync-protocol", choices=["s3", "fsspec"], default="s3")

    # eval cadence
    p.add_argument("--zeroshot-frequency", type=int, default=2)
    p.add_argument("--val-frequency", type=int, default=1)

    # model
    p.add_argument("--model", type=str, default="ViT-B-16")
    p.add_argument("--pretrained", default="", type=str)
    p.add_argument("--pretrained-image", default=False, action="store_true")
    p.add_argument("--precision", choices=[
        "amp", "amp_bf16", "amp_bfloat16", "bf16", "fp16", "pure_bf16", "pure_fp16", "fp32",
    ], default="amp")
    p.add_argument("--lock-image", default=False, action="store_true")
    p.add_argument("--lock-image-unlocked-groups", type=int, default=0)
    p.add_argument("--lock-image-freeze-bn-stats", default=False, action="store_true")
    p.add_argument("--lock-text", default=False, action="store_true")
    p.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    p.add_argument("--lock-text-freeze-layer-norm", default=False, action="store_true")
    p.add_argument("--force-quick-gelu", default=False, action="store_true")
    p.add_argument("--force-patch-dropout", default=None, type=float)
    p.add_argument("--force-image-size", type=int, nargs="+", default=None)
    p.add_argument("--aug-cfg", nargs="*", default={}, action=ParseKwargs)

    # losses
    p.add_argument("--local-loss", default=False, action="store_true")
    p.add_argument("--gather-with-grad", default=False, action="store_true")
    p.add_argument("--coca-caption-loss-weight", type=float, default=2.0)
    p.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0)
    p.add_argument("--distill-model", default=None)
    p.add_argument("--distill-pretrained", default=None)
    p.add_argument("--siglip", default=False, action="store_true")
    p.add_argument("--loss-dist-impl", default="bidir", type=str)

    # misc
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device to train on (default: the CUDA card; 'cpu' for the CPU)")

    # the JAX package's additions
    p.add_argument("--mesh-fsdp", type=int, default=1, help="fsdp mesh axis size")
    p.add_argument("--mesh-tp", type=int, default=1, help="tensor-parallel mesh axis size")
    p.add_argument(
        "--device-augment", default=False, action="store_true",
        help="run the MR-CLIP train augmentation (crop, affine, flip, blur, colour extras, "
             "normalise) on the card on the loader's images (as in the JAX package, on top "
             "of the host transform or the native loader's warp)",
    )
    p.add_argument(
        "--cached-features-accum", default=False, action="store_true",
        help="reference cached-feature grad accumulation (train.py:134-183)",
    )
    p.add_argument("--unique3d", default=False, action="store_true",
                   help="Unique3DSampler instead of UniqueLabelSampler")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="capture a torch.profiler trace window (a Chrome trace) to this dir")
    p.add_argument("--pallas-loss", default=False, action="store_true",
                   help="fused multipositive loss kernels (K6/K7: the logits never reach memory)")
    p.add_argument("--chunked-loss", default=False, action="store_true",
                   help="streaming multipositive loss (no N^2 logits; 32k-batch "
                        "path); for CoCa models, streams the captioning CE per "
                        "sequence chunk (no [B, T, vocab] logits)")
    p.add_argument("--loss-chunk-size", type=int, default=1024)
    p.add_argument("--caption-chunk-size", type=int, default=16,
                   help="sequence chunk for the CoCa streaming captioning CE")
    p.add_argument("--native-loader", default=False, action="store_true",
                   help="C++ threaded PNG decode, resize and train warp into uint8 "
                        "canvases (built from the package's C++ sources with the system "
                        "compiler; --workers threads, 0 = every core)")

    # torch-only flags: accepted, ignored
    for flag in _IGNORED_TORCH_FLAGS:
        p.add_argument(flag, nargs="?", const=True, default=None, help=argparse.SUPPRESS)

    ns = p.parse_args(args)

    for flag in _IGNORED_TORCH_FLAGS:
        key = flag.lstrip("-").replace("-", "_")
        if getattr(ns, key, None) not in (None, False):
            logging.warning(f"{flag} is ignored")

    if ns.lr is None or ns.beta1 is None or ns.beta2 is None or ns.eps is None:
        defaults = get_default_params(ns.model)
        for name, val in defaults.items():
            if getattr(ns, name) is None:
                setattr(ns, name, val)
    ns.distill = ns.distill_model is not None and ns.distill_pretrained is not None
    return ns
