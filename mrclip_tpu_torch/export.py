"""Export CLI of the port: model (+ open_clip checkpoint) -> servable artifact
(counterpart of `mrclip_tpu/export.py`).

Usage:
  python -m mrclip_tpu_torch.export --model ViT-B-16 \
      [--checkpoint open_clip.pt] [--precision bf16] [--gelu-approx] \
      [--attn-impl fusedp|fused|bf16|manual|xla] [--device cpu] --output model.mrclip
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    p = argparse.ArgumentParser("mrclip_tpu_torch export")
    p.add_argument("--model", required=True, help="model config name, e.g. ViT-B-16")
    p.add_argument("--checkpoint", default=None,
                   help="open_clip-layout torch .pt state dict to bake in (default: random init)")
    p.add_argument("--precision", default="fp32", help="compute dtype baked into the artifact")
    p.add_argument("--gelu-approx", action="store_true",
                   help="tanh-approximate GELU in the artifact (serving throughput mode)")
    p.add_argument("--attn-impl", default="fusedp",
                   choices=["xla", "manual", "bf16", "fused", "fusedp"],
                   help="attention baked into the artifact (the JAX export's choices): "
                   "fusedp = the packed Hopper kernels, fused = the grouped-layout ones, "
                   "xla/manual/bf16 = plain softmax math")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run without one)")
    p.add_argument("--output", required=True, help="output .mrclip artifact path")
    args = p.parse_args(argv)

    from .factory import create_model
    from .serving import export_model, save_exported

    model = create_model(
        args.model,
        pretrained=args.checkpoint,
        precision=args.precision,
        device=args.device,
        attn_impl=args.attn_impl,
        gelu_approx=args.gelu_approx,
    )
    save_exported(export_model(model), args.output)
    print(f"exported {args.model} -> {args.output} "
          f"(precision={args.precision}, attn_impl={args.attn_impl})")
    return args.output


if __name__ == "__main__":
    main()
