"""How far apart the gradients of a deep post-norm EVA02-E tower are under
two attention paths, on the CPU.

Builds EVA02-E-14 at a narrow width (`--width`, heads of 112) and
`--layers` post-norm vision layers with the factory's random weights,
optionally scales each vision q and k row by `--scale` (what
`chip_smoke.tame_post_norm_scores` does with 1 / sqrt(layers)), and takes
the multipositive loss's gradients at one batch under plain attention in
fp32 and bf16, the packed kernels' plain versions ('fusedp') in bf16 and
jax's flash block walk ('flash') in fp32 and bf16. It prints the loss of
each and the cosine of each gradient set against the others, whole and the
lowest over tensors of 10**4 or more elements. Nothing here runs on a card.

    python3 tools/post_norm_grads.py --layers 64 --scale 1
    python3 tools/post_norm_grads.py --layers 64 --scale 0.125
    python3 tools/post_norm_grads.py --layers 8 --scale 1
"""

import argparse
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mrclip_tpu_torch import create_loss, factory  # noqa: E402
from mrclip_tpu_torch.models import clip  # noqa: E402
from mrclip_tpu_torch.ops.image_ops import normalize_images  # noqa: E402
from mrclip_tpu_torch.parallel import make_loss_apply  # noqa: E402
from mrclip_tpu_torch.parallel.train_step import loss_and_grads  # noqa: E402


def cosines(a, b):
    """(whole, lowest per tensor of >= 10**4 elements), float64."""
    dot = na = nb = 0.0
    worst = 1.0
    for name, x in a.items():
        x, y = x.double().flatten(), b[name].double().flatten()
        d, nx, ny = (x @ y).item(), (x @ x).item(), (y @ y).item()
        dot, na, nb = dot + d, na + nx, nb + ny
        if x.numel() >= 10**4:
            worst = min(worst, d / max(np.sqrt(nx * ny), 1e-300))
    return dot / np.sqrt(na * nb), worst


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--layers", type=int, default=64)
    p.add_argument("--width", type=int, default=448)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--threads", type=int, default=8)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    clip._EVA_DIMS["enormous"] = (args.width, args.layers, args.width // 112)
    cfg = factory.get_model_config("EVA02-E-14")
    text = dict(cfg["text_cfg"], width=128, heads=2)
    kw = dict(device="cpu", gelu_approx=True, text_cfg=text, embed_dim=64)
    bf16 = factory.create_model("EVA02-E-14", precision="bf16", attn_impl="xla", **kw)
    with torch.no_grad():
        for block in bf16.visual.trunk.blocks:
            w = block.attn.qkv.weight
            w[: 2 * w.shape[1]] *= args.scale
    fp32 = factory.create_model("EVA02-E-14", pretrained=bf16.state_dict(), precision="fp32",
                                attn_impl="xla", **kw)
    rng = np.random.RandomState(1)
    n = args.batch
    batch = {
        "images": normalize_images(torch.from_numpy(
            rng.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8))),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (n, 77))),
        "labels": torch.from_numpy(rng.randint(0, 32, (n,)).astype(np.int32)),
    }
    loss = make_loss_apply(create_loss(SimpleNamespace(
        multipositiveloss=True, delta=0.5, model="EVA02-E-14", gather_with_grad=True,
        pallas_loss=True)))

    def grads(model, impl):
        for m in model.modules():
            if hasattr(m, "attn_impl"):
                m.attn_impl = impl
        g, ld = loss_and_grads(model, loss, dict(model.named_parameters()), batch)
        return g, ld["loss"].item()

    runs = {"fp32 xla": grads(fp32, "xla"), "fp32 flash": grads(fp32, "flash"),
            "bf16 xla": grads(bf16, "xla"), "bf16 fusedp": grads(bf16, "fusedp"),
            "bf16 flash": grads(bf16, "flash")}
    print(f"EVA02-E-14, vision {args.width} wide x {args.layers} post-norm layers, heads of "
          f"112, q and k rows x {args.scale}, b{n}, CPU")
    for name, (_, value) in runs.items():
        print(f"  loss {name}: {value:.6f}")
    for a, b in (("fp32 flash", "fp32 xla"), ("bf16 xla", "fp32 xla"),
                 ("bf16 fusedp", "fp32 xla"), ("bf16 flash", "fp32 xla"),
                 ("bf16 fusedp", "bf16 xla"), ("bf16 flash", "bf16 xla")):
        whole, worst = cosines(runs[a][0], runs[b][0])
        print(f"  {a} vs {b}: gradient cosine whole {whole:.6f}, lowest per tensor {worst:.6f}")


if __name__ == "__main__":
    main()
