#!/usr/bin/env python3
"""Time the bf16 attention forward on wgmma at the wide head dims
(`wgmma_wide_fwd_kernel` in `mrclip_tpu_torch/csrc/attn_mma_fwd.cuh`: K1,
K4 and K10 at D = 72-112, and at D = 64 past 256 keys, up to 272 keys)
beside variants of its design, on one CUDA card, in turns within one
process.

    python3 tools/attn_wide_fwd_variants.py [--variants committed,mma_sync,one_wg,...]
                                            [--out build/attn_wide_fwd_variants.json]

Each variant is the committed sources with text edits to that header, built
by `chip_smoke.build_fwd_variant` into `build/variants/fwd_<name>/` (K1's,
K4's and K10's sources, one nvcc each, all variants started together); the
package's own wrappers run each build through `chip_smoke.fwd_libraries`.
  committed     the sources as they are: one warpgroup a block, two blocks
                an SM, where two such blocks fit an SM's shared memory (D <=
                80 at 272 keys), else two warpgroups a block sharing K and V
                (D = 88-112);
  mma_sync      the route the wide kernel replaced (mma_fwd_kernel:
                `chip_smoke.MMA_SYNC_EDITS`);
  one_wg        one warpgroup a block at every width (D = 88-112: one block
                of four warps an SM);
  two_wg        two warpgroups a block at every width (D <= 80: one block an
                SM, not two);
  no_dead_skip  K10's several-block form takes the softmax in every warp,
                also those whose 16 rows all lie past n (N = 257's fifth
                sub-tile holds one row; K1 and K4 take it in every warp);
  batch_first   the blocks ordered sample first, then head (as the other
                attention kernels), not head first: neighbouring blocks no
                longer share the sectors that split rows of D = 72, 88 and
                104 (144, 176, 208 bytes) between heads.
For each it prints ptxas's registers and spills of wgmma_wide_fwd_kernel,
checks K1, K4 and K10 against their plain versions at the timed shapes
(chip_smoke's O_TOL and LSE_TOL), and times them at the routed towers'
shapes, b256 and b32 (N 257, H 16 at D = 64, 80, 88, 104 and 112; SO400M's
N 256 and text N 64 at D = 72): medians of chip_smoke.FWD_RUNS rounds of
CUDA-event readings, the variants in turns within each round, and the
profiler's device time per launch. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mrclip_tpu_torch.ops import build  # noqa: E402
from mrclip_tpu_torch.ops import flash_attn as fl  # noqa: E402
from mrclip_tpu_torch.ops import fused_attn as fa  # noqa: E402

WGS = "  return wide_smem_bytes(D, G, 1) <= kTwoBlocksSmem ? 1 : 2;"
VARIANTS = {
    "committed": [],
    "mma_sync": cs.MMA_SYNC_EDITS,
    "one_wg": [(WGS, "  return 1;")],
    "two_wg": [(WGS, "  return 2;")],
    "no_dead_skip": [("const bool live = wrow0 < n;", "const bool live = true;")],
    "batch_first": [("const long long b = blockIdx.x / heads;",
                     "const long long b = blockIdx.x % (gridDim.x / heads);"),
                    ("const int h = blockIdx.x % heads;",
                     "const int h = blockIdx.x / (gridDim.x / heads);")],
}
TOWER = dict(h=16, causal=False)
SHAPES = {f"d{d}_{tag}_b{b}": dict(TOWER, b=b, n=n, nk=n, d=d)
          for d, tag, n in ((64, "n257", 257), (72, "n256", 256), (72, "text_n64", 64),
                            (80, "n257", 257), (88, "n257", 257), (104, "n257", 257),
                            (112, "n257", 257))
          for b in (cs.TRAIN_BATCH, 32)}


def registers(name):
    """ptxas's lines for the variant's wgmma_wide_fwd_kernel instantiations."""
    lines = []
    for src in cs.FWD_SOURCES:
        log = build.build_dir().parent / "variants" / f"fwd_{name}" / f"{src}.log"
        entry = ""
        for line in (log.read_text() if log.is_file() else "").splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line) and "wide_fwd" in entry:
                lines.append(f"{src}: {entry}: {line.strip()}")
    return lines


def calls(shape, gen):
    """{kernel: (call, plain call, stat kinds)} of K1, K4 and K10 on one
    set of bf16 inputs (column slices of one projection; K4 on their
    grouped copies)."""
    h, d = shape["h"], shape["d"]
    q, k, v = cs.qkv_slices(shape, torch.bfloat16, gen)
    q3, k3, v3 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
    qg, kg, vg = (fa.group_heads(t) for t in (q3, k3, v3))
    return {"K1": (lambda: fa.fused_attention_packed(q, k, v, heads=h),
                   lambda: fa.fused_attention_packed_ref(q, k, v, heads=h), ["lse"]),
            "K4": (lambda: fa.fused_attention_grouped(qg, kg, vg),
                   lambda: fa.fused_attention_ref(qg, kg, vg), ["lse"]),
            "K10": (lambda: fl.flash_attention(q3, k3, v3),
                    lambda: fl.flash_attention_ref(q3, k3, v3), ["l", "m"])}


def check(tag, got, want, kinds):
    err_o = cs.abs_err(got[0], want[0])
    err_s = [cs.rel_err(a, b, 1.0) if kind != "l" else ((a - b).abs() / b).max().item()
             for a, b, kind in zip(got[1:], want[1:], kinds)]
    ok = err_o <= cs.O_TOL[torch.bfloat16] and max(err_s) <= cs.LSE_TOL
    if not ok:
        raise AssertionError(f"{tag}: max|o-plain| {err_o:.3e}, stats {err_s}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=str(ROOT / "build" / "attn_wide_fwd_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_wide_fwd_variants: no CUDA device available", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    card = cs.smi_name_power()
    print(f"[variants] {torch.cuda.get_device_name(0)} | {card}", flush=True)
    build.load_libraries(cs.FWD_SOURCES)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: cs.build_fwd_variant(n, VARIANTS[n]), names)))
    out = {"card": card, "registers": {}, "shapes": {}}
    for name in names:
        out["registers"][name] = registers(name)
        for line in out["registers"][name]:
            print(f"[ptxas] {name}: {line}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(23)
    for label, shape in SHAPES.items():
        fns, res = {}, {}
        for kernel, (call, plain, kinds) in calls(shape, gen).items():
            want = plain()
            for name in names:
                fn = cs.on_libraries(call, libs[name])
                check(f"{name} {kernel} {label}", fn(), want, kinds)
                fns[f"{kernel}/{name}"] = fn
        t, reads = cs.median_ms(fns, 20)
        dev = cs.device_ms(fns)
        args_ = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        bound = cs.attention_bound(**args_, dtype=torch.bfloat16)[0]
        for key in fns:
            res[key] = {"ms": t[key], "device_ms": dev[key], "readings": reads[key]}
        out["shapes"][label] = {"shape": shape, "bound_ms": bound, "results": res}
        for kernel in ("K1", "K4", "K10"):
            print(f"[time] {label} {kernel}: " + ", ".join(
                f"{name} {t[f'{kernel}/{name}']:.4f} / {cs.fmt_ms(dev[f'{kernel}/{name}'])}"
                for name in names) + f" ms (event median / device); bound {bound:.4f} ms",
                flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"[variants] readings written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
