#!/usr/bin/env python3
"""Time the bf16 attention backward on wgmma at the wide head dims
(`wgmma_wide_bwd_dq_kernel` and `wgmma_wide_bwd_dkv_kernel` in
`mrclip_tpu_torch/csrc/attn_mma_bwd.cuh`: K3, K5 and K10b at D = 72-112,
and at D = 64 past 256 rows, up to 272 rows, not causal) beside variants of
its design, on one CUDA card, in turns within one process.

    python3 tools/attn_wide_bwd_variants.py [--variants committed,mma_sync,one_wg,...]
                                            [--out build/attn_wide_bwd_variants.json]

Each variant is the committed sources with text edits to attn_mma_bwd.cuh
(and, for the `mma.sync` route, attn_mma_fwd.cuh), built by
`chip_smoke.build_fwd_variant` into `build/variants/fwd_<name>/` (the
forward and backward sources, one nvcc each, all variants started
together); the package's own wrappers run each build through
`chip_smoke.fwd_libraries`.
  committed  the sources as they are: one warpgroup a block, two blocks an
             SM, where two such blocks fit an SM's shared memory at 272 rows
             (the dq pass to D = 88, the dk/dv pass to 80), else two
             warpgroups a block sharing the staged pair, one block an SM;
  mma_sync   the route the wide kernels replaced (mma_bwd_*:
             `chip_smoke.MMA_SYNC_EDITS` and `MMA_SYNC_BWD_EDITS`);
  one_wg     one warpgroup a block at every width (one block of four warps
             an SM where two do not fit);
  two_wg     two warpgroups a block at every width (one block an SM, not
             two, at D <= 80).
For each it prints ptxas's registers and spills of the wide backward
kernels, checks K3, K5 and K10b against their plain versions at the timed
shapes (chip_smoke's GRAD_TOL of the call's largest max |plain|), and times
them at the routed towers' shapes, b256 and b32 (N 257, H 16 at D = 64, 80,
88, 104 and 112; SO400M's N 256 at D = 72; its text, N 64, one 64-row
sub-tile a side, runs the mma.sync route in every build): medians of
chip_smoke.FWD_RUNS rounds of CUDA-event readings, the variants in turns
within each round, and the profiler's device time per launch. Needs one
CUDA card; imports no JAX.
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

WGS = "  return wide_bwd_smem(D, kWideKeys, DKV, FLASH, 1) <= kTwoBlocksSmem ? 1 : 2;"
# (attn_mma_fwd.cuh edits, attn_mma_bwd.cuh edits)
VARIANTS = {
    "committed": ([], []),
    "mma_sync": (cs.MMA_SYNC_EDITS, cs.MMA_SYNC_BWD_EDITS),
    "one_wg": ([], [(WGS, "  return 1;")]),
    "two_wg": ([], [(WGS, "  return 2;")]),
}
TOWER = dict(h=16, causal=False)
SHAPES = {f"d{d}_{tag}_b{b}": dict(TOWER, b=b, n=n, nk=n, d=d)
          for d, tag, n in ((64, "n257", 257), (72, "n256", 256), (80, "n257", 257),
                            (88, "n257", 257), (104, "n257", 257), (112, "n257", 257))
          for b in (cs.TRAIN_BATCH, 32)}
SOURCES = (*cs.FWD_SOURCES, *cs.BWD_SOURCES)


def registers(name):
    """ptxas's lines for the variant's wide backward instantiations."""
    lines = []
    for src in SOURCES:
        log = build.build_dir().parent / "variants" / f"fwd_{name}" / f"{src}.log"
        entry = ""
        for line in (log.read_text() if log.is_file() else "").splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line) and "wide_bwd" in entry:
                lines.append(f"{src}: {entry}: {line.strip()}")
    return lines


def calls(shape, gen):
    """{kernel: (call, plain call)} of K3, K5 and K10b on one set of bf16
    inputs (column slices of one projection; K5 on their grouped copies)."""
    h, d = shape["h"], shape["d"]
    bf16 = torch.bfloat16
    q, k, v = cs.qkv_slices(shape, bf16, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(bf16)
    o, lse = fa.fused_attention_packed(q, k, v, heads=h)
    qg, kg, vg, dog = (fa.group_heads(t.unflatten(-1, (h, d))) for t in (q, k, v, do))
    og, lseg = fa.fused_attention_grouped(qg, kg, vg)
    q3, k3, v3, do3 = (t.unflatten(-1, (h, d)) for t in (q, k, v, do))
    of, l, m = fl.flash_attention(q3, k3, v3)
    di = fl.flash_di(of, do3)
    return {"K3": (lambda: fa.fused_attention_packed_bwd(q, k, v, o, do, lse, heads=h),
                   lambda: fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, heads=h)),
            "K5": (lambda: fa.fused_attention_grouped_bwd(qg, kg, vg, og, dog, lseg),
                   lambda: fa.fused_attention_bwd_ref(qg, kg, vg, og, dog, lseg)),
            "K10b": (lambda: fl.flash_attention_bwd(q3, k3, v3, do3, l, m, di),
                     lambda: fl.flash_attention_bwd_ref(q3, k3, v3, do3, l, m, di))}


def check(tag, got, want):
    scale = max(w.float().abs().max().item() for w in want)
    err = max(cs.rel_err(g, w, scale) for g, w in zip(got, want))
    if not err <= cs.GRAD_TOL[torch.bfloat16]:
        raise AssertionError(f"{tag}: max|d-plain| / max|plain| {err:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=str(ROOT / "build" / "attn_wide_bwd_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_wide_bwd_variants: no CUDA device available", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    card = cs.smi_name_power()
    print(f"[variants] {torch.cuda.get_device_name(0)} | {card}", flush=True)
    build.load_libraries(SOURCES)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: cs.build_fwd_variant(n, *VARIANTS[n]), names)))
    out = {"card": card, "registers": {}, "shapes": {}}
    for name in names:
        out["registers"][name] = registers(name)
        for line in out["registers"][name]:
            print(f"[ptxas] {name}: {line}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(24)
    for label, shape in SHAPES.items():
        fns, res = {}, {}
        for kernel, (call, plain) in calls(shape, gen).items():
            want = plain()
            for name in names:
                fn = cs.on_libraries(call, libs[name])
                check(f"{name} {kernel} {label}", fn(), want)
                fns[f"{kernel}/{name}"] = fn
        t, reads = cs.median_ms(fns, 10)
        dev = cs.device_ms(fns)
        args_ = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        bound = cs.attention_bwd_bound(**args_, dtype=torch.bfloat16)[0]
        for key in fns:
            res[key] = {"ms": t[key], "device_ms": dev[key], "readings": reads[key]}
        out["shapes"][label] = {"shape": shape, "bound_ms": bound, "results": res}
        for kernel in ("K3", "K5", "K10b"):
            print(f"[time] {label} {kernel}: " + ", ".join(
                f"{name} {t[f'{kernel}/{name}']:.4f} / {cs.fmt_ms(dev[f'{kernel}/{name}'])}"
                for name in names) + f" ms (event median / device); K3's bound {bound:.4f} ms",
                flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"[variants] readings written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
