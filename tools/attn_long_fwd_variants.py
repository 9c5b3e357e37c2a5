#!/usr/bin/env python3
"""Time the bf16 attention forward past 272 keys (`wgmma_long_fwd_kernel` in
`mrclip_tpu_torch/csrc/attn_mma_fwd.cuh`: K1, K4 and K10, not causal, D =
64-112) beside variants of its design and the route it replaced, on one
CUDA card, in turns within one process.

    python3 tools/attn_long_fwd_variants.py [--variants committed,mma_sync,...]
                                            [--shapes d72_n729_b32,...]
                                            [--out build/attn_long_fwd_variants.json]

Each variant is the committed sources with text edits to that header, built
by `chip_smoke.build_fwd_variant` into `build/variants/fwd_<name>/` (K1's,
K4's and K10's sources, one nvcc each, all variants started together); the
package's own wrappers run each build through `chip_smoke.fwd_libraries`.
  committed    the sources as they are: K resident in shared memory where
               it fits (every long tower's shape), V through a ring of
               three 64-key tiles, a block walking the row blocks of its
               head in turn, two consumer warpgroups a block, K10 in one
               pass over a jax block of at most two tiles (128 keys);
  k10_two_pass  K10 with a pass A (the block's max) and a pass B over
               every jax block, S computed twice;
  mma_sync     the route the long kernel replaced (mma_fwd_kernel:
               `chip_smoke.MMA_SYNC_EDITS`);
  streamed     K streamed through the ring beside V at every shape (twice
               a row block), one row block a block;
  one_row_block  K resident, but one row block a block;
  two_stages   a ring of two tiles;
  four_stages  a ring of four tiles (D = 104 and 112 at N = 577 then
               stream K: their resident K no longer fits);
  long_at_257  every shape past 256 keys on the long kernel, so that it
               times against wgmma_wide_fwd_kernel at N = 257 (the
               committed route there).
For each it prints ptxas's registers and spills of wgmma_long_fwd_kernel,
checks K1, K4 and K10 against their plain versions at the timed shapes
(chip_smoke's O_TOL and LSE_TOL) and K10 against the mma_sync build's bits
where that build is timed, and times them: medians of chip_smoke.FWD_RUNS
rounds of CUDA-event readings, the variants in turns within each round, and
the profiler's device time per launch, beside SDPA's forward and the bound.
Needs one CUDA card; imports no JAX.
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

VARIANTS = {
    "committed": [],
    "mma_sync": cs.MMA_SYNC_EDITS,
    "k10_two_pass": [("    if (resident && blk_k <= kLongHeld * kLongKeys)", "    if (false)")],
    "streamed": [("  const bool resident = long_smem_bytes(D, ktiles) <= kMaxSmem;",
                  "  const bool resident = false;")],
    "one_row_block": [("  int iters = 1;\n  if (resident) {", "  int iters = 1;\n  if (false) {")],
    "two_stages": [("constexpr int kLongStages = 3;", "constexpr int kLongStages = 2;")],
    "four_stages": [("constexpr int kLongStages = 3;", "constexpr int kLongStages = 4;")],
    "long_at_257": [("  if (nk <= kWideKeys) return kRouteWide;",
                     "  if (nk <= kWgKeys) return kRouteWide;")],
}
# chip_smoke's long shapes at b32 (LONG_SHAPES), ViT-H-14-CLIPA-336's vision
# (D 80, N 577: K10 in one pass), and the wide route's N = 257 at D = 104
# and 112, b256 (ViT-bigG-14's and EVA02-E-14's vision)
SHAPES = {**{f"{label}_b32": shape for label, shape in cs.LONG_SHAPES.items()},
          "d80_n577_b32": dict(b=32, n=577, nk=577, h=16, d=80, causal=False),
          **{f"d{d}_n257_b256": dict(b=cs.TRAIN_BATCH, n=257, nk=257, h=16, d=d, causal=False)
             for d in (104, 112)}}


def registers(name):
    """ptxas's lines for the variant's wgmma_long_fwd_kernel instantiations."""
    lines = []
    for src in cs.FWD_SOURCES:
        log = build.build_dir().parent / "variants" / f"fwd_{name}" / f"{src}.log"
        entry = ""
        for line in (log.read_text() if log.is_file() else "").splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line) and "long_fwd" in entry:
                lines.append(f"{src}: {entry}: {line.strip()}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default=str(ROOT / "build" / "attn_long_fwd_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_long_fwd_variants: no CUDA device available", file=sys.stderr)
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
    gen = torch.Generator(device="cuda").manual_seed(25)
    for label in args.shapes.split(","):
        shape = SHAPES[label]
        fns, res = {}, {}
        calls, sdpa = cs.long_calls(shape, gen)
        for kernel, (call, plain, kinds) in calls.items():
            want = plain()
            got = {}
            for name in names:
                fn = cs.on_libraries(call, libs[name])
                got[name] = fn()
                cs.check_forward(f"{name} {kernel} {label}", got[name], want, kinds)
                fns[f"{kernel}/{name}"] = fn
            if kernel == "K10" and "mma_sync" in got:
                for name in names:
                    same = cs.bits_equal(got[name], got["mma_sync"])
                    res[f"K10/{name}_bit_equal_vs_mma_sync"] = same
                    print(f"[bits] {label} K10 {name} vs mma_sync: o, l, m bit-equal {same}",
                          flush=True)
        fns["sdpa"] = sdpa
        t, reads = cs.median_ms(fns, 10)
        dev = cs.device_ms(fns)
        args_ = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        bound = cs.attention_bound(**args_, dtype=torch.bfloat16)
        for key in fns:
            res[key] = {"ms": t[key], "device_ms": dev[key], "readings": reads[key]}
        out["shapes"][label] = {"shape": shape, "bound_ms": bound[0], "bound_by": bound[1],
                                "results": res}
        for kernel in ("K1", "K4", "K10"):
            print(f"[time] {label} {kernel}: " + ", ".join(
                f"{name} {t[f'{kernel}/{name}']:.4f} / {cs.fmt_ms(dev[f'{kernel}/{name}'])}"
                for name in names) + f" ms (event median / device); SDPA {t['sdpa']:.4f} / "
                f"{cs.fmt_ms(dev['sdpa'])}; bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"[variants] readings written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
