#!/usr/bin/env python3
"""Time the bf16 attention backward past 272 rows (`wgmma_long_bwd_dq_kernel`
and `wgmma_long_bwd_dkv_kernel` in `mrclip_tpu_torch/csrc/attn_mma_bwd.cuh`:
K3, K5 and K10b, not causal, without the rope, D = 64-112) beside variants
of its design and the route it replaced, on one CUDA card, in turns within
one process.

    python3 tools/attn_long_bwd_variants.py [--variants committed,mma_sync,...]
                                            [--shapes d72_n729_b32,...]
                                            [--out build/attn_long_bwd_variants.json]

Each variant is the committed sources with text edits to that header, K3's,
K5's and K10b's sources built by `chip_smoke.build_fwd_variant` into
`build/variants/fwd_lbwd_<name>/` (one nvcc each, all variants started
together); the package's own wrappers run each build through
`chip_smoke.fwd_libraries` (the forwards stay the package's).
  committed     the sources as they are: each pass streams its staged pair
                (K and V; Q and dO with their rows' statistics) through a
                ring of three 64-row tiles that one producer warpgroup fills
                and two consumer warpgroups share, 64 rows (keys) each, one
                block a 128-row (128-key) block of a head;
  mma_sync      the route the long kernels replaced (mma_bwd_*:
                `chip_smoke.MMA_SYNC_BWD_EDITS`);
  two_stages    a ring of two tiles;
  four_stages   a ring of four tiles;
  one_consumer  one consumer warpgroup a block (64 rows or keys), two
                blocks an SM, 216 registers a consumer thread;
  long_at_257   every shape past 256 rows on the long kernels, so that they
                time against wgmma_wide_bwd_* at N = 257 (the committed
                route there).
For each it prints ptxas's registers and spills of the long backward's
instantiations (mma_bwd_*'s for mma_sync), checks K3, K5 and K10b against
their plain versions at the timed shapes (chip_smoke's GRAD_TOL) and their
bits against the committed build's, and times them: medians of
chip_smoke.FWD_RUNS rounds of CUDA-event readings, the variants in turns
within each round, and the profiler's device time per launch, beside SDPA's
backward (forward and backward less forward) and the bound.
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
    "mma_sync": cs.MMA_SYNC_BWD_EDITS,
    "two_stages": [("constexpr int kLbStages = 3;", "constexpr int kLbStages = 2;")],
    "four_stages": [("constexpr int kLbStages = 3;", "constexpr int kLbStages = 4;")],
    "one_consumer": [("constexpr int kLbConsumers = 2;", "constexpr int kLbConsumers = 1;"),
                     ("constexpr int kLbMinBlocks = 1;", "constexpr int kLbMinBlocks = 2;"),
                     ("constexpr int kLbConsumerRegs = 232;", "constexpr int kLbConsumerRegs = 216;")],
    "long_at_257": [("  if (n > kWideKeys || nk > kWideKeys) return kRouteLong;",
                     "  if (n > kWgKeys || nk > kWgKeys) return kRouteLong;")],
}
# chip_smoke's long shapes at b32 (LONG_SHAPES) and the wide route's N = 257
# at D = 80 and 112, b256 (ViT-H-14's and EVA02-E-14's vision)
SHAPES = {**{f"{label}_b32": shape for label, shape in cs.LONG_SHAPES.items()},
          **{f"d{d}_n257_b256": dict(b=cs.TRAIN_BATCH, n=257, nk=257, h=16, d=d, causal=False)
             for d in (80, 112)}}


def registers(name):
    """ptxas's lines for the variant's long backward instantiations (the
    mma.sync build's mma_bwd_*)."""
    key = "mma_bwd_" if name == "mma_sync" else "long_bwd"
    lines = []
    for src in cs.BWD_SOURCES:
        log = build.build_dir().parent / "variants" / f"fwd_lbwd_{name}" / f"{src}.log"
        entry = ""
        for line in (log.read_text() if log.is_file() else "").splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line) and key in entry:
                lines.append(f"{src}: {entry}: {line.strip()}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default=str(ROOT / "build" / "attn_long_bwd_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_long_bwd_variants: no CUDA device available", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    card = cs.smi_name_power()
    print(f"[variants] {torch.cuda.get_device_name(0)} | {card}", flush=True)
    own = build.load_libraries(cs.FWD_SOURCES + cs.BWD_SOURCES)
    forwards = {src: own[src] for src in cs.FWD_SOURCES}
    with ThreadPoolExecutor(len(names)) as pool:
        built = pool.map(lambda n: cs.build_fwd_variant(f"lbwd_{n}", [], VARIANTS[n], fwd=False),
                         names)
        libs = {name: {**forwards, **lib} for name, lib in zip(names, built)}
    out = {"card": card, "registers": {}, "shapes": {}}
    for name in names:
        out["registers"][name] = registers(name)
        for line in out["registers"][name]:
            print(f"[ptxas] {name}: {line}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(26)
    for label in args.shapes.split(","):
        shape = SHAPES[label]
        fns, res = {}, {}
        for kernel, (call, plain) in cs.long_bwd_calls(shape, gen).items():
            want = plain()
            got = {}
            for name in names:
                fn = cs.on_libraries(call, libs[name])
                got[name] = fn()
                res[f"{kernel}/{name}_errors"] = cs.check_backward(
                    f"{name} {kernel} {label}", got[name], want)
                fns[f"{kernel}/{name}"] = fn
            if "committed" in got:
                for name in names:
                    same = cs.bits_equal(got[name], got["committed"])
                    res[f"{kernel}/{name}_bit_equal_vs_committed"] = same
                    print(f"[bits] {label} {kernel} {name} vs committed: dq, dk, dv bit-equal "
                          f"{same}", flush=True)
            del got, want
        t, reads = cs.median_ms(fns, 10)
        dev = cs.device_ms(fns)
        h, d = shape["h"], shape["d"]
        q, k, v = cs.qkv_slices(shape, torch.bfloat16, gen)
        q4, k4, v4 = (x.unflatten(-1, (h, d)).transpose(1, 2) for x in (q, k, v))
        sdpa_bwd = cs.sdpa_ms(q4, k4, v4, torch.randn_like(q4), shape["causal"])[1]
        args_ = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        bound = cs.attention_bwd_bound(**args_, dtype=torch.bfloat16)
        for key in fns:
            res[key] = {"ms": t[key], "device_ms": dev[key], "readings": reads[key]}
        out["shapes"][label] = {"shape": shape, "bound_ms": bound[0], "bound_by": bound[1],
                                "sdpa_bwd_ms": sdpa_bwd, "results": res}
        for kernel in ("K3", "K5", "K10b"):
            print(f"[time] {label} {kernel}: " + ", ".join(
                f"{name} {t[f'{kernel}/{name}']:.4f} / {cs.fmt_ms(dev[f'{kernel}/{name}'])}"
                for name in names) + f" ms (event median / device); SDPA's backward "
                f"{sdpa_bwd:.4f}; bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"[variants] readings written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
