#!/usr/bin/env python3
"""Time the depthwise convolution kernels of the PyTorch/CUDA port (K8
`dw_conv_fwd` and K9 `dw_conv_bwd`, `mrclip_tpu_torch/csrc/dw_conv.cu`)
beside variants of their design, on one CUDA card, in turns within one
process.

    python3 tools/dw_conv_variants.py [--out build/dw_conv_variants.json]

Source variants are the committed `dw_conv.cu` with text edits, built by
nvcc into `build/variants/dw_<name>/` and bound in place of the package's
library:
  committed     the source as it is;
  rows_unrolled the tap-row loop unrolled (every row's window live at once);
  strip16       a thread's strip 16 outputs along W, not 8;
  bwd_lb3       K9's pass at three blocks per SM (80 registers), on 8 x 16
                tiles (its shared memory then lets three share an SM).
Plan variants run the committed library under other work splits, through
`ops/dw_conv.py::plan`'s overrides: tiles of 8 x 16 and 8 x 32 output
pixels for both kernels, and K9 with 1024 and 2048 dw blocks (committed:
512).
For each it prints ptxas's registers and spills, checks K8's y and K9's dx
bit-equal to the plain versions and K9's dw within 1e-3 (chip_smoke.py's
bars) at one shape per stage, and times K8 and K9 in bf16 at MobileCLIP-S1's
stage shapes at b256: medians of 7 rounds of CUDA-event readings, the
variants in turns within each round, and their sums over the 73
convolutions of one forward. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mrclip_tpu_torch.ops import build  # noqa: E402
from mrclip_tpu_torch.ops import dw_conv as dc  # noqa: E402

SOURCE = "dw_conv.cu"
UNROLL = ("#pragma unroll 1  // one row's window", "#pragma unroll  // one row's window")
BWD_LB3 = ("__global__ void __launch_bounds__(kThreads, 2)\ndw_bwd_kernel(",
           "__global__ void __launch_bounds__(kThreads, 3)\ndw_bwd_kernel(")
STRIP16 = ("constexpr int kStrip = 8; ", "constexpr int kStrip = 16; ")
# name -> (source edits, plan changes: strip, fixed tile (th, tw) of either
# kernel, K9's dw blocks)
VARIANTS = {
    "committed": ([], {}),
    "rows_unrolled": ([UNROLL], {}),
    "strip16": ([STRIP16], {"strip": 16}),
    "bwd_lb3": ([BWD_LB3], {"tile": (8, 16), "only": "bwd"}),
    "tile_8x16": (None, {"tile": (8, 16)}),
    "tile_8x32": (None, {"tile": (8, 32)}),
    "dw_blocks_1024": (None, {"blocks": 1024}),
    "dw_blocks_2048": (None, {"blocks": 2048}),
}


def build_variant(name, edits):
    """The variant's (dw_conv_fwd, dw_conv_bwd), bound as the package binds
    them, and ptxas's lines."""
    if edits is None:
        return None, []
    dst = ROOT / "build" / "variants" / f"dw_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    text = (dst / SOURCE).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE} once")
        text = text.replace(old, new)
    (dst / SOURCE).write_text(text)
    out = dst / "libdw_conv.so"
    proc = subprocess.run(build.nvcc_command(dst / SOURCE, out, build._find_nvcc()),
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{log}")
    lines, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and "bfloat16" in entry:
            lines.append(f"{entry}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    fns = {}
    for fn_name, fn in dc.load_kernels().items():
        fns[fn_name] = getattr(lib, fn_name)
        fns[fn_name].argtypes, fns[fn_name].restype = fn.argtypes, fn.restype
    return fns, lines


def variant_plan(change, x, k, *tensors, backward=False):
    """The plan of one call under a variant's plan changes, through `plan`'s
    own overrides: a starting tile for either kernel (or only one), a strip
    that the tile's width must hold, K9's dw blocks."""
    p = dc._plan_for(x, k, *tensors, backward=backward)
    kind = "bwd" if backward else "fwd"
    th, tw = change["tile"] if "tile" in change and change.get("only", kind) == kind else (
        p.th, p.tw)
    return dc._plan_for(x, k, *tensors, backward=backward,
                        tile=(th, max(tw, change.get("strip", dc.STRIP))),
                        dw_blocks=change.get("blocks", dc._DW_BLOCKS))


def calls(fns, change, x, w2, dy):
    """Zero-argument K8 and K9 calls through the variant's library (the
    package's where `fns` is None) under its plan, as the wrappers make
    them (dy already in x's type)."""
    fns = fns or dc.load_kernels()
    k = dc._kernel_args("dw_conv_bwd", x, w2, dy)

    def fwd():
        y = torch.empty_like(x)
        dc._run_fwd(x, w2, y, k, variant_plan(change, x, k, y), fns["dw_conv_fwd"])
        return y

    def bwd():
        dx = torch.empty_like(x)
        dw = torch.empty(k * k, x.shape[3], dtype=torch.float32, device=x.device)
        dc._run_bwd(x, w2, dy, dx, dw, k, variant_plan(change, x, k, dy, dx, backward=True),
                    fns["dw_conv_bwd"])
        return dx, dw

    return fwd, bwd


def inputs(b, h, w, c, k, gen):
    x = torch.randn(b, h, w, c, device="cuda", generator=gen).to(torch.bfloat16)
    w2 = torch.randn(k * k, c, device="cuda", generator=gen) * 0.2
    dy = torch.randn(b, h, w, c, device="cuda", generator=gen).to(torch.bfloat16)
    return x, w2, dy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/dw_conv_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dw_conv_variants: no CUDA device available", file=sys.stderr)
        return 1
    name, smi = cs.phase_card()
    dc.load_kernels()  # the package's library, whose argtypes the variants take
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # the variants build together
        done = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS,
                                           (v[0] for v in VARIANTS.values()))))
    for var, (_, lines) in done.items():
        for line in lines:
            cs.log(f"[ptxas] {var}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    result = {"card": smi, "device": name, "runs": cs.FWD_RUNS, "shapes": {}, "per_forward": {}}
    for var, (fns, _) in done.items():  # one shape per stage, the card tests' bars
        for shape in [(2, 64, 64, 64, 7), (2, 32, 32, 128, 3), (2, 16, 16, 256, 7),
                      (2, 8, 8, 512, 7), (2, 9, 33, 33, 7)]:
            x, w2, dy = inputs(*shape, gen)
            fwd, bwd = calls(fns, VARIANTS[var][1], x, w2, dy)
            y, (dx, dw) = fwd(), bwd()
            want_dx, want_dw = dc.dw_conv_bwd_ref(x, w2, dy)
            err = cs.rel_err(dw, want_dw)
            if not (torch.equal(y, dc.dw_conv_fwd_ref(x, w2)) and torch.equal(dx, want_dx)
                    and err <= cs.DW_GRAD_TOL):
                raise AssertionError(f"variant {var} disagrees with the plain versions at {shape}")
        cs.log(f"[check] {var}: y, dx bit-equal, dw within {cs.DW_GRAD_TOL} at one shape per stage")
    sums = {}
    for (h, w, c, k), count in cs.DW_STAGES:
        shape = (cs.TRAIN_BATCH, h, w, c, k)
        x, w2, dy = inputs(*shape, gen)
        fns = {}
        for var, (lib, _) in done.items():
            fns[f"{var} K8"], fns[f"{var} K9"] = calls(lib, VARIANTS[var][1], x, w2, dy)
        med, reads = cs.median_ms(fns, 10)
        key = f"b{shape[0]} {(h, w, c)} K={k}"
        result["shapes"][key] = {"median_ms": med, "readings": reads}
        for fn_name in fns:
            sums[fn_name] = sums.get(fn_name, 0.0) + count * med[fn_name]
            cs.log(f"[time] {key} {fn_name}: {med[fn_name]:.4f} ms (readings "
                   f"{min(reads[fn_name]):.4f}-{max(reads[fn_name]):.4f})")
        del x, w2, dy
    result["per_forward"] = sums
    for fn_name, ms in sums.items():
        cs.log(f"[time] the 73 convolutions of one forward at b{cs.TRAIN_BATCH}, {fn_name}: "
               f"{ms:.4f} ms")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
