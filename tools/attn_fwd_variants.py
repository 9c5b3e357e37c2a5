#!/usr/bin/env python3
"""Time the bf16 attention forward on wgmma (`wgmma_fwd_kernel` in
`mrclip_tpu_torch/csrc/attn_mma_fwd.cuh`: K1, K4, K10 and, in its ROPE
form, K2 with one key block of at most 256 keys at D = 64) beside variants
of its design, on one CUDA card, in turns within one process.

    python3 tools/attn_fwd_variants.py [--out build/attn_fwd_variants.json]
                                       [--variants committed,mma_sync_route]

Each variant is the committed sources with text edits to that header, built
by nvcc into `build/variants/fwd_<name>/` and called through its own
`packed_attn_fwd` (K1; K4 and K10 run the same kernel with other strides
or statistics) and `packed_attn_rope_fwd` (K2) C entries. The package's
modules are not touched.
  committed       the sources as they are: two blocks an SM;
  mma_sync_route  the wgmma route disabled: K1 and K2 on the mma.sync
                  kernel (mma_fwd_kernel) that it replaced;
  three_blocks    three blocks an SM (`__launch_bounds__(128, 3)`: at most
                  168 registers a thread, not 255);
  n64_only        S on whole 64-key tiles only: the launcher rounds the
                  16-key groups up to a multiple of four, so N = 197
                  computes 256 keys, not 208;
  q_reg           K2 rotates each warp's Q A fragments in registers after
                  their ldmatrix (rotate_frag_a, 32-bit table loads), not
                  the Q sub-tile in shared memory before its barrier;
  carveout_164    the wgmma kernel asks for a 164 KB shared-memory carveout
                  (72% of 228 KB; two blocks fit up to G = 14, N = 224),
                  so that the rest of the SM's 256 KB, 92 KB of L1, can
                  hold K2's table rows (50 KB at N = 197);
  carveout_max    it asks for the largest (L1 at its least);
and, to find where K2's rotation time goes (its o is then wrong, so K2 is
timed, not checked; K1 is unchanged):
  rope_no_q       K2 leaves Q unrotated;
  rope_no_k       K2 leaves K unrotated.
For each it prints ptxas's registers and spills of the wgmma kernels,
checks K1 and K2 against their plain versions at the timed shapes (O_TOL
and LSE_TOL, as chip_smoke.py), and times K1 at ViT-B-16 vision b32 and
b256, text b256 (N = 98, causal) and EVA02-B-16's text ctx 77 b256, and K2
with K1 beside it on the same q, k, v at EVA02-B-16's vision layer (b32,
b256, with its rope_cat_2d table) and at N = 577 b32 (past the wgmma
route: both routes run mma_fwd_kernel there): medians of 7 rounds of
CUDA-event readings, the variants in turns within each round, and the
profiler's device time per launch. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
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
from mrclip_tpu_torch.ops import fused_attn as fa  # noqa: E402

HEADER = "attn_mma_fwd.cuh"
# K2's rotation of the Q sub-tile in wgmma_fwd_kernel
Q_SMEM = "    if constexpr (ROPE) rotate_rows<D>(sq, tab, row0, min(kMmaRows, n - row0));\n"
# the shared-memory carveout of wgmma_fwd_kernel, in percent of the SM's
# 228 KB, set after its dynamic shared memory is allowed
ALLOW = "  const cudaError_t err = allow_smem(wgmma_fwd_kernel<FLASH, ROPE, G>, smem, done);\n"
CARVEOUT = ("  cudaFuncSetAttribute(wgmma_fwd_kernel<FLASH, ROPE, G>,\n"
            "                       cudaFuncAttributePreferredSharedMemoryCarveout, {});\n")
VARIANTS = {
    "committed": [],
    "mma_sync_route": [("if (nblk == 1 && nk <= kWgKeys)\n      return launch_wgmma_fwd<",
                        "if (false)\n      return launch_wgmma_fwd<")],
    "three_blocks": [("__launch_bounds__(kMmaThreads, 2)\n    wgmma_fwd_kernel(",
                      "__launch_bounds__(kMmaThreads, 3)\n    wgmma_fwd_kernel(")],
    "n64_only": [("causal, (nk + 15) / 16, stream);", "causal, (nk + 63) / 64 * 4, stream);")],
    "q_reg": [(Q_SMEM, ""),
              ("    // S = Q K^T, straight-line:",
               "    if constexpr (ROPE) rotate_frag_a<D>(qf, tab, row0 + 16 * warp, n, lane);\n"
               "    // S = Q K^T, straight-line:")],
    "carveout_164": [(ALLOW, ALLOW + CARVEOUT.format("72"))],
    "carveout_max": [(ALLOW, ALLOW + CARVEOUT.format("100"))],
    "rope_no_q": [(Q_SMEM, "")],
    "rope_no_k": [("if constexpr (ROPE) rotate_swz(", "if constexpr (false) rotate_swz(")],
}
ROPE_ABLATIONS = ("rope_no_q", "rope_no_k")
SHAPES = {"vision_b256": dict(cs.VISION, b=cs.TRAIN_BATCH), "vision_b32": cs.VISION,
          "text_b256": dict(cs.TEXT, b=cs.TRAIN_BATCH),
          "text77_b256": dict(cs.TEXT77, b=cs.TRAIN_BATCH)}
# K2 (and K1 beside it): EVA02-B-16's vision layer, and N = 577 (24 x 24
# grid and a CLS row) past the wgmma route
ROPE_SHAPES = {"eva02_vision_b256": dict(cs.ROPE_VISION, b=cs.TRAIN_BATCH),
               "eva02_vision_b32": cs.ROPE_VISION,
               "eva02_n577_b32": dict(cs.ROPE_VISION, n=577, nk=577)}


def build_variant(name, edits):
    """The variant's `packed_attn_fwd` and `packed_attn_rope_fwd` C
    functions and ptxas's lines for its wgmma kernels."""
    src = ROOT / "build" / "variants" / f"fwd_{name}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    header = src / HEADER
    text = header.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {HEADER} once")
        text = text.replace(old, new)
    header.write_text(text)
    out = src / "libpacked_attn_fwd.so"
    proc = subprocess.run(build.nvcc_command(src / "packed_attn_fwd.cu", out, build._find_nvcc()),
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{log}")
    lines, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and "wgmma_fwd" in entry:
            lines.append(f"{entry}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    k1, k2 = lib.packed_attn_fwd, lib.packed_attn_rope_fwd
    k1.argtypes = fa.load_kernel().argtypes
    k2.argtypes = fa.load_rope_kernel().argtypes
    k1.restype = k2.restype = ctypes.c_int
    return (k1, k2), lines


def fwd_call(fn, shape, q, k, v, tab=None):
    """A zero-argument call of the variant's K1 (K2 with the rope table
    `tab`) on the packed column slices q, k, v, allocating o and lse as the
    package's wrapper does."""
    b, n, hd = q.shape
    h, d = shape["h"], shape["d"]
    sizes = (b, n, k.shape[1], h, d) if tab is None else (b, n, h, d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *(() if tab is None else (tab.data_ptr(),)))

    def call():
        o = torch.empty((b, n, hd), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        err = fn(*ptrs, o.data_ptr(), lse.data_ptr(), 1, *sizes, q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1), 1.0 / math.sqrt(d),
                 int(shape["causal"]), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"packed_attn_{'rope_' if tab is not None else ''}fwd launch "
                               f"failed: cudaError {err}")
        return o, lse

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/attn_fwd_variants.json")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names to build and time (default: all)")
    args = ap.parse_args()
    variants = {name: VARIANTS[name] for name in args.variants.split(",")}
    if not torch.cuda.is_available():
        print("attn_fwd_variants: no CUDA device available", file=sys.stderr)
        return 1
    name, smi = cs.phase_card()
    with ThreadPoolExecutor(len(variants)) as pool:  # the variants build together
        done = dict(zip(variants, pool.map(build_variant, variants, variants.values())))
    for var, (_, lines) in done.items():
        for line in lines:
            cs.log(f"[ptxas] {var}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(12)
    result = {"card": smi, "kind": name, "shapes": {}}

    def run(tag, shape, fns, refs, bound, by):
        """Check each of `fns` (name -> call) against its plain output in
        `refs` (name -> (o, lse), None: not checked), then time them in
        turns."""
        errs = {}
        for var, call in fns.items():
            o, lse = call()
            torch.cuda.synchronize()
            if refs[var] is None:
                cs.log(f"[check] {var} at {tag}: not checked (rope steps taken out)")
                continue
            o_ref, lse_ref = refs[var]
            errs[var] = (cs.abs_err(o, o_ref), (lse - lse_ref).abs().max().item())
            if not (errs[var][0] <= cs.O_TOL[torch.bfloat16] and errs[var][1] <= cs.LSE_TOL):
                raise AssertionError(f"{var} at {tag}: max |o - plain|, |lse - plain| = "
                                     f"{errs[var]}")
        ms, readings = cs.median_ms(fns, 50)
        dev = cs.device_ms(fns)
        cs.log(f"[time] {tag}: " + ", ".join(
            f"{var} {ms[var]:.4f} / {cs.fmt_ms(dev[var])} ms" for var in fns)
            + f" (event median of {cs.FWD_RUNS} / profiler device time; readings "
              f"{cs.spread(readings)}); bound {bound * 1e3:.2f} us ({by}); on {smi}")
        result["shapes"][tag] = {"event_ms": ms, "device_ms": dev, "readings": readings,
                                 "max_abs_err": errs, "bound_ms": bound}

    for tag, shape in SHAPES.items():
        q, k, v = cs.qkv_slices(shape, torch.bfloat16, gen)
        ref = fa.fused_attention_packed_ref(q, k, v, is_causal=shape["causal"], heads=shape["h"])
        fns = {f"{var} K1": fwd_call(fn[0], shape, q, k, v) for var, (fn, _) in done.items()}
        run(tag, shape, fns, dict.fromkeys(fns, ref),
            *cs.attention_bound(**shape, dtype=torch.bfloat16))
    for tag, shape in ROPE_SHAPES.items():
        q, k, v, _, tab = cs.rope_inputs(shape, torch.bfloat16, gen)
        h = shape["h"]
        refs = {"K2": fa.fused_attention_packed_ref(q, k, v, heads=h, rope=tab),
                "K1": fa.fused_attention_packed_ref(q, k, v, heads=h)}
        fns, want = {}, {}
        for var, (fn, _) in done.items():
            for kern, f, t in (("K2", fn[1], tab), ("K1", fn[0], None)):
                fns[f"{var} {kern}"] = fwd_call(f, shape, q, k, v, t)
                want[f"{var} {kern}"] = (None if kern == "K2" and var in ROPE_ABLATIONS
                                         else refs[kern])
        dims = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        run(tag, shape, fns, want, *cs.rope_attention_bound(**dims, dtype=torch.bfloat16))
    result["ptxas"] = {var: lines for var, (_, lines) in done.items()}
    out = Path(args.out)
    if out.suffix != ".json":
        out = out / "attn_fwd_variants.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    cs.log(f"[variants] readings in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
