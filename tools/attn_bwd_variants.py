#!/usr/bin/env python3
"""Time the bf16 attention backward of the PyTorch/CUDA port (K5 and K10b,
`mrclip_tpu_torch/csrc/attn_mma_bwd.cuh`) beside variants of its design, on
one CUDA card, in turns within one process.

    python3 tools/attn_bwd_variants.py [--out build/attn_bwd_variants.json]

Each variant is the committed sources with one text edit, built by nvcc into
`build/variants/<name>/` and bound in place of the package's own library:
  committed    the sources as they are;
  one_subtile  a resident block takes one 64-row (dq) or 64-key (dkv)
               sub-tile and stages K, V (Q, dO) for it alone: the staged
               operands are read from device memory once per sub-tile, not
               once per (sample, head);
  dq_k64       the dq pass steps 64 keys at a time, not 32;
  dkv_q32      the dkv pass steps 32 queries at a time, not 16;
  dkv_lb2      the dkv pass's resident kernel at two blocks per SM (255
               registers), not three (168).
For each it prints ptxas's registers and spills, checks K5 and K10b against
their plain versions at the timed shapes (GRAD_TOL, as chip_smoke.py), and
times them at ViT-B-16 vision b256, text b256 (N = 98, causal) and
EVA02-B-16's text ctx 77 b256: medians of 7 rounds of CUDA-event readings,
the variants in turns within each round. Needs one CUDA card; imports no JAX.
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
from mrclip_tpu_torch.ops import flash_attn as fl  # noqa: E402
from mrclip_tpu_torch.ops import fused_attn as fa  # noqa: E402

HEADER = "attn_mma_bwd.cuh"
# the package's own loaders: each variant's backward is bound beside the
# committed forward
LOADERS = (fa.load_grouped_kernels, fl.load_kernels)
VARIANTS = {
    "committed": [],
    "one_subtile": [("constexpr int kMost = kMaxRows / kMmaRows;", "constexpr int kMost = 1;")],
    "dq_k64": [("constexpr int kDqKeys = 32;", "constexpr int kDqKeys = 64;")],
    "dkv_q32": [("constexpr int kDkvQueries = 16;", "constexpr int kDkvQueries = 32;")],
    "dkv_lb2": [("__launch_bounds__(kMmaThreads, CHUNKED ? 2 : 3)\n    mma_bwd_dkv_kernel(",
                 "__launch_bounds__(kMmaThreads, 2)\n    mma_bwd_dkv_kernel(")],
}
SHAPES = {"vision_b256": dict(cs.VISION, b=cs.TRAIN_BATCH),
          "text_b256": dict(cs.TEXT, b=cs.TRAIN_BATCH),
          "text77_b256": dict(cs.TEXT77, b=cs.TRAIN_BATCH)}


def build_variant(name, edits):
    """The grouped and flash libraries of one variant, (K5 bwd fn, K10b bwd
    fn), and ptxas's lines for the backward kernels (and, for the committed
    sources, the forward's)."""
    src = ROOT / "build" / "variants" / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    header = src / HEADER
    text = header.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {HEADER} once")
        text = text.replace(old, new)
    header.write_text(text)
    libs, lines = {}, []
    for lib in ("grouped_attn", "flash_attn"):
        out = src / f"lib{lib}.so"
        proc = subprocess.run(build.nvcc_command(src / f"{lib}.cu", out, build._find_nvcc()),
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed on {lib}.cu:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line) and (
                    "mma_bwd" in entry or (name == "committed" and "mma_fwd" in entry)):
                lines.append(f"{lib} {entry}: {line.strip()}")
        libs[lib] = ctypes.CDLL(str(out))
    k5 = libs["grouped_attn"].grouped_attn_bwd
    k5.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    k10b = libs["flash_attn"].flash_attn_bwd
    k10b.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    k5.restype = k10b.restype = ctypes.c_int
    return (k5, k10b), lines


def inputs(shape, gen):
    """K5's grouped (q, k, v, o, do, lse) and K10b's (q, k, v, do, l, m, di)
    from one set of column slices."""
    h, d, causal = shape["h"], shape["d"], shape["causal"]
    sl = cs.qkv_slices(shape, torch.bfloat16, gen)
    qg, kg, vg = (fa.group_heads(t.unflatten(-1, (h, d))) for t in sl)
    og, lse = fa.fused_attention_grouped(qg, kg, vg, is_causal=causal)
    dog = torch.randn(og.shape, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (h, d)) for t in sl)
    o, l, m = fl.flash_attention(q, k, v, is_causal=causal)
    do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
    return (qg, kg, vg, og, dog, lse), (q, k, v, do, l, m, fl.flash_di(o, do))


def calls(fns, k5_args, k10b_args, causal):
    """Zero-argument K5 and K10b backward calls through the wrappers, bound
    to the variant's library functions `fns`."""
    def k5():
        fa.load_grouped_kernels = lambda: (LOADERS[0]()[0], fns[0])
        return fa.fused_attention_grouped_bwd(*k5_args, is_causal=causal)

    def k10b():
        fl.load_kernels = lambda: (LOADERS[1]()[0], fns[1])
        return fl.flash_attention_bwd(*k10b_args, is_causal=causal)

    return k5, k10b


def check(tag, got, want):
    scale = max(w.float().abs().max().item() for w in want)
    err = max(cs.rel_err(g, w, scale) for g, w in zip(got, want))
    if not err <= cs.GRAD_TOL[torch.bfloat16]:
        raise AssertionError(f"{tag}: max |d - plain| / max |plain| = {err:.3e}")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/attn_bwd_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_bwd_variants: no CUDA device available", file=sys.stderr)
        return 1
    name, smi = cs.phase_card()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # the variants build together
        done = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS, VARIANTS.values())))
    built = {}
    for var, (fns, lines) in done.items():
        built[var] = fns
        for line in lines:
            cs.log(f"[ptxas] {var}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(8)
    result = {"card": smi, "device": name, "runs": cs.FWD_RUNS, "shapes": {}}
    for sname, shape in SHAPES.items():
        k5_args, k10b_args = inputs(shape, gen)
        causal = shape["causal"]
        want5 = fa.fused_attention_bwd_ref(*k5_args, is_causal=causal)
        want10 = fl.flash_attention_bwd_ref(*k10b_args, is_causal=causal)
        fns = {}
        for var, lib in built.items():
            k5, k10b = calls(lib, k5_args, k10b_args, causal)
            errs = (check(f"{var} K5 {sname}", k5(), want5),
                    check(f"{var} K10b {sname}", k10b(), want10))
            cs.log(f"[check] {var} {sname}: K5 {errs[0]:.3e}, K10b {errs[1]:.3e} (tol "
                   f"{cs.GRAD_TOL[torch.bfloat16]})")
            fns[f"{var} K5"], fns[f"{var} K10b"] = k5, k10b
        med, reads = cs.median_ms(fns, 20)
        result["shapes"][sname] = {"shape": shape, "median_ms": med, "readings": reads}
        for key in fns:
            cs.log(f"[time] {sname} {key}: {med[key]:.4f} ms (readings "
                   f"{min(reads[key]):.4f}-{max(reads[key]):.4f}, median of {cs.FWD_RUNS})")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
