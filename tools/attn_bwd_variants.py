#!/usr/bin/env python3
"""Time the bf16 attention backward of the PyTorch/CUDA port (K3, K3r, K5
and K10b, `mrclip_tpu_torch/csrc/attn_mma_bwd.cuh`) beside variants of its
design, on one CUDA card, in turns within one process.

    python3 tools/attn_bwd_variants.py [--out build/attn_bwd_variants.json]
                                       [--variants committed,mma_sync_route]

Each variant is the committed sources with text edits to that header, built
by nvcc into `build/variants/<name>/` and bound in place of the package's
own libraries:
  committed      the sources as they are: K3, K3r, K5 and K10b at D = 64
                 with n and nk <= 256 on wgmma (wgmma_bwd_dq_kernel,
                 wgmma_bwd_dkv_kernel);
  mma_sync_route the wgmma route disabled: K3, K3r, K5 and K10b on the
                 mma.sync kernels (mma_bwd_dq_kernel, mma_bwd_dkv_kernel)
                 that it replaced;
  no_causal_skip the wgmma passes compute every step of a causal sub-tile,
                 the steps wholly masked too (as the wgmma forward does);
  one_subtile    a wgmma block takes one 64-row (dq) or 64-key (dk/dv)
                 sub-tile and stages K and V (Q and dO) for it alone;
and, to find where K3r's rotation time goes (its results are then wrong,
so K3r is timed, not checked; K3, K5 and K10b are unchanged), on both
routes:
  rope_no_reg  K3r leaves the register operand (Q in the dq pass, K in the
               dk/dv pass) unrotated;
  rope_no_smem K3r leaves the staged operand (K, Q) unrotated;
  rope_no_unrot K3r stores dq and dk without their un-rotation;
  rope_none    all three: the ROPE instantiation doing K3's work;
and, for K10b's FLASH form on wgmma:
  dq_fold      the dq pass takes dS = (e (dP - di)) (1 / l scale), e =
               2^(S sl2 - m), one multiply a score fewer than P = e (1 / l)
               first (fp32 association only: checked);
  flash_no_inv K10b leaves P unscaled by 1 / l (K5's arithmetic on K10b's
               statistics; K10b then wrong, so timed, not checked).
For each it prints ptxas's registers and spills, checks K3, K5, K10b and K3r
against their plain versions at the timed shapes (GRAD_TOL, as
chip_smoke.py), and times K3, K5 and K10b at ViT-B-16 vision b256, text
b256 (N = 98, causal) and EVA02-B-16's text ctx 77 b256, and K3r (with K3
beside it) at EVA02-B-16's vision b256 with its rope_cat_2d table: medians
of 7 rounds of CUDA-event readings, the variants in turns within each
round, and the profiler's device time per call (medians of 7 windows).
Needs one CUDA card; imports no JAX.
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
# K3r's rope steps, each taken out by edits (with a count of occurrences),
# in the mma.sync kernels and in the wgmma kernels
NO_REG = [("if constexpr (ROPE) rotate_frag_a<D>(", "if constexpr (false) rotate_frag_a<D>(", 4)]
NO_SMEM = [("rotate_rows<D>(sk_a", "if (false) rotate_rows<D>(sk_a", 2),
           ("rotate_rows<D>(sq_a", "if (false) rotate_rows<D>(sq_a", 2),
           ("rotate_swz(s", "if (false) rotate_swz(s", 2)]
NO_UNROT = ("if constexpr (ROPE) unrotate_frag_c<D>(", "if constexpr (false) unrotate_frag_c<D>(",
            4)
ROPE_ABLATIONS = ("rope_no_reg", "rope_no_smem", "rope_no_unrot", "rope_none")
VARIANTS = {
    "committed": [],
    "mma_sync_route": [("if (d == kWgDim && n <= kWgKeys && nk <= kWgKeys) return kRouteWgmma;",
                        "if (d == kWgDim && n <= kWgKeys && nk <= kWgKeys) return kRouteMmaSync;")],
    "no_causal_skip": [
        ("const int steps = CAUSAL ? min(full, row0 / kMmaRows + 1) : full;",
         "const int steps = full;"),
        ("if (!CAUSAL || 64 * full < row0 + kMmaRows)", "if (true)"),
        ("for (int tt = CAUSAL ? kr0 / kMmaRows : 0; tt < full; ++tt)",
         "for (int tt = 0; tt < full; ++tt)")],
    "one_subtile": [
        ("wgmma_bwd_dq_kernel<FLASH, ROPE, kCausal, kTail><<<dim3(batch, 1, heads)",
         "wgmma_bwd_dq_kernel<FLASH, ROPE, kCausal, kTail><<<dim3(batch, tiles_q, heads)"),
        ("(groups_k - 1) / 4, tiles_q);", "(groups_k - 1) / 4, 1);"),
        ("wgmma_bwd_dkv_kernel<FLASH, ROPE, kCausal, kTail><<<dim3(batch, 1, heads)",
         "wgmma_bwd_dkv_kernel<FLASH, ROPE, kCausal, kTail><<<dim3(batch, tiles_k, heads)"),
        ("(groups_q - 1) / 4, tiles_k);", "(groups_q - 1) / 4, 1);")],
    "rope_no_reg": NO_REG,
    "rope_no_smem": NO_SMEM,
    "rope_no_unrot": [NO_UNROT],
    "rope_none": [*NO_REG, *NO_SMEM, NO_UNROT],
    "dq_fold": [("      if constexpr (FLASH) x[e] *= inv[e >> 1];\n", ""),
                ("  dq_ds<NG>(s, dp, dl, scale);\n",
                 "#pragma unroll\n  for (int j = 0; j < 8 * NG; ++j)\n"
                 "    s[j] = s[j] * (dp[j] - dl[(j >> 1) & 1]) *\n"
                 "      (FLASH ? inv[(j >> 1) & 1] * scale : scale);\n")],
    "flash_no_inv": [("      if constexpr (FLASH) x[e] *= inv[e >> 1];",
                      "      if constexpr (false) x[e] *= inv[e >> 1];"),
                     ("    if constexpr (FLASH) {\n      const float2 il =",
                      "    if constexpr (false) {\n      const float2 il =")],
}
SHAPES = {"vision_b256": dict(cs.VISION, b=cs.TRAIN_BATCH),
          "text_b256": dict(cs.TEXT, b=cs.TRAIN_BATCH),
          "text77_b256": dict(cs.TEXT77, b=cs.TRAIN_BATCH)}
ROPE_SHAPE = dict(cs.ROPE_VISION, b=cs.TRAIN_BATCH)  # EVA02-B-16's vision layer


def build_variant(name, edits):
    """The grouped, flash and packed-backward libraries of one variant,
    (K5 bwd fn, K10b bwd fn, K3 fn, K3r fn), and ptxas's lines for the
    backward kernels (and, for the committed sources, the forward's)."""
    src = ROOT / "build" / "variants" / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC, src)
    header = src / HEADER
    text = header.read_text()
    for old, new, *count in edits:
        if text.count(old) != (count[0] if count else 1):
            raise RuntimeError(f"variant {name}: {old!r} is not in {HEADER} "
                               f"{count[0] if count else 1} times")
        text = text.replace(old, new)
    header.write_text(text)
    lines = []
    for lib in cs.BWD_SOURCES:
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
    return bind_variant(src), lines


def bind_variant(src):
    """(K5 bwd fn, K10b bwd fn, K3 fn, K3r fn) of the grouped, flash and
    packed-backward libraries built by `build_variant` in `src`."""
    libs = {lib: ctypes.CDLL(str(Path(src) / f"lib{lib}.so"))
            for lib in cs.BWD_SOURCES}
    k5 = libs["grouped_attn_bwd"].grouped_attn_bwd
    k5.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    k10b = libs["flash_attn_bwd"].flash_attn_bwd
    k10b.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    k3 = libs["packed_attn_bwd"].packed_attn_bwd
    k3.argtypes = fa.load_bwd_kernel().argtypes
    k3r = libs["packed_attn_bwd"].packed_attn_rope_bwd
    k3r.argtypes = fa.load_rope_bwd_kernel().argtypes
    k5.restype = k10b.restype = k3.restype = k3r.restype = ctypes.c_int
    return k5, k10b, k3, k3r


def inputs(shape, gen):
    """K5's grouped (q, k, v, o, do, lse), K10b's (q, k, v, do, l, m, di)
    and K3's packed (q, k, v, o, do, lse) from one set of column slices."""
    h, d, causal = shape["h"], shape["d"], shape["causal"]
    sl = cs.qkv_slices(shape, torch.bfloat16, gen)
    qg, kg, vg = (fa.group_heads(t.unflatten(-1, (h, d))) for t in sl)
    og, lse = fa.fused_attention_grouped(qg, kg, vg, is_causal=causal)
    dog = torch.randn(og.shape, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (h, d)) for t in sl)
    o, l, m = fl.flash_attention(q, k, v, is_causal=causal)
    do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
    op, lse_p = fa.fused_attention_packed(*sl, is_causal=causal, heads=h)
    dop = torch.randn(op.shape, device="cuda", generator=gen).to(torch.bfloat16)
    return ((qg, kg, vg, og, dog, lse), (q, k, v, do, l, m, fl.flash_di(o, do)),
            (*sl, op, dop, lse_p))


def bound_call(wrapper, loader, fn, *args, **kw):
    """A zero-argument call of `wrapper` with the package's `loader` (a
    name in `fa` or `fl`) bound to the variant's library function `fn`."""
    module, name = loader

    def call():
        setattr(module, name, lambda: fn)
        return wrapper(*args, **kw)

    return call


def calls(fns, k5_args, k10b_args, k3_args, causal, h):
    """Zero-argument K5, K10b and K3 backward calls through the wrappers,
    bound to the variant's library functions `fns`."""
    def k5():
        fa.load_grouped_kernels = lambda: (LOADERS[0]()[0], fns[0])
        return fa.fused_attention_grouped_bwd(*k5_args, is_causal=causal)

    def k10b():
        fl.load_kernels = lambda: (LOADERS[1]()[0], fns[1])
        return fl.flash_attention_bwd(*k10b_args, is_causal=causal)

    k3 = bound_call(fa.fused_attention_packed_bwd, (fa, "load_bwd_kernel"), fns[2], *k3_args,
                    is_causal=causal, heads=h)
    return k5, k10b, k3


def check(tag, got, want):
    scale = max(w.float().abs().max().item() for w in want)
    err = max(cs.rel_err(g, w, scale) for g, w in zip(got, want))
    if not err <= cs.GRAD_TOL[torch.bfloat16]:
        raise AssertionError(f"{tag}: max |d - plain| / max |plain| = {err:.3e}")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/attn_bwd_variants.json")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names to build and time (default: all)")
    args = ap.parse_args()
    variants = {name: VARIANTS[name] for name in args.variants.split(",")}
    if not torch.cuda.is_available():
        print("attn_bwd_variants: no CUDA device available", file=sys.stderr)
        return 1
    name, smi = cs.phase_card()
    fa.load_bwd_kernel()  # the package's own K3 library, whose argtypes the variants take
    with ThreadPoolExecutor(len(variants)) as pool:  # the variants build together
        done = dict(zip(variants, pool.map(build_variant, variants, variants.values())))
    built = {}
    for var, (fns, lines) in done.items():
        built[var] = fns
        for line in lines:
            cs.log(f"[ptxas] {var}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(8)
    result = {"card": smi, "device": name, "runs": cs.FWD_RUNS, "shapes": {}}

    def timed(sname, shape, fns):
        med, reads = cs.median_ms(fns, 20)
        dev = cs.device_ms(fns)
        result["shapes"][sname] = {"shape": shape, "median_ms": med, "readings": reads,
                                   "device_ms": dev}
        for key in fns:
            cs.log(f"[time] {sname} {key}: {med[key]:.4f} ms (readings "
                   f"{min(reads[key]):.4f}-{max(reads[key]):.4f}, median of {cs.FWD_RUNS}); "
                   f"device {cs.fmt_ms(dev[key])} ms")

    for sname, shape in SHAPES.items():
        k5_args, k10b_args, k3_args = inputs(shape, gen)
        causal, h = shape["causal"], shape["h"]
        want5 = fa.fused_attention_bwd_ref(*k5_args, is_causal=causal)
        want10 = fl.flash_attention_bwd_ref(*k10b_args, is_causal=causal)
        want3 = fa.fused_attention_packed_bwd_ref(*k3_args, is_causal=causal, heads=h)
        fns = {}
        for var, lib in built.items():
            k5, k10b, k3 = calls(lib, k5_args, k10b_args, k3_args, causal, h)
            got10 = k10b()
            errs = (check(f"{var} K5 {sname}", k5(), want5),
                    float("nan") if var == "flash_no_inv"  # wrong by design: timed, not checked
                    else check(f"{var} K10b {sname}", got10, want10),
                    check(f"{var} K3 {sname}", k3(), want3))
            cs.log(f"[check] {var} {sname}: K5 {errs[0]:.3e}, K10b {errs[1]:.3e}, K3 "
                   f"{errs[2]:.3e} (tol {cs.GRAD_TOL[torch.bfloat16]})")
            fns[f"{var} K5"], fns[f"{var} K10b"], fns[f"{var} K3"] = k5, k10b, k3
        timed(sname, shape, fns)

    # K3r at EVA02-B-16's vision layer, K3 beside it on the same q, k, v
    q, k, v, _, tab = cs.rope_inputs(ROPE_SHAPE, torch.bfloat16, gen)
    h = ROPE_SHAPE["h"]
    o, lse = fa.fused_attention_packed(q, k, v, heads=h, rope=tab)
    o1, lse1 = fa.fused_attention_packed(q, k, v, heads=h)
    do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
    want = fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, heads=h, rope=tab)
    fns = {}
    for var, lib in built.items():
        k3r = bound_call(fa.fused_attention_packed_bwd, (fa, "load_rope_bwd_kernel"), lib[3],
                         q, k, v, o, do, lse, heads=h, rope=tab)
        got = k3r()
        if var in ROPE_ABLATIONS:  # wrong by design: timed, not checked
            cs.log(f"[check] {var} K3r: not checked (rope steps taken out)")
        else:
            cs.log(f"[check] {var} K3r: {check(f'{var} K3r', got, want):.3e}")
        fns[f"{var} K3r"] = k3r
        fns[f"{var} K3"] = bound_call(fa.fused_attention_packed_bwd, (fa, "load_bwd_kernel"),
                                      lib[2], q, k, v, o1, do, lse1, heads=h)
    timed("eva02_vision_b256", ROPE_SHAPE, fns)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
