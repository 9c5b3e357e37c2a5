#!/usr/bin/env python3
"""Time the fused SupCon loss kernels of the PyTorch/CUDA port (K6
`supcon_stats`, K7 `supcon_grad_q` and `supcon_grad_k`,
`mrclip_tpu_torch/csrc/supcon_loss.cu`) beside variants of their design,
on one CUDA card, in turns within one process.

    python3 tools/supcon_variants.py [--variants a,b] [--out build/supcon_variants.json]

Source variants are the committed `supcon_loss.cu` with text edits, built
by nvcc into `build/variants/supcon_<name>/` and bound in place of the
package's library:
  committed      the source as it is;
  stages3        a ring of three staged slices of D in the tile product, not
                 two (the gradients' own rows streamed: resident ones leave no
                 room, so their instantiations are taken out);
  kc64           slices of 64 columns of D, not 32 (the same);
  outer          the tile product's four depths of a step as four outer
                 products (all of b's fragments loaded first), not four
                 chained FMAs a logit (the same sums in the same order);
  logit_only     the gradient product's FMAs and copies taken out (wrong by
                 design: the logit tiles and coeff alone; K6 as committed);
  grad_only      the logit tiles' FMAs and copies taken out (wrong by design:
                 coeff and the gradient product alone; K6 without copies).
Plan variants run the committed library under other cuts, through
`ops/pallas_loss.py::plan`'s overrides: the gradients on 32-row tiles, each kernel unsplit, and the gradients with
their own rows streamed slice by slice beside the walk rows, not resident.
For each it prints ptxas's registers and spills, checks the variants that
are right by design against the plain versions (max |err| / max |plain| <=
1e-5, chip_smoke.py's bar) at B = 256 and 8192, and times the three kernels
at B = 256 and 8192, D = 512: the profiler's device time per call, medians
of 5 windows, the variants in turns within each window.

    python3 tools/supcon_variants.py --parent build/parent

times another checkout of the repository (e.g. `git archive <commit>`
unpacked into a git-ignored directory) beside this one, each in its own
process, in turns (parent, this, this, parent): the three kernels and the
two-direction pallas loss's forward+backward
(`pallas_multipositive_clip_loss`) at B = 256 and 8192, D = 512, by event
median and the profiler's device time.

    python3 tools/supcon_variants.py --shared-loads

measures what one warp's 16-byte shared load costs the SM by the address
pattern of its lanes (16 warps an SM, a stream of independent loads): the
cost that bounds the kernels' register-blocked tile products.
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
from mrclip_tpu_torch.ops import pallas_loss as pl  # noqa: E402

SOURCE = "supcon_loss.cu"
KC64 = ("constexpr int kKC = 32; ", "constexpr int kKC = 64; ")
STAGES3 = ("constexpr int kStages = 2; ", "constexpr int kStages = 3; ")
GRAD_FMA = ("""              r[0] = fmaf(av[e], b.x, r[0]);
              r[1] = fmaf(av[e], b.y, r[1]);
              r[2] = fmaf(av[e], b.z, r[2]);
              r[3] = fmaf(av[e], b.w, r[3]);
""", "")
LOGIT_FMA = ("""        for (int i = 0; i < MR; ++i) {
          acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);""", """        for (int i = 0; i < MR; ++i) {
          if (SQUAT) continue;
          acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);""")
OUTER = ("""      for (int j = 0; j < NR; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kLd + c);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
        }
      }""", """      float4 bw[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j)
        bw[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kLd + c);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(av[i].x, bw[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(av[i].y, bw[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(av[i].z, bw[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(av[i].w, bw[j].w, acc[i][j]);""")
LOGIT_COPY = ("  if (sl * kKC < d) {", "  if (sl * kKC < d && TM == 0) {")
GRAD_COPY = ("stage<kWK, kDS>(", "if (false) stage<kWK, kDS>(")
# the gradients' resident instantiations taken out (they outgrow a block's
# shared memory in stages3 and kc64)
NO_RESIDENT = [(f"err = resident ? MRCLIP_GRAD({t}, true) : MRCLIP_GRAD({t}, false);",
                f"err = MRCLIP_GRAD({t}, false);") for t in ("64, 128", "32, 32")]
STREAMED = {kind: {"resident": False} for kind in ("grad_q", "grad_k")}
# name -> (source edits or None for the committed library, plan overrides by
# kind, right by design)
VARIANTS = {
    "committed": ([], {}, True),
    "stages3": ([STAGES3, *NO_RESIDENT], STREAMED, True),
    "kc64": ([KC64, *NO_RESIDENT], STREAMED, True),
    "outer": ([OUTER], {}, True),
    "logit_only": ([GRAD_FMA, GRAD_COPY], {}, False),
    "grad_only": ([LOGIT_FMA, LOGIT_COPY], {}, False),
    "grad_tile32": (None, {"grad_q": {"tile": (32, 32)}, "grad_k": {"tile": (32, 32)}}, True),
    "unsplit": (None, {kind: {"splits": 1} for kind in pl.TILES}, True),
    "streamed": (None, STREAMED, True),
}


def build_variant(name, edits):
    """The variant's three entry points, bound as the package binds them
    (None: the package's own library), and ptxas's lines."""
    if edits is None:
        return None, []
    dst = ROOT / "build" / "variants" / f"supcon_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    text = (dst / SOURCE).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE}")
        text = text.replace(old, new)
    (dst / SOURCE).write_text(text)
    out = dst / "libsupcon_loss.so"
    proc = subprocess.run(build.nvcc_command(dst / SOURCE, out, build._find_nvcc()),
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{log}")
    lines, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            lines.append(f"{entry}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    fns = {}
    for fn_name, fn in pl.load_kernels().items():
        fns[fn_name] = getattr(lib, fn_name)
        fns[fn_name].argtypes, fns[fn_name].restype = fn.argtypes, fn.restype
    return fns, lines


def calls(var, fns, q, k, lab, sc, gb, m, s, cnt):
    """Zero-argument calls of the three kernels through the variant's
    library (the package's where `fns` is None) under its plan."""
    _, overrides, _ = VARIANTS[var]
    fns = fns or pl.load_kernels()
    ps = {kind: pl._plan_for(kind, q, k, **overrides.get(kind, {})) for kind in pl.TILES}
    return {
        "supcon_stats": lambda: pl._run_stats(q, k, lab, lab, sc, ps["stats"],
                                              fns["supcon_stats"]),
        "supcon_grad_q": lambda: pl._run_grad_q(q, k, lab, lab, sc, gb, m, s, cnt, ps["grad_q"],
                                                fns["supcon_grad_q"]),
        "supcon_grad_k": lambda: pl._run_grad_k(q, k, lab, lab, sc, gb, m, s, cnt, ps["grad_k"],
                                                fns["supcon_grad_k"]),
    }, ps


LDS_SOURCE = r"""
#include <cuda_runtime.h>
// 16 warps a block, one block an SM; each warp issues iters x 16
// independent shared loads whose lane offsets follow `mode`.
template <int MODE>
__global__ void __launch_bounds__(512, 1) lds_kernel(float* out, int iters) {
  __shared__ __align__(16) float s[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) s[i] = i * 0.001f;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int off = MODE == 0 ? 0 : MODE == 1 ? (lane / 16) * 4 : MODE == 2 ? (lane % 2) * 4
                : MODE == 3 ? (lane % 4) * 4 : MODE == 4 ? (lane % 8) * 4 : MODE == 5 ? lane * 4
                : MODE == 6 ? lane : 0;
  float4 a0 = make_float4(0, 0, 0, 0), a1 = a0, a2 = a0, a3 = a0;
  float b0 = 0, b1 = 0, b2 = 0, b3 = 0;
  for (int it = 0; it < iters; ++it) {
    const int base = (it * 256) & 4095;
#pragma unroll
    for (int u = 0; u < 16; u += 4) {
      if (MODE >= 6) {
        b0 += s[base + off + u * 32];
        b1 += s[base + off + u * 32 + 32];
        b2 += s[base + off + u * 32 + 64];
        b3 += s[base + off + u * 32 + 96];
      } else {
        const float4 x0 = *reinterpret_cast<const float4*>(s + base + off + u * 128);
        const float4 x1 = *reinterpret_cast<const float4*>(s + base + off + u * 128 + 128);
        const float4 x2 = *reinterpret_cast<const float4*>(s + base + off + u * 128 + 256);
        const float4 x3 = *reinterpret_cast<const float4*>(s + base + off + u * 128 + 384);
        a0.x += x0.x; a0.y += x0.y; a0.z += x0.z; a0.w += x0.w;
        a1.x += x1.x; a1.y += x1.y; a1.z += x1.z; a1.w += x1.w;
        a2.x += x2.x; a2.y += x2.y; a2.z += x2.z; a2.w += x2.w;
        a3.x += x3.x; a3.y += x3.y; a3.z += x3.z; a3.w += x3.w;
      }
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0.x + a0.y + a0.z + a0.w + a1.x + a1.y + a1.z +
      a1.w + a2.x + a2.y + a2.z + a2.w + a3.x + a3.y + a3.z + a3.w + b0 + b1 + b2 + b3;
}
extern "C" int lds(int mode, float* out, int iters, int blocks) {
  switch (mode) {
    case 0: lds_kernel<0><<<blocks, 512>>>(out, iters); break;
    case 1: lds_kernel<1><<<blocks, 512>>>(out, iters); break;
    case 2: lds_kernel<2><<<blocks, 512>>>(out, iters); break;
    case 3: lds_kernel<3><<<blocks, 512>>>(out, iters); break;
    case 4: lds_kernel<4><<<blocks, 512>>>(out, iters); break;
    case 5: lds_kernel<5><<<blocks, 512>>>(out, iters); break;
    case 6: lds_kernel<6><<<blocks, 512>>>(out, iters); break;
    default: lds_kernel<7><<<blocks, 512>>>(out, iters); break;
  }
  return (int)cudaGetLastError();
}
"""
LDS_MODES = ["16-byte, one address a warp", "16-byte, one address a quarter-warp (2 a warp)",
             "16-byte, 2 addresses a quarter-warp", "16-byte, 4 addresses a quarter-warp",
             "16-byte, 8 addresses a quarter-warp (the same 128 bytes in each)",
             "16-byte, 32 addresses (512 bytes)", "4-byte, 32 addresses", "4-byte, one address"]


def shared_loads(result) -> None:
    """SM cycles one warp's shared load costs, by LDS_MODES, at the card's
    maximum SM clock."""
    dst = ROOT / "build" / "variants" / "lds"
    dst.mkdir(parents=True, exist_ok=True)
    (dst / "lds.cu").write_text(LDS_SOURCE)
    subprocess.run(build.nvcc_command(dst / "lds.cu", dst / "liblds.so", build._find_nvcc()),
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(dst / "liblds.so"))
    lib.lds.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True).stdout.split()[0])
    out = torch.empty(sms * 512, device="cuda")
    iters = 20000
    result["shared_loads"] = {"sm_clock_mhz": mhz}
    for mode, what in enumerate(LDS_MODES):
        lib.lds(mode, out.data_ptr(), 100, sms)
        ms = cs.cuda_ms(lambda: lib.lds(mode, out.data_ptr(), iters, sms), 1, warmup=0)
        cycles = ms * 1e-3 * mhz * 1e6 / (16 * iters * 16)  # per SM: 16 warps x iters x 16 loads
        result["shared_loads"][what] = cycles
        cs.log(f"[lds] {what}: {cycles:.3f} SM cycles a warp load ({ms:.3f} ms at {mhz:.0f} MHz)")


PARENT_SCRIPT = r"""
import json, statistics, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from mrclip_tpu_torch.ops import pallas_loss as pl
assert pl.__file__.startswith(root), pl.__file__
torch.backends.cuda.matmul.allow_tf32 = False
pl.load_kernels()
gen = torch.Generator(device="cuda").manual_seed(0)


def device_ms(fn, n):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3


def event_ms(fn, n):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


out = {}
for b in (256, 8192):
    n = 20 if b == 256 else 3
    x, y = (torch.nn.functional.normalize(torch.randn(b, 512, device="cuda", generator=gen), dim=-1)
            for _ in range(2))
    lab = torch.randint(0, 32, (b,), device="cuda", generator=gen).to(torch.int32)
    sc = torch.tensor([1 / 0.07], device="cuda")
    gb = torch.tensor([0.5 / b], device="cuda")
    m, s, _, cnt = pl.supcon_stats_ref(x, y, lab, lab, sc)
    cnt = cnt.clamp(min=1.0)
    img, txt = x.clone().requires_grad_(), y.clone().requires_grad_()
    scale = torch.tensor(1 / 0.07, device="cuda", requires_grad=True)

    def loss():
        pl.pallas_multipositive_clip_loss(img, txt, lab, scale)["loss"].backward()
        img.grad = txt.grad = scale.grad = None

    fns = {"loss_fwd_bwd": loss,
           "supcon_stats": lambda: pl.supcon_stats(x, y, lab, lab, sc),
           "supcon_grad_q": lambda: pl.supcon_grad_q(x, y, lab, lab, sc, m, s, cnt, gb),
           "supcon_grad_k": lambda: pl.supcon_grad_k(x, y, lab, lab, sc, m, s, cnt, gb)}
    for name, fn in fns.items():
        for _ in range(2):
            fn()
        out[f"B{b} {name}"] = {"event_ms": statistics.median(event_ms(fn, n) for _ in range(5)),
                               "device_ms": statistics.median(device_ms(fn, n) for _ in range(3))}
print(json.dumps(out))
"""


def parent_turns(parent: str, result) -> None:
    """PARENT_SCRIPT from `parent` and from this checkout, each in its own
    process, in turns: parent, this, this, parent."""
    script = ROOT / "build" / "variants" / "supcon_parent.py"
    script.parent.mkdir(parents=True, exist_ok=True)
    script.write_text(PARENT_SCRIPT)
    reads = {}
    for tag, root in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        proc = subprocess.run([sys.executable, str(script), str(Path(root).resolve())],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} tree {root}: {proc.stderr[-2000:]}")
        for key, t in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            reads.setdefault(f"{tag} {key}", []).append(t)
    result["parent"] = {"tree": str(parent), "readings": reads}
    for key, ts in reads.items():
        cs.log(f"[parent] {key}: event " + " / ".join(f"{t['event_ms']:.4f}" for t in ts)
               + " ms, device " + " / ".join(f"{t['device_ms']:.4f}" for t in ts) + " ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", help="another checkout to time beside this one, in turns")
    ap.add_argument("--shared-loads", action="store_true",
                    help="the shared-load microbenchmark instead of the variants")
    ap.add_argument("--out", default="build/supcon_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("supcon_variants: no CUDA device available", file=sys.stderr)
        return 1
    if args.shared_loads or args.parent:
        name, smi = cs.phase_card()
        result = {"card": smi, "device": name}
        if args.shared_loads:
            shared_loads(result)
        if args.parent:
            parent_turns(args.parent, result)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(smi)
        return 0
    names = args.variants.split(",")
    name, smi = cs.phase_card()
    pl.load_kernels()  # the package's library, whose argtypes the variants take
    with ThreadPoolExecutor(len(names)) as pool:  # the variants build together
        done = dict(zip(names, pool.map(build_variant, names,
                                        (VARIANTS[v][0] or None for v in names))))
    for var, (_, lines) in done.items():
        for line in lines:
            cs.log(f"[ptxas] {var}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    result = {"card": smi, "device": name, "shapes": {}}
    for n in (cs.TRAIN_BATCH, 8192):
        q, k, lab, sc, gb = cs.supcon_inputs(n, 32, gen)
        m, s, _, cnt = pl.supcon_stats_ref(q, k, lab, lab, sc)
        cnt = cnt.clamp(min=1.0)
        want = {"supcon_stats": pl.supcon_stats_ref(q, k, lab, lab, sc),
                "supcon_grad_q": pl.supcon_grad_q_ref(q, k, lab, lab, sc, m, s, cnt, gb),
                "supcon_grad_k": (pl.supcon_grad_k_ref(q, k, lab, lab, sc, m, s, cnt, gb),)}
        fns = {}
        for var, (lib, _) in done.items():
            var_calls, ps = calls(var, lib, q, k, lab, sc, gb, m, s, cnt)
            cs.log(f"[plan] {var} B={n}: " + ", ".join(
                f"{kind} {p.tm}x{p.tn} x{p.splits} ({p.blocks} blocks)" for kind, p in ps.items()))
            for fn_name, fn in var_calls.items():
                fns[f"{var} {fn_name}"] = fn
                if VARIANTS[var][2]:
                    got = fn()
                    got = got if isinstance(got, tuple) else (got,)
                    err = max(cs.rel_err(g, w) for g, w in zip(got, want[fn_name]))
                    if err > cs.SUPCON_TOL:
                        raise AssertionError(f"variant {var} {fn_name} at B={n}: {err:.3e}")
        dev = cs.device_ms(fns, launches=5 if n == 8192 else 20, runs=5)
        result["shapes"][f"B{n} D{cs.EMBED}"] = dev
        for key, ms in dev.items():
            cs.log(f"[time] B={n} D={cs.EMBED} {key}: {cs.fmt_ms(ms)} ms device")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
