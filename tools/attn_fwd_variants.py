#!/usr/bin/env python3
"""Time the bf16 attention forward on wgmma (`wgmma_fwd_kernel` in
`mrclip_tpu_torch/csrc/attn_mma_fwd.cuh`: K1, K4 and K10 with one key block
of at most 256 keys at D = 64) beside variants of its design, on one CUDA
card, in turns within one process.

    python3 tools/attn_fwd_variants.py [--out build/attn_fwd_variants.json]

Each variant is the committed sources with text edits to that header, built
by nvcc into `build/variants/fwd_<name>/` and called through its own
`packed_attn_fwd` C entry (K1; K4 and K10 run the same kernel with other
strides or statistics). The package's modules are not touched.
  committed     the sources as they are: two blocks an SM;
  three_blocks  three blocks an SM (`__launch_bounds__(128, 3)`: at most
                168 registers a thread, not 255);
  n64_only      S on whole 64-key tiles only: the launcher rounds the
                16-key groups up to a multiple of four, so N = 197 computes
                256 keys, not 208.
For each it prints ptxas's registers and spills of the wgmma kernels,
checks K1 against its plain version at the timed shapes (O_TOL and LSE_TOL,
as chip_smoke.py), and times K1 at ViT-B-16 vision b32 and b256, text b256
(N = 98, causal) and EVA02-B-16's text ctx 77 b256: medians of 7 rounds of
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
VARIANTS = {
    "committed": [],
    "three_blocks": [("__launch_bounds__(kMmaThreads, 2)\n    wgmma_fwd_kernel(",
                      "__launch_bounds__(kMmaThreads, 3)\n    wgmma_fwd_kernel(")],
    "n64_only": [("causal, (nk + 15) / 16, stream);", "causal, (nk + 63) / 64 * 4, stream);")],
}
SHAPES = {"vision_b256": dict(cs.VISION, b=cs.TRAIN_BATCH), "vision_b32": cs.VISION,
          "text_b256": dict(cs.TEXT, b=cs.TRAIN_BATCH),
          "text77_b256": dict(cs.TEXT77, b=cs.TRAIN_BATCH)}


def build_variant(name, edits):
    """The variant's `packed_attn_fwd` C function and ptxas's lines for its
    wgmma kernels."""
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
    fn = ctypes.CDLL(str(out)).packed_attn_fwd
    fn.argtypes = fa.load_kernel().argtypes
    fn.restype = ctypes.c_int
    return fn, lines


def k1_call(fn, shape, q, k, v):
    """A zero-argument call of the variant's K1 on the packed column slices
    q, k, v, allocating o and lse as the package's wrapper does."""
    b, n, hd = q.shape
    h, d = shape["h"], shape["d"]

    def call():
        o = torch.empty((b, n, hd), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), 1, b, n,
                 k.shape[1], h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), 1.0 / math.sqrt(d), int(shape["causal"]),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"packed_attn_fwd launch failed: cudaError {err}")
        return o, lse

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/attn_fwd_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_fwd_variants: no CUDA device available", file=sys.stderr)
        return 1
    name, smi = cs.phase_card()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # the variants build together
        done = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS, VARIANTS.values())))
    for var, (_, lines) in done.items():
        for line in lines:
            cs.log(f"[ptxas] {var}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(12)
    result = {"card": smi, "kind": name, "shapes": {}}
    for tag, shape in SHAPES.items():
        q, k, v = cs.qkv_slices(shape, torch.bfloat16, gen)
        fns = {var: k1_call(fn, shape, q, k, v) for var, (fn, _) in done.items()}
        o_ref, lse_ref = fa.fused_attention_packed_ref(q, k, v, is_causal=shape["causal"],
                                                       heads=shape["h"])
        errs = {}
        for var, call in fns.items():
            o, lse = call()
            torch.cuda.synchronize()
            errs[var] = (cs.abs_err(o, o_ref), (lse - lse_ref).abs().max().item())
            if not (errs[var][0] <= cs.O_TOL[torch.bfloat16] and errs[var][1] <= cs.LSE_TOL):
                raise AssertionError(f"{var} at {tag}: max |o - plain|, |lse - plain| = "
                                     f"{errs[var]}")
        ms, readings = cs.median_ms(fns, 50)
        dev = cs.device_ms(fns)
        bound, by = cs.attention_bound(**shape, dtype=torch.bfloat16)
        cs.log(f"[time] K1 {tag}: " + ", ".join(
            f"{var} {ms[var]:.4f} / {cs.fmt_ms(dev[var])} ms" for var in fns)
            + f" (event median of {cs.FWD_RUNS} / profiler device time; readings "
              f"{cs.spread(readings)}); bound {bound * 1e3:.2f} us ({by}); on {smi}")
        result["shapes"][tag] = {"event_ms": ms, "device_ms": dev, "readings": readings,
                                 "max_abs_err": errs, "bound_ms": bound}
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
