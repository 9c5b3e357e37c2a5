#!/usr/bin/env python3
"""Time the attention kernels at head dims 80, 88 and 104 (K1/K3, K4/K5 and
K10/K10b, bf16 on `mma.sync`) beside variants of how they stage their N =
257 rows, on one CUDA card, in turns.

    python3 tools/attn_wide_variants.py [--variants committed,chunk256,resident]
                                        [--rounds 2] [--out build/attn_wide_variants.json]

Each variant is a copy of the package (with `chip_smoke.py` and
`pyproject.toml`) under `build/variants/wide_<name>/`, text-edited in
`attn_mma_fwd.cuh` and `attn_mma_bwd.cuh`, built by nvcc into the copy's
own `build/kernels/` and run in a process of its own that imports the copy:
  committed  the sources as they are: past D = 64 a staged chunk leaves
             shared memory for two blocks an SM (`mma_max_chunk`,
             `mma_bwd_max_chunk`: N = 257 resident at D = 80, in two chunks
             at 88 and 104) and a block's sub-tiles are spread evenly;
  chunk256   D = 64's chunk of 256 rows at every width (N = 257 in two
             chunks, one block an SM at 88 and 104) and up to four
             sub-tiles a block (5 as 4 + 1);
  resident   N = 257 in one chunk at 88 and 104 too (one block an SM).
Each run holds K1/K3, K4/K5 and K10/K10b against their plain versions at
phase 16's shapes (`chip_smoke.wide_pairs`, bf16 and fp32, phase 3's
bars) and times them at N 257, H 16, b256 and b32
(`chip_smoke.wide_timings`: medians of 7 event readings and the profiler's
device time per launch). A round runs every variant once; the next round
runs them in reverse order. Prints one line per kernel and shape, device
ms per variant and round, and writes the readings as JSON. Needs one CUDA
card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FWD, BWD = "attn_mma_fwd.cuh", "attn_mma_bwd.cuh"
# (header, committed text, variant text)
CHUNK256 = [
    (FWD, "  if (D <= 64) return kMaxChunk;\n  const int fit = ((",
     "  if (true) return kMaxChunk;\n  const int fit = (("),
    (BWD, "  if (D <= 64) return kMaxChunk;\n  const int fit = (",
     "  if (true) return kMaxChunk;\n  const int fit = ("),
    (FWD, "  const int blocks = (tiles + most - 1) / most;\n  return (tiles + blocks - 1) / blocks;",
     "  return tiles < most ? tiles : most;"),
]
RESIDENT = [
    (FWD, "  if (D <= 64) return kMaxChunk;\n  const int fit = ((",
     "  if (D <= 64) return kMaxChunk;\n  if (D > 80) return kMaxResident;\n  const int fit = (("),
    (BWD, "  if (D <= 64) return kMaxChunk;\n  const int fit = (",
     "  if (D <= 64) return kMaxChunk;\n  if (D > 80) return kMaxResident;\n  const int fit = ("),
]
VARIANTS = {"committed": [], "chunk256": CHUNK256, "resident": RESIDENT}
DIMS = (80, 88, 104)


def make_copy(name: str) -> Path:
    """The package, chip_smoke.py and pyproject.toml under
    build/variants/wide_<name>/ with the variant's edits (a kept build dir
    is reused: nvcc keys it by the sources)."""
    dst = ROOT / "build" / "variants" / f"wide_{name}"
    dst.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(dst / "mrclip_tpu_torch", ignore_errors=True)
    shutil.copytree(ROOT / "mrclip_tpu_torch", dst / "mrclip_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in ("chip_smoke.py", "pyproject.toml"):
        shutil.copy(ROOT / f, dst / f)
    for header, old, new in VARIANTS[name]:
        path = dst / "mrclip_tpu_torch" / "csrc" / header
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the text to edit is not once in {header}")
        path.write_text(text.replace(old, new))
    return dst


def worker(name: str, check: bool) -> dict:
    """In a variant's copy: build, check (once), time; the readings."""
    import torch

    import chip_smoke as cs
    from mrclip_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_libraries(cs.SOURCES)
    gen = torch.Generator(device="cuda").manual_seed(20)
    if check:
        for d in DIMS:
            for shape in [dict(cs.WIDE_VISION, d=d), *(dict(s, d=d) for s in cs.WIDE_EDGES)]:
                for dtype in (torch.bfloat16, torch.float32):
                    for pair, (f, r, kinds, got, want) in cs.wide_pairs(shape, dtype, gen).items():
                        cs.check_attention(f"[{name}] {pair}", shape, dtype, (f, r, kinds),
                                           (got, want))
    out = {}
    for d in DIMS:
        for b in (256, 32):
            timed = cs.wide_timings(dict(cs.WIDE_VISION, b=b, d=d), gen)
            out[f"d{d}_b{b}"] = {k: {"ms": v["ms"], "device_ms": v["device_ms"]}
                                 for k, v in timed.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "attn_wide_variants.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:  # inside a copy: its package and chip_smoke.py come first
        sys.path.insert(0, str(Path.cwd()))
        print("WIDE_JSON " + json.dumps(worker(args.worker, args.check)), flush=True)
        return 0

    names = args.variants.split(",")
    copies = {name: make_copy(name) for name in names}
    # one nvcc build per copy, all started together
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
                                "import chip_smoke as cs; from mrclip_tpu_torch.ops import build; "
                                "build.load_libraries(cs.SOURCES)"], cwd=copies[n])
              for n in names]
    if any(p.wait() for p in builds):
        raise SystemExit("a variant failed to build")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    readings = {name: [] for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", name]
            run = subprocess.run(cmd + (["--check"] if r == 0 else []), cwd=copies[name],
                                 capture_output=True, text=True)
            if run.returncode:
                sys.stdout.write(run.stdout[-4000:] + run.stderr[-4000:])
                raise SystemExit(f"variant {name} failed in round {r}")
            line = next(x for x in run.stdout.splitlines() if x.startswith("WIDE_JSON "))
            readings[name].append(json.loads(line[len("WIDE_JSON "):]))
            print(f"round {r}: {name} checked and timed", flush=True)
    first = readings[names[0]][0]
    for shape, kernels in first.items():
        for kernel in kernels:
            cells = ", ".join(
                f"{name} " + " / ".join(f"{run[shape][kernel]['device_ms']:.4f}"
                                        for run in readings[name]) for name in names)
            print(f"{shape:10s} {kernel:17s} device ms: {cells}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "readings": readings}, indent=1))
    print(f"readings written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
