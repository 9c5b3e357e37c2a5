#!/usr/bin/env python3
"""Look for a missing wait or fence in the bf16 attention backward on wgmma
(K3, K3r, K5 and K10b, `mrclip_tpu_torch/csrc/attn_mma_bwd.cuh`), on one
CUDA card.

    python3 tools/attn_bwd_sanitize.py [--out build/attn_bwd_sanitize] [--sass-dir DIR]

Two builds, made as tools/attn_bwd_variants.py makes its variants (the
committed sources with text edits to that header, into
`build/variants/<name>/`):
  committed  the sources as they are: every wgmma walk ends in a
             straight-line step of TAIL = 1-4 16-row groups;
  tail0      a walk of a whole number of 64-row steps ends in the loop's
             last pass (TAIL 0; `with_tail` maps a group count that is a
             multiple of 4 to it), the form the header's note says is
             wrong.
At N = 128, 192 and 256 (B = 2, H = 12, D = 64, bf16, not causal; 8, 12
and 16 groups, so TAIL 0 in the tail0 build) the script
  1. holds each build's K3, K3r (with a random table, and with the
     identity table) and K10b against their plain versions (GRAD_TOL, as
     chip_smoke.py) and prints the errors; a tail0 failure is reported,
     not raised;
  2. runs itself again under `compute-sanitizer --tool racecheck` and
     `--tool synccheck` for each build (the wgmma backward kernels only,
     `--kernel-name kns=wgmma_bwd`), calling those kernels once at each
     shape, and prints each run's exit code and error summary (or why it
     did not run: the sanitizer missing from the toolkit, or refused);
  3. disassembles both builds' three libraries (`cuobjdump -sass`) and,
     for every wgmma backward instantiation, finds its innermost loop that
     issues wgmma (the walk of whole 64-row steps), the A-operand registers
     the loop carries around its back-edge (read before written in the
     body: Q and dO in the dq pass, K and V in the dk/dv pass, the same in
     every pass by design) and the body's instructions that write one of
     them after that read, so that the next pass multiplies another value;
     it prints the count of such loops per build, the counts and loops of
     the rope dq and dk/dv pair (TAIL 4 against TAIL 0) and of every loop
     that writes one, and writes that pair's SASS to the output directory.
The run fails (exit 1) if a committed kernel disagrees with its plain
version or a committed loop writes a carried A operand.
`--out` is a directory: `result.json` and the SASS files. Needs one CUDA
card; imports no JAX. `--sass-dir DIR` reads the `.sass` files a run
wrote to DIR again (step 3 on them alone), without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import attn_bwd_variants as av  # noqa: E402
import chip_smoke as cs  # noqa: E402
from mrclip_tpu_torch.ops import flash_attn as fl  # noqa: E402
from mrclip_tpu_torch.ops import fused_attn as fa  # noqa: E402

BUILDS = {
    "committed": [],
    "tail0": [
        ("    default: return fn(C(), std::integral_constant<int, 4>());",
         "    default: return fn(C(), std::integral_constant<int, 0>());"),
        ("        (groups_k - 1) / 4, tiles_q);", "        (groups_k - 1) / 4 + (kTail == 0), tiles_q);"),
        ("        (groups_q - 1) / 4, tiles_k);", "        (groups_q - 1) / 4 + (kTail == 0), tiles_k);"),
        ("    if (!CAUSAL || 64 * full < row0 + kMmaRows)\n      dq_step<TAIL",
         "    if constexpr (TAIL > 0) if (!CAUSAL || 64 * full < row0 + kMmaRows)\n"
         "      dq_step<TAIL"),
        ("    dkv_step<TAIL, FLASH, CAUSAL>(dka", "    if constexpr (TAIL > 0) dkv_step<TAIL, FLASH, CAUSAL>(dka"),
    ],
}
SHAPES = [dict(b=2, n=n, nk=n, h=12, d=64, causal=False, prefix=1) for n in (128, 192, 256)]
TOOLS = ("racecheck", "synccheck")
SANITIZE_S = 200  # each run's limit
# the rope kernels whose SASS is compared: (pass, mangled template arguments
# <FLASH, ROPE, CAUSAL, TAIL>) of the committed build and the tail0 build
SASS_PAIRS = [(f"wgmma_bwd_{p}_kernel", "ILb0ELb1ELb0ELi4E", "ILb0ELb1ELb0ELi0E")
              for p in ("dq", "dkv")]
SASS_KEYS = ("HGMMA", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR", "WARPSYNC", "BAR.SYNC",
             "LDGSTS", "LDGDEPBAR", "DEPBAR", "FENCE", "STG", "LDSM")


def cases(fns, gen):
    """(tag, zero-argument call, plain result) of K3, K3r (random and
    identity tables) and K10b of the library functions `fns` at SHAPES."""
    out = []
    for shape in SHAPES:
        n, h = shape["n"], shape["h"]
        _, k10b_args, k3_args = av.inputs(shape, gen)
        _, k10b, k3 = av.calls(fns, None, k10b_args, k3_args, False, h)
        out.append((f"K3 N={n}", k3, fa.fused_attention_packed_bwd_ref(*k3_args, heads=h)))
        out.append((f"K10b N={n}", k10b, fl.flash_attention_bwd_ref(*k10b_args)))
        q, k, v, rope, tab = cs.rope_inputs(shape, torch.bfloat16, gen)
        half = (n - shape["prefix"], shape["d"])  # sin || cos of the raw table
        ident = np.concatenate([np.zeros(half, np.float32), np.ones(half, np.float32)], 1)
        for tname, table in (("random", tab),
                             ("identity", fa.rope_table(ident, 1, torch.bfloat16).cuda())):
            o, lse = fa.fused_attention_packed(q, k, v, heads=h, rope=table)
            do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
            call = av.bound_call(fa.fused_attention_packed_bwd, (fa, "load_rope_bwd_kernel"),
                                 fns[3], q, k, v, o, do, lse, heads=h, rope=table)
            want = fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, heads=h, rope=table)
            out.append((f"K3r N={n} {tname} table", call, want))
    return out


def rel(got, want):
    scale = max(w.float().abs().max().item() for w in want)
    return max(cs.rel_err(g, w, scale) for g, w in zip(got, want))


def child(name: str) -> int:
    """Under the sanitizer: each kernel once at each shape."""
    fns = av.bind_variant(ROOT / "build" / "variants" / name)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for tag, call, _ in cases(fns, gen):
        call()
        torch.cuda.synchronize()
        print(f"[child] {name} {tag} ran", flush=True)
    return 0


def sanitize(exe, name, tool):
    """One sanitizer run of `child(name)`: (exit code, summary line, tail)."""
    cmd = [exe, "--tool", tool, "--kernel-name", "kns=wgmma_bwd", "--print-limit", "20",
           sys.executable, __file__, "--child", name]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=SANITIZE_S)
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        return None, f"timed out after {SANITIZE_S} s", out[-3000:]
    text = proc.stdout + proc.stderr
    summary = [line.strip("= ") for line in text.splitlines()
               if line.startswith("=========") and ("Error" in line or "SUMMARY" in line)]
    return proc.returncode, "; ".join(summary) or "no summary line", text[-4000:]


def functions(sass: str) -> dict:
    """Mangled name -> SASS text of each function in cuobjdump's output."""
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return {parts[i]: parts[i + 1] for i in range(1, len(parts) - 1, 2)}


_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"\bR(\d+)\b")
# opcodes whose first operand is not a register they write
_NO_DEST = ("ST", "BRA", "BAR", "WARPGROUP", "DEPBAR", "EXIT", "RED", "BSYNC", "BSSY", "NOP",
            "MEMBAR", "FENCE", "LDGDEPBAR", "ARRIVE", "CALL", "RET", "WARPSYNC")


def _parse(op: str):
    """(opcode, destination register or None, registers read) of one SASS
    instruction, its predicate stripped; a wgmma (HGMMA) reads its A
    operand as four registers from the one named."""
    op = re.sub(r"^@!?U?P\w+\s+", "", op.strip())
    opcode, _, rest = op.partition(" ")
    operands = [x.strip() for x in rest.split(",")]
    regs = [[int(r) for r in _REG.findall(x)] for x in operands]
    if opcode.startswith("HGMMA"):
        a = regs[1] if len(regs) > 1 else []
        return opcode, None, {a[0] + i for i in range(4)} if a else set()
    if opcode.startswith(_NO_DEST) or not regs or not regs[0]:
        return opcode, None, {r for x in regs for r in x}
    wide = 2 if ".64" in opcode or "WIDE" in opcode else 1
    dest = {regs[0][0] + i for i in range(wide)}
    return opcode, dest, {r for x in regs[1:] for r in x}


def wgmma_loops(text: str, after: int = 12) -> list:
    """Each innermost loop (a backward branch, its body from the target to
    it, holding no other backward branch) that issues wgmma: the walk of
    whole 64-row steps. The wgmma A-operand registers the body reads before it
    writes them (values carried around the back-edge, so the next pass reads
    them as this one did), the body's instructions that write one of them
    after that read (a carried A operand overwritten: the next pass then
    multiplies another value), and the first `after` instructions of the
    loop's exit."""
    ins = [(int(m.group(1), 16), m.group(2)) for m in _ADDR.finditer(text)]
    edges = []
    for i, (addr, op) in enumerate(ins):
        tgt = re.search(r"BRA\s+(?:`\(\.)?(0x[0-9a-f]+)", op)
        if tgt and int(tgt.group(1), 16) < addr:
            edges.append((i, addr, int(tgt.group(1), 16)))
    loops = []
    for i, addr, target in edges:
        if any(target <= a < addr for _, a, _ in edges):
            continue  # an outer loop
        body = [(a, o) for a, o in ins if target <= a <= addr]
        if not any("HGMMA" in o for _, o in body):
            continue
        written, carried, clobbers = set(), set(), []
        for a, o in body:
            opcode, dest, reads = _parse(o)
            if opcode.startswith("HGMMA"):
                carried |= reads - written
            if dest:
                if dest & carried:
                    clobbers.append(f"{a:04x}: {o}")
                written |= dest
        loops.append({"back_edge": f"{addr:04x}: {op}", "body": f"{target:04x}-{addr:04x}",
                      "carried_a_registers": sorted(carried),
                      "carried_a_overwritten_by": clobbers,
                      "exit": [f"{a:04x}: {o}" for a, o in ins[i + 1:i + 1 + after]]})
    return loops


def analyse_sass(texts: dict) -> dict:
    """Instruction counts and wgmma loops of each function's SASS, by name."""
    result = {}
    for name, text in texts.items():
        counts = {k: len(re.findall(rf"\b{re.escape(k)}\b", text)) for k in SASS_KEYS}
        counts["instructions"] = len(_ADDR.findall(text))
        loops = wgmma_loops(text)
        result[name] = {"counts": counts, "wgmma_loops": loops}
        if not any(lp["carried_a_overwritten_by"] for lp in loops) and not name.endswith(
                tuple(a for _, c, t in SASS_PAIRS for a in (c, t))):
            continue  # the printed lines: the compared pair, and any loop that overwrites
        cs.log(f"[sass] {name}: {json.dumps(counts)}")
        for lp in loops:
            regs = lp["carried_a_registers"]
            cs.log(f"[sass]   wgmma loop {lp['body']}: carried A operands R{min(regs)}-R{max(regs)} "
                   f"({len(regs)} registers); overwritten inside the loop by "
                   f"{len(lp['carried_a_overwritten_by'])} instructions"
                   + (f", first {lp['carried_a_overwritten_by'][0]}"
                      if lp["carried_a_overwritten_by"] else "")
                   + "; exit: " + " | ".join(x.split(": ", 1)[1] for x in lp["exit"][:6]))
    return result


_INST = re.compile(r"(wgmma_bwd_\w+?_kernel)(I(?:L[bi]\d+E)+E)")


def dump_sass(build: str, out: Path) -> dict:
    """The SASS of every wgmma backward instantiation in the build's three
    libraries, by "<build> <library> <kernel><template args>"; the rope
    dq and dk/dv pair of SASS_PAIRS also written to `out` as
    <build>_<kernel>_<args>.sass."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    texts = {}
    for lib in ("packed_attn_bwd", "grouped_attn", "flash_attn"):
        path = ROOT / "build" / "variants" / build / f"lib{lib}.so"
        proc = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump failed on {path}: {proc.stderr[-2000:]}")
        for fn, text in functions(proc.stdout).items():
            m = _INST.search(fn)
            if m is None:
                continue
            texts[f"{build} {lib} {m.group(1)}{m.group(2)}"] = text
            for kernel, committed_args, tail0_args in SASS_PAIRS:
                args = committed_args if build == "committed" else tail0_args
                if lib == "packed_attn_bwd" and m.group(1) == kernel and m.group(2).startswith(args):
                    (out / f"{build}_{kernel}_{args}.sass").write_text(text)
    return texts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/attn_bwd_sanitize")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--sass-dir", help="analyse the .sass files an earlier run wrote there "
                                       "(no card needed) and exit")
    args = ap.parse_args()
    if args.sass_dir:
        texts = {f.stem: f.read_text() for f in sorted(Path(args.sass_dir).glob("*.sass"))}
        analyse_sass(texts)
        return 0
    if not torch.cuda.is_available():
        print("attn_bwd_sanitize: no CUDA device available", file=sys.stderr)
        return 1
    if args.child:
        return child(args.child)
    name, smi = cs.phase_card()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fa.load_bwd_kernel()  # the package's own libraries, whose argtypes the builds take
    fa.load_rope_kernel()
    fa.load_kernel()
    fl.load_kernels()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        built = dict(zip(BUILDS, pool.map(av.build_variant, BUILDS, BUILDS.values())))
    nvcc = subprocess.run([av.build._find_nvcc(), "--version"], capture_output=True, text=True)
    result = {"card": smi, "device": name, "shapes": SHAPES, "checks": {}, "sanitizer": {},
              "nvcc": nvcc.stdout.strip().splitlines()[-1]}
    cs.log(f"[card] nvcc: {result['nvcc']}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for build, (fns, _) in built.items():
        errs = {tag: rel(call(), want) for tag, call, want in cases(fns, gen)}
        result["checks"][build] = errs
        for tag, err in errs.items():
            ok = err <= cs.GRAD_TOL[torch.bfloat16]
            cs.log(f"[check] {build} {tag}: {err:.3e} (tol {cs.GRAD_TOL[torch.bfloat16]}) "
                   + ("ok" if ok else "WRONG"))
    committed_wrong = [t for t, e in result["checks"]["committed"].items()
                       if not e <= cs.GRAD_TOL[torch.bfloat16]]

    exe = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.isfile(exe):
        result["sanitizer"] = {"available": False, "searched": exe}
        cs.log(f"[sanitizer] compute-sanitizer is not in the toolkit ({exe} missing)")
    else:
        ver = subprocess.run([exe, "--version"], capture_output=True, text=True)
        result["sanitizer"] = {"available": True, "path": exe,
                               "version": (ver.stdout + ver.stderr).strip()[-300:]}
        cs.log(f"[sanitizer] {exe}: {result['sanitizer']['version']}")
        for build in BUILDS:
            for tool in TOOLS:
                rc, summary, tail = sanitize(exe, build, tool)
                result["sanitizer"][f"{build} {tool}"] = {"rc": rc, "summary": summary,
                                                         "tail": tail}
                cs.log(f"[sanitizer] {build} {tool}: rc {rc}; {summary}")
                if "Device not supported" in summary:
                    cs.log("[sanitizer] the sanitizer refuses this card: no further runs")
                    break
            else:
                continue
            break

    result["sass"] = {}
    for build in BUILDS:
        sass = analyse_sass(dump_sass(build, out))
        result["sass"].update(sass)
        bad = sorted(n for n, r in sass.items()
                     if any(lp["carried_a_overwritten_by"] for lp in r["wgmma_loops"]))
        cs.log(f"[sass] {build}: {len(sass)} wgmma backward instantiations, "
               f"{sum(len(r['wgmma_loops']) for r in sass.values())} wgmma loops; loops that "
               f"overwrite a carried A operand: {len(bad)} ({', '.join(bad[:6])})")
        if build == "committed":
            committed_wrong += bad
    with open(out / "result.json", "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    if committed_wrong:
        print(f"the committed kernels disagree with their plain versions or overwrite a wgmma "
              f"loop's carried A operands: {committed_wrong}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
