#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mrclip_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:
  1. card:   name, power limit, TF32 off for fp32 products;
  2. build:  every CUDA source in `mrclip_tpu_torch/csrc` (one nvcc each, all
             started together), with registers and spills from ptxas;
  3. kernel: each kernel against its plain PyTorch version on the card: K1
             (attention forward) and K3 (attention backward) at the served and
             trained shapes and ragged edges, bf16 and fp32, q/k/v/o/dO as
             strided column slices; K2 and K3r (the same with the EVA02 rope
             rotated inside) at EVA02-B-16's vision shapes b32 and b256 with
             the real rope_cat_2d table and at edges (prefix 0, N = 1, 50,
             257, head dim 32, causal); K6/K7 (fused SupCon loss) in fp32 at
             B in {100, 256, 333} and with distinct labels; timings beside
             the plain versions, the bounds and SDPA (forward, and backward;
             for K2/K3r on q and k rotated beforehand, so not the same
             function), and K2/K3r beside K1/K3 at the same shape; K4/K5
             (grouped-layout attention, 'fused') and K10/K10b (flash
             attention, 'flash'; also at N = 257 and 577, several key
             blocks) at the same shapes as K1/K3, bf16 and fp32, timed at
             the b256 shapes of phases 8 and 9 beside K1 (K4) and K4/K5
             (K10/K10b);
  4. serve:  full-width ViT-B-16 (random weights from a seed, bf16 compute,
             fp32 params, attn_impl='fusedp') exported to an artifact, loaded,
             served over HTTP on 127.0.0.1; health, concurrent image and text
             requests and a score; features checked against the same weights
             under the plain attention; the kernel launch counts of that run;
             served throughput at b32/b256;
  5. train:  full-width ViT-B-16 (bf16 compute, fp32 params, 'fusedp', tanh
             GELU) with AdamW (lr 1e-4, wd 0.2, bf16 first moment) and the
             multipositive loss, batch 256 of uint8 images normalised inside
             the step; gradients checked against plain attention and the
             pallas loss against the dense one at the initial weights; then
             one warm-up and 5 timed dense steps and one pallas-loss step,
             with the kernels' launch counts of that run;
  6. serve EVA02-B-16 (full width and depth, random weights from a seed,
             bf16, 'fusedp'): export, load, `encode_image` at b32 and b256
             and `encode_text` at b256 through `ServedModel`; features
             against the same weights under plain attention; 12 K2 launches
             per image call and 12 K1 per text call;
  7. train EVA02-B-16 at b256, as phase 5: 12 K2, 12 K1, 12 K3r and 12 K3
             launches per step, every q/k/v projection with a gradient;
  8. fused:  ViT-B-16 as phase 5 under attn_impl='fused': one warm-up and 3
             timed dense steps with 24 K4 and 24 K5 launches each and no
             packed kernel; then `encode_image` at b256 through `ServedModel`
             from an exported 'fused' artifact, 12 K4 per call, against the
             same weights under plain attention;
  9. flash:  EVA02-B-16 as phase 7 under attn_impl='flash': 48 K10 (24 in
             the forward, 24 recomputed in the backward) and 24 K10b per
             step, no packed kernel, every q/k/v projection with a gradient,
             peak memory beside phase 7's; `encode_image` at b256 under
             `inference_mode`, 12 K10 per call.
Each path (4 to 9) runs with the launch counts set to 0 just before it and
reads them just after. The last three lines are the kernels JSON, the card's
name and power limit, and {"ok": true, "device": {...}}. Needs one CUDA card
and imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 MMA / fp32 FMA
# K1 o: about one bf16 ulp at |o| < 4; fp32 differs only in summation order
O_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
# K3, max |err| of each of dq, dk, dv over the largest max |plain| of the
# three (one scale per call: at N = 1, dq and dk are exactly 0 and the plain
# version's rounding noise has no scale of its own): kernel and plain version
# round P and dS to bf16 at the same points, but fp32 sums in another order
# can flip one bf16 rounding of a gradient (~1e-2 relative); fp32 is
# summation order only.
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# K6/K7, fp32 with TF32 off: max |err| / max |plain|, summation order only
SUPCON_TOL = 1e-5
VISION = dict(b=32, n=197, nk=197, h=12, d=64, causal=False)  # ViT-B-16, batch 32
TEXT = dict(b=32, n=98, nk=98, h=8, d=64, causal=True)  # its text tower, context 98
TRAIN_BATCH = 256
EMBED = 512  # ViT-B-16's embedding width: the D of the loss kernels
SUPCON_CASES = [(256, 32), (100, 32), (333, 32), (256, None)]  # (B, label classes | distinct)
EDGES = [dict(b=4, n=n, nk=n, h=4, d=64, causal=c) for n in (1, 50, 257) for c in (False, True)]
EDGES += [dict(b=2, n=76, nk=255, h=2, d=64, causal=False),  # kv length != q length
          dict(b=3, n=33, nk=33, h=2, d=32, causal=True)]  # head dim 32
TEXT77 = dict(TEXT, n=77, nk=77)  # EVA02-B-16's text tower, context 77
# K1 and K3 are checked at every shape phase 3 times them: the served b32 and
# the trained b256 of ViT-B-16's towers and of EVA02-B-16's text tower
CHECKED = [VISION, TEXT, *(dict(s, b=TRAIN_BATCH) for s in (VISION, TEXT, TEXT77)), *EDGES]
# K10/K10b also where jax walks several key blocks: N = 577 pads to 640, five
# blocks of 128 (N = 257 in EDGES pads to 384, three)
FLASH_CHECKED = [*CHECKED, *(dict(b=4, n=577, nk=577, h=4, d=64, causal=c) for c in (False, True))]
# K2/K3r: EVA02-B-16's vision layers have ViT-B-16's N, H and D, and a CLS
# prefix row; the table is rope_cat_2d's where N - prefix is a square grid
ROPE_VISION = dict(VISION, prefix=1)
ROPE_EDGES = [
    dict(b=4, n=197, nk=197, h=4, d=64, causal=False, prefix=0),
    dict(b=4, n=1, nk=1, h=4, d=64, causal=False, prefix=1),
    dict(b=4, n=50, nk=50, h=4, d=64, causal=False, prefix=1),
    dict(b=4, n=257, nk=257, h=4, d=64, causal=False, prefix=1),
    dict(b=3, n=33, nk=33, h=2, d=32, causal=False, prefix=1),
    dict(b=4, n=50, nk=50, h=4, d=64, causal=True, prefix=1),
]
CAPTIONS = [
    "A brain MRI, plane axial, Scanner (Manufacturer, Model, Field Strength): (SIEMENS, "
    "Prisma, 3), Acquisition (Description, Sequence, Variant): (t1_mprage_tra, GR\\IR, "
    "SP\\MP), Imaging Parameters (Echo Time, Repetition Time, Inversion Time, Flip "
    "Angle): (2.26, 2300, 900, 8)",
    "A brain MRI, plane sagittal, Scanner (Manufacturer, Model, Field Strength): (GE "
    "MEDICAL SYSTEMS, Signa HDxt, 1.5), Acquisition (Description, Sequence, Variant): "
    "(Sag T2 FLAIR, SE\\IR, SK\\SP), Imaging Parameters (Echo Time, Repetition Time, "
    "Inversion Time, Flip Angle): (120, 9000, 2500, 90)",
    "A brain MRI, plane coronal, Scanner (Manufacturer, Model, Field Strength): "
    "(Philips, Achieva, 3), Acquisition (Description, Sequence, Variant): (T2W_TSE, SE, "
    "SK), Imaging Parameters (Echo Time, Repetition Time, Inversion Time, Flip Angle): "
    "(100, 4000, NONE, 90)",
    "A brain MRI, plane axial, Scanner (Manufacturer, Model, Field Strength): (SIEMENS, "
    "Skyra, 3), Acquisition (Description, Sequence, Variant): (ep2d_diff, EP, SK\\SP), "
    "Imaging Parameters (Echo Time, Repetition Time, Inversion Time, Flip Angle): "
    "(89, 5200, NONE, 90)",
]


def log(*a):
    print(*a, flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _pairs(n, nk, causal):
    return sum(min(i + 1, nk) for i in range(n)) if causal else n * nk


def attention_bound(b, n, nk, h, d, causal, dtype):
    """K1 (least ms, 'bytes'|'operations'): q, k, v read once, o and lse
    written once; 4*D operations per attended (query, key) pair."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * b * h * d * (2 * n + 2 * nk) + 4 * b * h * n
    return _bound(nbytes, 4 * b * h * _pairs(n, nk, causal) * d, dtype)


def attention_bwd_bound(b, n, nk, h, d, causal, dtype):
    """K3 and K5: q, o, dO read and dq written (N rows), k, v read and dk,
    dv written (Nk rows), once each, plus lse; 10*D operations per attended
    pair (the five products S, dV, dP, dQ, dK)."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * b * h * d * (4 * n + 4 * nk) + 4 * b * h * n
    return _bound(nbytes, 10 * b * h * _pairs(n, nk, causal) * d, dtype)


def rope_attention_bound(b, n, nk, h, d, causal, dtype, backward=False):
    """K2 (K3r with `backward`): K1's (K3's) bytes plus the [N, 2D] table read
    once; K1's (K3's) operations plus 6 per rotated element of q and k (K3r
    also un-rotates dq and dk: 4 tensors)."""
    item = torch.tensor([], dtype=dtype).element_size()
    tensors = (5 * n + 3 * nk) if backward else (2 * n + 2 * nk)
    nbytes = item * b * h * d * tensors + 4 * b * h * n + item * n * 2 * d
    ops = ((10 if backward else 4) * b * h * _pairs(n, nk, causal) * d
           + 6 * (4 if backward else 2) * b * n * h * d)
    return _bound(nbytes, ops, dtype)


def flash_bound(b, n, nk, h, d, causal, dtype, backward=False):
    """K10: q, k, v read and o, l, m written once; 4*D operations per
    attended pair. K10b (`backward`): q, k, v, dO, l, m, di read and dq, dk,
    dv written once; 10*D per attended pair."""
    item = torch.tensor([], dtype=dtype).element_size()
    if backward:
        nbytes = item * b * h * d * (3 * n + 4 * nk) + 12 * b * h * n
    else:
        nbytes = item * b * h * d * (2 * n + 2 * nk) + 8 * b * h * n
    return _bound(nbytes, (10 if backward else 4) * b * h * _pairs(n, nk, causal) * d, dtype)


def supcon_bound(kind, nq, nk, d):
    """K6 'stats': 2*Nq*Nk*D operations, q and k read, 4 row vectors written;
    K7 'grad_q'/'grad_k': 4*Nq*Nk*D (the logit tile and the gradient
    product), q, k, labels and 3 row vectors read, dq (+ds) or dk written."""
    if kind == "stats":
        nbytes, ops = 4 * (nq + nk) * d + 4 * (nq + nk) + 16 * nq, 2 * nq * nk * d
    else:
        out = nq * d + nq if kind == "grad_q" else nk * d
        nbytes, ops = 4 * (nq + nk) * d + 4 * (nq + nk) + 12 * nq + 4 * out, 4 * nq * nk * d
    return _bound(nbytes, ops, torch.float32)


def qkv_slices(shape, dtype, gen):
    """q, k, v as the column slices of one packed in_proj-like output."""
    b, n, nk, h, d = (shape[k] for k in ("b", "n", "nk", "h", "d"))
    hd = h * d
    x = torch.randn(b, n, 3 * hd, device="cuda", generator=gen).to(dtype)
    y = x if nk == n else torch.randn(b, nk, 3 * hd, device="cuda", generator=gen).to(dtype)
    return x[..., :hd], y[..., hd:2 * hd], y[..., 2 * hd:]


def phase_card():
    name = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {name} | {smi} | devices={torch.cuda.device_count()}")
    log(f"[card] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, smi


SOURCES = ("packed_attn_fwd", "packed_attn_bwd", "supcon_loss", "grouped_attn", "flash_attn")


def phase_build():
    from mrclip_tpu_torch.ops import build, flash_attn, fused_attn, pallas_loss

    t0 = time.perf_counter()
    build.load_libraries(SOURCES)  # one nvcc per source, all started together
    log(f"[build] {len(SOURCES)} sources built in {time.perf_counter() - t0:.2f} s wall")
    for name in SOURCES:
        info = build.build_info(name)
        log(f"[build] {name}.cu -> {info['path']} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")
    fused_attn.load_kernel()
    fused_attn.load_bwd_kernel()
    fused_attn.load_grouped_kernels()
    flash_attn.load_kernels()
    pallas_loss.load_kernels()


def phase_kernel_fwd():
    from mrclip_tpu_torch.ops import fused_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for shape in CHECKED:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv_slices(shape, dtype, gen)
            o, lse = fa.fused_attention_packed(q, k, v, is_causal=shape["causal"], heads=shape["h"])
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.fused_attention_packed_ref(
                q, k, v, is_causal=shape["causal"], heads=shape["h"])
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_l = (lse - lse_ref).abs().max().item()
            ok = (bool(torch.isfinite(o.float()).all()) and err_o <= O_TOL[dtype]
                  and err_l <= LSE_TOL)
            log(f"[kernel] {shape} {str(dtype)[6:]}: max|o-plain|={err_o:.3e} "
                f"(tol {O_TOL[dtype]}) max|lse-plain|={err_l:.3e} (tol {LSE_TOL}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"packed_attn_fwd disagrees with its plain version at {shape} {dtype}")
            worst[dtype] = max(worst[dtype], err_o)

    def timings(shape):
        q, k, v = qkv_slices(shape, torch.bfloat16, gen)
        h, causal = shape["h"], shape["causal"]
        q4, k4, v4 = (t.unflatten(-1, (h, shape["d"])).transpose(1, 2) for t in (q, k, v))
        ms = cuda_ms(lambda: fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h), 50)
        plain = cuda_ms(lambda: fa.fused_attention_packed_ref(q, k, v, is_causal=causal, heads=h), 20)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), 50)
        bound, by = attention_bound(**shape, dtype=torch.bfloat16)
        log(f"[kernel] bf16 {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"SDPA {lib:.4f} ms, bound {bound * 1e3:.2f} us ({by})")
        return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)

    vision, text = timings(VISION), timings(TEXT)
    serving_b256 = timings(dict(VISION, b=TRAIN_BATCH))
    text_b256 = timings(dict(TEXT, b=TRAIN_BATCH))
    text77_b256 = timings(dict(TEXT77, b=TRAIN_BATCH))
    return {
        "name": "packed_attn_fwd",
        "route": "cuda",
        "source": "mrclip_tpu_torch/csrc/packed_attn_fwd.cu",
        "replaces": "mrclip_tpu/ops/fused_attn.py:300",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_packed_fwd_kernel",
        "launches": None,  # filled in from the served run
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_fp32": worst[torch.float32],
        "shape": "vision b32 n197 h12 d64 bf16",
        **vision,
        "kernel_ms": vision["ms"],
        "bound_us": vision["bound_ms"] * 1e3,
        "text": text,
        "vision_b256": serving_b256,
        "text_b256": text_b256,
        "text77_b256": text77_b256,
    }


def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def rel_err(got, want, scale=None):
    """max |got - want| / scale (default max |want|), in fp32."""
    scale = want.float().abs().max().item() if scale is None else scale
    return abs_err(got, want) / max(scale, 1e-30)


def phase_kernel_bwd():
    """K3 against its plain version; q, k, v, o and dO as strided column
    slices, and dq/dk/dv written into the column slices of one buffer
    where N = Nk (as the train step hands them over)."""
    from mrclip_tpu_torch.ops import fused_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_abs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for shape in CHECKED:
        h, causal = shape["h"], shape["causal"]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv_slices(shape, dtype, gen)
            o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h)
            od = torch.empty(*o.shape[:2], 2 * o.shape[2], device="cuda", dtype=dtype)
            o_s, do_s = od.chunk(2, dim=-1)
            o_s.copy_(o)
            do_s.copy_(torch.randn(o.shape, device="cuda", generator=gen))
            out = None
            if shape["n"] == shape["nk"]:
                out = torch.empty(*o.shape[:2], 3 * o.shape[2], device="cuda", dtype=dtype).chunk(3, -1)
            got = fa.fused_attention_packed_bwd(q, k, v, o_s, do_s, lse, is_causal=causal,
                                                heads=h, out=out)
            torch.cuda.synchronize()
            want = fa.fused_attention_packed_bwd_ref(q, k, v, o_s, do_s, lse, is_causal=causal,
                                                     heads=h)
            scale = max(w.float().abs().max().item() for w in want)
            errs = [rel_err(g, w, scale) for g, w in zip(got, want)]
            ok = all(bool(torch.isfinite(g.float()).all()) for g in got) and max(errs) <= GRAD_TOL[dtype]
            log(f"[kernel] K3 {shape} {str(dtype)[6:]}: max|d-plain| / max|plain| (={scale:.3g}) "
                "dq/dk/dv = " + "/".join(f"{e:.3e}" for e in errs) + f" (tol {GRAD_TOL[dtype]}) "
                + ("ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError(f"packed_attn_bwd disagrees with its plain version at {shape} {dtype}")
            worst[dtype] = max(worst[dtype], *errs)
            worst_abs[dtype] = max(worst_abs[dtype], *(abs_err(g, w) for g, w in zip(got, want)))

    def timings(shape):
        q, k, v = qkv_slices(shape, torch.bfloat16, gen)
        h, causal = shape["h"], shape["causal"]
        o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
        buf = torch.empty(*o.shape[:2], 3 * o.shape[2], device="cuda", dtype=torch.bfloat16)
        out = buf.chunk(3, dim=-1)
        ms = cuda_ms(lambda: fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal,
                                                           heads=h, out=out), 20)
        plain = cuda_ms(lambda: fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse,
                                                                  is_causal=causal, heads=h), 5)
        q4, k4, v4 = (t.unflatten(-1, (h, shape["d"])).transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        do4 = do.unflatten(-1, (h, shape["d"])).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fwd = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=causal), 20)
        both = cuda_ms(lambda: torch.autograd.grad(sdpa(q4, k4, v4, is_causal=causal),
                                                   (q4, k4, v4), do4), 20)
        bound, by = attention_bwd_bound(**shape, dtype=torch.bfloat16)
        log(f"[kernel] K3 bf16 {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA backward "
            f"{both - fwd:.4f} ms (fwd+bwd {both:.4f} - fwd {fwd:.4f}), bound {bound * 1e3:.2f} us ({by})")
        return dict(ms=ms, plain_ms=plain, library_ms=both - fwd, bound_ms=bound, bound_by=by)

    vision = timings(dict(VISION, b=TRAIN_BATCH))
    text = timings(dict(TEXT, b=TRAIN_BATCH))
    text77 = timings(dict(TEXT77, b=TRAIN_BATCH))
    return {
        "name": "packed_attn_bwd",
        "route": "cuda",
        "source": "mrclip_tpu_torch/csrc/packed_attn_bwd.cu",
        "replaces": "mrclip_tpu/ops/fused_attn.py:382",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_packed_bwd_kernel",
        "launches": None,  # filled in from the train run
        "max_abs_err": worst_abs[torch.bfloat16],
        "max_abs_err_fp32": worst_abs[torch.float32],
        "max_rel_err": worst[torch.bfloat16],
        "max_rel_err_fp32": worst[torch.float32],
        "rel_err_is": "max |kernel - plain| / the call's largest max |plain| of dq, dk, dv",
        "shape": f"vision b{TRAIN_BATCH} n197 h12 d64 bf16",
        **vision,
        "library": "scaled_dot_product_attention backward (fwd+bwd minus fwd)",
        "text_b256": text,
        "text77_b256": text77,
    }


def rope_inputs(shape, dtype, gen):
    """q, k, v as strided column slices (`qkv_slices`), the raw [N - prefix,
    2D] sin||cos table (rope_cat_2d's where N - prefix is a square grid, as
    EVA02's 14 x 14, else uniform in [-1, 1]) and the kernel table built from
    it in `dtype`."""
    from mrclip_tpu_torch.ops import fused_attn as fa
    from mrclip_tpu_torch.ops.pos_embed import rope_cat_2d

    n, d, prefix = shape["n"], shape["d"], shape["prefix"]
    g = int(round((n - prefix) ** 0.5))
    if g * g == n - prefix and g:
        rope = rope_cat_2d(d, g, g, ref_feat_shape=(16, 16))
    else:
        rope = np.random.RandomState(n).uniform(-1, 1, (n - prefix, 2 * d)).astype(np.float32)
    q, k, v = qkv_slices(shape, dtype, gen)
    return q, k, v, rope, fa.rope_table(rope, prefix, dtype).cuda()


def phase_kernel_rope():
    """K2 and K3r against their plain versions: q, k, v, o and dO as strided
    column slices, dq/dk/dv into the column slices of one buffer; timings
    at EVA02-B-16's vision layer (b32 served, b256 trained) beside K1/K3 at
    the same shape (the cost of the rope) and SDPA on q and k rotated
    beforehand (labelled: not the same function)."""
    from mrclip_tpu_torch.models.layers import apply_rope_cat
    from mrclip_tpu_torch.ops import fused_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"fwd": {torch.bfloat16: 0.0, torch.float32: 0.0},
             "bwd": {torch.bfloat16: 0.0, torch.float32: 0.0}}
    worst_rel = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for shape in [ROPE_VISION, dict(ROPE_VISION, b=TRAIN_BATCH), *ROPE_EDGES]:
        h, causal = shape["h"], shape["causal"]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _, tab = rope_inputs(shape, dtype, gen)
            o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h, rope=tab)
            od = torch.empty(*o.shape[:2], 2 * o.shape[2], device="cuda", dtype=dtype)
            o_s, do_s = od.chunk(2, dim=-1)
            o_s.copy_(o)
            do_s.copy_(torch.randn(o.shape, device="cuda", generator=gen))
            out = torch.empty(*o.shape[:2], 3 * o.shape[2], device="cuda", dtype=dtype).chunk(3, -1)
            got = fa.fused_attention_packed_bwd(q, k, v, o_s, do_s, lse, is_causal=causal, heads=h,
                                                rope=tab, out=out)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.fused_attention_packed_ref(q, k, v, is_causal=causal, heads=h,
                                                           rope=tab)
            want = fa.fused_attention_packed_bwd_ref(q, k, v, o_s, do_s, lse, is_causal=causal,
                                                     heads=h, rope=tab)
            err_o, err_l = abs_err(o, o_ref), (lse - lse_ref).abs().max().item()
            scale = max(w.float().abs().max().item() for w in want)
            errs = [rel_err(g, w, scale) for g, w in zip(got, want)]
            ok = (bool(torch.isfinite(o.float()).all()) and err_o <= O_TOL[dtype]
                  and err_l <= LSE_TOL and all(bool(torch.isfinite(g.float()).all()) for g in got)
                  and max(errs) <= GRAD_TOL[dtype])
            log(f"[kernel] K2/K3r {shape} {str(dtype)[6:]}: max|o-plain|={err_o:.3e} (tol "
                f"{O_TOL[dtype]}) max|lse-plain|={err_l:.3e} (tol {LSE_TOL}); max|d-plain| / "
                f"max|plain| (={scale:.3g}) dq/dk/dv = " + "/".join(f"{e:.3e}" for e in errs)
                + f" (tol {GRAD_TOL[dtype]}) " + ("ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError(f"packed_attn_rope_fwd/bwd disagree with their plain versions "
                                     f"at {shape} {dtype}")
            worst["fwd"][dtype] = max(worst["fwd"][dtype], err_o)
            worst["bwd"][dtype] = max(worst["bwd"][dtype], *(abs_err(g, w) for g, w in zip(got, want)))
            worst_rel[dtype] = max(worst_rel[dtype], *errs)

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def timings(shape):
        q, k, v, rope, tab = rope_inputs(shape, torch.bfloat16, gen)
        h, d, causal = shape["h"], shape["d"], shape["causal"]
        o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h, rope=tab)
        o1, lse1 = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
        out = torch.empty(*o.shape[:2], 3 * o.shape[2], device="cuda",
                          dtype=torch.bfloat16).chunk(3, dim=-1)
        fwd = dict(
            ms=cuda_ms(lambda: fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h,
                                                         rope=tab), 50),
            k1_ms=cuda_ms(lambda: fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h), 50),
            plain_ms=cuda_ms(lambda: fa.fused_attention_packed_ref(q, k, v, is_causal=causal,
                                                                   heads=h, rope=tab), 20),
        )
        bwd = dict(
            ms=cuda_ms(lambda: fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal,
                                                             heads=h, rope=tab, out=out), 20),
            k3_ms=cuda_ms(lambda: fa.fused_attention_packed_bwd(q, k, v, o1, do, lse1,
                                                                is_causal=causal, heads=h, out=out), 20),
            plain_ms=cuda_ms(lambda: fa.fused_attention_packed_bwd_ref(
                q, k, v, o, do, lse, is_causal=causal, heads=h, rope=tab), 5),
        )
        # SDPA on q and k rotated beforehand: the rotation is not in its time
        tab32 = fa.rope_table(rope, shape["prefix"], torch.float32).cuda()
        rot = [apply_rope_cat(t.unflatten(-1, (h, d)), tab32).transpose(1, 2) for t in (q, k)]
        q4, k4 = (t.detach().requires_grad_() for t in rot)
        v4 = v.unflatten(-1, (h, d)).transpose(1, 2).detach().requires_grad_()
        do4 = do.unflatten(-1, (h, d)).transpose(1, 2)
        fwd["library_ms"] = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=causal), 50)
        both = cuda_ms(lambda: torch.autograd.grad(sdpa(q4, k4, v4, is_causal=causal),
                                                   (q4, k4, v4), do4), 20)
        bwd["library_ms"] = both - fwd["library_ms"]
        args = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        fwd["bound_ms"], fwd["bound_by"] = rope_attention_bound(**args, dtype=torch.bfloat16)
        bwd["bound_ms"], bwd["bound_by"] = rope_attention_bound(**args, dtype=torch.bfloat16,
                                                                backward=True)
        for name, t in (("K2", fwd), ("K3r", bwd)):
            base = "K1" if name == "K2" else "K3"
            log(f"[kernel] {name} bf16 {shape}: kernel {t['ms']:.4f} ms, {base} same shape "
                f"{t[base.lower() + '_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA on "
                f"pre-rotated q/k {t['library_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.2f} us "
                f"({t['bound_by']})")
        return fwd, bwd

    fwd32, bwd32 = timings(ROPE_VISION)
    fwd256, bwd256 = timings(dict(ROPE_VISION, b=TRAIN_BATCH))
    library = ("scaled_dot_product_attention on q and k rotated beforehand: the rotation "
               "is not in its time, so not the same function")
    common = dict(route="cuda", launches=None, shape=f"EVA02-B-16 vision b{TRAIN_BATCH} n197 "
                  "h12 d64 bf16, rope_cat_2d 14x14 table, CLS prefix")
    return [{
        "name": "packed_attn_rope_fwd",
        "source": "mrclip_tpu_torch/csrc/packed_attn_fwd.cu",
        "replaces": "mrclip_tpu/ops/fused_attn.py:330",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_packed_fwd_kernel, rope branch :330-343",
        "max_abs_err": worst["fwd"][torch.bfloat16],
        "max_abs_err_fp32": worst["fwd"][torch.float32],
        **common, **fwd256,
        "library": library + " (forward)",
        "vision_b32": fwd32,
    }, {
        "name": "packed_attn_rope_bwd",
        "source": "mrclip_tpu_torch/csrc/packed_attn_bwd.cu",
        "replaces": "mrclip_tpu/ops/fused_attn.py:418",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_packed_bwd_kernel, rope branch "
                      ":418-428, :464-473",
        "max_abs_err": worst["bwd"][torch.bfloat16],
        "max_abs_err_fp32": worst["bwd"][torch.float32],
        "max_rel_err": worst_rel[torch.bfloat16],
        "max_rel_err_fp32": worst_rel[torch.float32],
        "rel_err_is": "max |kernel - plain| / the call's largest max |plain| of dq, dk, dv",
        **common, **bwd256,
        "library": library + " (backward: fwd+bwd minus fwd)",
        "vision_b32": bwd32,
    }]


def check_attention(tag, shape, dtype, fwd, bwd):
    """Hold one forward (o, residual stats) and backward (dq, dk, dv) of a
    kernel pair against their plain versions with K1/K3's bars: o within
    O_TOL, each stat within LSE_TOL (abs for lse and m, relative for l), each
    gradient within GRAD_TOL of the call's largest |plain| gradient.
    `fwd` / `bwd` are (kernel outputs, plain outputs, stat kinds) and
    (kernel grads, plain grads). Returns (max |o - plain|, max |d - plain|,
    max relative gradient error)."""
    (o, stats), (o_ref, stats_ref), kinds = fwd
    got, want = bwd
    err_o = abs_err(o, o_ref)
    err_s = [rel_err(a, b, 1.0) if kind != "l" else ((a - b).abs() / b).max().item()
             for a, b, kind in zip(stats, stats_ref, kinds)]
    scale = max(w.float().abs().max().item() for w in want)
    errs = [rel_err(g, w, scale) for g, w in zip(got, want)]
    ok = (bool(torch.isfinite(o.float()).all()) and err_o <= O_TOL[dtype] and max(err_s) <= LSE_TOL
          and all(bool(torch.isfinite(g.float()).all()) for g in got)
          and max(errs) <= GRAD_TOL[dtype])
    log(f"[kernel] {tag} {shape} {str(dtype)[6:]}: max|o-plain|={err_o:.3e} (tol {O_TOL[dtype]}) "
        + " ".join(f"{k}={e:.3e}" for k, e in zip(kinds, err_s)) + f" (tol {LSE_TOL}); "
        f"max|d-plain| / max|plain| (={scale:.3g}) dq/dk/dv = "
        + "/".join(f"{e:.3e}" for e in errs) + f" (tol {GRAD_TOL[dtype]}) " + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"{tag} disagree with their plain versions at {shape} {dtype}")
    return err_o, max(abs_err(g, w) for g, w in zip(got, want)), max(errs)


def sdpa_ms(q4, k4, v4, do4, causal):
    """SDPA forward ms and backward ms (fwd+bwd minus fwd) on [B, H, L, D]
    views: a yardstick, never on a path."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.detach().requires_grad_() for t in (q4, k4, v4))
    fwd = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=causal), 50)
    both = cuda_ms(lambda: torch.autograd.grad(sdpa(q4, k4, v4, is_causal=causal),
                                               (q4, k4, v4), do4), 20)
    return fwd, both - fwd


def phase_kernel_grouped():
    """K4 and K5 against their plain versions on q, k, v as 'fused' hands
    them over (column slices of one projection, transposed to contiguous
    [B*H, L, D]); timings at phase 8's shapes beside K1 at the same shape."""
    from mrclip_tpu_torch.ops import fused_attn as fa

    def inputs(shape, dtype):
        h, d = shape["h"], shape["d"]
        return [fa.group_heads(t.unflatten(-1, (h, d))) for t in qkv_slices(shape, dtype, gen)]

    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {dt: [0.0, 0.0, 0.0] for dt in (torch.bfloat16, torch.float32)}
    for shape in CHECKED:
        causal = shape["causal"]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(shape, dtype)
            o, lse = fa.fused_attention_grouped(q, k, v, is_causal=causal)
            do = torch.randn(o.shape, device="cuda", generator=gen).to(dtype)
            got = fa.fused_attention_grouped_bwd(q, k, v, o, do, lse, is_causal=causal)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.fused_attention_ref(q, k, v, is_causal=causal)
            want = fa.fused_attention_bwd_ref(q, k, v, o, do, lse, is_causal=causal)
            errs = check_attention("K4/K5", shape, dtype, ((o, [lse]), (o_ref, [lse_ref]), ["lse"]),
                                   (got, want))
            worst[dtype] = [max(a, b) for a, b in zip(worst[dtype], errs)]

    def timings(shape):
        h, d, causal = shape["h"], shape["d"], shape["causal"]
        q, k, v = inputs(shape, torch.bfloat16)
        q1, k1, v1 = qkv_slices(shape, torch.bfloat16, gen)
        o, lse = fa.fused_attention_grouped(q, k, v, is_causal=causal)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
        fwd = dict(
            ms=cuda_ms(lambda: fa.fused_attention_grouped(q, k, v, is_causal=causal), 50),
            k1_ms=cuda_ms(lambda: fa.fused_attention_packed(q1, k1, v1, is_causal=causal, heads=h),
                          50),
            plain_ms=cuda_ms(lambda: fa.fused_attention_ref(q, k, v, is_causal=causal), 20))
        bwd = dict(
            ms=cuda_ms(lambda: fa.fused_attention_grouped_bwd(q, k, v, o, do, lse,
                                                              is_causal=causal), 20),
            plain_ms=cuda_ms(lambda: fa.fused_attention_bwd_ref(q, k, v, o, do, lse,
                                                                is_causal=causal), 5))
        b, n = shape["b"], shape["n"]
        fwd["library_ms"], bwd["library_ms"] = sdpa_ms(
            *(t.view(b, h, -1, d) for t in (q, k, v)), do.view(b, h, n, d), causal)
        args = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        fwd["bound_ms"], fwd["bound_by"] = attention_bound(**args, dtype=torch.bfloat16)
        bwd["bound_ms"], bwd["bound_by"] = attention_bwd_bound(**args, dtype=torch.bfloat16)
        log(f"[kernel] K4 bf16 {shape}: kernel {fwd['ms']:.4f} ms, K1 same shape "
            f"{fwd['k1_ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, SDPA {fwd['library_ms']:.4f} "
            f"ms, bound {fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']})")
        log(f"[kernel] K5 bf16 {shape}: kernel {bwd['ms']:.4f} ms, plain {bwd['plain_ms']:.4f} ms, "
            f"SDPA backward {bwd['library_ms']:.4f} ms, bound {bwd['bound_ms'] * 1e3:.2f} us "
            f"({bwd['bound_by']})")
        return fwd, bwd

    fwd256, bwd256 = timings(dict(VISION, b=TRAIN_BATCH))
    fwd_text, bwd_text = timings(dict(TEXT, b=TRAIN_BATCH))
    common = dict(route="cuda", source="mrclip_tpu_torch/csrc/grouped_attn.cu", launches=None,
                  shape=f"vision b{TRAIN_BATCH} n197 h12 d64 bf16, grouped [B*H, N, D]")
    return [{
        "name": "grouped_attn_fwd",
        "replaces": "mrclip_tpu/ops/fused_attn.py:101",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_fwd_kernel (via _run_fwd :167)",
        "max_abs_err": worst[torch.bfloat16][0], "max_abs_err_fp32": worst[torch.float32][0],
        **common, **fwd256,
        "library": "scaled_dot_product_attention forward",
        "text_b256": fwd_text,
    }, {
        "name": "grouped_attn_bwd",
        "replaces": "mrclip_tpu/ops/fused_attn.py:118",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_bwd_kernel (via _core_bwd :193)",
        "max_abs_err": worst[torch.bfloat16][1], "max_abs_err_fp32": worst[torch.float32][1],
        "max_rel_err": worst[torch.bfloat16][2], "max_rel_err_fp32": worst[torch.float32][2],
        "rel_err_is": "max |kernel - plain| / the call's largest max |plain| of dq, dk, dv",
        **common, **bwd256,
        "library": "scaled_dot_product_attention backward (fwd+bwd minus fwd)",
        "text_b256": bwd_text,
    }]


def phase_kernel_flash():
    """K10 and K10b against their plain versions on q, k, v as 'flash' hands
    them over ([B, L, H, D] views of one projection's column slices), also
    at N = 577 (five key blocks); timings at phase 9's shapes beside K4/K5
    at the same shape."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    def inputs(shape, dtype):
        return [t.unflatten(-1, (shape["h"], shape["d"])) for t in qkv_slices(shape, dtype, gen)]

    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {dt: [0.0, 0.0, 0.0] for dt in (torch.bfloat16, torch.float32)}
    for shape in FLASH_CHECKED:
        causal = shape["causal"]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(shape, dtype)
            o, l, m = fl.flash_attention(q, k, v, is_causal=causal)
            do = torch.randn(o.shape, device="cuda", generator=gen).to(dtype)
            di = fl.flash_di(o, do)
            got = fl.flash_attention_bwd(q, k, v, do, l, m, di, is_causal=causal)
            torch.cuda.synchronize()
            o_ref, l_ref, m_ref = fl.flash_attention_ref(q, k, v, is_causal=causal)
            want = fl.flash_attention_bwd_ref(q, k, v, do, l, m, di, is_causal=causal)
            errs = check_attention("K10/K10b", shape, dtype,
                                   ((o, [l, m]), (o_ref, [l_ref, m_ref]), ["l", "m"]), (got, want))
            worst[dtype] = [max(a, b) for a, b in zip(worst[dtype], errs)]

    def timings(shape):
        h, d, causal = shape["h"], shape["d"], shape["causal"]
        q, k, v = inputs(shape, torch.bfloat16)
        o, l, m = fl.flash_attention(q, k, v, is_causal=causal)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
        di = fl.flash_di(o, do)
        qg, kg, vg, dog = (fa.group_heads(t) for t in (q, k, v, do))
        og, lse = fa.fused_attention_grouped(qg, kg, vg, is_causal=causal)
        fwd = dict(
            ms=cuda_ms(lambda: fl.flash_attention(q, k, v, is_causal=causal), 50),
            k4_ms=cuda_ms(lambda: fa.fused_attention_grouped(qg, kg, vg, is_causal=causal), 50),
            plain_ms=cuda_ms(lambda: fl.flash_attention_ref(q, k, v, is_causal=causal), 10))
        bwd = dict(
            ms=cuda_ms(lambda: fl.flash_attention_bwd(q, k, v, do, l, m, di, is_causal=causal), 20),
            k5_ms=cuda_ms(lambda: fa.fused_attention_grouped_bwd(qg, kg, vg, og, dog, lse,
                                                                 is_causal=causal), 20),
            plain_ms=cuda_ms(lambda: fl.flash_attention_bwd_ref(q, k, v, do, l, m, di,
                                                                is_causal=causal), 5))
        fwd["library_ms"], bwd["library_ms"] = sdpa_ms(
            *(t.transpose(1, 2) for t in (q, k, v)), do.transpose(1, 2), causal)
        args = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        fwd["bound_ms"], fwd["bound_by"] = flash_bound(**args, dtype=torch.bfloat16)
        bwd["bound_ms"], bwd["bound_by"] = flash_bound(**args, dtype=torch.bfloat16, backward=True)
        log(f"[kernel] K10 bf16 {shape}: kernel {fwd['ms']:.4f} ms, K4 same shape "
            f"{fwd['k4_ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, SDPA {fwd['library_ms']:.4f} "
            f"ms, bound {fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']})")
        log(f"[kernel] K10b bf16 {shape}: kernel {bwd['ms']:.4f} ms, K5 same shape "
            f"{bwd['k5_ms']:.4f} ms, plain {bwd['plain_ms']:.4f} ms, SDPA backward "
            f"{bwd['library_ms']:.4f} ms, bound {bwd['bound_ms'] * 1e3:.2f} us ({bwd['bound_by']})")
        return fwd, bwd

    fwd256, bwd256 = timings(dict(VISION, b=TRAIN_BATCH))
    fwd_text, bwd_text = timings(dict(TEXT77, b=TRAIN_BATCH))
    fwd_577, bwd_577 = timings(dict(b=32, n=577, nk=577, h=12, d=64, causal=False))
    common = dict(route="cuda", source="mrclip_tpu_torch/csrc/flash_attn.cu", launches=None,
                  shape=f"EVA02-B-16 vision b{TRAIN_BATCH} n197 h12 d64 bf16 (one key block)")
    return [{
        "name": "flash_attn_fwd",
        "replaces": "mrclip_tpu/ops/flash_attn.py:41",
        "tpu_kernel": "mrclip_tpu/ops/flash_attn.py::flash_attention_unpadded -> jax "
                      "pallas/ops/tpu/flash_attention.py::_flash_attention_kernel_single_batch",
        "max_abs_err": worst[torch.bfloat16][0], "max_abs_err_fp32": worst[torch.float32][0],
        **common, **fwd256,
        "library": "scaled_dot_product_attention forward",
        "text77_b256": fwd_text, "n577_b32": fwd_577,
    }, {
        "name": "flash_attn_bwd",
        "replaces": "mrclip_tpu/ops/flash_attn.py:41",
        "tpu_kernel": "jax pallas/ops/tpu/flash_attention.py::_flash_attention_dkv_kernel, "
                      "_flash_attention_dq_kernel (via _flash_attention_bwd)",
        "max_abs_err": worst[torch.bfloat16][1], "max_abs_err_fp32": worst[torch.float32][1],
        "max_rel_err": worst[torch.bfloat16][2], "max_rel_err_fp32": worst[torch.float32][2],
        "rel_err_is": "max |kernel - plain| / the call's largest max |plain| of dq, dk, dv",
        **common, **bwd256,
        "library": "scaled_dot_product_attention backward (fwd+bwd minus fwd)",
        "text77_b256": bwd_text, "n577_b32": bwd_577,
    }]


def supcon_inputs(n, classes, gen):
    q = torch.nn.functional.normalize(torch.randn(n, EMBED, device="cuda", generator=gen), dim=-1)
    k = torch.nn.functional.normalize(torch.randn(n, EMBED, device="cuda", generator=gen), dim=-1)
    labels = (torch.arange(n, device="cuda") if classes is None else
              torch.randint(0, classes, (n,), device="cuda", generator=gen)).to(torch.int32)
    scale = torch.tensor([1 / 0.07], device="cuda")
    gbar = torch.tensor([0.5 / n], device="cuda")
    return q, k, labels, scale, gbar


def phase_kernel_supcon():
    """K6 and K7 against their plain versions in fp32; timings at B = 256
    (the train step) and 8192."""
    from mrclip_tpu_torch.ops import pallas_loss as pl

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"supcon_stats": 0.0, "supcon_grad_q": 0.0, "supcon_grad_k": 0.0}
    worst_abs = dict(worst)
    for n, classes in SUPCON_CASES:
        q, k, labels, scale, gbar = supcon_inputs(n, classes, gen)
        stats = pl.supcon_stats(q, k, labels, labels, scale)
        want = pl.supcon_stats_ref(q, k, labels, labels, scale)
        m, s, _, cnt = want
        cnt = cnt.clamp(min=1.0)
        dq, ds_rows = pl.supcon_grad_q(q, k, labels, labels, scale, m, s, cnt, gbar)
        dk = pl.supcon_grad_k(q, k, labels, labels, scale, m, s, cnt, gbar)
        torch.cuda.synchronize()
        want_dq, want_ds = pl.supcon_grad_q_ref(q, k, labels, labels, scale, m, s, cnt, gbar)
        want_dk = pl.supcon_grad_k_ref(q, k, labels, labels, scale, m, s, cnt, gbar)
        errs = {
            "supcon_stats": max(rel_err(g, w) for g, w in zip(stats, want)),
            "supcon_grad_q": max(rel_err(dq, want_dq), rel_err(ds_rows, want_ds)),
            "supcon_grad_k": rel_err(dk, want_dk),
        }
        ok = max(errs.values()) <= SUPCON_TOL
        log(f"[kernel] K6/K7 B={n} D={EMBED} labels={classes or 'distinct'} fp32: "
            + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items()) + f" (tol {SUPCON_TOL}) "
            + ("ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError(f"supcon kernels disagree with their plain versions at B={n}")
        abs_errs = {
            "supcon_stats": max(abs_err(g, w) for g, w in zip(stats, want)),
            "supcon_grad_q": max(abs_err(dq, want_dq), abs_err(ds_rows, want_ds)),
            "supcon_grad_k": abs_err(dk, want_dk),
        }
        for name, e in errs.items():
            worst[name] = max(worst[name], e)
            worst_abs[name] = max(worst_abs[name], abs_errs[name])

    def timings(n):
        q, k, labels, scale, gbar = supcon_inputs(n, 32, gen)
        m, s, _, cnt = pl.supcon_stats_ref(q, k, labels, labels, scale)
        cnt = cnt.clamp(min=1.0)
        calls = {
            "supcon_stats": (lambda: pl.supcon_stats(q, k, labels, labels, scale),
                             lambda: pl.supcon_stats_ref(q, k, labels, labels, scale), "stats"),
            "supcon_grad_q": (lambda: pl.supcon_grad_q(q, k, labels, labels, scale, m, s, cnt, gbar),
                              lambda: pl.supcon_grad_q_ref(q, k, labels, labels, scale, m, s, cnt,
                                                           gbar), "grad_q"),
            "supcon_grad_k": (lambda: pl.supcon_grad_k(q, k, labels, labels, scale, m, s, cnt, gbar),
                              lambda: pl.supcon_grad_k_ref(q, k, labels, labels, scale, m, s, cnt,
                                                           gbar), "grad_k"),
        }
        out = {}
        for name, (kernel, plain, kind) in calls.items():
            ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 10)
            bound, by = supcon_bound(kind, n, n, EMBED)
            log(f"[kernel] {name} fp32 B={n} D={EMBED}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound * 1e3:.2f} us ({by})")
            out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        return out

    b256, b8192 = timings(TRAIN_BATCH), timings(8192)
    tpu = {"supcon_stats": ":37 (_fwd_kernel, via _stats :155)",
           "supcon_grad_q": ":76 (_grad_q_kernel, via _bwd :229)",
           "supcon_grad_k": ":106 (_grad_k_kernel, via _bwd :229)"}
    return [{
        "name": name,
        "route": "cuda",
        "source": "mrclip_tpu_torch/csrc/supcon_loss.cu",
        "replaces": "mrclip_tpu/ops/pallas_loss.py" + tpu[name].split(" ")[0],
        "tpu_kernel": "mrclip_tpu/ops/pallas_loss.py" + tpu[name],
        "launches": None,  # filled in from the train run
        "max_abs_err": worst_abs[name],
        "max_rel_err": worst[name],
        "rel_err_is": "max |kernel - plain| / max |plain| per output, fp32",
        "shape": f"B{TRAIN_BATCH} D{EMBED} fp32",
        **b256[name],
        "library_ms": None,
        "library": "none: no single PyTorch call computes the SupCon row statistics or their gradients",
        "b8192": b8192[name],
    } for name in worst]


def post(base, path, payload):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def unit_rows(feats, n, dim):
    f = np.asarray(feats, np.float64)
    if f.shape != (n, dim) or not np.isfinite(f).all():
        raise AssertionError(f"features of shape {f.shape} (want {(n, dim)}) or not finite")
    norms = np.linalg.norm(f, axis=1)
    if np.abs(norms - 1).max() > 1e-2:
        raise AssertionError(f"features not unit-norm: {norms}")
    return f


def cosine_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def phase_serve(kernel_entry, card):
    from mrclip_tpu_torch import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD, SimpleTokenizer
    from mrclip_tpu_torch.factory import create_model
    from mrclip_tpu_torch.ops import fused_attn as fa
    from mrclip_tpu_torch.serve import make_server
    from mrclip_tpu_torch.serving import export_model, load_exported, save_exported

    t0 = time.perf_counter()
    model = create_model("ViT-B-16", precision="bf16", attn_impl="fusedp", rng_seed=0)
    exported = export_model(model)
    del model
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "vit_b_16.mrclip")
    save_exported(exported, path)
    served = load_exported(path)
    plain = create_model("ViT-B-16", pretrained=exported.state_dict, precision="bf16",
                         attn_impl="xla")
    server = make_server(path, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    log(f"[serve] ViT-B-16 built, exported ({os.path.getsize(path) / 1e6:.1f} MB), "
        f"loaded and serving at {base} in {time.perf_counter() - t0:.1f} s")
    embed = served.meta["model_cfg"]["embed_dim"]
    rng = np.random.RandomState(0)
    mean, std = np.asarray(OPENAI_DATASET_MEAN), np.asarray(OPENAI_DATASET_STD)
    # 4 decimals keep each 224x224 image near 1 MB of JSON
    images = np.round((rng.rand(8, 224, 224, 3) - mean) / std, 4).astype(np.float32)
    texts = [CAPTIONS[i % 4] for i in range(8)]
    try:
        fa.reset_launches()  # the served main path starts here
        health = json.loads(urllib.request.urlopen(base + "/health", timeout=60).read())
        if health.get("ok") is not True or health["meta"]["attn_impl"] != "fusedp":
            raise AssertionError(f"bad /health answer: {health}")
        with ThreadPoolExecutor(8) as pool:
            img_futs = [pool.submit(post, base, "/encode_image", {"images": images[2 * i:2 * i + 2].tolist()})
                        for i in range(4)]
            txt_futs = [pool.submit(post, base, "/encode_text", {"texts": texts[2 * i:2 * i + 2]})
                        for i in range(4)]
            img_feats = np.concatenate([unit_rows(f.result()["features"], 2, embed) for f in img_futs])
            txt_feats = np.concatenate([unit_rows(f.result()["features"], 2, embed) for f in txt_futs])
        score = post(base, "/score", {"images": images[:1].tolist(), "texts": texts[:2]})["logits"]
        main_path_launches = fa.launches  # read right after the served run
    finally:
        server.shutdown()
        server.server_close()
    want = served.meta["logit_scale"] * img_feats[:1] @ txt_feats[:2].T
    if np.asarray(score).shape != (1, 2) or np.abs(np.asarray(score) - want).max() > 0.5:
        raise AssertionError(f"/score {score} vs features {want}")
    if main_path_launches == 0 or main_path_launches % 12:
        raise AssertionError(f"{main_path_launches} kernel launches on the served path "
                             "(want a positive multiple of 12 layers)")
    log(f"[serve] /health ok; 4x2 images, 4x2 captions and 1 score answered; "
        f"packed_attn_fwd launched {main_path_launches} times")

    # one direct call per tower: one launch per attention layer
    per_pair = 0
    for enc, arg in ((served.encode_image, images[:2]), (served.encode_text, SimpleTokenizer()(texts[:2]))):
        before = fa.launches
        enc(arg)
        if fa.launches - before != 12:
            raise AssertionError(f"{enc.__name__}: {fa.launches - before} launches, want 12")
        per_pair += fa.launches - before
    log(f"[serve] launch counter: +12 per tower call, {per_pair} per image+text pair")

    with torch.inference_mode():
        ref_img = plain.encode_image(torch.from_numpy(images).cuda(), normalize=True).float().cpu().numpy()
        tok = torch.from_numpy(SimpleTokenizer()(texts)).cuda()
        ref_txt = plain.encode_text(tok, normalize=True).float().cpu().numpy()
    cos_img, cos_txt = cosine_rows(img_feats, ref_img).min(), cosine_rows(txt_feats, ref_txt).min()
    log(f"[serve] served (kernel) vs plain attention, same weights: min cosine "
        f"image {cos_img:.6f}, text {cos_txt:.6f}")
    if min(cos_img, cos_txt) < 0.999:
        raise AssertionError("served features disagree with the plain-attention model")

    # throughput through ServedModel (numpy in, numpy out) and on the device
    perf = {}
    for bsz in (32, 256):
        batch = np.ascontiguousarray(np.resize(images, (bsz, 224, 224, 3)))
        served.encode_image(batch)
        t = time.perf_counter()
        iters = 5
        for _ in range(iters):
            served.encode_image(batch)
        perf[f"served_encode_image_b{bsz}_imgs_per_s"] = bsz * iters / (time.perf_counter() - t)
    tokens = np.resize(SimpleTokenizer()(texts), (256, 98))
    served.encode_text(tokens)
    t = time.perf_counter()
    for _ in range(5):
        served.encode_text(tokens)
    perf["served_encode_text_b256_texts_per_s"] = 256 * 5 / (time.perf_counter() - t)
    x256 = torch.from_numpy(np.resize(images, (256, 224, 224, 3))).cuda()
    with torch.inference_mode():
        for name, m in (("fusedp", served.model), ("xla", plain)):
            ms = cuda_ms(lambda: m.encode_image(x256, normalize=True), 5, warmup=1)
            perf[f"device_encode_image_b256_ms_{name}"] = ms
    share = 12 * kernel_entry["vision_b256"]["ms"] / perf["device_encode_image_b256_ms_fusedp"]
    perf["attention_kernel_share_b256"] = share
    log(f"[serve] throughput on {card}: " + json.dumps(perf))
    tmp.cleanup()
    return {"packed_attn_fwd": main_path_launches}, per_pair, perf


def launch_counts():
    """Every kernel's launches since the last reset, by kernel name."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa
    from mrclip_tpu_torch.ops import pallas_loss as pl

    return {"packed_attn_fwd": fa.launches, "packed_attn_bwd": fa.bwd_launches,
            "packed_attn_rope_fwd": fa.rope_launches,
            "packed_attn_rope_bwd": fa.rope_bwd_launches,
            "grouped_attn_fwd": fa.grouped_launches, "grouped_attn_bwd": fa.grouped_bwd_launches,
            "flash_attn_fwd": fl.launches, "flash_attn_bwd": fl.bwd_launches, **pl.launches}


def reset_counts():
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa
    from mrclip_tpu_torch.ops import pallas_loss as pl

    fa.reset_launches()
    fl.reset_launches()
    pl.reset_launches()


def phase_serve_eva02(entries, card):
    """EVA02-B-16 through the serving entry points: export, load, encode."""
    from mrclip_tpu_torch import SimpleTokenizer
    from mrclip_tpu_torch.factory import create_model
    from mrclip_tpu_torch.serving import export_model, load_exported, save_exported

    t0 = time.perf_counter()
    model = create_model("EVA02-B-16", precision="bf16", attn_impl="fusedp", rng_seed=0)
    exported = export_model(model)
    del model
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "eva02_b_16.mrclip")
    save_exported(exported, path)
    served = load_exported(path)
    plain = create_model("EVA02-B-16", pretrained=exported.state_dict, precision="bf16",
                         attn_impl="xla")
    embed, ctx = served.meta["model_cfg"]["embed_dim"], served.meta["context_length"]
    log(f"[serve-eva02] EVA02-B-16 built, exported ({os.path.getsize(path) / 1e6:.1f} MB) and "
        f"loaded in {time.perf_counter() - t0:.1f} s; context {ctx}")
    rng = np.random.RandomState(1)
    images = rng.randn(TRAIN_BATCH, 224, 224, 3).astype(np.float32)
    tokens = np.resize(SimpleTokenizer(context_length=ctx)(CAPTIONS), (TRAIN_BATCH, ctx))

    reset_counts()  # the EVA02 served main path starts here
    calls, feats = [], {}
    for key, enc, arg in (("image_b32", served.encode_image, images[:32]),
                          ("image_b256", served.encode_image, images),
                          ("text_b256", served.encode_text, tokens)):
        before = launch_counts()
        feats[key] = unit_rows(enc(arg), len(arg), embed)
        calls.append({k: v - before[k] for k, v in launch_counts().items() if v != before[k]})
    main_path = launch_counts()  # read right after the served run
    want = [{"packed_attn_rope_fwd": 12}, {"packed_attn_rope_fwd": 12}, {"packed_attn_fwd": 12}]
    log(f"[serve-eva02] launches per call (image b32, image b256, text b256): {calls} "
        f"(want {want}) {'ok' if calls == want else 'FAIL'}")
    if calls != want:
        raise AssertionError("the EVA02 served path did not launch K2 12 times per image call "
                             "and K1 12 times per text call")

    with torch.inference_mode():
        ref_img = plain.encode_image(torch.from_numpy(images[:32]).cuda(), normalize=True)
        ref_txt = plain.encode_text(torch.from_numpy(tokens).cuda(), normalize=True)
    cos_img = cosine_rows(feats["image_b32"], ref_img.float().cpu().numpy()).min()
    cos_256 = cosine_rows(feats["image_b256"][:32], feats["image_b32"]).min()
    cos_txt = cosine_rows(feats["text_b256"], ref_txt.float().cpu().numpy()).min()
    ok = min(cos_img, cos_txt) >= 0.999 and cos_256 >= 0.999
    log(f"[serve-eva02] served (kernel) vs plain attention, same weights: min cosine image "
        f"{cos_img:.6f}, text {cos_txt:.6f}; image b256 vs b32 rows {cos_256:.6f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("EVA02 served features disagree with the plain-attention model")

    perf = {}
    for bsz in (32, 256):
        t = time.perf_counter()
        for _ in range(5):
            served.encode_image(images[:bsz])
        perf[f"served_encode_image_b{bsz}_imgs_per_s"] = bsz * 5 / (time.perf_counter() - t)
    t = time.perf_counter()
    for _ in range(5):
        served.encode_text(tokens)
    perf["served_encode_text_b256_texts_per_s"] = TRAIN_BATCH * 5 / (time.perf_counter() - t)
    x256 = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        for name, m in (("fusedp", served.model), ("xla", plain)):
            perf[f"device_encode_image_b256_ms_{name}"] = cuda_ms(
                lambda: m.encode_image(x256, normalize=True), 5, warmup=1)
    perf["k2_share_b256"] = (12 * entries["packed_attn_rope_fwd"]["ms"]
                             / perf["device_encode_image_b256_ms_fusedp"])
    log(f"[serve-eva02] throughput on {card}: " + json.dumps(perf))
    tmp.cleanup()
    return main_path, perf


def grad_cosines(a: dict, b: dict):
    """(cosine of the whole flattened gradients, min cosine over tensors of
    10**4 or more elements, that tensor's name), in float64."""
    dot = na = nb = 0.0
    worst, worst_name = 1.0, None
    for name, ga in a.items():
        x, y = ga.double().flatten(), b[name].double().flatten()
        d, nx, ny = (x @ y).item(), (x @ x).item(), (y @ y).item()
        dot, na, nb = dot + d, na + nx, nb + ny
        if x.numel() >= 10**4:
            cos = d / max(np.sqrt(nx * ny), 1e-300)
            if cos < worst:
                worst, worst_name = cos, name
    return dot / np.sqrt(na * nb), worst, worst_name


# Device kernels by (lower-cased) name -> the layer they belong to (first
# match wins). The rope instantiations of the packed attention kernels and
# the flash instantiations of the row kernels carry the template flag `true`
# in their names.
KERNEL_GROUPS = [
    ("K10 flash_attn_fwd", ("rows_fwd_kernel<__nv_bfloat16, 64, true>",)),
    ("K4 grouped_attn_fwd", ("rows_fwd_kernel",)),
    ("K10b flash_attn_bwd", ("rows_bwd_dq_kernel<__nv_bfloat16, 64, true>",
                             "rows_bwd_dkv_kernel<__nv_bfloat16, 64, true>")),
    ("K5 grouped_attn_bwd", ("rows_bwd_",)),
    ("K2 packed_attn_rope_fwd", ("packed_attn_fwd_kernel<__nv_bfloat16, 64, true>",)),
    ("K1 packed_attn_fwd", ("packed_attn_fwd",)),
    ("K3r packed_attn_rope_bwd", ("_kernel<__nv_bfloat16, 64, true>",)),
    ("K3 packed_attn_bwd", ("attn_bwd_dq", "attn_bwd_dkv")),
    ("K6/K7 supcon", ("supcon_",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("other (elementwise, norms, reductions, copies)", ("",)),
]


def profile_step(run, tag="[train]"):
    """Device time of one step by kernel group, from torch.profiler (CUPTI),
    and the device's idle share of the profiled wall time (profiling slows
    the host, so that share is an upper bound). {} if no device time was
    recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        kernels.append((ms, ev.count, ev.key))
        low = ev.key.lower()
        groups[next(g for g, keys in KERNEL_GROUPS if any(k in low for k in keys))] += ms
    busy = sum(groups.values())
    if busy == 0:
        log(f"{tag} profiler recorded no device time: breakdown by kernel not measured")
        return {}
    log(f"{tag} profiled step: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}; by group (ms): "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in groups.items()))
    for ms, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"{tag}   {ms:9.3f} ms  x{count:<5d} {key[:110]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "groups_ms": groups}


# The train main path of each (model, attn_impl): the attention kernels'
# exact launches per dense step (one per attention layer per direction;
# 'flash' launches K10 again in the backward) and which parameters are the
# attention's input projections.
VIT_PROJ = ("attn.in_proj_weight",)
EVA_PROJ = ("attn.q_proj.weight", "attn.k_proj.weight", "attn.v_proj.weight")
TRAIN_PATHS = {
    ("ViT-B-16", "fusedp"): dict(per_step={"packed_attn_fwd": 24, "packed_attn_bwd": 24},
                                 projections=VIT_PROJ),
    ("EVA02-B-16", "fusedp"): dict(per_step={"packed_attn_rope_fwd": 12, "packed_attn_fwd": 12,
                                             "packed_attn_rope_bwd": 12, "packed_attn_bwd": 12},
                                   projections=EVA_PROJ),
    ("ViT-B-16", "fused"): dict(per_step={"grouped_attn_fwd": 24, "grouped_attn_bwd": 24},
                                projections=VIT_PROJ),
    ("EVA02-B-16", "flash"): dict(per_step={"flash_attn_fwd": 48, "flash_attn_bwd": 24},
                                  projections=EVA_PROJ),
}
PALLAS_STEP = {"supcon_stats": 2, "supcon_grad_q": 2, "supcon_grad_k": 2}


def kernel_ms_per_step(model_name, attn_impl, entries):
    """Each attention kernel's device ms in one step of `model_name` under
    `attn_impl` at b256, from the phase 3 timings at the step's shapes."""
    fwd, bwd = entries["packed_attn_fwd"], entries["packed_attn_bwd"]
    if attn_impl == "fused":  # ViT-B-16
        k4, k5 = entries["grouped_attn_fwd"], entries["grouped_attn_bwd"]
        return {"K4": 12 * (k4["ms"] + k4["text_b256"]["ms"]),
                "K5": 12 * (k5["ms"] + k5["text_b256"]["ms"])}
    if attn_impl == "flash":  # EVA02-B-16: K10 twice per layer (forward, recomputed)
        k10, k10b = entries["flash_attn_fwd"], entries["flash_attn_bwd"]
        return {"K10": 24 * (k10["ms"] + k10["text77_b256"]["ms"]),
                "K10b": 12 * (k10b["ms"] + k10b["text77_b256"]["ms"])}
    if model_name == "ViT-B-16":
        return {"K1": 12 * (fwd["vision_b256"]["ms"] + fwd["text_b256"]["ms"]),
                "K3": 12 * (bwd["ms"] + bwd["text_b256"]["ms"])}
    return {"K2": 12 * entries["packed_attn_rope_fwd"]["ms"], "K1": 12 * fwd["text77_b256"]["ms"],
            "K3r": 12 * entries["packed_attn_rope_bwd"]["ms"], "K3": 12 * bwd["text77_b256"]["ms"]}


def phase_train(model_name, entries, card, attn_impl="fusedp", timed=5, pallas_step=True):
    """The train step of the JAX package's bench.py on `model_name` at b256
    under `attn_impl`: checks at the initial weights, then one warm-up and
    `timed` dense steps (and, with `pallas_step`, the pallas loss against
    the dense one and one pallas-loss step)."""
    from types import SimpleNamespace

    from mrclip_tpu_torch import create_loss
    from mrclip_tpu_torch.factory import create_model
    from mrclip_tpu_torch.ops import pallas_loss as pl
    from mrclip_tpu_torch.ops.image_ops import normalize_images
    from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                           make_loss_apply)
    from mrclip_tpu_torch.parallel.train_step import loss_and_grads

    tag = ("[train]" if model_name == "ViT-B-16" else "[train-eva02]")
    if attn_impl != "fusedp":
        tag = f"[train-{attn_impl}]"
    spec = TRAIN_PATHS[model_name, attn_impl]
    t0 = time.perf_counter()
    model = create_model(model_name, precision="bf16", attn_impl=attn_impl, gelu_approx=True,
                         rng_seed=0)
    tx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = create_train_state(model, tx)
    args = dict(multipositiveloss=True, delta=0.5, model=model_name, gather_with_grad=True)
    dense = make_loss_apply(create_loss(SimpleNamespace(**args, pallas_loss=False)))
    pallas = make_loss_apply(create_loss(SimpleNamespace(**args, pallas_loss=True)))
    rng = np.random.RandomState(0)
    ctx = model.context_length
    batch = {  # uint8 canvases as the loader ships them; normalised inside the step
        "images": torch.from_numpy(rng.randint(0, 256, (TRAIN_BATCH, 224, 224, 3)).astype(np.uint8)).cuda(),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (TRAIN_BATCH, ctx)).astype(np.int64)).cuda(),
        "labels": torch.from_numpy(rng.randint(0, 32, (TRAIN_BATCH,)).astype(np.int32)).cuda(),
    }

    def prep(b):
        return dict(b, images=normalize_images(b["images"]))

    n_params = sum(p.numel() for p in state.params.values())
    log(f"{tag} {model_name} ({n_params / 1e6:.1f} M params), attn_impl={attn_impl!r}, AdamW "
        f"bf16 mu, batch {TRAIN_BATCH}, context {ctx}, built in {time.perf_counter() - t0:.1f} s")

    # checks at the initial weights (their launches are not the main path's)
    g_kernel, l_kernel = loss_and_grads(model, dense, state.params, prep(batch))
    plain = create_model(model_name, pretrained={k: v.detach().cpu() for k, v in model.state_dict().items()},
                         precision="bf16", attn_impl="xla", gelu_approx=True)
    g_plain, l_plain = loss_and_grads(plain, dense, dict(plain.named_parameters()), prep(batch))
    del plain
    lk, lp = l_kernel["loss"].item(), l_plain["loss"].item()
    whole, worst, worst_name = grad_cosines(g_kernel, g_plain)
    del g_plain
    torch.cuda.empty_cache()
    proj = [n for n in g_kernel if n.endswith(spec["projections"])]
    dead = [n for n in proj if g_kernel[n].abs().max().item() == 0]
    ok = (np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp) and whole >= 0.999 and worst >= 0.99
          and proj and not dead)
    log(f"{tag} kernel vs plain attention, same weights and batch: loss {lk:.6f} vs {lp:.6f} "
        f"(rel {abs(lk - lp) / abs(lp):.2e}, tol 1e-2); gradient cosine whole {whole:.6f} "
        f"(>= 0.999), min per tensor >= 1e4 elements {worst:.6f} at {worst_name} (>= 0.99, "
        f"bf16 through 12 layers); {len(proj) - len(dead)}/{len(proj)} attention projection "
        f"weights ({', '.join(spec['projections'])}) with a gradient {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the kernel train step's gradients disagree with plain attention")

    if pallas_step:
        pl.reset_launches()
        g_pallas, l_pallas = loss_and_grads(model, pallas, state.params, prep(batch))
        torch.cuda.synchronize()
        lpl = l_pallas["loss"].item()
        whole_p, worst_p, _ = grad_cosines(g_pallas, g_kernel)
        counts = dict(pl.launches)
        ok = (abs(lpl - lk) <= 1e-4 * abs(lk) and whole_p >= 0.9999
              and all(c == 2 for c in counts.values()))
        log(f"{tag} pallas vs dense loss, same state: loss {lpl:.7f} vs {lk:.7f} (rel "
            f"{abs(lpl - lk) / abs(lk):.2e}, tol 1e-4); gradient cosine {whole_p:.7f} (>= 0.9999); "
            f"launches {counts} (2 each) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the pallas loss step disagrees with the dense one")
        del g_pallas
    del g_kernel
    torch.cuda.empty_cache()

    # the main path: warm-up, `timed` dense steps (and one pallas-loss step);
    # each step launches exactly the listed kernels, no other
    dense_step = build_train_step(model, dense, tx)
    losses, per_step, wants = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    def one(step_fn, want):
        nonlocal state
        before = launch_counts()
        state, metrics = step_fn(state, prep(batch))
        per_step.append({k: v - before[k] for k, v in launch_counts().items() if v != before[k]})
        wants.append(want)
        losses.append(metrics["loss"])
        return metrics

    one(dense_step, spec["per_step"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed):
        one(dense_step, spec["per_step"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / timed * 1e3
    if pallas_step:
        one(build_train_step(model, pallas, tx), {**spec["per_step"], **PALLAS_STEP})
    torch.cuda.synchronize()
    launches = launch_counts()  # read right after the train run
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    n_steps = 1 + timed + int(pallas_step)
    ok = all(np.isfinite(losses)) and per_step == wants and state.step == n_steps
    log(f"{tag} main path: {n_steps} steps (1 warm-up, {timed} timed"
        + (", 1 pallas loss" if pallas_step else "") + "), losses "
        + ", ".join(f"{x:.5f}" for x in losses) + f"; launches per step {per_step} (want "
        f"{wants}); launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {model_name} {attn_impl} train main path failed its checks")

    # where the step's time goes: the kernels from phase 3, the rest measured here
    kernel_ms = kernel_ms_per_step(model_name, attn_impl, entries)
    with torch.no_grad():
        out = model(prep(batch)["images"], batch["tokens"])
    feats = {k: (v.detach().requires_grad_() if k.endswith("features") else v.detach())
             for k, v in out.items()}

    def loss_fwd_bwd(apply):
        ld = apply(feats, batch)
        return torch.autograd.grad(ld["loss"], [feats["image_features"], feats["text_features"]])

    dense_ms = cuda_ms(lambda: loss_fwd_bwd(dense), 10)
    pallas_ms = cuda_ms(lambda: loss_fwd_bwd(pallas), 10)
    norm_ms = cuda_ms(lambda: normalize_images(batch["images"]), 10)
    grads, _ = loss_and_grads(model, dense, state.params, prep(batch))
    opt_ms = cuda_ms(lambda: tx.update(grads, state.opt_state, state.params), 3, warmup=1)
    del grads
    rest = step_ms - sum(kernel_ms.values()) - dense_ms - norm_ms - opt_ms
    profile = profile_step(lambda: dense_step(state, prep(batch)), tag)
    perf = {
        "train_step_ms": step_ms,
        "train_pairs_per_s": TRAIN_BATCH / step_ms * 1e3,
        "peak_memory_gb": peak_gb,
        **{f"{k.lower()}_ms_per_step": v for k, v in kernel_ms.items()},
        **{f"{k.lower()}_share": v / step_ms for k, v in kernel_ms.items()},
        "dense_loss_fwd_bwd_ms": dense_ms, "pallas_loss_fwd_bwd_ms": pallas_ms,
        "normalize_ms": norm_ms, "optimizer_ms": opt_ms,
        "rest_gemm_elementwise_ms": rest,
        "profiled_step": profile,
    }
    log(f"{tag} {model_name} b{TRAIN_BATCH} step {step_ms:.2f} ms, "
        f"{perf['train_pairs_per_s']:.1f} pairs/s, peak memory {peak_gb:.2f} GB, "
        + ", ".join(f"{k} {100 * v / step_ms:.1f}%" for k, v in kernel_ms.items())
        + f" of the step | {card}")
    log(f"{tag} breakdown: " + json.dumps(perf))
    per_step_launches = {**spec["per_step"], **(PALLAS_STEP if pallas_step else {})}
    del model, state
    torch.cuda.empty_cache()
    return launches, per_step_launches, perf


def phase_encode(model_name, attn_impl, kernel, card, exported):
    """`encode_image` at b256 of full-width `model_name` under `attn_impl`
    (random weights from seed 0, bf16): through `ServedModel` from an
    exported artifact when `exported`, else on the model under
    `inference_mode`. Each call launches `kernel` 12 times and no other
    kernel; the features agree with the same weights under plain attention."""
    from mrclip_tpu_torch.factory import create_model, get_model_config
    from mrclip_tpu_torch.serving import export_model, load_exported, save_exported

    tag = f"[serve-{attn_impl}]"
    model = create_model(model_name, precision="bf16", attn_impl=attn_impl, rng_seed=0)
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    embed = get_model_config(model_name)["embed_dim"]
    tmp = tempfile.TemporaryDirectory()
    if exported:
        path = os.path.join(tmp.name, "model.mrclip")
        save_exported(export_model(model), path)
        del model
        served = load_exported(path)
        if served.meta["attn_impl"] != attn_impl:
            raise AssertionError(f"artifact carries attn_impl {served.meta['attn_impl']!r}")
        model, encode = served.model, served.encode_image
    else:
        def encode(x):
            with torch.inference_mode():
                return model.encode_image(torch.from_numpy(x).cuda(), normalize=True).float().cpu().numpy()
    images = np.random.RandomState(2).randn(TRAIN_BATCH, 224, 224, 3).astype(np.float32)

    reset_counts()  # this path starts here
    calls = []
    for _ in range(2):
        before = launch_counts()
        feats = unit_rows(encode(images), TRAIN_BATCH, embed)
        calls.append({k: v - before[k] for k, v in launch_counts().items() if v != before[k]})
    main_path = launch_counts()  # read right after the run
    want = [{kernel: 12}] * 2
    plain = create_model(model_name, pretrained=weights, precision="bf16", attn_impl="xla")
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        ref = plain.encode_image(x, normalize=True).float().cpu().numpy()
    cos = cosine_rows(feats, ref).min()
    ok = calls == want and cos >= 0.999
    log(f"{tag} {model_name} encode_image b{TRAIN_BATCH} "
        f"{'through ServedModel from an artifact' if exported else 'under inference_mode'}: "
        f"launches per call {calls} (want {want}); min cosine vs plain attention, same weights "
        f"{cos:.6f} (>= 0.999) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {attn_impl} encode path of {model_name} failed its checks")
    perf = {}
    with torch.inference_mode():
        for name, m in ((attn_impl, model), ("xla", plain)):
            perf[f"device_encode_image_b256_ms_{name}"] = cuda_ms(
                lambda: m.encode_image(x, normalize=True), 5, warmup=1)
    t = time.perf_counter()
    for _ in range(3):
        encode(images)
    perf["encode_image_b256_imgs_per_s"] = TRAIN_BATCH * 3 / (time.perf_counter() - t)
    log(f"{tag} throughput on {card}: " + json.dumps(perf))
    tmp.cleanup()
    del model, plain
    torch.cuda.empty_cache()
    return main_path, perf


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mrclip_tpu_torch  # noqa: F401 - outside a checkout this fails before any output

    name, smi = phase_card()
    phase_build()
    entries = {e["name"]: e for e in [phase_kernel_fwd(), phase_kernel_bwd(), *phase_kernel_rope(),
                                      *phase_kernel_supcon(), *phase_kernel_grouped(),
                                      *phase_kernel_flash()]}
    fwd, rope_fwd = entries["packed_attn_fwd"], entries["packed_attn_rope_fwd"]
    k4, k10 = entries["grouped_attn_fwd"], entries["flash_attn_fwd"]
    paths, per_step = {}, {}
    paths["serve"], fwd["launches_per_pair"], fwd["serving"] = phase_serve(fwd, smi)
    paths["train"], per_step["train"], fwd["training"] = phase_train("ViT-B-16", entries, smi)
    paths["serve_eva02"], rope_fwd["serving"] = phase_serve_eva02(entries, smi)
    paths["train_eva02"], per_step["train_eva02"], rope_fwd["training"] = phase_train(
        "EVA02-B-16", entries, smi)
    paths["train_fused"], per_step["train_fused"], k4["training"] = phase_train(
        "ViT-B-16", entries, smi, attn_impl="fused", timed=3, pallas_step=False)
    paths["serve_fused"], k4["serving"] = phase_encode("ViT-B-16", "fused", "grouped_attn_fwd", smi,
                                                       exported=True)
    paths["train_flash"], per_step["train_flash"], k10["training"] = phase_train(
        "EVA02-B-16", entries, smi, attn_impl="flash", timed=3, pallas_step=False)
    paths["serve_flash"], k10["serving"] = phase_encode("EVA02-B-16", "flash", "flash_attn_fwd", smi,
                                                        exported=False)
    log(f"[train-flash] peak memory of the EVA02-B-16 b{TRAIN_BATCH} step: flash "
        f"{k10['training']['peak_memory_gb']:.2f} GB (keeps q, k, v), fusedp "
        f"{rope_fwd['training']['peak_memory_gb']:.2f} GB (keeps q, k, v, o, lse)")
    # every kernel of a path launched on it (the exact counts are checked inside)
    expected = {"serve": ["packed_attn_fwd"],
                "train": [*TRAIN_PATHS["ViT-B-16", "fusedp"]["per_step"], *PALLAS_STEP],
                "serve_eva02": ["packed_attn_rope_fwd", "packed_attn_fwd"],
                "train_eva02": [*TRAIN_PATHS["EVA02-B-16", "fusedp"]["per_step"], *PALLAS_STEP],
                "train_fused": [*TRAIN_PATHS["ViT-B-16", "fused"]["per_step"]],
                "serve_fused": ["grouped_attn_fwd"],
                "train_flash": [*TRAIN_PATHS["EVA02-B-16", "flash"]["per_step"]],
                "serve_flash": ["flash_attn_fwd"]}
    missing = [(p, k) for p, ks in expected.items() for k in ks if not paths[p].get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    for kname, entry in entries.items():
        by_path = {p: counts.get(kname, 0) for p, counts in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        entry["launches_per_step"] = {p: per_step[p].get(kname, 0) for p in per_step}
        entry["card"] = smi
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
