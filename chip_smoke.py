#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mrclip_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:
  1. card:   name, power limit, PyTorch and CUDA versions, TF32 off for fp32
             products;
  2. build:  every CUDA source in `mrclip_tpu_torch/csrc` (one nvcc each, all
             started together), with registers and spills from ptxas for
             every instantiation, and the instantiations that spill;
  3. kernel: each kernel against its plain PyTorch version on the card: K1
             (attention forward) and K3 (attention backward) at the served and
             trained shapes and ragged edges, bf16 and fp32, q/k/v/o/dO as
             strided column slices, both also at the tensor-core kernels'
             tile edges (N in {1, 15, 16, 17, 63, 65, 255}, head dim 32 and
             64, causal and not; and at D = 64 the wgmma forward's, N in
             {48, 49, 64, 127, 128, 129, 193, 208, 209, 256}) and N = 577
             (the chunked backward; two bf16 K3 runs bit-equal there); K2
             and K3r (the same with the EVA02
             rope rotated inside) at EVA02-B-16's vision shapes b32 and b256
             with the real rope_cat_2d table, at edges (prefix 0, N = 1, 50,
             257, head dim 32, causal) and at the tile edges and N = 577,
             causal and not (two bf16 K3r runs bit-equal there);
             which device kernels bf16 and fp32 K1, K2, K3 and K3r run
             (profiler: bf16 K1 on attn_mma_fwd.cuh's wgmma_fwd_kernel, and
             on mma_fwd_kernel at N = 577, K2 on wgmma_fwd_kernel's ROPE form
             at N <= 256 and on mma_fwd_kernel at N = 257 and 577; bf16
             K3/K3r (and K5) on attn_mma_bwd.cuh's wgmma_bwd_* at D = 64
             with N and Nk <= 256, on its mma_bwd_* at N = 257 and 577, Nk =
             300 and D = 32, K10b on wgmma_bwd_*'s FLASH form at the vision,
             N = 256 and causal ctx 77 shapes and on mma_bwd_* at N = 577,
             each name in its own profiler group; fp32 on packed_attn_bwd.cu's
             FMA kernels);
             K6/K7 (fused SupCon loss) in fp32 at
             B in {100, 256, 333} and with distinct labels; timings beside
             the plain versions, the bounds and SDPA (forward, and backward;
             for K2/K3r on q and k rotated beforehand, so not the same
             function), K1 beside K4 and K10 and K2 beside K1 and K4 at the same
             shape, K3 beside K5 and K3r beside K3 (medians of 7, and the
             profiler's device time per launch: at the small shapes the host
             takes longer to issue a call than the card to run it; two bf16
             K3 and K3r runs bit-equal at the timed shapes); K4/K5
             (grouped-layout attention, 'fused') and K10/K10b (flash
             attention, 'flash'; also at N = 257 and 577, several key
             blocks; K4/K5 also at N = 577) at the same shapes as K1/K3 and
             at the edges of the bf16 tensor-core tiles (as K1's), bf16 and
             fp32, which device kernels bf16 and fp32 K4, K5, K10 and K10b
             run (profiler; bf16 K4 and K10 on wgmma_fwd_kernel, K10 at N =
             577 on mma_fwd_kernel; K10b as above),
             two bf16 K5 and K10b runs bit-equal, timed at the b256 shapes of
             phases 8 and 9 beside K1 (K4) and K4/K5 (K10/K10b), the
             backward too as medians of 7 and the profiler's device time;
             K8/K9 (depthwise convolution, MRCLIP_DW_IMPL=pallas) at
             MobileCLIP-S1's stage shapes (b32 and b256) and edges (B = 1,
             9 x 13, C in {8, 80, 100}, K = 5; 7 x 7 on 2 x 2; the kernels'
             tiles one pixel short and past, an odd C, C not a multiple of
             64; x and dy one element into their storage, off 16-byte
             alignment), bf16 and fp32, K9 twice for equal bits, timed
             beside the plain versions, the bounds, the unfused floors and
             cuDNN (`F.conv2d(groups=C)`), as event means and profiler
             device time;
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
             `inference_mode`, 12 K10 per call;
 10. serve MobileCLIP-S1 (FastViT MCi1, 256 x 256, random weights from a
             seed, bf16, 'fusedp', MRCLIP_DW_IMPL=pallas): export, load,
             `encode_image` at b32 and b256 and `encode_text` at b256 through
             `ServedModel`; 73 K8 and 4 K1 per image call, 12 K1 per text
             call; features against the same weights on cuDNN's convolution
             and plain attention; throughput under both convolution choices;
 11. train MobileCLIP-S1 at b256 as phase 5, attn_impl 'bf16' (bench.py's
             choice): gradients against cuDNN's convolution, every depthwise
             weight with a gradient, pallas vs dense loss, one warm-up, 3
             timed steps and a pallas-loss step with 73 K8 + 73 K9 each, a
             profiled step (K8 and K9 in their own groups, no depthwise
             kernel in "other"), peak memory, and the step on cuDNN's
             convolution;
 12. objectives: ViT-B-16 as phase 5 with MR-CLIP's frozen temperature
             (logit_scale_trainable=False: ln 10, in no parameter tree) and
             text dropout 0.1 (masks from the step's CUDA generator), TE/TR
             from the labels as the JAX package's synthetic data makes them:
             the TE/TR distance-weighted loss's gradients against plain
             attention (same weights, same masks), the dropout's masks
             following the generator, one warm-up and 3 timed distance steps
             (24 K1 + 24 K3 each; logit_scale unchanged, no moments); one
             checked step each of vision-only (build_vision_only_step, 12 K1
             + 12 K3), lam, distill (a second ViT-B-16 as the frozen teacher,
             48 K1 + 24 K3) and SigLIP (logit_bias -10 gets a gradient), each
             step's loss held, on its own captured outputs, against the same
             function in float64 on the CPU (1e-4); and the chunked loss
             against the dense one at B = 8192, D = 512 (loss 1e-4, gradient
             cosine 0.9999), timed beside the dense and pallas losses with
             the peak memory of each.
Each path (4 to 12; phase 12 has five, one per objective) runs with the
launch counts set to 0 just before it and reads them just after. The last three lines are the kernels JSON, the card's
name and power limit, and {"ok": true, "device": {...}}. Needs one CUDA card
and imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
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
# FP32 instructions (FMUL, FADD or FFMA: one lane each) an H100 SXM issues a
# second: 132 SMs x 128 lanes at the 1.98 GHz boost clock
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
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
# K6/K7: (B, label classes | None for distinct labels, D): the train batch,
# ragged batches, the edges of ops/pallas_loss.plan's 32-row tiles and
# splits (31, 33, 127, 129, 257) and of its 64 x 128 gradient tiles (1000),
# D = 30 (element-by-element copies) and 1024 (the gradients in two
# 512-wide slices, own rows streamed)
SUPCON_CASES = [(256, 32, EMBED), (100, 32, EMBED), (333, 32, EMBED), (256, None, EMBED),
                *((n, 32, EMBED) for n in (31, 33, 127, 129, 257, 1000)),
                (1000, 32, 30), (256, 32, 1024)]
SUPCON_BIG = 8192  # a global batch of the 8k-32k the fused loss exists for
EDGES = [dict(b=4, n=n, nk=n, h=4, d=64, causal=c) for n in (1, 50, 257) for c in (False, True)]
EDGES += [dict(b=2, n=76, nk=255, h=2, d=64, causal=False),  # kv length != q length
          dict(b=3, n=33, nk=33, h=2, d=32, causal=True)]  # head dim 32
TEXT77 = dict(TEXT, n=77, nk=77)  # EVA02-B-16's (and MobileCLIP-S1's) text tower, context 77
MCI = dict(b=32, n=64, nk=64, h=8, d=64, causal=False)  # MobileCLIP-S1's attention stage
# K1 and K3 are checked at every shape phase 3 times them: the served b32 and
# the trained b256 of ViT-B-16's towers and of EVA02-B-16's text tower, and
# at MobileCLIP-S1's served attention stage (8 x 8 tokens), b32 and b256
CHECKED = [VISION, TEXT, *(dict(s, b=TRAIN_BATCH) for s in (VISION, TEXT, TEXT77)), MCI,
           dict(MCI, b=TRAIN_BATCH), *EDGES]
# K10/K10b also where jax walks several key blocks: N = 577 pads to 640, five
# blocks of 128, N = 400 to 512, two of 256 (N = 257 in EDGES pads to 384,
# three of 128)
FLASH_CHECKED = [*CHECKED, *(dict(b=4, n=n, nk=n, h=4, d=64, causal=c)
                             for n in (577, 400) for c in (False, True))]
# K1, K4 and K10 (and their backward) also at the edges of the bf16
# forward's tiles: 16-key groups, 64-key sub-tiles, 16-row warps of a 64-row
# block; and of the wgmma forward (D = 64): its 64-row sub-tile (N = 64,
# 127, 128, 129, 193), its n64 tiles and n16 tail (48, 49, 208, 209) and
# the top of its route (256 keys; N = 257 in EDGES takes mma_fwd_kernel)
TILE_EDGES = [dict(b=2, n=n, nk=n, h=2, d=d, causal=c) for n in (1, 15, 16, 17, 63, 65, 255)
              for d in (32, 64) for c in (False, True)]
TILE_EDGES += [dict(b=2, n=n, nk=n, h=2, d=64, causal=c)
               for n in (48, 49, 64, 127, 128, 129, 193, 208, 209, 256) for c in (False, True)]
# K1 and K4/K5 past 256 keys, where the tensor-core kernels walk chunks of
# 256 rows (the forward copies them again in pass B; N = 257 is in EDGES):
# N = 577, three chunks; and Nk != N past the bf16 backward's wgmma route
# (Nk <= 256: N = 76, Nk = 255 in EDGES)
PACKED_CHECKED = [*CHECKED, *TILE_EDGES, *(dict(b=4, n=577, nk=577, h=4, d=64, causal=c)
                                           for c in (False, True)),
                  dict(b=2, n=76, nk=300, h=2, d=64, causal=False)]
# K1, K4, K10 and K2 with one key block of at most 256 keys at D = 64
# (every main-path shape); several key blocks, longer walks and D = 32 stay
# on mma_fwd_kernel
WGMMA_FWD = dict(source="mrclip_tpu_torch/csrc/attn_mma_fwd.cuh",
                 design="wgmma bf16 (wgmma_fwd_kernel: m64n64k16 and m64n16k16, A in "
                        "registers, K and V read through 128-byte-swizzled shared memory), each "
                        "row's scores whole in registers, one exp per score; mma.sync "
                        "(mma_fwd_kernel) over several key blocks, past 256 keys and at D = 32")
# K3, K3r, K5 and K10b at D = 64 with n and nk at most 256 (every
# main-path shape); D = 32 and longer walks stay on the mma_bwd_* kernels
WGMMA_BWD = dict(source="mrclip_tpu_torch/csrc/attn_mma_bwd.cuh",
                 design="wgmma bf16 (wgmma_bwd_dq_kernel, wgmma_bwd_dkv_kernel: m64n64k16 and "
                        "m64n16k16, A in registers, the staged pair read K-major and MN-major "
                        "from one 128-byte-swizzled tile), two passes, no atomics; mma.sync "
                        "(mma_bwd_*) past 256 rows and at D = 32")
# the bf16 forwards (K1, K2, K4, K10), the kernels each is set beside and
# SDPA take tens of microseconds at the text shapes: each is the median of
# this many readings
FWD_RUNS = 7
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
# K2 and K3r at the tile edges (prefix 1 at D = 64, 0 at D = 32), causal
# and not, and past 256 rows (the chunked kernels)
ROPE_TILE_EDGES = [dict(s, prefix=int(s["d"] == 64)) for s in TILE_EDGES]
ROPE_TILE_EDGES += [dict(b=2, n=577, nk=577, h=2, d=64, causal=c, prefix=1) for c in (False, True)]
# K8/K9: MobileCLIP-S1's stride-1 depthwise convolutions (H, W, C, K) by
# stage, with their count in one forward (RepMixer blocks x one 3x3 and one
# 7x7; the CPE on the 8 x 8 map), held at b32 and b256; and the edges
# (B, H, W, C, K): one image, a ragged 9 x 13 map, C not a multiple of 32,
# the CPE's 7 x 7 on the 2 x 2 map of a 64 px image; the kernels' tiles
# (`ops/dw_conv.plan`: 16 x 16 output pixels at maps of 16 and wider in
# bf16, 4 or 8 rows in fp32, 8 wide on the 8 x 8 map; 64 channels) one pixel
# short and one past, at K = 3, 5 and 7, in H and in W, an odd C, C not a
# multiple of 64; and contiguous views whose storage offset of one element
# breaks 16-byte alignment (the element-wise copies)
DW_STAGES = [((64, 64, 64, 3), 4), ((64, 64, 64, 7), 4), ((32, 32, 128, 3), 12),
             ((32, 32, 128, 7), 12), ((16, 16, 256, 3), 20), ((16, 16, 256, 7), 20),
             ((8, 8, 512, 7), 1)]
DW_EDGES = [(1, 9, 13, c, 5) for c in (8, 80, 100)] + [(2, 2, 2, 16, 7)] + [
    (2, 7, 31, 64, 7), (2, 9, 33, 64, 3), (2, 9, 33, 33, 7), (2, 15, 15, 128, 7),
    (2, 17, 17, 100, 3), (2, 8, 8, 96, 5), (2, 15, 33, 64, 7), (2, 17, 17, 64, 7),
    (2, 33, 31, 64, 5)]
DW_OFFSET_VIEWS = [(2, 9, 33, 64, 7), (2, 16, 16, 128, 3)]
# K8 and K9's dx: bit-identical to the plain versions (the same fp32 products
# and sums in the same order, one rounding to the input type); the bar is
# one bf16 ulp at |y| < 4 and 0 in fp32. K9's dw: max |err| / max |plain|,
# fp32 sums over up to 10^6 terms in another order.
DW_TOL = {torch.bfloat16: 2e-2, torch.float32: 0.0}
DW_GRAD_TOL = 1e-3
MOBILECLIP_SIZE = 256
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


def median_ms(fns: dict, iters: int, runs: int = FWD_RUNS) -> tuple[dict, dict]:
    """Median of `runs` cuda_ms readings of each of `fns` (name -> fn), the
    fns taken in turn within a run so that a slow spell of the card falls on
    all of them; and every reading."""
    reads = {key: [] for key in fns}
    for _ in range(runs):
        for key, fn in fns.items():
            reads[key].append(cuda_ms(fn, iters))
    return {key: statistics.median(v) for key, v in reads.items()}, reads


def device_ms(fns: dict, launches: int = 10, runs: int = FWD_RUNS) -> dict:
    """Median over `runs` torch.profiler windows of each of `fns`' device
    time per call (the kernels that `launches` back-to-back calls ran): the
    kernel's own time, which cuda_ms exceeds where the host takes longer to
    issue a call than the card takes to run it. None where the profiler
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reads = {key: [] for key in fns}
    for _ in range(runs):
        for key, fn in fns.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(launches):
                    fn()
                torch.cuda.synchronize()
            total = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA)
            reads[key].append(total / launches / 1e3)
    return {key: statistics.median(v) if all(v) else None for key, v in reads.items()}


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def spread(readings: dict) -> str:
    """min-max of each fn's readings, ms."""
    return ", ".join(f"{key} {min(v):.4f}-{max(v):.4f}" for key, v in readings.items())


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


def supcon_bound(kind, nq, nk, d, scratch=0):
    """K6 'stats': 2*Nq*Nk*D operations, q and k read, 4 row vectors written;
    K7 'grad_q'/'grad_k': 4*Nq*Nk*D (the logit tile and the gradient
    product), q, k, labels and 3 row vectors read, dq (+ds) or dk written.
    `scratch`: fp32 partials a split call also writes and reads back (not
    part of the function; the bound with them is reported beside it)."""
    if kind == "stats":
        nbytes, ops = 4 * (nq + nk) * d + 4 * (nq + nk) + 16 * nq, 2 * nq * nk * d
    else:
        out = nq * d + nq if kind == "grad_q" else nk * d
        nbytes, ops = 4 * (nq + nk) * d + 4 * (nq + nk) + 12 * nq + 4 * out, 4 * nq * nk * d
    return _bound(nbytes + 8 * scratch, ops, torch.float32)


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
    log(f"[card] {name} | {smi} | devices={torch.cuda.device_count()} | torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[card] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, smi


SOURCES = ("packed_attn_fwd", "packed_attn_bwd", "supcon_loss", "grouped_attn", "flash_attn",
           "dw_conv")


def phase_build():
    from mrclip_tpu_torch.ops import build, dw_conv, flash_attn, fused_attn, pallas_loss

    t0 = time.perf_counter()
    build.load_libraries(SOURCES)  # one nvcc per source, all started together
    log(f"[build] {len(SOURCES)} sources built in {time.perf_counter() - t0:.2f} s wall")
    spills = []
    for name in SOURCES:
        info = build.build_info(name)
        log(f"[build] {name}.cu -> {info['path']} in {info['seconds']:.2f} s")
        entry = ""
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill stores" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{name}: {entry} ({line.strip()})")
    log(f"[build] instantiations that spill: {len(spills)}")
    for line in spills:
        log(f"[build]   {line}")
    fused_attn.load_kernel()
    fused_attn.load_bwd_kernel()
    fused_attn.load_grouped_kernels()
    flash_attn.load_kernels()
    pallas_loss.load_kernels()
    dw_conv.load_kernels()


def device_kernels(tag, calls, want, avoid=None, group=None):
    """The device kernels that one call of each of `calls` (dtype -> fn)
    launches, by torch.profiler; fails unless each name holds `want[dtype]`
    (the kernel the type routes to) and not `avoid` (a kernel whose name
    holds want's: "wgmma_bwd_" holds "mma_bwd_"), and, with `group`, unless
    `kernel_group` puts each name in that profiler group. "not measured"
    where the profiler records no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dtype, fn in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = sorted({ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA})
        key = str(dtype)[6:]
        names[key] = seen or "not measured"
        ok = not seen or all(want[dtype] in name and not (avoid and avoid in name)
                             and (group is None or kernel_group(name) == group) for name in seen)
        log(f"[kernel] {tag} {key} runs {seen or 'no kernel the profiler recorded: not measured'} "
            f"(want {want[dtype]!r}{f', not {avoid!r}' if avoid else ''}"
            f"{f', in group {group!r}' if group else ''}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} {key} ran {seen}, not {want[dtype]} (or not in {group})")
    return names


def phase_kernel_fwd():
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for shape in PACKED_CHECKED:
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

    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv_slices(VISION, dtype, gen)
        calls[dtype] = lambda q=q, k=k, v=v: fa.fused_attention_packed(q, k, v, heads=VISION["h"])
    names = device_kernels("K1", calls, {torch.bfloat16: "wgmma_fwd_kernel<false, false, ",
                                         torch.float32: "packed_attn_fwd_kernel<64, false>"})
    chunked = dict(VISION, b=4, n=577, nk=577, h=4)  # past 256 keys: the chunked walk
    q, k, v = qkv_slices(chunked, torch.bfloat16, gen)
    call = {torch.bfloat16: lambda: fa.fused_attention_packed(q, k, v, heads=chunked["h"])}
    names["bf16_n577"] = device_kernels(
        "K1 N=577", call, {torch.bfloat16: "mma_fwd_kernel<64, false, false, false>"})["bfloat16"]

    def timings(shape):
        q, k, v = qkv_slices(shape, torch.bfloat16, gen)
        h, d, causal = shape["h"], shape["d"], shape["causal"]
        q3, k3, v3 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
        q4, k4, v4 = (t.transpose(1, 2) for t in (q3, k3, v3))
        qg, kg, vg = (fa.group_heads(t) for t in (q3, k3, v3))
        fns = {"ms": lambda: fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h),
               "k4_ms": lambda: fa.fused_attention_grouped(qg, kg, vg, is_causal=causal),
               "k10_ms": lambda: fl.flash_attention(q3, k3, v3, is_causal=causal),
               "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=causal)}
        t, readings = median_ms(fns, 50)
        t.update(readings=readings, device_ms=device_ms(fns), plain_ms=cuda_ms(
            lambda: fa.fused_attention_packed_ref(q, k, v, is_causal=causal, heads=h), 20))
        t["bound_ms"], t["bound_by"] = attention_bound(**shape, dtype=torch.bfloat16)
        dev = t["device_ms"]
        log(f"[kernel] K1 bf16 {shape}: kernel {t['ms']:.4f} ms, K4 / K10 same shape "
            f"{t['k4_ms']:.4f} / {t['k10_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
            f"{t['library_ms']:.4f} ms (medians of {FWD_RUNS}; readings {spread(readings)}); "
            f"device time per launch (profiler): K1 {fmt_ms(dev['ms'])}, K4 "
            f"{fmt_ms(dev['k4_ms'])}, K10 {fmt_ms(dev['k10_ms'])}, SDPA "
            f"{fmt_ms(dev['library_ms'])} ms; bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']})")
        return t

    vision, text = timings(VISION), timings(TEXT)
    serving_b256 = timings(dict(VISION, b=TRAIN_BATCH))
    text_b256 = timings(dict(TEXT, b=TRAIN_BATCH))
    text77_b256 = timings(dict(TEXT77, b=TRAIN_BATCH))
    return {
        "name": "packed_attn_fwd",
        "route": "cuda",
        "replaces": "mrclip_tpu/ops/fused_attn.py:300",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_packed_fwd_kernel",
        "launches": None,  # filled in from the served run
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_fp32": worst[torch.float32],
        "shape": "vision b32 n197 h12 d64 bf16",
        **vision,
        **WGMMA_FWD,  # bf16; fp32 runs packed_attn_fwd.cu's FMA kernel
        "entry": "mrclip_tpu_torch/csrc/packed_attn_fwd.cu::packed_attn_fwd",
        "device_kernels": names,
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


def fresh_grads(shape, dtype):
    """A zero-argument call giving the column slices (dq, dk, dv) of a new
    [B, N, 3*H*D] gradient buffer, as the train step's backward allocates
    one per call (fresh outputs also keep two runs' bits apart)."""
    b, n, hd = shape["b"], shape["n"], shape["h"] * shape["d"]
    return lambda: torch.empty(b, n, 3 * hd, device="cuda", dtype=dtype).chunk(3, dim=-1)


def phase_kernel_bwd():
    """K3 against its plain version at PACKED_CHECKED (the tensor-core tile
    edges and N = 577, the chunked kernels, too); q, k, v, o and dO as
    strided column slices, and dq/dk/dv written into the column slices of
    one buffer where N = Nk (as the train step hands them over); two bf16
    runs bit-equal at N = 577 (and at the timed shapes); which device
    kernels bf16 and fp32 K3 run; timings at the b256 main-path shapes
    beside K5 at the same shape and SDPA's backward."""
    from mrclip_tpu_torch.ops import fused_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_abs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for shape in PACKED_CHECKED:
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
                out = fresh_grads(shape, dtype)()
            got = fa.fused_attention_packed_bwd(q, k, v, o_s, do_s, lse, is_causal=causal,
                                                heads=h, out=out)
            torch.cuda.synchronize()
            want = fa.fused_attention_packed_bwd_ref(q, k, v, o_s, do_s, lse, is_causal=causal,
                                                     heads=h)
            scale = max(w.float().abs().max().item() for w in want)
            errs = [rel_err(g, w, scale) for g, w in zip(got, want)]
            ok = all(bool(torch.isfinite(g.float()).all()) for g in got) and max(errs) <= GRAD_TOL[dtype]
            same = ""
            if dtype == torch.bfloat16 and shape["n"] == 577:  # the chunked kernels
                again = fa.fused_attention_packed_bwd(q, k, v, o_s, do_s, lse, is_causal=causal,
                                                      heads=h)
                equal = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = ok and equal
                same = "; two runs bit-equal" if equal else "; two runs differ"
            log(f"[kernel] K3 {shape} {str(dtype)[6:]}: max|d-plain| / max|plain| (={scale:.3g}) "
                "dq/dk/dv = " + "/".join(f"{e:.3e}" for e in errs) + f" (tol {GRAD_TOL[dtype]})"
                + same + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"packed_attn_bwd disagrees with its plain version at {shape} {dtype}")
            worst[dtype] = max(worst[dtype], *errs)
            worst_abs[dtype] = max(worst_abs[dtype], *(abs_err(g, w) for g, w in zip(got, want)))

    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv_slices(VISION, dtype, gen)
        o, lse = fa.fused_attention_packed(q, k, v, heads=VISION["h"])
        calls[dtype] = lambda q=q, k=k, v=v, o=o, lse=lse: fa.fused_attention_packed_bwd(
            q, k, v, o, o, lse, heads=VISION["h"])
    names = device_kernels("K3", calls, {torch.bfloat16: "wgmma_bwd_", torch.float32: "attn_bwd_"},
                           group=K3_GROUP)
    # past the wgmma route (N = 257, 577; Nk = 300) and at D = 32: mma.sync
    for tag, shape in (("N=256", dict(VISION, b=2, n=256, nk=256, h=2)),
                       ("N=257", dict(VISION, b=2, n=257, nk=257, h=2)),
                       ("N=577", dict(VISION, b=2, n=577, nk=577, h=2)),
                       ("Nk=300", dict(VISION, b=2, n=76, nk=300, h=2)),
                       ("D=32", dict(VISION, b=2, h=2, d=32))):
        q, k, v = qkv_slices(shape, torch.bfloat16, gen)
        o, lse = fa.fused_attention_packed(q, k, v, heads=2)
        call = {torch.bfloat16: lambda q=q, k=k, v=v, o=o, lse=lse: fa.fused_attention_packed_bwd(
            q, k, v, o, o, lse, heads=2)}
        wgmma = shape["d"] == 64 and max(shape["n"], shape["nk"]) <= 256
        names[f"bf16_{tag}"] = device_kernels(
            f"K3 {tag}", call, {torch.bfloat16: "wgmma_bwd_" if wgmma else "mma_bwd_"},
            avoid=None if wgmma else "wgmma", group=K3_GROUP)["bfloat16"]

    def timings(shape):
        q, k, v = qkv_slices(shape, torch.bfloat16, gen)
        h, d, causal = shape["h"], shape["d"], shape["causal"]
        o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
        grads = fresh_grads(shape, torch.bfloat16)
        qg, kg, vg, og, dog = (fa.group_heads(t.unflatten(-1, (h, d))) for t in (q, k, v, o, do))
        lse_g = lse.flatten(0, 1)
        t = backward_timings(
            {"ms": lambda: fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal,
                                                         heads=h, out=grads()),
             "k5_ms": lambda: fa.fused_attention_grouped_bwd(qg, kg, vg, og, dog, lse_g,
                                                             is_causal=causal)},
            lambda: fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=causal,
                                                      heads=h))
        q4, k4, v4, do4 = (x.unflatten(-1, (h, d)).transpose(1, 2) for x in (q, k, v, do))
        _, t["library_ms"] = sdpa_ms(q4, k4, v4, do4, causal)
        t["bound_ms"], t["bound_by"] = attention_bwd_bound(**shape, dtype=torch.bfloat16)
        dev = t["device_ms"]
        log(f"[kernel] K3 bf16 {shape}: kernel {t['ms']:.4f} ms, K5 same shape {t['k5_ms']:.4f} "
            f"ms (medians of {FWD_RUNS}; readings {spread(t['readings'])}); device time per "
            f"launch (profiler): K3 {fmt_ms(dev['ms'])}, K5 {fmt_ms(dev['k5_ms'])} ms; two runs "
            f"bit-equal; plain {t['plain_ms']:.4f} ms, SDPA backward {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
        return t

    vision = timings(dict(VISION, b=TRAIN_BATCH))
    text = timings(dict(TEXT, b=TRAIN_BATCH))
    text77 = timings(dict(TEXT77, b=TRAIN_BATCH))
    return {
        "name": "packed_attn_bwd",
        "route": "cuda",
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
        **WGMMA_BWD,  # bf16; fp32 runs packed_attn_bwd.cu's FMA kernels
        "entry": "mrclip_tpu_torch/csrc/packed_attn_bwd.cu::packed_attn_bwd",
        "device_kernels": names,
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
    for shape in [ROPE_VISION, dict(ROPE_VISION, b=TRAIN_BATCH), *ROPE_EDGES, *ROPE_TILE_EDGES]:
        h, causal = shape["h"], shape["causal"]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _, tab = rope_inputs(shape, dtype, gen)
            o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h, rope=tab)
            od = torch.empty(*o.shape[:2], 2 * o.shape[2], device="cuda", dtype=dtype)
            o_s, do_s = od.chunk(2, dim=-1)
            o_s.copy_(o)
            do_s.copy_(torch.randn(o.shape, device="cuda", generator=gen))
            got = fa.fused_attention_packed_bwd(q, k, v, o_s, do_s, lse, is_causal=causal, heads=h,
                                                rope=tab, out=fresh_grads(shape, dtype)())
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
            same = ""
            if dtype == torch.bfloat16 and shape["n"] == 577:  # the chunked kernels
                again = fa.fused_attention_packed_bwd(q, k, v, o_s, do_s, lse, is_causal=causal,
                                                      heads=h, rope=tab)
                equal = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = ok and equal
                same = "; two runs bit-equal" if equal else "; two runs differ"
            log(f"[kernel] K2/K3r {shape} {str(dtype)[6:]}: max|o-plain|={err_o:.3e} (tol "
                f"{O_TOL[dtype]}) max|lse-plain|={err_l:.3e} (tol {LSE_TOL}); max|d-plain| / "
                f"max|plain| (={scale:.3g}) dq/dk/dv = " + "/".join(f"{e:.3e}" for e in errs)
                + f" (tol {GRAD_TOL[dtype]})" + same + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"packed_attn_rope_fwd/bwd disagree with their plain versions "
                                     f"at {shape} {dtype}")
            worst["fwd"][dtype] = max(worst["fwd"][dtype], err_o)
            worst["bwd"][dtype] = max(worst["bwd"][dtype], *(abs_err(g, w) for g, w in zip(got, want)))
            worst_rel[dtype] = max(worst_rel[dtype], *errs)

    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _, tab = rope_inputs(ROPE_VISION, dtype, gen)
        calls[dtype] = lambda q=q, k=k, v=v, tab=tab: fa.fused_attention_packed(
            q, k, v, heads=ROPE_VISION["h"], rope=tab)
    names = device_kernels("K2", calls, {torch.bfloat16: "wgmma_fwd_kernel<false, true, ",
                                         torch.float32: "packed_attn_fwd_kernel<64, true>"},
                           group=K2_GROUP)
    for n in (256, 257, 577):  # the top of the wgmma route, and past it
        shape = dict(ROPE_VISION, b=2, n=n, nk=n, h=2)
        q, k, v, _, tab = rope_inputs(shape, torch.bfloat16, gen)
        call = {torch.bfloat16: lambda q=q, k=k, v=v, tab=tab:
                fa.fused_attention_packed(q, k, v, heads=2, rope=tab)}
        names[f"bf16_n{n}"] = device_kernels(
            f"K2 N={n}", call, {torch.bfloat16: "wgmma_fwd_kernel<false, true, " if n <= 256
                                else "mma_fwd_kernel<64, false, false, true>"},
            avoid=None if n <= 256 else "wgmma", group=K2_GROUP)["bfloat16"]
    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _, tab = rope_inputs(ROPE_VISION, dtype, gen)
        o, lse = fa.fused_attention_packed(q, k, v, heads=ROPE_VISION["h"], rope=tab)
        calls[dtype] = lambda q=q, k=k, v=v, o=o, lse=lse, tab=tab: fa.fused_attention_packed_bwd(
            q, k, v, o, o, lse, heads=ROPE_VISION["h"], rope=tab)
    names_bwd = device_kernels("K3r", calls, {torch.bfloat16: "wgmma_bwd_",
                                              torch.float32: "attn_bwd_"}, group=K3R_GROUP)
    for n in (256, 257, 577):  # the top of the wgmma route, and past it
        shape = dict(ROPE_VISION, b=2, n=n, nk=n, h=2)
        q, k, v, _, tab = rope_inputs(shape, torch.bfloat16, gen)
        o, lse = fa.fused_attention_packed(q, k, v, heads=2, rope=tab)
        call = {torch.bfloat16: lambda q=q, k=k, v=v, o=o, lse=lse, tab=tab:
                fa.fused_attention_packed_bwd(q, k, v, o, o, lse, heads=2, rope=tab)}
        names_bwd[f"bf16_n{n}"] = device_kernels(
            f"K3r N={n}", call, {torch.bfloat16: "wgmma_bwd_" if n <= 256 else "mma_bwd_"},
            avoid=None if n <= 256 else "wgmma", group=K3R_GROUP)["bfloat16"]

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def timings(shape):
        q, k, v, rope, tab = rope_inputs(shape, torch.bfloat16, gen)
        h, d, causal = shape["h"], shape["d"], shape["causal"]
        o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h, rope=tab)
        o1, lse1 = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
        grads = fresh_grads(shape, torch.bfloat16)
        # SDPA on q and k rotated beforehand: the rotation is not in its time
        tab32 = fa.rope_table(rope, shape["prefix"], torch.float32).cuda()
        rot = [apply_rope_cat(t.unflatten(-1, (h, d)), tab32).transpose(1, 2) for t in (q, k)]
        q4, k4 = (t.detach().requires_grad_() for t in rot)
        v4 = v.unflatten(-1, (h, d)).transpose(1, 2).detach().requires_grad_()
        do4 = do.unflatten(-1, (h, d)).transpose(1, 2)
        qg, kg, vg = (fa.group_heads(t.unflatten(-1, (h, d))) for t in (q, k, v))
        fns = {"ms": lambda: fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h, rope=tab),
               "k1_ms": lambda: fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h),
               "k4_ms": lambda: fa.fused_attention_grouped(qg, kg, vg, is_causal=causal),
               "library_ms": lambda: sdpa(q4, k4, v4, is_causal=causal)}
        fwd, readings = median_ms(fns, 50)
        fwd.update(readings=readings, device_ms=device_ms(fns), plain_ms=cuda_ms(
            lambda: fa.fused_attention_packed_ref(q, k, v, is_causal=causal, heads=h, rope=tab), 20))
        bwd = backward_timings(
            {"ms": lambda: fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal,
                                                         heads=h, rope=tab, out=grads()),
             "k3_ms": lambda: fa.fused_attention_packed_bwd(q, k, v, o1, do, lse1,
                                                            is_causal=causal, heads=h,
                                                            out=grads())},
            lambda: fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=causal,
                                                      heads=h, rope=tab))
        both = cuda_ms(lambda: torch.autograd.grad(sdpa(q4, k4, v4, is_causal=causal),
                                                   (q4, k4, v4), do4), 20)
        bwd["library_ms"] = both - fwd["library_ms"]
        args = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        fwd["bound_ms"], fwd["bound_by"] = rope_attention_bound(**args, dtype=torch.bfloat16)
        bwd["bound_ms"], bwd["bound_by"] = rope_attention_bound(**args, dtype=torch.bfloat16,
                                                                backward=True)
        dev = fwd["device_ms"]
        log(f"[kernel] K2 bf16 {shape}: kernel {fwd['ms']:.4f} ms, K1 same shape "
            f"{fwd['k1_ms']:.4f} ms, K4 same shape {fwd['k4_ms']:.4f} ms, plain "
            f"{fwd['plain_ms']:.4f} ms, SDPA on pre-rotated q/k {fwd['library_ms']:.4f} ms "
            f"(medians of {FWD_RUNS}; readings {spread(readings)}); device time per launch "
            f"(profiler): K2 {fmt_ms(dev['ms'])}, K1 {fmt_ms(dev['k1_ms'])}, K4 "
            f"{fmt_ms(dev['k4_ms'])}, SDPA {fmt_ms(dev['library_ms'])} ms; bound "
            f"{fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']})")
        dev = bwd["device_ms"]
        log(f"[kernel] K3r bf16 {shape}: kernel {bwd['ms']:.4f} ms, K3 same shape "
            f"{bwd['k3_ms']:.4f} ms (medians of {FWD_RUNS}; readings {spread(bwd['readings'])}); "
            f"device time per launch (profiler): K3r {fmt_ms(dev['ms'])}, K3 "
            f"{fmt_ms(dev['k3_ms'])} ms; two runs bit-equal; plain {bwd['plain_ms']:.4f} ms, "
            f"SDPA backward on pre-rotated q/k {bwd['library_ms']:.4f} ms, bound "
            f"{bwd['bound_ms'] * 1e3:.2f} us ({bwd['bound_by']})")
        return fwd, bwd

    fwd32, bwd32 = timings(ROPE_VISION)
    fwd256, bwd256 = timings(dict(ROPE_VISION, b=TRAIN_BATCH))
    library = ("scaled_dot_product_attention on q and k rotated beforehand: the rotation "
               "is not in its time, so not the same function")
    common = dict(route="cuda", launches=None, shape=f"EVA02-B-16 vision b{TRAIN_BATCH} n197 "
                  "h12 d64 bf16, rope_cat_2d 14x14 table, CLS prefix")
    return [{
        "name": "packed_attn_rope_fwd",
        "replaces": "mrclip_tpu/ops/fused_attn.py:330",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_packed_fwd_kernel, rope branch :330-343",
        "max_abs_err": worst["fwd"][torch.bfloat16],
        "max_abs_err_fp32": worst["fwd"][torch.float32],
        **common, **fwd256,
        # bf16; fp32 runs packed_attn_fwd.cu's FMA kernel
        "source": WGMMA_FWD["source"],
        "design": WGMMA_FWD["design"] + "; q and k rotated in shared memory (rope.cuh "
                  "rotate_pair_f32): K once in the swizzled tile, each Q sub-tile before its "
                  "barrier",
        "entry": "mrclip_tpu_torch/csrc/packed_attn_fwd.cu::packed_attn_rope_fwd",
        "device_kernels": names,
        "library": library + " (forward)",
        "vision_b32": fwd32,
    }, {
        "name": "packed_attn_rope_bwd",
        "replaces": "mrclip_tpu/ops/fused_attn.py:418",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_packed_bwd_kernel, rope branch "
                      ":418-428, :464-473",
        "max_abs_err": worst["bwd"][torch.bfloat16],
        "max_abs_err_fp32": worst["bwd"][torch.float32],
        "max_rel_err": worst_rel[torch.bfloat16],
        "max_rel_err_fp32": worst_rel[torch.float32],
        "rel_err_is": "max |kernel - plain| / the call's largest max |plain| of dq, dk, dv",
        **common, **bwd256,
        # bf16; fp32 runs packed_attn_bwd.cu's FMA kernels
        "source": WGMMA_BWD["source"],
        "design": WGMMA_BWD["design"] + "; the staged operand rotated in shared memory, the "
                  "other in registers, dq and dk un-rotated in registers (rope.cuh)",
        "entry": "mrclip_tpu_torch/csrc/packed_attn_bwd.cu::packed_attn_rope_bwd",
        "device_kernels": names_bwd,
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


def backward_timings(fns, plain):
    """The backward's medians of FWD_RUNS readings and the profiler's device
    time per call of each of `fns` (name -> fn; "ms" is the kernel), the
    plain version's time, and whether two kernel runs on the same inputs
    give the same bits (raises if not: each gradient element is written
    once by one thread, no atomics)."""
    t, readings = median_ms(fns, 20)
    t.update(readings=readings, device_ms=device_ms(fns), plain_ms=cuda_ms(plain, 5))
    first, second = fns["ms"](), fns["ms"]()
    t["bit_equal"] = all(torch.equal(a, b) for a, b in zip(first, second))
    if not t["bit_equal"]:
        raise AssertionError("two runs of the backward kernel on the same inputs differ")
    return t


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
    for shape in PACKED_CHECKED:
        causal = shape["causal"]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(shape, dtype)
            o, lse = fa.fused_attention_grouped(q, k, v, is_causal=causal)
            do = torch.randn(o.shape, device="cuda", generator=gen).to(dtype)
            got = fa.fused_attention_grouped_bwd(q, k, v, o, do, lse, is_causal=causal)
            if dtype == torch.bfloat16 and shape["n"] == 577:  # the chunked kernels
                again = fa.fused_attention_grouped_bwd(q, k, v, o, do, lse, is_causal=causal)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"two bf16 K5 runs differ at {shape}")
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.fused_attention_ref(q, k, v, is_causal=causal)
            want = fa.fused_attention_bwd_ref(q, k, v, o, do, lse, is_causal=causal)
            errs = check_attention("K4/K5", shape, dtype, ((o, [lse]), (o_ref, [lse_ref]), ["lse"]),
                                   (got, want))
            worst[dtype] = [max(a, b) for a, b in zip(worst[dtype], errs)]

    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(VISION, dtype)
        o, lse = fa.fused_attention_grouped(q, k, v)
        calls[dtype] = lambda q=q, k=k, v=v, o=o, lse=lse: fa.fused_attention_grouped_bwd(
            q, k, v, o, o, lse)
    names = device_kernels("K5", calls, {torch.bfloat16: "wgmma_bwd_", torch.float32: "rows_bwd_"},
                           group=K3_GROUP)
    for tag, shape in (("N=257", dict(VISION, b=2, n=257, nk=257, h=2)),
                       ("Nk=300", dict(VISION, b=2, n=76, nk=300, h=2))):
        q, k, v = inputs(shape, torch.bfloat16)
        o, lse = fa.fused_attention_grouped(q, k, v)
        call = {torch.bfloat16: lambda q=q, k=k, v=v, o=o, lse=lse: fa.fused_attention_grouped_bwd(
            q, k, v, o, o, lse)}
        names[f"bf16_{tag}"] = device_kernels(f"K5 {tag}", call, {torch.bfloat16: "mma_bwd_"},
                                              avoid="wgmma", group=K3_GROUP)["bfloat16"]
    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(VISION, dtype)
        calls[dtype] = lambda q=q, k=k, v=v: fa.fused_attention_grouped(q, k, v)
    names_fwd = device_kernels("K4", calls, {torch.bfloat16: "wgmma_fwd_kernel<false, false, ",
                                             torch.float32: "rows_fwd_kernel<float, 64, false>"})

    def timings(shape):
        h, d, causal = shape["h"], shape["d"], shape["causal"]
        q, k, v = inputs(shape, torch.bfloat16)
        q1, k1, v1 = qkv_slices(shape, torch.bfloat16, gen)
        o, lse = fa.fused_attention_grouped(q, k, v, is_causal=causal)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
        b, n = shape["b"], shape["n"]
        q4, k4, v4 = (t.view(b, h, -1, d) for t in (q, k, v))
        fns = {"ms": lambda: fa.fused_attention_grouped(q, k, v, is_causal=causal),
               "k1_ms": lambda: fa.fused_attention_packed(q1, k1, v1, is_causal=causal, heads=h),
               "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=causal)}
        fwd, readings = median_ms(fns, 50)
        fwd.update(readings=readings, device_ms=device_ms(fns), plain_ms=cuda_ms(
            lambda: fa.fused_attention_ref(q, k, v, is_causal=causal), 20))
        bwd = backward_timings(
            {"ms": lambda: fa.fused_attention_grouped_bwd(q, k, v, o, do, lse, is_causal=causal)},
            lambda: fa.fused_attention_bwd_ref(q, k, v, o, do, lse, is_causal=causal))
        _, bwd["library_ms"] = sdpa_ms(q4, k4, v4, do.view(b, h, n, d), causal)
        args = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        fwd["bound_ms"], fwd["bound_by"] = attention_bound(**args, dtype=torch.bfloat16)
        bwd["bound_ms"], bwd["bound_by"] = attention_bwd_bound(**args, dtype=torch.bfloat16)
        dev = fwd["device_ms"]
        log(f"[kernel] K4 bf16 {shape}: kernel {fwd['ms']:.4f} ms, K1 same shape "
            f"{fwd['k1_ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, SDPA {fwd['library_ms']:.4f} "
            f"ms (medians of {FWD_RUNS}; readings {spread(readings)}); device time per launch "
            f"(profiler): K4 {fmt_ms(dev['ms'])}, K1 {fmt_ms(dev['k1_ms'])}, SDPA "
            f"{fmt_ms(dev['library_ms'])} ms; bound {fwd['bound_ms'] * 1e3:.2f} us "
            f"({fwd['bound_by']})")
        log(f"[kernel] K5 bf16 {shape}: kernel {bwd['ms']:.4f} ms (median of {FWD_RUNS}; readings "
            f"{spread(bwd['readings'])}; device time per launch {fmt_ms(bwd['device_ms']['ms'])} "
            f"ms; two runs bit-equal), plain {bwd['plain_ms']:.4f} ms, SDPA backward "
            f"{bwd['library_ms']:.4f} ms, bound {bwd['bound_ms'] * 1e3:.2f} us ({bwd['bound_by']})")
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
        **common, **fwd256, **WGMMA_FWD,
        "device_kernels": names_fwd,
        "library": "scaled_dot_product_attention forward",
        "text_b256": fwd_text,
    }, {
        "name": "grouped_attn_bwd",
        "replaces": "mrclip_tpu/ops/fused_attn.py:118",
        "tpu_kernel": "mrclip_tpu/ops/fused_attn.py::_bwd_kernel (via _core_bwd :193)",
        "max_abs_err": worst[torch.bfloat16][1], "max_abs_err_fp32": worst[torch.float32][1],
        "max_rel_err": worst[torch.bfloat16][2], "max_rel_err_fp32": worst[torch.float32][2],
        "rel_err_is": "max |kernel - plain| / the call's largest max |plain| of dq, dk, dv",
        **common, **bwd256, **WGMMA_BWD,  # bf16; fp32 runs attn_rows.cuh's FMA kernels
        "entry": "mrclip_tpu_torch/csrc/grouped_attn.cu::grouped_attn_bwd",
        "device_kernels": names,
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
    for shape in [*FLASH_CHECKED, *TILE_EDGES]:
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

    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(VISION, dtype)
        o, l, m = fl.flash_attention(q, k, v)
        di = fl.flash_di(o, o)
        calls[dtype] = lambda q=q, k=k, v=v, o=o, l=l, m=m, di=di: fl.flash_attention_bwd(
            q, k, v, o, l, m, di)
    names = device_kernels("K10b", calls, {torch.bfloat16: "wgmma_bwd_",
                                           torch.float32: "rows_bwd_"}, group=K10B_GROUP)
    # the causal text shape (ctx 77) on the wgmma pair's CAUSAL form, the
    # top of its route, and N = 577 (several jax key blocks) on mma.sync
    for tag, shape in (("text77", dict(TEXT77, b=2)), ("n256", dict(VISION, b=2, n=256, nk=256)),
                       ("n577", dict(VISION, b=2, n=577, nk=577))):
        q, k, v = inputs(shape, torch.bfloat16)
        o, l, m = fl.flash_attention(q, k, v, is_causal=shape["causal"])
        di = fl.flash_di(o, o)
        call = {torch.bfloat16: lambda q=q, k=k, v=v, o=o, l=l, m=m, di=di, c=shape["causal"]:
                fl.flash_attention_bwd(q, k, v, o, l, m, di, is_causal=c)}
        wgmma = shape["n"] <= 256  # wgmma_bwd_*<FLASH, ROPE, CAUSAL, TAIL>
        want = f"_kernel<true, false, {str(shape['causal']).lower()}, " if wgmma else "mma_bwd_"
        names[f"bf16_{tag}"] = device_kernels(
            f"K10b {tag}", call, {torch.bfloat16: want}, avoid=None if wgmma else "wgmma",
            group=K10B_GROUP)["bfloat16"]
    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(VISION, dtype)
        calls[dtype] = lambda q=q, k=k, v=v: fl.flash_attention(q, k, v)
    names_fwd = device_kernels("K10", calls, {torch.bfloat16: "wgmma_fwd_kernel<true, ",
                                              torch.float32: "rows_fwd_kernel<float, 64, true>"})
    q, k, v = inputs(dict(VISION, b=4, n=577, nk=577, h=4), torch.bfloat16)  # five key blocks
    names_fwd["bf16_n577"] = device_kernels(
        "K10 N=577", {torch.bfloat16: lambda: fl.flash_attention(q, k, v)},
        {torch.bfloat16: "mma_fwd_kernel<64, true, true, false>"})["bfloat16"]

    def timings(shape):
        h, d, causal = shape["h"], shape["d"], shape["causal"]
        q, k, v = inputs(shape, torch.bfloat16)
        o, l, m = fl.flash_attention(q, k, v, is_causal=causal)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(torch.bfloat16)
        di = fl.flash_di(o, do)
        qg, kg, vg, dog = (fa.group_heads(t) for t in (q, k, v, do))
        og, lse = fa.fused_attention_grouped(qg, kg, vg, is_causal=causal)
        q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"ms": lambda: fl.flash_attention(q, k, v, is_causal=causal),
               "k4_ms": lambda: fa.fused_attention_grouped(qg, kg, vg, is_causal=causal),
               "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=causal)}
        fwd, readings = median_ms(fns, 50)
        fwd.update(readings=readings, device_ms=device_ms(fns), plain_ms=cuda_ms(
            lambda: fl.flash_attention_ref(q, k, v, is_causal=causal), 10))
        bwd = backward_timings(
            {"ms": lambda: fl.flash_attention_bwd(q, k, v, do, l, m, di, is_causal=causal),
             "k5_ms": lambda: fa.fused_attention_grouped_bwd(qg, kg, vg, og, dog, lse,
                                                             is_causal=causal)},
            lambda: fl.flash_attention_bwd_ref(q, k, v, do, l, m, di, is_causal=causal))
        _, bwd["library_ms"] = sdpa_ms(q4, k4, v4, do.transpose(1, 2), causal)
        args = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
        fwd["bound_ms"], fwd["bound_by"] = flash_bound(**args, dtype=torch.bfloat16)
        bwd["bound_ms"], bwd["bound_by"] = flash_bound(**args, dtype=torch.bfloat16, backward=True)
        dev = fwd["device_ms"]
        log(f"[kernel] K10 bf16 {shape}: kernel {fwd['ms']:.4f} ms, K4 same shape "
            f"{fwd['k4_ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, SDPA {fwd['library_ms']:.4f} "
            f"ms (medians of {FWD_RUNS}; readings {spread(readings)}); device time per launch "
            f"(profiler): K10 {fmt_ms(dev['ms'])}, K4 {fmt_ms(dev['k4_ms'])}, SDPA "
            f"{fmt_ms(dev['library_ms'])} ms; bound {fwd['bound_ms'] * 1e3:.2f} us "
            f"({fwd['bound_by']})")
        dev = bwd["device_ms"]
        log(f"[kernel] K10b bf16 {shape}: kernel {bwd['ms']:.4f} ms, K5 same shape "
            f"{bwd['k5_ms']:.4f} ms (medians of {FWD_RUNS}; readings {spread(bwd['readings'])}); "
            f"device time per launch (profiler): K10b {fmt_ms(dev['ms'])}, K5 "
            f"{fmt_ms(dev['k5_ms'])} ms; two runs bit-equal; plain {bwd['plain_ms']:.4f} ms, SDPA "
            f"backward {bwd['library_ms']:.4f} ms, bound {bwd['bound_ms'] * 1e3:.2f} us "
            f"({bwd['bound_by']})")
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
        **common, **fwd256, **WGMMA_FWD,
        "device_kernels": names_fwd,
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
        **common, **bwd256, **WGMMA_BWD,  # bf16; fp32 runs attn_rows.cuh's FMA kernels
        "entry": "mrclip_tpu_torch/csrc/flash_attn.cu::flash_attn_bwd",
        "device_kernels": names,
        "library": "scaled_dot_product_attention backward (fwd+bwd minus fwd)",
        "text77_b256": bwd_text, "n577_b32": bwd_577,
    }]


def supcon_inputs(n, classes, gen, d=EMBED):
    q = torch.nn.functional.normalize(torch.randn(n, d, device="cuda", generator=gen), dim=-1)
    k = torch.nn.functional.normalize(torch.randn(n, d, device="cuda", generator=gen), dim=-1)
    labels = (torch.arange(n, device="cuda") if classes is None else
              torch.randint(0, classes, (n,), device="cuda", generator=gen)).to(torch.int32)
    scale = torch.tensor([1 / 0.07], device="cuda")
    gbar = torch.tensor([0.5 / n], device="cuda")
    return q, k, labels, scale, gbar


SUPCON_MERGE = {"supcon_stats": "supcon_stats_merge", "supcon_grad_q": "supcon_sum_splits",
                "supcon_grad_k": "supcon_sum_splits"}


def supcon_plans(q, k):
    """ops/pallas_loss.plan of each K6/K7 kernel on these operands, as the
    wrappers cut the call."""
    from mrclip_tpu_torch.ops import pallas_loss as pl

    return {f"supcon_{kind}": pl._plan_for(kind, q, k) for kind in pl.TILES}


def plan_text(p):
    return (f"{p.tm}x{p.tn} tiles, {p.splits} split(s) of {p.per_split}, {p.blocks} blocks"
            + (", own rows resident" if p.resident else "") + ("" if p.wide else ", element copies"))


def phase_kernel_supcon():
    """K6 and K7 against their plain versions in fp32 at every SUPCON_CASES
    shape, two runs bit-equal, timings at B = 256 (the train step) and 8192
    (event medians and the profiler's device time), and the pallas-loss
    forward+backward at B = 8192 against the dense loss."""
    from mrclip_tpu_torch.losses import multipositive_clip_loss
    from mrclip_tpu_torch.ops import pallas_loss as pl

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"supcon_stats": 0.0, "supcon_grad_q": 0.0, "supcon_grad_k": 0.0}
    worst_abs = dict(worst)
    for n, classes, d in SUPCON_CASES:
        q, k, labels, scale, gbar = supcon_inputs(n, classes, gen, d)
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
        plans = supcon_plans(q, k)
        log(f"[kernel] K6/K7 B={n} D={d} labels={classes or 'distinct'} fp32: "
            + ", ".join(f"{k_} {e:.3e} ({plan_text(plans[k_])})" for k_, e in errs.items())
            + f" (tol {SUPCON_TOL}) " + ("ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError(f"supcon kernels disagree with their plain versions at B={n} D={d}")
        abs_errs = {
            "supcon_stats": max(abs_err(g, w) for g, w in zip(stats, want)),
            "supcon_grad_q": max(abs_err(dq, want_dq), abs_err(ds_rows, want_ds)),
            "supcon_grad_k": abs_err(dk, want_dk),
        }
        for name, e in errs.items():
            worst[name] = max(worst[name], e)
            worst_abs[name] = max(worst_abs[name], abs_errs[name])

    def calls(n):
        q, k, labels, scale, gbar = supcon_inputs(n, 32, gen)
        m, s, _, cnt = pl.supcon_stats_ref(q, k, labels, labels, scale)
        cnt = cnt.clamp(min=1.0)
        args = (q, k, labels, labels, scale, m, s, cnt, gbar)
        return supcon_plans(q, k), {
            "supcon_stats": (lambda: pl.supcon_stats(*args[:5]),
                             lambda: pl.supcon_stats_ref(*args[:5]), "stats"),
            "supcon_grad_q": (lambda: pl.supcon_grad_q(*args), lambda: pl.supcon_grad_q_ref(*args),
                              "grad_q"),
            "supcon_grad_k": (lambda: pl.supcon_grad_k(*args), lambda: pl.supcon_grad_k_ref(*args),
                              "grad_k"),
        }

    # every kernel splits its walk at B = 256: two runs merge their partials
    # in the same order, without atomics
    plans, fns = calls(TRAIN_BATCH)
    same = {}
    for name, (kernel, _, _) in fns.items():
        first, second = kernel(), kernel()
        first, second = (x if isinstance(x, tuple) else (x,) for x in (first, second))
        same[name] = plans[name].splits > 1 and all(
            torch.equal(a, b) for a, b in zip(first, second))
    log(f"[kernel] K6/K7 B={TRAIN_BATCH} D={EMBED}: two runs bit-equal (split plans): {same}")
    if not all(same.values()):
        raise AssertionError(f"supcon kernels are not deterministic at a split shape: {same}")

    def timings(n):
        plans, fns = calls(n)
        runs = 3 if n >= SUPCON_BIG else FWD_RUNS
        timed = {name: kernel for name, (kernel, _, _) in fns.items()}
        timed.update({f"{name} plain": plain for name, (_, plain, _) in fns.items()})
        med, readings = median_ms(timed, 5 if n >= SUPCON_BIG else 50, runs=runs)
        dev = device_ms(timed, launches=3 if n >= SUPCON_BIG else 10, runs=runs)
        out = {}
        for name, (_, _, kind) in fns.items():
            p = plans[name]
            bound, by = supcon_bound(kind, n, n, EMBED)
            bound_p, by_p = supcon_bound(kind, n, n, EMBED, p.scratch + p.scratch_ds)
            log(f"[kernel] {name} fp32 B={n} D={EMBED} ({plan_text(p)}): kernel "
                f"{med[name]:.4f} ms, device {fmt_ms(dev[name])} ms; plain "
                f"{med[name + ' plain']:.4f} ms, device {fmt_ms(dev[name + ' plain'])} ms; bound "
                f"{bound * 1e3:.2f} us ({by}), with the partials {bound_p * 1e3:.2f} us ({by_p}); "
                f"readings {spread({name: readings[name]})}")
            out[name] = dict(ms=med[name], device_ms=dev[name], plain_ms=med[name + " plain"],
                             plain_device_ms=dev[name + " plain"], bound_ms=bound, bound_by=by,
                             plan=dict(tile=[p.tm, p.tn], splits=p.splits, blocks=p.blocks,
                                       resident=p.resident, scratch_floats=p.scratch + p.scratch_ds,
                                       merge=SUPCON_MERGE[name] if p.splits > 1 else None))
        return out

    b256, big = timings(TRAIN_BATCH), timings(SUPCON_BIG)
    loss_big = phase_loss_big(pl, multipositive_clip_loss, gen)
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
        "merge_kernel": SUPCON_MERGE[name],
        "launch_counts": "one per call, the merge kernel included",
        "bit_equal_runs": same[name],
        f"b{SUPCON_BIG}": big[name],
        f"loss_b{SUPCON_BIG}": loss_big,
    } for name in worst]


def phase_loss_big(pl, multipositive_clip_loss, gen):
    """The two-direction pallas loss (K6 + K7, each twice) forward+backward at
    B = SUPCON_BIG, D = EMBED through pallas_multipositive_clip_loss against
    the dense multipositive_clip_loss on the same inputs: loss within 1e-4
    relative, gradient cosine (features and logit scale) >= 0.9999; both
    timed."""
    img, txt, labels, _, _ = supcon_inputs(SUPCON_BIG, 32, gen)
    img, txt = img.requires_grad_(), txt.requires_grad_()
    scale = torch.tensor(1 / 0.07, device="cuda", requires_grad=True)
    results = {}
    for key, fn in (("pallas", pl.pallas_multipositive_clip_loss),
                    ("dense", multipositive_clip_loss)):
        loss = fn(img, txt, labels, scale)["loss"]
        loss.backward()
        results[key] = (loss.item(), {n: t.grad.clone() for n, t in
                                      (("img", img), ("txt", txt), ("scale", scale))})
        for t in (img, txt, scale):
            t.grad = None
    (lp, gp), (ld, gd) = results["pallas"], results["dense"]
    whole, _, _ = grad_cosines({n: g.reshape(-1) for n, g in gp.items()},
                               {n: g.reshape(-1) for n, g in gd.items()})

    def fwd_bwd(fn):
        def run():
            fn(img, txt, labels, scale)["loss"].backward()
            for t in (img, txt, scale):
                t.grad = None
        return run

    ms = {key: cuda_ms(fwd_bwd(fn), 3) for key, fn in
          (("pallas", pl.pallas_multipositive_clip_loss), ("dense", multipositive_clip_loss))}
    ok = abs(lp - ld) <= 1e-4 * abs(ld) and whole >= 0.9999
    log(f"[kernel] pallas vs dense loss B={SUPCON_BIG} D={EMBED} fp32: loss {lp:.7f} vs {ld:.7f} "
        f"(rel {abs(lp - ld) / abs(ld):.2e}, tol 1e-4); gradient cosine {whole:.7f} (>= 0.9999); "
        f"forward+backward {ms['pallas']:.4f} ms (pallas) vs {ms['dense']:.4f} ms (dense) "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"the pallas loss disagrees with the dense one at B={SUPCON_BIG}")
    del img, txt, results, gp, gd
    torch.cuda.empty_cache()
    return {"loss_rel_err": abs(lp - ld) / abs(ld), "grad_cosine": whole,
            "pallas_fwd_bwd_ms": ms["pallas"], "dense_fwd_bwd_ms": ms["dense"]}


def dw_bound(b, h, w, c, k, dtype, backward=False):
    """K8: x read and y written once, the [K*K, C] fp32 table read; one
    multiply-add (2 operations, fp32) per tap and element. K9: x and dy read,
    dx written, the table read and dw written; two multiply-adds per tap and
    element (dx and dw)."""
    item = torch.tensor([], dtype=dtype).element_size()
    n, taps = b * h * w * c, k * k
    nbytes = item * n * (3 if backward else 2) + 4 * taps * c * (2 if backward else 1)
    return _bound(nbytes, (4 if backward else 2) * taps * n, torch.float32)


def dw_floor(b, h, w, c, k, backward=False):
    """The unfused floor of K8 (K9), ms: y (and dx) are held bit-equal to the
    plain versions, which round each product before adding it, so they take
    two FP32 instructions per tap and element, and K9's dw one more (FMA)."""
    return (3 if backward else 2) * k * k * b * h * w * c / FP32_INSTR_PER_S * 1e3


def phase_kernel_dw():
    """K8 and K9 against their plain versions on the card, bf16 and fp32,
    at MobileCLIP-S1's stage shapes (b32 and b256) and the edges; K9 twice
    on the same input for equal bits; timings at every stage shape beside
    the plain versions, the bounds, the unfused floors and cuDNN
    (`F.conv2d(groups=C)` on the channels-last view, bf16 weight: the 'xla'
    path's call), as event means and as the profiler's device time per call
    (at b32 the host issues a call more slowly than the card runs it), and
    the sums over the 73 convolutions of one MobileCLIP-S1 forward."""
    from mrclip_tpu_torch.ops import dw_conv as dc

    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(b, h, w, c, k, dtype, offset=0):
        """x, the table and dy; with `offset`, x and dy are contiguous views
        that many elements into their storage."""
        def image():
            flat = torch.randn(offset + b * h * w * c, device="cuda", generator=gen).to(dtype)
            return flat[offset:].view(b, h, w, c)
        x = image()
        w2 = torch.randn(k * k, c, device="cuda", generator=gen) * 0.2
        return x, w2, image()

    worst = {dt: [0.0, 0.0, 0.0] for dt in (torch.bfloat16, torch.float32)}
    shapes = [(b, *shape) for (shape, _) in DW_STAGES for b in (32, TRAIN_BATCH)] + DW_EDGES
    cases = [(shape, 0) for shape in shapes] + [(shape, 1) for shape in DW_OFFSET_VIEWS]
    for shape, offset in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x, w2, dy = inputs(*shape, dtype, offset)
            wide = dc._plan_for(x, shape[4], dy).wide
            y = dc.dw_conv_fwd(x, w2)
            dx, dw = dc.dw_conv_bwd(x, w2, dy)
            dx2, dw2 = dc.dw_conv_bwd(x, w2, dy)
            torch.cuda.synchronize()
            y_ref = dc.dw_conv_fwd_ref(x, w2)
            dx_ref, dw_ref = dc.dw_conv_bwd_ref(x, w2, dy)
            errs = [abs_err(y, y_ref), abs_err(dx, dx_ref), rel_err(dw, dw_ref)]
            same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
            ok = (all(bool(torch.isfinite(t.float()).all()) for t in (y, dx, dw)) and same
                  and max(errs[:2]) <= DW_TOL[dtype] and errs[2] <= DW_GRAD_TOL)
            log(f"[kernel] K8/K9 {shape} {str(dtype)[6:]}{f' offset {offset}' if offset else ''} "
                f"({'16-byte' if wide else 'element-wise'} copies): max|y-plain|={errs[0]:.3e} "
                f"max|dx-plain|={errs[1]:.3e} (tol {DW_TOL[dtype]}) max|dw-plain| / max|plain|="
                f"{errs[2]:.3e} (tol {DW_GRAD_TOL}); second K9 run bit-equal {same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"dw_conv kernels disagree with their plain versions at {shape} "
                                     f"{dtype}")
            worst[dtype] = [max(a, b) for a, b in zip(worst[dtype], errs)]
            del x, dy, y, dx, dx2, y_ref, dx_ref

    def timings(b, h, w, c, k):
        x, w2, dy = inputs(b, h, w, c, k, torch.bfloat16)
        xn = x.permute(0, 3, 1, 2)  # the NCHW view of NHWC: channels-last
        wt = w2.t().reshape(c, 1, k, k).to(torch.bfloat16)
        xg, wg = xn.detach().requires_grad_(), wt.detach().requires_grad_()

        def conv(a, b):
            return torch.nn.functional.conv2d(a, b, padding=k // 2, groups=c)

        fwd = dict(ms=cuda_ms(lambda: dc.dw_conv_fwd(x, w2), 10),
                   plain_ms=cuda_ms(lambda: dc.dw_conv_fwd_ref(x, w2), 3, warmup=1),
                   library_ms=cuda_ms(lambda: conv(xn, wt), 10))
        dyn = dy.permute(0, 3, 1, 2)
        both = cuda_ms(lambda: torch.autograd.grad(conv(xg, wg), (xg, wg), dyn), 10)
        bwd = dict(ms=cuda_ms(lambda: dc.dw_conv_bwd(x, w2, dy), 10),
                   plain_ms=cuda_ms(lambda: dc.dw_conv_bwd_ref(x, w2, dy), 3, warmup=1),
                   library_ms=both - fwd["library_ms"])
        dev = device_ms({"fwd": lambda: dc.dw_conv_fwd(x, w2),
                         "bwd": lambda: dc.dw_conv_bwd(x, w2, dy),
                         "lib": lambda: conv(xn, wt),
                         "lib_both": lambda: torch.autograd.grad(conv(xg, wg), (xg, wg), dyn)},
                        runs=3)
        fwd["device_ms"], bwd["device_ms"] = dev["fwd"], dev["bwd"]
        fwd["library_device_ms"] = dev["lib"]
        bwd["library_device_ms"] = (None if None in (dev["lib"], dev["lib_both"])
                                    else dev["lib_both"] - dev["lib"])
        fwd["bound_ms"], fwd["bound_by"] = dw_bound(b, h, w, c, k, torch.bfloat16)
        bwd["bound_ms"], bwd["bound_by"] = dw_bound(b, h, w, c, k, torch.bfloat16, backward=True)
        for name, t, back in (("K8", fwd, False), ("K9", bwd, True)):
            log(f"[kernel] {name} bf16 b{b} {(h, w, c)} K={k}: kernel {t['ms']:.4f} ms (device "
                f"{fmt_ms(t['device_ms'])}), plain {t['plain_ms']:.4f} ms, cuDNN "
                f"{t['library_ms']:.4f} ms (device {fmt_ms(t['library_device_ms'])}), bound "
                f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), unfused floor "
                f"{dw_floor(b, h, w, c, k, back) * 1e3:.2f} us (assumed clock, not measured)")
        return fwd, bwd

    fwd, bwd = {}, {}
    for b in (TRAIN_BATCH, 32):
        for shape, _ in DW_STAGES:
            fwd[b, shape], bwd[b, shape] = timings(b, *shape)

    def per_forward(table, b):
        """ms of the 73 convolutions of one forward at batch b, by key (None
        where the profiler gave no device time)."""
        out = {}
        for key in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                    "bound_ms"):
            vals = [table[b, shape][key] for shape, _ in DW_STAGES]
            out[key] = (None if None in vals
                        else sum(n * v for (_, n), v in zip(DW_STAGES, vals)))
        return out

    head = (TRAIN_BATCH, DW_STAGES[1][0])  # stage 0, 7x7, b256
    common = dict(route="cuda", source="mrclip_tpu_torch/csrc/dw_conv.cu", launches=None,
                  shape=f"MobileCLIP-S1 stage 0 b{TRAIN_BATCH} [64, 64, 64] K=7 bf16")
    entries = []
    for name, table, tpu, line, lib in (
            ("dw_conv_fwd", fwd, "_fwd_kernel (via _core_fwd :113)", 57,
             "F.conv2d(groups=C) forward, bf16, channels-last (cuDNN)"),
            ("dw_conv_bwd", bwd, "_bwd_kernel (via _core_bwd :128)", 75,
             "F.conv2d(groups=C) backward, dx and dw (fwd+bwd minus fwd; cuDNN)")):
        i = 0 if name == "dw_conv_fwd" else 1
        entries.append({
            "name": name,
            "replaces": f"mrclip_tpu/ops/dw_conv.py:{line}",
            "tpu_kernel": f"mrclip_tpu/ops/dw_conv.py::{tpu}",
            "max_abs_err": worst[torch.bfloat16][i],
            "max_abs_err_fp32": worst[torch.float32][i],
            **({} if i == 0 else {"dw_max_rel_err": worst[torch.bfloat16][2],
                                  "dw_max_rel_err_fp32": worst[torch.float32][2],
                                  "dw_rel_err_is": "max |kernel - plain| / max |plain| of dw"}),
            **common, **table[head],
            "library": lib,
            "by_shape": {f"b{b} {shape[:3]} K={shape[3]}": t for (b, shape), t in table.items()},
            "per_forward_b256": per_forward(table, TRAIN_BATCH),
            "per_forward_b32": per_forward(table, 32),
        })
    for e, tag, back in zip(entries, ("K8", "K9"), (False, True)):
        floors = [sum(n * dw_floor(b, *shape, back) for shape, n in DW_STAGES)
                  for b in (TRAIN_BATCH, 32)]
        log(f"[kernel] {tag} over the 73 convolutions of one MobileCLIP-S1 forward at "
            f"b{TRAIN_BATCH}: " + json.dumps(e["per_forward_b256"]) + f"; b32: "
            + json.dumps(e["per_forward_b32"]) + f"; unfused floor (assumed clock, not "
            f"measured) b{TRAIN_BATCH} {floors[0]:.4f} ms, b32 {floors[1]:.4f} ms")
    return entries


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
    from mrclip_tpu_torch.ops import dw_conv as dc
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa
    from mrclip_tpu_torch.ops import pallas_loss as pl

    return {"packed_attn_fwd": fa.launches, "packed_attn_bwd": fa.bwd_launches,
            "packed_attn_rope_fwd": fa.rope_launches,
            "packed_attn_rope_bwd": fa.rope_bwd_launches,
            "grouped_attn_fwd": fa.grouped_launches, "grouped_attn_bwd": fa.grouped_bwd_launches,
            "flash_attn_fwd": fl.launches, "flash_attn_bwd": fl.bwd_launches, **pl.launches,
            **dc.launches}


def reset_counts():
    from mrclip_tpu_torch.ops import dw_conv as dc
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa
    from mrclip_tpu_torch.ops import pallas_loss as pl

    fa.reset_launches()
    fl.reset_launches()
    pl.reset_launches()
    dc.reset_launches()


def build_model(name, dw_impl="pallas", **kw):
    """`create_model(name, **kw)` with MRCLIP_DW_IMPL set to `dw_impl`:
    DepthwiseConv reads it when it is built (it has no effect on the towers
    without depthwise convolutions)."""
    from mrclip_tpu_torch.factory import create_model

    os.environ["MRCLIP_DW_IMPL"] = dw_impl
    return create_model(name, **kw)


def phase_serve_mobileclip(entries, card):
    """MobileCLIP-S1 through the serving entry points with
    MRCLIP_DW_IMPL=pallas: export, load, `encode_image` at b32 and b256
    (256 x 256) and `encode_text` at b256 through `ServedModel`; 73 K8 and 4
    K1 launches per image call, 12 K1 per text call; features against the
    same weights on cuDNN's convolution and plain attention; throughput
    under both convolution choices (the same attention)."""
    from mrclip_tpu_torch import SimpleTokenizer
    from mrclip_tpu_torch.serving import ServedModel, export_model, load_exported, save_exported

    t0 = time.perf_counter()
    model = build_model("MobileCLIP-S1", "pallas", precision="bf16", attn_impl="fusedp", rng_seed=0)
    exported = export_model(model)
    del model
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "mobileclip_s1.mrclip")
    save_exported(exported, path)
    # the artifact's dw_impl ('pallas') decides, not the serving process's
    # variable: the K8 launch counts below show it
    os.environ["MRCLIP_DW_IMPL"] = "xla"
    served = load_exported(path)
    weights = exported.state_dict
    plain = build_model("MobileCLIP-S1", "xla", pretrained=weights, precision="bf16", attn_impl="xla")
    conv = ServedModel(build_model("MobileCLIP-S1", "xla", pretrained=weights, precision="bf16",
                                   attn_impl="fusedp"), served.meta)
    embed, ctx = served.meta["model_cfg"]["embed_dim"], served.meta["context_length"]
    size = served.meta["image_size"][0]
    log(f"[serve-mobileclip] MobileCLIP-S1 built, exported ({os.path.getsize(path) / 1e6:.1f} MB) "
        f"and loaded in {time.perf_counter() - t0:.1f} s; {size} x {size} px, context {ctx}")
    rng = np.random.RandomState(4)
    images = rng.randn(TRAIN_BATCH, size, size, 3).astype(np.float32)
    tokens = np.resize(SimpleTokenizer(context_length=ctx)(CAPTIONS), (TRAIN_BATCH, ctx))

    reset_counts()  # the MobileCLIP served main path starts here
    calls, feats = [], {}
    for key, enc, arg in (("image_b32", served.encode_image, images[:32]),
                          ("image_b256", served.encode_image, images),
                          ("text_b256", served.encode_text, tokens)):
        before = launch_counts()
        feats[key] = unit_rows(enc(arg), len(arg), embed)
        calls.append({k: v - before[k] for k, v in launch_counts().items() if v != before[k]})
    main_path = launch_counts()  # read right after the served run
    want = [{"packed_attn_fwd": 4, "dw_conv_fwd": 73}] * 2 + [{"packed_attn_fwd": 12}]
    log(f"[serve-mobileclip] launches per call (image b32, image b256, text b256): {calls} "
        f"(want {want}) {'ok' if calls == want else 'FAIL'}")
    if calls != want:
        raise AssertionError("the MobileCLIP served path did not launch K8 73 times and K1 4 "
                             "times per image call and K1 12 times per text call")

    with torch.inference_mode():
        ref_img = plain.encode_image(torch.from_numpy(images[:32]).cuda(), normalize=True)
        ref_txt = plain.encode_text(torch.from_numpy(tokens).cuda(), normalize=True)
    cos_img = cosine_rows(feats["image_b32"], ref_img.float().cpu().numpy()).min()
    cos_256 = cosine_rows(feats["image_b256"][:32], feats["image_b32"]).min()
    cos_txt = cosine_rows(feats["text_b256"], ref_txt.float().cpu().numpy()).min()
    ok = min(cos_img, cos_txt, cos_256) >= 0.999
    log(f"[serve-mobileclip] served (K8, K1) vs cuDNN convolution and plain attention, same "
        f"weights: min cosine image {cos_img:.6f}, text {cos_txt:.6f}; image b256 vs b32 rows "
        f"{cos_256:.6f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("MobileCLIP served features disagree with the plain model")

    perf = {}
    for name, srv in (("pallas", served), ("xla", conv)):
        for bsz in (32, 256):
            srv.encode_image(images[:bsz])
            t = time.perf_counter()
            for _ in range(3):
                srv.encode_image(images[:bsz])
            perf[f"served_encode_image_b{bsz}_imgs_per_s_{name}"] = bsz * 3 / (time.perf_counter() - t)
    t = time.perf_counter()
    for _ in range(3):
        served.encode_text(tokens)
    perf["served_encode_text_b256_texts_per_s"] = TRAIN_BATCH * 3 / (time.perf_counter() - t)
    x256 = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        for name, m in (("pallas", served.model), ("xla", conv.model), ("xla_plain_attention", plain)):
            perf[f"device_encode_image_b256_ms_{name}"] = cuda_ms(
                lambda: m.encode_image(x256, normalize=True), 3, warmup=1)
    perf["k8_share_b256"] = (entries["dw_conv_fwd"]["per_forward_b256"]["ms"]
                             / perf["device_encode_image_b256_ms_pallas"])
    log(f"[serve-mobileclip] throughput on {card}: " + json.dumps(perf))
    tmp.cleanup()
    del served, conv, plain, x256
    torch.cuda.empty_cache()
    return main_path, perf


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
# the flash instantiations of the row and tensor-core kernels carry the
# template flag `true` in their names (the wgmma kernels' flags are FLASH,
# then ROPE: K2's group comes before K1/K4's, and K10b's and K3r's before
# K3/K5's, whose "mma_bwd_" every wgmma_bwd_ name holds); phase 3 asserts
# where K2, K3, K3r, K5 and K10b land.
K2_GROUP = "K2 packed_attn_rope_fwd"
K10B_GROUP = "K10b flash_attn_bwd"
K3R_GROUP = "K3r packed_attn_rope_bwd"
K3_GROUP = "K3 packed_attn_bwd / K5 grouped_attn_bwd"
KERNEL_GROUPS = [
    ("K8 dw_conv_fwd", ("dw_fwd_kernel",)),
    ("K9 dw_conv_bwd", ("dw_bwd_kernel", "dw_wgrad_sum_kernel")),
    ("convolution (cuDNN: stem, downsamples)", ("convolution", "cudnn", "fprop", "dgrad",
                                                "wgrad", "conv2d", "depthwise")),
    (K2_GROUP, ("wgmma_fwd_kernel<false, true", "mma_fwd_kernel<64, false, false, true>",
                "packed_attn_fwd_kernel<64, true>")),
    ("K10 flash_attn_fwd", ("wgmma_fwd_kernel<true, ", "mma_fwd_kernel<64, true",
                            "rows_fwd_kernel<float, 64, true>")),
    # one instantiation: K1 under fusedp, K4 under fused
    ("K1 packed_attn_fwd / K4 grouped_attn_fwd", ("wgmma_fwd_kernel", "mma_fwd_kernel",
                                                  "rows_fwd_kernel", "packed_attn_fwd")),
    (K10B_GROUP, ("wgmma_bwd_dq_kernel<true", "wgmma_bwd_dkv_kernel<true",
                  "mma_bwd_dq_kernel<64, true", "mma_bwd_dkv_kernel<64, true",
                  "rows_bwd_dq_kernel<float, 64, true>", "rows_bwd_dkv_kernel<float, 64, true>")),
    (K3R_GROUP, ("wgmma_bwd_dq_kernel<false, true", "wgmma_bwd_dkv_kernel<false, true",
                 "mma_bwd_dq_kernel<64, false, false, true>",
                 "mma_bwd_dkv_kernel<64, false, false, true>",
                 "mma_bwd_dq_kernel<64, false, true, true>",  # past 256 rows
                 "mma_bwd_dkv_kernel<64, false, true, true>",
                 "attn_bwd_dq_kernel<64, true>", "attn_bwd_dkv_kernel<64, true>")),
    # the rest of the tensor-core and FMA backward: one bf16 instantiation,
    # K3 under fusedp, K5 under fused
    (K3_GROUP, ("mma_bwd_", "rows_bwd_", "attn_bwd_dq", "attn_bwd_dkv")),
    ("K6/K7 supcon", ("supcon_",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("other (elementwise, norms, reductions, copies)", ("",)),
]


def kernel_group(name):
    """The KERNEL_GROUPS group of a device kernel's name."""
    low = name.lower()
    return next(g for g, keys in KERNEL_GROUPS if any(k in low for k in keys))


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
        groups[kernel_group(ev.key)] += ms
    busy = sum(groups.values())
    if busy == 0:
        log(f"{tag} profiler recorded no device time: breakdown by kernel not measured")
        return {}
    log(f"{tag} profiled step: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}; by group (ms): "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in groups.items()))
    for ms, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"{tag}   {ms:9.3f} ms  x{count:<5d} {key[:110]}")
    other = KERNEL_GROUPS[-1][0]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "groups_ms": groups,
            "kernels_in_other": [key for _, _, key in kernels if kernel_group(key) == other]}


# The train main path of each (model, attn_impl): the attention kernels'
# exact launches per dense step (one per attention layer per direction;
# 'flash' launches K10 again in the backward) and which parameters are the
# attention's input projections.
VIT_PROJ = ("attn.in_proj_weight",)
EVA_PROJ = ("attn.q_proj.weight", "attn.k_proj.weight", "attn.v_proj.weight")
DW_WEIGHTS = ("mixer_dw.weight", "ffn.conv_dw.weight", "pos_emb_dw.weight")
# `weights`: the parameters whose gradient comes through the path's kernels;
# `plain`: the (attn_impl, MRCLIP_DW_IMPL) of the step it is held against
TRAIN_PATHS = {
    ("ViT-B-16", "fusedp"): dict(per_step={"packed_attn_fwd": 24, "packed_attn_bwd": 24},
                                 weights=VIT_PROJ, plain=("xla", "pallas")),
    ("EVA02-B-16", "fusedp"): dict(per_step={"packed_attn_rope_fwd": 12, "packed_attn_fwd": 12,
                                             "packed_attn_rope_bwd": 12, "packed_attn_bwd": 12},
                                   weights=EVA_PROJ, plain=("xla", "pallas")),
    ("ViT-B-16", "fused"): dict(per_step={"grouped_attn_fwd": 24, "grouped_attn_bwd": 24},
                                weights=VIT_PROJ, plain=("xla", "pallas")),
    ("EVA02-B-16", "flash"): dict(per_step={"flash_attn_fwd": 48, "flash_attn_bwd": 24},
                                  weights=EVA_PROJ, plain=("xla", "pallas")),
    # bench.py's attention for MobileCLIP-S1 ('bf16': plain), held against
    # cuDNN's convolution
    ("MobileCLIP-S1", "bf16"): dict(per_step={"dw_conv_fwd": 73, "dw_conv_bwd": 73},
                                    weights=DW_WEIGHTS, plain=("bf16", "xla")),
}
PALLAS_STEP = {"supcon_stats": 2, "supcon_grad_q": 2, "supcon_grad_k": 2}


def kernel_ms_per_step(model_name, attn_impl, entries):
    """Each attention kernel's device ms in one step of `model_name` under
    `attn_impl` at b256, from the phase 3 timings at the step's shapes."""
    if model_name == "MobileCLIP-S1":  # the 73 convolutions; attention 'bf16' is plain
        return {"K8": entries["dw_conv_fwd"]["per_forward_b256"]["ms"],
                "K9": entries["dw_conv_bwd"]["per_forward_b256"]["ms"]}
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
    from mrclip_tpu_torch.ops import pallas_loss as pl
    from mrclip_tpu_torch.ops.image_ops import normalize_images
    from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                           make_loss_apply)
    from mrclip_tpu_torch.parallel.train_step import loss_and_grads

    tag = ("[train]" if model_name == "ViT-B-16" else "[train-eva02]")
    if attn_impl != "fusedp":
        tag = f"[train-{attn_impl}]"
    if model_name == "MobileCLIP-S1":
        tag = "[train-mobileclip]"
    spec = TRAIN_PATHS[model_name, attn_impl]
    plain_attn, plain_dw = spec["plain"]
    t0 = time.perf_counter()
    model = build_model(model_name, "pallas", precision="bf16", attn_impl=attn_impl,
                        gelu_approx=True, rng_seed=0)
    size = model.visual.image_size[0]
    tx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = create_train_state(model, tx)
    args = dict(multipositiveloss=True, delta=0.5, model=model_name, gather_with_grad=True)
    dense = make_loss_apply(create_loss(SimpleNamespace(**args, pallas_loss=False)))
    pallas = make_loss_apply(create_loss(SimpleNamespace(**args, pallas_loss=True)))
    rng = np.random.RandomState(0)
    ctx = model.context_length
    batch = {  # uint8 canvases as the loader ships them; normalised inside the step
        "images": torch.from_numpy(rng.randint(0, 256, (TRAIN_BATCH, size, size, 3)).astype(np.uint8)).cuda(),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (TRAIN_BATCH, ctx)).astype(np.int64)).cuda(),
        "labels": torch.from_numpy(rng.randint(0, 32, (TRAIN_BATCH,)).astype(np.int32)).cuda(),
    }

    def prep(b):
        return dict(b, images=normalize_images(b["images"]))

    n_params = sum(p.numel() for p in state.params.values())
    log(f"{tag} {model_name} ({n_params / 1e6:.1f} M params), attn_impl={attn_impl!r}, AdamW "
        f"bf16 mu, batch {TRAIN_BATCH}, {size} x {size} px, context {ctx}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # checks at the initial weights (their launches are not the main path's)
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    g_kernel, l_kernel = loss_and_grads(model, dense, state.params, prep(batch))
    plain = build_model(model_name, plain_dw, pretrained=weights, precision="bf16",
                        attn_impl=plain_attn, gelu_approx=True)
    g_plain, l_plain = loss_and_grads(plain, dense, dict(plain.named_parameters()), prep(batch))
    del plain
    lk, lp = l_kernel["loss"].item(), l_plain["loss"].item()
    whole, worst, worst_name = grad_cosines(g_kernel, g_plain)
    del g_plain
    torch.cuda.empty_cache()
    through = [n for n in g_kernel if n.endswith(spec["weights"])]
    dead = [n for n in through if g_kernel[n].abs().max().item() == 0]
    ok = (np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp) and whole >= 0.999 and worst >= 0.99
          and through and not dead)
    log(f"{tag} kernel path vs plain (attn_impl={plain_attn!r}, MRCLIP_DW_IMPL={plain_dw!r}), "
        f"same weights and batch: loss {lk:.6f} vs {lp:.6f} (rel {abs(lk - lp) / abs(lp):.2e}, "
        f"tol 1e-2); gradient cosine whole {whole:.6f} (>= 0.999), min per tensor >= 1e4 "
        f"elements {worst:.6f} at {worst_name} (>= 0.99, bf16 through the tower); "
        f"{len(through) - len(dead)}/{len(through)} weights behind the kernels "
        f"({', '.join(spec['weights'])}) with a gradient {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the kernel train step's gradients disagree with the plain step")

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
    if profile and "dw_conv_fwd" in spec["per_step"]:
        # the depthwise kernels in their own groups, none of them in "other"
        stray = [key for key in profile["kernels_in_other"] if "dw_" in key.lower()]
        dw_ms = [profile["groups_ms"][g] for g in ("K8 dw_conv_fwd", "K9 dw_conv_bwd")]
        log(f"{tag} profiled K8 / K9 groups {dw_ms[0]:.2f} / {dw_ms[1]:.2f} ms; depthwise "
            f"kernels in 'other': {stray}")
        if min(dw_ms) <= 0 or stray:
            raise AssertionError(f"{tag} the profiler did not put K8 and K9 in their groups")
    baseline = {}
    if plain_dw == "xla":  # the same step on cuDNN's convolution, same attention and weights
        base = build_model(model_name, "xla", pretrained=weights, precision="bf16",
                           attn_impl=attn_impl, gelu_approx=True)
        base_state = create_train_state(base, tx)
        base_step = build_train_step(base, dense, tx)
        base_state, _ = base_step(base_state, prep(batch))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(timed):
            base_state, _ = base_step(base_state, prep(batch))
        torch.cuda.synchronize()
        baseline = {"train_step_ms_xla_conv": (time.perf_counter() - t) / timed * 1e3}
        del base, base_state, base_step
        torch.cuda.empty_cache()
    perf = {
        "train_step_ms": step_ms,
        "train_pairs_per_s": TRAIN_BATCH / step_ms * 1e3,
        "peak_memory_gb": peak_gb,
        **{f"{k.lower()}_ms_per_step": v for k, v in kernel_ms.items()},
        **{f"{k.lower()}_share": v / step_ms for k, v in kernel_ms.items()},
        "dense_loss_fwd_bwd_ms": dense_ms, "pallas_loss_fwd_bwd_ms": pallas_ms,
        "normalize_ms": norm_ms, "optimizer_ms": opt_ms,
        "rest_gemm_elementwise_ms": rest,
        **baseline,
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


# Phase 12: MR-CLIP's other objectives on the ViT-B-16 'fusedp' b256 step,
# with the frozen temperature and text dropout. Each path: its loss flags,
# the kernels' exact launches per step, and how many steps (one warm-up and
# three timed for the distance loss, one checked step for each other)
OBJECTIVE_PATHS = {
    "train_distance": dict(flags=dict(multipositiveloss=True, distance=True, delta=0.5),
                           per_step={"packed_attn_fwd": 24, "packed_attn_bwd": 24}),
    # image-only (build_vision_only_step; the flags name its loss): the
    # vision tower's 12 layers, each way
    "train_vision_only": dict(flags=dict(multipositiveloss=True, visiononly=True),
                              per_step={"packed_attn_fwd": 12, "packed_attn_bwd": 12}),
    "train_lam": dict(flags=dict(lam=0.3), per_step={"packed_attn_fwd": 24, "packed_attn_bwd": 24}),
    "train_siglip": dict(flags=dict(siglip=True),
                         per_step={"packed_attn_fwd": 24, "packed_attn_bwd": 24}),
    # the frozen teacher's forward: 24 K1 more, no K3
    "train_distill": dict(flags=dict(distill=True),
                          per_step={"packed_attn_fwd": 48, "packed_attn_bwd": 24}),
}
TEXT_DROPOUT = 0.1
DISTANCE_TIMED = 3


def objective_loss(apply, feats, batch, device, dtype):
    """The loss `apply` (a `make_loss_apply` of the path's `create_loss`)
    on captured model outputs `feats` and the batch, every float tensor
    moved to `device` in `dtype`."""
    def move(t):
        return t.detach().to(device, dtype if t.is_floating_point() else None)

    return apply({k: move(v) for k, v in feats.items()},
                 {k: move(v) for k, v in batch.items()})["loss"]


def phase_chunked_loss_big(gen):
    """The chunked multipositive loss (ops/fused_loss.py, 1024-key chunks)
    forward+backward at B = SUPCON_BIG, D = EMBED against the dense loss on
    the same inputs: loss within 1e-4 relative, gradient cosine (features
    and scale) >= 0.9999; each of the chunked, dense and pallas losses timed
    (event mean of 3) with its peak memory above what was allocated before
    the call; the chunked loss's peak must be the dense loss's or less."""
    from mrclip_tpu_torch.losses import multipositive_clip_loss
    from mrclip_tpu_torch.ops import pallas_loss as pl
    from mrclip_tpu_torch.ops.fused_loss import chunked_multipositive_clip_loss

    img, txt, labels, _, _ = supcon_inputs(SUPCON_BIG, 32, gen)
    img, txt = img.requires_grad_(), txt.requires_grad_()
    scale = torch.tensor(1 / 0.07, device="cuda", requires_grad=True)
    fns = {"chunked": chunked_multipositive_clip_loss, "dense": multipositive_clip_loss,
           "pallas": pl.pallas_multipositive_clip_loss}
    results, peak, ms = {}, {}, {}

    def fwd_bwd(fn):
        def run():
            loss = fn(img, txt, labels, scale)["loss"]
            loss.backward()
            for t in (img, txt, scale):
                t.grad = None
            return loss
        return run

    for key, fn in fns.items():
        loss = fn(img, txt, labels, scale)["loss"]
        loss.backward()
        results[key] = (loss.item(), {n: t.grad.clone() for n, t in
                                      (("img", img), ("txt", txt), ("scale", scale))})
        for t in (img, txt, scale):
            t.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_bwd(fn)()
        torch.cuda.synchronize()
        peak[key] = (torch.cuda.max_memory_allocated() - base) / 1e6
        ms[key] = cuda_ms(fwd_bwd(fn), 3)
    (lc, gc), (ld, gd) = results["chunked"], results["dense"]
    whole, _, _ = grad_cosines({n: g.reshape(-1) for n, g in gc.items()},
                               {n: g.reshape(-1) for n, g in gd.items()})
    ok = abs(lc - ld) <= 1e-4 * abs(ld) and whole >= 0.9999 and peak["chunked"] <= peak["dense"]
    log(f"[objectives] chunked vs dense loss B={SUPCON_BIG} D={EMBED} fp32: loss {lc:.7f} vs "
        f"{ld:.7f} (rel {abs(lc - ld) / abs(ld):.2e}, tol 1e-4); gradient cosine {whole:.7f} "
        f"(>= 0.9999); forward+backward ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + "; peak memory MB " + ", ".join(f"{k} {v:.1f}" for k, v in peak.items())
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"the chunked loss disagrees with the dense one at B={SUPCON_BIG} "
                             "or needs more memory")
    del img, txt, results, gc, gd
    torch.cuda.empty_cache()
    return {"loss_rel_err": abs(lc - ld) / abs(ld), "grad_cosine": whole,
            **{f"{k}_fwd_bwd_ms": v for k, v in ms.items()},
            **{f"{k}_peak_mb": v for k, v in peak.items()}}


def phase_objectives(entries, card):
    """Phase 12: full-width ViT-B-16 (bf16 compute, fp32 params, 'fusedp',
    tanh GELU) at b256 with MR-CLIP's frozen temperature
    (logit_scale_trainable=False, ln 10) and text dropout 0.1, trained with
    the other objectives; TE/TR from the labels as the JAX package's
    synthetic data makes them. Returns ({path: launches}, {path: per-step
    launches}, perf)."""
    from types import SimpleNamespace

    from mrclip_tpu_torch import create_loss
    from mrclip_tpu_torch.ops.image_ops import normalize_images
    from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                           make_loss_apply)
    from mrclip_tpu_torch.parallel.train_step import loss_and_grads
    from mrclip_tpu_torch.train import build_vision_only_step

    tag = "[objectives]"
    opts = dict(precision="bf16", attn_impl="fusedp", gelu_approx=True,
                logit_scale_trainable=False, text_dropout=TEXT_DROPOUT)
    t0 = time.perf_counter()
    model = build_model("ViT-B-16", "pallas", rng_seed=0, **opts)
    tx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = create_train_state(model, tx)
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 32, (TRAIN_BATCH,)).astype(np.int32)
    batch = {  # uint8 canvases, normalised inside the step; TE/TR (s) from the labels
        "images": torch.from_numpy(rng.randint(0, 256, (TRAIN_BATCH, 224, 224, 3)).astype(np.uint8)).cuda(),
        "tokens": torch.from_numpy(rng.randint(1, 49408, (TRAIN_BATCH, model.context_length)).astype(np.int64)).cuda(),
        "labels": torch.from_numpy(labels).cuda(),
        "echo_time": torch.from_numpy((0.01 * (labels + 1)).astype(np.float32)).cuda(),
        "repetition_time": torch.from_numpy((0.5 * (labels + 1)).astype(np.float32)).cuda(),
    }

    def prep(b):
        return dict(b, images=normalize_images(b["images"]))

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def apply_of(path):
        return make_loss_apply(create_loss(SimpleNamespace(
            model="ViT-B-16", gather_with_grad=True, **OBJECTIVE_PATHS[path]["flags"])))

    frozen = model.logit_scale.clone()
    log(f"{tag} ViT-B-16 b{TRAIN_BATCH} 'fusedp', logit_scale_trainable=False "
        f"(exp {frozen.exp().item():.6f}), text_dropout={TEXT_DROPOUT}, built in "
        f"{time.perf_counter() - t0:.1f} s; logit_scale among the params: "
        f"{'logit_scale' in state.params}")
    if "logit_scale" in state.params or "logit_scale" in state.opt_state.mu:
        raise AssertionError("the frozen temperature is among the trained parameters")

    # checks at the initial weights (their launches are not the main path's):
    # the distance step's gradients against plain attention, the same
    # weights and the same dropout masks (the same generator seed)
    dist_apply = apply_of("train_distance")
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    g_kernel, l_kernel = loss_and_grads(model, dist_apply, state.params, prep(batch), gen(0))
    plain = build_model("ViT-B-16", "pallas", pretrained=weights,
                        **dict(opts, attn_impl="xla"))
    g_plain, l_plain = loss_and_grads(plain, dist_apply, dict(plain.named_parameters()),
                                      prep(batch), gen(0))
    del plain
    lk, lp = l_kernel["loss"].item(), l_plain["loss"].item()
    whole, worst, worst_name = grad_cosines(g_kernel, g_plain)
    through = [n for n in g_kernel if n.endswith(VIT_PROJ)]
    dead = [n for n in through if g_kernel[n].abs().max().item() == 0]
    del g_kernel, g_plain
    torch.cuda.empty_cache()
    ok = (np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp) and whole >= 0.999 and worst >= 0.99
          and through and not dead)
    log(f"{tag} distance loss, kernel path vs plain attention, same weights, batch and dropout "
        f"masks: loss {lk:.6f} vs {lp:.6f} (rel {abs(lk - lp) / abs(lp):.2e}, tol 1e-2); "
        f"gradient cosine whole {whole:.6f} (>= 0.999), min per tensor {worst:.6f} at "
        f"{worst_name} (>= 0.99); {len(through) - len(dead)}/{len(through)} in_proj weights with "
        f"a gradient {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the distance step's gradients disagree with the plain step")
    # text dropout: the masks follow the generator
    with torch.no_grad():
        model.train()
        drops = [dist_apply(model(prep(batch)["images"], batch["tokens"], generator=gen(s)),
                            batch)["loss"].item() for s in (5, 5, 6)]
    ok = drops[0] == drops[1] != drops[2]
    log(f"{tag} text dropout {TEXT_DROPOUT} from a CUDA generator: losses {drops} (seeds 5, 5, 6; "
        f"equal, equal, different) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the text dropout does not follow the step's generator")

    paths, per_step, checks, perf = {}, {}, {}, {}
    teacher = None

    def run(path, step_fn, steps, timed=0):
        """`steps` steps of the path with the counts set to 0 before and read
        after; the model outputs of the last step captured by forward hooks
        (the student's and, for distill, the teacher's)."""
        nonlocal state
        seen = {}
        hooks = [model.register_forward_hook(lambda m, i, o: seen.update(o))]
        if teacher is not None:
            hooks.append(teacher.register_forward_hook(
                lambda m, i, o: seen.update({f"dist_{k}": v for k, v in o.items()})))
        reset_counts()
        wants, got, losses, times = [], [], [], []
        for i in range(steps):
            before = launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step_fn(state, prep(batch), gen(100 + i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            got.append({k: v - before[k] for k, v in launch_counts().items() if v != before[k]})
            wants.append(OBJECTIVE_PATHS[path]["per_step"])
            losses.append(metrics["loss"].item())
        paths[path] = launch_counts()  # read right after the path
        per_step[path] = OBJECTIVE_PATHS[path]["per_step"]
        for h in hooks:
            h.remove()
        apply = apply_of(path)
        card_loss = objective_loss(apply, seen, batch, batch["labels"].device, torch.float32).item()
        ref = objective_loss(apply, seen, batch, "cpu", torch.float64).item()
        rel = abs(card_loss - ref) / abs(ref)
        ok = (all(np.isfinite(losses)) and got == wants and rel <= 1e-4
              and abs(losses[-1] - card_loss) <= 1e-4 * abs(ref))
        log(f"{tag} {path}: {steps} step(s), losses {', '.join(f'{x:.6f}' for x in losses)}; "
            f"launches per step {got} (want {wants}); the last step's loss on its own outputs: "
            f"card fp32 {card_loss:.7f}, CPU float64 {ref:.7f} (rel {rel:.2e}, tol 1e-4) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} the {path} path failed its checks")
        checks[path] = {"losses": losses, "loss_rel_err_vs_float64": rel}
        return times[-timed:] if timed else times

    # the distance main path: one warm-up and DISTANCE_TIMED timed steps
    times = run("train_distance", build_train_step(model, dist_apply, tx), 1 + DISTANCE_TIMED,
                timed=DISTANCE_TIMED)
    step_ms = statistics.mean(times)
    ok = torch.equal(model.logit_scale, frozen) and "logit_scale" not in state.opt_state.mu
    log(f"{tag} logit_scale after {state.step} steps: exp {model.logit_scale.exp().item():.6f}, "
        f"unchanged {torch.equal(model.logit_scale, frozen)}, no moments "
        f"{'logit_scale' not in state.opt_state.mu} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the frozen temperature moved or has moments")
    phase5 = entries["packed_attn_fwd"].get("training", {}).get("train_step_ms")
    perf["distance_step_ms"] = step_ms
    perf["distance_step_ms_readings"] = times
    perf["distance_pairs_per_s"] = TRAIN_BATCH / step_ms * 1e3
    perf["phase5_dense_step_ms"] = phase5
    log(f"{tag} distance step b{TRAIN_BATCH}: {step_ms:.2f} ms mean of {DISTANCE_TIMED} "
        f"(readings {', '.join(f'{x:.2f}' for x in times)}), {perf['distance_pairs_per_s']:.1f} "
        f"pairs/s; phase 5's dense step {fmt_ms(phase5)} ms | {card}")

    run("train_vision_only", build_vision_only_step(model, tx), 1)
    run("train_lam", build_train_step(model, apply_of("train_lam"), tx), 1)

    # distill: a second ViT-B-16 (seed 1) as the frozen teacher
    teacher = build_model("ViT-B-16", "pallas", rng_seed=1, **opts)
    run("train_distill", build_train_step(model, apply_of("train_distill"), tx, teacher=teacher), 1)
    teacher = None
    del model, state
    torch.cuda.empty_cache()

    # SigLIP on a model with a learned bias (init -10)
    model = build_model("ViT-B-16", "pallas", rng_seed=0, init_logit_bias=-10.0, **opts)
    state = create_train_state(model, tx)
    bias0 = model.logit_bias.item()
    run("train_siglip", build_train_step(model, apply_of("train_siglip"), tx), 1)
    mu = state.opt_state.mu["logit_bias"].float().abs().item()
    ok = mu > 0 and model.logit_bias.item() != bias0
    log(f"{tag} SigLIP logit_bias {bias0:.6f} -> {model.logit_bias.item():.6f}, first moment "
        f"{mu:.3e} (its gradient reached it) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the SigLIP bias got no gradient")
    del model, state
    torch.cuda.empty_cache()

    perf["chunked_loss_b8192"] = phase_chunked_loss_big(torch.Generator(device="cuda").manual_seed(12))
    perf["checks"] = checks
    log(f"{tag} breakdown: " + json.dumps(perf))
    return paths, per_step, perf


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
                                      *phase_kernel_flash(), *phase_kernel_dw()]}
    fwd, rope_fwd = entries["packed_attn_fwd"], entries["packed_attn_rope_fwd"]
    k4, k10, k8 = entries["grouped_attn_fwd"], entries["flash_attn_fwd"], entries["dw_conv_fwd"]
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
    paths["serve_mobileclip"], k8["serving"] = phase_serve_mobileclip(entries, smi)
    paths["train_mobileclip"], per_step["train_mobileclip"], k8["training"] = phase_train(
        "MobileCLIP-S1", entries, smi, attn_impl="bf16", timed=3)
    obj_paths, obj_per_step, fwd["objectives"] = phase_objectives(entries, smi)
    paths.update(obj_paths)
    per_step.update(obj_per_step)
    # every kernel of a path launched on it (the exact counts are checked inside)
    expected = {"serve": ["packed_attn_fwd"],
                "train": [*TRAIN_PATHS["ViT-B-16", "fusedp"]["per_step"], *PALLAS_STEP],
                "serve_eva02": ["packed_attn_rope_fwd", "packed_attn_fwd"],
                "train_eva02": [*TRAIN_PATHS["EVA02-B-16", "fusedp"]["per_step"], *PALLAS_STEP],
                "train_fused": [*TRAIN_PATHS["ViT-B-16", "fused"]["per_step"]],
                "serve_fused": ["grouped_attn_fwd"],
                "train_flash": [*TRAIN_PATHS["EVA02-B-16", "flash"]["per_step"]],
                "serve_flash": ["flash_attn_fwd"],
                "serve_mobileclip": ["dw_conv_fwd", "packed_attn_fwd"],
                "train_mobileclip": [*TRAIN_PATHS["MobileCLIP-S1", "bf16"]["per_step"],
                                     *PALLAS_STEP],
                **{path: [*spec["per_step"]] for path, spec in OBJECTIVE_PATHS.items()}}
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
