#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mrclip_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:
  1. card:   name, power limit, PyTorch and CUDA versions, TF32 off for fp32
             products;
  2. build:  every CUDA source in `mrclip_tpu_torch/csrc` (one nvcc each, all
             started together; `png_unfilter.cu` is host code), with
             registers and spills from ptxas for every instantiation, and
             the instantiations that spill;
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
             on wgmma_long_fwd_kernel at N = 577, K2 on wgmma_fwd_kernel's ROPE form
             at N <= 256 and on mma_fwd_kernel at N = 257 and 577; bf16
             K3/K3r (and K5) on attn_mma_bwd.cuh's wgmma_bwd_* at D = 64
             with N and Nk <= 256, K3, K5 on its wgmma_wide_bwd_* at N =
             257, on its wgmma_long_bwd_* at N = 577 and Nk = 300, on its
             mma_bwd_* at N = 257 causal and D = 32, by the route
             `bwd_route` names, K10b on wgmma_bwd_*'s FLASH form at the
             vision, N = 256 and causal ctx 77 shapes, on wgmma_wide_bwd_*
             at N = 257 and on wgmma_long_bwd_* at N = 577,
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
             577 on wgmma_long_fwd_kernel; K10b as above),
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
 13. cli:    MR-CLIP's own main path from MRI volumes: 40 synthetic NIfTI
             volumes (208 x 192 x 222 int16, the port's writer) with BIDS
             sidecars over five protocols go through `python -m
             mrclip_tpu_torch.preprocessing` slices, captions, label and
             split (row counts, labels in range, disjoint volumes); the PNG
             decode (the compiled unfilter) and host transform rates; then
             `python -m mrclip_tpu_torch.train.main` trains full-width
             ViT-B-16 at 224 px, b256, `fusedp` + `--pallas-loss
             --multipositiveloss`, csv, amp, for 1 epoch with a val pass
             (and a profiler window), and `--resume latest --epochs 2`
             exactly one more: the checkpoints and results,
             finite losses and metrics, the exact K1/K3/K6/K7 launches of
             each epoch (phase 5's per step times the steps) and K1's of
             each val pass, read from the runs' logs; the epoch-1 checkpoint
             restored onto the card bit-equal; a batch of the CLI's data
             (its first sampler indices and seed; augmentation draws of its
             own) under the kernels against plain attention and the dense
             loss (phase 5's bars); the loader's rate, the H2D copy of a pinned batch,
             the CLI's pairs/s and data-time share.
 14. options: the training CLI's options on full-width models, b256, bf16,
             'fusedp', the pallas loss. Remat on ViT-B-16: each policy
             (full, dots, mlp_only) one step against none from the same
             weights and batch (phase 5's bars, bit-equality stated), its
             exact launches (K1 twice per layer, K3 once), peak memory and
             the median of 3 timed steps (full must peak below none);
             EVA02-B-16 (K2/K3r) and MobileCLIP-S1 (K8/K9) one checked remat
             step each. Accumulation: the cached mode at 4 x 64 against one
             b256 step, the plain mode's loss against its four b64 losses,
             the exact launches (K6/K7 at B = 256 cached, 64 plain), the
             cached mode at 4 x 256 timed beside b256. sgd, lion (bf16 mu)
             and adafactor one step each from captured gradients against the
             same optimizer in float64 on the CPU. --lock-image and --freeze
             --freezelast: frozen parameters bit-unchanged, the others moved,
             grad_norm over every gradient; MobileCLIP-S1 with
             --lock-image-freeze-bn-stats. Then `python -m
             mrclip_tpu_torch.train.main` on synthetic data (224 px): cached
             accumulation + remat dots + lion + --freeze --freezelast + the
             pallas loss for an epoch with val and `--resume latest` for one
             more (the restored state bit-equal), adafactor and sgd for one
             short epoch, --visiononly for an epoch with its eval; the exact
             launches of each from its log.
 15. fast input: the native data path and the augmentation on the card.
             The port's C++ loader library built on the card's host (the
             compiler, its flags and the zlib it links printed); its
             load_batch (cover, bicubic) and augment_batch (the MR-CLIP warp
             and blur) on a b256 of phase 13's slices to 224 px, images/s
             on 1 thread and on every core, beside phase 13's host
             transforms; random_augment_batch (with and without the colour
             extras), eval_preprocess_batch and normalize_images on the card
             at b256 from 256 x 256 uint8 canvases (CUDA events), the
             deterministic apply and the eval preprocessing on the card
             against the CPU on the same draws (1e-4); then the training
             CLI on phase 13's CSVs under --native-loader and
             --device-augment (1 epoch each, a val pass): exact K1/K3/K6/K7
             launches per epoch and K1's per val pass, finite losses and
             metrics, pairs/s and the data-time share beside phase 13's.
 16. wide:   the attention kernels at the head dims of the large public
             towers, 80 (ViT-H-14), 88 (ViT-g-14) and 104 (ViT-bigG-14; 88
             and 104 padded to 96 and 112 columns inside the kernels): K1/K3,
             K4/K5 and K10/K10b against their plain versions with phase 3's
             bars, bf16 and fp32, at the towers' vision shape (N 257, H 16)
             at b32 and b256 and at the tile edges (N 1, 15, 17, 65, 257,
             causal and not; 400: K10's two key blocks), and at D = 64 at
             ViT-L-14's vision shape (N 257, b32 and b256, causal and not at
             b2); which device kernels they run and the route the libraries
             name (bf16 forwards: attn_mma_fwd.cuh's wgmma_wide_fwd_kernel up
             to 272 keys, K10's MULTI form past 256; backward:
             attn_mma_bwd.cuh's wgmma_wide_bwd_* up to 272 rows, not
             causal); two bf16 runs of each forward and backward bit-equal;
             timings at b256 and b32 beside the kernels' mma.sync route of
             the same run (a second build of the three forward and three
             backward sources under build/variants/fwd_mma_sync/ with the
             wide routes' reach cut to no row, started with phase 2's), SDPA
             and the bounds.
             Then ViT-g-14 and ViT-bigG-14 at full width and depth (random
             weights drawn on the card from seed 0, bf16, 'fusedp', remat
             'full') served at b32
             (against their plain attention) and trained one step at b32,
             peak memory each; ViT-H-14 at full width and depth trained with
             the pallas loss under remat 'full' at b256 (gradients against
             plain attention at b32 first, also under 'fused' and 'flash':
             K4/K5, K10/K10b at D = 80; 1 warm-up and 3 timed steps, 112 K1
             and 56 K3 each, by head dim; a profiled step), then exported
             and served by serve.py's HTTP server (K1 32 times at D = 80 per
             image call, 24 at D = 64 per text call), held against the same
             weights' fp32 plain path by cosine, timed through ServedModel at
             b32 and b256, and its attention under 'fused' and 'flash' (K4,
             K10 at D = 80) against its plain attention; after
             `server_close` the card holds none of it (the batcher threads
             end).
 17. siglip: the SigLIP and CLIPA families. K1/K3, K4/K5 and K10/K10b at
             D = 72 (ViT-SO400M-SigLIP's towers, padded to 80 columns inside
             the kernels) against their plain versions with phase 16's
             bars, bf16 and fp32, at SO400M's vision shapes (N 256 at b256
             and b32, N 729 at b32: 378 and 384 px, no CLS), its non-causal
             text (N 64, b256) and the tile edges; which device kernels they
             run (the forwards on wgmma_wide_fwd_kernel, N 729 on
             wgmma_long_fwd_kernel; the backward on wgmma_wide_bwd_*, N 729
             on wgmma_long_bwd_*); timings at those four shapes beside the
             mma.sync route, SDPA and the bounds.
             Then ViT-SO400M-14-SigLIP at full width and depth (random
             weights drawn on the card from seed 0, bf16, 'fusedp'): the
             export's logit scale and bias, served through ServedModel
             (K1 27 + 27 at D = 72 a b32 image and text call) against its
             plain attention and the same weights' fp32 plain path,
             `logits` with the bias, images/s at b32 and b256 and captions/s
             at b256; trained with the SigLIP loss under remat 'full' at
             b256 (gradients against plain attention at b32 first, also
             under 'fused' and 'flash': K4/K5, K10/K10b at D = 72; 1 warm-up
             and 3 timed steps, 108 K1 and 54 K3 each; a profiled step);
             ViT-B-16-SigLIP-512 (N = 1024 at D = 64) and
             ViT-bigG-14-CLIPA-336 (N = 577 at D = 104) served one b32 batch
             each against their plain attention, their vision K1 on
             wgmma_long; encode_image b32 timed on the package's build and on
             the mma.sync route's in turns, with K1's share of one profiled
             call on each. Then ViT-SO400M-14-SigLIP-384 (vision N 729 at D
             = 72, 27 layers, map pool; non-causal text N 64) at full width
             and depth trained with the SigLIP loss under remat 'full' at
             b32 (gradients against plain attention first, also under
             'fused' and 'flash'; 1 warm-up and 5 timed steps, 108 K1 and 54
             K3 each, the vision backward on wgmma_long_bwd_* and the text's
             on mma_bwd_* by the launch counts by route; a profiled step
             with the backward's device time by route; the step's forward
             and backward timed with the mma.sync route's backward in
             turns).
 18. eva:    the EVA family. K1/K3, K4/K5 and K10/K10b at D = 112
             (EVA02-E-14's vision tower, 16 heads of 112, unpadded) against
             their plain versions with phase 16's bars, bf16 and fp32, at
             its vision shape (N 257, H 16) at b32 and b256 and the tile
             edges; which device kernels they run; timings at b256 and b32
             beside the mma.sync route, SDPA and the bounds. Then EVA02-E-14
             at full width and
             depth (4.7 B parameters drawn on the card from seed 0, the
             vision q and k rows at 1/8 of the factory's std so that the
             post-norm scores stay near unit std, bf16, 'fusedp', remat
             'full'; post-norm blocks, fused qkv) served
             through ServedModel (K1 64 at D = 112 + 24 at D = 64 a b32
             image and text call) against its plain attention, images/s at
             b32 and b256 and texts/s at b256; trained with the pallas loss
             and Lion (a bf16 moment: AdamW's does not fit beside the
             gradient check; the update 32 tensors at a time) at b32
             (gradients against plain attention first, also under 'fused'
             and 'flash': K4/K5, K10/K10b at D = 112; 1 warm-up and 4 timed
             steps, 176 K1 and 88 K3 each; a profiled step), freed, the
             card's memory checked;
             EVA02-E-14-plus, EVA01-g-14 (D = 88, pre-norm) and
             EVA02-L-14-336 (K2 at N = 577) served one b32 batch each
             against their plain attention; EVA02-L-14 served at b32 and
             b256 and trained one step at b32 (K2/K3r at N = 257). The run
             ends with the count of torch.profiler windows and of those that
             recorded no device event, by phase.
 19. long:   the bf16 forward past 272 keys and backward past 272 rows,
             not causal (attn_mma_fwd.cuh's wgmma_long_fwd_kernel: K and V
             streamed through a ring of 64-key tiles by TMA;
             attn_mma_bwd.cuh's wgmma_long_bwd_*: each pass's staged pair
             through such a ring): K1, K4 and K10, K3, K5 and K10b at the
             long towers' vision shapes at b32 (D 64 N 577 and N 1024 at 12
             heads, D 72 N 729, D 80 N 730, D 104 N 577; 16 heads) against
             their plain versions with phase 3's bars, their bits against the
             mma.sync route's build (bit-equal or not, and the largest
             difference), which device kernel each runs on both builds and
             the route the libraries name; timings beside the mma.sync
             route, SDPA's forward and backward, the plain versions and the
             bounds, two runs bit-equal.
Phases 16, 17, 18 and 19's kernel checks and timings run right after the build
(late in a long process the profiler loses the device records of short
windows), their models after phase 15. Their served and trained paths also
read the attention launches by route (`ops.launch_counts_by_route`): every
K1, K4 and K10 launch and every K3, K5 and K10b launch at D = 72-112 on
wgmma_wide (but SO400M's text backward, N 64, on mma_sync, and phase 17's
long vision towers' on wgmma_long), at the text towers' D = 64 on wgmma,
K2 and K3r (EVA02-L-14) on mma_sync, none elsewhere.
Each path (4 to 18; phase 12 has five, one per objective; phase 13's train
and val runs are "cli" and "cli_eval", phase 14's CLI runs "cli_<run>",
phase 15's "fast_native", "fast_device" and their "_eval", counted by the
runs themselves) runs with the launch counts set to 0 just before it and
reads them just after. The last three lines are the kernels JSON, the card's
name and power limit, and {"ok": true, "device": {...}}. Needs one CUDA card
and imports no JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
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
# the top of its route (256 keys; N = 257 in EDGES takes wgmma_wide_fwd_kernel)
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
# (every main-path shape); K1, K4 and K10 at D = 72-112 up to 272 keys and
# at D = 64 from 257 to 272 keys on the wide wgmma kernel, past 272 keys
# (not causal) on the long one; causal walks past 272 keys, K2 past 256
# keys and D = 32 stay on mma_fwd_kernel
WGMMA_FWD = dict(source="mrclip_tpu_torch/csrc/attn_mma_fwd.cuh",
                 design="wgmma bf16 (wgmma_fwd_kernel: m64n64k16 and m64n16k16, A in "
                        "registers, K and V read through 128-byte-swizzled shared memory), each "
                        "row's scores whole in registers, one exp per score; wgmma_wide_fwd_kernel "
                        "at D = 72-112 (and 64 past 256 keys) up to 272 keys: K and V once per "
                        "(sample, head) in 32-byte-swizzled 16-column slabs, P V on m64nDk16, "
                        "K10's 128-key blocks as jax's update; wgmma_long_fwd_kernel past 272 "
                        "keys, not causal: K and V by TMA, K resident for both passes, V through "
                        "a ring of 64-key tiles, a block walking the row blocks of its head; "
                        "mma.sync (mma_fwd_kernel) causal past 272 keys, K2 past 256 and at D = 32")
# K3, K3r, K5 and K10b at D = 64 with n and nk at most 256; K3, K5 and K10b
# at D = 72-112 (and 64 past 256 rows) up to 272 rows, not causal, on the
# wide wgmma kernels; D = 32, the rope and causal past those, longer walks
# and one 64-row sub-tile a side stay on the mma_bwd_* kernels
WGMMA_BWD = dict(source="mrclip_tpu_torch/csrc/attn_mma_bwd.cuh",
                 design="wgmma bf16 (wgmma_bwd_dq_kernel, wgmma_bwd_dkv_kernel: m64n64k16 and "
                        "m64n16k16, A in registers, the staged pair read K-major and MN-major "
                        "from one 128-byte-swizzled tile), two passes, no atomics; "
                        "wgmma_wide_bwd_dq_kernel and wgmma_wide_bwd_dkv_kernel at D = 72-112 "
                        "(and 64 past 256 rows) up to 272 rows, not causal: the staged pair once "
                        "per (sample, head) in 32-byte-swizzled 16-column slabs, dQ, dK and dV "
                        "on m64nDk16, the dk/dv pass's K and V the A operands from shared "
                        "memory; mma.sync (mma_bwd_*) past 272 rows, at D = 32, K3r past 256, "
                        "causal past the D = 64 route, and where n and nk are each one 64-row "
                        "sub-tile")
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


# The profiler windows this run opened, those that recorded no device event,
# the phase each was opened in: `main` logs them at the end.
PROFILER = {"phase": "", "windows": 0, "empty": 0, "first_empty": None, "empty_by_phase": {}}


@contextlib.contextmanager
def profiled():
    """A torch.profiler window over CPU and CUDA activity (CUPTI), counted
    in PROFILER with whether it recorded any device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
    PROFILER["windows"] += 1
    if not any(ev.device_type == DeviceType.CUDA for ev in prof.events()):
        PROFILER["empty"] += 1
        phase = PROFILER["phase"]
        PROFILER["empty_by_phase"][phase] = PROFILER["empty_by_phase"].get(phase, 0) + 1
        if PROFILER["first_empty"] is None:
            PROFILER["first_empty"] = (PROFILER["windows"], phase)


def device_ms(fns: dict, launches: int = 10, runs: int = FWD_RUNS) -> dict:
    """Median over `runs` torch.profiler windows of each of `fns`' device
    time per call (the kernels that `launches` back-to-back calls ran): the
    kernel's own time, which cuda_ms exceeds where the host takes longer to
    issue a call than the card takes to run it. The profiler can lose some
    or all of a window's device records (PROFILER): only whole windows are
    read, those where every device kernel of the fn's windows appears a
    multiple of `launches` times; None where fewer than half are whole."""
    from torch.autograd import DeviceType

    reads = {key: [] for key in fns}
    for _ in range(runs):
        for key, fn in fns.items():
            torch.cuda.synchronize()
            with profiled() as prof:
                for _ in range(launches):
                    fn()
                torch.cuda.synchronize()
            kernels = {ev.key: (ev.count, getattr(ev, "self_device_time_total", 0.0))
                       for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}
            reads[key].append(kernels)
    out = {}
    for key, windows in reads.items():
        names = set().union(*windows)
        whole = [sum(t for _, t in w.values()) / launches / 1e3 for w in windows
                 if w and set(w) == names and all(n % launches == 0 for n, _ in w.values())]
        out[key] = statistics.median(whole) if 2 * len(whole) > runs else None
    return out


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


SOURCES = ("packed_attn_fwd", "packed_attn_bwd", "supcon_loss", "grouped_attn", "grouped_attn_bwd",
           "flash_attn", "flash_attn_bwd", "dw_conv")
HOST_SOURCES = ("png_unfilter",)  # host code only: the PNG reader's unfilter (phase 13)
# The bf16 forward's and backward's mma.sync routes (mma_fwd_kernel,
# mma_bwd_*) at the shapes the wide and long wgmma kernels took over, timed
# beside them in phases 16-19: K1's, K3's, K4/K5's and K10/K10b's sources
# built again from a copy of csrc/ whose wide and long routes reach no row
# (attn_mma_fwd.cuh's fwd_route and attn_mma_bwd.cuh's bwd_route then name
# mma_sync there) and whose launchers leave those kernels out (not
# compiled: the build costs what the kernels cost before them)
FWD_SOURCES = ("packed_attn_fwd", "grouped_attn", "flash_attn")
BWD_SOURCES = ("packed_attn_bwd", "grouped_attn_bwd", "flash_attn_bwd")
MMA_SYNC_EDITS = [("constexpr int kWideKeys = 272;", "constexpr int kWideKeys = 0;"),
                  ("  if constexpr (!ROPE && D != 32) {\n    if (route == kRouteWide)",
                   "  if constexpr (false) {\n    if (route == kRouteWide)"),
                  ("  if (causal) return kRouteMmaSync;\n  return kRouteLong;", "  return kRouteMmaSync;"),
                  ("  if constexpr (!ROPE && D != 32 && FLASH == MULTI) {\n    if (route == kRouteLong)",
                   "  if constexpr (false) {\n    if (route == kRouteLong)")]
MMA_SYNC_BWD_EDITS = [("  if (n > kWideKeys || nk > kWideKeys) return kRouteLong;\n", ""),
                      ("  return kRouteWide;\n}", "  return kRouteMmaSync;\n}"),
                      ("  if constexpr (!ROPE && D != 32) {\n    if (route == kRouteWide)\n"
                       "      return launch_wide_bwd",
                       "  if constexpr (false) {\n    if (route == kRouteWide)\n"
                       "      return launch_wide_bwd")]
MMA_SYNC_LIBS: dict = {}  # source name -> ctypes.CDLL of that build (phase_build)


def build_fwd_variant(name, edits, bwd_edits=None, fwd=True):
    """The three forward sources (not without `fwd`) built from a copy of
    csrc/ under build/variants/fwd_<name>/ with `edits` ((old, new) texts of
    attn_mma_fwd.cuh, each found once) applied, and with `bwd_edits` (texts
    of attn_mma_bwd.cuh) the three backward sources too; one nvcc each in
    parallel, keyed by the edited sources as build.py keys the package's.
    Returns {source: ctypes.CDLL}; raises with nvcc's output when a build
    fails."""
    import ctypes
    import shutil

    from mrclip_tpu_torch.ops import build

    root = build.build_dir().parent / "variants" / f"fwd_{name}"
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    sources = (*(FWD_SOURCES if fwd else ()), *(() if bwd_edits is None else BWD_SOURCES))
    for header, header_edits in (("attn_mma_fwd.cuh", edits), ("attn_mma_bwd.cuh", bwd_edits or ())):
        text = (csrc / header).read_text()
        for old, new in header_edits:
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: the edit is not once in {header}: {old!r}")
            text = text.replace(old, new)
        (csrc / header).write_text(text)

    def one(src_name):
        src = csrc / f"{src_name}.cu"
        out = root / f"lib{src_name}-{build.source_key(src)}.so"
        if not out.is_file():  # niced: beside the package's own build, it takes what is left
            proc = subprocess.run(["nice", "-n", "10", *build.nvcc_command(
                src, out, build._find_nvcc())], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {name}'s {src_name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            (root / f"{src_name}.log").write_text(proc.stdout + proc.stderr)
        return src_name, ctypes.CDLL(str(out))

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources))


@contextlib.contextmanager
def fwd_libraries(libs):
    """Within the block the K1, K4 and K10 wrappers (and K3's, K5's and
    K10b's, where `libs` holds the backward sources) launch the kernels of
    `libs` (a `build_fwd_variant` build, bound as the package binds its
    own). Only timing and device-kernel comparisons enter it: the launches
    it counts are not read."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    def bind(lib, like):
        fn = getattr(lib, like.__name__)
        fn.argtypes, fn.restype = like.argtypes, like.restype
        return fn

    def pair(fwd_lib, bwd_lib, fns):  # (forward, backward): the package's backward without bwd_lib
        return (bind(libs[fwd_lib], fns[0]), bind(libs[bwd_lib], fns[1]) if bwd_lib in libs
                else fns[1])

    k1 = bind(libs["packed_attn_fwd"], fa.load_kernel())
    k3 = bind(libs["packed_attn_bwd"], fa.load_bwd_kernel()) if "packed_attn_bwd" in libs else None
    k4 = pair("grouped_attn", "grouped_attn_bwd", fa.load_grouped_kernels())
    k10 = pair("flash_attn", "flash_attn_bwd", fl.load_kernels())
    saved = fa.load_kernel, fa.load_bwd_kernel, fa.load_grouped_kernels, fl.load_kernels
    fa.load_kernel, fa.load_grouped_kernels, fl.load_kernels = (
        lambda: k1), (lambda: k4), (lambda: k10)
    if k3 is not None:
        fa.load_bwd_kernel = lambda: k3
    try:
        yield
    finally:
        fa.load_kernel, fa.load_bwd_kernel, fa.load_grouped_kernels, fl.load_kernels = saved


def on_libraries(fn, libs):
    """fn run under `fwd_libraries(libs)`, for the timing loops."""
    def call():
        with fwd_libraries(libs):
            return fn()
    return call



def phase_build():
    from mrclip_tpu_torch.ops import build, dw_conv, flash_attn, fused_attn, pallas_loss

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # the mma.sync route's builds beside the package's
        variant = pool.submit(build_fwd_variant, "mma_sync", MMA_SYNC_EDITS, MMA_SYNC_BWD_EDITS)
        build.load_libraries(SOURCES + HOST_SOURCES)  # one nvcc per source, all started together
        t_pkg = time.perf_counter() - t0
        MMA_SYNC_LIBS.update(variant.result())
    log(f"[build] {len(SOURCES)} kernel sources and {len(HOST_SOURCES)} host source built in "
        f"{t_pkg:.2f} s wall; the mma.sync routes' {len(MMA_SYNC_LIBS)} sources beside "
        f"them, all done in {time.perf_counter() - t0:.2f} s")
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


# The device kernels that each bf16 backward route (`fused_attn.bwd_route`)
# runs: a name they hold, and a name they must not ("wgmma_bwd_" holds
# "mma_bwd_").
BWD_ROUTE_KERNELS = {"wgmma": ("wgmma_bwd_", None), "wgmma_wide": ("wgmma_wide_bwd_", None),
                     "wgmma_long": ("wgmma_long_bwd_", None), "mma_sync": ("mma_bwd_", "wgmma")}


def bwd_kernel_route(name):
    """The backward route (`fused_attn.BWD_ROUTES`) of a device kernel's
    name, or None for a kernel of no attention backward."""
    for route, (key, _) in BWD_ROUTE_KERNELS.items():  # the wgmma routes before mma_sync's
        if key in name:
            return route
    return "fma" if "rows_bwd_" in name or "attn_bwd_d" in name else None


def device_kernels(tag, calls, want, avoid=None, group=None):
    """The device kernels that one call of each of `calls` (dtype -> fn)
    launches, by torch.profiler; fails unless each name holds `want[dtype]`
    (the kernel the type routes to) and not `avoid` (a kernel whose name
    holds want's: "wgmma_bwd_" holds "mma_bwd_"), and, with `group`, unless
    `kernel_group` puts each name in that profiler group. "not measured"
    where three profiler windows record no device kernel."""
    from torch.autograd import DeviceType

    names = {}
    for dtype, fn in calls.items():
        seen = []
        for _ in range(3):  # a window that records nothing is tried again
            torch.cuda.synchronize()
            with profiled() as prof:
                fn()
                torch.cuda.synchronize()
            seen = sorted({ev.key for ev in prof.key_averages()
                           if ev.device_type == DeviceType.CUDA})
            if seen:
                break
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
    long = dict(VISION, b=4, n=577, nk=577, h=4)  # past 272 keys: the long kernel
    q, k, v = qkv_slices(long, torch.bfloat16, gen)
    call = {torch.bfloat16: lambda: fa.fused_attention_packed(q, k, v, heads=long["h"])}
    names["bf16_n577"] = device_kernels(
        "K1 N=577", call, {torch.bfloat16: "wgmma_long_fwd_kernel<64, false, false>"})["bfloat16"]

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
    # past the wgmma route: N = 257 on the wide one, causal there, past 272
    # rows (N = 577, Nk = 300) and at D = 32 on mma.sync
    for tag, shape in (("N=256", dict(VISION, b=2, n=256, nk=256, h=2)),
                       ("N=257", dict(VISION, b=2, n=257, nk=257, h=2)),
                       ("N=257 causal", dict(VISION, b=2, n=257, nk=257, h=2, causal=True)),
                       ("N=577", dict(VISION, b=2, n=577, nk=577, h=2)),
                       ("Nk=300", dict(VISION, b=2, n=76, nk=300, h=2)),
                       ("D=32", dict(VISION, b=2, h=2, d=32))):
        q, k, v = qkv_slices(shape, torch.bfloat16, gen)
        o, lse = fa.fused_attention_packed(q, k, v, heads=2, is_causal=shape["causal"])
        call = {torch.bfloat16: lambda q=q, k=k, v=v, o=o, lse=lse, c=shape["causal"]:
                fa.fused_attention_packed_bwd(q, k, v, o, o, lse, heads=2, is_causal=c)}
        want, avoid = BWD_ROUTE_KERNELS[fa.bwd_route("packed_attn_bwd", True, shape["d"], False,
                                                     shape["n"], shape["nk"], shape["causal"])]
        names[f"bf16_{tag}"] = device_kernels(f"K3 {tag}", call, {torch.bfloat16: want},
                                              avoid=avoid, group=K3_GROUP)["bfloat16"]

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
        want, avoid = BWD_ROUTE_KERNELS[fa.bwd_route("grouped_attn_bwd", True, 64, False,
                                                     shape["n"], shape["nk"], False)]
        names[f"bf16_{tag}"] = device_kernels(f"K5 {tag}", call, {torch.bfloat16: want},
                                              avoid=avoid, group=K3_GROUP)["bfloat16"]
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
        "entry": "mrclip_tpu_torch/csrc/grouped_attn_bwd.cu::grouped_attn_bwd",
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
    # top of its route, N = 257 on the wide route and N = 577 (several jax
    # key blocks) on mma.sync
    for tag, shape in (("text77", dict(TEXT77, b=2)), ("n256", dict(VISION, b=2, n=256, nk=256)),
                       ("n257", dict(VISION, b=2, n=257, nk=257)),
                       ("n577", dict(VISION, b=2, n=577, nk=577))):
        q, k, v = inputs(shape, torch.bfloat16)
        o, l, m = fl.flash_attention(q, k, v, is_causal=shape["causal"])
        di = fl.flash_di(o, o)
        call = {torch.bfloat16: lambda q=q, k=k, v=v, o=o, l=l, m=m, di=di, c=shape["causal"]:
                fl.flash_attention_bwd(q, k, v, o, l, m, di, is_causal=c)}
        route = fa.bwd_route("flash_attn_bwd", True, 64, False, shape["n"], shape["nk"],
                             shape["causal"])
        want, avoid = BWD_ROUTE_KERNELS[route]
        if route == "wgmma":  # wgmma_bwd_*<FLASH, ROPE, CAUSAL, TAIL>
            want = f"_kernel<true, false, {str(shape['causal']).lower()}, "
        names[f"bf16_{tag}"] = device_kernels(
            f"K10b {tag}", call, {torch.bfloat16: want}, avoid=avoid,
            group=K10B_GROUP)["bfloat16"]
    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(VISION, dtype)
        calls[dtype] = lambda q=q, k=k, v=v: fl.flash_attention(q, k, v)
    names_fwd = device_kernels("K10", calls, {torch.bfloat16: "wgmma_fwd_kernel<true, ",
                                              torch.float32: "rows_fwd_kernel<float, 64, true>"})
    # five key blocks of 128, each in one pass
    q, k, v = inputs(dict(VISION, b=4, n=577, nk=577, h=4), torch.bfloat16)
    names_fwd["bf16_n577"] = device_kernels(
        "K10 N=577", {torch.bfloat16: lambda: fl.flash_attention(q, k, v)},
        {torch.bfloat16: "wgmma_long_fwd_kernel<64, true, true>"})["bfloat16"]

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
        "entry": "mrclip_tpu_torch/csrc/flash_attn_bwd.cu::flash_attn_bwd",
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
    from mrclip_tpu_torch.ops import launch_counts, launches_since
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
        calls.append(launches_since(before))
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
    from mrclip_tpu_torch.ops import launch_counts, launches_since
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
        calls.append(launches_since(before))
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
ATTN_DIMS = (32, 64, 72, 80, 88, 104, 112)  # the kernels' head dims (fused_attn.HEAD_DIMS)
K3R_GROUP = "K3r packed_attn_rope_bwd"
K3_GROUP = "K3 packed_attn_bwd / K5 grouped_attn_bwd"
KERNEL_GROUPS = [
    ("K8 dw_conv_fwd", ("dw_fwd_kernel",)),
    ("K9 dw_conv_bwd", ("dw_bwd_kernel", "dw_wgrad_sum_kernel")),
    ("convolution (cuDNN: stem, downsamples)", ("convolution", "cudnn", "fprop", "dgrad",
                                                "wgrad", "conv2d", "depthwise")),
    (K2_GROUP, ("wgmma_fwd_kernel<false, true", "mma_fwd_kernel<64, false, false, true>",
                "packed_attn_fwd_kernel<64, true>")),
    ("K10 flash_attn_fwd", ("wgmma_fwd_kernel<true, ",
                            *(f"wgmma_wide_fwd_kernel<{d}, true" for d in ATTN_DIMS),
                            *(f"wgmma_long_fwd_kernel<{d}, true" for d in ATTN_DIMS),
                            *(f"mma_fwd_kernel<{d}, true" for d in ATTN_DIMS),
                            *(f"rows_fwd_kernel<float, {d}, true>" for d in ATTN_DIMS))),
    # one instantiation: K1 under fusedp, K4 under fused
    ("K1 packed_attn_fwd / K4 grouped_attn_fwd", ("wgmma_fwd_kernel", "wgmma_wide_fwd_kernel",
                                                  "wgmma_long_fwd_kernel", "mma_fwd_kernel",
                                                  "rows_fwd_kernel", "packed_attn_fwd")),
    (K10B_GROUP, ("wgmma_bwd_dq_kernel<true", "wgmma_bwd_dkv_kernel<true",
                  *(f"wgmma_{w}_bwd_{p}_kernel<{d}, true" for w in ("wide", "long")
                    for d in ATTN_DIMS for p in ("dq", "dkv")),
                  *(f"mma_bwd_{p}_kernel<{d}, true" for d in ATTN_DIMS for p in ("dq", "dkv")),
                  *(f"rows_bwd_{p}_kernel<float, {d}, true>" for d in ATTN_DIMS
                    for p in ("dq", "dkv")))),
    (K3R_GROUP, ("wgmma_bwd_dq_kernel<false, true", "wgmma_bwd_dkv_kernel<false, true",
                 "mma_bwd_dq_kernel<64, false, false, true>",
                 "mma_bwd_dkv_kernel<64, false, false, true>",
                 "mma_bwd_dq_kernel<64, false, true, true>",  # past 256 rows
                 "mma_bwd_dkv_kernel<64, false, true, true>",
                 "attn_bwd_dq_kernel<64, true>", "attn_bwd_dkv_kernel<64, true>")),
    # the rest of the tensor-core and FMA backward: one bf16 instantiation,
    # K3 under fusedp, K5 under fused
    (K3_GROUP, ("wgmma_wide_bwd_", "wgmma_long_bwd_", "mma_bwd_", "rows_bwd_", "attn_bwd_dq",
                "attn_bwd_dkv")),
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
    the attention backward's device time by route (`bwd_kernel_route`), and
    the device's idle share of the profiled wall time (profiling slows the
    host, so that share is an upper bound). {} if no device time was
    recorded."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with profiled() as prof:
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
        log(f"{tag} profiler recorded no device time (window {PROFILER['windows']} of the run): "
            "breakdown by kernel not measured")
        return {}
    records = sum(count for _, count, _ in kernels)
    log(f"{tag} profiled step: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}, {records} device records; by group (ms): "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in groups.items()))
    for ms, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"{tag}   {ms:9.3f} ms  x{count:<5d} {key[:110]}")
    bwd_routes = {}
    for ms, _, key in kernels:
        if (route := bwd_kernel_route(key)) is not None:
            bwd_routes[route] = bwd_routes.get(route, 0.0) + ms
    if bwd_routes:
        log(f"{tag} the attention backward by route (ms, share of the device time): "
            + ", ".join(f"{r} {ms:.2f} ({ms / busy:.3f})" for r, ms in bwd_routes.items()))
    other = KERNEL_GROUPS[-1][0]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "groups_ms": groups, "bwd_by_route_ms": bwd_routes,
            "kernels_in_other": [key for _, _, key in kernels if kernel_group(key) == other]}


# The train main path of each (model, attn_impl): the attention kernels'
# exact launches per dense step (one per attention layer per direction;
# 'flash' launches K10 again in the backward) and which parameters are the
# attention's input projections.
VIT_PROJ = ("attn.in_proj_weight", "attn.qkv.weight")  # open_clip's ViT, timm's (SigLIP)
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
    from mrclip_tpu_torch.ops import launch_counts, launches_since
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
        per_step.append(launches_since(before))
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
    from mrclip_tpu_torch.ops import launch_counts, launches_since
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
        calls.append(launches_since(before))
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
    from mrclip_tpu_torch.ops import launch_counts, launches_since
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
            got.append(launches_since(before))
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


# The training CLI from MRI volumes (phase 13): `CLI_*` size the run; a CPU
# rehearsal may cut them.
CLI_MODEL = "ViT-B-16"
CLI_DEVICE = "cuda"
CLI_BATCH = TRAIN_BATCH
CLI_VOLUMES = 40  # 50 slices each; a 60/20/20 split: 1200 train rows (4 steps), 400 val
CLI_SHAPE = (208, 192, 222)  # 208 x 192 slices along the last axis, int16 voxels
CLI_SLICES = range(122, 221, 2)  # the slices the captions and split steps keep
CLI_PER_STEP = {**TRAIN_PATHS["ViT-B-16", "fusedp"]["per_step"], **PALLAS_STEP}
CLI_EVAL_PER_BATCH = {"packed_attn_fwd": 24}  # 12 vision + 12 text layers
CLI_TIMEOUT = 900
# epochs of the first training run; `--resume latest` then trains one more
# (one, not two: the runs wait on the host's transforms, ~20 s an epoch's
# first step, and the whole script has to stay inside its time limit)
CLI_EPOCHS = 1


def _run_cli(tag, args, log_path):
    """`python -m <args>` from the checkout's root, its output in `log_path`;
    raises with the output's tail when it exits non-zero."""
    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.run([sys.executable, "-m", *args], cwd=root, stdout=out,
                              stderr=subprocess.STDOUT, timeout=CLI_TIMEOUT)
    seconds = time.perf_counter() - t
    with open(log_path) as f:
        text = f.read()
    log(f"{tag} python -m {' '.join(args[:2])}: exit {proc.returncode} in {seconds:.1f} s")
    if proc.returncode != 0:
        log(text[-6000:])
        raise AssertionError(f"{tag} python -m {args[0]} {args[1]} exited {proc.returncode}")
    return text, seconds


def _cli_log(path):
    """(per-step (epoch, loss, data s, batch s), {epoch: train launches},
    {epoch: eval launches}) from a train CLI's out.log."""
    import re

    steps, train, evals = [], {}, {}
    step_re = re.compile(r"Train Epoch: (\d+) \[.*\] Loss: (\S+) Data \(t\): (\S+) Batch \(t\): "
                         r"([\d.]+),")
    launch_re = re.compile(r"(Train|Eval) Epoch: (\d+) kernel launches: (\{.*\})")
    with open(path) as f:
        for line in f:
            m = step_re.search(line)
            if m:
                steps.append((int(m[1]), float(m[2]), float(m[3]), float(m[4])))
            m = launch_re.search(line)
            if m:
                (train if m[1] == "Train" else evals)[int(m[2])] = json.loads(m[3])
    return steps, train, evals


def _scaled(per_step, n):
    return {k: v * n for k, v in per_step.items()}


def _cli_flags(work, logs, name, workers):
    """The training CLI's flags of phases 13 and 15 on the study in `work`:
    ViT-B-16 b256 `fusedp`, the pallas loss, amp, a val pass each epoch."""
    return ["--train-data", os.path.join(work, "split", "train.csv"),
            "--val-data", os.path.join(work, "split", "val.csv"), "--csv-caption-key", "text",
            "--model", CLI_MODEL, "--attn-impl", "fusedp", "--pallas-loss",
            "--multipositiveloss", "--dataset-type", "csv", "--batch-size", str(CLI_BATCH),
            "--val-frequency", "1", "--precision", "amp", "--workers", str(workers),
            "--lr", "1e-4", "--wd", "0.2", "--skip-scheduler", "--bf16-moments",
            "--gelu-approx", "--seed", "0", "--log-every-n-steps", "1", "--logs", logs,
            "--name", name, "--device", CLI_DEVICE]


def _cli_rates(steps, n_steps):
    """Pairs/s and the data-time share over every logged step, and over the
    steps after each epoch's first (whose batches the loader makes while
    the first waits); the first steps' seconds and data seconds."""
    steady = [s for i, s in enumerate(steps) if i % n_steps]
    data_s, batch_s = sum(s[2] for s in steady), sum(s[3] for s in steady)
    all_data, all_batch = sum(s[2] for s in steps), sum(s[3] for s in steps)
    return dict(cli_pairs_per_s=CLI_BATCH * len(steps) / all_batch,
                cli_data_time_share=all_data / all_batch,
                cli_steady_pairs_per_s=CLI_BATCH * len(steady) / batch_s if steady else None,
                cli_steady_batch_ms=batch_s / len(steady) * 1e3 if steady else None,
                cli_steady_data_time_share=data_s / batch_s if steady else None,
                cli_first_step_s=[s[3] for i, s in enumerate(steps) if i % n_steps == 0],
                cli_first_step_data_s=[s[2] for i, s in enumerate(steps) if i % n_steps == 0])


def phase_cli(card):
    """Phase 13: MR-CLIP's own main path from MRI volumes. Synthetic NIfTI
    volumes (the port's writer) with BIDS sidecars go through the
    preprocessing CLI (slices, captions, label, split); the training CLI
    trains `CLI_MODEL` on the CSVs for CLI_EPOCHS epochs with a val pass after
    each, then `--resume latest` trains exactly one more. Checks the
    runs' files, finite losses and metrics, the exact K1/K3/K6/K7 launches
    per epoch and K1's per val pass, the saved state restored bit-equal onto
    the card, and a batch of the CLI's data under the kernels against plain
    attention and the dense loss. Returns ({path: launches}, {path: per-step
    or per-batch launches}, perf, the study: its temporary directory, the
    preprocessed `work` directory and the split rows, for phase 15)."""
    import random
    from types import SimpleNamespace

    from mrclip_tpu_torch import checkpoint as ckpt
    from mrclip_tpu_torch.data import get_data, png
    from mrclip_tpu_torch.data.table import read_table
    from mrclip_tpu_torch.factory import (create_loss, create_model, create_model_and_transforms,
                                          get_tokenizer)
    from mrclip_tpu_torch.parallel import create_optimizer, create_train_state, make_loss_apply
    from mrclip_tpu_torch.parallel.train_step import loss_and_grads
    from mrclip_tpu_torch.preprocessing import extract_image_id
    from mrclip_tpu_torch.preprocessing.synthetic import write_study
    from mrclip_tpu_torch.train.loop import _to_device
    from mrclip_tpu_torch.train.params import parse_args
    from mrclip_tpu_torch.transforms import image_transform

    tag = "[cli]"
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="mrclip_cli_")
    root = tmp.name
    raw, work = os.path.join(root, "raw"), os.path.join(root, "work")
    perf = {}

    # 1. data: int16 volumes and their sidecars, several protocols
    t = time.perf_counter()
    write_study(raw, CLI_VOLUMES, shape=CLI_SHAPE, slices=CLI_SLICES, seed=13, dtype=np.int16)
    perf["write_volumes_s"] = time.perf_counter() - t
    log(f"{tag} {CLI_VOLUMES} NIfTI volumes {CLI_SHAPE} int16 with sidecars in "
        f"{perf['write_volumes_s']:.1f} s")

    # 2. the preprocessing CLI, step by step
    pre = "mrclip_tpu_torch.preprocessing"
    os.makedirs(os.path.join(work, "split"))
    steps = [("slices", "--input", raw, "--output", os.path.join(work, "slices")),
             ("captions", "--input", os.path.join(work, "slices"), "--rawdata", raw, "--output",
              os.path.join(work, "cap", "captions.csv")),
             ("label", "--input", os.path.join(work, "cap", "*.csv"), "--output",
              os.path.join(work, "lab")),
             ("split", "--input", os.path.join(work, "lab"), "--output", os.path.join(work, "split"),
              "--train-ratio", "0.6", "--val-ratio", "0.2")]
    for step in steps:
        _, perf[f"preprocess_{step[0]}_s"] = _run_cli(tag, [pre, *step],
                                                       os.path.join(root, f"pre_{step[0]}.log"))
    with open(os.path.join(work, "lab", "label_dict.json")) as f:
        n_labels = len(json.load(f))
    splits = {s: read_table(os.path.join(work, "split", f"{s}.csv"))[1]
              for s in ("train", "val", "test")}
    vols = {s: {extract_image_id(r["filepath"]) for r in rows} for s, rows in splits.items()}
    labels = [int(r["label"]) for rows in splits.values() for r in rows]
    n_slices = len(os.listdir(os.path.join(work, "slices")))
    ok = (n_slices == CLI_VOLUMES * len(CLI_SLICES)
          and sum(map(len, splits.values())) == n_slices and n_labels >= 3
          and all(0 <= x < n_labels for x in labels)
          and not (vols["train"] & vols["val"] or vols["train"] & vols["test"]
                   or vols["val"] & vols["test"])
          and len(splits["train"]) >= 4 * CLI_BATCH and len(splits["val"]) >= CLI_BATCH)
    log(f"{tag} preprocessing: {n_slices} slices, {n_labels} labels, rows train "
        f"{len(splits['train'])} / val {len(splits['val'])} / test {len(splits['test'])}, "
        f"volumes {len(vols['train'])} / {len(vols['val'])} / {len(vols['test'])} (disjoint) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} the preprocessing CLI's outputs failed their checks")

    # 3. host rates on this machine: PNG decode, the transforms, one thread
    files = [r["filepath"] for r in splits["train"][:200]]
    t = time.perf_counter()
    pixels = [png.read_png(p) for p in files]
    perf["png_decode_images_per_s"] = len(files) / (time.perf_counter() - t)
    perf["png_unfilter_backend"] = png.unfilter_backend()
    with open(files[0], "rb") as f:
        raw, h, w, ch = png.parse_png(f.read())
    t = time.perf_counter()
    for _ in range(20):
        png._unfilter_numpy(np.frombuffer(raw, np.uint8), h, w * ch, ch)
    perf["png_unfilter_numpy_ms"] = (time.perf_counter() - t) / 20 * 1e3
    for name, fn in (("train", image_transform(224, True)), ("eval", image_transform(224, False))):
        random.seed(0)
        t = time.perf_counter()
        for p in pixels[:100]:
            fn(p)
        perf[f"{name}_transform_images_per_s"] = 100 / (time.perf_counter() - t)
    log(f"{tag} host, one thread: PNG decode ({perf['png_unfilter_backend']} unfilter) "
        f"{perf['png_decode_images_per_s']:.1f} images/s ({CLI_SHAPE[0]} x {CLI_SHAPE[1]}; the "
        f"numpy unfilter {perf['png_unfilter_numpy_ms']:.2f} ms an image); train transform "
        f"{perf['train_transform_images_per_s']:.1f} images/s, eval transform "
        f"{perf['eval_transform_images_per_s']:.1f} images/s (224 px)")

    # 4. the training CLI: CLI_EPOCHS epochs with val, then one more from the
    # saved state
    workers = os.cpu_count() or 4
    logs = os.path.join(root, "logs")
    flags = _cli_flags(work, logs, "cli", workers)
    train_mod = "mrclip_tpu_torch.train.main"
    epochs = CLI_EPOCHS + 1
    _, perf["cli_run1_s"] = _run_cli(tag, [train_mod, *flags, "--epochs", str(CLI_EPOCHS),
                                           "--profile-dir", os.path.join(root, "trace")],
                                     os.path.join(root, "train1.log"))
    run = os.path.join(logs, "cli")
    ckdir = os.path.join(run, "checkpoints")
    saved = ckpt.load_checkpoint(ckdir, CLI_EPOCHS)
    _, perf["cli_run2_s"] = _run_cli(tag, [train_mod, *flags, "--epochs", str(epochs), "--resume",
                                           "latest"], os.path.join(root, "train2.log"))
    steps, train_launch, eval_launch = _cli_log(os.path.join(run, "out.log"))
    with open(os.path.join(run, "out.log")) as f:  # where the runs' time went
        for line in f:
            if any(k in line for k in ("Model:", "Start epoch", "Saved checkpoint", "resuming",
                                       "wrote a profiler trace", "Eval Epoch: ")) \
                    and "kernel launches" not in line:
                log(f"{tag}   out.log {line.strip()[:150]}")
    with open(os.path.join(ckdir, "results.jsonl")) as f:
        results = [json.loads(line) for line in f]
    with open(os.path.join(run, "out.log")) as f:
        text = f.read()
    n_steps = len(splits["train"]) // CLI_BATCH
    n_val = -(-len(splits["val"]) // CLI_BATCH)
    want_train = _scaled(CLI_PER_STEP, n_steps)
    want_eval = _scaled(CLI_EVAL_PER_BATCH, n_val)
    finite = (all(np.isfinite(s[1]) for s in steps)
              and all(np.isfinite(v) for r in results for v in r.values()
                      if isinstance(v, (int, float))))
    traces = os.listdir(os.path.join(root, "trace")) if os.path.isdir(
        os.path.join(root, "trace")) else []
    ok = (sorted(ckpt.saved_steps(ckdir)) == list(range(1, epochs + 1))
          and [r["epoch"] for r in results] == list(range(1, epochs + 1))
          and [s[0] for s in steps] == [e for e in range(epochs) for _ in range(n_steps)]
          and f"=> resuming checkpoint (epoch {CLI_EPOCHS})" in text and finite
          and train_launch == {e: want_train for e in range(epochs)}
          and eval_launch == {e: want_eval for e in range(1, epochs + 1)} and traces)
    log(f"{tag} train CLI: {len(steps)} steps over {epochs} epochs ({n_steps} a epoch, "
        f"b{CLI_BATCH}, {workers} loader threads), the last resumed from epoch {CLI_EPOCHS}; losses "
        + ", ".join(f"{s[1]:.4f}" for s in steps) + "; val R@1 i2t "
        + ", ".join(f"{r.get('image_to_text_general_R@1', float('nan')):.3f}" for r in results)
        + f"; launches per train epoch {train_launch.get(0)} (want {want_train}), per val pass "
        f"{eval_launch.get(1)} (want {want_eval}); checkpoints {sorted(ckpt.saved_steps(ckdir))}; "
        f"profiler trace {traces} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} the training CLI's runs failed their checks: "
                             f"{train_launch} {eval_launch} {results}")
    perf.update(_cli_rates(steps, n_steps))
    log(f"{tag} train CLI, all {len(steps)} steps: {perf['cli_pairs_per_s']:.1f} pairs/s, "
        f"data-time share {perf['cli_data_time_share']:.3f}; each epoch's first step "
        + ", ".join(f"{x:.2f}" for x in perf["cli_first_step_s"]) + " s (data "
        + ", ".join(f"{x:.2f}" for x in perf["cli_first_step_data_s"]) + " s); the steps after "
        f"it {perf['cli_steady_batch_ms']:.1f} ms a step, {perf['cli_steady_pairs_per_s']:.1f} "
        f"pairs/s, data-time share {perf['cli_steady_data_time_share']:.3f} (phase 5's bare step "
        f"on random uint8 images is the card's side of it) | {card}")

    # 5. the resumed state: the epoch-CLI_EPOCHS checkpoint loaded onto the
    # card, bit-equal
    args = parse_args([*flags, "--epochs", str(epochs), "--workers", str(workers)])
    args.device, args.rank, args.world_size = CLI_DEVICE, 0, 1
    model, preprocess_train, preprocess_val = create_model_and_transforms(
        CLI_MODEL, precision="amp", device=CLI_DEVICE, attn_impl="fusedp", gelu_approx=True,
        rng_seed=0)
    tx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = ckpt.load_checkpoint(ckdir, CLI_EPOCHS, template=create_train_state(model, tx))
    same = (state.step == saved["step"] == CLI_EPOCHS * n_steps
            and all(torch.equal(state.params[k].cpu(), v) for k, v in saved["params"].items())
            and all(torch.equal(state.opt_state.mu[k].cpu(), v)
                    for k, v in saved["opt_state"]["mu"].items())
            and all(torch.equal(state.opt_state.nu[k].cpu(), v)
                    for k, v in saved["opt_state"]["nu"].items())
            and all(v.dtype == torch.bfloat16 for v in state.opt_state.mu.values()))
    log(f"{tag} epoch-{CLI_EPOCHS} checkpoint restored onto {CLI_DEVICE}: step {state.step}, "
        f"{len(saved['params'])} parameters and both moments (first in bf16) bit-equal "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{tag} the restored state differs from the checkpoint")
    del state, saved, tx
    torch.cuda.empty_cache()

    # 6. a batch of the CLI's data at its first epoch's sampler indices,
    # with the initial weights of --seed 0, under the kernels and the pallas
    # loss vs plain attention and the dense loss; the copy of its images to
    # the card. One worker here, so its crops, angles and flips are its own
    # draws: the CLI's workers drew theirs from the global `random` in
    # another order.
    random.seed(0)
    np.random.seed(0)
    tokenizer = get_tokenizer(CLI_MODEL)
    args.workers = 1  # one batch: one thread makes it fastest (PERF.md, PR 17)
    data = get_data(args, (preprocess_train, preprocess_val), tokenizer=tokenizer)
    loader = data["train"].dataloader
    data["train"].set_epoch(0)
    host_batch = next(iter(loader))
    images = host_batch["images"]
    pinned = torch.is_tensor(images) and images.is_pinned()
    dev = torch.device(CLI_DEVICE)
    if dev.type == "cuda":
        copies = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            host_batch["images"].to(dev, non_blocking=True)
            end.record()
            torch.cuda.synchronize()
            copies.append(start.elapsed_time(end))
        perf["h2d_images_ms"] = statistics.median(copies)
    else:
        perf["h2d_images_ms"] = None
    nbytes = images.numel() * images.element_size() if torch.is_tensor(images) else images.nbytes
    rate = ("not measured" if perf["h2d_images_ms"] is None
            else f"{nbytes / perf['h2d_images_ms'] / 1e6:.2f} GB/s")
    log(f"{tag} H2D copy of a pinned ({pinned}) {nbytes / 1e6:.1f} MB image batch from the "
        f"loader: {fmt_ms(perf['h2d_images_ms'])} ms ({rate}), median of 5 | {card}")
    batch = _to_device(host_batch, dev)
    pallas = make_loss_apply(create_loss(args))
    dense = make_loss_apply(create_loss(SimpleNamespace(**{**vars(args), "pallas_loss": False})))
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    g_kernel, l_kernel = loss_and_grads(model, pallas, dict(model.named_parameters()), batch)
    plain = create_model(CLI_MODEL, pretrained=weights, precision="amp", device=CLI_DEVICE,
                         attn_impl="xla", gelu_approx=True)
    g_plain, l_plain = loss_and_grads(plain, dense, dict(plain.named_parameters()), batch)
    lk, lp = l_kernel["loss"].item(), l_plain["loss"].item()
    whole, worst, worst_name = grad_cosines(g_kernel, g_plain)
    ok = np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp) and whole >= 0.999 and worst >= 0.99
    log(f"{tag} a batch of the CLI's data (its first sampler indices, initial weights of "
        f"--seed 0): "
        f"fusedp + pallas loss {lk:.6f} vs plain attention + dense loss {lp:.6f} (rel "
        f"{abs(lk - lp) / abs(lp):.2e}, tol 1e-2); gradient cosine whole {whole:.6f} (>= 0.999), "
        f"min per tensor {worst:.6f} at {worst_name} (>= 0.99) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} the CLI's batch disagrees between kernels and plain")
    perf.update(first_batch_loss_kernel=lk, first_batch_loss_plain=lp, first_batch_cosine=whole)
    del model, plain, g_kernel, g_plain, batch, host_batch, data
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag} phase wall {perf['phase_s']:.1f} s | {card}")
    log(f"{tag} breakdown: " + json.dumps(perf))
    launches = {k: sum(e.get(k, 0) for e in train_launch.values()) for k in want_train}
    eval_launches = {k: sum(e.get(k, 0) for e in eval_launch.values()) for k in want_eval}
    study = {"tmp": tmp, "work": work, "splits": splits}  # phase 15 trains on it again
    return ({"cli": launches, "cli_eval": eval_launches},
            {"cli": CLI_PER_STEP, "cli_eval": CLI_EVAL_PER_BATCH}, perf, study)


# The training CLI's options (phase 14): remat, accumulation, the other
# optimizers, locking and freezing, and the CLI under them. `OPT_*` size
# the phase; a CPU rehearsal may cut them.
REMAT_POLICIES = (None, "full", "dots", "mlp_only")
REMAT_TIMED = 3
ACCUM = 4
ACCUM_BIG = 256  # rows per microbatch of the cached mode's timed step (A x 256 = 1024)
OPT_LR = {"sgd": 1e-3, "lion": 1e-4, "adafactor": 1e-3}
OPT_CLI_BATCH = 128
OPT_CLI_SAMPLES = {"options": 256, "adafactor": 256, "sgd": 256, "visiononly": 256}


def set_remat(model, policy):
    """Remat every transformer stack of `model` under `policy` (None: off)
    and, for FastViT, its RepMixer blocks; the blocks read the policy at
    each call, so one set of weights serves every policy."""
    from mrclip_tpu_torch.models.fastvit import FastViT
    from mrclip_tpu_torch.models.transformer import Transformer
    from mrclip_tpu_torch.models.vision import EvaVisionTransformer

    for m in model.modules():
        if isinstance(m, (Transformer, EvaVisionTransformer, FastViT)):
            m.remat = policy


class GradRecorder:
    """An optimizer that keeps the gradients it is given and moves nothing:
    a step's gradients, whatever the accumulation mode."""

    def init(self, params):
        from types import SimpleNamespace
        return SimpleNamespace(count=0)

    def update(self, grads, state, params, grad_norm=None):
        self.grads, self.grad_norm = grads, grad_norm
        return state


def supcon_rows(pl):
    """Wrap the K6/K7 wrappers of `pl` to record the rows of each call;
    returns (the list they append to, an undo)."""
    rows, real = [], {}
    for name in ("supcon_stats", "supcon_grad_q", "supcon_grad_k"):
        real[name] = getattr(pl, name)

        def wrapped(q, k, *a, _name=name):
            rows.append((_name, q.shape[0], k.shape[0]))
            return real[_name](q, k, *a)

        setattr(pl, name, wrapped)
    return rows, lambda: [setattr(pl, n, f) for n, f in real.items()]


def check_grads(tag, what, got, want, lg, lw, scale_logit=1):
    """Phase 5's bars: loss within 1e-2 relative, gradient cosine >= 0.999
    whole and >= 0.99 per tensor of 1e4 or more elements; `scale_logit`
    multiplies want's temperature gradient first. Returns (ok, bit-equal)."""
    if scale_logit != 1 and "logit_scale" in want:
        want = dict(want, logit_scale=want["logit_scale"] * scale_logit)
    whole, worst, worst_name = grad_cosines(got, want)
    equal = all(torch.equal(got[k], want[k]) for k in want)
    ok = np.isfinite(lg) and abs(lg - lw) <= 1e-2 * abs(lw) and whole >= 0.999 and worst >= 0.99
    log(f"{tag} {what}: loss {lg:.6f} vs {lw:.6f} (rel {abs(lg - lw) / abs(lw):.2e}); gradient "
        f"cosine whole {whole:.7f}, min per tensor {worst:.7f} at {worst_name}; bit-equal "
        f"{equal} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} {what}: gradients disagree")
    return ok, equal


def phase_options(card):
    """Phase 14: remat, accumulation, sgd/lion/adafactor and locking on
    full-width models at b256 (bf16, 'fusedp', the pallas loss), then the
    training CLI under those options. Returns ({path: launches}, {path:
    per-step launches}, perf)."""
    from types import SimpleNamespace

    from mrclip_tpu_torch import create_loss
    from mrclip_tpu_torch.ops import launch_counts, launches_since
    from mrclip_tpu_torch.ops import pallas_loss as pl
    from mrclip_tpu_torch.ops.image_ops import normalize_images
    from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                           make_loss_apply)
    from mrclip_tpu_torch.parallel.freeze import build_trainable_mask, chain_with_mask
    from mrclip_tpu_torch.parallel.optim import global_norm
    from mrclip_tpu_torch.parallel.train_step import loss_and_grads

    tag = "[options]"
    t_phase = time.perf_counter()
    dev = torch.device(CLI_DEVICE)
    paths, per_step, perf = {}, {}, {}
    args = dict(multipositiveloss=True, delta=0.5, gather_with_grad=True)
    pallas = make_loss_apply(create_loss(SimpleNamespace(**args, pallas_loss=True)))

    def make_batch(n, size, ctx, seed=0):
        rng = np.random.RandomState(seed)
        return {
            "images": normalize_images(torch.from_numpy(
                rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)).to(dev)),
            "tokens": torch.from_numpy(rng.randint(1, 49408, (n, ctx)).astype(np.int64)).to(dev),
            "labels": torch.from_numpy(rng.randint(0, 32, (n,)).astype(np.int32)).to(dev),
        }

    def grads_at(model, batch, peak=False):
        """(grads, loss, launches, peak bytes above the start) of one
        forward and backward."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        g, ld = loss_and_grads(model, pallas, dict(model.named_parameters()), batch)
        torch.cuda.synchronize()
        return g, ld["loss"].item(), launches_since(before), torch.cuda.max_memory_allocated() - base

    # 1. remat on ViT-B-16 b256: each policy's gradients against none's, its
    # launches, peak memory and step time
    model = build_model("ViT-B-16", "pallas", precision="bf16", attn_impl="fusedp",
                        gelu_approx=True, rng_seed=0)
    batch = make_batch(TRAIN_BATCH, model.visual.image_size[0], model.context_length)
    remat = {}
    g_none = None
    for policy in REMAT_POLICIES:
        set_remat(model, policy)
        g, loss, got, peak = grads_at(model, batch)
        want = {"packed_attn_fwd": 24 * (1 if policy is None else 2), "packed_attn_bwd": 24,
                **PALLAS_STEP}
        if policy is None:
            g_none, l_none = g, loss
            equal = True
        else:
            _, equal = check_grads(tag, f"remat {policy} vs none, ViT-B-16 b{TRAIN_BATCH}", g,
                                   g_none, loss, l_none)
        del g
        remat[str(policy)] = {"launches": got, "want": want, "peak_gb": peak / 1e9,
                              "bit_equal_to_none": equal}
        if got != want:
            raise AssertionError(f"{tag} remat {policy}: launches {got}, want {want}")
    del g_none
    torch.cuda.empty_cache()
    # the main path: each policy's train step, one warm-up and REMAT_TIMED timed
    tx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = create_train_state(model, tx)
    step = build_train_step(model, pallas, tx)
    reset_counts()
    for policy in REMAT_POLICIES:
        set_remat(model, policy)
        times = []
        for i in range(1 + REMAT_TIMED):
            before = launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            got = launches_since(before)
            if got != remat[str(policy)]["want"] or not np.isfinite(metrics["loss"].item()):
                raise AssertionError(f"{tag} remat {policy} step: launches {got}")
        remat[str(policy)]["step_ms"] = statistics.median(times[1:])
        remat[str(policy)]["step_ms_readings"] = times[1:]
    paths["options_remat"] = launch_counts()
    per_step["options_remat"] = remat["full"]["want"]
    for policy, r in remat.items():
        log(f"{tag} remat {policy}: K1/K3 per step {r['launches'].get('packed_attn_fwd')}/"
            f"{r['launches'].get('packed_attn_bwd')}, peak {r['peak_gb']:.2f} GB above the "
            f"weights, step {r['step_ms']:.2f} ms (median of {REMAT_TIMED}: "
            + ", ".join(f"{x:.2f}" for x in r["step_ms_readings"]) + f") | {card}")
    if not remat["full"]["peak_gb"] < remat["None"]["peak_gb"]:
        raise AssertionError(f"{tag} remat full does not peak below no remat")
    perf["remat_vit_b16"] = remat
    set_remat(model, None)
    del state, step, tx
    torch.cuda.empty_cache()

    # 2. accumulation on ViT-B-16: the cached mode at A x 64 against one b256
    # step, the plain mode against its four b64 losses
    m = TRAIN_BATCH // ACCUM
    rec = GradRecorder()
    state = create_train_state(model, rec)
    rows, undo = supcon_rows(pl)
    out = {}
    try:
        for name, kw in (("unsplit", {}), ("cached", dict(accum_freq=ACCUM, cached_features_accum=True)),
                         ("plain", dict(accum_freq=ACCUM))):
            rows.clear()
            before = launch_counts()
            _, metrics = build_train_step(model, pallas, rec, **kw)(state, batch)
            torch.cuda.synchronize()
            out[name] = (metrics["loss"].item(), rec.grads, launches_since(before), list(rows))
    finally:
        undo()
    (lu, gu, cu, ru), (lc, gc, cc, rc), (lp, gp, cp, rp) = (out[k] for k in ("unsplit", "cached", "plain"))
    check_grads(tag, f"cached accumulation {ACCUM} x {m} vs one b{TRAIN_BATCH} step (the "
                f"temperature's gradient {ACCUM}x)", gc, gu, lc, lu, scale_logit=ACCUM)
    with torch.no_grad():
        model.train()
        micro = [pallas(model(batch["images"][i * m:(i + 1) * m], batch["tokens"][i * m:(i + 1) * m]),
                        {"labels": batch["labels"][i * m:(i + 1) * m]})["loss"].item()
                 for i in range(ACCUM)]
    mean = sum(micro) / ACCUM
    want_c = {"packed_attn_fwd": 48 * ACCUM, "packed_attn_bwd": 24 * ACCUM,
              **{k: 2 * ACCUM for k in PALLAS_STEP}}
    want_p = {"packed_attn_fwd": 24 * ACCUM, "packed_attn_bwd": 24 * ACCUM,
              **{k: 2 * ACCUM for k in PALLAS_STEP}}
    ok = (abs(lp - mean) <= 1e-5 * abs(mean) and cc == want_c and cp == want_p
          and {r[1:] for r in rc} == {(TRAIN_BATCH, TRAIN_BATCH)} and {r[1:] for r in rp} == {(m, m)}
          and len(rc) == len(rp) == 6 * ACCUM)
    log(f"{tag} plain accumulation {ACCUM} x {m}: loss {lp:.7f}, the mean of its {ACCUM} b{m} "
        f"losses {mean:.7f} (rel {abs(lp - mean) / abs(mean):.2e}, tol 1e-5); launches per "
        f"optimizer step cached {cc} (want {want_c}), plain {cp} (want {want_p}); K6/K7 rows x "
        f"keys cached {sorted({r[1:] for r in rc})}, plain {sorted({r[1:] for r in rp})} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} the accumulation modes failed their checks")
    del gu, gc, gp, out, state, rec
    torch.cuda.empty_cache()
    # the main path: the cached mode at A x 256 (1024 rows through K6/K7)
    # and plain A x 64 beside one b256 step, AdamW
    tx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = create_train_state(model, tx)
    big = make_batch(ACCUM * ACCUM_BIG, model.visual.image_size[0], model.context_length, seed=1)
    accum = {}
    reset_counts()
    for name, b, kw in (("b256", batch, {}),
                        (f"cached_{ACCUM}x{ACCUM_BIG}", big,
                         dict(accum_freq=ACCUM, cached_features_accum=True)),
                        (f"plain_{ACCUM}x{m}", batch, dict(accum_freq=ACCUM))):
        step = build_train_step(model, pallas, tx, **kw)
        state, _ = step(state, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(2):
            state, metrics = step(state, b)
        torch.cuda.synchronize()
        accum[name] = {"step_ms": (time.perf_counter() - t) / 2 * 1e3,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "loss": metrics["loss"].item()}
        log(f"{tag} {name}: {accum[name]['step_ms']:.2f} ms per optimizer step (mean of 2), "
            f"{len(b['labels']) / accum[name]['step_ms'] * 1e3:.1f} pairs/s, peak "
            f"{accum[name]['peak_gb']:.2f} GB, loss {accum[name]['loss']:.5f} | {card}")
    paths["options_accum"] = launch_counts()
    per_step["options_accum"] = want_c
    perf["accumulation"] = accum
    del state, step, tx, big
    torch.cuda.empty_cache()

    # 3. the optimizers: one step each from captured gradients, against the
    # same optimizer on the CPU in float64
    g_card, _, _, _ = grads_at(model, batch)
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    g_cpu = {k: v.double().cpu() for k, v in g_card.items()}
    p_cpu = {k: v.double().cpu() for k, v in params0.items()}
    optim = {}
    for opt in ("sgd", "lion", "adafactor"):
        tx = create_optimizer(lr=OPT_LR[opt], wd=0.2, opt=opt,
                              moments_dtype="bfloat16" if opt == "lion" else None)
        ref_tx = create_optimizer(lr=OPT_LR[opt], wd=0.2, opt=opt)
        params = {k: v.clone() for k, v in params0.items()}
        t = time.perf_counter()
        st = tx.update(g_card, tx.init(params), params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        ref_p = {k: v.clone() for k, v in p_cpu.items()}
        ref = ref_tx.update(g_cpu, ref_tx.init(ref_p), ref_p)
        worst_p, flips, n_el = 0.0, 0, 0
        for k, p in params.items():
            got, want, p0 = p.double().cpu(), ref_p[k], p_cpu[k]
            step_max = (want - p0).abs().max().item()
            err = (got - want).abs()
            if opt == "lion":  # a flipped sign moves an element by 2 lr
                flips += int((err > OPT_LR[opt]).sum())
                err = torch.where(err > OPT_LR[opt], torch.zeros_like(err), err)
            worst_p = max(worst_p, ((err - 2.0 ** -22 * want.abs()).clamp_min(0).max().item())
                          / max(step_max, 1e-30))
            n_el += p.numel()
        worst_s = 0.0
        for field in ("trace", "mu", "v_row", "v_col", "v"):
            if not hasattr(st, field):
                continue
            for k, v in getattr(st, field).items():
                want = getattr(ref, field)[k]
                worst_s = max(worst_s, (v.double().cpu() - want).abs().max().item()
                              / max(want.abs().max().item(), 1e-30))
        state_tol = 2.0 ** -8 if opt == "lion" else 1e-5
        ok = worst_p <= 1e-3 and worst_s <= state_tol and flips / n_el <= 1e-4
        optim[opt] = {"update_ms": ms, "param_err_of_largest_update": worst_p,
                      "state_rel_err": worst_s, "sign_flip_share": flips / n_el}
        log(f"{tag} {opt} (lr {OPT_LR[opt]}, wd 0.2{', bf16 mu' if opt == 'lion' else ''}) one step "
            f"on the card vs float64 on the CPU: parameters within {worst_p:.2e} of each tensor's "
            f"largest update past one fp32 rounding (<= 1e-3), state {worst_s:.2e} of its largest "
            f"(<= {state_tol:g}), elements with a flipped sign {flips} of {n_el} "
            f"({flips / n_el:.2e}, <= 1e-4); update {ms:.1f} ms host {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} {opt} disagrees with its float64 run")
        del params, st
    perf["optimizers"] = optim
    del g_cpu, p_cpu, ref_p, ref
    torch.cuda.empty_cache()

    # 4. locking and freezing: frozen parameters bit-unchanged, the others
    # move, grad_norm over every gradient
    with torch.no_grad():
        for k, v in model.named_parameters():
            v.copy_(params0[k])
    full_norm = global_norm(g_card.values()).item()
    freeze = {}
    for name, flags in (("--lock-image", dict(lock_image=True)),
                        ("--freeze --freezelast", dict(freeze=True, freezelast=True))):
        tx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
        state = create_train_state(model, tx)
        mask = build_trainable_mask(state.params, SimpleNamespace(**flags))
        tx = chain_with_mask(tx, mask)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        state, metrics = build_train_step(model, pallas, tx)(state, batch)
        torch.cuda.synchronize()
        frozen = [k for k, v in mask.items() if v == 0.0]
        still = all(torch.equal(state.params[k], before[k]) for k in frozen)
        moved = sum(not torch.equal(state.params[k], before[k]) for k in mask if mask[k] == 1.0)
        norm = metrics["grad_norm"].item()
        ok = (frozen and still and moved == len(mask) - len(frozen)
              and abs(norm - full_norm) <= 1e-3 * full_norm)
        freeze[name] = {"frozen": len(frozen), "trainable_moved": moved, "grad_norm": norm}
        log(f"{tag} {name}: {len(frozen)} frozen tensors bit-unchanged "
            f"{still}, {moved} of {len(mask) - len(frozen)} others moved; grad_norm {norm:.6f} "
            f"vs every gradient's {full_norm:.6f} (the frozen towers counted) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} {name} failed its checks")
        with torch.no_grad():
            for k, v in model.named_parameters():
                v.copy_(params0[k])
        del state, tx
    perf["freezing"] = freeze
    del model, params0, g_card, batch
    torch.cuda.empty_cache()

    # 5. EVA02-B-16 (K2/K3r) and MobileCLIP-S1 (K8/K9) under remat: one
    # checked step each against no remat
    for name, attn, want in (
            ("EVA02-B-16", "fusedp", {"packed_attn_rope_fwd": 24, "packed_attn_fwd": 24,
                                      "packed_attn_rope_bwd": 12, "packed_attn_bwd": 12,
                                      **PALLAS_STEP}),
            ("MobileCLIP-S1", "bf16", {"dw_conv_fwd": 73 + 72, "dw_conv_bwd": 73,
                                       **PALLAS_STEP})):
        model = build_model(name, "pallas", precision="bf16", attn_impl=attn, gelu_approx=True,
                            rng_seed=0)
        size = model.visual.image_size[0]
        b = make_batch(TRAIN_BATCH, size, model.context_length)
        bufs = {k: v.clone() for k, v in model.named_buffers()}
        n_bn = sum(isinstance(mod, torch.nn.modules.batchnorm._BatchNorm) for mod in model.modules())
        g0, l0, c0, _ = grads_at(model, b)
        g0 = {k: v.float() for k, v in g0.items()}
        set_remat(model, "dots")
        reset_counts()
        g1, l1, c1, _ = grads_at(model, b)
        key = "options_remat_" + ("eva02" if name.startswith("EVA") else "mobileclip")
        paths[key], per_step[key] = launch_counts(), want
        check_grads(tag, f"{name} remat dots vs none", g1, g0, l1, l0)
        same_bufs = all(torch.equal(v, bufs[k]) for k, v in model.named_buffers())
        ok = c1 == want and same_bufs
        log(f"{tag} {name} remat dots: launches {c1} (want {want}; without remat {c0}); "
            f"BatchNorm modules {n_bn}, buffers unchanged {same_bufs} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} {name} under remat failed its checks")
        if name == "MobileCLIP-S1":
            # --lock-image --lock-image-freeze-bn-stats: the tower's parameters
            # and statistics unchanged by a step
            set_remat(model, None)
            tx = create_optimizer(lr=1e-4, wd=0.2)
            state = create_train_state(model, tx)
            tx = chain_with_mask(tx, build_trainable_mask(state.params,
                                                          SimpleNamespace(lock_image=True)))
            vis = {k: v.detach().clone() for k, v in state.params.items() if k.startswith("visual.")}
            state, _ = build_train_step(model, pallas, tx, freeze_bn_subtrees=("visual",))(state, b)
            torch.cuda.synchronize()
            ok = (all(torch.equal(state.params[k], v) for k, v in vis.items())
                  and all(torch.equal(v, bufs[k]) for k, v in model.named_buffers()))
            log(f"{tag} MobileCLIP-S1 --lock-image --lock-image-freeze-bn-stats: {len(vis)} visual "
                f"tensors and the {sum(1 for _ in model.buffers())} buffers (BatchNorm "
                f"statistics: none in the from-scratch FastViT) unchanged {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag} the locked MobileCLIP-S1 tower moved")
            del state, tx
        del model, g0, g1, b
        torch.cuda.empty_cache()

    # 6. the CLI under the options
    cli_paths, cli_per_step, perf["cli"] = phase_options_cli(card)
    paths.update(cli_paths)
    per_step.update(cli_per_step)
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag} phase wall {perf['phase_s']:.1f} s | {card}")
    log(f"{tag} breakdown: " + json.dumps(perf))
    return paths, per_step, perf


OPT_CLI_RUNS = {
    # name: (flags, per optimizer step, per val batch)
    "options": (["--accum-freq", "2", "--cached-features-accum", "--grad-checkpointing",
                 "--remat-policy", "dots", "--opt", "lion", "--bf16-moments", "--freeze",
                 "--freezelast", "--pallas-loss"],
                {"packed_attn_fwd": 48 * 2 + 24 * 2, "packed_attn_bwd": 24 * 2,
                 **{k: 2 * 2 for k in PALLAS_STEP}}, {"packed_attn_fwd": 24}),
    "adafactor": (["--opt", "adafactor", "--pallas-loss"],
                  {"packed_attn_fwd": 24, "packed_attn_bwd": 24, **PALLAS_STEP}, None),
    "sgd": (["--opt", "sgd", "--pallas-loss"],
            {"packed_attn_fwd": 24, "packed_attn_bwd": 24, **PALLAS_STEP}, None),
    "visiononly": (["--visiononly"], {"packed_attn_fwd": 12, "packed_attn_bwd": 12},
                   {"packed_attn_fwd": 12}),
}


def phase_options_cli(card):
    """`python -m mrclip_tpu_torch.train.main` on `--dataset-type
    synthetic` (224 px) under the options of OPT_CLI_RUNS: the first for one
    epoch with a val pass and `--resume latest` for exactly one more (the
    restored state bit-equal to its checkpoint), adafactor and sgd for one
    short epoch, the vision-only path for one epoch with its eval (its
    metrics in results.jsonl); the exact launches of each epoch and val pass
    from the runs' logs."""
    from mrclip_tpu_torch import checkpoint as ckpt
    from mrclip_tpu_torch.factory import create_model
    from mrclip_tpu_torch.parallel import create_optimizer, create_train_state

    tag = "[options-cli]"
    tmp = tempfile.TemporaryDirectory(prefix="mrclip_options_")
    logs = os.path.join(tmp.name, "logs")
    paths, per_step, perf = {}, {}, {}
    mod = "mrclip_tpu_torch.train.main"
    for run, (flags, want_step, want_eval) in OPT_CLI_RUNS.items():
        batch = OPT_CLI_BATCH if run == "options" else 2 * OPT_CLI_BATCH
        accum = 2 if run == "options" else 1
        n_steps = OPT_CLI_SAMPLES[run] // (batch * accum)
        common = ["--dataset-type", "synthetic", "--train-num-samples", str(OPT_CLI_SAMPLES[run]),
                  "--model", CLI_MODEL, "--attn-impl", "fusedp", "--multipositiveloss",
                  "--batch-size", str(batch), "--precision", "amp", "--workers", "8",
                  "--lr", "1e-4", "--wd", "0.2", "--skip-scheduler", "--gelu-approx",
                  "--seed", "0", "--log-every-n-steps", "1", "--logs", logs, "--name", run,
                  "--device", CLI_DEVICE, *flags]
        if want_eval is not None:  # the synthetic val set is as large as the train set
            common += ["--val-data", "synthetic"]
        _, perf[f"{run}_s"] = _run_cli(tag, [mod, *common, "--epochs", "1"],
                                       os.path.join(tmp.name, f"{run}.log"))
        epochs = 1
        ckdir = os.path.join(logs, run, "checkpoints")
        if run == "options":
            saved = ckpt.load_checkpoint(ckdir, 1)
            _, perf[f"{run}_resume_s"] = _run_cli(
                tag, [mod, *common, "--epochs", "2", "--resume", "latest"],
                os.path.join(tmp.name, f"{run}_resume.log"))
            epochs = 2
        steps, train_launch, eval_launch = _cli_log(os.path.join(logs, run, "out.log"))
        want_train = _scaled(want_step, n_steps)
        n_val = -(-OPT_CLI_SAMPLES[run] // batch)
        want_ev = None if want_eval is None else _scaled(want_eval, n_val)
        with open(os.path.join(logs, run, "out.log")) as f:
            text = f.read()
        results = []
        if want_eval is not None:
            with open(os.path.join(ckdir, "results.jsonl")) as f:
                results = [json.loads(line) for line in f]
        losses = [float(x) for x in __import__("re").findall(r"Loss: (\S+) ", text)]
        ok = (train_launch == {e: want_train for e in range(epochs)}
              and (want_eval is None
                   or eval_launch == {e: want_ev for e in range(1, epochs + 1)})
              and all(np.isfinite(losses)) and len(losses) >= epochs * n_steps
              and ckpt.saved_steps(ckdir)[-1] == epochs)
        if run == "visiononly":
            ok = ok and "image_to_image_R@1" in results[-1] and "vision_only_val_loss" in results[-1]
        if run == "options":
            ok = ok and "=> resuming checkpoint (epoch 1)" in text and "Frozen: " in text
        log(f"{tag} {run} ({' '.join(flags)}): {epochs} epoch(s) of {n_steps} optimizer steps "
            f"(b{batch} x {accum}); losses {', '.join(f'{x:.4f}' for x in losses)}; launches per "
            f"epoch {train_launch.get(0)} (want {want_train})"
            + (f", per val pass {eval_launch.get(1)} (want {want_ev})" if want_ev is not None
               else "")
            + (f"; results {sorted(k for k in results[-1] if 'R@1' in k or 'val_loss' in k)}"
               if results else "") + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} the {run} CLI run failed its checks: {train_launch} "
                                 f"{eval_launch}")
        paths[f"cli_{run}"] = {k: sum(e.get(k, 0) for e in train_launch.values()) for k in want_train}
        per_step[f"cli_{run}"] = want_step
        if run == "options":
            # the resumed optimizer state: the epoch-1 checkpoint onto the card, bit-equal
            model = create_model(CLI_MODEL, precision="amp", device=CLI_DEVICE, attn_impl="fusedp",
                                 gelu_approx=True, rng_seed=0)
            tx = create_optimizer(lr=1e-4, wd=0.2, opt="lion", moments_dtype="bfloat16")
            state = ckpt.load_checkpoint(ckdir, 1, template=create_train_state(model, tx))
            same = (state.step == saved["step"] == n_steps and state.opt_state.count == n_steps
                    and all(torch.equal(state.params[k].cpu(), v) for k, v in saved["params"].items())
                    and all(torch.equal(state.opt_state.mu[k].cpu(), v)
                            for k, v in saved["opt_state"]["mu"].items())
                    and all(v.dtype == torch.bfloat16 for v in state.opt_state.mu.values()))
            after = ckpt.load_checkpoint(ckdir, 2)
            same = same and after["opt_state"]["count"] == 2 * n_steps
            log(f"{tag} the epoch-1 checkpoint restored onto {CLI_DEVICE}: step {state.step}, "
                f"parameters and Lion's bf16 mu bit-equal {same}; epoch 2 counts "
                f"{after['opt_state']['count']} steps {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"{tag} the resumed Lion state differs from its checkpoint")
            del model, state, tx, saved, after
            if CLI_DEVICE == "cuda":
                torch.cuda.empty_cache()
    tmp.cleanup()
    return paths, per_step, perf


# The fast input path (phase 15): the native C++ loader and the augmentation
# and eval preprocessing on the card, on phase 13's study. `FAST_*` size it;
# a CPU rehearsal may cut them.
FAST_CANVAS = 256  # the canvas random_augment_batch takes to 224 on the card
FAST_SIZE = (224, 224)
FAST_TIMED = 10
FAST_APPLY_ROWS = 64  # rows of the card-vs-CPU apply check (the CPU's share is slow)
FAST_APPLY_TOL = 1e-4  # normalised values: fp32 order and the card's FMAs
FAST_JITTER = dict(color_jitter=(0.4, 0.4, 0.4, 0.1), color_jitter_prob=0.8,
                   gray_scale_prob=0.2)
FAST_RUNS = {"native": (["--native-loader"], 1), "device": (["--device-augment"], 1)}


def _host_images_per_s(fn, n):
    """Images/s of one fn() that makes n images, after one warm call (the
    files then sit in the page cache: warm reads)."""
    out, status = fn()
    if not (status == 0).all():
        raise AssertionError(f"[fast-input] {int((status != 0).sum())} of {n} images failed")
    t = time.perf_counter()
    fn()
    return n / (time.perf_counter() - t)


def phase_fast_input(card, study, cli_perf):
    """Phase 15: the fast input path. Builds the native library (the port's
    C++ copy, the system compiler, zlib); times its `load_batch` (cover,
    bicubic) and `augment_batch` (the MR-CLIP warp and blur) on a b256 of
    phase 13's slices at 1 thread and every core, beside phase 13's host
    transforms; times `random_augment_batch` and `eval_preprocess_batch` on
    the card at b256 from 256 x 256 uint8 canvases to 224 x 224 and holds the
    deterministic apply (with the colour extras) and the eval preprocessing
    on the card against the CPU on the same draws; then trains the CLI on
    phase 13's CSVs under `--native-loader` and `--device-augment` (one
    epoch each, a val pass): the exact launches per epoch and
    per val pass, finite losses and metrics, pairs/s and the data-time
    share beside phase 13's. Returns ({path: launches}, {path: per-step or
    per-batch launches}, perf) and removes the study."""
    from mrclip_tpu_torch import native
    from mrclip_tpu_torch.ops import build, image_ops

    tag = "[fast-input]"
    t_phase = time.perf_counter()
    perf = {}

    # 1. the host library, built here from the checkout's sources
    t = time.perf_counter()
    native.library()
    perf["build_s"] = time.perf_counter() - t
    info = build.build_info("mrclip_native")
    cxx = subprocess.run([build._find_cxx(), "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    ldd = subprocess.run(["ldd", info["path"]], capture_output=True, text=True).stdout
    zlib = next((line.strip() for line in ldd.splitlines() if "libz." in line), "no libz in ldd")
    how = (f"built in {perf['build_s']:.2f} s: {info['command']}" if "command" in info else
           f"loaded, built earlier with {' '.join(build.HOST_CXX_FLAGS + build.HOST_LIBS)}")
    log(f"{tag} native library {info['path']} {how}; compiler {cxx}; zlib: {zlib}")

    # 2. the host side: one b256 of phase 13's train slices
    paths = [r["filepath"] for r in study["splits"]["train"][:CLI_BATCH]]
    n = len(paths)
    mats = native.augment_matrices(np.random.RandomState(0), n,
                                   src_sizes=[native.png_size(p) for p in paths])
    sigmas = np.random.RandomState(1).uniform(0.1, 2.0, n).astype(np.float32)
    cores = os.cpu_count() or 1
    for k in (1, cores):
        perf[f"load_{k}t_images_per_s"] = _host_images_per_s(lambda: native.load_batch(
            paths, FAST_SIZE, num_threads=k, resize_mode="cover", interpolation="bicubic"), n)
        perf[f"augment_{k}t_images_per_s"] = _host_images_per_s(lambda: native.augment_batch(
            paths, FAST_SIZE, mats, sigmas, num_threads=k), n)
    log(f"{tag} host, b{n} of {CLI_SHAPE[0]} x {CLI_SHAPE[1]} slices to {FAST_SIZE[0]} px "
        f"(warm file cache): native load_batch (cover, bicubic) "
        f"{perf['load_1t_images_per_s']:.1f} images/s on 1 thread, "
        f"{perf[f'load_{cores}t_images_per_s']:.1f} on {cores}; native "
        f"augment_batch (warp + blur) {perf['augment_1t_images_per_s']:.1f} on 1, "
        f"{perf[f'augment_{cores}t_images_per_s']:.1f} on {cores}; phase 13's host transforms "
        f"on 1 thread: train {cli_perf['train_transform_images_per_s']:.1f}, eval "
        f"{cli_perf['eval_transform_images_per_s']:.1f} | {card}")

    # where one train batch of the native loader's producer goes: its
    # Python (header sizes, matrices, tokens) around the C++ call, and the
    # pinned copy
    from types import SimpleNamespace

    from mrclip_tpu_torch.data.loader import _pinned
    from mrclip_tpu_torch.data.native_loader import NativeBatchLoader
    from mrclip_tpu_torch.factory import get_tokenizer

    dev = torch.device(CLI_DEVICE)
    rows = study["splits"]["train"][:n]
    ds = SimpleNamespace(images=paths, captions=[r["text"] for r in rows],
                         labels=[int(r["label"]) for r in rows])
    loader = NativeBatchLoader(ds, n, canvas_size=FAST_SIZE, tokenizer=get_tokenizer(CLI_MODEL),
                               num_threads=cores, augment=True)
    parts = {
        "sizes": lambda: [native.png_size(p) for p in paths],
        "matrices": lambda: native.augment_matrices(np.random.RandomState(0), n,
                                                    src_sizes=[native.png_size(p) for p in paths]),
        "c++": lambda: native.augment_batch(paths, FAST_SIZE, mats, sigmas, num_threads=cores),
        "first_batch": lambda: loader._make_batch(range(n)),  # each caption tokenised once
        "batch": lambda: loader._make_batch(range(n)),  # from the token cache, as later
    }
    producer = {}
    for name, fn in parts.items():
        t = time.perf_counter()
        out = fn()
        producer[name] = (time.perf_counter() - t) * 1e3
    producer["pin"] = None
    if dev.type == "cuda":
        t = time.perf_counter()
        _pinned(out)
        producer["pin"] = (time.perf_counter() - t) * 1e3
    perf["producer_ms"] = producer
    log(f"{tag} native producer, one b{n} train batch, host clock: PNG header sizes "
        f"{producer['sizes']:.1f} ms, augment_matrices (sizes included) "
        f"{producer['matrices']:.1f}, the C++ decode + warp + blur on {cores} threads "
        f"{producer['c++']:.1f}; the whole _make_batch {producer['first_batch']:.1f} with the "
        f"captions tokenised, {producer['batch']:.1f} from the token cache; the pinned copy "
        f"{fmt_ms(producer['pin'])} | {card}")

    # 3. the card side at b256, from 256 x 256 canvases of the same slices
    canvases, _ = native.load_batch(paths, (FAST_CANVAS, FAST_CANVAS), num_threads=cores,
                                    resize_mode="cover")
    x = torch.from_numpy(canvases).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = {
        "random_augment_ms": lambda: image_ops.random_augment_batch(x, gen, out_size=FAST_SIZE),
        "random_augment_colour_ms": lambda: image_ops.random_augment_batch(
            x, gen, out_size=FAST_SIZE, **FAST_JITTER),
        "eval_preprocess_ms": lambda: image_ops.eval_preprocess_batch(x, out_size=FAST_SIZE),
        "normalize_ms": lambda: image_ops.normalize_images(x),
    }
    for name, fn in timed.items():
        perf[name] = cuda_ms(fn, FAST_TIMED) if dev.type == "cuda" else None
    rows = FAST_APPLY_ROWS
    draws = image_ops.draw_augment(rows, (FAST_CANVAS, FAST_CANVAS),
                                   torch.Generator().manual_seed(3), out_size=FAST_SIZE,
                                   **FAST_JITTER)
    kw = dict(out_size=FAST_SIZE, color_jitter=FAST_JITTER["color_jitter"])
    on_card = image_ops.apply_augment(x[:rows], draws, **kw).cpu()
    on_cpu = image_ops.apply_augment(x[:rows].cpu(), draws, **kw)
    perf["apply_max_abs_err"] = float((on_card - on_cpu).abs().max())
    ev_card = image_ops.eval_preprocess_batch(x[:rows], out_size=FAST_SIZE).cpu()
    ev_cpu = image_ops.eval_preprocess_batch(x[:rows].cpu(), out_size=FAST_SIZE)
    perf["eval_max_abs_err"] = float((ev_card - ev_cpu).abs().max())
    ok = (perf["apply_max_abs_err"] <= FAST_APPLY_TOL and perf["eval_max_abs_err"] <= FAST_APPLY_TOL
          and bool(torch.isfinite(on_card).all()) and on_card.shape == (rows, *FAST_SIZE, 3))
    log(f"{tag} card, b{n} from {FAST_CANVAS}^2 uint8 to {FAST_SIZE[0]}^2: random_augment_batch "
        f"{fmt_ms(perf['random_augment_ms'])} ms (with the colour extras "
        f"{fmt_ms(perf['random_augment_colour_ms'])}), eval_preprocess_batch "
        f"{fmt_ms(perf['eval_preprocess_ms'])}, normalize_images {fmt_ms(perf['normalize_ms'])} "
        f"(CUDA events, mean of {FAST_TIMED}); the apply on the card vs the CPU on the same "
        f"draws (b{rows}, colour extras): max|err| {perf['apply_max_abs_err']:.2e}, the eval "
        f"preprocessing {perf['eval_max_abs_err']:.2e} (tol {FAST_APPLY_TOL}) "
        f"{'ok' if ok else 'FAIL'} | {card}")
    if not ok:
        raise AssertionError(f"{tag} the card's augmentation disagrees with the CPU's")
    del x, on_card, on_cpu, ev_card, ev_cpu
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 4. the training CLI on phase 13's CSVs under each option
    logs = os.path.join(study["tmp"].name, "fast_logs")
    n_steps = len(study["splits"]["train"]) // CLI_BATCH
    n_val = -(-len(study["splits"]["val"]) // CLI_BATCH)
    want_train, want_eval = _scaled(CLI_PER_STEP, n_steps), _scaled(CLI_EVAL_PER_BATCH, n_val)
    paths_out, per_step = {}, {}
    for run, (extra, epochs) in FAST_RUNS.items():
        name = f"fast_{run}"
        _, perf[f"{run}_run_s"] = _run_cli(
            tag, ["mrclip_tpu_torch.train.main", *_cli_flags(study["work"], logs, name, cores),
                  *extra, "--epochs", str(epochs)], os.path.join(study["tmp"].name, f"{name}.log"))
        steps, train_launch, eval_launch = _cli_log(os.path.join(logs, name, "out.log"))
        with open(os.path.join(logs, name, "checkpoints", "results.jsonl")) as f:
            results = [json.loads(line) for line in f]
        finite = (all(np.isfinite(st[1]) for st in steps)
                  and all(np.isfinite(v) for r in results for v in r.values()
                          if isinstance(v, (int, float))))
        ok = (finite and len(steps) == epochs * n_steps
              and [r["epoch"] for r in results] == list(range(1, epochs + 1))
              and train_launch == {e: want_train for e in range(epochs)}
              and eval_launch == {e: want_eval for e in range(1, epochs + 1)})
        rates = _cli_rates(steps, n_steps)
        perf[run] = rates
        log(f"{tag} train CLI {' '.join(extra)}: {len(steps)} steps over {epochs} epoch(s) "
            f"({n_steps} an epoch, b{CLI_BATCH}, {cores} threads), losses "
            + ", ".join(f"{st[1]:.4f}" for st in steps) + "; val R@1 i2t "
            + ", ".join(f"{r.get('image_to_text_general_R@1', float('nan')):.3f}" for r in results)
            + f"; launches per epoch {train_launch.get(0)} (want {want_train}), per val pass "
            f"{eval_launch.get(1)} (want {want_eval}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} the {' '.join(extra)} CLI run failed its checks: "
                                 f"{train_launch} {eval_launch} {results}")
        steady = ("n/a (one step an epoch)" if rates["cli_steady_pairs_per_s"] is None else
                  f"{rates['cli_steady_batch_ms']:.1f} ms a step, "
                  f"{rates['cli_steady_pairs_per_s']:.1f} pairs/s, data-time share "
                  f"{rates['cli_steady_data_time_share']:.3f}")
        log(f"{tag} train CLI {' '.join(extra)}, all {len(steps)} steps: "
            f"{rates['cli_pairs_per_s']:.1f} pairs/s, data-time share "
            f"{rates['cli_data_time_share']:.3f}; each epoch's first step "
            + ", ".join(f"{v:.2f}" for v in rates["cli_first_step_s"]) + " s (data "
            + ", ".join(f"{v:.2f}" for v in rates["cli_first_step_data_s"]) + f" s); after it "
            f"{steady}. Phase 13 (the host transforms) in this run: "
            f"{cli_perf['cli_pairs_per_s']:.1f} pairs/s, share "
            f"{cli_perf['cli_data_time_share']:.3f}; after each first step "
            f"{cli_perf['cli_steady_pairs_per_s']:.1f} pairs/s, share "
            f"{cli_perf['cli_steady_data_time_share']:.3f} | {card}")
        paths_out[name] = {k: sum(e.get(k, 0) for e in train_launch.values()) for k in want_train}
        paths_out[f"{name}_eval"] = {k: sum(e.get(k, 0) for e in eval_launch.values())
                                     for k in want_eval}
        per_step[name], per_step[f"{name}_eval"] = CLI_PER_STEP, CLI_EVAL_PER_BATCH
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag} phase wall {perf['phase_s']:.1f} s | {card}")
    log(f"{tag} breakdown: " + json.dumps(perf))
    study["tmp"].cleanup()
    return paths_out, per_step, perf


# Phase 16: the attention kernels at the head widths of the large public
# CLIP towers (ViT-H-14 80, ViT-g-14 88, ViT-bigG-14 104), and those towers
# at full width through the serving and training entry points
WIDE_MODELS = {80: "ViT-H-14", 88: "ViT-g-14", 104: "ViT-bigG-14"}
# ViT-L-14's vision tower: D = 64 at the same N = 257, one key past the D =
# 64 wgmma route (its rope sibling EVA02-L-14 runs K2 there)
L14_MODEL = "ViT-L-14"
# their vision towers: 16 x 16 patches of 14 px and the class token, 16 heads
WIDE_VISION = dict(b=32, n=257, nk=257, h=16, causal=False)
# the tensor-core tiles' edges; N = 400: K10's two jax key blocks of 256,
# each staged in two chunks past D = 80 (attn_mma_fwd.cuh's mma_max_chunk)
WIDE_EDGES = [dict(b=2, n=n, nk=n, h=2, causal=c) for n in (1, 15, 17, 65, 257)
              for c in (False, True)] + [dict(b=2, n=400, nk=400, h=2, causal=False)]
WIDE_TIMED = 3  # timed ViT-H-14 steps at b256
WIDE_STEP_BATCH = 32  # ViT-g-14 and ViT-bigG-14: one step each
# served bf16 features (kernels) against the same weights' fp32 plain path:
# bf16 rounding through 32 vision and 24 text layers, not summation order
WIDE_SERVE_COS = 0.99
# the train step's whole gradient, kernel vs plain attention, both bf16: the
# two paths' roundings drift apart layer by layer, and these towers have 56
# to 80 layers against ViT-B-16's 24 (phase 5 reads 0.9999 there, ViT-H-14
# 0.9987 at b32); a wrong kernel falls far below
WIDE_GRAD_COS = 0.995
ATTN_PAIRS = {"K1/K3": ("packed_attn_fwd", "packed_attn_bwd"),
              "K4/K5": ("grouped_attn_fwd", "grouped_attn_bwd"),
              "K10/K10b": ("flash_attn_fwd", "flash_attn_bwd")}


def wide_pairs(shape, dtype, gen):
    """K1/K3, K4/K5 and K10/K10b on one set of inputs (q, k, v as the column
    slices of one projection; the grouped copies for K4/K5, [B, N, H, D]
    views for K10/K10b): {pair: ((kernel o, stats), (plain o, stats), stat
    kinds, kernel grads, plain grads)}."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    h, d, causal = shape["h"], shape["d"], shape["causal"]
    q, k, v = qkv_slices(shape, dtype, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    out = {}
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h)
    got = fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal, heads=h)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.fused_attention_packed_ref(q, k, v, is_causal=causal, heads=h)
    want = fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=causal, heads=h)
    out["K1/K3"] = ((o, [lse]), (o_ref, [lse_ref]), ["lse"], got, want)
    qg, kg, vg, dog = (fa.group_heads(t.unflatten(-1, (h, d))) for t in (q, k, v, do))
    o, lse = fa.fused_attention_grouped(qg, kg, vg, is_causal=causal)
    got = fa.fused_attention_grouped_bwd(qg, kg, vg, o, dog, lse, is_causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.fused_attention_ref(qg, kg, vg, is_causal=causal)
    want = fa.fused_attention_bwd_ref(qg, kg, vg, o, dog, lse, is_causal=causal)
    out["K4/K5"] = ((o, [lse]), (o_ref, [lse_ref]), ["lse"], got, want)
    q3, k3, v3, do3 = (t.unflatten(-1, (h, d)) for t in (q, k, v, do))
    o, l, m = fl.flash_attention(q3, k3, v3, is_causal=causal)
    di = fl.flash_di(o, do3)
    got = fl.flash_attention_bwd(q3, k3, v3, do3, l, m, di, is_causal=causal)
    torch.cuda.synchronize()
    o_ref, l_ref, m_ref = fl.flash_attention_ref(q3, k3, v3, is_causal=causal)
    want = fl.flash_attention_bwd_ref(q3, k3, v3, do3, l, m, di, is_causal=causal)
    out["K10/K10b"] = ((o, [l, m]), (o_ref, [l_ref, m_ref]), ["l", "m"], got, want)
    return out


def wide_timings(shape, gen, backward=True):
    """bf16 K1, K4, K10 and SDPA's forward, K3, K5, K10b and SDPA's backward
    (not without `backward`) at one shape: medians of FWD_RUNS event
    readings and the profiler's device time per launch, in turns with the
    kernels' mma.sync route (MMA_SYNC_LIBS: "mma_sync_ms"), the plain
    versions' times, the bounds; two runs of each forward and backward
    bit-equal. {kernel name: timing dict}."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    bf16 = torch.bfloat16
    h, d, causal = shape["h"], shape["d"], shape["causal"]
    q, k, v = qkv_slices(shape, bf16, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(bf16)
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h)
    qg, kg, vg, dog = (fa.group_heads(t.unflatten(-1, (h, d))) for t in (q, k, v, do))
    og, lseg = fa.fused_attention_grouped(qg, kg, vg, is_causal=causal)
    q3, k3, v3, do3 = (t.unflatten(-1, (h, d)) for t in (q, k, v, do))
    of, l, m = fl.flash_attention(q3, k3, v3, is_causal=causal)
    di = fl.flash_di(of, do3)
    q4, k4, v4, do4 = (t.transpose(1, 2) for t in (q3, k3, v3, do3))
    fwd = {"packed_attn_fwd": lambda: fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h),
           "grouped_attn_fwd": lambda: fa.fused_attention_grouped(qg, kg, vg, is_causal=causal),
           "flash_attn_fwd": lambda: fl.flash_attention(q3, k3, v3, is_causal=causal),
           "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
               q4, k4, v4, is_causal=causal)}
    fwd.update({f"{name}@mma_sync": on_libraries(fwd[name], MMA_SYNC_LIBS)
                for name in ("packed_attn_fwd", "grouped_attn_fwd", "flash_attn_fwd")})
    bwd = {"packed_attn_bwd": lambda: fa.fused_attention_packed_bwd(
               q, k, v, o, do, lse, is_causal=causal, heads=h),
           "grouped_attn_bwd": lambda: fa.fused_attention_grouped_bwd(
               qg, kg, vg, og, dog, lseg, is_causal=causal),
           "flash_attn_bwd": lambda: fl.flash_attention_bwd(
               q3, k3, v3, do3, l, m, di, is_causal=causal)}
    bwd.update({f"{name}@mma_sync": on_libraries(bwd[name], MMA_SYNC_LIBS) for name in list(bwd)})
    if not backward:
        bwd = {}
    plain = {"packed_attn_fwd": lambda: fa.fused_attention_packed_ref(
                 q, k, v, is_causal=causal, heads=h),
             "grouped_attn_fwd": lambda: fa.fused_attention_ref(qg, kg, vg, is_causal=causal),
             "flash_attn_fwd": lambda: fl.flash_attention_ref(q3, k3, v3, is_causal=causal),
             "packed_attn_bwd": lambda: fa.fused_attention_packed_bwd_ref(
                 q, k, v, o, do, lse, is_causal=causal, heads=h),
             "grouped_attn_bwd": lambda: fa.fused_attention_bwd_ref(
                 qg, kg, vg, og, dog, lseg, is_causal=causal),
             "flash_attn_bwd": lambda: fl.flash_attention_bwd_ref(
                 q3, k3, v3, do3, l, m, di, is_causal=causal)}
    t_fwd, r_fwd = median_ms(fwd, 20)
    t_bwd, r_bwd = median_ms(bwd, 10)
    dev = {**device_ms(fwd), **device_ms(bwd)}
    sdpa_bwd = sdpa_ms(q4, k4, v4, do4, causal)[1] if backward else None
    args = {key: shape[key] for key in ("b", "n", "nk", "h", "d", "causal")}
    bounds = {"packed_attn_fwd": attention_bound(**args, dtype=bf16),
              "grouped_attn_fwd": attention_bound(**args, dtype=bf16),
              "flash_attn_fwd": flash_bound(**args, dtype=bf16),
              "packed_attn_bwd": attention_bwd_bound(**args, dtype=bf16),
              "grouped_attn_bwd": attention_bwd_bound(**args, dtype=bf16),
              "flash_attn_bwd": flash_bound(**args, dtype=bf16, backward=True)}
    out = {}
    for name, fn in {**fwd, **bwd}.items():
        if name == "sdpa" or "@" in name:
            continue
        is_bwd = name in bwd
        if not all(torch.equal(a, b) for a, b in zip(fn(), fn())):
            raise AssertionError(f"two bf16 {name} runs at {shape} differ")
        out[name] = dict(
            ms=(t_bwd if is_bwd else t_fwd)[name], device_ms=dev[name],
            readings=(r_bwd if is_bwd else r_fwd)[name],
            plain_ms=cuda_ms(plain[name], 2, warmup=1),
            library_ms=sdpa_bwd if is_bwd else t_fwd["sdpa"],
            library_device_ms=None if is_bwd else dev["sdpa"],
            bound_ms=bounds[name][0], bound_by=bounds[name][1])
        t = out[name]
        t["mma_sync_ms"] = (t_bwd if is_bwd else t_fwd)[f"{name}@mma_sync"]
        t["mma_sync_device_ms"] = dev[f"{name}@mma_sync"]
        log(f"[widths] {name} bf16 {shape}: kernel {t['ms']:.4f} ms (median of {FWD_RUNS}; "
            f"readings {min(t['readings']):.4f}-{max(t['readings']):.4f}), device "
            f"{fmt_ms(t['device_ms'])} ms per launch; the mma.sync route {t['mma_sync_ms']:.4f} "
            f"ms, device {fmt_ms(t['mma_sync_device_ms'])} "
            f"({'faster' if t['ms'] < t['mma_sync_ms'] else 'NOT faster'})"
            + f"; plain {t['plain_ms']:.4f} ms; SDPA "
            f"{'backward (fwd+bwd - fwd) ' if is_bwd else ''}{t['library_ms']:.4f} ms"
            + ("" if is_bwd else f" (device {fmt_ms(t['library_device_ms'])})")
            + f"; bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); two runs bit-equal")
    return out


def width_checks(shapes, gen):
    """K1/K3, K4/K5 and K10/K10b against their plain versions at `shapes`
    (phase 3's bars), bf16 and fp32. Returns {pair: {dtype: [max |o err|,
    max |grad err|, max relative grad err]}}."""
    bf16, fp32 = torch.bfloat16, torch.float32
    worst = {pair: {bf16: [0.0, 0.0, 0.0], fp32: [0.0, 0.0, 0.0]} for pair in ATTN_PAIRS}
    for shape in shapes:
        for dtype in (bf16, fp32):
            for pair, (fwd_out, ref_out, kinds, got, want) in wide_pairs(shape, dtype, gen).items():
                errs = check_attention(pair, shape, dtype, (fwd_out, ref_out, kinds), (got, want))
                worst[pair][dtype] = [max(a, b) for a, b in zip(worst[pair][dtype], errs)]
    return worst


WIDE_FWD_KEYS = 272  # the wide wgmma kernels' most rows (attn_mma_fwd.cuh's kWideKeys)


def width_device_kernels(shape, gen):
    """Which device kernels the six run at `shape` (profiler), bf16 and
    fp32, and the route each library names (`fwd_route`, `bwd_route`): the
    bf16 forwards on the route K1's library names, wgmma_wide_fwd_kernel up to
    WIDE_FWD_KEYS keys (K10 in its several-block MULTI form where jax walks
    more than one key block) and wgmma_long_fwd_kernel past them (not
    causal), and on the mma.sync route's build on mma_fwd_kernel; the bf16
    backward on the route K3's library names (`bwd_route`: wgmma_wide_bwd_*
    up to WIDE_FWD_KEYS rows, not causal, one side past 64 rows;
    wgmma_long_bwd_* past them; mma_bwd_* else), and on the mma.sync
    route's build on mma_bwd_*; the FMA kernels in fp32. {kernel name: {dtype: names}}, the
    mma.sync route's under "bfloat16_mma_sync"."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    bf16 = torch.bfloat16
    h, d, nk = shape["h"], shape["d"], shape["nk"]
    nblk = fl._blocks(shape["n"], nk)[2]
    multi = "true" if nblk > 1 else "false"
    n, causal = shape["n"], shape["causal"]
    # K10's over jax's blocks is the same past 256 keys at D > 64
    route = fa.fwd_route("packed_attn_fwd", True, d, False, nk, 1, causal)
    bwd_route = fa.bwd_route("packed_attn_bwd", True, d, False, n, nk, causal)
    for library, flash in (("packed_attn_fwd", False), ("grouped_attn", False),
                           ("flash_attn", True)):
        got = fa.fwd_route(library, True, d, False, nk, nblk if flash else 1, causal)
        if got != route or fa.fwd_route(library, False, d, False, nk, 1, causal) != "fma":
            raise AssertionError(f"{library} names route {got} at D = {d}, {nk} keys, not {route}")
    for library in BWD_SOURCES:
        got = fa.bwd_route(library, True, d, False, n, nk, causal)
        if got != bwd_route or fa.bwd_route(library, False, d, False, n, nk, causal) != "fma":
            raise AssertionError(f"{library} names backward route {got} at D = {d}, N = {n}, "
                                 f"Nk = {nk}, not {bwd_route}")
    mma = {flash: f"mma_fwd_kernel<{d}, {flash}, {multi if flash == 'true' else 'false'}, false>"
           for flash in ("false", "true")}
    bf16_fwd = {"wgmma_wide": {flash: f"wgmma_wide_fwd_kernel<{d}, {flash}, "
                                      f"{multi if flash == 'true' else 'false'}, "
                               for flash in ("false", "true")},
                "wgmma_long": {flash: f"wgmma_long_fwd_kernel<{d}, {flash}, "
                               for flash in ("false", "true")},
                "mma_sync": mma}[route]
    wants = {
        "packed_attn_fwd": (bf16_fwd["false"], f"packed_attn_fwd_kernel<{d}, false>", None),
        "grouped_attn_fwd": (bf16_fwd["false"], f"rows_fwd_kernel<float, {d}, false>", None),
        "flash_attn_fwd": (bf16_fwd["true"], f"rows_fwd_kernel<float, {d}, true>", None),
        "packed_attn_bwd": (BWD_ROUTE_KERNELS[bwd_route][0], "attn_bwd_", K3_GROUP),
        "grouped_attn_bwd": (BWD_ROUTE_KERNELS[bwd_route][0], "rows_bwd_", K3_GROUP),
        "flash_attn_bwd": (BWD_ROUTE_KERNELS[bwd_route][0], "rows_bwd_", K10B_GROUP)}
    names = {}
    for dtype in (bf16, torch.float32):
        q, k, v = qkv_slices(shape, dtype, gen)
        o, lse = fa.fused_attention_packed(q, k, v, heads=h)
        qg, kg, vg = (fa.group_heads(t.unflatten(-1, (h, d))) for t in (q, k, v))
        og, lseg = fa.fused_attention_grouped(qg, kg, vg)
        q3, k3, v3 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
        of, l, m = fl.flash_attention(q3, k3, v3)
        di = fl.flash_di(of, of)
        calls = {
            "packed_attn_fwd": lambda: fa.fused_attention_packed(q, k, v, heads=h),
            "packed_attn_bwd": lambda: fa.fused_attention_packed_bwd(q, k, v, o, o, lse, heads=h),
            "grouped_attn_fwd": lambda: fa.fused_attention_grouped(qg, kg, vg),
            "grouped_attn_bwd": lambda: fa.fused_attention_grouped_bwd(qg, kg, vg, og, og, lseg),
            "flash_attn_fwd": lambda: fl.flash_attention(q3, k3, v3),
            "flash_attn_bwd": lambda: fl.flash_attention_bwd(q3, k3, v3, of, l, m, di)}
        for name, (want_bf16, want_fp32, group) in wants.items():
            want = want_bf16 if dtype == bf16 else want_fp32
            on_wgmma = (route if name.endswith("_fwd") else bwd_route) != "mma_sync"
            avoid = None if dtype == bf16 and on_wgmma else "wgmma"
            seen = device_kernels(f"{name} D={d} N={shape['n']}", {dtype: calls[name]},
                                  {dtype: want}, avoid=avoid, group=group)
            names.setdefault(name, {}).update(seen)
            if dtype == bf16:  # the route it replaced
                flash = "true" if name == "flash_attn_fwd" else "false"
                seen = device_kernels(f"{name} D={d} N={shape['n']} (mma.sync route build)",
                                      {dtype: on_libraries(calls[name], MMA_SYNC_LIBS)},
                                      {dtype: mma[flash] if name.endswith("_fwd") else "mma_bwd_"},
                                      avoid="wgmma", group=group)
                names[name]["bfloat16_mma_sync"] = seen["bfloat16"]
    return names


def width_results(model, worst, names, timed):
    """{kernel name: the results phase 16 and 17 record for one head dim}:
    the worst errors of `width_checks`, the device kernels, and the timings
    of `wide_timings` under their labels."""
    bf16, fp32 = torch.bfloat16, torch.float32
    out = {}
    for pair, (fwd_name, bwd_name) in ATTN_PAIRS.items():
        for name, i in ((fwd_name, 0), (bwd_name, 1)):
            out[name] = dict(
                model=model, max_abs_err=worst[pair][bf16][i],
                max_abs_err_fp32=worst[pair][fp32][i],
                **({"max_rel_err": worst[pair][bf16][2],
                    "max_rel_err_fp32": worst[pair][fp32][2]} if i else {}),
                device_kernels=names[name], **{label: t[name] for label, t in timed.items()})
    return out


def phase_kernel_widths():
    """K1/K3, K4/K5 and K10/K10b at head dims 80, 88 and 104 against their
    plain versions with phase 3's bars, bf16 and fp32, forward and backward:
    the three towers' vision shape at b32 and b256 (N 257, H 16) and the
    tensor-core tiles' edges (N 1, 15, 17, 65, 257, causal and not); the
    same at D = 64 at ViT-L-14's vision shape and N = 257 at b2 (phase 3
    holds D = 64's smaller edges), where the forwards leave wgmma_fwd_kernel
    (256 keys) for the wide one; which device kernels each runs (bf16:
    wgmma_wide_fwd_kernel up to 272 keys, mma_bwd_*); timings at b256 and
    b32 beside the mma.sync route. Returns {kernel name: {d: results}}."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    widths = {name: {} for pair in ATTN_PAIRS.values() for name in pair}
    for d, model in [*WIDE_MODELS.items(), (64, L14_MODEL)]:
        t0 = time.perf_counter()
        edges = WIDE_EDGES if d != 64 else [s for s in WIDE_EDGES if s["n"] == 257]
        shapes = [dict(WIDE_VISION, d=d), dict(WIDE_VISION, d=d, b=TRAIN_BATCH),
                  *(dict(s, d=d) for s in edges)]
        worst = width_checks(shapes, gen)
        log(f"[widths] D = {d} ({model}): {len(shapes)} shapes x bf16, fp32 x 3 kernel pairs "
            f"checked in {time.perf_counter() - t0:.1f} s")
        shape = dict(WIDE_VISION, d=d)  # N = 257: K10 walks jax's three key blocks of 128
        names = width_device_kernels(shape, gen)
        timed = {"b256": wide_timings(dict(shape, b=TRAIN_BATCH), gen),
                 "b32": wide_timings(shape, gen)}
        for name, res in width_results(model, worst, names, timed).items():
            widths[name][d] = res
    return widths


class attention_impl:
    """Within the block, every attention module of `model` runs `impl`
    (the plain 'xla', or another kernel path) on the same weights; the
    modules' own choice is put back after."""

    def __init__(self, model, impl):
        self.mods = [m for m in model.modules() if hasattr(m, "attn_impl")]
        self.impl, self.saved = impl, [m.attn_impl for m in self.mods]

    def __enter__(self):
        for m in self.mods:
            m.attn_impl = self.impl

    def __exit__(self, *exc):
        for m, impl in zip(self.mods, self.saved):
            m.attn_impl = impl


def wide_layers(model_name):
    """(vision layers, vision head dim, text layers, text head dim) of a
    model config (a timm SigLIP or EVA tower's from the port's tables)."""
    from mrclip_tpu_torch.factory import get_model_config
    from mrclip_tpu_torch.models import clip

    cfg = get_model_config(model_name)
    vis, txt = cfg["vision_cfg"], cfg["text_cfg"]
    if eva := clip._eva_tower(vis.get("timm_model_name")):
        width, layers, heads = clip._EVA_DIMS[eva[0]]
        n_vis, d_vis = layers, width // heads
    elif vis.get("timm_model_name"):
        width, layers, heads = clip._TIMM_VIT_DIMS[
            clip._TIMM_VIT.match(vis["timm_model_name"]).group(1)]
        n_vis, d_vis = layers, width // heads
    else:
        n_vis, d_vis = vis["layers"], vis.get("head_width", 64)
    return n_vis, d_vis, txt["layers"], txt["width"] // txt["heads"]


def build_on_card(name, seed=0, pretrained=None, **kw):
    """`create_model(name, pretrained, **kw)` with its parameters made on
    the card and, without `pretrained`, its random init (the factory's
    `_init_weights`: the same recipe) drawn from a CUDA generator seeded
    with `seed`: no pass on the host's CPU over 2.5 B parameters
    (ViT-bigG-14 took 43.5 s that way)."""
    from mrclip_tpu_torch import factory

    with torch.device("cuda"):
        model = factory.create_model(name, pretrained, init_params=False, device="cuda", **kw)
        if pretrained is None:
            factory._init_weights(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def wide_images(n, size, seed):
    from mrclip_tpu_torch import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

    rng = np.random.RandomState(seed)
    mean, std = np.asarray(OPENAI_DATASET_MEAN), np.asarray(OPENAI_DATASET_STD)
    # 4 decimals keep each 224 x 224 image near 1 MB of JSON
    return np.round((rng.rand(n, size, size, 3) - mean) / std, 4).astype(np.float32)


def phase_serve_h14(card):
    """ViT-H-14 at full width and depth (random weights from seed 0, bf16
    compute, fp32 params, 'fusedp') exported, loaded and served by
    serve.py's HTTP server on 127.0.0.1: health, concurrent image and text
    requests and a score, K1 launched 32 times at D = 80 per image call and
    24 times at D = 64 per text call; the served features against the same
    weights' fp32 plain path on the card by cosine; `encode_image` at b32
    and b256 and `encode_text` at b256 through `ServedModel`; then the same
    model's attention modules under 'fused' and 'flash' (K4, K10 at D = 80)
    at b32 against its plain attention. Returns ({path: launches}, {path:
    launches by width}, perf)."""
    from mrclip_tpu_torch import SimpleTokenizer
    from mrclip_tpu_torch.ops import launch_counts, launch_counts_by_width
    from mrclip_tpu_torch.serve import make_server
    from mrclip_tpu_torch.serving import export_model, save_exported

    name = "ViT-H-14"
    n_vis, d_vis, n_txt, d_txt = wide_layers(name)
    t0 = time.perf_counter()
    model = build_on_card(name, precision="bf16", attn_impl="fusedp")
    exported = export_model(model)
    del model
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "vit_h_14.mrclip")
    save_exported(exported, path)
    t_build = time.perf_counter() - t0
    server = make_server(path, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    log(f"[serve-h14] {name} built and exported ({os.path.getsize(path) / 1e9:.2f} GB) in "
        f"{t_build:.1f} s; loaded and serving at {base} in {time.perf_counter() - t0:.1f} s")
    embed = exported.meta["model_cfg"]["embed_dim"]
    images = wide_images(8, 224, 0)
    texts = [CAPTIONS[i % 4] for i in range(8)]
    try:
        reset_counts()  # the served main path starts here
        health = json.loads(urllib.request.urlopen(base + "/health", timeout=60).read())
        if health.get("ok") is not True or health["meta"]["attn_impl"] != "fusedp":
            raise AssertionError(f"bad /health answer: {health}")
        with ThreadPoolExecutor(8) as pool:
            img_futs = [pool.submit(post, base, "/encode_image",
                                    {"images": images[2 * i:2 * i + 2].tolist()}) for i in range(4)]
            txt_futs = [pool.submit(post, base, "/encode_text", {"texts": texts[2 * i:2 * i + 2]})
                        for i in range(4)]
            img_feats = np.concatenate([unit_rows(f.result()["features"], 2, embed) for f in img_futs])
            txt_feats = np.concatenate([unit_rows(f.result()["features"], 2, embed) for f in txt_futs])
        score = post(base, "/score", {"images": images[:1].tolist(), "texts": texts[:2]})["logits"]
        served_path = nonzero(launch_counts())  # read right after the served run
        by_width = launch_counts_by_width()
        check_routes("[serve-h14] HTTP", by_width)
    finally:
        server.shutdown()
        server.server_close()
    want = exported.meta["logit_scale"] * img_feats[:1] @ txt_feats[:2].T
    if np.asarray(score).shape != (1, 2) or np.abs(np.asarray(score) - want).max() > 0.5:
        raise AssertionError(f"/score {score} vs features {want}")
    k1 = by_width.get("packed_attn_fwd", {})
    calls = {d: k1.get(d, 0) // n for d, n in ((d_vis, n_vis), (d_txt, n_txt))}
    ok = (set(k1) == {d_vis, d_txt} and all(calls.values())
          and all(k1[d] == calls[d] * n for d, n in ((d_vis, n_vis), (d_txt, n_txt)))
          and set(served_path) == {"packed_attn_fwd"})
    log(f"[serve-h14] /health ok; 4x2 images, 4x2 captions and 1 score answered; launches "
        f"{served_path}, by head dim {by_width} (want {n_vis} a vision call at D = {d_vis}, "
        f"{n_txt} a text call at D = {d_txt}: {calls[d_vis]} image and {calls[d_txt]} text "
        f"device calls) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the served path's launches are not whole tower calls")

    t0 = time.perf_counter()
    plain = build_on_card(name, pretrained=exported.state_dict, precision="fp32", attn_impl="xla")
    tokens = SimpleTokenizer()(texts)
    with torch.inference_mode():
        ref_img = plain.encode_image(torch.from_numpy(images).cuda(), normalize=True).float().cpu().numpy()
        ref_txt = plain.encode_text(torch.from_numpy(tokens).cuda(), normalize=True).float().cpu().numpy()
    del plain
    torch.cuda.empty_cache()
    cos_img, cos_txt = cosine_rows(img_feats, ref_img).min(), cosine_rows(txt_feats, ref_txt).min()
    ok = min(cos_img, cos_txt) >= WIDE_SERVE_COS
    log(f"[serve-h14] served (bf16, K1) vs the fp32 plain path, same weights (built in "
        f"{time.perf_counter() - t0:.1f} s): min cosine image {cos_img:.6f}, text {cos_txt:.6f} "
        f"(>= {WIDE_SERVE_COS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"served {name} features disagree with the fp32 plain path")

    served = server.served  # the server's own model, its HTTP run done
    perf = {"min_cosine_vs_fp32_plain": float(min(cos_img, cos_txt))}
    for bsz in (32, 256):
        batch = np.ascontiguousarray(np.resize(images, (bsz, 224, 224, 3)))
        before = launch_counts_by_width()
        served.encode_image(batch)
        got = {k: {d: n - before.get(k, {}).get(d, 0) for d, n in v.items()}
               for k, v in launch_counts_by_width().items()}
        if got.get("packed_attn_fwd", {}).get(d_vis) != n_vis:
            raise AssertionError(f"encode_image b{bsz}: launches by width {got}")
        t = time.perf_counter()
        for _ in range(3):
            served.encode_image(batch)
        perf[f"served_encode_image_b{bsz}_imgs_per_s"] = bsz * 3 / (time.perf_counter() - t)
    tok256 = np.resize(tokens, (256, tokens.shape[1]))
    served.encode_text(tok256)
    t = time.perf_counter()
    for _ in range(3):
        served.encode_text(tok256)
    perf["served_encode_text_b256_texts_per_s"] = 256 * 3 / (time.perf_counter() - t)
    x = torch.from_numpy(np.resize(images, (256, 224, 224, 3))).cuda()
    with torch.inference_mode():
        perf["device_encode_image_b256_ms_fusedp"] = cuda_ms(
            lambda: served.model.encode_image(x, normalize=True), 3, warmup=1)
    log(f"[serve-h14] throughput on {card}: " + json.dumps(perf))

    # the other two attention paths at D = 80, same weights, against plain
    x32 = x[:32]
    with torch.inference_mode(), attention_impl(served.model, "xla"):
        ref = served.model.encode_image(x32, normalize=True).float()
    paths, widths = {"serve_h14": served_path}, {"serve_h14": by_width}
    for impl, kernel in (("fused", "grouped_attn_fwd"), ("flash", "flash_attn_fwd")):
        reset_counts()  # this path starts here
        with torch.inference_mode(), attention_impl(served.model, impl):
            feats = served.model.encode_image(x32, normalize=True).float()
        torch.cuda.synchronize()
        paths[f"serve_h14_{impl}"] = nonzero(launch_counts())
        widths[f"serve_h14_{impl}"] = launch_counts_by_width()
        check_routes(f"[serve-h14] {impl}", widths[f"serve_h14_{impl}"])
        cos = torch.nn.functional.cosine_similarity(feats, ref, dim=-1).min().item()
        ok = (widths[f"serve_h14_{impl}"] == {kernel: {d_vis: n_vis}}
              and paths[f"serve_h14_{impl}"] == {kernel: n_vis} and cos >= 0.999)
        log(f"[serve-h14] encode_image b32 under {impl!r}: launches {paths[f'serve_h14_{impl}']} "
            f"(want {{{kernel!r}: {n_vis}}}, D = {d_vis}); min cosine vs plain attention, same "
            f"weights {cos:.6f} (>= 0.999) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} under {impl} failed its checks")
    del served, server, x, x32
    tmp.cleanup()
    torch.cuda.empty_cache()
    return paths, widths, perf


def rope_tower(model_name):
    """Whether the model's vision tower is EVA02-B/L's, whose attention
    runs K2 (and K3r) with its rope under 'fusedp'."""
    from mrclip_tpu_torch.factory import get_model_config
    from mrclip_tpu_torch.models import clip

    eva = clip._eva_tower(get_model_config(model_name)["vision_cfg"].get("timm_model_name"))
    return eva is not None and eva[0] in ("base", "large")


def tower_wants(model_name, fwd, bwd=None, per_layer=1):
    """{kernel: {head dim: launches}} of one pass through both towers under
    'fusedp' (`fwd`, `bwd`: the packed kernels' names; a rope vision tower's
    run K2/K3r) or another path (its kernels' names): `per_layer` forward
    launches a layer and, with `bwd`, one backward."""
    n_vis, d_vis, n_txt, d_txt = wide_layers(model_name)
    rope = fwd == "packed_attn_fwd" and rope_tower(model_name)
    want = {}
    for name, vis_name, n in ((fwd, "packed_attn_rope_fwd", per_layer),
                              (bwd, "packed_attn_rope_bwd", 1)):
        if name is None:
            continue
        for kernel, d, layers in ((vis_name if rope else name, d_vis, n_vis),
                                  (name, d_txt, n_txt)):
            want.setdefault(kernel, {})[d] = want.get(kernel, {}).get(d, 0) + n * layers
    return want


ROUTED_KERNELS = ("packed_attn_fwd", "packed_attn_rope_fwd", "grouped_attn_fwd", "flash_attn_fwd",
                  "packed_attn_bwd", "packed_attn_rope_bwd", "grouped_attn_bwd", "flash_attn_bwd")


def text_bwd_share(model_name):
    """(head dim, share of that head dim's backward launches, route) of
    `model_name`'s text tower where its backward leaves wgmma_wide (the
    route K3's library names at its context, causal unless
    `no_causal_mask`): SO400M's text, N 64 at D = 72 beside its vision's, half
    of them on mma_sync. None where the text runs D = 64 or the wide
    route."""
    from mrclip_tpu_torch.factory import get_model_config
    from mrclip_tpu_torch.ops import fused_attn as fa

    n_vis, d_vis, n_txt, d_txt = wide_layers(model_name)
    txt = get_model_config(model_name)["text_cfg"]
    ctx = txt["context_length"]
    route = fa.bwd_route("packed_attn_bwd", True, d_txt, False, ctx, ctx,
                         not txt.get("no_causal_mask", False))
    if d_txt == 64 or route == "wgmma_wide":
        return None
    return d_txt, n_txt / (n_txt + (n_vis if d_vis == d_txt else 0)), route


def vision_tokens(model_name):
    """The vision tower's sequence length: its patches (of the config's
    patch size, or the timm tower's name) and a class token, which the timm
    SigLIP towers lack."""
    from mrclip_tpu_torch.factory import get_model_config

    vis = get_model_config(model_name)["vision_cfg"]
    timm = vis.get("timm_model_name")
    patch = int(re.search(r"patch(\d+)", timm).group(1)) if timm else vis["patch_size"]
    return (vis["image_size"] // patch) ** 2 + (0 if timm and "siglip" in timm else 1)


def long_vision_share(model_name):
    """(head dim, share of that head dim's launches, backward route) of
    `model_name`'s vision tower where its forward runs past WIDE_FWD_KEYS
    keys (K1's library names wgmma_long; the backward's route K3's library
    names, wgmma_long), beside a text tower of the same head dim
    (ViT-B-16-SigLIP-512's, ViT-SO400M-14-SigLIP-384's); None where it does
    not, or where the tower is a rope one (K2)."""
    from mrclip_tpu_torch.ops import fused_attn as fa

    n_vis, d_vis, n_txt, d_txt = wide_layers(model_name)
    n = vision_tokens(model_name)
    if rope_tower(model_name) or fa.fwd_route("packed_attn_fwd", True, d_vis, False,
                                              n) != "wgmma_long":
        return None
    return (d_vis, n_vis / (n_vis + (n_txt if d_txt == d_vis else 0)),
            fa.bwd_route("packed_attn_bwd", True, d_vis, False, n, n, False))


def check_routes(tag, by_width, model_name=None):
    """Fails unless the attention kernels' launches since the last reset,
    forward and backward, by route (`ops.launch_counts_by_route`), are those
    of `by_width` ({kernel: {d: launches}}, read at the same time) on the
    routes of phases 16-18's towers: within 272 rows D = 72-112 (not
    causal) on wgmma_wide, the text towers' D = 64 (context 77 at most) on
    wgmma, K2 and K3r (EVA02-L-14's rope tower, N = 257 and 577) on
    mma_sync; with `model_name`, its text tower's backward launches on
    their own route where `text_bwd_share` names one (SO400M's text on
    mma_sync), and its vision tower's launches past 272 rows where
    `long_vision_share` names a share (phase 17's long towers: the forwards
    on wgmma_long, the backwards on the route the library names,
    wgmma_long). Returns the launches by route."""
    from mrclip_tpu_torch.ops import launch_counts_by_route

    got = launch_counts_by_route()
    want = {k: {d: {"mma_sync" if k.startswith("packed_attn_rope") else "wgmma" if d == 64
                    else "wgmma_wide": n} for d, n in dims.items()}
            for k, dims in by_width.items() if k in ROUTED_KERNELS}
    if model_name and (text := text_bwd_share(model_name)):
        d, share, route = text
        for k in BWD_SOURCES:  # each backward kernel is named after its source
            if d in want.get(k, {}):
                n = want[k][d]["wgmma_wide"]
                want[k][d] = {r: c for r, c in ((route, round(n * share)),
                                                ("wgmma_wide", n - round(n * share))) if c}
    if model_name and (long := long_vision_share(model_name)):
        d, share, bwd_long = long
        vision_default = "wgmma" if d == 64 else "wgmma_wide"  # where `want` put the vision's
        for k in (*LONG_FORWARDS.values(), *BWD_SOURCES):
            if d in want.get(k, {}):
                routes = dict(want[k][d])
                m = round(sum(routes.values()) * share)
                long_route = "wgmma_long" if k in LONG_FORWARDS.values() else bwd_long
                routes[vision_default] -= m
                routes[long_route] = routes.get(long_route, 0) + m
                want[k][d] = {r: c for r, c in routes.items() if c}
    ok = got == want
    log(f"{tag} attention launches by route {got} (want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} attention launches off their route: {got}, want {want}")
    return got


def wide_batch(model, n, seed):
    rng = np.random.RandomState(seed)
    size, ctx = model.visual.image_size[0], model.context_length
    vocab = model.token_embedding.num_embeddings
    return {  # uint8 canvases as the loader ships them; normalised inside the step
        "images": torch.from_numpy(rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)).cuda(),
        "tokens": torch.from_numpy(rng.randint(1, vocab, (n, ctx)).astype(np.int64)).cuda(),
        "labels": torch.from_numpy(rng.randint(0, 32, (n,)).astype(np.int32)).cuda(),
    }


# a loss_and_grads under remat 'full' launches each attention layer's
# forward kernel twice (the recompute), 'flash' three times (its backward
# recomputes the forward too), and the backward kernel once
WIDE_GRAD_PATHS = {"fused": ("grouped_attn_fwd", 2, "grouped_attn_bwd"),
                   "flash": ("flash_attn_fwd", 3, "flash_attn_bwd")}


def wide_step(model_name, model, batch_size, steps, card, tag, profile=False, impls=(),
              siglip=False, opt="adamw"):
    """The multipositive train step (`opt`, AdamW by default, with a bf16
    first moment, the pallas loss; with `siglip`, SigLIP's sigmoid loss with
    its learned bias; bf16 compute, remat 'full' as `model` was built) on
    `model` (a rope tower's attention on K2/K3r):
    gradients at the initial weights against the same model's plain
    attention at b32 (phase 5's loss bar; WIDE_GRAD_COS), also with its
    attention under each of `impls` ('fused', 'flash': exact launches, by
    head dim, each its own path), then `steps` steps at `batch_size` (the
    first a warm-up when there are several) with the exact launches of
    each, by head dim too. Returns (launches, launches by width, per-step
    launches, perf, {impl: (launches, launches by width)})."""
    from types import SimpleNamespace

    from mrclip_tpu_torch import create_loss
    from mrclip_tpu_torch.ops import launch_counts, launch_counts_by_width, launches_since
    from mrclip_tpu_torch.ops.image_ops import normalize_images
    from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                           make_loss_apply)
    from mrclip_tpu_torch.parallel.train_step import loss_and_grads

    n_vis, _, n_txt, _ = wide_layers(model_name)
    args = (dict(siglip=True, loss_dist_impl="bidir", model=model_name) if siglip else
            dict(multipositiveloss=True, delta=0.5, model=model_name, gather_with_grad=True,
                 pallas_loss=True))
    loss = make_loss_apply(create_loss(SimpleNamespace(**args)))
    loss_kernels = {} if siglip else PALLAS_STEP  # the pallas loss's K6/K7 a step

    def prep(b):
        return dict(b, images=normalize_images(b["images"]))

    small = prep(wide_batch(model, WIDE_STEP_BATCH, 1))
    params = dict(model.named_parameters())
    with attention_impl(model, "xla"):
        g_plain, l_plain = loss_and_grads(model, loss, params, small)
    lp = l_plain["loss"].item()
    grad_paths = {}
    for impl in ("fusedp", *impls):
        reset_counts()  # a path of its own: this impl's kernels at b32
        with attention_impl(model, impl):
            g_kernel, l_kernel = loss_and_grads(model, loss, params, small)
        torch.cuda.synchronize()
        counts, by_width = nonzero(launch_counts()), launch_counts_by_width()
        check_routes(f"{tag} {impl} b{WIDE_STEP_BATCH}", by_width, model_name)
        lk = l_kernel["loss"].item()
        whole, worst, worst_name = grad_cosines(g_kernel, g_plain)
        through = [n for n in g_kernel if n.endswith((*VIT_PROJ, EVA_PROJ[0]))]
        dead = [n for n in through if g_kernel[n].abs().max().item() == 0]
        del g_kernel
        ok = (np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp) and whole >= WIDE_GRAD_COS
              and worst >= 0.99 and len(through) == n_vis + n_txt and not dead)
        if impl in WIDE_GRAD_PATHS:
            fwd_name, per_layer, bwd_name = WIDE_GRAD_PATHS[impl]
            want_width = tower_wants(model_name, fwd_name, bwd_name, per_layer)
            want = {**{k: sum(v.values()) for k, v in want_width.items()}, **loss_kernels}
            ok = ok and counts == want and by_width == want_width
            grad_paths[impl] = (counts, by_width)
        log(f"{tag} {impl} vs the same model's plain attention, b{WIDE_STEP_BATCH}: loss "
            f"{lk:.6f} vs {lp:.6f} (rel {abs(lk - lp) / abs(lp):.2e}, tol 1e-2); gradient cosine "
            f"whole {whole:.6f} (>= {WIDE_GRAD_COS}), min per tensor {worst:.6f} at {worst_name} "
            f"(>= 0.99); {len(through) - len(dead)}/{len(through)} in_proj/qkv weights with a "
            f"gradient; launches {counts}, by head dim {by_width} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{model_name}: the {impl} step's gradients disagree with plain")
    del g_plain
    torch.cuda.empty_cache()

    n_params = sum(p.numel() for p in params.values())
    per_param = {"adamw": 14, "lion": 10}[opt]  # fp32 param and grad, bf16 mu (+ fp32 nu)
    log(f"{tag} {model_name}: {opt} with a bf16 first moment holds {per_param} B a parameter, "
        f"{n_params * per_param / 1e9:.1f} GB for {n_params / 1e9:.3f} B parameters, before "
        f"activations ({torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB card)")
    tx = create_optimizer(lr=1e-4, wd=0.2, opt=opt, moments_dtype="bfloat16")
    state = create_train_state(model, tx)
    step = build_train_step(model, loss, tx)
    batch = wide_batch(model, batch_size, 0)
    # remat 'full': K1 (K2) again in each block's backward
    want_width = tower_wants(model_name, "packed_attn_fwd", "packed_attn_bwd", 2)
    want = {**{k: sum(v.values()) for k, v in want_width.items()}, **loss_kernels}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path starts here
    per_step, per_width, losses, times = [], [], [], []
    for _ in range(steps):
        before, before_w = launch_counts(), launch_counts_by_width()
        t = time.perf_counter()
        state, metrics = step(state, prep(batch))
        losses.append(metrics["loss"].item())  # waits for the step
        times.append((time.perf_counter() - t) * 1e3)
        per_step.append(launches_since(before))
        after = launch_counts_by_width()
        per_width.append({k: {d: n - before_w.get(k, {}).get(d, 0) for d, n in v.items()
                              if n != before_w.get(k, {}).get(d, 0)}
                          for k, v in after.items() if k in want_width})
    torch.cuda.synchronize()
    launches, by_width = nonzero(launch_counts()), launch_counts_by_width()  # read right after
    by_route = check_routes(f"{tag} {steps} steps", by_width, model_name)

    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = times[1:] if steps > 1 else times
    step_ms = statistics.median(timed)
    ok = (all(np.isfinite(losses)) and all(p == want for p in per_step)
          and all(w == want_width for w in per_width) and state.step == steps)
    log(f"{tag} {model_name} b{batch_size}, remat 'full', {'siglip' if siglip else 'pallas'} "
        f"loss: {steps} steps, losses "
        + ", ".join(f"{x:.5f}" for x in losses) + f"; step ms {', '.join(f'{x:.1f}' for x in times)}"
        f"; launches per step {per_step[0]} (want {want}), by head dim {per_width[0]} (want "
        f"{want_width}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {model_name} train main path failed its checks")
    perf = {"batch": batch_size, "steps": steps, "step_ms": step_ms, "step_ms_all": times,
            "pairs_per_s": batch_size / step_ms * 1e3, "peak_memory_gb": peak,
            "params_m": n_params / 1e6, "optimizer": opt, "launches_by_route": by_route}
    if profile:  # one more step, after the main path's counts were read
        perf["profiled_step"] = profile_step(lambda: step(state, prep(batch)), tag)
    log(f"{tag} {model_name} b{batch_size} step {step_ms:.1f} ms"
        f"{' (median of the timed steps)' if steps > 1 else ''}, {perf['pairs_per_s']:.1f} "
        f"pairs/s, peak memory {peak:.2f} GB ({perf['params_m']:.1f} M params) | {card}")
    del state, step
    torch.cuda.empty_cache()
    return launches, by_width, want, perf, grad_paths


def phase_train_h14(card):
    """ViT-H-14 at full width and depth (random weights drawn on the card
    from seed 0, the served model's), bf16, 'fusedp', remat 'full': gradients against plain
    attention at b32, also with the attention under 'fused' and 'flash'
    (K4/K5 and K10/K10b at D = 80, each a path), then one warm-up and
    WIDE_TIMED timed steps at b256: 112 K1 (64 at D = 80, 48 at D = 64) and
    56 K3 (32 at D = 80) each, pairs/s, peak memory; one profiled step."""
    t0 = time.perf_counter()
    model = build_on_card("ViT-H-14", precision="bf16", attn_impl="fusedp", gelu_approx=True,
                          grad_checkpointing=True, remat_policy="full")
    log(f"[train-h14] ViT-H-14 built on the card in {time.perf_counter() - t0:.1f} s")
    out = wide_step("ViT-H-14", model, TRAIN_BATCH, 1 + WIDE_TIMED, card, "[train-h14]",
                    profile=True, impls=("fused", "flash"))
    del model
    torch.cuda.empty_cache()
    return out


def serve_against_plain(name, served, images, tokens, tag, routes=True):
    """`encode_image` and `encode_text` through `served` (a ServedModel under
    'fusedp'), its launches read right after: K1 once a layer at each
    tower's head dim, on the routes of `check_routes` (`routes`; phase 17's
    longest sequences run past them); the features against the same model's
    plain attention (same weights and compute type) by cosine (>= 0.999).
    Returns (launches, launches by width, image features)."""
    from mrclip_tpu_torch.ops import launch_counts, launch_counts_by_width

    model = served.model
    reset_counts()  # the served path starts here
    img = served.encode_image(images)
    txt = served.encode_text(tokens)
    launches = nonzero(launch_counts())  # read right after the run
    by_width = launch_counts_by_width()
    if routes:
        check_routes(tag, by_width, name)
    want = tower_wants(name, "packed_attn_fwd")
    with torch.inference_mode(), attention_impl(model, "xla"):
        ref_img = model.encode_image(torch.from_numpy(images).cuda(), normalize=True).float().cpu().numpy()
        ref_txt = model.encode_text(torch.from_numpy(tokens).cuda(), normalize=True).float().cpu().numpy()
    cos = min(cosine_rows(img, ref_img).min(), cosine_rows(txt, ref_txt).min())
    embed = model.text_projection.weight.shape[0] if isinstance(
        model.text_projection, torch.nn.Module) else model.text_projection.shape[1]
    ok = (img.shape == (len(images), embed) and np.isfinite(img).all() and np.isfinite(txt).all()
          and by_width == want and cos >= 0.999)
    log(f"{tag} {name} encode_image b{len(images)} ({images.shape[1]} px) + encode_text "
        f"b{len(tokens)} (ctx {tokens.shape[1]}): features {img.shape}, launches by head dim "
        f"{by_width} (want {want}); min cosine vs the same model's plain "
        f"attention {cos:.6f} (>= 0.999) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"serving {name} failed its checks")
    return launches, by_width, img


def phase_wide_models(card):
    """ViT-g-14 and ViT-bigG-14 at full width and depth (random weights
    from seed 0, bf16, 'fusedp', remat 'full'): `encode_image` at b32 and
    `encode_text` at b32 through `ServedModel`, K1 once per layer at each
    tower's head dim, the features against the same model's plain
    attention; then one train step at b32 (gradients against plain
    attention first), peak memory. Returns {path: launches}, {path:
    launches by width}, {path: per-step launches}, perf."""
    from mrclip_tpu_torch import SimpleTokenizer
    from mrclip_tpu_torch.serving import ServedModel

    paths, widths, per_step, perf = {}, {}, {}, {}
    images = wide_images(WIDE_STEP_BATCH, 224, 3)
    tokens = np.resize(SimpleTokenizer()(CAPTIONS), (WIDE_STEP_BATCH, 98))
    for name in ("ViT-g-14", "ViT-bigG-14"):
        key = name.lower().replace("-", "_").replace("vit_", "")
        t0 = time.perf_counter()
        model = build_on_card(name, precision="bf16", attn_impl="fusedp", gelu_approx=True,
                              grad_checkpointing=True, remat_policy="full")
        served = ServedModel(model, {})
        log(f"[wide] {name} built on the card in {time.perf_counter() - t0:.1f} s")
        paths[f"serve_{key}"], widths[f"serve_{key}"], _ = serve_against_plain(
            name, served, images, tokens, "[wide]")
        t = time.perf_counter()
        for _ in range(3):
            served.encode_image(images)
        perf[f"{key}_served_encode_image_b{WIDE_STEP_BATCH}_imgs_per_s"] = (
            3 * WIDE_STEP_BATCH / (time.perf_counter() - t))
        launches, by_width, want_step, step_perf, _ = wide_step(
            name, model, WIDE_STEP_BATCH, 1, card, "[wide]")
        paths[f"train_{key}"], widths[f"train_{key}"] = launches, by_width
        per_step[f"train_{key}"] = want_step
        perf[f"{key}_train"] = step_perf
        del model, served
        torch.cuda.empty_cache()
    return paths, widths, per_step, perf


# Phase 17: the SigLIP and CLIPA families. The attention kernels at head
# dim 72 (ViT-SO400M-SigLIP's vision and text towers: 1152 wide, 16 heads),
# SO400M served and trained at full width and depth, and one served batch
# each of the longest sequences the port's configs reach
SIGLIP_MODEL = "ViT-SO400M-14-SigLIP"
SIGLIP_D = 72
SIGLIP_SHAPES = {  # no CLS token; the text is non-causal
    "b256": dict(b=TRAIN_BATCH, n=256, nk=256, h=16, d=SIGLIP_D, causal=False),  # 224 px / 14
    "b32": dict(b=32, n=256, nk=256, h=16, d=SIGLIP_D, causal=False),
    "n729_b32": dict(b=32, n=729, nk=729, h=16, d=SIGLIP_D, causal=False),  # 378 and 384 px
    "text_b256": dict(b=TRAIN_BATCH, n=64, nk=64, h=16, d=SIGLIP_D, causal=False),  # ctx 64
}
SIGLIP_TIMED = 3  # timed SO400M steps at b256 after one warm-up
# one served b32 batch each against plain attention: ViT-B-16-SigLIP-512's
# N = 1024 at D = 64 (32 x 32 patches, no CLS) and ViT-bigG-14-CLIPA-336's N
# = 577 at D = 104
LONG_MODELS = ("ViT-B-16-SigLIP-512", "ViT-bigG-14-CLIPA-336")


# The bf16 forward past WIDE_FWD_KEYS keys (wgmma_long_fwd_kernel): the long
# towers' vision shapes at b32, 16 heads but SigLIP-B's 12: ViT-L-14-336 (N
# 577, D 64), ViT-B-16-SigLIP-512 (1024, 64), ViT-SO400M-14-SigLIP-378/384
# (729, 72), ViT-H-14-378 (730, 80), ViT-bigG-14-CLIPA-336 (577, 104)
LONG_SHAPES = {"d64_n577": dict(b=32, n=577, nk=577, h=16, d=64, causal=False),
               "d64_n1024": dict(b=32, n=1024, nk=1024, h=12, d=64, causal=False),
               "d72_n729": dict(b=32, n=729, nk=729, h=16, d=72, causal=False),
               "d80_n730": dict(b=32, n=730, nk=730, h=16, d=80, causal=False),
               "d104_n577": dict(b=32, n=577, nk=577, h=16, d=104, causal=False)}
LONG_FORWARDS = {"K1": "packed_attn_fwd", "K4": "grouped_attn_fwd", "K10": "flash_attn_fwd"}


def long_calls(shape, gen):
    """({kernel: (call, plain call, stat kinds)} of bf16 K1, K4 and K10 on one
    set of inputs (column slices of one projection; K4 on their grouped
    copies), SDPA's forward on the same)."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    h, d, causal = shape["h"], shape["d"], shape["causal"]
    q, k, v = qkv_slices(shape, torch.bfloat16, gen)
    q3, k3, v3 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
    qg, kg, vg = (fa.group_heads(t) for t in (q3, k3, v3))
    q4, k4, v4 = (t.transpose(1, 2) for t in (q3, k3, v3))
    calls = {"K1": (lambda: fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h),
                    lambda: fa.fused_attention_packed_ref(q, k, v, is_causal=causal, heads=h),
                    ["lse"]),
             "K4": (lambda: fa.fused_attention_grouped(qg, kg, vg, is_causal=causal),
                    lambda: fa.fused_attention_ref(qg, kg, vg, is_causal=causal), ["lse"]),
             "K10": (lambda: fl.flash_attention(q3, k3, v3, is_causal=causal),
                     lambda: fl.flash_attention_ref(q3, k3, v3, is_causal=causal), ["l", "m"])}
    return calls, lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal)


def check_forward(tag, got, want, kinds):
    """A bf16 forward's (o, stats) against its plain version with phase 3's
    bars: o within O_TOL, lse and m within LSE_TOL, l within LSE_TOL
    relative. Returns (max |o err|, max stat err); raises past a bar."""
    err_o = abs_err(got[0], want[0])
    err_s = [((a - b).abs() / b).max().item() if kind == "l" else abs_err(a, b)
             for a, b, kind in zip(got[1:], want[1:], kinds)]
    ok = err_o <= O_TOL[torch.bfloat16] and max(err_s) <= LSE_TOL
    if not ok:
        raise AssertionError(f"{tag}: max|o-plain| {err_o:.3e}, stats {err_s}")
    return err_o, max(err_s)


def bits_equal(got, want):
    """Whether each pair of tensors (o and the stats) is bit-equal."""
    return [torch.equal(a, b) for a, b in zip(got, want)]


def long_device_kernels(label, shape, calls):
    """Which device kernel bf16 K1, K4 and K10 (`calls`, long_calls's) run at
    a long shape (profiler): wgmma_long_fwd_kernel<D, FLASH, ONE> on the
    package's build, the route its library names (`fwd_route`), and
    mma_fwd_kernel on the mma.sync route's build (MMA_SYNC_LIBS). {kernel:
    {"bfloat16": names, "bfloat16_mma_sync": names}}."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    bf16, d, nk = torch.bfloat16, shape["d"], shape["nk"]
    nblk = fl._blocks(shape["n"], nk)[2]
    libraries = {"K1": "packed_attn_fwd", "K4": "grouped_attn", "K10": "flash_attn"}
    names = {}
    for kernel, (call, _, _) in calls.items():
        flash = kernel == "K10"
        route = fa.fwd_route(libraries[kernel], True, d, False, nk, nblk if flash else 1)
        if route != "wgmma_long":
            raise AssertionError(f"{libraries[kernel]} names route {route} at {label}")
        new = device_kernels(f"{kernel} {label}", {bf16: call},
                             {bf16: f"wgmma_long_fwd_kernel<{d}, {str(flash).lower()}, "})
        old = device_kernels(f"{kernel} {label} (mma.sync route build)",
                             {bf16: on_libraries(call, MMA_SYNC_LIBS)},
                             {bf16: f"mma_fwd_kernel<{d}, {str(flash).lower()}, "
                                    f"{str(flash and nblk > 1).lower()}, false>"}, avoid="wgmma")
        names[kernel] = {"bfloat16": new["bfloat16"], "bfloat16_mma_sync": old["bfloat16"]}
    return names


# the backwards' kernel names, their libraries' too
LONG_BACKWARDS = {"K3": "packed_attn_bwd", "K5": "grouped_attn_bwd", "K10b": "flash_attn_bwd"}


def long_bwd_calls(shape, gen):
    """{kernel: (call, plain call)} of bf16 K3, K5 and K10b on one set of
    inputs (column slices of one projection and a random output gradient;
    K5 on their grouped copies), each from its own forward's outputs."""
    from mrclip_tpu_torch.ops import flash_attn as fl
    from mrclip_tpu_torch.ops import fused_attn as fa

    h, d, causal = shape["h"], shape["d"], shape["causal"]
    q, k, v = qkv_slices(shape, torch.bfloat16, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    o, lse = fa.fused_attention_packed(q, k, v, is_causal=causal, heads=h)
    qg, kg, vg, dog = (fa.group_heads(t.unflatten(-1, (h, d))) for t in (q, k, v, do))
    og, lseg = fa.fused_attention_grouped(qg, kg, vg, is_causal=causal)
    q3, k3, v3, do3 = (t.unflatten(-1, (h, d)) for t in (q, k, v, do))
    of, l, m = fl.flash_attention(q3, k3, v3, is_causal=causal)
    di = fl.flash_di(of, do3)
    return {"K3": (lambda: fa.fused_attention_packed_bwd(q, k, v, o, do, lse, is_causal=causal,
                                                         heads=h),
                   lambda: fa.fused_attention_packed_bwd_ref(q, k, v, o, do, lse, is_causal=causal,
                                                             heads=h)),
            "K5": (lambda: fa.fused_attention_grouped_bwd(qg, kg, vg, og, dog, lseg,
                                                          is_causal=causal),
                   lambda: fa.fused_attention_bwd_ref(qg, kg, vg, og, dog, lseg, is_causal=causal)),
            "K10b": (lambda: fl.flash_attention_bwd(q3, k3, v3, do3, l, m, di, is_causal=causal),
                     lambda: fl.flash_attention_bwd_ref(q3, k3, v3, do3, l, m, di,
                                                        is_causal=causal))}


def check_backward(tag, got, want):
    """A bf16 backward's (dq, dk, dv) against its plain version with phase
    3's bar: finite, each within GRAD_TOL of the call's largest |plain|
    gradient. Returns (max |d - plain|, max relative error); raises past
    the bar."""
    scale = max(w.float().abs().max().item() for w in want)
    errs = [rel_err(g, w, scale) for g, w in zip(got, want)]
    ok = (all(bool(torch.isfinite(g.float()).all()) for g in got)
          and max(errs) <= GRAD_TOL[torch.bfloat16])
    if not ok:
        raise AssertionError(f"{tag}: max|d-plain| / max|plain| dq/dk/dv {errs}")
    return max(abs_err(g, w) for g, w in zip(got, want)), max(errs)


def long_bwd_device_kernels(label, shape, calls):
    """Which device kernels bf16 K3, K5 and K10b (`calls`, long_bwd_calls's)
    run at a long shape (profiler): the route each library names
    (`bwd_route`: wgmma_long_bwd_* past WIDE_FWD_KEYS rows), in K3/K5's or
    K10b's profiler group, and mma_bwd_* on the mma.sync route's build
    (MMA_SYNC_LIBS). {kernel: {"route": route, "bfloat16": names,
    "bfloat16_mma_sync": names}}."""
    from mrclip_tpu_torch.ops import fused_attn as fa

    bf16, d, n, nk = torch.bfloat16, shape["d"], shape["n"], shape["nk"]
    names = {}
    for kernel, (call, _) in calls.items():
        group = K10B_GROUP if kernel == "K10b" else K3_GROUP
        route = fa.bwd_route(LONG_BACKWARDS[kernel], True, d, False, n, nk, shape["causal"])
        want, avoid = BWD_ROUTE_KERNELS[route]
        new = device_kernels(f"{kernel} {label}", {bf16: call}, {bf16: want}, avoid=avoid,
                             group=group)
        old = device_kernels(f"{kernel} {label} (mma.sync route build)",
                             {bf16: on_libraries(call, MMA_SYNC_LIBS)}, {bf16: "mma_bwd_"},
                             avoid="wgmma", group=group)
        names[kernel] = {"route": route, "bfloat16": new["bfloat16"],
                         "bfloat16_mma_sync": old["bfloat16"]}
    return names


def phase_kernel_long():
    """bf16 K1, K4 and K10 past WIDE_FWD_KEYS keys (wgmma_long_fwd_kernel)
    and bf16 K3, K5 and K10b past WIDE_FWD_KEYS rows (wgmma_long_bwd_*) at
    LONG_SHAPES: against their plain versions with phase 3's bars, their
    bits against the mma.sync route's build (bit-equal or not; K10 keeps its
    arithmetic, K1 and K4 sum their rows' online l over other key chunks
    past D = 64, the backwards sum their products in another order), which
    device kernel each runs on both builds and the route the libraries
    name, and timed (`wide_timings`: event and device ms beside the
    mma.sync route's, the plain version, SDPA's forward and backward, the
    bound; two runs bit-equal). Returns {kernel name: {label: results}}."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    out = {name: {} for name in (*LONG_FORWARDS.values(), *LONG_BACKWARDS.values())}
    for label, shape in LONG_SHAPES.items():
        t0 = time.perf_counter()
        calls, _ = long_calls(shape, gen)
        names = long_device_kernels(label, shape, calls)
        checked = {}
        for kernel, (call, plain, kinds) in calls.items():
            got, old = call(), on_libraries(call, MMA_SYNC_LIBS)()
            errs = check_forward(f"[long] {kernel} {label}", got, plain(), kinds)
            checked[kernel] = (*errs, bits_equal(got, old), abs_err(got[0], old[0]))
        del calls
        bwd_calls = long_bwd_calls(shape, gen)
        names.update(long_bwd_device_kernels(label, shape, bwd_calls))
        for kernel, (call, plain) in bwd_calls.items():
            got, old = call(), on_libraries(call, MMA_SYNC_LIBS)()
            errs = check_backward(f"[long] {kernel} {label}", got, plain())
            checked[kernel] = (*errs, bits_equal(got, old),
                               max(abs_err(a, b) for a, b in zip(got, old)))
        del bwd_calls
        timed = wide_timings(shape, gen)
        for kernel, (err_a, err_b, same, err_old) in checked.items():
            if kernel in LONG_FORWARDS:
                name = LONG_FORWARDS[kernel]
                res = out[name][label] = dict(shape=shape, max_abs_err=err_a, max_stat_err=err_b,
                                              bit_equal_vs_mma_sync=same,
                                              max_abs_vs_mma_sync=err_old,
                                              device_kernels=names[kernel], **timed[name])
                what, errors = "o", f"max|o - plain| {err_a:.3e}, stats {err_b:.3e}"
                yardstick = f"SDPA's {fmt_ms(res['library_device_ms'])}"
            else:
                name = LONG_BACKWARDS[kernel]
                res = out[name][label] = dict(shape=shape, max_abs_err=err_a, max_rel_err=err_b,
                                              bit_equal_vs_mma_sync=same,
                                              max_abs_vs_mma_sync=err_old,
                                              device_kernels=names[kernel], **timed[name])
                what = "dq, dk, dv"
                errors = f"max|d - plain| {err_a:.3e}, relative {err_b:.3e} (tol {GRAD_TOL[torch.bfloat16]})"
                yardstick = f"SDPA's backward (event) {res['library_ms']:.4f}"
            log(f"[long] {kernel} {label}: {errors}; against the mma.sync route: bit-equal "
                f"({what}) {same}, max|diff| {err_old:.3e}; device {fmt_ms(res['device_ms'])} ms "
                f"against the mma.sync route's {fmt_ms(res['mma_sync_device_ms'])} "
                f"({'faster' if res['ms'] < res['mma_sync_ms'] else 'NOT faster'} by event) and "
                f"{yardstick} (bound {res['bound_ms']:.4f}, {res['bound_by']})")
        log(f"[long] {label} checked and timed in {time.perf_counter() - t0:.1f} s")
    return out


def phase_kernel_siglip():
    """K1/K3, K4/K5 and K10/K10b at D = 72 against their plain versions with
    phase 3's and phase 16's bars, bf16 and fp32, forward and backward, at
    SO400M's shapes (vision N 256 at b256 and b32, N 729 at b32, non-causal
    text N 64 at b256; 16 heads) and the tensor-core tiles' edges; which
    device kernels each runs at N = 256 and 729; timed at the four shapes
    (event and device ms, the plain version, SDPA, the bound). Returns
    {kernel name: {72: results}}."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    t0 = time.perf_counter()
    shapes = [*SIGLIP_SHAPES.values(), *(dict(s, d=SIGLIP_D) for s in WIDE_EDGES)]
    worst = width_checks(shapes, gen)
    log(f"[siglip] D = {SIGLIP_D} ({SIGLIP_MODEL}): {len(shapes)} shapes x bf16, fp32 x 3 "
        f"kernel pairs checked in {time.perf_counter() - t0:.1f} s")
    names = width_device_kernels(SIGLIP_SHAPES["b32"], gen)
    for name, seen in width_device_kernels(SIGLIP_SHAPES["n729_b32"], gen).items():
        for key, kernels in seen.items():
            names[name][f"{key}_n729"] = kernels
    timed = {label: wide_timings(shape, gen) for label, shape in SIGLIP_SHAPES.items()}
    return {name: {SIGLIP_D: res}
            for name, res in width_results(SIGLIP_MODEL, worst, names, timed).items()}


def siglip_inputs(model, n, seed):
    """n normalised images at the model's size and n token ids of its
    context from its vocabulary (the hub tokenizer is not ported)."""
    size, ctx = model.visual.image_size[0], model.context_length
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, model.token_embedding.num_embeddings, (n, ctx)).astype(np.int64)
    return wide_images(n, size, seed), tokens


def phase_serve_so400m(card):
    """ViT-SO400M-14-SigLIP at full width and depth (random weights drawn on
    the card from seed 0, bf16 compute, fp32 params, 'fusedp') through
    `ServedModel`: `export_model`'s meta carries the logit scale and bias;
    `encode_image` and `encode_text` at b32 with K1 once a layer at D = 72
    (27 + 27) against the same model's plain attention, then against the
    same weights' fp32 plain path (WIDE_SERVE_COS); `logits` with the bias;
    `encode_image` at b32 and b256 and `encode_text` at b256 timed. Returns
    ({path: launches}, {path: launches by width}, perf)."""
    from mrclip_tpu_torch.serving import ServedModel, export_model

    name = SIGLIP_MODEL
    t0 = time.perf_counter()
    model = build_on_card(name, precision="bf16", attn_impl="fusedp")
    exported = export_model(model)
    meta = exported.meta
    ok = abs(meta["logit_bias"] + 10.0) < 1e-6 and abs(meta["logit_scale"] - 10.0) < 1e-4
    log(f"[serve-so400m] {name} built on the card and exported in "
        f"{time.perf_counter() - t0:.1f} s ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} "
        f"M params): meta logit_scale {meta['logit_scale']:.6f} (exp of ln 10), logit_bias "
        f"{meta['logit_bias']} (-10) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the export does not carry the logit scale and bias")
    served = ServedModel(model, meta)
    images, tokens = siglip_inputs(model, 32, 17)
    launches, by_width, img = serve_against_plain(name, served, images, tokens, "[serve-so400m]")
    paths, widths = {"serve_so400m": launches}, {"serve_so400m": by_width}

    txt = served.encode_text(tokens)
    logits = served.logits(images[:4], tokens[:8])  # its own b4 and b8 calls
    want = 10.0 * served.encode_image(images[:4]) @ served.encode_text(tokens[:8]).T - 10.0
    err = np.abs(logits - want).max()
    t0 = time.perf_counter()
    plain = build_on_card(name, pretrained=exported.state_dict, precision="fp32", attn_impl="xla")
    del exported
    with torch.inference_mode():
        ref_img = plain.encode_image(torch.from_numpy(images).cuda(), normalize=True).float().cpu().numpy()
        ref_txt = plain.encode_text(torch.from_numpy(tokens).cuda(), normalize=True).float().cpu().numpy()
    del plain
    torch.cuda.empty_cache()
    cos_img, cos_txt = cosine_rows(img, ref_img).min(), cosine_rows(txt, ref_txt).min()
    ok = min(cos_img, cos_txt) >= WIDE_SERVE_COS and logits.shape == (4, 8) and err < 1e-3
    log(f"[serve-so400m] served (bf16, K1) vs the fp32 plain path, same weights (built in "
        f"{time.perf_counter() - t0:.1f} s): min cosine image {cos_img:.6f}, text {cos_txt:.6f} "
        f"(>= {WIDE_SERVE_COS}); logits {logits.shape} = 10 img txt^T - 10 within {err:.2e} "
        f"(range {logits.min():.3f} to {logits.max():.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"served {name} disagrees with the fp32 plain path or its bias")

    perf = served_rates(name, served, images, tokens, {
        "min_cosine_vs_fp32_plain": float(min(cos_img, cos_txt)),
        "params_m": sum(p.numel() for p in model.parameters()) / 1e6})
    x = torch.from_numpy(np.resize(images, (256, *images.shape[1:]))).cuda()
    with torch.inference_mode():
        perf["device_encode_image_b256_ms_fusedp"] = cuda_ms(
            lambda: model.encode_image(x, normalize=True), 3, warmup=1)
    log(f"[serve-so400m] throughput on {card}: " + json.dumps(perf))
    del served, model, x
    torch.cuda.empty_cache()
    return paths, widths, perf


def phase_train_so400m(card):
    """ViT-SO400M-14-SigLIP at full width and depth (random weights drawn on
    the card from seed 0), bf16, 'fusedp', remat 'full', the SigLIP sigmoid
    loss with its learned bias: gradients against plain attention at b32,
    also with the attention under 'fused' and 'flash' (K4/K5 and K10/K10b
    at D = 72, each a path), then one warm-up and SIGLIP_TIMED timed steps
    at b256: 108 K1 and 54 K3 each, all at D = 72; pairs/s, peak memory; one
    profiled step."""
    t0 = time.perf_counter()
    model = build_on_card(SIGLIP_MODEL, precision="bf16", attn_impl="fusedp",
                          grad_checkpointing=True, remat_policy="full")
    log(f"[train-so400m] {SIGLIP_MODEL} built on the card in {time.perf_counter() - t0:.1f} s")
    out = wide_step(SIGLIP_MODEL, model, TRAIN_BATCH, 1 + SIGLIP_TIMED, card, "[train-so400m]",
                    profile=True, impls=("fused", "flash"), siglip=True)
    del model
    torch.cuda.empty_cache()
    return out


# The first training path through a long tower: ViT-SO400M-14-SigLIP-384
# (vision N 729 at D = 72, 16 heads, 27 layers, map pool; non-causal text N
# 64 at D = 72), whose vision backward runs wgmma_long_bwd_*
SIGLIP_LONG_MODEL = "ViT-SO400M-14-SigLIP-384"
SIGLIP_LONG_BATCH = 32
SIGLIP_LONG_TIMED = 5  # timed steps after one warm-up: at b32 the host sets the pace


def phase_train_so400m_384(card):
    """ViT-SO400M-14-SigLIP-384 at full width and depth (random weights drawn
    on the card from seed 0), bf16, 'fusedp', remat 'full', the SigLIP
    sigmoid loss with its learned bias: gradients against plain attention at
    b32, also with the attention under 'fused' and 'flash' (K4/K5 and
    K10/K10b, each a path), then one warm-up and SIGLIP_LONG_TIMED timed
    steps at SIGLIP_LONG_BATCH: 108 K1 and 54 K3 a step at D = 72, the
    vision tower's forwards and backwards on wgmma_long and its text's
    backward on mma_sync by the exact launch counts by route
    (`check_routes`); pairs/s, peak memory, one profiled step with the
    attention backward's device time by route; then the step's forward and
    backward (`loss_and_grads`, no optimizer) by CUDA events with the
    package's backward and with the mma.sync route's (MMA_SYNC_LIBS'
    backward sources beside the package's forwards), in turns."""
    from types import SimpleNamespace

    from mrclip_tpu_torch import create_loss
    from mrclip_tpu_torch.ops import build
    from mrclip_tpu_torch.ops.image_ops import normalize_images
    from mrclip_tpu_torch.parallel import make_loss_apply
    from mrclip_tpu_torch.parallel.train_step import loss_and_grads

    t0 = time.perf_counter()
    model = build_on_card(SIGLIP_LONG_MODEL, precision="bf16", attn_impl="fusedp",
                          grad_checkpointing=True, remat_policy="full")
    log(f"[train-so400m-384] {SIGLIP_LONG_MODEL} built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    out = wide_step(SIGLIP_LONG_MODEL, model, SIGLIP_LONG_BATCH, 1 + SIGLIP_LONG_TIMED, card,
                    "[train-so400m-384]", profile=True, impls=("fused", "flash"), siglip=True)
    loss = make_loss_apply(create_loss(SimpleNamespace(siglip=True, loss_dist_impl="bidir",
                                                       model=SIGLIP_LONG_MODEL)))
    batch = wide_batch(model, SIGLIP_LONG_BATCH, 0)
    batch["images"] = normalize_images(batch["images"])
    params = dict(model.named_parameters())
    runs = {"wgmma_long": lambda: loss_and_grads(model, loss, params, batch)}
    old_bwd = {**{src: build.load_library(src) for src in FWD_SOURCES},
               **{src: MMA_SYNC_LIBS[src] for src in BWD_SOURCES}}
    runs["mma_sync"] = on_libraries(runs["wgmma_long"], old_bwd)
    reads = {key: [] for key in runs}
    for _ in range(5):
        for key, fn in runs.items():
            reads[key].append(cuda_ms(fn, 1, warmup=1))
    grads_ms = {key: statistics.median(v) for key, v in reads.items()}
    out[3]["grads_ms_by_route"] = grads_ms
    out[3]["grads_ms_readings"] = reads
    log(f"[train-so400m-384] forward and backward of the b{SIGLIP_LONG_BATCH} step "
        f"(loss_and_grads), medians of 5 in turns: vision backward on wgmma_long "
        f"{grads_ms['wgmma_long']:.1f} ms, on the mma.sync route {grads_ms['mma_sync']:.1f} ms "
        f"({spread(reads)}) | {card}")
    del model, params, batch
    torch.cuda.empty_cache()
    return out


def attention_share(fn, names):
    """(device ms of one fn() call, the share of it in device kernels whose
    name holds one of `names`) from one profiler window; (None, None) where
    the window recorded no device kernel."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with profiled() as prof:
        fn()
        torch.cuda.synchronize()
    times = {ev.key: getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA}
    total = sum(times.values())
    if not total:
        return None, None
    return total / 1e3, sum(v for k, v in times.items() if any(n in k for n in names)) / total


def phase_serve_long(card):
    """One served b32 batch each of LONG_MODELS at full width and depth
    (random weights from seed 0, bf16, 'fusedp') through `ServedModel`:
    ViT-B-16-SigLIP-512 (vision N = 1024 at D = 64, text N = 64) and
    ViT-bigG-14-CLIPA-336 (vision N = 577 at D = 104, avg pool and no
    ln_pre; non-causal text N = 32 at D = 64), K1 once a layer, the vision
    tower's on wgmma_long (`check_routes`), against the same model's plain
    attention; `encode_image` at b32 timed on the package's build and on the
    mma.sync route's (MMA_SYNC_LIBS, the route it replaced) in turns, and
    one profiled call of each with K1's share of the device time. Returns
    ({path: launches}, {path: launches by width}, perf)."""
    from mrclip_tpu_torch.serving import ServedModel

    paths, widths, perf = {}, {}, {}
    for name in LONG_MODELS:
        key = "serve_" + name.lower().replace("-", "_").replace("vit_", "")
        t0 = time.perf_counter()
        model = build_on_card(name, precision="bf16", attn_impl="fusedp")
        log(f"[serve-long] {name} built on the card in {time.perf_counter() - t0:.1f} s")
        served = ServedModel(model, {})
        images, tokens = siglip_inputs(model, 32, 18)
        paths[key], widths[key], _ = serve_against_plain(name, served, images, tokens,
                                                         "[serve-long]")
        x = torch.from_numpy(images).cuda()

        def encode():
            with torch.inference_mode():
                return model.encode_image(x, normalize=True)

        runs = {"long": encode, "mma_sync": on_libraries(encode, MMA_SYNC_LIBS)}
        t_enc, reads = median_ms(runs, 3, runs=5)
        shares = {route: attention_share(fn, ("wgmma_long_fwd_kernel", "mma_fwd_kernel"))
                  for route, fn in runs.items()}
        perf[f"{key}_device_encode_image_b32_ms"] = t_enc["long"]
        perf[f"{key}_device_encode_image_b32_ms_mma_sync"] = t_enc["mma_sync"]
        perf[f"{key}_encode_image_b32_readings"] = reads
        perf[f"{key}_k1_share"] = {route: s for route, (_, s) in shares.items()}
        perf[f"{key}_profiled_device_ms"] = {route: ms for route, (ms, _) in shares.items()}
        log(f"[serve-long] {name} encode_image b32 on the card: {t_enc['long']:.2f} ms on "
            f"wgmma_long, {t_enc['mma_sync']:.2f} ms on the mma.sync route it replaced (medians "
            f"of 5 in turns; {spread(reads)}); K1's share of one profiled call's device time: "
            + ", ".join(f"{route} {fmt_ms(ms)} ms, "
                        f"{'not measured' if s is None else f'{100 * s:.1f}%'}"
                        for route, (ms, s) in shares.items()) + f" | {card}")
        del served, model, x
        torch.cuda.empty_cache()
    return paths, widths, perf


# Phase 18: the EVA family. The attention kernels at head dim 112
# (EVA02-E-14's vision tower: 1792 wide, 16 heads, N = 257), EVA02-E-14
# served and trained at full width and depth, one served b32 batch each of
# EVA02-E-14-plus, EVA01-g-14 (D = 88, fused qkv, pre-norm) and
# EVA02-L-14-336 (K2 at N = 577), then EVA02-L-14 served and trained (K2/K3r
# at N = 257)
EVA_MODEL = "EVA02-E-14"
EVA_D = 112
EVA_SHAPES = {"b256": dict(WIDE_VISION, d=EVA_D, b=TRAIN_BATCH), "b32": dict(WIDE_VISION, d=EVA_D)}
# EVA02-E-14 steps at b32: one warm-up, four timed (single steps read 0.86 to
# 1.71 s on one card: the median of two was the host's)
EVA_STEPS = 5
# Lion with a bf16 moment: 10 B a parameter, 47 GB at 4.7 B; AdamW's 14 B
# (66 GB) leaves no room for the gradients held against plain attention
EVA_OPT = "lion"
EVA_SERVED = ("EVA02-E-14-plus", "EVA01-g-14", "EVA02-L-14-336")
EVA_LARGE = "EVA02-L-14"


def tame_post_norm_scores(model):
    """Scale the q and k rows of each post-norm vision block's qkv weight by
    1 / sqrt(depth), in place. EVA02-E's post-norm blocks attend over the
    raw residual stream, whose std grows as sqrt(l) under the factory's
    random init: by layer 64 the scores' std is about 64 and each softmax
    nearly an argmax, and the gradient is chaotic there (on the CPU,
    tools/post_norm_grads.py: two fp32 attention paths give gradients at
    cosine -0.03, bf16 against fp32 0.01; with this scale >= 0.9997).
    Trained weights keep their scores in range; these random ones are made
    to. Returns the scale (1 without post-norm blocks)."""
    blocks = [b for b in model.visual.trunk.blocks if getattr(b, "post_norm", False)]
    if not blocks:
        return 1.0
    scale = len(blocks) ** -0.5
    with torch.no_grad():
        for block in blocks:
            w = block.attn.qkv.weight
            w[: 2 * w.shape[1]] *= scale
    return scale


def phase_kernel_eva():
    """K1/K3, K4/K5 and K10/K10b at D = 112 against their plain versions with
    phase 3's and phase 16's bars, bf16 and fp32, forward and backward, at
    EVA02-E-14's vision shape (N 257, H 16) at b32 and b256 and the
    tensor-core tiles' edges; which device kernels each runs; timed at b256
    and b32 (event and device ms, the plain version, SDPA, the bound; two
    bf16 backward runs bit-equal). Returns {kernel name: {112: results}}."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    t0 = time.perf_counter()
    shapes = [*EVA_SHAPES.values(), *(dict(s, d=EVA_D) for s in WIDE_EDGES)]
    worst = width_checks(shapes, gen)
    log(f"[eva] D = {EVA_D} ({EVA_MODEL}): {len(shapes)} shapes x bf16, fp32 x 3 kernel pairs "
        f"checked in {time.perf_counter() - t0:.1f} s")
    names = width_device_kernels(EVA_SHAPES["b32"], gen)
    timed = {label: wide_timings(shape, gen) for label, shape in EVA_SHAPES.items()}
    return {name: {EVA_D: res}
            for name, res in width_results(EVA_MODEL, worst, names, timed).items()}


def served_rates(name, served, images, tokens, perf):
    """`encode_image` at b32 and b256 (each call launching the vision
    kernel, K1 or K2, exactly once a layer) and `encode_text` at b256
    through `served`, each timed over 3 calls after one: images/s and
    texts/s into `perf`."""
    from mrclip_tpu_torch.ops import launch_counts_by_width

    n_vis, d_vis, _, _ = wide_layers(name)
    want = {"packed_attn_rope_fwd" if rope_tower(name) else "packed_attn_fwd": {d_vis: n_vis}}
    for bsz in (WIDE_STEP_BATCH, TRAIN_BATCH):
        batch = np.ascontiguousarray(np.resize(images, (bsz, *images.shape[1:])))
        before = launch_counts_by_width()
        served.encode_image(batch)
        got = {k: {d: n - before.get(k, {}).get(d, 0) for d, n in v.items()
                   if n != before.get(k, {}).get(d, 0)}
               for k, v in launch_counts_by_width().items()}
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"{name} encode_image b{bsz}: launches by width {got}, "
                                 f"want {want}")
        t = time.perf_counter()
        for _ in range(3):
            served.encode_image(batch)
        perf[f"served_encode_image_b{bsz}_imgs_per_s"] = bsz * 3 / (time.perf_counter() - t)
    tok = np.resize(tokens, (TRAIN_BATCH, tokens.shape[1]))
    served.encode_text(tok)
    t = time.perf_counter()
    for _ in range(3):
        served.encode_text(tok)
    perf[f"served_encode_text_b{TRAIN_BATCH}_texts_per_s"] = TRAIN_BATCH * 3 / (
        time.perf_counter() - t)
    return perf


def phase_eva_e(card):
    """EVA02-E-14 at full width and depth (4.7 B parameters drawn on the
    card from seed 0, the vision q and k rows at 1/8 of the factory's std:
    `tame_post_norm_scores`; fp32 params, bf16 compute, 'fusedp', remat
    'full'):
    `encode_image` and `encode_text` at b32 through `ServedModel` with K1
    once a layer (64 at D = 112, 24 at D = 64) against the same model's
    plain attention; `encode_image` at b32 and b256 and `encode_text` at
    b256 timed; then the train step (EVA_OPT, the pallas loss): gradients at
    b32 against plain attention, also under 'fused' and 'flash' (K4/K5 and
    K10/K10b at D = 112, each a path), and EVA_STEPS steps at b32 with exact
    launches (176 K1, 88 K3 a step) and the peak memory; one profiled
    step. The model is freed after, and the card's memory checked. Returns
    ({path: launches}, {path: launches by width}, {path: per-step
    launches}, perf)."""
    from mrclip_tpu_torch.serving import ServedModel

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_on_card(EVA_MODEL, precision="bf16", attn_impl="fusedp", gelu_approx=True,
                          grad_checkpointing=True, remat_policy="full")
    n_params = sum(p.numel() for p in model.parameters())
    scale = tame_post_norm_scores(model)
    log(f"[eva-e] {EVA_MODEL} built on the card in {time.perf_counter() - t0:.1f} s "
        f"({n_params / 1e9:.3f} B parameters, {torch.cuda.memory_allocated() / 1e9:.1f} GB); "
        f"vision q and k rows scaled by {scale:.4f}")
    served = ServedModel(model, {})
    images, tokens = siglip_inputs(model, WIDE_STEP_BATCH, 18)
    paths, widths, per_step = {}, {}, {}
    paths["serve_eva_e"], widths["serve_eva_e"], _ = serve_against_plain(
        EVA_MODEL, served, images, tokens, "[eva-e]")
    perf = served_rates(EVA_MODEL, served, images, tokens, {"params_m": n_params / 1e6})
    x = torch.from_numpy(np.resize(images, (TRAIN_BATCH, *images.shape[1:]))).cuda()
    with torch.inference_mode():
        perf[f"device_encode_image_b{TRAIN_BATCH}_ms_fusedp"] = cuda_ms(
            lambda: model.encode_image(x, normalize=True), 3, warmup=1)
    log(f"[eva-e] served throughput on {card}: " + json.dumps(perf))
    del served, x
    (paths["train_eva_e"], widths["train_eva_e"], per_step["train_eva_e"], train,
     grads) = wide_step(EVA_MODEL, model, WIDE_STEP_BATCH, EVA_STEPS, card, "[eva-e]",
                        profile=True, impls=("fused", "flash"), opt=EVA_OPT)
    for impl, (counts, by_width) in grads.items():  # K4/K5 and K10/K10b at D = 112
        paths[f"grads_eva_e_{impl}"], widths[f"grads_eva_e_{impl}"] = counts, by_width
    perf = {"serve": perf, "train": train}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_allocated() - held
    log(f"[eva-e] card memory after the model was freed: {kept / 1e9:+.3f} GB against before "
        f"it was built {'ok' if kept < 0.5e9 else 'FAIL'}")
    if kept >= 0.5e9:
        raise AssertionError(f"{EVA_MODEL} outlived its phase")
    return paths, widths, per_step, perf


def phase_eva_family(card):
    """One served b32 batch each of EVA_SERVED at full width and depth
    (random weights from seed 0, bf16, 'fusedp') through `ServedModel`
    against the same model's plain attention: EVA02-E-14-plus (D = 112,
    text 32 x 1280), EVA01-g-14 (D = 88, fused qkv, pre-norm) and
    EVA02-L-14-336 (K2 at N = 577, the rope rescaled from the 24 x 24 grid
    to (16, 16)); then EVA02-L-14 served at b32 and b256 and one train step
    at b32 (AdamW, the pallas loss; gradients against plain attention
    first): K2/K3r at N = 257. Returns ({path: launches}, {path: launches
    by width}, {path: per-step launches}, perf)."""
    from mrclip_tpu_torch.serving import ServedModel

    paths, widths, per_step, perf = {}, {}, {}, {}
    for name in (*EVA_SERVED, EVA_LARGE):
        key = name.lower().replace("-", "_")
        t0 = time.perf_counter()
        large = name == EVA_LARGE
        model = build_on_card(name, precision="bf16", attn_impl="fusedp", gelu_approx=True,
                              **(dict(grad_checkpointing=True, remat_policy="full") if large
                                 else {}))
        scale = tame_post_norm_scores(model)
        log(f"[eva] {name} built on the card in {time.perf_counter() - t0:.1f} s "
            f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params; vision q and k "
            f"rows scaled by {scale:.4f})")
        served = ServedModel(model, {})
        images, tokens = siglip_inputs(model, WIDE_STEP_BATCH, 19)
        paths[f"serve_{key}"], widths[f"serve_{key}"], _ = serve_against_plain(
            name, served, images, tokens, "[eva]")
        x = torch.from_numpy(images).cuda()
        with torch.inference_mode():
            perf[f"{key}_device_encode_image_b32_ms"] = cuda_ms(
                lambda: model.encode_image(x, normalize=True), 3, warmup=1)
        log(f"[eva] {name} encode_image b32 ({images.shape[1]} px) on the card: "
            f"{perf[f'{key}_device_encode_image_b32_ms']:.2f} ms | {card}")
        del x
        if large:
            perf[f"{key}_serve"] = served_rates(name, served, images, tokens, {})
            log(f"[eva] {name} served throughput on {card}: {json.dumps(perf[f'{key}_serve'])}")
            (paths[f"train_{key}"], widths[f"train_{key}"], per_step[f"train_{key}"],
             perf[f"{key}_train"], _) = wide_step(name, model, WIDE_STEP_BATCH, 1, card, "[eva]")
        del served, model
        torch.cuda.empty_cache()
    return paths, widths, per_step, perf


def mark(phase, t0):
    """Log the run's seconds so far as `phase` starts; its profiler windows
    are counted under it."""
    PROFILER["phase"] = phase
    log(f"[time] {phase} starts at {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mrclip_tpu_torch  # noqa: F401 - outside a checkout this fails before any output

    t0 = time.perf_counter()
    name, smi = phase_card()
    mark("2 build", t0)
    phase_build()
    # phases 18, 16 and 17's kernel checks and timings come first: they read
    # device kernels and times from many short profiler windows, and late in
    # a long process the profiler loses windows' device records (PROFILER,
    # tools/profiler_windows.py)
    mark("18 kernels", t0)
    eva_widths = phase_kernel_eva()
    mark("16 kernels", t0)
    widths = phase_kernel_widths()
    mark("17 kernels", t0)
    for kname, res in [*phase_kernel_siglip().items(), *eva_widths.items()]:
        widths[kname].update(res)
    mark("19 kernels", t0)
    long_res = phase_kernel_long()
    mark("3 kernel", t0)
    entries = {e["name"]: e for e in [phase_kernel_fwd(), phase_kernel_bwd(), *phase_kernel_rope(),
                                      *phase_kernel_supcon(), *phase_kernel_grouped(),
                                      *phase_kernel_flash(), *phase_kernel_dw()]}
    fwd, rope_fwd = entries["packed_attn_fwd"], entries["packed_attn_rope_fwd"]
    k4, k10, k8 = entries["grouped_attn_fwd"], entries["flash_attn_fwd"], entries["dw_conv_fwd"]
    paths, per_step = {}, {}
    mark("4-11 serve and train", t0)
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
    mark("12 objectives", t0)
    obj_paths, obj_per_step, fwd["objectives"] = phase_objectives(entries, smi)
    paths.update(obj_paths)
    per_step.update(obj_per_step)
    mark("13 cli", t0)
    cli_paths, cli_per_step, fwd["cli"], study = phase_cli(smi)
    paths.update(cli_paths)
    per_step.update(cli_per_step)
    mark("14 options", t0)
    opt_paths, opt_per_step, fwd["options"] = phase_options(smi)
    paths.update(opt_paths)
    per_step.update(opt_per_step)
    mark("15 fast input", t0)
    fast_paths, fast_per_step, fwd["fast_input"] = phase_fast_input(smi, study, fwd["cli"])
    paths.update(fast_paths)
    per_step.update(fast_per_step)
    # phase 16's models: the towers at head dims 80, 88 and 104
    mark("16 models", t0)
    big_paths, wide_widths, big_per_step, big_perf = phase_wide_models(smi)
    paths.update(big_paths)
    per_step.update(big_per_step)
    (paths["train_h14"], wide_widths["train_h14"], per_step["train_h14"], h14_train,
     h14_grads) = phase_train_h14(smi)
    for impl, (counts, by_width) in h14_grads.items():  # K4/K5 and K10/K10b at D = 80
        paths[f"grads_h14_{impl}"], wide_widths[f"grads_h14_{impl}"] = counts, by_width
    held = torch.cuda.memory_allocated()
    wide_paths, serve_widths, h14_serve = phase_serve_h14(smi)
    gc.collect()  # the server's handler class, a cycle, held the model too
    kept = torch.cuda.memory_allocated() - held
    log(f"[serve-h14] card memory after server_close: {kept / 1e9:+.3f} GB against before the "
        f"server (its batcher threads ended and the model went with them) "
        f"{'ok' if kept < 0.5e9 else 'FAIL'}")
    if kept >= 0.5e9:
        raise AssertionError("the served ViT-H-14 outlived its server")
    paths.update(wide_paths)
    wide_widths.update(serve_widths)
    fwd["wide_models"] = {"serve_h14": h14_serve, "train_h14": h14_train, **big_perf}
    # phase 17's models: ViT-SO400M-14-SigLIP and the longest sequences
    mark("17 models", t0)
    so400m_paths, so400m_widths, so400m_serve = phase_serve_so400m(smi)
    paths.update(so400m_paths)
    wide_widths.update(so400m_widths)
    (paths["train_so400m"], wide_widths["train_so400m"], per_step["train_so400m"], so400m_train,
     so400m_grads) = phase_train_so400m(smi)
    for impl, (counts, by_width) in so400m_grads.items():  # K4/K5 and K10/K10b at D = 72
        paths[f"grads_so400m_{impl}"], wide_widths[f"grads_so400m_{impl}"] = counts, by_width
    # the long tower trained: its vision backward on wgmma_long_bwd_*
    (paths["train_so400m_384"], wide_widths["train_so400m_384"], per_step["train_so400m_384"],
     so400m_384_train, so400m_384_grads) = phase_train_so400m_384(smi)
    for impl, (counts, by_width) in so400m_384_grads.items():
        paths[f"grads_so400m_384_{impl}"] = counts
        wide_widths[f"grads_so400m_384_{impl}"] = by_width
    long_paths, long_widths, long_perf = phase_serve_long(smi)
    paths.update(long_paths)
    wide_widths.update(long_widths)
    fwd["siglip_models"] = {"serve_so400m": so400m_serve, "train_so400m": so400m_train,
                            "train_so400m_384": so400m_384_train, **long_perf}
    # phase 18's models: EVA02-E-14, then the rest of the EVA family
    mark("18 models", t0)
    eva_paths, eva_widths, eva_per_step, eva_perf = phase_eva_e(smi)
    fam_paths, fam_widths, fam_per_step, fam_perf = phase_eva_family(smi)
    paths.update({**eva_paths, **fam_paths})
    wide_widths.update({**eva_widths, **fam_widths})
    per_step.update({**eva_per_step, **fam_per_step})
    fwd["eva_models"] = {"eva02_e_14": eva_perf, **fam_perf}
    mark("end", t0)
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
                **{path: [*spec["per_step"]] for path, spec in OBJECTIVE_PATHS.items()},
                "cli": [*CLI_PER_STEP], "cli_eval": [*CLI_EVAL_PER_BATCH],
                **{path: [*want] for path, want in opt_per_step.items()},
                **{path: [*want] for path, want in fast_per_step.items()},
                **{path: [*counts] for path, counts in wide_paths.items()},
                **{path: [*want] for path, want in big_per_step.items()},
                "train_h14": [*per_step["train_h14"]],
                **{f"grads_h14_{impl}": [fwd_name, bwd_name, *PALLAS_STEP]
                   for impl, (fwd_name, _, bwd_name) in WIDE_GRAD_PATHS.items()},
                "serve_so400m": ["packed_attn_fwd"],
                "train_so400m": [*per_step["train_so400m"]],
                **{f"grads_so400m_{impl}": [fwd_name, bwd_name]
                   for impl, (fwd_name, _, bwd_name) in WIDE_GRAD_PATHS.items()},
                "train_so400m_384": [*per_step["train_so400m_384"]],
                **{f"grads_so400m_384_{impl}": [fwd_name, bwd_name]
                   for impl, (fwd_name, _, bwd_name) in WIDE_GRAD_PATHS.items()},
                **{path: ["packed_attn_fwd"] for path in long_paths},
                **{path: [*counts, *(PALLAS_STEP if path.startswith(("train_", "grads_")) else ())]
                   for path, counts in {**eva_widths, **fam_widths}.items()}}
    missing = [(p, k) for p, ks in expected.items() for k in ks if not paths[p].get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    new_dims = (*WIDE_MODELS, SIGLIP_D, EVA_D)
    for kname, entry in entries.items():
        by_path = {p: counts.get(kname, 0) for p, counts in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        entry["launches_per_step"] = {p: per_step[p].get(kname, 0) for p in per_step}
        entry["card"] = smi
        if kname in widths:  # phases 16 to 18: the same kernel at head dims 72 to 112
            entry["widths"] = {str(d): res for d, res in widths[kname].items()}
            entry["launches_at_new_widths"] = {
                str(d): sum(w.get(kname, {}).get(d, 0) for w in wide_widths.values())
                for d in new_dims}
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       *(r["max_abs_err"] for r in widths[kname].values()))
            entry["max_abs_err_fp32"] = max(entry["max_abs_err_fp32"],
                                            *(r["max_abs_err_fp32"] for r in widths[kname].values()))
        if kname in long_res:  # phase 19: past 272 rows on wgmma_long_fwd_kernel, _bwd_*
            entry["long"] = long_res[kname]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       *(r["max_abs_err"] for r in long_res[kname].values()))
    log(f"[profiler] {PROFILER['windows']} windows opened, {PROFILER['empty']} recorded no "
        f"device event; the first such: {PROFILER['first_empty']} (window, phase); by phase "
        f"{PROFILER['empty_by_phase']}")
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
