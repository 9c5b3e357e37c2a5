#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mrclip_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:
  1. card:   name, power limit, TF32 off for fp32 products;
  2. build:  every CUDA kernel of the served path, from `mrclip_tpu_torch/csrc`;
  3. kernel: each kernel against its plain PyTorch version on the card, at the
             served shapes and ragged edges, bf16 and fp32, q/k/v passed as
             strided column slices of one qkv tensor; timings beside SDPA;
  4. serve:  full-width ViT-B-16 (random weights from a seed, bf16 compute,
             fp32 params, attn_impl='fusedp') exported to an artifact, loaded,
             served over HTTP on 127.0.0.1; health, concurrent image and text
             requests and a score; features checked against the same weights
             under the plain attention; the kernel launch counts of that run;
             served throughput at b32/b256.
The last three lines are the kernels JSON, the card's name and power limit,
and {"ok": true, "device": {...}}. Needs one CUDA card and imports no JAX.
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
O_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
VISION = dict(b=32, n=197, nk=197, h=12, d=64, causal=False)  # ViT-B-16, batch 32
TEXT = dict(b=32, n=98, nk=98, h=8, d=64, causal=True)  # its text tower, context 98
EDGES = [dict(b=4, n=n, nk=n, h=4, d=64, causal=c) for n in (1, 50, 257) for c in (False, True)]
EDGES += [dict(b=2, n=76, nk=255, h=2, d=64, causal=False),  # kv length != q length
          dict(b=3, n=33, nk=33, h=2, d=32, causal=True)]  # head dim 32
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


def attention_bound(b, n, nk, h, d, causal, dtype):
    """(least ms, 'bytes'|'operations'): q, k, v read once, o and lse written
    once; 4*D operations per attended (query, key) pair."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * b * h * d * (2 * n + 2 * nk) + 4 * b * h * n
    pairs = sum(min(i + 1, nk) for i in range(n)) if causal else n * nk
    ops = 4 * b * h * pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def phase_build():
    from mrclip_tpu_torch.ops import build, fused_attn

    fused_attn.load_kernel()  # the slice's one source; later sources build in parallel
    info = build.build_info("packed_attn_fwd")
    log(f"[build] packed_attn_fwd.cu -> {info['path']} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def phase_kernel():
    from mrclip_tpu_torch.ops import fused_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for shape in [VISION, TEXT, *EDGES]:
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
    serving_b256 = timings(dict(VISION, b=256))
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
    }


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
    return main_path_launches, per_pair, perf


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mrclip_tpu_torch  # noqa: F401 - outside a checkout this fails before any output

    name, smi = phase_card()
    phase_build()
    entry = phase_kernel()
    entry["launches"], entry["launches_per_pair"], entry["serving"] = phase_serve(entry, smi)
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
