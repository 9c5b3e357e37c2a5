"""The port's native data-path library (`mrclip_tpu_torch/native.py`, built
from its own copy of the C++ sources) and `NativeBatchLoader` against the
JAX package's (`mrclip_tpu.native`, which loads its prebuilt
`assets/libmrclip_native.so`) on the same PNG files, written by the port's
codec.

`decode_png`, `augment_matrices` and `color_jitter_params` must be
bit-equal. `load_batch` and `augment_batch` must be within one level per
uint8 pixel, with at most 1e-4 of the pixels differing: the two builds may
contract different multiply-adds into FMAs (the JAX library was built with
-march=native; the port's with -mfma on x86-64 is bit-equal to it here).
The C++ runs 1 or 2 threads: the suite runs several worker processes."""

import ctypes
import filecmp
import os
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mrclip_tpu.native as jax_native
from mrclip_tpu.data.native_loader import NativeBatchLoader as JaxNativeBatchLoader
from mrclip_tpu.transforms import AugmentationCfg as JaxAugmentationCfg
from mrclip_tpu_torch import native
from mrclip_tpu_torch.data import NativeBatchLoader, UniqueLabelSampler
from mrclip_tpu_torch.data.png import write_png
from mrclip_tpu_torch.ops import build
from mrclip_tpu_torch.transforms import AugmentationCfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHARE = 1e-4  # the largest share of uint8 pixels that may differ, by one level

# (h, w, channels): grey, grey + alpha, RGB, RGBA; square and not
SHAPES = [(52, 44, 1), (40, 40, 2), (36, 50, 3), (48, 48, 4), (30, 64, 1), (64, 30, 3)]


def _slice(h, w, c, seed):
    """A smooth image with noise, as MRI slices look."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = [127 + 90 * np.sin(rng.uniform(0.5, 3) * yy / h * np.pi)
             * np.cos(rng.uniform(0.5, 3) * xx / w * np.pi + rng.uniform(0, 3))
             + 20 * rng.randn(h, w) for _ in range(c)]
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    paths = []
    for i, (h, w, c) in enumerate(SHAPES * 2):
        p = str(root / f"img{i}.png")
        write_png(p, _slice(h, w, c, i))
        paths.append(p)
    return paths


def _close_u8(got, want):
    """Within one level, at most SHARE of the pixels differing."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert d.max() <= 1 and (d > 0).mean() <= SHARE, (d.max(), (d > 0).mean())


def test_sources_are_byte_identical_copies_and_shipped():
    import tomllib

    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]["mrclip_tpu_torch"]
    shipped = {p for g in globs for p in build.NATIVE_SRC.parent.glob(g)}
    for name in ("png_decode.cc", "loader.cc"):
        assert filecmp.cmp(ROOT / "native" / name, build.NATIVE_SRC / name, shallow=False)
        assert build.NATIVE_SRC / name in shipped


def test_library_is_the_ports_own_build():
    """Built from `native_src/` into the kernels' build directory, without
    -march=native; never the JAX package's prebuilt library."""
    lib = native.library()
    assert native.native_available()
    info = build.build_info("mrclip_native")
    assert Path(info["path"]).parent == build.BUILD_DIR and Path(info["path"]).is_file()
    assert lib._name == info["path"]
    if "command" in info:  # built in this process
        assert "-march=native" not in info["command"] and "-lz" in info["command"]
    assert "libmrclip_native.so" not in lib._name and "assets" not in lib._name
    assert "-march=native" not in build.HOST_CXX_FLAGS


@pytest.mark.parametrize("channels", [3, 1])
def test_decode_png_bit_equal(pngs, channels):
    for p in pngs[:len(SHAPES)]:
        data = Path(p).read_bytes()
        got = native.decode_png(data, channels)
        want = jax_native.decode_png(data, channels)
        assert got is not None and got.shape[2] == channels
        np.testing.assert_array_equal(got, want)
    assert native.decode_png(b"not a png at all, twenty-four bytes+", 3) is None


@pytest.mark.parametrize("mode", ["squash", "cover", "contain"])
@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
@pytest.mark.parametrize("size", [(32, 32), (40, 56)])
def test_load_batch_matches_jax(pngs, mode, interp, size):
    got, gs = native.load_batch(pngs, size, num_threads=2, resize_mode=mode, interpolation=interp)
    want, ws = jax_native.load_batch(pngs, size, num_threads=2, resize_mode=mode,
                                     interpolation=interp)
    assert (gs == 0).all() and (ws == 0).all()
    _close_u8(got, want)


def test_load_batch_status_of_a_missing_file(pngs):
    got, status = native.load_batch([pngs[0], "/no/such/file.png"], (16, 16), num_threads=1)
    assert status[0] == 0 and status[1] != 0 and not got[1].any() and got[0].any()


def test_png_size(pngs, tmp_path):
    assert native.png_size(pngs[0]) == (SHAPES[0][1], SHAPES[0][0])
    assert native.png_size(tmp_path / "missing.png") is None
    (tmp_path / "junk.png").write_bytes(b"JUNK" * 10)
    assert native.png_size(tmp_path / "junk.png") is None


@pytest.mark.parametrize("sizes", [True, False])
def test_augment_matrices_and_colour_params_bit_equal(pngs, sizes):
    src = [native.png_size(p) for p in pngs] if sizes else None
    kw = dict(crop_scale=(0.5, 1.0), ratio=(0.6, 1.6), src_sizes=src)
    got = native.augment_matrices(np.random.RandomState(7), len(pngs), **kw)
    want = jax_native.augment_matrices(np.random.RandomState(7), len(pngs), **kw)
    np.testing.assert_array_equal(got, want)
    got = native.color_jitter_params(np.random.RandomState(8), 9, (0.4, 0.3, 0.2, 0.1), 0.8, 0.3)
    want = jax_native.color_jitter_params(np.random.RandomState(8), 9, (0.4, 0.3, 0.2, 0.1),
                                          0.8, 0.3)
    np.testing.assert_array_equal(got, want)
    assert native.color_jitter_params(np.random.RandomState(8), 9) is None


@pytest.mark.parametrize("colour", [False, True])
def test_augment_batch_matches_jax(pngs, colour):
    rng = np.random.RandomState(3)
    n = len(pngs)
    mats = native.augment_matrices(rng, n, src_sizes=[native.png_size(p) for p in pngs])
    sigmas = rng.uniform(0.1, 2.0, n).astype(np.float32)
    cp = native.color_jitter_params(rng, n, (0.4, 0.4, 0.4, 0.1), 0.8, 0.3) if colour else None
    got, gs = native.augment_batch(pngs, (40, 40), mats, sigmas, color_params=cp, num_threads=2)
    want, ws = jax_native.augment_batch(pngs, (40, 40), mats, sigmas, color_params=cp,
                                        num_threads=2)
    assert (gs == 0).all() and (ws == 0).all() and got.any()
    _close_u8(got, want)
    with pytest.raises(ValueError, match="matrices"):
        native.augment_batch(pngs, (8, 8), mats[:2], sigmas)


class _Set:
    def __init__(self, paths, captions, labels):
        self.images, self.captions, self.labels = paths, captions, labels

    def __len__(self):
        return len(self.images)


def _tok(texts):
    return np.asarray([[len(s), sum(map(ord, s)) % 997, 0] for s in texts], np.int32)


@pytest.mark.parametrize("augment", [True, False])
def test_native_loader_matches_jax_over_two_epochs(pngs, augment):
    """Same sampler, seed, colour extras and per-batch seeds: the same
    batches, epoch after epoch, with prefetching producers."""
    captions = [f"slice {i % 5} (0.09, 9.0, nan, 150)" for i in range(len(pngs))]
    labels = [i % 5 for i in range(len(pngs))]
    ds = _Set(pngs, captions, labels)
    cfg = dict(scale=(0.7, 1.0), color_jitter=(0.3, 0.3, 0.3, 0.05), color_jitter_prob=0.5,
               gray_scale_prob=0.2)
    kw = dict(batch_size=4, canvas_size=(32, 32), tokenizer=_tok, with_times=True, num_threads=2,
              prefetch_batches=2, drop_last=augment, augment=augment, seed=5,
              eval_resize_mode="cover", eval_interpolation="bicubic")
    got = NativeBatchLoader(ds, sampler=UniqueLabelSampler(labels, 4, seed=5),
                            aug_cfg=AugmentationCfg(**cfg) if augment else None, **kw)
    from mrclip_tpu.data import UniqueLabelSampler as JaxSampler

    want = JaxNativeBatchLoader(ds, sampler=JaxSampler(labels, 4, seed=5),
                                aug_cfg=JaxAugmentationCfg(**cfg) if augment else None, **kw)
    assert len(got) == len(want) >= 2
    for epoch in range(2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        gb, wb = list(got), list(want)
        assert len(gb) == len(wb) == len(want)
        for g, w in zip(gb, wb):
            assert sorted(g) == sorted(w) == ["echo_time", "images", "labels",
                                              "repetition_time", "tokens"]
            _close_u8(g["images"], w["images"])
            for k in ("labels", "tokens", "echo_time", "repetition_time"):
                np.testing.assert_array_equal(g[k], w[k])
    assert got._batch_counter == want._batch_counter == (2 * len(want) if augment else 0)


def test_native_loader_raises_a_producer_error(pngs):
    ds = _Set(pngs[:4], ["ok", "ok", "boom", "ok"], [0, 1, 2, 3])

    def tokenizer(texts):
        if "boom" in texts[0]:
            raise ValueError("malformed caption")
        return np.zeros((len(texts), 8), np.int32)

    loader = NativeBatchLoader(ds, batch_size=1, tokenizer=tokenizer, canvas_size=(8, 8),
                               drop_last=False, num_threads=1)
    seen = 0
    with pytest.raises(ValueError, match="malformed caption"):
        for _ in loader:
            seen += 1
    assert seen == 2
    # an abandoned iterator stops its producer
    it = iter(NativeBatchLoader(_Set(pngs, ["a"] * len(pngs), [0] * len(pngs)), batch_size=1,
                                canvas_size=(8, 8), num_threads=1, prefetch_batches=1))
    next(it)
    it.close()


def test_host_build_names_what_is_missing(monkeypatch, tmp_path):
    """No C++ compiler, or a compiler without zlib: a RuntimeError that
    says so, and no library (never a Python or PIL path)."""
    src = tmp_path / "x.cc"
    src.write_text('extern "C" int f() { return 1; }\n')
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"no C\+\+ compiler \(c\+\+ or g\+\+\)"):
        build.load_host_library("nocxx", [src])
    fake = tmp_path / "fakecxx"
    fake.write_text("#!/bin/sh\necho 'x.cc:1:10: fatal error: zlib.h: No such file or "
                    "directory' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="zlib's header zlib.h is missing"):
        build.load_host_library("nozlib", [src])
    assert not list((tmp_path / "kernels").glob("*.so"))
    # and with a real compiler it builds and loads
    monkeypatch.undo()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    lib = build.load_host_library("tiny", [src])
    lib.f.restype = ctypes.c_int
    assert lib.f() == 1 and len(list((tmp_path / "kernels").glob("libtiny-*.so"))) == 1


def test_native_modules_import_no_jax_or_pil():
    code = ("import sys\nfor m in ('PIL', 'pandas'):\n    sys.modules[m] = None\n"
            "import mrclip_tpu_torch.native, mrclip_tpu_torch.data.native_loader\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mrclip_tpu', 'PIL')"
            " and sys.modules[m] is not None]\nprint(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout + proc.stderr


PREPROCESS = {  # the port's configs and the registry's kinds of override
    "ViT-B-16": dict(size=224),
    "MobileCLIP-S1 (mean 0, std 1)": dict(size=256, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    "squash, bilinear, mean 0.5": dict(size=32, resize_mode="squash", interpolation="bilinear",
                                       mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    "contain, 'random' interpolation": dict(size=40, resize_mode="longest",
                                            interpolation="random"),
}


@pytest.mark.parametrize("which", sorted(PREPROCESS))
def test_get_data_native_loader_honours_the_preprocess_cfg(pngs, tmp_path, which):
    """`--native-loader` through `get_data`: the canvas, the eval resize
    mode and interpolation and the PreprocessCfg (whose mean and std the
    loops normalise with) as JAX's `get_data` sets them; the validated
    `--aug-cfg` on the train loader; and the val pass's normalisation by
    that config."""
    from types import SimpleNamespace

    import mrclip_tpu.data as jax_data
    from mrclip_tpu import transforms as JT
    from mrclip_tpu_torch import transforms as TT
    from mrclip_tpu_torch.data import get_data
    from mrclip_tpu_torch.data.table import write_table
    from mrclip_tpu_torch.train.loop import _maybe_preprocess_images

    write_table(tmp_path / "set.csv", [{"filepath": p, "title": f"c{i}", "label": i % 3}
                                        for i, p in enumerate(pngs)])
    cfg = PREPROCESS[which]

    def args(**kw):
        return SimpleNamespace(train_data=str(tmp_path / "set.csv"),
                               val_data=str(tmp_path / "set.csv"), dataset_type="csv",
                               batch_size=4, workers=1, seed=2, accum_freq=1, native_loader=True,
                               image_size=cfg["size"], aug_cfg={"scale": (0.8, 1.0)}, **kw)

    pp_t, pp_j = TT.PreprocessCfg(**cfg), JT.PreprocessCfg(**cfg)
    got = get_data(args(), (TT.TrainTransform(pp_t), TT.EvalTransform(pp_t)))
    want = jax_data.get_data(args(), (JT.TrainTransform(pp_j), JT.EvalTransform(pp_j)))
    for split in ("train", "val"):
        g, w = got[split].dataloader, want[split].dataloader
        assert isinstance(g, NativeBatchLoader)
        for k in ("canvas_size", "eval_resize_mode", "eval_interpolation", "augment", "seed",
                  "batch_size", "drop_last", "num_threads"):
            assert getattr(g, k) == getattr(w, k), k
        assert g.preprocess_cfg.mean == w.preprocess_cfg.mean == pp_t.mean
        assert g.preprocess_cfg.std == w.preprocess_cfg.std
        assert len(g) == len(w)
    assert got["train"].dataloader.aug_cfg.scale == (0.8, 1.0)
    assert got["val"].dataloader.aug_cfg is None
    batch = next(iter(got["val"].dataloader))
    out = _maybe_preprocess_images({"images": torch.from_numpy(batch["images"])},
                                   SimpleNamespace(image_size=cfg["size"]),
                                   got["val"].dataloader.preprocess_cfg)["images"]
    want_norm = (batch["images"] / np.float32(255.0) - np.float32(pp_t.mean)) / np.float32(pp_t.std)
    np.testing.assert_allclose(out.numpy(), want_norm, atol=1e-5, rtol=0)
    bad = SimpleNamespace(**{**vars(args()), "aug_cfg": {"re_prob": 0.5}})
    with pytest.raises(NotImplementedError, match="random erasing"):
        get_data(bad, (TT.TrainTransform(pp_t), TT.EvalTransform(pp_t)))
