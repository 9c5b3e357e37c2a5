"""The port's host transforms and data path (`mrclip_tpu_torch.host_image`,
`transforms`, `data`, `train.metrics`) against PIL and the JAX package on
the same inputs: PIL's resampling, affine warp, kernel filter, blends and
colour conversions bit-equal; `EvalTransform` and `TrainTransform` (under
`random.seed`) bit-equal with the same draws; `CsvDataset` items, the three
samplers' indices, `DataLoader` batches (0 and 4 workers) and `get_data`'s
loader lengths equal; the retrieval metrics equal on random features."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageFilter

import mrclip_tpu.data as jax_data
import mrclip_tpu.transforms as J
from mrclip_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from mrclip_tpu.train.metrics import get_clip_metrics as jax_clip_metrics
from mrclip_tpu.train.metrics import volume_voting_metrics as jax_voting
from mrclip_tpu_torch import data, host_image as hi, transforms as T
from mrclip_tpu_torch.data.png import write_png
from mrclip_tpu_torch.data.table import write_table
from mrclip_tpu_torch.tokenizer import SimpleTokenizer, canonicalize_text, get_clean_fn
from mrclip_tpu_torch.train.metrics import get_clip_metrics, volume_voting_metrics

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

SHAPES = [(64, 64), (48, 70), (70, 33), (20, 30)]


def _img(seed, shape, rgb):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, shape + ((3,) if rgb else ())).astype(np.uint8)


@pytest.mark.parametrize("kind", ["bicubic", "bilinear"])
@pytest.mark.parametrize("rgb", [False, True])
def test_resize_bit_equal_to_pil(kind, rgb):
    """Up, down and non-square scaling, with and without a crop box
    (integer and fractional)."""
    pk = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}[kind]
    for i, (h, w) in enumerate(SHAPES + [(150, 130)]):
        a = _img(i, (h, w), rgb)
        pim = Image.fromarray(a)
        for size in [(64, 64), (31, 90), (w, 45), (h, w)]:
            np.testing.assert_array_equal(hi.resize(a, size, kind), np.asarray(pim.resize(size, pk)))
        for box in [(2, 3, 2 + w // 2, 3 + h // 2), (0, 0, w - 1, h), (1.5, 0.25, w - 0.5, h - 2.0)]:
            np.testing.assert_array_equal(hi.resize(a, (64, 64), kind, box=box),
                                          np.asarray(pim.resize((64, 64), pk, box=box)))


@pytest.mark.parametrize("kind", ["bicubic", "bilinear"])
def test_affine_and_kernel_filter_bit_equal_to_pil(kind):
    pk = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}[kind]
    rng = np.random.RandomState(3)
    for i, (h, w) in enumerate(SHAPES):
        for rgb in (False, True):
            a = _img(10 + i, (h, w), rgb)
            pim = Image.fromarray(a)
            for _ in range(3):
                ang, s = np.deg2rad(rng.uniform(-20, 20)), rng.uniform(0.8, 1.2)
                c, sn = np.cos(ang) / s, np.sin(ang) / s
                co = (c, sn, rng.uniform(-20, 20), -sn, c, rng.uniform(-20, 20))
                np.testing.assert_array_equal(hi.affine(a, co, kind),
                                              np.asarray(pim.transform(pim.size, Image.AFFINE, co, pk)))
            for sigma in (0.1, 0.8, 2.0):
                k1 = np.array([np.exp(-0.5 / sigma ** 2), 1.0, np.exp(-0.5 / sigma ** 2)])
                k = tuple(np.outer(k1, k1).reshape(-1) / k1.sum() ** 2)
                np.testing.assert_array_equal(
                    hi.filter3x3(a, k), np.asarray(pim.filter(ImageFilter.Kernel((3, 3), k, scale=1.0))))


def test_colour_ops_bit_equal_to_pil():
    for i, (h, w) in enumerate(SHAPES):
        a = _img(20 + i, (h, w), True)
        pim = Image.fromarray(a)
        np.testing.assert_array_equal(hi.to_grey(a), np.asarray(pim.convert("L")))
        hsv = np.asarray(pim.convert("HSV"))
        np.testing.assert_array_equal(hi.rgb_to_hsv(a), hsv)
        np.testing.assert_array_equal(hi.hsv_to_rgb(hsv), np.asarray(Image.fromarray(hsv, "HSV").convert("RGB")))
        for f in (0.2, 1.0, 1.6):
            np.testing.assert_array_equal(hi.blend(np.zeros_like(a), a, f),
                                          np.asarray(ImageEnhance.Brightness(pim).enhance(f)))
            np.testing.assert_array_equal(hi.blend(np.full_like(a, hi.mean_grey(a)), a, f),
                                          np.asarray(ImageEnhance.Contrast(pim).enhance(f)))
            np.testing.assert_array_equal(hi.blend(hi.to_rgb(hi.to_grey(a)), a, f),
                                          np.asarray(ImageEnhance.Color(pim).enhance(f)))


@pytest.mark.parametrize("resize_mode", ["shortest", "longest", "squash"])
@pytest.mark.parametrize("interpolation", ["bicubic", "bilinear"])
def test_eval_transform_bit_equal(resize_mode, interpolation):
    """Grey and RGB, up- and downscaling, square and not, pad-then-crop with
    a fill colour (a packed pixel for RGB, as PIL reads an int)."""
    for i, (h, w) in enumerate(SHAPES + [(256, 256)]):
        for rgb in (False, True):
            a = _img(30 + i, (h, w), rgb)
            for size in (64, (40, 56)):
                kw = dict(size=size, resize_mode=resize_mode, interpolation=interpolation,
                          fill_color=7)
                want = J.EvalTransform(J.PreprocessCfg(**kw))(Image.fromarray(a))
                got = T.EvalTransform(T.PreprocessCfg(**kw))(a)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aug", [None, dict(color_jitter=(0.4, 0.4, 0.4, 0.1), color_jitter_prob=0.8,
                                            gray_scale_prob=0.3)])
def test_train_transform_same_draws_and_pixels(aug):
    """Under `random.seed(s)` on both sides: the same draws (the global
    state after the call matches) and bit-equal pixels, for grey and RGB
    inputs, with and without the colour extras."""
    for i, (h, w) in enumerate(SHAPES):
        for rgb in (False, True):
            a = _img(40 + i, (h, w), rgb)
            size = 56
            tj = J.TrainTransform(J.PreprocessCfg(size=size), J.AugmentationCfg(**aug) if aug else None)
            tt = T.TrainTransform(T.PreprocessCfg(size=size), T.AugmentationCfg(**aug) if aug else None)
            for s in range(3):
                random.seed(s)
                want, after_j = tj(Image.fromarray(a)), random.random()
                random.seed(s)
                got, after_t = tt(a), random.random()
                assert after_t == after_j
                np.testing.assert_array_equal(got, want)


def test_transform_config_surface():
    assert T.merge_preprocess_kwargs(T.PreprocessCfg(), size=96, mean=None).size == 96
    assert T.PreprocessCfg(size=(32, 48)).input_size == (3, 32, 48)
    with pytest.raises(NotImplementedError, match="timm"):
        T.validate_aug_cfg(T.AugmentationCfg(use_timm=True))
    with pytest.raises(ValueError, match="color_jitter_prob"):
        T.validate_aug_cfg(T.AugmentationCfg(color_jitter=0.4))
    with pytest.raises(NotImplementedError, match="nearest"):
        T.EvalTransform(T.PreprocessCfg(interpolation="nearest"))
    assert isinstance(T.image_transform(64, True, aug_cfg={"scale": (0.8, 1.0)}), T.TrainTransform)
    assert isinstance(T.image_transform_v2(T.PreprocessCfg(), False), T.EvalTransform)


def test_canonicalize_clean_against_jax():
    from mrclip_tpu.tokenizer import get_clean_fn as jax_clean

    text = "A brain_MRI, plane AXIAL: (SIEMENS, Prisma_fit, 3) &amp; T2!"
    assert get_clean_fn("canonicalize")(text) == jax_clean("canonicalize")(text)
    assert canonicalize_text("a.b,c", keep_punctuation_exact_string=",") == "ab,c"
    tok, jtok = SimpleTokenizer(context_length=32, clean="canonicalize"), \
        JaxTokenizer(context_length=32, clean="canonicalize")
    np.testing.assert_array_equal(tok([text]), jtok([text]))


@pytest.fixture(scope="module")
def csv_set(tmp_path_factory):
    """16 PNG slices of 4 volumes with labels and captions carrying TE/TR."""
    root = tmp_path_factory.mktemp("csv")
    rng = np.random.RandomState(5)
    rows = []
    for i in range(16):
        path = root / f"ur_sub{i // 4}_axial_slice{120 + 2 * i}.png"
        shape = (40 + i, 50) if i % 3 else (50, 44)
        write_png(path, rng.randint(0, 256, shape).astype(np.uint8))
        te, tr = 0.01 * (i % 5 + 1), 0.5 * (i % 3 + 1)
        rows.append({"filepath": str(path), "text": f"A brain MRI, plane axial, Imaging Parameters "
                     f"(Echo Time, Repetition Time): ({te}, {tr}, nan, 90)", "label": i % 5})
    rows[3]["text"] = "NA"  # pandas reads it as NaN: the caption is "nan"
    write_table(root / "set.csv", rows)
    return root / "set.csv"


def _datasets(path, with_times=True):
    tj = J.EvalTransform(J.PreprocessCfg(size=32))
    tt = T.EvalTransform(T.PreprocessCfg(size=32))
    jd = jax_data.CsvDataset(str(path), tj, caption_key="text", tokenizer=JaxTokenizer(context_length=24),
                             with_times=with_times)
    td = data.CsvDataset(str(path), tt, caption_key="text", tokenizer=SimpleTokenizer(context_length=24),
                         with_times=with_times)
    return jd, td


def test_csv_dataset_items_equal_jax(csv_set):
    jd, td = _datasets(csv_set)
    assert len(td) == len(jd) == 16
    assert td.labels == jd.labels and td.volume_ids == jd.volume_ids and td.captions[3] == "nan"
    for i in range(len(td)):
        a, b = td[i], jd[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], str):
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    assert data.extract_times(td[0]["caption"]) == (0.01, 0.5)


def test_csv_dataset_without_label_column(tmp_path, csv_set):
    from mrclip_tpu_torch.data.table import read_table

    cols, rows = read_table(csv_set)
    write_table(tmp_path / "nolabel.csv", [{k: r[k] for k in ("filepath", "text")} for r in rows])
    td = data.CsvDataset(str(tmp_path / "nolabel.csv"), caption_key="text")
    assert td.labels == [0] * 16 and td[0]["images"].dtype == np.uint8
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        data.CsvTabularDataset(str(csv_set))


@pytest.mark.parametrize("kind", ["distributed", "unique_label", "unique_3d"])
def test_samplers_emit_jax_indices(kind):
    rng = np.random.RandomState(1)
    labels = rng.randint(0, 7, 57).tolist()
    vols = [f"v{i // 5}" for i in range(57)]
    for epoch in range(3):
        for rank, world in ((0, 1), (0, 2), (1, 2)):
            if kind == "distributed":
                mk = lambda m: m.DistributedSampler(57, rank, world, shuffle=True, seed=3)  # noqa: E731
            elif kind == "unique_label":
                mk = lambda m: m.UniqueLabelSampler(labels, 8, rank, world, seed=3)  # noqa: E731
            else:
                mk = lambda m: m.Unique3DSampler(labels, vols, 8, rank, world, seed=3)  # noqa: E731
            got, want = mk(data), mk(jax_data)
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want) and len(got) == len(want)


@pytest.mark.parametrize("workers", [0, 4])
def test_loader_batches_equal_jax(csv_set, workers):
    jd, td = _datasets(csv_set)
    js = jax_data.UniqueLabelSampler(jd.labels, 4, seed=2)
    ts = data.UniqueLabelSampler(td.labels, 4, seed=2)
    jl = jax_data.DataLoader(jd, 4, sampler=js, num_workers=workers, drop_last=True)
    tl = data.DataLoader(td, 4, sampler=ts, num_workers=workers, drop_last=True)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl) == 4
        for a, b in zip(tb, jb):
            assert sorted(a) == sorted(b)
            for k in a:
                if isinstance(a[k], list):
                    assert a[k] == b[k]
                else:
                    np.testing.assert_array_equal(a[k], b[k])


def test_loader_pins_batches(csv_set):
    _, td = _datasets(csv_set, with_times=False)
    batch = next(iter(data.DataLoader(td, 8, num_workers=2, pin_memory=False)))
    assert isinstance(batch["images"], np.ndarray) and isinstance(batch["caption"], list)
    if torch.cuda.is_available():
        pinned = next(iter(data.DataLoader(td, 8, num_workers=2, pin_memory=True)))
        assert pinned["images"].is_pinned()


class _Failing:
    """Eight samples; reading sample 5 raises."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 is unreadable")
        return {"x": np.full(3, i)}


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_raises_a_worker_error(workers):
    loader = data.DataLoader(_Failing(), 2, num_workers=workers)
    got = []
    with pytest.raises(ValueError, match="sample 5"):
        for batch in loader:
            got.append(batch["x"][:, 0].tolist())
    assert got == [[0, 1], [2, 3]]


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_stops_its_producer_when_left_early(csv_set, workers):
    import threading

    _, td = _datasets(csv_set, with_times=False)
    before = threading.active_count()
    it = iter(data.DataLoader(td, 2, num_workers=workers, prefetch_batches=1))
    next(it)
    it.close()  # the consumer leaves after one batch
    assert threading.active_count() == before


def _args(path, **kw):
    base = dict(train_data=str(path), val_data=str(path), dataset_type="csv", batch_size=3,
                workers=0, csv_caption_key="text", seed=0, accum_freq=1)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("dataset_type,unique3d", [("csv", False), ("csv-unique-sampler", False),
                                                   ("csv-unique-sampler", True), ("synthetic", False),
                                                   ("auto", False)])
def test_get_data_lengths_equal_jax(csv_set, dataset_type, unique3d):
    fns_t = (T.EvalTransform(T.PreprocessCfg(size=32)),) * 2
    fns_j = (J.EvalTransform(J.PreprocessCfg(size=32)),) * 2
    kw = dict(dataset_type=dataset_type, unique3d=unique3d, image_size=32, train_num_samples=10)
    got = data.get_data(_args(csv_set, **kw), fns_t)
    want = jax_data.get_data(_args(csv_set, **kw), fns_j)
    assert sorted(got) == sorted(want) == ["train", "val"]
    for split in got:
        assert len(got[split].dataloader) == len(want[split].dataloader)
        assert type(got[split].sampler).__name__ == type(want[split].sampler).__name__
    assert data._loader_batch(_args(csv_set, accum_freq=2), True) == 6


@pytest.mark.parametrize("flags,match", [
    (dict(train_data="shards-{000..003}.tar", dataset_type="auto"), "data/shards.py"),
    (dict(dataset_type="webdataset"), "data/shards.py"),
    (dict(tabular=True), "CsvTabularDataset"),
    (dict(imagenet_val="/x"), "zero_shot"),
    (dict(imagenet_v2="/x"), "zero_shot"),
])
def test_get_data_refuses_unported(csv_set, flags, match):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{match}"):
        data.get_data(_args(csv_set, **flags), (None, None))


def test_metrics_equal_jax():
    rng = np.random.RandomState(0)
    img, txt = rng.randn(40, 16).astype(np.float32), rng.randn(40, 16).astype(np.float32)
    labels = rng.randint(0, 6, 40)
    unique = np.arange(40)
    got = get_clip_metrics(img, txt, 7.5, labels, unique, trace=True)
    want = jax_clip_metrics(img, txt, 7.5, labels, unique, trace=True)
    assert got[0] == want[0] and got[1] == want[1]
    votes = {f"v{i}": [rng.randint(0, 4, 10).tolist() for _ in range(3)] for i in range(6)}
    truth = {v: [int(rng.randint(0, 4))] * 3 for v in votes}
    assert volume_voting_metrics(votes, truth) == jax_voting(votes, truth)
