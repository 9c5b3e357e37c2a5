"""The port's PNG codec and MRI preprocessing (`mrclip_tpu_torch.data.png`,
`mrclip_tpu_torch.preprocessing`) against PIL and the JAX package's
preprocessing on the same inputs: decoded pixels bit-equal to PIL's, the
same slice files and pixels, and caption, labeled and split CSVs and
`label_dict.json` byte-identical to those of `python -m
mrclip_tpu.preprocessing`. Volumes come from a numpy seed, small."""

import glob
import io
import json
import os
import struct
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from mrclip_tpu.preprocessing import __main__ as jax_cli
from mrclip_tpu.preprocessing import determine_plane as jax_determine_plane
from mrclip_tpu.preprocessing import filter_slices as jax_filter_slices
from mrclip_tpu.preprocessing import merge_and_shuffle_split as jax_split
from mrclip_tpu.preprocessing import read_nifti as jax_read_nifti
from mrclip_tpu_torch.data import png
from mrclip_tpu_torch.data.table import read_table, write_table
from mrclip_tpu_torch.preprocessing import __main__ as cli
from mrclip_tpu_torch.preprocessing import (determine_plane, filter_slices,
                                            merge_and_shuffle_split, read_nifti, write_nifti)
from mrclip_tpu_torch.preprocessing.synthetic import write_study

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _filter_types(data: bytes) -> set:
    """The row filter types of a PNG's image data."""
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            header = struct.unpack_from(">IIBB", data, pos + 8)
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, colour = header
    row = 1 + w * {0: 1, 4: 2, 2: 3, 6: 4}[colour]
    raw = zlib.decompress(idat)
    return {raw[i * row] for i in range(h)}


def _image(rng, h, w, ch):
    """Smooth ramps plus noise: PIL's encoder then picks Sub, Up and Paeth rows."""
    a = rng.rand(h, w, ch) * 60 + np.linspace(0, 190, w)[None, :, None]
    a = a.astype(np.uint8)
    return a[..., 0] if ch == 1 else a


@pytest.mark.parametrize("mode", list(MODES))
def test_png_decodes_pil_files_bit_equal(mode):
    """Every width (1 and odd ones too) of every mode PIL writes, as
    `np.asarray(Image.open(...))` reads it back; the files carry the filter
    types PIL emits."""
    rng = np.random.RandomState(MODES[mode])
    seen = set()
    for w in (1, 7, 67, 256):
        a = _image(rng, 41, w, MODES[mode])
        buf = io.BytesIO()
        Image.fromarray(a, mode).save(buf, "PNG")
        data = buf.getvalue()
        seen |= _filter_types(data)
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = png.read_png(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert {1, 2, 4} <= seen


@pytest.mark.parametrize("mode", list(MODES))
def test_png_written_reads_back_through_pil(tmp_path, mode):
    rng = np.random.RandomState(10 + MODES[mode])
    for w in (1, 5, 64):
        a = _image(rng, 23, w, MODES[mode])
        path = tmp_path / f"{mode}_{w}.png"
        png.write_png(path, a)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
        np.testing.assert_array_equal(png.read_png(str(path)), a)


def _reference_unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The PNG specification's reconstruction, byte by byte."""
    out = np.zeros((h, rowbytes), np.int64)
    for y in range(h):
        t = raw[y * (rowbytes + 1)]
        f = raw[y * (rowbytes + 1) + 1:(y + 1) * (rowbytes + 1)]
        for i in range(rowbytes):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y else 0
            c = out[y - 1, i - bpp] if (y and i >= bpp) else 0
            if t == 0:
                pred = 0
            elif t == 1:
                pred = a
            elif t == 2:
                pred = b
            elif t == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, i] = (f[i] + pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp", [1, 3])
def test_unfilter_all_five_filters(bpp):
    """Random filtered rows of each type 0-4 (Average included, which PIL
    rarely picks) reconstruct as the specification says; an unknown type
    raises."""
    rng = np.random.RandomState(bpp)
    h, rowbytes = 10, 7 * bpp
    rows = rng.randint(0, 256, (h, rowbytes + 1)).astype(np.uint8)
    rows[:, 0] = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]
    raw = rows.tobytes()
    np.testing.assert_array_equal(png.unfilter(raw, h, rowbytes, bpp),
                                  _reference_unfilter(raw, h, rowbytes, bpp))
    rows[4, 0] = 5
    with pytest.raises(ValueError, match="filter type"):
        png.unfilter(rows.tobytes(), h, rowbytes, bpp)


def test_png_refuses_other_formats():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(buf, "PNG")
    with pytest.raises(NotImplementedError, match="8-bit grey"):
        png.read_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(b"GIF89a")


@pytest.mark.parametrize("dtype,gz", [(np.float32, False), (np.int16, False), (np.float32, True),
                                      (np.uint8, True)])
def test_nifti_write_read_against_jax(tmp_path, dtype, gz):
    vol = (np.random.RandomState(0).rand(9, 11, 13) * 300).astype(dtype)
    path = str(tmp_path / ("v.nii.gz" if gz else "v.nii"))
    write_nifti(path, vol, pixdim=(1.0, 2.0, 3.0))
    data, hdr = read_nifti(path)
    jdata, jhdr = jax_read_nifti(path)
    np.testing.assert_array_equal(data, vol.astype(np.float64))
    np.testing.assert_array_equal(data, jdata)
    assert hdr == jhdr


def test_determine_plane_against_jax(tmp_path):
    vol = np.zeros((5, 6, 7), np.float32)
    for pixdim, want in [((3.0, 1.0, 1.0), "sagittal"), ((1.0, 3.0, 1.0), "coronal"),
                         ((1.0, 1.0, 3.0), "axial")]:
        path = str(tmp_path / f"ur_{want}.nii")
        write_nifti(path, vol, pixdim=pixdim)
        assert determine_plane(path) == jax_determine_plane(path) == want
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"\0" * 400)
    assert determine_plane(str(bad)) == jax_determine_plane(str(bad)) == "axial"


def _rel(paths, root):
    return sorted(os.path.relpath(p, root) for p in paths)


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both CLIs, step by step on the same inputs: slices from the same raw
    study (float32, int16 and gzipped volumes; an `angio` and a non-`ur_`
    series that the step skips), then captions, label (with a second caption
    CSV whose rows all have a dropped flip angle) and split, each from the
    same files."""
    root = tmp_path_factory.mktemp("pre")
    raw = root / "raw"
    write_study(str(raw), 4, shape=(44, 48, 224), slices=range(118, 224, 3), seed=1)
    write_study(str(raw / "int"), 3, shape=(46, 42, 222), slices=range(120, 222, 2), seed=2,
                dtype=np.int16, gz=True)
    for f in glob.glob(str(raw / "int" / "ur_*")):  # other names, same protocols
        os.rename(f, f.replace("ur_sub", "ur_int"))
    write_nifti(str(raw / "ur_angio_x.nii"), np.ones((50, 50, 3), np.float32))
    write_nifti(str(raw / "sub_plain.nii"), np.ones((50, 50, 3), np.float32))
    out = {}
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        main(["slices", "--input", str(raw), "--output", str(root / name / "slices")])
        out[name] = root / name
    # later steps read the same files: the port's slices
    slices = root / "torch" / "slices"
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        d = out[name]
        main(["captions", "--input", str(slices), "--rawdata", str(raw), "--output",
              str(d / "cap" / "captions.csv")])
        main(["captions", "--input", str(slices), "--rawdata", str(raw / "int"), "--output",
              str(d / "cap" / "captions_int.csv")])
    rows = read_table(out["torch"] / "cap" / "captions.csv")[1]
    caps = root / "caps"
    caps.mkdir()
    for f in ("captions.csv", "captions_int.csv"):
        (caps / f).write_bytes((out["torch"] / "cap" / f).read_bytes())
    flip9 = [r for r in rows if r["text"].endswith(", 9)")]
    assert flip9
    write_table(caps / "captions_x.csv", [dict(r, text=r["text"][:-3] + "15)") for r in flip9])
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        main(["label", "--input", str(caps / "*.csv"), "--output", str(out[name] / "lab")])
    # split reads the labeled files that have rows (both packages refuse an
    # empty one: test_split_refuses_a_file_without_columns)
    split_in = root / "split_in"
    split_in.mkdir()
    for f in ("labeled_captions.csv", "labeled_captions_int.csv"):
        (split_in / f).write_bytes((out["torch"] / "lab" / f).read_bytes())
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        (out[name] / "split").mkdir()
        main(["split", "--input", str(split_in), "--output",
              str(out[name] / "split"), "--train-ratio", "0.5", "--val-ratio", "0.2"])
    out["root"] = root
    return out


def test_split_refuses_a_file_without_columns(pipelines, tmp_path):
    """An all-filtered labeled file is one empty line; the JAX split's
    `pd.read_csv` raises on it (EmptyDataError, a ValueError), and so does
    the port's."""
    (tmp_path / "labeled_x.csv").write_bytes(
        (pipelines["torch"] / "lab" / "labeled_captions_x.csv").read_bytes())
    for split in (jax_split, merge_and_shuffle_split):
        with pytest.raises(ValueError, match="[Nn]o columns"):
            split(str(tmp_path), "", "", "")


def test_slices_same_files_and_pixels(pipelines):
    got = _rel(glob.glob(str(pipelines["torch"] / "slices" / "*.png")), pipelines["torch"])
    want = _rel(glob.glob(str(pipelines["jax"] / "slices" / "*.png")), pipelines["jax"])
    assert got == want and len(got) > 100
    assert not [f for f in got if "angio" in f or "plain" in f]
    for rel in got[::7]:
        a = png.read_png(str(pipelines["torch"] / rel))
        b = np.asarray(Image.open(pipelines["jax"] / rel))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rel", ["cap/captions.csv", "cap/captions_int.csv",
                                 "lab/labeled_captions.csv", "lab/labeled_captions_int.csv",
                                 "lab/labeled_captions_x.csv", "lab/label_dict.json",
                                 "split/train.csv", "split/val.csv", "split/test.csv"])
def test_csvs_byte_identical(pipelines, rel):
    got = (pipelines["torch"] / rel).read_bytes()
    assert got == (pipelines["jax"] / rel).read_bytes()
    if rel.endswith("_x.csv"):  # every row had a dropped flip angle
        assert got == b"\n"
    elif rel.startswith("split"):
        assert got.count(b"\n") > 1
    if rel.endswith(".json"):
        assert len(json.loads(got)) >= 4  # several protocols, several labels


def test_split_volumes_disjoint(pipelines):
    from mrclip_tpu_torch.preprocessing import extract_image_id

    ids = [{extract_image_id(r["filepath"]) for r in
            read_table(pipelines["torch"] / "split" / f"{s}.csv")[1]} for s in ("train", "val", "test")]
    assert all(ids) and not (ids[0] & ids[1] or ids[0] & ids[2] or ids[1] & ids[2])


def test_filter_and_split_on_tables_against_jax(pipelines, tmp_path):
    """`filter_slices` and `merge_and_shuffle_split` on in-memory tables
    against JAX's on the same frames: the same rows, in the same order."""
    tables = [read_table(f)[1] for f in sorted(glob.glob(str(pipelines["torch"] / "lab" / "labeled_captions*.csv")))
              if os.path.getsize(f) > 1]
    frames = [pd.DataFrame(t).astype({"label": int}) for t in tables]
    for t, f in zip(tables, frames):
        assert [r["filepath"] for r in filter_slices(t)] == jax_filter_slices(f)["filepath"].tolist()
    got = merge_and_shuffle_split(tables, "", str(tmp_path / "v.csv"), "", seed=7)
    want = jax_split(frames, "", str(tmp_path / "jv.csv"), "", seed=7)
    for g, w in zip(got, want):
        assert [r["filepath"] for r in g] == w["filepath"].tolist()
        assert [int(r["label"]) for r in g] == w["label"].tolist()
    assert (tmp_path / "v.csv").read_bytes() == (tmp_path / "jv.csv").read_bytes()


def test_table_matches_pandas_layout(tmp_path):
    rows = [{"a": 1, "b": 'x, "y"', "c": 0.1}, {"a": 2, "b": "z\nw", "c": float("nan")}]
    write_table(tmp_path / "t.csv", rows)
    pd.DataFrame(rows).to_csv(tmp_path / "p.csv", index=False)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "p.csv").read_bytes()
    cols, back = read_table(tmp_path / "t.csv")
    assert cols == ["a", "b", "c"] and back[1]["b"] == "z\nw"
    write_table(tmp_path / "e.csv", [])
    pd.DataFrame([]).to_csv(tmp_path / "pe.csv", index=False)
    assert (tmp_path / "e.csv").read_bytes() == (tmp_path / "pe.csv").read_bytes()
    with pytest.raises(ValueError, match="no columns"):
        read_table(tmp_path / "e.csv")
