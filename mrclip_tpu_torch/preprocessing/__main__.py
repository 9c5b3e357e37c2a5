"""Preprocessing CLI of the port: `python -m mrclip_tpu_torch.preprocessing <step>`.

The same four steps and flags as `python -m mrclip_tpu.preprocessing`, with
no PIL and no pandas; the CSVs and `label_dict.json` it writes are
byte-identical to the JAX package's on the same inputs:
  slices    NIfTI dir -> per-slice PNGs (only `ur_` series, no angio)
  captions  PNG+JSON sidecars -> CSV of (filepath, text)
  label     caption CSVs -> labeled CSVs (TE/TR/TI binning)
  split     labeled CSVs -> train/val/test (volume-grouped, 60/10/30)
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..data.table import read_table, write_table
from .binning import label_rows, load_bin_intervals
from .captions import build_caption_rows
from .nifti import determine_plane, process_nifti
from .split import merge_and_shuffle_split


def cmd_slices(args):
    total = 0
    for root, _, files in os.walk(args.input):
        for f in files:
            if not (f.endswith(".nii") or f.endswith(".nii.gz")):
                continue
            # only `ur_` (unringed) series, no angio
            if not f.startswith("ur_") or "angio" in f.lower():
                continue
            path = os.path.join(root, f)
            total += process_nifti(path, args.output, determine_plane(path))
    print(f"wrote {total} slices to {args.output}")


def cmd_captions(args):
    pngs = sorted(glob.glob(os.path.join(args.input, "**", "*.png"), recursive=True))

    def json_for_png(png):
        name = os.path.basename(png)
        stem = name.split("_slice")[0].rsplit("_", 1)[0]  # strip plane suffix
        return os.path.join(args.rawdata, stem + ".json")

    rows = build_caption_rows(pngs, json_for_png)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    write_table(args.output, rows)
    print(f"wrote {len(rows)} caption rows to {args.output}")


def cmd_label(args):
    bins = load_bin_intervals(args.bin_intervals)
    label_dict = {}
    for path in sorted(glob.glob(args.input)):
        _, table = read_table(path)
        rows, label_dict = label_rows(table, bins, label_dict)
        out = os.path.join(args.output, "labeled_" + os.path.basename(path))
        os.makedirs(args.output, exist_ok=True)
        # an all-filtered file yields zero rows and is written without
        # columns (one empty line), as the JAX package writes it
        write_table(out, [{k: v for k, v in r.items() if k != "label_key"} for r in rows])
        print(f"{path}: {len(rows)} rows -> {out}")
    with open(os.path.join(args.output, "label_dict.json"), "w") as f:
        json.dump(label_dict, f)
    print(f"{len(label_dict)} unique labels")


def cmd_split(args):
    train, val, test = merge_and_shuffle_split(
        args.input,
        os.path.join(args.output, "train.csv"),
        os.path.join(args.output, "val.csv"),
        os.path.join(args.output, "test.csv"),
        train_ratio=args.train_ratio,
        val_ratio=args.val_ratio,
    )
    print(f"train {len(train)} / val {len(val)} / test {len(test)}")


def main(argv=None):
    p = argparse.ArgumentParser("mrclip_tpu_torch.preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("slices")
    s.add_argument("--input", required=True)
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_slices)

    s = sub.add_parser("captions")
    s.add_argument("--input", required=True, help="PNG slices dir")
    s.add_argument("--rawdata", required=True, help="dir with JSON sidecars")
    s.add_argument("--output", required=True, help="output CSV path")
    s.set_defaults(fn=cmd_captions)

    s = sub.add_parser("label")
    s.add_argument("--input", required=True, help="glob of caption CSVs")
    s.add_argument("--output", required=True, help="output dir")
    s.add_argument("--bin-intervals", default=None)
    s.set_defaults(fn=cmd_label)

    s = sub.add_parser("split")
    s.add_argument("--input", required=True, help="dir of labeled_*.csv")
    s.add_argument("--output", required=True)
    s.add_argument("--train-ratio", type=float, default=0.6)
    s.add_argument("--val-ratio", type=float, default=0.1)
    s.set_defaults(fn=cmd_split)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
