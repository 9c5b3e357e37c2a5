"""The port's training CLI under `--native-loader`, `--device-augment` and
both, against the JAX package's CLI on the same CSVs and weights.

The data and weights are `tests/test_torch_cli.py`'s kind: a small synthetic
study through the port's preprocessing CLI (44 x 50 slices), JAX's
ViT-B-32-mini crossed over into an open_clip `.pt`; both CLIs train one
epoch of 3 steps at batch 8 with a val pass, fp32, `--workers 1`, the same
`--seed`. Each run records what reaches its train step (the images after
the loader, the augmentation and the normalisation) and what its eval pass
makes of the native loader's uint8 canvases.

`--device-augment` draws from a torch generator in the port and from a key
in JAX, so the port's `draw_augment` is replaced by JAX's draws for the same
step (the key JAX folds from --seed, the epoch and 2 i + 1, split as its
`random_augment_batch` splits it): the rest is the port's own code. As in
the JAX package, the device augmentation runs on what the loader made: the
CSV loader's transformed, normalised floats, or the native loader's warped
canvases, a second time.

Tolerances: the native canvases within one level per uint8 pixel
(`tests/test_torch_native.py`), so step images within 1 / 255 / std plus
1e-4; the eval inputs and the augmented images 1e-4 (normalised values);
losses and `results.jsonl` 1e-4 relative."""

import json

import jax
import numpy as np
import pytest
import torch

import mrclip_tpu.train.loop as jax_loop
import mrclip_tpu.train.main as jax_main
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu_torch import state_dict_from_flax
from mrclip_tpu_torch.constants import OPENAI_DATASET_STD
from mrclip_tpu_torch.ops import image_ops
from mrclip_tpu_torch.preprocessing import __main__ as pre_cli
from mrclip_tpu_torch.preprocessing.synthetic import write_study
from mrclip_tpu_torch.train import loop as port_loop
from mrclip_tpu_torch.train import main as port_main

from test_torch_image_ops import jax_augment_draws

torch.set_num_threads(1)

TOL = 1e-4
SEED = 3
LEVEL = 1.0 / 255.0 / min(OPENAI_DATASET_STD)  # one uint8 level, normalised


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp("fast_input")
    write_study(str(root / "raw"), 8, shape=(44, 50, 224), slices=range(122, 134, 2), seed=4)
    pre_cli.main(["slices", "--input", str(root / "raw"), "--output", str(root / "slices")])
    pre_cli.main(["captions", "--input", str(root / "slices"), "--rawdata", str(root / "raw"),
                  "--output", str(root / "cap" / "captions.csv")])
    pre_cli.main(["label", "--input", str(root / "cap" / "*.csv"), "--output", str(root / "lab")])
    (root / "split").mkdir()
    pre_cli.main(["split", "--input", str(root / "lab"), "--output", str(root / "split"),
                  "--train-ratio", "0.5", "--val-ratio", "0.25"])
    _, jv = jax_create_model("ViT-B-32-mini", scan_layers=False)
    torch.save(state_dict_from_flax(jv["params"]), root / "mini.pt")
    return root


def _flags(root, name, *extra):
    return ["--train-data", str(root / "split" / "train.csv"),
            "--val-data", str(root / "split" / "val.csv"), "--csv-caption-key", "text",
            "--dataset-type", "csv", "--model", "ViT-B-32-mini",
            "--pretrained", str(root / "mini.pt"), "--batch-size", "8", "--epochs", "1",
            "--multipositiveloss", "--precision", "fp32", "--workers", "1", "--seed", str(SEED),
            "--lr", "1e-4", "--wd", "0.2", "--warmup", "1", "--val-frequency", "1",
            "--aug-cfg", "scale=(0.7,1.0)", "--logs", str(root / "logs"), "--name", name, *extra]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _recording_step(module, rec):
    build = module.build_train_step

    def wrapped(*a, **kw):
        step = build(*a, **kw)

        def run(state, batch, *sa, **skw):
            rec["images"].append(_np(batch["images"]).copy())
            state, metrics = step(state, batch, *sa, **skw)
            rec["losses"].append(float(np.asarray(metrics["loss"])))
            return state, metrics

        return run

    return wrapped


def _recording_eval(module, rec):
    fn = module._maybe_preprocess_images

    def wrapped(batch, *a, **kw):
        raw = batch.get("images")
        out = fn(batch, *a, **kw)
        rec["eval_in"].append(str(_np(raw).dtype))
        rec["eval"].append(_np(out["images"]).copy())
        return out

    return wrapped


def _jax_draws_in_step_order(aug_kw):
    """A stand-in for the port's `draw_augment` that returns what JAX's
    `--device-augment` draws at the same step of epoch 0."""
    calls = []

    def draw(n, in_hw, generator, **kw):
        i = len(calls)
        calls.append(in_hw)
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(SEED), 0), 2 * i + 1)
        return jax_augment_draws(key, n, tuple(in_hw), **kw)[0]

    return draw, calls


FLAGS = {"native": ["--native-loader"], "device": ["--device-augment"],
         "both": ["--native-loader", "--device-augment"]}


@pytest.fixture(scope="module", params=sorted(FLAGS))
def runs(request, study):
    name = request.param
    flags = FLAGS[name]
    rec = {side: {"images": [], "losses": [], "eval": [], "eval_in": [], "aug_in": []}
           for side in ("jax", "torch")}
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_main, "build_train_step", _recording_step(jax_main, rec["jax"]))
    mp.setattr(port_main, "build_train_step", _recording_step(port_main, rec["torch"]))
    mp.setattr(jax_loop, "_maybe_preprocess_images", _recording_eval(jax_loop, rec["jax"]))
    mp.setattr(port_loop, "_maybe_preprocess_images", _recording_eval(port_loop, rec["torch"]))
    draw, calls = _jax_draws_in_step_order(None)
    mp.setattr(image_ops, "draw_augment", draw)
    apply = image_ops.apply_augment

    def recording_apply(images, *a, **kw):
        rec["torch"]["aug_in"].append(_np(images).copy())
        return apply(images, *a, **kw)

    mp.setattr(image_ops, "apply_augment", recording_apply)
    try:
        jax_main.main(_flags(study, f"jax_{name}", "--attn-impl", "xla", *flags))
        state = port_main.main(_flags(study, f"torch_{name}", "--attn-impl", "fusedp",
                                      "--device", "cpu", *flags))
    finally:
        mp.undo()
    return name, rec, state, calls


def _results(root, name):
    with open(root / "logs" / name / "checkpoints" / "results.jsonl") as f:
        return [json.loads(line) for line in f]


def test_step_inputs_match_jax(runs):
    """What reaches the train step: the same images within the tolerance,
    of the shape and kind each flag combination makes."""
    name, rec, state, calls = runs
    got, want = rec["torch"]["images"], rec["jax"]["images"]
    assert len(got) == len(want) == state.step == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (8, 64, 64, 3) and g.dtype == w.dtype == np.float32
        tol = TOL + (LEVEL if name == "native" else 0.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    # the device augmentation ran on the card's side of each step, on what
    # the loader made: 64 x 64 (the CSV loader's transform or the canvas)
    assert calls == ([(64, 64)] * 3 if name != "native" else [])


def test_double_augmentation_is_kept(runs):
    """Under --device-augment the card augments what the loader made, as
    JAX's CLI does (the step inputs above match it): the CSV loader's
    transformed, normalised floats, or the native loader's warped uint8
    canvases, each warped, blurred and normalised a second time. Without it
    nothing is augmented on the card."""
    name, rec, _, _ = runs
    aug_in, steps = rec["torch"]["aug_in"], rec["torch"]["images"]
    if name == "native":
        assert aug_in == []
        return
    assert len(aug_in) == len(steps) == 3
    for x, step in zip(aug_in, steps):
        assert x.shape == (8, 64, 64, 3)
        if name == "device":  # TrainTransform's output: normalised floats
            assert x.dtype == np.float32 and x.min() < -1.0 and x.max() > 1.0
            once = x
        else:  # the native warp's canvases
            assert x.dtype == np.uint8
            once = image_ops.normalize_images(torch.from_numpy(x)).numpy()
        assert np.abs(step - once).max() > 0.5  # augmented again, not passed through


def test_eval_on_uint8_batches_matches_jax(runs):
    name, rec, _, _ = runs
    got, want = rec["torch"]["eval"], rec["jax"]["eval"]
    assert len(got) == len(want) == 2  # 12 val rows, batch 8
    native = name != "device"
    assert rec["torch"]["eval_in"] == rec["jax"]["eval_in"] == (
        ["uint8"] * 2 if native else ["float32"] * 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL + (LEVEL if native else 0.0))


def test_losses_and_results_match_jax(runs, study):
    name, rec, _, _ = runs
    np.testing.assert_allclose(rec["torch"]["losses"], rec["jax"]["losses"], rtol=TOL)
    assert all(np.isfinite(rec["torch"]["losses"]))
    got, want = _results(study, f"torch_{name}"), _results(study, f"jax_{name}")
    assert len(got) == len(want) == 1 and sorted(got[0]) == sorted(want[0])
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=TOL, atol=TOL, err_msg=k)
    log = (study / "logs" / f"torch_{name}" / "out.log").read_text()
    assert "Train Epoch: 0 [24/24 (100%)]" in log and "NotImplementedError" not in log
