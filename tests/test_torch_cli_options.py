"""The training CLI's options in the port (`python -m
mrclip_tpu_torch.train.main`): gradient accumulation (plain and cached),
remat, sgd, lion and adafactor, tower locking and `--freeze`, and the
vision-only epoch loop and eval, against the JAX package's CLI on the same
data and weights, and `--resume latest` under them.

As tests/test_torch_cli.py: a small synthetic study through the port's
preprocessing CLI, JAX's ViT-B-32-mini crossed over as `--pretrained`,
JAX under `--attn-impl xla` and the port under `fusedp` (plain versions on
the CPU), fp32, `--workers 0`, the same `--seed`; per-step losses and the
`results.jsonl` metrics within 1e-4 relative. The vision-only run is JAX's
tests/test_vision_only_cli.py scenario (image-only steps, an
image<->image eval whose metrics land in results.jsonl).
"""

import json

import numpy as np
import pytest
import torch

import mrclip_tpu.train.main as jax_main
import mrclip_tpu.train.vision_only as jax_vision_only
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu_torch import checkpoint as ckpt
from mrclip_tpu_torch import state_dict_from_flax
from mrclip_tpu_torch.preprocessing import __main__ as pre_cli
from mrclip_tpu_torch.preprocessing.synthetic import write_study
from mrclip_tpu_torch.train import main as port_main

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_options")
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
            "--dataset-type", "csv-unique-sampler", "--model", "ViT-B-32-mini",
            "--pretrained", str(root / "mini.pt"), "--epochs", "1", "--multipositiveloss",
            "--precision", "fp32", "--workers", "0", "--seed", "3", "--lr", "1e-3",
            "--wd", "0.2", "--warmup", "1", "--val-frequency", "1",
            "--logs", str(root / "logs"), "--name", name, *extra]


def _recording(module, attr, losses):
    """Wrap `module.<attr>` (a function that makes a train step) so that each step's loss is kept."""
    build = getattr(module, attr)

    def wrapped(*a, **kw):
        step = build(*a, **kw)

        def run(*sa, **skw):
            state, metrics = step(*sa, **skw)
            losses.append(float(np.asarray(metrics["loss"])))
            return state, metrics

        return run

    return wrapped


def _results(root, name):
    with open(root / "logs" / name / "checkpoints" / "results.jsonl") as f:
        return [json.loads(line) for line in f]


def _run_both(study, name, flags, makers):
    """Both CLIs on the same flags, each step's loss recorded: (JAX losses,
    port losses, the port's final state)."""
    mp = pytest.MonkeyPatch()
    losses = {"jax": [], "torch": []}
    for (jax_mod, port_mod, attr) in makers:
        mp.setattr(jax_mod, attr, _recording(jax_mod, attr, losses["jax"]))
        mp.setattr(port_mod, attr, _recording(port_mod, attr, losses["torch"]))
    try:
        jax_main.main(_flags(study, f"{name}_jax", "--attn-impl", "xla", *flags))
        state = port_main.main(_flags(study, f"{name}_torch", "--attn-impl", "fusedp",
                                      "--device", "cpu", *flags))
    finally:
        mp.undo()
    return losses["jax"], losses["torch"], state


TRAIN_STEP = [(jax_main, port_main, "build_train_step")]
OPTION_RUNS = {
    # the options of chip_smoke.py phase 14's CLI run, at the mini's size
    "cached_remat_lion_freeze": ["--batch-size", "4", "--accum-freq", "2",
                                 "--cached-features-accum", "--grad-checkpointing",
                                 "--remat-policy", "dots", "--opt", "lion", "--freeze",
                                 "--pallas-loss"],
    "plain_adafactor_lock_image": ["--batch-size", "4", "--accum-freq", "2", "--opt",
                                   "adafactor", "--lock-image", "--lock-image-unlocked-groups",
                                   "1", "--grad-checkpointing", "--remat-policy", "mlp_only"],
    "sgd_lock_text": ["--batch-size", "8", "--opt", "sgd", "--momentum", "0.8", "--lock-text",
                      "--lock-text-unlocked-layers", "1", "--grad-checkpointing",
                      "--remat-policy", "full"],
}


@pytest.mark.parametrize("run", sorted(OPTION_RUNS))
def test_cli_options_match_jax(study, run):
    """Three optimizer steps (24 train rows at 8 a step) under each set of
    flags: the per-step losses and the val metrics within 1e-4 relative."""
    jl, tl, state = _run_both(study, run, OPTION_RUNS[run], TRAIN_STEP)
    assert len(tl) == len(jl) == state.step == 3
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    got, want = _results(study, f"{run}_torch"), _results(study, f"{run}_jax")
    assert len(got) == len(want) == 1 and sorted(got[0]) == sorted(want[0])
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=TOL, err_msg=k)


def test_cli_vision_only_matches_jax(study):
    """`--visiononly --multipositiveloss`: the image-only steps' losses and
    the image<->image metrics and `vision_only_val_loss` in results.jsonl
    within 1e-4 relative, R@k in [0, 1]."""
    makers = [(jax_vision_only, port_main, "build_vision_only_step")]
    jl, tl, state = _run_both(study, "vo", ["--batch-size", "8", "--visiononly"], makers)
    assert len(tl) == len(jl) == state.step == 3
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    got, want = _results(study, "vo_torch"), _results(study, "vo_jax")
    assert len(got) == len(want) == 1 and sorted(got[0]) == sorted(want[0])
    assert "vision_only_val_loss" in got[0] and "image_to_image_R@1" in got[0]
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=TOL, err_msg=k)
    assert all(0.0 <= v <= 1.0 for k, v in got[0].items() if k.endswith(("R@1", "R@5", "R@10")))


def test_cli_vision_only_refuses_accumulation(study, tmp_path):
    with pytest.raises(ValueError, match="accum-freq"):
        port_main.main(["--model", "ViT-B-32-mini", "--device", "cpu", "--visiononly",
                        "--multipositiveloss", "--accum-freq", "2", "--logs",
                        str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()


@pytest.mark.parametrize("opt", ["lion", "adafactor"])
def test_cli_resume_is_bit_equal(study, opt):
    """One epoch, then `--resume latest` for a second, under cached
    accumulation, remat and `--freeze`: the state the resumed run trains
    from holds the epoch-1 checkpoint's parameters and optimizer state
    bit-equal, in their stored types, and its epoch-2 checkpoint counts six
    optimizer steps."""
    flags = ["--batch-size", "4", "--accum-freq", "2", "--cached-features-accum",
             "--grad-checkpointing", "--opt", opt, "--freeze", "--device", "cpu",
             "--attn-impl", "fusedp", "--val-frequency", "0", "--save-frequency", "1"]
    name = f"resumed_{opt}"
    ckdir = str(study / "logs" / name / "checkpoints")
    port_main.main(_flags(study, name, *flags))
    saved = ckpt.load_checkpoint(ckdir, 1)
    restored = {}
    load = ckpt.load_checkpoint

    def recording(*a, **kw):
        state = load(*a, **kw)
        restored["params"] = {k: v.clone() for k, v in state.params.items()}
        restored["opt"] = {f: {k: v.clone() for k, v in getattr(state.opt_state, f).items()}
                           for f in saved["opt_state"] if f != "count"}
        restored["count"] = state.opt_state.count
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_main.ckpt, "load_checkpoint", recording)
        port_main.main(_flags(study, name, *flags, "--epochs", "2", "--resume", "latest"))
    assert restored["count"] == saved["opt_state"]["count"] == 3
    for k, v in saved["params"].items():
        assert torch.equal(restored["params"][k], v), k
    for field, tensors in restored["opt"].items():
        for k, v in tensors.items():
            want = saved["opt_state"][field][k]
            assert v.dtype == want.dtype and torch.equal(v, want), (field, k)
    after = ckpt.load_checkpoint(ckdir, 2)
    assert after["step"] == after["opt_state"]["count"] == 6
