"""The port's training CLI (`python -m mrclip_tpu_torch.train.main`) against
the JAX package's on the same data and weights, and its checkpoints.

The data: a small synthetic study through the port's preprocessing CLI.
The weights: JAX's ViT-B-32-mini crossed over by `state_dict_from_flax`
into an open_clip `.pt`, passed to both CLIs as `--pretrained`. JAX runs
`--attn-impl xla`, the port `fusedp` (its kernels' plain versions on the
CPU), both fp32 with `--workers 0`, the same `--seed`,
`--multipositiveloss`, `--dataset-type csv-unique-sampler`, batch 8, one
epoch of 3 steps and a val pass. The train transforms are bit-equal
(`tests/test_torch_data.py`), so the per-step losses and the
`results.jsonl` metrics agree within 1e-4 relative."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import mrclip_tpu.train.main as jax_main
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu_torch import checkpoint as ckpt
from mrclip_tpu_torch import state_dict_from_flax
from mrclip_tpu_torch.factory import create_model
from mrclip_tpu_torch.parallel import create_optimizer, create_train_state
from mrclip_tpu_torch.preprocessing import __main__ as pre_cli
from mrclip_tpu_torch.preprocessing.synthetic import write_study
from mrclip_tpu_torch.train import main as port_main

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """train.csv (24 rows, 4 volumes), val.csv (12 rows) and the shared
    pretrained weights."""
    root = tmp_path_factory.mktemp("cli")
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
            "--pretrained", str(root / "mini.pt"), "--batch-size", "8", "--epochs", "1",
            "--multipositiveloss", "--precision", "fp32", "--workers", "0", "--seed", "3",
            "--lr", "1e-4", "--wd", "0.2", "--warmup", "1", "--val-frequency", "1",
            "--logs", str(root / "logs"), "--name", name, *extra]


def _recording(module, losses):
    """Wrap `module.build_train_step` so that each step's loss is kept."""
    build = module.build_train_step

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


@pytest.fixture(scope="module")
def runs(study):
    mp = pytest.MonkeyPatch()
    losses = {"jax": [], "torch": []}
    mp.setattr(jax_main, "build_train_step", _recording(jax_main, losses["jax"]))
    mp.setattr(port_main, "build_train_step", _recording(port_main, losses["torch"]))
    try:
        jax_main.main(_flags(study, "jax", "--attn-impl", "xla"))
        state = port_main.main(_flags(study, "torch", "--attn-impl", "fusedp", "--device", "cpu"))
    finally:
        mp.undo()
    return losses, state


def test_cli_losses_match_jax(runs):
    losses, state = runs
    assert len(losses["torch"]) == len(losses["jax"]) == state.step == 3
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=TOL)
    assert all(np.isfinite(losses["torch"]))


def test_cli_results_match_jax(runs, study):
    got, want = _results(study, "torch"), _results(study, "jax")
    assert len(got) == len(want) == 1 and sorted(got[0]) == sorted(want[0])
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=TOL, err_msg=k)
    assert got[0]["num_samples"] == 12 and got[0]["epoch"] == 1


def test_cli_writes_its_files(runs, study):
    run = study / "logs" / "torch"
    assert (run / "out.log").is_file() and (run / "params.txt").is_file()
    assert "device: cpu" in (run / "params.txt").read_text()
    log = (run / "out.log").read_text()
    assert "Train Epoch: 0 [24/24 (100%)]" in log and "kernel launches: {}" in log
    assert ckpt.latest_step(str(run / "checkpoints")) == 1


def test_resume_restores_state_bit_equal(runs, study):
    """The checkpoint holds the trained state; resuming it into a fresh
    state restores parameters, moments and step bit for bit."""
    _, state = runs
    saved = ckpt.load_checkpoint(str(study / "logs" / "torch" / "checkpoints"))
    assert saved["step"] == state.step == 3 and saved["opt_state"]["count"] == 3
    model = create_model("ViT-B-32-mini", device="cpu", rng_seed=9)
    fresh = create_train_state(model, create_optimizer(lr=1e-4))
    restored = ckpt.load_checkpoint(str(study / "logs" / "torch" / "checkpoints"), template=fresh)
    assert restored.step == 3 and restored.opt_state.count == 3
    for name, p in state.params.items():
        assert torch.equal(restored.params[name], p.detach())
        assert torch.equal(dict(model.named_parameters())[name], p.detach())
        assert torch.equal(restored.opt_state.mu[name], state.opt_state.mu[name])
        assert torch.equal(restored.opt_state.nu[name], state.opt_state.nu[name])


def test_resume_latest(runs, study):
    """`--resume latest` when the run is done trains nothing; with one more
    epoch it trains exactly that epoch from the saved state."""
    shutil.copytree(study / "logs" / "torch", study / "logs" / "torch_resume")
    flags = _flags(study, "torch_resume", "--attn-impl", "fusedp", "--device", "cpu",
                   "--resume", "latest")
    assert port_main.main(flags).step == 3
    more = port_main.main([*flags[:flags.index("--epochs") + 1], "2",
                           *flags[flags.index("--epochs") + 2:]])
    assert more.step == 6
    assert ckpt.latest_step(str(study / "logs" / "torch_resume" / "checkpoints")) == 2
    assert [r["epoch"] for r in _results(study, "torch_resume")] == [1, 2]


def test_test_mode_matches_jax(study):
    """`--test` (full-set ranks against the unique captions, 3D volume
    voting) on the pretrained weights, against JAX's."""
    jm = jax_main.main(_flags(study, "jax_test", "--attn-impl", "xla", "--test"))
    tm = port_main.main(_flags(study, "torch_test", "--attn-impl", "fusedp", "--device", "cpu",
                               "--test"))
    assert sorted(tm) == sorted(jm) and "3d_vote_top1_accuracy" in tm
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, rtol=TOL, err_msg=k)
    out = study / "logs" / "torch_test" / "checkpoints"
    assert (out / "i2t_ranks.npy").is_file() and (out / "grouped_3d_analysis.json").is_file()


@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_checkpoint_round_trip(tmp_path, moments):
    """Params, bf16 or fp32 moments, the step and the frozen logit scale
    come back bit-equal onto the state's own tensors; keep=1 keeps the
    newest file and no temporary one is left."""
    model = create_model("ViT-B-32-mini", device="cpu", logit_scale_trainable=False)
    tx = create_optimizer(lr=1e-3, moments_dtype=moments)
    state = create_train_state(model, tx)
    assert "logit_scale" in state.constants and "logit_scale" not in state.params
    g = torch.Generator().manual_seed(0)
    for t in [*state.params.values(), *state.opt_state.mu.values(), *state.opt_state.nu.values()]:
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=g))
    state.step, state.opt_state.count = 7, 7
    want = {k: v.clone() for k, v in state.params.items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), step, state, keep=1)
    assert sorted(os.listdir(tmp_path)) == ["step_3.pt"] and ckpt.latest_step(str(tmp_path)) == 3
    with torch.no_grad():
        model.logit_scale.fill_(0.0)
    other = create_train_state(model, tx)
    with torch.no_grad():
        for t in other.params.values():
            t.zero_()
    back = ckpt.load_checkpoint(str(tmp_path), template=other)
    assert back.step == 7 and back.opt_state.count == 7
    assert next(iter(back.opt_state.mu.values())).dtype == (torch.bfloat16 if moments else torch.float32)
    for k in want:
        assert torch.equal(back.params[k], want[k]) and torch.equal(back.opt_state.mu[k], mu[k])
    assert model.logit_scale.item() == pytest.approx(np.log(10.0))
    with pytest.raises(KeyError, match="do not match"):
        ckpt.load_checkpoint(str(tmp_path), template=create_train_state(
            create_model("ViT-B-32-mini", device="cpu"), tx))
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"))


@pytest.mark.parametrize("flags,item", [
    (["--mesh-fsdp", "2"], "modules item 6"),
    (["--mesh-tp", "2"], "modules item 6"),
    (["--remote-sync", "s3://x"], "file_utils"),
    (["--linear"], "linear_probe"),
    (["--train-data", "shards-{0..3}.tar", "--logs", "LOGS"], "data/shards.py"),
    (["--force-patch-dropout", "0.5", "--dataset-type", "synthetic", "--logs", "LOGS"],
     "modules item 4"),
])
def test_cli_refuses_unported_flags(tmp_path, flags, item):
    """Each raises naming its ROADMAP item; the flags `train.main` checks
    first are refused before anything is written."""
    early = "LOGS" not in flags
    flags = [f for f in flags if f not in ("--logs", "LOGS")]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        port_main.main(["--model", "ViT-B-32-mini", "--device", "cpu", "--logs",
                        str(tmp_path / "logs"), *flags])
    assert (tmp_path / "logs").exists() != early
