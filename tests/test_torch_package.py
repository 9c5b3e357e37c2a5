"""Package rules of the PyTorch port (mrclip_tpu_torch) and its chip_smoke.py:
no JAX, CUDA by default, byte-identical copies of configs and vocab, and a
Hopper build of every kernel source."""

import filecmp
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mrclip_tpu_torch import export as export_cli
from mrclip_tpu_torch import serve
from mrclip_tpu_torch.factory import create_model
from mrclip_tpu_torch.ops import build
from mrclip_tpu_torch.parallel import create_optimizer, create_train_state
from mrclip_tpu_torch.serving import export_model, load_exported, save_exported

ROOT = Path(__file__).resolve().parents[1]

_IMPORTS_NO_JAX = """
import sys
import chip_smoke, mrclip_tpu_torch
import mrclip_tpu_torch.export, mrclip_tpu_torch.serve, mrclip_tpu_torch.ops.fused_attn
import mrclip_tpu_torch.ops.flash_attn
import mrclip_tpu_torch.ops.pallas_loss, mrclip_tpu_torch.ops.image_ops, mrclip_tpu_torch.ops.pos_embed
import mrclip_tpu_torch.models.vision, mrclip_tpu_torch.models.transformer, mrclip_tpu_torch.weights
import mrclip_tpu_torch.losses, mrclip_tpu_torch.parallel, mrclip_tpu_torch.train
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "mrclip_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORTS_NO_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pkg") / "m.mrclip")
    save_exported(export_model(create_model("ViT-B-32-mini", device="cpu")), path)
    return path


@pytest.mark.parametrize("entry", ["create_model", "create_model EVA02-B-16", "load_exported",
                                   "make_server", "serve.main", "export.main", "train"])
def test_entry_points_need_cuda_unless_asked(no_cuda, artifact, tmp_path, entry):
    """The training path runs on its model's device, so it too stops at
    create_model without a card unless given device='cpu'."""
    calls = {
        "create_model": lambda: create_model("ViT-B-32-mini"),
        "create_model EVA02-B-16": lambda: create_model("EVA02-B-16", attn_impl="fusedp"),
        "train": lambda: create_train_state(create_model("ViT-B-32-mini", attn_impl="fusedp"),
                                            create_optimizer(lr=1e-4)),
        "load_exported": lambda: load_exported(artifact),
        "make_server": lambda: serve.make_server(artifact, host="127.0.0.1", port=0),
        "serve.main": lambda: serve.main(["--model", artifact, "--port", "0"]),
        "export.main": lambda: export_cli.main(
            ["--model", "ViT-B-32-mini", "--output", str(tmp_path / "x.mrclip")]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("rel", [
    "model_configs/ViT-B-16.json",
    "model_configs/ViT-B-32-mini.json",
    "model_configs/EVA02-B-16.json",
    "assets/bpe_simple_vocab_16e6.txt.gz",
])
def test_copied_files_are_byte_identical(rel):
    assert filecmp.cmp(ROOT / "mrclip_tpu" / rel, ROOT / "mrclip_tpu_torch" / rel, shallow=False)


@pytest.mark.parametrize("source,entries,tpu_kernels", [
    ("packed_attn_fwd.cu", ["packed_attn_fwd", "packed_attn_rope_fwd"],
     ["fused_attn.py::_packed_fwd_kernel", "rope branch"]),
    ("packed_attn_bwd.cu", ["packed_attn_bwd", "packed_attn_rope_bwd"],
     ["fused_attn.py::_packed_bwd_kernel", "_rope_unrotate_grad"]),
    ("supcon_loss.cu", ["supcon_stats", "supcon_grad_q", "supcon_grad_k"],
     ["pallas_loss.py", "_fwd_kernel", "_grad_q_kernel", "_grad_k_kernel"]),
    ("grouped_attn.cu", ["grouped_attn_fwd", "grouped_attn_bwd"],
     ["fused_attn.py::_fwd_kernel", "fused_attn.py::_bwd_kernel"]),
    ("flash_attn.cu", ["flash_attn_fwd", "flash_attn_bwd"],
     ["flash_attn.py::flash_attention_unpadded", "_flash_attention_kernel_single_batch",
      "_flash_attention_dkv_kernel", "_flash_attention_dq_kernel"]),
])
def test_kernel_source_builds_for_hopper(source, entries, tpu_kernels):
    src = build.CSRC / source
    assert src.is_file()
    text = src.read_text()
    for entry in entries:
        assert f'extern "C" int {entry}(' in text
    for kernel in tpu_kernels:  # names the TPU kernel it replaces
        assert kernel in text
    headers = "".join((build.CSRC / h).read_text() for h in build._headers(src))
    assert "cudaGetLastError()" in text + headers
    cmd = build.nvcc_command(src, Path("lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_rope_helpers_live_in_one_header_that_keys_the_build(tmp_path):
    """K2 and K3r take the rotation from one `rope.cuh`, and an edit to that
    header changes the build key of each source that includes it."""
    for source in ("packed_attn_fwd.cu", "packed_attn_bwd.cu"):
        text = (build.CSRC / source).read_text()
        assert '#include "rope.cuh"' in text
        assert "void rotate_pair(" not in text and "float round_to(" not in text
    (tmp_path / "rope.cuh").write_text("// v1\n")
    src = tmp_path / "k.cu"
    src.write_text('#include "rope.cuh"\n')
    key = build.source_key(src)
    assert build.source_key(src) == key
    (tmp_path / "rope.cuh").write_text("// v2\n")
    assert build.source_key(src) != key


def test_nested_headers_key_the_build(tmp_path):
    """K4/K5 and K10/K10b share `attn_rows.cuh`, which includes
    `attn_tile.cuh` (K3 includes that one too): an edit to a header that a
    source includes only through another header rebuilds the source."""
    assert build._headers(build.CSRC / "grouped_attn.cu") == ["attn_rows.cuh", "attn_tile.cuh",
                                                              "rope.cuh"]
    assert "attn_tile.cuh" in build._headers(build.CSRC / "packed_attn_bwd.cu")
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "outer.cuh"\n')
    key = build.source_key(src)
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert build.source_key(src) != key


@pytest.mark.parametrize("cwd", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, cwd):
    """No CUDA here: chip_smoke.py must exit non-zero and print no result
    line, both from the repo and as the only file of an empty directory."""
    script = ROOT / "chip_smoke.py"
    if cwd == "alone":
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, where = tmp_path / "chip_smoke.py", tmp_path
    else:
        where = ROOT
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present; the no-card path cannot be exercised")
    proc = subprocess.run([sys.executable, str(script)], cwd=where,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
