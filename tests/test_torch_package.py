"""Package rules of the PyTorch port (mrclip_tpu_torch) and its chip_smoke.py:
no JAX, CUDA by default, byte-identical copies of configs and vocab, and a
Hopper build of every kernel source."""

import filecmp
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

from mrclip_tpu_torch import export as export_cli
from mrclip_tpu_torch import serve
from mrclip_tpu_torch.factory import create_model
from mrclip_tpu_torch.ops import build
from mrclip_tpu_torch.parallel import create_optimizer, create_train_state
from mrclip_tpu_torch.serving import export_model, load_exported, save_exported
from mrclip_tpu_torch.train import main as train_main

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_IMPORTS_NO_JAX = """
import sys
for blocked in ("PIL", "pandas"):  # an import of either anywhere in the port fails loudly
    sys.modules[blocked] = None
import chip_smoke, mrclip_tpu_torch
import mrclip_tpu_torch.export, mrclip_tpu_torch.serve, mrclip_tpu_torch.ops.fused_attn
import mrclip_tpu_torch.ops.flash_attn, mrclip_tpu_torch.ops.dw_conv, mrclip_tpu_torch.models.fastvit
import mrclip_tpu_torch.ops.pallas_loss, mrclip_tpu_torch.ops.image_ops, mrclip_tpu_torch.ops.pos_embed
import mrclip_tpu_torch.models.vision, mrclip_tpu_torch.models.transformer, mrclip_tpu_torch.weights
import mrclip_tpu_torch.losses, mrclip_tpu_torch.parallel, mrclip_tpu_torch.train
import mrclip_tpu_torch.preprocessing, mrclip_tpu_torch.preprocessing.__main__
import mrclip_tpu_torch.preprocessing.synthetic, mrclip_tpu_torch.data, mrclip_tpu_torch.transforms
import mrclip_tpu_torch.checkpoint, mrclip_tpu_torch.train.loop, mrclip_tpu_torch.train.main
import mrclip_tpu_torch.parallel.optim, mrclip_tpu_torch.parallel.freeze
import mrclip_tpu_torch.train.vision_only, mrclip_tpu_torch.native
import mrclip_tpu_torch.data.native_loader
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "mrclip_tpu", "PIL", "pandas")
             and sys.modules[m] is not None)
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    """Nor PIL or pandas, which the card's machine does not have."""
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


@pytest.mark.parametrize("entry", ["create_model", "create_model EVA02-B-16",
                                   "create_model MobileCLIP-S1", "load_exported", "make_server",
                                   "serve.main", "export.main", "train", "train.main"])
def test_entry_points_need_cuda_unless_asked(no_cuda, artifact, tmp_path, entry):
    """The training path runs on its model's device, so it too stops at
    create_model without a card unless given device='cpu'."""
    calls = {
        "create_model": lambda: create_model("ViT-B-32-mini"),
        "create_model EVA02-B-16": lambda: create_model("EVA02-B-16", attn_impl="fusedp"),
        "create_model MobileCLIP-S1": lambda: create_model("MobileCLIP-S1"),
        "train": lambda: create_train_state(create_model("ViT-B-32-mini", attn_impl="fusedp"),
                                            create_optimizer(lr=1e-4)),
        "load_exported": lambda: load_exported(artifact),
        "make_server": lambda: serve.make_server(artifact, host="127.0.0.1", port=0),
        "serve.main": lambda: serve.main(["--model", artifact, "--port", "0"]),
        "export.main": lambda: export_cli.main(
            ["--model", "ViT-B-32-mini", "--output", str(tmp_path / "x.mrclip")]),
        "train.main": lambda: train_main.main(
            ["--model", "ViT-B-32-mini", "--dataset-type", "synthetic", "--logs",
             str(tmp_path / "logs")]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("rel", [
    "model_configs/ViT-B-16.json",
    "model_configs/ViT-B-32-mini.json",
    "model_configs/EVA02-B-16.json",
    "model_configs/MobileCLIP-S1.json",
    "model_configs/MobileCLIP-S2.json",
    "model_configs/ViT-B-32.json",
    "model_configs/ViT-L-14.json",
    "model_configs/ViT-L-14-336.json",
    "model_configs/ViT-H-14.json",
    "model_configs/ViT-H-14-378.json",
    "model_configs/ViT-g-14.json",
    "model_configs/ViT-bigG-14.json",
    "model_configs/ViT-B-16-plus-240.json",
    "model_configs/ViT-B-32-256.json",
    "model_configs/ViT-B-16-SigLIP.json",
    "model_configs/ViT-B-16-SigLIP-256.json",
    "model_configs/ViT-B-16-SigLIP-384.json",
    "model_configs/ViT-B-16-SigLIP-512.json",
    "model_configs/ViT-B-16-SigLIP-i18n-256.json",
    "model_configs/ViT-L-16-SigLIP-256.json",
    "model_configs/ViT-L-16-SigLIP-384.json",
    "model_configs/ViT-SO400M-14-SigLIP.json",
    "model_configs/ViT-SO400M-14-SigLIP-378.json",
    "model_configs/ViT-SO400M-14-SigLIP-384.json",
    "model_configs/ViT-SO400M-16-SigLIP-i18n-256.json",
    "model_configs/ViT-L-14-CLIPA.json",
    "model_configs/ViT-L-14-CLIPA-336.json",
    "model_configs/ViT-H-14-CLIPA.json",
    "model_configs/ViT-H-14-CLIPA-336.json",
    "model_configs/ViT-bigG-14-CLIPA.json",
    "model_configs/ViT-bigG-14-CLIPA-336.json",
    "model_configs/EVA02-E-14.json",
    "model_configs/EVA02-E-14-plus.json",
    "model_configs/EVA02-L-14.json",
    "model_configs/EVA02-L-14-336.json",
    "model_configs/EVA01-g-14.json",
    "model_configs/EVA01-g-14-plus.json",
    "assets/bpe_simple_vocab_16e6.txt.gz",
    "assets/bin_intervals_et_20_rt_20.json",
    "preprocessing/binning.py",
    "preprocessing/captions.py",
    "train/metrics.py",
])
def test_copied_files_are_byte_identical(rel):
    assert filecmp.cmp(ROOT / "mrclip_tpu" / rel, ROOT / "mrclip_tpu_torch" / rel, shallow=False)


@pytest.mark.parametrize("source,entries,tpu_kernels,includes", [
    ("packed_attn_fwd.cu", ["packed_attn_fwd", "packed_attn_rope_fwd"],
     ["fused_attn.py::_packed_fwd_kernel", "rope branch"], ["attn_mma_fwd.cuh"]),
    ("packed_attn_bwd.cu", ["packed_attn_bwd", "packed_attn_rope_bwd"],
     ["fused_attn.py::_packed_bwd_kernel", "_rope_unrotate_grad"], ["attn_mma_bwd.cuh"]),
    ("supcon_loss.cu", ["supcon_stats", "supcon_grad_q", "supcon_grad_k"],
     ["pallas_loss.py", "_fwd_kernel", "_grad_q_kernel", "_grad_k_kernel"], []),
    ("grouped_attn.cu", ["grouped_attn_fwd"], ["fused_attn.py::_fwd_kernel"],
     ["attn_mma_fwd.cuh"]),
    ("flash_attn.cu", ["flash_attn_fwd"],
     ["flash_attn.py::flash_attention_unpadded", "_flash_attention_kernel_single_batch"],
     ["attn_mma_fwd.cuh"]),
    ("dw_conv.cu", ["dw_conv_fwd", "dw_conv_bwd"],
     ["dw_conv.py::_fwd_kernel", "dw_conv.py::_bwd_kernel"], []),
    ("grouped_attn_bwd.cu", ["grouped_attn_bwd"], ["fused_attn.py::_bwd_kernel"],
     ["attn_mma_bwd.cuh"]),
    ("flash_attn_bwd.cu", ["flash_attn_bwd"],
     ["flash_attn.py::flash_attention_unpadded", "_flash_attention_dkv_kernel",
      "_flash_attention_dq_kernel"],
     ["attn_mma_bwd.cuh"]),
])
def test_kernel_source_builds_for_hopper(source, entries, tpu_kernels, includes):
    """Each source's C entry points, the TPU kernels it names, the
    tensor-core headers its bf16 kernels come from, and its nvcc line."""
    src = build.CSRC / source
    assert src.is_file()
    text = src.read_text()
    for entry in entries:
        assert f'extern "C" int {entry}(' in text
    for kernel in tpu_kernels:  # names the TPU kernel it replaces
        assert kernel in text
    for header in includes:  # bf16 on the tensor cores
        assert f'#include "{header}"' in text
    headers = "".join((build.CSRC / h).read_text() for h in build._headers(src))
    assert "cudaGetLastError()" in text + headers
    cmd = build.nvcc_command(src, Path("lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("source", ["packed_attn_fwd.cu", "grouped_attn.cu", "flash_attn.cu"])
def test_attention_forwards_reach_wgmma(source):
    """K1, K2, K4 and K10 reach the Hopper forward on wgmma: `wgmma.cuh` is
    among the headers that key their build, it emits `wgmma.mma_async`
    (m64n64k16, m64n16k16, and m64nNk16 at every wide head dim), and the one
    launcher they share routes by `fwd_route` one key block of at most 256
    keys at D = 64, with the rope (K2) or without, to `wgmma_fwd_kernel`,
    K1, K4 and K10 without the rope up to 272 keys otherwise (D = 64 past
    256 keys, 72-112) to `wgmma_wide_fwd_kernel`, and past 272 keys, not
    causal, to `wgmma_long_fwd_kernel`, whose K and V come by TMA (the
    kernels themselves run only on the card)."""
    assert "wgmma.cuh" in build._headers(build.CSRC / source)
    header = (build.CSRC / "wgmma.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in header
    assert "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16" in header
    for n in (72, 80, 88, 104, 112):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16" in header
    fwd = (build.CSRC / "attn_mma_fwd.cuh").read_text()
    route = fwd[fwd.index("inline int fwd_route("):]
    assert "if (d == kWgDim && nblk == 1 && nk <= kWgKeys) return kRouteWgmma;" in route
    assert "if (rope || d == 32) return kRouteMmaSync;" in route
    assert "if (nk <= kWideKeys) return kRouteWide;" in route
    assert "if (causal) return kRouteMmaSync;\n  return kRouteLong;" in route
    launcher = fwd[fwd.index("int launch_mma_fwd("):]
    assert "if constexpr (D == kWgDim && !MULTI) {" in launcher
    assert "if (route == kRouteWgmma)" in launcher
    assert "return launch_wgmma_fwd<FLASH, ROPE>(" in launcher
    assert "if (route == kRouteWide)" in launcher
    assert "return launch_wide_fwd<D, FLASH, MULTI>(" in launcher
    assert "if (route == kRouteLong)" in launcher
    assert "return launch_long_fwd<D, FLASH>(" in launcher
    assert "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes" in fwd
    assert "constexpr int kWgKeys = 256;" in fwd and "constexpr int kWgDim = 64;" in fwd
    assert "constexpr int kWideKeys = 272;" in fwd


# (the ids name the sources K5 and K10b lived in with their forwards)
@pytest.mark.parametrize("source,call,writes_delta", [
    ("packed_attn_bwd.cu", "launch_mma_bwd<D, false, ROPE>(", True),  # K3, K3r
    ("grouped_attn_bwd.cu", "launch_bwd<T, D, false>(", True),  # K5
    ("flash_attn_bwd.cu", "launch_bwd<T, D, true>(", False),  # K10b: di from outside
], ids=["packed_attn_bwd.cu-launch_mma_bwd<D, false, ROPE>(-True",
        "grouped_attn.cu-launch_bwd<T, D, false>(-True",
        "flash_attn.cu-launch_bwd<T, D, true>(-False"])
def test_attention_backwards_reach_wgmma(source, call, writes_delta):
    """K3, K3r, K5 and K10b reach the Hopper backward on wgmma: `wgmma.cuh`
    keys each source's build through `attn_mma_bwd.cuh`, and the launcher
    they share routes by `bwd_route`, whatever the source's FLASH flag
    (K10b's, which reads m, l and di where the others take lse and write
    delta): bf16 at D = 64 with n and nk at most 256 to `launch_wgmma_bwd`,
    without the rope and not causal past 272 rows (n or nk) to
    `launch_long_bwd` (its passes fed by TMA), up to 272 rows otherwise (D
    = 64 past 256 rows, 72-112; not where n and nk are each one 64-row
    sub-tile) to `launch_wide_bwd`. Every wgmma_bwd_* and wgmma_wide_bwd_* pass ends in a
    straight-line step of 1 to 4 groups (the wide passes 1 or 4): no TAIL =
    0 instantiation (the kernels run only on the card)."""
    assert "wgmma.cuh" in build._headers(build.CSRC / source)
    assert call in (build.CSRC / source).read_text()
    assert ("FLASH" not in call and "true" not in call.split("<")[1]) == writes_delta
    bwd = (build.CSRC / "attn_mma_bwd.cuh").read_text()
    route = bwd[bwd.index("inline int bwd_route("):]
    assert "if (d == kWgDim && n <= kWgKeys && nk <= kWgKeys) return kRouteWgmma;" in route
    assert "if (rope || causal || d == 32) return kRouteMmaSync;" in route
    assert "if (n > kWideKeys || nk > kWideKeys) return kRouteLong;" in route
    assert "if (n <= kMmaRows && nk <= kMmaRows) return kRouteMmaSync;" in route
    launcher = bwd[bwd.index("int launch_mma_bwd("):]
    assert "const int route = bwd_route(true, D, ROPE, n, nk, causal != 0);" in launcher
    assert "if constexpr (D == kWgDim) {" in launcher and "!FLASH" not in launcher
    assert "if (route == kRouteWgmma)" in launcher
    assert "return launch_wgmma_bwd<FLASH, ROPE>(" in launcher
    assert "if (route == kRouteWide)" in launcher
    assert "return launch_wide_bwd<D, FLASH>(" in launcher
    assert "if (route == kRouteLong)" in launcher
    assert "return launch_long_bwd<D, FLASH>(" in launcher
    assert bwd.count("tma_load_4d(") == 6  # K and V (dq pass); K, V, Q and dO (dk/dv pass)
    # the FLASH passes read di; only the others' dq pass writes delta
    dq_rows = bwd[bwd.index("void dq_rows("):bwd.index("void dq_walk(")]
    flash, other = dq_rows.split("} else {", 1)
    assert "delta[sb + row] =" not in flash and "delta[sb + row] = dl[i]" in other
    # with_tail's 1-4 (D = 64) and with_wide_tail's 1 and 4
    tails = re.findall(r"std::integral_constant<int, (\d+)>\(\)", bwd)
    assert sorted(map(int, tails)) == [1, 1, 2, 3, 4, 4]


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
    """K1/K2, K4/K5 and K10/K10b share `attn_mma_fwd.cuh` (the bf16
    forward, which includes `wgmma.cuh`) and `attn_rows.cuh`, which includes
    `attn_tile.cuh`; K3/K3r,
    K5 and K10b also `attn_mma_bwd.cuh` (the bf16 backward), which includes
    the forward's header: an edit to a header that a source includes only
    through another header rebuilds the source, and an edit to the
    backward's header rebuilds K3/K3r's, K5's and K10b's sources alone."""
    sources = ("packed_attn_fwd.cu", "grouped_attn.cu", "flash_attn.cu", "packed_attn_bwd.cu",
               "grouped_attn_bwd.cu", "flash_attn_bwd.cu")
    fwd_headers = ["attn_mma_fwd.cuh", "attn_rows.cuh", "attn_tile.cuh", "rope.cuh", "wgmma.cuh"]
    for source in sources[:3]:
        assert build._headers(build.CSRC / source) == fwd_headers
    for source in sources[3:]:
        assert build._headers(build.CSRC / source) == ["attn_mma_bwd.cuh", *fwd_headers]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    keys = {s: build.source_key(csrc / s) for s in sources}
    header = csrc / "attn_mma_bwd.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert [build.source_key(csrc / s) != keys[s] for s in sources] == [False] * 3 + [True] * 3
    keys = {s: build.source_key(csrc / s) for s in sources}
    header = csrc / "attn_mma_fwd.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert all(build.source_key(csrc / s) != keys[s] for s in sources)
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "outer.cuh"\n')
    key = build.source_key(src)
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert build.source_key(src) != key


def test_package_data_ships_every_included_header():
    """An installed package builds its kernels from the files its package
    data ships: every `#include "..."` of every `csrc/*.cu` and `*.cuh`
    names a file that those globs match."""
    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]["mrclip_tpu_torch"]
    pkg = build.CSRC.parent
    shipped = {p for g in globs for p in pkg.glob(g)}
    sources = sorted(build.CSRC.glob("*.cu")) + sorted(build.CSRC.glob("*.cuh"))
    assert len(sources) >= 7 and set(sources) <= shipped
    assert pkg / "assets" / "bin_intervals_et_20_rt_20.json" in shipped
    from setuptools import find_packages

    found = find_packages(str(ROOT), include=tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["packages"]["find"]["include"])
    assert {"mrclip_tpu_torch.preprocessing", "mrclip_tpu_torch.data",
            "mrclip_tpu_torch.train"} <= set(found)
    for src in sources:
        for name in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            assert build.CSRC / name in shipped, f"{src.name} includes {name}, which is not shipped"


def test_build_dir_is_the_checkout_or_the_user_cache(tmp_path):
    """Kernels build into `build/kernels/` of a checkout (a pyproject.toml
    beside the package), and into the per-user cache from an install."""
    installed = tmp_path / "site-packages" / "mrclip_tpu_torch"
    installed.mkdir(parents=True)
    assert build.build_dir(installed) == Path.home() / ".cache" / "mrclip_tpu_torch" / "kernels"
    (tmp_path / "site-packages" / "pyproject.toml").write_text("")
    assert build.build_dir(installed) == tmp_path / "site-packages" / "build" / "kernels"
    assert build.build_dir() == build.BUILD_DIR == ROOT / "build" / "kernels"


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
