"""The bf16 attention forward's routes on the CPU side: the launch counts by
route the wrappers keep (`ops.launch_counts_by_route`), the route names
against the C enum they index, and the text edits by which `chip_smoke.py`
and `tools/attn_wide_fwd_variants.py` build the route and the design
variants they time beside the committed kernels. The routes themselves are
the CUDA libraries' (`attn_fwd_route`): tests/test_torch_cuda.py holds them
on the card."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mrclip_tpu_torch import ops
from mrclip_tpu_torch.ops import flash_attn as fl
from mrclip_tpu_torch.ops import fused_attn as fa

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "mrclip_tpu_torch" / "csrc" / "attn_mma_fwd.cuh"


def test_route_names_follow_the_c_enum():
    """FWD_ROUTES[i] names the FwdRoute whose value is i."""
    enum = re.search(r"enum FwdRoute \{([^}]*)\}", HEADER.read_text()).group(1)
    values = {name.strip(): int(v) for name, v in
              (item.split("=") for item in enum.split(","))}
    want = {"kRouteFma": "fma", "kRouteMmaSync": "mma_sync", "kRouteWgmma": "wgmma",
            "kRouteWide": "wgmma_wide"}
    assert sorted(values.values()) == list(range(len(fa.FWD_ROUTES)))
    for name, value in values.items():
        assert fa.FWD_ROUTES[value] == want[name]


@pytest.fixture
def clean_counts():
    fa.reset_launches()
    fl.reset_launches()
    yield
    fa.reset_launches()
    fl.reset_launches()


def test_counts_by_route_assemble_and_reset(clean_counts):
    """Each forward launch counted with its route shows under its kernel
    name and head dim; the backward and a reset leave none."""
    fa._count("launches", 80, "wgmma_wide")
    fa._count("launches", 80, "wgmma_wide")
    fa._count("launches", 64, "wgmma")
    fa._count("rope_launches", 64, "mma_sync")
    fa._count("grouped_launches", 112, "wgmma_wide")
    fa._count("bwd_launches", 80)
    fl._count("launches", 72, "wgmma_wide")
    assert ops.launch_counts_by_route() == {
        "packed_attn_fwd": {80: {"wgmma_wide": 2}, 64: {"wgmma": 1}},
        "packed_attn_rope_fwd": {64: {"mma_sync": 1}},
        "grouped_attn_fwd": {112: {"wgmma_wide": 1}},
        "flash_attn_fwd": {72: {"wgmma_wide": 1}}}
    assert ops.launch_counts_by_width()["packed_attn_bwd"] == {80: 1}
    fa.reset_launches()
    fl.reset_launches()
    assert ops.launch_counts_by_route() == {}


def test_cpu_tensors_count_no_route(clean_counts):
    """The plain versions on the CPU launch nothing and ask no library for
    a route."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 17, 2, 72).astype(np.float32)) for _ in range(3))
    fa.fused_attention_packed(q, k, v)
    fl.flash_attention(q, k, v)
    fa.fused_attention_grouped(*(fa.group_heads(t) for t in (q, k, v)))
    assert ops.launch_counts_by_route() == {} and fa.fwd_route.cache_info().currsize == 0


def test_variant_edits_find_their_text():
    """Every text edit that the card's comparison builds apply to
    attn_mma_fwd.cuh (chip_smoke's mma.sync route, the variants tool's
    designs) finds its text exactly once in the committed header."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import attn_wide_fwd_variants as tool
    import chip_smoke

    text = HEADER.read_text()
    assert tool.VARIANTS["mma_sync"] == chip_smoke.MMA_SYNC_EDITS
    for name, edits in tool.VARIANTS.items():
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            assert old != new
