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
            "kRouteWide": "wgmma_wide", "kRouteLong": "wgmma_long"}
    assert sorted(values.values()) == list(range(len(fa.FWD_ROUTES)))
    for name, value in values.items():
        assert fa.FWD_ROUTES[value] == want[name]
    body = _fwd_route_body()
    assert set(re.findall(r"return (kRoute\w+);", body)) == set(values)


def _fwd_route_body():
    text = HEADER.read_text()
    body = text[text.index("inline int fwd_route("):]
    return body[:body.index("\n}\n")]


def _header_route(body, consts, **args):
    """The route name that the C body of `fwd_route` returns for `args`,
    its conditions read as Python over the header's constants."""
    names = {"kRouteFma": "fma", "kRouteMmaSync": "mma_sync", "kRouteWgmma": "wgmma",
             "kRouteWide": "wgmma_wide", "kRouteLong": "wgmma_long"}
    for cond, route in re.findall(r"if \((.*)\) return (kRoute\w+);", body):
        expr = re.sub(r"!(?!=)", " not ", cond.replace("&&", " and ").replace("||", " or "))
        if eval(expr, dict(consts), dict(args)):
            return names[route]
    return names[re.search(r"\n  return (kRoute\w+);", body).group(1)]


def _card_tests():
    import importlib.util

    spec = importlib.util.spec_from_file_location("card_tests", ROOT / "tests" / "test_torch_cuda.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The configs whose vision tower runs past the wide kernel's 272 keys, with
# (N, D): 16- and 14-px patches of 336-512 px images, a class token except
# in the timm SigLIP towers
LONG_CONFIGS = {"ViT-B-16-SigLIP-384": (576, 64), "ViT-L-16-SigLIP-384": (576, 64),
                "ViT-B-16-SigLIP-512": (1024, 64), "ViT-SO400M-14-SigLIP-378": (729, 72),
                "ViT-SO400M-14-SigLIP-384": (729, 72), "ViT-H-14-378": (730, 80),
                "ViT-H-14-CLIPA-336": (577, 80), "ViT-L-14-336": (577, 64),
                "ViT-L-14-CLIPA-336": (577, 64), "ViT-bigG-14-CLIPA-336": (577, 104)}


def test_long_configs_take_the_long_route():
    """At each long config's vision shape (N and D from its config) bf16 K1,
    K4 and K10 take wgmma_long by the header's `fwd_route`, and the card
    tests' mirror (`_fwd_route_of`) says so too; causal, at D = 32 or with
    the rope (K2: EVA02-L-14-336, N 577) the same lengths stay on mma_sync,
    and fp32 on the FMA kernels."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k(?:WgDim|WgKeys|WideKeys)) = (\d+);", HEADER.read_text())}
    body, card = _fwd_route_body(), _card_tests()
    for name, (n, d) in LONG_CONFIGS.items():
        assert chip_smoke.vision_tokens(name) == n, name
        assert chip_smoke.wide_layers(name)[1] == d, name
        for nblk in (1, fl._blocks(n, n)[2]):  # K1 and K4; K10 over jax's blocks
            args = dict(bf16_in=True, d=d, rope=False, nk=n, nblk=nblk, causal=False)
            assert _header_route(body, consts, **args) == "wgmma_long", name
            assert card._fwd_route_of(d, n, nblk) == "wgmma_long"
            for stay in (dict(causal=True), dict(d=32), dict(rope=True, d=64)):
                assert _header_route(body, consts, **{**args, **stay}) == "mma_sync", (name, stay)
            assert _header_route(body, consts, **{**args, "bf16_in": False}) == "fma"
    assert chip_smoke.wide_layers("EVA02-L-14-336")[1] == 64 and chip_smoke.rope_tower(
        "EVA02-L-14-336")


def test_card_checks_mirror_the_header_route():
    """The bf16 forward route that the card tests expect (`_fwd_route_of`,
    the one Python copy of the rule) is the one the header's `fwd_route` returns at every head dim, on both sides of
    256 and 272 keys, over one key block or jax's several, causal or not,
    with the rope or not."""
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k(?:WgDim|WgKeys|WideKeys)) = (\d+);", HEADER.read_text())}
    assert set(consts) == {"kWgDim", "kWgKeys", "kWideKeys"}
    body, card = _fwd_route_body(), _card_tests()
    seen = set()
    for d in fa.HEAD_DIMS:
        for nk in (1, 64, 200, 256, 257, 272, 273, 320, 511, 577, 729, 1024):
            for nblk in {1, fl._blocks(nk, nk)[2]}:
                for causal in (False, True):
                    for rope in (False, True):
                        want = _header_route(body, consts, bf16_in=True, d=d, rope=rope, nk=nk,
                                             nblk=nblk, causal=causal)
                        assert card._fwd_route_of(d, nk, nblk, causal, rope) == want
                        seen.add(want)
    assert seen == {"mma_sync", "wgmma", "wgmma_wide", "wgmma_long"}


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
    fa._count("launches", 72, "wgmma_long")
    fa._count("grouped_launches", 104, "wgmma_long")
    fl._count("launches", 72, "wgmma_long")
    fl._count("launches", 64, "mma_sync")
    assert ops.launch_counts_by_route() == {
        "packed_attn_fwd": {80: {"wgmma_wide": 2}, 64: {"wgmma": 1}, 72: {"wgmma_long": 1}},
        "packed_attn_rope_fwd": {64: {"mma_sync": 1}},
        "grouped_attn_fwd": {112: {"wgmma_wide": 1}, 104: {"wgmma_long": 1}},
        "flash_attn_fwd": {72: {"wgmma_wide": 1, "wgmma_long": 1}, 64: {"mma_sync": 1}}}
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
    attn_mma_fwd.cuh (chip_smoke's mma.sync route, which cuts the wide and
    the long routes; the two variants tools' designs) finds its text
    exactly once in the committed header."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import attn_long_fwd_variants as long_tool
    import attn_wide_fwd_variants as tool
    import chip_smoke

    text = HEADER.read_text()
    assert tool.VARIANTS["mma_sync"] == long_tool.VARIANTS["mma_sync"] == chip_smoke.MMA_SYNC_EDITS
    assert any("kRouteLong" in old for old, _ in chip_smoke.MMA_SYNC_EDITS)
    for name, edits in [*tool.VARIANTS.items(), *long_tool.VARIANTS.items()]:
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            assert old != new
    assert set(long_tool.SHAPES) >= {f"{label}_b32" for label in chip_smoke.LONG_SHAPES}
