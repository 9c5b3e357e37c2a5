"""The bf16 attention backward's routes on the CPU side: the route names
against the C enum `bwd_route` returns, the launch counts by route the
backward wrappers keep (`ops.launch_counts_by_route`), and the text edits
by which `chip_smoke.py` and the backward tools build the `mma.sync` route
and the design variants they time beside the committed kernels. The routes
themselves are the CUDA libraries' (`attn_bwd_route`):
tests/test_torch_cuda.py holds them on the card."""

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
CSRC = ROOT / "mrclip_tpu_torch" / "csrc"
BWD_HEADER = CSRC / "attn_mma_bwd.cuh"
FWD_HEADER = CSRC / "attn_mma_fwd.cuh"


def test_route_names_follow_the_c_enum():
    """BWD_ROUTES[i] names the route value i that `bwd_route` returns, and
    every value it returns has a name."""
    enum = re.search(r"enum FwdRoute \{([^}]*)\}", FWD_HEADER.read_text()).group(1)
    values = {name.strip(): int(v) for name, v in
              (item.split("=") for item in enum.split(","))}
    want = {"kRouteFma": "fma", "kRouteMmaSync": "mma_sync", "kRouteWgmma": "wgmma",
            "kRouteWide": "wgmma_wide", "kRouteLong": "wgmma_long"}
    for name, value in values.items():
        assert fa.BWD_ROUTES[value] == want[name]
    text = BWD_HEADER.read_text()
    body = text[text.index("inline int bwd_route("):]
    body = body[:body.index("\n}\n")]
    assert set(re.findall(r"return (kRoute\w+);", body)) == set(values)


def test_wide_route_rows_agree():
    """The card check's most rows of the wide route (`chip_smoke`'s
    WIDE_FWD_KEYS) is the header's kWideKeys, which both wide routes read."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    keys = int(re.search(r"constexpr int kWideKeys = (\d+);", FWD_HEADER.read_text()).group(1))
    assert chip_smoke.WIDE_FWD_KEYS == keys == 272
    assert "n > kWideKeys || nk > kWideKeys" in BWD_HEADER.read_text()


def _header_route(body, consts, **args):
    """The route name that the C body of `bwd_route` returns for `args`,
    its conditions read as Python over the headers' constants."""
    names = {"kRouteFma": "fma", "kRouteMmaSync": "mma_sync", "kRouteWgmma": "wgmma",
             "kRouteWide": "wgmma_wide", "kRouteLong": "wgmma_long"}
    for cond, route in re.findall(r"if \((.*)\) return (kRoute\w+);", body):
        expr = re.sub(r"!(?!=)", " not ", cond.replace("&&", " and ").replace("||", " or "))
        if eval(expr, dict(consts), dict(args)):
            return names[route]
    return names[re.search(r"\n  return (kRoute\w+);", body).group(1)]


def _bwd_route_body():
    text = BWD_HEADER.read_text()
    body = text[text.index("inline int bwd_route("):]
    return body[:body.index("\n}\n")]


def _route_consts():
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k(?:WgDim|WgKeys|WideKeys|MmaRows)) = (\d+);", FWD_HEADER.read_text())}
    assert set(consts) == {"kWgDim", "kWgKeys", "kWideKeys", "kMmaRows"}
    return consts


def _card_tests():
    import importlib.util

    spec = importlib.util.spec_from_file_location("card_tests", ROOT / "tests" / "test_torch_cuda.py")
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)
    return card_tests


def test_card_checks_mirror_the_header_route():
    """The bf16 backward route that the card tests expect (`_bwd_route_of`
    of tests/test_torch_cuda.py, the one Python copy of the rule;
    chip_smoke.py asks the built libraries) is the one the header's
    `bwd_route` returns, at every head dim and on both sides of each row
    limit: 64 (one sub-tile), 256 and 272, causal or not, with the rope or
    not."""
    card_tests = _card_tests()
    consts = _route_consts()
    body = _bwd_route_body()
    rows = (1, 17, 63, 64, 65, 200, 256, 257, 272, 273, 577, 729)
    seen = set()
    for d in fa.HEAD_DIMS:
        for n in rows:
            for nk in rows:
                for causal in (False, True):
                    for rope in (False, True):
                        want = _header_route(body, consts, bf16_in=True, d=d, rope=rope, n=n,
                                             nk=nk, causal=causal)
                        assert card_tests._bwd_route_of(d, n, nk, causal, rope) == want
                        seen.add(want)
    assert seen == {"mma_sync", "wgmma", "wgmma_wide", "wgmma_long"}
    assert _header_route(body, consts, bf16_in=False, d=80, rope=False, n=257, nk=257,
                         causal=False) == "fma"
    assert _header_route(body, consts, bf16_in=True, d=72, rope=False, n=64, nk=64,
                         causal=False) == "mma_sync"


def test_long_configs_take_the_long_backward_route():
    """At each long config's vision shape (N and D from its config:
    tests/test_torch_fwd_route.py's LONG_CONFIGS) bf16 K3, K5 and K10b take
    wgmma_long by the header's `bwd_route`, and the card tests' mirror says
    so too; causal, at D = 32 or with the rope (K3r: EVA02-L-14-336, N 577)
    the same lengths stay on mma_sync, and fp32 on the FMA kernels."""
    import importlib.util

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    spec = importlib.util.spec_from_file_location("fwd_route_tests",
                                                  ROOT / "tests" / "test_torch_fwd_route.py")
    fwd_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fwd_tests)
    body, consts, card = _bwd_route_body(), _route_consts(), _card_tests()
    assert len(fwd_tests.LONG_CONFIGS) == 10
    for name, (n, d) in fwd_tests.LONG_CONFIGS.items():
        assert chip_smoke.vision_tokens(name) == n and chip_smoke.wide_layers(name)[1] == d, name
        args = dict(bf16_in=True, d=d, rope=False, n=n, nk=n, causal=False)
        assert _header_route(body, consts, **args) == "wgmma_long", name
        assert card._bwd_route_of(d, n, n, False) == "wgmma_long", name
        for stay in (dict(causal=True), dict(d=32), dict(rope=True, d=64)):
            assert _header_route(body, consts, **{**args, **stay}) == "mma_sync", (name, stay)
        assert _header_route(body, consts, **{**args, "bf16_in": False}) == "fma"
    n = chip_smoke.vision_tokens("EVA02-L-14-336")
    assert n == 577 and chip_smoke.rope_tower("EVA02-L-14-336")
    assert _header_route(body, consts, bf16_in=True, d=64, rope=True, n=n, nk=n,
                         causal=False) == "mma_sync"


@pytest.fixture
def clean_counts():
    fa.reset_launches()
    fl.reset_launches()
    yield
    fa.reset_launches()
    fl.reset_launches()


def test_backward_counts_by_route_assemble_and_reset(clean_counts):
    """Each backward launch counted with its route shows under its kernel
    name and head dim beside the forwards'; a reset leaves none."""
    fa._count("bwd_launches", 80, "wgmma_wide")
    fa._count("bwd_launches", 80, "wgmma_wide")
    fa._count("bwd_launches", 64, "wgmma")
    fa._count("rope_bwd_launches", 64, "mma_sync")
    fa._count("grouped_bwd_launches", 112, "wgmma_wide")
    fa._count("launches", 80, "wgmma_wide")
    fl._count("bwd_launches", 72, "wgmma_wide")
    fl._count("bwd_launches", 64, "mma_sync")
    assert ops.launch_counts_by_route() == {
        "packed_attn_bwd": {80: {"wgmma_wide": 2}, 64: {"wgmma": 1}},
        "packed_attn_rope_bwd": {64: {"mma_sync": 1}},
        "grouped_attn_bwd": {112: {"wgmma_wide": 1}},
        "packed_attn_fwd": {80: {"wgmma_wide": 1}},
        "flash_attn_bwd": {72: {"wgmma_wide": 1}, 64: {"mma_sync": 1}}}
    assert ops.launch_counts_by_width()["packed_attn_bwd"] == {80: 2, 64: 1}
    fa.reset_launches()
    fl.reset_launches()
    assert ops.launch_counts_by_route() == {}


def test_cpu_backwards_count_no_route(clean_counts):
    """The backward wrappers' plain versions on the CPU launch nothing and
    ask no library for a route."""
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 17, 2, 72).astype(np.float32))
                   for _ in range(4))
    o, lse = fa.fused_attention_packed(q, k, v)
    fa.fused_attention_packed_bwd(q, k, v, o, do, lse)
    qg, kg, vg, dog = (fa.group_heads(t) for t in (q, k, v, do))
    og, lseg = fa.fused_attention_grouped(qg, kg, vg)
    fa.fused_attention_grouped_bwd(qg, kg, vg, og, dog, lseg)
    of, l, m = fl.flash_attention(q, k, v)
    fl.flash_attention_bwd(q, k, v, do, l, m, fl.flash_di(of, do))
    assert ops.launch_counts_by_route() == {} and ops.launch_counts() == {
        name: 0 for name in ops.launch_counts()}
    assert fa.bwd_route.cache_info().currsize == 0


def _variant_edits():
    """(tool, variant, header, (old, new[, count])) of every text edit that
    the card's comparison builds apply to the attention headers."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import attn_bwd_sanitize
    import attn_bwd_variants
    import attn_long_bwd_variants
    import attn_wide_bwd_variants
    import chip_smoke

    yield from (("chip_smoke", "mma_sync", BWD_HEADER, e) for e in chip_smoke.MMA_SYNC_BWD_EDITS)
    yield from (("chip_smoke", "mma_sync", FWD_HEADER, e) for e in chip_smoke.MMA_SYNC_EDITS)
    for name, (fwd_edits, bwd_edits) in attn_wide_bwd_variants.VARIANTS.items():
        yield from (("attn_wide_bwd_variants", name, FWD_HEADER, e) for e in fwd_edits)
        yield from (("attn_wide_bwd_variants", name, BWD_HEADER, e) for e in bwd_edits)
    for name, edits in attn_bwd_variants.VARIANTS.items():
        yield from (("attn_bwd_variants", name, BWD_HEADER, e) for e in edits)
    for name, edits in attn_bwd_sanitize.BUILDS.items():
        yield from (("attn_bwd_sanitize", name, BWD_HEADER, e) for e in edits)
    for name, edits in attn_long_bwd_variants.VARIANTS.items():
        yield from (("attn_long_bwd_variants", name, BWD_HEADER, e) for e in edits)


def test_variant_edits_find_their_text():
    """Every text edit of the backward's comparison builds (chip_smoke's
    `mma.sync` route, tools/attn_wide_bwd_variants.py's and
    tools/attn_long_bwd_variants.py's designs, tools/attn_bwd_variants.py's
    and tools/attn_bwd_sanitize.py's) finds its
    text in the committed header as often as it says (once by default), and
    the wide tool's `mma.sync` route is chip_smoke's."""
    edits = list(_variant_edits())
    import attn_wide_bwd_variants
    import chip_smoke

    assert attn_wide_bwd_variants.VARIANTS["mma_sync"] == (chip_smoke.MMA_SYNC_EDITS,
                                                           chip_smoke.MMA_SYNC_BWD_EDITS)
    assert len(edits) >= 20
    texts = {}
    for tool, name, header, (old, new, *count) in edits:
        text = texts.setdefault(header, header.read_text())
        assert text.count(old) == (count[0] if count else 1), (tool, name, old)
        assert old != new


def _sass(*ops):
    return "\n".join(f"        /*{16 * i:04x}*/                   {op} ;" for i, op in enumerate(ops))


@pytest.mark.parametrize("clobber", [False, True])
def test_sanitize_reads_a_wgmma_loop_around_an_mbarrier_wait(clobber):
    """tools/attn_bwd_sanitize.py's SASS reading finds the long kernels'
    tile loop, which holds the spin loop of its mbarrier wait (a nested
    backward branch that issues no wgmma), with the A operands it carries
    (four registers from the one an HGMMA names), and reports an
    instruction of the body that writes one of them after the wgmma."""
    sys.path.insert(0, str(ROOT / "tools"))
    import attn_bwd_sanitize

    body = ["MOV R1, c[0x0][0x28]", "LDG.E R152, desc[UR4][R2.64]",
            "SYNCS.PHASECHECK.TRANS64.TRYWAIT P0, [UR8], R5", "@!P0 BRA 0x20",
            "HGMMA.64x64x16.F32.BF16 R24, R152, gdesc[UR4], R24", "FADD R30, R24, R25",
            *(["MOV R154, R30"] if clobber else []), "@P1 BRA 0x20", "EXIT"]
    loops = attn_bwd_sanitize.wgmma_loops(_sass(*body))
    assert len(loops) == 1
    assert loops[0]["carried_a_registers"] == [152, 153, 154, 155]
    assert bool(loops[0]["carried_a_overwritten_by"]) == clobber
