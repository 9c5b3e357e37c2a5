"""The port's depthwise convolution (mrclip_tpu_torch.ops.dw_conv: plain
versions of K8 and K9, `DwConv`, `dw_conv`) and `DepthwiseConv` against the
JAX package's Pallas `dw_conv` in interpret mode and its XLA convolution.

On the CPU the kernel wrappers run their plain versions and count no
launch; the kernels themselves are held against the plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py). Inputs come from numpy
seeds; the JAX test's shapes (tests/test_dw_conv.py) and tolerances: fp32
forward 1e-5, gradients 1e-4. The kernels' work split (`dw_conv.plan`: tile,
copy width, K9's dw partition) is Python, so its coverage is checked here on
every shape chip_smoke.py holds the kernels at.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mrclip_tpu.ops.dw_conv as jax_dw
from mrclip_tpu.models.layers import DepthwiseConv as JaxDepthwiseConv
from mrclip_tpu_torch.models.layers import DepthwiseConv
from mrclip_tpu_torch.ops import dw_conv as dc

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def _xla_dw(x, kernel):
    return jax.lax.conv_general_dilated(
        x, kernel, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=kernel.shape[3])


def _inputs(b, h, w, c, k, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    kern = (rng.randn(k, k, 1, c) * 0.2).astype(np.float32)  # JAX HWIO
    dy = rng.randn(b, h, w, c).astype(np.float32)
    return x, kern, dy


def _weight(kern):
    """JAX [K, K, 1, C] -> the port's [C, 1, K, K]."""
    return torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))


def _table(kern):
    return torch.from_numpy(kern.reshape(-1, kern.shape[3]).copy())


def _port_grads(x, kern, dy, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = _weight(kern).requires_grad_()
    y = dc.dw_conv(xt, wt)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy).to(dtype))
    return y.detach(), gx, gw


def _jax_kernel(x, kern):
    return jax_dw.dw_conv(jnp.asarray(x), jnp.asarray(kern), interpret=True)


def _jax_grads(x, kern, dy, fn):
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(kern))
    gx, gk = vjp(jnp.asarray(dy))
    return y, gx, gk


@pytest.mark.parametrize("k,h,w,c", [(3, 8, 8, 16), (7, 12, 10, 8), (5, 9, 9, 4)])
def test_plain_forward_matches_jax_kernel(k, h, w, c):
    x, kern, _ = _inputs(2, h, w, c, k, 0)
    want = np.asarray(_jax_kernel(x, kern))
    got = dc.dw_conv_fwd_ref(torch.from_numpy(x), _table(kern))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the function built from the [C, 1, K, K] weight gives the same
    torch.testing.assert_close(dc.dw_conv(torch.from_numpy(x), _weight(kern)), got, rtol=0, atol=0)


@pytest.mark.parametrize("k", [3, 7])
def test_plain_gradients_match_jax_kernel(k):
    """dx and dw through `DwConv` (the plain K9 on the CPU) against jax.vjp
    of the interpret-mode kernel, fp32, 1e-4."""
    x, kern, dy = _inputs(2, 10, 10, 8, k, 1)
    _, gx_j, gk_j = _jax_grads(x, kern, dy, _jax_kernel)
    _, gx, gw = _port_grads(x, kern, dy)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gw.numpy().transpose(2, 3, 1, 0), np.asarray(gk_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("k", [3, 7])
def test_plain_versions_match_jax_kernel_in_bf16(k):
    """bf16 in and out: both accumulate the rounded-up bf16 inputs in fp32 and
    round once, so y and dx agree within one bf16 ulp of their largest
    value, and the fp32 dw within 1e-4 of its largest (fp32 sums in another
    order); dy is rounded to bf16 first on both sides."""
    x, kern, dy = _inputs(2, 9, 13, 8, k, 2)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_j, gx_j, gk_j = _jax_grads(xb, kern, jnp.asarray(dy, jnp.bfloat16), _jax_kernel)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    y = dc.dw_conv_fwd_ref(xt, _table(kern))
    gx, dw = dc.dw_conv_bwd_ref(xt, _table(kern), torch.from_numpy(dy))
    assert y.dtype == gx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for got, want in ((y, y_j), (gx, gx_j)):
        want = np.asarray(want, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got.float().numpy() - want).max() <= ulp
    want_dw = np.asarray(gk_j, np.float32).reshape(k * k, -1)
    assert np.abs(dw.numpy() - want_dw).max() <= 1e-4 * np.abs(want_dw).max()


def test_function_matches_plain_backward_and_launches_nothing_on_the_cpu():
    x, kern, dy = _inputs(2, 7, 6, 12, 3, 3)
    dc.reset_launches()
    y, gx, gw = _port_grads(x, kern, dy)
    want_dx, want_dw = dc.dw_conv_bwd_ref(torch.from_numpy(x), _table(kern), torch.from_numpy(dy))
    torch.testing.assert_close(gx, want_dx, rtol=0, atol=0)
    torch.testing.assert_close(gw, want_dw.t().reshape(12, 1, 3, 3), rtol=0, atol=0)
    assert dc.launches == {"dw_conv_fwd": 0, "dw_conv_bwd": 0}


def test_function_passes_gradcheck_in_float64():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 5, 4, 3)).requires_grad_()
    w = torch.from_numpy(rng.randn(3, 1, 3, 3)).requires_grad_()
    assert torch.autograd.gradcheck(dc.dw_conv, (x, w), fast_mode=True)


@pytest.mark.parametrize("h,w,k", [(2, 2, 7), (3, 5, 7), (1, 4, 3), (4, 2, 5)])
def test_any_image_size_matches_xla_where_the_jax_kernel_raises(h, w, k):
    """H or W at most K//2 (MCi1's 7 x 7 CPE on the 2 x 2 map of a 64 px
    image): the JAX kernel's static slices run out of bounds, the port's
    plain versions skip the taps that reach no output, as SAME zero padding
    does; forward and both gradients against XLA's convolution."""
    x, kern, dy = _inputs(2, h, w, 6, k, 5)
    with pytest.raises(Exception):
        jax_dw.dw_conv(jnp.asarray(x), jnp.asarray(kern), interpret=True)
    y_j, gx_j, gk_j = _jax_grads(x, kern, dy, _xla_dw)
    y, gx, gw = _port_grads(x, kern, dy)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gw.numpy().transpose(2, 3, 1, 0), np.asarray(gk_j), rtol=1e-4,
                               atol=1e-4)


def test_wrappers_refuse_other_devices_and_bad_weights():
    """Only a CPU tensor reaches the plain versions; `dw_conv` takes an odd
    square [C, 1, K, K] depthwise weight only (stride is no argument: the
    stride-2 convolutions stay `F.conv2d`)."""
    meta, tab = torch.empty(1, 8, 8, 4, device="meta"), torch.empty(9, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dc.dw_conv_fwd(meta, tab)
    with pytest.raises(ValueError, match="unsupported device"):
        dc.dw_conv_bwd(meta, tab, meta)
    x = torch.zeros(1, 8, 8, 4)
    for shape in [(4, 1, 4, 4), (4, 1, 3, 5), (4, 2, 3, 3), (5, 1, 3, 3)]:
        with pytest.raises(ValueError, match="weight"):
            dc.dw_conv(x, torch.zeros(shape))
    with pytest.raises(ValueError, match="K odd"):
        dc.dw_conv_fwd_ref(x, torch.zeros(8, 4))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_module_matches_jax_module(monkeypatch, impl):
    """`DepthwiseConv` against the JAX package's under the same
    `MRCLIP_DW_IMPL`, its [K, K, 1, C] kernel and bias carried over; the
    choice is read when the port's module is built. The JAX module takes its
    kernel only on one device, so the test shows it one."""
    monkeypatch.setenv("MRCLIP_DW_IMPL", impl)
    monkeypatch.setattr(jax, "device_count", lambda *a, **kw: 1)
    calls = []
    real = jax_dw.dw_conv
    monkeypatch.setattr(jax_dw, "dw_conv", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x, kern, _ = _inputs(2, 8, 8, 16, 7, 6)
    bias = np.random.RandomState(7).randn(16).astype(np.float32)
    want = JaxDepthwiseConv(16, 7).apply({"params": {"kernel": kern, "bias": bias}}, jnp.asarray(x))
    assert len(calls) == (impl == "pallas")
    mod = DepthwiseConv(16, 7)
    assert mod.impl == impl and f"impl={impl!r}" in repr(mod)
    mod.load_state_dict({"weight": _weight(kern), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# Every shape the card holds the kernels at (chip_smoke.py: the stage shapes
# at b32 and b256, the edges, the misaligned views), as (B, H, W, C, K)
PLAN_SHAPES = sorted({(b, *shape) for shape, _ in chip_smoke.DW_STAGES for b in (2, 32, 256)}
                     | set(chip_smoke.DW_EDGES) | set(chip_smoke.DW_OFFSET_VIEWS))


def _runs(p, backward):
    """The tiles each block of a channel slice takes: one each (K8), or a
    run of per_part (K9); every tile once, no K9 block without a tile."""
    if backward:
        runs = [range(part * p.per_part, min(p.tiles, (part + 1) * p.per_part))
                for part in range(p.parts)]
        assert all(len(run) > 0 for run in runs), "a K9 block without a tile"
    else:
        runs = [range(t, t + 1) for t in range(p.tiles)]
    assert [t for run in runs for t in run] == list(range(p.tiles))
    return runs


def _cover(p, b, h, w, c, backward):
    """How often the kernels write each output (b, row, column, channel)
    under plan `p`, by csrc/dw_conv.cu's index math: the blocks (tile, slice)
    of K8, or (part, slice) of K9 walking tiles [part * per_part, ...); a
    tile's origin from its index (`tile_origin`); its 8 warps taking the
    (row, strip) items in turn, a strip 8 outputs, 32 lanes a channel pair
    each; writes past H, W or C dropped. K9's dw visits the same positions."""
    count = np.zeros((b, h, w, c), np.uint8)
    tiles_h, tiles_w = -(-h // p.th), -(-w // p.tw)
    runs = _runs(p, backward)
    ns = p.tw // dc.STRIP
    items = sorted(it for warp in range(8) for it in range(warp, p.th * ns, 8))
    assert items == list(range(p.th * ns))
    for ch0 in range(0, p.slices * dc.TILE_C, dc.TILE_C):
        chans = [ch for lane in range(32) for ch in (ch0 + 2 * lane, ch0 + 2 * lane + 1) if ch < c]
        assert chans == list(range(ch0, min(c, ch0 + dc.TILE_C)))
        for run in runs:
            for t in run:
                bi, rest = divmod(t, tiles_h * tiles_w)
                ty, tx = divmod(rest, tiles_w)
                for it in items:
                    r, s = divmod(it, ns)
                    q0 = tx * p.tw + s * dc.STRIP
                    count[bi, ty * p.th + r:ty * p.th + r + 1, q0:q0 + dc.STRIP,
                          ch0:ch0 + dc.TILE_C] += 1
    return count


@pytest.mark.parametrize("b,h,w,c,k", PLAN_SHAPES)
def test_plan_covers_every_output_once(b, h, w, c, k):
    """K8's and K9's work split, bf16 and fp32: every output element written
    once, every K9 block with a tile, the block's shared memory in the budget
    that lets two blocks share an SM, and about _DW_BLOCKS K9 blocks where
    there are as many tiles."""
    for itemsize in (2, 4):
        for backward in (False, True):
            p = dc.plan(b, h, w, c, k, itemsize, backward)
            assert p.smem == dc.smem_bytes(k, itemsize, p.th, p.tw, backward)
            assert p.smem <= dc.SMEM_BUDGET[backward]
            assert p.tw % dc.STRIP == 0 and p.tiles == b * -(-h // p.th) * -(-w // p.tw)
            assert p.slices * dc.TILE_C >= c > (p.slices - 1) * dc.TILE_C
            _runs(p, backward)
            if b * h * w * c <= 2**24:
                assert (_cover(p, b, h, w, c, backward) == 1).all()
            if backward:
                assert p.parts * p.per_part >= p.tiles > (p.parts - 1) * p.per_part
                assert p.parts * p.slices <= dc._DW_BLOCKS + p.slices
                assert p.parts == p.tiles or p.parts * p.slices * 2 >= dc._DW_BLOCKS


def test_plan_takes_narrow_copies_for_odd_c_and_misaligned_views():
    """16-byte copies only where C is a multiple of 16 bytes' elements and
    every tensor of the call is 16-byte aligned; else the element-wise
    kernels (still the kernels, never the plain version)."""
    assert dc.plan(2, 9, 33, 64, 7, 2).wide and dc.plan(2, 9, 33, 64, 7, 4, True).wide
    for c, itemsize in ((33, 2), (33, 4), (100, 2), (6, 4), (12, 2)):
        assert not dc.plan(2, 9, 33, c, 7, itemsize).wide
        assert not dc.plan(2, 9, 33, c, 7, itemsize, True).wide
    assert dc.plan(2, 9, 33, 100, 7, 4).wide  # 100 fp32 channels: 25 copies a pixel
    assert not dc.plan(2, 9, 33, 64, 7, 2, aligned=False).wide
    for dtype in (torch.bfloat16, torch.float32):
        base = torch.zeros(2 * 9 * 33 * 64 + 1, dtype=dtype)
        view = base[1:].view(2, 9, 33, 64)
        assert view.is_contiguous() and view.storage_offset() == 1
        assert not dc._plan_for(view, 7, torch.zeros_like(view)).wide
        assert dc._plan_for(base[:-1].view(2, 9, 33, 64), 7).wide


@pytest.mark.parametrize("b,h,w,c,k", [(1, 9, 33, 33, 7), (2, 17, 17, 33, 3), (1, 9, 33, 64, 5),
                                       (1, 17, 17, 33, 7)])
def test_plain_versions_match_jax_kernel_past_a_tile(b, h, w, c, k):
    """At an odd C and at maps one larger than the kernels' tiles (16 x 16
    in bf16, 4 or 8 rows in fp32): the plain versions the card holds the
    kernels to against the JAX kernel in interpret mode, forward and both
    gradients, fp32."""
    x, kern, dy = _inputs(b, h, w, c, k, 8)
    y_j, gx_j, gk_j = _jax_grads(x, kern, dy, _jax_kernel)
    y = dc.dw_conv_fwd_ref(torch.from_numpy(x), _table(kern))
    gx, dw = dc.dw_conv_bwd_ref(torch.from_numpy(x), _table(kern), torch.from_numpy(dy))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gk_j).reshape(k * k, c), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("tile,dw_blocks", [((8, 16), 512), ((8, 32), 512), (None, 1024),
                                            (None, 2048)])
def test_plan_overrides_cover_every_output_once(tile, dw_blocks):
    """`plan`'s overrides (a starting tile, K9's dw blocks), as the design
    sweep of tools/dw_conv_variants.py takes them: each output still once,
    the block in the budget, the tile no larger than asked."""
    for b, h, w, c, k in [(2, 17, 33, 100, 7), (2, 9, 13, 64, 3), (32, 16, 16, 256, 7)]:
        for itemsize in (2, 4):
            for backward in (False, True):
                p = dc.plan(b, h, w, c, k, itemsize, backward, tile=tile, dw_blocks=dw_blocks)
                assert p.smem <= dc.SMEM_BUDGET[backward]
                if tile is not None:
                    assert p.th <= tile[0] and p.tw <= tile[1]
                assert (_cover(p, b, h, w, c, backward) == 1).all()
                if backward:
                    assert p.parts * p.slices <= dw_blocks + p.slices
