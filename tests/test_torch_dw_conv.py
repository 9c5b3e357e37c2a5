"""The port's depthwise convolution (mrclip_tpu_torch.ops.dw_conv: plain
versions of K8 and K9, `DwConv`, `dw_conv`) and `DepthwiseConv` against the
JAX package's Pallas `dw_conv` in interpret mode and its XLA convolution.

On the CPU the kernel wrappers run their plain versions and count no
launch; the kernels themselves are held against the plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py). Inputs come from numpy
seeds; the JAX test's shapes (tests/test_dw_conv.py) and tolerances: fp32
forward 1e-5, gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
