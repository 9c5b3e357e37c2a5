"""MobileCLIP-S1 in the port (mrclip_tpu_torch: the FastViT/MCi tower,
`MRCLIP_DW_IMPL`, the weights, the train step and the artifact) against the
JAX package, on the same weights.

JAX params cross over through `state_dict_from_flax` and load with
`strict=True`; the same numpy-seeded inputs go through both sides in fp32 on
the CPU. Sizes are cut through the FASTVIT_DIMS entry of `fastvit_mci1`,
patched alike in both packages: the JAX test's narrow widths (8, 16, 32, 64)
at 128 x 128 px where the JAX side runs its Pallas kernel (interpret mode;
its static slices need every map wider than K//2, so not at 64 px), and
MCi1's full widths (64 to 512) at a cut depth on 64 x 64 px under XLA's
convolution. The text tower is cut to one narrow layer. The JAX package
takes its kernel only on one device, so the tests that want it show it one
(`jax.device_count` patched) and count its calls.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrclip_tpu.models.fastvit as jax_fastvit
import mrclip_tpu.ops.dw_conv as jax_dw
from mrclip_tpu.factory import create_loss as jax_create_loss
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu.parallel.train_step import _wd_mask as jax_wd_mask
from mrclip_tpu_torch import create_loss, create_model, state_dict_from_flax
from mrclip_tpu_torch.factory import get_model_config, model_from_config
from mrclip_tpu_torch.models import fastvit
from mrclip_tpu_torch.models.fastvit import Conv2d
from mrclip_tpu_torch.models.layers import DepthwiseConv
from mrclip_tpu_torch.ops import dw_conv as dc
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                       make_loss_apply)
from mrclip_tpu_torch.parallel.train_step import _wd_mask, loss_and_grads
from mrclip_tpu_torch.serving import export_model, load_exported, save_exported

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TEXT_CFG = dict(context_length=16, vocab_size=49408, width=64, heads=2, layers=1)
# tests/test_mobileclip.py's widths; one RepMixer block (3x3, 7x7) and the CPE
NARROW = ((1, 0, 0, 1), (8, 16, 32, 64), 3.0)
CUT = ((2, 2, 2, 1), (64, 128, 256, 512), 3.0)  # MCi1's widths, cut depth


def _use_dims(mp, dims):
    mp.setitem(jax_fastvit.FASTVIT_DIMS, "fastvit_mci1", dims)
    mp.setitem(fastvit.FASTVIT_DIMS, "fastvit_mci1", dims)


def _vision(size):
    return dict(get_model_config("MobileCLIP-S1")["vision_cfg"], image_size=size)


def _batch(size, n=2, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    tokens = rng.randint(1, 49408, (n, 16)).astype(np.int32)
    return images, tokens, np.arange(n, dtype=np.int32) % 3  # repeated labels


def _jax_model(size, scan_layers=False):
    jm, _ = jax_create_model("MobileCLIP-S1", init_params=False, scan_layers=scan_layers,
                             attn_impl="xla", vision_cfg=_vision(size), text_cfg=TEXT_CFG)
    return jm


def _params(jm, size, seed=1):
    """Seeded numpy params of the JAX model's tree at its initialisers'
    scales (norm and RepMixer scales near 1, biases near 0, kernels and
    projections normal with std fan_in^-0.5), every leaf off its initial
    value so each one counts."""
    images, tokens, _ = _batch(size)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), images, tokens))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['logit_scale']"):
            return np.float32(np.log(1 / 0.07))
        base = 1.0 if name.endswith(("['scale']", "['mixer_scale']")) else 0.0
        std = np.prod(shape[:-1]) ** -0.5 if len(shape) >= 2 else 0.05
        return np.asarray(base + std * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(params, size, **kw):
    return create_model("MobileCLIP-S1", pretrained=state_dict_from_flax(params), device="cpu",
                        vision_cfg=_vision(size), text_cfg=TEXT_CFG, **kw)


def _jax_kernel_calls(mp):
    """Show JAX one device (its DepthwiseConv then takes the kernel) and
    count the traced calls of its Pallas `dw_conv`."""
    mp.setattr(jax, "device_count", lambda *a, **kw: 1)
    calls, real = [], jax_dw.dw_conv
    mp.setattr(jax_dw, "dw_conv", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def _features(jm, params, images, tokens):
    # a fresh function per call: the traced convolution depends on MRCLIP_DW_IMPL
    out = jax.jit(lambda p: jm.apply({"params": p}, jax_normalize(images), tokens))(params)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_features(model, images, tokens):
    with torch.no_grad():
        out = model(normalize_images(torch.from_numpy(images)), torch.from_numpy(tokens))
    return {k: v.numpy() for k, v in out.items()}


def _impls(model):
    return {m.impl for m in model.modules() if isinstance(m, DepthwiseConv)}


@pytest.fixture(scope="module")
def narrow():
    """(JAX module, params) of the narrow MobileCLIP-S1 at 128 px; its
    image tower has one RepMixer block (a 3x3 and a 7x7 depthwise
    convolution) and the CPE (7x7 on the 4 x 4 map)."""
    with pytest.MonkeyPatch.context() as mp:
        _use_dims(mp, NARROW)
        jm = _jax_model(128)
        return jm, _params(jm, 128)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_narrow_clip_matches_jax_under_the_same_impl(monkeypatch, narrow, impl):
    """The narrow MobileCLIP-S1 under the same MRCLIP_DW_IMPL on both
    sides: the JAX Pallas kernel in interpret mode and the port's plain K8
    ('pallas'), or both convolutions ('xla'); fp32 features to 1e-4."""
    jm, params = narrow
    _use_dims(monkeypatch, NARROW)
    images, tokens, _ = _batch(128)
    monkeypatch.setenv("MRCLIP_DW_IMPL", impl)
    calls = _jax_kernel_calls(monkeypatch)
    want = _features(jm, params, images, tokens)
    assert len(calls) == (3 if impl == "pallas" else 0)
    model = _port(params, 128)
    assert _impls(model) == {impl}
    got = _port_features(model, images, tokens)
    for key in ("image_features", "text_features"):
        assert got[key].shape == want[key].shape == (2, 512)
        assert np.abs(got[key] - want[key]).max() < 1e-4, key


@pytest.fixture(scope="module")
def cut():
    """(JAX params, JAX features under XLA's convolution) of MCi1 at full
    widths, depths (2, 2, 2, 1), on 64 x 64 px."""
    with pytest.MonkeyPatch.context() as mp:
        _use_dims(mp, CUT)
        mp.setenv("MRCLIP_DW_IMPL", "xla")
        jm = _jax_model(64)
        params = _params(jm, 64)
        images, tokens, _ = _batch(64)
        return params, _features(jm, params, images, tokens)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_full_width_mci1_matches_jax(monkeypatch, cut, impl):
    """MCi1 at its full widths against JAX under XLA's convolution, fp32
    features to 1e-4. At 64 px the CPE is a 7 x 7 convolution on a 2 x 2
    map, where the JAX kernel raises: the port's 'pallas' path (plain K8
    here) takes it, as SAME padding does."""
    params, want = cut
    _use_dims(monkeypatch, CUT)
    monkeypatch.setenv("MRCLIP_DW_IMPL", impl)
    model = _port(params, 64)
    assert _impls(model) == {impl}
    images, tokens, _ = _batch(64)
    got = _port_features(model, images, tokens)
    for key in ("image_features", "text_features"):
        assert np.abs(got[key] - want[key]).max() < 1e-4, key


def test_two_train_steps_match_jax_under_pallas(monkeypatch, narrow):
    """Two fp32 dense-loss steps (AdamW lr 1e-4, wd 0.2, bf16 first moment,
    as tests/test_torch_train_step.py) of a narrow MobileCLIP-S1 at 128 px
    under 'pallas' on both sides: the JAX kernel's custom VJP in interpret
    mode, the port's DwConv with the plain K8/K9. Loss and grad norm per
    step to 1e-5 relative, parameters after the steps to 2e-5."""
    jm, params = narrow
    _use_dims(monkeypatch, NARROW)
    images, tokens, labels = _batch(128, n=8, seed=2)
    monkeypatch.setenv("MRCLIP_DW_IMPL", "pallas")
    calls = _jax_kernel_calls(monkeypatch)
    args = SimpleNamespace(multipositiveloss=True, delta=0.5, pallas_loss=False,
                           model="MobileCLIP-S1", gather_with_grad=True)
    tx = jax_create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = jax_create_train_state({"params": params}, tx)
    jax_apply = jax_make_loss_apply(jax_create_loss(args))
    step = jax_build_train_step(jm, jax_apply, tx, donate=False)
    jb = {"images": jax_normalize(jnp.asarray(images)), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}
    jax_metrics = []
    for i in range(2):
        state, m = step(state, jb, jax.random.key(i))
        jax_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    assert len(calls) == 3  # traced once: mixer 3x3, FFN 7x7, CPE 7x7
    jax_params = state_dict_from_flax(jax.device_get(state.params))

    model = _port(params, 128)
    assert _impls(model) == {"pallas"}
    ptx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    pstate = create_train_state(model, ptx)
    pstep = build_train_step(model, make_loss_apply(create_loss(args)), ptx)
    pb = {"images": normalize_images(torch.from_numpy(images)),
          "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    port_metrics = []
    for _ in range(2):
        pstate, m = pstep(pstate, pb)
        port_metrics.append((m["loss"].item(), m["grad_norm"].item()))
    for (jl, jn), (pl_, pn) in zip(jax_metrics, port_metrics):
        np.testing.assert_allclose(pl_, jl, rtol=1e-5)
        np.testing.assert_allclose(pn, jn, rtol=1e-5)
    assert set(pstate.params) == set(jax_params)
    for name, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_params[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)


def test_full_depth_mci1_runs_the_kernels_73_times(monkeypatch):
    """MobileCLIP-S1's image tower at full widths and depth under 'pallas':
    73 stride-1 depthwise convolutions (36 RepMixer blocks x 2, the CPE),
    each through the K8 wrapper once forward and the K9 wrapper once
    backward; the stem and the three stride-2 downsamples stay F.conv2d.
    On the CPU the wrappers run their plain versions and count no launch."""
    monkeypatch.setenv("MRCLIP_DW_IMPL", "pallas")
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "dw_conv_fwd"), ("bwd", "dw_conv_bwd")):
        real = getattr(dc, name)
        monkeypatch.setattr(dc, name, lambda *a, _r=real, _k=key: calls.__setitem__(
            _k, calls[_k] + 1) or _r(*a))
    visual = create_model("MobileCLIP-S1", device="cpu", vision_cfg=_vision(64)).visual
    assert sum(isinstance(m, DepthwiseConv) for m in visual.modules()) == 73
    assert sum(isinstance(m, Conv2d) for m in visual.modules()) == 5
    dc.reset_launches()
    images = torch.from_numpy(np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32))
    visual(images).square().sum().backward()
    assert calls == {"fwd": 73, "bwd": 73}
    assert dc.launches == {"dw_conv_fwd": 0, "dw_conv_bwd": 0}
    for name, p in visual.named_parameters():
        if name.endswith(("mixer_dw.weight", "ffn.conv_dw.weight", "pos_emb_dw.weight")):
            assert p.grad.abs().max() > 0, name


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
def test_state_dict_from_flax(monkeypatch, layout):
    """Both layouts of the attention stage (`blocks/block` stacked, or
    `blocks_N`) convert to the same state dict, every key one the port's
    module holds; convolutions HWIO -> [out, in / groups, K, K], Dense
    kernels transposed, `mixer_scale` and `proj` as they are."""
    _use_dims(monkeypatch, NARROW)
    params = _params(_jax_model(128), 128, seed=4)
    if layout == "scanned":  # each tower's blocks_N stacked on a leading layer axis
        def stack(tower):
            tr = tower["transformer"]
            blocks = [tr[k] for k in sorted(tr, key=lambda k: int(k.split("_")[-1]))]
            return dict(tower, transformer={"blocks": {"block": jax.tree.map(
                lambda *xs: np.stack(xs), *blocks)}})

        params = dict(params, visual=stack(params["visual"]), text=stack(params["text"]))
        images, tokens, _ = _batch(128)
        scanned = jax.eval_shape(lambda: _jax_model(128, scan_layers=True).init(
            jax.random.key(0), images, tokens))["params"]
        assert jax.tree.structure(params) == jax.tree.structure(scanned)
    sd = state_dict_from_flax(params)
    model = model_from_config(dict(get_model_config("MobileCLIP-S1"), vision_cfg=_vision(128),
                                   text_cfg=TEXT_CFG))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    vis = params["visual"]
    blk = vis["stage0_block0"]
    np.testing.assert_array_equal(sd["visual.stage0_block0.mixer_dw.weight"].numpy(),
                                  blk["mixer_dw"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["visual.stage0_block0.mixer_scale"].numpy(), blk["mixer_scale"])
    np.testing.assert_array_equal(sd["visual.stem_conv2.weight"].numpy(),
                                  vis["stem_conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["visual.downsample1.conv_pw.weight"].numpy(),
                                  vis["downsample1"]["conv_pw"]["kernel"].T)
    np.testing.assert_array_equal(sd["visual.head_norm.weight"].numpy(), vis["head_norm"]["scale"])
    np.testing.assert_array_equal(sd["visual.proj"].numpy(), vis["proj"])
    assert sd["visual.transformer.resblocks.0.attn.in_proj_weight"].shape == (192, 64)


def test_wd_mask_matches_jax(monkeypatch):
    """Parameter for parameter through the weight mapping, against JAX's
    mask of the unrolled tree: convolution and dense weights decay, biases,
    norms and `mixer_scale` do not."""
    _use_dims(monkeypatch, NARROW)
    params = _params(_jax_model(128), 128, seed=5)
    want = state_dict_from_flax(jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                             jax_wd_mask(params), params))
    model = model_from_config(dict(get_model_config("MobileCLIP-S1"), vision_cfg=_vision(128),
                                   text_cfg=TEXT_CFG))
    got = _wd_mask(dict(model.named_parameters()))
    assert set(got) == set(want)
    for name, decay in got.items():
        assert decay == bool(want[name].flatten()[0]), name
    assert got["visual.stage0_block0.mixer_dw.weight"] and got["visual.proj"]
    assert not got["visual.stage0_block0.mixer_scale"] and not got["visual.head_norm.weight"]


def test_random_init_follows_the_jax_initialisers(monkeypatch):
    """Convolutions normal with std fan_in^-0.5 (lecun_normal's scale),
    `mixer_scale` and every LayerNorm scale 1, every bias 0."""
    _use_dims(monkeypatch, NARROW)
    model = create_model("MobileCLIP-S1", device="cpu", vision_cfg=_vision(128), text_cfg=TEXT_CFG)
    params = dict(model.named_parameters())
    for name, p in params.items():
        if name.endswith("bias") and name != "logit_bias":
            assert (p == 0).all(), name
        elif name.endswith("mixer_scale") or ("norm" in name and name.endswith("weight")):
            assert (p == 1).all(), name
    for name, fan_in in (("visual.downsample3.conv_dw.weight", 49),
                         ("visual.stem_conv2.weight", 8 * 9), ("visual.proj", 128)):
        std = params[name].std().item()
        assert 0.85 * fan_in ** -0.5 < std < 1.15 * fan_in ** -0.5, name


def _serve_exported(monkeypatch, tmp_path, exported, loading):
    """The narrow MobileCLIP-S1 built and exported under MRCLIP_DW_IMPL =
    `exported`, loaded under `loading` (None: the variable unset): the
    served model keeps the artifact's `dw_impl` and the exporting model's
    features."""
    _use_dims(monkeypatch, NARROW)
    monkeypatch.setenv("MRCLIP_DW_IMPL", exported)
    model = create_model("MobileCLIP-S1", device="cpu", vision_cfg=_vision(128), text_cfg=TEXT_CFG)
    assert _impls(model) == {exported}
    path = str(tmp_path / "mobileclip.mrclip")
    save_exported(export_model(model), path)
    if loading is None:
        monkeypatch.delenv("MRCLIP_DW_IMPL")
    else:
        monkeypatch.setenv("MRCLIP_DW_IMPL", loading)
    served = load_exported(path, device="cpu")
    assert _impls(served.model) == {exported} and served.meta["dw_impl"] == exported
    assert served.meta["image_size"] == [128, 128]
    images, _, _ = _batch(128)
    imgs = normalize_images(torch.from_numpy(images)).numpy()
    with torch.no_grad():
        want = model.encode_image(torch.from_numpy(imgs), normalize=True).numpy()
    np.testing.assert_allclose(served.encode_image(imgs), want, rtol=0, atol=1e-5)


def test_export_round_trip_takes_the_serving_process_choice(monkeypatch, tmp_path):
    """The serving process takes its convolution choice from the artifact
    (`dw_impl`), not from its own MRCLIP_DW_IMPL: exported under 'xla',
    loaded under 'pallas', it serves on 'xla'."""
    _serve_exported(monkeypatch, tmp_path, "xla", "pallas")


def test_export_keeps_the_pallas_choice_without_the_variable(monkeypatch, tmp_path):
    """Exported under 'pallas', loaded with the variable unset: the served
    model still runs K8 (its plain version here on the CPU), not the
    default convolution."""
    _serve_exported(monkeypatch, tmp_path, "pallas", None)


@pytest.mark.parametrize("key,value,match", [
    ("timm_deploy_import", True, "ROADMAP"),
    ("timm_model_name", "vit_base_mci_224", "ROADMAP"),  # MobileCLIP-B
    ("output_tokens", True, "ROADMAP"),
    ("timm_model_name", "fastvit_t8", "stage table"),
    ("image_size", 100, "divisible by 32"),
])
def test_forms_outside_the_slice_raise(key, value, match):
    cfg = get_model_config("MobileCLIP-S1")
    cfg["vision_cfg"][key] = value
    with pytest.raises((NotImplementedError, ValueError), match=match):
        model_from_config(cfg)


def test_remat_raises(monkeypatch):
    """Remat, once refused, now builds: MobileCLIP-S1 (narrow) under
    `grad_checkpointing` recomputes each RepMixer block whole and the
    attention stage under the policy, and its dense-loss step's gradients
    are bit-equal to the step's without remat (the CPU's recompute repeats
    the forward's arithmetic); an unknown policy raises."""
    _use_dims(monkeypatch, NARROW)
    images, tokens, labels = _batch(64, n=4)
    batch = {"images": normalize_images(torch.from_numpy(images)),
             "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    apply = make_loss_apply(create_loss(SimpleNamespace(
        multipositiveloss=True, delta=0.5, model="MobileCLIP-S1", gather_with_grad=True)))
    grads = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = create_model("MobileCLIP-S1", device="cpu", vision_cfg=_vision(64),
                             text_cfg=TEXT_CFG, grad_checkpointing=remat, remat_policy="mlp_only")
        assert model.visual.remat == ("mlp_only" if remat else None)
        grads[remat], _ = loss_and_grads(model, apply, dict(model.named_parameters()), batch)
    for name, g in grads[True].items():
        assert torch.equal(g, grads[False][name]), name
    with pytest.raises(ValueError, match="remat policy"):
        create_model("MobileCLIP-S1", device="cpu", grad_checkpointing=True, remat_policy="x")
