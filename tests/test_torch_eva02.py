"""The port's EVA02 tower and EVA02-B-16 slice (mrclip_tpu_torch) against the
JAX package's, on the same weights.

JAX params cross over through `mrclip_tpu_torch.weights.state_dict_from_flax`
into the timm `visual.trunk.*` layout and load into the port with
`strict=True`; the same numpy-seeded inputs then go through both, in fp32 on
the CPU. The whole slice runs EVA02-B-16 at full vision width and depth on
64 x 64 images (16 patches + CLS) with a 2-layer text tower, through both
factories and both train steps. The JAX side is built once, with
`scan_layers=True`; its unrolled tree (`blocks_N`, the JAX package's default
at 12 layers) is the same params unstacked.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mrclip_tpu.factory import create_loss as jax_create_loss
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.hub import export_torch_state_dict
from mrclip_tpu.models.layers import apply_rope_cat as jax_apply_rope_cat
from mrclip_tpu.models.vision import VisionTransformer as JaxVisionTransformer
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu.ops.pos_embed import rope_cat_2d as jax_rope_cat_2d
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu.parallel.train_step import _wd_mask as jax_wd_mask
from mrclip_tpu_torch import create_loss, create_model, state_dict_from_flax
from mrclip_tpu_torch.factory import get_model_config, model_from_config
from mrclip_tpu_torch.models.layers import ATTN_IMPLS, apply_rope_cat
from mrclip_tpu_torch.models.vision import EvaVisionTransformer
from mrclip_tpu_torch.ops.fused_attn import rope_table
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.ops.pos_embed import rope_cat_2d
from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                       make_loss_apply)
from mrclip_tpu_torch.parallel.train_step import _wd_mask, loss_and_grads
from mrclip_tpu_torch.serving import export_model, load_exported, save_exported

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

STEPS = 2
# the slice's configuration cut to size: full-width, full-depth vision on
# 64 x 64 images, a 2-layer text tower
TEXT_CFG = dict(context_length=16, vocab_size=49408, width=128, heads=2, layers=2)


def _slice_cfgs():
    cfg = get_model_config("EVA02-B-16")
    return dict(cfg["vision_cfg"], image_size=64), TEXT_CFG


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8),
            rng.randint(1, 49408, (8, 16)).astype(np.int32),
            np.array([0, 1, 2, 0, 1, 0, 2, 2], np.int32))  # repeated labels


@pytest.fixture(scope="module")
def scanned():
    """(JAX module, params) of the slice, `scan_layers=True`."""
    vision, text = _slice_cfgs()
    jm, jv = jax_create_model("EVA02-B-16", scan_layers=True, attn_impl="xla",
                              vision_cfg=vision, text_cfg=text)
    return jm, jax.device_get(jv["params"])


def _unstack(params):
    """The scan-stacked tree with its `blocks/block` layer axis unrolled into
    `blocks_N`, the layout of `scan_layers=False`."""

    def tower(t):
        tr = dict(t["transformer"])
        stacked = tr.pop("blocks")["block"]
        n = len(jax.tree.leaves(stacked)[0])
        tr.update({f"blocks_{i}": jax.tree.map(lambda x, i=i: x[i], stacked) for i in range(n)})
        return dict(t, transformer=tr)

    return dict(params, visual=tower(params["visual"]), text=tower(params["text"]))


def _port(params, attn_impl):
    vision, text = _slice_cfgs()
    return create_model("EVA02-B-16", pretrained=state_dict_from_flax(params), device="cpu",
                        attn_impl=attn_impl, vision_cfg=vision, text_cfg=text)


@pytest.mark.parametrize("args", [(64, 14, 14, (16, 16)), (64, 16, 16, (16, 16)),
                                  (32, 4, 4, (8, 8)), (8, 3, 5, None)])
def test_rope_cat_2d_is_a_copy_of_jax(args):
    *shape, ref = args
    np.testing.assert_array_equal(rope_cat_2d(*shape, ref_feat_shape=ref),
                                  jax_rope_cat_2d(*shape, ref_feat_shape=ref))


@pytest.mark.parametrize("prefix", [0, 1])
def test_apply_rope_cat_matches_jax(prefix):
    """The 'xla' path's fp32 rotation, CLS rows passing through bit-exact."""
    rng = np.random.RandomState(1)
    t = rng.randn(2, 17, 3, 8).astype(np.float32)
    rope = rng.uniform(-1, 1, (17 - prefix, 16)).astype(np.float32)
    got = apply_rope_cat(torch.from_numpy(t), rope_table(rope, prefix, torch.float32))
    want = jax_apply_rope_cat(jnp.asarray(t), jnp.asarray(rope), prefix)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    if prefix:
        np.testing.assert_array_equal(got[:, 0].numpy(), t[:, 0])


def test_apply_rope_cat_in_the_compute_type_matches_jax():
    """The rotation of 'bf16', 'flash' and 'fused' (`compute_dtype` bf16):
    each product and sum rounded to bf16, as the JAX package computes it on
    the same bf16 inputs and bf16 table. Bar: one bf16 ulp at the largest
    magnitude (measured: bit-equal)."""
    rng = np.random.RandomState(1)
    t = jnp.asarray(rng.randn(2, 17, 3, 8), jnp.bfloat16)
    rope = rng.uniform(-1, 1, (16, 16)).astype(np.float32)
    want = np.asarray(jax_apply_rope_cat(t, jnp.asarray(rope), 1, compute_dtype=jnp.bfloat16),
                      np.float32)
    got = apply_rope_cat(torch.from_numpy(np.asarray(t, np.float32)).to(torch.bfloat16),
                         rope_table(rope, 1, torch.bfloat16), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp
    np.testing.assert_array_equal(got[:, 0].float().numpy(), np.asarray(t[:, 0], np.float32))


@pytest.mark.parametrize("impl", ATTN_IMPLS)
def test_rope_table_type_follows_jax(impl):
    """JAX rotates q and k in the compute type under 'bf16', 'flash', 'fused'
    (and inside the kernels under 'fusedp'), in fp32 under 'xla' and
    'manual' (`MultiHeadAttention`, layers.py:456-460): the table is built in
    that type."""
    tower = EvaVisionTransformer(image_size=16, patch_size=4, width=32, layers=1, heads=2,
                                 output_dim=24, rope_ref_feat_shape=(8, 8), attn_impl=impl,
                                 dtype=torch.bfloat16)
    want = torch.float32 if impl in ("xla", "manual") else torch.bfloat16
    assert tower.rope.dtype == want


@pytest.mark.parametrize("impl", ["xla", "fusedp"])
def test_narrow_tower_matches_jax(impl):
    """tests/test_fused_attn.py's narrow EVA02 tower (image 16, patch 4,
    width 32, 2 layers, 2 heads, ref grid (8, 8)) with zero k bias, under
    the same attn_impl on both sides; biases and norms moved off their
    initial values so each one counts."""
    imgs = np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32)
    vt = JaxVisionTransformer(
        image_size=16, patch_size=4, width=32, layers=2, heads=2, mlp_ratio=4 * 2 / 3,
        output_dim=24, patch_bias=True, no_ln_pre=True, pool_type="tok", use_rope=True,
        rope_ref_feat_shape=(8, 8), mlp_type="swiglu", mlp_norm=True, attn_inner_norm=True,
        attn_zero_k_bias=True, ln_eps=1e-6, attn_impl=impl, scan_layers=False)
    params = jax.device_get(vt.init(jax.random.PRNGKey(0), jnp.asarray(imgs))["params"])
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.randn(*np.shape(x)).astype(np.float32),
                          params)
    want = np.asarray(vt.apply({"params": params}, jnp.asarray(imgs)))
    tower = EvaVisionTransformer(image_size=16, patch_size=4, width=32, layers=2, heads=2,
                                 output_dim=24, rope_ref_feat_shape=(8, 8), attn_impl=impl)
    sd = state_dict_from_flax({"visual": params})
    tower.load_state_dict({k.removeprefix("visual."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tower(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 24)
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
def test_state_dict_matches_hub_export(scanned, layout):
    """The port's converter gives exactly what `hub.export_torch_state_dict`
    writes for an EVA02 CLIP (timm trunk, k bias dropped, text inlined), and
    every key is one the port's module holds (strict load)."""
    params = scanned[1] if layout == "scanned" else _unstack(scanned[1])
    sd = state_dict_from_flax(params)
    ref = export_torch_state_dict(params)
    vision, text = _slice_cfgs()
    model = model_from_config(dict(get_model_config("EVA02-B-16"), vision_cfg=vision,
                                   text_cfg=text))
    assert set(sd) == set(ref) == set(model.state_dict())
    assert "visual.trunk.blocks.11.attn.k_proj.weight" in sd
    assert not any(k.endswith("k_proj.bias") for k in sd)
    for key, val in sd.items():
        assert val.dtype == torch.float32
        np.testing.assert_array_equal(val.numpy(), ref[key], err_msg=key)
    model.load_state_dict(sd, strict=True)


def test_fused_gate_params_convert_like_split(scanned):
    """A fused-gate SwiGLU tree (`fc1` = gate||value, the JAX package's
    `swiglu_fused` layout) converts to the same split state dict."""
    from mrclip_tpu.models.layers import fuse_swiglu_params

    params = scanned[1]
    fused = jax.device_get(fuse_swiglu_params(params))
    assert "fc1" in fused["visual"]["transformer"]["blocks"]["block"]["mlp"]
    a, b = state_dict_from_flax(params), state_dict_from_flax(fused)
    assert set(a) == set(b)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["fusedp", "xla"])
def test_whole_slice_features_match_jax(scanned, impl):
    """EVA02-B-16 through both factories: JAX `attn_impl='xla'` with
    `scan_layers=True`, the port under `fusedp` (plain K2 and K1 on the CPU)
    and `xla`; fp32 features to 1e-4."""
    jm, params = scanned
    images, tokens, _ = _batch()
    imgs = np.array(jax_normalize(jnp.asarray(images)))
    want = jm.apply({"params": params}, imgs, tokens)
    model = _port(params, impl)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(tokens))
    for key in ("image_features", "text_features"):
        assert got[key].shape == want[key].shape == (8, 512)
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-4, key


@pytest.mark.parametrize("impl", ["fused", "flash"])
def test_small_eva02_features_match_jax_under_the_same_impl(scanned, impl):
    """EVA02-B-16 cut to the slice's size (full-width, full-depth vision on
    64 x 64 images, 2-layer text) under 'fused' (K4 plain) and 'flash' (K10
    plain) against the JAX model under the same attn_impl (its kernels in
    interpret mode), same params: fp32 features to 1e-4. The JAX side runs
    unrolled: jax's flash kernel sits in a `jax.checkpoint`, which interpret
    mode cannot partial-evaluate inside a scan."""
    jm, params = scanned
    images, tokens, _ = _batch()
    imgs = np.array(jax_normalize(jnp.asarray(images)))
    jax_model = jm.clone(attn_impl=impl, scan_layers=False)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p: jax_model.apply({"params": p}, imgs, tokens))(_unstack(params))
    model = _port(params, impl)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(tokens))
    for key in ("image_features", "text_features"):
        assert got[key].shape == want[key].shape == (8, 512)
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-4, key


@pytest.fixture(scope="module")
def steps(scanned):
    """STEPS fp32 dense-loss train steps on both sides from the same weights
    and batch (AdamW lr 1e-4 with a bf16 first moment, as
    tests/test_torch_train_step.py), the port under 'fusedp'. Weight decay
    is 0 here: JAX's mask decides by ndim, and under `scan_layers=True` the
    norm scales and biases of the blocks are [L, W], so it decays them, which
    neither the unrolled JAX model nor the port does; the mask itself is held
    against the unrolled tree's by test_wd_mask_matches_jax."""
    jm, params = scanned
    images, tokens, labels = _batch()
    args = SimpleNamespace(multipositiveloss=True, delta=0.5, pallas_loss=False,
                           model="EVA02-B-16", gather_with_grad=True)
    tx = jax_create_optimizer(lr=1e-4, wd=0.0, moments_dtype="bfloat16")
    state = jax_create_train_state({"params": params}, tx)
    jax_apply = jax_make_loss_apply(jax_create_loss(args))
    jb = {"images": jax_normalize(jnp.asarray(images)), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}

    def jax_loss(p):
        out = jm.apply({"params": p}, jb["images"], jb["tokens"], deterministic=False)
        return jax_apply(out, jb)["loss"]

    jax_grads = state_dict_from_flax(jax.device_get(jax.jit(jax.grad(jax_loss))(state.params)))
    step = jax_build_train_step(jm, jax_apply, tx, donate=False)
    jax_metrics = []
    for i in range(STEPS):
        state, m = step(state, jb, jax.random.key(i))
        jax_metrics.append((float(m["loss"]), float(m["grad_norm"])))

    model = _port(params, "fusedp")
    ptx = create_optimizer(lr=1e-4, wd=0.0, moments_dtype="bfloat16")
    pstate = create_train_state(model, ptx)
    apply = make_loss_apply(create_loss(args))
    pb = {"images": normalize_images(torch.from_numpy(images)),
          "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    port_grads, _ = loss_and_grads(model, apply, pstate.params, pb)
    pstep = build_train_step(model, apply, ptx)
    port_metrics = []
    for _ in range(STEPS):
        pstate, m = pstep(pstate, pb)
        port_metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return dict(jax_grads=jax_grads, port_grads=port_grads, jax_metrics=jax_metrics,
                port_metrics=port_metrics, jax_params=state_dict_from_flax(
                    jax.device_get(state.params)), state=pstate)


def test_train_steps_match_jax(steps):
    """tests/test_torch_train_step.py's bars: loss and grad norm per step to
    1e-5 relative; first-step gradients to rtol 1e-4, atol 5e-6; parameters
    after the steps to 2e-5."""
    for (jl, jn), (pl_, pn) in zip(steps["jax_metrics"], steps["port_metrics"]):
        np.testing.assert_allclose(pl_, jl, rtol=1e-5)
        np.testing.assert_allclose(pn, jn, rtol=1e-5)
    jg, pg = steps["jax_grads"], steps["port_grads"]
    assert set(pg) == set(jg)
    for name, g in pg.items():
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), rtol=1e-4, atol=5e-6,
                                   err_msg=name)
    for i in (0, 11):  # the attention projections learn through the rope backward
        for proj in ("q_proj", "k_proj", "v_proj"):
            assert pg[f"visual.trunk.blocks.{i}.attn.{proj}.weight"].abs().max() > 0
    state, jp = steps["state"], steps["jax_params"]
    assert state.step == STEPS
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)


def test_wd_mask_matches_jax(scanned):
    """Parameter for parameter through the weight mapping, against JAX's
    mask of the unrolled tree: timm's cls_token [1, 1, W] is not decayed
    (JAX's class_embedding [W]), pos_embed [1, N, W] is (JAX's
    positional_embedding [N, W])."""
    params = _unstack(scanned[1])
    want = state_dict_from_flax(jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                             jax_wd_mask(params), params))
    vision, text = _slice_cfgs()
    model = model_from_config(dict(get_model_config("EVA02-B-16"), vision_cfg=vision,
                                   text_cfg=text))
    got = _wd_mask(dict(model.named_parameters()))
    assert set(got) == set(want)
    for name, decay in got.items():
        assert decay == bool(want[name].flatten()[0]), name
    assert not got["visual.trunk.cls_token"] and got["visual.trunk.pos_embed"]
    assert not got["visual.trunk.blocks.0.attn.norm.weight"]


def _small_eva02(attn_impl="fusedp", **kw):
    vision, text = _slice_cfgs()
    return create_model("EVA02-B-16", device="cpu", attn_impl=attn_impl, vision_cfg=vision,
                        text_cfg=text, **kw)


def test_random_init_follows_the_name_rules():
    """Every LayerNorm scale is 1 and every bias 0 (timm's 1-D norm weights
    included), embeddings and projections are normals of the JAX package's
    scale."""
    model = _small_eva02()
    params = dict(model.named_parameters())
    for name, p in params.items():
        if name.endswith("bias"):
            assert (p == 0).all(), name
        elif "norm" in name and name.endswith("weight"):
            assert (p == 1).all(), name
    std = params["visual.trunk.cls_token"].std().item()
    assert 0.8 * 768 ** -0.5 < std < 1.2 * 768 ** -0.5
    std = params["visual.trunk.blocks.0.mlp.fc2.weight"].std().item()
    assert 0.9 * 2048 ** -0.5 < std < 1.1 * 2048 ** -0.5
    assert params["visual.trunk.blocks.0.mlp.fc1_g.weight"].shape == (2048, 768)


def test_export_round_trip_on_the_cpu(tmp_path):
    """An EVA02 artifact rebuilds through `build_args` and serves the same
    features."""
    model = _small_eva02(precision="fp32")
    path = str(tmp_path / "eva02.mrclip")
    save_exported(export_model(model), path)
    served = load_exported(path, device="cpu")
    assert served.meta["attn_impl"] == "fusedp" and served.meta["image_size"] == [64, 64]
    images, tokens, _ = _batch()
    imgs = np.array(jax_normalize(jnp.asarray(images)))
    with torch.no_grad():
        want = model(torch.from_numpy(imgs), torch.from_numpy(tokens))
    np.testing.assert_array_equal(served.encode_image(imgs), want["image_features"].numpy())
    np.testing.assert_array_equal(served.encode_text(tokens), want["text_features"].numpy())


def test_custom_text_checkpoint_loads():
    """A CustomTextCLIP state dict (text tower under `text.`, as open_clip
    saves EVA02-B-16) loads into the inlined layout."""
    sd = _small_eva02().state_dict()
    custom = {("text." + k if not k.startswith(("visual.", "logit_")) else k): v
              for k, v in sd.items()}
    assert "text.token_embedding.weight" in custom
    loaded = _small_eva02(pretrained={"state_dict": custom}).state_dict()
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


@pytest.mark.parametrize("key,value", [
    ("timm_model_name", "eva02_enormous_patch14_clip_224"),
    ("timm_model_name", "eva_giant_patch14_224"),
    ("mlp_fused_gate", True),
    ("timm_drop_path", 0.1),
    ("patch_dropout", 0.5),
])
def test_eva02_options_outside_the_slice_raise(key, value):
    cfg = get_model_config("EVA02-B-16")
    cfg["vision_cfg"][key] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_from_config(cfg)
