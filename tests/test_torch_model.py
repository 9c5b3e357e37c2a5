"""The PyTorch port's CLIP (mrclip_tpu_torch) against the JAX package's.

JAX `create_model("ViT-B-32-mini", scan_layers=False)` params cross over
through `mrclip_tpu_torch.weights.state_dict_from_flax` and load into the
port with `strict=True`; the same numpy-seeded images and tokens then go
through `model.apply` and the port, in fp32 on the CPU, under each of the
JAX package's six attention implementations (its Pallas kernels in
interpret mode, the port's wrappers on their plain versions).
"""

import contextlib
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
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from mrclip_tpu_torch import SimpleTokenizer, create_loss, state_dict_from_flax
from mrclip_tpu_torch.factory import create_model, get_model_config, model_from_config
from mrclip_tpu_torch.models.layers import ATTN_IMPLS, LayerNorm, MultiHeadAttention
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                       make_loss_apply)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TEXTS = [
    "A brain MRI, plane axial, Scanner (Manufacturer, Model, Field Strength): "
    "(SIEMENS, Prisma, 3)",
    "sagittal T2 FLAIR, TE 120 ms, TR 9000 ms",
    "x",
]


def _interpret(attn_impl):
    """JAX's flash kernels run on the CPU only under interpret mode
    (tests/test_flash_attn.py); the fused ones choose it themselves."""
    return pltpu.force_tpu_interpret_mode() if attn_impl == "flash" else contextlib.nullcontext()


@pytest.fixture(scope="module", params=list(ATTN_IMPLS))
def pair(request):
    """(attn_impl, jax module, jax variables, port model) on one set of weights."""
    with _interpret(request.param):
        jm, jv = jax_create_model("ViT-B-32-mini", scan_layers=False, attn_impl=request.param)
    params = jax.device_get(jv["params"])
    model = create_model(
        "ViT-B-32-mini", pretrained=state_dict_from_flax(params), device="cpu",
        attn_impl=request.param,
    )
    return request.param, jm, jv, model


def _batch():
    rng = np.random.RandomState(0)
    images = rng.randn(3, 64, 64, 3).astype(np.float32)
    tokens = SimpleTokenizer(context_length=32)(TEXTS)
    return images, tokens


def test_encoders_and_logits_match_jax(pair):
    impl, jm, jv, model = pair
    images, tokens = _batch()
    with _interpret(impl):
        want = jm.apply(jv, images, tokens)
        want_logits, _ = jm.apply(jv, images, tokens, method=jm.get_logits)
        want_raw = jm.apply(jv, images, method=jm.encode_image)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(tokens))
        logits, logits_t = model.get_logits(torch.from_numpy(images), torch.from_numpy(tokens))
        raw_img = model.encode_image(torch.from_numpy(images))
    for key in ("image_features", "text_features"):
        assert got[key].shape == want[key].shape
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-4, (impl, key)
    assert np.abs(raw_img.numpy() - np.asarray(want_raw)).max() < 1e-4
    assert abs(float(got["logit_scale"]) - float(want["logit_scale"])) < 1e-4
    assert np.abs(logits.numpy() - np.asarray(want_logits)).max() < 1e-4
    torch.testing.assert_close(logits_t, logits.T)


def test_state_dict_matches_hub_export(pair):
    """The port's copy of the converter gives exactly what
    `mrclip_tpu.hub.export_torch_state_dict` writes, and every key is one the
    port's module holds (strict load)."""
    _, _, jv, model = pair
    params = jax.device_get(jv["params"])
    sd = state_dict_from_flax(params)
    ref = export_torch_state_dict(params)
    assert set(sd) == set(ref) == set(model.state_dict())
    for key, val in sd.items():
        assert val.dtype == torch.float32
        np.testing.assert_array_equal(val.numpy(), ref[key], err_msg=key)


def test_scan_stacked_params_convert_like_unrolled(pair):
    _, _, jv, _ = pair
    params = jax.device_get(jv["params"])

    def stack(tower):
        tr = dict(tower["transformer"])
        blocks = [tr.pop(f"blocks_{i}") for i in range(2)]
        tr["blocks"] = {"block": jax.tree.map(lambda *xs: np.stack(xs), *blocks)}
        return dict(tower, transformer=tr)

    stacked = dict(params, visual=stack(params["visual"]), text=stack(params["text"]))
    a, b = state_dict_from_flax(params), state_dict_from_flax(stacked)
    assert set(a) == set(b)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def test_tokenizer_ids_match_jax():
    texts = TEXTS + ["Imaging Parameters (Echo Time, Repetition Time): (2.26, 2300)", "é ü 3T"]
    np.testing.assert_array_equal(SimpleTokenizer()(texts), JaxTokenizer()(texts))
    np.testing.assert_array_equal(
        SimpleTokenizer(context_length=8)(texts), JaxTokenizer(context_length=8)(texts)
    )


def test_bf16_compute_over_fp32_params():
    model = create_model("ViT-B-32-mini", precision="bf16", device="cpu", rng_seed=1)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    images, tokens = _batch()
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images), normalize=True)
        txt = model.encode_text(torch.from_numpy(tokens), normalize=True)
    assert img.dtype == txt.dtype == torch.bfloat16
    assert torch.isfinite(img.float()).all() and torch.isfinite(txt.float()).all()
    ref = create_model("ViT-B-32-mini", precision="fp32", device="cpu", rng_seed=1)
    with torch.no_grad():
        img32 = ref.encode_image(torch.from_numpy(images), normalize=True)
    cos = torch.nn.functional.cosine_similarity(img.float(), img32, dim=-1)
    assert cos.min() > 0.99


def test_layernorm_keeps_fp32_statistics():
    ln = LayerNorm(8)
    x = torch.randn(4, 8, dtype=torch.bfloat16) * 100 + 1000
    y = ln(x)
    assert y.dtype == torch.bfloat16
    want = torch.nn.functional.layer_norm(x.float(), (8,)).to(torch.bfloat16)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_same_seed_same_weights():
    a = create_model("ViT-B-32-mini", device="cpu", rng_seed=3).state_dict()
    b = create_model("ViT-B-32-mini", device="cpu", rng_seed=3).state_dict()
    c = create_model("ViT-B-32-mini", device="cpu", rng_seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["visual.proj"], c["visual.proj"])


@pytest.mark.parametrize(
    "tower,key,value",
    [
        ("vision_cfg", "timm_model_name", "vit_base_patch16_224"),
        ("vision_cfg", "layers", [3, 4, 6, 3]),
        ("vision_cfg", "patch_dropout", 0.5),
        ("vision_cfg", "pool_type", "map"),
        ("text_cfg", "hf_model_name", "roberta-base"),
        ("text_cfg", "embed_cls", True),
    ],
)
def test_options_outside_the_slice_raise(tower, key, value):
    cfg = get_model_config("ViT-B-32-mini")
    cfg[tower][key] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_from_config(cfg)


@pytest.mark.parametrize("option", [{"scan_layers": True}, {"force_patch_dropout": 0.5}])
def test_create_model_options_outside_the_slice_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model("ViT-B-32-mini", device="cpu", **option)


def test_text_dropout_raises():
    """MR-CLIP's text dropout, once refused, now builds: a text tower asked
    for it drops each block's branches in train mode (masks from the
    forward's generator) and nothing in eval mode, and train mode without a
    generator raises rather than draw from the global RNG; the vision tower
    keeps none."""
    text_cfg = dict(get_model_config("ViT-B-32-mini")["text_cfg"], dropout=0.5)
    model = create_model("ViT-B-32-mini", text_cfg=text_cfg, device="cpu")
    assert all(b.dropout == 0.5 for b in model.transformer.resblocks)
    assert all(b.dropout == 0.0 for b in model.visual.transformer.resblocks)
    tokens = torch.randint(1, 49408, (2, 32), generator=torch.Generator().manual_seed(0))
    model.eval()
    plain = model.encode_text(tokens)
    model.train()
    dropped = model.encode_text(tokens, generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(plain, dropped)
    with pytest.raises(ValueError, match="Generator"):
        model.encode_text(tokens)
    model.eval()
    torch.testing.assert_close(model.encode_text(tokens), plain, rtol=0, atol=0)


def test_params_do_not_depend_on_the_attention_impl(pair):
    """The JAX tree under each option has xla's structure and shapes, so one
    state dict (and `state_dict_from_flax`, unchanged) serves every option."""
    impl, _, jv, model = pair
    _, ref = jax_create_model("ViT-B-32-mini", scan_layers=False, attn_impl="xla")
    shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    assert shapes(jv["params"]) == shapes(ref["params"]), impl
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in create_model("ViT-B-32-mini", device="cpu").state_dict().items()}


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError, match="attn_impl"):
        MultiHeadAttention(64, 2, attn_impl="sdpa")


STEPS = 3


@pytest.mark.parametrize("impl", ["fused", "manual", "bf16", "flash"])
def test_three_train_steps_match_jax(impl):
    """fp32, dense multipositive loss, AdamW (lr 1e-4, wd 0.2, bf16 first
    moment), 3 steps from the same weights and batch, at
    tests/test_torch_train_step.py's bars: loss and grad norm per step to
    1e-5 relative, parameters after the steps to 2e-5. The port runs `impl`;
    JAX the same, except for 'flash', whose step is held against JAX's 'xla'
    step: jax's flash kernel is differentiated through a `jax.checkpoint`,
    which cannot be partial-evaluated in interpret mode
    (tests/test_flash_attn.py), and in fp32 both compute the same attention
    (tests/test_torch_flash_attn.py holds the kernels to 1e-4)."""
    jax_impl = "xla" if impl == "flash" else impl
    jm, jv = jax_create_model("ViT-B-32-mini", scan_layers=False, attn_impl=jax_impl)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)
    tokens = rng.randint(1, 49408, (8, 32)).astype(np.int32)
    labels = np.array([0, 1, 2, 0, 1, 0, 2, 2], np.int32)
    args = SimpleNamespace(multipositiveloss=True, delta=0.5, pallas_loss=False,
                           model="ViT-B-32-mini", gather_with_grad=True)
    tx = jax_create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = jax_create_train_state(jv, tx)
    step = jax_build_train_step(jm, jax_make_loss_apply(jax_create_loss(args)), tx, donate=False)
    jb = {"images": jax_normalize(jnp.asarray(images)), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}
    jax_metrics = []
    for i in range(STEPS):
        state, m = step(state, jb, jax.random.key(i))
        jax_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    jax_params = state_dict_from_flax(jax.device_get(state.params))

    model = create_model("ViT-B-32-mini", pretrained=state_dict_from_flax(jax.device_get(jv["params"])),
                         device="cpu", attn_impl=impl)
    ptx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    pstate = create_train_state(model, ptx)
    pstep = build_train_step(model, make_loss_apply(create_loss(args)), ptx)
    pb = {"images": normalize_images(torch.from_numpy(images)),
          "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    for jl, jn in jax_metrics:
        pstate, m = pstep(pstate, pb)
        np.testing.assert_allclose(m["loss"].item(), jl, rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), jn, rtol=1e-5)
    for name, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_params[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
