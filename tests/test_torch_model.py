"""The PyTorch port's CLIP (mrclip_tpu_torch) against the JAX package's.

JAX `create_model("ViT-B-32-mini", scan_layers=False)` params cross over
through `mrclip_tpu_torch.weights.state_dict_from_flax` and load into the
port with `strict=True`; the same numpy-seeded images and tokens then go
through `model.apply` and the port, in fp32 on the CPU, under both
attention implementations the port has.
"""

import jax
import numpy as np
import pytest
import torch

from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.hub import export_torch_state_dict
from mrclip_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from mrclip_tpu_torch import SimpleTokenizer, state_dict_from_flax
from mrclip_tpu_torch.factory import create_model, get_model_config, model_from_config
from mrclip_tpu_torch.models.layers import LayerNorm, MultiHeadAttention

TEXTS = [
    "A brain MRI, plane axial, Scanner (Manufacturer, Model, Field Strength): "
    "(SIEMENS, Prisma, 3)",
    "sagittal T2 FLAIR, TE 120 ms, TR 9000 ms",
    "x",
]


@pytest.fixture(scope="module", params=["xla", "fusedp"])
def pair(request):
    """(attn_impl, jax module, jax variables, port model) on one set of weights."""
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
    want = jm.apply(jv, images, tokens)
    want_logits, _ = jm.apply(jv, images, tokens, method=jm.get_logits)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(tokens))
        logits, logits_t = model.get_logits(torch.from_numpy(images), torch.from_numpy(tokens))
        raw_img = model.encode_image(torch.from_numpy(images))
    want_raw = jm.apply(jv, images, method=jm.encode_image)
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
        ("vision_cfg", "pool_type", "avg"),
        ("text_cfg", "hf_model_name", "roberta-base"),
        ("text_cfg", "embed_cls", True),
    ],
)
def test_options_outside_the_slice_raise(tower, key, value):
    cfg = get_model_config("ViT-B-32-mini")
    cfg[tower][key] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_from_config(cfg)


@pytest.mark.parametrize("option", [{"scan_layers": True}, {"grad_checkpointing": True},
                                    {"force_patch_dropout": 0.5}])
def test_create_model_options_outside_the_slice_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model("ViT-B-32-mini", device="cpu", **option)


@pytest.mark.parametrize("impl", ["flash", "fused", "bf16", "manual"])
def test_attention_impls_outside_the_slice_raise(impl):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiHeadAttention(64, 2, attn_impl=impl)
