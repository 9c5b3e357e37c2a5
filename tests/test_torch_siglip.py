"""The SigLIP configs in the PyTorch port against the JAX package.

- Each of the eleven SigLIP configs at its published widths, the depth cut
  to 2 layers a tower (the timm towers take their depth from
  `_TIMM_VIT_DIMS`, not the config, so both packages' tables are patched
  for the test), images of 3 patches plus 2 pixels a side (the stride-p
  patchify crops the remainder, as SO400M-14 crops 384 to 378) and 16
  token ids: JAX's params cross over through `state_dict_from_flax` into
  the port with `strict=True`, and the same numpy-seeded images and tokens
  go through JAX's `xla` attention and the port's `fusedp` (its K1 wrapper
  on the plain version on the CPU) in fp32. The i18n vocabularies (250000
  rows) are cut to 32000, the other configs' size, to keep two copies of
  the table in memory small; the embedding lookup is the same code.
- The SO400M vision tower (head dim 72) against a JAX `VisionTransformer`
  built with SigLIP's arguments directly, as tests/test_siglip_import.py
  builds its tiny trunk.
- A checkpoint in the released open_clip layout (`visual.trunk.*`, the
  CustomTextCLIP's `text.*` with `text.text_projection.{weight,bias}`,
  `logit_scale`, `logit_bias`) loads into the port with `strict=True` and
  into JAX through its own importer; both give the same features.
- A 3-step `fusedp` train step with the SigLIP sigmoid loss at head dim 72
  and a narrow width against JAX's, as tests/test_torch_wide_models.py
  runs head dim 80.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrclip_tpu.models.clip as jax_clip
from mrclip_tpu.factory import create_loss as jax_create_loss
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.factory import get_model_config as jax_get_model_config
from mrclip_tpu.models.layers import gelu_tanh as jax_gelu_tanh
from mrclip_tpu.models.vision import VisionTransformer as JaxVisionTransformer
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu_torch import create_loss, create_model, state_dict_from_flax
from mrclip_tpu_torch.factory import get_model_config
from mrclip_tpu_torch.models import clip as port_clip
from mrclip_tpu_torch.models.layers import gelu_tanh
from mrclip_tpu_torch.models.vision import SiglipVisionTransformer
from mrclip_tpu_torch.ops import fused_attn as fa
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                       make_loss_apply)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

SIGLIP = ["ViT-B-16-SigLIP", "ViT-B-16-SigLIP-256", "ViT-B-16-SigLIP-384",
          "ViT-B-16-SigLIP-512", "ViT-B-16-SigLIP-i18n-256", "ViT-L-16-SigLIP-256",
          "ViT-L-16-SigLIP-384", "ViT-SO400M-14-SigLIP", "ViT-SO400M-14-SigLIP-378",
          "ViT-SO400M-14-SigLIP-384", "ViT-SO400M-16-SigLIP-i18n-256"]
LAYERS, CTX, VOCAB = 2, 16, 32000
STEPS = 3


@pytest.fixture
def cut_depth(monkeypatch):
    """Both packages' timm ViT tables at LAYERS layers, widths kept."""
    for module in (jax_clip, port_clip):
        monkeypatch.setattr(module, "_TIMM_VIT_DIMS",
                            {k: (w, LAYERS, h) for k, (w, _, h) in module._TIMM_VIT_DIMS.items()})


def _patch(cfg):
    return int(port_clip._TIMM_VIT.match(cfg["vision_cfg"]["timm_model_name"]).group(2))


def _cut(name):
    """(vision_cfg, text_cfg, image side) of the config cut to size."""
    cfg = get_model_config(name)
    side = 3 * _patch(cfg) + 2
    text = dict(cfg["text_cfg"], layers=LAYERS, context_length=CTX,
                vocab_size=min(VOCAB, cfg["text_cfg"]["vocab_size"]))
    return dict(cfg["vision_cfg"], image_size=side), text, side


@pytest.mark.parametrize("name", SIGLIP)
def test_siglip_config_matches_jax_at_full_width(name, cut_depth):
    """fp32: image and text features within 1e-4 of JAX's (`xla`), the
    port under `fusedp`; every parameter loads strictly with JAX's shape;
    the logits carry the bias (-10) and match JAX's `get_logits`."""
    vision, text, side = _cut(name)
    cfg = get_model_config(name)
    assert cfg == jax_get_model_config(name)
    jm, jv = jax_create_model(name, scan_layers=False, attn_impl="xla", vision_cfg=vision,
                              text_cfg=text)
    sd = state_dict_from_flax(jax.device_get(jv["params"]))
    model = create_model(name, pretrained=sd, device="cpu", attn_impl="fusedp",
                         vision_cfg=vision, text_cfg=text)  # load_state_dict(strict=True)
    for key, p in model.state_dict().items():
        assert tuple(p.shape) == tuple(sd[key].shape), key
    width = cfg["embed_dim"]
    hidden = 4304 if "SO400M" in name else 4 * width
    assert tuple(sd["visual.trunk.blocks.1.mlp.fc1.weight"].shape) == (hidden, width)
    assert tuple(sd["visual.trunk.attn_pool.mlp.fc2.weight"].shape) == (width, hidden)
    assert tuple(sd["text_projection.weight"].shape) == (width, width)
    assert "visual.trunk.cls_token" not in sd and "visual.head.proj.weight" not in sd
    heads = 16 if width > 768 else 12
    assert model.visual.trunk.blocks[0].attn.num_heads == heads

    rng = np.random.RandomState(side)
    images = rng.randn(2, side, side, 3).astype(np.float32)
    tokens = rng.randint(1, text["vocab_size"], (2, CTX)).astype(np.int32)
    want = jm.apply(jv, images, tokens)
    want_logits, _ = jm.apply(jv, images, tokens, method=jm.get_logits)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(tokens).long())
        got_logits, _ = model.get_logits(torch.from_numpy(images), torch.from_numpy(tokens))
    for key in ("image_features", "text_features"):
        assert got[key].shape == want[key].shape == (2, width)
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-4, key
    assert got["logit_bias"].item() == -10.0
    assert np.abs(got_logits.numpy() - np.asarray(want_logits)).max() < 1e-4
    assert fa.launches == 0  # the CPU ran the plain version


def test_so400m_tower_matches_jax_vision_transformer():
    """SO400M's vision tower (1152 wide, 16 heads of 72, MLP 4304, 2
    layers) at 44 px in patches of 14 against JAX's `VisionTransformer`
    with SigLIP's arguments (no CLS, patch bias, no ln_pre, map pool, GELU
    tanh, LN eps 1e-6), fp32 within 1e-4, under each attention option that
    runs on the CPU."""
    kw = dict(image_size=44, patch_size=14, width=1152, layers=2, heads=16,
              mlp_ratio=4304 / 1152)
    jt = JaxVisionTransformer(**kw, output_dim=None, patch_bias=True, use_cls_token=False,
                              no_ln_pre=True, pool_type="map", act=jax_gelu_tanh, ln_eps=1e-6,
                              scan_layers=False)
    rng = np.random.RandomState(72)
    images = rng.randn(3, 44, 44, 3).astype(np.float32)
    params = jt.init(jax.random.key(0), jnp.asarray(images))["params"]
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(images)))
    sd = state_dict_from_flax({"visual": jax.device_get(params)})
    sd = {k[len("visual."):]: v for k, v in sd.items()}
    for impl in ("xla", "manual", "fusedp", "fused", "flash"):
        tower = SiglipVisionTransformer(**kw, act=gelu_tanh, ln_eps=1e-6, attn_impl=impl)
        tower.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = tower(torch.from_numpy(images)).numpy()
        assert got.shape == want.shape == (3, 1152)
        assert np.abs(got - want).max() < 1e-4, impl


def _released_layout(vision_width, hidden, patch, side, text_cfg, embed_dim, seed=0):
    """A checkpoint in the released open_clip SigLIP layout: the timm
    trunk under `visual.trunk.`, the CustomTextCLIP's text tower under
    `text.` with a biased projection, and the logit scale and bias."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32))

    def ln(key, w):
        return {key + ".weight": 1 + r(w), key + ".bias": r(w)}

    def dense(key, n_in, n_out):
        return {key + ".weight": r(n_out, n_in), key + ".bias": r(n_out)}

    d, n = vision_width, (side // patch) ** 2
    t = "visual.trunk."
    sd = {t + "pos_embed": r(1, n, d), **dense(t + "patch_embed.proj", 3 * patch * patch, d),
          **ln(t + "norm", d), t + "attn_pool.latent": r(1, 1, d),
          **dense(t + "attn_pool.q", d, d), **dense(t + "attn_pool.kv", d, 2 * d),
          **dense(t + "attn_pool.proj", d, d), **ln(t + "attn_pool.norm", d),
          **dense(t + "attn_pool.mlp.fc1", d, hidden), **dense(t + "attn_pool.mlp.fc2", hidden, d)}
    sd[t + "patch_embed.proj.weight"] = sd[t + "patch_embed.proj.weight"].reshape(
        d, 3, patch, patch)
    for i in range(LAYERS):
        b = f"{t}blocks.{i}."
        sd.update({**ln(b + "norm1", d), **dense(b + "attn.qkv", d, 3 * d),
                   **dense(b + "attn.proj", d, d), **ln(b + "norm2", d),
                   **dense(b + "mlp.fc1", d, hidden), **dense(b + "mlp.fc2", hidden, d)})
    w = text_cfg["width"]
    sd.update({"text.token_embedding.weight": r(text_cfg["vocab_size"], w),
               "text.positional_embedding": r(text_cfg["context_length"], w),
               **ln("text.ln_final", w), **dense("text.text_projection", w, embed_dim),
               "logit_scale": torch.tensor(2.3026), "logit_bias": torch.tensor(-10.0)})
    for i in range(LAYERS):
        b = f"text.transformer.resblocks.{i}."
        sd.update({**ln(b + "ln_1", w), b + "attn.in_proj_weight": r(3 * w, w),
                   b + "attn.in_proj_bias": r(3 * w), **dense(b + "attn.out_proj", w, w),
                   **ln(b + "ln_2", w), **dense(b + "mlp.c_fc", w, hidden),
                   **dense(b + "mlp.c_proj", hidden, w)})
    return sd


def test_released_open_clip_layout_loads_strictly(cut_depth, tmp_path):
    """ViT-SO400M-14-SigLIP at 2 layers a tower: a checkpoint in the
    released layout loads into the port with `strict=True` (through
    `create_model(pretrained=path)`, which drops the `text.` prefix) and
    into JAX through its importer; image and text features, logits and the
    logit bias agree to 1e-4 in fp32."""
    name = "ViT-SO400M-14-SigLIP"
    vision, text, side = _cut(name)
    sd = _released_layout(1152, 4304, 14, side, text, 1152)
    path = str(tmp_path / "open_clip_pytorch_model.bin")
    torch.save(sd, path)
    model = create_model(name, pretrained=path, device="cpu", attn_impl="fusedp",
                         vision_cfg=vision, text_cfg=text)
    loaded = model.state_dict()
    assert set(loaded) == {k.removeprefix("text.") for k in sd}
    for key, val in sd.items():
        assert torch.equal(loaded[key.removeprefix("text.")], val), key
    jm, jv = jax_create_model(name, pretrained=path, scan_layers=False, attn_impl="xla",
                              vision_cfg=vision, text_cfg=text)
    assert "class_embedding" not in jv["params"]["visual"]

    rng = np.random.RandomState(1)
    images = rng.randn(2, side, side, 3).astype(np.float32)
    tokens = rng.randint(1, text["vocab_size"], (2, CTX)).astype(np.int32)
    want_logits, _ = jm.apply(jv, images, tokens, method=jm.get_logits)
    want = jm.apply(jv, images, tokens)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(tokens).long())
        got_logits, _ = model.get_logits(torch.from_numpy(images), torch.from_numpy(tokens))
    for key in ("image_features", "text_features"):
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-4, key
    assert got["logit_bias"].item() == float(want["logit_bias"]) == -10.0
    assert np.abs(got_logits.numpy() - np.asarray(want_logits)).max() < 1e-4


def test_three_fusedp_siglip_steps_at_head_width_72_match_jax(monkeypatch):
    """A narrow SO400M-like SigLIP model (vision 144 wide: 2 heads of 72,
    MLP int(144 * 4304 / 1152), 2 layers, 44 px in patches of 14, no CLS;
    text 144 wide: 2 heads of 72, non-causal, `last` pool, biased
    projection): 3 AdamW steps (lr 1e-4, wd 0.2) with the SigLIP sigmoid
    loss and its learned bias, both sides under `fusedp` (JAX's kernels in
    interpret mode, the port's plain versions), fp32: loss and grad norm
    per step to 1e-5 relative, parameters after the steps within 2e-5 (a
    fifth of one Adam step)."""
    for module in (jax_clip, port_clip):
        monkeypatch.setitem(module._TIMM_VIT_DIMS, "so400m", (144, 2, 2))
    name = "ViT-SO400M-14-SigLIP"
    text = dict(get_model_config(name)["text_cfg"], width=144, heads=2, layers=2,
                context_length=16, vocab_size=1000)
    kw = dict(vision_cfg=dict(get_model_config(name)["vision_cfg"], image_size=44),
              text_cfg=text, embed_dim=144)
    jm, jv = jax_create_model(name, scan_layers=False, attn_impl="xla", **kw)
    jm = jm.clone(attn_impl="fusedp")
    rng = np.random.RandomState(72)
    images = rng.randint(0, 256, (8, 44, 44, 3)).astype(np.uint8)
    tokens = rng.randint(1, 1000, (8, 16)).astype(np.int32)
    args = SimpleNamespace(siglip=True, loss_dist_impl="bidir", model=name)

    tx = jax_create_optimizer(lr=1e-4, wd=0.2)
    state = jax_create_train_state(jv, tx)
    step = jax_build_train_step(jm, jax_make_loss_apply(jax_create_loss(args)), tx, donate=False)
    jb = {"images": jax_normalize(jnp.asarray(images)), "tokens": jnp.asarray(tokens)}
    jax_metrics = []
    for i in range(STEPS):
        state, m = step(state, jb, jax.random.key(i))
        jax_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    jax_params = state_dict_from_flax(jax.device_get(state.params))

    model = create_model(name, pretrained=state_dict_from_flax(jax.device_get(jv["params"])),
                         device="cpu", attn_impl="fusedp", **kw)
    assert model.visual.trunk.blocks[0].attn.num_heads == 2  # 144 / 2 = 72 a head
    ptx = create_optimizer(lr=1e-4, wd=0.2)
    pstate = create_train_state(model, ptx)
    pstep = build_train_step(model, make_loss_apply(create_loss(args)), ptx)
    pb = {"images": normalize_images(torch.from_numpy(images)),
          "tokens": torch.from_numpy(tokens)}
    port_metrics = []
    for _ in range(STEPS):
        pstate, m = pstep(pstate, pb, torch.Generator().manual_seed(0))
        port_metrics.append((m["loss"].item(), m["grad_norm"].item()))
    for (jl, jn), (pl_, pn) in zip(jax_metrics, port_metrics):
        np.testing.assert_allclose(pl_, jl, rtol=1e-5)
        np.testing.assert_allclose(pn, jn, rtol=1e-5)
    assert port_metrics[-1][0] < port_metrics[0][0]  # it learns
    for key, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_params[key].numpy(), rtol=0,
                                   atol=2e-5, err_msg=key)
    assert pstate.params["visual.trunk.blocks.0.attn.qkv.weight"].shape == (432, 144)
    assert "logit_bias" in pstate.params
