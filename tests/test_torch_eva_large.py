"""EVA02-E-14, EVA02-E-14-plus, EVA01-g-14 and EVA01-g-14-plus (the fused-qkv
EVA towers, head dims 112 and 88) and EVA02-L-14 and EVA02-L-14-336 in the
PyTorch port against the JAX package (their configs' bytes are held in
tests/test_torch_package.py).

Each config at its published widths with the depth cut to 2 layers a tower
and 56 px images (4 x 4 patches of 14 and the class token). The JAX package
fixes an EVA tower's depth in `_build_timm_vit_tower`, so its
`VisionTransformer` is wrapped there to build 2 layers; the port's depth
comes from `models.clip._EVA_DIMS`. JAX params cross over through
`state_dict_from_flax` with the layout `vision_layout_from_config` reads off
the config (`timm_eva02_postnorm` for the fused-qkv towers, whose tree is a
plain ViT's) and load into the port with `strict=True`; the same
numpy-seeded images and tokens then go through JAX's `xla` attention and
the port's kernel paths (their plain versions on the CPU) in fp32. Then 3
`fusedp` train steps with the pallas loss on a narrow post-norm tower with
heads of 112, against JAX's.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.factory import create_loss as jax_create_loss
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.hub import export_torch_state_dict
from mrclip_tpu.models import clip as jax_clip
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu_torch import (create_loss, create_model, state_dict_from_flax,
                              vision_layout_from_config)
from mrclip_tpu_torch.factory import get_model_config, model_from_config
from mrclip_tpu_torch.models import clip
from mrclip_tpu_torch.ops import flash_attn as fl
from mrclip_tpu_torch.ops import fused_attn as fa
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                       make_loss_apply)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# name -> (vision size in clip._EVA_DIMS, vision head dim, MLP hidden width)
FUSED = {"EVA02-E-14": ("enormous", 112, 15360), "EVA02-E-14-plus": ("enormous", 112, 15360),
         "EVA01-g-14": ("giant", 88, 6144), "EVA01-g-14-plus": ("giant", 88, 6144)}
LAYERS = 2
STEPS = 3


@pytest.fixture
def cut(monkeypatch):
    """Both packages' EVA towers at LAYERS layers, or at the (width, layers,
    heads) given to the returned function."""
    jax_vt = jax_clip.VisionTransformer
    dims = {}

    def jax_tower(**kw):
        return jax_vt(**dict(kw, layers=LAYERS, **dims))

    monkeypatch.setattr(jax_clip, "VisionTransformer", jax_tower)
    for size, (w, _, h) in list(clip._EVA_DIMS.items()):
        monkeypatch.setitem(clip._EVA_DIMS, size, (w, LAYERS, h))

    def narrow(size, width, heads):
        dims.update(width=width, heads=heads)
        monkeypatch.setitem(clip._EVA_DIMS, size, (width, LAYERS, heads))

    return narrow


def _cfgs(name, image_size=56, context_length=16):
    cfg = get_model_config(name)
    return (dict(cfg["vision_cfg"], image_size=image_size),
            dict(cfg["text_cfg"], layers=LAYERS, context_length=context_length))


def _jax_model(name, seed, **kw):
    """(JAX module, variables) of `name` under `xla`, unrolled, its params
    drawn with numpy from `seed` on the shapes `jax.eval_shape` gives:
    uniform of std fan_in^-0.5 for each kernel and 0.02 for each vector,
    norm scales 1 + 0.1 u with u of std 1, biases included (the k third of
    the qkv bias too, which both packages leave out). JAX's own init takes
    tens of seconds on a billion-wide tower on the CPU."""
    built = {}

    def build():
        built["module"], variables = jax_create_model(name, scan_layers=False, attn_impl="xla",
                                                      **kw)
        return variables

    shapes = jax.eval_shape(build)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = (rng.random(leaf.shape, dtype=np.float32) - np.float32(0.5)) * np.float32(12 ** 0.5)
        if "scale" in jax.tree_util.keystr(path):
            return np.asarray(1 + 0.1 * x, np.float32)
        return np.asarray(x * (leaf.shape[0] ** -0.5 if len(leaf.shape) >= 2 else 0.02),
                          np.float32)

    return built["module"], jax.tree_util.tree_map_with_path(draw, shapes)


def _stack(params):
    """The unrolled tree with its `blocks_N` stacked on a leading layer axis
    under `blocks/block`, the layout of `scan_layers=True`."""

    def tower(t):
        tr = dict(t["transformer"])
        keys = sorted((k for k in tr if k.startswith("blocks_")), key=lambda k: int(k[7:]))
        blocks = [tr.pop(k) for k in keys]
        tr["blocks"] = {"block": jax.tree.map(lambda *x: np.stack(x), *blocks)}
        return dict(t, transformer=tr)

    return dict(params, visual=tower(params["visual"]), text=tower(params["text"]))


class attention_impl:
    """Within the block, every attention module of `model` runs `impl`."""

    def __init__(self, model, impl):
        self.mods = [m for m in model.modules() if hasattr(m, "attn_impl")]
        self.impl, self.saved = impl, [m.attn_impl for m in self.mods]

    def __enter__(self):
        for m in self.mods:
            m.attn_impl = self.impl

    def __exit__(self, *exc):
        for m, impl in zip(self.mods, self.saved):
            m.attn_impl = impl


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_qkv_config_matches_jax_at_full_width(cut, name):
    """The state dict equals hub's export (`timm_eva02_postnorm`) key for key
    and value for value, from the unrolled and the scanned tree, and loads
    strictly; fp32 image and text features within 1e-4 of JAX's `xla` under
    'fusedp', 'fused' and 'flash', each on its kernel's plain version."""
    size, d, hidden = FUSED[name]
    cfg = get_model_config(name)
    layout = vision_layout_from_config(cfg)
    assert layout == "timm_eva02_postnorm"
    vision, text = _cfgs(name)
    jm, jv = _jax_model(name, d, vision_cfg=vision, text_cfg=text)
    params = jv["params"]
    sd = state_dict_from_flax(params, vision_layout=layout)
    for tree in (params, _stack(params)):
        ref = export_torch_state_dict(tree, vision_layout=layout)
        got = sd if tree is params else state_dict_from_flax(tree, vision_layout=layout)
        assert set(got) == set(ref)
        assert all(val.dtype == torch.float32 for val in got.values())
        # bit for bit; hub writes the logit scale as [1], the port as []
        differ = [key for key, val in got.items() if val.numel() != ref[key].size
                  or not np.array_equal(val.numpy().reshape(ref[key].shape), ref[key])]
        assert not differ, differ
        del ref, got
    width = clip._EVA_DIMS[size][0]
    bp = "visual.trunk.blocks.1."
    assert tuple(sd[bp + "attn.qkv.weight"].shape) == (3 * width, width)
    assert tuple(sd[bp + "attn.q_bias"].shape) == tuple(sd[bp + "attn.v_bias"].shape) == (width,)
    assert tuple(sd[bp + "mlp.fc1.weight"].shape) == (hidden, width)
    assert not any("k_bias" in k or "k_proj" in k for k in sd)
    model = create_model(name, pretrained=sd, device="cpu", attn_impl="fusedp",
                         vision_cfg=vision, text_cfg=text)  # load_state_dict(strict=True)
    del sd
    block = model.visual.trunk.blocks[0]
    assert block.post_norm == (size == "enormous") and model.visual.rope is None
    assert width // block.attn.num_heads == d

    rng = np.random.RandomState(d)
    images = rng.randn(2, 56, 56, 3).astype(np.float32)
    tokens = rng.randint(1, 49408, (2, 16)).astype(np.int32)
    want = jax.jit(jm.apply)(jv, images, tokens)
    del jv
    fa.reset_launches()
    fl.reset_launches()
    for impl in ("fusedp", "fused", "flash"):
        with torch.no_grad(), attention_impl(model, impl):
            got = model(torch.from_numpy(images), torch.from_numpy(tokens).long())
        for key in ("image_features", "text_features"):
            assert got[key].shape == want[key].shape
            assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-4, (impl, key)
    assert fa.launches == fa.grouped_launches == fl.launches == 0  # the CPU ran the plain versions


@pytest.mark.parametrize("name,size", [("EVA02-L-14", 56), ("EVA02-L-14-336", 336)])
def test_eva02_large_matches_jax_at_full_width(cut, name, size):
    """fp32 features within 1e-4 of JAX's `xla`, the port under 'fusedp'
    (plain K2 and K1): at 56 px and at 336 px, where the 24 x 24 grid (N =
    577) takes the rope rescaled to the (16, 16) pretraining grid."""
    assert vision_layout_from_config(get_model_config(name)) == "timm_eva02"
    vision, text = _cfgs(name, image_size=size)
    jm, jv = _jax_model(name, size, vision_cfg=vision, text_cfg=text)
    sd = state_dict_from_flax(jv["params"], vision_layout="timm_eva02")
    model = create_model(name, pretrained=sd, device="cpu", attn_impl="fusedp",
                         vision_cfg=vision, text_cfg=text)
    assert model.visual.grid_size == (size // 14,) * 2 and model.visual.rope.shape == (
        (size // 14) ** 2 + 1, 128)
    rng = np.random.RandomState(size)
    images = rng.randn(1, size, size, 3).astype(np.float32)
    tokens = rng.randint(1, 49408, (1, 16)).astype(np.int32)
    want = jax.jit(jm.apply)(jv, images, tokens)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(tokens).long())
    for key in ("image_features", "text_features"):
        assert got[key].shape == want[key].shape == (1, 768)
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-4, key


def test_auto_layout_reads_a_fused_qkv_tree_as_a_plain_vit(cut):
    """`auto` reads a narrow EVA02-E tree as the plain ViT's it is, which the
    port's EVA02-E model refuses; the config's layout loads; an unknown
    layout raises."""
    cut("enormous", 224, 2)
    vision, text = _cfgs("EVA02-E-14", image_size=28, context_length=8)
    text.update(width=64, heads=1)
    kw = dict(vision_cfg=vision, text_cfg=text, embed_dim=64)
    params = _jax_model("EVA02-E-14", 0, **kw)[1]["params"]
    model = model_from_config(dict(get_model_config("EVA02-E-14"), **kw))
    plain = state_dict_from_flax(params)
    assert "visual.conv1.weight" in plain and not any(k.startswith("visual.trunk") for k in plain)
    with pytest.raises(RuntimeError, match="visual.trunk.blocks.0.attn.q_bias"):
        model.load_state_dict(plain, strict=True)
    model.load_state_dict(state_dict_from_flax(params, vision_layout="timm_eva02_postnorm"),
                          strict=True)
    with pytest.raises(ValueError, match="vision_layout"):
        state_dict_from_flax(params, vision_layout="timm")
    assert vision_layout_from_config(get_model_config("ViT-H-14")) == "auto"


def _loss_args():
    return SimpleNamespace(multipositiveloss=True, delta=0.5, pallas_loss=True, model="narrow",
                           gather_with_grad=True)


def test_three_fusedp_steps_on_a_post_norm_tower_at_head_width_112_match_jax(cut):
    """A narrow EVA02-E tower (width 224: 2 heads of 112, 2 post-norm layers,
    MLP int(224 * 15360 / 1792) = 1920, 56 px) and text tower (width 224: 2
    heads of 112): 3 AdamW steps (lr 1e-4, wd 0.2, bf16 first moment) with
    the pallas multipositive loss, both sides under `fusedp` (JAX's kernels
    in interpret mode, the port's plain versions), fp32, with
    tests/test_torch_eva02.py's bars: loss and grad norm per step to 1e-5
    relative, parameters after the steps within 2e-5."""
    cut("enormous", 224, 2)
    vision, _ = _cfgs("EVA02-E-14")
    text = dict(context_length=16, vocab_size=49408, width=224, heads=2, layers=2)
    kw = dict(vision_cfg=vision, text_cfg=text, embed_dim=64)
    jm, jv = _jax_model("EVA02-E-14", 112, **kw)
    jm = jm.clone(attn_impl="fusedp")
    rng = np.random.RandomState(112)
    images = rng.randint(0, 256, (8, 56, 56, 3)).astype(np.uint8)
    tokens = rng.randint(1, 49408, (8, 16)).astype(np.int32)
    labels = np.array([0, 1, 2, 0, 1, 0, 2, 2], np.int32)

    tx = jax_create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    state = jax_create_train_state(jv, tx)
    step = jax_build_train_step(jm, jax_make_loss_apply(jax_create_loss(_loss_args())), tx,
                                donate=False)
    jb = {"images": jax_normalize(jnp.asarray(images)), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}
    jax_metrics = []
    for i in range(STEPS):
        state, m = step(state, jb, jax.random.key(i))
        jax_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    layout = "timm_eva02_postnorm"
    jax_params = state_dict_from_flax(jax.device_get(state.params), vision_layout=layout)

    model = create_model("EVA02-E-14", device="cpu", attn_impl="fusedp", **kw,
                         pretrained=state_dict_from_flax(jv["params"], vision_layout=layout))
    assert model.visual.trunk.blocks[1].mlp.fc1.weight.shape == (1920, 224)
    ptx = create_optimizer(lr=1e-4, wd=0.2, moments_dtype="bfloat16")
    pstate = create_train_state(model, ptx)
    pstep = build_train_step(model, make_loss_apply(create_loss(_loss_args())), ptx)
    pb = {"images": normalize_images(torch.from_numpy(images)),
          "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    port_metrics = []
    for _ in range(STEPS):
        pstate, m = pstep(pstate, pb, torch.Generator().manual_seed(0))
        port_metrics.append((m["loss"].item(), m["grad_norm"].item()))
    for (jl, jn), (pl_, pn) in zip(jax_metrics, port_metrics):
        np.testing.assert_allclose(pl_, jl, rtol=1e-5)
        np.testing.assert_allclose(pn, jn, rtol=1e-5)
    assert port_metrics[-1][0] < port_metrics[0][0]  # it learns
    assert set(pstate.params) == set(jax_params)
    for name, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_params[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
