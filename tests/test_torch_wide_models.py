"""ViT-H-14, ViT-g-14 and ViT-bigG-14 (head dims 80, 88 and 104) in the
PyTorch port against the JAX package.

Each config at its published widths with the depth cut to 2 layers a tower
and 56 px images (4 x 4 patches of 14 and the class token): JAX's params
cross over through `state_dict_from_flax` into the port with `strict=True`,
and the same numpy-seeded images and tokens go through JAX's `xla`
attention and the port's `fusedp` (its K1 wrapper on the plain version on
the CPU) in fp32. Then a 3-step `fusedp` train step with the pallas loss at
a narrow width with head_width 80 against JAX's, as
tests/test_torch_train_step.py runs ViT-B-32-mini at 32 and 64.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrclip_tpu.factory import create_loss as jax_create_loss
from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.factory import get_model_config as jax_get_model_config
from mrclip_tpu.ops.image_ops import normalize_images as jax_normalize
from mrclip_tpu.parallel import build_train_step as jax_build_train_step
from mrclip_tpu.parallel import create_optimizer as jax_create_optimizer
from mrclip_tpu.parallel import create_train_state as jax_create_train_state
from mrclip_tpu.parallel import make_loss_apply as jax_make_loss_apply
from mrclip_tpu_torch import create_loss, create_model, state_dict_from_flax
from mrclip_tpu_torch.factory import get_model_config
from mrclip_tpu_torch.ops import fused_attn as fa
from mrclip_tpu_torch.ops.image_ops import normalize_images
from mrclip_tpu_torch.parallel import (build_train_step, create_optimizer, create_train_state,
                                       make_loss_apply)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# name -> (vision head dim, MLP hidden width: int(width * mlp_ratio), as JAX)
WIDE = {"ViT-H-14": (80, 5120), "ViT-g-14": (88, 6144), "ViT-bigG-14": (104, 8192)}
STEPS = 3


def _cut(name, layers=2, image_size=56, context_length=16):
    """The config's towers at their published widths, depth and size cut."""
    cfg = get_model_config(name)
    return (dict(cfg["vision_cfg"], layers=layers, image_size=image_size),
            dict(cfg["text_cfg"], layers=layers, context_length=context_length))


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_config_matches_jax_at_full_width(name):
    """fp32: image and text features within 1e-4 of JAX's (`xla`), the port
    under `fusedp` at the config's head dim; every parameter loads strictly
    with JAX's shape, the MLP at JAX's hidden width."""
    d, hidden = WIDE[name]
    vision, text = _cut(name)
    assert get_model_config(name) == jax_get_model_config(name)
    jm, jv = jax_create_model(name, scan_layers=False, attn_impl="xla", vision_cfg=vision,
                              text_cfg=text)
    sd = state_dict_from_flax(jax.device_get(jv["params"]))
    model = create_model(name, pretrained=sd, device="cpu", attn_impl="fusedp",
                         vision_cfg=vision, text_cfg=text)  # load_state_dict(strict=True)
    for key, p in model.state_dict().items():
        assert tuple(p.shape) == tuple(sd[key].shape), key
    width = vision["width"]
    assert width // vision["head_width"] == 16 and vision["head_width"] == d
    assert tuple(sd["visual.transformer.resblocks.0.mlp.c_fc.weight"].shape) == (hidden, width)
    assert tuple(sd["visual.transformer.resblocks.1.mlp.c_proj.weight"].shape) == (width, hidden)

    rng = np.random.RandomState(d)
    images = rng.randn(2, 56, 56, 3).astype(np.float32)
    tokens = rng.randint(1, 49408, (2, 16)).astype(np.int32)
    want = jm.apply(jv, images, tokens)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(tokens).long())
    for key in ("image_features", "text_features"):
        assert got[key].shape == want[key].shape
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 1e-4, key
    assert fa.launches == 0  # the CPU ran the plain version


def _loss_args():
    return SimpleNamespace(multipositiveloss=True, delta=0.5, pallas_loss=True, model="narrow",
                           gather_with_grad=True)


def test_three_fusedp_steps_at_head_width_80_match_jax():
    """A narrow ViT-H-like tower (width 160: 2 heads of 80, 2 layers, 56 px
    in patches of 14) and text tower (width 160: 2 heads of 80): 3 AdamW
    steps (lr 1e-4, wd 0.2, bf16 first moment) with the pallas multipositive
    loss, both sides under `fusedp` (JAX's kernels in interpret mode, the
    port's plain versions), fp32: loss and grad norm per step to 1e-5
    relative, parameters after the steps within 2e-5 (a fifth of one Adam
    step)."""
    vision = dict(image_size=56, layers=2, width=160, head_width=80, patch_size=14)
    text = dict(context_length=16, vocab_size=49408, width=160, heads=2, layers=2)
    kw = dict(vision_cfg=vision, text_cfg=text, embed_dim=64)
    jm, jv = jax_create_model("ViT-H-14", scan_layers=False, attn_impl="xla", **kw)
    jm = jm.clone(attn_impl="fusedp")
    rng = np.random.RandomState(80)
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
    jax_params = state_dict_from_flax(jax.device_get(state.params))

    model = create_model("ViT-H-14", pretrained=state_dict_from_flax(jax.device_get(jv["params"])),
                         device="cpu", attn_impl="fusedp", **kw)
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
    for name, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_params[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
    w = pstate.params["visual.transformer.resblocks.0.attn.in_proj_weight"]
    assert w.shape == (480, 160)
