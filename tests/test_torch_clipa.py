"""The CLIPA configs and the two plain ViT configs added beside them
(ViT-B-16-plus-240, ViT-B-32-256) in the PyTorch port against the JAX
package.

Each config at its published widths with the depth cut to 2 layers a tower,
images of 3 patches plus 2 pixels a side (the patchify crops the remainder)
and 16 token ids (CLIPA's context is 32, the plain configs' 98): JAX's
params cross over through `state_dict_from_flax` into the port with
`strict=True`, and the same numpy-seeded images and tokens go through
JAX's `xla` attention and the port's attention options in fp32 (the kernel
wrappers on their plain versions on the CPU). CLIPA's vision tower has no
ln_pre, pools the mean of its patch rows and norms after the pool; its text
is non-causal and pools the last row; its head widths are 64, 80 and 104.
"""

import jax
import numpy as np
import pytest
import torch

from mrclip_tpu.factory import create_model as jax_create_model
from mrclip_tpu.factory import get_model_config as jax_get_model_config
from mrclip_tpu_torch import create_model, state_dict_from_flax
from mrclip_tpu_torch.factory import get_model_config
from mrclip_tpu_torch.models.layers import ATTN_IMPLS
from mrclip_tpu_torch.ops import fused_attn as fa

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

# name -> vision head width
CONFIGS = {"ViT-L-14-CLIPA": 64, "ViT-L-14-CLIPA-336": 64, "ViT-H-14-CLIPA": 80,
           "ViT-H-14-CLIPA-336": 80, "ViT-bigG-14-CLIPA": 104, "ViT-bigG-14-CLIPA-336": 104,
           "ViT-B-16-plus-240": 64, "ViT-B-32-256": 64}
CTX = 16


def _cut(name):
    cfg = get_model_config(name)
    side = 3 * cfg["vision_cfg"]["patch_size"] + 2
    return (dict(cfg["vision_cfg"], layers=2, image_size=side),
            dict(cfg["text_cfg"], layers=2, context_length=CTX), side)


def _features(name, attn_impls):
    """(JAX's features, {impl: the port's features}, the state dict)."""
    vision, text, side = _cut(name)
    jm, jv = jax_create_model(name, scan_layers=False, attn_impl="xla", vision_cfg=vision,
                              text_cfg=text)
    sd = state_dict_from_flax(jax.device_get(jv["params"]))
    rng = np.random.RandomState(side)
    images = rng.randn(2, side, side, 3).astype(np.float32)
    tokens = rng.randint(1, text["vocab_size"], (2, CTX)).astype(np.int32)
    want = jm.apply(jv, images, tokens)
    got = {}
    for impl in attn_impls:
        model = create_model(name, pretrained=sd, device="cpu", attn_impl=impl,
                             vision_cfg=vision, text_cfg=text)  # load_state_dict(strict=True)
        with torch.no_grad():
            got[impl] = model(torch.from_numpy(images), torch.from_numpy(tokens).long())
    return want, got, sd


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_matches_jax_at_full_width(name):
    """fp32: image and text features within 1e-4 of JAX's (`xla`), the
    port under `fusedp`, each parameter loaded strictly with JAX's shape;
    CLIPA has no `visual.ln_pre`, the plain configs have one."""
    cfg = get_model_config(name)
    assert cfg == jax_get_model_config(name)
    want, got, sd = _features(name, ["fusedp"])
    assert ("visual.ln_pre.weight" in sd) == ("CLIPA" not in name)
    width = cfg["vision_cfg"]["width"]
    assert cfg["vision_cfg"].get("head_width", 64) == CONFIGS[name]
    assert tuple(sd["visual.transformer.resblocks.0.attn.in_proj_weight"].shape) == (
        3 * width, width)
    for key in ("image_features", "text_features"):
        assert got["fusedp"][key].shape == want[key].shape == (2, cfg["embed_dim"])
        assert np.abs(got["fusedp"][key].numpy() - np.asarray(want[key])).max() < 1e-4, key
    assert fa.launches == 0  # the CPU ran the plain version


@pytest.mark.parametrize("name", ["ViT-H-14-CLIPA", "ViT-bigG-14-CLIPA-336"])
def test_clipa_under_every_attention_option(name):
    """CLIPA at head widths 80 and 104 under each of the six attention
    options: fp32 features within 1e-4 of JAX's `xla`."""
    want, got, _ = _features(name, ATTN_IMPLS)
    for impl, out in got.items():
        for key in ("image_features", "text_features"):
            assert np.abs(out[key].numpy() - np.asarray(want[key])).max() < 1e-4, (impl, key)
