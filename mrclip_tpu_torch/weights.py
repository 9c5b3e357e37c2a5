"""JAX-package parameters -> the port's state dict.

The port's own copy of the plain-ViT, EVA and text part of
`mrclip_tpu.hub.export_torch_state_dict`: it takes the Flax params of a
`mrclip_tpu` CLIP (a nested dict of arrays, unrolled `blocks_N` or
scan-stacked `blocks/block` with a leading layer axis) and returns the
open_clip-layout state dict that `mrclip_tpu_torch.models.CLIP` loads with
`strict=True`; an EVA02-B/L vision tower (one with SwiGLU MLPs) goes to the
`visual.trunk.*` timm layout, and so does an EVA02-E or EVA01-g tower when
`vision_layout` says so (its tree is a plain ViT's:
`vision_layout_from_config` reads the layout off the model config, as hub's
`_vision_layout_from_config` does), and a SigLIP tower (no CLS token),
as the inverse of `mrclip_tpu.convert.timm_vit_to_vision_params`, which hub's
export refuses. A plain ViT without `ln_pre` (CLIPA) has no `visual.ln_pre`,
and a text projection with a bias (a Dense) becomes
`text_projection.{weight,bias}`. A FastViT/MCi tower (MobileCLIP-S1/S2; hub's
export has no branch for it) keeps the Flax tree's names, with each
convolution's HWIO kernel `[K, K, in / groups, out]` as the torch weight
`[out, in / groups, K, K]` and its attention stage as
`visual.transformer.resblocks.N`. Like hub's export it takes a tree without
`text` or `logit_scale` (a lone vision tower's). Only numpy is needed: any
array with `__array__` works.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "vision_layout_from_config"]

# hub.export_torch_state_dict's `vision_layout` values: 'auto' reads the
# tree; 'timm_eva02' is the EVA02-B/L trunk (split q/k/v, SwiGLU), which
# 'auto' finds by its SwiGLU; 'timm_eva02_postnorm' the fused-qkv trunk of
# EVA02-E and EVA01-g (`attn.qkv`, `q_bias`, `v_bias`, `mlp.fc1/fc2`)
VISION_LAYOUTS = ("auto", "timm_eva02", "timm_eva02_postnorm")


def vision_layout_from_config(model_config: dict) -> str:
    """The `vision_layout` of a model config, by its timm tower name (the
    JAX package's `hub._vision_layout_from_config`): EVA02-E and EVA01-g
    trees cannot be told from a plain ViT's."""
    name = (model_config.get("vision_cfg") or {}).get("timm_model_name") or ""
    if name.startswith(("eva_giant", "eva02_enormous")):
        return "timm_eva02_postnorm"
    if name.startswith("eva02_"):
        return "timm_eva02"
    return "auto"


def _blocks(tower: dict) -> list:
    tr = tower["transformer"]
    stacked = tr.get("blocks", {}).get("block")
    if stacked is not None:
        n = len(np.asarray(stacked["ln_1"]["scale"]))
        return [_index(stacked, i) for i in range(n)]
    keys = sorted((k for k in tr if k.startswith("blocks_")), key=lambda k: int(k.split("_")[-1]))
    return [tr[k] for k in keys]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _split_swiglu(mlp: dict) -> dict:
    """A fused-gate SwiGLU mlp (`fc1`, kernel [.., D, 2H] = gate||value) in
    the split layout (`fc1_g`, `fc1_x`), as `mrclip_tpu.models.layers.
    split_swiglu_params` does; split subtrees pass through."""
    if "fc1" not in mlp:
        return mlp
    mlp = dict(mlp)
    gv = mlp.pop("fc1")
    gk, vk = np.split(np.asarray(gv["kernel"]), 2, axis=-1)
    gb, vb = np.split(np.asarray(gv["bias"]), 2, axis=-1)
    return dict(mlp, fc1_g={"kernel": gk, "bias": gb}, fc1_x={"kernel": vk, "bias": vb})


def state_dict_from_flax(params: dict, vision_layout: str = "auto") -> dict[str, torch.Tensor]:
    """Flax CLIP params -> {open_clip key: fp32 torch tensor}. `vision_layout`
    as hub's export takes it (`VISION_LAYOUTS`): pass
    `vision_layout_from_config(cfg)` for an EVA02-E or EVA01-g model."""
    if vision_layout not in VISION_LAYOUTS:
        raise ValueError(f"vision_layout={vision_layout!r} is not one of {VISION_LAYOUTS}")
    params = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}

    def put(key, val):
        sd[key] = torch.tensor(np.asarray(val, dtype=np.float32))  # a contiguous copy

    def put_ln(key, ln):
        put(key + ".weight", ln["scale"])
        put(key + ".bias", ln["bias"])

    def put_dense(key, dense):  # Flax kernel [in, out] -> torch weight [out, in]
        put(key + ".weight", np.asarray(dense["kernel"]).T)
        put(key + ".bias", dense["bias"])

    def put_blocks(tower, prefix):
        for i, blk in enumerate(_blocks(tower)):
            bp = f"{prefix}transformer.resblocks.{i}."
            put_ln(bp + "ln_1", blk["ln_1"])
            put_ln(bp + "ln_2", blk["ln_2"])
            put(bp + "attn.in_proj_weight", np.asarray(blk["attn"]["in_proj"]["kernel"]).T)
            put(bp + "attn.in_proj_bias", blk["attn"]["in_proj"]["bias"])
            put_dense(bp + "attn.out_proj", blk["attn"]["out_proj"])
            put_dense(bp + "mlp.c_fc", blk["mlp"]["c_fc"])
            put_dense(bp + "mlp.c_proj", blk["mlp"]["c_proj"])
            for ls in ("ls_1", "ls_2"):
                if ls in blk:
                    put(bp + f"{ls}.gamma", blk[ls]["gamma"])

    def put_eva02_trunk(vis, fused):  # hub.export_eva02_trunk (post_norm=fused)
        tp = "visual.trunk."
        put(tp + "cls_token", np.asarray(vis["class_embedding"]).reshape(1, 1, -1))
        put(tp + "pos_embed", np.asarray(vis["positional_embedding"])[None])
        put(tp + "patch_embed.proj.weight",
            np.asarray(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1))
        put(tp + "patch_embed.proj.bias", vis["conv1"]["bias"])
        for i, blk in enumerate(_blocks(vis)):
            bp = f"{tp}blocks.{i}."
            put_ln(bp + "norm1", blk["ln_1"])
            put_ln(bp + "norm2", blk["ln_2"])
            qkv_w = np.asarray(blk["attn"]["in_proj"]["kernel"]).T  # [3W, W]
            qb, _, vb = np.split(np.asarray(blk["attn"]["in_proj"]["bias"]), 3)  # k bias is 0
            if fused:  # EVA02-E, EVA01-g: one qkv weight, the q and v biases apart
                put(bp + "attn.qkv.weight", qkv_w)
                put(bp + "attn.q_bias", qb)
                put(bp + "attn.v_bias", vb)
                put_dense(bp + "mlp.fc1", blk["mlp"]["c_fc"])
                put_dense(bp + "mlp.fc2", blk["mlp"]["c_proj"])
            else:
                qw, kw, vw = np.split(qkv_w, 3, axis=0)
                put(bp + "attn.q_proj.weight", qw)
                put(bp + "attn.q_proj.bias", qb)
                put(bp + "attn.k_proj.weight", kw)
                put(bp + "attn.v_proj.weight", vw)
                put(bp + "attn.v_proj.bias", vb)
                put_ln(bp + "attn.norm", blk["attn"]["norm"])
                mlp = _split_swiglu(blk["mlp"])
                for name in ("fc1_g", "fc1_x", "fc2"):
                    put_dense(bp + f"mlp.{name}", mlp[name])
                put_ln(bp + "mlp.norm", mlp["norm"])
            put_dense(bp + "attn.proj", blk["attn"]["out_proj"])
        put_ln(tp + "norm", vis["ln_post"])
        put("visual.head.proj.weight", np.asarray(vis["proj"]).T)

    def put_siglip_trunk(vis):  # convert.timm_vit_to_vision_params, inverted
        tp = "visual.trunk."
        put(tp + "pos_embed", np.asarray(vis["positional_embedding"])[None])
        put(tp + "patch_embed.proj.weight",
            np.asarray(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1))
        put(tp + "patch_embed.proj.bias", vis["conv1"]["bias"])
        for i, blk in enumerate(_blocks(vis)):
            bp = f"{tp}blocks.{i}."
            put_ln(bp + "norm1", blk["ln_1"])
            put_ln(bp + "norm2", blk["ln_2"])
            put_dense(bp + "attn.qkv", blk["attn"]["in_proj"])
            put_dense(bp + "attn.proj", blk["attn"]["out_proj"])
            put_dense(bp + "mlp.fc1", blk["mlp"]["c_fc"])
            put_dense(bp + "mlp.fc2", blk["mlp"]["c_proj"])
        put_ln(tp + "norm", vis["ln_post"])
        pool = vis["attn_pool"]
        put(tp + "attn_pool.latent", pool["latent"])
        for name in ("q", "kv", "proj"):
            put_dense(f"{tp}attn_pool.{name}", pool[name])
        put_ln(tp + "attn_pool.norm", pool["norm"])
        put_dense(tp + "attn_pool.mlp.fc1", pool["mlp"]["c_fc"])
        put_dense(tp + "attn_pool.mlp.fc2", pool["mlp"]["c_proj"])

    def put_tree(key, tree):  # FastViT: Conv, Dense and LayerNorm subtrees by their leaves
        if "kernel" in tree:  # Conv HWIO -> [out, in / groups, K, K]; Dense [in, out] -> [out, in]
            k = np.asarray(tree["kernel"])
            put(key + ".weight", k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)
            put(key + ".bias", tree["bias"])
        elif "scale" in tree:
            put_ln(key, tree)
        else:
            for name, sub in tree.items():
                (put_tree if hasattr(sub, "items") else put)(f"{key}.{name}", sub)

    vis = params["visual"]
    if "stem_conv1" in vis:
        put_tree("visual", {k: v for k, v in vis.items() if k != "transformer"})
        put_blocks(vis, "visual.")
    elif "conv1" not in vis:
        raise NotImplementedError(
            "only the plain CLIP ViT, the SigLIP, the EVA and the FastViT/MCi towers convert "
            "(ROADMAP: modules item 5, the other towers)"
        )
    elif "class_embedding" not in vis:
        put_siglip_trunk(vis)
    elif vision_layout != "auto" or ((blocks := _blocks(vis)) and (
            "fc1_g" in blocks[0]["mlp"] or "fc1" in blocks[0]["mlp"])):
        put_eva02_trunk(vis, fused=vision_layout == "timm_eva02_postnorm")
    else:
        # [ph, pw, 3, W] -> open_clip conv layout [W, 3, ph, pw]
        put("visual.conv1.weight", np.asarray(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1))
        put("visual.class_embedding", vis["class_embedding"])
        put("visual.positional_embedding", vis["positional_embedding"])
        if "ln_pre" in vis:
            put_ln("visual.ln_pre", vis["ln_pre"])
        put_ln("visual.ln_post", vis["ln_post"])
        put("visual.proj", vis["proj"])
        put_blocks(vis, "visual.")

    txt = params.get("text")  # absent, as in hub's export, for a lone vision tower
    if txt is not None:
        if "token_embedding" not in txt:
            raise NotImplementedError(
                "only the open_clip text tower converts (ROADMAP: modules item 5, the other "
                "towers)"
            )
        put("token_embedding.weight", txt["token_embedding"]["embedding"])
        put("positional_embedding", txt["positional_embedding"])
        put_ln("ln_final", txt["ln_final"])
        if hasattr(txt["text_projection"], "items"):  # proj_bias: a Dense
            put_dense("text_projection", txt["text_projection"])
        else:
            put("text_projection", txt["text_projection"])
        put_blocks(txt, "")

    if "logit_scale" in params:
        put("logit_scale", np.asarray(params["logit_scale"]).reshape(()))
    if "logit_bias" in params:
        put("logit_bias", np.asarray(params["logit_bias"]).reshape(()))
    return sd
