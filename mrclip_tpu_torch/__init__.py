"""PyTorch/CUDA port of `mrclip_tpu` for NVIDIA Hopper (H100).

It serves the plain ViT + causal-text CLIP (e.g. ViT-B-16) over HTTP and
trains it with the multipositive contrastive loss (`create_loss`,
`parallel.create_optimizer`, `create_train_state`, `make_loss_apply`,
`build_train_step`), from MRI volumes through the preprocessing and
training CLIs (`python -m mrclip_tpu_torch.preprocessing`,
`python -m mrclip_tpu_torch.train.main`). Every attention layer can run
through the hand-written packed fused-attention kernels, forward and
backward (`ops/fused_attn.py`, `csrc/packed_attn_fwd.cu`,
`csrc/packed_attn_bwd.cu`), and the loss through the fused SupCon kernels
(`ops/pallas_loss.py`, `csrc/supcon_loss.cu`). The package imports torch
and never jax or `mrclip_tpu`, PIL or pandas. Entry points run on the CUDA
card unless the caller passes `device="cpu"`.

The names below load their module on first use, so that the preprocessing
CLI, which needs numpy alone, starts without importing torch.
"""

import importlib

_EXPORTS = {
    "DEFAULT_CONTEXT_LENGTH": "constants",
    "OPENAI_DATASET_MEAN": "constants",
    "OPENAI_DATASET_STD": "constants",
    "add_model_config": "factory",
    "create_loss": "factory",
    "create_model": "factory",
    "get_model_config": "factory",
    "list_models": "factory",
    "CLIP": "models",
    "CLIPTextCfg": "models",
    "CLIPVisionCfg": "models",
    "export_model": "serving",
    "load_exported": "serving",
    "save_exported": "serving",
    "SimpleTokenizer": "tokenizer",
    "decode": "tokenizer",
    "tokenize": "tokenizer",
    "state_dict_from_flax": "weights",
    "vision_layout_from_config": "weights",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
