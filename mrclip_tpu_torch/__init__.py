"""PyTorch/CUDA port of `mrclip_tpu` for NVIDIA Hopper (H100).

This slice serves the plain ViT + causal-text CLIP (e.g. ViT-B-16) over
HTTP; every attention layer can run through the hand-written packed
fused-attention kernel (`ops/fused_attn.py`, `csrc/packed_attn_fwd.cu`).
The package imports torch and never jax or `mrclip_tpu`. Entry points run on
the CUDA card unless the caller passes `device="cpu"`.
"""

from .constants import DEFAULT_CONTEXT_LENGTH, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from .factory import add_model_config, create_model, get_model_config, list_models
from .models import CLIP, CLIPTextCfg, CLIPVisionCfg
from .serving import export_model, load_exported, save_exported
from .tokenizer import SimpleTokenizer, decode, tokenize
from .weights import state_dict_from_flax

__all__ = [
    "DEFAULT_CONTEXT_LENGTH",
    "OPENAI_DATASET_MEAN",
    "OPENAI_DATASET_STD",
    "CLIP",
    "CLIPTextCfg",
    "CLIPVisionCfg",
    "SimpleTokenizer",
    "add_model_config",
    "create_model",
    "decode",
    "export_model",
    "get_model_config",
    "list_models",
    "load_exported",
    "save_exported",
    "state_dict_from_flax",
    "tokenize",
]
