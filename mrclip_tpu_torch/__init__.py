"""PyTorch/CUDA port of `mrclip_tpu` for NVIDIA Hopper (H100).

It serves the plain ViT + causal-text CLIP (e.g. ViT-B-16) over HTTP and
trains it with the multipositive contrastive loss (`create_loss`,
`parallel.create_optimizer`, `create_train_state`, `make_loss_apply`,
`build_train_step`). Every attention layer can run through the hand-written
packed fused-attention kernels, forward and backward (`ops/fused_attn.py`,
`csrc/packed_attn_fwd.cu`, `csrc/packed_attn_bwd.cu`), and the loss through
the fused SupCon kernels (`ops/pallas_loss.py`, `csrc/supcon_loss.cu`).
The package imports torch and never jax or `mrclip_tpu`. Entry points run on
the CUDA card unless the caller passes `device="cpu"`.
"""

from .constants import DEFAULT_CONTEXT_LENGTH, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from .factory import add_model_config, create_loss, create_model, get_model_config, list_models
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
    "create_loss",
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
