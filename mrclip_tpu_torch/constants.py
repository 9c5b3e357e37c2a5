"""Normalization constants, the default context length and the canonical
file names (the port's copy of `mrclip_tpu/constants.py`)."""

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)

# MR-CLIP raised CLIP's 77 to 98 to fit the structured DICOM captions.
DEFAULT_CONTEXT_LENGTH = 98

# Checkpoint / config file names used by the factory and hub IO.
HF_WEIGHTS_NAME = "open_clip_pytorch_model.bin"
HF_SAFE_WEIGHTS_NAME = "open_clip_model.safetensors"
HF_CONFIG_NAME = "open_clip_config.json"
