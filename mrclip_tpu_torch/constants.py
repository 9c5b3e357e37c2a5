"""Normalization constants and the default context length (the port's copy
of `mrclip_tpu/constants.py`, limited to what the port uses)."""

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

# MR-CLIP raised CLIP's 77 to 98 to fit the structured DICOM captions.
DEFAULT_CONTEXT_LENGTH = 98
