"""Model towers of the port."""

from .clip import CLIP, CLIPTextCfg, CLIPVisionCfg
from .text import TextTransformer
from .vision import VisionTransformer

__all__ = ["CLIP", "CLIPTextCfg", "CLIPVisionCfg", "TextTransformer", "VisionTransformer"]
