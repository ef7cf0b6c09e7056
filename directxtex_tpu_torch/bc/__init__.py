"""BC1-BC7 block compression on torch tensors, batched over blocks."""

from . import bc45, bc6h, bc67, bc123
from .common import blocks_to_image, image_to_blocks

__all__ = ["bc123", "bc45", "bc6h", "bc67", "blocks_to_image",
           "image_to_blocks"]
