"""BC6H and BC7 block compression on torch tensors, batched over blocks."""

from . import bc6h, bc67
from .common import blocks_to_image, image_to_blocks

__all__ = ["bc6h", "bc67", "blocks_to_image", "image_to_blocks"]
