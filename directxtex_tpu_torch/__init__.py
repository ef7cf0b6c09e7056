"""directxtex_tpu_torch — the PyTorch / CUDA port of directxtex_tpu.

The JAX package beside it is the reference; this package holds the same
functions on torch tensors, with the TPU's Pallas kernels rewritten as
hand-written CUDA kernels for Hopper (sm_90a). It has the BC7 default
tier on images with or without alpha, at any alpha weight (search,
MOMENT winner-refine, decode), the BC7 QUICK and MAXQUALITY tiers
(the maxq search, MOMENT then the exact LADDER_FULL refine), BC7
USE_3SUBSETS (modes 0 and 2) in either of those tiers, the BC6H
codec (decode, the shared-fit search, the mid and maxq refine tiers) and
BASELINE config 4 (models.pipelines.hdr_cubemap_pipeline). It imports
torch and numpy only, never jax.
"""

__version__ = "0.1.0"
