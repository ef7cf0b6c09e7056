"""End-to-end texture pipelines (BASELINE.md configs)."""

from .pipelines import (asset_pipeline, bc_encode_pipeline,
                        hdr_cubemap_pipeline, mipped_compress_pipeline)

__all__ = ["asset_pipeline", "bc_encode_pipeline", "hdr_cubemap_pipeline",
           "mipped_compress_pipeline"]
