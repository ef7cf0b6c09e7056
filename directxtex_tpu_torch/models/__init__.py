"""End-to-end texture pipelines (BASELINE.md configs)."""

from .pipelines import bc_encode_pipeline, hdr_cubemap_pipeline

__all__ = ["bc_encode_pipeline", "hdr_cubemap_pipeline"]
