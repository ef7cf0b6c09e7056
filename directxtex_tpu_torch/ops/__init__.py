"""Texture ops on torch tensors (the port's part of directxtex_tpu/ops):
sRGB conversion and the normal map's neighbourhood fetch."""
