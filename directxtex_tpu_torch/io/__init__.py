"""Container I/O on torch tensors: DDS (the other loaders of the JAX
package's io/ are still to port, ROADMAP queue 1 item 6)."""

from .dds import (
    DDS_FLAGS, DDSMetaData, encode_dds_header, get_metadata_from_dds_memory,
    load_from_dds_file, load_from_dds_memory, save_to_dds_file,
    save_to_dds_memory,
)

__all__ = [
    "DDS_FLAGS", "DDSMetaData", "encode_dds_header",
    "get_metadata_from_dds_memory", "load_from_dds_file",
    "load_from_dds_memory", "save_to_dds_file", "save_to_dds_memory",
]
