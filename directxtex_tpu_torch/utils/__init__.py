"""Utilities: the error taxonomy and the default device (timing and
profiling are still to port, ROADMAP queue 1 item 9)."""

from .errors import (
    TexAbortError, TexArithmeticOverflowError, TexInvalidArgError,
    TexInvalidDataError, TexNotSupportedError,
)

__all__ = [
    "TexAbortError", "TexArithmeticOverflowError", "TexInvalidArgError",
    "TexInvalidDataError", "TexNotSupportedError",
]
