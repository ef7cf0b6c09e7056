"""Utilities: the error taxonomy, the default device, and timing and
profiling (timing.timed, timing.profile_trace)."""

from .errors import (
    TexAbortError, TexArithmeticOverflowError, TexInvalidArgError,
    TexInvalidDataError, TexNotSupportedError,
)
from .timing import profile_trace, timed

__all__ = [
    "TexAbortError", "TexArithmeticOverflowError", "TexInvalidArgError",
    "TexInvalidDataError", "TexNotSupportedError", "profile_trace", "timed",
]
