"""Error taxonomy mirroring the reference's HRESULT surface (SURVEY.md §5).

A verbatim copy of directxtex_tpu/utils/errors.py (tests/test_torch_formats.py
pins it equal).

The reference returns HRESULTs (DirectXTexP.h:210-234); Python raises typed
exceptions so callers can distinguish the same cases:

    HRESULT_E_NOT_SUPPORTED      -> TexNotSupportedError
    HRESULT_E_INVALID_DATA       -> TexInvalidDataError
    E_INVALIDARG                 -> TexInvalidArgError
    HRESULT_E_ARITHMETIC_OVERFLOW-> TexArithmeticOverflowError
    E_ABORT (statusCallBack)     -> TexAbortError

All derive from ValueError so existing `except ValueError` call sites keep
working.
"""

from __future__ import annotations


class TexNotSupportedError(ValueError):
    """The format/operation combination is not supported."""


class TexInvalidDataError(ValueError):
    """The container or block data is malformed."""


class TexInvalidArgError(ValueError):
    """An argument is out of range or inconsistent."""


class TexArithmeticOverflowError(ValueError):
    """A size computation overflowed sane limits (CP_FLAGS_LIMIT_4GB etc.)."""


class TexAbortError(RuntimeError):
    """A status callback requested cancellation (ConvertEx/CompressEx)."""
