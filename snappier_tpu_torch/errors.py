"""Exception types for the codec.

The reference maps all malformed-input conditions to
``System.IO.InvalidDataException`` (see ``Snappier/Internal/ThrowHelper.cs``
and the corrupt-data tests in ``Snappier.Tests/SnappyTests.cs:244-331``).
We mirror that with a small hierarchy.
"""

from __future__ import annotations


class SnappyError(Exception):
    """Base class for all codec errors."""


class InvalidDataError(SnappyError):
    """The compressed input is malformed (bad tag, offset, length, CRC,
    truncation, or framing violation). Equivalent of the reference's
    ``InvalidDataException``."""


class BufferTooSmallError(SnappyError):
    """The caller-supplied output buffer cannot hold the result.
    Equivalent of the reference's ``ArgumentException`` on undersized
    destinations (``Snappy.cs:37-55``)."""


class InvalidOperationError(SnappyError):
    """API misuse (wrong stream mode, overlapping buffers, reuse after
    close). Equivalent of ``InvalidOperationException`` /
    ``ArgumentException`` paths in the reference."""
