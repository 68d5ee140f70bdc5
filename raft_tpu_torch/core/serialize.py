"""numpy-format array serialization, hardened (port of
``raft_tpu.core.serialize``, byte for byte).

Arrays go out in the numpy ``.npy`` wire format through
:func:`numpy.lib.format.write_array`; a tensor is written as
``np.ascontiguousarray(t.detach().cpu().numpy())``, so its header is the
one the JAX package writes for the same array (a transposed view would
otherwise say ``fortran_order: True``).  Scalars carry the ``RTSC`` tag
and their dtype string.  Index serializers wrap their whole payload in the
versioned envelope (magic ``RTIE``, format version 1, payload length,
CRC32: ``<4sHQI``), so a torn or bit-flipped index file raises
:class:`CorruptIndexError`, never loads as garbage arrays; every reader
detects short reads and names the record and its byte offset.  A stream
written by either package reads in the other.

Every record written or read passes the fault sites ``serialize.write`` /
``serialize.read`` (:mod:`raft_tpu_torch.resilience.faults`).
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import BinaryIO

import numpy as np
import torch
from numpy.lib import format as npy_format

from raft_tpu_torch.resilience import faults as _faults

_SCALAR_MAGIC = b"RTSC"

_ENVELOPE_MAGIC = b"RTIE"
_ENVELOPE_VERSION = 1
# magic | u16 envelope version | u64 payload bytes | u32 crc32(payload)
_ENVELOPE_HEADER = struct.Struct("<4sHQI")


class CorruptIndexError(ValueError):
    """A serialized index / checkpoint stream is truncated or corrupted
    (bad magic, short read, CRC mismatch).  A ``ValueError``, as in the
    reference."""


def _tell(stream: BinaryIO) -> int:
    try:
        return stream.tell()
    except (OSError, AttributeError):
        return -1


def _offset(off: int) -> str:
    return f"at byte offset {off}" if off >= 0 else "at unknown offset"


def _read_exact(stream: BinaryIO, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`CorruptIndexError`
    naming the record and offsets (short-read detection)."""
    off = _tell(stream)
    try:
        data = stream.read(n)
    except (OverflowError, MemoryError) as e:
        # a corrupt length field (e.g. its top bit flipped) asks for more
        # bytes than a read can hold
        raise CorruptIndexError(
            f"corrupt stream: {what} of {n} bytes {_offset(off)} cannot "
            f"be read: {e}") from e
    if data is None or len(data) != n:
        got = 0 if data is None else len(data)
        raise CorruptIndexError(
            f"corrupt stream: short read of {what} {_offset(off)} "
            f"(wanted {n} bytes, got {got})")
    return data


def _host(arr) -> np.ndarray:
    """The numpy array written for ``arr``: a tensor's C-contiguous host
    copy, anything else as ``np.asarray`` gives it."""
    if isinstance(arr, torch.Tensor):
        return np.ascontiguousarray(arr.detach().cpu().numpy())
    return np.asarray(arr)


def serialize_mdspan(res, stream: BinaryIO, arr) -> None:
    """Write an array (tensor or numpy) in ``.npy`` format."""
    _faults.maybe_fail("serialize.write")
    npy_format.write_array(stream, _host(arr), allow_pickle=False)


def deserialize_mdspan(res, stream: BinaryIO) -> np.ndarray:
    """Read an array in ``.npy`` format, as numpy.  Truncated headers or
    data regions raise :class:`CorruptIndexError` with the record's start
    offset."""
    _faults.maybe_fail("serialize.read")
    off = _tell(stream)
    try:
        return npy_format.read_array(stream, allow_pickle=False)
    except (ValueError, OSError, EOFError, struct.error) as e:
        raise CorruptIndexError(
            f"corrupt stream: bad/truncated array record starting "
            f"{_offset(off)}: {e}") from e


def serialize_scalar(res, stream: BinaryIO, value) -> None:
    """Write one scalar with a dtype tag."""
    _faults.maybe_fail("serialize.write")
    arr = _host(value)
    dt = arr.dtype.str.encode()
    stream.write(_SCALAR_MAGIC)
    stream.write(struct.pack("<B", len(dt)))
    stream.write(dt)
    stream.write(arr.tobytes())


def deserialize_scalar(res, stream: BinaryIO):
    _faults.maybe_fail("serialize.read")
    off = _tell(stream)
    magic = _read_exact(stream, 4, "scalar magic")
    if magic != _SCALAR_MAGIC:
        raise CorruptIndexError(
            f"corrupt scalar stream: bad magic {magic!r} {_offset(off)}")
    (n,) = struct.unpack("<B", _read_exact(stream, 1, "scalar dtype length"))
    try:
        dtype = np.dtype(_read_exact(stream, n, "scalar dtype tag").decode())
    except (TypeError, ValueError, UnicodeDecodeError) as e:
        raise CorruptIndexError(
            f"corrupt scalar stream: bad dtype tag {_offset(off)}: "
            f"{e}") from e
    payload = _read_exact(stream, dtype.itemsize,
                          f"scalar payload ({dtype.str})")
    return np.frombuffer(payload, dtype=dtype)[0]


# ---------------------------------------------------------------------------
# versioned integrity envelope (index serializers + build checkpoints)
# ---------------------------------------------------------------------------

def write_envelope(stream: BinaryIO, payload: bytes) -> None:
    """Wrap ``payload`` with magic + format version + length + CRC32."""
    _faults.maybe_fail("serialize.write")
    stream.write(_ENVELOPE_HEADER.pack(_ENVELOPE_MAGIC, _ENVELOPE_VERSION,
                                       len(payload),
                                       zlib.crc32(payload) & 0xFFFFFFFF))
    stream.write(payload)


def read_envelope(stream: BinaryIO) -> bytes:
    """Read and verify an envelope; returns the payload bytes.  Bad magic,
    an unknown version, a short payload or a CRC mismatch raise
    :class:`CorruptIndexError`."""
    _faults.maybe_fail("serialize.read")
    off = _tell(stream)
    header = _read_exact(stream, _ENVELOPE_HEADER.size, "envelope header")
    magic, version, length, crc = _ENVELOPE_HEADER.unpack(header)
    if magic != _ENVELOPE_MAGIC:
        raise CorruptIndexError(
            f"corrupt stream: bad envelope magic {magic!r} {_offset(off)} "
            "(not a raft_tpu index/checkpoint, or written by a "
            "pre-envelope version)")
    if version != _ENVELOPE_VERSION:
        raise CorruptIndexError(
            f"unsupported envelope version {version} {_offset(off)} "
            f"(expected {_ENVELOPE_VERSION})")
    payload = _read_exact(stream, length, f"envelope payload ({length} B)")
    actual = zlib.crc32(payload) & 0xFFFFFFFF
    if actual != crc:
        raise CorruptIndexError(
            f"corrupt stream: payload CRC mismatch {_offset(off)} "
            f"(stored {crc:#010x}, computed {actual:#010x})")
    return payload


class enveloped_writer:
    """``with enveloped_writer(stream) as body:`` — serialize records into
    ``body``; one CRC-sealed envelope is emitted on clean exit."""

    def __init__(self, stream: BinaryIO) -> None:
        self._stream = stream
        self._body = io.BytesIO()

    def __enter__(self) -> BinaryIO:
        return self._body

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            write_envelope(self._stream, self._body.getvalue())


def open_envelope(stream: BinaryIO) -> BinaryIO:
    """Verify the envelope at ``stream`` and return the payload as a
    readable buffer for record-level deserializers."""
    return io.BytesIO(read_envelope(stream))
