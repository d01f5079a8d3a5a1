"""A minimal protocol-buffers wire-format writer and reader, in Python and
numpy (the counterpart of ``export/flatbuf.py`` for the SavedModel).

A TF SavedModel's ``saved_model.pb`` is one protobuf message, and neither
the ``protobuf`` package nor TensorFlow is on the card's machine; this
module covers what a SavedModel needs of the format
(https://protobuf.dev/programming-guides/encoding/):

* a record is a tag (``field << 3 | wire type``, a varint) and a value:
  a varint (type 0), 8 little-endian bytes (1), a length-delimited run of
  bytes (2: strings, bytes, nested messages, packed repeated scalars) or
  4 little-endian bytes (5: ``float``, ``fixed32``);
* a negative ``int32``/``int64`` is the varint of its 64-bit two's
  complement (ten bytes); ``sint32``/``sint64`` are zigzag-encoded;
* a ``map<K, V>`` is a repeated message of ``key = 1`` and ``value = 2``.

The writer keeps a message as a list of chunks and the sum of their
lengths, so a nested message is framed without being joined, and a
``bytes`` field takes a numpy array's buffer as it is: a weight is copied
once, when the file is written (:meth:`Message.write_to`).

The reader walks a ``bytes``/``memoryview`` in place: :func:`parse` gives
each field's records, a length-delimited one as a ``memoryview`` of the
buffer (a weight's bytes come back with no copy), to be parsed again where
it is a nested message.
"""

from __future__ import annotations

import struct

import numpy as np

VARINT, FIXED64, LENGTH, FIXED32 = 0, 1, 2, 5
_U64 = (1 << 64) - 1


def varint(n: int) -> bytes:
    """The varint of ``n``; a negative ``n`` as its 64-bit two's
    complement, as protobuf writes a negative ``int32``/``int64``."""
    n = int(n)
    if n < 0:
        n &= _U64
    out = bytearray()
    while True:
        low = n & 0x7F
        n >>= 7
        if n:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def zigzag(n: int) -> int:
    """``sint64``'s encoding: 0, -1, 1, -2, ... -> 0, 1, 2, 3, ..."""
    n = int(n)
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def signed(n: int) -> int:
    """A varint read back as a two's-complement ``int64`` (an ``int32``
    is written sign-extended to 64 bits, so it reads back the same)."""
    n &= _U64
    return n - (1 << 64) if n >> 63 else n


def _tag(field: int, wire: int) -> bytes:
    return varint(field << 3 | wire)


class Message:
    """A message as it is built: append fields in any order (protobuf
    readers take them so; a repeated field is appended once a value)."""

    __slots__ = ("chunks", "size")

    def __init__(self):
        self.chunks: list = []
        self.size = 0

    def _put(self, data):
        self.chunks.append(data)
        self.size += len(data) if not isinstance(data, memoryview) \
            else data.nbytes

    def varint(self, field: int, value: int) -> "Message":
        self._put(_tag(field, VARINT) + varint(value))
        return self

    def bool(self, field: int, value: bool) -> "Message":
        return self.varint(field, int(bool(value)))

    def float(self, field: int, value: float) -> "Message":
        self._put(_tag(field, FIXED32) + struct.pack("<f", value))
        return self

    def bytes(self, field: int, data) -> "Message":
        """A length-delimited field: ``str`` (as UTF-8), ``bytes``, or a
        numpy array whose buffer is taken as it is (no copy here)."""
        if isinstance(data, str):
            data = data.encode()
        elif isinstance(data, np.ndarray):
            data = memoryview(np.ascontiguousarray(data)).cast("B")
        n = len(data) if not isinstance(data, memoryview) else data.nbytes
        self._put(_tag(field, LENGTH) + varint(n))
        if n:
            self._put(data)
        return self

    def message(self, field: int, msg: "Message") -> "Message":
        """A nested message, framed without joining its chunks."""
        self._put(_tag(field, LENGTH) + varint(msg.size))
        self.chunks.extend(msg.chunks)
        self.size += msg.size
        return self

    def packed(self, field: int, values) -> "Message":
        """A packed repeated varint field (int32, int64, enum, bool)."""
        body = b"".join(varint(v) for v in values)
        if body:
            self._put(_tag(field, LENGTH) + varint(len(body)) + body)
        return self

    def entry(self, field: int, key: str, value: "Message") -> "Message":
        """One entry of a ``map<string, message>`` field."""
        return self.message(field, Message().bytes(1, key).message(2, value))

    def write_to(self, f) -> int:
        """Write the message to the binary file ``f``, chunk by chunk;
        returns the bytes written."""
        for c in self.chunks:
            f.write(c)
        return self.size

    def tobytes(self) -> bytes:
        return b"".join(bytes(c) for c in self.chunks)


# ---- the reader -------------------------------------------------------------

def _read_varint(buf, pos: int):
    n = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("a varint runs past the message")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 63:
            raise ValueError("a varint longer than ten bytes")


def parse(buf) -> dict[int, list]:
    """The records of one message: ``{field: [value, ...]}`` in file
    order, a varint as an ``int`` (unsigned: see :func:`signed`), a
    length-delimited value as a ``memoryview`` of ``buf``, a fixed one as
    its raw bytes."""
    mv = memoryview(buf).cast("B")
    out: dict[int, list] = {}
    pos, end = 0, mv.nbytes
    while pos < end:
        key, pos = _read_varint(mv, pos)
        field, wire = key >> 3, key & 7
        if wire == VARINT:
            value, pos = _read_varint(mv, pos)
        elif wire in (LENGTH, FIXED32, FIXED64):
            n = 4 if wire == FIXED32 else 8
            if wire == LENGTH:
                n, pos = _read_varint(mv, pos)
            if pos + n > end:
                raise ValueError(f"field {field} runs past the message")
            value, pos = mv[pos:pos + n], pos + n
            if wire != LENGTH:
                value = bytes(value)
        else:
            raise ValueError(f"wire type {wire} (field {field}) is not read "
                             "here (groups are deprecated)")
        out.setdefault(field, []).append(value)
    return out


class Fields:
    """A parsed message with typed accessors; an absent field reads as
    its default."""

    __slots__ = ("f",)

    def __init__(self, buf):
        self.f = parse(buf)

    def has(self, field: int) -> bool:
        return field in self.f

    def int(self, field: int, default: int = 0) -> int:
        v = self.f.get(field)
        return signed(v[-1]) if v else default

    def bool(self, field: int) -> bool:
        return bool(self.int(field))

    def float(self, field: int, default: float = 0.0) -> float:
        v = self.f.get(field)
        return struct.unpack("<f", v[-1])[0] if v else default

    def bytes(self, field: int) -> memoryview:
        v = self.f.get(field)
        return v[-1] if v else memoryview(b"")

    def str(self, field: int) -> str:
        return bytes(self.bytes(field)).decode()

    def strs(self, field: int) -> list[str]:
        return [bytes(v).decode() for v in self.f.get(field, [])]

    def message(self, field: int) -> "Fields | None":
        v = self.f.get(field)
        return Fields(v[-1]) if v else None

    def messages(self, field: int) -> list["Fields"]:
        return [Fields(v) for v in self.f.get(field, [])]

    def ints(self, field: int) -> list[int]:
        """A repeated integer field, packed or not."""
        out = []
        for v in self.f.get(field, []):
            if isinstance(v, int):
                out.append(signed(v))
                continue
            pos = 0
            while pos < v.nbytes:
                n, pos = _read_varint(v, pos)
                out.append(signed(n))
        return out

    def map(self, field: int) -> dict[str, "Fields"]:
        """A ``map<string, message>`` field."""
        out = {}
        for v in self.f.get(field, []):
            e = Fields(v)
            out[e.str(1)] = Fields(e.bytes(2))
        return out
