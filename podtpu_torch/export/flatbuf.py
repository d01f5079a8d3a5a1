"""A minimal FlatBuffers writer and reader, in Python and numpy.

The TFLite file format (``export/tflite.py``) is a FlatBuffers buffer, and
neither the ``flatbuffers`` package nor TensorFlow is on the card's
machine; this module covers what a TFLite model needs of the format
(https://flatbuffers.dev/internals/):

* tables, each with a vtable of 16-bit field offsets (a field absent from
  the vtable reads as its default);
* vectors of scalars, of tables and of strings, and strings;
* unions, which are two plain fields (a ``ubyte`` type and a table);
* everything little-endian; offsets to tables, vectors and strings are
  unsigned 32-bit and point forward.

The writer lays the buffer out front to back: an object is written before
the objects it refers to, with a placeholder patched once the child has its
place, so every offset points forward as the format requires. A vector of
scalars is a numpy array written with one ``tobytes()``, whatever its size
(a model's weights go in this way), its data aligned to ``align`` bytes.

The reader walks a ``bytes``/``memoryview`` in place: a vector of scalars
comes back as a numpy view of the buffer, with no copy.
"""

from __future__ import annotations

import struct

import numpy as np

# struct format of each scalar kind
_FMT = {"bool": "?", "int8": "b", "uint8": "B", "int16": "h", "uint16": "H",
        "int32": "i", "uint32": "I", "int64": "q", "uint64": "Q",
        "float32": "f", "float64": "d"}


class Scalar:
    """An inline field: ``kind`` is a key of ``_FMT``."""

    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value):
        self.kind, self.value = kind, value


class Vector:
    """A vector of scalars: a numpy array, its data aligned to ``align``."""

    __slots__ = ("array", "align")

    def __init__(self, array, dtype=None, align: int = 4):
        arr = np.asarray(array, dtype=dtype)
        if arr.ndim != 1:
            arr = arr.reshape(-1)
        self.array = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        self.align = max(align, arr.dtype.itemsize, 4)


class String:
    __slots__ = ("text",)

    def __init__(self, text: str):
        self.text = text


class Table:
    """A table: ``{slot: Scalar | Table | Vector | String | list}``, where a
    list is a vector of tables or strings; ``None`` leaves a slot out."""

    __slots__ = ("fields",)

    def __init__(self, fields: dict):
        self.fields = {s: v for s, v in fields.items() if v is not None}


def _pad_to(buf: bytearray, align: int, extra: int = 0):
    """Zero bytes until ``len(buf) + extra`` is a multiple of ``align``."""
    buf.extend(b"\0" * ((-(len(buf) + extra)) % align))


def serialize(root: Table, identifier: bytes = b"") -> bytearray:
    """The buffer of ``root``, with a 4-byte file identifier after the
    root offset when one is given."""
    if identifier and len(identifier) != 4:
        raise ValueError("a file identifier has 4 bytes")
    buf = bytearray(4 + len(identifier))
    buf[4:] = identifier
    pending = [(0, root)]  # (position of a uoffset to patch, its object)
    while pending:
        nxt = []
        for at, obj in pending:
            pos = _write(buf, obj, nxt)
            struct.pack_into("<I", buf, at, pos - at)
        pending = nxt
    return buf


def _write(buf: bytearray, obj, pending: list) -> int:
    """Append ``obj``; returns the position its offsets point at (a table's
    start, a vector's or string's length field)."""
    if isinstance(obj, Table):
        return _write_table(buf, obj, pending)
    if isinstance(obj, Vector):
        _pad_to(buf, obj.align, 4)
        pos = len(buf)
        buf.extend(struct.pack("<I", obj.array.size))
        buf.extend(obj.array.tobytes())
        return pos
    if isinstance(obj, String):
        data = obj.text.encode()
        _pad_to(buf, 4)
        pos = len(buf)
        buf.extend(struct.pack("<I", len(data)) + data + b"\0")
        return pos
    if isinstance(obj, list):  # a vector of tables or strings
        _pad_to(buf, 4)
        pos = len(buf)
        buf.extend(struct.pack("<I", len(obj)))
        for child in obj:
            pending.append((len(buf), child))
            buf.extend(b"\0\0\0\0")
        return pos
    raise TypeError(f"cannot write {type(obj).__name__}")


def _write_table(buf: bytearray, table: Table, pending: list) -> int:
    # inline layout: the soffset to the vtable, then the fields, widest
    # first so that each sits at its own alignment
    def size(v):
        return struct.calcsize("<" + _FMT[v.kind]) if isinstance(v, Scalar) \
            else 4

    slots = sorted(table.fields, key=lambda s: (-size(table.fields[s]), s))
    layout, off = {}, 4
    for s in slots:
        n = size(table.fields[s])
        off += (-off) % n
        layout[s] = off
        off += n
    inline = off
    align = max([4] + [size(table.fields[s]) for s in slots])
    n_slots = max(table.fields, default=-1) + 1
    vtable = struct.pack(f"<{2 + n_slots}H", 4 + 2 * n_slots, inline,
                         *[layout.get(s, 0) for s in range(n_slots)])
    # the vtable right before the table, the table at its alignment
    _pad_to(buf, align, len(vtable))
    vt_pos = len(buf)
    buf.extend(vtable)
    pos = len(buf)
    body = bytearray(inline)
    struct.pack_into("<i", body, 0, pos - vt_pos)
    for s, v in table.fields.items():
        if isinstance(v, Scalar):
            struct.pack_into("<" + _FMT[v.kind], body, layout[s], v.value)
        else:
            pending.append((pos + layout[s], v))
    buf.extend(body)
    return pos


class View:
    """A table of a FlatBuffers buffer, read in place."""

    __slots__ = ("buf", "pos", "_vt", "_vt_len")

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self._vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self._vt_len = struct.unpack_from("<H", buf, self._vt)[0]

    def _at(self, slot: int):
        """Absolute position of the field in ``slot``, or None if absent."""
        entry = 4 + 2 * slot
        if entry >= self._vt_len:
            return None
        off = struct.unpack_from("<H", self.buf, self._vt + entry)[0]
        return self.pos + off if off else None

    def _deref(self, at: int) -> int:
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def has(self, slot: int) -> bool:
        return self._at(slot) is not None

    def scalar(self, slot: int, kind: str, default=0):
        at = self._at(slot)
        if at is None:
            return default
        return struct.unpack_from("<" + _FMT[kind], self.buf, at)[0]

    def table(self, slot: int):
        at = self._at(slot)
        return None if at is None else View(self.buf, self._deref(at))

    def vector(self, slot: int, dtype):
        """A numpy view of a vector of scalars (``None`` if absent)."""
        at = self._at(slot)
        if at is None:
            return None
        vec = self._deref(at)
        n = struct.unpack_from("<I", self.buf, vec)[0]
        return np.frombuffer(self.buf, dtype=np.dtype(dtype).newbyteorder("<"),
                             count=n, offset=vec + 4)

    def tables(self, slot: int) -> list:
        at = self._at(slot)
        if at is None:
            return []
        vec = self._deref(at)
        n = struct.unpack_from("<I", self.buf, vec)[0]
        return [View(self.buf, self._deref(vec + 4 + 4 * i))
                for i in range(n)]

    def string(self, slot: int):
        at = self._at(slot)
        if at is None:
            return None
        s = self._deref(at)
        n = struct.unpack_from("<I", self.buf, s)[0]
        return bytes(self.buf[s + 4:s + 4 + n]).decode()


def root(buf, identifier: bytes = b"") -> View:
    """The root table of ``buf``; checks the file identifier if given."""
    if identifier and bytes(buf[4:8]) != identifier:
        raise ValueError(f"not a {identifier.decode()} buffer "
                         f"(identifier {bytes(buf[4:8])!r})")
    return View(buf, struct.unpack_from("<I", buf, 0)[0])
