"""Reader of the JAX package's checkpoint file without flax or msgpack.

The JAX package's `training/checkpoint.py::Checkpointer.save` writes
``flax.serialization.to_bytes({"params", "opt_state", "step", "epoch"})``:
one msgpack object (flax 0.12's `msgpack_serialize`) in which

- every dict is a map with str keys; a tuple or list is a map keyed "0",
  "1", ...; a namedtuple (optax's ``ScaleByAdamState(count, mu, nu)``) a
  map keyed by its field names; an empty state (optax's ``EmptyState()``,
  an empty tuple) an empty map;
- an ndarray or jax.Array is ext type 1, whose payload is the msgpack of
  (shape, dtype name, C-order bytes); a numpy scalar ext type 3 with the
  same payload (a 0-d array);
- an array above 2**30 bytes is split: a map {"__msgpack_chunked_array__":
  True, "shape": {"0": ...}, "chunks": {"0": flat array, ...}};
- ``step`` and ``epoch`` are Python ints; None is nil.

`read_msgpack` decodes the whole msgpack format into dicts, lists, Python
scalars and numpy arrays, and reassembles chunked arrays. Anything it does
not decode (a reserved byte, an ext type no checkpoint holds, a dtype
outside `_DTYPES`, a key that is not a str, a duplicate key, a length past
the end, bytes after the object) raises `FlaxCheckpointError` naming the
file and the byte offset; it never returns a partial tree.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

#: the first byte of a msgpack map (fixmap, map 16, map 32); 0x80, the
#: empty fixmap, is left out: no checkpoint is an empty map, and it is the
#: first byte of a legacy (pre-zip) ``torch.save`` pickle
MAP_FIRST_BYTES = frozenset(range(0x81, 0x90)) | {0xDE, 0xDF}
_CHUNKED = "__msgpack_chunked_array__"
#: the dtype names `np.dtype(name)` reads the same everywhere; flax writes
#: ``arr.dtype.name``
_DTYPES = frozenset({
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64",
})
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class FlaxCheckpointError(ValueError):
    """A flax msgpack checkpoint that the reader does not decode."""


def is_flax_msgpack(head: bytes) -> bool:
    """Whether ``head`` (the file's first bytes) starts a msgpack map."""
    return len(head) > 0 and head[0] in MAP_FIRST_BYTES


class _Decoder:
    """One msgpack object from ``data[start:end]``; the offsets in its
    errors are positions in ``data``, the file's bytes (an ext payload is
    decoded by a decoder of its own over the same bytes)."""

    def __init__(self, data: memoryview, source: str, start: int = 0, end: int | None = None):
        self.data = data
        self.source = source
        self.pos = start
        self.end = len(data) if end is None else end

    def fail(self, at: int, what: str):
        raise FlaxCheckpointError(f"{self.source}: at byte {at}: {what}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > self.end:
            self.fail(self.pos, f"{n} bytes needed, {self.end - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        at = self.pos
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8 / 16 / 32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}  # str 8 / 16 / 32
        if b in sized:
            return self.text(self.unpack(sized[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), at)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b], at)
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8 / 16 / 32
        if b in sized:
            return self.ext(self.unpack(sized[b]), at)
        self.fail(at, f"byte 0x{b:02x} starts no msgpack object")

    def text(self, n: int) -> str:
        at = self.pos
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as exc:
            self.fail(at, f"a str that is not UTF-8 ({exc.reason})")

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if not isinstance(key, str):
                self.fail(key_at, f"a map key of type {type(key).__name__}; flax writes str keys")
            if key in out:
                self.fail(key_at, f"the key {key!r} twice in the map at byte {at}")
            out[key] = self.value()
        if _CHUNKED in out:
            return self.unchunk(out, at)
        return out

    def ext(self, n: int, at: int):
        code = self.unpack(">b")
        start = self.pos
        self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            self.fail(at, f"ext type {code}, which no checkpoint holds (1 ndarray, 3 numpy scalar)")
        arr = self.ndarray(start, start + n)
        return arr[()] if code == _EXT_NPSCALAR else arr

    def ndarray(self, start: int, end: int) -> np.ndarray:
        sub = _Decoder(self.data, self.source, start, end)
        head = sub.unpack(">B")
        if head != 0x93:  # fixarray of 3: (shape, dtype name, buffer)
            sub.fail(start, f"an ndarray payload starting 0x{head:02x}, not a 3-element array")
        shape = sub.value()
        if not (isinstance(shape, list) and all(isinstance(d, int) and not isinstance(d, bool)
                                                and d >= 0 for d in shape)):
            sub.fail(start + 1, f"an ndarray shape {shape!r}")
        name_at = sub.pos
        name = sub.value()
        if name not in _DTYPES:
            sub.fail(name_at, f"dtype {name!r}, which the reader does not decode")
        buf_at = sub.pos
        buf = sub.value()
        if not isinstance(buf, bytes):
            sub.fail(buf_at, f"an ndarray buffer of type {type(buf).__name__}")
        dtype = np.dtype(name)
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if len(buf) != want:
            sub.fail(buf_at, f"an ndarray buffer of {len(buf)} bytes for shape {shape} {name} ({want})")
        if sub.pos != end:
            sub.fail(sub.pos, f"{end - sub.pos} bytes after the ndarray payload")
        return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()

    def unchunk(self, d: dict, at: int) -> np.ndarray:
        """flax's `_unchunk`: the flat chunks, concatenated, in the shape."""
        shape, chunks = d.get("shape"), d.get("chunks")
        if set(d) != {_CHUNKED, "shape", "chunks"} or not isinstance(shape, dict) \
                or not isinstance(chunks, dict):
            self.fail(at, f"a chunked array with keys {sorted(d)}")
        dims = [shape.get(str(i)) for i in range(len(shape))]
        parts = [chunks.get(str(i)) for i in range(len(chunks))]
        if not all(isinstance(v, int) and v >= 0 for v in dims) \
                or not parts or not all(isinstance(p, np.ndarray) and p.ndim == 1 for p in parts) \
                or len({p.dtype for p in parts}) != 1:
            self.fail(at, "a chunked array whose shape or chunks flax did not write")
        flat = np.concatenate(parts)
        if flat.size != int(np.prod(dims, dtype=np.int64)):
            self.fail(at, f"chunks of {flat.size} elements for the shape {dims}")
        return flat.reshape(dims)


def read_msgpack(data: bytes, source: str = "<bytes>"):
    """The object that ``data`` holds, decoded as flax's
    `msgpack_restore` decodes it (chunked arrays reassembled)."""
    dec = _Decoder(memoryview(data), source)
    value = dec.value()
    if dec.pos != len(data):
        dec.fail(dec.pos, f"{len(data) - dec.pos} bytes after the msgpack object")
    return value


def flatten(tree: dict, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a tree of str-keyed dicts (empty dicts vanish)."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(flatten(value, name))
        else:
            flat[name] = value
    return flat


@dataclasses.dataclass
class FlaxCheckpoint:
    """The payload of a JAX package ``.ckpt``."""

    params: dict      # flat: "params/nerf/Dense_4/Dense_0/kernel" -> array
    opt_state: object  # the optimizer's tree, as `read_msgpack` decodes it
    step: int
    epoch: int


def read_flax_checkpoint(path: str) -> FlaxCheckpoint:
    """Read a ``.ckpt`` that the JAX package's `Checkpointer.save` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    if not is_flax_msgpack(data[:1]):
        raise FlaxCheckpointError(f"{path}: at byte 0: not a msgpack map "
                                  f"(starts {bytes(data[:4])!r})")
    payload = read_msgpack(data, path)
    missing = {"params", "opt_state", "step", "epoch"} - set(payload)
    if missing:
        raise FlaxCheckpointError(f"{path}: the payload has no {sorted(missing)} "
                                  f"(keys {sorted(payload)})")
    params = payload["params"]
    if not isinstance(params, dict):
        raise FlaxCheckpointError(f"{path}: params is a {type(params).__name__}, not a tree")
    flat = flatten(params)
    bad = sorted(k for k, v in flat.items() if not isinstance(v, np.ndarray))
    if bad:
        raise FlaxCheckpointError(f"{path}: params leaves that are no arrays: {bad}")
    for key in ("step", "epoch"):
        if not isinstance(payload[key], int) or isinstance(payload[key], bool):
            raise FlaxCheckpointError(f"{path}: {key} is {payload[key]!r}, not an int")
    return FlaxCheckpoint(flat, payload["opt_state"], payload["step"], payload["epoch"])
