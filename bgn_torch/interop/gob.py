"""A subset codec for Go's encoding/gob wire format.  The port's copy of
`bgn_tpu/interop/gob.py` (pure Python, no tensors).

The reference serializes every artifact with gob (ciphertexts at
ciphertext.go:76-116, public keys at bgn.go:595-666); this module encodes
and decodes exactly the wire subset those structs need:

  bool, int, uint, float64, string, []byte, slices, structs,
  and GobEncoder-opaque values (math/big.Int).

Wire format (per the encoding/gob package documentation):
  - stream = sequence of messages, each preceded by an unsigned byte count
  - unsigned int: < 128 -> one byte; else one byte holding -len(b) (as a
    byte, i.e. 256-len), then the minimal big-endian bytes b
  - signed int i: bit 0 = sign; i >= 0 -> u = i<<1, i < 0 -> u = ^i<<1 | 1
  - float64: math.Float64bits, byte-reversed, sent as unsigned
  - string / []byte: unsigned length + raw bytes
  - slice: unsigned count + elements
  - struct: (field-delta, value)* terminated by delta 0; field numbers
    start at -1 and deltas are strictly positive; zero-valued fields are
    omitted
  - type definition message: typeId < 0, then a wireType value (bootstrap
    schema below); value message: typeId > 0, then the value
  - user type ids are assigned from 65 upward in order of construction
    (outer struct before its field types); definitions are transmitted
    outer-first (encoding/gob sendActualType), so forward references
    occur and are resolved lazily on decode
  - GobEncoder values travel as a byte slice holding the type's own
    GobEncode output (for big.Int: one version<<1|sign byte then the
    magnitude bytes, big-endian)

The decoder is structural: it matches struct fields by name and ignores
type names (gob's own documented matching rule for non-interface values).

Verified against the worked `struct { X, Y int }{22, 33}` example in the
encoding/gob documentation (tests/test_interop.py::test_gob_point_example;
tests/test_torch_interop.py holds this copy to `bgn_tpu.interop.gob`).
"""

from __future__ import annotations

import struct as _struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Bootstrap (predefined) type ids, encoding/gob/type.go
BOOL = 1
INT = 2
UINT = 3
FLOAT = 4
BYTES = 5
STRING = 6
COMPLEX = 7
INTERFACE = 8
WIRE_TYPE = 16
ARRAY_TYPE = 17
COMMON_TYPE = 18
SLICE_TYPE = 19
STRUCT_TYPE = 20
FIELD_TYPE = 21
FIELD_TYPE_SLICE = 22
MAP_TYPE = 23

_FIRST_USER_ID = 65


# ---------------------------------------------------------------------------
# Primitive encoders
# ---------------------------------------------------------------------------


def encode_uint(u: int) -> bytes:
    if u < 0:
        raise ValueError("uint must be non-negative")
    if u < 128:
        return bytes([u])
    b = u.to_bytes((u.bit_length() + 7) // 8, "big")
    return bytes([256 - len(b)]) + b


def encode_int(i: int) -> bytes:
    if i >= 0:
        return encode_uint(i << 1)
    return encode_uint((~i << 1) | 1)


def encode_float(f: float) -> bytes:
    u = _struct.unpack("<Q", _struct.pack(">d", f))[0]  # byte-reverse
    return encode_uint(u)


def encode_bytes(b: bytes) -> bytes:
    return encode_uint(len(b)) + bytes(b)


def encode_string(s: str) -> bytes:
    return encode_bytes(s.encode("utf-8"))


def encode_bool(v: bool) -> bytes:
    return encode_uint(1 if v else 0)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("gob: unexpected end of stream")
        v = self.data[self.pos]
        self.pos += 1
        return v

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("gob: unexpected end of stream")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def uint(self) -> int:
        b0 = self.byte()
        if b0 < 128:
            return b0
        n = 256 - b0
        if n > 8:
            raise ValueError("gob: uint too large")
        return int.from_bytes(self.take(n), "big")

    def int_(self) -> int:
        u = self.uint()
        if u & 1:
            return ~(u >> 1)
        return u >> 1

    def float_(self) -> float:
        u = self.uint()
        return _struct.unpack(">d", _struct.pack("<Q", u))[0]

    def bytes_(self) -> bytes:
        return self.take(self.uint())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def eof(self) -> bool:
        return self.pos >= len(self.data)


# ---------------------------------------------------------------------------
# Type schema
# ---------------------------------------------------------------------------


@dataclass
class GobType:
    """A gob wire type: one of the kinds below.

    kind: 'bool'|'int'|'uint'|'float'|'bytes'|'string'|
          'slice'|'struct'|'gobencoder'
    """

    kind: str
    name: str = ""
    elem: Optional["GobType"] = None                  # slice
    fields: List[Tuple[str, "GobType"]] = field(default_factory=list)

    def zero(self):
        return {"bool": False, "int": 0, "uint": 0, "float": 0.0,
                "bytes": b"", "string": "", "slice": [],
                "gobencoder": b""}.get(self.kind, {})


def _is_zero(t: GobType, v) -> bool:
    """Go's zero-field omission rule, recursively for struct fields."""
    if t.kind == "struct":
        return all(
            _is_zero(ft, v.get(fn) if isinstance(v, dict)
                     else getattr(v, fn))
            for fn, ft in t.fields)
    if t.kind in ("bytes", "gobencoder"):
        return len(v) == 0
    return v == t.zero()


BOOL_T = GobType("bool")
INT_T = GobType("int")
UINT_T = GobType("uint")
FLOAT_T = GobType("float")
BYTES_T = GobType("bytes")
STRING_T = GobType("string")


def slice_of(elem: GobType, name: str = "") -> GobType:
    return GobType("slice", name=name, elem=elem)


def struct_of(name: str, fields: List[Tuple[str, GobType]]) -> GobType:
    return GobType("struct", name=name, fields=list(fields))


def gob_encoder_type(name: str) -> GobType:
    return GobType("gobencoder", name=name)


_BUILTIN_IDS = {
    "bool": BOOL, "int": INT, "uint": UINT, "float": FLOAT,
    "bytes": BYTES, "string": STRING,
}


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


class Encoder:
    """Produces a gob stream equivalent to Go's gob.NewEncoder(buf) for the
    supported subset.  One Encoder per stream (ids restart at 65, like a
    fresh gob.Encoder -- the reference creates one per Bytes() call)."""

    def __init__(self):
        self._next_id = _FIRST_USER_ID
        self._ids: Dict[int, int] = {}       # id(GobType) -> typeId
        self._sent: set = set()
        self._out = bytearray()

    # -- type id assignment (construction order: outer before fields,
    #    matching encoding/gob newTypeObject) --

    def _assign_ids(self, t: GobType):
        if t.kind in _BUILTIN_IDS or id(t) in self._ids:
            return
        self._ids[id(t)] = self._next_id
        self._next_id += 1
        if t.kind == "slice":
            self._assign_ids(t.elem)
        elif t.kind == "struct":
            for _, ft in t.fields:
                self._assign_ids(ft)

    def _type_id(self, t: GobType) -> int:
        if t.kind in _BUILTIN_IDS:
            return _BUILTIN_IDS[t.kind]
        return self._ids[id(t)]

    # -- wireType definition messages (outer first, then inner) --

    def _common_type(self, t: GobType) -> bytes:
        b = bytearray()
        if t.name:
            b += encode_uint(1) + encode_string(t.name)   # field 0: Name
            b += encode_uint(1)                           # field 1: Id
        else:
            b += encode_uint(2)                           # skip Name
        b += encode_int(self._type_id(t))
        b += encode_uint(0)
        return bytes(b)

    def _wire_type(self, t: GobType) -> bytes:
        # wireType fields: 0 ArrayT, 1 SliceT, 2 StructT, 3 MapT,
        # 4 GobEncoderT, 5 BinaryMarshalerT, 6 TextMarshalerT.
        # SliceType/StructType/gobEncoderType all embed CommonType as their
        # field 0, so each opens with a field-delta of 1 before the
        # CommonType body (cf. the worked Point example: `03 01 01 05 ...`).
        b = bytearray()
        if t.kind == "slice":
            b += encode_uint(2)                           # field 1: SliceT
            b += encode_uint(1) + self._common_type(t)    # field 0: CommonType
            # sliceType field 1: Elem
            b += encode_uint(1) + encode_int(self._type_id(t.elem))
            b += encode_uint(0)
        elif t.kind == "struct":
            b += encode_uint(3)                           # field 2: StructT
            b += encode_uint(1) + self._common_type(t)
            if t.fields:
                b += encode_uint(1)                       # field 1: Field
                b += encode_uint(len(t.fields))
                for fname, ft in t.fields:
                    fb = encode_uint(1) + encode_string(fname)
                    fb += encode_uint(1) + encode_int(self._type_id(ft))
                    fb += encode_uint(0)
                    b += fb
            b += encode_uint(0)
        elif t.kind == "gobencoder":
            b += encode_uint(5)                           # field 4: GobEncoderT
            b += encode_uint(1) + self._common_type(t)    # gobEncoderType =
            b += encode_uint(0)                           #   {CommonType}
        else:
            raise ValueError(f"no wireType for kind {t.kind}")
        b += encode_uint(0)                               # end wireType
        return bytes(b)

    def _send_type(self, t: GobType):
        if t.kind in _BUILTIN_IDS or id(t) in self._sent:
            return
        self._sent.add(id(t))
        msg = encode_int(-self._type_id(t)) + self._wire_type(t)
        self._out += encode_uint(len(msg)) + msg
        # inner types after the outer (sendActualType order)
        if t.kind == "slice":
            self._send_type(t.elem)
        elif t.kind == "struct":
            for _, ft in t.fields:
                self._send_type(ft)

    # -- values --

    def _encode_value(self, t: GobType, v) -> bytes:
        if t.kind == "bool":
            return encode_bool(bool(v))
        if t.kind == "int":
            return encode_int(int(v))
        if t.kind == "uint":
            return encode_uint(int(v))
        if t.kind == "float":
            return encode_float(float(v))
        if t.kind in ("bytes", "gobencoder"):
            return encode_bytes(bytes(v))
        if t.kind == "string":
            return encode_string(str(v))
        if t.kind == "slice":
            b = bytearray(encode_uint(len(v)))
            for e in v:
                b += self._encode_value(t.elem, e)
            return bytes(b)
        if t.kind == "struct":
            b = bytearray()
            prev = -1
            for i, (fname, ft) in enumerate(t.fields):
                fv = v.get(fname) if isinstance(v, dict) \
                    else getattr(v, fname)
                if fv is None or _is_zero(ft, fv):
                    continue                # zero fields are omitted
                b += encode_uint(i - prev)
                b += self._encode_value(ft, fv)
                prev = i
            b += encode_uint(0)
            return bytes(b)
        raise ValueError(f"cannot encode kind {t.kind}")

    def encode(self, t: GobType, value) -> bytes:
        """Append one top-level value (with any needed type definitions)
        and return the full stream so far."""
        if t.kind != "struct":
            raise ValueError("top-level gob values here are always structs")
        self._assign_ids(t)
        self._send_type(t)
        msg = encode_int(self._type_id(t)) + self._encode_value(t, value)
        self._out += encode_uint(len(msg)) + msg
        return bytes(self._out)


def dumps(t: GobType, value) -> bytes:
    """One-shot encode: fresh encoder (ids from 65), one value."""
    return Encoder().encode(t, value)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class _WireStruct:
    def __init__(self, name, fields):
        self.name = name
        self.fields = fields        # list of (name, typeid)


class _WireSlice:
    def __init__(self, name, elem):
        self.name = name
        self.elem = elem


class _WireGobEncoder:
    def __init__(self, name):
        self.name = name


def _parse_common(r: _Reader):
    name, tid = "", 0
    fieldnum = -1
    while True:
        delta = r.uint()
        if delta == 0:
            break
        fieldnum += delta
        if fieldnum == 0:
            name = r.string()
        elif fieldnum == 1:
            tid = r.int_()
        else:
            raise ValueError("gob: bad CommonType field")
    return name, tid


def _parse_wire_type(r: _Reader):
    """Parse a wireType value; returns (typeid, wire object)."""
    kind_field = None
    obj = None
    tid = 0
    fieldnum = -1
    while True:
        delta = r.uint()
        if delta == 0:
            break
        fieldnum += delta
        kind_field = fieldnum
        if fieldnum == 1:          # SliceT
            name = tid_ = None
            elem = 0
            inner = -1
            while True:
                d2 = r.uint()
                if d2 == 0:
                    break
                inner += d2
                if inner == 0:
                    name, tid_ = _parse_common_inline(r)
                elif inner == 1:
                    elem = r.int_()
                else:
                    raise ValueError("gob: bad SliceType field")
            tid = tid_
            obj = _WireSlice(name, elem)
        elif fieldnum == 2:        # StructT
            name = tid_ = None
            fields = []
            inner = -1
            while True:
                d2 = r.uint()
                if d2 == 0:
                    break
                inner += d2
                if inner == 0:
                    name, tid_ = _parse_common_inline(r)
                elif inner == 1:
                    n = r.uint()
                    for _ in range(n):
                        fields.append(_parse_field_type(r))
                else:
                    raise ValueError("gob: bad StructType field")
            tid = tid_
            obj = _WireStruct(name, fields)
        elif fieldnum == 4:        # GobEncoderT
            name, tid = _parse_common_struct(r)
            obj = _WireGobEncoder(name)
        elif fieldnum in (0, 3, 5, 6):   # ArrayT / MapT / marshalers
            raise ValueError(
                f"gob: unsupported wireType field {fieldnum}")
        else:
            raise ValueError(f"gob: unknown wireType field {fieldnum}")
    if obj is None:
        raise ValueError(f"gob: empty wireType (field {kind_field})")
    return tid, obj


def _parse_common_inline(r: _Reader):
    """CommonType transmitted as struct field 0 of its parent: the parent's
    delta has been consumed; parse the struct body."""
    return _parse_common(r)


def _parse_common_struct(r: _Reader):
    """gobEncoderType value: {CommonType} struct wrapper."""
    name, tid = "", 0
    fieldnum = -1
    while True:
        delta = r.uint()
        if delta == 0:
            break
        fieldnum += delta
        if fieldnum == 0:
            name, tid = _parse_common(r)
        else:
            raise ValueError("gob: bad gobEncoderType field")
    return name, tid


def _parse_field_type(r: _Reader):
    name, tid = "", 0
    fieldnum = -1
    while True:
        delta = r.uint()
        if delta == 0:
            break
        fieldnum += delta
        if fieldnum == 0:
            name = r.string()
        elif fieldnum == 1:
            tid = r.int_()
        else:
            raise ValueError("gob: bad fieldType field")
    return name, tid


class Decoder:
    """Decodes the supported gob subset into Python values: structs ->
    dicts (field name -> value, zero-valued fields filled in), slices ->
    lists, bytes/GobEncoder payloads -> bytes."""

    def __init__(self, data: bytes):
        self.r = _Reader(data)
        self.wire: Dict[int, Any] = {}

    def decode(self) -> Tuple[int, Any]:
        """Decode the next top-level value; returns (typeid, value)."""
        while True:
            n = self.r.uint()
            msg = _Reader(self.r.take(n))
            tid = msg.int_()
            if tid < 0:
                got_tid, obj = _parse_wire_type(msg)
                if got_tid != -tid:
                    raise ValueError(
                        f"gob: type id mismatch {got_tid} != {-tid}")
                self.wire[-tid] = obj
                continue
            val = self._value(tid, msg, top=True)
            if not msg.eof():
                raise ValueError("gob: trailing bytes in value message")
            return tid, val

    def _value(self, tid: int, r: _Reader, top: bool = False):
        if tid == BOOL:
            return r.uint() != 0
        if tid == INT:
            return r.int_()
        if tid == UINT:
            return r.uint()
        if tid == FLOAT:
            return r.float_()
        if tid == BYTES:
            return r.bytes_()
        if tid == STRING:
            return r.string()
        obj = self.wire.get(tid)
        if obj is None:
            raise ValueError(f"gob: value of undefined type {tid}")
        if isinstance(obj, _WireGobEncoder):
            return r.bytes_()
        if isinstance(obj, _WireSlice):
            n = r.uint()
            return [self._value(obj.elem, r) for _ in range(n)]
        if isinstance(obj, _WireStruct):
            out = {name: self._zero_of(ftid)
                   for name, ftid in obj.fields}
            fieldnum = -1
            while True:
                delta = r.uint()
                if delta == 0:
                    break
                fieldnum += delta
                if fieldnum >= len(obj.fields):
                    raise ValueError("gob: field number out of range")
                name, ftid = obj.fields[fieldnum]
                out[name] = self._value(ftid, r)
            return out
        raise ValueError(f"gob: cannot decode type {tid}")

    def _zero_of(self, tid: int):
        """Zero value for omitted struct fields (gob omits zero fields)."""
        builtin = {BOOL: False, INT: 0, UINT: 0, FLOAT: 0.0,
                   BYTES: b"", STRING: ""}
        if tid in builtin:
            return builtin[tid]
        obj = self.wire.get(tid)
        if isinstance(obj, _WireSlice):
            return []
        if isinstance(obj, _WireGobEncoder):
            return b""
        if isinstance(obj, _WireStruct):
            return {name: self._zero_of(ftid) for name, ftid in obj.fields}
        return None   # forward reference: zero unavailable yet


def loads(data: bytes) -> Any:
    """One-shot decode of the first top-level value in a gob stream."""
    return Decoder(data).decode()[1]


# ---------------------------------------------------------------------------
# big.Int GobEncode payload (math/big/intmarsh.go)
# ---------------------------------------------------------------------------

_BIG_INT_VERSION = 1


def big_int_gob_encode(x: int) -> bytes:
    """big.Int.GobEncode: byte 0 = version<<1 | sign, then |x| big-endian
    (empty magnitude for zero)."""
    sign = 1 if x < 0 else 0
    mag = abs(x)
    b = mag.to_bytes((mag.bit_length() + 7) // 8, "big")
    return bytes([_BIG_INT_VERSION << 1 | sign]) + b


def big_int_gob_decode(data: bytes) -> int:
    if len(data) == 0:
        raise ValueError("big.Int gob: empty payload")
    version = data[0] >> 1
    if version != _BIG_INT_VERSION:
        raise ValueError(f"big.Int gob: unsupported version {version}")
    mag = int.from_bytes(data[1:], "big")
    return -mag if data[0] & 1 else mag
