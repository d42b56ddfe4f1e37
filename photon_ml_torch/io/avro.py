"""Avro binary format: stdlib-only codec + object-container-file I/O.

Counterpart of ``photon_ml_tpu/io/avro.py`` (stdlib only, copied).
Photon-ML's on-disk interchange format — training data, scoring output
and saved models — is Avro object container files.  This module
implements the wire format from the Avro 1.x specification (zigzag
varint longs, little-endian floats, length-prefixed bytes/strings,
block-encoded arrays/maps, union = index + value, container = magic /
metadata map / sync-marker-delimited deflate or null blocks), so files
written here are readable by any Avro implementation and vice versa.

Scope: all primitive types, record / enum / fixed / array / map / union
named types, recursive name references, ``null`` and ``deflate``
codecs, and schema resolution: ``read_container(path,
reader_schema=...)`` decodes with the container's writer schema and
resolves each datum to the caller's reader schema (writer-only fields
skipped, reader-only fields defaulted, primitive promotion, branch-wise
unions, reader aliases).

Host-side ETL: device code only sees the int32/float32 arrays produced
downstream (``io.dataset``).
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterable, Iterator

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
_PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "bytes", "string"
}


# ---------------------------------------------------------------------------
# Schema handling
# ---------------------------------------------------------------------------


class Schema:
    """A parsed Avro schema: the JSON structure plus a named-type registry
    so ``{"type": "X"}`` references resolve during encode/decode."""

    def __init__(self, source: "str | dict | list"):
        if isinstance(source, str):
            src = source.strip()
            source = json.loads(src) if src and src[0] in "[{\"" else src
        self.names: dict[str, dict] = {}
        self.root = self._collect(source)

    def _collect(self, s: Any) -> Any:
        """Walk the schema, registering named types (record/enum/fixed)."""
        if isinstance(s, str):
            return s
        if isinstance(s, list):
            return [self._collect(b) for b in s]
        t = s.get("type")
        if t in ("record", "error"):
            self.names[s["name"]] = s
            for f in s["fields"]:
                f["type"] = self._collect(f["type"])
            return s
        if t in ("enum", "fixed"):
            self.names[s["name"]] = s
            return s
        if t == "array":
            s["items"] = self._collect(s["items"])
            return s
        if t == "map":
            s["values"] = self._collect(s["values"])
            return s
        if isinstance(t, (dict, list)):
            # {"type": {...}} wrapper
            return self._collect(t)
        return s

    def resolve(self, s: Any) -> Any:
        """Dereference a by-name type reference."""
        if isinstance(s, str) and s not in _PRIMITIVES:
            return self.names[s]
        return s

    def to_json(self) -> str:
        return json.dumps(self.root)


# ---------------------------------------------------------------------------
# Binary encoding (Avro spec §"Binary Encoding")
# ---------------------------------------------------------------------------


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(out: BinaryIO, n: int) -> None:
    z = _zigzag(n)
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


def read_long(inp: BinaryIO) -> int:
    shift, acc = 0, 0
    while True:
        (b,) = inp.read(1)
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(acc)
        shift += 7


def _encode(schema: Schema, s: Any, datum: Any, out: BinaryIO) -> None:
    s = schema.resolve(s)
    if isinstance(s, list):                       # union
        for i, branch in enumerate(s):
            if _union_match(schema, branch, datum):
                write_long(out, i)
                _encode(schema, branch, datum, out)
                return
        raise TypeError(f"datum {datum!r} matches no union branch {s!r}")
    t = s if isinstance(s, str) else s["type"]
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if datum else b"\x00")
    elif t in ("int", "long"):
        write_long(out, int(datum))
    elif t == "float":
        out.write(struct.pack("<f", float(datum)))
    elif t == "double":
        out.write(struct.pack("<d", float(datum)))
    elif t == "bytes":
        write_long(out, len(datum))
        out.write(datum)
    elif t == "string":
        raw = datum.encode("utf-8")
        write_long(out, len(raw))
        out.write(raw)
    elif t == "record":
        for f in s["fields"]:
            name = f["name"]
            if name in datum:
                value = datum[name]
            elif "default" in f:
                value = f["default"]
            else:
                raise KeyError(
                    f"record {s['name']!r}: field {name!r} missing and "
                    "has no default"
                )
            _encode(schema, f["type"], value, out)
    elif t == "enum":
        out.write(b"")
        write_long(out, s["symbols"].index(datum))
    elif t == "fixed":
        if len(datum) != s["size"]:
            raise ValueError(f"fixed {s['name']}: want {s['size']} bytes")
        out.write(datum)
    elif t == "array":
        if datum:
            write_long(out, len(datum))
            for item in datum:
                _encode(schema, s["items"], item, out)
        write_long(out, 0)
    elif t == "map":
        if datum:
            write_long(out, len(datum))
            for k, v in datum.items():
                _encode(schema, "string", k, out)
                _encode(schema, s["values"], v, out)
        write_long(out, 0)
    else:
        raise TypeError(f"unsupported schema {s!r}")


def _union_match(schema: Schema, branch: Any, datum: Any) -> bool:
    branch = schema.resolve(branch)
    t = branch if isinstance(branch, str) else branch["type"]
    if t == "null":
        return datum is None
    if t == "boolean":
        return isinstance(datum, bool)
    if t in ("int", "long"):
        return isinstance(datum, int) and not isinstance(datum, bool)
    if t in ("float", "double"):
        return isinstance(datum, (int, float)) and not isinstance(datum, bool)
    if t == "string":
        return isinstance(datum, str)
    if t in ("bytes", "fixed"):
        return isinstance(datum, (bytes, bytearray))
    if t == "record":
        return isinstance(datum, dict)
    if t == "map":
        return isinstance(datum, dict)
    if t == "array":
        return isinstance(datum, (list, tuple))
    if t == "enum":
        return isinstance(datum, str)
    return False


def _decode(schema: Schema, s: Any, inp: BinaryIO) -> Any:
    s = schema.resolve(s)
    if isinstance(s, list):                       # union
        return _decode(schema, s[read_long(inp)], inp)
    t = s if isinstance(s, str) else s["type"]
    if t == "null":
        return None
    if t == "boolean":
        return inp.read(1) == b"\x01"
    if t in ("int", "long"):
        return read_long(inp)
    if t == "float":
        return struct.unpack("<f", inp.read(4))[0]
    if t == "double":
        return struct.unpack("<d", inp.read(8))[0]
    if t == "bytes":
        return inp.read(read_long(inp))
    if t == "string":
        return inp.read(read_long(inp)).decode("utf-8")
    if t == "record":
        return {f["name"]: _decode(schema, f["type"], inp)
                for f in s["fields"]}
    if t == "enum":
        return s["symbols"][read_long(inp)]
    if t == "fixed":
        return inp.read(s["size"])
    if t == "array":
        out = []
        while True:
            count = read_long(inp)
            if count == 0:
                return out
            if count < 0:                         # block with byte size
                read_long(inp)
                count = -count
            for _ in range(count):
                out.append(_decode(schema, s["items"], inp))
    if t == "map":
        out = {}
        while True:
            count = read_long(inp)
            if count == 0:
                return out
            if count < 0:
                read_long(inp)
                count = -count
            for _ in range(count):
                k = inp.read(read_long(inp)).decode("utf-8")
                out[k] = _decode(schema, s["values"], inp)
    raise TypeError(f"unsupported schema {s!r}")


# ---------------------------------------------------------------------------
# Schema resolution (Avro spec §"Schema Resolution"): decode with the
# WRITER schema's wire layout, produce data shaped by the READER schema.
# ---------------------------------------------------------------------------

_PROMOTIONS = {
    ("int", "long"), ("int", "float"), ("int", "double"),
    ("long", "float"), ("long", "double"), ("float", "double"),
    ("string", "bytes"), ("bytes", "string"),
}


def _type_of(s: Any) -> str:
    return s if isinstance(s, str) else s["type"]


def _schemas_match(wschema: "Schema", ws: Any, rschema: "Schema",
                   rs: Any) -> bool:
    """Can writer schema ``ws`` resolve to reader schema ``rs``?
    (Shallow per spec — container element mismatches surface as errors
    during decode, like reference implementations.)"""
    ws = wschema.resolve(ws)
    rs = rschema.resolve(rs)
    if isinstance(ws, list) or isinstance(rs, list):
        return True   # union resolution happens per-datum at decode
    wt, rt = _type_of(ws), _type_of(rs)
    if wt == rt:
        if wt in ("record", "enum", "fixed"):
            # Named types match on unqualified name — or when the
            # reader declares the writer's name as an alias (spec
            # §Aliases), mirroring _decode_resolved: without this a
            # renamed type nested inside a reader union failed
            # resolution that succeeds outside a union.
            wn = ws["name"].rsplit(".", 1)[-1]
            rn = rs["name"].rsplit(".", 1)[-1]
            if wn != rn and wn not in (
                    a.rsplit(".", 1)[-1] for a in rs.get("aliases", ())):
                return False
            if wt == "fixed":
                return ws["size"] == rs["size"]
        return True
    return (wt, rt) in _PROMOTIONS


def _promote(value: Any, wt: str, rt: str) -> Any:
    if rt in ("float", "double") and wt in ("int", "long", "float"):
        return float(value)
    if wt == "string" and rt == "bytes":
        return value.encode("utf-8") if isinstance(value, str) else value
    if wt == "bytes" and rt == "string":
        return value.decode("utf-8") if isinstance(value, bytes) else value
    return value


def _default_datum(rschema: "Schema", rs: Any, default: Any) -> Any:
    """A reader field's JSON default → runtime datum (spec: bytes/fixed
    defaults are JSON strings of latin-1 code points; union defaults
    conform to the FIRST branch)."""
    rs = rschema.resolve(rs)
    if isinstance(rs, list):
        return _default_datum(rschema, rs[0], default)
    t = _type_of(rs)
    if t in ("bytes", "fixed") and isinstance(default, str):
        return default.encode("latin-1")
    if t == "record":
        return {
            f["name"]: _default_datum(
                rschema, f["type"],
                default.get(f["name"], f.get("default")))
            for f in rs["fields"]
        }
    if t == "array":
        return [_default_datum(rschema, rs["items"], d) for d in default]
    if t == "map":
        return {k: _default_datum(rschema, rs["values"], v)
                for k, v in default.items()}
    return default


def _skip(schema: Schema, s: Any, inp: BinaryIO) -> None:
    """Decode-and-discard a writer-only value (spec: skipped fields)."""
    _decode(schema, s, inp)


def _decode_resolved(wschema: Schema, ws: Any, rschema: Schema, rs: Any,
                     inp: BinaryIO) -> Any:
    ws = wschema.resolve(ws)
    rs = rschema.resolve(rs)
    if isinstance(ws, list):
        # Writer union: the wire carries the branch index; resolve the
        # actual branch against the reader schema.
        return _decode_resolved(wschema, ws[read_long(inp)], rschema, rs,
                                inp)
    if isinstance(rs, list):
        # Reader union, writer not: first reader branch that matches.
        for branch in rs:
            if _schemas_match(wschema, ws, rschema, branch):
                return _decode_resolved(wschema, ws, rschema, branch, inp)
        raise TypeError(
            f"writer schema {ws!r} matches no reader union branch {rs!r}")
    wt, rt = _type_of(ws), _type_of(rs)
    if wt != rt and (wt, rt) not in _PROMOTIONS:
        raise TypeError(
            f"cannot resolve writer {wt!r} to reader {rt!r}")
    if wt == rt and wt in ("enum", "fixed"):
        # Spec: named types resolve only when (unqualified) names match
        # — or the reader declares the writer's name as an alias; fixed
        # additionally requires equal sizes.  A silent fall-through
        # here would yield writer-shaped bytes under a reader contract
        # that promises something else (review finding).
        wn = ws["name"].rsplit(".", 1)[-1]
        rn = rs["name"].rsplit(".", 1)[-1]
        if wn != rn and wn not in (
                a.rsplit(".", 1)[-1] for a in rs.get("aliases", ())):
            raise TypeError(
                f"{wt} name mismatch: writer {wn!r}, reader {rn!r}")
        if wt == "fixed" and ws["size"] != rs["size"]:
            raise TypeError(
                f"fixed {wn!r} size mismatch: writer {ws['size']}, "
                f"reader {rs['size']}")
    if wt == "record":
        wn = ws["name"].rsplit(".", 1)[-1]
        rn = rs["name"].rsplit(".", 1)[-1]
        if wn != rn and wn not in (
                a.rsplit(".", 1)[-1] for a in rs.get("aliases", ())):
            raise TypeError(f"record name mismatch: writer {wn}, "
                            f"reader {rn}")
        r_fields = {f["name"]: f for f in rs["fields"]}
        # Reader field aliases (spec §Aliases): a renamed field matches
        # the writer data under its OLD name.
        r_alias = {a: f for f in rs["fields"]
                   for a in f.get("aliases", ())}
        out = {}
        for f in ws["fields"]:        # wire order = writer field order
            rf = r_fields.pop(f["name"], None)
            if rf is None:
                rf = r_alias.get(f["name"])
                if rf is not None:
                    r_fields.pop(rf["name"], None)
            if rf is None:
                _skip(wschema, f["type"], inp)
            else:
                out[rf["name"]] = _decode_resolved(
                    wschema, f["type"], rschema, rf["type"], inp)
        for name, rf in r_fields.items():   # reader-only → defaults
            if "default" not in rf:
                raise TypeError(
                    f"record {rs['name']!r}: reader field {name!r} "
                    "absent from writer data and has no default")
            out[name] = _default_datum(rschema, rf["type"], rf["default"])
        return out
    if wt == "enum":
        symbol = ws["symbols"][read_long(inp)]
        if symbol not in rs["symbols"]:
            if "default" in rs:       # Avro 1.9+ enum default
                return rs["default"]
            raise TypeError(
                f"enum symbol {symbol!r} not in reader symbols")
        return symbol
    if wt == "array":
        out = []
        while True:
            count = read_long(inp)
            if count == 0:
                return out
            if count < 0:
                read_long(inp)
                count = -count
            for _ in range(count):
                out.append(_decode_resolved(
                    wschema, ws["items"], rschema, rs["items"], inp))
    if wt == "map":
        out = {}
        while True:
            count = read_long(inp)
            if count == 0:
                return out
            if count < 0:
                read_long(inp)
                count = -count
            for _ in range(count):
                k = inp.read(read_long(inp)).decode("utf-8")
                out[k] = _decode_resolved(
                    wschema, ws["values"], rschema, rs["values"], inp)
    value = _decode(wschema, ws, inp)
    return _promote(value, wt, rt)


def decode_datum_resolved(wschema: Schema, rschema: Schema,
                          raw: bytes) -> Any:
    """Decode writer-layout bytes into reader-schema-shaped data."""
    return _decode_resolved(wschema, wschema.root, rschema, rschema.root,
                            io.BytesIO(raw))


def encode_datum(schema: Schema, datum: Any) -> bytes:
    buf = io.BytesIO()
    _encode(schema, schema.root, datum, buf)
    return buf.getvalue()


def decode_datum(schema: Schema, raw: bytes) -> Any:
    return _decode(schema, schema.root, io.BytesIO(raw))


# ---------------------------------------------------------------------------
# Object container files (Avro spec §"Object Container Files")
# ---------------------------------------------------------------------------

_META_SCHEMA = Schema({"type": "map", "values": "bytes"})


def write_container(
    path: str,
    schema: "Schema | str | dict",
    records: Iterable[Any],
    codec: str = "deflate",
    records_per_block: int = 4096,
) -> int:
    """Write records to an Avro object container file; returns count."""
    if not isinstance(schema, Schema):
        schema = Schema(schema)
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r}")
    sync = os.urandom(SYNC_SIZE)
    total = 0
    with open(path, "wb") as f:
        f.write(MAGIC)
        _encode(
            _META_SCHEMA,
            _META_SCHEMA.root,
            {
                "avro.schema": schema.to_json().encode(),
                "avro.codec": codec.encode(),
            },
            f,
        )
        f.write(sync)

        block = io.BytesIO()
        in_block = 0

        def flush():
            nonlocal in_block
            if not in_block:
                return
            payload = block.getvalue()
            if codec == "deflate":
                # Avro deflate = raw DEFLATE stream (no zlib wrapper).
                c = zlib.compressobj(wbits=-15)
                payload = c.compress(payload) + c.flush()
            write_long(f, in_block)
            write_long(f, len(payload))
            f.write(payload)
            f.write(sync)
            block.seek(0)
            block.truncate()
            in_block = 0

        for rec in records:
            _encode(schema, schema.root, rec, block)
            in_block += 1
            total += 1
            if in_block >= records_per_block:
                flush()
        flush()
    return total


def read_container(
    path: str,
    reader_schema: "Schema | str | dict | None" = None,
) -> tuple[Schema, Iterator[Any]]:
    """Open an Avro object container file → (writer schema, record iter).

    With ``reader_schema``, each record is RESOLVED writer→reader
    (schema evolution): data written under an older/newer schema decodes
    into the caller's shape — writer-only fields skipped, reader-only
    fields defaulted, primitives promoted (Avro spec §"Schema
    Resolution").  The returned schema is still the writer's (callers
    inspecting the file's own layout keep working).
    """
    if reader_schema is not None and not isinstance(reader_schema, Schema):
        reader_schema = Schema(reader_schema)
    f = open(path, "rb")
    if f.read(4) != MAGIC:
        f.close()
        raise ValueError(f"{path}: not an Avro object container file")
    meta = _decode(_META_SCHEMA, _META_SCHEMA.root, f)
    schema = Schema(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        f.close()
        raise ValueError(f"{path}: unsupported codec {codec!r}")
    sync = f.read(SYNC_SIZE)

    def records() -> Iterator[Any]:
        with f:
            while True:
                head = f.read(1)
                if not head:
                    return
                f.seek(-1, 1)
                count = read_long(f)
                size = read_long(f)
                payload = f.read(size)
                if codec == "deflate":
                    payload = zlib.decompress(payload, wbits=-15)
                if f.read(SYNC_SIZE) != sync:
                    raise ValueError(f"{path}: sync marker mismatch")
                buf = io.BytesIO(payload)
                if reader_schema is None:
                    for _ in range(count):
                        yield _decode(schema, schema.root, buf)
                else:
                    for _ in range(count):
                        yield _decode_resolved(
                            schema, schema.root, reader_schema,
                            reader_schema.root, buf)

    return schema, records()
