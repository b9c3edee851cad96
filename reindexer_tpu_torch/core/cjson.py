"""Port of reindexer_tpu/core/cjson.py: a copy of the reference's module
(host only; the same wire format).

The reference's notes follow.

CJSON-style binary document codec with a tags (field-name) table.

Semantic equivalent of the reference's CJSON encoder/decoder + TagsMatcher
(cpp_src/core/cjson/tagsmatcher.h:13, cjsonbuilder.cc, cjsondecoder.cc):
documents travel as tag-compressed binary — field names live once in a
name table, values are varint/typed-binary instead of JSON text. Two
deliberate deviations from the reference, chosen for a connection-stateless
wire (README.md parity notes):

* the tag table is SELF-CONTAINED per payload (one table shared by every
  document in a batch) instead of a stateful per-namespace TagsMatcher
  version handshake — a FETCH_RESULTS page amortizes each field name once,
  which is where the reference's savings come from, without the
  version-mismatch resync ladder (tagsmatcher.h version_ / stateToken_);
* arbitrary JSON trees are supported without a payload-type schema (the
  reference falls back to its own untyped tags for non-indexed fields).

Layout:
    payload  := varint n_names, { varint len, utf8 }... , varint n_docs,
                value...
    value    := tag byte, body
    tags     := NULL | TRUE | FALSE | INT (zigzag varint) | DOUBLE (8B LE)
              | STR (varint len + utf8) | ARRAY (varint n + values)
              | OBJECT (varint n + { varint name_idx, value }...)
"""
from __future__ import annotations

import struct
from typing import Any

_NULL = 0
_TRUE = 1
_FALSE = 2
_INT = 3
_DOUBLE = 4
_STR = 5
_ARRAY = 6
_OBJECT = 7


def _put_varuint(buf: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _get_varuint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 127) if v < 0 else v << 1


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


class _TagTable:
    """Per-payload field-name table (the stateless TagsMatcher analog)."""

    def __init__(self):
        self.names: list[str] = []
        self._idx: dict[str, int] = {}

    def tag(self, name: str) -> int:
        t = self._idx.get(name)
        if t is None:
            t = len(self.names)
            self.names.append(name)
            self._idx[name] = t
        return t


def _encode_value(buf: bytearray, v: Any, tt: _TagTable) -> None:
    if v is None:
        buf.append(_NULL)
    elif v is True:
        buf.append(_TRUE)
    elif v is False:
        buf.append(_FALSE)
    elif isinstance(v, int):
        buf.append(_INT)
        _put_varuint(buf, _zigzag(v))
    elif isinstance(v, float):
        buf.append(_DOUBLE)
        buf.extend(struct.pack("<d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        buf.append(_STR)
        _put_varuint(buf, len(raw))
        buf.extend(raw)
    elif isinstance(v, dict):
        buf.append(_OBJECT)
        _put_varuint(buf, len(v))
        for k, x in v.items():
            _put_varuint(buf, tt.tag(str(k)))
            _encode_value(buf, x, tt)
    elif isinstance(v, (list, tuple)):
        buf.append(_ARRAY)
        _put_varuint(buf, len(v))
        for x in v:
            _encode_value(buf, x, tt)
    else:
        # same fallback the JSON wire uses (json.dumps default=str)
        _encode_value(buf, str(v), tt)


def _decode_value(data: bytes, pos: int, names: list[str],
                  ) -> tuple[Any, int]:
    tag = data[pos]
    pos += 1
    if tag == _NULL:
        return None, pos
    if tag == _TRUE:
        return True, pos
    if tag == _FALSE:
        return False, pos
    if tag == _INT:
        v, pos = _get_varuint(data, pos)
        return _unzigzag(v), pos
    if tag == _DOUBLE:
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if tag == _STR:
        n, pos = _get_varuint(data, pos)
        return data[pos: pos + n].decode("utf-8"), pos + n
    if tag == _ARRAY:
        n, pos = _get_varuint(data, pos)
        out = []
        for _ in range(n):
            v, pos = _decode_value(data, pos, names)
            out.append(v)
        return out, pos
    if tag == _OBJECT:
        n, pos = _get_varuint(data, pos)
        obj = {}
        for _ in range(n):
            t, pos = _get_varuint(data, pos)
            v, pos = _decode_value(data, pos, names)
            obj[names[t]] = v
        return obj, pos
    raise ValueError(f"bad cjson tag {tag}")


def encode_docs(docs: list) -> bytes:
    """Encode a document batch with one shared name table (the page-level
    amortization a FETCH_RESULTS response needs)."""
    tt = _TagTable()
    body = bytearray()
    _put_varuint(body, len(docs))
    for d in docs:
        _encode_value(body, d, tt)
    head = bytearray()
    _put_varuint(head, len(tt.names))
    for name in tt.names:
        raw = name.encode("utf-8")
        _put_varuint(head, len(raw))
        head.extend(raw)
    return bytes(head + body)


def decode_docs(data: bytes) -> list:
    n_names, pos = _get_varuint(data, 0)
    names = []
    for _ in range(n_names):
        ln, pos = _get_varuint(data, pos)
        names.append(data[pos: pos + ln].decode("utf-8"))
        pos += ln
    n_docs, pos = _get_varuint(data, pos)
    out = []
    for _ in range(n_docs):
        v, pos = _decode_value(data, pos, names)
        out.append(v)
    return out


class TagState:
    """Per-connection cumulative tags table (reference: tagsmatcher.h:13
    stateToken_/version_ — the reference keeps the name table on the
    connection and ships only deltas). Pages encoded against a TagState
    carry [base_count, new names] instead of the full table: measured
    ~170 B/page for a 12-field schema = 73% of a single-doc page, 2.3%
    at 100 docs — the stateful form makes point-lookup pages near-free."""

    def __init__(self):
        self.names: list[str] = []


def encode_docs_stateful(docs: list, state: TagState) -> bytes:
    """Delta-table page: [base varuint][n_new varuint][new names][n_docs]
    [docs]. Mutates `state` by appending the new names (call in connection
    order; the server serializes responses per connection)."""
    tt = _TagTable()
    tt.names = list(state.names)
    tt._idx = {n: i for i, n in enumerate(tt.names)}
    base = len(state.names)
    body = bytearray()
    _put_varuint(body, len(docs))
    for d in docs:
        _encode_value(body, d, tt)
    head = bytearray()
    _put_varuint(head, base)
    new = tt.names[base:]
    _put_varuint(head, len(new))
    for name in new:
        raw = name.encode("utf-8")
        _put_varuint(head, len(raw))
        head.extend(raw)
    state.names = tt.names
    return bytes(head + body)


def decode_docs_stateful(data: bytes, state: TagState) -> list:
    base, pos = _get_varuint(data, 0)
    if base != len(state.names):
        raise ValueError(
            f"tag-state desync: page base {base}, local {len(state.names)}")
    n_new, pos = _get_varuint(data, pos)
    for _ in range(n_new):
        ln, pos = _get_varuint(data, pos)
        state.names.append(data[pos: pos + ln].decode("utf-8"))
        pos += ln
    n_docs, pos = _get_varuint(data, pos)
    out = []
    for _ in range(n_docs):
        v, pos = _decode_value(data, pos, state.names)
        out.append(v)
    return out


def encode_doc(doc: Any) -> bytes:
    return encode_docs([doc])


def decode_doc(data: bytes) -> Any:
    return decode_docs(data)[0]
