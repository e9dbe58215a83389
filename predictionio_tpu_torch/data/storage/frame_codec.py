"""Binary wire codec for EventFrame: the bulk-scan payload of the remote
storage daemon.

The JAX package's PIOF1 format, byte for byte, so either package's daemon
and clients read the other's frames.  The reference's Elasticsearch
backend ships bulk event scans through the elasticsearch-spark
connector's own columnar wire format (ESPEvents.scala:42); this is the
same thing for the remote backend: a compact, self-describing encoding of
one columnar EventFrame that round-trips losslessly (ids, tags, prId,
creation time) without a JSON object per event.

Layout (version 1)::

    b"PIOF1\\n"                       magic
    u32 big-endian header length
    header JSON  {"n": N, "cols": [{"name": ..., "kind": ..., "len": ...}]}
    per-column payloads, in header order

Column kinds:

* ``i64``  — raw little-endian int64 array (N*8 bytes)
* ``str``  — i32 length array (N*4 bytes; -1 encodes None) followed by the
  concatenated UTF-8 bytes
* ``json`` — same layout as ``str``; each row is a JSON document, with the
  empty string standing for the column's "empty" value ({} or ())

Absent optional columns (event_id/tags/pr_id/creation_time_ms may be None
on synthesized frames) are omitted from the header.

Both directions run on numpy alone, so the daemon and its clients need no
pyarrow.  Encoding a repetitive column (bulk columns are built as
``vocabulary[codes]``) encodes each unique object once and joins the
gathered bytes in one C call; a column of distinct strings joins once and
takes its byte lengths from the characters when it is ASCII.  Decoding a
repetitive column hashes each row's bytes in a few vectorized passes,
decodes each distinct value once and broadcasts it, so a 20M-row scan
materializes vocabulary-many Python strings, as the JAX codec's arrow
dictionary does; a column of distinct values is sliced out of one decoded
text.  The per-row loop stays only for what the JAX codec also sends down
its own: rows that are not strings (coerced with ``str``) and JSON
columns of distinct documents.
"""

from __future__ import annotations

import json

import numpy as np

from predictionio_tpu_torch.data.storage.base import (
    EventFrame,
    obj_ptrs,
    ptr_factorize,
)

MAGIC = b"PIOF1\n"


def dictionary_to_objects(arr, null_value=None, transform=None) -> np.ndarray:
    """Arrow DictionaryArray -> numpy object column, decoding (and
    optionally ``transform``-ing) each unique dictionary value once and
    broadcasting through the int32 codes; null rows become ``null_value``.
    The interned output keeps downstream pointer fast paths hot.  It reads
    only the array's own methods, so this module imports no pyarrow; the
    parquet backend's scan decoders use it from here."""
    n = len(arr)
    if transform is None:
        uniq = np.asarray(
            arr.dictionary.to_numpy(zero_copy_only=False), object
        )
    else:
        vals = arr.dictionary.to_pylist()
        uniq = np.empty(len(vals), object)
        for j, v in enumerate(vals):
            uniq[j] = transform(v)
    if not len(uniq):  # all-null column dictionary-encodes to 0 values
        return np.full(n, null_value, object)
    codes = arr.indices.fill_null(0).to_numpy(zero_copy_only=False)
    out = uniq[codes]
    if arr.null_count:
        out[arr.is_null().to_numpy(zero_copy_only=False)] = null_value
    return out


_I64_COLS = ("event_time_ms", "creation_time_ms")
_JSON_COLS = ("properties", "tags")
_COLUMN_ORDER = (
    "event",
    "entity_type",
    "entity_id",
    "target_entity_type",
    "target_entity_id",
    "event_time_ms",
    "properties",
    "event_id",
    "tags",
    "pr_id",
    "creation_time_ms",
)

#: decode: a column is deduplicated when its rows hold at most a quarter
#: as many distinct values (the JAX codec's dictionary threshold)
_DEDUP_MIN_ROWS = 1024
#: decode: a leading sample's distinct values code the column by a
#: binary search when they are at most _DEDUP_FEW (else one sort)
_DEDUP_SAMPLE = 65536
_DEDUP_FEW = 4096
#: decode: the padded row matrix may cost at most this many times the
#: column's bytes (one long row among short ones would blow it up)
_MAX_PAD_FACTOR = 8


# ---------------------------------------------------------------------------
# encode


def _none_mask(col: np.ndarray) -> np.ndarray:
    """Rows that hold None, by pointer (no Python call per row)."""
    ptrs = obj_ptrs(col)
    if ptrs is None:
        return np.zeros(len(col), bool)
    return ptrs == id(None)


def _encode_values(vals) -> tuple[np.ndarray, list[bytes]]:
    """(i32 lengths, UTF-8 bytes) per value; None is -1 and contributes no
    bytes, any other non-string goes through ``str`` (the JAX codec's row
    loop)."""
    lengths = np.empty(len(vals), dtype="<i4")
    parts: list[bytes] = []
    for i, v in enumerate(vals):
        if v is None:
            lengths[i] = -1
            parts.append(b"")
        else:
            b = v.encode("utf-8") if isinstance(v, str) else str(v).encode("utf-8")
            lengths[i] = len(b)
            parts.append(b)
    return lengths, parts


def _payload_from_codes(codes: np.ndarray, uniq) -> bytes:
    """The payload of ``uniq[codes]``, encoding each unique value once."""
    ulen, parts = _encode_values(uniq)
    if len(parts) == 1:  # one value in every row
        return np.full(len(codes), ulen[0], "<i4").tobytes() + parts[0] * len(codes)
    enc = np.empty(len(parts), object)
    enc[:] = parts
    return ulen[codes].astype("<i4").tobytes() + b"".join(enc[codes].tolist())


def _ascii_payload(col: np.ndarray, none: np.ndarray) -> bytes | None:
    """The payload of an all-str/None column whose text is ASCII, from one
    join (byte lengths are then the character counts), else None."""
    vals = col[~none] if none.any() else col
    try:
        text = "".join(vals)
    except TypeError:  # a row that is not a string
        return None
    if not text.isascii():
        return None
    lengths = np.full(len(col), -1, dtype="<i4")
    lengths[~none] = np.fromiter(map(len, vals), np.int64, len(vals))
    return lengths.tobytes() + text.encode("ascii")


def _encode_str_col(col: np.ndarray) -> bytes:
    """A few objects encode once each; else one ASCII join; else each
    unique object once; else row by row."""
    col = np.asarray(col, dtype=object)
    f = ptr_factorize(col, sample_only=True)
    if f is not None:
        return _payload_from_codes(*f)
    fast = _ascii_payload(col, _none_mask(col))
    if fast is not None:
        return fast
    f = ptr_factorize(col)
    if f is not None:
        return _payload_from_codes(*f)
    lengths, parts = _encode_values(col)
    return lengths.tobytes() + b"".join(parts)


def _ser_json(v) -> str:
    """One row's serialized document ('' = empty value)."""
    if not v:
        return ""
    if isinstance(v, str):  # lazy row: already-serialized JSON
        return v
    return json.dumps(
        list(v) if isinstance(v, tuple) else v, separators=(",", ":")
    )


def _encode_json_col(col: np.ndarray) -> bytes:
    col = np.asarray(col, dtype=object)
    # repetitive columns (rating documents, empty tag tuples) serialize
    # each unique value once
    f = ptr_factorize(col)
    if f is not None:
        codes, uniq = f
        return _payload_from_codes(codes, [_ser_json(v) for v in uniq])
    # lazy rows (already-serialized documents) join as strings
    fast = _ascii_payload(col, np.zeros(len(col), bool))
    if fast is not None:
        return fast
    lengths = np.empty(len(col), dtype="<i4")
    parts = []
    for i, v in enumerate(col):
        b = _ser_json(v).encode("utf-8")
        lengths[i] = len(b)
        parts.append(b)
    return lengths.tobytes() + b"".join(parts)


def encode_frame(frame: EventFrame) -> bytes:
    n = len(frame)
    cols = []
    payloads = []
    for name in _COLUMN_ORDER:
        col = getattr(frame, name)
        if col is None:
            continue
        if name in _I64_COLS:
            kind = "i64"
            payload = np.ascontiguousarray(col, dtype="<i8").tobytes()
        elif name in _JSON_COLS:
            kind = "json"
            payload = _encode_json_col(col)
        else:
            kind = "str"
            payload = _encode_str_col(col)
        cols.append({"name": name, "kind": kind, "len": len(payload)})
        payloads.append(payload)
    header = json.dumps({"n": n, "cols": cols}).encode("utf-8")
    return b"".join(
        [MAGIC, len(header).to_bytes(4, "big"), header] + payloads
    )


# ---------------------------------------------------------------------------
# decode


def _row_matrix(
    data: np.ndarray, sizes: np.ndarray, width: int
) -> np.ndarray:
    """(n, width) uint8 matrix of the rows' bytes, zero padded."""
    m = np.zeros((len(sizes), width), np.uint8)
    m[np.arange(width) < sizes[:, None]] = data
    return m


def _dedup_codes(
    data: bytes, offsets: np.ndarray, sizes: np.ndarray
) -> tuple[np.ndarray, np.ndarray] | None:
    """(codes, first row of each code) grouping equal rows, or None when
    the column is mostly distinct or too ragged to pad.  Rows group by a
    64-bit FNV-1a hash of their bytes and length, looked up in the hashes
    of a leading sample when it holds few (one sort of the whole column
    otherwise, or when the sample misses values); the grouping is then checked byte for byte,
    and a collision gives None."""
    n = len(sizes)
    if n < _DEDUP_MIN_ROWS:
        return None
    probe = min(n, 4096)
    starts = offsets[:probe].tolist()
    if len({data[a: a + b] for a, b in zip(starts, sizes[:probe].tolist())}) * 10 > probe * 9:
        return None  # nearly distinct: no dedup pass
    width = int(sizes.max())
    if n * width > _MAX_PAD_FACTOR * len(data) + (1 << 20):
        return None
    m = _row_matrix(np.frombuffer(data, np.uint8), sizes, width)
    h = np.full(n, 0xCBF29CE484222325, np.uint64) ^ sizes.astype(np.uint64)
    prime = np.uint64(0x100000001B3)
    for j in range(width):
        h ^= m[:, j]
        h *= prime
    uniq, first = np.unique(h[:_DEDUP_SAMPLE], return_index=True)
    covered = False
    if len(uniq) <= _DEDUP_FEW:
        codes = np.searchsorted(uniq, h)
        codes[codes == len(uniq)] = 0
        covered = bool((uniq[codes] == h).all())
    if not covered:  # values past the sample, or too many to search
        uniq, first, codes = np.unique(h, return_index=True, return_inverse=True)
        codes = codes.reshape(-1)
    if len(uniq) * 4 > n:
        return None
    rep = first[codes]
    if not (sizes[rep] == sizes).all() or not (m[rep] == m).all():
        return None
    return codes, first


def _decode_rows(data: bytes, offsets: np.ndarray) -> np.ndarray:
    """One str per row, sliced out of one decoded text when it is ASCII."""
    n = len(offsets) - 1
    out = np.empty(n, dtype=object)
    text = data.decode("utf-8")
    starts, ends = offsets[:-1].tolist(), offsets[1:].tolist()
    if len(text) == len(data):
        out[:] = [text[a:b] for a, b in zip(starts, ends)]
    else:
        out[:] = [data[a:b].decode("utf-8") for a, b in zip(starts, ends)]
    return out


def _decode_str_col(buf: memoryview, n: int) -> np.ndarray:
    """Object column of str/None from the wire layout; equal rows share one
    Python string when the column is repetitive."""
    lengths = np.frombuffer(buf[: n * 4], dtype="<i4")
    sizes = np.where(lengths > 0, lengths, 0).astype(np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    total = int(offsets[-1])
    data = bytes(buf[n * 4: n * 4 + total])
    if n and (lengths == lengths[0]).all() and data == data[: sizes[0]] * n:
        # one value in every row (a constant or an all-None column)
        out = np.empty(n, dtype=object)
        out[:] = None if lengths[0] < 0 else data[: sizes[0]].decode("utf-8")
        return out
    f = _dedup_codes(data, offsets, sizes)
    if f is not None:
        codes, first = f
        uniq = np.empty(len(first), dtype=object)
        uniq[:] = [
            data[offsets[i]: offsets[i] + sizes[i]].decode("utf-8")
            for i in first.tolist()
        ]
        out = uniq[codes]
    else:
        out = _decode_rows(data, offsets)
    none = lengths < 0
    if none.any():
        out[none] = None
    return out


def _parse_json(s, empty):
    if not s:
        return empty
    v = json.loads(s)
    return tuple(v) if isinstance(v, list) else v


def _decode_json_col(buf: memoryview, n: int, empty) -> np.ndarray:
    """Eager JSON column (tags): each unique document parsed once."""
    out = _decode_str_col(buf, n)
    f = ptr_factorize(out)
    codes, uniq = f if f is not None else (None, out)
    # element by element: a parsed tuple must not broadcast as a sequence
    parsed = np.empty(len(uniq), object)
    for j, s in enumerate(uniq):
        parsed[j] = _parse_json(s, empty)
    return parsed if codes is None else parsed[codes]


def decode_frame(data: bytes) -> EventFrame:
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError("not a PIOF1 frame")
    view = memoryview(data)
    off = len(MAGIC)
    hlen = int.from_bytes(view[off : off + 4], "big")
    off += 4
    header = json.loads(bytes(view[off : off + hlen]))
    off += hlen
    n = header["n"]
    kwargs: dict[str, np.ndarray] = {}
    for spec in header["cols"]:
        name, kind, plen = spec["name"], spec["kind"], spec["len"]
        buf = view[off : off + plen]
        off += plen
        if kind == "i64":
            kwargs[name] = np.frombuffer(buf, dtype="<i8").astype(np.int64)
        elif kind == "json" and name != "properties":
            kwargs[name] = _decode_json_col(buf, n, ())
        else:
            # str columns, and properties as lazy rows ("" = empty
            # document): bulk receivers skip N json.loads calls
            kwargs[name] = _decode_str_col(buf, n)
    return EventFrame(**kwargs)
