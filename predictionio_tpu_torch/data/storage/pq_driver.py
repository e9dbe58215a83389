"""Minimal PostgreSQL driver over libpq via ctypes — zero Python deps.

The JAX package's ``pq_driver.py``.  The reference's production
metadata/event store is JDBC-Postgres (storage/jdbc/.../StorageClient.scala);
a host may ship ``libpq.so.5`` but no ``psycopg``, and the backend would
otherwise be configured-but-unusable.  This module binds the handful of
libpq entry points needed for the DAO workload:

  - ``PQconnectdb`` / ``PQfinish`` / ``PQstatus`` / ``PQerrorMessage``
  - ``PQexecParams`` with per-param formats (bytes go BINARY, so BYTEA
    model blobs need no escaping; everything else goes text)
  - text-format results decoded by column OID (ints, floats, bool, bytea
    hex, text)

The cursor accepts psycopg-style ``%s`` placeholders (rewritten to libpq's
``$N``), exposes ``execute/fetchone/fetchall/rowcount/description``, and the
connection is autocommit — exactly the surface
``postgres_backend.PGClient`` consumes, so it slots in as the third driver
fallback after psycopg/psycopg2.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Any, Sequence

CONNECTION_OK = 0
PGRES_COMMAND_OK = 1
PGRES_TUPLES_OK = 2

_OID_INT = {20, 21, 23, 26}  # int8, int2, int4, oid
_OID_FLOAT = {700, 701, 1700}  # float4, float8, numeric
_OID_BOOL = {16}
_OID_BYTEA = {17}


class PQError(Exception):
    pass


_lib = None


def _libpq():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("pq") or "libpq.so.5"
        lib = ctypes.CDLL(name)
        lib.PQconnectdb.restype = ctypes.c_void_p
        lib.PQconnectdb.argtypes = [ctypes.c_char_p]
        lib.PQstatus.argtypes = [ctypes.c_void_p]
        lib.PQerrorMessage.restype = ctypes.c_char_p
        lib.PQerrorMessage.argtypes = [ctypes.c_void_p]
        lib.PQfinish.argtypes = [ctypes.c_void_p]
        lib.PQexecParams.restype = ctypes.c_void_p
        lib.PQexecParams.argtypes = [
            ctypes.c_void_p,  # conn
            ctypes.c_char_p,  # command
            ctypes.c_int,  # nParams
            ctypes.c_void_p,  # paramTypes (NULL = infer)
            ctypes.POINTER(ctypes.c_char_p),  # paramValues
            ctypes.POINTER(ctypes.c_int),  # paramLengths
            ctypes.POINTER(ctypes.c_int),  # paramFormats
            ctypes.c_int,  # resultFormat (0 = text)
        ]
        lib.PQresultStatus.argtypes = [ctypes.c_void_p]
        lib.PQresultErrorMessage.restype = ctypes.c_char_p
        lib.PQresultErrorMessage.argtypes = [ctypes.c_void_p]
        lib.PQntuples.argtypes = [ctypes.c_void_p]
        lib.PQnfields.argtypes = [ctypes.c_void_p]
        lib.PQgetvalue.restype = ctypes.POINTER(ctypes.c_char)
        lib.PQgetvalue.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.PQgetlength.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.PQgetisnull.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.PQftype.restype = ctypes.c_uint
        lib.PQftype.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.PQfname.restype = ctypes.c_char_p
        lib.PQfname.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.PQcmdTuples.restype = ctypes.c_char_p
        lib.PQcmdTuples.argtypes = [ctypes.c_void_p]
        lib.PQclear.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def placeholders_to_dollar(sql: str) -> str:
    """Rewrite psycopg-style ``%s`` placeholders to libpq ``$N`` (skipping
    string literals so a literal percent inside quotes survives)."""
    out: list[str] = []
    n = 0
    i = 0
    in_str = False
    while i < len(sql):
        ch = sql[i]
        if ch == "'":
            in_str = not in_str
            out.append(ch)
            i += 1
        elif not in_str and sql.startswith("%s", i):
            n += 1
            out.append(f"${n}")
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _encode_param(p: Any) -> tuple[bytes | None, int]:
    """(wire bytes, format) — format 1 = binary (bytea), 0 = text."""
    if p is None:
        return None, 0
    if isinstance(p, bool):
        return (b"t" if p else b"f"), 0
    if isinstance(p, (bytes, bytearray, memoryview)):
        return bytes(p), 1
    if isinstance(p, (int, float)):
        return str(p).encode(), 0
    return str(p).encode(), 0


def _decode_value(raw: bytes, oid: int) -> Any:
    if oid in _OID_INT:
        return int(raw)
    if oid in _OID_FLOAT:
        return float(raw)
    if oid in _OID_BOOL:
        return raw == b"t"
    if oid in _OID_BYTEA:
        # text-format bytea is hex: \x0123ab...
        if raw.startswith(b"\\x"):
            return bytes.fromhex(raw[2:].decode())
        return raw
    return raw.decode("utf-8")


class Cursor:
    """DB-API-flavored cursor over one result at a time."""

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._rows: list[tuple] = []
        self._pos = 0
        self.rowcount = -1
        self.description: list[tuple] | None = None

    def execute(self, sql: str, params: Sequence = ()) -> "Cursor":
        lib = _libpq()
        encoded = [_encode_param(p) for p in params]
        n = len(encoded)
        values = (ctypes.c_char_p * n)(
            *[v for v, _ in encoded]
        ) if n else None
        lengths = (ctypes.c_int * n)(
            *[len(v) if v is not None else 0 for v, _ in encoded]
        ) if n else None
        formats = (ctypes.c_int * n)(*[f for _, f in encoded]) if n else None
        res = lib.PQexecParams(
            self._conn._conn,
            placeholders_to_dollar(sql).encode(),
            n, None, values, lengths, formats, 0,
        )
        if not res:
            # NULL result: connection lost / out of memory — the error
            # lives on the connection, not the (absent) result
            msg = lib.PQerrorMessage(self._conn._conn).decode(
                "utf-8", "replace"
            ).strip()
            raise PQError(msg or "PQexecParams returned no result")
        try:
            status = lib.PQresultStatus(res)
            if status not in (PGRES_COMMAND_OK, PGRES_TUPLES_OK):
                msg = lib.PQresultErrorMessage(res).decode(
                    "utf-8", "replace"
                ).strip()
                raise PQError(f"{msg} (sql: {sql[:200]})")
            self._rows = []
            self._pos = 0
            self.description = None
            if status == PGRES_TUPLES_OK:
                nt, nf = lib.PQntuples(res), lib.PQnfields(res)
                oids = [lib.PQftype(res, c) for c in range(nf)]
                self.description = [
                    (lib.PQfname(res, c).decode(), oids[c], None, None,
                     None, None, None)
                    for c in range(nf)
                ]
                for r in range(nt):
                    row = []
                    for c in range(nf):
                        if lib.PQgetisnull(res, r, c):
                            row.append(None)
                            continue
                        ln = lib.PQgetlength(res, r, c)
                        raw = ctypes.string_at(lib.PQgetvalue(res, r, c), ln)
                        row.append(_decode_value(raw, oids[c]))
                    self._rows.append(tuple(row))
                self.rowcount = nt
            else:
                tup = lib.PQcmdTuples(res)
                self.rowcount = int(tup) if tup else -1
        finally:
            lib.PQclear(res)
        return self

    def executemany(self, sql: str, rows: Sequence[Sequence]) -> "Cursor":
        for r in rows:
            self.execute(sql, r)
        return self

    def fetchone(self):
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchall(self):
        rows = self._rows[self._pos :]
        self._pos = len(self._rows)
        return rows


class Connection:
    """Autocommit libpq connection (no explicit transactions — matching
    the autocommit mode PGClient requests from psycopg)."""

    def __init__(self, url: str):
        lib = _libpq()
        self._conn = lib.PQconnectdb(url.encode())
        if lib.PQstatus(self._conn) != CONNECTION_OK:
            msg = lib.PQerrorMessage(self._conn).decode("utf-8", "replace")
            lib.PQfinish(self._conn)
            self._conn = None
            raise PQError(f"connection failed: {msg.strip()}")

    def cursor(self) -> Cursor:
        return Cursor(self)

    def close(self) -> None:
        if self._conn is not None:
            _libpq().PQfinish(self._conn)
            self._conn = None

    def __del__(self):  # belt and braces; close() is the real path
        try:
            self.close()
        except Exception:
            pass


def connect(url: str) -> Connection:
    return Connection(url)


def available() -> bool:
    """True when libpq is loadable on this host."""
    try:
        _libpq()
        return True
    except OSError:
        return False
