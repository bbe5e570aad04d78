"""PostgreSQL wire-protocol server.

Port of hyrise_tpu/server.py (reference: src/lib/server/ — boost::asio
sessions speaking the PostgreSQL protocol, server_session.cpp:67-110's
message loop, PostgresWireHandler, QueryResponseBuilder's row description
and data rows — and src/bin/server.cpp). A threaded socketserver, one
thread a session: the startup handshake (SSL refused, AuthenticationOk,
ParameterStatus), SimpleQuery, and the extended protocol's Parse / Bind /
Describe / Execute / Close / Sync / Flush, all in text format.

Every statement runs through SQLPipelineBuilder over the server's Catalog
with MVCC on (reads see committed rows only; a write commits on its own)
and with the plan cache, which hands every caller an operator tree of its
own. A session keeps its own SQL PREPARE statements, as PostgreSQL does.
Where the JAX server is wrong, this one follows the protocol (ROADMAP C2):

- Bind to a statement that was never parsed answers ErrorResponse.
- After an error in the extended protocol, every message up to the next
  Sync is skipped; Sync answers ReadyForQuery.
- Describe of a statement answers ParameterDescription, then the
  RowDescription of a statement that returns rows and NoData of one that
  does not. The port infers no column types from a plan, and a literal's
  type follows its value (an int is int4 or int8 by its size, NULL has a
  type of its own), so a result's types can depend on the values bound to
  the parameters and on those of uncorrelated scalar subqueries. Describe
  therefore runs the statement over zero-row copies of the catalog's tables
  on the CPU once for every combination of a value of each type that each
  parameter (by its declared type; any type where Parse declared none) and
  each scalar subquery (by its column's type) can take, NULL included: no
  stored row is read and nothing runs on the card. A run that fails stands
  for values with which Execute answers an error and sends no row (a NULL
  compared with a string column). Describe answers the RowDescription where
  every other run gives the same one, and ErrorResponse 42P18, as
  PostgreSQL does for a type it cannot determine, where they differ, where
  every run fails, or where there would be more than _DESCRIBE_RUNS runs.
  Describe of a portal runs the bound statement and describes its result.
- CommandComplete carries PostgreSQL's tag for the statement: SELECT n,
  INSERT 0 n, UPDATE n, DELETE n, CREATE TABLE, and so on.

    python -m hyrise_tpu_torch.server --port 5432 --tpch 1 [--device cpu]

generates TPC-H at SF1 on the card (the default device; it raises where
there is none) and serves it.
"""

from __future__ import annotations

import socketserver
import struct
import threading
from typing import List, Optional

import torch

from hyrise_tpu_torch.concurrency.transaction import TransactionConflict
from hyrise_tpu_torch.ops.materialize import ensure_prefix
from hyrise_tpu_torch.sql import parser as P
from hyrise_tpu_torch.sql.pipeline import (SQLPipelineBuilder, SQLPipelineStatement,
                                           UnknownPreparedStatement, prepared_statement)
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType

_OID_INT2 = 21
_OID_INT8 = 20
_OID_INT4 = 23
_OID_FLOAT4 = 700
_OID_FLOAT8 = 701
_OID_NUMERIC = 1700
_OID_TEXT = 25

_TYPE_OID = {
    DataType.INT32: _OID_INT4,
    DataType.INT64: _OID_INT8,
    DataType.FLOAT32: _OID_FLOAT4,
    DataType.FLOAT64: _OID_FLOAT8,
    DataType.STRING: _OID_TEXT,
    DataType.NULL: _OID_TEXT,
}
_INT_OIDS = (_OID_INT2, _OID_INT4, _OID_INT8)
_INT_LIMIT = {_OID_INT2: 2**15, _OID_INT4: 2**31, _OID_INT8: 2**63}
_FLOAT_OIDS = (_OID_FLOAT4, _OID_FLOAT8, _OID_NUMERIC)

# SQLSTATE codes of the errors the server answers with
_SYNTAX_ERROR = "42601"
_SERIALIZATION_FAILURE = "40001"
_UNKNOWN_STATEMENT = "26000"
_UNKNOWN_PORTAL = "34000"
_INDETERMINATE_TYPE = "42P18"
_OUT_OF_RANGE = "22003"
_NOT_SUPPORTED = "0A000"

# statements that return no rows, and their CommandComplete tags
_NO_ROWS_TAGS = {P.CreateTableStmt: "CREATE TABLE", P.DropTableStmt: "DROP TABLE",
                 P.CreateViewStmt: "CREATE VIEW", P.DropViewStmt: "DROP VIEW",
                 P.PrepareStmt: "PREPARE"}
_DML = (P.InsertStmt, P.UpdateStmt, P.DeleteStmt)


class ProtocolError(Exception):
    """An error the session answers with ErrorResponse and `sqlstate`."""

    def __init__(self, message: str, sqlstate: str):
        super().__init__(message)
        self.sqlstate = sqlstate


def _typed_param(text: str, oid: int) -> object:
    """Decode a text-format Bind parameter by its Parse-declared type OID;
    with no declared OID, a number where the text reads as one (client
    libraries send untyped placeholders)."""
    if oid in _INT_OIDS:
        v = int(text)
        if not -_INT_LIMIT[oid] <= v < _INT_LIMIT[oid]:
            raise ProtocolError(f"value {text} is out of range for its type", _OUT_OF_RANGE)
        return v
    if oid in _FLOAT_OIDS:
        return float(text)
    if oid:
        return text
    try:
        return int(text)
    except ValueError:
        try:
            return float(text)
        except ValueError:
            return text


# Describe of a statement: one value of each literal type (an int32, an
# int64, NULL) a value can take, and the most runs it makes
_INT_VALUES = (0, 2**40, None)
_DESCRIBE_RUNS = 256


def _param_values(oid: int) -> tuple:
    """A value of each literal type a parameter declared `oid` can be bound
    to (Bind refuses an int2 or int4 out of its range)."""
    if oid in (_OID_INT2, _OID_INT4):
        return (0, None)
    if oid == _OID_INT8:
        return _INT_VALUES
    if oid in _FLOAT_OIDS:
        return (0.0, None)
    if oid:
        return ("", None)
    return (0, 2**40, 0.0, "", None)


def _scalar_values(dtype: DataType) -> tuple:
    """A value of each literal type a scalar subquery with a column of
    `dtype` can stand for (SQLPipelineStatement._scalar_value)."""
    if dtype.is_integral:
        return _INT_VALUES
    if dtype is DataType.STRING:
        return ("", None)
    if dtype is DataType.NULL:
        return (None,)
    return (0.0, None)


class _Choices:
    """Every combination of the choices that runs make, one run at a time: a
    run calls pick() at each choice, then next() moves to the next
    combination (the last choice first) and is False after the last."""

    def __init__(self):
        self._path: List[List[int]] = []  # [index, number of values] a choice
        self._at = 0

    def pick(self, values: tuple) -> object:
        if self._at == len(self._path):
            self._path.append([0, len(values)])
        i = self._path[self._at][0]
        self._at += 1
        return values[i]

    def next(self) -> bool:
        del self._path[self._at:]
        self._at = 0
        while self._path:
            self._path[-1][0] += 1
            if self._path[-1][0] < self._path[-1][1]:
                return True
            self._path.pop()
        return False


class _DescribeRun(SQLPipelineStatement):
    """A statement over zero-row tables whose scalar subqueries stand for the
    values `choices` picks."""

    def __init__(self, stmt, sql: str, catalog: Catalog, params, choices: _Choices):
        super().__init__(stmt, sql, catalog, None, use_cache=False, params=params)
        self.choices = choices

    def _scalar_value(self, t: Table):
        return self.choices.pick(_scalar_values(t.columns[0].dtype))


def _pack_msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _effective(stmt, prepared: dict):
    """The statement whose kind decides the answer: EXECUTE's prepared one
    in the session's map `prepared`."""
    if isinstance(stmt, P.ExecuteStmt):
        inner = prepared_statement(stmt.name, prepared)
        return stmt if inner is None else inner
    return stmt


def _returns_rows(stmt, prepared: dict) -> bool:
    stmt = _effective(stmt, prepared)
    return not isinstance(stmt, _DML) and type(stmt) not in _NO_ROWS_TAGS


def _command_tag(stmt, result: Table, plan, prepared: dict) -> str:
    stmt = _effective(stmt, prepared)
    if isinstance(stmt, _DML):
        # the rows the Insert appends, the Delete or the Update changes:
        # its first input's
        n = plan.inputs[0].get_output().num_rows
        return {P.InsertStmt: f"INSERT 0 {n}", P.UpdateStmt: f"UPDATE {n}",
                P.DeleteStmt: f"DELETE {n}"}[type(stmt)]
    if type(stmt) in _NO_ROWS_TAGS:
        return _NO_ROWS_TAGS[type(stmt)]
    if isinstance(stmt, P.ExplainStmt):
        return "EXPLAIN"
    if isinstance(stmt, P.ShowStmt):
        return "SHOW"
    return f"SELECT {result.num_rows}"


def _zero_row_catalog(catalog: Catalog) -> Catalog:
    """The catalog's tables with their columns' types and dictionaries and no
    row, on the CPU, and its views."""
    out = Catalog(device="cpu")
    for name in catalog.table_names():
        cols = [Column(c.name, c.dtype, torch.empty(0, dtype=c.dtype.torch_dtype),
                       None, c.dictionary)
                for c in catalog.get_table(name).columns]
        out.add_table(name, Table(cols, 0, name=name))
    for name in catalog.view_names():
        out.add_view(name, catalog.get_view(name))
    return out


def _row_description(table: Table) -> bytes:
    out = struct.pack("!H", len(table.columns))
    for c in table.columns:
        out += _cstr(c.name) + struct.pack("!IhIhih", 0, 0, _TYPE_OID[c.dtype], -1, -1, 0)
    return out


def _data_rows(table: Table) -> bytes:
    """One DataRow message a row, in text format. Each column is copied to
    the host once and formatted value by value (str of the decoded value,
    as the JAX server formats it); the rows are then joined from the
    columns."""
    prefix = ensure_prefix(table)
    n = prefix.num_rows
    null = struct.pack("!i", -1)
    columns = []
    for c in prefix.columns:
        cells = []
        for v in c.decode(n):
            if v is None:
                cells.append(null)
            else:
                b = str(v).encode()
                cells.append(struct.pack("!i", len(b)) + b)
        columns.append(cells)
    header = struct.pack("!H", len(columns))
    return b"".join(_pack_msg(b"D", header + b"".join(row)) for row in zip(*columns))


class _Parsed:
    """A statement of Parse: its text, declared parameter types and parse
    tree."""

    def __init__(self, sql: str, oids: List[int]):
        parser = P.Parser(P.tokenize(sql), sql)
        statements = parser.parse_statements()
        if len(statements) > 1:
            raise ProtocolError("cannot insert multiple commands into a prepared "
                                "statement", _SYNTAX_ERROR)
        self.sql = sql
        self.stmt = statements[0] if statements else None
        self.oids = oids + [0] * (parser.n_params - len(oids))


class _Portal:
    """A bound statement of Bind, and its result once Describe ran it."""

    def __init__(self, parsed: _Parsed, params: Optional[List[object]]):
        self.parsed = parsed
        self.params = params
        self.result: Optional[tuple] = None  # (statement, result, plan)


class _Session:
    """One client connection (reference: ServerSessionImpl)."""

    def __init__(self, rfile, wfile, server: "Server"):
        self.rfile = rfile
        self.wfile = wfile
        self.server = server
        self.catalog = server.catalog
        self._statements: dict = {}    # name -> _Parsed
        self._portals: dict = {}       # name -> _Portal
        self._prepared: dict = {}      # SQL PREPARE's name -> parse tree
        self._skipping = False         # after an extended-protocol error, until Sync

    # -- low-level -----------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        data = b""
        while len(data) < n:
            chunk = self.rfile.read(n - len(data))
            if not chunk:
                raise ConnectionError("client closed")
            data += chunk
        return data

    def _send(self, tag: bytes, payload: bytes = b"") -> None:
        self.wfile.write(_pack_msg(tag, payload))

    def _flush(self) -> None:
        self.wfile.flush()

    # -- startup -------------------------------------------------------------

    def startup(self) -> bool:
        while True:
            length = struct.unpack("!I", self._read_exact(4))[0]
            body = self._read_exact(length - 4)
            proto = struct.unpack("!I", body[:4])[0]
            if proto != 80877103:  # not SSLRequest
                break
            self.wfile.write(b"N")  # SSL refused: go on in plain text
            self._flush()
        if proto == 80877102:  # CancelRequest
            return False
        self._send(b"R", struct.pack("!I", 0))  # AuthenticationOk
        for k, v in (("server_version", "14.0 (hyrise_tpu_torch)"),
                     ("client_encoding", "UTF8")):
            self._send(b"S", _cstr(k) + _cstr(v))
        self._ready()
        return True

    def _ready(self) -> None:
        self._send(b"Z", b"I")
        self._flush()

    # -- responses -----------------------------------------------------------

    def _send_error(self, message: str, sqlstate: str = _SYNTAX_ERROR) -> None:
        payload = b"SERROR\x00" + b"C" + _cstr(sqlstate) + b"M" + _cstr(message) + b"\x00"
        self._send(b"E", payload)

    def _send_exception(self, e: Exception) -> None:
        if isinstance(e, ProtocolError):
            self._send_error(str(e), e.sqlstate)
        elif isinstance(e, TransactionConflict):
            self._send_error(str(e), _SERIALIZATION_FAILURE)
        elif isinstance(e, UnknownPreparedStatement):
            self._send_error(str(e), _UNKNOWN_STATEMENT)
        else:
            self._send_error(str(e))

    def _send_result(self, stmt, result: Table, plan, describe: bool) -> None:
        """The rows of a statement that returns rows (after their
        RowDescription if `describe`), then CommandComplete."""
        if _returns_rows(stmt, self._prepared):
            if describe:
                self._send(b"T", _row_description(result))
            self.wfile.write(_data_rows(result))
        self._send(b"C", _cstr(_command_tag(stmt, result, plan, self._prepared)))

    # -- statements ----------------------------------------------------------

    def _pipeline(self, sql: str, params=None):
        return (SQLPipelineBuilder(sql).with_catalog(self.catalog)
                .with_mvcc(True).with_prepared(self._prepared).with_params(params)
                .create_pipeline())

    def _run_simple(self, sql: str) -> None:
        pipeline = self._pipeline(sql)
        if not pipeline.statements:
            self._send(b"I")  # EmptyQueryResponse
            return
        for ps, result in pipeline.execute_statements():
            self._send_result(ps.stmt, result, getattr(ps, "last_plan", None),
                              describe=True)

    def _run_portal(self, portal: _Portal) -> tuple:
        pipeline = self._pipeline(portal.parsed.sql, portal.params)
        (ps, result), = pipeline.execute_statements()
        return ps.stmt, result, getattr(ps, "last_plan", None)

    def _describe_statement(self, parsed: _Parsed) -> None:
        self._send(b"t", struct.pack("!H", len(parsed.oids))
                   + b"".join(struct.pack("!I", o) for o in parsed.oids))
        if parsed.stmt is None or not _returns_rows(parsed.stmt, self._prepared):
            self._send(b"n")  # NoData
            return
        if isinstance(parsed.stmt, P.ExecuteStmt):
            raise ProtocolError("the result types of EXECUTE are known after Bind: "
                                "describe the portal", _INDETERMINATE_TYPE)
        zero_rows = self.server.zero_row_catalog()
        choices, described, failed = _Choices(), set(), None
        for _ in range(_DESCRIBE_RUNS):
            params = [choices.pick(_param_values(o)) for o in parsed.oids] or None
            # parsed anew: a run must not see what an earlier one did to its tree
            stmt, = P.parse_sql(parsed.sql)
            try:
                result = _DescribeRun(stmt, parsed.sql, zero_rows, params, choices).execute()
                described.add(_row_description(result))
            except Exception as e:  # these values give an error, not rows
                failed = failed or e
            if len(described) > 1:
                raise ProtocolError("the result's column types depend on the values of "
                                    "its parameters or scalar subqueries",
                                    _INDETERMINATE_TYPE)
            if not choices.next():
                if not described:
                    raise ProtocolError(f"could not determine the result columns: "
                                        f"{failed}", _INDETERMINATE_TYPE) from failed
                self._send(b"T", described.pop())
                return
        raise ProtocolError(f"the result's column types may depend on more than "
                            f"{_DESCRIBE_RUNS} combinations of the types of its "
                            f"parameters and scalar subqueries", _INDETERMINATE_TYPE)

    # -- the extended protocol -------------------------------------------------

    def _parse(self, body: bytes) -> None:
        name, rest = body.split(b"\x00", 1)
        sql, rest = rest.split(b"\x00", 1)
        n_oids = struct.unpack("!H", rest[:2])[0] if len(rest) >= 2 else 0
        oids = [struct.unpack("!I", rest[2 + 4 * i:6 + 4 * i])[0] for i in range(n_oids)]
        self._statements[name.decode()] = _Parsed(sql.decode(), oids)
        self._send(b"1")  # ParseComplete

    def _bind(self, body: bytes) -> None:
        portal_name, stmt_name, rest = body.split(b"\x00", 2)
        parsed = self._statements.get(stmt_name.decode())
        if parsed is None:
            raise ProtocolError(f"prepared statement {stmt_name.decode()!r} does not "
                                "exist", _UNKNOWN_STATEMENT)
        n_formats = struct.unpack("!H", rest[:2])[0]
        formats = struct.unpack(f"!{n_formats}H", rest[2:2 + 2 * n_formats])
        off = 2 + 2 * n_formats
        if any(formats):
            raise ProtocolError("binary parameters are not supported", _NOT_SUPPORTED)
        n_params = struct.unpack("!H", rest[off:off + 2])[0]
        off += 2
        # typed values, substituted as literal nodes by the pipeline: a
        # string holding quotes or '?' stays one literal, never re-parsed SQL
        params: List[object] = []
        for i in range(n_params):
            plen = struct.unpack("!i", rest[off:off + 4])[0]
            off += 4
            if plen < 0:
                params.append(None)
                continue
            text = rest[off:off + plen].decode()
            off += plen
            params.append(_typed_param(text, parsed.oids[i] if i < len(parsed.oids) else 0))
        n_results = struct.unpack("!H", rest[off:off + 2])[0]
        if any(struct.unpack(f"!{n_results}H", rest[off + 2:off + 2 + 2 * n_results])):
            raise ProtocolError("binary results are not supported", _NOT_SUPPORTED)
        self._portals[portal_name.decode()] = _Portal(parsed, params or None)
        self._send(b"2")  # BindComplete

    def _portal(self, name: str) -> _Portal:
        portal = self._portals.get(name)
        if portal is None:
            raise ProtocolError(f"portal {name!r} does not exist", _UNKNOWN_PORTAL)
        return portal

    def _describe(self, body: bytes) -> None:
        kind, name = body[:1], body[1:].split(b"\x00")[0].decode()
        if kind == b"S":
            parsed = self._statements.get(name)
            if parsed is None:
                raise ProtocolError(f"prepared statement {name!r} does not exist",
                                    _UNKNOWN_STATEMENT)
            self._describe_statement(parsed)
            return
        portal = self._portal(name)
        if portal.parsed.stmt is None or not _returns_rows(portal.parsed.stmt,
                                                            self._prepared):
            self._send(b"n")
            return
        # run now for the result's own description; Execute sends its rows
        portal.result = self._run_portal(portal)
        self._send(b"T", _row_description(portal.result[1]))

    def _execute(self, body: bytes) -> None:
        portal = self._portal(body.split(b"\x00")[0].decode())
        if portal.parsed.stmt is None:
            self._send(b"I")
            return
        stmt, result, plan = portal.result or self._run_portal(portal)
        portal.result = None
        self._send_result(stmt, result, plan, describe=False)

    def _close(self, body: bytes) -> None:
        kind, name = body[:1], body[1:].split(b"\x00")[0].decode()
        (self._statements if kind == b"S" else self._portals).pop(name, None)
        self._send(b"3")  # CloseComplete

    # -- message loop --------------------------------------------------------

    def serve(self) -> None:
        if not self.startup():
            return
        extended = {b"P": self._parse, b"B": self._bind, b"D": self._describe,
                    b"E": self._execute, b"C": self._close}
        while True:
            tag = self.rfile.read(1)
            if not tag or tag == b"X":  # Terminate
                return
            length = struct.unpack("!I", self._read_exact(4))[0]
            body = self._read_exact(length - 4)
            if tag == b"S":  # Sync ends an extended-protocol run, failed or not
                self._skipping = False
                self._ready()
            elif self._skipping:
                continue
            elif tag == b"Q":  # SimpleQuery
                try:
                    self._run_simple(body.rstrip(b"\x00").decode())
                except Exception as e:  # the session goes on after a failed statement
                    self._send_exception(e)
                self._ready()
            elif tag in extended:
                try:
                    extended[tag](body)
                except Exception as e:  # reported, then skip until Sync
                    self._send_exception(e)
                    self._skipping = True
            elif tag == b"H":  # Flush
                self._flush()
            else:
                self._send_error(f"unsupported message {tag!r}", _NOT_SUPPORTED)
                self._ready()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            _Session(self.rfile, self.wfile, self.server).serve()
        except ConnectionError:
            pass  # the client went away


class Server(socketserver.ThreadingTCPServer):
    """Reference: bin/server.cpp — listens and serves each session on a
    thread of its own. port=0 takes a free port (`server_address[1]`)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 5432, *, catalog: Catalog):
        super().__init__((host, port), _Handler)
        self.catalog = catalog
        self._zero_rows: Optional[tuple] = None  # (the tables and views, their copies)
        self._zero_rows_lock = threading.Lock()

    def zero_row_catalog(self) -> Catalog:
        """The catalog's tables without rows, on the CPU, for Describe; made
        again when a table or a view has been replaced (a write replaces
        the table it appends to)."""
        cat = self.catalog
        current = [(n, cat.get_table(n)) for n in cat.table_names()] + \
            [(n, cat.get_view(n)) for n in cat.view_names()]
        with self._zero_rows_lock:
            if self._zero_rows is None or len(self._zero_rows[0]) != len(current) or \
                    any(a[0] != b[0] or a[1] is not b[1]
                        for a, b in zip(self._zero_rows[0], current)):
                self._zero_rows = (current, _zero_row_catalog(cat))
            return self._zero_rows[1]

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


def main(argv=None):
    import argparse

    from hyrise_tpu_torch.console import checked_device
    from hyrise_tpu_torch.tpch.dbgen import generate_tables

    p = argparse.ArgumentParser(description="hyrise_tpu_torch PostgreSQL server")
    p.add_argument("--port", type=int, default=5432)
    p.add_argument("--tpch", type=float, default=None,
                   help="generate TPC-H tables at this scale factor")
    p.add_argument("--device", default="cuda",
                   help="where the tables live (cuda or cpu)")
    args = p.parse_args(argv)
    catalog = Catalog(device=checked_device(args.device))
    if args.tpch:
        for name, t in generate_tables(args.tpch, device=catalog.device).items():
            catalog.add_table(name, t)
    srv = Server(port=args.port, catalog=catalog)
    print(f"hyrise_tpu_torch server listening on :{args.port} ({catalog.device})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
