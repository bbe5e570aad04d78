"""The port's PostgreSQL wire server (hyrise_tpu_torch/server.py) against the
JAX package's (hyrise_tpu/server.py), and against the protocol where the JAX
server is wrong (ROADMAP C2).

Both servers run on ephemeral ports over equal catalogs (the port's built
from the JAX tables with storage/interop.py) and answer the same message
sequences from a minimal client that speaks the raw protocol
(hyrise_tpu_torch/pg_client.py: tests/test_server.py's client with buffered
reads, which chip_smoke.py uses too). Message tags, RowDescriptions and
CommandComplete tags must be equal; DataRows equal with ints and strings byte for byte and
floats within 1e-6 relative, in order where the statement has ORDER BY."""

import os
import re
import struct
import sys
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.server import Server as JaxServer
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.utils.table_eq import tables_equal
from hyrise_tpu_torch.concurrency.transaction import MvccData
from hyrise_tpu_torch.pg_client import (PgClient, command_tags, row_description, tags,
                                        text_rows, typed_rows)
from hyrise_tpu_torch.server import Server, main as server_main
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.tpch.queries import TPCH_SQL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH_SF = 0.01
QUERY_SF = {20: 0.05}  # where Q20 returns rows


def same_answer(got, want, ordered):
    assert [t for t, _ in got] == [t for t, _ in want]
    assert command_tags(got) == command_tags(want)
    if not any(t == b"T" for t, _ in want):
        return
    assert [b for t, b in got if t == b"T"] == [b for t, b in want if t == b"T"]
    ok, msg = tables_equal(typed_rows(got), typed_rows(want),
                           ordered=ordered, rel_tol=1e-6, abs_tol=0.0)
    assert ok, msg


def port_table(name, jt):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy(name, cols, jt.num_rows, live, device="cpu")


def small_tables():
    rng = np.random.default_rng(11)
    return {
        "t": JaxTable.from_pandas("t", pd.DataFrame({
            "a": np.array([1, 2, 3, 4, 5, 6], dtype=np.int32),
            "b": np.array([10, -20, 30, -40, 50, 2**40], dtype=np.int64),
            "f": (rng.random(6) * 100).astype(np.float32),
            "d": np.array([0.1, 1e-300, -2.5, 1e16, 3.25, -0.0]),
            "s": np.array(["x", "it's", "z", "x", "é?", ""], dtype=object),
        })),
        "n": JaxTable.from_pandas("n", pd.DataFrame({
            "k": pd.array([1, None, 3, 2, None], dtype="Int32"),
            "v": pd.array([0.5, 1.5, None, 2.5, 4.0], dtype="Float64"),
            "w": np.array(["p", None, "q", "p", "r"], dtype=object),
        })),
        "empty_t": JaxTable.from_pandas("empty_t", pd.DataFrame(
            {"x": np.array([], dtype=np.int32)})),
    }


SMALL_STATEMENTS = [
    "SELECT a, s FROM t WHERE a > 1 ORDER BY a",
    "SELECT * FROM t ORDER BY a DESC",
    "SELECT a, b, f, d FROM t WHERE b < 0 ORDER BY b",
    "SELECT s, COUNT(*) AS c, SUM(b) AS sb, AVG(f) AS af FROM t GROUP BY s ORDER BY s",
    "SELECT MIN(d), MAX(d), SUM(d) FROM t",
    "SELECT k, v, w FROM n ORDER BY v",
    "SELECT w, COUNT(k), SUM(v) FROM n GROUP BY w ORDER BY w",
    "SELECT t.a, n.w FROM t JOIN n ON t.a = n.k ORDER BY t.a",
    "SELECT a * 2 + 1 AS y, b / 10 AS z FROM t WHERE s = 'x' ORDER BY y",
    "SELECT x FROM empty_t",
    "SELECT COUNT(*) FROM empty_t",
    "SELECT a FROM t WHERE s LIKE '%?%' OR s = 'it''s' ORDER BY a",
    "SELECT DISTINCT w FROM n WHERE w IS NOT NULL ORDER BY w",
    "SELECT nope FROM t",
    "SELEKT 1",
]


@pytest.fixture(scope="module")
def small_servers():
    tables = small_tables()
    jcat, cat = JaxCatalog(), Catalog(device="cpu")
    for name, jt in tables.items():
        jcat.add_table(name, jt)
        cat.add_table(name, port_table(name, jt))
    jsrv, srv = JaxServer(port=0, catalog=jcat), Server(port=0, catalog=cat)
    jsrv.serve_background()
    srv.serve_background()
    yield jsrv, srv
    for s in (jsrv, srv):
        s.shutdown()
        s.server_close()


def connect(server):
    c = PgClient(server.server_address[1])
    c.startup()
    return c


@pytest.mark.parametrize("sql", SMALL_STATEMENTS)
def test_simple_query_matches_jax(small_servers, sql):
    jsrv, srv = small_servers
    jc, c = connect(jsrv), connect(srv)
    try:
        same_answer(c.query(sql), jc.query(sql), ordered="ORDER BY" in sql)
    finally:
        jc.close()
        c.close()


@pytest.mark.parametrize("sql,params,oids", [
    ("SELECT k FROM n WHERE w = ?", ["p"], [25]),
    ("SELECT a, s FROM t WHERE b > ? ORDER BY a", [0], [20]),
    ("SELECT s FROM t WHERE s = ?", ["it's"], [25]),
    ("SELECT a FROM t WHERE d < ? ORDER BY a", [1.5], [701]),
    ("SELECT a FROM t WHERE a BETWEEN ? AND ? ORDER BY a", [2, 4], []),
])
def test_extended_query_matches_jax(small_servers, sql, params, oids):
    """Parse / Bind / Describe(portal) / Execute / Sync, as tests/test_server.py
    sends them."""
    jsrv, srv = small_servers
    answers = []
    for server in (srv, jsrv):
        c = connect(server)
        c.parse(sql, oids)
        c.bind(params)
        c.describe(b"P")
        c.execute()
        answers.append((c, c.sync()))
        c.close()
    (c, got), (_, want) = answers
    assert not any(t == b"E" for t, _ in got), got
    same_answer(got, want, ordered="ORDER BY" in sql)


_tpch_state = {}


def tpch_servers(sf):
    if sf not in _tpch_state:
        jcat, cat = JaxCatalog(), Catalog(device="cpu")
        for name, jt in jax_generate_tables(sf).items():
            jcat.add_table(name, jt)
            cat.add_table(name, port_table(name, jt))
        jsrv, srv = JaxServer(port=0, catalog=jcat), Server(port=0, catalog=cat)
        jsrv.serve_background()
        srv.serve_background()
        _tpch_state[sf] = (jsrv, srv)
    return _tpch_state[sf]


@pytest.fixture(scope="module", autouse=True)
def _close_tpch_servers():
    yield
    for jsrv, srv in _tpch_state.values():
        for s in (jsrv, srv):
            s.shutdown()
            s.server_close()
    _tpch_state.clear()


@pytest.mark.parametrize("qid", sorted(TPCH_SQL))
def test_tpch_text_matches_jax(qid):
    jsrv, srv = tpch_servers(QUERY_SF.get(qid, TPCH_SF))
    jc, c = connect(jsrv), connect(srv)
    try:
        got, want = c.query(TPCH_SQL[qid]), jc.query(TPCH_SQL[qid])
        assert not any(t == b"E" for t, _ in got), got
        if qid != 2:  # Q2's double equality on price can be empty at a tiny SF
            assert text_rows(got)
        same_answer(got, want, ordered="ORDER BY" in TPCH_SQL[qid].upper())
    finally:
        jc.close()
        c.close()


_COMPARED_LITERAL = re.compile(r"((?:<>|<=|>=|=|<|>|\bbetween|\band)\s*)'([^']*)'", re.I)


def with_placeholders(sql):
    """The text with each string literal after a comparison, BETWEEN or AND
    as a placeholder, and those literals in order."""
    values = [m.group(2) for m in _COMPARED_LITERAL.finditer(sql)]
    return _COMPARED_LITERAL.sub(lambda m: m.group(1) + "?", sql), values


@pytest.mark.parametrize("qid", sorted(TPCH_SQL))
def test_describe_statement_matches_the_executed_portal(qid):
    """Describe of each TPC-H text's statement, as written and with its
    compared string literals as text parameters, is the RowDescription that
    Describe of the bound portal gives after running it, byte for byte; the
    template's rows equal the text's."""
    _, srv = tpch_servers(QUERY_SF.get(qid, TPCH_SF))
    template, values = with_placeholders(TPCH_SQL[qid])
    assert values or qid in (9, 13, 18, 22)  # LIKE and IN only, or no string
    c = connect(srv)
    try:
        rows = []
        for name, text, params in ((b"text", TPCH_SQL[qid], []),
                                   (b"template", template, values)):
            c.parse(text, [25] * len(params), name=name)
            c.describe(b"S", name)
            described = c.sync()
            assert tags(described) == [b"1", b"t", b"T", b"Z"], described
            c.bind(params, statement=name)
            c.describe(b"P")
            c.execute()
            run = c.sync()
            assert tags(run)[:2] == [b"2", b"T"] and b"E" not in tags(run), run[:3]
            assert dict(described)[b"T"] == dict(run)[b"T"]
            rows.append(text_rows(run))
        assert rows[0] == rows[1]
    finally:
        c.close()


# -- ROADMAP C2: where the JAX server is wrong, the protocol decides ------------


@pytest.fixture()
def port_server():
    cat = Catalog(device="cpu")
    for name, jt in small_tables().items():
        cat.add_table(name, port_table(name, jt))
    srv = Server(port=0, catalog=cat)
    srv.serve_background()
    yield srv
    srv.shutdown()
    srv.server_close()


def error_code(msgs):
    body = next(b for t, b in msgs if t == b"E")
    fields = dict((f[:1], f[1:].decode()) for f in body.split(b"\x00") if f)
    return fields[b"C"]


def test_bind_to_unknown_statement_is_an_error(port_server):
    c = connect(port_server)
    c.bind([1], statement=b"never_parsed")
    c.describe(b"P")
    c.execute()
    msgs = c.sync()
    # the error, then nothing until Sync's ReadyForQuery
    assert [t for t, _ in msgs] == [b"E", b"Z"]
    assert error_code(msgs) == "26000"
    assert text_rows(c.query("SELECT a FROM t WHERE a = 1")) == [("1",)]
    c.close()


def test_messages_after_an_error_are_skipped_until_sync(port_server):
    c = connect(port_server)
    c.parse("SELECT nope FROM t WHERE")  # a syntax error at Parse
    c.bind([])
    c.describe(b"P")
    c.execute()
    c.send(b"H")  # Flush, skipped too
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"E", b"Z"]
    # an error at Execute: the second Execute of the same run is skipped
    c.parse("SELECT nope FROM t")
    c.bind([])
    c.execute()
    c.execute()
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"2", b"E", b"Z"]
    # the next run is served again
    c.parse("SELECT a FROM t WHERE a = ?", [23])
    c.bind([2])
    c.execute()
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"2", b"D", b"C", b"Z"]
    assert text_rows(msgs) == [("2",)]
    assert command_tags(msgs) == ["SELECT 1"]
    c.close()


def test_describe_statement_gives_the_row_description(port_server):
    c = connect(port_server)
    c.parse("SELECT a, s, d, b * 2 AS bb, COUNT(*) AS c FROM t WHERE a > ? GROUP BY a, s, d, b",
            [23], name=b"s1")
    c.describe(b"S", b"s1")
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"t", b"T", b"Z"]
    params = dict(msgs)[b"t"]
    assert struct.unpack("!HI", params) == (1, 23)
    assert row_description(msgs) == [("a", 23), ("s", 25), ("d", 701), ("bb", 20),
                                      ("c", 20)]
    # the description is that of the rows Execute then sends
    c.bind([2], statement=b"s1")
    c.describe(b"P")
    c.execute()
    run = c.sync()
    assert row_description(run) == row_description(msgs)
    assert sorted(text_rows(run)) == [("3", "z", "-2.5", "60", "1"),
                                   ("4", "x", "1e+16", "-80", "1"),
                                   ("5", "é?", "3.25", "100", "1"),
                                   ("6", "", "-0.0", str(2**41), "1")]
    # an undeclared parameter compared with a string column: only a string
    # gives rows (any other value is an error), so the rows are described
    c.parse("SELECT a FROM t WHERE s = ?", [], name=b"s2")
    c.describe(b"S", b"s2")
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"t", b"T", b"Z"]
    assert row_description(msgs) == [("a", 23)]
    c.bind(["x"], statement=b"s2")
    c.describe(b"P")
    c.execute()
    run = c.sync()
    assert row_description(run) == [("a", 23)]
    assert sorted(text_rows(run)) == [("1",), ("4",)]
    # an undeclared parameter in the select list: its value's type is the
    # column's, so no single description holds: 42P18, and none is guessed
    c.parse("SELECT a, ? AS p FROM t", [], name=b"s5")
    c.describe(b"S", b"s5")
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"t", b"E", b"Z"]
    assert error_code(msgs) == "42P18"
    # declared, it is described; a statement without rows answers NoData
    c.parse("SELECT a FROM t WHERE s = ?", [25], name=b"s3")
    c.describe(b"S", b"s3")
    c.parse("DELETE FROM t WHERE a = ?", [], name=b"s4")
    c.describe(b"S", b"s4")
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"t", b"T", b"1", b"t", b"n", b"Z"]
    c.close()


@pytest.mark.parametrize("sql,oids,params,describable", [
    # a scalar subquery in WHERE: its value's type cannot reach a column
    ("SELECT a, s FROM t WHERE b > (SELECT AVG(b) FROM t) ORDER BY a", [], [], True),
    # in the select list over an empty result it is NULL (text) when run,
    # over rows an int: no single description holds
    ("SELECT a, (SELECT MAX(b) FROM t WHERE a > 100) AS m FROM t ORDER BY a", [], [], False),
    ("SELECT a, (SELECT MAX(a) FROM t) AS m FROM t ORDER BY a", [], [], False),
    # an int4 parameter keeps its type; an int8's literal is int4 or int8
    # by its size, and NULL has a type of its own
    ("SELECT a + ? AS x FROM t ORDER BY a", [23], [1], True),
    ("SELECT a + ? AS x FROM t ORDER BY a", [20], [2**40], False),
    ("SELECT a FROM t WHERE b < ? ORDER BY a", [20], [2**40], True),
])
def test_describe_statement_holds_for_every_value(port_server, sql, oids, params,
                                                  describable):
    """Describe of a statement gives the RowDescription of the rows Execute
    sends where that holds for every value of its parameters and scalar
    subqueries, and 42P18 where it does not: a description is never
    guessed."""
    c = connect(port_server)
    c.parse(sql, oids, name=b"s")
    c.describe(b"S", b"s")
    described = c.sync()
    c.bind(params, statement=b"s")
    c.describe(b"P")
    c.execute()
    run = c.sync()
    assert [t for t, _ in run][:2] == [b"2", b"T"] and b"E" not in [t for t, _ in run]
    if describable:
        assert [t for t, _ in described] == [b"1", b"t", b"T", b"Z"]
        assert dict(described)[b"T"] == dict(run)[b"T"]
    else:
        assert [t for t, _ in described] == [b"1", b"t", b"E", b"Z"]
        assert error_code(described) == "42P18"
    c.close()


@pytest.mark.parametrize("oid,value,ok", [(21, 2**15 - 1, True), (21, 2**15, False),
                                          (23, -2**31, True), (23, 2**31, False),
                                          (20, 2**40, True), (20, 2**63, False)])
def test_bind_refuses_an_int_out_of_its_declared_range(port_server, oid, value, ok):
    """A parameter declared int2 or int4 is a value of that type: Describe
    counts on it. Out of range, Bind answers 22003, as PostgreSQL does."""
    c = connect(port_server)
    c.parse("SELECT a FROM t WHERE b < ? ORDER BY a", [oid])
    c.bind([value])
    c.execute()
    msgs = c.sync()
    if ok:
        assert tags(msgs)[:2] == [b"1", b"2"] and b"E" not in tags(msgs)
    else:
        assert tags(msgs) == [b"1", b"E", b"Z"]
        assert error_code(msgs) == "22003"
    c.close()


def test_describe_statement_follows_a_replaced_table(port_server):
    """Describe reads zero-row copies of the tables, made again once a write
    has replaced a table: a table created after the first Describe is
    described too."""
    c = connect(port_server)
    c.parse("SELECT COUNT(*) AS c FROM t", [], name=b"s")
    c.describe(b"S", b"s")
    assert row_description(c.sync()) == [("c", 20)]
    c.query("CREATE TABLE later (x DOUBLE, y TEXT)")
    c.query("INSERT INTO later VALUES (1.5, 'a')")
    c.parse("SELECT y, x FROM later", [], name=b"s2")
    c.describe(b"S", b"s2")
    assert row_description(c.sync()) == [("y", 25), ("x", 701)]
    c.close()


def test_close_and_binary_formats(port_server):
    """Close drops a statement (a later Bind to it is an error); binary
    parameters or results are refused: the server speaks text only."""
    c = connect(port_server)
    c.parse("SELECT a FROM t WHERE a = ?", [23], name=b"s")
    c.send(b"C", b"Ss\x00")
    c.bind([1], statement=b"s")
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"3", b"E", b"Z"]
    assert error_code(msgs) == "26000"
    c.parse("SELECT a FROM t WHERE a = ?", [23])
    c.send(b"B", b"\x00\x00" + struct.pack("!HHHi", 1, 1, 1, 4) + struct.pack("!i", 1)
           + struct.pack("!H", 0))
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"E", b"Z"]
    assert error_code(msgs) == "0A000"
    c.parse("SELECT a FROM t WHERE a = ?", [23])
    c.send(b"B", b"\x00\x00" + struct.pack("!HHi", 0, 1, 1) + b"1"
           + struct.pack("!HH", 1, 1))
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"E", b"Z"]
    assert error_code(msgs) == "0A000"
    c.close()


def test_describe_statement_reads_no_stored_row(port_server):
    cat = port_server.catalog
    before = {name: cat.get_table(name) for name in cat.table_names()}
    c = connect(port_server)
    c.parse("SELECT COUNT(*) AS c FROM t", [], name=b"s")
    c.describe(b"S", b"s")
    msgs = c.sync()
    assert row_description(msgs) == [("c", 20)]
    assert not any(t == b"D" for t, _ in msgs)
    assert {name: cat.get_table(name) for name in cat.table_names()} == before
    c.close()


def test_command_tags_follow_the_statement(port_server):
    c = connect(port_server)
    tags = []
    for sql in ("CREATE TABLE u (a INT, b DOUBLE)",
                "INSERT INTO u VALUES (1, 2.5), (2, 3.5), (3, 4.5)",
                "UPDATE u SET b = 1.0 WHERE a < 3",
                "DELETE FROM u WHERE a = 3",
                "SELECT * FROM u",
                "DROP TABLE u"):
        msgs = c.query(sql)
        assert not any(t == b"E" for t, _ in msgs), msgs
        tags += command_tags(msgs)
    assert tags == ["CREATE TABLE", "INSERT 0 3", "UPDATE 2", "DELETE 1", "SELECT 2",
                    "DROP TABLE"]
    # the extended protocol's Execute gives the same tags, and a statement
    # without rows answers Describe(portal) with NoData, no RowDescription
    c.query("CREATE TABLE u (a INT)")
    c.query("INSERT INTO u VALUES (7), (8), (9)")
    c.parse("DELETE FROM u WHERE a > ?", [23])
    c.bind([7])
    c.describe(b"P")
    c.execute()
    msgs = c.sync()
    assert [t for t, _ in msgs] == [b"1", b"2", b"n", b"C", b"Z"]
    assert command_tags(msgs) == ["DELETE 2"]
    assert text_rows(c.query("SELECT a FROM u")) == [("7",)]
    c.close()


def test_simple_query_answers_each_statement_and_the_empty_query(port_server):
    c = connect(port_server)
    msgs = c.query("SELECT a FROM t WHERE a < 3 ORDER BY a; SELECT COUNT(*) FROM t")
    assert [t for t, _ in msgs] == [b"T", b"D", b"D", b"C", b"T", b"D", b"C", b"Z"]
    assert command_tags(msgs) == ["SELECT 2", "SELECT 1"]
    assert [t for t, _ in c.query("")] == [b"I", b"Z"]  # EmptyQueryResponse
    c.close()


def test_writes_are_read_back_through_mvcc(port_server):
    """Reads see committed rows only: a DELETE through the server hides its
    rows from the next SELECT of any session."""
    cat = port_server.catalog
    t = cat.get_table("t")
    t.mvcc = MvccData.for_new_table(t.num_rows, t.capacity, device="cpu")
    writer, reader = connect(port_server), connect(port_server)
    assert command_tags(writer.query("DELETE FROM t WHERE a > 4")) == ["DELETE 2"]
    assert text_rows(reader.query("SELECT a FROM t ORDER BY a")) == \
        [("1",), ("2",), ("3",), ("4",)]
    assert command_tags(writer.query("INSERT INTO t SELECT a + 10, b, f, d, s FROM t")) == \
        ["INSERT 0 4"]
    assert text_rows(reader.query("SELECT COUNT(*) FROM t")) == [("8",)]
    writer.close()
    reader.close()


def test_bin_client_works_against_the_port(port_server):
    """bin/client.py speaks the raw protocol and imports neither package."""
    sys.path.insert(0, os.path.join(REPO, "bin"))
    try:
        from client import PgWireClient
    finally:
        sys.path.pop(0)
    c = PgWireClient(port=port_server.server_address[1], host="127.0.0.1")
    cols, rows, notes = c.query("SELECT a, s FROM t WHERE a < 3 ORDER BY a")
    assert cols == ["a", "s"]
    assert rows == [("1", "x"), ("2", "it's")]
    assert notes == ["SELECT 2"]
    with pytest.raises(RuntimeError, match="server error"):
        c.query("SELECT nope FROM t")
    c.close()


# -- ROADMAP C19: concurrent sessions ------------------------------------------


def run_stream(port, texts, out, errors):
    try:
        c = PgClient(port)
        c.startup()
        for sql in texts:
            out.append(c.query(sql))
        c.close()
    except Exception as e:  # reported by the test below
        errors.append(e)


@pytest.mark.parametrize("qids", [(1, 3, 6, 10, 13), (18, 9, 5, 14, 21)],
                         ids=lambda q: "Q" + "-".join(map(str, q)))
def test_two_sessions_at_once_get_the_single_session_answer(qids):
    """Two sessions send the same texts at the same moment; each answer
    equals the one a session alone gets. The server's plan cache is on, so
    both sessions' statements after the first come from it (ROADMAP C19)."""
    _, srv = tpch_servers(TPCH_SF)
    port = srv.server_address[1]
    texts = [TPCH_SQL[q] for q in qids] * 2
    alone, errors = [], []
    run_stream(port, texts, alone, errors)
    outs = [[], []]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run_stream, args=(port, texts, o, errors))
                   for o in outs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    for out in outs:
        assert len(out) == len(texts)
        for got, want in zip(out, alone):
            assert not any(t == b"E" for t, _ in got), got
            assert [t for t, _ in got] == [t for t, _ in want]
            assert text_rows(got) == text_rows(want)


def test_prepared_statements_belong_to_their_session(port_server):
    """ROADMAP C21: SQL PREPARE names are one session's. Two sessions prepare
    the same name with different texts and each EXECUTE runs its own
    session's; a session that prepared nothing gets the server's error for
    an unknown statement; a second PREPARE in one session replaces its
    statement there only."""
    a, b, c = connect(port_server), connect(port_server), connect(port_server)
    try:
        assert command_tags(a.query("PREPARE p FROM 'SELECT a FROM t WHERE a = 1'")) == [
            "PREPARE"]
        assert command_tags(b.query("PREPARE p FROM 'SELECT a FROM t WHERE a > 1'")) == [
            "PREPARE"]
        assert text_rows(a.query("EXECUTE p")) == [("1",)]
        assert sorted(text_rows(b.query("EXECUTE p"))) == [(str(v),) for v in range(2, 7)]
        unknown = c.query("EXECUTE p")
        assert tags(unknown) == [b"E", b"Z"] and error_code(unknown) == "26000"
        a.query("PREPARE p FROM 'SELECT a FROM t WHERE a = 3'")
        assert text_rows(a.query("EXECUTE p")) == [("3",)]
        assert sorted(text_rows(b.query("EXECUTE p"))) == [(str(v),) for v in range(2, 7)]
    finally:
        for client in (a, b, c):
            client.close()


def test_plan_cache_serves_two_sessions_at_once():
    """ROADMAP C19: with the server's plan cache on, two sessions that send
    the same text at once both hit it and each gets the answer a session
    alone gets."""
    from hyrise_tpu_torch.sql import pipeline
    _, srv = tpch_servers(TPCH_SF)
    port = srv.server_address[1]
    texts = [TPCH_SQL[q] for q in (3, 10, 18)] * 3
    alone, errors = [], []
    run_stream(port, texts, alone, errors)
    hits = []
    statement_execute = pipeline.SQLPipelineStatement.execute

    def counted(self):
        out = statement_execute(self)
        hits.append(self.metrics.cache_hit)
        return out

    outs = [[], []]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pipeline.SQLPipelineStatement.execute = counted
    try:
        threads = [threading.Thread(target=run_stream, args=(port, texts, o, errors))
                   for o in outs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        pipeline.SQLPipelineStatement.execute = statement_execute
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert len(hits) == 2 * len(texts) and all(hits), hits
    for out in outs:
        for got, want in zip(out, alone):
            assert text_rows(got) == text_rows(want)


def test_concurrent_inserts_all_land(port_server):
    """Two sessions append to one MVCC table at once: every row is there
    once (the append holds the table's write lock)."""
    c = connect(port_server)
    c.query("CREATE TABLE ins (a INT)")
    c.close()
    errors, outs = [], [[], []]
    texts = [[f"INSERT INTO ins VALUES ({1000 * s + i})" for i in range(40)] for s in (1, 2)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run_stream,
                                    args=(port_server.server_address[1], tx, o, errors))
                   for tx, o in zip(texts, outs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    c = connect(port_server)
    got = sorted(int(r[0]) for r in text_rows(c.query("SELECT a FROM ins")))
    assert got == sorted(1000 * s + i for s in (1, 2) for i in range(40))
    c.close()


def test_entry_point_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        server_main(["--port", "0"])

