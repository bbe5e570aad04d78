"""ChunkCompressionTask: hyrise_tpu_torch.tasks against hyrise_tpu.tasks, on
CPU tensors, in the cases of tests/test_compression_task.py (its scheduler
case aside: the port has no JobTask). An INSERT writes a table's encoded
columns out dense; the task encodes exactly those again, to the table's
spec, and query results do not change. Both packages run the same
statements on the same rows and must give the same rows."""

import numpy as np
import pytest
import torch

from hyrise_tpu.concurrency.transaction import MvccData as JaxMvccData
from hyrise_tpu.concurrency.transaction import reset_default_transaction_manager
from hyrise_tpu.sql.pipeline import run_sql as jax_run_sql
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.storage.encoding import ChunkEncoder as JaxChunkEncoder
from hyrise_tpu.storage.encoding import EncodingType as JaxEncodingType
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.tasks import ChunkCompressionTask as JaxChunkCompressionTask
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu_torch.concurrency.transaction import MvccData
from hyrise_tpu_torch.sql.pipeline import run_sql
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.encoding import ChunkEncoder, EncodingType
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.tasks import ChunkCompressionTask

torch.set_num_threads(1)

A = np.array([5, 5, 5, 7, 7, 9, 9, 9], dtype=np.int64)
S = np.array(list("aabbccdd"), dtype=object)
F = np.array([0.5, 0.5, 1.5, 1.5, 2.5, 2.5, 3.5, 3.5])


def _catalogs(spec):
    """(JAX catalog, port catalog), each with t(a, s, f) encoded by `spec`
    (an EncodingType value or {column: value}) and under MVCC."""
    reset_default_transaction_manager()
    jt = JaxTable.from_arrays("t", [JaxDef("a", JaxDataType.INT64),
                                    JaxDef("s", JaxDataType.STRING),
                                    JaxDef("f", JaxDataType.FLOAT64)], [A, S, F])
    cols = [(c.name, c.dtype.value, np.asarray(c.data), None, c.dictionary)
            for c in jt.columns]
    t = table_from_numpy("t", cols, jt.num_rows, device="cpu")
    if isinstance(spec, dict):
        jspec = {k: JaxEncodingType(v) for k, v in spec.items()}
        pspec = {k: EncodingType(v) for k, v in spec.items()}
    else:
        jspec, pspec = JaxEncodingType(spec), EncodingType(spec)
    jt = JaxChunkEncoder.encode_table(jt, jspec)
    jt.mvcc = JaxMvccData.for_new_table(jt.num_rows, jt.capacity)
    t = ChunkEncoder.encode_table(t, pspec)
    t.mvcc = MvccData.for_new_table(t.num_rows, t.capacity, device="cpu")
    jcat, cat = JaxCatalog(), Catalog(device="cpu")
    jcat.add_table("t", jt)
    cat.add_table("t", t)
    return jcat, cat


def _both(sql, jcat, cat):
    got = run_sql(sql, cat, use_mvcc=True)
    want = jax_run_sql(sql, jcat, use_mvcc=True)
    return ([tuple(v.item() if hasattr(v, "item") else v for v in r) for r in got.rows()],
            [tuple(v.item() if hasattr(v, "item") else v for v in r) for r in want.rows()])


def _encoded(table):
    return {c.name: c.encoded is not None for c in table.columns}


def test_compress_appended_restores_encoding():
    jcat, cat = _catalogs("dictionary")
    t0 = cat.get_table("t")
    assert all(c.encoded is not None for c in t0.columns)
    assert t0.encoding_spec is EncodingType.DICTIONARY

    _both("INSERT INTO t VALUES (11, 'zz', 4.5), (5, 'aa', 0.5)", jcat, cat)
    before, jax_before = _both("SELECT a, s, f FROM t ORDER BY a, s", jcat, cat)
    assert before == jax_before
    appended = cat.get_table("t")
    # the append wrote the columns out dense
    assert _encoded(appended) == _encoded(jcat.get_table("t")) == \
        {"a": False, "s": False, "f": False}
    assert appended.encoding_spec is EncodingType.DICTIONARY

    out = ChunkCompressionTask("t", cat).run()
    JaxChunkCompressionTask("t", jcat).run()
    assert _encoded(out) == _encoded(jcat.get_table("t")) == \
        {"a": True, "s": True, "f": True}
    assert cat.get_table("t") is out
    assert out.mvcc is appended.mvcc  # MVCC state carried over
    assert out.encoding_spec is EncodingType.DICTIONARY

    after, jax_after = _both("SELECT a, s, f FROM t ORDER BY a, s", jcat, cat)
    assert after == before == jax_after
    assert (11, "zz", 4.5) in after and (5, "aa", 0.5) in after


def test_compress_appended_noop_without_spec():
    plain = table_from_numpy("p", [("x", "int64", np.arange(4, dtype=np.int64), None, None)],
                             4, device="cpu")
    plain.mvcc = MvccData.for_new_table(plain.num_rows, plain.capacity, device="cpu")
    cat = Catalog(device="cpu")
    cat.add_table("p", plain)
    out = ChunkCompressionTask("p", cat).run()
    assert out is plain  # a table never encoded is left as it is
    assert ChunkCompressionTask("p", cat).run() is plain


def test_compress_without_an_append_is_a_noop():
    _, cat = _catalogs("run_length")
    t = cat.get_table("t")
    assert ChunkCompressionTask("t", cat).run() is t


@pytest.mark.parametrize("spec", [
    "run_length",
    "frame_of_reference",  # f is floating-point: it stays dense
    {"a": "frame_of_reference", "s": "dictionary"},
])
def test_compress_reencodes_exactly_the_dropped_columns(spec):
    jcat, cat = _catalogs(spec)
    want_encoded = _encoded(cat.get_table("t"))
    assert want_encoded == _encoded(jcat.get_table("t"))
    _both("INSERT INTO t VALUES (1, 'q', 9.5)", jcat, cat)
    out = ChunkCompressionTask("t", cat).run()
    JaxChunkCompressionTask("t", jcat).run()
    assert _encoded(out) == want_encoded == _encoded(jcat.get_table("t"))
    got, want = _both("SELECT COUNT(*), SUM(a), MIN(s), MAX(f) FROM t", jcat, cat)
    assert got == want == [(9, 57, "a", 9.5)]
    # the task, run again, finds nothing to do
    assert ChunkCompressionTask("t", cat).run() is out


def test_compress_with_an_explicit_spec():
    jcat, cat = _catalogs({"a": "run_length"})
    _both("INSERT INTO t VALUES (3, 'e', 0.0)", jcat, cat)
    out = ChunkCompressionTask("t", cat, spec={"s": EncodingType.DICTIONARY}).run()
    JaxChunkCompressionTask("t", jcat, spec={"s": JaxEncodingType.DICTIONARY}).run()
    assert _encoded(out) == _encoded(jcat.get_table("t")) == \
        {"a": False, "s": True, "f": False}
    assert out.encoding_spec == {"s": EncodingType.DICTIONARY}
    got, want = _both("SELECT a, s FROM t WHERE s >= 'c' ORDER BY a, s", jcat, cat)
    assert got == want
