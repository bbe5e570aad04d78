"""Column encodings: hyrise_tpu_torch.storage.encoding against
hyrise_tpu.storage.encoding on the same exported tables, on CPU tensors.

For every EncodingType and every column type, with NULLs, NaN, -0.0 and
+-inf among the floats, on an empty table, one row, and lengths that are
not a multiple of FOR_BLOCK (2,048): the port's payloads equal the JAX
package's (dtypes and values) and so do the decodes. A table carried across
as the JAX encoder's payloads (storage/interop.table_from_numpy) decodes to
the same values. Then the operators over encoded tables, as in
tests/test_encoding_sweep.py and the encoding tests of
tests/test_storage_extras.py: a scan, a join, an aggregate and a SQL
statement give the rows of the unencoded table; the at-rest bytes shrink;
an encoded column with int32 codes is not written into by an INSERT."""

import numpy as np
import pytest
import torch

from hyrise_tpu.storage.encoding import ChunkEncoder as JaxChunkEncoder
from hyrise_tpu.storage.encoding import EncodingType as JaxEncodingType
from hyrise_tpu.storage.encoding import FrameOfReferenceColumn as JaxFoR
from hyrise_tpu.storage.encoding import RunLengthColumn as JaxRLE
from hyrise_tpu.storage.encoding import encoded_memory_bytes as jax_memory_bytes
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu_torch.concurrency.transaction import MvccData
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops import TableWrapper, execute_plan
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder, run_sql
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.encoding import (FOR_BLOCK, ChunkEncoder, EncodingType,
                                               FrameOfReferenceColumn, NarrowCodes,
                                               RunLengthColumn, compress_attribute_vector,
                                               encoded_memory_bytes)
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import JoinMode
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

TYPES = ["int32", "int64", "float32", "float64", "string"]
ENCODINGS = [EncodingType.DICTIONARY, EncodingType.FIXED_STRING_DICTIONARY,
             EncodingType.RUN_LENGTH, EncodingType.FRAME_OF_REFERENCE]
SIZES = [0, 1, FOR_BLOCK - 1, FOR_BLOCK + 1, 5000]


def _values(dtype: str, n: int, seed: int):
    """n values in runs of 1 to 40 equal values, and a validity mask with a
    NULL in about every tenth row (None for n < 2)."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 41, max(n, 1))
    base = rng.integers(0, 60, len(runs))
    keys = np.repeat(base, runs)[:n]
    if dtype == "string":
        values = np.array([f"v{k:03d}" for k in keys], dtype=object)
    elif dtype.startswith("int"):
        # spread over more than int16, and one value near the type's top
        values = (keys * 1237 - 20000).astype(dtype)
        if n > 3:
            values[n // 2] = np.iinfo(dtype).max - 5
    else:
        values = (keys / 8 - 3).astype(dtype)
        special = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan]
        if n >= len(special) * 2:
            pos = rng.choice(n, len(special), replace=False)
            values[pos] = special
    validity = None if n < 2 else rng.random(n) >= 0.1
    return values, validity


def _jax_table(dtype: str, n: int, seed: int = 0) -> JaxTable:
    values, validity = _values(dtype, n, seed)
    return JaxTable.from_arrays("t", [JaxDef("c", JaxDataType(dtype), validity is not None)],
                                [values], [validity])


def _export(jt: JaxTable):
    return [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]


def _port_table(jt: JaxTable):
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy(jt.name, _export(jt), jt.num_rows, live, device="cpu")


def _jax_payload(e):
    """The JAX payload as (kind, first array, second array or None, rows)."""
    if isinstance(e, JaxRLE):
        return ("run_length", np.asarray(e.values), np.asarray(e.end_positions), e.num_rows)
    if isinstance(e, JaxFoR):
        return ("frame_of_reference", np.asarray(e.frames), np.asarray(e.offsets), e.num_rows)
    return ("dictionary", np.asarray(e.codes),
            None if e.dictionary is None else np.asarray(e.dictionary), e.codes.shape[0])


def _port_payload(e):
    if isinstance(e, RunLengthColumn):
        return ("run_length", e.values.numpy(), e.end_positions.numpy(), e.num_rows)
    if isinstance(e, FrameOfReferenceColumn):
        return ("frame_of_reference", e.frames.numpy(), e.offsets.numpy(), e.num_rows)
    assert isinstance(e, NarrowCodes)
    return ("dictionary", e.codes.numpy(),
            None if e.dictionary is None else e.dictionary.numpy(), e.codes.shape[0])


def _same_array(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.dtype == want.dtype
    # NaN equals NaN, and -0.0 equals 0.0 (np.unique keeps either zero)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("enc", ENCODINGS, ids=lambda e: e.value)
@pytest.mark.parametrize("dtype", TYPES)
def test_payload_and_decode_equal_jax(dtype, enc, n):
    jt = _jax_table(dtype, n, seed=n)
    jenc = JaxChunkEncoder.encode_table(jt, JaxEncodingType(enc.value))
    t = ChunkEncoder.encode_table(_port_table(jt), enc)
    jc, c = jenc.column("c"), t.column("c")
    assert t.encoding_spec is enc
    if jc.encoded is None:  # FRAME_OF_REFERENCE leaves floats as they are
        assert enc is EncodingType.FRAME_OF_REFERENCE and dtype.startswith("float")
        assert c.encoded is None
    else:
        want, got = _jax_payload(jc.encoded), _port_payload(c.encoded)
        assert got[0] == want[0] and got[3] == want[3]
        _same_array(got[1], want[1])
        _same_array(got[2], want[2])
        assert encoded_memory_bytes(c) == jax_memory_bytes(jc)
    _same_array(c.data.numpy(), np.asarray(jc.data))
    assert (c.validity is None) == (jc.validity is None)
    if c.validity is not None:
        np.testing.assert_array_equal(c.validity.numpy(), np.asarray(jc.validity))


@pytest.mark.parametrize("dtype,enc", [
    (d, e) for d in TYPES for e in ENCODINGS
    if not (d.startswith("float") and e is EncodingType.FRAME_OF_REFERENCE)],
    ids=lambda p: getattr(p, "value", p))
def test_table_from_jax_payloads_decodes_as_jax(dtype, enc):
    """The port's table starts from the JAX encoder's bytes."""
    jt = JaxChunkEncoder.encode_table(_jax_table(dtype, 5000, seed=3),
                                      JaxEncodingType(enc.value))
    jc = jt.column("c")
    cols = [(c.name, c.dtype.value, None,
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    t = table_from_numpy("t", cols, jt.num_rows, device="cpu",
                         encoded={"c": _jax_payload(jc.encoded)})
    c = t.column("c")
    assert c.encoded is not None and c.capacity == jc.capacity
    _same_array(c.data.numpy(), np.asarray(jc.data))
    _same_array(_port_payload(c.encoded)[1], _jax_payload(jc.encoded)[1])
    if dtype.startswith("int"):
        assert c.val_range == (int(np.asarray(jc.data).min()), int(np.asarray(jc.data).max()))


def test_compress_attribute_vector_narrows_as_jax():
    for hi, dt in ((100, torch.int8), (1000, torch.int16), (10**6, torch.int32),
                   (2**40, torch.int64)):
        assert compress_attribute_vector(torch.tensor([0, hi])).dtype == dt
    assert compress_attribute_vector(torch.tensor([-129, 0])).dtype == torch.int16
    assert compress_attribute_vector(torch.zeros(0, dtype=torch.int64)).dtype == torch.int64


def test_frame_of_reference_of_a_column_spanning_the_int32_range():
    """A block that spans more than int32 wraps in the difference, as numpy
    does, and decodes back."""
    values = np.array([np.iinfo(np.int32).min, 0, np.iinfo(np.int32).max] * 700,
                      dtype=np.int32)
    jt = JaxTable.from_arrays("t", [JaxDef("c", JaxDataType.INT32)], [values])
    jenc = JaxChunkEncoder.encode_table(jt, JaxEncodingType.FRAME_OF_REFERENCE)
    t = ChunkEncoder.encode_table(_port_table(jt), EncodingType.FRAME_OF_REFERENCE)
    want, got = _jax_payload(jenc.column("c").encoded), _port_payload(t.column("c").encoded)
    _same_array(got[2], want[2])
    np.testing.assert_array_equal(t.column("c").data.numpy()[:len(values)], values)


def test_encode_table_spec_merges_and_keeps_the_table():
    jt = JaxTable.from_arrays("t", [JaxDef("a", JaxDataType.INT64),
                                    JaxDef("s", JaxDataType.STRING)],
                              [np.arange(10, dtype=np.int64),
                               np.array(list("abcabcabca"), dtype=object)])
    t = _port_table(jt)
    t.mvcc = MvccData.for_new_table(t.num_rows, t.capacity, device="cpu")
    once = ChunkEncoder.encode_table(t, {"a": EncodingType.RUN_LENGTH})
    twice = ChunkEncoder.encode_table(once, {"s": EncodingType.DICTIONARY})
    assert twice.encoding_spec == {"a": EncodingType.RUN_LENGTH,
                                   "s": EncodingType.DICTIONARY}
    assert twice.mvcc is t.mvcc and twice.num_rows == t.num_rows
    assert isinstance(twice.column("a").encoded, RunLengthColumn)
    assert isinstance(twice.column("s").encoded, NarrowCodes)
    assert twice.rows() == t.rows()
    # a masked table keeps its mask
    rows = torch.arange(t.capacity)
    live = (rows % 3 == 0) & (rows < t.num_rows)
    masked = ChunkEncoder.encode_table(Table(t.columns, int(live.sum()), name="t", live=live),
                                       EncodingType.DICTIONARY)
    assert masked.rows() == [r for i, r in enumerate(t.rows()) if i % 3 == 0]


# -- operators over encoded tables (tests/test_encoding_sweep.py) ---------------


SWEEP = [EncodingType.UNENCODED] + ENCODINGS


def _sweep_table(n: int = 800, seed: int = 7):
    rng = np.random.default_rng(seed)
    jt = JaxTable.from_arrays(
        "t", [JaxDef("k", JaxDataType.INT64), JaxDef("v", JaxDataType.INT32),
              JaxDef("s", JaxDataType.STRING), JaxDef("f", JaxDataType.FLOAT64)],
        [np.sort(rng.integers(1000, 1040, size=n)).astype(np.int64),
         rng.integers(0, 50, size=n).astype(np.int32),
         np.array([f"g{x:02d}" for x in rng.integers(0, 9, size=n)], dtype=object),
         rng.normal(size=n)])
    return _port_table(jt)


@pytest.fixture(scope="module")
def plain():
    return _sweep_table()


@pytest.mark.parametrize("enc", SWEEP, ids=lambda e: e.value)
def test_scan_over_encoding(plain, enc):
    t = ChunkEncoder.encode_table(plain, enc)
    pred = (ast.col("k") > ast.lit(1010)) & (ast.col("s") != ast.lit("g03"))
    ref = execute_plan(TableScan(TableWrapper(plain), pred))
    got = execute_plan(TableScan(TableWrapper(t), pred))
    assert_tables_equal(got.rows(), ref.rows(), ordered=True, rel_tol=0, abs_tol=0)


@pytest.mark.parametrize("enc", SWEEP, ids=lambda e: e.value)
def test_join_over_encoding(plain, enc):
    t = ChunkEncoder.encode_table(plain, enc)
    dim = table_from_numpy("d", [("k", "int64", np.arange(1000, 1040, dtype=np.int64), None,
                                  None),
                                 ("label", "string", np.arange(40, dtype=np.int32), None,
                                  np.array([f"L{i:02d}" for i in range(40)]))],
                           40, device="cpu", unique=["k"])
    ref = execute_plan(Sort(Join(TableWrapper(plain), TableWrapper(dim), JoinMode.INNER,
                                 ("k", "k")), ["k", "f"]))
    got = execute_plan(Sort(Join(TableWrapper(t), TableWrapper(dim), JoinMode.INNER,
                                 ("k", "k")), ["k", "f"]))
    assert_tables_equal(got.rows(), ref.rows(), ordered=True, rel_tol=0, abs_tol=0)


@pytest.mark.parametrize("enc", SWEEP, ids=lambda e: e.value)
def test_aggregate_over_encoding(plain, enc):
    t = ChunkEncoder.encode_table(plain, enc)
    aggs = [("s_v", ast.sum_(ast.col("v"))), ("n", ast.count_()),
            ("mx", ast.max_(ast.col("k")))]
    ref = execute_plan(Sort(Aggregate(TableWrapper(plain), ["s"], aggs), ["s"]))
    got = execute_plan(Sort(Aggregate(TableWrapper(t), ["s"], aggs), ["s"]))
    assert_tables_equal(got.rows(), ref.rows(), ordered=True, rel_tol=0, abs_tol=0)


def test_encodings_compress_at_rest(plain):
    base = sum(encoded_memory_bytes(c) for c in plain.columns)
    for enc in (EncodingType.RUN_LENGTH, EncodingType.FRAME_OF_REFERENCE):
        t = ChunkEncoder.encode_table(plain, enc)
        assert encoded_memory_bytes(t.column("k")) < encoded_memory_bytes(plain.column("k"))
    t = ChunkEncoder.encode_table(plain, EncodingType.DICTIONARY)
    assert sum(encoded_memory_bytes(c) for c in t.columns) < base
    assert t.column("s").encoded.codes.dtype == torch.int8


def test_encoded_table_through_sql(plain):
    sql = ("SELECT s, SUM(v) AS sv FROM t WHERE k BETWEEN 1005 AND 1035 "
           "GROUP BY s ORDER BY s")
    rows = []
    for t in (plain, ChunkEncoder.encode_table(plain, EncodingType.RUN_LENGTH)):
        cat = Catalog(device="cpu")
        cat.add_table("t", t)
        rows.append(SQLPipelineBuilder(sql).with_catalog(cat).create_pipeline()
                    .get_result_table().rows())
    assert_tables_equal(rows[1], rows[0], ordered=True, rel_tol=0, abs_tol=0)


def test_insert_never_writes_into_an_encoded_payload():
    """Over 32,767 distinct strings keep int32 codes, whose decode is the
    payload itself; an INSERT into the table's headroom must write into a
    copy, and the older table must read what it read before."""
    n = 40_000
    words = np.array([f"w{i:05d}" for i in range(n)])
    t = table_from_numpy("t", [("s", "string", np.arange(n, dtype=np.int32), None, words)],
                         n - 10, device="cpu")  # 10 rows of headroom
    t.mvcc = MvccData.for_new_table(t.num_rows, t.capacity, device="cpu")
    enc = ChunkEncoder.encode_table(t, EncodingType.DICTIONARY)
    payload = enc.column("s").encoded.codes
    assert payload.dtype == torch.int32
    before = payload.clone()
    old_rows = enc.rows()
    cat = Catalog(device="cpu")
    cat.add_table("t", enc)
    run_sql("INSERT INTO t VALUES ('w00001')", cat, use_mvcc=True)
    assert torch.equal(payload, before)
    assert enc.rows() == old_rows
    grown = cat.get_table("t")
    assert grown.column("s").encoded is None and grown.encoding_spec is EncodingType.DICTIONARY
    assert grown.rows()[-1] == ("w00001",)
