""".tbl, CSV and binary files between the port and the JAX package, on the
CPU, and the Print operator.

Each test writes its own files into tmp_path from seeded numpy data (ints,
floats, strings, NULLs, an empty table). A file written by either package
loads in the other with the same rows, column names and types; the port's
load_table, load_csv and load_binary put the table on the device they are
given."""

import io

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.ops import import_export as jax_io
from hyrise_tpu.ops import print_op as jax_print
from hyrise_tpu.storage.load_table import load_table as jax_load_table
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu_torch.ops import import_export, print_op
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import TableWrapper
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.storage.load_table import load_table

torch.set_num_threads(1)


def _frame(kind: str) -> pd.DataFrame:
    rng = np.random.default_rng(23)
    n = 0 if kind == "empty" else 37
    words = np.array(["alpha", "beta", "gamma", "delta, with a comma", 'quote "q"', ""],
                     dtype=object)
    s = words[rng.integers(0, len(words), n)]
    df = pd.DataFrame({
        "i": rng.integers(-1000, 1000, n).astype(np.int32),
        "l": rng.integers(-2**40, 2**40, n).astype(np.int64),
        "f": (rng.integers(-4000, 4000, n) / 8).astype(np.float32),
        "d": rng.random(n) * 1e6,
        "s": s,
    })
    if kind == "nulls":
        df["i"] = pd.array(np.where(rng.random(n) < 0.3, None, df["i"]), dtype="Int32")
        df["d"] = pd.array(np.where(rng.random(n) < 0.3, None, df["d"]), dtype="Float64")
        df["s"] = np.where(rng.random(n) < 0.3, None, s).astype(object)
    return df


def _jax_table(kind: str) -> JaxTable:
    return JaxTable.from_pandas("t", _frame(kind))


def _port_table(jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    return table_from_numpy("t", cols, jt.num_rows, device="cpu")


def _plain(v):
    return v.item() if hasattr(v, "item") else v


def _content(t):
    """(names, types, rows) of a table of either package."""
    return ([c.name for c in t.columns], [c.dtype.value for c in t.columns],
            [tuple(_plain(v) for v in r) for r in t.rows()])


KINDS = ["plain", "nulls", "empty"]


def _write_tbl(path, kind: str) -> None:
    """A .tbl file: names, types (`_null` marks a nullable column), rows."""
    df = _frame(kind)
    types = {"i": "int", "l": "long", "f": "float", "d": "double", "s": "string"}
    nullable = kind == "nulls"
    lines = ["|".join(df.columns),
             "|".join(types[c] + ("_null" if nullable and c in "ids" else "")
                      for c in df.columns)]
    for r in df.itertuples(index=False):
        lines.append("|".join("null" if v is None or v is pd.NA else
                              str(v).replace("|", "/") for v in r))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("kind", ["plain", "nulls"])
def test_tbl_loads_like_jax(tmp_path, kind):
    path = tmp_path / f"{kind}.tbl"
    _write_tbl(path, kind)
    got = load_table(str(path), "t", device="cpu")
    want = jax_load_table(str(path), "t")
    assert got.device == torch.device("cpu")
    assert _content(got) == _content(want)


def test_tbl_rejects_an_unknown_type(tmp_path):
    path = tmp_path / "bad.tbl"
    path.write_text("a|b\nint|decimal\n1|2\n")
    with pytest.raises(ValueError, match="decimal"):
        load_table(str(path), device="cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_csv_round_trip_between_the_packages(tmp_path, kind, writer):
    jt = _jax_table(kind)
    path = str(tmp_path / f"{kind}.csv")
    if writer == "port":
        import_export.export_csv(_port_table(jt), path)
    else:
        jax_io.export_csv(jt, path)
    got = import_export.load_csv(path, "t", device="cpu")
    want = jax_io.load_csv(path, "t")
    assert _content(got) == _content(want)
    assert got.device == torch.device("cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binary_round_trip_between_the_packages(tmp_path, kind, writer):
    jt = _jax_table(kind)
    path = str(tmp_path / f"{kind}.bin")
    if writer == "port":
        import_export.export_binary(_port_table(jt), path)
    else:
        jax_io.export_binary(jt, path)
    got = import_export.load_binary(path, "t", device="cpu")
    want = jax_io.load_binary(path, "t")
    assert _content(got) == _content(want) == _content(jt)
    assert got.device == torch.device("cpu")


def test_csv_without_a_meta_file_infers_types_like_jax(tmp_path):
    path = tmp_path / "plain.csv"
    path.write_text("a,b,c\n1,2.5,x\n-3,4,yy\n")
    got = import_export.load_csv(str(path), device="cpu")
    want = jax_io.load_csv(str(path))
    assert _content(got) == _content(want)
    assert [c.dtype.value for c in got.columns] == ["int32", "float32", "string"]


def test_the_operators_write_and_read_through_the_files(tmp_path):
    t = _port_table(_jax_table("nulls"))
    csv_path, bin_path = str(tmp_path / "o.csv"), str(tmp_path / "o.bin")
    execute_plan(import_export.ExportCsv(TableWrapper(t), csv_path))
    execute_plan(import_export.ExportBinary(TableWrapper(t), bin_path))
    for op in (import_export.ImportCsv(csv_path, "o", device="cpu"),
               import_export.ImportBinary(bin_path, "o", device="cpu")):
        assert _content(execute_plan(op)) == _content(t)


def test_export_of_a_masked_table_writes_its_live_rows(tmp_path):
    jt = _jax_table("plain")
    t = _port_table(jt)
    live = torch.zeros(t.capacity, dtype=torch.bool)
    live[:jt.num_rows:2] = True
    masked = type(t)(t.columns, int(live.sum()), name="t", live=live)
    path = str(tmp_path / "m.bin")
    import_export.export_binary(masked, path)
    assert _content(import_export.load_binary(path, device="cpu"))[2] == \
        _content(t)[2][::2]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_rows", [None, 5])
def test_format_table_prints_like_jax(kind, max_rows):
    jt = _jax_table(kind)
    assert print_op.format_table(_port_table(jt), max_rows) == \
        jax_print.format_table(jt, max_rows)


def test_print_operator_writes_to_its_stream():
    t = _port_table(_jax_table("plain"))
    out = io.StringIO()
    result = execute_plan(print_op.Print(TableWrapper(t), out=out, max_rows=3))
    assert result is t
    assert out.getvalue() == print_op.format_table(t, 3) + "\n"
    assert "(37 rows total)" in out.getvalue()
