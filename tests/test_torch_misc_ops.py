"""Limit, Alias and UnionAll of the port (hyrise_tpu_torch.ops.misc) against
the same JAX operators on the same exported tables: rows equal as ordered
lists, NULLs in the same cells, column names and types equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyrise_tpu.ops as jax_ops
import hyrise_tpu_torch.ops as torch_ops
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.types import DataType as T
from hyrise_tpu_torch.storage.interop import table_from_numpy

torch.set_num_threads(1)


def _port_table(jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy(jt.name, cols, jt.num_rows, live, device="cpu")


def _table(seed: int, n: int, words, int_type=T.INT32, masked=False) -> JaxTable:
    rng = np.random.default_rng(seed)
    ints = rng.integers(-9, 9, n)
    t = JaxTable.from_arrays(
        "t", [JaxDef("a", int_type, True), JaxDef("s", T.STRING), JaxDef("f", T.FLOAT64)],
        [ints.astype(int_type.numpy_dtype), np.array(rng.choice(words, n), dtype=object),
         rng.random(n)], [rng.random(n) > 0.3, None, None])
    if masked:
        live = np.zeros(t.capacity, dtype=bool)
        live[:n] = rng.random(n) < 0.5
        t = JaxTable(t.columns, int(live.sum()), name="t", live=jnp.asarray(live))
    return t


def _both(build, *tables):
    jout = jax_ops.execute_plan(build(jax_ops, *[jax_ops.TableWrapper(t) for t in tables]))
    pout = torch_ops.execute_plan(
        build(torch_ops, *[torch_ops.TableWrapper(_port_table(t)) for t in tables]))
    assert pout.column_names == jout.column_names
    assert [c.dtype.value for c in pout.columns] == [c.dtype.value for c in jout.columns]
    assert pout.num_rows == jout.num_rows == len(pout.rows())
    assert pout.rows() == jout.rows()
    return pout


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("n", [0, 3, 7, 99])
def test_limit_matches_jax(n, masked):
    t = _table(1, 12, ["x", "y", "z"], masked=masked)
    out = _both(lambda ops, src: ops.Limit(src, n), t)
    assert out.num_rows == min(n, t.num_rows)
    assert (out.live is not None) == masked  # a mask stays a mask: nothing moves


def test_alias_matches_jax():
    t = _table(2, 9, ["x", "y"])
    out = _both(lambda ops, src: ops.Alias(src, ["p", "q", "r"]), t)
    assert out.column_names == ["p", "q", "r"]
    out = _both(lambda ops, src: ops.Alias(src, ["y", "k"], ["f", "a"]), t)
    assert out.column_names == ["y", "k"]
    masked = _table(2, 9, ["x", "y"], masked=True)
    _both(lambda ops, src: ops.Alias(src, ["y"], ["s"]), masked)
    with pytest.raises(ValueError):
        torch_ops.execute_plan(torch_ops.Alias(
            torch_ops.TableWrapper(_port_table(t)), ["only_one"]))


UNIONS = {
    "same_dictionary": (["x", "y", "z"], ["x", "y", "z"], T.INT32, False),
    "merged_dictionary": (["x", "y", "zz"], ["a", "y", "zebra"], T.INT32, False),
    "promoted_int": (["x", "y"], ["x", "y"], T.INT64, False),
    "masked_inputs": (["x", "y"], ["w", "x"], T.INT32, True),
}


@pytest.mark.parametrize("name", sorted(UNIONS))
def test_union_all_matches_jax(name):
    lwords, rwords, rtype, masked = UNIONS[name]
    lt = _table(3, 11, lwords, masked=masked)
    rt = _table(4, 6, rwords, int_type=rtype, masked=masked)
    out = _both(lambda ops, a, b: ops.UnionAll(a, b), lt, rt)
    assert out.num_rows == lt.num_rows + rt.num_rows and out.is_prefix
    assert out.column("a").dtype.value == rtype.value


def test_union_all_of_empty_and_mismatched_inputs():
    lt, rt = _table(5, 4, ["x"]), _table(6, 3, ["x"])
    rt = JaxTable(rt.columns, 0, name="t", live=jnp.zeros(rt.capacity, dtype=bool))
    out = _both(lambda ops, a, b: ops.UnionAll(a, b), lt, rt)
    assert out.num_rows == 4
    narrow = torch_ops.Alias(torch_ops.TableWrapper(_port_table(lt)), ["a"], ["a"])
    with pytest.raises(ValueError):
        torch_ops.execute_plan(torch_ops.UnionAll(
            torch_ops.TableWrapper(_port_table(lt)), narrow))
    with pytest.raises(TypeError):  # string column against a numeric one
        torch_ops.execute_plan(torch_ops.UnionAll(
            torch_ops.Alias(torch_ops.TableWrapper(_port_table(lt)), ["c"], ["s"]),
            torch_ops.Alias(torch_ops.TableWrapper(_port_table(lt)), ["c"], ["f"])))
