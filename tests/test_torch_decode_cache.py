"""Table.to_pandas's string columns taken from each dictionary's kept
pandas array (hyrise_tpu_torch/storage/column.py, _frame_strings) on the
CPU: frames identical to the construction the port used before, under
pandas' string inference on and off, NULLs included; the rule that builds
an entry (at once when a decode reads at least the dictionary's length, else
on the second decode of the same object); entries freed with their
dictionaries; threads at once; the counts and the span's `cache` word;
Column.decode and Table.rows unchanged."""

import gc
import sys
import threading
import types

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu_torch.plan import compiler
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage import column as column_mod
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column, frame_decode_counts
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils import spans

INFER = [True, False]


@pytest.fixture(params=INFER, ids=["infer_string", "object_strings"])
def infer(request):
    with pd.option_context("future.infer_string", request.param):
        yield request.param


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.enable(False)
    spans.drain()
    yield
    spans.enable(False)
    spans.drain()


# -- the construction before kept arrays, as the reference ---------------------


def _reference_values(c: Column, n: int, mask) -> np.ndarray:
    data = c.data[:n].numpy()
    valid = np.ones(n, dtype=bool) if c.validity is None else c.validity[:n].numpy()
    if c.dtype is DataType.STRING:
        out = np.empty(n, dtype=object)
        d = c.dictionary
        out[:] = d[np.clip(data, 0, len(d) - 1)] if len(d) \
            else np.array([""] * n, dtype=object)
        out[~valid] = None
    elif not valid.all():
        out = np.empty(n, dtype=object)
        out[:] = data
        out[~valid] = None
    else:
        out = data
    return out if mask is None else out[mask]


def reference_frame(t: Table) -> pd.DataFrame:
    if t.live is None:
        n, mask = int(t.num_rows), None
    else:
        n, mask = t.capacity, t.live.numpy()
    data = {}
    for c in t.columns:
        k, suffix = c.name, 1
        while k in data:
            k = f"{c.name}.{suffix}"
            suffix += 1
        data[k] = _reference_values(c, n, mask)
    return pd.DataFrame(data)


def assert_same(frame: pd.DataFrame, ref: pd.DataFrame) -> None:
    pd.testing.assert_frame_equal(frame, ref, check_dtype=True)
    assert [str(t) for t in frame.dtypes] == [str(t) for t in ref.dtypes]
    for i in range(ref.shape[1]):
        a, b = frame.iloc[:, i], ref.iloc[:, i]
        if b.dtype == object:  # None stays None, not NaN
            assert [v is None for v in a] == [v is None for v in b]
            assert [type(v) for v in a] == [type(v) for v in b]


# -- cases ----------------------------------------------------------------------


def _words(n: int, tag: str = "w") -> np.ndarray:
    return np.array(sorted(f"{tag}{i:05d}" for i in range(n)))


def _string(name, codes, dictionary, valid=None) -> Column:
    return Column(name, DataType.STRING, torch.tensor(np.asarray(codes, dtype=np.int32)),
                  None if valid is None else torch.tensor(np.asarray(valid, dtype=bool)),
                  dictionary)


def _ints(name, values, valid=None) -> Column:
    return Column(name, DataType.INT32, torch.tensor(np.asarray(values, dtype=np.int32)),
                  None if valid is None else torch.tensor(np.asarray(valid, dtype=bool)))


def case_nulls():
    d = _words(40)
    rng = np.random.default_rng(1)
    return Table([_string("s", rng.integers(0, 40, 100), d, rng.random(100) > 0.3),
                  _ints("i", np.arange(100))], 100)


def case_all_null():
    d = _words(40)
    return Table([_string("s", np.arange(50) % 40, d, np.zeros(50, dtype=bool))], 50)


def case_empty_dictionary():
    return Table([_string("s", np.zeros(6), np.array([], dtype=str), [1, 0, 1, 1, 0, 1])], 6)


def case_zero_rows():
    return Table([_string("s", np.zeros(8), _words(5)), _ints("i", np.arange(8))], 0)


def case_masked():
    d = _words(30)
    rng = np.random.default_rng(2)
    live = torch.tensor(rng.random(64) > 0.4)
    cols = [_string("s", rng.integers(0, 30, 64), d, rng.random(64) > 0.2),
            _ints("i", np.arange(64), rng.random(64) > 0.5)]
    return Table(cols, int(live.sum()), live=live)


def case_masked_dead_codes():
    d = _words(10)
    codes = np.arange(20) % 10
    codes[::3] = 10_000  # dead rows of a capacity buffer hold anything
    live = torch.tensor(codes < 10)
    return Table([_string("s", codes, d)], int(live.sum()), live=live)


def case_duplicate_names():
    d = _words(12)
    return Table([_string("s", np.arange(12), d), _string("s", np.arange(12)[::-1], d),
                  _ints("s", np.arange(12))], 12)


def case_shared_dictionary():
    d = _words(25)
    rng = np.random.default_rng(3)
    return Table([_string("a", rng.integers(0, 25, 30), d),
                  _string("b", rng.integers(0, 25, 30), d, rng.random(30) > 0.5)], 30)


def case_both_ends():
    d = _words(7)
    codes = [0, 6, 0, 6, -3, 99, 3]  # the ends, and past them (clipped)
    return Table([_string("s", codes, d, [1, 1, 0, 1, 1, 1, 1])], 7)


def case_no_string_column():
    return Table([_ints("i", np.arange(9), np.arange(9) % 2 == 0),
                  Column("f", DataType.FLOAT64, torch.linspace(0, 1, 9, dtype=torch.float64))], 9)


def case_device_count():
    d = _words(16)
    return Table([_string("s", np.arange(16) % 16, d)], torch.tensor(11))


def case_one_entry():
    return Table([_string("s", np.zeros(5), np.array(["only"]))], 5)


CASES = [case_nulls, case_all_null, case_empty_dictionary, case_zero_rows, case_masked,
         case_masked_dead_codes, case_duplicate_names, case_shared_dictionary, case_both_ends,
         case_no_string_column, case_device_count, case_one_entry]


@pytest.mark.parametrize("make", CASES, ids=[c.__name__[5:] for c in CASES])
def test_frames_equal_the_object_construction(make, infer):
    t = make()
    ref = reference_frame(t)
    for _ in range(3):  # direct or built first, then from the kept arrays
        assert_same(t.to_pandas(), ref)


@pytest.mark.parametrize("make", CASES, ids=[c.__name__[5:] for c in CASES])
def test_decode_and_rows_are_unchanged(make):
    t = make()
    n = int(t.num_rows) if t.live is None else t.capacity
    mask = None if t.live is None else t.live.numpy()
    ref = [_reference_values(c, n, None) for c in t.columns]
    for c, r in zip(t.columns, ref):
        got = c.decode(n)
        assert got.dtype == r.dtype and len(got) == len(r)
        assert all(a is b or a == b for a, b in zip(got, r))
    picked = [r if mask is None else r[mask] for r in ref]
    rows = list(zip(*picked)) if picked and len(picked[0]) else []
    for _ in range(2):
        assert t.rows() == rows


def test_a_setting_changed_later_gets_its_own_array():
    d = _words(20)
    t = Table([_string("s", np.arange(20), d, np.arange(20) % 3 > 0)], 20)
    for on in (True, False, True, False):
        with pd.option_context("future.infer_string", on):
            assert_same(t.to_pandas(), reference_frame(t))


# -- the rule ---------------------------------------------------------------------


def _delta(before):
    now = frame_decode_counts()
    return {k: now[k] - before[k] for k in ("hit", "build", "direct")}


def test_a_long_decode_builds_at_once():
    t = Table([_string("s", np.arange(30) % 20, _words(20))], 30)
    before = frame_decode_counts()
    t.to_pandas()
    assert _delta(before) == {"hit": 0, "build": 1, "direct": 0}
    t.to_pandas()
    assert _delta(before) == {"hit": 1, "build": 1, "direct": 0}


def test_a_short_decode_builds_on_the_second():
    d = _words(100)
    t = Table([_string("s", [5, 7, 99], d)], 3)
    before = frame_decode_counts()
    words = []
    with spans.recording():
        for _ in range(4):
            t.to_pandas()
            (s,) = [s for s in spans.drain() if s.name == "decode.strings"]
            assert s.attrs["rows"] == 3
            words.append(s.attrs["cache"])
    assert words == ["direct", "build", "hit", "hit"]
    assert _delta(before) == {"hit": 2, "build": 1, "direct": 1}


def test_no_string_column_counts_nothing():
    before = frame_decode_counts()
    case_no_string_column().to_pandas()
    assert _delta(before) == {"hit": 0, "build": 0, "direct": 0}


def test_fresh_dictionaries_leave_no_entry():
    gc.collect()
    before = frame_decode_counts()
    for i in range(1000):
        size = 50 if i % 2 else 3  # longer than the decode, then shorter
        t = Table([_string("s", np.arange(10) % size, _words(size, f"x{i}_"))], 10)
        t.to_pandas()
        del t
    gc.collect()
    after = frame_decode_counts()
    assert after["entries"] <= before["entries"]
    d = _delta(before)
    assert d["build"] == 500 and d["direct"] == 500 and d["hit"] == 0


def test_an_entry_dies_with_its_dictionary():
    d = _words(10)
    t = Table([_string("s", np.arange(10), d)], 10)
    t.to_pandas()
    key = id(d)
    assert column_mod._frame_entries[key].ref() is d
    del t, d
    gc.collect()
    assert key not in column_mod._frame_entries


@pytest.mark.parametrize("workers", [2, 8])
def test_threads_decode_at_once(infer, workers):
    """Threads decode tables over shared dictionaries at once, with the
    interpreter switching threads often: every frame right, and every
    string decode counted once."""
    rng = np.random.default_rng(4)
    d1, d2 = _words(3000, "a"), _words(500, "b")
    tables = []
    for i in range(6):
        n = 400 + 100 * i
        tables.append(Table([_string("a", rng.integers(0, 3000, n), d1, rng.random(n) > 0.1),
                             _string("b", rng.integers(0, 500, n), d2),
                             _ints("i", np.arange(n))], n))
    refs = [reference_frame(t) for t in tables]
    barrier = threading.Barrier(workers, timeout=60)
    errors = []
    rounds = 4

    def client(w):
        try:
            barrier.wait()
            order = list(range(6)) if w % 2 else list(range(5, -1, -1))
            for _ in range(rounds):
                for j in order:
                    assert_same(tables[j].to_pandas(), refs[j])
        except Exception as e:  # noqa: BLE001 - handed to the main thread
            errors.append(e)

    before = frame_decode_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(w,)) for w in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert sum(_delta(before).values()) == workers * rounds * 6 * 2


# -- one compiled statement -------------------------------------------------------


@pytest.fixture
def graphs(monkeypatch):
    """CompiledQuery's steps on the CPU as on the card: a stand-in graph
    whose capture runs the plan once in capacity mode and whose replay
    hands back those outputs."""
    def capture(self):
        self._graph = types.SimpleNamespace(replay=lambda: None)
        self._graph_outputs = self._execute(learning=False)
        self.captures += 1

    monkeypatch.setattr(compiler.CompiledQuery, "on_cuda", property(lambda self: True))
    monkeypatch.setattr(compiler, "_sync_errors", lambda on: _NoCheck())
    monkeypatch.setattr(compiler.CompiledQuery, "capture", capture)


class _NoCheck:
    def __enter__(self):
        return False

    def __exit__(self, *exc):
        return False


def _catalog() -> Catalog:
    n = 80
    names = np.array([f"name{i:03d}" for i in range(n)], dtype=object)
    names[::7] = None
    t = Table.from_arrays(
        "t", [TableColumnDefinition("a", DataType.INT32),
              TableColumnDefinition("s", DataType.STRING, nullable=True),
              TableColumnDefinition("g", DataType.STRING)],
        [np.arange(n, dtype=np.int32), names,
         np.array(["x", "y", "z", "w"], dtype=object)[np.arange(n) % 4]], device="cpu")
    cat = Catalog()
    cat.add_table("t", t)
    return cat


SQL = "SELECT s, g, a FROM t WHERE a < 30 ORDER BY a"


def test_one_compiled_statement_builds_once_then_hits(graphs, infer):
    cat = _catalog()
    frames, words = [], []
    before = frame_decode_counts()
    with spans.recording():
        for _ in range(4):
            pipeline = SQLPipelineBuilder(SQL).with_catalog(cat).with_compiled_execution() \
                .create_pipeline()
            table = pipeline.get_result_table()
            assert pipeline.pipeline_statements[-1].last_compiled
            frames.append((table.to_pandas(), reference_frame(table)))
            words.append([s.attrs["cache"] for s in spans.drain()
                          if s.name == "decode.strings" and s.attrs and "cache" in s.attrs])
    for frame, ref in frames:
        assert_same(frame, ref)
        assert len(frame) == 30
    # s: 30 rows of 69 names (built on the second decode); g: 30 of 4 (at once)
    assert words == [["direct", "build"], ["build", "hit"], ["hit", "hit"], ["hit", "hit"]]
    assert _delta(before) == {"hit": 5, "build": 2, "direct": 1}
