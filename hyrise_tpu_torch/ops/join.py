"""Join operators.

Port of hyrise_tpu/ops/join.py. Reference operators covered: JoinHash
(src/lib/operators/join_hash.cpp), JoinSortMerge (join_sort_merge.cpp),
JoinMPSM, JoinNestedLoop (join_nested_loop.cpp), Product (product.cpp)
and JoinIndex (join_index.cpp), whose build side is a table's index.

One engine, two paths:

- lookup: an equi-join in which every probe row has at most one match to
  report (SEMI/ANTI need existence only; INNER/LEFT need a build key column
  flagged `unique`). One probe gives (matched, build row) per probe row: the
  direct-address table of the K4 kernel when the key range is known and
  small enough, else the hash table of the K8 kernel (prims.lookup_last_eq:
  keys of any range, float keys). The
  output is the probe table itself under a live MASK, with the build
  columns gathered lazily beside it, so a chain of joins never moves the
  probe side.
- sorted ranges, for everything else: promote both key columns to one key
  space, sort the build side's valid rows once, and each probe row's
  matches are a contiguous range [lo, hi) of that order, for equality and
  for < <= > >= alike (!= is two ranges). The ranges expand into flat
  (probe row, build row) pairs (the K5 kernel), then come the unmatched
  probe rows (LEFT/OUTER) and the unmatched build rows (OUTER), and one
  lazy gather per side.

Output order: probe-major; within a probe row the build rows in ascending
(key, row) order; then unmatched probe rows; then unmatched build rows.
Sizes are read eagerly (one host sync per variable-size step); there is no
capacity padding. In capacity mode (plan/compiler.py) every such step is an
oracle site instead: the pair expansion takes K5's capacity form (estimated
at one match a probe row, as in the JAX package), the compactions K9's,
the parts are joined by one more compaction, and a lookup join's row count
stays on the device.

Join-key NULL semantics match the reference (join_hash.cpp probe /
probe_semi_anti): NULL keys never match; LEFT/RIGHT/OUTER emit them with a
NULL other side; ANTI keeps them; ANTI_NULL_AS_TRUE (NOT IN) rejects them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.expression.evaluator import _apply_cmp
from hyrise_tpu_torch.kernels.prims import (LUT_MAX_ENTRIES, compact_indices,
                                            expand_pairs, lookup_last_eq,
                                            lookup_last_eq_lut, rank_in_sorted,
                                            ranks_lo_hi, sort_valid_keys)
from hyrise_tpu_torch.kernels.join_probe import expand_pairs_cap
from hyrise_tpu_torch.ops.base import AbstractOperator, capacity_mode, execute_plan
from hyrise_tpu_torch.ops.get_table import TableWrapper
from hyrise_tpu_torch.ops.materialize import (ensure_prefix, filter_table,
                                              gather_columns_at, mask_to_indices)
from hyrise_tpu_torch.ops.sort_util import lexsort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.storage.column import Column, merge_dictionaries
from hyrise_tpu_torch.storage.index import SortedIndex, get_index
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import (EXISTENCE_MODES, DataType, JoinMode,
                                    PredicateCondition)

Ranges = List[Tuple[torch.Tensor, torch.Tensor]]  # (lo, counts) per range


@dataclasses.dataclass
class _KeySpace:
    """One comparable key space for a probe and a build key column (the
    reference's JoinHash hash_traits promotion for mixed int/float keys):
    int64 keys for integer and string columns, float64 otherwise. String
    columns with UNEQUAL dictionaries have their codes rewritten into the
    merged dictionary's code space, whose size is remap_len; a caller that
    bounds the key values must then use (0, remap_len - 1): the columns'
    own bounds are in the old space."""

    dtype: torch.dtype
    probe_remap: Optional[np.ndarray] = None  # old code -> merged code
    build_remap: Optional[np.ndarray] = None
    remap_len: Optional[int] = None


def _key_space(pc: Column, bc: Column) -> _KeySpace:
    if (pc.dtype is DataType.STRING) != (bc.dtype is DataType.STRING):
        raise TypeError("cannot join string with non-string column")
    if pc.dtype is DataType.STRING:
        if pc.dictionary is bc.dictionary or np.array_equal(pc.dictionary, bc.dictionary):
            return _KeySpace(torch.int64)
        merged, rp, rb = merge_dictionaries(pc.dictionary, bc.dictionary)
        return _KeySpace(torch.int64, rp, rb, len(merged))
    if pc.dtype.is_integral and bc.dtype.is_integral:
        return _KeySpace(torch.int64)
    return _KeySpace(torch.float64)


def _keys_in(c: Column, remap: Optional[np.ndarray], dtype: torch.dtype) -> torch.Tensor:
    from hyrise_tpu_torch.plan.compiler import device_constant

    if remap is None:
        return c.data.to(dtype)
    return device_constant(remap, torch.int64, c.device)[c.data.to(torch.int64)]


def _rows(mask: torch.Tensor, label: str):
    """The number of True rows of a masked-layout output: read on the host
    eagerly (oracle_capacity), kept on the device in capacity mode, where
    the mask needs no capacity."""
    from hyrise_tpu_torch.plan.compiler import oracle_capacity

    return mask.sum() if capacity_mode() else oracle_capacity(mask.sum(), label=label)[0]


def _join_key_arrays(lt: Table, rt: Table, left_col: str, right_col: str):
    """Both key columns in one key space (_KeySpace): (lk, lv, rk, rv,
    remap_len), each side's keys and validity or None."""
    lc, rc = lt.column(left_col), rt.column(right_col)
    space = _key_space(lc, rc)
    return (_keys_in(lc, space.probe_remap, space.dtype), lc.validity,
            _keys_in(rc, space.build_remap, space.dtype), rc.validity, space.remap_len)


def _valid_rows(table: Table, validity: Optional[torch.Tensor]) -> torch.Tensor:
    live = table.live_mask()
    return live if validity is None else (live & validity)


def _probe_ranges(sorted_keys: torch.Tensor, probe_keys: torch.Tensor,
                  probe_valid: torch.Tensor, cond: PredicateCondition, n_valid=None):
    """Per probe row, the contiguous match range over the sorted valid
    build keys, as int32 (lo, counts); invalid probe rows get count 0. The
    condition reads `probe cond build`. In capacity mode the sorted keys
    are a buffer whose first `n_valid` (a device count) entries are the
    keys: the ranges are cut there, as in the JAX package."""
    padded = isinstance(n_valid, torch.Tensor)
    if not padded:
        n_valid = sorted_keys.shape[0]
    if cond is PredicateCondition.EQUALS:
        lo, hi = ranks_lo_hi(sorted_keys, probe_keys)
    elif cond is PredicateCondition.LESS_THAN:          # probe < build
        lo = rank_in_sorted(sorted_keys, probe_keys, "right")
        hi = torch.full_like(lo, sorted_keys.shape[0])
    elif cond is PredicateCondition.LESS_THAN_EQUALS:
        lo = rank_in_sorted(sorted_keys, probe_keys, "left")
        hi = torch.full_like(lo, sorted_keys.shape[0])
    elif cond is PredicateCondition.GREATER_THAN:       # probe > build
        hi = rank_in_sorted(sorted_keys, probe_keys, "left")
        lo = torch.zeros_like(hi)
    elif cond is PredicateCondition.GREATER_THAN_EQUALS:
        hi = rank_in_sorted(sorted_keys, probe_keys, "right")
        lo = torch.zeros_like(hi)
    else:
        raise ValueError(cond)
    if padded:
        n32 = n_valid.to(torch.int32)
        lo, hi = torch.minimum(lo, n32), torch.minimum(hi, n32)
        return lo, torch.where(probe_valid, (hi - lo).clamp(min=0), 0)
    counts = torch.where(probe_valid, hi - lo, 0)
    return lo, counts


def _concat_columns(left_cols, right_cols, swap_output: bool):
    return (right_cols + left_cols) if swap_output else (left_cols + right_cols)


@dataclasses.dataclass
class _BuildSide:
    """A join's build side as its probes read it."""

    table: Table                      # the build rows (a prefix copy on the ranges path)
    space: _KeySpace
    keys: torch.Tensor                # in `space`
    validity: Optional[torch.Tensor]  # the key column's
    valid: torch.Tensor               # live and not NULL
    bounds: Optional[Tuple[int, int]] = None  # lookup path: the LUT's, else None
    sorted_keys: Optional[torch.Tensor] = None  # ranges path
    perm: Optional[torch.Tensor] = None
    n_valid: object = None  # ranges path in capacity mode: the device count


class BuildCache:
    """What the build sides of a streamed run cost outside the kernels,
    kept from one block to the next (plan/blocked.py): a build input off the
    stream path gives the same Table object in every block, so its keys,
    LUT bounds (with their possible host read) or sorted order are made
    once a run. An entry keeps the objects whose identity its key holds.
    `builds` counts the entries made."""

    def __init__(self) -> None:
        self._entries: dict = {}
        self.builds = 0

    def get(self, key):
        entry = self._entries.get(key)
        return None if entry is None else entry[1]

    def put(self, key, keep, value) -> None:
        self._entries[key] = (keep, value)
        self.builds += 1

    def clear(self) -> None:
        self._entries.clear()


class Join(AbstractOperator):
    """The join engine (see the module docstring)."""

    name = "Join"

    def __init__(self, left: AbstractOperator, right: AbstractOperator,
                 mode: JoinMode, column_pair: Tuple[str, str],
                 cond: PredicateCondition = PredicateCondition.EQUALS):
        super().__init__(left, right)
        self.mode = mode
        self.left_col, self.right_col = column_pair
        self.cond = cond
        # which path ran: "lut" (K4), "lookup" (K8) or "ranges"
        self.path: Optional[str] = None
        # set by a streamed run (plan/blocked.py) while the build input is
        # one that every block shares
        self.build_cache: Optional[BuildCache] = None

    def _on_execute(self, context) -> Table:
        return self._join(self.input_table(0), self.input_table(1), self.left_col,
                          self.right_col)

    def _join(self, lt: Table, rt: Table, left_col: str, right_col: str) -> Table:
        if self.mode is JoinMode.RIGHT:
            # RIGHT = LEFT with the sides swapped (reference
            # join_hash.cpp:55-76); the output keeps left columns first
            probe_t, build_t = rt, lt
            probe_col, build_col = right_col, left_col
            mode, cond, swap = JoinMode.LEFT, self.cond.flipped(), True
        else:
            probe_t, build_t = lt, rt
            probe_col, build_col = left_col, right_col
            mode, cond, swap = self.mode, self.cond, False
        lookup = self._lookup_applicable(build_t, build_col, mode, cond)
        build = self._build_side(probe_t, build_t, probe_col, build_col, lookup)
        if lookup:
            return self._lookup_execute(probe_t, build, probe_col, mode, swap)
        # the sort-based path pays per row of capacity: compact masked inputs
        probe_t = ensure_prefix(probe_t)
        ranges, probe_valid = self._probe(probe_t, build, probe_col, cond)
        self.path = "ranges"
        return self._emit(probe_t, build.table, build_col, ranges, build.perm,
                          probe_valid, mode, swap)

    def _build_side(self, probe_t: Table, build_t: Table, probe_col: str, build_col: str,
                    lookup: bool) -> "_BuildSide":
        """The build side's keys in the probe's key space, and what the path
        needs of them: the LUT bounds (lookup) or the sorted valid keys
        (ranges, over a prefix copy of a masked build table). With a
        build_cache, a build table seen before (the same Table object, a
        probe key of the same type and dictionary) is not built again."""
        pc = probe_t.column(probe_col)
        probe_dict = pc.dictionary if pc.dtype is DataType.STRING else None
        key = ("build", id(build_t), build_col, pc.dtype, id(probe_dict))
        if self.build_cache is not None:
            cached = self.build_cache.get(key)
            if cached is not None:
                return cached
        table = build_t if lookup else ensure_prefix(build_t)
        bc = table.column(build_col)
        space = _key_space(pc, bc)
        keys = _keys_in(bc, space.build_remap, space.dtype)
        build = _BuildSide(table, space, keys, bc.validity, _valid_rows(table, bc.validity))
        if lookup:
            build.bounds = self._lut_bounds(table, build_col, keys, build.valid,
                                            space.remap_len)
        else:
            build.sorted_keys, build.perm, build.n_valid = self._sorted_build(
                table, build_col, keys, bc.validity, space.remap_len)
        if self.build_cache is not None:
            self.build_cache.put(key, (build_t, probe_dict), build)
        return build

    # -- lookup path (unique build keys / existence joins) -----------------------

    @staticmethod
    def _lookup_applicable(build_t: Table, build_col: str, mode: JoinMode,
                           cond: PredicateCondition) -> bool:
        """One (matched, build row) per probe row is the whole answer when
        every probe row has at most one match to report: SEMI/ANTI need
        existence only, INNER/LEFT need a unique build key column."""
        if cond is not PredicateCondition.EQUALS:
            return False
        if mode in EXISTENCE_MODES:
            return True
        if mode in (JoinMode.INNER, JoinMode.LEFT):
            return build_t.has_column(build_col) and build_t.column(build_col).unique
        return False

    @staticmethod
    def _lut_bounds(build_t: Table, build_col: str, rk: torch.Tensor,
                    build_valid: torch.Tensor,
                    remap_len: Optional[int]) -> Optional[Tuple[int, int]]:
        """Bounds of the build key values when a direct-address table over
        them is possible and small enough, else None. They are carried ON
        the column (val_range survives only row subsets and renames, so a
        derived column can never inherit a base column's bound); string
        codes are bounded by their dictionary; a merged-dictionary rewrite
        supersedes both. Without a carried bound: one device min/max and a
        host read."""
        if rk.dtype is not torch.int64:
            return None
        bc = build_t.column(build_col)
        if remap_len is not None:
            bounds = (0, remap_len - 1)
        elif bc.dtype is DataType.STRING:
            bounds = (0, max(len(bc.dictionary) - 1, 0))
        elif bc.val_range is not None:
            bounds = bc.val_range
        elif capacity_mode():
            return None  # no host read in capacity mode: the hash lookup (K8)
        else:
            info = torch.iinfo(torch.int64)
            bounds = tuple(torch.stack([
                torch.where(build_valid, rk, info.max).amin(),
                torch.where(build_valid, rk, info.min).amax()]).tolist()) \
                if rk.shape[0] else (0, -1)  # no valid build row: lo > hi
        if 0 < bounds[1] - bounds[0] + 1 <= LUT_MAX_ENTRIES:
            return bounds
        return None

    def _lookup_execute(self, probe_t: Table, build: "_BuildSide", probe_col: str,
                        mode: JoinMode, swap_output: bool) -> Table:
        pc = probe_t.column(probe_col)
        lk, lv = _keys_in(pc, build.space.probe_remap, build.space.dtype), pc.validity
        live = probe_t.live_mask()
        probe_valid = live if lv is None else (live & lv)
        if build.bounds is not None:
            matched, build_row = lookup_last_eq_lut(build.keys, build.valid, lk,
                                                    *build.bounds)
            self.path = "lut"
        else:
            matched, build_row = lookup_last_eq(build.keys, build.valid, lk)
            self.path = "lookup"
        matched = matched & probe_valid
        if mode in EXISTENCE_MODES:
            keep = matched if mode is JoinMode.SEMI else (live & ~matched)
            if mode is JoinMode.ANTI_NULL_AS_TRUE:
                # NOT IN (reference JoinMode::AntiNullAsTrue): a NULL probe
                # key is rejected unless the set is empty, and any NULL in
                # the build set rejects every probe row
                b_live = build.table.live_mask()
                if lv is not None:
                    keep = keep & (lv | ~b_live.any())
                if build.validity is not None:
                    keep = keep & ~(b_live & ~build.validity).any()
            return Table(probe_t.columns, _rows(keep, "join.lookup"), name=probe_t.name,
                         live=keep)
        out_live = matched if mode is JoinMode.INNER else live
        build_cols = gather_columns_at(
            build.table, build_row, matched if mode is JoinMode.LEFT else None)
        return Table(_concat_columns(probe_t.columns, build_cols, swap_output),
                     _rows(out_live, "join.lookup"), name=probe_t.name, live=out_live)

    # -- sorted-range path -------------------------------------------------------

    def _probe(self, probe_t: Table, build: "_BuildSide", probe_col: str,
               cond: PredicateCondition):
        """(ranges, probe_valid): per probe row the match ranges over the
        build side's valid rows in sorted order."""
        pc = probe_t.column(probe_col)
        lk = _keys_in(pc, build.space.probe_remap, build.space.dtype)
        probe_valid = _valid_rows(probe_t, pc.validity)
        if cond is PredicateCondition.NOT_EQUALS:
            conds = (PredicateCondition.GREATER_THAN, PredicateCondition.LESS_THAN)
        else:
            conds = (cond,)
        ranges = [_probe_ranges(build.sorted_keys, lk, probe_valid, c, build.n_valid)
                  for c in conds]
        return ranges, probe_valid

    def _sorted_build(self, build_t: Table, build_col: str, rk: torch.Tensor,
                      rv: Optional[torch.Tensor], remap_len: Optional[int]):
        """The build side's valid rows in ascending (key, row) order: (sorted
        keys, their rows, None), or in capacity mode (a buffer of sorted
        keys, their rows, the device count of valid rows)."""
        if capacity_mode():
            return _sort_valid_capacity(rk, _valid_rows(build_t, rv))
        return (*sort_valid_keys(rk, _valid_rows(build_t, rv)), None)

    @staticmethod
    def _emit(probe_t: Table, build_t: Table, build_col: str, ranges: Ranges,
              build_perm: torch.Tensor, probe_valid: torch.Tensor, mode: JoinMode,
              swap_output: bool) -> Table:
        total_counts = ranges[0][1]
        for _, c in ranges[1:]:
            total_counts = total_counts + c
        live = probe_t.live_mask()

        if mode in EXISTENCE_MODES:
            if mode is JoinMode.SEMI:
                keep = (total_counts > 0) & live
            elif mode is JoinMode.ANTI:
                keep = (total_counts == 0) & live  # NULL keys kept: no match
            else:
                # ANTI_NULL_AS_TRUE (NOT IN): NULL probe keys are rejected
                # against a non-empty set, and any NULL build key empties
                # the result
                b_live = build_t.live_mask()
                keep = (total_counts == 0) & torch.where(b_live.any(), probe_valid, live)
                bcol = build_t.column(build_col)
                if bcol.validity is not None:
                    keep = keep & ~(b_live & ~bcol.validity).any()
            return filter_table(probe_t, keep)

        if capacity_mode():
            return _emit_capacity(probe_t, build_t, ranges, build_perm, total_counts,
                                  live, mode, swap_output)
        from hyrise_tpu_torch.plan.compiler import note_eager_read

        dev = probe_t.device
        expanded = [expand_pairs(lo, counts, build_perm) for lo, counts in ranges]
        for _ in expanded:
            note_eager_read()  # K5 handed the number of pairs to the host
        probe_parts = [p for p, _ in expanded]
        build_parts = [b for _, b in expanded]
        n_pairs = sum(p.shape[0] for p in probe_parts)
        # (rows with real values, then NULL-padded rows) per side
        probe_ok = [torch.ones(n_pairs, dtype=torch.bool, device=dev)]
        build_ok = [torch.ones(n_pairs, dtype=torch.bool, device=dev)]

        def pad(n: int, real: bool) -> torch.Tensor:
            return torch.full((n,), real, dtype=torch.bool, device=dev)

        if mode in (JoinMode.LEFT, JoinMode.OUTER):
            unmatched = compact_indices((total_counts == 0) & live)
            probe_parts.append(unmatched)
            build_parts.append(torch.zeros_like(unmatched))
            probe_ok.append(pad(unmatched.shape[0], True))
            build_ok.append(pad(unmatched.shape[0], False))
        if mode is JoinMode.OUTER:
            seen = torch.zeros(build_t.capacity, dtype=torch.bool, device=dev)
            for b in build_parts[:len(expanded)]:
                seen[b] = True
            unmatched = compact_indices(~seen & build_t.live_mask())
            probe_parts.append(torch.zeros_like(unmatched))
            build_parts.append(unmatched)
            probe_ok.append(pad(unmatched.shape[0], False))
            build_ok.append(pad(unmatched.shape[0], True))

        probe_idx, build_idx = torch.cat(probe_parts), torch.cat(build_parts)
        probe_cols = gather_columns_at(
            probe_t, probe_idx,
            torch.cat(probe_ok) if mode is JoinMode.OUTER else None)
        build_cols = gather_columns_at(
            build_t, build_idx,
            torch.cat(build_ok) if mode in (JoinMode.LEFT, JoinMode.OUTER) else None)
        return Table(_concat_columns(probe_cols, build_cols, swap_output),
                     probe_idx.shape[0], name=probe_t.name)


def _sort_valid_capacity(keys: torch.Tensor, valid: torch.Tensor):
    """sort_valid_keys in capacity mode: (sorted keys, their rows, the
    device count of valid rows). The valid rows' positions come from the
    oracle's compaction and sort first, in the order sort_valid_keys gives;
    the padding behind them repeats the last valid key, so the buffer stays
    sorted whatever the keys (NaN included), and _probe_ranges cuts the
    ranges at the count."""
    rows, n_valid = mask_to_indices(valid, "join.build_valid")
    in_use = torch.arange(rows.shape[0], device=rows.device) < n_valid
    k = keys.index_select(0, rows)
    order = lexsort([k, (~in_use).to(torch.int32)])
    k = k.index_select(0, order)
    last = k.index_select(0, (n_valid - 1).clamp(min=0).reshape(1))
    return torch.where(in_use, k, last), rows.index_select(0, order), n_valid


def _capacity_parts(parts, dev):
    """Join the parts of a capacity-mode join output, each (probe rows,
    build rows, device count, flag: 1 both sides real, 0 build side NULL, 2
    probe side NULL), into (probe rows, build rows, flags or None, count):
    one part as it is, several by one more oracle compaction."""
    if len(parts) == 1:
        p, b, n, _ = parts[0]
        return p, b, None, n
    keep = torch.cat([torch.arange(p.shape[0], device=dev) < n for p, _, n, _ in parts])
    sel, n_out = mask_to_indices(keep, "join.out")
    flags = torch.cat([torch.full((p.shape[0],), f, dtype=torch.int32, device=dev)
                       for p, _, _, f in parts])
    return (torch.cat([p for p, _, _, _ in parts]).index_select(0, sel),
            torch.cat([b for _, b, _, _ in parts]).index_select(0, sel),
            flags.index_select(0, sel), n_out)


def _emit_capacity(probe_t: Table, build_t: Table, ranges: Ranges, build_perm: torch.Tensor,
                   total_counts: torch.Tensor, live: torch.Tensor, mode: JoinMode,
                   swap_output: bool) -> Table:
    """Join._emit in capacity mode (the JAX package's _emit): each range
    list expands through K5's capacity form at a site estimated at one pair
    a probe row, then the unmatched probe rows (LEFT/OUTER) and build rows
    (OUTER) through K9's."""
    from hyrise_tpu_torch.plan.compiler import active

    ctx = active()
    dev = probe_t.device
    parts = []
    for lo, counts in ranges:
        cap = ctx.reserve(None, probe_t.capacity, "join.expand")
        p, b, total, refused = expand_pairs_cap(lo, counts, build_perm, cap)
        ctx.check(refused, "join.expand ranges")
        parts.append((p, b, ctx.record(total, cap), 1))
    if mode in (JoinMode.LEFT, JoinMode.OUTER):
        u, n_u = mask_to_indices((total_counts == 0) & live, "join.unmatched")
        parts.append((u, torch.zeros_like(u), n_u, 0))
    if mode is JoinMode.OUTER:
        seen = torch.zeros(build_t.capacity + 1, dtype=torch.bool, device=dev)
        for _, b, n, _ in parts[:len(ranges)]:
            in_use = torch.arange(b.shape[0], device=dev) < n
            seen.index_fill_(0, torch.where(in_use, b, build_t.capacity), True)
        bu, n_bu = mask_to_indices(~seen[:-1] & build_t.live_mask(), "join.build_unmatched")
        parts.append((torch.zeros_like(bu), bu, n_bu, 2))
    probe_idx, build_idx, flags, n_out = _capacity_parts(parts, dev)
    probe_cols = gather_columns_at(probe_t, probe_idx,
                                   flags != 2 if mode is JoinMode.OUTER else None)
    build_cols = gather_columns_at(build_t, build_idx,
                                   flags >= 1 if mode in (JoinMode.LEFT, JoinMode.OUTER)
                                   else None)
    return Table(_concat_columns(probe_cols, build_cols, swap_output), n_out,
                 name=probe_t.name)


class JoinHash(Join):
    """Equi-join entry point (reference JoinHash): the same engine, equality
    only, as join_hash.cpp asserts."""

    name = "JoinHash"

    def __init__(self, left, right, mode, column_pair,
                 cond=PredicateCondition.EQUALS):
        if cond is not PredicateCondition.EQUALS:
            raise ValueError("JoinHash supports equi joins only")
        super().__init__(left, right, mode, column_pair, cond)


class JoinSortMerge(Join):
    """Reference JoinSortMerge: equi and non-equi conditions."""

    name = "JoinSortMerge"


class JoinMPSM(Join):
    """Reference JoinMPSM (join_mpsm.cpp). On one device it is the shared
    engine, a one-cluster sort-merge; its range-clustered distributed form
    is part of the distribution work (parallel/), not ported yet."""

    name = "JoinMPSM"


class JoinIndex(Join):
    """Reference JoinIndex (join_index.cpp: the probe side walks the build
    side's index instead of building a hash table). When the build input is
    the very table that carries an index on the join column, the index's
    sorted values and permutation are the sorted build side, in the order
    sort_valid_keys gives, so the result equals Join's, row for row. Only
    the sorted-range path runs (searchsorted and expand_pairs, K5): the
    lookup paths would not read the index. performance_data.extra
    ["index_used"] says whether the index served; it does not where the
    keys are promoted across kinds (int against float), where string
    dictionaries differ, where the build input was compacted into a new
    table (its rows are not the index's), or in capacity mode, where it
    sorts as the JAX CompiledQuery's index-free traced tables do (a
    captured graph reads no index tensor)."""

    name = "JoinIndex"

    @staticmethod
    def _lookup_applicable(build_t, build_col, mode, cond) -> bool:
        return False

    def _sorted_build(self, build_t, build_col, rk, rv, remap_len):
        idx = None if capacity_mode() else get_index(build_t, build_col)
        values = None if idx is None else idx.sorted_values
        used = (isinstance(idx, SortedIndex) and remap_len is None
                and values.is_floating_point() == rk.is_floating_point())
        self.performance_data.extra["index_used"] = used
        if not used:
            return super()._sorted_build(build_t, build_col, rk, rv, remap_len)
        return values.to(rk.dtype), idx.perm, None


PACKED_LEFT, PACKED_RIGHT = "__packed_key_left", "__packed_key_right"


def _pack_ranges(lt: Table, rt: Table, pairs) -> Optional[List[Tuple[int, int]]]:
    """(lowest value, width) per key pair when the pairs pack into one int64
    key without collisions: integer columns with known val_ranges, or
    string columns of one dictionary, whose widths multiply to at most
    2^63. None otherwise."""
    out = []
    for left, right in pairs:
        a, b = lt.column(left), rt.column(right)
        if a.dtype is DataType.STRING and b.dtype is DataType.STRING:
            if not (a.dictionary is b.dictionary
                    or np.array_equal(a.dictionary, b.dictionary)):
                return None
            lo, hi = 0, max(len(a.dictionary) - 1, 0)
        elif a.dtype.is_integral and b.dtype.is_integral and \
                a.val_range is not None and b.val_range is not None:
            lo = min(a.val_range[0], b.val_range[0])
            hi = max(a.val_range[1], b.val_range[1])
        else:
            return None
        out.append((lo, hi - lo + 1))
    return out if math.prod(w for _, w in out) <= 1 << 63 else None


def _with_packed_key(t: Table, columns: Sequence[str], ranges, name: str) -> Table:
    """`t` with one more column `name`: its key columns packed into one
    int64, NULL where any of them is NULL. It is unique where one of them
    is, and bounded by the product of the widths."""
    cols = [t.column(c) for c in columns]
    key = torch.zeros(t.capacity, dtype=torch.int64, device=t.device)
    validity = None
    for c, (lo, width) in zip(cols, ranges):
        key = key * width + (c.data.to(torch.int64) - lo)
        if c.validity is not None:
            validity = c.validity if validity is None else validity & c.validity
    packed = Column(name, DataType.INT64, key, validity, unique=any(c.unique for c in cols),
                    val_range=(0, math.prod(w for _, w in ranges) - 1))
    return Table(list(t.columns) + [packed], t.num_rows, name=t.name, live=t.live)


class MultiKeyJoin(Join):
    """An INNER equi join on several column pairs (ROADMAP C22), as the
    physical translator makes it from a JoinNode and the column equalities
    between its two sides directly above it (plan/translator.py).

    Where the key pairs pack into one int64 key (_pack_ranges), each side
    gets the packed key as one more column, the join engine runs on that one
    pair, and the packed columns are dropped again: the join expands only
    the pairs that match on every key, and a packed key that is unique on
    the build side takes the lookup path. Otherwise it is the plan the
    JoinNode gave before: the join on the first pair, then a TableScan of
    each other equality. performance_data.extra["packed_key"] says which
    ran. The rows and their order are the same either way."""

    name = "Join"

    def __init__(self, left: AbstractOperator, right: AbstractOperator,
                 column_pair: Tuple[str, str], folded: Sequence[Tuple[str, str, object]]):
        super().__init__(left, right, JoinMode.INNER, column_pair)
        # (left column, right column, the equality's predicate) each
        self.folded = list(folded)

    @property
    def column_pairs(self) -> List[Tuple[str, str]]:
        return [(self.left_col, self.right_col)] + [(a, b) for a, b, _ in self.folded]

    def _on_execute(self, context) -> Table:
        lt, rt = self.input_table(0), self.input_table(1)
        pairs = self.column_pairs
        ranges = _pack_ranges(lt, rt, pairs)
        self.performance_data.extra["packed_key"] = ranges is not None
        if ranges is None:
            out = self._join(lt, rt, self.left_col, self.right_col)
            for _, _, predicate in self.folded:
                out = execute_plan(TableScan(TableWrapper(out), predicate))
            return out
        packed_lt = _with_packed_key(lt, [a for a, _ in pairs], ranges, PACKED_LEFT)
        key = ("packed", id(rt))
        packed_rt = None if self.build_cache is None else self.build_cache.get(key)
        if packed_rt is None:
            packed_rt = _with_packed_key(rt, [b for _, b in pairs], ranges, PACKED_RIGHT)
            if self.build_cache is not None:
                self.build_cache.put(key, rt, packed_rt)
        out = self._join(packed_lt, packed_rt, PACKED_LEFT, PACKED_RIGHT)
        return Table([c for c in out.columns if c.name not in (PACKED_LEFT, PACKED_RIGHT)],
                     out.num_rows, name=out.name, live=out.live)


class JoinNestedLoop(AbstractOperator):
    """O(n*m) fallback over a dense pair matrix (reference
    join_nested_loop.cpp: all modes, all conditions). For cross-checks and
    small inputs only: the matrix holds capacity x capacity bools."""

    name = "JoinNestedLoop"

    def __init__(self, left, right, mode: JoinMode, column_pair,
                 cond: PredicateCondition = PredicateCondition.EQUALS):
        super().__init__(left, right)
        self.mode = mode
        self.left_col, self.right_col = column_pair
        self.cond = cond

    def _on_execute(self, context) -> Table:
        mode = self.mode
        lt, rt = self.input_table(0), self.input_table(1)
        lk, lv, rk, rv, _ = _join_key_arrays(lt, rt, self.left_col, self.right_col)
        pair = (_apply_cmp(self.cond, lk[:, None], rk[None, :])
                & _valid_rows(lt, lv)[:, None] & _valid_rows(rt, rv)[None, :])
        l_counts = pair.sum(dim=1)

        if mode in EXISTENCE_MODES:
            keep = ((l_counts > 0) if mode is JoinMode.SEMI
                    else (l_counts == 0)) & lt.live_mask()
            if mode is JoinMode.ANTI_NULL_AS_TRUE:  # NOT IN
                if lv is not None:
                    keep = keep & (lv | ~rt.live_mask().any())
                if rv is not None:
                    keep = keep & ~(rt.live_mask() & ~rv).any()
            return filter_table(lt, keep)

        # matched pairs, flat left-major
        dev = lt.device
        if capacity_mode():
            return self._capacity_form(lt, rt, pair, l_counts)
        sel = compact_indices(pair.reshape(-1))
        left_parts = [sel // max(rt.capacity, 1)]
        right_parts = [sel % max(rt.capacity, 1)]
        n_pairs = sel.shape[0]
        left_ok = [torch.ones(n_pairs, dtype=torch.bool, device=dev)]
        right_ok = [torch.ones(n_pairs, dtype=torch.bool, device=dev)]

        def pad(n: int, real: bool) -> torch.Tensor:
            return torch.full((n,), real, dtype=torch.bool, device=dev)

        if mode in (JoinMode.LEFT, JoinMode.OUTER):
            unmatched = compact_indices((l_counts == 0) & lt.live_mask())
            left_parts.append(unmatched)
            right_parts.append(torch.zeros_like(unmatched))
            left_ok.append(pad(unmatched.shape[0], True))
            right_ok.append(pad(unmatched.shape[0], False))
        if mode in (JoinMode.RIGHT, JoinMode.OUTER):
            unmatched = compact_indices((pair.sum(dim=0) == 0) & rt.live_mask())
            left_parts.append(torch.zeros_like(unmatched))
            right_parts.append(unmatched)
            left_ok.append(pad(unmatched.shape[0], False))
            right_ok.append(pad(unmatched.shape[0], True))

        left_idx, right_idx = torch.cat(left_parts), torch.cat(right_parts)
        left_cols = gather_columns_at(
            lt, left_idx,
            torch.cat(left_ok) if mode in (JoinMode.RIGHT, JoinMode.OUTER) else None)
        right_cols = gather_columns_at(
            rt, right_idx,
            torch.cat(right_ok) if mode in (JoinMode.LEFT, JoinMode.OUTER) else None)
        return Table(left_cols + right_cols, left_idx.shape[0], name=lt.name)

    def _capacity_form(self, lt: Table, rt: Table, pair: torch.Tensor,
                       l_counts: torch.Tensor) -> Table:
        """The pairs and the unmatched rows through the oracle's compactions."""
        mode, dev = self.mode, lt.device
        m = max(rt.capacity, 1)
        sel, n = mask_to_indices(pair.reshape(-1), "join.pairs")
        parts = [(sel // m, sel % m, n, 1)]
        if mode in (JoinMode.LEFT, JoinMode.OUTER):
            u, n_u = mask_to_indices((l_counts == 0) & lt.live_mask(), "join.unmatched")
            parts.append((u, torch.zeros_like(u), n_u, 0))
        if mode in (JoinMode.RIGHT, JoinMode.OUTER):
            u, n_u = mask_to_indices((pair.sum(dim=0) == 0) & rt.live_mask(),
                                     "join.build_unmatched")
            parts.append((torch.zeros_like(u), u, n_u, 2))
        left_idx, right_idx, flags, n_out = _capacity_parts(parts, dev)
        left_cols = gather_columns_at(
            lt, left_idx, flags != 2 if mode in (JoinMode.RIGHT, JoinMode.OUTER) else None)
        right_cols = gather_columns_at(
            rt, right_idx, flags >= 1 if mode in (JoinMode.LEFT, JoinMode.OUTER) else None)
        return Table(left_cols + right_cols, n_out, name=lt.name)


class Product(AbstractOperator):
    """Cross join (reference product.cpp): every left row beside every right
    row, left-major, as two index tensors and lazy gathers."""

    name = "Product"

    def __init__(self, left, right):
        super().__init__(left, right)

    def _on_execute(self, context) -> Table:
        lt = ensure_prefix(self.input_table(0))
        rt = ensure_prefix(self.input_table(1))
        n, m = lt.num_rows, rt.num_rows
        if isinstance(n, torch.Tensor) or isinstance(m, torch.Tensor):
            # capacity mode: every pair of positions, the live ones in a mask
            nc, mc = lt.capacity, max(rt.capacity, 1)
            idx = torch.arange(nc * rt.capacity, device=lt.device)
            live = (idx // mc < n) & (idx % mc < m)
            cols = gather_columns_at(lt, idx // mc) + gather_columns_at(rt, idx % mc)
            return Table(cols, n * m, name=lt.name, live=live)
        idx = torch.arange(n * m, device=lt.device)
        cols = gather_columns_at(lt, idx // max(m, 1)) + \
            gather_columns_at(rt, idx % max(m, 1))
        return Table(cols, n * m, name=lt.name)
