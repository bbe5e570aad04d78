"""Join operators.

Port of hyrise_tpu/ops/join.py. Reference operators covered: JoinHash
(src/lib/operators/join_hash.cpp), JoinSortMerge (join_sort_merge.cpp),
JoinMPSM, JoinNestedLoop (join_nested_loop.cpp) and Product (product.cpp).
JoinIndex waits for storage/index.py.

One engine, two paths:

- lookup: an equi-join in which every probe row has at most one match to
  report (SEMI/ANTI need existence only; INNER/LEFT need a build key column
  flagged `unique`). One probe gives (matched, build row) per probe row: the
  direct-address table of the K4 kernel when the key range is known and
  small enough, else a sort and binary searches (prims.lookup_last_eq). The
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
capacity padding.

Join-key NULL semantics match the reference (join_hash.cpp probe /
probe_semi_anti): NULL keys never match; LEFT/RIGHT/OUTER emit them with a
NULL other side; ANTI keeps them; ANTI_NULL_AS_TRUE (NOT IN) rejects them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.expression.evaluator import _apply_cmp
from hyrise_tpu_torch.kernels.prims import (LUT_MAX_ENTRIES, compact_indices,
                                            expand_pairs, lookup_last_eq,
                                            lookup_last_eq_lut, rank_in_sorted,
                                            ranks_lo_hi, sort_valid_keys)
from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import (ensure_prefix, filter_table,
                                              gather_columns_at)
from hyrise_tpu_torch.storage.column import merge_dictionaries
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import (EXISTENCE_MODES, DataType, JoinMode,
                                    PredicateCondition)

Ranges = List[Tuple[torch.Tensor, torch.Tensor]]  # (lo, counts) per range


def _join_key_arrays(lt: Table, rt: Table, left_col: str, right_col: str):
    """Promote both key columns into one comparable key space (the
    reference's JoinHash hash_traits promotion for mixed int/float keys).

    Returns (lk, lv, rk, rv, remap_len): int64 keys for integer and string
    columns, float64 otherwise, and each side's validity or None. remap_len
    is None unless the keys are string columns with UNEQUAL dictionaries;
    then the codes were rewritten into the merged dictionary's code space
    and remap_len is its size, and a caller that bounds the key values must
    use (0, remap_len - 1): the columns' own bounds are in the old space."""
    lc, rc = lt.column(left_col), rt.column(right_col)
    if (lc.dtype is DataType.STRING) != (rc.dtype is DataType.STRING):
        raise TypeError("cannot join string with non-string column")
    remap_len = None
    if lc.dtype is DataType.STRING:
        same = lc.dictionary is rc.dictionary or np.array_equal(
            lc.dictionary, rc.dictionary)
        if same:
            lk, rk = lc.data.to(torch.int64), rc.data.to(torch.int64)
        else:
            merged, rl, rr = merge_dictionaries(lc.dictionary, rc.dictionary)
            dev = lt.device
            lk = torch.as_tensor(rl, dtype=torch.int64, device=dev)[lc.data.to(torch.int64)]
            rk = torch.as_tensor(rr, dtype=torch.int64, device=dev)[rc.data.to(torch.int64)]
            remap_len = len(merged)
    elif lc.dtype.is_integral and rc.dtype.is_integral:
        lk, rk = lc.data.to(torch.int64), rc.data.to(torch.int64)
    else:
        lk, rk = lc.data.to(torch.float64), rc.data.to(torch.float64)
    return lk, lc.validity, rk, rc.validity, remap_len


def _valid_rows(table: Table, validity: Optional[torch.Tensor]) -> torch.Tensor:
    live = table.live_mask()
    return live if validity is None else (live & validity)


def _probe_ranges(sorted_keys: torch.Tensor, probe_keys: torch.Tensor,
                  probe_valid: torch.Tensor, cond: PredicateCondition):
    """Per probe row, the contiguous match range over the sorted valid
    build keys, as int32 (lo, counts); invalid probe rows get count 0. The
    condition reads `probe cond build`."""
    n_valid = sorted_keys.shape[0]
    if cond is PredicateCondition.EQUALS:
        lo, hi = ranks_lo_hi(sorted_keys, probe_keys)
    elif cond is PredicateCondition.LESS_THAN:          # probe < build
        lo = rank_in_sorted(sorted_keys, probe_keys, "right")
        hi = torch.full_like(lo, n_valid)
    elif cond is PredicateCondition.LESS_THAN_EQUALS:
        lo = rank_in_sorted(sorted_keys, probe_keys, "left")
        hi = torch.full_like(lo, n_valid)
    elif cond is PredicateCondition.GREATER_THAN:       # probe > build
        hi = rank_in_sorted(sorted_keys, probe_keys, "left")
        lo = torch.zeros_like(hi)
    elif cond is PredicateCondition.GREATER_THAN_EQUALS:
        hi = rank_in_sorted(sorted_keys, probe_keys, "right")
        lo = torch.zeros_like(hi)
    else:
        raise ValueError(cond)
    counts = torch.where(probe_valid, hi - lo, 0)
    return lo, counts


def _concat_columns(left_cols, right_cols, swap_output: bool):
    return (right_cols + left_cols) if swap_output else (left_cols + right_cols)


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
        # which path ran: "lut" (K4), "lookup" (sorted lookup) or "ranges"
        self.path: Optional[str] = None

    def _on_execute(self, context) -> Table:
        lt, rt = self.input_table(0), self.input_table(1)
        if self.mode is JoinMode.RIGHT:
            # RIGHT = LEFT with the sides swapped (reference
            # join_hash.cpp:55-76); the output keeps left columns first
            probe_t, build_t = rt, lt
            probe_col, build_col = self.right_col, self.left_col
            mode, cond, swap = JoinMode.LEFT, self.cond.flipped(), True
        else:
            probe_t, build_t = lt, rt
            probe_col, build_col = self.left_col, self.right_col
            mode, cond, swap = self.mode, self.cond, False
        if self._lookup_applicable(build_t, build_col, mode, cond):
            return self._lookup_execute(probe_t, build_t, probe_col, build_col,
                                        mode, swap)
        # the sort-based path pays per row of capacity: compact masked inputs
        probe_t, build_t = ensure_prefix(probe_t), ensure_prefix(build_t)
        ranges, perm, probe_valid = self._probe(probe_t, build_t, probe_col,
                                                build_col, cond)
        self.path = "ranges"
        return self._emit(probe_t, build_t, build_col, ranges, perm,
                          probe_valid, mode, swap)

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
        else:
            info = torch.iinfo(torch.int64)
            bounds = tuple(torch.stack([
                torch.where(build_valid, rk, info.max).amin(),
                torch.where(build_valid, rk, info.min).amax()]).tolist()) \
                if rk.shape[0] else (0, -1)  # no valid build row: lo > hi
        if 0 < bounds[1] - bounds[0] + 1 <= LUT_MAX_ENTRIES:
            return bounds
        return None

    def _lookup_execute(self, probe_t: Table, build_t: Table, probe_col: str,
                        build_col: str, mode: JoinMode, swap_output: bool) -> Table:
        lk, lv, rk, rv, remap_len = _join_key_arrays(probe_t, build_t,
                                                     probe_col, build_col)
        live = probe_t.live_mask()
        probe_valid = live if lv is None else (live & lv)
        b_live = build_t.live_mask()
        build_valid = b_live if rv is None else (b_live & rv)
        bounds = self._lut_bounds(build_t, build_col, rk, build_valid, remap_len)
        if bounds is not None:
            matched, build_row = lookup_last_eq_lut(rk, build_valid, lk, *bounds)
            self.path = "lut"
        else:
            matched, build_row = lookup_last_eq(rk, build_valid, lk)
            self.path = "lookup"
        matched = matched & probe_valid
        if mode in EXISTENCE_MODES:
            keep = matched if mode is JoinMode.SEMI else (live & ~matched)
            if mode is JoinMode.ANTI_NULL_AS_TRUE:
                # NOT IN (reference JoinMode::AntiNullAsTrue): a NULL probe
                # key is rejected unless the set is empty, and any NULL in
                # the build set rejects every probe row
                if lv is not None:
                    keep = keep & (lv | ~b_live.any())
                if rv is not None:
                    keep = keep & ~(b_live & ~rv).any()
            return Table(probe_t.columns, int(keep.sum()), name=probe_t.name,
                         live=keep)
        out_live = matched if mode is JoinMode.INNER else live
        build_cols = gather_columns_at(
            build_t, build_row, matched if mode is JoinMode.LEFT else None)
        return Table(_concat_columns(probe_t.columns, build_cols, swap_output),
                     int(out_live.sum()), name=probe_t.name, live=out_live)

    # -- sorted-range path -------------------------------------------------------

    @staticmethod
    def _probe(probe_t: Table, build_t: Table, probe_col: str, build_col: str,
               cond: PredicateCondition):
        """(ranges, build_perm, probe_valid): per probe row the match ranges
        over the build side's valid rows in sorted order, and that order as
        original build rows."""
        lk, lv, rk, rv, _ = _join_key_arrays(probe_t, build_t, probe_col, build_col)
        probe_valid = _valid_rows(probe_t, lv)
        sorted_keys, perm = sort_valid_keys(rk, _valid_rows(build_t, rv))
        if cond is PredicateCondition.NOT_EQUALS:
            conds = (PredicateCondition.GREATER_THAN, PredicateCondition.LESS_THAN)
        else:
            conds = (cond,)
        ranges = [_probe_ranges(sorted_keys, lk, probe_valid, c) for c in conds]
        return ranges, perm, probe_valid

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

        dev = probe_t.device
        expanded = [expand_pairs(lo, counts, build_perm) for lo, counts in ranges]
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
        idx = torch.arange(n * m, device=lt.device)
        cols = gather_columns_at(lt, idx // max(m, 1)) + \
            gather_columns_at(rt, idx % max(m, 1))
        return Table(cols, n * m, name=lt.name)
