"""The comparison that decides `correct`: an answer of the program against
the plain reference's answer to the same query over the same data.

Rows are matched whatever order ties left them in: both sides are sorted by
their integer and string columns (unique in every TPC-H answer), floats
last. Then
- `exact_mismatches` counts what must be equal: the row and column counts,
  every integer and string cell, which cells are NULL, and every pair of
  neighbouring program rows out of the text's ORDER BY order (checked on
  the program's own values, so ties may fall either way);
- `float_rel_err` is the widest relative gap |program - reference| /
  |reference| of a float cell (0 where both are equal, so an exact zero
  matches an exact zero).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from tpch_bench_gpu.reference.common import Answer


def _as_kind(values: np.ndarray, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """(values in the kind's host type, NULL mask): None, and NaN in a
    float column, stand for NULL."""
    values = np.asarray(values)
    null = np.equal(values, None) if values.dtype == object else np.zeros(len(values), dtype=bool)
    if kind == "str":
        out = values.astype(object)
        out[null] = ""
        return out, null
    if kind == "float":
        out = np.where(null, np.nan, values).astype(np.float64)
        null = null | np.isnan(out)
        return np.where(null, 0.0, out), null
    return np.where(null, 0, values).astype(np.int64), null


def _ranks(*arrays: np.ndarray) -> List[np.ndarray]:
    """String arrays as integer ranks in one shared string order."""
    joined = np.concatenate([a.astype(str) for a in arrays])
    _, inverse = np.unique(joined, return_inverse=True)
    out, at = [], 0
    for a in arrays:
        out.append(inverse[at:at + len(a)])
        at += len(a)
    return out


def _canonical(cols: List[np.ndarray], kinds: Sequence[str], ranks: List[np.ndarray]) -> np.ndarray:
    keys = [r for r, k in zip(ranks, kinds) if k != "float"] + \
        [c for c, k in zip(cols, kinds) if k == "float"]
    if not keys or len(cols[0]) == 0:
        return np.arange(len(cols[0]) if cols else 0)
    return np.lexsort(keys[::-1])


def order_violations(cols: List[np.ndarray], kinds: Sequence[str], order_by) -> int:
    """Neighbouring rows out of ORDER BY order (ASC / DESC per key)."""
    n = len(cols[0]) if cols else 0
    if n < 2 or not order_by:
        return 0
    undecided = np.ones(n - 1, dtype=bool)
    bad = np.zeros(n - 1, dtype=bool)
    for index, direction in order_by:
        key = _ranks(cols[index])[0] if kinds[index] == "str" else cols[index]
        step = np.sign(np.diff(key))
        if direction == "desc":
            step = -step
        bad |= undecided & (step < 0)
        undecided &= step == 0
    return int(bad.sum())


def compare(program: Sequence[np.ndarray], reference: Answer, order_by) -> Tuple[int, float]:
    """(exact_mismatches, float_rel_err) of one program answer, given as
    its columns in output order, against the reference's."""
    kinds = reference.kinds
    rows = len(reference.columns[0]) if reference.columns else 0
    if len(program) != len(kinds):
        return max(rows, 1) * max(len(kinds), 1), 0.0
    p_rows = len(program[0]) if len(program) else 0
    if p_rows != rows:
        return max(rows, p_rows, 1) * len(kinds), 0.0
    prog = [_as_kind(c, k) for c, k in zip(program, kinds)]
    ref = [_as_kind(c, k) for c, k in zip(reference.columns, kinds)]
    mismatches = order_violations([v for v, _ in prog], kinds, order_by)
    p_ranks, r_ranks = [], []
    for (pv, _), (rv, _), k in zip(prog, ref, kinds):
        if k == "str":
            a, b = _ranks(pv, rv)
        else:
            a, b = pv, rv
        p_ranks.append(a)
        r_ranks.append(b)
    p_order = _canonical([v for v, _ in prog], kinds, p_ranks)
    r_order = _canonical([v for v, _ in ref], kinds, r_ranks)
    widest = 0.0
    for (pv, pn), (rv, rn), k in zip(prog, ref, kinds):
        pv, pn, rv, rn = pv[p_order], pn[p_order], rv[r_order], rn[r_order]
        mismatches += int((pn != rn).sum())
        both = ~pn & ~rn
        if k == "float":
            gap = np.abs(pv[both] - rv[both])
            scale = np.abs(rv[both])
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(gap == 0, 0.0, gap / scale)
            if len(rel):
                widest = max(widest, float(np.max(rel)))
        else:
            mismatches += int((pv[both] != rv[both]).sum())
    return mismatches, widest


def sorted_answer(answer: Answer, order_by) -> Answer:
    """The answer's rows in ORDER BY order (stable), as the program returns
    them: for the control, which stands in the program's place."""
    if not order_by or not answer.columns or len(answer.columns[0]) < 2:
        return answer
    keys = []
    for index, direction in order_by:
        col = answer.columns[index]
        key = _ranks(col)[0] if answer.kinds[index] == "str" else col
        keys.append(-key if direction == "desc" else key)
    order = np.lexsort(keys[::-1])
    return Answer([c[order] for c in answer.columns], answer.kinds)
