"""What every plain reference query uses: the generated tables as torch
tensors, string predicates over a column's value pool, key maps and
group-bys.

Plain torch, on whatever device the caller names. It imports nothing of the
program under test and takes nothing the program made: the tables come from
datagen.generate_specs, as the program's do.

Semantics followed (the configuration's `precision`): arithmetic over
float32 columns and integer literals stays float32, a float literal makes
it float64; SUM and AVG of a float column accumulate in `acc` (float64 as
the configuration states; float32 in the lower-precision control), COUNT
and the SUM of an integer column are int64. A string column is compared as
its strings: a predicate is evaluated once over the column's pool and read
through the codes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Answer:
    """A query's result: one host array per output column, each of kind
    "str" (object array of str), "int" (int64) or "float" (float64; NaN
    stands for NULL)."""

    columns: List[np.ndarray]
    kinds: List[str]


class Data:
    """The generated tables on `device`. TPC-H column names are unique
    across tables, so a column is found by its name alone."""

    def __init__(self, specs: Dict[str, tuple], device):
        self.device = torch.device(device)
        self.cols: Dict[str, torch.Tensor] = {}
        self.pools: Dict[str, np.ndarray] = {}
        for cols, _ in specs.values():
            for name, kind, payload in cols:
                if kind == "string":
                    codes, pool = payload
                    self.pools[name] = np.asarray(pool)
                    payload = codes
                dtype = {"string": np.int32, "int32": np.int32, "float32": np.float32}[kind]
                self.cols[name] = torch.from_numpy(
                    np.ascontiguousarray(payload, dtype=dtype)).to(self.device)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.cols[name]

    # -- strings ----------------------------------------------------------------

    def where_str(self, name: str, predicate: Callable[[np.ndarray], np.ndarray]) -> torch.Tensor:
        """Bool per row of `name`: `predicate` over the column's pool of
        strings, read through each row's code."""
        pool = self.pools[name]
        hit = np.asarray(predicate(pool if pool.dtype.kind == "U" else pool.astype(str)),
                         dtype=bool)
        return torch.from_numpy(hit).to(self.device)[self.cols[name].long()]

    def eq(self, name: str, value: str) -> torch.Tensor:
        return self.where_str(name, lambda p: p == value)

    def isin(self, name: str, values: Sequence[str]) -> torch.Tensor:
        return self.where_str(name, lambda p: np.isin(p, list(values)))

    def like(self, name: str, pattern: str) -> torch.Tensor:
        """`name LIKE pattern` per row, matched over the pool on the device
        (`like_rows`)."""
        pool = np.asarray(self.pools[name], dtype=str)
        width = pool.dtype.itemsize // 4
        chars = torch.from_numpy(np.ascontiguousarray(pool).view(np.int32).reshape(-1, width))
        hit = like_rows(chars.to(self.device), pattern)
        return hit[self.cols[name].long()]

    def cmp(self, name: str, op: str, value: str) -> torch.Tensor:
        """`name <op> 'value'` by string order."""
        fn = {"<": np.less, "<=": np.less_equal, ">": np.greater,
              ">=": np.greater_equal}[op]
        return self.where_str(name, lambda p: fn(p, value))

    def order_codes(self, *names: str) -> None:
        """Check that these columns share one pool in string order, so their
        codes compare as their strings do."""
        pool = self.pools[names[0]]
        assert all(np.array_equal(self.pools[n], pool) for n in names), names
        assert np.all(pool[:-1] < pool[1:]), f"pool of {names[0]} not in order"

    def decode(self, name: str, codes: torch.Tensor) -> np.ndarray:
        """The strings of `codes` of column `name`, as an object array."""
        return self.pools[name][codes.cpu().numpy()].astype(object)

    def substr(self, name: str, start: int, length: int) -> "tuple[torch.Tensor, np.ndarray]":
        """SUBSTR(name, start, length) per row: (code into the result pool,
        the result pool)."""
        parts = np.array([s[start - 1:start - 1 + length] for s in self.pools[name].astype(str)])
        pool, inverse = np.unique(parts, return_inverse=True)
        lut = torch.from_numpy(inverse.astype(np.int64)).to(self.device)
        return lut[self.cols[name].long()], pool


def like_rows(chars: torch.Tensor, pattern: str) -> torch.Tensor:
    """SQL LIKE over strings as rows of code points, 0-padded ([n, width]
    int32): % any run, _ one character. The pattern's parts between %s are
    found leftmost, each after the one before; a part at the pattern's start
    must begin the string and one at its end must end it."""
    n, width = chars.shape
    length = (chars != 0).sum(1)
    parts = pattern.split("%")
    ok = torch.ones(n, dtype=torch.bool, device=chars.device)
    pos = torch.zeros(n, dtype=torch.int64, device=chars.device)
    for i, part in enumerate(parts):
        k = len(part)
        if k == 0:
            if len(parts) == 1:  # the empty pattern: the empty string
                ok &= length == 0
            continue
        if k > width:
            return torch.zeros(n, dtype=torch.bool, device=chars.device)
        at = torch.ones((n, width - k + 1), dtype=torch.bool, device=chars.device)
        for c, ch in enumerate(part):
            window = chars[:, c:c + width - k + 1]
            at &= (window != 0) if ch == "_" else (window == ord(ch))
        first, last = i == 0, i == len(parts) - 1
        if first and last:  # no %: the whole string
            ok &= at[:, 0] & (length == k)
        elif first:
            ok &= at[:, 0]
            pos = torch.full_like(pos, k)
        elif last:
            start = length - k
            ok &= (start >= pos) & at.gather(1, start.clamp(min=0).unsqueeze(1)).squeeze(1)
        else:
            after = at & (torch.arange(width - k + 1, device=chars.device) >= pos.unsqueeze(1))
            found = after.any(1)
            ok &= found
            pos = torch.where(found, after.to(torch.int8).argmax(1), 0) + k
    return ok


# -- keys ------------------------------------------------------------------------


def key_map(keys: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Position of each key value among `keys` (unique where `mask` is
    True): a dense int64 map indexed by the value, -1 where absent."""
    k = keys.long()
    pos = torch.full((int(k.max()) + 2,), -1, dtype=torch.int64, device=keys.device)
    rows = torch.arange(len(k), device=keys.device)
    if mask is not None:
        k, rows = k[mask], rows[mask]
    pos[k] = rows
    return pos


def probe(pos: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Row of each key in `pos` (key_map), -1 where absent or out of range."""
    k = keys.long()
    inside = (k >= 0) & (k < len(pos))
    return torch.where(inside, pos[k.clamp(0, len(pos) - 1)], torch.full_like(k, -1))


def pack(*keys: torch.Tensor) -> torch.Tensor:
    """Several non-negative integer keys as one int64 key, order-preserving."""
    out = torch.zeros_like(keys[0], dtype=torch.int64)
    for k in keys:
        k = k.long()
        width = int(k.max()) + 1 if len(k) else 1
        out = out * width + k
    return out


def group(*keys: torch.Tensor):
    """(inverse, n_groups, first row of each group) of the rows grouped by
    `keys`."""
    packed = pack(*keys)
    uniq, inverse = torch.unique(packed, return_inverse=True)
    n = len(uniq)
    first = torch.full((n,), len(packed), dtype=torch.int64, device=packed.device)
    first.scatter_reduce_(0, inverse, torch.arange(len(packed), device=packed.device),
                          reduce="amin")
    return inverse, n, first


def group_sum(values: torch.Tensor, inverse: torch.Tensor, n: int,
              acc: torch.dtype) -> torch.Tensor:
    return torch.zeros(n, dtype=acc, device=values.device).index_add_(0, inverse, values.to(acc))


def group_count(inverse: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(inverse, minlength=n).to(torch.int64)


def floats(t: torch.Tensor) -> np.ndarray:
    return t.double().cpu().numpy()


def ints(t: torch.Tensor) -> np.ndarray:
    return t.long().cpu().numpy()
