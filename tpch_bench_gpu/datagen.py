"""TPC-H data for the benchmark, from one seed.

Numbers, keys and dates follow the rules of the numpy generators of
hyrise_tpu_torch/tpch/dbgen.py (`generate_specs` and what it calls), copied
here and drawn with torch. Text follows clause 4.2.2: a text column's value
is a substring of one 300 MByte text pool of the clause 4.2.2.14 grammar, at
an offset and of a length in [min, max] drawn per row (4.2.2.10); addresses
are random v-strings (4.2.2.7); p_name is five distinct colour words; names,
clerks and phones are per row. So a comment column holds about as many
distinct values as rows, as TPC-H's does. Everything is drawn, and the text
dictionary-encoded, on `device` (the card in a run), then copied to host
arrays.

The yardstick owns its data: the program's generator may change, this one
does not. Both the program under test and the plain reference get the same
host arrays from `generate_specs(scale_factor, seed, device)`; one seed on
one kind of device gives the same arrays.

Column types are the strings "int32", "float32" and "string". A string
column is already dictionary-encoded: (int32 codes, sorted pool of numpy
str), so order-preserving codes compare as the strings do. Dates are
'YYYY-MM-DD' strings whose codes are day offsets from 1992-01-01.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# Single-column primary keys (TPC-H clause 1.4.2).
PRIMARY_KEYS = {"r_regionkey", "n_nationkey", "s_suppkey", "c_custkey",
                "p_partkey", "o_orderkey"}

# ---------------------------------------------------------------------------
# Static pools (TPC-H spec, section 4.2.2 / appendix)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

NATIONS = [  # (name, regionkey) — spec's 25 nations
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]

PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]

SHIP_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]

SHIP_MODE = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

TYPE_SYLL_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYLL_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYLL_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]

CONTAINER_SYLL_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYLL_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

# spec's 92 P_NAME words (colours) — includes green/forest used by Q9/Q20
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green",
    "grey", "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
    "lace", "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
    "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
    "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]

# ---------------------------------------------------------------------------
# The pseudo-text grammar of clause 4.2.2.14, with dbgen's word lists and
# weights (dists.dss). A sentence is one of GRAMMAR's forms; N is a noun
# phrase, V a verb phrase, P a prepositional phrase ("preposition the N"),
# T a terminator, which follows the last word without a space.

TEXT_POOL_BYTES = 300 * 2**20  # clause 4.2.2.10

GRAMMAR = ((("N", "V", "T"), 3), (("N", "V", "P", "T"), 3), (("N", "V", "N", "T"), 3),
           (("N", "P", "V", "N", "T"), 1), (("N", "P", "V", "P", "T"), 1))
NOUN_PHRASES = ((("noun",), 10), (("adjective", "noun"), 20),
                (("adjective,", "adjective", "noun"), 10), (("adverb", "adjective", "noun"), 50))
VERB_PHRASES = ((("verb",), 30), (("auxiliary", "verb"), 1), (("verb", "adverb"), 40),
                (("auxiliary", "verb", "adverb"), 1))


def _weighted(spec: str) -> Tuple[Tuple[str, int], ...]:
    out = []
    for item in spec.split(","):
        word, _, weight = item.strip().rpartition(":")
        out.append((word, int(weight)))
    return tuple(out)


WORDS = {
    "noun": _weighted(
        "packages:40, requests:40, accounts:40, deposits:40, foxes:20, ideas:20, theodolites:20,"
        " pinto beans:20, instructions:20, dependencies:10, excuses:10, platelets:10,"
        " asymptotes:10, courts:5, dolphins:5, multipliers:1, sauternes:1, warthogs:1, frets:1,"
        " dinos:1, attainments:1, somas:1, Tiresias:1, patterns:1, forges:1, braids:1, frays:1,"
        " warhorses:1, dugouts:1, notornis:1, epitaphs:1, pearls:1, tithes:1, waters:1, orbits:1,"
        " gifts:1, sheaves:1, depths:1, sentiments:1, decoys:1, realms:1, pains:1, grouches:1,"
        " escapades:1, hockey players:1"),
    "verb": _weighted(
        "sleep:20, wake:20, are:20, cajole:20, haggle:20, nag:10, use:10, boost:10, affix:5,"
        " detect:5, integrate:5, maintain:1, nod:1, was:1, lose:1, sublate:1, solve:1, thrash:1,"
        " promise:1, engage:1, hinder:1, print:1, x-ray:1, breach:1, eat:1, grow:1, impress:1,"
        " mold:1, poach:1, serve:1, run:1, dazzle:1, snooze:1, doze:1, unwind:1, kindle:1,"
        " play:1, hang:1, believe:1, doubt:1"),
    "adjective": _weighted(
        "special:20, pending:20, unusual:20, express:20, furious:1, sly:1, careful:1, blithe:1,"
        " quick:1, fluffy:1, slow:1, quiet:1, ruthless:1, thin:1, close:1, dogged:1, daring:1,"
        " brave:1, stealthy:1, permanent:1, enticing:1, idle:1, busy:1, regular:50, final:40,"
        " ironic:40, even:30, bold:20, silent:10"),
    "adverb": _weighted(
        "sometimes:1, always:1, never:1, furiously:50, slyly:50, carefully:50, blithely:40,"
        " quickly:30, fluffily:20, slowly:1, quietly:1, ruthlessly:1, thinly:1, closely:1,"
        " doggedly:1, daringly:1, bravely:1, stealthily:1, permanently:1, enticingly:1, idly:1,"
        " busily:1, regularly:1, finally:1, ironically:1, evenly:1, boldly:1, silently:1"),
    "preposition": _weighted(
        "about:50, above:50, according to:50, across:50, after:50, against:40, along:40,"
        " alongside of:30, among:30, around:20, at:10, atop:1, before:1, behind:1, beneath:1,"
        " beside:1, besides:1, between:1, beyond:1, by:1, despite:1, during:1, except:1, for:1,"
        " from:1, in place of:1, inside:1, instead of:1, into:1, near:1, of:1, on:1, outside:1,"
        " over:1, past:1, since:1, through:1, throughout:1, to:1, toward:1, under:1, until:1,"
        " up:1, upon:1, without:1, with:1, within:1"),
    "auxiliary": _weighted(
        "do:1, may:1, might:1, shall:1, will:1, would:1, can:1, could:1, should:1, ought to:1,"
        " must:1, will have to:1, shall have to:1, could have to:1, should have to:1,"
        " must have to:1, need to:1, try to:1"),
    "terminator": (("." , 50), (";", 1), (":", 1), ("?", 1), ("!", 1), ("--", 1)),
}

# random v-strings (clause 4.2.2.7): 64 symbols
V_STRING_SYMBOLS = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ.,"

EPOCH = np.datetime64("1992-01-01")
DATE_END = np.datetime64("1999-01-01")  # exclusive
N_DAYS = int((DATE_END - EPOCH).astype(int))  # 2557
CURRENT_DATE_OFFSET = int((np.datetime64("1995-06-17") - EPOCH).astype(int))

_DATE_POOL: Optional[np.ndarray] = None


def date_pool() -> np.ndarray:
    """All dates 1992-01-01..1998-12-31 as sorted 'YYYY-MM-DD' strings —
    chronological order == lexicographic order, so dictionary codes are day
    offsets from EPOCH."""
    global _DATE_POOL
    if _DATE_POOL is None:
        days = EPOCH + np.arange(N_DAYS)
        _DATE_POOL = days.astype("datetime64[D]").astype(str)
    return _DATE_POOL


# A string column already encoded as (codes into a SORTED pool, pool).
EncodedStr = Tuple[np.ndarray, np.ndarray]
ColSpec = Tuple[str, str, Union[np.ndarray, EncodedStr]]


def _encode_pool(codes: np.ndarray, pool: List[str]) -> EncodedStr:
    """Re-sort an arbitrary pool and remap codes (dictionaries must be
    sorted for order-preserving compares)."""
    arr = np.asarray(pool, dtype=str)
    sorted_pool, inverse = np.unique(arr, return_inverse=True)
    return inverse.astype(np.int32)[codes], sorted_pool


# ---------------------------------------------------------------------------
# Strings as byte matrices on the device: one row a value, NUL-padded to a
# multiple of 8 bytes. NUL sorts before every character, so rows compare as
# their strings do.


def _width(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _byte_table(words: Sequence[str], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bytes [len(words), longest], lengths) of ASCII words."""
    w = max(len(s) for s in words)
    table = np.zeros((len(words), w), dtype=np.uint8)
    for i, s in enumerate(words):
        table[i, :len(s)] = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    return (torch.from_numpy(table).to(device),
            torch.tensor([len(s) for s in words], dtype=torch.int64, device=device))


def _unicode(rows: torch.Tensor) -> np.ndarray:
    """A byte matrix's rows as a numpy str array (UCS4, as wide as the
    longest row)."""
    longest = int((rows != 0).sum(1).max()) if len(rows) else 0
    longest = max(longest, 1)
    ucs4 = rows[:, :longest].to(torch.int32).cpu().numpy()
    return np.ascontiguousarray(ucs4).view(f"<U{longest}").reshape(-1)


def _dictionary_encode(rows: torch.Tensor) -> EncodedStr:
    """(codes, sorted pool of the distinct rows): a stable sort of the rows
    as big-endian 8-byte words, last word first."""
    n, w = rows.shape
    words = torch.zeros((n, w // 8), dtype=torch.int64, device=rows.device)
    for b in range(8):
        words = (words << 8) | rows[:, b::8].to(torch.int64)
    perm = torch.arange(n, device=rows.device)
    for k in reversed(range(w // 8)):
        perm = perm[torch.sort(words[perm, k], stable=True).indices]
    ordered = words[perm]
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    if n > 1:
        first[1:] = (ordered[1:] != ordered[:-1]).any(1)
    del words, ordered
    codes = torch.empty(n, dtype=torch.int32, device=rows.device)
    codes[perm] = (torch.cumsum(first, 0) - 1).to(torch.int32)
    return codes.cpu().numpy(), _unicode(rows[perm[first]])


def _numbered(prefix: str, numbers: torch.Tensor, digits: int) -> torch.Tensor:
    """Rows `prefix` + each number zero-padded to `digits` digits."""
    n = len(numbers)
    rows = torch.zeros((n, _width(len(prefix) + digits)), dtype=torch.uint8,
                       device=numbers.device)
    rows[:, :len(prefix)] = torch.tensor(list(prefix.encode("ascii")), dtype=torch.uint8,
                                         device=numbers.device)
    for d in range(digits):
        place = 10 ** (digits - 1 - d)
        rows[:, len(prefix) + d] = (48 + (numbers // place) % 10).to(torch.uint8)
    return rows


class Source:
    """What one run draws from, on `device`: the clause 4.2.2.10 text pool,
    the per-row strings drawn from it and the tables' numbers, each column
    or table from its own torch.Generator, seeded from the run's numpy
    stream."""

    def __init__(self, rng: np.random.Generator, device, pool_bytes: int):
        self.rng = rng
        self.device = torch.device(device)
        vocab, self.classes = [], {}
        for cls, entries in WORDS.items():
            ids = []
            for word, weight in entries:
                ids += [len(vocab)] * weight
                vocab.append(word if cls == "terminator" else " " + word)
            self.classes[cls] = torch.tensor(ids, device=self.device)
            if cls == "adjective":
                ids = []
                for word, weight in entries:
                    ids += [len(vocab)] * weight
                    vocab.append(" " + word + ",")
                self.classes["adjective,"] = torch.tensor(ids, device=self.device)
        self.the = len(vocab)
        vocab.append(" the")
        self.vocab, self.vocab_len = _byte_table(vocab, self.device)
        self.pool = self._pool(pool_bytes)

    def generator(self) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(self.rng.integers(0, 2**62)))
        return g

    def ints(self, g, lo: int, hi: int, shape) -> torch.Tensor:
        """int64 uniform in [lo, hi), of `shape` (a length or a tuple)."""
        shape = (shape,) if isinstance(shape, int) else shape
        return torch.randint(lo, hi, shape, generator=g, device=self.device)

    def money(self, g, n: int, lo_cents: int, hi_cents: int) -> torch.Tensor:
        """n float32 amounts of whole cents in [lo_cents, hi_cents] / 100."""
        return (self.ints(g, lo_cents, hi_cents + 1, n).to(torch.float64) / 100.0).to(
            torch.float32)

    def _pick(self, g, forms, n: int, realize) -> torch.Tensor:
        """[n, widest form] token ids (-1 pads) of n phrases, each of a form
        drawn by weight; `realize(part, k)` gives a part's [k, width]."""
        weights = torch.tensor([w for _, w in forms], dtype=torch.float64, device=self.device)
        choice = torch.multinomial(weights, n, replacement=True, generator=g) if n else \
            torch.zeros(0, dtype=torch.int64, device=self.device)
        parts = [[realize(p, 1) for p in form] for form, _ in forms]
        width = max(sum(x.shape[1] for x in ps) for ps in parts)
        out = torch.full((n, width), -1, dtype=torch.int64, device=self.device)
        for i, (form, _) in enumerate(forms):
            rows = (choice == i).nonzero().squeeze(1)
            if len(rows):
                block = torch.cat([realize(p, len(rows)) for p in form], 1)
                out[rows, :block.shape[1]] = block
        return out

    def _word(self, g, cls: str, k: int) -> torch.Tensor:
        table = self.classes[cls]
        return table[self.ints(g, 0, len(table), (k, 1))]

    def _phrase(self, g, part: str, k: int) -> torch.Tensor:
        if part == "N":
            return self._pick(g, NOUN_PHRASES, k, lambda c, m: self._word(g, c, m))
        if part == "V":
            return self._pick(g, VERB_PHRASES, k, lambda c, m: self._word(g, c, m))
        if part == "P":
            the = torch.full((k, 1), self.the, dtype=torch.int64, device=self.device)
            return torch.cat([self._word(g, "preposition", k), the, self._phrase(g, "N", k)], 1)
        return self._word(g, "terminator", k)

    def _pool(self, size: int) -> torch.Tensor:
        """`size` bytes of grammar sentences, one after another."""
        g = self.generator()
        tokens, total = [], 0
        while total <= size:
            n = size // 40 + 64
            sentences = self._pick(g, GRAMMAR, n, lambda p, m: self._phrase(g, p, m))
            t = sentences[sentences >= 0]
            tokens.append(t)
            total += int(self.vocab_len[t].sum())
        t = torch.cat(tokens)
        lens = self.vocab_len[t]
        ends = torch.cumsum(lens, 0)
        keep = int(torch.searchsorted(ends, torch.tensor([size + 1], device=self.device))[0]) + 1
        t, lens, ends = t[:keep], lens[:keep], ends[:keep]
        which = torch.repeat_interleave(torch.arange(keep, device=self.device), lens)
        within = torch.arange(len(which), device=self.device) - (ends - lens)[which]
        return self.vocab[t[which], within][1:size + 1]  # the first word's space dropped

    def text(self, n: int, lo: int, hi: int) -> torch.Tensor:
        """n rows of text[lo, hi] (clause 4.2.2.10)."""
        g = self.generator()
        offset = self.ints(g, 0, len(self.pool) - hi + 1, (n,))
        length = self.ints(g, lo, hi + 1, (n,))
        rows = torch.zeros((n, _width(hi)), dtype=torch.uint8, device=self.device)
        for j in range(hi):
            rows[:, j] = torch.where(length > j, self.pool[offset + j], 0)
        return rows

    def v_string(self, n: int, lo: int, hi: int) -> torch.Tensor:
        """n rows of random v-string[lo, hi] (clause 4.2.2.7)."""
        g = self.generator()
        symbols = torch.tensor(list(V_STRING_SYMBOLS.encode("ascii")), dtype=torch.uint8,
                               device=self.device)
        chars = symbols[self.ints(g, 0, len(symbols), (n, hi))]
        length = self.ints(g, lo, hi + 1, (n, 1))
        rows = torch.zeros((n, _width(hi)), dtype=torch.uint8, device=self.device)
        rows[:, :hi] = torch.where(torch.arange(hi, device=self.device) < length, chars, 0)
        return rows

    def part_names(self, n: int) -> torch.Tensor:
        """n rows of five distinct P_NAME words joined by spaces (4.2.3)."""
        g = self.generator()
        ids = self.ints(g, 0, len(P_NAME_WORDS), (n, 5))
        while True:
            s = ids.sort(1).values
            dup = (s[:, 1:] == s[:, :-1]).any(1).nonzero().squeeze(1)
            if not len(dup):
                break
            ids[dup] = self.ints(g, 0, len(P_NAME_WORDS), (len(dup), 5))
        table, lens = _byte_table(P_NAME_WORDS, self.device)
        width = _width(5 * table.shape[1] + 4)
        flat = torch.zeros(n * width, dtype=torch.uint8, device=self.device)
        base = torch.arange(n, device=self.device) * width
        pos = torch.zeros(n, dtype=torch.int64, device=self.device)
        for s in range(5):
            w = ids[:, s]
            for b in range(table.shape[1]):
                inside = lens[w] > b
                flat[(base + pos + b)[inside]] = table[w, b][inside]
            pos = pos + lens[w]
            if s < 4:
                flat[base + pos] = ord(" ")
                pos = pos + 1
        return flat.view(n, width)

    def phones(self, nationkeys: np.ndarray) -> torch.Tensor:
        """'CC-LLL-LLL-LLLL', the country code nationkey + 10 (4.2.2.9)."""
        g = self.generator()
        n = len(nationkeys)
        nk = torch.from_numpy(nationkeys.astype(np.int64)).to(self.device)
        rows = torch.zeros((n, 16), dtype=torch.uint8, device=self.device)
        rows[:, 0] = (48 + (nk + 10) // 10).to(torch.uint8)
        rows[:, 1] = (48 + (nk + 10) % 10).to(torch.uint8)
        col = 2
        for lo, hi, digits in ((100, 1000, 3), (100, 1000, 3), (1000, 10000, 4)):
            rows[:, col] = ord("-")
            v = self.ints(g, lo, hi, (n,))
            for d in range(digits):
                rows[:, col + 1 + d] = (48 + (v // 10 ** (digits - 1 - d)) % 10).to(torch.uint8)
            col += 1 + digits
        return rows

    def plant(self, rows: torch.Tensor, k: int, first: str, second: str,
              avoid: Sequence[int] = ()) -> List[int]:
        """Write `first`, other text, then `second` at a random place into k
        random rows not in `avoid` (4.2.3's Customer ... Complaints); the
        rows chosen."""
        lengths = (rows != 0).sum(1).cpu().numpy()
        free = np.setdiff1d(np.arange(len(rows)), np.asarray(avoid, dtype=np.int64))
        chosen = self.rng.choice(free, size=min(k, len(free)), replace=False)
        need = len(first) + len(second)
        for r in chosen:
            length = int(lengths[r])
            start = int(self.rng.integers(0, length - need + 1))
            gap = int(self.rng.integers(0, length - need - start + 1))
            at = start + len(first) + gap
            rows[r, start:start + len(first)] = torch.tensor(list(first.encode()),
                                                             dtype=torch.uint8)
            rows[r, at:at + len(second)] = torch.tensor(list(second.encode()), dtype=torch.uint8)
        return [int(r) for r in chosen]


def _numbered_pool(src: Source, prefix: str, n: int) -> EncodedStr:
    """Codes 0..n-1 into '<prefix>000000001' ..., already in order."""
    numbers = torch.arange(1, n + 1, device=src.device)
    return np.arange(n, dtype=np.int32), _unicode(_numbered(prefix, numbers, 9))


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.cpu().numpy().astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# table constructors


def gen_region(src: Source) -> List[ColSpec]:
    return [
        ("r_regionkey", "int32", np.arange(5, dtype=np.int32)),
        ("r_name", "string", _encode_pool(np.arange(5), REGIONS)),
        ("r_comment", "string", _dictionary_encode(src.text(5, 31, 115))),
    ], 5


def gen_nation(src: Source) -> List[ColSpec]:
    names = [n for n, _ in NATIONS]
    region = np.array([r for _, r in NATIONS], dtype=np.int32)
    return [
        ("n_nationkey", "int32", np.arange(25, dtype=np.int32)),
        ("n_name", "string", _encode_pool(np.arange(25), names)),
        ("n_regionkey", "int32", region),
        ("n_comment", "string", _dictionary_encode(src.text(25, 31, 114))),
    ], 25


def gen_supplier(src: Source, sf: float) -> Tuple[List[ColSpec], int]:
    S = max(int(10000 * sf), 1)
    g = src.generator()
    nationkey = _host(src.ints(g, 0, 25, S), np.int32)
    acctbal = _host(src.money(g, S, -99999, 999999), np.float32)
    # SF * 5 rows hold Customer ... Complaints, SF * 5 others Customer ...
    # Recommends (4.2.3; Q16 reads the first)
    comments = src.text(S, 25, 100)
    k = max(int(5 * sf), 1)
    complaints = src.plant(comments, k, "Customer", "Complaints")
    src.plant(comments, k, "Customer", "Recommends", avoid=complaints)
    return [
        ("s_suppkey", "int32", np.arange(1, S + 1, dtype=np.int32)),
        ("s_name", "string", _numbered_pool(src, "Supplier#", S)),
        ("s_address", "string", _dictionary_encode(src.v_string(S, 10, 40))),
        ("s_nationkey", "int32", nationkey),
        ("s_phone", "string", _dictionary_encode(src.phones(nationkey))),
        ("s_acctbal", "float32", acctbal),
        ("s_comment", "string", _dictionary_encode(comments)),
    ], S


def gen_customer(src: Source, sf: float) -> Tuple[List[ColSpec], int]:
    C = max(int(150000 * sf), 3)
    g = src.generator()
    nationkey = _host(src.ints(g, 0, 25, C), np.int32)
    seg_codes = _host(src.ints(g, 0, 5, C), np.int32)
    acctbal = _host(src.money(g, C, -99999, 999999), np.float32)
    return [
        ("c_custkey", "int32", np.arange(1, C + 1, dtype=np.int32)),
        ("c_name", "string", _numbered_pool(src, "Customer#", C)),
        ("c_address", "string", _dictionary_encode(src.v_string(C, 10, 40))),
        ("c_nationkey", "int32", nationkey),
        ("c_phone", "string", _dictionary_encode(src.phones(nationkey))),
        ("c_acctbal", "float32", acctbal),
        ("c_mktsegment", "string", _encode_pool(seg_codes, SEGMENTS)),
        ("c_comment", "string", _dictionary_encode(src.text(C, 29, 116))),
    ], C


def gen_part(src: Source, sf: float) -> Tuple[List[ColSpec], int, torch.Tensor]:
    P = max(int(200000 * sf), 8)
    g = src.generator()
    partkey = torch.arange(1, P + 1, device=src.device)
    mfgr = src.ints(g, 1, 6, P)
    brand_codes = (mfgr - 1) * 5 + src.ints(g, 0, 5, P)
    mfgr_pool = [f"Manufacturer#{i}" for i in range(1, 6)]
    brand_pool = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
    type_pool = [f"{a} {b} {c}" for a in TYPE_SYLL_1 for b in TYPE_SYLL_2
                 for c in TYPE_SYLL_3]
    type_codes = _host(src.ints(g, 0, len(type_pool), P), np.int32)
    cont_pool = [f"{a} {b}" for a in CONTAINER_SYLL_1 for b in CONTAINER_SYLL_2]
    cont_codes = _host(src.ints(g, 0, len(cont_pool), P), np.int32)
    size = _host(src.ints(g, 1, 51, P), np.int32)
    retail = ((90000 + ((partkey // 10) % 20001) + 100 * (partkey % 1000)).to(torch.float64)
              / 100.0).to(torch.float32)
    specs = [
        ("p_partkey", "int32", _host(partkey, np.int32)),
        ("p_name", "string", _dictionary_encode(src.part_names(P))),
        ("p_mfgr", "string", _encode_pool(_host(mfgr - 1, np.int64), mfgr_pool)),
        ("p_brand", "string", _encode_pool(_host(brand_codes, np.int64), brand_pool)),
        ("p_type", "string", _encode_pool(type_codes, type_pool)),
        ("p_size", "int32", size),
        ("p_container", "string", _encode_pool(cont_codes, cont_pool)),
        ("p_retailprice", "float32", _host(retail, np.float32)),
        ("p_comment", "string", _dictionary_encode(src.text(P, 5, 22))),
    ]
    return specs, P, retail


def _ps_suppkey(partkey: torch.Tensor, i: torch.Tensor, S: int) -> torch.Tensor:
    """Spec 4.2.3 partsupp supplier formula."""
    return ((partkey + i * (S // 4 + (partkey - 1) // S)) % S) + 1


def gen_partsupp(src: Source, P: int, S: int) -> Tuple[List[ColSpec], int]:
    n = P * 4
    g = src.generator()
    partkey = torch.arange(1, P + 1, device=src.device).repeat_interleave(4)
    i = torch.arange(4, device=src.device).repeat(P)
    return [
        ("ps_partkey", "int32", _host(partkey, np.int32)),
        ("ps_suppkey", "int32", _host(_ps_suppkey(partkey, i, S), np.int32)),
        ("ps_availqty", "int32", _host(src.ints(g, 1, 10000, n), np.int32)),
        ("ps_supplycost", "float32", _host(src.money(g, n, 100, 100000), np.float32)),
        ("ps_comment", "string", _dictionary_encode(src.text(n, 49, 198))),
    ], n


def gen_orders_lineitem(src: Source, sf: float, C: int, P: int, S: int,
                        part_retail: torch.Tensor):
    O = max(int(1500000 * sf), 10)
    g = src.generator()
    dev = src.device
    idx = torch.arange(O, device=dev)
    orderkey = (idx // 8) * 32 + idx % 8 + 1  # sparse keys
    # custkeys never divisible by 3 (spec: one third of customers have no
    # orders — the basis of Q13/Q22)
    j = src.ints(g, 0, C - C // 3, O)
    custkey = 3 * (j // 2) + 1 + (j % 2)
    orderdate_off = src.ints(g, 0, N_DAYS - 151, O)

    # lineitems: 1..7 per order
    counts = src.ints(g, 1, 8, O)
    l_order_row = torch.repeat_interleave(idx, counts)
    L = len(l_order_row)
    offsets = torch.cumsum(counts, 0) - counts
    l_linenumber = torch.arange(L, device=dev) - offsets[l_order_row] + 1
    l_partkey = src.ints(g, 1, P + 1, L)
    l_suppkey = _ps_suppkey(l_partkey, src.ints(g, 0, 4, L), S)
    qty = src.ints(g, 1, 51, L)
    eprice = qty.to(torch.float32) * part_retail[l_partkey - 1]
    discount = (src.ints(g, 0, 11, L).to(torch.float64) / 100.0).to(torch.float32)
    tax = (src.ints(g, 0, 9, L).to(torch.float64) / 100.0).to(torch.float32)

    o_date_l = orderdate_off[l_order_row]
    shipdate = o_date_l + src.ints(g, 1, 122, L)
    commitdate = o_date_l + src.ints(g, 30, 91, L)
    receiptdate = shipdate + src.ints(g, 1, 31, L)
    shipdate = shipdate.clamp(max=N_DAYS - 1)
    commitdate = commitdate.clamp(max=N_DAYS - 1)
    receiptdate = receiptdate.clamp(max=N_DAYS - 1)

    returned = receiptdate <= CURRENT_DATE_OFFSET
    rf_draw = torch.rand(L, generator=g, device=dev) < 0.5
    returnflag_code = torch.where(returned, torch.where(rf_draw, 2, 0), 1)  # R/A/N
    rf_pool = np.array(["A", "N", "R"])
    linestatus_is_o = shipdate > CURRENT_DATE_OFFSET
    ls_pool = np.array(["F", "O"])

    # order status: F if all F, O if all O, else P
    o_ls_sum = torch.zeros(O, dtype=torch.int64, device=dev).index_add_(
        0, l_order_row, linestatus_is_o.to(torch.int64))
    o_status_code = torch.where(o_ls_sum == 0, 0, torch.where(o_ls_sum == counts, 1, 2))
    status_pool = np.array(["F", "O", "P"])

    # o_totalprice = sum(eprice*(1+tax)*(1-discount)), each order's lines
    # summed in line order (a [orders, 7] matrix: the same bits every run)
    line_total = eprice.to(torch.float64) * (1 + tax) * (1 - discount)
    lines = torch.zeros((O, 7), dtype=torch.float64, device=dev)
    lines[l_order_row, l_linenumber - 1] = line_total
    o_totalprice = lines.sum(1).to(torch.float32)
    del lines, line_total

    clerk_n = max(int(1000 * sf), 1)
    _, clerk_pool = _numbered_pool(src, "Clerk#", clerk_n)
    clerk_codes = src.ints(g, 0, clerk_n, O)
    priority_codes = _host(src.ints(g, 0, 5, O), np.int64)
    si_codes = _host(src.ints(g, 0, len(SHIP_INSTRUCT), L), np.int64)
    sm_codes = _host(src.ints(g, 0, len(SHIP_MODE), L), np.int64)

    i32 = np.int32
    dp = date_pool()
    orders_specs = [
        ("o_orderkey", "int32", _host(orderkey, i32)),
        ("o_custkey", "int32", _host(custkey, i32)),
        ("o_orderstatus", "string", (_host(o_status_code, i32), status_pool)),
        ("o_totalprice", "float32", _host(o_totalprice, np.float32)),
        ("o_orderdate", "string", (_host(orderdate_off, i32), dp)),
        ("o_orderpriority", "string", _encode_pool(priority_codes, PRIORITIES)),
        ("o_clerk", "string", (_host(clerk_codes, i32), clerk_pool)),
        ("o_shippriority", "int32", np.zeros(O, dtype=i32)),
        ("o_comment", "string", _dictionary_encode(src.text(O, 19, 78))),
    ]
    lineitem_specs = [
        ("l_orderkey", "int32", _host(orderkey[l_order_row], i32)),
        ("l_partkey", "int32", _host(l_partkey, i32)),
        ("l_suppkey", "int32", _host(l_suppkey, i32)),
        ("l_linenumber", "int32", _host(l_linenumber, i32)),
        ("l_quantity", "float32", _host(qty.to(torch.float32), np.float32)),
        ("l_extendedprice", "float32", _host(eprice, np.float32)),
        ("l_discount", "float32", _host(discount, np.float32)),
        ("l_tax", "float32", _host(tax, np.float32)),
        ("l_returnflag", "string", (_host(returnflag_code, i32), rf_pool)),
        ("l_linestatus", "string", (_host(linestatus_is_o, i32), ls_pool)),
        ("l_shipdate", "string", (_host(shipdate, i32), dp)),
        ("l_commitdate", "string", (_host(commitdate, i32), dp)),
        ("l_receiptdate", "string", (_host(receiptdate, i32), dp)),
        ("l_shipinstruct", "string", _encode_pool(si_codes, SHIP_INSTRUCT)),
        ("l_shipmode", "string", _encode_pool(sm_codes, SHIP_MODE)),
        ("l_comment", "string", _dictionary_encode(src.text(L, 10, 43))),
    ]
    return orders_specs, O, lineitem_specs, L


def generate_specs(scale_factor: float, seed: int, device="cpu"
                   ) -> Dict[str, Tuple[List[ColSpec], int]]:
    """All 8 TPC-H tables as host numpy column specs and row counts, drawn
    on `device` by generators seeded from one np.random.default_rng(seed)
    stream (any non-negative integer seed, beyond 32 bits too). The text
    pool is the spec's 300 MBytes from SF1 up and shrinks with the scale
    factor below it (at least 1 MiB), for tests."""
    rng = np.random.default_rng(seed)
    src = Source(rng, device, max(2**20, int(TEXT_POOL_BYTES * min(1.0, scale_factor))))
    out: Dict[str, Tuple[List[ColSpec], int]] = {}
    out["region"] = gen_region(src)
    out["nation"] = gen_nation(src)
    specs, S = gen_supplier(src, scale_factor)
    out["supplier"] = (specs, S)
    specs, C = gen_customer(src, scale_factor)
    out["customer"] = (specs, C)
    specs, P, retail = gen_part(src, scale_factor)
    out["part"] = (specs, P)
    out["partsupp"] = gen_partsupp(src, P, S)
    o_specs, O, l_specs, L = gen_orders_lineitem(src, scale_factor, C, P, S, retail)
    out["orders"] = (o_specs, O)
    out["lineitem"] = (l_specs, L)
    del src, retail
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out
