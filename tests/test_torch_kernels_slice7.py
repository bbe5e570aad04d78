"""The contract that the redesigned K8 (lookup_last_eq: a table of 16-byte
slots holding key ^ 0x8000000000000000 and row + 1, cleared by one memset)
and K2 (q6_encoded: one kernel whose last block folds the per-block
partials) must meet, through the wrappers on CPU tensors (their plain
versions) against the JAX package on the same numpy inputs, run on the CPU
in both formulations of tpu_prims (HYRISE_TPU_FASTPATH) where it has two,
and against numpy oracles. Everything here is integers, row ids and flags:
exact equality. The CUDA kernels themselves are held against these plain
versions, in the same shapes, on the card by chip_smoke.py. Also the
Python-side helpers of K8's design: the table's and the filter's sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu.kernels.q6 import q6_encoded_chain_jit
from hyrise_tpu_torch.kernels import hash_lookup, q6

torch.set_num_threads(1)

I64 = np.iinfo(np.int64)
F64 = np.finfo(np.float64)
# int64 keys a hash table can get wrong; INT64_MIN is the one whose stored
# pattern (key ^ 0x8000000000000000) is the empty slot's
INT_EDGES = np.array([I64.min, I64.max, 0, -1, 1, I64.min + 1, I64.max - 1], dtype=np.int64)
# float64: -0.0 has INT64_MIN's bits and equals 0.0; NaN equals nothing
FLOAT_EDGES = np.array([-0.0, 0.0, np.inf, -np.inf, F64.max, -F64.max, 1.5])
EDGE_BITS = 10  # build sizes 2^10 - 1, 2^10, 2^10 + 1


@pytest.fixture(params=["0", "1"], ids=["jax_plain", "jax_fastpath"])
def fastpath(request, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", request.param)
    return request.param


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# -- K8 lookup_last_eq -----------------------------------------------------------------


def _oracle(bk, bvalid, pk):
    """The last valid build row with an equal key, by a dictionary (NaN keys
    never enter it and never hit it: nan != nan)."""
    last = {}
    for j, (k, v) in enumerate(zip(bk.tolist(), bvalid.tolist())):
        if v and k == k:
            last[k] = j
    rows = np.array([last.get(k, -1) for k in pk.tolist()], dtype=np.int64)
    return rows >= 0, np.maximum(rows, 0)


def _lookup(bk, bvalid, pk, jax_build=None):
    """The port's lookup on CPU tensors, held against the numpy oracle and the
    JAX form (given `jax_build`, its build keys and validity, where the
    port's cannot be given to it); checks that no kernel was launched."""
    before = hash_lookup.lookup_last_eq.launches
    matched, row = hash_lookup.lookup_last_eq(_t(bk), _t(bvalid), _t(pk))
    assert hash_lookup.lookup_last_eq.launches == before  # CPU: no kernel
    assert matched.dtype == torch.bool and row.dtype == torch.int64
    om, orow = _oracle(bk, bvalid, pk)
    np.testing.assert_array_equal(matched.numpy(), om)
    np.testing.assert_array_equal(row.numpy(), orow)
    jbk, jvalid = (bk, bvalid) if jax_build is None else jax_build
    jm, jr = tpu_prims.lookup_last_eq(jnp.asarray(jbk), jnp.asarray(jvalid), jnp.asarray(pk))
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jr))
    return matched, row


def _with_edges(rng, nb, edges, dtype):
    keys = rng.integers(-2**40, 2**40, nb).astype(dtype)
    if nb:
        keys[rng.integers(0, nb, 2 * len(edges))] = np.tile(edges, 2)
    probes = np.concatenate([edges, rng.choice(keys, nb) if nb else edges,
                             rng.integers(-2**40, 2**40, nb + 3).astype(dtype)])
    return keys, rng.random(nb) < 0.85, probes


@pytest.mark.parametrize("nb", [1, 2**EDGE_BITS - 1, 2**EDGE_BITS, 2**EDGE_BITS + 1])
@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_lookup_edge_keys_at_power_of_two_build_sizes(nb, kind, fastpath):
    rng = np.random.default_rng(nb * 3 + len(kind))
    edges = INT_EDGES if kind == "int64" else FLOAT_EDGES
    keys, valid, probes = _with_edges(rng, nb, edges, getattr(np, kind))
    matched, row = _lookup(keys, valid, probes)
    assert matched.any() and not matched.all()


@pytest.mark.parametrize("nb", [2**EDGE_BITS - 1, 2**EDGE_BITS, 2**EDGE_BITS + 1])
def test_lookup_distinct_keys_fill_the_table(nb, fastpath):
    """Every build key distinct: the most slots a table of table_slots(nb)
    ever holds."""
    rng = np.random.default_rng(nb)
    keys = rng.permutation(rng.integers(I64.min, I64.max, nb, dtype=np.int64, endpoint=True))
    probes = np.concatenate([rng.choice(keys, nb), keys[::-1] ^ 1, INT_EDGES])
    matched, _ = _lookup(keys, np.ones(nb, dtype=bool), probes)
    assert int(matched.sum()) >= nb


def test_lookup_the_empty_pattern_is_an_ordinary_key(fastpath):
    """INT64_MIN (stored as all-zero bytes, the empty slot) as a key of many
    build rows, some invalid, beside its neighbours."""
    keys = np.array([I64.min, 7, I64.min, I64.min + 1, I64.min, 0], dtype=np.int64)
    valid = np.array([True, True, True, True, False, True])
    probes = np.array([I64.min, 0, I64.min + 1, I64.max, 7, I64.min], dtype=np.int64)
    matched, row = _lookup(keys, valid, probes)
    assert row.tolist() == [2, 5, 3, 0, 1, 2]  # the last VALID INT64_MIN is row 2
    assert matched.tolist() == [True, True, True, False, True, True]


def test_lookup_negative_zero_equals_zero(fastpath):
    """-0.0 has the bits of INT64_MIN; it is the same key as 0.0, and the
    last row of either sign is the one found."""
    keys = np.array([0.0, -0.0, 2.0, -0.0, 0.0])
    valid = np.array([True, True, True, True, False])
    probes = np.array([0.0, -0.0, 2.0, -2.0])
    matched, row = _lookup(keys, valid, probes)
    assert row.tolist() == [3, 3, 2, 0]


def test_lookup_nan_matches_nothing():
    """A NaN build key is never found and a NaN probe key finds nothing, as
    in the JAX package's fast-path form. (Its CPU form matches NaN to NaN, a
    fault of the reference; ROADMAP C8.)"""
    keys = np.array([np.nan, 1.0, np.nan, np.inf, 3.0])
    probes = np.array([np.nan, 1.0, np.inf, 3.0, -np.nan])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYRISE_TPU_FASTPATH", "1")
        matched, row = _lookup(keys, np.ones(5, dtype=bool), probes)
    assert matched.tolist() == [False, True, True, True, False]
    assert row.tolist() == [0, 1, 3, 4, 0]


def test_lookup_subnormal_keys_are_not_zero():
    """5e-324 is a key of its own. (XLA on the CPU flushes it to 0.0, so the
    JAX package finds it for a probe of 0.0; ROADMAP C8. The port, on the
    CPU and on the card, compares it by value.)"""
    keys = np.array([5e-324, 0.0, -5e-324])
    probes = np.array([0.0, 5e-324, -5e-324, -0.0, 1e-320])
    matched, row = hash_lookup.lookup_last_eq(_t(keys), _t(np.ones(3, dtype=bool)),
                                              _t(probes))
    om, orow = _oracle(keys, np.ones(3, dtype=bool), probes)
    np.testing.assert_array_equal(matched.numpy(), om)
    np.testing.assert_array_equal(row.numpy(), orow)
    assert row.tolist() == [1, 0, 2, 1, 0]


@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_lookup_hot_key(kind, fastpath):
    """A third of the build rows on one key, some of them invalid: the last
    valid one is found."""
    rng = np.random.default_rng(33)
    nb = 3000
    keys = rng.integers(-2**40, 2**40, nb)
    keys[rng.random(nb) < 1 / 3] = keys[0]
    keys = keys.astype(getattr(np, kind))
    valid = rng.random(nb) < 0.8
    probes = np.concatenate([keys[:1], rng.choice(keys, 500), rng.integers(-9, 9, 50)
                             .astype(keys.dtype)])
    _, row = _lookup(keys, valid, probes)
    assert row[0] == np.flatnonzero(valid & (keys == keys[0]))[-1]


@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_lookup_no_valid_build_row(kind, fastpath):
    """Every build row invalid, and an empty build side, which the JAX form
    cannot take (ROADMAP C6): it gets the all-invalid side in its place."""
    rng = np.random.default_rng(5)
    edges = INT_EDGES if kind == "int64" else FLOAT_EDGES
    keys, _, probes = _with_edges(rng, 40, edges, getattr(np, kind))
    invalid = np.zeros(40, dtype=bool)
    matched, row = _lookup(keys, invalid, probes)
    assert not matched.any() and not row.any()
    matched, row = _lookup(keys[:0], invalid[:0], probes, jax_build=(keys, invalid))
    assert not matched.any() and not row.any()


def test_lookup_views_one_element_into_their_buffers(fastpath):
    rng = np.random.default_rng(9)
    keys, valid, probes = _with_edges(rng, 2**EDGE_BITS + 2, INT_EDGES, np.int64)
    whole = [_t(a) for a in (keys, valid, probes)]
    got = hash_lookup.lookup_last_eq(*(a[1:] for a in whole))
    want = _oracle(keys[1:], valid[1:], probes[1:])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("nb", [0, 1, 2, 3, 4, 5, 2**10 - 1, 2**10, 2**10 + 1, 1_501_583,
                                2**31 - 1])
def test_table_slots(nb):
    """Even (two 16-byte slots to a sector), more than the build rows (a
    probe sequence always meets an empty slot) and two a row: the load is
    at most a half."""
    slots = hash_lookup.table_slots(nb)
    assert slots % 2 == 0 and slots > nb and slots >= 2
    assert nb / slots <= 1 / 2 and slots <= 2 * nb + 2


@pytest.mark.parametrize("nb", [0, 1, 2, 3, 4, 5, 2**10 - 1, 2**10, 2**10 + 1, 1_501_583,
                                2**31 - 1])
def test_filter_bits(nb):
    """A power of two of at least 32 bits (one 32-bit word) and 8 to 16 bits
    a build row: a key that is not in the table finds its bit clear at least
    7 times in 8."""
    bits = hash_lookup.filter_bits(nb)
    assert bits >= 32 and bits & (bits - 1) == 0
    assert bits >= 8 * nb and (nb < 4 or bits < 16 * nb)


def test_table_and_filter_of_the_timed_shape_fit_the_l2():
    """1,501,583 build rows (chip_smoke.py's timed shape): 16 bytes a slot,
    one slot behind the table, then the filter: inside the card's L2 of
    50 MiB (52,428,800 bytes, as the H100 reports it)."""
    nb = 1_501_583
    assert (hash_lookup.table_slots(nb) + 1) * 16 + hash_lookup.filter_bits(nb) // 8 < 50 * 2**20


# -- K2 q6_encoded ---------------------------------------------------------------------

LO, HI = 731, 1096


def _encoded(n, seed, wrap=False):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2557, n).astype(np.int16),
            rng.integers(0, 11, n).astype(np.int8),
            rng.integers(1, 51, n).astype(np.int8),
            rng.integers(90_000, 2**31 - 1 if wrap else 10_495_000, n).astype(np.int32)]


def _exact(ship, disc, qty, price, lo=LO, hi=HI):
    """The int64 total of the int32 products (two's-complement wrap) of the
    rows that pass."""
    keep = (ship >= lo) & (ship < hi) & (disc >= 5) & (disc <= 7) & (qty < 24)
    prod = price * disc.astype(np.int32)  # numpy wraps int32 arrays silently
    return int(prod[keep].astype(np.int64).sum())


def _jax_total(cols, lo=LO, hi=HI):
    """q6_encoded_chain with k=1 over the columns padded to whole blocks of
    512 rows with dead rows (shipdate code -1), as its callers pad them."""
    pad = (-len(cols[0])) % 512
    padded = [np.concatenate([c, np.full(pad, -1 if i == 0 else 0, dtype=c.dtype)])
              for i, c in enumerate(cols)]
    return int(q6_encoded_chain_jit(*[jnp.asarray(a) for a in padded], jnp.int32(lo),
                                    jnp.int32(hi), jnp.int64(0), jnp.int32(1)))


@pytest.mark.parametrize("n", list(range(1, 18)) + [511, 512, 513, 4095, 4096, 4097, 65_543])
@pytest.mark.parametrize("wrap", [False, True], ids=["no_wrap", "int32_wrap"])
def test_q6_encoded_ragged_lengths_match_jax_and_oracle(n, wrap):
    cols = _encoded(n, seed=n + wrap, wrap=wrap)
    before = q6.q6_encoded.launches
    got = q6.q6_encoded(*_torch_cols(cols), LO, HI)
    assert q6.q6_encoded.launches == before  # CPU: no kernel
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == _exact(*cols) == _jax_total(cols)


def test_q6_encoded_wraps_the_int32_product_as_the_jax_form_does():
    """A price whose product with 7 cents leaves int32: the row adds the
    wrapped (negative) product, in both packages."""
    cols = [np.array([800, 800], dtype=np.int16), np.array([7, 5], dtype=np.int8),
            np.array([1, 1], dtype=np.int8), np.array([400_000_000, 3], dtype=np.int32)]
    want = (400_000_000 * 7 + 2**31) % 2**32 - 2**31 + 15
    assert want == -1_494_967_281
    assert int(q6.q6_encoded(*_torch_cols(cols), LO, HI)) == want == _jax_total(cols)


def test_q6_encoded_views_one_element_into_their_buffers():
    cols = _encoded(4098, seed=4, wrap=True)
    views = [c[1:] for c in _torch_cols(cols)]
    assert int(q6.q6_encoded(*views, LO, HI)) == _exact(*(c[1:] for c in cols))


def _torch_cols(cols):
    return [torch.as_tensor(c) for c in cols]
