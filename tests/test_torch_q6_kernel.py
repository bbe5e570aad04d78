"""The Q6 scans of the port (hyrise_tpu_torch/kernels/q6.py) against the
JAX package's: the plain torch versions and the kernel wrappers on CPU
tensors (which take the plain versions), with the Pallas kernel run in
interpret mode as tests/test_pallas.py runs it. The CUDA kernels themselves
are compared with these plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyrise_tpu.kernels.pallas_scan import TILE_ROWS, q6_pallas
from hyrise_tpu.kernels.q6 import q6_compute as jax_q6_compute
from hyrise_tpu.kernels.q6 import q6_encoded_chain_jit
from hyrise_tpu_torch.kernels import q6

torch.set_num_threads(1)

LO, HI = 731, 1096


def _dense(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        ship=rng.integers(0, 2557, n).astype(np.int32),
        disc=(rng.integers(0, 11, n) / 100).astype(np.float32),
        qty=rng.integers(1, 51, n).astype(np.float32),
        price=(rng.random(n) * 1e5).astype(np.float32),
        live=np.arange(n) < n - 100)


def _encoded(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        ship=rng.integers(0, 2557, n).astype(np.int16),
        disc_cents=rng.integers(0, 11, n).astype(np.int8),
        qty=rng.integers(1, 51, n).astype(np.int8),
        price_cents=rng.integers(90_000, 10_495_000, n).astype(np.int32))


def _order(d):
    return [d[k] for k in ("ship", "disc", "qty", "price", "live")]


def _torch(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


def test_q6_compute_matches_pallas_interpret():
    cols = _order(_dense(2 * TILE_ROWS, seed=0))
    want = float(q6_pallas(*[jnp.asarray(a) for a in cols], jnp.int32(LO),
                           jnp.int32(HI), interpret=True))
    got = float(q6.q6_compute(*_torch(cols), LO, HI))
    assert _rel(got, want) < 1e-5  # the bound of tests/test_pallas.py


@pytest.mark.parametrize("n", [0, 1, 1000, 65_543, 200_003])
def test_q6_scan_on_cpu_matches_jax_q6_compute(n):
    cols = _order(_dense(n, seed=n))
    want = float(jax_q6_compute(*[jnp.asarray(a) for a in cols], jnp.int32(LO),
                                jnp.int32(HI)))
    before = q6.q6_scan.launches
    got = q6.q6_scan(*_torch(cols), LO, HI)
    assert got.dtype == torch.float64
    assert _rel(float(got), want) < 1e-5
    assert _rel(float(q6.q6_compute(*_torch(cols), LO, HI)), want) < 1e-5
    assert q6.q6_scan.launches == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("n", [512, 4096, 65_536])
def test_q6_encoded_matches_jax_and_int64_oracle(n):
    e = _encoded(n, seed=n)
    args = [e[k] for k in ("ship", "disc_cents", "qty", "price_cents")]
    m = ((e["ship"] >= LO) & (e["ship"] < HI) & (e["disc_cents"] >= 5)
         & (e["disc_cents"] <= 7) & (e["qty"] < 24))
    exact = int((e["price_cents"][m].astype(np.int64) * e["disc_cents"][m]).sum())
    jax_total = int(q6_encoded_chain_jit(*[jnp.asarray(a) for a in args],
                                         jnp.int32(LO), jnp.int32(HI),
                                         jnp.int64(0), jnp.int32(1)))
    before = q6.q6_encoded.launches
    got = q6.q6_encoded(*_torch(args), LO, HI)
    assert got.dtype == torch.int64
    assert int(got) == exact == jax_total
    assert int(q6.q6_encoded_reference(*_torch(args), LO, HI)) == exact
    assert q6.q6_encoded.launches == before


def test_q6_encoded_ragged_length_matches_oracle():
    e = _encoded(1001, seed=5)
    args = _torch([e[k] for k in ("ship", "disc_cents", "qty", "price_cents")])
    m = ((e["ship"] >= LO) & (e["ship"] < HI) & (e["disc_cents"] >= 5)
         & (e["disc_cents"] <= 7) & (e["qty"] < 24))
    exact = int((e["price_cents"][m].astype(np.int64) * e["disc_cents"][m]).sum())
    assert int(q6.q6_encoded(*args, LO, HI)) == exact


def test_wrappers_reject_what_the_kernels_do_not_take():
    cols = _torch(_order(_dense(16, seed=1)))
    with pytest.raises(TypeError):
        q6.q6_scan(cols[0].to(torch.int64), *cols[1:], LO, HI)
    with pytest.raises(ValueError):
        q6.q6_scan(cols[0][:8], *cols[1:], LO, HI)
    with pytest.raises(ValueError):
        q6.q6_scan(*[c.to("meta") for c in cols], LO, HI)
    with pytest.raises(ValueError):
        q6.q6_scan(*cols, LO, 2**31)
    enc = _torch([_encoded(16, seed=2)[k] for k in ("ship", "disc_cents", "qty", "price_cents")])
    with pytest.raises(ValueError):
        q6.q6_encoded(*enc, LO, 40_000)
    with pytest.raises(ValueError):
        q6.q6_encoded(enc[0][::2].contiguous(), *[c[::2] for c in enc[1:]], LO, HI)
