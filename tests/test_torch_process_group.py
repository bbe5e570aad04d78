"""Distribution over a torch.distributed process group on the CPU
(hyrise_tpu_torch/parallel/multihost.py; the exchanges of exchange.py as
gloo collectives).

Four spawned processes join a gloo group through initialize_from_env (a
`file://` rendezvous under the test's tmp_path, so parallel test workers
never share a port; a 60 s timeout on every collective), each holding one
shard of TPC-H at SF 0.01 and of synthetic tables that force shuffles with
a hot key. Their answers (Q1, Q3, Q6, Q18, shuffle joins through the
all_to_all and the ring, dist_q6, the join steps), exchange_stats() and
process_info() must equal the same work on an in-process mesh of 4 CPU
shards. So must the compiled form (DistributedCompiledQuery, uncaptured on
the CPU) of Q1, Q3, Q6, Q18 and the shuffle joins: its exchanges move
fixed-size buffers between the ranks, and its capacities, grown and shrunk
by the largest count of any rank, agree on every rank. Every group has a
deadline: the parent polls its children, kills them all on expiry or as
soon as one fails, and fails the test; a rank that raises must fail the
test well within the deadline, not hang it."""

import datetime
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
SF = 0.01
QIDS = (1, 3, 6, 18)
DEADLINE_S = 150


class GroupFailed(Exception):
    pass


def run_group(target, tmp_path, world=WORLD, deadline=DEADLINE_S):
    """Start `world` spawned ranks of target(rank, world, tmp_path) and wait
    for all of them; kill every rank and raise GroupFailed, with every
    rank's error, when one exits non-zero or the deadline passes."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, str(tmp_path)))
             for rank in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                # every rank's error, not only the failed ranks': a rank whose
                # peer exited can abort before the peer's exit code is seen
                errors = [(tmp_path / f"error{r}.txt") for r in range(world)]
                raise GroupFailed(f"ranks {failed} failed: " + " ".join(
                    e.read_text() for e in errors if e.exists()))
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > end:
                raise GroupFailed(f"deadline of {deadline} s passed; exit codes {codes}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)


def _join_group(rank, world, tmp, timeout_s):
    from hyrise_tpu_torch.parallel.multihost import initialize_from_env

    torch.set_num_threads(1)
    os.environ.update(COORDINATOR=f"file://{tmp}/rendezvous", NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    assert initialize_from_env(device="cpu", timeout=datetime.timedelta(seconds=timeout_s))


def _skew_tables():
    """fact (60,000 rows, half of them on key 7) and dim (70,000 rows, too
    large to broadcast), both sharded by columns that are not the join key."""
    from hyrise_tpu_torch.storage.column import Column
    from hyrise_tpu_torch.storage.table import Table
    from hyrise_tpu_torch.types import DataType

    rng = np.random.default_rng(5)
    k = rng.integers(0, 70_000, 60_000).astype(np.int64)
    k[rng.random(60_000) < 0.5] = 7
    fact = Table([Column.from_numpy("k", DataType.INT64, k, device="cpu"),
                  Column.from_numpy("v", DataType.FLOAT64, rng.normal(size=60_000),
                                    device="cpu")], 60_000, name="fact")
    dim = Table([Column.from_numpy("k", DataType.INT64, np.arange(70_000, dtype=np.int64),
                                   device="cpu"),
                 Column.from_numpy("w", DataType.FLOAT64, rng.normal(size=70_000), device="cpu"),
                 Column.from_numpy("salt", DataType.INT64,
                                   rng.integers(0, 1 << 30, 70_000).astype(np.int64),
                                   device="cpu")], 70_000, name="dim")
    return fact, dim


def _skew_plans(cat):
    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops.aggregate import Aggregate
    from hyrise_tpu_torch.ops.get_table import GetTable
    from hyrise_tpu_torch.ops.join import Join
    from hyrise_tpu_torch.ops.sort import Sort
    from hyrise_tpu_torch.types import JoinMode

    def plan(mode):
        j = Join(GetTable("fact", cat), GetTable("dim", cat), mode, ("k", "k"))
        return Aggregate(j, [], [("s", ast.sum_(ast.col("v"))), ("n", ast.count_())])

    by_key = Sort(Aggregate(Join(GetTable("dim", cat), GetTable("fact", cat), JoinMode.INNER,
                                 ("k", "k")), ["k"], [("n", ast.count_())]), ["k"])
    return {"inner": plan(JoinMode.INNER), "left": plan(JoinMode.LEFT),
            "anti": plan(JoinMode.ANTI), "by_key": by_key}


def compiled(out, name, cq):
    """Two runs of a compiled query: the second's rows, exchange_stats(),
    decisions and retries under "compiled:<name>" keys."""
    cq.run()
    out[f"compiled:{name}"] = cq.run().rows()
    out[f"compiled:stats:{name}"] = cq.exchange_stats()
    out[f"compiled:decisions:{name}"] = cq.join_decisions()
    out[f"compiled:retries:{name}"] = cq.last_retries


def workload(mesh):
    """Everything both meshes run: {name: rows or numbers}, plus
    exchange_stats under "stats:<name>"."""
    from hyrise_tpu_torch.ops.base import execute_plan
    from hyrise_tpu_torch.parallel.dist_compiler import (DistributedCompiledQuery,
                                                         DistributedQuery, shard_tpch)
    from hyrise_tpu_torch.parallel.dist_query import dist_q6
    from hyrise_tpu_torch.parallel.exchange import (dist_join_aggregate_step,
                                                    ring_join_aggregate_step)
    from hyrise_tpu_torch.parallel.partition import hash_partition
    from hyrise_tpu_torch.storage.catalog import Catalog
    from hyrise_tpu_torch.tpch.dbgen import generate_tables
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS

    out = {}
    cat = Catalog(device="cpu")
    for name, t in generate_tables(SF, device="cpu").items():
        cat.add_table(name, t)
    sc = shard_tpch(cat, mesh)
    for qid in QIDS:
        dq = DistributedQuery(TPCH_PLANS[qid](cat), sc)
        out[f"Q{qid}"] = dq.run().rows()
        out[f"stats:Q{qid}"] = dq.exchange_stats()
        compiled(out, f"Q{qid}", DistributedCompiledQuery(TPCH_PLANS[qid](cat), sc))
    fact, dim = _skew_tables()
    cat.add_table("fact", fact)
    cat.add_table("dim", dim)
    sc.add_sharded("fact", fact, "v")
    sc.add_sharded("dim", dim, "salt")
    for exchange in ("all_to_all", "ring"):
        for name, plan in _skew_plans(cat).items():
            dq = DistributedQuery(plan, sc, exchange=exchange)
            out[f"{name}:{exchange}"] = dq.run().rows()
            out[f"stats:{name}:{exchange}"] = dq.exchange_stats()
            out[f"decisions:{name}:{exchange}"] = dq.join_decisions()
        for name, plan in _skew_plans(cat).items():
            compiled(out, f"{name}:{exchange}",
                     DistributedCompiledQuery(plan, sc, exchange=exchange))
    li = sc.get("lineitem")
    code = li.shards[0].column("l_shipdate").code_for
    out["dist_q6"] = float(dist_q6(mesh, li, code("1994-01-01"), code("1995-01-01")))
    # the join steps: lineitem placed by l_partkey, so they shuffle it
    li_pk = hash_partition(cat.get_table("lineitem"), "l_partkey", mesh)
    orders = sc.get("orders")
    args = ([t.column("l_orderkey").data for t in li_pk.shards],
            [t.column("l_extendedprice").data for t in li_pk.shards],
            [t.column("l_discount").data for t in li_pk.shards],
            [torch.ones(t.num_rows, dtype=torch.bool) for t in li_pk.shards],
            [t.column("o_orderkey").data for t in orders.shards],
            [torch.ones(t.num_rows, dtype=torch.bool) for t in orders.shards])
    for name, step in (("step", dist_join_aggregate_step(mesh)),
                       ("step_ring", dist_join_aggregate_step(mesh, exchange="ring")),
                       ("ring_step", ring_join_aggregate_step(mesh))):
        revenue, matches = step(*args)
        out[name] = (float(revenue), int(matches))
    out["single:inner"] = execute_plan(_skew_plans(cat)["inner"]).rows()
    return out


def _rank_main(rank, world, tmp):
    try:
        import torch.distributed as dist
        from hyrise_tpu_torch.parallel.mesh import make_mesh
        from hyrise_tpu_torch.parallel.multihost import process_info

        _join_group(rank, world, tmp, 60)
        mesh = make_mesh(device="cpu")
        assert mesh.n_shards == world and mesh.local_shards == [rank]
        out = workload(mesh)
        out["info"] = process_info()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _rank_raises(rank, world, tmp):
    """Rank 2 raises before the first collective; the others wait in it."""
    try:
        import torch.distributed as dist

        _join_group(rank, world, tmp, 30)
        if rank == 2:
            raise RuntimeError("rank 2 fails on purpose")
        dist.all_reduce(torch.ones(1))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("group")
    run_group(_rank_main, tmp)
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    from hyrise_tpu_torch.parallel.mesh import make_mesh
    return ranks, workload(make_mesh(WORLD, device="cpu"))


def _same(got, want):
    from hyrise_tpu_torch.utils.table_eq import assert_tables_equal
    if isinstance(want, list):
        assert_tables_equal(got, want, ordered=True, rel_tol=1e-6)
    elif isinstance(want, tuple):
        assert got[1] == want[1] and abs(got[0] - want[0]) <= 1e-9 * abs(want[0])
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-9 * abs(want)
    else:
        assert got == want


@pytest.mark.parametrize("name", [f"Q{q}" for q in QIDS])
def test_tpch_over_four_ranks_equals_four_in_process_shards(group_results, name):
    ranks, want = group_results
    for out in ranks:  # every rank returns the whole answer
        _same(out[name], want[name])
        assert out[f"stats:{name}"] == want[f"stats:{name}"]


@pytest.mark.parametrize("exchange", ["all_to_all", "ring"])
@pytest.mark.parametrize("plan", ["inner", "left", "anti", "by_key"])
def test_shuffle_joins_over_four_ranks(group_results, plan, exchange):
    ranks, want = group_results
    key = f"{plan}:{exchange}"
    assert "shuffle" in " ".join(want[f"decisions:{key}"])
    _same(want[key], want[f"{plan}:all_to_all"])
    if plan == "inner":
        _same(want[key], want["single:inner"])
    for out in ranks:
        _same(out[key], want[key])
        assert out[f"decisions:{key}"] == want[f"decisions:{key}"]
        assert out[f"stats:{key}"] == want[f"stats:{key}"]


@pytest.mark.parametrize("name", [f"Q{q}" for q in QIDS]
                         + [f"{p}:{e}" for e in ("all_to_all", "ring")
                            for p in ("inner", "left", "anti", "by_key")])
def test_compiled_over_four_ranks_equals_the_eager_answers(group_results, name):
    """The compiled form over the group equals the eager answers and
    exchange_stats() on every rank, and the compiled form over the
    in-process shards; its second run retries nothing."""
    ranks, want = group_results
    _same(want[f"compiled:{name}"], want[name])
    assert want[f"compiled:stats:{name}"] == want[f"stats:{name}"]
    for out in ranks:
        _same(out[f"compiled:{name}"], want[name])
        assert out[f"compiled:stats:{name}"] == want[f"stats:{name}"]
        assert out[f"compiled:decisions:{name}"] == want[f"compiled:decisions:{name}"]
        assert out[f"compiled:retries:{name}"] == 0


@pytest.mark.parametrize("name", ["dist_q6", "step", "step_ring", "ring_step"])
def test_hand_pipelines_over_four_ranks(group_results, name):
    ranks, want = group_results
    for out in ranks:
        _same(out[name], want[name])
    if name != "dist_q6":
        _same(want[name], want["step"])


def test_initialize_from_env_and_process_info(group_results):
    ranks, _ = group_results
    for rank, out in enumerate(ranks):
        assert out["info"] == {"process_index": rank, "process_count": WORLD,
                               "local_devices": ["cpu"], "global_devices": ["cpu"] * WORLD}


def test_initialize_from_env_without_a_coordinator(monkeypatch):
    from hyrise_tpu_torch.parallel.multihost import initialize_from_env, process_info

    monkeypatch.delenv("COORDINATOR", raising=False)
    assert initialize_from_env(device="cpu") is False
    info = process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1


def test_a_rank_that_raises_fails_the_group_within_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(GroupFailed, match="rank 2 fails on purpose"):
        run_group(_rank_raises, tmp_path, deadline=60)
    assert time.monotonic() - t0 < 60
