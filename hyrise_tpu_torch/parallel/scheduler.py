"""Operator DAG scheduler.

Port of hyrise_tpu/parallel/scheduler.py (reference: src/lib/scheduler/ —
AbstractTask with predecessor/successor edges, ready when its pending
predecessors reach 0, abstract_task.hpp:36-146; OperatorTask wrapping one
operator, operator_task.cpp:25-58, whose make_tasks_from_operator walks the
DAG in post-order; NodeQueueScheduler's worker threads,
node_queue_scheduler.cpp:30-122; CurrentScheduler with its
execute-immediately fallback, current_scheduler.hpp:19-80).

Workers are host threads. They overlap the host work of independent plan
branches (expression compilation, host reads, launches); their device work
goes, in the order they enqueue it, onto the current stream of the
operators' device, which is the same default stream for every thread: the
scheduler adds no side stream. Each operator waits for the device at its
end (ops/base.py), so a successor starts after its inputs are on the card.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.storage.table import Table


class OperatorTask:
    """Reference: scheduler/operator_task.hpp — one task per operator."""

    def __init__(self, op: AbstractOperator):
        self.op = op
        self.predecessors: List["OperatorTask"] = []
        self.successors: List["OperatorTask"] = []
        self._undrained = 0  # successors that still need our output

    def mark_drained_by(self, successor: "OperatorTask") -> None:
        """Reference: operator_task.cpp:100-117 — once every successor has
        executed, the cached output Table is dropped, so long chains do not
        hold every intermediate in device memory. Leaf fetches
        (GetTable/TableWrapper) reference catalog-owned tables; clearing
        them releases nothing.

        The freed tensors go back to torch's caching allocator, which hands
        their blocks out again in the order of the stream they were used
        on. Every worker launches on the one default stream, so work
        enqueued later, which may reuse a block, runs after every kernel
        that read it. That holds only while no side stream is added: a
        tensor used on another stream would need record_stream first."""
        self._undrained -= 1
        if self._undrained == 0:
            self.op.clear_output()

    def set_as_predecessor_of(self, other: "OperatorTask") -> None:
        self.successors.append(other)
        other.predecessors.append(self)

    @staticmethod
    def make_tasks_from_operator(root: AbstractOperator) -> List["OperatorTask"]:
        """Post-order DAG walk; shared sub-operators become one task
        (reference: operator_task.cpp:25-58)."""
        tasks: Dict[int, OperatorTask] = {}
        order: List[OperatorTask] = []

        def walk(op: AbstractOperator) -> OperatorTask:
            if id(op) in tasks:
                return tasks[id(op)]
            t = OperatorTask(op)
            tasks[id(op)] = t
            for i in op.inputs:
                walk(i).set_as_predecessor_of(t)
            order.append(t)
            return t

        walk(root)
        for t in order:
            t._undrained = len(t.successors)
        return order


class JobTask:
    """Reference: scheduler/job_task.hpp — a schedulable function, for work
    that is not an operator DAG (tasks.ChunkCompressionTask). schedule()
    runs it on the current scheduler's job pool when that is a
    PoolScheduler, else at once on the caller; join() waits and returns its
    result or raises its exception."""

    def __init__(self, fn):
        self.fn = fn
        self._future: Optional[Future] = None
        self._result = None
        self._ran = False

    def schedule(self) -> "JobTask":
        sched = current_scheduler()
        if isinstance(sched, PoolScheduler):
            self._future = sched.job_pool().submit(self.fn)
        else:
            self._result = self.fn()
            self._ran = True
        return self

    def join(self):
        if self._future is not None:
            return self._future.result()
        if not self._ran:
            raise RuntimeError("join() before schedule()")
        return self._result


class ImmediateScheduler:
    """Single-threaded fallback (reference: AbstractTask::schedule() with no
    scheduler set executes on the caller)."""

    def schedule_and_wait(self, tasks: List[OperatorTask], context=None,
                          drain: bool = True) -> None:
        for t in tasks:  # already topologically ordered (post-order)
            t.op.execute(context)
            if drain:
                for p in t.predecessors:
                    p.mark_drained_by(t)


class PoolScheduler:
    """Thread-pool DAG scheduler (reference: NodeQueueScheduler). Tasks run
    as soon as all their predecessors have finished; independent branches
    overlap. The first error stops the scheduling of further tasks and is
    raised to the caller once the tasks already running have ended."""

    def __init__(self, workers: int = 4):
        self.workers = workers
        self._job_pool: Optional[ThreadPoolExecutor] = None
        self._job_pool_lock = threading.Lock()

    def job_pool(self) -> ThreadPoolExecutor:
        """The pool JobTasks run on, made on first use."""
        with self._job_pool_lock:
            if self._job_pool is None:
                self._job_pool = ThreadPoolExecutor(max_workers=self.workers)
            return self._job_pool

    def schedule_and_wait(self, tasks: List[OperatorTask], context=None,
                          drain: bool = True) -> None:
        pending = {id(t): len(t.predecessors) for t in tasks}
        lock = threading.Lock()
        done = threading.Event()
        remaining = [len(tasks)]
        errors: List[BaseException] = []

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            def run(task: OperatorTask):
                try:
                    task.op.execute(context)
                except BaseException as e:  # raised to the caller below
                    with lock:
                        errors.append(e)
                        done.set()
                    return
                ready = []
                with lock:
                    if drain:
                        for p in task.predecessors:
                            p.mark_drained_by(task)
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        done.set()
                    for s in task.successors:
                        pending[id(s)] -= 1
                        if pending[id(s)] == 0:
                            ready.append(s)
                    if errors:
                        return  # the pool is closing: schedule nothing more
                    for s in ready:
                        pool.submit(run, s)

            roots = [t for t in tasks if not t.predecessors]
            if not roots:
                return
            for r in roots:
                pool.submit(run, r)
            done.wait()
        if errors:
            raise errors[0]


_current: Optional[object] = None


def set_scheduler(s) -> None:
    """Reference: CurrentScheduler::set()."""
    global _current
    _current = s


def current_scheduler():
    return _current if _current is not None else ImmediateScheduler()


def schedule_plan(root: AbstractOperator, context=None,
                  drain: bool = True) -> Table:
    """Execute a plan through the current scheduler. With `drain` (the
    default, as the reference's OperatorTask does), every intermediate
    output is released once its last consumer has executed; only the
    root's result survives."""
    tasks = OperatorTask.make_tasks_from_operator(root)
    current_scheduler().schedule_and_wait(tasks, context, drain=drain)
    return root.get_output()
