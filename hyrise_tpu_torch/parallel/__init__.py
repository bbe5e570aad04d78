"""Host-side parallelism of the port: the operator-task scheduler
(scheduler.py). Distribution across cards is not ported yet."""
