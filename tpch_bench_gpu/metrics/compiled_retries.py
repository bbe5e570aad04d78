"""compiled_retries: CompiledQuery.last_retries summed over the window's
requests that ran compiled (capacity overflows that forced a new learning
run and capture); nothing where none ran compiled."""


def read(run):
    compiled = [r for r in run.completed if r.compiled]
    return sum(r.retries for r in compiled) if compiled else None
