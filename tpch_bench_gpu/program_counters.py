"""The program's process-wide counters of compiled execution, for the
metric readers: `hyrise_tpu_torch.plan.compiler.compiled_counts()`, or
None where the program has no such function (an older program) or has
captured no graph (CPU tensors)."""

from typing import Dict, Optional


def compiled_counts() -> Optional[Dict[str, int]]:
    try:
        from hyrise_tpu_torch.plan import compiler
    except ImportError:
        return None
    counts = getattr(compiler, "compiled_counts", None)
    if counts is None:
        return None
    counts = counts()
    return counts if counts.get("captures") else None
