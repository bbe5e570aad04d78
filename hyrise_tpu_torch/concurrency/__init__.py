from hyrise_tpu_torch.concurrency.transaction import (  # noqa: F401
    INVALID_TID, MAX_COMMIT_ID, MvccData, TransactionConflict, TransactionContext,
    TransactionManager, TransactionPhase)
