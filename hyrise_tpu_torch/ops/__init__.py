from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan  # noqa: F401
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper  # noqa: F401
from hyrise_tpu_torch.ops.table_scan import TableScan  # noqa: F401
from hyrise_tpu_torch.ops.projection import Projection  # noqa: F401
from hyrise_tpu_torch.ops.aggregate import Aggregate  # noqa: F401
from hyrise_tpu_torch.ops.sort import Sort  # noqa: F401
from hyrise_tpu_torch.ops.join import (Join, JoinHash, JoinMPSM,  # noqa: F401
                                       JoinNestedLoop, JoinSortMerge, Product)
from hyrise_tpu_torch.ops.misc import Alias, Limit, UnionAll  # noqa: F401
