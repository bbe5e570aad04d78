from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan  # noqa: F401
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper  # noqa: F401
from hyrise_tpu_torch.ops.table_scan import TableScan  # noqa: F401
from hyrise_tpu_torch.ops.projection import Projection  # noqa: F401
from hyrise_tpu_torch.ops.aggregate import Aggregate  # noqa: F401
from hyrise_tpu_torch.ops.sort import Sort  # noqa: F401
from hyrise_tpu_torch.ops.join import (Join, JoinHash, JoinIndex,  # noqa: F401
                                       JoinMPSM, JoinNestedLoop, JoinSortMerge,
                                       Product)
from hyrise_tpu_torch.ops.index_scan import IndexScan  # noqa: F401
from hyrise_tpu_torch.ops.misc import Alias, Limit, UnionAll  # noqa: F401
from hyrise_tpu_torch.ops.misc import AddRowIds, with_row_ids  # noqa: F401
from hyrise_tpu_torch.ops.rw_ops import Delete, Insert, Update, Validate  # noqa: F401
