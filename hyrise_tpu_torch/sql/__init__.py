from hyrise_tpu_torch.sql.parser import parse_sql  # noqa: F401
from hyrise_tpu_torch.sql.pipeline import SQLPipeline, SQLPipelineBuilder  # noqa: F401
