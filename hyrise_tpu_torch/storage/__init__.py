from hyrise_tpu_torch.storage.column import Column, encode_strings, merge_dictionaries  # noqa: F401
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition  # noqa: F401
from hyrise_tpu_torch.storage.catalog import Catalog  # noqa: F401
