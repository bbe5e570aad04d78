"""Maintenance tasks.

Port of hyrise_tpu/tasks.py (reference: src/lib/tasks/
chunk_compression_task.{hpp,cpp}, which re-encodes a chunk once it is
full). Tables have no chunks, so the unit is the column: an Insert writes
an encoded column out dense (ops/rw_ops.append_rows), and this task encodes
exactly those columns again, to the spec the table remembers.
"""

from __future__ import annotations

from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.encoding import ChunkEncoder, EncodingType
from hyrise_tpu_torch.storage.table import Table


class ChunkCompressionTask:
    """Re-encode the dense columns of a table to its at-rest spec.

        task = ChunkCompressionTask("lineitem", catalog)
        task.run()                              # on the caller, or
        JobTask(task.run).schedule().join()     # through the scheduler
                                                # (parallel/scheduler.py),
                                                # like the reference's task queue

    The spec defaults to the one ChunkEncoder.encode_table remembered on
    the table (`encoding_spec`); a table never encoded is left as it is.
    The new table replaces the old one in the catalog and shares its MVCC
    state. Encodings are lossless, so query results do not change."""

    def __init__(self, table_name: str, catalog: Catalog, spec=None):
        self.table_name = table_name
        self.catalog = catalog
        self.spec = spec

    def run(self) -> Table:
        table = self.catalog.get_table(self.table_name)
        spec = self.spec if self.spec is not None else table.encoding_spec
        if spec is None:
            return table
        todo = {}
        for c in table.columns:
            want = spec.get(c.name) if isinstance(spec, dict) else spec
            if want in (None, EncodingType.UNENCODED) or c.encoded is not None or \
                    (want is EncodingType.FRAME_OF_REFERENCE and c.dtype.is_floating):
                continue  # not meant to be encoded, or still encoded
            todo[c.name] = want
        if not todo:
            return table
        out = ChunkEncoder.encode_table(table, todo)
        out.encoding_spec = spec
        self.catalog.replace_table(self.table_name, out)
        return out
