from hyrise_tpu_torch.tpch.dbgen import generate_tables  # noqa: F401
