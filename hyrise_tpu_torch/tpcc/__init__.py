from hyrise_tpu_torch.tpcc.generator import generate_tpcc_tables  # noqa: F401
