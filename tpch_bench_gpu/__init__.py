"""A benchmark of hyrise_tpu_torch on one NVIDIA H100: TPC-H through the SQL
pipeline, driven by closed-loop query streams, every answer checked against
a plain reference. `python3 -m tpch_bench_gpu.run --help`."""
