"""The benchmark of seaweedfs_tpu_torch's erasure-coding path on one
NVIDIA H100: one cell (configuration x traffic mix) per run, found by
name in BENCHMARK.json.  `python3 -m ecbench.run --help` says how to run
it; README.md says how to add a configuration, a mix or a metric."""
