"""Benchmark harness (port of ``gpu_radix_sort_tpu/bench``; reference:
benchmark/pkg/benchmark + localTest)."""

from .harness import (  # noqa: F401
    BenchRecord,
    bench_full_sort,
    bench_partial_sort,
    bench_key_value_sort,
    bench_keygen,
    bench_hash_aggregate,
    bench_mesh_lsd,
    bench_mesh_kv_sample,
    bench_mesh_sample,
    bench_storage_distrib,
    device_time,
    report,
    run_benchmarks,
)
