"""The benchmark of centroflye_tpu_torch: see BENCHMARK.json and PERF.md."""
