"""The benchmark of tetraear_tpu_torch: harness, generator and reference
(see benchmark/README.md)."""
