"""Per-layer metrics, one module each, named as in ``BENCHMARK.json``. Each
has ``read(reading: portbench.trace.Reading) -> float | None``: None where it
finds nothing to read, and the harness then leaves the metric out."""
