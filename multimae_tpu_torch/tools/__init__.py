"""Benchmarks, the step profiler and the checkpoint converters of the
port (counterparts of the JAX package's repo-root tools/)."""
