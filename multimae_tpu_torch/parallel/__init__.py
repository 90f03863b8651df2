"""Process groups for data parallelism."""
