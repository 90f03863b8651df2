"""Framework-free constants and the JAX-params -> state_dict converter."""
