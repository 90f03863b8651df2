"""Test configuration: run JAX on CPU with 8 simulated devices.

Multi-chip sharding tests use an 8-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), per the reference
rebuild test strategy (SURVEY.md §4).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# The env var alone is not enough if a pytest plugin imported jax before
# this conftest ran (the config default is captured at import time).
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: full-width tests, deselected in tier-1 by -m 'not slow'")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels have no CPU mode); "
        "skips without one")


def _torch_available():
    try:
        import torch  # noqa: F401

        return True
    except Exception:
        return False


requires_torch = pytest.mark.skipif(
    not _torch_available(), reason="torch not available for parity tests"
)

REFERENCE_DIR = "/root/reference"


def reference_available():
    return os.path.isdir(os.path.join(REFERENCE_DIR, "multimae"))


requires_reference = pytest.mark.skipif(
    not (reference_available() and _torch_available()),
    reason="reference repo or torch unavailable",
)


def install_reference_import_shim():
    """Make `import multimae.*` from /root/reference work without its heavy
    deps: register a stub `utils` package (same __path__, __init__ NOT
    executed) so `from utils.registry import register_model` resolves to
    the real submodule while skipping utils/__init__.py's torchvision/
    wandb imports."""
    import types

    if REFERENCE_DIR not in sys.path:
        # APPEND, not insert: the reference also has top-level `tools/`
        # which must not shadow ours (repo root stays first).
        sys.path.append(REFERENCE_DIR)
    if "utils" not in sys.modules or not getattr(
        sys.modules["utils"], "__reference_shim__", False
    ):
        pkg = types.ModuleType("utils")
        pkg.__path__ = [os.path.join(REFERENCE_DIR, "utils")]
        pkg.__reference_shim__ = True
        sys.modules["utils"] = pkg
