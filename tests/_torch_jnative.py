"""The JAX package's fastimage library, built privately for the port's tests.

`multimae_tpu/native/__init__.py` compiles `libfastimage.so` with `g++ -o`
straight onto its final path beside the source, and any process that finds
the file newer than the source loads it; a failed load is then cached for
the rest of that process. Test files running at once in several processes
(xdist workers) can therefore load a half-written library and see
`available() == False`. This helper compiles the same source with the JAX
package's own flags through the port's builder, which writes a per-process
temporary and moves it into place with `os.replace`, into a directory of
the caller's, and points the JAX module at that file. The JAX module's own
`_load` then binds it with the JAX package's signatures, and the shared
library beside the source is never read.
"""

from __future__ import annotations

from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JAX_SOURCE = REPO / "multimae_tpu" / "native" / "fastimage.cpp"
# multimae_tpu/native/__init__.py `_build`: the flags and libraries of its g++ line
JAX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
JAX_LIBS = ("-ljpeg", "-lpng16")


def bind_private_jax_fastimage(monkeypatch, build_dir):
    """Build the JAX package's fastimage.cpp into `build_dir` and make
    `multimae_tpu.native` load it, through `monkeypatch` (undone with it).
    Returns the JAX module; raises RuntimeError with g++'s message where the
    library does not build (no g++, libjpeg or libpng) or does not load."""
    from multimae_tpu import native as jnative
    from multimae_tpu_torch import native

    path = native.build(JAX_SOURCE, Path(build_dir), flags=JAX_FLAGS, libs=JAX_LIBS,
                        name="libfastimage.so")
    monkeypatch.setattr(jnative, "_SO", str(path))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    if jnative._load() is None:
        raise RuntimeError(f"{path} was built but does not load")
    return jnative
