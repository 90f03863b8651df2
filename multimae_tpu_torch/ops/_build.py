"""Build the CUDA kernels of csrc/ with nvcc and bind them with ctypes.

The sources are plain CUDA C++ with a C interface (no PyTorch headers),
compiled for Hopper (sm_90a) at first use: one nvcc process per source,
all started together, then one link into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o <source>.o csrc/<source>.cu          (each, in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> *.o

The library is cached under build/kernels/<hash of the sources and the
command>/ in the repository (listed in .gitignore), so an edit to any
source rebuilds it. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None  # set when this process compiled
BUILD_LOG: Optional[Path] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_LLP = ctypes.POINTER(ctypes.c_longlong)

# C signatures (csrc/*.cu); every pointer and the stream are void*.
_SIGNATURES = {
    "mm_fused_block_infer_bf16": [_P, _P, _PP, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P],
    "mm_fused_decoder_fwd_bf16": [_P, _P, _P, _PP, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _P],
    "mm_fused_decoder_fwd_f32": [_P, _P, _P, _PP, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
    "mm_fused_decoder_bwd_bf16": [_P, _P, _P, _P, _P, _PP, _PP, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _P],
    "mm_fused_decoder_bwd_f32": [_P, _P, _P, _P, _P, _PP, _PP, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
    "mm_fused_decoder_bwd_workspace": [_I, _I, _I, _I, _I, _I, _I, _I,
                                       _LLP, _LLP, _LLP],
    "mm_short_attention_fwd_bf16": [_P, _I, _P, _I, _P, _I, _P, _P,
                                    _I, _I, _I, _I, _I, _P],
    "mm_short_attention_bwd_bf16": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _P],
    "mm_short_attention_bwd_workspace": [_I, _I, _I, _LLP],
    "mm_short_attention_fwd_stage_bf16": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "mm_fused_ln_mlp_res_fwd_bf16": [_P, _P, _P, _PP, _P, _P, _I, _I, _I, _P],
    "mm_fused_ln_mlp_res_bwd_bf16": [_P, _P, _P, _PP, _PP, _P, _P, _I, _I, _I, _P],
    "mm_fused_mlp_bwd_workspace": [_I, _I, _I, _I, _LLP, _LLP],
    "mm_fused_mlp_fwd_bf16": [_P, _P, _PP, _P, _I, _I, _I, _P],
    "mm_fused_mlp_bwd_bf16": [_P, _P, _P, _PP, _PP, _P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(cmd_flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(cmd_flags).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path, lib_path: Path) -> str:
    """Compile every source in parallel, link, and return the log."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc] + ARCH_FLAGS + NVCC_FLAGS + ["-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = out_dir / f"lib.{os.getpid()}.so"
    if not failed:
        cmd = [nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)] + [str(o) for _, o, _ in jobs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        (out_dir / "nvcc.log").write_text("".join(log))
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib_path)
    return "".join(log)


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if it is not cached."""
    global _LIB, BUILD_SECONDS, BUILD_LOG
    if _LIB is not None:
        return _LIB
    out_dir = BUILD_ROOT / _digest(ARCH_FLAGS + NVCC_FLAGS)
    lib_path = out_dir / "libmultimae_kernels.so"
    BUILD_LOG = out_dir / "nvcc.log"
    if not lib_path.exists():
        t0 = time.perf_counter()
        log = _build(out_dir, lib_path)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG.write_text(log + f"nvcc seconds: {BUILD_SECONDS:.1f}\n")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mm_error_string.argtypes = [_I]
    lib.mm_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.mm_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def pointer_array(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers, in order."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
