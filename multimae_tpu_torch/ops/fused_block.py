"""Fused pre-LN ViT encoder block for inference (kernel K4).

Counterpart of multimae_tpu/ops/fused_block_pallas.py `fused_block_infer`:
LN1 -> qkv -> multi-head attention (fp32 softmax) -> proj + residual ->
LN2 -> fc1 -> GELU -> fc2 + residual, forward only (no backward, as on
the TPU). On a CUDA tensor the wrapper launches the hand-written kernel
chain of csrc/fused_block_infer.cu; on a CPU tensor it runs the plain
twin `block_infer_ref`. There is no other path: a CUDA tensor the kernel
does not take raises. `supported` is the gate the ViT block consults
before it calls this op; the shapes it refuses take the module path.
Sequences whose K/V rows do not fit in shared memory (the 512-px
fine-tune's 2049 tokens) take the K2 forward kernel for the attention
step, inside the same chain.

Numerics of the kernel and its twin: fp32 two-pass LayerNorm statistics
(the Pallas kernel uses the fast variance E[x^2]-E[x]^2), GEMMs with
fp32 accumulation rounded to the compute dtype before the bias is added
in that dtype, exact-erf GELU (the Pallas kernel's is the tanh-basis
polynomial, within 3e-6 of erf), fp32 logits and softmax, probabilities
rounded to the compute dtype before P @ V, residuals in the compute
dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimae_tpu_torch.ops import _build
from multimae_tpu_torch.ops.functional import (
    attention,
    check_grid,
    dense,
    gelu,
    layer_norm,
    merge_heads,
    split_heads,
)

LAUNCHES = 0  # kernel launches made by fused_block_infer

_FORCE_MODE = None  # None | "plain" (tests and the kernel-vs-twin check)


def set_force_mode(mode):
    global _FORCE_MODE
    assert mode in (None, "plain")
    _FORCE_MODE = mode


class BlockWeights(NamedTuple):
    """fp32 parameters in the torch layout: LayerNorm (D,), Linear
    weights (out, in), biases (out,)."""

    n1_g: torch.Tensor
    n1_b: torch.Tensor
    wqkv: torch.Tensor  # (3D, D)
    bqkv: torch.Tensor
    wp: torch.Tensor    # (D, D)
    bp: torch.Tensor
    n2_g: torch.Tensor
    n2_b: torch.Tensor
    w1: torch.Tensor    # (H, D)
    b1: torch.Tensor
    w2: torch.Tensor    # (D, H)
    b2: torch.Tensor


_LN_IDX = frozenset({0, 1, 6, 7})


def _cast(w: BlockWeights, dtype) -> BlockWeights:
    """LayerNorm parameters stay fp32; everything else to `dtype`."""
    return BlockWeights(*[
        t.float().contiguous() if i in _LN_IDX else t.to(dtype).contiguous()
        for i, t in enumerate(w)
    ])


def block_infer_ref(x: torch.Tensor, w: BlockWeights, heads: int) -> torch.Tensor:
    """Plain twin: x (B, N, D) in the compute dtype -> (B, N, D)."""
    dtype = x.dtype
    d = x.shape[-1]
    h = layer_norm(x, w.n1_g, w.n1_b, dtype)
    q, k, v = dense(h, w.wqkv, w.bqkv, dtype).split(d, dim=-1)
    a = attention(split_heads(q, heads), split_heads(k, heads),
                  split_heads(v, heads), (d // heads) ** -0.5)
    x = x + dense(merge_heads(a), w.wp, w.bp, dtype)
    h = layer_norm(x, w.n2_g, w.n2_b, dtype)
    return x + dense(gelu(dense(h, w.w1, w.b1, dtype)), w.w2, w.b2, dtype)


def attention_smem_bytes(nk: int, dh: int) -> int:
    """Dynamic shared memory of the attention kernel (csrc/common.cuh) in
    fp32, the larger of its two dtypes: for each of its 8 warps four
    query rows and their scores, then K and V rows padded to dh+2."""
    return 16 * 8 * (dh + nk) + 2 * nk * (dh + 2) * 4


SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def shape_problem(d: int, heads: int, hidden: int, nk: int,
                  dtype: torch.dtype = torch.float32):
    """Why the kernel chains do not take a shape, or None: GEMM depths and
    widths in multiples of 32, head width a multiple of 32 up to 128, a
    LayerNorm row of at most 1024, and in fp32 K/V rows that fit shared
    memory. In bf16 any key count goes: where K/V do not fit, the chains'
    attention step runs the key-tiled K2 forward
    (csrc/short_attention_fwd.cu)."""
    if heads <= 0 or d % heads or d % 32 or hidden % 32 or d > 1024:
        return f"unsupported widths: dim {d}, heads {heads}, hidden {hidden}"
    dh = d // heads
    if dh % 32 or dh > 128:
        return f"unsupported head width {dh}"
    if dtype != torch.bfloat16 and attention_smem_bytes(nk, dh) > SMEM_LIMIT:
        return f"{nk} keys of width {dh} exceed shared memory"
    return None


def check_kernel_shapes(d: int, heads: int, hidden: int, nk: int,
                        dtype: torch.dtype = torch.float32) -> None:
    """Raise ValueError for the shapes `shape_problem` names."""
    problem = shape_problem(d, heads, hidden, nk, dtype)
    if problem is not None:
        raise ValueError(problem)


def supported(n: int, d: int, heads: int, hidden: int, dtype, batch: int = 1) -> bool:
    """Whether K4 takes a block of `batch` x n tokens: bf16, D and the
    hidden width in whole 64-element k-steps of the wgmma tiles
    (csrc/decoder_tc.cuh), and the chains' limits (`shape_problem`: head
    width 32, 64, 96 or 128, D at most 1024). The counterpart of the JAX
    `fused_block_pallas.supported`, which the JAX block consults
    (multimae_tpu/models/vit.py:334); every shape it refuses takes the
    module path. A shape it takes whose launch would leave the grids
    raises ValueError with the reason (functional.check_grid)."""
    if not (dtype == torch.bfloat16 and d % 64 == 0 and hidden % 64 == 0
            and shape_problem(d, heads, hidden, n, dtype) is None):
        return False
    check_grid("fused_block_infer", batch * n, batch, heads)
    return True


def _launch(x: torch.Tensor, w: BlockWeights, heads: int) -> torch.Tensor:
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_infer: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_block_infer: kernel takes bfloat16, not {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_block_infer: x must be a contiguous (B, N, D)")
    b, n, d = x.shape
    hidden = w.w1.shape[0]
    if not supported(n, d, heads, hidden, x.dtype, b):
        raise ValueError(f"fused_block_infer: no kernel for {n} tokens of dim {d}, "
                         f"{heads} heads, hidden {hidden}")
    wc = _cast(w, x.dtype)
    expect = [(d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
              (hidden, d), (hidden,), (d, hidden), (d,)]
    for name, t, shape in zip(BlockWeights._fields, wc, expect):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"fused_block_infer: weight {name} is "
                             f"{tuple(t.shape)} on {t.device}, expected {shape}")
    m = b * n
    out = torch.empty_like(x)
    ln = torch.empty((m, d), device=x.device, dtype=x.dtype)
    qkv = torch.empty((m, 3 * d), device=x.device, dtype=x.dtype)
    att = torch.empty((m, d), device=x.device, dtype=x.dtype)
    hid = torch.empty((m, hidden), device=x.device, dtype=x.dtype)
    lib = _build.load()
    rc = lib.mm_fused_block_infer_bf16(
        x.data_ptr(), out.data_ptr(), _build.pointer_array(wc),
        ln.data_ptr(), qkv.data_ptr(), att.data_ptr(), hid.data_ptr(),
        b, n, d, heads, hidden, torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES += 1
    _build.check(lib, rc, "fused_block_infer")
    return out


def fused_block_infer(x: torch.Tensor, w: BlockWeights, heads: int) -> torch.Tensor:
    """x (B, N, D) in the compute dtype -> (B, N, D): one pre-LN ViT
    block, inference only. CPU tensors take the plain twin; CUDA tensors
    launch the kernel or raise."""
    if _FORCE_MODE == "plain" or x.device.type == "cpu":
        return block_infer_ref(x, _cast(w, x.dtype), heads)
    return _launch(x, w, heads)
