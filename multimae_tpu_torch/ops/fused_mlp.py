"""Dense -> GELU -> Dense over rows (kernel K3a, forward and backward), and
the ConvNeXt block's tail, res + fc2(GELU(fc1(LN(x)))) (kernel K3b,
forward and backward).

Counterpart of multimae_tpu/ops/fused_mlp_pallas.py `fused_mlp` (K3a:
forward `_fwd_kernel`, backward `_bwd_kernel`, which recomputes fc1) and
`fused_ln_mlp_res` (K3b: forward `_lmr_fwd_kernel`, backward
`_lmr_bwd_kernel`, which recomputes LN and fc1 and returns dy itself as the
residual's gradient). Each op is a torch.autograd.Function, as each JAX op
is a custom_vjp. On a CUDA tensor its forward launches csrc/fused_mlp_fwd.cu
and its backward csrc/fused_mlp_bwd.cu (bf16; both kernels run one shared
MLP chain there, on the wgmma GEMMs and LayerNorm rows of
csrc/decoder_tc.cuh); on a CPU tensor the same Function runs the plain twins
(`fused_mlp_ref`, `fused_mlp_bwd_ref`; `fused_ln_mlp_res_ref`,
`fused_ln_mlp_res_bwd_ref`).

No model path calls K3a: in both packages the ConvNeXt block takes K3b,
and the JAX `fused_mlp`'s only caller is its test. It is ported so that
every TPU kernel has its counterpart, and is held against its twin on the
card by the card tests and chip_smoke.py.

Weights are fp32 parameters in the torch layout, cast at use: LayerNorm
gamma and beta (K,) stay fp32, w1 (H, K), b1 (H,), w2 (K, H) and b2 (K,)
go to the compute dtype (the JAX kernels take w1 (K, H) and w2 (H, K)).
The backwards return dx in the compute dtype and fp32 gradients for the
parameters.

Numerics of the kernels and their twins, as the Pallas kernels' (JAX
fused_decoder_pallas `_ln_fwd`, `_dense`, `_gelu_fwd`, `_gelu_bwd`,
`_ln_bwd`): LayerNorm with fp32 statistics (two-pass here; the Pallas
kernel's fast variance E[x^2] - E[x]^2 there), each dense's fp32 sum
rounded before its bias is added in the compute dtype, exact-erf GELU
(the Pallas kernel's is a tanh-basis fit within 3e-6), dW and db summed
in fp32, the LayerNorm backward in fp32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from multimae_tpu_torch.ops import _build
from multimae_tpu_torch.ops.functional import (
    check_grid,
    dense,
    dense_bwd,
    fp32,
    gelu,
    gelu_grad,
    layer_norm,
    layer_norm_bwd,
)

LAUNCHES = 0          # K3b forward kernel launches made by fused_ln_mlp_res
LAUNCHES_BWD = 0      # K3b backward kernel launches made by its gradient
LAUNCHES_MLP = 0      # K3a forward kernel launches made by fused_mlp
LAUNCHES_MLP_BWD = 0  # K3a backward kernel launches made by its gradient

_FORCE_MODE = None  # None | "plain" (tests and the kernel-vs-twin check)

# K3b's row floor, from the H100 (chip_smoke.py phase 9, PERF.md §6; H100
# 80GB HBM3, 700 W): at (rows, 384, hidden 1536) the kernels beat the
# ConvNeXt block's module path in 21 of 24 pairs at 4096, 16384 and 65536
# rows, forward and training forward + backward; the three losses, at
# most 0.15 ms, came where both paths are bound by the host. Below 4096
# rows nothing was measured, so the module path serves there.
MIN_ROWS = 4096

# The JAX predicate's row floor (`supported`, :73-84: 8 row tiles of
# 2048), which K3a's gate keeps: no path runs K3a, so the card has given
# no reason to move it.
JAX_MIN_ROWS = 16384


def set_force_mode(mode):
    global _FORCE_MODE
    assert mode in (None, "plain")
    _FORCE_MODE = mode


def supported(m: int, k: int, h: int, dtype) -> bool:
    """The gate the ConvNeXt block consults (models/conv_utils.py): bf16
    with at least MIN_ROWS rows, and widths the kernels take: K and H in
    whole 64-element k-steps of the wgmma tiles (csrc/decoder_tc.cuh), K
    at most 1024 (a LayerNorm row per warp). Every shape it refuses takes
    the block's module path; one it takes whose M rows would leave the
    GEMMs' grid raises ValueError with the reason (functional.check_grid)."""
    if not (dtype == torch.bfloat16 and m >= MIN_ROWS and k % 64 == 0
            and k <= 1024 and h % 64 == 0):
        return False
    check_grid("fused_ln_mlp_res", m)
    return True


def fused_mlp_supported(m: int, k: int, h: int, dtype) -> bool:
    """The JAX predicate of `fused_mlp` (:73-84) as it stands: bf16, K and H
    multiples of 128, at least JAX_MIN_ROWS rows, and a 2048-row tile with the
    weights and their fp32 gradients within 80 MiB (the TPU's VMEM budget,
    kept so that both packages take a kernel at the same shapes)."""
    if k % 128 or h % 128 or dtype != torch.bfloat16:
        return False
    tile = 2048 * (2 * k + h) * 2 * 2
    weights = 2 * 2 * k * h + 4 * (k * h * 2 + k + h)
    if m < JAX_MIN_ROWS or tile + weights > 80 * 1024 * 1024:
        return False
    check_grid("fused_mlp", m)
    return True


class MlpCoreWeights(NamedTuple):
    """K3a's fp32 parameters in the torch layout."""

    w1: torch.Tensor  # (H, K)
    b1: torch.Tensor  # (H,)
    w2: torch.Tensor  # (K, H)
    b2: torch.Tensor  # (K,)


class MlpWeights(NamedTuple):
    """fp32 parameters in the torch layout."""

    ln_g: torch.Tensor  # (K,)
    ln_b: torch.Tensor  # (K,)
    w1: torch.Tensor    # (H, K)
    b1: torch.Tensor    # (H,)
    w2: torch.Tensor    # (K, H)
    b2: torch.Tensor    # (K,)


def _cast(w, dtype):
    """LayerNorm parameters stay fp32; everything else to `dtype`."""
    if isinstance(w, MlpCoreWeights):
        return MlpCoreWeights(*[t.to(dtype).contiguous() for t in w])
    return MlpWeights(w.ln_g.float().contiguous(), w.ln_b.float().contiguous(),
                      *[t.to(dtype).contiguous() for t in w[2:]])


# ------------------------------------------------------------- the twins --


def fused_mlp_ref(x: torch.Tensor, w: MlpCoreWeights) -> torch.Tensor:
    """Plain twin of K3a: x (M, K) in the compute dtype -> (M, K)."""
    dtype = x.dtype
    wc = _cast(w, dtype)
    return dense(gelu(dense(x, wc.w1, wc.b1, dtype)), wc.w2, wc.b2, dtype)


def fused_mlp_bwd_ref(x: torch.Tensor, dy: torch.Tensor, w: MlpCoreWeights):
    """Plain twin of K3a's backward (`_bwd_kernel` math): the gradient dy
    (M, K) of the output -> (dx in the compute dtype, MlpCoreWeights of fp32
    gradients)."""
    dtype = x.dtype
    wc = _cast(w, dtype)
    pre = dense(x, wc.w1, wc.b1, dtype)
    dh, dw2, db2 = dense_bwd(gelu(pre), wc.w2, dy.to(dtype))
    dpre = (fp32(dh) * gelu_grad(pre)).to(dtype)
    dx, dw1, db1 = dense_bwd(x, wc.w1, dpre)
    return dx.to(dtype), MlpCoreWeights(dw1, db1, dw2, db2)


def fused_ln_mlp_res_ref(x: torch.Tensor, res: torch.Tensor, w: MlpWeights) -> torch.Tensor:
    """Plain twin: x and res (M, K) in the compute dtype -> (M, K)."""
    dtype = x.dtype
    wc = _cast(w, dtype)
    h = gelu(dense(layer_norm(x, wc.ln_g, wc.ln_b, dtype), wc.w1, wc.b1, dtype))
    return res.to(dtype) + dense(h, wc.w2, wc.b2, dtype)


def fused_ln_mlp_res_bwd_ref(x: torch.Tensor, dy: torch.Tensor, w: MlpWeights):
    """Plain twin of the backward (`_lmr_bwd_kernel` math): the gradient dy
    (M, K) of the output -> (dx in the compute dtype, MlpWeights of fp32
    gradients)."""
    dtype = x.dtype
    wc = _cast(w, dtype)
    dy = dy.to(dtype)
    n1 = layer_norm(x, wc.ln_g, wc.ln_b, dtype)
    pre = dense(n1, wc.w1, wc.b1, dtype)
    dh, dw2, db2 = dense_bwd(gelu(pre), wc.w2, dy)
    dpre = (fp32(dh) * gelu_grad(pre)).to(dtype)
    dn1, dw1, db1 = dense_bwd(n1, wc.w1, dpre)
    dx, dg, db = layer_norm_bwd(dn1, x, wc.ln_g)
    return dx.to(dtype), MlpWeights(dg, db, dw1, db1, dw2, db2)


# --------------------------------------------------------------- kernels --


def _check(x: torch.Tensor, w, *rows):
    """Raise for inputs the kernels do not take; returns the weights cast
    to the compute dtype (LayerNorm parameters fp32)."""
    k3a = isinstance(w, MlpCoreWeights)
    what = "fused_mlp" if k3a else "fused_ln_mlp_res"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: kernel takes bfloat16, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (M, K), not {tuple(x.shape)}")
    m, k = x.shape
    h = w.w1.shape[0]
    if not (fused_mlp_supported if k3a else supported)(m, k, h, x.dtype):
        raise ValueError(f"{what}: no kernel for ({m}, {k}), hidden {h}")
    for name, t in (("x", x),) + rows:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    wc = _cast(w, x.dtype)
    expect = [(h, k), (h,), (k, h), (k,)]
    if not k3a:
        expect = [(k,), (k,)] + expect
    for name, t, shape in zip(type(w)._fields, wc, expect):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{what}: weight {name} is {tuple(t.shape)} "
                             f"on {t.device}, expected {shape}")
    return wc


def _workspace(lib, m: int, k: int, h: int, ln: bool, device):
    """The backward's bf16 and fp32 workspaces, sized by the CUDA side."""
    t_elems, f_elems = ctypes.c_longlong(), ctypes.c_longlong()
    lib.mm_fused_mlp_bwd_workspace(m, k, h, int(ln), ctypes.byref(t_elems),
                                   ctypes.byref(f_elems))
    return (torch.empty(t_elems.value, device=device, dtype=torch.bfloat16),
            torch.empty(f_elems.value, device=device, dtype=torch.float32))


def _launch(x: torch.Tensor, res: torch.Tensor, w: MlpWeights) -> torch.Tensor:
    global LAUNCHES
    res = res.to(x.dtype).contiguous()
    wc = _check(x, w, ("res", res))
    m, k = x.shape
    h = wc.w1.shape[0]
    y = torch.empty_like(x)
    ln = torch.empty_like(x)
    hid = torch.empty((m, h), device=x.device, dtype=x.dtype)
    lib = _build.load()
    rc = lib.mm_fused_ln_mlp_res_fwd_bf16(
        x.data_ptr(), res.data_ptr(), y.data_ptr(), _build.pointer_array(wc),
        ln.data_ptr(), hid.data_ptr(), m, k, h,
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES += 1
    _build.check(lib, rc, "fused_ln_mlp_res")
    return y


def _launch_bwd(x: torch.Tensor, dy: torch.Tensor, w: MlpWeights):
    global LAUNCHES_BWD
    wc = _check(x, w, ("dy", dy))
    m, k = x.shape
    h = wc.w1.shape[0]
    lib = _build.load()
    ws, fws = _workspace(lib, m, k, h, True, x.device)
    dx = torch.empty_like(x)
    dw = [torch.empty(t.shape, device=x.device, dtype=torch.float32) for t in wc]
    rc = lib.mm_fused_ln_mlp_res_bwd_bf16(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), _build.pointer_array(wc[:5]),
        _build.pointer_array(dw), ws.data_ptr(), fws.data_ptr(), m, k, h,
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES_BWD += 1
    _build.check(lib, rc, "fused_ln_mlp_res backward")
    return dx, MlpWeights(*dw)


def _launch_mlp(x: torch.Tensor, w: MlpCoreWeights) -> torch.Tensor:
    global LAUNCHES_MLP
    wc = _check(x, w)
    m, k = x.shape
    h = wc.w1.shape[0]
    y = torch.empty_like(x)
    hid = torch.empty((m, h), device=x.device, dtype=x.dtype)
    lib = _build.load()
    rc = lib.mm_fused_mlp_fwd_bf16(x.data_ptr(), y.data_ptr(), _build.pointer_array(wc),
                                   hid.data_ptr(), m, k, h,
                                   torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES_MLP += 1
    _build.check(lib, rc, "fused_mlp")
    return y


def _launch_mlp_bwd(x: torch.Tensor, dy: torch.Tensor, w: MlpCoreWeights):
    global LAUNCHES_MLP_BWD
    wc = _check(x, w, ("dy", dy))
    m, k = x.shape
    h = wc.w1.shape[0]
    lib = _build.load()
    ws, fws = _workspace(lib, m, k, h, False, x.device)
    dx = torch.empty_like(x)
    dw = [torch.empty(t.shape, device=x.device, dtype=torch.float32) for t in wc]
    rc = lib.mm_fused_mlp_bwd_bf16(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), _build.pointer_array(wc[:3]),
        _build.pointer_array(dw), ws.data_ptr(), fws.data_ptr(), m, k, h,
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES_MLP_BWD += 1
    _build.check(lib, rc, "fused_mlp backward")
    return dx, MlpCoreWeights(*dw)


def _plain(x: torch.Tensor) -> bool:
    return _FORCE_MODE == "plain" or x.device.type == "cpu"


def fused_ln_mlp_res_bwd(x: torch.Tensor, dy: torch.Tensor, w: MlpWeights):
    """The backward of fused_ln_mlp_res: (dx in the compute dtype, fp32
    MlpWeights gradients); the residual's gradient is dy. CPU tensors take
    the plain twin; CUDA tensors launch the kernel or raise."""
    if _plain(x):
        return fused_ln_mlp_res_bwd_ref(x, dy, w)
    return _launch_bwd(x, dy.to(x.dtype).contiguous(), w)


def fused_mlp_bwd(x: torch.Tensor, dy: torch.Tensor, w: MlpCoreWeights):
    """The backward of fused_mlp: (dx in the compute dtype, fp32
    MlpCoreWeights gradients). CPU tensors take the plain twin; CUDA
    tensors launch the kernel or raise."""
    if _plain(x):
        return fused_mlp_bwd_ref(x, dy, w)
    return _launch_mlp_bwd(x, dy.to(x.dtype).contiguous(), w)


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *weights):
        ctx.save_for_backward(x, *weights)
        w = MlpCoreWeights(*weights)
        if _plain(x):
            return fused_mlp_ref(x, w)
        return _launch_mlp(x, w)

    @staticmethod
    def backward(ctx, grad):
        x, *weights = ctx.saved_tensors
        dx, dw = fused_mlp_bwd(x, grad, MlpCoreWeights(*weights))
        return (dx, *dw)


def fused_mlp(x: torch.Tensor, w: MlpCoreWeights) -> torch.Tensor:
    """x (M, K) in the compute dtype -> fc2(GELU(fc1(x))), (M, K). CPU
    tensors take the plain twins, forward and backward; CUDA tensors launch
    the kernels or raise."""
    return _FusedMlp.apply(x, *w)


class _FusedLnMlpRes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.res_dtype = res.dtype
        w = MlpWeights(*weights)
        if _plain(x):
            return fused_ln_mlp_res_ref(x, res, w)
        return _launch(x, res, w)

    @staticmethod
    def backward(ctx, grad):
        x, *weights = ctx.saved_tensors
        dx, dw = fused_ln_mlp_res_bwd(x, grad, MlpWeights(*weights))
        return (dx, grad.to(ctx.res_dtype), *dw)


def fused_ln_mlp_res(x: torch.Tensor, res: torch.Tensor, w: MlpWeights) -> torch.Tensor:
    """x and res (M, K) in the compute dtype -> res + fc2(GELU(fc1(LN(x)))),
    (M, K). CPU tensors take the plain twins, forward and backward; CUDA
    tensors launch the kernels or raise."""
    return _FusedLnMlpRes.apply(x, res, *w)
