"""The profiler's kernel categories (cli/profile_forward.CATEGORIES) name
the kernels of csrc/decoder_tc.cuh (K1's, and K3's and K4's GEMMs and
LayerNorms), so that their GEMM, whose name contains "gemm", is not
counted with cuBLAS, and keep the other kinds apart. Kernel names as
torch.profiler reports them on the card."""

import pytest

from multimae_tpu_torch.cli.profile_forward import category

NAMES = [
    ("void mm::dtc::(anonymous namespace)::tc_gemm_kernel<0, 2, false, false>"
     "(mm::dtc::(anonymous namespace)::GemmArgs<__nv_bfloat16>)", "K1 GEMMs, bf16"),
    ("void mm::dtc::(anonymous namespace)::tc_gemm_kernel<6, 2, true, true>"
     "(mm::dtc::(anonymous namespace)::GemmArgs<__nv_bfloat16>)", "K1 GEMMs, bf16"),
    ("void mm::dtc::(anonymous namespace)::f32_gemm_kernel<5, false, true>"
     "(mm::dtc::(anonymous namespace)::GemmArgs<float>)", "K1 GEMMs, fp32"),
    ("void mm::dtc::(anonymous namespace)::attn_fwd_kernel<32>(__nv_bfloat16 const*, int, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, int, __nv_bfloat16*, int, int, int, float)",
     "K1 attention fwd"),
    ("void mm::dtc::(anonymous namespace)::attn_bwd_rows_kernel<32>(...)",
     "K1 attention bwd rows"),
    ("void mm::dtc::(anonymous namespace)::attn_bwd_keys_kernel<64>(...)",
     "K1 attention bwd keys"),
    ("void mm::dtc::(anonymous namespace)::fa_bwd_rows_kernel<32, 128>(float const*, ...)",
     "K1 attention, fp32"),
    ("void mm::dtc::(anonymous namespace)::fa_fwd_kernel<32>(float const*, ...)",
     "K1 attention, fp32"),
    ("void mm::dtc::(anonymous namespace)::ln_fwd_kernel<__nv_bfloat16, 8>(...)",
     "K1 LayerNorm"),
    ("void mm::dtc::(anonymous namespace)::ln_param_partial_kernel<float>(...)",
     "K1 LayerNorm"),
    ("mm::dtc::(anonymous namespace)::sum_slices2_kernel(float const*, ...)",
     "K1 LayerNorm and slice sums"),
    ("void mm::layer_norm_kernel<__nv_bfloat16>(...)", "common.cuh"),
    ("void mm::dtc::(anonymous namespace)::ln_bwd_kernel<__nv_bfloat16>(...)", "K1 LayerNorm"),
    ("void (anonymous namespace)::short_attention_fwd_kernel<64, 3>(...)", "K2 fwd"),
    ("void (anonymous namespace)::dkdv_kernel<64>(...)", "K2 bwd dK/dV"),
    ("void mm::attention_kernel<float, 64>(...)", "common.cuh"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT", "cuBLAS"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "cuBLAS"),
]


@pytest.mark.parametrize("name,kind", NAMES)
def test_kernel_names_land_in_their_category(name, kind):
    assert category(name).startswith(kind), (name, category(name))
