"""``audio8_tpu_torch.profile.kernel_groups`` on profiler events that
carry the kernel names an H100 trace of the port shows (cuBLAS's Hopper
bf16 GEMMs ``nvjet_...``, the attention block's GEMMs on each route, the
core's forward routes and three backward launches, the conv wgrad's,
dgrad's and forward's bf16 GEMMs, which are the same TMA-fed kernel, the
CTC sweep and gradient launches, PyTorch's elementwise kernels):
each name
lands in its group, and only the rest in "other". No card is needed: the
events are stand-ins with a name, a device type and a time range."""
from types import SimpleNamespace

import pytest
import torch

from audio8_tpu_torch.profile import GEMM_CALLERS, gemm_caller, kernel_groups
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CUDA = torch.autograd.DeviceType.CUDA


def _event(name, us, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=0, end=us))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


# (name, group): cuBLAS bf16 on Hopper, then the block's GEMM on its three
# routes (one of each launch's operand and epilogue types), then the core
EVENTS = [
    ("nvjet_tst_256x128_64x4_1x4_h_bz_coopA_NNT", "matmul"),
    ("nvjet_tst_192x128_64x5_1x2_h_bz_coopB_TNT", "matmul"),
    ("nvjet_tst_96x64_64x8_2x4_h_bz_NTN", "matmul"),
    ("void tmagemm::wgmma_gemm_kernel<256, tmagemm::TmaRowCols, "
     "tmagemm::TmaHeadRows, blockgemm::Partial>(tmagemm::Maps, "
     "tmagemm::TmaRowCols, tmagemm::TmaHeadRows, blockgemm::Partial, "
     "int, int, int, int, int)", "attention_block_gemm"),
    ("void tmagemm::wgmma_gemm_kernel<256, tmagemm::TmaHeadCols, "
     "tmagemm::TmaWeightCols, tmagemm::PaddedRowOut>(tmagemm::Maps, ...)",
     "attention_block_gemm"),
    ("void blockgemm::gemm_bf16_mma_kernel<blockgemm::RowCols<__nv_bfloat16>, "
     "blockgemm::HeadRows<__nv_bfloat16>, blockgemm::Partial>(...)",
     "attention_block_gemm"),
    ("void blockgemm::gemm_kernel<float, blockgemm::HeadCols<float>, "
     "blockgemm::WeightCols<float>, blockgemm::RowOut<float> >(...)",
     "attention_block_gemm"),
    ("void (anonymous namespace)::bias_partials_kernel(float const*, float "
     "const*, float const*, float*, int, int, int)", "attention_block_gemm"),
    ("void (anonymous namespace)::attention_bwd_wgmma_kernel<64>(...)",
     "attention_bwd"),
    ("void (anonymous namespace)::dq_reduce_kernel<__nv_bfloat16>(...)",
     "attention_bwd"),
    ("void (anonymous namespace)::attention_fwd_bf16_mma_kernel<64>(...)",
     "attention_fwd"),
    ("void (anonymous namespace)::attention_fwd_wgmma_kernel<64>((anonymous "
     "namespace)::FwdMaps, unsigned char const*, __nv_bfloat16*, ...)",
     "attention_fwd"),
    ("void (anonymous namespace)::attention_fwd_simt_kernel<float, 64>(...)",
     "attention_fwd"),
    # the conv wgrad's bf16 GEMM is the same TMA-fed kernel on its taps
    ("void tmagemm::wgmma_gemm_kernel<256, tmagemm::TmaTapRows, "
     "tmagemm::TmaRowCols, (anonymous namespace)::TapPartial>("
     "tmagemm::Maps, ...)", "conv_k3s2_wgrad"),
    ("void (anonymous namespace)::sum_splits_kernel(float const*, float*, "
     "long long, int)", "conv_k3s2_wgrad"),
    # the conv forward's bf16 GEMM is the same kernel on its K-major taps
    ("void tmagemm::wgmma_gemm_kernel<256, tmagemm::TmaTapCols, "
     "tmagemm::TmaWeightCols, tmagemm::PaddedRowOut>(tmagemm::Maps, ...)",
     "conv_k3s2_fwd"),
    # the conv dgrad's bf16 GEMM: the same kernel on shifted dy rows
    ("void tmagemm::wgmma_gemm_kernel<256, tmagemm::TmaShiftRows, "
     "tmagemm::TmaWeightRows, (anonymous namespace)::HalfRowsOut>("
     "tmagemm::Maps, ...)", "conv_k3s2_dgrad"),
    ("void (anonymous namespace)::dgrad_bf16_mma_kernel((anonymous "
     "namespace)::Dgrad<__nv_bfloat16>)", "conv_k3s2_dgrad"),
    ("void (anonymous namespace)::conv_k3s2_fwd_bf16_mma_kernel(...)",
     "conv_k3s2_fwd"),
    # the CTC loss: the alpha and beta sweep and the gradient pass
    ("void (anonymous namespace)::ctc_sweep_kernel<1>((anonymous "
     "namespace)::SweepArgs)", "ctc"),
    ("void (anonymous namespace)::ctc_finish_kernel(float const*, int "
     "const*, ...)", "ctc"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)...>", "other"),
]


def test_kernel_groups_read_a_bf16_step():
    prof = _Prof([_event(n, 1000.0 * (i + 1)) for i, (n, _) in
                  enumerate(EVENTS)] + [_event("cpu op", 5e6, "cpu")])
    out = kernel_groups(prof)
    want = {}
    for i, (_, group) in enumerate(EVENTS):
        want[group] = want.get(group, 0.0) + (i + 1)
    for group, ms in want.items():
        assert out[group] == pytest.approx(ms), group
    assert out["matmul"] == pytest.approx(6.0)  # no longer near zero
    assert list(out["other_top5"]) == [EVENTS[-1][0][:90]]
    dq = next(i for i, (n, _) in enumerate(EVENTS) if "dq_reduce" in n)
    assert out["attention_bwd_parts"]["dq_reduce"] == pytest.approx(dq + 1.0)


@pytest.mark.parametrize("recipe,caller", sorted(GEMM_CALLERS.items()))
def test_gemm_caller_reads_the_a_recipe(recipe, caller):
    """A TMA-fed GEMM kernel is filed under the caller of its A operand's
    recipe (the one table), whatever recipe its B operand names and
    whatever the epilogue's namespace; no other kernel has a caller."""
    for b in GEMM_CALLERS:
        name = (f"void tmagemm::wgmma_gemm_kernel<128, tmagemm::{recipe}, "
                f"tmagemm::{b}, (anonymous namespace)::Out>(tmagemm::Maps, "
                f"tmagemm::{recipe}, tmagemm::{b}, ...)")
        assert gemm_caller(name) == caller
    assert gemm_caller(f"void blockgemm::gemm_kernel<float, {recipe}>") is None
