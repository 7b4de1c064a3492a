"""The build's report of each kernel's registers and spills
(``ops/build.py::ptxas_usage``, read from ``ptxas -v``) and the names
``chip_smoke.py`` prints it under."""

import re
import types

import pytest

from adversarial_learning_on_pointclouds_tpu_torch.ops import build
from chip_smoke import ptxas_report

GEMM = "_ZN8pointtpu12_GLOBAL__N_114tc_gemm_kernelILi128ELb1ELb0ELb1EEEv4Gemmi"
THIN = "_ZN8pointtpu12_GLOBAL__N_111thin_kernelILb0EEEv4Gemmib"
SPLIT = "_ZN8pointtpu12_GLOBAL__N_116split_sum_kernelEPKfixPf"
HELPER = "_ZN8pointtpu12_GLOBAL__N_16helperEv"
# The tensor-core backward passes (train_bwd_tc.cu).
B1_TC = "_ZN8pointtpu12_GLOBAL__N_112b1_tc_kernelILb1ELb0EEEvNS_7BwdArgsE"
BMID_TC = ("_ZN8pointtpu12_GLOBAL__N_114bmid_tc_kernelILb0ELi128EEEv"
           "NS_7BwdArgsE")
# Trunk F2 (train_bwd_tc.cu) and the disc's weight-gradient row pass
# (disc_tc.cu) on the tensor cores.
F2_TC = ("_ZN8pointtpu12_GLOBAL__N_112f2_tc_kernelILb0ELb1EEEv"
         "NS_10RowFwdArgsE")
DISC_TC = ("_ZN8pointtpu12_GLOBAL__N_118disc_row_tc_kernelILb1ELi1EEEv"
           "NS_8DiscArgsE")
# The disc's other passes on the tensor cores (disc_tc.cu): the
# backward's row pass by mode (0 dx only, 1 dW, 2 both) and the forward
# by precision.
DISC_ROW = ("_ZN8pointtpu12_GLOBAL__N_118disc_row_tc_kernelILb1ELi0EEEv"
            "NS_8DiscArgsE")
DISC_FWD = "_ZN8pointtpu12_GLOBAL__N_118disc_fwd_tc_kernelILb0EEEvNS_8DiscArgsE"
# The seg head's Pmid and B1 on the tensor cores (train_bwd_tc.cu), by
# precision (and B1 by its n tile: 64, or 8 for c_in <= 8).
PMID_TC = ("_ZN8pointtpu12_GLOBAL__N_114pmid_tc_kernelILb1EEEv"
           "NS_10RowFwdArgsE")
HEAD_B1_TC = ("_ZN8pointtpu12_GLOBAL__N_117head_b1_tc_kernelILb0ELi8EEEv"
              "NS_7BwdArgsE")
# Trunk F1 (by precision and its x stage: 64, or 4 for c_in <= 4) and the
# seg head's B4 on the tensor cores (train_bwd_tc.cu).
F1_TC = ("_ZN8pointtpu12_GLOBAL__N_112f1_tc_kernelILb0ELi64EEEv"
         "NS_10RowFwdArgsE")
F1_FMA = ("_ZN8pointtpu12_GLOBAL__N_112f1_tc_kernelILb1ELi4EEEv"
          "NS_10RowFwdArgsE")
B4_TC = "_ZN8pointtpu12_GLOBAL__N_112b4_tc_kernelILb1EEEvNS_7BwdArgsE"


def _entry(name, regs, st=0, ld=0):
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {st + 8} bytes stack frame, {st} bytes spill stores, "
            f"{ld} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, 512 "
            f"bytes cmem[0]\n")


@pytest.mark.parametrize("text,want", [
    ("", {}),
    ("ptxas info    : 0 bytes gmem\n", {}),
    (_entry(GEMM, 128, 84, 80), {GEMM: (128, 84, 80)}),
    (_entry(GEMM, 128, 84, 84) + _entry(THIN, 40),
     {GEMM: (128, 84, 84), THIN: (40, 0, 0)}),
    # A non-inlined device function's properties between an entry's
    # header and its register count are not that entry's spills.
    (f"ptxas info    : Compiling entry function '{SPLIT}' for 'sm_90a'\n"
     f"ptxas info    : Function properties for {HELPER}\n"
     "    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
     "loads\n"
     f"ptxas info    : Function properties for {SPLIT}\n"
     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
     "ptxas info    : Used 18 registers, 384 bytes cmem[0]\n",
     {SPLIT: (18, 0, 0)}),
])
def test_ptxas_usage(text, want):
    assert build.ptxas_usage(text) == want


def test_ptxas_report_names_kernels_with_template_arguments():
    fake = types.SimpleNamespace(resource_usage={"strided_gemm.cu": {
        GEMM: (128, 84, 84), THIN: (40, 0, 0), SPLIT: (18, 0, 0)}})
    assert ptxas_report(fake, "strided_gemm.cu") == {
        "tc_gemm_kernel<128,1,0,1>": (128, 84, 84),
        "thin_kernel<0>": (40, 0, 0), "split_sum_kernel": (18, 0, 0)}
    assert ptxas_report(fake, "tnet_apply.cu") == {}


def test_ptxas_report_names_the_backward_kernels():
    fake = types.SimpleNamespace(resource_usage={"train_bwd_tc.cu": {
        B1_TC: (204, 0, 0), BMID_TC: (255, 0, 0)}})
    assert ptxas_report(fake, "train_bwd_tc.cu") == {
        "b1_tc_kernel<1,0>": (204, 0, 0),
        "bmid_tc_kernel<0,128>": (255, 0, 0)}


def test_ptxas_report_names_the_new_tensor_core_kernels():
    fake = types.SimpleNamespace(resource_usage={
        "train_bwd_tc.cu": {F2_TC: (155, 0, 0)},
        "disc_tc.cu": {DISC_TC: (255, 64, 620)}})
    assert ptxas_report(fake, "train_bwd_tc.cu") == {
        "f2_tc_kernel<0,1>": (155, 0, 0)}
    assert ptxas_report(fake, "disc_tc.cu") == {
        "disc_row_tc_kernel<1,1>": (255, 64, 620)}


def test_ptxas_report_names_the_disc_passes_by_mode():
    fake = types.SimpleNamespace(resource_usage={"disc_tc.cu": {
        DISC_ROW: (251, 0, 0), DISC_FWD: (243, 0, 0)}})
    assert ptxas_report(fake, "disc_tc.cu") == {
        "disc_row_tc_kernel<1,0>": (251, 0, 0),
        "disc_fwd_tc_kernel<0>": (243, 0, 0)}


def test_ptxas_report_names_the_seg_head_passes():
    fake = types.SimpleNamespace(resource_usage={"train_bwd_tc.cu": {
        PMID_TC: (144, 0, 0), HEAD_B1_TC: (72, 0, 0)}})
    assert ptxas_report(fake, "train_bwd_tc.cu") == {
        "pmid_tc_kernel<1>": (144, 0, 0),
        "head_b1_tc_kernel<0,8>": (72, 0, 0)}


def test_ptxas_report_names_trunk_f1_and_head_b4():
    fake = types.SimpleNamespace(resource_usage={"train_bwd_tc.cu": {
        F1_TC: (128, 0, 0), F1_FMA: (92, 0, 0), B4_TC: (209, 0, 0)}})
    assert ptxas_report(fake, "train_bwd_tc.cu") == {
        "f1_tc_kernel<0,64>": (128, 0, 0), "f1_tc_kernel<1,4>": (92, 0, 0),
        "b4_tc_kernel<1>": (209, 0, 0)}


# The serving kernels on the tensor cores (encoder_fused.cu), as nvcc
# names them (its anonymous namespace carries the file's name): the stack
# by its first layer's depth (64 on mma_step, 4 for c_in <= 4 as FMAs)
# and the seg head.
ANON = "_ZN8pointtpu49_GLOBAL__N__2f377c82_16_encoder_fused_cu_7914b6ff"
STACK_TC = ANON + "15stack_tc_kernelILi64EEEvNS0_9StackArgsE"
STACK_FMA = ANON + "15stack_tc_kernelILi4EEEvNS0_9StackArgsE"
HEAD_TC = ANON + "14head_tc_kernelENS0_8HeadArgsE"


def test_ptxas_report_names_the_serving_kernels():
    fake = types.SimpleNamespace(resource_usage={"encoder_fused.cu": {
        STACK_TC: (242, 0, 0), STACK_FMA: (240, 0, 0),
        HEAD_TC: (255, 184, 692)}})
    assert ptxas_report(fake, "encoder_fused.cu") == {
        "stack_tc_kernel<64>": (242, 0, 0), "stack_tc_kernel<4>": (240, 0, 0),
        "head_tc_kernel": (255, 184, 692)}


# The seg head's P1 (on trunk F1's tile) and P4 (B4's first half) on the
# tensor cores (train_bwd_tc.cu), by precision.
P1_TC = ("_ZN8pointtpu12_GLOBAL__N_117head_p1_tc_kernelILb0EEEv"
         "NS_10RowFwdArgsE")
P4_TC = ("_ZN8pointtpu12_GLOBAL__N_117head_p4_tc_kernelILb1EEEv"
         "NS_10RowFwdArgsE")


def test_ptxas_report_names_head_p1_and_p4():
    fake = types.SimpleNamespace(resource_usage={"train_bwd_tc.cu": {
        P1_TC: (128, 0, 0), P4_TC: (120, 0, 0), F1_TC: (128, 0, 0)}})
    assert ptxas_report(fake, "train_bwd_tc.cu") == {
        "head_p1_tc_kernel<0>": (128, 0, 0),
        "head_p4_tc_kernel<1>": (120, 0, 0),
        "f1_tc_kernel<0,64>": (128, 0, 0)}


def test_no_source_defines_the_cuda_core_row_kernel():
    """The forward row kernel is gone: P1 and P4 launch the tensor-core
    kernels that train_bwd_tc.cu defines, and no source names the row
    kernel or its launcher."""
    srcs = {p.name: p.read_text() for p in sorted(build.CSRC.iterdir())
            if p.suffix in (".cu", ".cuh")}
    assert not [n for n, text in srcs.items() if "row_fwd" in text]
    for kernel in ("head_p1_tc_kernel", "head_p4_tc_kernel"):
        assert f"{kernel}(const" in srcs["train_bwd_tc.cu"], kernel
    entry = srcs["seg_head_train.cu"]
    for launcher in ("head_p1_tc(*a, stream)", "head_p4_tc(*a, stream)"):
        assert launcher in entry, launcher


# The T-Net fc layers' split-K product across clusters (small_fc.cuh), as
# pool_fc_epilogue.cu and fc_head_train.cu instantiate it: by precision
# and W's layout (K-major, or N-major for the backward's cotangents);
# their anonymous namespace carries the source's name.
FC_TC = ("_ZN8pointtpu52_GLOBAL__N__cfc19620_19_pool_fc_epilogue_cu_f51175f0"
         "12fc_tc_kernelILb1ELb1EEEvNS0_7FcLayerENS0_6DwTileE")
FC_TC_NMAJ = ("_ZN8pointtpu49_GLOBAL__N__180701d2_16_fc_head_train_cu_a023436a"
              "12fc_tc_kernelILb0ELb0EEEvNS0_7FcLayerENS0_6DwTileE")


def test_ptxas_report_names_the_fc_cluster_kernels():
    fake = types.SimpleNamespace(resource_usage={
        "pool_fc_epilogue.cu": {FC_TC: (61, 0, 0)},
        "fc_head_train.cu": {FC_TC_NMAJ: (58, 0, 0)}})
    assert ptxas_report(fake, "pool_fc_epilogue.cu") == {
        "fc_tc_kernel<1,1>": (61, 0, 0)}
    assert ptxas_report(fake, "fc_head_train.cu") == {
        "fc_tc_kernel<0,0>": (58, 0, 0)}


def test_no_source_defines_the_cuda_core_fc_kernels():
    """The column-parallel CUDA-core fc layers are gone: pool-fc and the
    fc head launch small_fc.cuh's cluster kernel, and no source names the
    kernels or the routine they shared."""
    srcs = {p.name: p.read_text() for p in sorted(build.CSRC.iterdir())
            if p.suffix in (".cu", ".cuh")}
    gone = ("pool_fc_kernel", "fc_layer_kernel", "fc_bn_bwd_kernel",
            "layer_product")
    assert not [(n, g) for n, text in srcs.items() for g in gone if g in text]
    assert "fc_tc_kernel(const FcLayer" in srcs["small_fc.cuh"]
    assert "cluster.map_shared_rank" in srcs["small_fc.cuh"]
    for src in ("pool_fc_epilogue.cu", "fc_head_train.cu"):
        assert '#include "small_fc.cuh"' in srcs[src], src
        assert "run_fc(" in srcs[src], src


# Serving's conv1 (shared_mlp.cu: a channel group of 4 a thread, by the
# depth its weights in registers take, 0 for the general path) and the
# paired augmentation (augment_fused.cu), as nvcc names them in their
# files' anonymous namespaces.
CONV = ("_ZN8pointtpu46_GLOBAL__N__5d2c1a3e_13_shared_mlp_cu_4b1f9c20"
        "17conv_group_kernelILi3EEEvPKfS3_S3_S3_Pfxiiii")
CONV_GENERAL = ("_ZN8pointtpu46_GLOBAL__N__5d2c1a3e_13_shared_mlp_cu_4b1f9c20"
                "17conv_group_kernelILi0EEEvPKfS3_S3_S3_Pfxiiii")
AUGMENT = ("_ZN8pointtpu49_GLOBAL__N__9a61c0b7_16_augment_fused_cu_0c3e5d11"
           "19augment_pair_kernelENS0_7AugArgsE")


def test_ptxas_report_names_the_conv_and_augment_kernels():
    fake = types.SimpleNamespace(resource_usage={
        "shared_mlp.cu": {CONV: (40, 0, 0), CONV_GENERAL: (48, 0, 0)},
        "augment_fused.cu": {AUGMENT: (64, 0, 0)}})
    assert ptxas_report(fake, "shared_mlp.cu") == {
        "conv_group_kernel<3>": (40, 0, 0),
        "conv_group_kernel<0>": (48, 0, 0)}
    assert ptxas_report(fake, "augment_fused.cu") == {
        "augment_pair_kernel": (64, 0, 0)}


def test_no_source_defines_the_first_conv_and_augment_kernels():
    """conv1's element-per-thread kernel and the one-stream augment kernel
    are gone, and so is round_smem: shared_mlp.cu defines the channel-group
    kernel, augment_fused.cu the paired kernel that both of its entry
    points launch."""
    srcs = {p.name: p.read_text() for p in sorted(build.CSRC.iterdir())
            if p.suffix in (".cu", ".cuh")}
    gone = (r"linear_affine_act_kernel", r"\baugment_kernel\b",
            r"round_smem")
    assert not [(n, g) for n, text in srcs.items() for g in gone
                if re.search(g, text)]
    assert "conv_group_kernel(const float*" in srcs["shared_mlp.cu"]
    aug = srcs["augment_fused.cu"]
    assert "augment_pair_kernel(const AugArgs a)" in aug
    for entry in ("pt_augment_fused(", "pt_augment_fused_pair("):
        assert entry in aug, entry
    assert aug.count("augment_pair_kernel<<<") == 1


# fused_mlp_stack's tensor-core kernel (mlp_stack.cu), by precision and
# m16 tiles a warp (4: 128 rows a tile, 2: 64).
CHAIN_TC = ("_ZN8pointtpu12_GLOBAL__N_115chain_tc_kernelILb0ELi4EEEv"
            "NS_9StackArgsENS0_9StackPlanE")
CHAIN_TC_64 = ("_ZN8pointtpu12_GLOBAL__N_115chain_tc_kernelILb1ELi2EEEv"
               "NS_9StackArgsENS0_9StackPlanE")


def test_ptxas_report_names_the_chain_kernel():
    fake = types.SimpleNamespace(resource_usage={"mlp_stack.cu": {
        CHAIN_TC: (168, 0, 0), CHAIN_TC_64: (128, 0, 0)}})
    assert ptxas_report(fake, "mlp_stack.cu") == {
        "chain_tc_kernel<0,4>": (168, 0, 0),
        "chain_tc_kernel<1,2>": (128, 0, 0)}


def test_no_source_defines_the_cuda_core_row_gemm():
    """fused_mlp_stack's CUDA-core kernel is gone, and with it the row
    GEMM that only it used: mlp_stack.cu defines the tensor-core kernel on
    mma.cuh's fragment layer, and no source names the old kernel, the row
    GEMM, its staging or its FMA tile."""
    srcs = {p.name: p.read_text() for p in sorted(build.CSRC.iterdir())
            if p.suffix in (".cu", ".cuh")}
    gone = (r"\bstack_kernel\b", r"\bgemm_acc\b", r"\bload_tile\b",
            r"\bwith_nj_pow2\b", r"\btile_fma\b", r"\bpad32\b",
            r"\bkStageLd\b", r"\bkMaxCols\b")
    assert not [(n, g) for n, text in srcs.items() for g in gone
                if re.search(g, text)]
    stack = srcs["mlp_stack.cu"]
    assert '#include "mma.cuh"' in stack
    assert "chain_tc_kernel(const __grid_constant__ StackArgs a" in stack
    assert "mma_step<MT, 4, BF>" in stack
    assert 'extern "C" int pt_mlp_stack(' in stack
    assert '#include "train_gemm.cuh"' not in stack
