// Plan layout (int64) of the fused ConvNet kernels, csrc/convnet.cu and
// csrc/convnet_wide.cu, written by ops/cuda/convnet.py `_pack_plan`.

#pragma once

#include "activations.cuh"  // Act codes, apply_act, activate, stage

namespace {

constexpr int P_N_LAYERS = 0;
constexpr int P_CIN = 1;
constexpr int P_COUT = 2;
constexpr int P_C = 3;
constexpr int P_HEAD_W = 4;
constexpr int P_HEAD_B = 5;
constexpr int P_SEG_MAX = 6;
constexpr int P_ACT = 7;
constexpr int P_ACT_PRM = 8;
constexpr int P_HEADER = 10;
constexpr int LF = 8;  // fields per layer
constexpr int L_K = 0, L_D = 1, L_M = 2, L_RING = 3, L_SEG = 4, L_SEG_LEN = 5, L_CIN = 6;

}  // namespace
