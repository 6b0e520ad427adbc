// Pass two of K3's weight gradient, shared by its float32
// (conv3x3_dk_tf32_tc.cu) and bfloat16 (conv3x3_dk_tc.cu) kernels: the
// chunks' float32 partial sums, added in chunk order. With pass one's fixed
// order, two runs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace mm {
namespace {  // one copy per source: no symbol is shared between the objects

// dk[i] = sum over chunks of partial[chunk][i], in chunk order.
__global__ void conv3x3_dk_sum(const float* __restrict__ partial, float* __restrict__ dk, int n,
                               int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[static_cast<size_t>(c) * n + i];
  dk[i] = s;
}

// partial (n_chunks, n) -> dk (n) on `stream`; a CUDA error code, or 0.
int sum_chunks(const float* partial, float* dk, int n, int n_chunks, cudaStream_t stream) {
  conv3x3_dk_sum<<<(n + 255) / 256, 256, 0, stream>>>(partial, dk, n, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mm
