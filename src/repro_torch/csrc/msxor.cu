// MSXOR debias fold (paper §4.2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _msxor_kernel of
// src/repro/kernels/msxor/msxor.py:32 (launched by msxor_pallas, :45).
// Input: (G = 2^n_stages, M) raw words, row-major, each a uint32 value held
// in an int64 (the port's word tensors, read as they are; only the low 32
// bits are used).  Output: (M,) words, word[c] = raw[0][c] ^ ... ^
// raw[G-1][c] zero-extended to int64, or with to_uniform the float
// (word >> 8) * 2^-24 (exact: at most 24 bits).  XOR is associative and
// commutative, so folding the G rows of a column in order gives the same
// bits as the paper's pairwise gate tree (_fold_block: 8 -> 4 -> 2 -> 1);
// the plain version is repro_torch/kernels/msxor/ref.py.
//
// What bounds it on this card.  Each column reads G 8-byte words and
// writes one word (8 bytes) or one float (4 bytes), about G operations on
// them: bound by bytes (3.35 TB/s from HBM), two orders of magnitude below
// the ALU limit.
//
// What the design does about that.  None of the Pallas blocking is kept:
// one thread folds one column.  Consecutive threads read consecutive words
// of a row, so every load is coalesced, and the G loads of a thread are
// independent and unrolled (G is a template argument), so they are all in
// flight at once.  A grid-stride loop covers any M; the ragged edge is
// bounds-checked, nothing is padded.  Indices are 64-bit (G * M passes 2^31
// at M = 2^28).  The shift is logical (uint32).
//
// Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks per SM

template <int G, bool kUniform>
__global__ void __launch_bounds__(kThreads)
    msxor_kernel(const unsigned long long* __restrict__ raw, void* __restrict__ out,
                 long long m) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; col < m;
       col += stride) {
    unsigned long long w[G];
#pragma unroll
    for (int r = 0; r < G; ++r) w[r] = __ldg(raw + static_cast<size_t>(r) * m + col);
    uint32_t acc = static_cast<uint32_t>(w[0]);
#pragma unroll
    for (int r = 1; r < G; ++r) acc ^= static_cast<uint32_t>(w[r]);
    if (kUniform) {
      static_cast<float*>(out)[col] = static_cast<float>(acc >> 8) * 0x1p-24f;
    } else {
      static_cast<unsigned long long*>(out)[col] = acc;
    }
  }
}

template <int G, bool kUniform>
void launch(const unsigned long long* raw, void* out, long long m, cudaStream_t s) {
  const long long b = (m + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
  msxor_kernel<G, kUniform><<<blocks, kThreads, 0, s>>>(raw, out, m);
}

template <bool kUniform>
cudaError_t launch_stages(const unsigned long long* raw, void* out, int n_stages, long long m,
                          cudaStream_t s) {
  switch (n_stages) {
    case 1: launch<2, kUniform>(raw, out, m, s); break;
    case 2: launch<4, kUniform>(raw, out, m, s); break;
    case 3: launch<8, kUniform>(raw, out, m, s); break;
    case 4: launch<16, kUniform>(raw, out, m, s); break;
    case 5: launch<32, kUniform>(raw, out, m, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_msxor(const unsigned long long* raw, void* out, int n_stages, long long m,
                int to_uniform, void* stream) {
  if (m < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return to_uniform ? launch_stages<true>(raw, out, n_stages, m, s)
                    : launch_stages<false>(raw, out, n_stages, m, s);
}

}  // extern "C"
