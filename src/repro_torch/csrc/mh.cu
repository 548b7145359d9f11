// Fused Metropolis-Hastings chain kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/mh/mh.py with
// one kernel, mh_chain_kernel<kShared, Draw>, that differs only in where
// each step's flip word and uniform come from:
//   * Draw = OperandDraw  <- _mh_kernel (mh.py:35, launched by
//     mh_chain_pallas): K MH steps with the flip words and uniforms given
//     as operands (randomness "host" and "cim"); entry repro_mh_chain;
//   * Draw = FusedDraw    <- _mh_fused_kernel (mh.py:125, launched by
//     mh_chain_pallas_fused): the same chain with the flip word and the
//     uniform drawn in-kernel from the Threefry counter cipher (rng.cuh),
//     given only per-column key words and a per-column step base t0c;
//     entry repro_mh_chain_fused.
//
// One step of chain (b, c), as in the Pallas kernels and in the plain
// version repro_torch/kernels/mh/ref.py:
//   cand = state ^ (flip & mask)
//   lc   = cand < V ? table[b, cand] : -inf
//   e    = expf(min(lc - logp, 0)), then 0 where e < 2^-126 (XLA flushes
//          denormal exp results; this keeps the accept test identical)
//   accept when u < e and lc is finite; state/logp select; samples[k,b,c]
//
// What bounds them on this card.  The OperandDraw kernel moves about 12
// bytes per chain-step (flip word and uniform in, sample out) plus the table
// once, and does a handful of operations per step: it is bound by bytes.
// The FusedDraw kernel moves 4 bytes per chain-step (the sample) but runs
// nbits + 2 Threefry-20 blocks per chain-step (the step key, one per flip
// bit-plane, one for the uniform), about 80 integer operations each: it is
// bound by 32-bit integer ALU work.
//
// Why the first design is simple.  One thread owns one chain and runs the
// K-step loop in registers, the TPU kernel's sequential fori_loop; blocks
// of 128 chains of one table row run in parallel.  The table row is staged
// whole in dynamic shared memory when it fits in a block's opt-in limit
// (V = 49,155 float32 is 196,620 bytes); otherwise (V = 256,000 is 1 MB)
// the lookup gathers from global memory through the read-only cache and
// L2.  No tensor cores, no software pipelining of the operand loads and no
// sharing of the step key across chains of one column: speed is later work.
//
// Built by repro_torch/kernels/_build.py with --fmad=false and without fast
// math (expf, never __expf).  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "rng.cuh"

// The staged table row (dynamic shared memory, sized at launch).
extern __shared__ float srow[];

namespace {

constexpr int kThreads = 128;
constexpr float kFlush = 1.17549435e-38f;  // 2^-126, the least normal float

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <bool kShared>
__device__ __forceinline__ float lookup(const float* __restrict__ row,
                                        uint32_t w, uint32_t vocab) {
  if (w >= vocab) return neg_inf();
  return kShared ? srow[w] : __ldg(row + w);
}

__device__ __forceinline__ bool accept_test(float u, float lc, float logp) {
  const float d = lc - logp;
  const float m = d > 0.0f ? 0.0f : d;  // jnp.minimum(d, 0): NaN stays NaN
  float e = expf(m);
  if (e < kFlush) e = 0.0f;
  return (u < e) && isfinite(lc);
}

template <bool kShared>
__device__ __forceinline__ void stage_row(const float* __restrict__ row, int V) {
  if (kShared) {
    for (int i = threadIdx.x; i < V; i += blockDim.x) srow[i] = row[i];
    __syncthreads();
  }
}

// Where one step's flip word and uniform come from.  chain(b, c) gives the
// per-chain reader; draw(k, idx, ...) yields step k's pair, idx = (k, b, c)
// offset in the (K, B, C) operands.

// _mh_kernel: the flip words and uniforms are (K, B, C) operands.
struct OperandDraw {
  const uint32_t* flips;
  const float* u;
  __device__ OperandDraw chain(int, int) const { return *this; }
  __device__ __forceinline__ void draw(int, size_t idx, uint32_t& flip, float& uu) const {
    flip = flips[idx];
    uu = u[idx];
  }
};

// _mh_fused_kernel: step t0c[c] + k (mod 2^32) of column c's key at site
// b * cc + c % cc, so chains folded chain-major into the columns keep
// their streams.
struct FusedDraw {
  const uint32_t* k0c;
  const uint32_t* k1c;
  const int32_t* t0c;
  int nbits, cc;
  uint32_t p_u32;

  struct Chain {
    uint32_t k0, k1, t0, site, p_u32;
    int nbits;
    __device__ __forceinline__ void draw(int k, size_t, uint32_t& flip, float& uu) const {
      uint32_t s0, s1;
      repro::step_key(k0, k1, t0 + static_cast<uint32_t>(k), s0, s1);
      flip = repro::flips_at(s0, s1, site, nbits, p_u32);
      uu = repro::uniform_at(s0, s1, site);
    }
  };
  __device__ Chain chain(int b, int c) const {
    const uint32_t site = static_cast<uint32_t>(b) * static_cast<uint32_t>(cc) +
                          static_cast<uint32_t>(c % cc);
    return {k0c[c], k1c[c], static_cast<uint32_t>(t0c[c]), site, p_u32, nbits};
  }
};

template <bool kShared, class Draw>
__global__ void __launch_bounds__(kThreads)
mh_chain_kernel(const float* __restrict__ table, const uint32_t* __restrict__ init,
                const Draw draw, uint32_t* __restrict__ samples,
                int32_t* __restrict__ accept, int B, int V, int C, int K, uint32_t mask) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const float* row = table + static_cast<size_t>(b) * V;
  stage_row<kShared>(row, V);
  if (c >= C) return;

  const uint32_t vocab = static_cast<uint32_t>(V);
  const size_t bc = static_cast<size_t>(b) * C + c;
  const size_t plane = static_cast<size_t>(B) * C;
  const auto chain = draw.chain(b, c);
  uint32_t state = init[bc];
  float logp = lookup<kShared>(row, state, vocab);
  int32_t acc = 0;
  for (int k = 0; k < K; ++k) {
    const size_t idx = static_cast<size_t>(k) * plane + bc;
    uint32_t flip;
    float uu;
    chain.draw(k, idx, flip, uu);
    const uint32_t cand = state ^ (flip & mask);
    const float lc = lookup<kShared>(row, cand, vocab);
    if (accept_test(uu, lc, logp)) {
      state = cand;
      logp = lc;
      ++acc;
    }
    samples[idx] = state;
  }
  accept[bc] = acc;
}

__global__ void threefry2x32_kernel(const uint32_t* __restrict__ k0,
                                    const uint32_t* __restrict__ k1,
                                    const uint32_t* __restrict__ x0,
                                    const uint32_t* __restrict__ x1,
                                    uint32_t* __restrict__ y0,
                                    uint32_t* __restrict__ y1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a = x0[i], b = x1[i];
  repro::threefry2x32(k0[i], k1[i], a, b);
  y0[i] = a;
  y1[i] = b;
}

// Stage the row in shared memory when it fits the block's opt-in limit on
// this device, else gather from global memory; then launch.
template <class Draw>
cudaError_t launch_mh_chain(const float* table, const uint32_t* init, const Draw& draw,
                            uint32_t* samples, int32_t* accept, int B, int V, int C,
                            int K, uint32_t mask, void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t bytes = static_cast<size_t>(V) * sizeof(float);
  if (bytes <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(mh_chain_kernel<true, Draw>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    mh_chain_kernel<true, Draw><<<grid, kThreads, bytes, s>>>(table, init, draw, samples,
                                                             accept, B, V, C, K, mask);
  } else {
    mh_chain_kernel<false, Draw><<<grid, kThreads, 0, s>>>(table, init, draw, samples,
                                                          accept, B, V, C, K, mask);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_mh_chain(const float* table, const uint32_t* init, const uint32_t* flips,
                   const float* u, uint32_t* samples, int32_t* accept, int B, int V,
                   int C, int K, uint32_t mask, void* stream) {
  return launch_mh_chain(table, init, OperandDraw{flips, u}, samples, accept, B, V, C, K,
                         mask, stream);
}

int repro_mh_chain_fused(const float* table, const uint32_t* init, const uint32_t* k0c,
                         const uint32_t* k1c, const int32_t* t0c, uint32_t* samples,
                         int32_t* accept, int B, int V, int C, int K, int nbits, int cc,
                         uint32_t p_u32, uint32_t mask, void* stream) {
  return launch_mh_chain(table, init, FusedDraw{k0c, k1c, t0c, nbits, cc, p_u32}, samples,
                         accept, B, V, C, K, mask, stream);
}

int repro_threefry2x32(const uint32_t* k0, const uint32_t* k1, const uint32_t* x0,
                       const uint32_t* x1, uint32_t* y0, uint32_t* y1, int n,
                       void* stream) {
  const int threads = 256;
  threefry2x32_kernel<<<(n + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(k0, k1, x0, x1, y0, y1, n);
  return cudaGetLastError();
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
