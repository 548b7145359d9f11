// Fused Metropolis-Hastings chain kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/mh/mh.py with
// one kernel, mh_chain_kernel<kShared, Draw>, that differs only in where
// each step's flip word and uniform come from:
//   * Draw = OperandDraw   <- _mh_kernel (mh.py:35, launched by
//     mh_chain_pallas): K MH steps with the flip words and uniforms given
//     as operands (randomness "host" and "cim"); entry repro_mh_chain;
//   * Draw = FusedDraw<NB> <- _mh_fused_kernel (mh.py:125, launched by
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
// Words cross as the port holds them: init, flips, k0c, k1c and t0c are
// int64 tensors of uint32 values (only the low 32 bits are read), and the
// samples are written as int64 uint32 values, so a wrapper call is this
// kernel's launch and nothing else.
//
// What bounds it on this card.  OperandDraw moves 20 bytes per chain-step
// (an 8-byte flip word and a 4-byte uniform in, an 8-byte sample out) plus
// the table row once, and does a handful of operations per step: it is
// bound by bytes.  FusedDraw moves 8 bytes per chain-step (the sample) and
// needs nbits + 1 Threefry-20 blocks per chain-step of which only x0 is
// kept (one per flip bit-plane, one for the uniform; about 67 integer
// operations each), plus a step key that the rows of a column share: it is
// bound by 32-bit integer ALU work.  The kernel derives the step key in
// every chain-step's fill (nbits + 2 blocks).
//
// What the design does about it.  A chain is serial in its state, but its
// draws are not: they depend only on (column, step, row).  So a block of
// 1,024 threads takes one table row b and a tile of Ct chains (a power of
// two, at most 128, chosen at launch so the grid fills the SMs), and walks
// K in step tiles of Kt = 1024 / Ct steps, double-buffered in shared
// memory:
//   * fill: every thread takes one (step, chain) item of the next tile and
//     writes its flip word and uniform there.  Under FusedDraw it derives
//     the step key and runs the flip bit-planes unrolled (NB = 8, 16, 18 at
//     compile time, else a loop unrolled by 4), so independent Threefry
//     blocks are in flight; the word is built in one thread, bit i from
//     plane i, exactly as the plain version builds it.  Under OperandDraw
//     the fill is cp.async copies of the (Kt, 1, Ct) slab of the operands,
//     issued before the walk so they land while it runs;
//   * walk: thread c < Ct runs chain c through the current tile: lookup,
//     accept, select, one coalesced 8-byte store of each step's state.
//     Under FusedDraw the walk goes first and the walkers' fill share
//     after it, while the other 28+ warps fill; one __syncthreads a tile.
//   * the table row is staged in shared memory when the row and the tiles
//     fit the block's opt-in limit (V = 49,155 float32 is 196,620 bytes;
//     the tiles take 24,576): one thread issues the TMA's bulk copy
//     (cp.async.bulk, completion on an mbarrier) of the row's 16-byte
//     aligned interior while the first tile fills, the at most 3 + 3 ragged
//     floats at its ends are plain loads, and the row sits in shared memory
//     at its global address's offset modulo 16 (a row starts 16-byte
//     aligned only when 4 b V is a multiple of 16).  The walkers wait on
//     the mbarrier before their first lookup.  A longer row (V = 256,000
//     is 1 MB) is gathered from global memory through the L1 and L2.
//
// Built by repro_torch/kernels/_build.py with --fmad=false and without fast
// math (expf, never __expf).  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int kThreads = 1024;     // threads a block; one block per SM
constexpr int kItems = 1024;       // (step, chain) items a tile: Kt x Ct
constexpr int kMaxChainLog = 7;    // Ct at most 128 chains
constexpr int kMinChainLog = 3;    // spread below 128 chains down to 8
constexpr float kFlush = 1.17549435e-38f;  // 2^-126, the least normal float
constexpr uint32_t kBulkPiece = 65536;     // bytes of one bulk copy

// One tile of draws: item i = kk * Ct + cc is step kbase + kk of chain cc.
struct Tile {
  unsigned long long flip[kItems];  // the low 32 bits are the flip word
  float u[kItems];
};
constexpr int kTilesBytes = 2 * static_cast<int>(sizeof(Tile));  // 24,576
constexpr int kBarOffset = kTilesBytes;                          // the mbarrier
constexpr int kRowOffset = kTilesBytes + 16;  // + (row address mod 16)

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kShared>
__device__ __forceinline__ float lookup(const float* __restrict__ row,
                                        const float* srow, uint32_t w,
                                        uint32_t vocab) {
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

// The row's staging: the 16-byte aligned interior by the TMA's bulk copy,
// completing on the mbarrier `bar`; the ragged head and tail by plain
// loads (visible after the block's next __syncthreads).
__device__ void stage_row(const float* __restrict__ row, float* srow, int V, uint32_t bar) {
  const uint32_t mis = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(row) & 15u);
  int head = static_cast<int>(((16u - mis) & 15u) / 4u);
  if (head > V) head = V;
  const int body = ((V - head) / 4) * 4;  // floats in whole 16-byte pieces
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(body) * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    for (uint32_t off = 0; off < bytes; off += kBulkPiece) {
      const uint32_t n = bytes - off < kBulkPiece ? bytes - off : kBulkPiece;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(srow + head) + off),
             "l"(reinterpret_cast<const char*>(row + head) + off), "r"(n), "r"(bar)
          : "memory");
    }
  }
  const int t = static_cast<int>(threadIdx.x);
  if (t < head) srow[t] = row[t];
  if (t >= 32 && t - 32 < V - head - body) srow[head + body + t - 32] = row[head + body + t - 32];
}

__device__ __forceinline__ void wait_row(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar) : "memory");
  }
}

// Where the (step, chain) items of a tile come from.  fill(tile, k, b, c,
// i) writes item i, step k of chain (b, c); kAsync says whether fill only
// issues copies that wait() completes.

// _mh_kernel: the flip words and uniforms are (K, B, C) operands, copied
// by cp.async (8 and 4 bytes an item).
struct OperandDraw {
  static constexpr bool kAsync = true;
  const unsigned long long* flips;
  const float* u;
  int B, C;
  __device__ __forceinline__ void fill(Tile& t, int k, int b, int c, int i) const {
    const size_t idx = (static_cast<size_t>(k) * B + b) * C + c;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(smem_addr(&t.flip[i])), "l"(flips + idx) : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_addr(&t.u[i])), "l"(u + idx) : "memory");
  }
  __device__ __forceinline__ void commit() const {
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  __device__ __forceinline__ void wait() const {
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
};

// _mh_fused_kernel: step t0c[c] + k (mod 2^32) of column c's key at site
// b * cc + c % cc, so chains folded chain-major into the columns keep
// their streams.  NB is nbits when known at compile time, else 0.
template <int NB>
struct FusedDraw {
  static constexpr bool kAsync = false;
  const unsigned long long* k0c;
  const unsigned long long* k1c;
  const unsigned long long* t0c;
  int nbits, cc;
  uint32_t p_u32;
  __device__ __forceinline__ void fill(Tile& t, int k, int b, int c, int i) const {
    const uint32_t site = static_cast<uint32_t>(b) * static_cast<uint32_t>(cc) +
                          static_cast<uint32_t>(c % cc);
    uint32_t s0, s1;
    repro::step_key(static_cast<uint32_t>(__ldg(k0c + c)),
                    static_cast<uint32_t>(__ldg(k1c + c)),
                    static_cast<uint32_t>(__ldg(t0c + c)) + static_cast<uint32_t>(k),
                    s0, s1);
    t.flip[i] = repro::flips_at<NB>(s0, s1, site, nbits, p_u32);
    t.u[i] = repro::uniform_at(s0, s1, site);
  }
  __device__ __forceinline__ void commit() const {}
  __device__ __forceinline__ void wait() const {}
};

// Fill this thread's items of the tile at step kbase.
template <class Draw>
__device__ __forceinline__ void fill_tile(const Draw& draw, Tile& t, int kbase, int K,
                                          int b, int C, int c0, int lct) {
  for (int i = threadIdx.x; i < kItems; i += kThreads) {
    const int kk = i >> lct;
    const int c = c0 + (i & ((1 << lct) - 1));
    if (kk < K - kbase && c < C) draw.fill(t, kbase + kk, b, c, i);
  }
  draw.commit();
}

// Block (x, b): chains [x Ct, (x + 1) Ct) of row b, Ct = 2^lct.
template <bool kShared, class Draw>
__global__ void __launch_bounds__(kThreads, 1)
mh_chain_kernel(const float* __restrict__ table, const unsigned long long* __restrict__ init,
                const Draw draw, unsigned long long* __restrict__ samples,
                int32_t* __restrict__ accept, int B, int V, int C, int K, int lct,
                uint32_t mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile* tiles = reinterpret_cast<Tile*>(smem);
  const uint32_t bar = smem_addr(smem + kBarOffset);
  const int b = blockIdx.y;
  const int ct = 1 << lct;
  const int kt = kItems >> lct;
  const int c0 = blockIdx.x * ct;
  const int tid = threadIdx.x;
  const float* row = table + static_cast<size_t>(b) * V;
  float* srow = reinterpret_cast<float*>(
      smem + kRowOffset + (reinterpret_cast<uintptr_t>(row) & 15u));

  if (kShared) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    stage_row(row, srow, V, bar);
  }
  fill_tile(draw, tiles[0], 0, K, b, C, c0, lct);
  draw.wait();
  __syncthreads();

  const uint32_t vocab = static_cast<uint32_t>(V);
  const int c = c0 + tid;
  const bool walker = tid < ct && c < C;
  const size_t bc = static_cast<size_t>(b) * C + c;
  const size_t plane = static_cast<size_t>(B) * C;
  uint32_t state = 0;
  float logp = 0.0f;
  int32_t acc = 0;
  if (walker) {
    if (kShared) wait_row(bar);
    state = static_cast<uint32_t>(init[bc]);
    logp = lookup<kShared>(row, srow, state, vocab);
  }
  const int tiles_k = K == 0 ? 0 : (K - 1) / kt + 1;
  for (int tk = 0; tk < tiles_k; ++tk) {
    const int kbase = tk * kt, buf = tk & 1;
    const bool next = tk + 1 < tiles_k;
    if (Draw::kAsync && next) fill_tile(draw, tiles[buf ^ 1], kbase + kt, K, b, C, c0, lct);
    if (walker) {
      const Tile& t = tiles[buf];
      const int n = K - kbase < kt ? K - kbase : kt;
      for (int kk = 0; kk < n; ++kk) {
        const int i = (kk << lct) + tid;
        const uint32_t cand = state ^ (static_cast<uint32_t>(t.flip[i]) & mask);
        const float lc = lookup<kShared>(row, srow, cand, vocab);
        if (accept_test(t.u[i], lc, logp)) {
          state = cand;
          logp = lc;
          ++acc;
        }
        samples[static_cast<size_t>(kbase + kk) * plane + bc] = state;
      }
    }
    if (!Draw::kAsync && next) fill_tile(draw, tiles[buf ^ 1], kbase + kt, K, b, C, c0, lct);
    draw.wait();
    __syncthreads();
  }
  if (walker) accept[bc] = acc;
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

// The chain tile: no wider than C needs, then halved (down to 8 chains)
// while the grid would still fit one block per SM.
int chain_tile_log(int B, int C, int sms) {
  int lct = kMaxChainLog;
  while (lct > 0 && (1 << (lct - 1)) >= C) --lct;
  while (lct > kMinChainLog) {
    const long long blocks = static_cast<long long>(B) * ((C + (1 << (lct - 1)) - 1) >> (lct - 1));
    if (blocks > sms) break;
    --lct;
  }
  return lct;
}

// The current device's SM count and the longest row the kernel stages in
// shared memory beside its tiles (the block's opt-in limit).
cudaError_t device_limits(int& sms, int& staged_vocab) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  staged_vocab = (optin - kRowOffset - 16) / 4;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

// Stage the row in shared memory when it and the tiles fit the block's
// opt-in limit on this device, else gather from global memory; then launch.
template <class Draw>
cudaError_t launch_mh_chain(const float* table, const unsigned long long* init,
                            const Draw& draw, unsigned long long* samples, int32_t* accept,
                            int B, int V, int C, int K, uint32_t mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0, staged_vocab = 0;
  cudaError_t err = device_limits(sms, staged_vocab);
  if (err != cudaSuccess) return err;
  const int lct = chain_tile_log(B, C, sms);
  const dim3 grid((C + (1 << lct) - 1) >> lct, B);
  if (V <= staged_vocab) {
    const int shared = kRowOffset + 16 + V * 4;
    err = cudaFuncSetAttribute(mh_chain_kernel<true, Draw>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return err;
    mh_chain_kernel<true, Draw><<<grid, kThreads, shared, s>>>(
        table, init, draw, samples, accept, B, V, C, K, lct, mask);
  } else {
    mh_chain_kernel<false, Draw><<<grid, kThreads, kRowOffset, s>>>(
        table, init, draw, samples, accept, B, V, C, K, lct, mask);
  }
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_fused(const float* table, const unsigned long long* init,
                         const unsigned long long* k0c, const unsigned long long* k1c,
                         const unsigned long long* t0c, unsigned long long* samples,
                         int32_t* accept, int B, int V, int C, int K, int nbits, int cc,
                         uint32_t p_u32, uint32_t mask, void* stream) {
  return launch_mh_chain(table, init, FusedDraw<NB>{k0c, k1c, t0c, nbits, cc, p_u32},
                         samples, accept, B, V, C, K, mask, stream);
}

}  // namespace

extern "C" {

int repro_mh_chain(const float* table, const unsigned long long* init,
                   const unsigned long long* flips, const float* u,
                   unsigned long long* samples, int32_t* accept, int B, int V, int C, int K,
                   uint32_t mask, void* stream) {
  return launch_mh_chain(table, init, OperandDraw{flips, u, B, C}, samples, accept, B, V, C,
                         K, mask, stream);
}

// nbits 8 (the gmm workload), 16 (granite-3's vocab) and 18 (minitron's)
// draw their flip planes fully unrolled; any other width unrolled by 4.
// On the H100 the full unroll took 1.2-2.5 % less device time than the
// loop unrolled by 4 at each of these widths (PERF.md).
int repro_mh_chain_fused(const float* table, const unsigned long long* init,
                         const unsigned long long* k0c, const unsigned long long* k1c,
                         const unsigned long long* t0c, unsigned long long* samples,
                         int32_t* accept, int B, int V, int C, int K, int nbits, int cc,
                         uint32_t p_u32, uint32_t mask, void* stream) {
  switch (nbits) {
    case 8:
      return launch_fused<8>(table, init, k0c, k1c, t0c, samples, accept, B, V, C, K, nbits,
                             cc, p_u32, mask, stream);
    case 16:
      return launch_fused<16>(table, init, k0c, k1c, t0c, samples, accept, B, V, C, K, nbits,
                              cc, p_u32, mask, stream);
    case 18:
      return launch_fused<18>(table, init, k0c, k1c, t0c, samples, accept, B, V, C, K, nbits,
                              cc, p_u32, mask, stream);
    default:
      return launch_fused<0>(table, init, k0c, k1c, t0c, samples, accept, B, V, C, K, nbits,
                             cc, p_u32, mask, stream);
  }
}

// The longest row (V) the kernel stages in shared memory on the current
// device; a longer row is gathered from global memory.
int repro_mh_staged_vocab(int* out) {
  int sms = 0;
  return device_limits(sms, *out);
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
