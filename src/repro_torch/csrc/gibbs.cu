// Checkerboard Gibbs kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gibbs/gibbs.py:
//   * gibbs_sweep_kernel   <- _gibbs_kernel (gibbs.py:37, launched by
//     gibbs_chain_pallas): K half-sweeps with the uniforms given as a
//     (K, B, H, W) operand and a per-lattice starting parity (randomness
//     "host" and "cim"); entries repro_gibbs_chain[_spin_glass];
//   * gibbs_band_kernel    <- _gibbs_fused_kernel (gibbs.py:136, launched by
//     gibbs_chain_pallas_fused): the uniforms drawn in-kernel from the
//     Threefry counter cipher (rng.cuh), given per-lattice key words and a
//     per-lattice absolute-step base t0b; entries
//     repro_gibbs_chain_fused[_spin_glass].
// The conditional, which a Pallas kernel traces as a closure and a CUDA
// kernel must know, is a template argument: Logit = IsingLogit (scalars
// beta, field) or SpinGlassLogit ((H, W) couplings j_right, j_down in
// global memory, and field).  Both keep the JAX models' operation order;
// every product in them is exact, so only the order of the sums matters.
//
// One half-sweep k of site (b, h, w), as in the Pallas kernels and in the
// plain version repro_torch/kernels/gibbs/ref.py:
//   active = (h + w) % 2 == parity_k   (parity0[b] + k, or t0b[b] + k, mod 2)
//   p      = 1 / (1 + expf(-logit(state_{k-1})))   on active sites
//   next   = active ? (u < p) : state_{k-1}; flips[b, h, w] += next != state
// Spins are {0, 1}; samples and flips are written as int32.
//
// gibbs_sweep_kernel (operand uniforms).  It must read the uniforms and
// write the samples, 8 bytes per site-step, and does a few dozen
// operations per site: bound by bytes.  One launch per half-sweep, one
// thread per site, reading state k-1 from device memory (init for k = 0)
// and writing every site of state k; never updating in place keeps odd
// periodic lattices right.  Kept simple: its path is set by the torch
// draw of the uniforms, not by the kernel.
//
// gibbs_band_kernel (fused draw).  It must write the samples, 4 bytes per
// site-step, and runs one Threefry-20 block (about 80 32-bit integer
// adds, rotates and xors) per active site-step: bound by integer issue,
// the samples' stores a third of that.  The design, as the TPU kernel's
// one grid step per lattice with a fori_loop over half-sweeps inside:
//   * One cooperative launch per call (per group of lattices that fits the
//     card), 1,024 threads a block, one block per SM.  Block (i, j) owns
//     band j (rows [j R, j R + R)) of lattice b0 + i and loops over all K
//     half-sweeps itself.
//   * The band's spins (one byte a site) and its flip counts (one byte a
//     site, flushed to device memory every 255 half-sweeps and at the end)
//     live in shared memory for the whole call: 2 R W bytes plus two halo
//     rows, at most 227 KB, so a band holds about 116,000 sites and a
//     lattice at most 132 bands (the per-lattice limit; the wrapper
//     splits the batch into groups and raises past it).  These layout
//     rules are written here only: repro_gibbs_band_limits reports the
//     most rows a band of a given width may have, and launch_bands
//     refuses more.
//   * A half-sweep computes the whole active colour from state k-1 into
//     registers (one bit per site, at most 64 sites a thread) before any
//     site is written, so every neighbour is read from state k-1: odd
//     periodic lattices, where two neighbours across the wrap share a
//     colour, stay right.
//   * Only the band-edge rows cross blocks, and the output carries them:
//     the two neighbour rows of state k-1 are read from samples[k-1] (init
//     for k = 0) through L2.  A band writes its two edge rows of state k,
//     then raises its ready flag to k + 1 (release); a band starts
//     half-sweep k when both neighbour bands' flags reach k (acquire).
//     A grid-wide barrier in their place was slower at the main shape.
//   * The rest of the band leaves with 16-byte streaming stores (evict
//     first) while the next half-sweep computes; samples are int32, never
//     widened.
//   * The step key is derived once per block and half-sweep, and the
//     inactive colour draws nothing (JAX draws those values and discards
//     them: every active site's counter is unchanged).
//
// Built by repro_torch/kernels/_build.py with --fmad=false and without fast
// math (expf, never __expf).  Every entry point returns a cudaError_t.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;       // gibbs_sweep_kernel
constexpr int kBandThreads = 1024;  // gibbs_band_kernel: one block per SM
constexpr int kFlushEvery = 255;    // half-sweeps a uint8 flip count holds
constexpr int kBandSlots = 64;      // active sites a band thread holds (a uint64)

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float spin(uint32_t word) {
  return 2.0f * static_cast<float>(word) - 1.0f;
}

// A site's four periodic neighbours' spin words, and where the site sits
// in its row-major (H, W) plane: row h, column w, the row above hn and
// the column to the west ww (for the couplings).
struct Nbrs {
  uint32_t sn, ss, sw, se;
  int h, w, hn, ww, W;
};

// The flip u < p as an integer test, exact: u = (raw >> 8) * 2^-24 and
// p * 2^24 is exact, so u < p iff (raw >> 8) < ceil(p * 2^24).
__device__ __forceinline__ uint32_t threshold(float p) {
  return static_cast<uint32_t>(ceilf(p * 16777216.0f));
}

// IsingModel.conditional_logit: 2 (beta * (((N + S) + W) + E) + field).
// On {0, 1} spins the neighbour sum is exactly 2 c - 4 for c up
// neighbours, so the band kernel looks p up in a table of five
// thresholds made by this same formula (fill_table).
struct IsingLogit {
  float beta, field;
  __device__ __forceinline__ float operator()(const Nbrs& n) const {
    const float nb = ((spin(n.sn) + spin(n.ss)) + spin(n.sw)) + spin(n.se);
    return 2.0f * (beta * nb + field);
  }
  __device__ void fill_table(uint32_t* table) const {
    if (threadIdx.x < 5) {
      const uint32_t c = threadIdx.x;  // up neighbours
      table[c] = threshold(sigmoid((*this)(Nbrs{c > 0, c > 1, c > 2, c > 3})));
    }
  }
  __device__ __forceinline__ uint32_t flip_threshold(const Nbrs& n,
                                                     const uint32_t* table) const {
    return table[n.sn + n.ss + n.sw + n.se];
  }
};

// SpinGlass.fused_logit: 2 (((jr * sE + jr[w-1] * sW) + jd * sS) + jd[h-1] * sN
// + field).  The couplings are read through L2 (8 MB at 1024 x 1024).
struct SpinGlassLogit {
  const float* j_right;
  const float* j_down;
  float field;
  __device__ __forceinline__ float operator()(const Nbrs& n) const {
    const int at = n.h * n.W + n.w;
    const float nb = ((__ldg(j_right + at) * spin(n.se) +
                       __ldg(j_right + n.h * n.W + n.ww) * spin(n.sw)) +
                      __ldg(j_down + at) * spin(n.ss)) +
                     __ldg(j_down + n.hn * n.W + n.w) * spin(n.sn);
    return 2.0f * (nb + field);
  }
  __device__ void fill_table(uint32_t*) const {}
  __device__ __forceinline__ uint32_t flip_threshold(const Nbrs& n, const uint32_t*) const {
    return threshold(sigmoid((*this)(n)));
  }
};

// ---- gibbs_sweep_kernel: uniforms as a (K, B, H, W) operand ---------------

// Half-sweep k of all B lattices: grid (ceil(H*W / kThreads), B).
template <class Logit>
__global__ void __launch_bounds__(kThreads)
gibbs_sweep_kernel(const uint32_t* __restrict__ prev, uint32_t* __restrict__ next,
                   int32_t* __restrict__ flips, const Logit logit,
                   const float* __restrict__ uk, const int32_t* __restrict__ parity0,
                   int H, int W, int k) {
  const int b = blockIdx.y;
  const int hw = H * W;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const uint32_t parity = (static_cast<uint32_t>(parity0[b]) + static_cast<uint32_t>(k)) & 1u;
  const int h = i / W;
  const int w = i - h * W;
  const size_t idx = static_cast<size_t>(b) * hw + i;
  const uint32_t* lat = prev + static_cast<size_t>(b) * hw;
  const uint32_t state = lat[i];
  uint32_t nxt = state;
  if (static_cast<uint32_t>((h + w) & 1) == parity) {
    const int hn = h == 0 ? H - 1 : h - 1, hs = h == H - 1 ? 0 : h + 1;
    const int ww = w == 0 ? W - 1 : w - 1, we = w == W - 1 ? 0 : w + 1;
    const Nbrs n{lat[hn * W + w], lat[hs * W + w], lat[h * W + ww], lat[h * W + we],
                 h, w, hn, ww, W};
    nxt = uk[idx] < sigmoid(logit(n)) ? 1u : 0u;
  }
  next[idx] = nxt;
  flips[idx] = (k == 0 ? 0 : flips[idx]) + (nxt != state ? 1 : 0);
}

// K launches on the stream, half-sweep k reading state k-1 and writing
// samples[k]; stops at the first launch that fails.
template <class Logit>
cudaError_t launch_sweeps(const uint32_t* init, const float* u, const int32_t* parity0,
                          const Logit& logit, uint32_t* samples, int32_t* flips, int B,
                          int H, int W, int K, void* stream) {
  const int hw = H * W;
  const dim3 grid((hw + kThreads - 1) / kThreads, B);
  const size_t plane = static_cast<size_t>(B) * hw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < K; ++k) {
    const uint32_t* prev = k == 0 ? init : samples + static_cast<size_t>(k - 1) * plane;
    gibbs_sweep_kernel<Logit><<<grid, kThreads, 0, s>>>(
        prev, samples + static_cast<size_t>(k) * plane, flips, logit,
        u + static_cast<size_t>(k) * plane, parity0, H, W, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// ---- gibbs_band_kernel: fused draw, one persistent launch -----------------

struct BandArgs {
  const int32_t* init;  // (B, H, W) {0, 1}
  const uint32_t* k0b;  // (B,) per-lattice key words
  const uint32_t* k1b;
  const int32_t* t0b;   // (B,) per-lattice absolute-step base
  int32_t* samples;     // (K, B, H, W)
  int32_t* flips;       // (B, H, W)
  int* ready;           // (lattices * bands,) zeroed: half-sweeps published
  int B, H, W, K, lat_b;
  int b0, bands, rows;  // the group's first lattice; bands a lattice, rows a band
};

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) & ~size_t{15}; }

// Shared memory of a block: the band's spins, two halo rows, flip counts.
__host__ __device__ constexpr size_t band_smem(int rows, int W) {
  return round16(static_cast<size_t>(rows) * W) + round16(2 * static_cast<size_t>(W)) +
         static_cast<size_t>(rows) * W;
}

// The most rows a band of width W may have: its active sites fit the
// threads' result bits and its shared memory fits `smem` bytes; 0 if not
// even one row does.
int band_max_rows(int W, size_t smem) {
  const size_t halo = round16(2 * static_cast<size_t>(W));
  long long rows = static_cast<long long>(kBandSlots) * kBandThreads / ((W + 1) / 2);
  while (rows > 0 && band_smem(static_cast<int>(rows), W) > smem) {
    const long long fit =
        smem > halo ? static_cast<long long>((smem - halo) / (2 * static_cast<size_t>(W))) : 0;
    rows = fit < rows - 1 ? fit : rows - 1;
  }
  return static_cast<int>(rows > 0 ? rows : 0);
}

// Spins until a neighbour band has published half-sweep k - 1; traps
// (an error at the next synchronise, not a hung card) after ~10 s.
__device__ __forceinline__ void wait_ready(const int* flag, int k) {
  int v;
  for (long long spins = 0;; ++spins) {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
    if (v >= k) return;
    if (spins > (1LL << 28)) __trap();
    __nanosleep(32);
  }
}

__device__ __forceinline__ void publish(int* flag, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

// Calls f(i, lr, h, w) for this thread's active sites in band rows
// lr = lr0 + r * dr, r < nrows: slot s = threadIdx.x + i * blockDim.x is
// pair jj of the slot's row, site w = ((parity ^ h) & 1) + 2 jj, so that
// (h + w) % 2 == parity.
template <class F>
__device__ __forceinline__ void for_each_active(int lr0, int nrows, int dr, int r0, int W,
                                                uint32_t parity, F&& f) {
  const int half = (W + 1) >> 1;
  const int dl = blockDim.x / half, dj = blockDim.x - dl * half;
  int r = threadIdx.x / half, jj = threadIdx.x - r * half;
  for (int i = 0; r < nrows; ++i) {
    const int lr = lr0 + r * dr;
    const int h = r0 + lr;
    const int w = static_cast<int>((parity ^ static_cast<uint32_t>(h)) & 1u) + 2 * jj;
    if (w < W) f(i, lr, h, w);
    r += dl;
    jj += dj;
    if (jj >= half) {
      jj -= half;
      ++r;
    }
  }
}

// Band rows lr = lr0 + r * dr (r < nrows) of state k, from state k-1 in
// the band and halo.  An active site's vertical neighbours in the band
// have the other colour and do not change in this half-sweep; its
// horizontal ones may share its colour across an odd wrap, so each row is
// computed whole (into registers) before any of it is written.
template <class Logit>
__device__ __forceinline__ void update_rows(const Logit& logit, const uint32_t* table,
                                            uint8_t* band, const uint8_t* halo,
                                            uint8_t* cnt, int lr0, int nrows, int dr,
                                            int rows, int r0, int H, int W, uint32_t parity,
                                            uint32_t s0, uint32_t s1, uint32_t site0) {
  uint64_t bits = 0;
  for_each_active(lr0, nrows, dr, r0, W, parity, [&](int i, int lr, int h, int w) {
    const int row = lr * W;
    const int ww = w == 0 ? W - 1 : w - 1, we = w == W - 1 ? 0 : w + 1;
    const Nbrs nb{lr == 0 ? halo[w] : band[row - W + w],
                  lr == rows - 1 ? halo[W + w] : band[row + W + w],
                  band[row + ww], band[row + we], h, w, h == 0 ? H - 1 : h - 1, ww, W};
    const uint32_t m = repro::raw_draw(s0, s1, site0 + static_cast<uint32_t>(h * W + w),
                                       repro::kUSalt) >> 8;
    bits |= static_cast<uint64_t>(m < logit.flip_threshold(nb, table)) << i;
  });
  __syncthreads();
  for_each_active(lr0, nrows, dr, r0, W, parity, [&](int i, int lr, int, int w) {
    const int idx = lr * W + w;
    const uint8_t nv = static_cast<uint8_t>((bits >> i) & 1u);
    cnt[idx] += nv != band[idx];
    band[idx] = nv;
  });
  __syncthreads();
}

template <class Logit>
__global__ void __launch_bounds__(kBandThreads, 1)
gibbs_band_kernel(const Logit logit, const BandArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t key[2][2];  // step keys of half-sweeps k and k + 1
  __shared__ uint32_t table[5];   // Ising flip thresholds
  const int H = a.H, W = a.W, T = blockDim.x, tid = threadIdx.x;
  const int li = blockIdx.x / a.bands, j = blockIdx.x - li * a.bands;
  const int b = a.b0 + li;
  const int r0 = j * a.rows;
  const int rows = min(a.rows, H - r0);
  const int n = rows * W;
  uint8_t* band = smem;                                        // state k-1, then k
  uint8_t* halo = band + round16(static_cast<size_t>(a.rows) * W);  // rows above, below
  uint8_t* cnt = halo + round16(2 * static_cast<size_t>(W));   // flips since a flush
  const size_t hw = static_cast<size_t>(H) * W;
  const size_t plane = static_cast<size_t>(a.B) * hw;
  const size_t lat = static_cast<size_t>(b) * hw;
  const size_t base = lat + static_cast<size_t>(r0) * W;
  const size_t up = lat + static_cast<size_t>(r0 == 0 ? H - 1 : r0 - 1) * W;
  const size_t down = lat + static_cast<size_t>(r0 + rows == H ? 0 : r0 + rows) * W;
  const int first = li * a.bands;
  const int up_blk = first + (j == 0 ? a.bands - 1 : j - 1);
  const int down_blk = first + (j == a.bands - 1 ? 0 : j + 1);
  const uint32_t site0 = static_cast<uint32_t>(b % a.lat_b) * static_cast<uint32_t>(hw);
  const uint32_t k0 = a.k0b[b], k1 = a.k1b[b], t0 = static_cast<uint32_t>(a.t0b[b]);
  const int last = (rows - 1) * W;
  const bool vec = base % 4 == 0 && W % 4 == 0;  // 16-byte stores line up

  logit.fill_table(table);
  if (tid == 0) repro::step_key(k0, k1, t0, key[0][0], key[0][1]);
  for (int i = tid; i < n; i += T) {
    band[i] = a.init[base + i] != 0;
    cnt[i] = 0;
  }
  for (int k = 0; k < a.K; ++k) {
    const uint32_t t = t0 + static_cast<uint32_t>(k), parity = t & 1u;
    const int32_t* prev = k == 0 ? a.init : a.samples + static_cast<size_t>(k - 1) * plane;
    int32_t* out = a.samples + static_cast<size_t>(k) * plane + base;

    // 1. the neighbour bands' edge rows of state k-1 (published early in
    //    their half-sweep k-1, so this rarely waits)
    if (tid == 0 && k > 0) {
      wait_ready(a.ready + up_blk, k);
      wait_ready(a.ready + down_blk, k);
    }
    __syncthreads();
    const uint32_t s0 = key[k & 1][0], s1 = key[k & 1][1];
    for (int c = tid; c < 2 * W; c += T) {
      halo[c] = __ldcg(prev + (c < W ? up + c : down + (c - W))) != 0;
    }
    __syncthreads();

    // 2. the band's edge rows of state k, stored and published first
    update_rows(logit, table, band, halo, cnt, 0, rows > 1 ? 2 : 1, rows - 1, rows, r0, H, W,
                parity, s0, s1, site0);
    for (int c = tid; c < W; c += T) {
      out[c] = band[c];
      out[last + c] = band[last + c];
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      publish(a.ready + blockIdx.x, k + 1);
      repro::step_key(k0, k1, t + 1u, key[(k + 1) & 1][0], key[(k + 1) & 1][1]);
    }

    // 3. the interior rows, while the neighbours take the edges
    if (rows > 2) {
      update_rows(logit, table, band, halo, cnt, 1, rows - 2, 1, rows, r0, H, W, parity, s0,
                  s1, site0);
    }
    if (vec) {
      const uchar4* src = reinterpret_cast<const uchar4*>(band);
      int4* dst = reinterpret_cast<int4*>(out);
      for (int q = W / 4 + tid; q < last / 4; q += T) {
        const uchar4 v = src[q];
        __stcs(dst + q, make_int4(v.x, v.y, v.z, v.w));
      }
    } else {
      for (int i = W + tid; i < last; i += T) __stcs(out + i, static_cast<int32_t>(band[i]));
    }

    // 4. flip counts to device memory before a uint8 can overflow
    if ((k + 1) % kFlushEvery == 0 || k == a.K - 1) {
      for (int i = tid; i < n; i += T) {
        a.flips[base + i] = (k < kFlushEvery ? 0 : a.flips[base + i]) + cnt[i];
        cnt[i] = 0;
      }
    }
  }
}

// What the card gives the band kernel: its SMs (one block each) and the
// dynamic shared memory a block may use (the opt-in limit less the larger
// static use of the two specialisations).
cudaError_t band_capacity(int& sms, size_t& smem) {
  int dev = 0, optin = 0;
  cudaFuncAttributes ising{}, glass{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&ising, gibbs_band_kernel<IsingLogit>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&glass, gibbs_band_kernel<SpinGlassLogit>);
  const size_t fixed = ising.sharedSizeBytes > glass.sharedSizeBytes ? ising.sharedSizeBytes
                                                                      : glass.sharedSizeBytes;
  smem = static_cast<size_t>(optin) - fixed;
  return err;
}

// One cooperative launch of gibbs_band_kernel over `lattices` lattices
// from b0, `bands` bands of `rows` rows each.  Refused (an error, nothing
// run) if a band is too large for a block or the card cannot hold every
// block at once.
template <class Logit>
cudaError_t launch_bands(const Logit& logit, const BandArgs& a, int lattices, void* stream) {
  const auto kernel = gibbs_band_kernel<Logit>;
  int sms = 0, per_sm = 0;
  size_t avail = 0;
  cudaError_t err = band_capacity(sms, avail);
  if (err != cudaSuccess) return err;
  if (a.rows < 1 || a.bands < 1 || a.rows > band_max_rows(a.W, avail))
    return cudaErrorInvalidValue;
  const size_t smem = band_smem(a.rows, a.W);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBandThreads, smem);
  if (err != cudaSuccess) return err;
  const int blocks = lattices * a.bands;
  if (blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  Logit l = logit;
  BandArgs args = a;
  void* params[] = {&l, &args};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                     dim3(kBandThreads), params, smem,
                                     static_cast<cudaStream_t>(stream));
}

BandArgs band_args(const int32_t* init, const uint32_t* k0b, const uint32_t* k1b,
                   const int32_t* t0b, int32_t* samples, int32_t* flips, int* ready, int B,
                   int H, int W, int K, int lat_b, int b0, int bands, int rows) {
  return {init, k0b, k1b, t0b, samples, flips, ready, B, H, W, K, lat_b, b0, bands, rows};
}

}  // namespace

extern "C" {

int repro_gibbs_chain(const uint32_t* init, const float* u, const int32_t* parity0,
                      float beta, float field, uint32_t* samples, int32_t* flips, int B,
                      int H, int W, int K, void* stream) {
  return launch_sweeps(init, u, parity0, IsingLogit{beta, field}, samples, flips, B, H, W,
                       K, stream);
}

int repro_gibbs_chain_spin_glass(const uint32_t* init, const float* u,
                                 const int32_t* parity0, const float* j_right,
                                 const float* j_down, float field, uint32_t* samples,
                                 int32_t* flips, int B, int H, int W, int K, void* stream) {
  return launch_sweeps(init, u, parity0, SpinGlassLogit{j_right, j_down, field}, samples,
                       flips, B, H, W, K, stream);
}

// What the band kernel can take on the current device for lattices W
// sites wide: out[0] SMs (a lattice group may have one band a SM), out[1]
// the most rows a band may have (band_max_rows), out[2] whether the device
// launches cooperative kernels.
int repro_gibbs_band_limits(int W, int* out) {
  size_t avail = 0;
  int dev = 0;
  cudaError_t err = band_capacity(out[0], avail);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  out[1] = W >= 1 ? band_max_rows(W, avail) : 0;
  return err;
}

int repro_gibbs_chain_fused(const int32_t* init, const uint32_t* k0b, const uint32_t* k1b,
                            const int32_t* t0b, float beta, float field, int32_t* samples,
                            int32_t* flips, int* ready, int B, int H, int W, int K,
                            int lat_b, int b0, int lattices, int bands, int rows,
                            void* stream) {
  return launch_bands(IsingLogit{beta, field},
                      band_args(init, k0b, k1b, t0b, samples, flips, ready, B, H, W, K,
                                lat_b, b0, bands, rows),
                      lattices, stream);
}

int repro_gibbs_chain_fused_spin_glass(const int32_t* init, const uint32_t* k0b,
                                       const uint32_t* k1b, const int32_t* t0b,
                                       const float* j_right, const float* j_down,
                                       float field, int32_t* samples, int32_t* flips,
                                       int* ready, int B, int H, int W, int K, int lat_b,
                                       int b0, int lattices, int bands, int rows,
                                       void* stream) {
  return launch_bands(SpinGlassLogit{j_right, j_down, field},
                      band_args(init, k0b, k1b, t0b, samples, flips, ready, B, H, W, K,
                                lat_b, b0, bands, rows),
                      lattices, stream);
}

}  // extern "C"
