// Checkerboard Gibbs kernel for Hopper (sm_90a).
//
// One kernel, gibbs_band_kernel<Draw, Logit>, replaces both Pallas TPU
// kernels of src/repro/kernels/gibbs/gibbs.py; the draw policy says where
// the uniforms come from:
//   * OperandDraw <- _gibbs_kernel (gibbs.py:37, launched by
//     gibbs_chain_pallas): the uniforms given as a (K, B, H, W) float32
//     operand and a per-lattice starting parity parity0[b] (randomness
//     "host" and "cim"); entries repro_gibbs_chain[_spin_glass];
//   * FusedDraw   <- _gibbs_fused_kernel (gibbs.py:136, launched by
//     gibbs_chain_pallas_fused): the uniforms drawn in-kernel from the
//     Threefry counter cipher (rng.cuh), given per-lattice key words and a
//     per-lattice absolute-step base t0b[b]; entries
//     repro_gibbs_chain_fused[_spin_glass].
// The conditional, which a Pallas kernel traces as a closure and a CUDA
// kernel must know, is the other template argument: Logit = IsingLogit
// (scalars beta, field) or SpinGlassLogit ((H, W) couplings j_right,
// j_down in global memory, and field), each with a scale multiplied in
// last: 1 for a plain model, float32(beta) for a replica of a tempered
// ladder (the JAX package's TemperedLattice computes float32(beta) *
// logit after the model's own logit).  Both keep the JAX models'
// operation order.  Every product of the model's own logit is exact, so
// only the order of the sums matters there; the scale's product is not,
// so the build must not contract it (--fmad=false).
//
// One half-sweep k of site (b, h, w), as in the Pallas kernels and in the
// plain versions repro_torch/kernels/gibbs/ref.py:
//   active = (h + w) % 2 == (s[b] + k) % 2       (s = parity0, or t0b)
//   p      = 1 / (1 + expf(-logit(state_{k-1})))   on active sites
//   next   = active ? (u < p) : state_{k-1}; flips[b, h, w] += next != state
// Spins are {0, 1}; samples and flips are written as int32.
//
// What bounds it.  OperandDraw must read the uniforms and write the
// samples, 8 bytes a site-step, and does a few dozen operations an active
// site: bound by bytes.  FusedDraw must write the samples, 4 bytes a
// site-step, and runs one Threefry-20 block (about 80 32-bit integer adds,
// rotates and xors) an active site-step: bound by integer issue, the
// samples' stores a third of that.  The design, as the TPU kernels' one
// grid step per lattice with a fori_loop over half-sweeps inside:
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
//     A grid-wide barrier in their place was slower at the fused kernel's
//     main shape.
//   * The rest of the band leaves with 16-byte streaming stores (evict
//     first) while the next half-sweep computes; samples are int32, never
//     widened.
//   * FusedDraw derives the step key once per block and half-sweep, and
//     the inactive colour draws nothing (JAX draws those values and
//     discards them: every active site's counter is unchanged).
//   * OperandDraw reads each active site's u once, by a streaming load
//     (evict first), the loads of kBatch = 4 sites issued before the first
//     is used.  No thread loads the inactive colour's u, but it shares
//     32-byte sectors with the active colour's: the whole operand crosses
//     HBM once, as its bound counts.  u takes no shared memory.  Timed on
//     the H100 and not kept (PERF.md): a bulk prefetch of the band's next
//     u into L2 (5-19 % slower at 1024 x 1024), the first batch of
//     edge-row u loaded before the halo wait (1-9 % slower), one load at
//     a time (13 % slower at 1024 x 1024) and batches of 2 or 8.
//   * The flip test.  FusedDraw's uniform is (raw >> 8) 2^-24, so u < p is
//     the exact integer test (raw >> 8) < ceil(p 2^24).  An operand u is
//     any float32, off that grid, so OperandDraw tests u < p in floats.
//     The Ising specialisation tables the flip code (threshold or p) for
//     each count of up neighbours, made by the per-site formula.
//
// Built by repro_torch/kernels/_build.py with --fmad=false and without fast
// math (expf, never __expf).  Every entry point returns a cudaError_t.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int kBandThreads = 1024;  // one block per SM
constexpr int kFlushEvery = 255;    // half-sweeps a uint8 flip count holds
constexpr int kBandSlots = 64;      // active sites a thread holds (a uint64)
constexpr int kBatch = 4;  // OperandDraw: active sites whose u loads are issued together

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

// The flip u < p as an integer test, exact for u = (raw >> 8) * 2^-24:
// p * 2^24 is exact, so u < p iff (raw >> 8) < ceil(p * 2^24).
__device__ __forceinline__ uint32_t threshold(float p) {
  return static_cast<uint32_t>(ceilf(p * 16777216.0f));
}

// IsingModel.conditional_logit: 2 (beta * (((N + S) + W) + E) + field),
// times scale last.  On {0, 1} spins the neighbour sum is exactly 2 c - 4
// for c up neighbours, so the kernel looks the flip code up in a table of
// five, made by this same scaled formula (fill_table).
struct IsingLogit {
  float beta, field, scale;
  __device__ __forceinline__ float operator()(const Nbrs& n) const {
    const float nb = ((spin(n.sn) + spin(n.ss)) + spin(n.sw)) + spin(n.se);
    return scale * (2.0f * (beta * nb + field));
  }
  template <class Draw>
  __device__ void fill_table(uint32_t* table) const {
    if (threadIdx.x < 5) {
      const uint32_t c = threadIdx.x;  // up neighbours
      table[c] = Draw::code(sigmoid((*this)(Nbrs{c > 0, c > 1, c > 2, c > 3})));
    }
  }
  template <class Draw>
  __device__ __forceinline__ uint32_t flip_code(const Nbrs& n, const uint32_t* table) const {
    return table[n.sn + n.ss + n.sw + n.se];
  }
};

// SpinGlass.fused_logit: 2 (((jr * sE + jr[w-1] * sW) + jd * sS) + jd[h-1] * sN
// + field), times scale last.  The couplings are read through L2 (8 MB at
// 1024 x 1024).
struct SpinGlassLogit {
  const float* j_right;
  const float* j_down;
  float field, scale;
  __device__ __forceinline__ float operator()(const Nbrs& n) const {
    const int at = n.h * n.W + n.w;
    const float nb = ((__ldg(j_right + at) * spin(n.se) +
                       __ldg(j_right + n.h * n.W + n.ww) * spin(n.sw)) +
                      __ldg(j_down + at) * spin(n.ss)) +
                     __ldg(j_down + n.hn * n.W + n.w) * spin(n.sn);
    return scale * (2.0f * (nb + field));
  }
  template <class Draw>
  __device__ void fill_table(uint32_t*) const {}
  template <class Draw>
  __device__ __forceinline__ uint32_t flip_code(const Nbrs& n, const uint32_t*) const {
    return Draw::code(sigmoid((*this)(n)));
  }
};

struct BandArgs {
  const int32_t* init;  // (B, H, W) {0, 1}
  int32_t* samples;     // (K, B, H, W)
  int32_t* flips;       // (B, H, W)
  int* ready;           // (lattices * bands,) zeroed: half-sweeps published
  int B, H, W, K;
  int b0, bands, rows;  // the group's first lattice; bands a lattice, rows a band
};

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

// A thread's active sites in band rows lr = lr0 + r * dr (r < nrows), in
// for_each_active's order, kBatch at a time: batch() gives the next
// kBatch slots' band row lr (-1 past the last) and column w, and moves on.
struct Slots {
  int half, dl, dj, r, jj;
  __device__ __forceinline__ explicit Slots(int W) : half((W + 1) >> 1) {
    dl = blockDim.x / half;
    dj = blockDim.x - dl * half;
    r = threadIdx.x / half;
    jj = threadIdx.x - r * half;
  }
  __device__ __forceinline__ void batch(int lr0, int nrows, int dr, int r0, int W,
                                        uint32_t parity, int (&lr)[kBatch], int (&w)[kBatch]) {
#pragma unroll
    for (int g = 0; g < kBatch; ++g) {
      const int l = lr0 + r * dr;
      const int c = static_cast<int>((parity ^ static_cast<uint32_t>(r0 + l)) & 1u) + 2 * jj;
      lr[g] = r < nrows && c < W ? l : -1;
      w[g] = c;
      r += dl;
      jj += dj;
      if (jj >= half) {
        jj -= half;
        ++r;
      }
    }
  }
};

// Where the uniforms come from.  draw.block(a, b) gives a block's state
// for lattice b: t0, the starting parity (half-sweep k updates the colour
// (t0 + k) % 2); prepare(k, key), run by thread 0 before half-sweep k
// (after the neighbours may read half-sweep k-1's edge rows); sweep(k,
// key), the draw of half-sweep k.  A site's flip is u < p, p given as
// code(p).  kBatched: update_rows walks the sites kBatch at a time and
// loads their u (Sweep::load(site), site h W + w of the plane) first;
// else it calls Sweep::flip(site, code) site by site.

// _gibbs_kernel: u[k, b, h, w] from a (K, B, H, W) float32 operand.
struct OperandDraw {
  static constexpr bool kBatched = true;
  const float* u;
  const int32_t* parity0;  // (B,)
  __device__ static __forceinline__ uint32_t code(float p) { return __float_as_uint(p); }
  struct Sweep {
    const float* uk;  // plane (k, b) of u
    __device__ __forceinline__ float load(int site) const { return __ldcs(uk + site); }
  };
  struct Block {
    const float* ub;  // plane (0, b) of u
    size_t plane;     // B H W floats: half-sweep k to k + 1
    uint32_t t0;
    __device__ void prepare(int, uint32_t (*)[2]) const {}
    __device__ __forceinline__ Sweep sweep(int k, uint32_t (*)[2]) const {
      return {ub + static_cast<size_t>(k) * plane};
    }
  };
  __device__ Block block(const BandArgs& a, int b) const {
    const size_t hw = static_cast<size_t>(a.H) * a.W;
    return {u + static_cast<size_t>(b) * hw, static_cast<size_t>(a.B) * hw,
            static_cast<uint32_t>(parity0[b])};
  }
};

// _gibbs_fused_kernel: the uniform of lattice b's site at half-sweep k is
// uniform_at(step_key(k0b[b], k1b[b], t0b[b] + k), (b % lat_b) H W + h W + w).
struct FusedDraw {
  static constexpr bool kBatched = false;
  const uint32_t* k0b;  // (B,) per-lattice key words
  const uint32_t* k1b;
  const int32_t* t0b;   // (B,) per-lattice absolute-step base
  int lat_b;
  __device__ static __forceinline__ uint32_t code(float p) { return threshold(p); }
  struct Sweep {
    uint32_t s0, s1, site0;
    __device__ __forceinline__ bool flip(int site, uint32_t code) const {
      return (repro::raw_draw(s0, s1, site0 + static_cast<uint32_t>(site), repro::kUSalt) >>
              8) < code;
    }
  };
  struct Block {
    uint32_t k0, k1, t0, site0;
    // the step key of half-sweep k into key[k % 2]
    __device__ void prepare(int k, uint32_t (*key)[2]) const {
      repro::step_key(k0, k1, t0 + static_cast<uint32_t>(k), key[k & 1][0], key[k & 1][1]);
    }
    __device__ __forceinline__ Sweep sweep(int k, uint32_t (*key)[2]) const {
      return {key[k & 1][0], key[k & 1][1], site0};
    }
  };
  __device__ Block block(const BandArgs& a, int b) const {
    const uint32_t hw = static_cast<uint32_t>(a.H) * static_cast<uint32_t>(a.W);
    return {k0b[b], k1b[b], static_cast<uint32_t>(t0b[b]),
            static_cast<uint32_t>(b % lat_b) * hw};
  }
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

// Band rows lr = lr0 + r * dr (r < nrows) of state k, from state k-1 in
// the band and halo.  An active site's vertical neighbours in the band
// have the other colour and do not change in this half-sweep; its
// horizontal ones may share its colour across an odd wrap, so each row is
// computed whole (into registers) before any of it is written.
template <class Draw, class Logit>
__device__ __forceinline__ void update_rows(const Logit& logit, const uint32_t* table,
                                            const typename Draw::Sweep& draw, uint8_t* band,
                                            const uint8_t* halo, uint8_t* cnt, int lr0,
                                            int nrows, int dr, int rows, int r0, int H, int W,
                                            uint32_t parity) {
  uint64_t bits = 0;
  const auto site_bit = [&](int lr, int h, int w, auto&& flip) {
    const int row = lr * W;
    const int ww = w == 0 ? W - 1 : w - 1, we = w == W - 1 ? 0 : w + 1;
    const Nbrs nb{lr == 0 ? halo[w] : band[row - W + w],
                  lr == rows - 1 ? halo[W + w] : band[row + W + w],
                  band[row + ww], band[row + we], h, w, h == 0 ? H - 1 : h - 1, ww, W};
    return static_cast<uint64_t>(flip(logit.template flip_code<Draw>(nb, table)));
  };
  if constexpr (Draw::kBatched) {
    // every u of a batch is loaded before the first is used: kBatch loads
    // in flight a thread where one would leave the card's latency bare
    Slots slots(W);
    for (int i0 = 0; slots.r < nrows; i0 += kBatch) {
      int lr[kBatch], w[kBatch];
      float u[kBatch];
      slots.batch(lr0, nrows, dr, r0, W, parity, lr, w);
#pragma unroll
      for (int g = 0; g < kBatch; ++g) {
        u[g] = lr[g] >= 0 ? draw.load((r0 + lr[g]) * W + w[g]) : 1.0f;
      }
#pragma unroll
      for (int g = 0; g < kBatch; ++g) {  // straight-line: a slot past the end
        const bool ok = lr[g] >= 0;       // computes site (0, 0) and is masked
        const int l = ok ? lr[g] : 0, c = ok ? w[g] : 0;
        const uint64_t bit = site_bit(l, r0 + l, c, [&](uint32_t code) {
          return u[g] < __uint_as_float(code);  // OperandDraw::code(p) = p
        });
        bits |= (ok ? bit : 0) << (i0 + g);
      }
    }
  } else {
    for_each_active(lr0, nrows, dr, r0, W, parity, [&](int i, int lr, int h, int w) {
      bits |= site_bit(lr, h, w, [&](uint32_t code) { return draw.flip(h * W + w, code); })
              << i;
    });
  }
  __syncthreads();
  for_each_active(lr0, nrows, dr, r0, W, parity, [&](int i, int lr, int, int w) {
    const int idx = lr * W + w;
    const uint8_t nv = static_cast<uint8_t>((bits >> i) & 1u);
    cnt[idx] += nv != band[idx];
    band[idx] = nv;
  });
  __syncthreads();
}

template <class Draw, class Logit>
__global__ void __launch_bounds__(kBandThreads, 1)
gibbs_band_kernel(const Logit logit, const Draw draw, const BandArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t key[2][2];  // FusedDraw: step keys of half-sweeps k and k + 1
  __shared__ uint32_t table[5];   // Ising flip codes
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
  const typename Draw::Block blk = draw.block(a, b);
  const int last = (rows - 1) * W;
  const bool vec = base % 4 == 0 && W % 4 == 0;  // 16-byte stores line up

  logit.template fill_table<Draw>(table);
  if (tid == 0) blk.prepare(0, key);
  for (int i = tid; i < n; i += T) {
    band[i] = a.init[base + i] != 0;
    cnt[i] = 0;
  }
  for (int k = 0; k < a.K; ++k) {
    const uint32_t parity = (blk.t0 + static_cast<uint32_t>(k)) & 1u;
    const int32_t* prev = k == 0 ? a.init : a.samples + static_cast<size_t>(k - 1) * plane;
    int32_t* out = a.samples + static_cast<size_t>(k) * plane + base;

    // 1. the neighbour bands' edge rows of state k-1 (published early in
    //    their half-sweep k-1, so this rarely waits)
    if (tid == 0 && k > 0) {
      wait_ready(a.ready + up_blk, k);
      wait_ready(a.ready + down_blk, k);
    }
    __syncthreads();
    const typename Draw::Sweep sweep = blk.sweep(k, key);
    for (int c = tid; c < 2 * W; c += T) {
      halo[c] = __ldcg(prev + (c < W ? up + c : down + (c - W))) != 0;
    }
    __syncthreads();

    // 2. the band's edge rows of state k, stored and published first
    update_rows<Draw>(logit, table, sweep, band, halo, cnt, 0, rows > 1 ? 2 : 1, rows - 1,
                      rows, r0, H, W, parity);
    for (int c = tid; c < W; c += T) {
      out[c] = band[c];
      out[last + c] = band[last + c];
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      publish(a.ready + blockIdx.x, k + 1);
      blk.prepare(k + 1, key);
    }

    // 3. the interior rows, while the neighbours take the edges
    if (rows > 2) {
      update_rows<Draw>(logit, table, sweep, band, halo, cnt, 1, rows - 2, 1, rows, r0, H, W,
                        parity);
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

template <class Draw, class Logit>
cudaError_t static_smem(size_t& most) {
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, gibbs_band_kernel<Draw, Logit>);
  if (attr.sharedSizeBytes > most) most = attr.sharedSizeBytes;
  return err;
}

// What the card gives the band kernel: its SMs (one block each) and the
// dynamic shared memory a block may use (the opt-in limit less the largest
// static use of the four specialisations).
cudaError_t band_capacity(int& sms, size_t& smem) {
  int dev = 0, optin = 0;
  size_t fixed = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = static_smem<OperandDraw, IsingLogit>(fixed);
  if (err == cudaSuccess) err = static_smem<OperandDraw, SpinGlassLogit>(fixed);
  if (err == cudaSuccess) err = static_smem<FusedDraw, IsingLogit>(fixed);
  if (err == cudaSuccess) err = static_smem<FusedDraw, SpinGlassLogit>(fixed);
  smem = static_cast<size_t>(optin) - fixed;
  return err;
}

// One cooperative launch of gibbs_band_kernel over `lattices` lattices
// from a.b0, a.bands bands of a.rows rows each.  Refused (an error,
// nothing run) if a band is too large for a block or the card cannot hold
// every block at once.
template <class Draw, class Logit>
cudaError_t launch_bands(const Logit& logit, const Draw& draw, const BandArgs& a,
                         int lattices, void* stream) {
  const auto kernel = gibbs_band_kernel<Draw, Logit>;
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
  Draw d = draw;
  BandArgs args = a;
  void* params[] = {&l, &d, &args};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                     dim3(kBandThreads), params, smem,
                                     static_cast<cudaStream_t>(stream));
}

BandArgs band_args(const int32_t* init, int32_t* samples, int32_t* flips, int* ready, int B,
                   int H, int W, int K, int b0, int bands, int rows) {
  return {init, samples, flips, ready, B, H, W, K, b0, bands, rows};
}

}  // namespace

extern "C" {

int repro_gibbs_chain(const int32_t* init, const float* u, const int32_t* parity0,
                      float beta, float field, float scale, int32_t* samples, int32_t* flips,
                      int* ready, int B, int H, int W, int K, int b0, int lattices, int bands,
                      int rows, void* stream) {
  return launch_bands(IsingLogit{beta, field, scale}, OperandDraw{u, parity0},
                      band_args(init, samples, flips, ready, B, H, W, K, b0, bands, rows),
                      lattices, stream);
}

int repro_gibbs_chain_spin_glass(const int32_t* init, const float* u,
                                 const int32_t* parity0, const float* j_right,
                                 const float* j_down, float field, float scale,
                                 int32_t* samples, int32_t* flips, int* ready, int B, int H,
                                 int W, int K, int b0, int lattices, int bands, int rows,
                                 void* stream) {
  return launch_bands(SpinGlassLogit{j_right, j_down, field, scale}, OperandDraw{u, parity0},
                      band_args(init, samples, flips, ready, B, H, W, K, b0, bands, rows),
                      lattices, stream);
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
                            const int32_t* t0b, float beta, float field, float scale,
                            int32_t* samples, int32_t* flips, int* ready, int B, int H, int W,
                            int K, int lat_b, int b0, int lattices, int bands, int rows,
                            void* stream) {
  return launch_bands(IsingLogit{beta, field, scale}, FusedDraw{k0b, k1b, t0b, lat_b},
                      band_args(init, samples, flips, ready, B, H, W, K, b0, bands, rows),
                      lattices, stream);
}

int repro_gibbs_chain_fused_spin_glass(const int32_t* init, const uint32_t* k0b,
                                       const uint32_t* k1b, const int32_t* t0b,
                                       const float* j_right, const float* j_down,
                                       float field, float scale, int32_t* samples,
                                       int32_t* flips, int* ready, int B, int H, int W, int K,
                                       int lat_b, int b0, int lattices, int bands, int rows,
                                       void* stream) {
  return launch_bands(SpinGlassLogit{j_right, j_down, field, scale},
                      FusedDraw{k0b, k1b, t0b, lat_b},
                      band_args(init, samples, flips, ready, B, H, W, K, b0, bands, rows),
                      lattices, stream);
}

}  // extern "C"
