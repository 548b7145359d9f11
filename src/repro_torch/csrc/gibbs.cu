// Checkerboard Gibbs kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gibbs/gibbs.py
// with one kernel, gibbs_sweep_kernel<Logit, Draw>, that differs only in
// where each half-sweep's uniforms come from:
//   * Draw = OperandDraw  <- _gibbs_kernel (gibbs.py:37, launched by
//     gibbs_chain_pallas): K half-sweeps with the uniforms given as a
//     (K, B, H, W) operand and a per-lattice starting parity (randomness
//     "host" and "cim"); entries repro_gibbs_chain[_spin_glass];
//   * Draw = FusedDraw    <- _gibbs_fused_kernel (gibbs.py:136, launched
//     by gibbs_chain_pallas_fused): the uniforms drawn in-kernel from the
//     Threefry counter cipher (rng.cuh), given per-lattice key words and a
//     per-lattice absolute-step base t0b; entries
//     repro_gibbs_chain_fused[_spin_glass].
// and in the conditional, which a Pallas kernel traces as a closure and a
// CUDA kernel must know: Logit = IsingLogit (scalars beta, field) or
// SpinGlassLogit ((H, W) couplings j_right, j_down in global memory, and
// field).  Both keep the JAX models' operation order; every product in
// them is exact, so only the order of the sums matters.
//
// One half-sweep k of site (b, h, w), as in the Pallas kernels and in the
// plain version repro_torch/kernels/gibbs/ref.py:
//   active = (h + w) % 2 == parity_k   (parity0[b] + k, or t0b[b] + k, mod 2)
//   p      = 1 / (1 + expf(-logit(state_{k-1})))   on active sites
//   next   = active ? (u < p) : state_{k-1}; flips[b, h, w] += next != state
//
// What bounds them on this card.  The OperandDraw kernel must read the
// uniforms and write the samples, 8 bytes per site-step, and does a few
// dozen operations per site: it is bound by bytes.  The FusedDraw kernel
// must write only the samples, 4 bytes per site-step, but runs one
// Threefry-20 block (about 80 integer operations) per active site-step: it
// is bound by 32-bit integer ALU work.
//
// Why the first design is simple.  A half-sweep reads neighbours across
// the whole lattice, so no block can own a 1024 x 1024 lattice the way one
// TPU grid step does.  Each launch does one half-sweep of all B lattices,
// one thread per site, reading state k-1 (init for k = 0) and writing
// every site of state k; the C entry point launches it K times on the
// stream.  Never updating in place keeps odd periodic lattices right, where
// two neighbours across the wrap share a colour.  The fused kernel skips
// the cipher on the inactive colour (JAX draws those values and discards
// them: every active site's counter is unchanged) and computes the step
// key once per block.  No bit-packed spins, no shared-memory tile with
// halo, no persistent kernel across half-sweeps: speed is later work.
//
// Built by repro_torch/kernels/_build.py with --fmad=false and without fast
// math (expf, never __expf).  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float spin(uint32_t word) {
  return 2.0f * static_cast<float>(word) - 1.0f;
}

// The four periodic neighbours of site (h, w) in a row-major (H, W) plane.
struct Nbrs {
  int h, w, hn, hs, ww, we, W;
  __device__ __forceinline__ int at(int hh, int ww_) const { return hh * W + ww_; }
};

// IsingModel.conditional_logit: 2 (beta * (((N + S) + W) + E) + field).
struct IsingLogit {
  float beta, field;
  __device__ __forceinline__ float operator()(const uint32_t* lat, const Nbrs& n) const {
    const float nb = ((spin(lat[n.at(n.hn, n.w)]) + spin(lat[n.at(n.hs, n.w)])) +
                      spin(lat[n.at(n.h, n.ww)])) +
                     spin(lat[n.at(n.h, n.we)]);
    return 2.0f * (beta * nb + field);
  }
};

// SpinGlass.fused_logit: 2 (((jr * sE + jr[w-1] * sW) + jd * sS) + jd[h-1] * sN
// + field).
struct SpinGlassLogit {
  const float* j_right;
  const float* j_down;
  float field;
  __device__ __forceinline__ float operator()(const uint32_t* lat, const Nbrs& n) const {
    const float nb =
        ((j_right[n.at(n.h, n.w)] * spin(lat[n.at(n.h, n.we)]) +
          j_right[n.at(n.h, n.ww)] * spin(lat[n.at(n.h, n.ww)])) +
         j_down[n.at(n.h, n.w)] * spin(lat[n.at(n.hs, n.w)])) +
        j_down[n.at(n.hn, n.w)] * spin(lat[n.at(n.hn, n.w)]);
    return 2.0f * (nb + field);
  }
};

// Where half-sweep k's parity and uniforms come from.  step(b, k, hw) is
// called by every thread of a block (all of one lattice b) before any
// returns; the step it gives yields the active colour and, per site, u.

// _gibbs_kernel: uniforms are a (K, B, H, W) operand.
struct OperandDraw {
  const float* u;
  const int32_t* parity0;
  size_t plane;  // B * H * W
  struct Step {
    const float* uk;
    uint32_t parity;
    __device__ __forceinline__ float uniform(size_t idx, int) const { return uk[idx]; }
  };
  __device__ __forceinline__ Step step(int b, int k, int) const {
    const uint32_t parity =
        (static_cast<uint32_t>(parity0[b]) + static_cast<uint32_t>(k)) & 1u;
    return {u + static_cast<size_t>(k) * plane, parity};
  }
};

// _gibbs_fused_kernel: step t0b[b] + k (mod 2^32) of lattice b's key at
// site (b % lat_b) * H * W + h * W + w, so lattices folded chain-major
// into the batch keep their streams.  Thread 0 derives the step key.
struct FusedDraw {
  const uint32_t* k0b;
  const uint32_t* k1b;
  const int32_t* t0b;
  int lat_b;
  struct Step {
    uint32_t s0, s1, parity, site0;
    __device__ __forceinline__ float uniform(size_t, int i) const {
      return repro::uniform_at(s0, s1, site0 + static_cast<uint32_t>(i));
    }
  };
  __device__ __forceinline__ Step step(int b, int k, int hw) const {
    __shared__ uint32_t key[2];
    const uint32_t t = static_cast<uint32_t>(t0b[b]) + static_cast<uint32_t>(k);
    if (threadIdx.x == 0) repro::step_key(k0b[b], k1b[b], t, key[0], key[1]);
    __syncthreads();
    const uint32_t site0 = static_cast<uint32_t>(b % lat_b) * static_cast<uint32_t>(hw);
    return {key[0], key[1], t & 1u, site0};
  }
};

// Half-sweep k of all B lattices: grid (ceil(H*W / kThreads), B).
template <class Logit, class Draw>
__global__ void __launch_bounds__(kThreads)
gibbs_sweep_kernel(const uint32_t* __restrict__ prev, uint32_t* __restrict__ next,
                   int32_t* __restrict__ flips, const Logit logit, const Draw draw,
                   int H, int W, int k) {
  const int b = blockIdx.y;
  const int hw = H * W;
  const auto step = draw.step(b, k, hw);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const int h = i / W;
  const int w = i - h * W;
  const size_t idx = static_cast<size_t>(b) * hw + i;
  const uint32_t* lat = prev + static_cast<size_t>(b) * hw;
  const uint32_t state = lat[i];
  uint32_t nxt = state;
  if (static_cast<uint32_t>((h + w) & 1) == step.parity) {
    const Nbrs n{h, w, h == 0 ? H - 1 : h - 1, h == H - 1 ? 0 : h + 1,
                 w == 0 ? W - 1 : w - 1, w == W - 1 ? 0 : w + 1, W};
    const float p = sigmoid(logit(lat, n));
    nxt = step.uniform(idx, i) < p ? 1u : 0u;
  }
  next[idx] = nxt;
  flips[idx] = (k == 0 ? 0 : flips[idx]) + (nxt != state ? 1 : 0);
}

// K launches on the stream, half-sweep k reading state k-1 and writing
// samples[k]; stops at the first launch that fails.
template <class Logit, class Draw>
cudaError_t launch_gibbs(const uint32_t* init, const Logit& logit, const Draw& draw,
                         uint32_t* samples, int32_t* flips, int B, int H, int W, int K,
                         void* stream) {
  const int hw = H * W;
  const dim3 grid((hw + kThreads - 1) / kThreads, B);
  const size_t plane = static_cast<size_t>(B) * hw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < K; ++k) {
    const uint32_t* prev = k == 0 ? init : samples + static_cast<size_t>(k - 1) * plane;
    gibbs_sweep_kernel<Logit, Draw><<<grid, kThreads, 0, s>>>(
        prev, samples + static_cast<size_t>(k) * plane, flips, logit, draw, H, W, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

OperandDraw operand_draw(const float* u, const int32_t* parity0, int B, int H, int W) {
  return {u, parity0, static_cast<size_t>(B) * H * W};
}

}  // namespace

extern "C" {

int repro_gibbs_chain(const uint32_t* init, const float* u, const int32_t* parity0,
                      float beta, float field, uint32_t* samples, int32_t* flips, int B,
                      int H, int W, int K, void* stream) {
  return launch_gibbs(init, IsingLogit{beta, field}, operand_draw(u, parity0, B, H, W),
                      samples, flips, B, H, W, K, stream);
}

int repro_gibbs_chain_spin_glass(const uint32_t* init, const float* u,
                                 const int32_t* parity0, const float* j_right,
                                 const float* j_down, float field, uint32_t* samples,
                                 int32_t* flips, int B, int H, int W, int K, void* stream) {
  return launch_gibbs(init, SpinGlassLogit{j_right, j_down, field},
                      operand_draw(u, parity0, B, H, W), samples, flips, B, H, W, K,
                      stream);
}

int repro_gibbs_chain_fused(const uint32_t* init, const uint32_t* k0b, const uint32_t* k1b,
                            const int32_t* t0b, float beta, float field, uint32_t* samples,
                            int32_t* flips, int B, int H, int W, int K, int lat_b,
                            void* stream) {
  return launch_gibbs(init, IsingLogit{beta, field}, FusedDraw{k0b, k1b, t0b, lat_b},
                      samples, flips, B, H, W, K, stream);
}

int repro_gibbs_chain_fused_spin_glass(const uint32_t* init, const uint32_t* k0b,
                                       const uint32_t* k1b, const int32_t* t0b,
                                       const float* j_right, const float* j_down,
                                       float field, uint32_t* samples, int32_t* flips,
                                       int B, int H, int W, int K, int lat_b,
                                       void* stream) {
  return launch_gibbs(init, SpinGlassLogit{j_right, j_down, field},
                      FusedDraw{k0b, k1b, t0b, lat_b}, samples, flips, B, H, W, K,
                      stream);
}

}  // extern "C"
