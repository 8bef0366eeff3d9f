// Hopper (sm_90a) kernels of the RG-LRU linear recurrence, bound with ctypes.
//
// rglru_scan replaces the TPU kernel
//   src/repro/kernels/rglru_scan/kernel.py::rglru_scan_pallas
// and computes ref.py::rglru_scan_ref in float32:
//   h_t = a_t * h_{t-1} + x_t
// for a, x (B, S, D) and h0 (B, D), giving every state h_all (B, S, D)
// and the last one (B, D).
//
// Design.  The TPU kernel ran a grid (B, D/128, S/128) in order on one
// core and kept the (1, 128) state tile in VMEM scratch across the
// sequential chunk axis.  Here every (batch, channel) chain stays one
// sequential loop in t, run by one lane that keeps h in a register for
// the whole sequence (h0 read and the last state written once); the
// parallelism comes from the B*D chains alone.  A chunk-parallel scan
// (products of a combined across chunks) would round differently, so
// there is none.
//
//   Tile     a block owns 32 adjacent channels of one batch row: one
//            128-byte row of a, of x and of h_all per timestep.  Grid
//            (ceil(D / 32), B): 512 blocks at (4, 512, 4096) and 128 at
//            the long prompt (1, 3072, 4096), where a 128-channel tile
//            would leave 100 of the 132 SMs idle.
//   Warps    a block is 4 warps.  Warp 0 runs the 32 chains; warps 1-3
//            move the data, so the memory instructions issue from three
//            of the SM's four schedulers and the chain's warp issues
//            none.  On an H100 one warp a tile doing both (a 12-stage
//            ring, 44 KB in flight) ran the long prompt at 51 % of its
//            bound (PERF.md §6), and a deeper ring did not help: one
//            warp's copies and 128-byte stores issue too slowly.
//   Staging  the sequence goes in stages of kSteps = 32 timesteps (8 KB
//            of a and x) through a ring of kStages = 4 in shared memory:
//            while warp 0 runs stage s, stages s+1 .. s+3 are in flight
//            (24 KB a block), copied with cp.async (16-byte pieces when D
//            is a multiple of 4 and a, x and h_all are 16-byte aligned,
//            one float a thread otherwise).  Warp 0 writes each h_t to a
//            double buffer in shared memory; warps 1-3 write stage s-1's
//            h_all rows out (float4 or one float a thread) while warp 0
//            runs stage s.  One barrier a stage: each copying thread
//            waits for its own copies of stage s (cp.async.wait_group 2)
//            before it, so after it stage s has landed, stage s-1's
//            states are in shared memory and the buffers the next copies
//            and states go to are free.  40 KB of shared memory a block.
//   Chain    a lane reads its column of the stage (conflict-free), all
//            32 steps' a and x into registers first, then runs the 32
//            dependent multiply-adds.
//   Decode   S = 1 takes a second kernel with no staging: one thread a
//            float4 of (B, D) (a float when D is not a multiple of 4 or
//            a pointer is not 16-byte aligned), writing h_all's one row
//            and the last state.
// Any S >= 0 (S = 0 writes the last state = h0) and any D: a tile's
// channels past D stage and store nothing.
//
// Bound: bytes.  The call must read a and x and write h_all, 12*B*S*D
// bytes, plus h0 and the last state, 8*B*D: at (4, 512, 4096) 100.8 MB,
// 0.0301 ms at 3.35 TB/s; at (1, 3072, 4096) 151.0 MB, 0.0451 ms; at a
// decode step (4, 1, 4096) 0.33 MB, 0.0001 ms, below the launch
// latency.  2 flops an element: far below any compute floor.  The chain
// itself is a dependent FMUL and FADD a step, about 8 cycles: 3072 steps
// take 12.4 us at 1.98 GHz, under the long prompt's bytes bound of 45 us.
//
// Rounding.  a*h + x is written as __fadd_rn(__fmul_rn(a, h), x) (and the
// library is built with -fmad=false): the product and the sum round
// separately, as the eager PyTorch plain version rounds them, so h_all
// and the last state equal the plain version's bit for bit, and a
// sequence split into two chained calls gives the same states.
//
// Variants.  Two macros build the alternatives the design was chosen
// against, for scripts/rglru_variants.py, which times them beside the
// shipped build; the package builds neither:
//   RGLRU_CHAIN_WARPS=W  a 32*W-channel tile, W chain warps and the same
//                        three copying warps, stages of 32/W timesteps
//                        (the same 8 KB a stage);
//   RGLRU_TMA=1          the aligned path's stages copied by TMA bulk
//                        copies (cp.async.bulk, one per row of a and of
//                        x, issued by one thread), each stage completing
//                        on its own mbarrier, in place of cp.async.
//
// Offsets are size_t.
#include <cuda_runtime.h>
#include <stddef.h>

#ifndef RGLRU_CHAIN_WARPS
#define RGLRU_CHAIN_WARPS 1
#endif
#ifndef RGLRU_TMA
#define RGLRU_TMA 0
#endif

namespace {

constexpr int kLanes = 32 * RGLRU_CHAIN_WARPS;  // channels a block
constexpr int kMovers = 96;              // the copying warps' threads
constexpr int kThreads = kLanes + kMovers;
constexpr int kSteps = 32 / RGLRU_CHAIN_WARPS;  // timesteps a stage
constexpr int kStages = 4;               // stages in the ring
constexpr int kStageFloats = kSteps * kLanes;
constexpr int kRowVec = kLanes / 4;      // float4 a stage row
constexpr int kStepThreads = 256;        // the decode kernel's block

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- TMA bulk copies and mbarriers (the RGLRU_TMA variant) ----------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(float* smem, const float* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread: stage rows t0 .. t0+kSteps-1 (those below seq) of a and x
// into sa / sx by bulk copies of 4*min(left, kLanes) bytes each (a
// multiple of 16 on the aligned path), completing on bar.
__device__ __forceinline__ void stage_bulk(float* sa, float* sx,
                                           const float* __restrict__ a,
                                           const float* __restrict__ x,
                                           size_t base, size_t dim, int t0,
                                           int seq, int left,
                                           unsigned long long* bar) {
  const int rows = seq - t0 < kSteps ? seq - t0 : kSteps;
  const unsigned row_bytes = 4u * (unsigned)(left < kLanes ? left : kLanes);
  // the buffer was last read by the chain warps (generic proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, 2u * (unsigned)rows * row_bytes);
  for (int r = 0; r < rows; ++r) {
    const size_t e = base + (size_t)(t0 + r) * dim;
    bulk_copy(sa + r * kLanes, a + e, row_bytes, bar);
    bulk_copy(sx + r * kLanes, x + e, row_bytes, bar);
  }
}

// The copying warps (m = threadIdx.x - kLanes in [0, 96)): copy stage
// rows t0 .. t0+kSteps-1 (those below seq) of the tile into sa / sx (row
// r at r*kLanes).  base: the offset of (row, t=0, d0); left: channels of
// the tile below D.
template <bool kVec>
__device__ __forceinline__ void stage_copy(float* sa, float* sx,
                                           const float* __restrict__ a,
                                           const float* __restrict__ x,
                                           size_t base, size_t dim, int t0,
                                           int seq, int left, int m) {
  if (kVec) {            // kRowVec float4 a row
    for (int f = m; f < kSteps * kRowVec; f += kMovers) {
      const int r = f / kRowVec, q = (f % kRowVec) * 4;
      if (t0 + r < seq && q < left) {
        const size_t e = base + (size_t)(t0 + r) * dim + (size_t)q;
        cp_async16(sa + r * kLanes + q, a + e);
        cp_async16(sx + r * kLanes + q, x + e);
      }
    }
  } else {
    for (int f = m; f < kStageFloats; f += kMovers) {
      const int r = f / kLanes, c = f % kLanes;
      if (t0 + r < seq && c < left) {
        const size_t e = base + (size_t)(t0 + r) * dim + (size_t)c;
        cp_async4(sa + r * kLanes + c, a + e);
        cp_async4(sx + r * kLanes + c, x + e);
      }
    }
  }
}

// The copying warps: write the states of stage rows t0 .. (hb, row r at
// r*kLanes) to h_all.
template <bool kVec>
__device__ __forceinline__ void stage_store(const float* hb,
                                            float* __restrict__ out,
                                            size_t base, size_t dim, int t0,
                                            int seq, int left, int m) {
  if (kVec) {
    for (int f = m; f < kSteps * kRowVec; f += kMovers) {
      const int r = f / kRowVec, q = (f % kRowVec) * 4;
      if (t0 + r < seq && q < left)
        *reinterpret_cast<float4*>(out + base + (size_t)(t0 + r) * dim +
                                   (size_t)q) =
            *reinterpret_cast<const float4*>(hb + r * kLanes + q);
    }
  } else {
    for (int f = m; f < kStageFloats; f += kMovers) {
      const int r = f / kLanes, c = f % kLanes;
      if (t0 + r < seq && c < left)
        out[base + (size_t)(t0 + r) * dim + (size_t)c] = hb[r * kLanes + c];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ x,
                      const float* __restrict__ h0, float* __restrict__ out,
                      float* __restrict__ last, int seq, int dim) {
  __shared__ __align__(16) float sa[kStages * kStageFloats];
  __shared__ __align__(16) float sx[kStages * kStageFloats];
  __shared__ __align__(16) float hb[2 * kStageFloats];
  // the TMA variant's aligned path: one mbarrier a ring buffer
  constexpr bool kBulk = RGLRU_TMA && kVec;
  __shared__ __align__(8) unsigned long long bar[kStages];
  const int d0 = blockIdx.x * kLanes, left = dim - d0;
  const size_t row = blockIdx.y, stride = (size_t)dim;
  const size_t base = row * (size_t)seq * stride + (size_t)d0;
  const bool chain = threadIdx.x < kLanes;     // the chain warps
  const int lane = threadIdx.x, m = threadIdx.x - kLanes;
  float h = chain && lane < left ? h0[row * stride + (size_t)(d0 + lane)]
                                 : 0.0f;
  const int nst = (seq + kSteps - 1) / kSteps;
  if (kBulk) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bar + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // prologue: stages 0 .. kStages-2, one commit group each (empty past
  // the sequence and in the chain warps, so the group count stays
  // uniform)
  for (int s = 0; s < kStages - 1; ++s) {
    if (kBulk) {
      if (m == 0 && s < nst)
        stage_bulk(sa + s * kStageFloats, sx + s * kStageFloats, a, x, base,
                   stride, s * kSteps, seq, left, bar + s);
    } else if (!chain && s < nst) {
      stage_copy<kVec>(sa + s * kStageFloats, sx + s * kStageFloats, a, x,
                       base, stride, s * kSteps, seq, left, m);
    }
    cp_async_commit();
  }
  int buf = 0;                                // s % kStages
  for (int s = 0; s < nst; ++s) {
    if (kBulk)
      mbar_wait(bar + buf, (unsigned)(s / kStages) & 1u);
    else
      cp_async_wait<kStages - 2>();           // this thread's stage s
    __syncthreads();
    if (chain) {
      const float* ca = sa + buf * kStageFloats + lane;
      const float* cx = sx + buf * kStageFloats + lane;
      float* hw = hb + (s & 1) * kStageFloats + lane;
      const int t0 = s * kSteps;
      if (t0 + kSteps <= seq) {
        float av[kSteps], xv[kSteps];
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          av[i] = ca[i * kLanes];
          xv[i] = cx[i * kLanes];
        }
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          h = __fadd_rn(__fmul_rn(av[i], h), xv[i]);
          hw[i * kLanes] = h;
        }
      } else {
        for (int i = 0; i < seq - t0; ++i) {
          h = __fadd_rn(__fmul_rn(ca[i * kLanes], h), cx[i * kLanes]);
          hw[i * kLanes] = h;
        }
      }
    } else {
      if (s > 0)
        stage_store<kVec>(hb + ((s - 1) & 1) * kStageFloats, out, base,
                          stride, (s - 1) * kSteps, seq, left, m);
      const int nxt = s + kStages - 1;        // into buffer (s-1) % kStages
      const int nbuf = buf == 0 ? kStages - 1 : buf - 1;
      if (kBulk) {
        if (m == 0 && nxt < nst)
          stage_bulk(sa + nbuf * kStageFloats, sx + nbuf * kStageFloats, a,
                     x, base, stride, nxt * kSteps, seq, left, bar + nbuf);
      } else if (nxt < nst) {
        stage_copy<kVec>(sa + nbuf * kStageFloats, sx + nbuf * kStageFloats,
                         a, x, base, stride, nxt * kSteps, seq, left, m);
      }
    }
    cp_async_commit();
    buf = buf == kStages - 1 ? 0 : buf + 1;
  }
  cp_async_wait<0>();
  __syncthreads();                            // the last stage's states
  if (!chain && nst > 0)
    stage_store<kVec>(hb + ((nst - 1) & 1) * kStageFloats, out, base, stride,
                      (nst - 1) * kSteps, seq, left, m);
  if (chain && lane < left) last[row * stride + (size_t)(d0 + lane)] = h;
}

// One decode step (S = 1): element i of (B, D), or float4 i with kVec.
template <bool kVec>
__global__ void __launch_bounds__(kStepThreads)
    rglru_scan_step_kernel(const float* __restrict__ a,
                      const float* __restrict__ x,
                      const float* __restrict__ h0, float* __restrict__ out,
                      float* __restrict__ last, size_t n) {
  const size_t i = (size_t)blockIdx.x * kStepThreads + threadIdx.x;
  if (i >= n) return;
  if (kVec) {
    const float4 av = reinterpret_cast<const float4*>(a)[i];
    const float4 xv = reinterpret_cast<const float4*>(x)[i];
    float4 h = reinterpret_cast<const float4*>(h0)[i];
    h.x = __fadd_rn(__fmul_rn(av.x, h.x), xv.x);
    h.y = __fadd_rn(__fmul_rn(av.y, h.y), xv.y);
    h.z = __fadd_rn(__fmul_rn(av.z, h.z), xv.z);
    h.w = __fadd_rn(__fmul_rn(av.w, h.w), xv.w);
    reinterpret_cast<float4*>(out)[i] = h;
    reinterpret_cast<float4*>(last)[i] = h;
  } else {
    const float h = __fadd_rn(__fmul_rn(a[i], h0[i]), x[i]);
    out[i] = h;
    last[i] = h;
  }
}

}  // namespace

// a, x, out: (bsz, seq, dim); h0, last: (bsz, dim); all float32,
// contiguous.  bsz in [1, 65535], dim >= 1, seq >= 0.  vec: dim % 4 == 0
// and a, x, h0, out and last 16-byte aligned (16-byte copies, float4
// stores and steps).  seq == 1 takes the step kernel.  Returns
// cudaGetLastError().
extern "C" int rglru_scan(const void* a, const void* x, const void* h0,
                          void* out, void* last, long long bsz,
                          long long seq, long long dim, int vec,
                          void* stream) {
  const float* pa = (const float*)a;
  const float* px = (const float*)x;
  const float* ph = (const float*)h0;
  float* po = (float*)out;
  float* pl = (float*)last;
  cudaStream_t s = (cudaStream_t)stream;
  if (seq == 1) {
    const size_t n = (size_t)bsz * (size_t)dim / (vec ? 4 : 1);
    const unsigned blocks = (unsigned)((n + kStepThreads - 1) / kStepThreads);
    if (vec)
      rglru_scan_step_kernel<true>
          <<<blocks, kStepThreads, 0, s>>>(pa, px, ph, po, pl, n);
    else
      rglru_scan_step_kernel<false>
          <<<blocks, kStepThreads, 0, s>>>(pa, px, ph, po, pl, n);
  } else {
    const dim3 grid((unsigned)((dim + kLanes - 1) / kLanes), (unsigned)bsz);
    if (vec)
      rglru_scan_kernel<true><<<grid, kThreads, 0, s>>>(pa, px, ph, po, pl,
                                                        (int)seq, (int)dim);
    else
      rglru_scan_kernel<false><<<grid, kThreads, 0, s>>>(pa, px, ph, po, pl,
                                                         (int)seq, (int)dim);
  }
  return (int)cudaGetLastError();
}
