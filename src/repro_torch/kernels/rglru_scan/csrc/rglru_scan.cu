// Hopper (sm_90a) kernel of the RG-LRU linear recurrence, bound with ctypes.
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
// sequential chunk axis.  Hopper's blocks run in parallel and in no
// order, so the sequence becomes a loop over t inside the thread: each
// thread owns one (batch, channel) pair and keeps h in a register for the
// whole sequence (h0 read and the last state written once).  Neighbouring
// threads own neighbouring channels, so every load and store of a
// timestep is coalesced.  The loads of a_t and x_t do not depend on h:
// the thread keeps the next kChunk timesteps of both in registers, issued
// before it runs the current chunk's chain of multiply-adds, so the
// loads are in flight while the chain runs.  Any S >= 0 (a decode step
// is S = 1) and any D (the last block's threads past D return at once).
//
// Bound.  At recurrentgemma-9b's prefill shape (B=4, S=512, D=4096) the
// call must read a and x and write h_all, 3 x 4 x 512 x 4096 x 4 B =
// 100.7 MB (h0 and the last state add 0.1 MB): 0.030 ms at 3.35 TB/s.
// It does 2 flops per element (8.4 MFLOP), far below any compute floor,
// so it is bound by bytes.  At a decode step (S=1, B=4) it moves 0.26 MB,
// below the launch latency.
//
// Rounding.  a*h + x is written as __fadd_rn(__fmul_rn(a, h), x) (and the
// library is built with -fmad=false): the product and the sum round
// separately, as the eager PyTorch plain version rounds them, so h_all
// and the last state equal the plain version's bit for bit, and a
// sequence split into two chained calls gives the same states.
//
// Offsets are size_t.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kChannels = 128;  // threads of a block: one channel each
constexpr int kChunk = 16;      // timesteps held in registers ahead

__global__ void __launch_bounds__(kChannels)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ x,
                      const float* __restrict__ h0,
                      float* __restrict__ out, float* __restrict__ last,
                      int seq, int dim) {
  const int d = blockIdx.x * kChannels + threadIdx.x;
  if (d >= dim) return;            // no barrier in this kernel
  const size_t row = blockIdx.y;
  const size_t base = row * (size_t)seq * (size_t)dim + (size_t)d;
  const size_t stride = (size_t)dim;
  float h = h0[row * (size_t)dim + (size_t)d];

  float an[kChunk], xn[kChunk];   // the next chunk, loaded ahead
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const bool in = i < seq;
    an[i] = in ? a[base + (size_t)i * stride] : 0.0f;
    xn[i] = in ? x[base + (size_t)i * stride] : 0.0f;
  }
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    float ac[kChunk], xc[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      ac[i] = an[i];
      xc[i] = xn[i];
    }
    const int t1 = t0 + kChunk;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool in = t1 + i < seq;
      const size_t e = base + (size_t)(t1 + i) * stride;
      an[i] = in ? a[e] : 0.0f;
      xn[i] = in ? x[e] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (t0 + i < seq) {
        h = __fadd_rn(__fmul_rn(ac[i], h), xc[i]);
        out[base + (size_t)(t0 + i) * stride] = h;
      }
    }
  }
  last[row * (size_t)dim + (size_t)d] = h;
}

}  // namespace

// a, x, out: (bsz, seq, dim); h0, last: (bsz, dim); all float32,
// contiguous.  bsz in [1, 65535], dim >= 1, seq >= 0.  Returns
// cudaGetLastError().
extern "C" int rglru_scan(const void* a, const void* x, const void* h0,
                          void* out, void* last, long long bsz,
                          long long seq, long long dim, void* stream) {
  const dim3 grid((unsigned)((dim + kChannels - 1) / kChannels),
                  (unsigned)bsz);
  rglru_scan_kernel<<<grid, kChannels, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)x, (const float*)h0, (float*)out,
      (float*)last, (int)seq, (int)dim);
  return (int)cudaGetLastError();
}
