// Hopper (sm_90a) kernel of the legacy per-message DANA-Zero master round,
// bound with ctypes.
//
// dana_master_update replaces the TPU kernel
//   src/repro/kernels/dana_update/kernel.py::dana_master_update_2d
// and computes exactly ref.py::dana_master_update_ref over one contiguous
// leaf of n elements, in float32 or bfloat16:
//   v'  = gamma * v + g            (worker i's momentum)
//   v0' = (v0 - v) + v'            (the O(1) running-sum update)
//   th' = theta - lr * v'
//   hat = th' - lrg * v0'          (the look-ahead view sent back)
// with lrg = lr * gamma formed ONCE on the host in the leaf's type (as
// the JAX reference forms it from scalars of the leaf's dtype).
//
// Design.  One elementwise pass, out of place like the JAX kernel:
// 4 reads (theta, v, v0, g) and 4 writes (th', v', v0', hat).  The TPU
// kernel tiled (R, 128) rows through VMEM and needed every leaf padded to
// whole rows; here a float32 leaf of any length runs as float4 vectors
// (one 16-byte access per stream per thread, grid-stride) when all eight
// pointers are 16-byte aligned, with a scalar tail for the last n % 4
// elements (the whole leaf, if a pointer is not aligned).  bfloat16
// leaves run one element per thread.
//
// Bound: device-memory bytes, 8 * n * sizeof(T) per call; 7 operations
// per element are far below the card's operations-per-byte balance.
//
// Rounding.  Built without --use_fast_math and with -fmad=false: every
// a*b+c rounds twice, as the eager PyTorch plain version computes it, so
// float32 results equal the plain version bit for bit.  For bfloat16
// every operation is computed in float32 and rounded to bfloat16, as
// PyTorch rounds its bfloat16 elementwise operations.
//
// Offsets are size_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 8192;

struct Scalars {
  float lr, gamma, lrg;
};

__device__ __forceinline__ float rnd(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// one element of the round; every operation rounded to the leaf's type
__device__ __forceinline__ void round1(float th, float vi, float s0, float g,
                                       Scalars s, bool bf16, float* o) {
  const float vn = rnd(rnd(s.gamma * vi, bf16) + g, bf16);
  const float s0n = rnd(rnd(s0 - vi, bf16) + vn, bf16);
  const float thn = rnd(th - rnd(s.lr * vn, bf16), bf16);
  o[0] = thn;
  o[1] = vn;
  o[2] = s0n;
  o[3] = rnd(thn - rnd(s.lrg * s0n, bf16), bf16);
}

__global__ void dana_f32_kernel(const float* __restrict__ th,
                                const float* __restrict__ vi,
                                const float* __restrict__ v0,
                                const float* __restrict__ g,
                                float* __restrict__ th_o,
                                float* __restrict__ vi_o,
                                float* __restrict__ v0_o,
                                float* __restrict__ hat_o, size_t n,
                                size_t n4, Scalars s) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t e = tid; e < n4; e += stride) {
    const float4 a = reinterpret_cast<const float4*>(th)[e];
    const float4 b = reinterpret_cast<const float4*>(vi)[e];
    const float4 c = reinterpret_cast<const float4*>(v0)[e];
    const float4 d = reinterpret_cast<const float4*>(g)[e];
    float o0[4], o1[4], o2[4], o3[4];
    round1(a.x, b.x, c.x, d.x, s, false, o0);
    round1(a.y, b.y, c.y, d.y, s, false, o1);
    round1(a.z, b.z, c.z, d.z, s, false, o2);
    round1(a.w, b.w, c.w, d.w, s, false, o3);
    reinterpret_cast<float4*>(th_o)[e] = make_float4(o0[0], o1[0], o2[0], o3[0]);
    reinterpret_cast<float4*>(vi_o)[e] = make_float4(o0[1], o1[1], o2[1], o3[1]);
    reinterpret_cast<float4*>(v0_o)[e] = make_float4(o0[2], o1[2], o2[2], o3[2]);
    reinterpret_cast<float4*>(hat_o)[e] = make_float4(o0[3], o1[3], o2[3], o3[3]);
  }
  // the scalar tail (n % 4 elements; all of them when a pointer is not
  // 16-byte aligned and n4 == 0)
  for (size_t e = 4 * n4 + tid; e < n; e += stride) {
    float o[4];
    round1(th[e], vi[e], v0[e], g[e], s, false, o);
    th_o[e] = o[0];
    vi_o[e] = o[1];
    v0_o[e] = o[2];
    hat_o[e] = o[3];
  }
}

__global__ void dana_bf16_kernel(const __nv_bfloat16* __restrict__ th,
                                 const __nv_bfloat16* __restrict__ vi,
                                 const __nv_bfloat16* __restrict__ v0,
                                 const __nv_bfloat16* __restrict__ g,
                                 __nv_bfloat16* __restrict__ th_o,
                                 __nv_bfloat16* __restrict__ vi_o,
                                 __nv_bfloat16* __restrict__ v0_o,
                                 __nv_bfloat16* __restrict__ hat_o, size_t n,
                                 Scalars s) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    float o[4];
    round1(__bfloat162float(th[e]), __bfloat162float(vi[e]),
           __bfloat162float(v0[e]), __bfloat162float(g[e]), s, true, o);
    th_o[e] = __float2bfloat16_rn(o[0]);
    vi_o[e] = __float2bfloat16_rn(o[1]);
    v0_o[e] = __float2bfloat16_rn(o[2]);
    hat_o[e] = __float2bfloat16_rn(o[3]);
  }
}

int blocks_for(size_t items) {
  size_t b = (items + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// dtype: 0 float32, 1 bfloat16.  n: elements of the leaf (> 0).  The
// scalars are the leaf type's values, passed as float.  Returns
// cudaGetLastError().
extern "C" int dana_master_update(int dtype, const void* theta,
                                  const void* v_i, const void* v0,
                                  const void* g, void* theta_out,
                                  void* v_i_out, void* v0_out, void* hat_out,
                                  long long n, float lr, float gamma,
                                  float lrg, void* stream) {
  const Scalars s{lr, gamma, lrg};
  const size_t len = (size_t)n;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const bool vec = aligned16(theta) && aligned16(v_i) && aligned16(v0) &&
                     aligned16(g) && aligned16(theta_out) &&
                     aligned16(v_i_out) && aligned16(v0_out) &&
                     aligned16(hat_out);
    const size_t n4 = vec ? len / 4 : 0;
    const size_t items = n4 > len - 4 * n4 ? n4 : len - 4 * n4;
    dana_f32_kernel<<<blocks_for(items), kThreads, 0, st>>>(
        (const float*)theta, (const float*)v_i, (const float*)v0,
        (const float*)g, (float*)theta_out, (float*)v_i_out, (float*)v0_out,
        (float*)hat_out, len, n4, s);
  } else if (dtype == 1) {
    dana_bf16_kernel<<<blocks_for(len), kThreads, 0, st>>>(
        (const __nv_bfloat16*)theta, (const __nv_bfloat16*)v_i,
        (const __nv_bfloat16*)v0, (const __nv_bfloat16*)g,
        (__nv_bfloat16*)theta_out, (__nv_bfloat16*)v_i_out,
        (__nv_bfloat16*)v0_out, (__nv_bfloat16*)hat_out, len, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
