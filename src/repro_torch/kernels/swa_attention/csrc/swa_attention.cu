// Hopper (sm_90a) kernel of causal sliding-window flash attention, bound
// with ctypes.
//
// swa_attention replaces the TPU kernel
//   src/repro/kernels/swa_attention/kernel.py::swa_attention_pallas
// and computes ref.py::swa_attention_ref: for q (B, S, H, hd) and k, v
// (B, S, K, hd) with K dividing H (GQA; query head h reads kv head
// h / (H/K)), each query at position i attends to the keys j with
// i - window < j <= i, softmax(q.k / sqrt(hd)) v, in float32, with the
// output in the inputs' type (float32 or bfloat16).
//
// Design.  The TPU kernel ran a grid (B*H, S/128) over K/V already
// repeated to H heads, held whole K/V rows in VMEM and visited the band's
// kv blocks with a fori_loop.  Here one block of 128 threads owns a tile
// of kBq = 32 queries of one (batch, head) and visits only the kv tiles of
// kBk = 32 keys that meet its band [q0 - window + 1, q0 + 31], so the work
// is O(S * window), not O(S^2).  The kv head is read in place: GQA needs
// no repeated K/V.  The query tile (scaled by 1/sqrt(hd) as it is loaded,
// as kernel.py scales it) and each K and V tile go through shared memory
// as float32; rows are padded by one float so the score loop's reads
// fall in distinct banks.  Per kv tile:
//   scores  each thread computes a 2 x 4 micro-tile of the 32 x 32 score
//           tile (rows rg, rg+16; columns cg + 8j), masks it (key after
//           the query, outside the window or past S: -1e30) and stores
//           it in shared memory;
//   softmax each warp owns 8 query rows; a lane per key column, warp
//           shuffles for the row max and sum; the running max m and sum
//           l live in registers (every lane of the warp holds its rows');
//   PV      each warp scales its rows' accumulators by exp(m_old - m_new)
//           and adds P V: lane L owns dims L, L+32, ... of its 8 rows,
//           so the V reads are conflict-free and the P reads broadcast.
// The output is acc / max(l, 1e-30), as kernel.py writes it.  Any S >= 1
// (the last tile masks its rows and keys past S), head_dim up to 256 (the
// template's HD is the next of 32, 64, 128, 256; dims past hd are zero).
// Tensor cores, TMA and wgmma are later work: this first kernel runs its
// products on the CUDA cores.
//
// Bound.  FLOPs = 4 * B * H * hd * (number of (query, key) pairs in the
// band): at recurrentgemma-9b's prefill (B=4, S=512, H=16, hd=256, window
// 2048 >= S, so plain causal: 131,328 pairs per head) 8.6 GFLOP, 0.0087
// ms at the dense bf16 tensor-core rate of 989 TFLOP/s; bytes (q, k, v
// read once, o written once; MQA, K = 1) 18.9 MB in bf16, 0.0056 ms at
// 3.35 TB/s.  At B=1, S=3072, window 2048 (4.2M pairs per head): 68.7
// GFLOP, 0.069 ms.  Operations bound it; on the CUDA cores (67 TFLOP/s
// of float32) the floor is 15x higher, and shared-memory traffic
// (about two loads per multiply-add in the score loop) is this kernel's
// real limit.
//
// Offsets are size_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kBq = 32;         // queries per block
constexpr int kBk = 32;         // keys per kv tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int HD>
struct Smem {                        // sizes in floats
  static constexpr int kQ = kBq * (HD + 1);
  static constexpr int kK = kBk * (HD + 1);
  static constexpr int kV = kBk * HD;
  static constexpr int kP = kBq * (kBk + 1);
  static constexpr size_t kBytes = (size_t)(kQ + kK + kV + kP) *
                                   sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         int seq, int heads, int kv_heads, int hd,
                         int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBq][HD + 1], scaled
  float* ks = qs + Smem<HD>::kQ;           // [kBk][HD + 1]
  float* vs = ks + Smem<HD>::kK;           // [kBk][HD]
  float* ps = vs + Smem<HD>::kV;           // [kBq][kBk + 1]
  constexpr int kDims = HD / 32;           // dims per lane in PV

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const size_t q_stride = (size_t)heads * hd;      // one position of q, o
  const size_t kv_stride = (size_t)kv_heads * hd;  // one position of k, v
  const T* qb = q + b * (size_t)seq * q_stride + (size_t)h * hd;
  const T* kb = k + b * (size_t)seq * kv_stride + (size_t)kh * hd;
  const T* vb = v + b * (size_t)seq * kv_stride + (size_t)kh * hd;
  T* ob = o + b * (size_t)seq * q_stride + (size_t)h * hd;

  for (int i = tid; i < kBq * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    qs[r * (HD + 1) + d] =
        (s < seq && d < hd) ? to_f32(qb[(size_t)s * q_stride + d]) * scale
                            : 0.0f;
  }

  float m[8], l[8], acc[8][kDims];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[r][j] = 0.0f;
  }

  const int q_last = min(q0 + kBq, seq) - 1;
  const int k_first = max(0, q0 - window + 1);
  const int rg = tid / 8, cg = tid % 8;    // score micro-tile

  for (int k0 = (k_first / kBk) * kBk; k0 <= q_last; k0 += kBk) {
    __syncthreads();   // the previous tile is consumed (the Q tile written)
    for (int i = tid; i < kBk * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int s = k0 + r;
      const bool in = s < seq && d < hd;
      const size_t e = (size_t)s * kv_stride + d;
      ks[r * (HD + 1) + d] = in ? to_f32(kb[e]) : 0.0f;
      vs[r * HD + d] = in ? to_f32(vb[e]) : 0.0f;
    }
    __syncthreads();

    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[2], kv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) qv[i] = qs[(rg + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 8 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = __fmaf_rn(qv[i], kv[j],
                                                         sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 8 * j;
        const bool ok = kj < seq && kj <= qi && qi - kj < window;
        ps[(rg + 16 * i) * (kBk + 1) + cg + 8 * j] = ok ? sc[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over this tile: warp w owns rows 8w .. 8w+7
    float corr[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* prow = ps + (warp * 8 + r) * (kBk + 1);
      const float sv = prow[lane];
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = expf(sv - m_new);
      corr[r] = expf(m[r] - m_new);
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), warp_sum(p));
      m[r] = m_new;
      prow[lane] = p;
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[r][j] = __fmul_rn(acc[r][j],
                                                            corr[r]);
#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float pv[8], vv[kDims];
#pragma unroll
      for (int r = 0; r < 8; ++r) pv[r] = ps[(warp * 8 + r) * (kBk + 1) + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) vv[j] = vs[c * HD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[r][j] = __fmaf_rn(pv[r], vv[j],
                                                              acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int s = q0 + warp * 8 + r;
    if (s >= seq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) store(ob + (size_t)s * q_stride + d, acc[r][j] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           long long bsz, long long seq, long long heads, long long kv_heads,
           long long hd, long long window, cudaStream_t st) {
  auto kern = swa_attention_kernel<T, HD>;
  const size_t smem = Smem<HD>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((seq + kBq - 1) / kBq), (unsigned)heads,
                  (unsigned)bsz);
  const float scale = 1.0f / sqrtf((float)hd);
  kern<<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)seq, (int)heads,
      (int)kv_heads, (int)hd, (int)window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             long long bsz, long long seq, long long heads,
             long long kv_heads, long long hd, long long window,
             cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, bsz, seq, heads, kv_heads, hd, window,
                         st);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, bsz, seq, heads, kv_heads, hd, window,
                         st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, bsz, seq, heads, kv_heads, hd,
                          window, st);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, o, bsz, seq, heads, kv_heads, hd,
                          window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: (bsz, seq, heads, hd); k, v: (bsz, seq, kv_heads, hd); contiguous,
// all float32 (dtype 0) or all bfloat16 (dtype 1).  bsz and heads in
// [1, 65535], seq >= 1, kv_heads divides heads, 1 <= hd <= 256,
// 1 <= window <= seq.  Returns cudaGetLastError() (cudaErrorInvalidValue
// for another dtype or hd).
extern "C" int swa_attention(const void* q, const void* k, const void* v,
                             void* o, long long bsz, long long seq,
                             long long heads, long long kv_heads,
                             long long hd, long long window, int dtype,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, bsz, seq, heads, kv_heads, hd,
                           window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, bsz, seq, heads, kv_heads,
                                   hd, window, st);
  return (int)cudaErrorInvalidValue;
}
