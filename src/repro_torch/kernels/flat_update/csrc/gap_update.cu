// Hopper (sm_90a) kernel of the gap-aware master update (ga-asgd), bound
// with ctypes.
//
// gap_update replaces the TPU kernel
//   src/repro/kernels/flat_update/kernel.py::gap_master_update_1
// chained k times by ::flat_master_update_batch_gap, and computes the
// gap-aware branch of ref.py::flat_master_update_batch_ref: k worker
// messages applied IN ORDER to the flat master state theta (R,128), the
// momentum slab v (N,R,128), the sent-snapshot slab (N,R,128) and the
// scalar avg_step.  For message j from worker i:
//
//   gap     = sqrt(sum((theta - sent_i)^2)) / sqrt_p        (pass 1)
//   penalty = 1 + gap / max(avg_step, 1e-12)
//   v_i'    = gamma * v_i + cg * ((1/vs) * ((1/penalty) * g_j))
//   theta'  = ((-lr) * vs) * v_i' + theta;  sent_i' = hat_j = theta'
//   avg_step' = ema * avg_step + (1-ema) * (lr*vs) * ||v_i'|| / sqrt_p
//
// Design.  Every element of message j's update needs the global norm of
// theta - sent_i first, and avg_step needs the norm of v_i' after.  The
// TPU kernel carried the partial sums in SMEM from one grid step to the
// next; Hopper's blocks run in no order and share nothing, so each
// message is three launches on one stream:
//   1. gap_norm: a fixed grid of G blocks (G depends only on R), each a
//      grid-stride float4 loop summing (theta - sent_i)^2, reduced in a
//      fixed order (thread, warp shuffle, block) into partial1[b];
//   2. gap_apply: every block first sums partial1[0..G) in the same
//      fixed order, so all blocks agree on the gap bit for bit, reads
//      avg_step from device memory, applies the penalised update to its
//      float4s (theta, v_i, sent_i, the hat, and theta before the update
//      when telemetry is on) and writes its ||v_i'||^2 partial;
//   3. gap_finish: one block sums partial2 and writes avg_step.
// No float atomics: a run is bit-reproducible, so the deterministic
// cluster equals the engine's kernel run bit for bit.  avg_step never
// leaves the device.  A worker that appears twice in a batch chains on
// its own update, because message j+1's launches follow message j's.
//
// Bound: device-memory bytes.  The least one message must move, each
// input read once and each output written once, is theta in/out, v_i
// and sent_i in/out, g_j in and the hat out [+ pre]: 4*R*128*(8 [+1])
// bytes, 807 MB at R = 197,000 (0.241 ms at 3.35 TB/s).  The two passes
// read theta twice: pass 1 reads theta and sent_i, pass 2 reads theta,
// v_i and g_j and writes theta, v_i, sent_i and the hat, 4*R*128*(2 + 7
// [+1 telemetry: pre]) bytes, 908 MB (0.271 ms).  theta (100.9 MB) does
// not fit in the 50 MB L2, so pass 2 reads it again from device memory;
// a fused design that overlaps message j+1's pass 1 with message j's
// pass 2 would save that read (later work).  About a dozen f32
// operations per element: far below the card's operations-per-byte
// balance.
//
// Rounding.  Built without --use_fast_math (IEEE sqrtf and division)
// and with -fmad=false, so every a*b+c rounds twice as the plain
// version does; only the norms' summation order differs from it.
//
// Offsets are size_t: N*R*128 exceeds 2^31 at the paper's state size.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;   // the wrapper allocates 2*kMaxBlocks

__device__ __forceinline__ float4 load4(const float* p, size_t e) {
  return reinterpret_cast<const float4*>(p)[e];
}

__device__ __forceinline__ void store4(float* p, size_t e, float4 x) {
  reinterpret_cast<float4*>(p)[e] = x;
}

// The block's sum of one value per thread, in a fixed order (warp
// shuffle tree, then warp 0 over the warp sums), returned to EVERY
// thread.  Ends with a barrier, so a block may call it again.
__device__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) total = x;
  }
  __syncthreads();
  x = total;
  __syncthreads();
  return x;
}

// The same sum of partial[0..count) in every block that calls it.
__device__ float sum_partials(const float* __restrict__ partial, int count) {
  float x = 0.0f;
  for (int b = threadIdx.x; b < count; b += blockDim.x) x += partial[b];
  return block_sum(x);
}

__global__ void gap_norm_kernel(const float* __restrict__ theta,
                                const float* __restrict__ sent_i,
                                float* __restrict__ partial, size_t e4) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < e4;
       e += stride) {
    const float4 t = load4(theta, e), s = load4(sent_i, e);
    float d;
    d = t.x - s.x; acc += d * d;
    d = t.y - s.y; acc += d * d;
    d = t.z - s.z; acc += d * d;
    d = t.w - s.w; acc += d * d;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__device__ __forceinline__ float momentum(float gamma, float vi, float cg,
                                          float inv_vs, float inv, float g) {
  return gamma * vi + cg * (inv_vs * (inv * g));
}

__global__ void gap_apply_kernel(float* theta, float* __restrict__ v_i,
                                 float* __restrict__ sent_i,
                                 const float* __restrict__ g,
                                 float* __restrict__ hat,
                                 float* __restrict__ pre,
                                 const float* __restrict__ partial1,
                                 const float* __restrict__ avg_step,
                                 float* __restrict__ partial2, int nblocks,
                                 size_t e4, float lr, float gamma, float cg,
                                 float vs, float sqrt_p) {
  const float gap = sqrtf(sum_partials(partial1, nblocks)) / sqrt_p;
  const float penalty = 1.0f + gap / fmaxf(*avg_step, 1e-12f);
  const float inv = 1.0f / penalty;
  const float inv_vs = 1.0f / vs;
  const float a = (-lr) * vs;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < e4;
       e += stride) {
    const float4 th = load4(theta, e), vi = load4(v_i, e), gj = load4(g, e);
    if (pre) store4(pre, e, th);
    float4 vn, tn;
    vn.x = momentum(gamma, vi.x, cg, inv_vs, inv, gj.x);
    vn.y = momentum(gamma, vi.y, cg, inv_vs, inv, gj.y);
    vn.z = momentum(gamma, vi.z, cg, inv_vs, inv, gj.z);
    vn.w = momentum(gamma, vi.w, cg, inv_vs, inv, gj.w);
    tn.x = a * vn.x + th.x;
    tn.y = a * vn.y + th.y;
    tn.z = a * vn.z + th.z;
    tn.w = a * vn.w + th.w;
    acc += vn.x * vn.x;
    acc += vn.y * vn.y;
    acc += vn.z * vn.z;
    acc += vn.w * vn.w;
    store4(theta, e, tn);
    store4(v_i, e, vn);
    store4(sent_i, e, tn);
    store4(hat, e, tn);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial2[blockIdx.x] = acc;
}

__global__ void gap_finish_kernel(const float* __restrict__ partial2,
                                  int nblocks, float* avg_step, float lr,
                                  float vs, float sqrt_p, float ema,
                                  float one_minus_ema) {
  const float vn2 = sum_partials(partial2, nblocks);
  if (threadIdx.x == 0) {
    const float step_rms = ((lr * vs) * sqrtf(vn2)) / sqrt_p;
    *avg_step = ema * *avg_step + one_minus_ema * step_rms;
  }
}

}  // namespace

// rows: R (R*128 elements per flat buffer).  gs / hats: k device
// pointers each, in a HOST array; ids: k host int32 worker ids; scal: a
// host (4, k) f32 block of lr, gamma, cg and vscale per message.  pres
// is null unless telemetry is on.  partials: 2*kMaxBlocks device floats
// of scratch.  Returns the first non-zero cudaGetLastError() of the 3k
// launches, or 0.
extern "C" int gap_update_batch(float* theta, float* v, float* sent,
                                float* avg_step, float* partials,
                                float* pres, const void* gs,
                                const void* hats, const int* ids,
                                const float* scal, long long rows, int n,
                                int k, float sqrt_p, float ema,
                                float one_minus_ema, void* stream) {
  const size_t e4 = (size_t)rows * 32;
  const size_t p = e4 * 4;                      // floats per (R,128) row
  const size_t want = (e4 + kThreads - 1) / kThreads;
  const int nblocks = (int)(want < (size_t)kMaxBlocks ? want : kMaxBlocks);
  const float* const* g_ptrs = static_cast<const float* const*>(gs);
  float* const* hat_ptrs = static_cast<float* const*>(hats);
  float* partial1 = partials;
  float* partial2 = partials + kMaxBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  for (int j = 0; j < k; ++j) {
    if (ids[j] < 0 || ids[j] >= n) return (int)cudaErrorInvalidValue;
    const float lr = scal[j], gamma = scal[k + j], cg = scal[2 * k + j];
    const float vs = scal[3 * k + j];
    float* v_i = v + (size_t)ids[j] * p;
    float* sent_i = sent + (size_t)ids[j] * p;
    gap_norm_kernel<<<nblocks, kThreads, 0, s>>>(theta, sent_i, partial1,
                                                 e4);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    gap_apply_kernel<<<nblocks, kThreads, 0, s>>>(
        theta, v_i, sent_i, g_ptrs[j], hat_ptrs[j],
        pres ? pres + (size_t)j * p : nullptr, partial1, avg_step, partial2,
        nblocks, e4, lr, gamma, cg, vs, sqrt_p);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    gap_finish_kernel<<<1, kThreads, 0, s>>>(partial2, nblocks, avg_step, lr,
                                             vs, sqrt_p, ema, one_minus_ema);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}
