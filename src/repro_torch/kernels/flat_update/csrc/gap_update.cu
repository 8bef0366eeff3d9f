// Hopper (sm_90a) kernels of the gap-aware master update (ga-asgd), bound
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
//   gap     = sqrt(sum((theta - sent_i)^2)) / sqrt_p
//   penalty = 1 + gap / max(avg_step, 1e-12)
//   v_i'    = gamma * v_i + cg * ((1/vs) * ((1/penalty) * g_j))
//   theta'  = ((-lr) * vs) * v_i' + theta;  sent_i' = hat_j = theta'
//   avg_step' = ema * avg_step + (1-ema) * (lr*vs) * ||v_i'|| / sqrt_p
//
// Design: one pass over the state per message, k + 2 launches for k
// messages on one stream.  Every element of message j's update needs the
// global norm of theta - sent_i first, and avg_step needs the norm of
// v_i' after.  The TPU kernel carried the partial sums in SMEM from one
// grid step to the next; Hopper's blocks run in no order and share
// nothing, so the sums cross launches, and each launch does the next
// message's norm while it has the data in registers:
//   gap_norm (once, message 0): a fixed grid of G blocks (G depends only
//      on R), each a grid-stride float4 loop summing (theta - sent_i0)^2,
//      reduced in a fixed order (thread, warp shuffle, block) into G
//      partials;
//   gap_apply (message j, k launches): every block first sums message j's
//      G norm partials, and message j-1's G step partials (||v'||^2), in
//      the same fixed order, so all blocks agree bit for bit on the gap
//      and on avg_step_j = ema * avg_step_{j-1} + (1-ema) * step_rms_{j-1};
//      block 0 keeps avg_step_j in one of two device slots (ping-pong:
//      launch j writes slot j%2 and reads slot (j-1)%2, so no block reads
//      a value another block of its launch writes).  It then applies the
//      penalised update to its float4s (theta, v_i, sent_i, the hat, and
//      theta before the update when telemetry is on), sums ||v_i'||^2,
//      and, unless j is the last message, sums message j+1's gap
//      (theta' - sent_{i_{j+1}})^2 from theta' in registers.  When
//      i_{j+1} == i_j that snapshot is the theta' just written, and the
//      term is exactly 0 as in the plain version: the kernel reads
//      nothing for it.  A worker that appears again later in the batch
//      reads the sent row an earlier launch wrote, in stream order.  The
//      partials of norm and step ping-pong between two buffers too;
//   gap_finish (once): one block sums message k-1's step partials and
//      writes avg_step.
// Each thread takes the same elements in the same order in every launch
// as the two-pass design did (gap_norm, then gap_apply, then gap_finish,
// 3k launches), so the sums, and the results, are bit for bit those of
// that design.  No float atomics: a run is bit-reproducible, so the
// deterministic cluster equals the engine's kernel run bit for bit.
// avg_step never leaves the device.
//
// Bound: device-memory bytes.  The least k messages must move, each
// input read once and each output written once, is theta in/out, the u
// distinct v and sent rows in/out, k gradients in and k hats out [+ k
// pre rows]: 4*R*128*(2 + 4u + 2k [+k]) bytes; at R = 197,000, k = 1
// with telemetry 0.908 GB (0.271 ms at 3.35 TB/s), k = 8 (u = 5) 4.64
// GB (1.385 ms).  That k = 8 floor reads theta once over all eight
// messages, which no design that honours each message's global gap norm
// can do while theta (100.9 MB) exceeds the 50 MB L2.  This design moves
// 4*R*128*(2 + k(7 [+1]) + (k - 1 - a)) bytes, a the adjacent pairs of
// one worker: k = 1 0.908 GB as before, k = 8 7.36 GB (2.20 ms), against
// 4*R*128*k*(9 [+1]) = 8.07 GB (2.41 ms) for the two-pass design, which
// read theta again in pass 2.  About a dozen f32 operations per element:
// far below the card's operations-per-byte balance.
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
constexpr int kMaxBlocks = 1024;   // the wrapper's scratch: 4*kMaxBlocks+2

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

// avg_step after a message whose ||v_i'||^2 partials are step
__device__ float next_avg(const float* __restrict__ step, int nblocks,
                          float avg, float lr, float vs, float sqrt_p,
                          float ema, float one_minus_ema) {
  const float vn2 = sum_partials(step, nblocks);
  const float step_rms = ((lr * vs) * sqrtf(vn2)) / sqrt_p;
  return ema * avg + one_minus_ema * step_rms;
}

__device__ __forceinline__ float sq_diff(float4 t, float4 s, float acc) {
  float d;
  d = t.x - s.x; acc += d * d;
  d = t.y - s.y; acc += d * d;
  d = t.z - s.z; acc += d * d;
  d = t.w - s.w; acc += d * d;
  return acc;
}

__global__ void gap_norm_kernel(const float* __restrict__ theta,
                                const float* __restrict__ sent_i,
                                float* __restrict__ partial, size_t e4) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < e4;
       e += stride)
    acc = sq_diff(load4(theta, e), load4(sent_i, e), acc);
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__device__ __forceinline__ float momentum(float gamma, float vi, float cg,
                                          float inv_vs, float inv, float g) {
  return gamma * vi + cg * (inv_vs * (inv * g));
}

// One message.  norm_in: this message's gap partials; step_in: the
// previous message's ||v'||^2 partials (null for the first, whose
// avg_step is *avg_src as it stands); avg_src: the avg_step before the
// previous message (or before this one, for the first); avg_dst: where
// block 0 keeps this message's avg_step.  sent_next: the next message's
// snapshot row, or null when there is none or it is this message's own
// (its gap partials are then 0).
__global__ void gap_apply_kernel(
    float* theta, float* __restrict__ v_i, float* __restrict__ sent_i,
    const float* __restrict__ g, float* __restrict__ hat,
    float* __restrict__ pre, const float* __restrict__ sent_next,
    const float* __restrict__ norm_in, float* __restrict__ norm_out,
    const float* __restrict__ step_in, float* __restrict__ step_out,
    const float* avg_src, float* avg_dst, int nblocks, size_t e4, float lr,
    float gamma, float cg, float vs, float lr_prev, float vs_prev,
    float sqrt_p, float ema, float one_minus_ema) {
  const float gap = sqrtf(sum_partials(norm_in, nblocks)) / sqrt_p;
  float avg = *avg_src;
  if (step_in) {
    avg = next_avg(step_in, nblocks, avg, lr_prev, vs_prev, sqrt_p, ema,
                   one_minus_ema);
    if (blockIdx.x == 0 && threadIdx.x == 0) *avg_dst = avg;
  }
  const float penalty = 1.0f + gap / fmaxf(avg, 1e-12f);
  const float inv = 1.0f / penalty;
  const float inv_vs = 1.0f / vs;
  const float a = (-lr) * vs;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  float acc_v = 0.0f, acc_next = 0.0f;
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
    acc_v += vn.x * vn.x;
    acc_v += vn.y * vn.y;
    acc_v += vn.z * vn.z;
    acc_v += vn.w * vn.w;
    if (sent_next) acc_next = sq_diff(tn, load4(sent_next, e), acc_next);
    store4(theta, e, tn);
    store4(v_i, e, vn);
    store4(sent_i, e, tn);
    store4(hat, e, tn);
  }
  acc_v = block_sum(acc_v);
  acc_next = block_sum(acc_next);
  if (threadIdx.x == 0) {
    step_out[blockIdx.x] = acc_v;
    norm_out[blockIdx.x] = acc_next;
  }
}

__global__ void gap_finish_kernel(const float* __restrict__ step,
                                  int nblocks, const float* avg_src,
                                  float* avg_step, float lr, float vs,
                                  float sqrt_p, float ema,
                                  float one_minus_ema) {
  const float avg = next_avg(step, nblocks, *avg_src, lr, vs, sqrt_p, ema,
                             one_minus_ema);
  if (threadIdx.x == 0) *avg_step = avg;
}

}  // namespace

// rows: R (R*128 elements per flat buffer).  gs / hats: k device
// pointers each, in a HOST array; ids: k host int32 worker ids; scal: a
// host (4, k) f32 block of lr, gamma, cg and vscale per message.  pres
// is null unless telemetry is on.  scratch: 4*kMaxBlocks + 2 device
// floats (two norm and two step partial buffers, two avg_step slots),
// used by one stream at a time.  Returns cudaErrorInvalidValue before
// any launch if an id is out of range, else the first non-zero
// cudaGetLastError() of the k + 2 launches, or 0.
extern "C" int gap_update_batch(float* theta, float* v, float* sent,
                                float* avg_step, float* scratch,
                                float* pres, const void* gs,
                                const void* hats, const int* ids,
                                const float* scal, long long rows, int n,
                                int k, float sqrt_p, float ema,
                                float one_minus_ema, void* stream) {
  for (int j = 0; j < k; ++j)
    if (ids[j] < 0 || ids[j] >= n) return (int)cudaErrorInvalidValue;
  const size_t e4 = (size_t)rows * 32;
  const size_t p = e4 * 4;                      // floats per (R,128) row
  const size_t want = (e4 + kThreads - 1) / kThreads;
  const int nblocks = (int)(want < (size_t)kMaxBlocks ? want : kMaxBlocks);
  const float* const* g_ptrs = static_cast<const float* const*>(gs);
  float* const* hat_ptrs = static_cast<float* const*>(hats);
  float* const norm[2] = {scratch, scratch + kMaxBlocks};
  float* const step[2] = {scratch + 2 * kMaxBlocks, scratch + 3 * kMaxBlocks};
  float* const slot[2] = {scratch + 4 * kMaxBlocks,
                          scratch + 4 * kMaxBlocks + 1};
  const float *lrs = scal, *gammas = scal + k, *cgs = scal + 2 * k;
  const float* vss = scal + 3 * k;
  cudaStream_t s = (cudaStream_t)stream;
  gap_norm_kernel<<<nblocks, kThreads, 0, s>>>(
      theta, sent + (size_t)ids[0] * p, norm[0], e4);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  for (int j = 0; j < k; ++j) {
    const bool same = j + 1 < k && ids[j + 1] == ids[j];
    const float* sent_next =
        j + 1 < k && !same ? sent + (size_t)ids[j + 1] * p : nullptr;
    gap_apply_kernel<<<nblocks, kThreads, 0, s>>>(
        theta, v + (size_t)ids[j] * p, sent + (size_t)ids[j] * p, g_ptrs[j],
        hat_ptrs[j], pres ? pres + (size_t)j * p : nullptr, sent_next,
        norm[j & 1], norm[(j + 1) & 1], j ? step[(j - 1) & 1] : nullptr,
        step[j & 1], j <= 1 ? avg_step : slot[(j - 1) & 1], slot[j & 1],
        nblocks, e4, lrs[j], gammas[j], cgs[j], vss[j],
        j ? lrs[j - 1] : 0.0f, j ? vss[j - 1] : 0.0f, sqrt_p, ema,
        one_minus_ema);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  gap_finish_kernel<<<1, kThreads, 0, s>>>(
      step[(k - 1) & 1], nblocks, k <= 1 ? avg_step : slot[(k - 1) & 1],
      avg_step, lrs[k - 1], vss[k - 1], sqrt_p, ema, one_minus_ema);
  return (int)cudaGetLastError();
}
