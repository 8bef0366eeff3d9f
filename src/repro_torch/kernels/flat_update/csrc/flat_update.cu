// Hopper (sm_90a) kernels of the flat master update, bound with ctypes.
//
// flat_update_batch replaces the TPU kernels
//   src/repro/kernels/flat_update/kernel.py::flat_master_update_batch_2d
//   src/repro/kernels/flat_update/kernel.py::flat_master_update_batch_prefetch
// and computes exactly ref.py::flat_master_update_batch_ref without the
// gap-aware branch: k coalesced worker messages applied IN ORDER to the
// flat master state theta (R,128), the momentum slab v (N,R,128), the
// optional running sum v0, second moment u2 and sent-snapshot slab, with
// per-message look-ahead views (hats) and optional telemetry (theta
// before each message).
//
// send_view replaces src/repro/kernels/flat_update/send.py::_send_view_pallas
// and computes view = theta - c * sum_m w[m] * slab[m] [/ (sqrt(u2) + eps)].
// The slab is read where it lies: worker m's R rows are contiguous and
// start `pitch` elements after worker m-1's, so a row range slab[:, r0:r1]
// of a larger (N, R_full, 128) slab (a hot-row pull, a shard's reply) is
// reduced in place, with no copy.  A contiguous slab has pitch R*128.
// It runs at 89-93 % of its bytes bound in all three of its modes (N=1,
// rate-weighted and adaptive N=64; H100, scripts/torch_host_cost.py), so
// it keeps this element-parallel design; its call at N=1 is mostly the
// wrapper's host work (send.py's lean launch path).
//
// Design.  Both kernels are element-parallel: a thread owns 4 consecutive
// f32 elements of the R*128 row space (one float4; rows are 512 B, so
// every access is a 16-byte aligned vector) and walks the row space with
// a grid-stride loop.  In flat_update_batch the thread loads its theta,
// v0 and u2 into registers ONCE, runs the k messages in order, and writes
// them back once at the end.  That register residency is what the TPU
// kernel got from VMEM residency across its inner message axis: device
// traffic is O(state) + O(k * grad) per batch, not O(k * state).  The
// momentum (and sent) row of message j is read and written in device
// memory, v[ids[j]] addressed by the thread itself; a worker that appears
// twice in a batch therefore chains on its own earlier update for free,
// because the same thread reads back its own store.  Only the rows the
// batch names are ever touched (the TPU's scalar-prefetch variant), so
// one kernel serves both TPU lowerings and there is no limit on N.
//
// Bound: device-memory bytes.  For k messages naming u distinct workers
// flat_update_batch moves
//   4*R*128*(2 + 2[v0] + 2[u2] + 2u(1 + [sent]) + k + k + k[telemetry])
// bytes (theta in/out, v0/u2 in/out, u slab rows (and sent rows) in/out,
// k gradients in, k hats out, k pre-thetas out), plus N slab rows per
// message for the weighted hat; send_view moves 4*R*128*(N + 2 + [u2])
// whatever its pitch.
// Both do a few f32 operations per element, far below the card's
// operations-per-byte balance.
//
// Rounding.  Built without --use_fast_math (IEEE sqrtf and division) and
// with -fmad=false, so every a*b+c rounds twice as the eager PyTorch
// plain versions do: the elementwise modes reproduce the plain versions
// bit for bit on the card, and only the N-way weighted sums differ from
// the plain versions' tensordot by summation order.
//
// Gradients and hats come as tables of k device pointers, one (R,128)
// buffer per message, in one device block with the per-message scalars
// (the wrapper uploads it with one copy).  A batch's gradients therefore
// need no stacking copy, and each reply view can own its storage: a
// reply kept by one worker does not pin the other k-1 views of its
// batch.
//
// Offsets are size_t: N*R*128 exceeds 2^31 at the paper's state size.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 8192;

enum HatMode { kHatTheta = 0, kHatV0 = 1, kHatSelf = 2, kHatWeighted = 3 };

struct Flags {
  int nesterov, adaptive, dc, sent_view, hat_mode;
  float dc_lambda, b2, one_minus_b2, eps;
};

__device__ __forceinline__ void load4(const float* p, size_t e, float* x) {
  const float4 q = reinterpret_cast<const float4*>(p)[e];
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, size_t e, const float* x) {
  reinterpret_cast<float4*>(p)[e] = make_float4(x[0], x[1], x[2], x[3]);
}

// gs / hats: k pointers each; scal is one (6, k) block: row 0 the
// worker ids (int32 bits), then lr, gamma, cg, vscale and the hat
// coefficient per message.
__global__ void flat_update_batch_kernel(
    float* theta, float* v, float* v0, float* u2, float* sent,
    const float* const* __restrict__ gs, float* const* __restrict__ hats,
    const float* __restrict__ scal, const float* __restrict__ weights,
    float* __restrict__ pres, size_t e4, int n, int k, Flags f) {
  const int* ids = reinterpret_cast<const int*>(scal);
  const float* lrs = scal + k;
  const float* gammas = scal + 2 * k;
  const float* cgs = scal + 3 * k;
  const float* vss = scal + 4 * k;
  const float* hcs = scal + 5 * k;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < e4;
       e += stride) {
    float th[4], s0[4], q2[4];
    load4(theta, e, th);
    if (v0) load4(v0, e, s0);
    if (u2) load4(u2, e, q2);
    for (int j = 0; j < k; ++j) {
      const float lr = lrs[j], gamma = gammas[j], cg = cgs[j];
      const float vs = vss[j], hc = hcs[j];
      const float inv_vs = 1.0f / vs;
      const size_t row = (size_t)ids[j] * e4 + e;
      const size_t msg = (size_t)j * e4 + e;
      if (pres) store4(pres, msg, th);
      float vi[4], gj[4], vn[4], den[4], hat[4];
      load4(v, row, vi);
      load4(gs[j], e, gj);
      if (sent) {
        float si[4];
        load4(sent, row, si);
        if (f.dc) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            gj[c] = gj[c] + f.dc_lambda * ((gj[c] * gj[c]) * (th[c] - si[c]));
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) vn[c] = gamma * vi[c] + cg * (inv_vs * gj[c]);
      if (f.adaptive) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          q2[c] = f.b2 * q2[c] + f.one_minus_b2 * gj[c] * gj[c];
          den[c] = sqrtf(q2[c]) + f.eps;
        }
      }
      if (f.nesterov) {
        const float a = gamma * vs;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float num = a * vn[c] + cg * gj[c];
          th[c] = f.adaptive ? (-lr) * (num / den[c]) + th[c]
                             : (-lr) * num + th[c];
        }
      } else {
        const float a = (-lr) * vs;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          th[c] = f.adaptive ? a * (vn[c] / den[c]) + th[c] : a * vn[c] + th[c];
      }
      // the slab row updates BEFORE the hat: the weighted hat reduces
      // over the post-update slab
      store4(v, row, vn);
      if (v0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s0[c] = (s0[c] - vi[c]) + vn[c];
      }
      if (f.hat_mode == kHatTheta) {
#pragma unroll
        for (int c = 0; c < 4; ++c) hat[c] = th[c];
      } else if (f.hat_mode == kHatV0) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          hat[c] = f.adaptive ? th[c] - (hc * s0[c]) / den[c]
                              : (-hc) * s0[c] + th[c];
      } else if (f.hat_mode == kHatSelf) {
#pragma unroll
        for (int c = 0; c < 4; ++c) hat[c] = (-hc) * vn[c] + th[c];
      } else {
        const float* wj = weights + (size_t)j * n;
        float ws[4], x[4];
        load4(v, e, x);
#pragma unroll
        for (int c = 0; c < 4; ++c) ws[c] = wj[0] * x[c];
        for (int m = 1; m < n; ++m) {
          load4(v, (size_t)m * e4 + e, x);
#pragma unroll
          for (int c = 0; c < 4; ++c) ws[c] = ws[c] + wj[m] * x[c];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) hat[c] = (-hc) * ws[c] + th[c];
      }
      store4(hats[j], e, hat);
      if (sent) store4(sent, row, f.sent_view ? hat : th);
    }
    store4(theta, e, th);
    if (v0) store4(v0, e, s0);
    if (u2) store4(u2, e, q2);
  }
}

__global__ void send_view_kernel(const float* __restrict__ theta,
                                 const float* __restrict__ slab,
                                 const float* __restrict__ w, float c,
                                 const float* __restrict__ u2, float eps,
                                 float* __restrict__ out, size_t e4, int n,
                                 size_t pitch4) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < e4;
       e += stride) {
    float ws[4], x[4], th[4], o[4];
    load4(theta, e, th);   // before the slab: both streams in flight at N=1
    load4(slab, e, x);
#pragma unroll
    for (int q = 0; q < 4; ++q) ws[q] = w[0] * x[q];
    for (int m = 1; m < n; ++m) {
      load4(slab, (size_t)m * pitch4 + e, x);
#pragma unroll
      for (int q = 0; q < 4; ++q) ws[q] = ws[q] + w[m] * x[q];
    }
    if (u2) {
      float q2[4];
      load4(u2, e, q2);
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = th[q] - (c * ws[q]) / (sqrtf(q2[q]) + eps);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = (-c) * ws[q] + th[q];
    }
    store4(out, e, o);
  }
}

int blocks_for(size_t e4) {
  size_t b = (e4 + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// rows: R (the row count; R*128 elements per flat buffer).  block: k
// gradient pointers, k hat pointers (8 bytes each), then the (6, k) f32
// scalars.  Pointers to absent optional buffers are null.  Returns
// cudaGetLastError().
extern "C" int flat_update_batch(float* theta, float* v, float* v0,
                                 float* u2, float* sent, const void* block,
                                 const float* weights, float* pres,
                                 long long rows,
                                 int n, int k, int nesterov, int adaptive,
                                 int dc, float dc_lambda, int sent_view,
                                 int hat_mode, float b2, float one_minus_b2,
                                 float eps, void* stream) {
  const size_t e4 = (size_t)rows * 32;
  Flags f{nesterov, adaptive, dc, sent_view, hat_mode,
          dc_lambda, b2, one_minus_b2, eps};
  const char* b = static_cast<const char*>(block);
  const float* const* gs = reinterpret_cast<const float* const*>(b);
  float* const* hats = reinterpret_cast<float* const*>(b + 8 * (size_t)k);
  const float* scal = reinterpret_cast<const float*>(b + 16 * (size_t)k);
  flat_update_batch_kernel<<<blocks_for(e4), kThreads, 0, (cudaStream_t)stream>>>(
      theta, v, v0, u2, sent, gs, hats, scal, weights, pres, e4, n, k, f);
  return (int)cudaGetLastError();
}

// pitch: elements from worker m's first row to worker m+1's (a multiple
// of 4, at least rows*128; the wrapper checks it).
extern "C" int send_view(const float* theta, const float* slab,
                         const float* w, float c, const float* u2, float eps,
                         float* out, long long rows, int n, long long pitch,
                         void* stream) {
  const size_t e4 = (size_t)rows * 32;
  send_view_kernel<<<blocks_for(e4), kThreads, 0, (cudaStream_t)stream>>>(
      theta, slab, w, c, u2, eps, out, e4, n, (size_t)pitch / 4);
  return (int)cudaGetLastError();
}
