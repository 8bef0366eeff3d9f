// Hopper (sm_90a) kernels of flash attention: causal with a sliding
// window, non-causal over keys of another length, and segment masks;
// bound with ctypes.
//
// swa_attention replaces the TPU kernel
//   src/repro/kernels/swa_attention/kernel.py::swa_attention_pallas
// (causal, sliding window, S == T) and covers the other cases of the JAX
// model's jnp flash_attention (src/repro/models/attention.py:83-187): it
// computes ref.py::swa_attention_ref.  For q (B, S, H, hd) and k, v
// (B, T, K, hd) with K dividing H (GQA; query head h reads kv head
// h / (H/K), in place: K/V are never repeated), query i attends to
//   causal (T == S):  the keys j with i - window < j <= i;
//   non-causal:       every key j < T (the encoder, T == S, and cross
//                     attention over the encoder's T frames);
// and, with segments (B, S) int32 (packed documents), only the keys whose
// segment equals the query's, which must be > 0 (keys take
// segments[:, :T]).  softmax(q.k / sqrt(hd)) v, the output in the inputs'
// type.  A masked score is -1e30, as in the JAX recurrence, so a row
// masked against every key (a segment-0 padding row) gets p = 1 for
// every key and the mean of V over all T keys (with a window too: the
// JAX windowed path averages only its band's chunks, ROADMAP C33); keys
// past T in a ragged last tile score -inf and never count.  The TPU
// kernel ran a grid (B*H, S/128) over K/V already repeated to H heads
// and visited the band's kv blocks with a fori_loop.  Here a block owns
// a tile of queries of one (batch, head) and visits only the kv tiles
// that meet its band [q0 - window + 1, q_last] when causal, so the work is
// O(S * window), not O(S^2); every kv tile when not causal, or when the
// tile holds a padding row (the mean above needs every key: a cost paid
// by the padding tiles only).  Any S, T >= 1 (the last tiles mask their
// rows and keys), head_dim 1..256 (zero-padded in shared memory to the
// template's HD), any window >= 1.  One entry point, two kernels, picked
// by the inputs' type (both count as one launch of swa_attention):
//
// bfloat16: the tensor-core kernel (swa_attention_tc_kernel), the
// FlashAttention-2 forward on mma.sync.
//   Tiles    a block of 4 warps owns kBq = 64 queries (16 rows a warp)
//            and walks kv tiles of kBk = 64 keys.  HD is 64, 128 or 256
//            (the next at or above hd).  Dynamic shared memory holds the
//            Q tile, one K and one V tile (and, with segments, the kv
//            tile's 64 ids): 24 KB at HD 64, 48 KB at 128, 96 KB at 256,
//            so two blocks share an SM even at HD 256
//            (__launch_bounds__(128, 2): 255 registers a thread at most;
//            ptxas gives 245-248, no spills) and one block's copies run
//            under the other's products.  Rows of HD bf16 are cut into
//            16-byte chunks stored at chunk ^ (row % 8), so the 8 row
//            addresses of every ldmatrix phase fall in distinct banks.
//   Copies   cp.async.cg, 16 bytes a thread, zero-filled past S (Q), T
//            (K, V) and hd (src-size 0), interleaved as FlashAttention-2
//            does: V_t's copy runs under Q K_t^T and the softmax,
//            K_{t+1}'s under P V_t; cp.async.wait_group 0 and a barrier
//            precede each use (two barriers a tile).  A thread keeps one
//            chunk column, so each copy's shared address is one of two
//            swizzled offsets plus a constant.  Inputs whose hd is no
//            multiple of 8 (or whose pointers are not 16-byte aligned)
//            take a scalar copy loop in the same kernel.
//   Products mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//            S = Q K^T: A from Q by ldmatrix.x4, B from K rows by
//            ldmatrix.x4; O += P V: B from V by ldmatrix.x4.trans.  Each
//            lane's ldmatrix addresses are four swizzled offsets per
//            operand plus constants, computed once.  The scale
//            log2(e)/sqrt(hd) multiplies the f32 scores after Q K^T (q is
//            not rounded twice), and the softmax runs in base 2 (exp2f):
//            exp(x / sqrt(hd)) = 2^(x log2(e) / sqrt(hd)).
//   Softmax  in registers: each thread holds two rows' (g, g + 8) score
//            fragments, a quad of 4 lanes a row, so the row max needs two
//            shuffles; m and acc stay f32 and 2^(m_old - m_new) rescales
//            them; l is summed from the f32 p (per thread, the quad's
//            partial sums added once at the end).  P never goes to shared
//            memory: the f32 score fragment of keys 16kk..16kk+15 is the
//            A fragment of the PV product, rounded to bf16 (as
//            FlashAttention and the JAX model's own flash_attention,
//            models/attention.py:158, round it; the Pallas kernel keeps P
//            in f32).  Only the tiles that cross the diagonal or the
//            window's lower edge, hold keys past T, or mix segments apply
//            the mask (-1e30, -inf past T); interior tiles skip it.  Keys
//            before a row's first valid key give p = 1 only while that
//            row's m is still -1e30, and the first valid tile's
//            2^(m_old - m_new) = 0 wipes them, as in the Pallas kernel.
//   Masks    the causal flag and the presence of segments are template
//            parameters (four instances an HD), so the causal kernel
//            without segments carries none of the other masks' code.
//            With segments each thread reads its two rows' ids once;
//            barriers that reduce (__syncthreads_or / _and) find whether
//            the query tile holds a padding row and whether it is of one
//            segment, and the loop's first barrier of each kv tile whether
//            the tile's 64 keys (their ids copied to shared memory beside
//            K) are of that segment too: then the tile skips the segment
//            mask.
//   Output   acc / max(l, 1e-30), rounded to bf16, staged in the warp's
//            own Q rows and written as 16-byte chunks.
//   Grid     one dimension, dispatched in order, longest bands first:
//            every (head, batch row) of the last query tile, then of the
//            one before, and so on, so the short first tiles fill the
//            grid's tail.
//
// float32: the CUDA-core kernel (swa_attention_kernel): tensor cores
// cannot meet the float32 tolerance of 2e-5.  One block of 128 threads
// owns kBq = 32 queries and walks kv tiles of kBk = 32 keys through shared
// memory in float32 (q scaled by 1/sqrt(hd) as it is loaded); each thread
// computes a 2 x 4 micro-tile of the scores (rows rg, rg+16; columns
// cg + 8j), masks it (the segment ids of the tile's rows and keys in
// shared memory, checked on every element) and stores it; each warp runs
// the online softmax of 8 rows (a lane per key, warp shuffles for max and
// sum) and adds P V with lane L owning dims L, L+32, ... of its rows.  HD
// is the next of 32, 64, 128, 256.
//
// Bound.  FLOPs = 4 * B * H * hd * (number of (query, key) pairs in the
// band); bytes = q, k, v read once and o written once.  At
// recurrentgemma-9b's prefill (B=4, S=512, H=16, K=1, hd=256, window 2048
// >= S, so plain causal: 131,328 pairs per head) 8.6 GFLOP, 0.0087 ms at
// the dense bf16 tensor-core rate of 989 TFLOP/s, and 35.7 MB in bf16
// (q and o 16.8 MB each, k and v 1.0 MB each), 0.0106 ms at 3.35 TB/s:
// bytes bound this shape.  At B=1, S=3072, window 2048 (4.2M pairs per
// head) 68.7 GFLOP, 0.0695 ms, against 53.5 MB, 0.016 ms: operations
// bound it.  What the design does about it: q is read and o written once,
// 16 bytes a thread; K/V tiles come from L2 (one MQA kv head serves the
// 16 heads' blocks: 0.5 MB per batch row at S=512, 3 MB at 3072); the
// products run on the tensor cores through mma.sync (wgmma, the only
// route to the full rate, is later work).  The masked halves of the
// diagonal tiles add 12 % of mma work at (4, 512) and 3 % at (1, 3072).
// What limits this design: each warp reads every K and V tile from
// shared memory for its 16 rows (ldmatrix, about 72 KB a warp a tile at
// HD 256), which caps it near 1,800 FLOP per clock per SM against the
// tensor cores' 4,096; wgmma reads B once for 64 rows.  Measured on an
// H100 80GB HBM3 at 700 W (device time, chip_smoke.py): 0.048-0.050 ms
// at (4, 512) and 0.247-0.252 ms at (1, 3072), 173-278 TFLOP/s.  Two K
// and two V buffers (160 KB at HD 256: one block an SM) with blocks
// ordered only within each head measured 0.103 and 0.465 ms.
// The float32 kernel runs on the CUDA cores (67 TFLOP/s of float32), and
// its shared-memory traffic (about two loads per multiply-add) is its
// limit.
// Non-causal and cross attention (seamless-m4t-large-v2: H = K = 16,
// hd 64).  Every (query, key) pair counts: B * S * T pairs a head.  At
// the encoder and cross shapes (B=4, S=T=512) 4.3 GFLOP, 0.0043 ms at
// 989 TFLOP/s, against 16.8 MB in bf16 (q, k, v, o 4.2 MB each), 0.0050
// ms: bytes bound it, barely.  At (1, 512) queries over the longest
// encoder output (T = 4096) 8.6 GFLOP, 0.0087 ms, against 18.9 MB, 0.0056
// ms: operations bound it.  The design is the causal one without the
// band (every tile interior but the last, ragged one), so what limits it
// is what limits the causal kernel: ldmatrix traffic from shared memory
// and mma.sync, not HBM.  Packed sequences (qwen2-1.5b: B=4, S=512, 12
// heads, 2 kv heads, hd 128): the causal band plus, for tiles with a
// padding row, every tile.  The pairs that count are those within each
// document (at most the causal band's: 3.2 GFLOP, 0.0033 ms) against
// 14.7 MB, 0.0044 ms: bytes bound it.
//
// Offsets are size_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;   // 4 warps
constexpr int kBq = 32;         // queries per block
constexpr int kBk = 32;         // keys per kv tile
constexpr float kNegInf = -1e30f;   // a masked score, as the JAX recurrence

// the score of a key past T: -inf, so its p is 0 even in a row whose
// every score is kNegInf
__device__ __forceinline__ float no_key() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// The problem's sizes and masks, passed by value to both kernels.
struct Dims {
  int seq;        // S: queries (and, causal, keys)
  int kv_len;     // T: keys
  int heads;      // H
  int kv_heads;   // K, dividing H
  int hd;         // head_dim
  int window;     // causal only: keys in (i - window, i]
  int causal;     // 0: every key below T
};

template <int HD>
struct Smem {                        // sizes in 4-byte words
  static constexpr int kQ = kBq * (HD + 1);
  static constexpr int kK = kBk * (HD + 1);
  static constexpr int kV = kBk * HD;
  static constexpr int kP = kBq * (kBk + 1);
  static constexpr int kSeg = kBq + kBk;   // the tile's segment ids
  static constexpr size_t kBytes = (size_t)(kQ + kK + kV + kP + kSeg) *
                                   sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         const int* __restrict__ seg, Dims p, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBq][HD + 1], scaled
  float* ks = qs + Smem<HD>::kQ;           // [kBk][HD + 1]
  float* vs = ks + Smem<HD>::kK;           // [kBk][HD]
  float* ps = vs + Smem<HD>::kV;           // [kBq][kBk + 1]
  int* qseg = reinterpret_cast<int*>(ps + Smem<HD>::kP);   // [kBq]
  int* kseg = qseg + kBq;                                  // [kBk]
  constexpr int kDims = HD / 32;           // dims per lane in PV

  const int seq = p.seq, kv_len = p.kv_len, hd = p.hd, window = p.window;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int kh = h / (p.heads / p.kv_heads);
  const size_t q_stride = (size_t)p.heads * hd;      // one position of q, o
  const size_t kv_stride = (size_t)p.kv_heads * hd;  // one position of k, v
  const T* qb = q + b * (size_t)seq * q_stride + (size_t)h * hd;
  const T* kb = k + b * (size_t)kv_len * kv_stride + (size_t)kh * hd;
  const T* vb = v + b * (size_t)kv_len * kv_stride + (size_t)kh * hd;
  T* ob = o + b * (size_t)seq * q_stride + (size_t)h * hd;
  const int* sb = seg == nullptr ? nullptr : seg + b * (size_t)seq;

  for (int i = tid; i < kBq * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    qs[r * (HD + 1) + d] =
        (s < seq && d < hd) ? to_f32(qb[(size_t)s * q_stride + d]) * scale
                            : 0.0f;
  }
  // the tile's segment ids; a row of segment <= 0 attends no key
  bool pad = false;
  if (sb != nullptr && tid < kBq) {
    const int s = q0 + tid;
    qseg[tid] = s < seq ? sb[s] : 1;
    pad = s < seq && qseg[tid] <= 0;
  }
  // a tile with such a row visits every key: the row's scores are all
  // -1e30, so each key's p is 1 and the row takes the mean of V over T
  const bool has_pad = __syncthreads_or(pad);

  float m[8], l[8], acc[8][kDims];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[r][j] = 0.0f;
  }

  // keys [k_begin, k_end): the causal band, or all T keys
  const bool all_keys = !p.causal || has_pad;
  const int k_begin = all_keys ? 0 : max(0, q0 - window + 1);
  const int k_end = all_keys ? kv_len : min(q0 + kBq, seq);
  const int rg = tid / 8, cg = tid % 8;    // score micro-tile

  for (int k0 = (k_begin / kBk) * kBk; k0 < k_end; k0 += kBk) {
    __syncthreads();   // the previous tile is consumed (the Q tile written)
    for (int i = tid; i < kBk * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int s = k0 + r;
      const bool in = s < kv_len && d < hd;
      const size_t e = (size_t)s * kv_stride + d;
      ks[r * (HD + 1) + d] = in ? to_f32(kb[e]) : 0.0f;
      vs[r * HD + d] = in ? to_f32(vb[e]) : 0.0f;
    }
    if (sb != nullptr && tid < kBk)   // keys take segments[:, :T], T <= S
      kseg[tid] = k0 + tid < kv_len ? sb[k0 + tid] : -1;
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
    // mask: keys past T give p = 0 (-inf), other masked keys -1e30
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 8 * j;
        float x = sc[i][j];
        if (kj >= kv_len) {
          x = no_key();
        } else {
          bool ok = !p.causal || (kj <= qi && qi - kj < window);
          if (sb != nullptr) {
            const int sq = qseg[rg + 16 * i];
            ok = ok && sq > 0 && sq == kseg[cg + 8 * j];
          }
          if (!ok) x = kNegInf;
        }
        ps[(rg + 16 * i) * (kBk + 1) + cg + 8 * j] = x;
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
           const int* seg, long long bsz, const Dims& p, cudaStream_t st) {
  auto kern = swa_attention_kernel<T, HD>;
  const size_t smem = Smem<HD>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((p.seq + kBq - 1) / kBq), (unsigned)p.heads,
                  (unsigned)bsz);
  const float scale = 1.0f / sqrtf((float)p.hd);
  kern<<<grid, kThreads, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                     (T*)o, seg, p, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const int* seg, long long bsz, const Dims& p, cudaStream_t st) {
  if (p.hd <= 32) return launch<T, 32>(q, k, v, o, seg, bsz, p, st);
  if (p.hd <= 64) return launch<T, 64>(q, k, v, o, seg, bsz, p, st);
  if (p.hd <= 128) return launch<T, 128>(q, k, v, o, seg, bsz, p, st);
  if (p.hd <= 256) return launch<T, 256>(q, k, v, o, seg, bsz, p, st);
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async, swizzled tiles
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;   // queries per block, 16 rows a warp
constexpr int kBk = 64;            // keys per kv tile
constexpr int kNb = kBk / 8;       // 8-key column blocks of a score tile

template <int HD, bool SEG>
struct Smem {                      // sizes in bf16 elements
  static constexpr int kQ = kBq * HD;
  static constexpr int kTile = kBk * HD;
  // the Q, K and V tiles, then (with segments) the kv tile's kBk ids
  static constexpr size_t kBytes = (size_t)(kQ + 2 * kTile) *
                                   sizeof(__nv_bfloat16) +
                                   (SEG ? kBk * sizeof(int) : 0);
};

// Element offset of (row, col) in a tile of rows of HD bf16 whose 16-byte
// chunks are stored at chunk ^ (row % 8); HD >= 64, so 8 chunks or more.
template <int HD>
__device__ __forceinline__ int swz(int row, int col) {
  return row * HD + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ROWS rows of HD from src (row s at src + s * stride; rows >= seq and
// columns >= hd read as 0) into the swizzled tile dst.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0, int seq,
                                          int hd, bool vec, int tid) {
  constexpr int kChunks = HD / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "tile / threads");
  static_assert(kThreads % kChunks == 0, "a thread keeps its chunk");
  if (vec) {
    // thread tid copies chunk c of rows r0, r0 + kStep, ...: kStep is 4, 8
    // or 16, so a row's swizzle is one of two offsets, and each copy's
    // shared address is one of them plus a constant
    constexpr int kStep = kThreads / kChunks;
    constexpr unsigned kRow = HD * sizeof(__nv_bfloat16);
    const int c = tid % kChunks, r0 = tid / kChunks;
    const bool col_in = c * 8 < hd;
    const unsigned base = smem_u32(dst) + r0 * kRow;
    const unsigned d0 = base + ((c ^ (r0 & 7)) << 4);
    const unsigned d4 = base + ((c ^ ((r0 + 4) & 7)) << 4);
    const __nv_bfloat16* g = src + (size_t)(row0 + r0) * stride + c * 8;
    const size_t g_step = (size_t)kStep * stride;
#pragma unroll
    for (int j = 0; j < ROWS / kStep; ++j) {
      const bool in = col_in && row0 + r0 + j * kStep < seq;
      cp_async16(((j * kStep) & 4 ? d4 : d0) + j * kStep * kRow,
                 in ? g + j * g_step : src, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int s = row0 + r;
      dst[swz<HD>(r, d)] = (s < seq && d < hd)
                               ? src[(size_t)s * stride + d]
                               : __float2bfloat16_rn(0.0f);
    }
  }
}

// CAUSAL and SEG are compile-time, so the causal path without segments
// (every attention prefill but the encoder's, cross attention's and packed
// training's) compiles to the kernel without the other masks' code.
template <int HD, bool CAUSAL, bool SEG>
__global__ void __launch_bounds__(kThreads, 2)
    swa_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o,
                            const int* __restrict__ seg, Dims p,
                            float scale_log2, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using Sm = Smem<HD, SEG>;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + Sm::kQ;                  // [kBk][HD]
  __nv_bfloat16* vs = ks + Sm::kTile;               // [kBk][HD]
  int* kseg = reinterpret_cast<int*>(vs + Sm::kTile);   // [kBk], SEG only
  constexpr int kD = HD / 8;       // 8-dim column blocks of the output

  const int seq = p.seq, kv_len = p.kv_len, hd = p.hd, window = p.window;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  // a 1-D grid, dispatched in order: every (head, batch row) of the last
  // query tile first (the longest bands), the first query tile last
  const int nq = (seq + kBq - 1) / kBq;
  const int rows = (int)gridDim.x / nq;             // heads * batch rows
  const int q0 = (nq - 1 - (int)blockIdx.x / rows) * kBq;
  const int h = (int)blockIdx.x % rows % p.heads;
  const size_t b = (size_t)((int)blockIdx.x % rows / p.heads);
  const int kh = h / (p.heads / p.kv_heads);
  const size_t q_stride = (size_t)p.heads * hd;      // one position of q, o
  const size_t kv_stride = (size_t)p.kv_heads * hd;  // one position of k, v
  const __nv_bfloat16* qb = q + b * (size_t)seq * q_stride + (size_t)h * hd;
  const __nv_bfloat16* kb = k + b * (size_t)kv_len * kv_stride +
                            (size_t)kh * hd;
  const __nv_bfloat16* vb = v + b * (size_t)kv_len * kv_stride +
                            (size_t)kh * hd;
  __nv_bfloat16* ob = o + b * (size_t)seq * q_stride + (size_t)h * hd;
  const int* sb = SEG ? seg + b * (size_t)seq : nullptr;
  const int row = q0 + warp * 16 + g;   // this thread's rows: row, row + 8

  // Segments.  This thread's two rows' ids (rows past S take the tile's
  // first id); the tile holds a row of segment <= 0 (has_pad), or one
  // segment > 0 in every row (q_uni: then a kv tile whose keys are all of
  // that segment needs no segment mask).  A tile with a padding row
  // visits every key: the row's scores are all -1e30, so each key's p is
  // 1 and the row takes the mean of V over T.
  int sq[2] = {1, 1};
  int seg0 = 1;
  bool has_pad = false, q_uni = false;
  if constexpr (SEG) {
    seg0 = sb[q0];
    bool pad = false, same = true;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sq[r] = row + 8 * r < seq ? sb[row + 8 * r] : seg0;
      pad = pad || sq[r] <= 0;
      same = same && sq[r] == seg0;
    }
    has_pad = __syncthreads_or(pad);
    q_uni = __syncthreads_and(same) && seg0 > 0;
  }

  const int nkv = (kv_len + kBk - 1) / kBk;
  const bool all_keys = !CAUSAL || has_pad;
  const int t_first = all_keys ? 0 : max(0, q0 - window + 1) / kBk;
  const int t_last = all_keys ? nkv - 1 : (min(q0 + kBq, seq) - 1) / kBk;

  // kv tile t's segment ids into kseg (keys take segments[:, :T], T <= S;
  // keys past T take -1); returns whether this thread's key is of the
  // query tile's one segment (true for threads that load no key)
  auto load_kseg = [&](int t) {
    if (!SEG || tid >= kBk) return true;
    const int j = t * kBk + tid;
    kseg[tid] = j < kv_len ? sb[j] : -1;
    return j < kv_len && sb[j] == seg0;
  };

  load_tile<HD, kBq>(qs, qb, q_stride, q0, seq, hd, vec, tid);
  load_tile<HD, kBk>(ks, kb, kv_stride, t_first * kBk, kv_len, hd, vec, tid);
  cp_async_commit();
  bool key_uni = load_kseg(t_first);

  float acc[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  // This lane's ldmatrix row addresses (bytes in shared memory).  Every
  // row it names has row % 8 == lane % 8, so chunk 8u + w of a row sits at
  // 8u + (w ^ lane % 8): four swizzled offsets per operand (w = 2j + the
  // lane's half), the rest compile-time constants.
  constexpr unsigned kRow = HD * sizeof(__nv_bfloat16);
  const int r7 = lane & 7;
  unsigned q_off[4], k_off[4], v_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // Q (A): rows 16 warp + lane % 16, dims 16kk + 8 (lane / 16)
    q_off[j] = smem_u32(qs) + (warp * 16 + (lane & 15)) * kRow +
               (((2 * j + (lane >> 4)) ^ r7) << 4);
    // K (B of Q K^T): keys 16 n2 + lane % 8 + 8 (lane / 16), dims
    // 16kk + 8 (lane / 8 % 2)
    k_off[j] = smem_u32(ks) + ((lane & 7) + ((lane >> 4) << 3)) * kRow +
               (((2 * j + ((lane >> 3) & 1)) ^ r7) << 4);
    // V (B of P V, transposed): keys 16kk + lane % 8 + 8 (lane / 8 % 2),
    // dims 16 d2 + 8 (lane / 16)
    v_off[j] = smem_u32(vs) + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRow +
               (((2 * j + (lane >> 4)) ^ r7) << 4);
  }

  for (int t = t_first; t <= t_last; ++t) {
    // K_t has landed and every warp is done with V_{t-1}: V_t's copy
    // runs under Q K_t^T and the softmax.  With segments the barrier also
    // finds whether tile t's keys and the query tile share one segment.
    cp_async_wait<0>();
    bool seg_mask = false;
    if constexpr (SEG)
      seg_mask = !(__syncthreads_and(key_uni) && q_uni);
    else
      __syncthreads();
    load_tile<HD, kBk>(vs, vb, kv_stride, t * kBk, kv_len, hd, vec, tid);
    cp_async_commit();

    // S = Q K^T: this warp's 16 rows x kBk keys, kNb blocks of 8 keys
    float s[kNb][4];
#pragma unroll
    for (int n = 0; n < kNb; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, q_off[kk & 3] + (kk >> 2) * 128);
#pragma unroll
      for (int n2 = 0; n2 < kNb / 2; ++n2) {
        unsigned bk[4];
        ldmatrix_x4(bk, k_off[kk & 3] + (kk >> 2) * 128 + n2 * 16 * kRow);
        mma(s[2 * n2], a, bk[0], bk[1]);
        mma(s[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }

    // scale; mask only the tiles that cross the diagonal or the window's
    // lower edge (causal; the ragged last tile is one of them), hold keys
    // past T (not causal), or mix segments.  Fragment element e: row + 8 *
    // (e / 2), key k0 + 8n + 2 tig + e % 2.  A key past T scores -inf (p =
    // 0: it never counts, not even in a padding row), another masked key
    // -1e30.  Causal without segments, a key past T = S lies past every
    // row's diagonal and the row's own key, so -1e30 gives it p = 0.
    const int k0 = t * kBk;
    const bool edge = CAUSAL ? (k0 + kBk - 1 > q0 ||
                                q0 + kBq - 1 - k0 >= window)
                             : k0 + kBk > kv_len;
#pragma unroll
    for (int n = 0; n < kNb; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[n][e], scale_log2);
        if (edge || seg_mask) {
          const int i = row + (e >> 1) * 8;
          const int c = n * 8 + tig * 2 + (e & 1);
          const int j = k0 + c;
          if constexpr (CAUSAL && !SEG) {
            if (j > i || i - j >= window) x = kNegInf;
          } else {
            const int si = sq[e >> 1];
            if (j >= kv_len)
              x = no_key();
            else if ((CAUSAL && (j > i || i - j >= window)) ||
                     (SEG && seg_mask && !(si > 0 && si == kseg[c])))
              x = kNegInf;
          }
        }
        s[n][e] = x;
      }

    // online softmax; a row's 4 lanes (a quad) share its max
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < kNb; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kNb; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2f(s[n][e] - mx);
          s[n][e] = p;
          sum = __fadd_rn(sum, p);
        }
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), sum);
    }
#pragma unroll
    for (int d = 0; d < kD; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = __fmul_rn(acc[d][e],
                                                        corr[e >> 1]);

    // V_t has landed and every warp is done with K_t: K_{t+1}'s copy runs
    // under P V_t
    cp_async_wait<0>();
    __syncthreads();
    if (t < t_last) {
      load_tile<HD, kBk>(ks, kb, kv_stride, (t + 1) * kBk, kv_len, hd, vec,
                         tid);
      cp_async_commit();
      key_uni = load_kseg(t + 1);   // every warp has masked tile t
    }

    // O += P V: P's f32 fragments of keys 16kk.. are the A fragment
#pragma unroll
    for (int kk = 0; kk < kNb / 2; ++kk) {
      const unsigned a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < kD / 2; ++d2) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, v_off[d2 & 3] + (d2 >> 2) * 128 +
                                  kk * 16 * kRow);
        mma(acc[2 * d2], a, bv[0], bv[1]);
        mma(acc[2 * d2 + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    l[r] = fmaxf(l[r], 1e-30f);
  }
  // stage the output in this warp's own Q rows (no other warp reads them)
  __nv_bfloat16* os = qs;
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = warp * 16 + g + 8 * r;
      *reinterpret_cast<__nv_bfloat162*>(os + swz<HD>(rr, d * 8 + tig * 2)) =
          __floats2bfloat162_rn(acc[d][2 * r] / l[r],
                                acc[d][2 * r + 1] / l[r]);
    }
  __syncwarp();
  if (vec) {
    constexpr int kChunks = HD / 8;
#pragma unroll
    for (int j = 0; j < 16 * kChunks / 32; ++j) {
      const int i = lane + 32 * j;
      const int rr = warp * 16 + i / kChunks, c = i % kChunks;
      const int s = q0 + rr;
      if (s < seq && c * 8 < hd)
        *reinterpret_cast<uint4*>(ob + (size_t)s * q_stride + c * 8) =
            *reinterpret_cast<const uint4*>(os + swz<HD>(rr, c * 8));
    }
  } else {
    for (int i = lane; i < 16 * HD; i += 32) {
      const int rr = warp * 16 + i / HD, d = i % HD;
      const int s = q0 + rr;
      if (s < seq && d < hd) ob[(size_t)s * q_stride + d] = os[swz<HD>(rr, d)];
    }
  }
}

template <int HD, bool CAUSAL, bool SEG>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* seg, long long bsz, const Dims& p, cudaStream_t st) {
  auto kern = swa_attention_tc_kernel<HD, CAUSAL, SEG>;
  const size_t smem = Smem<HD, SEG>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = p.hd % 8 == 0 &&
                  (((size_t)q | (size_t)k | (size_t)v | (size_t)o) & 15) == 0;
  const long long blocks = (p.seq + kBq - 1) / kBq * p.heads * bsz;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  // the softmax runs in base 2: scores times log2(e) / sqrt(hd)
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)p.hd);
  kern<<<grid, kThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, seg, p, scale_log2, vec);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_masks(const void* q, const void* k, const void* v, void* o,
                   const int* seg, long long bsz, const Dims& p,
                   cudaStream_t st) {
  if (seg != nullptr)
    return p.causal ? launch<HD, true, true>(q, k, v, o, seg, bsz, p, st)
                    : launch<HD, false, true>(q, k, v, o, seg, bsz, p, st);
  return p.causal ? launch<HD, true, false>(q, k, v, o, seg, bsz, p, st)
                  : launch<HD, false, false>(q, k, v, o, seg, bsz, p, st);
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             const int* seg, long long bsz, const Dims& p, cudaStream_t st) {
  if (p.hd <= 64) return dispatch_masks<64>(q, k, v, o, seg, bsz, p, st);
  if (p.hd <= 128) return dispatch_masks<128>(q, k, v, o, seg, bsz, p, st);
  if (p.hd <= 256) return dispatch_masks<256>(q, k, v, o, seg, bsz, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// q, o: (bsz, seq, heads, hd); k, v: (bsz, kv_len, kv_heads, hd);
// contiguous, all float32 (dtype 0: the CUDA-core kernel) or all
// bfloat16 (dtype 1: the tensor-core kernel).  segments: nullptr or
// (bsz, seq) int32.  bsz and heads in [1, 65535], seq >= 1, kv_len >= 1,
// kv_heads divides heads, 1 <= hd <= 256; causal: kv_len == seq and
// 1 <= window <= seq; not causal: window ignored; with segments kv_len <=
// seq.  Returns cudaGetLastError() (cudaErrorInvalidValue for another
// dtype or hd).
extern "C" int swa_attention(const void* q, const void* k, const void* v,
                             void* o, const void* segments, long long bsz,
                             long long seq, long long kv_len,
                             long long heads, long long kv_heads,
                             long long hd, long long window, int causal,
                             int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims p{(int)seq, (int)kv_len, (int)heads, (int)kv_heads, (int)hd,
               causal ? (int)window : (int)kv_len, causal ? 1 : 0};
  const int* seg = (const int*)segments;
  if (dtype == 0) return dispatch<float>(q, k, v, o, seg, bsz, p, st);
  if (dtype == 1) return tc::dispatch(q, k, v, o, seg, bsz, p, st);
  return (int)cudaErrorInvalidValue;
}
