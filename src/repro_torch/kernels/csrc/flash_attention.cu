// Flash attention (online softmax) for Hopper (sm_90a).  Replaces the Pallas
// TPU kernel repro/kernels/flash_attention.py::_flash_kernel, which
// repro/kernels/ops.py::flash_attention vmaps over batch and heads.
//
// What it computes: for every (batch, head) and query row,
//   o = softmax(mask(softcap(scale * q . k^T))) . v
// with a causal mask (top-left aligned: query i at position q_offset + i
// sees keys 0 .. q_offset + i), a sliding window (keys > qpos - window), a
// tanh logit cap, and f32 running max / sum / accumulator.  As in the TPU
// kernel, p is rounded to v's dtype before the P.V product (a no-op for
// f32) while the running sum takes the unrounded p; masked logits are the
// finite -1e30, and a row that kept no key at all writes zeros (the
// l == 0 guard).  Masked entries contribute p = 0 explicitly, so a kv tile
// that holds no kept key for a row leaves that row's state unchanged.
//
// Structure.  The TPU kernel walks a sequential (q tile, kv tile) grid and
// carries m / l / acc in VMEM scratch across the kv sweep.  CUDA blocks run
// in parallel and in no order, so here ONE CTA owns one (batch, head,
// 64-row q tile) and walks the kv tiles itself, in order, with m, l and the
// accumulator in registers; the output is written once.  The kv head is
// h / (h / hkv): grouped-query heads share K/V without a repeated copy.
// Only kv tiles that hold a kept key for some row of the q tile are visited
// (for causal/window masks a contiguous range, computed exactly, so the
// skip changes no result).  Any sq and skv: the ragged q rows are never
// stored, the ragged kv columns are masked.  Inputs are read through
// (batch, head, seq) strides with a unit last stride, so the projections'
// head-transposed views and a (b, s, h, d) output need no copies.
//
// Threads.  128 threads as 8 x 16: thread (ty, tx) owns query rows
// ty*8 .. ty*8+7 and, in S = Q K^T, kv columns tx + 16 j (j < 4); in the
// output, columns tx + 16 j (j < D/16).  Shared memory holds the q tile
// (f32, row stride D+1), one kv buffer reused for K (transposed, stride
// BKV+1) and then V (row-major), and P (stride BKV+1): conflict-free reads in
// both products.  Row max and row sum are 16-lane shuffles: a row's 16
// threads are adjacent lanes of one warp.
//
// What bounds it on the H100.  At the serving shape (s = 2048, d = 128,
// causal) attention does about 4 d = 512 operations per kept (q, k) pair
// against a few bytes per pair, far above the card's ~295 op/byte ridge:
// it is bound by operations, and a tensor-core design would aim at the
// 989 TFLOP/s bf16 rate (bf16 products are exact in f32).  This first
// kernel runs f32 FMAs on the CUDA cores (67 TFLOP/s peak), fed from
// shared memory: each k step of the products issues 12 shared loads per
// 32 FMAs (S) and 16 per 64 (P.V), so shared-memory issue caps it well
// below the f32 peak.  wgmma, TMA, cp.async pipelines and register-resident
// P are left for the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BKV = 64;        // keys per kv tile
constexpr int TY = 8, TX = 16; // thread grid
constexpr int RM = BQ / TY;    // query rows per thread (8)
constexpr int CN = BKV / TX;   // kv columns per thread in S (4)
constexpr int NTHREADS = TY * TX;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)D * (BKV + 1) + (size_t)BQ * (BKV + 1));
}

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int sq, int skv, int rep, Strides qs, Strides ks,
    Strides vs, Strides os, float scale, int causal, int window,
    float softcap, int q_offset) {
  constexpr int CD = D / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                         // [BQ][D + 1]
  float* kv_s = q_s + BQ * (D + 1);          // K^T [D][BKV + 1] or V [BKV][D]
  float* p_s = kv_s + D * (BKV + 1);         // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  // heaviest (causal) q tiles first, so the tail of the grid is short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / rep;
  const int q0 = qt * BQ;
  const T* qb = q + bb * qs.b + hh * qs.h;
  const T* kb = k + bb * ks.b + kh * ks.h;
  const T* vb = v + bb * vs.b + kh * vs.h;
  T* ob = o + bb * os.b + hh * os.h;

  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    q_s[r * (D + 1) + c] = (q0 + r < sq) ? to_f32(qb[(q0 + r) * qs.s + c]) : 0.f;
  }

  // the kv range holding a kept key for some row of this tile
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, sq) - 1;
  int k_hi = skv - 1;
  if (causal) k_hi = min(k_hi, qpos_hi);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, qpos_lo - window + 1);
  const int kt_lo = k_lo / BKV;
  const int kt_hi = (k_lo <= k_hi) ? k_hi / BKV : kt_lo - 1;

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // q tile stored / previous V no longer read
    for (int idx = tid; idx < BKV * D; idx += NTHREADS) {
      const int r = idx / D, c = idx % D;
      kv_s[c * (BKV + 1) + r] = (k0 + r < skv) ? to_f32(kb[(k0 + r) * ks.s + c]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty * RM + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = kv_s[d * (BKV + 1) + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float p[RM][CN], corr[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q_offset + q0 + ty * RM + i;
      bool keep[CN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + TX * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        keep[j] = kpos < skv && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        s[i][j] = keep[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float e = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += e;
        p[i][j] = round_to(e, T());
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done with K
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) p_s[(ty * RM + i) * (BKV + 1) + tx + TX * j] = p[i][j];
    for (int idx = tid; idx < BKV * D; idx += NTHREADS) {
      const int r = idx / D, c = idx % D;
      kv_s[r * D + c] = (k0 + r < skv) ? to_f32(vb[(k0 + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr[i];
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[RM], vv[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty * RM + i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = kv_s[kk * D + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r >= sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < CD; ++j) store_out(&ob[r * os.s + tx + TX * j], acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h,
           int hkv, int sq, int skv, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, int causal, int window, float softcap,
           int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, h / hkv, qs, ks,
      vs, os, scale, causal, window, softcap, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               int b, int h, int hkv, int sq, int skv, Strides qs, Strides ks,
               Strides vs, Strides os, float scale, int causal, int window,
               float softcap, int q_offset, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, h, hkv, sq, skv, qs, ks, vs, os,
                           scale, causal, window, softcap, q_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, o, b, h, hkv, sq, skv, qs, ks, vs, os,
                           scale, causal, window, softcap, q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, o, b, h, hkv, sq, skv, qs, ks, vs, os,
                            scale, causal, window, softcap, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// (batch, head, seq) axes; the head-dim stride must be 1.  window <= 0 and
// softcap <= 0 mean "none".  Returns the CUDA error code (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int h, int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    float softcap, int q_offset, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 || skv <= 0 ||
      b > 65535 || h > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, b, h, hkv, sq, skv, qs, ks, vs, os,
                             scale, causal, window, softcap, q_offset, s);
  return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, h, hkv, sq, skv, qs, ks,
                                   vs, os, scale, causal, window, softcap,
                                   q_offset, s);
}
