// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the forward
// in flash_attention.cu.  The TPU package has no backward kernel (its
// training differentiates a jnp loop); the port sends every CUDA attention
// to the flash forward, so training on the card needs this one.
//
// What it computes.  With x = scale * q . k^T, or with the cap
// x = softcap * tanh(scale * q . k^T / softcap), the forward's masks (causal
// top-left aligned at q_offset, a sliding window, ragged lengths) and the
// forward's row log-sum-exp lse = m + log(l) (+inf for a row that kept no
// key), the kernels recompute P = exp(x - lse) (0 where masked) and form
//   D_i  = sum_d dO_i . O_i
//   dV  += P^T dO
//   dX   = P * (dO V^T - D)
//   dS   = scale * dX            (times 1 - tanh^2 under the cap)
//   dK  += dS^T Q,   dQ += dS K
// all in f32.  P is kept in f32 for dV (the forward rounds p to bf16
// before P.V; the backward is the gradient of the f32 function, as the
// plain backward in flash_attention.py is).  GQA: the g = h / hkv query
// heads of a kv head add into its dK / dV.
//
// Structure: three kernels, deterministic, with no atomics.
//  (a) flash_bwd_delta_kernel: one warp per query row, D_i.
//  (b) flash_bwd_dkdv_kernel: one CTA per (batch, kv head, 64-key tile).
//      K and V stay in shared memory; the CTA walks the group's query heads
//      and, for each, the 64-row query tiles that can see the tile (a
//      contiguous range under causal / window masks, computed exactly),
//      and writes dK and dV once.
//  (c) flash_bwd_dq_kernel: one CTA per (batch, head, 64-row query tile);
//      Q and dO stay in shared memory; it walks the kv tiles the forward
//      walked and writes dQ once.
// (b) and (c) each recompute S and dP: seven 64 x 64 x d products per
// (q tile, kv tile) pair where five would do with atomics or a dS buffer.
//
// What bounds it.  Operations: at olmo-1b's training shape (b 8, h 16,
// s 2048, d 128, causal) the five products of the kept pairs are 3.4e11
// operations, 0.35 ms at the bf16 tensor-core rate.  This kernel runs f32
// FMAs on the CUDA cores (about 67 TFLOP/s at most), for both dtypes:
// correct first.  Inputs are converted to f32 as they are staged in shared
// memory; each thread keeps a 4 x 4 block of S and dP and a 4 x (d / 16)
// block of its accumulators, and reads shared memory in 16-byte vectors.
// A wgmma backward is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;
};

constexpr int BQ = 64;          // query rows per tile
constexpr int BKV = 64;         // keys per tile
constexpr int TY = 16, TX = 16; // thread grid
constexpr int RM = BQ / TY;     // S rows per thread (4); also dK/dV/dQ rows
constexpr int CN = BKV / TX;    // S columns per thread (4)
constexpr int NTHREADS = TY * TX;
constexpr int LP = BKV + 4;     // row stride of the P / dS tiles (floats)

static_assert(RM == 4 && BQ == BKV, "float4 reads of P / dS rows assume 4");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
struct Geom {
  static constexpr int LD = D + 4;               // row stride of a [row][D] tile
  static constexpr int VEC = D >= 64 ? 4 : 2;    // columns per vector read
  static constexpr int NC = D / (TX * VEC);      // vectors per thread per row
  static constexpr int CW = NC * VEC;            // accumulator columns per thread
  static constexpr int TILE = BQ * LD;           // floats in one staged tile
};

// column of accumulator slot j of thread tx: vectors of VEC columns, TX * VEC
// apart, so a warp's reads of one row are contiguous
template <int D>
__device__ __forceinline__ int acc_col(int tx, int j) {
  using G = Geom<D>;
  return (j / G::VEC) * TX * G::VEC + tx * G::VEC + (j % G::VEC);
}

template <int D>
__device__ __forceinline__ void load_row_vec(const float* p, float* out) {
  using G = Geom<D>;
  if constexpr (G::VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  }
}

// rows [r0, r0 + 64) of a strided (s, D) head into a [64][LD] f32 tile;
// rows at or past n are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long stride_s,
                                      int r0, int n) {
  using G = Geom<D>;
  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * G::LD + c] = (r0 + r < n) ? to_f32(src[(long long)(r0 + r) * stride_s + c]) : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// S = Q K^T and dP = dO V^T for thread (ty, tx): rows ty*RM + i, columns
// tx + TX*j
template <int D>
__device__ __forceinline__ void s_and_dp(const float* q_s, const float* do_s,
                                         const float* k_s, const float* v_s, int ty,
                                         int tx, float (&s)[RM][CN], float (&dp)[RM][CN]) {
  using G = Geom<D>;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int dd = 0; dd < D; dd += 4) {
    float4 qa[RM], da[RM], kb[CN], vb[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(q_s + (ty * RM + i) * G::LD + dd);
      da[i] = *reinterpret_cast<const float4*>(do_s + (ty * RM + i) * G::LD + dd);
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      kb[j] = *reinterpret_cast<const float4*>(k_s + (tx + TX * j) * G::LD + dd);
      vb[j] = *reinterpret_cast<const float4*>(v_s + (tx + TX * j) * G::LD + dd);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = dot4(qa[i], kb[j], s[i][j]);
        dp[i][j] = dot4(da[i], vb[j], dp[i][j]);
      }
  }
}

// P and dS of one (q row, key) entry from the raw product s and dP
struct PdS {
  float p, ds;
};
__device__ __forceinline__ PdS p_and_ds(float s, float dp, float lse, float delta,
                                        bool keep, float scale, float softcap) {
  if (!keep) return {0.f, 0.f};
  float x = s * scale, t = 0.f;
  if (softcap > 0.f) {
    t = tanhf(x / softcap);
    x = t * softcap;
  }
  const float p = expf(x - lse);
  float ds = p * (dp - delta) * scale;
  if (softcap > 0.f) ds *= 1.f - t * t;
  return {p, ds};
}

__device__ __forceinline__ bool kept(int qi, int sq, int qpos, int kpos, int skv,
                                     int causal, int window) {
  return qi < sq && kpos < skv && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// the kv tiles [kt_lo, kt_hi] that hold a kept key for rows q0 .. q0+bq-1
// (the forward's walk)
__device__ __forceinline__ void kv_range(int q0, int sq, int skv, int causal, int window,
                                         int q_offset, int& kt_lo, int& kt_hi) {
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, sq) - 1;
  int k_hi = skv - 1;
  if (causal) k_hi = min(k_hi, qpos_hi);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, qpos_lo - window + 1);
  kt_lo = k_lo / BKV;
  kt_hi = (k_lo <= k_hi) ? k_hi / BKV : kt_lo - 1;
}

// the q tiles [qt_lo, qt_hi] with a row that keeps a key of k0 .. k0+BKV-1
__device__ __forceinline__ void q_range(int k0, int sq, int skv, int causal, int window,
                                        int q_offset, int& qt_lo, int& qt_hi) {
  const int k_last = min(k0 + BKV, skv) - 1;
  int lo = 0, hi = sq - 1;
  if (causal) lo = max(lo, k0 - q_offset);                  // kpos <= qpos
  if (window > 0) hi = min(hi, k_last + window - 1 - q_offset);  // kpos > qpos - window
  qt_lo = lo / BQ;
  qt_hi = (lo <= hi) ? hi / BQ : qt_lo - 1;
}

// (a) D_i = sum_d dO_i . O_i, one warp per row of the (b, h, sq) grid
template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
    int h, int sq, int d, long long n_rows, Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * (NTHREADS / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const long long bb = row / ((long long)h * sq);
  const int hh = (int)((row / sq) % h), i = (int)(row % sq);
  const T* orow = o + bb * os.b + hh * os.h + (long long)i * os.s;
  const T* drow = dout + bb * dos.b + hh * dos.h + (long long)i * dos.s;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// (b) dK and dV of one (batch, kv head, key tile)
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int h,
    int sq, int skv, int rep, Strides qs, Strides ks, Strides vs, Strides dos,
    Strides dks, Strides dvs, float scale, int causal, int window, float softcap,
    int q_offset) {
  using G = Geom<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* k_s = smem;              // [BKV][LD]
  float* v_s = k_s + G::TILE;
  float* q_s = v_s + G::TILE;     // [BQ][LD]
  float* do_s = q_s + G::TILE;
  float* p_s = do_s + G::TILE;    // [BQ][LP]
  float* ds_s = p_s + BQ * LP;
  float* lse_s = ds_s + BQ * LP;  // [BQ]
  float* dl_s = lse_s + BQ;       // [BQ]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int kt = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int k0 = kt * BKV;
  stage<T, D>(k_s, k + bb * ks.b + kh * ks.h, ks.s, k0, skv);
  stage<T, D>(v_s, v + bb * vs.b + kh * vs.h, vs.s, k0, skv);
  int qt_lo, qt_hi;
  q_range(k0, sq, skv, causal, window, q_offset, qt_lo, qt_hi);

  float dk_acc[RM][G::CW], dv_acc[RM][G::CW];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < G::CW; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int hh = kh * rep + r;
    const T* qb = q + bb * qs.b + hh * qs.h;
    const T* db = dout + bb * dos.b + hh * dos.h;
    const float* lb = lse + ((long long)bb * h + hh) * sq;
    const float* deb = delta + ((long long)bb * h + hh) * sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      stage<T, D>(q_s, qb, qs.s, q0, sq);
      stage<T, D>(do_s, db, dos.s, q0, sq);
      if (tid < BQ) {
        const bool in = q0 + tid < sq;
        lse_s[tid] = in ? lb[q0 + tid] : 0.f;
        dl_s[tid] = in ? deb[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[RM][CN], dp[RM][CN];
      s_and_dp<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qi = ty * RM + i;
        const int qpos = q_offset + q0 + qi;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int kj = tx + TX * j;
          const bool keep = kept(q0 + qi, sq, qpos, k0 + kj, skv, causal, window);
          const PdS e = p_and_ds(s[i][j], dp[i][j], lse_s[qi], dl_s[qi], keep, scale,
                                 softcap);
          p_s[qi * LP + kj] = e.p;
          ds_s[qi * LP + kj] = e.ds;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: thread rows ty*RM + i (keys), columns
      // acc_col(tx, j)
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        const float4 pa = *reinterpret_cast<const float4*>(p_s + qq * LP + ty * RM);
        const float4 sa = *reinterpret_cast<const float4*>(ds_s + qq * LP + ty * RM);
        const float pr[RM] = {pa.x, pa.y, pa.z, pa.w};
        const float sr[RM] = {sa.x, sa.y, sa.z, sa.w};
        float dov[G::CW], qv[G::CW];
#pragma unroll
        for (int c = 0; c < G::NC; ++c) {
          const int col = c * TX * G::VEC + tx * G::VEC;
          load_row_vec<D>(do_s + qq * G::LD + col, dov + c * G::VEC);
          load_row_vec<D>(q_s + qq * G::LD + col, qv + c * G::VEC);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < G::CW; ++j) {
            dv_acc[i][j] = fmaf(pr[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sr[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

  T* dkb = dk + bb * dks.b + kh * dks.h;
  T* dvb = dv + bb * dvs.b + kh * dvs.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty * RM + i;
    if (row >= skv) continue;
#pragma unroll
    for (int j = 0; j < G::CW; ++j) {
      const int col = acc_col<D>(tx, j);
      dkb[(long long)row * dks.s + col] = from_f32<T>(dk_acc[i][j]);
      dvb[(long long)row * dvs.s + col] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// (c) dQ of one (batch, head, query tile)
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int h, int sq, int skv,
    int rep, Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale,
    int causal, int window, float softcap, int q_offset) {
  using G = Geom<D>;
  constexpr int LQ = BQ + 4;  // row stride of the transposed dS tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;              // [BQ][LD]
  float* do_s = q_s + G::TILE;
  float* k_s = do_s + G::TILE;    // [BKV][LD]
  float* v_s = k_s + G::TILE;
  float* dst_s = v_s + G::TILE;   // dS^T [BKV][LQ]
  float* lse_s = dst_s + BKV * LQ;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  // heaviest (causal) q tiles first, so the tail of the grid is short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z, kh = hh / rep;
  const int q0 = qt * BQ;
  stage<T, D>(q_s, q + bb * qs.b + hh * qs.h, qs.s, q0, sq);
  stage<T, D>(do_s, dout + bb * dos.b + hh * dos.h, dos.s, q0, sq);
  if (tid < BQ) {
    const long long base = ((long long)bb * h + hh) * sq;
    const bool in = q0 + tid < sq;
    lse_s[tid] = in ? lse[base + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[base + q0 + tid] : 0.f;
  }
  const T* kb = k + bb * ks.b + kh * ks.h;
  const T* vb = v + bb * vs.b + kh * vs.h;
  int kt_lo, kt_hi;
  kv_range(q0, sq, skv, causal, window, q_offset, kt_lo, kt_hi);

  float dq_acc[RM][G::CW];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < G::CW; ++j) dq_acc[i][j] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous K and dS^T are read
    stage<T, D>(k_s, kb, ks.s, k0, skv);
    stage<T, D>(v_s, vb, vs.s, k0, skv);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
    s_and_dp<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = ty * RM + i;
      const int qpos = q_offset + q0 + qi;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = tx + TX * j;
        const bool keep = kept(q0 + qi, sq, qpos, k0 + kj, skv, causal, window);
        dst_s[kj * LQ + qi] =
            p_and_ds(s[i][j], dp[i][j], lse_s[qi], dl_s[qi], keep, scale, softcap).ds;
      }
    }
    __syncthreads();

    // dQ += dS K: thread rows ty*RM + i (queries), columns acc_col(tx, j)
#pragma unroll 2
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 sa = *reinterpret_cast<const float4*>(dst_s + kk * LQ + ty * RM);
      const float sr[RM] = {sa.x, sa.y, sa.z, sa.w};
      float kv[G::CW];
#pragma unroll
      for (int c = 0; c < G::NC; ++c)
        load_row_vec<D>(k_s + kk * G::LD + c * TX * G::VEC + tx * G::VEC, kv + c * G::VEC);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < G::CW; ++j) dq_acc[i][j] = fmaf(sr[i], kv[j], dq_acc[i][j]);
    }
  }

  T* dqb = dq + bb * dqs.b + hh * dqs.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < G::CW; ++j)
      dqb[(long long)row * dqs.s + acc_col<D>(tx, j)] = from_f32<T>(dq_acc[i][j]);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int b, h, hkv, sq, skv, d;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
  int causal, window;
  float softcap;
  int q_offset;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Args& a) {
  using G = Geom<D>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int rep = a.h / a.hkv;

  const long long n_rows = (long long)a.b * a.h * a.sq;
  const long long n_blocks = (n_rows + NTHREADS / 32 - 1) / (NTHREADS / 32);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T><<<(unsigned)n_blocks, NTHREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), dout, a.delta, a.h, a.sq, a.d, n_rows, a.os, a.dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv =
      sizeof(float) * (4 * (size_t)G::TILE + 2 * (size_t)BQ * LP + 2 * (size_t)BQ);
  auto kv_kern = flash_bwd_dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((a.skv + BKV - 1) / BKV, a.hkv, a.b);
  kv_kern<<<grid_kv, NTHREADS, smem_kv, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.h,
      a.sq, a.skv, rep, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.scale, a.causal,
      a.window, a.softcap, a.q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q =
      sizeof(float) * (4 * (size_t)G::TILE + (size_t)BKV * (BQ + 4) + 2 * (size_t)BQ);
  auto q_kern = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((a.sq + BQ - 1) / BQ, a.h, a.b);
  q_kern<<<grid_q, NTHREADS, smem_q, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.h, a.sq, a.skv, rep, a.qs,
      a.ks, a.vs, a.dos, a.dqs, a.scale, a.causal, a.window, a.softcap, a.q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dtype(int dtype, const Args& a) {
  return dtype == 0 ? launch<float, D>(a) : launch<__nv_bfloat16, D>(a);
}

}  // namespace

// The three backward kernels, in order, on one stream: delta, dK / dV, dQ.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv all of
// it); lse and the delta workspace are f32 (b, h, sq), contiguous.
// Strides are in elements for the (batch, head, seq) axes; the head-dim
// stride must be 1.  window <= 0 and softcap <= 0 mean "none".  Returns
// the CUDA error code (0 = launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int b,
    int h, int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss, float scale,
    int causal, int window, float softcap, int q_offset, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 || skv <= 0 ||
      b > 65535 || h > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, hkv, sq, skv, d,
               Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
               Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
               Strides{do_sb, do_sh, do_ss}, Strides{dq_sb, dq_sh, dq_ss},
               Strides{dk_sb, dk_sh, dk_ss}, Strides{dv_sb, dv_sh, dv_ss},
               scale, causal, window, softcap, q_offset,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 32:
      return launch_dtype<32>(dtype, a);
    case 64:
      return launch_dtype<64>(dtype, a);
    case 128:
      return launch_dtype<128>(dtype, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
