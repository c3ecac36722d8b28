// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the forward
// in flash_attention.cu.  The TPU package has no backward kernel (its
// training differentiates a jnp loop over repro/kernels/flash_attention.py::
// _flash_kernel's function); the port sends every CUDA attention to the flash
// forward, so training on the card needs this one.
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
// with f32 sums.  The backward is the gradient of the f32 function the plain
// backward in flash_attention.py computes.  GQA: the g = h / hkv query heads
// of a kv head add into its dK / dV.
//
// Structure: three kernels, deterministic, with no atomics.
//  (a) flash_bwd_delta_kernel: one warp per query row, D_i (and, for the
//      bf16 kernels, a copy of lse in the same padded layout).
//  (b) dK / dV: one CTA per (batch, kv head, key tile).  K and V stay in
//      shared memory; the CTA walks the group's query heads and, for each,
//      the query tiles that can see the tile (a contiguous range under
//      causal / window masks, computed exactly), and writes dK and dV once.
//  (c) dQ: one CTA per (batch, head, query tile); Q and dO stay in shared
//      memory; it walks the kv tiles the forward walked and writes dQ once.
// (b) and (c) each recompute S and dP, where atomics into an f32 dQ would
// save those two products but make the sums' order change from run to run.
//
// What bounds it.  Operations: at olmo-1b's training shape (b 8, h 16,
// s 2048, d 128, causal) the five products of the kept pairs are 3.4e11
// operations, 0.35 ms at the bf16 tensor-core rate.
//
// bf16: tensor-core kernels (flash_bwd_dkdv_bf16_kernel, flash_bwd_dq_bf16_
// kernel), written as the forward's flash_bf16_kernel is (hopper.cuh).
//  - (b) is two consumer warpgroups of 64 keys (128 keys a CTA).  Per 64-row
//    query tile: S^T = K . Q^T and dP^T = V . dO^T on wgmma m64n64k16 from
//    shared memory (both operands K-major); P^T and dS^T in registers; then
//    dV += P^T . dO and dK += dS^T . Q on wgmma m64nDk16 with A from
//    REGISTERS (the accumulator's layout is the A fragment's) and B from
//    shared memory with the transpose flag.  Q and dO tiles (with their lse
//    and delta, 1-D bulk copies of the padded rows) arrive through a
//    two-stage TMA ring with full / empty mbarriers; thread 0 starts item
//    i+1's copies before item i's products.
//  - (c) is two consumer warpgroups of 64 query rows (128 rows a CTA): S =
//    Q . K^T and dP = dO . V^T from shared memory, P and dS in registers,
//    dQ += dS . K with dS from registers and K transposed; 64-key K / V
//    tiles through the ring.  The forward's structure, one product more.
//  - P and dS enter their products as bf16 pairs hi + lo (hi = bf16(x), lo
//    = bf16(x - hi)), two wgmmas into one accumulator.  One bf16 rounding
//    of P and dS (2^-9 relative a term) moves an early key's dK / dV, a sum
//    over ~2,000 queries whose first terms are large and cancel, by up to 12
//    times phase 22's limit at olmo's shape (tests/test_torch_flash_
//    attention.py emulates both); the split costs three products more,
//    seven products become ten.
//  - A warpgroup skips the products of a tile in which none of its pairs is
//    kept (the causal diagonal), and evaluates masks only on the tiles that
//    need them.  Shared memory at d 128: 64 KB resident + 2 stages x 32 KB.
//  - The tile index is the grid's slowest axis, so the heaviest causal
//    tiles of every head launch first and the grid's tail is light ones:
//    on an H100 at olmo's shape 1.92-1.95 ms against 2.16-2.29 ms with the
//    tile index fastest (chip_smoke.py phase 22's timing, in turns).
// f32: SIMT kernels (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel), kept for
//    f32 inputs: TF32 would break the 1e-4 parity with the reference.  f32
//    FMAs on the CUDA cores; each thread keeps a 4 x 4 block of S and dP and
//    a 4 x (d / 16) block of its accumulators, and reads shared memory in
//    16-byte vectors.
//
// Left for later: a producer warp with setmaxnreg, overlapping one tile's
// softmax with the next tile's products, and atomics into an f32 dQ.
#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace hopper;

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
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride_s,
                                      int r0, int n) {
  using G = Geom<D>;
  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * G::LD + c] = (r0 + r < n) ? src[(long long)(r0 + r) * stride_s + c] : 0.f;
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

// the kv tiles [kt_lo, kt_hi] of bkv keys that hold a kept key for rows
// q0 .. q0+bq-1 (the forward's walk)
__device__ __forceinline__ void kv_range(int q0, int bq, int bkv, int sq, int skv,
                                         int causal, int window, int q_offset,
                                         int& kt_lo, int& kt_hi) {
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + bq, sq) - 1;
  int k_hi = skv - 1;
  if (causal) k_hi = min(k_hi, qpos_hi);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, qpos_lo - window + 1);
  kt_lo = k_lo / bkv;
  kt_hi = (k_lo <= k_hi) ? k_hi / bkv : kt_lo - 1;
}

// the q tiles [qt_lo, qt_hi] of bq rows with a row that keeps a key of
// k0 .. k0+bkv-1
__device__ __forceinline__ void q_range(int k0, int bkv, int bq, int sq, int skv,
                                        int causal, int window, int q_offset,
                                        int& qt_lo, int& qt_hi) {
  const int k_last = min(k0 + bkv, skv) - 1;
  int lo = 0, hi = sq - 1;
  if (causal) lo = max(lo, k0 - q_offset);                  // kpos <= qpos
  if (window > 0) hi = min(hi, k_last + window - 1 - q_offset);  // kpos > qpos - window
  qt_lo = lo / bq;
  qt_hi = (lo <= hi) ? hi / bq : qt_lo - 1;
}

// (a) D_i = sum_d dO_i . O_i, one warp per row of a (b, h, ld) grid, ld >=
// sq; rows past sq get D = 0.  lse_out (bf16 kernels only): the forward's
// lse (b, h, sq) copied to the same (b, h, ld) layout, +inf past sq, so a
// query tile's rows are one aligned 1-D bulk copy
template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ lse_out, int h, int sq, int ld, int d,
    long long n_rows, Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * (NTHREADS / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / ld;
  const long long bb = bh / h;
  const int hh = (int)(bh % h), i = (int)(row % ld);
  float acc = 0.f;
  if (i < sq) {
    const T* orow = o + bb * os.b + hh * os.h + (long long)i * os.s;
    const T* drow = dout + bb * dos.b + hh * dos.h + (long long)i * dos.s;
    for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    delta[row] = acc;
    if (lse_out != nullptr) lse_out[row] = i < sq ? lse[bh * sq + i] : INFINITY;
  }
}

// (b) f32: dK and dV of one (batch, kv head, 64-key tile)
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int h,
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
  stage<D>(k_s, k + bb * ks.b + kh * ks.h, ks.s, k0, skv);
  stage<D>(v_s, v + bb * vs.b + kh * vs.h, vs.s, k0, skv);
  int qt_lo, qt_hi;
  q_range(k0, BKV, BQ, sq, skv, causal, window, q_offset, qt_lo, qt_hi);

  float dk_acc[RM][G::CW], dv_acc[RM][G::CW];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < G::CW; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int hh = kh * rep + r;
    const float* qb = q + bb * qs.b + hh * qs.h;
    const float* db = dout + bb * dos.b + hh * dos.h;
    const float* lb = lse + ((long long)bb * h + hh) * sq;
    const float* deb = delta + ((long long)bb * h + hh) * sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      stage<D>(q_s, qb, qs.s, q0, sq);
      stage<D>(do_s, db, dos.s, q0, sq);
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

  float* dkb = dk + bb * dks.b + kh * dks.h;
  float* dvb = dv + bb * dvs.b + kh * dvs.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty * RM + i;
    if (row >= skv) continue;
#pragma unroll
    for (int j = 0; j < G::CW; ++j) {
      const int col = acc_col<D>(tx, j);
      dkb[(long long)row * dks.s + col] = dk_acc[i][j];
      dvb[(long long)row * dvs.s + col] = dv_acc[i][j];
    }
  }
}

// (c) f32: dQ of one (batch, head, 64-row query tile)
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int h, int sq, int skv,
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
  stage<D>(q_s, q + bb * qs.b + hh * qs.h, qs.s, q0, sq);
  stage<D>(do_s, dout + bb * dos.b + hh * dos.h, dos.s, q0, sq);
  if (tid < BQ) {
    const long long base = ((long long)bb * h + hh) * sq;
    const bool in = q0 + tid < sq;
    lse_s[tid] = in ? lse[base + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[base + q0 + tid] : 0.f;
  }
  const float* kb = k + bb * ks.b + kh * ks.h;
  const float* vb = v + bb * vs.b + kh * vs.h;
  int kt_lo, kt_hi;
  kv_range(q0, BQ, BKV, sq, skv, causal, window, q_offset, kt_lo, kt_hi);

  float dq_acc[RM][G::CW];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < G::CW; ++j) dq_acc[i][j] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous K and dS^T are read
    stage<D>(k_s, kb, ks.s, k0, skv);
    stage<D>(v_s, vb, vs.s, k0, skv);
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

  float* dqb = dq + bb * dqs.b + hh * dqs.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < G::CW; ++j)
      dqb[(long long)row * dqs.s + acc_col<D>(tx, j)] = dq_acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA kernels (b) and (c).  Thread (warpgroup wg, warp w, lane
// 4 g + t) holds accumulator rows wg*64 + w*16 + g and + 8 (keys in (b),
// query rows in (c)), columns 8 j + 2 t + {0, 1} (hopper.cuh).
namespace tc {

constexpr int NTHREADS = 256;  // two consumer warpgroups
constexpr int BLOCK = 128;     // a CTA's resident rows: keys in (b), query rows in (c)
constexpr int TILE = 64;       // rows of a ring item: query rows in (b), keys in (c)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geom : Swizzle<D> {
  static constexpr uint32_t RES_BYTES = BLOCK * D * 2;  // one resident tile
  static constexpr uint32_t ITEM_BYTES = TILE * D * 2;  // one ring tile
  static constexpr uint32_t ROW_BYTES = TILE * 4;       // a ring item's lse or delta
  // two resident tiles, two stages of two ring tiles, two stages of lse and
  // delta, 5 mbarriers; 1 KB of alignment slack
  static constexpr size_t SMEM = 2 * (size_t)RES_BYTES + 4 * (size_t)ITEM_BYTES +
                                 4 * (size_t)ROW_BYTES + 64 + 1024;
};

__device__ __forceinline__ bool kept_pair(int qi, int kpos, int skv, int causal,
                                          int window, int q_offset) {
  const int qpos = q_offset + qi;
  return kpos < skv && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// whether query rows q_lo..q_hi and keys k_lo..k_hi hold a kept pair
__device__ __forceinline__ bool block_live(int q_lo, int q_hi, int k_lo, int k_hi, int sq,
                                          int skv, int causal, int window,
                                          int q_offset) {
  q_hi = min(q_hi, sq - 1);
  k_hi = min(k_hi, skv - 1);
  if (q_lo > q_hi || k_lo > k_hi) return false;
  if (causal && k_lo > q_offset + q_hi) return false;
  if (window > 0 && q_offset + q_lo > k_hi + window - 1) return false;
  return true;
}

// whether the block holds a masked pair among rows below sq (rows past sq
// have lse = +inf, so P = 0 there without a mask)
__device__ __forceinline__ bool block_masked(int q_lo, int q_hi, int k_lo, int k_hi,
                                            int skv, int causal, int window,
                                            int q_offset) {
  return k_hi >= skv || (causal && k_hi > q_offset + q_lo) ||
         (window > 0 && k_lo <= q_offset + q_hi - window);
}

// P and dS of one pair in place: s (the raw q . k) becomes P, dp becomes dS.
// lse2 is lse * log2(e); sc and cap put the logit in the log2 domain
__device__ __forceinline__ void p_and_ds(float& s, float& dp, float lse2, float dl,
                                         float sc, float cap, float scale, bool capped) {
  float x, dsc = scale;
  if (capped) {
    const float th = tanhf(s * sc);
    x = th * cap;
    dsc *= 1.f - th * th;
  } else {
    x = s * sc;
  }
  const float p = ex2(x - lse2);
  s = p;
  dp = p * (dp - dl) * dsc;
}

}  // namespace tc

// (b) bf16: dK and dV of one (batch, kv head, 128-key tile).  Ring items are
// (query head of the group, 64-row query tile) pairs: item i is head kh *
// rep + i / n_qt, tile qt_lo + i % n_qt.
template <int D>
__global__ void __launch_bounds__(tc::NTHREADS, 1) flash_bwd_dkdv_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, int ld,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int h, int sq,
    int skv, int rep, Strides dks, Strides dvs, float scale, int causal, int window,
    float softcap, int q_offset) {
  using G = tc::Geom<D>;
  constexpr int NS = tc::TILE / 2;  // S^T / dP^T registers per thread (64 x 64)
  constexpr int NA = D / 2;         // dK / dV registers per thread (64 x D)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t s_k = (base + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t s_v = s_k + G::RES_BYTES;
  const uint32_t s_q = s_v + G::RES_BYTES;  // stage st at + st * ITEM_BYTES
  const uint32_t s_do = s_q + 2 * G::ITEM_BYTES;
  const uint32_t s_lse = s_do + 2 * G::ITEM_BYTES;  // stage st at + st * ROW_BYTES
  const uint32_t s_dl = s_lse + 2 * G::ROW_BYTES;
  const uint32_t bar_kv = s_dl + 2 * G::ROW_BYTES;  // then full[2], empty[2]
  auto bar_f = [&](int st) { return bar_kv + 8 + 8 * st; };
  auto bar_e = [&](int st) { return bar_kv + 24 + 8 * st; };
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (s_lse - base));
  const float* dl_s = reinterpret_cast<const float*>(smem_raw + (s_dl - base));

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4;
  // key tiles on the grid's slowest axis: the heaviest (causal) tiles of
  // every head launch first, so the tail of the grid is short
  const int kh = blockIdx.x, bb = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * tc::BLOCK;
  const int kw0 = k0 + wg * 64;                 // this warpgroup's keys
  const int key0 = kw0 + warp * 16 + lane / 4;  // and key0 + 8
  int qt_lo, qt_hi;
  q_range(k0, tc::BLOCK, tc::TILE, sq, skv, causal, window, q_offset, qt_lo, qt_hi);
  const int n_qt = qt_hi - qt_lo + 1;
  const int n_items = n_qt > 0 ? rep * n_qt : 0;

  float dk_acc[NA], dv_acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_items > 0) {
    if (tid == 0) {
      mbar_init(bar_kv, 1);
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        mbar_init(bar_f(st), 1);
        mbar_init(bar_e(st), 2);  // one arrival per warpgroup
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // thread 0: item i's Q, dO, lse and delta into stage st
    const CUtensorMap *mq = &tq, *mdo = &tdo;
    auto load_item = [&](int i, int st) {
      const int hh = kh * rep + i / n_qt, q0 = (qt_lo + i % n_qt) * tc::TILE;
      const uint32_t bar = bar_f(st);
      mbar_expect_tx(bar, 2 * G::ITEM_BYTES + 2 * G::ROW_BYTES);
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb) {
        const uint32_t off = st * G::ITEM_BYTES + cb * tc::TILE * G::ROWB;
        tma_load_4d(s_q + off, mq, bar, cb * G::CB, q0, hh, bb);
        tma_load_4d(s_do + off, mdo, bar, cb * G::CB, q0, hh, bb);
      }
      const long long row = ((long long)bb * h + hh) * ld + q0;
      bulk_load(s_lse + st * G::ROW_BYTES, lse + row, G::ROW_BYTES, bar);
      bulk_load(s_dl + st * G::ROW_BYTES, delta + row, G::ROW_BYTES, bar);
    };
    if (tid == 0) {
      mbar_expect_tx(bar_kv, 2 * G::RES_BYTES);
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb) {
        tma_load_4d(s_k + cb * tc::BLOCK * G::ROWB, &tk, bar_kv, cb * G::CB, k0, kh, bb);
        tma_load_4d(s_v + cb * tc::BLOCK * G::ROWB, &tv, bar_kv, cb * G::CB, k0, kh, bb);
      }
      load_item(0, 0);
    }
    const bool capped = softcap > 0.f;
    const float sc = capped ? scale / softcap : scale * tc::LOG2E;
    const float cap = softcap * tc::LOG2E;

    for (int it = 0; it < n_items; ++it) {
      const int st = it & 1;
      const uint32_t ph = (it >> 1) & 1;
      if (tid == 0 && it + 1 < n_items) {
        // item it+1 goes to the stage item it-1 used, once both warpgroups
        // have released it
        const int nst = (it + 1) & 1;
        if (it >= 1) mbar_wait(bar_e(nst), (((it + 1) >> 1) - 1) & 1);
        load_item(it + 1, nst);
      }
      __syncwarp();
      const int q0 = (qt_lo + it % n_qt) * tc::TILE;
      mbar_wait(bar_kv, 0);
      mbar_wait(bar_f(st), ph);
      if (tc::block_live(q0, q0 + tc::TILE - 1, kw0, kw0 + 63, sq, skv, causal, window,
                     q_offset)) {
        const uint32_t q_st = s_q + st * G::ITEM_BYTES, do_st = s_do + st * G::ITEM_BYTES;
        // S^T = K . Q^T and dP^T = V . dO^T (64 keys x 64 queries each)
        float s[NS], dp[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int cb = kk / (G::CB / 16), kin = kk % (G::CB / 16);
          const uint32_t a_off = cb * tc::BLOCK * G::ROWB + wg * 64 * G::ROWB + kin * 32;
          const uint32_t b_off = cb * tc::TILE * G::ROWB + kin * 32;
          wgmma_ss_n64(s, make_desc<D>(s_k + a_off, 16, 8 * G::ROWB),
                       make_desc<D>(q_st + b_off, 16, 8 * G::ROWB), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int cb = kk / (G::CB / 16), kin = kk % (G::CB / 16);
          const uint32_t a_off = cb * tc::BLOCK * G::ROWB + wg * 64 * G::ROWB + kin * 32;
          const uint32_t b_off = cb * tc::TILE * G::ROWB + kin * 32;
          wgmma_ss_n64(dp, make_desc<D>(s_v + a_off, 16, 8 * G::ROWB),
                       make_desc<D>(do_st + b_off, 16, 8 * G::ROWB), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<NS>(s);
        fence_regs<NS>(dp);

        // P^T and dS^T in place; column c of the tile is query q0 + c
        const bool need_mask = tc::block_masked(q0, q0 + tc::TILE - 1, kw0, kw0 + 63, skv,
                                            causal, window, q_offset);
        const float* lse_st = lse_s + st * tc::TILE;
        const float* dl_st = dl_s + st * tc::TILE;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_st + c);
          const float2 d2 = *reinterpret_cast<const float2*>(dl_st + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            if (need_mask && !tc::kept_pair(q0 + c + (e & 1), key0 + 8 * (e >> 1), skv,
                                        causal, window, q_offset)) {
              s[i] = dp[i] = 0.f;
            } else {
              tc::p_and_ds(s[i], dp[i], ((e & 1) ? l2.y : l2.x) * tc::LOG2E,
                       (e & 1) ? d2.y : d2.x, sc, cap, scale, capped);
            }
          }
        }
        // dV += P^T . dO and dK += dS^T . Q over the 64 queries, each
        // operand as bf16 hi + lo
        uint32_t p_hi[tc::TILE / 16][4], p_lo[tc::TILE / 16][4];
        uint32_t d_hi[tc::TILE / 16][4], d_lo[tc::TILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < tc::TILE / 16; ++kk) {
          pack_frag_split(s, kk, p_hi[kk], p_lo[kk]);
          pack_frag_split(dp, kk, d_hi[kk], d_lo[kk]);
        }
        fence_regs<NA>(dv_acc);
        fence_regs<NA>(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < tc::TILE / 16; ++kk) {
          const uint64_t db = make_desc<D>(do_st + kk * 16 * G::ROWB, tc::TILE * G::ROWB,
                                           8 * G::ROWB);
          wgmma_rs<D>(dv_acc, p_hi[kk], db);
          wgmma_rs<D>(dv_acc, p_lo[kk], db);
        }
#pragma unroll
        for (int kk = 0; kk < tc::TILE / 16; ++kk) {
          const uint64_t db = make_desc<D>(q_st + kk * 16 * G::ROWB, tc::TILE * G::ROWB,
                                           8 * G::ROWB);
          wgmma_rs<D>(dk_acc, d_hi[kk], db);
          wgmma_rs<D>(dk_acc, d_lo[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<NA>(dv_acc);
        fence_regs<NA>(dk_acc);
      }
      if ((tid & 127) == 0) mbar_arrive(bar_e(st));  // this stage is free
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= skv) continue;
    __nv_bfloat16* krow = dk + bb * dks.b + kh * dks.h + (long long)key * dks.s;
    __nv_bfloat16* vrow = dv + bb * dvs.b + kh * dvs.h + (long long)key * dvs.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// (c) bf16: dQ of one (batch, head, 128-row query tile); 64-key K / V tiles
// of the forward's kv range through the ring.
template <int D>
__global__ void __launch_bounds__(tc::NTHREADS, 1) flash_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, int ld,
    __nv_bfloat16* __restrict__ dq, int h, int sq, int skv, int rep, Strides dqs,
    float scale, int causal, int window, float softcap, int q_offset) {
  using G = tc::Geom<D>;
  constexpr int NS = tc::TILE / 2;  // S / dP registers per thread (64 x 64)
  constexpr int NA = D / 2;         // dQ registers per thread (64 x D)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t s_do = s_q + G::RES_BYTES;
  const uint32_t s_k = s_do + G::RES_BYTES;  // stage st at + st * ITEM_BYTES
  const uint32_t s_v = s_k + 2 * G::ITEM_BYTES;
  const uint32_t bar_q = s_v + 2 * G::ITEM_BYTES;  // then full[2], empty[2]
  auto bar_f = [&](int st) { return bar_q + 8 + 8 * st; };
  auto bar_e = [&](int st) { return bar_q + 24 + 8 * st; };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4;
  // query tiles on the grid's slowest axis, the heaviest (causal) of every
  // head first, so the tail of the grid is short
  const int hh = blockIdx.x, bb = blockIdx.y, kh = hh / rep;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * tc::BLOCK;
  const int qw0 = q0 + wg * 64;                 // this warpgroup's rows
  const int row0 = qw0 + warp * 16 + lane / 4;  // and row0 + 8
  int kt_lo, kt_hi;
  kv_range(q0, tc::BLOCK, tc::TILE, sq, skv, causal, window, q_offset, kt_lo, kt_hi);
  const int n_tiles = kt_hi - kt_lo + 1;

  float dq_acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq_acc[i] = 0.f;

  if (n_tiles > 0) {
    // this thread's two rows: lse in the log2 domain and delta (rows past sq
    // get P = 0)
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long at = ((long long)bb * h + hh) * ld + row;
      lse2[r] = row < sq ? lse[at] * tc::LOG2E : INFINITY;
      dl[r] = row < sq ? delta[at] : 0.f;
    }
    if (tid == 0) {
      mbar_init(bar_q, 1);
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        mbar_init(bar_f(st), 1);
        mbar_init(bar_e(st), 2);  // one arrival per warpgroup
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // thread 0: kv tile kt's K and V into stage st
    const CUtensorMap *mk = &tk, *mv = &tv;
    auto load_kv = [&](int kt, int st) {
      const uint32_t bar = bar_f(st);
      mbar_expect_tx(bar, 2 * G::ITEM_BYTES);
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb) {
        const uint32_t off = st * G::ITEM_BYTES + cb * tc::TILE * G::ROWB;
        tma_load_4d(s_k + off, mk, bar, cb * G::CB, kt * tc::TILE, kh, bb);
        tma_load_4d(s_v + off, mv, bar, cb * G::CB, kt * tc::TILE, kh, bb);
      }
    };
    if (tid == 0) {
      mbar_expect_tx(bar_q, 2 * G::RES_BYTES);
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb) {
        tma_load_4d(s_q + cb * tc::BLOCK * G::ROWB, &tq, bar_q, cb * G::CB, q0, hh, bb);
        tma_load_4d(s_do + cb * tc::BLOCK * G::ROWB, &tdo, bar_q, cb * G::CB, q0, hh, bb);
      }
      load_kv(kt_lo, 0);
    }
    const bool capped = softcap > 0.f;
    const float sc = capped ? scale / softcap : scale * tc::LOG2E;
    const float cap = softcap * tc::LOG2E;

    for (int it = 0; it < n_tiles; ++it) {
      const int kt = kt_lo + it, st = it & 1;
      const uint32_t ph = (it >> 1) & 1;
      if (tid == 0 && it + 1 < n_tiles) {
        const int nst = (it + 1) & 1;
        if (it >= 1) mbar_wait(bar_e(nst), (((it + 1) >> 1) - 1) & 1);
        load_kv(kt + 1, nst);
      }
      __syncwarp();
      const int k0 = kt * tc::TILE;
      mbar_wait(bar_q, 0);
      mbar_wait(bar_f(st), ph);
      if (tc::block_live(qw0, qw0 + 63, k0, k0 + tc::TILE - 1, sq, skv, causal, window,
                     q_offset)) {
        const uint32_t k_st = s_k + st * G::ITEM_BYTES, v_st = s_v + st * G::ITEM_BYTES;
        // S = Q . K^T and dP = dO . V^T (64 rows x 64 keys each)
        float s[NS], dp[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int cb = kk / (G::CB / 16), kin = kk % (G::CB / 16);
          const uint32_t a_off = cb * tc::BLOCK * G::ROWB + wg * 64 * G::ROWB + kin * 32;
          const uint32_t b_off = cb * tc::TILE * G::ROWB + kin * 32;
          wgmma_ss_n64(s, make_desc<D>(s_q + a_off, 16, 8 * G::ROWB),
                       make_desc<D>(k_st + b_off, 16, 8 * G::ROWB), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int cb = kk / (G::CB / 16), kin = kk % (G::CB / 16);
          const uint32_t a_off = cb * tc::BLOCK * G::ROWB + wg * 64 * G::ROWB + kin * 32;
          const uint32_t b_off = cb * tc::TILE * G::ROWB + kin * 32;
          wgmma_ss_n64(dp, make_desc<D>(s_do + a_off, 16, 8 * G::ROWB),
                       make_desc<D>(v_st + b_off, 16, 8 * G::ROWB), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<NS>(s);
        fence_regs<NS>(dp);

        const bool need_mask = tc::block_masked(qw0, qw0 + 63, k0, k0 + tc::TILE - 1, skv,
                                            causal, window, q_offset);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int r = (i >> 1) & 1;
          if (need_mask && !tc::kept_pair(row0 + 8 * r, k0 + 8 * (i / 4) + 2 * t + (i & 1),
                                      skv, causal, window, q_offset)) {
            s[i] = dp[i] = 0.f;
          } else {
            tc::p_and_ds(s[i], dp[i], lse2[r], dl[r], sc, cap, scale, capped);
          }
        }
        // dQ += dS . K over the 64 keys, dS as bf16 hi + lo
        uint32_t d_hi[tc::TILE / 16][4], d_lo[tc::TILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < tc::TILE / 16; ++kk) pack_frag_split(dp, kk, d_hi[kk], d_lo[kk]);
        fence_regs<NA>(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < tc::TILE / 16; ++kk) {
          const uint64_t db = make_desc<D>(k_st + kk * 16 * G::ROWB, tc::TILE * G::ROWB,
                                           8 * G::ROWB);
          wgmma_rs<D>(dq_acc, d_hi[kk], db);
          wgmma_rs<D>(dq_acc, d_lo[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<NA>(dq_acc);
      }
      if ((tid & 127) == 0) mbar_arrive(bar_e(st));  // this stage is free
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* qrow = dq + bb * dqs.b + hh * dqs.h + (long long)row * dqs.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * r], dq_acc[4 * j + 2 * r + 1]);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* work;
  void *dq, *dk, *dv;
  int b, h, hkv, sq, skv, d, ld;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
  int causal, window;
  float softcap;
  int q_offset, parts;
  cudaStream_t stream;
};

constexpr int PART_DELTA = 1, PART_DKDV = 2, PART_DQ = 4;

// (a) into `delta` (b, h, ld), and lse's padded copy into lse_out if given
template <typename T>
int launch_delta(const Args& a, float* delta, float* lse_out) {
  const long long n_rows = (long long)a.b * a.h * a.ld;
  const long long n_blocks = (n_rows + NTHREADS / 32 - 1) / (NTHREADS / 32);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T><<<(unsigned)n_blocks, NTHREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, delta, lse_out,
      a.h, a.sq, a.ld, a.d, n_rows, a.os, a.dos);
  return (int)cudaGetLastError();
}

// sets a kernel's dynamic shared memory, launches it, and returns the
// CUDA error of either
template <typename Kernel, typename... Params>
int launch_kernel(Kernel kern, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                  Params... params) {
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(params...);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a) {
  using G = Geom<D>;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int rep = a.h / a.hkv;
  int e = 0;
  if (a.parts & PART_DELTA) e = launch_delta<float>(a, a.work, nullptr);
  if (e == 0 && (a.parts & PART_DKDV))
    e = launch_kernel(
        flash_bwd_dkdv_kernel<D>, dim3((a.skv + BKV - 1) / BKV, a.hkv, a.b),
        NTHREADS,
        sizeof(float) * (4 * (size_t)G::TILE + 2 * (size_t)BQ * LP + 2 * (size_t)BQ),
        a.stream, q, k, v, dout, a.lse, (const float*)a.work, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.h, a.sq, a.skv, rep, a.qs, a.ks, a.vs, a.dos,
        a.dks, a.dvs, a.scale, a.causal, a.window, a.softcap, a.q_offset);
  if (e == 0 && (a.parts & PART_DQ))
    e = launch_kernel(
        flash_bwd_dq_kernel<D>, dim3((a.sq + BQ - 1) / BQ, a.h, a.b), NTHREADS,
        sizeof(float) * (4 * (size_t)G::TILE + (size_t)BKV * (BQ + 4) + 2 * (size_t)BQ),
        a.stream, q, k, v, dout, a.lse, (const float*)a.work, static_cast<float*>(a.dq),
        a.h, a.sq, a.skv, rep, a.qs, a.ks, a.vs, a.dos, a.dqs, a.scale, a.causal,
        a.window, a.softcap, a.q_offset);
  return e;
}

template <int D>
int launch_bf16(const Args& a) {
  constexpr size_t smem = tc::Geom<D>::SMEM;
  // work: delta (b, h, ld), then lse's padded copy (b, h, ld)
  float* delta = a.work;
  float* lse_pad = a.work + (long long)a.b * a.h * a.ld;
  // (b) reads Q / dO in ring tiles and K / V resident, (c) the reverse
  CUtensorMap q_item, do_item, k_res, v_res, q_res, do_res, k_item, v_item;
  int e = encode_map<D>(&q_item, a.q, a.b, a.h, a.sq, a.qs, tc::TILE);
  if (e == 0) e = encode_map<D>(&do_item, a.dout, a.b, a.h, a.sq, a.dos, tc::TILE);
  if (e == 0) e = encode_map<D>(&k_res, a.k, a.b, a.hkv, a.skv, a.ks, tc::BLOCK);
  if (e == 0) e = encode_map<D>(&v_res, a.v, a.b, a.hkv, a.skv, a.vs, tc::BLOCK);
  if (e == 0) e = encode_map<D>(&q_res, a.q, a.b, a.h, a.sq, a.qs, tc::BLOCK);
  if (e == 0) e = encode_map<D>(&do_res, a.dout, a.b, a.h, a.sq, a.dos, tc::BLOCK);
  if (e == 0) e = encode_map<D>(&k_item, a.k, a.b, a.hkv, a.skv, a.ks, tc::TILE);
  if (e == 0) e = encode_map<D>(&v_item, a.v, a.b, a.hkv, a.skv, a.vs, tc::TILE);
  const int rep = a.h / a.hkv;
  if (e == 0 && (a.parts & PART_DELTA))
    e = launch_delta<__nv_bfloat16>(a, delta, lse_pad);
  if (e == 0 && (a.parts & PART_DKDV))
    e = launch_kernel(flash_bwd_dkdv_bf16_kernel<D>,
                      dim3(a.hkv, a.b, (a.skv + tc::BLOCK - 1) / tc::BLOCK), tc::NTHREADS,
                      smem, a.stream, q_item, k_res, v_res, do_item, (const float*)lse_pad,
                      (const float*)delta, a.ld, static_cast<__nv_bfloat16*>(a.dk),
                      static_cast<__nv_bfloat16*>(a.dv), a.h, a.sq, a.skv, rep, a.dks,
                      a.dvs, a.scale, a.causal, a.window, a.softcap, a.q_offset);
  if (e == 0 && (a.parts & PART_DQ))
    e = launch_kernel(flash_bwd_dq_bf16_kernel<D>,
                      dim3(a.h, a.b, (a.sq + tc::BLOCK - 1) / tc::BLOCK), tc::NTHREADS,
                      smem, a.stream, q_res, k_item, v_item, do_res, (const float*)lse_pad,
                      (const float*)delta, a.ld, static_cast<__nv_bfloat16*>(a.dq), a.h,
                      a.sq, a.skv, rep, a.dqs, a.scale, a.causal, a.window, a.softcap,
                      a.q_offset);
  return e;
}

template <int D>
int launch_dtype(int dtype, const Args& a) {
  return dtype == 0 ? launch_f32<D>(a) : launch_bf16<D>(a);
}

}  // namespace

// The three backward kernels, in order, on one stream: delta, dK / dV, dQ.
// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16 (tensor-core kernels):
// q, k, v, o, dout, dq, dk, dv all of it.  lse is the forward's, f32
// (b, h, sq) contiguous.  work: an f32 workspace of b * h * ld floats
// (delta) for f32, 2 * b * h * ld (delta, then lse's copy) for bf16, with
// ld = sq for f32 and sq rounded up to a multiple of 64 for bf16.  Strides
// are in elements for the (batch, head, seq) axes; the head-dim stride
// must be 1; bf16 q, k, v and dout need 16-byte-aligned bases and (batch,
// head, seq) strides that are multiples of 8 elements (TMA), which the
// wrapper guarantees.  window <= 0 and softcap <= 0 mean "none".  Returns
// the CUDA error code (0 = launched), or 1000 + the CUresult of a refused
// tensor map.  parts: the kernels to launch, bits 1 (delta), 2 (dK / dV)
// and 4 (dQ); 7 is the backward, the others time one kernel alone (dK / dV
// and dQ read the workspace the delta kernel filled).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* work, void* dq, void* dk, void* dv, int dtype, int b,
    int h, int hkv, int sq, int skv, int d, int ld, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss, float scale,
    int causal, int window, float softcap, int q_offset, int parts, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 || skv <= 0 ||
      b > 65535 || h > 65535 || (dtype != 0 && dtype != 1) || parts < 0 || parts > 7 ||
      sq > 65535 * tc::BLOCK || skv > 65535 * tc::BLOCK ||  // grid z of the bf16 kernels
      ld != (dtype == 0 ? sq : (sq + tc::TILE - 1) / tc::TILE * tc::TILE))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, work, dq, dk, dv, b, h, hkv, sq, skv, d, ld,
               Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
               Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
               Strides{do_sb, do_sh, do_ss}, Strides{dq_sb, dq_sh, dq_ss},
               Strides{dk_sb, dk_sh, dk_ss}, Strides{dv_sb, dv_sh, dv_ss},
               scale, causal, window, softcap, q_offset, parts,
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
