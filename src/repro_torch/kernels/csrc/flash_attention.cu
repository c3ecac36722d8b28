// Flash attention (online softmax) for Hopper (sm_90a).  Replaces the Pallas
// TPU kernel repro/kernels/flash_attention.py::_flash_kernel, which
// repro/kernels/ops.py::flash_attention vmaps over batch and heads.
//
// What it computes: for every (batch, head) and query row,
//   o = softmax(mask(softcap(scale * q . k^T))) . v
// with a causal mask (top-left aligned: query i at position q_offset + i
// sees keys 0 .. q_offset + i), a sliding window (keys > qpos - window), a
// tanh logit cap, and f32 running max / sum / accumulator.  As in the TPU
// kernel, p is rounded to v's dtype before the P.V product while the
// running sum takes the unrounded p; masked logits are the finite -1e30,
// masked entries get p = 0 explicitly (a kv tile with no kept key for a row
// leaves that row's state unchanged), and a row that kept no key at all
// writes zeros (the l == 0 guard).  When asked (a non-null lse), each row
// also writes its log-sum-exp m + log(l) of the scaled (and capped) logits
// in f32, +inf for a row that kept no key, for the backward kernels in
// flash_attention_bwd.cu.  Any sq and skv; GQA reads kv head
// h / (h / hkv) with no repeated K/V; inputs are strided (batch, head, seq)
// views with a unit last stride, the output a (b, s, h, d) buffer.
//
// Structure.  The TPU kernel walks a sequential (q tile, kv tile) grid and
// carries m / l / acc in VMEM scratch across the kv sweep.  CUDA blocks run
// in no order, so ONE CTA owns one (batch, head, q tile) and walks, in
// order, only the kv tiles that hold a kept key for some of its rows (for
// causal / window masks a contiguous range, computed exactly, so the skip
// changes no result); the heaviest causal q tiles are launched first.
//
// What bounds it on the H100.  At the serving shape (s 2048, d 128,
// causal) attention does 4 d = 512 operations per kept (q, k) pair against
// a few bytes per pair, far above the card's ~295 op/byte ridge: it is
// bound by operations, at the 989 TFLOP/s bf16 tensor-core rate (bf16
// products are exact in f32).
//
// bf16: the tensor-core kernel (flash_bf16_kernel).
//  - Products on wgmma, bf16 in, f32 accumulate.  A CTA is two consumer
//    warpgroups of 64 query rows each (BQ = 128).  S = Q.K^T is
//    m64n128k16 with Q and K from shared memory (K-major); O += P.V is
//    m64nDk16 with P from REGISTERS (the S accumulator, converted in place
//    to bf16 pairs: the accumulator's layout is the A fragment's) and V
//    from shared memory with the 16-bit transpose flag (V is key-major).
//  - Copies by TMA.  Q is loaded once and stays resident; K and V tiles of
//    BKV = 128 keys go through a two-stage ring with an mbarrier per tile
//    ("full") and one per stage ("empty", one arrival per warpgroup).
//    Thread 0 starts tile j+1's copies before tile j's products, so the
//    copy overlaps two products and a softmax.  The tensor maps are 4-D
//    (d, s, h, b) views of the caller's strides, built on the host with
//    cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (no
//    -lcuda link); TMA zero-fills rows past sq / skv.
//  - Shared memory uses the 128-byte swizzle (64-byte at d = 32) both in
//    the TMA boxes and in the wgmma descriptors: a tile is d / 64 column
//    blocks of rows x 128 B.  At d = 128: Q 32 KB + 2 stages x (K 32 KB +
//    V 32 KB) = 160 KB, one CTA per SM.
//  - Softmax in registers in the log2 domain (ex2.approx): a row's max and
//    sum are reduced over the 4 threads of a quad; the sum is reduced once,
//    at the end.  Masks are evaluated only on the tiles that need them.
// f32: the SIMT kernel (flash_f32_kernel), kept for f32 inputs: TF32 would
//    break the 1e-4 parity with the reference's HIGHEST precision.  f32
//    FMAs on the CUDA cores from shared memory; not on the serving path.
//
// Left for later: a producer warp with setmaxnreg and intra-warpgroup
// overlap of softmax with the next tile's S (FA3's ping-pong), a TMA store
// of the output, and head dims other than 32 / 64 / 128.
#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;

// the kv tiles [kt_lo, kt_hi] that hold a kept key for rows q0 .. q0+bq-1
__device__ __forceinline__ void kv_range(int q0, int bq, int sq, int skv,
                                         int causal, int window, int q_offset,
                                         int bkv, int& kt_lo, int& kt_hi) {
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + bq, sq) - 1;
  int k_hi = skv - 1;
  if (causal) k_hi = min(k_hi, qpos_hi);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, qpos_lo - window + 1);
  kt_lo = k_lo / bkv;
  kt_hi = (k_lo <= k_hi) ? k_hi / bkv : kt_lo - 1;
}

// ---------------------------------------------------------------------------
// f32: SIMT kernel.  128 threads as 8 x 16: thread (ty, tx) owns query rows
// ty*8 .. ty*8+7 and, in S = Q K^T, kv columns tx + 16 j (j < 4); in the
// output, columns tx + 16 j (j < D/16).  Shared memory holds the q tile
// (row stride D+1), one kv buffer reused for K (transposed, stride BKV+1)
// and then V (row-major), and P (stride BKV+1).
namespace simt {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BKV = 64;        // keys per kv tile
constexpr int TY = 8, TX = 16; // thread grid
constexpr int RM = BQ / TY;    // query rows per thread (8)
constexpr int CN = BKV / TX;   // kv columns per thread in S (4)
constexpr int NTHREADS = TY * TX;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)D * (BKV + 1) + (size_t)BQ * (BKV + 1));
}

}  // namespace simt

template <int D>
__global__ void __launch_bounds__(simt::NTHREADS) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
    int sq, int skv, int rep, Strides qs, Strides ks, Strides vs, Strides os,
    float scale, int causal, int window, float softcap, int q_offset) {
  using namespace simt;
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
  const float* qb = q + bb * qs.b + hh * qs.h;
  const float* kb = k + bb * ks.b + kh * ks.h;
  const float* vb = v + bb * vs.b + kh * vs.h;
  float* ob = o + bb * os.b + hh * os.h;

  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    q_s[r * (D + 1) + c] = (q0 + r < sq) ? qb[(q0 + r) * qs.s + c] : 0.f;
  }
  int kt_lo, kt_hi;
  kv_range(q0, BQ, sq, skv, causal, window, q_offset, BKV, kt_lo, kt_hi);

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
      kv_s[c * (BKV + 1) + r] = (k0 + r < skv) ? kb[(k0 + r) * ks.s + c] : 0.f;
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
        p[i][j] = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[i][j];
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
      kv_s[r * D + c] = (k0 + r < skv) ? vb[(k0 + r) * vs.s + c] : 0.f;
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
    for (int j = 0; j < CD; ++j) ob[r * os.s + tx + TX * j] = acc[i][j] * inv;
    if (lse != nullptr && tx == 0)
      lse[((long long)bb * gridDim.y + hh) * sq + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA kernel.
namespace tc {

constexpr int BQ = 128;   // query rows per CTA: two warpgroups of 64
constexpr int BKV = 128;  // keys per kv tile
constexpr int NTHREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// a tile is D / CB column blocks of rows x ROWB bytes (hopper.cuh)
template <int D>
struct Geom : Swizzle<D> {
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t T_BYTES = BKV * D * 2;  // one K or V tile
  // shared memory: Q, K[2], V[2], then 7 mbarriers; 1 KB of alignment slack
  static constexpr size_t SMEM = Q_BYTES + 4 * (size_t)T_BYTES + 64 + 1024;
};

// thread 0: copy kv tile kt of kv head kh into stage st (K, then V, each
// arriving on its own barrier)
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t s_k, uint32_t s_v, uint32_t bar_k,
                                        uint32_t bar_v, int st, int kt, int kh, int bb) {
  using G = Geom<D>;
  mbar_expect_tx(bar_k, G::T_BYTES);
#pragma unroll
  for (int cb = 0; cb < G::NCB; ++cb)
    tma_load_4d(s_k + st * G::T_BYTES + cb * BKV * G::ROWB, tk, bar_k, cb * G::CB,
                kt * BKV, kh, bb);
  mbar_expect_tx(bar_v, G::T_BYTES);
#pragma unroll
  for (int cb = 0; cb < G::NCB; ++cb)
    tma_load_4d(s_v + st * G::T_BYTES + cb * BKV * G::ROWB, tv, bar_v, cb * G::CB,
                kt * BKV, kh, bb);
}

}  // namespace tc

// One CTA: two consumer warpgroups (64 query rows each) of one (batch,
// head, 128-row q tile).  Thread (warpgroup wg, warp w, lane = 4 g + t)
// holds rows wg*64 + w*16 + g and + 8 of S and O: S columns 8 j + 2 t + {0,1}
// in registers 4 j + {0,1} (row g) and 4 j + {2,3} (row g + 8), O likewise.
template <int D>
__global__ void __launch_bounds__(tc::NTHREADS, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int sq, int skv, int rep, Strides os, float scale,
    int causal, int window, float softcap, int q_offset) {
  using namespace tc;
  using G = Geom<D>;
  constexpr int NS = BKV / 2;  // S registers per thread
  constexpr int NO = D / 2;    // O registers per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t s_k = s_q + G::Q_BYTES;       // stage st at + st * T_BYTES
  const uint32_t s_v = s_k + 2 * G::T_BYTES;
  const uint32_t bar_q = s_v + 2 * G::T_BYTES;  // then k[2], v[2], empty[2]
  auto bar_k = [&](int st) { return bar_q + 8 + 8 * st; };
  auto bar_v = [&](int st) { return bar_q + 24 + 8 * st; };
  auto bar_e = [&](int st) { return bar_q + 40 + 8 * st; };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4;
  // heaviest (causal) q tiles first, so the tail of the grid is short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z, kh = hh / rep;
  const int q0 = qt * BQ;
  const int row0 = wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
  const int qpos0 = q_offset + q0 + row0;
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, sq) - 1;
  int kt_lo, kt_hi;
  kv_range(q0, BQ, sq, skv, causal, window, q_offset, BKV, kt_lo, kt_hi);
  const int n_tiles = kt_hi - kt_lo + 1;

  float acc[NO], s[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};


  if (n_tiles > 0) {
    if (tid == 0) {
      mbar_init(bar_q, 1);
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        mbar_init(bar_k(st), 1);
        mbar_init(bar_v(st), 1);
        mbar_init(bar_e(st), 2);  // one arrival per warpgroup
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bar_q, G::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb)
        tma_load_4d(s_q + cb * BQ * G::ROWB, &tq, bar_q, cb * G::CB, q0, hh, bb);
      load_kv<D>(&tk, &tv, s_k, s_v, bar_k(0), bar_v(0), 0, kt_lo, kh, bb);
    }
    // logits in the log2 domain: x = scale * s * log2(e), or with the cap
    // softcap * tanh(scale * s / softcap) * log2(e)
    const float sc = softcap > 0.f ? scale / softcap : scale * LOG2E;
    const float cap = softcap * LOG2E;

    for (int it = 0; it < n_tiles; ++it) {
      const int kt = kt_lo + it, st = it & 1;
      const uint32_t ph = (it >> 1) & 1;
      if (tid == 0 && it + 1 < n_tiles) {
        // tile it+1 goes to the stage tile it-1 used, once both warpgroups
        // have released it
        const int nst = (it + 1) & 1;
        if (it >= 1) mbar_wait(bar_e(nst), (((it + 1) >> 1) - 1) & 1);
        load_kv<D>(&tk, &tv, s_k, s_v, bar_k(nst), bar_v(nst), nst, kt + 1, kh, bb);
      }
      __syncwarp();
      mbar_wait(bar_q, 0);
      mbar_wait(bar_k(st), ph);

      // S = Q . K^T (64 x 128 per warpgroup)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk / (G::CB / 16), kin = kk % (G::CB / 16);
        const uint64_t da = make_desc<D>(
            s_q + cb * BQ * G::ROWB + wg * 64 * G::ROWB + kin * 32, 16, 8 * G::ROWB);
        const uint64_t db = make_desc<D>(
            s_k + st * G::T_BYTES + cb * BKV * G::ROWB + kin * 32, 16, 8 * G::ROWB);
        wgmma_ss_n128(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NS>(s);

      const int k0 = kt * BKV;
      const bool need_mask = k0 + BKV > skv || (causal && k0 + BKV - 1 > qpos_lo) ||
                             (window > 0 && k0 <= qpos_hi - window);
      auto kept = [&](int i) {
        const int kpos = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const int qpos = qpos0 + 8 * ((i >> 1) & 1);
        return kpos < skv && (!causal || kpos <= qpos) &&
               (window <= 0 || kpos > qpos - window);
      };
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = softcap > 0.f ? tanhf(s[i] * sc) * cap : s[i] * sc;
        if (need_mask && !kept(i)) x = NEG_INF;
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
      }
      // p in f32 for the running sum; rounded to bf16 for P.V
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float p = ex2(s[i] - m[(i >> 1) & 1]);
        if (need_mask && !kept(i)) p = 0.f;
        rsum[(i >> 1) & 1] += p;
        s[i] = p;
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) pack_frag(s, kk, pa[kk]);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P . V
      mbar_wait(bar_v(st), ph);
      fence_regs<NO>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = make_desc<D>(s_v + st * G::T_BYTES + kk * 16 * G::ROWB,
                                         BKV * G::ROWB, 8 * G::ROWB);
        wgmma_rs<D>(acc, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NO>(acc);
      if ((tid & 127) == 0) mbar_arrive(bar_e(st));  // this stage is free
    }
  }

  // the row sums were kept per thread: reduce over the quad, then store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* orow = o + bb * os.b + hh * os.h + (long long)row * os.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    // m is in the log2 domain: lse = m ln 2 + log(l)
    if (lse != nullptr && t == 0)
      lse[((long long)bb * gridDim.y + hh) * sq + row] =
          l[r] > 0.f ? m[r] * 0.6931471805599453f + logf(l[r]) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// host side

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int b, h, hkv, sq, skv;
  Strides qs, ks, vs, os;
  float scale;
  int causal, window;
  float softcap;
  int q_offset;
  cudaStream_t stream;
};

template <int D>
int launch_f32(const Args& a) {
  constexpr size_t smem = simt::smem_bytes<D>();
  auto kern = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + simt::BQ - 1) / simt::BQ, a.h, a.b);
  kern<<<grid, simt::NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.sq, a.skv,
      a.h / a.hkv, a.qs, a.ks, a.vs, a.os, a.scale, a.causal, a.window, a.softcap,
      a.q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a) {
  CUtensorMap mq, mk, mv;
  int err = encode_map<D>(&mq, a.q, a.b, a.h, a.sq, a.qs, tc::BQ);
  if (err == 0) err = encode_map<D>(&mk, a.k, a.b, a.hkv, a.skv, a.ks, tc::BKV);
  if (err == 0) err = encode_map<D>(&mv, a.v, a.b, a.hkv, a.skv, a.vs, tc::BKV);
  if (err != 0) return err;
  constexpr size_t smem = tc::Geom<D>::SMEM;
  auto kern = flash_bf16_kernel<D>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid((a.sq + tc::BQ - 1) / tc::BQ, a.h, a.b);
  kern<<<grid, tc::NTHREADS, smem, a.stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), a.lse, a.sq, a.skv, a.h / a.hkv, a.os,
      a.scale, a.causal, a.window, a.softcap, a.q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const Args& a) {
  return dtype == 0 ? launch_f32<D>(a) : launch_bf16<D>(a);
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor-core kernel).
// Strides are in elements, for the (batch, head, seq) axes; the head-dim
// stride must be 1.  bf16 views need 16-byte-aligned bases and (batch,
// head, seq) strides that are multiples of 8 elements (TMA); the wrapper
// guarantees both.  window <= 0 and softcap <= 0 mean "none".  Returns the
// CUDA error code (0 = launched), or 1000 + the CUresult of a refused
// tensor map.  lse: null, or an f32 (b, h, sq) contiguous buffer that gets
// each row's log-sum-exp.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int b,
    int h, int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    float softcap, int q_offset, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 || skv <= 0 ||
      b > 65535 || h > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, b, h, hkv, sq, skv,
               Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
               Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
               scale, causal, window, softcap, q_offset,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 32:
      return launch<32>(dtype, a);
    case 64:
      return launch<64>(dtype, a);
    case 128:
      return launch<128>(dtype, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
