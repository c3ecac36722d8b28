// Filtered block-sparse matmul over a compacted product list, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// repro/kernels/block_spgemm.py::_tiled_kernel.
//
// What it computes: C_ij = sum_k A_ik . B_kj over the surviving (i, k, j)
// products only, k ascending, accumulated in f32 and cast to the storage
// dtype once.  A filtered product contributes exactly nothing.
//
// What bounds it on the H100.  f32 FMAs on the CUDA cores (67 TFLOP/s; f32
// parity with the reference rules out TF32) and what feeds them.  One small
// block pair does little work per word: 23^3 FMAs per 2 x 23^2 words, about
// 11.5, so a design that stages every product's two blocks on its own (one
// CTA per output block) re-reads each block once per product: at full fill
// (512^3 products of 23 x 23 blocks) about 568 GB of L2 reads per multiply.
//
// Structure.  The TPU kernel walks the list on a sequential grid and carries
// one VMEM accumulator across a k-run.  Here one CTA owns a GROUP of
// G_r x G_c output blocks (4 x 4 for 23 x 23 blocks: a 92 x 92 panel) and
// walks k in increasing order.  The wrapper (kernels/block_spgemm.py::
// group_masks) gives it, per k, a G_r*G_c-bit mask of the group's surviving
// products; the CTA compacts the non-zero masks of its row of that array into
// shared memory (512 k's at a time) and skips the rest.  At each k it stages
// the group's A_{i,k} blocks (one per block row with a surviving product) and
// B_{k,j} blocks once, and every thread multiplies them into its registers,
// so each staged block serves the whole group: work per word read rises
// about G-fold and the L2 reads at full fill fall about 4x.  No atomics:
// every output block has one writer; groups without a survivor get no CTA
// (the wrapper lists them as -1 past the active ones: those CTAs exit).
//
// Threads.  128 threads as 16 x 8, each owning a 6-row x 12-column register
// micro-tile of a 96 x 96 panel.  Block rows sit in the panel at a stride
// rounded up to a multiple of 6 (columns: of 12; 24 for 23-wide blocks), so
// each thread's micro-tile lies in ONE block pair (i, j) and takes one mask
// bit per k: when a k's mask is full every thread runs the same plain FMA
// loop; when it is partial, a thread whose product was filtered skips the k
// (its staged operands are never touched: no 0 . x with x non-finite).
// Shared memory holds A transposed (As[k][row], stride 98) and B
// (Bs[k][col], stride 96), so the inner loop reads 3 float2 of A and 3
// float4 of B per 72 FMAs.  Blocks above 96 rows / cols take one block per
// CTA, cut into 96 x 96 sub-tiles (grid.y); any bs_r, bs_k, bs_c,
// rectangular blocks included, with ragged edges (block or group) never
// stored.
//
// Loads.  The contraction is staged 24 at a time (one stage for 23-wide
// blocks) through two buffers: the next stage's copies are started before
// this stage's FMAs.  f32 blocks go by 4-byte cp.async: a 23 x 23 block is
// 2,116 contiguous bytes, read coalesced, but its base is a multiple of 2,116
// B, not 16, so 16-byte cp.async and TMA do not apply.  bf16 and f8
// (e4m3fn, e5m2) blocks are widened to f32 as they are staged, with plain
// loads, and the f32 sum is rounded to the storage dtype once, at
// write-back (f8: to nearest even, unsaturated, as PyTorch casts).  The
// 4-byte copies and the operand reads go through the same shared-memory
// (MIO) pipe: at full fill, builds without the copies and without the FMAs
// took times that add up to the whole kernel's, so the double buffer hides
// latency but the two do not overlap.
//
// Left for later: copies that bypass the shared-memory pipe (a bulk copy
// of each block's 16-byte-aligned hull, then compute from that layout), a
// wgmma leg for bf16 and f8 blocks (padded to the tensor-core tile),
// 3xTF32 splitting for f32, and a persistent grid.
//
// Operand layout.  Each block is row-major and contiguous; the block grids
// of A and B may have any strides (in elements), so a stride-0 view that
// aliases one block across a grid axis is read in place.  C is contiguous.
// Offsets are computed in 64 bits: ia * nk * bs_r * bs_k passes 2^31 once
// nb * bs grows past about 46k.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RM = 6, RC = 12;    // rows, columns of a thread's micro-tile
constexpr int TY = 16, TX = 8, NT = TY * TX;
constexpr int PANEL = 96;         // output rows / cols of one CTA: TY * RM = TX * RC
constexpr int TK = 24;            // contraction staged TK at a time
constexpr int LDA = PANEL + 2;    // As[kk][row]: even, for float2 reads
constexpr int LDB = PANEL;        // Bs[kk][col]
constexpr int STAGE = TK * (LDA + LDB);
constexpr int KC = 512;           // k's of the mask row compacted per pass
constexpr int MAX_BITS = 16;      // G_r * G_c
constexpr int NBUF = 2;           // staging buffers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void stage_copy(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void stage_copy(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}
__device__ __forceinline__ void stage_copy(float* dst, const __nv_fp8_e4m3* src) {
  *dst = static_cast<float>(*src);
}
__device__ __forceinline__ void stage_copy(float* dst, const __nv_fp8_e5m2* src) {
  *dst = static_cast<float>(*src);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(__nv_fp8_e4m3* p, float v) {
  p->__x = __nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E4M3);
}
__device__ __forceinline__ void store_out(__nv_fp8_e5m2* p, float v) {
  p->__x = __nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E5M2);
}

// compact the non-zero masks of gm[kb .. kb + cnt) into (ek, em), k ascending;
// returns their number
__device__ int compact(const int* __restrict__ gm, int kb, int cnt, int* ek, int* em,
                       int* wcnt) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int total = 0;
  for (int p = 0; p < cnt; p += NT) {
    const int m = p + tid < cnt ? gm[kb + p + tid] : 0;
    const unsigned ball = __ballot_sync(0xffffffffu, m != 0);
    if (lane == 0) wcnt[w] = __popc(ball);
    __syncthreads();
    int off = total, all = 0;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) {
      const int c = wcnt[i];
      off += i < w ? c : 0;
      all += c;
    }
    if (m != 0) {
      const int pos = off + __popc(ball & ((1u << lane) - 1u));
      ek[pos] = kb + p + tid;
      em[pos] = m;
    }
    total += all;
    __syncthreads();
  }
  return total;
}

// (first row, first column, row step, column step) of a thread's walk over
// an n_rows x n_cols row-major block, NT elements a step
struct Walk {
  int r0, c0, dr, dc;
  __device__ Walk(int tid, int n_cols)
      : r0(tid / n_cols), c0(tid % n_cols), dr(NT / n_cols), dc(NT % n_cols) {}
};

template <typename T>
__global__ void __launch_bounds__(NT, 4) group_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
    const int* __restrict__ masks, const int* __restrict__ groups, int64_t sa_i,
    int64_t sa_k, int64_t sb_k, int64_t sb_j, int ni, int nk,
    int nj, int bs_r, int bs_k, int bs_c, int g_r, int g_c, int sr, int sc,
    int n_sub_c) {
  __shared__ __align__(16) float st[NBUF][STAGE];
  __shared__ int ek[KC], em[KC], wcnt[NT / 32];

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int n_gc = (nj + g_c - 1) / g_c;
  const int64_t g = groups[blockIdx.x];
  if (g < 0) return;  // padding past the active groups
  const int gi = (int)(g / n_gc), gj = (int)(g % n_gc);
  const int row0 = (blockIdx.y / n_sub_c) * PANEL;  // sub-tile of a block above 96
  const int col0 = (blockIdx.y % n_sub_c) * PANEL;
  const int nr = min(bs_r - row0, PANEL), nc = min(bs_c - col0, PANEL);

  // this thread's block pair and its first row / column in that block
  const int tpb_r = sr / RM, tpb_c = sc / RC;
  const int bi = ty / tpb_r, bj = tx / tpb_c;
  const int r_in = row0 + RM * (ty % tpb_r), c_in = col0 + RC * (tx % tpb_c);
  const int64_t ia = (int64_t)gi * g_r + bi, ij = (int64_t)gj * g_c + bj;
  const bool mine = bi < g_r && bj < g_c && ia < ni && ij < nj;
  const int bit = mine ? bi * g_c + bj : 0;
  // bits of block row 0 / block column 0; shifted for the others
  const int row_bits = (1 << g_c) - 1;
  int col_bits = 0;
  for (int i = 0; i < g_r; ++i) col_bits |= 1 << (i * g_c);

  const int n_kc = (bs_k + TK - 1) / TK;
  const int kc_last = bs_k - (n_kc - 1) * TK;
  const Walk wa_full(tid, min(bs_k, TK)), wa_last(tid, kc_last), wb(tid, nc);

  // start the copies of step s (entry s / n_kc, contraction chunk s % n_kc)
  auto stage = [&](int s, int buf) {
    const int e = s / n_kc, ch = s - e * n_kc;
    const int k = ek[e], m = em[e];
    const int k0 = ch * TK;
    const bool last = ch == n_kc - 1;
    const int kc = last ? kc_last : TK;
    const Walk wa = last ? wa_last : wa_full;
    float* as = st[buf];
    float* bsm = as + TK * LDA;
    for (int i = 0; i < g_r; ++i) {
      if (((m >> (i * g_c)) & row_bits) == 0) continue;  // no product in this block row
      const T* src = a + ((int64_t)gi * g_r + i) * sa_i + (int64_t)k * sa_k +
                     (int64_t)row0 * bs_k + k0;
      float* dst = as + i * sr;
      for (int r = wa.r0, kk = wa.c0; r < nr;) {
        stage_copy(dst + kk * LDA + r, src + r * bs_k + kk);
        r += wa.dr;
        kk += wa.dc;
        if (kk >= kc) {
          kk -= kc;
          ++r;
        }
      }
    }
    for (int j = 0; j < g_c; ++j) {
      if (((m >> j) & col_bits) == 0) continue;  // no product in this block column
      const T* src = b + (int64_t)k * sb_k + ((int64_t)gj * g_c + j) * sb_j +
                     (int64_t)k0 * bs_c + col0;
      float* dst = bsm + j * sc;
      for (int kk = wb.r0, cc = wb.c0; kk < kc;) {
        stage_copy(dst + kk * LDB + cc, src + kk * bs_c + cc);
        kk += wb.dr;
        cc += wb.dc;
        if (cc >= nc) {
          cc -= nc;
          ++kk;
        }
      }
    }
  };

  float acc[RM][RC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;

  const int* gm = masks + g * nk;
  for (int kb = 0; kb < nk; kb += KC) {
    const int n_e = compact(gm, kb, min(KC, nk - kb), ek, em, wcnt);
    const int n_steps = n_e * n_kc;
    if (n_steps == 0) continue;
    stage(0, 0);
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      if (s + 1 < n_steps) stage(s + 1, (s + 1) % NBUF);
      cp_async_commit();  // possibly empty: keeps "all but the newest" exact
      cp_async_wait_prev();
      __syncthreads();
      const int e = s / n_kc;
      if (mine && ((em[e] >> bit) & 1)) {
        const int kc = (s - e * n_kc) == n_kc - 1 ? kc_last : TK;
        const float* as = st[s % NBUF] + RM * ty;
        const float* bsm = st[s % NBUF] + TK * LDA + RC * tx;
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          if (kk >= kc) break;
          float av[RM], bv[RC];
#pragma unroll
          for (int h = 0; h < RM / 2; ++h) {
            const float2 x = *reinterpret_cast<const float2*>(as + kk * LDA + 2 * h);
            av[2 * h] = x.x;
            av[2 * h + 1] = x.y;
          }
#pragma unroll
          for (int h = 0; h < RC / 4; ++h) {
            const float4 y = *reinterpret_cast<const float4*>(bsm + kk * LDB + 4 * h);
            bv[4 * h] = y.x;
            bv[4 * h + 1] = y.y;
            bv[4 * h + 2] = y.z;
            bv[4 * h + 3] = y.w;
          }
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();  // this buffer is refilled two steps on
    }
  }

  if (!mine) return;
  T* cp = c + (ia * nj + ij) * bs_r * bs_c;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r_in + i;
    if (r >= bs_r) continue;
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int cc = c_in + j;
      if (cc < bs_c) store_out(cp + (int64_t)r * bs_c + cc, acc[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = float8_e5m2.
// sa_i, sa_k / sb_k, sb_j: the strides of A's / B's block grids in elements
// (each block row-major and contiguous; C contiguous).  masks: (n_groups, nk)
// int32, bit (i % g_r) * g_c + j % g_c of group (i / g_r) * n_gc + j / g_c at
// k set for each surviving product; groups: the n_active groups with one,
// or those followed by -1 entries (CTAs that exit at once).
// g_r / g_c: blocks per group, stride_r / stride_c: panel rows / cols per
// block (a multiple of 6), n_sub_r / n_sub_c: 96-wide sub-tiles per block
// (blocks above 96), all as chosen by kernels/block_spgemm.py::kernel_tile.
// Returns cudaGetLastError() after the launch; a refused shape returns
// cudaErrorInvalidValue without launching.
namespace {
struct Args {
  int64_t sa_i, sa_k, sb_k, sb_j;
  int ni, nk, nj, bs_r, bs_k, bs_c, g_r, g_c, stride_r, stride_c, n_sub_c;
};

template <typename T>
void launch_as(const void* a, const void* b, void* c, const int* m, const int* gr,
               dim3 grid, cudaStream_t s, const Args& x) {
  group_kernel<T><<<grid, NT, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, gr,
      x.sa_i, x.sa_k, x.sb_k, x.sb_j, x.ni, x.nk, x.nj, x.bs_r, x.bs_k, x.bs_c, x.g_r,
      x.g_c, x.stride_r, x.stride_c, x.n_sub_c);
}
}  // namespace

extern "C" int block_spgemm_launch(const void* a, const void* b, void* c,
                                   const void* masks, const void* groups,
                                   long long n_active, long long sa_i, long long sa_k,
                                   long long sb_k, long long sb_j, int ni, int nk,
                                   int nj, int bs_r, int bs_k, int bs_c, int g_r,
                                   int g_c, int stride_r, int stride_c, int n_sub_r,
                                   int n_sub_c, int dtype, void* stream) {
  auto edge_ok = [](int bs, int g, int stride, int n_sub, int micro) {
    if (g < 1 || stride < micro || stride % micro != 0 || g * stride > PANEL) return false;
    if (bs > PANEL) return g == 1 && stride == PANEL && n_sub == (bs + PANEL - 1) / PANEL;
    return stride >= bs && n_sub == 1;
  };
  if (n_active <= 0 || n_active > 0x7fffffffLL || ni <= 0 || nk <= 0 || nj <= 0 ||
      bs_k <= 0 || sa_i < 0 || sa_k < 0 || sb_k < 0 || sb_j < 0 ||
      !edge_ok(bs_r, g_r, stride_r, n_sub_r, RM) ||
      !edge_ok(bs_c, g_c, stride_c, n_sub_c, RC) || g_r * g_c > MAX_BITS ||
      n_sub_r * n_sub_c > 65535 || dtype < 0 || dtype > 3)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_active, (unsigned)(n_sub_r * n_sub_c));
  const int* m = static_cast<const int*>(masks);
  const int* gr = static_cast<const int*>(groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args x{sa_i, sa_k, sb_k, sb_j, ni, nk, nj, bs_r, bs_k, bs_c,
               g_r, g_c, stride_r, stride_c, n_sub_c};
  switch (dtype) {
    case 0: launch_as<float>(a, b, c, m, gr, grid, s, x); break;
    case 1: launch_as<__nv_bfloat16>(a, b, c, m, gr, grid, s, x); break;
    case 2: launch_as<__nv_fp8_e4m3>(a, b, c, m, gr, grid, s, x); break;
    default: launch_as<__nv_fp8_e5m2>(a, b, c, m, gr, grid, s, x); break;
  }
  return (int)cudaGetLastError();
}
