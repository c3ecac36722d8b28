// Filtered block-sparse matmul over a compacted product list, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// repro/kernels/block_spgemm.py::_tiled_kernel.
//
// What it computes: C_ij = sum_k A_ik . B_kj over the surviving (i, k, j)
// products only, accumulated in f32 and cast to the storage dtype once.
//
// Structure.  The TPU kernel walks the list on a sequential grid and carries
// one VMEM accumulator across a k-run.  CUDA blocks run in parallel and in
// no order, so here the run is walked INSIDE one CTA: the wrapper
// (kernels/block_spgemm.py::tile_runs) turns the list into per-output-tile
// runs (tile_ia, tile_ij, run_start, run_len) over the valid entries, and
// each CTA owns one (non-empty output tile, tm sub-tile, tn sub-tile).  It
// loops over its run's k's, stages A_ik[tm, tk] and B_kj[tk, tn] in shared
// memory, keeps the accumulator in registers, and writes its sub-tile once.
// Padding entries (valid == 0) lie past every run and are never visited;
// tiles without a survivor get no CTA (the wrapper's output starts at zero).
// No atomics: every output element has exactly one writer.
//
// Threads.  A thread owns an R x R register micro-tile, strided by the
// thread-block shape (rows ty + r*TY, cols tx + c*TX) so a warp reads
// consecutive shared-memory words.  Blocks up to 24 x 24 use R = 3 and at
// most 8 x 8 threads (the paper's 23 x 23 blocks: one 24 x 24 sub-tile,
// 8 % padding); larger blocks use R = 4 and at most 16 x 16 threads over
// 64 x 64 sub-tiles.  Any bs_r, bs_k, bs_c is accepted; ragged edges are
// masked on load and store.  The contraction is staged TK = 32 at a time.
//
// What bounds it on the H100.  Small blocks do little work per byte:
// 23^3 multiply-adds per 2 x 23^2 operand words, about 3 FMA per byte read,
// so every product's operands come from L2 or device memory.  The arithmetic
// is f32 FMA on the CUDA cores (f32 parity with the reference rules out
// TF32), whose peak is 67 TFLOP/s; the inner loop issues 2R shared-memory
// loads per R^2 FMAs, so shared-memory issue, not the FMA pipes, caps it.
// The design keeps enough CTAs resident (small static shared memory, few
// registers) to hide the operand loads without explicit pipelining.
// wgmma, TMA, cp.async pipelines and tensor cores are left for later work.
//
// Offsets are computed in 64 bits: ia * nk * bs_r * bs_k passes 2^31 once
// nb * bs grows past about 46k.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int R, int TMAX, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS) tile_run_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
    const int* __restrict__ ik, const int* __restrict__ tile_ia,
    const int* __restrict__ tile_ij, const int* __restrict__ run_start,
    const int* __restrict__ run_len, int nk, int nj, int bs_r, int bs_k,
    int bs_c, int n_tn) {
  __shared__ float as[TK][TMAX + 1];  // A sub-tile, transposed: as[kk][m]
  __shared__ float bsh[TK][TMAX];     // B sub-tile: bsh[kk][n]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int tm = TY * R, tn = TX * R;
  const int tid = ty * TX + tx, nthr = TX * TY;
  const int64_t t = blockIdx.x;
  const int row0 = (blockIdx.y / n_tn) * tm;
  const int col0 = (blockIdx.y % n_tn) * tn;
  const int64_t ia = tile_ia[t], ij = tile_ij[t];
  const int64_t p0 = run_start[t];
  const int len = run_len[t];
  const int64_t a_sz = (int64_t)bs_r * bs_k, b_sz = (int64_t)bs_k * bs_c;

  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < R; ++q) acc[r][q] = 0.f;

  for (int p = 0; p < len; ++p) {
    const int64_t k = ik[p0 + p];
    const T* ap = a + (ia * nk + k) * a_sz;
    const T* bp = b + (k * nj + ij) * b_sz;
    for (int k0 = 0; k0 < bs_k; k0 += TK) {
      const int kc = min(TK, bs_k - k0);
      // consecutive threads read consecutive addresses of one block row
      for (int e = tid; e < tm * kc; e += nthr) {
        const int m = e / kc, kk = e - m * kc;
        const int row = row0 + m;
        as[kk][m] = row < bs_r ? to_f32(ap[(int64_t)row * bs_k + k0 + kk]) : 0.f;
      }
      for (int e = tid; e < kc * tn; e += nthr) {
        const int kk = e / tn, n = e - kk * tn;
        const int col = col0 + n;
        bsh[kk][n] = col < bs_c ? to_f32(bp[(int64_t)(k0 + kk) * bs_c + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        float av[R], bv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) av[r] = as[kk][ty + r * TY];
#pragma unroll
        for (int q = 0; q < R; ++q) bv[q] = bsh[kk][tx + q * TX];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < R; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
      }
      __syncthreads();
    }
  }

  T* cp = c + (ia * nj + ij) * ((int64_t)bs_r * bs_c);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + ty + r * TY;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int col = col0 + tx + q * TX;
      if (row < bs_r && col < bs_c) store_out(cp + (int64_t)row * bs_c + col, acc[r][q]);
    }
  }
}

template <typename T, int R, int TMAX, int MAX_THREADS>
void launch(const void* a, const void* b, void* c, const int* ik,
            const int* tile_ia, const int* tile_ij, const int* run_start,
            const int* run_len, long long n_tiles, int nk, int nj, int bs_r,
            int bs_k, int bs_c, int ty, int tx, cudaStream_t stream) {
  const int n_tm = (bs_r + ty * R - 1) / (ty * R);
  const int n_tn = (bs_c + tx * R - 1) / (tx * R);
  const dim3 grid((unsigned)n_tiles, (unsigned)(n_tm * n_tn));
  const dim3 block((unsigned)tx, (unsigned)ty);
  tile_run_kernel<T, R, TMAX, MAX_THREADS><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      ik, tile_ia, tile_ij, run_start, run_len, nk, nj, bs_r, bs_k, bs_c, n_tn);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  r / ty / tx: the micro-tile edge and
// thread-block shape chosen by the wrapper (kernels/block_spgemm.py::
// kernel_tile).  Returns cudaGetLastError() after the launch; a refused
// shape returns cudaErrorInvalidValue without launching.
extern "C" int block_spgemm_launch(const void* a, const void* b, void* c,
                                   const void* ik, const void* tile_ia,
                                   const void* tile_ij, const void* run_start,
                                   const void* run_len, long long n_tiles,
                                   int nk, int nj, int bs_r, int bs_k,
                                   int bs_c, int dtype, int r, int ty, int tx,
                                   void* stream) {
  const bool ok_small = r == 3 && ty * 3 <= 24 && tx * 3 <= 24;
  const bool ok_large = r == 4 && ty * 4 <= 64 && tx * 4 <= 64;
  if (n_tiles <= 0 || n_tiles > 0x7fffffffLL || ty <= 0 || tx <= 0 ||
      !(ok_small || ok_large) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int* ik_ = static_cast<const int*>(ik);
  const int* ia_ = static_cast<const int*>(tile_ia);
  const int* ij_ = static_cast<const int*>(tile_ij);
  const int* rs_ = static_cast<const int*>(run_start);
  const int* rl_ = static_cast<const int*>(run_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && r == 3)
    launch<float, 3, 24, 64>(a, b, c, ik_, ia_, ij_, rs_, rl_, n_tiles, nk, nj,
                             bs_r, bs_k, bs_c, ty, tx, s);
  else if (dtype == 0)
    launch<float, 4, 64, 256>(a, b, c, ik_, ia_, ij_, rs_, rl_, n_tiles, nk,
                              nj, bs_r, bs_k, bs_c, ty, tx, s);
  else if (r == 3)
    launch<__nv_bfloat16, 3, 24, 64>(a, b, c, ik_, ia_, ij_, rs_, rl_, n_tiles,
                                     nk, nj, bs_r, bs_k, bs_c, ty, tx, s);
  else
    launch<__nv_bfloat16, 4, 64, 256>(a, b, c, ik_, ia_, ij_, rs_, rl_,
                                      n_tiles, nk, nj, bs_r, bs_k, bs_c, ty,
                                      tx, s);
  return (int)cudaGetLastError();
}
