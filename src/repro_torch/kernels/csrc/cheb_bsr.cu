// Block-ELL Chebyshev kernels for Hopper (sm_90a), CUDA C++.
//
// Three kernels. The first two are each the counterpart of a Pallas TPU
// kernel in src/repro/kernels/cheb_bsr.py:
//
// * cheb_step_strip_kernel (B = 8, 16) and cheb_step_kernel (any other B)
//   replace cheb_step_pallas (_cheb_step_kernel, :40; pallas_call :128).
//   One eq. 9 step, out = ca*(L t1) + cb*t1 + cc*t2, L*t1 accumulated in
//   f32 and cast once on store; t2 is not read when cc == 0.
// * cheb_union_kernel replaces cheb_union_pallas (_cheb_union_kernel,
//   :159; pallas_call :331). The whole union apply, eq. 9 + eq. 11, in one
//   launch: T_0 = f, T_1 = L f / a - f, T_k = (2/a) L T_{k-1} - 2 T_{k-1}
//   - T_{k-2}, and the eta accumulators c_{j,0}/2 T_0 + sum_k c_{j,k} T_k.
//
// The third has no TPU counterpart (the reference runs the adjoint as the
// plain recurrence on eta-stacked columns):
//
// * cheb_adjoint_union_kernel is the union apply's adjoint, eq. 13,
//   Phi~* a = sum_j sum_k c_{j,k} T_k a_j (c_{j,0} halved), in one launch.
//   L is symmetric, so each T_k = Tbar_k(L) is too, and the sum is
//   sum_k T_k z_k with z_k = sum_j c_{j,k} a_j: a Chebyshev series with
//   vector coefficients, summed by Clenshaw's recurrence. With
//   Lt = L / a - I, b_{M+1} = b_{M+2} = 0 and
//   b_k = z_k + 2 Lt b_{k+1} - b_{k+2} (k = M .. 1), the result is
//   z_0 + Lt b_1 - b_2. That is M matvecs on F columns, the forward
//   apply's work, where the plain recurrence runs M on eta * F.
//
// What bounds them on this card. Both are gather-driven sparse products
// with about 2*B FLOPs per gathered value: far below the ~20 FLOP/byte at
// which the H100's f32 FMA rate (67 TFLOP/s) rather than its 3.35 TB/s HBM
// becomes the limit. So the step kernel is bound by bytes: reading t1, t2
// and writing T_k once per order. The fused kernel's least traffic is only
// tiles + f + output, because the Krylov state never has to leave the
// chip; over M orders its FMAs outweigh those bytes, and at the deployment
// shape (N = 8192, F = 256, eta = 5, M = 20) its bound is by operations.
// What it loses against that bound is how often each gathered value and
// each tile is re-read from L2, and the grid barriers between orders.
//
// What the step kernel's design does about it: it keeps the L2 traffic
// near the least HBM traffic by building around the strip, the B rows of
// one block row in one signal column.
//
// * One thread owns one strip (block row br, column col). For each of the
//   row's k_max tiles it reads the B gathered values t1[c*B + jj, col] into
//   registers once and runs B independent FMA chains, one per row, in f32:
//   no tensor cores, so no TF32 and no minimum tile (the quickstart shape is
//   F = 1, B = 8). Each gathered value is read from L2 once per strip, not
//   once per row: at the deployment shape (N = 8192, F = 256, B = 8,
//   k_max = 10) 84 MB of gathers a step instead of 671 MB.
// * B is a template parameter, built for 8 and 16: every loop over rows
//   and tile columns is unrolled and the index math is 32-bit (the wrapper
//   refuses N * F >= 2^31). Each tile row is read as 16-byte loads that
//   every lane of a warp shares (one address, a broadcast), not one 4-byte
//   load per FMA.
// * Launch: blockIdx.y picks a slab of f_tile signal columns (the ragged
//   last slab is narrower); within a slab thread t takes block row t / fc
//   and column t % fc, so lanes take neighbour columns of one block row and
//   each gathered row is one coalesced 128-byte read (f32) once the slab is
//   a multiple of 32 wide (f_tile = 128 by default). A 256-thread block
//   then covers 2 block rows x 128 columns. A narrower slab (F = 1) lays
//   the warp across neighbour block rows instead: no lane idles, but the
//   reads are no longer coalesced; that shape is launch-bound anyway.
// * Any other B (4, 32, the 128 x 128 tiles of the reference's slow test)
//   takes the generic kernel: one thread per output element with a run-time
//   B, each gathered value read once per row.
// Hopper has no scalar prefetch: each thread loads its block row's column
// ids itself (they stay in L1).
//
// The union kernel is built around the strip, B rows of one signal
// column inside one block row:
//
// * One thread owns UNION_ROWS = 8 rows of one strip (block row br, column
//   col) for a whole pass: the whole strip at B = 8, half of it at B = 16
//   (a whole B = 16 strip needs more than the 128 registers a thread may
//   have and spilled). For each of the row's k_max tiles it reads the B
//   gathered values T_{k-1}[c*B + jj, col] once into registers and the
//   tile as loads that every lane of a warp shares, and runs 8 independent
//   FMA chains, one per row. Each gathered value is read from L2 once per
//   strip at B = 8 (twice at B = 16), not once per row, and B is a
//   template parameter (8 or 16), so every loop over rows and tile columns
//   is unrolled. Lanes take neighbour columns of the same strip, so each
//   gather is one 128-byte row when a pass is >= 32 wide.
// * The TPU kernel keeps the (N, ft) Krylov state and the (eta, N, ft)
//   accumulators in VMEM. At N = 8192, eta = 5 one signal column already
//   needs N*4*(2+eta) = 229 KB, more than the 227 KB a block may use. Here
//   each thread keeps its rows' accumulators in registers for the whole
//   pass, 8 rows x UNION_ACC/B multipliers (one group of them at a time),
//   and the T_{k-1}/T_{k-2} ping/pong buffers live in a global scratch the
//   wrapper allocates, which at these sizes stays in the 50 MB L2. Only
//   the final accumulators are written to HBM, once.
// * Orders are separated by a grid-wide barrier (cooperative launch,
//   grid.sync()). The pong write of T_k over T_{k-2} is in place: the one
//   thread that reads T_{k-2}[i, f] is the thread that writes T_k[i, f],
//   and the barrier keeps the next order's gathers of T_k behind all
//   writes. The resident grid (two blocks of 256 per SM, 8 rows of a
//   column a thread) holds a pass of f_tile signal columns; the kernel
//   walks the passes (and groups of multipliers) in a loop, so one launch
//   does the whole apply at any F and eta. A barrier stands only where a buffer is
//   reused: between the orders of a pass (M - 1), and before a multiplier
//   group reruns the columns of the last one. Consecutive passes write
//   disjoint columns of the full (N, F) buffers and need none.
// * Coefficients and lmax are runtime arguments (a device array and
//   floats), so a new filter needs no rebuild.
//
// The adjoint kernel keeps the union kernel's skeleton: the same strip
// per thread, the same passes, strip_lx for the matvec, ping/pong scratch
// read with __ldcg and one grid barrier per order. What differs:
//
// * The sweep runs from k = M down to 0. z_k is formed in registers at
//   each order from the thread's rows of the eta inputs (eta reads a row,
//   against the B tile columns' gathers of the matvec), so the eq. 13
//   contraction is fused and nothing of size (M+1, N, F) is written.
// * b_{k+1} and b_{k+2} of the thread's own rows stay in registers; only
//   b_k goes to the scratch, for the neighbouring strips' matvecs. So an
//   order reads only b_{k+1} from one buffer and writes b_k into the
//   other, which held b_{k+2} that no thread reads any more: one barrier
//   per order keeps every gather of b_{k+1} ahead of the next write.
// * One output and no accumulator groups: any eta runs in one sweep.
//   The output is written once, at k = 0.
//
// Plain C interface, loaded with ctypes: every pointer and the stream are
// void*, every launcher returns the cudaError_t of its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int STEP_THREADS = 256;
constexpr int UNION_THREADS = 256;
constexpr int UNION_MIN_BLOCKS = 2;  // 512 resident threads per SM, <= 128 registers a thread
constexpr int UNION_ROWS = 8;        // rows of a strip one thread owns: all of B = 8, half of 16
constexpr int UNION_ACC = 64;        // multipliers per group: UNION_ACC / B

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

// Loads. Inputs no thread writes during the launch (tiles, columns, the
// step kernel's t1/t2, the union kernel's f) may take the read-only path.
// The union kernel's Krylov ping/pong buffers are written by other blocks
// between grid barriers, so they are read with __ldcg (through L2, which
// every SM sees once grid.sync() returns): the non-coherent read-only path
// could serve a T_{k-2} value cached before the barrier.
template <bool kL2, typename T>
__device__ __forceinline__ float load(const T* p) {
  if constexpr (kL2) return to_f32(__ldcg(p));
  else return to_f32(__ldg(p));
}

// (L x)[i, col] in f32 over the Block-ELL row of vertex i. A block column
// outside [0, n_rows) is never dereferenced: the element comes out NaN, so
// a malformed operand shows in the result instead of reading out of
// bounds (the wrappers do not synchronise to check the columns).
template <bool kL2, typename TB, typename TX>
__device__ __forceinline__ float lx_elem(const TB* __restrict__ blocks,
                                         const int* __restrict__ cols, const TX* x, long i,
                                         long col, int n_rows, int k_max, int B, long F) {
  const long br = i / B;
  const int r = static_cast<int>(i - br * B);
  float s = 0.f;
  for (int kk = 0; kk < k_max; ++kk) {
    const int cc = __ldg(cols + br * k_max + kk);
    if (static_cast<unsigned>(cc) >= static_cast<unsigned>(n_rows)) return __int_as_float(0x7fc00000);
    const long c = cc;
    const TB* tile = blocks + ((br * k_max + kk) * B + r) * B;
    const TX* xs = x + c * B * F + col;
    for (int jj = 0; jj < B; ++jj) s = fmaf(load<false>(tile + jj), load<kL2>(xs + jj * F), s);
  }
  return s;
}

template <typename TB, typename TT>
__global__ void __launch_bounds__(STEP_THREADS)
cheb_step_kernel(const TB* __restrict__ blocks, const int* __restrict__ cols,
                 const TT* __restrict__ t1, const TT* __restrict__ t2,
                 TT* __restrict__ out, int n_rows, int k_max, int B, int F,
                 int f_tile, float ca, float cb, float cc) {
  // blockIdx.y picks a slab of f_tile columns; x walks its N * ft elements.
  const long N = static_cast<long>(n_rows) * B;
  const long f0 = static_cast<long>(blockIdx.y) * f_tile;
  const long fc = min(static_cast<long>(f_tile), F - f0);
  const long n_el = N * fc;
  for (long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n_el;
       e += static_cast<long>(gridDim.x) * blockDim.x) {
    const long i = e / fc;
    const long col = f0 + (e - i * fc);
    const long idx = i * F + col;
    const float lx = lx_elem<false>(blocks, cols, t1, i, col, n_rows, k_max, B, F);
    float v = ca * lx + cb * load<false>(t1 + idx);
    if (cc != 0.f) v += cc * load<false>(t2 + idx);
    out[idx] = from_f32<TT>(v);
  }
}

// One tile row of B values as float, read as 16-byte loads (a bf16 value
// is the upper half of an f32 one). The wrapper's operands are contiguous
// and the launcher refuses tiles that are not 16-byte aligned.
template <int B>
__device__ __forceinline__ void tile_row(const float* p, float (&w)[B]) {
#pragma unroll
  for (int q = 0; q < B / 4; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
}
template <int B>
__device__ __forceinline__ void tile_row(const __nv_bfloat16* p, float (&w)[B]) {
#pragma unroll
  for (int q = 0; q < B / 8; ++q) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[8 * q + 2 * e] = __uint_as_float(u[e] << 16);
      w[8 * q + 2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
}

template <int B, typename TB, typename TT>
__global__ void __launch_bounds__(STEP_THREADS)
cheb_step_strip_kernel(const TB* __restrict__ blocks, const int* __restrict__ cols,
                       const TT* __restrict__ t1, const TT* __restrict__ t2,
                       TT* __restrict__ out, int n_rows, int k_max, int F, int f_tile,
                       float ca, float cb, float cc) {
  const int f0 = blockIdx.y * f_tile;
  const int fc = min(f_tile, F - f0);
  const int tid = blockIdx.x * STEP_THREADS + threadIdx.x;
  if (tid >= n_rows * fc) return;
  const int br = tid / fc;
  const int col = f0 + (tid - br * fc);
  const int* crow = cols + static_cast<size_t>(br) * k_max;
  const TB* tile = blocks + static_cast<size_t>(br) * k_max * B * B;
  float s[B];
#pragma unroll
  for (int r = 0; r < B; ++r) s[r] = 0.f;
  bool bad = false;
  for (int kk = 0; kk < k_max; ++kk, tile += B * B) {
    const int c = __ldg(crow + kk);
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(n_rows)) {
      bad = true;
      continue;
    }
    const TT* xs = t1 + c * B * F + col;
    float xv[B];
#pragma unroll
    for (int jj = 0; jj < B; ++jj) xv[jj] = load<false>(xs + jj * F);
#pragma unroll
    for (int r = 0; r < B; ++r) {
      float w[B];
      tile_row<B>(tile + r * B, w);
#pragma unroll
      for (int jj = 0; jj < B; ++jj) s[r] = fmaf(w[jj], xv[jj], s[r]);
    }
  }
  const int row0 = br * B * F + col;  // element (br*B, col)
#pragma unroll
  for (int r = 0; r < B; ++r) {
    const int idx = row0 + r * F;
    float v = bad ? __int_as_float(0x7fc00000) : ca * s[r];
    v += cb * load<false>(t1 + idx);
    if (cc != 0.f) v += cc * load<false>(t2 + idx);
    out[idx] = from_f32<TT>(v);
  }
}

// (L x) over UNION_ROWS rows of one strip, rows br*B + r0 .. of signal
// column col, into s. All B gathered values of each tile are read once;
// the tile is read column by column as 4-byte loads that every lane of a
// warp shares (16-byte row loads were hoisted by the compiler and spilled
// at 128 registers). A block column outside [0, n_rows) is never
// dereferenced: the rows come out NaN.
template <int B, bool kL2, typename TX>
__device__ __forceinline__ void strip_lx(const float* __restrict__ blocks,
                                         const int* __restrict__ cols, const TX* x, int br,
                                         int r0, int col, int n_rows, int k_max, int F,
                                         float (&s)[UNION_ROWS]) {
#pragma unroll
  for (int r = 0; r < UNION_ROWS; ++r) s[r] = 0.f;
  const float* tile = blocks + (static_cast<size_t>(br) * k_max * B + r0) * B;
  const int* crow = cols + static_cast<size_t>(br) * k_max;
  bool bad = false;
  for (int kk = 0; kk < k_max; ++kk, tile += B * B) {
    const int c = __ldg(crow + kk);
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(n_rows)) {
      bad = true;
      continue;
    }
    const TX* xs = x + c * B * F + col;
    float xv[B];
#pragma unroll
    for (int jj = 0; jj < B; ++jj) xv[jj] = load<kL2>(xs + jj * F);
#pragma unroll
    for (int jj = 0; jj < B; ++jj)
#pragma unroll
      for (int r = 0; r < UNION_ROWS; ++r) s[r] = fmaf(__ldg(tile + r * B + jj), xv[jj], s[r]);
  }
  if (bad) {
#pragma unroll
    for (int r = 0; r < UNION_ROWS; ++r) s[r] = __int_as_float(0x7fc00000);
  }
}

template <int B, typename KT>
__global__ void __launch_bounds__(UNION_THREADS, UNION_MIN_BLOCKS)
cheb_union_kernel(const float* __restrict__ blocks, const int* __restrict__ cols,
                  const float* __restrict__ f, const float* __restrict__ coeffs,
                  KT* ta, KT* tb, float* __restrict__ out, int n_rows, int k_max, int F,
                  int eta, int order, int f_tile, float inv_alpha, float two_inv_alpha) {
  constexpr int EG = UNION_ACC / B;     // multipliers per group
  constexpr int H = B / UNION_ROWS;     // threads per strip
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int ncoef = order + 1;
  const size_t nf = static_cast<size_t>(n_rows) * B * F;

  for (int j0 = 0; j0 < eta; j0 += EG) {
    if (j0 > 0) grid.sync();  // this group rewrites ta/tb where the last one read
    const int ne = min(EG, eta - j0);
    const float* cj = coeffs + j0 * ncoef;
    for (int f0 = 0; f0 < F; f0 += f_tile) {
      // Lanes take neighbour columns of one (block row, row half).
      const int fc = min(f_tile, F - f0);
      const bool active = tid < n_rows * H * fc;
      const int rest = active ? tid / fc : 0;
      const int col = f0 + (active ? tid - rest * fc : 0);
      const int br = rest / H;
      const int r0 = (rest - br * H) * UNION_ROWS;
      const int row0 = (br * B + r0) * F + col;  // element (br*B + r0, col)
      float acc[UNION_ROWS][EG];
      float s[UNION_ROWS];

      // k = 0, 1: T_1 = L f / a - f into the ping buffer; accumulators set.
      if (active) {
        strip_lx<B, false>(blocks, cols, f, br, r0, col, n_rows, k_max, F, s);
        float c0[EG], c1[EG];
#pragma unroll
        for (int j = 0; j < EG; ++j) {
          c0[j] = j < ne ? 0.5f * __ldg(cj + j * ncoef) : 0.f;
          c1[j] = j < ne ? __ldg(cj + j * ncoef + 1) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < UNION_ROWS; ++r) {
          const int idx = row0 + r * F;
          const float t0 = __ldg(f + idx);
          const float t1 = s[r] * inv_alpha - t0;
          ta[idx] = from_f32<KT>(t1);
#pragma unroll
          for (int j = 0; j < EG; ++j) acc[r][j] = c0[j] * t0 + c1[j] * t1;
        }
      }

      // k >= 2: even k reads T_{k-1} from ta and writes tb; odd k the
      // reverse. T_{k-2} is the destination itself (read, then overwritten
      // by the same thread), except at k = 2 where it is f.
      for (int k = 2; k <= order; ++k) {
        grid.sync();
        if (!active) continue;
        const KT* src1 = (k % 2 == 0) ? ta : tb;
        KT* dst = (k % 2 == 0) ? tb : ta;
        strip_lx<B, true>(blocks, cols, src1, br, r0, col, n_rows, k_max, F, s);
        float ck[EG];
#pragma unroll
        for (int j = 0; j < EG; ++j) ck[j] = j < ne ? __ldg(cj + j * ncoef + k) : 0.f;
#pragma unroll
        for (int r = 0; r < UNION_ROWS; ++r) {
          const int idx = row0 + r * F;
          const float prev2 = (k == 2) ? load<false>(f + idx) : load<true>(dst + idx);
          const float tn = two_inv_alpha * s[r] - 2.f * load<true>(src1 + idx) - prev2;
          dst[idx] = from_f32<KT>(tn);
#pragma unroll
          for (int j = 0; j < EG; ++j) acc[r][j] = fmaf(ck[j], tn, acc[r][j]);
        }
      }

      if (active) {
#pragma unroll
        for (int r = 0; r < UNION_ROWS; ++r)
#pragma unroll
          for (int j = 0; j < EG; ++j)
            if (j < ne) out[(j0 + j) * nf + row0 + r * F] = acc[r][j];
      }
      // No barrier: the next pass writes other columns of ta/tb and out.
    }
  }
}

// z_k over the thread's UNION_ROWS rows: sum_j c_{j,k} a_j, c_{j,0} halved.
__device__ __forceinline__ void adjoint_z(const float* __restrict__ a,
                                          const float* __restrict__ coeffs, int eta, int ncoef,
                                          int k, size_t nf, int row0, int F,
                                          float (&z)[UNION_ROWS]) {
#pragma unroll
  for (int r = 0; r < UNION_ROWS; ++r) z[r] = 0.f;
  for (int j = 0; j < eta; ++j) {
    const float c = (k == 0 ? 0.5f : 1.f) * __ldg(coeffs + j * ncoef + k);
    const float* aj = a + j * nf + row0;
#pragma unroll
    for (int r = 0; r < UNION_ROWS; ++r) z[r] = fmaf(c, __ldg(aj + r * F), z[r]);
  }
}

template <int B>
__global__ void __launch_bounds__(UNION_THREADS, UNION_MIN_BLOCKS)
cheb_adjoint_union_kernel(const float* __restrict__ blocks, const int* __restrict__ cols,
                          const float* __restrict__ a, const float* __restrict__ coeffs,
                          float* ba, float* bb, float* __restrict__ out, int n_rows, int k_max,
                          int F, int eta, int order, int f_tile, float inv_alpha,
                          float two_inv_alpha) {
  constexpr int H = B / UNION_ROWS;  // threads per strip
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int ncoef = order + 1;
  const size_t nf = static_cast<size_t>(n_rows) * B * F;

  for (int f0 = 0; f0 < F; f0 += f_tile) {
    // Lanes take neighbour columns of one (block row, row half).
    const int fc = min(f_tile, F - f0);
    const bool active = tid < n_rows * H * fc;
    const int rest = active ? tid / fc : 0;
    const int col = f0 + (active ? tid - rest * fc : 0);
    const int br = rest / H;
    const int r0 = (rest - br * H) * UNION_ROWS;
    const int row0 = (br * B + r0) * F + col;  // element (br*B + r0, col)
    float b1[UNION_ROWS], b2[UNION_ROWS];      // b_{k+1}, b_{k+2} of this thread's rows
    float z[UNION_ROWS], s[UNION_ROWS];

    // k = M: b_M = z_M, into the buffer of M's parity (even: ba).
    if (active) {
      adjoint_z(a, coeffs, eta, ncoef, order, nf, row0, F, z);
      float* dst = (order % 2 == 0) ? ba : bb;
#pragma unroll
      for (int r = 0; r < UNION_ROWS; ++r) {
        b1[r] = z[r];
        b2[r] = 0.f;
        dst[row0 + r * F] = z[r];
      }
    }

    // k = M-1 .. 1: b_k = z_k + (2/a) L b_{k+1} - 2 b_{k+1} - b_{k+2} over
    // the buffer that held b_{k+2}; k = 0: the output.
    for (int k = order - 1; k >= 0; --k) {
      grid.sync();
      if (!active) continue;
      const float* src = (k % 2 == 0) ? bb : ba;  // b_{k+1}
      strip_lx<B, true>(blocks, cols, src, br, r0, col, n_rows, k_max, F, s);
      adjoint_z(a, coeffs, eta, ncoef, k, nf, row0, F, z);
      if (k > 0) {
        float* dst = (k % 2 == 0) ? ba : bb;
#pragma unroll
        for (int r = 0; r < UNION_ROWS; ++r) {
          const float bk = z[r] + two_inv_alpha * s[r] - 2.f * b1[r] - b2[r];
          dst[row0 + r * F] = bk;
          b2[r] = b1[r];
          b1[r] = bk;
        }
      } else {
#pragma unroll
        for (int r = 0; r < UNION_ROWS; ++r)
          out[row0 + r * F] = z[r] + inv_alpha * s[r] - b1[r] - b2[r];
      }
    }
    // No barrier: the next pass writes other columns of ba/bb and out.
  }
}

template <int B, typename TB, typename TT>
cudaError_t launch_step_strip(const void* blocks, const void* cols, const void* t1,
                              const void* t2, void* out, int n_rows, int k_max, int F,
                              int f_tile, float ca, float cb, float cc, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(blocks) % 16 != 0) return cudaErrorMisalignedAddress;
  const int fc = f_tile < F ? f_tile : F;
  const dim3 grid(static_cast<unsigned>((n_rows * fc + STEP_THREADS - 1) / STEP_THREADS),
                  static_cast<unsigned>((F + f_tile - 1) / f_tile));
  cheb_step_strip_kernel<B, TB, TT><<<grid, STEP_THREADS, 0, stream>>>(
      static_cast<const TB*>(blocks), static_cast<const int*>(cols),
      static_cast<const TT*>(t1), static_cast<const TT*>(t2), static_cast<TT*>(out), n_rows,
      k_max, F, f_tile, ca, cb, cc);
  return cudaGetLastError();
}

template <typename TB, typename TT>
cudaError_t launch_step(const void* blocks, const void* cols, const void* t1, const void* t2,
                        void* out, int n_rows, int k_max, int B, int F, int f_tile,
                        float ca, float cb, float cc, cudaStream_t stream) {
  if (B == 8)
    return launch_step_strip<8, TB, TT>(blocks, cols, t1, t2, out, n_rows, k_max, F, f_tile,
                                        ca, cb, cc, stream);
  if (B == 16)
    return launch_step_strip<16, TB, TT>(blocks, cols, t1, t2, out, n_rows, k_max, F, f_tile,
                                         ca, cb, cc, stream);
  const long n_el = static_cast<long>(n_rows) * B * f_tile;
  const long want = (n_el + STEP_THREADS - 1) / STEP_THREADS;
  const dim3 grid(static_cast<unsigned>(want < 65535 ? want : 65535),
                  static_cast<unsigned>((F + f_tile - 1) / f_tile));
  cheb_step_kernel<TB, TT><<<grid, STEP_THREADS, 0, stream>>>(
      static_cast<const TB*>(blocks), static_cast<const int*>(cols),
      static_cast<const TT*>(t1), static_cast<const TT*>(t2), static_cast<TT*>(out), n_rows,
      k_max, B, F, f_tile, ca, cb, cc);
  return cudaGetLastError();
}

template <int B, typename KT>
cudaError_t launch_union(const void* blocks, const void* cols, const void* f,
                         const void* coeffs, void* ta, void* tb, void* out, int n_rows,
                         int k_max, int F, int eta, int order, int f_tile, float inv_alpha,
                         float two_inv_alpha, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks per SM: a property of the build
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cheb_union_kernel<B, KT>,
                                                        UNION_THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  if (f_tile > F) f_tile = F;
  const long threads = static_cast<long>(n_rows) * (B / UNION_ROWS) * f_tile;
  const long want = (threads + UNION_THREADS - 1) / UNION_THREADS;
  // Every block must be resident at once for grid.sync(); a pass that
  // needs more threads than the card holds is refused, not truncated.
  if (want > static_cast<long>(per_sm) * n_sm) return cudaErrorCooperativeLaunchTooLarge;
  const float* blocks_p = static_cast<const float*>(blocks);
  const int* cols_p = static_cast<const int*>(cols);
  const float* f_p = static_cast<const float*>(f);
  const float* coeffs_p = static_cast<const float*>(coeffs);
  KT* ta_p = static_cast<KT*>(ta);
  KT* tb_p = static_cast<KT*>(tb);
  float* out_p = static_cast<float*>(out);
  void* args[] = {&blocks_p, &cols_p, &f_p, &coeffs_p, &ta_p, &tb_p, &out_p,
                  &n_rows, &k_max, &F, &eta, &order, &f_tile, &inv_alpha, &two_inv_alpha};
  // Stream capture records this launch as a cooperative kernel node, so
  // a CUDA graph of an apply replays it with grid.sync() intact.
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(cheb_union_kernel<B, KT>),
                                    dim3(static_cast<unsigned>(want)), dim3(UNION_THREADS),
                                    args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_union_b(const void* blocks, const void* cols, const void* f,
                           const void* coeffs, void* ta, void* tb, int krylov_dtype, void* out,
                           int n_rows, int k_max, int F, int eta, int order, int f_tile,
                           float inv_alpha, float two_inv_alpha, cudaStream_t stream) {
  if (krylov_dtype == 0)
    return launch_union<B, float>(blocks, cols, f, coeffs, ta, tb, out, n_rows, k_max, F, eta,
                                  order, f_tile, inv_alpha, two_inv_alpha, stream);
  if (krylov_dtype == 1)
    return launch_union<B, __nv_bfloat16>(blocks, cols, f, coeffs, ta, tb, out, n_rows, k_max,
                                          F, eta, order, f_tile, inv_alpha, two_inv_alpha,
                                          stream);
  return cudaErrorInvalidValue;
}

template <int B>
cudaError_t launch_adjoint_union(const void* blocks, const void* cols, const void* a,
                                 const void* coeffs, void* ba, void* bb, void* out, int n_rows,
                                 int k_max, int F, int eta, int order, int f_tile,
                                 float inv_alpha, float two_inv_alpha, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks per SM: a property of the build
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cheb_adjoint_union_kernel<B>,
                                                        UNION_THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  if (f_tile > F) f_tile = F;
  const long threads = static_cast<long>(n_rows) * (B / UNION_ROWS) * f_tile;
  const long want = (threads + UNION_THREADS - 1) / UNION_THREADS;
  // Every block must be resident at once for grid.sync().
  if (want > static_cast<long>(per_sm) * n_sm) return cudaErrorCooperativeLaunchTooLarge;
  const float* blocks_p = static_cast<const float*>(blocks);
  const int* cols_p = static_cast<const int*>(cols);
  const float* a_p = static_cast<const float*>(a);
  const float* coeffs_p = static_cast<const float*>(coeffs);
  float* ba_p = static_cast<float*>(ba);
  float* bb_p = static_cast<float*>(bb);
  float* out_p = static_cast<float*>(out);
  void* args[] = {&blocks_p, &cols_p, &a_p, &coeffs_p, &ba_p, &bb_p, &out_p,
                  &n_rows, &k_max, &F, &eta, &order, &f_tile, &inv_alpha, &two_inv_alpha};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(cheb_adjoint_union_kernel<B>),
                                    dim3(static_cast<unsigned>(want)), dim3(UNION_THREADS),
                                    args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. B = 8 and 16 take the strip kernel,
// any other B the generic one.

int cheb_step_launch(const void* blocks, int blocks_dtype, const void* cols, const void* t1,
                     const void* t2, void* out, int t_dtype, int n_rows, int k_max, int B,
                     int F, int f_tile, float ca, float cb, float cc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks_dtype == 0 && t_dtype == 0)
    return launch_step<float, float>(blocks, cols, t1, t2, out, n_rows, k_max, B, F, f_tile,
                                     ca, cb, cc, s);
  if (blocks_dtype == 0 && t_dtype == 1)
    return launch_step<float, __nv_bfloat16>(blocks, cols, t1, t2, out, n_rows, k_max, B, F,
                                             f_tile, ca, cb, cc, s);
  if (blocks_dtype == 1 && t_dtype == 0)
    return launch_step<__nv_bfloat16, float>(blocks, cols, t1, t2, out, n_rows, k_max, B, F,
                                             f_tile, ca, cb, cc, s);
  if (blocks_dtype == 1 && t_dtype == 1)
    return launch_step<__nv_bfloat16, __nv_bfloat16>(blocks, cols, t1, t2, out, n_rows, k_max,
                                                     B, F, f_tile, ca, cb, cc, s);
  return cudaErrorInvalidValue;
}

// B is a template parameter of the union kernel: 8 and 16 are built.
int cheb_union_launch(const void* blocks, const void* cols, const void* f, const void* coeffs,
                      void* ta, void* tb, int krylov_dtype, void* out, int n_rows, int k_max,
                      int B, int F, int eta, int order, int f_tile, float inv_alpha,
                      float two_inv_alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 8)
    return launch_union_b<8>(blocks, cols, f, coeffs, ta, tb, krylov_dtype, out, n_rows, k_max,
                             F, eta, order, f_tile, inv_alpha, two_inv_alpha, s);
  if (B == 16)
    return launch_union_b<16>(blocks, cols, f, coeffs, ta, tb, krylov_dtype, out, n_rows,
                              k_max, F, eta, order, f_tile, inv_alpha, two_inv_alpha, s);
  return cudaErrorInvalidValue;
}

// The adjoint kernel, float32 throughout; B = 8 and 16 are built.
int cheb_adjoint_union_launch(const void* blocks, const void* cols, const void* a,
                              const void* coeffs, void* ba, void* bb, void* out, int n_rows,
                              int k_max, int B, int F, int eta, int order, int f_tile,
                              float inv_alpha, float two_inv_alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 8)
    return launch_adjoint_union<8>(blocks, cols, a, coeffs, ba, bb, out, n_rows, k_max, F, eta,
                                   order, f_tile, inv_alpha, two_inv_alpha, s);
  if (B == 16)
    return launch_adjoint_union<16>(blocks, cols, a, coeffs, ba, bb, out, n_rows, k_max, F, eta,
                                    order, f_tile, inv_alpha, two_inv_alpha, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
