// LF-MMI denominator forward-backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels satpu/chain/pallas_fb.py::_fwd_kernel (K2f, the
// pl.pallas_call at pallas_fb.py:234) and ::_bwd_kernel (K2b, the call at
// pallas_fb.py:278), reached from satpu.chain.objf.den_forward's factored
// branch. For every batch row b and frame t the forward step is
//
//   lse     = logsumexp_i alpha[i]
//   leaked  = logaddexp(alpha, log_leak + log_init + lse)   (alpha if no leak)
//   m       = max_i leaked[i]
//   sums    = exp(leaked - m) @ A                           (A [S, S], f32)
//   alpha'  = max(logaddexp(log(max(sums, 1e-30)) + m + llf_t,
//                           leaked + log_self + lls_t), -1e30)
//
// and the backward is its exact VJP in reverse order, recomputing each
// step's internals from the stored alphas, with one d_sums @ A^T per step.
// The same formulas, in plain PyTorch, are satpu_torch/chain/den_fb.py's
// den_fb_forward_plain / den_fb_backward_plain.
//
// Bound: bytes. A comes from the den graph's arcs and is sparse: at
// S = 1641 (the full-scale den graph) it holds 14,924 nonzeros of 2.69 M
// (0.55%). At B = 16 and T = 99 the forward's products need 2*B*T*nnz =
// 47 MFLOP (0.7 us at the 67 TFLOP/s f32 rate outside the tensor cores),
// against 42.2 MB of device-memory traffic (llf, lls and the alphas once, A
// once: 12.6 us at 3.35 TB/s). The backward does twice the products (0.1
// GFLOP, 1.4 us) and moves 63.0 MB (18.8 us).
//
// Design (simple first). The TPU kernel keeps A (10.8 MB) resident in VMEM
// and carries alpha across a sequential grid. Hopper has neither 10 MB of
// on-chip memory per block nor an ordered grid, so each C entry point loops
// over t on the caller's stream and launches one kernel per step (three per
// step in the backward: column tiles, row tiles, then one block per batch
// row for the leak's full-row sum). A stays in device memory and is re-read
// from the 50 MB L2 each step. A forward block owns 8 batch rows (one warp
// each) and 32 state columns (one lane each): it reduces its rows of alpha
// itself (6.6 KB a row at S = 1641, so no grid-wide sync), stages
// e = exp(leaked - m) in shared memory ([S][8], i-major), and each warp
// accumulates e @ A over every 8th i with f32 FMAs; the 8 warps' partial
// sums are added in a fixed order, so results do not vary from run to run.
// Products use plain f32 FMA (no TF32, no fast-math intrinsics). The
// products run over A densely, 99.45% of them on zeros, and the rest of the
// time goes to re-reading A and to T (3T in the backward) launches of small
// grids. Gathering A's nonzeros by destination state (about 120 KB, which
// fits one SM's shared memory) and running all T frames of a batch row in
// one persistent launch per direction is left for a later change.
//
// Sentinels follow the TPU kernel: NEG_INF = -1e30 (finite), exp(x - y) is 0
// wherever y <= NEG_INF / 2, and log_leak < NEG_INF / 2 switches the leak
// off.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;  // a normal f32: log(kTiny) is finite
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps;    // batch rows per block, one warp each
constexpr int kCols = 32;        // state columns per column-tile block
constexpr int kRowTile = 32;     // states per row-tile block (backward)

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// exp(x - y), and 0 where y is the clamped log(0)
__device__ __forceinline__ float guard_exp(float x, float y) {
  return y > kNegInf / 2 ? expf(x - y) : 0.0f;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float leak_of(float a, float log_init_i, float log_leak,
                                         float lse, bool leak) {
  return leak ? logaddexp(a, log_leak + log_init_i + lse) : a;
}

// Warp `warp` reduces batch row b0 + warp of alpha [B, S]: lse and m go to
// stat_s[warp] and stat_s[kRows + warp], exp(leaked - m) to e_s[i * kRows +
// warp]. Rows past B stage zeros.
__device__ void stage_rows(const float* __restrict__ alpha,
                           const float* __restrict__ log_init, float log_leak,
                           bool leak, int b0, int nb, int S, float* e_s,
                           float* stat_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= nb) {
    for (int i = lane; i < S; i += 32) e_s[i * kRows + warp] = 0.0f;
    return;
  }
  const float* row = alpha + static_cast<long long>(b0 + warp) * S;
  float mx = -INFINITY;
  for (int i = lane; i < S; i += 32) mx = fmaxf(mx, row[i]);
  mx = warp_max(mx);
  const float m0 = mx > kNegInf / 2 ? mx : 0.0f;
  float s = 0.0f;
  for (int i = lane; i < S; i += 32) s += expf(row[i] - m0);
  const float lse = logf(warp_sum(s)) + m0;
  float m = mx;  // without the leak, leaked == alpha
  if (leak) {
    m = -INFINITY;
    for (int i = lane; i < S; i += 32)
      m = fmaxf(m, leak_of(row[i], log_init[i], log_leak, lse, true));
    m = warp_max(m);
  }
  m = m > kNegInf / 2 ? m : 0.0f;
  for (int i = lane; i < S; i += 32)
    e_s[i * kRows + warp] = expf(leak_of(row[i], log_init[i], log_leak, lse, leak) - m);
  if (lane == 0) {
    stat_s[warp] = lse;
    stat_s[kRows + warp] = m;
  }
}

// sums[b0 + warp, c0 + lane] = sum_i e_s[i][warp] * A[i, c0 + lane]: each
// warp takes every kWarps-th i for all kRows rows, then the block adds the
// warps' partial sums in order. Returns this thread's sum.
__device__ float column_sums(const float* __restrict__ A, int S, int c0,
                             const float* e_s, float* part_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = c0 + lane;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  if (j < S) {
#pragma unroll 4
    for (int i = warp; i < S; i += kWarps) {
      const float a = A[static_cast<long long>(i) * S + j];
      const float4 lo = *reinterpret_cast<const float4*>(e_s + i * kRows);
      const float4 hi = *reinterpret_cast<const float4*>(e_s + i * kRows + 4);
      acc[0] = fmaf(lo.x, a, acc[0]);
      acc[1] = fmaf(lo.y, a, acc[1]);
      acc[2] = fmaf(lo.z, a, acc[2]);
      acc[3] = fmaf(lo.w, a, acc[3]);
      acc[4] = fmaf(hi.x, a, acc[4]);
      acc[5] = fmaf(hi.y, a, acc[5]);
      acc[6] = fmaf(hi.z, a, acc[6]);
      acc[7] = fmaf(hi.w, a, acc[7]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) part_s[(warp * kRows + r) * kCols + lane] = acc[r];
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total += part_s[(w * kRows + warp) * kCols + lane];
  return total;
}

size_t column_smem(int S) {
  return (static_cast<size_t>(S) * kRows + kWarps * kRows * kCols + 2 * kRows) * sizeof(float);
}

// One forward step: alpha_t [B, S] -> alpha_next [B, S]. llf/lls point at
// frame t of [B, T, S] tensors, ll_stride = T * S between batch rows.
__global__ void __launch_bounds__(kThreads)
den_fwd_step(const float* __restrict__ alpha, float* __restrict__ alpha_next,
             const float* __restrict__ llf, const float* __restrict__ lls,
             long long ll_stride, const float* __restrict__ A,
             const float* __restrict__ log_self, const float* __restrict__ log_init,
             float log_leak, int B, int S) {
  extern __shared__ float4 smem4[];
  float* e_s = reinterpret_cast<float*>(smem4);
  float* part_s = e_s + static_cast<size_t>(S) * kRows;
  float* stat_s = part_s + kWarps * kRows * kCols;
  const bool leak = log_leak > kNegInf / 2;
  const int b0 = blockIdx.y * kRows, nb = min(kRows, B - b0), c0 = blockIdx.x * kCols;
  stage_rows(alpha, log_init, log_leak, leak, b0, nb, S, e_s, stat_s);
  __syncthreads();
  const float sums = column_sums(A, S, c0, e_s, part_s);
  const int r = threadIdx.x / 32, j = c0 + threadIdx.x % 32;
  if (r >= nb || j >= S) return;
  const int b = b0 + r;
  const float lse = stat_s[r], m = stat_s[kRows + r];
  const float leaked = leak_of(alpha[static_cast<long long>(b) * S + j], log_init[j],
                               log_leak, lse, leak);
  const float cross = logf(fmaxf(sums, kTiny)) + m + llf[b * ll_stride + j];
  const float selfp = leaked + log_self[j] + lls[b * ll_stride + j];
  alpha_next[static_cast<long long>(b) * S + j] = fmaxf(logaddexp(cross, selfp), kNegInf);
}

// Backward (a), column tiles: recompute the step, then the logaddexp branch
// weights w_cross -> dllf, w_self -> dlls, and d_sums = w_cross / sums.
// Blocks of column tile 0 also store the rows' (lse, m) in stats [B, 2].
__global__ void __launch_bounds__(kThreads)
den_bwd_cols(const float* __restrict__ alpha, const float* __restrict__ newa,
             const float* __restrict__ g_next, const float* __restrict__ llf,
             const float* __restrict__ lls, long long ll_stride,
             const float* __restrict__ A, const float* __restrict__ log_self,
             const float* __restrict__ log_init, float log_leak,
             float* __restrict__ dllf, float* __restrict__ dlls,
             float* __restrict__ d_sums, float* __restrict__ stats, int B, int S) {
  extern __shared__ float4 smem4[];
  float* e_s = reinterpret_cast<float*>(smem4);
  float* part_s = e_s + static_cast<size_t>(S) * kRows;
  float* stat_s = part_s + kWarps * kRows * kCols;
  const bool leak = log_leak > kNegInf / 2;
  const int b0 = blockIdx.y * kRows, nb = min(kRows, B - b0), c0 = blockIdx.x * kCols;
  stage_rows(alpha, log_init, log_leak, leak, b0, nb, S, e_s, stat_s);
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < nb) {
    stats[2 * (b0 + threadIdx.x)] = stat_s[threadIdx.x];
    stats[2 * (b0 + threadIdx.x) + 1] = stat_s[kRows + threadIdx.x];
  }
  const float sums = column_sums(A, S, c0, e_s, part_s);
  const int r = threadIdx.x / 32, j = c0 + threadIdx.x % 32;
  if (r >= nb || j >= S) return;
  const int b = b0 + r;
  const long long bj = static_cast<long long>(b) * S + j;
  const float lse = stat_s[r], m = stat_s[kRows + r];
  const float leaked = leak_of(alpha[bj], log_init[j], log_leak, lse, leak);
  const float cross = logf(fmaxf(sums, kTiny)) + m + llf[b * ll_stride + j];
  const float selfp = leaked + log_self[j] + lls[b * ll_stride + j];
  // the clamp max(lae, NEG_INF) passes gradient where it is inactive
  const float na = newa[bj];
  const bool live = na > kNegInf;
  const float g = g_next[bj];
  const float w_cross = live ? g * guard_exp(cross, na) : 0.0f;
  const float w_self = live ? g * guard_exp(selfp, na) : 0.0f;
  dllf[b * ll_stride + j] = w_cross;
  dlls[b * ll_stride + j] = w_self;
  d_sums[bj] = sums > kTiny ? w_cross / fmaxf(sums, kTiny) : 0.0f;
}

// Backward (b), row tiles: d_e[b, i] = sum_j d_sums[b, j] * A[i, j], then
// g_leaked = e * d_e + w_self (w_self read back from dlls at this frame).
// d_sums rows are staged b-major in shared memory; warp w takes states
// i0 + w, i0 + w + kWarps, ... and its lanes walk A's row i contiguously.
__global__ void __launch_bounds__(kThreads)
den_bwd_rows(const float* __restrict__ d_sums, const float* __restrict__ A,
             const float* __restrict__ alpha, const float* __restrict__ dlls,
             long long ll_stride, const float* __restrict__ log_init, float log_leak,
             const float* __restrict__ stats, float* __restrict__ g_leaked, int B,
             int S) {
  extern __shared__ float4 smem4[];
  float* ds_s = reinterpret_cast<float*>(smem4);
  const bool leak = log_leak > kNegInf / 2;
  const int b0 = blockIdx.y * kRows, nb = min(kRows, B - b0), i0 = blockIdx.x * kRowTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* src = d_sums + static_cast<long long>(b0) * S;
  for (int k = threadIdx.x; k < kRows * S; k += kThreads)
    ds_s[k] = k < nb * S ? src[k] : 0.0f;
  __syncthreads();
  for (int ii = warp; ii < kRowTile; ii += kWarps) {
    const int i = i0 + ii;
    if (i >= S) break;
    const float* arow = A + static_cast<long long>(i) * S;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int j = lane; j < S; j += 32) {
      const float a = arow[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(ds_s[r * S + j], a, acc[r]);
    }
    float d_e = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = warp_sum(acc[r]);
      if (lane == r) d_e = v;
    }
    if (lane < nb) {
      const int b = b0 + lane;
      const long long bi = static_cast<long long>(b) * S + i;
      const float lse = stats[2 * b], m = stats[2 * b + 1];
      const float e = expf(leak_of(alpha[bi], log_init[i], log_leak, lse, leak) - m);
      g_leaked[bi] = e * d_e + dlls[b * ll_stride + i];
    }
  }
}

__device__ float block_sum(float v, float* red_s) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total += red_s[w];
  return total;
}

// Backward (c), one block per batch row: the leak's VJP. With
// leaked = logaddexp(alpha, k + lse) and lse = logsumexp(alpha):
//   d_lse   = sum_i g_leaked[i] * exp(k_i + lse - leaked_i)
//   g_alpha = g_leaked * exp(alpha - leaked) + d_lse * exp(alpha - lse)
// g_alpha is dL/d alpha_t, carried to the step before.
__global__ void __launch_bounds__(kThreads)
den_bwd_leak(const float* __restrict__ g_leaked, const float* __restrict__ alpha,
             const float* __restrict__ log_init, float log_leak,
             const float* __restrict__ stats, float* __restrict__ g_alpha, int S) {
  __shared__ float red_s[kWarps];
  const bool leak = log_leak > kNegInf / 2;
  const int b = blockIdx.x;
  const long long off = static_cast<long long>(b) * S;
  const float lse = stats[2 * b];
  float d_lse = 0.0f;
  if (leak) {
    float part = 0.0f;
    for (int i = threadIdx.x; i < S; i += kThreads) {
      const float k = log_leak + log_init[i];
      const float leaked = logaddexp(alpha[off + i], k + lse);
      part += g_leaked[off + i] * guard_exp(k + lse, leaked);
    }
    d_lse = block_sum(part, red_s);
  }
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float a = alpha[off + i];
    const float leaked = leak_of(a, log_init[i], log_leak, lse, leak);
    float g = g_leaked[off + i] * guard_exp(a, leaked);
    if (leak) g += d_lse * guard_exp(a, lse);
    g_alpha[off + i] = g;
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// Shared memory a block needs at S states: the larger of the column-tile
// kernels' and the row-tile kernel's. The wrapper refuses S above the card's
// 227 KB per block.
extern "C" long long satpu_den_smem_bytes(int S) {
  const size_t rows = static_cast<size_t>(S) * kRows * sizeof(float);
  const size_t cols = column_smem(S);
  return static_cast<long long>(cols > rows ? cols : rows);
}

// Forward: llf, lls [B, T, S]; A [S, S]; log_self, log_init [S]; alphas
// [T + 1, B, S] with alphas[0] = alpha_0 filled by the caller. Writes
// alphas[1..T]. All contiguous f32 device buffers. Launches T kernels on
// `stream`; returns the first cudaGetLastError() that is not 0.
extern "C" int satpu_den_fwd(const float* llf, const float* lls, const float* A,
                             const float* log_self, const float* log_init,
                             float log_leak, float* alphas, int B, int T, int S,
                             void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const size_t smem = column_smem(S);
  int err = set_smem(den_fwd_step, smem);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kCols - 1) / kCols, (B + kRows - 1) / kRows);
  const long long bs = static_cast<long long>(B) * S, ll_stride = static_cast<long long>(T) * S;
  for (int t = 0; t < T; ++t) {
    den_fwd_step<<<grid, kThreads, smem, st>>>(alphas + t * bs, alphas + (t + 1) * bs,
                                               llf + static_cast<long long>(t) * S,
                                               lls + static_cast<long long>(t) * S, ll_stride,
                                               A, log_self, log_init, log_leak, B, S);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}

// Backward: g_final [B, S] = dL/d alpha_T; alphas [T + 1, B, S] from the
// forward; writes dllf, dlls [B, T, S]. work: 3 * B * S + 2 * B floats of
// scratch (the carried gradient, d_sums, g_leaked, the rows' (lse, m)).
// Launches 3 T kernels on `stream`; returns the first error that is not 0.
extern "C" int satpu_den_bwd(const float* g_final, const float* alphas, const float* llf,
                             const float* lls, const float* A, const float* log_self,
                             const float* log_init, float log_leak, float* dllf,
                             float* dlls, float* work, int B, int T, int S,
                             void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const long long bs = static_cast<long long>(B) * S, ll_stride = static_cast<long long>(T) * S;
  float* carry = work;
  float* d_sums = work + bs;
  float* g_leaked = work + 2 * bs;
  float* stats = work + 3 * bs;
  const size_t smem_cols = column_smem(S);
  const size_t smem_rows = static_cast<size_t>(S) * kRows * sizeof(float);
  int err = set_smem(den_bwd_cols, smem_cols);
  if (!err) err = set_smem(den_bwd_rows, smem_rows);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = static_cast<int>(cudaMemcpyAsync(carry, g_final, bs * sizeof(float),
                                         cudaMemcpyDeviceToDevice, st));
  if (err) return err;
  const dim3 grid_cols((S + kCols - 1) / kCols, (B + kRows - 1) / kRows);
  const dim3 grid_rows((S + kRowTile - 1) / kRowTile, (B + kRows - 1) / kRows);
  for (int t = T - 1; t >= 0; --t) {
    const float* alpha = alphas + t * bs;
    const long long f = static_cast<long long>(t) * S;
    den_bwd_cols<<<grid_cols, kThreads, smem_cols, st>>>(
        alpha, alpha + bs, carry, llf + f, lls + f, ll_stride, A, log_self, log_init,
        log_leak, dllf + f, dlls + f, d_sums, stats, B, S);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    den_bwd_rows<<<grid_rows, kThreads, smem_rows, st>>>(
        d_sums, A, alpha, dlls + f, ll_stride, log_init, log_leak, stats, g_leaked, B, S);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    den_bwd_leak<<<B, kThreads, 0, st>>>(g_leaked, alpha, log_init, log_leak, stats, carry, S);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}
