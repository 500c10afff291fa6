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
// Design: destination-sparse and persistent. A comes from the den graph's
// arcs and is sparse (14,924 nonzeros of 1641^2 on the full-scale graph,
// in-degree 9.1 on average and at most 17; one state fans out to all 164
// phones). The wrapper passes A's nonzeros twice (den_fb.den_sparse): by
// destination (row j: the in-arcs of j, ascending source) for sums, and by
// source (row i: the out-arcs of i, ascending destination) for d_sums @ A^T;
// states are 16-bit, pointers 32-bit, values f32. One block of 1024 threads
// owns one batch row for all T frames (rows are independent: no grid-wide
// barrier, one launch per direction). Thread x owns the states x, x + 1024,
// ...; its states' alpha, emission scores and carried gradient stay in its
// registers, and only the vectors that other threads read through the arcs
// (e, and d_sums in the backward) go to shared memory. A frame is three
// block reductions (max, sum, max; one without the leak), a barrier after e,
// then each thread's in-arc sums as f32 FMAs in ascending arc order; the
// backward adds a barrier after d_sums, each thread's out-arc sums, and one
// block sum for the leak's d_lse. A row of more than 32 arcs (the start
// state's fan-out) is split across the warp that owns it, lane l taking arcs
// l, l + 32, ..., added in a fixed shuffle tree. Every reduction runs in a
// fixed order and there are no atomics: two calls give the same bits. The
// next frame's llf / lls (and, backward, alphas) rows are loaded into
// registers at the top of each step, so their device-memory latency hides
// behind the step's compute.
//
// Placement: when the arc arrays fit the block's shared memory beside the
// row vectors (forward 96 KB, backward 192 KB at S = 1641), they are copied
// there once per block with cp.async; otherwise (e.g. S = 4001, 234 KB by
// destination alone) the same kernel reads them from device memory through
// the read-only path, where they stay resident in the 50 MB L2.
//
// Bound: the serial chain of T steps, each a handful of block-wide
// reductions and barriers, not bytes (llf, lls and the alphas once, A's
// sparse form once: 31.5 MB forward, 9.4 us at 3.35 TB/s, at B = 16, T =
// 99) or operations (2 B T nnz = 47 MFLOP forward, 0.7 us). One block per
// batch row fills B of the 132 SMs.
//
// Sentinels follow the TPU kernel: NEG_INF = -1e30 (finite), exp(x - y) is 0
// wherever y <= NEG_INF / 2, and log_leak < NEG_INF / 2 switches the leak
// off. Plain f32 FMA, no TF32, no fast-math intrinsics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;  // a normal f32: log(kTiny) is finite
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPer = 6;        // states a thread owns, at most
constexpr int kSplit = 32;        // rows with more arcs are split across a warp
constexpr int kMaxIndex = 32767;  // states are int16
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == 32, "a block reduction reads one partial per lane");

// A's nonzeros by destination or by source: the arcs of state s are
// ptr[s] .. ptr[s + 1] - 1, with the other state in idx (ascending) and A's
// entry in val.
struct Arcs {
  const int* ptr;
  const short* idx;
  const float* val;
};

struct FwdArgs {
  const float* llf;
  const float* lls;
  Arcs in;
  const float* log_self;
  const float* log_init;
  float log_leak;
  float* alphas;
  int B, T, S, nnz;
};

struct BwdArgs {
  const float* g_final;
  const float* alphas;
  const float* llf;
  const float* lls;
  Arcs in, out;
  const float* log_self;
  const float* log_init;
  float log_leak;
  float* dllf;
  float* dlls;
  int B, T, S, nnz;
};

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// exp(x - y), and 0 where y is the clamped log(0)
__device__ __forceinline__ float guard_exp(float x, float y) {
  return y > kNegInf / 2 ? expf(x - y) : 0.0f;
}

// xor butterflies: every lane ends with the same bits
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block reductions: each warp reduces its lanes, then every warp reduces the
// kWarps partials the same way, so every thread holds the same result. `red`
// is kWarps floats that no other reduction of the step uses.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return warp_max(red[threadIdx.x % 32]);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return warp_sum(red[threadIdx.x % 32]);
}

// the state of this thread's slot k: threadIdx.x + k * kThreads
__device__ __forceinline__ int state(int k) { return static_cast<int>(threadIdx.x) + k * kThreads; }

template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

__device__ __forceinline__ void copy_words(void* dst, const void* src, int n) {
  unsigned* d = static_cast<unsigned*>(dst);
  const unsigned* s = static_cast<const unsigned*>(src);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(d + k));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(s + k));
  }
}

__host__ __device__ constexpr long long arcs_bytes(int S, int nnz) {
  return 4LL * (S + 1) + 4LL * nnz + 2LL * (nnz + (nnz & 1));
}

// Starts the copy of g's arrays to shared memory at `at` (ptr, val, then idx
// padded to whole words: arcs_bytes(S, nnz) bytes) and returns the copy. The
// caller waits for the copies and synchronises the block.
__device__ Arcs stage(Arcs g, int S, int nnz, char* at) {
  int* ptr = reinterpret_cast<int*>(at);
  float* val = reinterpret_cast<float*>(ptr + S + 1);
  short* idx = reinterpret_cast<short*>(val + nnz);
  copy_words(ptr, g.ptr, S + 1);
  copy_words(val, g.val, nnz);
  copy_words(idx, g.idx, nnz / 2);
  if ((nnz & 1) && threadIdx.x == 0) idx[nnz - 1] = g.idx[nnz - 1];
  return {ptr, idx, val};
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// sum over the arcs p of state s of x[idx[p]] * val[p] (0 for s >= S). A
// row of at most kSplit arcs runs in its owner thread in ascending order; a
// longer one is split across the owner's warp: lane l takes arcs l, l + 32,
// ..., and the warp adds the partial sums in a fixed tree. Every thread of
// the block calls it.
template <bool kShared>
__device__ float row_sum(const Arcs& a, const float* x, int s, int S) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = 0;
  if (s < S) {
    lo = ld<kShared>(a.ptr + s);
    hi = ld<kShared>(a.ptr + s + 1);
  }
  const bool split = hi - lo > kSplit;
  float acc = 0.0f;
  if (!split)
    for (int p = lo; p < hi; ++p)
      acc = fmaf(x[ld<kShared>(a.idx + p)], ld<kShared>(a.val + p), acc);
  for (unsigned todo = __ballot_sync(kFull, split); todo; todo &= todo - 1) {
    const int owner = __ffs(todo) - 1;
    const int l = __shfl_sync(kFull, lo, owner), h = __shfl_sync(kFull, hi, owner);
    float part = 0.0f;
    for (int p = l + lane; p < h; p += 32)
      part = fmaf(x[ld<kShared>(a.idx + p)], ld<kShared>(a.val + p), part);
    part = warp_sum(part);
    if (lane == owner) acc = part;
  }
  return acc;
}

// The row's lse = logsumexp(alpha) and m = max(leaked) (0 where the row is
// all NEG_INF), and this thread's leaked. kl = log_leak + log_init of the
// thread's states. Three block reductions with the leak; without it one
// (leaked = alpha, m from alpha's max, lse unused).
template <int kPer>
__device__ void row_stats(const float (&alpha)[kPer], const float (&kl)[kPer], bool leak, int S,
                          float* red, float& lse, float& m, float (&leaked)[kPer]) {
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (state(k) < S) mx = fmaxf(mx, alpha[k]);
  mx = block_max(mx, red);
  const float m0 = mx > kNegInf / 2 ? mx : 0.0f;
  if (!leak) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) leaked[k] = alpha[k];
    lse = 0.0f;
    m = m0;
    return;
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (state(k) < S) s += expf(alpha[k] - m0);
  lse = logf(block_sum(s, red + kWarps)) + m0;
  float ml = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    leaked[k] = logaddexp(alpha[k], kl[k] + lse);
    if (state(k) < S) ml = fmaxf(ml, leaked[k]);
  }
  ml = block_max(ml, red + 2 * kWarps);
  m = ml > kNegInf / 2 ? ml : 0.0f;
}

// Forward, one block per batch row, all T frames: alphas [T + 1, B, S] with
// alphas[0] filled by the caller; llf, lls [B, T, S].
template <int kPer, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) den_fwd(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // reduction partials, 4 x kWarps
  float* e_s = red + 4 * kWarps;                  // [S]
  const int S = a.S, T = a.T;
  Arcs in = a.in;
  if constexpr (kShared) {
    in = stage(in, S, a.nnz, reinterpret_cast<char*>(e_s + S));
    wait_copies();
  }
  const bool leak = a.log_leak > kNegInf / 2;
  const long long bs = static_cast<long long>(a.B) * S;
  const float* __restrict__ llf = a.llf + blockIdx.x * static_cast<long long>(T) * S;
  const float* __restrict__ lls = a.lls + blockIdx.x * static_cast<long long>(T) * S;
  float* __restrict__ row = a.alphas + blockIdx.x * static_cast<long long>(S);  // + t * bs
  float alpha[kPer], kl[kPer], lself[kPer], cf[kPer], cs[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = state(k);
    const bool v = j < S;
    alpha[k] = v ? row[j] : kNegInf;
    kl[k] = v ? a.log_leak + a.log_init[j] : 0.0f;
    lself[k] = v ? a.log_self[j] : 0.0f;
    cf[k] = v ? llf[j] : 0.0f;
    cs[k] = v ? lls[j] : 0.0f;
  }
  __syncthreads();  // the staged arcs
  for (int t = 0; t < T; ++t) {
    const long long next = static_cast<long long>(min(t + 1, T - 1)) * S;
    float nf[kPer], ns[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = state(k);
      nf[k] = j < S ? llf[next + j] : 0.0f;
      ns[k] = j < S ? lls[next + j] : 0.0f;
    }
    float leaked[kPer], lse, m;
    row_stats<kPer>(alpha, kl, leak, S, red, lse, m, leaked);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = state(k);
      if (j < S) e_s[j] = expf(leaked[k] - m);
    }
    __syncthreads();
    float* __restrict__ out = row + (t + 1) * bs;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = state(k);
      const float sums = row_sum<kShared>(in, e_s, j, S);
      if (j < S) {
        const float cross = logf(fmaxf(sums, kTiny)) + m + cf[k];
        const float selfp = leaked[k] + lself[k] + cs[k];
        alpha[k] = fmaxf(logaddexp(cross, selfp), kNegInf);
        out[j] = alpha[k];
      }
      cf[k] = nf[k];
      cs[k] = ns[k];
    }
  }
}

// Backward, one block per batch row, t = T - 1 ... 0: dllf, dlls [B, T, S]
// from g_final [B, S] = dL/d alpha_T and the forward's alphas. The carried
// gradient dL/d alpha_t stays in registers.
template <int kPer, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) den_bwd(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // reduction partials, 4 x kWarps
  float* e_s = red + 4 * kWarps;                  // [S]
  float* ds_s = e_s + a.S;                        // [S] d_sums
  const int S = a.S, T = a.T;
  Arcs in = a.in, out = a.out;
  if constexpr (kShared) {
    char* at = reinterpret_cast<char*>(ds_s + S);
    in = stage(in, S, a.nnz, at);
    out = stage(out, S, a.nnz, at + arcs_bytes(S, a.nnz));
    wait_copies();
  }
  const bool leak = a.log_leak > kNegInf / 2;
  const long long bs = static_cast<long long>(a.B) * S;
  const long long off = blockIdx.x * static_cast<long long>(T) * S;  // [B, T, S] row
  const float* __restrict__ llf = a.llf + off;
  const float* __restrict__ lls = a.lls + off;
  float* __restrict__ dllf = a.dllf + off;
  float* __restrict__ dlls = a.dlls + off;
  const float* __restrict__ row = a.alphas + blockIdx.x * static_cast<long long>(S);
  float g[kPer], newa[kPer], alpha[kPer], kl[kPer], lself[kPer], cf[kPer], cs[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = state(k);
    const bool v = j < S;
    const long long last = static_cast<long long>(T - 1) * S;
    g[k] = v ? a.g_final[blockIdx.x * static_cast<long long>(S) + j] : 0.0f;
    newa[k] = v ? row[T * bs + j] : kNegInf;
    alpha[k] = v ? row[(T - 1) * bs + j] : kNegInf;
    kl[k] = v ? a.log_leak + a.log_init[j] : 0.0f;
    lself[k] = v ? a.log_self[j] : 0.0f;
    cf[k] = v ? llf[last + j] : 0.0f;
    cs[k] = v ? lls[last + j] : 0.0f;
  }
  __syncthreads();  // the staged arcs
  for (int t = T - 1; t >= 0; --t) {
    const int tp = max(t - 1, 0);
    float pa[kPer], nf[kPer], ns[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = state(k);
      const bool v = j < S;
      pa[k] = v ? row[tp * bs + j] : kNegInf;
      nf[k] = v ? llf[static_cast<long long>(tp) * S + j] : 0.0f;
      ns[k] = v ? lls[static_cast<long long>(tp) * S + j] : 0.0f;
    }
    float leaked[kPer], e[kPer], ws[kPer], lse, m;
    row_stats<kPer>(alpha, kl, leak, S, red, lse, m, leaked);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = state(k);
      e[k] = j < S ? expf(leaked[k] - m) : 0.0f;
      if (j < S) e_s[j] = e[k];
    }
    __syncthreads();
    const long long f = static_cast<long long>(t) * S;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = state(k);
      const float sums = row_sum<kShared>(in, e_s, j, S);
      ws[k] = 0.0f;
      if (j < S) {
        const float cross = logf(fmaxf(sums, kTiny)) + m + cf[k];
        const float selfp = leaked[k] + lself[k] + cs[k];
        // the clamp max(lae, NEG_INF) passes gradient where it is inactive
        const bool live = newa[k] > kNegInf;
        const float wc = live ? g[k] * guard_exp(cross, newa[k]) : 0.0f;
        ws[k] = live ? g[k] * guard_exp(selfp, newa[k]) : 0.0f;
        dllf[f + j] = wc;
        dlls[f + j] = ws[k];
        ds_s[j] = sums > kTiny ? wc / fmaxf(sums, kTiny) : 0.0f;
      }
    }
    __syncthreads();
    // g_leaked = e * (d_sums @ A^T) + w_self, then the leak's VJP: with
    // leaked = logaddexp(alpha, k + lse) and lse = logsumexp(alpha),
    //   d_lse   = sum_i g_leaked[i] * exp(k_i + lse - leaked_i)
    //   g_alpha = g_leaked * exp(alpha - leaked) + d_lse * exp(alpha - lse)
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = state(k);
      const float gl = e[k] * row_sum<kShared>(out, ds_s, i, S) + ws[k];
      g[k] = gl * guard_exp(alpha[k], leaked[k]);
      if (leak && i < S) part += gl * guard_exp(kl[k] + lse, leaked[k]);
    }
    if (leak) {
      const float d_lse = block_sum(part, red + 3 * kWarps);
#pragma unroll
      for (int k = 0; k < kPer; ++k) g[k] += d_lse * guard_exp(alpha[k], lse);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      newa[k] = alpha[k];
      alpha[k] = pa[k];
      cf[k] = nf[k];
      cs[k] = ns[k];
    }
  }
}

long long smem_bytes(int S, int nnz, bool backward, bool shared) {
  const int forms = backward ? 2 : 1;  // e (and d_sums); A by destination (and by source)
  long long bytes = 4LL * (4 * kWarps + forms * S);
  if (shared) bytes += forms * arcs_bytes(S, nnz);
  return bytes;
}

template <typename Kernel>
int set_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename Args>
using Launch = int (*)(const Args&, long long, cudaStream_t);

template <int kPer, bool kShared>
int launch_fwd(const FwdArgs& a, long long smem, cudaStream_t st) {
  int err = set_smem(den_fwd<kPer, kShared>, smem);
  if (err) return err;
  den_fwd<kPer, kShared><<<a.B, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kPer, bool kShared>
int launch_bwd(const BwdArgs& a, long long smem, cudaStream_t st) {
  int err = set_smem(den_bwd<kPer, kShared>, smem);
  if (err) return err;
  den_bwd<kPer, kShared><<<a.B, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations, by tier(S) (kPer 2, 4, 6) and placement (global, shared)
const Launch<FwdArgs> kFwd[3][2] = {{launch_fwd<2, false>, launch_fwd<2, true>},
                                    {launch_fwd<4, false>, launch_fwd<4, true>},
                                    {launch_fwd<6, false>, launch_fwd<6, true>}};
const Launch<BwdArgs> kBwd[3][2] = {{launch_bwd<2, false>, launch_bwd<2, true>},
                                    {launch_bwd<4, false>, launch_bwd<4, true>},
                                    {launch_bwd<6, false>, launch_bwd<6, true>}};

int tier(int S) { return (S - 1) / (2 * kThreads); }  // 0, 1, 2: kPer = 2 (tier + 1)

bool takes(int S, int nnz) { return S > 0 && S <= kMaxIndex && S <= kMaxPer * kThreads && nnz >= 0; }

}  // namespace

// The most states the kernels take.
extern "C" int satpu_den_max_states() {
  return kMaxPer * kThreads < kMaxIndex ? kMaxPer * kThreads : kMaxIndex;
}

// Dynamic shared memory of one block at S states and nnz arcs, with the
// arcs in shared memory (shared = 1) or read from device memory (0).
extern "C" long long satpu_den_smem_bytes(int S, int nnz, int backward, int shared) {
  return smem_bytes(S, nnz, backward != 0, shared != 0);
}

// Forward: llf, lls [B, T, S]; A's arcs by destination (in_ptr [S + 1]
// int32, in_src [nnz] int16, in_val [nnz] f32); log_self, log_init [S];
// alphas [T + 1, B, S] with alphas[0] = alpha_0 filled by the caller. Writes
// alphas[1..T]. All contiguous buffers of the current device, which the
// caller sets (its shared-memory limit is set there). One launch on `stream`;
// returns its cudaGetLastError(), or cudaErrorInvalidValue for sizes the
// kernel does not take.
extern "C" int satpu_den_fwd(const float* llf, const float* lls, const int* in_ptr,
                             const short* in_src, const float* in_val, const float* log_self,
                             const float* log_init, float log_leak, float* alphas, int B,
                             int T, int S, int nnz, int shared, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!takes(S, nnz)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{llf, lls, {in_ptr, in_src, in_val}, log_self, log_init, log_leak, alphas,
                  B, T, S, nnz};
  return kFwd[tier(S)][shared != 0](a, smem_bytes(S, nnz, false, shared != 0),
                                           static_cast<cudaStream_t>(stream));
}

// Backward: g_final [B, S] = dL/d alpha_T; alphas [T + 1, B, S] from the
// forward; A's arcs by destination and by source (out_ptr [S + 1], out_dst
// [nnz], out_val [nnz]); writes dllf, dlls [B, T, S]. One launch on
// `stream`; returns as satpu_den_fwd.
extern "C" int satpu_den_bwd(const float* g_final, const float* alphas, const float* llf,
                             const float* lls, const int* in_ptr, const short* in_src,
                             const float* in_val, const int* out_ptr, const short* out_dst,
                             const float* out_val, const float* log_self,
                             const float* log_init, float log_leak, float* dllf, float* dlls,
                             int B, int T, int S, int nnz, int shared, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!takes(S, nnz)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{g_final, alphas, llf, lls, {in_ptr, in_src, in_val},
                  {out_ptr, out_dst, out_val}, log_self, log_init, log_leak, dllf, dlls,
                  B, T, S, nnz};
  return kBwd[tier(S)][shared != 0](a, smem_bytes(S, nnz, true, shared != 0),
                                           static_cast<cudaStream_t>(stream));
}
