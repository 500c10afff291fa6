// LF-MMI numerator forward-backward, hand-written for Hopper (sm_90a).
//
// K3f (num_fwd) and K3b (num_bwd) replace no TPU kernel: satpu's numerator
// is a lax.scan of one-hot matmuls (satpu/chain/objf.py:96-121), which XLA
// fuses into one program. The port's plain numerator is a Python loop over
// the T output frames of a dozen small launches each, run three times a
// training step (the forward, its autograd backward, and a second forward
// and backward for the xent targets), so at T = 247-661 the host set the
// pace and the card waited. These kernels run each direction in one launch,
// and K3b's posteriors d num / d loglikes serve both the loss's gradient
// and the xent targets (satpu_torch/chain/num_fb.py, _NumFB).
//
// For every batch row b and frame t < num_frames[b], with the row's live
// arcs e (src, dst, pdf, w), the forward step is the plain step's
// arithmetic in f32, in the same order:
//
//   score_e = alpha[src_e] + (ll[b, t, pdf_e] + w_e)
//   m       = max_e score_e, or 0 where it is at or below NEG_INF / 2
//   sums[d] = sum over the arcs into d, in arc order, of exp(score_e - m)
//   alpha'  = max(log(max(sums, 1e-30)) + m, NEG_INF)
//
// frames t >= num_frames[b] are identity steps, and the row's value is
// logsumexp(max(alpha_T + final, NEG_INF)). The backward is the VJP that
// autograd takes of that loop for d sum_b value[b] / d ll, m held constant:
// the gradient is zero through the 1e-30 floor and the NEG_INF clamp where
// they bind, and on identity frames. The same formulas, in plain PyTorch,
// are satpu_torch/chain/num_fb.py's num_fb_forward_plain /
// num_fb_backward_plain.
//
// Arcs whose log-prob is at or below NEG_INF / 2 (the padding of
// fst.pad_graph_arrays) are left out: their scores sit at NEG_INF, they add
// exact zeros to the sums and to the gradients, and never set m. The
// wrapper groups the live arcs three ways, with stable sorts, so every sum
// runs over one group in the original arc order: by destination (the order
// the arc tables are stored in; in_ptr), by source (out_ptr, out_pos) and by
// pdf (p_pos, p_pdf). One thread owns a state, so each alpha, each
// destination's sums and each source's gradient is added by one thread in
// that order, and one thread adds each (frame, pdf) posterior. No float
// atomics: two calls give the same bits.
//
// Design: one block per batch row runs all of the row's frames (rows are
// independent: one launch per direction). The row's arc tables, alpha (two
// frames), the carried gradient and each frame's arc scores live in shared
// memory. A forward frame is one block max and one barrier; a backward frame
// reads the forward's m and takes two barriers (the arcs' gradients, then
// the sources' and pdfs' sums). Frame t+1's ll gathers (and, backward,
// frame t-1's alphas) are copied to shared memory with cp.async while frame
// t computes, since the serial chain of frames is what bounds these kernels.
// K3b writes the posteriors [B, T, P] of the pdfs the row's arcs carry; the
// caller zero-fills the rest.
//
// Bound: the T dependent frames, each a few shared-memory reads, expf/logf
// and one or two barriers. In bytes, the gathered ll read and the posteriors
// written: at B = 16, T = 661, P = 3280 about 30 MB + 139 MB, or about 50 us
// at 3.35 TB/s; in operations, a few per arc and frame (under 1 us).
//
// Limits: the row's tables must fit one block's shared memory,
// satpu_num_smem_bytes(S, E, backward) <= 232448 bytes (forward 12 bytes a
// state and 12 an arc, backward 20 and 28); the wrapper raises ValueError
// beyond them.
//
// Plain f32, no fast-math intrinsics: expf, logf and the division are the
// ones torch's CUDA ops call.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;  // a normal f32: log(kTiny) is finite
constexpr int kMaxThreads = 1024;
constexpr int kRed = 32;         // floats of one block reduction's partials
constexpr unsigned kFull = 0xffffffffu;

// One batch's live arcs as the wrapper groups them: [B, E] arrays of which
// the first in_ptr[b][S] are live, and [B, S + 1] pointers.
struct Arcs {
  const int* src;      // by destination: the arc's source state
  const int* pdf;      // by destination: its pdf
  const float* w;      // by destination: its log-prob
  const int* in_ptr;   // the arcs into state j: in_ptr[j] .. in_ptr[j + 1] - 1
  const int* out_ptr;  // by source: the arcs out of state i: out_ptr[i] .. out_ptr[i + 1] - 1
  const int* out_pos;  // by source: the arc's position by destination
  const int* p_pos;    // by pdf: the arc's position by destination
  const int* p_pdf;    // by pdf: its pdf
};

struct FwdArgs {
  const float* ll;          // [B, T, P]
  Arcs arcs;
  const float* start;       // [B, S]
  const float* final_;      // [B, S]
  const int* num_frames;    // [B]
  float* alphas;            // [B, T + 1, S]
  float* m;                 // [B, T]
  float* value;             // [B]
  int B, T, P, S, E;
};

struct BwdArgs {
  const float* ll;
  Arcs arcs;
  const float* final_;
  const int* num_frames;
  const float* alphas;
  const float* m;
  const float* value;
  float* posts;             // [B, T, P], zero-filled by the caller
  int B, T, P, S, E;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block reductions (blockDim.x a multiple of 32): each warp reduces its
// lanes, then every warp reduces the partials the same way, so every thread
// holds the same bits. `red` is kRed floats that no reduction since the last
// barrier used.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return warp_max(threadIdx.x % 32 < blockDim.x / 32 ? red[threadIdx.x % 32] : -INFINITY);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return warp_sum(threadIdx.x % 32 < blockDim.x / 32 ? red[threadIdx.x % 32] : 0.0f);
}

// a 4-byte copy from device to shared memory, in flight until wait_copies()
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src));
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the row's scores of frame t's arcs: ll[t, pdf] + w, the gathers started
// with cp.async into `to` by start_scores and finished here by the thread
// that started them
__device__ __forceinline__ void start_scores(float* to, const float* ll_t, const int* pdf, int L) {
  for (int e = threadIdx.x; e < L; e += blockDim.x) copy_async(to + e, ll_t + __ldg(pdf + e));
  commit_copies();
}

__device__ __forceinline__ void finish_scores(float* to, const float* w, int L) {
  wait_copies();
  for (int e = threadIdx.x; e < L; e += blockDim.x) to[e] = to[e] + __ldg(w + e);
}

__device__ __forceinline__ void load_ints(int* to, const int* from, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) to[k] = __ldg(from + k);
}

// the frames the row runs: num_frames[b] within [0, T]
__device__ __forceinline__ int live_frames(const int* num_frames, int T) {
  return min(max(__ldg(num_frames + blockIdx.x), 0), T);
}

// Forward, one block per batch row: alphas [B, T + 1, S] (alphas[0] the
// clamped start), m [B, T] (0 on identity frames) and value [B].
__global__ void __launch_bounds__(kMaxThreads) num_fwd(FwdArgs a) {
  extern __shared__ float4 smem4[];
  const int S = a.S, E = a.E, T = a.T, b = blockIdx.x;
  float* red = reinterpret_cast<float*>(smem4);  // 4 x kRed: two frames' max, the final max and sum
  float* alpha = red + 4 * kRed;                  // [2][S]
  float* score = alpha + 2 * S;                   // [2][E]: ll + w of each arc
  int* in_ptr = reinterpret_cast<int*>(score + 2 * E);  // [S + 1]
  int* src = in_ptr + S + 1;                      // [E]
  const long long rowE = static_cast<long long>(b) * E;
  const int* pdf = a.arcs.pdf + rowE;
  const float* w = a.arcs.w + rowE;
  const float* ll = a.ll + static_cast<long long>(b) * T * a.P;
  float* out = a.alphas + static_cast<long long>(b) * (T + 1) * S;
  load_ints(in_ptr, a.arcs.in_ptr + static_cast<long long>(b) * (S + 1), S + 1);
  const int L = __ldg(a.arcs.in_ptr + static_cast<long long>(b) * (S + 1) + S);
  load_ints(src, a.arcs.src + rowE, L);
  const int nf = live_frames(a.num_frames, T);
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const float v = fmaxf(__ldg(a.start + static_cast<long long>(b) * S + j), kNegInf);
    alpha[j] = v;
    out[j] = v;
  }
  if (nf > 0) {
    start_scores(score, ll, pdf, L);
    finish_scores(score, w, L);
  }
  __syncthreads();
  for (int t = 0; t < nf; ++t) {
    const float* al = alpha + (t & 1) * S;
    float* an = alpha + ((t + 1) & 1) * S;
    const float* sc = score + (t & 1) * E;
    float* sn = score + ((t + 1) & 1) * E;
    if (t + 1 < nf) start_scores(sn, ll + static_cast<long long>(t + 1) * a.P, pdf, L);
    float mx = -INFINITY;
    for (int j = threadIdx.x; j < S; j += blockDim.x)
      for (int p = in_ptr[j]; p < in_ptr[j + 1]; ++p) mx = fmaxf(mx, al[src[p]] + sc[p]);
    mx = block_max(mx, red + (t & 1) * kRed);
    const float m = mx > kNegInf / 2 ? mx : 0.0f;
    if (threadIdx.x == 0) a.m[static_cast<long long>(b) * T + t] = m;
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      float sums = 0.0f;
      for (int p = in_ptr[j]; p < in_ptr[j + 1]; ++p) sums += expf((al[src[p]] + sc[p]) - m);
      const float v = fmaxf(logf(fmaxf(sums, kTiny)) + m, kNegInf);
      an[j] = v;
      out[static_cast<long long>(t + 1) * S + j] = v;
    }
    if (t + 1 < nf) finish_scores(sn, w, L);
    __syncthreads();
  }
  // identity frames, then the value logsumexp(max(alpha_T + final, NEG_INF))
  const float* af = alpha + (nf & 1) * S;
  for (int t = nf; t < T; ++t) {
    for (int j = threadIdx.x; j < S; j += blockDim.x)
      out[static_cast<long long>(t + 1) * S + j] = af[j];
    if (threadIdx.x == 0) a.m[static_cast<long long>(b) * T + t] = 0.0f;
  }
  const float* fin = a.final_ + static_cast<long long>(b) * S;
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    mx = fmaxf(mx, fmaxf(af[j] + __ldg(fin + j), kNegInf));
  mx = block_max(mx, red + 2 * kRed);
  float s = 0.0f;
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    s += expf(fmaxf(af[j] + __ldg(fin + j), kNegInf) - mx);
  s = block_sum(s, red + 3 * kRed);
  if (threadIdx.x == 0) a.value[b] = logf(s) + mx;
}

// Backward, one block per batch row, t = num_frames[b] - 1 ... 0: the
// posteriors d sum_b value[b] / d ll into posts [B, T, P]. The carried
// gradient g = d / d alpha_{t+1} starts as the value's VJP.
__global__ void __launch_bounds__(kMaxThreads) num_bwd(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const int S = a.S, E = a.E, T = a.T, b = blockIdx.x;
  float* alpha = reinterpret_cast<float*>(smem4);  // [2][S]
  float* g = alpha + 2 * S;                        // [S]
  float* score = g + S;                            // [2][E]
  float* gs = score + 2 * E;                       // [E]: d / d score of each arc
  int* in_ptr = reinterpret_cast<int*>(gs + E);    // [S + 1]
  int* out_ptr = in_ptr + S + 1;                   // [S + 1]
  int* src = out_ptr + S + 1;                      // [E]
  int* out_pos = src + E;                          // [E]
  int* p_pos = out_pos + E;                        // [E]
  int* p_pdf = p_pos + E;                          // [E]
  const long long rowE = static_cast<long long>(b) * E, rowS1 = static_cast<long long>(b) * (S + 1);
  const int* pdf = a.arcs.pdf + rowE;
  const float* w = a.arcs.w + rowE;
  const float* ll = a.ll + static_cast<long long>(b) * T * a.P;
  const float* row = a.alphas + static_cast<long long>(b) * (T + 1) * S;
  load_ints(in_ptr, a.arcs.in_ptr + rowS1, S + 1);
  load_ints(out_ptr, a.arcs.out_ptr + rowS1, S + 1);
  const int L = __ldg(a.arcs.in_ptr + rowS1 + S);
  load_ints(src, a.arcs.src + rowE, L);
  load_ints(out_pos, a.arcs.out_pos + rowE, L);
  load_ints(p_pos, a.arcs.p_pos + rowE, L);
  load_ints(p_pdf, a.arcs.p_pdf + rowE, L);
  const int nf = live_frames(a.num_frames, T);
  // the value's VJP: exp(y - value) through the clamp y = max(x, NEG_INF),
  // x = alpha_T + final
  const float v = __ldg(a.value + b);
  const float* fin = a.final_ + static_cast<long long>(b) * S;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const float x = __ldg(row + static_cast<long long>(T) * S + j) + __ldg(fin + j);
    g[j] = x >= kNegInf ? expf(fmaxf(x, kNegInf) - v) : 0.0f;
  }
  if (nf > 0) {
    const int t = nf - 1;
    for (int j = threadIdx.x; j < S; j += blockDim.x)
      alpha[(t & 1) * S + j] = __ldg(row + static_cast<long long>(t) * S + j);
    start_scores(score + (t & 1) * E, ll + static_cast<long long>(t) * a.P, pdf, L);
    finish_scores(score + (t & 1) * E, w, L);
  }
  const float* ms = a.m + static_cast<long long>(b) * T;
  float m_next = nf > 0 ? __ldg(ms + nf - 1) : 0.0f;
  __syncthreads();
  for (int t = nf - 1; t >= 0; --t) {
    const float* al = alpha + (t & 1) * S;
    const float* sc = score + (t & 1) * E;
    float* sn = score + ((t + 1) & 1) * E;
    const float m = m_next;
    if (t > 0) {
      m_next = __ldg(ms + t - 1);
      float* an = alpha + ((t + 1) & 1) * S;
      const float* prev = row + static_cast<long long>(t - 1) * S;
      for (int j = threadIdx.x; j < S; j += blockDim.x) copy_async(an + j, prev + j);
      start_scores(sn, ll + static_cast<long long>(t - 1) * a.P, pdf, L);
    }
    // each destination: its sums again, then the gradient of its arcs'
    // scores, as autograd takes it through max(log(max(sums, tiny)) + m,
    // NEG_INF)
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      float sums = 0.0f;
      for (int p = in_ptr[j]; p < in_ptr[j + 1]; ++p) sums += expf((al[src[p]] + sc[p]) - m);
      const float x = logf(fmaxf(sums, kTiny)) + m;
      const float g1 = x >= kNegInf ? g[j] : 0.0f;
      const float g2 = g1 / fmaxf(sums, kTiny);
      const float g3 = sums >= kTiny ? g2 : 0.0f;
      for (int p = in_ptr[j]; p < in_ptr[j + 1]; ++p)
        gs[p] = g3 * expf((al[src[p]] + sc[p]) - m);
    }
    __syncthreads();
    // each source's gradient d / d alpha_t, and each pdf's posterior
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      float acc = 0.0f;
      for (int k = out_ptr[j]; k < out_ptr[j + 1]; ++k) acc += gs[out_pos[k]];
      g[j] = acc;
    }
    float* post = a.posts + (static_cast<long long>(b) * T + t) * a.P;
    for (int k = threadIdx.x; k < L; k += blockDim.x) {
      const int p = p_pdf[k];
      if (k > 0 && p_pdf[k - 1] == p) continue;  // not the first arc of its pdf
      float acc = 0.0f;
      for (int q = k; q < L && p_pdf[q] == p; ++q) acc += gs[p_pos[q]];
      post[p] = acc;
    }
    if (t > 0) finish_scores(sn, w, L);
    __syncthreads();
  }
}

long long smem_bytes(int S, int E, bool backward) {
  if (backward) return 4LL * (3LL * S + 3LL * E + 2LL * (S + 1) + 4LL * E);
  return 4LL * (4 * kRed + 2LL * S + 2LL * E + (S + 1) + E);
}

int threads(int S, int E) {
  const int want = S > (E + 1) / 2 ? S : (E + 1) / 2;
  const int n = (want + 31) / 32 * 32;
  return n < 64 ? 64 : (n > kMaxThreads ? kMaxThreads : n);
}

template <typename Kernel>
int set_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool takes(int B, int T, int P, int S, int E) {
  return B > 0 && T >= 0 && P > 0 && S > 0 && E > 0;
}

}  // namespace

// Dynamic shared memory of one block at S states and E arcs a row.
extern "C" long long satpu_num_smem_bytes(int S, int E, int backward) {
  return smem_bytes(S, E, backward != 0);
}

// Forward: ll [B, T, P]; the live arcs grouped by destination (src, pdf, w
// [B, E], in_ptr [B, S + 1]); start, final [B, S]; num_frames [B] int32.
// Writes alphas [B, T + 1, S], m [B, T] and value [B]. All contiguous
// buffers of the current device, which the caller sets (its shared-memory
// limit is set there). One launch on `stream`; returns its
// cudaGetLastError(), or cudaErrorInvalidValue for sizes the kernel does not
// take.
extern "C" int satpu_num_fwd(const float* ll, const int* src, const int* pdf, const float* w,
                             const int* in_ptr, const float* start, const float* final_,
                             const int* num_frames, float* alphas, float* m, float* value,
                             int B, int T, int P, int S, int E, void* stream) {
  if (!takes(B, T, P, S, E)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{ll, {src, pdf, w, in_ptr, nullptr, nullptr, nullptr, nullptr}, start, final_,
                  num_frames, alphas, m, value, B, T, P, S, E};
  const long long smem = smem_bytes(S, E, false);
  int err = set_smem(num_fwd, smem);
  if (err) return err;
  num_fwd<<<B, threads(S, E), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Backward: as satpu_num_fwd's inputs, plus the arcs grouped by source
// (out_ptr [B, S + 1], out_pos [B, E]) and by pdf (p_pos, p_pdf [B, E]), and
// the forward's alphas, m and value; adds into posts [B, T, P], which the
// caller zero-fills. One launch on `stream`; returns as satpu_num_fwd.
extern "C" int satpu_num_bwd(const float* ll, const int* src, const int* pdf, const float* w,
                             const int* in_ptr, const int* out_ptr, const int* out_pos,
                             const int* p_pos, const int* p_pdf, const float* final_,
                             const int* num_frames, const float* alphas, const float* m,
                             const float* value, float* posts, int B, int T, int P, int S,
                             int E, void* stream) {
  if (!takes(B, T, P, S, E)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{ll, {src, pdf, w, in_ptr, out_ptr, out_pos, p_pos, p_pdf}, final_,
                  num_frames, alphas, m, value, posts, B, T, P, S, E};
  const long long smem = smem_bytes(S, E, true);
  int err = set_smem(num_bwd, smem);
  if (err) return err;
  num_bwd<<<B, threads(S, E), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
