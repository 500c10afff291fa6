// YAAPT's Viterbi dynamic programs, hand-written for Hopper (sm_90a).
//
// K4 (viterbi_kernel) replaces no TPU kernel: satpu runs these DPs as an
// XLA associative scan (satpu/ops/yaapt.py::viterbi_path), which XLA fuses
// into one program. The port's plain version (satpu_torch/ops/yaapt.py::
// viterbi_path_plain) is a Python loop over frames of about eight small
// launches a frame for the two DPs together, so at the serving cells'
// 50-1750 frames a batch the host set the pace and the card waited. This
// kernel runs one DP call, the forward recursion and the backtrace, in one
// launch.
//
// For each batch row b, with local [B, C, T] and trans [B, C, C, T] indexed
// trans[b, next, prev, t] (each read through the strides it is given, so a
// transposed view needs no copy), the forward is the plain version's
// arithmetic in f32, in the same order:
//
//   cost_0[n]     = local[n, 0]
//   v[n, p]       = cost_{t-1}[p] + trans[n, p, t]
//   cost_t[n]     = min_p v[n, p] + local[n, t]
//   back_t[n]     = the p of that minimum
//
// and the path ends at the argmin of cost_{T-1} and follows back_t. Only
// adds and compares: nothing for the compiler to contract. The plain version
// takes torch.min / argmin over the candidates in flipped order, so a tie
// goes to the HIGHEST index and a NaN wins over any number, the highest
// NaN over the others: here the candidates are scanned from C - 1 down, and
// one replaces the best so far only when it is smaller, or NaN where the
// best is not. The path is then the plain version's bit for bit, on any
// input. (dynamic_final's transitions are NaN where a row has no voiced
// best candidate, as its mean pitch is then 0.)
//
// Bound: T dependent frames. In bytes, trans and local read once and the
// path written: B (C^2 + C) T 4 + 8 B T, 16 MB at B = 32, C = 6, T = 3500,
// about 5 us at 3.35 TB/s; a frame of the chain is a few dozen cycles.
//
// Design: one warp a row, one block a warp. Tiles of kTile frames of the
// row's trans and local are copied to shared memory with cp.async, lane l
// copying frame t0 + l of every (next, prev) row, so a warp's copies are
// coalesced along T; two buffers, the next tile's copy in flight while
// this one's frames run, so the recursion never waits on device memory.
// Lane n owns candidate next = n (lanes past C - 1 repeat the last one and
// store nothing): it takes the C costs of the previous frame from the lanes
// that own them by shuffle, and does C adds and compares. Staged rows are
// kTile + 1 words apart, so the lanes' reads of their own rows fall on
// distinct banks. Backpointers are bytes, [T, C], in shared memory when C T
// bytes fit beside the tiles, else in a device-memory scratch the wrapper
// allocates (satpu_viterbi_scratch_bytes); after the forward, lane 0 walks
// them back and writes the path.
//
// Instantiations: C = 4 (dynamic5, shc_maxpeaks) and C = 6 (dynamic_final,
// two NCCF tracks of 3) unrolled; any other C up to kMaxC generic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;          // frames a staged tile: a lane a frame
constexpr int kPitch = kTile + 1;  // words from one staged row to the next
constexpr int kMaxC = 16;          // candidates at most: a lane each, their tiles in shared memory
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* local;
  long long l_b, l_c, l_t;  // local's strides, in floats
  const float* trans;
  long long t_b, t_n, t_p, t_t;  // trans's strides: [b, next, prev, t]
  long long* path;               // [B, T], contiguous
  uint8_t* back;                 // [B, T, C] in device memory, or null: in shared memory
  int C, T;
};

// Start the copy of tile k of row b (frames k kTile + lane) into buf:
// rows n C + p of trans, then rows C^2 + n of local, kPitch words apart.
// Commits a group whether or not it copied anything.
template <int kC>
__device__ __forceinline__ void fetch(const Args& a, int C, int b, int k, float* buf) {
  const int t = k * kTile + static_cast<int>(threadIdx.x);
  if (t < a.T) {
    const float* tr = a.trans + b * a.t_b + t * a.t_t;
    const float* lo = a.local + b * a.l_b + t * a.l_t;
    float* to = buf + threadIdx.x;
#pragma unroll
    for (int n = 0; n < (kC ? kC : C); ++n) {
#pragma unroll
      for (int p = 0; p < (kC ? kC : C); ++p) {
        const unsigned dst =
            static_cast<unsigned>(__cvta_generic_to_shared(to + (n * C + p) * kPitch));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                     "l"(tr + n * a.t_n + p * a.t_p));
      }
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(to + (C * C + n) * kPitch));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(lo + n * a.l_c));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The lowest of the costs v(C - 1), ..., v(0) as the plain version's
// flipped torch.min takes it: from the highest index down, a candidate
// replaces the best only when smaller, or NaN where the best is not.
template <int kC, typename Cost>
__device__ __forceinline__ float lowest(int C, Cost v, int& arg) {
  float best = v(C - 1);
  arg = C - 1;
#pragma unroll
  for (int p = (kC ? kC : C) - 2; p >= 0; --p) {
    const float x = v(p);
    if (x < best || (x != x && best == best)) {
      best = x;
      arg = p;
    }
  }
  return best;
}

// kC = 0: the generic instantiation, C from the arguments.
template <int kC>
__global__ void __launch_bounds__(32) viterbi_kernel(const Args a) {
  extern __shared__ float smem[];
  const int C = kC ? kC : a.C;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int rows = C * C + C;
  float* bufs = smem;  // [2][rows, kPitch]
  uint8_t* back = a.back ? a.back + static_cast<long long>(b) * a.T * C
                         : reinterpret_cast<uint8_t*>(smem + 2 * rows * kPitch);
  const int n = lane < C ? lane : C - 1;
  const int n_tiles = (a.T + kTile - 1) / kTile;

  fetch<kC>(a, C, b, 0, bufs);
  float cost = 0.0f;  // lane n's cost of candidate n at the last frame run
  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) {
      fetch<kC>(a, C, b, k + 1, bufs + ((k + 1) & 1) * rows * kPitch);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();  // tile k is in, from every lane's copies
    const float* buf = bufs + (k & 1) * rows * kPitch;
    const float* tr = buf + n * C * kPitch;
    const float* lo = buf + (C * C + n) * kPitch;
    const int t0 = k * kTile;
    const int frames = min(kTile, a.T - t0);
    for (int f = 0; f < frames; ++f) {
      if (t0 + f == 0) {
        cost = lo[0];
        continue;
      }
      const float prev = cost;
      int arg;
      const float best = lowest<kC>(
          C, [&](int p) { return __shfl_sync(kFull, prev, p) + tr[p * kPitch + f]; }, arg);
      cost = best + lo[f];
      if (lane < C) back[static_cast<long long>(t0 + f) * C + lane] = static_cast<uint8_t>(arg);
    }
    __syncwarp();  // every lane is done with this buffer before tile k + 2 is copied into it
  }
  int cur;
  lowest<kC>(C, [&](int p) { return __shfl_sync(kFull, cost, p); }, cur);
  __syncwarp();  // the backpointers are written
  if (lane == 0) {
    long long* out = a.path + static_cast<long long>(b) * a.T;
    out[a.T - 1] = cur;
    for (int t = a.T - 1; t > 0; --t) {
      cur = back[static_cast<long long>(t) * C + cur];
      out[t - 1] = cur;
    }
  }
}

long long tile_bytes(int C) { return 2LL * (C * C + C) * kPitch * sizeof(float); }

// Backpointers in shared memory when they fit beside the tiles.
bool back_in_smem(int C, int T) { return tile_bytes(C) + static_cast<long long>(C) * T <= kMaxSmem; }

template <int kC>
int launch(const Args& a, int B, cudaStream_t stream) {
  const long long smem = tile_bytes(a.C) + (a.back ? 0 : static_cast<long long>(a.C) * a.T);
  if (smem > 48 * 1024) {
    // the most a block may have, so no other thread's call lowers it under
    // this launch
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_kernel<kC><<<B, 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of device-memory scratch a row needs for its backpointers: 0 when
// they fit shared memory, else C T.
extern "C" long long satpu_viterbi_scratch_bytes(int C, int T) {
  return back_in_smem(C, T) ? 0 : static_cast<long long>(C) * T;
}

// local [B, C, T] and trans [B, C, C, T] ([b, next, prev, t]) f32 at the
// strides given (in floats); path [B, T] int64, contiguous; back: null, or
// B satpu_viterbi_scratch_bytes(C, T) bytes of device memory when that is
// not 0. All on the current device, which the caller sets (the kernel's
// shared-memory limit is set there). One launch on `stream`; returns its
// cudaGetLastError(), or cudaErrorInvalidValue for sizes the kernel does not
// take (C outside 1..kMaxC, T < 1, or scratch missing where it is needed).
extern "C" int satpu_viterbi_path(const float* local, long long l_b, long long l_c,
                                  long long l_t, const float* trans, long long t_b,
                                  long long t_n, long long t_p, long long t_t, long long* path,
                                  uint8_t* back, int B, int C, int T, void* stream) {
  if (C < 1 || C > kMaxC || T < 1 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!back_in_smem(C, T) && back == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Args a{local, l_b, l_c, l_t, trans, t_b, t_n, t_p, t_t, path,
               back_in_smem(C, T) ? nullptr : back, C, T};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 4) return launch<4>(a, B, st);
  if (C == 6) return launch<6>(a, B, st);
  return launch<0>(a, B, st);
}
