// SHC band of the YAAPT spectral track, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel satpu/ops/yaapt.py::_shc_pallas_from_packs (the
// pl.pallas_call at yaapt.py:588), reached from shc_all_frames through
// _shc_band_matmul_pallas. It computes
//
//   shc[f, i] = sum_{j < J} prod_{h < H} mag[f, (min_shc + i) * (h + 1) + j]
//
// over the half-window-padded banded DFT magnitude mag [F, M] (f32) into
// shc [F, I] (f32). With the anonymizer's YAAPT options M = 1045, I = 226,
// H = 4, J = 21, min_shc = 31.
//
// Bound. Per frame the function must read the M - min_shc = 1014 columns
// it taps (4056 bytes; the kernel copies whole frames, 3% more) and write
// I*4 = 904 bytes against I*J*H = 18,984 flops (about 3.8 flops per byte),
// far below the ~20 flops per byte at which H100's f32 units (67 TFLOP/s)
// would become the limit at 3.35 TB/s: 94.8 us at F = 64,000 frames (B =
// 128 utterances of 10 s). What bounds this design is shared-memory
// traffic: about 2.3 wavefronts an output by a model of this layout
// (chip_smoke.py's shc_wavefronts, which reads the layout from
// satpu_shc_layout), 126 us at F = 64,000 at one wavefront a clock on 132
// SMs at 1.98 GHz. The first design (one output a thread, taps read
// straight from a staged row, (h+1)-strided across a warp) took 5.25 and
// 390 us.
//
// Design: the TPU kernel's phase packs come back, built in shared memory at
// no cost in device memory. Harmonic s = h + 1 of a staged frame is stored
// as s phases, phase rho holding the columns (min_shc + t) * s + rho for
// t = 0, 1, ..., so the tap of candidate i at window offset j = rho + s * m
// is phase rho's word t = i + m. A thread owns kR = 4 consecutive candidates
// i0..i0+3 of one frame; for each (s, rho) their taps are one run of
// consecutive words from word i0, read as float4 (neighbouring lanes read
// neighbouring vectors: no conflicts) and reused from registers for every
// (candidate, j). With (H, J) known at compile time every loop unrolls and
// the taps are immediates: 32 float4 reads serve 4 outputs, 1 wavefront an
// output.
//
// A block is persistent over groups of kRows = 4 frames, which are one
// contiguous 16-byte aligned run of mag. Per group: cp.async copies the
// group into `raw` (16-byte pieces, no registers), the block lays it out as
// phases (each thread moves 4 columns of every frame: one or two aligned
// float4 reads, one float4, two float2 or four word stores; the pitches
// keep a warp's stores on distinct banks), and then the next group's copy
// is started, so it runs under this group's products. The outputs are
// staged in shared memory (two buffers) and written to device memory as
// contiguous rows while the next group's products are formed. Three blocks
// share an SM (80 registers a thread), so one block's staging overlaps the
// others' arithmetic.
//
// Any other geometry (H <= kMaxH, any J) takes the generic instantiation:
// the same copy, layout and thread ownership, with J a runtime loop that
// reads the two float4 covering each (h, j) run, and the frame's offset in
// its float4 selected at run time.
//
// Order: prod over h is taken h = 0..H-1 and the sum over j in ascending j,
// in both instantiations; no atomics, so two calls give the same bits.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kRows = 4;       // frames per block
static_assert(kRows % 4 == 0, "a group of frames starts on a float4");
constexpr int kThreads = 256;  // threads per block
constexpr int kR = 4;          // consecutive candidates a thread
constexpr int kMaxH = 6;       // harmonics the layout has room for
constexpr int kBlocksPerSm = 3;  // resident blocks an SM: at most 85 registers a thread
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

// Where each harmonic's phases live in a staged frame (words). Computed on
// the host from the geometry, passed by value.
struct Layout {
  int off[kMaxH];    // first word of harmonic h's phase 0
  int pitch[kMaxH];  // words from phase rho to phase rho + 1
  int len[kMaxH];    // words t = 0 .. len - 1 of every phase
  int row_words;     // words from one staged frame to the next
};

struct Args {
  const float* mag;
  float* out;
  int F, M, min_shc, n_out, n_harm, win, n_quads;
  int raw_words;  // kRows * M and the deinterleave's overreach, in float4
  int vec;        // mag is 16-byte aligned: copy it in 16-byte pieces
  Layout lay;
};

// Start the asynchronous copy of group g's frames (n_rows * M contiguous
// floats of mag) into raw: in 16-byte pieces when mag is 16-byte aligned
// (then so is every group, as kRows is a multiple of 4), else in 4-byte
// ones.
__device__ __forceinline__ void fetch(const Args& a, int g, float* raw) {
  const long long f0 = static_cast<long long>(g) * kRows;
  const int n = static_cast<int>(min(static_cast<long long>(kRows), a.F - f0)) * a.M;
  const float* src = a.mag + f0 * a.M;
  const int n4 = a.vec ? n / 4 : 0;
  for (int k = threadIdx.x; k < n4; k += kThreads) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(raw + 4 * k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src + 4 * k));
  }
  for (int k = 4 * n4 + threadIdx.x; k < n; k += kThreads) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(raw + k));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src + k));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16- and 8-byte stores to shared memory at an aligned address (written
// out: nvcc splits a store through a reinterpret_cast float4 pointer here
// into four 4-byte ones, which conflict 4-way across a warp)
__device__ __forceinline__ void st_shared(float* p, float x, float y, float z, float w) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(to), "f"(x), "f"(y), "f"(z),
               "f"(w));
}

__device__ __forceinline__ void st_shared(float* p, float x, float y) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(to), "f"(x), "f"(y));
}

__device__ __forceinline__ void wait_fetch() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Move harmonic kS of the group's frames into its phases: element e is
// column min_shc * kS + e, phase e % kS, word e / kS. A thread moves
// elements e = 4q..4q+3 of every frame, read as the aligned float4 that
// cover them (two unless they are aligned: frame r's run starts at word
// sh_r of its float4, the same in every lane) and stored as one float4
// (kS = 1), two float2 (kS = 2) or four words. Columns past the row's end
// are zeros. kKnown: M % 4 == kM4 and frame 0's run starts at word kSh0,
// so every sh_r is known at compile time (no selects); else sh_r is taken
// at run time.
template <int kS, bool kKnown, int kM4, int kSh0>
__device__ __forceinline__ void move_harmonic(const Args& a, int n_rows, const float* raw,
                                              float* rows) {
  const Layout& L = a.lay;
  const int c0 = a.min_shc * kS;
  const int n = kS * L.len[kS - 1];  // a multiple of 4
  const int pitch = L.pitch[kS - 1];
  for (int q = threadIdx.x; 4 * q < n; q += kThreads) {
    const int e = 4 * q;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= n_rows) break;
      const int w = r * a.M + c0 + e;
      const int sh = kKnown ? (kSh0 + r * kM4) & 3 : w & 3;
      const float4* p = reinterpret_cast<const float4*>(raw + (w - sh));
      const float4 x = p[0];
      const float4 y = sh ? p[1] : x;
      const float u[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float vi = sh == 0 ? u[i] : sh == 1 ? u[i + 1] : sh == 2 ? u[i + 2] : u[i + 3];
        v[i] = c0 + e + i < a.M ? vi : 0.0f;
      }
      float* row = rows + r * L.row_words + L.off[kS - 1];
      if constexpr (kS == 1) {
        st_shared(row + e, v[0], v[1], v[2], v[3]);
      } else if constexpr (kS == 2) {
        st_shared(row + 2 * q, v[0], v[2]);
        st_shared(row + pitch + 2 * q, v[1], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = (e + i) / kS;
          row[(e + i - t * kS) * pitch + t] = v[i];
        }
      }
    }
  }
}

template <int kS, int kM4>
__device__ __forceinline__ void move_harmonic_m4(const Args& a, int n_rows, const float* raw,
                                                 float* rows) {
  switch (a.min_shc * kS % 4) {
    case 0: move_harmonic<kS, true, kM4, 0>(a, n_rows, raw, rows); break;
    case 1: move_harmonic<kS, true, kM4, 1>(a, n_rows, raw, rows); break;
    case 2: move_harmonic<kS, true, kM4, 2>(a, n_rows, raw, rows); break;
    default: move_harmonic<kS, true, kM4, 3>(a, n_rows, raw, rows); break;
  }
}

// The fixed geometry dispatches on (M % 4, frame 0's offset) to a body
// without selects; the generic one selects at run time.
template <int kS, bool kFixed>
__device__ __forceinline__ void deinterleave_harmonic(const Args& a, int n_rows, const float* raw,
                                                      float* rows) {
  if constexpr (kFixed) {
    switch (a.M % 4) {
      case 0: move_harmonic_m4<kS, 0>(a, n_rows, raw, rows); break;
      case 1: move_harmonic_m4<kS, 1>(a, n_rows, raw, rows); break;
      case 2: move_harmonic_m4<kS, 2>(a, n_rows, raw, rows); break;
      default: move_harmonic_m4<kS, 3>(a, n_rows, raw, rows); break;
    }
  } else {
    move_harmonic<kS, false, 0, 0>(a, n_rows, raw, rows);
  }
}

template <int kH>
__device__ __forceinline__ void deinterleave(const Args& a, int n_rows, const float* raw,
                                             float* rows) {
  constexpr bool kFixed = kH > 0;
  const int H = kH ? kH : a.n_harm;
  deinterleave_harmonic<1, kFixed>(a, n_rows, raw, rows);
  if (H > 1) deinterleave_harmonic<2, kFixed>(a, n_rows, raw, rows);
  if (H > 2) deinterleave_harmonic<3, kFixed>(a, n_rows, raw, rows);
  if (H > 3) deinterleave_harmonic<4, kFixed>(a, n_rows, raw, rows);
  if (H > 4) deinterleave_harmonic<5, kFixed>(a, n_rows, raw, rows);
  if (H > 5) deinterleave_harmonic<6, kFixed>(a, n_rows, raw, rows);
  static_assert(kMaxH == 6, "one deinterleave_harmonic call a harmonic");
}

// prod[r][j] of candidate i0 + r over harmonics 1..kS-1 and phases
// kRho..kS-1 of harmonic kS, then the rest: a run of 4 * nv words of phase
// kRho read as float4 and reused for every (r, m).
template <int kH, int kJ, int kS, int kRho>
__device__ __forceinline__ void taps(float (&prod)[kR][kJ], const float* row, const Layout& L) {
  constexpr int n = (kJ - kRho + kS - 1) / kS;  // taps j = kRho + kS * m, m < n
  constexpr int nv = (kR - 1 + n + 3) / 4;
  const float4* src =
      reinterpret_cast<const float4*>(row + L.off[kS - 1] + kRho * L.pitch[kS - 1]);
  float w[4 * nv];
#pragma unroll
  for (int v = 0; v < nv; ++v) {
    const float4 x = src[v];
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }
#pragma unroll
  for (int m = 0; m < n; ++m) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if constexpr (kS == 1) {
        prod[r][kRho + kS * m] = w[r + m];
      } else {
        prod[r][kRho + kS * m] *= w[r + m];
      }
    }
  }
  if constexpr (kRho + 1 < kS) {
    taps<kH, kJ, kS, kRho + 1>(prod, row, L);
  } else if constexpr (kS < kH) {
    taps<kH, kJ, kS + 1, 0>(prod, row, L);
  }
}

// The fixed geometry: every loop unrolled, taps at immediate offsets.
template <int kH, int kJ>
__device__ __forceinline__ void band_fixed(const float* row, const Layout& L, float (&acc)[kR]) {
  float prod[kR][kJ];
  taps<kH, kJ, 1, 0>(prod, row, L);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) sum += prod[r][j];
    acc[r] = sum;
  }
}

// Any geometry: j runs at run time; the run t = i0 + m .. i0 + m + 3 of
// (h, j) lies in the two float4 at i0 + (m & ~3).
__device__ __forceinline__ void band_any(const float* row, const Layout& L, int H, int J,
                                         float (&acc)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
  for (int j = 0; j < J; ++j) {
    float p[kR];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      if (h >= H) break;
      const int s = h + 1;
      const int m = j / s;
      const int a = m & 3;
      const float4* src = reinterpret_cast<const float4*>(
          row + L.off[h] + (j - m * s) * L.pitch[h] + (m - a));
      const float4 x = src[0];
      const float4 y = a ? src[1] : x;  // a is the same in every lane
      const float u[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      float v[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        v[r] = a == 0 ? u[r] : a == 1 ? u[r + 1] : a == 2 ? u[r + 2] : u[r + 3];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) p[r] = h == 0 ? v[r] : p[r] * v[r];
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] += p[r];
  }
}

// Group g's outputs, staged in outs [kRows, out_pitch], to device memory:
// n_rows * n_out contiguous floats.
__device__ __forceinline__ void store_group(const Args& a, int g, const float* outs) {
  const long long f0 = static_cast<long long>(g) * kRows;
  const int n_rows = static_cast<int>(min(static_cast<long long>(kRows), a.F - f0));
  float* dst = a.out + f0 * a.n_out;
  for (int r = 0; r < n_rows; ++r) {
    for (int i = threadIdx.x; i < a.n_out; i += kThreads) {
      dst[r * a.n_out + i] = outs[r * 4 * a.n_quads + i];
    }
  }
}

// kH = kJ = 0: the generic instantiation, H and J from the arguments.
// Persistent: block b takes groups b, b + gridDim.x, ...; the next group's
// copy and the previous group's stores are in flight while this one's
// products are formed.
template <int kH, int kJ>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) shc_band_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // [kRows, M]
  float* rows = raw + a.raw_words;               // [kRows, row_words]
  const int out_pitch = 4 * a.n_quads;
  float* outs = rows + kRows * a.lay.row_words;  // [2][kRows, out_pitch]
  const int out_words = kRows * out_pitch;
  const int n_groups = (a.F + kRows - 1) / kRows;
  if (static_cast<int>(blockIdx.x) < n_groups) fetch(a, blockIdx.x, raw);
  int last = -1;  // the previous group, whose outputs wait in outs[k ^ 1]
  for (int g = blockIdx.x, k = 0; g < n_groups; g += gridDim.x, k ^= 1) {
    const long long f0 = static_cast<long long>(g) * kRows;
    const int n_rows = static_cast<int>(min(static_cast<long long>(kRows), a.F - f0));
    wait_fetch();
    __syncthreads();  // raw holds group g; group g - 1's phases are read
    deinterleave<kH>(a, n_rows, raw, rows);
    __syncthreads();  // the phases hold group g; raw is read
    if (g + static_cast<int>(gridDim.x) < n_groups) fetch(a, g + gridDim.x, raw);
    if (last >= 0) store_group(a, last, outs + (k ^ 1) * out_words);

    float* out_k = outs + k * out_words;
    for (int o = threadIdx.x; o < n_rows * a.n_quads; o += kThreads) {
      const int r = o / a.n_quads;
      const int i0 = kR * (o - r * a.n_quads);
      const float* row = rows + r * a.lay.row_words + i0;
      float acc[kR];
      if constexpr (kJ > 0) {
        band_fixed<kH, kJ>(row, a.lay, acc);
      } else {
        band_any(row, a.lay, a.n_harm, a.win, acc);
      }
      st_shared(out_k + r * out_pitch + i0, acc[0], acc[1], acc[2], acc[3]);
    }
    last = g;
  }
  if (last >= 0) {
    __syncthreads();
    const int k = (last - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) % 2;
    store_group(a, last, outs + k * out_words);
  }
}

// The pitch (>= len, a multiple of 4) that spreads a warp's phase stores of
// harmonic s >= 3 over the most banks: lane l of warp w stores element
// e = 4 (32 w + l) + i in its i-th store, to phase e % s, word e / s.
// (s = 1, 2 store whole vectors.)
int phase_pitch(int s, int len) {
  if (s < 3) return len;
  int best = len, best_ways = 1 << 30;
  for (int p = len; p < len + 32; p += 4) {
    int ways = 0;  // summed over the stores and the warps' starting phases
    for (int w = 0; w < s; ++w) {
      for (int i = 0; i < 4; ++i) {
        int hits[32] = {0}, most = 0;
        for (int l = 0; l < 32; ++l) {
          const int e = 4 * (32 * w + l) + i;
          const int bank = ((e % s) * p + e / s) % 32;
          most = ++hits[bank] > most ? hits[bank] : most;
        }
        ways += most;
      }
    }
    if (ways < best_ways) best = p, best_ways = ways;
  }
  return best;
}

Layout make_layout(int n_quads, int H, int J) {
  Layout L{};
  int words = 0;
  for (int h = 0; h < H; ++h) {
    const int s = h + 1;
    const int n0 = (J + s - 1) / s;  // taps of phase 0
    // the last thread reads 4 * ceil((kR - 1 + n0) / 4) words from its i0
    L.len[h] = kR * (n_quads - 1) + 4 * ((kR - 1 + n0 + 3) / 4);
    L.pitch[h] = phase_pitch(s, L.len[h]);
    L.off[h] = words;
    words += (s - 1) * L.pitch[h] + L.len[h];
  }
  // frame r + 1's first vector follows frame r's last in bank order, so a
  // warp that straddles two frames reads without conflicts
  while ((words / 4 - n_quads) % 8 != 0) words += 4;
  L.row_words = words;
  return L;
}

// A geometry's launch configuration on a device.
struct Config {
  int dev, M, min_shc, n_out, n_harm, win;  // the key
  Layout lay;
  int raw_words;
  size_t smem;
  int blocks;  // blocks that fill the card
};

bool same_key(const Config& a, const Config& b) {
  return a.dev == b.dev && a.M == b.M && a.min_shc == b.min_shc && a.n_out == b.n_out &&
         a.n_harm == b.n_harm && a.win == b.win;
}

// The layout, shared memory and grid of c's key for shc_band_kernel<kH, kJ>.
template <int kH, int kJ>
int configure(Config& c) {
  const int n_quads = (c.n_out + kR - 1) / kR;
  c.lay = make_layout(n_quads, c.n_harm, c.win);
  // the deinterleave reads whole float4 up to each harmonic's last phase
  // word, past the last frame's end: room for them
  int past = 0;
  for (int h = 0; h < c.n_harm; ++h) {
    past = max(past, (c.min_shc + c.lay.len[h]) * (h + 1) - c.M);
  }
  c.raw_words = ((kRows - 1) * c.M + max(c.M, c.M + past) + 8 + 3) / 4 * 4;
  c.smem = sizeof(float) *
           (c.raw_words + kRows * (static_cast<size_t>(c.lay.row_words) + 2 * 4 * n_quads));
  if (c.smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (c.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(shc_band_kernel<kH, kJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(c.smem));
  }
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, c.dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shc_band_kernel<kH, kJ>,
                                                        kThreads, c.smem);
  }
  c.blocks = max(per_sm, 1) * sms;
  return static_cast<int>(err);
}

// The last call's configuration on each device, as a caller serves one
// geometry on each card (a serving mesh alternates its cards every batch):
// configuring every call (the pitch search, the shared-memory limit and
// the occupancy query) took 55-66 us of host time a call against 19-23 us
// (chip_smoke.py's kernel phase, H100 80GB HBM3), more than the kernel at
// 8000 frames. cudaFuncSetAttribute sets the limit of the current device
// only, so each device keeps its own entry. The mutex is held through the
// launch, so another thread cannot lower the kernel's shared-memory limit
// in between.
std::mutex last_mutex;
std::vector<Config> last;  // by device ordinal; dev -1: not configured yet

}  // namespace

// 1 when (n_harm, win) has its own unrolled instantiation, else 0 (the
// generic one runs).
extern "C" int satpu_shc_fixed(int n_harm, int win) { return n_harm == 4 && win == 21; }

// mag [F, M] and out [F, n_out]: contiguous f32 device buffers, 4-byte
// aligned. The caller guarantees (min_shc + n_out - 1) * n_harm + win - 1 < M
// and 1 <= n_harm <= 6. The buffers and `stream` belong to the current
// device, which the caller sets (it is configured and launched there).
// Launches on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a geometry out of range).
extern "C" int satpu_shc_band(const float* mag, float* out, int F, int M, int min_shc,
                              int n_out, int n_harm, int win, void* stream) {
  if (n_harm < 1 || n_harm > kMaxH || win < 1 || n_out < 1) return cudaErrorInvalidValue;
  if (F <= 0) return 0;
  Config c{0, M, min_shc, n_out, n_harm, win};
  const cudaError_t err = cudaGetDevice(&c.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool fixed = satpu_shc_fixed(n_harm, win);
  std::lock_guard<std::mutex> lock(last_mutex);
  if (static_cast<int>(last.size()) <= c.dev) last.resize(c.dev + 1, Config{-1});
  Config& mine = last[c.dev];
  if (!same_key(mine, c)) {
    const int e = fixed ? configure<4, 21>(c) : configure<0, 0>(c);
    if (e != 0) return e;
    mine = c;
  }
  const Args a{mag, out, F, M, min_shc, n_out, n_harm, win, (n_out + kR - 1) / kR,
               mine.raw_words, reinterpret_cast<uintptr_t>(mag) % 16 == 0, mine.lay};
  const int blocks = min(mine.blocks, (F + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fixed) {
    shc_band_kernel<4, 21><<<blocks, kThreads, mine.smem, st>>>(a);
  } else {
    shc_band_kernel<0, 0><<<blocks, kThreads, mine.smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The phase layout the kernel uses for a geometry, for models of its
// shared-memory traffic: words[3h], words[3h + 1], words[3h + 2] hold
// harmonic h's off, pitch and len (h < n_harm), words[3 n_harm] a staged
// frame's words. Returns cudaErrorInvalidValue for a geometry out of range.
extern "C" int satpu_shc_layout(int n_out, int n_harm, int win, int* words) {
  if (n_harm < 1 || n_harm > kMaxH || win < 1 || n_out < 1) return cudaErrorInvalidValue;
  const Layout L = make_layout((n_out + kR - 1) / kR, n_harm, win);
  for (int h = 0; h < n_harm; ++h) {
    words[3 * h] = L.off[h];
    words[3 * h + 1] = L.pitch[h];
    words[3 * h + 2] = L.len[h];
  }
  words[3 * n_harm] = L.row_words;
  return 0;
}
