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
// Bound: memory. Per frame the kernel reads M*4 = 4180 bytes and writes
// I*4 = 904 bytes against I*J*H = 18,984 flops (about 3.7 flops per byte),
// far below the ~20 flops per byte at which H100's f32 units (67 TFLOP/s)
// would become the limit at 3.35 TB/s. At F = 64,000 frames (B = 128
// utterances of 10 s) that is 325 MB, about 97 us at 3.35 TB/s.
//
// Design: the TPU kernel needed phase-deinterleaved copies of mag and
// one-hot matmuls because Mosaic has no strided lane slices. Here a block
// copies ROWS consecutive rows of mag into shared memory once (coalesced:
// the rows are contiguous in device memory), and its threads walk the
// strided harmonic taps in shared memory directly, each thread owning one or
// more (row, i) outputs and accumulating its sum in f32 registers. Device
// memory then sees each input byte read once and each output written once.
// Shared-memory reads of harmonic h are (h+1)-strided across a warp, so
// h = 1 and h = 3 take 2- and 4-way bank conflicts; cp.async/TMA staging and
// conflict-free layouts are left for a tuning pass.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;       // frames per block
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads)
shc_band_kernel(const float* __restrict__ mag, float* __restrict__ out, int F,
                int M, int min_shc, int n_out, int n_harm, int win) {
  extern __shared__ float rows_smem[];
  const long long f0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), F - f0));
  const float* src = mag + f0 * M;
  const int n_in = rows * M;
  for (int k = threadIdx.x; k < n_in; k += blockDim.x) rows_smem[k] = src[k];
  __syncthreads();

  const int n_total = rows * n_out;
  for (int o = threadIdx.x; o < n_total; o += blockDim.x) {
    const int r = o / n_out;
    const int i = o - r * n_out;
    const float* row = rows_smem + r * M;
    const int base = min_shc + i;
    float acc = 0.0f;
    for (int j = 0; j < win; ++j) {
      float term = row[base + j];
      for (int h = 1; h < n_harm; ++h) term *= row[base * (h + 1) + j];
      acc += term;
    }
    out[(f0 + r) * n_out + i] = acc;
  }
}

}  // namespace

// mag [F, M] and out [F, n_out]: contiguous f32 device buffers. The caller
// guarantees (min_shc + n_out - 1) * n_harm + win - 1 < M. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int satpu_shc_band(const float* mag, float* out, int F, int M,
                              int min_shc, int n_out, int n_harm, int win,
                              void* stream) {
  if (F <= 0) return 0;
  const size_t smem = static_cast<size_t>(kRows) * M * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        shc_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((F + kRows - 1) / kRows);
  shc_band_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, out, F, M, min_shc, n_out, n_harm, win);
  return static_cast<int>(cudaGetLastError());
}
