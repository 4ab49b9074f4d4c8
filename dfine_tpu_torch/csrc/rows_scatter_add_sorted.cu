// Deterministic row scatter-add over a payload sorted by destination: a
// segmented reduction.
//
//   out[r, j, :] = sum over n in [start[r, j], start[r, j + 1]) of payload[r, n, :]
//
// Replaces: dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add_tiled
// (:226-283, kernel body _kernel_tiled :203-223), the reproducible value
// gradient of the deformable-attention core. As there, the sort happens
// outside the kernel: the wrapper (ops/kernels/scatter_rows.py) sorts the
// destination keys with a stable sort (dropped entries keyed hw, past every
// row), gathers the bf16 payload in that order and finds each destination
// row's run with searchsorted. The TPU kernel then built a one-hot matrix per
// (row block, chunk) to sum each tile's span on the MXU; that detour is not
// carried over. Here one warp owns one destination row (r, j), its lanes run
// over D, and it sums that row's run in sorted order in f32 registers, then
// writes the row: every output row is written exactly once, so there is no
// zeroing pass and no atomic, not even in shared memory, and the summation
// order is fixed by the stable sort. Two runs give bit-equal output.
//
// Layouts: payload [R, N, D] bf16 (sorted per r); start [R, HW + 1] int32
// (start[r, HW] = number of kept entries of row r); out [R, HW, D] f32.
//
// Bound on the H100: memory. The kernel reads the payload once (2 bytes an
// element) and the run starts, and writes the output once (4 bytes an
// element). At D = 32 a warp's read of one sorted entry is one coalesced
// 64-byte row and its write one 128-byte row. The sort and gather around it
// move more bytes than the kernel does; the wrapper's time includes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__global__ void rows_scatter_add_sorted_kernel(const __nv_bfloat16* __restrict__ payload,
                                               const int* __restrict__ start,
                                               float* __restrict__ out, long long rows,
                                               int N, int HW, int D) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); w < rows;
       w += warps) {
    const long long r = w / HW;
    const int j = (int)(w % HW);
    const int* s = start + r * (HW + 1) + j;
    const int lo = __ldg(s), hi = __ldg(s + 1);
    const __nv_bfloat16* src = payload + r * (long long)N * D;
    float* dst = out + w * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f;
      for (int n = lo; n < hi; ++n) acc += __bfloat162float(src[(long long)n * D + d]);
      dst[d] = acc;
    }
  }
}

// Returns the cudaError_t of the launch (0 = success).
extern "C" int rows_scatter_add_sorted(const void* payload, const void* start, void* out,
                                       int R, int N, int HW, int D, void* stream) {
  const long long rows = (long long)R * HW;
  if (rows == 0 || D == 0) return (int)cudaSuccess;
  const int threads = 256;  // 8 warps, 8 destination rows a block
  long long blocks = (rows + 7) / 8;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride loop covers the rest
  rows_scatter_add_sorted_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)payload, (const int*)start, (float*)out, rows, N, HW, D);
  return (int)cudaGetLastError();
}
