// Batched row scatter-add with a bf16 payload and global f32 atomics:
// out[r, idx[r, n], :] += contrib[r, n, :].
//
// Replaces: dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add_mxu
// (:137-185, kernel body _kernel_mxu :116-134), a value gradient of the
// deformable-attention core. The Pallas kernel turned the scatter into a
// one-hot matrix product because the TPU serializes duplicate-index scatters;
// that O(HW x N) work and its VMEM chunk sizing are TPU workarounds and are
// not carried over. Kept: each contribution rounded once to bf16 (by the
// caller), f32 accumulation, and the dropping of idx < 0 (indices at or past
// hw are dropped too, so no write can leave the output). The f32 payload and
// the deterministic form are in rows_scatter_add_tile.cu.
//
// Layouts: idx [R, N] int32; contrib [R, N, D] bf16; out [R, HW, D] f32,
// zeroed by the caller.
//
// Bound on the H100: memory. At m@640, B=8 on the train path (R = 64,
// N = 500*P_l*4 = 6000 / 12000 / 6000, HW = 6400 / 1600 / 400, D = 32), the
// three calls of one backward read 24 M payload elements (49 MB in bf16) and
// write 69 MB of output. The adds (one per payload element) are nothing for
// the card. Design: one thread per payload element, so a warp covers one
// (r, n) row at D = 32: the payload read is one coalesced 64-byte
// transaction, the index a broadcast, and the 32 fire-and-forget float
// atomics (RED) land on one 128-byte output row, which L2 merges. Duplicate
// destinations, the reason for the TPU's detour, cost only contention in L2.
// Atomics make the summation order, and so the low bits, vary from run to
// run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__global__ void rows_scatter_add_bf16_kernel(const int* __restrict__ idx,
                                             const __nv_bfloat16* __restrict__ contrib,
                                             float* __restrict__ out, long long total, int N,
                                             int HW, int D) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long rn = t / D;
    const int dst = __ldg(idx + rn);
    if (dst < 0 || dst >= HW) continue;
    const long long r = rn / N;
    atomicAdd(out + (r * HW + dst) * D + (t % D), __bfloat162float(contrib[t]));
  }
}

// Returns the cudaError_t of the launch (0 = success).
extern "C" int rows_scatter_add_bf16(const void* idx, const void* contrib, void* out, int R,
                                     int N, int HW, int D, void* stream) {
  const long long total = (long long)R * N * D;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride loop covers the rest
  rows_scatter_add_bf16_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const __nv_bfloat16*)contrib, (float*)out, total, N, HW, D);
  return (int)cudaGetLastError();
}
