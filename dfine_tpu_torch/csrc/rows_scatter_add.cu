// Batched row scatter-add: out[r, idx[r, n], :] += contrib[r, n, :], in two
// payload types: f32 (rows_scatter_add) and bf16 (rows_scatter_add_bf16).
//
// Replaces:
//   rows_scatter_add      <- dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add
//                            (:64-97, kernel body _kernel :37-61)
//   rows_scatter_add_bf16 <- dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add_mxu
//                            (:137-185, kernel body _kernel_mxu :116-134)
// Both are the value gradient of the deformable-attention core. The Pallas
// kernels turned the scatter into a one-hot matrix product because the TPU
// serializes duplicate-index scatters; that O(HW x N) work, and the _mxu
// variant's VMEM chunk sizing, are TPU workarounds and are not carried over.
// Kept: the payload type (f32 as given, or each contribution rounded once to
// bf16 by the caller), f32 accumulation, and the dropping of idx < 0 (indices
// at or past hw are dropped too, so no write can leave the output).
//
// Layouts: idx [R, N] int32; contrib [R, N, D] f32 or bf16; out [R, HW, D]
// f32, zeroed by the caller.
//
// Bound on the H100: memory. At m@640, B=8 on the train path (R = 64,
// N = 500*P_l*4 = 6000 / 12000 / 6000, HW = 6400 / 1600 / 400, D = 32), the
// three calls of one backward read 24 M payload elements (98 MB in f32, 49 MB
// in bf16) and write 69 MB of output. The adds (one per payload element) are
// nothing for the card. Design: one thread per payload element, so a warp
// covers one (r, n) row at D = 32: the payload read is one coalesced 128-byte
// (f32) or 64-byte (bf16) transaction, the index a broadcast, and the 32
// fire-and-forget float atomics (RED) land on one 128-byte output row, which
// L2 merges. Duplicate destinations, the reason for the TPU's detour, cost
// only contention in L2. Atomics make the summation order, and so the low
// bits, vary from run to run (the sorted kernel in rows_scatter_add_sorted.cu
// is the deterministic form).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float load_payload(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_payload(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void rows_scatter_add_kernel(const int* __restrict__ idx,
                                        const T* __restrict__ contrib,
                                        float* __restrict__ out, long long total, int N,
                                        int HW, int D) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long rn = t / D;
    const int dst = __ldg(idx + rn);
    if (dst < 0 || dst >= HW) continue;
    const long long r = rn / N;
    atomicAdd(out + (r * HW + dst) * D + (t % D), load_payload(contrib + t));
  }
}

template <typename T>
static int launch(const void* idx, const void* contrib, void* out, int R, int N, int HW,
                  int D, void* stream) {
  const long long total = (long long)R * N * D;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride loop covers the rest
  rows_scatter_add_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const T*)contrib, (float*)out, total, N, HW, D);
  return (int)cudaGetLastError();
}

// Each returns the cudaError_t of the launch (0 = success).
extern "C" int rows_scatter_add(const void* idx, const void* contrib, void* out, int R,
                                int N, int HW, int D, void* stream) {
  return launch<float>(idx, contrib, out, R, N, HW, D, stream);
}

extern "C" int rows_scatter_add_bf16(const void* idx, const void* contrib, void* out, int R,
                                     int N, int HW, int D, void* stream) {
  return launch<__nv_bfloat16>(idx, contrib, out, R, N, HW, D, stream);
}
