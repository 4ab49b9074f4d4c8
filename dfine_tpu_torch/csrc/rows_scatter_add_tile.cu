// Batched row scatter-add into destination tiles held in shared memory:
//
//   out[r, j, :] = sum over n with idx[r, n] == j of contrib[r, n, :],  0 <= j < HW
//
// (entries with idx outside [0, HW) are dropped). Two C entry points:
//
//   rows_scatter_add       f32 payload, f32 sums in shared-memory atomics
//                          <- dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add
//                             (:64-97, pallas_call :85, kernel body _kernel :37-61)
//   rows_scatter_add_tiled bf16 payload, f32 sums in a fixed order: deterministic
//                          <- dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add_tiled
//                             (:226-283, pallas_call :277, kernel body _kernel_tiled :203-223)
//
// Both are the value gradient of the deformable-attention core. The Pallas
// kernels built a one-hot match matrix per (row, destination tile) and summed
// on the MXU, and the tiled one sorted the entries by destination beforehand;
// the matrix product, and the global sort with its payload gather, are not
// carried over. What is kept is the grid over (r, destination tile): the sum
// of a tile stays on chip until it is written once.
//
// Layouts: idx [R, N] int32; contrib [R, N, D] f32 (rows_scatter_add) or bf16
// (rows_scatter_add_tiled); out [R, HW, D] f32, written whole by the kernel
// (the caller allocates it uninitialized). D is 16 or 32; any other D is
// refused with cudaErrorInvalidValue.
//
// Bound on the H100: memory. Each payload byte is read once and each output
// byte written once; the adds are one per payload element. At m@640, B = 8 on
// the train path (R = 64, N = 6000 / 12000 / 6000, HW = 6400 / 1600 / 400,
// D = 32) one backward (3 calls) reads 196.6 MB of f32 payload (98.3 MB in
// bf16) and 6.1 MB of indices and writes 68.8 MB.
//
// Design. One CTA of 8 warps per (r, tile of T = 128 destination rows): at
// the train shapes 3200 / 832 / 256 CTAs, so even the smallest level gives
// every one of the 132 SMs work. The CTA walks all of row r's indices in
// windows of 6144 entries, in order; warp w takes entries [768 w, 768 (w + 1))
// of the window as 24 coalesced 128-byte loads a lane, all issued before any
// is used, keeps by ballot the entries whose destination falls in its tile and
// appends them, in increasing n, to its own list in shared memory. The
// indices are thus read ceil(HW / T) times, from L2 after the first.
//
// rows_scatter_add: the tile's f32 accumulator [T, D] lies in shared memory,
// zeroed in place. Each warp takes its list in batches: D lanes (one a
// column) load one payload row (128 bytes at D = 32), 16 rows a lane before
// the first add, then add them with shared-memory atomics, neighbouring lanes
// on neighbouring banks. After the last window the tile is written once with
// 16-byte stores. No zero pass over the output, no global atomic: the 49 M
// global f32 atomics a backward of the kernel this one replaces, whose output
// (52 MB at level 0) does not fit the 50 MB L2, are gone. The order of the
// shared-memory atomics still varies between warps, so the low bits of a sum
// vary from run to run. nvcc -Xptxas -v for sm_90a: 48 registers at D = 32
// (64 at D = 16), no spills, 40 KB of shared memory at D = 32 (32 KB at 16):
// 5 CTAs (40 warps) an SM. An f32 atomicAdd on shared memory is a
// compare-and-swap loop on the H100 (ATOMS.CAST.SPIN in the SASS), so
// destinations that many entries share make the warps of a CTA retry: the
// train step's sampling points cluster (up to about 500 entries on one
// level-0 pixel and 1000 on one level-1 pixel), and there the kernel takes
// 1.7 to 2 times its time on uniform destinations.
//
// rows_scatter_add_tiled: a stable counting sort of each window's kept
// entries by destination, in shared memory: (1) a histogram per (destination,
// warp), (2) its exclusive scan in (destination, warp) order, (3) each entry
// placed at its (destination, warp) offset plus its rank among the equal
// destinations of lower lanes (__match_any_sync and a popcount), the warps'
// lists being in increasing n and the warps in window order. (4) The payload
// rows of the sorted entries are copied into the lists' space, free by then,
// with independent 16-byte loads by all threads, as many rows at a time as the
// space holds (384 at D = 32); then one lane per (destination row, two
// columns) adds that row's part in order, in f32 registers that start at
// 0.0f, are carried from window to window, and are written once after the
// last window. Each output element is thus the sum of its entries in
// increasing n, which is also the order of the CPU's index_add_: the result
// is bit-equal from run to run and to the CPU's plain version. A run of one
// row as long as N costs its loads in parallel; only its adds are in series.
// No atomic touches the payload, so shared destinations cost nothing extra.
// nvcc -Xptxas -v for sm_90a: 64 registers, the launch bound of 4 CTAs an SM
// (with 36 bytes of spill stores at D = 32 and 8 at D = 16, which still beat
// 73 registers and 3 CTAs), 53.8 KB of shared memory: 4 CTAs (32 warps) an SM.
//
// The window, the batch and T were chosen by timing variants at the train
// shapes on the H100 (windows of 4096 and 8192 entries, batches of 8, T = 64
// and 256, loads of 16 bytes a lane in the first kernel, runs summed straight
// from device memory in the second): each was slower than the choice here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;                // destination rows a CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = 24;               // 32-entry chunks a warp takes per window
constexpr int kSpan = kChunks * 32;       // entries a warp takes per window
constexpr int kWindow = kWarps * kSpan;   // entries of row r a window covers
constexpr int kJBits = 8;                 // a list entry: (n - n0) << kJBits | (dst - t0)
constexpr int kJMask = (1 << kJBits) - 1;
constexpr int kBatch = 16;                // payload rows a lane loads before it adds them
constexpr int kSortedBlocks = 4;          // CTAs an SM for the sorted kernel (<= 64 registers)
static_assert(kTile <= (1 << kJBits), "a tile row must fit kJBits");
static_assert(kWindow < (1 << (31 - kJBits)), "a window offset must fit the rest");

// The walk shared by both kernels: warp `warp` reads its span of the window
// [n0, n0 + kWindow) of row r's indices and appends the entries with a
// destination in [t0, hi) to `list`, in increasing n. Returns the list's
// length, the same in every lane. Warp-private: no block barrier.
__device__ __forceinline__ int compact_span(const int* __restrict__ idx_row, int N, int n0,
                                            int t0, int hi, int warp, int lane,
                                            int* __restrict__ list) {
  const int off = warp * kSpan;
  int dst[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int n = n0 + off + c * 32 + lane;
    dst[c] = n < N ? __ldg(idx_row + n) : -1;
  }
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const bool keep = dst[c] >= t0 && dst[c] < hi;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) list[count + __popc(m & below)] = ((off + c * 32 + lane) << kJBits) | (dst[c] - t0);
    count += __popc(m);
  }
  return count;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rows_scatter_add_tile_kernel(const int* __restrict__ idx, const float* __restrict__ contrib,
                             float* __restrict__ out, int N, int HW, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);            // [kTile, D]
  int* lists = reinterpret_cast<int*>(acc + kTile * D);   // [kWarps, kSpan]
  constexpr int G = 32 / D;                               // row groups of D lanes a warp
  const int r = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * kTile;
  const int hi = min(t0 + kTile, HW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane / D, d = lane % D;
  int* list = lists + warp * kSpan;
  const int* idx_row = idx + (long long)r * N;
  const float* src = contrib + (long long)r * N * D + d;

  for (int i = threadIdx.x; i < kTile * D / 4; i += kThreads)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += kWindow) {
    const int count = compact_span(idx_row, N, n0, t0, hi, warp, lane, list);
    __syncwarp();
    for (int e0 = 0; e0 < count; e0 += G * kBatch) {
      float v[kBatch];
      int j[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + g + G * u;
        j[u] = -1;
        v[u] = 0.f;
        if (e < count) {
          const int p = list[e];
          j[u] = p & kJMask;
          v[u] = __ldg(src + (long long)(n0 + (p >> kJBits)) * D);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j[u] >= 0) atomicAdd(acc + j[u] * D + d, v[u]);
    }
    __syncwarp();  // the list is refilled by the next window
  }
  __syncthreads();

  float4* dst = reinterpret_cast<float4*>(out + ((long long)r * HW + t0) * D);
  for (int i = threadIdx.x; i < (hi - t0) * D / 4; i += kThreads)
    dst[i] = reinterpret_cast<const float4*>(acc)[i];
}

template <int D>
__global__ void __launch_bounds__(kThreads, kSortedBlocks)
rows_scatter_add_tile_sorted_kernel(const int* __restrict__ idx,
                                    const __nv_bfloat16* __restrict__ contrib,
                                    float* __restrict__ out, int N, int HW, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lists = reinterpret_cast<int*>(smem);  // [kWarps, kSpan] kept entries, in n
  int* offset = lists + kWarps * kSpan;       // [kTile, kWarps] counts, then offsets
  int* run = offset + kTile * kWarps;         // [kTile + 1] where each row's run starts
  int* sorted = run + kTile + 1;              // [kWindow] window offsets n - n0, by (row, n)
  __shared__ int warp_sums[kWarps];
  constexpr int L = D / 2;                    // lanes a row, two columns a lane
  constexpr int G = 32 / L;                   // row groups a warp
  constexpr int K = kTile / (kWarps * G);     // rows a lane sums
  constexpr int kItems = kTile * kWarps / kThreads;  // scan items a thread
  static_assert(kItems * kThreads == kTile * kWarps && kWarps % kItems == 0, "scan layout");
  const int r = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * kTile;
  const int hi = min(t0 + kTile, HW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane / L, c = lane % L;
  const unsigned below = (1u << lane) - 1u;
  int* list = lists + warp * kSpan;
  const int* idx_row = idx + (long long)r * N;
  constexpr int P = D * 2 / 16;                         // 16-byte pieces a payload row
  constexpr int kStage = kWarps * kSpan * 4 / (D * 2);  // payload rows the lists' space holds
  const uint4* src = reinterpret_cast<const uint4*>(contrib + (long long)r * N * D);
  uint4* stage = reinterpret_cast<uint4*>(lists);
  const __nv_bfloat162* staged = reinterpret_cast<const __nv_bfloat162*>(lists);
  const int first = warp * G + g;             // this lane's rows: first + k * kWarps * G

  float2 acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = make_float2(0.f, 0.f);

  for (int n0 = 0; n0 < N; n0 += kWindow) {
    const int count = compact_span(idx_row, N, n0, t0, hi, warp, lane, list);
    for (int i = threadIdx.x; i < kTile * kWarps; i += kThreads) offset[i] = 0;
    __syncthreads();

    // (1) histogram of the destinations, per warp
    for (int e = lane; e < count; e += 32) atomicAdd(offset + (list[e] & kJMask) * kWarps + warp, 1);
    __syncthreads();

    // (2) exclusive scan in (destination, warp) order; run[j] = start of row j
    int v[kItems], sum = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) sum += (v[i] = offset[threadIdx.x * kItems + i]);
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int excl = incl - sum;
    for (int w = 0; w < warp; ++w) excl += warp_sums[w];
    if (threadIdx.x * kItems % kWarps == 0) run[threadIdx.x * kItems / kWarps] = excl;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      offset[threadIdx.x * kItems + i] = excl;
      excl += v[i];
    }
    if (threadIdx.x == kThreads - 1) run[kTile] = excl;
    __syncthreads();

    // (3) stable placement: equal destinations keep increasing n
    for (int e0 = 0; e0 < count; e0 += 32) {
      const int e = e0 + lane;
      const int p = e < count ? list[e] : 0;
      const int j = e < count ? (p & kJMask) : kTile + lane;  // idle lanes: keys of their own
      const unsigned peers = __match_any_sync(0xffffffffu, j);
      const int rank = __popc(peers & below);
      if (e < count) sorted[offset[j * kWarps + warp] + rank] = p >> kJBits;
      __syncwarp();
      if (e < count && rank == 0) offset[j * kWarps + warp] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();

    // (4) the payload rows of the window's entries, in sorted order, into the
    // lists' space (free now), kStage entries at a time, 16 bytes a thread and
    // all loads independent; then each lane adds its rows' part of them in order
    const int total = run[kTile];
    for (int s0 = 0; s0 < total; s0 += kStage) {
      const int count_s = min(kStage, total - s0);
#pragma unroll 4
      for (int i = threadIdx.x; i < count_s * P; i += kThreads)
        stage[i] = __ldg(src + (long long)(n0 + sorted[s0 + i / P]) * P + i % P);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = first + k * kWarps * G;
        const int b = min(run[j + 1], s0 + count_s) - s0;
#pragma unroll 4
        for (int e = max(run[j], s0) - s0; e < b; ++e) {
          const float2 f = __bfloat1622float2(staged[e * L + c]);
          acc[k].x += f.x;
          acc[k].y += f.y;
        }
      }
      __syncthreads();
    }
    __syncthreads();  // lists, offsets, runs and the order are refilled by the next window
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = first + k * kWarps * G;
    if (t0 + j < hi) reinterpret_cast<float2*>(out + ((long long)r * HW + t0 + j) * D)[c] = acc[k];
  }
}

template <int D>
size_t tile_smem() { return (size_t)kTile * D * sizeof(float) + kWarps * kSpan * sizeof(int); }

size_t sorted_smem() {
  return (kWarps * kSpan + kTile * kWarps + kTile + 1 + kWindow) * sizeof(int);
}

// Above 48 KB a kernel must be allowed its dynamic shared memory first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Checks the sizes and returns the grid (0: nothing to do, -1: refused).
long long grid_of(int R, int N, int HW, int D) {
  if (D != 16 && D != 32) return -1;
  if (R < 0 || N < 0 || HW < 0) return -1;
  const long long blocks = (long long)R * ((HW + kTile - 1) / kTile);
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

}  // namespace

// Each returns the cudaError_t of the launch (0 = success).
extern "C" int rows_scatter_add(const void* idx, const void* contrib, void* out, int R, int N,
                                int HW, int D, void* stream) {
  const long long blocks = grid_of(R, N, HW, D);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const int tiles = (HW + kTile - 1) / kTile;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto kernel = D == 32 ? rows_scatter_add_tile_kernel<32> : rows_scatter_add_tile_kernel<16>;
  const size_t smem = D == 32 ? tile_smem<32>() : tile_smem<16>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>((const int*)idx, (const float*)contrib,
                                                  (float*)out, N, HW, tiles);
  return (int)cudaGetLastError();
}

extern "C" int rows_scatter_add_tiled(const void* idx, const void* contrib, void* out, int R,
                                      int N, int HW, int D, void* stream) {
  const long long blocks = grid_of(R, N, HW, D);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const int tiles = (HW + kTile - 1) / kTile;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto kernel =
      D == 32 ? rows_scatter_add_tile_sorted_kernel<32> : rows_scatter_add_tile_sorted_kernel<16>;
  const cudaError_t err = allow_smem(kernel, sorted_smem());
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, sorted_smem(), s>>>(
      (const int*)idx, (const __nv_bfloat16*)contrib, (float*)out, N, HW, tiles);
  return (int)cudaGetLastError();
}
