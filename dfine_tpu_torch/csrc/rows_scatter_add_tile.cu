// Batched row scatter-add into destination tiles held in shared memory:
//
//   out[r, j, :] = sum over n with idx[r, n] == j of contrib[r, n, :],  0 <= j < HW
//
// (entries with idx outside [0, HW) are dropped). Three C entry points:
//
//   rows_scatter_add       f32 payload, f32 sums in shared-memory atomics
//                          <- dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add
//                             (:64-97, pallas_call :85, kernel body _kernel :37-61)
//   rows_scatter_add_mxu   bf16 payload, f32 sums of one-hot products on the
//                          tensor cores (mma.sync), no atomics
//                          <- dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add_mxu
//                             (:137-185, pallas_call :173, kernel body _kernel_mxu :116-134)
//   rows_scatter_add_tiled bf16 payload, f32 sums in a fixed order: deterministic
//                          <- dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add_tiled
//                             (:226-283, pallas_call :277, kernel body _kernel_tiled :203-223)
//
// All three are the value gradient of the deformable-attention core. The
// Pallas kernels built a one-hot match matrix of every entry of the row
// against every destination of a tile and summed on the MXU, and the tiled
// one sorted the entries by destination beforehand. What is kept is the grid
// over (r, destination tile): the sum of a tile stays on chip until it is
// written once; and, in rows_scatter_add_mxu, the one-hot product itself,
// restricted to the entries that fall in the tile.
//
// Layouts: idx [R, N] int32; contrib [R, N, D] f32 (rows_scatter_add) or bf16
// (rows_scatter_add_mxu, rows_scatter_add_tiled; 16-byte aligned); out
// [R, HW, D] f32, written whole by the kernel (the caller allocates it
// uninitialized). D is 16, 32 or 64; any other D is refused with
// cudaErrorInvalidValue.
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
// D = 64 (the widened decoder layers past eval_idx, layer_scale = 2 at
// s/m/l/x): rows_scatter_add's lanes take two columns each, d and d + 32, so
// that a payload row is still two coalesced 128-byte loads and neighbouring
// lanes still add on neighbouring banks; its tile is 32 KB and, with the
// lists, 56 KB of shared memory, above the 48 KB a launch gets unasked
// (allow_smem). The sorted kernel keeps one row's 32 lanes of two columns
// and sums 16 rows a lane, with a launch bound of 3 CTAs an SM (85
// registers) for its 32 f32 sums. The mma kernel's warps hold 8 m16n8
// fragments (twice the 32 floats of D = 32, and as many again for a chunk's
// partial sums), with a launch bound of 2 CTAs an SM (128 registers); its
// staged rows are 144 bytes, and its output staging (34 KB) takes the lists'
// and the stages' space, free after the last window. chip_smoke.py prints
// the registers and spills of every instance.
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
//
// rows_scatter_add_mxu: the TPU kernel's one-hot product on the tensor cores,
// over the tile's kept entries only (the walk above), with no atomic at all.
// It replaces a kernel of one global f32 atomic a payload element (49 M a
// backward into L2, behind a zero pass over the 68.8 MB output), and avoids
// the compare-and-swap spin of shared f32 atomics on clustered destinations:
// a hot pixel only lengthens its warp's list. The kept entries of a window
// (the 8 warps' lists, taken in warp order) are staged kMmaStage = 128 at a
// time, in two buffers so that one chunk is copied while the one before it
// is summed: every thread copies payload rows with cp.async 16-byte copies
// into rows padded to D * 2 + 16 bytes (which keeps ldmatrix free of bank
// conflicts), and each entry's local destination into a byte array. Warp w
// owns the tile's rows [16 w, 16 w + 16), all D columns, as D / 8 m16n8 f32
// fragments in registers. From a chunk it takes only the entries that fall
// in its rows (a ballot over the destination bytes, compacted in order into
// a list of its own), 16 to a k-block: it builds the A fragment (16 rows x
// 16 entries) in registers, bf16 1.0 where the entry's destination is the
// fragment's row and 0 elsewhere; it loads B (16 entries x 16 columns a
// time) with ldmatrix.trans, each lane giving the staged row of its entry
// (past the warp's last entry a zero row), so that the gather costs no copy;
// and issues mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32. Each warp picks
// its own entries, and does not run over every k-block of the chunk: at
// uniform destinations nearly every block holds an entry of each warp, so a
// vote that skips empty blocks would leave 7 of 8 products of zeros. The
// chunk size and the two buffers were chosen by timing
// variants (64 to 256 entries, 2 to 4 buffers): none was clearly faster,
// and the larger ones cost occupancy. A chunk's
// products are summed in the tensor cores from zero and then added to the
// tile's accumulator with IEEE f32 adds, so that no tensor-core sum runs over
// more than one chunk. The products with the one-hot are exact; the sums are
// f32 in another order than the CPU's, the same from run to run (no
// atomics). After the last window each warp writes its 16 rows, zero rows
// too, through shared memory with 16-byte stores. A non-finite payload
// element spreads (0 x inf) to the 16 rows of its warp, as it did across a
// tile on the TPU. mma.sync and not wgmma: a warp's 16-row slice and
// 16-entry k-blocks are far smaller than wgmma's 64-row warpgroup tiles; a
// 64-row sub-tile a warpgroup is left to try. nvcc -Xptxas -v for sm_90a:
// 64 registers, the launch bound of 4 CTAs an SM (28 bytes of spill stores
// at D = 32, none at 16); 47,440 bytes of shared memory at D = 32 (39,216 at
// 16): 4 CTAs (32 warps) an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
constexpr int kSortedBlocksWide = 3;      // the same at D = 64 (<= 85 registers)
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
  constexpr int CL = D > 32 ? D / 32 : 1;                 // columns a lane: d + 32 k
  constexpr int LW = D / CL;                              // lanes a payload row
  constexpr int G = 32 / LW;                              // row groups a warp
  const int r = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * kTile;
  const int hi = min(t0 + kTile, HW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane / LW, d = lane % LW;
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
      float v[kBatch][CL];
      int j[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + g + G * u;
        j[u] = -1;
#pragma unroll
        for (int k = 0; k < CL; ++k) v[u][k] = 0.f;
        if (e < count) {
          const int p = list[e];
          j[u] = p & kJMask;
#pragma unroll
          for (int k = 0; k < CL; ++k)
            v[u][k] = __ldg(src + (long long)(n0 + (p >> kJBits)) * D + 32 * k);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j[u] >= 0) {
#pragma unroll
          for (int k = 0; k < CL; ++k) atomicAdd(acc + j[u] * D + d + 32 * k, v[u][k]);
        }
    }
    __syncwarp();  // the list is refilled by the next window
  }
  __syncthreads();

  float4* dst = reinterpret_cast<float4*>(out + ((long long)r * HW + t0) * D);
  for (int i = threadIdx.x; i < (hi - t0) * D / 4; i += kThreads)
    dst[i] = reinterpret_cast<const float4*>(acc)[i];
}

template <int D>
__global__ void __launch_bounds__(kThreads, D > 32 ? kSortedBlocksWide : kSortedBlocks)
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
    for (int e = lane; e < count; e += 32)
      atomicAdd(offset + (list[e] & kJMask) * kWarps + warp, 1);
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

constexpr int kMmaStage = 128;  // entries a staging buffer of the mma kernel holds
constexpr int kMmaBufs = 2;     // its staging buffers: kMmaBufs - 1 chunks in flight
constexpr int kMmaBlocks = 4;   // CTAs an SM for the mma kernel (<= 64 registers)
constexpr int kMmaBlocksWide = 2;  // the same at D = 64 (<= 128 registers)
static_assert(kMmaStage % 32 == 0 && kMmaStage <= 256, "a chunk entry must fit a byte");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&b)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += A (16 x 16 bf16, a) * B (16 x 8 bf16, b0 b1), f32 c
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two one-hot A elements as bf16 (1.0 = 0x3f80): low half where row `lo` is
// `row`, high half where row `hi` is
__device__ __forceinline__ unsigned onehot2(unsigned lo, unsigned hi, unsigned row) {
  return (lo == row ? 0x3f80u : 0u) | (hi == row ? 0x3f800000u : 0u);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D > 32 ? kMmaBlocksWide : kMmaBlocks)
rows_scatter_add_mma_kernel(const int* __restrict__ idx, const __nv_bfloat16* __restrict__ contrib,
                            float* __restrict__ out, int N, int HW, int tiles) {
  constexpr int RS = D * 2 + 16;  // bytes a staged row (the pad spreads ldmatrix's rows on banks)
  constexpr int PC = D * 2 / 16;  // 16-byte pieces a payload row
  constexpr int NF = D / 8;       // m16n8 fragments of a warp's 16 rows
  constexpr int OS = D + 4;       // floats a row of the output staging
  static_assert(kWarps * 16 == kTile, "a warp owns 16 rows of the tile");
  static_assert(kWarps * 16 * OS * 4 <= kWarps * kSpan * 4 + kMmaBufs * kMmaStage * RS,
                "the output staging fits the lists and the stages");
  extern __shared__ __align__(16) unsigned char smem[];
  int* lists = reinterpret_cast<int*>(smem);                    // [kWarps, kSpan]
  unsigned char* stage = smem + kWarps * kSpan * sizeof(int);   // [kMmaBufs][kMmaStage][RS]
  unsigned char* zero_row = stage + kMmaBufs * kMmaStage * RS;  // [RS] zeros
  unsigned char* dsts = zero_row + RS;                          // [kMmaBufs][kMmaStage] local rows
  unsigned short* mine =                                        // [kWarps][kMmaStage]
      reinterpret_cast<unsigned short*>(dsts + kMmaBufs * kMmaStage);
  __shared__ int counts[kWarps];
  const int r = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * kTile;
  const int hi = min(t0 + kTile, HW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const unsigned below = (1u << lane) - 1u;
  int* list = lists + warp * kSpan;
  unsigned short* mine_w = mine + warp * kMmaStage;
  const int* idx_row = idx + (long long)r * N;
  const __nv_bfloat16* src = contrib + (long long)r * N * D;
  if (threadIdx.x < RS / 16)
    reinterpret_cast<uint4*>(zero_row)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kWindow) {
    const int count = compact_span(idx_row, N, n0, t0, hi, warp, lane, list);
    if (lane == 0) counts[warp] = count;
    __syncthreads();
    int off[kWarps + 1];  // where each warp's list starts among the window's kept entries
    off[0] = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) off[w + 1] = off[w] + counts[w];
    const int total = off[kWarps];
    const int chunks = (total + kMmaStage - 1) / kMmaStage;

    // entries [c kMmaStage, ...) of the window (the warps' lists in warp order)
    // into buffer c % kMmaBufs: payload rows by cp.async, local rows as bytes;
    // one cp.async group a call, empty past the last chunk
    auto stage_chunk = [&](int c) {
      if (c < chunks) {
        const int e0 = c * kMmaStage, cnt = min(kMmaStage, total - e0);
        unsigned char* buf = stage + (c % kMmaBufs) * kMmaStage * RS;
        unsigned char* dbuf = dsts + (c % kMmaBufs) * kMmaStage;
        for (int i = threadIdx.x; i < cnt * PC; i += kThreads) {
          const int e = i / PC, pc = i % PC, es = e0 + e;
          int w = 0, base = 0;
#pragma unroll
          for (int k = 1; k < kWarps; ++k)
            if (es >= off[k]) w = k, base = off[k];
          const int p = lists[w * kSpan + es - base];
          cp_async16(buf + e * RS + pc * 16, src + (long long)(n0 + (p >> kJBits)) * D + pc * 8);
          if (pc == 0) dbuf[e] = (unsigned char)(p & kJMask);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    for (int c = 0; c < kMmaBufs - 1; ++c) stage_chunk(c);
    for (int c = 0; c < chunks; ++c) {
      stage_chunk(c + kMmaBufs - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmaBufs - 1) : "memory");  // chunk c landed
      __syncthreads();
      const int cnt = min(kMmaStage, total - c * kMmaStage);
      const unsigned char* buf = stage + (c % kMmaBufs) * kMmaStage * RS;
      const unsigned char* dbuf = dsts + (c % kMmaBufs) * kMmaStage;

      // this warp's entries of the chunk, in order: (row in the warp's 16) << 8 | entry
      int nm = 0;
#pragma unroll
      for (int k = 0; k < kMmaStage / 32; ++k) {
        const int e = k * 32 + lane;
        const unsigned dj = e < cnt ? dbuf[e] : 0xffu;
        const bool hit = (dj >> 4) == (unsigned)warp;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) mine_w[nm + __popc(m & below)] = (unsigned short)((dj & 15u) << 8 | e);
        nm += __popc(m);
      }
      __syncwarp();

      // one-hot products, 16 of this warp's entries a k-block: A (16 rows x
      // 16 entries) from the entries' rows, B (16 entries x 16 columns a
      // ldmatrix) gathered from their staged rows; past the last entry, a
      // zero row and no row
      float part[NF][4];
#pragma unroll
      for (int j = 0; j < NF; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
      for (int kb = 0; kb < nm; kb += 16) {
        const unsigned short* blk = mine_w + kb;
        const int left = nm - kb;
        const unsigned r0 = 2 * tq < left ? blk[2 * tq] >> 8 : 0xffu;
        const unsigned r1 = 2 * tq + 1 < left ? blk[2 * tq + 1] >> 8 : 0xffu;
        const unsigned r8 = 2 * tq + 8 < left ? blk[2 * tq + 8] >> 8 : 0xffu;
        const unsigned r9 = 2 * tq + 9 < left ? blk[2 * tq + 9] >> 8 : 0xffu;
        const unsigned a[4] = {onehot2(r0, r1, g), onehot2(r0, r1, g + 8), onehot2(r8, r9, g),
                               onehot2(r8, r9, g + 8)};
        const int kk = (lane >> 3 & 1) * 8 + (lane & 7);  // the entry whose row this lane addresses
        const unsigned char* row =
            (kk < left ? buf + (blk[kk] & 0xffu) * RS : zero_row) + (lane >> 4) * 16;
#pragma unroll
        for (int j = 0; j < NF / 2; ++j) {  // 16 columns a time
          unsigned b[4];
          ldmatrix_x4_trans(b, row + j * 32);
          mma_bf16(part[2 * j], a, b[0], b[1]);
          mma_bf16(part[2 * j + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] += part[j][k];
      __syncthreads();  // buffer c % kMmaBufs and the warps' entry lists are refilled
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // the empty groups
    __syncthreads();  // counts and lists are refilled by the next window
  }

  // the warp's 16 rows through shared memory (the lists and the stages, free
  // now), then 16-byte stores
  float* rows = reinterpret_cast<float*>(smem) + warp * 16 * OS;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    *reinterpret_cast<float2*>(rows + g * OS + j * 8 + 2 * tq) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(rows + (g + 8) * OS + j * 8 + 2 * tq) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  const int first = t0 + warp * 16;
  float4* dst = reinterpret_cast<float4*>(out + ((long long)r * HW + first) * D);
#pragma unroll
  for (int i = lane; i < 16 * D / 4; i += 32) {
    const int row = i / (D / 4), c4 = i % (D / 4);
    if (first + row < hi) dst[i] = *reinterpret_cast<const float4*>(rows + row * OS + c4 * 4);
  }
}

template <int D>
size_t tile_smem() { return (size_t)kTile * D * sizeof(float) + kWarps * kSpan * sizeof(int); }

template <int D>
size_t mma_smem() {
  return kWarps * kSpan * sizeof(int) + kMmaBufs * kMmaStage * (D * 2 + 16 + 1) + (D * 2 + 16) +
         kWarps * kMmaStage * sizeof(unsigned short);
}

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
  if (D != 16 && D != 32 && D != 64) return -1;
  if (R < 0 || N < 0 || HW < 0) return -1;
  const long long blocks = (long long)R * ((HW + kTile - 1) / kTile);
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// f(std::integral_constant<int, D>) for the compiled widths
template <typename F>
cudaError_t by_width(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename Payload, typename Kernel>
cudaError_t run(Kernel kernel, size_t smem, long long blocks, const void* idx,
                const void* contrib, void* out, int N, int HW, cudaStream_t s) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>((const int*)idx, (const Payload*)contrib,
                                                  (float*)out, N, HW, (HW + kTile - 1) / kTile);
  return cudaGetLastError();
}

}  // namespace

// Each returns the cudaError_t of the launch (0 = success).
extern "C" int rows_scatter_add(const void* idx, const void* contrib, void* out, int R, int N,
                                int HW, int D, void* stream) {
  const long long blocks = grid_of(R, N, HW, D);
  if (blocks <= 0) return blocks < 0 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
  return (int)by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return run<float>(
        rows_scatter_add_tile_kernel<W>, tile_smem<W>(), blocks, idx, contrib, out, N, HW,
        (cudaStream_t)stream);
  });
}

extern "C" int rows_scatter_add_mxu(const void* idx, const void* contrib, void* out, int R, int N,
                                    int HW, int D, void* stream) {
  const long long blocks = grid_of(R, N, HW, D);
  if (blocks < 0 || ((size_t)contrib & 15)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  return (int)by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return run<__nv_bfloat16>(
        rows_scatter_add_mma_kernel<W>, mma_smem<W>(), blocks, idx, contrib, out, N, HW,
        (cudaStream_t)stream);
  });
}

extern "C" int rows_scatter_add_tiled(const void* idx, const void* contrib, void* out, int R,
                                      int N, int HW, int D, void* stream) {
  const long long blocks = grid_of(R, N, HW, D);
  if (blocks <= 0) return blocks < 0 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
  return (int)by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return run<__nv_bfloat16>(
        rows_scatter_add_tile_sorted_kernel<W>, sorted_smem(), blocks, idx, contrib, out, N, HW,
        (cudaStream_t)stream);
  });
}
