// Exact min-cost assignment of a batch of small rectangular problems:
//
//   col4row[p, :] = argmin over injective maps rows -> columns of
//                   sum over valid rows i of cost[p, i, col4row[p, i]]
//
// <- dfine_tpu/ops/hungarian.py::_solve_one (:48-145), vmapped over the
//    problems by ::hungarian (:148-165). XLA, no Pallas counterpart: the
//    JAX train step solves every (output set, image) assignment on the
//    device with it (dfine_tpu/matcher.py:163-184).
//
// The algorithm is the JAX solver's, step for step (Jonker-Volgenant with
// dual potentials and a row-reduction start), and every float operation is
// its f32 add or subtract in its order, so the assignment is the same,
// element for element, as the JAX solver's and the plain version's
// (dfine_tpu_torch/ops/hungarian.py):
//
//   row reduction: u[i] = min_j cost[i, j] on valid rows (0 elsewhere),
//     v = 0; column j goes to the valid row with the smallest index whose
//     first argmin it is; the other valid rows are pending, in index order;
//   for each pending row cur, a shortest augmenting path: from row i,
//     rc = ((minval + cost[i]) - u[i]) - v over the columns not done,
//     shortest and pred lowered where rc is smaller, then the first argmin
//     of shortest over the columns not done (done ones read as 1e30): the
//     column is done; a free column ends the path, an assigned one moves
//     the path to its row;
//   then u += minval - shortest[col4row] on the scanned rows (minval on
//     cur), v -= minval - shortest on the done columns, and the path is
//     flipped along pred.
//
// Pad rows take no part in any of it, so the kernel solves each problem's
// valid rows compacted in index order ("slots"): a relabelling that keeps
// every tie rule (the claim's smallest row is the smallest slot).
//
// Layouts: cost [P, G, Q] f32 (row-major), row_valid [V, G] uint8 (a torch
// bool) or null (every row valid), problem p reading row p % V (a [B, G]
// mask broadcast over the leading sets of a [S, B, G, Q] stack needs no
// copy), out [P, G] int32, -1 on rows that are not valid; G <= Q <= kMaxQ;
// steps [P] int32 or null: the path steps each problem took (the plain
// version counts the same). Costs must be finite (the matcher's are
// nan_to_num'ed): a non-finite cost gives an unspecified assignment, but
// every index stays in bounds and every loop is bounded.
//
// Bound on the H100: latency, not bytes. At m (S = 6 sets x B = 8 images,
// G = 100 slots of which 5-40 valid, Q = 300) the valid cost rows are at
// most 1.15 MB, about 0.34 us of HBM time, while the work is a chain of
// dependent path steps (about 7 a problem after the row reduction), each an
// argmin over Q columns that the next step waits on.
//
// Design. One CTA of 8 warps a problem, all P problems in one launch.
//   1. Every warp reads the row mask (its loads all in flight) and compacts
//      the valid rows by a ballot and a prefix count a chunk of 32 rows; it
//      stages the slots s = warp (mod 8) into shared memory as it finds
//      them, with cp.async (16 bytes a copy where the rows allow it), so
//      that no barrier comes before the copies.
//   2. After its own copies land, each warp reduces its rows from shared
//      memory, two at a time (a lane's columns by a tree, then two warp
//      reductions, redux.sync, of an order-keeping key and of the column),
//      and claims each row's argmin column with an atomicMin of the slot
//      into row4col: the smallest slot keeps it, the serial rule. A problem whose valid rows do not fit the shared memory
//      the launch has (cap_rows rows) reads them from global memory instead,
//      here and in its path steps.
//   3. Warp 0 alone walks the paths, with no block barrier: lane l owns the
//      columns l, l + 32, ... (C of them, a template parameter from Q), and
//      keeps their v, shortest, pred, row4col and done bits in registers. A
//      path step loads the row's staged costs (lane l's reads hit bank
//      (l + row offset) mod 32: distinct) before any arithmetic, lowers its
//      columns branch-free, takes its first minimum by a tree, and an xor
//      butterfly over (value, column, row of the column) gives every lane
//      the first argmin and the next row: no shared-memory round trip and
//      no broadcast. The pending rows come from a ballot and prefix count
//      over the claims, in slot order. u, col4row and row4col live in
//      shared memory. A scanned row's u moves by minval less the minval at
//      the step that reached it (that is shortest at its column, frozen
//      once done), so the duals read no column state; lane 0 flips the
//      path along pred once a path.
// Shared memory: 28 G + 8 Q bytes of state (rounded up to 16) plus the
// staged rows, up to kMaxSmem (227 KB; cap_rows = 100 at G = 100, Q = 300:
// 125,200 bytes). The kernel's limit is raised once, by hungarian_lap_init,
// when the library is loaded; a launch sets nothing, allocates nothing and
// runs on the caller's stream, so it can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 1024;
constexpr int kMaxSmem = 232448;  // the dynamic shared memory a block of the H100 takes
constexpr float kMask = 1e30f;    // the JAX solver's _INF, the value of a done column
constexpr int kFree = 0x7fffffff;  // row4col of a column no row holds
constexpr unsigned kAll = 0xffffffffu;

// the arrays below (no static shared memory: kMaxSmem is all the dynamic
// shared memory a block can be given), rounded so that the staged rows
// start 16-byte aligned
__host__ __device__ constexpr size_t state_bytes(int g, int q) {
  return ((size_t)g * 28 + (size_t)q * 8 + 15) / 16 * 16;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// a before b: smaller, or equal at a smaller column (jnp.argmin's first minimum)
__device__ __forceinline__ bool before(float a, int ja, float b, int jb) {
  return a < b || (a == b && ja < jb);
}

// The first minimum of val[0..C) at the columns col (ascending in k), by a
// tree that keeps the left one on ties; tag follows the winner. Result in
// val[0], col[0], tag[0].
template <int C>
__device__ __forceinline__ void lane_first_min(float (&val)[C], int (&col)[C], int (&tag)[C]) {
#pragma unroll
  for (int w = 1; w < C; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < C; k += 2 * w) {
      if (val[k + w] < val[k]) {
        val[k] = val[k + w];
        col[k] = col[k + w];
        tag[k] = tag[k + w];
      }
    }
  }
}

// the first minimum of (val, col) over the warp, in every lane, with the tag
// of the winning lane
__device__ __forceinline__ void warp_argmin(float& val, int& col, int& tag) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(kAll, val, off);
    const int c = __shfl_xor_sync(kAll, col, off);
    const int t = __shfl_xor_sync(kAll, tag, off);
    if (before(v, c, val, col)) {
      val = v;
      col = c;
      tag = t;
    }
  }
}

// The first minimum of (val, col) over the warp, in every lane, by two
// warp reductions (redux.sync): the least value's key, then the least
// column holding it. The key orders floats as numbers, with -0 and +0 equal
// (x + 0 is +0 for both), so the column is jnp.argmin's; the value comes
// back from the key (a zero as +0, which no comparison tells from -0).
__device__ __forceinline__ void warp_first_min(float& val, int& col) {
  const unsigned b = __float_as_uint(val + 0.f);
  const unsigned key = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const unsigned least = __reduce_min_sync(kAll, key);
  col = (int)__reduce_min_sync(kAll, key == least ? (unsigned)col : 0xffffffffu);
  val = __uint_as_float((least & 0x80000000u) ? (least & 0x7fffffffu) : ~least);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The shared state of a problem (slot-indexed rows, columns).
struct State {
  float* u;          // [g] row duals
  int* col4row;      // [g] the column of each slot, -1 free
  int* row_of_slot;  // [g]
  int* order;        // [g] pending slots, in order
  int* scan;         // [g] the slots a path scanned, in order
  float* reach;      // [g] minval at the step that reached each of them
  int* row4col;      // [q] the slot of each column, kFree where none
  int* pred;         // [q] a path's pred on its done columns
};

// a lane's first minimum of a row's costs (C columns a lane). Every load is
// made, at a column clamped into the row, before any comparison: a load
// under a condition would wait for the comparisons before it.
template <int C>
__device__ __forceinline__ void row_first_min(const float* row, int q, int lane, float& best,
                                              int& bj) {
  float val[C];
  int col[C], tag[C];
#pragma unroll
  for (int k = 0; k < C; ++k) val[k] = row[min(lane + 32 * k, q - 1)];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = lane + 32 * k;
    val[k] = j < q ? val[k] : inf();
    col[k] = j;
    tag[k] = 0;
  }
  lane_first_min<C>(val, col, tag);
  best = val[0];
  bj = col[0];
}

// The row reduction of this warp's slots (s = warp mod kWarps), two rows at
// a time: u = the row's minimum, its first argmin claimed by the smallest
// slot. `rows` as in walk.
template <int C, bool kStaged>
__device__ __forceinline__ void reduce_rows(const float* __restrict__ rows, const State st,
                                            int q, int n, int warp, int lane) {
  for (int s = warp; s < n; s += 2 * kWarps) {
    const int s2 = s + kWarps < n ? s + kWarps : s;  // s itself again past the last slot
    const float* ra = rows + (size_t)(kStaged ? s : st.row_of_slot[s]) * q;
    const float* rb = rows + (size_t)(kStaged ? s2 : st.row_of_slot[s2]) * q;
    float va, vb;
    int ja, jb;
    row_first_min<C>(ra, q, lane, va, ja);
    row_first_min<C>(rb, q, lane, vb, jb);
    warp_first_min(va, ja);
    warp_first_min(vb, jb);
    if (lane == 0) {
      ja = ja < q ? ja : 0;
      st.u[s] = va;
      st.col4row[s] = ja;
      atomicMin(&st.row4col[ja], s);
      if (s2 != s) {
        jb = jb < q ? jb : 0;
        st.u[s2] = vb;
        st.col4row[s2] = jb;
        atomicMin(&st.row4col[jb], s2);
      }
    }
  }
}

// Warp 0: the shortest augmenting path of every pending slot. `rows` is the
// staged rows (kStaged) or the problem's costs in global memory. Returns
// the path steps taken.
template <int C, bool kStaged>
__device__ __forceinline__ int walk(const float* __restrict__ rows, const State st, int q, int n,
                                   int n_pending, int lane) {
  float v[C];
  int r4c[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = lane + 32 * k;
    v[k] = 0.f;
    r4c[k] = j < q ? st.row4col[j] : kFree;
  }
  int steps = 0;
  for (int p = 0; p < n_pending; ++p) {
    const int cur = st.order[p];
    float shortest[C];
    int pred[C];
    unsigned done = 0u;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      shortest[k] = kMask;
      pred[k] = 0;
    }
    int s = cur, sink = -1, n_scan = 0;
    float minval = 0.f;
    // ---- at most q steps (one column done each)
    for (int step = 0; step < q; ++step) {
      if (lane == 0 && n_scan < n) {
        st.scan[n_scan] = s;
        st.reach[n_scan] = minval;
      }
      ++n_scan;
      const float us = st.u[s];
      const float* row = rows + (size_t)(kStaged ? s : st.row_of_slot[s]) * q;
      float val[C];
      int col[C], tag[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {  // every load first, unconditional (row_first_min)
        const int j = min(lane + 32 * k, q - 1);
        val[k] = kStaged ? row[j] : __ldg(row + j);
      }
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int j = lane + 32 * k;
        const bool open = j < q && !((done >> k) & 1u);
        const float rc = __fsub_rn(__fsub_rn(__fadd_rn(minval, val[k]), us), v[k]);
        const bool upd = open && rc < shortest[k];
        shortest[k] = upd ? rc : shortest[k];
        pred[k] = upd ? s : pred[k];
        val[k] = open ? shortest[k] : (j < q ? kMask : inf());
        col[k] = j;
        tag[k] = r4c[k];
      }
      lane_first_min<C>(val, col, tag);
      float best = val[0];
      int bj = col[0], br = tag[0];
      warp_argmin(best, bj, br);
      ++steps;
      minval = best;
      const int j = bj < q ? bj : 0;
      if (lane == (j & 31)) done |= 1u << (j >> 5);
      if ((unsigned)br >= (unsigned)n) {
        sink = j;
        break;
      }
      s = br;
    }
    n_scan = min(n_scan, n);

    // ---- the duals over the scanned sets
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if ((done >> k) & 1u) {
        st.pred[lane + 32 * k] = pred[k];
        v[k] = __fsub_rn(v[k], __fsub_rn(minval, shortest[k]));
      }
    }
    __syncwarp();  // lane 0's scan list
    for (int t = lane; t < n_scan; t += 32) {
      const int r = st.scan[t];
      st.u[r] = t == 0 ? __fadd_rn(st.u[r], minval)  // cur
                       : __fadd_rn(st.u[r], __fsub_rn(minval, st.reach[t]));
    }
    __syncwarp();
    // ---- augment along pred, serially: at most n links
    if (lane == 0 && sink >= 0) {
      int j = sink;
      for (int t = 0; t < n; ++t) {
        const int r = min(max(st.pred[j], 0), n - 1);
        st.row4col[j] = r;
        const int nxt = st.col4row[r];
        st.col4row[r] = j;
        if (r == cur || nxt < 0) break;
        j = nxt;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < C; ++k) {  // the path's columns are done ones
      if ((done >> k) & 1u) r4c[k] = st.row4col[lane + 32 * k];
    }
  }
  return steps;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    hungarian_lap_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ row_valid,
                         int valid_rows, int32_t* __restrict__ out, int32_t* __restrict__ steps,
                         int g, int q, int cap_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  State st;
  st.u = reinterpret_cast<float*>(smem);
  st.col4row = reinterpret_cast<int*>(st.u + g);
  int* slot_of_row = st.col4row + g;  // [g] -1 on rows that are not valid
  st.row_of_slot = slot_of_row + g;
  st.order = st.row_of_slot + g;
  st.scan = st.order + g;
  st.reach = reinterpret_cast<float*>(st.scan + g);
  st.row4col = reinterpret_cast<int*>(st.reach + g);
  st.pred = st.row4col + q;
  float* stage = reinterpret_cast<float*>(smem + state_bytes(g, q));  // [cap_rows, q]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c = cost + (size_t)blockIdx.x * g * q;
  const uint8_t* valid =
      row_valid ? row_valid + (size_t)(blockIdx.x % valid_rows) * g : nullptr;
  const unsigned below = (1u << lane) - 1u;
  for (int j = tid; j < q; j += kThreads) st.row4col[j] = kFree;

  // ---- every warp: the valid rows compacted in index order (slots); warp
  // w keeps the rows of its slots (s = w mod kWarps), warp 0 the row map
  const int chunks = (g + 31) / 32;
  unsigned mine = 0u;  // bit t: row lane + 32 t is valid
#pragma unroll 8
  for (int t = 0; t < chunks; ++t) {
    const int i = lane + 32 * t;
    if (i < g && (!valid || valid[i])) mine |= 1u << t;
  }
  int n = 0;
  for (int t = 0; t < chunks; ++t) {
    const int i = lane + 32 * t;
    const bool ok = (mine >> t) & 1u;
    const unsigned m = __ballot_sync(kAll, ok);
    const int slot = n + __popc(m & below);
    if (ok && slot % kWarps == warp) st.row_of_slot[slot] = i;
    if (warp == 0 && i < g) slot_of_row[i] = ok ? slot : -1;
    n += __popc(m);
  }
  __syncwarp();
  const bool staged = n <= cap_rows;
  if (staged) {  // this warp's rows into shared memory
    const bool vec = (q & 3) == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0;
    for (int s = warp; s < n; s += kWarps) {
      const float* src = c + (size_t)st.row_of_slot[s] * q;
      float* dst = stage + (size_t)s * q;
      if (vec) {
        for (int j = 4 * lane; j < q; j += 128) cp_async16(dst + j, src + j);
      } else {
        for (int j = lane; j < q; j += 32) cp_async4(dst + j, src + j);
      }
    }
  }
  __syncthreads();  // row4col cleared, every slot's row known
  if (staged) {
    cp_async_wait_all();
    __syncwarp();
  }

  // ---- row reduction
  if (staged) {
    reduce_rows<C, true>(stage, st, q, n, warp, lane);
  } else {
    reduce_rows<C, false>(c, st, q, n, warp, lane);
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- the claims' losers pend, in slot order
  int n_pending = 0;
  for (int base = 0; base < n; base += 32) {
    const int s = base + lane;
    const bool pend = s < n && st.row4col[st.col4row[s]] != s;
    const unsigned m = __ballot_sync(kAll, pend);
    if (pend) {
      st.col4row[s] = -1;
      st.order[n_pending + __popc(m & below)] = s;
    }
    n_pending += __popc(m);
  }
  __syncwarp();

  int taken = 0;
  if (n_pending > 0) {
    taken = staged ? walk<C, true>(stage, st, q, n, n_pending, lane)
                   : walk<C, false>(c, st, q, n, n_pending, lane);
  }
  __syncwarp();
  int32_t* o = out + (size_t)blockIdx.x * g;
  for (int i = lane; i < g; i += 32) {
    const int s = slot_of_row[i];
    o[i] = s < 0 ? -1 : st.col4row[s];
  }
  if (steps && lane == 0) steps[blockIdx.x] = taken;
}

// One warp, `iters` dependent xor-butterfly argmins over (value, column,
// tag): the latency of one path step's argmin, for the latency floor.
__global__ void hungarian_lap_probe_kernel(int iters, float* out) {
  const int lane = threadIdx.x;
  float val = (float)((lane * 7) & 31);
  int col = lane, tag = lane;
  for (int t = 0; t < iters; ++t) {
    warp_argmin(val, col, tag);
    val = __fadd_rn(val, (float)((lane ^ col ^ tag) & 31));  // the next round waits on this one
    col = lane;
  }
  if (lane == 0) out[0] = val;
}

template <int C>
int launch(const float* cost, const uint8_t* row_valid, int V, int32_t* out, int32_t* steps,
           int P, int G, int Q, cudaStream_t stream) {
  const size_t state = state_bytes(G, Q);
  const size_t fit = (kMaxSmem - state) / ((size_t)Q * 4);  // rows the rest of kMaxSmem holds
  const int cap_rows = fit < (size_t)G ? (int)fit : G;
  const size_t smem = state + (size_t)cap_rows * Q * 4;
  hungarian_lap_kernel<C><<<P, kThreads, smem, stream>>>(cost, row_valid, V, out, steps, G, Q,
                                                         cap_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Raise the kernels' dynamic shared-memory limit to kMaxSmem on the current
// device: once, when the library is loaded, never at a launch.
extern "C" int hungarian_lap_init(void) {
  cudaError_t e = cudaFuncSetAttribute(hungarian_lap_kernel<10>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(hungarian_lap_kernel<16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(hungarian_lap_kernel<32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return (int)e;
}

// cost [P, G, Q] f32, row_valid [V, G] uint8 or null, out [P, G] int32,
// steps [P] int32 or null, on `stream`. Returns the CUDA error of the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int hungarian_lap(const void* cost, const void* row_valid, int V, void* out,
                             void* steps, int P, int G, int Q, void* stream) {
  if (P < 0 || G < 0 || G > Q || Q > kMaxQ || (row_valid && V <= 0))
    return (int)cudaErrorInvalidValue;
  if (P == 0 || G == 0) return (int)cudaSuccess;
  const float* c = static_cast<const float*>(cost);
  const uint8_t* rv = static_cast<const uint8_t*>(row_valid);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* s = static_cast<int32_t*>(steps);
  cudaStream_t st = (cudaStream_t)stream;
  if (Q <= 320) return launch<10>(c, rv, V, o, s, P, G, Q, st);
  if (Q <= 512) return launch<16>(c, rv, V, o, s, P, G, Q, st);
  return launch<32>(c, rv, V, o, s, P, G, Q, st);
}

// `iters` dependent butterfly argmins on one warp into out[0] (f32).
extern "C" int hungarian_lap_probe(void* out, int iters, void* stream) {
  hungarian_lap_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(iters,
                                                                 static_cast<float*>(out));
  return (int)cudaGetLastError();
}
