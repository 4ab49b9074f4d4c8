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
// Layouts: cost [P, G, Q] f32 (row-major), row_valid [V, G] uint8 (a torch
// bool) or null (every row valid), problem p reading row p % V (a [B, G]
// mask broadcast over the leading sets of a [S, B, G, Q] stack needs no
// copy), out [P, G] int32, -1 on rows that are not valid; G <= Q <= kMaxQ.
// Costs must be finite (the matcher's are nan_to_num'ed): a non-finite cost
// gives an unspecified assignment, but every index stays in bounds and every
// loop is bounded.
//
// Bound on the H100: latency, not bytes. The work is a chain of dependent
// path steps, each a block-wide argmin over Q columns that the next step
// waits on, and a serial walk along the path. At m (S = 6 sets x B = 8
// images, G = 100 slots of which 5-40 valid, Q = 300) the valid cost rows
// are at most 1.15 MB, about 0.34 us of HBM time, while one path step takes
// a few microseconds of barriers and an L2 read.
//
// Design (simple and right first). One CTA of 256 threads per problem, all
// P problems in one launch: 48 CTAs at m. The columns are striped over the
// threads; the per-column state (v, shortest, pred, row4col, done) and the
// per-row state (u, col4row, pending order, scanned) live in shared memory,
// 17 Q + 13 G bytes (6.4 KB at Q = 300, G = 100). The row reduction gives
// each warp whole rows (a lane-strided first argmin, then a shuffle), with
// no block barrier. A path step reads the cost row of its row once,
// coalesced, from global memory (L2 after the reduction read it); each
// thread lowers its columns and keeps its first argmin; the warps' argmins
// meet in shared memory, where warp 0 reduces them and thread 0 does the
// serial bookkeeping (the column done, the sink or the next row): two
// barriers a step. The dual updates are striped over the threads, and
// thread 0 flips the path. The kernel launches on the caller's stream and
// allocates nothing, so it can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 1024;  // 17 kMaxQ + 13 kMaxQ bytes of shared memory: under 48 KB
constexpr float kMask = 1e30f;  // the JAX solver's _INF, the value of a done column
constexpr int kNoCol = 0x7fffffff;

// a before b: smaller, or equal at a smaller column (jnp.argmin's first minimum)
__device__ __forceinline__ bool before(float a, int ja, float b, int jb) {
  return a < b || (a == b && ja < jb);
}

__device__ __forceinline__ void warp_argmin(float& val, int& col) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, val, off);
    const int c = __shfl_down_sync(0xffffffffu, col, off);
    if (before(v, c, val, col)) {
      val = v;
      col = c;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    hungarian_lap_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ row_valid,
                         int valid_rows, int32_t* __restrict__ out, int g, int q) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);         // [q]
  float* shortest = v + q;                           // [q]
  int* pred = reinterpret_cast<int*>(shortest + q);  // [q]
  int* row4col = pred + q;                           // [q]
  float* u = reinterpret_cast<float*>(row4col + q);  // [g]
  int* col4row = reinterpret_cast<int*>(u + g);      // [g]
  int* order = col4row + g;                          // [g]
  uint8_t* done = reinterpret_cast<uint8_t*>(order + g);  // [q]
  uint8_t* scanned = done + q;                            // [g]
  __shared__ float warp_val[kWarps];
  __shared__ int warp_col[kWarps];
  __shared__ int s_pending, s_row, s_sink;
  __shared__ float s_minval;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c = cost + (size_t)blockIdx.x * g * q;
  const uint8_t* valid =
      row_valid ? row_valid + (size_t)(blockIdx.x % valid_rows) * g : nullptr;

  // ---- row reduction: u = the row's minimum, col4row its first argmin
  for (int j = tid; j < q; j += kThreads) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int i = warp; i < g; i += kWarps) {
    const bool ok = !valid || valid[i];  // the same for the whole warp
    float best = __int_as_float(0x7f800000);
    int bj = kNoCol;
    if (ok) {
      const float* row = c + (size_t)i * q;
      for (int j = lane; j < q; j += 32) {
        const float x = __ldg(row + j);
        if (before(x, j, best, bj)) {
          best = x;
          bj = j;
        }
      }
      warp_argmin(best, bj);
    }
    if (lane == 0) {
      u[i] = ok ? best : 0.f;
      col4row[i] = ok ? (bj < q ? bj : 0) : -1;
    }
  }
  __syncthreads();
  // each column to the smallest valid row whose argmin it is; the others pend
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < g; ++i) {
      if (valid && !valid[i]) continue;
      const int j = col4row[i];
      if (row4col[j] < 0) {
        row4col[j] = i;
      } else {
        col4row[i] = -1;
        order[n++] = i;
      }
    }
    s_pending = n;
  }
  __syncthreads();
  const int n_pending = s_pending;

  for (int k = 0; k < n_pending; ++k) {
    const int cur = order[k];
    for (int j = tid; j < q; j += kThreads) {
      shortest[j] = kMask;
      pred[j] = 0;
      done[j] = 0;
    }
    for (int i = tid; i < g; i += kThreads) scanned[i] = 0;
    if (tid == 0) {
      s_row = cur;
      s_sink = -1;
      s_minval = 0.f;
    }
    __syncthreads();

    // ---- the shortest augmenting path from cur: at most q steps (one column done each)
    int sink = -1;
    for (int step = 0; step < q && sink < 0; ++step) {
      const int i = s_row;
      const float minval = s_minval;
      const float ui = u[i];
      const float* row = c + (size_t)i * q;
      if (tid == 0) scanned[i] = 1;
      float best = __int_as_float(0x7f800000);
      int bj = kNoCol;
      for (int j = tid; j < q; j += kThreads) {
        float s = kMask;
        if (!done[j]) {
          const float rc = __fsub_rn(__fsub_rn(__fadd_rn(minval, __ldg(row + j)), ui), v[j]);
          s = shortest[j];
          if (rc < s) {
            s = rc;
            shortest[j] = rc;
            pred[j] = i;
          }
        }
        if (before(s, j, best, bj)) {
          best = s;
          bj = j;
        }
      }
      warp_argmin(best, bj);
      if (lane == 0) {
        warp_val[warp] = best;
        warp_col[warp] = bj;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < kWarps ? warp_val[lane] : __int_as_float(0x7f800000);
        bj = lane < kWarps ? warp_col[lane] : kNoCol;
        warp_argmin(best, bj);
        if (lane == 0) {
          const int j = bj < q ? bj : 0;
          s_minval = best;
          done[j] = 1;
          const int r = row4col[j];
          if (r < 0) {
            s_sink = j;
          } else {
            s_row = r;
          }
        }
      }
      __syncthreads();
      sink = s_sink;
    }

    // ---- the duals over the scanned sets
    const float minval = s_minval;
    for (int r = tid; r < g; r += kThreads) {
      if (r == cur) {
        u[r] = __fadd_rn(u[r], minval);
      } else if (scanned[r]) {
        const int j = min(max(col4row[r], 0), q - 1);
        u[r] = __fadd_rn(u[r], __fsub_rn(minval, shortest[j]));
      }
    }
    for (int j = tid; j < q; j += kThreads) {
      if (done[j]) v[j] = __fsub_rn(v[j], __fsub_rn(minval, shortest[j]));
    }
    __syncthreads();
    // ---- augment along pred, serially: at most g links
    if (tid == 0 && sink >= 0) {
      int j = sink;
      for (int t = 0; t < g; ++t) {
        const int r = pred[j];
        row4col[j] = r;
        const int nxt = col4row[r];
        col4row[r] = j;
        if (r == cur || nxt < 0) break;
        j = nxt;
      }
    }
    __syncthreads();
  }

  int32_t* o = out + (size_t)blockIdx.x * g;
  for (int i = tid; i < g; i += kThreads) o[i] = col4row[i];
}

}  // namespace

// cost [P, G, Q] f32, row_valid [V, G] uint8 or null, out [P, G] int32, on
// `stream`. Returns the CUDA error of the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int hungarian_lap(const void* cost, const void* row_valid, int V, void* out, int P,
                             int G, int Q, void* stream) {
  if (P < 0 || G < 0 || G > Q || Q > kMaxQ || (row_valid && V <= 0))
    return (int)cudaErrorInvalidValue;
  if (P == 0 || G == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)Q * 17 + (size_t)G * 13;
  hungarian_lap_kernel<<<P, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(row_valid), V,
      static_cast<int32_t*>(out), G, Q);
  return (int)cudaGetLastError();
}
