// Multi-scale deformable-attention core, backward (the closed form).
//
// Replaces: dfine_tpu/ops/deform_attn.py::ms_deform_attn_core_fused's bwd
// (:306-434, the `else` branch, no `window`; the corner tables at :235-241).
// On the TPU this was XLA device code with no Pallas kernel: for each level
// and each of the 4 bilinear corners it re-gathers the value rows, forms
// g.v, and builds the attention and location gradients and the (idx,
// contrib) streams of the value-gradient scatter. Here every level of one
// MSDeformAttnCore backward is one launch; the value gradient itself stays
// with the three scatter kernels (csrc/rows_scatter_add_tile.cu), one call a
// level, which take the streams written here as they are.
//
// Semantics, for each (b, q, head) and point p of level l (W, H its map):
//   x = u*W - 0.5, y = v*H - 0.5, x0 = floor(x), fx = x - x0 (y alike);
//   corner (dy, dx): weight w_c (the bilinear weight), valid when inside the
//   map, row r = (y0 + dy) * W + (x0 + dx) or -1 where not valid;
//   g.v_c = sum_d g_out[b,q,head,d] * value[b, start_l + r, head, d];
//   grad_att[p] = sum_c w_c m_c g.v_c; grad_loc[p] = (att * sum_c m_c dw_c/dfx
//   g.v_c * W, att * sum_c m_c dw_c/dfy g.v_c * H); and, for the scatter,
//   idx = r and contrib[d] = (att * (w_c * m_c)) * g_out[d], in f32 or
//   rounded once to bf16 (the payload of rows_scatter_add_mxu / _tiled).
//
// Layouts: value [B, S, H, D] (S = sum of the levels' H*W), bf16 or f32;
// loc [B, Q, H, P, 2] f32; att [B, Q, H, P] f32; g_out [B, Q, H*D] f32;
// grad_att [B, Q, H, P] f32; grad_loc [B, Q, H, P, 2] f32; idx int32 and
// contrib [., D] one allocation each holding every level's block in level
// order: level l's block is [B*H, 4*Q*P_l] entries (corner-major, then q,
// then p, as the reference concatenates them), starting at entry
// 4*B*Q*H*(points before l). idx == contrib == null writes neither (value
// not needing a gradient). D is 16, 32 or 64, P at most 16, at most 4
// levels; value 16-byte aligned, loc, grad_loc 8-byte, contrib 16-byte.
// Anything else is refused with cudaErrorInvalidValue.
//
// Exactness. idx equals the plain version's, and contrib is bit-equal to it
// (in f32, and in bf16 after the same round-to-nearest-even): every product
// and difference on the way to contrib is its own rounded op, as PyTorch's
// separate elementwise kernels take them (x = u*W - 0.5, fx = x - x0,
// 1 - fx, w_c, w_c * m, att * wgt, then * g), by the __fmul_rn / __fsub_rn /
// __fadd_rn intrinsics, which nvcc never contracts into an FMA. Every lane
// of a pair's group computes that chain itself from the same loads, so the
// lane that writes a channel holds the same bits as any other. The two
// gradients sum g.v over D in another order (a butterfly inside the lane
// group) than the reference's einsum, and are held within 2e-4 of their
// largest value.
//
// Bound on the H100: memory, and the writes of contrib above all. At m@640,
// B = 8, Q = 300, H = 8, points (3, 6, 3), D = 32 with the f32 payload:
// 921,600 entries x 128 B of contrib (118 MB) and 3.7 MB of idx, against
// 2.8 MB of gradients, 5.2 MB of loc, att and g_out and at most 34 MB of
// bf16 value rows (only those a valid corner touches are read): about 0.043
// ms at 3.35 TB/s; the bf16 payload halves contrib. The arithmetic (a few
// flops a channel and corner) is nothing for the card. chip_smoke.py
// computes the bound of each of its runs from the data.
//
// Design. The work is the list of slots (l, b, head, q, p_l) in the order
// of the output blocks: within level l and row b*H + head, slot s = q*P_l +
// p_l, and the entry of corner c is block + c*Q*P_l + s. So consecutive
// slots of one row are consecutive entries of each of the 4 corner ranges,
// and a run of consecutive queries of one (b, head) is one contiguous range
// of each.
//   - Lane groups. A lane holds 4 channels, so G = D / 4 lanes (4, 8 or 16)
//     cover a value row and a contrib row, and a warp holds NG = 32 / G
//     groups. One unit of work is NG * U consecutive slots of one row,
//     taken by one warp: group g takes slots g + NG j, j < U. Every store
//     instruction of the warp then covers NG consecutive entries: 512
//     contiguous bytes of f32 contrib, 256 of bf16, whole 32-byte sectors
//     (a 16-byte store a lane in f32, 8 bytes in bf16), and NG (or NG U)
//     consecutive idx. The CTA's 4 warps take 4 consecutive units.
//   - Loads first. Each lane loads its slots' loc, att and 4 channels of
//     g_out, then computes the location arithmetic of its U points (every
//     lane of the group the same chain: no shuffle for a coefficient),
//     tests each corner's validity on the floats before any int cast (a
//     location far off the map neither overflows nor reads: an off-map
//     corner is row -1 and loads nothing), and starts all 4U corner loads
//     of its row quarter (8 bytes at bf16, 16 at f32) before it uses any;
//     the loops are unrolled on the template U, with no run-time bound.
//   - g.v inside the group: 4 FMAs a lane, then log2(G) rounds of
//     __shfl_xor_sync (2, 3 or 4), the 4U butterflies independent, so
//     they pipeline; every lane of the group ends with the same sums (each
//     round adds the same two values in either order), so the 4 corners of
//     a point combine into grad_att and grad_loc in registers, with no
//     further shuffle.
//   - Every lane stores: its 4 channels of each of its 4U contrib rows;
//     lane j of a group the idx of slot j for each corner, and grad_att and
//     grad_loc (8 bytes) of slot j. Every output element is written, so
//     nothing is zero-filled before the launch and a call is one kernel.
//   - The level of a unit is a select on the levels' first units, and its
//     fields selects on constant indices, in registers: no local memory.
// TMA and wgmma do not fit: the loads are a gather of 32- to 256-byte rows
// at data-dependent addresses, the arithmetic a dot product a pair, and
// the stores already fill whole sectors from registers.
//
// nvcc -Xptxas -v for sm_90a: 48 registers (40 with bf16 value and payload),
// no stack frame, no spill in all 12 instances (chip_smoke.py's build phase
// fails otherwise); a 4-warp CTA, 10 CTAs an SM. On the H100, 2 or 4 slots a
// group (64-128 registers), 8-warp CTAs and streaming (evict-first) contrib
// stores made the train step's call no faster, so U = 1 stays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxPoints = 16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];   // first row of the level in S
  int first[kMaxLevels];   // the level's first point
  int points[kMaxLevels];  // the level's points
  int chunks[kMaxLevels];  // units a (b, head) row of the level
  int unit0[kMaxLevels];   // the level's first unit; unused levels: INT_MAX
};

// lv.<field>[l] for a warp-uniform l, as selects on constant indices (no local memory)
#define PICK(field) \
  (l == 0 ? lv.field[0] : l == 1 ? lv.field[1] : l == 2 ? lv.field[2] : lv.field[3])

// 4 channels of a value row, and their f32 values
template <typename T>
struct Quad;

template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ static void to_float(const uint2& r, float* f) {  // exact: bf16 is f32's top half
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};

template <>
struct Quad<float> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void to_float(const float4& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

// 4 channels of a contrib row: one 16-byte store in f32, 8 bytes in bf16
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

template <typename TV, typename TP, int D, int U>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_bwd_kernel(const TV* __restrict__ value, const float* __restrict__ loc,
                          const float* __restrict__ att, const float* __restrict__ g_out,
                          float* __restrict__ grad_att, float* __restrict__ grad_loc,
                          int* __restrict__ idx, TP* __restrict__ contrib, long long items,
                          int units, int S, int Q, int H, int P, Levels lv) {
  constexpr int G = D / 4;        // lanes a row
  constexpr int NG = 32 / G;      // groups a warp
  constexpr int SLOTS = NG * U;   // slots a unit
  static_assert(G * 4 == D && NG * G == 32 && U >= 1 && U <= G, "layout");
  using V = Quad<TV>;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= units) return;  // the whole warp
  const int grp = lane / G, lg = lane % G;

  // the unit: level l, row bh = b * H + head, chunk of SLOTS slots
  const int l = (u >= lv.unit0[1]) + (u >= lv.unit0[2]) + (u >= lv.unit0[3]);
  const int hl = PICK(h), wl = PICK(w), np = PICK(points);
  const int first_p = PICK(first), chunks = PICK(chunks);
  const int local = u - PICK(unit0);
  const int bh = local / chunks;
  const int chunk = local - bh * chunks;
  const int b = bh / H, head = bh - b * H;
  const int qp = Q * np;  // slots of the row
  const float wf = (float)wl, hf = (float)hl;
  const float x_last = (float)(wl - 1), y_last = (float)(hl - 1);
  const long long row = (long long)H * D;  // elements between two value rows
  const TV* val = value + ((long long)b * S + PICK(start)) * row + (long long)head * D + 4 * lg;
  // entry of (l, bh, corner 0, slot 0) in the level-ordered streams
  const long long block = 4LL * items * first_p + (long long)bh * 4 * qp;

  // 1. this lane's slots: loc, att and its 4 channels of g_out
  int slot[U];
  long long at[U];  // item * P + p, the slot's element of att and grad_att
  float2 xy[U];
  float a[U], g[U][4];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    slot[j] = chunk * SLOTS + j * NG + grp;
    const int s = slot[j] < qp ? slot[j] : qp - 1;  // a slot past the row computes on the last
    const int q = s / np;
    const long long item = ((long long)b * Q + q) * H + head;
    at[j] = item * P + first_p + (s - q * np);
    xy[j] = __ldg(reinterpret_cast<const float2*>(loc) + at[j]);
    a[j] = __ldg(att + at[j]);
#pragma unroll
    for (int k = 0; k < 4; ++k) g[j][k] = __ldg(g_out + item * D + 4 * lg + k);
  }

  // 2. the location arithmetic (each op rounded on its own, as the plain
  // version's kernels round it) and every corner load, before any is used
  float fx[U], fy[U], ux[U], uy[U];
  int r[U][4];
  typename V::Raw raw[U][4];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const float x = __fsub_rn(__fmul_rn(xy[j].x, wf), 0.5f);
    const float y = __fsub_rn(__fmul_rn(xy[j].y, hf), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    fx[j] = __fsub_rn(x, x0);
    fy[j] = __fsub_rn(y, y0);
    ux[j] = __fsub_rn(1.f, fx[j]);
    uy[j] = __fsub_rn(1.f, fy[j]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // the corners in the reference's order: (dy, dx)
      const float xc = __fadd_rn(x0, (float)(c & 1)), yc = __fadd_rn(y0, (float)(c >> 1));
      const bool ok = xc >= 0.f && xc <= x_last && yc >= 0.f && yc <= y_last;
      r[j][c] = ok ? (int)yc * wl + (int)xc : -1;
      raw[j][c] = ok ? V::load(val + (long long)r[j][c] * row) : typename V::Raw{};
    }
  }

  // 3. g.v of every pair: this lane's 4 channels, then the group's butterfly
  float gdv[U][4];
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[4];
      V::to_float(raw[j][c], v);
      float part = g[j][0] * v[0];
#pragma unroll
      for (int k = 1; k < 4; ++k) part = fmaf(g[j][k], v[k], part);
      gdv[j][c] = part;
    }
  }
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) gdv[j][c] += __shfl_xor_sync(0xffffffffu, gdv[j][c], m);
    }
  }

  // 4. the stores: contrib rows (every lane its 4 channels), idx and the
  // two gradients (lane j of the group for slot j)
  const bool write_value = idx != nullptr;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const bool live = slot[j] < qp;
    float ga = 0.f, gfx = 0.f, gfy = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dy = c >> 1, dx = c & 1;
      const float m = r[j][c] >= 0 ? 1.f : 0.f;
      // the corner table: w_c = wx * wy, d w_c / d fx = +-wy, d w_c / d fy = +-wx
      const float wx = dx ? fx[j] : ux[j], wy = dy ? fy[j] : uy[j];
      const float wgt = __fmul_rn(__fmul_rn(wx, wy), m);
      ga += wgt * gdv[j][c];
      gfx += m * (dx ? wy : -wy) * gdv[j][c];
      gfy += m * (dy ? wx : -wx) * gdv[j][c];
      if (write_value && live) {
        const long long e = block + (long long)c * qp + slot[j];
        const float coeff = __fmul_rn(a[j], wgt);
        float out[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = __fmul_rn(coeff, g[j][k]);
        store4(contrib + e * D + 4 * lg, out);
        if (lg == j) idx[e] = r[j][c];
      }
    }
    if (live && lg == j) {
      grad_att[at[j]] = ga;
      reinterpret_cast<float2*>(grad_loc)[at[j]] =
          make_float2(a[j] * gfx * wf, a[j] * gfy * hf);  // d x / d u = W, d y / d v = H
    }
  }
}

template <typename TV, typename TP, int D>
cudaError_t launch(const void* value, const void* loc, const void* att, const void* g_out,
                   void* grad_att, void* grad_loc, void* idx, void* contrib, long long items,
                   int B, int S, int Q, int H, int P, int n_levels, const int* info,
                   cudaStream_t stream) {
  constexpr int U = 1;                      // slots a group
  constexpr int SLOTS = 32 / (D / 4) * U;   // slots a unit
  Levels lv;
  long long units = 0;
  int p_sum = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < n_levels;
    const long long qp = used ? (long long)Q * info[4 * l + 3] : 0;
    lv.h[l] = used ? info[4 * l] : 1;
    lv.w[l] = used ? info[4 * l + 1] : 1;
    lv.start[l] = used ? info[4 * l + 2] : 0;
    lv.first[l] = p_sum;
    lv.points[l] = used ? info[4 * l + 3] : 1;
    lv.chunks[l] = (int)((qp + SLOTS - 1) / SLOTS);
    lv.unit0[l] = used ? (int)units : INT_MAX;
    units += (long long)B * H * lv.chunks[l];
    p_sum += used ? info[4 * l + 3] : 0;
    if (units > INT_MAX - kWarps) return cudaErrorInvalidValue;
  }
  if (units == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((units + kWarps - 1) / kWarps);
  ms_deform_attn_bwd_kernel<TV, TP, D, U><<<blocks, kThreads, 0, stream>>>(
      (const TV*)value, (const float*)loc, (const float*)att, (const float*)g_out,
      (float*)grad_att, (float*)grad_loc, (int*)idx, (TP*)contrib, items, (int)units, S, Q, H,
      P, lv);
  return cudaGetLastError();
}

template <typename TV, typename TP>
cudaError_t dispatch(int D, const void* v, const void* l, const void* a, const void* g,
                     void* ga, void* gl, void* i, void* c, long long n, int B, int S, int Q,
                     int H, int P, int nl, const int* info, cudaStream_t s) {
  if (D == 16) return launch<TV, TP, 16>(v, l, a, g, ga, gl, i, c, n, B, S, Q, H, P, nl, info, s);
  if (D == 32) return launch<TV, TP, 32>(v, l, a, g, ga, gl, i, c, n, B, S, Q, H, P, nl, info, s);
  if (D == 64) return launch<TV, TP, 64>(v, l, a, g, ga, gl, i, c, n, B, S, Q, H, P, nl, info, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// level_info: host int32 [n_levels, 4] rows of (h, w, start row in S, points).
// idx and contrib both null: no value gradient wanted, neither is written.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ms_deform_attn_bwd(const void* value, const void* loc, const void* att,
                                  const void* g_out, void* grad_att, void* grad_loc, void* idx,
                                  void* contrib, int B, int S, int Q, int H, int D, int P,
                                  int value_is_bf16, int payload_is_bf16, int n_levels,
                                  const void* level_info, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || P < 1 || P > kMaxPoints || H < 1)
    return (int)cudaErrorInvalidValue;
  if (((size_t)value & 15) || ((size_t)loc & 7) || ((size_t)grad_loc & 7) ||
      ((size_t)contrib & 15) || ((idx == nullptr) != (contrib == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* info = (const int*)level_info;
  int p_sum = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (info[4 * l] < 1 || info[4 * l + 1] < 1 || info[4 * l + 3] < 0)
      return (int)cudaErrorInvalidValue;
    p_sum += info[4 * l + 3];
  }
  if (p_sum != P || (long long)Q * P > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * Q * H;
  if (items == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (value_is_bf16 && payload_is_bf16)
    return (int)dispatch<bf16, bf16>(D, value, loc, att, g_out, grad_att, grad_loc, idx, contrib,
                                     items, B, S, Q, H, P, n_levels, info, s);
  if (value_is_bf16)
    return (int)dispatch<bf16, float>(D, value, loc, att, g_out, grad_att, grad_loc, idx,
                                      contrib, items, B, S, Q, H, P, n_levels, info, s);
  if (payload_is_bf16)
    return (int)dispatch<float, bf16>(D, value, loc, att, g_out, grad_att, grad_loc, idx,
                                      contrib, items, B, S, Q, H, P, n_levels, info, s);
  return (int)dispatch<float, float>(D, value, loc, att, g_out, grad_att, grad_loc, idx, contrib,
                                     items, B, S, Q, H, P, n_levels, info, s);
}
