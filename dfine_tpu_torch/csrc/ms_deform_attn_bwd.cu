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
// levels; loc 8-byte aligned. Anything else is refused with
// cudaErrorInvalidValue.
//
// Exactness. idx equals the plain version's, and contrib is bit-equal to it
// (in f32, and in bf16 after the same round-to-nearest-even): every product
// and difference on the way to contrib is its own rounded op, as PyTorch's
// separate elementwise kernels take them (x = u*W - 0.5, fx = x - x0,
// 1 - fx, w_c, w_c * m, att * wgt, then * g), by the __fmul_rn / __fsub_rn /
// __fadd_rn intrinsics, which nvcc never contracts into an FMA. The two
// gradients sum g.v over D in another order (a warp reduction) than the
// reference's einsum, and are held within 2e-4 of their largest value.
//
// Bound on the H100: memory, and the writes of contrib above all. At m@640,
// B = 8, Q = 300, H = 8, points (3, 6, 3), D = 32 with the f32 payload:
// 921,600 entries x 128 B of contrib (118 MB) and 3.7 MB of idx, against
// 2.8 MB of gradients, 5.2 MB of loc, att and g_out and at most 34 MB of
// bf16 value rows (only those a valid corner touches are read): about 0.04
// ms at 3.35 TB/s; the bf16 payload halves contrib. The arithmetic (a few
// flops a channel and corner) is nothing for the card. chip_smoke.py
// computes the bound of each of its runs from the data.
//
// Design (simple first; a wgmma/TMA design is later work). One item is one
// (b, q, head); a warp takes 32 / D items at D = 16 (16 lanes each), one at
// D = 32, and one at D = 64 with two 32-channel slices a lane (channels li
// and li + 32), as the sampling kernel splits D = 64. A lane holds its
// channels of g_out in registers; for each level, point and corner every
// lane computes the (cheap, warp-uniform) location arithmetic, tests the
// corner's validity on the floats before any int cast (a location far off
// the map neither overflows nor reads: a -1 row is never an address), loads
// its channels of the corner's value row, and a butterfly of
// __shfl_xor_sync over the item's lanes gives every lane g.v. Lane 0 of the
// item writes the entry's idx, every lane its channels of contrib (one
// 128-byte line a warp at D = 32 f32), and after the corners lane 0 writes
// the point's grad_att and grad_loc: every output element is written, so
// nothing is zero-filled before the launch and a call is one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxPoints = 16;
constexpr int kThreads = 128;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];   // first row of the level in S
  int first[kMaxLevels];   // the level's first point
  int points[kMaxLevels];  // the level's points
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {  // exact: bf16 is f32's top half
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// the sum of x over the item's LANES lanes (a butterfly: every lane gets it)
template <int LANES>
__device__ __forceinline__ float item_sum(float x) {
#pragma unroll
  for (int m = LANES / 2; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <typename TV, typename TP, int D>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_bwd_kernel(const TV* __restrict__ value, const float* __restrict__ loc,
                          const float* __restrict__ att, const float* __restrict__ g_out,
                          float* __restrict__ grad_att, float* __restrict__ grad_loc,
                          int* __restrict__ idx, TP* __restrict__ contrib, long long items,
                          int S, int Q, int H, int P, int n_levels, Levels lv) {
  constexpr int LANES = D < 32 ? D : 32;  // lanes an item
  constexpr int CH = D / LANES;           // channels a lane: li + 32 k
  constexpr int IW = 32 / LANES;          // items a warp
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * IW;
  if (first >= items) return;  // the whole warp
  // a lane past the last item computes on the last one (the shuffles need
  // every lane) and writes nothing
  const bool live = first + lane / LANES < items;
  const long long item = live ? first + lane / LANES : items - 1;
  const int li = lane % LANES;
  const int head = (int)(item % H);
  const long long bq = item / H;  // b * Q + q
  const int q = (int)(bq % Q);
  const long long b = bq / Q;
  const long long row = (long long)H * D;  // elements between two value rows
  const TV* val = value + b * S * row + (long long)head * D + li;
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + item * P;
  const float* att_i = att + item * P;
  const bool write_value = idx != nullptr;
  float g[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) g[k] = __ldg(g_out + item * D + li + 32 * k);

  for (int l = 0; l < n_levels; ++l) {
    const int wl = lv.w[l], np = lv.points[l];
    const float wf = (float)wl, hf = (float)lv.h[l];
    const float x_last = (float)(wl - 1), y_last = (float)(lv.h[l] - 1);
    const TV* val_l = val + (long long)lv.start[l] * row;
    // this item's row (b * H + head) of the level's [B*H, 4*Q*P_l] block
    const long long n_l = 4LL * Q * np;
    const long long block = 4LL * items * lv.first[l] + (b * H + head) * n_l + (long long)q * np;
    for (int pl = 0; pl < np; ++pl) {
      const int p = lv.first[l] + pl;
      const float2 xy = __ldg(loc_i + p);
      const float a = __ldg(att_i + p);
      const float x = __fsub_rn(__fmul_rn(xy.x, wf), 0.5f);
      const float y = __fsub_rn(__fmul_rn(xy.y, hf), 0.5f);
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
      const float ux = __fsub_rn(1.f, fx), uy = __fsub_rn(1.f, fy);
      float ga = 0.f, gfx = 0.f, gfy = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // the corners in the reference's order
        const int dy = c >> 1, dx = c & 1;
        const float xc = __fadd_rn(x0, (float)dx), yc = __fadd_rn(y0, (float)dy);
        const bool ok = xc >= 0.f && xc <= x_last && yc >= 0.f && yc <= y_last;
        const float m = ok ? 1.f : 0.f;
        // the corner table: w_c = wx * wy, d w_c / d fx = +-wy, d w_c / d fy = +-wx
        const float wx = dx ? fx : ux, wy = dy ? fy : uy;
        const float wgt = __fmul_rn(__fmul_rn(wx, wy), m);
        const int r = ok ? (int)yc * wl + (int)xc : -1;
        float part = 0.f;
        if (ok) {
#pragma unroll
          for (int k = 0; k < CH; ++k) part += g[k] * load(val_l + (long long)r * row + 32 * k);
        }
        const float gdv = item_sum<LANES>(part);
        ga += wgt * gdv;
        gfx += m * (dx ? wy : -wy) * gdv;
        gfy += m * (dy ? wx : -wx) * gdv;
        if (write_value && live) {
          const long long e = block + (long long)c * Q * np + pl;
          if (li == 0) idx[e] = r;
          const float coeff = __fmul_rn(a, wgt);
          TP* out = contrib + e * D + li;
#pragma unroll
          for (int k = 0; k < CH; ++k) store(out + 32 * k, __fmul_rn(coeff, g[k]));
        }
      }
      if (live && li == 0) {
        grad_att[item * P + p] = ga;
        grad_loc[(item * P + p) * 2] = a * gfx * wf;  // d x / d u = W
        grad_loc[(item * P + p) * 2 + 1] = a * gfy * hf;
      }
    }
  }
}

template <typename TV, typename TP, int D>
cudaError_t launch(const void* value, const void* loc, const void* att, const void* g_out,
                   void* grad_att, void* grad_loc, void* idx, void* contrib, long long items,
                   int S, int Q, int H, int P, int n_levels, const Levels& lv,
                   cudaStream_t stream) {
  constexpr int IW = 32 / (D < 32 ? D : 32);
  const long long per_block = kThreads / 32 * IW;
  const long long blocks = (items + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ms_deform_attn_bwd_kernel<TV, TP, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const TV*)value, (const float*)loc, (const float*)att, (const float*)g_out,
      (float*)grad_att, (float*)grad_loc, (int*)idx, (TP*)contrib, items, S, Q, H, P, n_levels,
      lv);
  return cudaGetLastError();
}

template <typename TV, typename TP>
cudaError_t dispatch(int D, const void* v, const void* l, const void* a, const void* g,
                     void* ga, void* gl, void* i, void* c, long long n, int S, int Q, int H,
                     int P, int nl, const Levels& lv, cudaStream_t s) {
  if (D == 16) return launch<TV, TP, 16>(v, l, a, g, ga, gl, i, c, n, S, Q, H, P, nl, lv, s);
  if (D == 32) return launch<TV, TP, 32>(v, l, a, g, ga, gl, i, c, n, S, Q, H, P, nl, lv, s);
  if (D == 64) return launch<TV, TP, 64>(v, l, a, g, ga, gl, i, c, n, S, Q, H, P, nl, lv, s);
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
  if (((size_t)loc & 7) || ((idx == nullptr) != (contrib == nullptr)))
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  const int* info = (const int*)level_info;
  int p_sum = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = info[4 * l];
    lv.w[l] = info[4 * l + 1];
    lv.start[l] = info[4 * l + 2];
    lv.first[l] = p_sum;
    lv.points[l] = info[4 * l + 3];
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.points[l] < 0) return (int)cudaErrorInvalidValue;
    p_sum += lv.points[l];
  }
  if (p_sum != P) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * Q * H;
  if (items == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (value_is_bf16 && payload_is_bf16)
    return (int)dispatch<bf16, bf16>(D, value, loc, att, g_out, grad_att, grad_loc, idx, contrib,
                                     items, S, Q, H, P, n_levels, lv, s);
  if (value_is_bf16)
    return (int)dispatch<bf16, float>(D, value, loc, att, g_out, grad_att, grad_loc, idx,
                                      contrib, items, S, Q, H, P, n_levels, lv, s);
  if (payload_is_bf16)
    return (int)dispatch<float, bf16>(D, value, loc, att, g_out, grad_att, grad_loc, idx,
                                      contrib, items, S, Q, H, P, n_levels, lv, s);
  return (int)dispatch<float, float>(D, value, loc, att, g_out, grad_att, grad_loc, idx, contrib,
                                     items, S, Q, H, P, n_levels, lv, s);
}
