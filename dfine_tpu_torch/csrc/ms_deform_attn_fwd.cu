// Multi-scale deformable-attention sampling core, forward.
//
// Replaces: dfine_tpu/ops/deform_attn.py::ms_deform_attn_core (:72-101). On
// the TPU this op was left to XLA's gather (no Pallas kernel was written for
// it); here it is the one custom kernel of the serving path, 4 launches a
// frame at size m (one a decoder layer), and 4 a train step.
//
// Semantics: F.grid_sample(mode=bilinear, padding_mode=zeros,
// align_corners=False) per level, weighted by the softmaxed attention and
// summed over levels and points:
//   out[b,q,h,:] = sum_l sum_p att[b,q,h,p] * sum_corners w_c * V_l[b, y_c, x_c, h, :]
// with x = u*W - 0.5, y = v*H - 0.5, and a corner outside the map giving 0.
//
// Layouts: value [B, S, H, D] (S = sum of the levels' H*W), bf16 or f32;
// loc [B, Q, H, P, 2] f32 in [0, 1]; att [B, Q, H, P] f32; out [B, Q, H*D] f32.
// D is 16, 32 or 64, P at most 16, at most 4 levels; value 16-byte aligned,
// loc 8-byte aligned. Anything else is refused with cudaErrorInvalidValue.
//
// Bound on the H100: memory. At m@640 (S = 8400, H = 8, D = 32, P = 12) the
// kernel must read once each bf16 value row that a valid corner touches,
// loc and att once, and write the output. At locations uniform in the map
// (chip_smoke.py's bound) that is 3.1 MB at B = 1, Q = 300 (0.92 us at
// 3.35 TB/s, below the cost of a launch: 56 % of the level rows are hit)
// and 32.7 MB at the train shape B = 8, Q = 500 (9.8 us). The
// arithmetic, 4 corners x 2 flops x D a point, is nothing for the card. A
// frame's value (4.3 MB at B = 1, 34.4 MB at B = 8 in bf16) fits the 50 MB
// L2, so the corner rows, read by many points, are L2 hits after the first:
// what limits the kernel is L2 latency, and the design keeps many
// independent 16-byte loads in flight to hide it.
//
// Design. One item is one (b, q, head); a warp takes 32 / D items, D lanes
// each. A value row of one head (D channels) is covered by 16-byte loads:
// 4 lanes at bf16 D = 32 (8 channels a lane), 8 at f32. The item's lanes
// thus form C lane groups (C = 8 channels a bf16 load, 4 an f32 one), and
// the item's 4P (point, corner) pairs q = 4 p + corner are shared out among
// the groups: group g takes pairs g + C i, i.e. corner g % 4 of the points
// g / 4 + (C / 4) i, P / 2 pairs a lane at bf16 (6 at P = 12) and P at f32.
//   1-2. Each pair's weight (att x wx x wy) and value row are computed once,
//      by lane q % D of the item, from the locations and attention weights
//      it loads (P = 12 at D = 32: 48 pairs, one or two a lane), testing the
//      corner's validity on the floats before any int cast, so that a
//      location far outside [0, 1] neither overflows nor reads out of bounds
//      (such a corner is weight 0, row -1 and no load). The point-to-level
//      map is a select on the levels' point ranges, in registers.
//   3. Each lane fetches its pairs' weights and rows by __shfl_sync (the
//      source register is the same in every lane) and issues all of its
//      16-byte corner loads before any is used; the loop is unrolled on a
//      template count of pairs, with no run-time loop bound.
//   4. Then the FMAs, in f32.
//   5. The C groups' partial sums are reduced and scattered in log2(C)
//      rounds of __shfl_xor_sync, each lane keeping half of what it has, so
//      that each lane ends with one channel: 7 shuffles at bf16 instead of
//      24 for a full reduce.
//   6. The item's D lanes store its D f32 outputs: one 128-byte line a warp.
// Each pair is computed once, by one lane, and not once in every lane of its
// group.
//
// Head dim 64 (the widened decoder layers past eval_idx, layer_scale = 2 at
// s/m/l/x): a head no longer fits a warp's 32 lanes at one 16-byte piece a
// lane group, so its 64 channels are two 32-channel slices that share the
// locations and attention weights. A slice is an item of the D = 32 design
// above with the value row offset by 32 channels and the output by 32
// floats: the two slices of a head run on neighbouring warps, each computing
// the same pairs, each loading its own 64-byte half of every corner row
// (bf16; 128 bytes at f32). At the train shape the wide value is 68.8 MB in
// bf16, more than the 50 MB L2, so corner rows are no longer all L2 hits.
//
// TMA and wgmma do not fit: the loads are a gather of scattered 32- and
// 64-byte rows, and the arithmetic is a weighted sum, not a matrix product.
//
// nvcc -Xptxas -v for sm_90a: 32 registers at bf16 D = 32 P = 12 (the serving
// and train instance), 30 to 44 across the 16 instances at D = 16 and 32, no
// spills, no shared memory; 4-warp CTAs, so the main instance may hold 16
// CTAs (64 warps) an SM. chip_smoke.py prints the registers of all 24
// instances, the 8 at D = 64 among them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxPoints = 16;
constexpr int kThreads = 128;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first row of the level in S
  int end[kMaxLevels];    // one past the level's last point; unused levels: past every point
};

// 16 bytes of a value row: C channels, and their f32 values
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int C = 8;
  using Raw = uint4;
  __device__ static void to_float(const uint4& r, float* f) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<float> {
  static constexpr int C = 4;
  using Raw = float4;
  __device__ static void to_float(const float4& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <typename T, int D, int SPLIT, int K>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const float* __restrict__ att, float* __restrict__ out, long long items,
                          int S, int QH, int H, int P, Levels lv) {
  using V = Vec<T>;
  constexpr int C = V::C;                          // channels a 16-byte load holds
  constexpr int LR = D / C;                        // lanes a value row
  constexpr int IW = 32 / D;                       // items a warp
  constexpr int J = (C * (K - 1) + C - 1) / D + 1;  // pairs a lane computes
  constexpr int kRounds = C == 8 ? 3 : 2;
  constexpr int DH = D * SPLIT;                    // head dim: SPLIT slices of D channels
  static_assert(LR * C == D && IW * D == 32, "layout");
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * IW;
  if (first >= items) return;  // the whole warp
  const bool live = first + lane / D < items;
  const long long slice = live ? first + lane / D : items - 1;  // items counts slices
  const long long item = slice / SPLIT;                          // the (b, q, head)
  const int half = (int)(slice % SPLIT);
  const int li = lane % D, base_lane = lane - li, part = li % LR, group = li / LR;
  const int head = (int)(item % H);
  const long long row = (long long)H * DH;  // elements between two value rows
  const T* val = value + (item / QH) * S * row + (long long)head * DH + half * D + part * C;
  const float2* loc_i = reinterpret_cast<const float2*>(loc + item * P * 2);
  const float* att_i = att + item * P;

  // 1-2. the item's (point, corner) pairs q = 4 p + corner, J a lane (pair
  // li + D j): the weight att * wx * wy and the value row, or row -1 where
  // the corner is off the map (tested on the floats, before any int cast)
  float wq[J];
  int sq[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = li + D * j, p = q >> 2, dx = q & 1, dy = (q >> 1) & 1;
    const float2 xy = p < P ? __ldg(loc_i + p) : make_float2(0.f, 0.f);
    const float a = p < P ? __ldg(att_i + p) : 0.f;
    const int l = (p >= lv.end[0]) + (p >= lv.end[1]) + (p >= lv.end[2]);
    const int hl = l == 0 ? lv.h[0] : l == 1 ? lv.h[1] : l == 2 ? lv.h[2] : lv.h[3];
    const int wl = l == 0 ? lv.w[0] : l == 1 ? lv.w[1] : l == 2 ? lv.w[2] : lv.w[3];
    const int st = l == 0 ? lv.start[0] : l == 1 ? lv.start[1] : l == 2 ? lv.start[2] : lv.start[3];
    const float x = xy.x * wl - 0.5f;
    const float y = xy.y * hl - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const float xc = x0 + dx, yc = y0 + dy;
    const bool ok = p < P && xc >= 0.f && xc <= (float)(wl - 1) && yc >= 0.f &&
                    yc <= (float)(hl - 1);
    wq[j] = ok ? a * (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy) : 0.f;
    sq[j] = ok ? st + (int)yc * wl + (int)xc : -1;
  }

  // 3. this lane's pairs: corner group % 4 of the points group / 4 + (C / 4) i,
  // i.e. pair group + C i, fetched from the lane that computed it; then all of
  // the lane's 16-byte corner loads, before any is used
  typename V::Raw raw[K];
  float wt[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int q = group + C * i;  // the register (C i) / D is the same in every lane
    const int src = base_lane + q % D;
    wt[i] = __shfl_sync(0xffffffffu, wq[C * i / D], src);
    const int s = __shfl_sync(0xffffffffu, sq[C * i / D], src);
    raw[i] = s >= 0 ? __ldg(reinterpret_cast<const typename V::Raw*>(val + s * row))
                    : typename V::Raw{};
  }

  // 4. the weighted sum of this lane's corners, in f32
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float v[C];
    V::to_float(raw[i], v);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(wt[i], v[c], acc[c]);
  }

  // 5. reduce-scatter over the item's C lane groups: in round r the lane whose
  // group bit r is set keeps the upper half of its values, its partner the
  // lower half, each adding the other's copy of the half it keeps
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int n = C >> (r + 1);
    const int m = LR << r;
    const bool up = lane & m;
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const float send = up ? acc[c] : acc[c + n];
      const float keep = up ? acc[c + n] : acc[c];
      acc[c] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  // the channel this lane kept: its part's first channel plus the group's bits reversed
  int ch = part * C;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) ch += ((group >> r) & 1) * (C >> (r + 1));

  // 6. one f32 a lane: the warp writes whole output lines
  if (live) out[item * DH + half * D + ch] = acc[0];
}

template <typename T, int D, int SPLIT, int K>
cudaError_t launch(const void* value, const void* loc, const void* att, void* out, long long items,
                   int S, int QH, int H, int P, const Levels& lv, cudaStream_t stream) {
  const long long per_block = kThreads / 32 * (32 / D);
  const long long blocks = (items + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ms_deform_attn_fwd_kernel<T, D, SPLIT, K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)value, (const float*)loc, (const float*)att, (float*)out, items, S, QH, H, P, lv);
  return cudaGetLastError();
}

// The pairs a lane takes, rounded up to a compiled count (2, 4, 6 or 8 at
// bf16, where a lane has every second point; 4, 8, 12 or 16 at f32).
template <typename T, int D, int SPLIT>
cudaError_t dispatch(const void* v, const void* l, const void* a, void* o, long long n, int S,
                     int QH, int H, int P, const Levels& lv, cudaStream_t s) {
  constexpr int PS = Vec<T>::C / 4;
  const int pairs = (P + PS - 1) / PS;
  if constexpr (PS == 2) {
    if (pairs <= 2) return launch<T, D, SPLIT, 2>(v, l, a, o, n, S, QH, H, P, lv, s);
    if (pairs <= 4) return launch<T, D, SPLIT, 4>(v, l, a, o, n, S, QH, H, P, lv, s);
    if (pairs <= 6) return launch<T, D, SPLIT, 6>(v, l, a, o, n, S, QH, H, P, lv, s);
    return launch<T, D, SPLIT, 8>(v, l, a, o, n, S, QH, H, P, lv, s);
  } else {
    if (pairs <= 4) return launch<T, D, SPLIT, 4>(v, l, a, o, n, S, QH, H, P, lv, s);
    if (pairs <= 8) return launch<T, D, SPLIT, 8>(v, l, a, o, n, S, QH, H, P, lv, s);
    if (pairs <= 12) return launch<T, D, SPLIT, 12>(v, l, a, o, n, S, QH, H, P, lv, s);
    return launch<T, D, SPLIT, 16>(v, l, a, o, n, S, QH, H, P, lv, s);
  }
}

}  // namespace

// level_info: host int32 [n_levels, 4] rows of (h, w, start row in S, points).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc, const void* att, void* out,
                                  int B, int S, int Q, int H, int D, int P, int value_is_bf16,
                                  int n_levels, const void* level_info, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || P < 1 || P > kMaxPoints || H < 1)
    return (int)cudaErrorInvalidValue;
  if (((size_t)value & 15) || ((size_t)loc & 7)) return (int)cudaErrorInvalidValue;
  Levels lv;
  const int* info = (const int*)level_info;
  int p_sum = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < n_levels;
    lv.h[l] = used ? info[4 * l] : 1;
    lv.w[l] = used ? info[4 * l + 1] : 1;
    lv.start[l] = used ? info[4 * l + 2] : 0;
    p_sum += used ? info[4 * l + 3] : 0;
    lv.end[l] = used ? p_sum : kMaxPoints + 1;
  }
  if (p_sum != P) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * Q * H;
  if (items == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int QH = Q * H;
  if (value_is_bf16 && D == 32)
    return (int)dispatch<__nv_bfloat16, 32, 1>(value, loc, att, out, items, S, QH, H, P, lv, s);
  if (value_is_bf16 && D == 16)
    return (int)dispatch<__nv_bfloat16, 16, 1>(value, loc, att, out, items, S, QH, H, P, lv, s);
  if (value_is_bf16 && D == 64)  // two 32-channel slices a head
    return (int)dispatch<__nv_bfloat16, 32, 2>(value, loc, att, out, 2 * items, S, QH, H, P,
                                                lv, s);
  if (!value_is_bf16 && D == 32)
    return (int)dispatch<float, 32, 1>(value, loc, att, out, items, S, QH, H, P, lv, s);
  if (!value_is_bf16 && D == 16)
    return (int)dispatch<float, 16, 1>(value, loc, att, out, items, S, QH, H, P, lv, s);
  if (!value_is_bf16 && D == 64)
    return (int)dispatch<float, 32, 2>(value, loc, att, out, 2 * items, S, QH, H, P, lv, s);
  return (int)cudaErrorInvalidValue;
}

// One launch of the kernel as the m model's serving path instantiates it
// (bf16, D = 32, P = 12) with no items: every warp returns at once. Its time
// is the floor under any launch of the kernel. Returns the cudaError_t.
extern "C" int ms_deform_attn_fwd_empty(void* stream) {
  Levels lv = {};
  ms_deform_attn_fwd_kernel<__nv_bfloat16, 32, 1, 6><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      nullptr, nullptr, nullptr, nullptr, 0, 0, 1, 1, 1, lv);
  return (int)cudaGetLastError();
}
