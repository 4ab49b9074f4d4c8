// Multi-scale deformable-attention sampling core, forward.
//
// Replaces: dfine_tpu/ops/deform_attn.py::ms_deform_attn_core (:72-101). On
// the TPU this op was left to XLA's gather (no Pallas kernel was written for
// it); here it is the one custom kernel of the serving path, 4 launches per
// frame at size m (one per decoder layer).
//
// Semantics: F.grid_sample(mode=bilinear, padding_mode=zeros,
// align_corners=False) per level, weighted by the softmaxed attention and
// summed over levels and points:
//   out[b,q,h,:] = sum_l sum_p att[b,q,h,p] * sum_corners w_c * V_l[b, y_c, x_c, h, :]
// with x = u*W - 0.5, y = v*H - 0.5, and a corner outside the map giving 0.
//
// Layouts: value [B, S, H, D] (S = sum of the levels' H*W), bf16 or f32;
// loc [B, Q, H, P, 2] f32 in [0, 1]; att [B, Q, H, P] f32; out [B, Q, H*D] f32.
//
// Bound on the H100: memory. At m@640, B=1 (S=8400, H=8, D=32, Q=300,
// P=12) the kernel must read the bf16 value once (4.3 MB) plus loc/att
// (0.17 MB) and write 0.3 MB: about 1.5 us at 3.35 TB/s. The arithmetic
// (4 corners x 2 flops x D per point) is ~2 MFLOP, nothing for the card.
// Design: one thread per output channel, D threads per (b, q, head) (one
// warp at D=32, half a warp at D=16). A head's value row is D contiguous
// elements, so each corner read is one coalesced 64-byte (bf16) or 128-byte
// (f32) transaction; the corner coordinates and weights are uniform across
// those threads; the fp32 accumulator stays in a register across all levels
// and points and is written once. The value map of a frame fits in the
// 50 MB L2, so the 4 corner reads of neighbouring points mostly hit L2.
// Coordinates are tested for validity as floats, before any int cast, so a
// location far outside [0, 1] can neither overflow nor read out of bounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MAX_LEVELS 4

struct Levels {
  int n;
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
  int points[MAX_LEVELS];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int D>
__global__ void ms_deform_attn_fwd_kernel(const T* __restrict__ value,
                                          const float* __restrict__ loc,
                                          const float* __restrict__ att,
                                          float* __restrict__ out, long long items,
                                          int S, int Q, int H, int P, Levels lv) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= items * D) return;
  const int c = (int)(tid % D);
  const long long item = tid / D;  // flattened (b, q, h)
  const int head = (int)(item % H);
  const long long b = item / H / Q;
  const long long row = (long long)H * D;  // elements between two value rows
  const T* val_b = value + b * S * row + (long long)head * D + c;
  const float* loc_i = loc + item * P * 2;
  const float* att_i = att + item * P;

  float acc = 0.f;
  int p = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const T* val_l = val_b + (long long)lv.start[l] * row;
    for (int k = 0; k < lv.points[l]; ++k, ++p) {
      const float x = __ldg(loc_i + 2 * p) * wl - 0.5f;
      const float y = __ldg(loc_i + 2 * p + 1) * hl - 0.5f;
      const float a = __ldg(att_i + p);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float fx = x - x0f;
      const float fy = y - y0f;
      // validity of the low (x0, y0) and high (x0+1, y0+1) corners
      const bool vx0 = x0f >= 0.f && x0f <= wl - 1;
      const bool vx1 = x0f >= -1.f && x0f <= wl - 2;
      const bool vy0 = y0f >= 0.f && y0f <= hl - 1;
      const bool vy1 = y0f >= -1.f && y0f <= hl - 2;
      if (!((vx0 || vx1) && (vy0 || vy1))) continue;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      float s = 0.f;
      if (vy0 && vx0) s += (1.f - fx) * (1.f - fy) * load_f32(val_l + ((long long)y0 * wl + x0) * row);
      if (vy0 && vx1) s += fx * (1.f - fy) * load_f32(val_l + ((long long)y0 * wl + x0 + 1) * row);
      if (vy1 && vx0) s += (1.f - fx) * fy * load_f32(val_l + ((long long)(y0 + 1) * wl + x0) * row);
      if (vy1 && vx1) s += fx * fy * load_f32(val_l + ((long long)(y0 + 1) * wl + x0 + 1) * row);
      acc += a * s;
    }
  }
  out[item * D + c] = acc;
}

template <typename T, int D>
static void launch(const void* value, const void* loc, const void* att, void* out,
                   long long items, int S, int Q, int H, int P, const Levels& lv,
                   cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (items * D + threads - 1) / threads;
  ms_deform_attn_fwd_kernel<T, D><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)value, (const float*)loc, (const float*)att, (float*)out, items, S, Q, H,
      P, lv);
}

// level_info: host int32 [n_levels, 4] rows of (h, w, start row in S, points).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc, const void* att,
                                  void* out, int B, int S, int Q, int H, int D, int P,
                                  int value_is_bf16, int n_levels, const void* level_info,
                                  void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  const int* info = (const int*)level_info;
  int p_sum = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = info[4 * l];
    lv.w[l] = info[4 * l + 1];
    lv.start[l] = info[4 * l + 2];
    lv.points[l] = info[4 * l + 3];
    p_sum += lv.points[l];
  }
  if (p_sum != P) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * Q * H;
  if (items == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_is_bf16 && D == 32) launch<__nv_bfloat16, 32>(value, loc, att, out, items, S, Q, H, P, lv, s);
  else if (value_is_bf16 && D == 16) launch<__nv_bfloat16, 16>(value, loc, att, out, items, S, Q, H, P, lv, s);
  else if (!value_is_bf16 && D == 32) launch<float, 32>(value, loc, att, out, items, S, Q, H, P, lv, s);
  else if (!value_is_bf16 && D == 16) launch<float, 16>(value, loc, att, out, items, S, Q, H, P, lv, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
