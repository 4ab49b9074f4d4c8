// Train-mode BatchNorm2d and the activation that follows it, for the bf16
// (or f32) output of a conv, in four launches a BatchNorm and step:
//
//   forward   z  = bf16((x - mean) * invstd * w + b),  y = bf16(act(float(z)))
//   backward  dz = bf16(dy * act'(z)),
//             grad_bias = sum dz,  grad_weight = sum dz * xhat,
//             dx = bf16(w * invstd * (dz - mean(dz) - xhat * mean(dz * xhat)))
//
// over the N*H*W elements of each channel, with xhat = (x - mean) * invstd,
// the batch's mean and biased variance, and the running statistics updated
// as flax updates them (torch's momentum 0.1, the biased variance). With f32
// activations nothing is rounded to bf16. act is the identity, ReLU or SiLU.
//
// <- replaces no TPU kernel: the JAX package leaves flax's BatchNorm to XLA,
//    which fuses it with the ops around it. It replaces the port's plain
//    chain (dfine_tpu_torch/ops/kernels/batch_norm.py::batch_norm_train_plain:
//    a cast to f32, cuDNN's f32 BatchNorm, var_mean for the running
//    statistics, a cast back, the activation as an op of its own, and the
//    same again backward), which writes every intermediate to device memory,
//    about 60 bytes an element a step, and was the train step's largest
//    device cost.
//
// Bound on the H100: the bytes that must cross device memory. Each pass
// reads or writes a bf16 tensor once:
//   1. statistics   read x                  2 B an element
//   2. apply        read x, write y         4 B
//   3. grad sums    read x and dy           4 B
//   4. grad apply   read x and dy, write dx 6 B
// 16 B an element; where x (forward) or x and dy (backward) fit in the
// 50 MB L2, the applies' reads come from it after the pass before, and 10 B
// an element cross memory. At 3.35 TB/s; the arithmetic, a few dozen f32
// operations an element (SiLU an exp and a division each way), stays under
// that pace.
//
// Design.
//   - Layout: NCHW-contiguous, a channel being N runs of H*W elements (the
//     conv outputs of the train step; the wrapper refuses other layouts).
//     Loads and stores take 16 bytes a thread (8 bf16 or 4 f32) where H*W
//     is a multiple of that and every pointer is 16-byte aligned, else one
//     element.
//   - The reductions (1, 3) run on a grid of (slice, channel), a slice one
//     of `slices` parts of the channel's N*H*W elements, so that maps of
//     3,200 elements a channel with 2,048 channels and maps of 819 k
//     elements a channel with 32 both fill the card. A thread keeps its
//     partials in registers (the statistics as count, mean and M2, merged
//     by Chan's formula: no sum of squares, which cancels in tensors of
//     tens of millions of elements), the block merges them by a tree in
//     shared memory and writes one partial. The channel's last block to
//     finish (an atomic ticket after __threadfence) merges the slices'
//     partials in a fixed order and writes the results, so they do not
//     depend on which block came last: two runs are bit-equal. It sets its
//     ticket back to 0, so a launch needs no memset and a CUDA graph holds
//     the launches alone.
//   - The applies (2, 4) are elementwise: grid-stride over the vectors, a
//     vector's channel from its index by multiply-shift divisions.
//   - The backward keeps no f32 copy of x: both its passes recompute xhat,
//     z and dz from the saved x and dy.
// Rounding points are those of the chain it replaces: z and y round to
// bf16 where the chain's casts round, dz where its bf16 activation backward
// rounds; SiLU is x / (1 + exp(-x)) and its derivative dy s (1 + x (1 - s))
// as PyTorch writes them.
//
// Nothing is allocated here and nothing synchronises: the caller passes the
// partials' workspace and the tickets (zero before the first launch, zero
// again after each) and the launches go to its stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIdentity = 0, kRelu = 1, kSilu = 2;  // batch_norm.py: ACTS

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (d >= 1)
struct Divider {
  uint32_t magic, shift;
};

Divider make_divider(uint32_t d) {
  uint32_t shift = 0;
  while ((1ull << shift) < d) ++shift;
  const uint64_t magic = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return {(uint32_t)magic, shift};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, Divider f) {
  return (__umulhi(n, f.magic) + n) >> f.shift;
}

struct Shape {
  int channels;
  uint32_t inner;      // vectors a row of H*W: H*W / V
  Divider by_inner;
  Divider by_channels;
  uint32_t per_channel;  // vectors a channel: N*H*W / V
  uint32_t vectors;    // N*C*H*W / V
  int slices;
};

template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, size_t i, float* e) { e[0] = p[i]; }
  static __device__ __forceinline__ void store(float* p, size_t i, const float* e) { p[i] = e[0]; }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, size_t i, float* e) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, size_t i, const float* e) {
    reinterpret_cast<float4*>(p)[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, size_t i, float* e) {
    e[0] = __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, const float* e) {
    p[i] = __float2bfloat16_rn(e[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, size_t i, float* e) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      e[2 * k] = f.x;
      e[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, const float* e) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(e[2 * k], e[2 * k + 1]);
    reinterpret_cast<uint4*>(p)[i] = raw;
  }
};

// x as the activation dtype holds it
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <int ACT>
__device__ __forceinline__ float act_forward(float z) {
  if constexpr (ACT == kRelu) return (z > 0.f || z != z) ? z : 0.f;  // clamp_min(z, 0), NaN kept
  if constexpr (ACT == kSilu) return z / (1.f + expf(-z));
  return z;
}

// dy * act'(z), as PyTorch's threshold_backward (on relu's output) and
// silu_backward compute it
template <int ACT>
__device__ __forceinline__ float act_backward(float dy, float z) {
  if constexpr (ACT == kRelu) return z <= 0.f ? 0.f : dy;
  if constexpr (ACT == kSilu) {
    const float s = 1.f / (1.f + expf(-z));
    return dy * s * (1.f + z * (1.f - s));
  }
  return dy;
}

struct Moments {  // count, mean and the sum of squared deviations (M2)
  float n, mean, m2;
  __device__ __forceinline__ void add(const Moments& o) {  // Chan et al.'s merge
    if (o.n == 0.f) return;
    const float total = n + o.n, delta = o.mean - mean, r = o.n / total;
    mean = fmaf(delta, r, mean);
    m2 = m2 + o.m2 + delta * delta * n * r;
    n = total;
  }
};

struct Sums {  // of dz and of dz * xhat
  float dz, dzx;
  __device__ __forceinline__ void add(const Sums& o) {
    dz += o.dz;
    dzx += o.dzx;
  }
};

template <class A>
__device__ __forceinline__ A load_l2(const A* p) {  // another block's partial: past L1
  A a;
  const float* s = reinterpret_cast<const float*>(p);
  float* d = reinterpret_cast<float*>(&a);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(A) / 4); ++k) d[k] = __ldcg(s + k);
  return a;
}

// sh holds a block's kThreads accumulators: thread t + stride merges into
// t, halving, until sh[0] holds the block's total, always in the same order
template <class A>
__device__ void merge_block(A* sh) {
  for (int stride = kThreads >> 1; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride) sh[threadIdx.x].add(sh[threadIdx.x + stride]);
  }
  __syncthreads();
}

// The block's total sh[0] of channel c goes to part[c][slice]; the
// channel's last block then merges every slice's partial, each thread over
// the slices s = t, t + kThreads, ... in order and then by the tree, calls
// finish(c, total) and sets the ticket back to 0.
template <class A, class F>
__device__ void across_slices(A* sh, int c, int slices, A* part, unsigned* ticket, F finish) {
  __shared__ bool last;
  const int t = threadIdx.x;
  if (t == 0) part[(size_t)c * slices + blockIdx.x] = sh[0];
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == (unsigned)slices - 1;
  __syncthreads();
  if (!last) return;
  A acc = {};
#pragma unroll 4
  for (int s = t; s < slices; s += kThreads) acc.add(load_l2(part + (size_t)c * slices + s));
  sh[t] = acc;
  merge_block(sh);
  if (t == 0) {
    *ticket = 0;
    finish(c, sh[0]);
  }
}

struct Stats {
  float* mean;
  float* invstd;
  float* running_mean;
  float* running_var;
  long long* num_batches_tracked;
  Moments* part;
  unsigned* tickets;
  float eps, momentum, keep;  // keep = 1 - momentum
};

struct Affine {
  const float* mean;
  const float* invstd;
  const float* weight;
  const float* bias;
};

struct Grads {
  float* weight;
  float* bias;
  Sums* part;
  unsigned* tickets;
  float inv_count;  // 1 / (N*H*W)
};

// the vectors [begin, end) of a channel that slice blockIdx.x reduces
__device__ __forceinline__ void slice_of(const Shape& s, uint32_t& begin, uint32_t& end) {
  const uint32_t per = (s.per_channel + s.slices - 1) / s.slices;
  begin = blockIdx.x * per;
  end = min(s.per_channel, begin + per);
}

// the index in x of a channel's vector v (v < N*H*W / V)
__device__ __forceinline__ size_t index_of(uint32_t v, int c, const Shape& s) {
  const uint32_t n = divide(v, s.by_inner);
  return ((size_t)n * s.channels + c) * s.inner + (v - n * s.inner);
}

struct Channel {  // one channel's statistics and affine parameters
  float mean, invstd, weight, bias;
};

__device__ __forceinline__ Channel channel(const Affine& a, int c) {
  return {__ldg(a.mean + c), __ldg(a.invstd + c), __ldg(a.weight + c), __ldg(a.bias + c)};
}

// z = bf16((x - mean) * invstd * w + b), and xhat
template <typename T>
__device__ __forceinline__ float normalise(float x, const Channel& p, float& xhat) {
  xhat = (x - p.mean) * p.invstd;
  return round_to<T>(fmaf(xhat, p.weight, p.bias));
}

// the channel of vector v
__device__ __forceinline__ int channel_of(uint32_t v, const Shape& s) {
  const uint32_t row = divide(v, s.by_inner);
  return (int)(row - divide(row, s.by_channels) * s.channels);
}

// 1. Each channel's mean and biased variance; the channel's last block
//    writes mean and invstd and updates the running statistics.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    batch_norm_stats_kernel(const T* __restrict__ x, Shape s, Stats st) {
  auto finish = [&](int c, const Moments& m) {
    const float var = m.m2 / m.n;
    st.mean[c] = m.mean;
    st.invstd[c] = 1.f / sqrtf(var + st.eps);
    st.running_mean[c] = fmaf(st.momentum, m.mean, st.running_mean[c] * st.keep);
    st.running_var[c] = fmaf(st.momentum, var, st.running_var[c] * st.keep);
    if (c == 0) *st.num_batches_tracked += 1;
  };
  const int c = blockIdx.y;
  uint32_t begin, end;
  slice_of(s, begin, end);
  Moments acc = {};
#pragma unroll 4
  for (uint32_t v = begin + threadIdx.x; v < end; v += kThreads) {
    float e[V];
    Vec<T, V>::load(x, index_of(v, c, s), e);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) sum += e[j];
    const float mean = sum * (1.f / V);
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) m2 = fmaf(e[j] - mean, e[j] - mean, m2);
    acc.add({(float)V, mean, m2});
  }
  __shared__ Moments sh[kThreads];
  sh[threadIdx.x] = acc;
  merge_block(sh);
  across_slices(sh, c, s.slices, st.part, st.tickets + c, finish);
}

// 2. y = act(z), elementwise.
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(kThreads)
    batch_norm_apply_kernel(const T* __restrict__ x, T* __restrict__ y, Shape s, Affine a) {
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < s.vectors;
       v += gridDim.x * kThreads) {
    const Channel p = channel(a, channel_of(v, s));
    float e[V];
    Vec<T, V>::load(x, v, e);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float xhat;
      e[j] = act_forward<ACT>(normalise<T>(e[j], p, xhat));
    }
    Vec<T, V>::store(y, v, e);
  }
}

// 3. Each channel's sums of dz and dz * xhat; the channel's last block
//    writes them as grad_bias and grad_weight.
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(kThreads)
    batch_norm_grad_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy, Shape s,
                                Affine a, Grads g) {
  auto finish = [&](int c, const Sums& t) {
    g.weight[c] = t.dzx;
    g.bias[c] = t.dz;
  };
  const int c = blockIdx.y;
  uint32_t begin, end;
  slice_of(s, begin, end);
  const Channel p = channel(a, c);
  Sums acc = {};
#pragma unroll 4
  for (uint32_t v = begin + threadIdx.x; v < end; v += kThreads) {
    const size_t i = index_of(v, c, s);
    float e[V], d[V];
    Vec<T, V>::load(x, i, e);
    Vec<T, V>::load(dy, i, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float xhat;
      const float dz = round_to<T>(act_backward<ACT>(d[j], normalise<T>(e[j], p, xhat)));
      acc.dz += dz;
      acc.dzx = fmaf(dz, xhat, acc.dzx);
    }
  }
  __shared__ Sums sh[kThreads];
  sh[threadIdx.x] = acc;
  merge_block(sh);
  across_slices(sh, c, s.slices, g.part, g.tickets + c, finish);
}

// 4. dx, elementwise, from the sums of 3.
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(kThreads)
    batch_norm_grad_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                 T* __restrict__ dx, Shape s, Affine a, Grads g) {
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < s.vectors;
       v += gridDim.x * kThreads) {
    const int c = channel_of(v, s);
    const Channel p = channel(a, c);
    // the channel's means of dz and dz * xhat
    const float mean_dz = __ldg(g.bias + c) * g.inv_count;
    const float mean_dzx = __ldg(g.weight + c) * g.inv_count;
    float e[V], d[V];
    Vec<T, V>::load(x, v, e);
    Vec<T, V>::load(dy, v, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float xhat;
      const float dz = round_to<T>(act_backward<ACT>(d[j], normalise<T>(e[j], p, xhat)));
      e[j] = p.weight * p.invstd * fmaf(-xhat, mean_dzx, dz - mean_dz);
    }
    Vec<T, V>::store(dx, v, e);
  }
}

Shape make_shape(int n, int c, int hw, int vec, int slices) {
  Shape s;
  s.channels = c;
  s.inner = (uint32_t)(hw / vec);
  s.by_inner = make_divider(s.inner);
  s.by_channels = make_divider((uint32_t)c);
  s.per_channel = (uint32_t)n * s.inner;
  s.vectors = (uint32_t)((long long)n * c * hw / vec);
  s.slices = slices;
  return s;
}

template <typename T, int V>
int forward(const T* x, T* y, const Shape& s, const Affine& a, const Stats& st, int act,
            int blocks, cudaStream_t stream) {
  batch_norm_stats_kernel<T, V><<<dim3(s.slices, s.channels), kThreads, 0, stream>>>(x, s, st);
  if (act == kRelu)
    batch_norm_apply_kernel<T, V, kRelu><<<blocks, kThreads, 0, stream>>>(x, y, s, a);
  else if (act == kSilu)
    batch_norm_apply_kernel<T, V, kSilu><<<blocks, kThreads, 0, stream>>>(x, y, s, a);
  else
    batch_norm_apply_kernel<T, V, kIdentity><<<blocks, kThreads, 0, stream>>>(x, y, s, a);
  return (int)cudaGetLastError();
}

template <typename T, int V, int ACT>
void backward_act(const T* x, const T* dy, T* dx, const Shape& s, const Affine& a,
                  const Grads& g, int blocks, cudaStream_t stream) {
  batch_norm_grad_sums_kernel<T, V, ACT>
      <<<dim3(s.slices, s.channels), kThreads, 0, stream>>>(x, dy, s, a, g);
  if (dx)
    batch_norm_grad_apply_kernel<T, V, ACT><<<blocks, kThreads, 0, stream>>>(x, dy, dx, s, a, g);
}

template <typename T, int V>
int backward(const T* x, const T* dy, T* dx, const Shape& s, const Affine& a, const Grads& g,
             int act, int blocks, cudaStream_t stream) {
  if (act == kRelu)
    backward_act<T, V, kRelu>(x, dy, dx, s, a, g, blocks, stream);
  else if (act == kSilu)
    backward_act<T, V, kSilu>(x, dy, dx, s, a, g, blocks, stream);
  else
    backward_act<T, V, kIdentity>(x, dy, dx, s, a, g, blocks, stream);
  return (int)cudaGetLastError();
}

bool valid(int n, int c, int hw, int bf16, int vec, int act, int slices, int blocks) {
  return n > 0 && c > 0 && hw > 0 && (long long)n * c * hw < (1ll << 31) && c < 65536 &&
         (vec == 1 || vec == (bf16 ? 8 : 4)) && hw % vec == 0 && act >= kIdentity &&
         act <= kSilu && slices > 0 && slices < 65536 && blocks > 0;
}

}  // namespace

// x, y [N, C, H, W] NCHW-contiguous, bf16 (bf16 = 1) or f32; weight, bias,
// running_mean, running_var, mean, invstd [C] f32; num_batches_tracked
// int64; part C * slices * 3 f32; tickets int32, zero, one a channel; `vec`
// elements a load (1, or 8 bf16 / 4 f32); act 0 identity, 1 ReLU, 2 SiLU;
// `slices` the reductions' blocks a channel; `blocks` the apply's grid.
// Returns the CUDA error of the launches (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int batch_norm_train_forward(const void* x, void* y, const void* weight,
                                        const void* bias, void* running_mean, void* running_var,
                                        void* num_batches_tracked, void* mean, void* invstd,
                                        void* part, void* tickets, int n, int c, int hw, int bf16,
                                        int vec, int act, int slices, int blocks, float eps,
                                        float momentum, float keep, void* stream) {
  if (!valid(n, c, hw, bf16, vec, act, slices, blocks)) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(n, c, hw, vec, slices);
  const Affine a = {static_cast<const float*>(mean), static_cast<const float*>(invstd),
                    static_cast<const float*>(weight), static_cast<const float*>(bias)};
  const Stats st = {static_cast<float*>(mean),         static_cast<float*>(invstd),
                    static_cast<float*>(running_mean), static_cast<float*>(running_var),
                    static_cast<long long*>(num_batches_tracked),
                    static_cast<Moments*>(part),       static_cast<unsigned*>(tickets),
                    eps,                               momentum,
                    keep};
  cudaStream_t cs = (cudaStream_t)stream;
  if (bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    return vec == 8 ? forward<__nv_bfloat16, 8>(xb, yb, s, a, st, act, blocks, cs)
                    : forward<__nv_bfloat16, 1>(xb, yb, s, a, st, act, blocks, cs);
  }
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  return vec == 4 ? forward<float, 4>(xf, yf, s, a, st, act, blocks, cs)
                  : forward<float, 1>(xf, yf, s, a, st, act, blocks, cs);
}

// The backward of batch_norm_train_forward: x and dy in, dx out (null: only
// the parameters' gradients), mean and invstd as the forward wrote them,
// grad_weight and grad_bias [C] f32, part C * slices * 2 f32, the other
// arguments as the forward's.
extern "C" int batch_norm_train_backward(const void* x, const void* dy, void* dx,
                                         const void* weight, const void* bias, const void* mean,
                                         const void* invstd, void* grad_weight, void* grad_bias,
                                         void* part, void* tickets, int n, int c, int hw, int bf16,
                                         int vec, int act, int slices, int blocks, void* stream) {
  if (!valid(n, c, hw, bf16, vec, act, slices, blocks)) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(n, c, hw, vec, slices);
  const Affine a = {static_cast<const float*>(mean), static_cast<const float*>(invstd),
                    static_cast<const float*>(weight), static_cast<const float*>(bias)};
  const Grads g = {static_cast<float*>(grad_weight), static_cast<float*>(grad_bias),
                   static_cast<Sums*>(part), static_cast<unsigned*>(tickets),
                   (float)(1.0 / ((double)n * hw))};
  cudaStream_t cs = (cudaStream_t)stream;
  if (bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(dy);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(dx);
    return vec == 8 ? backward<__nv_bfloat16, 8>(xb, db, ob, s, a, g, act, blocks, cs)
                    : backward<__nv_bfloat16, 1>(xb, db, ob, s, a, g, act, blocks, cs);
  }
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dy);
  float* of = static_cast<float*>(dx);
  return vec == 4 ? backward<float, 4>(xf, df, of, s, a, g, act, blocks, cs)
                  : backward<float, 1>(xf, df, of, s, a, g, act, blocks, cs);
}
