// The closest instance box along each ray, for sm_90a: BVH::intersect's
// leaf with `update=true` (BVH.h:61-135) over a flat list of boxes.
//
// Replaces no TPU kernel. The JAX package computes this search as a
// statically unrolled loop over the instances at (N,) lane width
// (gravit_tpu/render/tracer.py::_next_instance), which XLA fuses into one
// program; run eagerly, the same loop costs about 37 tiny launches an
// instance (925 a call at SimpleApp's 25), and the (N, I, 3) broadcast that
// replaces it moves 1.4 GB a call at 262,144 lanes. Both tracers call this
// kernel: the surface shuffle and hop loops (render/tracer.py) and the
// volume shuffle (render/volume_tracer.py).
//
// The function (what the plain version, ops/instance_slab.py, computes too).
// Per lane: inv = 1/d per axis (|d| < 1e-30 gives +-1e30 by d's sign, else
// IEEE 1.0f / d); per box i, in the JAX loop's order,
//   a = (lo_i - o) * inv, b = (hi_i - o) * inv,
//   tn = max(-FLT_MAX, min(a0, b0), min(a1, b1), min(a2, b2)) left to right,
//   tf = min(FLT_MAX, max(a0, b0), ...) likewise,
// and box i is hit iff tf > tn, tn > RAY_EPSILON, tn < t_max and
// i != exclude. The answer is the hit with the least tn, by a running strict
// `<` (on equal tn the lowest index wins); no hit gives found 0, index 0,
// t_entry FLT_MAX. min and max propagate NaN, as torch.minimum and
// torch.maximum do, so a NaN anywhere in a lane's box test fails it.
//
// What bounds it on the card: the rays in and the answers out, 32 bytes a
// lane read (origin, direction, t_max, exclude) and 9 written (found, index,
// t_entry); about 16 fp32 operations a (lane, box) pair are far below that
// at SimpleApp's 25 boxes. The design: one thread a lane and nothing shared
// between lanes. Every thread of a warp reads box i at the same address in
// the same step, so each read is one broadcast load through L1 (__ldg); any
// number of boxes works, with no staging. Lanes are read with a row stride,
// so a caller's column slices of a wider table need no copy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false ...
// --fmad=false keeps (lo - o) * inv two roundings, as PyTorch computes it.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr float RAY_EPSILON = 1e-6f;   // core/rays.py, compared in float32
constexpr float BIG = 1e30f;
constexpr float TINY = 1e-30f;

// NaN-propagating min/max, as torch.minimum / torch.maximum (one
// instruction each); they can differ from PyTorch's only in the sign of a
// zero, and the test below only compares.
__device__ __forceinline__ float minp(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float maxp(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(BLOCK) instance_slab_kernel(
    const float* __restrict__ lo, const float* __restrict__ hi,
    int num_boxes, const float* __restrict__ o, long long o_stride,
    const float* __restrict__ d, long long d_stride,
    const float* __restrict__ t_max, long long t_stride,
    const int* __restrict__ exclude, long long e_stride, int n,
    bool* __restrict__ found, int* __restrict__ nxt,
    float* __restrict__ t_entry) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= n) return;
  float org[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    org[k] = o[lane * o_stride + k];
    const float dk = d[lane * d_stride + k];
    inv[k] = fabsf(dk) < TINY ? (dk < 0.0f ? -BIG : BIG) : 1.0f / dk;
  }
  const float tm = t_max[lane * t_stride];
  const int ex = exclude[lane * e_stride];
  float best_t = FLT_MAX;
  int best_i = 0;
  for (int i = 0; i < num_boxes; ++i) {
    float tn = -FLT_MAX, tf = FLT_MAX;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = (__ldg(lo + 3 * i + k) - org[k]) * inv[k];
      const float b = (__ldg(hi + 3 * i + k) - org[k]) * inv[k];
      tn = maxp(tn, minp(a, b));
      tf = minp(tf, maxp(a, b));
    }
    if (tf > tn && tn > RAY_EPSILON && tn < tm && i != ex && tn < best_t) {
      best_t = tn;
      best_i = i;
    }
  }
  found[lane] = best_t < FLT_MAX;
  nxt[lane] = best_i;
  t_entry[lane] = best_t;
}

}  // namespace

extern "C" int instance_slab_launch(
    const void* lo, const void* hi, int num_boxes, const void* o,
    long long o_stride, const void* d, long long d_stride, const void* t_max,
    long long t_stride, const void* exclude, long long e_stride, int n,
    void* found, void* nxt, void* t_entry, void* stream) {
  if (n > 0) {
    instance_slab_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lo), static_cast<const float*>(hi),
        num_boxes, static_cast<const float*>(o), o_stride,
        static_cast<const float*>(d), d_stride,
        static_cast<const float*>(t_max), t_stride,
        static_cast<const int*>(exclude), e_stride, n,
        static_cast<bool*>(found), static_cast<int*>(nxt),
        static_cast<float*>(t_entry));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* instance_slab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
