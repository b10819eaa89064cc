// Packet BVH traversal with Möller-Trumbore leaf tests, for sm_90a.
//
// Replaces gravit_tpu/ops/pallas_bvh.py::_traverse_kernel in all three of
// its forms: closest hit (K1), any hit (K2), and the triangle table left in
// HBM (K3). Here the table always lives in global memory, so the 6 MB VMEM
// split of the TPU kernel has no counterpart.
//
// One thread block per 1024-ray packet, one thread per ray, so the packet
// semantics that decide ties carry over exactly:
//   * the stack (int[96]) is shared by the packet and lives in shared
//     memory; the stack pointer and the iteration counter are block-uniform
//     (every thread computes the same values);
//   * a node is entered iff ANY live lane passes its slab test
//     (__syncthreads_or); thread 0 pushes the children;
//   * the near child is taken first, by the sign of the packet's SUMMED
//     direction on the node's split axis (meta[3]); the sum runs over all
//     1024 lanes, dead ones included;
//   * every live lane tests every leaf the packet enters, whether or not
//     its own slab test passed; within a chunk of 8 rows a tie goes to the
//     smallest row, across chunks and leaves a hit must be strictly closer;
//   * the iteration cap is 4*Nn+64 and the stack pointer is clamped to
//     STACK_DEPTH-2 after each push, as on the TPU;
//   * any-hit mode runs while some live lane has no hit yet.
//
// What bounds it on the card: its roofline bound is the fp32 arithmetic of
// the node and triangle tests. Node bounds, meta and triangle rows are read
// by all threads of a block at one address (a broadcast served from L1/L2),
// so device-memory traffic is the rays in and the hits out. This first
// version is the simple, exact one and runs at ~3% of that bound: each
// node step waits on a broadcast load and two barriers (PERF.md). No node
// or triangle staging in shared memory, no warp-level packet splitting.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false ...
// --fmad=false keeps every a*b+c rounded twice, as the plain PyTorch
// version computes it, so kernel and plain version agree bit for bit.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PACKET = 1024;
constexpr int STACK_DEPTH = 96;
constexpr int LEAF_PAD = 8;
constexpr float BIG = 1e30f;

// NaN-propagating min/max, as jnp.minimum / torch.minimum
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) < 1e-30f ? (x < 0.0f ? -BIG : BIG) : 1.0f / x;
}

// sum over the block of x; the result is valid in every thread
__device__ float block_sum(float x, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = x;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < PACKET / 32; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(PACKET, 1)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const int* __restrict__ valid,
                    const int* __restrict__ block_root,
                    const float* __restrict__ t_far,
                    const float* __restrict__ bounds,
                    const int* __restrict__ meta,
                    const float* __restrict__ tri,
                    int num_nodes, int any_hit,
                    float* __restrict__ t_out, int* __restrict__ prim_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    int* __restrict__ stats) {
  __shared__ int stack[STACK_DEPTH];
  __shared__ float scratch[PACKET / 32];

  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blk) * PACKET + lane;
  const int root = block_root[blk];

  float tb = t_far[i];
  int prim = -1;
  float uu = 0.0f, vv = 0.0f;
  int visits = 0, tri_rows = 0;

  if (root >= 0) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const bool live = valid[i] != 0;
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const bool dpos0 = block_sum(dx, scratch) >= 0.0f;
    const bool dpos1 = block_sum(dy, scratch) >= 0.0f;
    const bool dpos2 = block_sum(dz, scratch) >= 0.0f;

    if (lane == 0) stack[0] = root;
    int sp = 1;
    const int cap = 4 * num_nodes + 64;
    for (int it = 0;; ++it) {
      // barrier: thread 0's pushes of the last step are visible below
      const int unresolved =
          any_hit ? __syncthreads_or(live && prim < 0) : (__syncthreads(), 1);
      if (!(it < cap && sp > 0 && unresolved)) break;
      ++visits;
      sp -= 1;
      const int node = stack[sp];

      const float* b = bounds + 8 * static_cast<int64_t>(node);
      float tn = -BIG, tf = BIG;
      {
        float a0 = (b[0] - ox) * ix, b0 = (b[3] - ox) * ix;
        tn = maxp(tn, minp(a0, b0));
        tf = minp(tf, maxp(a0, b0));
        float a1 = (b[1] - oy) * iy, b1 = (b[4] - oy) * iy;
        tn = maxp(tn, minp(a1, b1));
        tf = minp(tf, maxp(a1, b1));
        float a2 = (b[2] - oz) * iz, b2 = (b[5] - oz) * iz;
        tn = maxp(tn, minp(a2, b2));
        tf = minp(tf, maxp(a2, b2));
      }
      const bool node_hit = live && tf >= tn && tn < tb && tf > 1e-6f;
      // barrier: every thread has read stack[sp] before thread 0 writes it
      if (!__syncthreads_or(node_hit)) continue;

      const int* m = meta + 4 * static_cast<int64_t>(node);
      const int m0 = m[0], m1 = m[1];
      if (m[2] > 0) {
        // leaf: rows [m0, m0 + m1) in chunks of LEAF_PAD
        tri_rows += m1;
        for (int c = 0; c * LEAF_PAD < m1; ++c) {
          const int base = m0 + c * LEAF_PAD;
          float tmin = FLT_MAX, us = 0.0f, vs = 0.0f;
          int kmin = 0;
          for (int k = 0; k < LEAF_PAD && c * LEAF_PAD + k < m1; ++k) {
            const float* r = tri + 12 * static_cast<int64_t>(base + k);
            const float v0x = r[0], v0y = r[1], v0z = r[2];
            const float e1x = r[3], e1y = r[4], e1z = r[5];
            const float e2x = r[6], e2y = r[7], e2z = r[8];
            const float px = dy * e2z - dz * e2y;
            const float py = dz * e2x - dx * e2z;
            const float pz = dx * e2y - dy * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const float idet = det != 0.0f ? 1.0f / det : 0.0f;
            const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
            const float u = (tvx * px + tvy * py + tvz * pz) * idet;
            const float qx = tvy * e1z - tvz * e1y;
            const float qy = tvz * e1x - tvx * e1z;
            const float qz = tvx * e1y - tvy * e1x;
            const float v = (dx * qx + dy * qy + dz * qz) * idet;
            const float t = (e2x * qx + e2y * qy + e2z * qz) * idet;
            const bool ok = det != 0.0f && u >= 0.0f && v >= 0.0f &&
                            u + v <= 1.0f && t > 1e-6f && live;
            if (ok && t < tmin) {
              tmin = t;
              kmin = k;
              us = u;
              vs = v;
            }
          }
          if (tmin < tb) {
            tb = tmin;
            prim = base + kmin;
            // + 0 turns -0 into +0, as the TPU kernel's one-hot sum does
            uu = us + 0.0f;
            vv = vs + 0.0f;
          }
        }
      } else {
        // inner: push far child, then near child (popped first)
        const int axis = m[3];
        const bool left_first = axis == 0 ? dpos0 : (axis == 1 ? dpos1 : dpos2);
        if (lane == 0) {
          stack[sp] = left_first ? m1 : m0;
          stack[sp + 1] = left_first ? m0 : m1;
        }
        sp += 2;
      }
      // stack-overflow guard, as on the TPU: never write past the stack
      sp = min(sp, STACK_DEPTH - 2);
    }
  }
  t_out[i] = tb;
  prim_out[i] = prim;
  u_out[i] = uu;
  v_out[i] = vv;
  if (lane == 0) {
    stats[2 * blk] = visits;
    stats[2 * blk + 1] = tri_rows;
  }
}

}  // namespace

extern "C" int bvh_traverse_launch(
    const void* o, const void* d, const void* valid, const void* block_root,
    const void* t_far, const void* bounds, const void* meta, const void* tri,
    int num_blocks, int num_nodes, int any_hit, void* t_out, void* prim_out,
    void* u_out, void* v_out, void* stats, void* stream) {
  if (num_blocks > 0) {
    bvh_traverse_kernel<<<num_blocks, PACKET, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const int*>(valid), static_cast<const int*>(block_root),
        static_cast<const float*>(t_far), static_cast<const float*>(bounds),
        static_cast<const int*>(meta), static_cast<const float*>(tri),
        num_nodes, any_hit, static_cast<float*>(t_out),
        static_cast<int*>(prim_out), static_cast<float*>(u_out),
        static_cast<float*>(v_out), static_cast<int*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
