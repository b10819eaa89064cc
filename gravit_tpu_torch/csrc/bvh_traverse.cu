// BVH traversal with Möller-Trumbore leaf tests, for sm_90a: warp-wide
// voting groups under the packet's traversal order.
//
// Replaces gravit_tpu/ops/pallas_bvh.py::_traverse_kernel in all three of
// its forms: closest hit (K1), any hit (K2), and the triangle table left in
// HBM (K3). Here the table always lives in global memory, so the 6 MB VMEM
// split of the TPU kernel has no counterpart.
//
// The function (what every version computes). A packet of 1024 consecutive
// rays shares one traversal ORDER: at an inner node the near child, by the
// sign of the packet's SUMMED direction on the node's split axis (meta[3];
// the sum runs over all 1024 lanes, dead ones included, in block_sum's
// order, which the plain version repeats), is visited first.
// A ray's answer is the first closest hit along that order: a later leaf or
// chunk must be strictly closer, and within a chunk of 8 rows a tie goes to
// the smallest row.
//
// What bounds it on the card. The roofline bound is small: the fp32
// arithmetic of the node and triangle tests the rays need, and the rays in
// and hits out (tables are read at one address per warp, broadcasts served
// from L1/L2). What the card waits on is the walk itself, a chain of
// dependent steps (pop, fetch the node, test, vote, push), and a launch
// lasts as long as its longest chain. The TPU kernel's shape, one vote over
// all 1024 lanes, gave the card one 1024-thread block per SM: two
// block-wide barriers per node with nothing else to run, every lane testing
// every node ANY of 1024 lanes enters, and a tail as long as the busiest
// packet.
//
// The design.
//   * Voting group = one warp. A node is entered iff any live lane of the
//     warp passes its slab test (__any_sync); every live lane of the warp
//     tests every leaf the warp enters. Each warp has its own stack in
//     shared memory (lane 0 pushes, __syncwarp), its own stack pointer and
//     iteration counter; the cap 4*Nn+64 and the clamp to STACK_DEPTH-2
//     are the TPU kernel's. No block-wide barrier anywhere in the walk.
//   * The ORDER stays the packet's: a small pre-pass (packet_dpos_kernel,
//     one 1024-thread block per packet, the summation order of the first
//     version of this kernel) writes the three sign bits per packet, and
//     every warp of the packet reads them. So the walk runs in small
//     blocks, many per SM, warps hide each other's load chains and the
//     tail is a warp's, not a packet's.
//   * Why that is exact: a leaf in which a lane hits nothing closer leaves
//     its answer alone, and a lane can only hit inside boxes its own slab
//     test passes. A warp that walks the packet's order and prunes with its
//     own lanes' tests therefore skips only leaves that cannot change its
//     lanes' answers, and returns the packet-wide walk's (t, prim, u, v)
//     for every lane. Taking the signs from the warp, or regrouping rays
//     across packets, would change the tie winners and is not done.
//   * The slab test is conservative. In float32 a hit exactly on a box
//     face (a ray aimed at a vertex, or at the floor's zero-height box)
//     can fail the lane's own exact slab test by a rounding, while the
//     packet-wide vote enters the leaf on a neighbour's test. So the exit
//     distance is scaled by WIDEN = 1 + 2*gamma(3), gamma(n) = n*eps /
//     (1 - n*eps), eps = 2^-24, before it is compared (Ize, "Robust BVH Ray
//     Traversal", JCGT 2013; PBRT's Bounds3::IntersectP). The plain
//     version at any group below the packet does the same; the
//     packet-wide walk (the TPU kernel's) keeps the exact test.
//     tests/test_torch_bvh_groups.py and chip_smoke.py's hold_K1_vertices
//     count the lanes where the two walks still differ.
//   * The longest warp's chain is what a launch waits for, so each step is
//     kept short. A node's bounds and meta arrive as three 16-byte loads;
//     an inner node's near child, always the next pop, is fetched beside
//     the node's own test and kept in registers. The slab test's
//     NaN-propagating min/max are single instructions. A leaf chunk's rows
//     lie side by side in the table: one 16-byte load per lane stages them
//     in shared memory, then every lane tests them two rows per branch.
//   * A warp with no live lane leaves at once; in any-hit mode a warp
//     leaves when each of its live lanes has a hit.
//   * Möller-Trumbore is the plain version's arithmetic, line for line
//     (IEEE 1/det, + 0 on u and v), and the slab test gives the plain
//     version's verdict on every input.
//   Measured and not kept: 8x4 pixel sub-tiles per warp (camera rays 10%
//   faster, bounced rays 3% slower), an L1 prefetch hint for the far child
//   and a leaf's rows fetched before its vote (both slower).
//
// Counts, per warp: nodes popped, triangle rows tested, and what its live
// lanes need on their own (the root test, two node tests per inner node a
// lane's own slab test passed, the rows of every leaf its own test passed).
// The last two are the ray-level work that a roofline bound should count.
// Each warp also reports when its walk began and how long it took
// (%globaltimer, ns): a launch lasts as long as its longest walk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false ...
// --fmad=false keeps every a*b+c rounded twice, as the plain PyTorch
// version computes it, so kernel and plain version agree bit for bit.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PACKET = 1024;
constexpr int GROUP = 32;                     // voting group: one warp
constexpr int GROUPS_PER_PACKET = PACKET / GROUP;
constexpr int STACK_DEPTH = 96;
constexpr int LEAF_PAD = 8;
constexpr float BIG = 1e30f;
// 1 + 2*gamma(3) rounded to float32 (1 + 3*2^-23): the slab test's exit
// distance is scaled by it (ops/bvh_traverse.py's WIDEN)
constexpr float WIDEN = 0x1.000006p+0f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STATS = 6;                      // ints per warp in `stats`

// threads per traversal block, and resident blocks per SM the compiler must
// leave room for (up to 85 registers a thread). Measured on the H100 over
// 32..1024 threads and 16..64 warps per SM: all within 8%, this the best.
constexpr int BLOCK = 128;
constexpr int MIN_BLOCKS = 6;
constexpr int WARPS = BLOCK / GROUP;

// NaN-propagating min/max, as jnp.minimum / torch.minimum: one instruction
// each (min.NaN / max.NaN). Against the plain version's result they can
// differ only in the sign of a zero, and the slab test below only compares.
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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) < 1e-30f ? (x < 0.0f ? -BIG : BIG) : 1.0f / x;
}

__device__ __forceinline__ void load_node(const float* __restrict__ bounds,
                                          const int* __restrict__ meta,
                                          int node, float4& lo, float4& hi,
                                          int4& m) {
  const float4* b4 =
      reinterpret_cast<const float4*>(bounds + 8 * static_cast<int64_t>(node));
  lo = __ldg(b4);          // min x, y, z and max x
  hi = __ldg(b4 + 1);      // max y, z and padding
  m = __ldg(reinterpret_cast<const int4*>(meta + 4 * static_cast<int64_t>(node)));
}

// sum over a PACKET-thread block of x; the result is valid in every thread
__device__ float block_sum(float x, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(FULL, x, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = x;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < PACKET / 32; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// bit a of dpos[p]: the packet's summed direction on axis a is >= 0
__global__ void __launch_bounds__(PACKET)
packet_dpos_kernel(const float* __restrict__ d,
                   const int* __restrict__ block_root,
                   int* __restrict__ dpos) {
  __shared__ float scratch[PACKET / 32];
  const int blk = blockIdx.x;
  if (block_root[blk] < 0) return;
  const int64_t i = static_cast<int64_t>(blk) * PACKET + threadIdx.x;
  const float sx = block_sum(d[3 * i], scratch);
  const float sy = block_sum(d[3 * i + 1], scratch);
  const float sz = block_sum(d[3 * i + 2], scratch);
  if (threadIdx.x == 0)
    dpos[blk] = (sx >= 0.0f ? 1 : 0) | (sy >= 0.0f ? 2 : 0) |
                (sz >= 0.0f ? 4 : 0);
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const int* __restrict__ valid,
                    const int* __restrict__ block_root,
                    const int* __restrict__ dpos,
                    const float* __restrict__ t_far,
                    const float* __restrict__ bounds,
                    const int* __restrict__ meta,
                    const float* __restrict__ tri,
                    int num_nodes, int any_hit,
                    float* __restrict__ t_out, int* __restrict__ prim_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    int* __restrict__ stats) {
  __shared__ int stacks[WARPS][STACK_DEPTH];
  __shared__ float4 rowbufs[WARPS][3 * LEAF_PAD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t grp = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  const int pkt = static_cast<int>(grp / GROUPS_PER_PACKET);
  const int gw = static_cast<int>(grp % GROUPS_PER_PACKET);
  const int ray = gw * GROUP + lane;
  const int64_t i = static_cast<int64_t>(pkt) * PACKET + ray;
  const int root = block_root[pkt];
  const unsigned long long began = global_ns();

  float tb = t_far[i];
  int prim = -1;
  float uu = 0.0f, vv = 0.0f;
  int visits = 0, tri_rows = 0, own_nodes = 0, own_rows = 0;

  const bool live = root >= 0 && valid[i] != 0;
  if (__any_sync(FULL, live)) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const int dp = dpos[pkt];
    const bool dpos0 = dp & 1, dpos1 = dp & 2, dpos2 = dp & 4;

    int* stack = stacks[warp];
    float4* rowbuf = rowbufs[warp];
    float4 nlo, nhi;
    int4 nm;
    bool have_next = false;
    if (lane == 0) stack[0] = root;
    __syncwarp();
    own_nodes = live ? 1 : 0;                 // the root's test
    int sp = 1;
    const int cap = 4 * num_nodes + 64;
    for (int it = 0;; ++it) {
      const int unresolved = any_hit ? __any_sync(FULL, live && prim < 0) : 1;
      if (!(it < cap && sp > 0 && unresolved)) break;
      ++visits;
      sp -= 1;
      float4 lo, hi;
      int4 m;
      if (have_next) {
        lo = nlo, hi = nhi, m = nm;
      } else {
        load_node(bounds, meta, stack[sp], lo, hi, m);
      }
      const bool left_first =
          m.w == 0 ? dpos0 : (m.w == 1 ? dpos1 : dpos2);
      // an inner node's near child is popped next: fetch it now, beside
      // this node's own test (wasted, and harmless, if the vote fails)
      if (m.z <= 0)
        load_node(bounds, meta, left_first ? m.x : m.y, nlo, nhi, nm);
      have_next = false;
      float tn = -BIG, tf = BIG;
      {
        float a0 = (lo.x - ox) * ix, b0 = (lo.w - ox) * ix;
        tn = maxp(tn, minp(a0, b0));
        tf = minp(tf, maxp(a0, b0));
        float a1 = (lo.y - oy) * iy, b1 = (hi.x - oy) * iy;
        tn = maxp(tn, minp(a1, b1));
        tf = minp(tf, maxp(a1, b1));
        float a2 = (lo.z - oz) * iz, b2 = (hi.y - oz) * iz;
        tn = maxp(tn, minp(a2, b2));
        tf = minp(tf, maxp(a2, b2));
      }
      tf = tf * WIDEN;
      const bool node_hit = live && tf >= tn && tn < tb && tf > 1e-6f;
      // the vote. A lane that read stack[sp] above has used it by now (the
      // node feeds node_hit), so lane 0 may overwrite the slot below
      if (!__any_sync(FULL, node_hit)) continue;

      const int m0 = m.x, m1 = m.y;
      if (m.z > 0) {
        // leaf: rows [m0, m0 + m1) in chunks of LEAF_PAD
        tri_rows += m1;
        if (node_hit) own_rows += m1;
        for (int c = 0; c * LEAF_PAD < m1; ++c) {
          const int base = m0 + c * LEAF_PAD;
          float tmin = FLT_MAX, us = 0.0f, vs = 0.0f;
          int kmin = 0;
          // the chunk's rows lie side by side: one 16-byte load per lane
          // brings them to shared memory, then every lane reads every row
          const int nk = min(LEAF_PAD, m1 - c * LEAF_PAD);
          __syncwarp();    // the last chunk's reads are done
          if (lane < 3 * nk)
            rowbuf[lane] = __ldg(reinterpret_cast<const float4*>(
                                     tri + 12 * static_cast<int64_t>(base)) + lane);
          __syncwarp();
#pragma unroll
          for (int k = 0; k < LEAF_PAD; ++k) {
            // two rows per uniform branch: their arithmetic interleaves
            if ((k & 1) == 0 && k >= nk) break;
            // a row past nk holds stale values; `ok` drops it
            const float4 r0 = rowbuf[3 * k], r1 = rowbuf[3 * k + 1],
                         r2 = rowbuf[3 * k + 2];
            const bool in_leaf = k < nk;
            const float v0x = r0.x, v0y = r0.y, v0z = r0.z;
            const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
            const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
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
                            u + v <= 1.0f && t > 1e-6f && live && in_leaf;
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
        if (node_hit) own_nodes += 2;
        if (lane == 0) {
          stack[sp] = left_first ? m1 : m0;
          stack[sp + 1] = left_first ? m0 : m1;
        }
        sp += 2;
        __syncwarp();      // lane 0's pushes are visible to the next pop
      }
      // the next pop is the near child, unless the guard below moves sp
      have_next = m.z <= 0 && sp <= STACK_DEPTH - 2;
      // stack-overflow guard, as on the TPU: never write past the stack
      sp = min(sp, STACK_DEPTH - 2);
    }
  }
  t_out[i] = tb;
  prim_out[i] = prim;
  u_out[i] = uu;
  v_out[i] = vv;
  own_nodes = __reduce_add_sync(FULL, own_nodes);
  own_rows = __reduce_add_sync(FULL, own_rows);
  if (lane == 0) {
    int* st = stats + STATS * grp;
    st[0] = visits;
    st[1] = tri_rows;
    st[2] = own_nodes;
    st[3] = own_rows;
    st[4] = static_cast<int>(global_ns() - began);
    st[5] = static_cast<int>(began & 0x3fffffffull);    // ~1 s, wraps
  }
}

}  // namespace

// dpos is scratch for num_blocks ints; stats takes STATS ints per warp
extern "C" int bvh_traverse_launch(
    const void* o, const void* d, const void* valid, const void* block_root,
    const void* t_far, const void* bounds, const void* meta, const void* tri,
    int num_blocks, int num_nodes, int any_hit, void* dpos, void* t_out,
    void* prim_out, void* u_out, void* v_out, void* stats, void* stream) {
  if (num_blocks > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    packet_dpos_kernel<<<num_blocks, PACKET, 0, s>>>(
        static_cast<const float*>(d), static_cast<const int*>(block_root),
        static_cast<int*>(dpos));
    bvh_traverse_kernel<<<num_blocks * (PACKET / BLOCK), BLOCK, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const int*>(valid), static_cast<const int*>(block_root),
        static_cast<const int*>(dpos), static_cast<const float*>(t_far),
        static_cast<const float*>(bounds), static_cast<const int*>(meta),
        static_cast<const float*>(tri), num_nodes, any_hit,
        static_cast<float*>(t_out), static_cast<int*>(prim_out),
        static_cast<float*>(u_out), static_cast<float*>(v_out),
        static_cast<int*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

// threads per traversal block, resident blocks per SM, SMs of the device
extern "C" int bvh_traverse_occupancy(int* block_threads, int* blocks_per_sm,
                                      int* num_sms) {
  *block_threads = BLOCK;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bvh_traverse_kernel, BLOCK, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, dev));
}

extern "C" const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
