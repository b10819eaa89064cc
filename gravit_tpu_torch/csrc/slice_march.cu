// Slice-order volume integration for sm_90a: the whole-brick kernel (K4) and
// the z-window kernel (K5).
//
// Replaces gravit_tpu/ops/slice_march.py::_slice_kernel (K4) and
// ::_slice_slab_kernel (K5), which share ::_march_block as the two entry
// points here share march_block().
//
// What is computed (per ray, front to back along the permuted march axis):
// clip the ray to the brick (or to one z-window of it); for each plane k,
// zg = (k+0.5)*dzg, t_k = (zg-oz)/dz; if t_in <= t_k < t_out sample the
// z-lerped slice bilinearly, look the sample up in the 256-entry rgba
// table over [low, high], correct the opacity for the oblique path,
// a = 1-(1-a_tf)^corr, and composite while w < 0.99. Optional features
// (whole brick only): AMR subgrid override of the sample, isosurface
// crossings (sign change of s-iso between consecutive samples; gradient
// from x/y half-step taps on the plane and the backward z difference;
// headlight deposit after the ladder) and slice-plane crossings (sign
// change of the affine plane function fA+fB*t).
//
// The TPU writes the bilinear resample as a hat-weight matrix product
// because it has no gather. A hat weight max(0, 1-|g-x|) is nonzero at the
// columns floor(g) and floor(g)+1 only, so a thread gathers the 2x2 taps of
// the two slices itself, with the hat's weights applied in the product's
// order: z-lerp each tap, then x, then y.
//
// What bounds it on the card, and what the design does about it. Per
// marched (ray, plane) pair: 8 gathered floats, a table row, an IEEE
// division, a powf and ~110 fp32 operations, about 250 instructions with
// the tap geometry. In a 512^2 frame a sixth of the tiles hold a ray that
// marches (busy); the others only copy color and w through. Measured on the
// H100 (chip_smoke.py's slice_launch_shape reads the card's clock in every
// block of a launch made as a frame makes it), a launch lasts about as long
// as all its blocks' time spread over the blocks the card holds at once,
// plus the tail of the longest block: a busy 64^3 tile takes ~12 us
// (6 batches), an idle one ~1.5 us, and idle tiles are five times as
// many. So instruction issue and latency per batch, and the blocks resident
// per SM, bound it, far from its byte or fp32 bound. One thread per ray in
// film order (the first port) made each ray's planes one serial chain. This
// version keeps the TPU kernel's schedule (gravit_tpu/ops/slice_march.py,
// PLANE_BATCH) and spreads a batch over threads:
//   * a block is a TILE_W x TILE_H tile of rays of the film when the
//     caller names the film's width (rays in camera lane order), else RAYS
//     consecutive rays; lanes past the film's edge or the ray count are
//     masked. Each ray has BATCH threads, in one warp;
//   * the block marches in lockstep over batches of BATCH planes, aligned
//     at k = 0 as the TPU's are, from the lowest first plane of its live
//     rays; it leaves when no ray is unsaturated with planes left
//     (__syncthreads_or; no thread leaves a loop that holds a barrier);
//   * thread j of a ray samples plane m*BATCH + j, looks it up and takes
//     powf; the ray's threads swap the batch's values by shuffles and each
//     runs the same front-to-back composite, plane by plane, with the exact
//     per-plane valid / inside masks and the iso and slice-plane state
//     machine, so every thread of a ray holds its state. A batch's BATCH
//     chains run on BATCH threads at once. An iso crossing's x/y gradient
//     taps are read after the ladder (finish_iso), off the composite;
//   * a plane's taps are computed one batch ahead and kept in registers;
//     the gathers read the brick through L1. The 2-D tile and the lockstep
//     keep a batch's taps in a box of a few KB (the diagnostics measure
//     it), so they hit L1; copying each box into shared memory (cp.async,
//     double-buffered) was measured slower on the H100 and is not done.
//     AMR subgrid taps are read through L1 too; the 256x4 table is copied
//     into shared memory once per busy block;
//   * __launch_bounds__ holds the registers to MIN_BLOCKS resident blocks
//     per SM (FEAT_MIN_BLOCKS for the feature entry): more blocks hide more
//     of each batch's latency and of the idle tiles'.
// Every ray's sequence of float32 operations is the first port's; only the
// schedule and where the operands live changed.
//
// K5's windows: window s covers rows [s*(R-1), min(s*(R-1)+R-1, nz-1)] with
// R = slab_rows; `valid` is half-open in t against the window's own clip,
// so a plane belongs to one window, and the windows' planes ascend in k.
// So K5 runs ONE ladder of batches over k, as K4 does: each lane finds the
// window of each plane (the one of three neighbours whose clip holds t_k)
// and takes that window's row clamp and z weight, and reads the brick's
// rows in place. The reference's per-window restart (clip, first plane,
// first copy) is gone; every plane sees the same operations as before.
//
// Diagnostic outputs, written only when their pointers are set (a
// comparison against the plain version sets them, a frame does not): the
// plane of each ray's first crossing, the marched (ray, plane) pairs, the
// schedule (busy blocks, batches with a valid tap, the largest box in
// bytes: the grid cells a batch's valid taps touch over the block, reduced
// from the same taps the samples use), and each block's span on the card's
// clock with its batches.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false ...
// --fmad=false and IEEE division/sqrt keep every operation rounded as the
// plain PyTorch version rounds it; powf, sqrtf and floorf are the only
// library calls.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the schedule (ops/slice_march.py mirrors it as TILE and PLANE_BATCH)
constexpr int TILE_W = 8;            // rays
constexpr int TILE_H = 4;
constexpr int RAYS = TILE_W * TILE_H;
constexpr int BATCH = 4;             // planes, one per thread
constexpr int THREADS = RAYS * BATCH;
constexpr int WARPS = THREADS / 32;
// resident blocks per SM that __launch_bounds__ holds the registers to:
// the plain and K5 entries, the feature entry (measured best; 8 spills)
constexpr int MIN_BLOCKS = 7;
constexpr int FEAT_MIN_BLOCKS = 6;
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "tile");
static_assert(32 % BATCH == 0, "a ray's threads lie in one warp");

constexpr float BIG = 1e30f;
constexpr float OPACITY_TERMINATION = 0.99f;
constexpr float ISO_KA = 0.4f;
constexpr float ISO_KD = 0.6f;
constexpr float ISO_H = 0.5f;
// offsets into the scalar table `params`
constexpr int P_LOW = 0, P_SPAN = 2, P_SP = 3, P_ISO = 6;

}  // namespace

// mirrored by ctypes in ops/slice_march.py (natural alignment)
struct MarchArgs {
  // ray rows, read in place: (n,) contiguous each
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* corr;
  const unsigned char* active;  // (n,) bool
  const float* color_in;        // (n, 3) at strides color_s0, color_s1
  const float* w_in;            // (n,) at stride w_s
  const float* S;       // (nz, nS, nL) permuted brick
  const float* tf;      // (256, 4) rgba
  const float* params;  // low high span sp_l sp_s sp_a | 4 per iso |
                        // 12 per subgrid | 5 per slice plane
  float* out;           // (4, n): r g b w
  int* cross_k;         // diagnostic, (n,) or null: plane of the first
                        // iso / slice-plane crossing, -1 if none
  unsigned long long* pairs;  // diagnostic, (1,) or null: marched
                              // (ray, plane) pairs, summed
  unsigned long long* sched;  // diagnostic, (3,) or null: busy blocks,
                              // batches with a valid tap (all read
                              // through L1), the largest box in bytes
  long long* block_ns;        // diagnostic, (blocks, 3) or null: the
                              // block's start and end on the card's clock
                              // (ns), and its batches
  const float* const* sub;    // (n_sub,) device table of subgrid bricks
  const int* sub_shape;       // (n_sub, 3) device table: nz nS nL of each
  long long color_s0, color_s1, w_s;   // element strides
  int n, nz, nS, nL, n_planes, slab_rows;
  int n_iso, n_sub, n_slices;
  int film_width;   // > 0: rays are the film in camera lane order
  float dzg;
};

namespace {

// NaN-propagating min/max, as torch.minimum / torch.maximum: one
// instruction each (min.NaN / max.NaN). Against the plain version they can
// differ only in the sign of a zero, which no result here depends on.
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
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}
__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) < 1e-12f ? (x < 0.0f ? -BIG : BIG) : 1.0f / x;
}

// the two columns where the hat weight over integer x in [0, n-1] can be
// nonzero, with weights (0 outside the grid) and clamped indices
struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps hat_taps(float g, int n) {
  const float f = floorf(g);
  Taps t;
  t.w0 = maxp(1.0f - fabsf(g - f), 0.0f);
  t.w1 = maxp(1.0f - fabsf(g - (f + 1.0f)), 0.0f);
  if (!(f >= 0.0f && f <= (float)(n - 1))) t.w0 = 0.0f;
  if (!(f >= -1.0f && f <= (float)(n - 2))) t.w1 = 0.0f;
  t.i0 = (int)clipf(f, 0.0f, (float)(n - 1));
  t.i1 = (int)clipf(f + 1.0f, 0.0f, (float)(n - 1));
  return t;
}

// sum_y Wy[y] * (sum_x (A[y,x]*(1-fz) + B[y,x]*fz) * Wx[x]) at the taps;
// at(z, y, x) reads row z (0: A, 1: B)
template <class At>
__device__ __forceinline__ float bilinear(const At& at, float omf, float fz,
                                          const Taps& tx, const Taps& ty) {
  const float v00 = at(0, ty.i0, tx.i0) * omf + at(1, ty.i0, tx.i0) * fz;
  const float v01 = at(0, ty.i0, tx.i1) * omf + at(1, ty.i0, tx.i1) * fz;
  const float v10 = at(0, ty.i1, tx.i0) * omf + at(1, ty.i1, tx.i0) * fz;
  const float v11 = at(0, ty.i1, tx.i1) * omf + at(1, ty.i1, tx.i1) * fz;
  const float t0 = v00 * tx.w0 + v01 * tx.w1;
  const float t1 = v10 * tx.w0 + v11 * tx.w1;
  return t0 * ty.w0 + t1 * ty.w1;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, corr;
};

// color, w and the feature state a ray carries along the ladder
struct State {
  float r, g, b, w;
  int pairs;
  // features (whole brick only)
  float s_prev, t_prev, w_pre, g_x, g_y, g_z, rec_r, rec_g, rec_b;
  bool have_prev, crossed;
  int cross_k;
};

// one z-window of the brick: rows [off, z_hi]; window s of a ladder with
// `step` rows between windows starts at s*step. K4's single window is the
// whole brick [0, nz-1].
struct Window {
  float off, z_hi;
  int ioff, l0_max;
};

__device__ __forceinline__ Window window_of(const MarchArgs& a, int step,
                                            int s) {
  Window w;
  w.off = (float)(s * step);
  w.z_hi = fminf(w.off + (float)step, (float)(a.nz - 1));
  w.ioff = (int)w.off;
  w.l0_max = max((int)(w.z_hi - w.off) - 1, 0);
  return w;
}

// a ray against the window ladder: its x/y clip, its z-window count and
// step, and its valid planes [kv_lo, kv_hi) over all windows (the windows'
// valid planes are disjoint intervals, in window order)
struct Lane {
  float iz, t_in_xy, t_out_xy;
  float t_in, t_out;      // the clip of window 0 (K4: the whole brick)
  int step, n_slabs;
  int kv_lo, kv_hi;
};

// the ray's t range in window w, as the first port clipped it: x, then y,
// then the window's z slab, then t >= 0
__device__ __forceinline__ void window_t(const Ray& r, const Lane& ln,
                                         const Window& w, float& t_in,
                                         float& t_out) {
  const float ta = (w.off - r.oz) * ln.iz;
  const float tb = (w.z_hi - r.oz) * ln.iz;
  t_in = maxp(maxp(ln.t_in_xy, minp(ta, tb)), 0.0f);
  t_out = minp(ln.t_out_xy, maxp(ta, tb));
}

__device__ __forceinline__ bool plane_in(const MarchArgs& a, const Ray& r,
                                         float iz, float t_in, float t_out,
                                         int k) {
  const float zg = ((float)k + 0.5f) * a.dzg;
  const float t_k = (zg - r.oz) * iz;
  return t_k >= t_in && t_k < t_out;
}

// the valid planes of one window: entry and exit z with two planes of
// margin, then the exact test from both ends (t_k is monotone in k, so the
// valid planes are one interval)
__device__ __forceinline__ void window_planes(const MarchArgs& a,
                                              const Ray& r, float iz,
                                              float t_in, float t_out,
                                              int& lo, int& hi) {
  lo = hi = 0;
  if (!(t_out > t_in)) return;  // no plane satisfies t_in <= t_k < t_out
  int k_lo = 0, k_hi = a.n_planes;
  const float z0 = r.oz + t_in * r.dz, z1 = r.oz + t_out * r.dz;
  const float zmin = fminf(z0, z1), zmax = fmaxf(z0, z1);
  if (fabsf(zmin) < 1e9f) k_lo = max(0, (int)floorf(zmin / a.dzg - 0.5f) - 2);
  if (fabsf(zmax) < 1e9f)
    k_hi = min(a.n_planes, (int)ceilf(zmax / a.dzg + 0.5f) + 3);
  while (k_lo < k_hi && !plane_in(a, r, iz, t_in, t_out, k_lo)) ++k_lo;
  while (k_hi > k_lo && !plane_in(a, r, iz, t_in, t_out, k_hi - 1)) --k_hi;
  lo = k_lo;
  hi = k_hi;
}

template <bool WINDOWS>
__device__ __forceinline__ Lane make_lane(const MarchArgs& a, const Ray& r,
                                          bool ok) {
  Lane ln;
  ln.iz = safe_inv(r.dz);
  ln.step = WINDOWS ? a.slab_rows - 1 : a.nz - 1;
  ln.n_slabs = WINDOWS ? (a.nz - 1 + ln.step - 1) / ln.step : 1;
  ln.kv_lo = INT_MAX;
  ln.kv_hi = INT_MIN;
  {
    const float ix = safe_inv(r.dx), iy = safe_inv(r.dy);
    const float ta = (0.0f - r.ox) * ix, tb = ((float)(a.nL - 1) - r.ox) * ix;
    const float tc = (0.0f - r.oy) * iy, td = ((float)(a.nS - 1) - r.oy) * iy;
    ln.t_in_xy = maxp(maxp(-BIG, minp(ta, tb)), minp(tc, td));
    ln.t_out_xy = minp(minp(BIG, maxp(ta, tb)), maxp(tc, td));
  }
  window_t(r, ln, window_of(a, ln.step, 0), ln.t_in, ln.t_out);
  if (!ok) return ln;
  int s_lo = 0, s_hi = ln.n_slabs - 1;
  if (WINDOWS) {
    // the windows the ray's z range within the whole brick touches, one of
    // margin each side
    Window whole;
    whole.off = 0.0f;
    whole.z_hi = (float)(a.nz - 1);
    float T_in, T_out;
    window_t(r, ln, whole, T_in, T_out);
    if (!(T_out > T_in)) return ln;
    const float z0 = r.oz + T_in * r.dz, z1 = r.oz + T_out * r.dz;
    const float zmin = fminf(z0, z1), zmax = fmaxf(z0, z1);
    if (fabsf(zmin) < 1e9f)
      s_lo = max(0, (int)floorf(zmin / (float)ln.step) - 1);
    if (fabsf(zmax) < 1e9f)
      s_hi = min(ln.n_slabs - 1, (int)floorf(zmax / (float)ln.step) + 1);
  }
  for (int s = s_lo; s <= s_hi; ++s) {
    float t_in, t_out;
    window_t(r, ln, window_of(a, ln.step, s), t_in, t_out);
    int lo, hi;
    window_planes(a, r, ln.iz, t_in, t_out, lo, hi);
    if (lo < hi) {
      ln.kv_lo = min(ln.kv_lo, lo);
      ln.kv_hi = max(ln.kv_hi, hi);
    }
  }
  return ln;
}

// plane k's sample position, brick row, z weights and taps for one ray,
// computed without a branch on the plane (so a batch's planes interleave);
// `valid` says whether the ray samples the plane (in K5: in the one window
// whose clip holds t_k). For an invalid plane every index still lies in
// the grid and in a window's rows.
struct Plane {
  float zg, t_k, gx_raw, gy_raw, gx, gy, fz, omf;
  int row;        // the lower interpolation row in the brick
  Taps tx, ty;
  bool valid;
};

template <bool WINDOWS>
__device__ __forceinline__ Plane plane_at(const MarchArgs& a, const Ray& r,
                                          const Lane& ln, int k) {
  Plane p;
  p.zg = ((float)k + 0.5f) * a.dzg;
  p.t_k = (p.zg - r.oz) * ln.iz;
  Window wn;
  if (WINDOWS) {
    // the window of plane k is the one of s0-1, s0, s0+1 whose clip holds
    // t_k (at most one does)
    const int s0 = min(max((int)floorf(p.zg / (float)ln.step), 0),
                       ln.n_slabs - 1);
    int sel = s0;
    bool in = false;
#pragma unroll
    for (int d = -1; d <= 1; ++d) {
      const int s = min(max(s0 + d, 0), ln.n_slabs - 1);
      float t_in, t_out;
      window_t(r, ln, window_of(a, ln.step, s), t_in, t_out);
      const bool hit = p.t_k >= t_in && p.t_k < t_out;
      sel = hit ? s : sel;
      in = in || hit;
    }
    wn = window_of(a, ln.step, sel);
    p.valid = in;
  } else {
    wn = window_of(a, ln.step, 0);
    p.valid = p.t_k >= ln.t_in && p.t_k < ln.t_out;
  }
  p.valid = p.valid && k >= ln.kv_lo && k < ln.kv_hi;
  // window-local interpolation row: floor(zg) shifted by the window
  // offset, clamped to the window's rows
  const int l0 = min(max((int)floorf(p.zg) - wn.ioff, 0), wn.l0_max);
  p.row = wn.ioff + l0;
  p.fz = clipf(p.zg - wn.off - (float)l0, 0.0f, 1.0f);
  p.omf = 1.0f - p.fz;
  p.gx_raw = r.ox + p.t_k * r.dx;
  p.gy_raw = r.oy + p.t_k * r.dy;
  p.gx = clipf(p.gx_raw, 0.0f, (float)(a.nL - 1));
  p.gy = clipf(p.gy_raw, 0.0f, (float)(a.nS - 1));
  p.tx = hat_taps(p.gx, a.nL);
  p.ty = hat_taps(p.gy, a.nS);
  return p;
}

// the iso gradient's half-step taps of a plane
struct IsoTaps {
  Taps xp, xm, yp, ym;
};

__device__ __forceinline__ IsoTaps iso_taps(const MarchArgs& a,
                                            const Plane& p) {
  IsoTaps q;
  q.xp = hat_taps(p.gx + ISO_H, a.nL);
  q.xm = hat_taps(p.gx - ISO_H, a.nL);
  q.yp = hat_taps(p.gy + ISO_H, a.nS);
  q.ym = hat_taps(p.gy - ISO_H, a.nS);
  return q;
}

// a plane's bilinear sample at taps (tx, ty), read through L1
__device__ __forceinline__ float sample_at(const MarchArgs& a, const Plane& p,
                                           const Taps& tx, const Taps& ty) {
  const float* A = a.S + (size_t)p.row * a.nS * a.nL;
  const size_t zs = (size_t)a.nS * a.nL;
  const int nL = a.nL;
  auto at = [=](int z, int y, int x) {
    return __ldg(A + z * zs + (size_t)y * nL + x);
  };
  return bilinear(at, p.omf, p.fz, tx, ty);
}

// extents of grid cells, reduced over the block
struct Ext {
  int zmn, zmx, ymn, ymx, xmn, xmx;
};

__device__ __forceinline__ Ext empty_ext() {
  return Ext{INT_MAX, INT_MIN, INT_MAX, INT_MIN, INT_MAX, INT_MIN};
}

__device__ __forceinline__ void grow(Ext& e, int z, int z1, const Taps& x0,
                                     const Taps& x1, const Taps& y0,
                                     const Taps& y1) {
  e.zmn = min(e.zmn, z);
  e.zmx = max(e.zmx, z1);
  e.xmn = min(e.xmn, min(x0.i0, x1.i0));
  e.xmx = max(e.xmx, max(x0.i1, x1.i1));
  e.ymn = min(e.ymn, min(y0.i0, y1.i0));
  e.ymx = max(e.ymx, max(y0.i1, y1.i1));
}

// block-wide extents (one barrier); every thread gets the result
__device__ __forceinline__ Ext reduce_ext(Ext e, int (*s_red)[6]) {
  const unsigned full = 0xffffffffu;
  e.zmn = __reduce_min_sync(full, e.zmn);
  e.zmx = __reduce_max_sync(full, e.zmx);
  e.ymn = __reduce_min_sync(full, e.ymn);
  e.ymx = __reduce_max_sync(full, e.ymx);
  e.xmn = __reduce_min_sync(full, e.xmn);
  e.xmx = __reduce_max_sync(full, e.xmx);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_red[warp][0] = e.zmn;
    s_red[warp][1] = e.zmx;
    s_red[warp][2] = e.ymn;
    s_red[warp][3] = e.ymx;
    s_red[warp][4] = e.xmn;
    s_red[warp][5] = e.xmx;
  }
  __syncthreads();
  Ext r = empty_ext();
#pragma unroll
  for (int q = 0; q < WARPS; ++q) {
    r.zmn = min(r.zmn, s_red[q][0]);
    r.zmx = max(r.zmx, s_red[q][1]);
    r.ymn = min(r.ymn, s_red[q][2]);
    r.ymx = max(r.ymx, s_red[q][3]);
    r.xmn = min(r.xmn, s_red[q][4]);
    r.xmx = max(r.xmx, s_red[q][5]);
  }
  return r;
}

// what the sample of a plane needs, kept from one batch to the next (the
// plain feature set; with features the sample takes plane_at again)
struct Tap {
  int row;
  float fz;
  Taps tx, ty;
  bool valid;
};

// This thread's plane of batch m (plane m*BATCH + j for the thread's ray):
// its taps into `tap`, valid where the ray is live. With the schedule's
// diagnostics (a.sched, uniform over the launch; one barrier) it returns
// the bytes of the batch's box over the block, else 0: the grid cells its
// valid taps touch (rows row .. row+1, the y and x tap columns; with iso
// the +-ISO_H taps too), from those same taps.
template <bool FEAT, bool WINDOWS>
__device__ __forceinline__ int batch_taps(const MarchArgs& a, const Ray& ray,
                                          const Lane& ln, bool lane_live,
                                          int m, int j, int (*s_red)[6],
                                          Tap& tap) {
  const Plane p = plane_at<WINDOWS>(a, ray, ln, m * BATCH + j);
  tap = Tap{p.row, p.fz, p.tx, p.ty, lane_live && p.valid};
  if (!a.sched) return 0;
  Ext e = empty_ext();
  if (tap.valid) {
    grow(e, p.row, p.row + 1, p.tx, p.tx, p.ty, p.ty);
    if (FEAT && a.n_iso > 0) {   // the gradient's half-step taps
      const IsoTaps q = iso_taps(a, p);
      grow(e, p.row, p.row + 1, q.xm, q.xp, q.ym, q.yp);
    }
  }
  e = reduce_ext(e, s_red);
  if (e.zmn > e.zmx) return 0;
  return (e.zmx - e.zmn + 1) * (e.ymx - e.ymn + 1) * (e.xmx - e.xmn + 1) * 4;
}

// one plane's sample, table colour and corrected opacity
struct Sampled {
  float s, cr, cg, cb, al, tk;
  bool v;
};

// Sample this thread's plane of the batch: an invalid plane reads the
// brick's first cells (one line the block shares) and is masked in the
// composite.
template <bool FEAT, bool WINDOWS>
__device__ __forceinline__ Sampled sample_plane(
    const MarchArgs& a, const Ray& ray, const Lane& ln, const float4* s_tf,
    bool unsat, int k, const Tap& tap) {
  const float* __restrict__ P = a.params;
  const float low = P[P_LOW], span = P[P_SPAN];
  Sampled o;
  Plane p;
  if (FEAT) {
    p = plane_at<WINDOWS>(a, ray, ln, k);
  } else {
    p.row = tap.row;
    p.fz = tap.fz;
    p.omf = 1.0f - p.fz;
    p.tx = tap.tx;
    p.ty = tap.ty;
    p.t_k = 0.0f;
  }
  o.v = unsat && tap.valid;
  if (!o.v) {
    p.row = 0;
    p.tx.i0 = p.tx.i1 = 0;
    p.ty.i0 = p.ty.i1 = 0;
  }
  float s = sample_at(a, p, p.tx, p.ty);
  if (FEAT && o.v) {
    // AMR override, finer grids last: the raw main-grid coordinates map
    // affinely into each subgrid
    const int p_sub = P_ISO + 4 * a.n_iso;
    for (int si = 0; si < a.n_sub; ++si) {
      const float* q = P + p_sub + 12 * si;
      const int nzs = a.sub_shape[3 * si], nSs = a.sub_shape[3 * si + 1],
                nLs = a.sub_shape[3 * si + 2];
      const float gxs = q[0] + q[1] * p.gx_raw;
      const float gys = q[2] + q[3] * p.gy_raw;
      const float zs = q[4] + q[5] * p.zg;
      const bool in_sub = gxs >= q[6] && gxs <= q[7] && gys >= q[8] &&
                          gys <= q[9] && zs >= q[10] && zs <= q[11];
      if (in_sub) {
        const int l0s = min(max((int)floorf(zs), 0), nzs - 2);
        const float fzs = clipf(zs - (float)l0s, 0.0f, 1.0f);
        const float* A = a.sub[si] + (size_t)l0s * nSs * nLs;
        const size_t plane_elems = (size_t)nSs * nLs;
        auto at = [&](int z, int y, int x) {
          return __ldg(A + z * plane_elems + (size_t)y * nLs + x);
        };
        s = bilinear(at, 1.0f - fzs, fzs,
                     hat_taps(clipf(gxs, 0.0f, (float)(nLs - 1)), nLs),
                     hat_taps(clipf(gys, 0.0f, (float)(nSs - 1)), nSs));
      }
    }
  }
  // transfer function: 256-entry rgba table, lerp of two rows
  float x = (s - low) / span;
  x = clipf(x, 0.0f, 1.0f) * 255.0f;
  const int i0 = min(max((int)floorf(x), 0), 254);
  const float frac = x - (float)i0;
  const float omfr = 1.0f - frac;
  const float4 c0 = s_tf[i0];
  const float4 c1 = s_tf[i0 + 1];
  o.s = s;
  o.tk = p.t_k;
  o.cr = c0.x * omfr + c1.x * frac;
  o.cg = c0.y * omfr + c1.y * frac;
  o.cb = c0.z * omfr + c1.z * frac;
  const float a_tf = c0.w * omfr + c1.w * frac;
  o.al = 1.0f - powf(maxp(1.0f - a_tf, 0.0f), ray.corr);
  return o;
}

// the block's schedule counts (identical in every thread): busy, batches
// run, and with the diagnostics the batches with a valid tap and the
// largest box
struct Sched {
  bool busy;
  unsigned batches, boxed, max_box;
};

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One plane of the batch in the composite: plane k's values from lane
// `src` (the ray's thread that sampled it), then the front-to-back step.
template <bool FEAT>
__device__ __forceinline__ void composite_plane(const MarchArgs& a,
                                                const Ray& ray, int k, int src,
                                                const Sampled& mine,
                                                State& st) {
  const float* __restrict__ P = a.params;
  const unsigned full = 0xffffffffu;
  const int p_slc = P_ISO + 4 * a.n_iso + 12 * a.n_sub;
  const bool v = __shfl_sync(full, (int)mine.v, src) != 0;
  const float s = __shfl_sync(full, mine.s, src);
  const float cr = __shfl_sync(full, mine.cr, src);
  const float cg = __shfl_sync(full, mine.cg, src);
  const float cb = __shfl_sync(full, mine.cb, src);
  const float al_j = __shfl_sync(full, mine.al, src);
  const float tk = FEAT ? __shfl_sync(full, mine.tk, src) : 0.0f;
  if (!v || st.w >= OPACITY_TERMINATION) return;
  // valid, and inside (w < 0.99): every later deposit may land
  st.pairs += 1;
  bool inside = true;
  if (FEAT) {
    for (int ii = 0; ii < a.n_iso; ++ii) {
      const float* q = P + P_ISO + 4 * ii;
      const float iso = q[0];
      const bool cross = inside && st.have_prev && !st.crossed &&
                         ((st.s_prev - iso) * (s - iso) <= 0.0f) &&
                         (st.s_prev != s);
      if (cross) {
        // z of the gradient is the backward difference to the previous
        // plane's sample; its x/y half-step taps on this plane's main grid
        // are read after the ladder (finish_iso: plane cross_k)
        st.w_pre = st.w;
        st.g_z = (s - st.s_prev) / a.dzg;
        st.rec_r = q[1];
        st.rec_g = q[2];
        st.rec_b = q[3];
        st.cross_k = k;
        st.crossed = true;
        st.w = 1.0f;
      }
    }
    inside = inside && (st.w < OPACITY_TERMINATION);
    if (a.n_slices > 0) {
      const float sp_l = P[P_SP], sp_s = P[P_SP + 1], sp_a = P[P_SP + 2];
      for (int si = 0; si < a.n_slices; ++si) {
        const float* q = P + p_slc + 5 * si;
        const float fA = q[0] + q[1] * ray.ox + q[2] * ray.oy +
                         q[3] * ray.oz;
        const float fB = q[1] * ray.dx + q[2] * ray.dy + q[3] * ray.dz;
        const float fc = fA + fB * tk;
        const float fp = fA + fB * st.t_prev;
        const bool crs = inside && st.have_prev && (fp * fc <= 0.0f);
        if (crs) {
          const float vn = sqrtf(maxp(
              (ray.dx * sp_l) * (ray.dx * sp_l) +
                  (ray.dy * sp_s) * (ray.dy * sp_s) +
                  (ray.dz * sp_a) * (ray.dz * sp_a),
              1e-30f));
          const float ndv = fabsf(fB) / maxp(q[4] * vn, 1e-30f);
          const float shade = ISO_KA + ISO_KD * ndv;
          const float fade = 1.0f - st.w;
          st.r = st.r + fade * cr * shade;
          st.g = st.g + fade * cg * shade;
          st.b = st.b + fade * cb * shade;
          st.cross_k = k;
          st.w = 1.0f;
        }
      }
      inside = inside && (st.w < OPACITY_TERMINATION);
    }
  }
  const float al = inside ? al_j : 0.0f;
  const float fade = (1.0f - st.w) * al;
  st.r = st.r + fade * cr;
  st.g = st.g + fade * cg;
  st.b = st.b + fade * cb;
  st.w = st.w + fade;
  if (FEAT) {
    st.have_prev = true;
    st.s_prev = s;
    st.t_prev = tk;
  }
}

// March the block's rays through the brick (K5: its window ladder), batch
// by batch in lockstep. Thread j of a ray's BATCH threads takes plane
// m*BATCH + j of each batch; the ray's threads then swap their planes'
// values by shuffles and run the same composite, so they hold the same
// state. Every thread of the block calls it and reaches every barrier.
template <bool FEAT, bool WINDOWS>
__device__ __forceinline__ void march_block(const MarchArgs& a,
                                            const Ray& ray, bool ok,
                                            State& st, Sched& sc,
                                            float4* s_tf, int (*s_red)[6],
                                            int* s_kmin) {
  const int j = threadIdx.x % BATCH;
  const unsigned full = 0xffffffffu;
  const int lane0 = (threadIdx.x & 31) - j;   // the ray's first lane
  const Lane ln = make_lane<WINDOWS>(a, ray, ok);
  const bool live0 =
      ok && st.w < OPACITY_TERMINATION && ln.kv_lo < ln.kv_hi;
  // the block's first plane: min over its live lanes (one barrier)
  {
    const int v = __reduce_min_sync(full, live0 ? ln.kv_lo : INT_MAX);
    if ((threadIdx.x & 31) == 0) s_kmin[threadIdx.x >> 5] = v;
  }
  __syncthreads();
  int kmin = INT_MAX;
#pragma unroll
  for (int q = 0; q < WARPS; ++q) kmin = min(kmin, s_kmin[q]);
  if (kmin == INT_MAX) return;   // no live lane: uniform over the block
  sc.busy = true;
  // the table, once per busy block; the loop's first barrier publishes it
  for (int q = threadIdx.x; q < 256; q += THREADS)
    s_tf[q] = __ldg(reinterpret_cast<const float4*>(a.tf) + q);

  int m = kmin / BATCH;
  Tap cur_tap, nxt_tap;
  int cur_bytes =
      batch_taps<FEAT, WINDOWS>(a, ray, ln, live0, m, j, s_red, cur_tap);
  for (;; ++m) {
    const int kb = m * BATCH;
    const bool unsat = ok && st.w < OPACITY_TERMINATION;
    if (!__syncthreads_or(unsat && ln.kv_hi > kb && ln.kv_lo < ln.kv_hi))
      break;
    // batch m+1's taps, computed beside batch m's gathers
    const int nxt_bytes = batch_taps<FEAT, WINDOWS>(a, ray, ln, unsat, m + 1,
                                                    j, s_red, nxt_tap);
    ++sc.batches;
    if (cur_bytes > 0) {
      ++sc.boxed;
      sc.max_box = max(sc.max_box, (unsigned)cur_bytes);
    }

    // this thread's plane: sample, table, opacity correction
    const Sampled mine = sample_plane<FEAT, WINDOWS>(a, ray, ln, s_tf, unsat,
                                                     kb + j, cur_tap);

    // front-to-back composite over the ray's BATCH planes, in every one
    // of its threads, with the exact masks (the feature set's plane is
    // long: not unrolled)
    if (FEAT) {
#pragma unroll 1
      for (int jj = 0; jj < BATCH; ++jj)
        composite_plane<FEAT>(a, ray, kb + jj, lane0 + jj, mine, st);
    } else {
#pragma unroll
      for (int jj = 0; jj < BATCH; ++jj)
        composite_plane<FEAT>(a, ray, kb + jj, lane0 + jj, mine, st);
    }
    cur_bytes = nxt_bytes;
    cur_tap = nxt_tap;
  }
}

// headlight lambert at the recorded isosurface crossing. After a crossing
// w is 1 and no later plane is inside, so cross_k is the iso crossing's
// plane; its x/y gradient taps are read here, off the composite, with the
// operations the ladder would have done there.
__device__ void finish_iso(const MarchArgs& a, const Ray& ray, State& st) {
  if (!st.crossed) return;
  {
    const Lane ln = make_lane<false>(a, ray, true);
    const Plane p = plane_at<false>(a, ray, ln, st.cross_k);
    const IsoTaps h = iso_taps(a, p);
    const float sxp = sample_at(a, p, h.xp, p.ty);
    const float sxm = sample_at(a, p, h.xm, p.ty);
    const float syp = sample_at(a, p, p.tx, h.yp);
    const float sym = sample_at(a, p, p.tx, h.ym);
    st.g_x = (sxp - sxm) / (2.0f * ISO_H);
    st.g_y = (syp - sym) / (2.0f * ISO_H);
  }
  const float sp_l = a.params[P_SP], sp_s = a.params[P_SP + 1],
              sp_a = a.params[P_SP + 2];
  const float qx = st.g_x / sp_l, qy = st.g_y / sp_s, qz = st.g_z / sp_a;
  const float dot = st.g_x * ray.dx + st.g_y * ray.dy + st.g_z * ray.dz;
  const float gn = sqrtf(maxp(qx * qx + qy * qy + qz * qz, 1e-30f));
  const float vn = sqrtf(maxp((ray.dx * sp_l) * (ray.dx * sp_l) +
                                  (ray.dy * sp_s) * (ray.dy * sp_s) +
                                  (ray.dz * sp_a) * (ray.dz * sp_a),
                              1e-30f));
  const float ndv = fabsf(dot) / (gn * vn);
  const float shade = ISO_KA + ISO_KD * ndv;
  const float fade = 1.0f - st.w_pre;
  st.r = st.r + fade * st.rec_r * shade;
  st.g = st.g + fade * st.rec_g * shade;
  st.b = st.b + fade * st.rec_b * shade;
}

// the ray this thread's group marches in `tile`: a pixel of a film tile,
// or one of RAYS consecutive rays; -1 past the film's edge or the ray count
__device__ __forceinline__ int ray_of(const MarchArgs& a, int tile) {
  const int slot = threadIdx.x / BATCH;
  long long i;
  if (a.film_width > 0) {
    const int W = a.film_width;
    const int tiles_x = (W + TILE_W - 1) / TILE_W;
    const int col = (tile % tiles_x) * TILE_W + slot % TILE_W;
    const int row = (tile / tiles_x) * TILE_H + slot / TILE_W;
    if (col >= W) return -1;
    i = (long long)row * W + col;
  } else {
    i = (long long)tile * RAYS + slot;
  }
  return i < a.n ? (int)i : -1;
}

__device__ __forceinline__ bool load_ray(const MarchArgs& a, int i, Ray& ray,
                                         State& st) {
  ray.ox = a.ox[i];
  ray.oy = a.oy[i];
  ray.oz = a.oz[i];
  ray.dx = a.dx[i];
  ray.dy = a.dy[i];
  ray.dz = a.dz[i];
  ray.corr = a.corr[i];
  const float* c = a.color_in + i * a.color_s0;
  st.r = c[0];
  st.g = c[a.color_s1];
  st.b = c[2 * a.color_s1];
  st.w = a.w_in[i * a.w_s];
  return a.active[i] != 0;
}

__device__ __forceinline__ void store_ray(const MarchArgs& a, int i,
                                          const State& st) {
  const size_t n = (size_t)a.n;
  a.out[i] = st.r;
  a.out[n + i] = st.g;
  a.out[2 * n + i] = st.b;
  a.out[3 * n + i] = st.w;
  if (a.cross_k) a.cross_k[i] = st.cross_k;
}

// One tile of rays, from loading its rays to storing them. Every thread of
// the block calls it and reaches every barrier.
template <bool FEAT, bool WINDOWS>
__device__ __forceinline__ void march_tile(const MarchArgs& a, int tile,
                                           float4* s_tf, int (*s_red)[6],
                                           int* s_kmin) {
  long long t_start = 0;
  if (a.block_ns) t_start = globaltimer();
  const int i = ray_of(a, tile);
  Ray ray{};
  State st{};
  st.cross_k = -1;
  bool ok = false;
  if (i >= 0) ok = load_ray(a, i, ray, st);
  Sched sc{false, 0u, 0u, 0u};
  march_block<FEAT, WINDOWS>(a, ray, ok, st, sc, s_tf, s_red, s_kmin);
  if (FEAT && ok) finish_iso(a, ray, st);
  const bool first = threadIdx.x % BATCH == 0;   // one thread per ray writes
  if (i >= 0 && first) store_ray(a, i, st);

  if (a.pairs) {   // uniform over the launch; one atomic per warp
    int pairs = first ? st.pairs : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      pairs += __shfl_down_sync(0xffffffffu, pairs, d);
    if ((threadIdx.x & 31) == 0 && pairs > 0)
      atomicAdd(a.pairs, (unsigned long long)pairs);
  }
  if (a.block_ns && threadIdx.x == 0) {
    long long* q = a.block_ns + 3 * (size_t)tile;
    q[0] = t_start;
    q[1] = globaltimer();
    q[2] = sc.batches;
  }
  if (a.sched && threadIdx.x == 0) {
    if (sc.busy) atomicAdd(a.sched, 1ull);
    if (sc.boxed) atomicAdd(a.sched + 1, (unsigned long long)sc.boxed);
    atomicMax(a.sched + 2, (unsigned long long)sc.max_box);
  }
}

// K4 (WINDOWS false: the whole brick, window [0, nz-1]) and K5 (WINDOWS
// true: overlapping z-windows of slab_rows rows; a plane is sampled in the
// window whose clip holds it, so one front-to-back loop over the planes
// serves the whole ladder). Block b marches tile b.
template <bool FEAT, bool WINDOWS>
__global__ void __launch_bounds__(THREADS,
                                  FEAT ? FEAT_MIN_BLOCKS : MIN_BLOCKS)
slice_kernel(const MarchArgs a) {
  __shared__ float4 s_tf[256];
  __shared__ int s_red[WARPS][6];
  __shared__ int s_kmin[WARPS];
  march_tile<FEAT, WINDOWS>(a, blockIdx.x, s_tf, s_red, s_kmin);
}

using KernelFn = void (*)(const MarchArgs);

KernelFn kernel_of(int entry) {
  switch (entry) {
    case 0: return slice_kernel<false, false>;
    case 1: return slice_kernel<true, false>;
    case 2: return slice_kernel<false, true>;
    default: return nullptr;
  }
}

int num_tiles(const MarchArgs& a) {
  if (a.film_width <= 0) return (a.n + RAYS - 1) / RAYS;
  const long long W = a.film_width;
  const long long rows = (a.n + W - 1) / W;
  return (int)(((W + TILE_W - 1) / TILE_W) * ((rows + TILE_H - 1) / TILE_H));
}

}  // namespace

// entry: 0 = K4 plain feature set, 1 = K4 with iso / AMR / slice planes,
// 2 = K5 (z-windows, plain feature set)
extern "C" int slice_march_launch(const MarchArgs* args, int entry,
                                  void* stream) {
  const MarchArgs a = *args;
  const KernelFn fn = kernel_of(entry);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n > 0)
    fn<<<num_tiles(a), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slice_march_args_size() {
  return static_cast<int>(sizeof(MarchArgs));
}

// how an entry sits on the current card: threads per block, registers per
// thread, shared memory per block, local memory per thread (spills),
// resident blocks per SM, SMs
extern "C" int slice_march_occupancy(int entry, int* out) {
  const KernelFn fn = kernel_of(entry);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = THREADS;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  out[5] = sms;
  return 0;
}

extern "C" const char* slice_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
