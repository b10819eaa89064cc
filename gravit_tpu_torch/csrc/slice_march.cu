// Slice-order volume integration for sm_90a: the whole-brick kernel (K4) and
// the z-window kernel (K5).
//
// Replaces gravit_tpu/ops/slice_march.py::_slice_kernel (K4) and
// ::_slice_slab_kernel (K5), which share ::_march_block as the two entry
// points here share march_window().
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
// What differs from the TPU kernel, and why it is the same function:
//   * The TPU writes the bilinear resample as a hat-weight matrix product
//     because it has no gather. A hat weight max(0, 1-|g-x|) is nonzero at
//     the columns floor(g) and floor(g)+1 only, so a thread gathers the 2x2
//     taps of the two slices itself. The weights are formed as the hat
//     forms them and applied in the product's order: z-lerp each tap, then
//     x, then y.
//   * The TPU's block-wide plane range, its batches of 8 planes and its
//     block-wide early exit only skip planes on which no lane deposits;
//     every deposit is masked per ray. Here ONE THREAD marches ONE RAY: the
//     plane range is per thread (from the ray's own entry and exit z, two
//     planes of margin, then the exact t_in <= t_k < t_out test), and a
//     thread leaves the ladder when its own w reaches 0.99, after which the
//     reference deposits nothing for it either.
//   * K5's windows: window s covers rows [s*(R-1), min(s*(R-1)+R-1, nz-1)]
//     with R = slab_rows; `valid` is half-open in t against the window's
//     own clip, so a plane belongs to one window. The brick is read in
//     place at the window's offset (no stacked copies); color and w stay in
//     the thread's registers from window to window.
//
// What bounds it on the card: fp32 arithmetic per (ray, plane) pair
// (about 110 operations for the plain feature set) against 8 gathered
// floats that neighbouring rays share, so a brick that fits L2 (50 MB) is
// bound by operations; device-memory traffic is the brick once, the 12 ray
// rows in and 4 rows out. This first version does nothing about either:
// rays map to threads in film order, no slice staging in shared memory.
//
// Two diagnostic outputs, written only when their pointers are set (a
// comparison against the plain version sets them, a frame does not): the
// plane of each ray's first crossing, and the marched (ray, plane) pairs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false ...
// --fmad=false and IEEE division/sqrt keep every operation rounded as the
// plain PyTorch version rounds it; powf, sqrtf and floorf are the only
// library calls.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
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
  const float* rays;    // (12, n): ox oy oz dx dy dz corr active r g b w
  const float* S;       // (nz, nS, nL) permuted brick
  const float* tf;      // (256, 4) rgba
  const float* params;  // low high span sp_l sp_s sp_a | 4 per iso |
                        // 12 per subgrid | 5 per slice plane
  float* out;           // (4, n): r g b w
  int* cross_k;         // diagnostic, (n,) or null: plane of the first
                        // iso / slice-plane crossing, -1 if none
  unsigned long long* pairs;  // diagnostic, (1,) or null: marched
                              // (ray, plane) pairs, summed
  const float* const* sub;    // (n_sub,) device table of subgrid bricks
  const int* sub_shape;       // (n_sub, 3) device table: nz nS nL of each
  int n, nz, nS, nL, n_planes, slab_rows;
  int n_iso, n_sub, n_slices;
  float dzg;
};

namespace {

// NaN-propagating min/max, as torch.minimum / torch.maximum
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
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

// two neighbouring slices and their z-lerp weights
struct Slices {
  const float* a;
  const float* b;
  float omf, fz;
  int nL;
};

// sum_y Wy[y] * (sum_x (A[y,x]*(1-fz) + B[y,x]*fz) * Wx[x]) at the taps
__device__ __forceinline__ float bilinear(const Slices& s, const Taps& tx,
                                          const Taps& ty) {
  const int r0 = ty.i0 * s.nL, r1 = ty.i1 * s.nL;
  const float v00 = __ldg(s.a + r0 + tx.i0) * s.omf + __ldg(s.b + r0 + tx.i0) * s.fz;
  const float v01 = __ldg(s.a + r0 + tx.i1) * s.omf + __ldg(s.b + r0 + tx.i1) * s.fz;
  const float v10 = __ldg(s.a + r1 + tx.i0) * s.omf + __ldg(s.b + r1 + tx.i0) * s.fz;
  const float v11 = __ldg(s.a + r1 + tx.i1) * s.omf + __ldg(s.b + r1 + tx.i1) * s.fz;
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

// March one ray through the z-window [off, z_hi] of the brick.
template <bool FEAT>
__device__ void march_window(const MarchArgs& a, const Ray& ray, float off,
                             float z_hi, State& st) {
  const float* __restrict__ P = a.params;
  const int nS = a.nS, nL = a.nL;
  const float ox = ray.ox, oy = ray.oy, oz = ray.oz;
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const float iz = safe_inv(dz), iy = safe_inv(dy), ix = safe_inv(dx);

  float t_in = -BIG, t_out = BIG;
  {
    const float lo[3] = {0.0f, 0.0f, off};
    const float hi[3] = {(float)(nL - 1), (float)(nS - 1), z_hi};
    const float o[3] = {ox, oy, oz};
    const float inv[3] = {ix, iy, iz};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ta = (lo[c] - o[c]) * inv[c];
      const float tb = (hi[c] - o[c]) * inv[c];
      t_in = maxp(t_in, minp(ta, tb));
      t_out = minp(t_out, maxp(ta, tb));
    }
  }
  t_in = maxp(t_in, 0.0f);
  if (!(t_out > t_in)) return;   // no plane can satisfy t_in <= t_k < t_out

  // the thread's own plane range: entry and exit z, two planes of margin;
  // the exact test below decides
  int k_lo = 0, k_hi = a.n_planes;
  {
    const float z0 = oz + t_in * dz, z1 = oz + t_out * dz;
    const float zmin = fminf(z0, z1), zmax = fmaxf(z0, z1);
    if (fabsf(zmin) < 1e9f) k_lo = max(0, (int)floorf(zmin / a.dzg - 0.5f) - 2);
    if (fabsf(zmax) < 1e9f)
      k_hi = min(a.n_planes, (int)ceilf(zmax / a.dzg + 0.5f) + 3);
  }

  const float low = P[P_LOW], span = P[P_SPAN];
  const int ioff = (int)off;
  const int l0_max = max((int)(z_hi - off) - 1, 0);
  const size_t slice_elems = (size_t)nS * nL;
  const int p_sub = P_ISO + 4 * a.n_iso;
  const int p_slc = p_sub + 12 * a.n_sub;

  for (int k = k_lo; k < k_hi; ++k) {
    if (st.w >= OPACITY_TERMINATION) break;
    const float zg = ((float)k + 0.5f) * a.dzg;
    const float t_k = (zg - oz) * iz;
    if (!(t_k >= t_in && t_k < t_out)) continue;
    // valid, and inside (w < 0.99): every later deposit may land
    st.pairs += 1;

    // window-local interpolation row: floor(zg) shifted by the window
    // offset, clamped to the window's rows
    const int l0 = min(max((int)floorf(zg) - ioff, 0), l0_max);
    Slices sl;
    sl.fz = clipf(zg - off - (float)l0, 0.0f, 1.0f);
    sl.omf = 1.0f - sl.fz;
    sl.a = a.S + (size_t)(ioff + l0) * slice_elems;
    sl.b = sl.a + slice_elems;
    sl.nL = nL;
    const float gx_raw = ox + t_k * dx, gy_raw = oy + t_k * dy;
    const float gx = clipf(gx_raw, 0.0f, (float)(nL - 1));
    const float gy = clipf(gy_raw, 0.0f, (float)(nS - 1));
    const Taps tx = hat_taps(gx, nL), ty = hat_taps(gy, nS);
    float s = bilinear(sl, tx, ty);

    if (FEAT) {
      // AMR override, finer grids last: the raw main-grid coordinates map
      // affinely into each subgrid
      for (int si = 0; si < a.n_sub; ++si) {
        const float* q = P + p_sub + 12 * si;
        const int nzs = a.sub_shape[3 * si], nSs = a.sub_shape[3 * si + 1],
                  nLs = a.sub_shape[3 * si + 2];
        const float gxs = q[0] + q[1] * gx_raw;
        const float gys = q[2] + q[3] * gy_raw;
        const float zs = q[4] + q[5] * zg;
        const bool in_sub = gxs >= q[6] && gxs <= q[7] && gys >= q[8] &&
                            gys <= q[9] && zs >= q[10] && zs <= q[11];
        if (in_sub) {
          const int l0s = min(max((int)floorf(zs), 0), nzs - 2);
          Slices ss;
          ss.fz = clipf(zs - (float)l0s, 0.0f, 1.0f);
          ss.omf = 1.0f - ss.fz;
          ss.a = a.sub[si] + (size_t)l0s * nSs * nLs;
          ss.b = ss.a + (size_t)nSs * nLs;
          ss.nL = nLs;
          s = bilinear(ss, hat_taps(clipf(gxs, 0.0f, (float)(nLs - 1)), nLs),
                       hat_taps(clipf(gys, 0.0f, (float)(nSs - 1)), nSs));
        }
      }
    }

    bool inside = true;
    if (FEAT) {
      for (int ii = 0; ii < a.n_iso; ++ii) {
        const float* q = P + P_ISO + 4 * ii;
        const float iso = q[0];
        const bool cross = inside && st.have_prev && !st.crossed &&
                           ((st.s_prev - iso) * (s - iso) <= 0.0f) &&
                           (st.s_prev != s);
        if (cross) {
          // gradient taps on the main grid of THIS plane; z is the
          // backward difference to the previous plane's sample
          const float sxp = bilinear(sl, hat_taps(gx + ISO_H, nL), ty);
          const float sxm = bilinear(sl, hat_taps(gx - ISO_H, nL), ty);
          const float syp = bilinear(sl, tx, hat_taps(gy + ISO_H, nS));
          const float sym = bilinear(sl, tx, hat_taps(gy - ISO_H, nS));
          st.w_pre = st.w;
          st.g_x = (sxp - sxm) / (2.0f * ISO_H);
          st.g_y = (syp - sym) / (2.0f * ISO_H);
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
    }

    // transfer function: 256-entry rgba table, lerp of two rows
    float x = (s - low) / span;
    x = clipf(x, 0.0f, 1.0f) * 255.0f;
    const int i0 = min(max((int)floorf(x), 0), 254);
    const float frac = x - (float)i0;
    const float omfr = 1.0f - frac;
    const float4 c0 = __ldg(reinterpret_cast<const float4*>(a.tf) + i0);
    const float4 c1 = __ldg(reinterpret_cast<const float4*>(a.tf) + i0 + 1);
    const float cr = c0.x * omfr + c1.x * frac;
    const float cg = c0.y * omfr + c1.y * frac;
    const float cb = c0.z * omfr + c1.z * frac;
    const float a_tf = c0.w * omfr + c1.w * frac;

    if (FEAT) {
      if (a.n_slices > 0) {
        const float sp_l = P[P_SP], sp_s = P[P_SP + 1], sp_a = P[P_SP + 2];
        for (int si = 0; si < a.n_slices; ++si) {
          const float* q = P + p_slc + 5 * si;
          const float fA = q[0] + q[1] * ox + q[2] * oy + q[3] * oz;
          const float fB = q[1] * dx + q[2] * dy + q[3] * dz;
          const float fc = fA + fB * t_k;
          const float fp = fA + fB * st.t_prev;
          const bool crs = inside && st.have_prev && (fp * fc <= 0.0f);
          if (crs) {
            const float vn = sqrtf(maxp(
                (dx * sp_l) * (dx * sp_l) + (dy * sp_s) * (dy * sp_s) +
                    (dz * sp_a) * (dz * sp_a),
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

    float al = 1.0f - powf(maxp(1.0f - a_tf, 0.0f), ray.corr);
    if (!inside) al = 0.0f;
    const float fade = (1.0f - st.w) * al;
    st.r = st.r + fade * cr;
    st.g = st.g + fade * cg;
    st.b = st.b + fade * cb;
    st.w = st.w + fade;
    if (FEAT) {
      st.have_prev = true;
      st.s_prev = s;
      st.t_prev = t_k;
    }
  }
}

// headlight lambert at the recorded isosurface crossing
__device__ void finish_iso(const MarchArgs& a, const Ray& ray, State& st) {
  if (!st.crossed) return;
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

__device__ __forceinline__ bool load_ray(const MarchArgs& a, int i, Ray& ray,
                                         State& st) {
  const size_t n = (size_t)a.n;
  const float* __restrict__ r = a.rays;
  ray.ox = r[i];
  ray.oy = r[n + i];
  ray.oz = r[2 * n + i];
  ray.dx = r[3 * n + i];
  ray.dy = r[4 * n + i];
  ray.dz = r[5 * n + i];
  ray.corr = r[6 * n + i];
  st.r = r[8 * n + i];
  st.g = r[9 * n + i];
  st.b = r[10 * n + i];
  st.w = r[11 * n + i];
  st.pairs = 0;
  st.s_prev = st.t_prev = st.w_pre = 0.0f;
  st.g_x = st.g_y = st.g_z = 0.0f;
  st.rec_r = st.rec_g = st.rec_b = 0.0f;
  st.have_prev = st.crossed = false;
  st.cross_k = -1;
  return r[7 * n + i] > 0.5f;
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

// one atomic per warp for the marched-pair count (diagnostic launches)
__device__ __forceinline__ void add_pairs(const MarchArgs& a, int pairs) {
  if (!a.pairs) return;   // uniform over the launch
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) pairs += __shfl_down_sync(0xffffffffu, pairs, d);
  if ((threadIdx.x & 31) == 0 && pairs > 0)
    atomicAdd(a.pairs, (unsigned long long)pairs);
}

// K4: the whole brick, window [0, nz-1]
template <bool FEAT>
__global__ void __launch_bounds__(THREADS)
slice_kernel(const MarchArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int pairs = 0;
  if (i < a.n) {
    Ray ray;
    State st;
    if (load_ray(a, i, ray, st)) {
      march_window<FEAT>(a, ray, 0.0f, (float)(a.nz - 1), st);
      if (FEAT) finish_iso(a, ray, st);
    }
    store_ray(a, i, st);
    pairs = st.pairs;
  }
  add_pairs(a, pairs);
}

// K5: overlapping z-windows of slab_rows rows, front to back, color and w
// carried in registers; a saturated ray skips the remaining windows
__global__ void __launch_bounds__(THREADS)
slice_slab_kernel(const MarchArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int pairs = 0;
  if (i < a.n) {
    Ray ray;
    State st;
    if (load_ray(a, i, ray, st)) {
      const int step_rows = a.slab_rows - 1;
      const int n_slabs = (a.nz - 1 + step_rows - 1) / step_rows;
      for (int s = 0; s < n_slabs; ++s) {
        if (st.w >= OPACITY_TERMINATION) break;
        const float off = (float)(s * step_rows);
        const float z_hi = fminf(off + (float)step_rows, (float)(a.nz - 1));
        march_window<false>(a, ray, off, z_hi, st);
      }
    }
    store_ray(a, i, st);
    pairs = st.pairs;
  }
  add_pairs(a, pairs);
}

}  // namespace

// entry: 0 = K4 plain feature set, 1 = K4 with iso / AMR / slice planes,
// 2 = K5 (z-windows, plain feature set)
extern "C" int slice_march_launch(const MarchArgs* args, int entry,
                                  void* stream) {
  const MarchArgs a = *args;
  if (a.n > 0) {
    const int blocks = (a.n + THREADS - 1) / THREADS;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (entry == 0) {
      slice_kernel<false><<<blocks, THREADS, 0, st>>>(a);
    } else if (entry == 1) {
      slice_kernel<true><<<blocks, THREADS, 0, st>>>(a);
    } else if (entry == 2) {
      slice_slab_kernel<<<blocks, THREADS, 0, st>>>(a);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slice_march_args_size() {
  return static_cast<int>(sizeof(MarchArgs));
}

extern "C" const char* slice_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
