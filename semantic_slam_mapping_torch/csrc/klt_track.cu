// Pyramidal Lucas-Kanade tracking of a batch of features, for Hopper
// (sm_90a): one launch runs every feature of every frame through every
// pyramid level and every iteration.
//
// Replaces no TPU kernel: the JAX package's ops/klt.py is plain jnp, which
// XLA fuses on the TPU. In the port the same algorithm as plain PyTorch
// (ops/klt.py::track_pyramid_plain) is about 110 small launches an
// iteration, 20 iterations a level, 3 levels a leg and 4 legs a frame pair:
// some 940 launches a frame, each moving under a kilobyte, which the host
// issues slower than the card runs them. This kernel does one leg of the
// quad match in one launch.
//
// Contract (the plain version's, in float32). For each feature, coarsest
// level first, with pt0 = pt / 2^level and g the flow guess (init /
// 2^(levels-1) at the coarsest level, twice the last level's flow below):
//
//   - the template patch and the two gradient patches are bilinear samples
//     of the template level and of its Scharr gradients (im.gradients) at
//     pt0 - r + (l, k), read through the integer window corner
//     floor(pt0) - r - 1 and the offset frac(pt0) + 1; a tap outside the
//     image reads 0; every tap is
//       (1-ay)((1-ax) t00 + ax t01) + ay((1-ax) t10 + ax t11);
//   - G = [[gxx, gxy], [gxy, gyy]] sums the gradient products; its least
//     eigenvalue over the window's n = win^2 pixels must pass the gate,
//     else the feature is frozen at its guess; 1/det with |det| >= 1e-12;
//   - max_iterations steps: the target patch at the corner
//     floor(pt0 + guess) - r - kMargin and offset pt0 + g - corner - r, the
//     residual against the template patch, b = (sum r gx, sum r gy),
//     step = -G^-1 b, g = clamp(g + step, guess -+ (kMargin - 1)) until a
//     step under epsilon has converged the feature;
//   - at the finest level the mean |residual| of the final patch.
//
// Then xy = pt + flow and status = every level passed the gate and xy lies
// in [1, W - 2] x [1, H - 2] of the finest level. Every product, sum and
// quotient of a single value is one float32 operation rounded to nearest,
// in the plain version's order (no contraction into fused multiply-adds),
// so the taps, the 2x2 solve, the clamp and the gates round as PyTorch's
// elementwise kernels round them. The window sums are taken in another
// order than torch.sum's, so a sum may differ in its last bits, and a
// convergence test or the eigenvalue gate can then flip for a feature at
// its threshold (tests/test_torch_klt_cuda.py states the tolerances).
// A converged or frozen feature no longer moves, so the kernel stops its
// iterations there; the plain version runs them all and discards them.
//
// Design. One warp a feature. The window's n pixels go over the lanes,
// kPer = ceil(n / 32) a lane (4 for the 11x11 window: 121 of 128 slots);
// each lane keeps its template and gradient samples in registers over a
// level's iterations, and the sums are xor-butterfly shuffles, which leave
// the same bits in every lane, so the solve, the clamp and the convergence
// test are computed by every lane alike and branch uniformly. The feature's
// state (g, the 2x2 system, the gate) lives in registers over all levels;
// nothing goes through device memory between iterations, and lane 0 writes
// the three outputs once. Blocks of kWarps warps; a frame and its feature
// come from the warp's index, so a batch of frames is one launch.
//
// Bounds on an NVIDIA H100 (700 W) at the window's 32 frames x 512
// features, 3 levels, 11x11: the patches touched (template, gx, gy and the
// target, 12x12 float32 each, a feature a level) are 113 MB, 34 us at 3.35
// TB/s; the operations (about 325 float32 operations a pixel a level at 20
// iterations) are 1.9 GFLOP, 29 us at 67 TFLOP/s. Neither bounds it: a
// feature's iterations are a chain of dependent steps (taps read from L1 or
// L2, a five-step shuffle sum, the solve), a few hundred cycles each, and
// the parallelism to hide that latency is the number of warps resident,
// which the registers of a lane bound. The design keeps a lane's state to
// 3 kPer samples and the shared-nothing warp, so an SM holds up to 64
// warps, and the early stop at convergence shortens the chain.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxPer = 8;  // pixels a lane: windows up to 16x16
constexpr int kMargin = 10;  // ops/klt.py::_MARGIN
constexpr int kWarps = 4;   // warps a block
constexpr unsigned kFull = 0xffffffffu;

// One (frames, h, w) float32 image: element (f, y, x) at
// p[f * sb + y * sy + x * sx].
struct Image {
  const float* p;
  long long sb;
  int sy, sx, h, w;
};

struct Level {
  Image tmpl, tgt, gx, gy;
};

// Passed by value as a __grid_constant__, so that a level indexed at run
// time is read from the parameter space and not copied to local memory.
struct Args {
  Level lv[kMaxLevels];
  int levels, frames, n, win, iters;
  float eps2, eig_thr;
  const float* pts;   // (frames, n, 2)
  const float* init;  // (frames, n, 2) or null
  float* xy;          // (frames, n, 2)
  unsigned char* status;
  float* err;         // (frames, n)
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ float at(const float* f, const Image& im, int y,
                                    int x) {
  return (y >= 0 && y < im.h && x >= 0 && x < im.w)
             ? __ldg(f + y * im.sy + x * im.sx)
             : 0.0f;
}

// The bilinear tap at (x + ax, y + ay), ax and ay in [0, 1).
__device__ __forceinline__ float bilerp(const float* f, const Image& im,
                                        int y, int x, float ax, float ay) {
  const float bx = sub(1.0f, ax), by = sub(1.0f, ay);
  const float top = add(mul(bx, at(f, im, y, x)), mul(ax, at(f, im, y, x + 1)));
  const float bot =
      add(mul(bx, at(f, im, y + 1, x)), mul(ax, at(f, im, y + 1, x + 1)));
  return add(mul(by, top), mul(ay, bot));
}

// Where a patch at integer corner c and offset o starts: the integer
// origin c + floor(o) and the fractional part o - floor(o).
struct Origin {
  int x, y;
  float ax, ay;
};

__device__ __forceinline__ Origin origin(int cx, int cy, float ox, float oy) {
  const float fx = floorf(ox), fy = floorf(oy);
  return {cx + (int)fx, cy + (int)fy, sub(ox, fx), sub(oy, fy)};
}

template <int M>
__device__ __forceinline__ void warp_sum(float (&v)[M]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < M; ++i)
      v[i] = add(v[i], __shfl_xor_sync(kFull, v[i], o));
}

template <int PER>
__global__ void __launch_bounds__(kWarps * 32)
    klt_track_kernel(const __grid_constant__ Args a) {
  const long long feat =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (feat >= (long long)a.frames * a.n) return;  // uniform in the warp
  const int lane = threadIdx.x & 31;
  const long long frame = feat / a.n;
  const int r = a.win / 2, npx = a.win * a.win;
  const float inv_n = 1.0f / (float)npx;

  int pk[PER], pl[PER];
  bool on[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = lane + 32 * j;
    on[j] = p < npx;
    pk[j] = p / a.win;
    pl[j] = p % a.win;
  }

  const float px = a.pts[2 * feat], py = a.pts[2 * feat + 1];
  const float top = (float)(1 << (a.levels - 1));
  float fx = a.init ? __fdiv_rn(a.init[2 * feat], top) : 0.0f;
  float fy = a.init ? __fdiv_rn(a.init[2 * feat + 1], top) : 0.0f;
  bool ok = true;
  float err = 0.0f;

  for (int lvl = a.levels - 1; lvl >= 0; --lvl) {
    const Level& L = a.lv[lvl];
    const float s = (float)(1 << lvl);
    const float p0x = __fdiv_rn(px, s), p0y = __fdiv_rn(py, s);

    // template and gradient patches, and the gradient sums
    const float flx = floorf(p0x), fly = floorf(p0y);
    const Origin to = origin((int)flx - r - 1, (int)fly - r - 1,
                             add(sub(p0x, flx), 1.0f),
                             add(sub(p0y, fly), 1.0f));
    const float* T = L.tmpl.p + frame * L.tmpl.sb;
    const float* GX = L.gx.p + frame * L.gx.sb;
    const float* GY = L.gy.p + frame * L.gy.sb;
    float t[PER], gxv[PER], gyv[PER];
    float G[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      t[j] = gxv[j] = gyv[j] = 0.0f;
      if (on[j]) {
        const int y = to.y + pk[j], x = to.x + pl[j];
        t[j] = bilerp(T, L.tmpl, y, x, to.ax, to.ay);
        gxv[j] = bilerp(GX, L.gx, y, x, to.ax, to.ay);
        gyv[j] = bilerp(GY, L.gy, y, x, to.ax, to.ay);
        G[0] = add(G[0], mul(gxv[j], gxv[j]));
        G[1] = add(G[1], mul(gxv[j], gyv[j]));
        G[2] = add(G[2], mul(gyv[j], gyv[j]));
      }
    }
    warp_sum(G);
    const float gxx = G[0], gxy = G[1], gyy = G[2];
    const float det = sub(mul(gxx, gyy), mul(gxy, gxy));
    const float tr = add(gxx, gyy);
    const float disc = fmaxf(sub(mul(tr, tr), mul(4.0f, det)), 0.0f);
    const float min_eig =
        mul(mul(0.5f, sub(tr, __fsqrt_rn(disc))), inv_n);
    const bool ok_g = min_eig > a.eig_thr;
    const float inv_det = __frcp_rn(fabsf(det) < 1e-12f ? 1e-12f : det);

    // the iterations, in the target window around the guess
    const float* TG = L.tgt.p + frame * L.tgt.sb;
    const int cx = (int)floorf(add(p0x, fx)) - r - kMargin;
    const int cy = (int)floorf(add(p0y, fy)) - r - kMargin;
    const float cfx = (float)cx, cfy = (float)cy;
    const float lox = add(sub(fx, (float)kMargin), 1.0f);
    const float loy = add(sub(fy, (float)kMargin), 1.0f);
    const float hix = sub(add(fx, (float)kMargin), 1.0f);
    const float hiy = sub(add(fy, (float)kMargin), 1.0f);
    float gx = fx, gy = fy;
    bool done = !ok_g;
    for (int it = 0; it < a.iters && !done; ++it) {
      const Origin o = origin(cx, cy, sub(sub(add(p0x, gx), cfx), (float)r),
                              sub(sub(add(p0y, gy), cfy), (float)r));
      float b[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (on[j]) {
          const float rr = sub(
              bilerp(TG, L.tgt, o.y + pk[j], o.x + pl[j], o.ax, o.ay), t[j]);
          b[0] = add(b[0], mul(rr, gxv[j]));
          b[1] = add(b[1], mul(rr, gyv[j]));
        }
      }
      warp_sum(b);
      const float sx = mul(-sub(mul(gyy, b[0]), mul(gxy, b[1])), inv_det);
      const float sy = mul(-add(mul(-gxy, b[0]), mul(gxx, b[1])), inv_det);
      gx = fminf(fmaxf(add(gx, sx), lox), hix);
      gy = fminf(fmaxf(add(gy, sy), loy), hiy);
      done = add(mul(sx, sx), mul(sy, sy)) < a.eps2;
    }
    ok = ok && ok_g;

    if (lvl == 0) {
      const Origin o = origin(cx, cy, sub(sub(add(p0x, gx), cfx), (float)r),
                              sub(sub(add(p0y, gy), cfy), (float)r));
      float e[1] = {0.0f};
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (on[j])
          e[0] = add(e[0], fabsf(sub(bilerp(TG, L.tgt, o.y + pk[j],
                                            o.x + pl[j], o.ax, o.ay),
                                     t[j])));
      warp_sum(e);
      err = mul(e[0], inv_n);
      fx = gx;
      fy = gy;
    } else {
      fx = mul(gx, 2.0f);
      fy = mul(gy, 2.0f);
    }
  }

  if (lane == 0) {
    const float ox = add(px, fx), oy = add(py, fy);
    const Image& im = a.lv[0].tmpl;
    const bool inb = ox >= 1.0f && ox <= (float)(im.w - 2) && oy >= 1.0f &&
                     oy <= (float)(im.h - 2);
    a.xy[2 * feat] = ox;
    a.xy[2 * feat + 1] = oy;
    a.status[feat] = (unsigned char)(ok && inb);
    a.err[feat] = err;
  }
}

template <int PER>
int launch(const Args& a, cudaStream_t s) {
  const long long feats = (long long)a.frames * a.n;
  const unsigned blocks = (unsigned)((feats + kWarps - 1) / kWarps);
  klt_track_kernel<PER><<<blocks, kWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Track frames x n features through `levels` pyramid levels in one launch
// on `stream`. images[4 * l + {0, 1, 2, 3}] are level l's template,
// target, template x gradient and template y gradient, each a (frames, h,
// w) float32 image with batch stride batch_strides[i] and dims[4 * i + {0,
// 1, 2, 3}] = {h, w, row stride, column stride}, in elements. pts and init
// (null: zero) are (frames, n, 2); writes xy (frames, n, 2), status and
// err (frames, n). Returns the launch's cudaError.
extern "C" int klt_track(const void* const* images,
                         const long long* batch_strides, const int* dims,
                         int levels, int frames, int n, const void* pts,
                         const void* init, void* xy, void* status, void* err,
                         int win, int iters, float eps2, float eig_thr,
                         void* stream) {
  const int per = (win * win + 31) / 32;
  if (levels < 1 || levels > kMaxLevels || frames < 1 || n < 1 || win < 1 ||
      per > kMaxPer || iters < 0 ||
      (long long)frames * n > 0x7fffffffLL * kWarps)
    return (int)cudaErrorInvalidValue;
  Args a{};
  for (int l = 0; l < levels; ++l) {
    Image* im[4] = {&a.lv[l].tmpl, &a.lv[l].tgt, &a.lv[l].gx, &a.lv[l].gy};
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * l + k;
      *im[k] = {static_cast<const float*>(images[i]), batch_strides[i],
                dims[4 * i + 2], dims[4 * i + 3], dims[4 * i], dims[4 * i + 1]};
    }
  }
  a.levels = levels;
  a.frames = frames;
  a.n = n;
  a.win = win;
  a.iters = iters;
  a.eps2 = eps2;
  a.eig_thr = eig_thr;
  a.pts = static_cast<const float*>(pts);
  a.init = static_cast<const float*>(init);
  a.xy = static_cast<float*>(xy);
  a.status = static_cast<unsigned char*>(status);
  a.err = static_cast<float*>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    default: return launch<8>(a, s);
  }
}
