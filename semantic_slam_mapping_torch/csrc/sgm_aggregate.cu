// SGM path aggregation over four directions, for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_slam_mapping_tpu/ops/pallas/sgm_pallas.py
// (sgm_bidir_pallas -> _sgm_one_direction -> _sgm_dir_kernel), which
// ops/sgbm.py::_aggregate calls on the (H, W, D) cost volume and on its
// transpose. For every pixel p and disparity d each directional path cost is
//
//   L(p, d) = C(p, d) + min(L'(d), L'(d-1) + P1, L'(d+1) + P1, minL' + P2)
//             - minL'
//
// where L' is the path cost at the previous pixel along the direction and
// the first pixel of a line starts at L = C. The carry is float32.
//
// Contract (the Pallas kernel's). With r() rounding a float32 value to the
// volume's dtype and every + taken in float32 and rounded by r():
//
//   out = r(r(vf) + r(vb)) + r(r(hf) + r(hb))
//
// in the volume's dtype, vf/vb the top-down/bottom-up paths and hf/hb the
// left-right/right-left ones. In float32 r() is the identity. The plain
// PyTorch version (ops/cuda/sgm_cuda.py::sgm_aggregate4_plain) computes the
// same, and the two agree bit for bit. (A bfloat16 sum here is one add
// rounded once, where PyTorch rounds the exact sum to float32 and then to
// bfloat16; with 24 >= 2 * 8 + 2 significand bits the double rounding is
// innocuous, so the two are equal.)
//
// Design. Two launches, stream-ordered: the vertical pair writes
// vsum = r(vf + vb), the horizontal pair then writes out = r(vsum + r(hf +
// hb)). A batch of B frames, (B, H, W, Dp) contiguous, is one launch of B
// times the lines each: a block finds its frame and its line in the frame
// from its index, and lines are independent, so a batched launch gives
// what B single ones give, bit for bit. In each launch a block of two warps
// owns one scan line: warp 0
// walks it forward and warp 1 backward, at the same time, so a line's chain
// is n steps and not 2n. They meet in the middle. In its first half each
// warp writes its rounded path to the destination at the positions it owns;
// after a block barrier each reads its partner's rounded path at the
// positions it now reaches, adds its own, and writes the sum (plus vsum in
// the horizontal launch) over it. Every position is written once as a path
// and once as a sum, by the two warps of one block, so no atomics are
// needed; the destination is empty when the launch starts (vsum for the
// first, out for the second), so the stash needs no extra buffer.
//
// A lane holds 4 neighbouring disparities (D <= 124): its costs arrive as
// one 8-byte (bfloat16) or 16-byte (float32) shared-memory load, its
// results leave as one 8- or 16-byte store straight to device memory, and
// bfloat16 values are rounded, added and rounded again two to an
// instruction (cvt.rn.bf16x2.f32, fma.rn.bf16x2).
//
// Loads are kept in flight: each warp owns a ring of `nst` stages in shared
// memory, each stage kCh steps of its line, filled by 16-byte cp.async
// copies (LDGSTS, L2 only) issued nst - 1 stages ahead. One path serves both
// orientations: a vertical step is one pixel (D values, contiguous) strided
// by W pixels, a horizontal stage is kCh contiguous pixels. The host picks
// nst so that every block of the launch is resident at once (one wave)
// when there are at most 32 blocks an SM; past that (a batch: B = 8 frames
// of 376x1241 give 9,928 vertical lines, 75 an SM on 132 SMs) it sizes the
// ring for 32 blocks an SM, which is the floor of kMinStages stages, and
// the launch runs in several waves (sgm_aggregate_plan reports it).
//
// One step is a short chain: minL' is one redux.sync.min.u32 on the bit
// patterns of the float32 path costs (every cost is >= +0.0 and the padded
// slots are +inf, so unsigned order is float order; a -0.0 cost would sort
// last, so costs enter the carry as c + 0.0f), and d +- 1 across lanes are
// two shuffles beside it. No shared-memory load of a stage is under a
// branch or behind a store to shared memory, so they are issued ahead, and
// the sums and stores of one step overlap the chain of the next.
//
// Preconditions: a non-negative volume (SGBM's matching cost is a mean of
// absolute differences) and P1, P2 >= 0. The pixel stride Dp >= D makes a
// pixel a whole number of 16-byte vectors; the wrapper pads when D does
// not, with +inf.
//
// Bounds on an NVIDIA H100 80GB HBM3 (700 W) at (376, 1248, 80) bfloat16:
// the contract's bytes are the volume read once and the aggregate written
// once, 150.2 MB, 44.8 us at 3.35 TB/s; the operations (about 10 float32
// operations per element and direction, 1.5 GFLOP) take 22 us at 67
// TFLOP/s. Beside the bound: the dependent chain of the longest line is
// 1248 steps (horizontal) after 376 (vertical), at roughly 60-100 cycles a
// step 50-90 us at 1.7-1.98 GHz. What bounds this design is the bytes it
// moves, 675 MB and not 150: the volume is read by both launches, vsum is
// written and read back, and each launch writes and reads back its stash
// (75 MB each time). Without its loads the kernel takes about half the
// time; without the minimum reduction, the shuffles or the bfloat16
// packing, about the same (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPer = 4;          // disparities a lane
constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr int kMaxDevices = 16;
constexpr unsigned kFull = 0xffffffffu;

// Four neighbouring values of T: loaded, rounded from float32, added in T
// and stored.
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  using V = float4;
  static __device__ __forceinline__ void unpack(const float* p,
                                                float (&c)[kPer]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
  }
  static __device__ __forceinline__ V pack(const float (&c)[kPer]) {
    return make_float4(c[0], c[1], c[2], c[3]);
  }
  static __device__ __forceinline__ V load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ V add(V a, V b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  static __device__ __forceinline__ void store(float* p, V v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

// bfloat16: two to a 32-bit word, the lower disparity in the low half.
template <>
struct Quad<__nv_bfloat16> {
  using V = uint2;
  static __device__ __forceinline__ void unpack(const __nv_bfloat16* p,
                                                float (&c)[kPer]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    c[0] = __uint_as_float(v.x << 16);
    c[1] = __uint_as_float(v.x & 0xffff0000u);
    c[2] = __uint_as_float(v.y << 16);
    c[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    unsigned r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
  }
  static __device__ __forceinline__ V pack(const float (&c)[kPer]) {
    return make_uint2(pack2(c[0], c[1]), pack2(c[2], c[3]));
  }
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
    unsigned r;  // a * 1 + b, rounded once
    asm("fma.rn.bf16x2 %0, %1, %2, %3;"
        : "=r"(r)
        : "r"(a), "r"(0x3f803f80u), "r"(b));
    return r;
  }
  static __device__ __forceinline__ V add(V a, V b) {
    return make_uint2(add2(a.x, b.x), add2(a.y, b.y));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, V v) {
    *reinterpret_cast<uint2*>(p) = v;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n groups are pending (n is uniform, 1..kMaxStages-1).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// A warp's view of its line and its shared-memory ring. Ring layout:
// [stream][slot][step][Dp], streams 0 = volume, 1 = the partner's rounded
// path (read from dest), 2 = vsum. The horizontal launch (ADD) has 3
// blocks an SM and room for longer stages; the vertical one has 10.
template <typename T, bool ADD>
struct Walk {
  static constexpr int kStreams = ADD ? 3 : 2;
  static constexpr int kCh = ADD ? 16 : 8;  // steps a ring stage holds
  static constexpr int kVec = 16 / sizeof(T);
  const T* vol;
  const T* addend;
  T* dest;
  T* ring;
  long long origin, dstep;  // in elements: step 0's pixel, one step
  int Dp, nst, stage;          // stage: elements of one slot
  int rows, rr, vo;            // 16-byte copies: lane -> (row rr, offset vo)
  bool fwd;

  __device__ T* slot(int stream, int s) const {
    return ring + (stream * nst + s) * stage;
  }
  // Element offset of step i's pixel in the volume.
  __device__ long long offset(int i) const { return origin + i * dstep; }
  // Issue the copies of steps [ib, ib + cnt) into ring slot `s`, then
  // commit one group (empty when cnt == 0). A pass of the warp copies
  // `rows` pixels; lane -> (pixel rr of the pass, element vo of the pixel).
  __device__ void load(int ib, int cnt, int s, bool combine) const {
    const long long g0 = offset(ib) + vo;
    const int e0 = vo;
#pragma unroll
    for (int u = 0; u < kCh; ++u) {
      const int t = rr + u * rows;
      if (t >= cnt) break;
      const long long g = g0 + t * dstep;
      const int e = e0 + t * Dp;
      cp_async16(slot(0, s) + e, vol + g);
      if (combine) {
        cp_async16(slot(1, s) + e, dest + g);
        if (ADD) cp_async16(slot(2, s) + e, addend + g);
      }
    }
    cp_async_commit();
  }
};

// Steps [i0, i1) of one warp's walk. combine == false: write r(L) (the
// first half). combine == true: write r(r(L) + partner) (+ vsum).
template <typename T, bool ADD>
__device__ __forceinline__ void walk(const Walk<T, ADD>& w, const T* inf4,
                                     float (&L)[kPer], int i0, int i1,
                                     bool combine, int D, float p1,
                                     float p2) {
  using Q = Quad<T>;
  constexpr int kCh = Walk<T, ADD>::kCh;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * kPer;
  // Lanes past D read +inf costs from inf4 (and any path, which they
  // drop); a lane that straddles D reads the +inf padding of the pixel.
  const bool active = d0 < D;
  const int dl = active ? d0 : 0, rs = active ? w.Dp : 0;
  // d - 1 and d + 1 across lanes as rotations: lane 0 reads lane 31 and
  // lane 31 lane 0, and lane 31 is past D (D <= 124), so both read +inf
  const int from_left = (lane + 31) & 31, from_right = (lane + 1) & 31;
  const int n_stages = (i1 - i0 + kCh - 1) / kCh;
  auto count = [&](int k) { return min(kCh, i1 - i0 - k * kCh); };

  for (int k = 0; k < w.nst - 1; ++k)
    w.load(i0 + k * kCh, k < n_stages ? count(k) : 0, k, combine);

  for (int k = 0, s = 0; k < n_stages; ++k, s = s + 1 == w.nst ? 0 : s + 1) {
    __syncwarp();  // every lane is done with the slot refilled below
    const int kn = k + w.nst - 1;
    w.load(i0 + kn * kCh, kn < n_stages ? count(kn) : 0,
           s == 0 ? w.nst - 1 : s - 1, combine);
    cp_async_wait_upto(w.nst - 1);  // stage k has landed (this lane's part)
    __syncwarp();                   // ... and every lane's
    const int cnt = count(k);
    // no load below is under a branch, so the compiler issues a stage's
    // loads ahead of its chain
    const T* cs = active ? w.slot(0, s) + d0 : inf4;
    const T* ps = w.slot(1, s) + dl;
    const T* as = w.slot(2, s) + dl;
    T* out = w.dest + w.offset(i0 + k * kCh) + d0;
#pragma unroll
    for (int t = 0; t < kCh; ++t) {
      if (t >= cnt) break;  // warp-uniform
      // this step's costs (padded disparities cost +inf and stay +inf)
      float c[kPer];
      Q::unpack(cs + t * rs, c);
      // one step of the chain
      const unsigned lm =
          min(min(__float_as_uint(L[0]), __float_as_uint(L[1])),
              min(__float_as_uint(L[2]), __float_as_uint(L[3])));
      const float m = __uint_as_float(__reduce_min_sync(kFull, lm));
      float lp1[kPer];  // L'(d) + P1
#pragma unroll
      for (int j = 0; j < kPer; ++j) lp1[j] = L[j] + p1;
      const float left = __shfl_sync(kFull, lp1[kPer - 1], from_left);
      const float right = __shfl_sync(kFull, lp1[0], from_right);
      const float mp2 = m + p2;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float up = j > 0 ? lp1[j - 1] : left;         // L'(d - 1) + P1
        const float dn = j < kPer - 1 ? lp1[j + 1] : right;  // L'(d + 1) + P1
        const float best = fminf(fminf(L[j], mp2), fminf(up, dn));
        L[j] = (c[j] + best) - m;
      }
      // its result, straight to device memory
      typename Q::V o = Q::pack(L);
      if (combine) {
        o = Q::add(o, Q::load(ps + t * rs));
        if (ADD) o = Q::add(Q::load(as + t * rs), o);
      }
      if (active) Q::store(out, o);
      out += w.dstep;
    }
  }
  cp_async_wait<0>();
}

// One block of two warps a line; see the note at the top.
template <typename T, bool ADD>
__global__ void __launch_bounds__(64, ADD ? 4 : 10)
sgm_line_pair(const T* __restrict__ vol, const T* __restrict__ addend,
              T* __restrict__ dest, int n, int frame_lines,
              long long frame_stride, long long line_stride,
              long long step_stride, int D, int Dp, float p1, float p2,
              int nst) {
  using W = Walk<T, ADD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  // 16 bytes of +inf, then the two warps' rings
  T* inf4 = reinterpret_cast<T*>(smem);
  if (threadIdx.x < kPer) inf4[threadIdx.x] = T(inf);
  __syncthreads();  // inf4 is written
  W w;
  w.vol = vol;
  w.addend = addend;
  w.dest = dest;
  w.fwd = warp == 0;
  w.dstep = (w.fwd ? step_stride : -step_stride) * Dp;
  // block -> (frame, line of the frame)
  const int frame = blockIdx.x / frame_lines, line = blockIdx.x % frame_lines;
  w.origin = frame * frame_stride + line * line_stride * Dp +
             (w.fwd ? 0 : (n - 1) * -w.dstep);
  w.Dp = Dp;
  w.nst = nst;
  w.stage = W::kCh * Dp;
  const int vpp = Dp / W::kVec;  // 16-byte vectors a pixel
  w.rows = 32 / vpp;
  w.rr = lane < w.rows * vpp ? lane / vpp : W::kCh;  // kCh: copies nothing
  w.vo = lane % vpp * W::kVec;
  w.ring = reinterpret_cast<T*>(smem + 16) +
           warp * nst * W::kStreams * w.stage;

  // a carry of 0 (+inf past D) makes the first step give L = C + 0.0f
  // (P1, P2 >= 0), as a fresh start does; + 0.0f turns a -0.0 cost into
  // +0.0
  float L[kPer];
  for (int j = 0; j < kPer; ++j) L[j] = lane * kPer + j < D ? 0.0f : inf;
  // forward stashes positions [0, h), backward [h, n); each then
  // combines the positions its partner stashed
  const int h = n / 2;
  const int sw = w.fwd ? h : n - h;
  walk<T, ADD>(w, inf4, L, 0, sw, false, D, p1, p2);
  __syncthreads();  // the partner's stash is written and visible
  walk<T, ADD>(w, inf4, L, sw, n, true, D, p1, p2);
}

struct DeviceLimits {
  int n_sm = 0, per_sm_smem = 0, optin = 0, reserved = 0;
  cudaError_t query(int dev) {
    const cudaDeviceAttr attrs[4] = {
        cudaDevAttrMultiProcessorCount,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrMaxSharedMemoryPerBlockOptin,
        cudaDevAttrReservedSharedMemoryPerBlock};
    int* fields[4] = {&n_sm, &per_sm_smem, &optin, &reserved};
    for (int i = 0; i < 4; ++i) {
      const cudaError_t err = cudaDeviceGetAttribute(fields[i], attrs[i], dev);
      if (err != cudaSuccess) {
        n_sm = 0;
        return err;
      }
    }
    return cudaSuccess;
  }
};

// How a launch runs: its blocks, the ring depth that every block of a wave
// of up to 32 blocks an SM can have, and the blocks an SM then holds.
struct Plan {
  int blocks = 0, per_sm = 0, nst = 0, resident = 0;
  size_t smem = 0;
};

template <typename T, bool ADD>
cudaError_t plan_launch(int B, int H, int W, int Dp, int horizontal,
                        int dev, Plan& p) {
  constexpr int kStreams = Walk<T, ADD>::kStreams;
  auto kernel = sgm_line_pair<T, ADD>;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // per device, once: its limits, and the kernel's shared-memory ceiling
  // raised to the most a block may have
  static DeviceLimits limits[kMaxDevices];
  static bool opted_in[kMaxDevices];
  DeviceLimits& lim = limits[dev];
  cudaError_t err = cudaSuccess;
  if (!lim.n_sm) {
    err = lim.query(dev);
    if (err != cudaSuccess) return err;
  }
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lim.optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  p.blocks = B * (horizontal ? H : W);
  // the deepest ring at which every block of the launch is resident at once
  p.per_sm = min(32, (p.blocks + lim.n_sm - 1) / lim.n_sm);
  const long long budget = min((long long)lim.optin,
                               (long long)(lim.per_sm_smem / p.per_sm -
                                           lim.reserved));
  const long long slot_bytes =  // both warps
      2LL * Walk<T, ADD>::kCh * Dp * sizeof(T);
  p.nst = max(kMinStages, min(kMaxStages, (int)((budget - 16) /
                                                slot_bytes / kStreams)));
  p.smem = 16 + (size_t)slot_bytes * p.nst * kStreams;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.resident, kernel,
                                                       64, p.smem);
}

template <typename T, bool ADD>
int launch(const void* vol, const void* addend, void* dest, int B, int H,
           int W, int D, int Dp, float p1, float p2, int horizontal,
           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  err = plan_launch<T, ADD>(B, H, W, Dp, horizontal, dev, p);
  if (err != cudaSuccess) return (int)err;
  const int n = horizontal ? W : H;
  sgm_line_pair<T, ADD><<<p.blocks, 64, p.smem, stream>>>(
      static_cast<const T*>(vol), static_cast<const T*>(addend),
      static_cast<T*>(dest), n, horizontal ? H : W, (long long)H * W * Dp,
      horizontal ? W : 1, horizontal ? 1 : W, D, Dp, p1, p2, p.nst);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream`. vol, addend and dest are (B, H, W, Dp)
// contiguous, bfloat16 when is_bf16 else float32, 16-byte aligned, with
// Dp * element size a multiple of 16; only d < D is computed. horizontal
// == 0 walks the columns of every frame, 1 the rows. addend == NULL: dest
// = r(f + b); otherwise dest = r(addend + r(f + b)). Returns the
// cudaError_t of the set-up and the launch.
extern "C" int sgm_aggregate_pass(const void* vol, const void* addend,
                                  void* dest, int B, int H, int W, int D,
                                  int Dp, float p1, float p2, int is_bf16,
                                  int horizontal, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  if (D < 1 || D > 31 * kPer || Dp < D || Dp % vec || B < 1 || H < 1 ||
      W < 1 || (long long)B * (horizontal ? H : W) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return addend ? launch<__nv_bfloat16, true>(vol, addend, dest, B, H, W,
                                                D, Dp, p1, p2, horizontal, s)
                  : launch<__nv_bfloat16, false>(vol, addend, dest, B, H, W,
                                                 D, Dp, p1, p2, horizontal,
                                                 s);
  return addend ? launch<float, true>(vol, addend, dest, B, H, W, D, Dp, p1,
                                      p2, horizontal, s)
                : launch<float, false>(vol, addend, dest, B, H, W, D, Dp, p1,
                                       p2, horizontal, s);
}

// The plan of a launch of sgm_aggregate_pass with these arguments on
// device `dev` (the vertical launch has no addend, the horizontal one has
// one): out = {blocks, blocks an SM holds at once, ring stages, shared
// memory bytes of a block}. Launches nothing.
extern "C" int sgm_aggregate_plan(int B, int H, int W, int Dp, int is_bf16,
                                  int horizontal, int dev, int* out) {
  Plan p;
  cudaError_t err;
  if (is_bf16)
    err = horizontal
              ? plan_launch<__nv_bfloat16, true>(B, H, W, Dp, 1, dev, p)
              : plan_launch<__nv_bfloat16, false>(B, H, W, Dp, 0, dev, p);
  else
    err = horizontal ? plan_launch<float, true>(B, H, W, Dp, 1, dev, p)
                     : plan_launch<float, false>(B, H, W, Dp, 0, dev, p);
  out[0] = p.blocks;
  out[1] = p.resident;
  out[2] = p.nst;
  out[3] = (int)p.smem;
  return (int)err;
}
