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
// the first pixel of a line starts at L = C. The output is the float32 sum
// of the four axis-aligned directions.
//
// Design. The Pallas kernel scans one row per sequential grid step with the
// carry in VMEM; Hopper runs blocks in no order, so here the scan is a loop
// inside one warp. One warp owns one scan line (a column for the vertical
// pair, a row for the horizontal pair) and walks it forward and then
// backward. The D <= 96 disparities of a pixel are spread over the 32 lanes,
// three contiguous ones per lane; minL' is a __shfl_xor min-reduction and
// the d-1 / d+1 neighbours across lanes come from __shfl_up / __shfl_down.
// The (y, x, 0:D) slice is contiguous in both orientations, so the
// horizontal pass reads the volume as it lies, with no transpose. The carry
// is float32 over a bfloat16 or float32 volume. Launch 1 (vertical) writes
// the forward path and adds the backward one; launch 2 (horizontal) adds its
// two paths. Each output element belongs to one warp in each launch, so no
// atomics are needed. Each warp loads kChunk steps of costs (and of the
// output it adds to) before it computes them, to keep loads in flight.
//
// Numbers. The TPU kernel rounds each bidirectional result to the volume's
// dtype; this kernel keeps the four-direction sum in float32. With a float32
// volume the two agree to rounding. The sum is taken in the order
// ((vertical fwd + bwd) + horizontal fwd) + horizontal bwd, which the plain
// PyTorch version (ops/cuda/sgm_cuda.py::sgm_aggregate4_plain) repeats.
//
// Bound on an H100 SXM at (376, 1248, 80): the volume read once in bf16
// (75 MB) and the aggregate written once in f32 (150 MB) take 67 us at
// 3.35 TB/s; the arithmetic (about 10 f32 operations per element and
// direction) is under a third of that. In practice the kernel is bound by
// latency instead: a horizontal line is a chain of 2 x 1248 dependent steps,
// and that launch has only 376 warps of work for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPerLane = 3;
constexpr int kMaxD = 32 * kPerLane;
constexpr int kWarpsPerBlock = 4;
constexpr int kChunk = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One warp per line. Pixel (step s of line l) lies at
// l * line_stride + s * step_stride, in units of pixels (D values each).
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sgm_line_pair(const T* __restrict__ vol, float* __restrict__ out,
              int n_lines, int n_steps, long long line_stride,
              long long step_stride, int D, float p1, float p2,
              int accumulate) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (line >= n_lines) return;  // warp-uniform: every lane shares `line`
  const float inf = __int_as_float(0x7f800000);
  const long long base = (long long)line * line_stride;
  const int d0 = lane * kPerLane;

  for (int dir = 0; dir < 2; ++dir) {
    const bool add = accumulate || dir == 1;
    float L[kPerLane];
    for (int i0 = 0; i0 < n_steps; i0 += kChunk) {
      float cv[kChunk][kPerLane];
      float ov[kChunk][kPerLane];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + u;
        const int s = dir == 0 ? i : n_steps - 1 - i;
        const long long off = (base + (long long)s * step_stride) * D;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int d = d0 + k;
          const bool ok = i < n_steps && d < D;
          cv[u][k] = ok ? to_f32(vol[off + d]) : 0.0f;
          ov[u][k] = (ok && add) ? out[off + d] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + u;
        if (i >= n_steps) break;  // warp-uniform
        if (i == 0) {
#pragma unroll
          for (int k = 0; k < kPerLane; ++k)
            L[k] = d0 + k < D ? cv[u][k] : inf;
        } else {
          float m = fminf(fminf(L[0], L[1]), L[2]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            m = fminf(m, __shfl_xor_sync(kFull, m, o));
          float left = __shfl_up_sync(kFull, L[kPerLane - 1], 1);
          float right = __shfl_down_sync(kFull, L[0], 1);
          if (lane == 0) left = inf;
          if (lane == 31) right = inf;
          const float up[kPerLane] = {left, L[0], L[1]};   // L'(d - 1)
          const float dn[kPerLane] = {L[1], L[2], right};  // L'(d + 1)
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) {
            const float best = fminf(fminf(L[k], m + p2),
                                     fminf(up[k] + p1, dn[k] + p1));
            L[k] = d0 + k < D ? cv[u][k] + best - m : inf;
          }
        }
        const int s = dir == 0 ? i : n_steps - 1 - i;
        const long long off = (base + (long long)s * step_stride) * D;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int d = d0 + k;
          if (d < D) out[off + d] = add ? ov[u][k] + L[k] : L[k];
        }
      }
    }
  }
}

}  // namespace

// One launch on `stream`: horizontal == 0 writes the vertical pair,
// horizontal == 1 adds the horizontal pair. vol is (H, W, D) contiguous,
// bfloat16 when is_bf16 else float32; out is (H, W, D) float32. Returns the
// cudaError_t of the launch.
extern "C" int sgm_aggregate_pass(const void* vol, void* out, int H, int W,
                                  int D, float p1, float p2, int is_bf16,
                                  int horizontal, void* stream) {
  if (D < 1 || D > kMaxD || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int n_lines = horizontal ? H : W;
  const int n_steps = horizontal ? W : H;
  const long long line_stride = horizontal ? W : 1;
  const long long step_stride = horizontal ? 1 : W;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    sgm_line_pair<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), static_cast<float*>(out),
        n_lines, n_steps, line_stride, step_stride, D, p1, p2, horizontal);
  } else {
    sgm_line_pair<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(vol), static_cast<float*>(out), n_lines,
        n_steps, line_stride, step_stride, D, p1, p2, horizontal);
  }
  return (int)cudaGetLastError();
}
