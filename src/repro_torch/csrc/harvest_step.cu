// Float64 capacitor-bank harvest update: one thread per worker, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fleet_step.py
// (harvest_step / _harvest_kernel): charge N capacitors by one trace tick,
//   v' = min(sqrt(2 e / C), v_max),  e = 0.5 C v v + eff p dt,
// with per-worker C and v_max. The plain version is
// repro_torch.core.energy.capacitor_harvest; the two are bit-exact.
//
// What bounds it on an H100: bytes. Per worker it reads v, p, C and v_max
// and writes v' (40 B) for seven float64 operations, one of them a
// division and one a square root: far below the card's FP64 rate per byte.
// The design is one pass: a grid-stride loop of 256-thread blocks over the
// worker axis, each thread loading its five lanes once (coalesced 8-byte
// accesses). The TPU's (8, 128) tiling and its C=1 pad lanes are gone. At
// the fleet sizes served here the launch latency, not the bytes, sets the
// time; fusing the stage into a larger kernel is the lever for that.
//
// Rounding: nvcc contracts a*b+c into an FMA by default, which rounds once
// where numpy and torch round twice. Every operation is written with its
// round-to-nearest intrinsic (__dmul_rn, __dadd_rn, __ddiv_rn, __dsqrt_rn),
// which the compiler never fuses, in the reference's operand order, so the
// result is bit-equal to the separate eager ops of the plain version.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond this

__global__ void __launch_bounds__(kBlock)
    harvest_step_kernel(const double* __restrict__ v,
                        const double* __restrict__ p,
                        const double* __restrict__ c,
                        const double* __restrict__ v_max,
                        double* __restrict__ out, double eff, double dt,
                        int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
       w < n; w += stride) {
    const double cw = c[w], vw = v[w];
    // e = ((0.5 * C) * v) * v + (eff * p) * dt
    const double stored = __dmul_rn(__dmul_rn(__dmul_rn(0.5, cw), vw), vw);
    const double banked = __dmul_rn(__dmul_rn(eff, p[w]), dt);
    const double e = __dadd_rn(stored, banked);
    // sqrt((2.0 * e) / C), then the minimum with v_max; NaN propagates
    // from either operand, as in torch.minimum (fmin would drop it)
    const double s = __dsqrt_rn(__ddiv_rn(__dmul_rn(2.0, e), cw));
    const double m = v_max[w];
    out[w] = (s < m || isnan(s)) ? s : m;
  }
}

}  // namespace

// Launches on `stream` with no synchronisation; returns cudaGetLastError()
// after the launch. All five pointers are contiguous float64 (n,) arrays
// on the device; `out` may not alias an input.
extern "C" int harvest_step_launch(const double* v, const double* p,
                                   const double* c, const double* v_max,
                                   double* out, double eff, double dt,
                                   int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + kBlock - 1) / kBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  harvest_step_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      v, p, c, v_max, out, eff, dt, n);
  return static_cast<int>(cudaGetLastError());
}
