// Fused window association + point-to-plane normal equations (kernel B1).
//
// Replaces pylidar_slam_tpu/ops/pallas/assoc_gn_kernel.py::
// window_assoc_gn_pallas, but follows the JAX main path's XLA composite
// (aggregated_map.py: window_associate -> residuals -> Jacobian -> robust
// weights -> J^T J / J^T r sums), which differs from the Pallas body in the
// candidate order, the gate comparison and the Cauchy weight.
//
// Per target pixel (r, c) of an (H, W) image, one thread:
//   * picks the closest valid model candidate among the (2wr+1)(2wc+1)
//     pixels (r - dr, c - dc), dr outer, dc inner, a strict < so the first
//     minimum wins; rows outside the image are empty, columns wrap in
//     azimuth;
//   * gates it: best_d <= gate^2 and a non-zero model normal, then
//     optionally |r| <= plane_gate;
//   * forms the residual r = (t - m) . n, the Jacobian J = [n, t x n] at the
//     zero pose delta and the IRLS weight w = sqrt(C(r)) / max(|r|, eps);
//   * contributes wJ wJ^T (21 upper entries), wJ wr (6), (wr)^2, 1 and w^2.
// Output layout (30 floats): H upper triangle row-major, g, loss, match
// count, weight mass -- the Pallas kernel's layout.
//
// What bounds it: at 64x1024 one call reads ~2.6 MB (target, model xyz and
// normals, validity) and makes ~15 x 65k candidate tests, far below what
// the card needs to be busy -- it is launch- and latency-bound, not
// bandwidth-bound.  So the design is the simple one: one thread per pixel
// reading the halo straight from global memory (L1/L2 catch the reuse), a
// warp-shuffle + shared-memory sum per block into a partials buffer, and a
// second launch that adds the partials in a fixed order.  No float atomics,
// so a run repeats bit for bit.  Compiled with --fmad=false so each product
// and sum rounds as the plain PyTorch composite's separate kernels do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 30;

// Scheme ids (the wrapper's SCHEME_IDS).
enum Scheme {
  kLeastSquare = 0,
  kHuber = 1,
  kExp = 2,
  kNeighborhood = 3,
  kGemanMcClure = 4,
  kSquareGemanMcClure = 5,
  kCauchy = 6,
};

// IRLS weight sqrt(C(r)) / max(|r|, eps), optimization.py::robust_weights.
__device__ __forceinline__ float robust_weight(int scheme, float r, float sq_d,
                                               float sigma, float sigma_sq,
                                               float eps) {
  if (scheme == kLeastSquare) return 1.0f;
  const float r2 = r * r;
  const float abs_r = fabsf(r);
  float cost;
  switch (scheme) {
    case kHuber:
      cost = abs_r < sigma ? r2 : 2.0f * sigma * abs_r - sigma_sq;
      break;
    case kExp:
      cost = r2 * expf(-r2 / sigma_sq);
      break;
    case kNeighborhood:
      cost = r2 * expf(-sq_d / sigma_sq);
      break;
    case kGemanMcClure:
      cost = sigma * r2 / (sigma + r2);
      break;
    case kSquareGemanMcClure: {
      const float t = sigma / (sigma + r2);
      cost = r2 * (t * t);
      break;
    }
    default: {  // kCauchy
      const float q = r / sigma;
      cost = logf(1.0f + q * q);
      break;
    }
  }
  return sqrtf(cost) / fmaxf(abs_r, eps);
}

__global__ void __launch_bounds__(kThreads)
assoc_gn_partials(const float* __restrict__ timg,
                  const float* __restrict__ mxyz,
                  const float* __restrict__ mnrm,
                  const uint8_t* __restrict__ mvalid,
                  int h, int w, int wr, int wc, float gate_sq, int scheme,
                  float sigma, float sigma_sq, float plane_gate, float eps,
                  float* __restrict__ partials) {
  __shared__ float warp_sums[kWarps][kOut];
  float vals[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) vals[k] = 0.0f;

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < h * w) {
    const int r = p / w;
    const int c = p - r * w;
    const float tx = timg[3 * p], ty = timg[3 * p + 1], tz = timg[3 * p + 2];
    const bool tvalid = fmaxf(fabsf(tx), fmaxf(fabsf(ty), fabsf(tz))) > 0.0f;

    float best_d = INFINITY;
    float bx = 0.0f, by = 0.0f, bz = 0.0f;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (tvalid) {
      for (int dr = -wr; dr <= wr; ++dr) {
        const int mr = r - dr;
        if (mr < 0 || mr >= h) continue;  // zero-filled rows never win
        for (int dc = -wc; dc <= wc; ++dc) {
          int mc = (c - dc) % w;
          mc = mc < 0 ? mc + w : mc;  // azimuth wraps
          const int q = mr * w + mc;
          if (!mvalid[q]) continue;
          const float mx = mxyz[3 * q], my = mxyz[3 * q + 1], mz = mxyz[3 * q + 2];
          const float ex = tx - mx, ey = ty - my, ez = tz - mz;
          const float d = ex * ex + ey * ey + ez * ez;
          if (d < best_d) {
            best_d = d;
            bx = mx; by = my; bz = mz;
            nx = mnrm[3 * q]; ny = mnrm[3 * q + 1]; nz = mnrm[3 * q + 2];
          }
        }
      }
    }
    bool ok = isfinite(best_d) && best_d <= gate_sq &&
              fmaxf(fabsf(nx), fmaxf(fabsf(ny), fabsf(nz))) > 0.0f;
    const float res = (tx - bx) * nx + (ty - by) * ny + (tz - bz) * nz;
    if (plane_gate > 0.0f) ok = ok && fabsf(res) <= plane_gate;
    if (ok) {
      const float wgt = robust_weight(scheme, res, best_d, sigma, sigma_sq, eps);
      const float jac[6] = {nx, ny, nz, ty * nz - tz * ny, tz * nx - tx * nz,
                            tx * ny - ty * nx};
      float wj[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) wj[a] = jac[a] * wgt;
      const float wres = res * wgt;
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) vals[k++] = wj[a] * wj[b];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) vals[21 + a] = wj[a] * wres;
      vals[27] = wres * wres;
      vals[28] = 1.0f;
      vals[29] = wgt * wgt;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    float v = vals[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += warp_sums[i][threadIdx.x];
    partials[blockIdx.x * kOut + threadIdx.x] = s;
  }
}

// One block per output: adds the per-block partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
assoc_gn_finalize(const float* __restrict__ partials, int num_blocks,
                  float* __restrict__ out) {
  __shared__ float warp_sums[kWarps];
  const int k = blockIdx.x;
  float v = 0.0f;
  for (int b = threadIdx.x; b < num_blocks; b += kThreads) v += partials[b * kOut + k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += warp_sums[i];
    out[k] = s;
  }
}

}  // namespace

extern "C" {

// Floats of scratch the launch needs for an (h, w) image.
int assoc_gn_partials_size(int h, int w) {
  return ((h * w + kThreads - 1) / kThreads) * kOut;
}

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 = success).  Device pointers: timg/mxyz/mnrm (h, w, 3) float32,
// mvalid (h, w) uint8, partials assoc_gn_partials_size(h, w) floats, out 30
// floats.
int assoc_gn_launch(const void* timg, const void* mxyz, const void* mnrm,
                    const void* mvalid, int h, int w, int wr, int wc,
                    float gate_sq, int scheme, float sigma, float sigma_sq,
                    float plane_gate, float eps, void* partials, void* out,
                    void* stream) {
  const int blocks = (h * w + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  assoc_gn_partials<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(timg), static_cast<const float*>(mxyz),
      static_cast<const float*>(mnrm), static_cast<const uint8_t*>(mvalid), h,
      w, wr, wc, gate_sq, scheme, sigma, sigma_sq, plane_gate, eps,
      static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  assoc_gn_finalize<<<kOut, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                              blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
