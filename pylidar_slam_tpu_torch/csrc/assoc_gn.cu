// Fused window association + point-to-plane normal equations (kernel B1).
//
// Replaces pylidar_slam_tpu/ops/pallas/assoc_gn_kernel.py::
// window_assoc_gn_pallas, but follows the JAX main path's XLA composite
// (aggregated_map.py: window_associate -> residuals -> Jacobian -> robust
// weights -> J^T J / J^T r sums), which differs from the Pallas body in the
// candidate order, the gate comparison and the Cauchy weight.
//
// Per target pixel (r, c) of an (H, W) image:
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
// What bounds it: at 64x1024 one call must read the target, model xyz and
// normal images (3 x 786,432 B) and the validity (65,536 B), 2.42 MB, which
// is 0.72 us at 3.35 TB/s; its ~200 FLOP per pixel (1.3e7) take ~0.2 us at
// 67 TFLOP/s.  So the bound is memory, and a call this small is in practice
// held by latency: the chain of dependent steps from the first load to the
// last store.  The design keeps that chain short:
//
//  * One launch per call.  Each block sums its pixels; one thread writes the
//    block's 30 partial sums, fences and takes an integer ticket; the block
//    that draws the last ticket adds all partials, writes the 30 outputs
//    and resets the counter to 0.  No float atomics, so a run repeats bit
//    for bit.  The counter is one unsigned int per device, zeroed once by
//    the wrapper; the port launches on one stream per device, so two calls
//    never overlap.  The last block issues all its (16-byte) loads of the
//    partials before it adds the first.
//  * The halo in shared memory, in one round trip.  A block covers one row
//    x kStrip columns of target pixels.  It stages the 2wr+1 model rows'
//    xyz, normals and validity for the strip's columns +-wc (16-byte loads
//    for the strip and, for the validity, the 16 columns on each side; the
//    wrapped xyz halo columns one float at a time; rows outside the image
//    are left empty): every thread issues all its loads of the rows before
//    it stores any, and each model pixel comes from device memory once per
//    block.  The window search then reads shared memory only; the
//    champion's 1x2 window is compiled in and unrolled, other windows take
//    a generic instantiation (at 64x1024 on an H100 80GB HBM3, 700 W, the
//    generic one took 7.05-7.08 us per call against 6.58-6.61 us for the
//    compiled-in window, by CUDA-graph replay in one run of
//    `chip_smoke.py --compare`).  (On an H100, cp.async for the staging was a
//    little slower than these loads through registers, and bulk copies
//    (TMA) on an mbarrier, for the halo and for the last block's partials,
//    slower again.)
//  * One pixel per thread.  The kernel is a chain of latencies, so it wants
//    warps in flight more than work per thread: at 64x1024 on an H100, 2
//    pixels per thread (8 warps per SM) were clearly slower than 1 (16
//    warps per SM), with everything else the same.
//  * A fixed order for the float sums.  A block's 256 pixels are added in
//    groups of 32 as a warp's shuffle-down tree adds them, the 8 group sums
//    in turn; the last block adds the blocks' partials the same way.  On
//    an H100 80GB HBM3 (700 W) the aggregated champion's tr_err over the
//    140-frame acceptance sequence went from 0.0875% to 0.1349% when only
//    this order changed (per-thread sums first), past the round's bar of
//    0.1115%: the trajectory is that sensitive to one rounding of the
//    normal equations.  With this order a 64x1024 image gives the sums of
//    the earlier two-launch kernel bit for bit.
//
// Compiled with --fmad=false so each product and sum rounds as the plain
// PyTorch composite's separate kernels do; only the order of the float sums
// differs from the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = kThreads;  // target columns per block, one per thread
constexpr int kOut = 30;
constexpr int kPartial = 32;      // floats per block partial (30 sums, padded)
constexpr int kCore = 3 * kStrip / 4;    // 16-byte loads of a strip row's xyz
constexpr int kChunks = kStrip / 16 + 2;  // 16-byte validity chunks of a row
constexpr int kBatchRows = 3;             // halo rows loaded before any is stored
// The sums: each output's kStrip values (a block's pixels, or the last
// block's per-lane partials) in kGroups groups of 32, each group added as
// the 32-lane tree of a warp's shuffle-down reduction, then the groups in
// order starting from 0 -- the same order for the block sums and for the
// sum over blocks.
constexpr int kLanes = 32;
constexpr int kGroups = kStrip / kLanes;
constexpr int kRow = kLanes + 1;  // a padded group row: tree j reads banks j..j+31
constexpr int kTrees = kOut * kGroups;
constexpr size_t kReduceBytes = (kTrees * kRow + kTrees) * sizeof(float);

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

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int max_(int a, int b) { return a > b ? a : b; }

// Shared-memory layout of the staged halo.  Each model row holds the xyz
// (then, in a second array, the normals) of the columns c0 - wc .. c0 +
// kStrip + wc - 1 as 3 floats per pixel, and in a third array their
// validity bytes, each placed so that column c0 starts on a 16-byte
// boundary.
struct Halo {
  int wc;
  int rows;        // 2wr + 1
  int core;        // float offset of column c0 in a row (multiple of 4)
  int row_floats;  // floats per row (multiple of 4)
  int vcore;       // byte offset of column c0 in a validity row
  int row_bytes;   // bytes per validity row (multiple of 16)

  // Validity rows keep 16 columns of room on each side, so that a whole
  // strip can copy its validity halo as 16-byte chunks.
  __host__ __device__ Halo(int wr, int wc_)
      : wc(wc_), rows(2 * wr + 1), core(round_up(3 * wc_, 4)),
        row_floats(round_up(round_up(3 * wc_, 4) + 3 * (kStrip + wc_), 4)),
        vcore(round_up(max_(wc_, 16), 16)),
        row_bytes(round_up(round_up(max_(wc_, 16), 16) + kStrip + max_(wc_, 16), 16)) {}

  // float offset of staged column lc (lc = 0 is column c0 - wc) in a row
  __host__ __device__ int col(int lc) const { return core - 3 * wc + 3 * lc; }
  // byte offset of staged column lc in a validity row
  __host__ __device__ int vcol(int lc) const { return vcore - wc + lc; }
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(rows) * row_floats;
  }
  __host__ __device__ size_t bytes() const {
    const size_t stage = 2 * floats() * sizeof(float) + static_cast<size_t>(rows) * row_bytes;
    return round_up(static_cast<int>(stage > kReduceBytes ? stage : kReduceBytes), 16);
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

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

__device__ __forceinline__ int wrap(int c, int w) {
  const int m = c % w;
  return m < 0 ? m + w : m;
}

// wrap() for -w <= c < 2w, without a division.
__device__ __forceinline__ int wrap_near(int c, int w) {
  return c < 0 ? c + w : (c >= w ? c - w : c);
}

// Where value i (0 .. kStrip - 1) of output k lives in the reduction buffer.
__device__ __forceinline__ int slot(int k, int i) {
  return (k * kGroups + i / kLanes) * kRow + i % kLanes;
}

// The 32 values of a group row as a shuffle-down tree adds them: lane l
// takes l + 16, then l + 8, ..., and lane 0 holds the sum.
template <int kOff>
__device__ __forceinline__ void tree_step(float (&v)[kLanes]) {
#pragma unroll
  for (int i = 0; i < kOff; ++i) v[i] = v[i] + v[i + kOff];
}

__device__ __forceinline__ float lane_tree(const float* row) {
  float v[kLanes];  // constant indices only, so it stays in registers
#pragma unroll
  for (int i = 0; i < kLanes; ++i) v[i] = row[i];
  tree_step<16>(v);
  tree_step<8>(v);
  tree_step<4>(v);
  tree_step<2>(v);
  tree_step<1>(v);
  return v[0];
}

// The kOut sums of the values in `red` (every thread has written its own
// before the call); thread k < kOut returns sum k.
__device__ __forceinline__ float block_sums(const float* red, float* group_sums) {
  for (int j = threadIdx.x; j < kTrees; j += kThreads) group_sums[j] = lane_tree(red + j * kRow);
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < kOut) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += group_sums[threadIdx.x * kGroups + g];
  }
  return s;
}

// WR, WC >= 0 compile the window in; -1 takes wr, wc at run time.
template <int WR, int WC>
__global__ void __launch_bounds__(kThreads)
assoc_gn_fused(const float* __restrict__ timg, const float* __restrict__ mxyz,
               const float* __restrict__ mnrm, const uint8_t* __restrict__ mvalid,
               int h, int w, int wr_rt, int wc_rt, float gate_sq, int scheme,
               float sigma, float sigma_sq, float plane_gate, float eps,
               float* __restrict__ partials, unsigned int* __restrict__ counter,
               float* __restrict__ out) {
  const int wr = WR >= 0 ? WR : wr_rt;
  const int wc = WC >= 0 ? WC : wc_rt;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ __align__(16) float block_out[kPartial];
  __shared__ bool is_last;
  const Halo halo(wr, wc);
  float* sx = smem;
  float* sn = sx + halo.floats();
  uint8_t* sv = reinterpret_cast<uint8_t*>(sn + halo.floats());

  const int strips = (w + kStrip - 1) / kStrip;
  const int r = blockIdx.x / strips;
  const int c0 = (blockIdx.x - r * strips) * kStrip;
  const int ncols = min(kStrip, w - c0);
  const int span = ncols + 2 * wc;  // staged columns this block needs
  const int lt = threadIdx.x;       // this thread's target column in the strip

  // The target first: its loads fly while the halo is staged.
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  if (lt < ncols) {
    const size_t pix = static_cast<size_t>(r) * w + c0 + lt;
    tx = timg[3 * pix];
    ty = timg[3 * pix + 1];
    tz = timg[3 * pix + 2];
  }

  // Stage the halo.  A whole strip of an aligned image goes through
  // registers: each thread loads its share of kBatchRows rows before it
  // stores any of it, so the block waits for one round trip per batch.  The
  // strip's xyz and normals are 16-byte loads on the first kCore threads,
  // its validity 16-byte chunks on the next kChunks (the strip and the
  // wrapped chunk on each side), the wrapped xyz / normal halo columns one
  // float each on the threads after them.  Anything else comes by cp.async
  // one float (and one byte) at a time.
  const int t = threadIdx.x;
  const bool vec = ncols == kStrip && (w & 15) == 0 && kCore + kChunks + 6 * wc <= kThreads &&
                   ((reinterpret_cast<uintptr_t>(mxyz) | reinterpret_cast<uintptr_t>(mnrm) |
                     reinterpret_cast<uintptr_t>(mvalid)) & 15) == 0;
  if (vec) {
    const int e = t - kCore - kChunks;  // this thread's halo float, if any
    const int right = e >= 0 && wc > 0 ? e / (3 * wc) : 0;
    const int hlc = right * (wc + kStrip) + (e - right * 3 * wc) / 3;  // its column
    const int hk = (e - right * 3 * wc) % 3;
    for (int i0 = 0; i0 < halo.rows; i0 += kBatchRows) {
      float4 ax[kBatchRows], an[kBatchRows];
      uint4 av[kBatchRows];
      float hx[kBatchRows], hn[kBatchRows];
#pragma unroll
      for (int b = 0; b < kBatchRows; ++b) {
        const int mr = r - wr + i0 + b;
        if (i0 + b >= halo.rows || mr < 0 || mr >= h) continue;
        const size_t g0 = static_cast<size_t>(mr) * w;
        if (t < kCore) {
          ax[b] = __ldg(reinterpret_cast<const float4*>(mxyz + (g0 + c0) * 3) + t);
          an[b] = __ldg(reinterpret_cast<const float4*>(mnrm + (g0 + c0) * 3) + t);
        } else if (t < kCore + kChunks) {
          const int j = t - kCore - 1;
          av[b] = __ldg(reinterpret_cast<const uint4*>(mvalid + g0 + wrap_near(c0 + 16 * j, w)));
        } else if (e < 6 * wc) {
          const size_t g = (g0 + wrap_near(c0 - wc + hlc, w)) * 3 + hk;
          hx[b] = __ldg(mxyz + g);
          hn[b] = __ldg(mnrm + g);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatchRows; ++b) {
        const int i = i0 + b, mr = r - wr + i;
        if (i >= halo.rows) continue;
        float* rx = sx + i * halo.row_floats;
        float* rn = sn + i * halo.row_floats;
        uint8_t* rv = sv + i * halo.row_bytes;
        if (mr < 0 || mr >= h) {  // zero-filled rows never win
          for (int j = t; j < span; j += kThreads) rv[halo.vcol(j)] = 0;
        } else if (t < kCore) {
          reinterpret_cast<float4*>(rx + halo.core)[t] = ax[b];
          reinterpret_cast<float4*>(rn + halo.core)[t] = an[b];
        } else if (t < kCore + kChunks) {
          reinterpret_cast<uint4*>(rv + halo.vcore)[t - kCore - 1] = av[b];
        } else if (e < 6 * wc) {
          rx[halo.col(hlc) + hk] = hx[b];
          rn[halo.col(hlc) + hk] = hn[b];
        }
      }
    }
  } else {
    for (int i = 0; i < halo.rows; ++i) {
      const int mr = r - wr + i;
      float* rx = sx + i * halo.row_floats;
      float* rn = sn + i * halo.row_floats;
      uint8_t* rv = sv + i * halo.row_bytes;
      if (mr < 0 || mr >= h) {  // zero-filled rows never win
        for (int j = t; j < span; j += kThreads) rv[halo.vcol(j)] = 0;
        continue;
      }
      const size_t g0 = static_cast<size_t>(mr) * w;
      for (int j = t; j < 3 * span; j += kThreads) {
        const int lc = j / 3, k = j - 3 * lc;
        const size_t g = (g0 + wrap(c0 - wc + lc, w)) * 3 + k;
        cp_async4(rx + halo.col(lc) + k, mxyz + g);
        cp_async4(rn + halo.col(lc) + k, mnrm + g);
      }
#pragma unroll 4
      for (int j = t; j < span; j += kThreads) {
        rv[halo.vcol(j)] = mvalid[g0 + wrap(c0 - wc + j, w)];
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // The window search: model row r - dr, column c - dc.
  const bool tvalid = lt < ncols && fmaxf(fabsf(tx), fmaxf(fabsf(ty), fabsf(tz))) > 0.0f;
  float best_d = INFINITY;
  int best = -1;  // float offset of the winner in sx / sn
  if (tvalid) {
#pragma unroll
    for (int dr = -wr; dr <= wr; ++dr) {
      const int i = wr - dr;
#pragma unroll
      for (int dc = -wc; dc <= wc; ++dc) {
        const int lc = lt + wc - dc;
        const int o = i * halo.row_floats + halo.col(lc);
        const float ex = tx - sx[o], ey = ty - sx[o + 1], ez = tz - sx[o + 2];
        const float d = ex * ex + ey * ey + ez * ez;
        if (sv[i * halo.row_bytes + halo.vcol(lc)] && d < best_d) {
          best_d = d;
          best = o;
        }
      }
    }
  }
  float bx = 0.0f, by = 0.0f, bz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (best >= 0) {
    bx = sx[best]; by = sx[best + 1]; bz = sx[best + 2];
    nx = sn[best]; ny = sn[best + 1]; nz = sn[best + 2];
  }
  __syncthreads();  // the halo is read; its memory takes the sums

  float vals[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) vals[k] = 0.0f;
  bool ok = isfinite(best_d) && best_d <= gate_sq &&
            fmaxf(fabsf(nx), fmaxf(fabsf(ny), fabsf(nz))) > 0.0f;
  const float res = (tx - bx) * nx + (ty - by) * ny + (tz - bz) * nz;
  if (plane_gate > 0.0f) ok = ok && fabsf(res) <= plane_gate;
  if (ok) {
    const float wgt = robust_weight(scheme, res, best_d, sigma, sigma_sq, eps);
    const float jac[6] = {nx, ny, nz, ty * nz - tz * ny, tz * nx - tx * nz, tx * ny - ty * nx};
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
  float* red = smem;
  float* group_sums = red + kTrees * kRow;
#pragma unroll
  for (int k = 0; k < kOut; ++k) red[slot(k, lt)] = vals[k];
  __syncthreads();
  const float s = block_sums(red, group_sums);

  // One thread writes the block's 30 sums, fences and takes a ticket.
  if (threadIdx.x < kOut) block_out[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float4* dst = reinterpret_cast<float4*>(partials + static_cast<size_t>(blockIdx.x) * kPartial);
    const float4* src = reinterpret_cast<const float4*>(block_out);
#pragma unroll
    for (int i = 0; i < kPartial / 4; ++i) dst[i] = src[i];
    __threadfence();  // the partials are visible before the ticket is taken
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // The last block sums the partials in the same order: value t of output
  // k is the partials of blocks t, t + kStrip, ... in turn.  Thread t takes
  // block t of each pass, so its stores of the 30 values hit 30 banks that
  // no other thread of its warp hits; its loads are all in flight before
  // the first is stored.
  const int nb = gridDim.x;
  for (int base = 0; base < nb; base += kStrip) {
    const bool have = base + t < nb;
    const float4* src = reinterpret_cast<const float4*>(
        partials + static_cast<size_t>(base + t) * kPartial);
    float4 v[kPartial / 4];
#pragma unroll
    for (int i = 0; i < kPartial / 4; ++i) {
      v[i] = have ? __ldcg(src + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (base == 0 || have) {
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const float4 q = v[k / 4];
        const float f = k % 4 == 0 ? q.x : k % 4 == 1 ? q.y : k % 4 == 2 ? q.z : q.w;
        float* dst = red + slot(k, t);
        *dst = base == 0 ? 0.0f + f : *dst + f;
      }
    }
    __syncthreads();
  }
  const float total = block_sums(red, group_sums);
  if (threadIdx.x < kOut) out[threadIdx.x] = total;
  if (threadIdx.x == 0) *counter = 0u;
}

int blocks_of(int h, int w) { return h * ((w + kStrip - 1) / kStrip); }

constexpr int kMaxDevices = 64;

template <int WR, int WC>
int launch(const void* timg, const void* mxyz, const void* mnrm, const void* mvalid,
           int h, int w, int wr, int wc, float gate_sq, int scheme, float sigma,
           float sigma_sq, float plane_gate, float eps, void* partials,
           void* counter, void* out, cudaStream_t stream) {
  const size_t smem = Halo(wr, wc).bytes();
  // the dynamic shared memory this instantiation may use, per device
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024 && (dev >= kMaxDevices || allowed[dev] < smem)) {
    err = cudaFuncSetAttribute(assoc_gn_fused<WR, WC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  const int blocks = blocks_of(h, w);
  assoc_gn_fused<WR, WC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(timg), static_cast<const float*>(mxyz),
      static_cast<const float*>(mnrm), static_cast<const uint8_t*>(mvalid), h, w, wr,
      wc, gate_sq, scheme, sigma, sigma_sq, plane_gate, eps,
      static_cast<float*>(partials), static_cast<unsigned int*>(counter),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of scratch the launch needs for an (h, w) image: kPartial per
// block.
int assoc_gn_partials_size(int h, int w) { return kPartial * blocks_of(h, w); }

// Launches the one pass on `stream`; returns the cudaError_t of the launch
// (0 = success).  Device pointers: timg/mxyz/mnrm (h, w, 3) float32,
// mvalid (h, w) uint8, partials assoc_gn_partials_size(h, w) floats,
// counter one unsigned int that is 0 (and is 0 again after the pass), out
// 30 floats.
int assoc_gn_launch(const void* timg, const void* mxyz, const void* mnrm,
                    const void* mvalid, int h, int w, int wr, int wc,
                    float gate_sq, int scheme, float sigma, float sigma_sq,
                    float plane_gate, float eps, void* partials, void* counter,
                    void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wr == 1 && wc == 2) {  // the aggregated champion's window
    return launch<1, 2>(timg, mxyz, mnrm, mvalid, h, w, wr, wc, gate_sq, scheme,
                        sigma, sigma_sq, plane_gate, eps, partials, counter, out, s);
  }
  return launch<-1, -1>(timg, mxyz, mnrm, mvalid, h, w, wr, wc, gate_sq, scheme,
                        sigma, sigma_sq, plane_gate, eps, partials, counter, out, s);
}

}  // extern "C"
