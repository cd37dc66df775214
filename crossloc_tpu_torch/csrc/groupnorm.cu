// Fused GroupNorm(+ReLU) forward over NHWC activations, for Hopper (sm_90a).
//
// Replaces crossloc_tpu/ops/pallas_groupnorm.py::_kernel (the TPU kernel
// launched by _pallas_forward). Same function: per (image, group) statistics
// in fp32 over H*W*channels-in-group, y = gamma * (x - mu) * rsqrt(var + eps)
// + beta, optional ReLU, output in the input's type (f32 or bf16).
//
// Bound: memory bandwidth. The work is a few flops per element, far below
// the card's flop/byte balance. The least traffic is one read of x and one
// write of y. The TPU kernel got there by holding one image in VMEM; one
// 60x90x512 f32 image (11 MB) does not fit an SM, so this file has two
// designs, chosen per shape by ops/groupnorm.py::_plan:
//
// 1. Cluster design (gn_cluster_kernel): one launch, x read once from device
//    memory, nothing written there but y. One thread block cluster of up to
//    8 CTAs per (image, channel block of cb channels = whole groups, at
//    least 64 bytes a pixel). The slab [H*W, cb] of x is split into
//    contiguous row ranges, one per CTA, and each CTA loads its range into
//    shared memory with TMA boxes [box_rows, cb] (3D tensor map over
//    [B, H*W, C], one mbarrier per box, all boxes in flight at once).
//    Statistics are exact and in fp32, over shared memory: each CTA sums its
//    rows per group as the boxes land (mean m), then sums x - m and
//    (x - m)^2 over the same rows (the corrected two-pass formula: the first
//    sum removes the rounding of m, which matters when |mu| >> std). Each
//    CTA pushes its (mean, M2) per group into every peer's shared memory
//    (distributed shared memory stores, no round trip), one cluster barrier,
//    and every CTA merges the ranks' (count, mean, M2) with Chan's formula
//    in rank order, so all get the same bits; var is clamped at 0. The apply
//    computes (x - mu) * (gamma * rstd) + beta (+ReLU) from shared memory and
//    stores 16 bytes a thread straight to y. Rows past H*W are zero-filled by
//    the load and never counted or stored.
//    What bounds it on an H100: per CTA, the statistics, the cluster barrier
//    and the merge take about as long as its loads, and the device memory
//    idles meanwhile; two CTAs share an SM where the slab allows it (the
//    planner's first choice), so one CTA's loads overlap another's sums.
//    One exchange instead of two (mean, then centred sums), pushed instead
//    of pulled, and direct stores instead of a TMA store were each measured
//    faster on the card (PERF.md).
//
// 2. Three-pass design, for slabs larger than 8 CTAs can hold (on the main
//    path the two stem layers at 480x720 and 240x360). Two reads of x, one
//    write of y, and a scratch of per-chunk partials:
//   (a) gn_stats:    each block takes one (image, chunk of H*W rows) and reads
//                    its rows as contiguous 16-byte vectors; every thread keeps
//                    Welford (mean, M2) for its 4 (f32) or 8 (bf16) channels;
//                    the block merges its row slots with Chan's formula and
//                    writes per-channel partials to scratch [B, chunks, 2, C].
//   (b) gn_finalize: one block per (image, group) merges the chunk x channel
//                    partials of the group (Chan), then writes per channel
//                    a = gamma * rsqrt(var + eps), the group mean mu, and beta.
//   (c) gn_apply:    y = max((x - mu) * a + beta, 0) over contiguous NHWC,
//                    16-byte loads and stores.
//
// Both designs centre before the scale, which keeps the precision of the
// plain version when |mu| >> std, and neither forms E[x^2] - mu^2 (the TPU
// kernel's one-pass formula, which can go negative through cancellation).
// Under autograd both write (mu, rstd) per (image, group) to `stats` (a null
// pointer skips it), which the backward reads instead of reading x again.
//
// Backward (gnb_* kernels; the TPU package has none: its _bwd,
// pallas_groupnorm.py:141, recomputes through the plain reference with
// jax.vjp). No statistics are recomputed: the forward's (mu, r = rstd) are
// read. With xhat = (x - mu) * r, pre = (x - mu) * (gamma * r) + beta
// computed as the forward computes it (so the ReLU mask m = [pre > 0] has
// the forward's bits; a tie pre == 0 gives 0, as torch.relu does), and
// gh = dy * m:
//   dbeta_c = sum gh, dgamma_c = sum gh * xhat   (over the batch and H*W)
//   dx = (gamma * r) * gh - r * c1 - (x - mu) * r^2 * c2,
//   c1 = mean_g(gamma * gh), c2 = mean_g(gamma * gh * xhat)
// Bound: memory bandwidth, as the forward; the least traffic is one read of
// x and dy and one write of dx. Two designs, chosen per shape by
// ops/groupnorm.py::_plan_backward:
//
// 1. Cluster design (gnb_cluster_kernel + gnb_batch_sums_kernel): x and dy
//    read once. One cluster per (image, channel block), the forward's
//    channel block; each CTA holds its rows of x and of dy in shared memory
//    (two 3D tensor maps, one mbarrier per box pair, all boxes in flight).
//    As the boxes land each CTA sums gh and gh * xhat per channel in fp32,
//    pushes the 2 * cb sums into every peer's shared memory, and after one
//    cluster barrier every CTA adds the ranks in rank order (the same bits
//    in all of them), forms c1 and c2 per group, and writes dx from shared
//    memory with 16-byte stores. Rank 0 writes the image's per-channel sums
//    to a scratch [B, 2, C]; a small second kernel adds the images in order
//    into dgamma and dbeta. Taken where x + dy of one (image, channel block)
//    fits 8 CTAs (two to an SM where they fit: the 25 layers at 60x90 of
//    the coord net), else a non-portable cluster of 16 CTAs of one SM each
//    (stem3; C=1536 and 2048 in f32), at most 200 KB of slab a CTA.
//    What bounds it on an H100: as in the forward's cluster design, the
//    sums, the cluster barrier and the merge leave the device memory idle
//    between a CTA's loads and its stores, which a second CTA on the SM
//    covers only in part (55-71 % of the bytes bound in f32, 46-66 % in
//    bf16 at the main path's shapes; PERF.md).
// 2. Four-kernel design, for slabs larger than 16 CTAs hold (stem1 and
//    stem2 at 480x720 and 240x360). x and dy read twice, so at most 3/5 of
//    the bytes bound; at the stems it streams at about 90 % of HBM
//    bandwidth (PERF.md):
//   (a) gnb_partials: per (image, chunk of H*W rows), per channel, fp32 sums
//       of gh and gh * xhat into scratch [B, chunks, 2, C];
//   (b) gnb_image_sums: per (image, channel), the chunks summed in order;
//   (c) gnb_finalize: per (image, group) the two group means, folded into a
//       per-channel table [B, 5, C] for (d); one more row of blocks sums
//       dgamma and dbeta over the images in order;
//   (d) gnb_apply: dx over contiguous NHWC, 16-byte loads and stores.
// Neither uses float atomics: every sum has a fixed order, so dx, dgamma
// and dbeta have the same bits from run to run.
//
// Cross-shard design, for the mesh's "spatial" axis (an image's rows split
// over ranks): four entries whose statistics are exchanged between them; see
// the section of that name below.
//
// Plain C interface (bound with ctypes). The caller allocates the outputs
// and the scratch; each function launches on the given
// stream, does not synchronise, and returns the first error (0 when every
// launch was accepted; CUDA's codes, or a negative code of this file that
// crossloc_cuda_error_string names).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// ---------------------------------------------------------------------------
// Three-pass design
// ---------------------------------------------------------------------------

// Chan et al.: merge partial (nb, mean_b, m2_b) into (n, mean, m2).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float mean_b, float m2_b) {
  if (nb <= 0.f) return;
  const float nn = n + nb;
  const float delta = mean_b - mean;
  const float wb = nb / nn;
  mean += delta * wb;
  m2 += m2_b + delta * delta * n * wb;
  n = nn;
}

template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int HW, int C,
                                int chunk_rows, int nchunks) {
  constexpr int V = Vec<T>::N;
  const int tpr = C / V;              // threads per row
  const int rpi = blockDim.x / tpr;   // row slots per block
  const int cv = threadIdx.x % tpr;   // channel vector of this thread
  const int slot = threadIdx.x / tpr;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = chunk * chunk_rows;
  const int row1 = min(row0 + chunk_rows, HW);

  float mean[V], m2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.f;
  float n = 0.f;

  const T* xb = x + (size_t)b * HW * C + (size_t)cv * V;
  for (int r = row0 + slot; r < row1; r += rpi) {
    float v[V];
    load_vec(xb + (size_t)r * C, v);
    n += 1.f;
    const float inv = 1.f / n;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = v[k] - mean[k];
      mean[k] += d * inv;
      m2[k] += d * (v[k] - mean[k]);
    }
  }

  float* out = part + ((size_t)b * nchunks + chunk) * 2 * C + (size_t)cv * V;
  if (rpi == 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = mean[k];
      out[C + k] = m2[k];
    }
    return;
  }

  // rpi > 1 only when tpr <= 128, so blockDim.x <= 256 and this fits the
  // static 48 KB of shared memory: 256 * (2 * 8 + 1) * 4 B = 17 KB
  extern __shared__ float sh[];
  float* sh_mean = sh;
  float* sh_m2 = sh + blockDim.x * V;
  float* sh_n = sh + 2 * blockDim.x * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sh_mean[threadIdx.x * V + k] = mean[k];
    sh_m2[threadIdx.x * V + k] = m2[k];
  }
  sh_n[threadIdx.x] = n;
  __syncthreads();
  if (slot != 0) return;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float nk = n, mk = mean[k], sk = m2[k];
    for (int s = 1; s < rpi; ++s) {
      const int t = s * tpr + cv;
      chan_merge(nk, mk, sk, sh_n[t], sh_mean[t * V + k], sh_m2[t * V + k]);
    }
    out[k] = mk;
    out[C + k] = sk;
  }
}

constexpr int kFinalizeThreads = 256;

// Block-wide Chan merge of image b's chunk x channel Welford partials over
// the channels of group g (blockDim.x == kFinalizeThreads): every thread
// gets the group's (count, mean, M2). The merge order is fixed, so the
// result has the same bits from run to run.
__device__ __forceinline__ void merge_group_partials(const float* __restrict__ part, int b, int g,
                                                     int HW, int C, int G, int chunk_rows,
                                                     int nchunks, float& n_out, float& mean_out,
                                                     float& m2_out) {
  const int gs = C / G;
  const int total = nchunks * gs;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int chunk = i / gs;
    const int c = g * gs + i % gs;
    const float cnt = (float)min(chunk_rows, HW - chunk * chunk_rows);
    const float* p = part + ((size_t)b * nchunks + chunk) * 2 * C;
    chan_merge(n, mean, m2, cnt, p[c], p[C + c]);
  }

  __shared__ float sn[kFinalizeThreads], smean[kFinalizeThreads], sm2[kFinalizeThreads];
  const int tid = threadIdx.x;
  sn[tid] = n;
  smean[tid] = mean;
  sm2[tid] = m2;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      float a = sn[tid], m = smean[tid], q = sm2[tid];
      chan_merge(a, m, q, sn[tid + s], smean[tid + s], sm2[tid + s]);
      sn[tid] = a;
      smean[tid] = m;
      sm2[tid] = q;
    }
    __syncthreads();
  }
  n_out = sn[0];
  mean_out = smean[0];
  m2_out = sm2[0];
}

__global__ void gn_finalize_kernel(const float* __restrict__ part, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* __restrict__ affine,
                                   float* __restrict__ stats, int HW, int C, int G, int chunk_rows,
                                   int nchunks, float eps) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int gs = C / G;
  const int tid = threadIdx.x;
  float n, mean, m2;
  merge_group_partials(part, b, g, HW, C, G, chunk_rows, nchunks, n, mean, m2);

  __shared__ float s_mu, s_rstd;
  if (tid == 0) {
    const float var = fmaxf(m2 / n, 0.f);
    s_mu = mean;
    s_rstd = rsqrtf(var + eps);
    if (stats != nullptr) {
      stats[((size_t)b * G + g) * 2] = s_mu;
      stats[((size_t)b * G + g) * 2 + 1] = s_rstd;
    }
  }
  __syncthreads();
  float* a_out = affine + (size_t)b * 3 * C;
  for (int k = tid; k < gs; k += blockDim.x) {
    const int c = g * gs + k;
    a_out[c] = gamma[c] * s_rstd;
    a_out[C + c] = s_mu;
    a_out[2 * C + c] = beta[c];
  }
}

template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float* __restrict__ affine, int HWC, int C, int relu) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y;
  const int nvec = HWC / V;
  const T* xb = x + (size_t)b * HWC;
  T* yb = y + (size_t)b * HWC;
  const float* a_img = affine + (size_t)b * 3 * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += gridDim.x * blockDim.x) {
    const int e = i * V;
    const int c = e % C;
    float v[V], a[V], mu[V], be[V];
    load_vec(xb + e, v);
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      load_vec(a_img + c + k, a + k);
      load_vec(a_img + C + c + k, mu + k);
      load_vec(a_img + 2 * C + c + k, be + k);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float o = fmaf(v[k] - mu[k], a[k], be[k]);
      v[k] = relu ? fmaxf(o, 0.f) : o;
    }
    store_vec(yb + e, v);
  }
}

template <typename T>
cudaError_t launch_three_pass(const void* x, void* y, const float* gamma, const float* beta,
                              float* part, float* affine, float* stats, int B, int HW, int C,
                              int G, int chunk_rows, int nchunks, float eps, int relu,
                              cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int tpr = C / V;
  const int rpi = tpr >= 256 ? 1 : 256 / tpr;
  const int threads = tpr * rpi;
  const size_t shmem = rpi > 1 ? (size_t)threads * (2 * V + 1) * sizeof(float) : 0;
  gn_stats_kernel<T><<<dim3(nchunks, B), threads, shmem, stream>>>(
      static_cast<const T*>(x), part, HW, C, chunk_rows, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  gn_finalize_kernel<<<dim3(G, B), kFinalizeThreads, 0, stream>>>(
      part, gamma, beta, affine, stats, HW, C, G, chunk_rows, nchunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int HWC = HW * C;
  const int nvec = HWC / V;
  int blocks = (nvec + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  gn_apply_kernel<T><<<dim3(blocks, B), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), affine, HWC, C, relu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Cluster design
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 256;   // upper bound; the launch uses vpr * (256 / vpr)
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr int kMaxClusterBackward = 16;  // non-portable; H100 allows it on request
constexpr int kMaxDynSmem = 232448;    // 227 KB, the most one block may ask for

// Errors of this file, beside CUDA's own codes.
constexpr int kErrNoEncoder = -1;      // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncode = -2;         // cuTensorMapEncodeTiled refused a tensor map
constexpr int kErrSmemPlan = -3;       // the layout needs more shared memory than planned
constexpr int kErrNoCluster = -4;      // cudaOccupancyMaxActiveClusters gave 0

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// Row slots left after a warp's shuffles (see stage_slots).
__device__ __forceinline__ int red_slots(int vpr) {
  return (32 % vpr) == 0 ? blockDim.x >> 5 : blockDim.x / vpr;
}

// First stage of the block sums, for NA arrays of per-thread partials: each
// thread holds V partials for the V channels of its column cv (channels
// cv*V .. cv*V+V-1 of the block). Leaves red[a * red_slots * cb + j * cb + c]
// = array a's partial of row slot j at channel c, then __syncthreads.
template <int V, int NA>
__device__ __forceinline__ void stage_slots(float (&acc)[NA][V], float* red, int vpr, int cb) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_red = red_slots(vpr) * cb;  // floats per array in red
  if ((32 % vpr) == 0) {
    // vpr is a power of two <= 32 and blockDim.x a multiple of 32: lanes
    // lane ^ o for o >= vpr hold the same column, so shuffles first merge a
    // warp's rows
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < vpr) break;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int k = 0; k < V; ++k) acc[a][k] += __shfl_xor_sync(0xffffffffu, acc[a][k], o);
    }
    if (lane < vpr) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int k = 0; k < V; ++k) red[a * n_red + (warp * vpr + lane) * V + k] = acc[a][k];
    }
  } else {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int k = 0; k < V; ++k) red[a * n_red + tid * V + k] = acc[a][k];
  }
  __syncthreads();
}

// Per-group sums over the block: out[a * out_stride + g] receives array a's
// sum over group g. Fixed order, so every CTA that holds the same partials
// gets the same bits. Ends with __syncthreads, so `red` may be reused.
template <int V, int NA>
__device__ __forceinline__ void block_group_sums(float (&acc)[NA][V], float* red, float* out,
                                                 int out_stride, int vpr, int cb, int gs) {
  stage_slots<V, NA>(acc, red, vpr, cb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nslots = red_slots(vpr), n_red = nslots * cb;
  // one full warp per (array, group): lane l sums the slots of the group's
  // channels l, l + 32, ..., then a shuffle tree
  const int ng = cb / gs, nwarps = blockDim.x >> 5;
  if (warp < nwarps) {
    for (int p = warp; p < NA * ng; p += nwarps) {
      const int a = p / ng, g = p % ng;
      const float* ra = red + a * n_red;
      float s = 0.f;
      for (int c = g * gs + lane; c < (g + 1) * gs; c += 32)  // slot j of channel c at j * cb + c
        for (int j = 0; j < nslots; ++j) s += ra[j * cb + c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) out[a * out_stride + g] = s;
    }
  }
  __syncthreads();
}

// Per-channel sums over the block: out[a * cb + c] receives array a's sum at
// channel c, the row slots added in order. Ends with __syncthreads.
template <int V, int NA>
__device__ __forceinline__ void block_channel_sums(float (&acc)[NA][V], float* red, float* out,
                                                   int vpr, int cb) {
  stage_slots<V, NA>(acc, red, vpr, cb);
  const int nslots = red_slots(vpr), n_red = nslots * cb;
  for (int i = threadIdx.x; i < NA * cb; i += blockDim.x) {
    const float* ra = red + (i / cb) * n_red + i % cb;
    float s = 0.f;
    for (int j = 0; j < nslots; ++j) s += ra[j * cb];
    out[i] = s;
  }
  __syncthreads();
}

// One cluster of `cs` CTAs per (image, channel block of cb channels);
// gridDim.x = cs * C / cb, gridDim.y = B. CTA `rank` holds rows
// [rank * rows_per_cta, +rows_per_cta) of its image (fewer in the last CTA),
// loaded in boxes of box_rows rows.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
    gn_cluster_kernel(const __grid_constant__ CUtensorMap xmap, T* __restrict__ y,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      float* __restrict__ stats, int HW, int C, int gs, int cb,
                      int rows_per_cta, int box_rows, int nbox, float eps, int relu) {
  constexpr int V = Vec<T>::N;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int c0 = (blockIdx.x / cs) * cb;
  const int b = blockIdx.y;
  const int row0 = rank * rows_per_cta;
  const int nrows = max(0, min(rows_per_cta, HW - row0));
  const int nbox_live = (nrows + box_rows - 1) / box_rows;
  const int vpr = cb / V;                 // 16-byte vectors per row
  const int rslots = blockDim.x / vpr;    // rows processed side by side
  const int cv = tid % vpr;               // this thread's column of vectors
  const int slot = tid / vpr;
  const int ng = cb / gs;

  // shared memory: [slab | mbarriers | red | loc | xch | mu | rstd]
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (128u - (smem_addr(smem_raw) & 127u)) & 127u;
  T* slab = reinterpret_cast<T*>(smem_raw + pad);
  const int box_elems = box_rows * cb;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(slab + (size_t)nbox * box_elems);
  float* red = reinterpret_cast<float*>(mbar + nbox);  // 2 * red_slots * cb
  float* loc = red + 2 * red_slots(vpr) * cb;  // 2 * ng: this CTA's centred sums per group
  float* xch = loc + 2 * ng;              // cs * 2 * ng: every rank's mean and M2, pushed by each
  float* g_mu = xch + 2 * ng * cs;        // ng: this CTA's, then the cluster's mean
  float* g_rstd = g_mu + ng;              // ng

  if (tid == 0) {
    for (int k = 0; k < nbox_live; ++k) mbar_init(&mbar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t box_bytes = static_cast<uint32_t>(box_elems * sizeof(T));
    for (int k = 0; k < nbox_live; ++k) {
      // rows past HW are zero-filled and still counted in the box's bytes
      mbar_expect_tx(&mbar[k], box_bytes);
      tma_load_3d(slab + (size_t)k * box_elems, &xmap, c0, row0 + k * box_rows, b, &mbar[k]);
    }
  }
  __syncthreads();
  // waited before the first write to a peer: every CTA of the cluster runs
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // pass 1 over each box as it lands: sums over this CTA's rows
  float acc[1][V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[0][k] = 0.f;
  for (int bx = 0; bx < nbox_live; ++bx) {
    mbar_wait(&mbar[bx], 0);
    const int r_end = min(box_rows, nrows - bx * box_rows);
    const T* base = slab + (size_t)bx * box_elems + cv * V;
#pragma unroll 4
    for (int r = slot; r < r_end; r += rslots) {
      float v[V];
      load_vec(base + r * cb, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[0][k] += v[k];
    }
  }
  const float n_cta = static_cast<float>(nrows) * static_cast<float>(gs);
  block_group_sums<V, 1>(acc, red, g_mu, 0, vpr, cb, gs);
  if (tid < ng) g_mu[tid] = nrows > 0 ? g_mu[tid] / n_cta : 0.f;
  __syncthreads();

  // pass 2 over the same rows: centred sums around this CTA's mean
  float mu[V], acc2[2][V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mu[k] = g_mu[(cv * V + k) / gs];
    acc2[0][k] = acc2[1][k] = 0.f;
  }
#pragma unroll 4
  for (int r = slot; r < nrows; r += rslots) {
    float v[V];
    load_vec(slab + r * cb + cv * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = v[k] - mu[k];
      acc2[0][k] += d;
      acc2[1][k] = fmaf(d, d, acc2[1][k]);
    }
  }
  block_group_sums<V, 2>(acc2, red, loc, ng, vpr, cb, gs);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // push this CTA's (mean, M2) per group into slot `rank` of every CTA's xch
  // (stores into the peers' shared memory: no round trip to wait for)
  for (int i = tid; i < ng * cs; i += blockDim.x) {
    const int g = i % ng;
    // corrected two-pass: the sum of x - mu removes the rounding of the mean
    const float corr = nrows > 0 ? loc[g] / n_cta : 0.f;
    const float mean = g_mu[g] + corr;
    const float m2 = fmaxf(loc[ng + g] - corr * corr * n_cta, 0.f);
    float* dst = cluster.map_shared_rank(xch, i / ng) + rank * 2 * ng;
    dst[g] = mean;
    dst[ng + g] = m2;
  }
  cluster.sync();  // every rank's (mean, M2) has landed in every CTA

  // merge the CTAs' (count, mean, M2) (Chan et al.), in rank order so that
  // every CTA of the cluster gets the same bits
  if (tid < ng) {
    float m[kMaxCluster], q[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      m[r] = r < cs ? xch[r * 2 * ng + tid] : 0.f;
      q[r] = r < cs ? xch[r * 2 * ng + ng + tid] : 0.f;
    }
    float n = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const float nr = static_cast<float>(max(0, min(rows_per_cta, HW - r * rows_per_cta))) * gs;
      if (r < cs && nr > 0.f) {
        const float nn = n + nr, delta = m[r] - mean, w = nr / nn;
        mean += delta * w;
        m2 += q[r] + delta * delta * n * w;
        n = nn;
      }
    }
    g_mu[tid] = mean;
    g_rstd[tid] = rsqrtf(fmaxf(m2 / n, 0.f) + eps);
    if (stats != nullptr && rank == 0) {  // every rank holds the same bits
      const size_t at = ((size_t)b * (C / gs) + c0 / gs + tid) * 2;
      stats[at] = mean;
      stats[at + 1] = g_rstd[tid];
    }
  }
  __syncthreads();

  // apply, and store 16 bytes a thread straight from registers
  float a[V], be[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = cv * V + k;
    mu[k] = g_mu[c / gs];
    a[k] = gamma[c0 + c] * g_rstd[c / gs];
    be[k] = beta[c0 + c];
  }
  T* yb = y + ((size_t)b * HW + row0) * C + c0 + cv * V;
#pragma unroll 4
  for (int r = slot; r < nrows; r += rslots) {
    float v[V];
    load_vec(slab + r * cb + cv * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float o = fmaf(v[k] - mu[k], a[k], be[k]);
      v[k] = relu ? fmaxf(o, 0.f) : o;
    }
    store_vec(yb + (size_t)r * C, v);
  }
}

// The same layout as the kernel's, in bytes (ops/groupnorm.py::_cluster_smem
// computes it too).
size_t cluster_smem_bytes(int itemsize, int V, int cb, int gs, int box_rows, int nbox,
                          int threads, int cs) {
  const int ng = cb / gs, vpr = cb / V;
  const int slots = (32 % vpr) == 0 ? threads / 32 : threads / vpr;
  const size_t slab = ((size_t)nbox * box_rows * cb * itemsize + 15) & ~(size_t)15;
  return 128 + slab + 8 * (size_t)nbox + 4 * (2 * (size_t)slots * cb + (2 * cs + 4) * ng);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// fetched once; a function-local static is initialised once whatever the
// number of host threads
EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// 3D map over NHWC viewed as [B, HW, C] (innermost first: C, HW, B), box
// [1, box_rows, cb]. L2 promotion to 256 B: a box row is only 32-64 B wide,
// and the neighbouring channel blocks (other clusters, running at the same
// time) read the rest of each 256 B.
int encode_map(CUtensorMap* map, const void* ptr, bool bf16, int B, int HW, int C, int cb,
               int box_rows) {
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)HW, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * es, (cuuint64_t)HW * C * es};
  const cuuint32_t box[3] = {(cuuint32_t)cb, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      enc(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
          const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// A cluster launch: cs CTAs a cluster along x, `threads` a CTA, `smem` bytes
// of dynamic shared memory each (not copyable: cfg points into attr).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int cs, int threads, int smem, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// configurations whose cluster occupancy was checked
struct Checked {
  const void* kernel;
  int dev, cs, threads, smem;
};
constexpr int kMaxChecked = 256;

// Before the first launch of `kernel` in a configuration on this device:
// raise its shared-memory limit to 227 KB and check that at least one
// cluster of this size and shared memory fits the card. The table is shared
// by every host thread (data-parallel eval launches on several cards from
// several threads), so a mutex guards it.
int ready_cluster(const void* kernel, const ClusterLaunch& launch, int cs) {
  static Checked checked[kMaxChecked];
  static int n_checked = 0;
  static std::mutex table_mutex;
  const std::lock_guard<std::mutex> lock(table_mutex);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const Checked key{kernel, dev, cs, static_cast<int>(launch.cfg.blockDim.x),
                    static_cast<int>(launch.cfg.dynamicSmemBytes)};
  for (int i = 0; i < n_checked; ++i)
    if (checked[i].kernel == key.kernel && checked[i].dev == dev && checked[i].cs == cs &&
        checked[i].threads == key.threads && checked[i].smem == key.smem)
      return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (err != cudaSuccess) return err;
  if (cs > kMaxCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  int n_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &launch.cfg);
  if (err != cudaSuccess) return err;
  if (n_clusters < 1) return kErrNoCluster;
  if (n_checked < kMaxChecked) checked[n_checked++] = key;
  return 0;
}

template <typename T>
int launch_cluster(const void* x, void* y, const float* gamma, const float* beta, float* stats,
                   int B, int HW, int C, int G, int cb, int cs, int rows_per_cta, int box_rows,
                   int nbox, int threads, int smem, float eps, int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int gs = C / G;
  if (cluster_smem_bytes(sizeof(T), V, cb, gs, box_rows, nbox, threads, cs) > (size_t)smem ||
      smem > kMaxDynSmem || cs > kMaxCluster)
    return kErrSmemPlan;
  const ClusterLaunch launch(dim3(cs * (C / cb), B, 1), cs, threads, smem, stream);
  int e = ready_cluster(reinterpret_cast<const void*>(gn_cluster_kernel<T>), launch, cs);
  if (e != 0) return e;
  CUtensorMap xmap;
  e = encode_map(&xmap, x, sizeof(T) == 2, B, HW, C, cb, box_rows);
  if (e != 0) return e;
  const cudaError_t err =
      cudaLaunchKernelEx(&launch.cfg, gn_cluster_kernel<T>, xmap, static_cast<T*>(y), gamma, beta,
                         stats, HW, C, gs, cb, rows_per_cta, box_rows, nbox, eps, relu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// (a) One block per (chunk of rows, image), laid out like gn_stats_kernel:
// tpr threads across a row of C channels, rpi rows side by side. Writes
// part[b, chunk, 0, c] = sum gh and part[b, chunk, 1, c] = sum gh * xhat.
template <typename T>
__global__ void gnb_partials_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    const float* __restrict__ stats, float* __restrict__ part,
                                    int HW, int C, int G, int chunk_rows, int nchunks, int relu) {
  constexpr int V = Vec<T>::N;
  const int tpr = C / V;
  const int rpi = blockDim.x / tpr;
  const int cv = threadIdx.x % tpr;
  const int slot = threadIdx.x / tpr;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int gs = C / G;
  const int row0 = chunk * chunk_rows;
  const int row1 = min(row0 + chunk_rows, HW);

  float mu[V], r[V], a[V], be[V], s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = cv * V + k;
    const float* st = stats + ((size_t)b * G + c / gs) * 2;
    mu[k] = st[0];
    r[k] = st[1];
    a[k] = gamma[c] * r[k];  // the forward's product, so pre has its bits
    be[k] = beta[c];
    s1[k] = s2[k] = 0.f;
  }
  const size_t base = (size_t)b * HW * C + (size_t)cv * V;
  for (int row = row0 + slot; row < row1; row += rpi) {
    float v[V], g[V];
    load_vec(x + base + (size_t)row * C, v);
    load_vec(dy + base + (size_t)row * C, g);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = v[k] - mu[k];
      const float gh = (relu && !(fmaf(d, a[k], be[k]) > 0.f)) ? 0.f : g[k];
      s1[k] += gh;
      s2[k] = fmaf(gh, d * r[k], s2[k]);
    }
  }

  float* out = part + ((size_t)b * nchunks + chunk) * 2 * C + (size_t)cv * V;
  if (rpi == 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = s1[k];
      out[C + k] = s2[k];
    }
    return;
  }
  // rpi > 1 only when tpr <= 128, so blockDim.x <= 256: 256 * 2 * 8 * 4 B = 16 KB
  extern __shared__ float sh[];
  float* sh1 = sh;
  float* sh2 = sh + blockDim.x * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sh1[threadIdx.x * V + k] = s1[k];
    sh2[threadIdx.x * V + k] = s2[k];
  }
  __syncthreads();
  if (slot != 0) return;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float t1 = s1[k], t2 = s2[k];
    for (int s = 1; s < rpi; ++s) {  // slots in order
      const int t = s * tpr + cv;
      t1 += sh1[t * V + k];
      t2 += sh2[t * V + k];
    }
    out[k] = t1;
    out[C + k] = t2;
  }
}

// (b) sums[b, j, c] = sum over chunks of part[b, chunk, j, c]: blocks of
// 32 channels x 8 chunk lanes, each lane's chunks in order, then the lanes
// in order.
constexpr int kSumLanes = 8;

__global__ void gnb_image_sums_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                      int C, int nchunks) {
  __shared__ float tile[2][kSumLanes][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.y;
  float t1 = 0.f, t2 = 0.f;
  if (c < C) {
    for (int j = lane; j < nchunks; j += kSumLanes) {
      const float* p = part + ((size_t)b * nchunks + j) * 2 * C;
      t1 += p[c];
      t2 += p[C + c];
    }
  }
  tile[0][lane][threadIdx.x] = t1;
  tile[1][lane][threadIdx.x] = t2;
  __syncthreads();
  if (lane == 0 && c < C) {
    for (int l = 1; l < kSumLanes; ++l) {
      t1 += tile[0][l][threadIdx.x];
      t2 += tile[1][l][threadIdx.x];
    }
    sums[(size_t)b * 2 * C + c] = t1;
    sums[(size_t)b * 2 * C + C + c] = t2;
  }
}

// (c) One warp per (group, image) for blockIdx.y < B: the two group means
// and the per-channel table of (d): mu, gamma * r, beta, r * c1, r^2 * c2,
// where dx = (gamma * r) * gh - r * c1 - (x - mu) * r^2 * c2. Blocks with
// blockIdx.y == B sum dgamma and dbeta of the group's channels over the
// images in order.
__global__ void gnb_finalize_kernel(const float* __restrict__ sums,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    const float* __restrict__ stats, float* __restrict__ table,
                                    float* __restrict__ dgamma, float* __restrict__ dbeta, int B,
                                    int HW, int C, int G) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int gs = C / G;
  if (b == B) {
    for (int c = g * gs + lane; c < (g + 1) * gs; c += 32) {
      float db = 0.f, dg = 0.f;
      for (int i = 0; i < B; ++i) {
        db += sums[(size_t)i * 2 * C + c];
        dg += sums[(size_t)i * 2 * C + C + c];
      }
      dbeta[c] = db;
      dgamma[c] = dg;
    }
    return;
  }
  const float* s = sums + (size_t)b * 2 * C;
  float t1 = 0.f, t2 = 0.f;
  for (int c = g * gs + lane; c < (g + 1) * gs; c += 32) {
    t1 = fmaf(gamma[c], s[c], t1);
    t2 = fmaf(gamma[c], s[C + c], t2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    t1 += __shfl_xor_sync(0xffffffffu, t1, o);
    t2 += __shfl_xor_sync(0xffffffffu, t2, o);
  }
  const float n = (float)HW * (float)gs;
  const float mu = stats[((size_t)b * G + g) * 2];
  const float r = stats[((size_t)b * G + g) * 2 + 1];
  const float c1 = t1 / n, c2 = t2 / n;
  float* tb = table + (size_t)b * 5 * C;
  for (int c = g * gs + lane; c < (g + 1) * gs; c += 32) {
    tb[c] = mu;
    tb[C + c] = gamma[c] * r;
    tb[2 * C + c] = beta[c];
    tb[3 * C + c] = r * c1;
    tb[4 * C + c] = r * r * c2;
  }
}

// (d) dx over contiguous NHWC, V elements a thread, as gn_apply_kernel.
template <typename T>
__global__ void gnb_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                 T* __restrict__ dx, const float* __restrict__ table, int HWC,
                                 int C, int relu) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y;
  const int nvec = HWC / V;
  const size_t off = (size_t)b * HWC;
  const float* tb = table + (size_t)b * 5 * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += gridDim.x * blockDim.x) {
    const int e = i * V;
    const int c = e % C;
    float v[V], g[V], t[5][V];
    load_vec(x + off + e, v);
    load_vec(dy + off + e, g);
#pragma unroll
    for (int j = 0; j < 5; ++j)
#pragma unroll
      for (int k = 0; k < V; k += 4) load_vec(tb + j * C + c + k, t[j] + k);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = v[k] - t[0][k];
      const float gh = (relu && !(fmaf(d, t[1][k], t[2][k]) > 0.f)) ? 0.f : g[k];
      v[k] = fmaf(t[1][k], gh, -fmaf(d, t[4][k], t[3][k]));
    }
    store_vec(dx + off + e, v);
  }
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* dy, const float* gamma, const float* beta,
                            const float* stats, void* dx, float* dgamma, float* dbeta,
                            float* part, float* sums, float* table, int B, int HW, int C, int G,
                            int chunk_rows, int nchunks, int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int tpr = C / V;
  const int rpi = tpr >= 256 ? 1 : 256 / tpr;
  const int threads = tpr * rpi;
  const size_t shmem = rpi > 1 ? (size_t)threads * 2 * V * sizeof(float) : 0;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  gnb_partials_kernel<T><<<dim3(nchunks, B), threads, shmem, stream>>>(
      xt, dyt, gamma, beta, stats, part, HW, C, G, chunk_rows, nchunks, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  gnb_image_sums_kernel<<<dim3((C + 31) / 32, B), dim3(32, kSumLanes), 0, stream>>>(
      part, sums, C, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  gnb_finalize_kernel<<<dim3(G, B + 1), 32, 0, stream>>>(sums, gamma, beta, stats, table, dgamma,
                                                          dbeta, B, HW, C, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int HWC = HW * C;
  int blocks = (HWC / V + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  gnb_apply_kernel<T><<<dim3(blocks, B), 256, 0, stream>>>(xt, dyt, static_cast<T*>(dx), table,
                                                            HWC, C, relu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, cluster design
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ size_t round_up(size_t n, size_t to) {
  return (n + to - 1) / to * to;
}

// One cluster of `cs` CTAs per (image, channel block of cb channels), as
// gn_cluster_kernel; each CTA holds its rows of x and of dy. Writes dx, and
// (rank 0 of each cluster) sums[b, 0, c] = sum gh and sums[b, 1, c] =
// sum gh * xhat over the image.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
    gnb_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap dymap, T* __restrict__ dx,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ stats, float* __restrict__ sums, int HW, int C,
                       int gs, int cb, int rows_per_cta, int box_rows, int nbox, int relu) {
  constexpr int V = Vec<T>::N;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int c0 = (blockIdx.x / cs) * cb;
  const int b = blockIdx.y;
  const int row0 = rank * rows_per_cta;
  const int nrows = max(0, min(rows_per_cta, HW - row0));
  const int nbox_live = (nrows + box_rows - 1) / box_rows;
  const int vpr = cb / V;                 // 16-byte vectors per row
  const int rslots = blockDim.x / vpr;    // rows processed side by side
  const int cv = tid % vpr;               // this thread's column of vectors
  const int slot = tid / vpr;
  const int ng = cb / gs, G = C / gs;

  // shared memory: [x slab | dy slab | mbarriers | red | part | xch | csum | coef]
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (128u - (smem_addr(smem_raw) & 127u)) & 127u;
  const int box_elems = box_rows * cb;
  const size_t slab_bytes = (size_t)nbox * box_elems * sizeof(T);
  T* xs = reinterpret_cast<T*>(smem_raw + pad);
  T* ds = reinterpret_cast<T*>(smem_raw + pad + round_up(slab_bytes, 128));
  uint64_t* mbar =
      reinterpret_cast<uint64_t*>(smem_raw + pad + round_up(slab_bytes, 128) +
                                  round_up(slab_bytes, 16));
  float* red = reinterpret_cast<float*>(mbar + nbox);  // 2 * red_slots * cb
  float* part = red + 2 * red_slots(vpr) * cb;  // 2 * cb: this CTA's sums per channel
  float* xch = part + 2 * cb;             // cs * 2 * cb: every rank's, pushed by each
  float* csum = xch + 2 * cb * cs;        // 2 * cb: the image's sums per channel
  float* coef = csum + 2 * cb;            // 2 * ng: r * c1 and r^2 * c2 per group

  if (tid == 0) {
    for (int k = 0; k < nbox_live; ++k) mbar_init(&mbar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t box_bytes = static_cast<uint32_t>(box_elems * sizeof(T));
    for (int k = 0; k < nbox_live; ++k) {
      // one barrier per box pair; rows past HW are zero-filled and still
      // counted in the box's bytes
      mbar_expect_tx(&mbar[k], 2 * box_bytes);
      const int row = row0 + k * box_rows;
      tma_load_3d(xs + (size_t)k * box_elems, &xmap, c0, row, b, &mbar[k]);
      tma_load_3d(ds + (size_t)k * box_elems, &dymap, c0, row, b, &mbar[k]);
    }
  }
  __syncthreads();
  // waited before the first write to a peer: every CTA of the cluster runs
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the forward's per-channel constants: a = gamma * r is its product, so
  // pre = fmaf(x - mu, a, beta) and the ReLU mask have its bits
  float mu[V], r[V], a[V], be[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = c0 + cv * V + k;
    const float* st = stats + ((size_t)b * G + c / gs) * 2;
    mu[k] = st[0];
    r[k] = st[1];
    a[k] = gamma[c] * r[k];
    be[k] = beta[c];
  }

  // sums over this CTA's rows, each box as it lands
  float acc[2][V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[0][k] = acc[1][k] = 0.f;
  for (int bx = 0; bx < nbox_live; ++bx) {
    mbar_wait(&mbar[bx], 0);
    const int r_end = min(box_rows, nrows - bx * box_rows);
    const size_t at = (size_t)bx * box_elems + cv * V;
#pragma unroll 4
    for (int row = slot; row < r_end; row += rslots) {
      float v[V], g[V];
      load_vec(xs + at + row * cb, v);
      load_vec(ds + at + row * cb, g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = v[k] - mu[k];
        const float gh = (relu && !(fmaf(d, a[k], be[k]) > 0.f)) ? 0.f : g[k];
        acc[0][k] += gh;
        acc[1][k] = fmaf(gh, d * r[k], acc[1][k]);
      }
    }
  }
  block_channel_sums<V, 2>(acc, red, part, vpr, cb);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // push this CTA's sums into slot `rank` of every CTA's xch (stores into the
  // peers' shared memory: no round trip to wait for)
  for (int i = tid; i < 2 * cb * cs; i += blockDim.x)
    cluster.map_shared_rank(xch, i / (2 * cb))[rank * 2 * cb + i % (2 * cb)] = part[i % (2 * cb)];
  cluster.sync();  // every rank's sums have landed in every CTA

  // the image's sums per channel, the ranks added in order: every CTA of
  // the cluster gets the same bits
  for (int i = tid; i < 2 * cb; i += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < cs; ++k) s += xch[k * 2 * cb + i];
    csum[i] = s;
    if (rank == 0) sums[(size_t)b * 2 * C + (i / cb) * C + c0 + i % cb] = s;
  }
  __syncthreads();
  // the group means c1 = mean(gamma * gh), c2 = mean(gamma * gh * xhat)
  if (tid < ng) {
    float t1 = 0.f, t2 = 0.f;
    for (int c = tid * gs; c < (tid + 1) * gs; ++c) {
      t1 = fmaf(gamma[c0 + c], csum[c], t1);
      t2 = fmaf(gamma[c0 + c], csum[cb + c], t2);
    }
    const float n = (float)HW * (float)gs;
    const float rg = stats[((size_t)b * G + c0 / gs + tid) * 2 + 1];
    coef[tid] = rg * (t1 / n);
    coef[ng + tid] = rg * rg * (t2 / n);
  }
  __syncthreads();

  // dx = (gamma * r) * gh - r * c1 - (x - mu) * r^2 * c2 from shared memory,
  // 16 bytes a thread straight to device memory
  float rc1[V], r2c2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int g = (cv * V + k) / gs;
    rc1[k] = coef[g];
    r2c2[k] = coef[ng + g];
  }
  T* out = dx + ((size_t)b * HW + row0) * C + c0 + cv * V;
#pragma unroll 4
  for (int row = slot; row < nrows; row += rslots) {
    float v[V], g[V];
    load_vec(xs + row * cb + cv * V, v);
    load_vec(ds + row * cb + cv * V, g);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = v[k] - mu[k];
      const float gh = (relu && !(fmaf(d, a[k], be[k]) > 0.f)) ? 0.f : g[k];
      v[k] = fmaf(a[k], gh, -fmaf(d, r2c2[k], rc1[k]));
    }
    store_vec(out + (size_t)row * C, v);
  }
}

// dgamma and dbeta: the images' sums added in order, one thread a channel.
__global__ void gnb_batch_sums_kernel(const float* __restrict__ sums, float* __restrict__ dgamma,
                                      float* __restrict__ dbeta, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float db = 0.f, dg = 0.f;
  for (int i = 0; i < B; ++i) {
    db += sums[(size_t)i * 2 * C + c];
    dg += sums[(size_t)i * 2 * C + C + c];
  }
  dbeta[c] = db;
  dgamma[c] = dg;
}

// The same layout as gnb_cluster_kernel's, in bytes
// (ops/groupnorm.py::_cluster_backward_smem computes it too).
size_t cluster_backward_smem_bytes(int itemsize, int V, int cb, int gs, int box_rows, int nbox,
                                   int threads, int cs) {
  const int ng = cb / gs, vpr = cb / V;
  const int slots = (32 % vpr) == 0 ? threads / 32 : threads / vpr;
  const size_t slab = (size_t)nbox * box_rows * cb * itemsize;
  return 128 + round_up(slab, 128) + round_up(slab, 16) + 8 * (size_t)nbox +
         4 * (2 * (size_t)slots * cb + (2 * (size_t)cs + 4) * cb + 2 * ng);
}

template <typename T>
int launch_cluster_backward(const void* x, const void* dy, const float* gamma, const float* beta,
                            const float* stats, void* dx, float* dgamma, float* dbeta,
                            float* sums, int B, int HW, int C, int G, int cb, int cs,
                            int rows_per_cta, int box_rows, int nbox, int threads, int smem,
                            int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int gs = C / G;
  if (cluster_backward_smem_bytes(sizeof(T), V, cb, gs, box_rows, nbox, threads, cs) >
          (size_t)smem ||
      smem > kMaxDynSmem || cs > kMaxClusterBackward)
    return kErrSmemPlan;
  const ClusterLaunch launch(dim3(cs * (C / cb), B, 1), cs, threads, smem, stream);
  int e = ready_cluster(reinterpret_cast<const void*>(gnb_cluster_kernel<T>), launch, cs);
  if (e != 0) return e;
  CUtensorMap xmap, dymap;
  e = encode_map(&xmap, x, sizeof(T) == 2, B, HW, C, cb, box_rows);
  if (e != 0) return e;
  e = encode_map(&dymap, dy, sizeof(T) == 2, B, HW, C, cb, box_rows);
  if (e != 0) return e;
  cudaError_t err = cudaLaunchKernelEx(&launch.cfg, gnb_cluster_kernel<T>, xmap, dymap,
                                       static_cast<T*>(dx), gamma, beta, stats, sums, HW, C, gs,
                                       cb, rows_per_cta, box_rows, nbox, relu);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gnb_batch_sums_kernel<<<(C + 255) / 256, 256, 0, stream>>>(sums, dgamma, dbeta, B, C);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Cross-shard design (the mesh's "spatial" axis, parallel/spatial.py)
// ---------------------------------------------------------------------------
//
// On a height shard an image's rows are split over the ranks of a spatial
// group, so a norm's per-(image, group) statistics, and its backward's
// per-(image, channel) sums, span ranks. Neither unsharded design can take
// that: the cluster designs compute and apply in one launch, and the
// three-pass and four-kernel designs merge only the chunks of their own
// tensor. So the work splits at the exchange, into four entries, each a
// launch sequence on the caller's stream; parallel/spatial.py all-gathers
// over the spatial group between them:
//   K1-shard-stats      gn_stats_kernel's per-chunk Welford partials, then
//                       gn_shard_stats_kernel merges each (image, group)'s
//                       chunk x channel partials (Chan) into (count, mean,
//                       M2): B * G * 3 floats to exchange, not the partials.
//   K1-shard-apply      gn_shard_merge_kernel merges the ranks' (count, mean,
//                       M2) with Chan's formula in rank order, so every rank
//                       gets the same bits, clamps var at 0, writes (mu,
//                       rstd) to `stats` for the backward and the affine of
//                       gn_apply_kernel, which writes y.
//   K1-bwd-shard-sums   gnb_partials_kernel and gnb_image_sums_kernel: per
//                       (image, channel), the sums of gh and gh * xhat over
//                       the shard's rows.
//   K1-bwd-shard-apply  gnb_shard_sums_kernel adds the ranks' sums in rank
//                       order; gnb_batch_sums_kernel gives dgamma and dbeta
//                       from this shard's own sums (the training step's
//                       all-reduce over the ranks adds the shards);
//                       gnb_finalize_kernel with the image's whole H*W as
//                       the count (its dgamma row of blocks not launched);
//                       gnb_apply_kernel writes dx.
// Bound: bytes, as the unsharded designs. Each direction reads x (and dy)
// twice, once for the statistics and once for the apply: one read more
// than the bound, the price of applying only after the exchange.

// One block per (group, image): the chunk x channel Welford partials of
// the group merged into out[b, g] = (count, mean, M2).
__global__ void gn_shard_stats_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      int HW, int C, int G, int chunk_rows, int nchunks) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  float n, mean, m2;
  merge_group_partials(part, b, g, HW, C, G, chunk_rows, nchunks, n, mean, m2);
  if (threadIdx.x == 0) {
    float* o = out + ((size_t)b * G + g) * 3;
    o[0] = n;
    o[1] = mean;
    o[2] = m2;
  }
}

// One warp per (group, image): gathered [S, B, G, 3] merged in rank order,
// then (mu, rstd) to stats [B, G, 2] and the affine [B, 3, C] of
// gn_apply_kernel (gamma * rstd, mu, beta).
__global__ void gn_shard_merge_kernel(const float* __restrict__ gathered,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta, float* __restrict__ affine,
                                      float* __restrict__ stats, int S, int B, int C, int G,
                                      float eps) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int gs = C / G;
  __shared__ float s_mu, s_rstd;
  if (threadIdx.x == 0) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* p = gathered + (((size_t)s * B + b) * G + g) * 3;
      chan_merge(n, mean, m2, p[0], p[1], p[2]);
    }
    const float var = fmaxf(m2 / n, 0.f);
    s_mu = mean;
    s_rstd = rsqrtf(var + eps);
    stats[((size_t)b * G + g) * 2] = s_mu;
    stats[((size_t)b * G + g) * 2 + 1] = s_rstd;
  }
  __syncthreads();
  float* a_out = affine + (size_t)b * 3 * C;
  for (int k = threadIdx.x; k < gs; k += blockDim.x) {
    const int c = g * gs + k;
    a_out[c] = gamma[c] * s_rstd;
    a_out[C + c] = s_mu;
    a_out[2 * C + c] = beta[c];
  }
}

// sums[i] = sum over the S ranks, in rank order, of gathered[s, i]; n = B * 2 * C.
__global__ void gnb_shard_sums_kernel(const float* __restrict__ gathered,
                                      float* __restrict__ sums, int S, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = 0.f;
  for (int s = 0; s < S; ++s) t += gathered[(size_t)s * n + i];
  sums[i] = t;
}

template <typename T>
cudaError_t launch_shard_stats(const void* x, float* part, float* out, int B, int HW, int C,
                               int G, int chunk_rows, int nchunks, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int tpr = C / V;
  const int rpi = tpr >= 256 ? 1 : 256 / tpr;
  const int threads = tpr * rpi;
  const size_t shmem = rpi > 1 ? (size_t)threads * (2 * V + 1) * sizeof(float) : 0;
  gn_stats_kernel<T><<<dim3(nchunks, B), threads, shmem, stream>>>(
      static_cast<const T*>(x), part, HW, C, chunk_rows, nchunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_shard_stats_kernel<<<dim3(G, B), kFinalizeThreads, 0, stream>>>(part, out, HW, C, G,
                                                                     chunk_rows, nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_shard_apply(const void* x, void* y, const float* gamma, const float* beta,
                               const float* gathered, float* affine, float* stats, int S, int B,
                               int HW, int C, int G, float eps, int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  gn_shard_merge_kernel<<<dim3(G, B), 32, 0, stream>>>(gathered, gamma, beta, affine, stats, S,
                                                       B, C, G, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int HWC = HW * C;
  int blocks = (HWC / V + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  gn_apply_kernel<T><<<dim3(blocks, B), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), affine, HWC, C, relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_shard_backward_sums(const void* x, const void* dy, const float* gamma,
                                       const float* beta, const float* stats, float* part,
                                       float* sums, int B, int HW, int C, int G, int chunk_rows,
                                       int nchunks, int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int tpr = C / V;
  const int rpi = tpr >= 256 ? 1 : 256 / tpr;
  const int threads = tpr * rpi;
  const size_t shmem = rpi > 1 ? (size_t)threads * 2 * V * sizeof(float) : 0;
  gnb_partials_kernel<T><<<dim3(nchunks, B), threads, shmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta, stats, part, HW, C, G,
      chunk_rows, nchunks, relu);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gnb_image_sums_kernel<<<dim3((C + 31) / 32, B), dim3(32, kSumLanes), 0, stream>>>(
      part, sums, C, nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_shard_backward_apply(const void* x, const void* dy, const float* gamma,
                                        const float* beta, const float* stats,
                                        const float* gathered, float* sums, float* table,
                                        void* dx, float* dgamma, float* dbeta, int index, int S,
                                        int B, int HW, int count_hw, int C, int G, int relu,
                                        cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int n = B * 2 * C;
  gnb_shard_sums_kernel<<<(n + 255) / 256, 256, 0, stream>>>(gathered, sums, S, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gnb_batch_sums_kernel<<<(C + 255) / 256, 256, 0, stream>>>(gathered + (size_t)index * n,
                                                             dgamma, dbeta, B, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gnb_finalize_kernel<<<dim3(G, B), 32, 0, stream>>>(sums, gamma, beta, stats, table, dgamma,
                                                     dbeta, B, count_hw, C, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int HWC = HW * C;
  int blocks = (HWC / V + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  gnb_apply_kernel<T><<<dim3(blocks, B), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), table, HWC, C,
      relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int crossloc_gn_forward(const void* x, void* y, const float* gamma, const float* beta,
                                   float* part, float* affine, float* stats, int B, int HW, int C,
                                   int G, int chunk_rows, int nchunks, float eps, int relu,
                                   int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_three_pass<__nv_bfloat16>(x, y, gamma, beta, part, affine, stats, B, HW,
                                                 C, G, chunk_rows, nchunks, eps, relu, s)
              : launch_three_pass<float>(x, y, gamma, beta, part, affine, stats, B, HW, C, G,
                                         chunk_rows, nchunks, eps, relu, s);
  return static_cast<int>(err);
}

extern "C" int crossloc_gn_cluster_forward(const void* x, void* y, const float* gamma,
                                           const float* beta, float* stats, int B, int HW, int C,
                                           int G, int cb, int cluster, int rows_per_cta,
                                           int box_rows, int nbox, int threads, int smem,
                                           float eps, int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_cluster<__nv_bfloat16>(x, y, gamma, beta, stats, B, HW, C, G, cb,
                                                 cluster, rows_per_cta, box_rows, nbox, threads,
                                                 smem, eps, relu, s)
                 : launch_cluster<float>(x, y, gamma, beta, stats, B, HW, C, G, cb, cluster,
                                         rows_per_cta, box_rows, nbox, threads, smem, eps, relu,
                                         s);
}

extern "C" int crossloc_gn_backward(const void* x, const void* dy, const float* gamma,
                                    const float* beta, const float* stats, void* dx,
                                    float* dgamma, float* dbeta, float* part, float* sums,
                                    float* table, int B, int HW, int C, int G, int chunk_rows,
                                    int nchunks, int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_backward<__nv_bfloat16>(x, dy, gamma, beta, stats, dx, dgamma, dbeta,
                                               part, sums, table, B, HW, C, G, chunk_rows,
                                               nchunks, relu, s)
              : launch_backward<float>(x, dy, gamma, beta, stats, dx, dgamma, dbeta, part, sums,
                                       table, B, HW, C, G, chunk_rows, nchunks, relu, s);
  return static_cast<int>(err);
}

extern "C" int crossloc_gn_cluster_backward(const void* x, const void* dy, const float* gamma,
                                            const float* beta, const float* stats, void* dx,
                                            float* dgamma, float* dbeta, float* sums, int B,
                                            int HW, int C, int G, int cb, int cluster,
                                            int rows_per_cta, int box_rows, int nbox, int threads,
                                            int smem, int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_cluster_backward<__nv_bfloat16>(
                       x, dy, gamma, beta, stats, dx, dgamma, dbeta, sums, B, HW, C, G, cb,
                       cluster, rows_per_cta, box_rows, nbox, threads, smem, relu, s)
                 : launch_cluster_backward<float>(x, dy, gamma, beta, stats, dx, dgamma, dbeta,
                                                  sums, B, HW, C, G, cb, cluster, rows_per_cta,
                                                  box_rows, nbox, threads, smem, relu, s);
}

extern "C" int crossloc_gn_shard_stats(const void* x, float* part, float* out, int B, int HW,
                                       int C, int G, int chunk_rows, int nchunks, int is_bf16,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_shard_stats<__nv_bfloat16>(x, part, out, B, HW, C, G, chunk_rows, nchunks,
                                                  s)
              : launch_shard_stats<float>(x, part, out, B, HW, C, G, chunk_rows, nchunks, s));
}

extern "C" int crossloc_gn_shard_apply(const void* x, void* y, const float* gamma,
                                       const float* beta, const float* gathered, float* affine,
                                       float* stats, int S, int B, int HW, int C, int G,
                                       float eps, int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_shard_apply<__nv_bfloat16>(x, y, gamma, beta, gathered, affine, stats, S,
                                                  B, HW, C, G, eps, relu, s)
              : launch_shard_apply<float>(x, y, gamma, beta, gathered, affine, stats, S, B, HW,
                                          C, G, eps, relu, s));
}

extern "C" int crossloc_gn_shard_backward_sums(const void* x, const void* dy, const float* gamma,
                                               const float* beta, const float* stats,
                                               float* part, float* sums, int B, int HW, int C,
                                               int G, int chunk_rows, int nchunks, int relu,
                                               int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_shard_backward_sums<__nv_bfloat16>(x, dy, gamma, beta, stats, part, sums,
                                                          B, HW, C, G, chunk_rows, nchunks,
                                                          relu, s)
              : launch_shard_backward_sums<float>(x, dy, gamma, beta, stats, part, sums, B, HW,
                                                  C, G, chunk_rows, nchunks, relu, s));
}

extern "C" int crossloc_gn_shard_backward_apply(const void* x, const void* dy,
                                                const float* gamma, const float* beta,
                                                const float* stats, const float* gathered,
                                                float* sums, float* table, void* dx,
                                                float* dgamma, float* dbeta, int index, int S,
                                                int B, int HW, int count_hw, int C, int G,
                                                int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_shard_backward_apply<__nv_bfloat16>(x, dy, gamma, beta, stats, gathered,
                                                           sums, table, dx, dgamma, dbeta, index,
                                                           S, B, HW, count_hw, C, G, relu, s)
              : launch_shard_backward_apply<float>(x, dy, gamma, beta, stats, gathered, sums,
                                                   table, dx, dgamma, dbeta, index, S, B, HW,
                                                   count_hw, C, G, relu, s));
}

extern "C" const char* crossloc_cuda_error_string(int err) {
  switch (err) {
    case kErrNoEncoder:
      return "libcuda has no cuTensorMapEncodeTiled";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused the tensor map";
    case kErrSmemPlan:
      return "the cluster kernel's shared-memory layout exceeds the planned bytes or 227 KB";
    case kErrNoCluster:
      return "no cluster of this size and shared memory fits the card "
             "(cudaOccupancyMaxActiveClusters = 0)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
