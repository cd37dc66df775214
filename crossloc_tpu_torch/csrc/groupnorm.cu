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
// 60x90x512 f32 image (11 MB) does not fit an SM, so this file has three
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
// 2. Grid design (gn_grid_kernel), for slabs larger than a cluster holds:
//    on the main path the two stem layers at 480x720 and 240x360, whose
//    slabs (5.5-22 MB) fit the card's shared memory (132 SMs x 200 KB, 27
//    MB) but not a cluster's. One cooperative launch of one CTA an SM, x
//    read once. A unit (image, channel block: whole L2 lines or the whole
//    pixel, else K1's 64-byte block) spreads over k <= 132 CTAs; pair
//    unit * k + rank goes to CTA (pair mod grid), each CTA taking its pairs
//    in order, and k divides the grid where units fill several rounds. Per
//    pair: TMA loads of the rank's rows (a 64-byte L2 promotion: the units
//    of one image run one after another, so a wider promotion fetches other
//    blocks' bytes too early), per-channel sums of x - pivot and (x -
//    pivot)^2 as the boxes land (the pivot is the unit's first row, read by
//    every rank: one pass, no division), the rank's sums to a scratch of
//    the call's own, an arrival on the unit's integer counter (set to 0 by
//    the kernel itself before one grid barrier), the unit's sums added over
//    the ranks in a fixed order by every CTA of the unit alike (16-byte
//    loads all in flight), the group statistics as the cross-shard design
//    takes them, and the apply from shared memory with 16-byte stores; as
//    each box is stored it takes the next pair's rows, which are summed a
//    few boxes behind. Where the slab outgrows the card (stem1 in f32, 44
//    MB of 128-byte rows) each CTA holds what 200 KB takes and streams the
//    rest from device memory, in the sums and again in the apply (from the
//    L2 in part): 1.4 reads of x instead of 2.
//    What bounds it on an H100: every unit spans most of the card, so each
//    round of pairs ends in the statistics tail, the unit's barrier and the
//    merge, with the device memory idle while every SM waits on the slowest
//    rank (the apply itself runs near the memory's rate); 55-65 % of the
//    bytes bound at the stems, against 36-56 % for the three-pass design
//    (PERF.md). Two CTAs an SM (with half the slab each), 256-byte L2
//    promotion, a second statistics pass over shared memory, and merging
//    (count, mean, M2) by one warp a group were each measured slower.
//
// 3. Three-pass design, for slabs larger than the grid design holds. Two
//    reads of x, one write of y, and a scratch of per-chunk partials:
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
// Every design centres before the scale, which keeps the precision of the
// plain version when |mu| >> std, and none forms E[x^2] - mu^2 (the TPU
// kernel's one-pass formula, which can go negative through cancellation;
// the grid design's sums are about a pivot drawn from the data). Under
// autograd each writes (mu, rstd) per (image, group) to `stats` (a null
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
// x and dy and one write of dx. Three designs, chosen per shape by
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
// 2. Grid design (gnb_grid_kernel + gnb_batch_sums_kernel), the forward's
//    skeleton with x and dy held together, for slabs larger than 16 CTAs
//    hold that the card's shared memory holds whole (stem2: 11 MB of 64-byte
//    rows a unit). Per pair the sums of gh and gh * xhat per channel, the
//    unit's sums added over the ranks, c1 and c2 per group, and dx from
//    shared memory; rank 0 writes the image's sums to a scratch [B, 2, C],
//    which the second kernel adds in order into dgamma and dbeta.
//    stem1's x + dy (44 MB an image at 64 bytes a pixel) do not fit: 32-byte
//    blocks held whole, and 64-byte blocks streaming what 200 KB does not
//    hold, were both measured slower there than the four-kernel design
//    (PERF.md), which it keeps.
// 3. Four-kernel design, for slabs larger than the grid design holds
//    (stem1). x and dy read twice, so at most 3/5 of the bytes bound; at
//    stem1 it streams at about 90 % of HBM bandwidth (PERF.md):
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
constexpr int kErrNoResidency = -5;    // a cooperative grid larger than the card holds at once

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
// [1, box_rows, cb]. L2 promotion to 256 B where the neighbouring channel
// blocks (other clusters, running at the same time) read the rest of each
// 256 B; else (`wide` false: the grid design, whose units of one image run
// one after another) to 64 B, so a box row fetches no other block's bytes
// (measured: PERF.md).
int encode_map(CUtensorMap* map, const void* ptr, bool bf16, int B, int HW, int C, int cb,
               int box_rows, bool wide = true) {
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
          CU_TENSOR_MAP_SWIZZLE_NONE,
          wide ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B : CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
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

// The forward's per-channel constants of K1-bwd at channel c of image b:
// a = gamma * r is its product, so pre = fmaf(x - mu, a, beta) and the ReLU
// mask have its bits.
__device__ __forceinline__ void backward_constants(const float* __restrict__ gamma,
                                                   const float* __restrict__ beta,
                                                   const float* __restrict__ stats, int b, int G,
                                                   int gs, int c, float& mu, float& r, float& a,
                                                   float& be) {
  const float* st = stats + ((size_t)b * G + c / gs) * 2;
  mu = st[0];
  r = st[1];
  a = gamma[c] * r;
  be = beta[c];
}

// 16 bytes of a row as loaded (4 f32 or 8 bf16), unpacked where they are used,
// so a batch of loads holds 4 registers a row
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Rows r0, r0 + step, ... (U of them, those below row1) of a thread's column.
template <int U, typename T>
__device__ __forceinline__ void load_batch(uint4 (&raw)[U], const T* p, int r0, int row1,
                                           int step, int C) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (r0 + u * step < row1) raw[u] = load_raw(p + (size_t)(r0 + u * step) * C);
}

// The same rows of x and of dy, a row of each in turn.
template <int U, typename T>
__device__ __forceinline__ void load_batch2(uint4 (&rx)[U], uint4 (&rd)[U], const T* px,
                                            const T* pd, int r0, int row1, int step, int C) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (r0 + u * step < row1) {
      rx[u] = load_raw(px + (size_t)(r0 + u * step) * C);
      rd[u] = load_raw(pd + (size_t)(r0 + u * step) * C);
    }
  }
}

__device__ __forceinline__ void unpack(const float*, uint4 r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const __nv_bfloat16*, uint4 r, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// Grid design (slabs larger than a cluster holds: the stems)
// ---------------------------------------------------------------------------
//
// A unit is one (image, channel block) slab; its k CTAs ("ranks") hold
// contiguous row ranges of it, as a cluster's CTAs do. Pair p = unit * k +
// rank, and CTA c of the cooperative grid takes pairs c, c + gridDim.x, ...
// in order. With k <= gridDim.x the k ranks of a unit sit in distinct CTAs,
// and a CTA waits at pair p only on pairs of p's unit; each of those is
// either at most one step ahead of its own CTA or blocked by a pair of an
// earlier unit, so by induction over the units every wait ends (every CTA
// is resident: the launch is cooperative).

constexpr int kMaxGridBoxes = 32;  // mbarrier parities of a CTA's boxes in one word

// held: the pair's first rows, which its boxes hold in shared memory (all
// of them but where the slab outgrows the card: the rest, [held, nrows), is
// streamed from device memory in the sums and again in the apply); live:
// the boxes that hold rows.
struct GridPair {
  int unit, rank, b, c0, row0, nrows, held, live;
};

__device__ __forceinline__ GridPair grid_pair(int p, int k, int nblk, int cb, int HW,
                                              int rows_per_cta, int box_rows, int nbox) {
  GridPair q;
  q.unit = p / k;
  q.rank = p % k;
  q.b = q.unit / nblk;
  q.c0 = (q.unit % nblk) * cb;
  q.row0 = q.rank * rows_per_cta;
  q.nrows = min(rows_per_cta, HW - q.row0);
  q.held = min(q.nrows, nbox * box_rows);
  q.live = (q.held + box_rows - 1) / box_rows;
  return q;
}

constexpr int kStreamBatch = 8;  // streamed rows of x a thread loads before it uses any
constexpr int kStreamBatch2 = 4;  // of x and of dy

// The forward's streamed rows of pair q, from device memory: summed around
// `piv` into acc.
template <typename T, int V>
__device__ __forceinline__ void stream_pivot_sums(const T* x, const GridPair& q, int HW, int C,
                                                  int cv, int slot, int rslots,
                                                  const float (&piv)[V], float (&acc)[2][V]) {
  const T* base = x + ((size_t)q.b * HW + q.row0) * C + q.c0 + cv * V;
  for (int r0 = q.held + slot; r0 < q.nrows; r0 += kStreamBatch * rslots) {
    uint4 raw[kStreamBatch];
    load_batch(raw, base, r0, q.nrows, rslots, C);
#pragma unroll
    for (int u = 0; u < kStreamBatch; ++u) {
      if (r0 + u * rslots >= q.nrows) break;
      float v[V];
      unpack(x, raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - piv[j];
        acc[0][j] += d;
        acc[1][j] = fmaf(d, d, acc[1][j]);
      }
    }
  }
}

// The forward's streamed rows of pair q again (the L2 may still hold them):
// y = (x - mu) * a + be (+ReLU).
template <typename T, int V>
__device__ __forceinline__ void stream_apply(const T* x, T* y, const GridPair& q, int HW, int C,
                                             int cv, int slot, int rslots, const float (&mu)[V],
                                             const float (&a)[V], const float (&be)[V],
                                             int relu) {
  const size_t off = ((size_t)q.b * HW + q.row0) * C + q.c0 + cv * V;
  for (int r0 = q.held + slot; r0 < q.nrows; r0 += kStreamBatch * rslots) {
    uint4 raw[kStreamBatch];
    load_batch(raw, x + off, r0, q.nrows, rslots, C);
#pragma unroll
    for (int u = 0; u < kStreamBatch; ++u) {
      if (r0 + u * rslots >= q.nrows) break;
      float v[V];
      unpack(x, raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float o = fmaf(v[j] - mu[j], a[j], be[j]);
        v[j] = relu ? fmaxf(o, 0.f) : o;
      }
      store_vec(y + off + (size_t)(r0 + u * rslots) * C, v);
    }
  }
}

// The backward's streamed rows of pair q: the sums of gh and gh * xhat.
template <typename T, int V>
__device__ __forceinline__ void stream_grad_sums(const T* x, const T* dy, const GridPair& q,
                                                 int HW, int C, int cv, int slot, int rslots,
                                                 const float (&mu)[V], const float (&r)[V],
                                                 const float (&a)[V], const float (&be)[V],
                                                 int relu, float (&acc)[2][V]) {
  const size_t off = ((size_t)q.b * HW + q.row0) * C + q.c0 + cv * V;
  for (int r0 = q.held + slot; r0 < q.nrows; r0 += kStreamBatch2 * rslots) {
    uint4 rx[kStreamBatch2], rd[kStreamBatch2];
    load_batch2(rx, rd, x + off, dy + off, r0, q.nrows, rslots, C);
#pragma unroll
    for (int u = 0; u < kStreamBatch2; ++u) {
      if (r0 + u * rslots >= q.nrows) break;
      float v[V], g[V];
      unpack(x, rx[u], v);
      unpack(x, rd[u], g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - mu[j];
        const float gh = (relu && !(fmaf(d, a[j], be[j]) > 0.f)) ? 0.f : g[j];
        acc[0][j] += gh;
        acc[1][j] = fmaf(gh, d * r[j], acc[1][j]);
      }
    }
  }
}

// The backward's streamed rows of pair q again: dx.
template <typename T, int V>
__device__ __forceinline__ void stream_grad_apply(const T* x, const T* dy, T* dx,
                                                  const GridPair& q, int HW, int C, int cv,
                                                  int slot, int rslots, const float (&mu)[V],
                                                  const float (&a)[V], const float (&be)[V],
                                                  const float (&rc1)[V], const float (&r2c2)[V],
                                                  int relu) {
  const size_t off = ((size_t)q.b * HW + q.row0) * C + q.c0 + cv * V;
  for (int r0 = q.held + slot; r0 < q.nrows; r0 += kStreamBatch2 * rslots) {
    uint4 rx[kStreamBatch2], rd[kStreamBatch2];
    load_batch2(rx, rd, x + off, dy + off, r0, q.nrows, rslots, C);
#pragma unroll
    for (int u = 0; u < kStreamBatch2; ++u) {
      if (r0 + u * rslots >= q.nrows) break;
      float v[V], g[V];
      unpack(x, rx[u], v);
      unpack(x, rd[u], g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - mu[j];
        const float gh = (relu && !(fmaf(d, a[j], be[j]) > 0.f)) ? 0.f : g[j];
        v[j] = fmaf(a[j], gh, -fmaf(d, r2c2[j], rc1[j]));
      }
      store_vec(dx + off + (size_t)(r0 + u * rslots) * C, v);
    }
  }
}

// Thread 0: the TMA loads of boxes [from, to) of pair q, x's into xs and,
// where dmap is given, dy's into ds, one mbarrier per box (pair).
template <typename T>
__device__ __forceinline__ void grid_issue(T* xs, const CUtensorMap* xmap, T* ds,
                                           const CUtensorMap* dmap, uint64_t* mbar,
                                           const GridPair& q, int from, int to, int box_rows,
                                           int box_elems) {
  const uint32_t bytes = static_cast<uint32_t>(box_elems * sizeof(T)) * (dmap ? 2u : 1u);
  for (int j = from; j < to; ++j) {
    // rows past HW are zero-filled and still counted in the box's bytes
    mbar_expect_tx(&mbar[j], bytes);
    const int row = q.row0 + j * box_rows;
    tma_load_3d(xs + (size_t)j * box_elems, xmap, q.c0, row, q.b, &mbar[j]);
    if (dmap != nullptr) tma_load_3d(ds + (size_t)j * box_elems, dmap, q.c0, row, q.b, &mbar[j]);
  }
}

// Before the CTA's first pair: its mbarriers, its first pair's loads, and
// every unit's arrival counter set to 0 (by CTA 0), visible to the whole
// grid after one grid barrier: no host round trip, no memset.
template <typename T>
__device__ __forceinline__ void grid_start(T* xs, const CUtensorMap* xmap, T* ds,
                                           const CUtensorMap* dmap, uint64_t* mbar,
                                           const GridPair& first, int nbox, int box_rows,
                                           int box_elems, unsigned* arrive, int units) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < nbox; ++j) mbar_init(&mbar[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    grid_issue(xs, xmap, ds, dmap, mbar, first, 0, first.live, box_rows, box_elems);
  }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < units; i += blockDim.x) arrive[i] = 0u;
  cg::this_grid().sync();
}

// Thread 0, once every thread is done reading box j of the current pair:
// the next pair's load into it (generic reads, then an async-proxy write).
template <typename T>
__device__ __forceinline__ void grid_refill(T* xs, const CUtensorMap* xmap, T* ds,
                                            const CUtensorMap* dmap, uint64_t* mbar,
                                            const GridPair& nxt, int from, int to, int box_rows,
                                            int box_elems) {
  if (threadIdx.x == 0 && from < to) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    grid_issue(xs, xmap, ds, dmap, mbar, nxt, from, to, box_rows, box_elems);
  }
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every thread, after storing its part of this CTA's partials: marks the
// CTA's arrival on its unit's counter (integer atomics only) and returns
// once all k CTAs of the unit have arrived, their partials visible.
__device__ __forceinline__ void grid_unit_barrier(unsigned* counter, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (ld_acquire_gpu(counter) < static_cast<unsigned>(k)) {
    }
    __threadfence();
  }
  __syncthreads();
}

constexpr int kMergeBatch = 8;  // rank partials a thread loads before it adds any

// The unit's per-channel sums out[i] = sum over ranks r of part[r * n + i],
// i < n (n = 2 * cb, a multiple of 4): thread t takes 16-byte column t % nq
// (nq = n / 4) of the ranks t / nq, t / nq + S, ... (S = blockDim.x / nq
// slices), kMergeBatch loads in flight at once; `stage` (S * n <= 4 *
// blockDim.x floats) takes the slices' sums, which thread i adds in slice
// order. A fixed order: every CTA of the unit gets the same bits. Ends with
// __syncthreads.
__device__ __forceinline__ void unit_sums(const float* part, int k, int n, float* stage,
                                          float* out) {
  const int nq = n / 4, S = blockDim.x / nq;
  const int q = threadIdx.x % nq, sl = threadIdx.x / nq;
  if (sl < S) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = sl; r0 < k; r0 += kMergeBatch * S) {
      float4 v[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j)
        if (r0 + j * S < k)
          v[j] = __ldcg(reinterpret_cast<const float4*>(part + (size_t)(r0 + j * S) * n) + q);
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        if (r0 + j * S < k) {
          acc.x += v[j].x;
          acc.y += v[j].y;
          acc.z += v[j].z;
          acc.w += v[j].w;
        }
      }
    }
    reinterpret_cast<float4*>(stage + sl * n)[q] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float t = 0.f;
    for (int j = 0; j < S; ++j) t += stage[j * n + i];
    out[i] = t;
  }
  __syncthreads();
}

// Boxes a CTA's apply stays ahead of the next pair's sums: box j of the next
// pair is summed once box j + kSumLag of this one is stored (its load had
// that long to land).
constexpr int kSumLag = 3;

// Rows of box bx of pair q, summed around `piv` into acc (x - pivot, and its
// square), each thread its column over the box's row slots.
template <typename T, int V>
__device__ __forceinline__ void pivot_sums(const T* slab, const GridPair& q, int bx, int box_rows,
                                           int box_elems, int cb, int cv, int slot, int rslots,
                                           const float (&piv)[V], float (&acc)[2][V]) {
  const int r_end = min(box_rows, q.held - bx * box_rows);
  const T* base = slab + (size_t)bx * box_elems + cv * V;
#pragma unroll 4
  for (int r = slot; r < r_end; r += rslots) {
    float v[V];
    load_vec(base + r * cb, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - piv[j];
      acc[0][j] += d;
      acc[1][j] = fmaf(d, d, acc[1][j]);
    }
  }
}

// The backward's rows of box bx of pair q: the sums of gh and gh * xhat
// into acc, with the pair's per-channel constants.
template <typename T, int V>
__device__ __forceinline__ void grad_box_sums(const T* xs, const T* ds, const GridPair& q, int bx,
                                              int box_rows, int box_elems, int cb, int cv,
                                              int slot, int rslots, const float (&mu)[V],
                                              const float (&r)[V], const float (&a)[V],
                                              const float (&be)[V], int relu,
                                              float (&acc)[2][V]) {
  const int r_end = min(box_rows, q.held - bx * box_rows);
  const size_t at = (size_t)bx * box_elems + cv * V;
#pragma unroll 4
  for (int row = slot; row < r_end; row += rslots) {
    float v[V], g[V];
    load_vec(xs + at + row * cb, v);
    load_vec(ds + at + row * cb, g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - mu[j];
      const float gh = (relu && !(fmaf(d, a[j], be[j]) > 0.f)) ? 0.f : g[j];
      acc[0][j] += gh;
      acc[1][j] = fmaf(gh, d * r[j], acc[1][j]);
    }
  }
}

// The forward's per-channel constants of K1-bwd for the V channels of a
// thread's column in pair q.
template <int V>
__device__ __forceinline__ void pair_constants(const float* __restrict__ gamma,
                                               const float* __restrict__ beta,
                                               const float* __restrict__ stats, const GridPair& q,
                                               int G, int gs, int cv, float (&mu)[V],
                                               float (&r)[V], float (&a)[V], float (&be)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    backward_constants(gamma, beta, stats, q.b, G, gs, q.c0 + cv * V + j, mu[j], r[j], a[j],
                       be[j]);
}

// part: [units, k, 2, cb] of each rank's sums of x - pivot and (x -
// pivot)^2 per channel, the pivot the unit's first row (read by every rank
// alike); arrive: one counter a unit. Each pair: those sums as each box
// lands (one pass, no division; for every pair but a CTA's first, most of
// its boxes are summed during the previous pair's apply), the unit's sums
// added over the ranks (unit_sums), then per channel the mean and the
// centred M2 and per group the channels merged around the group mean, as
// the cross-shard statistics take them; the apply from shared memory, each
// box refilled with the next pair's rows once it is stored.
// One CTA an SM (the planner's choice: two measured slower), so the
// compiler may take up to 255 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1)
    gn_grid_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
                   T* __restrict__ y, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ stats, float* part,
                   unsigned* arrive, int HW, int C, int gs, int cb, int k, int units,
                   int rows_per_cta, int box_rows, int nbox, float eps, int relu) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x;
  const int vpr = cb / V;                 // 16-byte vectors per row
  const int rslots = blockDim.x / vpr;    // rows processed side by side
  const int cv = tid % vpr;               // this thread's column of vectors
  const int slot = tid / vpr;
  const int ng = cb / gs, G = C / gs, nblk = C / cb;
  const int npairs = units * k, box_elems = box_rows * cb;

  // shared memory: [slab | mbarriers | red | stage | csum | pv | mu | rstd]
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (128u - (smem_addr(smem_raw) & 127u)) & 127u;
  T* slab = reinterpret_cast<T*>(smem_raw + pad);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(slab + (size_t)nbox * box_elems);
  // 16-byte aligned after the mbarriers: unit_sums stores 16 bytes a thread
  float* red = reinterpret_cast<float*>(mbar + ((nbox + 1) & ~1));  // 2 * red_slots * cb
  float* stage = red + 2 * red_slots(vpr) * cb;  // 4 * blockDim.x: unit_sums' slices
  float* csum = stage + 4 * blockDim.x;   // 2 * cb: the unit's sums per channel
  float* pv = csum + 2 * cb;              // cb: the pivots
  float* g_mu = pv + cb;                  // ng
  float* g_rstd = g_mu + ng;              // ng

  GridPair cur = grid_pair(blockIdx.x, k, nblk, cb, HW, rows_per_cta, box_rows, nbox);
  grid_start<T>(slab, &xmap, nullptr, nullptr, mbar, cur, nbox, box_rows, box_elems, arrive,
                units);
  const float n_rows = static_cast<float>(HW);
  uint32_t phase = 0;  // bit j: the parity box j's next completion has
  // the current pair's pivot, its sums so far, and its boxes summed so far
  float piv[V], acc[2][V];
  int summed = 0;
  load_vec(x + (size_t)cur.b * HW * C + cur.c0 + cv * V, piv);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[0][j] = acc[1][j] = 0.f;
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    GridPair nxt{};
    if (p + static_cast<int>(gridDim.x) < npairs)
      nxt = grid_pair(p + gridDim.x, k, nblk, cb, HW, rows_per_cta, box_rows, nbox);

    // the streamed rows, then the boxes not yet summed, each as it lands
    stream_pivot_sums<T, V>(x, cur, HW, C, cv, slot, rslots, piv, acc);
    for (int bx = summed; bx < cur.live; ++bx) {
      mbar_wait(&mbar[bx], (phase >> bx) & 1u);
      phase ^= 1u << bx;
      pivot_sums<T, V>(slab, cur, bx, box_rows, box_elems, cb, cv, slot, rslots, piv, acc);
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (slot == 0) pv[cv * V + j] = piv[j];
    block_channel_sums<V, 2>(acc, red, part + (size_t)p * 2 * cb, vpr, cb);
    grid_unit_barrier(&arrive[cur.unit], k);
    unit_sums(part + (size_t)cur.unit * k * 2 * cb, k, 2 * cb, stage, csum);

    // per channel the mean and the centred M2 (into csum), then per group
    // the channels merged around the group mean; var clamped at 0
    for (int c = tid; c < cb; c += blockDim.x) {
      const float s1 = csum[c], q = s1 / n_rows;
      csum[c] = pv[c] + q;
      csum[cb + c] = fmaxf(csum[cb + c] - s1 * q, 0.f);
    }
    __syncthreads();
    if (tid < ng) {
      float m = 0.f;
      for (int c = tid * gs; c < (tid + 1) * gs; ++c) m += csum[c];
      m /= static_cast<float>(gs);
      float q = 0.f;
      for (int c = tid * gs; c < (tid + 1) * gs; ++c) {
        const float d = csum[c] - m;
        q += fmaf(n_rows * d, d, csum[cb + c]);
      }
      const float rstd = rsqrtf(fmaxf(q / (n_rows * static_cast<float>(gs)), 0.f) + eps);
      g_mu[tid] = m;
      g_rstd[tid] = rstd;
      if (stats != nullptr && cur.rank == 0) {  // every rank holds the same bits
        const size_t at = ((size_t)cur.b * G + cur.c0 / gs + tid) * 2;
        stats[at] = m;
        stats[at + 1] = rstd;
      }
    }
    __syncthreads();

    // apply box by box, 16 bytes a thread straight from registers; each
    // box, once stored, takes the next pair's rows
    float mu[V], a[V], be[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = cv * V + j;
      mu[j] = g_mu[c / gs];
      a[j] = gamma[cur.c0 + c] * g_rstd[c / gs];
      be[j] = beta[cur.c0 + c];
    }
    stream_apply<T, V>(x, y, cur, HW, C, cv, slot, rslots, mu, a, be, relu);
    T* yb = y + ((size_t)cur.b * HW + cur.row0) * C + cur.c0 + cv * V;
    summed = 0;
    if (nxt.live > 0) load_vec(x + (size_t)nxt.b * HW * C + nxt.c0 + cv * V, piv);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[0][j] = acc[1][j] = 0.f;
    for (int bx = 0; bx < cur.live; ++bx) {
      const int r_end = min(box_rows, cur.held - bx * box_rows);
      const T* src = slab + (size_t)bx * box_elems + cv * V;
      T* dst = yb + (size_t)bx * box_rows * C;
#pragma unroll 4
      for (int r = slot; r < r_end; r += rslots) {
        float v[V];
        load_vec(src + r * cb, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float o = fmaf(v[j] - mu[j], a[j], be[j]);
          v[j] = relu ? fmaxf(o, 0.f) : o;
        }
        store_vec(dst + (size_t)r * C, v);
      }
      if (bx < nxt.live) {
        __syncthreads();
        grid_refill<T>(slab, &xmap, nullptr, nullptr, mbar, nxt, bx, bx + 1, box_rows, box_elems);
      }
      // the next pair's box kSumLag behind, refilled that many boxes ago
      if (bx >= kSumLag && summed < nxt.live) {
        mbar_wait(&mbar[summed], (phase >> summed) & 1u);
        phase ^= 1u << summed;
        pivot_sums<T, V>(slab, nxt, summed, box_rows, box_elems, cb, cv, slot, rslots, piv, acc);
        ++summed;
      }
    }
    grid_refill<T>(slab, &xmap, nullptr, nullptr, mbar, nxt, cur.live, nxt.live, box_rows,
                   box_elems);
    cur = nxt;
  }
}

// part: [units, k, 2, cb] of each rank's sums of gh and gh * xhat per
// channel; arrive: one counter a unit; sums: [B, 2, C] of each image's
// sums, written by each unit's rank 0 (gnb_batch_sums_kernel adds them).
// Each pair: the sums over this CTA's rows as its boxes land (most of them,
// as the forward's, during the previous pair's apply), the unit's k
// partials added over the ranks (unit_sums), the group coefficients, and dx
// from shared memory, each box refilled with the next pair's rows once it
// is stored.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1)
    gnb_grid_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap dymap, const T* __restrict__ x,
                    const T* __restrict__ dy, T* __restrict__ dx,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ stats, float* part, unsigned* arrive,
                    float* __restrict__ sums, int HW, int C, int gs, int cb, int k, int units,
                    int rows_per_cta, int box_rows, int nbox, int relu) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x;
  const int vpr = cb / V, rslots = blockDim.x / vpr, cv = tid % vpr, slot = tid / vpr;
  const int ng = cb / gs, G = C / gs, nblk = C / cb;
  const int npairs = units * k, box_elems = box_rows * cb;

  // shared memory: [x slab | dy slab | mbarriers | red | stage | csum | coef]
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (128u - (smem_addr(smem_raw) & 127u)) & 127u;
  const size_t slab_bytes = (size_t)nbox * box_elems * sizeof(T);
  T* xs = reinterpret_cast<T*>(smem_raw + pad);
  T* ds = reinterpret_cast<T*>(smem_raw + pad + round_up(slab_bytes, 128));
  uint64_t* mbar =
      reinterpret_cast<uint64_t*>(smem_raw + pad + round_up(slab_bytes, 128) +
                                  round_up(slab_bytes, 16));
  // 16-byte aligned after the mbarriers: unit_sums stores 16 bytes a thread
  float* red = reinterpret_cast<float*>(mbar + ((nbox + 1) & ~1));  // 2 * red_slots * cb
  float* stage = red + 2 * red_slots(vpr) * cb;  // 4 * blockDim.x: unit_sums' slices
  float* csum = stage + 4 * blockDim.x;   // 2 * cb: the unit's sums per channel
  float* coef = csum + 2 * cb;            // 2 * ng: r * c1 and r^2 * c2 per group

  GridPair cur = grid_pair(blockIdx.x, k, nblk, cb, HW, rows_per_cta, box_rows, nbox);
  grid_start<T>(xs, &xmap, ds, &dymap, mbar, cur, nbox, box_rows, box_elems, arrive, units);
  const float n_all = static_cast<float>(HW) * static_cast<float>(gs);
  uint32_t phase = 0;
  // the forward's per-channel constants of the current pair (a = gamma * r
  // is its product, so pre = fmaf(x - mu, a, beta) and the ReLU mask have
  // its bits), its sums so far, and its boxes summed so far
  float mu[V], r[V], a[V], be[V], acc[2][V];
  int summed = 0;
  pair_constants<V>(gamma, beta, stats, cur, G, gs, cv, mu, r, a, be);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[0][j] = acc[1][j] = 0.f;
  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    GridPair nxt{};
    if (p + static_cast<int>(gridDim.x) < npairs)
      nxt = grid_pair(p + gridDim.x, k, nblk, cb, HW, rows_per_cta, box_rows, nbox);

    // sums over this CTA's rows: the streamed ones, then the boxes not yet
    // summed, each as it lands
    stream_grad_sums<T, V>(x, dy, cur, HW, C, cv, slot, rslots, mu, r, a, be, relu, acc);
    for (int bx = summed; bx < cur.live; ++bx) {
      mbar_wait(&mbar[bx], (phase >> bx) & 1u);
      phase ^= 1u << bx;
      grad_box_sums<T, V>(xs, ds, cur, bx, box_rows, box_elems, cb, cv, slot, rslots, mu, r, a,
                          be, relu, acc);
    }
    block_channel_sums<V, 2>(acc, red, part + (size_t)p * 2 * cb, vpr, cb);
    grid_unit_barrier(&arrive[cur.unit], k);

    // the unit's sums per channel (the same bits in every CTA of the unit);
    // rank 0 hands them to the batch sums
    unit_sums(part + (size_t)cur.unit * k * 2 * cb, k, 2 * cb, stage, csum);
    if (cur.rank == 0)
      for (int i = tid; i < 2 * cb; i += blockDim.x)
        sums[(size_t)cur.b * 2 * C + (i / cb) * C + cur.c0 + i % cb] = csum[i];
    // the group means c1 = mean(gamma * gh), c2 = mean(gamma * gh * xhat)
    if (tid < ng) {
      float t1 = 0.f, t2 = 0.f;
      for (int c = tid * gs; c < (tid + 1) * gs; ++c) {
        t1 = fmaf(gamma[cur.c0 + c], csum[c], t1);
        t2 = fmaf(gamma[cur.c0 + c], csum[cb + c], t2);
      }
      const float rg = stats[((size_t)cur.b * G + cur.c0 / gs + tid) * 2 + 1];
      coef[tid] = rg * (t1 / n_all);
      coef[ng + tid] = rg * rg * (t2 / n_all);
    }
    __syncthreads();

    // dx = (gamma * r) * gh - r * c1 - (x - mu) * r^2 * c2 box by box from
    // shared memory; each box, once stored, takes the next pair's rows
    float rc1[V], r2c2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = (cv * V + j) / gs;
      rc1[j] = coef[g];
      r2c2[j] = coef[ng + g];
    }
    stream_grad_apply<T, V>(x, dy, dx, cur, HW, C, cv, slot, rslots, mu, a, be, rc1, r2c2, relu);
    T* out = dx + ((size_t)cur.b * HW + cur.row0) * C + cur.c0 + cv * V;
    float nmu[V], nr[V], na[V], nbe[V];
    if (nxt.live > 0) pair_constants<V>(gamma, beta, stats, nxt, G, gs, cv, nmu, nr, na, nbe);
    summed = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[0][j] = acc[1][j] = 0.f;
    for (int bx = 0; bx < cur.live; ++bx) {
      const int r_end = min(box_rows, cur.held - bx * box_rows);
      const size_t at = (size_t)bx * box_elems + cv * V;
      T* dst = out + (size_t)bx * box_rows * C;
#pragma unroll 4
      for (int row = slot; row < r_end; row += rslots) {
        float v[V], g[V];
        load_vec(xs + at + row * cb, v);
        load_vec(ds + at + row * cb, g);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[j] - mu[j];
          const float gh = (relu && !(fmaf(d, a[j], be[j]) > 0.f)) ? 0.f : g[j];
          v[j] = fmaf(a[j], gh, -fmaf(d, r2c2[j], rc1[j]));
        }
        store_vec(dst + (size_t)row * C, v);
      }
      if (bx < nxt.live) {
        __syncthreads();
        grid_refill<T>(xs, &xmap, ds, &dymap, mbar, nxt, bx, bx + 1, box_rows, box_elems);
      }
      // the next pair's box kSumLag behind, refilled that many boxes ago
      if (bx >= kSumLag && summed < nxt.live) {
        mbar_wait(&mbar[summed], (phase >> summed) & 1u);
        phase ^= 1u << summed;
        grad_box_sums<T, V>(xs, ds, nxt, summed, box_rows, box_elems, cb, cv, slot, rslots, nmu,
                            nr, na, nbe, relu, acc);
        ++summed;
      }
    }
    grid_refill<T>(xs, &xmap, ds, &dymap, mbar, nxt, cur.live, nxt.live, box_rows, box_elems);
    cur = nxt;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = nmu[j];
      r[j] = nr[j];
      a[j] = na[j];
      be[j] = nbe[j];
    }
  }
}

// The grid kernels' layouts in bytes (ops/groupnorm.py::_grid_smem computes
// them too): the cluster designs' slabs, mbarriers (an even count, so what
// follows is 16-byte aligned) and reduction scratch, then unit_sums' stage, the unit's sums per channel, and the pivots,
// means and rstd (forward) or the coefficients (backward).
size_t grid_smem_bytes(int itemsize, int V, int cb, int gs, int box_rows, int nbox, int threads,
                       bool backward) {
  const int ng = cb / gs, vpr = cb / V;
  const int slots = (32 % vpr) == 0 ? threads / 32 : threads / vpr;
  const size_t slab = (size_t)nbox * box_rows * cb * itemsize;
  const size_t slabs = backward ? round_up(slab, 128) + round_up(slab, 16) : round_up(slab, 16);
  const size_t tail = (backward ? 2 : 3) * (size_t)cb + 2 * (size_t)ng;
  return 128 + slabs + 8 * (size_t)((nbox + 1) & ~1) +
         4 * (2 * (size_t)slots * cb + 4 * (size_t)threads + tail);
}

// A cooperative launch: `grid` CTAs along x, every one resident at once.
struct GridLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  GridLaunch(int grid, int threads, int smem, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = dim3(grid, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  GridLaunch(const GridLaunch&) = delete;
};

// Before a launch of `kernel` with `threads` and `smem` on this device: its
// shared-memory limit raised to 227 KB (once), and the CTAs the card holds
// at once (its occupancy times the SMs) at least `grid`. Cached per
// configuration, under a mutex as ready_cluster's table.
int ready_grid(const void* kernel, int threads, int smem, int grid) {
  struct Resident {
    const void* kernel;
    int dev, threads, smem, ctas;
  };
  static Resident checked[kMaxChecked];
  static int n_checked = 0;
  static std::mutex table_mutex;
  const std::lock_guard<std::mutex> lock(table_mutex);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_checked; ++i)
    if (checked[i].kernel == kernel && checked[i].dev == dev && checked[i].threads == threads &&
        checked[i].smem == smem)
      return grid <= checked[i].ctas ? 0 : kErrNoResidency;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (n_checked < kMaxChecked) checked[n_checked++] = Resident{kernel, dev, threads, smem, per_sm * sms};
  return grid <= per_sm * sms ? 0 : kErrNoResidency;
}

// The plan's geometry as the grid kernels need it: whole groups in a channel
// block that TMA boxes (16-byte multiples, at most 256 elements), whole rows
// of threads (whole warps where a row's vectors divide a warp), k ranks that
// cover H*W with rows in each, at most kMaxGridBoxes boxes (holding at most
// a rank's rows; the rest are streamed), a grid of at
// least k CTAs (so a unit's ranks sit in distinct CTAs) and at most the
// pairs, and the layout within the planned shared memory.
bool grid_plan_ok(int itemsize, int V, int C, int gs, int HW, int cb, int k, int rows_per_cta,
                  int box_rows, int nbox, int threads, int grid, int units, size_t need,
                  int smem) {
  if (cb <= 0 || C % cb != 0 || cb % gs != 0 || cb % V != 0 || cb > 256 ||
      (cb * itemsize) % 16 != 0 || (C * itemsize) % 16 != 0)
    return false;
  const int vpr = cb / V;
  if (threads > kClusterThreads || threads < vpr || threads % vpr != 0 ||
      (32 % vpr == 0 && threads % 32 != 0))
    return false;
  if (k < 1 || rows_per_cta < 1 || (size_t)k * rows_per_cta < (size_t)HW ||
      (size_t)(k - 1) * rows_per_cta >= (size_t)HW)
    return false;
  if (nbox < 1 || nbox > kMaxGridBoxes || box_rows > 256 || nbox * box_rows > rows_per_cta)
    return false;
  if (grid < k || (size_t)grid > (size_t)units * k) return false;
  if ((2 * cb) % 4 != 0 || 2 * cb / 4 > threads) return false;  // unit_sums' 16-byte columns
  return need <= (size_t)smem && smem <= kMaxDynSmem;
}

template <typename T>
int launch_grid(const void* x, void* y, const float* gamma, const float* beta, float* stats,
                float* scratch, int B, int HW, int C, int G, int cb, int k, int rows_per_cta,
                int box_rows, int nbox, int threads, int smem, int grid, float eps, int relu,
                cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int gs = C / G, units = B * (C / cb);
  if (!grid_plan_ok(sizeof(T), V, C, gs, HW, cb, k, rows_per_cta, box_rows, nbox, threads, grid,
                    units, grid_smem_bytes(sizeof(T), V, cb, gs, box_rows, nbox, threads, false),
                    smem))
    return kErrSmemPlan;
  int e = ready_grid(reinterpret_cast<const void*>(gn_grid_kernel<T>), threads, smem, grid);
  if (e != 0) return e;
  CUtensorMap xmap;
  e = encode_map(&xmap, x, sizeof(T) == 2, B, HW, C, cb, box_rows, false);
  if (e != 0) return e;
  float* part = scratch;  // [units, k, 2, cb], then one counter a unit
  unsigned* arrive = reinterpret_cast<unsigned*>(part + (size_t)units * k * 2 * cb);
  const GridLaunch launch(grid, threads, smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, gn_grid_kernel<T>, xmap,
                                             static_cast<const T*>(x), static_cast<T*>(y), gamma,
                                             beta, stats, part, arrive, HW, C, gs, cb, k, units,
                                             rows_per_cta, box_rows, nbox, eps, relu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_grid_backward(const void* x, const void* dy, const float* gamma, const float* beta,
                         const float* stats, void* dx, float* dgamma, float* dbeta,
                         float* scratch, int B, int HW, int C, int G, int cb, int k,
                         int rows_per_cta, int box_rows, int nbox, int threads, int smem,
                         int grid, int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int gs = C / G, units = B * (C / cb);
  if (!grid_plan_ok(sizeof(T), V, C, gs, HW, cb, k, rows_per_cta, box_rows, nbox, threads, grid,
                    units, grid_smem_bytes(sizeof(T), V, cb, gs, box_rows, nbox, threads, true),
                    smem))
    return kErrSmemPlan;
  int e = ready_grid(reinterpret_cast<const void*>(gnb_grid_kernel<T>), threads, smem, grid);
  if (e != 0) return e;
  CUtensorMap xmap, dymap;
  e = encode_map(&xmap, x, sizeof(T) == 2, B, HW, C, cb, box_rows, false);
  if (e != 0) return e;
  e = encode_map(&dymap, dy, sizeof(T) == 2, B, HW, C, cb, box_rows, false);
  if (e != 0) return e;
  float* sums = scratch;                  // [B, 2, C]
  float* part = sums + (size_t)B * 2 * C;  // [units, k, 2, cb], then one counter a unit
  unsigned* arrive = reinterpret_cast<unsigned*>(part + (size_t)units * k * 2 * cb);
  const GridLaunch launch(grid, threads, smem, stream);
  cudaError_t err = cudaLaunchKernelEx(&launch.cfg, gnb_grid_kernel<T>, xmap, dymap,
                                       static_cast<const T*>(x), static_cast<const T*>(dy),
                                       static_cast<T*>(dx), gamma, beta, stats, part, arrive,
                                       sums, HW, C, gs, cb, k, units, rows_per_cta, box_rows,
                                       nbox, relu);
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
// Replaces, for an image whose rows are split over the ranks of a spatial
// group, crossloc_tpu/ops/pallas_groupnorm.py::_kernel (:57; on a height
// shard the JAX package's jnp GroupNorm gets XLA's cross-shard reductions)
// and the backward that pallas_groupnorm.py:141 takes with jax.vjp. A
// norm's per-(image, group) statistics, and its backward's per-(image,
// channel) sums, span ranks, so each direction splits at the exchange into
// two entries, each ONE kernel on the caller's stream; parallel/spatial.py
// all-gathers over the spatial group between them:
//   K1-shard-stats      gn_shard_stats_cluster_kernel: (count, mean, M2)
//                       per (image, group) of the shard's rows, B * G * 3
//                       floats.
//   K1-shard-apply      gn_shard_apply_kernel: the ranks' statistics merged
//                       (Chan) in rank order, var clamped at 0, (mu, rstd)
//                       to `stats` for the backward, and y.
//   K1-bwd-shard-sums   gnb_shard_sums_cluster_kernel: per (image, channel)
//                       the sums of gh and gh * xhat over the shard's rows,
//                       [B, 2, C].
//   K1-bwd-shard-apply  gnb_shard_apply_kernel: the ranks' sums added in
//                       rank order, the group coefficients with the whole
//                       image's H*W as the count, this shard's dscale and
//                       dbias (the training step's all-reduce adds the
//                       shards), and dx.
// ops/groupnorm.py::_shard_plan cuts a shard into channel blocks of whole
// groups and contiguous row ranges; a thread holds V channels (16 bytes) of
// its column of the block and strides over the range's rows with 16-byte
// loads, in batches whose loads are in flight together.
// The two reductions run one thread block cluster per (image, channel
// block), its CTAs over the image's row ranges in rank order; the block is
// as wide as clusters of up to 16 allow while the grid still fills the
// card. Each CTA sums per channel in registers, then over its threads in a
// fixed order, pushes its sums into rank 0's shared memory (distributed
// shared memory stores), and after one cluster barrier rank 0 adds the
// ranks in rank order and writes the result: nothing else reaches device
// memory, and without float atomics two runs give the same bits. The
// statistics are sums around a per-channel pivot, the shard's first row,
// read alike by every CTA: no division in the loop, and the CTAs' sums add
// as plain sums. Rank 0 forms per channel mean = pivot + s1 / n and the
// centred M2 = s2 - s1 * s1 / n, then per group M2 = sum_c M2_c + n (mean_c -
// mean_g)^2: a centred variance (never E[x^2] - mu^2), which the ranks' Chan
// merge needs.
// The applies are plain launches over (row range, channel block, image),
// the block whole rows where a CTA's threads span them, so each CTA streams
// contiguous memory. A CTA loads its first batch of rows, then forms its
// groups' constants from the gathered tensor (S * 3 floats a group forward,
// S * 2 a channel backward) while those loads are in flight, and writes
// from registers: no table in device memory. The CTAs of row range 0 also
// write `stats` (forward), and for image 0 dscale and dbias (backward).
// Bound: bytes. The split reads x (and dy) before the exchange and again
// after it: one read more than the unsharded bound. Between a rank's two
// entries the step runs only an all-gather of a few kilobytes, so where one
// shard's tensors fit the 50 MB L2 the apply's read of x can hit it. No
// cache policy is set: measured as one graph, the pair after an evicting
// write saves about a tenth of the two entries timed cold, and the applies
// run near a plain copy of their bytes (PERF.md). stem1 and stem2 (88.5 and
// 44 MB a rank at B=4 in f32) cannot stay in the L2: their bound is the split's own
// traffic, x read twice forward, x and dy twice backward.

constexpr int kShardMaxThreads = 512;       // a reduction CTA's most threads
constexpr int kShardApplyMaxThreads = 256;  // an apply CTA's
// rows a thread loads before it uses any of them, in the loops whose loads
// the compiler would not keep in flight together (measured: PERF.md); an
// apply's first batch is loaded before its prologue
constexpr int kSumsBatch = 4;      // of x and of dy
constexpr int kApplyBatch = 8;
constexpr int kBwdApplyBatch = 4;  // of x and of dy

// The same layout as the reductions' (ops/groupnorm.py::_shard_smem
// computes it too): the reduction scratch, this CTA's NA = 2 sums per
// channel, every rank's (pushed into rank 0), and the channels' pivots.
size_t shard_smem_bytes(int V, int cb, int threads, int cs) {
  const int vpr = cb / V;
  const int slots = (32 % vpr) == 0 ? threads / 32 : threads / vpr;
  return 4 * (2 * (size_t)slots * cb + 3 * (size_t)cb + 2 * (size_t)cs * cb);
}

// The cluster's per-channel sums, in rank 0: this CTA's NA arrays of
// per-thread partials summed over its threads into `part`, pushed into slot
// `rank` of rank 0's xch, one cluster barrier. The caller arrived on the
// cluster barrier at its start (so every CTA runs before a peer writes to
// it). True in rank 0, whose xch then holds every rank's NA * cb sums.
template <int V, int NA>
__device__ __forceinline__ bool sums_to_rank0(float (&acc)[NA][V], float* red, float* part,
                                              float* xch, int vpr, int cb) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  block_channel_sums<V, NA>(acc, red, part, vpr, cb);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* dst = cluster.map_shared_rank(xch, 0) + rank * NA * cb;
  for (int i = threadIdx.x; i < NA * cb; i += blockDim.x) dst[i] = part[i];
  cluster.sync();
  return rank == 0;
}

// One cluster of gridDim.x CTAs per (image blockIdx.z, channel block
// blockIdx.y); CTA `rank` sums rows [rank * rows_per_cta, +rows_per_cta) of
// the shard. Rank 0 writes out[b, g] = (count, mean, M2) of the block's
// groups.
template <typename T>
__global__ void __launch_bounds__(kShardMaxThreads)
    gn_shard_stats_cluster_kernel(const T* __restrict__ x, float* __restrict__ out, int HW,
                                  int C, int gs, int cb, int rows_per_cta) {
  constexpr int V = Vec<T>::N;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, cs = gridDim.x;  // the cluster spans the grid's x
  const int c0 = blockIdx.y * cb;
  const int b = blockIdx.z;
  const int row1 = min(rank * rows_per_cta + rows_per_cta, HW);
  const int vpr = cb / V, rslots = blockDim.x / vpr;
  const int cv = tid % vpr, slot = tid / vpr;

  // shared memory: [red | part | xch | pv]
  extern __shared__ float sh[];
  float* red = sh;                               // 2 * red_slots * cb
  float* part = red + 2 * red_slots(vpr) * cb;   // 2 * cb
  float* xch = part + 2 * cb;                    // cs * 2 * cb, read in rank 0
  float* pv = xch + 2 * cs * cb;                 // cb: the pivots, read in rank 0

  const T* xb = x + (size_t)b * HW * C + c0;
  float piv[V], acc[2][V];
  load_vec(xb + cv * V, piv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (slot == 0) pv[cv * V + k] = piv[k];
    acc[0][k] = acc[1][k] = 0.f;
  }
#pragma unroll 8
  for (int r = rank * rows_per_cta + slot; r < row1; r += rslots) {
    float v[V];
    load_vec(xb + (size_t)r * C + cv * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = v[k] - piv[k];
      acc[0][k] += d;
      acc[1][k] = fmaf(d, d, acc[1][k]);
    }
  }
  if (!sums_to_rank0<V, 2>(acc, red, part, xch, vpr, cb)) return;

  // rank 0: per channel the image's mean and centred M2 (into part), then
  // per group the channels merged around the group mean
  const float n = static_cast<float>(HW);
  for (int c = tid; c < cb; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < cs; ++r) {
      s1 += xch[r * 2 * cb + c];
      s2 += xch[r * 2 * cb + cb + c];
    }
    const float q = s1 / n;
    part[c] = pv[c] + q;
    part[cb + c] = fmaxf(s2 - s1 * q, 0.f);
  }
  __syncthreads();
  for (int g = tid; g < cb / gs; g += blockDim.x) {
    float m = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) m += part[c];
    m /= static_cast<float>(gs);
    float q = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) {
      const float d = part[c] - m;
      q += fmaf(n * d, d, part[cb + c]);
    }
    float* o = out + ((size_t)b * (C / gs) + c0 / gs + g) * 3;
    o[0] = n * static_cast<float>(gs);
    o[1] = m;
    o[2] = q;
  }
}

// One CTA per (row range, channel block) = blockIdx.x and image blockIdx.y:
// the ranks' (count, mean, M2) of the block's groups merged in rank order,
// then y over the range's rows.
template <typename T>
__global__ void __launch_bounds__(kShardApplyMaxThreads)
    gn_shard_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ gathered, float* __restrict__ stats, int S,
                          int B, int HW, int C, int gs, int cb, int rows_per_cta, float eps,
                          int relu) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x;
  const int nblk = C / cb, chunk = blockIdx.x / nblk;
  const int c0 = (blockIdx.x % nblk) * cb;
  const int b = blockIdx.y;
  const int G = C / gs, ng = cb / gs, g0 = c0 / gs;
  const int vpr = cb / V, rslots = blockDim.x / vpr;
  const int cv = tid % vpr, slot = tid / vpr;
  const size_t base = (size_t)b * HW * C + c0 + cv * V;
  const int row1 = min(chunk * rows_per_cta + rows_per_cta, HW);
  const int step = kApplyBatch * rslots;
  int r0 = chunk * rows_per_cta + slot;
  uint4 raw[kApplyBatch];
  load_batch(raw, x + base, r0, row1, rslots, C);  // in flight through the prologue
  float mu[V], a[V], be[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = gamma[c0 + cv * V + k];
    be[k] = beta[c0 + cv * V + k];
  }
  extern __shared__ float sh[];  // mu [ng] | rstd [ng]
  for (int g = tid; g < ng; g += blockDim.x) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* p = gathered + (((size_t)s * B + b) * G + g0 + g) * 3;
      chan_merge(n, mean, m2, p[0], p[1], p[2]);
    }
    const float rstd = rsqrtf(fmaxf(m2 / n, 0.f) + eps);
    sh[g] = mean;
    sh[ng + g] = rstd;
    if (chunk == 0) {
      stats[((size_t)b * G + g0 + g) * 2] = mean;
      stats[((size_t)b * G + g0 + g) * 2 + 1] = rstd;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int g = (cv * V + k) / gs;
    mu[k] = sh[g];
    a[k] *= sh[ng + g];  // gamma * rstd, the forward's product
  }
  for (; r0 < row1; r0 += step) {
#pragma unroll
    for (int u = 0; u < kApplyBatch; ++u) {
      if (r0 + u * rslots >= row1) break;
      float v[V];
      unpack(x, raw[u], v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float o = fmaf(v[k] - mu[k], a[k], be[k]);
        v[k] = relu ? fmaxf(o, 0.f) : o;
      }
      store_vec(y + base + (size_t)(r0 + u * rslots) * C, v);
    }
    load_batch(raw, x + base, r0 + step, row1, rslots, C);
  }
}

// The layout of gn_shard_stats_cluster_kernel; rank 0 writes sums[b, 0, c] =
// sum gh and sums[b, 1, c] = sum gh * xhat over the shard's rows.
template <typename T>
__global__ void __launch_bounds__(kShardMaxThreads)
    gnb_shard_sums_cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                  const float* __restrict__ gamma, const float* __restrict__ beta,
                                  const float* __restrict__ stats, float* __restrict__ sums,
                                  int HW, int C, int gs, int cb, int rows_per_cta, int relu) {
  constexpr int V = Vec<T>::N;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, cs = gridDim.x;
  const int c0 = blockIdx.y * cb;
  const int b = blockIdx.z;
  const int row1 = min(rank * rows_per_cta + rows_per_cta, HW);
  const int vpr = cb / V, rslots = blockDim.x / vpr;
  const int cv = tid % vpr, slot = tid / vpr;

  extern __shared__ float sh[];
  float* red = sh;
  float* part = red + 2 * red_slots(vpr) * cb;
  float* xch = part + 2 * cb;

  float mu[V], r[V], a[V], be[V], acc[2][V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    backward_constants(gamma, beta, stats, b, C / gs, gs, c0 + cv * V + k, mu[k], r[k], a[k],
                       be[k]);
    acc[0][k] = acc[1][k] = 0.f;
  }
  const size_t base = (size_t)b * HW * C + c0 + cv * V;
  for (int r0 = rank * rows_per_cta + slot; r0 < row1; r0 += kSumsBatch * rslots) {
    uint4 rx[kSumsBatch], rd[kSumsBatch];
    load_batch2(rx, rd, x + base, dy + base, r0, row1, rslots, C);
#pragma unroll
    for (int u = 0; u < kSumsBatch; ++u) {
      if (r0 + u * rslots >= row1) break;
      float v[V], g[V];
      unpack(x, rx[u], v);
      unpack(x, rd[u], g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = v[k] - mu[k];
        const float gh = (relu && !(fmaf(d, a[k], be[k]) > 0.f)) ? 0.f : g[k];
        acc[0][k] += gh;
        acc[1][k] = fmaf(gh, d * r[k], acc[1][k]);
      }
    }
  }
  if (!sums_to_rank0<V, 2>(acc, red, part, xch, vpr, cb)) return;
  for (int i = tid; i < 2 * cb; i += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < cs; ++k) s += xch[k * 2 * cb + i];
    sums[(size_t)b * 2 * C + (i / cb) * C + c0 + i % cb] = s;
  }
}

// The layout of gn_shard_apply_kernel: the ranks' sums of the block's
// channels added in rank order, the group coefficients r * c1 and r^2 * c2
// (count: count_hw * gs), dx over the range's rows. The CTAs of row range 0
// of image 0 write dscale and dbias of their channels: rank `index`'s sums
// over the images, in order.
template <typename T>
__global__ void __launch_bounds__(kShardApplyMaxThreads)
    gnb_shard_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           const float* __restrict__ stats, const float* __restrict__ gathered,
                           float* __restrict__ dgamma, float* __restrict__ dbeta, int index,
                           int S, int B, int HW, int count_hw, int C, int gs, int cb,
                           int rows_per_cta, int relu) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x;
  const int nblk = C / cb, chunk = blockIdx.x / nblk;
  const int c0 = (blockIdx.x % nblk) * cb;
  const int b = blockIdx.y;
  const int G = C / gs, ng = cb / gs, g0 = c0 / gs;
  const size_t per_rank = (size_t)B * 2 * C;  // gathered is [S, B, 2, C]
  const int vpr = cb / V, rslots = blockDim.x / vpr;
  const int cv = tid % vpr, slot = tid / vpr;
  const size_t base = (size_t)b * HW * C + c0 + cv * V;
  const int row1 = min(chunk * rows_per_cta + rows_per_cta, HW);
  const int step = kBwdApplyBatch * rslots;
  int r0 = chunk * rows_per_cta + slot;
  uint4 rx[kBwdApplyBatch], rd[kBwdApplyBatch];
  load_batch2(rx, rd, x + base, dy + base, r0, row1, rslots, C);  // through the prologue
  float mu[V], r[V], a[V], be[V], rc1[V], r2c2[V];
#pragma unroll
  for (int k = 0; k < V; ++k)
    backward_constants(gamma, beta, stats, b, G, gs, c0 + cv * V + k, mu[k], r[k], a[k], be[k]);
  extern __shared__ float sh[];
  float* csum = sh;            // 2 * cb: the image's sums of the block's channels
  float* coef = sh + 2 * cb;   // 2 * ng: r * c1 and r^2 * c2 per group
  for (int i = tid; i < 2 * cb; i += blockDim.x) {
    const float* p = gathered + ((size_t)b * 2 + i / cb) * C + c0 + i % cb;
    float t = 0.f;
    for (int s = 0; s < S; ++s) t += p[s * per_rank];
    csum[i] = t;
  }
  if (b == 0 && chunk == 0) {
    const float* own = gathered + index * per_rank + c0;
    for (int c = tid; c < cb; c += blockDim.x) {
      float db = 0.f, dg = 0.f;
      for (int i = 0; i < B; ++i) {
        db += own[(size_t)i * 2 * C + c];
        dg += own[(size_t)i * 2 * C + C + c];
      }
      dbeta[c0 + c] = db;
      dgamma[c0 + c] = dg;
    }
  }
  __syncthreads();
  for (int g = tid; g < ng; g += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) {
      t1 = fmaf(gamma[c0 + c], csum[c], t1);
      t2 = fmaf(gamma[c0 + c], csum[cb + c], t2);
    }
    const float n = static_cast<float>(count_hw) * static_cast<float>(gs);
    const float rg = stats[((size_t)b * G + g0 + g) * 2 + 1];
    coef[g] = rg * (t1 / n);
    coef[ng + g] = rg * rg * (t2 / n);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int g = (cv * V + k) / gs;
    rc1[k] = coef[g];
    r2c2[k] = coef[ng + g];
  }
  for (; r0 < row1; r0 += step) {
#pragma unroll
    for (int u = 0; u < kBwdApplyBatch; ++u) {
      if (r0 + u * rslots >= row1) break;
      float v[V], g[V];
      unpack(x, rx[u], v);
      unpack(x, rd[u], g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = v[k] - mu[k];
        const float gh = (relu && !(fmaf(d, a[k], be[k]) > 0.f)) ? 0.f : g[k];
        v[k] = fmaf(a[k], gh, -fmaf(d, r2c2[k], rc1[k]));
      }
      store_vec(dx + base + (size_t)(r0 + u * rslots) * C, v);
    }
    load_batch2(rx, rd, x + base, dy + base, r0 + step, row1, rslots, C);
  }
}

// The plan's geometry as the kernels need it: whole groups in a channel
// block of whole vectors, one thread per vector of a row and whole rows of
// threads, the reductions' cluster within the card's limit and their layout
// within the planned shared memory (cs = 0 for the applies). A reduction
// whose rows divide a warp takes whole warps: stage_slots shuffles over all
// 32 lanes and keeps one row slot a warp.
bool shard_plan_ok(int V, int C, int gs, int cb, int cs, int rows_per_cta, int threads,
                   int smem) {
  if (cb <= 0 || C % cb != 0 || cb % gs != 0 || cb % V != 0 || rows_per_cta < 1) return false;
  const int vpr = cb / V;
  if (threads > (cs == 0 ? kShardApplyMaxThreads : kShardMaxThreads) || threads < vpr ||
      threads % vpr != 0)
    return false;
  if (cs != 0 && 32 % vpr == 0 && threads % 32 != 0) return false;
  return cs == 0 || (cs <= kMaxClusterBackward && smem <= kMaxDynSmem &&
                     shard_smem_bytes(V, cb, threads, cs) <= (size_t)smem);
}

template <typename T>
int launch_shard_stats(const void* x, float* out, int B, int HW, int C, int G, int cb, int cs,
                       int rows_per_cta, int threads, int smem, cudaStream_t stream) {
  if (!shard_plan_ok(Vec<T>::N, C, C / G, cb, cs, rows_per_cta, threads, smem))
    return kErrSmemPlan;
  const ClusterLaunch launch(dim3(cs, C / cb, B), cs, threads, smem, stream);
  int e = ready_cluster(reinterpret_cast<const void*>(gn_shard_stats_cluster_kernel<T>), launch,
                        cs);
  if (e != 0) return e;
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, gn_shard_stats_cluster_kernel<T>,
                                             static_cast<const T*>(x), out, HW, C, C / G, cb,
                                             rows_per_cta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_shard_apply(const void* x, void* y, const float* gamma, const float* beta,
                       const float* gathered, float* stats, int S, int B, int HW, int C, int G,
                       int cb, int rows_per_cta, int threads, float eps, int relu,
                       cudaStream_t stream) {
  if (!shard_plan_ok(Vec<T>::N, C, C / G, cb, 0, rows_per_cta, threads, 0))
    return kErrSmemPlan;
  const int chunks = (HW + rows_per_cta - 1) / rows_per_cta;
  const size_t smem = 2 * (size_t)(cb / (C / G)) * sizeof(float);
  gn_shard_apply_kernel<T><<<dim3(chunks * (C / cb), B), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), gamma, beta, gathered, stats, S, B, HW, C,
      C / G, cb, rows_per_cta, eps, relu);
  return cudaGetLastError();
}

template <typename T>
int launch_shard_backward_sums(const void* x, const void* dy, const float* gamma,
                               const float* beta, const float* stats, float* sums, int B, int HW,
                               int C, int G, int cb, int cs, int rows_per_cta, int threads,
                               int smem, int relu, cudaStream_t stream) {
  if (!shard_plan_ok(Vec<T>::N, C, C / G, cb, cs, rows_per_cta, threads, smem))
    return kErrSmemPlan;
  const ClusterLaunch launch(dim3(cs, C / cb, B), cs, threads, smem, stream);
  int e = ready_cluster(reinterpret_cast<const void*>(gnb_shard_sums_cluster_kernel<T>), launch,
                        cs);
  if (e != 0) return e;
  const cudaError_t err = cudaLaunchKernelEx(
      &launch.cfg, gnb_shard_sums_cluster_kernel<T>, static_cast<const T*>(x),
      static_cast<const T*>(dy), gamma, beta, stats, sums, HW, C, C / G, cb, rows_per_cta, relu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_shard_backward_apply(const void* x, const void* dy, const float* gamma,
                                const float* beta, const float* stats, const float* gathered,
                                void* dx, float* dgamma, float* dbeta, int index, int S, int B,
                                int HW, int count_hw, int C, int G, int cb, int rows_per_cta,
                                int threads, int relu, cudaStream_t stream) {
  if (!shard_plan_ok(Vec<T>::N, C, C / G, cb, 0, rows_per_cta, threads, 0))
    return kErrSmemPlan;
  const int chunks = (HW + rows_per_cta - 1) / rows_per_cta;
  const size_t smem = 2 * (size_t)(cb + cb / (C / G)) * sizeof(float);
  gnb_shard_apply_kernel<T><<<dim3(chunks * (C / cb), B), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), gamma, beta,
      stats, gathered, dgamma, dbeta, index, S, B, HW, count_hw, C, C / G, cb, rows_per_cta,
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

extern "C" int crossloc_gn_grid_forward(const void* x, void* y, const float* gamma,
                                        const float* beta, float* stats, float* scratch, int B,
                                        int HW, int C, int G, int cb, int k, int rows_per_cta,
                                        int box_rows, int nbox, int threads, int smem, int grid,
                                        float eps, int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_grid<__nv_bfloat16>(x, y, gamma, beta, stats, scratch, B, HW, C, G, cb,
                                              k, rows_per_cta, box_rows, nbox, threads, smem,
                                              grid, eps, relu, s)
                 : launch_grid<float>(x, y, gamma, beta, stats, scratch, B, HW, C, G, cb, k,
                                      rows_per_cta, box_rows, nbox, threads, smem, grid, eps,
                                      relu, s);
}

extern "C" int crossloc_gn_grid_backward(const void* x, const void* dy, const float* gamma,
                                         const float* beta, const float* stats, void* dx,
                                         float* dgamma, float* dbeta, float* scratch, int B,
                                         int HW, int C, int G, int cb, int k, int rows_per_cta,
                                         int box_rows, int nbox, int threads, int smem, int grid,
                                         int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_grid_backward<__nv_bfloat16>(x, dy, gamma, beta, stats, dx, dgamma,
                                                       dbeta, scratch, B, HW, C, G, cb, k,
                                                       rows_per_cta, box_rows, nbox, threads,
                                                       smem, grid, relu, s)
                 : launch_grid_backward<float>(x, dy, gamma, beta, stats, dx, dgamma, dbeta,
                                               scratch, B, HW, C, G, cb, k, rows_per_cta,
                                               box_rows, nbox, threads, smem, grid, relu, s);
}

extern "C" int crossloc_gn_shard_stats(const void* x, float* out, int B, int HW, int C, int G,
                                       int cb, int cluster, int rows_per_cta, int threads,
                                       int smem, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_shard_stats<__nv_bfloat16>(x, out, B, HW, C, G, cb, cluster,
                                                     rows_per_cta, threads, smem, s)
                 : launch_shard_stats<float>(x, out, B, HW, C, G, cb, cluster, rows_per_cta,
                                             threads, smem, s);
}

extern "C" int crossloc_gn_shard_apply(const void* x, void* y, const float* gamma,
                                       const float* beta, const float* gathered, float* stats,
                                       int S, int B, int HW, int C, int G, int cb,
                                       int rows_per_cta, int threads, float eps, int relu,
                                       int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_shard_apply<__nv_bfloat16>(x, y, gamma, beta, gathered, stats, S, B,
                                                     HW, C, G, cb, rows_per_cta, threads, eps,
                                                     relu, s)
                 : launch_shard_apply<float>(x, y, gamma, beta, gathered, stats, S, B, HW, C, G,
                                             cb, rows_per_cta, threads, eps, relu, s);
}

extern "C" int crossloc_gn_shard_backward_sums(const void* x, const void* dy, const float* gamma,
                                               const float* beta, const float* stats,
                                               float* sums, int B, int HW, int C, int G, int cb,
                                               int cluster, int rows_per_cta, int threads,
                                               int smem, int relu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_shard_backward_sums<__nv_bfloat16>(x, dy, gamma, beta, stats, sums, B,
                                                             HW, C, G, cb, cluster, rows_per_cta,
                                                             threads, smem, relu, s)
                 : launch_shard_backward_sums<float>(x, dy, gamma, beta, stats, sums, B, HW, C,
                                                     G, cb, cluster, rows_per_cta, threads,
                                                     smem, relu, s);
}

extern "C" int crossloc_gn_shard_backward_apply(const void* x, const void* dy,
                                                const float* gamma, const float* beta,
                                                const float* stats, const float* gathered,
                                                void* dx, float* dgamma, float* dbeta, int index,
                                                int S, int B, int HW, int count_hw, int C, int G,
                                                int cb, int rows_per_cta, int threads, int relu,
                                                int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_shard_backward_apply<__nv_bfloat16>(
                       x, dy, gamma, beta, stats, gathered, dx, dgamma, dbeta, index, S, B, HW,
                       count_hw, C, G, cb, rows_per_cta, threads, relu, s)
                 : launch_shard_backward_apply<float>(x, dy, gamma, beta, stats, gathered, dx,
                                                      dgamma, dbeta, index, S, B, HW, count_hw,
                                                      C, G, cb, rows_per_cta, threads, relu, s);
}

extern "C" const char* crossloc_cuda_error_string(int err) {
  switch (err) {
    case kErrNoEncoder:
      return "libcuda has no cuTensorMapEncodeTiled";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused the tensor map";
    case kErrSmemPlan:
      return "the kernel's geometry or shared-memory layout does not match its plan (more "
             "bytes than planned or 227 KB, or a channel block, row range or thread count it "
             "does not take)";
    case kErrNoCluster:
      return "no cluster of this size and shared memory fits the card "
             "(cudaOccupancyMaxActiveClusters = 0)";
    case kErrNoResidency:
      return "the grid design's CTAs do not all fit the card at once (occupancy x SMs is "
             "below the planned grid), so its cooperative launch is refused";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
