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
//
// Plain C interface (bound with ctypes). The caller allocates y (and, for the
// three-pass design, the scratch); each function launches on the given
// stream, does not synchronise, and returns the first error (0 when every
// launch was accepted; CUDA's codes, or a negative code of this file that
// crossloc_cuda_error_string names).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void gn_finalize_kernel(const float* __restrict__ part, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* __restrict__ affine,
                                   int HW, int C, int G, int chunk_rows, int nchunks, float eps) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
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
  __shared__ float s_mu, s_rstd;
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
  if (tid == 0) {
    const float var = fmaxf(sm2[0] / sn[0], 0.f);
    s_mu = smean[0];
    s_rstd = rsqrtf(var + eps);
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
                              float* part, float* affine, int B, int HW, int C, int G,
                              int chunk_rows, int nchunks, float eps, int relu,
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
      part, gamma, beta, affine, HW, C, G, chunk_rows, nchunks, eps);
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

// Row slots left after a warp's shuffles (see block_group_sums).
__device__ __forceinline__ int red_slots(int vpr) {
  return (32 % vpr) == 0 ? blockDim.x >> 5 : blockDim.x / vpr;
}

// Per-group sums over the block, for NA arrays of per-thread partials: each
// thread holds V partials for the V channels of its column cv (channels
// cv*V .. cv*V+V-1 of the block); out[a * out_stride + g] receives array a's
// sum over group g. Fixed order, so every CTA that holds the same partials
// gets the same bits. Ends with __syncthreads, so `red` may be reused.
template <int V, int NA>
__device__ __forceinline__ void block_group_sums(float (&acc)[NA][V], float* red, float* out,
                                                 int out_stride, int vpr, int cb, int gs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nslots = red_slots(vpr);
  const int n_red = nslots * cb;  // floats per array in red
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

// One cluster of `cs` CTAs per (image, channel block of cb channels);
// gridDim.x = cs * C / cb, gridDim.y = B. CTA `rank` holds rows
// [rank * rows_per_cta, +rows_per_cta) of its image (fewer in the last CTA),
// loaded in boxes of box_rows rows.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
    gn_cluster_kernel(const __grid_constant__ CUtensorMap xmap, T* __restrict__ y,
                      const float* __restrict__ gamma, const float* __restrict__ beta, int HW,
                      int C, int gs, int cb, int rows_per_cta, int box_rows, int nbox, float eps,
                      int relu) {
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

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
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

// configurations whose cluster occupancy was checked, per kernel instance
// (and devices whose shared-memory limit was raised)
struct Checked {
  int dev, cs, threads, smem;
};
constexpr int kMaxChecked = 256;

template <typename T>
int launch_cluster(const void* x, void* y, const float* gamma, const float* beta, int B, int HW,
                   int C, int G, int cb, int cs, int rows_per_cta, int box_rows, int nbox,
                   int threads, int smem, float eps, int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int gs = C / G;
  if (cluster_smem_bytes(sizeof(T), V, cb, gs, box_rows, nbox, threads, cs) > (size_t)smem ||
      smem > kMaxDynSmem || cs > kMaxCluster)
    return kErrSmemPlan;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;

  static Checked checked[kMaxChecked];
  static int n_checked = 0;
  static unsigned raised = 0;  // bit per device: shared-memory limit raised
  if (dev < 32 && !(raised & (1u << dev))) {
    err = cudaFuncSetAttribute(gn_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynSmem);
    if (err != cudaSuccess) return err;
    raised |= 1u << dev;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * (C / cb), B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  bool seen = false;
  for (int i = 0; i < n_checked && !seen; ++i)
    seen = checked[i].dev == dev && checked[i].cs == cs && checked[i].threads == threads &&
           checked[i].smem == smem;
  if (!seen) {
    int n_clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&n_clusters, gn_cluster_kernel<T>, &cfg);
    if (err != cudaSuccess) return err;
    if (n_clusters < 1) return kErrNoCluster;
    if (n_checked < kMaxChecked) checked[n_checked++] = Checked{dev, cs, threads, smem};
  }

  CUtensorMap xmap;
  const int e = encode_map(&xmap, x, sizeof(T) == 2, B, HW, C, cb, box_rows);
  if (e != 0) return e;
  err = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T>, xmap, static_cast<T*>(y), gamma, beta, HW,
                           C, gs, cb, rows_per_cta, box_rows, nbox, eps, relu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int crossloc_gn_forward(const void* x, void* y, const float* gamma, const float* beta,
                                   float* part, float* affine, int B, int HW, int C, int G,
                                   int chunk_rows, int nchunks, float eps, int relu, int is_bf16,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_three_pass<__nv_bfloat16>(x, y, gamma, beta, part, affine, B, HW, C, G,
                                                 chunk_rows, nchunks, eps, relu, s)
              : launch_three_pass<float>(x, y, gamma, beta, part, affine, B, HW, C, G,
                                         chunk_rows, nchunks, eps, relu, s);
  return static_cast<int>(err);
}

extern "C" int crossloc_gn_cluster_forward(const void* x, void* y, const float* gamma,
                                           const float* beta, int B, int HW, int C, int G, int cb,
                                           int cluster, int rows_per_cta, int box_rows, int nbox,
                                           int threads, int smem, float eps, int relu,
                                           int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_cluster<__nv_bfloat16>(x, y, gamma, beta, B, HW, C, G, cb, cluster,
                                                 rows_per_cta, box_rows, nbox, threads, smem,
                                                 eps, relu, s)
                 : launch_cluster<float>(x, y, gamma, beta, B, HW, C, G, cb, cluster,
                                         rows_per_cta, box_rows, nbox, threads, smem, eps, relu,
                                         s);
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
