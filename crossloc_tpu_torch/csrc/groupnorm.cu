// Fused GroupNorm(+ReLU) forward over NHWC activations, for Hopper (sm_90a).
//
// Replaces crossloc_tpu/ops/pallas_groupnorm.py::_kernel (the TPU kernel
// launched by _pallas_forward). Same function: per (image, group) statistics
// in fp32 over H*W*channels-in-group, y = gamma * (x - mu) * rsqrt(var + eps)
// + beta, optional ReLU, output in the input's type (f32 or bf16).
//
// Bound: memory bandwidth. The work is a few flops per element, far below
// the card's flop/byte balance. The least traffic is one read of x and one
// write of y. This kernel makes three passes (two reads of x, one write of y):
//   (a) gn_stats:    each block takes one (image, chunk of H*W rows) and reads
//                    its rows as contiguous 16-byte vectors; every thread keeps
//                    Welford (mean, M2) for its 4 (f32) or 8 (bf16) channels;
//                    the block merges its row slots with Chan's formula and
//                    writes per-channel partials to scratch [B, chunks, 2, C].
//   (b) gn_finalize: one block per (image, group) merges the chunk x channel
//                    partials of the group (Chan), then writes per channel
//                    a = gamma * rsqrt(var + eps), the group mean mu, and beta.
//   (c) gn_apply:    y = max((x - mu) * a + beta, 0) over contiguous NHWC,
//                    16-byte loads and stores. Centring before the scale keeps
//                    the precision of the plain version when |mu| >> std.
// Centred partials merged with Chan's formula never form E[x^2] - mu^2, so the
// variance cannot go negative through cancellation (the TPU kernel's
// one-pass formula can). One image at 60x90x512 does not fit one SM's shared
// memory, hence the cross-block reduction through scratch.
//
// Plain C interface (bound with ctypes). The caller allocates y and the
// scratch; the function launches on the given stream, does not synchronise,
// and returns the first CUDA error (0 when every launch was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
cudaError_t launch(const void* x, void* y, const float* gamma, const float* beta, float* part,
                   float* affine, int B, int HW, int C, int G, int chunk_rows, int nchunks,
                   float eps, int relu, cudaStream_t stream) {
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

}  // namespace

extern "C" int crossloc_gn_forward(const void* x, void* y, const float* gamma, const float* beta,
                                   float* part, float* affine, int B, int HW, int C, int G,
                                   int chunk_rows, int nchunks, float eps, int relu, int is_bf16,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, y, gamma, beta, part, affine, B, HW, C, G, chunk_rows,
                                      nchunks, eps, relu, s)
              : launch<float>(x, y, gamma, beta, part, affine, B, HW, C, G, chunk_rows, nchunks,
                              eps, relu, s);
  return static_cast<int>(err);
}

extern "C" const char* crossloc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
