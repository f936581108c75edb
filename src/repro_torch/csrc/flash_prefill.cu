// Causal (optionally sliding-window) flash prefill attention for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_prefill` (body `_kernel`) in
// src/repro/kernels/flash_prefill/kernel.py. Its plain PyTorch version is
// repro_torch/kernels/flash_prefill/ref.py.
//
// What it computes. q (B, T, H, D), k and v (B, T, KV, D) -> (B, T, H, D).
// Key j is visible to query i iff j <= i and, when window > 0, j > i - window.
// Query head h reads KV head h / QPK. Scores are scaled by D^-0.5 and the
// softmax is online in f32; the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: operations. A prompt of T tokens does
// 4 * D * T(T+1)/2 flops per head against 2 * T * D bytes of K/V per KV head,
// far above the ~295 flop/byte ridge point once T is in the hundreds, so the
// least time is the causal flops over the bf16 tensor-core peak (989 TFLOP/s).
//
// What the design does about it, in this first, simple form. One block per
// (batch, KV head, query tile) stacks the QPK heads of the tile's positions as
// the 64 rows of one tile, so every K/V tile staged in shared memory serves
// all QPK heads (the TPU kernel's (bq*QPK, D) GQA tile). The block walks key
// tiles from the window start to the diagonal only, skipping the dead ones.
// Both products run on the CUDA cores in f32 from shared memory with 4x4
// register micro-tiles; moving them onto the tensor cores (wgmma fed by TMA)
// is the later, fast form. T need not be a multiple of any tile: positions
// past T are masked, not asserted away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column groups of 4x4
constexpr int kRows = 64;      // query rows per block: (64 / QPK) positions
constexpr int kBK = 32;        // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats: q [64][D+1], k [32][D+1], v [32][D],
// p [64][33], o [64][D], m/l/alpha [64].
inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kRows * (kBK + 1) +
                          (size_t)kRows * D + 3 * kRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Tn,
                     int H, int KV, int D, int window, float scale) {
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int qpk = H / KV;
  const int bq = kRows / qpk;    // positions per query tile
  const int rows = bq * qpk;     // live rows (<= 64)
  const int q0 = blockIdx.x * bq;
  const int q_last = min(q0 + bq, Tn) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid >> 3, cg = tid & 7;  // 4x4 micro-tile coordinates
  const int DQ = D + 1;
  constexpr int PS = kBK + 1;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * DQ;
  float* vs = ks + kBK * DQ;
  float* ps = vs + kBK * D;
  float* os = ps + kRows * PS;
  float* m = os + kRows * D;
  float* l = m + kRows;
  float* alpha = l + kRows;

  // row r <-> position q0 + r / QPK, head g*QPK + r % QPK
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int pos = q0 + r / qpk;
    float x = 0.f;
    if (r < rows && pos < Tn)
      x = to_f32(q[(((size_t)b * Tn + pos) * H + (size_t)g * qpk + r % qpk) *
                       D + d]);
    qs[r * DQ + d] = x;
    os[r * D + d] = 0.f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo -= k_lo % kBK;
  for (int k0 = k_lo; k0 <= q_last; k0 += kBK) {
    __syncthreads();  // previous tile consumed; q/o/m/l initialised
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const int pos = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (pos < Tn) {
        const size_t off = (((size_t)b * Tn + pos) * KV + g) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[c * DQ + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    // s = q k^T on rows 4rg..4rg+3 x keys 4cg..4cg+3, masked
    {
      float sacc[4][4] = {};
      for (int d = 0; d < D; ++d) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(rg * 4 + i) * DQ + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = ks[(cg * 4 + j) * DQ + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] += a[i] * bb[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const int qpos = q0 + r / qpk;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + cg * 4 + j;
          const bool ok = r < rows && qpos < Tn && kpos <= qpos &&
                          (window == 0 || kpos > qpos - window);
          ps[r * PS + cg * 4 + j] = ok ? sacc[i][j] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 16w..16w+15, one key per lane
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const float sc = ps[r * PS + lane];
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float p = sc == kNegInf ? 0.f : expf(sc - m_new);
      ps[r * PS + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l[r] = a * l[r] + sum;
        m[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();

    // o = o * alpha + p v, 32 columns of D at a time
    for (int dc = 0; dc < D; dc += 32) {
      float oacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = alpha[rg * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dc + cg * 4 + j;
          oacc[i][j] = d < D ? os[(rg * 4 + i) * D + d] * a : 0.f;
        }
      }
      for (int c = 0; c < kBK; ++c) {
        float pv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dc + cg * 4 + j;
          vv[j] = d < D ? vs[c * D + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) oacc[i][j] += pv[i] * vv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dc + cg * 4 + j;
          if (d < D) os[(rg * 4 + i) * D + d] = oacc[i][j];
        }
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int pos = q0 + r / qpk;
    if (pos < Tn)
      out[(((size_t)b * Tn + pos) * H + (size_t)g * qpk + r % qpk) * D + d] =
          from_f32<T>(os[r * D + d] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Tn, int H, int KV, int D, int window, float scale,
                   cudaStream_t stream) {
  const int qpk = H / KV;
  const int bq = kRows / qpk;
  const size_t smem = smem_bytes(D);
  auto kern = flash_prefill_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Tn + bq - 1) / bq, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tn, H, KV, D, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int flash_prefill_forward(const void* q, const void* k,
                                     const void* v, void* out, int B, int Tn,
                                     int H, int KV, int D, int window,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || Tn <= 0 || KV <= 0 || H % KV != 0 || H / KV > kRows ||
      D <= 0 || D > 256 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, out, B, Tn, H, KV, D, window, scale,
                                st);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, out, B, Tn, H, KV, D, window,
                                        scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
