// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` (body `_kernel`) in
// src/repro/kernels/paged_attention/kernel.py. Its plain PyTorch version is
// repro_torch/kernels/paged_attention/ref.py.
//
// What it computes. One new query token per sequence. For sequence s and
// KV head g, the QPK = H / KV query heads g*QPK .. g*QPK+QPK-1 attend over the
// sequence's first context_lens[s] cached tokens, gathered page by page from
// the pool (NB, BS, KV, D) through block_tables[s, p]. Scores are scaled by
// D^-0.5; the softmax is online (running max, sum and accumulator, all f32);
// the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: bytes. Every live K and V row (2*D elements)
// is read once and feeds 4*QPK*D flops, i.e. QPK/2 flop per byte with an f32
// pool: two orders of magnitude below the ~295 flop/byte at which the tensor
// cores would become the limit. The least time is the live pool bytes over
// 3.35 TB/s.
//
// What the design does about it. One block per (sequence, KV head) keeps the
// whole QPK query group in shared memory, so each K/V page crosses HBM once
// for all QPK heads. The block stages its block-table row in shared memory
// and walks only ceil(ctx / BS) pages (never more than MB), a tile of up to
// 128 tokens at a time; rows of the last page at or past the context are
// neither loaded nor used. With one block per (sequence, KV head) only a few
// SMs stream, so each keeps many bytes in flight: 16-byte loads, eight of K
// and eight of V issued before any is stored to shared memory.
//
// Trap: block 0 is NOT a reserved null block. Every block starts on the
// engine's free list and unused block-table slots are zero-filled, so block 0
// usually holds another sequence's live KV. A page past the context is never
// read. The ids of live pages are not checked: they must lie in [0, NB), as
// the engine's allocator (engine/kv_cache.py) hands out no other.
//
// Layout contract, checked by the wrapper: D is a multiple of the 16-byte
// load width (4 f32 or 8 bf16 elements) and both pools start 16-byte aligned.
//
// Left for later work: splitting a sequence's pages over several blocks
// (flash decoding) when S * KV blocks cannot fill the 132 SMs, and
// cp.async/TMA double buffering that overlaps a tile's loads with the
// previous tile's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileTokens = 128;  // tokens staged in shared memory per step
constexpr int kUnroll = 8;           // 16-byte loads in flight per thread, each of K and V
constexpr size_t kMaxSmem = 227 * 1024;
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

// A chunk of VEC consecutive pool elements: one 16-byte load.
template <typename TKV>
struct Chunk {
  static constexpr int VEC = 16 / sizeof(TKV);
  uint4 raw;
  __device__ __forceinline__ void load(const TKV* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void store(float* dst) const {
    const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = to_f32(e[i]);
  }
};

// Shared memory: floats q [QPK][D], k [tile][D+1], v [tile][D], p [QPK][tile],
// acc [QPK][D], m/l/alpha [QPK]; then the block-table row, MB ints.
inline size_t smem_bytes(int qpk, int D, int tile, int MB) {
  return sizeof(float) * ((size_t)qpk * D * 2 + (size_t)tile * (D + 1) +
                          (size_t)tile * D + (size_t)qpk * tile + 3 * qpk) +
         sizeof(int) * (size_t)MB;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                    const TKV* __restrict__ pool_v,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, TQ* __restrict__ out,
                    int H, int KV, int D, int BS, int MB, int tile,
                    float scale) {
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int qpk = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int DK = D + 1;  // padded k rows: one thread per (head, token) dot
  constexpr int VEC = Chunk<TKV>::VEC;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + qpk * D;
  float* vs = ks + tile * DK;
  float* ps = vs + tile * D;
  float* acc = ps + qpk * tile;
  float* m = acc + qpk * D;
  float* l = m + qpk;
  float* alpha = l + qpk;
  int* bts = reinterpret_cast<int*>(alpha + qpk);

  const int ctx = context_lens[s];
  const int pages = ctx <= 0 ? 0 : min((ctx + BS - 1) / BS, MB);
  const int live = min(ctx, pages * BS);  // tokens that take part

  const size_t head0 = ((size_t)s * H + (size_t)g * qpk) * D;
  for (int i = tid; i < qpk * D; i += kThreads) {
    qs[i] = to_f32(q[head0 + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < qpk; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int p = tid; p < pages; p += kThreads)
    bts[p] = block_tables[(size_t)s * MB + p];

  const size_t tok_stride = (size_t)KV * D;  // between tokens of one block
  const int row_chunks = D / VEC;

  for (int t0 = 0; t0 < live; t0 += tile) {
    const int n = min(tile, live - t0);  // live tokens in this tile
    const int chunks = n * row_chunks;
    __syncthreads();  // previous tile consumed; q/acc/m/l/bts initialised
    for (int base = tid; base < chunks; base += kThreads * kUnroll) {
      Chunk<TKV> kc[kUnroll], vc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < chunks) {
          const int t = i / row_chunks, c = (i - t * row_chunks) * VEC;
          const int pos = t0 + t;
          const size_t off =
              ((size_t)bts[pos / BS] * BS + pos % BS) * tok_stride +
              (size_t)g * D + c;
          kc[u].load(pool_k + off);
          vc[u].load(pool_v + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < chunks) {
          const int t = i / row_chunks, c = (i - t * row_chunks) * VEC;
          kc[u].store(ks + t * DK + c);
          vc[u].store(vs + t * D + c);
        }
      }
    }
    __syncthreads();
    // scores: one thread per (query head, token)
    for (int pair = tid; pair < qpk * tile; pair += kThreads) {
      const int h = pair / tile, t = pair - h * tile;
      float dot = kNegInf;
      if (t < n) {
        dot = 0.f;
        const float* qr = qs + h * D;
        const float* kr = ks + t * DK;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        dot *= scale;
      }
      ps[pair] = dot;
    }
    __syncthreads();
    // online softmax: one warp per query head
    for (int h = warp; h < qpk; h += kWarps) {
      float* pr = ps + h * tile;
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_old = m[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[h] = a;
        l[h] = a * l[h] + sum;
        m[h] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ v: one thread per (query head, d)
    for (int i = tid; i < qpk * D; i += kThreads) {
      const int h = i / D, d = i - h * D;
      const float* pr = ps + h * tile;
      float a = acc[i] * alpha[h];
      for (int t = 0; t < n; ++t) a += pr[t] * vs[t * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < qpk * D; i += kThreads) {
    out[head0 + i] = from_f32<TQ>(acc[i] / fmaxf(l[i / D], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* bt, const int* lens, void* out, int S, int H,
                   int KV, int D, int BS, int MB, float scale,
                   cudaStream_t stream) {
  if (D % Chunk<TKV>::VEC != 0 || reinterpret_cast<uintptr_t>(pk) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pv) % 16 != 0)
    return cudaErrorInvalidValue;
  const int qpk = H / KV;
  // the largest whole-page tile of at most 128 tokens that fits
  int tile = BS >= kMaxTileTokens ? BS : (kMaxTileTokens / BS) * BS;
  while (tile > BS && smem_bytes(qpk, D, tile, MB) > kMaxSmem) tile -= BS;
  const size_t smem = smem_bytes(qpk, D, tile, MB);
  auto kern = paged_decode_kernel<TQ, TKV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(S, KV), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pk),
      static_cast<const TKV*>(pv), bt, lens, static_cast<TQ*>(out), H, KV, D,
      BS, MB, tile, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; (q, pool) is (f32, f32),
// (bf16, bf16) or (bf16, f32). Returns a cudaError_t.
extern "C" int paged_attention_decode(const void* q, const void* pool_k,
                                      const void* pool_v,
                                      const int* block_tables,
                                      const int* context_lens, void* out,
                                      int S, int H, int KV, int D, int BS,
                                      int MB, float scale, int q_dtype,
                                      int kv_dtype, void* stream) {
  if (S <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D > 256 || BS <= 0 ||
      MB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch<float, float>(q, pool_k, pool_v, block_tables,
                                     context_lens, out, S, H, KV, D, BS, MB,
                                     scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, pool_k, pool_v, block_tables, context_lens, out, S, H, KV, D, BS,
        MB, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(q, pool_k, pool_v, block_tables,
                                             context_lens, out, S, H, KV, D,
                                             BS, MB, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
