// Paged decode attention for Hopper (sm_90a), split over pages.
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
// the output is acc / max(l, 1e-30) in q's dtype, and zeros for ctx = 0.
//
// What bounds it on the H100: bytes. Every live K and V row (2*D elements)
// is read once and feeds 4*QPK*D flops, i.e. QPK/2 flop per byte with an f32
// pool: two orders of magnitude below the ~295 flop/byte at which the tensor
// cores would become the limit. The least time is the live pool bytes over
// 3.35 TB/s.
//
// What the design does about it. The bytes have to stream from many SMs at
// once, so each sequence's pages are split over blocks (flash decoding):
// grid (splits, KV, S), each block one fixed span of whole pages
// (`span_pages`, from the wrapper's plan) of one sequence for one KV head,
// so every page crosses HBM once for all QPK heads. The split count comes
// from the shapes alone (MB over the span), never from context_lens, so the
// launch needs no synchronisation with the device; a block whose span
// starts at or past the context writes an empty partial (m = -inf, l = 0)
// and exits. Inside a block the span's block-table entries are staged once
// in shared memory (fetched beside the context length), and 32-token tiles
// of K and V stream through a two-stage ring by 16-byte cp.async, so tile
// n+1 is in flight while tile n is computed. The block's lanes form groups
// of G (8 for QPK <= 4, 16 for QPK <= 8, else 32); a group takes every
// GROUPS-th token of a
// tile, splits D across its lanes (D / G elements each), reduces each dot
// product with log2(G) shuffles, and keeps its own online softmax for the
// QPK heads in registers, rescaling its accumulator only when its running
// max grows. K/V rows are padded in shared memory so that the groups of a
// warp read different banks. The groups merge in shared memory, and the
// block writes its partial max, sum and f32 accumulator to scratch. A
// second kernel, `paged_combine_kernel`, merges the partials of each
// (sequence, head) by log-sum-exp, skipping empty ones, and writes the
// output.
//
// Trap: block 0 is NOT a reserved null block. Every block starts on the
// engine's free list and unused block-table slots are zero-filled, so block 0
// usually holds another sequence's live KV. A page at or past the context is
// never read, nor a row of the last page past it. The ids of live pages are
// not checked: they must lie in [0, NB), as the engine's allocator
// (engine/kv_cache.py) hands out no other.
//
// Layout contract, checked by the wrapper: D in {32, 64, 96, 128}, QPK <= 16,
// both pools 16-byte aligned.

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;   // tokens per ring stage
constexpr int kStages = 2;  // ring depth: kStages - 1 tiles in flight
constexpr int kPad = 8;    // elements of padding per K/V row in shared memory

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

// Lanes per token group: as few as keep the MAXQ query and accumulator rows
// at 2 * MAXQ * D / G <= 128 registers a lane at D 128. Fewer lanes means
// fewer shuffle rounds per dot and more tokens scored at once.
template <int MAXQ>
__host__ __device__ constexpr int group_lanes() {
  return MAXQ <= 4 ? 8 : (MAXQ <= 8 ? 16 : 32);
}

// Shared memory: the ring, k[kStages][kTile][D + kPad] and
// v[kStages][kTile][D + kPad] in the pool's type, reused after the loop for
// the groups' merge (floats acc [groups][QPK][D] and (m, l)
// [groups][QPK][2]); then the span's block-table entries.
__host__ __device__ inline size_t ring_bytes(int D, int kv_size, int qpk,
                                             int groups) {
  const size_t ring = (size_t)2 * kStages * kTile * (D + kPad) * kv_size;
  const size_t merge = sizeof(float) * (size_t)groups * qpk * (D + 2);
  return ((ring > merge ? ring : merge) + 15) / 16 * 16;
}

// Grid (splits, KV, S), kThreads threads; MAXQ >= QPK heads held in
// registers.
template <typename TQ, typename TKV, int D, int MAXQ>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                   const TKV* __restrict__ pool_v,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int H, int KV, int BS, int MB, int span_pages, float scale) {
  constexpr int G = group_lanes<MAXQ>();
  constexpr int E = D / G;                   // elements of D per lane
  constexpr int GROUPS = kThreads / G;       // token groups per block
  constexpr int TPG = kTile / GROUPS;        // tokens per group per tile
  constexpr int U = MAXQ * TPG <= 16 ? TPG : 16 / MAXQ;  // scored at once
  constexpr int RS = D + kPad;               // shared-memory row stride
  constexpr int VEC = 16 / sizeof(TKV);      // elements per 16-byte copy
  constexpr int ROW_CHUNKS = D / VEC;
  static_assert(D % G == 0 && TPG % U == 0, "bad tiling");
  const int split = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.x;
  const int qpk = H / KV;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gid = tid / G, r = lane % G;  // group in block, lane in group

  extern __shared__ __align__(16) uint8_t smem[];
  TKV* ring = reinterpret_cast<TKV*>(smem);  // [k|v][stage][kTile][RS]
  int* bts = reinterpret_cast<int*>(
      smem + ring_bytes(D, (int)sizeof(TKV), qpk, GROUPS));
  // the span's block-table entries are fetched alongside the context length
  // (entries past the context are staged but never followed)
  const int ctx = context_lens[s];
  const int span_cap = min(span_pages, MB - split * span_pages);
  for (int p = tid; p < span_cap; p += kThreads)
    bts[p] = block_tables[(size_t)s * MB + split * span_pages + p];

  const int live = min(max(ctx, 0), MB * BS);
  const int t_begin = split * span_pages * BS;
  const int t_end = min(t_begin + span_pages * BS, live);
  const int head0 = s * H + g * qpk;
  if (t_begin >= t_end) {  // empty split
    if (tid < qpk) {
      part_ml[2 * ((size_t)(head0 + tid) * splits + split)] = -INFINITY;
      part_ml[2 * ((size_t)(head0 + tid) * splits + split) + 1] = 0.f;
    }
    return;
  }
  const int n_tok = t_end - t_begin;

  // q in registers, pre-scaled: lane r of a group holds d = j * G + r (its
  // loads overlap the block table's)
  float qr[MAXQ][E], acc[MAXQ][E], m[MAXQ], l[MAXQ];
#pragma unroll
  for (int h = 0; h < MAXQ; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      qr[h][j] = h < qpk ? to_f32(q[(size_t)(head0 + h) * D + j * G + r]) *
                               scale
                         : 0.f;
      acc[h][j] = 0.f;
    }
  }
  __syncthreads();

  const size_t tok_stride = (size_t)KV * D;  // between tokens of one block
  auto load_tile = [&](int n) {  // one cp.async group per call
    const int t0 = n * kTile;  // relative to t_begin
    const int nt = min(kTile, n_tok - t0);
    TKV* kd = ring + (size_t)(n % kStages) * kTile * RS;
    TKV* vd = ring + (size_t)(kStages + n % kStages) * kTile * RS;
    for (int i = tid; i < nt * ROW_CHUNKS; i += kThreads) {
      const int t = i / ROW_CHUNKS, c = (i % ROW_CHUNKS) * VEC;
      const int pos = t0 + t;
      const size_t off = ((size_t)bts[pos / BS] * BS + pos % BS) * tok_stride +
                         (size_t)g * D + c;
      sm90::cp_async16(kd + t * RS + c, pool_k + off);
      sm90::cp_async16(vd + t * RS + c, pool_v + off);
    }
    sm90::cp_async_commit();
  };

  const int n_tiles = (n_tok + kTile - 1) / kTile;
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < n_tiles)
      load_tile(n);
    else
      sm90::cp_async_commit();  // empty groups keep the count uniform
  }
  for (int n = 0; n < n_tiles; ++n) {
    // the stage of tile n + kStages - 1 was freed by the last iteration's
    // barrier
    if (n + kStages - 1 < n_tiles)
      load_tile(n + kStages - 1);
    else
      sm90::cp_async_commit();
    sm90::cp_async_wait<kStages - 1>();
    __syncthreads();
    const TKV* ks = ring + (size_t)(n % kStages) * kTile * RS;
    const TKV* vs = ring + (size_t)(kStages + n % kStages) * kTile * RS;
    const int nt = min(kTile, n_tok - n * kTile);

#pragma unroll
    for (int k0 = 0; k0 < TPG; k0 += U) {
      // scores of U tokens for every head, with no branch between them, so
      // that their shuffle reductions interleave. A token past the tile's
      // end reads stale shared memory; its score becomes -inf and its V row
      // zeros (a select, so stale NaNs cannot leak).
      float sc[MAXQ][U];
      bool valid[U];
#pragma unroll
      for (int uu = 0; uu < U; ++uu) {
        const int t = (k0 + uu) * GROUPS + gid;
        valid[uu] = t < nt;
        float kv[E];
#pragma unroll
        for (int j = 0; j < E; ++j) kv[j] = to_f32(ks[t * RS + j * G + r]);
#pragma unroll
        for (int h = 0; h < MAXQ; ++h) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < E; ++j) dot = fmaf(qr[h][j], kv[j], dot);
          sc[h][uu] = dot;
        }
      }
#pragma unroll
      for (int o = G / 2; o; o >>= 1)
#pragma unroll
        for (int h = 0; h < MAXQ; ++h)
#pragma unroll
          for (int uu = 0; uu < U; ++uu)
            if (h < qpk)
              sc[h][uu] += __shfl_xor_sync(0xffffffffu, sc[h][uu], o);
#pragma unroll
      for (int h = 0; h < MAXQ; ++h) {
        if (h >= qpk) continue;
        float mx = m[h];
#pragma unroll
        for (int uu = 0; uu < U; ++uu) {
          sc[h][uu] = valid[uu] ? sc[h][uu] : -INFINITY;
          mx = fmaxf(mx, sc[h][uu]);
        }
        if (mx == -INFINITY) {  // no live token yet: nothing to add
#pragma unroll
          for (int uu = 0; uu < U; ++uu) sc[h][uu] = 0.f;
          continue;
        }
        if (mx > m[h]) {  // rescale only when the running max grows
          const float alpha = expf(m[h] - mx);  // 0 while m = -inf
          l[h] *= alpha;
#pragma unroll
          for (int j = 0; j < E; ++j) acc[h][j] *= alpha;
          m[h] = mx;
        }
#pragma unroll
        for (int uu = 0; uu < U; ++uu) {
          sc[h][uu] = expf(sc[h][uu] - mx);
          l[h] += sc[h][uu];
        }
      }
#pragma unroll
      for (int uu = 0; uu < U; ++uu) {
        const int t = (k0 + uu) * GROUPS + gid;
        float vv[E];
#pragma unroll
        for (int j = 0; j < E; ++j)
          vv[j] = valid[uu] ? to_f32(vs[t * RS + j * G + r]) : 0.f;
#pragma unroll
        for (int h = 0; h < MAXQ; ++h) {
          if (h >= qpk) continue;
#pragma unroll
          for (int j = 0; j < E; ++j)
            acc[h][j] = fmaf(sc[h][uu], vv[j], acc[h][j]);
        }
      }
    }
    __syncthreads();  // this stage is read; the next load may overwrite it
  }
  sm90::cp_async_wait<0>();

  // merge the groups, then write the block's partial
  float* red = reinterpret_cast<float*>(smem);     // [group][h][D]
  float* red_ml = red + (size_t)GROUPS * qpk * D;  // [group][h][2]
#pragma unroll
  for (int h = 0; h < MAXQ; ++h) {
    if (h >= qpk) continue;
#pragma unroll
    for (int j = 0; j < E; ++j)
      red[((size_t)gid * qpk + h) * D + j * G + r] = acc[h][j];
    if (r == 0) {
      red_ml[(gid * qpk + h) * 2] = m[h];
      red_ml[(gid * qpk + h) * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  for (int i = tid; i < qpk * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    float mx = -INFINITY;
    for (int w = 0; w < GROUPS; ++w)
      mx = fmaxf(mx, red_ml[(w * qpk + h) * 2]);
    float sum = 0.f, a = 0.f;
    for (int w = 0; w < GROUPS; ++w) {
      const float mw = red_ml[(w * qpk + h) * 2];
      if (mw == -INFINITY) continue;  // a group with no live token
      const float wt = expf(mw - mx);
      sum += wt * red_ml[(w * qpk + h) * 2 + 1];
      a += wt * red[((size_t)w * qpk + h) * D + d];
    }
    const size_t part = (size_t)(head0 + h) * splits + split;
    part_acc[part * D + d] = a;
    if (d == 0) {
      part_ml[2 * part] = mx;
      part_ml[2 * part + 1] = sum;
    }
  }
}

// Grid (H, S), D threads: merges the live splits of one (sequence, head);
// a split with m = -inf is empty and its accumulator unset.
template <typename TQ>
__global__ void paged_combine_kernel(const float* __restrict__ part_ml,
                                     const float* __restrict__ part_acc,
                                     const int* __restrict__ context_lens,
                                     TQ* __restrict__ out, int H, int splits,
                                     int span_tokens) {
  const int h = blockIdx.x, s = blockIdx.y, d = threadIdx.x, D = blockDim.x;
  const size_t base = ((size_t)s * H + h) * splits;
  const int live = min((max(context_lens[s], 0) + span_tokens - 1) /
                           span_tokens, splits);
  float mx = -INFINITY;
#pragma unroll 4
  for (int i = 0; i < live; ++i) mx = fmaxf(mx, part_ml[2 * (base + i)]);
  float sum = 0.f, a = 0.f;
#pragma unroll 4
  for (int i = 0; i < live; ++i) {
    const float mi = part_ml[2 * (base + i)];
    if (mi == -INFINITY) continue;
    const float wt = expf(mi - mx);
    sum += wt * part_ml[2 * (base + i) + 1];
    a += wt * part_acc[(base + i) * D + d];
  }
  out[((size_t)s * H + h) * D + d] = from_f32<TQ>(a / fmaxf(sum, 1e-30f));
}

template <typename TQ, typename TKV, int D, int MAXQ>
cudaError_t launch_split(const void* q, const void* pk, const void* pv,
                         const int* bt, const int* lens, float* ml,
                         float* acc, int S, int H, int KV, int BS, int MB,
                         int span_pages, int splits, float scale,
                         cudaStream_t stream) {
  const int qpk = H / KV;
  const size_t smem = ring_bytes(D, (int)sizeof(TKV), qpk,
                                 kThreads / group_lanes<MAXQ>()) +
                      sizeof(int) * span_pages;
  auto kern = paged_split_kernel<TQ, TKV, D, MAXQ>;
  static size_t smem_set = 0;  // largest size allowed so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kern<<<dim3(splits, KV, S), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pk),
      static_cast<const TKV*>(pv), bt, lens, ml, acc, H, KV, BS, MB,
      span_pages, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t dispatch_qpk(const void* q, const void* pk, const void* pv,
                         const int* bt, const int* lens, float* ml,
                         float* acc, int S, int H, int KV, int BS, int MB,
                         int span_pages, int splits, float scale,
                         cudaStream_t st) {
  const int qpk = H / KV;
#define PAGED_SPLIT(MAXQ)                                                 \
  launch_split<TQ, TKV, D, MAXQ>(q, pk, pv, bt, lens, ml, acc, S, H, KV, \
                                 BS, MB, span_pages, splits, scale, st)
  // three widths only: rows past QPK are dead (`h < qpk` guards them)
  if (qpk <= 4) return PAGED_SPLIT(4);
  if (qpk <= 8) return PAGED_SPLIT(8);
  if (qpk <= 16) return PAGED_SPLIT(16);
#undef PAGED_SPLIT
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* bt, const int* lens, void* out, float* ml,
                   float* acc, int S, int H, int KV, int D, int BS, int MB,
                   int span_pages, int splits, float scale,
                   cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(pk) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pv) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t e;
  switch (D) {
    case 32:
      e = dispatch_qpk<TQ, TKV, 32>(q, pk, pv, bt, lens, ml, acc, S, H, KV, BS,
                                    MB, span_pages, splits, scale, stream);
      break;
    case 64:
      e = dispatch_qpk<TQ, TKV, 64>(q, pk, pv, bt, lens, ml, acc, S, H, KV, BS,
                                   MB, span_pages, splits, scale, stream);
      break;
    case 96:
      e = dispatch_qpk<TQ, TKV, 96>(q, pk, pv, bt, lens, ml, acc, S, H, KV, BS,
                                   MB, span_pages, splits, scale, stream);
      break;
    case 128:
      e = dispatch_qpk<TQ, TKV, 128>(q, pk, pv, bt, lens, ml, acc, S, H, KV, BS,
                                   MB, span_pages, splits, scale, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  paged_combine_kernel<TQ><<<dim3(H, S), D, 0, stream>>>(
      ml, acc, lens, static_cast<TQ*>(out), H, splits, span_pages * BS);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; (q, pool) is (f32, f32),
// (bf16, bf16) or (bf16, f32). `span_pages` pages per split and `splits`
// come from the wrapper's plan; `scratch` holds S * H * splits * (D + 2) f32:
// the partial (max, sum) pairs (S, H, splits, 2), then the partial
// accumulators (S, H, splits, D). Returns a cudaError_t.
extern "C" int paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v,
    const int* block_tables, const int* context_lens, void* out,
    float* scratch, int S, int H, int KV, int D, int BS, int MB,
    int span_pages, int splits, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  float* part_ml = scratch;
  float* part_acc = scratch + (size_t)2 * S * H * splits;
  if (S <= 0 || KV <= 0 || H % KV != 0 || BS <= 0 || MB <= 0 ||
      span_pages <= 0 || splits != (MB + span_pages - 1) / span_pages ||
      S > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS                                                          \
  q, pool_k, pool_v, block_tables, context_lens, out, part_ml, part_acc, S, \
      H, KV, D, BS, MB, span_pages, splits, scale, st
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch<float, float>(PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
