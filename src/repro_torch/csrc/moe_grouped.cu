// Grouped expert GEMM for the MoE feed-forward when serving, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The JAX package's `moe_block`
// (src/repro/models/moe.py) places each token's routed copies in an
// (E, C, d) capacity buffer and runs every expert over its C rows as one
// batched product, dropping a copy past C. Served dropless at prompt sizes
// that buffer needs C = n: at a 2 048-token chunk of Qwen3-30B-A3B, 1 GB and
// 128 x the expert FLOPs. This kernel computes only the rows that were
// routed. Its plain PyTorch version is repro_torch/kernels/moe_grouped/ref.py.
//
// What it computes. x (R, d): the R = n * k routed rows, sorted by expert;
// offsets (E + 1) int32 on the device: expert e's rows are offsets[e] ..
// offsets[e + 1] - 1 (offsets[E] = R). For each row r of expert e,
//   h[r]   = silu(x[r] @ w_gate[e]) * (x[r] @ w_up[e])    (f, in x's dtype)
//   out[r] = h[r] @ w_down[e]                             (d, in x's dtype)
// with w_gate, w_up (E, d, f) and w_down (E, f, d), accumulated in f32.
//
// What bounds it on the H100. Decode: bytes. A batch of 45 sequences routes
// 360 rows to about 121 of 128 experts a layer, 3 rows each, and every
// expert touched has to stream its 9.4 MB of weights once. Prefill:
// operations. A 740-token prompt gives each expert about 46 rows, 2 x 46
// flops for each weight element read, and the experts hold two thirds of a
// prefill's weight flops.
//
// What the design does about it. Two launches, gate-and-up then down, each
// on a grid of (row tiles, column tiles). The number of row tiles is a bound
// the host knows without reading the device: ceil(R / 64) + E, since each
// expert adds at most one partial tile. Each block reads the E + 1 offsets,
// turns them into per-expert tile counts and scans them (one warp-shuffle
// scan per 128 experts), and so finds its expert and its 64 rows; a block
// past the last tile exits at once, and an expert with no rows has no tile,
// so its weights are never read. Within a tile, bf16 runs on the tensor
// cores by `mma.sync` m16n8k16: 4 warps of 32 x 32 outputs each, 32-deep k
// slices of the rows and of the weights staged by 16-byte `cp.async` in a
// three-stage ring (rows past the segment zero-filled), padded so that
// `ldmatrix` reads distinct banks. Gate and up share the row tile and are
// fused with SiLU in registers, so `h` is written once, in x's dtype. f32
// runs on CUDA cores (4 x 4 outputs a thread, 16-deep k slices), in full
// f32, for the f32 oracle checks. No output is written by two threads and
// nothing is accumulated by atomics, so a call repeats bitwise.
//
// Counters. Given an int64 accumulator, the gate-and-up launch adds one
// call and the call's routed rows (block (0, 0)), and for each expert with
// a row, one expert touched and its block-padding rows (the first column
// tile of its first row tile): `kernels/moe_grouped`'s `counters`, read by
// tools/moe_routing.py. The adds never touch the outputs.
//
// Layout contract, checked by the wrapper: d and f multiples of 64, E at
// most 1024, every tensor contiguous and 16-byte aligned.

#include "sm90.cuh"

namespace {

constexpr int kBM = 64;            // rows per tile
constexpr int kBN = 64;            // output columns per tile
constexpr int kMaxExperts = 1024;

// ---- which tile a block computes ---------------------------------------------

struct Tile {
  int expert;  // -1: past the last tile
  int row0;    // first row of the tile
  int rows;    // rows of the tile that belong to the expert (1 .. kBM)
};

// Block-wide: the tile `tile` of the grouped rows, from the per-expert
// counts ceil(rows / kBM) in expert order. With `stats`, the block that
// holds an expert's first tile counts the expert and its padding rows.
template <int kThreads>
__device__ Tile find_tile(const int* __restrict__ offsets, int E, int tile,
                          unsigned long long* stats) {
  __shared__ int s_warp[kThreads / 32];
  __shared__ Tile s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile.expert = -1;
  int carry = 0;
  for (int base = 0; base < E; base += kThreads) {
    const int e = base + tid;
    int lo = 0, cnt = 0;
    if (e < E) {
      lo = offsets[e];
      cnt = offsets[e + 1] - lo;
    }
    const int n = (cnt + kBM - 1) / kBM;
    int v = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    int before = carry, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
    const int first = before + v - n;
    if (n > 0 && tile >= first && tile < first + n) {
      const int row0 = lo + (tile - first) * kBM;
      s_tile = Tile{e, row0, min(kBM, lo + cnt - row0)};
      if (stats != nullptr && tile == first) {
        atomicAdd(stats + 2, 1ull);
        atomicAdd(stats + 3, (unsigned long long)(n * kBM - cnt));
      }
    }
    carry += total;
    __syncthreads();
  }
  return s_tile;
}

__device__ __forceinline__ void count_call(const int* offsets, int E,
                                           unsigned long long* stats) {
  if (stats != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    atomicAdd(stats, 1ull);
    atomicAdd(stats + 1, (unsigned long long)offsets[E]);
  }
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// ---- bf16: tensor cores by mma.sync ----------------------------------------

constexpr int kThreads16 = 128;    // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int kBK = 32;            // k per stage
constexpr int kStages = 3;
constexpr int kAStride = kBK + 8;  // 80-byte rows: ldmatrix conflict-free
constexpr int kBStride = kBN + 8;  // 144-byte rows: ldmatrix.trans too

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(sm90::smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kGated: out (R, N) = silu(x @ w0[e]) * (x @ w1[e]); else x @ w0[e].
// x (R, K); w0, w1 (E, K, N).
template <bool kGated>
__global__ void __launch_bounds__(kThreads16)
grouped_bf16(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w0,
             const __nv_bfloat16* __restrict__ w1,
             const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out,
             unsigned long long* stats, int E, int K, int N) {
  constexpr int kMats = kGated ? 2 : 1;
  // bf16 tiles, as raw 16-bit words: only copies and ldmatrix touch them
  __shared__ __align__(16) uint16_t sa[kStages][kBM * kAStride];
  __shared__ __align__(16) uint16_t sb[kStages][kMats][kBK * kBStride];
  count_call(offsets, E, stats);
  const Tile t = find_tile<kThreads16>(offsets, E, blockIdx.x,
                                       blockIdx.y == 0 ? stats : nullptr);
  if (t.expert < 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 quarter
  const int n0 = blockIdx.y * kBN;
  const size_t wsize = (size_t)K * N;
  const __nv_bfloat16* wb[kMats];
  wb[0] = w0 + t.expert * wsize + n0;
  if (kGated) wb[kMats - 1] = w1 + t.expert * wsize + n0;
  const __nv_bfloat16* xa = x + (size_t)t.row0 * K;

  // one stage: 64 x 32 of the rows and 32 x 64 of each weight, 16 bytes a
  // copy, two copies of each a thread
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads16;
      const int r = c >> 2, col = (c & 3) * 8;
      const bool live = r < t.rows;
      cp_async16_zfill(&sa[stage][r * kAStride + col],
                       live ? xa + (size_t)r * K + k0 + col : x, live);
    }
#pragma unroll
    for (int m = 0; m < kMats; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kThreads16;
        const int r = c >> 3, col = (c & 7) * 8;
        sm90::cp_async16(&sb[stage][m][r * kBStride + col],
                         wb[m] + (size_t)(k0 + r) * N + col);
      }
  };

  float acc[kMats][2][4][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][i][j][v] = 0.f;

  const int ktiles = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s * kBK);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free to refill
    if (kt + kStages - 1 < ktiles)
      load((kt + kStages - 1) % kStages, (kt + kStages - 1) * kBK);
    sm90::cp_async_commit();
    const int st = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], &sa[st][(wm * 32 + i * 16 + (lane & 15)) * kAStride +
                                   ks + (lane >> 4) * 8]);
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        uint32_t bf[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4_trans(
              bf[j], &sb[st][m][(ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    kBStride +
                                wn * 32 + j * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[m][i][j], af[i], bf[j >> 1][(j & 1) * 2],
                     bf[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }
  sm90::cp_async_wait<0>();

  // c0, c1: row lane / 4, columns 2 (lane % 4) + {0, 1}; c2, c3: row + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + i * 16 + (lane >> 2) + half * 8;
      if (r >= t.rows) continue;
      __nv_bfloat16* o = out + (size_t)(t.row0 + r) * N + n0 + wn * 32 +
                         (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v0 = acc[0][i][j][half * 2], v1 = acc[0][i][j][half * 2 + 1];
        if (kGated) {
          v0 = silu(v0) * acc[kMats - 1][i][j][half * 2];
          v1 = silu(v1) * acc[kMats - 1][i][j][half * 2 + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(o + j * 8) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// ---- f32: CUDA cores, full f32 ---------------------------------------------

constexpr int kThreads32 = 256;    // 16 x 16 threads of 4 x 4 outputs
constexpr int kBK32 = 16;

template <bool kGated>
__global__ void __launch_bounds__(kThreads32)
grouped_f32(const float* __restrict__ x, const float* __restrict__ w0,
            const float* __restrict__ w1, const int* __restrict__ offsets,
            float* __restrict__ out, unsigned long long* stats, int E, int K,
            int N) {
  constexpr int kMats = kGated ? 2 : 1;
  __shared__ __align__(16) float sa[kBK32][kBM + 4];   // rows transposed
  __shared__ __align__(16) float sb[kMats][kBK32][kBN + 4];
  count_call(offsets, E, stats);
  const Tile t = find_tile<kThreads32>(offsets, E, blockIdx.x,
                                       blockIdx.y == 0 ? stats : nullptr);
  if (t.expert < 0) return;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.y * kBN;
  const size_t wsize = (size_t)K * N;
  const float* wb[kMats];
  wb[0] = w0 + t.expert * wsize + n0;
  if (kGated) wb[kMats - 1] = w1 + t.expert * wsize + n0;
  float acc[kMats][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK32) {
    {
      const int r = tid >> 2, kk = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < t.rows)
        v = *reinterpret_cast<const float4*>(x + (size_t)(t.row0 + r) * K +
                                             k0 + kk);
      sa[kk][r] = v.x;
      sa[kk + 1][r] = v.y;
      sa[kk + 2][r] = v.z;
      sa[kk + 3][r] = v.w;
    }
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      const int r = tid >> 4, c = (tid & 15) * 4;
      *reinterpret_cast<float4*>(&sb[m][r][c]) =
          *reinterpret_cast<const float4*>(wb[m] + (size_t)(k0 + r) * N + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float4 b = *reinterpret_cast<const float4*>(&sb[m][kk][tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[m][i][j] = fmaf(av[i], bv[j], acc[m][i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= t.rows) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = kGated ? silu(acc[0][i][j]) * acc[kMats - 1][i][j] : acc[0][i][j];
    *reinterpret_cast<float4*>(out + (size_t)(t.row0 + r) * N + n0 + tx * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T>
cudaError_t launch_both(const void* x, const void* w_gate, const void* w_up,
                        const void* w_down, const int* offsets, void* h,
                        void* out, unsigned long long* stats, int E, int D,
                        int F, int m_tiles, cudaStream_t st) {
  const T* xs = static_cast<const T*>(x);
  const T* wg = static_cast<const T*>(w_gate);
  const T* wu = static_cast<const T*>(w_up);
  const T* wd = static_cast<const T*>(w_down);
  T* hs = static_cast<T*>(h);
  T* os = static_cast<T*>(out);
  const dim3 up(m_tiles, F / kBN), down(m_tiles, D / kBN);
  if constexpr (sizeof(T) == 2) {
    grouped_bf16<true><<<up, kThreads16, 0, st>>>(xs, wg, wu, offsets, hs,
                                                  stats, E, D, F);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    grouped_bf16<false><<<down, kThreads16, 0, st>>>(hs, wd, nullptr, offsets,
                                                     os, nullptr, E, F, D);
  } else {
    grouped_f32<true><<<up, kThreads32, 0, st>>>(xs, wg, wu, offsets, hs,
                                                 stats, E, D, F);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    grouped_f32<false><<<down, kThreads32, 0, st>>>(hs, wd, nullptr, offsets,
                                                    os, nullptr, E, F, D);
  }
  return cudaGetLastError();
}

}  // namespace

// x (R, D) rows in expert order; w_gate, w_up (E, D, F); w_down (E, F, D);
// offsets (E + 1) int32; h (R, F) scratch; out (R, D); stats: four int64
// counters or null; m_tiles: ceil(R / 64) + E. dtype 0 f32, 1 bf16.
extern "C" int moe_grouped_ffn(const void* x, const void* w_gate,
                               const void* w_up, const void* w_down,
                               const int* offsets, void* h, void* out,
                               void* stats, int R, int E, int D, int F,
                               int m_tiles, int dtype, void* stream) {
  if (R <= 0 || E <= 0 || E > kMaxExperts || D % kBN || F % kBN ||
      D % kBK || F % kBK || m_tiles != (R + kBM - 1) / kBM + E ||
      D / kBN > 65535 || F / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* counters = static_cast<unsigned long long*>(stats);
  if (dtype == 0)
    return (int)launch_both<float>(x, w_gate, w_up, w_down, offsets, h, out,
                                   counters, E, D, F, m_tiles, st);
  if (dtype == 1)
    return (int)launch_both<__nv_bfloat16>(x, w_gate, w_up, w_down, offsets,
                                           h, out, counters, E, D, F, m_tiles,
                                           st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* moe_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
