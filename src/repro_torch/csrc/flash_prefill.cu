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
// Both kernels stack the QPK heads of a run of positions as the 64 rows of
// one tile (row r is position q0 + r / QPK, head g*QPK + r % QPK), so every
// K/V tile staged in shared memory serves all QPK heads (the TPU kernel's
// (bq*QPK, D) GQA tile); where 64 is not a multiple of QPK the last rows are
// dead (zeroed in shared memory by the bf16 kernel, masked by the f32 one,
// never stored). Key tiles run from the window's start to the diagonal only.
// T need
// not be a multiple of any tile: positions past T are masked, not asserted
// away. The wrapper (kernels/flash_prefill/kernel.py, `plan`) chooses the
// tile and the grid and passes them in.
//
// bf16: tensor cores fed by TMA (`flash_prefill_wgmma`), for D in {64, 96,
// 128, 256}. A block is two warpgroups. The producer warpgroup gives up its
// registers (setmaxnreg) and one of its threads issues TMA loads: the query
// tile once, then each 64-key K and V tile into a two-stage ring in shared
// memory, 128-byte swizzled, with an mbarrier per stage for "full" and one
// for "empty". The consumer warpgroup runs S = Q K^T as wgmma (bf16 from
// shared memory, f32 accumulators in registers), masks only the tiles that
// cross the diagonal or the window's edge, does the online softmax in
// registers, splits P in registers into a bf16 high part and a bf16
// remainder and feeds both as wgmma's A operand for O += P V (V read
// MN-major from the same swizzled tile; with the remainder P keeps about 16
// bits instead of 8, at the cost of a second P V product), so the output
// accumulator never leaves registers. D 96 is loaded as two 64-wide boxes,
// the second half zero-filled by TMA, and P V runs 128 wide. D 256
// (RecurrentGemma's heads) keeps O in 128 registers a thread and feeds P
// to P V one 16-key slice at a time, so the consumer stays inside its 232
// registers; its 161 KB of shared memory leave one block per SM. Query
// tiles are issued longest first (those near the end of the prompt). At D
// <= 128 two blocks share an SM, so one block's softmax overlaps the
// other's products.
//
// f32: the first, CUDA-core kernel (`flash_prefill_kernel<float>`): both
// products in f32 from shared memory with 4x4 register micro-tiles. It keeps
// full f32 (no TF32), which the f32 oracle checks rely on.

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column groups of 4x4
constexpr int kRows = 64;      // query rows per block: (64 / QPK) positions
constexpr int kBK = 32;        // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBN = 64;        // keys per tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kSub = 64 * 128;  // one 64-row x 128-byte swizzled box (bytes)
constexpr int kThreads = 256;  // producer warpgroup + consumer warpgroup

template <int D>
struct Cfg {
  static constexpr int DP = (D + 63) / 64 * 64;  // D padded to 64-wide boxes
  static constexpr int NSUB = DP / 64;
  static constexpr int TILE = NSUB * kSub;  // bytes of a 64-row tile
  static constexpr size_t SMEM =
      1024 + (size_t)TILE * (1 + 2 * kStages) + 8 * (2 * kStages + 1);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment i of P (S columns 2i, 2i+1 of this thread's accumulator
// layout) as a bf16 pair `hi` and the bf16 pair of its remainder `lo`.
template <int N>
__device__ __forceinline__ void split_bf16(const float (&p)[N], int i,
                                           uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p[2 * i] - back.x, p[2 * i + 1] - back.y);
}

// Grid (KV * B, query tiles); 256 threads; `P` positions per 64-row tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, int Tn, int H, int KV,
                    int qpk, int P, int window, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;
  uint8_t* sk = sq + C::TILE;             // stage s at sk + s * TILE
  uint8_t* sv = sk + kStages * C::TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + kStages * C::TILE);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int g = blockIdx.x % KV, b = blockIdx.x / KV;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * P;  // longest tiles first
  const int q_last = min(q0 + P, Tn) - 1;
  int k_start = window > 0 ? max(0, q0 - window + 1) : 0;
  k_start -= k_start % kBN;
  const int n_tiles = (q_last - k_start) / kBN + 1;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    sm90::mbar_init(qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_expect_tx(qbar, C::NSUB * 128 * qpk * P);
      for (int c = 0; c < C::NSUB; ++c)
        sm90::tma_load_5d(sq + c * kSub, &tm_q, qbar, c * 64, 0, g, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(full + s, 2 * C::TILE);
        const int k0 = k_start + it * kBN;
        for (int c = 0; c < C::NSUB; ++c) {
          sm90::tma_load_4d(sk + s * C::TILE + c * kSub, &tm_k, full + s,
                            c * 64, g, k0, b);
          sm90::tma_load_4d(sv + s * C::TILE + c * kSub, &tm_v, full + s,
                            c * 64, g, k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows ----
    sm90::setmaxnreg_inc<232>();
    const int wt = tid - 128, warp = wt >> 5, lane = wt & 31;
    const int rows = qpk * P;  // live rows; TMA leaves the others untouched
    const int dead = (64 - rows) * 8;  // 16-byte chunks per box
    for (int i = wt; i < dead * C::NSUB; i += 128) {
      const int c = i / dead, r = rows + (i % dead) / 8, ch = i % 8;
      *reinterpret_cast<uint4*>(sq + c * kSub + r * 128 + ch * 16) =
          make_uint4(0, 0, 0, 0);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier_sync(1, 128);

    // this thread's two rows, r0 and r0 + 8, of the accumulator layout
    const int r0 = warp * 16 + lane / 4;
    const int qpos[2] = {q0 + r0 / qpk, q0 + (r0 + 8) / qpk};
    const int col0 = 2 * (lane % 4);
    const uint32_t qa = sm90::smem_addr(sq), ka = sm90::smem_addr(sk),
                   va = sm90::smem_addr(sv);

    float o[C::DP / 2];
#pragma unroll
    for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(qbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = k_start + it * kBN;
      sm90::mbar_wait(full + s, (it / kStages) & 1);

      // S = Q K^T: 64 x 64, K-major operands, 16 of D per instruction
      float sc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kSub + (kk % 4) * 32;
        sm90::wgmma_ss_m64n64k16(
            sc, sm90::desc_sw128(qa + off, 16, 1024),
            sm90::desc_sw128(ka + s * C::TILE + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);

      // mask only the tiles that cross the diagonal or the window's edge
      const bool masked = k0 + kBN - 1 > q0 ||
                          (window > 0 && k0 <= q_last - window);
      if (masked) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + col0 + (i % 2);
          const int qp = qpos[(i / 2) % 2];
          if (key > qp || (window > 0 && key <= qp - window))
            sc[i] = -INFINITY;
        }
      }

      // online softmax on this thread's two rows (4 lanes share a row)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float mb[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float mn = fmaxf(m[rr], mx[rr]);
        mb[rr] = mn == -INFINITY ? 0.f : mn * scale_log2;
        alpha[rr] = ex2(m[rr] * scale_log2 - mb[rr]);  // 0 while m = -inf
        m[rr] = mn;
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int rr = (i / 2) % 2;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -mb[rr]));
        rs[rr] += sc[i];
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + rs[rr];
#pragma unroll
      for (int i = 0; i < C::DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // P to bf16 A fragments (k-slice kk holds S columns 16kk .. 16kk+15),
      // as a high part and the bf16 remainder, so that P V keeps about 16
      // bits of P: P rounded once to bf16 would err by up to 2^-9 of
      // sum |p v|, more than the output's own rounding
      if constexpr (C::DP <= 128) {
        uint32_t ph[kBN / 16 * 4], pl[kBN / 16 * 4];
#pragma unroll
        for (int i = 0; i < kBN / 16 * 4; ++i) split_bf16(sc, i, ph[i], pl[i]);

        // O += P V: V is MN-major (D contiguous), 16 keys per instruction
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const uint64_t db =
              sm90::desc_sw128(va + s * C::TILE + kk * 16 * 128, kSub, 1024);
          if constexpr (C::DP == 128) {
            sm90::wgmma_rs_m64n128k16(o, ph + 4 * kk, db);
            sm90::wgmma_rs_m64n128k16(o, pl + 4 * kk, db);
          } else {
            sm90::wgmma_rs_m64n64k16(o, ph + 4 * kk, db);
            sm90::wgmma_rs_m64n64k16(o, pl + 4 * kk, db);
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(o);
        sm90::fence_regs(ph);
        sm90::fence_regs(pl);
      } else {
        // D 256: O takes 128 registers a thread, so P goes to the tensor
        // cores one 16-key slice at a time (8 registers, not 32), each
        // slice's products finished before the next is split. O's columns
        // 0-127 and 128-255 are two n128 products, the second reading V's
        // boxes 2 and 3.
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_bf16(sc, 4 * kk + i, ph[i], pl[i]);
          const uint32_t vk = va + s * C::TILE + kk * 16 * 128;
          const uint64_t db0 = sm90::desc_sw128(vk, kSub, 1024);
          const uint64_t db1 = sm90::desc_sw128(vk + 2 * kSub, kSub, 1024);
          sm90::wgmma_fence();
          sm90::wgmma_rs_m64n128k16(o, ph, db0);
          sm90::wgmma_rs_m64n128k16(o + 64, ph, db1);
          sm90::wgmma_rs_m64n128k16(o, pl, db0);
          sm90::wgmma_rs_m64n128k16(o + 64, pl, db1);
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(o);
          sm90::fence_regs(ph);
          sm90::fence_regs(pl);
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + s);
    }

    // epilogue: rows sum over their 4 lanes; bf16 pairs straight to global
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      const int r = r0 + 8 * rr;
      if (r >= rows || qpos[rr] >= Tn) continue;
      const float inv = 1.f / fmaxf(l[rr], 1e-30f);
      __nv_bfloat16* dst =
          out + (((size_t)b * Tn + qpos[rr]) * H + (size_t)g * qpk + r % qpk) *
                    D;
#pragma unroll
      for (int j = 0; j < C::DP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Tn, int H, int KV, int window, float scale,
                   int P, int q_tiles, cudaStream_t stream) {
  const int qpk = H / KV;
  const cuuint64_t e = 2;  // bytes per element
  // q as (D, QPK, KV, T, B); one box is P positions x QPK heads x 64 of D
  const cuuint64_t qdim[5] = {(cuuint64_t)D, (cuuint64_t)qpk,
                              (cuuint64_t)KV, (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t qstr[4] = {D * e, (cuuint64_t)qpk * D * e,
                              (cuuint64_t)H * D * e,
                              (cuuint64_t)Tn * H * D * e};
  const cuuint32_t qbox[5] = {64, (cuuint32_t)qpk, 1, (cuuint32_t)P, 1};
  // k, v as (D, KV, T, B); one box is 64 keys x 64 of D
  const cuuint64_t kdim[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)Tn,
                              (cuuint64_t)B};
  const cuuint64_t kstr[3] = {D * e, (cuuint64_t)KV * D * e,
                              (cuuint64_t)Tn * KV * D * e};
  const cuuint32_t kbox[4] = {64, 1, kBN, 1};
  CUtensorMap mq, mk, mv;
  if (sm90::encode_tiled() == nullptr) return cudaErrorNotSupported;
  if (!sm90::encode_bf16(&mq, 5, q, qdim, qstr, qbox) ||
      !sm90::encode_bf16(&mk, 4, k, kdim, kstr, kbox) ||
      !sm90::encode_bf16(&mv, 4, v, kdim, kstr, kbox))
    return cudaErrorInvalidValue;
  const size_t smem = Cfg<D>::SMEM;
  auto kern = flash_prefill_wgmma<D>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  kern<<<dim3(KV * B, q_tiles), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Tn, H, KV, qpk, P, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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

// dtype codes: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, D in
// {64, 96, 128, 256}). `positions` query positions per 64-row tile and `q_tiles`
// tiles per (batch, KV head) come from the wrapper's plan. Returns a
// cudaError_t.
extern "C" int flash_prefill_forward(const void* q, const void* k,
                                     const void* v, void* out, int B, int Tn,
                                     int H, int KV, int D, int window,
                                     float scale, int dtype, int positions,
                                     int q_tiles, void* stream) {
  if (B <= 0 || Tn <= 0 || KV <= 0 || H % KV != 0 || H / KV > kRows ||
      D <= 0 || D > 256 || window < 0 || positions != kRows / (H / KV) ||
      q_tiles != (Tn + positions - 1) / positions)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, B, Tn, H, KV, D, window, scale,
                              st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return (int)wg::launch<64>(q, k, v, out, B, Tn, H, KV, window, scale,
                                 positions, q_tiles, st);
    case 96:
      return (int)wg::launch<96>(q, k, v, out, B, Tn, H, KV, window, scale,
                                 positions, q_tiles, st);
    case 128:
      return (int)wg::launch<128>(q, k, v, out, B, Tn, H, KV, window, scale,
                                  positions, q_tiles, st);
    case 256:
      return (int)wg::launch<256>(q, k, v, out, B, Tn, H, KV, window, scale,
                                  positions, q_tiles, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
