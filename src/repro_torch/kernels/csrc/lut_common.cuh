// Device pieces shared by the LUT kernels (fused_decode.cu, lut_amm_v2.cu,
// lut_amm_v1.cu, encode.cu).
//
// The fused and v2 kernels compute, for x (N, C*V), centroids P (C, K, V)
// fp32, int8 table T (C, K, M) and scale s (1|C, 1, 1|M):
//
//   code[n, c] = argmin_k  ||a||^2 - 2 a.P[c,k] + ||P[c,k]||^2   (fp32, lowest k wins)
//   y[n, m]    = sum_c T[c, code[n,c], m]  (int32, then one fp32 rescale fused with the
//                                         bias add: m-shared/scalar)
//              | sum_c T[c, code[n,c], m] * s[c, m|0]           (fp32: per-codebook/column)
//   out        = act(y + bias), written once in x's dtype.
//
// v1 computes the same codes and, per output element, the fp32 sum of
// fl(T * s[c|0, m|0]) in codebook order within chunks of block_c codebooks,
// the chunks added in order; no bias or activation (lut_amm_v1.cu). The
// encode kernel computes the codes alone (encode.cu).
//
// They replace the TPU kernels src/repro/kernels/fused_decode.py::fused_decode_pallas,
// src/repro/kernels/lut_amm.py::lut_amm_pallas (v2) and lut_amm_pallas_v1,
// and src/repro/kernels/dist_argmin.py::encode_pallas.
//
// What bounds them on this card. The bytes are the int8 table, read once per
// N tile (2-6 MiB at qwen3_1p7b's sites: 0.6-1.9 us at 3.35 TB/s). Before the
// lookup can start, every row's codes must exist, and they depend on all C
// codebooks' centroids; a block that stages all of them from L2 and encodes
// its rows over all of them spends ~20 us per 64 codebooks in a serial chain,
// which was the whole kernel's time at decode.
//
// The design (lut_cluster_body below), shared by the three LUT-AMM kernels:
//  1. A thread-block cluster of S blocks (along the M axis) owns one N tile
//     of `rows` rows. Rank r stages only its share of the codebooks,
//     [r*C/S, (r+1)*C/S), with their norms, and encodes the N tile's rows for
//     that share: S-fold less staging and encode per block.
//  2. The codes go through distributed shared memory: each rank writes its
//     share into its own code array (rows x C codes, one byte each up to
//     K = 256 and two above, kMaxK = 512) and pushes it into every
//     peer's array with st.async, whose bytes the peer's mbarrier counts; a
//     rank looks up once its mbarrier has counted every peer's share. Codes
//     never reach device memory, and no cluster-wide memory fence is needed
//     (cluster.sync() compiles to a GPU-scope fence and an L1 invalidate:
//     ~0.6 us here). A relaxed cluster barrier orders the mbarriers' setup
//     before the pushes, and one before exit keeps a block alive while a
//     peer may still write into it. The trade: S - 1 small pushes and two
//     cluster barriers per block.
//  3. The encode runs parallel over K (encode_tile; the encode kernel runs it
//     too, one block per codebook chunk and N tile): a chunk's centroids and
//     the N tile's sub-vectors are staged by cp.async (every copy in flight
//     at once), then a thread holds R rows x 4 centroids in registers, 4
//     lanes split K, and the lanes' minima merge by shuffles, lowest k on a
//     tie. Each distance is one fixed fp32 sequence (a_nrm and cross as FMA
//     chains over v ascending, any V up to kMaxV = 64), so every kernel and
//     launch finds the same codes.
//  4. A centroid norm's sum starts at word (c*K + k) % V of its row, a
//     function of the global row: every rank, chunk and kernel computes the
//     same fp32 norm, so fused == v2 bytewise whatever cluster and chunk.
//  5. Lookup. The block's table tile (C*K rows x 4Q columns) can be staged
//     into shared memory, issued at the kernel's start so the table's bytes
//     arrive while the codes are computed. N tiles of 16 rows and more
//     (prefill) stage it by TMA, one box of stage_c codebooks per ring stage
//     (a codebook of more than 256 rows: two equal boxes)
//     on an mbarrier: the lanes of a warp read along one table row
//     (conflict-free), warps and lane groups run along rows, each thread
//     holds whole sums for its rows, and the table is read once per N tile.
//     At decode (8-row tiles) the whole tile is copied by 16-byte cp.async
//     beside the centroids where it fits RING_BYTES, else gathered straight
//     from global memory; thread (q, g) owns 4 adjacent columns and the
//     codebooks g, g + G, ..., and the G partials join by warp shuffles and
//     then through shared memory. v1 must add every codebook of an element
//     in order, so it never splits codebooks: at a prefill chunk it takes
//     the same row-split lookup, at decode one thread per (row, column) with
//     a run of codebooks' loads issued ahead of the ordered adds.
//  6. The epilogue is unchanged: m-shared/scalar fmaf((float)acc, s, bias),
//     per-codebook the fp32 sum + bias; act, cast, one store per element; no
//     atomics. v1 stores its total, cast to x's dtype.
#pragma once

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lutnn {

constexpr int kThreads = 256;  // threads per block
constexpr int kBlockN = 8;     // rows per register tile of the direct lookup
constexpr int kMaxV = 64;      // longest sub-vector the kernels take
constexpr int kMaxK = 512;     // most centroids per codebook the kernels take
constexpr int kByteK = 256;    // codes are held on chip in one byte up to this K, else two
constexpr int kNormPiece = 32; // words of a centroid row a norm holds in registers at once
// reduction buffer: G groups x kBlockN rows x 4Q columns x 4 bytes, G * Q = kThreads
constexpr int kRedBytes = kThreads * kBlockN * 4 * 4;

enum Act { kActNone = 0, kActRelu = 1, kActSilu = 2, kActGelu = 3, kActRelu2 = 4 };

// Phase timestamps of the cluster kernels, compiled in only with
// -DLUTNN_PHASE_TRACE (kernels/phase_trace.py): thread 0 of each block
// reads the SM's cycle counter at kPhases points after a block barrier into
// shared memory; the last phase writes the block's row of lutnn_phase_log:
// its start on %globaltimer (ns), then the cycles from its start to each
// later phase. No device-memory traffic between phases.
constexpr int kPhases = 10;
#ifdef LUTNN_PHASE_TRACE
__device__ long long lutnn_phase_log[1 << 16];
__shared__ long long lutnn_cycles[kPhases];
#define LUTNN_STAMP(i)                                                                  \
  do {                                                                                  \
    __syncthreads();                                                                    \
    if (threadIdx.x == 0) {                                                             \
      lutnn_cycles[i] = clock64();                                                      \
      long long* row =                                                                  \
          lutnn_phase_log + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kPhases;    \
      if ((i) == 0) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(row[0]));          \
      if ((i) == kPhases - 1) {                                                         \
        for (int j = 1; j < kPhases; ++j) row[j] = lutnn_cycles[j] - lutnn_cycles[0];   \
      }                                                                                 \
    }                                                                                   \
  } while (0)
#else
#define LUTNN_STAMP(i) \
  do {                 \
  } while (0)
#endif

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_out(float* p, float y) { *p = y; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float y) { *p = __float2bfloat16_rn(y); }

// Epilogue activation on the fp32 value. gelu is the tanh approximation (the
// reference's jax.nn.gelu default).
__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case kActRelu:
      return fmaxf(y, 0.f);
    case kActSilu:
      return y / (1.f + expf(-y));
    case kActGelu: {
      const float inner = 0.7978845608028654f * (y + 0.044715f * y * y * y);
      return 0.5f * y * (1.f + tanhf(inner));
    }
    case kActRelu2: {
      const float r = fmaxf(y, 0.f);
      return __fmul_rn(r, r);
    }
    default:
      return y;
  }
}

// Staged centroid and sub-vector rows start 16-byte aligned, so that one
// 16-byte cp.async moves 4 words: the issue of the staging copies, not
// their bytes, sets the staging time (PERF.md). The extra 4 words keep the
// lanes of a warp that read one word of 8 rows on 8 bank groups.
__host__ __device__ __forceinline__ int row_stride16(int V) { return ((V + 3) & ~3) + 4; }

// The norms of `rows` staged centroid rows of codebooks from c_lo on: one
// FMA chain over words w0, w0 + 1, ..., V - 1, 0, ..., w0 - 1 with
// w0 = (c_lo*K + row) % V, the row's global index: the same fp32 norm in
// every block, chunk and kernel. The chain runs in pieces of kNormPiece
// words, each loaded into registers first (independent loads), the sum
// carried from piece to piece.
__device__ __forceinline__ void centroid_norms(int c_lo, int rows, int K, int V,
                                               const float* p_s, float* pn_s,
                                               int rs) {
  const int ps = K * rs + 4;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const float* p = p_s + (size_t)(i / K) * ps + (i % K) * rs;
    const int w0 = (c_lo * K + i) % V;
    float nrm = 0.f;
    for (int base = 0; base < V; base += kNormPiece) {  // word j of the chain: w0 + j mod V
      float r[kNormPiece];
#pragma unroll
      for (int j = 0; j < kNormPiece; ++j) {
        const int w = w0 + base + j;
        r[j] = base + j < V ? p[w < V ? w : w - V] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kNormPiece; ++j) {
        if (base + j < V) nrm = fmaf(r[j], r[j], nrm);
      }
    }
    pn_s[(i / K) * (K + 1) + i % K] = nrm;
  }
}

// Stage the N tile's sub-vectors of codebooks [c0, c0 + cc) into shared
// memory: x_s[(cl * rows + n) * rs + v], rows beyond n_rows left
// unwritten (their distances are computed and never used). 4 elements per
// load where rows allow it, 16 loads in flight per thread: the copy waits on
// memory once, not once per element.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, int n0, int n_rows, int rows,
                                        int D, int c0, int cc, int V, float* x_s, int rs) {
  using Vec = typename std::conditional<std::is_same<T, float>::value, float4, uint2>::type;
  constexpr int kBatch = 16;
  const int per_row = cc * V;
  const T* src = x + (size_t)n0 * D + (size_t)c0 * V;
  const bool vec = (V % 4) == 0 && (D % 4) == 0 && (c0 * V) % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) % sizeof(Vec)) == 0;
  if (vec) {
    const int per_row4 = per_row / 4;
    const int total4 = n_rows * per_row4;
    for (int base = threadIdx.x; base < total4; base += kBatch * blockDim.x) {
      Vec r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total4) {
          r[u] = *reinterpret_cast<const Vec*>(src + (size_t)(i / per_row4) * D +
                                               (i % per_row4) * 4);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total4) {
          const int rem = (i % per_row4) * 4;
          float* dst = x_s + ((rem / V) * rows + i / per_row4) * rs + rem % V;
          const T* e = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
          for (int j = 0; j < 4; ++j) dst[j] = load_x(e + j);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * per_row; i += blockDim.x) {
      const int rem = i % per_row;
      x_s[((rem / V) * rows + i / per_row) * rs + rem % V] =
          load_x(src + (size_t)(i / per_row) * D + rem);
    }
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Stage one chunk of a rank's share, codebooks [c0, c0 + cc): their
// centroids (padded rows), their norms, and the N tile's sub-vectors
// (x_s[(cl * rows + n) * row_stride16(V) + v]). Every copy is issued
// before any is waited on (cp.async), so the chunk waits on memory once;
// `issued()` runs while they are in flight and
// returns true if it committed a cp.async group of its own, which this
// chunk's wait leaves in flight.
template <typename T, typename Issued>
__device__ __forceinline__ void stage_share(const T* __restrict__ x,
                                            const float* __restrict__ centroids, int n0,
                                            int n_rows, int rows, int D, int c0, int cc, int K,
                                            int V, float* p_s, float* pn_s, float* x_s,
                                            Issued&& issued) {
  const int rs = row_stride16(V);
  const int ps = K * rs + 4;
  const float* cent = centroids + (size_t)c0 * K * V;
  const T* xs = x + (size_t)n0 * D + (size_t)c0 * V;
  const bool fp32_x = std::is_same<T, float>::value;
  // 16-byte copies where the rows allow them, else 4-byte ones
  const int wc = V % 4 == 0 && reinterpret_cast<uintptr_t>(cent) % 16 == 0 ? 4 : 1;
  for (int i = threadIdx.x; i < cc * K * V / wc; i += blockDim.x) {
    const int row = i / (V / wc);
    float* dst = p_s + (row / K) * ps + (row % K) * rs + wc * (i % (V / wc));
    if (wc == 4) {
      cp_async16(dst, cent + 4 * i);
    } else {
      cp_async4(dst, cent + i);
    }
  }
  if (fp32_x) {
    const float* xf = reinterpret_cast<const float*>(xs);
    const int wx = V % 4 == 0 && D % 4 == 0 && reinterpret_cast<uintptr_t>(xf) % 16 == 0 ? 4 : 1;
    const int per_row = cc * V / wx;  // one row's share of x is contiguous
    for (int i = threadIdx.x; i < n_rows * per_row; i += blockDim.x) {
      const int n = i / per_row;
      const int e = wx * (i % per_row);  // the element within the row's share
      float* dst = x_s + ((e / V) * rows + n) * rs + e % V;
      if (wx == 4) {
        cp_async16(dst, xf + (size_t)n * D + e);
      } else {
        cp_async4(dst, xf + (size_t)n * D + e);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  LUTNN_STAMP(2);
  const bool later = issued();  // the caller's work that overlaps the copies
  if (!fp32_x) stage_x(x, n0, n_rows, rows, D, c0, cc, V, x_s, rs);
  LUTNN_STAMP(3);
  if (later) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  LUTNN_STAMP(4);
  centroid_norms(c0, cc * K, K, V, p_s, pn_s, rs);
  __syncthreads();
}

// Parallel encode (every kernel) from staged sub-vectors and centroids. A
// thread holds R rows (rg, rg + n_rg, ...: the lanes of neighbouring row
// groups read neighbouring rows, on distinct banks at the 16-byte aligned
// row stride) x 4 centroids of one codebook in registers (the v loop
// outermost: R + 4 shared loads feed 4R FMAs) and takes k = kg, kg + 4, ...
// (its first k always, then a strict '<'); the 4 lanes kg of a row group
// merge their minima by shuffles, the lower k winning a tie. Every distance
// is the reference's fp32 sequence (a_nrm and cross as FMA chains over v
// ascending, then the expansion ||a||^2 - 2 a.p + ||p||^2), so the codes are
// the same in every kernel and launch.
// Writes codes_s[c * rows + n] (codebook-major) for c in [c0, c0 + cc):
// CodeT is uint8_t up to K = 256 and uint16_t above (kMaxK).
template <int R, typename CodeT>
__device__ __forceinline__ void encode_tile(int n_rows, int rows, int c0, int cc, int K, int V,
                                            const float* p_s, const float* pn_s,
                                            const float* x_s, CodeT* codes_s) {
  constexpr int KG = 4;  // lanes across k per row group
  constexpr int KT = 4;  // centroids per lane per pass over v
  const int rs = row_stride16(V);
  const int ps = K * rs + 4;
  const int n_rg = (n_rows + R - 1) / R;
  const int total = cc * n_rg * KG;
  // every lane of a warp runs each pass (the shuffles need them all); the KG
  // lanes of a row group lie wholly inside or outside [0, total)
  for (int base = 0; base < total; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int kg = t % KG;
    const int rg = (t / KG) % n_rg;
    const int cl = (t / KG) / n_rg;
    float best[R];
    int best_k[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      best[i] = INFINITY;
      best_k[i] = 0x7fffffff;
    }
    if (t < total) {
      const float* xa = x_s + (size_t)(cl * rows + rg) * rs;
      const float* p = p_s + (size_t)cl * ps;
      const float* pn = pn_s + cl * (K + 1);
      for (int kb = 0; kb < K; kb += KG * KT) {
        const float* pk[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j) pk[j] = p + min(kb + kg + KG * j, K - 1) * rs;
        float cross[R][KT];
        float a_nrm[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a_nrm[i] = 0.f;
#pragma unroll
          for (int j = 0; j < KT; ++j) cross[i][j] = 0.f;
        }
#pragma unroll 4
        for (int v = 0; v < V; ++v) {
          float av[R];
          float pv[KT];
#pragma unroll
          for (int i = 0; i < R; ++i) av[i] = xa[i * n_rg * rs + v];
#pragma unroll
          for (int j = 0; j < KT; ++j) pv[j] = pk[j][v];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            a_nrm[i] = fmaf(av[i], av[i], a_nrm[i]);
#pragma unroll
            for (int j = 0; j < KT; ++j) cross[i][j] = fmaf(av[i], pv[j], cross[i][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int k = kb + kg + KG * j;
          if (k < K) {
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const float d = __fadd_rn(__fsub_rn(a_nrm[i], __fmul_rn(2.f, cross[i][j])), pn[k]);
              if (best_k[i] == 0x7fffffff || d < best[i]) {
                best[i] = d;
                best_k[i] = k;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = KG / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float od = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k[i], off);
        if (od < best[i] || (od == best[i] && ok < best_k[i])) {
          best[i] = od;
          best_k[i] = ok;
        }
      }
    }
    if (t < total && kg == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = rg + i * n_rg;
        if (n < n_rows) codes_s[(size_t)(c0 + cl) * rows + n] = (CodeT)best_k[i];
      }
    }
  }
}

// int8 table entries as fp32 for v1's dequantize, exactly and without I2F
// (a quarter-rate instruction on this card): the byte's bits b ^ 0x80 = b + 128
// placed in the mantissa of 2^23 give the float 2^23 + 128 + b, from which one
// exact subtraction leaves b. `u8` is the entry's raw byte; `w` four entries
// of one 32-bit word, already XORed with 0x80808080, J selects one.
__device__ __forceinline__ float s8_to_f32(uint32_t u8) {
  return __fsub_rn(__int_as_float(0x4B000000u | (u8 ^ 0x80u)), 8388736.f);
}
template <int J>
__device__ __forceinline__ float s8x4_to_f32(uint32_t w) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | J)), 8388736.f);
}

// Accumulate table rows of codebooks [c_lo, c_lo + cc) into this thread's 4
// columns for the rows of one NR-row register tile. `tbl` points at codebook c_lo's
// first table row, `pitch` bytes apart, `col` this thread's first column in
// a row; m is that column's index in [0, M). Codes: codes[c * ldn + n].
// SHARED: raw int32 sums (the m-shared or scalar scale factors out);
// otherwise fp32 sums of T * s[c, m|0]. Thread group g takes the codebooks
// g, g + G, ... Rows past n_rows repeat the last valid row's code (their
// sums are never stored), so the loop has no branch per row.
template <bool SHARED, int NR, typename AccT, typename CodeT>
__device__ __forceinline__ void lookup_rows(AccT (&acc)[NR][4], const int8_t* tbl,
                                            size_t pitch, int col,
                                            const float* __restrict__ scale, int K, int M,
                                            int scale_m, int c_lo, int cc,
                                            const CodeT* codes, int ldn, int n_rows, int m,
                                            int g, int G, bool vec4) {
  if (m >= M) return;
  const bool full4 = vec4 && (m + 3 < M);
  for (int cl = g; cl < cc; cl += G) {
    const int c = c_lo + cl;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (!SHARED) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mm = min(m + j, M - 1);
        s[j] = scale[(size_t)c * scale_m + (scale_m == 1 ? 0 : mm)];
      }
    }
    const int8_t* base = tbl + (size_t)cl * K * pitch + col;
    int t[NR][4];
    if (full4) {
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const char4 t4 = *reinterpret_cast<const char4*>(
            base + (size_t)codes[(size_t)c * ldn + min(n, n_rows - 1)] * pitch);
        t[n][0] = t4.x;
        t[n][1] = t4.y;
        t[n][2] = t4.z;
        t[n][3] = t4.w;
      }
    } else {
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const int8_t* row = base + (size_t)codes[(size_t)c * ldn + min(n, n_rows - 1)] * pitch;
#pragma unroll
        for (int j = 0; j < 4; ++j) t[n][j] = (m + j < M) ? (int)row[j] : 0;
      }
    }
#pragma unroll
    for (int n = 0; n < NR; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (SHARED) {
          acc[n][j] += t[n][j];
        } else {
          acc[n][j] += (float)t[n][j] * s[j];
        }
      }
    }
  }
}

// The epilogue of one output element. m-shared / scalar: the reference's
// (float)acc32 * s + bias, which XLA contracts into one fused multiply-add
// (one rounding); without a bias, the single rounding of the product.
// Per-codebook: the fp32 sum + bias. Then the activation.
template <bool SHARED, typename AccT>
__device__ __forceinline__ float finish(AccT sum, float s, float b, bool has_bias, int act) {
  float y;
  if (SHARED) {
    y = has_bias ? __fmaf_rn((float)sum, s, b) : __fmul_rn((float)sum, s);
  } else {
    y = has_bias ? __fadd_rn((float)sum, b) : (float)sum;
  }
  return apply_act(y, act);
}

// Join the G codebook-group partials of one (NR x 4Q) tile, then the
// epilogue: one dequantize (SHARED), bias, activation, cast, and the single
// store of each output element. The groups of a warp that share columns
// (lanes q, q + Q, ...) join first by shuffles, then the warps' partials
// through shared memory: red_s must hold kRedBytes and is free again when
// this returns. The order of the sums is fixed by the launch. s_s / b_s: the
// scale and bias of the tile's columns, staged in shared memory. Q is a
// power of two (qs = log2 Q): the index math shifts instead of dividing.
template <bool SHARED, int NR, typename AccT, typename T>
__device__ __forceinline__ void reduce_store(AccT (&acc)[NR][4], void* red_s, int Q, int qs,
                                             int q, int g, int G, int n0, int n_rows, int m0,
                                             int M, const float* s_s, const float* b_s,
                                             bool has_bias, int act, T* __restrict__ out) {
  const int TW = 4 * Q;
  AccT* red = reinterpret_cast<AccT*>(red_s);
  const int gpws = max(5 - qs, 0);  // log2 of the groups per warp
  for (int off = Q; off < 32; off <<= 1) {
#pragma unroll
    for (int n = 0; n < NR; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] += __shfl_xor_sync(0xffffffffu, acc[n][j], off);
    }
  }
  if (Q >= 32 || (threadIdx.x & 31) < Q) {
#pragma unroll
    for (int n = 0; n < NR; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[((g >> gpws) * NR + n) * TW + 4 * q + j] = acc[n][j];
    }
  }
  __syncthreads();
  const int G2 = G >> gpws;
  for (int idx = threadIdx.x; idx < n_rows * TW; idx += blockDim.x) {
    const int n = idx >> (qs + 2);
    const int col = idx & (TW - 1);
    const int mm = m0 + col;
    if (mm < M) {
      AccT sum = 0;
      for (int gg = 0; gg < G2; ++gg) sum += red[(gg * NR + n) * TW + col];
      store_out(out + (size_t)(n0 + n) * M + mm,
                finish<SHARED>(sum, s_s[col], b_s[col], has_bias, act));
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The cluster pipeline of the fused, v2 and v1 kernels
// ---------------------------------------------------------------------------

// H100: dynamic shared memory one block may use (less the trace's stamps)
#ifdef LUTNN_PHASE_TRACE
constexpr int kMaxSmem = 232448 - 1024;
#else
constexpr int kMaxSmem = 232448;
#endif
constexpr int kStagedRows = 8;    // rows one thread accumulates in the row-split lookup, at most

// One launch's arguments; the shared-memory offsets come from the wrapper's
// geometry (kernels/lut_amm.py::cluster_geometry), which alone defines the
// layout: [ codes C x rows | epilogue scale and bias of the block's columns |
// centroid region | table ring | ring mbarriers ].
// The centroid region holds a chunk's centroids, their norms and the N
// tile's sub-vectors, and later the reduction buffer.
struct LutArgs {
  CUtensorMap tmap;     // the int8 table as a (C*K, M) tensor, one ring stage per box
  const void* x;
  const float* centroids;
  const int8_t* table_q;
  const float* scale;
  const float* bias;
  void* out;
  int N, C, K, V, M, scale_m, act;
  int S;                // cluster size (blocks along M sharing one N tile)
  int rows;             // rows of x per N tile (a multiple of 8)
  int Q;                // column quads per M tile (4Q columns)
  int tiles_per_block;  // M tiles one block sweeps (1 when staged)
  int chunk_c;          // codebooks of a rank's share staged at once
  int staged;           // 1: the table tile staged (one M tile per block): by
                        // TMA over N tiles of more than 8 rows, else by cp.async
  int stage_c;          // codebooks per table stage (one TMA box)
  int n_stages;         // table stages in the TMA ring (0 at decode)
  int epi_off, cent_off, ring_off, bar_off;
  int block_c;          // v1: codebooks per chunk of the fp32 sum (0 for fused and v2)
  int vec4;             // 4-byte table loads allowed (direct lookup)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Cluster barrier arrive, relaxed: the barriers here order no memory (the
// codes travel on the exchange's mbarrier), and a release arrive compiles
// to a GPU-scope fence.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of shared-memory location p in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// 8 bytes into a peer's shared memory; the peer's mbarrier `bar` counts them.
__device__ __forceinline__ void push_u64(uint32_t dst, uint64_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(
                   dst),
               "l"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Rows of one TMA box at most (a box dimension is at most 256 elements).
constexpr int kMaxBoxRows = 256;

// Rows of each TMA box of a ring stage of stage_rows rows: the fewest equal
// boxes of at most kMaxBoxRows rows (one box up to 256 rows; a codebook of
// 257-512 rows, two halves). The wrapper stages by TMA only where they split
// evenly and each box starts 128-byte aligned (lut_amm.py::ring_boxes).
__host__ __device__ __forceinline__ int box_rows(int stage_rows) {
  return stage_rows / ((stage_rows + kMaxBoxRows - 1) / kMaxBoxRows);
}

// Thread 0 fills ring slot i % n_stages with table stage i: stage_c*K table
// rows x 4Q columns from (row c0*K, column m0), as equal TMA boxes of
// box_rows rows; rows past C*K and columns past M arrive as zeros. The
// slot's mbarrier expects the whole stage.
__device__ __forceinline__ void issue_stage(const LutArgs& a, int i, int m0, uint8_t* ring,
                                            uint64_t* bars) {
  const int stage_rows = a.stage_c * a.K;
  const int box = stage_rows * 4 * a.Q;
  const int br = box_rows(stage_rows);
  const int slot = i % a.n_stages;
  uint64_t* bar = bars + slot;
  // the consumers' generic reads of this slot happen before the async writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, (uint32_t)box);
  for (int r0 = 0; r0 < stage_rows; r0 += br) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_u32(ring + (size_t)slot * box + (size_t)r0 * 4 * a.Q)),
        "l"(reinterpret_cast<uint64_t>(&a.tmap)), "r"(m0), "r"(i * stage_rows + r0),
        "r"(smem_u32(bar))
        : "memory");
  }
}

// Wait for stage i; after the block is done with it (ring_release), refill
// its slot with stage i + n_stages.
__device__ __forceinline__ const uint8_t* ring_acquire(const LutArgs& a, int i, uint8_t* ring,
                                                       uint64_t* bars) {
  const int slot = i % a.n_stages;
  mbar_wait(bars + slot, (uint32_t)((i / a.n_stages) & 1));
  return ring + (size_t)slot * a.stage_c * a.K * 4 * a.Q;
}

__device__ __forceinline__ void ring_release(const LutArgs& a, int i, int n_chunks, int m0,
                                             uint8_t* ring, uint64_t* bars) {
  __syncthreads();  // every thread is done with this slot
  if (threadIdx.x == 0 && i + a.n_stages < n_chunks) issue_stage(a, i + a.n_stages, m0, ring, bars);
}

// Row-split lookup of one staged M tile (N tiles of more than 8 rows): lane
// ql of a lane group reads 4 columns of one staged table row (the group
// reads the row once, conflict-free); row group rg takes rows rg, rg + RG,
// ... Every stage serves every row, and each thread holds its elements'
// whole sums: the epilogue follows without a reduction. Rows past n_rows
// repeat the last valid row's code and are not stored. V1: each element's
// fp32 sum of fl(t * s) in codebook order, joined into its total after every
// block_c codebooks (a chunk may span ring stages), with explicit _rn
// intrinsics (no FMA contraction); the total is stored without bias or
// activation. SHARED then means a (1, ..) scale: the column's, from s_s.
// NR rows per thread (at most kStagedRows): the fewest that cover the N
// tile, so that no thread repeats a row.
template <bool SHARED, typename T, bool V1, int NR, typename CodeT>
__device__ __forceinline__ void staged_lookup(const LutArgs& a, int n0, int n_rows, int m0,
                                              const CodeT* codes_s, const float* s_s,
                                              const float* b_s, uint8_t* ring, uint64_t* bars) {
  using AccT = typename std::conditional<SHARED && !V1, int, float>::type;
  const int TW = 4 * a.Q;
  const int K = a.K;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / a.Q;
  const int ql = lane % a.Q;
  const int rg = (threadIdx.x >> 5) * groups + lane / a.Q;
  const int RG = (kThreads / 32) * groups;
  const int m = m0 + 4 * ql;
  const int n_chunks = (a.C + a.stage_c - 1) / a.stage_c;
  float sv[4], bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sv[j] = s_s[4 * ql + j];
    bv[j] = b_s[4 * ql + j];
  }
  int rowc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) rowc[r] = min(rg + r * RG, n_rows - 1);
  AccT acc[NR][4];
  float total[NR][4];  // V1 only
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = total[i][j] = 0;
  }
  int left = a.block_c;  // V1: codebooks until the chunk joins its total
  for (int i = 0; i < n_chunks; ++i) {
    const uint8_t* st = ring_acquire(a, i, ring, bars) + 4 * ql;
    const int c0 = i * a.stage_c;
    const int cs = min(a.stage_c, a.C - c0);
    for (int cl = 0; cl < cs; ++cl) {
      const int c = c0 + cl;
      float s[4] = {sv[0], sv[1], sv[2], sv[3]};
      if (!SHARED) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] = a.scale[(size_t)c * a.scale_m + (a.scale_m == 1 ? 0 : min(m + j, a.M - 1))];
        }
      }
      const CodeT* code_row = codes_s + (size_t)c * a.rows;
      const uint8_t* tile = st + (size_t)cl * K * TW;
      int code[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) code[r] = code_row[rowc[r]];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if constexpr (V1) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(tile + code[r] * TW) ^ 0x80808080u;
          acc[r][0] = __fadd_rn(acc[r][0], __fmul_rn(s8x4_to_f32<0>(w), s[0]));
          acc[r][1] = __fadd_rn(acc[r][1], __fmul_rn(s8x4_to_f32<1>(w), s[1]));
          acc[r][2] = __fadd_rn(acc[r][2], __fmul_rn(s8x4_to_f32<2>(w), s[2]));
          acc[r][3] = __fadd_rn(acc[r][3], __fmul_rn(s8x4_to_f32<3>(w), s[3]));
        } else {
          const char4 t4 = *reinterpret_cast<const char4*>(tile + code[r] * TW);
          const int t[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (SHARED) {
              acc[r][j] += t[j];
            } else {
              acc[r][j] += (float)t[j] * s[j];
            }
          }
        }
      }
      if constexpr (V1) {
        if (--left == 0) {  // the reference's grid step ends after codebook c
          left = a.block_c;
#pragma unroll
          for (int r = 0; r < NR; ++r) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              total[r][j] = __fadd_rn(total[r][j], acc[r][j]);
              acc[r][j] = 0.f;
            }
          }
        }
      }
    }
    ring_release(a, i, n_chunks, m0, ring, bars);
  }
  T* out = static_cast<T*>(a.out);
  const bool has_bias = a.bias != nullptr;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int n = rg + r * RG;
    if (n < n_rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (m + j < a.M) {
          store_out(out + (size_t)(n0 + n) * a.M + m + j,
                    V1 ? total[r][j] : finish<SHARED>(acc[r][j], sv[j], bv[j], has_bias, a.act));
        }
      }
    }
  }
}

// Decode's staged table: the block's whole tile (C*K rows x 4Q columns,
// row-major at `ring`) by 16-byte cp.async, issued after the first chunk's
// staging copies as a cp.async group of its own that only the lookup waits
// for: the tile lands while the codes are computed. One instruction per 16
// bytes from every thread: TMA boxes of 256 narrow rows took ~5.7 us to land
// here (PERF.md). Pieces past M (a multiple of 16 when staged) are
// left unwritten; their columns are never stored.
__device__ __forceinline__ void copy_table(const LutArgs& a, int m0, uint8_t* ring) {
  const int TW = 4 * a.Q;
  const int per_row = TW / 16;
  const int inside = (min(a.M, m0 + TW) - m0) / 16;
  const int total = a.C * a.K * per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int row = i / per_row;
    const int piece = i % per_row;
    if (piece < inside) {
      cp_async16(ring + (size_t)row * TW + piece * 16,
                 a.table_q + (size_t)row * a.M + m0 + piece * 16);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Group-split lookup of the block's M tiles, NR rows at a time: thread
// (q, g) gathers 4 columns of the codebooks g, g + G, ... from the table
// tile copied to shared memory (`copy_table`) or straight from global
// memory, and reduce_store joins the groups. The centroid region is dead by
// now and holds the reduction buffer (red_s).
template <bool SHARED, typename T, int NR, typename CodeT>
__device__ __forceinline__ void group_lookup(const LutArgs& a, bool staged, int n0, int n_rows,
                                             int mt_begin, int mt_end, int col0,
                                             const CodeT* codes_s, const float* s_s,
                                             const float* b_s, void* red_s,
                                             const uint8_t* ring) {
  using AccT = typename std::conditional<SHARED, int, float>::type;
  const int TW = 4 * a.Q;
  const int qs = __ffs(a.Q) - 1;  // Q is a power of two
  const int G = kThreads >> qs;
  const int q = threadIdx.x & (a.Q - 1);
  const int g = threadIdx.x >> qs;
  const bool has_bias = a.bias != nullptr;
  for (int mt = mt_begin; mt < mt_end; ++mt) {
    const int m0 = mt * TW;
    for (int sub = 0; sub < n_rows; sub += NR) {
      const int sub_rows = min(NR, n_rows - sub);
      AccT acc[NR][4];
#pragma unroll
      for (int n = 0; n < NR; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = 0;
      }
      if (staged) {
        lookup_rows<SHARED, NR>(acc, reinterpret_cast<const int8_t*>(ring), TW, 4 * q, a.scale,
                                a.K, a.M, a.scale_m, 0, a.C, codes_s + sub, a.rows, sub_rows,
                                m0 + 4 * q, g, G, true);
      } else {
        lookup_rows<SHARED, NR>(acc, a.table_q, a.M, m0 + 4 * q, a.scale, a.K, a.M, a.scale_m, 0,
                                a.C, codes_s + sub, a.rows, sub_rows, m0 + 4 * q, g, G,
                                a.vec4 != 0);
      }
      reduce_store<SHARED, NR>(acc, red_s, a.Q, qs, q, g, G, n0 + sub, sub_rows, m0, a.M,
                               s_s + (m0 - col0), b_s + (m0 - col0), has_bias, a.act,
                               static_cast<T*>(a.out));
    }
  }
}

// v1's lookup where the table tile is not staged by TMA (decode, and tiles
// that gather from global memory): thread i takes the (row, column) pairs i,
// i + 256, ... of the N tile x M tile, one column each (so 16Q threads hold
// a row at 4 rows), and sums its element over every codebook in order, as
// staged_lookup's V1 does. The order of the adds is fixed, so the latency is
// hidden by issuing ahead: the loads of a run of kRun codebooks (code, table
// byte from the tile copied to shared memory or from global memory, scale)
// all go out before the run's ordered multiply-adds.
template <bool SHARED, typename T, typename CodeT>
__device__ __forceinline__ void ordered_lookup(const LutArgs& a, bool staged, int n0, int n_rows,
                                               int mt_begin, int mt_end, int col0,
                                               const CodeT* codes_s, const float* s_s,
                                               const uint8_t* ring) {
  constexpr int kRun = 16;
  const int TW = 4 * a.Q;
  const int ts = __ffs(a.Q) + 1;  // log2(TW): Q is a power of two
  const size_t pitch = staged ? TW : a.M;
  T* out = static_cast<T*>(a.out);
  for (int mt = mt_begin; mt < mt_end; ++mt) {
    const int m0 = mt * TW;
    for (int i = threadIdx.x; i < (n_rows << ts); i += blockDim.x) {
      const int n = i >> ts;
      const int col = i & (TW - 1);
      const int m = m0 + col;
      if (m >= a.M) continue;
      const uint8_t* tbl =
          staged ? ring + col : reinterpret_cast<const uint8_t*>(a.table_q) + m;
      const float* sp = a.scale + (a.scale_m == 1 ? 0 : m);
      const float s_col = SHARED ? s_s[m - col0] : 0.f;
      const CodeT* code = codes_s + n;
      float total = 0.f;
      float chunk = 0.f;
      int left = a.block_c;
      for (int c0 = 0; c0 < a.C; c0 += kRun) {
        uint32_t t[kRun];
        float s[kRun];
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          const int c = min(c0 + j, a.C - 1);
          t[j] = tbl[((size_t)c * a.K + code[c * a.rows]) * pitch];
          s[j] = SHARED ? s_col : sp[(size_t)c * a.scale_m];
        }
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          if (c0 + j < a.C) {
            chunk = __fadd_rn(chunk, __fmul_rn(s8_to_f32(t[j]), s[j]));
            if (--left == 0) {  // the reference's grid step ends after this codebook
              left = a.block_c;
              total = __fadd_rn(total, chunk);
              chunk = 0.f;
            }
          }
        }
      }
      store_out(out + (size_t)(n0 + n) * a.M + m, total);
    }
  }
}

// The body of the three LUT-AMM kernels. Grid: x = S blocks per cluster x
// column groups, y = N tiles; the cluster's S blocks share one N tile, block
// x owns M tiles [x * tiles_per_block, (x + 1) * tiles_per_block). CHUNKED
// (v2, v1) stages a rank's share in chunks of chunk_c codebooks; the fused
// kernel holds its whole share at once. V1 looks up with v1's ordered fp32
// sums (staged_lookup's V1, ordered_lookup) and no epilogue; SHARED then
// means a (1, ..) scale. CodeT holds a code on chip: uint8_t up to K = 256,
// uint16_t above (the exchange then moves twice the bytes).
template <typename T, bool SHARED, bool CHUNKED, bool V1, typename CodeT>
__device__ __forceinline__ void lut_cluster_body(const LutArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  CodeT* codes_s = reinterpret_cast<CodeT*>(smem);
  float* p_s = reinterpret_cast<float*>(smem + a.cent_off);
  uint8_t* ring = smem + a.ring_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + a.bar_off);
  uint64_t* xbar = bars + a.n_stages;  // the code exchange's mbarrier

  LUTNN_STAMP(0);
  const int S = a.S;
  const int r = (int)cooperative_groups::this_cluster().block_rank();
  // this rank's share of the codebooks; every rank owns at least one (the
  // wrapper's cluster is at most C)
  const int c_lo = r * a.C / S;
  const int c_hi = (r + 1) * a.C / S;

  // the exchange's mbarrier expects the peers' shares of the codes; the
  // cluster barrier's wait, after the encode, orders its setup before any
  // peer's push. Set up before any copy is issued: the release fence would
  // wait for copies in flight
  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(xbar, (uint32_t)((a.C - (c_hi - c_lo)) * a.rows * sizeof(CodeT)));
  }
  cluster_arrive();
  LUTNN_STAMP(1);
  const int n0 = blockIdx.y * a.rows;
  const int n_rows = min(a.rows, a.N - n0);
  const int TW = 4 * a.Q;
  const int n_mtiles = (a.M + TW - 1) / TW;
  const int mt_begin = blockIdx.x * a.tiles_per_block;
  const int mt_end = min(n_mtiles, mt_begin + a.tiles_per_block);
  const bool staged = a.staged != 0 && mt_begin < mt_end;
  const bool tma = staged && a.rows > kBlockN;  // a prefill chunk's ring of TMA boxes

  // the table, issued once while the first chunk's copies are in flight:
  // its bytes arrive while the codes are computed. At decode the whole tile
  // by cp.async (`copy_table`), at a prefill chunk the ring's first stages
  bool table_pending = staged;
  auto issue_table = [&]() -> bool {
    if (!table_pending) return false;
    table_pending = false;
    if (!tma) {
      copy_table(a, mt_begin * TW, ring);
      return true;
    }
    if (threadIdx.x == 0) {
      const int n_chunks = (a.C + a.stage_c - 1) / a.stage_c;
      for (int i = 0; i < a.n_stages; ++i) mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int i = 0; i < min(a.n_stages, n_chunks); ++i) {
        issue_stage(a, i, mt_begin * TW, ring, bars);
      }
    }
    return false;
  };
  // the epilogue's scale and bias of this block's columns, on their way too
  float* s_s = reinterpret_cast<float*>(smem + a.epi_off);
  float* b_s = s_s + a.tiles_per_block * TW;
  const int col0 = mt_begin * TW;
  const bool has_bias = a.bias != nullptr;
  for (int i = threadIdx.x; i < min(a.M, mt_end * TW) - col0; i += blockDim.x) {
    if (SHARED) cp_async4(s_s + i, a.scale + (a.scale_m == 1 ? 0 : col0 + i));
    if (has_bias) cp_async4(b_s + i, a.bias + col0 + i);
  }


  // the share, chunk by chunk: its centroids and norms and the N tile's
  // sub-vectors staged, then the codes
  const int step = CHUNKED ? a.chunk_c : max(c_hi - c_lo, 1);
  float* pn_s = p_s + (size_t)step * (a.K * row_stride16(a.V) + 4);
  float* x_s = pn_s + ((step * (a.K + 1) + 3) & ~3);  // 16-byte aligned
  for (int c0 = c_lo; c0 < c_hi; c0 += step) {
    const int cc = min(step, c_hi - c0);
    stage_share(static_cast<const T*>(a.x), a.centroids, n0, n_rows, a.rows, a.C * a.V, c0, cc,
                a.K, a.V, p_s, pn_s, x_s, issue_table);
    if (c0 == c_lo) LUTNN_STAMP(5);  // the first chunk staged
    if (a.rows > kBlockN) {
      encode_tile<4>(n_rows, a.rows, c0, cc, a.K, a.V, p_s, pn_s, x_s, codes_s);
    } else {
      encode_tile<1>(n_rows, a.rows, c0, cc, a.K, a.V, p_s, pn_s, x_s, codes_s);
    }
    __syncthreads();  // the next chunk overwrites the staged centroids
  }

  // the exchange: each rank pushes its share of the codes (contiguous,
  // codebook-major, 8 bytes at a time) into every peer's shared memory, and
  // waits until its own mbarrier has counted every peer's share
  LUTNN_STAMP(6);  // the share encoded
  cluster_wait();
  const int own = (c_hi - c_lo) * a.rows * (int)sizeof(CodeT) / 8;
  const uint64_t* mine = reinterpret_cast<const uint64_t*>(codes_s + (size_t)c_lo * a.rows);
  for (int i = threadIdx.x; i < own * (S - 1); i += blockDim.x) {
    const int peer = i / own + (i / own >= r);
    const int w = i % own;
    push_u64(peer_addr(mine + w, peer), mine[w], peer_addr(xbar, peer));
  }
  mbar_wait(xbar, 0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // decode's table tile
  __syncthreads();
  LUTNN_STAMP(7);  // the codes exchanged
  cluster_arrive();  // every code received: no peer writes here any more

  if (tma) {  // the fewest rows per thread that cover the N tile
    const int per_thread = (a.rows * a.Q + kThreads - 1) / kThreads;
    if (per_thread <= 1) {
      staged_lookup<SHARED, T, V1, 1>(a, n0, n_rows, col0, codes_s, s_s, b_s, ring, bars);
    } else if (per_thread <= 2) {
      staged_lookup<SHARED, T, V1, 2>(a, n0, n_rows, col0, codes_s, s_s, b_s, ring, bars);
    } else if (per_thread <= 4) {
      staged_lookup<SHARED, T, V1, 4>(a, n0, n_rows, col0, codes_s, s_s, b_s, ring, bars);
    } else {
      staged_lookup<SHARED, T, V1, kStagedRows>(a, n0, n_rows, col0, codes_s, s_s, b_s, ring,
                                                bars);
    }
  } else if constexpr (V1) {
    ordered_lookup<SHARED, T>(a, staged, n0, n_rows, mt_begin, mt_end, col0, codes_s, s_s, ring);
  } else if (n_rows <= kBlockN / 2) {  // decode: a 4-row register tile
    group_lookup<SHARED, T, kBlockN / 2>(a, staged, n0, n_rows, mt_begin, mt_end, col0, codes_s,
                                         s_s, b_s, p_s, ring);
  } else {
    group_lookup<SHARED, T, kBlockN>(a, staged, n0, n_rows, mt_begin, mt_end, col0, codes_s,
                                     s_s, b_s, p_s, ring);
  }
  LUTNN_STAMP(8);
  cluster_wait();  // no block leaves while a peer may still write its codes here
  LUTNN_STAMP(9);
}

// Host side: the launch attributes of a kernel, set once per instantiation
// (the dynamic shared memory cap, and clusters of 16).
template <auto KERNEL>
inline cudaError_t prepare_kernel() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    return e;
  }();
  return err;
}

// Kernels without clusters (the encode) lift only the shared memory cap, once.
template <auto KERNEL>
inline cudaError_t allow_smem() {
  static const cudaError_t err =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

inline cudaLaunchConfig_t cluster_config(dim3 grid, int S, int smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cuTensorMapEncodeTiled, looked up once through the runtime (no
// link against libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The table as a 2-D tensor of C*K rows x M int8 columns, boxes of one ring
// stage (stage_c*K rows x 4Q columns) or, past kMaxBoxRows rows, of an equal
// part of one. A stage the boxes do not split evenly is refused.
inline cudaError_t encode_table_map(LutArgs& a) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if ((a.stage_c * a.K) % box_rows(a.stage_c * a.K) != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)a.M, (cuuint64_t)a.C * a.K};
  const cuuint64_t strides[1] = {(cuuint64_t)a.M};
  const cuuint32_t box[2] = {(cuuint32_t)(4 * a.Q), (cuuint32_t)box_rows(a.stage_c * a.K)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(&a.tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                              const_cast<int8_t*>(a.table_q), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <auto KERNEL>
inline cudaError_t launch_cluster(LutArgs& a, int smem, cudaStream_t stream) {
  cudaError_t err = prepare_kernel<KERNEL>();
  if (err == cudaSuccess && a.staged && a.rows > kBlockN) err = encode_table_map(a);
  if (err != cudaSuccess) return err;
  const int TW = 4 * a.Q;
  const int n_mtiles = (a.M + TW - 1) / TW;
  const int col_blocks = (n_mtiles + a.tiles_per_block - 1) / a.tiles_per_block;
  const dim3 grid(((col_blocks + a.S - 1) / a.S) * a.S, (a.N + a.rows - 1) / a.rows, 1);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, a.S, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, KERNEL, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of S blocks with `smem` bytes each can be resident at once
// (0: the launch cannot run on this card).
template <auto KERNEL>
inline cudaError_t max_clusters(int S, int smem, int* out) {
  cudaError_t err = prepare_kernel<KERNEL>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(S, 1, 1), S, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, KERNEL, &cfg);
}

constexpr int kGeoInts = 14;  // ints of the geometry array the C entry points take

// Fill a LutArgs from the C entry points' arguments; geo holds, in order,
// S, rows, Q, tiles_per_block, chunk_c, staged, stage_c, n_stages, epi_off,
// cent_off, ring_off, bar_off, block_c, vec4.
inline LutArgs make_args(const void* x, const void* centroids, const void* table_q,
                         const void* scale, const void* bias, void* out, int N, int C, int K,
                         int V, int M, int scale_m, int act, const int* geo) {
  LutArgs a = {};
  a.x = x;
  a.centroids = static_cast<const float*>(centroids);
  a.table_q = static_cast<const int8_t*>(table_q);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.N = N;
  a.C = C;
  a.K = K;
  a.V = V;
  a.M = M;
  a.scale_m = scale_m;
  a.act = act;
  int* fields[kGeoInts] = {&a.S,        &a.rows,     &a.Q,        &a.tiles_per_block,
                           &a.chunk_c,  &a.staged,   &a.stage_c,  &a.n_stages,
                           &a.epi_off,  &a.cent_off, &a.ring_off, &a.bar_off,
                           &a.block_c,  &a.vec4};
  for (int i = 0; i < kGeoInts; ++i) *fields[i] = geo[i];
  return a;
}

}  // namespace lutnn
