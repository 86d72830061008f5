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
// v1 and the encode kernel share the staging and the device encode only.
//
// Thread layout of the lookup: a block owns kBlockN rows and one M tile of
// 4*Q columns at a time. Thread t handles the 4 adjacent columns 4*(t % Q)..+3
// (one coalesced 4-byte table read per row) for the codebooks c = t / Q,
// t / Q + G, ... with G = kThreads / Q codebook groups; the G partial sums are
// reduced through shared memory before the epilogue. The sum over codebooks
// is therefore split across threads and re-joined inside the block: no atomics
// and no second pass, and every output element is written exactly once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lutnn {

constexpr int kThreads = 256;  // threads per block
constexpr int kBlockN = 8;     // rows of x per N tile
constexpr int kMaxV = 32;      // longest sub-vector held in registers by the encoder
// reduction buffer: G groups x kBlockN rows x 4Q columns x 4 bytes, G * Q = kThreads
constexpr int kRedBytes = kThreads * kBlockN * 4 * 4;

enum Act { kActNone = 0, kActRelu = 1, kActSilu = 2, kActGelu = 3, kActRelu2 = 4 };

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

// Shared-memory layout of staged centroids: codebook c's K*V floats start at
// c * centroid_stride(K, V), its K squared norms at c * (K + 1). The padding
// shifts neighbouring codebooks by 4 (and 1) banks, so the encoder's threads,
// which read several codebooks at once, do not collide on one bank.
__host__ __device__ __forceinline__ int centroid_stride(int K, int V) { return K * V + 4; }

// Stage the centroids of codebooks [c_lo, c_lo + cc) into shared memory and
// compute their squared norms: p_s holds cc * centroid_stride floats, pn_s
// cc * (K + 1). 16-byte loads, eight in flight per thread: the copy is bound
// by L2 bandwidth rather than by one round trip per element.
__device__ __forceinline__ void stage_centroids(const float* __restrict__ centroids, int c_lo,
                                                int cc, int K, int V, float* p_s, float* pn_s) {
  const float* src = centroids + (size_t)c_lo * K * V;
  const int kv = K * V;
  const int ps = centroid_stride(K, V);
  if ((kv % 4) == 0 && (reinterpret_cast<uintptr_t>(src) % 16) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(p_s);
    const int kv4 = kv / 4;
    const int total4 = cc * kv4;
    for (int base = threadIdx.x; base < total4; base += 8 * blockDim.x) {
      float4 r[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total4) r[u] = __ldg(src4 + i);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total4) dst4[(i / kv4) * (ps / 4) + i % kv4] = r[u];
      }
    }
  } else {
    for (int i = threadIdx.x; i < cc * kv; i += blockDim.x) p_s[(i / kv) * ps + i % kv] = src[i];
  }
  __syncthreads();
  // one thread per centroid row; each lane starts its sum at another word of
  // the row, so the lanes of a warp, whose rows lie V words apart, read
  // different banks (the order of the sum is fixed by the lane)
  const int rot = threadIdx.x % V;
  for (int i = threadIdx.x; i < cc * K; i += blockDim.x) {
    const float* p = p_s + (size_t)(i / K) * ps + (i % K) * V;
    float nrm = 0.f;
    for (int v = 0, w = rot; v < V; ++v, w = (w + 1 == V) ? 0 : w + 1) nrm = fmaf(p[w], p[w], nrm);
    pn_s[(i / K) * (K + 1) + i % K] = nrm;
  }
  __syncthreads();
}

// Nearest-centroid codes of the block's rows for codebooks [c_lo, c_lo + cc):
// codes_s[n * cc + (c - c_lo)] for the n_rows valid rows. fp32 distances by
// the reference's expansion ||a||^2 - 2 a.p + ||p||^2; k ascends with a
// strict '<', so the lowest index wins a tie.
template <typename T>
__device__ __forceinline__ void encode_rows(const T* __restrict__ x, int n0, int n_rows, int D,
                                            int c_lo, int cc, int K, int V, const float* p_s,
                                            const float* pn_s, uint8_t* codes_s) {
  const int ps = centroid_stride(K, V);
  for (int t = threadIdx.x; t < n_rows * cc; t += blockDim.x) {
    // the rows of one codebook are neighbouring threads: centroid reads broadcast
    const int cl = t / n_rows;
    const int n = t % n_rows;
    const T* xr = x + (size_t)(n0 + n) * D + (size_t)(c_lo + cl) * V;
    float a[kMaxV];
    float a_nrm = 0.f;
#pragma unroll
    for (int v = 0; v < kMaxV; ++v) {
      if (v < V) {
        a[v] = load_x(xr + v);
        a_nrm = fmaf(a[v], a[v], a_nrm);
      }
    }
    const float* p = p_s + (size_t)cl * ps;
    const float* pn = pn_s + cl * (K + 1);
    float best = 0.f;
    int best_k = 0;
    for (int k = 0; k < K; ++k) {
      float cross = 0.f;
#pragma unroll
      for (int v = 0; v < kMaxV; ++v) {
        if (v < V) cross = fmaf(a[v], p[k * V + v], cross);
      }
      const float d = __fadd_rn(__fsub_rn(a_nrm, __fmul_rn(2.f, cross)), pn[k]);
      if (k == 0 || d < best) {
        best = d;
        best_k = k;
      }
    }
    codes_s[n * cc + cl] = (uint8_t)best_k;
  }
}

// Accumulate the table rows of codebooks [c_lo, c_lo + cc) into this thread's
// 4 columns m .. m+3 for every valid row. SHARED: raw int32 sums (the m-shared
// or scalar scale factors out); otherwise fp32 sums of T * s[c, m|0].
template <bool SHARED, typename AccT>
__device__ __forceinline__ void lookup_rows(AccT (&acc)[kBlockN][4],
                                            const int8_t* __restrict__ table_q,
                                            const float* __restrict__ scale, int K, int M,
                                            int scale_m, int c_lo, int cc,
                                            const uint8_t* codes_s, int n_rows, int m, int g,
                                            int G, bool vec4) {
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
#pragma unroll
    for (int n = 0; n < kBlockN; ++n) {
      if (n < n_rows) {
        const int code = codes_s[n * cc + cl];
        const int8_t* row = table_q + ((size_t)c * K + code) * M + m;
        int t[4];
        if (full4) {
          const char4 t4 = *reinterpret_cast<const char4*>(row);
          t[0] = t4.x;
          t[1] = t4.y;
          t[2] = t4.z;
          t[3] = t4.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) t[j] = (m + j < M) ? (int)row[j] : 0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (SHARED) {
            acc[n][j] += t[j];
          } else {
            acc[n][j] += (float)t[j] * s[j];
          }
        }
      }
    }
  }
}

// Join the G codebook-group partials of one (kBlockN x 4Q) tile through shared
// memory, then the epilogue: one dequantize (SHARED), bias, activation, cast,
// and the single store of each output element. red_s must hold kRedBytes and
// is free again when this returns. The order of the sums is fixed.
template <bool SHARED, typename AccT, typename T>
__device__ __forceinline__ void reduce_store(const AccT (&acc)[kBlockN][4], void* red_s, int Q,
                                             int q, int g, int G, int n0, int n_rows, int m0,
                                             int M, const float* __restrict__ scale,
                                             int scale_m, const float* __restrict__ bias,
                                             int act, T* __restrict__ out) {
  const int TW = 4 * Q;
  AccT* red = reinterpret_cast<AccT*>(red_s);
#pragma unroll
  for (int n = 0; n < kBlockN; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(g * kBlockN + n) * TW + 4 * q + j] = acc[n][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBlockN * TW; idx += blockDim.x) {
    const int n = idx / TW;
    const int col = idx % TW;
    const int mm = m0 + col;
    if (n < n_rows && mm < M) {
      AccT sum = 0;
      for (int gg = 0; gg < G; ++gg) sum += red[(gg * kBlockN + n) * TW + col];
      // m-shared / scalar: the reference's (float)acc32 * s + bias, which XLA
      // contracts into one fused multiply-add (one rounding); without a bias,
      // the single rounding of the product. Per-codebook: the fp32 sum + bias.
      float y;
      if (SHARED) {
        const float s = scale[scale_m == 1 ? 0 : mm];
        y = bias != nullptr ? __fmaf_rn((float)sum, s, bias[mm]) : __fmul_rn((float)sum, s);
      } else {
        y = bias != nullptr ? __fadd_rn((float)sum, bias[mm]) : (float)sum;
      }
      store_out(out + (size_t)(n0 + n) * M + mm, apply_act(y, act));
    }
  }
  __syncthreads();
}

// Host helper: lift the dynamic shared memory cap of a kernel once.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace lutnn
