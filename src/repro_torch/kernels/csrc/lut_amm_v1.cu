// LUT-AMM kernel v1 for Hopper (sm_90a): the TPU's first generation, kept as
// a version the autotuner times beside v2 and the fused kernel.
//
// Replaces the TPU kernel src/repro/kernels/lut_amm.py::lut_amm_pallas_v1
// (_lut_amm_kernel_v1). What it computes, for x (N, C*V), centroids P
// (C, K, V) fp32, int8 table T (C, K, M) and scale s (1|C, 1, 1|M):
//
//   code[n, c]  = argmin_k ||a||^2 - 2 a.P[c,k] + ||P[c,k]||^2  (lut_common.cuh)
//   chunk[n, m] = sum_{c in chunk} fl(T[c, code[n,c], m] * s[c|0, m|0])
//   out[n, m]   = sum_{chunks} chunk[n, m]
//
// in fp32, in codebook order within a chunk of block_c codebooks and in chunk
// order across chunks, then cast once to x's dtype. No bias or activation: the
// dispatcher adds them outside, in x's dtype, as the reference does. A (1, ..)
// scale is read as its broadcast over C, which the reference materializes.
//
// Design against the TPU original. The Pallas grid is (N/bn, M/bm, C/bc) with
// the codebook axis innermost and sequential: each step dequantizes its table
// tile to fp32 (t * s), contracts a one-hot against it, sums the bc codebooks
// of the step and read-modify-writes the output tile. Here the grid is
// (N tiles, M tiles) and the sequential C axis is a loop inside the block.
// Each thread owns 4 adjacent columns of one or two rows and sums every
// codebook of them itself, in order, with explicit _rn intrinsics (no FMA
// contraction): the plain version (ref.lut_amm_v1_plain) adds in the same
// order, so kernel and plain agree bytewise. The centroids are staged through
// shared memory in chunks of stage_c codebooks, which the wrapper sizes to
// shared memory independently of block_c: staging does not change the sums.
//
// What bounds it on this card: like v2, at decode the bytes of the int8 table
// (read once per N tile) and, in practice, the staging of all C codebooks'
// centroids into every block and the serial encode; the fp32 dequantize costs
// one multiply per gathered entry. It is the slowest generation by design.
//
// Shared memory: [ max(stage_c staged codebooks) | kBlockN * stage_c code bytes ].
#include "lut_common.cuh"

namespace lutnn {

// rows of the N tile one thread sums: kBlockN * Q / kThreads, with Q <= 64
constexpr int kV1Rows = 2;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lut_amm_v1_kernel(const T* __restrict__ x, const float* __restrict__ centroids,
                      const int8_t* __restrict__ table_q, const float* __restrict__ scale,
                      T* __restrict__ out, int N, int C, int K, int V, int M, int scale_c,
                      int scale_m, int Q, int block_c, int stage_c, int region_bytes, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);
  float* pn_s = p_s + (size_t)stage_c * centroid_stride(K, V);
  uint8_t* codes_s = smem + region_bytes;

  const int n0 = blockIdx.x * kBlockN;
  const int n_rows = min(kBlockN, N - n0);
  const int q = threadIdx.x % Q;
  const int r0 = threadIdx.x / Q;  // this thread's first row; rows r0, r0 + R
  const int R = kThreads / Q;
  const int m = blockIdx.y * 4 * Q + 4 * q;
  const bool full4 = vec4 != 0 && m + 3 < M;

  float total[kV1Rows][4];
  float chunk[kV1Rows][4];
#pragma unroll
  for (int i = 0; i < kV1Rows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) total[i][j] = chunk[i][j] = 0.f;
  }

  for (int c_lo = 0; c_lo < C; c_lo += stage_c) {
    const int cc = min(stage_c, C - c_lo);
    stage_centroids(centroids, c_lo, cc, K, V, p_s, pn_s);
    encode_rows(x, n0, n_rows, C * V, c_lo, cc, K, V, p_s, pn_s, codes_s);
    __syncthreads();
    if (m < M) {
      for (int cl = 0; cl < cc; ++cl) {
        const int c = c_lo + cl;
        const float* sc = scale + (size_t)(scale_c == 1 ? 0 : c) * scale_m;
        float s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = sc[scale_m == 1 ? 0 : min(m + j, M - 1)];
#pragma unroll
        for (int i = 0; i < kV1Rows; ++i) {
          const int n = r0 + i * R;
          if (n < n_rows) {
            const int8_t* row = table_q + ((size_t)c * K + codes_s[n * cc + cl]) * M + m;
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
              chunk[i][j] = __fadd_rn(chunk[i][j], __fmul_rn((float)t[j], s[j]));
            }
          }
        }
        if ((c + 1) % block_c == 0) {  // the reference's grid step ends here
#pragma unroll
          for (int i = 0; i < kV1Rows; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              total[i][j] = __fadd_rn(total[i][j], chunk[i][j]);
              chunk[i][j] = 0.f;
            }
          }
        }
      }
    }
    __syncthreads();  // codes and centroids of this stage are overwritten next
  }
  if (m >= M) return;
#pragma unroll
  for (int i = 0; i < kV1Rows; ++i) {
    const int n = r0 + i * R;
    if (n < n_rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (m + j < M) store_out(out + (size_t)(n0 + n) * M + m + j, total[i][j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_v1(const void* x, const void* centroids, const void* table_q,
                      const void* scale, void* out, int N, int C, int K, int V, int M,
                      int scale_c, int scale_m, int Q, int block_c, int stage_c,
                      int region_bytes, int smem_bytes, int vec4, cudaStream_t stream) {
  auto kernel = lut_amm_v1_kernel<T>;
  cudaError_t err = allow_smem<lut_amm_v1_kernel<T>>();
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBlockN - 1) / kBlockN, (M + 4 * Q - 1) / (4 * Q));
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(centroids),
      static_cast<const int8_t*>(table_q), static_cast<const float*>(scale), static_cast<T*>(out),
      N, C, K, V, M, scale_c, scale_m, Q, block_c, stage_c, region_bytes, vec4);
  return cudaGetLastError();
}

}  // namespace lutnn

// Plain C entry point (loaded with ctypes). Returns a cudaError_t: 0 on a
// successful launch. Launches on `stream` and does not synchronise.
extern "C" int lutnn_lut_amm_v1(const void* x, const void* centroids, const void* table_q,
                                const void* scale, void* out, int N, int C, int K, int V, int M,
                                int scale_c, int scale_m, int x_bf16, int Q, int block_c,
                                int stage_c, int region_bytes, int smem_bytes, int vec4,
                                void* stream) {
  using namespace lutnn;
  if (Q < 1 || Q > 64 || kThreads % Q != 0 || block_c < 1 || C % block_c != 0 || stage_c < 1) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch_v1<__nv_bfloat16>(x, centroids, table_q, scale, out, N, C, K, V, M, scale_c,
                                    scale_m, Q, block_c, stage_c, region_bytes, smem_bytes, vec4,
                                    s);
  }
  return launch_v1<float>(x, centroids, table_q, scale, out, N, C, K, V, M, scale_c, scale_m, Q,
                          block_c, stage_c, region_bytes, smem_bytes, vec4, s);
}
