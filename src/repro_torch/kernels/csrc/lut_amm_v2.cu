// LUT-AMM kernel v2 for Hopper (sm_90a): the port's fallback when the fused
// kernel's resident codebooks do not fit in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/lut_amm.py::lut_amm_pallas
// (_lut_amm_kernel_v2, _lut_amm_call_v2, _encode_onehot_i8). What it computes
// is in lut_common.cuh and is the same function as fused_decode.cu.
//
// Design against the TPU original. The Pallas grid is (N/bn, M/bm, C/bc) with
// the codebook axis innermost and sequential: partial sums live in a VMEM
// scratch accumulator across C steps and the output tile is written on the
// last one. Here the grid is (N tiles, M tiles) and the sequential C axis is a
// loop inside the block: each chunk of codebooks streams its centroids through
// shared memory, encodes the block's rows for that chunk, and gathers its
// table rows into per-thread registers (int32 for an m-shared or scalar scale,
// fp32 otherwise). After the last chunk the codebook groups are joined in
// shared memory and each output element is written once, with dequantize,
// bias and activation fused. No atomics.
//
// What bounds it on this card: at decode, bytes. The main path sends it the
// down projection (C = 192, M = 2048: a 6 MiB int8 table, about 1.9 us at
// 3.35 TB/s), whose 384 KiB of centroids cannot be resident in one block.
// Every block re-encodes its rows for every chunk (the v2 trade: the encode
// is charged once per M tile), and reads all C codebooks' centroids from L2.
// The wrapper picks the M tile width so that decode still launches about one
// block per SM.
//
// Shared memory: [ max(chunk staged codebooks, kRedBytes) | kBlockN*chunk code
// bytes ], a staged codebook being its padded centroids and norms. The centroid region becomes the reduction buffer after the
// last chunk.
#include "lut_common.cuh"

namespace lutnn {

template <typename T, bool SHARED>
__global__ void __launch_bounds__(kThreads)
    lut_amm_v2_kernel(const T* __restrict__ x, const float* __restrict__ centroids,
                      const int8_t* __restrict__ table_q, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out, int N, int C, int K,
                      int V, int M, int scale_m, int act, int Q, int chunk_c, int region_bytes,
                      int vec4) {
  using AccT = typename std::conditional<SHARED, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);
  float* pn_s = p_s + (size_t)chunk_c * centroid_stride(K, V);
  uint8_t* codes_s = smem + region_bytes;

  const int n0 = blockIdx.x * kBlockN;
  const int n_rows = min(kBlockN, N - n0);
  const int TW = 4 * Q;
  const int G = kThreads / Q;
  const int q = threadIdx.x % Q;
  const int g = threadIdx.x / Q;
  const int m0 = blockIdx.y * TW;

  AccT acc[kBlockN][4];
#pragma unroll
  for (int n = 0; n < kBlockN; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0;
  }

  // the TPU's sequential codebook grid axis, as a loop over chunks
  for (int c_lo = 0; c_lo < C; c_lo += chunk_c) {
    const int cc = min(chunk_c, C - c_lo);
    stage_centroids(centroids, c_lo, cc, K, V, p_s, pn_s);
    encode_rows(x, n0, n_rows, C * V, c_lo, cc, K, V, p_s, pn_s, codes_s);
    __syncthreads();
    lookup_rows<SHARED>(acc, table_q, scale, K, M, scale_m, c_lo, cc, codes_s, n_rows,
                        m0 + 4 * q, g, G, vec4 != 0);
    __syncthreads();  // codes and centroids of this chunk are overwritten next
  }
  reduce_store<SHARED>(acc, smem, Q, q, g, G, n0, n_rows, m0, M, scale, scale_m, bias, act,
                       out);
}

template <typename T, bool SHARED>
cudaError_t launch(const void* x, const void* centroids, const void* table_q, const void* scale,
                   const void* bias, void* out, int N, int C, int K, int V, int M, int scale_m,
                   int act, int Q, int chunk_c, int region_bytes, int smem_bytes, int vec4,
                   cudaStream_t stream) {
  auto kernel = lut_amm_v2_kernel<T, SHARED>;
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  const int TW = 4 * Q;
  dim3 grid((N + kBlockN - 1) / kBlockN, (M + TW - 1) / TW);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(centroids),
      static_cast<const int8_t*>(table_q), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), N, C, K, V, M, scale_m, act, Q,
      chunk_c, region_bytes, vec4);
  return cudaGetLastError();
}

}  // namespace lutnn

// Plain C entry point (loaded with ctypes). Returns a cudaError_t: 0 on a
// successful launch. Launches on `stream` and does not synchronise.
extern "C" int lutnn_lut_amm_v2(const void* x, const void* centroids, const void* table_q,
                                const void* scale, const void* bias, void* out, int N, int C,
                                int K, int V, int M, int scale_c, int scale_m, int x_bf16,
                                int act, int Q, int chunk_c, int region_bytes, int smem_bytes,
                                int vec4, void* stream) {
  using namespace lutnn;
  const bool shared = scale_c == 1;
  auto s = static_cast<cudaStream_t>(stream);
#define LUTNN_ARGS                                                                             \
  x, centroids, table_q, scale, bias, out, N, C, K, V, M, scale_m, act, Q, chunk_c,            \
      region_bytes, smem_bytes, vec4, s
  if (x_bf16) {
    return shared ? launch<__nv_bfloat16, true>(LUTNN_ARGS)
                  : launch<__nv_bfloat16, false>(LUTNN_ARGS);
  }
  return shared ? launch<float, true>(LUTNN_ARGS) : launch<float, false>(LUTNN_ARGS);
#undef LUTNN_ARGS
}
