// Fused encode -> lookup LUT-AMM kernel for Hopper (sm_90a), the port's "v3".
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py::fused_decode_pallas
// (_fused_decode_kernel, _fused_decode_call). What it computes is in
// lut_common.cuh: nearest-centroid codes over all C codebooks, then an int8
// table gather-accumulate, then a fused dequantize + bias + activation epilogue.
//
// Design against the TPU original. The TPU grid runs in order, so the Pallas
// kernel encodes an N tile once (pl.when(m_step == 0)) and keeps the codes in
// VMEM scratch across the whole M sweep. Blocks on Hopper run in parallel and
// share nothing, so here each block owns one N tile of kBlockN rows and a
// contiguous *range* of M tiles: it stages all C codebooks' fp32 centroids in
// dynamic shared memory, encodes its rows once into shared memory as uint8
// indices (kBlockN x C bytes), and then sweeps its M tiles. Codes never reach
// device memory. The number of M ranges is chosen by the wrapper so that a
// decode step (N = n_slots, one N tile) still launches about one block per SM:
// each of those blocks recomputes the same encode (4 rows x 64 codebooks x
// 16 centroids x 32 = 131k FMAs at the q site), which is the trade this design
// makes to fill 132 SMs without a second pass over device memory.
//
// What bounds it on this card: at decode, bytes. The int8 table is read once
// per N tile (the q site's 2 MiB table at 3.35 TB/s is about 0.63 us), and the
// centroids (128 KiB per block at C = 64, V = 32) come from L2 once per block.
// The lookup is a gather-accumulate in int32 (the pq.gather_lut form), which
// is exact; threads along m read each table row with coalesced 4-byte loads.
// Tensor-core one-hot dots (wgmma), TMA staging and a persistent schedule are
// later work.
//
// Shared memory: [ max(C staged codebooks, kRedBytes) | kBlockN*C code bytes ],
// a staged codebook being its padded centroids and norms (lut_common.cuh).
// The centroid region is dead after the encode and becomes the reduction
// buffer of the M sweep.
#include "lut_common.cuh"

namespace lutnn {

template <typename T, bool SHARED>
__global__ void __launch_bounds__(kThreads)
    fused_decode_kernel(const T* __restrict__ x, const float* __restrict__ centroids,
                        const int8_t* __restrict__ table_q, const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ out, int N, int C,
                        int K, int V, int M, int scale_m, int act, int Q, int tiles_per_range,
                        int region_bytes, int vec4) {
  using AccT = typename std::conditional<SHARED, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);
  float* pn_s = p_s + (size_t)C * centroid_stride(K, V);
  uint8_t* codes_s = smem + region_bytes;

  const int n0 = blockIdx.x * kBlockN;
  const int n_rows = min(kBlockN, N - n0);

  // ---- encode: once per block, all C codebooks resident ----
  stage_centroids(centroids, 0, C, K, V, p_s, pn_s);
  encode_rows(x, n0, n_rows, C * V, 0, C, K, V, p_s, pn_s, codes_s);
  __syncthreads();

  // ---- lookup: sweep this block's range of M tiles with the same codes ----
  const int TW = 4 * Q;
  const int G = kThreads / Q;
  const int q = threadIdx.x % Q;
  const int g = threadIdx.x / Q;
  const int n_mtiles = (M + TW - 1) / TW;
  const int mt_end = min(n_mtiles, (int)(blockIdx.y + 1) * tiles_per_range);
  for (int mt = blockIdx.y * tiles_per_range; mt < mt_end; ++mt) {
    const int m0 = mt * TW;
    AccT acc[kBlockN][4];
#pragma unroll
    for (int n = 0; n < kBlockN; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0;
    }
    lookup_rows<SHARED>(acc, table_q, scale, K, M, scale_m, 0, C, codes_s, n_rows, m0 + 4 * q,
                        g, G, vec4 != 0);
    reduce_store<SHARED>(acc, smem, Q, q, g, G, n0, n_rows, m0, M, scale, scale_m, bias, act,
                       out);
  }
}

template <typename T, bool SHARED>
cudaError_t launch(const void* x, const void* centroids, const void* table_q, const void* scale,
                   const void* bias, void* out, int N, int C, int K, int V, int M, int scale_m,
                   int act, int Q, int m_ranges, int tiles_per_range, int region_bytes,
                   int smem_bytes, int vec4, cudaStream_t stream) {
  auto kernel = fused_decode_kernel<T, SHARED>;
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBlockN - 1) / kBlockN, m_ranges);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(centroids),
      static_cast<const int8_t*>(table_q), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), N, C, K, V, M, scale_m, act, Q,
      tiles_per_range, region_bytes, vec4);
  return cudaGetLastError();
}

}  // namespace lutnn

// Plain C entry point (loaded with ctypes). Returns a cudaError_t: 0 on a
// successful launch. Launches on `stream` and does not synchronise.
extern "C" int lutnn_fused_decode(const void* x, const void* centroids, const void* table_q,
                                  const void* scale, const void* bias, void* out, int N, int C,
                                  int K, int V, int M, int scale_c, int scale_m, int x_bf16,
                                  int act, int Q, int m_ranges, int tiles_per_range,
                                  int region_bytes, int smem_bytes, int vec4, void* stream) {
  using namespace lutnn;
  const bool shared = scale_c == 1;
  auto s = static_cast<cudaStream_t>(stream);
#define LUTNN_ARGS                                                                             \
  x, centroids, table_q, scale, bias, out, N, C, K, V, M, scale_m, act, Q, m_ranges,           \
      tiles_per_range, region_bytes, smem_bytes, vec4, s
  if (x_bf16) {
    return shared ? launch<__nv_bfloat16, true>(LUTNN_ARGS)
                  : launch<__nv_bfloat16, false>(LUTNN_ARGS);
  }
  return shared ? launch<float, true>(LUTNN_ARGS) : launch<float, false>(LUTNN_ARGS);
#undef LUTNN_ARGS
}
