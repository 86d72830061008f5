// Closest-centroid encode for Hopper (sm_90a): int32 codes (N, C).
//
// Replaces the TPU kernel src/repro/kernels/dist_argmin.py::encode_pallas
// (_encode_kernel, _encode_call). What it computes:
//
//   code[n, c] = argmin_k ||a||^2 - 2 a.P[c,k] + ||P[c,k]||^2  (fp32, lowest k wins)
//
// with the device encode of lut_common.cuh (encode_tile, the one the LUT-AMM
// kernels run), so its codes are the codes those kernels look up.
//
// Design against the TPU original. The Pallas kernel is centroid-stationary:
// the codebook tile's index map ignores the N grid axis, so a (bc, K, V) tile
// stays in VMEM while the N tiles stream past, in order. Blocks on Hopper run
// in parallel, so here the grid is (codebook chunk x N tile) of independent
// blocks, sized by the wrapper to give at least about one block per SM. A
// block stages its chunk's centroids and its rows' sub-vectors by 16-byte
// cp.async (stage_share: every copy in flight at once), computes the
// centroids' norms, encodes in parallel over K (encode_tile: R = 1 row per
// lane group at tiles of 8 rows or fewer, R = 4 above) into shared memory,
// and writes the codebook-major codes out as row-major int32, neighbouring
// threads on neighbouring codes of a row. The codes are the output, so no
// cluster and no exchange are needed.
//
// What bounds it on this card: latency. The bytes (x once, P once per N
// tile, N C int32 codes) and the fp32 distance FMAs (2 N C K V) take well
// under a microsecond at the main path's shapes; a block's time is one
// round trip for its copies, the norms, the encode and the store.
//
// Shared memory: [ chunk centroids (16-byte rows) | their norms | the tile's
// sub-vectors | chunk x rows codes (1 byte each, 2 above K = 256) ], sizes from the wrapper
// (dist_argmin.py, encode_geometry).
#include "lut_common.cuh"

namespace lutnn {

template <typename T, typename CodeT>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const T* __restrict__ x, const float* __restrict__ centroids,
                  int32_t* __restrict__ out, int N, int C, int K, int V, int chunk_c, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rs = row_stride16(V);
  float* p_s = reinterpret_cast<float*>(smem);
  float* pn_s = p_s + (size_t)chunk_c * (K * rs + 4);
  float* x_s = pn_s + ((chunk_c * (K + 1) + 3) & ~3);  // 16-byte aligned
  CodeT* codes_s = reinterpret_cast<CodeT*>(x_s + (size_t)chunk_c * rows * rs);

  const int c0 = blockIdx.x * chunk_c;
  const int cc = min(chunk_c, C - c0);
  const int n0 = blockIdx.y * rows;
  const int n_rows = min(rows, N - n0);
  stage_share(x, centroids, n0, n_rows, rows, C * V, c0, cc, K, V, p_s, pn_s, x_s,
              [] { return false; });
  if (rows > kBlockN) {
    encode_tile<4>(n_rows, rows, 0, cc, K, V, p_s, pn_s, x_s, codes_s);
  } else {
    encode_tile<1>(n_rows, rows, 0, cc, K, V, p_s, pn_s, x_s, codes_s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * cc; i += blockDim.x) {
    const int n = i / cc;
    const int cl = i - n * cc;
    out[(size_t)(n0 + n) * C + c0 + cl] = codes_s[cl * rows + n];
  }
}

template <typename T, typename CodeT>
cudaError_t launch_encode(const void* x, const void* centroids, void* out, int N, int C, int K,
                          int V, int chunk_c, int rows, int smem_bytes, cudaStream_t stream) {
  auto kernel = encode_kernel<T, CodeT>;
  cudaError_t err = allow_smem<encode_kernel<T, CodeT>>();
  if (err != cudaSuccess) return err;
  dim3 grid((C + chunk_c - 1) / chunk_c, (N + rows - 1) / rows);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(static_cast<const T*>(x),
                                                 static_cast<const float*>(centroids),
                                                 static_cast<int32_t*>(out), N, C, K, V,
                                                 chunk_c, rows);
  return cudaGetLastError();
}

}  // namespace lutnn

// Plain C entry point (loaded with ctypes). Returns a cudaError_t: 0 on a
// successful launch. Launches on `stream` and does not synchronise.
extern "C" int lutnn_encode(const void* x, const void* centroids, void* out, int N, int C, int K,
                            int V, int x_bf16, int chunk_c, int rows, int smem_bytes,
                            void* stream) {
  using namespace lutnn;
  if (chunk_c < 1 || rows < 1 || V > kMaxV || K > kMaxK) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  // codes held as uint16_t in shared memory above K = kByteK
  if (x_bf16) {
    return K > kByteK ? launch_encode<__nv_bfloat16, uint16_t>(x, centroids, out, N, C, K, V,
                                                               chunk_c, rows, smem_bytes, s)
                      : launch_encode<__nv_bfloat16, uint8_t>(x, centroids, out, N, C, K, V,
                                                              chunk_c, rows, smem_bytes, s);
  }
  return K > kByteK ? launch_encode<float, uint16_t>(x, centroids, out, N, C, K, V, chunk_c,
                                                     rows, smem_bytes, s)
                    : launch_encode<float, uint8_t>(x, centroids, out, N, C, K, V, chunk_c, rows,
                                                    smem_bytes, s);
}
