// Closest-centroid encode for Hopper (sm_90a): int32 codes (N, C).
//
// Replaces the TPU kernel src/repro/kernels/dist_argmin.py::encode_pallas
// (_encode_kernel, _encode_call). What it computes:
//
//   code[n, c] = argmin_k ||a||^2 - 2 a.P[c,k] + ||P[c,k]||^2  (fp32, lowest k wins)
//
// with the device encode of lut_common.cuh (the one the LUT-AMM kernels run),
// so its codes are the codes those kernels look up.
//
// Design against the TPU original. The Pallas kernel is centroid-stationary:
// the codebook tile's index map ignores the N grid axis, so a (bc, K, V) tile
// stays in VMEM while the N tiles stream past. Here a block owns one chunk of
// codebooks and one range of rows: it stages the chunk's centroids and their
// norms in shared memory once, then encodes its rows kEncRows at a time into
// shared memory and writes each pass's codes out as int32, one row's chunk
// of codes contiguous. The wrapper picks the chunk and the row ranges so that
// about one block runs per SM.
//
// What bounds it on this card: the fp32 distance FMAs (2 N C K V) at small
// codebooks and, at the main path's shapes, the staging of the chunk's
// centroids from L2 into every row range's block; the bytes (x once, P once,
// N C int32 codes) are small.
//
// Shared memory: [ chunk staged codebooks | kEncRows * chunk code bytes ].
#include "lut_common.cuh"

namespace lutnn {

constexpr int kEncRows = 32;  // rows per encode pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const T* __restrict__ x, const float* __restrict__ centroids,
                  int32_t* __restrict__ out, int N, int C, int K, int V, int chunk_c,
                  int rows_per_block, int region_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);
  float* pn_s = p_s + (size_t)chunk_c * centroid_stride(K, V);
  uint8_t* codes_s = smem + region_bytes;

  const int c_lo = blockIdx.x * chunk_c;
  const int cc = min(chunk_c, C - c_lo);
  const int n_begin = blockIdx.y * rows_per_block;
  const int n_end = min(N, n_begin + rows_per_block);

  stage_centroids(centroids, c_lo, cc, K, V, p_s, pn_s);  // once per block
  for (int n0 = n_begin; n0 < n_end; n0 += kEncRows) {
    const int rows = min(kEncRows, n_end - n0);
    encode_rows(x, n0, rows, C * V, c_lo, cc, K, V, p_s, pn_s, codes_s);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * cc; i += blockDim.x) {
      const int n = i / cc;
      out[(size_t)(n0 + n) * C + c_lo + i % cc] = codes_s[i];
    }
    __syncthreads();  // codes_s is rewritten by the next pass
  }
}

template <typename T>
cudaError_t launch_encode(const void* x, const void* centroids, void* out, int N, int C, int K,
                          int V, int chunk_c, int rows_per_block, int region_bytes,
                          int smem_bytes, cudaStream_t stream) {
  auto kernel = encode_kernel<T>;
  cudaError_t err = allow_smem<encode_kernel<T>>();
  if (err != cudaSuccess) return err;
  dim3 grid((C + chunk_c - 1) / chunk_c, (N + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(centroids),
      static_cast<int32_t*>(out), N, C, K, V, chunk_c, rows_per_block, region_bytes);
  return cudaGetLastError();
}

}  // namespace lutnn

// Plain C entry point (loaded with ctypes). Returns a cudaError_t: 0 on a
// successful launch. Launches on `stream` and does not synchronise.
extern "C" int lutnn_encode(const void* x, const void* centroids, void* out, int N, int C, int K,
                            int V, int x_bf16, int chunk_c, int rows_per_block, int region_bytes,
                            int smem_bytes, void* stream) {
  using namespace lutnn;
  if (chunk_c < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch_encode<__nv_bfloat16>(x, centroids, out, N, C, K, V, chunk_c, rows_per_block,
                                        region_bytes, smem_bytes, s);
  }
  return launch_encode<float>(x, centroids, out, N, C, K, V, chunk_c, rows_per_block,
                              region_bytes, smem_bytes, s);
}
