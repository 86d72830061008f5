// LUT-AMM kernel v2 for Hopper (sm_90a): the port's kernel where the fused
// kernel's resident codebooks do not fit in one block's shared memory.
//
// Replaces the TPU kernel src/repro/kernels/lut_amm.py::lut_amm_pallas
// (_lut_amm_kernel_v2, _lut_amm_call_v2, _encode_onehot_i8). What it computes
// is in lut_common.cuh and is the same function as fused_decode.cu.
//
// Design against the TPU original. The Pallas grid is (N/bn, M/bm, C/bc) with
// the codebook axis innermost and sequential: each C step encodes one chunk of
// codebooks and its partial sums accumulate in VMEM scratch until the output
// tile is written on the last step. Here a thread-block cluster of S blocks
// (along M) shares one N tile; each rank stages and encodes only its share of
// the codebooks, and keeps v2's defining trait inside that share: a loop over
// chunks of at most chunk_c codebooks, so that a share larger than a block's
// region still streams through shared memory. The codes are exchanged through
// distributed shared memory (never device memory), and each block then looks
// up its M tiles over all C codebooks into int32 (m-shared or scalar scale) or
// fp32 (per-codebook) sums, written once in a fused epilogue. No atomics.
//
// What bounds it on this card: at decode, the bytes of the int8 table. The
// main path sends it the down projection (C = 192, M = 2048: a 6 MiB table,
// about 1.9 us at 3.35 TB/s), whose 384 KiB of centroids cannot be resident in
// one block. Every block used to stage and encode all 192 codebooks in three
// chunks; in a cluster of S = 16 a rank stages 12 codebooks in one chunk and
// encodes 12 of them, at the cost of two cluster barriers and a DSMEM
// exchange of N tile x C bytes. At a prefill chunk the table tile is staged
// by TMA and serves every row of the N tile.
//
// Shared memory: [ C x rows codes | the block's scale and bias | the
// chunk's codebooks centroids, norms and sub-vectors (or the reduction buffer) |
// table ring | its mbarriers ], offsets from the wrapper.
#include "lut_common.cuh"

namespace lutnn {

template <typename T, bool SHARED, typename CodeT>
__global__ void __launch_bounds__(kThreads) lut_amm_v2_kernel(const __grid_constant__ LutArgs a) {
  lut_cluster_body<T, SHARED, true, false, CodeT>(a);
}

}  // namespace lutnn

#define LUTNN_DISPATCH_CODES(FN, CODE, ...)                                         \
  (x_bf16 ? (shared ? FN<lut_amm_v2_kernel<__nv_bfloat16, true, CODE>>(__VA_ARGS__)  \
                    : FN<lut_amm_v2_kernel<__nv_bfloat16, false, CODE>>(__VA_ARGS__)) \
          : (shared ? FN<lut_amm_v2_kernel<float, true, CODE>>(__VA_ARGS__)          \
                    : FN<lut_amm_v2_kernel<float, false, CODE>>(__VA_ARGS__)))
// codes held as uint16_t above K = 256 (lut_common.cuh, lut_cluster_body)
#define LUTNN_DISPATCH(FN, ...)                                                      \
  (wide ? LUTNN_DISPATCH_CODES(FN, uint16_t, __VA_ARGS__)                            \
        : LUTNN_DISPATCH_CODES(FN, uint8_t, __VA_ARGS__))

// Plain C entry point (loaded with ctypes). geo: kGeoInts launch parameters
// (LutArgs, from S to vec4). Returns a cudaError_t: 0 on a successful launch.
// Launches on `stream` and does not synchronise.
extern "C" int lutnn_lut_amm_v2(const void* x, const void* centroids, const void* table_q,
                                  const void* scale, const void* bias, void* out, int N, int C,
                                  int K, int V, int M, int scale_c, int scale_m, int x_bf16,
                                  int act, const int* geo, int smem_bytes, void* stream) {
  using namespace lutnn;
  const bool shared = scale_c == 1;
  const bool wide = K > kByteK;
  LutArgs a =
      make_args(x, centroids, table_q, scale, bias, out, N, C, K, V, M, scale_m, act, geo);
  return LUTNN_DISPATCH(launch_cluster, a, smem_bytes, static_cast<cudaStream_t>(stream));
}

// How many clusters of S blocks of `smem_bytes` can be resident at once on
// this card (0: such a launch cannot run); wide: K > kByteK.
extern "C" int lutnn_lut_amm_v2_clusters(int x_bf16, int scale_c, int wide, int S,
                                         int smem_bytes, int* out) {
  using namespace lutnn;
  const bool shared = scale_c == 1;
  return LUTNN_DISPATCH(max_clusters, S, smem_bytes, out);
}
