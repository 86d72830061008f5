// Fused encode -> lookup LUT-AMM kernel for Hopper (sm_90a), the port's "v3".
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py::fused_decode_pallas
// (_fused_decode_kernel, _fused_decode_call). What it computes is in
// lut_common.cuh: nearest-centroid codes over all C codebooks, then an int8
// table gather-accumulate, then a fused dequantize + bias + activation epilogue.
//
// Design against the TPU original. The TPU grid runs in order, so the Pallas
// kernel encodes an N tile once (pl.when(m_step == 0)) and keeps the codes in
// VMEM scratch across the whole M sweep. Blocks on Hopper run in parallel, so
// here a thread-block cluster takes that role: its S blocks (along M) share
// one N tile, each stages and encodes only its share of the codebooks (all of
// the share resident at once: that is what distinguishes this kernel from v2),
// and the codes are exchanged through distributed shared memory. Codes never
// reach device memory. Each block then sweeps its own M tiles with the full
// N tile x C codes, from a table tile staged by TMA (a ring of
// mbarrier-tracked boxes; at decode only where the whole tile is resident at
// once, else a direct gather from global memory) (lut_common.cuh,
// lut_cluster_body).
//
// What bounds it on this card: the bytes of the int8 table, read once per N
// tile (q/o: 2 MiB, about 0.63 us at 3.35 TB/s). What used to keep it 35x
// above that bound was each block staging all C codebooks' centroids (128 KiB
// at C = 64) and encoding its rows over all of them; a cluster of S blocks
// divides that by S, at the cost of two cluster barriers and a DSMEM exchange
// of N tile x C bytes.
//
// Shared memory: [ C x rows codes | the block's scale and bias | the
// share's codebooks centroids, norms and sub-vectors (or the reduction buffer) |
// table ring | its mbarriers ], offsets from the wrapper.
#include "lut_common.cuh"

namespace lutnn {

template <typename T, bool SHARED, typename CodeT>
__global__ void __launch_bounds__(kThreads) fused_decode_kernel(const __grid_constant__ LutArgs a) {
  lut_cluster_body<T, SHARED, false, false, CodeT>(a);
}

}  // namespace lutnn

#define LUTNN_DISPATCH_CODES(FN, CODE, ...)                                         \
  (x_bf16 ? (shared ? FN<fused_decode_kernel<__nv_bfloat16, true, CODE>>(__VA_ARGS__)  \
                    : FN<fused_decode_kernel<__nv_bfloat16, false, CODE>>(__VA_ARGS__)) \
          : (shared ? FN<fused_decode_kernel<float, true, CODE>>(__VA_ARGS__)          \
                    : FN<fused_decode_kernel<float, false, CODE>>(__VA_ARGS__)))
// codes held as uint16_t above K = 256 (lut_common.cuh, lut_cluster_body)
#define LUTNN_DISPATCH(FN, ...)                                                      \
  (wide ? LUTNN_DISPATCH_CODES(FN, uint16_t, __VA_ARGS__)                            \
        : LUTNN_DISPATCH_CODES(FN, uint8_t, __VA_ARGS__))

// Plain C entry point (loaded with ctypes). geo: kGeoInts launch parameters
// (LutArgs, from S to vec4). Returns a cudaError_t: 0 on a successful launch.
// Launches on `stream` and does not synchronise.
extern "C" int lutnn_fused_decode(const void* x, const void* centroids, const void* table_q,
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
extern "C" int lutnn_fused_decode_clusters(int x_bf16, int scale_c, int wide, int S,
                                           int smem_bytes, int* out) {
  using namespace lutnn;
  const bool shared = scale_c == 1;
  return LUTNN_DISPATCH(max_clusters, S, smem_bytes, out);
}

#ifdef LUTNN_PHASE_TRACE
// The phase timestamps of the last launches (kernels/phase_trace.py).
extern "C" int lutnn_phase_read(void* out, int n) {
  return cudaMemcpyFromSymbol(out, lutnn::lutnn_phase_log, (size_t)n * sizeof(long long));
}
#endif
