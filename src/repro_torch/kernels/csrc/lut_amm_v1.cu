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
// The plain version (ref.lut_amm_v1_plain) adds in the same order with the
// same roundings, so kernel and plain version agree bytewise under every
// launch: the order depends on block_c alone.
//
// Design against the TPU original. The Pallas grid is (N/bn, M/bm, C/bc) with
// the codebook axis innermost and sequential: each step dequantizes its table
// tile to fp32 (t * s), contracts a one-hot against it, sums the bc codebooks
// of the step and read-modify-writes the output tile. Here the sequential C
// axis is a loop in a thread, and the launch is the fused and v2 kernels'
// cluster pipeline (lut_common.cuh, lut_cluster_body, with V1 set): a
// cluster of S blocks shares an N tile, each rank stages (16-byte cp.async)
// and encodes (encode_tile) only its share of the codebooks in chunks, as v2
// does, and pushes its codes into its peers' shared memory with st.async.
// The lookup cannot split an element's codebooks over threads (that would
// change the fp32 order), so one thread holds each element's whole sum: at a
// prefill chunk the row-split lookup over the table tile staged by TMA, at
// decode one thread per (row, column) over the tile copied to shared memory
// (or gathered from global memory where it does not fit), with the loads of
// 16 codebooks in flight before their ordered multiply-adds. Entries become
// fp32 by an exact bit trick instead of I2F (s8_to_f32), and every product
// and sum is an explicit _rn intrinsic: nvcc would contract t * s + acc
// into an FMA, a different rounding.
//
// What bounds it on this card: at decode, as for v2, the dependent chain of
// staging, encode and code exchange ahead of the lookup (the table's bytes,
// read once per N tile, take 0.6-1.9 us at the main path's sites); at a
// prefill chunk the lookup's fp32 instructions, three per element and
// codebook (dequantize, multiply, add) where the int32 kernels issue one.
//
// Shared memory: [ C x rows codes | the block's scale (of a (1, ..) scale) |
// the chunk's codebooks centroids, norms and sub-vectors | table ring | its
// mbarriers ], offsets from the wrapper (lut_amm.py, cluster_geometry).
#include "lut_common.cuh"

namespace lutnn {

template <typename T, bool SHARED, typename CodeT>
__global__ void __launch_bounds__(kThreads) lut_amm_v1_kernel(const __grid_constant__ LutArgs a) {
  lut_cluster_body<T, SHARED, true, true, CodeT>(a);
}

}  // namespace lutnn

// SHARED: a (1, ..) scale, the same for every codebook
#define LUTNN_DISPATCH_CODES(FN, CODE, ...)                                         \
  (x_bf16 ? (shared ? FN<lut_amm_v1_kernel<__nv_bfloat16, true, CODE>>(__VA_ARGS__)  \
                    : FN<lut_amm_v1_kernel<__nv_bfloat16, false, CODE>>(__VA_ARGS__)) \
          : (shared ? FN<lut_amm_v1_kernel<float, true, CODE>>(__VA_ARGS__)          \
                    : FN<lut_amm_v1_kernel<float, false, CODE>>(__VA_ARGS__)))
// codes held as uint16_t above K = 256 (lut_common.cuh, lut_cluster_body)
#define LUTNN_DISPATCH(FN, ...)                                                      \
  (wide ? LUTNN_DISPATCH_CODES(FN, uint16_t, __VA_ARGS__)                            \
        : LUTNN_DISPATCH_CODES(FN, uint8_t, __VA_ARGS__))

// Plain C entry point (loaded with ctypes), the fused and v2 kernels'
// signature; bias must be null and act none. geo: kGeoInts launch parameters
// (LutArgs, from S to vec4; block_c divides C). Returns a cudaError_t: 0 on a
// successful launch. Launches on `stream` and does not synchronise.
extern "C" int lutnn_lut_amm_v1(const void* x, const void* centroids, const void* table_q,
                                const void* scale, const void* bias, void* out, int N, int C,
                                int K, int V, int M, int scale_c, int scale_m, int x_bf16,
                                int act, const int* geo, int smem_bytes, void* stream) {
  using namespace lutnn;
  const bool shared = scale_c == 1;
  const bool wide = K > kByteK;
  LutArgs a =
      make_args(x, centroids, table_q, scale, bias, out, N, C, K, V, M, scale_m, act, geo);
  if (bias != nullptr || act != kActNone || a.block_c < 1 || C % a.block_c != 0) {
    return cudaErrorInvalidValue;
  }
  return LUTNN_DISPATCH(launch_cluster, a, smem_bytes, static_cast<cudaStream_t>(stream));
}

// How many clusters of S blocks of `smem_bytes` can be resident at once on
// this card (0: such a launch cannot run); wide: K > kByteK.
extern "C" int lutnn_lut_amm_v1_clusters(int x_bf16, int scale_c, int wide, int S,
                                         int smem_bytes, int* out) {
  using namespace lutnn;
  const bool shared = scale_c == 1;
  return LUTNN_DISPATCH(max_clusters, S, smem_bytes, out);
}
