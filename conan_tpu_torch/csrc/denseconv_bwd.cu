// K3 dw: the weight gradient of the dense stride-1 1-D convolution at the
// "default" training rung, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's dense conv and its gradient are
// XLA (conan_tpu/ops/conv.py:68-76). It was added for the reason K3 was
// (csrc/denseconv.cu): cuDNN's bf16 weight gradient returns bf16 where JAX's
// DEFAULT returns fp32. It computes
//   dw[n, c, j] = sum_b sum_t bf(gy[b, t, n]) * bf(x[b, t + j*dil - pad_l, c])
// with x [B, T, C] and gy [B, T_out, N] channels-last bf16 (handed over
// rounded), x zero outside [0, T), the products exact and summed in fp32, dw
// [N, C, K] fp32.
//
// What bounds it on the card: its bf16 products at the dense peak on the
// wide layers, its bytes on the narrow ones (the forward's bound). Per tap it
// is an [N, C] product reduced over the B*T_out rows, the outer dimension of
// both channels-last operands. The design:
//   - both operands are read in place as MN-major wgmma operands (the
//     transposes bf16 allows): a chunk of 64 rows t0 .. of one batch row is
//     staged by TMA as planes of 8 channels, each plane a run of 16-byte
//     rows (one time step's 8 channels), so 8 rows of a plane are a core
//     matrix and any row can start one: gy's 64 rows for the block's
//     NWG * 64 out-channels (A, M = out-channels), and x's window of 64 +
//     (TPW - 1) * dil rows from t0 + j0*dil - pad_l for its 64 in-channels
//     (B, N = in-channels), whose tap j0 + p is the same planes p*dil rows
//     on. The zero fill of TMA outside [0, T) and [0, T_out) stands for the
//     padding and the chunk's ragged end;
//   - a block is (64 in-channels, NWG * 64 out-channels, a run of TPW taps,
//     one of `splits` contiguous ranges of the reduction's chunks): each
//     consumer warpgroup holds TPW m64n64 accumulators (its 64
//     out-channels, each tap), so a chunk's gy tile feeds TPW products and
//     its x window NWG * TPW; one producer warp keeps `stages` chunks in
//     flight on mbarriers;
//   - a slot past the last tap multiplies the last tap again and is not
//     stored (a branch around a wgmma makes ptxas serialize them);
//   - each block writes its fp32 partial sums to scratch the wrapper
//     allocates; a second launch (denseconv_wgrad_reduce_kernel) adds the
//     splits in a fixed order and writes dw in its [N, C, K] layout. No
//     float atomics: the same inputs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "k2bf16.cuh"

namespace {

constexpr int kRows = 64;         // rows (times t) of the reduction a chunk
constexpr int kPlane = kRows * 16;   // bytes of one 8-channel plane of gy's chunk
constexpr int kMaxWindow = 256;   // x window rows a box holds at most

struct WgradArgs {
  float* part;      // [splits][K][N][C] fp32 partial sums
  int B, T_out, C, N, K, dil, pad_l;
  int runs;         // runs of TPW taps: ceil(K / TPW)
  int n_c, n_n;     // tiles of 64 in-channels, of NWG * 64 out-channels
  int splits;       // ranges of the reduction's chunks
  int cpr;          // chunks a batch row: ceil(T_out / 64)
  int n_chunks;     // B * cpr
  int win_rows;     // x window rows a chunk (a multiple of 8)
  int stages;
};

size_t wgrad_smem_bytes(int nwg, int win_rows, int stages) {
  return 1024 + (size_t)stages * ((size_t)nwg * 8 * kPlane + 8 * (size_t)win_rows * 16) +
         16 * (size_t)stages;
}

// shared-memory descriptor of an MN-major tile without swizzle: core
// matrices of 8 k rows x 16 bytes (8 MN values) stored contiguously, the
// next 8 k values 128 bytes on (the leading byte offset), the next 8 MN
// values `mn_stride` bytes on (the stride byte offset)
__device__ __forceinline__ uint64_t mn_desc(uint32_t saddr, uint32_t mn_stride) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((mn_stride >> 4) & 0x3FFF) << 32);
}

template <int TPW, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
denseconv_wgrad_kernel(const __grid_constant__ CUtensorMap gmap,
                       const __grid_constant__ CUtensorMap xmap, const WgradArgs a) {
  constexpr int GY_BYTES = NWG * 8 * kPlane;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int x_plane = a.win_rows * 16;
  const int stage_bytes = GY_BYTES + 8 * x_plane;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.stages * stage_bytes);
  uint64_t* empty = full + a.stages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // block: in-channel tile fastest, then out-channel tile, run, split
  int rest = blockIdx.x;
  const int ct = rest % a.n_c;
  rest /= a.n_c;
  const int nt = rest % a.n_n;
  rest /= a.n_n;
  const int run = rest % a.runs, sp = rest / a.runs;
  const int c0 = ct * 64, n0 = nt * NWG * 64, j0 = run * TPW;
  const int c_begin = (int)((long long)sp * a.n_chunks / a.splits);
  const int c_end = (int)((long long)(sp + 1) * a.n_chunks / a.splits);

  if (warp == NWG * 4) {
    // the producer: chunk c's gy planes (NWG * 8) and x window planes (8)
    if (lane != 0) return;
    for (int c = c_begin, i = 0; c < c_end; ++c, ++i) {
      const int st = i % a.stages;
      mbar_wait(empty + st, ((i / a.stages) & 1) ^ 1);
      mbar_expect_tx(full + st, stage_bytes);
      const int b = c / a.cpr, t0 = (c - b * a.cpr) * kRows;
      unsigned char* s = ring + st * stage_bytes;
      for (int p = 0; p < NWG * 8; ++p)
        tma_load_3d(s + p * kPlane, &gmap, full + st, n0 + 8 * p, t0, b);
      for (int p = 0; p < 8; ++p)
        tma_load_3d(s + GY_BYTES + p * x_plane, &xmap, full + st, c0 + 8 * p,
                    t0 + j0 * a.dil - a.pad_l, b);
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;
  // each slot's first window row (a slot past the last tap takes the last)
  int row[TPW];
#pragma unroll
  for (int p = 0; p < TPW; ++p) row[p] = (min(j0 + p, a.K - 1) - j0) * a.dil;
  float acc[TPW][32];
  for (int c = c_begin, i = 0; c < c_end; ++c, ++i) {
    const int st = i % a.stages;
    mbar_wait(full + st, (i / a.stages) & 1);
    const uint32_t s = smem_u32(ring + st * stage_bytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      const uint64_t ad = mn_desc(s + wg * 8 * kPlane + ks * 256, kPlane);
#pragma unroll
      for (int p = 0; p < TPW; ++p)
        Wgmma<64>::template mma<1, 1>(acc[p], ad,
                                      mn_desc(s + GY_BYTES + (row[p] + ks * 16) * 16, x_plane),
                                      i > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (i - 1) % a.stages);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < TPW; ++p) fence_acc(acc[p]);

  // acc[p] row m (out-channel n0 + 64 wg + m), column q (in-channel c0 + q)
#pragma unroll
  for (int p = 0; p < TPW; ++p) {
    const int j = j0 + p;
    if (j >= a.K) continue;
    float* pr = a.part + ((size_t)sp * a.K + j) * a.N * a.C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wg * 64 + wl * 16 + gid + 8 * h;
      if (n >= a.N) continue;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int ci = c0 + 8 * nb + 2 * tig;   // C is a multiple of 8: ci + 1 < C too
        if (ci < a.C)
          *reinterpret_cast<float2*>(pr + (size_t)n * a.C + ci) =
              make_float2(acc[p][4 * nb + 2 * h], acc[p][4 * nb + 2 * h + 1]);
      }
    }
  }
}

// dw[n, c, j] = sum over splits sp (in order) of part[sp][j][n][c]. A block
// an out-channel n: its C x K sums into shared memory, then written in dw's
// order (c, then j), contiguous.
__global__ void denseconv_wgrad_reduce_kernel(const float* __restrict__ part,
                                              float* __restrict__ dw, int N, int C, int K,
                                              int splits) {
  extern __shared__ float sums[];   // [C][K]
  const int n = blockIdx.x;
  const size_t split_floats = (size_t)K * N * C;
  for (int e = threadIdx.x; e < K * C; e += blockDim.x) {
    const int j = e / C, c = e - j * C;
    const float* src = part + ((size_t)j * N + n) * C + c;
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += src[sp * split_floats];
    sums[c * K + j] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < K * C; e += blockDim.x) dw[(size_t)n * C * K + e] = sums[e];
}

// a 3-D map over a bf16 [B, T, C] channels-last tensor: boxes of one batch
// row, `rows` rows x 8 channels (one plane), no swizzle, zero fill outside
CUresult plane_map(CUtensorMap* map, const void* t, int B, int T, int C, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return CUDA_ERROR_NOT_INITIALIZED;
  const cuuint64_t dim[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t stride[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t box[3] = {8, (cuuint32_t)rows, 1}, ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(t), dim, stride, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int TPW, int NWG>
int launch_wgrad(const CUtensorMap* maps, const WgradArgs& a, size_t blocks, size_t smem,
                 cudaStream_t s) {
  auto kernel = denseconv_wgrad_kernel<TPW, NWG>;
  static size_t opted[conan::kMaxDevices] = {};
  const cudaError_t e = conan::allow_dynamic_smem(kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, NWG * 128 + 32, smem, s>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

// The instantiations (TPW taps a warpgroup, NWG warpgroups);
// ops/denseconv.py:dense_wgrad_tiles plans among them.
#define DENSECONV_WGRAD_BUILT(X) \
  X(1, 1) X(2, 1) X(3, 1) X(4, 1) X(1, 2) X(2, 2) X(3, 2) X(4, 2)

int dispatch_wgrad(const CUtensorMap* maps, const WgradArgs& a, int tpw, int nwg, size_t blocks,
                   size_t smem, cudaStream_t s) {
#define DENSECONV_WGRAD_TRY(TPW, NWG) \
  if (tpw == TPW && nwg == NWG) return launch_wgrad<TPW, NWG>(maps, a, blocks, smem, s);
  DENSECONV_WGRAD_BUILT(DENSECONV_WGRAD_TRY)
#undef DENSECONV_WGRAD_TRY
  return (int)cudaErrorInvalidValue;   // not instantiated
}

}  // namespace

// K3 dw as the wrapper calls it. x [B, T, C] and gy [B, T_out, N] bf16
// contiguous (16-byte aligned); part the fp32 scratch of splits x K x N x C
// floats; dw [N, C, K] fp32, every element written; the plan (tpw taps a
// warpgroup, nwg warpgroups, stages, win_rows, splits) from
// ops/denseconv.py:dense_wgrad_plan, which alone chooses it: this entry
// only checks it. Two launches on `stream`; returns cudaGetLastError()
// after them, cudaErrorInvalidValue for what the kernel does not take.
extern "C" int denseconv_weight_grad(const void* x, const void* gy, float* part, float* dw, int B,
                                     int T, int C, int T_out, int N, int K, int dil, int pad_l,
                                     int tpw, int nwg, int stages, int win_rows, int splits,
                                     void* stream) {
  if (B < 1 || T < 1 || T_out < 1 || C < 8 || C % 8 || N < 8 || N % 8 || K < 1 || dil < 1 ||
      tpw < 1 || tpw > K || nwg < 1 || nwg > 2 || stages < 2 || splits < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(gy) % 16 ||
      reinterpret_cast<uintptr_t>(part) % 16 || (size_t)C * K * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (win_rows % 8 || win_rows < kRows + (tpw - 1) * dil || win_rows > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgrad_smem_bytes(nwg, win_rows, stages);
  const int cpr = (T_out + kRows - 1) / kRows;
  const long long n_chunks = (long long)B * cpr;
  const int runs = (K + tpw - 1) / tpw, n_c = (C + 63) / 64, n_n = (N + nwg * 64 - 1) / (nwg * 64);
  const long long blocks = (long long)n_c * n_n * runs * splits;
  if (smem > 227 * 1024 || n_chunks >= (1LL << 31) || splits > n_chunks ||
      blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  if (plane_map(&maps[0], gy, B, T_out, N, kRows) != CUDA_SUCCESS ||
      plane_map(&maps[1], x, B, T, C, win_rows) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const WgradArgs a{part, B,   T_out, C,   N,      K,    dil, pad_l,
                    runs, n_c, n_n,   splits, cpr, (int)n_chunks, win_rows, stages};
  const cudaStream_t s = (cudaStream_t)stream;
  int err = dispatch_wgrad(maps, a, tpw, nwg, (size_t)blocks, smem, s);
  if (err) return err;
  denseconv_wgrad_reduce_kernel<<<N, 256, (size_t)C * K * 4, s>>>(part, dw, N, C, K, splits);
  return (int)cudaGetLastError();
}
