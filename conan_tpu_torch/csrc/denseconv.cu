// K3: the dense (groups 1) stride-1 1-D convolution at the "default" training
// rung, for Hopper (sm_90a), and its input gradient.
//
// Replaces no TPU kernel: the JAX package's dense conv is XLA
// (conan_tpu/ops/conv.py:68-76, lax.conv_general_dilated at the scope's
// precision). It was added because the port's "default" rung handed these
// convs to cuDNN as bf16 tensors, and cuDNN returns a bf16 conv in bf16: one
// rounding of every result (forward, dx, dw) that JAX's DEFAULT, with its
// fp32 output, does not make. It computes
//   y[b, t, n] = bias[n] + sum_j sum_c bf(x[b, t + j*dil - pad_l, c]) * bf(w[n, c, j])
// with x [B, T, C] channels-last (handed over already rounded to bf16),
// zero outside [0, T), w [N, C, K] fp32, bf() rounding to bf16 (nearest
// even), the products exact and summed in fp32, y [B, T_out, N] fp32.
//
// What bounds it on the card: its bf16 products at the dense bf16 peak on
// the wide layers (Conan's 256 -> 512 k=31 conv: 2.9e11 FLOP against 73 MB
// of input and output at the step's 35,904 rows), its bytes on the narrow
// ones (chip_smoke.py:denseconv_bound_ms). The design, an implicit GEMM:
//   - M is output rows in m64 slots, 64 outputs of one batch row each
//     (slots = ceil(T_out / 64) a row, the rows' slots one after another); a
//     block takes NWG slots, one a consumer warpgroup, and BN output
//     channels;
//   - the reduction runs over (tap j, 64-channel chunk c). Tap j's A tile is
//     x's 64 rows t0 + j*dil - pad_l .. of the slot's batch row, channels
//     64c .. 64c + 63: one TMA box of a 3-D map over x (128-byte swizzle,
//     K-major), whose zero fill outside the tensor is the conv's padding,
//     causal or symmetric, and the channels past C; no im2col, no host pad
//     or transpose;
//   - B is the weights, [N, K*Cp] bf16 K-major (Cp = C rounded up to 64,
//     zero channels past C), laid out once a call by denseconv_weights_kernel
//     (plain version ops/denseconv.py:kernel_weights); reduction step
//     (j, c) is its column 64 * (j * C/64 + c), one TMA box of BN rows;
//   - one producer warp keeps STAGES stages (NWG A tiles and one B tile)
//     in flight on mbarriers; each consumer warpgroup issues a stage's four
//     wgmma m64nBNk16 (A and B from shared memory), keeps one stage in
//     flight (wgmma.wait_group 1) and releases the one before;
//   - the epilogue adds the bias in fp32 and stores y with 8-byte stores,
//     masked past T_out and N.
// It reads each x row once a tap from L2 (K boxes overlap); a window of
// rows read once and indexed a tap at a time is the next step where it
// trails its bound.
//
// The input gradient is the same kernel: dx is the conv of gy with the taps
// flipped and the channel roles swapped (its C is the forward's N), padded
// by dil*(K-1) - pad_l on the left; denseconv_weights_kernel lays those
// weights out in the same C call (flip = 1; plain version
// ops/denseconv.py:kernel_weights_dx).

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "k2bf16.cuh"

namespace {

constexpr int kSlot = 64;     // outputs of one batch row an m64 slot holds
constexpr int kChunk = 64;    // input channels a reduction step (one 128-byte row)
constexpr int kTileA = kSlot * kChunk * 2;   // bytes of one A box

struct DenseArgs {
  float* y;
  const float* bias;   // [N] or null
  int B, T_out, N, K, dil, pad_l;
  int nci;             // 64-channel chunks of the input: ceil(C / 64)
  int slots;           // m64 slots a batch row: ceil(T_out / 64)
  int n_n_tiles;       // BN-wide tiles of N
  int stages;
};

size_t dense_smem_bytes(int bn, int nwg, int stages) {
  return 1024 + (size_t)stages * (nwg * kTileA + bn * 128) + 16 * (size_t)stages;
}

template <int BN, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
denseconv_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap, const DenseArgs a) {
  constexpr int STAGE_BYTES = NWG * kTileA + BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.stages * STAGE_BYTES);
  uint64_t* empty = full + a.stages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, NWG * 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nt = blockIdx.x % a.n_n_tiles, mt = blockIdx.x / a.n_n_tiles;
  const int n0 = nt * BN;
  const int n_k = a.K * a.nci;   // reduction steps: (tap, 64-channel chunk)

  if (warp == NWG * 4) {
    // the producer: each step's NWG A boxes (a slot past the last batch row
    // reads rows past B: zero fill) and its B box
    if (lane != 0) return;
    for (int it = 0; it < n_k; ++it) {
      const int st = it % a.stages;
      mbar_wait(empty + st, ((it / a.stages) & 1) ^ 1);
      mbar_expect_tx(full + st, STAGE_BYTES);
      const int j = it / a.nci, c = it - j * a.nci;
      unsigned char* s = ring + st * STAGE_BYTES;
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        const int v = mt * NWG + w, b = v / a.slots;
        tma_load_3d(s + w * kTileA, &xmap, full + st, c * kChunk,
                    (v - b * a.slots) * kSlot + j * a.dil - a.pad_l, b);
      }
      tma_load_2d(s + NWG * kTileA, &wmap, full + st, it * kChunk, n0);
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[BN / 2];
  for (int it = 0; it < n_k; ++it) {
    const int st = it % a.stages;
    mbar_wait(full + st, (it / a.stages) & 1);
    const uint32_t s = smem_u32(ring + st * STAGE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // 16 channels a k-step: 32 bytes along the swizzled row
      Wgmma<BN>::mma(acc, b_desc(s + wg * kTileA + kk * 32),
                     b_desc(s + NWG * kTileA + kk * 32), it > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // the step before this one is done: release its stage
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (it - 1) % a.stages);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  const int v = mt * NWG + wg;
  if (v >= a.B * a.slots) return;
  const int b = v / a.slots, t_base = (v - b * a.slots) * kSlot;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t_base + wl * 16 + gid + 8 * h;
    if (t >= a.T_out) continue;
    float* yr = a.y + ((size_t)b * a.T_out + t) * a.N;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int n = n0 + 8 * nb + 2 * tig;   // N is a multiple of 8: n + 1 < N too
      if (n >= a.N) continue;
      float2 o = make_float2(acc[4 * nb + 2 * h], acc[4 * nb + 2 * h + 1]);
      if (a.bias) {
        o.x += a.bias[n];
        o.y += a.bias[n + 1];
      }
      *reinterpret_cast<float2*>(yr + n) = o;
    }
  }
}

// wq[n, j*Cp + c] = bf16(flip ? w[c, n, K-1-j] : w[n, c, j]), 0 for c >= C:
// the weights of the conv with C input and N output channels as
// denseconv_kernel's TMA reads them (w [N, C, K]; flipped, the forward's
// [C, N, K], for its input gradient). One thread an element, in wq's order.
__global__ void denseconv_weights_kernel(const float* __restrict__ w,
                                         __nv_bfloat16* __restrict__ wq, int N, int C, int Cp,
                                         int K, int flip) {
  const size_t row = (size_t)K * Cp, total = (size_t)N * row;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(e / row), r = (int)(e - n * row), j = r / Cp, c = r - j * Cp;
    float v = 0.f;
    if (c < C) v = flip ? w[((size_t)c * N + n) * K + (K - 1 - j)] : w[((size_t)n * C + c) * K + j];
    wq[e] = __float2bfloat16_rn(v);
  }
}

// the weights' and x's tensor maps: maps[0] over wq [N, K*Cp] bf16 (boxes
// [bn][64], 128-byte swizzle), maps[1] over x [B, T, C] bf16 (boxes
// [1][64][64], 128-byte swizzle, zero fill outside)
int dense_maps(const void* x, const void* wq, int B, int T, int C, int N, int K, int bn,
               CUtensorMap* maps) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorInitializationError;
  const int cp = round_up(C, kChunk);
  const cuuint64_t w_dim[2] = {(cuuint64_t)K * cp, (cuuint64_t)N};
  const cuuint64_t w_stride[1] = {(cuuint64_t)K * cp * 2};
  const cuuint32_t w_box[2] = {kChunk, (cuuint32_t)bn}, ones[3] = {1, 1, 1};
  CUresult e = encode(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wq), w_dim,
                      w_stride, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (e != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t x_dim[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t x_stride[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t x_box[3] = {kChunk, kSlot, 1};
  e = encode(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), x_dim, x_stride,
             x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return e == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int NWG>
int launch_dense(const CUtensorMap* maps, const DenseArgs& a, size_t n_tiles, cudaStream_t s) {
  const size_t smem = dense_smem_bytes(BN, NWG, a.stages);
  auto kernel = denseconv_kernel<BN, NWG>;
  static size_t opted[conan::kMaxDevices] = {};
  const cudaError_t e = conan::allow_dynamic_smem(kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)n_tiles, NWG * 128 + 32, smem, s>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

// The instantiated tiles (BN, NWG); ops/denseconv.py:DENSE_TILES plans
// among them, with the stages.
#define DENSECONV_BUILT(X) \
  X(128, 2)                \
  X(64, 2)

// the geometry's arguments and tile count, or false for what the kernel
// does not take
bool dense_args(int B, int T_out, int C, int N, int K, int dil, int pad_l, int bn, int nwg,
                int stages, DenseArgs* a, size_t* n_tiles) {
  if (B < 1 || T_out < 1 || C < 8 || C % 8 || N < 8 || N % 8 || K < 1 || dil < 1 ||
      stages < 2 || dense_smem_bytes(bn, nwg, stages) > 227 * 1024)
    return false;
  bool built = false;
#define DENSECONV_IS(BN, NWG) built |= bn == BN && nwg == NWG;
  DENSECONV_BUILT(DENSECONV_IS)
#undef DENSECONV_IS
  if (!built || (long long)(K - 1) * dil + T_out + (long long)pad_l >= (1LL << 30)) return false;
  const int slots = (T_out + kSlot - 1) / kSlot, n_n = (N + bn - 1) / bn;
  const long long m_tiles = ((long long)B * slots + nwg - 1) / nwg;
  if (m_tiles * n_n >= (1LL << 31)) return false;
  *a = DenseArgs{nullptr, nullptr, B, T_out, N, K, dil, pad_l, (C + kChunk - 1) / kChunk, slots,
                 n_n, stages};
  *n_tiles = (size_t)(m_tiles * n_n);
  return true;
}

int dispatch_dense(const CUtensorMap* maps, const DenseArgs& a, int bn, int nwg, size_t n_tiles,
                   cudaStream_t s) {
#define DENSECONV_TRY(BN, NWG) \
  if (bn == BN && nwg == NWG) return launch_dense<BN, NWG>(maps, a, n_tiles, s);
  DENSECONV_BUILT(DENSECONV_TRY)
#undef DENSECONV_TRY
  return (int)cudaErrorInvalidValue;
}

int dense_weights(const float* w, void* wq, int N, int C, int K, int flip, cudaStream_t s) {
  const size_t total = (size_t)N * K * round_up(C, kChunk);
  const int blocks = (int)((total + 255) / 256 < 2048 ? (total + 255) / 256 : 2048);
  denseconv_weights_kernel<<<blocks, 256, 0, s>>>(w, static_cast<__nv_bfloat16*>(wq), N, C,
                                                  round_up(C, kChunk), K, flip);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// K3's weights alone: wq [N, K*Cp] bf16 (Cp = C rounded up to 64) from w
// fp32 [N, C, K], or with flip from the forward's [C, N, K] (the input
// gradient's taps flipped, channel roles swapped). Returns cudaGetLastError().
extern "C" int denseconv_weights(const float* w, void* wq, int N, int C, int K, int flip,
                                 void* stream) {
  if (N < 1 || C < 1 || K < 1 || !aligned16(wq)) return (int)cudaErrorInvalidValue;
  return dense_weights(w, wq, N, C, K, flip, (cudaStream_t)stream);
}

// K3's tensor maps (256 bytes at `maps`) over x [B, T, C] bf16 and wq for
// tiles of bn output channels
extern "C" int denseconv_describe(const void* x, const void* wq, int B, int T, int C, int N,
                                  int K, int bn, void* maps) {
  if (!aligned16(x) || !aligned16(wq) || B < 1 || T < 1 || C % 8 || C < 8)
    return (int)cudaErrorInvalidValue;
  return dense_maps(x, wq, B, T, C, N, K, bn, static_cast<CUtensorMap*>(maps));
}

// the conv alone, on maps from denseconv_describe
extern "C" int denseconv_run(const void* maps, const float* bias, float* y, int B, int T_out,
                             int C, int N, int K, int dil, int pad_l, int bn, int nwg, int stages,
                             void* stream) {
  DenseArgs a;
  size_t n_tiles;
  if (!aligned16(y) || !dense_args(B, T_out, C, N, K, dil, pad_l, bn, nwg, stages, &a, &n_tiles))
    return (int)cudaErrorInvalidValue;
  a.y = y;
  a.bias = bias;
  return dispatch_dense(static_cast<const CUtensorMap*>(maps), a, bn, nwg, n_tiles,
                        (cudaStream_t)stream);
}

// K3 as the wrapper calls it: the conv of x [B, T, C] bf16 (channels-last,
// contiguous, 16-byte aligned) with w fp32 contiguous ([N, C, K], or with
// flip the forward's [C, N, K]: the input gradient), output t reading rows
// t + j*dil - pad_l (pad_l may be negative), plus bias [N] fp32 (or null),
// into y [B, T_out, N] fp32; wq the [N, K*Cp] bf16 scratch the weights are
// laid out in (16-byte aligned); the tile (bn, nwg) and stages from
// ops/denseconv.py:dense_plan, which alone chooses them: this entry checks
// them. Two launches on `stream`; returns cudaGetLastError() after them,
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int denseconv_forward(const void* x, const float* w, void* wq, const float* bias,
                                 float* y, int B, int T, int C, int T_out, int N, int K, int dil,
                                 int pad_l, int flip, int bn, int nwg, int stages, void* stream) {
  DenseArgs a;
  size_t n_tiles;
  if (!aligned16(x) || !aligned16(wq) || !aligned16(y) || T < 1 ||
      !dense_args(B, T_out, C, N, K, dil, pad_l, bn, nwg, stages, &a, &n_tiles))
    return (int)cudaErrorInvalidValue;
  a.y = y;
  a.bias = bias;
  CUtensorMap maps[2];
  int err = dense_maps(x, wq, B, T, C, N, K, bn, maps);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((err = dense_weights(w, wq, N, C, K, flip, s))) return err;
  return dispatch_dense(maps, a, bn, nwg, n_tiles, s);
}
