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
//     tile is NWG * MI slots, MI a consumer warpgroup, and BN output
//     channels; blocks are persistent and walk the tiles, so one tile's
//     epilogue runs while the producer loads the next tile's operands;
//   - the reduction runs over (64-channel chunk c, tap j). For each chunk and
//     run of `tpr` taps, the producer stages every slot's x window once: rows
//     t0 + r*tpr*dil - pad_l .. + win_rows of the slot's batch row, 64
//     channels (128-byte rows, 128-byte swizzle), one TMA box whose zero fill
//     outside the tensor is the conv's padding, causal or symmetric, and the
//     channels past C. The swizzle follows the shared-memory address, so any
//     row can start a K-major A: tap j's A is the same box (j - r*tpr)*dil
//     rows on, a descriptor offset, and each x row is read from L2 once a
//     chunk and run (once a chunk where the window holds every tap) instead
//     of once a tap;
//   - B is the weights, [N, K*Cp] bf16 K-major (Cp = C rounded up to 64,
//     zero channels past C), laid out once a call by denseconv_weights_kernel
//     (plain version ops/denseconv.py:kernel_weights); step (c, j) is its
//     column 64 * (j * C/64 + c), one TMA box of BN rows (128-byte swizzle)
//     in a ring of `wstages`; each box feeds MI products a warpgroup, so a
//     weight byte serves 64 * NWG * MI output rows;
//   - one producer warp keeps the ring and `xstages` window buffers (more
//     where a window serves fewer taps) in flight on mbarriers; each
//     consumer warpgroup issues a step's MI x 4 wgmma m64nBNk16 (A and B
//     from shared memory), keeps one step in flight
//     (wgmma.wait_group 1) and releases the one before, and a window once
//     the step after its last has been issued;
//   - the epilogue adds the bias in fp32 and stores y with 8-byte stores,
//     masked past T_out and N.
//
// The input gradient is the same kernel: dx is the conv of gy with the taps
// flipped and the channel roles swapped (its C is the forward's N), padded
// by dil*(K-1) - pad_l on the left (negative, or past T: the window's zero
// fill); denseconv_weights_kernel lays those weights out in the same C call
// (flip = 1; plain version ops/denseconv.py:kernel_weights_dx).

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "k2bf16.cuh"

namespace {

constexpr int kSlot = 64;     // outputs of one batch row an m64 slot holds
constexpr int kChunk = 64;    // input channels a window (128-byte rows)
constexpr int kNwg = 2;       // consumer warpgroups a block
constexpr int kMaxWindow = 256;   // window rows a TMA box holds at most

struct DenseArgs {
  float* y;
  const float* bias;   // [N] or null
  int B, T_out, N, K, dil, pad_l;
  int nci;             // 64-channel chunks of the input: ceil(C / 64)
  int slots;           // m64 slots a batch row: ceil(T_out / 64)
  int n_n_tiles;       // BN-wide tiles of N
  int n_tiles;         // M tiles x N tiles
  int tpr;             // taps a window run
  int win_rows;        // rows of a slot's window (a multiple of 8, at most 256)
  int wstages;         // weight boxes in flight
  int xstages;         // window buffers in flight
};

size_t dense_smem_bytes(int bn, int mi, int win_rows, int wstages, int xstages) {
  return 1024 + (size_t)wstages * bn * 128 + (size_t)xstages * kNwg * mi * win_rows * 128 +
         16 * ((size_t)wstages + xstages);
}

template <int BN, int MI>
__global__ void __launch_bounds__(kNwg * 128 + 32, 1)
denseconv_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap, const DenseArgs a) {
  constexpr int W_BYTES = BN * 128;   // one weight box
  constexpr int SLOTS = kNwg * MI;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int slot_bytes = a.win_rows * 128;    // a slot's window
  const int win_bytes = SLOTS * slot_bytes;   // one window buffer
  unsigned char* wins = wring + a.wstages * W_BYTES;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(wins + a.xstages * win_bytes);
  uint64_t* wempty = wfull + a.wstages;
  uint64_t* xfull = wempty + a.wstages;
  uint64_t* xempty = xfull + a.xstages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.wstages; ++i) {
      mbar_init(wfull + i, 1);
      mbar_init(wempty + i, kNwg * 4);   // lane 0 of each consumer warp
    }
    for (int i = 0; i < a.xstages; ++i) {
      mbar_init(xfull + i, 1);
      mbar_init(xempty + i, kNwg * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kNwg * 4) {
    // the producer: for each tile, its steps (chunk c, tap j) in order; a
    // step whose tap starts a run first loads the slots' windows (a slot
    // past the last batch row reads rows past B: zero fill)
    if (lane != 0) return;
    int it = 0, wu = 0;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      const int nt = tile % a.n_n_tiles, mt = tile / a.n_n_tiles;
      for (int c = 0, j = 0, r = 0, jr = 0; c < a.nci; ++it) {
        if (jr == 0) {
          const int xb = wu % a.xstages;
          mbar_wait(xempty + xb, ((wu / a.xstages) & 1) ^ 1);
          mbar_expect_tx(xfull + xb, (uint32_t)win_bytes);
          for (int s = 0; s < SLOTS; ++s) {
            const int v = mt * SLOTS + s, b = v / a.slots;
            tma_load_3d(wins + xb * win_bytes + s * slot_bytes, &xmap, xfull + xb, c * kChunk,
                        (v - b * a.slots) * kSlot + r * a.tpr * a.dil - a.pad_l, b);
          }
          ++wu;
        }
        const int st = it % a.wstages;
        mbar_wait(wempty + st, ((it / a.wstages) & 1) ^ 1);
        mbar_expect_tx(wfull + st, W_BYTES);
        tma_load_2d(wring + st * W_BYTES, &wmap, wfull + st, (j * a.nci + c) * kChunk, nt * BN);
        // the next step: tap j + 1 (a new run every tpr taps), or the next chunk
        if (++jr == a.tpr) jr = 0, ++r;
        if (++j == a.K) j = 0, r = 0, jr = 0, ++c;
      }
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t wring_s = smem_u32(wring), wins_s = smem_u32(wins);
  float acc[MI][BN / 2];
  int it = 0, wu = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int nt = tile % a.n_n_tiles, mt = tile / a.n_n_tiles;
    for (int c = 0, j = 0, jr = 0, q = 0; c < a.nci; ++it, ++q) {
      // this step's window: a new one at each run's first tap (waited on at
      // every step, with no branch between the wgmma groups in flight)
      wu += jr == 0;
      const int xb = (wu - 1) % a.xstages;
      mbar_wait(xfull + xb, ((wu - 1) / a.xstages) & 1);
      const uint32_t win_s = wins_s + xb * win_bytes + wg * MI * slot_bytes;
      const int st = it % a.wstages;
      mbar_wait(wfull + st, (it / a.wstages) & 1);
      const uint32_t ws = wring_s + st * W_BYTES;
      const uint32_t a_row = win_s + jr * a.dil * 128;
      wgmma_fence();
      // the step's k-steps: 16 channels (32 bytes of a row) each; the
      // channels past C are zeros of the window's fill and of the layout
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = b_desc(ws + kk * 32);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          Wgmma<BN>::mma(acc[mi], b_desc(a_row + mi * slot_bytes + kk * 32), bd, q > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the step before this one is done: release its operands
      if (q > 0) {
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(wempty + (it - 1) % a.wstages);
          if (jr == 0) mbar_arrive(xempty + (wu - 2) % a.xstages);   // the run before ended
        }
      }
      if (++jr == a.tpr) jr = 0;
      if (++j == a.K) j = 0, jr = 0, ++c;
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(wempty + (it - 1) % a.wstages);
      mbar_arrive(xempty + (wu - 1) % a.xstages);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) fence_acc(acc[mi]);

    const int n_base = nt * BN;
    // each output row this thread stores (null past B's slots or T_out)
    float* yr[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int v = mt * SLOTS + wg * MI + mi, b = v / a.slots;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = (v - b * a.slots) * kSlot + wl * 16 + gid + 8 * h;
        yr[mi][h] = v < a.B * a.slots && t < a.T_out ? a.y + ((size_t)b * a.T_out + t) * a.N
                                                     : nullptr;
      }
    }
    // a column pair at a time: its bias (read-only loads, free to run ahead
    // of the stores), then its stores
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int n = n_base + 8 * nb + 2 * tig;   // N is a multiple of 8: n + 1 < N too
      if (n >= a.N) break;
      const float b0 = a.bias ? __ldg(a.bias + n) : 0.f;
      const float b1 = a.bias ? __ldg(a.bias + n + 1) : 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (yr[mi][h])
            *reinterpret_cast<float2*>(yr[mi][h] + n) =
                make_float2(acc[mi][4 * nb + 2 * h] + b0, acc[mi][4 * nb + 2 * h + 1] + b1);
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
// [1][win_rows][64]: a slot's window, 128-byte swizzle, zero fill outside)
int dense_maps(const void* x, const void* wq, int B, int T, int C, int N, int K, int bn,
               int win_rows, CUtensorMap* maps) {
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
  e = sw128_rows_map(&maps[1], x, B, T, C, win_rows);
  return e == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the blocks a launch: as many as the SMs hold at once (by shared memory and
// registers), at most one a tile
template <typename Kernel>
int dense_grid(Kernel kernel, size_t smem, int n_tiles) {
  static int sms[conan::kMaxDevices] = {};
  int dev = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= conan::kMaxDevices) return 0;
  if (!sms[dev] && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) !=
                       cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kNwg * 128 + 32, smem) !=
          cudaSuccess ||
      per_sm < 1)
    return 0;
  return n_tiles < per_sm * sms[dev] ? n_tiles : per_sm * sms[dev];
}

template <int BN, int MI>
int launch_dense(const CUtensorMap* maps, const DenseArgs& a, cudaStream_t s) {
  const size_t smem = dense_smem_bytes(BN, MI, a.win_rows, a.wstages, a.xstages);
  auto kernel = denseconv_kernel<BN, MI>;
  static size_t opted[conan::kMaxDevices] = {};
  const cudaError_t e = conan::allow_dynamic_smem(kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const int grid = dense_grid(kernel, smem, a.n_tiles);
  if (grid < 1) return (int)cudaErrorInvalidDevice;
  kernel<<<grid, kNwg * 128 + 32, smem, s>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

// The instantiated tiles (BN, MI); ops/denseconv.py:DENSE_TILES plans among
// them, with the window's taps and the weight stages.
#define DENSECONV_BUILT(X) \
  X(128, 2)                \
  X(128, 1)                \
  X(64, 2)                 \
  X(64, 1)

// the geometry's arguments, or false for what the kernel does not take
bool dense_args(int B, int T_out, int C, int N, int K, int dil, int pad_l, int bn, int mi,
                int tpr, int win_rows, int wstages, int xstages, DenseArgs* a) {
  if (B < 1 || T_out < 1 || C < 8 || C % 8 || N < 8 || N % 8 || K < 1 || dil < 1 || tpr < 1 ||
      tpr > K || wstages < 2 || xstages < 2 || win_rows % 8 || win_rows > kMaxWindow ||
      (long long)win_rows < kSlot + (long long)(tpr - 1) * dil ||
      dense_smem_bytes(bn, mi, win_rows, wstages, xstages) > 227 * 1024)
    return false;
  bool built = false;
#define DENSECONV_IS(BN, MI) built |= bn == BN && mi == MI;
  DENSECONV_BUILT(DENSECONV_IS)
#undef DENSECONV_IS
  if (!built || (long long)(K - 1) * dil + T_out + (long long)pad_l >= (1LL << 30) ||
      (long long)pad_l <= -(1LL << 30))
    return false;
  const int slots = (T_out + kSlot - 1) / kSlot, n_n = (N + bn - 1) / bn;
  const long long m_tiles = ((long long)B * slots + kNwg * mi - 1) / (kNwg * mi);
  if (m_tiles * n_n >= (1LL << 31) || (long long)B * slots >= (1LL << 31)) return false;
  *a = DenseArgs{nullptr, nullptr, B,     T_out, N, K, dil, pad_l, (C + kChunk - 1) / kChunk,
                 slots,   n_n,     (int)(m_tiles * n_n), tpr, win_rows, wstages, xstages};
  return true;
}

int dispatch_dense(const CUtensorMap* maps, const DenseArgs& a, int bn, int mi, cudaStream_t s) {
#define DENSECONV_TRY(BN, MI) \
  if (bn == BN && mi == MI) return launch_dense<BN, MI>(maps, a, s);
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

// K3's tensor maps (256 bytes at `maps`) over x [B, T, C] bf16 (windows of
// win_rows rows) and wq for tiles of bn output channels
extern "C" int denseconv_describe(const void* x, const void* wq, int B, int T, int C, int N,
                                  int K, int bn, int win_rows, void* maps) {
  if (!aligned16(x) || !aligned16(wq) || B < 1 || T < 1 || C % 8 || C < 8 || win_rows < 8 ||
      win_rows > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  return dense_maps(x, wq, B, T, C, N, K, bn, win_rows, static_cast<CUtensorMap*>(maps));
}

// the conv alone, on maps from denseconv_describe
extern "C" int denseconv_run(const void* maps, const float* bias, float* y, int B, int T_out,
                             int C, int N, int K, int dil, int pad_l, int bn, int mi, int tpr,
                             int win_rows, int wstages, int xstages, void* stream) {
  DenseArgs a;
  if (!aligned16(y) ||
      !dense_args(B, T_out, C, N, K, dil, pad_l, bn, mi, tpr, win_rows, wstages, xstages, &a))
    return (int)cudaErrorInvalidValue;
  a.y = y;
  a.bias = bias;
  return dispatch_dense(static_cast<const CUtensorMap*>(maps), a, bn, mi, (cudaStream_t)stream);
}

// K3 as the wrapper calls it: the conv of x [B, T, C] bf16 (channels-last,
// contiguous, 16-byte aligned) with w fp32 contiguous ([N, C, K], or with
// flip the forward's [C, N, K]: the input gradient), output t reading rows
// t + j*dil - pad_l (pad_l may be negative), plus bias [N] fp32 (or null),
// into y [B, T_out, N] fp32; wq the [N, K*Cp] bf16 scratch the weights are
// laid out in (16-byte aligned); the plan (bn, mi, tpr, win_rows, wstages,
// xstages) from ops/denseconv.py:dense_plan, which alone chooses it: this entry
// checks it. Two launches on `stream`; returns cudaGetLastError() after
// them, cudaErrorInvalidValue for what the kernel does not take.
extern "C" int denseconv_forward(const void* x, const float* w, void* wq, const float* bias,
                                 float* y, int B, int T, int C, int T_out, int N, int K, int dil,
                                 int pad_l, int flip, int bn, int mi, int tpr, int win_rows,
                                 int wstages, int xstages, void* stream) {
  DenseArgs a;
  if (!aligned16(x) || !aligned16(wq) || !aligned16(y) || T < 1 ||
      !dense_args(B, T_out, C, N, K, dil, pad_l, bn, mi, tpr, win_rows, wstages, xstages, &a))
    return (int)cudaErrorInvalidValue;
  a.y = y;
  a.bias = bias;
  CUtensorMap maps[2];
  int err = dense_maps(x, wq, B, T, C, N, K, bn, win_rows, maps);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((err = dense_weights(w, wq, N, C, K, flip, s))) return err;
  return dispatch_dense(maps, a, bn, mi, s);
}
