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
// is an [C, N] product reduced over the B*T_out rows, the outer dimension of
// both channels-last operands. The design:
//   - both operands are read in place as MN-major wgmma operands (the
//     transposes bf16 allows) with the 128-byte swizzle: a chunk of 64 rows
//     t0 .. of one batch row is staged by TMA boxes of 64 channels x rows,
//     128-byte rows (the widest reads TMA makes): gy's 64 rows for the
//     block's NB out-channels (B, N = out-channels) and x's window of 64 +
//     (taps - 1) * dil rows from t0 + j0*dil - pad_l for its in-channels (A,
//     M = in-channels), whose tap j0 + p is the same box p*dil rows on: a
//     descriptor whose start lies inside a swizzle atom, its phase the base
//     offset. The zero fill of TMA outside [0, T) and [0, T_out) stands for
//     the padding and the chunk's ragged end;
//   - a block is (xboxes * 64 in-channels, NB out-channels, a run of taps,
//     one of `splits` contiguous ranges of the reduction's chunks); its two
//     consumer warpgroups take either the two 64-channel halves of 128
//     in-channels at the same TPW taps (xboxes 2) or the same 64 in-channels
//     at TPW taps each (xboxes 1: the run is 2*TPW taps), each holding TPW
//     m64nNB accumulators, so one staged chunk feeds every tap of the run;
//     one producer warp keeps `stages` chunks in flight on mbarriers;
//   - a tap past the last multiplies the last tap again and is not stored
//     (a branch around a wgmma makes ptxas serialize them);
//   - splits only where the tiles alone leave SMs idle: each block of a
//     split tile writes its partial sums to the plan's workspace, the last
//     to finish (an integer counter a tile, reset by it) adds them in split
//     order and writes dw; an unsplit tile writes dw itself. No float
//     atomics: the same inputs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "k2bf16.cuh"

namespace {

constexpr int kRows = 64;           // rows (times t) of the reduction a chunk
constexpr int kGyBox = kRows * 128;   // bytes of one 64-channel box of gy's chunk
constexpr int kMaxWindow = 256;     // x window rows a box holds at most
constexpr int kConsumers = 256;     // two consumer warpgroups

struct WgradArgs {
  float* dw;        // [N][C][K] fp32
  float* ws;        // split tiles' partial sums, or null (splits 1)
  int* counters;    // two zeroed counters a tile, or null (splits 1)
  int B, T_out, C, N, K, dil, pad_l;
  int xboxes;       // 64-channel x boxes a block: 2, or 1 (the warpgroups' taps differ)
  int taps;         // taps a block: TPW * (3 - xboxes)
  int runs;         // runs of taps: ceil(K / taps)
  int n_c, n_n;     // tiles of 64 * xboxes in-channels, of NB out-channels
  int n_tiles;      // n_c * n_n * runs
  int splits;       // ranges of the reduction's chunks
  int cpr;          // chunks a batch row: ceil(T_out / 64)
  int n_chunks;     // B * cpr
  int win_rows;     // x window rows a chunk (a multiple of 8)
  int stages;
};

size_t wgrad_stage_bytes(int nb, int xboxes, int win_rows) {
  return (size_t)(nb / 64) * kGyBox + (size_t)xboxes * win_rows * 128;
}

size_t wgrad_smem_bytes(int nb, int xboxes, int win_rows, int stages) {
  return 1024 + (size_t)stages * wgrad_stage_bytes(nb, xboxes, win_rows) + 16 * (size_t)stages;
}

template <int NB, int TPW>
__global__ void __launch_bounds__(kConsumers + 32, 1)
denseconv_wgrad_kernel(const __grid_constant__ CUtensorMap gmap,
                       const __grid_constant__ CUtensorMap xmap, const WgradArgs a) {
  constexpr int GY_BYTES = (NB / 64) * kGyBox;
  constexpr int REGS = NB / 2;   // accumulator floats a thread a tap
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int x_box = a.win_rows * 128;
  const int stage_bytes = GY_BYTES + a.xboxes * x_box;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.stages * stage_bytes);
  uint64_t* empty = full + a.stages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // block: in-channel tile fastest, then out-channel tile, run, split
  const int tile = blockIdx.x % a.n_tiles, sp = blockIdx.x / a.n_tiles;
  const int ct = tile % a.n_c, nt = (tile / a.n_c) % a.n_n, run = tile / (a.n_c * a.n_n);
  const int c0 = ct * 64 * a.xboxes, n0 = nt * NB, j0 = run * a.taps;
  const int c_begin = (int)((long long)sp * a.n_chunks / a.splits);
  const int c_end = (int)((long long)(sp + 1) * a.n_chunks / a.splits);

  if (warp == 8) {
    // the producer: chunk c's gy boxes and x window boxes
    if (lane != 0) return;
    for (int c = c_begin, i = 0; c < c_end; ++c, ++i) {
      const int st = i % a.stages;
      mbar_wait(empty + st, ((i / a.stages) & 1) ^ 1);
      mbar_expect_tx(full + st, stage_bytes);
      const int b = c / a.cpr, t0 = (c - b * a.cpr) * kRows;
      unsigned char* s = ring + st * stage_bytes;
#pragma unroll
      for (int q = 0; q < NB / 64; ++q)
        tma_load_3d(s + q * kGyBox, &gmap, full + st, n0 + 64 * q, t0, b);
      for (int q = 0; q < a.xboxes; ++q)
        tma_load_3d(s + GY_BYTES + q * x_box, &xmap, full + st, c0 + 64 * q,
                    t0 + j0 * a.dil - a.pad_l, b);
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;
  // this warpgroup's x box and taps: tap tb of the block is j0 + tb; a tap
  // past the last multiplies the last again (not stored)
  const int xq = a.xboxes == 2 ? wg : 0;
  const int tb0 = a.xboxes == 2 ? 0 : wg * TPW;
  int row[TPW];
#pragma unroll
  for (int p = 0; p < TPW; ++p) row[p] = (min(j0 + tb0 + p, a.K - 1) - j0) * a.dil;
  float acc[TPW][REGS];
  for (int c = c_begin, i = 0; c < c_end; ++c, ++i) {
    const int st = i % a.stages;
    mbar_wait(full + st, (i / a.stages) & 1);
    const uint32_t s = smem_u32(ring + st * stage_bytes);
    const uint32_t xs = s + GY_BYTES + xq * x_box;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      const uint64_t bd = sw128_mn_desc(s + ks * 2048, kGyBox);
#pragma unroll
      for (int p = 0; p < TPW; ++p)
        Wgmma<NB>::template mma<1, 1>(acc[p], sw128_mn_desc(xs + (row[p] + ks * 16) * 128, 0),
                                      bd, i > 0 || ks > 0);
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

  const int ctid = threadIdx.x;   // 0 .. 255: the consumers
  if (a.splits == 1) {
    // acc[p] row m (in-channel c0 + 64 xq + m), column q (out-channel n0 + q):
    // a thread's TPW taps of one (n, ci) are contiguous in dw, stored as one
    // vector where they all exist and align (K a multiple of TPW: 2 or 4)
    const int j = j0 + tb0;
    const bool vec = (TPW == 2 || TPW == 4) && a.K % TPW == 0 && j + TPW <= a.K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = c0 + 64 * xq + wl * 16 + gid + 8 * h;
      if (ci >= a.C || j >= a.K) continue;
#pragma unroll
      for (int nb = 0; nb < NB / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * nb + 2 * tig + e;   // N is a multiple of 8: n + 1 < N too
          if (n >= a.N) continue;
          float* out = a.dw + ((size_t)n * a.C + ci) * a.K + j;
          const int r = 4 * nb + 2 * h + e;
          if constexpr (TPW == 4) {
            if (vec) {
              *reinterpret_cast<float4*>(out) =
                  make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
              continue;
            }
          } else if constexpr (TPW == 2) {
            if (vec) {
              *reinterpret_cast<float2*>(out) = make_float2(acc[0][r], acc[1][r]);
              continue;
            }
          }
#pragma unroll
          for (int p = 0; p < TPW; ++p)
            if (j + p < a.K) out[p] = acc[p][r];
        }
      }
    }
    return;
  }

  // a split tile: this split's partial sums into the workspace (element r of
  // thread ctid at r*256 + ctid), then, once every split of the tile has
  // arrived (the launch is cooperative: all of them are resident), split sp
  // adds up its share of the tile's elements over the splits in order
  constexpr int E = TPW * REGS * kConsumers;
  float* tile_ws = a.ws + (size_t)tile * a.splits * E;
#pragma unroll
  for (int p = 0; p < TPW; ++p)
#pragma unroll
    for (int r = 0; r < REGS; ++r) tile_ws[(size_t)sp * E + (p * REGS + r) * kConsumers + ctid] =
        acc[p][r];
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  int* arrived = a.counters + 2 * tile;
  if (ctid == 0) {
    atomicAdd(arrived, 1);
    int seen;
#ifdef K2BF16_WATCHDOG
    uint32_t tries = 0;
#endif
    do {
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(seen) : "l"(arrived) : "memory");
#ifdef K2BF16_WATCHDOG
      if (++tries == (1u << 26)) __trap();
#endif
    } while (seen < a.splits);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  const int lo = (int)((long long)sp * E / a.splits), hi = (int)((long long)(sp + 1) * E / a.splits);
  for (int e = lo + ctid; e < hi; e += kConsumers) {
    float v = __ldcg(tile_ws + e);
    for (int q = 1; q < a.splits; ++q) v += __ldcg(tile_ws + (size_t)q * E + e);
    // element e: register r of consumer thread u, in the m64nNB layout
    const int r = e / kConsumers, u = e - r * kConsumers;
    const int p = r / REGS, rr = r - p * REGS;
    const int uwg = u / 128, uwl = (u / 32) % 4, ugid = (u % 32) >> 2, utig = u & 3;
    const int j = j0 + (a.xboxes == 2 ? 0 : uwg * TPW) + p;
    const int ci = c0 + (a.xboxes == 2 ? 64 * uwg : 0) + uwl * 16 + ugid + 8 * ((rr >> 1) & 1);
    const int n = n0 + 8 * (rr >> 2) + 2 * utig + (rr & 1);
    if (j < a.K && ci < a.C && n < a.N) a.dw[((size_t)n * a.C + ci) * a.K + j] = v;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  // the last split out zeroes the tile's counters for the next launch
  if (ctid == 0 && atomicAdd(arrived + 1, 1) == a.splits - 1) {
    arrived[0] = 0;
    arrived[1] = 0;
  }
}

// a split plan's launch is cooperative: every block resident at once (the
// splits of a tile wait for each other), else refused
template <int NB, int TPW>
int launch_wgrad(const CUtensorMap* maps, const WgradArgs& a, size_t blocks, size_t smem,
                 cudaStream_t s) {
  auto kernel = denseconv_wgrad_kernel<NB, TPW>;
  static size_t opted[conan::kMaxDevices] = {};
  cudaError_t e = conan::allow_dynamic_smem(kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  if (a.splits == 1) {
    kernel<<<(unsigned)blocks, kConsumers + 32, smem, s>>>(maps[0], maps[1], a);
    return (int)cudaGetLastError();
  }
  CUtensorMap gmap = maps[0], xmap = maps[1];
  WgradArgs args = a;
  void* params[] = {&gmap, &xmap, &args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3((unsigned)blocks),
                                  dim3(kConsumers + 32), params, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiations (NB out-channels, TPW taps a warpgroup);
// ops/denseconv.py:dense_wgrad_tiles plans among them.
#define DENSECONV_WGRAD_BUILT(X) \
  X(128, 1) X(128, 2) X(64, 1) X(64, 2) X(64, 3) X(64, 4)

int dispatch_wgrad(const CUtensorMap* maps, const WgradArgs& a, int nb, int tpw, size_t blocks,
                   size_t smem, cudaStream_t s) {
#define DENSECONV_WGRAD_TRY(NB, TPW) \
  if (nb == NB && tpw == TPW) return launch_wgrad<NB, TPW>(maps, a, blocks, smem, s);
  DENSECONV_WGRAD_BUILT(DENSECONV_WGRAD_TRY)
#undef DENSECONV_WGRAD_TRY
  return (int)cudaErrorInvalidValue;   // not instantiated
}

}  // namespace

// K3 dw as the wrapper calls it. x [B, T, C] and gy [B, T_out, N] bf16
// contiguous (16-byte aligned); dw [N, C, K] fp32, every element written;
// the plan (nb out-channels a block, tpw taps a warpgroup, xboxes, stages,
// win_rows, splits) from ops/denseconv.py:dense_wgrad_plan, which alone
// chooses it: this entry only checks it. With splits > 1, ws holds the
// split tiles' partial sums (splits x tiles x tpw*nb/2 x 256 floats) and
// counters two zeroed ints a tile, which the kernel leaves zeroed, and the
// launch is cooperative (refused where the blocks are not all resident at
// once); with splits 1 both may be null. One launch on `stream`; returns
// cudaGetLastError() after it, cudaErrorInvalidValue for what the kernel
// does not take.
extern "C" int denseconv_weight_grad(const void* x, const void* gy, float* ws, int* counters,
                                     float* dw, int B, int T, int C, int T_out, int N, int K,
                                     int dil, int pad_l, int nb, int tpw, int xboxes, int stages,
                                     int win_rows, int splits, void* stream) {
  if (B < 1 || T < 1 || T_out < 1 || C < 8 || C % 8 || N < 8 || N % 8 || K < 1 || dil < 1 ||
      tpw < 1 || xboxes < 1 || xboxes > 2 || stages < 2 || splits < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(gy) % 16 ||
      (splits > 1 && (!ws || !counters || reinterpret_cast<uintptr_t>(ws) % 16)))
    return (int)cudaErrorInvalidValue;
  const int taps = tpw * (3 - xboxes);
  if (taps > 2 * K || win_rows % 8 ||
      win_rows < kRows + (taps - 1) * dil || win_rows > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgrad_smem_bytes(nb, xboxes, win_rows, stages);
  const int cpr = (T_out + kRows - 1) / kRows;
  const long long n_chunks = (long long)B * cpr;
  const int runs = (K + taps - 1) / taps, n_c = (C + 64 * xboxes - 1) / (64 * xboxes);
  const int n_n = (N + nb - 1) / nb;
  const long long tiles = (long long)n_c * n_n * runs, blocks = tiles * splits;
  if (smem > 227 * 1024 || n_chunks >= (1LL << 31) || splits > n_chunks ||
      blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  if (sw128_rows_map(&maps[0], gy, B, T_out, N, kRows) != CUDA_SUCCESS ||
      sw128_rows_map(&maps[1], x, B, T, C, win_rows) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const WgradArgs a{dw,  splits > 1 ? ws : nullptr, splits > 1 ? counters : nullptr,
                    B,   T_out, C, N, K, dil, pad_l, xboxes, taps, runs, n_c, n_n, (int)tiles,
                    splits, cpr, (int)n_chunks, win_rows, stages};
  return dispatch_wgrad(maps, a, nb, tpw, (size_t)blocks, smem, (cudaStream_t)stream);
}
