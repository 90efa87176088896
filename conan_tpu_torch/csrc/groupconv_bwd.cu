// K2-bf16 dw: the weight gradient of the strided grouped 1-D convolution at
// the "default" training rung, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package differentiates its Pallas
// forward (conan_tpu/ops/pallas_groupconv.py:_pallas_grouped_conv1d_fwd)
// with a custom VJP whose dw is XLA (pallas_groupconv.py:151-158, through
// ops/grouped_conv.py:grouped_conv1d_blocked); this kernel takes that VJP's
// place on the card. It was added because the port's backward handed dw to
// cuDNN, whose grouped wgrad (wgrad2d_grouped_direct_kernel) took 11 ms a
// pass on the MSD's 1024 -> 1024 layer alone, and returned bf16 where JAX's
// DEFAULT returns fp32. It computes
//   dw[g*cog + o, ci, j] = sum_b sum_t bf(gy[b, t, g*cog + o])
//                                      * bf(x[b, t*s + j - pad_l, g*cig + ci])
// with x [B, T, Ci] and gy [B, T_out, Co] channels-last fp32, x zero outside
// [0, T), bf() rounding to bf16 (nearest even), the sum in fp32, dw [Co, cig,
// K] fp32.
//
// What bounds it on the card: its bytes on 13 of the MSD's 15 geometries (x
// and gy read once, dw written once, fp32, at 3.35 TB/s); its bf16 product
// at the dense peak on scales 1 and 2's 1024 -> 1024 (chip_smoke.py:
// groupconv_bf16_bound_ms's rule). Per group it is cog x (K taps x cig)
// outputs over the B*T_out rows of gy: a long reduction (72,000 rows at
// scale 1's first layer) into a small output. The design:
//   - the reduction runs over time, the outer dimension of both
//     channels-last operands. x is the B operand, MN-major (the transposed
//     descriptor bf16 allows): a chunk's x window is rounded once into the
//     forward's polyphase layout (16-byte rows of 8 channels at [channel
//     chunk][row % s][row / s]), where tap j's 64 rows t*s + j are 64
//     consecutive rows of one phase, so each tap is one descriptor into the
//     same window, N = cig. No im2col: a version that built one per
//     warpgroup (x as the A operand, K-major) spent its time on the
//     shared-memory traffic of building it, 2.1 against 1.0 ms over the 15
//     geometries (tools/torch_kernel_lab.py bwd; NVIDIA H100 80GB HBM3,
//     700 W);
//   - gy is the A operand, K-major, transposed while staging (a row: 8
//     times of one out-channel), its M = 64 rows 64 / cog shifts of the cog
//     out-channels: row (d, o) holds gy[t - d, o], which against tap j's B
//     gives tap j + d*s's gradient (the sum over t of gy[t - d] x[t*s + j]
//     is the sum over t' of gy[t'] x[t'*s + j + d*s]). So every row of a
//     product is useful at cog 16 and 32 too, and only the "B taps", j with
//     j mod (shifts*s) < s, about 1 / shifts of the K taps, are multiplied;
//   - filling the card: a block is one group, one run of B taps (TPW a
//     consumer warpgroup, each with its own accumulators) and one of
//     `splits` contiguous ranges of the reduction's 64-row chunks (chunk c:
//     batch row c / cpr, outputs 64 * (c % cpr) .., cpr covering T_out and
//     the shifts); each block writes its fp32 partial sums to scratch the
//     wrapper allocates, and a second launch (k2bf16_wgrad_reduce_kernel)
//     adds the splits in a fixed order and writes dw in its [Co, cig, K]
//     layout. No float atomics: the same inputs give the same bits;
//   - the operands come by TMA on mbarriers into fp32 staging, two chunks
//     in flight (zero fill outside [0, T) and [0, T_out) stands for the
//     padding and the shifts' edges), and are rounded into double-buffered
//     bf16 tiles, so a chunk's products run while the next is rounded;
//   - every warpgroup issues all its products: a branch on the warpgroup
//     around a wgmma made ptxas inject waits (C7517), so a slot past the
//     last B tap multiplies the last one again and is not stored.

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "k2bf16.cuh"

namespace {

constexpr int kRc = 64;           // gy rows (outputs t) a chunk: 4 k-steps of 16
constexpr int kGyLead = 16;       // gy rows staged before a chunk's first (the shifts)
constexpr int kMaxWarpgroups = 3;   // 168 registers a thread: TPW's accumulators and more
constexpr int kStaging = 2;       // chunks in flight a block

struct WgradArgs {
  float* part;      // [splits][groups][K * cig][cog] fp32 partial sums
  int K, stride, pad_l, groups;
  int nbt;          // B taps: j < K with j mod (shifts * stride) < stride
  int n_tb;         // runs of B taps a group: ceil(nbt / (warpgroups * TPW))
  int splits;       // ranges of the reduction's chunks
  int cpr;          // chunks a batch row: ceil((T_out + shifts - 1) / kRc)
  int n_chunks;     // B * cpr
  int stg_rows;     // x staging rows a buffer (a multiple of kRowBox)
};

// B tap bt's tap: bt = (j / period) * s + j % period, j % period < s
__host__ __device__ __forceinline__ int b_tap(int bt, int stride, int period) {
  return bt / stride * period + bt % stride;
}

// shared memory: kStaging x and gy staging buffers, two bf16 windows and two
// A tiles, kStaging mbarriers, from a 128-byte boundary
size_t wgrad_smem_bytes(int cog, int cig, int stg_rows) {
  return 128 + kStaging * ((size_t)stg_rows * cig * 4 + (size_t)(kGyLead + kRc) * cog * 4) +
         2 * ((size_t)stg_rows * cig * 2 + (size_t)kRc * 128) + 8 * kStaging;
}

// shared-memory descriptor of an MN-major tile without swizzle: core
// matrices of 8 k rows x 16 bytes (8 MN values) stored contiguously, the
// next 8 k values 128 bytes on (the leading byte offset), the next 8 MN
// values `mn_stride` bytes on (the stride byte offset). The card computes
// wrong sums with the two offsets the other way round.
__device__ __forceinline__ uint64_t mn_desc(uint32_t saddr, uint32_t mn_stride) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((mn_stride >> 4) & 0x3FFF) << 32);
}

// TPW: the B taps a warpgroup multiplies, each with its own TPW x CIG / 2
// accumulators a thread
template <int CIG, int COG, int TPW>
__global__ void __launch_bounds__(kMaxWarpgroups * 128, 1)
k2bf16_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap, const WgradArgs a) {
  constexpr int SHIFTS = 64 / COG;
  constexpr int C8 = CIG / 8;
  constexpr int GY_ROWS = kGyLead + kRc;
  constexpr int A_BYTES = kRc * 128;      // [8 k-groups][64 rows][16 bytes]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int xs_floats = a.stg_rows * CIG;
  const int win_bytes = a.stg_rows * CIG * 2;
  const int win_u = a.stg_rows / a.stride;               // window rows a phase
  const int plane = a.stride * win_u * 16;               // bytes of one 8-channel chunk
  float* xs = reinterpret_cast<float*>(base);            // [kStaging][stg_rows][CIG]
  float* gs = xs + kStaging * xs_floats;                 // [kStaging][GY_ROWS][COG]
  unsigned char* wins = reinterpret_cast<unsigned char*>(gs + kStaging * GY_ROWS * COG);
  unsigned char* as = wins + 2 * win_bytes;              // [2][A_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(as + 2 * A_BYTES);   // [kStaging]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int bt_block = nthreads / 128 * TPW;
  const int tb = blockIdx.x % a.n_tb, g = (blockIdx.x / a.n_tb) % a.groups;
  const int sp = blockIdx.x / (a.n_tb * a.groups);
  const int period = SHIFTS * a.stride, lg_s = __ffs(a.stride) - 1;
  const int bt0 = tb * bt_block, bt_end = min(bt0 + bt_block, a.nbt);
  const int j_lo = b_tap(bt0, a.stride, period);
  const int span = b_tap(bt_end - 1, a.stride, period) - j_lo + 1;
  const int x_boxes = ((kRc - 1) * a.stride + span + kRowBox - 1) / kRowBox;
  const int c_begin = (int)((long long)sp * a.n_chunks / a.splits);
  const int c_end = (int)((long long)(sp + 1) * a.n_chunks / a.splits);

  if (tid == 0) {
    for (int i = 0; i < kStaging; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk c's x window and gy rows into staging buffer `buf` (thread 0)
  auto issue = [&](int c, int buf) {
    const int b = c / a.cpr, t0 = (c - b * a.cpr) * kRc;
    mbar_expect_tx(full + buf, (uint32_t)(x_boxes * kRowBox * CIG + GY_ROWS * COG) * 4);
    const int in0 = t0 * a.stride - a.pad_l + j_lo;
    for (int k = 0; k < x_boxes; ++k)
      tma_load_3d(xs + buf * xs_floats + k * kRowBox * CIG, &xmap, full + buf, g * CIG,
                  in0 + k * kRowBox, b);
    for (int k = 0; k < GY_ROWS / kRowBox; ++k)
      tma_load_3d(gs + (buf * GY_ROWS + k * kRowBox) * COG, &gmap, full + buf, g * COG,
                  t0 - kGyLead + k * kRowBox, b);
  };
  if (tid == 0)   // the plan keeps splits <= n_chunks: every block has a chunk
    for (int i = 0; i < kStaging && c_begin + i < c_end; ++i) issue(c_begin + i, i);

  // this warpgroup's B taps (a slot past the last takes the last): each
  // one's first window row, in 16-byte rows from the window's start
  const int wg = tid / 128, warp = tid / 32, wl = warp % 4, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  int b_row[TPW];
#pragma unroll
  for (int tp = 0; tp < TPW; ++tp) {
    const int j = b_tap(min(bt0 + wg * TPW + tp, a.nbt - 1), a.stride, period) - j_lo;
    b_row[tp] = (j & (a.stride - 1)) * win_u + (j >> lg_s);
  }
  float acc[TPW][CIG / 2];
  for (int c = c_begin, i = 0; c < c_end; ++c, ++i) {
    const int buf = i % kStaging;
    mbar_wait(full + buf, (i / kStaging) & 1);
    const float* xsb = xs + buf * xs_floats;
    const float* gsb = gs + buf * GY_ROWS * COG;
    unsigned char* win = wins + (i & 1) * win_bytes;
    unsigned char* at = as + (i & 1) * A_BYTES;
    // the window: staging row q's 8-channel chunk c8 at [c8][q % s][q / s]
    for (int e = tid; e < x_boxes * kRowBox * C8; e += nthreads) {
      const int q = e / C8, c8 = e - q * C8;
      const float4 x0 = *reinterpret_cast<const float4*>(xsb + q * CIG + c8 * 8);
      const float4 x1 = *reinterpret_cast<const float4*>(xsb + q * CIG + c8 * 8 + 4);
      *reinterpret_cast<uint4*>(win + c8 * plane +
                                ((q & (a.stride - 1)) * win_u + (q >> lg_s)) * 16) =
          make_uint4(bf16x2_bits(x0.x, x0.y), bf16x2_bits(x0.z, x0.w), bf16x2_bits(x1.x, x1.y),
                     bf16x2_bits(x1.z, x1.w));
    }
    // A: row m = d * COG + o's 16-byte row of k-group kg holds the chunk's
    // gy rows 8 kg - d .. 8 kg - d + 7, out-channel o
    for (int e = tid; e < 8 * 64; e += nthreads) {
      const int m = e & 63, kg = e >> 6, d = m / COG, o = m - d * COG;
      const float* src = gsb + (kGyLead + kg * 8 - d) * COG + o;
      *reinterpret_cast<uint4*>(at + kg * 1024 + m * 16) =
          make_uint4(bf16x2_bits(src[0], src[COG]), bf16x2_bits(src[2 * COG], src[3 * COG]),
                     bf16x2_bits(src[4 * COG], src[5 * COG]),
                     bf16x2_bits(src[6 * COG], src[7 * COG]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // the tiles, to wgmma
    __syncthreads();   // staging buffer `buf` is rounded: refill it
    if (tid == 0 && c + kStaging < c_end) issue(c + kStaging, buf);
    const uint32_t win_s = smem_u32(win), at_s = smem_u32(at);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRc / 16; ++ks) {
      const uint64_t ad = a_desc(at_s + ks * 2048, 1024);
#pragma unroll
      for (int tp = 0; tp < TPW; ++tp)
        Wgmma<CIG>::template mma<1>(
            acc[tp], ad, mn_desc(win_s + (b_row[tp] + ks * 16) * 16, plane),
            i > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the last chunk's products are done with their tiles
    __syncthreads();   // every warpgroup's: tiles `i + 1` may be rewritten
  }
  wgmma_wait<0>();
#pragma unroll
  for (int tp = 0; tp < TPW; ++tp) fence_acc(acc[tp]);
  // acc[tp] row m = (d, o), column ci: dw[o, ci, j + d*s] of B tap j
  float* pr = a.part + ((size_t)sp * a.groups + g) * a.K * CIG * COG;
#pragma unroll
  for (int tp = 0; tp < TPW; ++tp) {
    const int bt = bt0 + wg * TPW + tp;
    if (bt >= bt_end) continue;
    const int j = b_tap(bt, a.stride, period);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wl * 16 + gid + 8 * h, d = m / COG, o = m - d * COG;
      const int tap = j + d * a.stride;
      if (tap >= a.K) continue;
#pragma unroll
      for (int nb = 0; nb < CIG / 8; ++nb)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          pr[((size_t)tap * CIG + 8 * nb + 2 * tig + cc) * COG + o] =
              acc[tp][4 * nb + 2 * h + cc];
    }
  }
}

// dw[g*cog + o, ci, j] = sum over splits sp (in order) of part[sp][g][j*cig +
// ci][o]. A block per (g, ci): the K x cog sums into shared memory, then
// written in dw's order (o, then j).
__global__ void k2bf16_wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                           int groups, int cig, int cog, int K, int splits) {
  extern __shared__ float sums[];   // [K][cog + 1]
  const int g = blockIdx.x / cig, ci = blockIdx.x - g * cig;
  const size_t split_floats = (size_t)groups * K * cig * cog;
  for (int e = threadIdx.x; e < K * cog; e += blockDim.x) {
    const int j = e / cog, o = e - j * cog;
    const float* src = part + (((size_t)g * K + j) * cig + ci) * cog + o;
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += src[sp * split_floats];
    sums[j * (cog + 1) + o] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cog * K; e += blockDim.x) {
    const int o = e / K, j = e - o * K;
    dw[((size_t)(g * cog + o) * cig + ci) * K + j] = sums[j * (cog + 1) + o];
  }
}

template <int CIG, int COG, int TPW>
int launch_wgrad(const CUtensorMap* maps, const WgradArgs& a, int nwg, size_t smem,
                 cudaStream_t s) {
  auto kernel = k2bf16_wgrad_kernel<CIG, COG, TPW>;
  static size_t opted[conan::kMaxDevices] = {};
  const cudaError_t e = conan::allow_dynamic_smem(kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.splits * a.groups * a.n_tb, nwg * 128, smem, s>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

// The instantiations (CIG, COG, TPW): the MSD's five grouped layers, with
// the B taps a warpgroup that ops/groupconv.py:WGRAD_TPW plans for each.
#define K2BF16_WGRAD_BUILT(X) \
  X(32, 32, 7)                \
  X(8, 16, 6)                 \
  X(16, 32, 7)                \
  X(32, 64, 7)                \
  X(64, 64, 4)

int dispatch_wgrad(const CUtensorMap* maps, const WgradArgs& a, int cig, int cog, int tpw,
                   int nwg, size_t smem, cudaStream_t s) {
#define K2BF16_WGRAD_TRY(CIG, COG, TPW)      \
  if (cig == CIG && cog == COG && tpw == TPW) \
    return launch_wgrad<CIG, COG, TPW>(maps, a, nwg, smem, s);
  K2BF16_WGRAD_BUILT(K2BF16_WGRAD_TRY)
#undef K2BF16_WGRAD_TRY
  return (int)cudaErrorInvalidValue;   // not instantiated
}

}  // namespace

// K2-bf16 dw as the wrapper calls it. x [B, T, Ci] and gy [B, T_out, Co]
// fp32 contiguous (16-byte aligned); part the fp32 scratch of splits x
// groups x K*cig x cog floats; dw [Co, cig, K] fp32, every element written;
// the plan (nwg consumer warpgroups, splits, stg_rows, tpw B taps a
// warpgroup, nbt B taps, n_tb runs of them) from
// ops/groupconv.py:bf16_wgrad_plan, which alone chooses it: this entry only
// checks it. Two launches on `stream`; returns cudaGetLastError() after
// them, cudaErrorInvalidValue for what the kernel does not take ((cig, cog,
// tpw) not instantiated, a stride that is not 1, 2, 4 or 8, a plan that does
// not cover the geometry or fit shared memory).
extern "C" int groupconv_weight_grad_bf16(const float* x, const float* gy, float* part,
                                          float* dw, int B, int T, int Ci, int T_out, int Co,
                                          int groups, int K, int stride, int pad_l, int nwg,
                                          int splits, int stg_rows, int tpw, int nbt, int n_tb,
                                          void* stream) {
  if (groups < 1 || Ci % groups || Co % groups || B < 1 || T < 1 || T_out < 1 || K < 1 ||
      stride < 1 || stride > 8 || (stride & (stride - 1)) || pad_l < 0 || nwg < 1 ||
      nwg > kMaxWarpgroups || splits < 1 || stg_rows < 1 || stg_rows % kRowBox || tpw < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(gy) % 16 ||
      reinterpret_cast<uintptr_t>(part) % 16)
    return (int)cudaErrorInvalidValue;
  const int cig = Ci / groups, cog = Co / groups;
  if ((cog != 16 && cog != 32 && cog != 64) || (size_t)K * (cog + 1) * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int period = 64 / cog * stride;
  int b_taps = 0;
  for (int j = 0; j < K; ++j) b_taps += j % period < stride;
  if (nbt != b_taps || n_tb != (nbt + nwg * tpw - 1) / (nwg * tpw))
    return (int)cudaErrorInvalidValue;
  const int cpr = (T_out + 64 / cog - 1 + kRc - 1) / kRc;
  const long long n_chunks = (long long)B * cpr;
  if (n_chunks >= (1LL << 31) || splits > n_chunks ||
      (long long)splits * groups * n_tb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  for (int tb = 0; tb < n_tb; ++tb) {   // every run's window fits its staging
    const int bt0 = tb * nwg * tpw, bt_end = min(bt0 + nwg * tpw, nbt);
    const int span = b_tap(bt_end - 1, stride, period) - b_tap(bt0, stride, period) + 1;
    if ((kRc - 1) * stride + span > stg_rows) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = wgrad_smem_bytes(cog, cig, stg_rows);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  if (fp32_rows_map(&maps[0], x, B, T, Ci, cig) != CUDA_SUCCESS ||
      fp32_rows_map(&maps[1], gy, B, T_out, Co, cog) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const WgradArgs a{part,   K,   stride,        pad_l,   groups, nbt,
                    n_tb,   splits, cpr,    (int)n_chunks, stg_rows};
  const cudaStream_t s = (cudaStream_t)stream;
  int err = dispatch_wgrad(maps, a, cig, cog, tpw, nwg, smem, s);
  if (err) return err;
  k2bf16_wgrad_reduce_kernel<<<Ci, 256, (size_t)K * (cog + 1) * 4, s>>>(part, dw, groups, cig,
                                                                        cog, K, splits);
  return (int)cudaGetLastError();
}
