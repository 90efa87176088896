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
//     chunk][row % s][row / s], a phase's rows win_u apart, win_u odd so
//     that the rounding pass's 16-byte stores of the channel chunks fall in
//     distinct banks), where tap j's 64 rows t*s + j are 64 consecutive rows
//     of one phase, so each tap is one descriptor into the same window, N =
//     cig. No im2col: a version that built one per warpgroup (x as the A
//     operand, K-major) spent its time on the shared-memory traffic of
//     building it, 2.1 against 1.0 ms over the 15 geometries
//     (tools/torch_kernel_lab.py bwd; NVIDIA H100 80GB HBM3, 700 W);
//   - gy is the A operand, K-major, transposed while rounding (a row: 8
//     times of one out-channel), its M = 64 rows 64 / cog shifts of the cog
//     out-channels: row (d, o) holds gy[t - d, o], which against tap j's B
//     gives tap j + d*s's gradient (the sum over t of gy[t - d] x[t*s + j]
//     is the sum over t' of gy[t'] x[t'*s + j + d*s]). So every row of a
//     product is useful at cog 16 and 32 too, and only the "B taps", j with
//     j mod (shifts*s) < s, about 1 / shifts of the K taps, are multiplied;
//   - warp-specialized, after the first design (one launch of a block-wide
//     round, barrier, multiply per chunk, thread 0 issuing the next chunk's
//     16-row TMA boxes in between, then a second launch adding the splits'
//     partial sums; step 0 of its redesign, tools/torch_kernel_lab.py
//     profile, NVIDIA H100 80GB HBM3, 700 W: 0.99 ms bare over the 15
//     geometries, of which the second launch alone 0.27): a producer
//     warpgroup (one thread issuing; its registers handed to the consumers
//     by setmaxnreg, which with a lone producer warp beside two warpgroups
//     ptxas could not do: 168 registers, the accumulators spilled) keeps
//     `stages` chunks of x window and gy rows in flight by TMA on mbarriers
//     into fp32 staging, in boxes of up to 256 rows; the consumer
//     warpgroups round chunk i + 1 into one of three bf16 tile pairs
//     (window, A) while chunk i's products run, then meet at their own
//     barrier (named barrier 1, once a chunk: no block-wide barrier after
//     the set-up) and hand the staging buffer back by mbarrier. A design
//     with a converter warpgroup of its own rounding for the consumers
//     lost: 1.12 ms device over the 15 geometries, the rounding on 128
//     threads the longest part (the same profile);
//   - a block is one group, one run of B taps (TPW a consumer warpgroup,
//     each with its own accumulators) and one of `splits` contiguous ranges
//     of the reduction's 64-row chunks (chunk c: batch row c / cpr, outputs
//     64 * (c % cpr) .., cpr covering T_out and the shifts). Every
//     warpgroup issues all its products: a branch on the warpgroup around a
//     wgmma made ptxas inject waits (C7517), so a slot past the last B tap
//     multiplies the last one again and is not stored;
//   - the accumulators go through shared memory into the tile's dw order
//     ([o][ci][tap - first tap]) and out in that order: an unsplit
//     tile (the plan splits only where the tiles alone leave the card
//     short) writes dw itself, once; a split tile writes its partial sums,
//     in the same order, to the plan's workspace, and once every split of
//     the tile has arrived (an integer counter a tile; the launch is
//     cooperative, so all are resident) each adds up its share of the
//     tile's rows over the splits in split order and writes it to dw (a
//     store computing each element's place by integer division made the
//     epilogue the longest part of the short layers); the last out
//     resets the counters. No float atomics: the same inputs give the same
//     bits. One launch a call.

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "k2bf16.cuh"

namespace {

constexpr int kRc = 64;             // gy rows (outputs t) a chunk: 4 k-steps of 16
constexpr int kGyLead = 16;         // gy rows staged before a chunk's first (the shifts)
constexpr int kGyRows = kGyLead + kRc;   // gy rows a chunk stages: one TMA box
constexpr int kMaxWarpgroups = 2;   // consumer warpgroups a block, beside the producer's
constexpr int kProducerRegs = 24;   // setmaxnreg: the producer warpgroup's registers a thread
constexpr int kConsumerRegs = 240;  // and the consumers' (24*128 + 240*256 <= 65536)
constexpr int kMaxStages = 4;       // chunks in flight a block by TMA
constexpr int kTileSlots = 3;       // bf16 tile pairs (window, A): one barrier a chunk
constexpr int kMaxBoxRows = 256;    // rows a TMA box holds at most
constexpr int kBarBytes = 128;      // the mbarriers, ahead of the data

struct WgradArgs {
  float* dw;        // [Co][cig][K] fp32
  float* ws;        // split tiles' partial sums in tile order, or null (splits 1)
  int* counters;    // two zeroed counters a tile, or null (splits 1)
  int K, stride, pad_l, groups;
  int nbt;          // B taps: j < K with j mod (shifts * stride) < stride
  int n_tb;         // runs of B taps a group: ceil(nbt / (nwg * TPW))
  int nwg;          // consumer warpgroups
  int splits;       // ranges of the reduction's chunks
  int cpr;          // chunks a batch row: ceil((T_out + shifts - 1) / kRc)
  int n_chunks;     // B * cpr
  int stg_rows;     // x staging rows a buffer: x_boxes TMA boxes
  int x_boxes;      // x boxes a chunk, of stg_rows / x_boxes rows
  int win_u;        // window rows a phase (odd)
  int stages;       // staging buffers
  int span;         // taps a tile's dw order holds (the widest run's)
};

// B tap bt's tap: bt = (j / period) * s + j % period, j % period < s
__host__ __device__ __forceinline__ int b_tap(int bt, int stride, int period) {
  return bt / stride * period + bt % stride;
}

// the B tap whose shift gives tap j (j = b_tap + d * s)
__host__ __device__ __forceinline__ int b_tap_of(int j, int stride, int period) {
  const int jb = j - (j % period) / stride * stride;
  return jb / period * stride + jb % period;
}

// the taps of run tb of B taps: j_lo (its first B tap) .. j_hi
__host__ __device__ __forceinline__ void run_taps(int tb, int per, int nbt, int stride,
                                                  int period, int K, int shifts, int* j_lo,
                                                  int* j_hi) {
  const int bt0 = tb * per, bt_end = min(bt0 + per, nbt);
  *j_lo = b_tap(bt0, stride, period);
  *j_hi = min(K - 1, b_tap(bt_end - 1, stride, period) + (shifts - 1) * stride);
}

size_t win_bytes(int cig, int stride, int win_u) { return (size_t)(cig / 8) * stride * win_u * 16; }

// shared memory from a 128-byte boundary: the mbarriers, then the larger
// of the main loop's staging and tile slots and the epilogue's dw-order tile
size_t wgrad_smem_bytes(int cog, int cig, int stride, int stg_rows, int win_u, int stages,
                        int span) {
  const size_t main = (size_t)stages * ((size_t)stg_rows * cig * 4 + (size_t)kGyRows * cog * 4) +
                      kTileSlots * (win_bytes(cig, stride, win_u) + (size_t)kRc * 128);
  const size_t epi = (size_t)cog * cig * span * 4;
  return 128 + kBarBytes + (main > epi ? main : epi);
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

// the consumer warpgroups' own barrier (named barrier 1; the producer warp
// never joins it)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// TPW: the B taps a consumer warpgroup multiplies, each with its own TPW x
// CIG / 2 accumulators a thread
template <int CIG, int COG, int TPW>
__global__ void __launch_bounds__((kMaxWarpgroups + 1) * 128, 1)
k2bf16_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap, const WgradArgs a) {
  constexpr int SHIFTS = 64 / COG;
  constexpr int C8 = CIG / 8;
  constexpr int A_BYTES = kRc * 128;      // [8 k-groups][64 rows][16 bytes]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  uint64_t* sfull = reinterpret_cast<uint64_t*>(base);   // [stages]: a chunk staged
  uint64_t* sempty = sfull + kMaxStages;                  // [stages]: a chunk rounded
  unsigned char* data = base + kBarBytes;
  const int xs_floats = a.stg_rows * CIG;
  const int wbytes = C8 * a.stride * a.win_u * 16;
  const int plane = a.stride * a.win_u * 16;               // bytes of one 8-channel chunk
  float* xs = reinterpret_cast<float*>(data);              // [stages][stg_rows][CIG]
  float* gs = xs + a.stages * xs_floats;                   // [stages][kGyRows][COG]
  unsigned char* wins = reinterpret_cast<unsigned char*>(gs + a.stages * kGyRows * COG);
  unsigned char* as = wins + kTileSlots * wbytes;          // [kTileSlots][A_BYTES]

  const int tid = threadIdx.x, consumers = a.nwg * 128;
  const int per = a.nwg * TPW;                             // B taps a block
  const int tb = blockIdx.x % a.n_tb, g = (blockIdx.x / a.n_tb) % a.groups;
  const int tile = blockIdx.x % (a.n_tb * a.groups), sp = blockIdx.x / (a.n_tb * a.groups);
  const int period = SHIFTS * a.stride, lg_s = __ffs(a.stride) - 1;
  const int bt0 = tb * per, bt_end = min(bt0 + per, a.nbt);
  int j_lo, j_hi;
  run_taps(tb, per, a.nbt, a.stride, period, a.K, SHIFTS, &j_lo, &j_hi);
  const int span = b_tap(bt_end - 1, a.stride, period) - j_lo + 1;   // the window's taps
  const int x_rows = round_up((kRc - 1) * a.stride + span, kRowBox);  // of stg_rows
  const int c_begin = (int)((long long)sp * a.n_chunks / a.splits);
  const int c_end = (int)((long long)(sp + 1) * a.n_chunks / a.splits);
  const int n = c_end - c_begin;   // the plan keeps splits <= n_chunks: every block has one

  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(sfull + i, 1);
      mbar_init(sempty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= consumers) {
    // the producer warpgroup, its registers handed to the consumers: thread
    // 0 brings chunk c's x window and gy rows by TMA into staging buffer i
    // % stages once the consumers have rounded what it held
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != consumers) return;
    const int box_rows = a.stg_rows / a.x_boxes;
    for (int i = 0; i < n; ++i) {
      const int buf = i % a.stages, c = c_begin + i;
      if (i >= a.stages) mbar_wait(sempty + buf, ((i / a.stages) - 1) & 1);
      const int b = c / a.cpr, t0 = (c - b * a.cpr) * kRc;
      mbar_expect_tx(sfull + buf, (uint32_t)(xs_floats + kGyRows * COG) * 4);
      const int in0 = t0 * a.stride - a.pad_l + j_lo;
      for (int k = 0; k < a.x_boxes; ++k)
        tma_load_3d(xs + buf * xs_floats + k * box_rows * CIG, &xmap, sfull + buf, g * CIG,
                    in0 + k * box_rows, b);
      tma_load_3d(gs + buf * kGyRows * COG, &gmap, sfull + buf, g * COG, t0 - kGyLead, b);
    }
    return;
  }

  // the consumers: chunk i + 1 is rounded into tile slot (i + 1) % 3 while
  // chunk i's products run; its slot was last read by chunk i - 2's, which
  // every warpgroup had waited for before the barrier that ended chunk i's
  // rounding
  auto round = [&](int i) {
    const int buf = i % a.stages, slot = i % kTileSlots;
    mbar_wait(sfull + buf, (i / a.stages) & 1);
    const float* xsb = xs + buf * xs_floats;
    const float* gsb = gs + buf * kGyRows * COG;
    unsigned char* win = wins + slot * wbytes;
    unsigned char* at = as + slot * A_BYTES;
    // the window: staging row q's 8-channel chunk c8 at [c8][q % s][q / s]
    for (int e = tid; e < x_rows * C8; e += consumers) {
      const int q = e / C8, c8 = e - q * C8;
      const float4 x0 = *reinterpret_cast<const float4*>(xsb + q * CIG + c8 * 8);
      const float4 x1 = *reinterpret_cast<const float4*>(xsb + q * CIG + c8 * 8 + 4);
      *reinterpret_cast<uint4*>(win + c8 * plane +
                                ((q & (a.stride - 1)) * a.win_u + (q >> lg_s)) * 16) =
          make_uint4(bf16x2_bits(x0.x, x0.y), bf16x2_bits(x0.z, x0.w),
                     bf16x2_bits(x1.x, x1.y), bf16x2_bits(x1.z, x1.w));
    }
    // A: row m = d * COG + o's 16-byte row of k-group kg holds the chunk's
    // gy rows 8 kg - d .. 8 kg - d + 7, out-channel o
    for (int e = tid; e < 8 * 64; e += consumers) {
      const int m = e & 63, kg = e >> 6, d = m / COG, o = m - d * COG;
      const float* src = gsb + (kGyLead + kg * 8 - d) * COG + o;
      *reinterpret_cast<uint4*>(at + kg * 1024 + m * 16) =
          make_uint4(bf16x2_bits(src[0], src[COG]), bf16x2_bits(src[2 * COG], src[3 * COG]),
                     bf16x2_bits(src[4 * COG], src[5 * COG]),
                     bf16x2_bits(src[6 * COG], src[7 * COG]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // the tiles, to wgmma
    consumer_sync(consumers);   // the chunk's tiles are whole; its staging is read
    if (tid == 0) mbar_arrive(sempty + buf);
  };

  // warpgroup wg multiplies B taps bt0 + wg*TPW .. (a slot past the last
  // takes the last): each one's first window row, in 16-byte rows from the
  // window's start
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // the warpgroup index made warp-uniform, so that what derives from it
  // (each B tap's window row) can live in uniform registers beside the
  // accumulators
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = tid / 32, wl = warp % 4, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  // (recomputed at each product from shifts and masks: the stride is a
  // power of two, and integer divisions here cost the whole kernel 20%)
  auto b_row = [&](int tp) {
    const int bt = min(bt0 + wg * TPW + tp, a.nbt - 1);
    const int j = (bt >> lg_s) * period + (bt & (a.stride - 1)) - j_lo;
    return (j & (a.stride - 1)) * a.win_u + (j >> lg_s);
  };
  float acc[TPW][CIG / 2];
  const uint32_t wins_s = smem_u32(wins), as_s = smem_u32(as);
  round(0);
  for (int i = 0; i < n; ++i) {
    const int slot = i % kTileSlots;
    const uint32_t win_s = wins_s + slot * wbytes, at_s = as_s + slot * A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRc / 16; ++ks) {
      const uint64_t ad = a_desc(at_s + ks * 2048, 1024);
#pragma unroll
      for (int tp = 0; tp < TPW; ++tp)
        Wgmma<CIG>::template mma<1>(acc[tp], ad,
                                    mn_desc(win_s + (b_row(tp) + ks * 16) * 16, plane),
                                    i > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // chunk i - 1's products are done with their tiles
    if (i + 1 < n) round(i + 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int tp = 0; tp < TPW; ++tp) fence_acc(acc[tp]);
  consumer_sync(consumers);   // every warpgroup's products are done with the tiles

  // the tile in dw order: [o][ci][tap - j_lo], a.span taps a row. acc[tp]
  // row m = (d, o), column ci: tap j + d*s of B tap j
  float* tile_s = reinterpret_cast<float*>(data);
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
          tile_s[(o * CIG + 8 * nb + 2 * tig + cc) * a.span + tap - j_lo] =
              acc[tp][4 * nb + 2 * h + cc];
    }
  }
  consumer_sync(consumers);
  // element k of the tile order is row r = k / span (o, ci), tap j_lo + k %
  // span, stored where that tap is this run's (a run's taps may interleave
  // with the next's where it ends inside a period: a 64-bit mask of the
  // row's taps, span <= 64); a thread steps k by `consumers`, its row and
  // tap advanced without a division
  const int R = COG * CIG, E = R * a.span;
  auto member = [&](int jj) {
    const int j = j_lo + jj, bt = b_tap_of(j, a.stride, period);
    return jj < a.span && j <= j_hi && bt >= bt0 && bt < bt_end;
  };
  const uint64_t taps = __ballot_sync(0xffffffffu, member(lane)) |
                        (uint64_t)__ballot_sync(0xffffffffu, member(lane + 32)) << 32;
  const int dr = consumers / a.span, dj = consumers - dr * a.span;
  float* dw_g = a.dw + (size_t)g * R * a.K + j_lo;
  auto store_range = [&](int k0, int k1, auto value) {   // elements k0 .. k1 - 1
    int r = (k0 + tid) / a.span, jj = k0 + tid - r * a.span;
    for (int k = k0 + tid; k < k1; k += consumers) {
      if ((taps >> jj) & 1) dw_g[(size_t)r * a.K + jj] = value(k);
      r += dr;
      jj += dj;
      if (jj >= a.span) jj -= a.span, ++r;
    }
  };
  if (a.splits == 1) {
    store_range(0, E, [&](int k) { return tile_s[k]; });
    return;
  }
  // a split tile: this split's partial sums to the workspace in the same
  // order, then, once every split of the tile has arrived, split sp adds
  // up its share of the tile's rows over the splits in order
  float* tile_ws = a.ws + (size_t)tile * a.splits * E;
  for (int k = tid; k < E / 4; k += consumers)
    reinterpret_cast<float4*>(tile_ws + (size_t)sp * E)[k] = reinterpret_cast<float4*>(tile_s)[k];
  __threadfence();
  consumer_sync(consumers);
  int* arrived = a.counters + 2 * tile;
  if (tid == 0) {
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
  consumer_sync(consumers);
  // split sp's share: its rows of the tile, each element over the splits in order
  store_range((int)((long long)sp * R / a.splits) * a.span,
              (int)((long long)(sp + 1) * R / a.splits) * a.span, [&](int k) {
                float v = __ldcg(tile_ws + k);
                for (int q = 1; q < a.splits; ++q) v += __ldcg(tile_ws + (size_t)q * E + k);
                return v;
              });
  consumer_sync(consumers);
  // the last split out zeroes the tile's counters for the next launch
  if (tid == 0 && atomicAdd(arrived + 1, 1) == a.splits - 1) {
    arrived[0] = 0;
    arrived[1] = 0;
  }
}

// a split plan's launch is cooperative: every block resident at once (the
// splits of a tile wait for each other), else refused
template <int CIG, int COG, int TPW>
int launch_wgrad(const CUtensorMap* maps, const WgradArgs& a, size_t smem, cudaStream_t s) {
  auto kernel = k2bf16_wgrad_kernel<CIG, COG, TPW>;
  static size_t opted[conan::kMaxDevices] = {};
  cudaError_t e = conan::allow_dynamic_smem(kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(a.splits * a.groups * a.n_tb), threads = (a.nwg + 1) * 128;
  if (a.splits == 1) {
    kernel<<<blocks, threads, smem, s>>>(maps[0], maps[1], a);
    return (int)cudaGetLastError();
  }
  CUtensorMap xmap = maps[0], gmap = maps[1];
  WgradArgs args = a;
  void* params[] = {&xmap, &gmap, &args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                  dim3(threads), params, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiations (CIG, COG, TPW): the MSD's five grouped layers, with
// the B taps a warpgroup that ops/groupconv.py:WGRAD_TPW plans for each.
#define K2BF16_WGRAD_BUILT(X) \
  X(32, 32, 7)                \
  X(8, 16, 6)                 \
  X(16, 32, 11)               \
  X(32, 64, 7)                \
  X(64, 64, 3)

int dispatch_wgrad(const CUtensorMap* maps, const WgradArgs& a, int cig, int cog, int tpw,
                   size_t smem, cudaStream_t s) {
#define K2BF16_WGRAD_TRY(CIG, COG, TPW)      \
  if (cig == CIG && cog == COG && tpw == TPW) \
    return launch_wgrad<CIG, COG, TPW>(maps, a, smem, s);
  K2BF16_WGRAD_BUILT(K2BF16_WGRAD_TRY)
#undef K2BF16_WGRAD_TRY
  return (int)cudaErrorInvalidValue;   // not instantiated
}

}  // namespace

// K2-bf16 dw as the wrapper calls it. x [B, T, Ci] and gy [B, T_out, Co]
// fp32 contiguous (16-byte aligned); dw [Co, cig, K] fp32, every element
// written; the plan (nwg consumer warpgroups, tpw B taps a warpgroup,
// splits, stages, stg_rows) from ops/groupconv.py:bf16_wgrad_plan, which
// alone chooses it: this entry only checks it. With splits > 1, ws holds
// the split tiles' partial sums (splits x tiles x cog*cig*span floats,
// 16-byte aligned) and counters two zeroed ints a tile, which the kernel
// leaves zeroed, and the launch is cooperative (refused where the blocks
// are not all resident at once); with splits 1 both may be null. One
// launch on `stream`; returns cudaGetLastError() after it,
// cudaErrorInvalidValue for what the kernel does not take ((cig, cog, tpw)
// not instantiated, a stride that is not 1, 2, 4 or 8, a plan that does not
// cover the geometry or fit shared memory).
extern "C" int groupconv_weight_grad_bf16(const float* x, const float* gy, float* ws,
                                          int* counters, float* dw, int B, int T, int Ci,
                                          int T_out, int Co, int groups, int K, int stride,
                                          int pad_l, int nwg, int tpw, int splits, int stages,
                                          int stg_rows, void* stream) {
  if (groups < 1 || Ci % groups || Co % groups || B < 1 || T < 1 || T_out < 1 || K < 1 ||
      stride < 1 || stride > 8 || (stride & (stride - 1)) || pad_l < 0 || nwg < 1 ||
      nwg > kMaxWarpgroups || splits < 1 || stages < 1 || stages > kMaxStages ||
      stg_rows < 1 || stg_rows % kRowBox || tpw < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(gy) % 16 ||
      (splits > 1 && (!ws || !counters || reinterpret_cast<uintptr_t>(ws) % 16)))
    return (int)cudaErrorInvalidValue;
  const int cig = Ci / groups, cog = Co / groups;
  if (cog != 16 && cog != 32 && cog != 64) return (int)cudaErrorInvalidValue;
  const int shifts = 64 / cog, period = shifts * stride;
  int nbt = 0;
  for (int j = 0; j < K; ++j) nbt += j % period < stride;
  const int per = nwg * tpw, n_tb = (nbt + per - 1) / per;
  const int cpr = (T_out + shifts - 1 + kRc - 1) / kRc;
  const long long n_chunks = (long long)B * cpr;
  if (n_chunks >= (1LL << 31) || splits > n_chunks ||
      (long long)splits * groups * n_tb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int span = 0;
  for (int tb = 0; tb < n_tb; ++tb) {   // every run's window fits its staging
    int j_lo, j_hi;
    run_taps(tb, per, nbt, stride, period, K, shifts, &j_lo, &j_hi);
    const int bt_end = min(tb * per + per, nbt);
    if ((kRc - 1) * stride + b_tap(bt_end - 1, stride, period) - j_lo + 1 > stg_rows)
      return (int)cudaErrorInvalidValue;
    span = max(span, j_hi - j_lo + 1);
  }
  // x's staging rows in the fewest boxes of at most kMaxBoxRows rows, a
  // multiple of kRowBox each
  const int x_boxes = (stg_rows + kMaxBoxRows - 1) / kMaxBoxRows;
  if (stg_rows % (kRowBox * x_boxes)) return (int)cudaErrorInvalidValue;
  if (span > 64) return (int)cudaErrorInvalidValue;   // a tile's row: two taps a lane
  const int win_u = stg_rows / stride + 1;
  const size_t smem = wgrad_smem_bytes(cog, cig, stride, stg_rows, win_u, stages, span);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  if (fp32_rows_map(&maps[0], x, B, T, Ci, cig, stg_rows / x_boxes) != CUDA_SUCCESS ||
      fp32_rows_map(&maps[1], gy, B, T_out, Co, cog, kGyRows) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const WgradArgs a{dw,   splits > 1 ? ws : nullptr, splits > 1 ? counters : nullptr,
                    K,    stride, pad_l, groups, nbt, n_tb, nwg, splits, cpr, (int)n_chunks,
                    stg_rows, x_boxes, win_u, stages, span};
  return dispatch_wgrad(maps, a, cig, cog, tpw, smem, (cudaStream_t)stream);
}
