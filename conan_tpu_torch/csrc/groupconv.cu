// Strided grouped 1-D convolution for Hopper (sm_90a), fp32 accuracy on the
// tensor cores: kernel K2.
//
// Replaces the TPU kernel conan_tpu/ops/pallas_groupconv.py:
// _pallas_grouped_conv1d_fwd, the forward of the MSD's grouped convs
// (k 41, groups 4/16, strides 1/2/4):
//   y[b, t, g*cog + co] = sum_{ci < cig, j < K} x[b, t*s + j - pad_l, g*cig + ci]
//                                               * w[g*cog + co, ci, j]
// with x channels-last [B, T, Ci], zero outside [0, T), and y [B, T_out, Co].
// The Pallas kernel packs groups block-diagonally into the MXU's 128 lanes
// (redundant FLOPs); here each block computes the true grouped product as an
// implicit GEMM per group: M = output times, N = the group's out-channels,
// reduction over r = (tap j, in-channel ci) in k-steps of 8 channels of one
// tap (cig is a multiple of 8), so a k-step reads 8 consecutive channels of
// window row m*s + j and there is no im2col copy.
//
// What bounds it on the card: its operations. The MSD's first grouped layer
// at the train step's batch (B=18, 8000 samples, 128 -> 128, s 2, g 4) does
// 2.4e10 FLOP against 111 MB of input, weights and output. The slice trains
// at "exact" (fp32, no plain TF32 product), so the product uses the
// three-pass split (CUTLASS's OpMultiplyAddFastF32): a = a_hi + a_lo with
// a_hi = tf32(a), a_lo = tf32(a - a_hi), both rounded to nearest with ties
// away from zero (cvt.rna), and
//   x*w ~ x_hi*w_hi + x_lo*w_hi + x_hi*w_lo,
// each an mma.sync.m16n8k8 tf32 product accumulated in fp32. The dropped
// x_lo*w_lo term and a_lo's own rounding are ~2^-22 of each product, fp32's
// order. At TF32's 495 TFLOP/s three products still beat the 67 TFLOP/s FMA
// peak, so the bound is 3 * FLOPs / 495e12 (chip_smoke.py:groupconv_bound_ms).
//
// The design, per block of (BM output times, group x BN out-channels, batch
// row), 4 warps each owning a WM x WN sub-tile in registers:
//   - the input window the tile reads, [(BM-1)*s + K rows, cig], is staged
//     once with cp.async (zero-filled outside [0, T)) as raw fp32, and each
//     A value is split into hi and lo as it is loaded into its fragment.
//     Splitting once at staging into two planes was built first and measured
//     slower (15 geometries: 4.06 ms against 3.06 ms, scale 1's first layer
//     0.835 against 0.603 ms; NVIDIA H100 80GB HBM3, 700 W): the second plane
//     doubles the window's shared memory, which costs resident warps, and
//     warps are what this loop is short of, not conversions;
//   - the window rows are stored polyphase: row r at (phase r % s, index
//     r / s). An A fragment's 8 rows m*s + j, s apart in the wav, are then 8
//     consecutive rows of phase j % s. With a row pitch of cig or cig + 8
//     floats, whichever is an odd multiple of 8, those rows fall in distinct
//     bank groups for every s, the loads are 64-bit (below), and every row
//     stays 16-byte aligned for cp.async;
//   - within a k-step the 8 reduction indices are permuted alike for A and B
//     (fragment column q < 4 takes channel 2q, q + 4 takes 2q + 1), so each
//     thread's two A values of a row, and its two B values of a plane, are
//     one 64-bit shared load;
//   - the wrapper splits the weights once per call (ops/groupconv.py:
//     tf32_split) and hands w_hi and w_lo over as [G, K*cig/8, cog, 8]:
//     k-step ks = j*cig/8 + ci/8, out-channel, ci % 8. A slice of RK
//     reduction steps for BN out-channels is then one contiguous run per
//     k-step, [BN][8] in shared memory, read without bank conflicts;
//   - weight slices are double-buffered with cp.async: slice i+1 loads while
//     slice i multiplies, one __syncthreads between them;
//   - two-level accumulation: the tensor cores add into their fp32
//     accumulator with truncation, which over the ~500-mma chain of a cig-32
//     layer biased y toward zero by ~6e-6 (measured on the card, some 6x
//     cuDNN's error). So each k-step's three products go into fresh
//     registers (C = 0), which are then added to the running sum with
//     ordinary round-to-nearest fp32 adds: 4 FADDs per fragment pair and
//     k-step, on the FMA pipe beside the tensor cores;
//   - ragged time tiles and out-channel tiles are zero-filled on load and
//     masked on store.
// Tiles, chosen by a sweep on the card over the 15 MSD geometries (tile
// sizes, warp tiles, RK 16-128, 2-4 stages): cog >= 64: BM 64, BN 64, warps
// 2 x 2 of 32 x 32; cog 32: BM 128 and warps 4 x 1 of 32 x 32 for s <= 2, BM
// 64 and warps 4 x 1 of 16 x 32 for s = 4; cog 16: BM 128, BN 16, warps of
// 32 x 16. Shared memory stays under 64 KB a block, so three blocks fit an
// SM; deeper pipelines lost more in resident blocks than they hid. Scale 1's
// first layer still runs at about a quarter of its 3xTF32 bound. mma.sync is
// used because each thread loads its fragments from any shared address,
// which the per-tap rows need; wgmma with A from registers and B through TMA
// into a swizzled tile is the next step, since K2 still trails its bound.
//
// K2-bf16 (groupconv_bf16_kernel, entry groupconv_forward_bf16) computes the
// same grouped conv for the "default" training rung, which the TPU kernel
// serves by running its dots at the input dtype (pallas_groupconv.py:60-62,
// 78-98): x and w rounded to bf16 (nearest even), one bf16 product per
// multiply-add, fp32 accumulation, fp32 output. It is written for Hopper's
// warpgroup products, both operands from shared memory:
//   - M runs over m64 slots: 64 outputs of one batch row each, slots =
//     ceil(T_out / 64) a row, the rows' slots one after another. A tile is
//     MI*NWG slots, so at scale 2-3's deep layers (T_out 63, 32) it holds
//     several batch rows; only a row's last slot past T_out is padding. Its
//     window is staged as one segment a batch row, rows t_lo*s - pad_l ..
//     t_hi*s - pad_l + K - 1, from a multiple of kRowBox rows;
//   - the window comes in by TMA (a 3-D map over x [B, T, Ci], boxes of
//     kRowBox rows x cig channels, zero-filled outside [0, T): the conv's
//     padding) into an fp32 staging buffer; the block's next window is
//     issued as soon as this one is converted, so it lands while this tile
//     multiplies. One pass in shared memory rounds it to bf16 into the
//     wgmma's no-swizzle K-major layout, polyphase: 16-byte core-matrix rows
//     of 8 channels at [channel chunk][row % s][row / s], zero chunks past
//     cig up to cigp (cig rounded up to 16; the MSD's 128 -> 256 layer has
//     cig 8). Output t's tap j is then row t + j/s of phase j % s, so an
//     m64 slot's k-step (tap j, 16 channels) is one descriptor: 8-row groups
//     128 bytes apart, the second 8 channels one chunk plane on;
//   - the product is wgmma.mma_async m64nBNk16 with A and B from shared
//     memory. B, the weights, come by TMA in 64-wide K-major boxes with the
//     128-byte swizzle, from a [Co, K*cigp] bf16 layout that a preparation
//     kernel writes once a call (k2bf16_weights_kernel; its plain version
//     ops/groupconv.py:kernel_weights_bf16);
//   - warp-specialized and persistent: one producer warp keeps a ring of
//     STAGES weight stages (KC boxes each) full by TMA on mbarriers and
//     issues the windows; one consumer warpgroup (NWG) issues a stage's
//     wgmmas back to back and keeps two stages in flight (wgmma.wait_group
//     1), releasing each stage's weights by mbarrier; a tile's first product
//     passes scale-d 0, and the last stage stops at the reduction's end.
//     Two consumer-only named barriers a tile guard the bf16 window; no
//     block-wide barrier runs after the set-up;
//   - y is stored from the accumulators with 8-byte stores (whole 32-byte
//     sectors per warp), masked past T_out and the last slot.
// What bounds it on the card: its fp32 x and y over HBM on 13 of the 15 MSD
// geometries, its bf16 product at the dense bf16 peak on scale 1-2's
// 1024 -> 1024 (chip_smoke.py:groupconv_bf16_bound_ms). Inside the kernel
// the shared-memory reads of the operands: an m64nBNk16 reads 2 KB of A and
// BN*32 bytes of B, which at BN 16-32 takes the port longer than the tensor
// cores take for the product, and the wgmmas of a stage are one dependent
// chain; tiles of two or four slots a warpgroup give more chains.
// Designs built first and measured slower (bare launches, 15 geometries at
// B=18, tools/torch_kernel_lab.py bf16; NVIDIA H100 80GB HBM3, 700 W):
//   - A from registers (the mma.m16n8k16 A layout, one 8-byte load per row
//     and k-step): 0.696-0.716 ms. Loading a k-step's A while the last
//     wgmma ran made ptxas serialize every wgmma; loading a stage's A before
//     its wgmmas cost the registers that held two blocks on an SM;
//   - rounding at fragment load from fp32 staging (no pass; two staging
//     buffers): 15-40% slower per geometry than the pass in shared memory;
//   - converting the next window during this tile's stages into a second
//     bf16 window: 0.763 ms against 0.599, the second window's shared
//     memory cost the scale-1 128 -> 128 layer its second block on an SM.
// Tiles (BN, CIGP, MI, NWG, KC, STAGES), chosen by that sweep over the
// swept list below: one consumer warpgroup throughout, its slots MI 2
// (MI 4 at cig 8) and stages of two 64-wide boxes; 0.549 ms, the parent's
// mma.sync kernel 0.981 ms in the same call.
//
// K2-bf16 dx (entry groupconv_input_grad_bf16) is the "default" rung's
// input gradient of the same conv,
//   dx[b, u, ci] = sum_o sum_{j = u + pad_l mod s} bf(w[o, ci, j])
//                                               * bf(gy[b, (u + pad_l - j) / s, o]),
// fp32 out. It replaces no Pallas kernel: it takes the place of the JAX
// package's XLA VJP (pallas_groupconv.py:151-158), and was added because
// the port's backward handed it to cuDNN (15-23 ms over the MSD's 15
// geometries a pass, bf16 results where JAX's DEFAULT returns fp32). Its
// bound is the forward's: bytes on 13 of the 15 geometries (gy and w read,
// dx written once), the bf16 product on scales 1 and 2's 1024 -> 1024. Its
// design is the forward kernel above run on one stride-1 conv of gy whose
// out-channels are dx's phases side by side (groupconv_bf16_kernel<...,
// true>): dx's padded row p = m*s + ph is the conv of gy with the taps j =
// ph + s*i, flipped, and each group's channel roles swapped (cig' = cog), so
// no product of the zeros a dilated gy would hold is computed. Every phase
// gets kp = ceil(K / s) taps, a phase with fewer padded with zero weights
// at the front, so that at k-step (row offset k, 16 channels) all s phases
// read the same gy rows: one A descriptor serves them all, and a group's
// s*cig columns are one B, N = s*cig (64, 16, 64, 128 and 64 on the MSD's
// five layers, where the first design ran a conv a phase with the phase in
// blockIdx.y at N = cig, 32/8/16/32/64: each phase re-read the same gy
// window, and at N 8-32 the A reads of a product outlasted it). The cost is
// the zero taps, kp*s - K of them (42 for 41 at s = 2, 44 at s = 4).
// k2bf16_dx_weights_kernel lays the weights out in the same C call (plain
// version ops/groupconv.py:kernel_weights_bf16_dx); the epilogue stores
// output t's column block ph at dx row t*s + ph - y_off, so each dx row is
// written once.

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "k2bf16.cuh"

namespace {

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;   // the low 13 bits, which the mma ignores, made zero
}

// d += a * b on the tensor cores (m16n8k8, tf32 in, fp32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, the same product into fresh registers
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's cp.async groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BM, int BN, int WM, int WN>
__host__ __device__ constexpr int threads_of() {
  return (BM / WM) * (BN / WN) * 32;
}

template <int BM, int BN, int WM, int WN, int RK, int STAGES>
__global__ void __launch_bounds__(threads_of<BM, BN, WM, WN>())
groupconv_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w_hi,
                        const float* __restrict__ w_lo, float* __restrict__ y, int T, int Ci,
                        int T_out, int Co, int cig, int cog, int K, int stride, int pad_l,
                        int n_co_tiles, int rpp, int xpitch) {
  constexpr int THREADS = threads_of<BM, BN, WM, WN>();
  constexpr int MI = WM / 16, NI = WN / 8, KS = RK / 8;
  constexpr int W_PLANE = RK * BN;   // floats of one weight plane of one stage
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                // [s][rpp][xpitch], polyphase rows
  float* ws = smem + stride * rpp * xpitch;        // [STAGES][hi, lo][KS][BN][8]

  const int g = blockIdx.y / n_co_tiles;
  const int co0 = (blockIdx.y - g * n_co_tiles) * BN;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int W = (BM - 1) * stride + K;
  const int CQ = cig / 4;            // 16-byte chunks of a window row
  const int NKS = K * cig / 8;       // k-steps
  const int n_slices = (NKS + KS - 1) / KS;

  const float* xb = x + (size_t)b * T * Ci + (size_t)g * cig;
  const int tin0 = t0 * stride - pad_l;
  for (int e = threadIdx.x; e < W * CQ; e += THREADS) {
    const int r = e / CQ, q = e - r * CQ;
    const int tin = tin0 + r;
    const bool ok = tin >= 0 && tin < T;
    const int row = (r % stride) * rpp + r / stride;
    cp_async16(xs + row * xpitch + q * 4, ok ? xb + (size_t)tin * Ci + q * 4 : x, ok);
  }
  cp_async_commit();

  const float* wg_hi = w_hi + (size_t)g * NKS * cog * 8;
  const float* wg_lo = w_lo + (size_t)g * NKS * cog * 8;
  auto load_slice = [&](int i) {
    float* dst = ws + (i % STAGES) * 2 * W_PLANE;
    for (int e = threadIdx.x; e < KS * BN * 2; e += THREADS) {
      const int ksl = e / (2 * BN), rem = e - ksl * 2 * BN, n = rem >> 1, h = rem & 1;
      const int ks = i * KS + ksl;
      const bool ok = ks < NKS && co0 + n < cog;
      const size_t src = ((size_t)ks * cog + co0 + n) * 8 + h * 4;
      const int d = (ksl * BN + n) * 8 + h * 4;
      cp_async16(dst + d, ok ? wg_hi + src : w_hi, ok);
      cp_async16(dst + W_PLANE + d, ok ? wg_lo + src : w_lo, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_slices) load_slice(i);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp % (BM / WM)) * WM;
  const int wn0 = (warp / (BM / WM)) * WN;
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  // the k-step's tap j and channel block c8, and the shared offset of its A
  // values for this thread: row (j % s)*rpp + j/s + wm0 + gid, column c8 + 2*tig
  int c8 = 0, phase = 0;
  int a_off = (wm0 + gid) * xpitch + 2 * tig;
  const int phase_step = rpp * xpitch;

  for (int i = 0; i < n_slices; ++i) {
    if (i + STAGES - 1 < n_slices) load_slice(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // the window (first time) and slice i are in
    __syncthreads();
    const float* wsh = ws + (i % STAGES) * 2 * W_PLANE;
    const float* wsl = wsh + W_PLANE;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (i * KS + kk >= NKS) break;
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int o = a_off + mi * 16 * xpitch;
        const float2 r0 = *reinterpret_cast<const float2*>(xs + o);
        const float2 r1 = *reinterpret_cast<const float2*>(xs + o + 8 * xpitch);
        const float a[4] = {r0.x, r1.x, r0.y, r1.y};   // rows gid, gid + 8; columns
#pragma unroll                                         // tig, tig, tig + 4, tig + 4
        for (int c = 0; c < 4; ++c) {
          ah[mi][c] = tf32_bits(a[c]);
          al[mi][c] = tf32_bits(a[c] - __uint_as_float(ah[mi][c]));
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int o = (kk * BN + wn0 + ni * 8 + gid) * 8 + 2 * tig;
        const float2 h = *reinterpret_cast<const float2*>(wsh + o);
        const float2 l = *reinterpret_cast<const float2*>(wsl + o);
        bh[ni][0] = __float_as_uint(h.x);    // row tig,     column gid
        bh[ni][1] = __float_as_uint(h.y);    // row tig + 4, column gid
        bl[ni][0] = __float_as_uint(l.x);
        bl[ni][1] = __float_as_uint(l.y);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          float d[4];
          mma_tf32_fresh(d, ah[mi], bh[ni]);
          mma_tf32(d, al[mi], bh[ni]);
          mma_tf32(d, ah[mi], bl[ni]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += d[c];
        }
      // next k-step: 8 channels on, or the next tap (next phase, or the
      // first phase one row on)
      c8 += 8;
      a_off += 8;
      if (c8 == cig) {
        c8 = 0;
        a_off += phase_step - cig;
        if (++phase == stride) {
          phase = 0;
          a_off += xpitch - stride * phase_step;
        }
      }
    }
    __syncthreads();   // slice i is consumed before slice i + STAGES lands in its buffer
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = co0 + wn0 + ni * 8 + 2 * tig;
      if (n >= cog) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wm0 + mi * 16 + gid + 8 * h;
        if (t < T_out)
          *reinterpret_cast<float2*>(y + ((size_t)b * T_out + t) * Co + (size_t)g * cog + n) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

template <int BM, int BN, int WM, int WN, int RK, int STAGES>
int launch(const float* x, const float* w_hi, const float* w_lo, float* y, int B, int T,
           int Ci, int T_out, int Co, int groups, int K, int stride, int pad_l, cudaStream_t s) {
  const int cig = Ci / groups, cog = Co / groups;
  const long long W = (long long)(BM - 1) * stride + K;
  const long long rpp = (W + stride - 1) / stride;
  const int xpitch = (cig / 8) % 2 ? cig : cig + 8;
  const long long smem =
      (1LL * stride * rpp * xpitch + 2LL * STAGES * RK * BN) * (long long)sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = groupconv_tf32x3_kernel<BM, BN, WM, WN, RK, STAGES>;
  static size_t opted[conan::kMaxDevices] = {};
  const cudaError_t e = conan::allow_dynamic_smem(kernel, (size_t)smem, opted);
  if (e != cudaSuccess) return (int)e;
  const int n_co_tiles = (cog + BN - 1) / BN;
  const dim3 grid((T_out + BM - 1) / BM, groups * n_co_tiles, B);
  kernel<<<grid, threads_of<BM, BN, WM, WN>(), smem, s>>>(
      x, w_hi, w_lo, y, T, Ci, T_out, Co, cig, cog, K, stride, pad_l, n_co_tiles, (int)rpp,
      xpitch);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K2-bf16: warp-specialized wgmma implicit GEMM (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kSlot = 64;     // outputs of one batch row an m64 block holds

// the consumer warpgroups' own barrier (named barrier 1; the producer warp
// never joins it)
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

struct Bf16Args {
  float* y;
  int B, T_out, Co, cig, cog, K, stride, pad_l, groups;
  int slots;        // m64 slots a batch row: ceil(T_out / 64)
  int win_rows;     // fp32 staging rows
  int win_u;        // bf16 window rows a phase: win_rows / stride, and a slot's reach
  int alloc_full;   // staging rows of a whole batch row's window (a multiple of kRowBox)
  int n_co_tiles, n_tiles;
  int nks;          // k-steps of 16 a tile: K * cigp / 16
  // The input gradient (groupconv_bf16_kernel<..., true>): this conv's
  // out-channel ph * dx_cig + ci of group g is dx's phase ph, channel g *
  // dx_cig + ci of Co / dx_s, and its output t of batch row b goes to dx row
  // t * dx_s + ph - y_off of y_rows (rows outside not stored).
  int dx_s, dx_cig, y_rows, y_off;
};

// M tile mt: the m64 slots v0 .. v1-1 (slot v: batch row v / slots, outputs
// 64 * (v % slots) ..), and the window segments they read, one a batch row
// b_first .. b_last: the first from output t_lo_first, its window taking
// alloc_first staging rows, each later one alloc_full (the last no more)
struct TileRows {
  int v0, v1, b_first, b_last, t_lo_first, alloc_first;
};

__device__ __forceinline__ int seg_t_hi(const Bf16Args& a, int v1, int b) {
  return min((v1 - b * a.slots) * kSlot, a.T_out) - 1;
}

__device__ __forceinline__ TileRows tile_rows(const Bf16Args& a, int mt, int mb) {
  TileRows r;
  r.v0 = mt * mb;
  r.v1 = min(r.v0 + mb, a.B * a.slots);
  r.b_first = r.v0 / a.slots;
  r.b_last = (r.v1 - 1) / a.slots;
  r.t_lo_first = (r.v0 - r.b_first * a.slots) * kSlot;
  const int t_hi = r.b_first == r.b_last ? seg_t_hi(a, r.v1, r.b_first) : a.T_out - 1;
  r.alloc_first = round_up((t_hi - r.t_lo_first) * a.stride + a.K, kRowBox);
  return r;
}

// the staging row of output t of batch row b (b_first <= b <= b_last)
__device__ __forceinline__ int window_row(const Bf16Args& a, const TileRows& r, int b, int t) {
  if (b == r.b_first) return (t - r.t_lo_first) * a.stride;
  return r.alloc_first + (b - r.b_first - 1) * a.alloc_full + t * a.stride;
}

template <int BN, int CIGP, int MI, int NWG, int KC, int STAGES>
struct Bf16Tiles {
  static constexpr int MB = MI * NWG;                // m64 slots a tile
  static constexpr int CONSUMERS = NWG * 128;
  static constexpr int THREADS = CONSUMERS + 32;     // + the producer warp
  static constexpr int BOX_BYTES = BN * 128;         // one [BN][64] bf16 weight box
  static constexpr int STAGE_BYTES = KC * BOX_BYTES;
  static constexpr int KSTEPS = 4 * KC;              // k-steps of 16 a stage
  static constexpr int TAPS = KC * 64 / CIGP;        // taps a stage
  static_assert(CIGP == 16 || CIGP == 32 || CIGP == 64, "cigp divides a 64-wide box");
  static_assert(BN == 8 || BN == 16 || BN == 32 || BN == 64 || BN == 128,
                "wgmma widths instantiated");
};

size_t bf16_smem_bytes(int bn, int kc, int stages, int win_rows, int win_u, int cig, int stride) {
  const int cigp = round_up(cig, 16);
  size_t bytes = 1024 + (size_t)stages * kc * bn * 128 + (size_t)win_rows * cig * 4 +
                 (size_t)(cigp / 8) * stride * win_u * 16;
  return bytes + 8 * (2 * stages + 2);
}

// the staging rows tile r's segments take
__device__ __forceinline__ int staged_rows(const Bf16Args& a, const TileRows& r) {
  const int span = r.b_last - r.b_first;
  if (span == 0) return r.alloc_first;
  return r.alloc_first + (span - 1) * a.alloc_full +
         round_up(seg_t_hi(a, r.v1, r.b_last) * a.stride + a.K, kRowBox);
}

template <int BN, int CIGP, int MI, int NWG, int KC, int STAGES, bool DX>
__global__ void __launch_bounds__(Bf16Tiles<BN, CIGP, MI, NWG, KC, STAGES>::THREADS, 1)
groupconv_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap, const Bf16Args a) {
  using P = Bf16Tiles<BN, CIGP, MI, NWG, KC, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* stg = reinterpret_cast<float*>(wring + STAGES * P::STAGE_BYTES);   // [win_rows][cig]
  unsigned char* win = reinterpret_cast<unsigned char*>(stg + a.win_rows * a.cig);
  const int plane = a.stride * a.win_u * 16;   // bytes of one 8-channel chunk's phases
  uint64_t* full = reinterpret_cast<uint64_t*>(win + (CIGP / 8) * plane);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;
  uint64_t* wempty = wfull + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, NWG * 4);   // lane 0 of each consumer warp
    }
    mbar_init(wfull, 1);
    mbar_init(wempty, NWG * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nks = a.nks, pad = a.pad_l;
  const int nchunks = (nks + P::KSTEPS - 1) / P::KSTEPS;   // stages a tile
  const int per_m = a.groups * a.n_co_tiles;

  if (warp == NWG * 4) {
    // the producer: window of the block's first tile, then for each tile its
    // weight stages, with the next tile's window issued once this tile's
    // window is converted (before stage STAGES, or after the last stage)
    if (lane != 0) return;
    auto load_window = [&](int tile, int i) {
      mbar_wait(wempty, (i & 1) ^ 1);
      const TileRows r = tile_rows(a, tile / per_m, P::MB);
      const int g = (tile % per_m) / a.n_co_tiles;
      mbar_expect_tx(wfull, (uint32_t)staged_rows(a, r) * a.cig * 4);
      int row = 0;
      for (int b = r.b_first; b <= r.b_last; ++b) {
        const int t_lo = b == r.b_first ? r.t_lo_first : 0;
        const int t_hi = b == r.b_last ? seg_t_hi(a, r.v1, b) : a.T_out - 1;
        const int n = (t_hi - t_lo) * a.stride + a.K;
        const int in0 = t_lo * a.stride - pad;
        for (int k = 0; k < n; k += kRowBox)
          tma_load_3d(stg + (row + k) * a.cig, &xmap, wfull, g * a.cig, in0 + k, b);
        row += b == r.b_first ? r.alloc_first : a.alloc_full;
      }
    };
    int chunk = 0, it = 0;
    if (blockIdx.x < a.n_tiles) load_window(blockIdx.x, 0);
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++it) {
      const int rest = tile % per_m, g = rest / a.n_co_tiles, ct = rest % a.n_co_tiles;
      const int next = tile + gridDim.x;
      const int w_row = g * a.cog + ct * BN;
      for (int c = 0; c < nchunks; ++c, ++chunk) {
        if (c == STAGES && next < a.n_tiles) load_window(next, it + 1);
        const int st = chunk % STAGES;
        mbar_wait(empty + st, ((chunk / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + st, P::STAGE_BYTES);
#pragma unroll
        for (int kb = 0; kb < KC; ++kb)
          tma_load_2d(wring + st * P::STAGE_BYTES + kb * P::BOX_BYTES, &wmap, full + st,
                      (c * KC + kb) * 64, w_row);
      }
      if (nchunks <= STAGES && next < a.n_tiles) load_window(next, it + 1);
    }
    return;
  }

  // the consumers: warpgroup wg multiplies the tile's m64 slots wg*MI ..
  // wg*MI + MI - 1; warp wl of it holds rows 16*wl .. 16*wl + 15 of each
  const int wg = warp / 4, wl = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;
  const int lg_s = __ffs(a.stride) - 1;   // the stride is a power of two (checked on the host)
  float acc[MI][BN / 2];
  int chunk = 0, it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++it) {
    const int rest = tile % per_m, g = rest / a.n_co_tiles, ct = rest % a.n_co_tiles;
    const TileRows r = tile_rows(a, tile / per_m, P::MB);
    mbar_wait(wfull, it & 1);
    // one pass: staging row q (fp32, cig channels) rounded to bf16 into the
    // window as 16-byte chunks of 8 channels at [chunk][q % s][q / s],
    // chunks past cig zero
    const int rows = staged_rows(a, r);
    consumer_sync<P::CONSUMERS>();   // every consumer's wgmmas are done with the last window
    constexpr int C8 = CIGP / 8;
    for (int e = threadIdx.x; e < rows * C8; e += P::CONSUMERS) {
      const int q = e / C8, c8 = e - q * C8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c8 * 8 < a.cig) {
        const float4 x0 = *reinterpret_cast<const float4*>(stg + q * a.cig + c8 * 8);
        const float4 x1 = *reinterpret_cast<const float4*>(stg + q * a.cig + c8 * 8 + 4);
        v = make_uint4(bf16x2_bits(x0.x, x0.y), bf16x2_bits(x0.z, x0.w), bf16x2_bits(x1.x, x1.y),
                       bf16x2_bits(x1.z, x1.w));
      }
      *reinterpret_cast<uint4*>(win + c8 * plane +
                                ((q & (a.stride - 1)) * a.win_u + (q >> lg_s)) * 16) = v;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(wempty);   // the staging buffer may be refilled
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // the window, to wgmma
    consumer_sync<P::CONSUMERS>();

    // each m64 slot's first window row, in rows of its phase plane
    int u0[MI];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int v = min(r.v0 + wg * MI + mi, r.v1 - 1);   // a slot past the tile: any, unstored
      const int b = v / a.slots;
      u0[mi] = window_row(a, r, b, (v - b * a.slots) * kSlot) >> lg_s;
    }
    const uint32_t win_s = smem_u32(win);
    for (int c = 0; c < nchunks; ++c, ++chunk) {
      const int st = chunk % STAGES;
      const uint32_t ws = smem_u32(wring + st * P::STAGE_BYTES);
      const int tap0 = c * P::TAPS;
      mbar_wait(full + st, (chunk / STAGES) & 1);
      wgmma_fence();
      // the stage's k-steps; the last stage's stop at the reduction's end
      // (the window rows past it may hold anything, and NaN * 0 is NaN), a
      // check that full stages go without
      auto issue = [&](auto partial) {
#pragma unroll
        for (int kk = 0; kk < P::KSTEPS; ++kk) {
          if (decltype(partial)::value && c * P::KSTEPS + kk >= nks) break;
          // k-step kk: tap j, channels c16*16 .. +15 (chunks 2*c16, 2*c16 + 1)
          const int j = tap0 + (kk * 16) / CIGP, c16 = ((kk * 16) % CIGP) / 16;
          const uint32_t a_base =
              win_s + 2 * c16 * plane + ((j & (a.stride - 1)) * a.win_u + (j >> lg_s)) * 16;
          const uint64_t bd = b_desc(ws + (kk / 4) * P::BOX_BYTES + (kk % 4) * 32);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            Wgmma<BN>::mma(acc[mi], a_desc(a_base + u0[mi] * 16, plane), bd, c > 0 || kk > 0);
        }
      };
      if ((c + 1) * P::KSTEPS <= nks)
        issue(std::false_type{});
      else
        issue(std::true_type{});
      wgmma_commit();
      wgmma_wait<1>();   // the stage before this one is done: release its weights
      if (c > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (chunk - 1) % STAGES);
      }
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + (chunk - 1) % STAGES);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) fence_acc(acc[mi]);

    // the input gradient's first column of this thread: phase and channel
    const int dx_ci = a.Co / a.dx_s, dx_ph0 = (ct * BN + 2 * tig) / a.dx_cig;
    const int dx_ci0 = ct * BN + 2 * tig - dx_ph0 * a.dx_cig;
    const bool one_phase = a.dx_cig % BN == 0;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int v = r.v0 + wg * MI + mi;
      if (v >= r.v1) continue;
      const int b = v / a.slots;
      float* dx_row = a.y + (size_t)b * a.y_rows * dx_ci + g * a.dx_cig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = (v - b * a.slots) * kSlot + wl * 16 + gid + 8 * h;
        if (t >= a.T_out) continue;
        if constexpr (DX) {
          // column n = ct*BN + 8*nb + 2*tig: phase ph = n / dx_cig, channel
          // ci (a float2 stays in one phase: dx_cig is a multiple of 8), dx
          // row t*s + ph - y_off; (ph, ci) advanced 8 columns a step, or one
          // row for the tile where its columns are one phase's
          int ph = dx_ph0, ci = dx_ci0;
          if (one_phase) {
            const int row = t * a.dx_s + ph - a.y_off;
            if (row < 0 || row >= a.y_rows) continue;
            float* yr = dx_row + (size_t)row * dx_ci + ci;
#pragma unroll
            for (int nb = 0; nb < BN / 8; ++nb)
              *reinterpret_cast<float2*>(yr + 8 * nb) =
                  make_float2(acc[mi][4 * nb + 2 * h], acc[mi][4 * nb + 2 * h + 1]);
            continue;
          }
#pragma unroll
          for (int nb = 0; nb < BN / 8; ++nb) {
            const int row = t * a.dx_s + ph - a.y_off;
            if (row >= 0 && row < a.y_rows)
              *reinterpret_cast<float2*>(dx_row + (size_t)row * dx_ci + ci) =
                  make_float2(acc[mi][4 * nb + 2 * h], acc[mi][4 * nb + 2 * h + 1]);
            ci += 8;
            if (ci >= a.dx_cig) ci -= a.dx_cig, ++ph;
          }
        } else {
          float* yr = a.y + ((size_t)b * a.T_out + t) * a.Co + g * a.cog + ct * BN + 2 * tig;
#pragma unroll
          for (int nb = 0; nb < BN / 8; ++nb)
            *reinterpret_cast<float2*>(yr + 8 * nb) =
                make_float2(acc[mi][4 * nb + 2 * h], acc[mi][4 * nb + 2 * h + 1]);
        }
      }
    }
  }
}

// wq[n, j*cigp + ci] = bf16(w[n, ci, j]), 0 where ci >= cig: the weights in
// the layout groupconv_bf16_kernel's TMA reads (ops/groupconv.py:
// kernel_weights_bf16). A block an out-channel: its cig x K weights read in
// order into shared memory, its K*cigp written in order.
__global__ void k2bf16_weights_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wq,
                                      int cig, int cigp, int K) {
  extern __shared__ float w_n[];   // [cig][K]
  const int n = blockIdx.x;
  for (int e = threadIdx.x; e < cig * K; e += blockDim.x) w_n[e] = w[(size_t)n * cig * K + e];
  __syncthreads();
  for (int p = threadIdx.x; p < K * cigp; p += blockDim.x) {
    const int j = p / cigp, ci = p - j * cigp;
    wq[(size_t)n * K * cigp + p] = __float2bfloat16_rn(ci < cig ? w_n[ci * K + j] : 0.f);
  }
}

// The input gradient's weights, the phases side by side in N: for phase ph
// (taps(ph) = ceil((K - ph) / s)) and k < kp = ceil(K / s)
// wq[(g*s + ph)*cig + ci, k*cogp + c] = bf16(w[g*cog + c, ci, ph + s*(kp - 1 - k)])
// where kp - 1 - k < taps(ph) and c < cog, else 0: each phase's taps flipped
// and padded at the front, so that tap k of every phase reads the same gy
// row, and each group's channel roles swapped (ops/groupconv.py:
// kernel_weights_bf16_dx). A block an in-channel g*cig + ci: its cog x K
// weights into shared memory, its s rows written in order.
__global__ void k2bf16_dx_weights_kernel(const float* __restrict__ w,
                                         __nv_bfloat16* __restrict__ wq, int cig, int cog,
                                         int cogp, int K, int s, int kp) {
  extern __shared__ float w_n[];   // [cog][K]
  const int n = blockIdx.x, g = n / cig, ci = n - g * cig;
  for (int e = threadIdx.x; e < cog * K; e += blockDim.x) {
    const int c = e / K, j = e - c * K;
    w_n[e] = w[((size_t)(g * cog + c) * cig + ci) * K + j];
  }
  __syncthreads();
  const int row = kp * cogp;
  for (int e = threadIdx.x; e < s * row; e += blockDim.x) {
    const int ph = e / row, q = e - ph * row, k = q / cogp, c = q - k * cogp;
    const int j = ph + s * (kp - 1 - k);
    const float v = j < K && c < cog ? w_n[c * K + j] : 0.f;
    wq[((size_t)(g * s + ph) * cig + ci) * row + q] = __float2bfloat16_rn(v);
  }
}

// The input gradient as one stride-1 conv of gy whose s*cig out-channels a
// group are dx's phases side by side: dx's padded row p = m*s + ph (m = m0 +
// t, m0 = pad_l / s) is output t's column block ph; kp = ceil(K / s) taps,
// t_m outputs, the window `pad` rows to the left of t, output t's block ph
// stored at dx row t*s + ph - y_off.
struct DxGeometry {
  int kp, t_m, pad, y_off;
};

DxGeometry dx_geometry(int T, int K, int stride, int pad_l) {
  const int m0 = pad_l / stride, kp = (K + stride - 1) / stride;
  return {kp, (T - 1 + pad_l) / stride - m0 + 1, kp - 1 - m0, pad_l - m0 * stride};
}


// The tile plan ops/groupconv.py:bf16_plan chooses, checked here.
struct Bf16Plan {
  int bn, mi, nwg, kc, stages, win_rows, win_u;
};

// the geometry's kernel arguments, or false for what the kernel does not
// take (a negative pad_l only for the input gradient's conv, `dx`)
bool bf16_args(int B, int T, int Ci, int T_out, int Co, int groups, int K, int stride,
               int pad_l, const Bf16Plan& p, Bf16Args* a, bool dx = false) {
  if (groups < 1 || Ci % groups || Co % groups || B < 1 || T < 1 || T_out < 1 || K < 1 ||
      stride < 1 || stride > 8 || (stride & (stride - 1)) || (pad_l < 0 && !dx) ||
      p.bn < 1 || p.mi < 1 || p.nwg < 1 || p.win_rows < 1 || p.win_rows % kRowBox)
    return false;
  const int cig = Ci / groups, cog = Co / groups;
  const int cigp = round_up(cig, 16);
  if (cig % 8 || cig > 64 || cog % p.bn) return false;
  const int mb = p.mi * p.nwg, slots = (T_out + kSlot - 1) / kSlot;
  const long long n_slots = (long long)B * slots;
  if (n_slots + mb > (1LL << 31) || (long long)Co * K * cigp >= (1LL << 31)) return false;
  const int alloc_full = round_up((T_out - 1) * stride + K, kRowBox);
  // the most staging rows a tile's segments take, and the window rows its
  // descriptors reach (ops/groupconv.py:bf16_plan)
  const int nseg = min(B, (mb - 1) / slots + 2);
  const int outs = min(mb * kSlot, nseg * T_out);
  const int need = min(nseg * alloc_full, (outs - nseg) * stride + nseg * (K + kRowBox - 1));
  if (p.win_rows < round_up(need, kRowBox) || p.win_u < p.win_rows / stride + kSlot) return false;
  const long long n_tiles = (n_slots + mb - 1) / mb * groups * (cog / p.bn);
  if (n_tiles >= (1LL << 31)) return false;
  *a = Bf16Args{nullptr, B, T_out, Co, cig, cog, K, stride, pad_l, groups, slots, p.win_rows,
                p.win_u, alloc_full, cog / p.bn, (int)n_tiles, K * cigp / 16, 1, 8, T_out, 0};
  return true;
}

// the weights' and x's tensor maps for tile width bn: maps[0] over wq
// [w_rows, K*cigp] bf16 (boxes [bn][64], 128-byte swizzle; w_rows is Co, or
// phases x Co for the input gradient), maps[1] over x [B, T, Ci] fp32
// (boxes [1][kRowBox][cig], zero fill outside)
int bf16_maps(const float* x, const void* wq, int B, int T, int Ci, int w_rows, int groups,
              int K, int bn, CUtensorMap* maps) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorInitializationError;
  const int cig = Ci / groups, cigp = round_up(cig, 16);
  const cuuint64_t w_dim[2] = {(cuuint64_t)K * cigp, (cuuint64_t)w_rows};
  const cuuint64_t w_stride[1] = {(cuuint64_t)K * cigp * 2};
  const cuuint32_t w_box[2] = {64, (cuuint32_t)bn}, ones[2] = {1, 1};
  CUresult e = encode(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wq),
                      w_dim, w_stride, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (e != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  e = fp32_rows_map(&maps[1], x, B, T, Ci, cig);
  return e == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int CIGP, int MI, int NWG, int KC, int STAGES, bool DX>
int launch_bf16(const CUtensorMap* maps, const Bf16Args& a, cudaStream_t s) {
  using P = Bf16Tiles<BN, CIGP, MI, NWG, KC, STAGES>;
  const size_t smem = bf16_smem_bytes(BN, KC, STAGES, a.win_rows, a.win_u, a.cig, a.stride);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = groupconv_bf16_kernel<BN, CIGP, MI, NWG, KC, STAGES, DX>;
  static size_t opted[conan::kMaxDevices] = {};
  cudaError_t e = conan::allow_dynamic_smem(kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  // the persistent grid: as many blocks as the device holds at once, kept
  // per device and shared-memory size (the occupancy query costs each of a
  // step's 45 calls host time otherwise)
  struct Grid {
    int dev;
    size_t smem;
    int blocks;
  };
  static Grid grids[16] = {};
  static int n_grids = 0;
  static std::mutex grids_mutex;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  int blocks = 0;
  {
    const std::lock_guard<std::mutex> lock(grids_mutex);
    for (int i = 0; i < min(n_grids, 16); ++i)
      if (grids[i].dev == dev && grids[i].smem == smem) blocks = grids[i].blocks;
  }
  if (!blocks) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P::THREADS, smem)) !=
        cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidValue;
    blocks = sms * per_sm;
    const std::lock_guard<std::mutex> lock(grids_mutex);
    grids[n_grids++ % 16] = Grid{dev, smem, blocks};
  }
  kernel<<<min(a.n_tiles, blocks), P::THREADS, smem, s>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

// The instantiated tiles: (BN, CIGP, MI, NWG, KC, STAGES).
// ops/groupconv.py:bf16_plan picks among the shipped ones (BF16_TILES), and
// for the input gradient among K2BF16_DX_TILES (BF16_DX_TILES): on the MSD
// its s*cig out-channels over cigp = cog rounded up to 16 are 64 over 32,
// 16 over 16, 64 and 128 over 64; 32 over 32 serves other geometries (the
// CPU tests').
#define K2BF16_SHIPPED(X) \
  X(64, 64, 2, 1, 2, 3)   \
  X(64, 32, 2, 1, 2, 3)   \
  X(32, 32, 2, 1, 2, 4)   \
  X(32, 16, 2, 1, 2, 4)   \
  X(16, 16, 4, 1, 2, 3)

#define K2BF16_DX_TILES(X) \
  X(128, 64, 2, 1, 2, 3)   \
  X(64, 64, 2, 1, 2, 3)    \
  X(64, 32, 2, 1, 2, 3)    \
  X(32, 32, 2, 1, 2, 4)    \
  X(16, 16, 4, 1, 2, 3)

// Built only for tools/torch_kernel_lab.py's sweep (-DK2BF16_SWEEP).
#ifdef K2BF16_SWEEP
#define K2BF16_SWEPT(X) \
  X(64, 64, 1, 2, 2, 3) \
  X(64, 64, 1, 1, 2, 3) \
  X(64, 64, 1, 1, 1, 3) \
  X(64, 64, 1, 1, 1, 4) \
  X(64, 64, 2, 2, 1, 3) \
  X(64, 32, 1, 2, 2, 3) \
  X(64, 32, 1, 1, 2, 4) \
  X(64, 32, 1, 1, 1, 3) \
  X(64, 32, 2, 1, 1, 3) \
  X(32, 32, 1, 2, 2, 4) \
  X(32, 32, 2, 1, 2, 3) \
  X(32, 32, 1, 1, 2, 4) \
  X(32, 32, 4, 1, 2, 3) \
  X(32, 16, 1, 2, 2, 4) \
  X(32, 16, 2, 1, 2, 3) \
  X(32, 16, 1, 1, 2, 4) \
  X(32, 16, 4, 1, 2, 3) \
  X(16, 16, 2, 1, 2, 3) \
  X(16, 16, 2, 1, 2, 4) \
  X(16, 16, 4, 1, 1, 3) \
  X(16, 16, 4, 1, 2, 4)
#else
#define K2BF16_SWEPT(X)
#endif

int dispatch_bf16(const CUtensorMap* maps, const Bf16Args& a, const Bf16Plan& p,
                  cudaStream_t s, bool dx = false) {
  const int cigp = round_up(a.cig, 16);
#define K2BF16_TRY(BN, CIGP, MI, NWG, KC, ST, DX)                                        \
  if (dx == DX && p.bn == BN && cigp == CIGP && p.mi == MI && p.nwg == NWG &&            \
      p.kc == KC && p.stages == ST)                                                      \
    return launch_bf16<BN, CIGP, MI, NWG, KC, ST, DX>(maps, a, s);
#define K2BF16_FWD(BN, CIGP, MI, NWG, KC, ST) K2BF16_TRY(BN, CIGP, MI, NWG, KC, ST, false)
#define K2BF16_BWD(BN, CIGP, MI, NWG, KC, ST) K2BF16_TRY(BN, CIGP, MI, NWG, KC, ST, true)
  K2BF16_SHIPPED(K2BF16_FWD)
  K2BF16_SWEPT(K2BF16_FWD)
  K2BF16_DX_TILES(K2BF16_BWD)
#undef K2BF16_BWD
#undef K2BF16_FWD
#undef K2BF16_TRY
  return (int)cudaErrorInvalidValue;   // a tile not instantiated
}

int bf16_weights(const float* w, void* wq, int Co, int cig, int K, cudaStream_t s) {
  if ((size_t)cig * K * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  k2bf16_weights_kernel<<<Co, 256, (size_t)cig * K * sizeof(float), s>>>(
      w, static_cast<__nv_bfloat16*>(wq), cig, round_up(cig, 16), K);
  return (int)cudaGetLastError();
}

int bf16_dx_weights(const float* w, void* wq, int Ci, int Co, int groups, int K, int stride,
                    cudaStream_t s) {
  const int cig = Ci / groups, cog = Co / groups;
  if ((size_t)cog * K * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  k2bf16_dx_weights_kernel<<<Ci, 256, (size_t)cog * K * sizeof(float), s>>>(
      w, static_cast<__nv_bfloat16*>(wq), cig, cog, round_up(cog, 16), K, stride,
      (K + stride - 1) / stride);
  return (int)cudaGetLastError();
}

// the input gradient's kernel arguments (its conv's Ci is Co, its Co is
// stride * Ci: the phases side by side)
bool dx_args(int B, int T, int Ci, int T_out, int Co, int groups, int K, int stride, int pad_l,
             const Bf16Plan& p, Bf16Args* a) {
  if (stride < 1 || stride > 8 || K < stride || pad_l < 0 || T < 1 || Ci % groups ||
      (Ci / groups) % 8)
    return false;
  const DxGeometry d = dx_geometry(T, K, stride, pad_l);
  if (d.t_m < 1 || !bf16_args(B, T_out, Co, d.t_m, stride * Ci, groups, d.kp, 1, d.pad, p, a,
                              true))
    return false;
  a->dx_s = stride;
  a->dx_cig = Ci / groups;
  a->y_rows = T;
  a->y_off = d.y_off;
  return true;
}

}  // namespace

// x [B, T, Ci] (16-byte aligned); w_hi, w_lo [groups, K*cig/8, cog, 8], the
// tf32 split of the weights in the order above; y [B, T_out, Co]; all fp32,
// contiguous, on the current device; cig = Ci/groups and cog = Co/groups
// multiples of 8; T_out = (T + pad_l + pad_r - K) / stride + 1, computed by
// the caller. Dilation is 1: the MSD, its only caller, dilates nothing.
// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for what it does not take).
extern "C" int groupconv_forward(const float* x, const float* w_hi, const float* w_lo,
                                 float* y, int B, int T, int Ci, int T_out, int Co, int groups,
                                 int K, int stride, int pad_l, void* stream) {
  if (groups < 1 || Ci % groups || Co % groups || (Ci / groups) % 8 || (Co / groups) % 8 ||
      K < 1 || stride < 1 || T_out < 1 || B < 1 || B > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const int cog = Co / groups;
  const cudaStream_t s = (cudaStream_t)stream;
  if (cog >= 64)
    return launch<64, 64, 32, 32, 16, 2>(x, w_hi, w_lo, y, B, T, Ci, T_out, Co, groups, K, stride,
                                      pad_l, s);
  if (cog >= 32 && stride <= 2)
    return launch<128, 32, 32, 32, 32, 2>(x, w_hi, w_lo, y, B, T, Ci, T_out, Co, groups, K,
                                       stride, pad_l, s);
  if (cog >= 32)
    return launch<64, 32, 16, 32, 32, 2>(x, w_hi, w_lo, y, B, T, Ci, T_out, Co, groups, K, stride,
                                      pad_l, s);
  return launch<128, 16, 32, 16, 64, 2>(x, w_hi, w_lo, y, B, T, Ci, T_out, Co, groups, K, stride,
                                     pad_l, s);
}

// K2-bf16's entry points. Geometry as groupconv_forward's; w [Co, cig, K]
// fp32 contiguous; wq the [Co, K*cigp] bf16 layout k2bf16_weights_kernel
// writes (16-byte aligned); y [B, T_out, Co] fp32 (8-byte aligned); the tile
// plan (bn, mi, nwg, kc, stages, win_rows, win_u) from
// ops/groupconv.py:bf16_plan. Each returns cudaGetLastError() after its
// launches, cudaErrorInvalidValue for what the kernel does not take (cig
// past 64 or not a multiple of 8, cog not a multiple of bn, a stride that is
// not 1, 2, 4 or 8, a tile that is not instantiated or does not fit shared
// memory).

// the weights, rounded and laid out for the kernel: one launch on `stream`
extern "C" int groupconv_bf16_weights(const float* w, void* wq, int Co, int cig, int K,
                                      void* stream) {
  if (Co < 1 || cig < 1 || cig > 64 || cig % 8 || K < 1 ||
      reinterpret_cast<uintptr_t>(wq) % 16)
    return (int)cudaErrorInvalidValue;
  return bf16_weights(w, wq, Co, cig, K, (cudaStream_t)stream);
}

// the two tensor maps of a call, copied to the 256 bytes at `maps` (host only)
extern "C" int groupconv_bf16_describe(const float* x, const void* wq, int B, int T, int Ci,
                                       int Co, int groups, int K, int bn, void* maps) {
  if (groups < 1 || Ci % groups || Co % groups || (Ci / groups) % 8 || Ci / groups > 64 ||
      bn < 1 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wq) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[2];
  const int err = bf16_maps(x, wq, B, T, Ci, Co, groups, K, bn, m);
  if (!err) memcpy(maps, m, sizeof m);
  return err;
}

// the conv alone, on maps from groupconv_bf16_describe
extern "C" int groupconv_bf16_conv(const void* maps, float* y, int B, int T, int Ci, int T_out,
                                   int Co, int groups, int K, int stride, int pad_l, int bn,
                                   int mi, int nwg, int kc, int stages, int win_rows, int win_u,
                                   void* stream) {
  const Bf16Plan p{bn, mi, nwg, kc, stages, win_rows, win_u};
  Bf16Args a;
  if (!bf16_args(B, T, Ci, T_out, Co, groups, K, stride, pad_l, p, &a) ||
      reinterpret_cast<uintptr_t>(y) % 8)
    return (int)cudaErrorInvalidValue;
  a.y = y;
  CUtensorMap m[2];
  memcpy(m, maps, sizeof m);
  return dispatch_bf16(m, a, p, (cudaStream_t)stream);
}

// K2-bf16 dx, the "default" rung's input gradient of the same conv: dx
// [B, T, Ci] fp32 (8-byte aligned, every row written) from gy [B, T_out, Co]
// fp32 (16-byte aligned) and w [Co, cig, K]; wq the [stride * Ci, kp * cogp]
// bf16 layout k2bf16_dx_weights_kernel writes (rows (group, phase, ci); cogp
// = cog rounded up to 16; 16-byte aligned); the plan from
// ops/groupconv.py:bf16_dx_plan, the forward's plan of the phases' conv
// among K2BF16_DX_TILES. Returns as the forward's entry points.

// the weights' layout alone: one launch on `stream`
extern "C" int groupconv_bf16_dx_weights(const float* w, void* wq, int Ci, int Co, int groups,
                                         int K, int stride, void* stream) {
  if (groups < 1 || Ci % groups || Co % groups || K < stride || stride < 1 ||
      reinterpret_cast<uintptr_t>(wq) % 16)
    return (int)cudaErrorInvalidValue;
  return bf16_dx_weights(w, wq, Ci, Co, groups, K, stride, (cudaStream_t)stream);
}

// the phases' conv alone, on maps from groupconv_bf16_describe(gy, wq, B,
// T_out, Co, stride * Ci, groups, kp, bn)
extern "C" int groupconv_bf16_dx_conv(const void* maps, float* dx, int B, int T, int Ci,
                                      int T_out, int Co, int groups, int K, int stride,
                                      int pad_l, int bn, int mi, int nwg, int kc, int stages,
                                      int win_rows, int win_u, void* stream) {
  const Bf16Plan p{bn, mi, nwg, kc, stages, win_rows, win_u};
  Bf16Args a;
  if (!dx_args(B, T, Ci, T_out, Co, groups, K, stride, pad_l, p, &a) ||
      reinterpret_cast<uintptr_t>(dx) % 8)
    return (int)cudaErrorInvalidValue;
  a.y = dx;
  CUtensorMap m[2];
  memcpy(m, maps, sizeof m);
  return dispatch_bf16(m, a, p, (cudaStream_t)stream, true);
}

// as the wrapper calls it: the weights laid out, the tensor maps, the conv
extern "C" int groupconv_input_grad_bf16(const float* gy, const float* w, void* wq, float* dx,
                                         int B, int T, int Ci, int T_out, int Co, int groups,
                                         int K, int stride, int pad_l, int bn, int mi, int nwg,
                                         int kc, int stages, int win_rows, int win_u,
                                         void* stream) {
  const Bf16Plan p{bn, mi, nwg, kc, stages, win_rows, win_u};
  Bf16Args a;
  if (!dx_args(B, T, Ci, T_out, Co, groups, K, stride, pad_l, p, &a) ||
      reinterpret_cast<uintptr_t>(gy) % 16 || reinterpret_cast<uintptr_t>(wq) % 16 ||
      reinterpret_cast<uintptr_t>(dx) % 8)
    return (int)cudaErrorInvalidValue;
  a.y = dx;
  const cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap maps[2];
  int err = bf16_maps(gy, wq, B, T_out, Co, stride * Ci, groups, a.K, bn, maps);
  if (err) return err;
  if ((err = bf16_dx_weights(w, wq, Ci, Co, groups, K, stride, s))) return err;
  return dispatch_bf16(maps, a, p, s, true);
}

// The "default" rung's forward, as the wrapper calls it: the weights laid
// out into wq, the tensor maps, the conv.
extern "C" int groupconv_forward_bf16(const float* x, const float* w, void* wq, float* y, int B,
                                      int T, int Ci, int T_out, int Co, int groups, int K,
                                      int stride, int pad_l, int bn, int mi, int nwg, int kc,
                                      int stages, int win_rows, int win_u, void* stream) {
  const Bf16Plan p{bn, mi, nwg, kc, stages, win_rows, win_u};
  Bf16Args a;
  if (!bf16_args(B, T, Ci, T_out, Co, groups, K, stride, pad_l, p, &a) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wq) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 8)
    return (int)cudaErrorInvalidValue;
  a.y = y;
  const cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap maps[2];
  int err = bf16_maps(x, wq, B, T, Ci, Co, groups, K, bn, maps);
  if (err) return err;
  if ((err = bf16_weights(w, wq, Co, Ci / groups, K, s))) return err;
  return dispatch_bf16(maps, a, p, s);
}
