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

#include <cstdint>

#include "common.cuh"

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
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
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
