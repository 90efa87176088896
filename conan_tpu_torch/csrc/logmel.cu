// Log-mel spectrogram for Hopper (sm_90a), fp32: kernel K1, one launch.
//
// Replaces the TPU kernel conan_tpu/ops/pallas_stft.py:_kernel / pallas_logmel:
//   out[b, f, m] = log(max(sum_k mag[b, f, k] * melw[k, m], clip)) * out_scale
//   mag[b, f, k] = |sum_n win[n] frame(b, f)[n] exp(-2πi k n / n_fft)|, under
//                  the sqrt as sqrt(re^2 + im^2 + eps)
// with frame(b, f)[n] = wav[b, f*hop + n - pad], zero outside [0, T) (the
// constant centre pad). The Pallas kernel computes the DFT as a dense product
// with a [n_fft, 2*bins] basis (the MXU's shape of work) and the mel sum as a
// dense product with the [bins, mels] filterbank; both were carried over in
// the port's first version, two launches with the magnitudes round-tripping
// through device memory.
//
// What bounds it on the card: its bytes. The function needs an FFT (~5 n
// log2 n FLOP a frame for the complex FFT done here) and the mel sum over the
// filterbank's nonzero weights against ~4 hop bytes of new wav and 4 n_mels
// bytes of output a frame (chip_smoke.py:logmel_bound_ms). What the design
// does about it: one block per frame does everything in shared memory, and
// only the wav (read once per overlapping frame, from L2 after the first) and
// the log-mel touch device memory:
//   1. framing and window: sample n of frame f read straight from the wav at
//      f*hop - pad + n (zero outside [0, T)), times the n_fft-long window
//      (the periodic Hann of win_length zero-padded to the centre, the same
//      numpy window as the plain version's DFT basis: ops/stft.py:_window_np);
//   2. a complex FFT of the n_fft windowed samples (imaginary parts zero) in
//      radix-2 Stockham passes between two shared buffers of n_fft float2.
//      Pass m (m = 1, 2, .., n/2) takes butterfly t < n/2 from x[t] and
//      x[t + n/2] and writes y[2t - k] = c0 + c1, y[2t - k + m] = (c0 - c1) *
//      w^(t - k) with k = t mod m and w^j = exp(-2πi j / n) from a table of
//      n/2 twiddles computed in float64 and rounded to fp32. Reads are
//      contiguous, the output comes in natural order, and no bit reversal is
//      needed. fp32 rounding grows as log2 n here against sqrt(n) for the
//      dense DFT. Packing even and odd samples into an n/2-point FFT would
//      halve the passes' work; not done yet.
//   3. sqrt(re^2 + im^2 + eps) of bins 0..n/2 into shared memory;
//   4. each mel summed over its own contiguous band of bins only (first bin,
//      count and offset into a compact weight array, built by the wrapper
//      from the same filterbank; a band of count 0 sums to 0 and gives
//      log(clip), as the dense product does), then log(max(., clip)) *
//      out_scale, written coalesced as [B, F, n_mels].
// Shared memory is 16 * n_fft bytes (32 KB at n_fft 2048), so one frame a
// block keeps several blocks on an SM, and serving at B=1 (257 frames of
// 5.12 s) fills the card's 132 SMs with one wave. No tensor cores: the FFT is
// a few kFLOP a frame.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
logmel_fft_kernel(const float* __restrict__ wav, const float* __restrict__ window,
                  const float2* __restrict__ twiddle, const int* __restrict__ band_first,
                  const int* __restrict__ band_count, const int* __restrict__ band_offset,
                  const float* __restrict__ band_w, float* __restrict__ out, int T,
                  int n_frames, int n_fft, int hop, int pad, int n_mels, float eps, float clip,
                  float out_scale) {
  extern __shared__ __align__(16) float2 buf[];   // two buffers of n_fft complex values
  const int frame = blockIdx.x;                   // b * n_frames + f
  const int b = frame / n_frames, f = frame - b * n_frames;
  const int half = n_fft >> 1;
  float2* x = buf;
  float2* y = buf + n_fft;

  const float* w = wav + (size_t)b * T;
  const long long t0 = (long long)f * hop - pad;
  for (int n = threadIdx.x; n < n_fft; n += THREADS) {
    const long long t = t0 + n;
    const float v = (t >= 0 && t < T) ? __ldg(w + t) : 0.f;
    x[n] = make_float2(v * __ldg(window + n), 0.f);
  }
  __syncthreads();

  for (int m = 1; m < n_fft; m <<= 1) {
    for (int t = threadIdx.x; t < half; t += THREADS) {
      const int k = t & (m - 1);
      const float2 c0 = x[t], c1 = x[t + half];
      const float2 tw = __ldg(twiddle + (t - k));
      const float dr = c0.x - c1.x, di = c0.y - c1.y;
      y[2 * t - k] = make_float2(c0.x + c1.x, c0.y + c1.y);
      y[2 * t - k + m] = make_float2(dr * tw.x - di * tw.y, dr * tw.y + di * tw.x);
    }
    __syncthreads();
    float2* tmp = x;
    x = y;
    y = tmp;
  }

  float* mag = reinterpret_cast<float*>(y);       // the free buffer, bins 0..n/2
  for (int k = threadIdx.x; k <= half; k += THREADS) {
    const float2 v = x[k];
    mag[k] = sqrtf(v.x * v.x + v.y * v.y + eps);
  }
  __syncthreads();

  float* o = out + (size_t)frame * n_mels;
  for (int m = threadIdx.x; m < n_mels; m += THREADS) {
    const float* mg = mag + __ldg(band_first + m);
    const float* wm = band_w + __ldg(band_offset + m);
    const int count = __ldg(band_count + m);
    float acc = 0.f;
    for (int i = 0; i < count; ++i) acc = fmaf(mg[i], __ldg(wm + i), acc);
    o[m] = logf(fmaxf(acc, clip)) * out_scale;
  }
}

}  // namespace

// wav [B, T]; window [n_fft]; twiddle [n_fft/2] complex (re, im interleaved);
// band_first, band_count, band_offset [n_mels] int32; band_w the bands'
// weights one after another; out [B, n_frames, n_mels]. All fp32 but the
// band tables, contiguous, on the current device; n_fft a power of two from
// 2 to 8192. Launches one kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for what it does not take).
extern "C" int logmel_forward(const float* wav, const float* window, const float* twiddle,
                              const int* band_first, const int* band_count,
                              const int* band_offset, const float* band_w, float* out, int B,
                              int T, int n_frames, int n_fft, int hop, int pad, int n_mels,
                              float eps, float clip, float out_scale, void* stream) {
  if (n_fft < 2 || n_fft > 8192 || (n_fft & (n_fft - 1)) || B < 1 || n_frames < 1 ||
      (long long)B * n_frames > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float2) * (size_t)n_fft;
  static size_t opted[conan::kMaxDevices] = {};
  const cudaError_t e = conan::allow_dynamic_smem(logmel_fft_kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  logmel_fft_kernel<<<B * n_frames, THREADS, smem, (cudaStream_t)stream>>>(
      wav, window, reinterpret_cast<const float2*>(twiddle), band_first, band_count,
      band_offset, band_w, out, T, n_frames, n_fft, hop, pad, n_mels, eps, clip, out_scale);
  return (int)cudaGetLastError();
}
