// Hopper building blocks shared by the K2-bf16 kernels (groupconv.cu: the
// forward and the input gradient; groupconv_bwd.cu: the weight gradient)
// and K3's (denseconv.cu, denseconv_bwd.cu): mbarriers, TMA tile loads,
// wgmma descriptors and products, and the tensor map encoder, found in the
// driver at run time.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int kRowBox = 16;   // window rows a TMA box

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed; built
// with -DK2BF16_WATCHDOG (tools/torch_kernel_lab.py), a wait of ~2^26 tries
// traps, so a pipeline that deadlocks fails its launch instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
#ifdef K2BF16_WATCHDOG
  uint32_t tries = 0;
#endif
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
#ifdef K2BF16_WATCHDOG
    if (++tries == (1u << 26)) __trap();
#endif
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory descriptor of the weights' B tile: K-major, 128-byte
// swizzle, rows of 64 bf16 (128 bytes), 8-row swizzle atoms 1024 bytes
// apart; a k-step of 16 within a row advances the start address by 32 bytes
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// shared-memory descriptor of an MN-major tile with the 128-byte swizzle
// (K3 dw's operands): rows of 64 MN values (128 bytes) a k, 8-row swizzle
// atoms 1024 bytes apart (the stride byte offset), the next 64 MN values
// `lbo` bytes on. The swizzle follows the shared-memory address, as TMA
// wrote it, so a start inside an atom (a tap's shifted rows) needs no base
// offset (checked on the card: the atom's phase there as the base offset
// gives wrong sums).
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// shared-memory descriptor of a K-major tile without swizzle (the forward's
// window, the weight gradient's A and B): a core matrix is 8 rows x 16 bytes
// (8 k values) stored contiguously, the next 8 k values `lbo` bytes on, the
// next 8 rows 128 bytes on
__device__ __forceinline__ uint64_t a_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// d = a * b + (scale_d ? d : 0): wgmma m64nNk16, A and B (bf16) through
// descriptors, fp32 accumulators in the m64nN layout; A K-major, B K-major
// or, with TRANS_B, MN-major (the transpose bf16 allows). A tile's first product
// passes scale_d 0, so no other instruction writes the accumulators inside
// the pipeline (ptxas serializes the wgmmas otherwise).
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int TRANS_B = 0>
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, %7;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<16> {
  template <int TRANS_B = 0>
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<32> {
  template <int TRANS_B = 0>
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<64> {
  // TRANS_A: A MN-major too (K3 dw's gy)
  template <int TRANS_B = 0, int TRANS_A = 0>
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
  }
};

// m64n128k16 (K3's tile of 128 output channels; K3 dw's 128 out-channels,
// with TRANS_A its x window MN-major)
template <>
struct Wgmma<128> {
  template <int TRANS_B = 0, int TRANS_A = 0>
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
  }
};

// keeps the compiler from moving accesses of an accumulator across a wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cuTensorMapEncodeTiled, found once in libcuda.so.1 by dlopen (no link against it)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a 3-D map over a bf16 [B, T, C] channels-last tensor (K3's x and gy):
// boxes of one batch row, `rows` rows x 64 channels (128-byte rows), 128-byte
// swizzle, zero fill outside
inline CUresult sw128_rows_map(CUtensorMap* map, const void* t, int B, int T, int C, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return CUDA_ERROR_NOT_INITIALIZED;
  const cuuint64_t dim[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t stride[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1}, ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(t), dim, stride, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// a 3-D map over an fp32 [B, T, C] channels-last tensor: boxes of `rows`
// rows (kRowBox unless given) x `box_c` channels of one batch row, zero
// fill outside
inline CUresult fp32_rows_map(CUtensorMap* map, const float* t, int B, int T, int C, int box_c,
                              int rows = kRowBox) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return CUDA_ERROR_NOT_INITIALIZED;
  const cuuint64_t dim[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t stride[2] = {(cuuint64_t)C * 4, (cuuint64_t)T * C * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_c, (cuuint32_t)rows, 1}, ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(t), dim, stride, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
