// Warp-level tensor-core and copy helpers shared by the kernels of this
// directory: mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// mma.sync.m16n8k32 (s8 in, s32 accumulate), the register packing their
// fragments use, and cp.async.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major), 4 regs of 2 bf16: {row g, cols 2t..2t+1},
//     {row g+8, cols 2t..}, {row g, cols 2t+8..}, {row g+8, cols 2t+8..};
//   B (16x8, k by n), 2 regs: {k 2t..2t+1, col g}, {k 2t+8..2t+9, col g};
//   C (16x8 f32), 4 floats: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// So a smem tile stored [n][k] (k contiguous) yields a B register with
// one 32-bit load, as does a [row][k] tile for A.
//
// The int8 product mma.sync.m16n8k32 (s8 in, s32 accumulate) packs 4
// values per register, lowest address in the lowest byte:
//   A (16x32): {row g, cols 4t..4t+3}, {row g+8, cols 4t..}, {row g,
//     cols 16+4t..}, {row g+8, cols 16+4t..};
//   B (32x8): {k 4t..4t+3, col g}, {k 16+4t..16+4t+3, col g};
//   C (16x8 s32): as above.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sfast {

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 8-byte asynchronous copy global -> shared (through L1); src_bytes = 0
// writes zeros.  For rows whose length is a multiple of 8 bytes only.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace sfast
