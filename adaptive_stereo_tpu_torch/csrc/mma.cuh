// Tensor-core building blocks shared by the bf16 convolutions of
// csrc/conv3d.cuh (kernels 2 and 4) and csrc/tower.cu (kernel 5):
// cp.async staging into shared memory, ldmatrix fragment loads, and
// mma.sync.m16n8k16 with bf16 inputs and f32 accumulators.
//
// Activations and weights are staged as 64-byte rows of 32 bf16 channels,
// four 16-byte chunks a row, and chunk c of row R lives at chunk
// c ^ ((R >> 1) & 3) (swz): any 8 consecutive rows then hit 8 different
// bank groups, so an ldmatrix over 8 consecutive rows is free of bank
// conflicts without padding. The swizzle key is the staged row's index.
#pragma once

#include "common.cuh"

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared through L2 only; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of 16-byte chunk c (0-3) of 64-byte row R, swizzled.
__device__ __forceinline__ int swz(int R, int c) { return R * 32 + ((c ^ ((R >> 1) & 3)) << 3); }
