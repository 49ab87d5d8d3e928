// Copies between device memory and a block's shared-memory tiles, for the
// kernels that stage a block of envs (full_tick.cu: B1, B3; env_kernel.cu:
// B4, B5). Copies in start with cp.async and complete with
// cp_async_wait_all() and a barrier; copies out are plain stores.
//
// * Feature-major fields ((K, E) arrays, a row per entry): the block's
//   columns [col0, col0 + EBT) of rows [0, rows) move as 16-byte chunks
//   when the whole tile's rows are 16-byte aligned, else element by
//   element (a partial last tile, columns off the 16-byte grid).
// * Row-major fields ((E, K) arrays, a row per env): the block's envs are
//   one contiguous span of elements, moved as 16-byte chunks from a
//   16-byte aligned start and element by element at the ragged end (or
//   throughout, from an unaligned start).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace dronerl {

__host__ __device__ constexpr int up16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The copies of a block of THREADS threads owning a tile of EBT envs.
template <int EBT, int THREADS>
struct BlockTile {
  // Whether rows of EBT elements of U at (row * ld + col0) move as 16-byte
  // chunks: a whole tile with every row start 16-byte aligned.
  template <typename U>
  __device__ __forceinline__ static bool rows_vectorizable(const void* base, long long ld,
                                                           long long col0, int ne) {
    return ne == EBT && (reinterpret_cast<uintptr_t>(base) & 15u) == 0 &&
           (ld * (long long)sizeof(U)) % 16 == 0 && (col0 * (long long)sizeof(U)) % 16 == 0;
  }

  // Start copying rows [0, rows) x envs [0, EBT) of src (row stride ld,
  // first column col0) into dst (row stride S); envs past ne read as 0.
  template <typename U, int S>
  __device__ __forceinline__ static void stage_rows(U* dst, const U* src, long long ld,
                                                    long long col0, int rows, int ne) {
    constexpr int PER = 16 / sizeof(U);
    constexpr int CPR = EBT / PER;  // 16-byte chunks a row
    if (rows_vectorizable<U>(src, ld, col0, ne)) {
      for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
        const int r = i / CPR, c = (i % CPR) * PER;
        cp_async16(dst + r * S + c, src + r * ld + col0 + c);
      }
    } else {
      for (int i = threadIdx.x; i < rows * EBT; i += THREADS) {
        const int r = i / EBT, c = i % EBT;
        dst[r * S + c] = c < ne ? src[r * ld + col0 + c] : U(0);
      }
    }
  }

  // Store rows [0, rows) x envs [0, ne) of src (row stride S) into dst.
  template <typename U, int S>
  __device__ __forceinline__ static void store_rows(U* dst, const U* src, long long ld,
                                                    long long col0, int rows, int ne) {
    constexpr int PER = 16 / sizeof(U);
    constexpr int CPR = EBT / PER;
    if (rows_vectorizable<U>(dst, ld, col0, ne)) {
      for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
        const int r = i / CPR, c = (i % CPR) * PER;
        *reinterpret_cast<uint4*>(dst + r * ld + col0 + c) =
            *reinterpret_cast<const uint4*>(src + r * S + c);
      }
    } else {
      for (int i = threadIdx.x; i < rows * ne; i += THREADS) {
        const int r = i / ne, c = i % ne;
        dst[r * ld + col0 + c] = src[r * S + c];
      }
    }
  }

  // Start copying the n elements of src into dst (16-byte aligned).
  template <typename U>
  __device__ __forceinline__ static void stage_flat(U* dst, const U* src, int n) {
    constexpr int PER = 16 / sizeof(U);
    const int body = (reinterpret_cast<uintptr_t>(src) & 15u) == 0 ? n / PER * PER : 0;
    for (int i = threadIdx.x * PER; i < body; i += THREADS * PER) cp_async16(dst + i, src + i);
    for (int i = body + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }

  // Store the n elements of src (16-byte aligned) into dst.
  template <typename U>
  __device__ __forceinline__ static void store_flat(U* dst, const U* src, int n) {
    constexpr int PER = 16 / sizeof(U);
    const int body = (reinterpret_cast<uintptr_t>(dst) & 15u) == 0 ? n / PER * PER : 0;
    for (int i = threadIdx.x * PER; i < body; i += THREADS * PER) {
      *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(src + i);
    }
    for (int i = body + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
};

}  // namespace dronerl
