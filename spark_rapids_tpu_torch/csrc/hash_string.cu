// K1: Spark murmur3 hashUnsafeBytes over a fixed-width string byte matrix.
//
// Replaces the Pallas TPU kernel spark_rapids_tpu/ops/pallas_kernels.py
// (pallas_hash_string, the pl.pallas_call at :138, body
// _hash_string_kernel at :53).  Bit for bit the same function:
//   for each row r of chars[N, W] (uint8, row-major, zero padded past
//   lengths[r]):
//     h1 = seeds[r]
//     every aligned 4-byte little-endian word below len & ~3 goes
//       through mixK1 / mixH1;
//     every tail byte below len goes through mixK1 / mixH1 on its own,
//       SIGN-EXTENDED ((uint32_t)(int32_t)(int8_t)b: Spark reads the
//       tail with Platform.getByte, a signed read);
//     out[r] = fmix(h1, len).
//   Bytes at or past W read as zero, so any length agrees with the JAX
//   version, which walks the same zero-padded matrix.
//
// What bounds it on an H100: memory.  Per row the kernel reads W bytes
// of chars, 4 of length and 4 of seed and writes 4 bytes of hash:
// N*W + 8N bytes in, 4N out, against ~14 integer operations per word,
// so at 3.35 TB/s the bytes take longer than the arithmetic for any W.
//
// Design: one thread per row in a grid-stride loop; no shared memory,
// no width cap and no row padding (the TPU kernel's 128-byte width cap
// and 1024-row blocks were VMEM and tiling artifacts).  Bytes are
// loaded one at a time because a row starts 4-byte aligned only when
// W % 4 == 0.  For the narrow keys of q1 (W = 1) neighbouring threads
// read neighbouring bytes, so every load is coalesced; for wide rows a
// warp's loads stride by W and each 32-byte sector is reused from L1
// across the loop.  Staging row tiles through shared memory for fully
// coalesced wide loads is later work.
//
// Launch contract: runs on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  h1 ^= h1 >> 16;
  return h1;
}

__global__ void hash_string_kernel(const uint8_t* __restrict__ chars,
                                   const int32_t* __restrict__ lengths,
                                   const uint32_t* __restrict__ seeds,
                                   uint32_t* __restrict__ out, int64_t n,
                                   int width) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const uint8_t* p = chars + row * (int64_t)width;
    const int32_t len = lengths[row];
    // floor modulo, as the reference's `len % 4` on int32
    const int32_t aligned = len - (((len % 4) + 4) % 4);
    uint32_t h1 = seeds[row];
    int32_t j = 0;
    for (; j + 4 <= aligned && j + 4 <= width; j += 4) {
      const uint32_t word = (uint32_t)p[j] | ((uint32_t)p[j + 1] << 8) |
                            ((uint32_t)p[j + 2] << 16) |
                            ((uint32_t)p[j + 3] << 24);
      h1 = mix_h1(h1, mix_k1(word));
    }
    if (j + 4 <= aligned && j < width) {
      // the last block straddles W: bytes past the matrix read as zero
      uint32_t word = 0;
      for (int32_t b = 0; j + b < width; ++b) {
        word |= (uint32_t)p[j + b] << (8 * b);
      }
      h1 = mix_h1(h1, mix_k1(word));
    }
    const int32_t tail_end = len < width ? len : width;
    for (int32_t t = aligned > 0 ? aligned : 0; t < tail_end; ++t) {
      h1 = mix_h1(h1, mix_k1((uint32_t)(int32_t)(int8_t)p[t]));
    }
    out[row] = fmix(h1, (uint32_t)len);
  }
}

}  // namespace

extern "C" int srt_hash_string(const void* chars, const void* lengths,
                               const void* seeds, void* out, int64_t n,
                               int width, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride covers the rest
  hash_string_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (const int32_t*)lengths,
      (const uint32_t*)seeds, (uint32_t*)out, n, width);
  return (int)cudaGetLastError();
}
