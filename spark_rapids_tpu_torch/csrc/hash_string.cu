// K1 on Hopper: Spark murmur3 of a batch's key tuple, one launch.
//
// Replaces the Pallas TPU kernel spark_rapids_tpu/ops/pallas_kernels.py
// (pallas_hash_string, the pl.pallas_call at :138, body
// _hash_string_kernel at :53), and the per-column chain around it in
// spark_rapids_tpu/exprs/hashing.py (hash_columns :235, partition_ids
// :272).  One kernel body, two entry points:
//
//   srt_hash_string   one string column with per-row seeds -> int32
//                     hashes (the TPU kernel's contract);
//   srt_hash_columns  up to 16 columns chained from per-row seeds (or
//                     42) -> int32 hashes, or int64 pmod(hash, P) when
//                     num_partitions P > 0.  Longer tuples chain through
//                     the seeds, one launch per 16 columns.
//
// Bit for bit Spark's function, per row:
//   BOOLEAN, INT, DATE  one 4-byte block: fmix(mixH1(h, mixK1(v)), 4);
//   LONG                two blocks, low word first, fmix(.., 8);
//   DOUBLE              -0.0 -> 0.0 and every NaN -> 0x7FF8000000000000,
//                       then as LONG;
//   STRING              hashUnsafeBytes: every aligned little-endian
//                       word below len & ~3, then every tail byte on its
//                       own, SIGN-EXTENDED (Spark reads it with the
//                       signed Platform.getByte), then fmix(h, len).
//                       Bytes at or past the matrix width W read as
//                       zero, as in the JAX version's padded matrix.
//   NULL                the row keeps its running seed.
//
// What bounds it on an H100: memory.  Per row it reads each column once
// (W chars + 4 length bytes for a string, 1, 4 or 8 bytes otherwise, 1
// validity byte) and writes 4 or 8 bytes, against ~15 integer operations
// per 4-byte word.  At 3.35 TB/s the bytes take longer than the
// arithmetic at the 32-bit rate for every type and width.  The copy of a
// string tile reads the whole N x W matrix, whatever the lengths, so the
// bound counts the whole matrix too.
//
// Design.
// - One thread per row, one tile of T consecutive rows per block of T
//   threads.  Murmur3 is a serial chain over a row's words, so a row
//   stays with one thread; only the loads change.
// - Wide string columns go through shared memory.  A tile of a string
//   column is one contiguous span of T*W bytes.  Thread k copies word k
//   of the span (k, k + T, ...) with a 4-byte cp.async, so a warp reads
//   128 contiguous bytes; byte loads by one thread per row put a warp's
//   32 loads W bytes apart, 32 sectors per load at W >= 32, and reached
//   a third of the bound at W = 64.  The block then hashes its rows out
//   of shared memory.
// - Everything else is read straight from global memory: seeds,
//   lengths, validity and fixed-width values (thread t reads row t, so
//   a warp's loads are contiguous: 4 or 8 bytes and 1 validity byte a
//   row, which shared memory would only copy), and strings of W <= 56
//   (ops/kernels.py::NARROW_WIDTH).  Up to there L1 serves a warp's
//   strided byte loads: direct loads beat staging at every width the
//   H100 sweep measured up to 56 and lost at 64 (0.33 of the bound
//   against 0.59), 128 and 256.
// - The copy overlaps the mixing across blocks, not within one: several
//   blocks are resident on an SM, so one block's copy is in flight while
//   another hashes.  A grid-stride loop that double-buffered the next
//   tile in the same block measured slower on an H100 (its
//   synchronisation and one-block-per-slot grid cost more than they hid;
//   PERF.md).
// - Alignment.  data_ptr() need not be 4-byte aligned (a row slice of a
//   matrix starts at r0*W), and a row starts at a different offset mod 4
//   whenever W % 4 != 0.  Row r of the tile goes to word r*pitch of the
//   column's region, shifted by its global address mod 4 (ph), so every
//   aligned global word lands on an aligned shared word; a word that
//   straddles rows is copied into both.  A reader funnel-shifts two
//   shared words into the row's word.  The ragged head and tail of the
//   span (up to 3 bytes each, outside its aligned words) are copied as
//   single bytes, so no byte outside the tensor is read; only an
//   unaligned data_ptr() or the last tile has any.
// - Bank conflicts.  Thread t reads word j of row t at t*pitch + j.  The
//   pitch (set by the caller) is an odd number of words, so a warp's 32
//   reads fall in 32 different banks for every W; a pitch of W/4 words
//   would put W = 64 in 2 banks (16-way) and any W % 128 == 0 in one.
// - Shared memory budget.  A tile must fit in the 227 KB a block may use;
//   above 48 KB the launcher raises the kernel's dynamic shared memory
//   limit and returns the error if that fails.  The caller
//   (ops/kernels.py::tile_geometry) picks T, the pitches and the regions
//   from the widths; a string so wide that one warp's rows would not fit
//   (W in the thousands) gets pitch 0 and is read straight from global
//   memory, a branch chosen from the shape alone.
//
// Launch contract: runs on the caller's stream, allocates nothing,
// returns 0 or the CUDA error of the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxThreads = 256;
constexpr uint32_t kDefaultSeed = 42;
constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr size_t kSmemPerBlock = 232448;

// column type tags, as ops/kernels.py writes them
enum : int32_t { kBool = 0, kInt32 = 1, kInt64 = 2, kFloat64 = 3, kString = 4 };

// One column of the key tuple; the layout is ops/kernels.py::_ColDesc.
struct ColDesc {
  int32_t type;
  int32_t width;        // string: bytes per row of the (N, W) matrix
  int32_t pitch_words;  // string: staged row pitch in words, odd; 0 = direct
  int32_t smem_off;     // staged string: first word of its region
  const void* data;          // values, or the string chars
  const uint8_t* validity;   // one bool per row, or null (all valid)
  const int32_t* lengths;    // string lengths, else null
};
static_assert(sizeof(ColDesc) == 40, "ColDesc is shared with ops/kernels.py");

// Passed by value: the descriptors travel in the launch itself.
struct Params {
  ColDesc cols[kMaxCols];
  const int32_t* seeds;  // per-row seeds (uint32 bits), or null (42)
  void* out;             // int32 hashes, or int64 ids if num_partitions > 0
  int64_t n;
  int32_t n_cols;
  int32_t num_partitions;
};

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

__device__ __forceinline__ uint32_t hash_int(uint32_t v, uint32_t h1) {
  return fmix(mix_h1(h1, mix_k1(v)), 4);
}

__device__ __forceinline__ uint32_t hash_long(uint64_t v, uint32_t h1) {
  h1 = mix_h1(h1, mix_k1((uint32_t)v));
  h1 = mix_h1(h1, mix_k1((uint32_t)(v >> 32)));
  return fmix(h1, 8);
}

// A string row in global memory.
struct GlobalRow {
  const uint8_t* p;
  __device__ uint32_t word(int j) const {
    return (uint32_t)p[j] | ((uint32_t)p[j + 1] << 8) |
           ((uint32_t)p[j + 2] << 16) | ((uint32_t)p[j + 3] << 24);
  }
  __device__ uint8_t byte(int j) const { return p[j]; }
};

// A string row staged in shared memory: row byte j is byte ph + j of
// the row's words.
struct SharedRow {
  const uint32_t* w;
  int ph;
  __device__ uint32_t word(int j) const {
    const uint32_t lo = w[j >> 2];
    const uint32_t hi = ph ? w[(j >> 2) + 1] : lo;
    return __funnelshift_r(lo, hi, 8 * ph);
  }
  __device__ uint8_t byte(int j) const {
    return reinterpret_cast<const uint8_t*>(w)[ph + j];
  }
};

// Spark hashUnsafeBytes of one row of a width-W byte matrix.
template <class Row>
__device__ uint32_t hash_bytes(const Row& row, int32_t width, int32_t len,
                               uint32_t h1) {
  // floor modulo, as the reference's `len % 4` on int32
  const int32_t aligned = len - (((len % 4) + 4) % 4);
  int32_t j = 0;
  for (; j + 4 <= aligned && j + 4 <= width; j += 4) {
    h1 = mix_h1(h1, mix_k1(row.word(j)));
  }
  if (j + 4 <= aligned && j < width) {
    // the last block straddles W: bytes past the matrix read as zero
    uint32_t word = 0;
    for (int32_t b = 0; j + b < width; ++b) {
      word |= (uint32_t)row.byte(j + b) << (8 * b);
    }
    h1 = mix_h1(h1, mix_k1(word));
  }
  const int32_t tail_end = len < width ? len : width;
  for (int32_t t = aligned > 0 ? aligned : 0; t < tail_end; ++t) {
    h1 = mix_h1(h1, mix_k1((uint32_t)(int32_t)(int8_t)row.byte(t)));
  }
  return fmix(h1, (uint32_t)len);
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Copy the chars of rows [r0, r0 + rows) of string column d into region
// (see the header: row r at word r*pitch, shifted by its address mod 4).
// The aligned words go by cp.async, still in flight on return.
__device__ void stage_chars(const ColDesc& d, int64_t r0, int rows,
                            uint32_t* region) {
  const int W = d.width;
  const int pitch_b = 4 * d.pitch_words;
  const uintptr_t gs = (uintptr_t)((const uint8_t*)d.data + r0 * W);
  const uintptr_t ge = gs + (uintptr_t)rows * W;
  const uintptr_t a0 = (gs + 3) & ~(uintptr_t)3;
  const uintptr_t a1 = ge & ~(uintptr_t)3;
  // rel / W == (rel * magic) >> 32 while rel * W < 2^32 (the launcher
  // checks T * W * W < 2^32)
  const uint64_t magic = 0xFFFFFFFFull / (uint32_t)W + 1;
  const int wmod = W & 3;
  const int gmod = (int)(gs & 3);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(region);
  // the aligned interior: thread k copies words k, k + T, ...; (r, col)
  // of its word steps by (step / W, step % W) with no division
  const int step = 4 * blockDim.x;
  const int dr = step / W;
  const int dc = step - dr * W;
  uintptr_t a = a0 + 4 * (uintptr_t)threadIdx.x;
  uint32_t rel = (uint32_t)(a - gs);
  int r = (int)((rel * magic) >> 32);
  int col = (int)rel - r * W;
  for (; a < a1; a += step) {
    int rr = r, cc = col;
    for (;;) {
      const int ph = (gmod + rr * wmod) & 3;
      cp_async4(bytes + rr * pitch_b + ph + cc, (const void*)a);
      if (cc + 4 <= W || rr + 1 >= rows) break;
      ++rr;  // the word runs on into the next row
      cc -= W;
    }
    r += dr;
    col += dc;
    if (col >= W) {
      col -= W;
      ++r;
    }
  }
  // the ragged head [gs, a0) and tail [a1, ge), byte by byte
  const uintptr_t head_end = a0 < ge ? a0 : ge;
  const uintptr_t tail_start = a1 > head_end ? a1 : head_end;
  const int head = (int)(head_end - gs);
  const int n_ragged = head + (int)(ge - tail_start);
  if ((int)threadIdx.x < n_ragged) {
    const int k = threadIdx.x;
    const uintptr_t x = k < head ? gs + k : tail_start + (k - head);
    rel = (uint32_t)(x - gs);
    const int rb = (int)((rel * magic) >> 32);
    const int cb = (int)rel - rb * W;
    const int ph = (gmod + rb * wmod) & 3;
    bytes[rb * pitch_b + ph + cb] = *(const uint8_t*)x;
  }
}

__device__ __forceinline__ bool is_staged(const ColDesc& d) {
  return d.type == kString && d.pitch_words > 0;
}

__global__ void __launch_bounds__(kMaxThreads)
    hash_columns_kernel(const __grid_constant__ Params p, bool staged) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int64_t r0 = (int64_t)blockIdx.x * T;
  const int64_t row = r0 + threadIdx.x;
  if (staged) {
    const int rows = p.n - r0 < T ? (int)(p.n - r0) : T;
    for (int c = 0; c < p.n_cols; ++c) {
      const ColDesc& d = p.cols[c];
      if (is_staged(d)) stage_chars(d, r0, rows, smem + d.smem_off);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the tile's wide strings are in shared memory
  }
  if (row >= p.n) return;
  uint32_t h = p.seeds != nullptr ? (uint32_t)p.seeds[row] : kDefaultSeed;
  for (int c = 0; c < p.n_cols; ++c) {
    const ColDesc& d = p.cols[c];
    if (d.validity != nullptr && !d.validity[row]) continue;  // NULL
    switch (d.type) {
      case kBool:
        h = hash_int(((const uint8_t*)d.data)[row], h);
        break;
      case kInt32:
        h = hash_int((uint32_t)((const int32_t*)d.data)[row], h);
        break;
      case kInt64:
        h = hash_long((uint64_t)((const int64_t*)d.data)[row], h);
        break;
      case kFloat64: {
        const double x = ((const double*)d.data)[row];
        const uint64_t bits = x == 0.0 ? 0ull
                              : x != x ? 0x7FF8000000000000ull
                                       : (uint64_t)__double_as_longlong(x);
        h = hash_long(bits, h);
        break;
      }
      default: {
        const uint8_t* g = (const uint8_t*)d.data + row * d.width;
        if (d.pitch_words > 0) {
          const SharedRow s{smem + d.smem_off + threadIdx.x * d.pitch_words,
                            (int)((uintptr_t)g & 3)};
          h = hash_bytes(s, d.width, d.lengths[row], h);
        } else {
          h = hash_bytes(GlobalRow{g}, d.width, d.lengths[row], h);
        }
      }
    }
  }
  if (p.num_partitions > 0) {
    int64_t m = (int64_t)(int32_t)h % p.num_partitions;
    if (m < 0) m += p.num_partitions;
    ((int64_t*)p.out)[row] = m;
  } else {
    ((int32_t*)p.out)[row] = (int32_t)h;
  }
}

int launch(const Params& p, int threads, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (p.n <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      p.n_cols < 0 || p.n_cols > kMaxCols) {
    return bad;
  }
  size_t smem_words = 0;
  for (int c = 0; c < p.n_cols; ++c) {
    const ColDesc& d = p.cols[c];
    if (d.type < kBool || d.type > kString ||
        (d.data == nullptr && !(d.type == kString && d.width == 0))) {
      return bad;
    }
    if (d.type != kString) continue;
    if (d.lengths == nullptr || d.width < 0 || d.pitch_words < 0) return bad;
    if (d.pitch_words == 0) continue;
    // room for W bytes after a shift of up to 3, odd, exact division of
    // tile offsets by W (stage_chars), and a region inside the tile
    const size_t end = (size_t)d.smem_off + (size_t)threads * d.pitch_words;
    if (d.width < 1 || d.pitch_words % 2 == 0 ||
        4 * (int64_t)d.pitch_words < (int64_t)d.width + 3 ||
        (int64_t)threads * d.width * d.width >= (int64_t(1) << 32) ||
        d.smem_off < 0 || end * sizeof(uint32_t) > kSmemPerBlock) {
      return bad;
    }
    if (end > smem_words) smem_words = end;
  }
  const size_t smem = smem_words * sizeof(uint32_t);
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        hash_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (p.n + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return bad;
  hash_columns_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      p, smem > 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_hash_string(const void* chars, const void* lengths,
                               const void* seeds, void* out, int64_t n,
                               int width, int threads, int pitch_words,
                               void* stream) {
  if (seeds == nullptr) return (int)cudaErrorInvalidValue;
  Params p{};
  p.cols[0] = ColDesc{kString, width, pitch_words, 0, chars, nullptr,
                      (const int32_t*)lengths};
  p.n_cols = 1;
  p.seeds = (const int32_t*)seeds;
  p.out = out;
  p.n = n;
  p.num_partitions = 0;
  return launch(p, threads, (cudaStream_t)stream);
}

extern "C" int srt_hash_columns(const void* desc, int n_cols,
                                const void* seeds_or_null, int64_t n,
                                int num_partitions, int threads, void* out,
                                void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || num_partitions < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  for (int c = 0; c < n_cols; ++c) {
    p.cols[c] = ((const ColDesc*)desc)[c];
  }
  p.n_cols = n_cols;
  p.seeds = (const int32_t*)seeds_or_null;
  p.out = out;
  p.n = n;
  p.num_partitions = num_partitions;
  return launch(p, threads, (cudaStream_t)stream);
}
