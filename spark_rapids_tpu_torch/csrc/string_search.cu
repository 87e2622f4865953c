// Substring window match over a padded string matrix.
//
// Replaces the TPU kernel _pallas_match_packed (body _mk_kernel), reached
// through pallas_window_match, of spark_rapids_tpu/kernels/string_search.py:
//   out[row, s] = (pattern[0:k] == data[row, s:s+k]) && s + k <= lengths[row]
// over a uint8[n, max_len] matrix of zero-padded UTF-8 values, bytes
// compared unsigned, written as 0/1 into the storage of a bool[n, max_len]
// tensor.
//
// Bound: bytes. Each row reads max_len data bytes and a 4-byte length and
// writes max_len output bytes, against at most max_len * k byte compares,
// most of which stop at the first byte. At the Q16 part stage's shape
// (n = 2^22, max_len = 64, k = 15) that is 553.6 MB, 0.165 ms at
// 3.35 TB/s, against 4.0e9 compares, 0.060 ms at 67e12 operations/s.
//
// Design: a block stages a tile of whole rows (about 16 KB) in shared
// memory with 16-byte loads, neighbouring threads on neighbouring bytes,
// beside the tile's lengths and the pattern, so each data byte is read
// from device memory once however long the pattern is (the XLA form
// re-reads the matrix once per pattern byte). The TPU kernel packed
// 128 / max_len strings into each 128-byte row for Mosaic's 8-bit tiles; a
// GPU needs no packing, so any max_len works. Each thread then decides
// four neighbouring (row, s) outputs from shared memory and stores them as
// one 32-bit word. Any n (the last tile is ragged) and any
// 1 <= k <= max_len: the pattern is a device buffer, copied into shared
// memory. Most windows fail at their first byte, so a thread first tests
// the four first bytes at once against the pattern's first byte
// (__vcmpeq4 on one 32-bit word of the tile) and only walks the pattern
// from the starts that pass: the full test costs a division for the row
// and a loop, which on every start would make the kernel bound by
// instructions rather than bytes. Blocks walk the tiles in a grid-stride
// loop. Vector loads and word stores need 16-byte aligned data and
// output: the wrapper allocates the output and copies data that is not
// aligned, and the entry point refuses a misaligned pointer.
//
// Plain C interface, bound with ctypes: pointers and the stream come from
// the wrapper in kernels/string_search.py, which allocates the output; the
// kernel launches on that stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;

__device__ __forceinline__ uint32_t match_at(const uint8_t* tile,
                                             const int32_t* lens,
                                             const uint8_t* pat, int k,
                                             int max_len, int p) {
  const int r = p / max_len;
  const int s = p - r * max_len;
  if (s + k > lens[r]) return 0u;
  const uint8_t* w = tile + p;  // s + k <= max_len: stays inside row r
  for (int j = 0; j < k; ++j) {
    if (w[j] != pat[j]) return 0u;
  }
  return 1u;
}

__global__ void __launch_bounds__(kThreads)
window_match_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ lengths,
                    const uint8_t* __restrict__ pattern, int k,
                    int max_len, int64_t n, int tile_rows,
                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile_cap = tile_rows * max_len;  // a multiple of 16
  uint8_t* tile = smem;
  int32_t* lens = reinterpret_cast<int32_t*>(smem + tile_cap);
  uint8_t* pat = reinterpret_cast<uint8_t*>(lens + tile_rows);
  for (int j = threadIdx.x; j < k; j += blockDim.x) pat[j] = pattern[j];

  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * tile_rows;
    const int rows = static_cast<int>(
        n - row0 < tile_rows ? n - row0 : tile_rows);
    const int bytes = rows * max_len;
    const uint8_t* src = data + row0 * max_len;
    uint8_t* dst = out + row0 * max_len;

    const int nvec = bytes / 16;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(tile)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    }
    // the ragged last tile's bytes past its last 16-byte vector
    for (int i = 16 * nvec + threadIdx.x; i < bytes; i += blockDim.x) {
      tile[i] = src[i];
    }
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      lens[i] = lengths[row0 + i];
    }
    __syncthreads();

    const int quads = bytes / 4;
    const uint32_t first4 = 0x01010101u * pat[0];
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      const int p = 4 * q;
      // 0xFF in each byte of the word that equals the pattern's first byte
      const uint32_t lead =
          __vcmpeq4(reinterpret_cast<const uint32_t*>(tile)[q], first4);
      uint32_t word = 0u;
      for (int b = 0; b < 4; ++b) {
        if ((lead >> (8 * b)) & 1u) {
          word |= match_at(tile, lens, pat, k, max_len, p + b) << (8 * b);
        }
      }
      reinterpret_cast<uint32_t*>(dst)[q] = word;
    }
    for (int p = 4 * quads + threadIdx.x; p < bytes; p += blockDim.x) {
      dst[p] = static_cast<uint8_t>(match_at(tile, lens, pat, k, max_len, p));
    }
    __syncthreads();  // the tile is overwritten by the next step
  }
}

int gcd(int a, int b) {
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

}  // namespace

extern "C" int window_match(const void* data, const void* lengths,
                            const void* pattern, int k, int max_len,
                            int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  if (max_len < 1 || k < 1 || k > max_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // whole rows per tile, and a tile of a multiple of 16 bytes, so every
  // tile starts 16-byte aligned
  const int align_rows = 16 / gcd(max_len, 16);
  int tile_rows = kTileBytes / max_len / align_rows * align_rows;
  if (tile_rows < align_rows) tile_rows = align_rows;
  const size_t smem = static_cast<size_t>(tile_rows) * max_len +
                      static_cast<size_t>(tile_rows) * 4 + k;
  if (reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  // enough blocks to fill 132 SMs several times over; the loop covers
  // whatever is left
  const int blocks = static_cast<int>(tiles < 132 * 8 ? tiles : 132 * 8);
  window_match_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(pattern), k, max_len, n, tile_rows,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
