// chacha20: the RFC 7539 ChaCha20 block function. Row i of the output is the
// 64-byte keystream block for counter counter0 + i (mod 2^32): 10 double
// rounds of add / xor / rotate over a 16-word state, then the input state
// added back.
//
// Replaces the TPU kernel src/repro/kernels/chacha20.py::_keystream (body
// _chacha20_kernel). On the TPU one program holds a [256, 16] u32 tile in
// VMEM and runs each quarter round column-wise across the VPU's lanes, so a
// u32 op is a full-width vector op. Here one thread owns one block: its 16
// state words live in registers, a rotate is one funnel shift (SHF), and
// the 32 threads of a warp compute 32 blocks side by side, the GPU's
// counterpart of the 4 or 8 blocks per AVX register of the x86 code. There
// is no tile multiple: the grid is ceil(n_blocks / 256) blocks of 256
// threads and the last block masks its tail.
//
// What bounds it: integer operations. A block takes 10 x 8 quarter rounds x
// (4 adds, 4 xors, 4 rotates) + 16 final adds = 976 32-bit instructions
// and writes 64 bytes, 15 instructions a byte. The H100 issues at most one
// instruction per CUDA-core lane per clock (132 SMs x 128 lanes x 1.98 GHz
// = 33.5e12/s) and writes 3.35e12 B/s, 10 instructions a byte: so it is
// bound by operations, 30 us for 64 MiB of keystream. Each thread writes
// its 64 bytes as four 16-byte stores. The key and nonce (44 bytes) are
// read by every thread through the read-only cache.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c,
                                        uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

__global__ void __launch_bounds__(THREADS)
chacha20_kernel(const uint32_t* __restrict__ key,
                const uint32_t* __restrict__ nonce, uint32_t counter0,
                long long n_blocks, uint4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_blocks) return;
  uint32_t s[16];
  s[0] = 0x61707865u; s[1] = 0x3320646eu; s[2] = 0x79622d32u; s[3] = 0x6b206574u;
#pragma unroll
  for (int w = 0; w < 8; ++w) s[4 + w] = __ldg(key + w);
  s[12] = counter0 + (uint32_t)i;            // wraps mod 2^32
#pragma unroll
  for (int w = 0; w < 3; ++w) s[13 + w] = __ldg(nonce + w);

  uint32_t x[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) x[w] = s[w];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
  uint4* o = out + i * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o[q] = make_uint4(x[4 * q] + s[4 * q], x[4 * q + 1] + s[4 * q + 1],
                      x[4 * q + 2] + s[4 * q + 2], x[4 * q + 3] + s[4 * q + 3]);
  }
}

}  // namespace

// key [8] and nonce [3] u32 and out [n_blocks, 16] u32 are device pointers;
// out is 16-byte aligned. Launches on `stream`; returns cudaGetLastError().
extern "C" int chacha20_keystream(const uint32_t* key, const uint32_t* nonce,
                                  uint32_t counter0, long long n_blocks,
                                  uint32_t* out, cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  const long long grid = (n_blocks + THREADS - 1) / THREADS;
  chacha20_kernel<<<(unsigned)grid, THREADS, 0, stream>>>(
      key, nonce, counter0, n_blocks, reinterpret_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
