// flash_attention: prefill attention, softmax(Q K^T / sqrt(DQK), causal or not) V,
// with GQA (query head h reads KV head h / G). Q and K have head dim DQK, V and
// the output DV: DQK = DV in {16, 32, 64, 80, 128, 160}, or MLA's DQK 192
// (nope 128 + rope 64) with DV 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _fa_kernel). On the TPU the KV axis is a sequential grid axis that
// carries the online-softmax state (m, l, acc) in VMEM across grid steps. CUDA
// blocks run in parallel and in no order, so here one block owns one
// (batch, head, query tile) and walks its KV tiles in a loop, keeping
// (m, l, acc) in registers. As in _fa_kernel, KV tiles wholly above the causal
// diagonal are skipped (the loop stops at the query tile's last row).
//
// What bounds it: at the serving shape (B=1, H=16, S=512, D=64, bf16, causal)
// the bytes of q, k, v and o, 4.2 MB or 1.25 us at 3.35 TB/s; the causal
// FLOPs (0.54 GFLOP) take 0.55 us on the bf16 tensor cores. At the GQA shape
// (B=4, H=48, KVH=4, S=500, D=128, causal) the bytes, 53 MB or 15.9 us,
// against 12.4 us of tensor-core FLOPs. The first kernel did its arithmetic in
// fp32 FMA on the CUDA cores with K/V widened to fp32 in shared memory and
// synchronous 32-key tiles: 80 us and 657 us, 64x and 41x the bounds, and
// 4-15x scaled_dot_product_attention.
//
// bf16 design (on the tensor cores with wgmma):
// - A warpgroup (128 threads) owns 64 query rows (BQ) and walks 64-key tiles
//   (BK). Q, K and V stay bf16 in shared memory, in the
//   no-swizzle "core matrix" order wgmma reads (8 rows x 16 bytes a core
//   matrix, 128 contiguous bytes), so one layout serves every head dim.
// - K/V tiles come through a ring of STAGES stages with cp.async (16 bytes a
//   thread, zero-filled past Skv): the copies of tiles j + 1 .. j + STAGES - 1
//   overlap the products of tile j. Four stages at DQK <= 64 (72 KB a
//   one-warpgroup block, three blocks an SM), three at DQK = 128 (112 KB, two
//   blocks an SM; 128 KB with two warpgroups, one), two at MLA's DQK = 192
//   (24 KB of Q and 2 x (24 KB of K + 16 KB of V): 104 KB, two blocks an SM).
// - S = Q K^T is DQK/16 wgmma m64n64k16 (A and B from shared memory, K-major);
//   O += P V is 4 wgmma m64nDVk16 with P as the A operand in registers
//   (the S accumulator's layout is the A fragment's, converted to bf16 in
//   place) and V read as a transposed (N-major) B operand, which 16-bit
//   types allow. Both accumulate in fp32.
// - The online softmax (m, l) stays in fp32 registers in the accumulator
//   layout: a thread holds 2 rows x 16 keys of S, so a row's max takes two
//   quad shuffles, and l stays a per-thread partial sum until the end.
//   Masking uses NEG_INF = -1e30 as the reference, only on tiles that cross
//   Skv or the diagonal.
// - Causal query tiles launch heaviest first (the tile index counts down
//   along the slowest grid axis), so the last wave holds the short tiles.
// - The output is staged in shared memory and written as 16-byte rows.
// - A block has one warpgroup, or two when the GQA group is even (at
//   DQK <= 128; MLA's DQK 192 has G 1 and one warpgroup): then the
//   two warpgroups are two query heads of one KV head, each with its own Q
//   tile, and every K/V tile is copied once for both. At the GQA shape the
//   K/V tiles, read again by each head of a group and each causal query
//   tile, come from L2 at about its rate; pairing halves that traffic.
// wgmma (not mma.sync) because it is the only path to the card's full
// tensor-core rate and reads both operands of S from shared memory without
// ldmatrix; cp.async (not TMA) keeps the strided operand views without a
// tensor map encoded on every call.
// Measured on the H100 with ablated copies (python -m
// repro_torch.kernels.ablate, PERF.md): the products and the exponentials
// are a small part of the time; the K/V copies in the loop and, at the GQA
// shape, each block's fixed start and end are most of it, and the ring's
// depth does not matter. Two warpgroups sharing one query tile, each taking
// every other KV tile, were slower at both shapes. What is left: TMA with a
// producer warp (warp specialisation), 128-byte swizzled tiles, and
// persistent blocks that overlap one tile's end with the next one's start.
//
// MLA (DQK 192, DV 128, G 1, one head a block): the bytes of q, k, v and o
// bound it too, 84 MB at B1 H128 S512 or 25 us, against 5.4 GFLOP causal (5.5
// us on the tensor cores). A 192-wide row is 24 core matrices, which 128
// threads do not divide into whole rows, so its tiles are copied chunk by chunk
// (load_tile's general path). Simple and right first; its time is in PERF.md.
//
// D 80 (zamba2's shared block) and 160 (stablelm-12b): S takes 5 or 10 k16
// steps and P V one wgmma m64n80k16 or m64n160k16 a step (N a multiple of 8
// up to 256), the tiles stay in core-matrix order (10 or 20 core matrices a
// row, copied chunk by chunk as at 192), three stages at 80 and two at 160
// (20 KB a tile: 100 KB with one warpgroup, 120 KB with two). Nothing is
// padded or copied outside the kernel. Simple and right first; its times
// are in PERF.md.
//
// fp32 keeps the first kernel's design: exact fp32 FMA on the CUDA cores
// (the reference's 2e-5 tolerance rules out TF32), 32x32 tiles widened to
// fp32 in shared memory, lane j of a warp owning key j of a tile.
//
// Cross-attention (whisper's decoder over its encoder's frames): the queries
// and the keys have lengths of their own, Sq and Skv, and the attention is
// not causal. Query tiles and output rows are bounded by Sq, key tiles and
// the key mask by Skv; a block walks all of its Skv keys. Causal attention
// takes Sq = Skv only, as the TPU kernel's mask assumes aligned positions,
// and the entry point refuses it otherwise. At whisper's cross shape (B1
// H20 Sq64 Skv1500 D64) the bytes of k and v bound it, 8 MB or 2.4 us, and
// a block a (head, query tile) gives 20 blocks for the 132 SMs: simple and
// right first; its time is in PERF.md.
//
// Layout: every tensor is passed with its own strides (batch, head, sequence)
// and a contiguous last dimension, so the model hands over transpose views of
// its [B, S, H, D] activations without a copy. Rows past Sq or Skv are
// zero-filled on load and masked, so any lengths work.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace rt;

namespace {

constexpr int BQ = 32;                  // query rows per block
constexpr int BK = 32;                  // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;        // query rows per warp
constexpr int THREADS = WARPS * 32;

template <int DQK, int DV> struct Smem {
  static constexpr int KS = DQK + 4;    // padded K row stride (floats)
  static constexpr int FLOATS = BQ * DQK + BK * KS + BK * DV + BQ * BK;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// Rows [row0, row0 + NROWS) of an [S, D] slab with row stride rs (elements)
// into shared memory with row stride ds (floats), widened to fp32; rows at or
// past S are zero.
template <typename T, int D, int NROWS>
__device__ __forceinline__ void load_tile(float* dst, int ds, const T* src,
                                          long long rs, int row0, int S) {
  constexpr int V = Vec<T>::N;
  constexpr int VPR = D / V;            // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < NROWS * VPR; idx += THREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * V;
    float vals[V];
    if (row0 + r < S) {
      load_vec(src + (long long)(row0 + r) * rs + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vals[i] = 0.f;
    }
    float* d = dst + r * ds + c;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(d + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int KVH, int Sq, int Skv,
                       long long qb, long long qh, long long qs,
                       long long kb, long long kh, long long ks,
                       long long vb, long long vh, long long vs,
                       long long ob, long long oh, long long os,
                       float scale, int causal) {
  constexpr int KS = Smem<DQK, DV>::KS;
  constexpr int DPL = (DV + 31) / 32;   // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [BQ][DQK]
  float* k_s = q_s + BQ * DQK;          // [BK][KS]
  float* v_s = k_s + BK * KS;           // [BK][DV]
  float* p_s = v_s + BK * DV;           // [WARPS][ROWS][BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + kvh * kh;
  const T* vp = v + b * vb + kvh * vh;

  load_tile<T, DQK, BQ>(q_s, DQK, qp, qs, q0, Sq);

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const float* q_w = q_s + warp * ROWS * DQK;   // this warp's query rows
  float* p_w = p_s + warp * ROWS * BK;        // this warp's probabilities
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();                  // previous tile consumed by every warp
    load_tile<T, DQK, BK>(k_s, KS, kp, ks, kv0, Skv);
    load_tile<T, DV, BK>(v_s, DV, vp, vs, kv0, Skv);
    __syncthreads();

    // scores: lane owns key kv0 + lane, for each of the warp's rows
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * KS;
#pragma unroll 4
    for (int d = 0; d < DQK; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_w + r * DQK + d);
        s[r] = fmaf(q4.x, k4.x, s[r]);
        s[r] = fmaf(q4.y, k4.y, s[r]);
        s[r] = fmaf(q4.z, k4.z, s[r]);
        s[r] = fmaf(q4.w, k4.w, s[r]);
      }
    }

    // online softmax, one warp reduction per row
    const int key = kv0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = q0 + warp * ROWS + r;
      const bool valid = key < Skv && (!causal || key <= row);
      const float sr = valid ? s[r] * scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = valid ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      p_w[r * BK + lane] = p;
    }
    __syncwarp();

    // readout: lane owns output dims lane, lane + 32, ...
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vj[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = c * 32 + lane;
          vj[jj][c] = d < DV ? v_s[(j + jj) * DV + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_w + r * BK + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          acc[r][c] = fmaf(p4.x, vj[0][c], acc[r][c]);
          acc[r][c] = fmaf(p4.y, vj[1][c], acc[r][c]);
          acc[r][c] = fmaf(p4.z, vj[2][c], acc[r][c]);
          acc[r][c] = fmaf(p4.w, vj[3][c], acc[r][c]);
        }
      }
    }
  }

  T* op = o + b * ob + h * oh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + warp * ROWS + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = c * 32 + lane;
      if (d < DV) store(op + row * os + d, acc[r][c] / denom);
    }
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Skv, const long long* st,
                   int causal, double sc, cudaStream_t stream) {
  constexpr size_t smem = Smem<DQK, DV>::BYTES;
  const float scale = sc > 0 ? static_cast<float>(sc)
      : static_cast<float>(1.0 / std::sqrt(static_cast<double>(DQK)));
  auto kernel = flash_attention_kernel<T, DQK, DV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KVH, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16: wgmma, cp.async

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;                  // query rows of a warpgroup
constexpr int BK = 64;                  // keys a tile
constexpr int WG = 128;                 // threads of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// A block's ring: STAGES K/V tiles, STAGES - 1 of them in flight while one
// is used. Bytes of one 64-row bf16 tile of Q or K (QK_TILE) and of V
// (V_TILE), and of a block's tiles for NW warpgroups: NW Q tiles, then
// STAGES x (K, V).
template <int DQK, int DV, int NW> struct Smem {
  static constexpr int STAGES = DQK <= 64 ? 4 : DQK <= 128 ? 3 : 2;
  static constexpr int QK_TILE = 64 * DQK * 2;
  static constexpr int V_TILE = 64 * DV * 2;
  static constexpr int STAGE = QK_TILE + V_TILE;
  static constexpr int BYTES = NW * QK_TILE + STAGES * STAGE;
  static_assert(NW * 64 * (DV + 8) * 2 <= BYTES, "output stage too large");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a [S, D] slab with row stride rs (elements) into
// a tile at shared address dst in core-matrix order: 16-byte chunk i holds
// row (i / 8) / (D / 8) * 8 + i % 8, columns ((i / 8) % (D / 8)) * 8 + 0..7.
// Eight consecutive threads fill one core matrix (128 contiguous bytes).
// Thread t of the NT that copy takes chunks t, t + NT, ... (only the first
// 64 * D / 8 threads when NT is more). Where NT is a multiple of D (every
// D but 80, 160 and 192) that is one column block, rows NT / (D / 8) apart,
// so its source pointer only steps; otherwise each chunk's row and column
// are computed on their own.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long rs, int row0, int S, int t) {
  constexpr int CPR = D / 8;            // core matrices across a row
  constexpr int LT = 64 * CPR < NT ? 64 * CPR : NT;
  constexpr int RSTEP = LT / CPR;       // rows between a thread's chunks
  if (LT < NT && t >= LT) return;
  if constexpr (LT % D != 0) {
    // a tile's chunks: LT each, the last pass short where LT does not
    // divide them (D 80 with 256 threads)
    constexpr int CH = 64 * CPR;
#pragma unroll
    for (int j = 0; j < (CH + LT - 1) / LT; ++j) {
      const int i = t + j * LT;
      if (CH % LT != 0 && i >= CH) break;
      const int row = row0 + (i / 8 / CPR) * 8 + i % 8;
      const bool ok = row < S;
      cp_async_16(dst + 16 * i, ok ? src + row * rs + (i / 8 % CPR) * 8 : src, ok);
    }
  } else {
    const int row = row0 + (t / 8 / CPR) * 8 + t % 8;
    const bf16* p = src + row * rs + (t / 8 % CPR) * 8;
    dst += 16 * t;
#pragma unroll
    for (int j = 0; j < 64 / RSTEP; ++j) {
      const bool ok = row + j * RSTEP < S;
      cp_async_16(dst + j * 16 * LT, ok ? p : src, ok);
      p += RSTEP * rs;
    }
  }
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (between core matrices along K), stride byte offset (between core
// matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across a wgmma fence or wait
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], A in registers, B N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A in registers, B N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers, B N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 80] (+)= A[64 x 16] B[16 x 80], A in registers, B N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers, B N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 160] (+)= A[64 x 16] B[16 x 160], A in registers, B N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// O[64 x D] += P[64 x 16] V[16 x D]
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(o, a, db, 1);
  else if constexpr (D == 32) wgmma_rs_n32(o, a, db, 1);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db, 1);
  else if constexpr (D == 80) wgmma_rs_n80(o, a, db, 1);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, db, 1);
  else wgmma_rs_n160(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Accumulator layout of wgmma m64nN (fp32) for thread t of a warpgroup: warp
// w = t / 32 owns rows 16 w .. 16 w + 15; value 4 j + r (r < 2) is row
// 16 w + (t % 32) / 4, column 8 j + 2 (t % 4) + r, and value 4 j + 2 + r the
// row 8 below.
//
// A block has NW warpgroups: warpgroup g owns the 64 query rows of head
// blockIdx.x * NW + g, and the NW heads share one KV head (NW divides the
// GQA group), so each K/V tile is copied once for all of them.
template <int DQK, int DV, int NW>
__global__ void __launch_bounds__(NW * WG)
flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int H, int KVH, int Sq, int Skv,
                          long long qb, long long qh, long long qs,
                          long long kb, long long kh, long long ks,
                          long long vb, long long vh, long long vs,
                          long long ob, long long oh, long long os,
                          float scale_log2, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  using SM = Smem<DQK, DV, NW>;
  constexpr int STAGES = SM::STAGES;
  constexpr int NT = NW * WG;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const uint32_t q_s = smem_addr(smem) + wg * SM::QK_TILE;   // this warpgroup's Q
  const uint32_t kv_s = smem_addr(smem) + NW * SM::QK_TILE;  // stage st: K at + st STAGE, V after

  const int h = blockIdx.x * NW + wg, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest tiles first
  const int kvh = h / (H / KVH);
  const int warp = tid / 32, lane = tid % 32;
  const bf16* kp = k + b * kb + kvh * kh;
  const bf16* vp = v + b * vb + kvh * vh;

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_kv = (kv_end + BK - 1) / BK;

  // cp.async group p holds tile p (group 0 also Q); STAGES - 1 in flight
  load_tile<DQK, WG>(q_s, q + b * qb + h * qh, qs, q0, Sq, tid);
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_kv) {
      load_tile<DQK, NT>(kv_s + p * SM::STAGE, kp, ks, p * BK, Skv, threadIdx.x);
      load_tile<DV, NT>(kv_s + p * SM::STAGE + SM::QK_TILE, vp, vs, p * BK, Skv,
                        threadIdx.x);
    }
    cp_async_commit();
  }

  const int row_a = q0 + warp * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  float o_acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_kv; ++t) {
    const int ahead = t + STAGES - 1;   // into the stage tile t - 1 used
    if (ahead < n_kv) {
      const uint32_t nxt = kv_s + (ahead % STAGES) * SM::STAGE;
      load_tile<DQK, NT>(nxt, kp, ks, ahead * BK, Skv, threadIdx.x);
      load_tile<DV, NT>(nxt + SM::QK_TILE, vp, vs, ahead * BK, Skv, threadIdx.x);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();        // tile t (and Q) has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t k_s = kv_s + (t % STAGES) * SM::STAGE, v_s = k_s + SM::QK_TILE;

    // S = Q K^T: DQK / 16 steps of 16 along DQK (two core matrices, 256 bytes)
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss_n64(s, desc(q_s + kk * 256, 128, 16 * DQK),
                   desc(k_s + kk * 256, 128, 16 * DQK), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // online softmax in the log2 domain, rows row_a (r = 0) and row_a + 8
    const int kv0 = t * BK;
    const bool edge = kv0 + BK > Skv || (causal && kv0 + BK - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float x = s[i] * scale_log2;
      if (edge) {
        const int key = kv0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (key >= Skv || (causal && key > row_a + 8 * r)) x = NEG_INF;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2f(s[i] - m[r]);
      l[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o_acc[i] *= corr[(i / 2) % 2];

    // P as bf16 A fragments, 16 keys a step: values 8 kk .. 8 kk + 7
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P V: V [BK x DV] as the N-major B operand; a step of 16 keys is two
    // core matrices along K (16 DV bytes apart), core matrices along N 128
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<DV>(o_acc, a[kk], desc(v_s + kk * 32 * DV, 16 * DV, 128));
    wgmma_commit();
    wgmma_wait();
    fence_regs(o_acc);
    __syncthreads();                    // stage t % STAGES free again
  }

  // finish the row sums over the quad, normalise, stage the tile in shared
  // memory (row stride DV + 8 elements: conflict-free 4-byte writes) and
  // write it as 16-byte rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  constexpr int OS = DV + 8;
  bf16* o_s = reinterpret_cast<bf16*>(smem) + wg * 64 * OS;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + lane / 4 + 8 * r;
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(o_s + row * OS + col) =
          pack_bf16(o_acc[4 * j + 2 * r] * l[r], o_acc[4 * j + 2 * r + 1] * l[r]);
    }
  __syncthreads();
  bf16* op = o + b * ob + h * oh;
#pragma unroll
  for (int j = 0; j < 64 * (DV / 8) / WG; ++j) {
    const int i = j * WG + tid;
    const int row = i / (DV / 8), c = (i % (DV / 8)) * 8;
    if (q0 + row < Sq)
      *reinterpret_cast<uint4*>(op + (q0 + row) * os + c) =
          *reinterpret_cast<const uint4*>(o_s + row * OS + c);
  }
}

template <int DQK, int DV, int NW>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Skv, const long long* st,
                   int causal, double sc, cudaStream_t stream) {
  constexpr int smem = Smem<DQK, DV, NW>::BYTES;
  const float scale_log2 = sc > 0 ? static_cast<float>(LOG2E * sc)
      : static_cast<float>(LOG2E / std::sqrt(static_cast<double>(DQK)));
  auto kernel = flash_attention_tc_kernel<DQK, DV, NW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(H / NW, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, NW * WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, KVH, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale_log2, causal);
  return cudaGetLastError();
}

// Two warpgroups (two heads) a block where the GQA group is even, else one.
// MLA (DQK 192) has G 1 and always takes one.
template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Skv, const long long* st,
                   int causal, double sc, cudaStream_t stream) {
  if constexpr (DQK == 192)
    return launch<DQK, DV, 1>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
  else
    return (H / KVH) % 2 == 0
               ? launch<DQK, DV, 2>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream)
               : launch<DQK, DV, 1>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
}

}  // namespace tc

// The kernel for one (dtype, DQK, DV): wgmma for bf16, CUDA cores for fp32.
template <typename T, int DQK, int DV>
cudaError_t launch_dims(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KVH, int Sq, int Skv, const long long* st,
                        int causal, double sc, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return tc::launch<DQK, DV>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
  else
    return launch<float, DQK, DV>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
}

template <typename T>
cudaError_t dispatch_d(int DQK, int DV, const void* q, const void* k,
                       const void* v, void* o, int B, int H, int KVH, int Sq,
                       int Skv, const long long* st, int causal, double sc,
                       cudaStream_t stream) {
  if (DQK == 192 && DV == 128)
    return launch_dims<T, 192, 128>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
  if (DQK != DV) return cudaErrorInvalidValue;
  switch (DQK) {
    case 16: return launch_dims<T, 16, 16>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
    case 32: return launch_dims<T, 32, 32>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
    case 64: return launch_dims<T, 64, 64>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
    case 80: return launch_dims<T, 80, 80>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
    case 128: return launch_dims<T, 128, 128>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
    case 160: return launch_dims<T, 160, 160>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, sc, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the kernel for (dtype, DQK, DV, NW warpgroups).
template <int DQK, int DV>
int smem_dims(int dtype, bool two) {
  if (dtype != DTYPE_BF16) return (int)Smem<DQK, DV>::BYTES;
  return two ? tc::Smem<DQK, DV, 2>::BYTES : tc::Smem<DQK, DV, 1>::BYTES;
}

}  // namespace

// q [B,H,Sq,DQK], k [B,KVH,Skv,DQK], v [B,KVH,Skv,DV], o [B,H,Sq,DV]; scores
// are scaled by `scale`, or by 1/sqrt(DQK) where it is not above 0; causal
// only where Sq = Skv. (DQK, DV) is (D, D)
// for D in {16, 32, 64, 80, 128, 160} or (192, 128). Strides (in elements)
// are (batch, head, sequence) for q, k, v, o in that order: 12 values.
// Returns the launch's cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int KVH,
                                   int Sq, int Skv, int DQK, int DV,
                                   const long long* strides, int causal,
                                   double scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0 ||
      (causal && Sq != Skv))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch_d<float>(DQK, DV, q, k, v, o, B, H, KVH, Sq, Skv, strides,
                             causal, scale, st);
  if (dtype == DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(DQK, DV, q, k, v, o, B, H, KVH, Sq, Skv,
                                     strides, causal, scale, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the kernel for (dtype, DQK, DV, GQA group
// G) asks for, in bytes; -1 for an unsupported pair of head dims.
extern "C" int flash_attention_smem_bytes(int dtype, int DQK, int DV, int G) {
  const bool two = G % 2 == 0;
  if (DQK == 192 && DV == 128) return smem_dims<192, 128>(dtype, false);
  if (DQK != DV) return -1;
  switch (DQK) {
    case 16: return smem_dims<16, 16>(dtype, two);
    case 32: return smem_dims<32, 32>(dtype, two);
    case 64: return smem_dims<64, 64>(dtype, two);
    case 80: return smem_dims<80, 80>(dtype, two);
    case 128: return smem_dims<128, 128>(dtype, two);
    case 160: return smem_dims<160, 160>(dtype, two);
    default: return -1;
  }
}
