// flash_attention: prefill attention, softmax(Q K^T / sqrt(D), causal or not) V,
// with GQA (query head h reads KV head h / G).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _fa_kernel). On the TPU the KV axis is a sequential grid axis that
// carries the online-softmax state (m, l, acc) in VMEM across grid steps. CUDA
// blocks run in parallel and in no order, so here one block owns one
// (batch, head, 32-row query tile) and walks its KV tiles in a loop, keeping
// (m, l, acc) in registers. As in _fa_kernel, KV tiles wholly above the causal
// diagonal are skipped (the loop stops at the query tile's last row).
//
// What bounds it: at the serving shape (S=512, H=16, D=64, bf16) the card's
// bound is the bytes of q, k, v and o (about 4 MB, 1.3 us at 3.35 TB/s); the
// causal FLOPs (0.54 GFLOP) would take 0.5 us on the bf16 tensor cores. This
// first kernel does its arithmetic in fp32 on the CUDA cores (so fp32 inputs
// keep the reference's 2e-5 tolerance), which makes FMA throughput its limit
// (at least 8 us at 67 TFLOP/s). The design keeps the FMA units fed: each KV
// tile is loaded once into shared memory for 32 query rows, every score and
// readout reads shared memory as float4 broadcasts or conflict-free rows (the
// K tile rows are padded by 4 floats), and lane j of a warp owns key j of the
// tile, so the row max and sum are one warp reduction each. wgmma, TMA and a
// bf16 tensor-core path are later work.
//
// Layout: every tensor is passed with its own strides (batch, head, sequence)
// and a contiguous last dimension, so the model hands over transpose views of
// its [B, S, H, D] activations without a copy. Rows past S are zero-filled
// on load and masked, so any S works.
#include <cmath>

#include "common.cuh"

using namespace rt;

namespace {

constexpr int BQ = 32;                  // query rows per block
constexpr int BK = 32;                  // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;        // query rows per warp
constexpr int THREADS = WARPS * 32;

template <int D> struct Smem {
  static constexpr int KS = D + 4;      // padded K row stride (floats)
  static constexpr int FLOATS = BQ * D + BK * KS + BK * D + BQ * BK;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// Rows [row0, row0 + BK_ROWS) of a [S, D] slab with row stride rs (elements)
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int KVH, int S,
                       long long qb, long long qh, long long qs,
                       long long kb, long long kh, long long ks,
                       long long vb, long long vh, long long vs,
                       long long ob, long long oh, long long os,
                       float scale, int causal) {
  constexpr int KS = Smem<D>::KS;
  constexpr int DPL = (D + 31) / 32;    // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [BQ][D]
  float* k_s = q_s + BQ * D;            // [BK][KS]
  float* v_s = k_s + BK * KS;           // [BK][D]
  float* p_s = v_s + BK * D;            // [WARPS][ROWS][BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + kvh * kh;
  const T* vp = v + b * vb + kvh * vh;

  load_tile<T, D, BQ>(q_s, D, qp, qs, q0, S);

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const float* q_w = q_s + warp * ROWS * D;   // this warp's query rows
  float* p_w = p_s + warp * ROWS * BK;        // this warp's probabilities
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();                  // previous tile consumed by every warp
    load_tile<T, D, BK>(k_s, KS, kp, ks, kv0, S);
    load_tile<T, D, BK>(v_s, D, vp, vs, kv0, S);
    __syncthreads();

    // scores: lane owns key kv0 + lane, for each of the warp's rows
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_w + r * D + d);
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
      const bool valid = key < S && (!causal || key <= row);
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
          vj[jj][c] = d < D ? v_s[(j + jj) * D + d] : 0.f;
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
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = c * 32 + lane;
      if (d < D) store(op + row * os + d, acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int S, const long long* st,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::BYTES;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KVH, S,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int KVH, int S,
                       const long long* st, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KVH, S, st, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KVH, S, st, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KVH, S, st, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KVH, S, st, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,S,D], k/v [B,KVH,S,D], o [B,H,S,D]; scores are scaled by 1/sqrt(D).
// Strides (in elements) are (batch, head, sequence) for q, k, v, o in that
// order: 12 values.
// Returns the launch's cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int KVH,
                                   int S, int D, const long long* strides,
                                   int causal, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch_d<float>(D, q, k, v, o, B, H, KVH, S, strides, causal, st);
  if (dtype == DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KVH, S, strides, causal, st);
  return cudaErrorInvalidValue;
}
