// flash_decode: one-token attention against a KV cache. For each (b, h):
// softmax(q . K^T / sqrt(D) over positions < lengths[b]) . V, with GQA
// (query head h reads KV head h / G).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::flash_decode
// (body _fd_kernel). On the TPU each query head walks the KV blocks along a
// sequential grid axis with (m, l, acc) in VMEM, and every head of a GQA
// group reads its KV blocks again. Here one CUDA block owns one
// (batch, KV head) and serves all G query heads of that group from each K/V
// row it loads. Its four warps take interleaved 32-key chunks of the cache,
// each warp keeping its own online-softmax state in registers, and the block
// merges the four states at the end. Only ceil(lengths[b] / 32) chunks are
// visited: a position at or past lengths[b] is never read.
//
// What bounds it: the bytes of the valid K and V rows (2 x lengths x D x 2 B a
// KV head in bf16); the arithmetic is about one FMA per byte. At the serving
// shape (B=1, 16 KV heads, 513..576 positions, D=64) that is about 2.4 MB,
// 0.7 us at 3.35 TB/s, which is below a kernel launch: with one block per KV
// head only 16 of 132 SMs work, and the time is latency, not bandwidth.
// Splitting the KV axis across blocks (split-KV with a second merge pass) is
// the later fix; this first kernel is the simple, exact one. Scores read each
// key row with 16-byte loads by the lane that owns the key; the readout reads
// V rows coalesced across lanes (lane owns output dims lane, lane + 32, ...),
// eight rows in flight at a time.
//
// Layout: q [B, H, D], k/v [B, KVH, S, D] and o [B, H, D] are passed with
// their strides and a contiguous last dimension, so the model's cache
// [B, Smax, KVH, D] goes in as a permute view, never copied.
#include <cmath>

#include "common.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// q rows of the group, then each warp's (m, l, acc) for the final merge
template <int D, int GT> struct Smem {
  static constexpr int FLOATS = GT * D + 2 * WARPS * GT + WARPS * GT * D;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, int D, int GT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ o, int G, int S,
                    long long qb, long long qh,
                    long long kb, long long kh, long long ks,
                    long long vb, long long vh, long long vs,
                    long long ob, long long oh, float scale) {
  constexpr int V = Vec<T>::N;
  constexpr int DPL = (D + 31) / 32;    // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [GT][D]
  float* m_s = q_s + GT * D;            // [WARPS][GT]
  float* l_s = m_s + WARPS * GT;        // [WARPS][GT]
  float* a_s = l_s + WARPS * GT;        // [WARPS][GT][D]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lengths[b], S);
  const T* kp = k + b * kb + kvh * kh;
  const T* vp = v + b * vb + kvh * vh;

  // the group's query heads kvh * G .. kvh * G + G - 1; padding heads are 0
  for (int idx = threadIdx.x; idx < GT * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    q_s[idx] = g < G ? to_float(q[b * qb + (long long)(kvh * G + g) * qh + d]) : 0.f;
  }
  __syncthreads();

  float m[GT], l[GT], acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[g][c] = 0.f;
  }

  const int n_chunks = (len + 31) / 32;
  for (int chunk = warp; chunk < n_chunks; chunk += WARPS) {
    const int key = chunk * 32 + lane;
    const bool valid = key < len;

    // scores: lane owns one key row, read with 16-byte loads
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
    if (valid) {
      const T* krow = kp + key * ks;
#pragma unroll
      for (int d = 0; d < D; d += V) {
        float kv[V];
        load_vec(krow + d, kv);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
#pragma unroll
          for (int i = 0; i < V; i += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(q_s + g * D + d + i);
            s[g] = fmaf(q4.x, kv[i], s[g]);
            s[g] = fmaf(q4.y, kv[i + 1], s[g]);
            s[g] = fmaf(q4.z, kv[i + 2], s[g]);
            s[g] = fmaf(q4.w, kv[i + 3], s[g]);
          }
        }
      }
    }

    // online softmax over this chunk, one warp reduction per head
    float p[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float sg = valid ? s[g] * scale : NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(sg));
      p[g] = valid ? expf(sg - m_new) : 0.f;
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[g][c] *= corr;
    }

    // readout: V rows coalesced across lanes, eight rows in flight at a
    // time; p broadcast from the lane that owns the key (0 past nk)
    const int nk = min(32, len - chunk * 32);
    for (int j0 = 0; j0 < nk; j0 += 8) {
      float vd[8][DPL];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = j0 + jj;
        const T* vrow = vp + (long long)(chunk * 32 + j) * vs;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = c * 32 + lane;
          vd[jj][c] = (j < nk && d < D) ? to_float(vrow[d]) : 0.f;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float pj = __shfl_sync(FULL_MASK, p[g], j0 + jj);
#pragma unroll
          for (int c = 0; c < DPL; ++c)
            acc[g][c] = fmaf(pj, vd[jj][c], acc[g][c]);
        }
      }
    }
  }

  // merge the warps' states
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      m_s[warp * GT + g] = m[g];
      l_s[warp * GT + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = c * 32 + lane;
      if (d < D) a_s[(warp * GT + g) * D + d] = acc[g][c];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GT * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    if (g >= G) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w * GT + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(m_s[w * GT + g] - mx);
      den += l_s[w * GT + g] * e;
      num += a_s[(w * GT + g) * D + d] * e;
    }
    store(o + b * ob + (long long)(kvh * G + g) * oh + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int GT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int KVH, int G, int S,
                   const long long* st, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, GT>::BYTES;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  static_assert(Smem<D, GT>::BYTES <= 48 * 1024, "decode tile exceeds 48 KB");
  const dim3 grid(KVH, B);
  flash_decode_kernel<T, D, GT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), G, S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], scale);
  return cudaGetLastError();
}

// GT: the group size rounded up to a power of two (padding heads are masked)
template <typename T, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const int* len, void* o, int B, int KVH, int S,
                       const long long* st, cudaStream_t s) {
  if (G <= 1) return launch<T, D, 1>(q, k, v, len, o, B, KVH, G, S, st, s);
  if (G <= 2) return launch<T, D, 2>(q, k, v, len, o, B, KVH, G, S, st, s);
  if (G <= 4) return launch<T, D, 4>(q, k, v, len, o, B, KVH, G, S, st, s);
  if (G <= 8) return launch<T, D, 8>(q, k, v, len, o, B, KVH, G, S, st, s);
  if (G <= 16) return launch<T, D, 16>(q, k, v, len, o, B, KVH, G, S, st, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k,
                       const void* v, const int* len, void* o, int B, int KVH,
                       int S, const long long* st, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, len, o, B, KVH, S, st, s);
    case 32: return dispatch_g<T, 32>(G, q, k, v, len, o, B, KVH, S, st, s);
    case 64: return dispatch_g<T, 64>(G, q, k, v, len, o, B, KVH, S, st, s);
    case 128: return dispatch_g<T, 128>(G, q, k, v, len, o, B, KVH, S, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D], k/v [B,KVH,S,D], lengths [B] int32, o [B,H,D]; scores are
// scaled by 1/sqrt(D). Strides (in elements): q (batch, head), k (batch,
// head, sequence), v (batch, head, sequence), o (batch, head): 10 values.
// Returns cudaGetLastError().
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int dtype,
                                int B, int H, int KVH, int S, int D,
                                const long long* strides, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  const int G = H / KVH;
  const int* len = static_cast<const int*>(lengths);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch_d<float>(D, G, q, k, v, len, o, B, KVH, S, strides, st);
  if (dtype == DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, G, q, k, v, len, o, B, KVH, S, strides, st);
  return cudaErrorInvalidValue;
}
