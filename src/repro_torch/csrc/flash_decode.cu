// flash_decode: one-token attention against a KV cache. For each (b, h):
// softmax(q . K^T / sqrt(D) over positions < lengths[b]) . V, with GQA
// (query head h reads KV head h / G).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::flash_decode
// (body _fd_kernel). On the TPU each query head walks the KV blocks along a
// sequential grid axis with (m, l, acc) in VMEM, and every head of a GQA
// group reads its KV blocks again.
//
// What bounds it: the bytes of the valid K and V rows (2 x length x D x 2 B a
// KV head in bf16); the arithmetic is about one FMA a byte. At the serving
// shape (B=1, 16 KV heads, 576-position cache, length 513, D=64) that is
// 2.1 MB, 0.63 us at 3.35 TB/s, below what one launch costs; at the GQA
// shape (B=4, 4 KV heads, D=128, lengths 1..576) 2.5 MB, 0.76 us. Neither
// can come near its bound: the time is one kernel's latency. The first
// kernel (one block per (batch, KV head): 16 blocks on 132 SMs, each lane
// reading a whole key row) took 25 us at the serving shape, cold.
//
// The design, split-KV: the grid is (splits, KVH, B). The wrapper cuts the
// cache axis into `splits` chunks of `chunk` positions (a multiple of 32, at
// least 64; kernels/decode_attention.py::plan_splits picks them from B, KVH,
// S and the SM count, never from `lengths`, so the host never waits for the
// card), enough to put a block on every SM at the serving shape (9 x 64
// positions x 16 KV heads = 144 blocks). A block reads only the positions of
// its chunk below lengths[b]: one whose chunk starts at or past lengths[b]
// reads nothing and writes an empty partial (m = NEG_INF, the reference's
// -inf; l = 0; acc = 0). Loads are 16 bytes a lane and coalesced: D*size/16
// lanes share a row (8 for D=64 bf16, so a warp reads 4 whole rows an
// instruction), and each lane has up to four rows of K and V in flight
// before it uses any (Unroll: fewer for large groups). The row's score is a butterfly over its lanes; each lane then
// keeps its own online-softmax state (m, l and its 16 bytes of acc) for every
// query head of the group, so every K/V row loaded serves all G heads.
// The states of a warp's row slots merge by shuffles, the block's four warps
// through shared memory.
//
// The merge, in the same launch: each block writes its partial (m, l, acc)
// in fp32 to a scratch buffer that the wrapper allocates with torch.empty,
// then adds one to a counter of its (b, kvh); the block that brings it to
// `splits` (the last to finish) rescales the partials by 2^(m - max m),
// combines them, writes the output and sets the counter back to 0. The
// wrapper keeps one zeroed counter buffer per device, so calls on one stream
// never share a counter (two streams running decode at once would). One call
// is one CUDA launch: a merge kernel of its own, as first built, made the
// call no faster and cost a second launch (PERF.md). With one split (B x KVH
// already fills the card) the block normalises and writes the output itself. A length of 0 gives 0
// (every partial is empty). fp32 and bf16 share the design; the arithmetic
// is fp32 in both, the softmax in base 2 (scores prescaled by log2 e).
//
// Rows whose 16-byte vectors do not divide a warp (D = 80 and 160: 10 or 20
// vectors in bf16, 20 or 40 in fp32): a row's lanes are rounded up to a
// power of two (LPR, at most 32), each lane takes VPL vectors of the row,
// vectors LPR apart, and the spare slots are masked: they load nothing,
// score 0 and are never written out, so the shuffle reductions stay over
// LPR lanes as for the other dims. bf16 D80 then keeps 10 of a row's 16
// lanes busy, bf16 D160 and fp32 D80 20 of 32, fp32 D160 40 of 64 slots.
// Where the group's query heads and the warps' partials do not fit the 48 KB
// of static shared memory side by side (D160 at a group of 16), the partials
// reuse the query heads' buffer after a barrier.
//
// The log-sum-exp, for a caller that merges partial outputs over shards of
// the cache (the sequence-parallel decode): where `lse` is given, the block
// that writes o[b, h] also writes lse[b, h] = ln sum exp(scores) over the
// valid positions, (m + log2 l) ln 2 from the state it already holds (the
// one split's, or the merged one), and -inf where the row has none.
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

// rows a lane loads before it uses any: fewer for large groups, whose
// per-lane state (GT heads x 16 bytes of acc) fills the registers
constexpr double LOG2E = 1.4426950408889634;
constexpr float LN2 = 0.6931471805599453f;
// partials the last block's merge has in flight a thread and output
constexpr int MERGE_BATCH = 8;

template <int GT> struct Unroll { static constexpr int N = GT <= 2 ? 4 : GT <= 4 ? 2 : 1; };

// How a row of D elements of T maps onto a warp: E elements a 16-byte
// vector, NV vectors a row, LPR lanes a row (NV rounded up to a power of
// two, at most a warp), VPL vectors a lane; PAD when some of the LPR x VPL
// slots lie past the row.
template <typename T, int D> struct RowMap {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int NV = D / E;
  static_assert(NV * E == D, "a row is whole 16-byte vectors");
  static constexpr int LPR = NV > 16 ? 32 : NV > 8 ? 16 : NV > 4 ? 8
                           : NV > 2 ? 4 : NV > 1 ? 2 : 1;
  static constexpr int VPL = (NV + LPR - 1) / LPR;
  static constexpr bool PAD = LPR * VPL != NV;
};

// 16 loaded bytes widened to fp32
__device__ __forceinline__ void widen(const uint4& raw, float* out, const float*) {
  out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void widen(const uint4& raw, float* out,
                                      const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// ln sum exp of a state (m in log2 units, l the sum of 2^(s - m)); -inf
// for an empty state (l = 0)
__device__ __forceinline__ float state_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * LN2 : -INFINITY;
}

// Fold state (m2, l2, a2) into (m, l, a); m in log2 units.
template <int E>
__device__ __forceinline__ void combine(float& m, float& l, float* a, float m2,
                                        float l2, const float* a2) {
  const float mx = fmaxf(m, m2);
  const float c1 = exp2f(m - mx), c2 = exp2f(m2 - mx);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = a[e] * c1 + a2[e] * c2;
  m = mx;
}

template <typename T, int D, int GT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ lengths, T* __restrict__ o,
                          float* __restrict__ lse,
                          float* __restrict__ part, int G, int S, int chunk,
                          long long qb, long long qh,
                          long long kb, long long kh, long long ks,
                          long long vb, long long vh, long long vs,
                          long long ob, long long oh, int* __restrict__ counters,
                          float scale_log2) {
  using RM = RowMap<T, D>;
  constexpr int E = RM::E;              // elements of one 16-byte vector
  constexpr int LPR = RM::LPR;          // lanes that share a row
  constexpr int VPL = RM::VPL;          // vectors a lane loads from a row
  constexpr int RPW = 32 / LPR;         // rows a warp loads an instruction
  constexpr int RPB = RPW * WARPS;      // rows the block loads an instruction
  constexpr int U = Unroll<GT>::N;
  // the partials take the query heads' buffer where both do not fit
  constexpr bool ALIAS = (1 + WARPS) * GT * D * sizeof(float) > 40 * 1024;
  __shared__ __align__(16) float q_s[ALIAS ? WARPS * GT * D : GT * D];
  __shared__ float m_s[WARPS * GT], l_s[WARPS * GT];
  __shared__ __align__(16) float a_own[ALIAS ? 4 : WARPS * GT * D];
  float* const a_s = ALIAS ? q_s : a_own;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x, KVH = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / LPR;          // the warp's row this lane loads
  const int c0 = (lane % LPR) * E;      // its first dimension; its vector j
  //                                       starts j * LPR * E further on
  bool vok[VPL];                        // which of its vectors lie in the row
#pragma unroll
  for (int j = 0; j < VPL; ++j) vok[j] = !RM::PAD || c0 + j * LPR * E < D;
  const int len = max(0, min(lengths[b], S));
  const int r0 = split * chunk;
  const int r1 = min(r0 + chunk, len);

  float m[GT], l[GT], acc[GT][VPL * E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VPL * E; ++e) acc[g][e] = 0.f;
  }

  if (r0 < r1) {                        // the same for the whole block
    const T* kp = k + b * kb + kvh * kh + c0;
    const T* vp = v + b * vb + kvh * vh + c0;
    uint4 kr[U][VPL], vr[U][VPL];
    bool ok[U];
    auto load_rows = [&](int base) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = base + u * RPB + slot;
        ok[u] = row < r1;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const bool in = ok[u] && vok[j];
          kr[u][j] = in ? *reinterpret_cast<const uint4*>(kp + row * ks + j * LPR * E)
                        : make_uint4(0, 0, 0, 0);
          vr[u][j] = in ? *reinterpret_cast<const uint4*>(vp + row * vs + j * LPR * E)
                        : make_uint4(0, 0, 0, 0);
        }
      }
    };
    // the first rows are in flight while the group's query heads
    // kvh * G .. kvh * G + G - 1 go to shared memory (padding heads are 0)
    load_rows(r0 + warp * RPW);
    for (int idx = threadIdx.x; idx < GT * D; idx += THREADS) {
      const int g = idx / D, d = idx % D;
      q_s[idx] = g < G ? to_float(q[b * qb + (long long)(kvh * G + g) * qh + d])
                       : 0.f;
    }
    __syncthreads();
    // the loop bound is the same for every lane of a warp, so the
    // butterfly's shuffles always have all 32 lanes
    for (int base = r0 + warp * RPW; base < r1; base += U * RPB) {
      if (base != r0 + warp * RPW) load_rows(base);
      float s[U][GT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < GT; ++g) s[u][g] = 0.f;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          if (!vok[j]) continue;        // a spare slot scores 0
          float kf[E];
          widen(kr[u][j], kf, static_cast<const T*>(nullptr));
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float* qg = q_s + g * D + c0 + j * LPR * E;
            float acc_s = s[u][g];
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qg + e);
              acc_s = fmaf(q4.x, kf[e], acc_s);
              acc_s = fmaf(q4.y, kf[e + 1], acc_s);
              acc_s = fmaf(q4.z, kf[e + 2], acc_s);
              acc_s = fmaf(q4.w, kf[e + 3], acc_s);
            }
            s[u][g] = acc_s;
          }
        }
      }
      // the row's score: a butterfly over the LPR lanes that share it
#pragma unroll
      for (int off = 1; off < LPR; off <<= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GT; ++g)
            s[u][g] += __shfl_xor_sync(FULL_MASK, s[u][g], off);
      float vf[U][VPL * E];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          widen(vr[u][j], vf[u] + j * E, static_cast<const T*>(nullptr));
      // this lane's online softmax over its U rows, for every head
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u]) mx = fmaxf(mx, s[u][g] * scale_log2);
        const float corr = exp2f(m[g] - mx);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < VPL * E; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = ok[u] ? exp2f(s[u][g] * scale_log2 - mx) : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VPL * E; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
        }
        m[g] = mx;
      }
    }
  }

  // merge the warp's row slots (lanes LPR apart hold the same dimensions)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float a2[VPL * E];
#pragma unroll
      for (int e = 0; e < VPL * E; ++e) a2[e] = __shfl_xor_sync(FULL_MASK, acc[g][e], off);
      const float m2 = __shfl_xor_sync(FULL_MASK, m[g], off);
      const float l2 = __shfl_xor_sync(FULL_MASK, l[g], off);
      combine<VPL * E>(m[g], l[g], acc[g], m2, l2, a2);
    }
  }
  // then the block's warps, through shared memory (after every warp's last
  // read of the query heads, where the partials take their buffer)
  if constexpr (ALIAS) __syncthreads();
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        m_s[warp * GT + g] = m[g];
        l_s[warp * GT + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        if (vok[j])
#pragma unroll
          for (int e = 0; e < E; ++e)
            a_s[(warp * GT + g) * D + c0 + j * LPR * E + e] = acc[g][j * E + e];
    }
  }
  __syncthreads();
  const long long n_part = (long long)splits * KVH * gridDim.z * G;
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w * GT + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = exp2f(m_s[w * GT + g] - mx);
      den += l_s[w * GT + g] * e;
      num += a_s[(w * GT + g) * D + d] * e;
    }
    if (splits == 1) {
      store(o + b * ob + (long long)(kvh * G + g) * oh + d, num / fmaxf(den, 1e-30f));
      if (lse != nullptr && d == 0)
        lse[(long long)(b * KVH + kvh) * G + g] = state_lse(mx, den);
    } else {
      // partial p = ((b * KVH + kvh) * splits + split) * G + g:
      // acc at part[p * D + d], (m, l) at part[n_part * D + 2 p]
      const long long p = ((long long)(b * KVH + kvh) * splits + split) * G + g;
      part[p * D + d] = num;
      if (d == 0) {
        part[n_part * D + 2 * p] = mx;
        part[n_part * D + 2 * p + 1] = den;
      }
    }
  }
  if (splits == 1) return;

  // The last block of (b, kvh) to write its partial merges them all:
  // out = sum_s acc_s e_s / sum_s l_s e_s, e_s = 2^(m_s - max m), folded in
  // online-softmax order, MERGE_BATCH partials of two outputs a thread in
  // flight (read through L2: other SMs wrote them). It resets the counter,
  // so the next call finds it 0.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + b * KVH + kvh, 1) == splits - 1;
    if (last) counters[b * KVH + kvh] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* ml = part + n_part * D;
  const long long p0 = (long long)(b * KVH + kvh) * splits * G;
  for (int idx0 = threadIdx.x; idx0 < G * D; idx0 += 2 * THREADS) {
    float mo[2] = {NEG_INF, NEG_INF}, lo[2] = {0.f, 0.f}, ao[2] = {0.f, 0.f};
    for (int s0 = 0; s0 < splits; s0 += MERGE_BATCH) {
      float m2[2][MERGE_BATCH], l2[2][MERGE_BATCH], a2[2][MERGE_BATCH];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = idx0 + j * THREADS;
        const int g = idx / D, d = idx % D;
#pragma unroll
        for (int i = 0; i < MERGE_BATCH; ++i) {
          const bool ok = idx < G * D && s0 + i < splits;
          const long long p = p0 + (long long)(s0 + i) * G + g;
          m2[j][i] = ok ? __ldcg(ml + 2 * p) : NEG_INF;
          l2[j][i] = ok ? __ldcg(ml + 2 * p + 1) : 0.f;
          a2[j][i] = ok ? __ldcg(part + p * D + d) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < MERGE_BATCH; ++i)
          combine<1>(mo[j], lo[j], &ao[j], m2[j][i], l2[j][i], &a2[j][i]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = idx0 + j * THREADS;
      if (idx < G * D) {
        store(o + b * ob + (long long)(kvh * G + idx / D) * oh + idx % D,
              ao[j] / fmaxf(lo[j], 1e-30f));
        if (lse != nullptr && idx % D == 0)
          lse[(long long)(b * KVH + kvh) * G + idx / D] = state_lse(mo[j], lo[j]);
      }
    }
  }
}

template <typename T, int D, int GT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, float* lse, float* part,
                   int* counters, int B, int KVH, int G, int S, int chunk,
                   int splits, const long long* st, double sc,
                   cudaStream_t stream) {
  const float scale_log2 = sc > 0 ? static_cast<float>(LOG2E * sc)
      : static_cast<float>(LOG2E / std::sqrt(static_cast<double>(D)));
  flash_decode_kernel<T, D, GT><<<dim3(splits, KVH, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), lse, part, G, S,
      chunk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], counters, scale_log2);
  return cudaGetLastError();
}

// GT: the group size rounded up to a power of two (padding heads are masked)
template <typename T, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const int* len, void* o, float* lse, float* part,
                       int* cnt, int B, int KVH, int S, int chunk, int splits,
                       const long long* st, double sc, cudaStream_t s) {
  if (G <= 1) return launch<T, D, 1>(q, k, v, len, o, lse, part, cnt, B, KVH, G, S, chunk, splits, st, sc, s);
  if (G <= 2) return launch<T, D, 2>(q, k, v, len, o, lse, part, cnt, B, KVH, G, S, chunk, splits, st, sc, s);
  if (G <= 4) return launch<T, D, 4>(q, k, v, len, o, lse, part, cnt, B, KVH, G, S, chunk, splits, st, sc, s);
  if (G <= 8) return launch<T, D, 8>(q, k, v, len, o, lse, part, cnt, B, KVH, G, S, chunk, splits, st, sc, s);
  if (G <= 16) return launch<T, D, 16>(q, k, v, len, o, lse, part, cnt, B, KVH, G, S, chunk, splits, st, sc, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k,
                       const void* v, const int* len, void* o, float* lse,
                       float* part, int* cnt, int B, int KVH, int S, int chunk,
                       int splits,
                       const long long* st, double sc, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, len, o, lse, part, cnt, B, KVH, S, chunk, splits, st, sc, s);
    case 32: return dispatch_g<T, 32>(G, q, k, v, len, o, lse, part, cnt, B, KVH, S, chunk, splits, st, sc, s);
    case 64: return dispatch_g<T, 64>(G, q, k, v, len, o, lse, part, cnt, B, KVH, S, chunk, splits, st, sc, s);
    case 80: return dispatch_g<T, 80>(G, q, k, v, len, o, lse, part, cnt, B, KVH, S, chunk, splits, st, sc, s);
    case 128: return dispatch_g<T, 128>(G, q, k, v, len, o, lse, part, cnt, B, KVH, S, chunk, splits, st, sc, s);
    case 160: return dispatch_g<T, 160>(G, q, k, v, len, o, lse, part, cnt, B, KVH, S, chunk, splits, st, sc, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D], k/v [B,KVH,S,D], lengths [B] int32, o [B,H,D]; scores are
// scaled by `scale`, or by 1/sqrt(D) where it is not above 0. The cache axis is cut into `splits` chunks of `chunk`
// positions (splits * chunk >= S). With splits > 1, `part` is fp32 scratch of
// B * H * splits * (D + 2) floats and `counters` B * KVH int32 that are 0 on
// entry and 0 again on return (the kernel resets them, so one zeroed buffer
// serves every call on a stream); with one split both are unused. Strides (in
// elements): q (batch, head), k (batch, head, sequence), v (batch, head,
// sequence), o (batch, head): 10 values. `lse` is null, or fp32 [B, H]
// (contiguous) for each row's log-sum-exp. One launch; returns
// cudaGetLastError().
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* lse,
                                void* part,
                                void* counters, int dtype, int B, int H,
                                int KVH, int S, int D, int chunk, int splits,
                                const long long* strides, double scale,
                                void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || splits <= 0 || chunk <= 0 ||
      (long long)splits * chunk < S ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const int G = H / KVH;
  const int* len = static_cast<const int*>(lengths);
  float* p = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  int* cnt = static_cast<int*>(counters);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch_d<float>(D, G, q, k, v, len, o, ls, p, cnt, B, KVH, S, chunk, splits, strides, scale, st);
  if (dtype == DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, G, q, k, v, len, o, ls, p, cnt, B, KVH, S, chunk, splits, strides, scale, st);
  return cudaErrorInvalidValue;
}
