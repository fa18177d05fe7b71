// mamba2_step: one decode step of a Mamba2 (SSD) layer, between the input
// projection's output and the output projection's input, in two launches.
//
// Not a port: the TPU reference computes Mamba2 outside any Pallas kernel
// (src/repro/models/mamba2.py::mamba2_decode), and so did this port, as about
// 39 small PyTorch ops a layer (casts, the conv window's concatenation, the
// depthwise conv, softplus and exp, the B/C heads' repeat, the state update,
// C . h, the skip, the gate, the RMSNorm) plus two copies of the state back
// into the cache. Each moves under 3 MB, so the step was bound by the
// latency of its launches, about 3 us each on the card inside a CUDA graph.
//
// For batch row b, head hh (of nh, head_dim hd, state size N, in the group
// g = hh / (nh / G) of B and C) and rows p of the head:
//
//   conv   u_c = silu(sum_k window[k, c] w[k, c] + u_new[c] w[K-1, c] + b_c)
//          for the x channels of the head and the B and C channels of g;
//          the window then shifts by one, the new input (widened to fp32)
//          at its end
//   dt     dt = softplus(dt_raw + dt_bias),  dA = exp(-exp(A_log) dt)
//   state  h[p, n] = dA h[p, n] + (x_p dt) B_n         (fp32, in place)
//   out    y_p = (sum_n C_n h[p, n] + D x_p) silu(z_p), rounded to the
//          compute dtype
//
// then over the row's d_in = nh hd outputs the gated RMSNorm, in fp32, its
// result in the compute dtype: y * rsqrt(mean(y^2) + eps) * out_norm. The
// rounding points are those of the plain path (kernels/ref.py::
// mamba2_step_ref): the conv and the SSM in fp32, y rounded before the norm,
// and each product of the state update rounded as the plain ops round it.
//
// Launch 1, the step: a block per (slice of P rows of a head, head, row),
// a warp a row: 4 x 80 x B blocks of 512 threads at the published
// Zamba2-2.7B (hd 64, P 16), so every SM has work at B = 1. Each lane first
// loads its N / 32 elements of h, then the block computes its group's B and
// C (2N channels, K taps each) into shared memory, its P x channels, and
// dt, all loads issued before any is used: the two reads from device memory
// overlap. Each warp then updates its row of h in place, reduces C . h by
// shuffles and writes its y; the block writes the sum of its P rounded y^2
// to a scratch slot of its own (no atomics: the norm's sum has one order
// every call). The x channels belong to one block, which shifts their
// window itself. The B and C channels are read by every head's block, so
// launch 1 never writes them.
//
// Launch 2, the norm: a block per 256 outputs of a row sums the row's
// partial sums of squares in a fixed order and normalises its outputs in
// place; the first block of a row also shifts the B and C channels' window
// (every head has read it by then: the launches run in stream order).
//
// What bounds it: bytes, about 2.9 MB a step at Zamba2-2.7B's shapes and
// B = 1 (the 1.31 MB fp32 state read and written, the window, the inputs
// and the conv weights), 0.85 us at 3.35 TB/s; in practice the latency of
// one read from device memory a launch, and the launches. Three blocks of
// 512 threads fit an SM (at most 40 registers a thread; ptxas spills 20-28
// bytes a thread to local memory for it), so the 320 blocks run in one
// wave: 8.9 us a call at B = 1 in bf16, where 64 registers and two waves
// took 11.6 us (PERF.md). Nothing is allocated: the wrapper
// (kernels/mamba2_step.py) allocates y and the partial sums with
// torch.empty and launches on the current stream, so a captured CUDA graph
// replays both launches.
//
// Limits: K <= MAX_K taps and N <= 32 x MAX_NPL states (the wrapper
// checks), so that a thread's window and row of h sit in registers.
//
// Layout: zx [B, 2 d_in + 2 G N + nh] (z, x, B, C, dt) with a row stride,
// the window [B, K-1, conv_ch] and h [B, nh, hd, N] fp32 contiguous,
// conv_w [K, conv_ch], conv_b and out_norm in the weights' dtype, dt_bias,
// A_log and D fp32, y [B, d_in] contiguous, part [B, nh x slices] fp32.
#include <cmath>

#include "common.cuh"

using namespace rt;

namespace {

constexpr int MAX_P = 16;            // rows of a head a block: a warp each
constexpr int MAX_K = 4;             // conv taps (Mamba2's d_conv)
constexpr int MAX_NPL = 4;           // elements of a row of h a lane: N <= 128
constexpr int NORM_THREADS = 256;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// torch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// x rounded to T, as the store of it to a T* would round it
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Conv channel c: the window's K-1 values, the new input u[c] and the K
// weights loaded (all issued before any is used), then the depthwise conv
// plus the bias, and SiLU. The window's values stay in `win_c` for a shift.
template <typename T, typename W>
__device__ __forceinline__ float conv_silu(const float* win, const T* u,
                                           const W* w, const W* bias, int c,
                                           int K, int conv_ch, float* win_c,
                                           float& u_c) {
  float wk[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    if (k < K - 1) win_c[k] = win[(long long)k * conv_ch + c];
    if (k < K) wk[k] = to_float(w[(long long)k * conv_ch + c]);
  }
  u_c = to_float(u[c]);
  const float b = to_float(bias[c]);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_K - 1; ++k)
    if (k < K - 1) acc = fmaf(win_c[k], wk[k], acc);
#pragma unroll
  for (int k = 0; k < MAX_K; ++k)
    if (k == K - 1) acc = fmaf(u_c, wk[k], acc);
  return silu(acc + b);
}

// Write channel c of the window shifted by one: its values 1..K-2, then
// the new input u_c.
__device__ __forceinline__ void shift(float* win, int c, int K, int conv_ch,
                                      const float* win_c, float u_c) {
#pragma unroll
  for (int k = 0; k < MAX_K - 1; ++k)
    if (k < K - 2) win[(long long)k * conv_ch + c] = win_c[k + 1];
  if (K > 1) win[(long long)(K - 2) * conv_ch + c] = u_c;
}

template <typename T, typename W>
__global__ void __launch_bounds__(MAX_P * 32, 3)
mamba2_step_kernel(const T* __restrict__ zx, long long zx_stride,
                   float* __restrict__ conv, float* __restrict__ h,
                   const W* __restrict__ conv_w, const W* __restrict__ conv_b,
                   const float* __restrict__ dt_bias,
                   const float* __restrict__ A_log,
                   const float* __restrict__ Dskip, T* __restrict__ y,
                   float* __restrict__ part, int nh, int hd, int N, int G,
                   int K, int P) {
  extern __shared__ float smem[];
  float* Bs = smem;            // [N]
  float* Cs = smem + N;        // [N]
  float* xs = smem + 2 * N;    // [P]
  __shared__ float sq[MAX_P];
  __shared__ float dt_s, dA_s;

  const int b = blockIdx.z, hh = blockIdx.y, p0 = blockIdx.x * P;
  const int np = min(P, hd - p0);
  const int d_in = nh * hd, gn = G * N, conv_ch = d_in + 2 * gn;
  const int g = hh / (nh / G);
  const T* zrow = zx + b * zx_stride;
  const T* u = zrow + d_in;                   // the conv's new input [conv_ch]
  float* win = conv + (long long)b * (K - 1) * conv_ch;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // this lane's elements of its warp's row of h, loaded first
  float* hp = h + (((long long)b * nh + hh) * hd + p0 + warp) * N;
  float hv[MAX_NPL];
#pragma unroll
  for (int j = 0; j < MAX_NPL; ++j)
    if (warp < np && lane + 32 * j < N) hv[j] = hp[lane + 32 * j];
  const float z = warp < np ? to_float(zrow[hh * hd + p0 + warp]) : 0.f;
  const float Dh = Dskip[hh];

  for (int i = tid; i < 2 * N + np; i += blockDim.x) {
    float win_c[MAX_K], u_c;
    if (i < 2 * N) {
      const int c = d_in + (i < N ? g * N + i : gn + g * N + i - N);
      smem[i] = conv_silu(win, u, conv_w, conv_b, c, K, conv_ch, win_c, u_c);
    } else {
      const int c = hh * hd + p0 + i - 2 * N;
      xs[i - 2 * N] = conv_silu(win, u, conv_w, conv_b, c, K, conv_ch, win_c,
                                u_c);
      shift(win, c, K, conv_ch, win_c, u_c);   // this block's channels alone
    }
  }
  if (tid == blockDim.x - 1) {
    const float dtv = softplus(to_float(zrow[2 * d_in + 2 * gn + hh]) + dt_bias[hh]);
    dt_s = dtv;
    dA_s = expf(dtv * -expf(A_log[hh]));
  }
  __syncthreads();

  if (warp < np) {
    const float x = xs[warp], xdt = __fmul_rn(x, dt_s), dA = dA_s;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_NPL; ++j) {
      const int n = lane + 32 * j;
      if (n < N) {
        const float hn = __fadd_rn(__fmul_rn(dA, hv[j]), __fmul_rn(xdt, Bs[n]));
        hp[n] = hn;
        acc = fmaf(Cs[n], hn, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float yv = __fadd_rn(acc, __fmul_rn(Dh, x));
      T* yo = y + (long long)b * d_in + hh * hd + p0 + warp;
      const float r = round_as(yv * silu(z), yo);   // what the norm reads
      store(yo, r);
      sq[warp] = r * r;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < np; ++r) s += sq[r];
    part[((long long)b * nh + hh) * gridDim.x + blockIdx.x] = s;
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(NORM_THREADS)
mamba2_norm_kernel(const T* __restrict__ zx, long long zx_stride,
                   float* __restrict__ conv, const W* __restrict__ out_norm,
                   T* __restrict__ y, const float* __restrict__ part,
                   int nparts, int d_in, int gn, int K, float eps) {
  __shared__ float red[NORM_THREADS / 32];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int i = blockIdx.x * NORM_THREADS + tid;
  T* yr = y + (long long)b * d_in;
  const float v = i < d_in ? to_float(yr[i]) : 0.f;
  const float wv = i < d_in ? to_float(out_norm[i]) : 0.f;
  const float* pr = part + (long long)b * nparts;
  float s = 0.f;
#pragma unroll 4
  for (int j = tid; j < nparts; j += NORM_THREADS) s += pr[j];
  if (blockIdx.x == 0) {
    const int conv_ch = d_in + 2 * gn;
    const T* u = zx + b * zx_stride + d_in;
    float* win = conv + (long long)b * (K - 1) * conv_ch;
    for (int j = tid; j < 2 * gn; j += NORM_THREADS) {
      const int c = d_in + j;
      float win_c[MAX_K];
#pragma unroll
      for (int k = 0; k < MAX_K - 1; ++k)
        if (k < K - 1) win_c[k] = win[(long long)k * conv_ch + c];
      shift(win, c, K, conv_ch, win_c, to_float(u[c]));
    }
  }
  s = warp_sum(s);
  if (tid % 32 == 0) red[tid / 32] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NORM_THREADS / 32; ++w) total += red[w];
  const float r = rsqrtf(total / d_in + eps);
  if (i < d_in) store(yr + i, (v * r) * wv);
}

template <typename T, typename W>
int launch(const void* zx, long long zx_stride, void* conv, void* h,
           const void* conv_w, const void* conv_b, const void* dt_bias,
           const void* A_log, const void* Dskip, const void* out_norm, void* y,
           void* part, int B, int nh, int hd, int N, int G, int K, int P,
           float eps, cudaStream_t st) {
  const int slices = (hd + P - 1) / P, d_in = nh * hd;
  const size_t shm = (2 * N + P) * sizeof(float);
  mamba2_step_kernel<T, W><<<dim3(slices, nh, B), 32 * P, shm, st>>>(
      static_cast<const T*>(zx), zx_stride, static_cast<float*>(conv),
      static_cast<float*>(h), static_cast<const W*>(conv_w),
      static_cast<const W*>(conv_b), static_cast<const float*>(dt_bias),
      static_cast<const float*>(A_log), static_cast<const float*>(Dskip),
      static_cast<T*>(y), static_cast<float*>(part), nh, hd, N, G, K, P);
  const dim3 norm_grid((d_in + NORM_THREADS - 1) / NORM_THREADS, B);
  mamba2_norm_kernel<T, W><<<norm_grid, NORM_THREADS, 0, st>>>(
      static_cast<const T*>(zx), zx_stride, static_cast<float*>(conv),
      static_cast<const W*>(out_norm), static_cast<T*>(y),
      static_cast<const float*>(part), nh * slices, d_in, G * N, K, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are device pointers; see the layout above. `dtype` is the
// compute dtype of zx and y, `wdtype` that of conv_w, conv_b and out_norm
// (DTYPE_F32 or DTYPE_BF16). P rows of a head a block (at most MAX_P);
// `part` holds B x nh x ceil(hd / P) floats. Launches twice on `stream`;
// returns cudaGetLastError().
extern "C" int mamba2_step_fwd(const void* zx, long long zx_stride, void* conv,
                               void* h, const void* conv_w, const void* conv_b,
                               const void* dt_bias, const void* A_log,
                               const void* Dskip, const void* out_norm,
                               void* y, void* part, int dtype, int wdtype,
                               int B, int nh, int hd, int N, int G, int K,
                               int P, double eps, void* stream) {
  if (B <= 0 || nh <= 0 || hd <= 0 || N <= 0 || N > 32 * MAX_NPL || G <= 0 ||
      nh % G || K < 1 || K > MAX_K || P <= 0 || P > MAX_P ||
      (2 * N + P) * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps);
  using bf = __nv_bfloat16;
#define MAMBA2_ARGS zx, zx_stride, conv, h, conv_w, conv_b, dt_bias, A_log, \
    Dskip, out_norm, y, part, B, nh, hd, N, G, K, P, e, st
  if (dtype == DTYPE_F32 && wdtype == DTYPE_F32) return launch<float, float>(MAMBA2_ARGS);
  if (dtype == DTYPE_F32 && wdtype == DTYPE_BF16) return launch<float, bf>(MAMBA2_ARGS);
  if (dtype == DTYPE_BF16 && wdtype == DTYPE_F32) return launch<bf, float>(MAMBA2_ARGS);
  if (dtype == DTYPE_BF16 && wdtype == DTYPE_BF16) return launch<bf, bf>(MAMBA2_ARGS);
#undef MAMBA2_ARGS
  return cudaErrorInvalidValue;
}
