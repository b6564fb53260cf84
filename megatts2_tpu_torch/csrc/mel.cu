// Log-mel spectrogram from the raw signal, one pass on an NVIDIA Hopper card.
//
// Replaces the Pallas TPU kernel megatts2_tpu/ops/mel.py::mel_spectrogram_fused
// (kernel body _mel_kernel), and computes what the golden
// megatts2_tpu/ops/mel.py::mel_spectrogram computes: center=True reflect
// padding, periodic Hann window, 513-bin magnitude spectrum, slaney
// filterbank (513 x 80), log(max(., 1e-5)).
//
// What bounds it on the card: latency and memory, not arithmetic.  The TPU
// kernel takes the DFT as two dense 1024 x 513 matmuls on the MXU (~2.1
// MFLOP a frame).  Here a frame costs ~30 KFLOP: a 1024-point real FFT
// (one 512-point complex FFT plus a split pass) and the filterbank's 1001
// nonzeros.  Over the signal's 4 bytes a sample that is ~30 FLOP a byte,
// under the card's fp32 ridge, so the floor is the signal read; what a
// straightforward kernel loses is latency: dependent shared-memory stages,
// scattered loads, and blocks too few to fill 132 SMs at a prompt's ~250
// frames.
//
// What the design does about it:
//  * A block takes FRAMES = 2 frames of one batch row, 64 threads a frame:
//    a ~4 s prompt's 251 frames make 126 blocks, the batch's 8 x 512 make
//    2048.  The block loads its frames' signal span (HOP samples a frame
//    plus 768) once into shared memory with 16-byte loads; reflect
//    indexing (and scalar loads) only at the signal's ends, no framed copy
//    in device memory.
//  * The 512-point complex FFT (even samples + i odd samples, windowed as
//    they are read) runs in registers, 8 points a thread, as three radix-8
//    passes with two exchanges through shared memory whose strides avoid
//    bank conflicts.  The index plan is stated once in Python
//    (ops/mel.py::fft_plan) and mirrored here; the twiddles come from the
//    table built there in float64 (no sincos in the kernel).
//  * The split to 513 bins and |X| read Z from shared memory; the
//    filterbank walks each mel's nonzeros only: thread p sums mel p and
//    mel 79 - p (16-42 weights, where single mels run 4-37), reading a
//    weight table laid out so a warp's reads at each step are consecutive.
//  * fp32 throughout, no tensor cores: log(clamp) amplifies error near 1e-5,
//    and TF32 or bf16 would lose the digits the tolerance needs.
//
// The backward (mt_mel_backward) has no Pallas counterpart: the JAX package
// differentiates the jnp golden with XLA's autodiff.  Given g_mel (B, T,
// n_mels) it returns g_sig (B, n) in two launches:
//  * mel_bwd_frames_kernel, the same blocks as the forward: it recomputes
//    the frame's spectrum X in registers (the forward's FFT again, so the
//    forward saves nothing), the mels, g_lin = g_mel / mel where mel >=
//    1e-5 (torch.clamp's convention: a tie passes the whole gradient),
//    g_|X| through the filterbank by bin (ops/mel.py::bin_tasks: at most two
//    mels a bin), G = g_|X| X / |X| (0 where |X| = 0), then the adjoint of
//    the one-sided rfft, sum_k<=512 Re(G[k] e^{+2 pi i k n / 1024}): the
//    even/odd split undone with conjugate twiddles into Zc (512 complex),
//    and the forward's 512-point FFT run on conj(Zc); times the window, into
//    a (B, T, 1024) scratch.
//  * mel_bwd_gather_kernel, a thread a sample: it sums the <= 4 frames that
//    cover its padded position and those of its reflected partners
//    (ops/mel.py::fold_sources, frames_covering).  A gather, no atomics:
//    the same bits on every run.
// What bounds it: the same as the forward, twice the FFT work and the
// scratch's round trip (8 KB a frame), all far under a microsecond at the
// trainer's (8, 16384); at that size the launches and the host decide.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NFFT = 1024;
constexpr int HOP = 256;
constexpr int NC = NFFT / 2;                      // complex FFT length
constexpr int TPF = 64;                           // threads a frame, 8 points each
constexpr int FRAMES = 2;                         // frames a block
constexpr int THREADS = TPF * FRAMES;
constexpr int SPAN = (FRAMES - 1) * HOP + NFFT;   // signal samples a block reads
constexpr int ROW = 72;                           // exchange stride between first digits
constexpr int XA = 640;                           // exchange A a frame: pass 1, then Z
constexpr int XB = 8 * ROW;                       // exchange B a frame: pass 2, then |X|
constexpr int TW1 = 0, TW2 = 8 * TPF, TWS = TW2 + 64;  // parts of the twiddle table
constexpr float LOG_CLIP = 1e-5f;
constexpr float SQRT_HALF = 0.70710678118654752f;

static_assert(SPAN % 4 == 0, "the span loads in float4");
static_assert(XB * 2 >= NC + 1, "the magnitudes fit exchange B");

// Index into the center=True reflect-padded signal (edge sample not
// repeated, as jnp.pad / torch reflect).  The wrapper guarantees n > NFFT/2.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// Slot of Z[k] in exchange A after pass 3 (ops/mel.py::zpos).
__device__ __forceinline__ int zpos(int k) { return k + 2 * (k >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_negi(float2 a) { return make_float2(a.y, -a.x); }  // a * (-i)

// In place: a[k] <- sum_n a[n] exp(-2 pi i n k / 8).  Radix-2 decimation in
// frequency, written out: a 4-point DFT of u = a[n] + a[n+4] gives the even
// outputs, one of v = (a[n] - a[n+4]) W_8^n the odd ones.
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  const float2 u0 = cadd(a[0], a[4]), u1 = cadd(a[1], a[5]), u2 = cadd(a[2], a[6]),
               u3 = cadd(a[3], a[7]);
  float2 v0 = csub(a[0], a[4]), v1 = csub(a[1], a[5]), v2 = csub(a[2], a[6]), v3 = csub(a[3], a[7]);
  v1 = make_float2(SQRT_HALF * (v1.x + v1.y), SQRT_HALF * (v1.y - v1.x));   // W_8 = (1 - i)/sqrt 2
  v2 = mul_negi(v2);                                                       // W_8^2 = -i
  v3 = make_float2(SQRT_HALF * (v3.y - v3.x), -SQRT_HALF * (v3.x + v3.y));  // W_8^3 = -(1 + i)/sqrt 2
  const float2 su = cadd(u0, u2), tu = cadd(u1, u3), du = csub(u0, u2), eu = mul_negi(csub(u1, u3));
  const float2 sv = cadd(v0, v2), tv = cadd(v1, v3), dv = csub(v0, v2), ev = mul_negi(csub(v1, v3));
  a[0] = cadd(su, tu);
  a[4] = csub(su, tu);
  a[2] = cadd(du, eu);
  a[6] = csub(du, eu);
  a[1] = cadd(sv, tv);
  a[5] = csub(sv, tv);
  a[3] = cadd(dv, ev);
  a[7] = csub(dv, ev);
}

// The block's signal span into shared memory: frame t0 + f reads span[f HOP,
// f HOP + NFFT), signal samples from (t0 + f) HOP - NC; past the last frame
// the span stays 0.
__device__ __forceinline__ void load_span(const float* __restrict__ s, float* span, int t0, int T,
                                          int n) {
  const int len = (min(FRAMES, T - t0) - 1) * HOP + NFFT;
  const int s0 = t0 * HOP - NC;  // a multiple of 4, like every i below
  const bool vec = (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  for (int i = 4 * threadIdx.x; i < SPAN; i += 4 * THREADS) {
    const int j = s0 + i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < len) {
      if (vec && j >= 0 && j + 3 < n)
        v = *reinterpret_cast<const float4*>(s + j);
      else
        v = make_float4(s[reflect(j, n)], s[reflect(j + 1, n)], s[reflect(j + 2, n)],
                        s[reflect(j + 3, n)]);
    }
    *reinterpret_cast<float4*>(span + i) = v;
  }
}

// Pass 1's input: z[t + 64 r] = x[m] + i x[m + 1], m = 2 (t + 64 r), windowed.
__device__ __forceinline__ void load_frame(const float* fs, const float2* __restrict__ window2,
                                           int t, float2 (&a)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float2 x = *reinterpret_cast<const float2*>(fs + 2 * (t + 64 * r));
    const float2 w = window2[t + 64 * r];
    a[r] = make_float2(x.x * w.x, x.y * w.y);
  }
}

// The 512-point complex FFT of a frame, thread t holding a[r] = z[t + 64 r]:
// Z[k] ends in xa at zpos(k).  Every thread of the block calls it (it
// synchronises twice); the caller synchronises before reading xa.
__device__ __forceinline__ void fft512(float2 (&a)[8], float2* xa, float2* xb,
                                       const float2* __restrict__ tw, int t) {
  dft8(a);
#pragma unroll
  for (int r = 0; r < 8; ++r) xa[r * ROW + t] = cmul(a[r], tw[TW1 + r * TPF + t]);
  __syncthreads();

  // pass 2: thread (k1, m2) = (t >> 3, t & 7)
  {
    const int k1 = t >> 3, m2 = t & 7;
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = xa[k1 * ROW + m2 + 8 * r];
    dft8(a);
#pragma unroll
    for (int r = 0; r < 8; ++r) xb[k1 * ROW + 9 * r + m2] = cmul(a[r], tw[TW2 + r * 8 + m2]);
  }
  __syncthreads();

  // pass 3: thread (k1, j1) = (t >> 3, t & 7) ends with Z[k1 + 8 j1 + 64 r]
  {
    const int k1 = t >> 3, j1 = t & 7;
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = xb[k1 * ROW + 9 * j1 + r];
    dft8(a);
#pragma unroll
    for (int r = 0; r < 8; ++r) xa[zpos(k1 + 8 * j1 + 64 * r)] = a[r];
  }
}

// The split, bin k < NC: X[k] = E[k] + W^k O[k], with E, O the spectra of
// the even and odd samples recovered from Z[k] and conj(Z[NC - k]);
// X[NC] = Re Z[0] - Im Z[0] is real and read by the caller.
__device__ __forceinline__ float2 split_bin(const float2* xa, const float2* __restrict__ tw, int k) {
  const float2 zk = xa[zpos(k)], zm = xa[zpos((NC - k) & (NC - 1))];
  const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  return cadd(e, cmul(tw[TWS + k], o));
}

// Task t of the filterbank: (mel t, mel 2 n_tasks - 1 - t), a narrow low
// filter with a wide high one, over their nonzero bins.
__device__ __forceinline__ float2 filterbank_pair(const float* mags, const int4* __restrict__ tasks,
                                                  const float* __restrict__ weights, int t,
                                                  int n_tasks) {
  const int4 task = tasks[t];  // (first bin, count) of each of the two mels
  float acc_a = 0.f, acc_b = 0.f;
  for (int i = 0; i < task.y; ++i) acc_a = fmaf(mags[task.x + i], weights[i * n_tasks + t], acc_a);
  for (int i = 0; i < task.w; ++i)
    acc_b = fmaf(mags[task.z + i], weights[(task.y + i) * n_tasks + t], acc_b);
  return make_float2(acc_a, acc_b);
}

__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ sig, const float2* __restrict__ window2,
           const float2* __restrict__ tw, const int4* __restrict__ tasks,
           const float* __restrict__ weights, float* __restrict__ out, int n, int T,
           int n_tasks) {
  __shared__ __align__(16) float span[SPAN];
  __shared__ float2 xa[FRAMES][XA];
  __shared__ float2 xb[FRAMES][XB];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FRAMES;
  const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
  load_span(sig + static_cast<size_t>(b) * n, span, t0, T, n);
  __syncthreads();

  float2 a[8];
  load_frame(span + f * HOP, window2, t, a);
  fft512(a, xa[f], xb[f], tw, t);
  __syncthreads();

  float* mags = reinterpret_cast<float*>(xb[f]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = t + 64 * i;
    const float2 x = split_bin(xa[f], tw, k);
    mags[k] = sqrtf(x.x * x.x + x.y * x.y);
  }
  if (t == 0) mags[NC] = fabsf(xa[f][0].x - xa[f][0].y);
  __syncthreads();

  const int frame = t0 + f;
  if (t < n_tasks && frame < T) {
    const float2 mel = filterbank_pair(mags, tasks, weights, t, n_tasks);
    float* o = out + (static_cast<size_t>(b) * T + frame) * (2 * n_tasks);
    o[t] = logf(fmaxf(mel.x, LOG_CLIP));
    o[2 * n_tasks - 1 - t] = logf(fmaxf(mel.y, LOG_CLIP));
  }
}

// Kernel A's backward, first launch: each frame's gradient, (B, T, NFFT).
__global__ void __launch_bounds__(THREADS)
mel_bwd_frames_kernel(const float* __restrict__ sig, const float* __restrict__ g_mel,
                      const float2* __restrict__ window2, const float2* __restrict__ tw,
                      const int4* __restrict__ tasks, const float* __restrict__ weights,
                      const int2* __restrict__ bin_mels, const float2* __restrict__ bin_weights,
                      float* __restrict__ g_frames, int n, int T, int n_tasks) {
  __shared__ __align__(16) float span[SPAN];
  __shared__ float2 xa[FRAMES][XA];
  __shared__ float2 xb[FRAMES][XB];
  __shared__ float g_lin[FRAMES][2 * TPF];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FRAMES;
  const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
  const int frame = t0 + f;
  load_span(sig + static_cast<size_t>(b) * n, span, t0, T, n);
  __syncthreads();

  // the forward again: X[t + 64 i] kept in registers, |X| to exchange B
  float2 a[8];
  load_frame(span + f * HOP, window2, t, a);
  fft512(a, xa[f], xb[f], tw, t);
  __syncthreads();
  float2 x[8];
  float* mags = reinterpret_cast<float*>(xb[f]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x[i] = split_bin(xa[f], tw, t + 64 * i);
    mags[t + 64 * i] = sqrtf(x[i].x * x[i].x + x[i].y * x[i].y);
  }
  const float x_nyq = xa[f][0].x - xa[f][0].y;  // X[NC], real; thread 0's
  if (t == 0) mags[NC] = fabsf(x_nyq);
  __syncthreads();

  // g_lin = g_mel / mel where mel >= LOG_CLIP (torch.clamp: a tie passes), else 0
  if (t < n_tasks) {
    float2 g = make_float2(0.f, 0.f);
    if (frame < T) {
      const float2 mel = filterbank_pair(mags, tasks, weights, t, n_tasks);
      const float* gm = g_mel + (static_cast<size_t>(b) * T + frame) * (2 * n_tasks);
      g = make_float2(mel.x >= LOG_CLIP ? gm[t] / mel.x : 0.f,
                      mel.y >= LOG_CLIP ? gm[2 * n_tasks - 1 - t] / mel.y : 0.f);
    }
    g_lin[f][t] = g.x;
    g_lin[f][2 * n_tasks - 1 - t] = g.y;
  }
  __syncthreads();

  // G[k] = g_|X|[k] X[k] / |X[k]| into exchange A (Z is no longer needed)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = t + 64 * i;
    const int2 m = bin_mels[k];
    const float2 w = bin_weights[k];
    const float g_mag = fmaf(w.x, g_lin[f][m.x], w.y * g_lin[f][m.y]);
    const float mag = mags[k];
    const float s = mag > 0.f ? g_mag / mag : 0.f;
    xa[f][k] = make_float2(s * x[i].x, s * x[i].y);
  }
  if (t == 0) {
    const int2 m = bin_mels[NC];
    const float2 w = bin_weights[NC];
    const float g_mag = fmaf(w.x, g_lin[f][m.x], w.y * g_lin[f][m.y]);
    xa[f][NC] = make_float2(x_nyq > 0.f ? g_mag : (x_nyq < 0.f ? -g_mag : 0.f), 0.f);
  }
  __syncthreads();

  // the adjoint of the one-sided rfft: Zc[k] = P + i W^-k Q with P, Q =
  // (G[k] +- conj(G[NC - k])) / 2 for 0 < k < NC; Zc[0] from the real G[0]
  // and G[NC]; then conj(FFT(conj(Zc))) = y[2m] + i y[2m + 1]
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = t + 64 * r;
    float2 zc;
    if (k == 0) {
      const float g0 = xa[f][0].x, gn = xa[f][NC].x;
      zc = make_float2(g0 + gn, g0 - gn);
    } else {
      const float2 gk = xa[f][k], gm = xa[f][NC - k];
      const float2 p = make_float2(0.5f * (gk.x + gm.x), 0.5f * (gk.y - gm.y));
      const float2 q = make_float2(0.5f * (gk.x - gm.x), 0.5f * (gk.y + gm.y));
      const float2 wq = cmul(make_float2(tw[TWS + k].x, -tw[TWS + k].y), q);
      zc = make_float2(p.x - wq.y, p.y + wq.x);
    }
    a[r] = make_float2(zc.x, -zc.y);
  }
  __syncthreads();
  fft512(a, xa[f], xb[f], tw, t);
  __syncthreads();

  if (frame < T) {
    float* o = g_frames + (static_cast<size_t>(b) * T + frame) * NFFT;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = t + 64 * r;
      const float2 y = xa[f][zpos(m)];
      const float2 w = window2[m];
      *reinterpret_cast<float2*>(o + 2 * m) = make_float2(w.x * y.x, -w.y * y.y);
    }
  }
}

// Sum of the frames' gradients at padded position q: frames t in [t_lo, t_hi]
// cover it (ops/mel.py::frames_covering), frame t at offset q - t HOP.
__device__ __forceinline__ float padded_grad(const float* gf, int q, int T) {
  const int t_lo = q >= NFFT ? (q - NFFT) / HOP + 1 : 0;
  const int t_hi = min(q / HOP, T - 1);
  float acc = 0.f;
  for (int t = t_lo; t <= t_hi; ++t) acc += gf[static_cast<size_t>(t) * NFFT + q - t * HOP];
  return acc;
}

// Kernel A's backward, second launch: sample i gathers its padded position
// i + NC and its reflected partners (ops/mel.py::fold_sources).
__global__ void mel_bwd_gather_kernel(const float* __restrict__ g_frames, float* __restrict__ g_sig,
                                      int n, int T) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* gf = g_frames + static_cast<size_t>(b) * T * NFFT;
  float acc = padded_grad(gf, i + NC, T);
  if (i >= 1 && i <= NC) acc += padded_grad(gf, NC - i, T);
  if (i <= n - 2 && i >= n - 1 - NC) acc += padded_grad(gf, 2 * (n - 1) - i + NC, T);
  g_sig[static_cast<size_t>(b) * n + i] = acc;
}

}  // namespace

// sig (B, n) fp32, window (1024,) fp32, tw (1088,) complex fp32 (the table
// of ops/mel.py::kernel_twiddles), tasks (n_mels / 2,) int4 and weights
// (depth, n_mels / 2) fp32 (ops/mel.py::filterbank_tasks), out (B, T,
// n_mels) fp32 with T = 1 + n / 256; all contiguous on the device of
// `stream`; n > 512, n_mels even and at most 128.
extern "C" int mt_mel_forward(const float* sig, const float* window, const float* tw,
                              const int* tasks, const float* weights, float* out, int B, int n,
                              int T, int n_mels, void* stream) {
  if (n <= NC || n_mels % 2 || n_mels > 2 * TPF) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + FRAMES - 1) / FRAMES, B);
  mel_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      sig, reinterpret_cast<const float2*>(window), reinterpret_cast<const float2*>(tw),
      reinterpret_cast<const int4*>(tasks), weights, out, n, T, n_mels / 2);
  return static_cast<int>(cudaGetLastError());
}

// sig (B, n) fp32 and g_mel (B, T, n_mels) fp32; the forward's tables, and
// bin_mels (NC + 1,) int2 and bin_weights (NC + 1,) float2
// (ops/mel.py::bin_tasks); g_frames (B, T, 1024) fp32 scratch; g_sig (B, n)
// fp32, the result.  All contiguous on the device of `stream`; T = 1 + n /
// 256, n > 512, n_mels even and at most 128.  Two launches on `stream`.
extern "C" int mt_mel_backward(const float* sig, const float* g_mel, const float* window,
                               const float* tw, const int* tasks, const float* weights,
                               const int* bin_mels, const float* bin_weights, float* g_frames,
                               float* g_sig, int B, int n, int T, int n_mels, void* stream) {
  if (n <= NC || n_mels % 2 || n_mels > 2 * TPF) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  mel_bwd_frames_kernel<<<dim3((T + FRAMES - 1) / FRAMES, B), THREADS, 0, st>>>(
      sig, g_mel, reinterpret_cast<const float2*>(window), reinterpret_cast<const float2*>(tw),
      reinterpret_cast<const int4*>(tasks), weights, reinterpret_cast<const int2*>(bin_mels),
      reinterpret_cast<const float2*>(bin_weights), g_frames, n, T, n_mels / 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int GATHER = 256;
  mel_bwd_gather_kernel<<<dim3((n + GATHER - 1) / GATHER, B), GATHER, 0, st>>>(g_frames, g_sig, n, T);
  return static_cast<int>(cudaGetLastError());
}
