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
// n_mels) it returns g_sig (B, n) in one launch of mel_bwd_kernel.
//
// What bounds it: not bytes (the signal and g_mel in, g_sig out: 1.2 MB at
// the vocoder trainer's (8, 16384), 0.36 us) nor operations (twice the
// forward's FFT work, ~32 MFLOP, 0.48 us) but latency: a block is a chain
// of ~12 stages separated by block-wide barriers (the FFT's own included),
// each 0.3-1.7 us on an H100 whatever its work, ~10 us in all; and the
// host's issue of the call.  What the design does about it:
//  * One launch and no scratch in device memory.  A block computes
//    BWD_FRAMES = 6 consecutive frames of one row, 64 threads a frame (384
//    threads): it recomputes each frame's spectrum X with the forward's
//    register FFT (the forward saves nothing), the mels, g_lin = g_mel / mel
//    where mel >= 1e-5 (torch.clamp's convention: a tie passes the whole
//    gradient), g_|X| through the filterbank by bin (ops/mel.py::bin_tasks:
//    at most two mels a bin), G = g_|X| X / |X| (0 where |X| = 0), then the
//    adjoint of the one-sided rfft, sum_k<=512 Re(G[k] e^{+2 pi i k n /
//    1024}): the even/odd split undone with conjugate twiddles into Zc, and
//    the forward's 512-point FFT run on conj(Zc).  Times the window, each
//    frame's 1024-sample gradient stays in shared memory (in its exchange
//    buffer B).
//  * Every table (window, twiddles, filterbank by task and by bin) is read
//    from shared memory: one array (ops/mel.py::bwd_table) copied in with
//    cp.async beside the span's load, so the stages wait on no device
//    memory (read in place, each stage's table reads cost a trip to L2).
//  * The overlap-add on chip.  Padded hop slot h (positions 256 h to 256 h
//    + 255) is the sum of frames h - 3 .. h.  A block owns a run of slots
//    (ops/mel.py::bwd_plan states the plan the kernel computes): the slots
//    of its own frames, and past the row's last frame the 3 slots its tail
//    reaches.  The 3 frames before its first slot reach into that slot and
//    the next two: their partial sums (768 floats, the carry) come from the
//    block before it, read through distributed shared memory in a
//    thread-block cluster of 4 blocks laid along the row (the cluster's
//    barrier before the read, and after it before any block leaves).  A
//    cluster's first block has no peer before it: it computes 3 frames
//    before its own (the halo) and owns 3 frames fewer, so every block
//    computes 6 frames and rows of any length work.  A launch with cluster
//    size 1 is the halo-only variant (slower: 21 blocks a row for 12).
//  * The reflected edges fold inside one block: the row's first block owns
//    slots 0-4 (samples 1..512 and padded positions 0..511), its last block
//    the last 5 (when the last block would own a single frame, the block
//    before it gives one up).  Each sample is written once, by the block
//    owning its padded position i + 512: frames summed in ascending order
//    (the carry first), then the reflected partners, as
//    ops/mel.py::fold_sources and frames_covering state.  No atomics: the
//    same bits on every run, and at every cluster size.
//  * The grid: (clusters x 4, B).  At (8, 16384) (T = 65) a row is 12
//    blocks in 3 clusters, 96 blocks on the 132 SMs; at (16, 16384) 192
//    blocks, 2 on 60 SMs.  Shared memory a block: 76,800 bytes (the span
//    9,216; exchange A 30,720; exchange B, then the frames' gradients,
//    27,648; g_lin 3,072; the carry out and in, 3,072 each) and the table
//    (28,224 bytes at 80 mels): 105,024 bytes, dynamic, after
//    cudaFuncSetAttribute; at 68 registers a thread 2 blocks fit an SM.
#include <cooperative_groups.h>
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

// The block's signal span into shared memory (NF frames, TPF threads each):
// frame t0 + f reads span[f HOP, f HOP + NFFT), signal samples from (t0 + f)
// HOP - NC; past the last frame the span stays 0.  t0 < T.
template <int NF = FRAMES>
__device__ __forceinline__ void load_span(const float* __restrict__ s, float* span, int t0, int T,
                                          int n) {
  const int len = (min(NF, T - t0) - 1) * HOP + NFFT;
  const int s0 = t0 * HOP - NC;  // a multiple of 4, like every i below
  const bool vec = (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  for (int i = 4 * threadIdx.x; i < (NF - 1) * HOP + NFFT; i += 4 * TPF * NF) {
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

// ---- kernel A's backward ----------------------------------------------------

constexpr int BWD_FRAMES = 6;                           // frames a block computes
constexpr int BWD_THREADS = TPF * BWD_FRAMES;
constexpr int HALO = 3;                                 // frames before a slot that reach into it
constexpr int CARRY = HALO * HOP;                       // partial sums handed to the next block
constexpr int MAX_CLUSTER = 8;                          // the portable cluster size
constexpr int GF = 2 * XB;                              // floats between two frames' gradients
// the backward's table (ops/mel.py::bwd_table), in floats: the window, the
// twiddles, the bin mels (int2) and weights, padded to 16 bytes, the
// filterbank tasks (int4), then their weights (depth x n_tasks)
constexpr int TB_TW = NFFT;
constexpr int TB_BIN_MELS = TB_TW + 2 * (TWS + NC);
constexpr int TB_BIN_WEIGHTS = TB_BIN_MELS + 2 * (NC + 1) + 2;
constexpr int TB_TASKS = TB_BIN_WEIGHTS + 2 * (NC + 1) + 2;
constexpr int MAX_TABLE = TB_TASKS + 4 * TPF + 64 * TPF;  // filters up to 64 bins a task
// dynamic shared memory, in floats: the span, exchanges A and B of each
// frame (B holds the frame's gradient at the end), g_lin, the carry out and
// in, then the table (its length at run time)
constexpr int SM_XA = (BWD_FRAMES - 1) * HOP + NFFT;
constexpr int SM_XB = SM_XA + BWD_FRAMES * 2 * XA;
constexpr int SM_GLIN = SM_XB + BWD_FRAMES * GF;
constexpr int SM_CARRY_OUT = SM_GLIN + BWD_FRAMES * 2 * TPF;
constexpr int SM_CARRY_IN = SM_CARRY_OUT + CARRY;
constexpr int SM_TABLE = SM_CARRY_IN + CARRY;

static_assert(SM_XA % 4 == 0 && SM_XB % 4 == 0 && SM_TABLE % 4 == 0 && TB_TASKS % 4 == 0,
              "the exchanges hold float2, the span, the table and its tasks 16-byte words");
static_assert(BWD_FRAMES >= 6, "the row's first block owns slots 0-4 even when it gives one up");
static_assert(CARRY % BWD_THREADS == 0, "each thread reads the same number of a peer's carry");
static_assert(SM_TABLE * 4 == 76800, "the shared memory the note at the top states");

// First slot (= first frame) that block j of a row owns (ops/mel.py::
// bwd_owned_start): BWD_FRAMES a block, HALO fewer at a cluster's first
// block after the row's first; never T - 1, so the last block owns 2 frames.
__device__ __forceinline__ int bwd_owned_start(int j, int T, int cluster) {
  const int o = j == 0 ? 0 : j * BWD_FRAMES - HALO * ((j - 1) / cluster);
  return o == T - 1 ? T - 2 : min(o, T);
}

// out[k HOP + o], k < HALO: what frames s - HALO .. s - 1 add to padded slot
// s + k at offset o, summed in ascending frame order; frame t's gradient at
// gf + (t - first) GF.
__device__ __forceinline__ void partial_slots(const float* gf, int first, int s, float* out) {
  for (int p = threadIdx.x; p < CARRY; p += BWD_THREADS) {
    const int h = s + p / HOP;
    float acc = 0.f;
#pragma unroll
    for (int d = HALO; d >= 1; --d) {  // frame h - d, at offset d HOP
      const int t = h - d;
      if (t >= 0 && t < s) acc += gf[(t - first) * GF + d * HOP + p % HOP];
    }
    out[p] = acc;
  }
}

// 16 bytes from device memory to shared memory, asynchronously (cp.async):
// the copies of a thread complete at copy_async_wait.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Stage clocks, for tools/mel_bwd_stages.py only, which builds this file
// with -DMEL_BWD_STAGES: thread 0 of each block writes the card's clock
// (%globaltimer, ns) when it has passed each stage of mel_bwd_kernel, into
// stage_clock[block][stage] (mt_mel_bwd_stage_buffer sets the buffer).
// Without the macro STAGE is nothing and the kernel is as shipped.
#ifdef MEL_BWD_STAGES
constexpr int STAGES = 14;
__device__ unsigned long long* stage_clock;
__device__ __forceinline__ void stage_stamp(int k) {
  if (threadIdx.x == 0 && stage_clock != nullptr) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now));
    stage_clock[(blockIdx.y * gridDim.x + blockIdx.x) * STAGES + k] = now;
  }
}
#define STAGE(k) stage_stamp(k)
#define STAGE_SYNC(k) (__syncthreads(), stage_stamp(k))
#else
#define STAGE(k)
#define STAGE_SYNC(k)
#endif

// The cluster's barrier in two halves (cluster.sync is both): arrive
// releases this thread's shared-memory writes, wait acquires the peers'.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

// One launch: each frame's gradient into shared memory, then the overlap-add
// and the reflected folds of the samples the block owns (the note at the top).
__global__ void __launch_bounds__(BWD_THREADS)
mel_bwd_kernel(const float* __restrict__ sig, const float* __restrict__ g_mel,
               const float* __restrict__ table, int table_len, float* __restrict__ g_sig, int n,
               int T, int n_tasks, int cluster) {
  extern __shared__ __align__(16) float smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();

  const int j = blockIdx.x, b = blockIdx.y;
  const int rank = j % cluster;  // the block's rank in its cluster
  const int own_lo = bwd_owned_start(j, T, cluster), own_hi = bwd_owned_start(j + 1, T, cluster);
  const bool real = own_lo < T;  // blocks past the row's end only join the cluster's barriers
  const bool halo = j > 0 && rank == 0;
  const int first = halo ? own_lo - HALO : own_lo;  // the block's first computed frame
  float* gf = smem + SM_XB;
  float* carry_out = smem + SM_CARRY_OUT;
  float* carry_in = smem + SM_CARRY_IN;
  STAGE(0);

  if (real) {
    const int f = threadIdx.x / TPF, t = threadIdx.x % TPF;
    const int frame = first + f;
    float2* xa = reinterpret_cast<float2*>(smem + SM_XA) + f * XA;
    float2* xb = reinterpret_cast<float2*>(smem + SM_XB) + f * XB;
    float* g_lin = smem + SM_GLIN + f * 2 * TPF;
    // every read of a table below is a shared-memory read: the table comes
    // in beside the span, one wait where each stage would wait on its own
    float* tab = smem + SM_TABLE;
    for (int i = 4 * threadIdx.x; i < table_len; i += 4 * BWD_THREADS) copy_async16(tab + i, table + i);
    const float2* window2 = reinterpret_cast<const float2*>(tab);
    const float2* tw = reinterpret_cast<const float2*>(tab + TB_TW);
    const int2* bin_mels = reinterpret_cast<const int2*>(tab + TB_BIN_MELS);
    const float2* bin_weights = reinterpret_cast<const float2*>(tab + TB_BIN_WEIGHTS);
    const int4* tasks = reinterpret_cast<const int4*>(tab + TB_TASKS);
    const float* weights = tab + TB_TASKS + 4 * n_tasks;
    // this thread's two mels' gradients, read now to overlap the same wait
    float2 gmel = make_float2(0.f, 0.f);
    if (t < n_tasks && frame < T) {
      const float* row = g_mel + (static_cast<size_t>(b) * T + frame) * (2 * n_tasks);
      gmel = make_float2(row[t], row[2 * n_tasks - 1 - t]);
    }
    load_span<BWD_FRAMES>(sig + static_cast<size_t>(b) * n, smem, first, T, n);
    copy_async_wait();
    __syncthreads();
    STAGE(1);

    // the forward again: X[t + 64 i] kept in registers, |X| to exchange B
    float2 a[8];
    load_frame(smem + f * HOP, window2, t, a);
    fft512(a, xa, xb, tw, t);
    __syncthreads();
    STAGE(2);
    float2 x[8];
    float* mags = reinterpret_cast<float*>(xb);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = split_bin(xa, tw, t + 64 * i);
      mags[t + 64 * i] = sqrtf(x[i].x * x[i].x + x[i].y * x[i].y);
    }
    const float x_nyq = xa[0].x - xa[0].y;  // X[NC], real; thread 0's
    if (t == 0) mags[NC] = fabsf(x_nyq);
    __syncthreads();
    STAGE(3);

    // g_lin = g_mel / mel where mel >= LOG_CLIP (torch.clamp: a tie passes), else 0
    if (t < n_tasks) {
      float2 g = make_float2(0.f, 0.f);
      if (frame < T) {
        const float2 mel = filterbank_pair(mags, tasks, weights, t, n_tasks);
        g = make_float2(mel.x >= LOG_CLIP ? gmel.x / mel.x : 0.f,
                        mel.y >= LOG_CLIP ? gmel.y / mel.y : 0.f);
      }
      g_lin[t] = g.x;
      g_lin[2 * n_tasks - 1 - t] = g.y;
    }
    __syncthreads();
    STAGE(4);

    // G[k] = g_|X|[k] X[k] / |X[k]| into exchange A (Z is no longer needed)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = t + 64 * i;
      const int2 m = bin_mels[k];
      const float2 w = bin_weights[k];
      const float g_mag = fmaf(w.x, g_lin[m.x], w.y * g_lin[m.y]);
      const float mag = mags[k];
      const float s = mag > 0.f ? g_mag / mag : 0.f;
      xa[k] = make_float2(s * x[i].x, s * x[i].y);
    }
    if (t == 0) {
      const int2 m = bin_mels[NC];
      const float2 w = bin_weights[NC];
      const float g_mag = fmaf(w.x, g_lin[m.x], w.y * g_lin[m.y]);
      xa[NC] = make_float2(x_nyq > 0.f ? g_mag : (x_nyq < 0.f ? -g_mag : 0.f), 0.f);
    }
    __syncthreads();
    STAGE(5);

    // the adjoint of the one-sided rfft: Zc[k] = P + i W^-k Q with P, Q =
    // (G[k] +- conj(G[NC - k])) / 2 for 0 < k < NC; Zc[0] from the real G[0]
    // and G[NC]; then conj(FFT(conj(Zc))) = y[2m] + i y[2m + 1]
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = t + 64 * r;
      float2 zc;
      if (k == 0) {
        const float g0 = xa[0].x, gn = xa[NC].x;
        zc = make_float2(g0 + gn, g0 - gn);
      } else {
        const float2 gk = xa[k], gm = xa[NC - k];
        const float2 p = make_float2(0.5f * (gk.x + gm.x), 0.5f * (gk.y - gm.y));
        const float2 q = make_float2(0.5f * (gk.x - gm.x), 0.5f * (gk.y + gm.y));
        const float2 wq = cmul(make_float2(tw[TWS + k].x, -tw[TWS + k].y), q);
        zc = make_float2(p.x - wq.y, p.y + wq.x);
      }
      a[r] = make_float2(zc.x, -zc.y);
    }
    __syncthreads();
    STAGE(6);
    fft512(a, xa, xb, tw, t);
    __syncthreads();
    STAGE(7);

    // times the window: the frame's gradient, samples 2m and 2m + 1, into exchange B
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = t + 64 * r;
      const float2 y = xa[zpos(m)];
      const float2 w = window2[m];
      xb[m] = make_float2(w.x * y.x, -w.y * y.y);
    }
    __syncthreads();
    STAGE(8);

    // the carry: for the next block, unless the row ends here; a cluster's
    // first block computes its own from its halo frames
    if (own_hi < T) partial_slots(gf, first, own_hi, carry_out);
    if (halo) partial_slots(gf, first, own_lo, carry_in);
    STAGE(9);
  }
  cluster_arrive();  // every block's carry is written ...
  cluster_wait();    // ... and visible to its peers
  STAGE(10);
  if (real && rank > 0) {
    const float* peer = cl.map_shared_rank(carry_out, rank - 1);
    float v[CARRY / BWD_THREADS];
#pragma unroll
    for (int k = 0; k < CARRY / BWD_THREADS; ++k) v[k] = peer[threadIdx.x + k * BWD_THREADS];
#pragma unroll
    for (int k = 0; k < CARRY / BWD_THREADS; ++k) carry_in[threadIdx.x + k * BWD_THREADS] = v[k];
  }
  cluster_arrive();  // this block reads no peer from here on
  __syncthreads();   // carry_in is complete
  STAGE(11);

  if (real) {
    // padded position q of an owned slot: the carry (frames before own_lo),
    // then the owned frames that cover q (ops/mel.py::frames_covering), ascending
    const bool carried = j > 0;
    auto padded = [&](int q) {
      const int h = q / HOP;
      float acc = carried && h < own_lo + HALO ? carry_in[(h - own_lo) * HOP + q % HOP] : 0.f;
#pragma unroll
      for (int d = HALO; d >= 0; --d) {  // frame h - d, at offset q - (h - d) HOP
        const int t = h - d;
        if (t >= own_lo && t < T) acc += gf[(t - first) * GF + q - t * HOP];
      }
      return acc;
    };
    // samples whose padded position i + NC lies in an owned slot; the last
    // block owns the 3 slots past the row's last frame
    const int slot_hi = own_hi < T ? own_hi : T + HALO;
    const int i_lo = max(0, (own_lo - 2) * HOP), i_hi = min(n, (slot_hi - 2) * HOP);
    float* out = g_sig + static_cast<size_t>(b) * n;
    for (int i = i_lo + threadIdx.x; i < i_hi; i += BWD_THREADS) {
      float acc = padded(i + NC);
      if (i >= 1 && i <= NC) acc += padded(NC - i);
      if (i <= n - 2 && i >= n - 1 - NC) acc += padded(2 * (n - 1) - i + NC);
      out[i] = acc;
    }
    STAGE_SYNC(12);
  }
  cluster_wait();  // no block leaves while a peer may still read its carry
  STAGE(13);
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

// sig (B, n) fp32 and g_mel (B, T, n_mels) fp32 with T = 1 + n / 256;
// table (table_len,) fp32, ops/mel.py::bwd_table for n_mels; g_sig (B, n)
// fp32, the result.  All contiguous on the current device, the device of
// `stream`; n > 512, n_mels even and at most 128; cluster in [1, 8] (1: the
// halo-only variant).  One launch on `stream`; a launch the card refuses
// returns its error.
extern "C" int mt_mel_backward(const float* sig, const float* g_mel, const float* table,
                               float* g_sig, int B, int n, int n_mels, int table_len, int cluster,
                               void* stream) {
  if (n <= NC || n_mels % 2 || n_mels > 2 * TPF || cluster < 1 || cluster > MAX_CLUSTER ||
      table_len % 4 || table_len < TB_TASKS + 2 * n_mels || table_len > MAX_TABLE)
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set[64];  // by device: the dynamic shared memory allowed, above 48 KB
  const int smem = (SM_TABLE + table_len) * static_cast<int>(sizeof(float));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_set[dev] < smem) {
    err = cudaFuncSetAttribute(mel_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = smem;
  }
  // clusters a row (ops/mel.py::bwd_clusters): the first owns cluster x
  // BWD_FRAMES frames, each later one HALO fewer
  const int T = 1 + n / HOP;
  const int per = cluster * BWD_FRAMES - HALO;
  const int clusters = T <= per + HALO ? 1 : (T - HALO + per - 1) / per;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster, B);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mel_bwd_kernel, sig, g_mel, table, table_len, g_sig, n, T,
                           n_mels / 2, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef MEL_BWD_STAGES
// tools/mel_bwd_stages.py: the (blocks x STAGES) int64 buffer on the current
// device that the stage clocks go to.
extern "C" int mt_mel_bwd_stage_buffer(void* buffer) {
  unsigned long long* p = static_cast<unsigned long long*>(buffer);
  return static_cast<int>(cudaMemcpyToSymbol(stage_clock, &p, sizeof(p)));
}
#endif
