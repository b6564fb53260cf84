// Masked attention forward with an online softmax, for an NVIDIA Hopper card.
//
// Replaces the Pallas TPU kernel megatts2_tpu/ops/attention_pallas.py::
// flash_attention (also the forward of flash_attention_vjp).  Same function:
// softmax(Q K^T * Dh^-0.5) V on (B, T, H, Dh) tensors, where logits at
// masked positions are REPLACED by the finite -1e9 (not -inf).  The mask is
// built in the kernel from a per-batch key length k_lens[b] and an optional
// causal flag.  Both products accumulate in fp32 and the output is written
// in the input dtype.  For the backward (kernel C) the kernel can also write
// each row's final max m and sum l, fp32 (B, H, Tq); with null pointers it
// writes neither.
//
// Two implementations, chosen by dtype and head dim (dispatch, not fallback):
//
// 1. bf16 at Dh 64, 96, 128 and 256 — the tensor-core path
//    (flash_fwd_tc_kernel), which the PLM's training, its prompt prefill,
//    the ADM with use_flash (Dh 96) and the MRTE's phone encoder (Dh 256)
//    take.  What bounds it:
//    operations.  At the PLM's (8, 1024, 16, 64) causal shape it does
//    4 Dh FLOP per kept (query, key) pair, ~25 GFLOP, ~0.025 ms at 989
//    TFLOP/s against ~0.02 ms for its 68 MB.  The design:
//    * One consumer warpgroup owns 64 query rows; S = Q K^T and O += P V run
//      as wgmma (m64n64k16, bf16 in, fp32 accumulators in registers).  Q and
//      K come from shared memory (K stored (key, d) is K-major for operand
//      B); P goes from the S accumulators to bf16 A fragments in registers;
//      V is read MN-major (transposed by the descriptor, not by a copy).
//    * A fifth warp loads: one lane issues TMA tile loads (128-byte
//      swizzle, zero fill past Tq / Tk) of Q once and of K/V in 64-key
//      tiles into a 2-stage ring, with full/empty mbarriers per stage.
//    * The online softmax runs on the accumulators: each row lives in four
//      lanes, so its max and sum take two shuffles.  The running sum l is
//      kept from the fp32 P, so kernel C recomputes the same P / l.  P V
//      takes P as bf16 A fragments (the JAX kernel and the SIMT path keep P
//      in fp32 there); P is split into bf16 hi + lo parts and P V runs
//      twice, so P keeps ~16 bits: with one bf16 P the output's error
//      against the plain fp32 version was 4x the SIMT path's at a checked
//      shape on an H100 (0.0156 against 0.0039 at (4, 1000, 2, 64) causal,
//      chip_smoke.py).  Tiles inside k_len, Tq and the diagonal skip the
//      mask arithmetic.
//    * Tiles whose P is exactly 0 are skipped as in (2); the ragged Tq / Tk
//      edges and the causal diagonal are masked inside the tile.  q tiles
//      are launched longest (causal) first.
//    * TMA needs a 16-byte-aligned base and 16-byte strides;
//      ops/attention.py copies a view that breaks this before the launch.
//    * At Dh 256 (the MRTE's (8, 64, 2, 256): ~34 MFLOP over 16 (batch,
//      head) pairs and one 64-row q tile each) the output's 256 columns are
//      split over two blocks (grid z).  Each computes the full S over Dh 256
//      (cheap at Tk <= 64) but loads and accumulates only its 128 columns of
//      V: O keeps the Dh 128 register plan (no spills under 2 blocks per SM
//      of registers), the MRTE shape gets 32 blocks, shared memory is Q 32
//      KB + 2 stages of K 32 + V 16 KB.  Only the first half writes m and l
//      (both compute the same); no atomics, deterministic.
//    * At Dh 96 (the ADM at tc_emb_dim 512: 8 heads of 96) 96 bf16 columns
//      are 192 bytes, no whole number of 128-byte swizzled boxes.  The
//      kernel runs the Dh 128 layout with tensor maps whose inner extent is
//      96: TMA fills columns 96-127 of the second box with zeros, which add
//      nothing to a product.  Q K^T takes only the 6 k16 steps of the real
//      columns; P V runs over both 64-column blocks (4/3 of the work of
//      64 + 32, with one descriptor layout where a 64 + 32 split with a
//      64-byte swizzle would need a second) and the epilogue stores 96
//      columns.  The wrapper passes the tensors unpadded.
//
// 2. fp32 (all head dims) and bf16 above Dh 256 — the SIMT path, the first
//    version (flash_fwd_kernel); other bf16 reaches it only when the caller
//    asks (simt), to compare the two.  Instances at Dh 64, 96, 128 and 256;
//    the wrapper zero-pads any other head dim to the next one, and above 256
//    to the next multiple of 256, and passes the true Dh's scale.  Above 256
//    one instance (chunks of 256 columns) loops over the chunks:
//    each block sums the scores over every chunk of Q and K, staged in
//    turn, and accumulates one chunk of the output (grid x), so shared
//    memory stays that of Dh 256 at any head dim; S is recomputed once a
//    chunk, a cost that only such head dims pay.  fp32 keeps full-fp32 products (TF32 wgmma would
//    not).  What bounds it: at short sequences launch latency and the
//    dependent chain of shared-memory reads (at the MRTE's (8, 64, 2, 256)
//    bf16, ~31 us of device time on an H100); at long sequences FMA issue.
//    The design:
//    * K/V stream through shared memory in 32-key tiles, converted to
//      fp32, with a running max and sum per row in fp32, P kept in fp32.
//    * A block takes BQ = 16 query rows of one (b, h): 4 warps of 4 rows.
//      For Q K^T lane j owns key j of the tile and runs the whole Dh dot,
//      reading K rows padded by one float, so the 32 lanes hit 32 banks.  For
//      P V lane l owns output dims l, l + 32, ...: P broadcasts by shuffle and
//      V rows are read unpadded, consecutive lanes on consecutive words.
//    * Tensors are read in place through their (b, t, h) strides; nothing is
//      transposed.  Ragged Tq and Tk edges are masked in the kernel.
//
// Both skip key tiles past k_len (and past the block's last row when
// causal).  That is exact only when the row keeps at least one key:
// exp(-1e9 - m) then underflows to exactly 0.  A row has no key only when
// k_len == 0; then all Tk keys take part and the row gives the mean of V, as
// the TPU kernel does, never NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 4;               // query rows per warp
constexpr int BQ = WARPS * ROWS;      // query rows per block
constexpr int BK = 32;                // keys per tile: one per lane
constexpr int THREADS = WARPS * 32;
constexpr float MASK_FILL = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  return (BQ * DH + BK * (DH + 1) + BK * DH) * sizeof(float);
}

// n rows of DH values from a strided tensor into shared memory, fp32, with
// row pitch `pitch`; rows at or past `limit` are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src, long long st,
                                          int row0, int n, int limit) {
  for (int idx = threadIdx.x; idx < n * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int t = row0 + r;
    dst[r * pitch + d] = t < limit ? to_f32(src[t * st + d]) : 0.f;
  }
}

// The same rows of two tensors in one pass (twice the loads in flight).
template <typename T, int DH>
__device__ __forceinline__ void load_rows2(float* d1, int p1, const T* s1, long long st1, float* d2,
                                           int p2, const T* s2, long long st2, int row0, int n,
                                           int limit) {
  for (int idx = threadIdx.x; idx < n * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int t = row0 + r;
    const bool in = t < limit;
    d1[r * p1 + d] = in ? to_f32(s1[t * st1 + d]) : 0.f;
    d2[r * p2 + d] = in ? to_f32(s2[t * st2 + d]) : 0.f;
  }
}

// The head dim is nc chunks of DH columns: NC = 1 (one chunk, fixed at
// compile time) for the instances up to 256; NC = 0 above, with nc = Dh / 256
// chunks given at run time.  Block x = (query tile) * nc + chunk writes
// output columns [chunk DH, (chunk + 1) DH).  With one chunk Q is loaded
// once; with more, the scores sum over the chunks in order (kernel C
// recomputes them in the same order), each chunk of Q and K staged in turn,
// and the block's own chunk of V is loaded beside its chunk of K.
template <typename T, int DH, int NC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ k_lens,
                 T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 int Tq, int Tk, int n_chunks, Strides sq, Strides sk, Strides sv, Strides so,
                 int causal, float scale) {
  const int nc = NC ? NC : n_chunks;
  constexpr int C = DH / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BQ][DH]
  float* k_s = q_s + BQ * DH;        // [BK][DH + 1]
  float* v_s = k_s + BK * (DH + 1);  // [BK][DH]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int chunk = blockIdx.x % nc;  // this block's chunk of output columns
  const int q0 = blockIdx.x / nc * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // mask: key j is kept iff j < klen (and j <= row when causal); a length
  // outside [0, Tk] masks the same keys as its clamp.
  const int klen = k_lens ? min(max(k_lens[b], 0), Tk) : Tk;
  int kend = Tk;  // keys this block visits
  if (klen > 0) {
    kend = klen;
    if (causal) kend = min(kend, min(q0 + BQ, Tq));
  }

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  if (nc == 1) load_rows<T, DH>(q_s, DH, qb, sq.t, q0, BQ, Tq);

  float m_i[ROWS], l_i[ROWS], acc[ROWS][C];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const float* kr = k_s + lane * (DH + 1);
  const float* qr = q_s + warp * ROWS * DH;
  for (int kt = 0; kt < kend; kt += BK) {
    // logits for key j = kt + lane against this warp's ROWS rows
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      __syncthreads();  // the previous chunk or tile is consumed (and q_s is written)
      if (nc > 1) load_rows<T, DH>(q_s, DH, qb + cc * DH, sq.t, q0, BQ, Tq);
      if (cc == chunk)
        load_rows2<T, DH>(k_s, DH + 1, kb + cc * DH, sk.t, v_s, DH, vb + cc * DH, sv.t, kt, BK, Tk);
      else
        load_rows<T, DH>(k_s, DH + 1, kb + cc * DH, sk.t, kt, BK, Tk);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) s[i] = fmaf(qr[i * DH + d], kd, s[i]);
      }
    }

    const int j = kt + lane;
    float p[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + warp * ROWS + i;
      const bool keep = j < klen && (!causal || j <= qi);
      float x = keep ? s[i] * scale : MASK_FILL;
      if (j >= kend) x = -INFINITY;  // outside the visited keys: no weight
      const float m_new = fmaxf(m_i[i], warp_max(x));  // lane 0 is visited: finite
      const float alpha = expf(m_i[i] - m_new);
      p[i] = expf(x - m_new);
      l_i[i] = l_i[i] * alpha + warp_sum(p[i]);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }

#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = v_s[jj * DH + c * 32 + lane];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pj = __shfl_sync(FULL, p[i], jj);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + warp * ROWS + i;
    if (qi >= Tq) continue;
    T* orow = o + b * so.b + qi * so.t + h * so.h + chunk * DH;
    if (m_out && lane == 0 && chunk == 0) {  // every chunk holds the same m, l
      const long long r = (static_cast<long long>(b) * gridDim.y + h) * Tq + qi;
      m_out[r] = m_i[i];
      l_out[r] = l_i[i];
    }
    const float inv = 1.f / l_i[i];
#pragma unroll
    for (int c = 0; c < C; ++c) orow[c * 32 + lane] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int DH, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const int* k_lens,
                   void* o, float* m_out, float* l_out, int B, int Tq, int Tk, int H, int nc,
                   Strides sq, Strides sk, Strides sv, Strides so, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = flash_fwd_kernel<T, DH, NC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Tq + BQ - 1) / BQ * nc, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      k_lens, static_cast<T*>(o), m_out, l_out, Tq, Tk, nc, sq, sk, sv, so, causal, scale);
  return cudaGetLastError();
}

// Above 256 the head dim runs in chunks of WIDE columns (the wrapper pads it
// to a multiple of WIDE).
constexpr int WIDE = 256;

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        const int* k_lens, void* o, float* m_out, float* l_out, int B,
                        int Tq, int Tk, int H, Strides sq, Strides sk, Strides sv,
                        Strides so, int causal, float scale, cudaStream_t stream) {
#define MT_LAUNCH(D, NC, nc) \
  launch<T, D, NC>(q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, nc, sq, sk, sv, so, causal, scale, \
                   stream)
  switch (Dh) {
    case 64:
      return MT_LAUNCH(64, 1, 1);
    case 96:
      return MT_LAUNCH(96, 1, 1);
    case 128:
      return MT_LAUNCH(128, 1, 1);
    case 256:
      return MT_LAUNCH(256, 1, 1);
    default:
      if (Dh > WIDE && Dh % WIDE == 0) return MT_LAUNCH(WIDE, 0, Dh / WIDE);
      return cudaErrorInvalidValue;
  }
#undef MT_LAUNCH
}


// ---- the tensor-core path: bf16, Dh 64, 96, 128 and 256 --------------------
namespace tc {

constexpr int BM = 64;        // query rows of a block: one consumer warpgroup
constexpr int BN = 64;        // keys per tile
constexpr int STAGES = 2;     // K/V ring
constexpr int THREADS = 160;  // warps 0-3 compute, warp 4 loads
static_assert(BM == BN, "Q and K/V tiles share one column-block size");

// Tiles are whole 64-column blocks: DP is the head dim rounded up to them
// (96 -> 128; TMA fills columns 96-127 with zeros).  A block accumulates DV
// of the DP output columns: all of them up to Dh 128; at Dh 256 one half,
// the other half in a second block (grid z), so O keeps the Dh 128 register
// plan and the MRTE's 16 (batch, head) pairs give 32 blocks.  Both blocks
// compute the full S = Q K^T over Dh 256.
template <int DH>
struct Layout {                                // byte offsets in shared memory
  static constexpr int DP = (DH + 63) / 64 * 64;
  static constexpr int DV = DP > 128 ? 128 : DP;
  static constexpr int TILE = BN * DP * 2;     // one 64-row bf16 tile of Q or K (BM == BN)
  static constexpr int VTILE = BN * DV * 2;    // the block's columns of a V tile
  static constexpr int Q = 0;
  static constexpr int RING = TILE;            // stage s: K at RING + s STAGE, V after it
  static constexpr int STAGE = TILE + VTILE;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int BYTES = BARS + 64 + 1024;  // barriers; slack to align to 1024
};

constexpr float LOG2E = 1.4426950408889634f;

// The online softmax on one 64 x 64 score tile in S accumulator layout (this
// thread: rows row and row + 8, columns 8 c + c0 and 8 c + c0 + 1): masks
// (MASKED), takes the new row max, rescales this thread's part of the row sum
// by alpha and adds the tile's fp32 P = exp(x - m), left in sc.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], int kt, int row, int c0, int klen,
                                             int kend, int causal, float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int r = (x >> 1) & 1;
    float v = sc[x] * scale;
    if (MASKED) {
      const int j = kt + 8 * (x / 4) + c0 + (x & 1);
      const bool keep = j < klen && (!causal || j <= row + 8 * r);
      v = keep ? v : MASK_FILL;
      if (j >= kend) v = -INFINITY;  // outside the visited keys: no weight
    }
    sc[x] = v;
    mx[r] = fmaxf(mx[r], v);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r]);  // key kt is visited: finite
    alpha[r] = exp2f((m_r[r] - m_new) * LOG2E);
    m_r[r] = m_new;
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int r = (x >> 1) & 1;
    sc[x] = exp2f((sc[x] - m_r[r]) * LOG2E);
    l_r[r] += sc[x];  // the unrounded P
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const int* __restrict__ k_lens,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Tq, int Tk, int H, Strides so, int causal,
                    float scale) {
  using L = Layout<DH>;
  constexpr int NB = L::DP / 64;   // 128-byte column blocks of a Q or K tile
  constexpr int NV = L::DV / 64;   // ... of this block's V columns and of O
  constexpr int KS = DH / 16;      // k16 steps of Q K^T: the zero columns past DH are left out
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal tiles first
  const int klen = k_lens ? min(max(k_lens[b], 0), Tk) : Tk;
  int kend = Tk;  // keys this block visits
  if (klen > 0) {
    kend = klen;
    if (causal) kend = min(kend, min(q0 + BM, Tq));
  }
  const int ntiles = (kend + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = L::DP > L::DV ? blockIdx.z * L::DV : 0;  // this block's first V and O column

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the loader
    if (lane == 0) {
      sm90::mbar_expect_tx(q_full, L::TILE);
      for (int nb = 0; nb < NB; ++nb)
        sm90::tma_load_4d(smem + L::Q + nb * BM * 128, &mq, nb * 64, h, q0, b, q_full);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) sm90::mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
        sm90::mbar_expect_tx(&full[s], L::STAGE);
        unsigned char* kt = smem + L::RING + s * L::STAGE;
        for (int nb = 0; nb < NB; ++nb)
          sm90::tma_load_4d(kt + nb * BN * 128, &mk, nb * 64, h, i * BN, b, &full[s]);
        for (int nb = 0; nb < NV; ++nb)
          sm90::tma_load_4d(kt + L::TILE + nb * BN * 128, &mv, col0 + nb * 64, h, i * BN, b,
                            &full[s]);
      }
    }
    return;
  }

  // the consumer warpgroup: thread (warp, lane) holds tile rows r0 and r0 + 8,
  // columns 8 c + c0 and 8 c + c0 + 1 of each 8-column chunk c
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t q_addr = sm90::smem_addr(smem + L::Q);
  float acc[NV][32];
#pragma unroll
  for (int nb = 0; nb < NV; ++nb)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[nb][x] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // l_r: this thread's part
  sm90::mbar_wait(q_full, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t k_addr = sm90::smem_addr(smem + L::RING + s * L::STAGE);
    const uint32_t v_addr = k_addr + L::TILE;

    float sc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks / 4) * (BN * 128) + (ks % 4) * 32;
      sm90::wgmma_ss_n64<0>(sc, sm90::desc_kmajor(q_addr + off), sm90::desc_kmajor(k_addr + off),
                            ks > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);

    const int kt = i * BN;
    float alpha[2];
    // a tile inside k_len, Tq and (when causal) below the diagonal needs no mask
    if (klen > 0 && kt + BN <= kend && q0 + BM <= Tq && (!causal || kt + BN - 1 <= q0))
      softmax_tile<false>(sc, m_r, l_r, alpha, kt, q0 + r0, c0, klen, kend, causal, scale);
    else
      softmax_tile<true>(sc, m_r, l_r, alpha, kt, q0 + r0, c0, klen, kend, causal, scale);
    // P as bf16 A fragments, one per 16 keys, split hi + lo: P V = P_hi V + P_lo V
    // carries P to ~16 bits, where one bf16 P would carry 8
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float a = sc[8 * kk + 2 * w], c = sc[8 * kk + 2 * w + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, c);
        hi[kk][w] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[kk][w] = sm90::pack_bf16(a - __low2float(h2), c - __high2float(h2));
      }
#pragma unroll
    for (int nb = 0; nb < NV; ++nb)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[nb][x] *= alpha[(x >> 1) & 1];

    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NV; ++nb) {
        const uint64_t dv = sm90::desc_mnmajor(v_addr + nb * BN * 128 + kk * 2048);
        sm90::wgmma_rs_n64<1>(acc[nb], hi[kk], dv);
        sm90::wgmma_rs_n64<1>(acc[nb], lo[kk], dv);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NV; ++nb) sm90::fence_operands(acc[nb]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);  // stage s may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
    const int qi = q0 + r0 + 8 * r;
    if (qi >= Tq) continue;
    if (m_out && lane % 4 == 0 && blockIdx.z == 0) {  // both halves hold the same m, l
      const long long idx = (static_cast<long long>(b) * H + h) * Tq + qi;
      m_out[idx] = m_r[r];
      l_out[idx] = l_r[r];
    }
    const float inv = 1.f / l_r[r];
    __nv_bfloat16* row = o + b * so.b + qi * so.t + h * so.h + col0;
#pragma unroll
    for (int nb = 0; nb < NV; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (DH % 64 == 0 || col0 + nb * 64 + 8 * c < DH)  // the zero columns past DH are not stored
          *reinterpret_cast<__nv_bfloat162*>(row + nb * 64 + 8 * c + c0) =
              __floats2bfloat162_rn(acc[nb][4 * c + 2 * r] * inv, acc[nb][4 * c + 2 * r + 1] * inv);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* k_lens, void* o,
                   float* m_out, float* l_out, int B, int Tq, int Tk, int H, Strides sq,
                   Strides sk, Strides sv, Strides so, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t e = sm90::make_tile_map(&mq, q, B, Tq, H, DH, sq.b, sq.t, sq.h, BM);
  if (e == cudaSuccess) e = sm90::make_tile_map(&mk, k, B, Tk, H, DH, sk.b, sk.t, sk.h, BN);
  if (e == cudaSuccess) e = sm90::make_tile_map(&mv, v, B, Tk, H, DH, sv.b, sv.t, sv.h, BN);
  if (e != cudaSuccess) return e;
  constexpr int smem = Layout<DH>::BYTES;
  e = sm90::allow_smem<flash_fwd_tc_kernel<DH>>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Tq + BM - 1) / BM, Layout<DH>::DP / Layout<DH>::DV);
  flash_fwd_tc_kernel<DH><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, k_lens, static_cast<__nv_bfloat16*>(o), m_out, l_out, Tq, Tk, H, so, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

// q (B, Tq, H, Dh), k and v (B, Tk, H, Dh), o (B, Tq, H, Dh): element strides
// over (b, t, h), unit stride over Dh.  k_lens is (B,) int32 or null (all
// keys valid).  Dh is 64, 96, 128 or a multiple of 256.
// is_bf16 selects __nv_bfloat16 over float for all four: 1 takes the
// tensor-core path at Dh 64, 96, 128 and 256 (bf16 tensors with 16-byte
// aligned bases and strides) and the SIMT path above; 2 takes the SIMT path,
// to compare the two.  scale is the softmax scale (the caller's true
// Dh^-0.5).  m_out and l_out are (B, H, Tq) fp32 for the row max and sum, or
// both null.
extern "C" int mt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 const int* k_lens, void* o, float* m_out, float* l_out,
                                 int B, int Tq, int Tk, int H, int Dh, long long sq_b, long long sq_t,
                                 long long sq_h, long long sk_b, long long sk_t,
                                 long long sk_h, long long sv_b, long long sv_t,
                                 long long sv_h, long long so_b, long long so_t,
                                 long long so_h, int causal, float scale, int is_bf16,
                                 void* stream) {
  const Strides sq{sq_b, sq_t, sq_h}, sk{sk_b, sk_t, sk_h};
  const Strides sv{sv_b, sv_t, sv_h}, so{so_b, so_t, so_h};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16 == 1 && Dh == 64)
    e = tc::launch<64>(q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk, sv, so, causal,
                       scale, st);
  else if (is_bf16 == 1 && Dh == 96)
    e = tc::launch<96>(q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk, sv, so, causal,
                       scale, st);
  else if (is_bf16 == 1 && Dh == 128)
    e = tc::launch<128>(q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk, sv, so, causal,
                        scale, st);
  else if (is_bf16 == 1 && Dh == 256)
    e = tc::launch<256>(q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk, sv, so, causal,
                        scale, st);
  else if (is_bf16)
    e = dispatch_dh<__nv_bfloat16>(Dh, q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk,
                                   sv, so, causal, scale, st);
  else
    e = dispatch_dh<float>(Dh, q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk, sv, so,
                           causal, scale, st);
  return static_cast<int>(e);
}
