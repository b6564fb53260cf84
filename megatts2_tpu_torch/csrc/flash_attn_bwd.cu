// Masked attention backward (recompute), for an NVIDIA Hopper card.
//
// Replaces the backward of megatts2_tpu/ops/attention_pallas.py::
// flash_attention_vjp (_fa_bwd), an XLA scan beside the Pallas forward.
// Same function: with P = softmax(where(mask, Q K^T * scale, -1e9)),
// recomputed from the forward's row max m and row sum l,
//   dv = P^T g,  dp = g V^T,  D = rowsum(dp * P),  ds = P * (dp - D),
//   dq = ds K * scale,  dk = ds^T Q * scale.
// Inputs q, k, v, g are fp32 or bf16.  Every product accumulates in fp32.
// As _fa_bwd does, P is rounded to the input dtype before P^T g and ds before
// the dq and dk products, while D comes from the fp32 P and dp.  dq, dk, dv
// are written in the input dtype.
//
// Both implementations below run two passes without atomics, so the result
// does not depend on run order: pass 1, per query tile, a sweep over the key
// tiles for D then a sweep for dq; pass 2, per key tile, dk and dv over the
// query tiles.  That is 9 products a (query, key) pair against the minimum 5.
// Tiles whose P is exactly 0 are skipped: key tiles past k_len or past the
// block's last row when causal (pass 1), query rows before the block's first
// key when causal and whole key blocks past k_len (pass 2).  That is exact
// only when k_len > 0.  A k_len == 0 row has every logit at -1e9, so P = 1/Tk
// on every key and ds spreads its gradient over all of them, as _fa_bwd does;
// those rows visit every tile.  Hence m and l are kept apart: -1e9 + log(Tk)
// rounds back to -1e9 in fp32, so a log-sum-exp would give P = 1 there
// instead of 1/Tk.
//
// 1. bf16 at Dh 64, 96, 128 and 256 — the tensor-core path
//    (flash_bwd_dq_tc_kernel, flash_bwd_dkdv_tc_kernel), which PLM training,
//    the ADM with use_flash (Dh 96) and the GAN step's MRTE with use_flash
//    (Dh 256) take.  What bounds it:
//    operations.  At the PLM's (8, 1024, 16, 64) causal shape the nine
//    products are 18 Dh FLOP a kept pair, ~62 GFLOP, ~0.06 ms at 989 TFLOP/s
//    against ~0.035 ms for its 118.5 MB.  The design:
//    * Every product is a wgmma, bf16 x bf16 -> fp32, exactly the roundings
//      _fa_bwd applies, so the tensor cores reproduce them up to summation
//      order.  Pass 1: one consumer warpgroup owns 64 query rows; S = Q K^T
//      and dP = g V^T read Q, g, K, V from shared memory (all K-major); dS
//      goes to bf16 A fragments in registers and dq += dS K reads K
//      MN-major.  Pass 2: one warpgroup owns 64 keys and computes the
//      transposes, S^T = K Q^T and dP^T = V g^T (K-major), then dv += P^T g
//      and dk += dS^T Q with P^T and dS^T from registers and g, Q MN-major.
//    * A fifth warp loads: one lane issues TMA loads (128-byte swizzle, zero
//      fill past the edges) of the block's own tiles once and of the
//      streamed tiles (K/V in pass 1, Q/g in pass 2) into a 2-stage ring
//      with full/empty mbarriers.  Pass 1 streams K/V twice, once a sweep.
//    * P = exp(x - m) / l in fp32, from m and l read per row in pass 1; in
//      pass 2 the loader warp stages m, 1/l and D of each query tile into
//      its ring stage.  Tiles inside k_len, Tq and the diagonal skip the
//      mask arithmetic.
//    * Pass 2 at Dh 128 streams 32-row query tiles to keep dk, dv and the
//      two score tiles within the register file.
//    * Query tiles are launched longest (causal) first in pass 1; pass 2's
//      low key tiles, the longest, come first already.
//    * At Dh 256 (the MRTE's (8, 64, 2, 256)) one warpgroup cannot hold
//      pass 2's dk and dv (2 x 128 registers a thread) beside the score
//      tiles.  The output columns are split over two blocks (grid z), as in
//      kernel B: each loads full-width tiles, computes S and dP over all
//      256 columns, and accumulates only its 128 columns of dq (pass 1) or
//      of dk and dv (pass 2), the Dh 128 register plan (no spills).  Both
//      halves compute D = rowsum(dP * P); the first writes it.  Shared
//      memory: two own tiles of 32 KB and a 2-stage ring of two 32 KB
//      tiles, ~195 KB, one block an SM; the MRTE gets 32 blocks a pass.
//    * At Dh 96 (the ADM) the tiles are 128 wide, as in kernel B: TMA
//      fills columns 96-127 with zeros, the score products take the 6 k16
//      steps of the real columns, the products into dq, dk and dv run over
//      both column blocks, and only 96 columns are stored.
//
// 2. fp32 (all head dims) and bf16 above Dh 256 — the SIMT path, the first
//    version (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel; instances at Dh
//    64, 96, 128 and 256, the wrapper zero-padding other head dims, above
//    256 to a multiple of 256, and passing the true Dh's scale; above 256
//    one instance loops over chunks of 256 columns, as kernel B's
//    does): FMA issue and the shared-memory reads feeding it bound it.
//    fp32 keeps full-fp32 products (TF32 wgmma would not).  The design:
//    * Pass 1, one block per (b, h, 16 query rows), 4 warps of 4 rows, lane j
//      owning key j of a 32-key tile (kernel B's layout).  Sweep A over the
//      key tiles computes D per row; sweep B recomputes P and dp and
//      accumulates dq in registers (lane l owns dims l, l + 32, ...).  Writes
//      dq and D.
//    * Pass 2, one block per (b, h, 16 keys), 4 warps of 4 keys, lane i owning
//      query row i of a 32-row tile.  It streams q and g tiles, reads m, l and
//      D per row, and accumulates dk and dv for its keys in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 4;           // query rows (pass 1) or keys (pass 2) per warp
constexpr int BR = WARPS * ROWS;  // rows or keys a block owns
constexpr int BT = 32;            // streamed tile: one key or query row per lane
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

// x rounded to T and back: the cast _fa_bwd applies to P and ds
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// P for query row qi and key j from the raw dot product s: masked logits
// are REPLACED by -1e9; positions outside the tensors carry no weight.
__device__ __forceinline__ float prob(float s, int qi, int j, int Tq, int Tk, int klen,
                                      int causal, float scale, float m, float l) {
  if (qi >= Tq || j >= Tk) return 0.f;
  const bool keep = j < klen && (!causal || j <= qi);
  const float x = keep ? s * scale : MASK_FILL;
  return expf(x - m) / l;
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

// s[i] += a_i . x and t[i] += b_i . y for ROWS rows a_i, b_i held at a, b
// (row pitch DH, read by broadcast) and one vector x, y per lane.
template <int DH>
__device__ __forceinline__ void add_dots(const float* a, const float* b, const float* x,
                                         const float* y, float (&s)[ROWS], float (&t)[ROWS]) {
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    const float xd = x[d], yd = y[d];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      s[i] = fmaf(a[i * DH + d], xd, s[i]);
      t[i] = fmaf(b[i * DH + d], yd, t[i]);
    }
  }
}

template <int DH>
constexpr size_t smem_bytes() {  // both passes: two [BR][DH] and two [BT][DH + 1] tiles
  return (2 * BR * DH + 2 * BT * (DH + 1)) * sizeof(float);
}

// Both passes take the head dim as nc chunks of DH columns: NC = 1 (one
// chunk, fixed at compile time) for the instances up to 256; NC = 0 above,
// with nc = Dh / 256 chunks given at run time.  Block x = (tile) * nc +
// chunk writes output columns [chunk DH, (chunk + 1) DH).  With one chunk
// the block's own rows are loaded once; with more, the dot products sum over
// the chunks in order, all four tiles of each chunk staged in turn (the
// forward's order, so the recomputed scores equal the forward's bit for
// bit), then the block's own chunk of the tiles its products read is staged
// again unless it was the last.

// ---- pass 1: D and dq, one block per (b, h, BR query rows, chunk) ----------
template <typename T, int DH, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const int* __restrict__ k_lens,
                    const float* __restrict__ m, const float* __restrict__ l,
                    float* __restrict__ dsum, T* __restrict__ dq, int Tq, int Tk, int n_chunks,
                    Strides sq, Strides sk, Strides sv, Strides sg, Strides sdq, int causal,
                    float scale) {
  const int nc = NC ? NC : n_chunks;
  constexpr int C = DH / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BR][DH]
  float* g_s = q_s + BR * DH;        // [BR][DH]
  float* k_s = g_s + BR * DH;        // [BT][DH + 1]
  float* v_s = k_s + BT * (DH + 1);  // [BT][DH + 1]

  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int chunk = blockIdx.x % nc;
  const int q0 = blockIdx.x / nc * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int klen = k_lens ? min(max(k_lens[b], 0), Tk) : Tk;
  int kend = Tk;  // keys this block visits: P is exactly 0 past them
  if (klen > 0) {
    kend = klen;
    if (causal) kend = min(kend, min(q0 + BR, Tq));
  }

  const T* qb = q + b * sq.b + h * sq.h;
  const T* gb = g + b * sg.b + h * sg.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  if (nc == 1) {
    load_rows<T, DH>(q_s, DH, qb, sq.t, q0, BR, Tq);
    load_rows<T, DH>(g_s, DH, gb, sg.t, q0, BR, Tq);
  }
  const long long stat0 = (static_cast<long long>(b) * H + h) * Tq;

  float m_r[ROWS], l_r[ROWS], d_r[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + warp * ROWS + i;
    m_r[i] = qi < Tq ? m[stat0 + qi] : 0.f;
    l_r[i] = qi < Tq ? l[stat0 + qi] : 1.f;
    d_r[i] = 0.f;
  }
  const float* qr = q_s + warp * ROWS * DH;
  const float* gr = g_s + warp * ROWS * DH;
  const float* kr = k_s + lane * (DH + 1);  // key j = kt + lane
  const float* vr = v_s + lane * (DH + 1);

  // s = q . k_j and dp = g . v_j over every chunk
  auto tile_dots = [&](int kt, float (&s)[ROWS], float (&dp)[ROWS]) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = dp[i] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      __syncthreads();  // the previous chunk or tile is consumed (and q_s, g_s are written)
      if (nc > 1) {
        load_rows<T, DH>(q_s, DH, qb + cc * DH, sq.t, q0, BR, Tq);
        load_rows<T, DH>(g_s, DH, gb + cc * DH, sg.t, q0, BR, Tq);
      }
      load_rows<T, DH>(k_s, DH + 1, kb + cc * DH, sk.t, kt, BT, Tk);
      load_rows<T, DH>(v_s, DH + 1, vb + cc * DH, sv.t, kt, BT, Tk);
      __syncthreads();
      add_dots<DH>(qr, gr, kr, vr, s, dp);
    }
  };

  // sweep A: D = sum_j dp * P, lane-partial then reduced over the warp
  for (int kt = 0; kt < kend; kt += BT) {
    float s[ROWS], dp[ROWS];
    tile_dots(kt, s, dp);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + warp * ROWS + i;
      const float p = prob(s[i], qi, kt + lane, Tq, Tk, klen, causal, scale, m_r[i], l_r[i]);
      d_r[i] = fmaf(dp[i], p, d_r[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) d_r[i] = warp_sum(d_r[i]);

  // sweep B: ds = P (dp - D), rounded; dq = ds K, over this block's chunk of K
  float acc[ROWS][C];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < kend; kt += BT) {
    float s[ROWS], dp[ROWS], ds[ROWS];
    tile_dots(kt, s, dp);
    if (chunk != nc - 1) {
      __syncthreads();
      load_rows<T, DH>(k_s, DH + 1, kb + chunk * DH, sk.t, kt, BT, Tk);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + warp * ROWS + i;
      const float p = prob(s[i], qi, kt + lane, Tq, Tk, klen, causal, scale, m_r[i], l_r[i]);
      ds[i] = round_to<T>(p * (dp[i] - d_r[i]));
    }
#pragma unroll 4
    for (int jj = 0; jj < BT; ++jj) {
      float kv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = k_s[jj * (DH + 1) + c * 32 + lane];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float dsj = __shfl_sync(FULL, ds[i], jj);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(dsj, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + warp * ROWS + i;
    if (qi >= Tq) continue;
    if (lane == 0 && chunk == 0) dsum[stat0 + qi] = d_r[i];  // every chunk holds the same D
    T* row = dq + b * sdq.b + qi * sdq.t + h * sdq.h + chunk * DH;
#pragma unroll
    for (int c = 0; c < C; ++c) row[c * 32 + lane] = from_f32<T>(acc[i][c] * scale);
  }
}

// ---- pass 2: dk and dv, one block per (b, h, BR keys, chunk) ---------------
template <typename T, int DH, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const int* __restrict__ k_lens, const float* __restrict__ m,
                      const float* __restrict__ l, const float* __restrict__ dsum,
                      T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int n_chunks,
                      Strides sq, Strides sk, Strides sv, Strides sg, Strides sdk, Strides sdv,
                      int causal, float scale) {
  const int nc = NC ? NC : n_chunks;
  constexpr int C = DH / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [BR][DH]
  float* v_s = k_s + BR * DH;        // [BR][DH]
  float* q_s = v_s + BR * DH;        // [BT][DH + 1]
  float* g_s = q_s + BT * (DH + 1);  // [BT][DH + 1]

  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int chunk = blockIdx.x % nc;
  const int k0 = blockIdx.x / nc * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int klen = k_lens ? min(max(k_lens[b], 0), Tk) : Tk;
  int qstart = 0, qend = Tq;  // query rows this block visits: P is exactly 0 elsewhere
  if (klen > 0) {
    if (k0 >= klen) qend = 0;       // every key of the block is masked
    if (causal) qstart = min(k0, Tq);  // rows before the block's first key
  }

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  if (nc == 1) {
    load_rows<T, DH>(k_s, DH, kb, sk.t, k0, BR, Tk);
    load_rows<T, DH>(v_s, DH, vb, sv.t, k0, BR, Tk);
  }
  const T* qb = q + b * sq.b + h * sq.h;
  const T* gb = g + b * sg.b + h * sg.h;
  const long long stat0 = (static_cast<long long>(b) * H + h) * Tq;

  float dk_acc[ROWS][C], dv_acc[ROWS][C];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  const float* kr = k_s + warp * ROWS * DH;
  const float* vr = v_s + warp * ROWS * DH;
  const float* qr = q_s + lane * (DH + 1);  // query row qt + lane
  const float* gr = g_s + lane * (DH + 1);

  for (int qt = qstart; qt < qend; qt += BT) {
    float s[ROWS], dp[ROWS];  // k_r . q_i and v_r . g_i, over every chunk
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      __syncthreads();  // the previous chunk or tile is consumed (and k_s, v_s are written)
      if (nc > 1) {
        load_rows<T, DH>(k_s, DH, kb + cc * DH, sk.t, k0, BR, Tk);
        load_rows<T, DH>(v_s, DH, vb + cc * DH, sv.t, k0, BR, Tk);
      }
      load_rows<T, DH>(q_s, DH + 1, qb + cc * DH, sq.t, qt, BT, Tq);
      load_rows<T, DH>(g_s, DH + 1, gb + cc * DH, sg.t, qt, BT, Tq);
      __syncthreads();
      add_dots<DH>(kr, vr, qr, gr, s, dp);
    }
    if (chunk != nc - 1) {  // this block's chunk of Q and g, for dk and dv
      __syncthreads();
      load_rows<T, DH>(q_s, DH + 1, qb + chunk * DH, sq.t, qt, BT, Tq);
      load_rows<T, DH>(g_s, DH + 1, gb + chunk * DH, sg.t, qt, BT, Tq);
      __syncthreads();
    }
    const int qi = qt + lane;  // this lane's query row
    const bool row = qi < Tq;
    const float m_i = row ? m[stat0 + qi] : 0.f;
    const float l_i = row ? l[stat0 + qi] : 1.f;
    const float d_i = row ? dsum[stat0 + qi] : 0.f;

    float pc[ROWS], ds[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = k0 + warp * ROWS + r;
      const float p = prob(s[r], qi, j, Tq, Tk, klen, causal, scale, m_i, l_i);
      pc[r] = round_to<T>(p);
      ds[r] = round_to<T>(p * (dp[r] - d_i));
    }
#pragma unroll 4
    for (int ii = 0; ii < BT; ++ii) {
      float qv[C], gv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        qv[c] = q_s[ii * (DH + 1) + c * 32 + lane];
        gv[c] = g_s[ii * (DH + 1) + c * 32 + lane];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pi = __shfl_sync(FULL, pc[r], ii);
        const float dsi = __shfl_sync(FULL, ds[r], ii);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv_acc[r][c] = fmaf(pi, gv[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dsi, qv[c], dk_acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int j = k0 + warp * ROWS + r;
    if (j >= Tk) continue;
    T* krow = dk + b * sdk.b + j * sdk.t + h * sdk.h + chunk * DH;
    T* vrow = dv + b * sdv.b + j * sdv.t + h * sdv.h + chunk * DH;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      krow[c * 32 + lane] = from_f32<T>(dk_acc[r][c] * scale);
      vrow[c * 32 + lane] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const int* k_lens;
  const float *m, *l;
  float* dsum;
  void *dq, *dk, *dv;
  int B, Tq, Tk, H;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
  int causal;
  float scale;
};

template <typename T, int DH, int NC>
cudaError_t launch(const Args& a, int nc, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto k1 = flash_bwd_dq_kernel<T, DH, NC>;
  auto k2 = flash_bwd_dkdv_kernel<T, DH, NC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  k1<<<dim3((a.Tq + BR - 1) / BR * nc, a.H, a.B), THREADS, smem, stream>>>(
      q, k, v, g, a.k_lens, a.m, a.l, a.dsum, static_cast<T*>(a.dq), a.Tq, a.Tk, nc, a.sq, a.sk,
      a.sv, a.sg, a.sdq, a.causal, a.scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k2<<<dim3((a.Tk + BR - 1) / BR * nc, a.H, a.B), THREADS, smem, stream>>>(
      q, k, v, g, a.k_lens, a.m, a.l, a.dsum, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.Tq, a.Tk, nc, a.sq, a.sk, a.sv, a.sg, a.sdk, a.sdv, a.causal, a.scale);
  return cudaGetLastError();
}

// Above 256 the head dim runs in chunks of WIDE columns (the wrapper pads it
// to a multiple of WIDE).
constexpr int WIDE = 256;

template <typename T>
cudaError_t dispatch_dh(int Dh, const Args& a, cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch<T, 64, 1>(a, 1, stream);
    case 96:
      return launch<T, 96, 1>(a, 1, stream);
    case 128:
      return launch<T, 128, 1>(a, 1, stream);
    case 256:
      return launch<T, 256, 1>(a, 1, stream);
    default:
      if (Dh > WIDE && Dh % WIDE == 0) return launch<T, WIDE, 0>(a, Dh / WIDE, stream);
      return cudaErrorInvalidValue;
  }
}


// ---- the tensor-core path: bf16, Dh 64, 96, 128 and 256 --------------------
namespace tc {

constexpr int BR = 64;        // rows a block owns: query rows (pass 1) or keys (pass 2)
constexpr int BK = 64;        // keys per streamed tile in pass 1
constexpr int STAGES = 2;
constexpr int THREADS = 160;  // warps 0-3 compute, warp 4 loads

// Tiles are whole 64-column blocks: DP is the head dim rounded up to them
// (96 -> 128; TMA fills columns 96-127 with zeros).  A block accumulates DV
// of the DP output columns (of dq in pass 1, of dk and dv in pass 2): all of
// them up to Dh 128; at Dh 256 one half, the other half in a second block
// (grid z), so the accumulators keep the Dh 128 register plan.  Both blocks
// compute the full scores over Dh 256.
template <int DH>
struct Layout {  // byte offsets in shared memory, either pass
  static constexpr int DP = (DH + 63) / 64 * 64;
  static constexpr int DV = DP > 128 ? 128 : DP;
  static constexpr int BQ = DP == 64 ? 64 : 32;  // query rows per streamed tile in pass 2
  static constexpr int OWN = BR * DP * 2;     // one of the block's two own tiles
  static constexpr int STREAM = BK * DP * 2;  // one streamed tile, pass 1 (pass 2's are no larger)
  static constexpr int RING = 2 * OWN;        // stage s: two streamed tiles at RING + 2 s STREAM
  static constexpr int STATS = RING + 2 * STAGES * STREAM;  // pass 2, stage s: m, 1/l, D of its rows
  static constexpr int STAT_STAGE = 3 * 64 * 4;
  static constexpr int BARS = STATS + STAGES * STAT_STAGE;
  static constexpr int BYTES = BARS + 64 + 1024;
};

constexpr float LOG2E = 1.4426950408889634f;

// P for query row qi and key j from the raw dot product s, as prob() below;
// without MASKED the caller knows the pair is inside every mask.
template <bool MASKED>
__device__ __forceinline__ float prob_tc(float s, int qi, int j, int Tq, int Tk, int klen,
                                         int causal, float scale, float m, float inv_l) {
  if (!MASKED) return exp2f((s * scale - m) * LOG2E) * inv_l;
  if (qi >= Tq || j >= Tk) return 0.f;
  const bool keep = j < klen && (!causal || j <= qi);
  const float x = keep ? s * scale : MASK_FILL;
  return exp2f((x - m) * LOG2E) * inv_l;
}

// Pass 1: P in place of the 64 x 64 scores (rows row, row + 8 of this thread).
template <bool MASKED>
__device__ __forceinline__ void probs_rows(float (&sc)[32], int row, int kt, int c0, int Tq, int Tk,
                                           int klen, int causal, float scale, const float (&m_r)[2],
                                           const float (&il_r)[2]) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int r = (x >> 1) & 1;
    sc[x] = prob_tc<MASKED>(sc[x], row + 8 * r, kt + 8 * (x / 4) + c0 + (x & 1), Tq, Tk, klen,
                            causal, scale, m_r[r], il_r[r]);
  }
}

// Pass 2: P^T in place of the 64 x N transposed scores (rows: keys key,
// key + 8; columns: query rows qt + 8 c + c0 + e) and dS^T = P^T (dP^T - D) in
// place of dP^T, with m, 1/l, D of the tile's query rows from shared memory.
template <bool MASKED, int N>
__device__ __forceinline__ void probs_cols(float (&sc)[N / 2], float (&dp)[N / 2], const float* st,
                                           int key, int qt, int c0, int Tq, int Tk, int klen,
                                           int causal, float scale) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int lc = 8 * c + c0 + e;
      const float m_i = st[lc], il_i = st[64 + lc], d_i = st[128 + lc];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = 4 * c + 2 * r + e;
        const float p = prob_tc<MASKED>(sc[x], qt + lc, key + 8 * r, Tq, Tk, klen, causal, scale,
                                        m_i, il_i);
        sc[x] = p;
        dp[x] = p * (dp[x] - d_i);
      }
    }
}

// Shared set-up of both passes: align the dynamic shared memory to 1024 bytes
// and initialise the own-tiles barrier and the ring's full/empty barriers.
template <int DH>
__device__ __forceinline__ unsigned char* setup(unsigned char* raw, uint64_t*& own, uint64_t*& full,
                                                uint64_t*& empty, int full_arrivals) {
  unsigned char* smem = raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Layout<DH>::BARS);
  own = bars;
  full = bars + 1;
  empty = bars + 1 + STAGES;
  if (threadIdx.x == 0) {
    sm90::mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], full_arrivals);
      sm90::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  return smem;
}

// The loader warp's loop: the block's two own tiles (row `own_row` of maps
// a, b), then n streamed pairs (maps c, d, `rows` each, starting at row
// first + (i % period) * rows).  Lane 0 issues the copies.  With m non-null
// (pass 2) every lane also writes m, 1/l and D of the streamed rows into the
// stage and arrives on its full barrier (33 arrivals with lane 0's expect_tx).
template <int DH>
__device__ __forceinline__ void load_all(unsigned char* smem, uint64_t* own, uint64_t* full,
                                         uint64_t* empty, const CUtensorMap* a, const CUtensorMap* b,
                                         int own_row, const CUtensorMap* c, const CUtensorMap* d,
                                         int first, int rows, int n, int period, int h, int bb,
                                         const float* m, const float* l, const float* dsum,
                                         long long stat0, int Tq) {
  using L = Layout<DH>;
  constexpr int NB = L::DP / 64;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    sm90::mbar_expect_tx(own, 2 * L::OWN);
    for (int nb = 0; nb < NB; ++nb) {
      sm90::tma_load_4d(smem + nb * BR * 128, a, nb * 64, h, own_row, bb, own);
      sm90::tma_load_4d(smem + L::OWN + nb * BR * 128, b, nb * 64, h, own_row, bb, own);
    }
  }
  const int bytes = rows * L::DP * 2;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    if (i >= STAGES) sm90::mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
    const int row = first + (i % period) * rows;
    if (lane == 0) {
      sm90::mbar_expect_tx(&full[s], 2 * bytes);
      unsigned char* t = smem + L::RING + 2 * s * L::STREAM;
      for (int nb = 0; nb < NB; ++nb) {
        sm90::tma_load_4d(t + nb * rows * 128, c, nb * 64, h, row, bb, &full[s]);
        sm90::tma_load_4d(t + L::STREAM + nb * rows * 128, d, nb * 64, h, row, bb, &full[s]);
      }
    }
    if (m) {
      float* st = reinterpret_cast<float*>(smem + L::STATS + s * L::STAT_STAGE);
      for (int r = lane; r < rows; r += 32) {
        const int qi = row + r;
        const bool in = qi < Tq;
        st[r] = in ? m[stat0 + qi] : 0.f;
        st[64 + r] = in ? 1.f / l[stat0 + qi] : 0.f;
        st[128 + r] = in ? dsum[stat0 + qi] : 0.f;
      }
      sm90::mbar_arrive(&full[s]);
    }
  }
}

// X (64 x N) = A (64 x DH, own tile at a_addr) B^T (N rows x DH at b_addr, N-row
// column blocks), both K-major; zeroes X first.  The zero columns past DH
// (of a padded tile) are left out.
template <int DH, int N>
__device__ __forceinline__ void scores(float (&x)[N / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const uint64_t da = sm90::desc_kmajor(a_addr + (ks / 4) * (BR * 128) + (ks % 4) * 32);
    const uint64_t db = sm90::desc_kmajor(b_addr + (ks / 4) * (N * 128) + (ks % 4) * 32);
    if constexpr (N == 64) sm90::wgmma_ss_n64<0>(x, da, db, ks > 0);
    else sm90::wgmma_ss_n32<0>(x, da, db, ks > 0);
  }
}

// acc[nb] (64 x 64 dims nb) += A (64 x 16 kk, fragments) B (rows x 64 NB
// columns at addr, MN-major: NB column blocks of a tile), over the KK k16
// steps of one streamed tile.
template <int NB, int KK>
__device__ __forceinline__ void accumulate(float (&acc)[NB][32], const uint32_t (&a)[KK][4],
                                           uint32_t addr) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      sm90::wgmma_rs_n64<1>(acc[nb], a[kk], sm90::desc_mnmajor(addr + nb * (KK * 16) * 128 + kk * 2048));
}

// Accumulator x (64 x 16 KK) as bf16 A fragments, one per 16 columns.
template <int KK>
__device__ __forceinline__ void fragments(uint32_t (&a)[KK][4], const float (&x)[KK * 8]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) a[kk][w] = sm90::pack_bf16(x[8 * kk + 2 * w], x[8 * kk + 2 * w + 1]);
}

// Writes rows r0 and r0 + 8 of a 64 x 64 NB accumulator, columns col0 on,
// times `mul`; rows at or past `limit` and columns at or past DH skipped.
template <int DH, int NB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long st, int row0, int limit,
                                           int col0, const float (&acc)[NB][32], float mul, int c0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= limit) continue;
    __nv_bfloat16* row = base + t * st + col0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (DH % 64 == 0 || col0 + nb * 64 + 8 * c < DH)
          *reinterpret_cast<__nv_bfloat162*>(row + nb * 64 + 8 * c + c0) = __floats2bfloat162_rn(
              acc[nb][4 * c + 2 * r] * mul, acc[nb][4 * c + 2 * r + 1] * mul);
  }
}

// This warp is done with ring stage s (its wgmmas have completed).
__device__ __forceinline__ void consumed(uint64_t* empty, int s) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) sm90::mbar_arrive(&empty[s]);
}

// ---- pass 1: D and dq, one block per (b, h, 64 query rows, DV columns) -----
template <int DH>
__global__ void __launch_bounds__(THREADS, DH > 128 ? 1 : 2)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                       const int* __restrict__ k_lens, const float* __restrict__ m,
                       const float* __restrict__ l, float* __restrict__ dsum,
                       __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H, Strides sdq,
                       int causal, float scale) {
  using L = Layout<DH>;
  constexpr int NV = L::DV / 64;  // column blocks of this block's dq
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint64_t *own, *full, *empty;
  unsigned char* smem = setup<DH>(smem_raw, own, full, empty, 1);
  const int col0 = L::DP > L::DV ? blockIdx.z * L::DV : 0;  // this block's first dq column

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest causal tiles first
  const int klen = k_lens ? min(max(k_lens[b], 0), Tk) : Tk;
  int kend = Tk;  // keys this block visits: P is exactly 0 past them
  if (klen > 0) {
    kend = klen;
    if (causal) kend = min(kend, min(q0 + BR, Tq));
  }
  const int ntiles = (kend + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 4) {  // the loader: Q and g once, K/V twice (one sweep each)
    if (lane == 0)
      load_all<DH>(smem, own, full, empty, &mq, &mg, q0, &mk, &mv, 0, BK, 2 * ntiles, ntiles, h, b,
                   nullptr, nullptr, nullptr, 0, Tq);
    return;
  }

  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const long long stat0 = (static_cast<long long>(b) * H + h) * Tq;
  float m_r[2], il_r[2], d_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    m_r[r] = qi < Tq ? m[stat0 + qi] : 0.f;
    il_r[r] = qi < Tq ? 1.f / l[stat0 + qi] : 1.f;
  }
  const uint32_t q_addr = sm90::smem_addr(smem), g_addr = q_addr + L::OWN;
  sm90::mbar_wait(own, 0);

  float acc[NV][32];
#pragma unroll
  for (int nb = 0; nb < NV; ++nb)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[nb][x] = 0.f;

  for (int i = 0; i < 2 * ntiles; ++i) {
    const int s = i % STAGES;
    const bool sweep_b = i >= ntiles;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t k_addr = sm90::smem_addr(smem + L::RING + 2 * s * L::STREAM);
    const uint32_t v_addr = k_addr + L::STREAM;
    float sc[32], dp[32];
    sm90::wgmma_fence();
    scores<DH, BK>(sc, q_addr, k_addr);  // S = Q K^T
    scores<DH, BK>(dp, g_addr, v_addr);  // dP = g V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);
    sm90::fence_operands(dp);

    const int kt = (sweep_b ? i - ntiles : i) * BK;
    // a tile inside k_len, Tq and (when causal) below the diagonal needs no mask
    if (klen > 0 && kt + BK <= kend && q0 + BR <= Tq && (!causal || kt + BK - 1 <= q0))
      probs_rows<false>(sc, q0 + r0, kt, c0, Tq, Tk, klen, causal, scale, m_r, il_r);
    else
      probs_rows<true>(sc, q0 + r0, kt, c0, Tq, Tk, klen, causal, scale, m_r, il_r);
    if (!sweep_b) {  // sweep A: D = sum_j dP * P, this thread's part
#pragma unroll
      for (int x = 0; x < 32; ++x) d_r[(x >> 1) & 1] = fmaf(dp[x], sc[x], d_r[(x >> 1) & 1]);
      if (i == ntiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          d_r[r] += __shfl_xor_sync(FULL, d_r[r], 1);
          d_r[r] += __shfl_xor_sync(FULL, d_r[r], 2);
        }
      }
      consumed(empty, s);
      continue;
    }
    // sweep B: dS = P (dP - D), rounded to bf16; dq += dS K
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] *= dp[x] - d_r[(x >> 1) & 1];
    uint32_t ds[BK / 16][4];
    fragments<BK / 16>(ds, sc);
    sm90::wgmma_fence();
    accumulate<NV, BK / 16>(acc, ds, k_addr + (col0 / 64) * (BK * 128));  // the block's columns of K
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NV; ++nb) sm90::fence_operands(acc[nb]);
    consumed(empty, s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi < Tq && lane % 4 == 0 && col0 == 0) dsum[stat0 + qi] = d_r[r];  // both halves hold D
  }
  store_rows<DH>(dq + b * sdq.b + h * sdq.h, sdq.t, q0 + r0, Tq, col0, acc, scale, c0);
}

// ---- pass 2: dk and dv, one block per (b, h, 64 keys, DV columns) ----------
template <int DH>
__global__ void __launch_bounds__(THREADS, DH == 64 ? 2 : 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                         const int* __restrict__ k_lens, const float* __restrict__ m,
                         const float* __restrict__ l, const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
                         int Tk, int H, Strides sdk, Strides sdv, int causal, float scale) {
  using L = Layout<DH>;
  constexpr int NV = L::DV / 64;  // column blocks of this block's dk and dv
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint64_t *own, *full, *empty;
  unsigned char* smem = setup<DH>(smem_raw, own, full, empty, 33);
  const int col0 = L::DP > L::DV ? blockIdx.z * L::DV : 0;  // this block's first dk and dv column

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * BR;
  const int klen = k_lens ? min(max(k_lens[b], 0), Tk) : Tk;
  int qstart = 0, qend = Tq;  // query rows this block visits: P is exactly 0 elsewhere
  if (klen > 0) {
    if (k0 >= klen) qend = 0;          // every key of the block is masked
    if (causal) qstart = min(k0, Tq);  // rows before the block's first key
  }
  const int ntiles = qend > qstart ? (qend - qstart + BQ - 1) / BQ : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long stat0 = (static_cast<long long>(b) * H + h) * Tq;

  if (warp == 4) {  // the loader: K and V once, then Q/g tiles with their m, 1/l, D
    if (ntiles > 0)
      load_all<DH>(smem, own, full, empty, &mk, &mv, k0, &mq, &mg, qstart, BQ, ntiles, ntiles, h, b,
                   m, l, dsum, stat0, Tq);
    return;
  }

  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t k_addr = sm90::smem_addr(smem), v_addr = k_addr + L::OWN;
  float dk_acc[NV][32], dv_acc[NV][32];
#pragma unroll
  for (int nb = 0; nb < NV; ++nb)
#pragma unroll
    for (int x = 0; x < 32; ++x) dk_acc[nb][x] = dv_acc[nb][x] = 0.f;
  if (ntiles > 0) sm90::mbar_wait(own, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const int qt = qstart + i * BQ;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t q_addr = sm90::smem_addr(smem + L::RING + 2 * s * L::STREAM);
    const uint32_t g_addr = q_addr + L::STREAM;
    float sc[BQ / 2], dp[BQ / 2];
    sm90::wgmma_fence();
    scores<DH, BQ>(sc, k_addr, q_addr);  // S^T = K Q^T
    scores<DH, BQ>(dp, v_addr, g_addr);  // dP^T = V g^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);
    sm90::fence_operands(dp);

    // rows are keys, columns query rows: P^T and dS^T; a tile inside k_len,
    // Tq and (when causal) below the diagonal needs no mask
    const float* st = reinterpret_cast<const float*>(smem + L::STATS + s * L::STAT_STAGE);
    if (klen > 0 && k0 + BR <= klen && qt + BQ <= Tq && (!causal || k0 + BR - 1 <= qt))
      probs_cols<false, BQ>(sc, dp, st, k0 + r0, qt, c0, Tq, Tk, klen, causal, scale);
    else
      probs_cols<true, BQ>(sc, dp, st, k0 + r0, qt, c0, Tq, Tk, klen, causal, scale);
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
    fragments<BQ / 16>(pf, sc);
    fragments<BQ / 16>(dsf, dp);
    sm90::wgmma_fence();
    const uint32_t cols = (col0 / 64) * (BQ * 128);  // the block's columns of g and Q
    accumulate<NV, BQ / 16>(dv_acc, pf, g_addr + cols);   // dv += P^T g
    accumulate<NV, BQ / 16>(dk_acc, dsf, q_addr + cols);  // dk += dS^T Q
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NV; ++nb) {
      sm90::fence_operands(dv_acc[nb]);
      sm90::fence_operands(dk_acc[nb]);
    }
    consumed(empty, s);
  }

  store_rows<DH>(dk + b * sdk.b + h * sdk.h, sdk.t, k0 + r0, Tk, col0, dk_acc, scale, c0);
  store_rows<DH>(dv + b * sdv.b + h * sdv.h, sdv.t, k0 + r0, Tk, col0, dv_acc, 1.f, c0);
}

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg, mq2, mg2;
  constexpr int BQ = Layout<DH>::BQ;
  cudaError_t e = sm90::make_tile_map(&mq, a.q, a.B, a.Tq, a.H, DH, a.sq.b, a.sq.t, a.sq.h, BR);
  if (e == cudaSuccess) e = sm90::make_tile_map(&mg, a.g, a.B, a.Tq, a.H, DH, a.sg.b, a.sg.t, a.sg.h, BR);
  if (e == cudaSuccess) e = sm90::make_tile_map(&mk, a.k, a.B, a.Tk, a.H, DH, a.sk.b, a.sk.t, a.sk.h, BK);
  if (e == cudaSuccess) e = sm90::make_tile_map(&mv, a.v, a.B, a.Tk, a.H, DH, a.sv.b, a.sv.t, a.sv.h, BK);
  if (e == cudaSuccess) e = sm90::make_tile_map(&mq2, a.q, a.B, a.Tq, a.H, DH, a.sq.b, a.sq.t, a.sq.h, BQ);
  if (e == cudaSuccess) e = sm90::make_tile_map(&mg2, a.g, a.B, a.Tq, a.H, DH, a.sg.b, a.sg.t, a.sg.h, BQ);
  if (e != cudaSuccess) return e;
  constexpr int smem = Layout<DH>::BYTES;
  e = sm90::allow_smem<flash_bwd_dq_tc_kernel<DH>>(smem);
  if (e == cudaSuccess) e = sm90::allow_smem<flash_bwd_dkdv_tc_kernel<DH>>(smem);
  if (e != cudaSuccess) return e;
  constexpr int halves = Layout<DH>::DP / Layout<DH>::DV;  // grid z: 2 at Dh 256
  flash_bwd_dq_tc_kernel<DH><<<dim3(a.B * a.H, (a.Tq + BR - 1) / BR, halves), THREADS, smem, stream>>>(
      mq, mk, mv, mg, a.k_lens, a.m, a.l, a.dsum, static_cast<__nv_bfloat16*>(a.dq), a.Tq, a.Tk,
      a.H, a.sdq, a.causal, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // pass 2's K/V maps: the block's own 64-key tiles (BR rows, as BK)
  flash_bwd_dkdv_tc_kernel<DH><<<dim3(a.B * a.H, (a.Tk + BR - 1) / BR, halves), THREADS, smem,
                                  stream>>>(
      mq2, mk, mv, mg2, a.k_lens, a.m, a.l, a.dsum, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.Tq, a.Tk, a.H, a.sdk, a.sdv, a.causal, a.scale);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

// q, g (B, Tq, H, Dh) and k, v (B, Tk, H, Dh) as the forward took them; dq,
// dk, dv of the same shapes; element strides over (b, t, h), unit stride over
// Dh.  m, l (the forward's row max and row sum) and dsum (scratch, written
// here) are contiguous (B, H, Tq) fp32.  k_lens is (B,) int32 or null (all
// keys valid).  Dh is 64, 96, 128 or a multiple of 256.
// is_bf16 selects __nv_bfloat16 over float for the seven tensors: 1 takes
// the tensor-core path at Dh 64, 96, 128 and 256 (bf16 tensors with 16-byte
// aligned bases and strides, dq/dk/dv contiguous) and the SIMT path above;
// 2 takes the SIMT path at every head dim, to compare the two.  Launches
// pass 1 then pass 2 on `stream`.
extern "C" int mt_flash_attn_bwd(const void* q, const void* k, const void* v, const void* g,
                                 const int* k_lens, const float* m, const float* l,
                                 float* dsum, void* dq, void* dk, void* dv, int B, int Tq,
                                 int Tk, int H, int Dh, const long long* strides, int causal,
                                 float scale, int is_bf16, void* stream) {
  // strides: (b, t, h) of q, k, v, g, dq, dk, dv in that order
  const long long* s = strides;
  const Args a{q, k, v, g, k_lens, m, l, dsum, dq, dk, dv, B, Tq, Tk, H,
               {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
               {s[9], s[10], s[11]}, {s[12], s[13], s[14]}, {s[15], s[16], s[17]},
               {s[18], s[19], s[20]}, causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16 == 1 && Dh == 64)
    e = tc::launch<64>(a, st);
  else if (is_bf16 == 1 && Dh == 96)
    e = tc::launch<96>(a, st);
  else if (is_bf16 == 1 && Dh == 128)
    e = tc::launch<128>(a, st);
  else if (is_bf16 == 1 && Dh == 256)
    e = tc::launch<256>(a, st);
  else
    e = is_bf16 ? dispatch_dh<__nv_bfloat16>(Dh, a, st) : dispatch_dh<float>(Dh, a, st);
  return static_cast<int>(e);
}
