// Masked attention backward (recompute), for an NVIDIA Hopper card.
//
// Replaces the backward of megatts2_tpu/ops/attention_pallas.py::
// flash_attention_vjp (_fa_bwd), an XLA scan beside the Pallas forward.
// Same function: with P = softmax(where(mask, Q K^T * scale, -1e9)),
// recomputed from the forward's row max m and row sum l,
//   dv = P^T g,  dp = g V^T,  D = rowsum(dp * P),  ds = P * (dp - D),
//   dq = ds K * scale,  dk = ds^T Q * scale.
// Inputs q, k, v, g are fp32 or bf16, read through their (b, t, h) strides
// with unit stride over Dh.  Every product accumulates in fp32.  As _fa_bwd
// does, P is rounded to the input dtype before P^T g and ds before the dq and
// dk products, while D comes from the fp32 P and dp.  dq, dk, dv are written
// in the input dtype.
//
// What bounds it on the card: at the PLM's (8, 1024, 16, 64) bf16 causal
// shape one layer's backward is ~9 Dh-long dot products per (query, key)
// pair, ~80 GFLOP of fp32 FMAs, with no tensor cores in this first version:
// FMA issue and the shared-memory reads feeding it bound it, not bytes.
//
// What the design does about it (simple and right first, no atomics, so it
// is deterministic):
//  * Pass 1, one block per (b, h, 16 query rows), 4 warps of 4 rows, lane j
//    owning key j of a 32-key tile (kernel B's layout).  Sweep A over the
//    key tiles computes D per row; sweep B recomputes P and dp and
//    accumulates dq in registers (lane l owns dims l, l + 32, ...).  Writes
//    dq and D.
//  * Pass 2, one block per (b, h, 16 keys), 4 warps of 4 keys, lane i owning
//    query row i of a 32-row tile.  It streams q and g tiles, reads m, l and
//    D per row, and accumulates dk and dv for its keys in registers.
//  * Tiles whose P is exactly 0 are skipped: key tiles past k_len or past
//    the block's last row when causal (pass 1), query rows before the block's
//    first key when causal and whole key blocks past k_len (pass 2).  That is
//    exact only when k_len > 0.  A k_len == 0 row has every logit at -1e9,
//    so P = 1/Tk on every key and ds spreads its gradient over all of them,
//    as _fa_bwd does; those rows visit every tile.  Hence m and l are kept
//    apart: -1e9 + log(Tk) rounds back to -1e9 in fp32, so a log-sum-exp
//    would give P = 1 there instead of 1/Tk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// s[i] = a_i . x and t[i] = b_i . y for ROWS rows a_i, b_i held at a, b
// (row pitch DH, read by broadcast) and one vector x, y per lane.
template <int DH>
__device__ __forceinline__ void dots(const float* a, const float* b, const float* x,
                                     const float* y, float (&s)[ROWS], float (&t)[ROWS]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) s[i] = t[i] = 0.f;
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

// ---- pass 1: D and dq, one block per (b, h, BR query rows) ----------------
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const int* __restrict__ k_lens,
                    const float* __restrict__ m, const float* __restrict__ l,
                    float* __restrict__ dsum, T* __restrict__ dq, int Tq, int Tk, Strides sq,
                    Strides sk, Strides sv, Strides sg, Strides sdq, int causal, float scale) {
  constexpr int C = DH / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BR][DH]
  float* g_s = q_s + BR * DH;        // [BR][DH]
  float* k_s = g_s + BR * DH;        // [BT][DH + 1]
  float* v_s = k_s + BT * (DH + 1);  // [BT][DH + 1]

  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int klen = k_lens ? min(max(k_lens[b], 0), Tk) : Tk;
  int kend = Tk;  // keys this block visits: P is exactly 0 past them
  if (klen > 0) {
    kend = klen;
    if (causal) kend = min(kend, min(q0 + BR, Tq));
  }

  load_rows<T, DH>(q_s, DH, q + b * sq.b + h * sq.h, sq.t, q0, BR, Tq);
  load_rows<T, DH>(g_s, DH, g + b * sg.b + h * sg.h, sg.t, q0, BR, Tq);
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
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

  // sweep A: D = sum_j dp * P, lane-partial then reduced over the warp
  for (int kt = 0; kt < kend; kt += BT) {
    __syncthreads();  // the previous tile is consumed (and q_s, g_s are written)
    load_rows<T, DH>(k_s, DH + 1, kb, sk.t, kt, BT, Tk);
    load_rows<T, DH>(v_s, DH + 1, vb, sv.t, kt, BT, Tk);
    __syncthreads();
    float s[ROWS], dp[ROWS];  // q . k_j and g . v_j
    dots<DH>(qr, gr, kr, vr, s, dp);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + warp * ROWS + i;
      const float p = prob(s[i], qi, kt + lane, Tq, Tk, klen, causal, scale, m_r[i], l_r[i]);
      d_r[i] = fmaf(dp[i], p, d_r[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) d_r[i] = warp_sum(d_r[i]);

  // sweep B: ds = P (dp - D), rounded; dq = ds K
  float acc[ROWS][C];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < kend; kt += BT) {
    __syncthreads();
    load_rows<T, DH>(k_s, DH + 1, kb, sk.t, kt, BT, Tk);
    load_rows<T, DH>(v_s, DH + 1, vb, sv.t, kt, BT, Tk);
    __syncthreads();
    float s[ROWS], dp[ROWS], ds[ROWS];
    dots<DH>(qr, gr, kr, vr, s, dp);
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
    if (lane == 0) dsum[stat0 + qi] = d_r[i];
    T* row = dq + b * sdq.b + qi * sdq.t + h * sdq.h;
#pragma unroll
    for (int c = 0; c < C; ++c) row[c * 32 + lane] = from_f32<T>(acc[i][c] * scale);
  }
}

// ---- pass 2: dk and dv, one block per (b, h, BR keys) ---------------------
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const int* __restrict__ k_lens, const float* __restrict__ m,
                      const float* __restrict__ l, const float* __restrict__ dsum,
                      T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, Strides sq,
                      Strides sk, Strides sv, Strides sg, Strides sdk, Strides sdv, int causal,
                      float scale) {
  constexpr int C = DH / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [BR][DH]
  float* v_s = k_s + BR * DH;        // [BR][DH]
  float* q_s = v_s + BR * DH;        // [BT][DH + 1]
  float* g_s = q_s + BT * (DH + 1);  // [BT][DH + 1]

  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int k0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int klen = k_lens ? min(max(k_lens[b], 0), Tk) : Tk;
  int qstart = 0, qend = Tq;  // query rows this block visits: P is exactly 0 elsewhere
  if (klen > 0) {
    if (k0 >= klen) qend = 0;       // every key of the block is masked
    if (causal) qstart = min(k0, Tq);  // rows before the block's first key
  }

  load_rows<T, DH>(k_s, DH, k + b * sk.b + h * sk.h, sk.t, k0, BR, Tk);
  load_rows<T, DH>(v_s, DH, v + b * sv.b + h * sv.h, sv.t, k0, BR, Tk);
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
    __syncthreads();  // the previous tile is consumed (and k_s, v_s are written)
    load_rows<T, DH>(q_s, DH + 1, qb, sq.t, qt, BT, Tq);
    load_rows<T, DH>(g_s, DH + 1, gb, sg.t, qt, BT, Tq);
    __syncthreads();
    const int qi = qt + lane;  // this lane's query row
    const bool row = qi < Tq;
    const float m_i = row ? m[stat0 + qi] : 0.f;
    const float l_i = row ? l[stat0 + qi] : 1.f;
    const float d_i = row ? dsum[stat0 + qi] : 0.f;

    float s[ROWS], dp[ROWS];  // k_r . q_i and v_r . g_i
    dots<DH>(kr, vr, qr, gr, s, dp);
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
    T* krow = dk + b * sdk.b + j * sdk.t + h * sdk.h;
    T* vrow = dv + b * sdv.b + j * sdv.t + h * sdv.h;
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

template <typename T, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto k1 = flash_bwd_dq_kernel<T, DH>;
  auto k2 = flash_bwd_dkdv_kernel<T, DH>;
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
  k1<<<dim3((a.Tq + BR - 1) / BR, a.H, a.B), THREADS, smem, stream>>>(
      q, k, v, g, a.k_lens, a.m, a.l, a.dsum, static_cast<T*>(a.dq), a.Tq, a.Tk, a.sq, a.sk,
      a.sv, a.sg, a.sdq, a.causal, a.scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k2<<<dim3((a.Tk + BR - 1) / BR, a.H, a.B), THREADS, smem, stream>>>(
      q, k, v, g, a.k_lens, a.m, a.l, a.dsum, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.Tq, a.Tk, a.sq, a.sk, a.sv, a.sg, a.sdk, a.sdv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const Args& a, cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    case 256:
      return launch<T, 256>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, g (B, Tq, H, Dh) and k, v (B, Tk, H, Dh) as the forward took them; dq,
// dk, dv of the same shapes; element strides over (b, t, h), unit stride over
// Dh.  m, l (the forward's row max and row sum) and dsum (scratch, written
// here) are contiguous (B, H, Tq) fp32.  k_lens is (B,) int32 or null (all
// keys valid).  is_bf16 selects __nv_bfloat16 over float for the seven
// tensors.  Launches pass 1 then pass 2 on `stream`.
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
  const cudaError_t e = is_bf16 ? dispatch_dh<__nv_bfloat16>(Dh, a, st) : dispatch_dh<float>(Dh, a, st);
  return static_cast<int>(e);
}
