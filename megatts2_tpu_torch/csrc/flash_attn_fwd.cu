// Masked attention forward with an online softmax, for an NVIDIA Hopper card.
//
// Replaces the Pallas TPU kernel megatts2_tpu/ops/attention_pallas.py::
// flash_attention (also the forward of flash_attention_vjp).  Same function:
// softmax(Q K^T * Dh^-0.5) V on (B, T, H, Dh) tensors, where logits at
// masked positions are REPLACED by the finite -1e9 (not -inf).  The mask is
// built in the kernel from a per-batch key length k_lens[b] and an optional
// causal flag.  Inputs are fp32 or bf16; both products accumulate in fp32,
// P stays fp32 for P V, and the output is written in the input dtype.
//
// What bounds it on the card: at the slice's shape (8, 64, 2, 256) the whole
// problem is ~34 MFLOP over 16 (batch, head) pairs, so launch latency and
// the dependent chain of shared-memory reads bound it, not FLOPs or bytes.
// At long sequences it becomes FMA-issue bound, since this first version
// uses no tensor cores.
//
// What the design does about it (simple and right first):
//  * The TPU kernel holds the whole K/V panel in VMEM per 128-row q block.
//    That does not fit Hopper's 227 KB of shared memory in general, so K/V
//    stream through shared memory in 32-key tiles, converted to fp32, with
//    a running max and sum per row in fp32 (online softmax).
//  * A block takes BQ = 16 query rows of one (b, h): 4 warps of 4 rows.
//    For Q K^T lane j owns key j of the tile and runs the whole Dh dot,
//    reading K rows padded by one float, so the 32 lanes hit 32 banks.  For
//    P V lane l owns output dims l, l + 32, ...: P broadcasts by shuffle and
//    V rows are read unpadded, consecutive lanes on consecutive words.
//  * Tensors are read in place through their (b, t, h) strides; nothing is
//    transposed.  Ragged Tq and Tk edges are masked in the kernel.
//  * Tiles past k_len (and past the block's last row when causal) are
//    skipped.  That is exact only when the row keeps at least one key:
//    exp(-1e9 - m) then underflows to exactly 0.  A row has no key only
//    when k_len == 0; then all Tk keys take part and the row gives the mean
//    of V, as the TPU kernel does, never NaN.
//  * For the backward (kernel C) the kernel can also write each row's final
//    max m and sum l, fp32 (B, H, Tq); with null pointers it writes neither.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ k_lens,
                 T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 int Tq, int Tk, Strides sq, Strides sk, Strides sv, Strides so,
                 int causal, float scale) {
  constexpr int C = DH / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BQ][DH]
  float* k_s = q_s + BQ * DH;        // [BK][DH + 1]
  float* v_s = k_s + BK * (DH + 1);  // [BK][DH]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
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
  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int qi = q0 + r;
    q_s[idx] = qi < Tq ? to_f32(qb[qi * sq.t + d]) : 0.f;
  }

  float m_i[ROWS], l_i[ROWS], acc[ROWS][C];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < kend; kt += BK) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int r = idx / DH, d = idx % DH;
      const int j = kt + r;
      const bool in = j < Tk;
      k_s[r * (DH + 1) + d] = in ? to_f32(kb[j * sk.t + d]) : 0.f;
      v_s[r * DH + d] = in ? to_f32(vb[j * sv.t + d]) : 0.f;
    }
    __syncthreads();

    // logits for key j = kt + lane against this warp's ROWS rows
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float* kr = k_s + lane * (DH + 1);
    const float* qr = q_s + warp * ROWS * DH;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) s[i] = fmaf(qr[i * DH + d], kd, s[i]);
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
    T* orow = o + b * so.b + qi * so.t + h * so.h;
    if (m_out && lane == 0) {
      const long long r = (static_cast<long long>(b) * gridDim.y + h) * Tq + qi;
      m_out[r] = m_i[i];
      l_out[r] = l_i[i];
    }
    const float inv = 1.f / l_i[i];
#pragma unroll
    for (int c = 0; c < C; ++c) orow[c * 32 + lane] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* k_lens,
                   void* o, float* m_out, float* l_out, int B, int Tq, int Tk, int H,
                   Strides sq, Strides sk, Strides sv, Strides so, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = flash_fwd_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      k_lens, static_cast<T*>(o), m_out, l_out, Tq, Tk, sq, sk, sv, so, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        const int* k_lens, void* o, float* m_out, float* l_out, int B,
                        int Tq, int Tk, int H, Strides sq, Strides sk, Strides sv,
                        Strides so, int causal, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch<T, 64>(q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk, sv, so,
                           causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk, sv, so,
                            causal, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq, sk, sv, so,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Tq, H, Dh), k and v (B, Tk, H, Dh), o (B, Tq, H, Dh): element strides
// over (b, t, h), unit stride over Dh.  k_lens is (B,) int32 or null (all
// keys valid).  is_bf16 selects __nv_bfloat16 over float for all four.
// m_out and l_out are (B, H, Tq) fp32 for the row max and sum, or both null.
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
  const cudaError_t e =
      is_bf16 ? dispatch_dh<__nv_bfloat16>(Dh, q, k, v, k_lens, o, m_out, l_out, B, Tq,
                                           Tk, H, sq, sk, sv, so, causal, scale, st)
              : dispatch_dh<float>(Dh, q, k, v, k_lens, o, m_out, l_out, B, Tq, Tk, H, sq,
                                   sk, sv, so, causal, scale, st);
  return static_cast<int>(e);
}
