// HBM → shared-memory copy pump for an NVIDIA Hopper card (kernel D).
//
// Replaces the Pallas TPU kernel tools/bw_ceiling.py::_pump_kernel_factory
// (pallas_pump), the bandwidth probe of the int8 PLM decode.  Same job:
// stream every byte of W (n_chunks, ch, cols) int8 from device memory into
// on-chip memory, `steps` times over, and return
//   head = sum over steps and chunks of sum(chunk[0:8, 0:128])
// which the TPU kernel returns as one fp32.  Here it is summed in integers
// and written as an int64; the wrapper converts it once, which equals the
// TPU's fp32 running sum while its partial sums stay below 2^24.  The
// kernel also writes
//   all = the int64 sum of EVERY byte that landed in shared memory,
// so a run shows that no copy was skipped, which `head` alone cannot.
//
// What bounds it: bytes.  It moves steps x |W| from device memory
// (151 MB a pass at the tool's shape) and does ~1 integer op per 4 bytes:
// at 3.35 TB/s a pass takes ~45 us, against ~3 us of dp4a work spread over
// 132 SMs.  W at that shape is 3x the 50 MB L2, yet the L2 (not LRU) keeps
// part of it from one pass to the next, so over many passes the rate can
// exceed the memory's; a W of 12x the L2 gives the bare device-memory rate.
//
// What the design does about it (not the TPU kernel's single
// double-buffered stream, which cannot fill an H100):
//  * A persistent grid, one block per SM (128 KB of shared memory each),
//    walks the (pass, tile) sequence with a stride of the grid size; a
//    tile is a contiguous 32 KB slice of a chunk (8 rows at the tool's
//    shape), so each pass sweeps W in order, as the decode's weight
//    stream does.
//  * Each block keeps a ring of STAGES tiles in flight.  One thread fills
//    a stage with the 1-D bulk copy (cp.async.bulk ... mbarrier::
//    complete_tx::bytes, the Hopper form of pltpu.make_async_copy) and its
//    mbarrier counts the bytes; all threads wait on the stage's phase,
//    sum its bytes with dp4a, meet at __syncthreads, and the stage is
//    refilled with the tile STAGES ahead.
//  * Sums stay in registers (int32 per tile, int64 across tiles), then one
//    warp-shuffle and shared-memory reduction and two 64-bit atomics per
//    block.  The wrapper zeroes the two outputs before the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::bulk_copy_g2s;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;

constexpr int THREADS = 256;    // 8 warps; the head region is 8 rows of 32 words
constexpr int STAGES = 4;
constexpr int HEAD_ROWS = 8;
constexpr int HEAD_COLS = 128;  // bytes: 32 words of 4
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == HEAD_ROWS * HEAD_COLS / 4, "one head word per thread");

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__global__ void __launch_bounds__(THREADS, 1)
    pump_kernel(const int8_t* __restrict__ w, long long tiles_per_pass, int tiles_per_chunk,
                int tile_bytes, int cols, long long total_tiles, unsigned long long* head_out,
                unsigned long long* all_out) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ long long red[2][THREADS / 32];

  const int tid = threadIdx.x;
  const long long grid = gridDim.x;
  // this block's tiles are i = blockIdx.x + k * grid, k < n_mine
  const long long n_mine =
      total_tiles > blockIdx.x ? (total_tiles - blockIdx.x + grid - 1) / grid : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  auto fill = [&](long long k) {
    const long long tile = (blockIdx.x + k * grid) % tiles_per_pass;
    const int s = static_cast<int>(k % STAGES);
    mbar_expect_tx(&full[s], tile_bytes);
    bulk_copy_g2s(ring + static_cast<size_t>(s) * tile_bytes, w + tile * tile_bytes, tile_bytes,
                  &full[s]);
  };
  if (tid == 0) {
    for (long long k = 0; k < STAGES && k < n_mine; ++k) fill(k);
  }

  long long acc_all = 0, acc_head = 0;
  for (long long k = 0; k < n_mine; ++k) {
    const int s = static_cast<int>(k % STAGES);
    mbar_wait(&full[s], static_cast<uint32_t>((k / STAGES) & 1));
    const unsigned char* buf = ring + static_cast<size_t>(s) * tile_bytes;
    const int4* vec = reinterpret_cast<const int4*>(buf);
    int part = 0;  // <= 128 bytes of |x| <= 128 per thread and 32 KB tile
    for (int j = tid; j < tile_bytes / 16; j += THREADS) {
      const int4 q = vec[j];
      part = __dp4a(q.x, 0x01010101, part);
      part = __dp4a(q.y, 0x01010101, part);
      part = __dp4a(q.z, 0x01010101, part);
      part = __dp4a(q.w, 0x01010101, part);
    }
    acc_all += part;
    const long long tile = (blockIdx.x + k * grid) % tiles_per_pass;
    if (tile % tiles_per_chunk == 0) {  // the chunk's first rows: its [0:8, 0:128] head
      const int r = tid / (HEAD_COLS / 4), c = (tid % (HEAD_COLS / 4)) * 4;
      acc_head += __dp4a(*reinterpret_cast<const int*>(buf + r * cols + c), 0x01010101, 0);
    }
    __syncthreads();  // every thread is done reading stage s
    if (tid == 0 && k + STAGES < n_mine) {
      // order those generic-proxy reads before the async-proxy refill
      sm90::fence_proxy_async();
      fill(k + STAGES);
    }
  }

  acc_all = warp_sum(acc_all);
  acc_head = warp_sum(acc_head);
  if (tid % 32 == 0) {
    red[0][tid / 32] = acc_all;
    red[1][tid / 32] = acc_head;
  }
  __syncthreads();
  if (tid == 0) {
    long long a = 0, h = 0;
    for (int i = 0; i < THREADS / 32; ++i) {
      a += red[0][i];
      h += red[1][i];
    }
    // two's complement: an unsigned add is the signed add
    atomicAdd(all_out, static_cast<unsigned long long>(a));
    atomicAdd(head_out, static_cast<unsigned long long>(h));
  }
}

}  // namespace

// w: contiguous (n_chunks, ch, cols) int8 on the device; tile_bytes divides
// ch * cols, is a multiple of 16 and holds the chunk's first 8 rows;
// head_out and all_out: one zeroed int64 each.  Returns a cudaError_t.
extern "C" int mt_pump(const void* w, long long n_chunks, int ch, int cols, int tile_bytes,
                       int steps, void* head_out, void* all_out, void* stream) {
  const long long chunk_bytes = static_cast<long long>(ch) * cols;
  const long long tiles_per_pass = n_chunks * (chunk_bytes / tile_bytes);
  const long long total = tiles_per_pass * steps;
  if (total == 0) return cudaSuccess;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int smem = STAGES * tile_bytes;
  err = cudaFuncSetAttribute(pump_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = total < n_sm ? total : n_sm;
  pump_kernel<<<static_cast<unsigned>(grid), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), tiles_per_pass, static_cast<int>(chunk_bytes / tile_bytes),
      tile_bytes, cols, total, static_cast<unsigned long long*>(head_out),
      static_cast<unsigned long long*>(all_out));
  return cudaGetLastError();
}
