// HK14 pack_finish: one stage-2 batch's result in one u32 buffer, the
// batch's single device-to-host copy.
//
// Replaces the TPU path quorum_tpu/models/corrector.py:2038
// (_pack_finish_lean, K14, fused into _correct_core :1916-1920) and the
// status merge of _bwd_epilogue (:1212): a read's status is its forward
// lane's where that is not OK, else its backward lane's.
//
// Layout (_pack_finish_lean's): [maxn][total] [B x start << 16 | end]
// [B x status << 16 | f_n] [B x b_n] [cap x (pos + POS_BIAS) << 16 |
// meta], every field cut to 16 bits; read i's forward then backward
// entries start at the exclusive prefix sum of f_n + b_n; entries past
// cap are dropped (the host sees total > cap and packs again with room),
// and the slots from total to cap are zero. maxn is the longest log, or
// maxe + 1 where HK4 flagged an overflow, which the host refuses.
//
// Design: two launches. One block of 1024 threads scans the B per-read
// totals, each thread a run of ceil(B / 1024) reads (8 at B = 8192), with
// warp shuffles (table.cuh block_excl_scan), writes the per-read words,
// the merged status and each read's offset; then a grid-stride pass, one
// thread per (lane, log slot), writes the live entries from the [2B, maxe]
// log planes with neighbouring threads on neighbouring words, and zeroes
// the rest of the entry area.
//
// Bound: bytes, a few hundred KB a batch (24 B a read and 8 B a live
// entry in, the buffer and the status out), so at the main path's shapes
// a launch's latency, not the card's memory rate, sets its time.
#include "table.cuh"

#define PACK_THREADS 1024
#define POS_BIAS 4

__device__ int block_max(int v) {
  __shared__ int wmax[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL_MASK, v, o));
  if (lane == 0) wmax[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < nw ? wmax[lane] : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      v = max(v, __shfl_xor_sync(FULL_MASK, v, o));
    if (lane == 0) wmax[0] = v;
  }
  __syncthreads();
  return wmax[0];
}

__global__ void pack_head_kernel(const int* __restrict__ start,
                                 const int* __restrict__ end,
                                 const int* __restrict__ status_f,
                                 const int* __restrict__ status_b,
                                 const int* __restrict__ f_n,
                                 const int* __restrict__ b_n,
                                 const int* __restrict__ overflow, int B,
                                 int maxe, uint32_t* __restrict__ buf,
                                 int* __restrict__ status,
                                 long long* __restrict__ offs) {
  const int per = (B + PACK_THREADS - 1) / PACK_THREADS;
  const int i0 = min(B, (int)threadIdx.x * per), i1 = min(B, i0 + per);
  long long sum = 0;
  int mx = 0;
  for (int i = i0; i < i1; ++i) {
    const int fn = f_n[i], bn = b_n[i];
    sum += fn + bn;
    mx = max(mx, max(fn, bn));
  }
  long long total;
  long long off = block_excl_scan(sum, &total);
  mx = block_max(mx);
  uint32_t* h1 = buf + 2;
  uint32_t* h2 = h1 + B;
  uint32_t* h3 = h2 + B;
  for (int i = i0; i < i1; ++i) {
    const int fn = f_n[i], bn = b_n[i];
    const int sf = status_f[i];
    const int st = sf != 0 ? sf : status_b[i];
    status[i] = st;
    offs[i] = off;
    h1[i] = ((uint32_t)start[i] << 16) | ((uint32_t)end[i] & 0xFFFFu);
    h2[i] = ((uint32_t)st << 16) | ((uint32_t)fn & 0xFFFFu);
    h3[i] = (uint32_t)bn & 0xFFFFu;
    off += fn + bn;
  }
  if (threadIdx.x == 0) {
    buf[0] = (uint32_t)(*overflow ? max(mx, maxe + 1) : mx);
    buf[1] = (uint32_t)total;
  }
}

__global__ void pack_entries_kernel(const int* __restrict__ f_n,
                                    const int* __restrict__ b_n,
                                    const int* __restrict__ f_pos,
                                    const int* __restrict__ f_meta,
                                    const int* __restrict__ b_pos,
                                    const int* __restrict__ b_meta, int B,
                                    int maxe, long long cap,
                                    const long long* __restrict__ offs,
                                    uint32_t* __restrict__ buf) {
  uint32_t* flat = buf + 2 + 3ll * B;
  const long long total = buf[1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long slots = 2ll * B * maxe;
  for (long long t = t0; t < slots; t += stride) {
    const int l = (int)(t / maxe), j = (int)(t - (long long)l * maxe);
    const bool bw = l >= B;
    const int i = bw ? l - B : l;
    if (j >= (bw ? b_n[i] : f_n[i])) continue;
    const long long slot = offs[i] + (bw ? f_n[i] : 0) + j;
    if (slot >= cap) continue;
    const long long e = (long long)i * maxe + j;
    const int pos = bw ? b_pos[e] : f_pos[e];
    const int meta = bw ? b_meta[e] : f_meta[e];
    flat[slot] = ((uint32_t)(pos + POS_BIAS) << 16) |
                 ((uint32_t)meta & 0xFFFFu);
  }
  for (long long s = total + t0; s < cap; s += stride) flat[s] = 0;
}

// The two launches are separate C launchers, so that each can be timed
// on its own. offs: scratch of B int64 (each read's first entry).
extern "C" int pack_head(const int* start, const int* end,
                         const int* status_f, const int* status_b,
                         const int* f_n, const int* b_n, const int* overflow,
                         int B, int maxe, uint32_t* buf, int* status,
                         long long* offs, void* stream) {
  pack_head_kernel<<<1, PACK_THREADS, 0, (cudaStream_t)stream>>>(
      start, end, status_f, status_b, f_n, b_n, overflow, B, maxe, buf,
      status, offs);
  return (int)cudaGetLastError();
}

extern "C" int pack_entries(const int* f_n, const int* b_n, const int* f_pos,
                            const int* f_meta, const int* b_pos,
                            const int* b_meta, int B, int maxe,
                            long long cap, const long long* offs,
                            uint32_t* buf, void* stream) {
  const long long slots = 2ll * B * maxe;
  const long long blocks = ((slots > cap ? slots : cap) + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 1 ? 1 : blocks > 4096 ? 4096
                                                                  : blocks);
  pack_entries_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      f_n, b_n, f_pos, f_meta, b_pos, b_meta, B, maxe, cap, offs, buf);
  return (int)cudaGetLastError();
}
