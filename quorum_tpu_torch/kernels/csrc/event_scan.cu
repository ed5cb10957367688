// HK17 event_scan: HK16's per-window planes -> the frame planes the event
// walk reads.
//
// Replaces the TPU path quorum_tpu/models/corrector.py:1670-1705 (the
// remap and scans of _event_planes): rc_map (the reverse-complement
// frame's row: the window ending at frame position p' is the read's
// window ending at len + k - 2 - p', through _rev_rows :1160), nd as a
// reverse cummin of the clean plane, lastc1 as a cummax of the
// prev-defining keeps, and prevval, the own count at lastc1.
//
// Design: one warp per frame row, 2B rows of L (forward rows then
// reverse-complement rows, JAX's order). The warp walks its row in
// chunks of 32 positions, a lane a position: a forward lane gathers from
// the same position, a reverse-complement lane from its mirror (fill
// outside the read), and writes the row's clean, cnt, aux and mer planes,
// coalesced. lastc1/prevval are a running scan left to right: a ballot of
// the chunk's prev-defining keeps gives each lane the last one at or
// before it, a shuffle brings that lane's count, and the chunk's last lane
// carries both into the next chunk. nd is the same scan right to left on
// the non-clean positions, carrying the first one at or after the chunk.
//
// Bound: bytes. HK16's planes are read once (29 bytes a window, the
// reverse-complement rows gather the same windows again) and the frame
// planes written once (37 bytes a frame position).
#include <cstdint>
#include <cuda_runtime.h>

#define AX_C1K 7
#define SCAN_WARPS 4
#define FULL 0xFFFFFFFFu

__global__ void event_scan_kernel(
    const uint8_t* __restrict__ clean, const int* __restrict__ cnt,
    const int* __restrict__ aux, const int* __restrict__ val,
    const long long* __restrict__ f, const long long* __restrict__ r,
    const int* __restrict__ lengths, int B, int L, int k,
    uint8_t* __restrict__ clean2, int* __restrict__ nd,
    int* __restrict__ cnt2, int* __restrict__ aux2,
    int* __restrict__ lastc1, int* __restrict__ prevval,
    long long* __restrict__ mf2, long long* __restrict__ mr2) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5);
  if (row >= 2 * B) return;  // whole warps
  const bool rcf = row >= B;
  const int i = rcf ? row - B : row;
  const int len = lengths[i];
  const size_t in0 = (size_t)i * L, out0 = (size_t)row * L;
  // the source window of frame position p, or -1 outside the read
  auto src = [&](int p) {
    if (!rcf) return p;
    const int e = len + k - 2 - p;
    return e >= 0 && e < len ? e : -1;
  };
  int carry_lc = -1, carry_pv = 0;
  for (int base = 0; base < L; base += 32) {
    const int p = base + lane;
    bool c1k = false;
    int co = 0;
    if (p < L) {
      const int e = src(p);
      const bool in = e >= 0;
      const int ax = in ? aux[in0 + e] : 0;
      co = in ? (int)((uint32_t)val[in0 + e] >> 1) : 0;
      c1k = (ax >> AX_C1K) & 1;
      clean2[out0 + p] = in ? clean[in0 + e] : 0;
      cnt2[out0 + p] = in ? cnt[in0 + e] : 0;
      aux2[out0 + p] = ax;
      // the frame's forward word is the window's reverse one in an rc row
      mf2[out0 + p] = in ? (rcf ? r[in0 + e] : f[in0 + e]) : 0;
      mr2[out0 + p] = in ? (rcf ? f[in0 + e] : r[in0 + e]) : 0;
    }
    if (base == 0) carry_pv = __shfl_sync(FULL, co, 0);  // prevval at -1
    const unsigned m = __ballot_sync(FULL, c1k) & ((2u << lane) - 1u);
    const int sl = m ? 31 - __clz(m) : 0;
    const int pv = __shfl_sync(FULL, co, sl);
    const int lc = m ? base + sl : carry_lc;
    const int pvl = m ? pv : carry_pv;
    if (p < L) {
      lastc1[out0 + p] = lc;
      prevval[out0 + p] = pvl;
    }
    carry_lc = __shfl_sync(FULL, lc, 31);
    carry_pv = __shfl_sync(FULL, pvl, 31);
  }
  int carry_nd = L;
  for (int base = ((L - 1) / 32) * 32; base >= 0; base -= 32) {
    const int p = base + lane;
    bool ev = false;
    if (p < L) {
      const int e = src(p);
      ev = !(e >= 0 && clean[in0 + e]);
    }
    const unsigned all = __ballot_sync(FULL, ev);
    const unsigned m = all & ~((1u << lane) - 1u);  // lanes >= this one
    if (p < L) nd[out0 + p] = m ? base + __ffs(m) - 1 : carry_nd;
    if (all) carry_nd = base + __ffs(all) - 1;
  }
}

extern "C" int event_scan(const uint8_t* clean, const int* cnt,
                          const int* aux, const int* val, const long long* f,
                          const long long* r, const int* lengths, int B,
                          int L, int k, uint8_t* clean2, int* nd, int* cnt2,
                          int* aux2, int* lastc1, int* prevval,
                          long long* mf2, long long* mr2, void* stream) {
  if (B > 0 && L > 0)
    event_scan_kernel<<<(unsigned)((2 * B + SCAN_WARPS - 1) / SCAN_WARPS),
                        32 * SCAN_WARPS, 0, (cudaStream_t)stream>>>(
        clean, cnt, aux, val, f, r, lengths, B, L, k, clean2, nd, cnt2, aux2,
        lastc1, prevval, mf2, mr2);
  return (int)cudaGetLastError();
}
