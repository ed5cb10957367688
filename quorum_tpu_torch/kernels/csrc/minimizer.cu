// HK21 minimizer: the mixed canonical m-mer minimizer of every k-window.
//
// Replaces the TPU path quorum_tpu/ops/mer.py:266 (minimizer_kmers, with
// _mix32_mer :252 and its rolling m-mer pass, mer.rolling_kmers :191).
//
// Design: one block per read (a grid stride over reads), 128 threads,
// walking the read in tiles of 128 window ends. For a tile the block
// stages the tile's codes with the k - 1 before it in shared memory, then
// computes once each m-mer value the tile's windows take,
//   v(q) = mix32(min(fwd m-mer ending at q, its reverse complement)),
// with a mixed value equal to the sentinel 0xFFFFFFFF pinned to
// 0xFFFFFFFE; then each thread takes, for its window end p, the minimum
// of v over the k - m + 1 m-mers of [p-k+1, p] and checks that the
// window is filled (p >= k - 1) and all ACGT (kvalid); the sentinel
// where it is not. An m-mer value inside a kvalid window needs no
// validity of its own; elsewhere it is never read.
//
// Bound: bytes. 1 B of codes read, 4 B of value and 1 B of kvalid written
// a position; the arithmetic (k - m + 1 compares and a few multiplies a
// position) hides under the memory traffic.
#include "table.cuh"

#define MIN_T 128
#define MIN_MAXK 31

__global__ void minimizer_kernel(const int8_t* __restrict__ codes, int b,
                                 int L, int k, int m,
                                 uint32_t* __restrict__ out,
                                 uint8_t* __restrict__ kvalid) {
  __shared__ int8_t sc[MIN_T + MIN_MAXK];   // codes [p0 - k + 1, p0 + T)
  __shared__ uint32_t sv[MIN_T + MIN_MAXK]; // v at [p0 - k + m, p0 + T)
  const int t = threadIdx.x;
  const int span = k - m + 1;
  for (int read = blockIdx.x; read < b; read += gridDim.x) {
    const int8_t* row = codes + (long long)read * L;
    for (int p0 = 0; p0 < L; p0 += MIN_T) {
      __syncthreads();  // the previous tile is done with sc, sv
      for (int i = t; i < MIN_T + k - 1; i += MIN_T) {
        const int at = p0 - (k - 1) + i;
        sc[i] = (at >= 0 && at < L) ? row[at] : (int8_t)-1;
      }
      __syncthreads();
      // v(q) for q = p0 - k + m + i, its m codes at sc[i .. i + m)
      for (int i = t; i < MIN_T + span - 1; i += MIN_T) {
        uint32_t f = 0u, r = 0u;
        for (int j = 0; j < m; ++j) {
          const int c = sc[i + j] < 0 ? 0 : sc[i + j];
          f = (f << 2) | (uint32_t)c;
          r |= (uint32_t)(3 - c) << (2 * j);
        }
        uint32_t v = mix32(f < r ? f : r);
        sv[i] = v == 0xFFFFFFFFu ? 0xFFFFFFFEu : v;
      }
      __syncthreads();
      const int p = p0 + t;
      if (p >= L) continue;
      bool ok = p >= k - 1;
      for (int j = 0; j < k && ok; ++j) ok = sc[t + j] >= 0;
      uint32_t best = 0xFFFFFFFFu;
      if (ok)
        for (int j = 0; j < span; ++j) best = sv[t + j] < best ? sv[t + j] : best;
      out[(long long)read * L + p] = best;
      kvalid[(long long)read * L + p] = ok;
    }
  }
}

extern "C" int minimizer(const int8_t* codes, int b, int L, int k, int m,
                         uint32_t* out, uint8_t* kvalid, void* stream) {
  if (b > 0 && L > 0)
    minimizer_kernel<<<(unsigned)(b < 132 * 16 ? b : 132 * 16), MIN_T, 0,
                       (cudaStream_t)stream>>>(codes, b, L, k, m, out,
                                               kvalid);
  return (int)cudaGetLastError();
}
