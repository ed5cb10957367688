// HK10 sketch_update: the count-min sketch of the singleton prefilter --
// its update over a batch's distinct lanes, and its query.
//
// Replaces the TPU path quorum_tpu/ops/sketch.py:135 (_sketch_update_lanes:
// per hash, a gather of the old cells, a saturating add and a scatter-max),
// sketch_min :129 with sketch_addrs :119, and with HK9 the pass-1 program
// _sketch_pass_wire :180.
//
// The update is two phases, hash 1 then hash 2, and phase 2 reads what
// phase 1 wrote (the JAX loop gathers `old` from the cells the previous
// scatter updated). Within a phase every cell c the batch touches becomes
//   new[c] = max(old[c], min(2, old[c] + t[c])) = min(2, old[c] + t[c]),
// t[c] = the largest min(mult, 2) of the distinct lanes hashing to c. A
// saturating atomic per observation (or per lane) would compute a sum
// instead: two distinct count-1 mers in one cell must give 1, not 2.
//
// Design, per phase: launch 1 ORs a touch code into bits 2-3 of the
// lane's cell byte through its 32-bit word (bit 2: t >= 1, bit 3: t = 2),
// so the byte holds the cell's old value (bits 0-1) and t[c]; launch 2
// reads the byte and writes min(2, old + t), clearing the touch bits.
// Launch 2 is idempotent -- a lane that finds the cell already rewritten
// reads t = 0 and writes the same value -- so lanes that share a cell
// agree without atomics. The query entry gathers min(cell[a1], cell[a2])
// per lane (0 for an invalid lane).
//
// Bound: bytes. The live lanes read once, and each distinct 32-byte
// sector of cells that the lanes' two hashes reach read and written once
// (the cells are 1 GiB at the full run's size, far beyond L2).
#include "table.cuh"

__global__ void touch_kernel(const long long* __restrict__ keys,
                             const uint32_t* __restrict__ hq,
                             const uint32_t* __restrict__ lq, long long n,
                             int h, uint32_t mask, uint32_t* words) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || keys[i] < 0) return;
  const uint32_t code = hq[i] + lq[i] >= 2u ? 0xCu : 0x4u;
  const uint32_t a = sketch_addr((uint64_t)keys[i], h, mask);
  atomicOr(words + (a >> 2), code << (8 * (a & 3u)));
}

__global__ void apply_kernel(const long long* __restrict__ keys, long long n,
                             int h, uint32_t mask, uint8_t* cells) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || keys[i] < 0) return;
  const uint32_t a = sketch_addr((uint64_t)keys[i], h, mask);
  const uint32_t c = *reinterpret_cast<volatile uint8_t*>(cells + a);
  const uint32_t t = (c & 0x8u) ? 2u : ((c >> 2) & 1u);
  const uint32_t v = (c & 3u) + t;
  cells[a] = (uint8_t)(v < 2u ? v : 2u);
}

__global__ void query_kernel(const long long* __restrict__ keys, long long n,
                             uint32_t mask, const uint8_t* __restrict__ cells,
                             int* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = keys[i] < 0 ? 0 : sketch_query(cells, (uint64_t)keys[i], mask);
}

extern "C" int sketch_update(const long long* keys, const uint32_t* hq,
                             const uint32_t* lq, long long n, int cells_log2,
                             uint8_t* cells, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t mask = (uint32_t)((1ull << cells_log2) - 1ull);
  const unsigned grid = (unsigned)((n + 255) / 256);
  for (int h = 0; h < 2 && n > 0; ++h) {
    touch_kernel<<<grid, 256, 0, st>>>(keys, hq, lq, n, h, mask,
                                       reinterpret_cast<uint32_t*>(cells));
    apply_kernel<<<grid, 256, 0, st>>>(keys, n, h, mask, cells);
  }
  return (int)cudaGetLastError();
}

extern "C" int sketch_min(const long long* keys, long long n, int cells_log2,
                          const uint8_t* cells, int* out, void* stream) {
  const uint32_t mask = (uint32_t)((1ull << cells_log2) - 1ull);
  if (n > 0)
    query_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>(keys, n, mask, cells, out);
  return (int)cudaGetLastError();
}
