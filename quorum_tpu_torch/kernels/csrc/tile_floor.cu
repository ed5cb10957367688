// HK12 tile_floor: the stage-2 presence floor on the sealed table.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1608 (tile_floor) and
// :1631 (_tile_floor_jit): an entry whose stored count (lo & max_val) is
// below the floor has both of its words zeroed.
//
// Design: in place on the sealed [rows, 128] u32 plane (the in-process
// handoff table and the HK7-loaded table alike), one thread per 16-byte
// vector = two (lo, hi) slot pairs, a grid-stride loop; a vector is
// written back only where an entry that was present goes.
//
// Bound: bytes. The rows read once (2 GiB at the full run's 2^22 rows),
// and each 32-byte sector that holds a dropped entry written once.
#include "table.cuh"

__global__ void floor_kernel(uint4* rows, long long n4, uint32_t maxv,
                             uint32_t floor) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    uint4 v = rows[i];
    const bool drop0 = (v.x & maxv) < floor && (v.x | v.y) != 0u;
    const bool drop1 = (v.z & maxv) < floor && (v.z | v.w) != 0u;
    if (!(drop0 || drop1)) continue;
    if (drop0) v.x = v.y = 0u;
    if (drop1) v.z = v.w = 0u;
    rows[i] = v;
  }
}

extern "C" int tile_floor(uint32_t* rows, long long nrows, int bits,
                          int floor, void* stream) {
  const long long n4 = nrows * (TILE_WORDS / 4);
  const long long blocks = (n4 + 255) / 256;
  if (n4 > 0)
    floor_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                   (cudaStream_t)stream>>>(
        reinterpret_cast<uint4*>(rows), n4, (1u << bits) - 1u,
        (uint32_t)floor);
  return (int)cudaGetLastError();
}
