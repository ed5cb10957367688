// HK3 tile_lookup: batched exact lookup in the sealed tile table, on one
// card's plane or, as its shard entry, on a table sharded by leading row
// bits (the routed stage-2 layout of --devices N).
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:677 (tile_lookup_impl,
// jitted as tile_lookup :700 and inside _tile_parts_jit :1387 /
// corrector._position_sweep). The shard entry replaces
// quorum_tpu/parallel/tile_sharded.py:706 (routed_lookup_local: bucket
// the queries by owner, all_to_all, answer in the owner's local row,
// all_to_all back) and :752 (query_step, its mesh-wide caller).
//
// Design: one thread per canonical key hashes it (table.cuh key_parts)
// and probes its one 512-byte row with 16-byte vector loads, stopping at
// the match; the same __device__ probe serves HK4 and HK5. A warp per
// probe would coalesce the row read; this first version keeps one thread
// per key. The shard entry keeps the table where it is: the probe takes
// owner = addr >> local_rb and reads the row addr & (2^local_rb - 1) of
// that shard's plane (table.cuh ShardRows), over NVLink where the shard
// lies on another card (peer access, enable_peer_access below), so the
// two all_to_all exchanges and their bucket scratch have no counterpart.
// The answer is routed_lookup_local's: the key's (count << 1) | qual in
// its owner's row, else 0.
//
// Bound: bytes. 8 B of key in and 8 B of value out per lookup, plus one
// read of each 512-byte row touched; the same for the shard entry, whose
// pointer table is one 520-byte kernel parameter read from the constant
// bank (nothing per key).
#include "table.cuh"

template <class Acc>
__global__ void lookup_kernel(const __grid_constant__ Acc rows,
                              const long long* __restrict__ keys, long long n,
                              int k, int rb, int bits,
                              long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = probe(rows, (uint64_t)keys[i], k, rb, bits);
}

template <class Acc>
static int launch_lookup(const Acc& rows, const long long* keys, long long n,
                         int k, int rb, int bits, long long* out,
                         void* stream) {
  if (n > 0)
    lookup_kernel<Acc><<<(unsigned)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(rows, keys, n, k, rb, bits,
                                                 out);
  return (int)cudaGetLastError();
}

extern "C" int tile_lookup(const uint32_t* rows, const long long* keys,
                           long long n, int k, int rb, int bits,
                           long long* out, void* stream) {
  return launch_lookup(PlaneRows{rows}, keys, n, k, rb, bits, out, stream);
}

// `shards`: a host array of n_shards plane pointers (2^local_rb rows
// each); rb is the GLOBAL geometry.
extern "C" int tile_lookup_shard(const uint32_t* const* shards, int n_shards,
                                 int local_rb, const long long* keys,
                                 long long n, int k, int rb, int bits,
                                 long long* out, void* stream) {
  ShardRows acc;
  if (!shard_rows(shards, n_shards, local_rb, &acc))
    return (int)cudaErrorInvalidValue;
  return launch_lookup(acc, keys, n, k, rb, bits, out, stream);
}

// Let kernels on `dev` read memory of `peer` (the routed layout's shard
// planes), once per ordered pair; "already enabled" is success. The
// calling thread's current device is restored.
extern "C" int enable_peer_access(int dev, int peer) {
  int cur;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the sticky-free error
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : back);
}
