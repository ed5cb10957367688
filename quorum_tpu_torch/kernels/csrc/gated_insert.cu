// HK11 gated_insert: stage-1 counting behind the singleton prefilter's
// sketch, in its two modes.
//
// Replaces the TPU path quorum_tpu/ops/sketch.py:208 (_gated_insert_core)
// and :282 (_gated_insert_wire), the prefiltered twin of HK1's path.
//
// two-pass (sketch.py:224-242): HK1's reads entry with a gate. One thread
// per window end reads its window off the wire (table.cuh wire_window),
// queries the FINISHED sketch (read-only here) and inserts with claim_add
// only when min(cell[a1], cell[a2]) >= 2; an observation that fails the
// gate is counted into dropped_hq / dropped_lq (a block sum, one atomic
// per block and value) and is done. Failed claims report `failed` and the
// key exactly as HK1 does, so the grow loop is unchanged. In a partitioned
// build HK1's partition filter (`part`, `n_parts`) comes BEFORE the gate
// (sketch.py:224-226): a mer another pass owns is neither inserted nor
// counted as dropped, so each dropped observation is counted by one pass.
//
// inline (sketch.py:244-277): one thread per distinct lane of HK9, with
// `old` = the PRE-batch sketch's query of the lane (HK10's query entry,
// run before HK10's update of the same lanes). The gate opens when
// old + min(mult, 2) >= 2; where old == 1 the deferred first observation
// is credited back (+1 hq if the lane saw a high-quality observation in
// this batch, else +1 lq), and the lane's summed counts go in with one
// claim_add. A gated-out lane is counted into the dropped totals and is
// done (deferred to a later batch through the sketch, not pending); a
// lane whose claim fails reports `failed`, and its observations go to the
// grow loop one count each, without the credit (as in the JAX package).
//
// Bound: bytes. two-pass: HK1's bound plus each distinct 32-byte cell
// sector the batch's mers reach, read once. inline: the live lanes and
// `old` read once and a flag each written, plus HK1's tag and counter
// sectors per gated lane.
#include "table.cuh"

__global__ void gated_reads_kernel(Wire w, int k, int rb, int bits,
                                   uint32_t part, uint32_t pmask,
                                   const uint8_t* __restrict__ cells,
                                   uint32_t cmask, uint32_t* tag,
                                   uint32_t* hq, uint32_t* lq,
                                   uint8_t* failed, long long* fkeys,
                                   int* full, unsigned long long* dropped) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long d[2] = {0ull, 0ull};
  if (idx < (long long)w.b * w.L) {
    failed[idx] = 0;
    uint64_t key;
    bool qual;
    KeyParts kp;
    if (wire_window(w, (int)(idx / w.L), (int)(idx % w.L), k, &key,
                    &qual) &&
        (rem_low(kp = key_parts(key, k, rb, bits), bits) & pmask) == part) {
      if (sketch_query(cells, key, cmask) < 2) {
        d[qual ? 0 : 1] = 1ull;
      } else if (!claim_add(tag, hq, lq, kp, qual ? 1u : 0u,
                            qual ? 0u : 1u)) {
        failed[idx] = qual ? 3 : 1;
        fkeys[idx] = (long long)key;
        *full = 1;
      }
    }
  }
  block_add<2>(d, dropped);
}

__global__ void gated_lanes_kernel(const long long* __restrict__ keys,
                                   const uint32_t* __restrict__ lhq,
                                   const uint32_t* __restrict__ llq,
                                   const int* __restrict__ old, long long n,
                                   int k, int rb, int bits, uint32_t* tag,
                                   uint32_t* hq, uint32_t* lq,
                                   uint8_t* failed, int* full,
                                   unsigned long long* dropped) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long d[2] = {0ull, 0ull};
  if (i < n) {
    failed[i] = 0;
    const long long key = keys[i];
    if (key >= 0) {
      const uint32_t h = lhq[i], l = llq[i];
      const int o = old[i];
      const int mult = h + l < 2u ? (int)(h + l) : 2;
      if (o + mult < 2) {
        d[0] = h;
        d[1] = l;
      } else {
        const bool retro = o == 1;
        const uint32_t ah = h + (retro && h > 0u ? 1u : 0u);
        const uint32_t al = l + (retro && h == 0u ? 1u : 0u);
        if (!claim_add(tag, hq, lq, key_parts((uint64_t)key, k, rb, bits),
                       ah, al)) {
          failed[i] = 1;
          *full = 1;
        }
      }
    }
  }
  block_add<2>(d, dropped);
}

extern "C" int gated_insert_reads(const uint8_t* wire, int b, int L,
                                  long long off_nmask, long long off_hq,
                                  long long off_len, int k, int rb, int bits,
                                  int part, int n_parts,
                                  const uint8_t* cells, int cells_log2,
                                  uint32_t* tag, uint32_t* hq, uint32_t* lq,
                                  uint8_t* failed, long long* fkeys,
                                  int* full, unsigned long long* dropped,
                                  void* stream) {
  const long long n = (long long)b * L;
  const uint32_t cmask = (uint32_t)((1ull << cells_log2) - 1ull);
  if (n > 0)
    gated_reads_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
        Wire{wire, b, L, off_nmask, off_hq, off_len}, k, rb, bits,
        (uint32_t)part, (uint32_t)(n_parts - 1), cells, cmask, tag, hq, lq,
        failed, fkeys, full, dropped);
  return (int)cudaGetLastError();
}

extern "C" int gated_insert_lanes(const long long* keys, const uint32_t* lhq,
                                  const uint32_t* llq, const int* old,
                                  long long n, int k, int rb, int bits,
                                  uint32_t* tag, uint32_t* hq, uint32_t* lq,
                                  uint8_t* failed, int* full,
                                  unsigned long long* dropped, void* stream) {
  if (n > 0)
    gated_lanes_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
        keys, lhq, llq, old, n, k, rb, bits, tag, hq, lq, failed, full,
        dropped);
  return (int)cudaGetLastError();
}
