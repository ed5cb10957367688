// Native FASTQ chunk parser + 2-bit encoder.
//
// The host-side analogue of the reference's C++ parsing layer
// (Jellyfish stream_manager + whole_sequence_parser, used at
// src/create_database.cc:27-28 and src/error_correct_reads.cc:127):
// the Python reader feeds decompressed byte chunks; this scanner
// consumes complete strict 4-line FASTQ records, encoding bases to
// 2-bit codes (-1 for non-ACGT) and copying raw quality bytes into
// caller-allocated fixed-stride arrays. Multi-line FASTQ and FASTA
// fall back to the pure-Python parser (io/fastq.py) — this is the fast
// path for the dominant format, not a second grammar implementation.
// (A copy of quorum_tpu/native/fastq_parser.cpp; the port keeps its own.)
//
// Build: g++ -O2 -shared -fPIC fastq_parser.cpp -o libqtfastq.so
// (done on demand by quorum_tpu_torch/native/binding.py into
// quorum_tpu_torch/_build/, under a name keyed by this file's hash).

#include <cstdint>
#include <cstring>

namespace {

inline const char* find_nl(const char* p, const char* end) {
    return static_cast<const char*>(memchr(p, '\n', end - p));
}

signed char CODE[256];

struct CodeInit {
    CodeInit() {
        memset(CODE, -1, sizeof(CODE));
        CODE[(unsigned)'A'] = 0; CODE[(unsigned)'a'] = 0;
        CODE[(unsigned)'C'] = 1; CODE[(unsigned)'c'] = 1;
        CODE[(unsigned)'G'] = 2; CODE[(unsigned)'g'] = 2;
        CODE[(unsigned)'T'] = 3; CODE[(unsigned)'t'] = 3;
    }
} code_init;

}  // namespace

extern "C" {

// Parse complete 4-line FASTQ records from buf[0:len).
//
// Outputs (caller-allocated):
//   codes  [cap_reads * stride] int8: 2-bit codes, -1 non-ACGT,
//          -2 padding beyond each read's length
//   quals  [cap_reads * stride] uint8: raw quality bytes, 0 padding
//   lengths[cap_reads] int32
//   hdr_off/hdr_len: header byte ranges within buf (after '@')
//
// Returns the number of records parsed (<= cap_reads), or:
//   -1  malformed input (not strict 4-line FASTQ) -> caller falls back
//   -2  a read longer than `stride`
// *consumed is set to the number of bytes of buf fully processed; the
// caller carries the remainder into the next chunk. With eof set, a
// trailing partial record is malformed (-1).
long qt_parse(const char* buf, long len, int eof,
              signed char* codes, unsigned char* quals,
              int32_t* lengths, int64_t* hdr_off, int32_t* hdr_len,
              int32_t cap_reads, int32_t stride, int64_t* consumed) {
    const char* p = buf;
    const char* end = buf + len;
    long n = 0;
    *consumed = 0;
    while (n < cap_reads) {
        const char* rec = p;
        if (rec == end) break;
        if (*rec != '@') return -1;
        const char* h_end = find_nl(rec, end);
        if (!h_end) { if (eof) return -1; break; }
        const char* seq = h_end + 1;
        const char* s_end = find_nl(seq, end);
        if (!s_end) { if (eof) return -1; break; }
        const char* plus = s_end + 1;
        const char* p_end = find_nl(plus, end);
        if (!p_end) { if (eof) return -1; break; }
        if (plus == p_end || *plus != '+') return -1;
        const char* qual = p_end + 1;
        const char* q_end = find_nl(qual, end);
        if (!q_end) {
            if (!eof) break;
            q_end = end;  // final record may lack trailing newline
            if (q_end == qual) return -1;
        }
        long slen = s_end - seq;
        long qlen = q_end - qual;
        if (slen != qlen) return -1;  // multi-line or corrupt -> fallback
        if (slen > stride) return -2;
        // strip possible '\r'
        if (slen > 0 && seq[slen - 1] == '\r') { --slen; --qlen; }
        signed char* crow = codes + (int64_t)n * stride;
        unsigned char* qrow = quals + (int64_t)n * stride;
        for (long i = 0; i < slen; ++i)
            crow[i] = CODE[(unsigned char)seq[i]];
        memset(crow + slen, -2, stride - slen);
        memcpy(qrow, qual, qlen);
        memset(qrow + qlen, 0, stride - qlen);
        lengths[n] = (int32_t)slen;
        long hl = h_end - rec - 1;
        if (hl > 0 && rec[hl] == '\r') --hl;
        hdr_off[n] = (rec + 1) - buf;
        hdr_len[n] = (int32_t)hl;
        ++n;
        p = (q_end == end) ? end : q_end + 1;
        *consumed = p - buf;
    }
    return n;
}

}  // extern "C"
