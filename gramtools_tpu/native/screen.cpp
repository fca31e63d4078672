// Kmer-presence screen over both read orientations.
//
// Native twin of kmer_index_vec.batch_all_indexed_matrix +
// _filter_buffer_rows's revcomp/matrix assembly (the reference performs
// this screen per read inside its quasimap loop,
// libgramtools/src/genotype/quasimap/quasimap.cpp:90-117 via
// coverage/common.cpp; here it is a host-side pre-filter feeding the
// device engine). The NumPy Horner slide costs ~160 ms per 20k-read
// buffer, and host submit time is on the device engine's critical
// path.
// This kernel fuses revcomp + windowed rolling-code + bitmap lookup
// with early exit, OpenMP over rows.
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// fwd: (n, L) uint8 base codes 1..4 (callers exclude rows containing 0)
// present: 4^k bytes, nonzero = kmer indexed; never null here (k <= 14
//          guard lives in Python)
// oriented: out (2n, L) uint8 -- row 2i = fwd read i, row 2i+1 = its
//           reverse complement (complement code = 5 - c)
// passed: out (2n,) uint8 -- 1 iff every k-window of the row is present
// returns number of passing oriented rows
int64_t gram_tpu_kmer_screen(const uint8_t* fwd, int64_t n, int32_t L,
                             int32_t k, const uint8_t* present,
                             uint8_t* oriented, uint8_t* passed,
                             int32_t num_threads) {
    if (L < k || k <= 0 || k > 14) {
        // populate BOTH outputs on the guard path: callers receive the
        // oriented matrix regardless of pass/fail
        std::memset(passed, 0, (size_t)(2 * n));
        std::memset(oriented, 0, (size_t)(2 * n) * (size_t)L);
        return 0;
    }
    const uint32_t mask = (1u << (2 * k)) - 1;  // k <= 14 guaranteed above
    int64_t total = 0;
#ifdef _OPENMP
    if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(static) reduction(+ : total)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* f = fwd + i * L;
        uint8_t* of = oriented + (2 * i) * L;
        uint8_t* orc = oriented + (2 * i + 1) * L;
        std::memcpy(of, f, L);
        for (int32_t j = 0; j < L; ++j) orc[j] = (uint8_t)(5 - f[L - 1 - j]);
        for (int32_t o = 0; o < 2; ++o) {
            const uint8_t* r = o ? orc : of;
            uint32_t code = 0;
            uint8_t ok = 1;
            for (int32_t j = 0; j < L; ++j) {
                code = ((code << 2) | (uint32_t)(r[j] - 1)) & mask;
                if (j >= k - 1 && !present[code]) {
                    ok = 0;
                    break;
                }
            }
            passed[2 * i + o] = ok;
            total += ok;
        }
    }
    return total;
}

}  // extern "C"
