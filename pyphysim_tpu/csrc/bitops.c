/* Native popcount kernels — host-side fallback for BER counting.
 *
 * The device compute path uses XLA's `population_count` (see
 * pyphysim_tpu/utils/misc.py:count_bits); this tiny C library is the
 * native equivalent of the reference's numba ufunc
 * (pyphysim/util/misc.py:449-476) and its intended-but-missing Cython
 * extension (build.py:10-13), for host-only / numpy code paths.
 *
 * Built on demand by pyphysim_tpu/utils/_bitops.py via cc; loaded with
 * ctypes (no pybind11 in this environment).
 */

#include <stdint.h>
#include <stddef.h>

void popcount_u64(const uint64_t *in, int64_t *out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        out[i] = (int64_t)__builtin_popcountll(in[i]);
    }
}

void popcount_u32(const uint32_t *in, int64_t *out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        out[i] = (int64_t)__builtin_popcount(in[i]);
    }
}

/* Fused xor+popcount+sum — the whole `count_bit_errors` reduction in one
 * pass (no temporary arrays). */
int64_t count_bit_errors_u64(const uint64_t *a, const uint64_t *b, size_t n) {
    int64_t acc = 0;
    for (size_t i = 0; i < n; ++i) {
        acc += (int64_t)__builtin_popcountll(a[i] ^ b[i]);
    }
    return acc;
}
