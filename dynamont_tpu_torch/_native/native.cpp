// Native host-side runtime for dynamont-tpu.
//
// The TPU computes the DP matrices (posterior probabilities + Viterbi choice
// bits); what remains on the host per read is inherently sequential pointer
// chasing and light streaming work, which is what lives here:
//   * banded MAP traceback  (ref: src/cpp/NT_banded.cpp:204-250)
//   * full-lattice MAP traceback (ref: src/cpp/NT.cpp:146-177)
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in this
// image). Batch entry points parallelize across reads with OpenMP.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Median of v[0..n) with the reference semantics (sort; odd -> middle,
// even -> mean of the two middles). Scratch is caller-provided.
static double median_of(double *v, int64_t n) {
    std::sort(v, v + n);
    if (n % 2 == 1) return v[n / 2];
    return (v[n / 2 - 1] + v[n / 2]) / 2.0;
}

// Banded traceback for one read.
//   choices: (T_pad, B) uint8 Viterbi predicate bits
//   PM, PE : (T_pad, B) float32 posterior probabilities
//   bstart : (T_pad,) int32 band starts
// Returns the number of segments written; out arrays must hold >= N entries.
// Segments are emitted in read order (basepos ascending).
int64_t banded_traceback(const uint8_t *choices, const float *PM,
                         const float *PE, const int32_t *bstart, int64_t B,
                         int64_t T, int64_t N, int64_t bw, int64_t kmer_half,
                         int32_t *out_basepos, int32_t *out_start,
                         double *out_median) {
    std::vector<double> probs;
    probs.reserve(1024);
    int64_t t = T - 1, n = N - 1, j = bw + 1;
    bool is_m = false;
    int64_t nseg = 0;
    while (t && n) {
        const int64_t s = (bstart[t] != bstart[t - 1]) ? 1 : 0;
        if (is_m) {
            probs.push_back((double)PM[t * B + j]);
            out_basepos[nseg] = (int32_t)(n - 1 + kmer_half);
            out_start[nseg] = (int32_t)(t - 1);
            out_median[nseg] = median_of(probs.data(), (int64_t)probs.size());
            ++nseg;
            probs.clear();
            --t;
            --n;
            j = j - 1 + s;
            is_m = false;
        } else {
            probs.push_back((double)PE[t * B + j]);
            is_m = choices[t * B + j] != 0;
            --t;
            j = j + s;
        }
    }
    // reverse into read order
    for (int64_t a = 0, b = nseg - 1; a < b; ++a, --b) {
        std::swap(out_basepos[a], out_basepos[b]);
        std::swap(out_start[a], out_start[b]);
        std::swap(out_median[a], out_median[b]);
    }
    return nseg;
}

// Batched banded traceback over R reads with OpenMP.
// All per-read matrices are slices of one (R, T_pad, B) block; per-read true
// sizes come from the T/N/bw arrays. out_counts[r] receives the segment count
// and the segment arrays are written at offset r*max_segments.
void banded_traceback_batch(const uint8_t *choices, const float *PM,
                            const float *PE, const int32_t *bstart,
                            int64_t R, int64_t T_pad, int64_t B,
                            const int32_t *T, const int32_t *N,
                            const int32_t *bw, int64_t kmer_half,
                            int64_t max_segments, int32_t *out_basepos,
                            int32_t *out_start, double *out_median,
                            int64_t *out_counts) {
#pragma omp parallel for schedule(dynamic)
    for (int64_t r = 0; r < R; ++r) {
        out_counts[r] = banded_traceback(
            choices + r * T_pad * B, PM + r * T_pad * B, PE + r * T_pad * B,
            bstart + r * T_pad, B, T[r], N[r], bw[r], kmer_half,
            out_basepos + r * max_segments, out_start + r * max_segments,
            out_median + r * max_segments);
    }
}

// Full-lattice traceback (ref: NT.cpp:146-177). Matrices are (T, N) row-major.
int64_t nt_traceback(const uint8_t *choices, const float *PM, const float *PE,
                     int64_t T, int64_t N, int64_t kmer_half,
                     int32_t *out_basepos, int32_t *out_start,
                     double *out_median) {
    std::vector<double> probs;
    probs.reserve(1024);
    int64_t t = T - 1, n = N - 1;
    bool is_m = false;
    int64_t nseg = 0;
    while (t && n) {
        if (is_m) {
            probs.push_back((double)PM[t * N + n]);
            out_basepos[nseg] = (int32_t)(n - 1 + kmer_half);
            out_start[nseg] = (int32_t)(t - 1);
            out_median[nseg] = median_of(probs.data(), (int64_t)probs.size());
            ++nseg;
            probs.clear();
            --t;
            --n;
            is_m = false;
        } else {
            probs.push_back((double)PE[t * N + n]);
            is_m = choices[t * N + n] != 0;
            --t;
        }
    }
    for (int64_t a = 0, b = nseg - 1; a < b; ++a, --b) {
        std::swap(out_basepos[a], out_basepos[b]);
        std::swap(out_start[a], out_start[b]);
        std::swap(out_median[a], out_median[b]);
    }
    return nseg;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// NTC 5-state traceback over the static candidate-slot layout
// (ref: src/cpp/NTC.cpp:691-904; mirrors ops/ntc_viterbi.ntc_traceback).
// ---------------------------------------------------------------------------

extern "C" {

namespace {

struct SlotView {
    const double *apsei;   // (T, 5, CN, CK)
    const double *logp;
    const int32_t *cand_n; // (T, CN) sorted asc, sentinel >= N
    const int32_t *ks;     // (T, CK) sorted asc, sentinel >= K
    const uint8_t *allowed; // (T, CN, CK)
    int64_t T, CN, CK;

    // slot of value v in sorted row (first occurrence), -1 if absent
    static int64_t find(const int32_t *row, int64_t len, int32_t v) {
        int64_t lo = 0, hi = len;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (row[mid] < v) lo = mid + 1; else hi = mid;
        }
        return (lo < len && row[lo] == v) ? lo : -1;
    }

    double get(const double *mat, int64_t t, int64_t n, int64_t k,
               int64_t state) const {
        if (t < 0 || t >= T) return -INFINITY;
        const int64_t i = find(cand_n + t * CN, CN, (int32_t)n);
        if (i < 0) return -INFINITY;
        const int64_t j = find(ks + t * CK, CK, (int32_t)k);
        if (j < 0) return -INFINITY;
        if (!allowed[(t * CN + i) * CK + j]) return -INFINITY;
        return mat[((t * 5 + state) * CN + i) * CK + j];
    }
    double ap(int64_t t, int64_t n, int64_t k, int64_t s) const {
        return get(apsei, t, n, k, s);
    }
    double lp(int64_t t, int64_t n, int64_t k, int64_t s) const {
        return get(logp, t, n, k, s);
    }
};

}  // namespace

// Returns segment count, or -1 on a backtrace error. Outputs sized >= T+N.
// States: 0 A, 1 P, 2 S, 3 E, 4 I (ref legend NTC.cpp:699-703).
// out_state: 0 = 'M' line, 1 = 'P' line.
int64_t ntc_traceback(const double *apsei, const double *logp,
                      const int32_t *cand_n, const int32_t *ks,
                      const uint8_t *allowed, int64_t T, int64_t N, int64_t K,
                      int64_t CN, int64_t CK, int64_t alphabet_size,
                      int64_t kmer_size, int64_t start_k, int32_t *out_state,
                      int32_t *out_basepos, int32_t *out_start,
                      double *out_median, int32_t *out_polish) {
    SlotView v{apsei, logp, cand_n, ks, allowed, T, CN, CK};
    const int64_t half = kmer_size / 2;
    const int64_t step = K / alphabet_size;
    int64_t t = T - 1, n = N - 1, k = start_k;
    int64_t state = 3;  // E
    std::vector<double> probs;
    probs.reserve(1024);
    int64_t nseg = 0;
    auto emit = [&](int32_t st, int64_t basepos, int64_t start) {
        out_state[nseg] = st;
        out_basepos[nseg] = (int32_t)basepos;
        out_start[nseg] = (int32_t)start;
        out_median[nseg] =
            probs.empty() ? 0.0 : median_of(probs.data(), (int64_t)probs.size());
        out_polish[nseg] = (int32_t)k;
        ++nseg;
        probs.clear();
    };
    int64_t guard = 2 * (T + N) + 10;
    while (t) {
        if (--guard < 0) return -1;
        if (state == 3) {  // E
            if (t == 1) {
                emit(0, half, 0);
                break;
            }
            const double sc = v.ap(t, n, k, 3);
            const double ls = v.lp(t, n, k, 3);
            probs.push_back(std::exp(ls));
            if (sc == v.ap(t - 1, n, k, 3) + ls) state = 3;
            else if (sc == v.ap(t - 1, n, k, 0) + ls) state = 0;
            else if (sc == v.ap(t - 1, n, k, 2) + ls) state = 2;
            else if (sc == v.ap(t - 1, n, k, 1) + ls) state = 1;
            else return -1;
            --t;
        } else if (state == 0) {  // A
            if (t == 1 && n == 1) {
                emit(0, half, 0);
                break;
            }
            const double sc = v.ap(t, n, k, 0);
            const double ls = v.lp(t, n, k, 0);
            probs.push_back(std::exp(ls));
            bool matched = false;
            for (int64_t a = 0; a < alphabet_size; ++a) {
                const int64_t pre = k / alphabet_size + a * step;
                if (sc == v.ap(t - 1, n - 1, pre, 3) + ls) {
                    emit(0, n - 1 + half, t - 1);
                    state = 3;
                } else if (sc == v.ap(t - 1, n - 1, pre, 4) + ls) {
                    emit(0, n - 1 + half, t - 1);
                    state = 4;
                } else {
                    continue;
                }
                --t;
                --n;
                k = pre;
                matched = true;
                break;
            }
            if (!matched) return -1;
        } else if (state == 1) {  // P
            if (t == 1) {
                emit(1, half, 0);
                break;
            }
            const double sc = v.ap(t, n, k, 1);
            const double ls = v.lp(t, n, k, 1);
            probs.push_back(std::exp(ls));
            bool matched = false;
            for (int64_t a = 0; a < alphabet_size; ++a) {
                const int64_t pre = k / alphabet_size + a * step;
                if (sc == v.ap(t - 1, n, pre, 3) + ls) {
                    emit(1, n - 1 + half, t - 1);
                    state = 3;
                } else if (sc == v.ap(t - 1, n, pre, 2) + ls) {
                    emit(1, n - 1 + half, t - 1);
                    state = 2;
                } else if (sc == v.ap(t - 1, n, pre, 4) + ls) {
                    emit(1, n - 1 + half, t - 1);
                    state = 4;
                } else {
                    continue;
                }
                --t;
                k = pre;
                matched = true;
                break;
            }
            if (!matched) return -1;
        } else if (state == 2) {  // S
            if (t == 1 && n == 1) break;
            const double sc = v.ap(t, n, k, 2);
            const double ls = v.lp(t, n, k, 2);
            probs.push_back(std::exp(ls));
            if (sc == v.ap(t - 1, n - 1, k, 3) + ls) state = 3;
            else if (sc == v.ap(t - 1, n - 1, k, 1) + ls) state = 1;
            else if (sc == v.ap(t - 1, n - 1, k, 4) + ls) state = 4;
            --t;
            --n;
        } else {  // I
            if (n == 1) break;
            const double sc = v.ap(t, n, k, 4);
            const double ls = v.lp(t, n, k, 4);
            probs.push_back(std::exp(ls));
            // two plain ifs in the reference: an E match overrides I
            if (sc == v.ap(t, n - 1, k, 4) + ls) state = 4;
            if (sc == v.ap(t, n - 1, k, 3) + ls) state = 3;
            --n;
        }
    }
    // reverse into read order
    for (int64_t a = 0, b = nseg - 1; a < b; ++a, --b) {
        std::swap(out_state[a], out_state[b]);
        std::swap(out_basepos[a], out_basepos[b]);
        std::swap(out_start[a], out_start[b]);
        std::swap(out_median[a], out_median[b]);
        std::swap(out_polish[a], out_polish[b]);
    }
    return nseg;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CSV row formatting (ref: src/python/segmentation/FileIO.py:402-483)
// ---------------------------------------------------------------------------

// Shortest round-trip double repr with CPython's formatting conventions:
// integral values get a trailing ".0", scientific exponents are sign-
// explicit and zero-padded to two digits ("1e-05"). std::to_chars already
// produces the shortest digits and the same fixed/scientific switch point
// (exponent < -4), so these two rewrites make the bytes identical to
// Python's repr(float(x)) — property-tested in tests/test_output.py.
static char *fmt_double_py(double d, char *p) {
    auto res = std::to_chars(p, p + 40, d);
    char *q = res.ptr;
    if (!std::isfinite(d)) return q;  // "nan"/"inf"/"-inf" match repr as-is
    char *e = nullptr;
    bool dot = false;
    for (char *c = p; c < q; ++c) {
        if (*c == 'e') { e = c; break; }
        if (*c == '.') dot = true;
    }
    if (!e) {
        if (!dot) { *q++ = '.'; *q++ = '0'; }
        return q;
    }
    char sign = '+';
    char *d0 = e + 1;
    if (*d0 == '-' || *d0 == '+') { sign = *d0; ++d0; }
    int nd = (int)(q - d0);
    char digits[8];
    std::memcpy(digits, d0, nd);
    char *w = e + 1;
    *w++ = sign;
    if (nd < 2) *w++ = '0';
    std::memcpy(w, digits, nd);
    return w + nd;
}

static char *fmt_i64(int64_t v, char *p) {
    auto res = std::to_chars(p, p + 24, v);
    return res.ptr;
}

extern "C" {

// Device summaries -> CSV bytes for one read, byte-identical to the Python
// path (nt_banded_device.summaries_to_segments + io.output
// format_segments_csv, basic mode: state "M", polish "NA").
// Returns bytes written, or -1 if out_cap is too small.
int64_t summaries_to_csv(const char *prefix, const int32_t *starts,
                         const float *medians, int64_t N, const char *read,
                         int64_t read_len, int64_t kmer_size, int64_t rna,
                         int64_t sig_offset, int64_t last_index, char *out,
                         int64_t out_cap) {
    const int64_t half = kmer_size / 2;
    const int64_t plen = (int64_t)std::strlen(prefix);
    const int64_t row_cap = plen + 3 * 24 + kmer_size + 48;
    char *w = out;
    char *end = out + out_cap;
    char *prev_end_slot = nullptr;  // previous row's `end` field, patched
                                    // once the next segment start is known
    for (int64_t n = 1; n < N; ++n) {
        if (starts[n] < 0) continue;
        if (end - w < row_cap) return -1;
        int64_t start_t = (int64_t)starts[n] + sig_offset;
        if (prev_end_slot) {
            char *q = fmt_i64(start_t, prev_end_slot);
            std::memmove(q, prev_end_slot + 24,
                         (size_t)(w - (prev_end_slot + 24)));
            w -= (prev_end_slot + 24) - q;
            prev_end_slot = nullptr;
        }
        std::memcpy(w, prefix, plen);
        w += plen;
        w = fmt_i64(start_t, w);
        *w++ = ',';
        prev_end_slot = w;  // reserve 24 chars for `end`
        std::memset(w, ' ', 24);
        w += 24;
        *w++ = ',';
        int64_t bp = n - 1 + half;
        int64_t lo = bp - half > 0 ? bp - half : 0;
        int64_t hi = bp + half + 1 < read_len ? bp + half + 1 : read_len;
        int64_t bp_out = rna ? read_len - bp - 1 : bp;
        w = fmt_i64(bp_out, w);
        *w++ = ',';
        *w++ = read[bp];
        *w++ = ',';
        if (rna) {
            for (int64_t i = hi - 1; i >= lo; --i) *w++ = read[i];
        } else {
            for (int64_t i = lo; i < hi; ++i) *w++ = read[i];
        }
        *w++ = ',';
        *w++ = 'M';
        *w++ = ',';
        w = fmt_double_py((double)medians[n], w);
        *w++ = ',';
        *w++ = 'N';
        *w++ = 'A';
        *w++ = '\n';
    }
    if (prev_end_slot) {
        char *q = fmt_i64(last_index, prev_end_slot);
        std::memmove(q, prev_end_slot + 24,
                     (size_t)(w - (prev_end_slot + 24)));
        w -= (prev_end_slot + 24) - q;
    }
    if (w == out) {
        if (out_cap < 1) return -1;
        *w++ = '\n';  // empty segment list -> single newline (Python join)
    }
    return w - out;
}

}  // extern "C"
