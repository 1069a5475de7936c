// Native host-side kernels for LDWeaver.
//
// Equivalents of the reference's Rcpp/C++ components
// (reference: src/getACGTNsites.cpp, src/computeMI.cpp helpers,
// src/fintersect.cpp; the kseq parser is replaced by a from-scratch
// buffered gz FASTA state machine):
//   * ldw_scan_alignment  - pass 1: equal-length check + 5xL allele counts
//   * ldw_extract_codes   - pass 2: gather retained sites into the dense
//                           uint8 code tensor
//   * ldw_aracne          - the ARACNE DPI loop over a CSR adjacency
//
// Exposed as a plain C ABI for ctypes.  Parallelism: OpenMP over
// sequences (ingest chunks) and over checked links (ARACNE).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// byte -> allele code LUT: a/A=0 c/C=1 g/G=2 t/T=3 else 4
// (classification per reference src/getACGTNsites.cpp:58-70)
struct Lut {
    uint8_t m[256];
    Lut() {
        memset(m, 4, sizeof(m));
        const char *acgt = "ACGT";
        for (int i = 0; i < 4; i++) {
            m[(unsigned char)acgt[i]] = (uint8_t)i;
            m[(unsigned char)(acgt[i] + 32)] = (uint8_t)i;
        }
    }
};
const Lut LUT;

// Streaming gz FASTA reader: invokes cb(name, seq) per record.
template <typename F>
int for_each_record(const char *path, F &&cb) {
    gzFile fp = gzopen(path, "rb");
    if (!fp) return -1;
    gzbuffer(fp, 1 << 20);
    std::string name, seq;
    std::vector<char> buf(1 << 20);
    bool in_name = false;
    bool have_record = false;
    int n = 0;
    for (;;) {
        int got = gzread(fp, buf.data(), (unsigned)buf.size());
        if (got < 0) { gzclose(fp); return -2; }
        if (got == 0) break;
        for (int i = 0; i < got; i++) {
            char c = buf[i];
            if (c == '>') {
                if (have_record) { cb(name, seq); n++; }
                name.clear(); seq.clear();
                in_name = true; have_record = true;
            } else if (c == '\n' || c == '\r') {
                in_name = false;
            } else if (in_name) {
                name.push_back(c);
            } else if (have_record) {
                seq.push_back(c);
            }
        }
    }
    if (have_record) { cb(name, seq); n++; }
    gzclose(fp);
    return n;
}

}  // namespace

extern "C" {

// Pass 1: count alleles per column.  Returns nseq (>0) or:
//   -1 open failure, -2 read error, -3 length mismatch.
// counts: int64[5 * cap_len] zeroed by caller; *seq_len set to the
// observed length (must be <= cap_len or -4 is returned).
long ldw_scan_alignment(const char *path, int64_t *counts,
                        int64_t cap_len, int64_t *seq_len_out,
                        const char *names_path) {
    int64_t seq_len = -1;
    long status = 0;
    FILE *nf = names_path ? fopen(names_path, "w") : nullptr;
    long n = for_each_record(path, [&](const std::string &nm, const std::string &s) {
        if (status != 0) return;
        if (seq_len < 0) {
            seq_len = (int64_t)s.size();
            if (seq_len > cap_len) { status = -4; return; }
        } else if ((int64_t)s.size() != seq_len) {
            status = -3; return;
        }
        if (nf) {
            // name up to first whitespace (kseq behaviour)
            size_t sp = nm.find_first_of(" \t");
            fwrite(nm.data(), 1, sp == std::string::npos ? nm.size() : sp, nf);
            fputc('\n', nf);
        }
        const unsigned char *p = (const unsigned char *)s.data();
        for (int64_t j = 0; j < seq_len; j++) {
            counts[(int64_t)LUT.m[p[j]] * cap_len + j] += 1;
        }
    });
    if (nf) fclose(nf);
    if (status != 0) return status;
    if (n < 0) return n;
    *seq_len_out = seq_len;
    return n;
}

// Pass 2: gather retained 1-based positions into codes[nseq, npos]
// (row-major).  Also fills acgtn[5 * npos] counts.  Returns #sequences.
long ldw_extract_codes(const char *path, const int64_t *pos1, int64_t npos,
                       uint8_t *codes, int64_t nseq_cap, int64_t *acgtn) {
    long i = 0;
    long status = 0;
    long n = for_each_record(path, [&](const std::string &, const std::string &s) {
        if (status != 0) return;
        if (i >= nseq_cap) { status = -5; return; }
        const unsigned char *p = (const unsigned char *)s.data();
        uint8_t *row = codes + (int64_t)i * npos;
        for (int64_t k = 0; k < npos; k++) {
            uint8_t c = LUT.m[p[pos1[k] - 1]];
            row[k] = c;
            acgtn[(int64_t)c * npos + k] += 1;
        }
        i++;
    });
    if (status != 0) return status;
    return n;
}

// ARACNE DPI test (reference semantics: runARACNE R/io_functions.R:101-164
// + .compareTriplet src/computeMI.cpp:62-77):
// for checked link (X, Z) with MI0, mark INDIRECT (0) iff some common
// neighbour Y of X and Z has MI(X,Y) > MI0 AND MI(Y,Z) > MI0 (strict).
//
// Adjacency is CSR over unique positions: for position u (0-based id),
// partners are adj_partner[adj_start[u] .. adj_start[u+1]) sorted
// ascending, with aligned MIs in adj_mi.  check_u/check_v are position
// ids; out[i] = 1 direct / 0 indirect.
void ldw_aracne(const int64_t *check_u, const int64_t *check_v,
                const double *check_mi, int64_t n_check,
                const int64_t *adj_start, const int64_t *adj_partner,
                const double *adj_mi, uint8_t *out, int nthreads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads) schedule(dynamic, 64)
#endif
    for (int64_t i = 0; i < n_check; i++) {
        out[i] = 1;
        int64_t u = check_u[i], v = check_v[i];
        double mi0 = check_mi[i];
        int64_t a = adj_start[u], ae = adj_start[u + 1];
        int64_t b = adj_start[v], be = adj_start[v + 1];
        while (a < ae && b < be) {
            int64_t pa = adj_partner[a], pb = adj_partner[b];
            if (pa < pb) a++;
            else if (pa > pb) b++;
            else {
                if (mi0 < adj_mi[a] && mi0 < adj_mi[b]) { out[i] = 0; break; }
                a++; b++;
            }
        }
    }
}

int ldw_version() { return 1; }

}  // extern "C"
