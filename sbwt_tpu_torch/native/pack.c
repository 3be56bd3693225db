/* Rolling k-mer window packer: the spill-encode stage of the external
 * build (construct/external.py).
 *
 * Replaces the numpy O(n*k) shifted-pass packer (utils/kmers.py
 * pack_windows, 30 full-array passes at k=30) with an O(n) rolling
 * update per position, the same single-pass shape as the reference's
 * KMC-side k-mer extraction loop (run_kmc.cpp:655-721 drives
 * multithreaded KMC over the input).  Multithreaded by slicing the
 * sequence with (k-1)-overlap; each thread packs and filters its slice
 * into a private buffer and the buffers are written to the spill file
 * in slice order, so the byte stream equals the single-thread output.
 *
 * Layout contract (utils/kmers.py): window char at offset j (0-based
 * from window start) sits at bit 64 - 2k + 2j of the record, so
 * integer order == colex order.  Invalid codes (< 0 or > 3) invalidate
 * every window containing them.
 */
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    const int8_t *codes;
    int64_t start;   /* first window index of this slice */
    int64_t count;   /* number of windows */
    int k;
    uint64_t *out;   /* private output buffer (count capacity) */
    int64_t written; /* valid windows packed */
} pk_job;

static void *pk_worker(void *arg)
{
    pk_job *j = (pk_job *)arg;
    const int8_t *c = j->codes + j->start;
    const int k = j->k;
    const int shift = 64 - 2 * k;
    const uint64_t keep = (k == 32) ? ~0ULL : (~0ULL << shift);
    uint64_t val = 0;
    int bad = 0; /* invalid codes among the last k seen */
    int64_t w = 0;
    /* warm up on the first k-1 chars of the slice */
    for (int i = 0; i < k - 1; i++) {
        int8_t x = c[i];
        val = (val >> 2) | ((uint64_t)(x & 3) << 62);
        if (x < 0) bad = k; else if (bad) bad--;
    }
    for (int64_t i = k - 1; i < j->count + k - 1; i++) {
        int8_t x = c[i];
        val = (val >> 2) | ((uint64_t)(x & 3) << 62);
        if (x < 0) bad = k; else if (bad) bad--;
        if (!bad) j->out[w++] = val & keep;
    }
    j->written = w;
    return NULL;
}

/* Pack every valid window of codes[0..n) and append the records to
 * `path` (binary, native-endian uint64).  Returns the number of records
 * written, or -1 on I/O error. */
int64_t pk_spill_windows_u64(const int8_t *codes, int64_t n, int k,
                             const char *path, int n_threads)
{
    if (k < 1 || k > 32 || n < k) return 0;
    int64_t m = n - k + 1;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (m < (int64_t)n_threads * 4096) n_threads = 1;

    pk_job jobs[64];
    pthread_t tids[64];
    int64_t per = (m + n_threads - 1) / n_threads;
    int nt = 0;
    for (int t = 0; t < n_threads; t++) {
        int64_t s = (int64_t)t * per;
        if (s >= m) break;
        int64_t cnt = per < m - s ? per : m - s;
        jobs[nt].codes = codes;
        jobs[nt].start = s;
        jobs[nt].count = cnt;
        jobs[nt].k = k;
        jobs[nt].out = (uint64_t *)malloc((size_t)cnt * sizeof(uint64_t));
        jobs[nt].written = 0;
        if (!jobs[nt].out) {
            for (int u = 0; u < nt; u++) free(jobs[u].out);
            return -1;
        }
        nt++;
    }
    for (int t = 1; t < nt; t++) pthread_create(&tids[t], NULL, pk_worker, &jobs[t]);
    pk_worker(&jobs[0]);
    for (int t = 1; t < nt; t++) pthread_join(tids[t], NULL);

    FILE *f = fopen(path, "ab");
    if (!f) {
        for (int t = 0; t < nt; t++) free(jobs[t].out);
        return -1;
    }
    int64_t total = 0;
    int err = 0;
    for (int t = 0; t < nt; t++) {
        if (!err && jobs[t].written) {
            if (fwrite(jobs[t].out, sizeof(uint64_t), (size_t)jobs[t].written, f)
                != (size_t)jobs[t].written)
                err = 1;
        }
        total += jobs[t].written;
        free(jobs[t].out);
    }
    if (fclose(f) != 0) err = 1;
    return err ? -1 : total;
}

/* In-memory variant: fills vals[0..m) and valid[0..m) for every window
 * (the utils/kmers.py pack_windows contract).  Returns m. */
int64_t pk_pack_windows_u64(const int8_t *codes, int64_t n, int k,
                            uint64_t *vals, uint8_t *valid)
{
    if (k < 1 || k > 32 || n < k) return 0;
    int64_t m = n - k + 1;
    const int shift = 64 - 2 * k;
    const uint64_t keep = (k == 32) ? ~0ULL : (~0ULL << shift);
    uint64_t val = 0;
    int bad = 0;
    for (int i = 0; i < k - 1; i++) {
        int8_t x = codes[i];
        val = (val >> 2) | ((uint64_t)(x & 3) << 62);
        if (x < 0) bad = k; else if (bad) bad--;
    }
    for (int64_t i = k - 1; i < n; i++) {
        int8_t x = codes[i];
        val = (val >> 2) | ((uint64_t)(x & 3) << 62);
        if (x < 0) bad = k; else if (bad) bad--;
        vals[i - (k - 1)] = val & keep;
        valid[i - (k - 1)] = !bad;
    }
    return m;
}

/* Linear merge-probe of two sorted uint64 streams: for each query q[j]
 * (ascending), found[j] = q[j] in buf; buf entries that matched any
 * query get covered[i] = 1.  Replaces the streaming build's per-chunk
 * binary searchsorted (O(m log n) random access) with one O(n+m) scan —
 * the same shape as the reference's cursor stream merge
 * (kmc_construct.hh:102-238). */
void pk_merge_probe(const uint64_t *buf, int64_t n, const uint64_t *q,
                    int64_t m, uint8_t *found, uint8_t *covered)
{
    int64_t i = 0;
    for (int64_t j = 0; j < m; j++) {
        uint64_t v = q[j];
        while (i < n && buf[i] < v) i++;
        if (i < n && buf[i] == v) {
            found[j] = 1;
            covered[i] = 1;
        } else {
            found[j] = 0;
        }
    }
}
