/* Multithreaded external-memory sort + dedup/count for packed k-mers.
 *
 * Native equivalent of the reference's EM_sort machinery
 * (src/EM_sort/EM_sort.cpp:49-212: single producer reads blocks, worker
 * threads sort and spill runs, then <=512-way file merges) specialized to
 * fixed 8-byte records — exactly what the construction pipeline
 * needs, since k-mers are packed into uint64 words whose plain integer
 * order IS colex order (utils/kmers.py; Kmer.hh:108-123).
 *
 * Also provides streaming dedup-with-abundance-counting over a sorted
 * run, replacing KMC's abundance cutoffs (run_kmc.cpp:673-694).
 *
 * Exposed via ctypes (see native/__init__.py).
 */
#define _GNU_SOURCE /* qsort_r */
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAX_WAY 512

/* ------------------------------------------------------------------ */
/* LSD radix sort (8 passes x 8 bits); returns whichever buffer holds  */
/* the sorted data                                                     */
/* ------------------------------------------------------------------ */
static uint64_t *sort_u64(uint64_t *a, uint64_t *tmp, int64_t n) {
    uint64_t *src = a, *dst = tmp;
    for (int pass = 0; pass < 8; pass++) {
        int shift = pass * 8;
        int64_t cnt[256] = {0};
        for (int64_t i = 0; i < n; i++) cnt[(src[i] >> shift) & 255]++;
        int nonzero = 0; for (int j = 0; j < 256; j++) nonzero += cnt[j] != 0;
        if (nonzero <= 1) continue;
        int64_t pos[256]; int64_t s = 0;
        for (int j = 0; j < 256; j++) { pos[j] = s; s += cnt[j]; }
        for (int64_t i = 0; i < n; i++) dst[pos[(src[i] >> shift) & 255]++] = src[i];
        uint64_t *sw = src; src = dst; dst = sw;
    }
    return src;
}

/* ------------------------------------------------------------------ */
/* block pipeline: a bounded single-producer / multi-consumer queue so */
/* the producer's fread overlaps with worker sorting — the pipeline    */
/* parallelism of the reference's ParallelBoundedQueue (EM_sort.cpp:   */
/* 102-134, ParallelBoundedQueue.hh:98-142)                            */
/* ------------------------------------------------------------------ */

/* W-word record comparison, word 0 most significant == colex k-mer order
 * for the multi-word packing of utils/kmers_wide.py (k up to 255). */
static inline int cmp_rec(const uint64_t *a, const uint64_t *b, int W) {
    for (int w = 0; w < W; w++) {
        if (a[w] < b[w]) return -1;
        if (a[w] > b[w]) return 1;
    }
    return 0;
}

/* Per-thread record width for the plain-qsort comparator (portable:
 * GNU and BSD disagree on the qsort_r signature). */
static _Thread_local int tls_W;

static int cmp_rec_qsort(const void *a, const void *b) {
    return cmp_rec(a, b, tls_W);
}

typedef struct {
    uint64_t *data;
    int64_t n; /* records */
    char path[4096];
} Block;

#define BQ_CAP 2 /* producer look-ahead blocks */

typedef struct {
    Block slots[BQ_CAP];
    int head, count;
    int done, err;
    int W; /* record width in words (1 = radix fast path) */
    pthread_mutex_t mu;
    pthread_cond_t not_full, not_empty;
} BlockQueue;

static void bq_init(BlockQueue *q, int W) {
    memset(q, 0, sizeof(*q));
    q->W = W;
    pthread_mutex_init(&q->mu, NULL);
    pthread_cond_init(&q->not_full, NULL);
    pthread_cond_init(&q->not_empty, NULL);
}

static void bq_push(BlockQueue *q, Block b) {
    pthread_mutex_lock(&q->mu);
    while (q->count == BQ_CAP && !q->err) pthread_cond_wait(&q->not_full, &q->mu);
    if (q->err) {
        free(b.data);
    } else {
        q->slots[(q->head + q->count) % BQ_CAP] = b;
        q->count++;
        pthread_cond_signal(&q->not_empty);
    }
    pthread_mutex_unlock(&q->mu);
}

static int bq_pop(BlockQueue *q, Block *out) {
    pthread_mutex_lock(&q->mu);
    while (q->count == 0 && !q->done) pthread_cond_wait(&q->not_empty, &q->mu);
    if (q->count == 0) {
        pthread_mutex_unlock(&q->mu);
        return 0;
    }
    *out = q->slots[q->head];
    q->head = (q->head + 1) % BQ_CAP;
    q->count--;
    pthread_cond_signal(&q->not_full);
    pthread_mutex_unlock(&q->mu);
    return 1;
}

static void bq_finish(BlockQueue *q) {
    pthread_mutex_lock(&q->mu);
    q->done = 1;
    pthread_cond_broadcast(&q->not_empty);
    pthread_mutex_unlock(&q->mu);
}

static void bq_set_err(BlockQueue *q) {
    pthread_mutex_lock(&q->mu);
    q->err = 1;
    pthread_cond_broadcast(&q->not_full);
    pthread_cond_broadcast(&q->not_empty);
    pthread_mutex_unlock(&q->mu);
}

static void *pipeline_worker(void *arg) {
    BlockQueue *q = arg;
    Block b;
    while (bq_pop(q, &b)) {
        int64_t wrote = -1;
        if (q->W == 1) {
            uint64_t *tmp = malloc(b.n * sizeof(uint64_t));
            if (tmp) {
                uint64_t *sorted = sort_u64(b.data, tmp, b.n);
                FILE *f = fopen(b.path, "wb");
                if (f) {
                    wrote = (int64_t)fwrite(sorted, sizeof(uint64_t), b.n, f);
                    if (fclose(f)) wrote = -1;
                }
                free(sorted == b.data ? tmp : b.data);
                if (sorted != b.data) b.data = tmp; /* freed below */
            }
        } else {
            tls_W = q->W;
            qsort(b.data, b.n, q->W * sizeof(uint64_t), cmp_rec_qsort);
            FILE *f = fopen(b.path, "wb");
            if (f) {
                wrote = (int64_t)fwrite(b.data, q->W * sizeof(uint64_t), b.n, f);
                if (fclose(f)) wrote = -1;
            }
        }
        free(b.data);
        if (wrote != b.n) bq_set_err(q);
    }
    return NULL;
}

/* Read in_path in blocks of block_recs W-word records, sort + spill them
 * through n_threads pipeline workers; returns the run count (paths are
 * "<tmp>/<prefix>_run_<i>.bin") or -1 on error. */
static int spill_sorted_runs(FILE *in, const char *tmp_dir, const char *prefix,
                             int W, int64_t block_recs, int n_threads) {
    BlockQueue q;
    bq_init(&q, W);
    pthread_t th[256];
    int nt = n_threads > 256 ? 256 : n_threads;
    for (int t = 0; t < nt; t++) pthread_create(&th[t], NULL, pipeline_worker, &q);
    size_t rec = (size_t)W * sizeof(uint64_t);
    int n_runs = 0, oom = 0;
    for (;;) {
        pthread_mutex_lock(&q.mu);
        int err = q.err;
        pthread_mutex_unlock(&q.mu);
        if (err) break;
        uint64_t *data = malloc(block_recs * rec);
        if (!data) { oom = 1; break; }
        int64_t n = fread(data, rec, block_recs, in);
        if (n <= 0) { free(data); break; }
        Block b;
        b.data = data;
        b.n = n;
        snprintf(b.path, sizeof(b.path), "%s/%s_run_%d.bin", tmp_dir, prefix, n_runs);
        n_runs++;
        bq_push(&q, b);
    }
    bq_finish(&q);
    for (int t = 0; t < nt; t++) pthread_join(th[t], NULL);
    int err = q.err || oom;
    if (err) {
        char path[4096];
        for (int i = 0; i < n_runs; i++) {
            snprintf(path, sizeof(path), "%s/%s_run_%d.bin", tmp_dir, prefix, i);
            remove(path);
        }
        return -1;
    }
    return n_runs;
}

/* ------------------------------------------------------------------ */
/* k-way merge of sorted run files (binary heap of buffered readers)   */
/* ------------------------------------------------------------------ */
typedef struct {
    FILE *f;
    uint64_t *buf;
    int64_t len, pos;
    uint64_t head;
    int alive;
} Run;

#define RUNBUF (1 << 16)

static int run_advance(Run *r) {
    if (++r->pos >= r->len) {
        r->len = fread(r->buf, sizeof(uint64_t), RUNBUF, r->f);
        r->pos = 0;
        if (r->len == 0) { r->alive = 0; return 0; }
    }
    r->head = r->buf[r->pos];
    return 1;
}

typedef struct { uint64_t key; int run; } HeapItem;

static void heap_down(HeapItem *h, int n, int i) {
    for (;;) {
        int l = 2 * i + 1, r = 2 * i + 2, m = i;
        if (l < n && h[l].key < h[m].key) m = l;
        if (r < n && h[r].key < h[m].key) m = r;
        if (m == i) return;
        HeapItem t = h[i]; h[i] = h[m]; h[m] = t;
        i = m;
    }
}

static int merge_runs(char **paths, int n_runs, const char *out_path) {
    Run *runs = calloc(n_runs, sizeof(Run));
    HeapItem *heap = malloc(n_runs * sizeof(HeapItem));
    int hn = 0;
    for (int i = 0; i < n_runs; i++) {
        runs[i].f = fopen(paths[i], "rb");
        if (!runs[i].f) return -1;
        runs[i].buf = malloc(RUNBUF * sizeof(uint64_t));
        runs[i].pos = -1;
        runs[i].alive = 1;
        if (run_advance(&runs[i]))
            heap[hn++] = (HeapItem){runs[i].head, i};
    }
    for (int i = hn / 2 - 1; i >= 0; i--) heap_down(heap, hn, i);
    FILE *out = fopen(out_path, "wb");
    if (!out) return -1;
    uint64_t *obuf = malloc(RUNBUF * sizeof(uint64_t));
    int64_t on = 0;
    int werr = 0;
    while (hn > 0) {
        obuf[on++] = heap[0].key;
        if (on == RUNBUF) {
            if ((int64_t)fwrite(obuf, sizeof(uint64_t), on, out) != on) werr = 1;
            on = 0;
        }
        Run *r = &runs[heap[0].run];
        if (run_advance(r)) heap[0].key = r->head;
        else heap[0] = heap[--hn];
        heap_down(heap, hn, 0);
    }
    if ((int64_t)fwrite(obuf, sizeof(uint64_t), on, out) != on) werr = 1;
    if (fclose(out)) werr = 1;
    for (int i = 0; i < n_runs; i++) { fclose(runs[i].f); free(runs[i].buf); }
    free(runs); free(heap); free(obuf);
    return werr ? -1 : 0;
}

/* ------------------------------------------------------------------ */
/* public API                                                          */
/* ------------------------------------------------------------------ */

/* Sort a raw file of uint64 records. ram_bytes bounds the total block
 * memory; n_threads workers sort blocks concurrently. Iterative
 * <=512-way merge passes (EM_sort.cpp:102-176). Returns 0 on success. */
int em_sort_u64(const char *in_path, const char *out_path,
                const char *tmp_dir, int64_t ram_bytes, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    FILE *in = fopen(in_path, "rb");
    if (!in) return -1;
    /* per-block budget: n_threads blocks in flight at 2x (radix double
     * buffer) + BQ_CAP queued blocks awaiting a worker */
    int64_t block = ram_bytes / (2 * n_threads + BQ_CAP);
    if (block < (int64_t)(1 << 20)) block = 1 << 20;
    int64_t block_recs = block / 8;

    int n_jobs = spill_sorted_runs(in, tmp_dir, "emsort", 1, block_recs, n_threads);
    fclose(in);
    if (n_jobs < 0) return -1;
    if (n_jobs == 0) { /* empty input -> empty output */
        FILE *out = fopen(out_path, "wb");
        if (!out) return -1;
        fclose(out);
        return 0;
    }

    /* iterative merge passes */
    char **cur = malloc(n_jobs * sizeof(char *));
    for (int i = 0; i < n_jobs; i++) {
        char path[4096];
        snprintf(path, sizeof(path), "%s/emsort_run_%d.bin", tmp_dir, i);
        cur[i] = strdup(path);
    }
    int n_cur = n_jobs, gen = 0;
    while (n_cur > 1) {
        int n_next = (n_cur + MAX_WAY - 1) / MAX_WAY;
        char **next = malloc(n_next * sizeof(char *));
        for (int g = 0; g < n_next; g++) {
            int lo = g * MAX_WAY;
            int hi = lo + MAX_WAY < n_cur ? lo + MAX_WAY : n_cur;
            char path[4096];
            snprintf(path, sizeof(path), "%s/emsort_merge_%d_%d.bin", tmp_dir,
                     gen, g);
            if (merge_runs(cur + lo, hi - lo, path)) return -1;
            next[g] = strdup(path);
            for (int i = lo; i < hi; i++) { remove(cur[i]); free(cur[i]); }
        }
        free(cur);
        cur = next;
        n_cur = n_next;
        gen++;
    }
    remove(out_path);
    if (rename(cur[0], out_path)) {
        /* cross-device: fall back to copy */
        FILE *a = fopen(cur[0], "rb"), *b = fopen(out_path, "wb");
        if (!a || !b) return -1;
        char buf[1 << 16]; size_t n;
        int werr = 0;
        while ((n = fread(buf, 1, sizeof(buf), a)) > 0)
            if (fwrite(buf, 1, n, b) != n) { werr = 1; break; }
        fclose(a);
        if (fclose(b)) werr = 1;
        remove(cur[0]);
        if (werr) return -1;
    }
    free(cur[0]); free(cur);
    return 0;
}

/* ------------------------------------------------------------------ */
/* Wide records: W x uint64 words per record, lexicographic word order  */
/* (word 0 most significant) == colex k-mer order for the multi-word   */
/* packing of utils/kmers_wide.py (k up to 255, Kmer.hh ceiling).      */
/* ------------------------------------------------------------------ */

typedef struct {
    FILE *f;
    uint64_t *buf;
    int64_t len, pos; /* in records */
    int alive;
    int W;
} RunW;

static int runw_advance(RunW *r) {
    if (++r->pos >= r->len) {
        r->len = fread(r->buf, r->W * sizeof(uint64_t), RUNBUF, r->f);
        r->pos = 0;
        if (r->len == 0) { r->alive = 0; return 0; }
    }
    return 1;
}

static inline const uint64_t *runw_head(RunW *r) {
    return r->buf + r->pos * r->W;
}

typedef struct { const uint64_t *key; int run; } HeapItemW;

static void heapw_down(HeapItemW *h, int n, int i, int W) {
    for (;;) {
        int l = 2 * i + 1, r = 2 * i + 2, m = i;
        if (l < n && cmp_rec(h[l].key, h[m].key, W) < 0) m = l;
        if (r < n && cmp_rec(h[r].key, h[m].key, W) < 0) m = r;
        if (m == i) return;
        HeapItemW t = h[i]; h[i] = h[m]; h[m] = t;
        i = m;
    }
}

static int merge_runs_w(char **paths, int n_runs, const char *out_path, int W) {
    RunW *runs = calloc(n_runs, sizeof(RunW));
    HeapItemW *heap = malloc(n_runs * sizeof(HeapItemW));
    int hn = 0;
    for (int i = 0; i < n_runs; i++) {
        runs[i].f = fopen(paths[i], "rb");
        if (!runs[i].f) return -1;
        runs[i].buf = malloc((size_t)RUNBUF * W * sizeof(uint64_t));
        runs[i].pos = -1;
        runs[i].alive = 1;
        runs[i].W = W;
        if (runw_advance(&runs[i]))
            heap[hn++] = (HeapItemW){runw_head(&runs[i]), i};
    }
    for (int i = hn / 2 - 1; i >= 0; i--) heapw_down(heap, hn, i, W);
    FILE *out = fopen(out_path, "wb");
    if (!out) return -1;
    uint64_t *obuf = malloc((size_t)RUNBUF * W * sizeof(uint64_t));
    int64_t on = 0;
    int werr = 0;
    while (hn > 0) {
        memcpy(obuf + on * W, heap[0].key, W * sizeof(uint64_t));
        if (++on == RUNBUF) {
            if ((int64_t)fwrite(obuf, W * sizeof(uint64_t), on, out) != on) werr = 1;
            on = 0;
        }
        RunW *r = &runs[heap[0].run];
        if (runw_advance(r)) heap[0].key = runw_head(r);
        else heap[0] = heap[--hn];
        heapw_down(heap, hn, 0, W);
    }
    if ((int64_t)fwrite(obuf, W * sizeof(uint64_t), on, out) != on) werr = 1;
    if (fclose(out)) werr = 1;
    for (int i = 0; i < n_runs; i++) { fclose(runs[i].f); free(runs[i].buf); }
    free(runs); free(heap); free(obuf);
    return werr ? -1 : 0;
}

/* Sort a raw file of W-word records (W in 1..32). Same structure as
 * em_sort_u64; the W=1 entry point remains the fast radix path. */
int em_sort_u64w(const char *in_path, const char *out_path,
                 const char *tmp_dir, int64_t ram_bytes, int n_threads, int W) {
    if (W == 1) return em_sort_u64(in_path, out_path, tmp_dir, ram_bytes, n_threads);
    if (W < 1 || W > 32) return -2;
    if (n_threads < 1) n_threads = 1;
    FILE *in = fopen(in_path, "rb");
    if (!in) return -1;
    size_t rec = W * sizeof(uint64_t);
    /* 2x headroom: glibc qsort may mergesort via an O(n) scratch buffer */
    int64_t block = ram_bytes / (2 * n_threads + BQ_CAP);
    if (block < (int64_t)(1 << 20)) block = 1 << 20;
    int64_t block_recs = block / rec;

    int n_jobs = spill_sorted_runs(in, tmp_dir, "emsortw", W, block_recs, n_threads);
    fclose(in);
    if (n_jobs < 0) return -1;
    if (n_jobs == 0) {
        FILE *out = fopen(out_path, "wb");
        if (!out) return -1;
        fclose(out);
        return 0;
    }

    char **cur = malloc(n_jobs * sizeof(char *));
    for (int i = 0; i < n_jobs; i++) {
        char path[4096];
        snprintf(path, sizeof(path), "%s/emsortw_run_%d.bin", tmp_dir, i);
        cur[i] = strdup(path);
    }
    int n_cur = n_jobs, gen = 0;
    while (n_cur > 1) {
        int n_next = (n_cur + MAX_WAY - 1) / MAX_WAY;
        char **next = malloc(n_next * sizeof(char *));
        for (int g = 0; g < n_next; g++) {
            int lo = g * MAX_WAY;
            int hi = lo + MAX_WAY < n_cur ? lo + MAX_WAY : n_cur;
            char path[4096];
            snprintf(path, sizeof(path), "%s/emsortw_merge_%d_%d.bin", tmp_dir,
                     gen, g);
            if (merge_runs_w(cur + lo, hi - lo, path, W)) return -1;
            next[g] = strdup(path);
            for (int i = lo; i < hi; i++) { remove(cur[i]); free(cur[i]); }
        }
        free(cur);
        cur = next;
        n_cur = n_next;
        gen++;
    }
    remove(out_path);
    if (rename(cur[0], out_path)) {
        FILE *a = fopen(cur[0], "rb"), *b = fopen(out_path, "wb");
        if (!a || !b) return -1;
        char buf[1 << 16]; size_t n;
        int werr = 0;
        while ((n = fread(buf, 1, sizeof(buf), a)) > 0)
            if (fwrite(buf, 1, n, b) != n) { werr = 1; break; }
        fclose(a);
        if (fclose(b)) werr = 1;
        remove(cur[0]);
        if (werr) return -1;
    }
    free(cur[0]); free(cur);
    return 0;
}

/* Dedup/abundance-filter a sorted W-word record file. */
int64_t em_dedup_count_u64w(const char *in_path, const char *out_path,
                            int64_t min_abund, int64_t max_abund, int W) {
    if (W < 1 || W > 32) return -2;
    FILE *in = fopen(in_path, "rb");
    if (!in) return -1;
    FILE *out = fopen(out_path, "wb");
    if (!out) { fclose(in); return -1; }
    size_t rec = W * sizeof(uint64_t);
    uint64_t *ibuf = malloc((size_t)RUNBUF * rec);
    uint64_t *obuf = malloc((size_t)RUNBUF * rec);
    uint64_t cur[32];
    int64_t on = 0, kept = 0, count = 0;
    int have = 0, werr = 0;
    for (;;) {
        int64_t n = fread(ibuf, rec, RUNBUF, in);
        if (n <= 0) break;
        for (int64_t i = 0; i < n; i++) {
            const uint64_t *v = ibuf + i * W;
            if (have && cmp_rec(v, cur, W) == 0) { count++; continue; }
            if (have && count >= min_abund && count <= max_abund) {
                memcpy(obuf + on * W, cur, rec);
                kept++;
                if (++on == RUNBUF) {
                    if ((int64_t)fwrite(obuf, rec, on, out) != on) werr = 1;
                    on = 0;
                }
            }
            memcpy(cur, v, rec);
            count = 1;
            have = 1;
        }
    }
    if (have && count >= min_abund && count <= max_abund) {
        memcpy(obuf + on * W, cur, rec);
        on++;
        kept++;
    }
    if ((int64_t)fwrite(obuf, rec, on, out) != on) werr = 1;
    free(ibuf); free(obuf);
    fclose(in);
    if (fclose(out)) werr = 1;
    return werr ? -1 : kept;
}

/* ------------------------------------------------------------------ */
/* Variable-length records (EM_sort_variable_length_records equivalent,*/
/* EM_sort.cpp:195-212 + Block.hh variable blocks). Record framing:    */
/* u64 LE payload length, then payload bytes. Order: bytewise          */
/* lexicographic on the payload, with a proper prefix sorting first    */
/* (memcmp on min length, then shorter-first) — the natural generic    */
/* comparator, matching Python bytes ordering for the test oracle.     */
/* ------------------------------------------------------------------ */

static inline int cmp_varlen(const char *a, const char *b) {
    uint64_t la, lb;
    memcpy(&la, a, 8);
    memcpy(&lb, b, 8);
    uint64_t m = la < lb ? la : lb;
    int c = memcmp(a + 8, b + 8, m);
    if (c) return c;
    return (la > lb) - (la < lb);
}

static _Thread_local const char *tls_vbase;

static int cmp_varlen_qsort(const void *x, const void *y) {
    return cmp_varlen(tls_vbase + *(const int64_t *)x,
                      tls_vbase + *(const int64_t *)y);
}

typedef struct {
    char *data;      /* raw block of framed records */
    int64_t *offs;   /* record start offsets within data */
    int64_t n_recs;
    char path[4096];
} JobV;

typedef struct {
    JobV *jobs;
    int n_jobs;
    int next;
    int err;
    pthread_mutex_t mu;
} PoolV;

static void *worker_v(void *arg) {
    PoolV *p = arg;
    for (;;) {
        pthread_mutex_lock(&p->mu);
        int i = p->next < p->n_jobs ? p->next++ : -1;
        pthread_mutex_unlock(&p->mu);
        if (i < 0) return NULL;
        JobV *j = &p->jobs[i];
        /* sort an index of record starts, like the reference's variable
         * Block (Block.hh:120-125), then write records in that order */
        tls_vbase = j->data;
        qsort(j->offs, j->n_recs, sizeof(int64_t), cmp_varlen_qsort);
        FILE *f = fopen(j->path, "wb");
        int ok = f != NULL;
        for (int64_t r = 0; ok && r < j->n_recs; r++) {
            const char *rec = j->data + j->offs[r];
            uint64_t len;
            memcpy(&len, rec, 8);
            ok = fwrite(rec, 1, 8 + len, f) == 8 + len;
        }
        if (f && fclose(f)) ok = 0;
        free(j->data);
        free(j->offs);
        j->data = NULL;
        j->offs = NULL; /* error paths re-free the job array */
        if (!ok) {
            pthread_mutex_lock(&p->mu);
            p->err = 1;
            pthread_mutex_unlock(&p->mu);
        }
    }
}

/* merge cursor: one materialized record per run */
typedef struct {
    FILE *f;
    char *rec;      /* framed record (header + payload), growable */
    size_t cap;
    int alive;
} RunV;

static int runv_advance(RunV *r) {
    uint64_t len;
    if (fread(&len, 1, 8, r->f) != 8) { r->alive = 0; return 0; }
    if (8 + len > r->cap) {
        r->cap = 2 * (8 + len);
        r->rec = realloc(r->rec, r->cap);
    }
    memcpy(r->rec, &len, 8);
    if (len && fread(r->rec + 8, 1, len, r->f) != len) { r->alive = 0; return 0; }
    return 1;
}

typedef struct { const char *key; int run; } HeapItemV;

static void heapv_down(HeapItemV *h, int n, int i) {
    for (;;) {
        int l = 2 * i + 1, r = 2 * i + 2, m = i;
        if (l < n && cmp_varlen(h[l].key, h[m].key) < 0) m = l;
        if (r < n && cmp_varlen(h[r].key, h[m].key) < 0) m = r;
        if (m == i) return;
        HeapItemV t = h[i]; h[i] = h[m]; h[m] = t;
        i = m;
    }
}

static int merge_runs_v(char **paths, int n_runs, const char *out_path) {
    RunV *runs = calloc(n_runs, sizeof(RunV));
    HeapItemV *heap = malloc(n_runs * sizeof(HeapItemV));
    int hn = 0;
    for (int i = 0; i < n_runs; i++) {
        runs[i].f = fopen(paths[i], "rb");
        if (!runs[i].f) return -1;
        runs[i].cap = 1 << 12;
        runs[i].rec = malloc(runs[i].cap);
        runs[i].alive = 1;
        if (runv_advance(&runs[i]))
            heap[hn++] = (HeapItemV){runs[i].rec, i};
    }
    for (int i = hn / 2 - 1; i >= 0; i--) heapv_down(heap, hn, i);
    FILE *out = fopen(out_path, "wb");
    if (!out) return -1;
    while (hn > 0) {
        uint64_t len;
        memcpy(&len, heap[0].key, 8);
        if (fwrite(heap[0].key, 1, 8 + len, out) != 8 + len) return -1;
        RunV *r = &runs[heap[0].run];
        if (runv_advance(r)) heap[0].key = r->rec; /* realloc may move it */
        else heap[0] = heap[--hn];
        heapv_down(heap, hn, 0);
    }
    if (fclose(out)) return -1;
    for (int i = 0; i < n_runs; i++) { fclose(runs[i].f); free(runs[i].rec); }
    free(runs); free(heap);
    return 0;
}

/* Sort a file of length-prefixed variable records. Same producer /
 * worker-pool / iterative <=512-way merge structure as em_sort_u64. */
int em_sort_varlen(const char *in_path, const char *out_path,
                   const char *tmp_dir, int64_t ram_bytes, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    FILE *in = fopen(in_path, "rb");
    if (!in) return -1;
    int64_t block = ram_bytes / (2 * n_threads);
    if (block < (int64_t)(1 << 16)) block = 1 << 16;

    JobV *jobs = NULL;
    int n_jobs = 0, cap_jobs = 0, sort_err = 0, read_err = 0;
    for (;;) {
        /* fill one block, respecting record boundaries; grow past the
         * block size if a single record alone exceeds it */
        int64_t cap = block, used = 0;
        char *data = malloc(cap);
        int64_t rcap = 1024, n_recs = 0;
        int64_t *offs = malloc(rcap * sizeof(int64_t));
        for (;;) {
            uint64_t len;
            size_t got = fread(&len, 1, 8, in);
            if (got == 0) break;
            if (got != 8) { read_err = 1; break; }
            if (used + 8 + (int64_t)len > cap) {
                if (n_recs > 0 && used + 8 + (int64_t)len > block) {
                    /* push back the header for the next block */
                    fseek(in, -8, SEEK_CUR);
                    break;
                }
                while (used + 8 + (int64_t)len > cap) cap *= 2;
                data = realloc(data, cap);
            }
            memcpy(data + used, &len, 8);
            if (len && fread(data + used + 8, 1, len, in) != len) {
                read_err = 1;
                break;
            }
            if (n_recs == rcap) {
                rcap *= 2;
                offs = realloc(offs, rcap * sizeof(int64_t));
            }
            offs[n_recs++] = used;
            used += 8 + len;
            if (used >= block) break;
        }
        if (n_recs == 0 || read_err) {
            free(data);
            free(offs);
            break;
        }
        if (n_jobs == cap_jobs) {
            cap_jobs = cap_jobs ? cap_jobs * 2 : 16;
            jobs = realloc(jobs, cap_jobs * sizeof(JobV));
        }
        JobV *j = &jobs[n_jobs];
        j->data = data;
        j->offs = offs;
        j->n_recs = n_recs;
        snprintf(j->path, sizeof(j->path), "%s/emsortv_run_%d.bin", tmp_dir, n_jobs);
        n_jobs++;
        if (n_jobs % n_threads == 0) {
            PoolV p = {jobs + n_jobs - n_threads, n_threads, 0, 0,
                       PTHREAD_MUTEX_INITIALIZER};
            pthread_t th[256];
            int nt = n_threads > 256 ? 256 : n_threads;
            for (int t = 0; t < nt; t++) pthread_create(&th[t], NULL, worker_v, &p);
            for (int t = 0; t < nt; t++) pthread_join(th[t], NULL);
            if (p.err) { sort_err = 1; break; }
        }
    }
    fclose(in);
    if (read_err) {
        for (int i = 0; i < n_jobs; i++) {
            free(jobs[i].data);
            free(jobs[i].offs);
            remove(jobs[i].path);
        }
        free(jobs);
        return -1;
    }
    int tail = n_jobs % n_threads;
    if (tail && !sort_err) {
        PoolV p = {jobs + n_jobs - tail, tail, 0, 0, PTHREAD_MUTEX_INITIALIZER};
        pthread_t th[256];
        int nt = tail > 256 ? 256 : tail;
        for (int t = 0; t < nt; t++) pthread_create(&th[t], NULL, worker_v, &p);
        for (int t = 0; t < nt; t++) pthread_join(th[t], NULL);
        if (p.err) sort_err = 1;
    }
    if (sort_err) {
        for (int i = 0; i < n_jobs; i++) {
            free(jobs[i].data);
            free(jobs[i].offs);
            remove(jobs[i].path);
        }
        free(jobs);
        return -1;
    }
    if (n_jobs == 0) {
        FILE *out = fopen(out_path, "wb");
        if (!out) { free(jobs); return -1; }
        fclose(out);
        free(jobs);
        return 0;
    }

    char **cur = malloc(n_jobs * sizeof(char *));
    for (int i = 0; i < n_jobs; i++) cur[i] = strdup(jobs[i].path);
    int n_cur = n_jobs, gen = 0;
    free(jobs);
    while (n_cur > 1) {
        int n_next = (n_cur + MAX_WAY - 1) / MAX_WAY;
        char **next = malloc(n_next * sizeof(char *));
        for (int g = 0; g < n_next; g++) {
            int lo = g * MAX_WAY;
            int hi = lo + MAX_WAY < n_cur ? lo + MAX_WAY : n_cur;
            char path[4096];
            snprintf(path, sizeof(path), "%s/emsortv_merge_%d_%d.bin", tmp_dir,
                     gen, g);
            if (merge_runs_v(cur + lo, hi - lo, path)) return -1;
            next[g] = strdup(path);
            for (int i = lo; i < hi; i++) { remove(cur[i]); free(cur[i]); }
        }
        free(cur);
        cur = next;
        n_cur = n_next;
        gen++;
    }
    remove(out_path);
    if (rename(cur[0], out_path)) {
        FILE *a = fopen(cur[0], "rb"), *b = fopen(out_path, "wb");
        if (!a || !b) return -1;
        char buf[1 << 16]; size_t n;
        int werr = 0;
        while ((n = fread(buf, 1, sizeof(buf), a)) > 0)
            if (fwrite(buf, 1, n, b) != n) { werr = 1; break; }
        fclose(a);
        if (fclose(b)) werr = 1;
        remove(cur[0]);
        if (werr) return -1;
    }
    free(cur[0]); free(cur);
    return 0;
}

/* Streaming dedup over a sorted u64 file with abundance filtering:
 * keep values occurring in [min_abund, max_abund] times
 * (KMC cutoff semantics, run_kmc.cpp:673-694).  Returns the number of
 * distinct kept values, or -1 on error. */
int64_t em_dedup_count_u64(const char *in_path, const char *out_path,
                           int64_t min_abund, int64_t max_abund) {
    FILE *in = fopen(in_path, "rb");
    if (!in) return -1;
    FILE *out = fopen(out_path, "wb");
    if (!out) { fclose(in); return -1; }
    uint64_t *ibuf = malloc(RUNBUF * sizeof(uint64_t));
    uint64_t *obuf = malloc(RUNBUF * sizeof(uint64_t));
    int64_t on = 0, kept = 0;
    uint64_t cur = 0;
    int64_t count = 0;
    int have = 0, werr = 0;
    for (;;) {
        int64_t n = fread(ibuf, sizeof(uint64_t), RUNBUF, in);
        if (n <= 0) break;
        for (int64_t i = 0; i < n; i++) {
            if (have && ibuf[i] == cur) { count++; continue; }
            if (have && count >= min_abund && count <= max_abund) {
                obuf[on++] = cur;
                kept++;
                if (on == RUNBUF) {
                    if ((int64_t)fwrite(obuf, 8, on, out) != on) werr = 1;
                    on = 0;
                }
            }
            cur = ibuf[i];
            count = 1;
            have = 1;
        }
    }
    if (have && count >= min_abund && count <= max_abund) {
        obuf[on++] = cur;
        kept++;
    }
    if ((int64_t)fwrite(obuf, 8, on, out) != on) werr = 1;
    free(ibuf); free(obuf);
    fclose(in);
    if (fclose(out)) werr = 1;
    return werr ? -1 : kept;
}
