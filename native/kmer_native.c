/*
 * kmer_native.c — host-side native runtime: validation, 2-bit encoding,
 * FASTA/CSV ingest.
 *
 * The reference implements its hot host paths in C inside a Postgres
 * backend (validate_sequence at kmer.c:20-41; per-tuple text I/O at
 * kmer.c:84-199).  The engine's equivalent native layer is this
 * data loader: it turns raw ASCII read files into dense 2-bit code
 * arrays at memory bandwidth so the host never bottlenecks the device
 * pipeline.  Exposed to Python via ctypes (kmer_tpu/native.py); every
 * function has a pure-numpy fallback so the engine still works without
 * a C toolchain.
 *
 * Build: cc -O3 -shared -fPIC -o libkmer_native.so kmer_native.c
 */

#include <stdint.h>
#include <stddef.h>

/* ASCII -> 2-bit code; 0xFF = invalid. Matches kmer_tpu.codec.CODE_LUT. */
static const uint8_t CODE_LUT[256] = {
    [0 ... 255] = 0xFF,
    ['a'] = 0, ['A'] = 0,
    ['c'] = 1, ['C'] = 1,
    ['g'] = 2, ['G'] = 2,
    ['t'] = 3, ['T'] = 3,
};

/*
 * Validate + encode an ASCII DNA sequence into 2-bit codes.
 * Returns -1 on success, else the index of the first invalid byte
 * (mirrors validate_sequence's reject-on-first-bad-char, kmer.c:26-38).
 */
long long kn_encode_validate(const char *in, long long n, uint8_t *out)
{
    for (long long i = 0; i < n; i++) {
        uint8_t c = CODE_LUT[(uint8_t)in[i]];
        if (c == 0xFF)
            return i;
        out[i] = c;
    }
    return -1;
}

/*
 * Encode, skipping invalid characters (e.g. 'N' runs in real FASTA).
 * Returns the number of codes written.
 */
long long kn_encode_skip(const char *in, long long n, uint8_t *out)
{
    long long w = 0;
    for (long long i = 0; i < n; i++) {
        uint8_t c = CODE_LUT[(uint8_t)in[i]];
        if (c != 0xFF)
            out[w++] = c;
    }
    return w;
}

/*
 * Pack 2-bit codes into big-endian-within-word uint32 lanes
 * (16 bases per word, first base in the top bits — the same
 * left-aligned layout as codec.pack_key64 truncated to 32 bits).
 */
void kn_pack2bit(const uint8_t *codes, long long n, uint32_t *words)
{
    long long nwords = (n + 15) / 16;
    for (long long w = 0; w < nwords; w++) {
        uint32_t acc = 0;
        long long base = w * 16;
        long long lim = n - base < 16 ? n - base : 16;
        for (long long j = 0; j < lim; j++)
            acc |= (uint32_t)codes[base + j] << (30 - 2 * j);
        words[w] = acc;
    }
}

/*
 * One-pass FASTA scan + encode.
 *
 * buf/n:        raw file bytes
 * codes:        output code stream (capacity >= n)
 * offsets:      per-read start offsets into codes (capacity max_reads+1);
 *               offsets[r]..offsets[r+1] delimit read r
 * max_reads:    capacity of offsets
 * skip_invalid: nonzero -> drop non-ACGT bases; zero -> abort on them
 *
 * Returns number of reads parsed, or -(byte index)-1 on an invalid
 * base when skip_invalid == 0, or -n-1 style overflow if max_reads hit.
 */
long long kn_fasta_encode(const char *buf, long long n, uint8_t *codes,
                          long long *offsets, long long max_reads,
                          int skip_invalid)
{
    long long nreads = 0, w = 0, i = 0;
    while (i < n) {
        if (buf[i] == '>') {            /* header line */
            while (i < n && buf[i] != '\n')
                i++;
            i++;
            if (nreads >= max_reads)
                return -((long long)1) - n;  /* capacity overflow sentinel */
            offsets[nreads++] = w;
            continue;
        }
        char ch = buf[i];
        if (ch == '\n' || ch == '\r') {
            i++;
            continue;
        }
        if (nreads == 0) {              /* sequence data before any header */
            offsets[nreads++] = w;
        }
        uint8_t c = CODE_LUT[(uint8_t)ch];
        if (c == 0xFF) {
            if (!skip_invalid)
                return -i - 1;
        } else {
            codes[w++] = c;
        }
        i++;
    }
    offsets[nreads] = w;
    return nreads;
}

/*
 * One-pass FASTQ scan + encode (strict 4-line records: @header,
 * sequence, '+' separator, quality).  Same contract as kn_fasta_encode;
 * quality bytes are skipped by sequence length, so '@'-leading quality
 * lines cannot be misparsed as headers.
 */
long long kn_fastq_encode(const char *buf, long long n, uint8_t *codes,
                          long long *offsets, long long max_reads,
                          int skip_invalid)
{
    long long nreads = 0, w = 0, i = 0;
    while (i < n) {
        if (buf[i] == '\n' || buf[i] == '\r') {  /* blank trailing lines */
            i++;
            continue;
        }
        if (buf[i] != '@')              /* record must open with @header */
            return -i - 1;
        while (i < n && buf[i] != '\n')
            i++;
        i++;
        if (nreads >= max_reads)
            return -((long long)1) - n;  /* capacity overflow sentinel */
        offsets[nreads++] = w;
        long long seq_len = 0;          /* chars on the sequence line */
        while (i < n && buf[i] != '\n') {
            char ch = buf[i];
            if (ch != '\r') {
                uint8_t c = CODE_LUT[(uint8_t)ch];
                if (c == 0xFF) {
                    if (!skip_invalid)
                        return -i - 1;
                } else {
                    codes[w++] = c;
                }
                seq_len++;
            }
            i++;
        }
        i++;
        if (i < n) {                    /* '+' separator line */
            if (buf[i] != '+')
                return -i - 1;
            while (i < n && buf[i] != '\n')
                i++;
            i++;
        }
        long long q = 0;                /* quality: exactly seq_len chars */
        while (i < n && q < seq_len) {
            if (buf[i] != '\r' && buf[i] != '\n')
                q++;
            i++;
        }
    }
    offsets[nreads] = w;
    return nreads;
}

/*
 * Batch-encode newline-separated sequences (one read per line — the
 * shape of a CSV column already isolated by the Python side).
 */
long long kn_lines_encode(const char *buf, long long n, uint8_t *codes,
                          long long *offsets, long long max_reads)
{
    long long nreads = 0, w = 0, i = 0;
    offsets[0] = 0;
    while (i < n && nreads < max_reads) {
        if (buf[i] == '\n') {
            offsets[++nreads] = w;
            i++;
            continue;
        }
        uint8_t c = CODE_LUT[(uint8_t)buf[i]];
        if (c == 0xFF)
            return -i - 1;
        codes[w++] = c;
        i++;
    }
    if (i >= n && (nreads == 0 || offsets[nreads] != w))
        offsets[++nreads] = w;
    return nreads;
}

/* ---------------- multithreaded parsing (pthreads) ----------------
 *
 * Two-phase parallel parse: records are found at validated record
 * boundaries near even byte splits, phase 1 counts reads/bases per
 * chunk, prefix sums assign disjoint output regions, phase 2 re-parses
 * writing codes/offsets — no locks, no atomics, byte-identical output
 * to the sequential parsers above.
 */

#include <pthread.h>

typedef struct {
    const char *buf;
    long long start, end;     /* chunk byte range */
    uint8_t *codes;           /* phase-2 outputs */
    long long *offsets;
    long long code_base, read_base;
    long long reads, bases;   /* phase-1 results */
    long long err;            /* -1 ok, else global byte index of bad input */
    int skip_invalid;
    int write;                /* 0 = count, 1 = write */
    int fastq;
    int first_chunk;
} kn_job;

static long long fasta_boundary(const char *buf, long long n, long long pos)
{
    if (pos <= 0)
        return 0;
    for (long long i = pos; i < n; i++)
        if (buf[i] == '>' && buf[i - 1] == '\n')
            return i;
    return n;
}

/* Validated FASTQ record start: an '@' line whose line+2 begins '+'
 * (a quality line starting '@' fails: two lines later is the next
 * record's sequence line, which starts with a base, not '+').
 * A candidate whose validation line lies beyond the buffer (j >= n)
 * is REJECTED: near the end of the file a quality line starting '@'
 * (Phred 31) inside the last record would otherwise be taken as a
 * record start, emitting a phantom read when a chunk split lands in
 * that record.  Returning n instead merges the tail into the
 * predecessor chunk, which parses it sequentially and correctly. */
static long long fastq_boundary(const char *buf, long long n, long long pos)
{
    if (pos <= 0)
        return 0;
    long long i = pos;
    while (i < n && buf[i - 1] != '\n')  /* advance to a line start */
        i++;
    while (i < n) {
        long long line = i;
        if (buf[line] == '@') {
            long long j = line;
            int k;
            for (k = 0; k < 2 && j < n; k++) {  /* skip 2 lines */
                while (j < n && buf[j] != '\n')
                    j++;
                j++;
            }
            if (j < n && buf[j] == '+')
                return line;
        }
        while (i < n && buf[i] != '\n')
            i++;
        i++;
    }
    return n;
}

static void *kn_fasta_worker(void *arg)
{
    kn_job *j = (kn_job *)arg;
    const char *buf = j->buf;
    long long i = j->start, end = j->end, w = 0, r = 0;
    j->err = -1;
    while (i < end) {
        if (buf[i] == '>') {
            while (i < end && buf[i] != '\n')
                i++;
            i++;
            if (j->write)
                j->offsets[j->read_base + r] = j->code_base + w;
            r++;
            continue;
        }
        char ch = buf[i];
        if (ch == '\n' || ch == '\r') {
            i++;
            continue;
        }
        if (r == 0) {  /* headerless leading data: only chunk 0 sees this */
            if (j->write)
                j->offsets[j->read_base] = j->code_base;
            r++;
        }
        uint8_t c = CODE_LUT[(uint8_t)ch];
        if (c == 0xFF) {
            if (!j->skip_invalid) {
                j->err = i;
                return NULL;
            }
        } else {
            if (j->write)
                j->codes[j->code_base + w] = c;
            w++;
        }
        i++;
    }
    j->reads = r;
    j->bases = w;
    return NULL;
}

static void *kn_fastq_worker(void *arg)
{
    kn_job *j = (kn_job *)arg;
    const char *buf = j->buf;
    long long i = j->start, end = j->end, w = 0, r = 0;
    j->err = -1;
    while (i < end) {
        if (buf[i] == '\n' || buf[i] == '\r') {
            i++;
            continue;
        }
        if (buf[i] != '@') {
            j->err = i;
            return NULL;
        }
        while (i < end && buf[i] != '\n')
            i++;
        i++;
        if (j->write)
            j->offsets[j->read_base + r] = j->code_base + w;
        r++;
        long long seq_len = 0;
        while (i < end && buf[i] != '\n') {
            char ch = buf[i];
            if (ch != '\r') {
                uint8_t c = CODE_LUT[(uint8_t)ch];
                if (c == 0xFF) {
                    if (!j->skip_invalid) {
                        j->err = i;
                        return NULL;
                    }
                } else {
                    if (j->write)
                        j->codes[j->code_base + w] = c;
                    w++;
                }
                seq_len++;
            }
            i++;
        }
        i++;
        if (i < end) {
            if (buf[i] != '+') {
                j->err = i;
                return NULL;
            }
            while (i < end && buf[i] != '\n')
                i++;
            i++;
        }
        long long q = 0;
        while (i < end && q < seq_len) {
            if (buf[i] != '\r' && buf[i] != '\n')
                q++;
            i++;
        }
    }
    j->reads = r;
    j->bases = w;
    return NULL;
}

static long long kn_reads_encode_mt(const char *buf, long long n,
                                    uint8_t *codes, long long *offsets,
                                    long long max_reads, int skip_invalid,
                                    int nthreads, int fastq)
{
    if (nthreads > 16)
        nthreads = 16;
    if (nthreads < 2 || n < (1 << 20))
        return fastq ? kn_fastq_encode(buf, n, codes, offsets, max_reads,
                                       skip_invalid)
                     : kn_fasta_encode(buf, n, codes, offsets, max_reads,
                                       skip_invalid);
    kn_job jobs[16];
    pthread_t tids[16];
    int t, T = nthreads;
    long long bounds[17];
    bounds[0] = 0;
    for (t = 1; t < T; t++) {
        long long pos = n * t / T;
        bounds[t] = fastq ? fastq_boundary(buf, n, pos)
                          : fasta_boundary(buf, n, pos);
        if (bounds[t] < bounds[t - 1])
            bounds[t] = bounds[t - 1];
    }
    bounds[T] = n;
    for (t = 0; t < T; t++) {
        if (bounds[t + 1] < bounds[t])
            bounds[t + 1] = bounds[t];
    }

    for (int phase = 0; phase < 2; phase++) {
        for (t = 0; t < T; t++) {
            jobs[t].buf = buf;
            jobs[t].start = bounds[t];
            jobs[t].end = bounds[t + 1];
            jobs[t].codes = codes;
            jobs[t].offsets = offsets;
            jobs[t].skip_invalid = skip_invalid;
            jobs[t].write = phase;
            jobs[t].fastq = fastq;
            jobs[t].first_chunk = (t == 0);
            if (phase == 0) {
                jobs[t].reads = jobs[t].bases = 0;
                jobs[t].code_base = jobs[t].read_base = 0;
            }
            pthread_create(&tids[t], NULL,
                           fastq ? kn_fastq_worker : kn_fasta_worker,
                           &jobs[t]);
        }
        long long err = -1;
        for (t = 0; t < T; t++) {
            pthread_join(tids[t], NULL);
            if (jobs[t].err >= 0 && (err < 0 || jobs[t].err < err))
                err = jobs[t].err;
        }
        if (err >= 0)
            return -err - 1;
        if (phase == 0) {
            long long rsum = 0, wsum = 0;
            for (t = 0; t < T; t++) {
                jobs[t].read_base = rsum;
                jobs[t].code_base = wsum;
                rsum += jobs[t].reads;
                wsum += jobs[t].bases;
            }
            if (rsum > max_reads)
                return -((long long)1) - n;  /* capacity overflow sentinel */
            offsets[rsum] = wsum;            /* final sentinel offset */
        }
    }
    long long total = 0;
    for (t = 0; t < T; t++)
        total += jobs[t].reads;
    return total;
}

/* ---------------- fixed-width packed row assembly -----------------
 *
 * Turns an encoded (code stream, per-read offsets) pair into the
 * device wire format in ONE pass: fixed-width rows of 2-bit-packed
 * uint32 words (16 bases/word, left-aligned) + uint16 row lengths.
 * Reads longer than `width` split into pieces sharing a k-1 base
 * overlap — semantics identical to kmer_tpu.parallel.driver.
 * split_long_reads followed by native.pack2bit_rows (the numpy
 * fallback), but without materializing the [rows, width] byte matrix
 * (that assembly + numpy packing cost 2x the parse — it was the feed
 * bottleneck of the pipelined count).
 */

typedef struct {
    const uint8_t *codes;
    const long long *offsets;
    long long r0, r1;         /* read range */
    long long row_base;       /* first output row of read r0 */
    uint32_t *words;
    uint16_t *lens;
    long long width, k, nw;
} kn_rows_job;

static void *kn_rows_worker(void *arg)
{
    kn_rows_job *j = (kn_rows_job *)arg;
    long long step = j->width - (j->k - 1);
    long long row = j->row_base;
    for (long long r = j->r0; r < j->r1; r++) {
        long long off = j->offsets[r];
        long long len = j->offsets[r + 1] - off;
        long long npieces = 1;
        if (len > j->width)
            npieces += (len - j->width + step - 1) / step;
        for (long long p = 0; p < npieces; p++) {
            const uint8_t *c = j->codes + off + p * step;
            long long plen = len - p * step;
            if (plen > j->width)
                plen = j->width;
            if (plen < 0)
                plen = 0;
            uint32_t *w = j->words + row * j->nw;
            long long full = plen / 16, wi;
            for (wi = 0; wi < full; wi++) {
                const uint8_t *cc = c + wi * 16;
                uint32_t acc = 0;
                for (int b = 0; b < 16; b++)
                    acc |= (uint32_t)cc[b] << (30 - 2 * b);
                w[wi] = acc;
            }
            if (full < j->nw) {
                const uint8_t *cc = c + full * 16;
                long long rem = plen - full * 16;
                uint32_t acc = 0;
                for (long long b = 0; b < rem; b++)
                    acc |= (uint32_t)cc[b] << (30 - 2 * b);
                w[full] = acc;
                for (wi = full + 1; wi < j->nw; wi++)
                    w[wi] = 0;
            }
            j->lens[row] = (uint16_t)plen;
            row++;
        }
    }
    return NULL;
}

/*
 * codes/offsets: encoded reads (offsets has n_reads+1 entries).
 * width: row width in bases (multiple of 16, > k-1).
 * words: output [total_rows, width/16]; lens: output [total_rows].
 * Caller sizes total_rows with the same piece formula (split_long_reads).
 * Returns total rows written, or -1 on bad arguments.
 */
long long kn_rows_packed(const uint8_t *codes, const long long *offsets,
                         long long n_reads, long long width, long long k,
                         uint32_t *words, uint16_t *lens, int nthreads)
{
    if (width <= k - 1 || (width & 15) || k <= 0)
        return -1;
    long long step = width - (k - 1);
    if (nthreads > 16)
        nthreads = 16;
    if (nthreads < 1)
        nthreads = 1;
    kn_rows_job jobs[16];
    pthread_t tids[16];
    int T = nthreads;
    if ((long long)T > n_reads)
        T = n_reads > 0 ? (int)n_reads : 1;
    /* contiguous read ranges; row bases via an arithmetic prefix pass */
    long long total = 0, t_next = 0;
    int t = 0;
    for (t = 0; t < T; t++) {
        jobs[t].r0 = n_reads * t / T;
        jobs[t].r1 = n_reads * (t + 1) / T;
    }
    for (t = 0; t < T; t++) {
        jobs[t].row_base = total;
        for (long long r = jobs[t].r0; r < jobs[t].r1; r++) {
            long long len = offsets[r + 1] - offsets[r];
            total += 1 + (len > width ? (len - width + step - 1) / step : 0);
        }
    }
    (void)t_next;
    for (t = 0; t < T; t++) {
        jobs[t].codes = codes;
        jobs[t].offsets = offsets;
        jobs[t].words = words;
        jobs[t].lens = lens;
        jobs[t].width = width;
        jobs[t].k = k;
        jobs[t].nw = width / 16;
        if (T > 1)
            pthread_create(&tids[t], NULL, kn_rows_worker, &jobs[t]);
        else
            kn_rows_worker(&jobs[t]);
    }
    if (T > 1)
        for (t = 0; t < T; t++)
            pthread_join(tids[t], NULL);
    return total;
}

/*
 * Exported record-boundary scanners for chunked (out-of-core) ingest:
 * return the byte offset of the first validated record start at or
 * after pos (n if none).  Used by io/ingest.iter_record_chunks to cut
 * bounded-memory file windows at exact record boundaries, so each
 * window parses standalone and the chunked feed is byte-identical to
 * the whole-file parse.
 */
long long kn_fasta_boundary_at(const char *buf, long long n, long long pos)
{
    return fasta_boundary(buf, n, pos);
}

long long kn_fastq_boundary_at(const char *buf, long long n, long long pos)
{
    return fastq_boundary(buf, n, pos);
}

long long kn_fasta_encode_mt(const char *buf, long long n, uint8_t *codes,
                             long long *offsets, long long max_reads,
                             int skip_invalid, int nthreads)
{
    return kn_reads_encode_mt(buf, n, codes, offsets, max_reads,
                              skip_invalid, nthreads, 0);
}

long long kn_fastq_encode_mt(const char *buf, long long n, uint8_t *codes,
                             long long *offsets, long long max_reads,
                             int skip_invalid, int nthreads)
{
    return kn_reads_encode_mt(buf, n, codes, offsets, max_reads,
                              skip_invalid, nthreads, 1);
}
