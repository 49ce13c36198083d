"""Sliding-window k-mer extraction (generate_kmers).

The reference emits one kmer per Postgres executor call in an SRF loop
(/root/reference/kmer.c:287-351) — its #1 hot loop.  Here extraction is a
batched, fully-vectorized transform: for a code stream of length n and a
static k, all ``n-k+1`` windows are produced at once as packed (hi, lo)
lanes via k shifted adds — no scan, no data-dependent control flow, so XLA
fuses it with downstream counting/predicates.

Contract (SURVEY.md §2.4 #7): windows are emitted left-to-right, duplicates
preserved; errors for k <= 0, k > 32, or k > len(dna) use the reference's
exact message "Invalid KMER Length" (kmer.c:310-313).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import codec
from ..errors import InvalidKmerLengthError
from ..packed import PackedKmers
from ..types import Dna, Kmer


def generate_kmers(dna, k: int) -> list[Kmer]:
    """Parity form: list of Kmer windows, in order, duplicates preserved.

    Mirrors generate_kmers (kmer.c:287-351) including its validation:
    len(dna) < k, k <= 0, or k > 32 -> "Invalid KMER Length".
    """
    d = Dna(dna)
    k = int(k)
    if len(d) < k or k <= 0 or k > codec.MAX_K:
        raise InvalidKmerLengthError()
    codes = d.codes
    return [Kmer.from_codes(codes[i : i + k]) for i in range(len(d) - k + 1)]


def extract_windows(codes, k: int):
    """codes [n] (uint8/int32) -> (hi, lo) uint32 arrays of n-k+1 packed windows.

    Pure-JAX vectorized form: k static shifted adds. Window i packs
    codes[i:i+k] left-aligned (base j at bits 62-2j of the 64-bit key).
    """
    codes = jnp.asarray(codes)
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        raise InvalidKmerLengthError()
    hi = jnp.zeros((m,), jnp.uint32)
    lo = jnp.zeros((m,), jnp.uint32)
    for j in range(k):
        c = codes[j : j + m].astype(jnp.uint32)
        if j < 16:
            hi = hi | (c << jnp.uint32(30 - 2 * j))
        else:
            lo = lo | (c << jnp.uint32(30 - 2 * (j - 16)))
    return hi, lo


def extract_windows_batch(codes, lengths, k: int) -> tuple[PackedKmers, jnp.ndarray]:
    """Batched extraction over padded reads.

    codes: [B, L] 2-bit codes (padded); lengths: [B]; k: static.
    Returns (PackedKmers with shape [B, L-k+1], valid mask [B, L-k+1]).
    Window (b, i) is valid iff i <= lengths[b] - k.  Length lanes of the
    result are the constant k (broadcast), kept for downstream uniformity.
    """
    codes = jnp.asarray(codes)
    b, n = codes.shape
    m = n - k + 1
    if m <= 0:
        raise InvalidKmerLengthError()
    hi = jnp.zeros((b, m), jnp.uint32)
    lo = jnp.zeros((b, m), jnp.uint32)
    for j in range(k):
        c = codes[:, j : j + m].astype(jnp.uint32)
        if j < 16:
            hi = hi | (c << jnp.uint32(30 - 2 * j))
        else:
            lo = lo | (c << jnp.uint32(30 - 2 * (j - 16)))
    valid = jnp.arange(m, dtype=jnp.int32)[None, :] <= (
        jnp.asarray(lengths, jnp.int32)[:, None] - k
    )
    length = jnp.full((b, m), k, jnp.int32)
    return PackedKmers(hi=hi, lo=lo, length=length), valid


# --- canonicalization --------------------------------------------------------
#
# Canonical form = min(kmer, reverse_complement(kmer)) — not part of the
# reference's surface (flag off for parity), but first-class for the
# counting north star (BASELINE.json).


def _reverse_pairs32(x):
    """Reverse the order of the 16 2-bit groups within each uint32 lane."""
    x = jnp.asarray(x, jnp.uint32)
    x = ((x & jnp.uint32(0x0000FFFF)) << 16) | ((x & jnp.uint32(0xFFFF0000)) >> 16)
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x & jnp.uint32(0xFF00FF00)) >> 8)
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x & jnp.uint32(0xF0F0F0F0)) >> 4)
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x & jnp.uint32(0xCCCCCCCC)) >> 2)
    return x


def revcomp_packed(hi, lo, k: int):
    """Reverse complement of left-aligned packed k-mers of static length k.

    Complement of a 2-bit code c is 3-c == ~c; reversing the 32 pairs of
    the 64-bit key right-aligns the rc, and shifting left by 2*(32-k)
    re-left-aligns while discarding the complemented padding.
    """
    ch, cl = ~jnp.asarray(hi, jnp.uint32), ~jnp.asarray(lo, jnp.uint32)
    # full 64-bit 2-bit-group reversal: reverse within lanes then swap lanes
    rh, rl = _reverse_pairs32(cl), _reverse_pairs32(ch)
    # now (rh, rl) is the rc right-aligned in 64 bits; shift left by s = 64-2k
    s = 64 - 2 * k
    if s == 0:
        return rh, rl
    if s < 32:
        sh = jnp.uint32(s)
        nh = (rh << sh) | (rl >> jnp.uint32(32 - s))
        nl = rl << sh
    else:
        sh = jnp.uint32(s - 32)
        nh = rl << sh
        nl = jnp.zeros_like(rl)
    return nh, nl


def canonicalize(hi, lo, k: int):
    """min((hi,lo), revcomp(hi,lo)) lexicographically, elementwise."""
    rh, rl = revcomp_packed(hi, lo, k)
    fwd_less = (hi < rh) | ((hi == rh) & (lo <= rl))
    return jnp.where(fwd_less, hi, rh), jnp.where(fwd_less, lo, rl)


# --- packed-word extraction (phase-major) ------------------------------------
#
# Windows computed directly from the 2-bit packed wire format (uint32
# words, 16 bases/word, left-aligned) without materializing byte codes:
# 4x less HBM input traffic.  Window at flat base position p = 16w + r
# spans words w..w+2; for a fixed phase r every window is the same
# shifted combination of (words, words>>1 word, words>>2 words), so the
# result is produced phase-major as [16, n_words] lanes.  Counting
# doesn't care about emission order — only the multiset and validity.


def _top_mask(bits: int):
    return jnp.uint32(0xFFFFFFFF) << jnp.uint32(32 - bits) if bits else jnp.uint32(0)


def extract_from_words(words, k: int):
    """words [nw] uint32 -> (hi, lo) [16, nw] phase-major packed windows.

    Window at flat position p = 16*w + r is (hi[r, w], lo[r, w]); windows
    whose tail passes the stream end read zeros (callers mask validity).
    """
    words = jnp.asarray(words, jnp.uint32)
    w0 = words
    w1 = jnp.concatenate([words[1:], jnp.zeros((1,), jnp.uint32)])
    w2 = jnp.concatenate([words[2:], jnp.zeros((2,), jnp.uint32)])
    his, los = [], []
    mh = _top_mask(min(k, 16) * 2)
    ml = _top_mask(max(k - 16, 0) * 2)
    for r in range(16):
        s = jnp.uint32(2 * r)
        if r == 0:
            hi_r, lo_r = w0, w1
        else:
            rs = jnp.uint32(32 - 2 * r)
            hi_r = (w0 << s) | (w1 >> rs)
            lo_r = (w1 << s) | (w2 >> rs)
        his.append(hi_r & mh)
        los.append(lo_r & ml)
    return jnp.stack(his), jnp.stack(los)


def phase_major_valid(n_words: int, read_len: int, n_reads: int, k: int):
    """Validity for phase-major windows over reads concatenated back-to-back.

    Flat position p = 16*w + r is a valid window start iff
    (p mod read_len) <= read_len - k and p < n_reads*read_len - k + 1.
    """
    w = jnp.arange(n_words, dtype=jnp.int32)[None, :]
    r = jnp.arange(16, dtype=jnp.int32)[:, None]
    p = 16 * w + r
    in_read = (p % read_len) <= (read_len - k)
    in_stream = p <= (n_reads * read_len - k)
    return in_read & in_stream


# --- host-side convenience ---------------------------------------------------


def extract_to_strings(dna, k: int) -> list[str]:
    """generate_kmers returning plain lowercase strings (test convenience)."""
    return [str(km) for km in generate_kmers(dna, k)]


def simulate_reads(num_reads: int, read_len: int, seed: int = 0) -> np.ndarray:
    """Random 2-bit code reads [num_reads, read_len] (benchmark inputs)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(num_reads, read_len), dtype=np.uint8)


def simulate_coverage_reads(
    num_reads: int, read_len: int, genome_bases: int, seed: int = 0
) -> np.ndarray:
    """Reads sampled from one random genome — realistic sequencing shape.

    Unlike uniform-random reads (every k-mer ~unique), coverage reads
    repeat each genomic k-mer ~(num_reads*read_len/genome_bases) times
    and share 16-base prefixes heavily — the regime where counting's
    equal-key runs get long (the group sort's fallback path) and where
    dedup/merge actually shrinks tables.
    """
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_bases, dtype=np.uint8)
    starts = rng.integers(0, genome_bases - read_len + 1, size=num_reads)
    idx = starts[:, None] + np.arange(read_len)[None, :]
    reads = genome[idx]
    # reverse-complement half the reads (sequencing strands)
    flip = rng.random(num_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    return reads
