"""ASCII <-> 2-bit codec for DNA / kmer / qkmer values.

This replaces the reference's per-character validation loops
(``validate_sequence`` at /root/reference/kmer.c:20-41 and the qkmer
alphabet loop at kmer.c:156-183) with table-lookup vectorized encoders,
and defines the packed representation every device kernel operates on.

Representation
--------------
* A nucleotide is a 2-bit code: a=0, c=1, g=2, t=3.  This ordering equals
  the byte order of the lowercase letters ('a'<'c'<'g'<'t'), so every
  ordering / prefix / equality semantic of the reference's ``memcmp``-based
  C code (kmer.c:54, kmer.c:243) carries over to integer comparisons.
* A k-mer (k <= 32) packs left-aligned into a 64-bit key: base ``i`` sits
  at bit positions ``[62-2i, 63-2i]``; unused low bits are zero.  On device
  the key is carried as two uint32 lanes ``(hi, lo)`` (JAX runs without
  x64 mode) with ``hi`` holding bases 0..15 and ``lo`` bases 16..31.
  Lexicographic string order == tuple order ``(key64, length)``.
* A qkmer is a vector of 4-bit IUPAC one-hot masks over {a,c,g,t}
  (bit b set <=> code b allowed).  ``match(pattern, base)`` of the
  reference (kmer.h:21-53) becomes ``(mask >> code) & 1``.  The mask
  table reproduces the reference's quirk that 'u' is accepted on input
  (kmer.c:165) but matches nothing (no 'u' case in kmer.h's switch):
  mask('u') = 0.  All 16 mask values are distinct, so qkmer decoding is
  exact.
"""

from __future__ import annotations

import numpy as np

from .errors import (
    InvalidDnaSequenceError,
    InvalidQkmerSequenceError,
    KmerTooLongError,
    QkmerTooLongError,
)

MAX_K = 32  # mirrors MAX_KMER_LENGTH, /root/reference/kmer.h:18

# --- lookup tables -----------------------------------------------------------

# ASCII -> 2-bit code; -1 for invalid characters.
CODE_LUT = np.full(256, -1, dtype=np.int8)
for _i, _ch in enumerate("acgt"):
    CODE_LUT[ord(_ch)] = _i
    CODE_LUT[ord(_ch.upper())] = _i

# 2-bit code -> ASCII (always lowercase: the reference lowercases on input,
# kmer.c:28-29, and always prints lowercase).
CODE_TO_CHAR = np.frombuffer(b"acgt", dtype=np.uint8)

# IUPAC pattern char -> 4-bit nucleotide mask; -1 invalid.
# a=1 c=2 g=4 t=8; degenerate codes are unions; u=0 (reference quirk).
IUPAC_MASKS = {
    "a": 1, "c": 2, "g": 4, "t": 8,
    "u": 0,           # accepted by qkmer_in (kmer.c:165) but never matches (kmer.h:50-51)
    "r": 1 | 4,       # puRine: a|g
    "y": 2 | 8,       # pYrimidine: c|t
    "k": 4 | 8,       # Keto: g|t
    "m": 1 | 2,       # aMino: a|c
    "s": 2 | 4,       # Strong: c|g
    "w": 1 | 8,       # Weak: a|t
    "b": 2 | 4 | 8,   # not a
    "d": 1 | 4 | 8,   # not c
    "h": 1 | 2 | 8,   # not g
    "v": 1 | 2 | 4,   # not t
    "n": 1 | 2 | 4 | 8,
}
MASK_LUT = np.full(256, -1, dtype=np.int8)
for _ch, _m in IUPAC_MASKS.items():
    MASK_LUT[ord(_ch)] = _m
    MASK_LUT[ord(_ch.upper())] = _m

# 4-bit mask -> qkmer character (all 16 values are distinct => invertible).
MASK_TO_CHAR = np.zeros(16, dtype=np.uint8)
for _ch, _m in IUPAC_MASKS.items():
    MASK_TO_CHAR[_m] = ord(_ch)

# Exact-base masks, used to find determinate positions when pruning
# qkmer index searches.
_EXACT_MASKS = (1, 2, 4, 8)

# --- host-side encode / decode ----------------------------------------------


def _to_bytes(seq) -> bytes:
    if isinstance(seq, bytes):
        return seq
    if isinstance(seq, str):
        return seq.encode("ascii", errors="replace")
    if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
        return seq.tobytes()
    raise TypeError(f"expected str/bytes, got {type(seq)!r}")


def encode_dna(seq) -> np.ndarray:
    """Validate + encode a DNA string to 2-bit codes (uint8 array).

    Equivalent of dna_in -> validate_sequence (kmer.c:84-97): any character
    outside [AaCcGgTt] raises InvalidDnaSequenceError.  Empty input is legal
    and returns a zero-length array.
    """
    raw = np.frombuffer(_to_bytes(seq), dtype=np.uint8)
    codes = CODE_LUT[raw]
    if codes.size and codes.min() < 0:
        raise InvalidDnaSequenceError()
    return codes.astype(np.uint8)


def encode_kmer(seq) -> np.ndarray:
    """Validate + encode a kmer string (<= 32 chars) to 2-bit codes.

    Mirrors kmer_in (kmer.c:109-129): the length check precedes alphabet
    validation, so an over-long invalid string reports the length error.
    """
    b = _to_bytes(seq)
    if len(b) > MAX_K:
        raise KmerTooLongError()
    raw = np.frombuffer(b, dtype=np.uint8)
    codes = CODE_LUT[raw]
    if codes.size and codes.min() < 0:
        raise InvalidDnaSequenceError()
    return codes.astype(np.uint8)


def encode_qkmer(seq) -> np.ndarray:
    """Validate + encode a qkmer string to 4-bit IUPAC masks.

    Mirrors qkmer_in (kmer.c:141-190): length check first, then alphabet
    check against acgtu + rykmswbdhvn (case-insensitive).
    """
    b = _to_bytes(seq)
    if len(b) > MAX_K:
        raise QkmerTooLongError()
    raw = np.frombuffer(b, dtype=np.uint8)
    masks = MASK_LUT[raw]
    if masks.size and masks.min() < 0:
        raise InvalidQkmerSequenceError()
    return masks.astype(np.uint8)


def decode_codes(codes: np.ndarray) -> str:
    """2-bit codes -> lowercase string (dna_out/kmer_out, kmer.c:99-106,131-138)."""
    codes = np.asarray(codes, dtype=np.uint8)
    return CODE_TO_CHAR[codes].tobytes().decode("ascii")


def decode_masks(masks: np.ndarray) -> str:
    """4-bit IUPAC masks -> lowercase qkmer string (qkmer_out, kmer.c:192-199)."""
    masks = np.asarray(masks, dtype=np.uint8)
    return MASK_TO_CHAR[masks].tobytes().decode("ascii")


# --- packing -----------------------------------------------------------------


def pack_key64(codes: np.ndarray) -> np.uint64:
    """Pack <=32 2-bit codes into a left-aligned uint64 key."""
    codes = np.asarray(codes, dtype=np.uint64)
    if codes.size > MAX_K:
        raise ValueError("kmer longer than 32")
    key = np.uint64(0)
    for c in codes:
        key = np.uint64(key << np.uint64(2)) | c
    key = np.uint64(key << np.uint64(2 * (MAX_K - codes.size)))
    return key


def split_key64(key: np.uint64) -> tuple[np.uint32, np.uint32]:
    """uint64 key -> (hi, lo) uint32 lanes."""
    key = np.uint64(key)
    return np.uint32(key >> np.uint64(32)), np.uint32(key & np.uint64(0xFFFFFFFF))


def join_key64(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 -> uint64 key (elementwise over arrays)."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def unpack_key64(key: np.uint64, length: int) -> np.ndarray:
    """Left-aligned uint64 key -> 2-bit codes array of the given length."""
    key = np.uint64(key)
    shifts = np.uint64(62) - np.uint64(2) * np.arange(length, dtype=np.uint64)
    return ((key >> shifts) & np.uint64(3)).astype(np.uint8)


def pack_batch(codes: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a padded [N, MAX_K] code matrix into (key64[N]) given lengths.

    Vectorized host packing for building indexes over kmer columns.
    Padding positions (>= length) contribute zero bits.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    n, w = codes.shape
    pos = np.arange(w, dtype=np.uint64)
    valid = pos[None, :] < np.asarray(lengths, dtype=np.uint64)[:, None]
    shifts = np.uint64(62) - np.uint64(2) * pos
    contrib = np.where(valid, codes << shifts[None, :], np.uint64(0))
    return contrib.sum(axis=1, dtype=np.uint64), np.asarray(lengths, dtype=np.int32)


def strings_to_padded_codes(seqs, width: int | None = None,
                            encoder=encode_dna) -> tuple[np.ndarray, np.ndarray]:
    """Encode a list of strings into a padded [N, width] uint8 code matrix + lengths."""
    enc = [encoder(s) for s in seqs]
    lengths = np.array([e.size for e in enc], dtype=np.int32)
    if width is None:
        width = int(lengths.max()) if len(enc) else 0
    out = np.zeros((len(enc), width), dtype=np.uint8)
    for i, e in enumerate(enc):
        out[i, : e.size] = e
    return out, lengths


def is_exact_mask(mask: int) -> bool:
    """True if a qkmer position pins exactly one nucleotide."""
    return mask in _EXACT_MASKS


def exact_mask_to_code(mask: int) -> int:
    """4-bit one-hot mask -> 2-bit code (mask must be exact)."""
    return {1: 0, 2: 1, 4: 2, 8: 3}[mask]
