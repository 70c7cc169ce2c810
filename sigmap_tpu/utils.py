"""Shared host-side helpers: 2-bit DNA codes, timers, formatting.

Mirrors the semantics of the reference lookup tables (utils.h:73-94) and
rolling seed hash (utils.h:96-115) with vectorized numpy equivalents.
"""

from __future__ import annotations

import os
import time

import numpy as np

# A/C/G/T -> 0/1/2/3, everything else (incl. '\0' and N) -> 4
# (reference: utils.h:73-84)
CHAR_TO_CODE = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate("ACGT"):
    CHAR_TO_CODE[ord(b)] = i
    CHAR_TO_CODE[ord(b.lower())] = i

CODE_TO_CHAR = np.frombuffer(b"ACGTNNNN", dtype=np.uint8)


def encode_bases(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0..3, 4=ambiguous}."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return CHAR_TO_CODE[arr]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space: 3^code, N (4) -> 7 -> maps to 'N'.

    Matches SequenceBatch::PrepareNegativeSequenceAt (sequence_batch.h:66-77):
    complement is (3 ^ code) even for code 4 (N -> 7 -> 'N' char -> code 4
    when re-encoded), so we canonicalize any code >3 back to 4.
    """
    rc = (3 ^ codes[::-1]).astype(np.uint8)
    rc[codes[::-1] > 3] = 4
    return rc


def seed_from_codes(codes: np.ndarray, start: int, length: int,
                    limit: int | None = None) -> int:
    """Rolling 2-bit seed of `length` bases at `start`.

    Ambiguous bases and positions >= limit shift in 0 (A), matching
    GenerateSeedFromSequence (utils.h:96-115).
    """
    if limit is None:
        limit = len(codes)
    mask = (1 << (2 * length)) - 1
    seed = 0
    for i in range(length):
        p = start + i
        b = int(codes[p]) if p < limit else 4
        seed = ((seed << 2) | (b if b < 4 else 0)) & mask
    return seed


def rolling_kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Vectorized 2-bit packed k-mers for every start position [0, L-k].

    Ambiguous bases contribute code 0 (A), as in the reference's rolling
    hash (utils.h:104-112).  Returns uint64[L-k+1].
    """
    b = np.where(codes < 4, codes, 0).astype(np.uint64)
    L = len(b)
    if L < k:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(L - k + 1, dtype=np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | b[i : L - k + 1 + i]
    return out


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


def fmt_float(x: float) -> str:
    """C++ std::to_string(float/double): printf %f, 6 decimals."""
    return f"{float(x):.6f}"


# fixed default cache directory: the path is part of the cache key, so it
# must not move between runs of one checkout
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and no
    directory is set here; otherwise the cache lives in <checkout>/.jax_cache.
    Safe to call repeatedly."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_COMPILE_CACHE
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
