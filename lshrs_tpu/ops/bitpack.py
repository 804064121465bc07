"""Sign-bitpack: turn projected batches into packed per-band signature words.

The reference hashes one vector at a time with per-band GEMVs and
``np.packbits`` (`/root/reference/lshrs/hash/lsh.py:171-211`). On the
device the whole batch is hashed with one matmul ``(n, dim) @ (dim, num_perm)``;
this module handles the second half — thresholding at zero and packing the
resulting bits into little-endian ``uint32`` words, ``words_per_band =
ceil(rows_per_band / 32)`` per band, so signatures can be compared with a
handful of integer equality ops instead of byte-string hashing.

Bit layout (identical to the reference's ``packbits(bitorder="little")``
followed by little-endian word reads): global bit ``j`` belongs to band
``j // rows_per_band``, row ``j % rows_per_band``; within a band, row ``t``
lands in word ``t // 32`` at bit position ``t % 32``. Unused high bits of
the last word of a band are zero.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "words_per_band",
    "bytes_per_band",
    "pack_bits_to_words",
    "pack_bits_to_words_np",
    "words_to_band_bytes",
    "band_bytes_to_words",
    "pack_bits_dense_np",
    "dense_to_words",
    "narrow_refine_r",
    "narrow_words_count",
    "pack_words_narrow",
]


def words_per_band(rows_per_band: int) -> int:
    """Number of uint32 words needed to hold one band's bits."""
    return -(-rows_per_band // 32)


def narrow_refine_r(rows_per_band: int) -> int:
    """Bits per band in the NARROW refine-table packing, or 0 if n/a.

    The word-aligned store layout spends one uint32 per band even when
    ``rows_per_band < 32``; the refine stage is gather-bandwidth-bound, so
    its table packs several bands per word when they fit evenly
    (``32 % rows_per_band == 0``) — at the flagship shape (r=16) that
    halves refine-gather traffic. Returns
    ``rows_per_band`` when the narrow packing applies, else 0.
    """
    if 0 < rows_per_band < 32 and 32 % rows_per_band == 0:
        return rows_per_band
    return 0


def narrow_words_count(num_bands: int, rows_per_band: int) -> int:
    """uint32 words per slot in the narrow refine packing."""
    bpw = 32 // rows_per_band
    return -(-num_bands // bpw)


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band"))
def pack_words_narrow(
    words: jax.Array, *, num_bands: int, rows_per_band: int
) -> jax.Array:
    """Word-aligned signature words -> narrow refine words (device).

    Args:
        words: ``(n, num_bands)`` uint32 — one word per band (the layout
            when ``rows_per_band < 32``), only the low ``rows_per_band``
            bits of each in use.
    Returns:
        ``(n, narrow_words_count(...))`` uint32; band ``b`` occupies bits
        ``[(b % bpw) * r, ...)`` of word ``b // bpw`` (``bpw = 32 // r``).
        Unused high bits of a trailing partial word are zero.
    """
    r = rows_per_band
    bpw = 32 // r
    n = words.shape[0]
    nw = narrow_words_count(num_bands, r)
    mask = jnp.uint32((1 << r) - 1)
    pad = nw * bpw - num_bands
    w = words & mask
    if pad:
        w = jnp.pad(w, ((0, 0), (0, pad)))
    w = w.reshape(n, nw, bpw)
    shifts = (jnp.arange(bpw, dtype=jnp.uint32) * jnp.uint32(r))[None, None, :]
    return jnp.sum(w << shifts, axis=-1, dtype=jnp.uint32)


def bytes_per_band(rows_per_band: int) -> int:
    """Number of bytes in one band's dense (wire) signature."""
    return -(-rows_per_band // 8)


def pack_bits_dense_np(
    bits: np.ndarray, *, num_bands: int, rows_per_band: int
) -> np.ndarray:
    """Sign bits -> dense wire signatures, ``(n, num_bands * ceil(r/8))`` u8.

    The minimal byte encoding of a signature (the reference's per-band
    ``packbits(little)`` bytes, concatenated). Used as the serving wire
    format: for ``r = 16`` this is 32 bytes per query instead of the 64
    bytes of the uint32 word layout — transfer-bound serving ships half
    the bits. Decode on device with :func:`dense_to_words`.
    """
    n = bits.shape[0]
    if rows_per_band % 8 == 0:
        # Byte-aligned bands: the flat little-endian packing coincides
        # with the per-band layout (global bit j = band j//r, row j%r),
        # and one contiguous packbits is several times faster than the
        # banded-axis form.
        return np.packbits(
            np.ascontiguousarray(bits).reshape(n, -1), axis=-1, bitorder="little"
        )
    banded = bits.reshape(n, num_bands, rows_per_band).astype(np.uint8)
    packed = np.packbits(banded, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed.reshape(n, -1))


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band"))
def dense_to_words(
    dense: jax.Array, *, num_bands: int, rows_per_band: int
) -> jax.Array:
    """Dense wire signatures -> ``(n, num_bands * W)`` uint32 words (device).

    Inverse of :func:`pack_bits_dense_np` into the storage engine's native
    word layout; a handful of shifts/ors, negligible next to the scan.
    """
    n = dense.shape[0]
    w = words_per_band(rows_per_band)
    nb = bytes_per_band(rows_per_band)
    banded = dense.reshape(n, num_bands, nb).astype(jnp.uint32)
    pad = w * 4 - nb
    if pad:
        banded = jnp.pad(banded, ((0, 0), (0, 0), (0, pad)))
    banded = banded.reshape(n, num_bands, w, 4)
    shifts = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, None, :]
    words = jnp.sum(banded << shifts, axis=-1, dtype=jnp.uint32)
    return words.reshape(n, num_bands * w)


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band"))
def pack_bits_to_words(
    bits: jax.Array, *, num_bands: int, rows_per_band: int
) -> jax.Array:
    """Pack sign bits into per-band uint32 words on device.

    Args:
        bits: ``(n, num_bands * rows_per_band)`` boolean (or 0/1) array of
            hyperplane signs for a batch of vectors.

    Returns:
        ``(n, num_bands * words_per_band)`` uint32 array; band ``b`` owns the
        contiguous word slice ``[b * W, (b + 1) * W)``.
    """
    n = bits.shape[0]
    w = words_per_band(rows_per_band)
    banded = bits.reshape(n, num_bands, rows_per_band).astype(jnp.uint32)
    pad = w * 32 - rows_per_band
    if pad:
        banded = jnp.pad(banded, ((0, 0), (0, 0), (0, pad)))
    banded = banded.reshape(n, num_bands, w, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(banded << shifts, axis=-1, dtype=jnp.uint32)
    return words.reshape(n, num_bands * w)


def pack_bits_to_words_np(
    bits: np.ndarray, *, num_bands: int, rows_per_band: int
) -> np.ndarray:
    """NumPy twin of :func:`pack_bits_to_words` (oracle/tests/host path)."""
    n = bits.shape[0]
    w = words_per_band(rows_per_band)
    banded = bits.reshape(n, num_bands, rows_per_band).astype(np.uint8)
    # packbits(little) then zero-pad each band's bytes to a whole word count.
    packed = np.packbits(banded, axis=-1, bitorder="little")  # (n, B, ceil(r/8))
    full = np.zeros((n, num_bands, w * 4), dtype=np.uint8)
    full[:, :, : packed.shape[-1]] = packed
    words = full.view("<u4").reshape(n, num_bands * w)
    return np.ascontiguousarray(words)


def words_to_band_bytes(words_row: np.ndarray, *, num_bands: int, rows_per_band: int) -> tuple[bytes, ...]:
    """One signature row ``(num_bands * W,)`` -> per-band packed bytes.

    Truncates each band's little-endian word bytes to ``ceil(r / 8)`` so the
    result is identical to the reference's ``packbits(...).tobytes()``.
    """
    w = words_per_band(rows_per_band)
    nbytes = -(-rows_per_band // 8)
    raw = np.asarray(words_row, dtype="<u4").reshape(num_bands, w).tobytes()
    stride = w * 4
    return tuple(raw[b * stride : b * stride + nbytes] for b in range(num_bands))


def band_bytes_to_words(bands: tuple[bytes, ...], *, rows_per_band: int) -> np.ndarray:
    """Per-band packed bytes -> ``(num_bands * W,)`` uint32 word row."""
    w = words_per_band(rows_per_band)
    out = np.zeros((len(bands), w * 4), dtype=np.uint8)
    for i, band in enumerate(bands):
        buf = np.frombuffer(band, dtype=np.uint8)
        out[i, : buf.shape[0]] = buf
    return out.view("<u4").reshape(-1)
