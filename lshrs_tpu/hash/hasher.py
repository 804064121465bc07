"""Banded random-hyperplane LSH hasher, batched for the device.

Capability parity with the reference hasher
(`/root/reference/lshrs/hash/lsh.py:18-247`): deterministic seeded
projections, per-band sign signatures packed little-endian, single-vector
and batch APIs, mutable ``projections`` (for persistence restore).

Device-first differences:

- All ``num_bands`` projection matrices are one ``(num_perm, dim)`` array
  drawn from a single seeded stream (row-for-row identical to the
  reference's sequence of per-band ``(r, dim)`` draws, since NumPy fills
  C-order from one stream). The device keeps its transpose ``(dim,
  num_perm)`` so a *batch* of vectors is hashed with a single matmul —
  the reference's per-vector, per-band GEMV loop
  (`/root/reference/lshrs/hash/lsh.py:199-211`) becomes
  ``(n, dim) @ (dim, num_perm)``.
- Signatures are materialised as packed ``uint32`` words (see
  `lshrs_tpu.ops.bitpack`), the storage engine's native key format. The
  byte-string `HashSignatures` view is derived from the same bits for API
  parity and bucket-style backends.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lshrs_tpu._config.config import HashSignatures
from lshrs_tpu.hash.crosspolytope import (
    cp_bits_jax,
    cp_bits_np,
    cp_diags,
    cp_probe_bits_jax,
    cp_probe_bits_np,
    max_cp_probes,
    validate_cp_geometry,
)
from lshrs_tpu.hash.fwht import (
    structured_coords_jax,
    structured_coords_np,
    structured_diags,
)
from lshrs_tpu.ops.bitpack import (
    band_bytes_to_words,
    pack_bits_dense_np,
    pack_bits_to_words,
    pack_bits_to_words_np,
    words_per_band,
    words_to_band_bytes,
)

__all__ = ["LSHHasher"]


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band"))
def _hash_batch_words_jit(
    vectors: jax.Array, proj_t: jax.Array, *, num_bands: int, rows_per_band: int
) -> jax.Array:
    """(n, dim) float32 -> (n, num_bands * W) uint32 signature words."""
    # Full-precision matmul: the sign of near-zero projections decides hash
    # bits, so we do not let XLA downcast to bf16 here. Hashing is a tiny
    # fraction of total FLOPs; the scan/rerank kernels carry the load.
    proj = jnp.dot(
        vectors,
        proj_t,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return pack_bits_to_words(proj > 0, num_bands=num_bands, rows_per_band=rows_per_band)


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band", "n_probes"))
def _probe_words_from_coords_jit(
    coords: jax.Array, *, num_bands: int, rows_per_band: int, n_probes: int
) -> jax.Array:
    """Coords ``(n, P)`` -> multi-probe words ``(n, n_probes, BW)``.

    Probe 0 is the plain signature (``coords > 0``); probe ``t >= 1``
    flips, in EVERY band, the band's ``t``-th smallest-|coordinate| bit —
    the bit whose hyperplane the query sits closest to, i.e. the most
    likely single-bit hash miss (query-directed probing, Lv et al. 2007,
    restricted to the dominant single-bit perturbations, applied
    band-uniformly so downstream shapes stay static).
    """
    n, p = coords.shape
    r = rows_per_band
    bits = coords > 0
    outs = [
        pack_bits_to_words(
            bits, num_bands=num_bands, rows_per_band=rows_per_band
        )
    ]
    if n_probes > 1:
        margins = jnp.abs(coords).reshape(n, num_bands, r)
        # indices of the (n_probes - 1) smallest margins per band, ascending
        _, idx = jax.lax.top_k(-margins, n_probes - 1)
        bits3 = bits.reshape(n, num_bands, r)
        for t in range(1, n_probes):
            onehot = jax.nn.one_hot(idx[..., t - 1], r, dtype=jnp.bool_)
            outs.append(
                pack_bits_to_words(
                    (bits3 ^ onehot).reshape(n, num_bands * r),
                    num_bands=num_bands,
                    rows_per_band=rows_per_band,
                )
            )
    return jnp.stack(outs, axis=1)


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band"))
def _hash_batch_words_structured_jit(
    vectors: jax.Array, diags: jax.Array, *, num_bands: int, rows_per_band: int
) -> jax.Array:
    """Structured twin of :func:`_hash_batch_words_jit` (FWHT rotations)."""
    coords = structured_coords_jax(vectors, diags, num_bands * rows_per_band)
    return pack_bits_to_words(
        coords > 0, num_bands=num_bands, rows_per_band=rows_per_band
    )


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band"))
def _hash_batch_words_cp_jit(
    vectors: jax.Array, diags: jax.Array, *, num_bands: int, rows_per_band: int
) -> jax.Array:
    """Cross-polytope twin: per-band FWHT rotation + signed-argmax symbol,
    encoded as the band's ``r`` bits (`lshrs_tpu.hash.crosspolytope`)."""
    bits = cp_bits_jax(
        vectors, diags, num_bands=num_bands, rows_per_band=rows_per_band
    )
    return pack_bits_to_words(bits, num_bands=num_bands, rows_per_band=rows_per_band)


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band", "n_probes"))
def _hash_batch_probe_words_cp_jit(
    vectors: jax.Array,
    diags: jax.Array,
    *,
    num_bands: int,
    rows_per_band: int,
    n_probes: int,
) -> jax.Array:
    """Cross-polytope multi-probe words ``(n, n_probes, BW)`` — probe t is
    every band's t-th largest-|coordinate| signed axis."""
    bits = cp_probe_bits_jax(
        vectors,
        diags,
        num_bands=num_bands,
        rows_per_band=rows_per_band,
        n_probes=n_probes,
    )
    n = bits.shape[0]
    flat = pack_bits_to_words(
        bits.reshape(n * n_probes, -1),
        num_bands=num_bands,
        rows_per_band=rows_per_band,
    )
    return flat.reshape(n, n_probes, -1)


class LSHHasher:
    """Random-projection LSH hasher producing banded binary signatures.

    Attributes:
        num_bands: number of independent bands (hash tables).
        rows_per_band: hyperplanes (bits) per band.
        dim: expected input dimensionality.
        words_per_band: uint32 words per band signature, ``ceil(r / 32)``.
        hash_family: ``"gaussian"`` (reference parity: dense seeded
            hyperplanes, one matmul per batch), ``"structured"``
            (FWHT pseudo-random rotations, `lshrs_tpu.hash.fwht` — ~13x
            fewer flops per vector, native C host path, and host/device
            bit parity by construction), or ``"learned"`` (data-dependent
            hyperplanes fitted with `lshrs_tpu.hash.itq` — same dense
            matmul machinery as gaussian, only the matrix differs; pass
            it via ``projection`` or assign ``projections`` afterwards).
        projections: list of per-band ``(rows_per_band, dim)`` float32
            matrices (views into one contiguous array); assignable, for
            restore-from-disk. Gaussian and learned families.
        diagonals: the ``(nblocks, 3, dpad)`` +-1 diagonal array of the
            structured family; assignable, for restore-from-disk.
    """

    def __init__(
        self,
        num_bands: int,
        rows_per_band: int,
        dim: int,
        seed: int = 42,
        hash_family: str = "gaussian",
        projection: np.ndarray | None = None,
    ) -> None:
        if num_bands <= 0:
            raise ValueError("num_bands must be > 0")
        if rows_per_band <= 0:
            raise ValueError("rows_per_band must be > 0")
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if hash_family not in ("gaussian", "structured", "learned", "crosspolytope"):
            raise ValueError(
                "hash_family must be 'gaussian', 'structured', 'learned' "
                "or 'crosspolytope'"
            )
        if projection is not None and hash_family != "learned":
            raise ValueError(
                "an explicit projection requires hash_family='learned'"
            )

        self.num_bands = num_bands
        self.rows_per_band = rows_per_band
        self.dim = dim
        self.words_per_band = words_per_band(rows_per_band)
        self.hash_family = hash_family

        num_perm = num_bands * rows_per_band
        if hash_family == "structured":
            self._proj = None
            self._diags = structured_diags(seed, dim=dim, num_perm=num_perm)
        elif hash_family == "crosspolytope":
            validate_cp_geometry(dim, rows_per_band)
            self._proj = None
            self._diags = cp_diags(seed, dim=dim, num_bands=num_bands)
        elif projection is not None:
            p = np.asarray(projection, dtype=np.float32)
            if p.shape != (num_perm, dim):
                raise ValueError(
                    f"projection must have shape ({num_perm}, {dim}); "
                    f"received {tuple(p.shape)}"
                )
            self._proj = p.copy()
            self._diags = None
        else:
            # The "learned" family without an explicit matrix starts from
            # the same seeded draw as gaussian — persistence restore
            # constructs the hasher first and assigns the learned
            # ``projections`` afterwards (`LSHRS.load_from_disk`).
            rng = np.random.default_rng(seed)
            self._proj = rng.standard_normal((num_perm, dim)).astype(np.float32)
            self._diags = None
        self._proj_dev: jax.Array | None = None  # device operand, lazy

    # -- projections --------------------------------------------------------

    @property
    def projections(self) -> list[np.ndarray]:
        """Per-band projection matrices, reference-compatible layout."""
        if self._proj is None:
            raise ValueError(
                f"the {self.hash_family} hash family has no projection "
                "matrices; persist `diagonals` instead"
            )
        r = self.rows_per_band
        return [self._proj[b * r : (b + 1) * r] for b in range(self.num_bands)]

    @projections.setter
    def projections(self, matrices) -> None:
        if self.hash_family not in ("gaussian", "learned"):
            raise ValueError(
                "projections are assignable only on the gaussian and "
                "learned hash families"
            )
        mats = [np.asarray(m, dtype=np.float32) for m in matrices]
        if len(mats) != self.num_bands or any(
            m.shape != (self.rows_per_band, self.dim) for m in mats
        ):
            raise ValueError(
                "projections must be a sequence of "
                f"{self.num_bands} matrices of shape ({self.rows_per_band}, {self.dim})"
            )
        self._proj = np.concatenate(mats, axis=0)
        self._proj_dev = None  # re-upload lazily

    @property
    def projection_matrix(self) -> np.ndarray:
        """The fused ``(num_perm, dim)`` float32 projection matrix."""
        return self._proj

    @property
    def diagonals(self) -> np.ndarray:
        """The ±1 FWHT diagonals: ``(nblocks, 3, dpad)`` for the structured
        family, ``(num_bands, 3, dpad)`` for cross-polytope."""
        if self._diags is None:
            raise ValueError(
                f"the {self.hash_family} hash family has no diagonals; "
                "persist `projections` instead"
            )
        return self._diags

    @diagonals.setter
    def diagonals(self, arr) -> None:
        if self.hash_family not in ("structured", "crosspolytope"):
            raise ValueError(
                "diagonals are assignable only on the structured and "
                "cross-polytope hash families"
            )
        a = np.asarray(arr, dtype=np.float32)
        if a.shape != self._diags.shape or not np.all(np.abs(a) == 1.0):
            raise ValueError(
                f"diagonals must be +-1 of shape {self._diags.shape}; "
                f"received shape {a.shape}"
            )
        self._diags = a
        self._proj_dev = None  # re-upload lazily

    def _device_projection(self) -> jax.Array:
        if self._proj_dev is None:
            src = self._diags if self._proj is None else self._proj.T
            self._proj_dev = jnp.asarray(src)
        return self._proj_dev

    def device_projection(self) -> jax.Array:
        """The device-resident hash operand (lazy upload).

        ``(dim, num_perm)`` projection for the gaussian family, the
        ``(nblocks, 3, dpad)`` diagonals for the structured one. Feed this
        to `DeviceStore.add_vectors_batch` (with ``hash_family=
        hasher.hash_family``) for the fused hash+append build path; it is
        the same array the device query hash uses, so signatures agree
        bit-for-bit.
        """
        return self._device_projection()

    # -- single-vector / parity API -----------------------------------------

    def _coords_host(self, arr: np.ndarray) -> np.ndarray:
        """Host projection coordinates, ``(n, num_perm)`` float32.

        Sign-bit families only — cross-polytope signatures are argmax
        symbols, not coordinate signs, so there is no per-bit coordinate
        to expose (callers needing bits use :meth:`_bits_host`).
        """
        if self.hash_family == "crosspolytope":
            raise ValueError(
                "the cross-polytope family has no per-bit projection "
                "coordinates (signatures are signed-argmax symbols); "
                "coordinate-based estimators (asymmetric ranking) require "
                "a sign-bit hash family"
            )
        if self.hash_family == "structured":
            return structured_coords_np(
                arr, self._diags, self.num_bands * self.rows_per_band
            )
        return arr @ self._proj.T

    def _bits_host(self, arr: np.ndarray) -> np.ndarray:
        """Host signature bits, ``(n, num_perm)`` bool — family dispatch."""
        if self.hash_family == "crosspolytope":
            return cp_bits_np(
                arr,
                self._diags,
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
            )
        return self._coords_host(arr) > 0

    def hash_vector(self, vector: np.ndarray) -> HashSignatures:
        """Hash one vector to per-band packed byte signatures (host path)."""
        vec = self._validate_vector(vector)
        if self.hash_family in ("structured", "crosspolytope"):
            # FWHT association is fixed, so the batch path is bit-identical
            # for a single row (unlike BLAS, where GEMV and GEMM may round
            # differently — the gaussian family keeps the reference's GEMV).
            bits = self._bits_host(vec.reshape(1, -1))
        else:
            bits = (self._proj @ vec > 0).reshape(1, -1)
        words = pack_bits_to_words_np(
            bits, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )[0]
        return HashSignatures(
            words_to_band_bytes(
                words, num_bands=self.num_bands, rows_per_band=self.rows_per_band
            )
        )

    def hash_batch(self, vectors: np.ndarray) -> list[HashSignatures]:
        """Hash a 2-D batch to a list of `HashSignatures` (host path)."""
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError("Batch input must be a 2D array")
        if arr.shape[1] != self.dim:
            raise ValueError(
                f"Expected vectors of dimension {self.dim}, received {arr.shape[1]}"
            )
        words = self.hash_batch_words_host(arr)
        return [
            HashSignatures(
                words_to_band_bytes(
                    row, num_bands=self.num_bands, rows_per_band=self.rows_per_band
                )
            )
            for row in words
        ]

    # -- batch word-signature paths (the hot path) ---------------------------

    def hash_batch_words(self, vectors) -> jax.Array:
        """Device path: ``(n, dim)`` -> ``(n, num_bands * W)`` uint32 words.

        One matmul for the whole batch plus an on-device bitpack; this is
        what ingestion and querying against the device store use.
        """
        arr = jnp.asarray(vectors, dtype=jnp.float32)
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(
                f"Expected vectors of shape (n, {self.dim}), received {tuple(arr.shape)}"
            )
        if self.hash_family == "crosspolytope":
            return _hash_batch_words_cp_jit(
                arr,
                self._device_projection(),
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
            )
        if self.hash_family == "structured":
            return _hash_batch_words_structured_jit(
                arr,
                self._device_projection(),
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
            )
        return _hash_batch_words_jit(
            arr,
            self._device_projection(),
            num_bands=self.num_bands,
            rows_per_band=self.rows_per_band,
        )

    def hash_batch_words_host(self, vectors: np.ndarray) -> np.ndarray:
        """Host twin of :meth:`hash_batch_words` (oracle / bucket backends).

        Gaussian: one BLAS sgemm. Structured: the native FWHT path
        (`lshrs_tpu/native/fwht.c`) when it loads, NumPy otherwise — all
        bit-identical (see `lshrs_tpu.hash.fwht`).
        """
        arr = np.asarray(vectors, dtype=np.float32)
        bits = self._bits_host(arr)
        return pack_bits_to_words_np(
            bits, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )

    def hash_batch_coords_host(self, vectors: np.ndarray) -> np.ndarray:
        """Host projection coordinates, ``(n, num_perm)`` float32.

        The pre-sign values whose signs are the hash bits — the query-side
        operand of asymmetric ranking (`lshrs_tpu.ops.asymmetric`), which
        keeps the query's coordinates instead of quantising them to bits.
        """
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(
                f"Expected vectors of shape (n, {self.dim}), received {tuple(arr.shape)}"
            )
        return self._coords_host(arr)

    def hash_batch_probe_words_host(
        self, vectors: np.ndarray, n_probes: int
    ) -> np.ndarray:
        """Multi-probe signature words, ``(n, n_probes, num_bands*W)`` uint32.

        Probe 0 is the plain signature; probe ``t >= 1`` flips, in every
        band, the band's ``t``-th smallest-|coordinate| bit — the bit the
        query is most likely to disagree with a near neighbor on
        (query-directed probing). ``n_probes == 1`` is exactly
        :meth:`hash_batch_words_host` with a probe axis.

        Host/device note: for queries whose coordinates tie exactly in
        magnitude the host argsort and the device top_k may pick different
        flip bits — measure-zero for continuous data, and irrelevant to
        correctness (any distinct-bit flip set is a valid probe set).
        """
        probe_bits = self._probe_bits_host(vectors, n_probes)
        n = probe_bits.shape[0]
        b, r = self.num_bands, self.rows_per_band
        out = np.empty((n, n_probes, b * self.words_per_band), np.uint32)
        for t in range(n_probes):
            out[:, t] = pack_bits_to_words_np(
                probe_bits[:, t], num_bands=b, rows_per_band=r
            )
        return out

    def hash_batch_probe_dense_host(
        self, vectors: np.ndarray, n_probes: int
    ) -> np.ndarray:
        """Multi-probe dense wire, ``(n, n_probes, B * ceil(r/8))`` uint8.

        The minimal-byte probe encoding for shipping multi-probe query
        batches to a remote store (`snapshot_query_fn(..., probes=T,
        wire="dense")` decodes it on device); same probe construction as
        :meth:`hash_batch_probe_words_host`.
        """
        probe_bits = self._probe_bits_host(vectors, n_probes)
        n = probe_bits.shape[0]
        b, r = self.num_bands, self.rows_per_band
        first = pack_bits_dense_np(probe_bits[:, 0], num_bands=b, rows_per_band=r)
        out = np.empty((n, n_probes, first.shape[1]), np.uint8)
        out[:, 0] = first
        for t in range(1, n_probes):
            out[:, t] = pack_bits_dense_np(
                probe_bits[:, t], num_bands=b, rows_per_band=r
            )
        return out

    @property
    def max_probes(self) -> int:
        """Largest valid multi-probe depth for this hash family.

        Sign families flip one of the band's ``r`` bits per probe; the
        cross-polytope family steps through the band's ``cp_dims`` ranked
        signed axes.
        """
        if self.hash_family == "crosspolytope":
            return max_cp_probes(self.rows_per_band)
        return self.rows_per_band

    def _validate_probes(self, n_probes: int) -> None:
        if n_probes < 1 or n_probes > self.max_probes:
            bound = (
                "cp_dims"
                if self.hash_family == "crosspolytope"
                else "rows_per_band"
            )
            raise ValueError(
                f"n_probes must be in [1, {bound}] "
                f"(= {self.max_probes}); received {n_probes}"
            )

    def _probe_bits_host(self, vectors: np.ndarray, n_probes: int) -> np.ndarray:
        """Host probe construction: ``(n, n_probes, num_perm)`` bool bits."""
        self._validate_probes(n_probes)
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(
                f"Expected vectors of shape (n, {self.dim}), received {tuple(arr.shape)}"
            )
        if self.hash_family == "crosspolytope":
            return cp_probe_bits_np(
                arr,
                self._diags,
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
                n_probes=n_probes,
            )
        coords = self._coords_host(arr)
        n, num_perm = coords.shape
        b, r = self.num_bands, self.rows_per_band
        bits = coords > 0
        out = np.empty((n, n_probes, num_perm), bool)
        out[:, 0] = bits
        if n_probes > 1:
            order = np.argsort(np.abs(coords).reshape(n, b, r), axis=2)
            bits3 = bits.reshape(n, b, r)
            rows = np.arange(n)[:, None]
            cols = np.arange(b)[None, :]
            for t in range(1, n_probes):
                bt = bits3.copy()
                bt[rows, cols, order[:, :, t - 1]] ^= True
                out[:, t] = bt.reshape(n, num_perm)
        return out

    def hash_batch_probe_words(self, vectors, n_probes: int) -> jax.Array:
        """Device twin of :meth:`hash_batch_probe_words_host`.

        The base probe comes from the same device matmul as
        :meth:`hash_batch_words`, so probe 0 agrees bit-for-bit with
        device-hashed store signatures (the per-store hash-path
        invariant).
        """
        self._validate_probes(n_probes)
        arr = jnp.asarray(vectors, dtype=jnp.float32)
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(
                f"Expected vectors of shape (n, {self.dim}), received {tuple(arr.shape)}"
            )
        if self.hash_family == "crosspolytope":
            return _hash_batch_probe_words_cp_jit(
                arr,
                self._device_projection(),
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
                n_probes=n_probes,
            )
        if self.hash_family == "structured":
            coords = structured_coords_jax(
                arr,
                self._device_projection(),
                self.num_bands * self.rows_per_band,
            )
        else:
            coords = jnp.dot(
                arr,
                self._device_projection(),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        return _probe_words_from_coords_jit(
            coords,
            num_bands=self.num_bands,
            rows_per_band=self.rows_per_band,
            n_probes=n_probes,
        )

    def hash_batch_dense_host(self, vectors: np.ndarray) -> np.ndarray:
        """Host hash to the dense wire format, ``(n, B * ceil(r/8))`` uint8.

        The minimal-byte signature encoding for shipping query batches to a
        remote device store (`lshrs_tpu.ops.bitpack.pack_bits_dense_np`);
        decode on device with `lshrs_tpu.ops.bitpack.dense_to_words`.
        """
        arr = np.asarray(vectors, dtype=np.float32)
        bits = self._bits_host(arr)
        return pack_bits_dense_np(
            bits, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )

    # -- conversions ---------------------------------------------------------

    def signature_to_words(self, signatures: HashSignatures) -> np.ndarray:
        """`HashSignatures` bytes -> ``(num_bands * W,)`` uint32 words."""
        return band_bytes_to_words(
            signatures.as_tuple(), rows_per_band=self.rows_per_band
        )

    def words_to_signature(self, words_row: np.ndarray) -> HashSignatures:
        """``(num_bands * W,)`` uint32 words -> `HashSignatures` bytes."""
        return HashSignatures(
            words_to_band_bytes(
                np.asarray(words_row),
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
            )
        )

    # -- validation ----------------------------------------------------------

    def _validate_vector(self, vector: np.ndarray) -> np.ndarray:
        vec = np.asarray(vector, dtype=np.float32).reshape(-1)
        if vec.ndim != 1 or vec.shape[0] != self.dim:
            raise ValueError(
                f"Expected vector of dimension {self.dim}, received {vec.shape}"
            )
        return vec
