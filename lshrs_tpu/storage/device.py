"""Device-resident signature store — the accelerator index engine.

Where the reference keeps bucket membership in Redis sets and pays one
network round-trip per band per query
(`/root/reference/lshrs/storage/redis.py:40,282`), this store keeps every
indexed vector's packed banded signature in device memory and answers
queries with fused scans (`lshrs_tpu.ops.scan`, `lshrs_tpu.ops.pallas_scan`):

    layout (all device arrays, statically shaped, power-of-two capacity):
        sig_t   (num_bands * W, capacity)  uint32   transposed signatures
                                                    (slot axis minor:
                                                    contiguous compares)
        ids     (capacity,)                int32    vector id, -1 = dead
        tie     (capacity,)                int32    global id-rank key
        ranks   (capacity,)                int32    per-chunk id-rank
        payload (capacity, dim)            float32  optional resident vectors

A band "bucket" is implicit: the set of slots whose band-b words equal a
given signature. Collision counting therefore needs no hash-table probing
at all — it is a dense, regular, vectorised compare, with exact reference
semantics for any (b, r) since full signatures (not lossy bucket hashes)
are compared.

Query strategy: the grouped fast path (count + key + group-max — a GPU
kernel where one serves — then exact candidate-group refinement) when the
selection key fits int32; the chunked `lax.scan` fallback otherwise. Both orderings are bit-identical
to the reference's ``(-count, id)``.

Mutation model: appends go to the tail via `dynamic_update_slice` (inputs
padded to powers of two so jit caches stay small); re-ingesting an id
overwrites its slot in place (upsert); deletion tombstones slots (id -> -1)
and is O(deleted), not a full key scan like the reference's SCAN+SREM
(`/root/reference/lshrs/storage/redis.py:419`). Capacity doubles
geometrically, so at most ~log2(N) recompiles over an index's lifetime.
"""

from __future__ import annotations

import threading
from collections.abc import Iterable, Sequence
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lshrs_tpu.ops.bitpack import (
    band_bytes_to_words,
    bytes_per_band,
    dense_to_words,
    narrow_refine_r,
    pack_words_narrow,
    words_per_band,
)
from lshrs_tpu.ops.bucketed import bucketed_topk, build_bucket_index
from lshrs_tpu.ops.hamming import (
    hamming_topk,
    hamming_topk_cascade,
    hamming_topk_cascade_core,
    hamming_topk_chunked,
    hamming_topk_chunked_core,
    hamming_topk_core,
    hamming_topk_packed,
    hamming_topk_packed_chunked,
    hamming_topk_packed_chunked_core,
    hamming_topk_packed_core,
    supports_hamming_grouped,
    unpack_bitplanes,
)
from lshrs_tpu.ops.rerank import (
    rerank_topp,
    rerank_topp_batch_core,
    rerank_topp_gather,
    rerank_topp_gather_core,
)
from lshrs_tpu.ops.pallas_scan import scan_kernel
from lshrs_tpu.ops.scan import (
    build_grouped_refine_rows,
    collision_counts,
    collision_topk,
    collision_topk_core,
    collision_topk_grouped,
    collision_topk_grouped_core,
    compute_chunk_ranks,
    compute_global_tie,
    supports_fast_path,
)
from lshrs_tpu.storage.base import BaseStorage, BucketOperation

__all__ = ["DeviceStore"]

_MAX_ID = 2**31 - 1


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _device_bytes_limit() -> int:
    """Memory JAX may use on the first device, in bytes
    (``memory_stats()["bytes_limit"]``). Backends that report no memory
    statistics (the CPU) count as 32 GiB."""
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", 32 << 30))


@partial(jax.jit, donate_argnums=(0, 1))
def _append_jit(sig_t, ids, new_sig_t, new_ids, offset):
    sig_t = jax.lax.dynamic_update_slice(sig_t, new_sig_t, (0, offset))
    ids = jax.lax.dynamic_update_slice(ids, new_ids, (offset,))
    return sig_t, ids


def _hash_words_fused(x, proj_t, *, num_bands, rows_per_band, hash_family="gaussian"):
    # HIGHEST precision: identical matmul spec to the query hash path
    # (`lshrs_tpu.hash.hasher._hash_batch_words_jit`), so fused-built rows
    # self-match device-hashed queries. The compiler may still pick a
    # different matmul algorithm per batch shape, so a projection within
    # rounding of zero can flip sign; `chip_smoke.py` measures how often.
    # For the structured family ``proj_t`` is the (nblocks, 3, dpad) diagonal array and the projection is the
    # fixed-association FWHT (`lshrs_tpu.hash.fwht`), identical to every
    # other structured hash path by construction.
    from lshrs_tpu.ops.bitpack import pack_bits_to_words

    if hash_family == "crosspolytope":
        from lshrs_tpu.hash.crosspolytope import cp_bits_jax

        bits = cp_bits_jax(
            x, proj_t, num_bands=num_bands, rows_per_band=rows_per_band
        )
        return pack_bits_to_words(
            bits, num_bands=num_bands, rows_per_band=rows_per_band
        )
    if hash_family == "structured":
        from lshrs_tpu.hash.fwht import structured_coords_jax

        proj = structured_coords_jax(x, proj_t, num_bands * rows_per_band)
    else:
        proj = jnp.dot(
            x,
            proj_t,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    return pack_bits_to_words(
        proj > 0, num_bands=num_bands, rows_per_band=rows_per_band
    )


@partial(
    jax.jit,
    donate_argnums=(0, 1, 2),
    static_argnames=("num_bands", "rows_per_band", "hash_family"),
)
def _hash_append_jit(
    sig_t, sig_rows, ids, x, proj_t, new_ids, offset, *, num_bands, rows_per_band,
    hash_family="gaussian",
):
    """ONE device program: hash (matmul + bitpack) + tail-append — the
    bulk-build hot path: raw vectors go up once and never come back."""
    w = _hash_words_fused(
        x, proj_t, num_bands=num_bands, rows_per_band=rows_per_band,
        hash_family=hash_family,
    )
    sig_t = jax.lax.dynamic_update_slice(sig_t, w.T, (0, offset))
    sig_rows = jax.lax.dynamic_update_slice(sig_rows, w, (offset, 0))
    ids = jax.lax.dynamic_update_slice(ids, new_ids, (offset,))
    return sig_t, sig_rows, ids, w


def _cast_payload_rows(x, jdtype):
    """Cast raw float32 rows to the resident payload dtype.

    ``int8``: symmetric per-row quantization ``rows = round(x / s)`` with
    scale ``s = max|x| / 127`` (zero rows get s=1). Returns
    ``(rows, pscale)`` — ``pscale`` is None for float dtypes. The cosine
    rerank never needs the scale (it cancels: ``pnorm`` stores the norm
    of the integer rows); the scale exists only to reconstruct vector
    magnitudes (`get_vectors`, checkpoints, dot-mode score fidelity).
    Re-quantizing a dequantized row reproduces the int8 rows
    bit-for-bit (the max coordinate lands on exactly +-127, and the
    <=2e-7 relative scale recovery error never moves a coordinate
    across a rounding boundary), so query results survive a checkpoint
    round-trip unchanged; the recovered scale itself may differ in the
    last f32 ulp.
    """
    if jdtype == jnp.int8:
        s = jnp.max(jnp.abs(x), axis=1) / 127.0
        s = jnp.where(s > 0, s, 1.0).astype(jnp.float32)
        rows = jnp.clip(jnp.round(x / s[:, None]), -127, 127).astype(jnp.int8)
        return rows, s
    return x.astype(jdtype), None


@partial(
    jax.jit,
    donate_argnums=(0, 1, 2, 3, 4, 5),
    static_argnames=("num_bands", "rows_per_band", "payload_dtype", "hash_family"),
)
def _hash_append_payload_jit(
    sig_t, sig_rows, ids, payload, pnorm, pscale, x, proj_t, new_ids, offset,
    *, num_bands, rows_per_band, payload_dtype, hash_family="gaussian",
):
    """`_hash_append_jit` + payload/pnorm append, still one dispatch."""
    w = _hash_words_fused(
        x, proj_t, num_bands=num_bands, rows_per_band=rows_per_band,
        hash_family=hash_family,
    )
    sig_t = jax.lax.dynamic_update_slice(sig_t, w.T, (0, offset))
    sig_rows = jax.lax.dynamic_update_slice(sig_rows, w, (offset, 0))
    ids = jax.lax.dynamic_update_slice(ids, new_ids, (offset,))
    rows, ps = _cast_payload_rows(x, payload_dtype)
    payload = jax.lax.dynamic_update_slice(payload, rows, (offset, 0))
    pnorm = jax.lax.dynamic_update_slice(
        pnorm, jnp.linalg.norm(rows.astype(jnp.float32), axis=1), (offset,)
    )
    if ps is not None:
        pscale = jax.lax.dynamic_update_slice(pscale, ps, (offset,))
    return sig_t, sig_rows, ids, payload, pnorm, pscale, w


@partial(jax.jit, donate_argnums=(0,))
def _append_rows_jit(arr, new_rows, offset):
    return jax.lax.dynamic_update_slice(arr, new_rows, (offset, 0))


@partial(
    jax.jit,
    donate_argnums=(0,),
    static_argnames=("num_bands", "rows_per_band", "hash_family", "step"),
)
def _rehash_block_jit(
    sig_rows, payload, proj_t, offset,
    *, num_bands, rows_per_band, hash_family, step,
):
    """Re-hash ``step`` payload rows at ``offset`` into the new signature
    row array — one donated device program per block, so peak extra memory
    stays O(step * dim) regardless of capacity. int8 payload rows hash
    as raw integers: the positive per-row scale cannot change the sign
    of any projection, so the bits equal those of the dequantized rows.
    """
    x = jax.lax.dynamic_slice(
        payload, (offset, 0), (step, payload.shape[1])
    ).astype(jnp.float32)
    w = _hash_words_fused(
        x, proj_t, num_bands=num_bands, rows_per_band=rows_per_band,
        hash_family=hash_family,
    )
    return jax.lax.dynamic_update_slice(sig_rows, w, (offset, 0))


@partial(jax.jit, donate_argnums=(0,))
def _scatter_cols_jit(sig_t, slots, cols):
    # Out-of-range slots (used as padding) are dropped, not clamped.
    return sig_t.at[:, slots].set(cols, mode="drop")


@partial(jax.jit, donate_argnums=(0,))
def _scatter_rows_jit(arr, slots, rows):
    return arr.at[slots].set(rows, mode="drop")


@partial(jax.jit, donate_argnums=(0,))
def _tombstone_jit(ids, slots):
    return ids.at[slots].set(-1, mode="drop")


@jax.jit
def _mask_delete_jit(ids, sorted_dels):
    pos = jnp.clip(jnp.searchsorted(sorted_dels, ids), 0, sorted_dels.shape[0] - 1)
    hit = (sorted_dels[pos] == ids) & (ids >= 0)
    return jnp.where(hit, -1, ids), hit.sum()


@partial(jax.jit, static_argnames=("w",))
def _band_bucket_jit(band_words_t, ids, q_band, *, w):
    match = jnp.ones(band_words_t.shape[1], dtype=bool)
    for j in range(w):
        match &= band_words_t[j, :] == q_band[j]
    return match & (ids >= 0)


@partial(jax.jit, static_argnames=("num_bands", "chunk", "max_out", "probes"))
def _topp_batch_jit(
    sig_t, ids, payload, pnorm, qw, qv, *, num_bands, chunk, max_out, probes=1
):
    from lshrs_tpu.ops.scan import collision_counts_core

    counts = collision_counts_core(
        sig_t, ids, qw, num_bands=num_bands, chunk=chunk, probes=probes
    )
    # bf16 wire queries are cast up inside the rerank core (which also
    # picks the matmul precision from the incoming dtype).
    return rerank_topp_batch_core(payload, pnorm, ids, counts, qv, max_out=max_out)


class DeviceStore(BaseStorage):
    """Device-resident LSH signature store with fused query kernels.

    Args:
        num_bands / rows_per_band: banding scheme (must match the hasher).
        dim: vector dimensionality; required when ``store_vectors``.
        store_vectors: keep a float32 payload matrix resident so top-p
            cosine reranking needs no ``vector_fetch_fn`` round-trip.
        initial_capacity: starting slot count (rounded up to a power of
            two, at least ``chunk_size``).
        chunk_size: fallback scan tile; must satisfy
            ``(num_bands + 1) * chunk_size < 2**31`` for exact key packing.
        group_size: group width of the fast-path group-max selection.
        dedupe: track id -> slot on host so re-ingesting an id overwrites
            its slot (upsert) and deletes are O(1) lookups. Disable for
            maximum-scale streaming ingest of known-unique ids.
        query_mode: ``"scan"`` (dense fused scan, default) or ``"bucket"``
            (sorted band keys + binary search, see `lshrs_tpu.ops.bucketed`).
        bucket_cap: per-(query, band) candidate window of the bucketed
            engine; longer bucket runs are truncated and counted.
        enable_hamming: make `query_hamming` (full-signature SimHash
            ranking) available.
        hamming_storage: ``"planes"`` (default) ranks on +-1 int8
            bitplanes — ``num_perm`` bytes/slot extra device memory,
            int8 matmul rate, materialized lazily on the first Hamming
            use and maintained incrementally after; ``"packed"`` ranks
            via XOR+popcount over the packed words the collision scan
            already stores — zero extra memory. Results are
            bit-identical.
        hamming_cascade: coarse prefix width (bits) of the two-pass
            refinement cascade — the >=4M-slot Hamming engine
            (`lshrs_tpu.ops.hamming.hamming_topk_cascade_core`). 0
            (default) = off (single-pass exact ranking). When set, the
            store materializes ONLY the first ``hamming_cascade``
            bitplane columns (``hamming_cascade`` bytes/slot instead of
            ``num_perm`` — 4x less ranking memory at 64/256), scans them
            at ``hamming_cascade / num_perm`` of the full matmul cost, and
            re-ranks the top ``hamming_cascade_refine`` slots per query
            by the exact full-width popcount from the packed words.
            Approximate: the prefix pass can exclude a true top-k slot.
            Incompatible with asymmetric-mode queries (they rank against
            full-width bitplanes).
        hamming_cascade_refine: per-query refine pool of the cascade, in
            slots (rounded up to whole selection groups, floored at k).
        payload_dtype: resident payload precision (``store_vectors``):
            ``"float32"`` (default; value-exact cosines),
            ``"bfloat16"`` — HALF the payload memory (the dominant array
            at scale: 2*dim bytes/slot instead of 4*dim), cosine rerank
            then runs a native bf16 matmul with ~1e-3 relative rounding —
            or ``"int8"`` — a QUARTER of f32 (dim + 8 bytes/slot
            including norm + reconstruction scale): rows store
            ``round(127 * x / max|x|)`` per-row-scaled; the scale cancels
            out of the cosine (pnorm is the integer rows' norm), so
            rerank ranks by the cosine of the quantized direction
            (~4e-3 relative rounding at 768d) and the gather engine
            moves 4x fewer payload-gather bytes.
        rerank_engine: top-p rerank formulation — ``"full"`` (one
            ``(Q, C)`` cosine matmul over the whole store; exact, but
            brute-force-kNN cost at scale), ``"gather"`` (candidate-gather:
            select the top ``rerank_candidates`` candidates by collision
            count, gather ONLY their payload rows, rerank the small block —
            cost scales with candidates, not capacity; exact whenever the
            candidate set fits, detected per query) or ``"auto"``
            (default: gather past ``_GATHER_MIN_CAPACITY`` slots when the
            expected candidate load fits, full otherwise).
        rerank_candidates: per-query candidate budget of the gather engine.
    """

    supports_signature_batches = True

    def __init__(
        self,
        *,
        num_bands: int,
        rows_per_band: int,
        dim: int | None = None,
        store_vectors: bool = False,
        initial_capacity: int = 1 << 14,
        chunk_size: int = 2048,
        group_size: int = 64,
        dedupe: bool = True,
        query_mode: str = "scan",
        bucket_cap: int = 128,
        enable_hamming: bool = False,
        hamming_storage: str = "planes",
        hamming_cascade: int = 0,
        hamming_cascade_refine: int = 2048,
        payload_dtype: str = "float32",
        rerank_engine: str = "auto",
        rerank_candidates: int = 1024,
    ) -> None:
        if chunk_size <= 0 or chunk_size > 1 << 14:
            raise ValueError("chunk_size must be in (0, 16384]")
        if payload_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                "payload_dtype must be 'float32', 'bfloat16' or 'int8'"
            )
        if rerank_engine not in ("auto", "full", "gather"):
            raise ValueError("rerank_engine must be 'auto', 'full' or 'gather'")
        if rerank_candidates <= 0:
            raise ValueError("rerank_candidates must be greater than zero")
        if (num_bands + 1) * chunk_size >= 2**31:
            raise ValueError("num_bands * chunk_size too large for exact top-k keys")
        if store_vectors and not dim:
            raise ValueError("dim is required when store_vectors=True")
        if group_size & (group_size - 1):
            raise ValueError("group_size must be a power of two")
        if query_mode not in ("scan", "bucket"):
            raise ValueError("query_mode must be 'scan' or 'bucket'")
        if hamming_storage not in ("planes", "packed"):
            raise ValueError("hamming_storage must be 'planes' or 'packed'")
        if hamming_cascade:
            num_perm = num_bands * rows_per_band
            if not enable_hamming or hamming_storage != "planes":
                raise ValueError(
                    "hamming_cascade requires enable_hamming=True with "
                    'hamming_storage="planes" (the coarse pass scans a '
                    "bitplane prefix)"
                )
            if (
                hamming_cascade % 32
                or not 0 < hamming_cascade < num_perm
            ):
                raise ValueError(
                    "hamming_cascade must be a positive multiple of 32 "
                    f"below num_perm (= {num_perm}); received "
                    f"{hamming_cascade}"
                )
            if hamming_cascade_refine <= 0:
                raise ValueError(
                    "hamming_cascade_refine must be greater than zero"
                )

        self.num_bands = num_bands
        self.rows_per_band = rows_per_band
        self.words = num_bands * words_per_band(rows_per_band)
        # Narrow refine-table packing (bands share words when they divide
        # 32 evenly) — halves refine-gather traffic at r=16, measured
        # -22 ms per 16k queries at 131k slots. 0 = word-aligned tables.
        self._refine_narrow_r = narrow_refine_r(rows_per_band)
        self.dim = dim
        self.store_vectors = store_vectors
        self.chunk = chunk_size
        self.group = group_size
        self.dedupe = dedupe
        self.query_mode = query_mode
        self.bucket_cap = bucket_cap
        self.enable_hamming = enable_hamming
        self.hamming_storage = hamming_storage
        self.hamming_cascade = hamming_cascade
        self.hamming_cascade_refine = hamming_cascade_refine
        self.payload_dtype = payload_dtype
        self.rerank_engine = rerank_engine
        self.rerank_candidates = rerank_candidates
        self._rerank_truncations = 0
        self._payload_jdtype = {
            "bfloat16": jnp.bfloat16,
            "int8": jnp.int8,
        }.get(payload_dtype, jnp.float32)
        # Lazily (re)built sorted bucket index (see lshrs_tpu.ops.bucketed).
        self._bucket_index: tuple | None = None
        self._bucket_overflows = 0

        cap = _next_pow2(max(chunk_size, initial_capacity))
        self._capacity = cap
        self._alloc(cap)
        self._size = 0  # high-water mark of used slots (including tombstones)
        self._tombstones = 0
        self._slot_of: dict[int, int] | None = {} if dedupe else None
        # Bumped on every mutation; snapshot_query_fn closures check it
        # (appends donate the state buffers, so captured arrays die).
        self._generation = 0
        # Re-entrant: compact() holds it across snapshot + clear + reload,
        # which re-enter add_signature_batch.
        self._lock = threading.RLock()
        # Bucket-op staging: index -> {band_id: bytes}, flushed to the array
        # store once all bands of a vector have arrived (bucket-level parity
        # path only; the signature-batch path never stages).
        self._pending_ops: dict[int, dict[int, bytes]] = {}

    def _alloc(self, cap: int) -> None:
        self._sig_t = jnp.zeros((self.words, cap), dtype=jnp.uint32)
        # Row-major twin of sig_t: refinement gathers whole contiguous rows
        # (words + tie + id appended lazily, see _refine_rows) instead of
        # minor-axis elements.
        self._sig_rows = jnp.zeros((cap, self.words), dtype=jnp.uint32)
        self._rows_ext: dict = {}  # grouped refine tables per geometry
        self._ids = jnp.full((cap,), -1, dtype=jnp.int32)
        self._ranks = jnp.zeros((cap,), dtype=jnp.int32)
        self._tie = jnp.full((cap,), -1, dtype=jnp.int32)
        self._payload = (
            jnp.zeros((cap, self.dim), dtype=self._payload_jdtype)
            if self.store_vectors
            else None
        )
        self._pnorm = (
            jnp.zeros((cap,), dtype=jnp.float32) if self.store_vectors else None
        )
        # Per-row quantization scales (int8 payload only): reconstruction
        # metadata, never read by the query path (see _cast_payload_rows).
        self._pscale = (
            jnp.zeros((cap,), dtype=jnp.float32)
            if self.store_vectors and self._payload_jdtype == jnp.int8
            else None
        )
        # Bitplanes are LAZY: materialized from the packed words on the
        # first Hamming use (`_ensure_planes`), then maintained by
        # appends/overwrites. An index that never ranks by Hamming — or
        # an auto-engine index below the ranking switch — pays zero of
        # the num_perm bytes/slot.
        self._planes = None
        self._ranks_dirty = False  # fresh arrays are self-consistent

    # -- query path selection ------------------------------------------------

    def _use_grouped(self) -> bool:
        return (
            supports_fast_path(self.num_bands, self._capacity)
            and self.num_bands <= 64
            and self._capacity % self.group == 0
        )

    def _local_rows(self) -> int:
        """Slots one device scans (all of them here; a shard's when sharded)."""
        return self._capacity

    def _scan_kernel(self, width: int = 16) -> str | None:
        """Group-max route of this store's grouped scans: the GPU kernel
        (`lshrs_tpu.ops.pallas_scan.scan_kernel`) or None for plain XLA.
        ``width`` is the bitplane width the dot kernel contracts over
        (`_plane_bits`)."""
        local = self._local_rows()
        return scan_kernel(local, min(self.group, local), width=width)

    # Rerank engine crossover: the full engine's (Q, C) HIGHEST matmul
    # grows with capacity, the gather engine's cost with the candidate
    # budget, so auto picks gather past ``C ~ 2560 * max_candidates`` (and
    # never below the absolute floor, where the full matmul is trivially
    # cheap). Both constants are provisional until measured on the GPU.
    _GATHER_MIN_CAPACITY = 1 << 18
    _GATHER_CROSSOVER_SLOTS_PER_CANDIDATE = 2560

    def _full_rerank_temp_budget(self) -> int:
        """Bytes the full rerank engine may take for its (Q, C) counts and
        float32 sims (8 bytes per query and slot): a quarter of the
        device's memory. Past it auto takes gather regardless of expected
        truncation, since the full engine would not fit."""
        return _device_bytes_limit() // 4

    def _scan_impls(self) -> dict:
        """Which implementation serves each grouped engine's group-max:
        ``"triton"`` (the GPU kernel) or ``"xla"``; None where the engine
        is off. The packed Hamming storage always runs on XLA."""
        ham = None
        if self.enable_hamming:
            planes = self.hamming_storage == "planes"
            ham = (planes and self._scan_kernel(self._plane_bits())) or "xla"
        return {"collision": self._scan_kernel() or "xla", "hamming": ham}

    def _gather_usable(self) -> bool:
        return self.store_vectors and self._use_grouped()

    def _expected_candidates(self) -> float:
        """Expected colliding candidates per query for random pairs:
        ``alive * (1 - (1 - 2^-r)^b) ~ alive * b * 2^-r``. Real workloads
        with near-duplicates exceed this; truncations are counted."""
        alive = max(0, self._size - self._tombstones)
        r = min(self.rows_per_band, 40)  # avoid float underflow theatrics
        return alive * (1.0 - (1.0 - 2.0**-r) ** self.num_bands)

    def _resolve_rerank_engine(
        self, engine: str | None, max_candidates: int | None, q: int = 1024
    ) -> tuple[str, int]:
        engine = engine if engine is not None else self.rerank_engine
        mc = max_candidates if max_candidates is not None else self.rerank_candidates
        if engine not in ("auto", "full", "gather"):
            raise ValueError("rerank engine must be 'auto', 'full' or 'gather'")
        if mc <= 0:
            raise ValueError("max_candidates must be greater than zero")
        if engine == "gather" and not self._gather_usable():
            raise RuntimeError(
                "rerank_engine='gather' requires store_vectors=True and the "
                "grouped fast path (capacity within int32 key packing)"
            )
        if engine == "auto":
            rows = self._local_rows()  # the rerank cost model's rows
            # Feasibility first: when the full engine's (Q, C) temporaries
            # cannot fit in memory, a truncated gather beats a guaranteed OOM.
            full_infeasible = (
                q * rows * 8 > self._full_rerank_temp_budget()
                and self._gather_usable()
            )
            engine = (
                "gather"
                if full_infeasible
                or (
                    self._gather_usable()
                    and rows >= self._GATHER_MIN_CAPACITY
                    # past the measured cost crossover (see the model above)
                    and rows >= mc * self._GATHER_CROSSOVER_SLOTS_PER_CANDIDATE
                    # a gather budget the expected load would blow through
                    # on most queries just truncates; stay on full.
                    and self._expected_candidates() <= mc / 2
                )
                else "full"
            )
        return engine, mc

    def _refresh_ranks(self) -> None:
        """Mark selection keys stale after a mutation (recomputed lazily).

        Ranks/ties are only read by queries; recomputing them eagerly would
        put two capacity-wide argsorts (and, sharded, a shard_map) on every
        ingest batch's critical path.
        """
        self._ranks_dirty = True
        self._bucket_index = None  # any mutation invalidates the index
        self._rows_ext = {}
        self._generation += 1

    def _ensure_ranks(self) -> None:
        """Recompute rank/tie keys if stale (call under the lock, before
        any query that reads ``_ranks``/``_tie``/``_refine_rows``)."""
        if self._ranks_dirty:
            self._ranks = compute_chunk_ranks(self._ids, chunk=self.chunk)
            self._tie = compute_global_tie(self._ids)
            self._ranks_dirty = False

    def _ensure_planes(self) -> None:
        """Materialize the int8 bitplane array on first Hamming use.

        Built from the packed words already stored (bit-identical by
        construction), then kept current by the append/overwrite paths.
        Call under the lock. Does NOT bump the generation — nothing the
        existing snapshots captured changes.
        """
        if (
            not self.enable_hamming
            or self.hamming_storage != "planes"
            or self._planes is not None
        ):
            return
        self._planes = self._materialize_planes()

    # Bound the unpack intermediate (slice_rows x num_bands x W x 32
    # uint32) to ~1 GB per dispatch during materialization.
    _PLANES_MATERIALIZE_STEP = 1 << 17

    def _plane_bits(self) -> int:
        """Stored bitplane width: the cascade prefix, or full num_perm."""
        return self.hamming_cascade or self.num_bands * self.rows_per_band

    def _cascade_groups(self, k: int) -> int:
        """Coarse-pass group pool of the cascade: ``hamming_cascade_refine``
        slots rounded up to whole selection groups, floored at k."""
        group = min(self.group, self._capacity)
        return max(k, -(-self.hamming_cascade_refine // group))

    def _planes_rows(self, words: jax.Array) -> jax.Array:
        """Bitplane rows for a batch of packed words, at the stored width
        (the cascade keeps only the first ``hamming_cascade`` columns)."""
        rows = unpack_bitplanes(
            words, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )
        pb = self._plane_bits()
        return rows if rows.shape[1] == pb else rows[:, :pb]

    def _materialize_planes(self) -> jax.Array:
        p = self._plane_bits()
        planes = jnp.zeros((self._capacity, p), dtype=jnp.int8)
        step = min(self._PLANES_MATERIALIZE_STEP, self._capacity)
        for off in range(0, self._capacity, step):
            rows = jax.lax.dynamic_slice_in_dim(self._sig_rows, off, step, 0)
            planes = jax.lax.dynamic_update_slice(
                planes, self._planes_rows(rows), (off, 0)
            )
        return planes

    # At most this many refine-table geometries (group widths) stay
    # resident. Each table is ~(BW + 2) * 4 bytes/slot (~72 MB at 1M slots
    # for BW=16); two bounds device memory when geometries churn (e.g.
    # group_size sweeps).
    _MAX_REFINE_GEOMETRIES = 2

    def _refine_rows(self, group: int) -> jax.Array:
        """Lazily built GROUPED refine table for ``group``-slot groups.

        ``(C // group, group * (BW + 2))`` uint32 — each row concatenates
        one selection group's per-slot (words | tie | id) rows (contiguous
        slot runs, the group-max geometry of every scan). Refinement then
        gathers one wide row per candidate group instead of ``group``
        narrow per-slot rows. Cached per group width with LRU eviction
        past ``_MAX_REFINE_GEOMETRIES`` (each table costs ``(BW + 2) * 4``
        bytes/slot of device memory); invalidated on any mutation.
        Eviction only drops this store's reference — serving closures
        that captured a table keep it alive independently.
        """
        key = group
        cached = self._rows_ext.pop(key, None)
        if cached is None:
            self._ensure_ranks()  # the tie column must be fresh
            words = self._sig_rows
            if self._refine_narrow_r:
                words = pack_words_narrow(
                    words,
                    num_bands=self.num_bands,
                    rows_per_band=self._refine_narrow_r,
                )
            ext = jnp.concatenate(
                [
                    words,
                    jax.lax.bitcast_convert_type(self._tie, jnp.uint32)[:, None],
                    jax.lax.bitcast_convert_type(self._ids, jnp.uint32)[:, None],
                ],
                axis=1,
            )
            cached = build_grouped_refine_rows(ext, group=group)
        # Re-insert last (dict preserves insertion order = LRU order).
        self._rows_ext[key] = cached
        while len(self._rows_ext) > self._MAX_REFINE_GEOMETRIES:
            self._rows_ext.pop(next(iter(self._rows_ext)))
        return cached

    # ------------------------------------------------------------------
    # signature-batch ingestion (the device path)
    # ------------------------------------------------------------------

    def add_signature_batch(
        self,
        indices: Sequence[int] | np.ndarray,
        words,
        vectors: np.ndarray | None = None,
    ) -> None:
        """Insert/overwrite a batch of ``(id, packed-signature)`` rows.

        Args:
            indices: integer ids, each in ``[0, 2**31)``.
            words: ``(n, num_bands * W)`` uint32 signature words (host or
                device array; device arrays stay on device), or the dense
                uint8 wire encoding ``(n, num_bands * ceil(r/8))`` from
                `LSHHasher.hash_batch_dense_host` — half the transfer
                bytes for ``rows_per_band <= 16``; decoded on device.
            vectors: ``(n, dim)`` float32 payload rows, required when
                ``store_vectors``.
        """
        ids_np = np.asarray(indices, dtype=np.int64).reshape(-1)
        if ids_np.size == 0:
            return
        if ids_np.min() < 0 or ids_np.max() > _MAX_ID:
            raise ValueError("indices must be in [0, 2**31) for the device store")
        n = ids_np.size
        if getattr(words, "dtype", None) == np.uint8:
            nb = self.num_bands * bytes_per_band(self.rows_per_band)
            if tuple(words.shape) != (n, nb):
                raise ValueError(
                    f"dense signatures must have shape ({n}, {nb}); "
                    f"received {tuple(words.shape)}"
                )
            words = dense_to_words(
                jnp.asarray(words),
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
            )
        if tuple(words.shape) != (n, self.words):
            raise ValueError(
                f"signature words must have shape ({n}, {self.words}); "
                f"received {tuple(words.shape)}"
            )
        if self.store_vectors:
            if vectors is None:
                raise ValueError("vectors are required when store_vectors=True")
            if tuple(vectors.shape) != (n, self.dim):
                raise ValueError(
                    f"vectors must have shape ({n}, {self.dim}); "
                    f"received {tuple(vectors.shape)}"
                )

        ids32 = ids_np.astype(np.int32)
        with self._lock:
            if self._slot_of is not None and self._needs_upsert(ids32):
                # Slow path: duplicate or already-present ids; resolve the
                # upserts host-side (pulls the words to host).
                words = np.asarray(words, dtype=np.uint32)
                if vectors is not None:
                    vectors = np.asarray(vectors, dtype=np.float32)
                # Within-batch duplicates: keep the last occurrence (upsert
                # semantics), preserving order of last occurrences.
                _, last_pos = np.unique(ids32[::-1], return_index=True)
                keep = np.sort(ids32.size - 1 - last_pos)
                if keep.size != ids32.size:
                    ids32, words = ids32[keep], words[keep]
                    if vectors is not None:
                        vectors = vectors[keep]
                id_list = ids32.tolist()
                existing_mask = np.fromiter(
                    (i in self._slot_of for i in id_list),
                    dtype=bool,
                    count=ids32.size,
                )
                if existing_mask.any():
                    slots = np.fromiter(
                        (self._slot_of[i] for i in ids32[existing_mask].tolist()),
                        dtype=np.int32,
                        count=int(existing_mask.sum()),
                    )
                    self._overwrite(
                        slots,
                        words[existing_mask],
                        vectors[existing_mask] if vectors is not None else None,
                    )
                    ids32 = ids32[~existing_mask]
                    words = words[~existing_mask]
                    if vectors is not None:
                        vectors = vectors[~existing_mask]
            if ids32.size:
                self._append(ids32, words, vectors)

    def add_vectors_batch(
        self,
        indices: Sequence[int] | np.ndarray,
        vectors,
        proj_t,
        hash_family: str = "gaussian",
    ) -> None:
        """Fused device build: hash + append a raw-vector batch in ONE
        device program (`_hash_append_jit`).

        This is the bulk-ingest hot path for device-resident vectors
        (e.g. embeddings produced on the same device). The hash matmul
        runs the same program spec the device query path uses
        (HIGHEST-precision ``(n, dim) @ (dim, num_perm)``); projections
        within rounding of zero may still differ in sign between batch
        shapes (see `_hash_words_fused`).

        Args:
            indices: integer ids in ``[0, 2**31)``.
            vectors: ``(n, dim)`` float32 — device array (stays resident)
                or host array (uploaded once).
            proj_t: the device hash operand from
                `LSHHasher.device_projection` — ``(dim, num_perm)``
                float32 projection for the gaussian family, the
                ``(nblocks, 3, dpad)`` diagonals for the structured one.
            hash_family: `LSHHasher.hash_family` of the hasher that
                produced ``proj_t`` (gaussian/learned take the matmul
                branch; structured/crosspolytope the FWHT ones).

        Batches containing duplicate or already-present ids take the
        hash-then-upsert slow path (same result, more dispatches).
        """
        ids_np = np.asarray(indices, dtype=np.int64).reshape(-1)
        if ids_np.size == 0:
            return
        if ids_np.min() < 0 or ids_np.max() > _MAX_ID:
            raise ValueError("indices must be in [0, 2**31) for the device store")
        n = ids_np.size
        x = jnp.asarray(vectors, dtype=jnp.float32)
        if x.ndim != 2 or (self.dim is not None and x.shape[1] != self.dim):
            raise ValueError(
                f"vectors must have shape ({n}, {self.dim}); "
                f"received {tuple(x.shape)}"
            )
        if x.shape[0] != n:
            raise ValueError(
                f"vectors must have shape ({n}, {x.shape[1]}); "
                f"received {tuple(x.shape)}"
            )
        if hash_family == "crosspolytope":
            # The CP device hash materialises the FULL per-band rotations
            # — an (n, num_bands * dpad) f32 transient (dpad = the padded
            # FWHT width) that hits 17 GB at n = 131k x 32 bands x 1024.
            # Slice the fused program so the transient stays ~2 GB; the
            # slices pipeline through the async dispatch queue, so the
            # extra dispatches cost RTTs, not serialised device time.
            dpad = 1 << (int(x.shape[1]) - 1).bit_length()
            # n_max = 2 GiB / (num_bands * dpad * 4 B)
            max_rows = max(4096, (1 << 29) // max(1, self.num_bands * dpad))
            if n > max_rows:
                for i in range(0, n, max_rows):
                    self.add_vectors_batch(
                        ids_np[i : i + max_rows],
                        jax.lax.slice_in_dim(x, i, min(i + max_rows, n)),
                        proj_t,
                        hash_family=hash_family,
                    )
                return
        proj_dev = jnp.asarray(proj_t, dtype=jnp.float32)
        ids32 = ids_np.astype(np.int32)
        with self._lock:
            if self._slot_of is not None and self._needs_upsert(ids32):
                # Upsert path: hash with the SAME jitted program the query
                # path uses (bit-agreement), then the generic upsert logic.
                from lshrs_tpu.hash.hasher import (
                    _hash_batch_words_cp_jit,
                    _hash_batch_words_jit,
                    _hash_batch_words_structured_jit,
                )

                hash_jit = {
                    "structured": _hash_batch_words_structured_jit,
                    "crosspolytope": _hash_batch_words_cp_jit,
                }.get(hash_family, _hash_batch_words_jit)
                words = hash_jit(
                    x,
                    proj_dev,
                    num_bands=self.num_bands,
                    rows_per_band=self.rows_per_band,
                )
                self.add_signature_batch(
                    ids_np, words, np.asarray(x) if self.store_vectors else None
                )
                return
            pad = _next_pow2(n)
            if self._size + pad > self._capacity:
                self._grow(max(2 * self._capacity, _next_pow2(self._size + pad)))
            ids_p = np.full(pad, -1, dtype=np.int32)
            ids_p[:n] = ids32
            if pad != n:
                # zero rows hash to the all-zero signature on dead slots
                x = jnp.pad(x, ((0, pad - n), (0, 0)))
            offset = np.int32(self._size)
            if self._payload is not None:
                (
                    self._sig_t, self._sig_rows, self._ids,
                    self._payload, self._pnorm, self._pscale, w,
                ) = _hash_append_payload_jit(
                    self._sig_t, self._sig_rows, self._ids,
                    self._payload, self._pnorm, self._pscale,
                    x, proj_dev, jnp.asarray(ids_p), offset,
                    num_bands=self.num_bands,
                    rows_per_band=self.rows_per_band,
                    payload_dtype=self._payload_jdtype,
                    hash_family=hash_family,
                )
            else:
                self._sig_t, self._sig_rows, self._ids, w = _hash_append_jit(
                    self._sig_t, self._sig_rows, self._ids,
                    x, proj_dev, jnp.asarray(ids_p), offset,
                    num_bands=self.num_bands,
                    rows_per_band=self.rows_per_band,
                    hash_family=hash_family,
                )
            if self._planes is not None:
                self._planes = _append_rows_jit(
                    self._planes, self._planes_rows(w), offset
                )
            self._append_finish(ids32, n)

    def _needs_upsert(self, ids32: np.ndarray) -> bool:
        """True when the batch contains duplicate or already-present ids.

        The common streaming case (all-new unique ids) takes the device-only
        append path; only genuine upserts pay a host round trip.
        """
        if np.unique(ids32).size != ids32.size:
            return True
        slot_of = self._slot_of
        id_list = ids32.tolist()  # one C-level conversion, not per-element
        return any(i in slot_of for i in id_list)

    def _overwrite(self, slots: np.ndarray, words_np: np.ndarray, vectors) -> None:
        pad = _next_pow2(slots.size)
        slots_p = np.full(pad, self._capacity, dtype=np.int32)  # OOB -> dropped
        slots_p[: slots.size] = slots
        words_p = np.zeros((pad, self.words), dtype=np.uint32)
        words_p[: slots.size] = words_np
        self._sig_t = _scatter_cols_jit(
            self._sig_t, jnp.asarray(slots_p), jnp.asarray(words_p.T)
        )
        self._sig_rows = _scatter_rows_jit(
            self._sig_rows, jnp.asarray(slots_p), jnp.asarray(words_p)
        )
        self._rows_ext = {}
        self._bucket_index = None  # upserts change signatures in place
        self._generation += 1
        if self._payload is not None and vectors is not None:
            rows_p = np.zeros((pad, self.dim), dtype=np.float32)
            rows_p[: slots.size] = vectors
            rows_d, ps = _cast_payload_rows(
                jnp.asarray(rows_p), self._payload_jdtype
            )
            self._payload = _scatter_rows_jit(
                self._payload, jnp.asarray(slots_p), rows_d
            )
            self._pnorm = self._pnorm.at[jnp.asarray(slots_p)].set(
                jnp.linalg.norm(rows_d.astype(jnp.float32), axis=1), mode="drop"
            )
            if ps is not None:
                self._pscale = self._pscale.at[jnp.asarray(slots_p)].set(
                    ps, mode="drop"
                )
        if self._planes is not None:
            self._planes = _scatter_rows_jit(
                self._planes,
                jnp.asarray(slots_p),
                self._planes_rows(jnp.asarray(words_p)),
            )
        # ids unchanged -> ranks unchanged.

    def _append_prep(self, ids32: np.ndarray, words, vectors):
        """Shared tail-append staging: grow if needed, pad the batch to a
        power of two (small jit cache), return device-ready arrays."""
        n = ids32.size
        pad = _next_pow2(n)
        if self._size + pad > self._capacity:
            self._grow(max(2 * self._capacity, _next_pow2(self._size + pad)))
        ids_p = np.full(pad, -1, dtype=np.int32)
        ids_p[:n] = ids32
        # Device-resident batches are padded on device (no d2h).
        words_dev = jnp.asarray(words, dtype=jnp.uint32)
        if pad != n:
            words_dev = jnp.pad(words_dev, ((0, pad - n), (0, 0)))
        rows = pscale = None
        if self._payload is not None:
            # Store-precision rows: norms are computed from the ROUNDED
            # payload so the cosine denominator matches the stored bits.
            rows, pscale = _cast_payload_rows(
                jnp.asarray(vectors, dtype=jnp.float32), self._payload_jdtype
            )
            if pad != n:
                rows = jnp.pad(rows, ((0, pad - n), (0, 0)))
                if pscale is not None:
                    pscale = jnp.pad(pscale, (0, pad - n))
        return n, ids_p, words_dev, rows, pscale

    def _append_finish(self, ids32: np.ndarray, n: int) -> None:
        if self._slot_of is not None:
            base = self._size
            self._slot_of.update(zip(ids32.tolist(), range(base, base + n)))
        self._size += n
        self._refresh_ranks()

    def _append(self, ids32: np.ndarray, words, vectors) -> None:
        n, ids_p, words_dev, rows, pscale = self._append_prep(
            ids32, words, vectors
        )
        offset = np.int32(self._size)
        self._sig_t, self._ids = _append_jit(
            self._sig_t, self._ids, words_dev.T, jnp.asarray(ids_p), offset
        )
        self._sig_rows = _append_rows_jit(self._sig_rows, words_dev, offset)
        if self._payload is not None:
            self._payload = _append_rows_jit(self._payload, rows, offset)
            self._pnorm = jax.lax.dynamic_update_slice(
                self._pnorm,
                jnp.linalg.norm(rows.astype(jnp.float32), axis=1),
                (offset,),
            )
            if pscale is not None:
                self._pscale = jax.lax.dynamic_update_slice(
                    self._pscale, pscale, (offset,)
                )
        if self._planes is not None:
            self._planes = _append_rows_jit(
                self._planes, self._planes_rows(words_dev), offset
            )
        self._append_finish(ids32, n)

    def _grow(self, new_cap: int) -> None:
        new_cap = _next_pow2(new_cap)
        sig_t = jnp.zeros((self.words, new_cap), dtype=jnp.uint32)
        ids = jnp.full((new_cap,), -1, dtype=jnp.int32)
        self._sig_t = sig_t.at[:, : self._capacity].set(self._sig_t)
        self._sig_rows = (
            jnp.zeros((new_cap, self.words), dtype=jnp.uint32)
            .at[: self._capacity]
            .set(self._sig_rows)
        )
        self._ids = ids.at[: self._capacity].set(self._ids)
        if self._payload is not None:
            payload = jnp.zeros((new_cap, self.dim), dtype=self._payload_jdtype)
            self._payload = payload.at[: self._capacity].set(self._payload)
            pnorm = jnp.zeros((new_cap,), dtype=jnp.float32)
            self._pnorm = pnorm.at[: self._capacity].set(self._pnorm)
            if self._pscale is not None:
                pscale = jnp.zeros((new_cap,), dtype=jnp.float32)
                self._pscale = pscale.at[: self._capacity].set(self._pscale)
        if self._planes is not None:
            planes = jnp.zeros((new_cap, self._plane_bits()), dtype=jnp.int8)
            self._planes = planes.at[: self._capacity].set(self._planes)
        self._capacity = new_cap
        self._refresh_ranks()

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    @staticmethod
    def _norm_qwords(qwords) -> tuple[jax.Array, int]:
        """Normalize query words to ``((Q, probes*BW) uint32, probes)``.

        Accepts the standard ``(Q, BW)`` layout and the multi-probe
        ``(Q, T, BW)`` layout (`LSHHasher.hash_batch_probe_words_host`).

        Multi-probe CONTRACT: within each band, a query's T probe
        signatures must be pairwise DISTINCT (the hashers' probe
        generators guarantee this — each variant flips a distinct bit).
        Any-match counting relies on it: a duplicated variant counts its
        band twice, inflating counts past ``num_bands`` and, at the
        packing limit, corrupting the (count, tie) selection keys. Pad a
        ragged probe axis by flipping further distinct bits, never by
        repeating a signature.
        """
        qw = jnp.asarray(qwords, dtype=jnp.uint32)
        if qw.ndim == 3:
            q, t, bw = qw.shape
            return qw.reshape(q, t * bw), t
        return qw, 1

    def _filtered_ids_tie(self, where) -> tuple[jax.Array, jax.Array]:
        """(ids, tie) with ``where``-inadmissible slots marked dead.

        The filtered columns flow through every query core exactly like
        tombstones (id/tie < 0 => key 0), so filtered results equal
        brute force over the admitted subset. Grouped fast paths must
        drop their prebuilt refine tables when filtering (the tables
        bake in the UNfiltered tie/id columns) — callers pass
        ``sig_rows=None`` and the cores fall back to per-slot gathers.
        """
        if where is None:
            return self._ids, self._tie
        from lshrs_tpu.storage.filter import as_filter

        return as_filter(where).device_state(self)

    def _query_topk_dev(
        self, qw: jax.Array, k: int, probes: int = 1, where=None
    ) -> tuple[jax.Array, jax.Array]:
        """Device-resident top-k (no host transfer of the results)."""
        self._ensure_ranks()
        ids_x, tie_x = self._filtered_ids_tie(where)
        k_eff = max(1, min(k, self._capacity))
        # The bucketed engine packs (count, tie) into int32; past the packing
        # limit it would silently corrupt keys, so fall through to the scan.
        # Multi-probe queries also fall through (the bucket index probes
        # exact band keys only), as do filtered queries (the bucket index
        # bakes in the unfiltered tie column).
        if self.query_mode == "bucket" and probes == 1 and where is None \
                and supports_fast_path(self.num_bands, self._capacity):
            if self._bucket_index is None:
                self._bucket_index = build_bucket_index(
                    self._sig_t, self._ids, num_bands=self.num_bands
                )
            skeys, order = self._bucket_index
            counts, out_ids, overflows = bucketed_topk(
                self._sig_t, self._ids, self._tie, skeys, order, qw,
                num_bands=self.num_bands,
                k=k_eff,
                bucket_cap=min(self.bucket_cap, self._capacity),
            )
            self._bucket_overflows += int(overflows)
            return counts, out_ids
        if self._use_grouped():
            group = min(self.group, self._capacity)
            return collision_topk_grouped(
                self._sig_t,
                ids_x,
                tie_x,
                qw,
                num_bands=self.num_bands,
                k=k_eff,
                group=group,
                kernel=self._scan_kernel(),
                sig_rows=self._refine_rows(group) if where is None else None,
                narrow_r=self._refine_narrow_r if where is None else 0,
                probes=probes,
            )
        return collision_topk(
            self._sig_t,
            ids_x,
            self._ranks,
            qw,
            num_bands=self.num_bands,
            k=k_eff,
            chunk=self.chunk,
            probes=probes,
        )

    def query_topk(
        self, qwords, k: int, *, where=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact (count desc, id asc) top-k for a query batch.

        Args:
            qwords: ``(Q, num_bands * W)`` uint32 signature words, or the
                multi-probe ``(Q, T, num_bands * W)`` layout — counts are
                then bands matching ANY probe variant.
            where: optional :class:`~lshrs_tpu.storage.IdFilter` (or an
                array-like allowlist of ids): results rank ONLY the
                admitted subset — exact top-k over it, not post-filtering.
        Returns:
            ``(counts, ids)`` NumPy arrays of shape ``(Q, k)``; zero-count
            padding carries id -1.
        """
        qw, probes = self._norm_qwords(qwords)
        # Dispatch under the lock: appends donate (alias) the state arrays,
        # so a concurrently-dispatched query could read deleted buffers.
        # The device->host readback happens outside (latency not serialised).
        with self._lock:
            if self._size == 0:
                q = qw.shape[0]
                return (np.zeros((q, k), np.int32), np.full((q, k), -1, np.int32))
            counts, ids = self._query_topk_dev(qw, k, probes, where=where)
        counts, ids = np.asarray(counts), np.asarray(ids)
        k_eff = counts.shape[1]
        if k_eff < k:
            q = counts.shape[0]
            counts = np.pad(counts, ((0, 0), (0, k - k_eff)))
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return counts, ids

    def query_topk_ids(self, qwords, k: int, *, where=None) -> jax.Array:
        """Device-resident id-only top-k (serving fast path, one readback)."""
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return jnp.full((qw.shape[0], k), -1, jnp.int32)
            _, ids = self._query_topk_dev(qw, k, probes, where=where)
        return ids

    def snapshot_query_fn(
        self,
        k: int,
        *,
        wire: str = "words",
        dev_batch: int | None = None,
        mode: str = "collision",
        probes: int = 1,
        where=None,
    ):
        """Compiled single-dispatch serving closure over the CURRENT contents.

        The serving hot loop wants exactly one dispatch per query batch.
        The returned callable closes over the current state
        arrays and fuses wire decode + scan + exact top-k + id select into
        one jitted program. Mutating the store invalidates the snapshot
        (appends donate the underlying buffers); a stale closure raises
        RuntimeError — take a new snapshot after ingesting.

        Args:
            k: result depth.
            wire: ``"words"`` (uint32 word signatures) or ``"dense"``
                (minimal-byte signatures from
                `LSHHasher.hash_batch_dense_host` — half the upload bytes
                for ``rows_per_band <= 16``).
            dev_batch: optionally split the batch into this many-query
                slices inside the program (bounds the scan working set for
                very large batches).
            mode: ``"collision"`` (band-collision counting),
                ``"hamming"`` (full-signature matmul ranking; requires
                ``enable_hamming=True``) or ``"asymmetric"`` (quantised
                query coordinates vs store bitplanes — the closure's
                input is ``(Q, num_perm)`` int8 coords from
                `lshrs_tpu.ops.asymmetric.quantize_coords_np`; with
                ``wire="coords4"`` it is instead the HALF-size packed
                nibble wire from
                `lshrs_tpu.ops.asymmetric.pack_coords_int4_np` of
                coords quantised with ``qmax=QMAX4`` — most of the
                asymmetric recall gain at half the transport. Other
                ``wire`` values are ignored for this mode).
            probes: multi-probe depth T (collision mode only). The
                closure's input grows a probe axis —
                ``(Q, T, num_bands * W)`` words from
                `LSHHasher.hash_batch_probe_words[_host]` (a flat
                ``(Q, T * num_bands * W)`` probe-major layout is also
                accepted), or ``(Q, T, dense_bytes)`` with
                ``wire="dense"``.

        Returns:
            callable ``(signatures) -> (Q, k) int32 device array of ids``.
        """
        if wire not in ("words", "dense", "coords4"):
            raise ValueError("wire must be 'words', 'dense' or 'coords4'")
        if wire == "coords4" and mode != "asymmetric":
            raise ValueError("wire='coords4' applies to mode='asymmetric' only")
        if mode not in ("collision", "hamming", "asymmetric"):
            raise ValueError(
                "mode must be 'collision', 'hamming' or 'asymmetric'"
            )
        if probes < 1:
            raise ValueError("probes must be >= 1")
        if probes > 1 and mode != "collision":
            raise ValueError(
                "multi-probe applies to collision counting only (the "
                "hamming/asymmetric estimators rank every slot already)"
            )
        if mode == "hamming" and not self.enable_hamming:
            raise RuntimeError(
                "enable_hamming=False: construct the store with "
                "enable_hamming=True for Hamming-mode queries"
            )
        if mode == "asymmetric" and not self.enable_hamming:
            raise RuntimeError(
                "enable_hamming=False: construct the store with "
                "enable_hamming=True for asymmetric-mode queries"
            )
        if mode == "asymmetric" and self.hamming_cascade:
            raise RuntimeError(
                "asymmetric ranking is unavailable with hamming_cascade: "
                "the store holds only the coarse bitplane prefix, and the "
                "asymmetric estimator ranks against full-width bitplanes"
            )
        from lshrs_tpu.ops.asymmetric import (
            QMAX,
            QMAX4,
            asymmetric_shift,
            asymmetric_topk_chunked_core,
            asymmetric_topk_core,
            unpack_coords_int4,
        )

        asym_qmax = QMAX4 if wire == "coords4" else QMAX
        with self._lock:
            if self._size == 0:
                raise RuntimeError("snapshot_query_fn requires a non-empty store")
            self._ensure_ranks()
            if mode in ("hamming", "asymmetric"):
                self._ensure_planes()  # lazily built on first ranking use
            if mode == "asymmetric" and self._planes is None:
                raise RuntimeError(
                    'asymmetric ranking requires hamming_storage="planes": '
                    "the query's quantised coordinates rank against int8 "
                    "bitplanes (the packed-words variant has no "
                    "bitplane operand)"
                )
            sig_t = self._sig_t
            ids, tie = self._filtered_ids_tie(where)
            ranks = self._ranks
            planes = self._planes
            grouped = self._use_grouped()
            group = min(self.group, self._capacity)
            kernel = self._scan_kernel()
            ham_kernel = self._scan_kernel(self._plane_bits())
            k_eff = max(1, min(k, self._capacity))
            num_bands, rows_per_band, chunk = (
                self.num_bands, self.rows_per_band, self.chunk,
            )
            num_perm = num_bands * rows_per_band
            ham_grouped = (
                supports_hamming_grouped(num_perm, self._capacity)
                and self._capacity % group == 0
            )
            cascade = self.hamming_cascade if mode == "hamming" else 0
            # The cascade's coarse key packs at ANY capacity (the coarse
            # pass tie-shifts past the int32 ceiling — see
            # hamming_topk_cascade_core), so grouping needs only the
            # group-divisibility invariant.
            cas_grouped = bool(cascade) and self._capacity % group == 0
            cas_groups = self._cascade_groups(k_eff) if cascade else 0
            if cas_grouped and dev_batch is None:
                # The coarse pass materializes per-group keys: (Q_slice,
                # C/group) int32 — 8.6 GB at 16M capacity x 8192 queries.
                # Bound the slice so the key matrix stays within 1/16 of
                # device memory; the serving closure loops slices inside
                # ONE program, so dispatch count is unchanged.
                ng_cas = self._capacity // group
                q_cap = (_device_bytes_limit() // 16) // (4 * ng_cas)
                dev_batch = max(128, (q_cap // 128) * 128)
            # Grouped refine table in the geometry of the served mode.
            asym_grouped = self._capacity % group == 0
            # Prebuilt refine tables bake the UNfiltered tie/id columns:
            # a filtered snapshot drops them (per-slot gather fallback).
            if where is not None:
                rows = None
            elif mode == "hamming":
                rows = (
                    self._refine_rows(group)
                    if (cas_grouped if cascade else ham_grouped)
                    else None
                )
            elif mode == "asymmetric":
                # Word-row refine: exact dots reconstruct from the packed
                # bits, so the 4-byte-word table replaces the num_perm-byte
                # bitplane gather. The core ignores the table past 2048
                # bits — don't build it.
                rows = (
                    self._refine_rows(group)
                    if asym_grouped and num_perm <= 2048
                    else None
                )
            else:
                rows = self._refine_rows(group) if grouped else None
            asym_shift = asymmetric_shift(num_perm, self._capacity, qmax=asym_qmax)
            # Read under the SAME lock hold as the state capture: a
            # mutation racing with snapshot creation must leave a closure
            # that fails the staleness check, not one that dispatches on
            # donated (deleted) buffers.
            snapshot_gen = self._generation

        # State rides as jit ARGUMENTS, not captured constants: captured
        # arrays are embedded in the program as constants, which blows up
        # for multi-hundred-MB stores.
        state = (sig_t, ids, tie, ranks, rows, planes)
        narrow_r = self._refine_narrow_r if where is None else 0

        def run_slice(qw, st):
            sig_t_, ids_, tie_, ranks_, rows_, planes_ = st
            if mode == "asymmetric":
                if asym_grouped:
                    _, out = asymmetric_topk_core(
                        planes_, ids_, tie_, qw,
                        k=k_eff,
                        chunk=chunk,
                        group=group,
                        shift=asym_shift,
                        qmax=asym_qmax,
                        kernel=ham_kernel,
                        sig_rows=rows_,
                        narrow_r=narrow_r,
                        num_bands=num_bands,
                    )
                else:
                    _, out = asymmetric_topk_chunked_core(
                        planes_, ids_, ranks_, qw,
                        k=k_eff, chunk=chunk, qmax=asym_qmax,
                    )
                return out
            if mode == "hamming":
                if planes_ is None:  # hamming_storage="packed"
                    if ham_grouped:
                        _, out = hamming_topk_packed_core(
                            sig_t_, ids_, tie_, qw,
                            num_perm=num_perm,
                            k=k_eff,
                            chunk=chunk,
                            group=group,
                            sig_rows=rows_,
                            narrow_r=narrow_r,
                        )
                    else:
                        _, out = hamming_topk_packed_chunked_core(
                            sig_t_, ids_, ranks_, qw,
                            num_perm=num_perm, k=k_eff, chunk=chunk,
                        )
                    return out
                qbits = unpack_bitplanes(
                    qw, num_bands=num_bands, rows_per_band=rows_per_band
                )
                if cascade:
                    if cas_grouped:
                        _, out = hamming_topk_cascade_core(
                            planes_, sig_t_, ids_, tie_,
                            qbits[:, :cascade], qw,
                            num_perm=num_perm,
                            k=k_eff,
                            refine_groups=cas_groups,
                            chunk=chunk,
                            group=group,
                            kernel=ham_kernel,
                            sig_rows=rows_,
                            narrow_r=narrow_r,
                        )
                    else:
                        _, out = hamming_topk_packed_chunked_core(
                            sig_t_, ids_, ranks_, qw,
                            num_perm=num_perm, k=k_eff, chunk=chunk,
                        )
                    return out
                if ham_grouped:
                    _, out = hamming_topk_core(
                        planes_, sig_t_, ids_, tie_, qbits, qw,
                        k=k_eff,
                        chunk=chunk,
                        group=group,
                        kernel=ham_kernel,
                        sig_rows=rows_,
                        narrow_r=narrow_r,
                    )
                else:
                    _, out = hamming_topk_chunked_core(
                        planes_, ids_, ranks_, qbits, k=k_eff, chunk=chunk
                    )
                return out
            if grouped:
                _, out = collision_topk_grouped_core(
                    sig_t_, ids_, tie_, qw,
                    num_bands=num_bands, k=k_eff, group=group,
                    kernel=kernel, sig_rows=rows_,
                    narrow_r=narrow_r, probes=probes,
                )
            else:
                _, out = collision_topk_core(
                    sig_t_, ids_, ranks_, qw,
                    num_bands=num_bands, k=k_eff, chunk=chunk,
                    probes=probes,
                )
            return out

        @jax.jit
        def _serve(q, st):
            if mode == "asymmetric":
                if wire == "coords4":  # packed nibbles -> int8 coords
                    q = unpack_coords_int4(q)
                else:
                    q = q.astype(jnp.int8)  # the wire IS the quantised coords
            elif wire == "dense":
                if probes > 1:  # (Q, T, DB) -> decode per probe -> (Q, T*BW)
                    nq = q.shape[0]
                    q = dense_to_words(
                        q.reshape(nq * probes, -1),
                        num_bands=num_bands,
                        rows_per_band=rows_per_band,
                    ).reshape(nq, -1)
                else:
                    q = dense_to_words(
                        q, num_bands=num_bands, rows_per_band=rows_per_band
                    )
            elif probes > 1:  # accept (Q, T, BW) or flat probe-major
                q = q.astype(jnp.uint32).reshape(q.shape[0], -1)
            n = q.shape[0]
            if dev_batch is None or n <= dev_batch:
                return run_slice(q, st)
            outs = [
                run_slice(jax.lax.slice_in_dim(q, i, min(i + dev_batch, n)), st)
                for i in range(0, n, dev_batch)
            ]
            return jnp.concatenate(outs)

        def serve(q):
            # Check-and-dispatch under the lock: a concurrent append donates
            # the captured buffers, so the staleness check must be atomic
            # with the dispatch (the device->host readback stays outside).
            with self._lock:
                if self._generation != snapshot_gen:
                    raise RuntimeError(
                        "snapshot_query_fn is stale: the store was mutated "
                        "after the snapshot was taken; call snapshot_query_fn "
                        "again"
                    )
                return _serve(q, state)

        return serve

    def snapshot_topp_fn(
        self,
        max_out: int,
        *,
        wire: str = "words",
        engine: str | None = None,
        max_candidates: int | None = None,
        probes: int = 1,
        batch_hint: int = 1024,
        dev_batch: int | None = None,
        where=None,
    ):
        """Compiled single-dispatch top-p rerank closure (serving path).

        The rerank analogue of :meth:`snapshot_query_fn`: one jitted
        program per batch fuses wire decode + candidate scoring + cosine
        rerank + the exact (cosine desc, id asc) ordering; callers can
        overlap hashing, dispatch and readback across batches.

        Args:
            max_out: ranked prefix length per query.
            wire: ``"words"`` or ``"dense"`` signature encoding (as
                :meth:`snapshot_query_fn`).
            engine / max_candidates: rerank formulation override (see the
                class docstring); resolved once at snapshot time. On the
                gather engine a returned ``n[i] >= max_candidates`` marks
                a possibly-truncated ranking (the serving hot loop does
                not read back the per-query exactness flags).
            probes: multi-probe depth T — the signature input grows a
                probe axis (``(Q, T, ...)`` words or dense, as
                :meth:`snapshot_query_fn`); candidate sets then include
                any-probe band matches before the cosine rerank.
            batch_hint: the query-batch size the closure will be served
                with. The auto engine's memory-feasibility check sizes the
                full formulation's ``(Q, C)`` temporaries from it — a
                closure resolved at the 1024 default but dispatched with
                16k-query batches can OOM at large capacity; pass your
                real batch size.
            dev_batch: split each dispatched batch into this many-query
                slices INSIDE the program. Default ``None`` auto-sizes
                from the resolved engine's per-query working set (the
                gather engine's refine + payload gathers are
                ``~max_candidates * (group * (BW + 2) + dim) * 4`` bytes
                per query — 21+ GB at 1M slots x 8k queries x the 1024
                default budget, a compile-time OOM without slicing; the
                full engine's is ``capacity * 8``). Dispatch count is
                unchanged — slices loop inside one jitted program.

        Returns:
            callable ``(signatures, qvecs) -> (ids (Q, max_out) int32,
            sims (Q, max_out) f32, n (Q,) int32)`` device arrays; ``qvecs``
            may be float32 or bfloat16 (cast up on device — bf16 halves
            the upload at ~1e-2 relative cosine rounding). Mutating the
            store invalidates the snapshot (stale closures raise
            RuntimeError).
        """
        if wire not in ("words", "dense"):
            raise ValueError("wire must be 'words' or 'dense'")
        if probes < 1:
            raise ValueError("probes must be >= 1")
        if self._payload is None:
            raise RuntimeError("store_vectors=False: no resident payload to rerank")
        from lshrs_tpu.ops.scan import collision_counts_core

        with self._lock:
            if self._size == 0:
                raise RuntimeError("snapshot_topp_fn requires a non-empty store")
            eng, mc = self._resolve_rerank_engine(
                engine, max_candidates, q=batch_hint
            )
            num_bands, rows_per_band, chunk = (
                self.num_bands, self.rows_per_band, self.chunk,
            )
            out = max(1, min(max_out, self._capacity))
            if eng == "gather":
                self._ensure_ranks()
                ids_x, tie_x = self._filtered_ids_tie(where)
                group = min(self.group, self._capacity)
                kernel = self._scan_kernel()
                state = (
                    self._sig_t,
                    ids_x,
                    tie_x,
                    self._payload,
                    self._pnorm,
                    self._refine_rows(group) if where is None else None,
                )
            else:
                ids_x, _ = self._filtered_ids_tie(where)
                state = (self._sig_t, ids_x, None, self._payload, self._pnorm, None)
            snapshot_gen = self._generation  # atomic with the state capture
        narrow_r = self._refine_narrow_r if where is None else 0
        if dev_batch is None:
            # Bound the per-slice working set to ~2 GB (see Args).
            if eng == "gather":
                group_g = min(self.group, self._capacity)
                bw = self._sig_t.shape[0]
                per_q = mc * (group_g * (bw + 2) + self.dim) * 4
                per_q += (self._capacity // group_g) * 4  # group-max keys
            else:
                per_q = self._capacity * 8
            q_cap = max(1, (1 << 31) // per_q)
            dev_batch = max(128, (q_cap // 128) * 128)

        def _run_slice(q, qv, st):
            sig_t_, ids_, tie_, payload_, pnorm_, rows_ = st
            if eng == "gather":
                out_ids, sims, n, _exact = rerank_topp_gather_core(
                    payload_, pnorm_, ids_, tie_, sig_t_, q, qv,
                    num_bands=num_bands,
                    max_out=out,
                    max_candidates=mc,
                    group=group,
                    kernel=kernel,
                    sig_rows=rows_,
                    narrow_r=narrow_r,
                    probes=probes,
                )
                return out_ids, sims, n
            counts = collision_counts_core(
                sig_t_, ids_, q, num_bands=num_bands, chunk=chunk,
                probes=probes,
            )
            return rerank_topp_batch_core(
                payload_, pnorm_, ids_, counts, qv, max_out=out
            )

        @jax.jit
        def _serve(q, qv, st):
            if wire == "dense":
                if probes > 1:  # (Q, T, DB) -> decode per probe
                    nq = q.shape[0]
                    q = dense_to_words(
                        q.reshape(nq * probes, -1),
                        num_bands=num_bands,
                        rows_per_band=rows_per_band,
                    ).reshape(nq, -1)
                else:
                    q = dense_to_words(
                        q, num_bands=num_bands, rows_per_band=rows_per_band
                    )
            else:
                q = q.astype(jnp.uint32)
                if probes > 1:  # accept (Q, T, BW) or flat probe-major
                    q = q.reshape(q.shape[0], -1)
            n = q.shape[0]
            if dev_batch is None or n <= dev_batch:
                return _run_slice(q, qv, st)
            outs = [
                _run_slice(
                    jax.lax.slice_in_dim(q, i, min(i + dev_batch, n)),
                    jax.lax.slice_in_dim(qv, i, min(i + dev_batch, n)),
                    st,
                )
                for i in range(0, n, dev_batch)
            ]
            return tuple(jnp.concatenate(cols) for cols in zip(*outs))

        def serve(q, qv):
            with self._lock:
                if self._generation != snapshot_gen:
                    raise RuntimeError(
                        "snapshot_topp_fn is stale: the store was mutated "
                        "after the snapshot was taken; call snapshot_topp_fn "
                        "again"
                    )
                return _serve(q, jnp.asarray(qv), state)

        return serve

    def query_counts(self, qwords, *, where=None) -> tuple[np.ndarray, np.ndarray]:
        """Full per-slot collision counts plus the slot-id map.

        Returns ``(counts (Q, capacity), ids (capacity,))`` — the device
        analogue of the reference's whole candidate dict, for the
        unbounded-candidate paths (``top_k=None``, top-p rerank).
        ``where``-inadmissible slots report zero counts and id -1.
        """
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return (
                    np.zeros((qw.shape[0], self._capacity), np.int32),
                    np.full((self._capacity,), -1, np.int32),
                )
            ids_x, _ = self._filtered_ids_tie(where)
            counts = collision_counts(
                self._sig_t, ids_x, qw,
                num_bands=self.num_bands, chunk=self.chunk, probes=probes,
            )
            ids = ids_x
        return np.asarray(counts), np.asarray(ids)

    def query_nnz(self, qwords, *, where=None) -> np.ndarray:
        """Per-query colliding-candidate counts, ``(Q,)`` — O(Q) readback.

        The completeness probe of the bounded candidate enumeration: the
        reduction runs inside the device chunk scan, so the ``(Q, C)``
        count matrix never exists anywhere. ``where``-inadmissible slots
        do not count.
        """
        from lshrs_tpu.ops.scan import collision_nnz

        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return np.zeros((qw.shape[0],), np.int32)
            ids_x, _ = self._filtered_ids_tie(where)
            n = collision_nnz(
                self._sig_t, ids_x, qw,
                num_bands=self.num_bands, chunk=self.chunk, probes=probes,
            )
        return np.asarray(n)

    def _query_hamming_dev(self, qw: jax.Array, k: int, where=None):
        """Device-resident Hamming top-k, grouped path when the packed
        key fits int32, chunked selection otherwise."""
        self._ensure_ranks()
        self._ensure_planes()  # lazily built on first Hamming use
        ids_x, tie_x = self._filtered_ids_tie(where)
        p = self.num_bands * self.rows_per_band
        k_eff = max(1, min(k, self._capacity))
        grouped = (
            supports_hamming_grouped(p, self._capacity)
            and self._capacity % self.group == 0
        )
        group = min(self.group, self._capacity)
        rows = self._refine_rows(group) if where is None else None
        if self.hamming_storage == "packed":
            if grouped:
                return hamming_topk_packed(
                    self._sig_t, ids_x, tie_x, qw,
                    num_perm=p,
                    k=k_eff,
                    chunk=self.chunk,
                    group=group,
                    sig_rows=rows,
                    narrow_r=self._refine_narrow_r if where is None else 0,
                )
            return hamming_topk_packed_chunked(
                self._sig_t, ids_x, self._ranks, qw,
                num_perm=p, k=k_eff, chunk=self.chunk,
            )
        qbits = unpack_bitplanes(
            qw, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )
        if self.hamming_cascade:
            cb = self.hamming_cascade
            # Coarse key packs at any capacity (tie-shift in the core).
            if self._capacity % self.group == 0:
                return hamming_topk_cascade(
                    self._planes, self._sig_t, ids_x, tie_x,
                    qbits[:, :cb], qw,
                    num_perm=p,
                    k=k_eff,
                    refine_groups=self._cascade_groups(k_eff),
                    chunk=self.chunk,
                    group=group,
                    kernel=self._scan_kernel(self._plane_bits()),
                    sig_rows=rows,
                    narrow_r=self._refine_narrow_r if where is None else 0,
                )
            # The resident planes are prefix-only, so the full-width
            # single-pass fallbacks can't run; exact packed-words ranking
            # covers the (pathological) capacities whose coarse key
            # doesn't fit int32.
            return hamming_topk_packed_chunked(
                self._sig_t, ids_x, self._ranks, qw,
                num_perm=p, k=k_eff, chunk=self.chunk,
            )
        if grouped:
            return hamming_topk(
                self._planes, self._sig_t, ids_x, tie_x, qbits, qw,
                k=k_eff,
                chunk=self.chunk,
                group=group,
                kernel=self._scan_kernel(self._plane_bits()),
                sig_rows=rows,
                narrow_r=self._refine_narrow_r if where is None else 0,
            )
        return hamming_topk_chunked(
            self._planes, ids_x, self._ranks, qbits, k=k_eff, chunk=self.chunk
        )

    def query_hamming(
        self, qwords, k: int, *, where=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k by full-signature Hamming distance (matmul ranking mode).

        Requires ``enable_hamming=True``. Returns ``(hamming (Q, k),
        ids (Q, k))`` ordered by (hamming asc, id asc); empty tail entries
        carry id -1. ``where``: optional id filter (exact ranking over
        the admitted subset).
        """
        if not self.enable_hamming:
            raise RuntimeError(
                "enable_hamming=False: construct the store with "
                "enable_hamming=True for Hamming-mode queries"
            )
        qw = jnp.asarray(qwords, dtype=jnp.uint32)
        p = self.num_bands * self.rows_per_band
        with self._lock:
            if self._size == 0:
                q = qw.shape[0]
                return (np.full((q, k), p + 1, np.int32), np.full((q, k), -1, np.int32))
            hamming, ids = self._query_hamming_dev(qw, k, where=where)
        hamming, ids = np.asarray(hamming), np.asarray(ids)
        k_eff = hamming.shape[1]
        if k_eff < k:
            q = hamming.shape[0]
            hamming = np.pad(hamming, ((0, 0), (0, k - k_eff)), constant_values=p + 1)
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return hamming, ids

    def _query_asymmetric_dev(self, qc: jax.Array, k: int, where=None):
        """Device-resident asymmetric top-k (quantised-coords query)."""
        from lshrs_tpu.ops.asymmetric import (
            asymmetric_shift,
            asymmetric_topk,
            asymmetric_topk_chunked,
        )

        self._ensure_ranks()
        self._ensure_planes()  # lazily built on first Hamming/asymmetric use
        ids_x, tie_x = self._filtered_ids_tie(where)
        if self._planes is None:
            raise RuntimeError(
                'asymmetric ranking requires hamming_storage="planes": the '
                "query's quantised coordinates rank against int8 bitplanes "
                "(the packed-words variant has no bitplane "
                "operand)"
            )
        p = self.num_bands * self.rows_per_band
        k_eff = max(1, min(k, self._capacity))
        group = min(self.group, self._capacity)
        grouped = self._capacity % group == 0
        if grouped:
            # Word-row refine: reconstruct exact dots from the grouped
            # 4-byte-word refine table instead of gathering full
            # num_perm-byte bitplane rows. The
            # core ignores the table past 2048 bits (unroll cost), so the
            # table is not built — or LRU-evicting others — there either.
            use_rows = p <= 2048 and where is None
            return asymmetric_topk(
                self._planes, ids_x, tie_x, qc,
                k=k_eff,
                chunk=self.chunk,
                group=group,
                shift=asymmetric_shift(p, self._capacity),
                kernel=self._scan_kernel(p),
                sig_rows=self._refine_rows(group) if use_rows else None,
                narrow_r=self._refine_narrow_r if use_rows else 0,
                num_bands=self.num_bands,
            )
        return asymmetric_topk_chunked(
            self._planes, ids_x, self._ranks, qc, k=k_eff, chunk=self.chunk
        )

    def query_asymmetric(
        self, qcoords, k: int, *, where=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k by asymmetric SimHash score (quantised query coords).

        Args:
            qcoords: ``(Q, num_perm)`` int8 quantised projection
                coordinates (`lshrs_tpu.ops.asymmetric.quantize_coords_np`).
            k: per-query result width.

        Returns ``(dots (Q, k) int32, ids (Q, k))`` ordered by
        (dots desc, id asc); empty tail entries carry id -1. The
        self-normalising cosine estimate is ``dots / sum|qcoords_row|``.
        Requires ``enable_hamming=True`` with ``hamming_storage="planes"``.
        """
        if not self.enable_hamming:
            raise RuntimeError(
                "enable_hamming=False: construct the store with "
                "enable_hamming=True for asymmetric-mode queries"
            )
        if self.hamming_cascade:
            raise RuntimeError(
                "asymmetric ranking is unavailable with hamming_cascade: "
                "the store holds only the coarse bitplane prefix, and the "
                "asymmetric estimator ranks against full-width bitplanes"
            )
        qc = jnp.asarray(qcoords, dtype=jnp.int8)
        p = self.num_bands * self.rows_per_band
        from lshrs_tpu.ops.asymmetric import QMAX

        empty_dots = -(p * QMAX + 1)
        with self._lock:
            if self._size == 0:
                q = qc.shape[0]
                return (
                    np.full((q, k), empty_dots, np.int32),
                    np.full((q, k), -1, np.int32),
                )
            dots, ids = self._query_asymmetric_dev(qc, k, where=where)
        dots, ids = np.asarray(dots), np.asarray(ids)
        k_eff = dots.shape[1]
        if k_eff < k:
            q = dots.shape[0]
            dots = np.pad(
                dots, ((0, 0), (0, k - k_eff)), constant_values=empty_dots
            )
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return dots, ids

    def query_hamming_ids(self, qwords, k: int, *, where=None) -> jax.Array:
        """Device-resident id-only Hamming top-k (serving fast path)."""
        if not self.enable_hamming:
            raise RuntimeError(
                "enable_hamming=False: construct the store with "
                "enable_hamming=True for Hamming-mode queries"
            )
        qw = jnp.asarray(qwords, dtype=jnp.uint32)
        with self._lock:
            if self._size == 0:
                return jnp.full((qw.shape[0], k), -1, jnp.int32)
            _, ids = self._query_hamming_dev(qw, k, where=where)
        return ids

    def query_topp(
        self, qwords, qvec: np.ndarray, max_out: int, *, where=None
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Fused top-p rerank: collision counts + cosine ranking, on device.

        Requires ``store_vectors``. Returns the first ``max_out`` colliding
        candidates ordered by (cosine desc, id asc) plus the total
        candidate count; only ``O(max_out)`` bytes reach the host.
        """
        if self._payload is None:
            raise RuntimeError("store_vectors=False: no resident payload to rerank")
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return (np.full(max_out, -1, np.int32), np.zeros(max_out, np.float32), 0)
            out = max(1, min(max_out, self._capacity))
            ids_x, _ = self._filtered_ids_tie(where)
            counts = collision_counts(
                self._sig_t, ids_x, qw,
                num_bands=self.num_bands, chunk=self.chunk, probes=probes,
            )
            ids, sims, n = rerank_topp(
                self._payload,
                self._pnorm,
                ids_x,
                counts[0],
                jnp.asarray(qvec, dtype=jnp.float32),
                max_out=out,
            )
        return np.asarray(ids), np.asarray(sims), int(n)

    def query_topp_batch(
        self,
        qwords,
        qvecs: np.ndarray,
        max_out: int,
        *,
        wire_dtype: str = "float32",
        engine: str | None = None,
        max_candidates: int | None = None,
        where=None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched fused top-p rerank (one device dispatch for the batch).

        Requires ``store_vectors``. Returns ``(ids (Q, max_out),
        sims (Q, max_out), n (Q,))`` ordered by (cosine desc, id asc);
        ``n[i]`` is query i's total colliding-candidate count.

        Args:
            wire_dtype: dtype the raw query vectors ship to the device in.
                ``"float32"`` (default) keeps cosines value-exact vs the
                host oracle; ``"bfloat16"`` halves the upload bytes — the
                win when the host->device link bounds rerank throughput —
                at ~1e-2 relative cosine error (queries are rounded once;
                the payload side stays f32).
            engine / max_candidates: override the store's
                ``rerank_engine`` / ``rerank_candidates`` for this call
                (see the class docstring). On the gather engine, queries
                whose candidate set exceeds the budget rerank the
                ``max_candidates`` most-colliding candidates; ``n`` is
                then a lower bound and ``stats()['rerank_truncations']``
                is incremented.
        """
        if self._payload is None:
            raise RuntimeError("store_vectors=False: no resident payload to rerank")
        if wire_dtype not in ("float32", "bfloat16"):
            raise ValueError("wire_dtype must be 'float32' or 'bfloat16'")
        qw, probes = self._norm_qwords(qwords)
        q = qw.shape[0]
        with self._lock:
            if self._size == 0:
                return (
                    np.full((q, max_out), -1, np.int32),
                    np.zeros((q, max_out), np.float32),
                    np.zeros((q,), np.int32),
                )
            eng, mc = self._resolve_rerank_engine(engine, max_candidates, q=q)
            out = max(1, min(max_out, self._capacity))
            qv = np.asarray(qvecs, dtype=np.float32)
            if wire_dtype == "bfloat16":
                import ml_dtypes

                qv = qv.astype(ml_dtypes.bfloat16)
            if eng == "gather":
                ids, sims, n, exact = self._topp_gather_dispatch(
                    qw, jnp.asarray(qv), out, mc, probes, where=where
                )
            else:
                exact = None
                ids_x, _ = self._filtered_ids_tie(where)
                ids, sims, n = _topp_batch_jit(
                    self._sig_t,
                    ids_x,
                    self._payload,
                    self._pnorm,
                    qw,
                    jnp.asarray(qv),
                    num_bands=self.num_bands,
                    chunk=self.chunk,
                    max_out=out,
                    probes=probes,
                )
        if exact is not None:
            truncated = int(q - np.asarray(exact).sum())
            if truncated:
                with self._lock:
                    self._rerank_truncations += truncated
        return np.asarray(ids), np.asarray(sims), np.asarray(n)

    def _topp_gather_dispatch(
        self, qw, qv_dev, max_out: int, mc: int, probes: int = 1, where=None
    ):
        """Gather-engine rerank dispatch (call under the lock); returns
        device ``(ids, sims, n, exact)``. Sharded stores override with
        the shard_map formulation."""
        self._ensure_ranks()
        ids_x, tie_x = self._filtered_ids_tie(where)
        group = min(self.group, self._capacity)
        return rerank_topp_gather(
            self._payload,
            self._pnorm,
            ids_x,
            tie_x,
            self._sig_t,
            qw,
            qv_dev,
            num_bands=self.num_bands,
            max_out=max_out,
            max_candidates=mc,
            group=group,
            kernel=self._scan_kernel(),
            sig_rows=self._refine_rows(group) if where is None else None,
            narrow_r=self._refine_narrow_r if where is None else 0,
            probes=probes,
        )

    def get_vectors(self, indices: Sequence[int]) -> np.ndarray:
        """Fetch resident payload rows by id (requires ``store_vectors``).

        Raises ``KeyError`` with a contract-level message for ids that were
        never indexed or have been deleted (deleted ids are popped from the
        id -> slot map by `remove_indices`).
        """
        if self._payload is None:
            raise RuntimeError("store_vectors=False: no resident payload to fetch")
        if self._slot_of is None:
            raise RuntimeError("get_vectors requires dedupe=True (id -> slot map)")
        with self._lock:
            slot_of = self._slot_of
            missing = [int(i) for i in indices if int(i) not in slot_of]
            if missing:
                raise KeyError(
                    f"ids not present in the index (unknown or deleted): "
                    f"{missing[:8]}{'...' if len(missing) > 8 else ''}"
                )
            slots = np.fromiter(
                (slot_of[int(i)] for i in indices),
                dtype=np.int64,
                count=len(indices),
            )
            payload = self._payload
            pscale = self._pscale
        rows = np.asarray(payload)[slots].astype(np.float32)
        if pscale is not None:  # int8: dequantize by the per-row scale
            rows *= np.asarray(pscale)[slots, None]
        return rows

    # ------------------------------------------------------------------
    # bucket-level parity API
    # ------------------------------------------------------------------

    def batch_add(self, operations: Sequence[BucketOperation]) -> None:
        """Bucket-op ingestion: stages per-band ops until a vector's band
        set is complete, then appends the assembled signature row."""
        if not operations:
            return
        ready_ids: list[int] = []
        ready_words: list[np.ndarray] = []
        with self._lock:
            for band_id, hash_val, index in operations:
                bands = self._pending_ops.setdefault(int(index), {})
                bands[int(band_id)] = bytes(hash_val)
                if len(bands) == self.num_bands:
                    row = band_bytes_to_words(
                        tuple(bands[b] for b in range(self.num_bands)),
                        rows_per_band=self.rows_per_band,
                    )
                    ready_ids.append(int(index))
                    ready_words.append(row)
                    del self._pending_ops[int(index)]
        if ready_ids:
            if self.store_vectors:
                raise RuntimeError(
                    "bucket-level batch_add cannot carry payload vectors; "
                    "use add_signature_batch with store_vectors=True"
                )
            self.add_signature_batch(ready_ids, np.stack(ready_words))

    def add_to_bucket(self, band_id: int, hash_val: bytes, index: int) -> None:
        self.batch_add([(band_id, hash_val, index)])

    def get_bucket(self, band_id: int, hash_val: bytes) -> set[int]:
        """Enumerate one implicit band bucket (device compare over the band)."""
        if not 0 <= band_id < self.num_bands:
            raise ValueError(f"band_id must be in [0, {self.num_bands})")
        with self._lock:
            if self._size == 0:
                return set()
            w = self.words // self.num_bands
            q_band = band_bytes_to_words(
                (bytes(hash_val),), rows_per_band=self.rows_per_band
            )
            band_words_t = self._sig_t[band_id * w : (band_id + 1) * w, :]
            match = _band_bucket_jit(band_words_t, self._ids, jnp.asarray(q_band), w=w)
            ids_dev = self._ids
        ids = np.asarray(ids_dev)
        return set(int(i) for i in ids[np.asarray(match)])

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------

    def remove_indices(self, indices: Iterable[int]) -> None:
        to_remove = [int(i) for i in indices]
        if not to_remove:
            return
        with self._lock:
            for i in to_remove:
                self._pending_ops.pop(i, None)
            if self._slot_of is not None:
                slots = [self._slot_of.pop(i) for i in to_remove if i in self._slot_of]
                if not slots:
                    return
                pad = _next_pow2(len(slots))
                slots_p = np.full(pad, self._capacity, dtype=np.int32)
                slots_p[: len(slots)] = slots
                self._ids = _tombstone_jit(self._ids, jnp.asarray(slots_p))
                self._tombstones += len(slots)
            else:
                dels = np.unique(np.asarray(to_remove, dtype=np.int32))
                self._ids, hits = _mask_delete_jit(self._ids, jnp.asarray(dels))
                self._tombstones += int(hits)
            # Relative order of surviving slots is unchanged, but the tie
            # array must mark the dead slots so the fast path skips them;
            # recomputed lazily with the rest of the selection keys.
            self._refresh_ranks()

    def compact(self) -> int:
        """Reclaim tombstoned slots by rebuilding the dense prefix.

        Returns the number of slots reclaimed. The reference's deletes
        shrink Redis sets in place; here dead slots still occupy scan
        capacity until compaction. Cheap (one snapshot + one append), so
        callers can run it after large deletion waves.
        """
        with self._lock:
            reclaimed = self._tombstones
            if reclaimed == 0:
                return 0
            snapshot = self.state_arrays()
            self.clear()
            self.load_state_arrays(snapshot)
        return reclaimed

    def clear(self) -> None:
        with self._lock:
            self._alloc(self._capacity)
            self._size = 0
            self._tombstones = 0
            self._generation += 1
            if self._slot_of is not None:
                self._slot_of.clear()
            self._pending_ops.clear()

    def _set_banding(self, num_bands: int, rows_per_band: int) -> None:
        """Adopt a new banding scheme (callers rebuild signatures after)."""
        if (num_bands + 1) * self.chunk >= 2**31:
            raise ValueError(
                "num_bands * chunk_size too large for exact top-k keys"
            )
        self.num_bands = num_bands
        self.rows_per_band = rows_per_band
        self.words = num_bands * words_per_band(rows_per_band)
        self._refine_narrow_r = narrow_refine_r(rows_per_band)

    def _reset_banding(self, num_bands: int, rows_per_band: int) -> None:
        """Re-allocate empty state under a new banding (host rehash path)."""
        with self._lock:
            self._set_banding(num_bands, rows_per_band)
            self._alloc(self._capacity)
            self._size = 0
            self._tombstones = 0
            self._generation += 1
            if self._slot_of is not None:
                self._slot_of.clear()
            self._pending_ops.clear()

    def rehash(
        self,
        proj_t,
        *,
        num_bands: int,
        rows_per_band: int,
        hash_family: str = "gaussian",
        block_slots: int = 1 << 17,
    ) -> None:
        """Rebuild EVERY stored signature from the resident payload under a
        new banding / seed / hash family — entirely on device, at fused-
        build rate, without re-streaming a single vector.

        The reference cannot retune an index without re-ingesting from the
        primary datastore (its Redis buckets only hold memberships,
        `/root/reference/lshrs/storage/redis.py:40`); with the payload
        resident in device memory, changing the operating point is a
        handful of hash-matmul dispatches.

        Args:
            proj_t: device hash operand of the NEW hasher
                (`LSHHasher.device_projection`).
            num_bands / rows_per_band: the new banding.
            hash_family: family matching ``proj_t``.
            block_slots: rows re-hashed per device program (bounds the
                transient f32 cast of the payload block).

        Signatures derive from the payload at its STORED precision: exact
        for ``payload_dtype="float32"``; with bf16/int8 payloads a few
        near-zero projection margins may flip vs hashing the original
        vectors (the probability is ~quantization-step / |margin|) —
        identical retrieval semantics, marginally different bucket
        boundaries. Ids, payload, tombstones and the id -> slot map are
        untouched; Hamming bitplanes and refine/bucket caches rebuild
        lazily.
        """
        with self._lock:
            if self._payload is None:
                raise RuntimeError(
                    "rehash requires store_vectors=True: signatures are "
                    "rebuilt from the resident payload"
                )
            self._set_banding(num_bands, rows_per_band)
            cap = self._capacity
            if hash_family == "crosspolytope" and self.dim:
                # Bound the CP hash's (step, num_bands * dpad) f32 rotated-
                # coords transient to ~2 GiB (see add_vectors_batch).
                dpad = 1 << (int(self.dim) - 1).bit_length()
                block_slots = min(
                    block_slots,
                    max(4096, (1 << 29) // max(1, num_bands * dpad)),
                )
            step = min(_next_pow2(block_slots), cap)
            while cap % step:
                step //= 2
            proj_dev = (
                proj_t
                if hash_family == "structured"
                else jnp.asarray(proj_t, dtype=jnp.float32)
            )
            sig_rows = jnp.zeros((cap, self.words), dtype=jnp.uint32)
            for off in range(0, cap, step):
                sig_rows = _rehash_block_jit(
                    sig_rows, self._payload, proj_dev, np.int32(off),
                    num_bands=num_bands, rows_per_band=rows_per_band,
                    hash_family=hash_family, step=step,
                )
            self._finish_rehash(sig_rows)

    def _finish_rehash(self, sig_rows) -> None:
        """Install rebuilt signature rows; invalidate derived state."""
        self._sig_rows = sig_rows
        self._sig_t = sig_rows.T
        self._rows_ext = {}
        self._bucket_index = None
        self._planes = None  # lazily rebuilt from the new words
        self._generation += 1
        # ids are unchanged, but the selection-key scale depends on the
        # banding; recompute lazily like every other mutation.
        self._refresh_ranks()

    def close(self) -> None:
        """Drop device buffers."""
        self._sig_t = self._ids = self._ranks = self._tie = None  # type: ignore[assignment]
        self._payload = self._pnorm = self._pscale = self._planes = None
        self._bucket_index = None
        self._sig_rows = None
        self._rows_ext = {}

    # ------------------------------------------------------------------
    # introspection / persistence
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self._size - self._tombstones

    def stats(self) -> dict:
        sig_bytes = self._capacity * self.words * 4
        payload_itemsize = {"bfloat16": 2, "int8": 1}.get(self.payload_dtype, 4)
        payload_bytes = (
            self._capacity * (self.dim or 0) * payload_itemsize
            # int8 carries a 4-byte per-row reconstruction scale
            + (self._capacity * 4 if self._pscale is not None else 0)
            if self.store_vectors
            else 0
        )
        return {
            "backend": "device",
            "size": self._size,
            "alive": self._size - self._tombstones,
            "tombstones": self._tombstones,
            "capacity": self._capacity,
            "chunk_size": self.chunk,
            "query_mode": self.query_mode,
            "hamming_storage": self.hamming_storage if self.enable_hamming else None,
            "hamming_cascade": self.hamming_cascade or None,
            "hamming_plane_bytes": (
                self._capacity * self._plane_bits()
                if self._planes is not None
                else 0
            ),
            "bucket_overflows": self._bucket_overflows,
            # Introspection must never raise: a pinned engine="gather" on a
            # geometry without the grouped fast path only errors when a
            # rerank is actually issued — stats() reports it unresolved.
            "rerank_engine": (
                (
                    self._resolve_rerank_engine(None, None)[0]
                    if self.rerank_engine != "gather" or self._gather_usable()
                    else "gather (unusable: needs the grouped fast path)"
                )
                if self.store_vectors
                else None
            ),
            "rerank_truncations": self._rerank_truncations,
            "fast_path": self._use_grouped(),
            "scan_kernel": self._scan_impls(),
            "signature_bytes": sig_bytes,
            "payload_bytes": payload_bytes,
        }

    def sample_payload_rows(self, cap: int) -> np.ndarray:
        """Up to ``cap`` dequantized ALIVE payload rows (float32, host).

        Evenly strided over the live slots and gathered ON DEVICE, so the
        host readback is O(cap * dim) regardless of capacity — a full
        `state_arrays` snapshot of a 1M x 768d store reads back ~3 GB
        through the transport; this reads back at most ``cap`` rows
        (plus the 4-byte-per-slot id column to locate the live slots).
        Feeds `LSHRS.retrain`'s default fit sample.
        """
        if cap <= 0:
            raise ValueError("cap must be > 0")
        with self._lock:
            if self._payload is None:
                raise RuntimeError(
                    "sample_payload_rows requires store_vectors=True"
                )
            n = self._size
            ids = np.asarray(self._ids[:n], dtype=np.int64)
            alive = np.flatnonzero(ids >= 0)
            if alive.size > cap:
                stride = alive.size / cap
                alive = alive[(np.arange(cap) * stride).astype(np.int64)]
            slots = jnp.asarray(alive.astype(np.int32))
            rows = jnp.take(self._payload, slots, axis=0).astype(jnp.float32)
            if self._pscale is not None:
                rows = rows * jnp.take(self._pscale, slots)[:, None]
            return np.asarray(rows)

    def state_arrays(self) -> dict[str, np.ndarray]:
        """Dense host snapshot of the used slots (for checkpointing)."""
        with self._lock:
            n = self._size
            out = {
                "ids": np.asarray(self._ids[:n]),
                "sig": np.asarray(self._sig_t[:, :n].T),
            }
            if self._payload is not None:
                # Export as float32: .npz round-trips builtin dtypes only
                # (bfloat16 re-rounds identically on restore; int8 rows
                # export dequantized and re-quantize bit-identically, so
                # query results are unchanged — only the reconstruction
                # scale can move by 1 ulp; see _cast_payload_rows).
                out["payload"] = np.asarray(
                    self._payload[:n].astype(jnp.float32)
                )
                if self._pscale is not None:
                    out["payload"] = out["payload"] * np.asarray(
                        self._pscale[:n]
                    )[:, None]
        return out

    def load_state_arrays(self, state: dict[str, np.ndarray]) -> None:
        """Restore from a :meth:`state_arrays` snapshot (replaces contents)."""
        self.clear()
        ids = np.asarray(state["ids"], dtype=np.int32)
        alive = ids >= 0
        self.add_signature_batch(
            ids[alive],
            np.asarray(state["sig"], dtype=np.uint32)[alive],
            np.asarray(state["payload"], dtype=np.float32)[alive]
            if "payload" in state and self.store_vectors
            else None,
        )
