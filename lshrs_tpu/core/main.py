"""LSHRS orchestrator: hashing + storage + buffered ingestion + queries.

Public API parity with the reference orchestrator
(`/root/reference/lshrs/core/main.py:58-1201`): ``create_signatures``,
``ingest``, ``index``, ``flush``, ``query``, ``get_top_k``, ``get_above_p``,
``delete``, ``clear``, ``stats``, ``save_to_disk``, ``load_from_disk``,
context-manager and pickle protocols, with the same validation messages,
candidate ordering ``(-collision_count, index)``, top-p cutoff
``max(1, ceil(n_candidates * p))`` and buffer-restore-on-failed-flush
semantics.

Device data flow (default ``backend="device"``):

    ingest/index -> batch hash (one matmul + bitpack)
                 -> host write buffer (thread-safe, op-counted)
                 -> flush: one device append per batch
    query        -> hash -> fused on-device collision scan + exact top-k
    rerank       -> resident payload matrix or user vector_fetch_fn

Bucket-style backends (``memory``, ``redis``, or any `BaseStorage`) get the
reference's exact host algorithm: per-band bucket reads + dict counting.
Within one instance all signatures come from a single hash path (device for
the device store, host NumPy for bucket stores) so stored and query
signatures always agree bit-for-bit.
"""

from __future__ import annotations

import json
import logging
import math
from collections.abc import Callable, Iterable, Sequence
from pathlib import Path
from threading import Lock
from typing import Any, Optional, Union

import numpy as np

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage.base import BaseStorage, BucketOperation
from lshrs_tpu.storage.device import DeviceStore
from lshrs_tpu.storage.filter import as_filter
from lshrs_tpu.storage.memory import MemoryStorage
from lshrs_tpu.utils.br import get_optimal_config
from lshrs_tpu.utils.similarity import top_k_cosine

logger = logging.getLogger(__name__)

VectorFetchFn = Callable[[Sequence[int]], np.ndarray]
CandidateScores = list[tuple[int, float]]
Loader = Callable[..., Iterable[tuple[Sequence[int], np.ndarray]]]

_METADATA_VERSION = "0.1.0"

__all__ = ["LSHRS", "lshrs", "VectorFetchFn", "CandidateScores"]


class LSHRS:
    """Locality-sensitive-hashing index over dense float32 vectors.

    Signatures are banded random hyperplane projections; storage is, by
    default, a device-resident signature store queried with fused XLA
    kernels. See the class docstrings in `lshrs_tpu.storage` for backends.

    Args:
        dim: vector dimensionality (> 0).
        num_perm: total projection bits (``num_bands * rows_per_band``).
        num_bands / rows_per_band: banding scheme; auto-tuned from
            ``similarity_threshold`` when either is omitted.
        similarity_threshold: target similarity for auto-tuning.
        buffer_size: buffered *bucket operations* (vector count x bands)
            that trigger an automatic flush.
        vector_fetch_fn: callable returning ``(n, dim)`` vectors for ids;
            required for top-p reranking unless ``store_vectors=True``.
        storage: preconfigured `BaseStorage`; overrides ``backend``.
        backend: ``"device"`` (default), ``"memory"``
            (hermetic bucket dict) or ``"redis"`` (server-backed buckets).
        store_vectors: device backend only — keep vectors device-resident so
            ``get_above_p`` reranks on-device data without a fetch round-trip.
        redis_*: connection settings used when ``backend="redis"``.
        seed: projection seed (determinism / reproducibility).
        initial_capacity / chunk_size: device store sizing knobs.
        shards: shard the index over this many devices (1-D mesh); queries
            merge shard-local top-k with one all-gather. Power of two.
        enable_hamming: maintain int8 bitplanes so `query_hamming` (full
            signature SimHash ranking as an int8 matmul) is available.
        group_size / dedupe / query_mode / bucket_cap: device store
            engine knobs, see `lshrs_tpu.storage.device.DeviceStore`.
        payload_dtype: resident payload precision — ``"float32"``
            (value-exact cosines), ``"bfloat16"`` (half the payload
            memory; ~1e-3 relative cosine rounding) or ``"int8"``
            (quarter memory, per-row-scale quantized; ~4e-3 rounding —
            what fits 768-dim payloads at 100M-scale sharding). Device
            backend only.
        rerank_engine: top-p rerank formulation — ``"full"`` (whole-store
            cosine matmul), ``"gather"`` (candidate-gather: rerank only
            the top ``rerank_candidates`` most-colliding slots; cost
            scales with candidates, not index size) or ``"auto"``
            (default — gather at scale when the expected candidate load
            fits the budget). See `lshrs_tpu.storage.device.DeviceStore`.
        rerank_candidates: per-query candidate budget of the gather engine.
        engine: top-k ranking engine — ``"collision"`` (band-collision
            counting, exact reference parity), ``"hamming"``
            (full-signature Hamming ranking: every hash bit is used,
            higher recall than collision at every measured operating
            point) or ``"auto"`` (default: collision below
            `_AUTO_HAMMING_CAPACITY` slots, Hamming past it — the regime
            where the collision scan's cost outgrows the bitplane scan's).
            Auto/hamming engines maintain int8 bitplanes (the matmul
            formulation) at ``num_perm`` bytes/slot unless the caller
            pins ``hamming_storage`` themselves. Candidate enumeration
            (``top_k=None``) and top-p rerank keep collision semantics
            in every engine.
        hamming_cascade: coarse prefix width (bits) of the two-pass
            Hamming refinement cascade — the >=4M-slot serving engine. 0
            (default) = off. When set (device backend, Hamming ranking
            available), Hamming-mode top-k scans only the first
            ``hamming_cascade`` hyperplanes' bitplanes (that fraction of
            the full matmul cost AND of the ranking memory) and re-ranks
            the top ``hamming_cascade_refine`` slots per query by the
            exact full-width distance. Approximate — the prefix pass can
            drop a true top-k slot (``chip_smoke.py`` checks planted
            recall@10 at 4M x 768d with 128 bits); asymmetric queries are
            unavailable while it is on. Composes with ``shards=N``: each
            shard runs the coarse scan + exact refine on its local block
            and the full-width keys merge with one all-gather, so the
            per-query refine pool applies PER SHARD.
        hamming_cascade_refine: cascade refine pool per query, in slots
            (per shard when sharded).
        hash_mode: where this instance hashes — ``"device"`` (one
            matmul per batch, ships raw vectors) or ``"host"`` (CPU sgemm,
            ships 64-byte packed signatures; wins when the host->device
            link is the ingest bottleneck). One path per instance, so
            stored and query signatures always agree bit-for-bit.
        multiprobe: query-directed multi-probe depth T (default 1 = off,
            exact reference semantics). For T > 1 every band additionally
            probes the T-1 buckets reached by flipping its lowest-margin
            bits — the nearest single-bit hash misses — so candidate sets
            grow at ZERO memory cost (classic multi-probe LSH, Lv et al.
            2007). Applies to collision counting and top-p candidate
            enumeration on every backend (device scans and bucket reads
            alike); counts become "bands matching any probe" and collision
            ordering is no longer reference-parity while T > 1.
        similarity: ``"cosine"`` (reference parity, default) or ``"dot"``
            — maximum-inner-product search (MIPS) via the simple-LSH
            augmentation (Neyshabur & Srebro 2015): every stored vector
            gains one coordinate ``sqrt(max_norm^2 - |x|^2)`` and every
            query a 0, reducing inner-product ranking to the cosine
            machinery end-to-end (hashing, collision counting, Hamming /
            asymmetric estimators, device rerank). Returned scores are
            inner products (rescaled exactly); candidate ids follow
            inner-product order. Known caveat of the augmentation: recall
            degrades when stored norms vary by orders of magnitude (the
            augmented coordinate dominates small-norm vectors' hashes).
        max_norm: required with ``similarity="dot"`` — the declared upper
            bound on stored vector norms; ingesting a vector above it
            raises ``ValueError``.
    """

    def __init__(
        self,
        *,
        dim: int,
        num_perm: int = 128,
        num_bands: Optional[int] = None,
        rows_per_band: Optional[int] = None,
        similarity_threshold: float = 0.5,
        buffer_size: int = 10_000,
        vector_fetch_fn: Optional[VectorFetchFn] = None,
        storage: Optional[BaseStorage] = None,
        backend: str = "device",
        store_vectors: bool = False,
        redis_host: str = "localhost",
        redis_port: int = 6379,
        redis_db: int = 0,
        redis_password: Optional[str] = None,
        redis_prefix: str = "lsh",
        redis_max_connections: int = 50,
        decode_responses: bool = False,
        seed: int = 42,
        initial_capacity: int = 1 << 14,
        chunk_size: int = 2048,
        shards: Optional[int] = None,
        enable_hamming: bool = False,
        group_size: int = 64,
        dedupe: bool = True,
        query_mode: str = "scan",
        bucket_cap: int = 128,
        hash_mode: str = "device",
        hash_family: str = "gaussian",
        hamming_storage: Optional[str] = None,
        hamming_cascade: int = 0,
        hamming_cascade_refine: int = 2048,
        payload_dtype: str = "float32",
        rerank_engine: str = "auto",
        rerank_candidates: int = 1024,
        engine: str = "auto",
        multiprobe: int = 1,
        similarity: str = "cosine",
        max_norm: Optional[float] = None,
    ) -> None:
        if dim <= 0:
            raise ValueError("Vector dimensionality must be greater than zero")
        if num_perm <= 0:
            raise ValueError("num_perm must be greater than zero")
        if buffer_size <= 0:
            raise ValueError("buffer_size must be greater than zero")
        if hash_mode not in ("device", "host"):
            raise ValueError("hash_mode must be 'device' or 'host'")
        if hash_family not in ("gaussian", "structured", "learned", "crosspolytope"):
            raise ValueError(
                "hash_family must be 'gaussian', 'structured', 'learned' "
                "or 'crosspolytope'"
            )
        if engine not in ("auto", "collision", "hamming"):
            raise ValueError("engine must be 'auto', 'collision' or 'hamming'")
        if hash_family == "crosspolytope":
            # Cross-polytope signatures are signed-argmax SYMBOLS, not sign
            # bits: Hamming distance over the symbol's binary encoding and
            # the coordinate-based asymmetric estimator are both
            # meaningless, so bit-semantic engines are rejected rather
            # than silently mis-ranking. Collision counting + payload
            # rerank carry this family (its candidate sets are what's
            # better — see lshrs_tpu/hash/crosspolytope.py).
            if engine == "hamming":
                raise ValueError(
                    "engine='hamming' requires sign-bit signatures; the "
                    "cross-polytope family ranks by collision counting "
                    "(+ payload rerank)"
                )
            if enable_hamming:
                raise ValueError(
                    "enable_hamming is unavailable with "
                    "hash_family='crosspolytope': Hamming distance over "
                    "argmax symbols is not meaningful"
                )
            engine = "collision"
        if not isinstance(multiprobe, int) or multiprobe < 1:
            raise ValueError("multiprobe must be an integer >= 1")
        if similarity not in ("cosine", "dot"):
            raise ValueError("similarity must be 'cosine' or 'dot'")
        if similarity == "dot":
            if max_norm is None or not max_norm > 0:
                raise ValueError(
                    'similarity="dot" requires max_norm > 0: the MIPS '
                    "augmentation needs an upper bound on stored vector "
                    "norms (vectors above it are rejected at ingest)"
                )
            max_norm = float(max_norm)
        self._similarity = similarity
        self._max_norm = max_norm
        # None = "not pinned by the caller": defaults to "planes", and the
        # engine override below may only touch the unpinned value (an
        # explicit "packed" is the caller trading QPS for zero extra device memory).
        hamming_pinned = hamming_storage is not None
        if hamming_storage is None:
            hamming_storage = "planes"
        if hamming_storage not in ("planes", "packed"):
            raise ValueError("hamming_storage must be 'planes' or 'packed'")
        if hamming_cascade:
            if backend != "device" or storage is not None:
                raise ValueError(
                    "hamming_cascade applies to the device backend only"
                )
            if engine == "collision" and not enable_hamming:
                raise ValueError(
                    "hamming_cascade requires Hamming ranking: construct "
                    "with enable_hamming=True or engine='auto'/'hamming'"
                )
        self._engine = engine
        if engine != "collision" and backend == "device" and not enable_hamming:
            # The auto/hamming engines rank with the int8 bitplane
            # formulation (an int8 matmul) rather than the zero-memory
            # packed (popcount) variant. Costs num_perm bytes/slot of
            # device memory (256 MB at 1M x 256 bits); construct with
            # enable_hamming=True, hamming_storage="packed" to trade that
            # memory back.
            enable_hamming = True
            if not hamming_pinned:
                hamming_storage = "planes"

        if num_bands is None or rows_per_band is None:
            if hash_family == "crosspolytope":
                # The sign-bit S-curve (p = s^r) does not describe
                # cross-polytope collisions; the CP tuner integrates a
                # Monte-Carlo collision curve instead (lshrs_tpu/utils/cp.py).
                from lshrs_tpu.utils.cp import get_optimal_cp_config

                num_bands, rows_per_band = get_optimal_cp_config(
                    num_perm, similarity_threshold, dim
                )
            else:
                num_bands, rows_per_band = get_optimal_config(
                    num_perm, similarity_threshold
                )
        if num_bands * rows_per_band != num_perm:
            raise ValueError(
                "num_bands * rows_per_band must equal num_perm "
                f"(received {num_bands} * {rows_per_band} != {num_perm})"
            )
        max_probes = (
            1 << (rows_per_band - 1)
            if hash_family == "crosspolytope"
            else rows_per_band
        )
        if multiprobe > max_probes:
            bound = "cp_dims" if hash_family == "crosspolytope" else "rows_per_band"
            raise ValueError(
                f"multiprobe must be <= {bound} "
                f"(= {max_probes}); received {multiprobe}"
            )
        self._multiprobe = multiprobe

        self._dim = dim
        # MIPS ("dot") augments every vector with one extra coordinate
        # (sqrt(max_norm^2 - |x|^2) stored-side, 0 query-side), reducing
        # inner-product ranking to the cosine machinery (simple-LSH /
        # Neyshabur & Srebro); the hasher and store operate on dim + 1.
        self._hash_dim = dim + 1 if similarity == "dot" else dim
        self._buffer_size = buffer_size
        self._vector_fetch_fn = vector_fetch_fn
        # One hash path per instance: stored and query signatures always
        # come from the same matmul implementation, so they agree
        # bit-for-bit. "host" hashes on CPU and ships 64-byte packed words
        # instead of raw vectors — the right choice when the host->device
        # link, not the hash matmul, is the ingest bottleneck.
        self._hash_on_device = hash_mode == "device"

        self._hasher = LSHHasher(
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            dim=self._hash_dim,
            seed=seed,
            hash_family=hash_family,
        )

        if storage is not None:
            self._storage: BaseStorage = storage
            backend = "device" if storage.supports_signature_batches else "custom"
        elif backend == "device":
            if shards is not None and shards > 1:
                from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh

                self._storage = ShardedDeviceStore(
                    mesh=make_mesh(shards),
                    num_bands=num_bands,
                    rows_per_band=rows_per_band,
                    dim=self._hash_dim,
                    store_vectors=store_vectors,
                    initial_capacity=initial_capacity,
                    chunk_size=chunk_size,
                    enable_hamming=enable_hamming,
                    hamming_storage=hamming_storage,
                    hamming_cascade=hamming_cascade,
                    hamming_cascade_refine=hamming_cascade_refine,
                    group_size=group_size,
                    dedupe=dedupe,
                    query_mode=query_mode,
                    bucket_cap=bucket_cap,
                    payload_dtype=payload_dtype,
                    rerank_engine=rerank_engine,
                    rerank_candidates=rerank_candidates,
                )
            else:
                self._storage = DeviceStore(
                    num_bands=num_bands,
                    rows_per_band=rows_per_band,
                    dim=self._hash_dim,
                    store_vectors=store_vectors,
                    initial_capacity=initial_capacity,
                    chunk_size=chunk_size,
                    enable_hamming=enable_hamming,
                    hamming_storage=hamming_storage,
                    hamming_cascade=hamming_cascade,
                    hamming_cascade_refine=hamming_cascade_refine,
                    group_size=group_size,
                    dedupe=dedupe,
                    query_mode=query_mode,
                    bucket_cap=bucket_cap,
                    payload_dtype=payload_dtype,
                    rerank_engine=rerank_engine,
                    rerank_candidates=rerank_candidates,
                )
        elif backend == "memory":
            self._storage = MemoryStorage()
        elif backend == "redis":
            from lshrs_tpu.storage.redis import RedisStorage

            self._storage = RedisStorage(
                host=redis_host,
                port=redis_port,
                db=redis_db,
                password=redis_password,
                decode_responses=decode_responses,
                prefix=redis_prefix,
                max_connections=redis_max_connections,
            )
        else:
            raise ValueError(f"Unsupported storage backend '{backend}'")

        self._device_mode = self._storage.supports_signature_batches
        if isinstance(self._storage, DeviceStore):
            store_vectors = self._storage.store_vectors
        self._store_vectors = store_vectors and self._device_mode

        # Write buffer. Device mode buffers (index, words_row, vector?)
        # records; bucket mode buffers BucketOperation tuples so the
        # flush-threshold unit (operations) matches the reference exactly.
        self._buffer: list = []
        self._buffer_lock = Lock()

        # Runtime counters (observability the reference lacks: its stats()
        # is a pure config snapshot, /root/reference/lshrs/core/main.py:798).
        self._counters = {
            "vectors_ingested": 0,
            "queries_served": 0,
            "flushes": 0,
            "deletes": 0,
        }
        self._counter_lock = Lock()

        self._config: dict[str, Any] = {
            "dim": dim,
            "num_perm": num_perm,
            "num_bands": num_bands,
            "rows_per_band": rows_per_band,
            "similarity_threshold": similarity_threshold,
            "buffer_size": buffer_size,
            "seed": seed,
            "similarity": similarity,
            "max_norm": max_norm,
        }
        self._tpu_config: dict[str, Any] = {
            "backend": backend,
            "store_vectors": store_vectors,
            "initial_capacity": initial_capacity,
            "chunk_size": chunk_size,
            "shards": shards,
            "enable_hamming": enable_hamming,
            "group_size": group_size,
            "dedupe": dedupe,
            "query_mode": query_mode,
            "bucket_cap": bucket_cap,
            "hash_mode": hash_mode,
            "hash_family": hash_family,
            "hamming_storage": hamming_storage,
            "hamming_cascade": hamming_cascade,
            "hamming_cascade_refine": hamming_cascade_refine,
            "payload_dtype": payload_dtype,
            "rerank_engine": rerank_engine,
            "rerank_candidates": rerank_candidates,
            "engine": engine,
            "multiprobe": multiprobe,
        }
        self._redis_config: dict[str, Any] = {
            "host": redis_host,
            "port": redis_port,
            "db": redis_db,
            "password": redis_password,
            "prefix": redis_prefix,
            "decode_responses": decode_responses,
            "max_connections": redis_max_connections,
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        """Flush pending operations and release the storage backend."""
        self.flush()
        self._storage.close()

    def __enter__(self) -> "LSHRS":
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover - convenience
        engine = self._engine
        resolved = self._tpu_config.get("engine_resolved")
        if resolved:
            engine = f"{engine}->{resolved}"
        return (
            "LSHRS("
            f"dim={self._dim}, "
            f"num_perm={self._config['num_perm']}, "
            f"num_bands={self._config['num_bands']}, "
            f"rows_per_band={self._config['rows_per_band']}, "
            f"engine='{engine}', "
            f"backend='{self._tpu_config['backend']}'"
            ")"
        )

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------

    def create_signatures(
        self,
        *,
        format: str = "postgres",
        prefetch: int = 2,
        **loader_kwargs: Any,
    ) -> None:
        """Bulk-build the index by streaming ``(indices, vectors)`` batches.

        ``format`` selects a loader: ``postgres``/``pg``, ``parquet``/``pq``
        or ``numpy``/``npz`` (see `lshrs_tpu.io`). Loader keyword arguments
        are passed through. Each streamed batch is indexed and flushed
        atomically (`index` semantics). ``prefetch`` batches are pulled
        ahead on a background thread so host IO overlaps device ingestion
        (set 0 to disable).
        """
        loader = self._resolve_loader(format)
        stream: Iterable = loader(**loader_kwargs)
        if prefetch > 0:
            from lshrs_tpu.io.prefetch import prefetch_batches

            stream = prefetch_batches(stream, depth=prefetch)
        import os

        # Two-stage ingest pipeline: hash batch i+1 on a worker thread
        # (BLAS releases the GIL) while the main thread commits batch i
        # (device dispatch + transfer). Only worth it with >= 2 CPUs
        # actually available to THIS process (cgroup/affinity-aware —
        # os.cpu_count() reports the machine and would enable the
        # pipeline inside a 1-CPU container): on one core the hash
        # thread and the transfer contend and throughput drops.
        try:
            avail_cpus = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):  # non-Linux
            avail_cpus = os.cpu_count() or 1
        if not self._device_mode or avail_cpus < 2:
            for indices, vectors in stream:
                self.index(indices, vectors)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = None
            it = iter(stream)
            while True:
                try:
                    indices, vectors = next(it)
                except StopIteration:
                    break
                except BaseException:
                    # Match the sequential path's partial-commit semantics:
                    # it commits batch i before pulling batch i+1, so a
                    # loader failure must not drop the already-hashed batch.
                    if pending is not None:
                        self._commit_index_batch(pending.result())
                        pending = None
                    raise
                fut = ex.submit(self._prepare_index_batch, indices, vectors)
                if pending is not None:
                    self._commit_index_batch(pending.result())
                pending = fut
            if pending is not None:
                self._commit_index_batch(pending.result())

    def ingest(self, index: int, vector: np.ndarray) -> None:
        """Hash one vector and buffer its bucket operations.

        Buffered data is not searchable until flushed (explicitly, at
        buffer capacity, via ``index()``, or on close).
        """
        if index < 0:
            raise ValueError("index must be non-negative")
        vec = self._augment_data(self._prepare_vector(vector)[None, :])[0]
        if self._device_mode:
            words = self._hash_for_ingest(vec[None, :])  # stays on device
            record = (
                np.asarray([index], dtype=np.int64),
                words,
                vec[None, :] if self._store_vectors else None,
            )
            with self._buffer_lock:
                self._buffer.append(record)
        else:
            signatures = self._hasher.hash_vector(vec)
            with self._buffer_lock:
                for band_id, sig in enumerate(signatures):
                    self._buffer.append((band_id, sig, int(index)))
        self._count("vectors_ingested")
        self._flush_buffer_if_needed()

    def index(self, indices: Sequence[int], vectors: Optional[np.ndarray] = None) -> None:
        """Index a batch of vectors and flush, making them searchable.

        ``vectors=None`` fetches the batch through ``vector_fetch_fn``.
        The whole batch is hashed with one device matmul in device mode.
        """
        if indices is None or len(indices) == 0:
            return
        if self._device_mode:
            self._commit_index_batch(self._prepare_index_batch(indices, vectors))
            return
        idx_arr, arr = self._validate_index_batch(indices, vectors)
        words = self._hasher.hash_batch_words_host(arr)
        idx_list = idx_arr.tolist()
        with self._buffer_lock:
            for j, idx in enumerate(idx_list):
                sig = self._hasher.words_to_signature(words[j])
                for band_id, band in enumerate(sig):
                    self._buffer.append((band_id, band, idx))
        self._count("vectors_ingested", idx_arr.size)
        self.flush()

    def _validate_index_batch(self, indices, vectors):
        """Shared `index()` validation -> ``(idx_arr, float32 arr)``."""
        if vectors is None:
            fetch_fn = self._require_vector_fetch_fn()
            vectors = fetch_fn(indices)

        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        if arr.shape[0] != len(indices):
            raise ValueError(
                "Number of vectors does not match number of indices "
                f"(received {arr.shape[0]} vectors for {len(indices)} indices)"
            )
        idx_arr = np.asarray(indices, dtype=np.int64).reshape(-1)
        if idx_arr.size and int(idx_arr.min()) < 0:
            raise ValueError("index must be non-negative")
        # Zero-row rejection with a first-column prefilter: a zero row
        # needs EVERY coordinate within tolerance, so only rows whose
        # first coordinate is already ~0 can qualify — scan just those
        # fully. Exact same semantics as the full np.all over the matrix,
        # ~dim x less memory traffic (measured 65% of the 1-core ingest
        # wall at 768d before this; the full check re-read 3 GB/1M rows).
        cand = np.flatnonzero(np.abs(arr[:, 0]) <= 1e-8)
        if cand.size and np.any(np.all(np.abs(arr[cand]) <= 1e-8, axis=1)):
            raise ValueError(
                "Cannot index zero vector - norm undefined. Check embeddings for corruption."
            )
        return idx_arr, self._augment_data(arr)

    def _fused_ingest(self) -> bool:
        """True when `index()` batches take the one-dispatch fused
        hash+append device program (`DeviceStore.add_vectors_batch`)."""
        return (
            self._device_mode
            and self._hash_on_device
            and hasattr(self._storage, "add_vectors_batch")
        )

    def _prepare_index_batch(self, indices, vectors):
        """Device-mode `index()` stage 1: validate + hash (no shared
        mutable state — safe to run on a pipeline worker thread)."""
        idx_arr, arr = self._validate_index_batch(indices, vectors)
        if self._fused_ingest():
            # Raw batch marker: hashing happens fused with the append in
            # one device program at commit (instead of two dispatches and
            # a host round trip).
            return (idx_arr, None, arr)
        words = self._hash_for_ingest(arr)  # device array or host wire bytes
        return (idx_arr, words, arr if self._store_vectors else None)

    def _commit_index_batch(self, record) -> None:
        """Device-mode `index()` stage 2: buffer + count + atomic flush."""
        idx_arr, words, vecs = record
        if words is None:  # fused hash+append path
            self.flush()  # commit buffered singles first (order-preserving)
            self._storage.add_vectors_batch(  # type: ignore[attr-defined]
                idx_arr, vecs, self._hasher.device_projection(),
                hash_family=self._hasher.hash_family,
            )
            self._count("vectors_ingested", idx_arr.size)
            self._count("flushes")  # each fused commit is one storage write
            return
        with self._buffer_lock:
            self._buffer.append(record)
        self._count("vectors_ingested", record[0].size)
        self.flush()

    def flush(self) -> None:
        """Write buffered operations to storage in one batch.

        On failure the snapshot is restored to the front of the buffer
        (order-preserving) and the exception re-raised, so a retry flushes
        the same data.
        """
        with self._buffer_lock:
            if not self._buffer:
                return
            pending = list(self._buffer)
            self._buffer.clear()

        try:
            if self._device_mode:
                # Buffer holds batch records (ids, device-resident words,
                # vectors?); a multi-record flush concatenates on device.
                if len(pending) == 1:
                    ids, words, vecs = pending[0]
                else:
                    import jax.numpy as jnp

                    ids = np.concatenate([rec[0] for rec in pending])
                    words = jnp.concatenate(
                        [jnp.asarray(rec[1]) for rec in pending]
                    )
                    vecs = (
                        np.concatenate([rec[2] for rec in pending])
                        if self._store_vectors
                        else None
                    )
                self._storage.add_signature_batch(ids, words, vecs)  # type: ignore[attr-defined]
            else:
                self._storage.batch_add(pending)
            self._count("flushes")
        except Exception as e:
            logger.error(f"Failed to flush buffer to storage: {e}")
            with self._buffer_lock:
                self._buffer[0:0] = pending
            raise

    def _count(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self._counters[key] += n

    def _buffered_ops(self) -> int:
        """Pending operation count (each vector counts num_bands ops)."""
        if self._device_mode:
            vectors = sum(rec[0].size for rec in self._buffer)
            return vectors * self._config["num_bands"]
        return len(self._buffer)

    def _flush_buffer_if_needed(self) -> None:
        with self._buffer_lock:
            should_flush = self._buffered_ops() >= self._buffer_size
        if should_flush:
            self.flush()

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    # Capacity at which the auto engine switches top-k ranking from
    # band-collision counting to Hamming: the collision scan's cost grows
    # with capacity faster than the int8 bitplane scan's, and Hamming
    # ranks with better recall. The crossover is provisional until it is
    # measured on the GPU (ROADMAP A5).
    _AUTO_HAMMING_CAPACITY = 1 << 19

    def _use_hamming_ranking(self) -> bool:
        """True when top-k queries should rank by full-signature Hamming.

        ``engine="collision"`` never does (reference parity);
        ``engine="hamming"`` always does; ``engine="auto"`` switches once
        the index capacity crosses `_AUTO_HAMMING_CAPACITY` — the regime
        where the collision scan can no longer hold the throughput bar.
        The switch is PINNED at first resolution and persisted
        (``_tpu_config["engine_resolved"]``): once an instance has ranked
        by Hamming, every later query — including after a save/load or
        pickle round-trip, whatever capacity the restored store reports —
        ranks by Hamming too, so result ordering never silently changes
        across a checkpoint boundary. Only top-k RANKING changes:
        candidate enumeration (``top_k=None``) and top-p rerank keep
        collision semantics in every engine.
        """
        if not self._device_mode or not getattr(self._storage, "enable_hamming", False):
            return False
        if self._engine == "hamming":
            return True
        if self._engine != "auto":
            return False
        if self._tpu_config.get("engine_resolved") == "hamming":
            return True
        switched = (
            getattr(self._storage, "_capacity", 0) >= self._AUTO_HAMMING_CAPACITY
        )
        if switched:
            # Pin + persist: the switch is monotonic in-process (capacity
            # only grows), and pinning makes it monotonic across
            # checkpoint/restore too. Fires at most once per lineage.
            self._tpu_config["engine_resolved"] = "hamming"
            logger.info(
                "engine='auto': index capacity reached %d slots; top-k "
                "ranking switched from band-collision counting to "
                "full-signature Hamming (higher recall, ~3x throughput at "
                "this scale; engine='collision' pins reference-parity "
                "ordering). The resolution is pinned and persists with "
                "the index.",
                self._AUTO_HAMMING_CAPACITY,
            )
        return switched

    def query(
        self,
        vector: np.ndarray,
        *,
        top_k: Optional[int] = 10,
        top_p: Optional[float] = None,
        where=None,
    ) -> Union[list[int], CandidateScores]:
        """Retrieve candidates similar to the query vector.

        Top-k mode (``top_p=None``): ids of the ``top_k`` candidates with
        the most band collisions, ordered by ``(-count, id)``;
        ``top_k=None`` returns every colliding candidate.

        Top-p mode: candidates reranked by cosine similarity (resident
        payload or ``vector_fetch_fn``); returns the top
        ``max(1, ceil(n_candidates * top_p))`` as ``(id, score)`` tuples,
        additionally capped by ``top_k`` when given.

        ``where``: optional :class:`~lshrs_tpu.storage.IdFilter` (or an
        array-like allowlist of ids). Results rank ONLY the admitted
        subset — exact top-k/top-p over it, not post-filtering (a
        filtered-out candidate never consumes a result slot). Works on
        every backend and engine.

        Engine note: with ``engine="auto"`` (the default), top-k RANKING
        switches from band-collision counting to full-signature Hamming
        once index capacity crosses ``_AUTO_HAMMING_CAPACITY`` (512k
        slots) — better recall and throughput at scale, but a different
        ordering key. The switch is pinned at first resolution and
        persists with the index (``stats()["engine_resolved"]``), so the
        ordering for a given index never changes again — including across
        save/load. Pass ``engine="collision"`` for strict reference-parity
        ordering at every scale.
        """
        where = as_filter(where)
        query_vector = self._augment_query(
            self._prepare_vector(vector)[None, :]
        )[0]
        self._count("queries_served")

        # Fast path: bounded top-k against the device store never
        # materialises the candidate set on host.
        if (
            self._device_mode
            and top_p is None
            and top_k is not None
            and top_k > 0
        ):
            if self._use_hamming_ranking():
                qwords = self._hash_words(query_vector[None, :])
                hamming, ids = self._storage.query_hamming(qwords, top_k, where=where)  # type: ignore[attr-defined]
                return [int(i) for i in ids[0] if i >= 0]
            qwords = self._hash_query_words(query_vector[None, :])
            counts, ids = self._storage.query_topk(qwords, top_k, where=where)  # type: ignore[attr-defined]
            return [int(i) for i, c in zip(ids[0], counts[0]) if c > 0]

        # Fused device rerank: resident payload, no fetch callback — counts,
        # cosine ranking and cutoff all happen on device (one matvec), with
        # only the final (id, score) prefix reaching the host.
        if (
            self._device_mode
            and top_p is not None
            and self._store_vectors
            and self._vector_fetch_fn is None
        ):
            fused = self._query_topp_device(query_vector, top_k, top_p, where=where)
            if fused is not None:
                return fused

        ordered = self._ordered_candidates(query_vector, where=where)
        if not ordered:
            return []

        if top_p is None:
            if top_k is None:
                top_k = len(ordered)
            if top_k <= 0:
                raise ValueError("top_k must be greater than zero when provided")
            return [idx for idx, _ in ordered[:top_k]]

        if not 0 < top_p <= 1:
            raise ValueError("top_p must be within the range (0, 1]")

        candidate_indices = [idx for idx, _ in ordered]
        arr = self._fetch_candidates(candidate_indices)
        similarities = top_k_cosine(query_vector, arr, k=len(candidate_indices))
        scale = (
            float(self._score_scale(query_vector[None, :])[0])
            if self._similarity == "dot"
            else 1.0
        )
        ordered_scores = [
            (candidate_indices[pos], score * scale)
            for pos, score in similarities
        ]

        limit = max(1, math.ceil(len(ordered_scores) * top_p))
        if top_k is not None:
            if top_k <= 0:
                raise ValueError("top_k must be greater than zero when provided")
            limit = min(limit, top_k)
        return ordered_scores[:limit]

    def query_batch(
        self, vectors: np.ndarray, *, top_k: int = 10, where=None
    ) -> list[list[int]]:
        """Batched top-k collision query (device backend fast path).

        Hashes the whole batch with one matmul and runs a single fused
        scan; this is the high-QPS serving interface the reference lacks.
        ``where``: optional id filter (see :meth:`query`).

        On the bucket backends (memory/Redis) there is no device program
        to batch into: the call degrades to a per-vector :meth:`query`
        loop — reference-grade semantics and throughput, one storage
        round-trip sequence per vector. Construct with the device backend
        for fused batching.
        """
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        where = as_filter(where)
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        if self._device_mode:
            self._count("queries_served", arr.shape[0])
            arr = self._augment_query(arr)
            if self._use_hamming_ranking():
                qwords = self._hash_words(arr)
                _, ids = self._storage.query_hamming(qwords, top_k, where=where)  # type: ignore[attr-defined]
                return [[int(i) for i in row if i >= 0] for row in ids]
            qwords = self._hash_query_words(arr)
            counts, ids = self._storage.query_topk(qwords, top_k, where=where)  # type: ignore[attr-defined]
            return [
                [int(i) for i, c in zip(row_ids, row_counts) if c > 0]
                for row_ids, row_counts in zip(ids, counts)
            ]
        return [self.query(v, top_k=top_k, where=where) for v in arr]  # type: ignore[misc]

    def query_hamming(
        self, vector: np.ndarray, *, top_k: int = 10, where=None
    ) -> CandidateScores:
        """Rank by full-signature Hamming distance (extension beyond the reference).

        Uses every bit of the hash budget as a SimHash angular estimator
        (one int8 matmul over the store) instead of quantising bands
        to hit/miss; typically higher recall than collision counting at
        equal memory. Requires ``enable_hamming=True`` and the device
        backend. Returns ``(id, estimated_cosine)`` tuples, where
        ``estimated_cosine = cos(pi * hamming / num_perm)``.
        """
        if not self._device_mode:
            raise RuntimeError("query_hamming requires the device backend")
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        query_vector = self._augment_query(
            self._prepare_vector(vector)[None, :]
        )
        self._count("queries_served")
        qwords = self._hash_words(query_vector)
        hamming, ids = self._storage.query_hamming(  # type: ignore[attr-defined]
            qwords, top_k, where=as_filter(where)
        )
        num_perm = self._config["num_perm"]
        scale = float(self._score_scale(query_vector)[0])
        return [
            (int(i), float(math.cos(math.pi * int(h) / num_perm)) * scale)
            for i, h in zip(ids[0], hamming[0])
            if i >= 0
        ]

    def query_hamming_batch(
        self, vectors: np.ndarray, *, top_k: int = 10, where=None
    ) -> list[CandidateScores]:
        """Batched full-signature Hamming ranking (one fused device scan).

        Requires ``enable_hamming=True`` and the device backend; see
        :meth:`query_hamming` for semantics.
        """
        if not self._device_mode:
            raise RuntimeError("query_hamming requires the device backend")
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        self._count("queries_served", arr.shape[0])
        arr = self._augment_query(arr)
        qwords = self._hash_words(arr)
        hamming, ids = self._storage.query_hamming(  # type: ignore[attr-defined]
            qwords, top_k, where=as_filter(where)
        )
        num_perm = self._config["num_perm"]
        scales = self._score_scale(arr)
        return [
            [
                (int(i), float(math.cos(math.pi * int(h) / num_perm)) * scales[r])
                for i, h in zip(ids[r], hamming[r])
                if i >= 0
            ]
            for r in range(arr.shape[0])
        ]

    def query_asymmetric(
        self, vector: np.ndarray, *, top_k: int = 10, where=None
    ) -> CandidateScores:
        """Rank by the asymmetric SimHash estimator (extension beyond the reference).

        Like :meth:`query_hamming` but the query side keeps its full
        projection coordinates (quantised to int8) instead of collapsing
        to sign bits — strictly better rank correlation with cosine at
        identical store memory (`lshrs_tpu.ops.asymmetric`). Requires
        ``enable_hamming=True`` with ``hamming_storage="planes"`` and the
        device backend. Returns ``(id, estimated_cosine)`` tuples; the
        estimate is the self-normalising ``dots / sum|q|`` (converges to
        ``cos(theta)`` for hyperplane projections).
        """
        return self.query_asymmetric_batch(
            self._prepare_vector(vector)[None, :], top_k=top_k, where=where
        )[0]

    def query_asymmetric_batch(
        self, vectors: np.ndarray, *, top_k: int = 10, where=None
    ) -> list[CandidateScores]:
        """Batched asymmetric SimHash ranking (one fused device scan).

        See :meth:`query_asymmetric` for semantics.
        """
        from lshrs_tpu.ops.asymmetric import quantize_coords_np

        if not self._device_mode:
            raise RuntimeError("query_asymmetric requires the device backend")
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        self._count("queries_served", arr.shape[0])
        arr = self._augment_query(arr)
        coords = self._hasher.hash_batch_coords_host(arr)
        qi8, sumabs = quantize_coords_np(coords)
        dots, ids = self._storage.query_asymmetric(  # type: ignore[attr-defined]
            qi8, top_k, where=as_filter(where)
        )
        denom = np.maximum(sumabs, 1).astype(np.float64) / self._score_scale(arr)
        return [
            [
                (int(i), float(d / denom[r]))
                for i, d in zip(ids[r], dots[r])
                if i >= 0
            ]
            for r in range(arr.shape[0])
        ]

    def get_above_p_batch(
        self,
        vectors: np.ndarray,
        p: float = 0.95,
        *,
        top_k: Optional[int] = None,
        max_candidates: int = 4096,
        wire_dtype: str = "float32",
        where=None,
    ) -> list[CandidateScores]:
        """Batched cosine-reranked top-p (device fused path).

        One device dispatch reranks the whole batch against the resident
        payload (requires ``store_vectors=True`` on the device backend);
        other configurations fall back to per-query :meth:`query`. Each
        query returns its top ``max(1, ceil(p * n_candidates))`` scored
        results (capped by ``top_k`` and ``max_candidates``).

        ``wire_dtype="bfloat16"`` ships the raw query vectors at half the
        bytes (for hosts where the rerank upload bounds throughput) at
        ~1e-2 relative cosine error; the default ``"float32"``
        is value-exact.
        """
        if not 0 < p <= 1:
            raise ValueError("top_p must be within the range (0, 1]")
        if top_k is not None and top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        if wire_dtype not in ("float32", "bfloat16"):
            raise ValueError("wire_dtype must be 'float32' or 'bfloat16'")
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        where = as_filter(where)
        fused = (
            self._device_mode
            and self._store_vectors
            and self._vector_fetch_fn is None
            and hasattr(self._storage, "query_topp_batch")
        )
        if not fused:
            return [
                self.query(v, top_k=top_k, top_p=p, where=where)  # type: ignore[misc]
                for v in arr
            ]
        self._count("queries_served", arr.shape[0])
        arr = self._augment_query(arr)
        qwords = self._hash_query_words(arr)
        # The per-query cutoff is min(ceil(p*n), top_k), so top_k bounds
        # how much of the ranking is ever consumed.
        max_out = min(max_candidates, top_k) if top_k is not None else max_candidates
        ids, sims, n = self._storage.query_topp_batch(  # type: ignore[attr-defined]
            qwords, arr, max_out, wire_dtype=wire_dtype, where=where
        )
        if self._similarity == "dot":
            sims = sims * self._score_scale(arr)[:, None]
        results: list[CandidateScores] = []
        for qi in range(arr.shape[0]):
            n_q = int(n[qi])
            if n_q == 0:
                results.append([])
                continue
            limit = max(1, math.ceil(n_q * p))
            if top_k is not None:
                limit = min(limit, top_k)
            limit = min(limit, ids.shape[1])
            results.append(
                [
                    (int(i), float(s))
                    for i, s in zip(ids[qi, :limit], sims[qi, :limit])
                    if i >= 0
                ]
            )
        return results

    def serving_fn(
        self,
        top_k: int = 10,
        *,
        mode: Optional[str] = None,
        wire_dtype: str = "float32",
        coords_wire: str = "int8",
        auto_refresh: bool = False,
        batch_hint: int = 1024,
        where=None,
    ):
        """Compiled high-QPS serving closure over the *current* index.

        The public face of the snapshot serving fast path (device backend
        only): each call of the returned closure hashes its batch through
        this instance's hash path and runs ONE fused *query* dispatch
        (wire decode + scan + exact top-k + id select). With
        ``hash_mode="host"`` the minimal dense wire encoding ships and
        that is the only device program per batch; ``hash_mode="device"``
        additionally dispatches the hash matmul as its own program first
        (two round trips per batch). Mutating the index invalidates the
        closure (it raises ``RuntimeError``) — take a new one after
        ingesting.

        Args:
            top_k: result depth per query.
            mode: ``"collision"`` (band-collision top-k), ``"hamming"``
                (full-signature SimHash ranking, requires
                ``enable_hamming=True``), ``"asymmetric"`` (quantised
                query coordinates vs store bitplanes — the strongest
                no-payload ranking; requires ``enable_hamming=True``
                with ``hamming_storage="planes"``) or ``"topp"`` (fused
                cosine rerank against the resident payload, requires
                ``store_vectors=True``). ``None`` (default) follows the
                instance's resolved ranking ``engine`` — collision below
                `_AUTO_HAMMING_CAPACITY` slots, packed-Hamming past it.
            wire_dtype: ``"topp"`` only — ``"bfloat16"`` ships the raw
                query vectors at half the bytes (~1e-2 relative cosine
                rounding); ``"float32"`` is value-exact.
            coords_wire: ``"asymmetric"`` only — ``"int8"`` (default,
                ``num_perm`` bytes/query) or ``"int4"`` (two coords per
                byte: half the transport, with the query quantised to
                ``[-7, 7]`` — retains most of the asymmetric recall
                gain).
            where: optional :class:`~lshrs_tpu.storage.IdFilter` (or an
                array-like allowlist of ids) baked into the snapshot:
                every batch ranks ONLY the admitted subset (exact — a
                filtered-out candidate never consumes a result slot).
                The filter state is captured with the snapshot; mutate
                + re-snapshot (or ``auto_refresh``) to track changes.
            batch_hint: ``"topp"`` only — the query-batch size the
                closure will be served with. The auto rerank engine's
                memory-feasibility check sizes the full formulation's
                ``(Q, capacity)`` temporaries from it; a closure
                resolved at the 1024 default but dispatched with
                8k-query batches can compile-OOM at 1M+ capacity (the
                round-5 cp_bench failure mode). Pass your real batch
                size.
            auto_refresh: serve through mutations — on a stale snapshot
                the closure transparently re-snapshots the CURRENT index
                contents and retries (thread-safe; re-snapshotting is
                cheap because store state rides as jit arguments, so the
                already-compiled program is reused). The default
                ``False`` keeps the strict contract: mutations raise
                ``RuntimeError`` until the caller re-creates the closure.

        Returns:
            ``mode="collision"``/``"hamming"``/``"asymmetric"``: callable
            ``(vectors (Q, dim)) -> (Q, top_k) int32 ndarray`` of ids
            (-1 padding). ``mode="topp"``: callable returning
            ``(ids (Q, top_k), cosines (Q, top_k), n_candidates (Q,))``.
        """
        if not self._device_mode:
            raise RuntimeError("serving_fn requires the device backend")
        where = as_filter(where)
        if auto_refresh:
            refresh_lock = Lock()
            inner: list = [None]

            def _current():
                with refresh_lock:
                    if inner[0] is None:
                        inner[0] = self.serving_fn(
                            top_k,
                            mode=mode,
                            wire_dtype=wire_dtype,
                            coords_wire=coords_wire,
                            batch_hint=batch_hint,
                            where=where,
                        )
                    return inner[0]

            def refreshing(vectors):
                fn = _current()
                try:
                    return fn(vectors)
                except RuntimeError as e:
                    if "stale" not in str(e):
                        raise
                    with refresh_lock:
                        # another thread may already have refreshed
                        if inner[0] is fn:
                            inner[0] = None
                    return _current()(vectors)

            return refreshing
        if mode is None:
            mode = "hamming" if self._use_hamming_ranking() else "collision"
        if mode not in ("collision", "hamming", "asymmetric", "topp"):
            raise ValueError(
                "mode must be 'collision', 'hamming', 'asymmetric' or 'topp'"
            )
        if mode in ("hamming", "asymmetric") and (
            self._hasher.hash_family == "crosspolytope"
        ):
            raise ValueError(
                f"mode='{mode}' requires sign-bit signatures; the "
                "cross-polytope family serves mode='collision' or 'topp'"
            )
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        if wire_dtype not in ("float32", "bfloat16"):
            raise ValueError("wire_dtype must be 'float32' or 'bfloat16'")
        wire = "words" if self._hash_on_device else "dense"

        def _validate(vectors) -> np.ndarray:
            arr = np.asarray(vectors, dtype=np.float32)
            if arr.ndim != 2 or arr.shape[1] != self._dim:
                raise ValueError(
                    f"Vectors must have shape (n, {self._dim}); "
                    f"received {arr.shape}"
                )
            return arr

        def _hash_wire(arr: np.ndarray, n_probes: int):
            """Serving wire for a query batch: probe words (device hash)
            or the dense probe wire (host hash) when probing, the
            instance's ingest wire otherwise."""
            if n_probes > 1:
                if self._hash_on_device:
                    return self._hasher.hash_batch_probe_words(arr, n_probes)
                return self._hasher.hash_batch_probe_dense_host(arr, n_probes)
            return self._hash_for_ingest(arr)

        if mode == "topp":
            topp_probes = self._multiprobe
            serve = self._storage.snapshot_topp_fn(  # type: ignore[attr-defined]
                top_k, wire=wire, probes=topp_probes,
                batch_hint=batch_hint, where=where,
            )

            def run_topp(vectors):
                arr = self._augment_query(_validate(vectors))
                sig = _hash_wire(arr, topp_probes)
                qv: np.ndarray = arr
                if wire_dtype == "bfloat16":
                    import ml_dtypes

                    qv = arr.astype(ml_dtypes.bfloat16)
                ids, sims, n = serve(sig, qv)
                # Count after the dispatch: stale-snapshot calls raise and
                # must not inflate queries_served.
                self._count("queries_served", arr.shape[0])
                sims = np.asarray(sims)
                if self._similarity == "dot":
                    sims = sims * self._score_scale(arr)[:, None]
                return np.asarray(ids), sims, np.asarray(n)

            return run_topp

        if mode == "asymmetric":
            from lshrs_tpu.ops.asymmetric import (
                QMAX4,
                pack_coords_int4_np,
                quantize_coords_np,
            )

            if coords_wire not in ("int8", "int4"):
                raise ValueError("coords_wire must be 'int8' or 'int4'")
            int4 = coords_wire == "int4"
            serve_a = self._storage.snapshot_query_fn(  # type: ignore[attr-defined]
                top_k,
                mode="asymmetric",
                wire="coords4" if int4 else "words",
                where=where,
            )

            def run_asym(vectors):
                arr = self._augment_query(_validate(vectors))
                # The asymmetric wire is the quantised projection coords
                # (num_perm bytes/query; "int4" packs two per byte for
                # half the transport at a small recall cost) — computed
                # on host for both hash modes, matching
                # query_asymmetric_batch's estimator.
                coords = self._hasher.hash_batch_coords_host(arr)
                if int4:
                    qi8, _ = quantize_coords_np(coords, qmax=QMAX4)
                    sig = pack_coords_int4_np(qi8)
                else:
                    sig, _ = quantize_coords_np(coords)
                out = np.asarray(serve_a(sig))
                # Count after the dispatch: stale-snapshot calls raise and
                # must not inflate queries_served.
                self._count("queries_served", arr.shape[0])
                return out

            return run_asym

        # Collision-mode serving honors the instance's multi-probe depth;
        # the probe wire grows a T axis (T * bytes/query).
        probes = self._multiprobe if mode == "collision" else 1
        serve = self._storage.snapshot_query_fn(  # type: ignore[attr-defined]
            top_k, wire=wire, mode=mode, probes=probes, where=where
        )

        def run(vectors):
            arr = self._augment_query(_validate(vectors))
            sig = _hash_wire(arr, probes)
            out = np.asarray(serve(sig))
            # Count after the dispatch: stale-snapshot calls raise and must
            # not inflate queries_served.
            self._count("queries_served", arr.shape[0])
            return out

        return run

    def get_top_k(self, vector: np.ndarray, topk: int = 10) -> list[int]:
        """Top ``topk`` candidate ids by band-collision count."""
        results = self.query(vector, top_k=topk, top_p=None)
        return list(results)  # type: ignore[arg-type]

    def get_above_p(self, vector: np.ndarray, p: float = 0.95) -> CandidateScores:
        """Cosine-reranked top ``ceil(p * n_candidates)`` scored results."""
        results = self.query(vector, top_k=None, top_p=p)
        return list(results)  # type: ignore[arg-type]

    _MAX_DEVICE_RERANK = 4096

    def _query_topp_device(
        self, query_vector: np.ndarray, top_k: Optional[int], top_p: float,
        where=None,
    ) -> Optional[CandidateScores]:
        """Fused top-p on the device store; None -> caller falls back."""
        qwords = self._hash_query_words(query_vector[None, :])
        ids, sims, n = self._storage.query_topp(  # type: ignore[attr-defined]
            qwords, query_vector, self._MAX_DEVICE_RERANK, where=where
        )
        if self._similarity == "dot":
            sims = sims * float(self._score_scale(query_vector[None, :])[0])
        if n == 0:
            return []
        if not 0 < top_p <= 1:
            raise ValueError("top_p must be within the range (0, 1]")
        limit = max(1, math.ceil(n * top_p))
        if top_k is not None:
            if top_k <= 0:
                raise ValueError("top_k must be greater than zero when provided")
            limit = min(limit, top_k)
        if limit > min(n, len(ids)):
            return None  # prefix too short: take the general path
        return [(int(i), float(s)) for i, s in zip(ids[:limit], sims[:limit])]

    # First guess for the bounded unbounded-candidate enumeration; grows
    # geometrically until the device-verified candidate count fits, so the
    # host readback stays O(candidates) instead of O(capacity).
    _CANDIDATE_ENUM_START = 4096

    def _ordered_candidates(
        self, query_vector: np.ndarray, where=None
    ) -> list[tuple[int, int]]:
        """All colliding candidates ordered by ``(-count, id)``.

        Device mode enumerates them BOUNDED: an exact device top-M by
        ``(count, id)`` plus an O(1)-readback total-candidate probe
        (`DeviceStore.query_nnz`); M grows geometrically on the rare
        queries whose candidate set exceeds it. The reference (and the
        previous implementation) materialised the entire per-slot count
        array on the host (`/root/reference/lshrs/core/main.py:605-614`)
        — 4 MB of readback per query at 1M slots.
        """
        if self._device_mode:
            qwords = self._hash_query_words(query_vector[None, :])
            n = int(self._storage.query_nnz(qwords, where=where)[0])  # type: ignore[attr-defined]
            if n == 0:
                return []
            m = max(self._CANDIDATE_ENUM_START, 1 << (n - 1).bit_length())
            counts, ids = self._storage.query_topk(  # type: ignore[attr-defined]
                qwords, m, where=where
            )
            return [
                (int(i), int(c)) for i, c in zip(ids[0, :n], counts[0, :n])
            ]
        counts_map = self._candidate_counts(query_vector)
        if where is not None:
            # Bucket backends (memory / Redis) filter host-side: one
            # vectorized membership probe over the candidate set.
            cand = np.fromiter(counts_map, dtype=np.int64, count=len(counts_map))
            admitted = where.admits(cand)
            counts_map = {
                int(i): counts_map[int(i)]
                for i, ok in zip(cand, admitted)
                if ok
            }
        return sorted(counts_map.items(), key=lambda item: (-item[1], item[0]))

    def _candidate_counts(self, query_vector: np.ndarray) -> dict[int, int]:
        """Bucket-backend path: per-band bucket reads + dict counting.

        With ``multiprobe=T > 1`` every band additionally reads its T-1
        probe buckets (the reference's per-band SMEMBERS loop,
        `/root/reference/lshrs/core/main.py:1105-1109`, extended with
        query-directed probing); a candidate's band signature lives in
        exactly one bucket, so the union over probes keeps counts
        <= num_bands.
        """
        if self._multiprobe > 1:
            probe_words = self._hasher.hash_batch_probe_words_host(
                query_vector[None, :], self._multiprobe
            )[0]
            sigs = [
                self._hasher.words_to_signature(probe_words[t])
                for t in range(self._multiprobe)
            ]
            counts: dict[int, int] = {}
            for band_id in range(self._config["num_bands"]):
                candidates: set[int] = set()
                for sig in sigs:
                    candidates |= self._storage.get_bucket(band_id, sig[band_id])
                for candidate in candidates:
                    counts[candidate] = counts.get(candidate, 0) + 1
            return counts
        signatures = self._hasher.hash_vector(query_vector)
        counts = {}
        for band_id, hash_val in enumerate(signatures):
            for candidate in self._storage.get_bucket(band_id, hash_val):
                counts[candidate] = counts.get(candidate, 0) + 1
        return counts

    def _fetch_candidates(self, candidate_indices: list[int]) -> np.ndarray:
        """Candidate payloads from the resident matrix or the user callback."""
        if self._vector_fetch_fn is None and self._store_vectors:
            return self._storage.get_vectors(candidate_indices)  # type: ignore[attr-defined]
        fetch_fn = self._require_vector_fetch_fn()
        candidate_vectors = fetch_fn(candidate_indices)
        arr = np.asarray(candidate_vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Fetched vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        if arr.shape[0] != len(candidate_indices):
            raise ValueError(
                "vector_fetch_fn returned mismatched batch size "
                f"(expected {len(candidate_indices)}, received {arr.shape[0]})"
            )
        return self._augment_data(arr)

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------

    def delete(self, indices: Union[int, Sequence[int]]) -> None:
        """Hard-delete ids from the index (tombstoned on device)."""
        to_remove = [indices] if isinstance(indices, int) else [int(i) for i in indices]
        self._count("deletes", len(to_remove))
        self._storage.remove_indices(to_remove)

    def clear(self) -> None:
        """Flush, then drop every indexed entry (projections are kept)."""
        self.flush()
        self._storage.clear()

    def rehash(
        self,
        *,
        num_perm: Optional[int] = None,
        num_bands: Optional[int] = None,
        rows_per_band: Optional[int] = None,
        similarity_threshold: Optional[float] = None,
        seed: Optional[int] = None,
        hash_family: Optional[str] = None,
    ) -> None:
        """Retune the index IN PLACE: rebuild every stored signature from
        the resident payload under a new banding / threshold / seed / hash
        family — no re-ingestion from the primary datastore.

        The reference cannot do this at all: its Redis buckets hold only
        memberships, so changing the operating point means re-streaming
        the full dataset through `create_signatures`
        (`/root/reference/lshrs/core/main.py:315`). With the payload
        resident in device memory the rebuild is a handful of hash-matmul
        dispatches (`DeviceStore.rehash`; `benchmarks/rehash_bench.py`
        times it).

        Args:
            num_perm / similarity_threshold: auto-tune the new banding via
                `get_optimal_config` (defaults: current values). Or pass
                ``num_bands`` AND ``rows_per_band`` explicitly.
            seed / hash_family: optionally re-draw the projections.

        Requires the device backend with ``store_vectors=True``. Deleted
        (tombstoned) entries stay deleted. Signatures derive from the
        payload at its stored precision — exact for the default
        ``payload_dtype="float32"`` (bit-identical to a fresh build); see
        `DeviceStore.rehash` for the bf16/int8 caveat. Serving closures
        from before the rehash raise the usual staleness error.
        """
        if not isinstance(self._storage, DeviceStore):
            raise RuntimeError(
                "rehash requires the device backend: bucket stores hold "
                "no payload to rebuild signatures from"
            )
        if not self._store_vectors:
            raise RuntimeError(
                "rehash requires store_vectors=True: signatures are "
                "rebuilt from the resident payload"
            )
        if (num_bands is None) != (rows_per_band is None):
            raise ValueError(
                "provide both num_bands and rows_per_band, or neither"
            )
        self.flush()
        cfg = self._config
        threshold = (
            cfg["similarity_threshold"]
            if similarity_threshold is None
            else similarity_threshold
        )
        if num_bands is None:
            new_perm = cfg["num_perm"] if num_perm is None else num_perm
            num_bands, rows_per_band = get_optimal_config(new_perm, threshold)
        new_perm = num_bands * rows_per_band
        if num_perm is not None and num_perm != new_perm:
            raise ValueError(
                "num_bands * rows_per_band must equal num_perm "
                f"(received {num_bands} * {rows_per_band} != {num_perm})"
            )
        seed = cfg["seed"] if seed is None else seed
        if hash_family is None:
            hash_family = self._tpu_config["hash_family"]
        if hash_family not in ("gaussian", "structured", "learned", "crosspolytope"):
            raise ValueError(
                "hash_family must be 'gaussian', 'structured', 'learned' "
                "or 'crosspolytope'"
            )
        if (hash_family == "crosspolytope") != (
            self._tpu_config["hash_family"] == "crosspolytope"
        ) and (
            getattr(self._storage, "enable_hamming", False)
            or self._engine == "hamming"
        ):
            raise ValueError(
                "cannot rehash across the cross-polytope boundary while "
                "Hamming ranking is enabled: construct the index with "
                "engine='collision' and enable_hamming=False first"
            )
        max_probes = (
            1 << (rows_per_band - 1)
            if hash_family == "crosspolytope"
            else rows_per_band
        )
        if self._multiprobe > max_probes:
            bound = "cp_dims" if hash_family == "crosspolytope" else "rows_per_band"
            raise ValueError(
                f"multiprobe must be <= {bound} "
                f"(= {max_probes}); received {self._multiprobe}"
            )
        projection = None
        if hash_family == "learned":
            # A learned matrix is data, not a seed — rehash can only carry
            # the CURRENT one (re-banding the same bits). Fitting a new one
            # is `retrain`'s job.
            if (
                self._hasher.hash_family != "learned"
                or self._hasher.projection_matrix.shape[0] != new_perm
            ):
                raise ValueError(
                    "rehash cannot draw a learned projection; use "
                    "retrain(sample) to fit one (or rehash within the "
                    "current num_perm to re-band the existing learned bits)"
                )
            projection = self._hasher.projection_matrix

        hasher = LSHHasher(
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            dim=self._hash_dim,
            seed=seed,
            hash_family=hash_family,
            projection=projection,
        )
        self._rebuild_store_signatures(hasher, num_bands, rows_per_band)
        cfg.update(
            num_perm=new_perm,
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            similarity_threshold=threshold,
            seed=seed,
        )
        self._tpu_config["hash_family"] = hash_family

    def _rebuild_store_signatures(
        self, hasher: LSHHasher, num_bands: int, rows_per_band: int
    ) -> None:
        """Rebuild every stored signature under ``hasher`` and install it."""
        store = self._storage
        if self._hash_on_device or hasher.hash_family in (
            "structured", "crosspolytope"
        ):
            store.rehash(
                hasher.device_projection(),
                num_bands=num_bands,
                rows_per_band=rows_per_band,
                hash_family=hasher.hash_family,
            )
        else:
            # hash_mode="host": host BLAS and the device matmul round differently,
            # and stored/query signatures must come from ONE path per
            # store — rebuild through a host round trip of the payload
            # (slower, still no primary-datastore re-ingest).
            snap = store.state_arrays()
            ids = np.asarray(snap["ids"], dtype=np.int64)
            alive = ids >= 0
            vec = np.asarray(snap["payload"], dtype=np.float32)[alive]
            store._reset_banding(num_bands, rows_per_band)
            if len(vec):
                store.add_signature_batch(
                    ids[alive], hasher.hash_batch_words_host(vec), vec
                )
        self._hasher = hasher

    def retrain(
        self,
        sample: Optional[np.ndarray] = None,
        *,
        iters: int = 64,
        sample_cap: int = 131072,
        seed: Optional[int] = None,
    ) -> dict[str, Any]:
        """Fit DATA-DEPENDENT hyperplanes (ITQ, `lshrs_tpu.hash.itq`) and
        rebuild the index's signatures under them, in place.

        The reference's hash family is frozen at seeded random hyperplanes
        (`/root/reference/lshrs/hash/lsh.py:93-94`). With the payload
        resident on the device this index can instead LEARN its projections
        from the indexed distribution — higher recall per bit on real
        embedding geometry — and swap them in
        with a handful of device rehash dispatches, no re-ingestion.

        Args:
            sample: ``(n, dim)`` representative raw vectors to fit on
                (``similarity="dot"`` indexes augment them exactly like
                ingest does). Default: the resident payload rows
                themselves — the index fits to what it actually holds.
            iters: ITQ alternation count.
            sample_cap: fit at most this many rows (evenly strided
                subsample; the fit is a host-side SVD + small GEMMs).
            seed: rotation-init / padding seed (default: current seed).

        Returns:
            The fit diagnostics dict from
            `lshrs_tpu.hash.itq.fit_itq_projection` (bit balance,
            quantization alignment, padded-bit count).

        Keeps the current banding; `rehash` re-bands afterwards if needed
        (the learned matrix is carried as long as ``num_perm`` is
        unchanged). Serving closures from before the retrain raise the
        usual staleness error. Like `rehash`, requires the device backend
        with ``store_vectors=True``.
        """
        from lshrs_tpu.hash.itq import fit_itq_projection

        if not isinstance(self._storage, DeviceStore):
            raise RuntimeError(
                "retrain requires the device backend: bucket stores hold "
                "no payload to rebuild signatures from"
            )
        if not self._store_vectors:
            raise RuntimeError(
                "retrain requires store_vectors=True: signatures are "
                "rebuilt from the resident payload"
            )
        self.flush()
        cfg = self._config
        if sample is None:
            # Device-side strided sampling: reads back <= sample_cap rows
            # regardless of capacity (a full snapshot of a 1M x 768d
            # store would move ~3 GB over the transport). int8 rows come
            # back dequantized; the fit l2-normalizes anyway, so the
            # per-row scale drops out.
            rows = self._storage.sample_payload_rows(sample_cap)
            if rows.shape[0] < 2:
                raise RuntimeError(
                    "retrain needs at least 2 indexed vectors to fit on "
                    "(or pass an explicit sample)"
                )
        else:
            arr = np.asarray(sample, dtype=np.float32)
            if arr.ndim != 2 or arr.shape[1] != self._dim:
                raise ValueError(
                    f"sample must have shape (n, {self._dim}); "
                    f"received {tuple(arr.shape)}"
                )
            rows = self._augment_data(arr)
        if rows.shape[0] > sample_cap:
            stride = rows.shape[0] / sample_cap
            rows = rows[(np.arange(sample_cap) * stride).astype(np.int64)]
        seed = cfg["seed"] if seed is None else seed
        proj, info = fit_itq_projection(
            rows, cfg["num_perm"], iters=iters, seed=seed, return_info=True
        )
        hasher = LSHHasher(
            num_bands=cfg["num_bands"],
            rows_per_band=cfg["rows_per_band"],
            dim=self._hash_dim,
            seed=seed,
            hash_family="learned",
            projection=proj,
        )
        self._rebuild_store_signatures(
            hasher, cfg["num_bands"], cfg["rows_per_band"]
        )
        cfg["seed"] = seed
        self._tpu_config["hash_family"] = "learned"
        return info

    def stats(self) -> dict[str, Any]:
        """Configuration snapshot plus backend counters."""
        with self._buffer_lock:
            buffered = self._buffered_ops()
        out: dict[str, Any] = {
            "dimension": self._dim,
            "num_perm": self._config["num_perm"],
            "num_bands": self._config["num_bands"],
            "rows_per_band": self._config["rows_per_band"],
            "buffer_size": self._buffer_size,
            "similarity_threshold": self._config["similarity_threshold"],
            "redis_prefix": self._redis_config["prefix"],
            "backend": self._tpu_config["backend"],
            "engine": self._engine,
            "engine_resolved": self._tpu_config.get("engine_resolved"),
            "similarity": self._similarity,
            "multiprobe": self._multiprobe,
            "ranking": "hamming" if self._use_hamming_ranking() else "collision",
            "buffered_operations": buffered,
            "counters": dict(self._counters),
        }
        if isinstance(self._storage, DeviceStore):
            out["index"] = self._storage.stats()
        return out

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_to_disk(self, path: Union[str, Path]) -> None:
        """Persist config + projections (and device index state) to a dir.

        Writes ``metadata.json`` (password redacted) and
        ``projections.npz``; device backends also write ``index.npz`` with
        the packed signature store so the whole index restores without a
        rebuild — a capability the reference delegates to Redis durability.
        """
        self.flush()
        output_dir = Path(path)
        output_dir.mkdir(parents=True, exist_ok=True)

        sanitized_redis = self._redis_config.copy()
        if "password" in sanitized_redis:
            sanitized_redis["password"] = "<REDACTED>"
        metadata = {
            "version": _METADATA_VERSION,
            "config": self._config,
            "redis_config": sanitized_redis,
            "tpu_config": self._tpu_config,
        }
        with open(output_dir / "metadata.json", "w") as f:
            json.dump(metadata, f, indent=2)

        if self._hasher.hash_family in ("structured", "crosspolytope"):
            np.savez_compressed(
                output_dir / "diagonals.npz", diagonals=self._hasher.diagonals
            )
        else:
            np.savez_compressed(
                output_dir / "projections.npz", *self._hasher.projections
            )

        if isinstance(self._storage, DeviceStore) and len(self._storage):
            np.savez_compressed(output_dir / "index.npz", **self._storage.state_arrays())

    @classmethod
    def load_from_disk(
        cls,
        path: Union[str, Path],
        *,
        redis_config: Optional[dict[str, Any]] = None,
        vector_fetch_fn: Optional[VectorFetchFn] = None,
        storage: Optional[BaseStorage] = None,
    ) -> "LSHRS":
        """Restore an instance saved with :meth:`save_to_disk`.

        ``redis_config`` overrides stored connection settings (the stored
        password is redacted and must be re-supplied when needed).
        """
        input_dir = Path(path)
        if not input_dir.exists():
            raise FileNotFoundError(f"Directory not found: {input_dir}")

        with open(input_dir / "metadata.json") as f:
            metadata = json.load(f)
        config = metadata["config"]
        stored_redis = metadata["redis_config"].copy()
        tpu_config = metadata.get("tpu_config", {})
        if redis_config:
            stored_redis.update(redis_config)
        if tpu_config.get("backend") == "custom" and storage is None:
            # The original used a caller-supplied backend that cannot be
            # reconstructed here; bucket contents live out-of-process anyway.
            tpu_config = {**tpu_config, "backend": "memory"}

        instance = cls(
            dim=config["dim"],
            num_perm=config["num_perm"],
            num_bands=config["num_bands"],
            rows_per_band=config["rows_per_band"],
            similarity_threshold=config["similarity_threshold"],
            buffer_size=config["buffer_size"],
            vector_fetch_fn=vector_fetch_fn,
            storage=storage,
            redis_host=stored_redis["host"],
            redis_port=stored_redis["port"],
            redis_db=stored_redis["db"],
            redis_password=stored_redis["password"],
            redis_prefix=stored_redis["prefix"],
            decode_responses=stored_redis["decode_responses"],
            redis_max_connections=stored_redis.get("max_connections", 50),
            seed=config["seed"],
            similarity=config.get("similarity", "cosine"),
            max_norm=config.get("max_norm"),
            **cls._restore_tpu_kwargs(tpu_config),
        )

        if instance._hasher.hash_family in ("structured", "crosspolytope"):
            with np.load(input_dir / "diagonals.npz") as data:
                instance._hasher.diagonals = data["diagonals"]
        else:
            with np.load(input_dir / "projections.npz") as data:
                instance._hasher.projections = [
                    data[f"arr_{i}"].astype(np.float32)
                    for i in range(len(data.files))
                ]

        index_path = input_dir / "index.npz"
        if index_path.exists() and isinstance(instance._storage, DeviceStore):
            with np.load(index_path) as data:
                instance._storage.load_state_arrays({k: data[k] for k in data.files})
        if tpu_config.get("engine_resolved"):
            # Pinned auto-engine resolution survives the checkpoint: result
            # ordering never silently changes across a restore boundary.
            instance._tpu_config["engine_resolved"] = tpu_config["engine_resolved"]
        return instance

    @classmethod
    def _restore_tpu_kwargs(cls, tpu_config: dict[str, Any]) -> dict[str, Any]:
        """Constructor kwargs reproducing a saved instance's capabilities.

        ``shards`` degrades (with a warning) to a single-device store when
        the restoring process exposes fewer devices than the index was
        sharded over; every other capability round-trips exactly.
        """
        shards = tpu_config.get("shards")
        if shards is not None and shards > 1:
            import jax

            available = len(jax.devices())
            if shards > available:
                logger.warning(
                    "Index was saved with shards=%d but only %d device(s) "
                    "are available; restoring unsharded (results are "
                    "identical, capacity is single-device).",
                    shards,
                    available,
                )
                shards = None
        return {
            "backend": tpu_config.get("backend", "device"),
            "store_vectors": tpu_config.get("store_vectors", False),
            "initial_capacity": tpu_config.get("initial_capacity", 1 << 14),
            "chunk_size": tpu_config.get("chunk_size", 2048),
            "shards": shards,
            "enable_hamming": tpu_config.get("enable_hamming", False),
            "group_size": tpu_config.get("group_size", 32),
            "dedupe": tpu_config.get("dedupe", True),
            "query_mode": tpu_config.get("query_mode", "scan"),
            "bucket_cap": tpu_config.get("bucket_cap", 128),
            "hash_mode": tpu_config.get("hash_mode", "device"),
            "hash_family": tpu_config.get("hash_family", "gaussian"),
            "hamming_storage": tpu_config.get("hamming_storage", "planes"),
            "hamming_cascade": tpu_config.get("hamming_cascade", 0),
            "hamming_cascade_refine": tpu_config.get(
                "hamming_cascade_refine", 2048
            ),
            "payload_dtype": tpu_config.get("payload_dtype", "float32"),
            "rerank_engine": tpu_config.get("rerank_engine", "auto"),
            "rerank_candidates": tpu_config.get("rerank_candidates", 1024),
            # Saved instances predating the engine knob behaved as
            # "collision"; restore them unchanged.
            "engine": tpu_config.get("engine", "collision"),
            "multiprobe": tpu_config.get("multiprobe", 1),
        }

    # ------------------------------------------------------------------
    # pickle protocol
    # ------------------------------------------------------------------

    def __getstate__(self) -> dict[str, Any]:
        self.flush()
        state: dict[str, Any] = {
            "config": self._config.copy(),
            "redis_config": self._redis_config.copy(),
            "tpu_config": self._tpu_config.copy(),
        }
        if self._hasher.hash_family in ("structured", "crosspolytope"):
            state["diagonals"] = np.asarray(self._hasher.diagonals)
        else:
            state["projections"] = [
                np.asarray(m, dtype=np.float32) for m in self._hasher.projections
            ]
        if isinstance(self._storage, DeviceStore) and len(self._storage):
            state["index_state"] = self._storage.state_arrays()
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        config = state["config"]
        redis_config = state["redis_config"]
        tpu_config = state.get("tpu_config", {})
        if tpu_config.get("backend") == "custom":
            tpu_config = {**tpu_config, "backend": "memory"}
        restored = self.__class__(
            dim=config["dim"],
            num_perm=config["num_perm"],
            num_bands=config["num_bands"],
            rows_per_band=config["rows_per_band"],
            similarity_threshold=config["similarity_threshold"],
            buffer_size=config["buffer_size"],
            vector_fetch_fn=None,  # callables are not persisted
            redis_host=redis_config["host"],
            redis_port=redis_config["port"],
            redis_db=redis_config["db"],
            redis_password=redis_config["password"],
            redis_prefix=redis_config["prefix"],
            decode_responses=redis_config["decode_responses"],
            redis_max_connections=redis_config.get("max_connections", 50),
            seed=config["seed"],
            similarity=config.get("similarity", "cosine"),
            max_norm=config.get("max_norm"),
            **self._restore_tpu_kwargs(tpu_config),
        )
        self.__dict__ = restored.__dict__
        if tpu_config.get("engine_resolved"):
            # Pinned auto-engine resolution survives pickling (see
            # load_from_disk): ordering is stable across the round-trip.
            self._tpu_config["engine_resolved"] = tpu_config["engine_resolved"]
        if "diagonals" in state:
            self._hasher.diagonals = state["diagonals"]
        else:
            self._hasher.projections = [
                np.asarray(m, dtype=np.float32) for m in state["projections"]
            ]
        if "index_state" in state and isinstance(self._storage, DeviceStore):
            self._storage.load_state_arrays(state["index_state"])

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _hash_words(self, arr: np.ndarray):
        """Batch-hash through this instance's single hash path."""
        if self._hash_on_device:
            return self._hasher.hash_batch_words(arr)
        return self._hasher.hash_batch_words_host(arr)

    def _hash_query_words(self, arr: np.ndarray):
        """Collision-path QUERY hashing, with multi-probe expansion.

        With ``multiprobe=T > 1`` the result is ``(Q, T, BW)`` — probe 0
        is the plain signature (bit-identical to the ingest hash), probes
        ``t >= 1`` flip each band's ``t``-th lowest-margin bit. The store
        counts bands matching ANY probe, expanding candidate sets at zero
        memory cost (only collision counting and top-p candidate
        enumeration consume probes; Hamming/asymmetric ranking scores all
        slots already).
        """
        if self._multiprobe > 1:
            if self._hash_on_device:
                return self._hasher.hash_batch_probe_words(arr, self._multiprobe)
            return self._hasher.hash_batch_probe_words_host(arr, self._multiprobe)
        return self._hash_words(arr)

    def _hash_for_ingest(self, arr: np.ndarray):
        """Ingest-path hashing: host mode ships the dense wire encoding
        (half the bytes over the host->device link; the store decodes)."""
        if self._hash_on_device:
            return self._hasher.hash_batch_words(arr)
        return self._hasher.hash_batch_dense_host(arr)

    def _prepare_vector(self, vector: np.ndarray) -> np.ndarray:
        arr = np.asarray(vector, dtype=np.float32).reshape(-1)
        if arr.shape[0] != self._dim:
            raise ValueError(
                f"Vector must have dimension {self._dim}; received {arr.shape[0]}"
            )
        if np.allclose(arr, 0.0, atol=1e-8):
            raise ValueError(
                "Cannot index zero vector - norm undefined. Check embeddings for corruption."
            )
        return arr

    # -- MIPS (similarity="dot") augmentation --------------------------------
    # Stored vectors gain one coordinate sqrt(max_norm^2 - |x|^2) (constant
    # augmented norm = max_norm); queries gain a literal 0, so the cosine of
    # augmented vectors is (q . x) / (|q| * max_norm) — inner-product order
    # under every cosine-based stage (hashing, collision, Hamming,
    # asymmetric, rerank). Scores rescale back via `_score_scale`.

    def _augment_data(self, arr: np.ndarray) -> np.ndarray:
        if self._similarity != "dot":
            return arr
        m2 = self._max_norm * self._max_norm
        n2 = np.einsum("ij,ij->i", arr.astype(np.float64), arr.astype(np.float64))
        if np.any(n2 > m2 * (1.0 + 1e-5)):
            raise ValueError(
                f"vector norm exceeds max_norm={self._max_norm}: the MIPS "
                "augmentation requires every stored vector inside the "
                "declared norm bound (re-create the index with a larger "
                "max_norm)"
            )
        aug = np.sqrt(np.maximum(m2 - n2, 0.0)).astype(np.float32)
        return np.concatenate([arr, aug[:, None]], axis=1)

    def _augment_query(self, arr: np.ndarray) -> np.ndarray:
        if self._similarity != "dot":
            return arr
        return np.concatenate(
            [arr, np.zeros((arr.shape[0], 1), np.float32)], axis=1
        )

    def _score_scale(self, q_aug: np.ndarray) -> np.ndarray:
        """Per-query factor mapping augmented-cosine scores to the public
        similarity: 1 for cosine, ``|q| * max_norm`` for dot (the
        augmented query norm equals the original — its extra coordinate
        is 0)."""
        if self._similarity != "dot":
            return np.ones(q_aug.shape[0] if q_aug.ndim == 2 else 1, np.float64)
        return (
            np.linalg.norm(np.atleast_2d(q_aug), axis=1).astype(np.float64)
            * self._max_norm
        )

    def _require_vector_fetch_fn(self) -> VectorFetchFn:
        if self._vector_fetch_fn is None:
            raise RuntimeError(
                "vector_fetch_fn must be supplied for operations requiring reranking"
            )
        return self._vector_fetch_fn

    def _resolve_loader(self, format: str) -> Loader:
        normalized = format.lower()
        if normalized in {"postgres", "pg"}:
            from lshrs_tpu.io.postgres import iter_postgres_vectors

            return iter_postgres_vectors
        if normalized in {"parquet", "pq"}:
            from lshrs_tpu.io.parquet import iter_parquet_vectors

            return iter_parquet_vectors
        if normalized in {"numpy", "npy", "npz", "arrays"}:
            from lshrs_tpu.io.numpy_io import iter_numpy_vectors

            return iter_numpy_vectors
        raise ValueError(f"Unsupported signature creation format '{format}'")


# Lowercase alias, matching the reference's backwards-compatible export
# (`/root/reference/lshrs/core/main.py:1201`).
lshrs = LSHRS
