"""Mesh-sharded device signature store.

Scale-out design (absent from the single-process reference; see
`/root/repo/SURVEY.md` section 2's parallelism checklist): the slot axis of
the transposed signature store shards across a 1-D `jax.sharding.Mesh`,
each device scanning only its columns. A query executes SPMD under
`shard_map`:

    replicate query words  ->  shard-local fused scan + exact local top-k
                           ->  `all_gather` of (count, id) k-lists
                           ->  identical exact merge on every device

The merge key is (count desc, id asc) — the same total order the
single-device engine and the reference use — so sharded results are
bit-identical to unsharded ones regardless of which shard holds which row.
The collective payload per query batch is ``O(n_shards * k)`` ints,
independent of index size.

Appends keep the base class's tail-append logic but pin array placement
with `NamedSharding`; because the scan is capacity-wide and uniform, row
placement does not affect query latency, only memory balance.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lshrs_tpu.ops.bitpack import pack_words_narrow
from lshrs_tpu.ops.hamming import (
    hamming_topk_cascade_core,
    hamming_topk_chunked_core,
    hamming_topk_core,
    hamming_topk_packed_chunked_core,
    hamming_topk_packed_core,
    supports_hamming_grouped,
    unpack_bitplanes,
)
from lshrs_tpu.ops.scan import (
    build_grouped_refine_rows,
    collision_counts_core,
    collision_topk_core,
    collision_topk_grouped_core,
    compute_chunk_ranks,
    global_tie_core,
    merge_topk_pools,
)
from lshrs_tpu.storage.device import DeviceStore, _next_pow2

__all__ = ["ShardedDeviceStore"]


class ShardedDeviceStore(DeviceStore):
    """`DeviceStore` with slot-axis sharding and all-gather top-k merge.

    Args:
        mesh: 1-D device mesh with a power-of-two device count; its single
            axis shards the slot dimension. Everything else as
            `DeviceStore`. Capacity stays a power of two, so every shard
            holds ``capacity / n_shards`` whole chunks.
    """

    def __init__(self, *, mesh: Mesh, **kwargs) -> None:
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedDeviceStore expects a 1-D mesh")
        n = int(mesh.devices.size)
        if n & (n - 1):
            raise ValueError("ShardedDeviceStore requires a power-of-two device count")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_shards = n
        self._col_sharding = NamedSharding(mesh, P(None, mesh.axis_names[0]))
        self._row_sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
        kwargs.setdefault("initial_capacity", 1 << 14)
        kwargs["initial_capacity"] = max(
            kwargs["initial_capacity"], n * kwargs.get("chunk_size", 2048)
        )
        super().__init__(**kwargs)
        self._reshard()

    # -- placement ---------------------------------------------------------

    def _reshard(self) -> None:
        col = NamedSharding(self.mesh, P(None, self.axis))
        row = NamedSharding(self.mesh, P(self.axis))
        self._sig_t = jax.device_put(self._sig_t, col)
        self._sig_rows = jax.device_put(
            self._sig_rows, NamedSharding(self.mesh, P(self.axis, None))
        )
        self._rows_ext = {}
        self._ids = jax.device_put(self._ids, row)
        self._ranks = jax.device_put(self._ranks, row)
        if self._payload is not None:
            self._payload = jax.device_put(
                self._payload, NamedSharding(self.mesh, P(self.axis, None))
            )
            self._pnorm = jax.device_put(self._pnorm, row)
            if self._pscale is not None:
                self._pscale = jax.device_put(self._pscale, row)
        if self._planes is not None:
            self._planes = jax.device_put(
                self._planes, NamedSharding(self.mesh, P(self.axis, None))
            )
        # Tie keys must be *shard-local* (each shard's selection-key scale
        # derives from its local column count); recomputed lazily on the
        # next query rather than eagerly on every placement repair.
        self._ranks_dirty = True

    def _ensure_ranks(self) -> None:
        # Shard-local tie (the base class's global tie would be wrong here:
        # each shard's selection-key scale derives from its local columns).
        if self._ranks_dirty:
            self._ranks = compute_chunk_ranks(self._ids, chunk=self.chunk)
            self._tie = _sharded_tie(self.mesh, self.axis, self._ids)
            self._ranks_dirty = False

    def _refine_rows(self, group: int) -> jax.Array:
        # Build each shard's grouped refine table locally under shard_map
        # (the base class's reshape/transpose on a sharded global array
        # would tempt GSPMD into cross-shard data movement). Output stays
        # P(axis, None): local block g = local group g, as the shard-local
        # query cores expect.
        key = group
        cached = self._rows_ext.pop(key, None)
        if cached is None:
            self._ensure_ranks()
            cached = _sharded_refine_rows(
                self.mesh, self.axis, self._sig_rows, self._tie, self._ids,
                group=group, narrow_r=self._refine_narrow_r,
            )
        # LRU-bounded, same policy as the base class (see _MAX_REFINE_GEOMETRIES).
        self._rows_ext[key] = cached
        while len(self._rows_ext) > self._MAX_REFINE_GEOMETRIES:
            self._rows_ext.pop(next(iter(self._rows_ext)))
        return cached

    def _check_placement(self) -> None:
        """Re-place only if an update dropped the sharding (rare: GSPMD
        propagates input shardings through the donated append jits, so
        appends normally cost O(batch), not O(capacity) movement)."""
        rows_want = NamedSharding(self.mesh, P(self.axis, None))
        ok = (
            self._sig_t.sharding.is_equivalent_to(self._col_sharding, 2)
            and self._ids.sharding.is_equivalent_to(self._row_sharding, 1)
            and self._sig_rows.sharding.is_equivalent_to(rows_want, 2)
        )
        if ok and self._payload is not None:
            ok = self._payload.sharding.is_equivalent_to(rows_want, 2)
            if ok and self._pscale is not None:
                ok = self._pscale.sharding.is_equivalent_to(
                    self._row_sharding, 1
                )
        if ok and self._planes is not None:
            ok = self._planes.sharding.is_equivalent_to(rows_want, 2)
        if not ok:
            self._reshard()

    def remove_indices(self, indices) -> None:
        with self._lock:
            super().remove_indices(indices)  # marks keys stale (lazy)
            self._check_placement()

    def clear(self) -> None:
        super().clear()
        self._reshard()

    def _grow(self, new_cap: int) -> None:
        super()._grow(max(new_cap, self.n_shards * self.chunk))
        self._reshard()

    def _append(self, ids32, words, vectors) -> None:
        """SPMD tail-append: every shard scatters the (replicated) batch
        into its local slots and drops the rest — O(batch) work and zero
        cross-shard data movement, regardless of capacity."""
        n, ids_p, words_dev, rows, pscale = self._append_prep(
            ids32, words, vectors
        )
        offset = jnp.int32(self._size)
        self._sig_t, self._sig_rows, self._ids = _sharded_append(
            self.mesh, self.axis,
            self._sig_t, self._sig_rows, self._ids,
            words_dev, jnp.asarray(ids_p), offset,
        )
        if self._payload is not None:
            self._payload, self._pnorm = _sharded_append_payload(
                self.mesh, self.axis, self._payload, self._pnorm, rows, offset
            )
            if pscale is not None:
                self._pscale = _sharded_append_vec(
                    self.mesh, self.axis, self._pscale, pscale, offset
                )
        if self._planes is not None:
            # _planes_rows slices to the stored width (the cascade keeps
            # only the first ``hamming_cascade`` bitplane columns).
            self._planes = _sharded_append_rows(
                self.mesh, self.axis, self._planes,
                self._planes_rows(words_dev), offset
            )
        self._append_finish(ids32, n)
        self._check_placement()

    def _overwrite(self, slots, words_np, vectors) -> None:
        super()._overwrite(slots, words_np, vectors)
        self._check_placement()

    def rehash(
        self,
        proj_t,
        *,
        num_bands: int,
        rows_per_band: int,
        hash_family: str = "gaussian",
        block_slots: int = 1 << 17,
    ) -> None:
        """Sharded `DeviceStore.rehash`: every shard re-hashes its LOCAL
        payload block under `shard_map` — zero cross-shard data movement
        (the base class's capacity-wide dynamic slices would straddle
        shard boundaries and tempt GSPMD into gathers)."""
        with self._lock:
            if self._payload is None:
                raise RuntimeError(
                    "rehash requires store_vectors=True: signatures are "
                    "rebuilt from the resident payload"
                )
            self._set_banding(num_bands, rows_per_band)
            local_cap = self._capacity // self.n_shards
            step = min(_next_pow2(block_slots), local_cap)
            while local_cap % step:
                step //= 2
            proj_dev = (
                proj_t
                if hash_family == "structured"
                else jnp.asarray(proj_t, dtype=jnp.float32)
            )
            sig_rows = jax.device_put(
                jnp.zeros((self._capacity, self.words), dtype=jnp.uint32),
                NamedSharding(self.mesh, P(self.axis, None)),
            )
            for off in range(0, local_cap, step):
                sig_rows = _sharded_rehash_block(
                    self.mesh, self.axis, sig_rows, self._payload, proj_dev,
                    jnp.int32(off),
                    num_bands=num_bands, rows_per_band=rows_per_band,
                    hash_family=hash_family, step=step,
                )
            self._finish_rehash(sig_rows)
            self._check_placement()

    def add_vectors_batch(
        self, indices, vectors, proj_t, hash_family: str = "gaussian"
    ) -> None:
        """Sharded fused build: hash once (the query path's jitted
        program, replicated) then the SPMD scatter-append. Two dispatches
        instead of one — the base class's donated single-program form
        would fight GSPMD placement for marginal gain; hashing is ~3 ms
        per 100k vectors either way."""
        from lshrs_tpu.hash.hasher import (
            _hash_batch_words_cp_jit,
            _hash_batch_words_jit,
            _hash_batch_words_structured_jit,
        )

        hash_jit = {
            "structured": _hash_batch_words_structured_jit,
            "crosspolytope": _hash_batch_words_cp_jit,
        }.get(hash_family, _hash_batch_words_jit)
        x = jnp.asarray(vectors, dtype=jnp.float32)
        words = hash_jit(
            x,
            jnp.asarray(proj_t, dtype=jnp.float32),
            num_bands=self.num_bands,
            rows_per_band=self.rows_per_band,
        )
        self.add_signature_batch(
            indices, words, x if self.store_vectors else None
        )

    # -- sharded queries -----------------------------------------------------

    def _local_rows(self) -> int:
        return self._capacity // self.n_shards

    def _use_grouped(self) -> bool:
        from lshrs_tpu.ops.scan import supports_fast_path

        local = self._capacity // self.n_shards
        return (
            supports_fast_path(self.num_bands, local)
            and self.num_bands <= 64
            and local % self.group == 0
        )

    def _expected_candidates(self) -> float:
        # Per-shard expectation: the gather budget applies per shard.
        return super()._expected_candidates() / self.n_shards

    def _gather_usable(self) -> bool:
        return self.store_vectors and self._use_grouped()  # local geometry

    def _topp_gather_dispatch(
        self, qw, qv_dev, max_out: int, mc: int, probes: int = 1, where=None
    ):
        """Shard_map gather rerank: each shard reranks its local
        candidates exactly (shard-local tie keys are exactly what the
        gather core expects per block), then the per-shard (cosine, id)
        k-lists merge with one all-gather — the same merge-correctness argument as
        the top-k path, with cosine as the (absolute, shard-independent)
        primary key. The per-query candidate budget is ``mc`` PER SHARD."""
        self._ensure_ranks()
        ids_x, tie_x = self._filtered_ids_tie(where)
        group = min(self.group, self._local_rows())
        return _sharded_topp_gather(
            self.mesh,
            self.axis,
            self._payload,
            self._pnorm,
            ids_x,
            tie_x,
            self._sig_t,
            self._refine_rows(group) if where is None else self._sig_rows,
            qw,
            qv_dev,
            num_bands=self.num_bands,
            max_out=max_out,
            max_candidates=mc,
            group=group,
            kernel=self._scan_kernel(),
            narrow_r=self._refine_narrow_r if where is None else 0,
            probes=probes,
            use_rows=where is None,
        )

    def snapshot_topp_fn(
        self,
        max_out: int,
        *,
        wire: str = "words",
        engine: str | None = None,
        max_candidates: int | None = None,
        probes: int = 1,
        batch_hint: int = 1024,
        where=None,
    ):
        """Sharded rerank serving closure. The full engine inherits the
        GSPMD program; the gather engine compiles the shard_map gather
        (`_topp_gather_dispatch`) behind the same staleness contract."""
        eng, mc = self._resolve_rerank_engine(
            engine, max_candidates, q=batch_hint
        )
        if eng != "gather":
            return super().snapshot_topp_fn(
                max_out, wire=wire, engine="full", max_candidates=mc,
                probes=probes, batch_hint=batch_hint, where=where,
            )
        if wire not in ("words", "dense"):
            raise ValueError("wire must be 'words' or 'dense'")
        if probes < 1:
            raise ValueError("probes must be >= 1")
        from lshrs_tpu.ops.bitpack import dense_to_words as _d2w

        with self._lock:
            if self._size == 0:
                raise RuntimeError("snapshot_topp_fn requires a non-empty store")
            self._ensure_ranks()
            local = self._local_rows()
            group = min(self.group, local)
            kernel = self._scan_kernel()
            out = max(1, min(max_out, local))
            num_bands, rows_per_band = self.num_bands, self.rows_per_band
            mesh, axis = self.mesh, self.axis
            use_rows = where is None
            narrow_r = self._refine_narrow_r if use_rows else 0
            ids_x, tie_x = self._filtered_ids_tie(where)
            state = (
                self._payload, self._pnorm, ids_x, tie_x,
                self._sig_t,
                self._refine_rows(group) if use_rows else self._sig_rows,
            )
            snapshot_gen = self._generation

        @jax.jit
        def _serve(q, qv, st):
            if wire == "dense":
                if probes > 1:  # (Q, T, DB) -> decode per probe
                    nq = q.shape[0]
                    q = _d2w(
                        q.reshape(nq * probes, -1),
                        num_bands=num_bands,
                        rows_per_band=rows_per_band,
                    ).reshape(nq, -1)
                else:
                    q = _d2w(
                        q, num_bands=num_bands, rows_per_band=rows_per_band
                    )
            else:
                q = q.astype(jnp.uint32)
                if probes > 1:  # accept (Q, T, BW) or flat probe-major
                    q = q.reshape(q.shape[0], -1)
            ids_o, sims, n, _exact = _sharded_topp_gather(
                mesh, axis, *st, q, qv,
                num_bands=num_bands, max_out=out, max_candidates=mc,
                group=group, kernel=kernel,
                narrow_r=narrow_r, probes=probes, use_rows=use_rows,
            )
            return ids_o, sims, n

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

    def _query_topk_dev(
        self, qw: jax.Array, k: int, probes: int = 1, where=None
    ):
        self._ensure_ranks()
        ids_x, tie_x = self._filtered_ids_tie(where)
        k_eff = max(1, min(k, self._local_rows()))
        group = min(self.group, self._local_rows())
        return _sharded_topk(
            self.mesh,
            self.axis,
            self._sig_t,
            self._refine_rows(group)
            if self._use_grouped() and where is None
            else self._sig_rows,
            ids_x,
            self._ranks,
            tie_x,
            qw,
            num_bands=self.num_bands,
            k=k_eff,
            chunk=min(self.chunk, self._local_rows()),
            grouped=self._use_grouped(),
            group=group,
            kernel=self._scan_kernel(),
            narrow_r=self._refine_narrow_r if where is None else 0,
            probes=probes,
            use_rows=where is None,
        )

    def _materialize_planes(self) -> jax.Array:
        # Shard-local unpack: each shard builds its block's bitplanes from
        # its packed rows (the base class's sliced loop would fight GSPMD
        # placement). One dispatch; the intermediate spreads over shards.
        return _sharded_unpack_planes(
            self.mesh,
            self.axis,
            self._sig_rows,
            num_bands=self.num_bands,
            rows_per_band=self.rows_per_band,
            plane_bits=self._plane_bits(),
        )

    def _query_hamming_dev(self, qw: jax.Array, k: int, where=None):
        self._ensure_ranks()
        self._ensure_planes()  # lazily built on first Hamming use
        ids_x, tie_x = self._filtered_ids_tie(where)
        p = self.num_bands * self.rows_per_band
        local = self._local_rows()
        k_eff = max(1, min(k, local))
        ham_grouped = (
            supports_hamming_grouped(p, local) and local % self.group == 0
        )
        group = min(self.group, local)
        chunk = min(self.chunk, local)
        ham_use_rows = ham_grouped and where is None
        ham_rows = self._refine_rows(group) if ham_use_rows else self._sig_rows
        if self.hamming_cascade:
            cb = self.hamming_cascade
            cas_grouped = local % group == 0
            qbits = unpack_bitplanes(
                qw, num_bands=self.num_bands, rows_per_band=self.rows_per_band
            )[:, :cb]
            cas_use_rows = cas_grouped and where is None
            return _sharded_hamming_cascade(
                self.mesh,
                self.axis,
                self._planes,
                self._sig_t,
                self._refine_rows(group) if cas_use_rows else self._sig_rows,
                ids_x,
                self._ranks,
                tie_x,
                qbits,
                qw,
                num_perm=p,
                k=k_eff,
                refine_groups=max(
                    k_eff, -(-self.hamming_cascade_refine // group)
                ),
                chunk=chunk,
                grouped=cas_grouped,
                group=group,
                kernel=self._scan_kernel(self._plane_bits()),
                narrow_r=self._refine_narrow_r if cas_use_rows else 0,
                use_rows=cas_use_rows,
            )
        if self.hamming_storage == "packed":
            return _sharded_hamming_packed(
                self.mesh,
                self.axis,
                self._sig_t,
                ham_rows,
                ids_x,
                self._ranks,
                tie_x,
                qw,
                num_perm=p,
                k=k_eff,
                chunk=chunk,
                grouped=ham_grouped,
                group=group,
                narrow_r=self._refine_narrow_r if ham_use_rows else 0,
                use_rows=ham_use_rows,
            )
        qbits = unpack_bitplanes(
            qw, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )
        return _sharded_hamming(
            self.mesh,
            self.axis,
            self._planes,
            self._sig_t,
            ham_rows,
            ids_x,
            self._ranks,
            tie_x,
            qbits,
            qw,
            num_perm=p,
            k=k_eff,
            chunk=chunk,
            grouped=ham_grouped,
            group=group,
            kernel=self._scan_kernel(self._plane_bits()),
            narrow_r=self._refine_narrow_r if ham_use_rows else 0,
            use_rows=ham_use_rows,
        )

    def _query_asymmetric_dev(self, qc: jax.Array, k: int, where=None):
        """Shard-local asymmetric ranking + exact (dots, id) all-gather merge."""
        from lshrs_tpu.ops.asymmetric import asymmetric_shift

        self._ensure_ranks()
        self._ensure_planes()
        ids_x, tie_x = self._filtered_ids_tie(where)
        if self._planes is None:
            raise RuntimeError(
                'asymmetric ranking requires hamming_storage="planes": the '
                "query's quantised coordinates rank against int8 bitplanes "
                "(the packed-words variant has no bitplane "
                "operand)"
            )
        p = self.num_bands * self.rows_per_band
        local = self._local_rows()
        k_eff = max(1, min(k, local))
        group = min(self.group, local)
        grouped = local % group == 0
        chunk = min(self.chunk, local)
        asym_use_rows = grouped and p <= 2048 and where is None
        return _sharded_asymmetric(
            self.mesh,
            self.axis,
            self._planes,
            self._refine_rows(group) if asym_use_rows else self._sig_rows,
            ids_x,
            self._ranks,
            tie_x,
            qc,
            num_perm=p,
            num_bands=self.num_bands,
            k=k_eff,
            chunk=chunk,
            grouped=grouped,
            group=group,
            shift=asymmetric_shift(p, local),
            kernel=self._scan_kernel(p),
            narrow_r=self._refine_narrow_r if asym_use_rows else 0,
            use_rows=asym_use_rows,
        )

    def query_nnz(self, qwords, *, where=None) -> np.ndarray:
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return np.zeros((qw.shape[0],), np.int32)
            ids_x, _ = self._filtered_ids_tie(where)
            n = _sharded_nnz(
                self.mesh,
                self.axis,
                self._sig_t,
                ids_x,
                qw,
                num_bands=self.num_bands,
                chunk=min(self.chunk, self._local_rows()),
                probes=probes,
            )
        return np.asarray(n)

    def query_counts(self, qwords, *, where=None) -> tuple[np.ndarray, np.ndarray]:
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return (
                    np.zeros((qw.shape[0], self._capacity), np.int32),
                    np.full((self._capacity,), -1, np.int32),
                )
            ids_x, _ = self._filtered_ids_tie(where)
            counts = _sharded_counts(
                self.mesh,
                self.axis,
                self._sig_t,
                ids_x,
                qw,
                num_bands=self.num_bands,
                chunk=min(self.chunk, self._local_rows()),
                probes=probes,
            )
            ids = ids_x
        return np.asarray(counts), np.asarray(ids)

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
        """Compiled single-dispatch serving closure over the sharded store.

        Same contract as `DeviceStore.snapshot_query_fn` but the captured
        program runs the shard_map SPMD query (shard-local scan + all-gather
        merge) — the base class's single-device program would misorder
        results across shards (shard-local tie keys are only distinct
        within a shard).
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
            unpack_coords_int4,
        )
        from lshrs_tpu.ops.bitpack import dense_to_words as _d2w

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
            snapshot_gen = self._generation
            num_bands, rows_per_band = self.num_bands, self.rows_per_band
            num_perm = num_bands * rows_per_band
            mesh, axis = self.mesh, self.axis
            local = self._local_rows()
            k_eff = max(1, min(k, local))
            chunk = min(self.chunk, local)
            group = min(self.group, local)
            grouped = self._use_grouped()
            ham_grouped = (
                supports_hamming_grouped(num_perm, local) and local % group == 0
            )
            packed = self.hamming_storage == "packed"
            kernel = self._scan_kernel()
            ham_kernel = self._scan_kernel(self._plane_bits())
            cascade = self.hamming_cascade if mode == "hamming" else 0
            # Cascade coarse keys pack at any capacity (tie-shift in the
            # core), so grouping needs only shard-local divisibility.
            cas_grouped = bool(cascade) and local % group == 0
            cas_groups = (
                max(k_eff, -(-self.hamming_cascade_refine // group))
                if cascade
                else 0
            )
            # Grouped refine table of the served mode (asymmetric
            # reconstructs exact dots from the same word-row table).
            asym_grouped = local % group == 0
            # Prebuilt refine tables bake the UNfiltered tie/id columns:
            # a filtered snapshot drops them (per-slot gather fallback).
            if where is not None:
                rows = self._sig_rows
            elif mode == "hamming":
                rows = (
                    self._refine_rows(group)
                    if (cas_grouped if cascade else ham_grouped)
                    else self._sig_rows
                )
            elif mode == "asymmetric":
                rows = (
                    self._refine_rows(group)
                    if asym_grouped and num_perm <= 2048
                    else self._sig_rows
                )
            else:
                rows = self._refine_rows(group) if grouped else self._sig_rows
            asym_shift = asymmetric_shift(num_perm, local, qmax=asym_qmax)
            ids_x, tie_x = self._filtered_ids_tie(where)
            state = (
                self._sig_t, rows, ids_x, self._ranks, tie_x, self._planes
            )
            mode_grouped = {
                "hamming": cas_grouped if cascade else ham_grouped,
                "asymmetric": asym_grouped,
            }.get(mode, grouped)
            use_rows = mode_grouped and where is None
            narrow_r = self._refine_narrow_r if use_rows else 0

        def run_slice(qw, st):
            sig_t, rows_, ids, ranks, tie, planes = st
            if mode == "asymmetric":
                return _sharded_asymmetric(
                    mesh, axis, planes, rows_, ids, ranks, tie, qw,
                    num_perm=num_perm, num_bands=num_bands, k=k_eff,
                    chunk=chunk, grouped=asym_grouped, group=group,
                    shift=asym_shift, kernel=ham_kernel, qmax=asym_qmax,
                    narrow_r=narrow_r, use_rows=use_rows,
                )[1]
            if mode == "hamming":
                if cascade:
                    qbits = unpack_bitplanes(
                        qw, num_bands=num_bands, rows_per_band=rows_per_band
                    )[:, :cascade]
                    return _sharded_hamming_cascade(
                        mesh, axis, planes, sig_t, rows_, ids, ranks, tie,
                        qbits, qw,
                        num_perm=num_perm, k=k_eff,
                        refine_groups=cas_groups, chunk=chunk,
                        grouped=cas_grouped, group=group, kernel=ham_kernel,
                        narrow_r=narrow_r, use_rows=use_rows,
                    )[1]
                if packed:
                    return _sharded_hamming_packed(
                        mesh, axis, sig_t, rows_, ids, ranks, tie, qw,
                        num_perm=num_perm, k=k_eff, chunk=chunk,
                        grouped=ham_grouped, group=group,
                        narrow_r=narrow_r, use_rows=use_rows,
                    )[1]
                qbits = unpack_bitplanes(
                    qw, num_bands=num_bands, rows_per_band=rows_per_band
                )
                return _sharded_hamming(
                    mesh, axis, planes, sig_t, rows_, ids, ranks, tie, qbits, qw,
                    num_perm=num_perm, k=k_eff, chunk=chunk,
                    grouped=ham_grouped, group=group, kernel=ham_kernel,
                    narrow_r=narrow_r, use_rows=use_rows,
                )[1]
            return _sharded_topk(
                mesh, axis, sig_t, rows_, ids, ranks, tie, qw,
                num_bands=num_bands, k=k_eff, chunk=chunk,
                grouped=grouped, group=group, kernel=kernel,
                narrow_r=narrow_r, probes=probes, use_rows=use_rows,
            )[1]

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
                    q = _d2w(
                        q.reshape(nq * probes, -1),
                        num_bands=num_bands,
                        rows_per_band=rows_per_band,
                    ).reshape(nq, -1)
                else:
                    q = _d2w(
                        q, num_bands=num_bands, rows_per_band=rows_per_band
                    )
            else:
                q = q.astype(jnp.uint32)
                if probes > 1:  # accept (Q, T, BW) or flat probe-major
                    q = q.reshape(q.shape[0], -1)
            n = q.shape[0]
            if dev_batch is None or n <= dev_batch:
                return run_slice(q, st)
            outs = [
                run_slice(jax.lax.slice_in_dim(q, i, min(i + dev_batch, n)), st)
                for i in range(0, n, dev_batch)
            ]
            return jnp.concatenate(outs)

        def serve(q):
            with self._lock:
                if self._generation != snapshot_gen:
                    raise RuntimeError(
                        "snapshot_query_fn is stale: the store was mutated "
                        "after the snapshot was taken; call snapshot_query_fn "
                        "again"
                    )
                return _serve(q, state)

        return serve

    def stats(self) -> dict:
        out = super().stats()
        out["backend"] = "device-sharded"
        out["n_shards"] = self.n_shards
        out["rows_per_shard"] = self._local_rows()
        return out


# ---------------------------------------------------------------------------
# SPMD kernels
# ---------------------------------------------------------------------------


def _local_scatter_pos(axis, offset, n, local_len):
    """Per-shard local slot positions for a tail-append of ``n`` rows at
    global ``offset``; out-of-shard rows map to ``local_len`` (dropped)."""
    i = jax.lax.axis_index(axis)
    pos = offset + jnp.arange(n, dtype=jnp.int32) - i * local_len
    ok = (pos >= 0) & (pos < local_len)
    return jnp.where(ok, pos, local_len)


@partial(jax.jit, static_argnames=("mesh", "axis"), donate_argnums=(2, 3, 4))
def _sharded_append(mesh, axis, sig_t, rows, ids, new_words, new_ids, offset):
    n = new_ids.shape[0]

    def local(sig_l, rows_l, ids_l, w, nid, off):
        pos = _local_scatter_pos(axis, off, n, ids_l.shape[0])
        sig_l = sig_l.at[:, pos].set(w.T, mode="drop")
        rows_l = rows_l.at[pos].set(w, mode="drop")
        ids_l = ids_l.at[pos].set(nid, mode="drop")
        return sig_l, rows_l, ids_l

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis, None), P(axis), P(), P(), P()),
        out_specs=(P(None, axis), P(axis, None), P(axis)),
        check_vma=False,
    )(sig_t, rows, ids, new_words, new_ids, offset)


@partial(jax.jit, static_argnames=("mesh", "axis"), donate_argnums=(2, 3))
def _sharded_append_payload(mesh, axis, payload, pnorm, new_rows, offset):
    n = new_rows.shape[0]

    def local(p_l, n_l, rows, off):
        pos = _local_scatter_pos(axis, off, n, n_l.shape[0])
        p_l = p_l.at[pos].set(rows, mode="drop")
        norms = jnp.linalg.norm(rows.astype(jnp.float32), axis=1)
        n_l = n_l.at[pos].set(norms, mode="drop")
        return p_l, n_l

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(), P()),
        out_specs=(P(axis, None), P(axis)),
        check_vma=False,
    )(payload, pnorm, new_rows, offset)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "num_bands", "rows_per_band", "hash_family", "step",
    ),
    donate_argnums=(2,),
)
def _sharded_rehash_block(
    mesh, axis, sig_rows, payload, proj_t, offset,
    *, num_bands, rows_per_band, hash_family, step,
):
    from lshrs_tpu.storage.device import _hash_words_fused

    def local(s_l, p_l, proj, off):
        x = jax.lax.dynamic_slice(
            p_l, (off, 0), (step, p_l.shape[1])
        ).astype(jnp.float32)
        w = _hash_words_fused(
            x, proj, num_bands=num_bands, rows_per_band=rows_per_band,
            hash_family=hash_family,
        )
        return jax.lax.dynamic_update_slice(s_l, w, (off, 0))

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(), P()),
        out_specs=P(axis, None),
        check_vma=False,
    )(sig_rows, payload, proj_t, offset)


@partial(jax.jit, static_argnames=("mesh", "axis"), donate_argnums=(2,))
def _sharded_append_vec(mesh, axis, vec, new_vals, offset):
    n = new_vals.shape[0]

    def local(v_l, vals, off):
        pos = _local_scatter_pos(axis, off, n, v_l.shape[0])
        return v_l.at[pos].set(vals, mode="drop")

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )(vec, new_vals, offset)


@partial(jax.jit, static_argnames=("mesh", "axis"), donate_argnums=(2,))
def _sharded_append_rows(mesh, axis, arr, new_rows, offset):
    n = new_rows.shape[0]

    def local(a_l, rows, off):
        pos = _local_scatter_pos(axis, off, n, a_l.shape[0])
        return a_l.at[pos].set(rows, mode="drop")

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P()),
        out_specs=P(axis, None),
        check_vma=False,
    )(arr, new_rows, offset)


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "group", "narrow_r"),
)
def _sharded_refine_rows(mesh, axis, sig_rows, tie, ids, *, group, narrow_r=0):
    def local(rows_l, tie_l, ids_l):
        if narrow_r:
            rows_l = pack_words_narrow(
                rows_l,
                num_bands=rows_l.shape[1],  # words-per-band == 1 when narrow
                rows_per_band=narrow_r,
            )
        ext = jnp.concatenate(
            [
                rows_l,
                jax.lax.bitcast_convert_type(tie_l, jnp.uint32)[:, None],
                jax.lax.bitcast_convert_type(ids_l, jnp.uint32)[:, None],
            ],
            axis=1,
        )
        return build_grouped_refine_rows(ext, group=group)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=P(axis, None),
        check_vma=False,
    )(sig_rows, tie, ids)


@partial(jax.jit, static_argnames=("mesh", "axis"))
def _sharded_tie(mesh, axis, ids):
    return jax.shard_map(
        global_tie_core,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=P(axis),
        check_vma=False,
    )(ids)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "num_bands", "k", "chunk",
        "grouped", "group", "kernel", "narrow_r", "probes", "use_rows",
    ),
)
def _sharded_topk(
    mesh, axis, sig_t, rows, ids, ranks, tie, qwords,
    *, num_bands, k, chunk, grouped, group, kernel=None,
    narrow_r=0, probes=1, use_rows=True,
):
    def local(sig_l, rows_l, ids_l, ranks_l, tie_l, qw):
        if grouped:
            counts, out_ids = collision_topk_grouped_core(
                sig_l, ids_l, tie_l, qw,
                num_bands=num_bands, k=k, group=group, kernel=kernel,
                sig_rows=rows_l if use_rows else None,
                narrow_r=narrow_r, probes=probes,
            )
        else:
            counts, out_ids = collision_topk_core(
                sig_l, ids_l, ranks_l, qw,
                num_bands=num_bands, k=k, chunk=chunk, probes=probes,
            )
        # (n_shards, Q, k) on every device after one all-gather.
        counts_g = jax.lax.all_gather(counts, axis)
        ids_g = jax.lax.all_gather(out_ids, axis)
        q = qw.shape[0]
        pool_counts = jnp.moveaxis(counts_g, 0, 1).reshape(q, -1)
        pool_ids = jnp.moveaxis(ids_g, 0, 1).reshape(q, -1)
        return merge_topk_pools(pool_counts, pool_ids, k=k)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis, None), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(sig_t, rows, ids, ranks, tie, qwords)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "num_perm", "num_bands", "k", "chunk", "grouped",
        "group", "shift", "kernel", "qmax", "narrow_r", "use_rows",
    ),
)
def _sharded_asymmetric(
    mesh, axis, planes, rows, ids, ranks, tie, qcoords,
    *, num_perm, num_bands, k, chunk, grouped, group, shift,
    kernel=None, qmax=None, narrow_r=0, use_rows=True,
):
    """Shard-local asymmetric top-k + exact all-gather merge.

    The asymmetric dot is an absolute key (the same query scores every
    shard), so merging per-shard (dots desc, id asc) prefixes over one
    all_gather is exact — the same argument as the cosine gather-rerank
    merge. Shard-local tie keys are exactly what the core expects.
    ``qmax`` must match the wire's quantisation range (`shift` is sized
    from it); None = the full int8 range. ``rows`` is each shard's
    grouped word-major refine table (word-row refine, see
    `lshrs_tpu.ops.asymmetric.refine_dots_from_words`); pass the
    per-slot ``sig_rows`` when ``grouped`` is False (unused there).
    """
    from lshrs_tpu.ops.asymmetric import (
        QMAX,
        asymmetric_topk_chunked_core,
        asymmetric_topk_core,
    )

    if qmax is None:
        qmax = QMAX
    offset = num_perm * qmax

    def local(planes_l, rows_l, ids_l, ranks_l, tie_l, qc):
        if grouped:
            dots, out_ids = asymmetric_topk_core(
                planes_l, ids_l, tie_l, qc,
                k=k, chunk=chunk, group=group, shift=shift, qmax=qmax,
                kernel=kernel, sig_rows=rows_l if use_rows else None,
                narrow_r=narrow_r, num_bands=num_bands,
            )
        else:
            dots, out_ids = asymmetric_topk_chunked_core(
                planes_l, ids_l, ranks_l, qc, k=k, chunk=chunk, qmax=qmax
            )
        # merge by (dots desc, id asc): shift to the non-negative scaled
        # domain merge_topk_pools expects (0 marks empty entries)
        scaled = jnp.where(out_ids >= 0, dots + offset + 1, 0)
        scaled_g = jax.lax.all_gather(scaled, axis)
        ids_g = jax.lax.all_gather(out_ids, axis)
        q = qc.shape[0]
        pool_scaled = jnp.moveaxis(scaled_g, 0, 1).reshape(q, -1)
        pool_ids = jnp.moveaxis(ids_g, 0, 1).reshape(q, -1)
        m_scaled, m_ids = merge_topk_pools(pool_scaled, pool_ids, k=k)
        return (
            jnp.where(m_ids >= 0, m_scaled - offset - 1, -(offset + 1)),
            m_ids,
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None), P(axis), P(axis), P(axis), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )(planes, rows, ids, ranks, tie, qcoords)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "num_perm", "k", "chunk", "grouped", "group",
        "kernel", "narrow_r", "use_rows",
    ),
)
def _sharded_hamming(
    mesh, axis, planes, sig_t, rows, ids, ranks, tie, qbits, qwords,
    *, num_perm, k, chunk, grouped, group, kernel=None, narrow_r=0,
    use_rows=True,
):
    def local(planes_l, sig_l, rows_l, ids_l, ranks_l, tie_l, qb, qw):
        if grouped:
            hamming, out_ids = hamming_topk_core(
                planes_l, sig_l, ids_l, tie_l, qb, qw,
                k=k, chunk=chunk, group=group, kernel=kernel,
                sig_rows=rows_l if use_rows else None, narrow_r=narrow_r,
            )
        else:
            hamming, out_ids = hamming_topk_chunked_core(
                planes_l, ids_l, ranks_l, qb, k=k, chunk=chunk
            )
        # merge by (similarity desc, id asc): similarity = P + 1 - hamming
        scaled = jnp.where(out_ids >= 0, num_perm + 1 - hamming, 0)
        scaled_g = jax.lax.all_gather(scaled, axis)
        ids_g = jax.lax.all_gather(out_ids, axis)
        q = qb.shape[0]
        pool_scaled = jnp.moveaxis(scaled_g, 0, 1).reshape(q, -1)
        pool_ids = jnp.moveaxis(ids_g, 0, 1).reshape(q, -1)
        m_scaled, m_ids = merge_topk_pools(pool_scaled, pool_ids, k=k)
        return jnp.where(m_ids >= 0, num_perm + 1 - m_scaled, num_perm + 1), m_ids

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(None, axis), P(axis, None),
            P(axis), P(axis), P(axis), P(), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )(planes, sig_t, rows, ids, ranks, tie, qbits, qwords)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "num_perm", "k", "refine_groups", "chunk", "grouped",
        "group", "kernel", "narrow_r", "use_rows",
    ),
)
def _sharded_hamming_cascade(
    mesh, axis, planes_prefix, sig_t, rows, ids, ranks, tie, qbits_prefix,
    qwords, *, num_perm, k, refine_groups, chunk, grouped, group,
    kernel=None, narrow_r=0, use_rows=True,
):
    """SPMD refinement cascade: shard-local coarse prefix scan +
    shard-local full-width refine, then the exact-key all-gather merge.

    Each shard runs `hamming_topk_cascade_core` on its local block —
    coarse selection over its ``planes_prefix`` columns, full
    ``num_perm``-bit popcount refine of its own top ``refine_groups``
    groups (the per-query refine pool applies PER SHARD, so the union
    pool is ``n_shards`` x deeper than the unsharded store's at equal
    settings). The refined (hamming, id) keys are absolute — full-width
    distances, global ids — so the standard merge by (similarity desc,
    id asc) is exact within the union pool, the same argument as
    `_sharded_hamming`. Shards whose local geometry can't group fall
    back to the exact packed-words scan (same as the base class)."""

    def local(planes_l, sig_l, rows_l, ids_l, ranks_l, tie_l, qb, qw):
        if grouped:
            hamming, out_ids = hamming_topk_cascade_core(
                planes_l, sig_l, ids_l, tie_l, qb, qw,
                num_perm=num_perm, k=k, refine_groups=refine_groups,
                chunk=chunk, group=group, kernel=kernel,
                sig_rows=rows_l if use_rows else None, narrow_r=narrow_r,
            )
        else:
            hamming, out_ids = hamming_topk_packed_chunked_core(
                sig_l, ids_l, ranks_l, qw, num_perm=num_perm, k=k, chunk=chunk
            )
        scaled = jnp.where(out_ids >= 0, num_perm + 1 - hamming, 0)
        scaled_g = jax.lax.all_gather(scaled, axis)
        ids_g = jax.lax.all_gather(out_ids, axis)
        q = qw.shape[0]
        pool_scaled = jnp.moveaxis(scaled_g, 0, 1).reshape(q, -1)
        pool_ids = jnp.moveaxis(ids_g, 0, 1).reshape(q, -1)
        m_scaled, m_ids = merge_topk_pools(pool_scaled, pool_ids, k=k)
        return jnp.where(m_ids >= 0, num_perm + 1 - m_scaled, num_perm + 1), m_ids

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(None, axis), P(axis, None),
            P(axis), P(axis), P(axis), P(), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )(planes_prefix, sig_t, rows, ids, ranks, tie, qbits_prefix, qwords)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "num_perm", "k", "chunk", "grouped", "group",
        "narrow_r", "use_rows",
    ),
)
def _sharded_hamming_packed(
    mesh, axis, sig_t, rows, ids, ranks, tie, qwords,
    *, num_perm, k, chunk, grouped, group, narrow_r=0, use_rows=True,
):
    def local(sig_l, rows_l, ids_l, ranks_l, tie_l, qw):
        if grouped:
            hamming, out_ids = hamming_topk_packed_core(
                sig_l, ids_l, tie_l, qw,
                num_perm=num_perm, k=k, chunk=chunk, group=group,
                sig_rows=rows_l if use_rows else None, narrow_r=narrow_r,
            )
        else:
            hamming, out_ids = hamming_topk_packed_chunked_core(
                sig_l, ids_l, ranks_l, qw, num_perm=num_perm, k=k, chunk=chunk
            )
        scaled = jnp.where(out_ids >= 0, num_perm + 1 - hamming, 0)
        scaled_g = jax.lax.all_gather(scaled, axis)
        ids_g = jax.lax.all_gather(out_ids, axis)
        q = qw.shape[0]
        pool_scaled = jnp.moveaxis(scaled_g, 0, 1).reshape(q, -1)
        pool_ids = jnp.moveaxis(ids_g, 0, 1).reshape(q, -1)
        m_scaled, m_ids = merge_topk_pools(pool_scaled, pool_ids, k=k)
        return jnp.where(m_ids >= 0, num_perm + 1 - m_scaled, num_perm + 1), m_ids

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, axis), P(axis, None), P(axis), P(axis), P(axis), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )(sig_t, rows, ids, ranks, tie, qwords)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "num_bands", "max_out", "max_candidates",
        "group", "kernel", "narrow_r", "probes", "use_rows",
    ),
)
def _sharded_topp_gather(
    mesh, axis, payload, pnorm, ids, tie, sig_t, rows, qwords, qvecs,
    *, num_bands, max_out, max_candidates, group, kernel=None,
    narrow_r=0, probes=1, use_rows=True,
):
    """SPMD candidate-gather rerank: shard-local gather rerank + cosine merge.

    Each shard runs `rerank_topp_gather_core` on its local block (the
    shard-local tie keys are exactly the per-block keys the core expects;
    the per-query candidate budget applies PER SHARD), then the
    ``(cosine, id)`` prefix lists merge over one ``all_gather`` —
    exact, because cosine is an absolute key: the global top-``max_out``
    by (cosine desc, id asc) is contained in the union of per-shard
    top-``max_out`` lists. ``n`` is the psum of shard-local candidate
    counts; ``exact`` ANDs the shard flags.
    """
    from lshrs_tpu.ops.rerank import rerank_topp_gather_core

    _INT32_MAX = jnp.int32(2**31 - 1)

    def local(payload_l, pnorm_l, ids_l, tie_l, sig_l, rows_l, qw, qv):
        out_ids, sims, n_l, exact_l = rerank_topp_gather_core(
            payload_l, pnorm_l, ids_l, tie_l, sig_l, qw, qv,
            num_bands=num_bands, max_out=max_out,
            max_candidates=max_candidates, group=group, kernel=kernel,
            sig_rows=rows_l if use_rows else None,
            narrow_r=narrow_r, probes=probes,
        )
        ids_g = jax.lax.all_gather(out_ids, axis)  # (S, Q, max_out)
        sims_g = jax.lax.all_gather(sims, axis)
        q = qw.shape[0]
        pool_ids = jnp.moveaxis(ids_g, 0, 1).reshape(q, -1)
        pool_sims = jnp.moveaxis(sims_g, 0, 1).reshape(q, -1)
        valid = pool_ids >= 0
        neg = jnp.where(valid, -pool_sims, jnp.inf)
        tie_id = jnp.where(valid, pool_ids, _INT32_MAX)
        _, _, s_sims, s_ids = jax.lax.sort(
            (neg, tie_id, pool_sims, pool_ids), num_keys=2
        )
        nv = valid.sum(axis=1)
        out = min(max_out, s_ids.shape[1])
        m_ids = jnp.where(
            jnp.arange(out)[None, :] < nv[:, None], s_ids[:, :out], -1
        )
        n = jax.lax.psum(n_l, axis)
        exact = jax.lax.pmin(exact_l.astype(jnp.int32), axis) > 0
        return m_ids, s_sims[:, :out], n, exact

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis), P(axis), P(axis), P(None, axis),
            P(axis, None), P(), P(),
        ),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )(payload, pnorm, ids, tie, sig_t, rows, qwords, qvecs)


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "num_bands", "rows_per_band", "plane_bits"),
)
def _sharded_unpack_planes(
    mesh, axis, sig_rows, *, num_bands, rows_per_band, plane_bits=0
):
    def local(rows_l):
        planes = unpack_bitplanes(
            rows_l, num_bands=num_bands, rows_per_band=rows_per_band
        )
        if plane_bits and plane_bits != planes.shape[1]:
            planes = planes[:, :plane_bits]  # cascade prefix columns only
        return planes

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=P(axis, None),
        check_vma=False,
    )(sig_rows)


@partial(
    jax.jit, static_argnames=("mesh", "axis", "num_bands", "chunk", "probes")
)
def _sharded_nnz(mesh, axis, sig_t, ids, qwords, *, num_bands, chunk, probes=1):
    from lshrs_tpu.ops.scan import collision_nnz_core

    def local(sig_l, ids_l, qw):
        n_l = collision_nnz_core(
            sig_l, ids_l, qw, num_bands=num_bands, chunk=chunk, probes=probes
        )
        return jax.lax.psum(n_l, axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis), P()),
        out_specs=P(),
        check_vma=False,
    )(sig_t, ids, qwords)


@partial(
    jax.jit, static_argnames=("mesh", "axis", "num_bands", "chunk", "probes")
)
def _sharded_counts(mesh, axis, sig_t, ids, qwords, *, num_bands, chunk, probes=1):
    def local(sig_l, ids_l, qw):
        return collision_counts_core(
            sig_l, ids_l, qw, num_bands=num_bands, chunk=chunk, probes=probes
        )

    # Counts come back sharded along the slot axis (global layout preserved).
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis), P()),
        out_specs=P(None, axis),
        check_vma=False,
    )(sig_t, ids, qwords)
