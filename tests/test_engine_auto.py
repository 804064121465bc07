"""The auto ranking engine: packed-Hamming at scale, collision parity below."""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from lshrs_tpu import LSHRS


def make(engine="auto", **kw):
    defaults = dict(
        dim=32, num_perm=32, num_bands=8, rows_per_band=4,
        backend="device", chunk_size=128, initial_capacity=128,
    )
    defaults.update(kw)
    return LSHRS(engine=engine, **defaults)


def test_auto_engine_enables_mxu_hamming(rng):
    lsh = make()
    st = lsh._storage
    # planes: the int8 bitplane (matmul) formulation, not packed;
    # costs num_perm bytes/slot — but only once Hamming ranking actually
    # engages (bitplanes materialize lazily on first Hamming use)
    assert st.enable_hamming and st.hamming_storage == "planes"
    assert st.stats()["hamming_plane_bytes"] == 0  # nothing used yet
    X = rng.standard_normal((20, 32)).astype(np.float32)
    lsh.index(list(range(20)), X)
    assert lsh.query_hamming(X[3], top_k=2)[0][0] == 3
    assert st.stats()["hamming_plane_bytes"] > 0  # materialized on use
    # appends after materialization keep the planes current
    lsh.index([50], X[:1] + 1.0)
    assert lsh.query_hamming(X[0] + 1.0, top_k=1)[0][0] == 50
    # explicit hamming config is respected, not overridden
    user = make(enable_hamming=True, hamming_storage="packed")
    assert user._storage.hamming_storage == "packed"
    # parity engine keeps the reference shape exactly
    parity = make(engine="collision")
    assert not parity._storage.enable_hamming


def test_auto_engine_ranks_by_collision_below_threshold(rng):
    lsh = make()
    assert lsh.stats()["ranking"] == "collision"
    X = rng.standard_normal((50, 32)).astype(np.float32)
    lsh.index(list(range(50)), X)
    parity = make(engine="collision")
    parity.index(list(range(50)), X)
    for qi in (0, 7, 31):
        assert lsh.get_top_k(X[qi], topk=8) == parity.get_top_k(X[qi], topk=8)


def test_auto_engine_switches_past_capacity_threshold(rng, monkeypatch):
    lsh = make()
    X = rng.standard_normal((60, 32)).astype(np.float32)
    lsh.index(list(range(60)), X)
    monkeypatch.setattr(LSHRS, "_AUTO_HAMMING_CAPACITY", 128)
    assert lsh._storage._capacity >= 128
    assert lsh.stats()["ranking"] == "hamming"
    ham = make(engine="hamming")
    ham.index(list(range(60)), X)
    q = X[5] + 0.02 * rng.standard_normal(32).astype(np.float32)
    assert lsh.get_top_k(q, topk=6) == [i for i, _ in ham.query_hamming(q, top_k=6)]
    assert lsh.query_batch(X[:4], top_k=3)[2][0] == 2
    # serving_fn default mode follows the engine
    serve = lsh.serving_fn(top_k=3)
    out = serve(X[:4])
    assert out[1, 0] == 1


def test_hamming_engine_ranks_every_bit(rng):
    """engine='hamming' must order by full-signature distance where the
    collision engine sees only all-or-nothing band ties."""
    lsh = make(engine="hamming")
    X = rng.standard_normal((40, 32)).astype(np.float32)
    lsh.index(list(range(40)), X)
    assert lsh.stats()["ranking"] == "hamming"
    got = lsh.get_top_k(X[3], topk=5)
    assert got[0] == 3
    expect = [i for i, _ in lsh.query_hamming(X[3], top_k=5)]
    assert got == expect


def test_engine_persistence_roundtrip_and_legacy_default(rng, tmp_path):
    lsh = make(engine="hamming")
    X = rng.standard_normal((30, 32)).astype(np.float32)
    lsh.index(list(range(30)), X)
    re = pickle.loads(pickle.dumps(lsh))
    assert re._engine == "hamming"
    assert re.get_top_k(X[4], topk=3) == lsh.get_top_k(X[4], topk=3)

    lsh.save_to_disk(tmp_path / "idx")
    back = LSHRS.load_from_disk(tmp_path / "idx")
    assert back._engine == "hamming"

    # configs saved before the engine knob restore as parity collision
    import json

    meta_path = tmp_path / "idx" / "metadata.json"
    meta = json.loads(meta_path.read_text())
    del meta["tpu_config"]["engine"]
    meta_path.write_text(json.dumps(meta))
    legacy = LSHRS.load_from_disk(tmp_path / "idx")
    assert legacy._engine == "collision"


def test_auto_resolution_pinned_across_checkpoint(rng, monkeypatch, tmp_path):
    """Once engine='auto' switches to Hamming ranking, the resolution is
    pinned and persisted: a save/load (or pickle) round-trip must never
    silently change result ordering, whatever capacity the restored store
    reports relative to the switch threshold."""
    lsh = make()
    X = rng.standard_normal((60, 32)).astype(np.float32)
    lsh.index(list(range(60)), X)
    monkeypatch.setattr(LSHRS, "_AUTO_HAMMING_CAPACITY", 128)
    q = X[5] + 0.02 * rng.standard_normal(32).astype(np.float32)
    before = lsh.get_top_k(q, topk=6)  # triggers + pins the switch
    assert lsh.stats()["engine_resolved"] == "hamming"
    assert "auto->hamming" in repr(lsh)
    # Restore the REAL threshold (512k): the restored store's capacity
    # (128) sits far below it — unpinned, auto would flip back to
    # collision ordering across the checkpoint boundary.
    monkeypatch.undo()
    assert lsh._storage._capacity < LSHRS._AUTO_HAMMING_CAPACITY

    lsh.save_to_disk(tmp_path / "idx")
    back = LSHRS.load_from_disk(tmp_path / "idx")
    assert back.stats()["engine_resolved"] == "hamming"
    assert back.stats()["ranking"] == "hamming"
    assert back.get_top_k(q, topk=6) == before

    re = pickle.loads(pickle.dumps(lsh))
    assert re.stats()["engine_resolved"] == "hamming"
    assert re.get_top_k(q, topk=6) == before

    # An unswitched instance persists no resolution and keeps collision
    # ordering after restore (nothing pinned prematurely).
    fresh = make()
    fresh.index(list(range(60)), X)
    assert fresh.stats()["engine_resolved"] is None
    fresh.save_to_disk(tmp_path / "fresh")
    fresh_back = LSHRS.load_from_disk(tmp_path / "fresh")
    assert fresh_back.stats()["engine_resolved"] is None
    assert fresh_back.stats()["ranking"] == "collision"


def test_engine_validation():
    with pytest.raises(ValueError, match="engine"):
        make(engine="warp")


def test_auto_switch_logged_once(rng, monkeypatch, caplog):
    import logging

    lsh = make()
    X = rng.standard_normal((30, 32)).astype(np.float32)
    lsh.index(list(range(30)), X)
    monkeypatch.setattr(LSHRS, "_AUTO_HAMMING_CAPACITY", 64)
    with caplog.at_level(logging.INFO, logger="lshrs_tpu.core.main"):
        lsh.get_top_k(X[0], topk=2)
        lsh.get_top_k(X[1], topk=2)
    msgs = [r for r in caplog.records if "switched" in r.message]
    assert len(msgs) == 1  # one-time notice


def test_pinned_hamming_storage_survives_engine_override(rng):
    """engine='auto' force-enables Hamming but must not overwrite an
    explicitly pinned hamming_storage='packed' (the caller traded QPS
    for zero extra HBM)."""
    from lshrs_tpu import LSHRS

    lsh = LSHRS(
        dim=16, num_perm=32, num_bands=4, rows_per_band=8,
        engine="auto", hamming_storage="packed",
    )
    assert lsh._storage.hamming_storage == "packed"
    assert lsh._tpu_config["hamming_storage"] == "packed"
    # unpinned still defaults to planes under the override
    lsh2 = LSHRS(
        dim=16, num_perm=32, num_bands=4, rows_per_band=8, engine="auto"
    )
    assert lsh2._storage.hamming_storage == "planes"
    with pytest.raises(ValueError, match="hamming_storage"):
        LSHRS(
            dim=16, num_perm=32, num_bands=4, rows_per_band=8,
            hamming_storage="bits",
        )


def test_stats_never_raises_for_unusable_pinned_gather(rng):
    """Introspection must not crash when rerank_engine='gather' is pinned
    on a geometry without the grouped fast path (num_bands > 64)."""
    from lshrs_tpu.storage.device import DeviceStore

    store = DeviceStore(
        num_bands=128, rows_per_band=2, dim=8, store_vectors=True,
        rerank_engine="gather", chunk_size=64, initial_capacity=128,
    )
    store.add_signature_batch(
        np.arange(4), np.zeros((4, 128), np.uint32),
        rng.standard_normal((4, 8)).astype(np.float32),
    )
    out = store.stats()
    assert "unusable" in out["rerank_engine"]


def test_snapshot_topp_batch_hint_accepted(rng):
    """batch_hint feeds the auto engine's feasibility check and the
    closure still serves correctly."""
    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    h = LSHHasher(num_bands=4, rows_per_band=8, dim=16, seed=3)
    store = DeviceStore(
        num_bands=4, rows_per_band=8, dim=16, store_vectors=True,
        chunk_size=64, initial_capacity=64,
    )
    X = rng.standard_normal((100, 16)).astype(np.float32)
    store.add_signature_batch(np.arange(100), h.hash_batch_words_host(X), X)
    serve = store.snapshot_topp_fn(5, batch_hint=4096)
    qw = h.hash_batch_words_host(X[:4])
    ids, sims, n = serve(qw, X[:4])
    assert (np.asarray(ids)[:, 0] == np.arange(4)).all()
