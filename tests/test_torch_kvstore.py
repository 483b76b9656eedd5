"""Port parity: the tiered KV store and the KVPG frame format.

The port's ``kvstore.py`` must write the JAX package's frames byte for byte
(bf16 leaves carried as raw bits without ``ml_dtypes``, int8 pools as
``{"q", "s"}`` dicts), read the JAX package's frames and page files, and
keep the store's budgets, eviction order and degraded outcomes.  The same
numpy blobs, made from a seed, go through both packages."""

import os

import ml_dtypes
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import kvstore as JK
from kubeflow_tpu.serving.engine.faults import StorageFaultConfig as JStorageFaultConfig
from kubeflow_tpu.serving.errors import RequestError as JRequestError
from kubeflow_tpu_torch.serving.engine import kvstore as TK
from kubeflow_tpu_torch.serving.engine.faults import StorageFaultConfig
from kubeflow_tpu_torch.serving.errors import RequestError

# a small pool slab: [layers, pages, kv heads, page size, head dim]
SLAB = (2, 3, 2, 8, 16)


def _bf16_blob(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(SLAB).astype(ml_dtypes.bfloat16) for _ in range(2))


def _int8_blob(seed=0):
    rng = np.random.default_rng(seed)

    def part():
        return {"q": rng.integers(-127, 128, SLAB).astype(np.int8),
                "s": rng.random(SLAB[:-1] + (1,)).astype(ml_dtypes.bfloat16)}
    return part(), part()


def _as_port(blob):
    """The port's form of a blob: bf16 leaves as BF16Bits (raw bits)."""
    def leaf(a):
        return TK.bf16_bits(a) if a.dtype == ml_dtypes.bfloat16 else a
    return tuple({k: leaf(v) for k, v in p.items()} if isinstance(p, dict) else leaf(p)
                 for p in blob)


def _bits(a):
    """A leaf's raw bytes as a comparable array (bf16 of either kind)."""
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_same_blob(got, want):
    assert type(got) is type(want) and len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].shape == w[k].shape
                np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]))
        else:
            assert g.shape == w.shape
            np.testing.assert_array_equal(_bits(g), _bits(w))


BLOBS = {"bf16": _bf16_blob, "int8": _int8_blob}
META = {"hashes": [3, 1 << 63, 7], "context_len": 24, "pages": 3}


@pytest.mark.parametrize("kind", sorted(BLOBS))
@pytest.mark.parametrize("port_form", [False, True], ids=["ml_dtypes", "bits"])
def test_frames_byte_identical_to_jax(kind, port_form):
    """The same blob packs to the same bytes in both packages, whether the
    port is handed the ml_dtypes arrays or its own raw-bits leaves."""
    blob = BLOBS[kind]()
    want, n_j, crc_j = JK.pack_frame("session/s", blob, META, version=3)
    got, n_t, crc_t = TK.pack_frame("session/s", _as_port(blob) if port_form else blob,
                                    META, version=3)
    assert got == want and (n_t, crc_t) == (n_j, crc_j)


@pytest.mark.parametrize("kind", sorted(BLOBS))
def test_frames_cross_read(kind):
    """Each package's unpack_frame reads the other's frame, bit for bit; the
    port hands bf16 back as BF16Bits."""
    blob = BLOBS[kind](seed=1)
    jframe, _, _ = JK.pack_frame("swap/7", blob, {"k": 1})
    tframe, _, _ = TK.pack_frame("swap/7", _as_port(blob), {"k": 1})
    t_blob, t_header = TK.unpack_frame(jframe)
    _assert_same_blob(t_blob, blob)
    leaves = [a for p in t_blob for a in (p.values() if isinstance(p, dict) else [p])]
    assert all(isinstance(a, TK.BF16Bits) == (a.dtype == np.uint16) for a in leaves)
    assert any(isinstance(a, TK.BF16Bits) for a in leaves)
    j_blob, j_header = JK.unpack_frame(tframe)
    _assert_same_blob(j_blob, blob)
    assert t_header == j_header


def test_corrupt_frames_are_refused_like_the_jax_package():
    """Torn (truncated), bit-flipped and bad-magic frames raise
    KVStoreCorrupt in both packages; a sharded (version 2) frame from the
    JAX package is read by the port (tensor parallelism landed: it was
    refused before), per-shard blobs bit for bit."""
    frame, _, _ = TK.pack_frame("k", _as_port(_bf16_blob()), {})
    flipped = bytearray(frame)
    flipped[-5] ^= 0x40
    for bad in (frame[:len(frame) // 2], bytes(flipped), b"XXXX" + frame[4:], frame[:8]):
        with pytest.raises(TK.KVStoreCorrupt):
            TK.unpack_frame(bad)
        with pytest.raises(JK.KVStoreCorrupt):
            JK.unpack_frame(bad)
    shards = [_bf16_blob(), _bf16_blob(1)]
    sharded, _, _ = JK.pack_sharded_frame("k", shards, {})
    got, header = TK.unpack_frame(sharded)
    assert isinstance(got, list) and len(header["shards"]) == 2
    for g, w in zip(got, shards):
        _assert_same_blob(g, w)


@pytest.mark.parametrize("kind", sorted(BLOBS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pinned_session_restores_across_packages(tmp_path, kind, writer):
    """A session one package's TieredKVStore pinned to a disk_dir restores
    in the other's store through its manifest replay, with identical bytes,
    meta and accounting."""
    blob = BLOBS[kind](seed=2)
    d = str(tmp_path / "kv")
    if writer == "jax":
        res = JK.TieredKVStore(JK.KVStoreConfig(disk_dir=d)).pin_session("s", blob, 0, META)
        reader = TK.TieredKVStore(TK.KVStoreConfig(disk_dir=d))
    else:
        res = TK.TieredKVStore(TK.KVStoreConfig(disk_dir=d)).pin_session(
            "s", _as_port(blob), 0, META)
        reader = JK.TieredKVStore(JK.KVStoreConfig(disk_dir=d))
    assert res["pinned"] and res["durable"]
    listed = reader.session_list()["s"]
    assert listed["tiers"] == ["disk"] and listed["pages"] == 3
    outcome, (got, nbytes, meta) = reader.restore_session("s")
    assert outcome == "disk" and nbytes == res["nbytes"] and meta == META
    _assert_same_blob(got, blob)


def test_session_id_validation_matches_jax():
    for sid in ("s", "web-1", "x" * 256, "~!@#"):
        assert TK.normalize_session_id(sid) == JK.normalize_session_id(sid)
    for bad in ("", 7, None, "x" * 257, "sp ace", "evil\r\nX: y", "emoji-\U0001f600"):
        with pytest.raises(JRequestError):
            JK.normalize_session_id(bad)
        with pytest.raises(RequestError):
            TK.normalize_session_id(bad)


def _both_stores(tmp_path, **kw):
    """The same store config in both packages, each on its own dir."""
    chaos = kw.pop("chaos", None)
    return (JK.TieredKVStore(JK.KVStoreConfig(
                disk_dir=str(tmp_path / "j"), **kw,
                chaos=JStorageFaultConfig(**chaos) if chaos else None)),
            TK.TieredKVStore(TK.KVStoreConfig(
                disk_dir=str(tmp_path / "t"), **kw,
                chaos=StorageFaultConfig(**chaos) if chaos else None)))


STAT_KEYS = ("swap_used_bytes", "swapped_out", "swapped_in", "swap_rejected",
             "kv_host_used_bytes", "kv_disk_used_bytes", "kv_spills",
             "kv_disk_evictions", "kv_verify_failures", "sessions_pinned",
             "session_evictions", "session_pins", "session_restores")


def _store_script(kv, blob):
    """Eviction order under budget pressure: unpinned swap entries go first,
    pinned sessions yield LRU-first and only to another pin."""
    out = [kv.pin_session("a", blob, 0, {})["evicted"],
           kv.pin_session("b", blob, 0, {})["evicted"],
           kv.restore_session("a")[0],                      # b is now LRU
           kv.put_swap(1, blob, 0), kv.put_swap(2, blob, 0),
           kv.pin_session("c", blob, 0, {})["evicted"],
           kv.restore_session("b")[0], kv.restore_session("a")[0],
           kv.pop_swap(1) is not None, kv.pop_swap(2) is not None]
    out.append({k: kv.stats()[k] for k in STAT_KEYS})
    return out


def test_budgets_and_eviction_order_match_jax(tmp_path):
    blob = _bf16_blob(3)
    nbytes = sum(a.nbytes for a in blob)
    jkv, tkv = _both_stores(tmp_path, host_max_bytes=nbytes,
                            disk_max_bytes=int(2.5 * nbytes))
    want = _store_script(jkv, blob)
    got = _store_script(tkv, _as_port(blob))
    assert got == want
    assert want[5] == ["b"]  # the LRU session was evicted for the new pin


@pytest.mark.parametrize("chaos,outcome", [
    ({"torn_write_every": 1}, "corrupt"), ({"bit_flip_every": 1}, "corrupt"),
    ({"enospc_every": 1}, "miss"), ({"slow_read_s": 0.01}, "disk")])
def test_storage_faults_degrade_like_jax(tmp_path, chaos, outcome):
    """Each storage fault class gives the same restore outcome and counters
    in both stores (host tier off, so the restore reads the page file)."""
    blob = _int8_blob(4)
    results = []
    for kv, b in zip(_both_stores(tmp_path, host_max_bytes=0, chaos=chaos),
                     (blob, _as_port(blob))):
        pin = kv.pin_session("s", b, 0, {"hashes": [1]})
        got = kv.restore_session("s")
        results.append((pin["pinned"], pin["durable"], got[0],
                        {k: kv.stats()[k] for k in STAT_KEYS},
                        kv.stats()["storage_chaos"]))
        if got[0] == "disk":
            _assert_same_blob(got[1][0], blob)
    assert results[0] == results[1]
    assert results[1][2] == outcome


def test_degraded_repin_keeps_previous_durable_copy(tmp_path):
    """An ENOSPC on the second pin serves the new context from the host tier
    and carries the first version's page file; a restarted store recovers
    the older context."""
    blob1, blob2 = _as_port(_bf16_blob(5)), _as_port(_bf16_blob(6))
    cfg = dict(host_max_bytes=1 << 20, disk_max_bytes=1 << 20, disk_dir=str(tmp_path / "kv"))
    kv = TK.TieredKVStore(TK.KVStoreConfig(**cfg, chaos=StorageFaultConfig(enospc_on=2)))
    assert kv.pin_session("s", blob1, 0, {"hashes": [1]})["durable"]
    r2 = kv.pin_session("s", blob2, 0, {"hashes": [1, 2]})
    assert r2["pinned"] and not r2["durable"] and r2["stale_durable"]
    out, payload = kv.restore_session("s")
    assert out == "host"
    _assert_same_blob(payload[0], blob2)
    out, payload = TK.TieredKVStore(TK.KVStoreConfig(**cfg)).restore_session("s")
    assert out == "disk" and payload[2]["hashes"] == [1]
    _assert_same_blob(payload[0], blob1)


def test_host_swap_store_budget(tmp_path):
    """The host-only facade: a put past the budget is rejected (the engine
    then recomputes), opaque blobs are held at face value."""
    st = TK.HostSwapStore(max_bytes=100)
    assert st.put(1, "blob", 60)
    assert not st.put(2, "big", 60)
    assert st.rejected == 1
    blob, n = st.pop(1)
    assert blob == "blob" and n == 60 and st.used_bytes == 0
    assert st.pop(1) is None
    assert st.put(3, "x", 100)
    st.discard(3)
    assert st.used_bytes == 0 and st.stats()["swapped_in"] == 1


def test_ephemeral_dir_removed_at_close():
    kv = TK.TieredKVStore(TK.KVStoreConfig(host_max_bytes=0))
    assert kv.pin_session("s", _as_port(_bf16_blob()), 0, {})["durable"]
    d = kv.disk_dir
    assert d and os.path.isdir(d)
    kv.close()
    assert not os.path.exists(d)
