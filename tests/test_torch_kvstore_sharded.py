"""Port parity: sharded (version 2, tensor-parallel) KVPG frames.

The same numpy-seeded per-shard blobs (f32, bf16, int8 ``{"q", "s"}``) go
through both packages: ``pack_sharded_frame`` gives the JAX package's bytes,
each package unpacks the other's frames bit for bit, a torn, flipped or
dropped single sub-frame (``faults._corrupt_shard``, the chaos plane's
injector) fails its own verifier with a shard-scoped error in both, and the
two packages' chaos injectors corrupt the same bytes and count the same
injections.  ``reshard_blob`` agrees with the JAX function across degrees
1, 2 and 4, exactly; degree-1 blobs keep the version-1 layout byte for
byte; the port's ``TieredKVStore`` keeps per-shard list blobs on its host
and disk tiers and restores them across packages."""

import json
import struct
import zlib

import ml_dtypes
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import faults as JF
from kubeflow_tpu.serving.engine import kvstore as JK
from kubeflow_tpu_torch.serving.engine import faults as TF
from kubeflow_tpu_torch.serving.engine import kvstore as TK

PAGE, HEADS, HD = 8, 4, 4


def _shards(degree, kind, pages=3, seed=0) -> list:
    """Per-shard ``(k, v)`` blobs ``[1, pages, HEADS/degree, PAGE, HD]`` in
    kv-head order, in the JAX package's form (ml_dtypes bf16)."""
    rng = np.random.default_rng(seed)
    per = HEADS // degree

    def part():
        x = rng.standard_normal((1, pages, per, PAGE, HD))
        if kind == "f32":
            return x.astype(np.float32)
        if kind == "bf16":
            return x.astype(ml_dtypes.bfloat16)
        return {"q": (x * 40).clip(-127, 127).astype(np.int8),
                "s": np.abs(rng.standard_normal((1, pages, per, PAGE, 1))).astype(
                    ml_dtypes.bfloat16)}
    return [(part(), part()) for _ in range(degree)]


def _port_form(tree):
    """The port's form of a blob tree: bf16 leaves as BF16Bits."""
    if isinstance(tree, np.ndarray):
        return TK.bf16_bits(tree) if tree.dtype == ml_dtypes.bfloat16 else tree
    if isinstance(tree, dict):
        return {k: _port_form(v) for k, v in tree.items()}
    out = [_port_form(v) for v in tree]
    return tuple(out) if isinstance(tree, tuple) else out


def _assert_same(got, want):
    """Same structure, shapes and raw bytes (bf16 of either kind)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                      np.ascontiguousarray(want).view(np.uint8))
        return
    assert type(got) is type(want) and len(got) == len(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    else:
        for g, w in zip(got, want):
            _assert_same(g, w)


KINDS = ("f32", "bf16", "int8")


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_frame_byte_identical_and_cross_read(kind, degree):
    blobs = _shards(degree, kind)
    meta = {"resume_len": 9, "tp": degree}
    want, n_j, crc_j = JK.pack_sharded_frame("handoff/1", blobs, meta)
    got, n_t, crc_t = TK.pack_sharded_frame("handoff/1", _port_form(blobs), meta)
    assert got == want and (n_t, crc_t) == (n_j, crc_j)
    assert struct.unpack("<I", got[4:8])[0] == TK.SHARDED_FORMAT_VERSION == 2
    t_blobs, t_header = TK.unpack_frame(want)
    j_blobs, j_header = JK.unpack_frame(got)
    assert TK.blob_degree(t_blobs) == degree and t_header == j_header
    _assert_same(t_blobs, blobs)
    _assert_same(j_blobs, blobs)
    # bf16 comes back to the port as raw bits, tagged
    if kind == "bf16":
        assert isinstance(t_blobs[0][0], TK.BF16Bits)
    assert t_header["nbytes"] == n_t and crc_t == zlib.crc32(
        got[12 + struct.unpack("<I", got[8:12])[0]:])


@pytest.mark.parametrize("kind", ["torn", "flip", "drop"])
def test_corrupt_sub_frame_is_caught_per_shard(kind):
    data, _, _ = TK.pack_sharded_frame("handoff/7", _port_form(_shards(2, "bf16")),
                                       {"resume_len": 4})
    assert TF._shard_regions(data) == JF._shard_regions(data)
    assert len(TF._shard_regions(data)) == 2
    bad = TF._corrupt_shard(data, 1, kind == "torn", kind == "flip", kind == "drop")
    assert bad == JF._corrupt_shard(data, 1, kind == "torn", kind == "flip", kind == "drop")
    assert len(bad) == len(data)  # the outer stream is intact
    with pytest.raises(TK.KVStoreCorrupt, match="shard 1"):
        TK.unpack_frame(bad)
    with pytest.raises(JK.KVStoreCorrupt, match="shard 1"):
        JK.unpack_frame(bad)
    for cut in (data[:len(data) - 5], data[:len(data) // 3]):  # torn outer stream
        with pytest.raises(TK.KVStoreCorrupt):
            TK.unpack_frame(cut)
    v1, _, _ = TK.pack_frame("x", _port_form(_shards(1, "bf16"))[0], {})
    assert TF._shard_regions(v1) == []  # legacy frames pass shard chaos by


@pytest.mark.parametrize("scope", ["handoff", "fabric"])
def test_shard_chaos_injects_like_the_jax_package(scope):
    """``shard_*`` fields are accepted (they were refused before) and
    corrupt the same bytes on the same pulls; ``injected_shard_faults``
    counts the injections."""
    data, _, _ = TK.pack_sharded_frame("fabric/k", _port_form(_shards(4, "int8")), {})
    kw = {"shard_torn_pull_on": 1, "shard_flip_pull_every": 2, "shard_drop_pull_on": 3}
    if scope == "handoff":
        t, j = TF.HandoffChaos(TF.HandoffFaultConfig(**kw)), JF.HandoffChaos(JF.HandoffFaultConfig(**kw))
    else:
        t, j = TF.FabricChaos(TF.FabricFaultConfig(**kw)), JF.FabricChaos(JF.FabricFaultConfig(**kw))
    for _ in range(5):
        got, want = t.on_pull(data), j.on_pull(data)
        assert got == want
    assert t.stats() == j.stats()
    assert t.stats()["injected_shard_faults"] == 4  # pulls 1, 2, 3, 4


@pytest.mark.parametrize("kind", KINDS)
def test_reshard_blob_exact_across_degrees(kind):
    four = _shards(4, kind, seed=3)
    for src in (1, 2, 4):
        blob = JK.reshard_blob(four, src)
        for dst in (1, 2, 4):
            want = JK.reshard_blob(blob, dst)
            got = TK.reshard_blob(_port_form(blob), dst)
            _assert_same(got, _port_form(want))
            assert TK.blob_degree(got) == dst
    uni = TK.reshard_blob(_port_form(four), 1)
    assert isinstance(uni, tuple)
    _assert_same(TK.reshard_blob(TK.reshard_blob(uni, 2), 4), _port_form(four))
    with pytest.raises(ValueError, match="not divisible"):
        TK.reshard_blob(uni, 3)


def test_degree1_frames_stay_version1_byte_for_byte():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((1, 2, 4, PAGE, 4)).astype(np.float32)
    v = rng.standard_normal((1, 2, 4, PAGE, 4)).astype(np.float32)
    meta = {"resume_len": 9, "page_size": PAGE}
    spec = {"t": "t", "v": [
        {"t": "a", "dtype": "float32", "shape": list(k.shape), "i": 0},
        {"t": "a", "dtype": "float32", "shape": list(v.shape), "i": 1}]}
    payload = k.tobytes() + v.tobytes()
    header = json.dumps({
        "v": 1, "key": "session/s/3", "spec": spec, "meta": meta,
        "nbytes": len(payload), "crc": zlib.crc32(payload), "version": 1}).encode()
    legacy = TK.MAGIC + struct.pack("<II", 1, len(header)) + header + payload
    data, _, _ = TK.pack_frame("session/s/3", (k, v), meta)
    assert data == legacy == JK.pack_frame("session/s/3", (k, v), meta)[0]
    blob, hdr = TK.unpack_frame(legacy)
    assert TK.blob_degree(blob) == 1 and hdr["meta"] == meta


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_keeps_shard_lists_on_host_and_disk(tmp_path, writer):
    """A per-shard list blob pins to the host tier and its page file, reads
    back from both as a list, and restores across packages from disk."""
    blobs = _shards(2, "bf16", seed=5)
    meta = {"hashes": [1, 2, 3], "pages": 3, "tp": 2}
    d = str(tmp_path / "kv")
    if writer == "jax":
        store = JK.TieredKVStore(JK.KVStoreConfig(disk_dir=d))
        res = store.pin_session("s", blobs, 0, meta)
    else:
        store = TK.TieredKVStore(TK.KVStoreConfig(disk_dir=d))
        res = store.pin_session("s", _port_form(blobs), 0, meta)
        outcome, (got, _, got_meta) = store.restore_session("s")
        assert outcome == "host" and got_meta == meta
        _assert_same(got, _port_form(blobs))
    assert res["pinned"] and res["durable"]
    for reader in (TK.TieredKVStore(TK.KVStoreConfig(disk_dir=d)),
                   JK.TieredKVStore(JK.KVStoreConfig(disk_dir=d))):
        outcome, (got, _, got_meta) = reader.restore_session("s")
        assert outcome == "disk" and got_meta == meta
        assert isinstance(got, list) and len(got) == 2
        want = _port_form(blobs) if isinstance(reader, TK.TieredKVStore) else blobs
        _assert_same(got, want)
