"""ctypes bindings + build-on-first-use for the C++ engine core (core.cc).

A copy of ``kubeflow_tpu/serving/engine/native.py`` (same bindings, same
behaviour) over the port's verbatim copy of ``core.cc``: the core exposes a
C ABI and binds with
ctypes, and the shared object is compiled once per source hash into this
package directory.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ...utils.native_build import load_native

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "core.cc")
_LOCK = threading.Lock()
_LIB = None


def load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = load_native(_SRC, "core")
            i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
            ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.eng_create.restype = p
            lib.eng_create.argtypes = [i32, i32, i32, i32]
            lib.eng_destroy.argtypes = [p]
            u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.eng_submit.restype = i32
            lib.eng_submit.argtypes = [p, i64, i32, i32, ctypes.c_void_p, i32]
            lib.eng_admit.restype = i32
            lib.eng_admit.argtypes = [p, ctypes.POINTER(i64), ctypes.POINTER(i32),
                                      ctypes.POINTER(i32), ctypes.POINTER(i32)]
            lib.eng_commit_token.restype = i32
            lib.eng_commit_token.argtypes = [p, i32, i32]
            lib.eng_commit_token_ex.restype = i32
            lib.eng_commit_token_ex.argtypes = [p, i32, i32, ctypes.POINTER(i32)]
            lib.eng_reserve_page.restype = i32
            lib.eng_reserve_page.argtypes = [p, i32]
            lib.eng_slot_pages.argtypes = [p, i32, ip]
            lib.eng_reclaimable.restype = i32
            lib.eng_reclaimable.argtypes = [p]
            lib.eng_reclaimable_slow.restype = i32
            lib.eng_reclaimable_slow.argtypes = [p]
            lib.eng_release.argtypes = [p, i32]
            lib.eng_release_cached.argtypes = [p, i32, u64p, i32]
            lib.eng_cache_stats.argtypes = [p, i64p]
            lib.eng_page_table.argtypes = [p, ip]
            lib.eng_seq_lens.argtypes = [p, ip]
            lib.eng_active_mask.argtypes = [p, ip]
            lib.eng_slot_req.restype = i64
            lib.eng_slot_req.argtypes = [p, i32]
            lib.eng_slot_seq_len.restype = i32
            lib.eng_slot_seq_len.argtypes = [p, i32]
            for fn in ("eng_num_free_pages", "eng_queue_depth", "eng_num_active"):
                getattr(lib, fn).restype = i32
                getattr(lib, fn).argtypes = [p]
            _LIB = lib
    return _LIB


class NativeBatcher:
    """Thin OO wrapper over the C core. Thread-safe (the core has the mutex)."""

    def __init__(self, max_slots: int, num_pages: int, page_size: int, max_pages_per_slot: int):
        self.lib = load_library()
        self.max_slots = max_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self._e = self.lib.eng_create(max_slots, num_pages, page_size, max_pages_per_slot)
        if not self._e:
            raise ValueError("bad engine geometry")

    def close(self) -> None:
        if self._e:
            self.lib.eng_destroy(self._e)
            self._e = None

    def _handle(self):
        """The live engine pointer; a clean Python error after close() —
        passing NULL into the C core would segfault instead."""
        if not self._e:
            raise RuntimeError("batcher closed")
        return self._e

    def submit(self, req_id: int, prompt_len: int, max_new_tokens: int,
               prefix_hashes=None) -> bool:
        """Queue a request; False if it can never fit. ``prefix_hashes``:
        uint64 chain hashes for the lookup-eligible full prompt pages (see
        Engine._page_hashes) — the prefix-cache lookup happens at admit."""
        if prefix_hashes is not None and len(prefix_hashes):
            h = np.ascontiguousarray(prefix_hashes, dtype=np.uint64)
            rc = self.lib.eng_submit(self._handle(), req_id, prompt_len,
                                     max_new_tokens, h.ctypes.data, len(h))
        else:
            rc = self.lib.eng_submit(self._handle(), req_id, prompt_len,
                                     max_new_tokens, None, 0)
        return rc == 0

    def admit(self):
        """-> (slot, req_id, prompt_len, max_new_tokens, cached_pages) or None."""
        rid = ctypes.c_int64()
        plen = ctypes.c_int32()
        mnew = ctypes.c_int32()
        cached = ctypes.c_int32()
        slot = self.lib.eng_admit(self._handle(), ctypes.byref(rid), ctypes.byref(plen),
                                  ctypes.byref(mnew), ctypes.byref(cached))
        if slot < 0:
            return None
        return slot, rid.value, plen.value, mnew.value, cached.value

    def commit_token(self, slot: int, is_eos: bool) -> int:
        """1=continue, 0=finished, -2=page pool exhausted."""
        return self.lib.eng_commit_token(self._handle(), slot, 1 if is_eos else 0)

    def commit_token_ex(self, slot: int, is_eos: bool) -> tuple:
        """-> (rc, new_page_id or -1): rc as commit_token; new_page_id lets
        the caller grow a host-side page-table mirror incrementally."""
        new_page = ctypes.c_int32(-1)
        rc = self.lib.eng_commit_token_ex(self._handle(), slot,
                                          1 if is_eos else 0,
                                          ctypes.byref(new_page))
        return rc, new_page.value

    def reserve_page(self, slot: int) -> int:
        """Pre-allocate one page for an active slot.  Returns the page id,
        -1 no-op (bad/inactive slot or per-slot cap), -2 pool empty.  A
        later ``commit_token_ex`` that crosses into a reserved page finds
        the slot's page list already long enough and allocates nothing; an
        unused reservation frees with the slot."""
        return load_library().eng_reserve_page(self._handle(), slot)

    def release(self, slot: int, prefix_hashes=None) -> None:
        """Free the slot; with ``prefix_hashes`` (uint64, one per full PROMPT
        page) the covered pages enter the prefix cache instead."""
        h = np.ascontiguousarray(prefix_hashes if prefix_hashes is not None else [],
                                 dtype=np.uint64)
        self.lib.eng_release_cached(self._handle(), slot, h, len(h))

    def cache_stats(self) -> dict:
        out = np.zeros((4,), np.int64)
        self.lib.eng_cache_stats(self._handle(), out)
        return {"cached_pages": int(out[0]), "page_hits": int(out[1]),
                "page_misses": int(out[2]), "evictions": int(out[3])}

    def page_table(self) -> np.ndarray:
        out = np.zeros((self.max_slots, self.max_pages_per_slot), np.int32)
        self.lib.eng_page_table(self._handle(), out.reshape(-1))
        return out

    def slot_pages(self, slot: int) -> np.ndarray:
        """One slot's page-table row (fetched at admission; see commit_token_ex)."""
        out = np.zeros((self.max_pages_per_slot,), np.int32)
        self.lib.eng_slot_pages(self._handle(), slot, out)
        return out

    def seq_lens(self) -> np.ndarray:
        out = np.zeros((self.max_slots,), np.int32)
        self.lib.eng_seq_lens(self._handle(), out)
        return out

    def active_mask(self) -> np.ndarray:
        out = np.zeros((self.max_slots,), np.int32)
        self.lib.eng_active_mask(self._handle(), out)
        return out

    def slot_req(self, slot: int) -> int:
        return self.lib.eng_slot_req(self._handle(), slot)

    def slot_seq_len(self, slot: int) -> int:
        return self.lib.eng_slot_seq_len(self._handle(), slot)

    def reclaimable(self) -> int:
        return self.lib.eng_reclaimable(self._handle())

    def reclaimable_slow(self) -> int:
        return self.lib.eng_reclaimable_slow(self._handle())

    @property
    def free_pages(self) -> int:
        return self.lib.eng_num_free_pages(self._handle())

    @property
    def queue_depth(self) -> int:
        return self.lib.eng_queue_depth(self._handle())

    @property
    def num_active(self) -> int:
        return self.lib.eng_num_active(self._handle())

    @property
    def free_slots(self) -> int:
        """Slots not currently holding a request."""
        return self.max_slots - self.lib.eng_num_active(self._handle())

    def __del__(self):  # pragma: no cover - defensive
        try:
            self.close()
        except Exception:
            pass
