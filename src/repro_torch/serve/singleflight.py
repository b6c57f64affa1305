# Port copy of src/repro/serve/singleflight.py: host-only, logic unchanged.
"""Single-flight deduplication + the two-tier decoded-response cache.

When N concurrent requests ask for the same expensive computation (decoding
the same container record, reconstructing the same file), exactly one —
the *leader* — runs it; the other N-1 await the leader's future and share
the result. This is the asyncio analogue of Go's ``singleflight`` package,
and the piece that keeps the retrieval server's worker pool from decoding
one hot checkpoint eight times side by side.

Keys must already encode *everything* the result depends on. The store
server keys flights by ``(store.read_gen, entity_tag, kind, repo, file[,
tensor])`` — the read generation rolls over on every ingest/delete/gc, so
a request issued after a mutation can never coalesce onto a stale
in-flight decode (see the read-gate notes in ``repro_torch.core.pipeline``).

:class:`TieredResponseCache` is what finished flights land in: a
byte-budgeted RAM LRU over an mmap-read disk spill directory (the store
root's ``.decoded/``). Entries are keyed by ``(object key, strong
validator)`` — the same ``key@gN`` entity tag conditional HTTP GETs
revalidate against — so hot tensors evicted from RAM stop re-paying
entropy decode (they promote back from disk), and gc/compact invalidation
stays trivial: a re-registered key gets a new validator, the old entry
simply stops being addressed and is purged on the next observed mutation.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import mmap
import os
import struct
from collections import OrderedDict
from typing import Any, Awaitable, Callable, Dict, Hashable, Optional, Tuple

from repro_torch.core.pipeline import _LRUCache

__all__ = ["SingleFlight", "TieredResponseCache"]


class SingleFlight:
    """Coalesce concurrent async calls per key. Event-loop-confined: call
    :meth:`run` only from coroutines on one loop (no internal locking is
    needed precisely because of that confinement)."""

    def __init__(self):
        self._inflight: Dict[Hashable, asyncio.Future] = {}
        self.leaders = 0   # flights actually executed
        self.joined = 0    # calls that shared another call's flight

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    async def run(self, key: Hashable, thunk: Callable[[], Awaitable[Any]]) -> Any:
        """Return ``await thunk()``, sharing one execution among all
        concurrent callers with the same ``key``.

        The leader's outcome — result or exception — propagates to every
        joiner. A joiner being cancelled does not cancel the shared flight
        (the future is shielded); a cancelled *leader* cancels the flight
        for everyone, which is the honest outcome since its work stopped.
        """
        existing = self._inflight.get(key)
        if existing is not None:
            self.joined += 1
            return await asyncio.shield(existing)

        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._inflight[key] = fut
        self.leaders += 1
        try:
            result = await thunk()
        except BaseException as e:
            self._inflight.pop(key, None)
            if not fut.cancelled():
                fut.set_exception(e)
                fut.exception()  # mark retrieved: no-joiner flights must not
                # warn "exception was never retrieved" at GC time
            raise
        else:
            self._inflight.pop(key, None)
            if not fut.cancelled():
                fut.set_result(result)
            return result

    def stats(self) -> Dict[str, int]:
        return {"leaders": self.leaders, "joined": self.joined,
                "inflight": self.inflight}


_SPILL_SUFFIX = ".dec"
_SPILL_TMP = ".part"   # same crash-debris contract as container writes


class TieredResponseCache:
    """Decoded-response cache with a RAM tier and a disk spill tier.

    * **RAM tier** — a byte-budgeted LRU of finished decode results
      (``bytes`` or ``(bytes, meta)`` tuples), keyed by ``(objkey,
      validator)`` where ``objkey`` is the engine's object coordinate
      (``("file", repo, file)`` / ``("tensor", repo, file, name)``) and
      ``validator`` the store's strong entity tag for that key (the
      ``key@gN`` form served as the HTTP ETag).
    * **Disk tier** — RAM evictions spill to ``spill_dir`` (the store
      root's ``.decoded/``) with the container write discipline
      (temp ``.part`` + atomic rename; crash debris is cleaned by the
      fsck orphan scan). A RAM miss that hits disk *promotes*: the
      payload is mmap-read back into the RAM tier and the spill file is
      dropped — an entry lives in exactly one tier.

    Validator keying makes lifecycle invalidation trivial: generations
    are immutable, so an entry can only go stale by its key being
    re-registered / deleted — which changes the key's current validator.
    :meth:`purge` drops every entry whose validator is no longer current
    (called when the engine observes a ``read_gen`` change), so dead
    generations never squat on either byte budget.

    Loop-confined like the engine that owns it: no internal locking.
    The constructor wipes ``spill_dir`` — spill files are cache state of
    one engine process, not durable data.
    """

    def __init__(self, spill_dir: Optional[str] = None, *,
                 max_bytes: int = 128 << 20,
                 spill_max_bytes: Optional[int] = None,
                 max_items: int = 1024):
        self._ram = _LRUCache(max_items=max_items, max_bytes=max_bytes,
                              on_evict=self._spill)
        self.spill_dir = spill_dir
        self.spill_max_bytes = (spill_max_bytes if spill_max_bytes is not None
                                else 4 * max_bytes)
        # spill index: fname -> (file bytes, objkey, validator); insertion
        # order is the disk tier's LRU order
        self._files: "OrderedDict[str, Tuple[int, Tuple, str]]" = OrderedDict()
        self._spill_bytes = 0
        self.ram_hits = self.disk_hits = self.misses = 0
        self.spills = self.promotions = self.purged = 0
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            for fn in os.listdir(spill_dir):  # cold start: previous
                # process's spill files (and any crash debris) are stale
                if fn.endswith((_SPILL_SUFFIX, _SPILL_TMP)):
                    try:
                        os.remove(os.path.join(spill_dir, fn))
                    except OSError:
                        pass

    # -- public surface -------------------------------------------------
    def get(self, objkey: Tuple, validator: str) -> Any:
        ent = self._ram.get((objkey, validator))
        if ent is not None:
            self.ram_hits += 1
            return ent[2]
        value_nbytes = self._load_spill(objkey, validator)
        if value_nbytes is not None:
            value, nbytes = value_nbytes
            self.disk_hits += 1
            self.promotions += 1
            # promote: disk -> RAM (may cascade other entries to disk)
            self._ram.put((objkey, validator), (objkey, validator, value),
                          nbytes)
            return value
        self.misses += 1
        return None

    def put(self, objkey: Tuple, validator: str, value: Any,
            nbytes: int) -> None:
        self._ram.put((objkey, validator), (objkey, validator, value),
                      nbytes)

    def purge(self, is_current: Callable[[Tuple, str], bool]) -> int:
        """Drop every entry (both tiers) whose ``(objkey, validator)``
        fails ``is_current`` — entries of re-registered / deleted keys.
        Dead RAM entries are discarded WITHOUT spilling (that would just
        move the squatting to disk). Returns the number purged."""
        n = 0
        for k in self._ram.keys():
            if not is_current(*k):
                self._ram.discard(k)
                n += 1
        for fname in list(self._files):
            _, objkey, validator = self._files[fname]
            if not is_current(objkey, validator):
                self._drop_spill(fname)
                n += 1
        self.purged += n
        return n

    def clear(self) -> None:
        for k in self._ram.keys():
            self._ram.discard(k)
        for fname in list(self._files):
            self._drop_spill(fname)

    @property
    def ram_bytes(self) -> int:
        return self._ram.nbytes

    @property
    def spill_bytes(self) -> int:
        return self._spill_bytes

    def __len__(self) -> int:
        return len(self._ram) + len(self._files)

    def stats(self) -> Dict[str, int]:
        return {"items": len(self._ram), "spilled_items": len(self._files),
                "hits": self.ram_hits, "disk_hits": self.disk_hits,
                "misses": self.misses, "spills": self.spills,
                "promotions": self.promotions, "purged": self.purged,
                "ram_bytes": self.ram_bytes, "spill_bytes": self._spill_bytes}

    # -- spill tier -----------------------------------------------------
    @staticmethod
    def _fname(objkey: Tuple, validator: str) -> str:
        h = hashlib.sha256(repr((objkey, validator)).encode()).hexdigest()
        return h[:32] + _SPILL_SUFFIX

    def _spill(self, ent: Tuple) -> None:
        """RAM-eviction hook: serialize the entry into the spill dir
        (4-byte header length, JSON header, raw payload). Best-effort —
        a full disk degrades to a plain LRU, never an error."""
        if self.spill_dir is None:
            return
        objkey, validator, value = ent
        payload, meta = (value if isinstance(value, tuple) and len(value) == 2
                         else (value, None))
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            return
        header = json.dumps({"k": list(objkey), "v": validator, "meta": meta,
                             "n": len(payload)}).encode()
        fname = self._fname(objkey, validator)
        path = os.path.join(self.spill_dir, fname)
        tmp = path + _SPILL_TMP
        try:
            with open(tmp, "wb") as f:
                f.write(struct.pack(">I", len(header)))
                f.write(header)
                f.write(payload)
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError):
            try:
                os.remove(tmp)
            except OSError:
                pass
            return
        nbytes = 4 + len(header) + len(payload)
        old = self._files.pop(fname, None)
        if old is not None:
            self._spill_bytes -= old[0]
        self._files[fname] = (nbytes, objkey, validator)
        self._spill_bytes += nbytes
        self.spills += 1
        while self._spill_bytes > self.spill_max_bytes and len(self._files) > 1:
            self._drop_spill(next(iter(self._files)))

    def _drop_spill(self, fname: str) -> None:
        ent = self._files.pop(fname, None)
        if ent is None:
            return
        self._spill_bytes -= ent[0]
        if self.spill_dir is not None:
            try:
                os.remove(os.path.join(self.spill_dir, fname))
            except OSError:
                pass

    def _load_spill(self, objkey: Tuple,
                    validator: str) -> Optional[Tuple[Any, int]]:
        """(value, payload nbytes) read back from the spill tier, or
        ``None``. The spill file is consumed (promotion moves the entry);
        any irregularity — deleted file, torn write, hash-name collision
        — degrades to a miss."""
        fname = self._fname(objkey, validator)
        if self.spill_dir is None or fname not in self._files:
            return None
        path = os.path.join(self.spill_dir, fname)
        try:
            with open(path, "rb") as f:
                with mmap.mmap(f.fileno(), 0,
                               access=mmap.ACCESS_READ) as mm:
                    (hlen,) = struct.unpack(">I", mm[:4])
                    hdr = json.loads(bytes(mm[4:4 + hlen]).decode())
                    if (tuple(hdr["k"]) != tuple(objkey)
                            or hdr["v"] != validator):
                        self._drop_spill(fname)
                        return None
                    n = int(hdr["n"])
                    payload = bytes(mm[4 + hlen:4 + hlen + n])
                    if len(payload) != n:
                        self._drop_spill(fname)
                        return None
        except (OSError, ValueError, KeyError, struct.error):
            self._drop_spill(fname)
            return None
        self._drop_spill(fname)
        meta = hdr.get("meta")
        value = payload if meta is None else (payload, meta)
        return value, n
