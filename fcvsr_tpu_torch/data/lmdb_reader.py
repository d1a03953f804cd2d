"""Read-only LMDB access in pure Python and the LMDB-backed SR dataset
(the port's own copy of ``fcvsr_tpu.data.lmdb_reader``).

The reference trains REDS from LMDB shards (mmedit's ``SRLmdbDataset``,
built by its REDS ``make_lmdb`` tool).  No ``lmdb`` module is needed: this
reads the LMDB file format itself (the 64-bit little-endian flavour): the
two meta pages (the latest txnid wins), B+tree branch and leaf pages,
inline and overflow (F_BIGDATA) values.  That covers a dataset's use:
random ``get`` and full ``keys`` iteration over a finished database.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

__all__ = ["LmdbReader", "SRLmdbDataset"]

_PAGE = 4096
_HDR = 16
_MAGIC = 0xBEEFC0DE
_P_BRANCH = 0x01
_P_LEAF = 0x02
_F_BIGDATA = 0x01


class LmdbReader:
    """A read-only LMDB environment over mmap."""

    def __init__(self, path: str):
        data_path = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        self._f = open(data_path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        metas = []
        for pg in (0, 1):
            off = pg * _PAGE + _HDR
            magic, version = struct.unpack_from("<II", self._mm, off)
            if magic != _MAGIC:
                raise ValueError(f"not an LMDB data file: {data_path}")
            main_db = struct.unpack_from("<IHHQQQQQ", self._mm, off + 72)
            txnid = struct.unpack_from("<Q", self._mm, off + 128)[0]
            metas.append((txnid, main_db[7], main_db[6]))  # txnid, root, entries
        txnid, self._root, self.entries = max(metas)

    # -- page/node parsing --------------------------------------------------

    def _page(self, pgno: int):
        off = pgno * _PAGE
        _, _, flags, lower, upper = struct.unpack_from("<QHHHH", self._mm, off)
        return off, flags, lower

    def _nodes(self, pgno: int):
        off, flags, lower = self._page(pgno)
        nk = (lower - _HDR) // 2
        ptrs = struct.unpack_from(f"<{nk}H", self._mm, off + _HDR)
        return off, flags, ptrs

    def _leaf_value(self, off: int, ptr: int) -> bytes:
        lo, hi, fl, ks = struct.unpack_from("<HHHH", self._mm, off + ptr)
        dsz = lo | (hi << 16)
        dstart = off + ptr + 8 + ks
        if fl & _F_BIGDATA:
            opg = struct.unpack_from("<Q", self._mm, dstart)[0]
            return bytes(self._mm[opg * _PAGE + _HDR : opg * _PAGE + _HDR + dsz])
        return bytes(self._mm[dstart : dstart + dsz])

    def _node_key(self, off: int, ptr: int) -> bytes:
        _, _, _, ks = struct.unpack_from("<HHHH", self._mm, off + ptr)
        return bytes(self._mm[off + ptr + 8 : off + ptr + 8 + ks])

    # -- public API ---------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if self._root == 0xFFFFFFFFFFFFFFFF:
            return None
        pgno = self._root
        while True:
            off, flags, ptrs = self._nodes(pgno)
            if flags & _P_LEAF:
                for p in ptrs:
                    if self._node_key(off, p) == key:
                        return self._leaf_value(off, p)
                return None
            # branch: last child whose key <= target (first key is implicit low)
            nxt = None
            for i, p in enumerate(ptrs):
                k = self._node_key(off, p)
                lo, hi = struct.unpack_from("<HH", self._mm, off + p)
                child = lo | (hi << 16)
                # branch node stores pgno in (mn_lo, mn_hi) + mn_flags(hi bits)
                fl = struct.unpack_from("<H", self._mm, off + p + 4)[0]
                child |= fl << 32
                if i == 0 or k <= key:
                    nxt = child
                else:
                    break
            pgno = nxt

    def keys(self) -> Iterator[bytes]:
        if self._root == 0xFFFFFFFFFFFFFFFF:
            return
        stack = [self._root]
        while stack:
            pgno = stack.pop()
            off, flags, ptrs = self._nodes(pgno)
            if flags & _P_LEAF:
                for p in ptrs:
                    yield self._node_key(off, p)
            else:
                children = []
                for p in ptrs:
                    lo, hi = struct.unpack_from("<HH", self._mm, off + p)
                    fl = struct.unpack_from("<H", self._mm, off + p + 4)[0]
                    children.append((lo | (hi << 16)) | (fl << 32))
                stack.extend(reversed(children))

    def close(self):
        self._mm.close()
        self._f.close()


class SRLmdbDataset:
    """LMDB-backed frame store (mmedit SRLmdbDataset shape): keys from
    ``meta_info.txt`` lines 'name.png (h,w,c) compression', values PNG bytes."""

    def __init__(self, lmdb_path: str):
        self.reader = LmdbReader(lmdb_path)
        self.meta: Dict[str, tuple] = {}
        meta_path = os.path.join(lmdb_path, "meta_info.txt")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        name = parts[0].rsplit(".", 1)[0]
                        self.meta[name] = tuple(
                            int(v) for v in parts[1].strip("()").split(","))

    def keys(self) -> List[str]:
        return (list(self.meta) if self.meta
                else [k.decode() for k in self.reader.keys()])

    def load(self, key: str) -> np.ndarray:
        """Decode the stored image -> uint8 (H, W, C)."""
        import io

        from PIL import Image

        blob = self.reader.get(key.encode())
        if blob is None:
            raise KeyError(key)
        with Image.open(io.BytesIO(blob)) as img:
            return np.asarray(img.convert("RGB"), np.uint8)
