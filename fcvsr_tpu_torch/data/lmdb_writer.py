"""An LMDB writer in pure Python (a batch, written once): the authoring
half of ``lmdb_reader.py`` (the port's own copy of
``fcvsr_tpu.data.lmdb_writer``).

It builds an LMDB data file (the 64-bit little-endian flavour) from
key/value pairs: sorted leaf pages, F_BIGDATA overflow chains for large
values, a bottom-up B+tree of branch pages and the two meta pages, the
layout liblmdb writes, so that a REDS ``make_lmdb`` tool needs no ``lmdb``
module.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

__all__ = ["LmdbWriter", "write_lmdb"]

_PAGE = 4096
_HDR = 16
_MAGIC = 0xBEEFC0DE
_VERSION = 1
_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_META = 0x08
_F_BIGDATA = 0x01
# largest node we inline (mirrors liblmdb's ~page/2 threshold conservatively)
_MAX_INLINE = 2000


def _leaf_node(key: bytes, data: bytes, bigdata_pgno: int | None) -> bytes:
    if bigdata_pgno is None:
        dsz = len(data)
        payload = data
        flags = 0
    else:
        dsz = len(data)  # full data size is recorded even for overflow
        payload = struct.pack("<Q", bigdata_pgno)
        flags = _F_BIGDATA
    node = struct.pack("<HHHH", dsz & 0xFFFF, dsz >> 16, flags, len(key))
    node += key + payload
    if len(node) % 2:
        node += b"\x00"
    return node


def _branch_node(key: bytes, child_pgno: int) -> bytes:
    lo = child_pgno & 0xFFFF
    hi = (child_pgno >> 16) & 0xFFFF
    fl = (child_pgno >> 32) & 0xFFFF
    node = struct.pack("<HHHH", lo, hi, fl, len(key)) + key
    if len(node) % 2:
        node += b"\x00"
    return node


def _pack_page(pgno: int, flags: int, nodes: List[bytes]) -> bytes:
    """Nodes allocated from the page top downward, ptr array after header."""
    n = len(nodes)
    lower = _HDR + 2 * n
    offsets = []
    top = _PAGE
    for node in nodes:
        top -= len(node)
        offsets.append(top)
    if top < lower:
        raise ValueError("page overflow")
    page = bytearray(_PAGE)
    struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, top)
    struct.pack_into(f"<{n}H", page, _HDR, *offsets)
    for off, node in zip(offsets, nodes):
        page[off : off + len(node)] = node
    return bytes(page)


class LmdbWriter:
    """Collects put() calls, writes the database on close().

    Usage:
        w = LmdbWriter("/path/to/out.lmdb")   # creates the directory
        w.put(b"key", b"value"); ...
        w.close()
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.items: Dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes):
        self.items[key] = value

    def close(self):
        items = sorted(self.items.items())
        pages: Dict[int, bytes] = {}
        next_pg = 2  # 0/1 are meta
        n_overflow = 0

        # ---- leaves (with overflow chains) ----
        leaf_entries: List[Tuple[bytes, bytes]] = []  # (first_key, page)
        leaf_pgnos: List[int] = []
        cur_nodes: List[bytes] = []
        cur_bytes = 0
        cur_first_key = None

        def flush_leaf():
            nonlocal cur_nodes, cur_bytes, cur_first_key, next_pg
            if not cur_nodes:
                return
            pg = next_pg
            next_pg += 1
            pages[pg] = _pack_page(pg, _P_LEAF, cur_nodes)
            leaf_entries.append((cur_first_key, pg))
            leaf_pgnos.append(pg)
            cur_nodes, cur_bytes, cur_first_key = [], 0, None

        overflow_chunks: List[Tuple[int, bytes]] = []
        for key, value in items:
            if 8 + len(key) + len(value) > _MAX_INLINE:
                npgs = -(-(len(value) + _HDR) // _PAGE)
                opg = next_pg
                next_pg += npgs
                n_overflow += npgs
                chunk = bytearray(npgs * _PAGE)
                struct.pack_into("<QHHI", chunk, 0, opg, 0, _P_OVERFLOW, npgs)
                chunk[_HDR : _HDR + len(value)] = value
                overflow_chunks.append((opg, bytes(chunk)))
                node = _leaf_node(key, value, opg)
            else:
                node = _leaf_node(key, value, None)
            need = len(node) + 2
            if cur_nodes and _HDR + cur_bytes + 2 * len(cur_nodes) + need > _PAGE:
                flush_leaf()
            if not cur_nodes:
                cur_first_key = key
            cur_nodes.append(node)
            cur_bytes += len(node)
        flush_leaf()

        # ---- branches bottom-up ----
        depth = 1
        level = leaf_entries  # list of (first_key, pgno)
        branch_pages = 0
        while len(level) > 1:
            depth += 1
            nxt: List[Tuple[bytes, int]] = []
            group: List[Tuple[bytes, int]] = []
            gbytes = 0

            def flush_branch():
                nonlocal group, gbytes, next_pg, branch_pages
                if not group:
                    return
                nodes = []
                for i, (k, child) in enumerate(group):
                    nodes.append(_branch_node(b"" if i == 0 else k, child))
                pg = next_pg
                next_pg += 1
                pages[pg] = _pack_page(pg, _P_BRANCH, nodes)
                branch_pages += 1
                nxt.append((group[0][0], pg))
                group, gbytes = [], 0

            for k, child in level:
                node_len = len(_branch_node(k, child)) + 2
                if group and _HDR + gbytes + node_len > _PAGE:
                    flush_branch()
                group.append((k, child))
                gbytes += node_len
            flush_branch()
            level = nxt

        if level:
            root = level[0][1]
        else:
            root = 0xFFFFFFFFFFFFFFFF
            depth = 0

        # ---- metas ----
        last_pg = next_pg - 1
        mapsize = next_pg * _PAGE

        def meta(pgno, txnid):
            page = bytearray(_PAGE)
            struct.pack_into("<QHHHH", page, 0, pgno, 0, _P_META, 0, 0)
            off = _HDR
            struct.pack_into("<II", page, off, _MAGIC, _VERSION)
            struct.pack_into("<QQ", page, off + 8, 0, mapsize)
            # free_db: empty
            struct.pack_into("<IHHQQQQQ", page, off + 24, 0, 0, 0, 0, 0, 0, 0,
                             0xFFFFFFFFFFFFFFFF)
            # main_db (md_root is the last field, at off+112)
            struct.pack_into("<IHHQQQQQ", page, off + 72, 0, 0, depth,
                             branch_pages, len(leaf_pgnos), n_overflow,
                             len(items), root)
            # mm_last_pg at +120, mm_txnid at +128 (after the 48-byte
            # main_db record) — packing at +112 would clobber md_root
            struct.pack_into("<QQ", page, off + 120, last_pg, txnid)
            return bytes(page)

        with open(os.path.join(self.path, "data.mdb"), "wb") as f:
            f.write(meta(0, 0))
            f.write(meta(1, 1))
            body = bytearray((next_pg - 2) * _PAGE)
            for pg, data in list(pages.items()) + overflow_chunks:
                off = (pg - 2) * _PAGE
                body[off : off + len(data)] = data
            f.write(body)
        # lock.mdb exists in the canonical folder layout
        open(os.path.join(self.path, "lock.mdb"), "wb").close()


def write_lmdb(path: str, items: Dict[bytes, bytes]):
    w = LmdbWriter(path)
    for k, v in items.items():
        w.put(k, v)
    w.close()
