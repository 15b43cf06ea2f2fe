"""Dependency-free LMDB read and write (port of
``caffe_escoin_tpu/data/lmdb_io.py``; a copy: the same reader, and a writer
that gives the same bytes for the same items).

The reference ingests image databases through LMDB
(`src/caffe/util/db_lmdb.cpp:1-113`; `data_layer.cpp` reads `Datum`
protobufs under "%08d"-style keys). This module reads standard LMDB files
directly, with no liblmdb and no python-lmdb, by walking the B+tree of the
data file:

* meta pages 0/1 (MDB_meta, magic 0xBEEFC0DE, newest txnid wins) give the
  MAIN db's root page; the page size is probed from the second meta's
  location (LMDB does not store it);
* BRANCH pages hold (48-bit child pgno | key) nodes; LEAF pages hold
  (datasize | key | value) nodes; F_BIGDATA values live on OVERFLOW page
  runs. DUPSORT trees (never written by Caffe's tools) are rejected.
* `Datum` decoding uses the protobuf wire walker of tools/caffemodel.py
  (fields channels/height/width/data/label/float_data/encoded of
  `src/caffe/proto/caffe.proto` message Datum).

The writer emits a valid tree of one branch level (root branch -> leaf
pages, large values on overflow pages): enough for tests, round trips and
`convert_imageset --backend lmdb`.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

MDB_MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
P_LEAF2, P_DIRTY = 0x20, 0x10
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
PAGEHDRSZ = 16
# page header + magic and version + address + map size + the free db
_META_DB_OFF = 16 + 8 + 8 + 8 + 48
# MDB_db: pad(4) flags(2) depth(2) branch(8) leaf(8) overflow(8)
# entries(8) root(8)
_DB_FMT = "<IHHQQQQq"
_DB_SIZE = struct.calcsize(_DB_FMT)


def _data_file(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class LmdbReader:
    """Read-only LMDB cursor over the MAIN database, in key order."""

    def __init__(self, path: str):
        self.path = _data_file(path)
        with open(self.path, "rb") as fh:
            if os.fstat(fh.fileno()).st_size < 32:
                raise ValueError(f"{self.path}: not an LMDB data file")
            # mapped, not read: a database may be far larger than memory,
            # and a reader that only wants the first record reads one page
            self.buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        magic = struct.unpack_from("<I", self.buf, PAGEHDRSZ)[0]
        if magic != MDB_MAGIC:
            raise ValueError(
                f"{self.path}: bad LMDB magic {magic:#x}")
        self.psize = self._probe_psize()
        meta = max((self._meta(0), self._meta(1)), key=lambda m: m["txnid"])
        self.entries = meta["entries"]
        self.root = meta["root"]
        if meta["flags"] & 0x04:  # MDB_DUPSORT
            raise ValueError("DUPSORT databases are not supported "
                             "(Caffe tooling never writes them)")

    def _probe_psize(self) -> int:
        for ps in (4096, 8192, 16384, 32768, 65536, 1024, 2048):
            if len(self.buf) >= ps + 32:
                if struct.unpack_from("<I", self.buf, ps + PAGEHDRSZ)[0] \
                        == MDB_MAGIC:
                    flags = struct.unpack_from("<H", self.buf, ps + 10)[0]
                    if flags & P_META:
                        return ps
        raise ValueError(f"{self.path}: cannot determine LMDB page size")

    def _meta(self, idx: int) -> dict:
        base = idx * self.psize
        # MDB_meta after the 16-byte page header:
        # magic(4) version(4) address(8) mapsize(8) dbs[2] last_pg(8) txnid(8)
        db = struct.unpack_from(_DB_FMT, self.buf, base + _META_DB_OFF)
        tail = base + _META_DB_OFF + _DB_SIZE
        last_pg, txnid = struct.unpack_from("<QQ", self.buf, tail)
        return dict(flags=db[1], depth=db[2], entries=db[6], root=db[7],
                    last_pg=last_pg, txnid=txnid)

    # -- page access -----------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, int, memoryview]:
        base = pgno * self.psize
        flags, lower = struct.unpack_from("<HH", self.buf, base + 10)
        return base, flags, memoryview(self.buf)

    def _numkeys(self, base: int) -> int:
        lower = struct.unpack_from("<H", self.buf, base + 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, base: int, i: int) -> Tuple[int, int, int, int]:
        """(node_offset, lo|hi size, flags, ksize)."""
        ptr = struct.unpack_from("<H", self.buf, base + PAGEHDRSZ + 2 * i)[0]
        off = base + ptr
        lo, hi, fl, ks = struct.unpack_from("<HHHH", self.buf, off)
        return off, lo | (hi << 16), fl, ks

    def _walk(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        base = pgno * self.psize
        flags = struct.unpack_from("<H", self.buf, base + 10)[0]
        n = self._numkeys(base)
        if flags & P_LEAF:
            for i in range(n):
                off, dsize, fl, ks = self._node(base, i)
                key = bytes(self.buf[off + 8: off + 8 + ks])
                if fl & F_BIGDATA:
                    ovpg = struct.unpack_from(
                        "<Q", self.buf, off + 8 + ks)[0]
                    ovbase = ovpg * self.psize
                    val = bytes(self.buf[ovbase + PAGEHDRSZ:
                                         ovbase + PAGEHDRSZ + dsize])
                else:
                    d0 = off + 8 + ks
                    val = bytes(self.buf[d0: d0 + dsize])
                yield key, val
        elif flags & P_BRANCH:
            for i in range(n):
                off, lohi, fl, ks = self._node(base, i)
                child = lohi | (fl << 32)  # 48-bit pgno across lo/hi/flags
                yield from self._walk(child)
        else:
            raise ValueError(f"page {pgno}: unexpected flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self.root < 0:
            return
        yield from self._walk(self.root)

    def __len__(self) -> int:
        return self.entries


# -- Datum (caffe.proto) ---------------------------------------------------

def datum_decode(raw: bytes) -> Tuple[np.ndarray, Optional[int]]:
    """Datum bytes -> (HWC uint8/float32 array, label or None)."""
    from caffe_escoin_tpu_torch.tools.caffemodel import (
        _packed_floats, _packed_varints, walk)

    fields = walk(raw)
    ch = _packed_varints(fields.get(1, []))
    h = _packed_varints(fields.get(2, []))
    w = _packed_varints(fields.get(3, []))
    ch = ch[0] if ch else 1
    h = h[0] if h else 1
    w = w[0] if w else 1
    label = _packed_varints(fields.get(5, []))
    label = label[0] if label else None
    enc = _packed_varints(fields.get(7, []))
    if enc and enc[0]:
        raise ValueError("encoded (JPEG) Datum needs an image decoder; "
                         "store raw pixels (convert_imageset default)")
    if 4 in fields and fields[4]:
        data = np.frombuffer(fields[4][0], np.uint8)
        arr = data.reshape(ch, h, w).transpose(1, 2, 0)  # CHW -> HWC
    else:
        arr = _packed_floats(fields.get(6, []))
        arr = np.asarray(arr, np.float32).reshape(ch, h, w).transpose(
            1, 2, 0)
    return arr, label


def datum_encode(arr: np.ndarray, label: int = 0) -> bytes:
    """HWC array -> Datum bytes (uint8 data field; float_data otherwise).
    Proper proto2 wire types: varint for the scalar int32 fields,
    length-delimited for data/float_data."""
    from caffe_escoin_tpu_torch.tools.caffemodel import _varint

    def vint(num, v):
        return bytes([num << 3 | 0]) + _varint(int(v))

    h, w, ch = arr.shape
    out = vint(1, ch) + vint(2, h) + vint(3, w)
    chw = np.ascontiguousarray(arr.transpose(2, 0, 1))
    if arr.dtype == np.uint8:
        payload = chw.tobytes()
        out += bytes([4 << 3 | 2]) + _varint(len(payload)) + payload
    else:
        payload = chw.astype("<f4").tobytes()
        out += bytes([6 << 3 | 2]) + _varint(len(payload)) + payload
    out += vint(5, label)
    return out


def lmdb_source(path: str, batch: int, *, loop: bool = True,
                dtype=np.float32):
    """Data-source callable over an LMDB of Datum records (the reference's
    `DataLayer` + `db_lmdb` ingestion path): each call returns {"data":
    [B,H,W,C] ``dtype``, "label": [B] int64} from a cursor in key order
    that wraps (``loop``) or gives a last, short batch and then raises
    StopIteration. The JAX function reads every record into memory first;
    this cursor walks the mapped file, with the same batches."""
    rd = LmdbReader(path)
    if next(rd.items(), None) is None:
        raise ValueError(f"{path}: empty database")
    cursor = [rd.items()]

    def next_record():
        rec = next(cursor[0], None)
        if rec is None and loop:
            cursor[0] = rd.items()
            rec = next(cursor[0])
        return rec

    def source():
        data, labels = [], []
        for _ in range(batch):
            rec = next_record()
            if rec is None:
                break
            arr, label = datum_decode(rec[1])
            data.append(np.asarray(arr, dtype))
            labels.append(label if label is not None else 0)
        if not data:
            raise StopIteration
        return {"data": np.stack(data),
                "label": np.asarray(labels, np.int64)}

    return source


# -- minimal writer --------------------------------------------------------

def write_lmdb(path: str, items: List[Tuple[bytes, bytes]],
               *, psize: int = 4096) -> None:
    """Write a valid LMDB data file holding ``items`` (sorted by key).

    Single branch level: root branch page -> leaf pages, values that
    don't fit inline on overflow page runs. Capacity (~100k typical Caffe
    records) far exceeds test/export needs; for bulk production datasets
    the `.cerec` format remains the native choice."""
    items = sorted(items, key=lambda kv: kv[0])
    pages: List[bytes] = [b"", b""]  # meta placeholders

    def page_hdr(pgno, flags, lower, upper, overflow_pages=0):
        if flags & P_OVERFLOW:
            return struct.pack("<QHHI", pgno, 0, flags, overflow_pages)
        return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)

    def new_page() -> int:
        pages.append(b"")
        return len(pages) - 1

    inline_max = psize // 4  # conservative MDB_node data threshold

    leaf_entries: List[Tuple[int, bytes]] = []  # (leaf pgno, first key)
    cur_nodes: List[bytes] = []
    cur_first: Optional[bytes] = None

    def flush_leaf():
        nonlocal cur_nodes, cur_first
        if not cur_nodes:
            return
        pgno = new_page()
        lower = PAGEHDRSZ + 2 * len(cur_nodes)
        pos0 = psize - sum(len(nb) for nb in cur_nodes)
        blob = bytearray(psize)
        hdr = page_hdr(pgno, P_LEAF, lower, pos0)
        blob[:len(hdr)] = hdr
        p = pos0
        for i, nb in enumerate(cur_nodes):
            struct.pack_into("<H", blob, PAGEHDRSZ + 2 * i, p)
            blob[p:p + len(nb)] = nb
            p += len(nb)
        pages[pgno] = bytes(blob)
        leaf_entries.append((pgno, cur_first))
        cur_nodes, cur_first = [], None

    def leaf_node(key: bytes, val: bytes) -> bytes:
        dsize = len(val)
        if dsize > inline_max:
            npages = -(-(PAGEHDRSZ + dsize) // psize)
            ovpg = len(pages)
            blob = page_hdr(ovpg, P_OVERFLOW, 0, 0, npages) + val
            blob += b"\0" * (npages * psize - len(blob))
            for i in range(npages):  # the run occupies npages file pages
                pages.append(blob[i * psize:(i + 1) * psize])
            return (struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16,
                                F_BIGDATA, len(key))
                    + key + struct.pack("<Q", ovpg))
        return (struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, 0,
                            len(key)) + key + val)

    for key, val in items:
        nb = leaf_node(key, val)
        used = PAGEHDRSZ + sum(2 + len(x) for x in cur_nodes)
        if cur_nodes and used + 2 + len(nb) > psize:
            flush_leaf()
        if cur_first is None:
            cur_first = key
        cur_nodes.append(nb)
    flush_leaf()

    # root: single leaf if one page, else one branch page
    if len(leaf_entries) == 1:
        root = leaf_entries[0][0]
        depth = 1
    else:
        root = new_page()
        nodes = []
        for pgno, first in leaf_entries:
            lo, hi, fl = pgno & 0xFFFF, (pgno >> 16) & 0xFFFF, pgno >> 32
            nodes.append(struct.pack("<HHHH", lo, hi, fl, len(first))
                         + first)
        lower = PAGEHDRSZ + 2 * len(nodes)
        pos0 = psize - sum(len(nb) for nb in nodes)
        if pos0 < lower:
            raise ValueError("write_lmdb: too many leaf pages for a "
                             "single branch level")
        blob = bytearray(psize)
        hdr = page_hdr(root, P_BRANCH, lower, pos0)
        blob[:len(hdr)] = hdr
        p = pos0
        for i, nb in enumerate(nodes):
            struct.pack_into("<H", blob, PAGEHDRSZ + 2 * i, p)
            blob[p:p + len(nb)] = nb
            p += len(nb)
        pages[root] = bytes(blob)
        depth = 2

    last_pg = len(pages) - 1

    def meta(pgno, txnid):
        hdr = struct.pack("<QHHHH", pgno, 0, P_META, 0, 0)
        body = struct.pack("<II", MDB_MAGIC, 1)
        body += struct.pack("<QQ", 0, max(psize * (last_pg + 1), 1 << 20))
        free_db = struct.pack(_DB_FMT, 0, 0, 0, 0, 0, 0, 0, -1)
        main_db = struct.pack(_DB_FMT, 0, 0, depth, 0, len(leaf_entries),
                              0, len(items), root)
        tail = struct.pack("<QQ", last_pg, txnid)
        blob = hdr + body + free_db + main_db + tail
        return blob + b"\0" * (psize - len(blob))

    pages[0] = meta(0, 1)
    pages[1] = meta(1, 2)

    target = _data_file(path)
    if os.path.isdir(path) or target.endswith("data.mdb"):
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
    with open(target, "wb") as fh:
        for pg in pages:
            if pg:
                fh.write(pg)
            else:
                fh.write(b"\0" * psize)
