"""Pure-Python LMDB reader/writer (no liblmdb dependency).

A copy of ``realvsr_tpu/data/lmdb_lite.py`` (standard library only), kept
here so the PyTorch package imports nothing of the JAX one.  The
reference's primary training I/O path stores raw uint8 frame buffers in
LMDB environments (``codes/data/RealVSR_dataset.py:68-74``,
``data/util.py:76-84``).  Without depending on the ``lmdb`` binding, this
module implements the LMDB on-disk format directly:

  * meta pages 0/1 (magic 0xBEEFC0DE, version 1, dual MDB_db headers,
    reader picks the larger txnid),
  * B-tree branch/leaf pages with the 8-byte node headers
    (mn_lo/mn_hi/mn_flags/mn_ksize), 2-byte-aligned nodes packed downward
    from ``pb_upper`` with the pointer array growing from ``pb_lower``,
  * F_BIGDATA leaf nodes spilling values onto contiguous overflow pages.

The reader memory-maps ``data.mdb`` and walks the tree; the writer bulk-
builds a static environment from sorted (key, value) pairs.  Both ends
interoperate with liblmdb-produced/consumed files (same layout rules:
branch child pgno in lo|hi<<16|flags<<32, leaf datasize in lo|hi<<16).

API mirrors the subset of the ``lmdb`` binding the reference uses::

    env = lmdb_lite.open(path, readonly=True)
    with env.begin() as txn:
        buf = txn.get(key_bytes)
    write_lmdb(path, items, map_size=...)
"""
from __future__ import annotations

import mmap
import os
import os.path as osp
import struct

MAGIC = 0xBEEFC0DE
VERSION = 1
PAGEHDRSZ = 16
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF


def _even(n: int) -> int:
    return (n + 1) & ~1


class _Node:
    __slots__ = ("lo", "hi", "flags", "key", "data_off", "page_off")

    def __init__(self, buf, off):
        self.lo, self.hi, self.flags, ksize = struct.unpack_from(
            "<HHHH", buf, off)
        self.key = bytes(buf[off + 8:off + 8 + ksize])
        self.data_off = off + 8 + ksize
        self.page_off = off

    @property
    def pgno(self) -> int:  # branch child page
        return self.lo | (self.hi << 16) | (self.flags << 32)

    @property
    def dsize(self) -> int:  # leaf data size
        return self.lo | (self.hi << 16)


class Transaction:
    def __init__(self, env):
        self._env = env

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def get(self, key: bytes, default=None):
        return self._env._get(key, default)

    def cursor(self):
        return Cursor(self._env)

    def stat(self):
        return {"entries": self._env.entries}


class Cursor:
    def __init__(self, env):
        self._env = env

    def __iter__(self):
        return self._env._iter_items()

    def iternext(self, keys=True, values=True):
        for k, v in self._env._iter_items():
            if keys and values:
                yield k, v
            elif keys:
                yield k
            else:
                yield v


class Environment:
    def __init__(self, path: str, readonly: bool = True, **_ignored):
        assert readonly, "lmdb_lite opens existing environments read-only; " \
                         "use write_lmdb() to create one"
        import builtins

        data = path if path.endswith(".mdb") else osp.join(path, "data.mdb")
        self._f = builtins.open(data, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        # liblmdb tolerates one torn/corrupt meta page by failing over to
        # the other; mirror that: a bad meta 0 must not poison the psize
        # probe for meta 1 (tried at the common page sizes)
        try:
            m0 = self._read_meta(0)
        except ValueError:
            m0 = None
        try:
            m1 = self._read_meta(1)
        except ValueError:
            m1 = None
        if m0 is None and m1 is None:
            raise ValueError("not an LMDB data file (both meta pages invalid)")
        if m0 is None:
            meta = m1
        elif m1 is None:
            meta = m0
        else:
            meta = m0 if m0["txnid"] >= m1["txnid"] else m1
        self.psize = meta["psize"]
        self.root = meta["root"]
        self.entries = meta["entries"]

    def _read_meta(self, pageno: int) -> dict:
        # meta candidates live on the first two pages; page size is not yet
        # known.  Validate meta 0's magic BEFORE trusting its psize field;
        # if meta 0 is torn, locate meta 1 by probing the default page sizes
        base0 = PAGEHDRSZ
        if pageno == 0:
            base = base0
        else:
            m0_magic, = struct.unpack_from("<I", self._mm, base0)
            psize0 = struct.unpack_from("<I", self._mm, base0 + 24)[0]
            candidates = [psize0] if m0_magic == MAGIC and psize0 else []
            candidates += [4096, 8192, 16384, 32768]
            base = None
            for ps in candidates:
                if ps + PAGEHDRSZ + 136 > len(self._mm):
                    continue
                magic, = struct.unpack_from("<I", self._mm, ps + PAGEHDRSZ)
                if magic == MAGIC:
                    base = ps + PAGEHDRSZ
                    break
            if base is None:
                raise ValueError("meta page 1 not found at any page size")
        magic, version = struct.unpack_from("<II", self._mm, base)
        if magic != MAGIC or version > 2:
            raise ValueError(f"not an LMDB data file (magic {magic:#x})")
        (psize,) = struct.unpack_from("<I", self._mm, base + 24)
        main = base + 72  # MDB_db struct of the MAIN dbi
        entries, = struct.unpack_from("<Q", self._mm, main + 32)
        root, = struct.unpack_from("<Q", self._mm, main + 40)
        txnid, = struct.unpack_from("<Q", self._mm, base + 128)
        return {"psize": psize, "root": root, "entries": entries,
                "txnid": txnid}

    # ---------------------------------------------------------------- pages
    def _page(self, pgno: int):
        off = pgno * self.psize
        flags, = struct.unpack_from("<H", self._mm, off + 10)
        return off, flags

    def _page_nodes(self, off: int):
        lower, upper = struct.unpack_from("<HH", self._mm, off + 12)
        n = (lower - PAGEHDRSZ) >> 1
        ptrs = struct.unpack_from(f"<{n}H", self._mm, off + PAGEHDRSZ)
        return [(off + p) for p in ptrs]

    def _get(self, key: bytes, default=None):
        if self.root == P_INVALID:
            return default
        pgno = self.root
        while True:
            off, flags = self._page(pgno)
            node_offs = self._page_nodes(off)
            if flags & P_BRANCH:
                # rightmost child whose separator key <= target (node 0 is
                # the leftmost fallback; liblmdb leaves its key unused)
                child = _Node(self._mm, node_offs[0]).pgno
                for noff in node_offs[1:]:
                    nd = _Node(self._mm, noff)
                    if nd.key <= key:
                        child = nd.pgno
                    else:
                        break
                pgno = child
            elif flags & P_LEAF:
                lo_i, hi_i = 0, len(node_offs) - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    nd = _Node(self._mm, node_offs[mid])
                    if nd.key == key:
                        return self._node_data(nd)
                    if nd.key < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return default
            else:
                raise ValueError(f"unexpected page flags {flags:#x}")

    def _node_data(self, nd: _Node) -> bytes:
        if nd.flags & F_BIGDATA:
            ovf_pgno, = struct.unpack_from("<Q", self._mm, nd.data_off)
            start = ovf_pgno * self.psize + PAGEHDRSZ
            return bytes(self._mm[start:start + nd.dsize])
        return bytes(self._mm[nd.data_off:nd.data_off + nd.dsize])

    def _iter_items(self):
        if self.root == P_INVALID:
            return
        stack = [self.root]
        leaves = []

        def walk(pgno):
            off, flags = self._page(pgno)
            if flags & P_BRANCH:
                for noff in self._page_nodes(off):
                    walk(_Node(self._mm, noff).pgno)
            else:
                for noff in self._page_nodes(off):
                    nd = _Node(self._mm, noff)
                    leaves.append((nd.key, self._node_data(nd)))

        walk(self.root)
        yield from leaves

    def begin(self, write: bool = False, **_ignored) -> Transaction:
        assert not write
        return Transaction(self)

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def open(path: str, readonly: bool = True, **kwargs) -> Environment:  # noqa: A001
    return Environment(path, readonly=readonly, **kwargs)


# ------------------------------------------------------------------- writer
def write_lmdb(path: str, items, psize: int = 4096,
               subdir: bool = True) -> None:
    """Bulk-create a static LMDB environment from (key, value) byte pairs.

    Keys are sorted internally; duplicate keys are rejected.  Layout is
    the standard LMDB B-tree built bottom-up (leaf pages → branch levels).
    """
    items = sorted((bytes(k), bytes(v)) for k, v in items)
    for (k1, _), (k2, _) in zip(items, items[1:]):
        if k1 == k2:
            raise ValueError(f"duplicate key {k1!r}")
    nodemax = (psize - PAGEHDRSZ) // 2 & ~1

    pages: list[bytes] = []  # data pages, index 0 == pgno 2

    def add_page(raw: bytes) -> int:
        pages.append(raw)
        return len(pages) + 1  # pgno (0/1 are meta)

    n_overflow = 0

    def page_header(pgno, flags, lower=None, upper=None, ovf_pages=None):
        hdr = struct.pack("<QHH", pgno, 0, flags)
        if ovf_pages is not None:
            hdr += struct.pack("<I", ovf_pages)
        else:
            hdr += struct.pack("<HH", lower, upper)
        return hdr

    def build_level(entries, leaf: bool):
        """entries: (key, payload) — payload is value bytes for leaves,
        child pgno for branches.  Returns [(first_key, pgno)]."""
        nonlocal n_overflow
        out = []
        cur: list[tuple[bytes, bytes, int]] = []  # (key, node_body, size)
        lower, upper = PAGEHDRSZ, psize

        def flush():
            nonlocal cur, lower, upper
            if not cur:
                return
            pgno = len(pages) + 2
            body = bytearray(psize)
            up = psize
            ptrs = []
            for _, node, sz in cur:
                up -= sz
                body[up:up + len(node)] = node
                ptrs.append(up)
            low = PAGEHDRSZ + 2 * len(ptrs)
            hdr = page_header(pgno, P_LEAF if leaf else P_BRANCH,
                              lower=low, upper=up)
            body[:len(hdr)] = hdr
            struct.pack_into(f"<{len(ptrs)}H", body, PAGEHDRSZ, *ptrs)
            add_page(bytes(body))
            out.append((cur[0][0], pgno))
            cur = []
            lower, upper = PAGEHDRSZ, psize

        for key, payload in entries:
            if leaf:
                dlen = len(payload)
                if 8 + len(key) + dlen > nodemax:
                    # spill to contiguous overflow pages
                    npg = (PAGEHDRSZ - 1 + dlen) // psize + 1
                    ovf_pgno = len(pages) + 2
                    raw = page_header(ovf_pgno, P_OVERFLOW, ovf_pages=npg)
                    raw = raw + payload
                    raw += b"\0" * (npg * psize - len(raw))
                    for i in range(npg):
                        add_page(raw[i * psize:(i + 1) * psize])
                    n_overflow += npg
                    node = struct.pack("<HHHH", dlen & 0xFFFF, dlen >> 16,
                                       F_BIGDATA, len(key)) + key + \
                        struct.pack("<Q", ovf_pgno)
                else:
                    node = struct.pack("<HHHH", dlen & 0xFFFF, dlen >> 16,
                                       0, len(key)) + key + payload
            else:
                child = payload
                node = struct.pack("<HHHH", child & 0xFFFF,
                                   (child >> 16) & 0xFFFF,
                                   (child >> 32) & 0xFFFF, len(key)) + key
            sz = _even(len(node))
            if lower + 2 + sz > upper:
                flush()
            lower += 2
            upper -= sz
            cur.append((key, node, sz))
        flush()
        return out

    n_leaf = n_branch = depth = 0
    if items:
        level = build_level(items, leaf=True)
        n_leaf = len(level)
        depth = 1
        while len(level) > 1:
            level = build_level([(k, pg) for k, pg in level], leaf=False)
            n_branch += len(level)
            depth += 1
        root = level[0][1]
    else:
        root = P_INVALID

    last_pg = len(pages) + 1

    def meta_page(pgno):
        body = bytearray(psize)
        body[:16] = page_header(pgno, P_META, lower=0, upper=0)
        o = PAGEHDRSZ
        struct.pack_into("<II", body, o, MAGIC, VERSION)
        struct.pack_into("<QQ", body, o + 8, 0, (last_pg + 1) * psize)
        # FREE db: psize in md_pad, empty tree
        struct.pack_into("<IHH", body, o + 24, psize, 0, 0)
        struct.pack_into("<QQQQQ", body, o + 32, 0, 0, 0, 0, P_INVALID)
        # MAIN db
        struct.pack_into("<IHH", body, o + 72, 0, 0, depth)
        struct.pack_into("<QQQQQ", body, o + 80, n_branch, n_leaf,
                         n_overflow, len(items), root)
        struct.pack_into("<QQ", body, o + 120, last_pg, 1)  # last_pg, txnid
        return bytes(body)

    import builtins

    if subdir and not path.endswith(".mdb"):
        os.makedirs(path, exist_ok=True)
        data_path = osp.join(path, "data.mdb")
        with builtins.open(osp.join(path, "lock.mdb"), "wb"):
            pass
    else:
        data_path = path
    with builtins.open(data_path, "wb") as f:
        f.write(meta_page(0))
        f.write(meta_page(1))
        for raw in pages:
            f.write(raw)
