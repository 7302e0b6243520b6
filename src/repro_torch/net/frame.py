"""Wire format of the socket control plane: the port of
``repro/net/frame.py``, bit for bit (``docs/WIRE_PROTOCOL.md``).

One frame = a fixed 32-byte little-endian header + an opaque payload:

    magic  4s   b"RPN1"  (repro net, version 1)
    op     u16  opcode (request or reply)
    flags  u16  op-specific small integer (e.g. batch lane count)
    word   i64  THE version/result word: a parameter pull carries the
                client's version out and the server's version back in
                this header field, so an unchanged pull is one 32-byte
                request + one 32-byte reply with ZERO payload bytes
    aux    i64  op-specific integer (store id / collector id / timeout)
    len    u64  payload byte count

Integrity is TCP's: a torn write surfaces as a short read or a bad magic,
both raised as :class:`ProtocolError`; readers degrade to their cached
value and never decode a torn frame.

Two payload encodings ride the frames:

* fixed-structure parameter payloads: the leaves of
  ``checkpoint/io.LeafCodec`` concatenated in codec order, storable
  dtypes, no padding (``encode_leaves`` / ``decode_leaves``);
* self-describing trajectory payloads ("tree frames"): a u32-length JSON
  header (keys, dtypes, shapes) + concatenated C-order buffers
  (``encode_tree`` / ``decode_tree``). Leaves are numpy arrays or torch
  tensors; bf16 rides as its uint16 bits through torch's own dtype views
  and is named ``"bfloat16"``, as in checkpoints. A decoded tree holds CPU
  tensors.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import (_dtype_name, _from_storable,
                                       _to_storable)

MAGIC = b"RPN1"
_HDR = struct.Struct("<4sHHqqQ")
HEADER_SIZE = _HDR.size            # 32

# ---- opcodes ---------------------------------------------------------
# parameter stores (aux = store id)
OP_PPUSH = 1        # payload=leaf bytes            -> OK word=new version
OP_PPULL = 2        # word=client version           -> OK word=version,
                    #   payload empty (unchanged) or leaf bytes (changed)
OP_PVER = 3         #                               -> OK word=version
OP_PMETA = 4        #                               -> OK payload=codec blob
OP_PINIT = 5        # payload=codec blob (idempotent) -> OK
# the data server (aux = collector id)
OP_DPUSH = 10       # flags=n lanes, word=timeout ms, payload=tree frame
                    #   -> OK word=total | FULL word=maxsize
OP_DCLAIM = 12      # word=k                        -> OK word=granted
OP_DREFUND = 13     #                               -> OK word=refunded
OP_DDRAIN = 14      #          -> OK word=item count, payload=item list
OP_DTOTAL = 15      #                               -> OK word=total
OP_DTARGET = 16     # word=target                   -> OK
OP_DLEN = 17        #                               -> OK word=pending items
# control
OP_JOIN = 20        #                -> OK payload=pickled join ticket
# replies
OP_OK = 100
OP_ERR = 101        # payload=utf-8 message (re-raised client-side)
OP_FULL = 102       # data push timed out on a full queue


class ProtocolError(RuntimeError):
    """A frame failed to parse: short read, bad magic, or truncated
    payload. The connection is unusable and must be closed; client pulls
    degrade to their cache like a seqlock reader seeing a crashed
    writer."""


def pack_frame(op: int, *, word: int = 0, aux: int = 0, flags: int = 0,
               payload: bytes = b"") -> bytes:
    return _HDR.pack(MAGIC, op, flags, word, aux, len(payload)) + payload


def send_frame(sock, op: int, *, word: int = 0, aux: int = 0,
               flags: int = 0, payload: bytes = b"") -> None:
    sock.sendall(pack_frame(op, word=word, aux=aux, flags=flags,
                            payload=payload))


def recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`ProtocolError`: a peer
    dying mid-frame can only produce a short read here."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock) -> Tuple[int, int, int, int, bytes]:
    """-> (op, word, aux, flags, payload). Raises ProtocolError on a short
    read or a bad magic; never returns a torn frame."""
    hdr = recv_exact(sock, HEADER_SIZE)
    magic, op, flags, word, aux, plen = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r}")
    payload = recv_exact(sock, plen) if plen else b""
    return op, word, aux, flags, payload


# ---- fixed-structure parameter payloads (LeafCodec both ends) --------
def encode_leaves(codec, tree) -> bytes:
    """Tree -> one byte string: the codec's storable leaves concatenated in
    codec order (the receiver's codec fixes the sizes)."""
    return b"".join(a.tobytes() for a in codec.encode(tree))


def decode_leaves(codec, payload: bytes):
    """Inverse of :func:`encode_leaves` -> tree of tensors of the codec's
    dtypes. Raises ProtocolError if the payload length does not match the
    codec (a torn or foreign frame never decodes)."""
    expect = sum(codec.nbytes)
    if len(payload) != expect:
        raise ProtocolError(
            f"parameter payload is {len(payload)} bytes, codec needs "
            f"{expect}")
    out, off = [], 0
    for sd, sh, n in zip(codec.storable_dtypes, codec.shapes, codec.nbytes):
        count = int(np.prod(sh, dtype=np.int64))
        out.append(np.frombuffer(payload, dtype=sd, count=count,
                                 offset=off).reshape(sh))
        off += int(n)
    return codec.decode(out)


# ---- self-describing trajectory payloads ("tree frames") -------------
def encode_tree(d: Dict[str, object]) -> bytes:
    """Flat dict of arrays or tensors -> u32 JSON-header length + JSON
    (keys, dtypes, storable dtypes, shapes) + the concatenated C-order
    storable buffers."""
    keys = list(d.keys())
    arrs = [np.ascontiguousarray(_to_storable(d[k])) for k in keys]
    meta = json.dumps({
        "keys": keys,
        "dtypes": [_dtype_name(d[k]) for k in keys],
        "sdtypes": [a.dtype.str for a in arrs],
        "shapes": [list(a.shape) for a in arrs],
    }).encode()
    return struct.pack("<I", len(meta)) + meta \
        + b"".join(a.tobytes() for a in arrs)


def decode_tree(payload: bytes) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`encode_tree` -> dict of CPU tensors. Raises
    ProtocolError on any truncation or header/buffer mismatch."""
    if len(payload) < 4:
        raise ProtocolError("tree frame shorter than its length prefix")
    (jlen,) = struct.unpack_from("<I", payload, 0)
    if len(payload) < 4 + jlen:
        raise ProtocolError("tree frame truncated inside JSON header")
    try:
        meta = json.loads(payload[4:4 + jlen])
        keys = meta["keys"]
        dtypes = meta["dtypes"]
        sdtypes = [np.dtype(s) for s in meta["sdtypes"]]
        shapes = [tuple(s) for s in meta["shapes"]]
    except (ValueError, KeyError, TypeError) as e:
        raise ProtocolError(f"garbled tree-frame header: {e}") from None
    off = 4 + jlen
    out: Dict[str, torch.Tensor] = {}
    for k, dt, sd, sh in zip(keys, dtypes, sdtypes, shapes):
        count = int(np.prod(sh, dtype=np.int64))
        need = count * sd.itemsize
        if len(payload) < off + need:
            raise ProtocolError(f"tree frame truncated in leaf {k!r}")
        arr = np.frombuffer(payload, dtype=sd, count=count,
                            offset=off).reshape(sh)
        out[k] = _from_storable(arr, dt, "cpu")
        off += need
    return out


def pack_drain_items(items: List[Tuple[int, bytes]]) -> bytes:
    """Drain reply payload: per queued item, u32 lane count + u32 byte
    length + the item's tree frame."""
    parts = []
    for n, blob in items:
        parts.append(struct.pack("<II", n, len(blob)))
        parts.append(blob)
    return b"".join(parts)


def unpack_drain_items(payload: bytes, count: int) -> List[Tuple[int, bytes]]:
    items, off = [], 0
    for _ in range(count):
        if len(payload) < off + 8:
            raise ProtocolError("drain reply truncated in item header")
        n, blen = struct.unpack_from("<II", payload, off)
        off += 8
        if len(payload) < off + blen:
            raise ProtocolError("drain reply truncated in item body")
        items.append((n, payload[off:off + blen]))
        off += blen
    return items
