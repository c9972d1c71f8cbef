"""Explicit collectives over the flat mesh: the reduce-scatter/all-gather
ring with an optional int8 wire format, and the fingerprint merge of the
sharded analyze.

The ring is the reference's (``repro/runtime/collectives.py``) hop for hop:
with ``n`` ranks the flat payload is padded with 0 to ``n`` equal chunks;
over ``n - 1`` reduce-scatter hops rank ``me`` sends its partial of chunk
``(me - i) % n`` to the next rank and combines what the previous rank sent
into chunk ``(me - i - 1) % n``; over ``n - 1`` all-gather hops the fully
reduced chunks circulate.  Each hop is one ``dist.batch_isend_irecv`` pair
(to the next rank, from the previous one) on host tensors: the port's
collectives run on gloo, so payloads are staged on the host.

``op`` is ``add``, ``xor`` or ``max`` — associative and commutative, 0 their
identity on the non-negative payloads used here.  With ``compress=True``
(``add`` only) every hop's wire format is an int8 payload plus its float32
scale (max-abs/127), and accumulation happens in float32 after dequantize,
so error does not compound multiplicatively with ring length.

``merge_fingerprint_shards`` merges each rank's ``ColumnFingerprints``: counts
and hash sums by wrapping int32 ``add``, the xor hash by ``xor``, the
subdiagonal flags by ``max``; ``seen`` rides an ``add`` ring so overlapping
shards are caught on every rank.  ``ColumnFingerprints.merge`` is its host
oracle.  On a one-shard mesh every ring is the identity.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

_RING_OPS = ("add", "xor", "max")


def quantize(g: torch.Tensor):
    """Int8 wire format of one ring hop: max-abs/127 scale, rounding half to
    even (``jnp.round``'s), clipped to [-127, 127]."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(g32.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "add":
        return a + b
    if op == "xor":
        return torch.bitwise_xor(a, b)
    return torch.maximum(a, b)


def _hop(mesh, send: torch.Tensor, compress: bool) -> torch.Tensor:
    """Send ``send`` to the next rank and return what the previous rank sent,
    through the wire format (int8 payload + float32 scale when
    ``compress``)."""
    if compress:
        q, s = quantize(send)
        send = torch.cat([q, s.reshape(1).view(torch.int8)])
    recv = torch.empty_like(send)
    nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group=mesh.group),
        dist.P2POp(dist.irecv, recv, prv, group=mesh.group)])
    for req in reqs:
        req.wait()
    if compress:
        return dequantize(recv[:-4], recv[-4:].clone().view(torch.float32)[0])
    return recv


def ring_allreduce(x: torch.Tensor, mesh, *, op: str = "add",
                   compress: bool = False) -> torch.Tensor:
    """All-reduce of this rank's ``x`` (the same shape on every rank) over
    the reduce-scatter + all-gather ring; returns the reduced tensor, of
    ``x``'s shape and dtype, on the host."""
    if op not in _RING_OPS:
        raise ValueError(f"unknown ring op {op!r}; pick from {_RING_OPS}")
    if compress and op != "add":
        raise ValueError(f"int8 compression only supports op='add', "
                         f"got {op!r}")
    n = mesh.size
    if n == 1:
        return x
    flat = x.detach().reshape(-1).cpu()
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    # compressed rings accumulate in float32 after dequantize; exact rings
    # (the integer fingerprint merges) stay in the payload dtype
    acc = (flat.to(torch.float32) if compress else flat.clone()).reshape(n, -1)
    me = mesh.rank
    for i in range(n - 1):                       # reduce-scatter
        recv = _hop(mesh, acc[(me - i) % n].contiguous(), compress)
        tgt = (me - i - 1) % n
        acc[tgt] = _combine(op, acc[tgt], recv.to(acc.dtype))
    for i in range(n - 1):                       # all-gather
        recv = _hop(mesh, acc[(me + 1 - i) % n].contiguous(), compress)
        acc[(me - i) % n] = recv.to(acc.dtype)
    out = acc.reshape(-1)[:x.numel()].reshape(x.shape)
    return out.to(x.dtype)


def merge_fingerprint_shards(mesh, axis: str, shard):
    """Merge this rank's ``ColumnFingerprints`` with every other rank's on
    the mesh axis ``axis``; every rank gets the merged one, bitwise
    ``ColumnFingerprints.merge`` folded over the shards.  The shards must be
    disjoint (the sharded analyze masks ownership before accumulating):
    overlapping ones raise ``ValueError`` on every rank."""
    from repro_torch.supernodes.fingerprint import ColumnFingerprints

    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{mesh.axis_names}")
    # the uint32 hashes wrap identically in int32 two's complement
    parts = {
        "counts": ("add", shard.counts.astype(np.int32)),
        "hsum": ("add", shard.hsum.view(np.int32)),
        "hxor": ("xor", shard.hxor.view(np.int32)),
        "subdiag": ("max", shard.subdiag.astype(np.int32)),
        "seen": ("add", shard.seen.astype(np.int32)),
    }
    out = {name: ring_allreduce(torch.from_numpy(np.array(arr)), mesh,
                                op=op).numpy()
           for name, (op, arr) in parts.items()}
    if (out["seen"] > 1).any():
        raise ValueError(
            f"cannot merge overlapping fingerprint shards: rows "
            f"{np.flatnonzero(out['seen'] > 1)[:8].tolist()}... seen on "
            f"several ranks")
    merged = ColumnFingerprints(n=shard.n)
    merged.counts = out["counts"].astype(np.int64)
    merged.hsum = out["hsum"].view(np.uint32).copy()
    merged.hxor = out["hxor"].view(np.uint32).copy()
    merged.subdiag = out["subdiag"].astype(bool)
    merged.seen = out["seen"] > 0
    return merged
