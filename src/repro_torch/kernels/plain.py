"""Plain PyTorch versions of the port's CUDA kernels.

The counterpart of ``repro/kernels/ref.py``: each function computes what its
kernel in ``kernels/csrc/`` computes, with ordinary tensor operations.  The
dispatch layer (``kernels/ops.py``) runs them for tensors that lie on the
CPU — which is how the CPU tests drive the whole path — and ``chip_smoke.py``
holds every kernel against them on the card.  They repeat the kernels'
arithmetic and are no yardstick of speed.
"""
from __future__ import annotations

import contextlib

import torch

INF = 2 ** 31 - 1          # int32 max: identity of the masked min


def minmax_relax_plain(prop: torch.Tensor, adj: torch.Tensor, *,
                       max_elems: int = 1 << 26) -> torch.Tensor:
    """``out[s, v] = min_u (adj[u, v] != 0 ? prop[s, u] : INF)`` for int32
    ``prop`` (S, U) and 0/1 ``adj`` (U, V).  The u axis is walked in chunks
    so the (S, chunk, V) broadcast stays under ``max_elems`` elements."""
    s, u = prop.shape
    v = adj.shape[1]
    out = torch.full((s, v), INF, dtype=torch.int32, device=prop.device)
    if s == 0 or v == 0:
        return out
    step = max(1, max_elems // (s * v))
    for u0 in range(0, u, step):
        edge = adj[u0:u0 + step] != 0                        # (c, V)
        masked = torch.where(edge[None], prop[:, u0:u0 + step, None], INF)
        out = torch.minimum(out, masked.amin(dim=1))
    return out


def ell_prop_plain(labels: torch.Tensor, srcs: torch.Tensor,
                   offset: int = 0) -> torch.Tensor:
    """Clamped propagation values of ``labels`` (S, n), in the offset
    encoding: ``max(offset + u, labels[s, u])`` where u is expandable
    (``u < srcs[s]``, label valid in the window: ``<= offset + n``), else
    INF."""
    n = labels.shape[1]
    u_ids = torch.arange(n, dtype=torch.int32, device=labels.device)
    ok = (labels <= offset + n) & (u_ids[None, :] < srcs[:, None])
    return torch.where(ok, torch.maximum(u_ids[None, :] + offset, labels),
                       INF)


def ell_relax_plain(prop: torch.Tensor, in_ell: torch.Tensor) -> torch.Tensor:
    """Candidate labels by ELL gather: ``cand[s, v] = min_k prop[s,
    in_ell[v, k]]`` over the (n, K) in-neighbour table, pad id n reading
    INF.  Walks the K slots one at a time (min is exact in any order), so
    the scratch is one (S, n) gather, not (S, n, K)."""
    pad = torch.cat([prop, torch.full((prop.shape[0], 1), INF,
                                      dtype=torch.int32,
                                      device=prop.device)], dim=1)
    cand = torch.full_like(prop, INF)
    for k in range(in_ell.shape[1]):
        cand = torch.minimum(cand, pad.index_select(1, in_ell[:, k].long()))
    return cand


def ell_superstep_plain(labels: torch.Tensor, out: torch.Tensor,
                        in_ell: torch.Tensor, out_deg: torch.Tensor,
                        srcs: torch.Tensor, edges: torch.Tensor,
                        conv: torch.Tensor, flag: torch.Tensor, *,
                        offset: int, it: int) -> None:
    """One superstep of the ELL fixpoint, as ``core/gsofa.py`` ran it op by
    op: the clamped props of ``labels`` (S, n) and, for ``it`` >= 1, of the
    previous labels in ``out``; the frontier where they differ; its
    out-degree sums into ``edges`` and ``it + 1`` into ``conv`` for rows
    with a frontier and into ``flag`` (1,) when any row has one; then the
    min over the ``in_ell`` (n, K) slots, pad id n reading INF, and
    ``min(labels, cand)`` into ``out``.  Everything int32, in place."""
    cur = ell_prop_plain(labels, srcs, offset)
    prev = (ell_prop_plain(out, srcs, offset) if it > 0
            else torch.full_like(cur, INF))
    frontier = cur != prev
    row_active = frontier.any(dim=1)
    edges.copy_(edges + torch.where(frontier, out_deg[None, :], 0).sum(
        dim=1).to(torch.int32))
    conv.copy_(torch.where(row_active, it + 1, conv))
    flag.copy_(torch.where(row_active.any(), it + 1, flag))
    out.copy_(torch.minimum(labels, ell_relax_plain(cur, in_ell)))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), as an int32 sum
    wraps.  ``torch.sum`` of int32 returns int64, so the wrap is explicit."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """xor over axis 0 — torch has no xor reduction, so fold pairwise."""
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        x = x[0::2] ^ x[1::2]
    return x[0]


def column_fingerprints_plain(rel: torch.Tensor, src: torch.Tensor,
                              m1: torch.Tensor, m2: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """(3, V) int32 per-column fingerprints of an (S, V) relative-label
    chunk: over rows with ``rel < v``, ``src > v`` and ``valid != 0``, the
    count, the sum of ``m1`` mod 2^32 and the xor of ``m2``."""
    v_ids = torch.arange(rel.shape[1], dtype=torch.int32, device=rel.device)
    mask = ((rel < v_ids[None, :]) & (src[:, None] > v_ids[None, :])
            & (valid[:, None] != 0))
    cnt = mask.sum(dim=0, dtype=torch.int64)
    hsum = torch.where(mask, m1[:, None].to(torch.int64), 0).sum(dim=0)
    hxor = _xor_reduce(torch.where(mask, m2[:, None], 0))
    return torch.stack([_wrap_int32(cnt), _wrap_int32(hsum), hxor])


@contextlib.contextmanager
def fp32_highest():
    """True float32 matmul for the block: no TF32 on the card."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def panel_update_plain(acc: torch.Tensor, l_panel: torch.Tensor,
                       u_panel: torch.Tensor) -> torch.Tensor:
    """(M, N) ``acc - l_panel @ u_panel`` in the inputs' dtype (float32
    or float64)."""
    with fp32_highest():
        return acc - l_panel @ u_panel


def panel_update_batched_plain(acc: torch.Tensor, l_panel: torch.Tensor,
                               u_panel: torch.Tensor) -> torch.Tensor:
    """(B, M, N) stacked ``acc - l_panel @ u_panel``, slice by slice
    through ``panel_update_plain`` so every slice is bitwise the per-panel
    result — K4's contract (``torch.bmm`` is not: its summation order
    depends on the batch size)."""
    if acc.shape[0] == 0:
        return acc
    return torch.stack([panel_update_plain(a, l, u)
                        for a, l, u in zip(acc, l_panel, u_panel)])


def panel_update_mapped_plain(flat: torch.Tensor, u: torch.Tensor,
                              lmap: torch.Tensor, tiles: torch.Tensor, *,
                              u_shift: int = 0, f32: bool = False,
                              systems: int = 1, flat_stride=None,
                              u_stride=None) -> None:
    """In place in ``flat``: for every slice of the tile records ``tiles``
    (one per record with ``m0 = n0 = 0``), ``acc - L @ U`` through
    ``panel_update_plain``, L gathered through ``lmap`` (-1 -> 0.0), in
    float64, or with acc, L and U rounded to float32 when ``f32``.  With
    ``systems`` > 1, the same records on each system's run of
    ``flat_stride`` entries of ``flat`` and ``u_stride`` of ``u`` (defaults:
    equal shares), one system after the other."""
    fs = flat.numel() // systems if flat_stride is None else flat_stride
    us = u.numel() // systems if u_stride is None else u_stride
    recs = [r for r in tiles.tolist() if not (r[6] or r[7])]
    for sy in range(systems):
        f = flat[sy * fs:(sy + 1) * fs]
        uu = u[sy * us:(sy + 1) * us]
        for acc_off, map_off, u_off, m, n, k, *_ in recs:
            lm = lmap[map_off:map_off + m * k].view(m, k).long()
            lp = torch.where(lm >= 0, f[lm.clamp(min=0)], 0.0)
            acc = f[acc_off:acc_off + m * n].view(m, n)
            b = uu[u_off - u_shift:u_off - u_shift + k * n].view(k, n)
            if f32:
                acc.copy_(panel_update_plain(acc.float(), lp.float(),
                                             b.float()))
            else:
                acc.copy_(panel_update_plain(acc, lp, b))


LOG2E = 1.4426950408889634   # K5 keeps its log-sum-exp in base 2


def _visible(s: int, t: int, causal: bool, window: int | None, device):
    """(S, T) bool: which keys each query sees (None: all of them).  Causal
    queries are the last S of T positions: query s sees keys ``<= s + (T -
    S)``, with a ``window`` only ``> s + (T - S) - window``: the band
    ``tril(t - s) & ~tril(t - s - window)``."""
    if not causal:
        return None
    ones = torch.ones((s, t), dtype=torch.bool, device=device)
    visible = ones.tril(t - s)
    if window:
        visible &= ~ones.tril(t - s - window)
    return visible


def _pad_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """x (B, live, ...) with zero heads appended up to h."""
    if x.shape[1] == h:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], h - x.shape[1])
                                     + tuple(x.shape[2:]))], dim=1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          kv_len: int | None = None,
                          live_heads: int | None = None,
                          window: int | None = None,
                          return_lse: bool = False):
    """Softmax attention of q (B, H, S, D) over the first ``kv_len``
    (default T) rows of k, v (B, Hkv, T, D), in float32, returned in q's
    dtype.  The KV heads are repeated ``live_heads // Hkv`` times
    (``jnp.repeat`` order) for the first ``live_heads`` (default H) query
    heads; the heads after them are zero.  Query s sees keys
    ``<= s + (kv_len - S)`` when ``causal`` (the queries are the last S
    positions), else all kv_len; with a ``window`` (causal only) just the
    keys ``> s + (kv_len - S) - window``, the band ``tril(t - s) &
    ~tril(t - s - window)``.  ``scale`` defaults to ``D ** -0.5``.  The
    (S, kv_len) scores are formed in full.  With ``return_lse`` also the
    float32 (B, H, S) log-sum-exp of the scaled scores in base 2 (K5's
    own: the natural one times log2(e)), 0 for the padded heads."""
    h, s = q.shape[1], q.shape[-2]
    live = h if live_heads is None else live_heads
    t = k.shape[-2] if kv_len is None else kv_len
    rep = live // k.shape[1]
    k, v = (x[:, :, :t].repeat_interleave(rep, dim=1) for x in (k, v))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with fp32_highest():
        logits = q[:, :live].float() @ k.float().transpose(-1, -2) * scale
        visible = _visible(s, t, causal, window, q.device)
        if visible is not None:
            logits = logits.masked_fill(~visible, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out = _pad_heads((probs @ v.float()).to(q.dtype), h)
    if not return_lse:
        return out
    return out, _pad_heads(torch.logsumexp(logits, dim=-1) * LOG2E, h)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   do: torch.Tensor, lse: torch.Tensor, *,
                                   causal: bool = True,
                                   scale: float | None = None,
                                   live_heads: int | None = None,
                                   window: int | None = None):
    """The gradient of ``flash_attention_plain`` (all T keys) for the
    upstream ``do``, from its output ``o`` and base-2 log-sum-exp ``lse``
    (B, H, S), in float32, returned in the inputs' dtypes: (dq (B, H, S,
    D), dk, dv (B, Hkv, T, D)).  With G = live_heads // Hkv and K, V
    repeated G times:

        P = exp2(scale * log2(e) * Q K^T - lse)  (0 where masked)
        dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O)
        dS = P * (dP - delta),  dQ = scale * dS K,  dK = scale * dS^T Q

    dK and dV summed over each KV head's G query heads; dq of the heads
    ``>= live_heads`` is zero and they add nothing to dk, dv."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    live = h if live_heads is None else live_heads
    rep = live // hkv
    if scale is None:
        scale = d ** -0.5
    with fp32_highest():
        qf, of, dof = (x[:, :live].float() for x in (q, o, do))
        kf, vf = (x.float().repeat_interleave(rep, dim=1) for x in (k, v))
        logits = qf @ kf.transpose(-1, -2) * (scale * LOG2E)
        p = torch.exp2(logits - lse[:, :live, :, None].float())
        visible = _visible(s, t, causal, window, q.device)
        if visible is not None:
            p = p.masked_fill(~visible, 0.0)
        dv = p.transpose(-1, -2) @ dof
        dp = dof @ vf.transpose(-1, -2)
        delta = (dof * of).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta)
        dq = ds @ kf * scale
        dk = ds.transpose(-1, -2) @ qf * scale
        dk, dv = (x.view(b, hkv, rep, t, d).sum(dim=2) for x in (dk, dv))
    return (_pad_heads(dq.to(q.dtype), h), dk.to(k.dtype), dv.to(v.dtype))


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rwkv6 time-mix recurrence from ``state``, one step at a time
    in the reference's order (``repro/models/rwkv6.py::_recurrence``):

        o_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t

    r, k, v, w (B, L, H, K); u (H, K); state (B, H, K, K) keyed
    [key, value].  Returns (o (B, L, H, K), the final state); ``state`` is
    not written."""
    s = state
    outs = []
    with fp32_highest():
        for t in range(r.shape[1]):
            r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
            kv = k_t[..., :, None] * v_t[..., None, :]       # (B, H, K, K)
            outs.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                     s + u[None, :, :, None] * kv))
            s = s * w_t[..., :, None] + kv
    o = torch.stack(outs, dim=1) if outs else torch.empty_like(r)
    return o, s.clone() if s is state else s


def mamba_scan_plain(x: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor,
                     c_t: torch.Tensor, a: torch.Tensor,
                     d_skip: torch.Tensor, h0: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective (S6) scan from ``h0``, one step at a time in the
    reference's order (``repro/models/mamba.py::_selective_scan``):

        h <- exp(dt_t A) * h + (dt_t x_t) (x) B_t,   y_t = h . C_t + D x_t

    x, dt (B, L, di); b_t, c_t (B, L, N); a (di, N); d_skip (di,); h0
    (B, di, N).  Returns (y (B, L, di), the final state); ``h0`` is not
    written."""
    h = h0
    ys = []
    with fp32_highest():
        for t in range(x.shape[1]):
            x_t, dt_t = x[:, t], dt[:, t]                    # (B, di)
            decay = torch.exp(dt_t[..., None] * a[None])     # (B, di, N)
            h = h * decay + (dt_t * x_t)[..., None] * b_t[:, t, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, c_t[:, t])
                      + d_skip[None] * x_t)
    y = torch.stack(ys, dim=1) if ys else torch.empty_like(x)
    return y, h.clone() if h is h0 else h


def rwkv6_scan_backward_plain(r: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, w: torch.Tensor,
                              u: torch.Tensor, state: torch.Tensor,
                              do: torch.Tensor, ds_final: torch.Tensor):
    """The gradient of ``rwkv6_scan_plain`` for the upstream ``do`` (B, L,
    H, K) of its output and ``ds_final`` (B, H, K, K) of its final state:
    (dr, dk, dv, dw (B, L, H, K), du (H, K), dstate (B, H, K, K)).

    The states S_0 = ``state`` .. S_{L-1} are recomputed first, then the
    walk goes back in time with G, the gradient of the state after step t
    (G = ``ds_final`` after the last step):

        dr_t = (S_{t-1} + diag(u) k_t^T v_t) do_t
        dk_t[i] = sum_j (u_i r_t[i] do_t[j] + G[i][j]) v_t[j]
        dv_t[j] = sum_i (u_i r_t[i] k_t[i] do_t[j] + G[i][j] k_t[i])
        dw_t[i] = sum_j G[i][j] S_{t-1}[i][j]
        du += r_t * k_t * (v_t . do_t)   (summed over B too)
        G <- diag(w_t) G + r_t^T do_t

    and dstate is G after the first step."""
    b, l, h, kk = r.shape
    with fp32_highest():
        states = [state]
        for t in range(l):
            states.append(states[-1] * w[:, t, ..., None]
                          + k[:, t, ..., None] * v[:, t, :, None, :])
        g = ds_final.clone()
        dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
        du = torch.zeros_like(u)
        for t in reversed(range(l)):
            r_t, k_t, v_t, w_t, do_t = (x[:, t] for x in (r, k, v, w, do))
            s_prev = states[t]
            vdo = (v_t * do_t).sum(-1, keepdim=True)           # (B, H, 1)
            ruk = (r_t * u * k_t).sum(-1, keepdim=True)
            dr[:, t] = (torch.einsum("bhij,bhj->bhi", s_prev, do_t)
                        + u * k_t * vdo)
            dk[:, t] = torch.einsum("bhij,bhj->bhi", g, v_t) + u * r_t * vdo
            dv[:, t] = torch.einsum("bhij,bhi->bhj", g, k_t) + do_t * ruk
            dw[:, t] = (g * s_prev).sum(-1)
            du += (r_t * k_t * vdo).sum(0)
            g = g * w_t[..., None] + r_t[..., None] * do_t[..., None, :]
    return dr, dk, dv, dw, du, g


def mamba_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor,
                              b_t: torch.Tensor, c_t: torch.Tensor,
                              a: torch.Tensor, d_skip: torch.Tensor,
                              h0: torch.Tensor, dy: torch.Tensor,
                              dh_final: torch.Tensor):
    """The gradient of ``mamba_scan_plain`` for the upstream ``dy`` (B, L,
    di) of its output and ``dh_final`` (B, di, N) of its final state:
    (dx, ddt (B, L, di), db, dc (B, L, N), da (di, N), dd_skip (di,), dh0
    (B, di, N)).

    The states h_0 = ``h0`` .. h_L are recomputed first, then the walk goes
    back in time with g, the gradient of h_t (the decay a_t = exp(dt_t A)):

        g_t = a_{t+1} g_{t+1} + dy_t (x) C_t    (g_L = dh_final + dy_L C_L)
        dC_t = sum_d dy_t[d] h_t[d],   dB_t = sum_d g_t[d] dt_t[d] x_t[d]
        dx_t = D dy_t + dt_t (g_t . B_t)
        ddt_t = sum_n g_t h_{t-1} a_t A + x_t (g_t . B_t)
        dA += g_t h_{t-1} a_t dt_t,   dD += dy_t x_t   (summed over B too)

    and dh0 is a_1 g_1."""
    l = x.shape[1]
    with fp32_highest():
        hs = [h0]
        for t in range(l):
            decay = torch.exp(dt[:, t, :, None] * a[None])
            hs.append(hs[-1] * decay
                      + (dt[:, t] * x[:, t])[..., None] * b_t[:, t, None, :])
        g = dh_final.clone()
        dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
        db, dc = torch.zeros_like(b_t), torch.zeros_like(c_t)
        da, dd = torch.zeros_like(a), torch.zeros_like(d_skip)
        for t in reversed(range(l)):
            x_t, dt_t, dy_t = x[:, t], dt[:, t], dy[:, t]      # (B, di)
            g = g + dy_t[..., None] * c_t[:, t, None, :]
            dc[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy_t)
            db[:, t] = torch.einsum("bdn,bd->bn", g, dt_t * x_t)
            decay = torch.exp(dt_t[..., None] * a[None])
            gd = g * hs[t] * decay          # the gradient of dt_t A
            gb = torch.einsum("bdn,bn->bd", g, b_t[:, t])
            dx[:, t] = d_skip * dy_t + dt_t * gb
            ddt[:, t] = (gd * a).sum(-1) + x_t * gb
            da += (gd * dt_t[..., None]).sum(0)
            dd += (dy_t * x_t).sum(0)
            g = g * decay
    return dx, ddt, db, dc, da, dd, g
