"""The gated Hamming matcher (what kernel K2 computes), written plainly:
popcounts of XORed 32-bit words, the window and octave gates, and per
query the best and second-best distance and the index of the best."""

from __future__ import annotations

import torch

INF = 1 << 20


def popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def match(desc_q, uv_q, r2_q, valid_q, desc_t, uv_t, valid_t,
          level_q=None, level_t=None, level_lo=-1e9, level_hi=1e9,
          r2_t=None, block: int = 64):
    """(best, second, idx), each (N,) int64; INF / INF / -1 where no
    target passes the gates.  Window distances are f32 products and a sum,
    unfused, as the program's matcher defines them."""
    n, m = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    use_level = level_lo > -100.0 or level_hi < 100.0
    f32 = torch.float32
    lq = level_q.to(f32) if level_q is not None else torch.zeros(n, device=dev)
    lt = level_t.to(f32) if level_t is not None else torch.zeros(m, device=dev)
    best = torch.full((n,), INF, dtype=torch.int64, device=dev)
    second = best.clone()
    idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if m == 0:
        return best, second, idx
    for s in range(0, n, block):
        e = min(n, s + block)
        x = desc_q[s:e, None, :].to(torch.int64) ^ desc_t[None, :, :].to(
            torch.int64)
        d = popcount32(x).sum(-1)
        d0 = uv_q[s:e, 0, None] - uv_t[None, :, 0]
        d1 = uv_q[s:e, 1, None] - uv_t[None, :, 1]
        d2 = d0 * d0 + d1 * d1
        ok = valid_q[s:e, None].bool() & valid_t[None, :].bool()
        if r2_q is not None:
            ok = ok & (d2 <= r2_q[s:e, None].to(f32))
        if r2_t is not None:
            ok = ok & (d2 <= r2_t[None, :].to(f32))
        if use_level:
            dl = lt[None, :] - lq[s:e, None]
            ok = ok & (dl >= float(level_lo)) & (dl <= float(level_hi))
        d = torch.where(ok, d, INF)
        b, am = d.min(1)
        d2nd = d.scatter(1, am[:, None], INF).amin(1)
        best[s:e] = b
        second[s:e] = d2nd
        idx[s:e] = torch.where(b < INF, am, -1)
    return best, second, idx


def rows_differ(call: dict) -> int:
    """Queries whose best or second distance differs from the program's,
    or whose unique best target does."""
    a, kw = call["args"], dict(call["kw"])
    names = ("desc_q", "uv_q", "r2_q", "valid_q", "desc_t", "uv_t",
             "valid_t", "level_q", "level_t", "level_lo", "level_hi", "r2_t")
    given = dict(zip(names, a))
    given.update(kw)
    b, s2, i = match(**given)
    pb, ps, pi = (t.to(torch.int64) for t in call["out"])
    bad = (pb != b) | (ps != s2) | ((b < s2) & (pi != i))
    return int(bad.sum())
