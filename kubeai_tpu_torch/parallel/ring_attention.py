"""Ring attention: exact causal attention over a sequence split over the
sp ranks (port of kubeai_tpu/parallel/ring_attention.py).

Each rank keeps its query block and passes its key/value block round the
ring, one step to the next rank per block, folding each block it holds
into flash-attention-style online-softmax statistics. The JAX package
runs this inside ``shard_map`` with ``ppermute``; here each rank calls
:func:`ring_attention` on its own block with its sp group, and the pass
is parallel/group.py's :func:`ring_shift_grad` (K and V travel as one
tensor, one pass a step). As in the JAX package the block is plain
tensor algebra (einsums in float32), not a kernel.

Gradients come from autograd through the unrolled steps: the pass's
backward sends the gradient back round the ring. A rank keeps each
step's [B, Kv, G, S/sp, S/sp] scores for the backward, so its memory is
O((S/sp)^2) per step, never S^2.

A block whose keys all lie after the rank's queries (source rank >
this rank) leaves o, l and m exactly as they are in ``_block_attend``
(every score masked, p = 0, alpha = 1), so it is passed on without
being computed. The last block a rank receives is then used by nothing,
and autograd would skip its pass's backward on that rank alone while
the ranks that did attend to it wait in theirs: :class:`_Tie` hands it a
zero gradient, so every rank runs every pass's backward.
"""

from __future__ import annotations

import torch

from kubeai_tpu_torch.parallel.group import TPGroup, ring_shift_grad

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _block_attend(q, k, v, q_pos, k_pos, scale, o, l, m):
    """One KV block of online-softmax attention (GQA grouped), the JAX
    package's _block_attend. q [B, Sq, H, h]; k, v [B, Sk, Kv, h];
    positions [Sq] / [Sk]; o [B, Sq, H, h] float32, l / m [B, Sq, H]
    float32 running statistics. Returns (o, l, m)."""
    B, Sq, H, h = q.shape
    Kv = k.shape[2]
    G = H // Kv

    qg = q.reshape(B, Sq, Kv, G, h)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    s = s * scale  # [B, Kv, G, Sq, Sk]
    causal = (k_pos[None, :] <= q_pos[:, None])[None, None, None]
    s = torch.where(causal, s, _NEG_INF)

    s_flat = s.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, -1)  # [B, Sq, H, Sk]
    m_new = torch.maximum(m, s_flat.amax(dim=-1))
    # _NEG_INF is finite, so m - m_new is always defined; rows with no
    # unmasked key yet keep l == 0 and o == 0 (p forced to zero).
    p = torch.where(s_flat > _NEG_INF / 2, torch.exp(s_flat - m_new[..., None]), 0.0)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    p_g = p.reshape(B, Sq, Kv, G, -1).permute(0, 2, 3, 1, 4)  # [B, Kv, G, Sq, Sk]
    o_blk = torch.einsum("bkgqs,bskh->bqkgh", p_g, v.float()).reshape(B, Sq, H, h)
    o_new = o * alpha[..., None] + o_blk
    return o_new, l_new, m_new


class _Tie(torch.autograd.Function):
    """*o* unchanged; *kv* gets a zero gradient (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, o, kv):
        ctx.kv_shape, ctx.kv_dtype = kv.shape, kv.dtype
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.kv_shape, dtype=ctx.kv_dtype, device=g.device)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sp_group: TPGroup | None, scale: float | None = None) -> torch.Tensor:
    """Causal ring attention over *sp_group*. q [B, S/sp, H, h] and k, v
    [B, S/sp, Kv, h] are this rank's blocks of the sequence (rank r holds
    positions r*S/sp ..); returns this rank's block of the output
    [B, S/sp, H, h] in q's dtype. Positions follow the JAX package's
    _ring_body: the queries sit at rank*block + arange, and at step i the
    rank holds the block of rank (rank - i) mod n."""
    n = sp_group.world_size if sp_group is not None else 1
    me = sp_group.rank if sp_group is not None else 0
    B, Sq, H, h = q.shape
    if k.shape[1] != Sq:
        raise ValueError(f"query block {Sq} and key block {k.shape[1]} differ")
    if scale is None:
        scale = h**-0.5
    dev = q.device
    q_pos = me * Sq + torch.arange(Sq, device=dev)

    o = torch.zeros((B, Sq, H, h), dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, H), _NEG_INF, dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])  # one tensor round the ring
    for i in range(n):
        src = (me - i) % n
        if src <= me:
            k_pos = src * Sq + torch.arange(Sq, device=dev)
            o, l, m = _block_attend(q, kv[0], kv[1], q_pos, k_pos, scale, o, l, m)
        elif i == n - 1 and torch.is_grad_enabled() and kv.requires_grad:
            o = _Tie.apply(o, kv)
        if i < n - 1:
            kv = ring_shift_grad(kv, sp_group)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def score_bytes(B: int, S: int, H: int, sp: int) -> dict:
    """Float32 score bytes of one attention step: a rank's [B, H, S/sp,
    S/sp] block against dense attention's [B, H, S, S]."""
    blk = S // sp
    return {"per_rank_step": 4 * B * H * blk * blk, "dense": 4 * B * H * S * S}
