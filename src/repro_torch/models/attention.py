"""GQA attention: the full-sequence (training / prefill) path and the
one-token decode path.  The port of `repro.models.attention`.

`chunked_attention` is the reference semantics of the flash-attention
kernel; ``impl`` selects the backend of `attention_train`: ``"ref"`` runs
`chunked_attention`, ``"kernel"`` the hand-written CUDA kernel
(`repro_torch.kernels.flash_attention`; the JAX package's ``"pallas"``).
Both compute the same online-softmax recurrence.  Layouts are the JAX
package's: (B, S, H, D) activations, (B, Smax, Hkv, D) caches.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro_torch
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard_hint
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import _normal, apply_rope, cast

__all__ = ["NEG_INF", "AttnConfig", "init_attention", "qkv_proj",
           "chunked_attention", "attention_train", "init_kv_cache",
           "attention_decode"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int           # padded query heads (multiple of TP)
    n_kv_heads: int        # effective kv heads after replication policy
    head_dim: int
    qkv_bias: bool = False
    causal: bool = True
    rope_theta: float = 10000.0
    chunk_q: int = 512
    chunk_k: int = 1024


def init_attention(gen: torch.Generator, cfg: AttnConfig,
                   dtype=torch.float32):
    s = cfg.d_model ** -0.5
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    p = {
        "wq": _normal(gen, (cfg.d_model, hq), dtype) * s,
        "wk": _normal(gen, (cfg.d_model, hkv), dtype) * s,
        "wv": _normal(gen, (cfg.d_model, hkv), dtype) * s,
        "wo": _normal(gen, (hq, cfg.d_model), dtype) * hq ** -0.5,
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def qkv_proj(params, cfg: AttnConfig, x: torch.Tensor,
             positions: torch.Tensor, compute_dtype=torch.bfloat16):
    B, S, _ = x.shape
    x = cast(x, compute_dtype)
    q = x @ cast(params["wq"], compute_dtype)
    k = x @ cast(params["wk"], compute_dtype)
    v = x @ cast(params["wv"], compute_dtype)
    if cfg.qkv_bias:
        q = q + cast(params["bq"], compute_dtype)
        k = k + cast(params["bk"], compute_dtype)
        v = v + cast(params["bv"], compute_dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_hint(q, "batch", "seq", "heads", "null")
    k = shard_hint(k, "batch", "seq", "kv_heads", "null")
    v = shard_hint(v, "batch", "seq", "kv_heads", "null")
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,H,D) by repeating each kv head for its q group."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return k.repeat_interleave(rep, dim=2)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, chunk_q: int, chunk_k: int,
                      kv_offset: int = 0) -> torch.Tensor:
    """Flash-style online-softmax attention over KV chunks.

    q: (B, Sq, H, D); k/v: (B, Sk, H, D).  `kv_offset`: absolute position
    of k[0] relative to q[0] (prefill = 0).  Loops over query chunks and,
    inside, over key chunks, in the order of the JAX scan.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    nq = max(1, (Sq + chunk_q - 1) // chunk_q)
    nk = max(1, (Sk + chunk_k - 1) // chunk_k)
    cq = -(-Sq // nq)
    ck = -(-Sk // nk)
    dev = q.device
    qf = q.float().transpose(1, 2)                 # (B,H,Sq,D)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    q_pos = torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev) + kv_offset
    outs = []
    for qi in range(nq):
        qs = slice(qi * cq, (qi + 1) * cq)
        q_blk = qf[:, :, qs]
        rows = q_blk.shape[2]
        acc = torch.zeros((B, H, rows, D), dtype=torch.float32, device=dev)
        m = torch.full((B, H, rows), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, rows), dtype=torch.float32, device=dev)
        for ki in range(nk):
            ks = slice(ki * ck, (ki + 1) * ck)
            s = torch.einsum("bhqd,bhkd->bhqk", q_blk, kf[:, :, ks]) * scale
            if causal:
                mask = q_pos[qs][:, None] >= k_pos[ks][None, :]
                s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vf[:, :, ks])
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=2).transpose(1, 2)   # (B,Sq,H,D)
    return out.to(q.dtype)


def _attend(q, k, v, cfg: AttnConfig, impl: str) -> torch.Tensor:
    """The backend on plain tensors, k/v with one head per query head."""
    S = q.shape[1]
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=cfg.causal)
    if impl == "ref":
        return chunked_attention(q, k, v, cfg.causal, min(cfg.chunk_q, S),
                                 min(cfg.chunk_k, S))
    raise ValueError(f"attention impl {impl!r}: expected 'ref' or "
                     f"'kernel'")


def _block_placements(q, k, cfg: AttnConfig):
    """``(qpl, kpl, q_off, kv_off)`` of DTensor q (B, S, H, D) and k (B,
    S, Hkv, D) run on each rank's (batch, heads) block: query heads keep
    the mesh dims their hint gave them; kv heads keep theirs where they
    match the query heads', else are whole.  A kv cache split along its
    sequence over a mesh dim (``cache_seq``) keeps that split, and the
    query heads are whole on that dim: each rank meets every head with
    its own positions (`_decode_on_blocks` combines the ranks' partial
    softmaxes).  Anything else is whole.  ``q_off`` and ``kv_off`` are
    the global index of the rank's first query and kv head.  Kv heads
    split over more ranks than there are (qwen2.5-14b's 8 kv heads over
    16 "model" ranks) are whole: a rank's query heads meet another
    rank's kv head."""
    mesh = q.device_mesh
    seq = [pk == Shard(1) for pk in k.placements]
    ways = 1
    for m, pq in enumerate(q.placements):
        if pq == Shard(2) and not seq[m]:
            ways *= mesh.size(m)
    even = cfg.n_kv_heads % ways == 0
    qpl, kpl = [], []
    for m, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if seq[m]:
            qpl.append(Replicate())
            kpl.append(pk)
        elif pq == Shard(0):
            qpl.append(pq)
            kpl.append(pq)
        elif pq == Shard(2):
            qpl.append(pq)
            kpl.append(pq if pk == Shard(2) and even else Replicate())
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
    return (qpl, kpl, shd.block_offset(qpl, mesh, 2, cfg.n_heads),
            shd.block_offset(kpl, mesh, 2, cfg.n_kv_heads))


def _kv_for_heads(kl, vl, q_off: int, kv_off: int, hl: int, group: int):
    """A rank's kv block narrowed to what its ``hl`` query heads from
    global head ``q_off`` meet: ``(k, v, n)``, ``n`` kv heads each met by
    ``hl // n`` consecutive query heads.  Local query head i is global
    head ``q_off + i`` and meets kv head ``(q_off + i) // group``, which
    is local kv head ``... - kv_off``."""
    if q_off % group == 0 and hl % group == 0 or group % hl == 0:
        # whole groups (or one group's share): a range of kv heads
        lo, n = q_off // group - kv_off, max(1, hl // group)
        return kl.narrow(2, lo, n), vl.narrow(2, lo, n), n
    idx = (q_off + torch.arange(hl, device=kl.device)) // group - kv_off
    return kl.index_select(2, idx), vl.index_select(2, idx), hl


def _attend_on_blocks(q, k, v, cfg: AttnConfig, impl: str):
    """The backend on each rank's (batch, heads) block of DTensor q, k, v
    (`shd.on_blocks`, `_block_placements`): attention is independent per
    batch row and per head.  Each rank expands its kv block by the global
    index of its query heads (`_kv_for_heads`)."""
    qpl, kpl, q_off, kv_off = _block_placements(q, k, cfg)
    group = cfg.n_heads // cfg.n_kv_heads

    def local(ql, kl, vl):
        hl = ql.shape[2]
        kl, vl, _ = _kv_for_heads(kl, vl, q_off, kv_off, hl, group)
        return _attend(ql, _expand_kv(kl, hl), _expand_kv(vl, hl), cfg,
                       impl)

    return shd.on_blocks(local, (qpl, kpl, kpl), qpl, q, k, v)


def attention_train(params, cfg: AttnConfig, x: torch.Tensor,
                    positions: torch.Tensor, compute_dtype=torch.bfloat16,
                    impl: str = "ref") -> torch.Tensor:
    """Full-sequence attention (training / prefill).  The kv heads are
    expanded before the backend, as in the JAX package, so the kernel
    sees one kv head per query head on this path.  On DTensors the
    backend runs on each rank's block (`_attend_on_blocks`)."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(params, cfg, x, positions, compute_dtype)
    if isinstance(q, DTensor):
        out = _attend_on_blocks(q, k, v, cfg, impl)
    else:
        out = _attend(q, _expand_kv(k, cfg.n_heads),
                      _expand_kv(v, cfg.n_heads), cfg, impl)
    out = shard_hint(out, "batch", "seq", "heads", "null")
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ cast(params["wo"], compute_dtype)


# -- decode path -----------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device=None):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = repro_torch.resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _no_grad_write(new: torch.Tensor) -> None:
    """Raises ``RuntimeError`` where autograd records ``new``, the value a
    decode writes into a cache in place: a saved tensor would meet the
    write."""
    if new.requires_grad:
        raise RuntimeError("decode writes its caches in place and is not "
                           "differentiable: run it under torch.no_grad()")


def _write_at(cache: torch.Tensor, new: torch.Tensor, pos: int):
    """``cache`` (B, Smax, Hkv, D) with ``new`` (B, 1, Hkv, D) written at
    sequence position ``pos`` in place; returns ``cache``.  On a DTensor
    each rank writes into its own block, the one whose sequence range
    holds ``pos``: DTensor's ``aten.copy_`` into a slice of a cache
    sharded along its sequence writes the slice of every rank's block
    (wrong values, no error), so the write is placed explicitly
    (`_on_cache_block`)."""
    if not isinstance(cache, DTensor):
        cache[:, pos:pos + 1] = new.to(cache.dtype)
        return cache

    def write(block, nl, off):
        if 0 <= pos - off < block.shape[1]:
            block[:, pos - off:pos - off + 1] = nl.to(block.dtype)
    return _on_cache_block(write, cache, new)


def _blend_at(cache: torch.Tensor, new: torch.Tensor, pos: int):
    """``cache`` (B, Smax, Hkv, D) with ``new`` (B, 1, Hkv, D) selected at
    sequence position ``pos`` by a one-hot mask over the sequence, a
    rewrite of the whole cache (the JAX package's collective-free write
    for sequence-sharded caches), in place (``torch.where(..., out=)``);
    returns ``cache``.  On a DTensor each rank masks its own block by
    global position (`_on_cache_block`), so nothing of the cache's
    length moves between ranks."""
    def blend(block, nl, off):
        sel = (off + torch.arange(block.shape[1], device=block.device)
               == pos)[None, :, None, None]
        torch.where(sel, nl.to(block.dtype), block, out=block)
    if not isinstance(cache, DTensor):
        blend(cache, new, 0)
        return cache
    return _on_cache_block(blend, cache, new)


def _on_cache_block(fn, cache, new):
    """``fn(block, new_block, off)`` writing into this rank's block of
    DTensor ``cache`` in place, the block's first position global
    position ``off``, with ``new`` placed like the cache but whole along
    the sequence; returns ``cache``, its block's storage written."""
    mesh, cpl = cache.device_mesh, list(cache.placements)
    npl = [Replicate() if p == Shard(1) else p for p in cpl]
    off = shd.block_offset(cpl, mesh, 1, cache.shape[1])
    fn(cache.to_local(), new.redistribute(mesh, npl).to_local(), off)
    return cache


def _grouped_decode(q, k, v, n_kv: int, pos: int):
    """One query position against caches k, v (B, Smax, n_kv, D) up to
    ``pos``, the query heads of q (B, 1, H, D) grouped per kv head (never
    expanded): (B, 1, n_kv, H // n_kv, D) in f32."""
    B, _, H, D = q.shape
    qg = q.reshape(B, 1, n_kv, H // n_kv, D).float()
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (D ** -0.5)
    mask = (torch.arange(kf.shape[1], device=q.device)
            <= pos)[None, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, vf)


def _grouped_decode_partial(q, k, v, n_kv: int, pos: int, off: int,
                            groups):
    """`_grouped_decode` on one block of the cache's positions, the first
    global position ``off``, combined over the ranks of ``groups`` (one
    ``(mesh, mesh dim)`` each) that hold the other blocks.  Each rank
    keeps its softmax unnormalized in f32: the running max m, the sum l
    and the weighted values o.  The ranks' maxima are all-reduced; each
    rank rescales (o, l) to the common max and the sums are all-reduced
    as one (B, n_kv, g, 1, D + 1) tensor.  Only these move, never the
    cache.  A block wholly past ``pos`` has p = 0, so l = 0 and o = 0;
    masked scores are ``NEG_INF``, finite, so m less the common max is
    never inf - inf."""
    from torch.distributed import _functional_collectives as funcol

    def all_reduce(t, op):
        for g in groups:
            t = funcol.all_reduce(t, op, g)
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) \
            else t

    B, _, H, D = q.shape
    qg = q.reshape(B, 1, n_kv, H // n_kv, D).float()
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (D ** -0.5)
    mask = (off + torch.arange(kf.shape[1], device=q.device)
            <= pos)[None, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    ol = torch.cat([torch.einsum("bhgqk,bkhd->bhgqd", p, vf),
                    p.sum(dim=-1, keepdim=True)], dim=-1)
    ol = all_reduce(ol * torch.exp(m - all_reduce(m, "max")), "sum")
    return (ol[..., :D] / ol[..., D:]).permute(0, 3, 1, 2, 4)


def _decode_on_blocks(q, k, v, cfg: AttnConfig, pos: int):
    """`_grouped_decode` on each rank's (batch, heads) block (B_l, 1, H_l,
    D): each rank groups its own heads against the kv heads they meet
    (`_kv_for_heads`).  DTensor's ``aten.view`` refuses to group query
    heads split over more ranks than there are kv heads per kv head
    (uneven unflatten), and torch 2.11's refuses the grouped einsum's
    flatten of a block whose kv-head dim is split ("flatten multiple
    dimensions ... being sharded"), an even split too.  A cache split
    along its sequence stays split: each rank attends over its own
    positions and the ranks' partial softmaxes are combined
    (`_grouped_decode_partial`), as XLA keeps such a cache sharded."""
    qpl, kpl, q_off, kv_off = _block_placements(q, k, cfg)
    group = cfg.n_heads // cfg.n_kv_heads
    mesh = q.device_mesh
    groups = [(mesh, m) for m, p in enumerate(kpl) if p == Shard(1)]
    k_off = shd.block_offset(kpl, mesh, 1, k.shape[1])

    def local(ql, kl, vl):
        Bl, _, hl, D = ql.shape
        kl, vl, n = _kv_for_heads(kl, vl, q_off, kv_off, hl, group)
        if groups:
            out = _grouped_decode_partial(ql, kl, vl, n, pos, k_off, groups)
        else:
            out = _grouped_decode(ql, kl, vl, n, pos)
        return out.reshape(Bl, 1, hl, D)

    return shd.on_blocks(local, (qpl, kpl, kpl), qpl, q, k, v)


def attention_decode(params, cfg: AttnConfig, x: torch.Tensor, cache,
                     pos: int, compute_dtype=torch.bfloat16,
                     cache_update: str = "dus", donate: bool = False):
    """One-token decode: x (B,1,d); cache k/v (B,Smax,Hkv,D); pos int.
    Returns (out, new cache).

    cache_update: ``"dus"`` writes the new k/v at ``pos``; ``"blend"``
    selects them with a one-hot mask over the whole sequence axis (the
    JAX package's collective-free variant for sequence-sharded caches).
    Both give the same caches and write in place.  ``donate`` False (the
    default): k and v are each copied once and written into the copies,
    so the given cache is not modified.  ``donate`` True: they are
    written into the given cache (on a DTensor, into each rank's block),
    which is returned, as a JAX argument donated to the step.  A write in
    place is not differentiable here: where autograd records the new
    k/v, it raises ``RuntimeError`` (decode under ``torch.no_grad()``).
    The kv heads are never expanded: queries are grouped per kv head.
    """
    if cache_update not in ("dus", "blend"):
        raise ValueError(f"cache_update {cache_update!r}: expected 'dus' "
                         f"or 'blend'")
    if not donate:
        cache = {"k": cache["k"].clone(), "v": cache["v"].clone()}
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = qkv_proj(params, cfg, x, positions, compute_dtype)
    _no_grad_write(k_new)
    write = _blend_at if cache_update == "blend" else _write_at
    k_cache = write(cache["k"], k_new, pos)
    v_cache = write(cache["v"], v_new, pos)

    if isinstance(q, DTensor):
        out = _decode_on_blocks(q, k_cache, v_cache, cfg, pos)
    else:
        out = _grouped_decode(q, k_cache, v_cache, cfg.n_kv_heads, pos)
    # one (B, H*D) x (H*D, d) product, as torch.matmul folds the (B, 1,
    # H*D) one on a plain tensor (a DTensor's strides for the unit dim keep
    # matmul from folding it, and its batched product rounds otherwise)
    out = out.reshape(B, cfg.n_heads * cfg.head_dim).to(compute_dtype)
    out = (out @ cast(params["wo"], compute_dtype))[:, None]
    return out, {"k": k_cache, "v": v_cache}
