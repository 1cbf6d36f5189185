"""Cross-entropy head kernels on Hopper: wrappers, launch counts, plain
versions.

Seven CUDA kernels (``csrc/xent.cu``) carry the head's four flavours
(save_exp x fused_bwd; the train step's default is saved and fused):

- ``xent_fwd`` replaces ``icikit/ops/xent.py``'s ``_fwd_kernel`` /
  ``_fwd_kernel_save`` (B9, ``_fwd_call``): per token the lse of the
  logits ``x w^T`` and the target logit, and with ``save`` the shifted
  exponentials e and each chunk's max.
- ``xent_dx_saved`` and ``xent_dw_saved`` replace ``_dx_saved_kernel``
  and ``_dw_saved_kernel`` (B10, ``_dx_call``/``_dw_call``): dx and dw
  from g rebuilt out of e, never written out.
- ``xent_dx`` and ``xent_dw`` replace ``_dx_kernel`` and ``_dw_kernel``
  with ``e_ref=None`` (B10, recompute flavour): g rebuilt from a
  recomputed logits tile. In bf16 past D 2048 (one cluster) they walk
  chunks (:func:`recompute_walk`): each chunk's g by ``xent_g``'s body,
  then its product by the saved flavour's body with g given.
- ``xent_g`` and ``xent_g_saved`` replace ``_bwd_kernel`` (B11,
  ``_g_call``) and ``_g_saved_kernel`` (B11, ``_g_saved_call``): the
  matmul backward's g written out as a ``(T, V)`` tensor.

The residual's layout is the port's own: e ``(T, V)`` in the compute
dtype and ``mrun (V / chunk, T)`` float32, the max of each
``chunk``-column piece of a row (``TILE``: 128 for bf16, half of the
forward's 256-column logits tile, 64 for float32, its square tile). The
softmax is
``p = e * exp2(mrun - lse * log2(e))`` whatever the chunk width, which
is all the backward needs.

Beside each kernel stands its plain PyTorch version, the same function
as whole-tensor ops. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build
from icikit_torch.ops.common import LN2, LOG2E

LAUNCHES = {"xent_fwd": 0, "xent_dx_saved": 0, "xent_dw_saved": 0,
            "xent_dx": 0, "xent_dw": 0, "xent_g": 0, "xent_g_saved": 0}

# mrun's chunk on the vocabulary (bf16: half of the forward's 128 x 256
# logits tile; float32: its square 64 x 64 tile, whose CTAs count on a
# token tile's counter to merge their partials).
TILE = {torch.bfloat16: 128, torch.float32: 64}
# The plain versions' chunk width on the CPU (any width gives the same p).
PLAIN_CHUNK = 128
# The widest D one cluster of the bf16 recompute kernel covers (8 CTAs of
# 256 columns); wider bf16 heads take recompute_walk.
CLUSTER_D_MAX = 2048


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: whole-tensor ops, any device.


def _pad_cols(a: torch.Tensor, n: int, value: float) -> torch.Tensor:
    return a if a.shape[-1] == n else torch.nn.functional.pad(
        a, (0, n - a.shape[-1]), value=value)


def _row_scale(mrun, lse, chunk: int, v: int) -> torch.Tensor:
    """exp2(m_i - lse * log2(e)) broadcast to ``(T, V)``."""
    m = mrun.t().repeat_interleave(chunk, dim=1)[:, :v]
    return torch.exp2(m - (lse * LOG2E)[:, None])


def xent_fwd_plain(x, w, targets, save: bool, chunk: int = PLAIN_CHUNK):
    """Plain version of ``xent_fwd``: x ``(T, D)``, w ``(V, D)``, int
    targets ``(T,)``. Float32 logits; each ``chunk``-column piece of a
    row takes its own base-2 max m_i and sum of exp2(s log2(e) - m_i);
    lse = (M + log2 sum l_i exp2(m_i - M)) ln 2; the target logit in
    natural units. Returns ``(lse, tgt)`` (``(T,)`` float32) and, with
    ``save``, ``e (T, V)`` in x's dtype and ``mrun (V / chunk, T)``."""
    t, v = x.shape[0], w.shape[0]
    s = torch.matmul(x.float(), w.float().t())
    tgt = s.gather(1, targets.long()[:, None])[:, 0]
    nc = -(-v // chunk)
    sb = _pad_cols(s * LOG2E, nc * chunk, -float("inf")).view(t, nc, chunk)
    m = sb.amax(dim=-1)                                   # (T, nc)
    e = torch.exp2(sb - m[..., None])
    l = e.sum(dim=-1)
    big = m.amax(dim=-1)
    lse = (big + torch.log2((l * torch.exp2(m - big[:, None])).sum(-1))) \
        * LN2
    if not save:
        return lse, tgt
    return (lse, tgt, e.reshape(t, nc * chunk)[:, :v].to(x.dtype),
            m.t().contiguous())


def _g_plain(e, mrun, targets, lse, dnll, chunk: int) -> torch.Tensor:
    """g = (p - onehot) * dnll in float32, p rebuilt from e."""
    v = e.shape[1]
    p = e.float() * _row_scale(mrun, lse, chunk, v)
    onehot = torch.nn.functional.one_hot(targets.long(), v).float()
    return (p - onehot) * dnll.float()[:, None]


def xent_dx_saved_plain(e, mrun, w, targets, lse, dnll,
                        chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version of ``xent_dx_saved``: dx = g w in float32 (g in
    float32 against w in float32, as the TPU contracts it), cast to e's
    dtype."""
    g = _g_plain(e, mrun, targets, lse, dnll, chunk)
    return torch.matmul(g, w.float()).to(e.dtype)


def xent_dw_saved_plain(e, mrun, x, targets, lse, dnll,
                        chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version of ``xent_dw_saved``: dw = g^T x in float32, cast
    to x's dtype."""
    g = _g_plain(e, mrun, targets, lse, dnll, chunk)
    return torch.matmul(g.t(), x.float()).to(x.dtype)


def xent_g_saved_plain(e, mrun, targets, lse, dnll,
                       chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version of ``xent_g_saved``: g from e, in e's dtype."""
    return _g_plain(e, mrun, targets, lse, dnll, chunk).to(e.dtype)


def g_cols_plain(x, w, targets, lse, dnll, v0: int = 0) -> torch.Tensor:
    """g = (exp2(s log2(e) - lse log2(e)) - onehot) * dnll in float32 from
    the float32 logits s = x w^T (``_g_chunk_recompute``), w holding the
    head's vocabulary rows v0, v0 + 1, ...: a row's target matches the
    column ``target - v0``, if it lies in w. With v0 a chunk's first row
    it is the plain version of :func:`recompute_walk`'s first piece (the
    card's ``icikit_xent_g_cols``)."""
    s = torch.matmul(x.float(), w.float().t())
    p = torch.exp2(s * LOG2E - (lse * LOG2E)[:, None])
    cols = torch.arange(v0, v0 + w.shape[0], device=x.device)
    onehot = (targets.long()[:, None] == cols).float()
    return (p - onehot) * dnll.float()[:, None]


def xent_g_plain(x, w, targets, lse, dnll) -> torch.Tensor:
    """Plain version of ``xent_g``: the recomputed g in x's dtype."""
    return g_cols_plain(x, w, targets, lse, dnll).to(x.dtype)


def g_product_plain(which: str, g, op, out) -> None:
    """Plain version of :func:`recompute_walk`'s second piece (the card's
    ``icikit_xent_g_product``): ``out = g op`` (dx) or ``g^T op`` (dw) in
    float32, cast to out's dtype."""
    g = g.float() if which == "dx" else g.float().t()
    out.copy_(torch.matmul(g, op.float()))


def xent_dx_plain(x, w, targets, lse, dnll) -> torch.Tensor:
    """Plain version of ``xent_dx``: dx = g w in float32 from the
    recomputed g, cast to x's dtype."""
    g = g_cols_plain(x, w, targets, lse, dnll)
    return torch.matmul(g, w.float()).to(x.dtype)


def xent_dw_plain(x, w, targets, lse, dnll) -> torch.Tensor:
    """Plain version of ``xent_dw``: dw = g^T x in float32 from the
    recomputed g, cast to x's dtype."""
    g = g_cols_plain(x, w, targets, lse, dnll)
    return torch.matmul(g.t(), x.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.


def _check_widths(what: str, dtype, d: int, v: int) -> None:
    if dtype == torch.bfloat16 and (d % 8 or v % 8):
        raise ValueError(f"{what}: the bf16 kernels read 16-byte rows: "
                         f"D={d} and V={v} must be multiples of 8")


def _rows(targets, lse=None, dnll=None):
    """The per-token operands as the kernels take them."""
    out = [targets.to(torch.int32).contiguous()]
    for a in (lse, dnll):
        if a is not None:
            out.append(a.float().contiguous())
    return out


def xent_fwd(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
             save: bool):
    """Head forward: x ``(T, D)``, w ``(V, D)`` (one dtype), int targets
    ``(T,)``. Returns ``(lse, tgt)`` float32 ``(T,)``, and with ``save``
    also ``e (T, V)`` in x's dtype and ``mrun (V / chunk, T)`` float32
    (chunk: ``TILE[dtype]`` on the card, ``PLAIN_CHUNK`` on the CPU).

    The kernel replaces ``icikit/ops/xent.py``'s ``_fwd_kernel`` /
    ``_fwd_kernel_save`` (B9, pallas_call at :283). Bound: the logits
    product, 2 T V D operations over the card's bf16 rate. In bf16 a
    persistent CTA an SM forms 128-token x 256-column logits tiles on
    wgmma from a TMA ring; its epilogue takes each 128-column chunk's
    max, sum and target logit from the registers, stages e in shared
    memory and stores it by TMA under the next tile's products, and a
    second launch in the same call merges the chunks into lse. CPU
    tensors take :func:`xent_fwd_plain`."""
    t, d = x.shape
    v = w.shape[0]
    if w.shape != (v, d) or targets.shape != (t,):
        raise ValueError(f"xent_fwd: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, targets "
                         f"{tuple(targets.shape)} disagree")
    if x.device.type == "cpu":
        return xent_fwd_plain(x, w, targets, save)
    _build.check_operands("xent_fwd", (x, w), x.dtype)
    _check_widths("xent_fwd", x.dtype, d, v)
    (tg,) = _rows(targets)
    tile = TILE[x.dtype]
    dev = x.device
    e = torch.empty((t, v) if save else (0,), dtype=x.dtype, device=dev)
    mrun, lpart, tpart = (torch.empty((-(-v // tile), t),
                                      dtype=torch.float32, device=dev)
                          for _ in range(3))
    counter = torch.zeros((-(-t // tile),), dtype=torch.int32, device=dev)
    lse = torch.empty((t,), dtype=torch.float32, device=dev)
    tgt = torch.empty((t,), dtype=torch.float32, device=dev)
    lib = _build.load("xent")
    rc = lib.icikit_xent_fwd(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
        tg.data_ptr(),
        e.data_ptr(), mrun.data_ptr(), lpart.data_ptr(), tpart.data_ptr(),
        counter.data_ptr(), lse.data_ptr(), tgt.data_ptr(), t, v, d,
        int(save), _build.stream(x))
    _build.check(rc, "xent_fwd launch")
    LAUNCHES["xent_fwd"] += 1
    return (lse, tgt, e, mrun) if save else (lse, tgt)


def _backward(which: str, e, mrun, other, targets, lse, dnll):
    t, v = e.shape
    d = other.shape[1]
    rows_other = v if which == "dx" else t
    if other.shape != (rows_other, d) or targets.shape != (t,) \
            or lse.shape != (t,) or dnll.shape != (t,):
        raise ValueError(f"xent_{which}_saved: shapes e {tuple(e.shape)}, "
                         f"operand {tuple(other.shape)}, rows "
                         f"{tuple(targets.shape)} disagree")
    cpu = e.device.type == "cpu"
    if not cpu:
        _build.check_operands(f"xent_{which}_saved", (e, other), e.dtype)
        _build.check_operands(f"xent_{which}_saved mrun", (mrun,),
                              torch.float32)
        _check_widths(f"xent_{which}_saved", e.dtype, d, v)
    chunk = PLAIN_CHUNK if cpu else TILE[e.dtype]
    if mrun.shape != (-(-v // chunk), t):
        raise ValueError(f"xent_{which}_saved: mrun {tuple(mrun.shape)} "
                         f"does not fit e {tuple(e.shape)}")
    if cpu:
        plain = xent_dx_saved_plain if which == "dx" else xent_dw_saved_plain
        return plain(e, mrun, other, targets, lse, dnll, chunk)
    tg, ls, dn = _rows(targets, lse, dnll)
    out = torch.empty((t, d) if which == "dx" else (v, d), dtype=e.dtype,
                      device=e.device)
    lib = _build.load("xent")
    fn = lib.icikit_xent_dx if which == "dx" else lib.icikit_xent_dw
    rc = fn(_build.DTYPE_CODE[e.dtype], e.data_ptr(), mrun.data_ptr(),
            other.data_ptr(), tg.data_ptr(), ls.data_ptr(), dn.data_ptr(),
            out.data_ptr(), t, v, d, chunk, _build.stream(e))
    _build.check(rc, f"xent_{which}_saved launch")
    LAUNCHES[f"xent_{which}_saved"] += 1
    return out


def xent_dx_saved(e, mrun, w, targets, lse, dnll) -> torch.Tensor:
    """dx ``(T, D)`` = g w, g = (e exp2(m_i - lse log2(e)) - onehot) dnll
    rebuilt from the forward's residual. The kernel replaces
    ``icikit/ops/xent.py``'s ``_dx_saved_kernel`` (B10, pallas_call at
    :374). Bound: 2 T V D operations. In bf16 a CTA holds a 128 x 256
    tile of dx on wgmma, g rebuilt in registers from e's tiles, which a
    TMA ring brings with w's. CPU tensors take
    :func:`xent_dx_saved_plain`."""
    return _backward("dx", e, mrun, w, targets, lse, dnll)


def xent_dw_saved(e, mrun, x, targets, lse, dnll) -> torch.Tensor:
    """dw ``(V, D)`` = g^T x, g rebuilt as for dx. The kernel replaces
    ``icikit/ops/xent.py``'s ``_dw_saved_kernel`` (B10, pallas_call at
    :411). Bound: 2 T V D operations. CPU tensors take
    :func:`xent_dw_saved_plain`."""
    return _backward("dw", e, mrun, x, targets, lse, dnll)


def xent_g_saved(e, mrun, targets, lse, dnll) -> torch.Tensor:
    """The matmul backward's g ``(T, V)`` in e's dtype, rebuilt from the
    forward's residual. The kernel replaces ``icikit/ops/xent.py``'s
    ``_g_saved_kernel`` (B11, pallas_call at :335). Bound: reading e and
    writing g (bytes). CPU tensors take :func:`xent_g_saved_plain`."""
    t, v = e.shape
    if targets.shape != (t,) or lse.shape != (t,) or dnll.shape != (t,):
        raise ValueError(f"xent_g_saved: e {tuple(e.shape)} and rows "
                         f"{tuple(targets.shape)} disagree")
    cpu = e.device.type == "cpu"
    if not cpu:
        _build.check_operands("xent_g_saved", (e,), e.dtype)
        _build.check_operands("xent_g_saved mrun", (mrun,), torch.float32)
        _check_widths("xent_g_saved", e.dtype, 8, v)
    chunk = PLAIN_CHUNK if cpu else TILE[e.dtype]
    if mrun.shape != (-(-v // chunk), t):
        raise ValueError(f"xent_g_saved: mrun {tuple(mrun.shape)} does not "
                         f"fit e {tuple(e.shape)}")
    if cpu:
        return xent_g_saved_plain(e, mrun, targets, lse, dnll, chunk)
    tg, ls, dn = _rows(targets, lse, dnll)
    g = torch.empty_like(e)
    rc = _build.load("xent").icikit_xent_g_saved(
        _build.DTYPE_CODE[e.dtype], e.data_ptr(), mrun.data_ptr(),
        tg.data_ptr(), ls.data_ptr(), dn.data_ptr(), g.data_ptr(), t, v,
        chunk, _build.stream(e))
    _build.check(rc, "xent_g_saved launch")
    LAUNCHES["xent_g_saved"] += 1
    return g


def _recompute_operands(what, x, w, targets, lse, dnll) -> bool:
    """Check the recompute kernels' operands; True when on the CPU."""
    t, d = x.shape
    v = w.shape[0]
    if w.shape != (v, d) or targets.shape != (t,) or lse.shape != (t,) \
            or dnll.shape != (t,):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, rows {tuple(targets.shape)} "
                         f"disagree")
    if x.device.type == "cpu":
        return True
    _build.check_operands(what, (x, w), x.dtype)
    _check_widths(what, x.dtype, d, v)
    return False


def xent_g(x, w, targets, lse, dnll) -> torch.Tensor:
    """The matmul backward's g ``(T, V)`` in x's dtype, the logits
    recomputed tile by tile in the kernel. Replaces
    ``icikit/ops/xent.py``'s ``_bwd_kernel`` (B11, pallas_call at :312).
    Bound: the logits product, 2 T V D operations. In bf16 it is
    ``xent_fwd``'s body (persistent, wgmma, a TMA ring) with another
    epilogue: g from the logits in registers, each row's lse, dnll and
    target loaded under its tile's products, the tile stored by TMA. CPU
    tensors take :func:`xent_g_plain`."""
    if _recompute_operands("xent_g", x, w, targets, lse, dnll):
        return xent_g_plain(x, w, targets, lse, dnll)
    t, d = x.shape
    v = w.shape[0]
    tg, ls, dn = _rows(targets, lse, dnll)
    g = torch.empty((t, v), dtype=x.dtype, device=x.device)
    rc = _build.load("xent").icikit_xent_g(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
        tg.data_ptr(), ls.data_ptr(), dn.data_ptr(), g.data_ptr(), t, v, d,
        _build.stream(x))
    _build.check(rc, "xent_g launch")
    LAUNCHES["xent_g"] += 1
    return g


def recompute_chunk(n: int, d: int, sms: int) -> int:
    """Rows of one chunk of :func:`recompute_walk` (tokens for dx,
    vocabulary rows for dw) out of ``n``, at width ``d`` on a card of
    ``sms`` SMs: the 128-row tiles whose ``ceil(d / 256)`` slices of D
    fill one wave of the product kernel (one CTA an SM), and at most a
    quarter of ``n`` rounded down to a multiple of 8 (dw's g rows must
    start on 16 bytes), so that g's scratch (chunk x V for dx, T x chunk
    for dw, bf16) stays within a quarter of the (T, V) residual the saved
    flavour keeps. At T 8192, D 4096, V 32768 on 132 SMs: 1024 rows both
    ways, scratch 64 MiB (dx) and 16 MiB (dw) against the residual's 512
    MiB. Below 32 rows a quarter holds no multiple of 8: the chunk is then
    8 rows, or all ``n`` when fewer, and the scratch at most 8 rows of
    the other side."""
    wave = 128 * max(1, sms // -(-d // 256))
    return min(wave, max(8, n // 4 // 8 * 8), n)


def recompute_walk(which: str, x, w, targets, lse, dnll, out, chunk: int,
                   g_piece, product):
    """The recompute flavour's dx (``which`` "dx", into ``out`` (T, D)) or
    dw ("dw", into ``out`` (V, D)) walked in chunks of ``chunk`` rows, so
    that each logits tile is formed once (``_dx_kernel`` / ``_dw_kernel``
    with ``e_ref=None`` keep a (bt, D) accumulator the card's registers
    cannot hold past D 2048):

    - dx, a chunk of tokens ``t0:t1``: ``g = g_piece(x[t0:t1], w,
      targets[t0:t1], lse[t0:t1], dnll[t0:t1], 0)`` (t1 - t0, V), then
      ``product("dx", g, w, out[t0:t1])``;
    - dw, a chunk of vocabulary rows ``v0:v1``: ``g = g_piece(x,
      w[v0:v1], targets, lse, dnll, v0)`` (T, v1 - v0), its targets in
      absolute vocabulary units, then ``product("dw", g, x, out[v0:v1])``.

    The contraction (V for dx, T for dw) is whole inside a chunk, so no
    sum crosses chunks. On the card the pieces are ``icikit_xent_g_cols``
    (``xent_g_bf16``) into one bf16 scratch buffer and
    ``icikit_xent_g_product`` (``xent_dx_g_bf16`` / ``xent_dw_g_bf16``),
    on one stream, so a chunk's product has read the scratch before the
    next chunk's g overwrites it; :func:`g_cols_plain` and
    :func:`g_product_plain` are their plain versions."""
    n = x.shape[0] if which == "dx" else w.shape[0]
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        if which == "dx":
            g = g_piece(x[a:b], w, targets[a:b], lse[a:b], dnll[a:b], 0)
            product("dx", g, w, out[a:b])
        else:
            g = g_piece(x, w[a:b], targets, lse, dnll, a)
            product("dw", g, x, out[a:b])
    return out


def card_pieces(lib, x, scratch):
    """:func:`recompute_walk`'s two pieces on the card, through library
    ``lib``'s C entries on x's stream, g written into ``scratch`` (bf16,
    at least a chunk's g)."""
    st = _build.stream(x)

    def g_piece(xc, wc, tg, ls, dn, v0):
        t, d = xc.shape
        v = wc.shape[0]
        g = scratch[:t * v].view(t, v)
        _build.check(lib.icikit_xent_g_cols(
            xc.data_ptr(), wc.data_ptr(), tg.data_ptr(), ls.data_ptr(),
            dn.data_ptr(), g.data_ptr(), t, v, d, v0, st),
            "xent recompute g launch")
        return g

    def product(which, g, op, out):
        t, v = g.shape
        _build.check(lib.icikit_xent_g_product(
            int(which == "dx"), g.data_ptr(), op.data_ptr(), out.data_ptr(),
            t, v, op.shape[1], st), f"xent recompute {which} product launch")

    return g_piece, product


def walk_on_card(lib, which: str, x, w, targets, lse, dnll, out):
    """:func:`recompute_walk` on the card through library ``lib`` (the
    operands as the kernels take them), its chunk by
    :func:`recompute_chunk` and g's scratch taken from the allocator on
    x's stream for the call."""
    t, d = x.shape
    v = w.shape[0]
    chunk = recompute_chunk(t if which == "dx" else v, d,
                            _build.sm_count(x.device))
    scratch = torch.empty(chunk * (v if which == "dx" else t),
                          dtype=x.dtype, device=x.device)
    return recompute_walk(which, x, w, targets, lse, dnll, out, chunk,
                          *card_pieces(lib, x, scratch))


def _recompute(which: str, x, w, targets, lse, dnll) -> torch.Tensor:
    what = f"xent_{which}"
    if _recompute_operands(what, x, w, targets, lse, dnll):
        plain = xent_dx_plain if which == "dx" else xent_dw_plain
        return plain(x, w, targets, lse, dnll)
    t, d = x.shape
    v = w.shape[0]
    tg, ls, dn = _rows(targets, lse, dnll)
    out = torch.empty((t, d) if which == "dx" else (v, d), dtype=x.dtype,
                      device=x.device)
    lib = _build.load("xent")
    if x.dtype == torch.bfloat16 and d > CLUSTER_D_MAX:
        walk_on_card(lib, which, x, w, tg, ls, dn, out)
    else:
        rc = lib.icikit_xent_recompute(
            _build.DTYPE_CODE[x.dtype], int(which == "dx"), x.data_ptr(),
            w.data_ptr(), tg.data_ptr(), ls.data_ptr(), dn.data_ptr(),
            out.data_ptr(), t, v, d, _build.stream(x))
        _build.check(rc, f"{what} launch")
    LAUNCHES[what] += 1
    return out


def xent_dx(x, w, targets, lse, dnll) -> torch.Tensor:
    """dx ``(T, D)`` = g w with g rebuilt from recomputed logits tiles.
    The kernels replace ``icikit/ops/xent.py``'s ``_dx_kernel`` with
    ``e_ref=None`` (B10 recompute flavour, pallas_call at :374). Bound:
    the rebuild and the contraction, 2 x 2 T V D operations. In bf16 up
    to D 2048 the CTAs that share a row tile form a thread-block cluster
    along D, so each logits tile is formed once; wider heads walk chunks
    of tokens (:func:`recompute_walk`, sizes by :func:`recompute_chunk`),
    a chunk's g (chunk, V) in bf16 by ``xent_g``'s persistent wgmma body
    and then its product with w on the saved flavour's body, g given:
    each logits tile is formed once there too. ``LAUNCHES`` counts one a
    call. CPU tensors take :func:`xent_dx_plain`."""
    return _recompute("dx", x, w, targets, lse, dnll)


def xent_dw(x, w, targets, lse, dnll) -> torch.Tensor:
    """dw ``(V, D)`` = g^T x with g rebuilt as for dx. The kernels
    replace ``_dw_kernel`` with ``e_ref=None`` (B10 recompute flavour,
    pallas_call at :411). Bound: 2 x 2 T V D operations. Past D 2048 in
    bf16 the walk takes chunks of vocabulary rows, a chunk's g (T, chunk)
    with its targets in absolute vocabulary units, then g^T x. CPU
    tensors take :func:`xent_dw_plain`."""
    return _recompute("dw", x, w, targets, lse, dnll)
