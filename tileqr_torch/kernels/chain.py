"""Chunked panel chain K2 and the strip update kernels K3 and K4.

Counterparts of ``tileqr/kernels/chain.py``:

- ``panel_chain`` (K2): TSQRT on ``n_chunks`` couples [R; B], B of
  ``block_rows`` rows, against the carried R;
- ``couple_strip`` (K3): the SSRFB sweep of the trailing update, with the
  diagonal LARFB fused in at the first couple (forward order) or after the
  last (``reverse``, the Q-apply order);
- ``larfb_strip`` (K4): the diagonal LARFB alone, for a panel with no
  couples.

On a CUDA tensor each wrapper launches its CUDA kernel (``csrc/chain.cu``;
K2 as one thread-block cluster, sized by ``panel.cluster_plan``);
on a CPU tensor it runs the plain version beside it. K3 and K4 update C and
the strip IN PLACE (the JAX kernels alias C to their output): the strip may
be a view of C's row strip, which the couple rows never touch. K3 and K4
take ``precision`` (``kernels/common.py``): their three products run in the
mode's product, the kernel's instantiation for it on the card; K2 is fp32
in every mode, as in ``tileqr``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tileqr_torch.kernels import _build
from tileqr_torch.kernels.common import counter_key, passes_of
from tileqr_torch.kernels.geqrt import geqrt_in_place
from tileqr_torch.kernels.larfb import larfb_body
from tileqr_torch.kernels.panel import _cluster_args
from tileqr_torch.kernels.ssrfb import ssrfb_body


def _check_chain(a, r_in, k, nb, base_block, n_chunks, block_rows):
    m, n = a.shape
    if n_chunks < 1 or block_rows % nb or (k + 1) * nb > n:
        raise ValueError("panel_chain: bad chunk geometry")
    if (base_block + n_chunks) * block_rows > m or tuple(r_in.shape) != (nb, nb):
        raise ValueError("panel_chain: chunks run past A or r_in is not (nb, nb)")


def panel_chain_plain(a, r_in, k: int, nb: int, base_block: int, n_chunks: int,
                      block_rows: int, ib: int = 128):
    """Plain torch K2."""
    _build.PLAIN_CALLS["panel_chain"] += 1
    _check_chain(a, r_in, k, nb, base_block, n_chunks, block_rows)
    kw = dict(dtype=a.dtype, device=a.device)
    v_chunks = torch.empty((n_chunks, block_rows, nb), **kw)
    t2 = torch.empty((n_chunks, nb, nb), **kw)
    r = r_in.clone()
    for i in range(n_chunks):
        r0 = (base_block + i) * block_rows
        at = torch.empty((nb, nb + block_rows), **kw)
        at[:, :nb] = r.T
        at[:, nb:] = a[r0 : r0 + block_rows, k * nb : (k + 1) * nb].T
        tt = torch.zeros((nb, nb), **kw)
        geqrt_in_place(at, tt, nb, ib)
        r = at[:, :nb].T.contiguous()  # strictly-lower stays exactly 0
        v_chunks[i] = at[:, nb:].T
        t2[i] = tt.T
    return r, v_chunks, t2


def panel_chain(a, r_in, k: int, nb: int, base_block: int, n_chunks: int,
                block_rows: int, ib: int = 128):
    """TSQRT-chain ``n_chunks`` couples of ``block_rows`` rows of panel
    column k against the carried R (seeded from ``r_in``). A is read only.
    Returns (r_out, v_chunks, t2_stack)."""
    if not _build.is_cuda(a, r_in):
        return panel_chain_plain(a, r_in, k, nb, base_block, n_chunks, block_rows, ib)
    _build.require_fp32(a, r_in)
    _build.require_row_major(a=a)
    _build.require_contiguous(r_in=r_in)
    _check_chain(a, r_in, k, nb, base_block, n_chunks, block_rows)
    kw = dict(dtype=a.dtype, device=a.device)
    r = torch.empty((nb, nb), **kw)
    v_chunks = torch.empty((n_chunks, block_rows, nb), **kw)
    t2 = torch.empty((n_chunks, nb, nb), **kw)
    lib, work, ctas, smem, resident = _cluster_args(nb, nb + block_rows, ib, kw)
    rc = lib.tq_panel_chain(
        a.data_ptr(), a.stride(0), r_in.data_ptr(), k, nb, base_block, n_chunks,
        block_rows, ib, r.data_ptr(), v_chunks.data_ptr(), t2.data_ptr(),
        work.data_ptr(), ctas, smem, resident, _build.stream(),
    )
    _build.check(rc, "panel_chain")
    _build.LAUNCHES["panel_chain"] += 1
    return r, v_chunks, t2


def _check_strip(v_stack, t2_stack, c, strip, stack_base, base_block, n_chunks,
                 block_rows, nb, col_start, vkk, tg):
    mc, p = c.shape
    if strip.dim() != 2 or strip.shape[0] != nb or strip.shape[1] != p - col_start * nb:
        raise ValueError(
            f"strip {tuple(strip.shape)} must be (nb, P - col_start·nb) for C {tuple(c.shape)}"
        )
    if v_stack.shape[1:] != (block_rows, nb) or t2_stack.shape[1:] != (nb, nb):
        raise ValueError("couple_strip: v_stack/t2_stack tile shapes")
    if n_chunks and (stack_base + n_chunks > v_stack.shape[0]
                     or (base_block + n_chunks) * block_rows > mc):
        raise ValueError("couple_strip: couples run past the stacks or C")
    if (vkk is None) != (tg is None):
        raise ValueError("couple_strip: pass both vkk and tg, or neither")


def couple_strip_plain(v_stack, t2_stack, c, strip, stack_base: int, base_block: int,
                       n_chunks: int, block_rows: int, nb: int, col_start: int,
                       trans: bool = True, reverse: bool = False, vkk=None, tg=None,
                       precision: str = "highest", counter: str = "couple_strip"):
    """Plain torch K3 (in place on C and the strip)."""
    _build.PLAIN_CALLS[counter_key(counter, precision)] += 1
    _check_strip(v_stack, t2_stack, c, strip, stack_base, base_block, n_chunks,
                 block_rows, nb, col_start, vkk, tg)
    c0 = col_start * nb
    s = strip
    if vkk is not None and not reverse:
        s = larfb_body(vkk, tg, s, trans, precision)
    order = range(n_chunks - 1, -1, -1) if reverse else range(n_chunks)
    for ii in order:
        r0 = (base_block + ii) * block_rows
        bot = c[r0 : r0 + block_rows, c0:]
        s, new_bot = ssrfb_body(v_stack[stack_base + ii], t2_stack[stack_base + ii],
                                s, bot, trans, precision)
        bot.copy_(new_bot)
    if vkk is not None and reverse:
        s = larfb_body(vkk, tg, s, trans, precision)
    if s is not strip:
        strip.copy_(s)
    return c, strip


def couple_strip(v_stack, t2_stack, c, strip, stack_base: int, base_block: int,
                 n_chunks: int, block_rows: int, nb: int, col_start: int,
                 trans: bool = True, reverse: bool = False,
                 vkk: Optional[torch.Tensor] = None,
                 tg: Optional[torch.Tensor] = None, precision: str = "highest",
                 counter: str = "couple_strip") -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``n_chunks`` couples to (strip, C), in place.

    v_stack: (B, block_rows, nb) reflector chunks; t2_stack: (B, nb, nb);
    couple ii uses slot stack_base + ii. Its C rows are row block
    base_block + ii (in units of block_rows), columns col_start·nb onward.
    strip: (nb, P − col_start·nb). reverse: couples in descending order.
    vkk/tg: the diagonal-tile LARFB, fused before the first couple (forward)
    or after the last (reverse). precision: the mode of the three products.
    counter: the name the call counts under, keyed by mode. Returns
    (c, strip).
    """
    passes = passes_of(precision)
    if not _build.is_cuda(v_stack, t2_stack, c, strip, vkk, tg):
        return couple_strip_plain(v_stack, t2_stack, c, strip, stack_base, base_block,
                                  n_chunks, block_rows, nb, col_start, trans, reverse,
                                  vkk, tg, precision, counter)
    _build.require_fp32(v_stack, t2_stack, c, strip, vkk, tg)
    _build.require_contiguous(v_stack=v_stack, t2_stack=t2_stack, vkk=vkk, tg=tg)
    _build.require_row_major(c=c, strip=strip)
    _check_strip(v_stack, t2_stack, c, strip, stack_base, base_block, n_chunks,
                 block_rows, nb, col_start, vkk, tg)
    if strip.shape[1] == 0:
        return c, strip
    rc = _build.lib().tq_couple_strip(
        v_stack.data_ptr(), t2_stack.data_ptr(), c.data_ptr(), c.stride(0),
        strip.data_ptr(), strip.stride(0), strip.shape[1], stack_base, base_block,
        n_chunks, block_rows, nb, col_start, int(trans), int(reverse),
        _build.ptr(vkk), _build.ptr(tg), passes, _build.stream(),
    )
    _build.check(rc, "couple_strip")
    _build.LAUNCHES[counter_key(counter, precision)] += 1
    return c, strip


def larfb_strip_plain(vkk, tg, strip, nb: int, trans: bool = True,
                      precision: str = "highest"):
    """Plain torch K4 (in place on the strip)."""
    _build.PLAIN_CALLS[counter_key("larfb_strip", precision)] += 1
    strip.copy_(larfb_body(vkk, tg, strip, trans, precision))
    return strip


def larfb_strip(vkk, tg, strip, nb: int, trans: bool = True,
                precision: str = "highest") -> torch.Tensor:
    """Apply the diagonal-tile GEQRT reflector block (vkk: packed (nb, nb),
    tg: its T) to the row strip, in place, in the precision mode."""
    if strip.dim() != 2 or strip.shape[0] != nb or tuple(vkk.shape) != (nb, nb):
        raise ValueError("larfb_strip: strip must be (nb, w) and vkk (nb, nb)")
    passes = passes_of(precision)
    if not _build.is_cuda(vkk, tg, strip):
        return larfb_strip_plain(vkk, tg, strip, nb, trans, precision)
    _build.require_fp32(vkk, tg, strip)
    _build.require_contiguous(vkk=vkk, tg=tg)
    _build.require_row_major(strip=strip)
    if strip.shape[1] == 0:
        return strip
    rc = _build.lib().tq_larfb_strip(
        vkk.data_ptr(), tg.data_ptr(), strip.data_ptr(), strip.stride(0),
        strip.shape[1], nb, int(trans), passes, _build.stream(),
    )
    _build.check(rc, "larfb_strip")
    _build.LAUNCHES[counter_key("larfb_strip", precision)] += 1
    return strip
