"""Batched SAD block-matching — methods 3 and 5 of the reference.

Rebuilds the compute cores of ``BlockMethod`` (CPU SAD,
``src/BlockMethod.cpp:25-147``) and ``FastSpacedBMMethod``'s OpenCL kernels
(``src/FastSpacedBMMethod.cl:4-169``): exhaustive +-scan_radius SAD search
per grid cell, histogram voting over the per-cell winners, and the iterative
2x-upsample sub-pixel refinement.

Device mapping: the per-workgroup ``abssum`` accumulation with atomics
(``src/FastSpacedBMMethod.cl:23-40``) becomes a ``lax.scan`` over row shifts
with all column shifts and all grid cells vectorized per step; the
``atomic_add`` histogram + bubble-sort vote (``src/FastSpacedBMMethod.cl:
86-169``) becomes a one-hot sum + ``top_k``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def _extract_blocks(frame: jnp.ndarray, origins: jnp.ndarray, size: int) -> jnp.ndarray:
    """Gather [G, size, size] blocks at integer origins [G, 2] (x, y)."""

    def one(origin):
        return jax.lax.dynamic_slice(frame, (origin[1], origin[0]), (size, size))

    return jax.vmap(one)(origins)


@functools.partial(jax.jit, static_argnames=("block_size", "scan_radius"))
def sad_search(
    curr_blocks: jnp.ndarray,
    prev_regions: jnp.ndarray,
    *,
    block_size: int,
    scan_radius: int,
) -> jnp.ndarray:
    """SAD maps: ``[G, S, S]`` blocks vs ``[G, S+2R, S+2R]`` search regions
    -> ``[G, D, D]`` sums of absolute differences (D = 2R+1), SAD[g, i, j]
    comparing the current block against the previous frame shifted by
    ``(j - R, i - R)`` — the exhaustive loop of ``src/BlockMethod.cpp:43-57``
    / ``src/FastSpacedBMMethod.cl:23-40``.
    """
    d = 2 * scan_radius + 1
    s = block_size
    curr = curr_blocks.astype(jnp.float32)

    def row_step(_, di):
        rows = jax.lax.dynamic_slice_in_dim(prev_regions, di, s, axis=1)
        # all column shifts at once: [G, D, S, S]
        cols = jnp.stack(
            [jax.lax.slice_in_dim(rows, dj, dj + s, axis=2) for dj in range(d)], axis=1
        ).astype(jnp.float32)
        sad = jnp.sum(jnp.abs(cols - curr[:, None, :, :]), axis=(-2, -1))  # [G, D]
        return None, sad

    _, sads = jax.lax.scan(row_step, None, jnp.arange(d))
    return jnp.moveaxis(sads, 0, 1)  # [G, D, D] rows = di (y), cols = dj (x)


def sad_min_flow(
    sad: jnp.ndarray, scan_radius: int, *, noise_threshold: float | None = None
) -> jnp.ndarray:
    """Per-cell integer flow from SAD maps: argmin -> shift in [-R, R].

    ``noise_threshold`` reproduces the FastSpacedBM uniform-area rejection:
    if the zero-shift SAD beats the minimum by no more than
    ``scanRadius^2 * 0.2`` the cell votes (0, 0)
    (``MinValThreshold``, ``src/FastSpacedBMMethod.cl:2``, ``:79-84``).
    Ties resolve to the lowest flat index like ``cv::minMaxLoc``.
    """
    g, d, _ = sad.shape
    flat = sad.reshape(g, d * d)
    loc = jnp.argmin(flat, axis=-1)
    dy = loc // d - scan_radius
    dx = loc % d - scan_radius
    flow = jnp.stack([dx, dy], axis=-1)
    if noise_threshold is not None:
        center = sad[:, scan_radius, scan_radius]
        minval = jnp.take_along_axis(flat, loc[:, None], axis=-1)[:, 0]
        flat_area = (center - minval) <= noise_threshold
        flow = jnp.where(flat_area[:, None], 0, flow)
    return flow


def histogram_vote(
    flow: jnp.ndarray, scan_radius: int, *, top_k: int = 1
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Independent x / y histogram vote over per-cell flows.

    ``BlockMethod`` histograms x and y separately and takes each argmax
    (``src/BlockMethod.cpp:59-76``); FastSpacedBM sorts the histograms and
    emits the ``TestDepth`` most-voted values per axis
    (``src/FastSpacedBMMethod.cl:120-165``).  Returns ``(top_x, top_y)``
    each ``[top_k]``, most-voted first; ties resolve to the smaller shift
    (lower bin), matching the stable bubble sort.
    """
    d = 2 * scan_radius + 1
    bins_x = jnp.sum(jax.nn.one_hot(flow[:, 0] + scan_radius, d, dtype=jnp.int32), axis=0)
    bins_y = jnp.sum(jax.nn.one_hot(flow[:, 1] + scan_radius, d, dtype=jnp.int32), axis=0)

    def top(bins):
        _, idx = jax.lax.top_k(bins * d - jnp.arange(d), top_k)  # stable: prefer low bins
        return idx - scan_radius

    return top(bins_x), top(bins_y)


@functools.partial(jax.jit, static_argnames=("passes",))
def refine_subpixel(
    curr: jnp.ndarray, prev: jnp.ndarray, full_pix_flow: jnp.ndarray, passes: int = 2
) -> jnp.ndarray:
    """Iterative 2x-upsample +-1 px refinement (``BlockMethod::Refine``,
    ``src/BlockMethod.cpp:96-147``): at each pass both frames are upsampled
    2x, a 3x3 SAD around the doubled offset picks the best sub-step, and the
    result is the accumulated offset / 2^passes.

    Note: the reference resizes ``imPrev2x`` *from imCurr2x*
    (``src/BlockMethod.cpp:109``), which compares the current frame against
    itself and pins the refinement at the integer flow; that is a bug in
    dormant code, not a behaviour — here the previous frame is upsampled
    from the previous frame.
    """
    curr = jnp.asarray(curr, jnp.float32)
    prev = jnp.asarray(prev, jnp.float32)
    offset = jnp.asarray(full_pix_flow, jnp.int32)  # (x, y), prev-offset sign

    h, w = curr.shape
    scale = 1
    for _ in range(passes):
        scale *= 2
        hh, ww = h * scale, w * scale
        curr_up = jax.image.resize(curr, (hh, ww), method="linear")
        prev_up = jax.image.resize(prev, (hh, ww), method="linear")
        offset = offset * 2

        # fixed comparison region for all 9 probes of this pass (the
        # reference's constant cutoutSize, src/BlockMethod.cpp:118-122),
        # expressed as an elementwise validity mask so offsets stay traced:
        # curr pixel x pairs with prev pixel x + o; both must be in-bounds
        # for every probe o +- 1.
        xs = jax.lax.broadcasted_iota(jnp.int32, (hh, ww), 1)
        ys = jax.lax.broadcasted_iota(jnp.int32, (hh, ww), 0)
        lo_x = jnp.maximum(0, -offset[0]) + 1
        hi_x = ww - jnp.maximum(0, offset[0]) - 1
        lo_y = jnp.maximum(0, -offset[1]) + 1
        hi_y = hh - jnp.maximum(0, offset[1]) - 1
        mask = (xs >= lo_x) & (xs < hi_x) & (ys >= lo_y) & (ys < hi_y)

        def sad_at(mn, mask=mask, curr_up=curr_up, prev_up=prev_up, offset=offset):
            m, n = mn[0], mn[1]
            shifted = jnp.roll(prev_up, shift=(-(offset[1] + m), -(offset[0] + n)), axis=(0, 1))
            return jnp.sum(jnp.where(mask, jnp.abs(curr_up - shifted), 0.0))

        grid = jnp.asarray([(m, n) for m in (-1, 0, 1) for n in (-1, 0, 1)], jnp.int32)
        sads = jax.vmap(sad_at)(grid)
        best = jnp.argmin(sads)
        offset = offset + jnp.stack([grid[best, 1], grid[best, 0]])

    return offset.astype(jnp.float32) / scale
