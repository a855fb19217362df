"""Shared honest-measurement harness for device throughput numbers.

Two hazards make naive device benchmarks lie: repeated dispatch of
identical (program, input) pairs can be served from a cache below the
client, and un-materialized results let the host race ahead of the device
(JAX returns before the device finishes).  Every throughput number in this
repo (``bench.py``, ``scripts/bench_pipeline.py``) goes through this
module: iterations are chained on data (each input derives from the
previous output) and every result is materialized on the host.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def make_chained(step: Callable[[jnp.ndarray, jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]):
    """Wrap ``step(prev, curr) -> (result, bump_scalar)`` into a jitted
    ``chained(prev, curr) -> (next_prev, result)`` where ``next_prev``
    depends on the step's output — so no iteration can be elided or
    deduplicated.  The bump stays small (wrap-add of 1..3) and preserves
    ``prev``'s dtype (uint8 wraps, float drifts negligibly)."""

    @jax.jit
    def chained(prev, curr):
        result, bump_scalar = step(prev, curr)
        bump = (jnp.nan_to_num(bump_scalar) % 3.0 + 1.0).astype(prev.dtype)
        return prev + bump, result

    return chained


def measure_scan_slope(build, k_pair=(25, 100), *, reps: int = 7, warmup: int = 2) -> dict:
    """Per-item device time via TWO chain lengths.

    ``build(k)`` returns ``run(i)``, which dispatches ONE ``k``-item chained
    program whose inputs incorporate the rep index ``i`` — value-identical
    dispatches can be deduplicated below the client even when every buffer
    is fresh (a scan that carries state hits a value fixed-point after one
    rep, which is how a "chained" benchmark can still read back impossibly
    fast) — and MATERIALIZES a result to the host (``float()``/
    ``np.asarray`` of a scalar checksum, which waits for the device like
    ``jax.block_until_ready`` does).  The
    per-item time is the slope ``(T[k_hi] - T[k_lo]) / (k_hi - k_lo)`` of
    the median wall times, which cancels the per-dispatch overhead
    (dispatch setup, readback sync) exactly; dividing one chain's
    total by ``k`` would smear those constants into every item.

    The slope is only as good as the two medians it is drawn through, so
    the per-rep times are kept and turned into a JITTER SCALE (the
    interquartile spread of the reps, worst of the two chain lengths); the
    result carries ``reliable`` = "the chain-median separation ``delta_ms``
    clears 3x that jitter AND the slope is positive": two medians a few
    ms apart inside a wider jitter band give a positive slope that is
    noise, and a positivity check alone waves exactly that through.
    """
    med, iqr = {}, {}
    for k in k_pair:
        run = build(k)
        for i in range(warmup):
            run(i)
        times = []
        for i in range(warmup, warmup + reps):
            t0 = time.perf_counter()
            run(i)
            times.append(time.perf_counter() - t0)
        times.sort()
        med[k] = times[len(times) // 2]
        iqr[k] = times[(3 * len(times)) // 4] - times[len(times) // 4]
    k_lo, k_hi = k_pair
    per = (med[k_hi] - med[k_lo]) / (k_hi - k_lo)
    delta = med[k_hi] - med[k_lo]
    jitter = max(iqr[k_lo], iqr[k_hi])
    return {
        "per_item_ms": per * 1e3,
        "overhead_ms": (med[k_lo] - per * k_lo) * 1e3,
        "k_pair": list(k_pair),
        # raw chain medians: a slope is only as good as the two points it
        # is drawn through — under load the medians can sit inside the
        # jitter band and the slope turns implausible.  Publishing them
        # makes a bad capture self-evident instead of silently optimistic.
        "med_ms": {int(k): med[k] * 1e3 for k in k_pair},
        "delta_ms": delta * 1e3,
        "jitter_ms": jitter * 1e3,
        "reliable": bool(per > 0 and delta >= 3.0 * jitter),
    }


def make_latency_frames(
    n_distinct: int = 64,
    *,
    width: int = 752,
    height: int = 480,
    channels: int = 3,
    seed: int = 0,
):
    """``n_distinct`` distinct uint8 BGR camera frames (textured, shifted) —
    host-side prep for the latency benchmarks.  Distinct content per frame
    plus the node's state chaining (prev frame = device output of the last
    step) keep every dispatch value-distinct."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(height, width), dtype=np.uint8)
    frames = []
    for i in range(n_distinct):
        g = np.roll(base, (3 * i) % height, axis=0)
        if channels == 3:
            g = np.stack([g, g, g], axis=-1)
        frames.append(np.ascontiguousarray(g))
    return frames


def measure_node_latency(
    n_frames: int = 1000,
    *,
    warmup: int = 64,
    n_distinct: int = 64,
    dt: float = 0.02,
    overrides=None,
) -> dict:
    """End-to-end per-frame latency of ``OpticFlowNode``'s single-frame
    fused program: raw uint8 BGR 752x480 frame in -> twist out, measured
    around ``on_image`` for ``n_frames`` frames after ``warmup``.

    This is the latency shape of the reference's per-frame blocking enqueue
    + readback (``src/FftMethod.cpp:398-407``) — here one fused device
    program plus the host readbacks of the tiny result arrays.  Returns
    p50/p90/p95/p99/mean in milliseconds.
    """
    node = _make_latency_node(overrides)
    frames = make_latency_frames(n_distinct)
    times = []
    stamp = 100.0
    for i in range(warmup + n_frames):
        stamp += dt
        elapsed = _time_node_frame(node, stamp, frames[i % n_distinct])
        if i >= warmup:
            times.append(elapsed)
    arr = np.asarray(times) * 1e3
    arr.sort()
    pct = lambda p: float(arr[min(int(len(arr) * p), len(arr) - 1)])  # noqa: E731
    return {
        "n": len(arr),
        "p50_ms": pct(0.50),
        "p90_ms": pct(0.90),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "mean_ms": float(arr.mean()),
    }


def _make_latency_node(overrides=None):
    """A ready-to-measure ``OpticFlowNode`` (camera info + sensor snapshots
    seeded, null publish/log) — shared by the latency harnesses."""
    from mrs_optic_flow_tpu.config import load_config
    from mrs_optic_flow_tpu.runtime.msgs import (
        CameraInfo,
        Float64Stamped,
        Imu,
        Odometry,
    )
    from mrs_optic_flow_tpu.runtime.node import OpticFlowNode

    cfg = load_config(overrides=overrides)
    node = OpticFlowNode(cfg, publish=lambda t, m: None, log=lambda s: None,
                         enable_profiler=False)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    t0 = 100.0
    node.on_camera_info(CameraInfo(k=[420.0, 0, 376.0, 0, 420.0, 240.0, 0, 0, 1],
                                   d=[0.0] * 5))
    node.on_imu(Imu(stamp=t0, angular_velocity=(0.0, 0.0, 0.0),
                    orientation=(0.0, 0.0, 0.0, 1.0)))
    node.on_odometry(Odometry(stamp=t0, orientation=(0.0, 0.0, 0.0, 1.0),
                              linear_velocity=(0.0, 0.0, 0.0)))
    node.on_height(Float64Stamped(stamp=t0, value=2.0))
    return node


def _time_node_frame(node, stamp: float, img) -> float:
    """Wall seconds of one ``on_image`` call."""
    from mrs_optic_flow_tpu.runtime.msgs import ImageMsg

    t_start = time.perf_counter()
    node.on_image(ImageMsg(stamp=stamp, data=img))
    return time.perf_counter() - t_start


def measure_node_latency_ab(
    n_frames: int = 600,
    *,
    overrides_a=None,
    overrides_b=None,
    block: int = 10,
    warmup: int = 32,
    n_distinct: int = 64,
    dt: float = 0.02,
) -> dict:
    """INTERLEAVED A/B of two node configurations within ONE run.

    End-to-end latency drifts with host load on the tens-of-seconds
    scale, so a sequential A-then-B comparison measures the drift as much
    as the knob.  Here the two configs
    alternate every ``block`` frames against their own stamp streams, the
    per-round paired delta ``median(B round) − median(A round)`` cancels
    drift to first order, and ``sign_consistency`` (fraction of rounds
    agreeing with the median's sign) says whether the verdict is stable
    inside the run.  Both nodes are warmed (compile) before timing.

    Returns ``delta_p50_ms`` (negative = B faster), per-round deltas, the
    per-config p50s, and ``sign_consistency``.
    """
    node_a = _make_latency_node(overrides_a)
    node_b = _make_latency_node(overrides_b)
    frames = make_latency_frames(n_distinct)
    stamps = {id(node_a): 100.0, id(node_b): 100.0}

    def run_block(node, n, i0, record=None):
        for i in range(n):
            stamps[id(node)] += dt
            el = _time_node_frame(
                node, stamps[id(node)], frames[(i0 + i) % n_distinct]
            )
            if record is not None:
                record.append(el)

    run_block(node_a, warmup, 0)
    run_block(node_b, warmup, 0)
    rounds = max(n_frames // (2 * block), 1)
    deltas, all_a, all_b = [], [], []
    for r in range(rounds):
        ta, tb = [], []
        run_block(node_a, block, r * block, ta)
        run_block(node_b, block, r * block, tb)
        deltas.append((float(np.median(tb)) - float(np.median(ta))) * 1e3)
        all_a += ta
        all_b += tb
    med_delta = float(np.median(deltas))
    agree = [d for d in deltas if (d < 0) == (med_delta < 0) or d == 0]
    return {
        "delta_p50_ms": med_delta,
        "round_deltas_ms": [float(d) for d in deltas],
        "sign_consistency": len(agree) / len(deltas),
        "a_p50_ms": float(np.median(all_a)) * 1e3,
        "b_p50_ms": float(np.median(all_b)) * 1e3,
        "n_rounds": rounds,
        "block": block,
    }


def measure_device_chain_latency(
    k: int = 100,
    *,
    reps: int = 7,
    warmup: int = 2,
    config=None,
    width: int = 752,
    height: int = 480,
    scale_rotation=None,
    max_k: int | None = None,
    budget_s=None,
) -> dict:
    """Device-program-only per-frame latency of the full single-frame chain
    (grayscale -> crop -> FftMethod.step -> getRT -> detilt).

    ``scale_rotation``: an optional ``ScaleRotationEstimator`` — when given,
    its log-polar step runs INSIDE the chained program with its state
    carried across iterations, exactly the node's fused ``scale_rotation:
    true`` path (``OpticFlowNode._frame_program``), so the slope measures
    the combined per-frame cost of flow + geometry + scale/rotation.

    Chains the frame program ``k`` and ``k/4`` times and reports the
    per-frame SLOPE between the two (:func:`measure_scan_slope`) — the
    per-dispatch host overhead that dominates single-frame timing
    cancels exactly, and a per-rep scalar bias keeps every dispatch
    value-distinct so nothing can be served from a cache.  The
    chain is ONE compiled program with a *dynamic* trip count
    (``lax.while_loop`` indexing a fixed frame stack), so both lengths share
    a single compile.

    SELF-POLICING: when the chain-median separation does not clear the
    measured rep jitter (``measure_scan_slope.reliable`` — a loaded host
    can leave both medians inside one jitter band), the chain
    length ESCALATES (k doubles, up to ``max_k``) and remeasures.
    Escalation is OPT-IN: it activates only when the caller passes
    ``budget_s`` (a zero-arg seconds-remaining callable or a float —
    ``max_k`` then defaults to ``4*k``) or an explicit ``max_k``; with
    neither, the measurement keeps its legacy fixed cost (and memory —
    the frame stack is allocated at ``max_k`` up front so every
    escalation reuses the ONE compiled program).  The result's
    ``slope_ok`` is the final reliability verdict — callers must not
    publish ratios off ``slope_ok=False``."""
    import jax
    import jax.numpy as jnp

    from mrs_optic_flow_tpu.geometry.motion import get_rt
    from mrs_optic_flow_tpu.geometry.rotations import (
        matrix_from_quat,
        quat_rotate,
        rpy_from_matrix,
    )
    from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
    from mrs_optic_flow_tpu.ops.preprocess import center_crop, to_grayscale

    engine = FftMethod(config if config is not None else FftMethodConfig())
    frame_size = engine.config.frame_size
    patch = engine.config.sample_point_size
    cx = width // 2
    ul_x = jnp.float32(cx - frame_size // 2)
    cam = jnp.asarray(
        [[420.0, 0, float(cx)], [0, 420.0, height / 2.0], [0, 0, 1.0]],
        jnp.float32,
    )
    dist = jnp.zeros((5,), jnp.float32)
    ident = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    alt_m = jnp.float32(2.0)  # UAV height above ground
    dtv = jnp.float32(0.02)

    @jax.jit
    def chain(state, sr_state, sr_w, frames, keys, bias, n):
        def body(carry):
            i, st, sr_st, acc = carry
            img = jax.lax.dynamic_index_in_dim(frames, i, keepdims=False)
            key = jax.lax.dynamic_index_in_dim(keys, i, keepdims=False)
            gray = center_crop(to_grayscale(img), frame_size, cx) + bias
            new_state, flow = engine.step(st, gray)
            res = get_rt(
                flow.shifts, alt_m, dtv, ul_x, cam, dist, ident, ident, key,
                frame_size=frame_size, patch=patch,
            )
            tran_b = quat_rotate(ident, quat_rotate(ident, res.tran))
            ang = jnp.stack(rpy_from_matrix(matrix_from_quat(res.rot)))
            acc = (acc + jnp.nansum(tran_b) + jnp.nansum(ang)
                   + jnp.sum(res.ok.astype(jnp.float32)))
            if scale_rotation is not None:
                # weights threaded as chain arguments, never closure
                # constants (ops/logpolar.py module comment)
                sr_st, srres = scale_rotation.step_w(sr_st, gray, sr_w)
                acc = acc + jnp.nan_to_num(srres.scale) + jnp.nan_to_num(srres.rotation)
            return i + 1, new_state, sr_st, acc
        # scalar checksum — run() materializes it to the host, which is the
        # only wait that is guaranteed to cover execution (see
        # measure_scan_slope)
        _, st, _, chk = jax.lax.while_loop(
            lambda c: c[0] < n, body,
            (jnp.int32(0), state, sr_state, jnp.float32(0.0)),
        )
        return st, chk

    if k < 2:
        raise ValueError(f"k must be >= 2 to fit a slope, got {k}")
    def _budget_now():
        if budget_s is None:
            return None
        return budget_s() if callable(budget_s) else float(budget_s)

    # escalation is OPT-IN via budget_s (or an explicit max_k): the frame
    # stack is allocated at max_k up front (4*k quadruples its memory and
    # a jittery host could multiply a caller's measurement time), so
    # legacy fixed-cost callers (scripts/verify_sr_fused.py and the tune
    # scripts) keep their old envelope unless they hand over a budget.
    # An ALREADY-EXHAUSTED budget also sizes at k: escalation could never
    # run, so the 4x stack would be pure wasted device memory/setup.
    if max_k is None:
        b_now = _budget_now()
        max_k = 4 * k if (b_now is not None and b_now > 0) else k
    max_k = max(int(max_k), k)

    @jax.jit
    def _make_frames(key):
        # distinct uint8 BGR frames generated ON DEVICE: host RNG and the
        # upload of the ~100 MB stack are set-up costs that don't belong in
        # a device-program latency number.  Sized at max_k
        # so an escalated chain length reuses the same compiled program
        # (the frames shape is baked into the HLO).
        g = jax.random.bits(key, (max_k, height, width), jnp.uint8)
        return jnp.repeat(g[..., None], 3, axis=-1)

    frames = _make_frames(jax.random.PRNGKey(1))
    keys = jax.random.split(jax.random.PRNGKey(0), max_k)

    sr_state0 = None if scale_rotation is None else scale_rotation.init_state()
    sr_w = () if scale_rotation is None else scale_rotation.lp_weights

    gen = {"n": 0}

    def build(kk):
        # generation counter folded into the bias: an ESCALATED round
        # re-measures chain lengths already dispatched (k_lo of round 2 ==
        # k_hi of round 0) with freshly-reset state, and a rep-index-only
        # bias would make those dispatches value-identical to the earlier
        # round's — servable from a cache below the client, corrupting the
        # very slope the escalation is refining
        g = gen["n"]
        gen["n"] += 1
        holder = {"state": engine.init_state()}

        def run(i):
            st, chk = chain(holder["state"], sr_state0, sr_w, frames, keys,
                            jnp.float32(g * 1000 + i) * 1e-3, jnp.int32(kk))
            float(chk)
            holder["state"] = st

        return run

    def _budget_left():
        b = _budget_now()
        return float("inf") if b is None else b

    # k_lo stays strictly below k (and within the max_k-frame stack every
    # chain length shares), so the slope denominator can never degenerate
    k_cur, escalations = k, 0
    while True:
        slope = measure_scan_slope(
            build, (max(k_cur // 4, 1), k_cur), reps=reps, warmup=warmup
        )
        if slope["reliable"] or k_cur >= max_k:
            break
        # cost estimate for the doubled chains from the medians just
        # measured (x2 for the doubling, x1.5 safety): escalate only if the
        # remaining budget covers it — a partial escalation that trips the
        # caller's alarm would erase the measurement it was refining
        est_s = 3.0 * (reps + warmup) * sum(slope["med_ms"].values()) / 1e3
        if _budget_left() < est_s:
            break
        k_cur = min(2 * k_cur, max_k)
        escalations += 1
    return {
        "k": k_cur,
        "per_frame_ms": slope["per_item_ms"],
        "dispatch_overhead_ms": slope["overhead_ms"],
        "chain_medians_ms": slope["med_ms"],
        "delta_ms": slope["delta_ms"],
        "jitter_ms": slope["jitter_ms"],
        "escalations": escalations,
        # reliability verdict (jitter-aware, not just positivity — a loaded
        # host can jitter the two medians past each other): callers must
        # not publish ratios off an unreliable slope
        "slope_ok": slope["reliable"],
    }


def measure_chained_stats(
    chained,
    prev: jnp.ndarray,
    curr: jnp.ndarray,
    *,
    items_per_call: int,
    iters: int = 16,
    pipeline: int = 1,
    warmup: int = 3,
    progress: Callable[[float], None] | None = None,
) -> dict:
    """Steady-state items/sec of a :func:`make_chained` function, WITH the
    per-window spread.

    ``pipeline`` calls are kept in flight per timed window (a streaming
    consumer's shape); every window's results are materialized on the host.
    The headline ``rate`` is the p50 of per-window rates (robust to
    scheduler jitter), and ``window_rates``/``rate_min``/``rate_max``
    publish the spread — a single scalar cannot tell host-load drift from
    a regression.

    ``progress``, when given, is called ONCE with the first timed window's
    rate as soon as it lands — the incremental-emission hook that lets
    ``bench.py`` print a provisional headline a later failure cannot erase.
    """
    p, s = chained(prev, curr)
    np.asarray(s)
    for _ in range(warmup):
        p, s = chained(p, curr)
        np.asarray(s)
    times = []
    for _ in range(max(iters // pipeline, 1)):
        pending = []
        t0 = time.perf_counter()
        for _ in range(pipeline):
            p, s = chained(p, curr)
            pending.append(s)
        for s in pending:
            np.asarray(s)
        times.append(time.perf_counter() - t0)
        if progress is not None and len(times) == 1:
            progress(items_per_call * pipeline / times[0])
    # headline: the upper-middle TIME (even window counts round to the
    # SLOWER of the middle pair — sorting rates instead would flip it to
    # the faster one, a silent optimistic bias of ~half the window spread)
    rate = items_per_call * pipeline / sorted(times)[len(times) // 2]
    # window_rates stay CHRONOLOGICAL so the artifact can distinguish
    # monotone within-run drift (e.g. clocks settling) from random jitter
    rates = [items_per_call * pipeline / t for t in times]
    return {
        "rate": rate,
        "rate_min": min(rates),
        "rate_max": max(rates),
        "window_rates": rates,
        "n_windows": len(rates),
    }


def measure_chained(chained, prev, curr, **kw) -> float:
    """p50-only wrapper over :func:`measure_chained_stats` (the tuning
    scripts' shape; ``bench.py`` consumes the full stats)."""
    return measure_chained_stats(chained, prev, curr, **kw)["rate"]
