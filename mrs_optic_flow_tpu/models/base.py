"""Abstract flow-engine interface — the ``OpticFlowCalc`` contract.

The reference's base class (``include/OpticFlowCalc.h:6-22``) prescribes:
``processImage(imCurr, gui, debug, midPoint, yaw_angle, rot_center,
raw_output, fx, fy) -> vector<Point2d>`` plus ``setImPrev``.  The JAX
contract keeps the same shape (gray frame in, per-window pixel shifts out;
invalid windows poisoned with NaN) but is functional: state in, state out.
"""

from __future__ import annotations

import abc
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class FlowState(NamedTuple):
    """Per-stream engine state.

    ``prev``  — previous grayscale frame ``[H, W]`` (the reference's
    ``imPrev`` member, seeded black at init, ``src/optic_flow.cpp:1016-1018``);
    uint8 for engines carrying the reference's 8-bit pipeline
    (``FftMethodConfig.quantize_8bit``), float32 otherwise.
    ``first`` — scalar bool; on the first frame the reference copies the
    current frame into ``imPrev`` so the first output is a zero-shift
    measurement (``src/FftMethod.cpp:1787-1789``).
    """

    prev: jnp.ndarray
    first: jnp.ndarray


class FlowResult(NamedTuple):
    """``shifts``: gated per-window shifts ``[P, 2]`` (x, y), NaN where
    invalid — matching the NaN-poisoning at ``src/FftMethod.cpp:1851-1854``.
    ``shifts_raw``: ungated shifts (the reference's ``shift_raw``,
    ``src/FftMethod.cpp:1828``).  ``response``: correlation peak value per
    window (observability; the reference discards it after the decode loop).
    """

    shifts: jnp.ndarray
    shifts_raw: jnp.ndarray
    response: jnp.ndarray


class FlowEngine(abc.ABC):
    """Stateless engine object; all per-stream state is explicit."""

    @abc.abstractmethod
    def init_state(self) -> FlowState:
        """Fresh state with a black previous frame."""

    @abc.abstractmethod
    def step(self, state: FlowState, frame: jnp.ndarray) -> Tuple[FlowState, FlowResult]:
        """One frame in, per-window pixel shifts out (jit-compiled)."""

    def set_im_prev(self, state: FlowState, frame: jnp.ndarray) -> FlowState:
        """``OpticFlowCalc::setImPrev`` (``include/OpticFlowCalc.h:16``)."""
        return FlowState(prev=jnp.asarray(frame, jnp.float32), first=jnp.asarray(False))

    @functools.partial(jax.jit, static_argnames=("self",))
    def step_batch(self, prev_frames: jnp.ndarray, curr_frames: jnp.ndarray) -> FlowResult:
        """Stateless throughput mode: ``[B, H, W]`` frame pairs in, batched
        :class:`FlowResult` out.  Default implementation vmaps :meth:`step`
        over synthesized states; engines with a dedicated batched kernel
        (FftMethod) override this.  (Jitted with static ``self`` like every
        step method — subclasses define ``__hash__``/``__eq__`` on config.)"""

        def one(p, c):
            _, res = self.step(self.set_im_prev(None, p), c)
            return res

        return jax.vmap(one)(jnp.asarray(prev_frames), jnp.asarray(curr_frames))


class OpticFlowCalc:
    """Signature-compatible wrapper over a :class:`FlowEngine`.

    Mirrors the reference's abstract interface
    (``include/OpticFlowCalc.h:9-16``): a *stateful* object whose
    ``process_image(im_curr, gui, debug, mid_point, yaw_angle, rot_center,
    raw_output, fx, fy) -> [P, 2] shifts`` hides the functional state
    threading — the migration path for code written against the reference.
    The GUI/debug/midpoint arguments are accepted for signature parity; the
    ones the reference itself ignores are ignored here too (``raw_output``
    is filled in-place like the reference's out-parameter *would* be — the
    reference declares it and never writes it, ``src/FftMethod.cpp:1772``).
    """

    def __init__(self, engine: FlowEngine):
        self.engine = engine
        self.state = engine.init_state()
        self.last_result: FlowResult | None = None

    def process_image(
        self,
        im_curr,
        gui: bool = False,
        debug: bool = False,
        mid_point=None,
        yaw_angle: float = 0.0,
        rot_center=None,
        raw_output=None,
        fx: float = 0.0,
        fy: float = 0.0,
    ):
        self.state, result = self.engine.step(self.state, im_curr)
        self.last_result = result
        if raw_output is not None:
            try:
                raw_output[:] = result.shifts_raw
            except (TypeError, ValueError):
                pass
        return result.shifts

    def process_image_long_range(self, im_curr, *args, **kwargs):
        """``FftMethod::processImageLongRange`` (``include/FftMethod.h:441``)
        through the same stateful interface."""
        self.state, result = self.engine.step_long_range(self.state, im_curr)
        self.last_result = result
        return result.shifts

    def set_im_prev(self, frame):
        self.state = self.engine.set_im_prev(self.state, frame)
