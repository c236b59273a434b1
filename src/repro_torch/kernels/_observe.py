"""The kernel wrappers' observation hook.

Each public wrapper (``spmm_ell``, ``fused_layer``, ...) is decorated with
:func:`counted` and its cost function, ``cost(*args, out=out, **kwargs) ->
(flops, bytes)``: the operations and the bytes of the function on these
inputs, each input byte read once and each output byte written once.
While an observer is registered (``launch.roofline``'s step walk,
``obs.comm.overlap_report``) each call is reported to it with its cost,
and the observer's ``depth`` is above 0 inside the call, so the aten ops a
wrapper dispatches (its plain version on the CPU) are not counted again.
With no observer a call costs one check of a module-level list.
"""
from __future__ import annotations

import functools
from typing import Callable, List

# the observers registered now (``observing``)
OBSERVERS: List["KernelObserver"] = []


class KernelObserver:
    """Base of an observer: ``depth`` counts the wrapper calls in progress;
    :meth:`kernel_done` gets each outermost call's name, cost function,
    arguments and output."""

    depth = 0

    def kernel_done(self, name: str, cost: Callable, args: tuple,
                    kwargs: dict, out) -> None:
        raise NotImplementedError


class observing:
    """``with observing(obs):`` registers ``obs`` for the block."""

    def __init__(self, obs: KernelObserver):
        self._obs = obs

    def __enter__(self) -> KernelObserver:
        OBSERVERS.append(self._obs)
        return self._obs

    def __exit__(self, *exc) -> bool:
        OBSERVERS.remove(self._obs)
        return False


def counted(cost: Callable) -> Callable:
    """Decorate a kernel wrapper with its cost function (kept as the
    wrapper's ``cost`` attribute)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not OBSERVERS:
                return fn(*args, **kwargs)
            watching = list(OBSERVERS)
            for obs in watching:
                obs.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                for obs in watching:
                    obs.depth -= 1
            for obs in watching:
                if obs.depth == 0:
                    obs.kernel_done(fn.__name__, cost, args, kwargs, out)
            return out
        wrapper.cost = cost
        return wrapper
    return deco
