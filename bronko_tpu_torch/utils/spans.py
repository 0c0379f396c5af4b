"""Named spans of the program's stages.

`span(name, seconds, key)` times its body on the host clock and adds the
duration into `seconds[key or name]`, so repeated spans of one key (both
mates, every partition) add up. While torch.profiler runs, the body is
also a `bronko.<name>` range in its trace (`record_function`), on the
thread that ran it; with the profiler off no range is entered.

A trace keeps a range's name but not its arguments, so whatever must
join ranges across threads rides in the name: each thread's share of one
sample runs under `sample_span(position)`, `bronko.sample.<position>`.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import torch
from torch.autograd import profiler as _autograd_profiler

_NULL = nullcontext()


def profiling() -> bool:
    """Whether a torch.profiler session is running. The module flag is set
    for the whole process, on every thread, also when the profiler records
    all threads, which the thread-local `torch.autograd._profiler_enabled()`
    then reads as off."""
    return bool(getattr(_autograd_profiler, "_is_profiler_enabled", False)
                or torch.autograd._profiler_enabled())


def add_seconds(seconds: dict[str, float], key: str, value: float) -> None:
    seconds[key] = seconds.get(key, 0.0) + value


class _Span:
    __slots__ = ("name", "seconds", "key", "t0", "t1", "_range")

    def __init__(self, name: str, seconds: dict | None, key: str | None):
        self.name, self.seconds, self.key = name, seconds, key
        self._range = None

    def __enter__(self) -> _Span:
        if profiling():
            self._range = torch.profiler.record_function("bronko." + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self.seconds is not None:
            add_seconds(self.seconds, self.key or self.name, self.t1 - self.t0)
        if self._range is not None:
            self._range.__exit__(*exc)

    def elapsed(self) -> float:
        """Seconds since the span began."""
        return time.perf_counter() - self.t0


def span(name: str, seconds: dict[str, float] | None = None, key: str | None = None):
    """A span of stage `name` (see the module's docstring). Without a
    `seconds` dict and with the profiler off it is a shared no-op."""
    if seconds is None and not profiling():
        return _NULL
    return _Span(name, seconds, key)


def sample_span(position: int | None):
    """The range `bronko.sample.<position>` around one thread's share of
    the sample at input `position` (nothing for None, or with the profiler
    off)."""
    if position is None or not profiling():
        return _NULL
    return _Span(f"sample.{position}", None, None)
