"""Python 3.10 compatibility: ``asyncio.TaskGroup`` / ``ExceptionGroup``.

The engine is written against the 3.11 structured-concurrency API.  On
3.11+ these names are just aliases for the stdlib; on 3.10 we provide a
minimal backport with the subset of semantics the engine relies on:

- ``create_task`` schedules a child; the first child error aborts (cancels)
  every sibling;
- ``__aexit__`` always waits for all children, then raises one
  ``ExceptionGroup`` carrying the child errors (plus the body error, if
  any);
- cancellation of the enclosing task cancels the children and propagates as
  ``CancelledError`` once they have unwound.
"""

from __future__ import annotations

import asyncio
import builtins

if hasattr(builtins, "BaseExceptionGroup"):  # Python 3.11+
    BaseExceptionGroup = builtins.BaseExceptionGroup
    ExceptionGroup = builtins.ExceptionGroup
else:

    class BaseExceptionGroup(BaseException):  # type: ignore[no-redef]
        def __init__(self, message: str, exceptions):
            super().__init__(message)
            self.message = message
            self.exceptions = tuple(exceptions)

        def __str__(self) -> str:
            return f"{self.message} ({len(self.exceptions)} sub-exception(s))"

    class ExceptionGroup(BaseExceptionGroup, Exception):  # type: ignore[no-redef]
        pass


if hasattr(asyncio, "TaskGroup"):  # Python 3.11+
    TaskGroup = asyncio.TaskGroup
else:

    class TaskGroup:  # type: ignore[no-redef]
        def __init__(self) -> None:
            self._tasks: set[asyncio.Task] = set()
            self._errors: list[BaseException] = []
            self._aborted = False
            self._parent_task: asyncio.Task | None = None
            # we cancelled the parent ourselves (3.11 semantics: the first
            # child error interrupts a body that is still awaiting); that
            # self-inflicted CancelledError must be swallowed exactly once
            self._parent_cancelled_by_us = False
            self._self_cancel_consumed = False
            self._outer_cancelled = False

        async def __aenter__(self) -> "TaskGroup":
            self._parent_task = asyncio.current_task()
            return self

        def create_task(self, coro, *, name: str | None = None) -> asyncio.Task:
            task = asyncio.get_running_loop().create_task(coro, name=name)
            self._tasks.add(task)
            task.add_done_callback(self._on_done)
            return task

        def _abort(self) -> None:
            self._aborted = True
            for t in self._tasks:
                if not t.done():
                    t.cancel()

        def _on_done(self, task: asyncio.Task) -> None:
            self._tasks.discard(task)
            if task.cancelled():
                return
            exc = task.exception()
            if exc is not None:
                self._errors.append(exc)
                self._abort()
                parent = self._parent_task
                if (
                    parent is not None
                    and not parent.done()
                    and not self._parent_cancelled_by_us
                ):
                    self._parent_cancelled_by_us = True
                    parent.cancel()

        def _classify_cancel(self) -> None:
            """One CancelledError hitting the parent is ours if we asked for
            it; any other one is a genuine outer cancellation."""
            if self._parent_cancelled_by_us and not self._self_cancel_consumed:
                self._self_cancel_consumed = True
            else:
                self._outer_cancelled = True

        async def __aexit__(self, et, exc, tb) -> bool:
            if exc is not None:
                self._abort()
            if et is not None and issubclass(et, asyncio.CancelledError):
                self._classify_cancel()
            while self._tasks:
                try:
                    await asyncio.gather(
                        *list(self._tasks), return_exceptions=True
                    )
                except asyncio.CancelledError:
                    self._classify_cancel()
                    self._abort()
            body_error = exc is not None and not isinstance(
                exc, asyncio.CancelledError
            )
            if body_error:
                self._errors.insert(0, exc)
            if self._outer_cancelled:
                # teardown wins over fail-fast: the canceller is tearing the
                # pipeline down and expects CancelledError to propagate
                raise asyncio.CancelledError()
            if self._errors:
                raise ExceptionGroup(
                    "unhandled errors in a TaskGroup", self._errors
                ) from None
            return False  # no child errors: let any body exception propagate
