"""User-facing exceptions (reference parity: python/ray/exceptions.py)."""

from __future__ import annotations


class RayError(Exception):
    """Base for all framework errors."""


class RayTaskError(RayError):
    """A task raised; carries the remote traceback. Re-raised on ray.get."""

    def __init__(self, function_name: str = "", traceback_str: str = "",
                 cause: BaseException | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(
            f"task {function_name} failed:\n{traceback_str or cause}")

    def __reduce__(self):
        # See RayActorError.__reduce__: rebuild from the real fields, not
        # the formatted message, so the message doesn't re-nest per hop.
        return (RayTaskError, (self.function_name, self.traceback_str,
                               self.cause))

    def as_instanceof_cause(self) -> BaseException:
        """Best effort: raise something isinstance-compatible with the
        original exception (reference RayTaskError.as_instanceof_cause)."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if issubclass(cause_cls, RayError):
            return self.cause
        try:
            class _Wrapped(RayTaskError, cause_cls):  # type: ignore[misc]
                def __init__(self, inner: RayTaskError):
                    self.__dict__.update(inner.__dict__)

                def __str__(self) -> str:
                    return RayTaskError.__str__(self)
            _Wrapped.__name__ = f"RayTaskError({cause_cls.__name__})"
            _Wrapped.__qualname__ = _Wrapped.__name__
            return _Wrapped(self)
        except TypeError:
            return self


class WorkerCrashedError(RayError):
    """The worker executing the task died (reference WorkerCrashedError)."""


class RayActorError(RayError):
    """The actor is dead; calls can't be delivered."""

    def __init__(self, actor_id: str = "", cause: str = ""):
        self.actor_id = actor_id
        self.cause = cause or "(death cause unknown)"
        super().__init__(f"actor {actor_id[:12]} died: {self.cause}")

    def __reduce__(self):
        # Default Exception pickling reconstructs from self.args (the
        # formatted message), which would shift into actor_id and blank the
        # cause on every serialization hop. Preserve the real fields.
        return (type(self), (self.actor_id, self.cause))


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """Actor temporarily unreachable (restarting)."""


class TaskCancelledError(RayError):
    pass


class GetTimeoutError(RayError, TimeoutError):
    pass


class ObjectLostError(RayError):
    """Object can't be found / reconstructed."""


class ObjectFreedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    pass


class DeadlockError(RayError):
    """A blocking get() inside an actor closed a waits-for cycle: every
    actor on the cycle holds its executor thread while waiting on the
    next one, so none can make progress. Raised by the waiter whose edge
    would have completed the cycle (the wait-graph detector in the GCS),
    which unwinds that waiter and lets the rest of the cycle drain —
    instead of the whole gang hanging forever."""

    def __init__(self, message: str = "", cycle: list | None = None):
        self.cycle = list(cycle or [])
        super().__init__(message)

    def __reduce__(self):
        # rebuild from the real fields (see RayActorError.__reduce__)
        return (DeadlockError, (self.args[0] if self.args else "",
                                self.cycle))


class RaySystemError(RayError):
    pass


class RuntimeEnvSetupError(RayError):
    pass


class PlacementGroupSchedulingError(RayError):
    pass


class PendingCallsLimitExceeded(RayError):
    """Submitting to an actor whose max_pending_calls bound is full
    (reference ray.exceptions.PendingCallsLimitExceeded)."""
