"""Typed failure domains of a request (``Request.error_kind``).

The port's copy of the ``ERR_*`` constants of ``repro/serving/faults.py``
that the scheduler and engine use; the fault injector is not ported yet.
"""

ERR_INVALID = "invalid"       # malformed or not-yet-ported request
ERR_CAPACITY = "capacity"     # could never fit the pool / grew past it
ERR_NAN = "nan"               # non-finite logits on the request's row
