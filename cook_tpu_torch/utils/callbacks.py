"""Safe listener fan-out: the one notify-all idiom shared by every
subscriber surface (encode-cache invalidations, quality-sample
listeners).  A sick listener is logged and skipped — observers must
never block or fail the producer's hot path.

Copy of `cook_tpu/utils/callbacks.py`."""
from __future__ import annotations

import logging

log = logging.getLogger(__name__)


def notify_all(listeners, context: str, *args, **kwargs) -> None:
    """Call every listener with (*args, **kwargs); exceptions are logged
    (tagged with `context`) and never propagate.  Iterates a snapshot so
    a listener registering mid-delivery neither breaks iteration nor
    receives this event."""
    for listener in list(listeners):
        try:
            listener(*args, **kwargs)
        except Exception:  # noqa: BLE001 — a sick listener must never
            # take down the producer (the observer rebuilds from its own
            # staleness checks; losing one notification is recoverable)
            log.exception("listener failed (%s)", context)
