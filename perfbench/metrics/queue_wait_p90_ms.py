"""Engine layer: the 90th percentile, in ms, over the requests due in the
window, of the scheduler's wait for admission: ``RequestMetrics``'
``first_scheduled_time`` less the arrival the engine was handed
(``Tracked.added``, its ``arrival_time``). A request not admitted by the
window's end counts with its age then; one due but never handed to the
engine (the loop was inside a step) waits in the generator's lateness,
not here."""
from perfbench import yardstick


def read(win, name):
    if not win.requests:
        return None
    return 1e3 * yardstick.percentile(
        [yardstick.censored(r.added, r.req.metrics.first_scheduled_time,
                            win.seconds) for r in win.requests], 90)
