"""The model step: the card's time in the window's dispatches, timed by the
program's CUDA events at each dispatch's start and end while traced
(``TrainingResult.dispatch``'s ``device_s``), per optimizer step, in ms.
None where the program does not report it."""


def read(rec):
    steps = sum(h["steps"] for h in rec.epochs)
    times = [d.get("device_s") for d in rec.dispatch]
    if not steps or not times or None in times:
        return None
    return 1e3 * sum(times) / steps
