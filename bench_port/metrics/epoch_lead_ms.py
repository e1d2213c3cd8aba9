"""The train loop (``train/torch_estimator.py`` ``_train_loop``): the host's
time from each epoch's start to its first dispatch's enqueue, while the card
waits (the last epoch ended in a loss read that waited for it):
``TrainingResult.dispatch``'s ``lead_s``, the mean over the window's epochs,
in ms. None where the program does not report it."""


def read(rec):
    leads = [d.get("lead_s") for d in rec.dispatch]
    if not leads or None in leads:
        return None
    return 1e3 * sum(leads) / len(leads)
