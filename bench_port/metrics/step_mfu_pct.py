"""The model step (``models/`` through ``_make_train_step``): the model
FLOPs the traced window's steps need (``counts.flops_per_step``) over the
traced window's wall time times the published dense peak of the
configuration's compute dtype (``peaks.json``)."""


def read(rec):
    t = rec.trace
    if t is None or rec.peaks is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    peak = rec.peaks["flops"][rec.config["compute_dtype"]]
    return 100.0 * rec.step_flops * rec.traced_steps / (t.window_s * peak)
