"""The step runner (``train/step_graph.py``): the window's optimizer steps
served by CUDA-graph replays, over all its steps
(``TrainingResult.dispatch``: ``graph_steps`` over ``steps``)."""


def read(rec):
    steps = sum(h["steps"] for h in rec.epochs)
    if not steps:
        return None
    return sum(d["graph_steps"] for d in rec.dispatch) / steps
