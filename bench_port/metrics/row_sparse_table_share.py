"""The kernels under the model step: the share of the model's embedding
tables whose gradient is row-sparse and applied by the program's
row-sparse kernel, read from the window's last epoch's dispatch record
(``TrainingResult.dispatch``: ``row_sparse_tables`` and
``dense_tables``). None where the record lacks the counts or the model
has no table."""


def read(rec):
    if not rec.dispatch:
        return None
    last = rec.dispatch[-1]
    sparse, dense = last.get("row_sparse_tables"), last.get("dense_tables")
    if sparse is None or dense is None or not sparse + dense:
        return None
    return sparse / (sparse + dense)
