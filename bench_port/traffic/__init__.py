"""Traffic mixes: ``<mix>.json`` files of parameters; the data kinds a
configuration's ``data`` key names, ``<data>.py``; and the one generator
(``generate.py``) that makes a mix's rows of a kind from the seed."""
