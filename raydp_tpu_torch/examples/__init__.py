"""The port's copies of the example pipelines the main path runs
(``examples/`` imports the reference package): the NYCTaxi feature ETL and
its CSV generator, and the Criteo DLRM generator and ``pre_process``."""
