"""Command-line harnesses of the port: ``repro_table2`` (the paper's
Table 2 from a checkpoint and a dataset) and ``synthetic_sanity`` (a
learning check that needs no external data)."""
